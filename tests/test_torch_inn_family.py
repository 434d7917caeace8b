"""What hangs on the INN warp in the port, against the JAX package on the
CPU: the inverse warp, the ``posenc`` and ``extrinsic`` latents (features
and checkpoints both ways), ``barf_inn_blender`` with both kinds of pose
noise and the l2g depth range, fine sampling under the warp, the SVD
Procrustes with the JAX package's VJP, the rigidity diagnostic, and the
entry point on the Blender model and with ``--tpu.fused_inn``.

Inputs are made from a seed with numpy; weights come from the JAX init over
the weight bridge, with the warp's zero output layers, latent projectors
and latent rows of the first layers filled, so that the warp is not the
identity and every leaf has a gradient (the PE rows stay zero: filled, the
2^5 pi band makes every fp32 gradient noise); the pose noise and every draw
of a step are handed to both systems. Tolerances: as tests/test_torch_train_step.py holds
the flagship step (losses rtol 1e-5; gradients rtol 1e-4 plus 1e-5 of the
leaf's largest entry), fp32 on both sides in other summation orders. The
inverse warp: rtol 1e-5, atol 1e-6 against JAX; the round trip 2e-4, as
tests/test_inn.py holds it (three blocks of fp32 trig each way). The Blender
configuration has no c2f schedule, so every PE band of the field is open
on points 2 to 6 units out: it runs with 4 and 2 bands, as
tests/test_inn_blender.py runs it (at 10 bands the 2^9 pi band turns fp32
rounding of the points into 1% of the field's gradients), and its warp
takes points 4 to 6 units out, in the noisy world frame, whose embedding
angles reach 600 rad: gradients there to 1e-4 of the leaf's largest entry
(read: up to 5e-5). With fine
sampling the resampled depths inherit the last bits of the coarse weights:
losses rtol 2e-4, gradients rtol 5e-3 plus 2e-3 of the leaf's largest entry
(tests/test_torch_nerf_system.py: 5e-3 and 5e-6 absolute).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import synth_data
from neural_invertible_warp_tpu import config
from neural_invertible_warp_tpu.models import get_system_class as jax_system_class
from neural_invertible_warp_tpu.ops import align as jalign
from neural_invertible_warp_tpu.ops import inn as jinn
from neural_invertible_warp_tpu.ops import lie as jlie
from neural_invertible_warp_tpu.ops import sampling as jsampling
from neural_invertible_warp_tpu.utils import ckpt as jckpt
from neural_invertible_warp_tpu_torch.models import get_system_class
from neural_invertible_warp_tpu_torch.models import inn_warp
from neural_invertible_warp_tpu_torch.ops import align, inn
from neural_invertible_warp_tpu_torch.utils import ckpt, weights

from test_torch_inn_align import D_FEAT, D_HIDDEN, _perturbed_params, _point_pairs
from test_torch_train_step import H, W, N_IMG, OVERRIDES, _arrays, _leaves

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

LLFF = OVERRIDES
BLENDER = [
    "--model=barf_inn_blender", "--yaml=barf_blender_inn", "--data.image_size=[16,16]",
    "--arch.layers_feat=[null,32,32,32,32]", "--arch.layers_rgb=[null,16,3]",
    "--arch.skip=[2]", "--arch.posenc.L_3D=4", "--arch.posenc.L_view=2",
    "--nerf.sample_intvs=16", "--nerf.rand_rays=64", "--inn.real_nvp.d_hidden=16",
    "--warp_latent.embed_dim=8", "--max_iter=8", "--loss_weight.global_alignment=3"]


# ------------------------------------------------------------ inverse warp

@pytest.mark.parametrize("anneal,alpha", [("reference", 0.0), ("reference", 0.37),
                                          ("reference", 1.0), ("bands", 0.37)])
def test_deform_inverse_matches_jax_and_round_trips(anneal, alpha):
    params = _perturbed_params(4)
    rng = np.random.RandomState(5)
    code = rng.randn(2, D_FEAT).astype(np.float32)
    pts = rng.randn(2, 50, 3).astype(np.float32)
    net = inn.DeformNetwork(D_FEAT, d_hidden=D_HIDDEN, multires=6, anneal=anneal)
    net.load_state_dict(weights.deform_from_jax(params))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jinn.deform_inverse(jp, jnp.asarray(code), jnp.asarray(pts), alpha, multires=6,
                              anneal=anneal)
    c, x = torch.tensor(code), torch.tensor(pts, requires_grad=True)
    got = inn.deform_inverse(net, c, x, alpha)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert float((got.detach() - x.detach()).abs().max()) > 1e-3
    torch.sum(got ** 2).backward()             # differentiable like the forward
    assert float(x.grad.abs().max()) > 0
    with torch.no_grad():
        for first, second in ((inn.deform_forward, inn.deform_inverse),
                              (inn.deform_inverse, inn.deform_forward)):
            back = second(net, c, first(net, c, x, alpha), alpha)
            np.testing.assert_allclose(back.numpy(), pts, atol=2e-4)


# ------------------------------------------------------------- Procrustes

@pytest.mark.parametrize("noise,spread", [(0.01, 1.0), (0.3, 1.0), (0.0, 1e-2)])
def test_svd_procrustes_rotation_and_vjp(noise, spread):
    x, y = _point_pairs(0, noise=noise, spread=spread)
    M = np.einsum("bni,bnj->bij", y - y.mean(1, keepdims=True),
                  x - x.mean(1, keepdims=True)).astype(np.float32)
    G = np.random.RandomState(1).randn(4, 3, 3).astype(np.float32)
    R_j, vjp = jax.vjp(jalign.procrustes_rotation, jnp.asarray(M))
    (gM_j,) = vjp(jnp.asarray(G))
    Mt = torch.tensor(M, requires_grad=True)
    R_t = align.ProcrustesSVD.apply(Mt)
    R_t.backward(torch.tensor(G))
    np.testing.assert_allclose(R_t.detach().numpy(), np.asarray(R_j), atol=1e-5)
    scale = np.abs(np.asarray(gM_j)).max()
    np.testing.assert_allclose(Mt.grad.numpy(), np.asarray(gM_j), rtol=1e-4,
                               atol=1e-5 * scale)
    # the quaternion solver gives the same rotation
    np.testing.assert_allclose(align.ProcrustesQuat.apply(torch.tensor(M)).numpy(),
                               R_t.detach().numpy(), atol=1e-5)


def test_svd_procrustes_reflection_and_symmetric_cloud():
    """A cross-covariance whose plain SVD solution is a reflection gets its
    last singular direction flipped; a near-symmetric cloud (close singular
    values), where an SVD backward with differences in its denominators
    breaks down, gives the JAX rule's finite gradient."""
    rng = np.random.RandomState(2)
    M = rng.randn(3, 3, 3).astype(np.float32)
    M[0] = np.diag([1.0, 1.0, -0.5])
    M[1] = np.eye(3) * 2.0 + 1e-6 * rng.randn(3, 3)
    G = rng.randn(3, 3, 3).astype(np.float32)
    R_j, vjp = jax.vjp(jalign.procrustes_rotation, jnp.asarray(M))
    (gM_j,) = vjp(jnp.asarray(G))
    Mt = torch.tensor(M, requires_grad=True)
    R_t = align.ProcrustesSVD.apply(Mt)
    R_t.backward(torch.tensor(G))
    np.testing.assert_allclose(torch.linalg.det(R_t.detach()).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(R_t.detach().numpy(), np.asarray(R_j), atol=1e-5)
    assert np.all(np.isfinite(Mt.grad.numpy()))
    # the clamped, near-degenerate entries aside, the gradients agree
    for i in (0, 2):
        np.testing.assert_allclose(Mt.grad.numpy()[i], np.asarray(gM_j)[i], rtol=1e-3,
                                   atol=1e-4 * np.abs(np.asarray(gM_j)[i]).max())


def test_rigid_points_registration_svd_grads():
    x, y = _point_pairs(2, noise=0.05)
    cot_R = np.random.RandomState(3).randn(4, 3, 3).astype(np.float32)
    cot_t = np.random.RandomState(4).randn(4, 3).astype(np.float32)

    def jf(x, y):
        R, t = jalign.rigid_points_registration(x, y, method="svd")
        return jnp.sum(R * cot_R) + jnp.sum(t * cot_t), (R, t)
    (_, (R_j, t_j)), g_j = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(y))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    R_t, t_t = align.rigid_points_registration(xt, yt)        # "svd" is the default
    (torch.sum(R_t * torch.tensor(cot_R)) + torch.sum(t_t * torch.tensor(cot_t))).backward()
    np.testing.assert_allclose(R_t.detach().numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(t_t.detach().numpy(), np.asarray(t_j), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(g_j[1]), rtol=1e-4, atol=1e-5)
    with pytest.raises(KeyError):
        align.rigid_points_registration(xt, yt, method="umeyama")


# ----------------------------------------------- the systems, side by side

def _options(overrides, out, size=(H, W)):
    yaml = [o for o in overrides if o.startswith("--yaml=")][0].split("=")[1]
    opt = config.load_options("options/{}.yaml".format(yaml))
    opt = config.override_options(opt, config.parse_arguments(overrides), key_stack=[],
                                  safe_check=True)
    opt.H, opt.W = size
    opt.output_path = str(out)
    return opt


def _pair(overrides, tmp_path, model, train=None, seed=0):
    """(JAX system, its state with the warp's output layers, latent
    projectors and latent rows filled, port system carrying the same
    weights), at step 2."""
    train = _arrays(N_IMG, 0) if train is None else train
    test = _arrays(1, 1)
    jsys = jax_system_class(model)(_options(overrides, tmp_path / "jax"))
    jsys.attach_data(train, test)
    state = jsys.init_state(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)

    def noise(x):
        return (rng.randn(*np.shape(x)) * 0.02).astype(np.float32)
    params = jax.tree_util.tree_map(lambda x: np.array(x), state["params"])
    for block in params["warp_mlp"]["blocks"]:
        d_feat = block["c"]["w"].shape[0]
        block["c"] = {k: noise(v) for k, v in block["c"].items()}
        for branch in ("a", "b"):
            first, last = block[branch]
            first["v"][-d_feat:] = noise(first["v"][-d_feat:])     # the latent rows
            last.update({k: noise(v) for k, v in last.items()})
    state = dict(state, params=jax.tree_util.tree_map(jnp.asarray, params),
                 step=jnp.int32(2))
    psys = get_system_class(model)(_options(overrides, tmp_path / "port"), "cpu")
    psys.attach_data(train, test)
    psys.init_state(seed)
    psys.graph.load_state_dict(weights.from_jax_params(params))
    psys.step = 2
    return jsys, state, psys


def _step0(jsys, state, psys, key=42, loss_rtol=1e-5, grad_rtol=1e-4, grad_atol=1e-5):
    """Losses and gradient leaves of one train forward + backward of both
    systems on the JAX step's own draws (``grad_atol`` as a share of the
    leaf's largest entry)."""
    opt = jsys.opt
    n_rays, K = opt.nerf.rand_rays // N_IMG, opt.nerf.sample_intvs
    key = jax.random.PRNGKey(key)
    k_perm, k_render = jax.random.split(key)
    k_depth, _ = jax.random.split(k_render)
    depth_rand = np.asarray(jax.random.uniform(k_depth, (N_IMG, n_rays, K, 1)))
    ray_idx = jsampling.sample_ray_subset(k_perm, H * W, n_rays, mode="stratified")

    def loss_fn(params):
        out, target, extras = jsys._forward_train(params, state["aux"], jsys.train_data,
                                                  ray_idx, k_render, state["step"])
        losses = jsys.compute_loss(params, state["aux"], jsys.train_data, out, target,
                                   state["step"], extras)
        return jsys.summarize_loss(losses), losses
    (total_j, losses_j), g_j = jax.value_and_grad(loss_fn, has_aux=True)(state["params"])

    psys.optim.zero_grad()
    out, target, extras = psys._forward_train(torch.from_numpy(np.array(ray_idx)).long(),
                                              psys.step, torch.tensor(depth_rand))
    losses_t = psys.compute_loss(out, target, extras)
    total_t = psys.summarize_loss(losses_t)
    total_t.backward()
    assert sorted(losses_t) == sorted(losses_j)
    for k in losses_j:
        np.testing.assert_allclose(float(losses_t[k].detach()), float(losses_j[k]),
                                   rtol=loss_rtol, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(float(total_t.detach()), float(total_j), rtol=loss_rtol)
    g_t = weights.to_jax_params(psys.graph, get=lambda p: p.grad)
    lj, lt = _leaves(g_j), jax.tree_util.tree_leaves(g_t)
    assert len(lj) == len(lt) > 30
    for (path, a), b in zip(lj, lt):
        a = np.asarray(a)
        assert np.abs(a).max() > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(b, a, rtol=grad_rtol,
                                   atol=grad_atol * np.abs(a).max() + 1e-9,
                                   err_msg=jax.tree_util.keystr(path))
    return losses_t, extras


# -------------------------------------------------------------- latents

@pytest.mark.parametrize("enc_type,width,dim", [("posenc", None, 16), ("extrinsic", 6, 126)])
def test_latent_features_step0_and_checkpoints(enc_type, width, dim, tmp_path):
    over = LLFF + ["--warp_latent.enc_type={}".format(enc_type)]
    jsys, state, psys = _pair(over, tmp_path, "barf_inn_llff")
    assert psys.latent_dim() == jsys.latent_dim() == dim
    assert psys.graph.warp_mlp.lin0_c.weight.shape == (dim, dim)
    if width is None:       # a fixed encoding of the frame id: nothing to learn
        assert not hasattr(psys.graph, "warp_latent") and "warp_latent" not in state["params"]
    else:
        assert psys.graph.warp_latent.weight.shape == (N_IMG, width)
    feat_j = np.asarray(jsys._warp_feat(state["params"]))
    feat_t = psys._warp_feat()
    assert feat_t.shape == (N_IMG, dim)
    np.testing.assert_allclose(feat_t.detach().numpy(), feat_j, rtol=1e-6, atol=1e-6)
    if enc_type == "extrinsic":
        # the reference's layout: the translation rides with the ROTATION's encoding
        L = psys.opt.warp_latent.extrinsic.L
        f = feat_t.detach().numpy()
        lat = psys.graph.warp_latent.weight.detach().numpy()
        np.testing.assert_array_equal(f[:, :3], lat[:, :3])
        np.testing.assert_array_equal(f[:, 3 + 6 * L:6 + 6 * L], lat[:, 3:])
        np.testing.assert_array_equal(f[:, 6 + 6 * L:], f[:, 3:3 + 6 * L])
    _step0(jsys, state, psys)

    # checkpoints both ways
    ckpt.save(str(tmp_path / "p"), psys, 2)
    restored, it = jckpt.restore_checkpoint(str(tmp_path / "p"), state)
    assert it == 2
    for a, b in zip(jax.tree_util.tree_leaves(restored["params"]),
                    jax.tree_util.tree_leaves(weights.to_jax_params(psys.graph))):
        np.testing.assert_array_equal(np.asarray(a), b)
    jckpt.save_checkpoint(str(tmp_path / "j"), state, 2)
    other = get_system_class("barf_inn_llff")(_options(over, tmp_path / "other"), "cpu")
    other.attach_data(_arrays(N_IMG, 0), _arrays(1, 1))
    other.init_state(7)
    assert ckpt.restore(str(tmp_path / "j"), other) == 2 and other.step == 2
    for (path, a), b in zip(_leaves(state["params"]),
                            jax.tree_util.tree_leaves(weights.to_jax_params(other.graph))):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=jax.tree_util.keystr(path))


def test_unknown_latent_is_refused(tmp_path):
    opt = _options(LLFF + ["--warp_latent.enc_type=hash"], tmp_path)
    system = get_system_class("barf_inn_llff")(opt, "cpu")
    with pytest.raises(NotImplementedError, match="hash"):
        system.latent_dim()


# ------------------------------------------------------- barf_inn_blender

def _blender_arrays(n, seed):
    """Cameras on a ring of radius 4 looking at the origin, w2c."""
    arrays = _arrays(n, seed)
    rng = np.random.RandomState(seed)
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / n + 0.1 * rng.randn()
        R = np.asarray(jlie.so3_to_SO3(jnp.asarray([0.0, a, 0.0], jnp.float32)))
        poses.append(np.concatenate([R, np.array([[0.0], [0.0], [4.0]], np.float32)], 1))
    arrays["pose"] = np.stack(poses).astype(np.float32)
    return arrays


@pytest.mark.parametrize("noise_type", ["barf", "l2g"])
def test_blender_step0_with_pose_noise(noise_type, tmp_path):
    flags = {"barf": ["--camera.noise_type=barf", "--camera.noise_barf=0.1"],
             "l2g": ["--camera.noise_type=l2g", "--camera.noise_l2g_r=0.07",
                     "--camera.noise_l2g_t=0.5"]}[noise_type]
    train = _blender_arrays(N_IMG, 0)
    jsys, state, psys = _pair(BLENDER + flags, tmp_path, "barf_inn_blender", train=train)
    assert type(psys) is inn_warp.InnWarpSystem
    # both systems drew their own noise, of the right kind
    for aux in (state["aux"], psys.aux):
        noise = np.asarray(aux["pose_noise"])
        assert noise.shape == (N_IMG, 3, 4) and np.abs(noise[:, :, :3] - np.eye(3)).max() > 1e-3
    drawn = psys.aux["pose_noise"]
    psys.init_state(0)
    assert torch.equal(psys.aux["pose_noise"], drawn)     # from the seeded generator
    # one noise for both
    rng = np.random.RandomState(3)
    if noise_type == "barf":
        noise = jlie.se3_to_SE3(jnp.asarray(rng.randn(N_IMG, 6) * 0.1, jnp.float32))
    else:
        noise = jnp.concatenate(
            [jlie.so3_to_SO3(jnp.asarray(rng.randn(N_IMG, 3) * 0.07, jnp.float32)),
             jnp.asarray(rng.randn(N_IMG, 3, 1) * 0.5, jnp.float32)], axis=-1)
    aux = dict(state["aux"], pose_noise=noise)
    aux["global_rigid"] = jsys._initial_pose_all(aux)
    state = dict(state, aux=aux)
    psys.graph.load_state_dict(weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, state["params"])))
    psys.step = 2
    psys.aux["pose_noise"] = torch.tensor(np.asarray(noise))
    psys.aux["global_rigid"] = psys._initial_pose_all()
    np.testing.assert_allclose(psys.aux["global_rigid"].numpy(),
                               np.asarray(aux["global_rigid"]), atol=1e-6)
    assert np.abs(np.asarray(aux["global_rigid"]) - train["pose"]).max() > 1e-2
    pose_t, gt_t = psys.get_all_training_poses()
    pose_j, gt_j = jsys.get_all_training_poses(state)
    np.testing.assert_allclose(pose_t.numpy(), pose_j, atol=1e-5)
    np.testing.assert_array_equal(gt_t.numpy(), gt_j)
    if noise_type == "l2g":
        near_t, far_t = psys._l2g_depth_range()
        near_j, far_j = jsys._l2g_depth_range(aux)
        np.testing.assert_allclose([float(near_t), float(far_t)],
                                   [float(near_j), float(far_j)], rtol=1e-5)
    losses, extras = _step0(jsys, state, psys, grad_atol=1e-4)
    assert float(losses["global_alignment"]) > 0
    # the warp was fed points in the noisy initial world frame
    assert float(extras["center_cam"].abs().max()) > 1.0


def test_l2g_depth_range_scales_with_camera_spread(tmp_path):
    opt = _options(BLENDER + ["--camera.noise_type=l2g"], tmp_path, size=(8, 8))
    system = inn_warp.InnWarpSystem(opt, "cpu")
    system.n_train = 4
    d = 3.0
    centers = np.array([[d, 0, 0], [-d, 0, 0], [0, d, 0], [0, -d, 0]], np.float32)
    poses = np.stack([np.concatenate([np.eye(3, dtype=np.float32), -c[:, None]], 1)
                      for c in centers])
    near, far = system._l2g_depth_range(dict(global_rigid=torch.tensor(poses)))
    depth_min, depth_max = opt.nerf.depth.range
    total = depth_max + depth_min
    np.testing.assert_allclose(float(near), depth_min / total * 2 * d, rtol=1e-5)
    np.testing.assert_allclose(float(far), depth_max / total * 2 * d, rtol=1e-5)


# ------------------------------------------- fine sampling under the warp

def test_fine_sampling_under_the_warp_step0(tmp_path):
    over = LLFF + ["--nerf.fine_sampling=true", "--nerf.sample_intvs_fine=8",
                   "--loss_weight.render_fine=0"]
    jsys, state, psys = _pair(over, tmp_path, "barf_inn_llff")
    assert sorted(n for n, _ in psys.graph.named_children()) == [
        "nerf", "nerf_fine", "warp_latent", "warp_mlp"]
    assert psys.param_labels() == {"nerf": "main", "nerf_fine": "main", "warp_mlp": "pose",
                                   "warp_latent": "latent"}
    losses, _ = _step0(jsys, state, psys, loss_rtol=2e-4, grad_rtol=5e-3, grad_atol=2e-3)
    assert sorted(losses) == ["global_alignment", "render", "render_fine"]
    with torch.no_grad():
        out = psys.render_image(psys.test_data["pose"][:1], psys.test_data["intr"][:1],
                                torch.tensor(0.25))
    ref = jsys.render_image(state["params"], state["aux"], jsys.test_data["pose"][:1],
                            jsys.test_data["intr"][:1], 0.25)
    for k in ("rgb", "rgb_fine"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


# ------------------------------------------------------------ diagnostics

def test_verify_warp_rigidity(tmp_path):
    opt = _options(LLFF, tmp_path)
    system = get_system_class("barf_inn_llff")(opt, "cpu")
    system.attach_data(_arrays(N_IMG, 0), _arrays(1, 1))
    system.init_state(0)
    res = inn_warp.verify_warp_rigidity(system, n_probes=6, seed=1)    # the identity warp
    assert res["angle_before"].shape == (6,)
    np.testing.assert_allclose(res["angle_after"], res["angle_before"], atol=1e-3)
    np.testing.assert_allclose(res["norm_ratio"], 1.0, atol=1e-6)
    with torch.no_grad():     # a warp that is not rigid shows
        for p in system.graph.warp_mlp.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(0)))
    res = inn_warp.verify_warp_rigidity(system, n_probes=6, seed=1)
    assert np.abs(res["norm_ratio"] - 1.0).max() > 1e-3
    with pytest.raises(RuntimeError, match="_forward_train"):
        system.get_train_pose()


# ------------------------------------------------------------ entry point

TINY = ["--arch.layers_feat=[null,16,16,16]", "--arch.layers_rgb=[null,8,3]", "--arch.skip=[1]",
        "--warp_latent.embed_dim=4", "--nerf.sample_intvs=8", "--max_iter=3", "--freq.scalar=1",
        "--freq.val=100", "--freq.ckpt=100", "--data.num_workers=2", "--group=cli"]


@pytest.mark.parametrize("name", ["barf_inn_blender", "barf_inn_llff fused"])
def test_train_entry_point_on_cpu(name, tmp_path, monkeypatch):
    """A few steps of ``python -m ...train`` in process with ``--device=cpu``;
    without that flag and without a card the entry point refuses to start."""
    from neural_invertible_warp_tpu_torch import train
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_inn
    root = str(tmp_path / "data")
    if name == "barf_inn_blender":
        synth_data.make_consistent_blender_scene(root, n_train=4, n_val=1, n_test=1,
                                                 img_size=24)
        flags = ["--model=barf_inn_blender", "--yaml=barf_blender_inn", "--data.scene=sphere",
                 "--data.image_size=[24,24]", "--nerf.rand_rays=256",
                 "--inn.real_nvp.d_hidden=8", "--camera.noise_barf=0.1",
                 "--loss_weight.global_alignment=3", "--name=blender"]
    else:
        synth_data.make_llff_scene(root, n_images=8, img_size=(24, 32))
        flags = ["--model=barf_inn_llff", "--yaml=barf_inn_llff", "--barf_c2f=[0.1,0.5]",
                 "--loss_weight.global_alignment=4", "--data.scene=toyfern",
                 "--data.image_size=[24,32]", "--data.val_ratio=0.25", "--nerf.rand_rays=384",
                 "--tpu.fused_inn", "--name=fused"]
    flags += TINY + ["--data.root={}".format(root), "--output_root={}".format(tmp_path / "out")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device=cpu"):
            train.main(flags)
    calls = []
    real = fused_inn.fused_deform_forward
    monkeypatch.setattr(fused_inn, "fused_deform_forward",
                        lambda *a: calls.append(1) or real(*a))
    trainer = train.main(flags + ["--device=cpu"])
    system = trainer.system
    assert system.step == 3 and type(system) is inn_warp.InnWarpSystem
    assert len(calls) == (0 if name == "barf_inn_blender" else 3)
    assert all(np.isfinite(float(m["loss_all"])) for m in trainer.history)
    assert float(trainer.history[-1]["loss_global_alignment"]) > 0
    if name == "barf_inn_blender":
        assert "pose_noise" in system.aux
        R_err, t_err = system.evaluate_camera_alignment()
        assert np.all(np.isfinite(R_err)) and np.all(np.isfinite(t_err))
    assert os.path.isfile(os.path.join(str(tmp_path), "out", "cli", flags[flags.index(
        "--name=blender" if name == "barf_inn_blender" else "--name=fused")].split("=")[1],
        "model.ckpt"))
