"""The DTU family of the port against the JAX package on the CPU: the loader,
the trajectory alignment of the evaluation, the train step of
``barf_inn_dtu`` and ``barf_dtu`` (losses, depth metrics, every gradient
leaf, one Adam step), the pose readout, alignment and eval poses,
``evaluate_full`` with the depth errors and masked metrics, checkpoints
both ways, the depth range of every render, the camera export and the
entry points.

The scene is tests/synth_data.py's ``make_dtu_scene``: 12 images at 30x40
(10 train, 2 val with ``dtuhold`` 8), cameras at radius 3.5 around an
analytic field, at the JAX DTU tests' size (a 4x32 trunk, 24 samples, 480
rays, INN d_hidden 32, latent 16, global alignment at 10^3). Both systems
start from the JAX init over the weight bridge at step 2; the warp's zero
output layers, latent rows and the se(3) refinement are filled with small
random values, so that no leaf is trivial, and the JAX system's
``noisy_gt`` draw (pose.noise 0.05) and the JAX step's ray and depth draws
are handed to the port. Tolerances: losses rtol 1e-5; gradient leaves in
float64 to 1e-6 of the leaf's largest entry, and in float32 rtol 1e-4 plus
1e-5 of the leaf's largest entry, as tests/test_torch_train_step.py holds
the flagship step, wherever the JAX reference lies that close to its own
float64 evaluation, else plus 1e-4 (the step test says why); parameters
after one Adam step to 1e-6, except where a gradient is noise-level (below 1e-4
of its leaf's largest entry), where lr * sign(g) may point the other way;
evaluation metrics rtol 1e-4; the copied numpy alignment to 1e-6.
"""

import os

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import synth_data
from neural_invertible_warp_tpu import config
from neural_invertible_warp_tpu.data import dtu as jdtu
from neural_invertible_warp_tpu.models import get_system_class as jax_system_class
from neural_invertible_warp_tpu.ops import align as jalign
from neural_invertible_warp_tpu.ops import lie as jlie
from neural_invertible_warp_tpu.ops import sampling as jsampling
from neural_invertible_warp_tpu.utils import ckpt as jckpt
from neural_invertible_warp_tpu_torch import config as pconfig
from neural_invertible_warp_tpu_torch.data import get_dataset
from neural_invertible_warp_tpu_torch.dotdict import DotDict
from neural_invertible_warp_tpu_torch.models import get_system_class
from neural_invertible_warp_tpu_torch.models import dtu
from neural_invertible_warp_tpu_torch.ops import align, sampling
from neural_invertible_warp_tpu_torch.utils import ckpt, weights

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

H, W = 30, 40
N_IMAGES, N_TRAIN = 12, 10
MODELS = ["barf_inn_dtu", "barf_dtu"]


def _overrides(model, root, max_iter=60):
    yaml = "barf_inn_dtu" if "inn" in model else "barf_dtu"
    return ["--model={}".format(model), "--yaml={}".format(yaml),
            "--data.root={}".format(root), "--data.scene=scan1",
            "--data.image_size=[30,40]", "--data.num_workers=2",
            "--arch.layers_feat=[null,32,32,32,32]", "--arch.layers_rgb=[null,16,3]",
            "--arch.skip=[2]", "--arch.posenc.L_3D=4", "--arch.posenc.L_view=2",
            "--nerf.sample_intvs=24", "--nerf.rand_rays=480", "--pose.init=noisy_gt",
            "--pose.noise=0.05", "--max_iter={}".format(max_iter)] + (
        ["--inn.real_nvp.d_hidden=32", "--inn.real_nvp.latent_dim=16",
         "--loss_weight.global_alignment=3"] if "inn" in model else [])


def _options(cfg, overrides, out):
    yaml = [o for o in overrides if o.startswith("--yaml=")][0].split("=")[1]
    opt = cfg.load_options("options/{}.yaml".format(yaml))
    opt = cfg.override_options(opt, cfg.parse_arguments(overrides), key_stack=[],
                               safe_check=True)
    opt.H, opt.W = H, W
    opt.output_path = str(out)
    return opt


@pytest.fixture(scope="module")
def dtu_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu"))
    synth_data.make_dtu_scene(root, n_images=N_IMAGES)
    return root


@pytest.fixture(scope="module")
def dtu49_root(tmp_path_factory):
    """All 49 views of a DTU scan (the pixelNeRF splits index up to 48), tiny."""
    root = str(tmp_path_factory.mktemp("dtu49"))
    synth_data.make_dtu_scene(root, n_images=49, H=6, W=8)
    return root


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize("split_type,n_images,size,mask_img", [
    (None, N_IMAGES, (15, 20), True),          # every 8th held out; resized; masked
    ("all", N_IMAGES, (H, W), False),
    ("pixelnerf", 49, (6, 8), False),
    ("pixelnerf_reduced_testset", 49, (6, 8), False)])
def test_loader_matches_jax(split_type, n_images, size, mask_img, dtu_root, dtu49_root):
    """Every array of both splits bit for bit, the split indices, the poses
    and ``norm_trans``. The JAX loader runs with cv2's IPP off: the port
    resizes as OpenCV's own code does (``utils/cv_ops.py``; against IPP's
    results: tests/test_torch_cv_ops.py)."""
    opt = synth_data.dtu_opt(dtu_root if n_images == N_IMAGES else dtu49_root, *size)
    opt.data.dtu.split_type = split_type
    opt.data.dtu.mask_img = mask_img
    popt = DotDict(opt.to_plain())
    ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        _loaders_agree(opt, popt, size)
    finally:
        cv2.ipp.setUseIPP(ipp)


def _loaders_agree(opt, popt, size):
    for split in ("train", "val"):
        ref = jdtu.Dataset(opt, split=split)
        got = get_dataset("dtu").Dataset(popt, split=split)
        assert got.indices == ref.indices and len(got) == len(ref) > 0
        np.testing.assert_array_equal(got.norm_trans, ref.norm_trans)
        assert float(np.abs(got.norm_trans).max()) > 1.0      # the scale_mat recentering
        np.testing.assert_array_equal(got.get_all_camera_poses(popt),
                                      ref.get_all_camera_poses(opt))
        a_ref, a_got = ref.all_arrays(opt), got.all_arrays(popt)
        assert sorted(a_got) == sorted(a_ref) and a_got["image"].shape[1:3] == size
        for k in a_ref:
            assert a_got[k].dtype == a_ref[k].dtype, k
            np.testing.assert_array_equal(a_got[k], a_ref[k], err_msg=k)
    assert float(a_got["depth_gt"].max()) > 1.0


# --------------------------------------------------------------- alignment

def _trajectories(n, seed):
    """(predicted w2c, GT w2c): GT = a sim(3) of the prediction, plus noise."""
    from scipy.spatial.transform import Rotation
    rng = np.random.RandomState(seed)
    R_true = Rotation.random(random_state=rng).as_matrix()
    s_true, t_true = 1.7, rng.randn(3)
    pred, gt = [], []
    for _ in range(n):
        R = Rotation.random(random_state=rng).as_matrix()
        t = rng.randn(3)
        pred.append(np.concatenate([R, t[:, None]], 1))
        R_gt = Rotation.from_rotvec(rng.randn(3) * 0.02).as_matrix() @ R_true @ R
        t_gt = s_true * R_true @ t + t_true + rng.randn(3) * 0.05
        gt.append(np.concatenate([R_gt, t_gt[:, None]], 1))
    return (jalign._np_invert_pose(np.stack(pred).astype(np.float32)),
            jalign._np_invert_pose(np.stack(gt).astype(np.float32)))


def _close(got, ref):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            _close(got[k], ref[k])
    elif isinstance(ref, str):
        assert got == ref
    elif isinstance(ref, tuple):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [15, 10, 9, 5])
def test_trajectory_alignment_matches_jax(n):
    """ATE above 9 cameras, the pairwise search at 9 or fewer; the fitted
    sim(3) applied to the set, backtracking and the pose errors."""
    pred, gt = _trajectories(n, seed=n)
    name = "prealign_w2c_{}_camera_systems".format("large" if n > 9 else "small")
    aligned, ssim = getattr(align, name)(pred, gt)
    aligned_j, ssim_j = getattr(jalign, name)(pred, gt)
    _close(aligned, aligned_j)
    _close(ssim, ssim_j)
    R_err, t_err = align._pose_errors_np(aligned, gt)
    _close((R_err, t_err), jalign._pose_errors_np(aligned_j, gt))
    assert R_err.mean() < 0.1 and 1e-4 < t_err.mean() < 0.5
    _close(align.apply_traj_align_ssim(pred, ssim), jalign.apply_traj_align_ssim(pred, ssim_j))
    back = align.backtrack_from_aligning_the_trajectory(gt, ssim)
    _close(back, jalign.backtrack_from_aligning_the_trajectory(gt, ssim_j))
    # backtracking undoes the alignment on the aligned set
    np.testing.assert_allclose(align.backtrack_from_aligning_the_trajectory(aligned, ssim),
                               pred, atol=2e-4)


def test_umeyama_and_translation_alignment_match_jax():
    rng = np.random.RandomState(3)
    model, data = rng.randn(12, 3), rng.randn(12, 3)
    for kw in ({}, {"known_scale": True}, {"yaw_only": True}):
        _close(align.align_umeyama(model, data, **kw), jalign.align_umeyama(model, data, **kw))
    s, _, _ = align.align_umeyama(model, np.zeros((12, 3)))       # collapsed cloud: s = 1
    assert s == 1.0
    gt = np.tile(np.eye(3, 4, dtype=np.float32), (4, 1, 1))
    gt[:, :, 3] = rng.randn(4, 3) + 5.0
    init = np.tile(np.eye(3, 4, dtype=np.float32), (4, 1, 1))
    out = align.align_translations(gt, init)
    _close(out, jalign.align_translations(gt, init))
    np.testing.assert_allclose(align._np_invert_pose(out)[:, :, 3].mean(0),
                               align._np_invert_pose(gt)[:, :, 3].mean(0), atol=1e-4)


# ------------------------------------------------- the systems, side by side

@pytest.fixture(scope="module", params=MODELS)
def pair(request, dtu_root, tmp_path_factory):
    """(JAX system, its state at step 2 with the filled leaves, port system
    carrying the same weights and the JAX system's aux state, the
    parameters as a numpy tree)."""
    from neural_invertible_warp_tpu.utils.flat_optim import FlatMultiOptimizer
    model = request.param
    over = _overrides(model, dtu_root)
    out = tmp_path_factory.mktemp(model)
    jopt = _options(config, over, out / "jax")
    train = jdtu.Dataset(jopt, split="train").all_arrays(jopt)
    test = jdtu.Dataset(jopt, split="val").all_arrays(jopt)
    jsys = jax_system_class(model)(jopt)
    jsys.attach_data(train, test)
    # the JAX system's init_state with its parameter init under jit (eagerly
    # it compiles a program per operation)
    k_param, k_aux = jax.random.split(jax.random.PRNGKey(0))
    jparams = jax.jit(jsys.init_params)(k_param)
    jsys.tx = FlatMultiOptimizer(jsys.make_optimizers(), jsys.param_labels(jparams))
    state = dict(params=jparams, opt_state=jax.jit(jsys.tx.init)(jparams),
                 step=jnp.int32(0), aux=jsys.init_aux(k_aux))
    rng = np.random.RandomState(0)

    def noise(x, scale=0.02):
        return (rng.randn(*np.shape(x)) * scale).astype(np.float32)
    params = jax.tree_util.tree_map(lambda x: np.array(x), state["params"])
    aux = {k: np.array(v) for k, v in state["aux"].items()}
    if "warp_mlp" in params:
        for block in params["warp_mlp"]["blocks"]:
            d_feat = block["c"]["w"].shape[0]
            block["c"] = {k: noise(v) for k, v in block["c"].items()}
            for branch in ("a", "b"):
                first, last = block[branch]
                first["v"][-d_feat:] = noise(first["v"][-d_feat:])     # the latent rows
                last.update({k: noise(v) for k, v in last.items()})
        # a readout that is not the identity, composed onto the initial poses
        aux["global_rigid"] = np.asarray(jlie.se3_to_SE3(jnp.asarray(noise(
            np.zeros((N_TRAIN, 6)), 0.05))))
    else:
        params["se3_refine"] = noise(params["se3_refine"], 0.01)
    state = dict(state, params=jax.tree_util.tree_map(jnp.asarray, params),
                 aux={k: jnp.asarray(v) for k, v in aux.items()}, step=jnp.int32(2))
    psys = get_system_class(model)(_options(pconfig, over, out / "port"), "cpu")
    psys.attach_data(train, test)
    psys.init_state(0)
    drawn = psys.aux["initial_poses_w2c"].clone()
    psys.init_state(0)
    assert torch.equal(psys.aux["initial_poses_w2c"], drawn)    # from the seed
    assert sorted(psys.aux) == sorted(aux)
    psys.graph.load_state_dict(weights.from_jax_params(params))
    psys.aux = {k: torch.tensor(v) for k, v in aux.items()}    # the JAX noisy_gt draw
    psys.step = 2
    return jsys, state, psys, params


def test_systems_and_labels(pair):
    jsys, state, psys, params = pair
    expected = {"barf_inn_dtu": dtu.InnDTUSystem, "barf_dtu": dtu.BarfDTUSystem}
    assert type(psys) is expected[psys.opt.model]
    assert psys.scene_depth_range == jsys.scene_depth_range
    np.testing.assert_allclose(psys.scene_depth_range, (1.2, 5.2), rtol=1e-6)
    if psys.opt.model == "barf_inn_dtu":
        assert psys.param_labels() == {"nerf": "main", "warp_mlp": "pose",
                                       "warp_latent": "latent"}
        assert psys.latent_dim() == jsys.latent_dim() == 16       # inn.real_nvp.latent_dim
        assert psys.graph.warp_latent.weight.shape == (N_TRAIN, 16)
    else:
        assert psys.param_labels() == {"nerf": "main", "se3_refine": "pose"}
    # the noisy_gt start is the GT moved by pose.noise
    init, gt = psys.aux["initial_poses_w2c"], psys.train_data["pose"]
    assert 1e-3 < float((init - gt).abs().max()) < 0.5


def _step0_grads(pair):
    """Losses, depth metrics and gradients of one train forward + backward of
    both systems on the JAX step's own draws; the port's gradients stay in
    ``.grad``."""
    jsys, state, psys, _ = pair
    opt = jsys.opt
    n_rays, K = opt.nerf.rand_rays // N_TRAIN, opt.nerf.sample_intvs
    k_perm, k_render = jax.random.split(jax.random.PRNGKey(42))
    k_depth, _ = jax.random.split(k_render)
    depth_rand = np.asarray(jax.random.uniform(k_depth, (N_TRAIN, n_rays, K, 1)))
    ray_idx = jsampling.sample_ray_subset(k_perm, H * W, n_rays, mode="stratified")

    def loss_fn(params):
        out, target, extras = jsys._forward_train(params, state["aux"], jsys.train_data,
                                                  ray_idx, k_render, state["step"])
        losses = jsys.compute_loss(params, state["aux"], jsys.train_data, out, target,
                                   state["step"], extras)
        scalars = {k: extras[k] for k in ("depth_abs", "depth_rmse")}
        return jsys.summarize_loss(losses), (losses, scalars)
    # eagerly, as the other parity tests take it: under jit, XLA's fused
    # sin/cos move these gradients by up to 2e-3 of a leaf's largest entry
    (total_j, (losses_j, scalars_j)), g_j = jax.value_and_grad(loss_fn, has_aux=True)(
        state["params"])
    psys.optim.zero_grad()
    out, target, extras = psys._forward_train(torch.from_numpy(np.array(ray_idx)).long(),
                                              psys.step, torch.tensor(depth_rand))
    losses_t = psys.compute_loss(out, target, extras)
    total_t = psys.summarize_loss(losses_t)
    total_t.backward()
    return (total_j, losses_j, scalars_j, g_j), (total_t, losses_t, extras), (ray_idx, depth_rand)


def _f64_grads(psys, ray_idx, depth_rand):
    """The port's gradients of the same step in float64 (a copy of the
    system), as a numpy tree in the JAX layout (the weight bridge rounds
    them to float32: 6e-8 of each entry)."""
    import copy
    p64 = copy.copy(psys)
    p64.graph = copy.deepcopy(psys.graph).double()
    for p in p64.graph.parameters():
        p.grad = None
    p64.train_data = {k: v.double() if v.is_floating_point() else v
                      for k, v in psys.train_data.items()}
    p64.aux = {k: v.double() for k, v in psys.aux.items()}
    out, target, extras = p64._forward_train(torch.from_numpy(np.array(ray_idx)).long(),
                                             psys.step, torch.tensor(depth_rand).double())
    p64.summarize_loss(p64.compute_loss(out, target, extras)).backward()
    return weights.to_jax_params(p64.graph, get=lambda p: p.grad)


def _jax_f64_grads(pair, ray_idx, depth_rand, monkeypatch):
    """The JAX package's gradients of the same step in float64, as a numpy
    tree. Two of its functions fix float32 whatever their inputs:
    ``sample_depth`` (which draws the jitter) and ``make_pose``. Here they
    take the injected draws and follow their inputs' dtype; everything
    else is the package's own code, under jit (in float64 XLA's fused
    sin/cos are as close as eager ones)."""
    from neural_invertible_warp_tpu.ops import pose as jpose
    jsys, state, _, _ = pair
    _, k_render = jax.random.split(jax.random.PRNGKey(42))

    def sample_depth(key, B, R, K, depth_range, param="metric", stratified=True, **kw):
        assert stratified and param == "metric" and depth_rand.shape == (B, R, K, 1)
        lo, hi = depth_range
        return (jnp.asarray(depth_rand, jnp.float64)
                + jnp.arange(K, dtype=jnp.float64)[None, None, :, None]) / K * (hi - lo) + lo

    def make_pose(R=None, t=None):
        if R is None:
            R = jnp.broadcast_to(jnp.eye(3, dtype=t.dtype), t.shape[:-1] + (3, 3))
        elif t is None:
            t = jnp.zeros(R.shape[:-1], dtype=R.dtype)
        return jnp.concatenate([R, t[..., None]], axis=-1)
    monkeypatch.setattr(jsampling, "sample_depth", sample_depth)
    monkeypatch.setattr(jpose, "make_pose", make_pose)

    def f64(x):
        x = np.asarray(x)
        return jnp.asarray(x.astype(np.float64) if x.dtype == np.float32 else x)
    with jax.enable_x64(True):
        data = {k: f64(v) for k, v in jsys.train_data.items()}
        aux = {k: f64(v) for k, v in state["aux"].items()}

        def loss_fn(params):
            out, target, extras = jsys._forward_train(params, aux, data, ray_idx, k_render,
                                                      state["step"])
            return jsys.summarize_loss(jsys.compute_loss(params, aux, data, out, target,
                                                         state["step"], extras))
        grads = jax.jit(jax.grad(loss_fn))(jax.tree_util.tree_map(f64, state["params"]))
        return jax.tree_util.tree_map(np.asarray, grads)


def test_step0_losses_gradients_and_adam_step(pair, monkeypatch):
    """Losses rtol 1e-5, the depth metrics, every gradient leaf, then one
    Adam step.

    Every leaf is held three ways. (1) The port's float64 evaluation
    against the JAX package's float64 evaluation of the same step, to 1e-6
    of the leaf's largest entry (they read at most 5.2e-8 apart: the
    progress stays float32 in both, and the bridge rounds the port's). (2) The port against JAX in float32,
    rtol 1e-4 plus 1e-5 of the leaf's largest entry wherever JAX's float32
    lies that close to its float64, else plus 1e-4. The field's PE takes
    DTU's world points, up to 8 units out, and the INN warp of barf_inn_dtu
    points 3 to 4 units out, whose embedding angles reach 350 rad; there
    JAX's float32 evaluation of 17 of barf_inn_dtu's 49 leaves (the first
    trunk layers, the head, the warp's output biases) and of barf_dtu's
    se3_refine lies 1.2e-5 to 5.6e-5 of the leaf's largest entry from its
    float64 one, and the port's 8e-8 to 3.1e-5. (3) The port's float32
    lies no farther from JAX's float64 than JAX's own float32 does, plus
    1e-5 of the leaf's largest entry."""
    jsys, state, psys, params = pair
    (total_j, losses_j, scalars_j, g_j), (total_t, losses_t, extras), draws = \
        _step0_grads(pair)
    expected = ["global_alignment", "render"] if "inn" in psys.opt.model else ["render"]
    assert sorted(losses_t) == sorted(losses_j) == expected
    for k in losses_j:
        np.testing.assert_allclose(float(losses_t[k].detach()), float(losses_j[k]),
                                   rtol=1e-5, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(float(total_t.detach()), float(total_j), rtol=1e-5)
    for k in ("depth_abs", "depth_rmse"):
        assert extras[k].ndim == 0 and not extras[k].requires_grad
        np.testing.assert_allclose(float(extras[k]), float(scalars_j[k]), rtol=1e-5, err_msg=k)
    g_t = weights.to_jax_params(psys.graph, get=lambda p: p.grad)
    lj = jax.tree_util.tree_leaves_with_path(g_j)
    lt = jax.tree_util.tree_leaves(g_t)
    l64 = jax.tree_util.tree_leaves(_f64_grads(psys, *draws))
    lj64 = jax.tree_util.tree_leaves(_jax_f64_grads(pair, *draws, monkeypatch))
    assert len(lj) == len(lt) == len(l64) == len(lj64) > 10
    for (path, a), b, c, d in zip(lj, lt, l64, lj64):
        a, name = np.asarray(a), jax.tree_util.keystr(path)
        scale = np.abs(a).max()
        assert scale > 0 and d.dtype == np.float64, name
        assert np.abs(c - d).max() <= 1e-6 * scale, name
        jax_err = np.abs(a - d).max()
        atol = (1e-5 if jax_err <= 1e-5 * scale else 1e-4) * scale
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=atol, err_msg=name)
        assert np.abs(b - d).max() <= jax_err + 1e-5 * scale, name

    # one Adam step from these gradients
    updates, _ = jax.jit(jsys.tx.update)(g_j, state["opt_state"], state["params"])
    stepped = optax.apply_updates(state["params"], updates)
    psys.optim.step()
    opt = jsys.opt
    lrs = dict(nerf=opt.optim.lr, warp_mlp=opt.optim.lr_pose, warp_latent=opt.optim.lr_pose,
               se3_refine=opt.optim.lr_pose)
    for (path, a), b, g in zip(jax.tree_util.tree_leaves_with_path(stepped),
                               jax.tree_util.tree_leaves(weights.to_jax_params(psys.graph)),
                               jax.tree_util.tree_leaves(g_j)):
        a, g = np.asarray(a), np.abs(np.asarray(g))
        noisy = g < 1e-4 * g.max()
        err = np.abs(b - a)
        name = jax.tree_util.keystr(path)
        assert np.all(err[~noisy] <= 1e-6 + 1e-5 * np.abs(a[~noisy])), name
        assert np.all(err[noisy] <= 2 * lrs[path[0].key] + 1e-6), name
    psys.graph.load_state_dict(weights.from_jax_params(params))    # back to the pair's weights


def test_pose_readout_alignment_and_eval_pose(pair):
    jsys, state, psys, _ = pair
    pose_t, gt_t = psys.get_all_training_poses()
    pose_j, gt_j = jsys.get_all_training_poses(state)
    np.testing.assert_allclose(pose_t.numpy(), pose_j, atol=1e-6)
    np.testing.assert_array_equal(gt_t.numpy(), gt_j)
    init = psys.aux["initial_poses_w2c"]
    assert float((pose_t - init).abs().max()) > 1e-3      # the readout moves the start
    R_t, t_t = psys.evaluate_camera_alignment()
    R_j, t_j = jsys.evaluate_camera_alignment(state)       # 10 cameras: ATE
    np.testing.assert_allclose(R_t, R_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t_t, t_j, rtol=1e-4, atol=1e-6)
    for k in ("R", "t", "s"):
        np.testing.assert_allclose(psys.ssim_est_gt_c2w[k], jsys.ssim_est_gt_c2w[k],
                                   rtol=1e-4, atol=1e-6)
    assert psys.depth_scaling_factor() == psys.ssim_est_gt_c2w["s"] != 1.0
    pose_GT = psys.test_data["pose"][:1]
    got = psys.get_eval_pose(pose_GT)
    ref = jsys.get_eval_pose(state["params"], state["aux"], jsys.test_data["pose"][:1])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert float((got - pose_GT).abs().max()) > 1e-3


def test_evaluate_full_matches_jax(pair, tmp_path):
    """``evaluate_full`` without refinement: PSNR, SSIM, the depth errors at
    the sim(3) scale and the masked metrics, rtol 1e-4."""
    jsys, state, psys, _ = pair
    ref = jsys.evaluate_full(state, output_path=str(tmp_path / "jax"), test_optim=False)
    got = psys.evaluate_full(output_path=str(tmp_path / "port"), test_optim=False)
    assert sorted(got) == sorted(ref)
    for k in ("PSNR", "SSIM", "depth_abs", "depth_rms", "PSNR_masked", "SSIM_masked",
              "rot_error_deg", "trans_error"):
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    assert got["LPIPS"] is got["LPIPS_masked"] is ref["LPIPS_masked"] is None
    for name in ("quant.txt", "quant_pose.txt"):
        assert os.path.isfile(os.path.join(str(tmp_path / "port"), name))


def test_checkpoints_both_ways(pair, tmp_path):
    """The port's checkpoint restores into the JAX state, the JAX one into a
    fresh port system (weights, warp_latent as the plain array the JAX tree
    holds, the noisy_gt start from the file, not redrawn)."""
    jsys, state, psys, _ = pair
    tree = weights.to_jax_params(psys.graph)
    if "warp_latent" in tree:
        assert tree["warp_latent"].shape == (N_TRAIN, 16)
        np.testing.assert_array_equal(tree["warp_latent"], np.asarray(state["params"]["warp_latent"]))
    ckpt.save(str(tmp_path / "p"), psys, 2)
    restored, it = jckpt.restore_checkpoint(str(tmp_path / "p"), state)
    assert it == 2
    for a, b in zip(jax.tree_util.tree_leaves(restored["params"]), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    jckpt.save_checkpoint(str(tmp_path / "j"), state, 2)
    other = get_system_class(psys.opt.model)(psys.opt, "cpu")
    other.attach_data({k: v.numpy() for k, v in psys.train_data.items()},
                      {k: v.numpy() for k, v in psys.test_data.items()})
    other.init_state(7)
    assert not torch.equal(other.aux["initial_poses_w2c"], psys.aux["initial_poses_w2c"])
    assert ckpt.restore(str(tmp_path / "j"), other) == 2 and other.step == 2
    for k in state["aux"]:
        np.testing.assert_array_equal(other.aux[k].numpy(), np.asarray(state["aux"][k]), err_msg=k)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(state["params"]),
                            jax.tree_util.tree_leaves(weights.to_jax_params(other.graph))):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------- the port on its own

def _tiny_system(model="barf_inn_dtu", fine=False, init="noisy_gt", seed=0,
                 output_path="unused", **pose):
    """A tiny port system on chip_smoke.py's in-memory DTU scene; ``pose``
    updates the ``pose`` options."""
    import chip_smoke as cs
    from neural_invertible_warp_tpu_torch.barf_inn_dtu import barf_inn_dtu_options
    opt = barf_inn_dtu_options()
    opt.update(model=model, H=8, W=10, output_path=output_path, max_iter=20)
    opt.arch.update(layers_feat=[None, 16, 16, 16], layers_rgb=[None, 8, 3], skip=[1])
    opt.inn.real_nvp.update(d_hidden=8, latent_dim=4)
    opt.nerf.update(rand_rays=24, sample_intvs=8)
    opt.pose.init = init
    opt.pose.update(pose)
    opt.optim.test_iter = 2
    if fine:
        opt.nerf.update(fine_sampling=True, sample_intvs_fine=8)
        opt.loss_weight.render_fine = 0
    system = get_system_class(model)(opt, "cpu")
    system.attach_data(cs.make_dtu_scene(8, 10, 6, seed=0), cs.make_dtu_scene(8, 10, 2, seed=1))
    system.init_state(seed)
    return system


@pytest.mark.parametrize("model,fine", [("barf_inn_dtu", False), ("barf_inn_dtu", True),
                                        ("barf_dtu", False)])
def test_every_render_samples_the_scene_depth_range(model, fine, monkeypatch):
    """The options' nerf.depth.range is [1, 0]; the train render (and its
    fine resample), render_image and test-time refinement all sample the
    scene's metric [1.2, 5.2]."""
    system = _tiny_system(model, fine)
    assert tuple(system.opt.nerf.depth.range) == (1, 0)
    seen = []
    for name in ("sample_depth", "sample_depth_from_pdf"):
        real = getattr(sampling, name)

        def spy(*args, _real=real, **kw):
            depth = _real(*args, **kw)
            seen.append((float(depth.min()), float(depth.max())))
            return depth
        monkeypatch.setattr(sampling, name, spy)
    ranges = {}
    system.train_step()
    ranges["train"], seen[:] = list(seen), []
    system.render_image(system.test_data["pose"][:1], system.test_data["intr"][:1])
    ranges["render_image"], seen[:] = list(seen), []
    system.test_time_optimized_pose(system.test_data["pose"][:1], system.test_data["intr"][:1],
                                    system.test_data["pixels"][:1])
    ranges["refinement"] = list(seen)
    assert len(ranges["train"]) == (2 if fine else 1)
    assert len(ranges["render_image"]) == 4 * (2 if fine else 1)     # 80 rays in chunks of 24
    assert len(ranges["refinement"]) == 2 * (2 if fine else 1)
    for phase, calls in ranges.items():
        for lo, hi in calls:
            assert 1.2 <= lo and hi <= 5.2, (phase, lo, hi)
    assert max(hi for _, hi in ranges["train"]) > 4.5 and min(lo for lo, _ in ranges["train"]) < 1.5


def test_inn_readout_starts_at_the_initial_poses():
    """global_rigid starts at the identity, so the readout at step 0 is the
    initial poses, composed in once."""
    system = _tiny_system()
    eye = torch.eye(3, 4).expand(6, 3, 4)
    assert torch.equal(system.aux["global_rigid"], eye)
    torch.testing.assert_close(system.get_all_training_poses()[0],
                               system.aux["initial_poses_w2c"], rtol=0, atol=1e-6)
    given = _tiny_system(init="given")
    assert torch.equal(given.aux["initial_poses_w2c"], given.train_data["pose"])
    identity = _tiny_system(init="identity")
    centers = align._np_invert_pose(identity.aux["initial_poses_w2c"].numpy())[:, :, 3]
    gt_centers = align._np_invert_pose(identity.train_data["pose"].numpy())[:, :, 3]
    np.testing.assert_allclose(centers.mean(0), gt_centers.mean(0), atol=1e-5)


@pytest.mark.parametrize("init", ["colmap", "colmap_files"])
def test_sfm_pose_inits_name_the_roadmap_item(init, tmp_path):
    """The SfM pose inits (which raised and named ROADMAP M15 until they
    were ported; tests/test_torch_colmap.py holds them against the JAX
    package) on the tiny in-memory scene. ``colmap_files``: a COLMAP model
    of the GT poses, read in image_id order (in-memory arrays carry no file
    names), gives the GT poses back. ``colmap``: the ZNCC matcher, on the
    system's device, finds no corner whose patch fits into an 8x10 view, so
    the SfM excludes every image and the start is the identity aligned on
    all of them: finite, and the same for every image."""
    from neural_invertible_warp_tpu_torch.utils import colmap_io
    if init == "colmap_files":
        gt = _tiny_system("barf_dtu", init="given").train_data["pose"].double().numpy()
        cameras = {1: colmap_io.Camera(1, "PINHOLE", 10, 8, np.array([17.5, 17.5, 5.0, 4.0]))}
        images = {i + 1: colmap_io.Image(i + 1, colmap_io.rotmat2qvec(gt[i, :, :3]),
                                         gt[i, :, 3], 1, "{}.png".format(i), np.zeros((0, 2)),
                                         np.zeros((0,), np.int64)) for i in range(len(gt))}
        colmap_io.write_model(cameras, images, {}, str(tmp_path), ext=".txt")
        system = _tiny_system("barf_dtu", init=init, model_dir=str(tmp_path))
        assert (system.sfm_valid_idx, system.sfm_excluded) == (list(range(6)), [])
        torch.testing.assert_close(system.aux["initial_poses_w2c"], system.train_data["pose"],
                                   rtol=0, atol=1e-5)
    else:
        system = _tiny_system("barf_dtu", init=init, output_path=str(tmp_path))
        assert (system.sfm_valid_idx, system.sfm_excluded) == ([], list(range(6)))
        assert sorted(os.listdir(tmp_path / "sfm")) == ["initial_poses.npz", "matches.npz"]
        init_poses = system.aux["initial_poses_w2c"]
        assert bool(torch.isfinite(init_poses).all())
        torch.testing.assert_close(init_poses, init_poses[:1].expand(6, 3, 4), rtol=0, atol=0)
    assert np.isfinite(float(system.train_step()["loss_all"]))


def test_export_dtu_cameras_round_trip(dtu_root, tmp_path):
    """``--export_dtu_cameras`` of the GT poses gives back the scan's own
    projection matrices: the export undoes the loader's recentering and
    1/300 scaling and applies K @ w2c in the original DTU frame."""
    from neural_invertible_warp_tpu_torch import evaluate
    opt = DotDict(synth_data.dtu_opt(dtu_root).to_plain())
    opt.output_path = str(tmp_path)
    ds = get_dataset("dtu").Dataset(opt, split="train")
    gt_w2c = torch.tensor(ds.get_all_camera_poses(opt))

    class GTPoses:
        def get_all_training_poses(self):
            return gt_w2c, gt_w2c
    out = evaluate.export_dtu_cameras(opt, GTPoses(), ds, mode="gt")
    written = np.load(out)
    orig = np.load(os.path.join(dtu_root, "rs_dtu_4", "DTU", "scan1", "cameras.npz"))
    assert len([k for k in written.files if k.startswith("world_mat")]) == len(ds) == N_TRAIN
    for j, i in enumerate(ds.indices):
        np.testing.assert_allclose(written["world_mat_%d" % j],
                                   orig["world_mat_%d" % i].astype(np.float32),
                                   rtol=2e-4, atol=2e-3)


def test_train_and_evaluate_entry_points_on_cpu(dtu_root, tmp_path):
    """``python -m ...train`` and ``...evaluate --export_dtu_cameras`` in
    process with ``--device=cpu``: a few steps with the depth metrics, then
    quant.txt, quant_pose.txt and cameras_refined.npz. Without that flag
    and without a card both refuse to start."""
    from neural_invertible_warp_tpu_torch import evaluate, train
    flags = _overrides("barf_inn_dtu", dtu_root, max_iter=3) + [
        "--freq.scalar=1", "--freq.val=100", "--freq.ckpt=100",
        "--optim.test_iter=2", "--group=cli", "--name=dtu",
        "--output_root={}".format(tmp_path)]
    if not torch.cuda.is_available():
        for main in (train.main, evaluate.main):
            with pytest.raises(RuntimeError, match="--device=cpu"):
                main(flags)
    trainer = train.main(flags + ["--device=cpu"])
    assert trainer.system.step == 3 and type(trainer.system) is dtu.InnDTUSystem
    for m in trainer.history:
        assert all(np.isfinite(float(m[k])) for k in ("loss_all", "depth_abs", "depth_rmse"))
    results = evaluate.main(flags + ["--device=cpu", "--export_dtu_cameras",
                                     "--novel_view_video!"])
    for k in ("PSNR", "depth_abs", "depth_rms", "PSNR_masked", "SSIM_masked", "rot_error_deg"):
        assert np.isfinite(results[k]), k
    out_dir = os.path.join(str(tmp_path), "cli", "dtu")
    rows = open(os.path.join(out_dir, "quant.txt")).read().split("\n")[:-1]
    assert len(rows) == 2                           # dtuhold 8 of 12 images: 0 and 8
    assert len(open(os.path.join(out_dir, "quant_pose.txt")).read().split("\n")) == N_TRAIN + 1
    cams = np.load(os.path.join(out_dir, "cameras_refined.npz"))
    assert sorted(cams.files) == sorted("world_mat_%d" % i for i in range(N_TRAIN))


def test_options_dict_equals_yaml_resolution():
    from neural_invertible_warp_tpu_torch.barf_inn_dtu import barf_inn_dtu_options
    opt = config.load_options("options/barf_inn_dtu.yaml")
    over = config.parse_arguments(["--model=barf_inn_dtu", "--yaml=barf_inn_dtu"])
    opt = config.override_options(opt, over, key_stack=[], safe_check=True)
    assert opt.to_plain() == barf_inn_dtu_options()
    assert barf_inn_dtu_options() is not barf_inn_dtu_options()
