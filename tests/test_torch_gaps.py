"""The options the port used to refuse, each against the JAX package on the
CPU: gradient clipping (``optim.clip_norm`` / ``clip_norm_pose``), the
``topk`` and ``permutation`` ray draws, NDC rays (``camera.ndc``), the INN
activations silu / elu / sine / gaussian, the log maps and quaternion and
6D helpers of ops/lie.py, ``options.yaml``, and the engine's tensorboard
writer, live pose view (``freq.vis``), ``debug.nan_check`` and
``tpu.profile_dir``.

Tolerances: elementwise maps and the lie helpers rtol 1e-5 / atol 1e-6
(1e-5 on gradients); clipping and the Adam step after it 1e-6; the NDC
train step as tests/test_torch_train_step.py holds a step (losses rtol
1e-5, every gradient leaf rtol 1e-4 plus 1e-5 of its largest entry); files
and draws exactly.
"""

import functools
import io
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import yaml

from neural_invertible_warp_tpu import config as jconfig
from neural_invertible_warp_tpu.models import engine as jengine
from neural_invertible_warp_tpu.models import get_system_class as jax_system_class
from neural_invertible_warp_tpu.ops import inn as jinn
from neural_invertible_warp_tpu.ops import lie as jlie
from neural_invertible_warp_tpu.ops import rays as jrays
from neural_invertible_warp_tpu.ops import sampling as jsampling
from neural_invertible_warp_tpu.utils import pose_viewer as jpose_viewer
from neural_invertible_warp_tpu_torch import config
from neural_invertible_warp_tpu_torch.dotdict import DotDict
from neural_invertible_warp_tpu_torch.models import get_system_class
from neural_invertible_warp_tpu_torch.models.engine import Trainer
from neural_invertible_warp_tpu_torch.ops import inn, lie, rays, sampling
from neural_invertible_warp_tpu_torch.ops.cuda import fused_inn
from neural_invertible_warp_tpu_torch.parallel import audit
from neural_invertible_warp_tpu_torch.utils import ckpt, image_io, weights
from neural_invertible_warp_tpu_torch.utils.optim import MultiAdam

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

H = W = 16
N_IMG = 4
TINY = ["--data.image_size=[16,16]", "--arch.layers_feat=[null,32,32,32,32]",
        "--arch.layers_rgb=[null,16,3]", "--arch.skip=[2]", "--arch.posenc.L_3D=4",
        "--arch.posenc.L_view=2", "--nerf.sample_intvs=16", "--nerf.rand_rays=64",
        "--max_iter=100"]


def _options(flags, out="unused"):
    opt = jconfig.load_options("options/barf_llff.yaml")
    opt = jconfig.override_options(
        opt, jconfig.parse_arguments(["--model=barf", "--yaml=barf_llff"] + TINY + flags),
        key_stack=[], safe_check=True)
    opt.H, opt.W = H, W
    opt.output_path = str(out)
    return opt


def _arrays(n, seed):
    rng = np.random.RandomState(seed)
    return dict(image=rng.rand(n, H, W, 3).astype(np.float32),
                intr=np.tile(np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]],
                                      np.float32), (n, 1, 1)),
                pose=np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1)),
                idx=np.arange(n, dtype=np.int32))


def _close(got, ref, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=msg)


# ---------------------------------------------------------------- clipping

@functools.partial(jax.jit, static_argnums=3)
def _optax_clip_adam(params, grads, limit, lr):
    """Per group: (the gradients clipped, the parameters after one step of
    optax.chain(clip_by_global_norm(limit), adam(lr))), the main group
    clipped, the pose group not."""
    out = {}
    for k in params:
        clip = optax.clip_by_global_norm(limit)
        tx = optax.chain(clip, optax.adam(lr)) if k == "main" else optax.adam(lr)
        clipped = clip.update(grads[k], None)[0] if k == "main" else grads[k]
        updates, _ = tx.update(grads[k], tx.init(params[k]), params[k])
        out[k] = (clipped, optax.apply_updates(params[k], updates))
    return out


@pytest.mark.parametrize("limit", [0.5, 50.0], ids=["clipped", "below"])
def test_clip_by_global_norm_per_group_then_adam(limit):
    """MultiAdam's clip against optax.chain(clip_by_global_norm, adam), per
    label group: the main group at ``limit`` (below or above its norm of
    ~3), the pose group unclipped."""
    rng = np.random.RandomState(0)
    shapes = {"main": [(3, 4), (5,)], "pose": [(2, 6)]}
    params = {k: [rng.randn(*s).astype(np.float32) for s in v] for k, v in shapes.items()}
    grads = {k: [rng.randn(*s).astype(np.float32) for s in v] for k, v in shapes.items()}
    lr = 1e-2
    tparams = {k: [torch.nn.Parameter(torch.tensor(p)) for p in v] for k, v in params.items()}
    optim = MultiAdam(tparams, {k: (lambda count: lr) for k in shapes}, clips={"main": limit})
    for k in shapes:
        for p, g in zip(tparams[k], grads[k]):
            p.grad = torch.tensor(g)
    optim.step()
    ref = _optax_clip_adam(params, grads, jnp.float32(limit), lr)
    for k in shapes:
        clipped, new = ref[k]
        for p, c, n in zip(tparams[k], clipped, new):
            _close(p.grad, c, msg=k)
            _close(p.detach(), n, rtol=1e-6, msg=k)
    norm = np.sqrt(sum(float(np.sum(g ** 2)) for g in grads["main"]))
    assert (norm > limit) == (limit == 0.5)


def test_clip_options_reach_every_group_and_the_checkpoint(tmp_path):
    """clip_norm on the main group, clip_norm_pose on the pose and latent
    groups (the JAX package's clip_wrap), and the clipped groups' state in
    the JAX package's chain layout, ((), adam state), both ways."""
    opt = _options([], tmp_path)
    opt.model = "barf_inn_llff"
    opt.optim.clip_norm, opt.optim.clip_norm_pose = 0.1, 0.01
    for k, v in jconfig.load_options("options/barf_inn_llff.yaml").items():
        opt.setdefault(k, v)
    psys = get_system_class("barf_inn_llff")(DotDict(opt.to_plain()), "cpu")
    psys.attach_data(_arrays(N_IMG, 0), _arrays(1, 1))
    psys.init_state(0)
    assert psys.optim.clips == {"main": 0.1, "pose": 0.01, "latent": 0.01}
    psys.train_step()
    state = ckpt.state_tree(psys)
    assert all(state["opt_state"][k][0] == () for k in ("main", "pose", "latent"))
    other = get_system_class("barf_inn_llff")(DotDict(opt.to_plain()), "cpu")
    other.attach_data(_arrays(N_IMG, 0), _arrays(1, 1))
    other.init_state(1)
    ckpt.load_state_tree(other, state)
    for p, q in zip(psys.optim.parameters(), other.optim.parameters()):
        for a, b in zip(psys.optim.moments(p), other.optim.moments(q)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------- ray draws

def test_topk_draw_equals_lax_top_k():
    rng = np.random.RandomState(1)
    u = rng.rand(300).astype(np.float32)
    u[[7, 70, 170]] = u.max()           # ties keep index order, as lax.top_k's
    u[[3, 30]] = u[np.argsort(u)[-20]]
    got = sampling.sample_ray_subset(300, 40, mode="topk", u=torch.tensor(u))
    _, ref = jax.lax.top_k(jnp.asarray(u), 40)
    assert got.tolist() == np.asarray(ref).tolist()


def test_permutation_draw_law():
    """torch's stream cannot be JAX's: the law instead. Distinct indices in
    range, and every index drawn as often as any other (within 5 sigma)."""
    gen = torch.Generator().manual_seed(0)
    n_total, n_pick, n_draws = 16, 4, 4000
    counts = np.zeros(n_total)
    for _ in range(n_draws):
        idx = sampling.sample_ray_subset(n_total, n_pick, mode="permutation", generator=gen)
        assert idx.shape == (n_pick,) and len(set(idx.tolist())) == n_pick
        assert 0 <= int(idx.min()) and int(idx.max()) < n_total
        counts[idx.numpy()] += 1
    expect = n_draws * n_pick / n_total
    sigma = np.sqrt(n_draws * (n_pick / n_total) * (1 - n_pick / n_total))
    assert np.all(np.abs(counts - expect) < 5 * sigma), counts
    with pytest.raises(ValueError):
        sampling.sample_ray_subset(n_total, n_pick, mode="sorted")


# ---------------------------------------------------------------------- NDC

def test_convert_ndc_values_and_gradients():
    rng = np.random.RandomState(2)
    center = (rng.randn(2, 9, 3) * 0.1).astype(np.float32)
    ray = np.concatenate([rng.randn(2, 9, 2) * 0.3, 1 + rng.rand(2, 9, 1)], -1).astype(np.float32)
    intr = np.stack([np.array([[f, 0, 8], [0, f * 1.1, 7], [0, 0, 1]], np.float32)
                     for f in (20.0, 25.0)])
    cot = [rng.randn(2, 9, 3).astype(np.float32) for _ in range(2)]
    out_j, vjp = jax.vjp(lambda c, r: jrays.convert_NDC(c, r, jnp.asarray(intr)),
                         jnp.asarray(center), jnp.asarray(ray))
    g_j = vjp(tuple(jnp.asarray(c) for c in cot))
    c, r = torch.tensor(center, requires_grad=True), torch.tensor(ray, requires_grad=True)
    out_t = rays.convert_NDC(c, r, torch.tensor(intr))
    sum(torch.sum(o * torch.tensor(k)) for o, k in zip(out_t, cot)).backward()
    for a, b in zip(out_t, out_j):
        _close(a.detach(), b)
    _close(c.grad, g_j[0], atol=1e-5)
    _close(r.grad, g_j[1], atol=1e-5)


def test_ndc_step_with_topk_draw_against_jax(tmp_path):
    """One step of a tiny LLFF BARF with ``camera.ndc`` (metric depths in
    [0, 1] along the NDC rays) and ``tpu.ray_sample: topk``: loss and every
    gradient leaf against the JAX step on the same draws."""
    opt = _options(["--camera.ndc", "--tpu.ray_sample=topk", "--nerf.depth.param=metric",
                    "--nerf.depth.range=[0,1]"], tmp_path)
    psys = get_system_class("barf")(DotDict(opt.to_plain()), "cpu")
    psys.attach_data(_arrays(N_IMG, 0), _arrays(1, 1))
    psys.init_state(0)
    jsys = jax_system_class("barf")(opt)
    jsys.attach_data(_arrays(N_IMG, 0), _arrays(1, 1))
    state = dict(params=jax.tree_util.tree_map(jnp.asarray, weights.to_jax_params(psys.graph)),
                 aux={}, step=jnp.int32(0))
    n_rays, K = opt.nerf.rand_rays // N_IMG, opt.nerf.sample_intvs
    key = jax.random.PRNGKey(5)
    k_perm, k_render = jax.random.split(key)
    k_depth, _ = jax.random.split(k_render)
    ray_u = np.asarray(jax.random.uniform(k_perm, (H * W,)))
    depth_rand = np.asarray(jax.random.uniform(k_depth, (N_IMG, n_rays, K, 1)))
    ray_idx = jsampling.sample_ray_subset(k_perm, H * W, n_rays, mode="topk")

    def loss_fn(params):
        out, target, extras = jsys._forward_train(params, state["aux"], jsys.train_data,
                                                  ray_idx, k_render, state["step"])
        losses = jsys.compute_loss(params, state["aux"], jsys.train_data, out, target,
                                   state["step"], extras)
        return jsys.summarize_loss(losses), losses
    (total_j, losses_j), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state["params"])
    job = dict(options=opt.to_plain(), train=_arrays(N_IMG, 0), test=_arrays(1, 1),
               steps=1, draws=[dict(ray_u=ray_u, depth_rand=depth_rand)])
    res = audit.run_job(job, "cpu")
    np.testing.assert_allclose(res["metrics"][0]["loss_render"], float(losses_j["render"]),
                               rtol=1e-5)
    np.testing.assert_allclose(res["metrics"][0]["loss_all"], float(total_j), rtol=1e-5)
    ref = {k: v.numpy() for k, v in weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, g_j)).items()}
    assert sorted(res["grads"][0]) == sorted(ref)
    for name, a in ref.items():
        assert np.abs(a).max() > 0, name
        np.testing.assert_allclose(res["grads"][0][name], a, rtol=1e-4,
                                   atol=1e-5 * np.abs(a).max(), err_msg=name)


# ------------------------------------------------------------ INN activations

def _deform_params(seed, d_feat=8, d_hidden=16):
    params = jinn.init_deform_params(jax.random.PRNGKey(seed), d_feat, d_hidden=d_hidden,
                                     n_blocks=1, multires=6)
    rng = np.random.RandomState(seed)

    def fill(x):
        x = np.asarray(x)
        return (rng.randn(*x.shape) * 0.05).astype(np.float32) if not np.any(x) else x
    return jax.tree_util.tree_map(fill, params)


@pytest.mark.parametrize("actfn", ["silu", "elu", "sine", "gaussian"])
def test_inn_activation_through_deform_network(actfn):
    """Values and every gradient through one coupling block (the activation
    sits in each of its MLPs) against the JAX package's deform_forward."""
    params = _deform_params(1)
    rng = np.random.RandomState(2)
    code = rng.randn(3, 8).astype(np.float32)
    pts = rng.randn(3, 20, 3).astype(np.float32)
    cot = rng.randn(3, 20, 3).astype(np.float32)

    def jf(params, pts):
        out = jinn.deform_forward(params, jnp.asarray(code), pts, 0.4, multires=6,
                                  actfn=actfn, n_blocks=1)
        return jnp.sum(out * cot), out
    (_, out_j), g_j = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(pts))
    net = inn.DeformNetwork(8, d_hidden=16, n_blocks=1, multires=6, actfn=actfn)
    net.load_state_dict(weights.deform_from_jax(params))
    p = torch.tensor(pts, requires_grad=True)
    out_t = net(torch.tensor(code), p, 0.4)
    torch.sum(out_t * torch.tensor(cot)).backward()
    _close(out_t.detach(), out_j)
    _close(p.grad, g_j[1], rtol=1e-4, atol=1e-5)
    leaves_j = jax.tree_util.tree_leaves(g_j[0])
    leaves_t = jax.tree_util.tree_leaves(weights.deform_to_jax(net, get=lambda q: q.grad))
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_j, leaves_t):
        a = np.asarray(a)
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5 * np.abs(a).max() + 1e-7)
    # the warp kernel covers softplus only, as the JAX kernel's supports does
    net3 = inn.DeformNetwork(8, d_hidden=128, multires=6, actfn=actfn)
    assert fused_inn.uncovered(net3) == ["actfn={} (kernel: softplus)".format(actfn)]
    with pytest.raises(ValueError, match="actfn"):
        fused_inn.fused_deform_forward(net3, torch.tensor(code), p, 0.4)


def test_unknown_inn_activation_raises_value_error():
    with pytest.raises(ValueError):
        inn.DeformNetwork(8, d_hidden=16, actfn="tanh")
    with pytest.raises(ValueError):
        jinn._activation("tanh")


# -------------------------------------------------------------- lie helpers

@jax.jit
def _jax_lie(w, wu, x, q, q2, w9, cot):
    R = jlie.so3_to_SO3(w)
    Rt = jlie.se3_to_SE3(wu)
    Rq = jlie.q_to_R(q)
    return dict(
        R=R, log_R=jlie.SO3_to_so3(R), Rt=Rt, log_Rt=jlie.SE3_to_se3(Rt),
        log_eye=jlie.SE3_to_se3(jnp.eye(3, 4)[None]),
        taylor=[jlie.taylor_A(x), jlie.taylor_B(x), jlie.taylor_C(x)],
        grad_log_R=jax.grad(lambda r: jnp.sum(jlie.SO3_to_so3(r) * cot))(R),
        Rq=Rq, q_back=jlie.R_to_q(Rq), q_inv=jlie.q_invert(q), q_prod=jlie.q_product(q, q2),
        sixd=jlie.sixd_to_SE3(w9))


def test_lie_helpers_at_the_identity_and_pi():
    """The log maps (where their clamps and eps act: at the identity and
    at pi; at pi - 1e-2, not nearer, as 1 / sin(theta) magnifies the last
    bit of the arccos in both packages), the Taylor series, the quaternion
    helpers (a half turn included) and the 6D rotation (parallel axes
    included) against the JAX package's."""
    rng = np.random.RandomState(3)
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    w = np.stack([np.zeros(3), 1e-4 * axis, 0.7 * axis, rng.randn(3), (np.pi - 1e-2) * axis,
                  np.pi * axis, np.array([np.pi, 0, 0])]).astype(np.float32)
    wu = np.concatenate([w, rng.randn(len(w), 3)], -1).astype(np.float32)
    x = np.concatenate([[0.0, 1e-4], np.linspace(0.1, np.pi, 9)]).astype(np.float32)
    q = rng.randn(8, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0], q[1] = [1, 0, 0, 0], [0, 1, 0, 0]
    q2 = rng.randn(8, 4).astype(np.float32)
    w9 = rng.randn(8, 9).astype(np.float32)
    w9[0, :6] = [1, 0, 0, 2, 0, 0]
    cot = rng.randn(len(w), 3).astype(np.float32)
    ref = {k: jax.tree_util.tree_map(np.asarray, v) for k, v in _jax_lie(
        *[jnp.asarray(a) for a in (w, wu, x, q, q2, w9, cot)]).items()}
    _close(lie.so3_to_SO3(torch.tensor(w)), ref["R"])
    _close(lie.SO3_to_so3(torch.tensor(ref["R"])), ref["log_R"], atol=1e-5)
    _close(lie.se3_to_SE3(torch.tensor(wu)), ref["Rt"])
    _close(lie.SE3_to_se3(torch.tensor(ref["Rt"])), ref["log_Rt"], atol=1e-5)
    np.testing.assert_array_equal(lie.SE3_to_se3(torch.eye(3, 4)[None]).numpy(), ref["log_eye"])
    for name, r in zip(("taylor_A", "taylor_B", "taylor_C"), ref["taylor"]):
        _close(getattr(lie, name)(torch.tensor(x)), r, msg=name)
    R = torch.tensor(ref["R"], requires_grad=True)
    torch.sum(lie.SO3_to_so3(R) * torch.tensor(cot)).backward()
    _close(R.grad, ref["grad_log_R"], rtol=1e-4, atol=1e-4 * np.abs(ref["grad_log_R"]).max())
    qt = torch.tensor(q)
    _close(lie.q_to_R(qt), ref["Rq"])
    _close(lie.R_to_q(torch.tensor(ref["Rq"])), ref["q_back"])
    _close(lie.q_invert(qt), ref["q_inv"])
    _close(lie.q_product(qt, torch.tensor(q2)), ref["q_prod"])
    _close(lie.sixd_to_SE3(torch.tensor(w9)), ref["sixd"], atol=1e-5)


# ------------------------------------------------------------ options.yaml

def test_options_file_and_its_drift_guard(tmp_path, monkeypatch):
    """The same file as the JAX package's save_options_file; a rerun with
    other options keeps the old file as options_prev.yaml off a TTY and
    asks on one."""
    opt = _options([])
    monkeypatch.setattr(sys, "stdin", io.StringIO())
    out_j, out_t = tmp_path / "jax", tmp_path / "port"
    out_j.mkdir()
    out_t.mkdir()
    opt.output_path = str(out_j)
    jconfig.save_options_file(opt)
    popt = DotDict(opt.to_plain())
    popt.output_path = str(out_t)
    popt.device = "cpu"
    config.save_options_file(popt)
    text_t = (out_t / "options.yaml").read_text()
    assert text_t == (out_j / "options.yaml").read_text().replace(str(out_j), str(out_t))
    assert "device" not in yaml.safe_load(text_t)
    config.save_options_file(popt)                 # unchanged: no backup
    assert not (out_t / "options_prev.yaml").exists()
    popt.max_iter = 7
    config.save_options_file(popt)
    assert (out_t / "options_prev.yaml").read_text() == text_t
    assert yaml.safe_load((out_t / "options.yaml").read_text())["max_iter"] == 7
    tty = io.StringIO()
    tty.isatty = lambda: True
    monkeypatch.setattr(sys, "stdin", tty)
    monkeypatch.setattr("builtins.input", lambda prompt: "n")
    popt.max_iter = 8
    with pytest.raises(SystemExit):
        config.save_options_file(popt)
    assert yaml.safe_load((out_t / "options.yaml").read_text())["max_iter"] == 7


# ------------------------------------------------------------------ engine

class FakeWriter:

    def __init__(self, logdir=None, log_dir=None, flush_secs=None):
        self.logdir = logdir or log_dir
        self.scalars, self.images, self.flushed = [], [], 0

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def _get_file_writer(self):
        return self

    def add_summary(self, summary, step):
        for value in summary.value:
            image = value.image
            self.images.append((value.tag, (image.height, image.width, image.colorspace),
                                int(step), image_io.decode_png(image.encoded_image_string)))

    def flush(self):
        self.flushed += 1


def _trainer(tmp_path, flags, steps=2):
    opt = DotDict(_options(["--freq.scalar=1", "--freq.val={}".format(steps),
                            "--freq.ckpt=100", "--freq.vis={}".format(steps),
                            "--tb.num_images=[1,2]"] + flags, tmp_path).to_plain())
    opt.max_iter = steps
    trainer = Trainer(opt, "cpu")
    trainer.build_system(_arrays(N_IMG, 0), _arrays(2, 1))
    return trainer


def test_tensorboard_scalars_and_validation_images(tmp_path, monkeypatch):
    """Through a stand-in tensorboardX (its writer, the real Summary
    message): the JAX engine's tags for the same metrics, and the validation
    rgb and inverse depth with their grids, as PNGs of the encoded pixels."""
    from tensorboardX.proto import summary_pb2
    monkeypatch.setitem(sys.modules, "tensorboardX",
                        types.SimpleNamespace(SummaryWriter=FakeWriter))
    monkeypatch.setitem(sys.modules, "tensorboardX.proto.summary_pb2", summary_pb2)
    trainer = _trainer(tmp_path, [])
    trainer.setup_visualizer()
    assert isinstance(trainer.tb, FakeWriter) and trainer.tb.logdir == str(tmp_path)
    trainer.train()
    tb = trainer.tb
    ref = types.SimpleNamespace(tb=FakeWriter())
    jengine.Trainer.log_scalars(ref, trainer.history[0], 1)
    assert [s for s in tb.scalars if s[2] == 1] == ref.tb.scalars
    assert {t for t, _, s in tb.scalars if s == 2} >= {"train/loss_render", "val/psnr_val"}
    assert [(t, shape) for t, shape, _, _ in tb.images] == [
        ("val/rgb", (H, W, 3)), ("val/invdepth", (H, W, 3)),
        ("val/rgb_grid", (H, 2 * W, 3)), ("val/invdepth_grid", (H, 2 * W, 3))]
    for tag, _, step, pixels in tb.images:
        assert trainer.tb_images[tag][0] == step
        assert np.array_equal(trainer.tb_images[tag][1], pixels), tag
    assert tb.flushed == 1


def test_without_a_writer_the_run_goes_on(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    trainer = _trainer(tmp_path, [])
    trainer.setup_visualizer()
    assert trainer.tb is None


def test_live_pose_view_at_freq_vis(tmp_path):
    """poses.html after every freq.vis steps: the JAX package's viewer of
    the same aligned frames, byte for byte."""
    trainer = _trainer(tmp_path, [], steps=4)
    trainer.opt.freq.vis = 2
    trainer.train()
    frames = trainer.live_pose_frames
    assert [s for s, _ in frames] == [2, 4]
    ref = tmp_path / "ref.html"
    jpose_viewer.export_interactive_poses(
        str(ref), frames, pose_ref=trainer.system.train_data["pose"].numpy(), cam_depth=0.2)
    assert (tmp_path / "poses.html").read_text() == ref.read_text()


def test_nan_check_raises_at_the_step(tmp_path):
    trainer = _trainer(tmp_path, ["--debug.nan_check"])
    trainer.system.train_data["pixels"][0] = float("nan")
    with pytest.raises(FloatingPointError, match="step 0"):
        trainer.train()
    # off, the same run takes its steps
    trainer = _trainer(tmp_path, [])
    trainer.system.train_data["pixels"][0] = float("nan")
    trainer.train()
    assert not np.isfinite(float(trainer.history[0]["loss_render"]))


def test_profile_dir_holds_a_trace(tmp_path):
    trainer = _trainer(tmp_path, ["--tpu.profile_dir={}".format(tmp_path / "prof")])
    trainer.train()
    trace = tmp_path / "prof" / "trace.json"
    assert trace.is_file() and trace.stat().st_size > 0
    assert len(trainer.step_seconds) == 2
