"""The GARF family in the port (``nerf_gaussian``, ``garf``,
``garf_se3_field``) against the JAX package on the CPU, at the JAX tests'
tiny sizes (tests/test_garf.py): the Gaussian field at depth 4, width 32,
skip [2]; the three systems' step 0 at depth 3, width 32, 24 samples, 384
rays over 6 images of 32x32; the pose warmup at depth 2, width 16, 8
samples, 64 rays over 3 images of 16x16.

Both packages run on the port's init, taken to the JAX side over the
weight bridge. Every draw of a step is the JAX side's own, injected into
the port: ray indices, depth jitter and density noise. The field's JAX
references are eager; the systems' steps are jitted (eager JAX spends
~8-20 s per system compiling its primitives one by one, and the Gaussian
chain has none of the PE's sin/cos whose fusion under jit moves gradients,
ROADMAP watch list). Tolerances: field values rtol 1e-5 plus 1e-5 of the
largest entry (the Gaussians of sigma 0.1 magnify the two fp32 orders'
differences past 1e-6 of max on rgb without the sigmoid); losses rtol 1e-5;
gradients rtol 1e-4 plus 1e-5 of the leaf's largest entry; parameters
after Adam steps 1e-6 plus 1e-5 relative, and to 2 lr where the gradient
is noise-level (as tests/test_torch_barf.py); the warmup run's parameters
rtol 1e-5 plus 1e-5 of max, and the pose exactly zero while gated.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from neural_invertible_warp_tpu import config
from neural_invertible_warp_tpu.dotdict import DotDict as JaxDotDict
from neural_invertible_warp_tpu.models import get_system_class as jax_system_class
from neural_invertible_warp_tpu.ops import garf_field as jgarf
from neural_invertible_warp_tpu.ops import sampling as jsampling
from neural_invertible_warp_tpu.utils import ckpt as jckpt
from neural_invertible_warp_tpu.utils.flat_optim import FlatMultiOptimizer
from neural_invertible_warp_tpu_torch.dotdict import DotDict
from neural_invertible_warp_tpu_torch.garf_llff import garf_llff_options
from neural_invertible_warp_tpu_torch.models import get_system_class
from neural_invertible_warp_tpu_torch.ops import garf_field
from neural_invertible_warp_tpu_torch.utils import ckpt, weights

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

ARCH = dict(depth=4, width=32, skip=[2], density_activ="softplus", sigmoid=True,
            gaussian=dict(sigma=0.1))
FIELD_CASES = {
    "softplus": {}, "relu": dict(activ="relu"), "abs": dict(activ="abs"),
    "sigmoid": dict(activ="sigmoid"), "exp": dict(activ="exp"),
    "no_view_dep": dict(view_dep=False), "no_skip": dict(arch=dict(skip=[])),
    "no_sigmoid": dict(arch=dict(sigmoid=False)),
    "uniform_init": dict(init=dict(weight=dict(uniform=True, range=0.1))),
    "noise": dict(noise=0.5),
}


def _close(got, ref, rtol, share, name=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=share * np.abs(ref).max() + 1e-9, err_msg=name)


@pytest.mark.parametrize("case", list(FIELD_CASES))
def test_gaussian_field_over_the_bridge(case):
    """The port's GaussianNerf, its init over the weight bridge:
    rgb, density and every parameter gradient of a weighted sum of both,
    against ``apply_gaussian_nerf``."""
    spec = FIELD_CASES[case]
    arch = dict(ARCH, **spec.get("arch", {}))
    view_dep = spec.get("view_dep", True)
    activ = spec.get("activ", "softplus")
    init_cfg = spec.get("init")
    jarch = JaxDotDict(arch)
    rng = np.random.RandomState(0)
    pts = (rng.randn(2, 5, 7, 3) * 0.5).astype(np.float32)
    ray = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    c_rgb = rng.randn(2, 5, 7, 3).astype(np.float32)
    c_dens = rng.randn(2, 5, 7).astype(np.float32)
    reg = spec.get("noise")
    noise_key = jax.random.PRNGKey(3)

    def loss_fn(p):
        rgb, dens = jgarf.apply_gaussian_nerf(
            p, jarch, jnp.asarray(pts), jnp.asarray(ray) if view_dep else None,
            view_dep=view_dep, density_activ=activ, density_noise_reg=reg,
            noise_key=noise_key if reg else None)
        return jnp.sum(rgb * c_rgb) + jnp.sum(dens * c_dens), (rgb, dens)
    field = garf_field.GaussianNerf(DotDict(arch), view_dep=view_dep,
                                    init_cfg=DotDict(init_cfg) if init_cfg else None,
                                    generator=torch.Generator().manual_seed(0))
    for lin in field.modules():     # weights U(+-range) or U(+-1/sqrt(fan_in)), biases the latter
        if isinstance(lin, torch.nn.Linear):
            w_bound = 0.1 if init_cfg else 1 / math.sqrt(lin.in_features)
            assert 0.5 * w_bound < float(lin.weight.detach().abs().max()) <= w_bound
            assert float(lin.bias.detach().abs().max()) <= 1 / math.sqrt(lin.in_features)
    params = weights.nerf_to_jax(field)
    # the JAX package's init has the same tree, shape for shape
    ref_init = jax.eval_shape(lambda key: jgarf.init_gaussian_nerf_params(
        key, jarch, view_dep=view_dep, init_cfg=JaxDotDict(init_cfg) if init_cfg else None),
        jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(ref_init) == jax.tree_util.tree_structure(params)
    assert [a.shape for a in jax.tree_util.tree_leaves(ref_init)] == \
        [a.shape for a in jax.tree_util.tree_leaves(params)]
    (_, (rgb_j, dens_j)), g_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    noise = None
    if reg:
        draw = np.asarray(jax.random.normal(noise_key, (2, 5, 7, 1)))[..., 0]
        noise = torch.tensor(draw) * reg
    rgb, dens = field(torch.tensor(pts), torch.tensor(ray) if view_dep else None,
                      activ, noise)
    (rgb * torch.tensor(c_rgb)).sum().add((dens * torch.tensor(c_dens)).sum()).backward()
    assert rgb.shape == (2, 5, 7, 3) and dens.shape == (2, 5, 7)
    _close(rgb.detach(), rgb_j, 1e-5, 1e-5, "rgb")
    _close(dens.detach(), dens_j, 1e-5, 1e-5, "density")
    # without view dependence gaussian_linear_c is unused: JAX's gradient is 0
    g_t = weights.nerf_to_jax(field, get=lambda p: torch.zeros_like(p) if p.grad is None
                              else p.grad)
    lj = jax.tree_util.tree_leaves_with_path(g_j)
    lt = jax.tree_util.tree_leaves(g_t)
    assert len(lj) == len(lt) == 2 * (4 + arch["depth"] + (4 if view_dep else 1) - 2)
    for (path, a), b in zip(lj, lt):
        _close(b, a, 1e-4, 1e-5, jax.tree_util.keystr(path))


def test_garf_option_dicts_equal_yaml_resolution():
    for yaml, model in (("nerf_gaussian_llff", "nerf_gaussian"), ("garf_llff", "garf"),
                        ("garf_llff_se3", "garf_se3_field")):
        opt = config.load_options("options/{}.yaml".format(yaml))
        over = config.parse_arguments(["--model={}".format(model), "--yaml={}".format(yaml)])
        opt = config.override_options(opt, over, key_stack=[], safe_check=True)
        assert garf_llff_options(model).to_plain() == opt.to_plain(), model
    assert garf_llff_options() is not garf_llff_options()


# ----------------------------------------------------------------- systems

N_IMG, HW = 6, 32


def _arrays(n, seed, hw=HW):
    """n views of a smooth image near the identity pose."""
    rng = np.random.RandomState(seed)
    f = 0.5 * hw / np.tan(0.4)
    ys, xs = np.meshgrid(np.linspace(0, 1, hw), np.linspace(0, 1, hw), indexing="ij")
    base = np.stack([xs, ys, xs * ys], -1)
    image = np.stack([np.clip(base + 0.1 * rng.rand(hw, hw, 3), 0, 1) for _ in range(n)])
    pose = np.concatenate([np.tile(np.eye(3), (n, 1, 1)), rng.randn(n, 3, 1) * 0.05], -1)
    return dict(image=image.astype(np.float32),
                intr=np.tile(np.array([[f, 0, hw / 2], [0, f, hw / 2], [0, 0, 1]],
                                      np.float32), (n, 1, 1)),
                pose=pose.astype(np.float32), idx=np.arange(n, dtype=np.int32))


def _options(model, tmp_path, extra=(), hw=HW):
    """tests/test_garf.py's ``_garf_opt`` on in-memory arrays."""
    yaml = {"nerf_gaussian": "nerf_gaussian_llff", "garf": "garf_llff",
            "garf_se3_field": "garf_llff_se3"}[model]
    opt = config.load_options("options/{}.yaml".format(yaml))
    flags = dict(a.split("=", 1) if "=" in a else (a, None) for a in [
        "--model={}".format(model), "--yaml={}".format(yaml),
        "--data.image_size=[{0},{0}]".format(hw), "--arch.depth=3", "--arch.width=32", "--arch.skip=[]",
        "--nerf.sample_intvs=24", "--nerf.rand_rays=384", "--max_iter=60",
    ] + (["--arch.layers_warp=[null,32,32,6]", "--arch.skip_warp=[]",
          "--arch.embedding_dim=16"] if model == "garf_se3_field" else []) + list(extra))
    over = config.parse_arguments([k if v is None else k + "=" + v for k, v in flags.items()])
    opt = config.override_options(opt, over, key_stack=[], safe_check=True)
    opt.H, opt.W = opt.data.image_size
    opt.output_path = str(tmp_path)
    return opt


def _draws(key, n_img, n_rays, K):
    """The JAX step's own draws: (ray_u, depth_rand) from its key chain."""
    k_perm, k_render = jax.random.split(key)
    k_depth, _ = jax.random.split(k_render)
    return (np.asarray(jax.random.uniform(k_perm, (n_rays,))),
            np.asarray(jax.random.uniform(k_depth, (n_img, n_rays, K, 1))))


def _pair(model, tmp_path, extra=(), n_img=N_IMG, hw=HW):
    """(JAX system, its state, port system) on the same arrays and weights:
    the port's init, taken into the JAX state over the weight bridge (the
    JAX package's own init costs seconds of eager compiles of its draws)."""
    train, test = _arrays(n_img, 0, hw), _arrays(1, 1, hw)
    psys = get_system_class(model)(DotDict(_options(model, tmp_path / "port", extra, hw)
                                           .to_plain()), "cpu")
    psys.attach_data(train, test)
    psys.init_state(0)
    with torch.no_grad():
        if model == "garf":     # away from the identity, where every pose is alike
            psys.graph.se3_refine.weight.normal_(
                std=0.02, generator=torch.Generator().manual_seed(0))
        if model == "garf_se3_field":
            # warps of that size too: at the default init's (se(3) entries to
            # ~0.5) the pose leaves' fp32 sums over rays and images cancel,
            # and the port and the JAX package, each about as far from a
            # float64 evaluation as the other at d loss / d se(3), differ by
            # more than 1e-5 of some warp leaves' max
            psys.graph.warp_mlp[-1].weight.mul_(0.05)
            psys.graph.warp_mlp[-1].bias.mul_(0.05)
    params = weights.to_jax_params(psys.graph)
    jsys = jax_system_class(model)(_options(model, tmp_path / "jax", extra, hw))
    assert type(psys).__name__ == type(jsys).__name__
    jsys.attach_data(train, test)
    assert sorted(jsys.param_labels(params)) == sorted(params)
    jsys.tx = FlatMultiOptimizer(jsys.make_optimizers(), jsys.param_labels(params))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = dict(params=params, opt_state=jsys.tx.init(params),
                 step=jnp.zeros((), jnp.int32), aux=jsys.init_aux(jax.random.PRNGKey(0)))
    return jsys, state, psys


@pytest.fixture(scope="module", params=["nerf_gaussian", "garf", "garf_se3_field"])
def pair(request, tmp_path_factory):
    return _pair(request.param, tmp_path_factory.mktemp(request.param))


def _leaves_close(tree_j, tree_t, rtol, share, nonzero=True):
    lj = jax.tree_util.tree_leaves_with_path(tree_j)
    lt = jax.tree_util.tree_leaves(tree_t)
    assert len(lj) == len(lt)
    for (path, a), b in zip(lj, lt):
        a = np.asarray(a)
        assert not nonzero or np.abs(a).max() > 0, jax.tree_util.keystr(path)
        _close(b, a, rtol, share, jax.tree_util.keystr(path))


def test_step0_loss_gradients_and_adam_step(pair):
    """Step 0 of each system: the loss, every gradient leaf, then the
    parameters after one Adam step (optax's update of the JAX gradients
    against the port's train_step)."""
    jsys, state, psys = pair
    opt = jsys.opt
    n_rays, K = opt.nerf.rand_rays // N_IMG, opt.nerf.sample_intvs
    key = jax.random.PRNGKey(42)
    ray_u, depth_rand = _draws(key, N_IMG, n_rays, K)
    k_perm, k_render = jax.random.split(key)
    ray_idx = jsampling.sample_ray_subset(k_perm, HW * HW, n_rays, mode="stratified")

    def step_fn(params, opt_state):
        def loss_fn(params):
            out, target, extras = jsys._forward_train(params, state["aux"], jsys.train_data,
                                                      ray_idx, k_render, state["step"])
            losses = jsys.compute_loss(params, state["aux"], jsys.train_data, out, target,
                                       state["step"], extras)
            return jsys.summarize_loss(losses), losses
        (total, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = jsys.tx.update(grads, opt_state, params)
        return total, losses, grads, optax.apply_updates(params, updates)
    total_j, losses_j, g_j, params_j = jax.jit(step_fn)(state["params"], state["opt_state"])

    psys.optim.zero_grad()
    out, target, extras = psys._forward_train(torch.from_numpy(np.array(ray_idx)).long(),
                                              psys.step, torch.tensor(depth_rand))
    losses_t = psys.compute_loss(out, target, extras)
    total_t = psys.summarize_loss(losses_t)
    total_t.backward()
    assert list(losses_t) == list(losses_j) == ["render"]
    np.testing.assert_allclose(float(total_t.detach()), float(total_j), rtol=1e-5)
    _leaves_close(g_j, weights.to_jax_params(psys.graph, get=lambda p: p.grad), 1e-4, 1e-5)

    metrics = psys.train_step(torch.tensor(ray_u), torch.tensor(depth_rand))
    np.testing.assert_allclose(float(metrics["loss_all"]), float(total_j), rtol=1e-5)
    lrs = dict(main=opt.optim.lr, pose=opt.optim.get("lr_pose"))
    labels = jsys.param_labels(state["params"])
    p_t = weights.to_jax_params(psys.graph)
    for (path, a), b, g in zip(jax.tree_util.tree_leaves_with_path(params_j),
                               jax.tree_util.tree_leaves(p_t),
                               jax.tree_util.tree_leaves(g_j)):
        a, g = np.asarray(a), np.abs(np.asarray(g))
        noisy = g < 1e-4 * g.max()
        err = np.abs(b - a)
        name = jax.tree_util.keystr(path)
        assert np.all(err[~noisy] <= 1e-6 + 1e-5 * np.abs(a[~noisy])), name
        assert np.all(err[noisy] <= 2 * lrs[labels[path[0].key]] + 1e-6), name
    if psys.model_name != "nerf_gaussian":
        pred_j, _ = jsys.get_all_training_poses(dict(state, params=params_j))
        np.testing.assert_allclose(psys.get_all_training_poses()[0].numpy(), pred_j,
                                   rtol=1e-5, atol=1e-5)


def test_the_field_takes_the_plain_chain(pair):
    """No kernel covers the Gaussian field: the render core's dispatch is
    "off" for it, whatever ``tpu.*`` says, and the NeRF MLP's kernels raise
    for the density activations they do not implement."""
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe
    _, _, psys = pair
    assert psys.opt.tpu.fused_pe and psys.opt.tpu.fused_raymarch
    assert psys._field_mode() == "off"
    assert isinstance(psys.graph.nerf, garf_field.GaussianNerf)
    with pytest.raises(NotImplementedError, match="tpu.fused_pe"):
        fused_pe._activ("abs")
    assert fused_pe._activ("relu") == 1


def test_se3_field_last_layer_keeps_the_default_init(tmp_path):
    """The reference's near-zero init of the warp MLP's last layer is dead
    code (the JAX package keeps it dead): the port's last layer keeps
    torch's default bound 1/sqrt(fan_in) for weight and bias."""
    opt = DotDict(_options("garf_se3_field", tmp_path).to_plain())
    psys = get_system_class("garf_se3_field")(opt, "cpu")
    psys.attach_data(_arrays(N_IMG, 0), _arrays(1, 1))
    psys.init_state(0)
    last = psys.graph.warp_mlp[-1]
    bound = 1 / math.sqrt(last.in_features)
    for w in (last.weight, last.bias):
        assert 0.5 * bound < float(w.detach().abs().max()) <= bound
    assert psys.graph.warp_embedding.weight.shape == (N_IMG, 16)
    assert abs(float(psys.graph.warp_embedding.weight.detach().std()) - 1) < 0.3
    assert psys.label_keys() == {"main": ["nerf"], "pose": ["warp_embedding", "warp_mlp"]}
    assert not hasattr(psys.graph, "se3_refine")


def test_checkpoints_both_ways(pair, tmp_path):
    """The port's checkpoint restores into the JAX state and the JAX one into
    a fresh port system: the GARF field's tree, and garf_se3_field's
    ``warp_embedding`` and list-of-layers ``warp_mlp``."""
    jsys, state, psys = pair
    tree = weights.to_jax_params(psys.graph)
    if psys.model_name == "garf_se3_field":
        assert isinstance(tree["warp_mlp"], list) and len(tree["warp_mlp"]) == 3
        assert tree["warp_embedding"].shape == (N_IMG, 16)
    ckpt.save(str(tmp_path / "p"), psys, 3)
    restored, it = jckpt.restore_checkpoint(str(tmp_path / "p"), state)
    assert it == 3
    for a, b in zip(jax.tree_util.tree_leaves(restored["params"]),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    jckpt.save_checkpoint(str(tmp_path / "j"), state, 2)
    other = get_system_class(psys.opt.model)(psys.opt, "cpu")
    other.attach_data({k: v.numpy() for k, v in psys.train_data.items()},
                      {k: v.numpy() for k, v in psys.test_data.items()})
    other.init_state(7)
    assert ckpt.restore(str(tmp_path / "j"), other) == 2
    assert other.step == int(state["step"])
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(state["params"]),
                            jax.tree_util.tree_leaves(weights.to_jax_params(other.graph))):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=jax.tree_util.keystr(path))


WARMUP = 5


def test_pose_warmup_gate_against_jax(tmp_path):
    """``init.pose`` with ``init.pose_warmup`` 5 (tests/test_garf.py's
    configuration), WARMUP + 2 of the port's train steps, each step's
    gradients also fed to the JAX system's own optimizer (the gate chained
    in front of Adam and its schedules): the pose parameters stay exactly
    zero through the gated steps on both sides and then match after the
    first and second open steps (a skipped Adam count would double the
    first open step), the field's parameters at every step; the checkpoint
    carries the gate's count in the JAX layout, both ways."""
    extra = ["--arch.depth=2", "--arch.width=16", "--nerf.sample_intvs=8",
             "--nerf.rand_rays=64", "--init.pose", "--init.pose_warmup={}".format(WARMUP),
             "--max_iter=100"]
    jsys, state, psys = _pair("garf", tmp_path, extra, n_img=3, hw=16)
    with torch.no_grad():
        psys.graph.se3_refine.weight.zero_()
    params = jax.tree_util.tree_map(jnp.asarray, weights.to_jax_params(psys.graph))
    opt_state = jsys.tx.init(params)
    assert psys.optim.gates == {"pose": WARMUP}
    grads = []
    step = psys.optim.step

    def step_and_record():      # the gradients the optimizer is handed
        grads.append(weights.to_jax_params(psys.graph, get=lambda p: p.grad))
        step()
    psys.optim.step = step_and_record
    update = jax.jit(jsys.tx.update)
    gen = torch.Generator().manual_seed(0)
    for it in range(WARMUP + 2):
        psys.train_step(torch.rand(64 // 3, generator=gen),
                        torch.rand(3, 64 // 3, 8, 1, generator=gen))
        assert np.abs(grads[-1]["se3_refine"]).max() > 0
        updates, opt_state = update(grads[-1], opt_state, params)
        params = optax.apply_updates(params, updates)
        se3_j = np.asarray(params["se3_refine"])
        se3_t = psys.graph.se3_refine.weight.detach().numpy()
        if it < WARMUP:
            assert not se3_j.any() and not se3_t.any()
        else:
            # Adam's count is WARMUP + 1 at the first open step: a step of
            # lr * 0.52 (a count restarted at 1 would step the whole lr)
            assert np.abs(se3_j).max() > 0.25 * jsys.opt.optim.lr_pose
            _close(se3_t, se3_j, 1e-5, 1e-5, "se3_refine after step {}".format(it))
        _leaves_close(params["nerf"], weights.to_jax_params(psys.graph)["nerf"], 1e-5, 1e-5,
                      nonzero=False)
    state = dict(state, params=params, opt_state=opt_state)
    ckpt.save(str(tmp_path / "p"), psys, psys.step)
    restored, _ = jckpt.restore_checkpoint(str(tmp_path / "p"), state)
    (gate_count,), ((count, mu, nu), _) = restored["opt_state"]["pose"]
    (gate_j,), ((count_j, mu_j, _), _) = opt_state["pose"]
    assert int(gate_count) == int(count) == int(gate_j) == int(count_j) == WARMUP + 2
    _close(mu, mu_j, 1e-5, 1e-5, "pose moments")
    jckpt.save_checkpoint(str(tmp_path / "j"), dict(state, step=jnp.int32(WARMUP + 2)), 7)
    other = get_system_class("garf")(psys.opt, "cpu")
    other.attach_data({k: v.numpy() for k, v in psys.train_data.items()},
                      {k: v.numpy() for k, v in psys.test_data.items()})
    other.init_state(3)
    assert ckpt.restore(str(tmp_path / "j"), other) == WARMUP + 2
    assert other.optim.count == other.step == WARMUP + 2
    np.testing.assert_array_equal(other.graph.se3_refine.weight.detach().numpy(),
                                  np.asarray(params["se3_refine"]))


def test_warmup_needs_known_poses(tmp_path):
    opt = DotDict(_options("garf", tmp_path, ["--init.pose_warmup=5"]).to_plain())
    with pytest.raises(ValueError, match="pose_warmup"):
        get_system_class("garf")(opt, "cpu")


@pytest.mark.parametrize("model,yaml", [("nerf_gaussian", "nerf_gaussian_llff"),
                                        ("garf_se3_field", "garf_llff_se3")])
def test_train_and_evaluate_entry_points_on_cpu(tmp_path, model, yaml):
    """``train`` then ``evaluate`` in-process with ``--device=cpu`` on the
    synthetic LLFF fixture: checkpoints, quant.txt and the novel views (for
    nerf_gaussian, which optimizes no pose, around the GT poses)."""
    import os
    import synth_data
    from neural_invertible_warp_tpu_torch import evaluate, train
    root = str(tmp_path / "data")
    synth_data.make_llff_scene(root, n_images=6, img_size=(12, 16))
    flags = ["--model={}".format(model), "--yaml={}".format(yaml), "--device=cpu",
             "--data.root={}".format(root), "--data.scene=toyfern",
             "--data.image_size=[12,16]", "--data.num_workers=1", "--data.val_ratio=0.2",
             "--arch.depth=2", "--arch.width=16", "--nerf.sample_intvs=8",
             "--nerf.rand_rays=50", "--max_iter=2", "--freq.scalar=1", "--freq.val=100",
             "--freq.ckpt=100", "--output_root={}".format(tmp_path / "out")]
    if model == "garf_se3_field":
        flags += ["--arch.layers_warp=[null,16,6]", "--arch.skip_warp=[]",
                  "--arch.embedding_dim=8", "--optim.test_iter=2"]
    trainer = train.main(flags)
    assert type(trainer.system).__name__ == jax_system_class(model).__name__
    assert trainer.system.step == 2
    results = evaluate.main(flags)
    out = trainer.opt.output_path
    assert np.isfinite(results["PSNR"]) and ("rot_error_deg" in results) == (model != "nerf_gaussian")
    assert len(open(os.path.join(out, "quant.txt")).read().split("\n")) == 1 + 1
    assert len(os.listdir(os.path.join(out, "novel_view"))) == 60
