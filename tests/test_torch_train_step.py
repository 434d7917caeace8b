"""The whole flagship slice on the CPU: the port's InnWarpSystem train step
against the JAX package's, at a tiny size (4 images of 16x16, 64 rays,
16 samples, a 4x32 trunk, a 16-wide INN, an 8-wide latent), with the
flagship's c2f (0.1, 0.5) and global alignment at 10^4.

Both systems start from the same weights (JAX init over the weight
bridge; the INN's zero output layers are filled with small random values
so that the warp is not the identity) at step 2, so that the c2f band
weights are open. The step's random draws are taken from the JAX step's
own keys and injected into the port.

Tolerances: the forward is fp32 on both sides with different summation
orders (losses rtol 1e-5). Gradients: rtol 1e-4 plus atol 1e-5 of the
leaf's largest entry. Adam's first update is lr * g / (|g| + eps), about
lr * sign(g), so an entry whose gradient is noise-level (below 1e-4 of the
leaf's largest) can move the other way; parameters after the step are held
to 1e-6 elsewhere, and to 2 lr on those entries.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neural_invertible_warp_tpu import config
from neural_invertible_warp_tpu.models import get_system_class as jax_system_class
from neural_invertible_warp_tpu.ops import sampling as jsampling
from neural_invertible_warp_tpu.utils import ckpt as jckpt
from neural_invertible_warp_tpu_torch.models import get_system_class
from neural_invertible_warp_tpu_torch.utils import ckpt, weights

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

H = W = 16
N_IMG = 4
OVERRIDES = [
    "--model=barf_inn_llff", "--yaml=barf_inn_llff", "--barf_c2f=[0.1,0.5]",
    "--loss_weight.global_alignment=4", "--data.image_size=[16,16]",
    "--arch.layers_feat=[null,32,32,32,32]", "--arch.layers_rgb=[null,16,3]",
    "--arch.skip=[2]", "--nerf.sample_intvs=16", "--nerf.rand_rays=64",
    "--inn.real_nvp.d_hidden=16", "--warp_latent.embed_dim=8", "--max_iter=8",
]


def _options(tmp_path):
    opt = config.load_options("options/barf_inn_llff.yaml")
    opt = config.override_options(opt, config.parse_arguments(OVERRIDES),
                                  key_stack=[], safe_check=True)
    opt.H, opt.W = H, W
    opt.output_path = str(tmp_path)
    return opt


def _arrays(n, seed):
    rng = np.random.RandomState(seed)
    f = 0.5 * W / np.tan(0.4)
    ys, xs = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    base = np.stack([xs, ys, xs * ys], -1)
    image = np.stack([np.clip(base + 0.1 * rng.rand(H, W, 3), 0, 1) for _ in range(n)])
    w = rng.randn(n, 3) * 0.02
    from neural_invertible_warp_tpu.ops import lie
    R = np.asarray(lie.so3_to_SO3(jnp.asarray(w, jnp.float32)))
    pose = np.concatenate([R, rng.randn(n, 3, 1) * 0.05], -1)
    return dict(image=image.astype(np.float32),
                intr=np.tile(np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
                                      np.float32), (n, 1, 1)),
                pose=pose.astype(np.float32), idx=np.arange(n, dtype=np.int32))


def _draws(key, n_rays, K):
    """The JAX step's own draws: (ray_u, depth_rand) from its key chain."""
    k_perm, k_render = jax.random.split(key)
    k_depth, _ = jax.random.split(k_render)
    return (np.asarray(jax.random.uniform(k_perm, (n_rays,))),
            np.asarray(jax.random.uniform(k_depth, (N_IMG, n_rays, K, 1))))


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    opt = _options(tmp_path_factory.mktemp("jax"))
    jsys = jax_system_class("barf_inn_llff")(opt)
    train, test = _arrays(N_IMG, 0), _arrays(1, 1)
    jsys.attach_data(train, test)
    state = jsys.init_state(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def fill(x):
        x = np.asarray(x)
        return (rng.randn(*x.shape) * 0.02).astype(np.float32) if not np.any(x) else x
    params = jax.tree_util.tree_map(np.asarray, state["params"])
    params["warp_mlp"] = jax.tree_util.tree_map(fill, params["warp_mlp"])
    state = dict(state, params=jax.tree_util.tree_map(jnp.asarray, params),
                 step=jnp.int32(2))

    popt = _options(tmp_path_factory.mktemp("port"))
    psys = get_system_class("barf_inn_llff")(popt, "cpu")
    psys.attach_data(train, test)
    psys.init_state(0)
    psys.graph.load_state_dict(weights.from_jax_params(params))
    psys.step = 2
    psys.aux["global_rigid"] = torch.tensor(np.asarray(state["aux"]["global_rigid"]))
    return jsys, state, psys


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_step0_loss_and_every_gradient(systems):
    jsys, state, psys = systems
    opt = jsys.opt
    n_rays, K = opt.nerf.rand_rays // N_IMG, opt.nerf.sample_intvs
    key = jax.random.PRNGKey(42)
    ray_u, depth_rand = _draws(key, n_rays, K)
    k_perm, k_render = jax.random.split(key)
    ray_idx = jsampling.sample_ray_subset(k_perm, H * W, n_rays, mode="stratified")

    def loss_fn(params):
        out, target, extras = jsys._forward_train(params, state["aux"], jsys.train_data,
                                                  ray_idx, k_render, state["step"])
        losses = jsys.compute_loss(params, state["aux"], jsys.train_data, out, target,
                                   state["step"], extras)
        return jsys.summarize_loss(losses), losses
    (total_j, losses_j), g_j = jax.value_and_grad(loss_fn, has_aux=True)(state["params"])

    idx_t = torch.from_numpy(np.array(ray_idx)).long()
    from neural_invertible_warp_tpu_torch.ops import sampling
    assert torch.equal(sampling.sample_ray_subset(H * W, n_rays, u=torch.tensor(ray_u)),
                       idx_t)
    psys.optim.zero_grad()
    out, target, extras = psys._forward_train(idx_t, psys.step, torch.tensor(depth_rand))
    losses_t = psys.compute_loss(out, target, extras)
    total_t = psys.summarize_loss(losses_t)
    total_t.backward()
    for k in ("render", "global_alignment"):
        np.testing.assert_allclose(float(losses_t[k].detach()), float(losses_j[k]), rtol=1e-5,
                                   atol=1e-12, err_msg=k)
    np.testing.assert_allclose(float(total_t.detach()), float(total_j), rtol=1e-5)
    g_t = weights.to_jax_params(psys.graph, get=lambda p: p.grad)
    lj, lt = _leaves(g_j), jax.tree_util.tree_leaves(g_t)
    assert len(lj) == len(lt) > 30
    for (path, a), b in zip(lj, lt):
        a = np.asarray(a)
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5 * np.abs(a).max() + 1e-9,
                                   err_msg=jax.tree_util.keystr(path))


def test_step0_without_the_one_call_train_kernel(systems, monkeypatch):
    """``tpu.fused_train: false`` sends training through the forward render
    and its backward (K3 + K4 on the card) instead of the one-call train
    kernel (K2). On the CPU both routes are the plain chain: the loss and
    every gradient leaf must agree between the two routes (1e-6 of the
    leaf's largest entry: the squared error is summed in another order) and
    with the JAX system (the tolerances of the test above)."""
    jsys, state, psys = systems
    opt = jsys.opt
    n_rays, K = opt.nerf.rand_rays // N_IMG, opt.nerf.sample_intvs
    key = jax.random.PRNGKey(42)
    ray_u, depth_rand = _draws(key, n_rays, K)
    k_perm, k_render = jax.random.split(key)
    ray_idx = jsampling.sample_ray_subset(k_perm, H * W, n_rays, mode="stratified")
    idx_t = torch.from_numpy(np.array(ray_idx)).long()

    def port_step0(fused_train):
        monkeypatch.setitem(psys.opt.tpu, "fused_train", fused_train)
        psys.optim.zero_grad()
        out, target, extras = psys._forward_train(idx_t, psys.step, torch.tensor(depth_rand))
        assert ("render_sq_sum" in out) == fused_train
        losses = psys.compute_loss(out, target, extras)
        total = psys.summarize_loss(losses)
        total.backward()
        return (float(total.detach()), {k: float(v.detach()) for k, v in losses.items()},
                weights.to_jax_params(psys.graph, get=lambda p: p.grad.clone()))
    total_k2, losses_k2, g_k2 = port_step0(True)
    total_k34, losses_k34, g_k34 = port_step0(False)
    np.testing.assert_allclose(total_k34, total_k2, rtol=1e-6)
    for k in losses_k2:
        np.testing.assert_allclose(losses_k34[k], losses_k2[k], rtol=1e-6, err_msg=k)

    def loss_fn(params):
        out, target, extras = jsys._forward_train(params, state["aux"], jsys.train_data,
                                                  ray_idx, k_render, state["step"])
        return jsys.summarize_loss(jsys.compute_loss(
            params, state["aux"], jsys.train_data, out, target, state["step"], extras))
    total_j, g_j = jax.value_and_grad(loss_fn)(state["params"])
    np.testing.assert_allclose(total_k34, float(total_j), rtol=1e-5)
    for (path, a), b, c in zip(_leaves(g_j), jax.tree_util.tree_leaves(g_k34),
                               jax.tree_util.tree_leaves(g_k2)):
        a, name = np.asarray(a), jax.tree_util.keystr(path)
        np.testing.assert_allclose(b, c, rtol=1e-5, atol=1e-6 * np.abs(c).max() + 1e-12,
                                   err_msg=name)
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5 * np.abs(a).max() + 1e-9,
                                   err_msg=name)


def test_adam_step_then_step1_loss_and_checkpoint(systems, tmp_path):
    jsys, state, psys = systems
    opt = jsys.opt
    n_rays, K = opt.nerf.rand_rays // N_IMG, opt.nerf.sample_intvs
    step_fn = jax.jit(jsys.make_train_step())
    psys.graph.load_state_dict(weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, state["params"])))
    keys = [jax.random.PRNGKey(42), jax.random.PRNGKey(43)]

    # gradients of the first step, for locating noise-level entries
    def grads_of(params):
        k_perm, k_render = jax.random.split(keys[0])
        ray_idx = jsampling.sample_ray_subset(k_perm, H * W, n_rays, mode="stratified")
        out, target, extras = jsys._forward_train(params, state["aux"], jsys.train_data,
                                                  ray_idx, k_render, state["step"])
        return jsys.summarize_loss(jsys.compute_loss(
            params, state["aux"], jsys.train_data, out, target, state["step"], extras))
    g_j = jax.grad(grads_of)(state["params"])

    js, metrics_j = step_fn(state, jsys.train_data, keys[0])
    ray_u, depth_rand = _draws(keys[0], n_rays, K)
    metrics_t = psys.train_step(torch.tensor(ray_u), torch.tensor(depth_rand))
    np.testing.assert_allclose(float(metrics_t["loss_all"]), float(metrics_j["loss_all"]),
                               rtol=1e-5)
    p_t = weights.to_jax_params(psys.graph)
    lrs = dict(nerf=opt.optim.lr, warp_mlp=opt.optim.lr_pose, warp_latent=opt.optim.lr_pose)
    for (path, a), b, g in zip(_leaves(js["params"]), jax.tree_util.tree_leaves(p_t),
                               jax.tree_util.tree_leaves(g_j)):
        a, g = np.asarray(a), np.abs(np.asarray(g))
        noisy = g < 1e-4 * g.max()
        lr = lrs[path[0].key]
        err = np.abs(b - a)
        name = jax.tree_util.keystr(path)
        assert np.all(err[~noisy] <= 1e-6 + 1e-5 * np.abs(a[~noisy])), name
        assert np.all(err[noisy] <= 2 * lr + 1e-6), name
    np.testing.assert_allclose(psys.aux["global_rigid"].numpy(),
                               np.asarray(js["aux"]["global_rigid"]), atol=1e-5)

    # the port's checkpoint loads into the JAX state through the JAX restore
    ckpt.save(str(tmp_path), psys, psys.step)
    restored, it = jckpt.restore_checkpoint(str(tmp_path), js)
    assert it == 3 and int(restored["step"]) == 3
    for a, b in zip(jax.tree_util.tree_leaves(restored["params"]),
                    jax.tree_util.tree_leaves(p_t)):
        np.testing.assert_array_equal(np.asarray(a), b)
    for label in ("main", "pose", "latent"):
        (cnt_r, mu_r, nu_r), _ = restored["opt_state"][label]
        (cnt_j, mu_j, nu_j), _ = js["opt_state"][label]
        assert int(cnt_r) == int(cnt_j) == 1
        assert np.asarray(mu_r).shape == np.asarray(mu_j).shape
        np.testing.assert_allclose(np.asarray(mu_r), np.asarray(mu_j), rtol=1e-3,
                                   atol=1e-5 * np.abs(np.asarray(mu_j)).max())

    # the next step from the updated states
    js2, metrics_j2 = step_fn(js, jsys.train_data, keys[1])
    ray_u, depth_rand = _draws(keys[1], n_rays, K)
    metrics_t2 = psys.train_step(torch.tensor(ray_u), torch.tensor(depth_rand))
    for k in ("loss_render", "loss_global_alignment", "loss_all"):
        np.testing.assert_allclose(float(metrics_t2[k]), float(metrics_j2[k]),
                                   rtol=1e-4, err_msg=k)
