"""SE(3) BARF on LLFF (``--model=barf --yaml=barf_llff``): the port's
BarfSystem train step against the JAX package's on the CPU, at a tiny size
(4 images of 16x16, 64 rays, 16 samples, a 4x32 trunk) with c2f (0.1, 0.5).

Both systems start from the same weights (JAX init over the weight bridge)
and a small random ``se3_refine`` (at its zero init every image has the
identity pose), at step 2 so that c2f bands are open. The step's draws come
from the JAX step's own keys and are injected into the port.

Tolerances as tests/test_torch_train_step.py: losses rtol 1e-5; gradients
rtol 1e-4 plus 1e-5 of the leaf's largest entry; parameters after one Adam
step to 1e-6, and to 2 lr where the gradient is noise-level.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neural_invertible_warp_tpu import config
from neural_invertible_warp_tpu.models import get_system_class as jax_system_class
from neural_invertible_warp_tpu.ops import sampling as jsampling
from neural_invertible_warp_tpu_torch.models import get_system_class
from neural_invertible_warp_tpu_torch.models.barf import BarfSystem
from neural_invertible_warp_tpu_torch.utils import ckpt, weights

from test_torch_train_step import H, W, N_IMG, _arrays, _draws, _leaves

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

OVERRIDES = [
    "--model=barf", "--yaml=barf_llff", "--barf_c2f=[0.1,0.5]",
    "--data.image_size=[16,16]", "--arch.layers_feat=[null,32,32,32,32]",
    "--arch.layers_rgb=[null,16,3]", "--arch.skip=[2]", "--nerf.sample_intvs=16",
    "--nerf.rand_rays=64", "--max_iter=8",
]


def _options(tmp_path):
    opt = config.load_options("options/barf_llff.yaml")
    opt = config.override_options(opt, config.parse_arguments(OVERRIDES),
                                  key_stack=[], safe_check=True)
    opt.H, opt.W = H, W
    opt.output_path = str(tmp_path)
    return opt


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    jsys = jax_system_class("barf")(_options(tmp_path_factory.mktemp("jax")))
    train, test = _arrays(N_IMG, 0), _arrays(1, 1)
    jsys.attach_data(train, test)
    state = jsys.init_state(jax.random.PRNGKey(0))
    se3 = (np.random.RandomState(0).randn(N_IMG, 6) * 0.02).astype(np.float32)
    state = dict(state, params=dict(state["params"], se3_refine=jnp.asarray(se3)),
                 step=jnp.int32(2))
    assert get_system_class("barf") is BarfSystem
    psys = BarfSystem(_options(tmp_path_factory.mktemp("port")), "cpu")
    psys.attach_data(train, test)
    psys.init_state(0)
    assert not psys.graph.se3_refine.weight.any()      # identity poses at init
    psys.graph.load_state_dict(weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, state["params"])))
    psys.step = 2
    return jsys, state, psys


def test_barf_poses_and_labels(systems):
    jsys, state, psys = systems
    pred_j, gt_j = jsys.get_all_training_poses(state)
    pred_t, gt_t = psys.get_all_training_poses()
    np.testing.assert_allclose(pred_t.numpy(), pred_j, atol=1e-6)
    np.testing.assert_array_equal(gt_t.numpy(), gt_j)
    assert not pred_t.requires_grad
    assert psys.label_keys() == {"main": ["nerf"], "pose": ["se3_refine"]}
    assert sorted(weights.to_jax_params(psys.graph)) == sorted(state["params"])
    R_j, t_j = jsys.evaluate_camera_alignment(state)
    R_t, t_t = psys.evaluate_camera_alignment()
    np.testing.assert_allclose(R_t, R_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t_t, t_j, rtol=1e-4, atol=1e-6)


def test_barf_step0_loss_and_every_gradient(systems):
    jsys, state, psys = systems
    opt = jsys.opt
    n_rays, K = opt.nerf.rand_rays // N_IMG, opt.nerf.sample_intvs
    key = jax.random.PRNGKey(42)
    _, depth_rand = _draws(key, n_rays, K)
    k_perm, k_render = jax.random.split(key)
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
    assert list(losses_t) == list(losses_j) == ["render"]
    np.testing.assert_allclose(float(total_t.detach()), float(total_j), rtol=1e-5)
    g_t = weights.to_jax_params(psys.graph, get=lambda p: p.grad)
    lj, lt = _leaves(g_j), jax.tree_util.tree_leaves(g_t)
    assert len(lj) == len(lt) == 2 * (4 + 2) + 1
    for (path, a), b in zip(lj, lt):
        a = np.asarray(a)
        assert np.abs(a).max() > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5 * np.abs(a).max() + 1e-9,
                                   err_msg=jax.tree_util.keystr(path))


def test_barf_adam_step_and_checkpoint(systems, tmp_path):
    jsys, state, psys = systems
    opt = jsys.opt
    n_rays, K = opt.nerf.rand_rays // N_IMG, opt.nerf.sample_intvs
    psys.graph.load_state_dict(weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, state["params"])))
    key = jax.random.PRNGKey(42)

    def total_of(params):
        k_perm, k_render = jax.random.split(key)
        ray_idx = jsampling.sample_ray_subset(k_perm, H * W, n_rays, mode="stratified")
        out, target, extras = jsys._forward_train(params, state["aux"], jsys.train_data,
                                                  ray_idx, k_render, state["step"])
        return jsys.summarize_loss(jsys.compute_loss(
            params, state["aux"], jsys.train_data, out, target, state["step"], extras))
    g_j = jax.grad(total_of)(state["params"])
    js, metrics_j = jax.jit(jsys.make_train_step())(state, jsys.train_data, key)
    ray_u, depth_rand = _draws(key, n_rays, K)
    metrics_t = psys.train_step(torch.tensor(ray_u), torch.tensor(depth_rand))
    np.testing.assert_allclose(float(metrics_t["loss_all"]), float(metrics_j["loss_all"]),
                               rtol=1e-5)
    p_t = weights.to_jax_params(psys.graph)
    lrs = dict(nerf=opt.optim.lr, se3_refine=opt.optim.lr_pose)
    for (path, a), b, g in zip(_leaves(js["params"]), jax.tree_util.tree_leaves(p_t),
                               jax.tree_util.tree_leaves(g_j)):
        a, g = np.asarray(a), np.abs(np.asarray(g))
        noisy = g < 1e-4 * g.max()
        err = np.abs(b - a)
        name = jax.tree_util.keystr(path)
        assert np.all(err[~noisy] <= 1e-6 + 1e-5 * np.abs(a[~noisy])), name
        assert np.all(err[noisy] <= 2 * lrs[path[0].key] + 1e-6), name

    # a checkpoint of the stepped port system restores into a fresh one
    ckpt.save(str(tmp_path), psys, psys.step)
    fresh = BarfSystem(psys.opt, "cpu")
    fresh.attach_data(_arrays(N_IMG, 0), _arrays(1, 1))
    fresh.init_state(1)
    assert ckpt.restore(str(tmp_path), fresh) == 3 and fresh.step == 3
    for (name, a), b in zip(psys.graph.named_parameters(), fresh.graph.parameters()):
        assert torch.equal(a, b), name
        assert torch.equal(psys.optim.moments(a)[0], fresh.optim.moments(b)[0]), name


@pytest.mark.parametrize("dataset,item", [("iphone", "M14"), ("dtu", "M10")])
def test_barf_on_other_data_names_the_roadmap_item(tmp_path, dataset, item):
    opt = _options(tmp_path)
    opt.data.dataset = dataset
    with pytest.raises(NotImplementedError, match=item):
        BarfSystem(opt, "cpu")
