"""Test-time pose refinement and the full evaluation on the CPU: the port's
BarfSystem.test_time_optimized_pose / NerfSystem.evaluate_full against the
JAX package's, on the tiny LLFF INN system of tests/test_torch_train_step.py
(4 train + 2 test images of 16x16, 64 rays, 16 samples, a 4x32 trunk), with
the weights over the bridge, a pose readout that is not the identity (so
that the sim(3) alignment is well posed) and ``optim.test_iter = 5``.

The JAX loop draws its rays from ``fold_in(key, i) -> split ->
sample_ray_subset``; the tests reproduce those uniforms on the JAX side and
inject them into the port.

Tolerances: the render and its gradient are fp32 on both sides with
different summation orders: values rtol 1e-5, d/d(se3) rtol 1e-3 plus 1e-5
of its largest entry. Five Adam steps of lr 1e-3 move the pose by ~5e-3; the
refined pose agrees to 1e-5. The evaluation's PSNR, SSIM and pose errors
agree to rtol 1e-4.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neural_invertible_warp_tpu.models import get_system_class as jax_system_class
from neural_invertible_warp_tpu.ops import lie as jlie
from neural_invertible_warp_tpu.ops import pose as jpose
from neural_invertible_warp_tpu.ops import rays as jrays
from neural_invertible_warp_tpu.ops import lpips as jlpips
from neural_invertible_warp_tpu_torch.models import get_system_class
from neural_invertible_warp_tpu_torch.ops import lie, lpips, rays
from neural_invertible_warp_tpu_torch.ops import pose as pose_ops
from neural_invertible_warp_tpu_torch.utils import weights

from test_torch_train_step import H, W, N_IMG, _arrays, _options

TEST_ITER = 5
N_TEST = 2
PROGRESS = 0.4


def _readout(train):
    """A pose readout near the GT poses: GT composed with a small se(3)."""
    rng = np.random.RandomState(3)
    noise = jlie.se3_to_SE3(jnp.asarray(rng.randn(N_IMG, 6) * 0.02, jnp.float32))
    return np.asarray(jpose.compose([noise, jnp.asarray(train["pose"])]))


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    train, test = _arrays(N_IMG, 0), _arrays(N_TEST, 1)
    readout = _readout(train)

    def options(name):
        opt = _options(tmp_path_factory.mktemp(name))
        opt.optim.test_iter = TEST_ITER
        assert opt.optim.test_photo and opt.tpu.ray_sample == "stratified"
        return opt
    jsys = jax_system_class("barf_inn_llff")(options("jax"))
    jsys.attach_data(train, test)
    state = jsys.init_state(jax.random.PRNGKey(0))
    state = dict(state, step=jnp.int32(3),
                 aux=dict(state["aux"], global_rigid=jnp.asarray(readout)))

    psys = get_system_class("barf_inn_llff")(options("port"), "cpu")
    psys.attach_data(train, test)
    psys.init_state(0)
    psys.graph.load_state_dict(weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, state["params"])))
    psys.step = 3
    psys.aux["global_rigid"] = torch.tensor(readout)
    return jsys, state, psys


def _ray_u(key, n_iter, n_rays):
    """The uniforms behind the JAX refinement loop's ray draws."""
    us = []
    for i in range(n_iter):
        k_perm, _ = jax.random.split(jax.random.fold_in(key, i))
        us.append(np.asarray(jax.random.uniform(k_perm, (n_rays,))))
    return torch.tensor(np.stack(us))


def test_render_test_optim_value_and_pose_gradient(systems):
    """render_rays(mode="test-optim"): unjittered depths, rgb and the
    gradient of the photometric loss with respect to a per-view se(3)."""
    jsys, state, psys = systems
    rng = np.random.RandomState(0)
    se3 = (rng.randn(1, 6) * 0.01).astype(np.float32)
    idx = np.sort(rng.choice(H * W, 48, replace=False))
    pose0 = np.asarray(jsys.test_data["pose"][:1])
    intr = np.asarray(jsys.test_data["intr"][:1])
    pixels = np.asarray(jsys.test_data["pixels"][:1])

    def loss_j(se3):
        pose = jpose.compose([jlie.se3_to_SE3(se3), jnp.asarray(pose0)])
        center, ray = jrays.get_center_and_ray(pose, jnp.asarray(intr), H=H, W=W,
                                               ray_idx=jnp.asarray(idx))
        out = jsys.render_rays(state["params"], center, ray, jax.random.PRNGKey(0),
                               mode="test-optim", progress=PROGRESS, intr=jnp.asarray(intr))
        return jnp.mean((out["rgb"] - jnp.asarray(pixels)[:, idx]) ** 2), out
    (l_j, out_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(jnp.asarray(se3))

    se3_t = torch.tensor(se3, requires_grad=True)
    idx_t = torch.tensor(idx)
    pose = pose_ops.compose([lie.se3_to_SE3(se3_t), torch.tensor(pose0)])
    center, ray = rays.get_center_and_ray(pose, torch.tensor(intr), idx_t, W)
    out_t = psys.render_rays(center, ray, mode="test-optim", progress=PROGRESS)
    l_t = torch.mean((out_t["rgb"] - torch.tensor(pixels)[:, idx_t]) ** 2)
    l_t.backward()
    for k in ("rgb", "depth", "opacity"):
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    g_j = np.asarray(g_j)
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(se3_t.grad.numpy(), g_j, rtol=1e-3,
                               atol=1e-5 * np.abs(g_j).max())
    # the same rays in "eval" mode render the same values (both unjittered)
    with torch.no_grad():
        out_e = psys.render_rays(center.detach(), ray.detach(), mode="eval", progress=PROGRESS)
    assert torch.equal(out_e["rgb"], out_t["rgb"].detach())


def test_five_refinement_steps_match_jax(systems):
    jsys, state, psys = systems
    key = jax.random.PRNGKey(7)
    pose0 = jsys.test_data["pose"][:1]
    intr, pixels = jsys.test_data["intr"][:1], jsys.test_data["pixels"][:1]
    ref = np.asarray(jax.jit(jsys.make_test_time_optim())(
        state["params"], state["aux"], pose0, intr, pixels, key, jnp.float32(PROGRESS)))

    n_rays = min(psys.opt.nerf.rand_rays, H * W)
    requires = [p.requires_grad for p in psys.graph.parameters()]
    psys.graph.zero_grad(set_to_none=True)
    got = psys.test_time_optimized_pose(
        psys.test_data["pose"][:1], psys.test_data["intr"][:1],
        psys.test_data["pixels"][:1], PROGRESS, ray_u=_ray_u(key, TEST_ITER, n_rays))
    assert got.shape == (1, 3, 4) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    # the pose moved by about test_iter * lr, and the loop left the weights
    # trainable and without gradients
    moved = np.abs(ref - np.asarray(pose0)).max()
    assert 1e-3 < moved < 1e-1
    assert psys.refine_losses.shape == (TEST_ITER,)
    assert bool(torch.isfinite(psys.refine_losses).all())
    assert [p.requires_grad for p in psys.graph.parameters()] == requires
    assert all(p.grad is None for p in psys.graph.parameters())


def test_refinement_with_a_generator_is_reproducible(systems):
    """Without injected draws the ray subsets come from the given generator."""
    _, _, psys = systems
    args = (psys.test_data["pose"][:1], psys.test_data["intr"][:1],
            psys.test_data["pixels"][:1], PROGRESS)
    a = psys.test_time_optimized_pose(*args, generator=torch.Generator().manual_seed(5))
    b = psys.test_time_optimized_pose(*args, generator=torch.Generator().manual_seed(5))
    c = psys.test_time_optimized_pose(*args, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("test_optim", [False, True], ids=["plain", "refined"])
def test_evaluate_full_matches_jax(systems, tmp_path, monkeypatch, test_optim):
    """evaluate_full, with and without test-time refinement: the result keys,
    PSNR, SSIM and the aligned pose errors against the JAX system's, the
    files written, and LPIPS gated off without weights."""
    jsys, state, psys = systems
    monkeypatch.delenv(lpips.WEIGHTS_ENV, raising=False)
    lpips.reset_cache()
    jlpips.reset_cache()
    out_j, out_t = tmp_path / "jax", tmp_path / "port"
    out_j.mkdir()
    out_t.mkdir()
    ref = jsys.evaluate_full(state, output_path=str(out_j), dump_images=True,
                             test_optim=test_optim)

    # the JAX evaluation refines view i with PRNGKey(1000 + i)
    n_rays = min(psys.opt.nerf.rand_rays, H * W)
    draws = [_ray_u(jax.random.PRNGKey(1000 + i), TEST_ITER, n_rays) for i in range(N_TEST)]
    refine = psys.test_time_optimized_pose
    calls = []

    def refine_with_draws(pose, intr, pixels, progress, generator=None):
        calls.append(len(calls))
        return refine(pose, intr, pixels, progress, ray_u=draws[calls[-1]])
    monkeypatch.setattr(psys, "test_time_optimized_pose", refine_with_draws)
    got = psys.evaluate_full(output_path=str(out_t), dump_images=True, test_optim=test_optim)

    assert len(calls) == (N_TEST if test_optim else 0)
    assert list(got) == list(ref) == ["rot_error_deg", "trans_error", "PSNR", "SSIM", "LPIPS"]
    assert got["LPIPS"] is None and ref["LPIPS"] is None
    for k in ("rot_error_deg", "trans_error", "PSNR", "SSIM"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == [
        "quant.txt", "quant_pose.txt", "test_view"]
    assert sorted(os.listdir(out_t / "test_view")) == sorted(os.listdir(out_j / "test_view")) \
        == sorted("{}_{}.png".format(n, i) for n in ("rgb", "rgb_GT", "depth")
                  for i in range(N_TEST))
    for name, n_rows in (("quant.txt", N_TEST), ("quant_pose.txt", N_IMG)):
        rows_t = [l.split() for l in open(out_t / name).read().splitlines()]
        rows_j = [l.split() for l in open(out_j / name).read().splitlines()]
        assert len(rows_t) == len(rows_j) == n_rows
        for rt, rj in zip(rows_t, rows_j):
            assert rt[0] == rj[0]
            if name == "quant.txt":
                assert rt[3] == rj[3] == "unavailable"
            np.testing.assert_allclose([float(x) for x in rt[1:3]],
                                       [float(x) for x in rj[1:3]], rtol=1e-4)
    assert len(psys.eval_log) == N_TEST
    assert ("refine_losses" in psys.eval_log[0]) == test_optim


def test_validate_returns_vis_all(systems):
    """validate keeps the maps of the first tb.num_images views, as the JAX
    system does."""
    jsys, state, psys = systems
    n_vis = int(np.prod(psys.opt.tb.num_images))
    res = psys.validate()
    ref = jsys.validate(state)
    assert len(res["vis_all"]) == len(ref["vis_all"]) == min(N_TEST, n_vis)
    assert res["vis"] is res["vis_all"][0]
    np.testing.assert_allclose(res["psnr_val"], ref["psnr_val"], rtol=1e-4)
    for k in ("error_R", "error_t"):
        np.testing.assert_allclose(res[k], ref[k], rtol=1e-4)
    np.testing.assert_allclose(res["vis_all"][-1]["rgb"], ref["vis_all"][-1]["rgb"],
                               rtol=1e-4, atol=1e-5)
