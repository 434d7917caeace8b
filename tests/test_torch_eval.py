"""The port's evaluation-side ops against the JAX package's on the same numpy
inputs: SSIM, LPIPS (with seeded random AlexNet-shaped weights, and the
weight gate), the depth metrics, the inverse-depth map, the novel-view
trajectory and the tensor Procrustes analysis.

Tolerances: atol 1e-5 (fp32 on both sides, different summation orders in
the convolutions and reductions); LPIPS 1e-4, since it sums five layers of
unit-normalised feature differences through up to 3456-term convolutions.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from neural_invertible_warp_tpu.ops import align as jalign
from neural_invertible_warp_tpu.ops import lpips as jlpips
from neural_invertible_warp_tpu.ops import metrics as jmetrics
from neural_invertible_warp_tpu.ops import pose as jpose
from neural_invertible_warp_tpu.ops import render as jrender
from neural_invertible_warp_tpu.ops import ssim as jssim
from neural_invertible_warp_tpu_torch.ops import align, lpips, metrics, render, ssim
from neural_invertible_warp_tpu_torch.ops import pose as pose_ops

ATOL = 1e-5
ATOL_LPIPS = 1e-4
# torchvision AlexNet feature convolutions [out, in, kh, kw]
ALEXNET_CONV_SHAPES = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3),
                       (256, 384, 3, 3), (256, 256, 3, 3)]


def synth_lpips_weights(seed=0):
    rng = np.random.RandomState(seed)
    w = {}
    for i, shape in enumerate(ALEXNET_CONV_SHAPES):
        w["conv{}".format(i)] = rng.randn(*shape).astype(np.float32) * 0.05
        w["conv{}_b".format(i)] = rng.randn(shape[0]).astype(np.float32) * 0.05
        w["lin{}".format(i)] = np.abs(rng.randn(shape[0]).astype(np.float32)) * 0.1
    return w


@pytest.mark.parametrize("pair", ["random", "near identical", "identical"])
def test_ssim_matches_jax(pair):
    rng = np.random.RandomState(0)
    a = rng.rand(2, 3, 24, 32).astype(np.float32)
    b = {"random": rng.rand(2, 3, 24, 32).astype(np.float32),
         "near identical": np.clip(a + 1e-3 * rng.randn(2, 3, 24, 32), 0, 1).astype(np.float32),
         "identical": a}[pair]
    got = float(ssim.ssim(torch.tensor(a), torch.tensor(b)))
    ref = float(jssim.ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - ref) <= ATOL
    if pair == "identical":
        assert abs(got - 1.0) <= ATOL
    if pair == "random":
        assert got < 0.5


def test_lpips_matches_jax_with_synthetic_weights():
    w = synth_lpips_weights()
    rng = np.random.RandomState(1)
    a = rng.rand(1, 3, 64, 64).astype(np.float32) * 2 - 1
    b = rng.rand(1, 3, 64, 64).astype(np.float32) * 2 - 1
    near = (a + 0.01 * (b - a)).astype(np.float32)
    for x, y in ((a, b), (a, near), (a, a)):
        got = lpips.lpips(torch.tensor(x), torch.tensor(y), weights=w)
        ref = jlpips.lpips(x, y, weights=w)
        assert isinstance(got, float) and np.isfinite(got)
        assert abs(got - ref) <= ATOL_LPIPS
    assert lpips.lpips(a, a, weights=w) == pytest.approx(0.0, abs=1e-6)
    assert lpips.lpips(a, near, weights=w) < lpips.lpips(a, b, weights=w)


def test_lpips_gate_follows_the_env_var(tmp_path, monkeypatch):
    """Without weights: not available, NaN; with an npz at NIW_LPIPS_WEIGHTS:
    available, and the same value as the JAX package reads from that file."""
    assert lpips.WEIGHTS_ENV == jlpips.WEIGHTS_ENV
    zeros = np.zeros((1, 3, 32, 32), np.float32)
    lpips.reset_cache()
    jlpips.reset_cache()
    monkeypatch.delenv(lpips.WEIGHTS_ENV, raising=False)
    assert not lpips.available()
    assert np.isnan(lpips.lpips(torch.tensor(zeros), torch.tensor(zeros)))
    path = tmp_path / "w.npz"
    np.savez(path, **synth_lpips_weights())
    monkeypatch.setenv(lpips.WEIGHTS_ENV, str(path))
    lpips.reset_cache()
    assert lpips.available()
    got = lpips.lpips(torch.tensor(zeros - 0.5), torch.tensor(zeros + 0.5))
    assert abs(got - jlpips.lpips(zeros - 0.5, zeros + 0.5)) <= ATOL_LPIPS
    lpips.reset_cache()
    jlpips.reset_cache()
    monkeypatch.delenv(lpips.WEIGHTS_ENV, raising=False)
    assert not lpips.available()


def test_depth_metrics_match_jax():
    rng = np.random.RandomState(2)
    B, H, W, N = 2, 6, 8, 11
    pred = (rng.rand(B, N, 1) * 3 + 1).astype(np.float32)
    gt = (rng.rand(B, H * W) * 3 + 1).astype(np.float32)
    valid = rng.rand(B, H * W) > 0.3
    idx = rng.choice(H * W, N, replace=False)
    got = metrics.depth_error_on_rays(torch.tensor(pred), torch.tensor(gt),
                                      torch.tensor(valid), torch.tensor(idx), 1.7)
    ref = jmetrics.depth_error_on_rays(jnp.asarray(pred), jnp.asarray(gt),
                                       jnp.asarray(valid), jnp.asarray(idx), 1.7)
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in ref], atol=ATOL)
    full = (rng.rand(H, W) * 3 + 1).astype(np.float32)
    got = metrics.depth_error_full(torch.tensor(full), torch.tensor(gt[0].reshape(H, W)),
                                   torch.tensor(valid[0].reshape(H, W)), 0.6)
    ref = jmetrics.depth_error_full(jnp.asarray(full), jnp.asarray(gt[0].reshape(H, W)),
                                    jnp.asarray(valid[0].reshape(H, W)), 0.6)
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in ref], atol=ATOL)


def test_masked_psnr_matches_jax():
    rng = np.random.RandomState(3)
    a = rng.rand(6, 8, 3).astype(np.float32)
    b = rng.rand(6, 8, 3).astype(np.float32)
    mask = (rng.rand(6, 8) > 0.4).astype(np.float32)
    np.testing.assert_allclose(
        metrics.white_composite(torch.tensor(a), torch.tensor(mask)).numpy(),
        np.asarray(jmetrics.white_composite(jnp.asarray(a), jnp.asarray(mask))), atol=0)
    got = float(metrics.masked_psnr(torch.tensor(a), torch.tensor(b), torch.tensor(mask)))
    ref = float(jmetrics.masked_psnr(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask)))
    assert abs(got - ref) <= ATOL


@pytest.mark.parametrize("ndc", [False, True])
def test_invdepth_map_matches_jax(ndc):
    rng = np.random.RandomState(4)
    depth = (rng.rand(1, 12, 1) * (0.9 if ndc else 5.0) + 0.05).astype(np.float32)
    opacity = (rng.rand(1, 12, 1) * 0.9 + 0.1).astype(np.float32)
    got = render.invdepth_map(torch.tensor(depth), torch.tensor(opacity), ndc=ndc)
    ref = jrender.invdepth_map(jnp.asarray(depth), jnp.asarray(opacity), ndc=ndc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=ATOL)


def test_novel_view_poses_and_camera_maps_match_jax():
    rng = np.random.RandomState(5)
    from neural_invertible_warp_tpu.ops import lie as jlie
    R = np.asarray(jlie.so3_to_SO3(jnp.asarray(rng.randn(3) * 0.3, jnp.float32)))
    anchor = np.concatenate([R, rng.randn(3, 1)], -1).astype(np.float32)
    got = pose_ops.get_novel_view_poses(torch.tensor(anchor), N=7, scale=1.3)
    ref = jpose.get_novel_view_poses(jnp.asarray(anchor), N=7, scale=1.3)
    assert got.shape == (7, 3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    for axis in "XYZ":
        a = rng.randn(4).astype(np.float32)
        np.testing.assert_allclose(
            pose_ops.angle_to_rotation_matrix(torch.tensor(a), axis).numpy(),
            np.asarray(jpose.angle_to_rotation_matrix(jnp.asarray(a), axis)), atol=1e-6)
    X = rng.randn(2, 5, 3).astype(np.float32)
    poses = np.stack([anchor, anchor[:, [1, 2, 0, 3]]])
    intr = np.tile(np.array([[20.0, 0, 8], [0, 20.0, 6], [0, 0, 1]], np.float32), (2, 1, 1))
    np.testing.assert_allclose(
        pose_ops.world2cam(torch.tensor(X), torch.tensor(poses)).numpy(),
        np.asarray(jpose.world2cam(jnp.asarray(X), jnp.asarray(poses))), atol=ATOL)
    np.testing.assert_allclose(
        pose_ops.cam2img(torch.tensor(X), torch.tensor(intr)).numpy(),
        np.asarray(jpose.cam2img(jnp.asarray(X), jnp.asarray(intr))), atol=ATOL)


@pytest.mark.parametrize("reflect", [False, True])
def test_procrustes_analysis_matches_jax(reflect):
    """The tensor Procrustes analysis against the JAX one and the host
    float64 one; ``reflect`` mirrors the second point set, so that the
    determinant correction runs."""
    rng = np.random.RandomState(6)
    from neural_invertible_warp_tpu.ops import lie as jlie
    X0 = rng.randn(9, 3).astype(np.float32)
    R = np.asarray(jlie.so3_to_SO3(jnp.asarray(rng.randn(3) * 0.5, jnp.float32)))
    X1 = ((X0 @ R) * 1.7 + rng.randn(3) + 0.01 * rng.randn(9, 3)).astype(np.float32)
    if reflect:
        X1 = X1 * np.array([1, 1, -1], np.float32)
    got = align.procrustes_analysis(torch.tensor(X0), torch.tensor(X1))
    ref = jalign.procrustes_analysis(jnp.asarray(X0), jnp.asarray(X1))
    ref64 = jalign.procrustes_analysis_np(X0, X1)
    assert set(got) == set(ref) == {"t0", "t1", "s0", "s1", "R"}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=ATOL, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), ref64[k], atol=ATOL, err_msg=k)
    assert float(torch.linalg.det(got["R"])) > 0.99
