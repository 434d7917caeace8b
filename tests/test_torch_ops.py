"""The port's math ops (neural_invertible_warp_tpu_torch/ops) against the JAX
package's, on the CPU.

Inputs are made once with numpy and handed to both sides; random draws
(depth jitter, ray-subset uniforms) are taken from the JAX function's own
key and injected into the port. Tolerances: both sides compute in fp32;
elementwise ops agree to a few ulp (rtol 1e-6); ops with reductions or
matrix products differ by summation order (rtol 1e-5); PE at the finest
band multiplies position rounding by 2^9*pi (atol 1e-4).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neural_invertible_warp_tpu.dotdict import DotDict
from neural_invertible_warp_tpu.ops import lie as jlie
from neural_invertible_warp_tpu.ops import nerf_mlp as jmlp
from neural_invertible_warp_tpu.ops import pose as jpose
from neural_invertible_warp_tpu.ops import posenc as jposenc
from neural_invertible_warp_tpu.ops import rays as jrays
from neural_invertible_warp_tpu.ops import render as jrender
from neural_invertible_warp_tpu.ops import sampling as jsampling
from neural_invertible_warp_tpu_torch.ops import lie, nerf_mlp, pose, posenc
from neural_invertible_warp_tpu_torch.ops import rays, render, sampling
from neural_invertible_warp_tpu_torch.utils import weights

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

RNG = np.random.RandomState(0)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a.detach() if hasattr(a, "detach") else a),
                               np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("scale", [0.0, 1e-4, 0.5, 2.0])
def test_lie_exp_maps(scale):
    w = (RNG.randn(5, 6) * scale).astype(np.float32)
    _close(lie.so3_to_SO3(_t(w[:, :3])), jlie.so3_to_SO3(jnp.asarray(w[:, :3])),
           atol=1e-6)
    _close(lie.se3_to_SE3(_t(w)), jlie.se3_to_SE3(jnp.asarray(w)), atol=1e-6)


def test_lie_exp_gradient_smooth_at_zero():
    """The theta^2 series has a finite gradient at theta = 0."""
    w = torch.zeros(2, 6, requires_grad=True)
    lie.se3_to_SE3(w).sum().backward()
    assert torch.isfinite(w.grad).all()
    g_jax = jax.grad(lambda x: jnp.sum(jlie.se3_to_SE3(x)))(jnp.zeros((2, 6)))
    _close(w.grad, g_jax, atol=1e-6)


def _poses(n):
    R = np.asarray(jlie.so3_to_SO3(jnp.asarray(RNG.randn(n, 3).astype(np.float32))))
    t = RNG.randn(n, 3, 1).astype(np.float32)
    return np.concatenate([R, t], -1).astype(np.float32)


def test_pose_ops():
    a, b = _poses(4), _poses(4)
    X = RNG.randn(4, 7, 3).astype(np.float32)
    _close(pose.compose([_t(a), _t(b)]), jpose.compose([jnp.asarray(a), jnp.asarray(b)]),
           atol=1e-5)
    _close(pose.invert_pose(_t(a)), jpose.invert_pose(jnp.asarray(a)), atol=1e-6)
    _close(pose.cam2world(_t(X), _t(a)), jpose.cam2world(jnp.asarray(X), jnp.asarray(a)),
           rtol=1e-5, atol=1e-5)
    Rt, tt = pose.pose_distance(_t(a), _t(b))
    Rj, tj = jpose.pose_distance(jnp.asarray(a), jnp.asarray(b))
    _close(Rt, Rj, rtol=1e-5, atol=1e-5)
    _close(tt, tj, rtol=1e-6)


def test_rays():
    H, W = 6, 8
    f = 0.5 * W / np.tan(0.4)
    intr = np.tile(np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32),
                   (3, 1, 1))
    p = _poses(3)
    idx = np.array([0, 5, 17, 47], np.int64)
    c, r = rays.get_center_and_ray(_t(p), _t(intr), torch.from_numpy(idx), W)
    cj, rj = jrays.get_center_and_ray(jnp.asarray(p), jnp.asarray(intr), W=W,
                                      ray_idx=jnp.asarray(idx, jnp.int32))
    _close(c, cj, rtol=1e-5, atol=1e-5)
    _close(r, rj, rtol=1e-5, atol=1e-5)
    c, g = rays.get_unwarped_center_and_ray(_t(intr), torch.from_numpy(idx), W)
    cj, gj = jrays.get_unwarped_center_and_ray(jnp.asarray(intr), W=W,
                                               ray_idx=jnp.asarray(idx, jnp.int32))
    _close(c, cj)
    _close(g, gj, rtol=1e-6)


@pytest.mark.parametrize("progress,c2f", [(None, None), (0.3, (0.1, 0.5)),
                                          (0.05, (0.1, 0.5)), (0.9, (0.1, 0.5))])
def test_positional_encoding_c2f(progress, c2f):
    x = RNG.randn(5, 3).astype(np.float32)
    _close(posenc.positional_encoding_c2f(_t(x), 10, progress, c2f),
           jposenc.positional_encoding_c2f(jnp.asarray(x), 10, progress, c2f),
           atol=1e-4)
    if c2f is None:
        _close(posenc.positional_encoding(_t(x), 10),
               jposenc.positional_encoding(jnp.asarray(x), 10), atol=1e-4)
    else:
        _close(posenc.barf_c2f_weights(progress, 10, c2f),
               jposenc.barf_c2f_weights(progress, 10, c2f), atol=1e-7)


@pytest.mark.parametrize("alpha", [0.0, 0.37, 1.0])
def test_annealed_embed_reference(alpha):
    """The point-axis window of the reference's embedder, rows included."""
    x = RNG.randn(2, 30, 2).astype(np.float32)
    _close(posenc.annealed_embed_reference(_t(x), 6, alpha),
           jposenc.annealed_embed_reference(jnp.asarray(x), 6, alpha), atol=1e-5)
    _close(posenc.annealed_embed(_t(x), 6, alpha),
           jposenc.annealed_embed(jnp.asarray(x), 6, alpha), atol=1e-5)


@pytest.mark.parametrize("stratified", [True, False])
def test_sample_depth_inverse(stratified):
    """Same draw (taken from the JAX key) -> same inverse depths, with the
    1e-6 floor: a draw of u ~ 1 maps to depth 1e6."""
    key = jax.random.PRNGKey(3)
    B, R, K = 2, 5, 16
    ref = jsampling.sample_depth(key, B, R, K, (1.0, 0.0), param="inverse",
                                 stratified=stratified)
    rand = np.array(jax.random.uniform(key, (B, R, K, 1)))
    got = sampling.sample_depth(B, R, K, (1.0, 0.0), param="inverse",
                                stratified=stratified, rand=_t(rand))
    _close(got, ref, rtol=1e-6)
    rand[0, 0, -1, 0] = 1.0          # the metric depth rounds to 0
    got = sampling.sample_depth(B, R, K, (1.0, 0.0), param="inverse",
                                stratified=True, rand=_t(rand))
    assert float(got[0, 0, -1, 0]) == pytest.approx(1e6)


@pytest.mark.parametrize("n_total,n_pick", [(256, 16), (307200, 113), (100, 7)])
def test_sample_ray_subset_stratified(n_total, n_pick):
    key = jax.random.PRNGKey(n_pick)
    ref = jsampling.sample_ray_subset(key, n_total, n_pick, mode="stratified")
    u = np.array(jax.random.uniform(key, (n_pick,)))
    got = sampling.sample_ray_subset(n_total, n_pick, mode="stratified",
                                     u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert len(set(got.tolist())) == n_pick


def test_composite_values_and_grads():
    B, R, K = 2, 3, 16
    ray = RNG.randn(B, R, 3).astype(np.float32)
    rgb = RNG.rand(B, R, K, 3).astype(np.float32)
    dens = (RNG.rand(B, R, K) * 3).astype(np.float32)
    depth = np.sort(RNG.rand(B, R, K, 1) * 4 + 1, axis=2).astype(np.float32)

    def jloss(ray, rgb, dens):
        o = jrender.composite(ray, rgb, dens, jnp.asarray(depth),
                              setbg_opaque=True, bgcolor=1.0)
        return sum(jnp.sum(v * (i + 1)) for i, v in enumerate(o[:3])), o
    (lj, oj), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(ray), jnp.asarray(rgb), jnp.asarray(dens))
    ts = [_t(v).requires_grad_(True) for v in (ray, rgb, dens)]
    o = render.composite(*ts, _t(depth), setbg_opaque=True, bgcolor=1.0)
    lt = sum(torch.sum(v * (i + 1)) for i, v in enumerate(o[:3]))
    lt.backward()
    for a, b in zip(o, oj):
        _close(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(ts, gj):
        _close(a.grad, b, rtol=1e-4, atol=1e-5)


ARCH = DotDict(dict(layers_feat=[None, 32, 32, 32, 32], layers_rgb=[None, 16, 3],
                    skip=[2], posenc=dict(L_3D=10, L_view=4),
                    density_activ="softplus", tf_init=True))


@pytest.mark.parametrize("activ", ["softplus", "relu"])
def test_nerf_mlp_apply_over_bridge(activ):
    """Same weights over the bridge -> same rgb/density and gradients."""
    params = jmlp.init_nerf_params(jax.random.PRNGKey(1), ARCH)
    mlp = nerf_mlp.NerfMLP(ARCH)
    mlp.load_state_dict(weights.nerf_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    center = RNG.randn(2, 3, 3).astype(np.float32) * 0.2
    ray = RNG.randn(2, 3, 3).astype(np.float32)
    depth = np.sort(RNG.rand(2, 3, 8, 1) * 3 + 1, axis=2).astype(np.float32)

    def jloss(p):
        rgb, d = jmlp.apply_nerf_samples(p, ARCH, jnp.asarray(center), jnp.asarray(ray),
                                         jnp.asarray(depth), density_activ=activ,
                                         progress=0.4, barf_c2f=(0.1, 0.5))
        return jnp.sum(rgb ** 2) + jnp.sum(d), (rgb, d)
    (_, (rgb_j, d_j)), g_j = jax.value_and_grad(jloss, has_aux=True)(params)
    rgb_t, d_t = nerf_mlp.apply_nerf_samples(mlp, _t(center), _t(ray), _t(depth),
                                             density_activ=activ, progress=0.4,
                                             barf_c2f=(0.1, 0.5))
    (torch.sum(rgb_t ** 2) + torch.sum(d_t)).backward()
    _close(rgb_t, rgb_j, rtol=1e-5, atol=2e-6)
    _close(d_t, d_j, rtol=1e-5, atol=2e-6)
    g_t = weights.nerf_to_jax(mlp, get=lambda p: p.grad)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g_j),
                            jax.tree_util.tree_leaves(g_t)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_nerf_mlp_init_statistics():
    """tf_init: Xavier-uniform bounds per layer, gain 1 on the density row."""
    mlp = nerf_mlp.NerfMLP(ARCH, generator=torch.Generator().manual_seed(0))
    last = mlp.mlp_feat[-1].weight.detach()
    b_dens = np.sqrt(6.0 / (1 + last.shape[1]))
    b_feat = np.sqrt(2.0) * np.sqrt(6.0 / (last.shape[0] - 1 + last.shape[1]))
    assert float(last[0].abs().max()) <= b_dens
    assert float(last[1:].abs().max()) <= b_feat
    assert float(last[1:].abs().max()) > 0.8 * b_feat
    assert all(float(l.bias.detach().abs().max()) == 0 for l in mlp.mlp_feat)
