"""The port's INN warp (ops/inn.py) and quaternion Procrustes (ops/align.py)
against the JAX package's, on the CPU.

The INN weights come from the JAX init and cross the weight bridge; the
zero-initialized output layers are overwritten with small random values so
that the warp, and every gradient through it, is non-trivial. Tolerances:
fp32 on both sides; the warp composes three coupling blocks of small
matmuls (rtol 1e-5, atol 1e-6 on points; gradients rtol 1e-4, atol 1e-6,
and for weight gradients atol 1e-5 of the leaf's largest entry, for
summation order). Procrustes: rotations to 1e-5; the VJP through the
adjugate solve to rtol 1e-4; the SVD method's rotation equals the
quaternion method's to 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neural_invertible_warp_tpu.ops import align as jalign
from neural_invertible_warp_tpu.ops import inn as jinn
from neural_invertible_warp_tpu.ops import lie as jlie
from neural_invertible_warp_tpu_torch.ops import align, inn
from neural_invertible_warp_tpu_torch.utils import weights

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

D_FEAT, D_HIDDEN = 8, 16


def _perturbed_params(seed):
    params = jinn.init_deform_params(jax.random.PRNGKey(seed), D_FEAT,
                                     d_hidden=D_HIDDEN, multires=6)
    rng = np.random.RandomState(seed)

    def fill(layer):
        out = {k: np.asarray(v) for k, v in layer.items()}
        for k in ("w", "b"):
            if k in out and not np.any(out[k]):
                out[k] = (rng.randn(*out[k].shape) * 0.05).astype(np.float32)
        return out
    return dict(blocks=[dict(a=[fill(l) for l in b["a"]], b=[fill(l) for l in b["b"]],
                             c=fill(b["c"])) for b in params["blocks"]])


@pytest.mark.parametrize("anneal,alpha", [("reference", 0.0), ("reference", 0.3),
                                          ("bands", 0.3)])
def test_deform_forward_values_and_grads(anneal, alpha):
    params = _perturbed_params(1)
    rng = np.random.RandomState(2)
    code = rng.randn(3, D_FEAT).astype(np.float32)
    pts = rng.randn(3, 40, 3).astype(np.float32)
    cot = rng.randn(3, 40, 3).astype(np.float32)

    def jf(params, code, pts):
        out = jinn.deform_forward(params, code, pts, alpha, multires=6,
                                  anneal=anneal)
        return jnp.sum(out * cot), out
    (_, out_j), g_j = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(code),
        jnp.asarray(pts))

    net = inn.DeformNetwork(D_FEAT, d_hidden=D_HIDDEN, multires=6, anneal=anneal)
    net.load_state_dict(weights.deform_from_jax(params))
    c = torch.tensor(code, requires_grad=True)
    p = torch.tensor(pts, requires_grad=True)
    out_t = inn.deform_forward(net, c, p, alpha)
    torch.sum(out_t * torch.tensor(cot)).backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(g_j[1]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(g_j[2]), rtol=1e-4, atol=1e-6)
    g_t = weights.deform_to_jax(net, get=lambda q: q.grad)
    leaves_j = jax.tree_util.tree_leaves_with_path(g_j[0])
    leaves_t = jax.tree_util.tree_leaves(g_t)
    assert len(leaves_j) == len(leaves_t)
    for (path, a), b in zip(leaves_j, leaves_t):
        scale = float(np.abs(np.asarray(a)).max())
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5 * scale + 1e-7,
                                   err_msg=jax.tree_util.keystr(path))


def test_deform_init_is_identity_and_bridges_back():
    """A fresh port DeformNetwork is the identity map; JAX params survive
    the bridge both ways."""
    net = inn.DeformNetwork(D_FEAT, d_hidden=D_HIDDEN,
                            generator=torch.Generator().manual_seed(0))
    pts = torch.randn(2, 10, 3)
    out = inn.deform_forward(net, torch.randn(2, D_FEAT), pts, 0.0)
    assert torch.allclose(out, pts, atol=1e-6)
    params = _perturbed_params(3)
    net.load_state_dict(weights.deform_from_jax(params))
    back = weights.deform_to_jax(net)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


def _point_pairs(seed, n=50, noise=0.01, spread=1.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, n, 3) * spread).astype(np.float32)
    R = np.asarray(jlie.so3_to_SO3(jnp.asarray(rng.randn(4, 3).astype(np.float32))))
    y = (x @ np.swapaxes(R, -1, -2) + rng.randn(4, 1, 3)
         + noise * rng.randn(4, n, 3)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("noise,spread", [(0.01, 1.0), (0.3, 1.0), (0.0, 1e-2)])
def test_quat_procrustes_rotation_and_vjp(noise, spread):
    x, y = _point_pairs(0, noise=noise, spread=spread)
    M = np.einsum("bni,bnj->bij", y - y.mean(1, keepdims=True),
                  x - x.mean(1, keepdims=True)).astype(np.float32)
    G = np.random.RandomState(1).randn(4, 3, 3).astype(np.float32)
    R_j, vjp = jax.vjp(jalign.procrustes_rotation_quat, jnp.asarray(M))
    (gM_j,) = vjp(jnp.asarray(G))
    Mt = torch.tensor(M, requires_grad=True)
    R_t = align.ProcrustesQuat.apply(Mt)
    R_t.backward(torch.tensor(G))
    np.testing.assert_allclose(R_t.detach().numpy(), np.asarray(R_j), atol=1e-5)
    scale = np.abs(np.asarray(gM_j)).max()
    np.testing.assert_allclose(Mt.grad.numpy(), np.asarray(gM_j), rtol=1e-4,
                               atol=1e-5 * scale)


def test_rigid_points_registration_grads():
    """(R, t) and the gradients of a loss through them to both point sets,
    as the global-alignment loss uses them."""
    x, y = _point_pairs(2, noise=0.05)
    cot_R = np.random.RandomState(3).randn(4, 3, 3).astype(np.float32)
    cot_t = np.random.RandomState(4).randn(4, 3).astype(np.float32)

    def jf(x, y):
        R, t = jalign.rigid_points_registration(x, y, method="quat")
        return jnp.sum(R * cot_R) + jnp.sum(t * cot_t), (R, t)
    (_, (R_j, t_j)), g_j = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(y))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    R_t, t_t = align.rigid_points_registration(xt, yt, method="quat")
    (torch.sum(R_t * torch.tensor(cot_R)) + torch.sum(t_t * torch.tensor(cot_t))).backward()
    np.testing.assert_allclose(R_t.detach().numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(t_t.detach().numpy(), np.asarray(t_j), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(g_j[1]), rtol=1e-4, atol=1e-5)
    # the SVD method fits the same transform (its VJP: tests/test_torch_inn_family.py)
    R_s, t_s = align.rigid_points_registration(xt, yt, method="svd")
    np.testing.assert_allclose(R_s.detach().numpy(), R_t.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(t_s.detach().numpy(), t_t.detach().numpy(), atol=1e-5)


@pytest.mark.parametrize("method", ["svd", "quat"])
def test_rigid_points_registration_weighted(method):
    """The weighted fit on tests/test_align.py's case (the last 10 of 40
    points corrupted and zero-weighted): the true (R, t), and the same
    values and gradients in x and y as the JAX package."""
    from scipy.spatial.transform import Rotation
    rng = np.random.RandomState(6)
    B, N = 2, 40
    R = Rotation.random(B, random_state=rng).as_matrix().astype(np.float32)
    t = rng.randn(B, 3).astype(np.float32)
    x = rng.randn(B, N, 3).astype(np.float32)
    y = (np.einsum("bij,bnj->bni", R, x) + t[:, None]).astype(np.float32)
    y[:, -10:] += 100.0
    w = np.ones((B, N), np.float32)
    w[:, -10:] = 0.0
    cot_R = rng.randn(B, 3, 3).astype(np.float32)
    cot_t = rng.randn(B, 3).astype(np.float32)

    def jf(x, y):
        R_, t_ = jalign.rigid_points_registration(x, y, jnp.asarray(w), method=method)
        return jnp.sum(R_ * cot_R) + jnp.sum(t_ * cot_t), (R_, t_)
    (_, (R_j, t_j)), g_j = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(y))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    R_t, t_t = align.rigid_points_registration(xt, yt, torch.tensor(w), method=method)
    (torch.sum(R_t * torch.tensor(cot_R)) + torch.sum(t_t * torch.tensor(cot_t))).backward()
    np.testing.assert_allclose(R_t.detach().numpy(), R, atol=1e-4)
    np.testing.assert_allclose(t_t.detach().numpy(), t, atol=1e-4)
    np.testing.assert_allclose(R_t.detach().numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(t_t.detach().numpy(), np.asarray(t_j), atol=1e-5)
    for got, ref in ((xt.grad, g_j[0]), (yt.grad, g_j[1])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())
    # the zero-weighted points take no part in the fit
    assert not np.any(xt.grad.numpy()[:, -10:]) and not np.any(yt.grad.numpy()[:, -10:])


def test_sim3_alignment_matches_jax():
    rng = np.random.RandomState(5)
    X0 = rng.randn(6, 3).astype(np.float32)
    X1 = (X0 * 0.5 + 0.1 * rng.randn(6, 3)).astype(np.float32)
    s_t = align.procrustes_analysis_np(X0, X1)
    s_j = jalign.procrustes_analysis_np(X0, X1)
    for k in s_j:
        np.testing.assert_allclose(s_t[k], s_j[k], rtol=1e-6)
    R = np.asarray(jlie.so3_to_SO3(jnp.asarray(rng.randn(5, 3).astype(np.float32))))
    pose = np.concatenate([R, rng.randn(5, 3, 1)], -1).astype(np.float32)
    for direction in ("pred_to_GT", "GT_to_pred"):
        got = align.apply_sim3_to_poses(torch.tensor(pose),
                                        {k: torch.as_tensor(v) for k, v in s_t.items()},
                                        direction)
        ref = jalign.apply_sim3_to_poses(jnp.asarray(pose),
                                         {k: jnp.asarray(v) for k, v in s_j.items()},
                                         direction)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
