"""The NeRF field MLP on encoded inputs as one CUDA kernel per direction
(K1), with its plain PyTorch version (port of
neural_invertible_warp_tpu/ops/pallas/fused_field.py, ``fused_mlp`` with its
VJP and ``fused_apply_nerf_samples``).

The PE of the points and of the unit rays is PyTorch, under autograd; the
kernel takes xp [N,63] and view [N,27] per sample and returns [N,4] = (rgb,
density). Under autograd the forward keeps its activations and the backward
kernel returns dxp, dview and, where a weight needs one, the weight
gradients. Unlike the TPU kernel it takes the density-noise draw ([N], added
to the density pre-activation, as K5 and K2 take it), so the MLP-only tier
stays on its kernel when noise is active.

The wrapper takes the plain version only for CPU tensors. For CUDA tensors
it launches the kernel or raises. Sources: ``csrc/field.cu``,
``csrc/nerf_field.cuh`` and ``csrc/gemm_tc.cuh`` (K5's routes and K2's
weight planes: ``fused_pe.py``).
"""

from __future__ import annotations

import torch

from ..nerf_mlp import sample_points
from .fused_pe import (_check_noise, field_launch_bwd, field_launch_fwd, refuse_bf16,
                       run_field_kernel)

D_XP = 63
D_VIEW = 27


def mlp_plain(mlp, xp, view, density_activ="softplus", noise=None):
    """K1's plain version: the layers on xp [N,63], view [N,27] (noise [N]
    optional) -> [N,4]."""
    rgb, dens = mlp.forward_encoded(xp, view, density_activ, noise)
    return torch.cat([rgb, dens[..., None]], dim=-1)


def _check_encoded(xp, view):
    if xp.shape[1:] != (D_XP,) or view.shape != (xp.shape[0], D_VIEW):
        raise ValueError("encoded inputs must be [N,63] and [N,27]: {} {}".format(
            tuple(xp.shape), tuple(view.shape)))


# K = 1 below: the per-ray limits of the PE kernels do not apply to K1

def launch_field_fwd(mlp, xp, view, density_activ="softplus", noise=None, keep=False):
    """One K1 forward launch on CUDA tensors: xp [N,63], view [N,27], noise
    [N] or None. Returns (out [N,4], workspace, K2Weights)."""
    _check_encoded(xp, view)
    N = xp.shape[0]
    tensors = [xp, view] + _check_noise(noise, (N,))
    head = (xp.data_ptr(), view.data_ptr(), None if noise is None else noise.data_ptr(), N)
    return field_launch_fwd("niw_field", mlp, head, tensors, N, 1, density_activ, keep)


def launch_field_bwd(mlp, g, cache, packed, want_dw=True, density_activ="softplus"):
    """One K1 backward launch: g [N,4], with the ``cache`` and the K2Weights
    ``packed`` of the kept forward launch -> (dxp [N,63], dview [N,27], grads
    of ``mlp.parameters()`` or None without ``want_dw``)."""
    N = g.shape[0]
    return field_launch_bwd("niw_field", mlp, (g.data_ptr(), N), [], g, cache, packed, N,
                            1, [(N, D_XP), (N, D_VIEW)], want_dw, density_activ)


def fused_mlp(mlp, xp, view, density_activ="softplus", noise=None):
    """The MLP on encoded inputs (K1): xp [N,63], view [N,27] -> [N,4] =
    (rgb, density), differentiable in xp, view and the weights. noise [N]:
    the density-noise draw, already scaled, optional."""
    if noise is not None:
        noise = noise.detach().contiguous()
    if not xp.is_cuda:
        return mlp_plain(mlp, xp, view, density_activ, noise)
    return run_field_kernel(
        fused_mlp, mlp, xp, view,
        lambda xp, view, keep: launch_field_fwd(mlp, xp, view, density_activ, noise, keep),
        lambda xp, view, g, cache, packed, want_dw: launch_field_bwd(
            mlp, g, cache, packed, want_dw, density_activ))


fused_mlp.launches = 0             # K1 forward launches
fused_mlp.backward_launches = 0    # K1 backward launches


def fused_apply_nerf_samples(mlp, center, ray, depth, *, progress=None,
                             barf_c2f=None, density_activ="softplus", noise=None,
                             compute_dtype="float32"):
    """The field along rays with the PE outside the kernel (K1). center/ray
    [B,R,3]; depth [B,R,K,1]; noise [B,R,K] optional -> (rgb [B,R,K,3],
    density [B,R,K]). ``compute_dtype`` "bfloat16" raises
    NotImplementedError (no bf16 K1 yet)."""
    refuse_bf16(compute_dtype, "K1 (the MLP-only field kernel, tpu.fused_pe: false)")
    B, R, K = depth.shape[0], depth.shape[1], depth.shape[2]
    points, ray_unit = sample_points(center, ray, depth)
    xp, view = mlp.encode(points, ray_unit, progress, barf_c2f)
    out = fused_mlp(mlp, xp.reshape(-1, xp.shape[-1]), view.reshape(-1, view.shape[-1]),
                    density_activ, None if noise is None else noise.reshape(-1))
    return out[:, :3].reshape(B, R, K, 3), out[:, 3].reshape(B, R, K)
