"""K7, PDC-Net's 9x9 local correlation, and its two adjoints as CUDA kernels,
with their plain PyTorch versions (port of
neural_invertible_warp_tpu/ops/pallas/correlation_kernel.py:
``local_correlation_pallas``, and of the adjoint the JAX package takes with
``jax.vjp`` of ops/correlation.py).

    local_correlation(f1, f2, md)            [B,C,H,W] x 2 -> [B,(2md+1)^2,H,W]
    local_correlation_transpose(m, f2, md)   the adjoint in f1 (GOCor's filter
                                             gradient), no autograd
    local_correlation_transpose_f2(m, f1, md)  the adjoint in f2

``local_correlation`` is the autograd Function ``_LocalCorrelation``: its
forward is the K7 kernel and its backward the two adjoint kernels. Each launch
adds one to its kernel's count: ``local_correlation.launches`` (forward),
``local_correlation_transpose.launches`` (adjoint in f1) and
``local_correlation_transpose_f2.launches`` (adjoint in f2).

CPU tensors take the plain versions of ``ops/correlation.py``; CUDA tensors
launch the kernels or raise. Source: ``csrc/correlation.cu``.
"""

from __future__ import annotations

import torch

from .. import correlation as plain
from . import build

KERNEL_MD = 4               # the kernels' search radius, PDC-Net's
D = (2 * KERNEL_MD + 1) ** 2


def _on_cuda(md, *tensors):
    """True for float32 CUDA tensors on one device, False for CPU tensors;
    raises on a mix."""
    if not any(t.is_cuda for t in tensors):
        return False
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev and t.dtype == torch.float32 for t in tensors):
        raise ValueError("the correlation kernels take float32 tensors on one CUDA device")
    if md != KERNEL_MD:
        raise ValueError("the correlation kernels take max_displacement {}, not {}".format(
            KERNEL_MD, md))
    return True


def _launch(fn, a, b):
    """One launch of ``fn``: the forward on two [B,C,H,W] maps a, b ->
    [B,81,H,W], or an adjoint on a [B,81,H,W] cost volume a and a map b ->
    [B,C,H,W]."""
    a, b = a.contiguous(), b.contiguous()
    forward = fn == "niw_corr_fwd"
    if b.dim() != 4 or b.numel() == 0 or a.shape != (
            b.shape if forward else (b.shape[0], D) + b.shape[2:]):
        raise ValueError("{}: operands of shapes {} and {}".format(
            fn, tuple(a.shape), tuple(b.shape)))
    B, C, H, W = b.shape
    out = torch.empty(B, D if forward else C, H, W, dtype=torch.float32, device=b.device)
    lib = build.load_library().lib
    err = getattr(lib, fn)(a.data_ptr(), b.data_ptr(), B, C, H, W, out.data_ptr(),
                           torch.cuda.current_stream(b.device).cuda_stream)
    build.check(err, fn)
    return out


def _forward(f1, f2, md):
    if not _on_cuda(md, f1, f2):
        return plain.local_correlation(f1, f2, md)
    out = _launch("niw_corr_fwd", f1, f2)
    local_correlation.launches += 1
    return out


def local_correlation_transpose(m, f2, max_displacement=4):
    """df1 [B,C,H,W] = (1/C) sum_d m[:,d] f2 shifted by d: the adjoint of
    ``local_correlation`` in f1, without autograd."""
    if not _on_cuda(max_displacement, m, f2):
        return plain.local_correlation_transpose(m, f2, max_displacement)
    out = _launch("niw_corr_adj_f1", m, f2)
    local_correlation_transpose.launches += 1
    return out


def local_correlation_transpose_f2(m, f1, max_displacement=4):
    """df2 [B,C,H,W]: the adjoint of ``local_correlation`` in f2, without
    autograd."""
    if not _on_cuda(max_displacement, m, f1):
        return plain.local_correlation_transpose_f2(m, f1, max_displacement)
    out = _launch("niw_corr_adj_f2", m, f1)
    local_correlation_transpose_f2.launches += 1
    return out


class _LocalCorrelation(torch.autograd.Function):
    """The cost volume from one K7 launch; its backward is one launch of
    each adjoint kernel that an input needs."""

    @staticmethod
    def forward(ctx, f1, f2, md):
        ctx.md = md
        ctx.save_for_backward(f1, f2)
        return _forward(f1.detach(), f2.detach(), md)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        df1 = df2 = None
        if ctx.needs_input_grad[0]:
            df1 = local_correlation_transpose(g, f2, ctx.md)
        if ctx.needs_input_grad[1]:
            df2 = local_correlation_transpose_f2(g, f1, ctx.md)
        return df1, df2, None


def local_correlation(f1, f2, max_displacement=4):
    """Cost volume [B,(2md+1)^2,H,W] of f1, f2 [B,C,H,W]:
    out[b,d,y,x] = mean_c f1[b,c,y,x] f2[b,c,y+dy,x+dx], zero padded;
    differentiable in both inputs."""
    return _LocalCorrelation.apply(f1, f2, max_displacement)


local_correlation.launches = 0                  # K7 forward launches
local_correlation_transpose.launches = 0        # adjoint-in-f1 launches
local_correlation_transpose_f2.launches = 0     # adjoint-in-f2 launches
