"""Positional encodings (port of neural_invertible_warp_tpu/ops/posenc.py).

* ``positional_encoding``: per input dim d, [sin(f_0 x_d)..sin(f_{L-1} x_d),
  cos(f_0 x_d)..cos(f_{L-1} x_d)], frequencies f_k = f32(2^k) * f32(pi).
* ``barf_c2f_weights``: the BARF coarse-to-fine band weights.
* ``annealed_embed_reference``: the INN warp's embedding with the
  reference's point-axis window (see the JAX module for the history).
"""

from __future__ import annotations

import math

import torch


def _freqs(L, like):
    return (2.0 ** torch.arange(L, dtype=like.dtype, device=like.device)) * math.pi


def positional_encoding(x, L):
    """[...,D] -> [...,2*D*L] sin/cos encoding (no identity term)."""
    spectrum = x[..., None] * _freqs(L, x)                          # [...,D,L]
    enc = torch.stack([torch.sin(spectrum), torch.cos(spectrum)], dim=-2)
    return enc.reshape(x.shape[:-1] + (-1,))


def barf_c2f_weights(progress, L, c2f, dtype=torch.float32, device=None):
    """weight_k = (1 - cos(pi * clamp(alpha - k, 0, 1))) / 2,
    alpha = (progress - start) / (end - start) * L."""
    start, end = c2f
    progress = torch.as_tensor(progress, dtype=dtype, device=device)
    alpha = (progress - start) / (end - start) * L
    k = torch.arange(L, dtype=dtype, device=device)
    return (1 - torch.cos(torch.clamp(alpha - k, 0.0, 1.0) * math.pi)) / 2


def positional_encoding_c2f(x, L, progress=None, c2f=None):
    """PE with optional BARF c2f weighting. Returns [...,2*D*L]."""
    spectrum = x[..., None] * _freqs(L, x)
    enc = torch.stack([torch.sin(spectrum), torch.cos(spectrum)], dim=-2)
    if c2f is not None:
        enc = enc * barf_c2f_weights(progress, L, c2f, x.dtype, x.device)
    return enc.reshape(x.shape[:-1] + (-1,))


def annealed_embed(x, multires, alpha_ratio):
    """Nerfies-windowed PE: [...,D] -> [...,D*(1+2L)], layout
    [x, sin(f_0 x), cos(f_0 x), ..., sin(f_{L-1} x), cos(f_{L-1} x)]."""
    D = x.shape[-1]
    freqs = (2.0 ** torch.linspace(0.0, multires - 1, multires,
                                   dtype=x.dtype, device=x.device)) * math.pi
    spectrum = x[..., None, :] * freqs[:, None]                    # [...,L,D]
    i = torch.arange(multires, dtype=x.dtype, device=x.device)
    alpha_ratio = torch.as_tensor(alpha_ratio, dtype=x.dtype, device=x.device)
    w = (1 - torch.cos(math.pi * torch.clamp(alpha_ratio * multires - i,
                                             0.0, 1.0))) * 0.5
    sin = torch.sin(spectrum) * w[:, None]
    cos = torch.cos(spectrum) * w[:, None]
    bands = torch.stack([sin, cos], dim=-2).reshape(
        x.shape[:-1] + (2 * multires * D,))
    return torch.cat([x, bands], dim=-1)


def annealed_embed_reference(x, multires, alpha_ratio):
    """The INN embedding as the reference computes it: every feature is
    full-frequency, and point rows (2i+1)*D .. (2i+3)*D of the N axis are
    scaled by the band-i window. x: [B,N,D] -> [B,N,D*(1+2L)]."""
    D = x.shape[-1]
    N = x.shape[-2]
    full = annealed_embed(x, multires, 1.0)
    i = torch.arange(multires, dtype=x.dtype, device=x.device)
    alpha_ratio = torch.as_tensor(alpha_ratio, dtype=x.dtype, device=x.device)
    w = (1 - torch.cos(math.pi * torch.clamp(alpha_ratio * multires - i,
                                             0.0, 1.0))) * 0.5
    rows = torch.arange(N, device=x.device)
    row_w = torch.ones((N,), dtype=x.dtype, device=x.device)
    for b in range(multires):
        lo, hi = (2 * b + 1) * D, (2 * b + 3) * D
        in_band = (rows >= lo) & (rows < hi)
        row_w = row_w * torch.where(in_band, w[b], torch.ones_like(w[b]))
    return full * row_w[:, None]
