"""Positional encodings (port of neural_invertible_warp_tpu/ops/posenc.py).

* ``positional_encoding``: per input dim d, [sin(f_0 x_d)..sin(f_{L-1} x_d),
  cos(f_0 x_d)..cos(f_{L-1} x_d)], frequencies f_k = f32(2^k) * f32(pi).
* ``barf_c2f_weights``: the BARF coarse-to-fine band weights.
* ``annealed_embed_reference``: the INN warp's embedding with the
  reference's point-axis window (see the JAX module for the history);
  ``reference_row_window`` is that window alone.
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


def _band_spectrum(x, multires):
    """[...,D] -> [...,L,D]: x times the band frequencies f32(2^l) * f32(pi)."""
    freqs = (2.0 ** torch.linspace(0.0, multires - 1, multires,
                                   dtype=x.dtype, device=x.device)) * math.pi
    return x[..., None, :] * freqs[:, None]


def full_embed(x, multires):
    """Full-frequency PE: [...,D] -> [...,D*(1+2L)], layout
    [x, sin(f_0 x), cos(f_0 x), ..., sin(f_{L-1} x), cos(f_{L-1} x)]."""
    spectrum = _band_spectrum(x, multires)
    bands = torch.stack([torch.sin(spectrum), torch.cos(spectrum)], dim=-2).reshape(
        x.shape[:-1] + (2 * multires * x.shape[-1],))
    return torch.cat([x, bands], dim=-1)


def annealed_embed(x, multires, alpha_ratio):
    """Nerfies-windowed PE in ``full_embed``'s layout: band i of the sin
    and cos columns is scaled by (1 - cos(pi * clamp(alpha * L - i, 0, 1))) / 2."""
    D = x.shape[-1]
    spectrum = _band_spectrum(x, multires)                         # [...,L,D]
    i = torch.arange(multires, dtype=x.dtype, device=x.device)
    alpha_ratio = torch.as_tensor(alpha_ratio, dtype=x.dtype, device=x.device)
    w = (1 - torch.cos(math.pi * torch.clamp(alpha_ratio * multires - i,
                                             0.0, 1.0))) * 0.5
    sin = torch.sin(spectrum) * w[:, None]
    cos = torch.cos(spectrum) * w[:, None]
    bands = torch.stack([sin, cos], dim=-2).reshape(
        x.shape[:-1] + (2 * multires * D,))
    return torch.cat([x, bands], dim=-1)


_ROW_BANDS = {}   # (N, D, multires, device) -> (band index per row, rows inside a band)


def reference_row_window(N, D, multires, alpha_ratio, dtype=torch.float32, device=None):
    """The reference's point-axis window as a [N] vector: rows (2i+1)*D ..
    (2i+3)*D carry the band-i weight (1 - cos(pi * clamp(alpha * L - i, 0,
    1))) / 2, every other row 1. The rows' band indices depend on the shape
    only and are kept, so a call costs a handful of small ops."""
    device = torch.device("cpu" if device is None else device)
    key = (N, D, multires, device)
    if key not in _ROW_BANDS:
        rows = torch.arange(N, device=device)
        band = torch.div(rows - D, 2 * D, rounding_mode="floor")
        _ROW_BANDS[key] = (torch.clamp(band, 0, multires - 1),
                           (rows >= D) & (band < multires))
    band, in_band = _ROW_BANDS[key]
    i = torch.arange(multires, dtype=dtype, device=device)
    alpha_ratio = torch.as_tensor(alpha_ratio, dtype=dtype, device=device)
    w = (1 - torch.cos(math.pi * torch.clamp(alpha_ratio * multires - i,
                                             0.0, 1.0))) * 0.5
    return torch.where(in_band, w[band], torch.ones((), dtype=dtype, device=device))


def annealed_embed_reference(x, multires, alpha_ratio):
    """The INN embedding as the reference computes it: every feature is
    full-frequency, and point rows (2i+1)*D .. (2i+3)*D of the N axis are
    scaled by the band-i window. x: [B,N,D] -> [B,N,D*(1+2L)]."""
    full = full_embed(x, multires)
    row_w = reference_row_window(x.shape[-2], x.shape[-1], multires, alpha_ratio,
                                 x.dtype, x.device)
    return full * row_w[:, None]
