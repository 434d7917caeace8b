"""Local correlation (cost volume) of PDC-Net, plain PyTorch (port of
neural_invertible_warp_tpu/ops/correlation.py).

These are the plain versions of K7 and its two adjoints: the CPU tests and
the CPU route of ``ops/cuda/correlation.py`` run them, and ``chip_smoke.py``
holds the CUDA kernels against them on the card. Displacements (dy, dx) run
over [-md, md]^2 in the order d = (dy + md) (2 md + 1) + (dx + md); windows
that leave the image read zeros (the reference's zero padding).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _displacements(md):
    return [(dy, dx) for dy in range(-md, md + 1) for dx in range(-md, md + 1)]


def local_correlation(f1, f2, max_displacement=4):
    """out[b, d, y, x] = mean_c f1[b,c,y,x] * f2[b,c,y+dy,x+dx].

    f1, f2 [B,C,H,W] -> [B,(2md+1)^2,H,W]; differentiable by autograd."""
    H, W = f1.shape[-2:]
    md = max_displacement
    f2p = F.pad(f2, (md, md, md, md))
    return torch.stack([(f1 * f2p[:, :, md + dy:md + dy + H, md + dx:md + dx + W]).mean(dim=1)
                        for dy, dx in _displacements(md)], dim=1)


def local_correlation_transpose(m, f2, max_displacement=4):
    """The adjoint of ``local_correlation`` with respect to f1 (the
    reference's ``FunctionCorrelationTranspose``):
    df1[b,c,y,x] = (1/C) sum_d m[b,d,y,x] f2[b,c,y+dy,x+dx].

    m [B,(2md+1)^2,H,W], f2 [B,C,H,W] -> [B,C,H,W]."""
    C, H, W = f2.shape[-3:]
    md = max_displacement
    f2p = F.pad(f2, (md, md, md, md))
    out = torch.zeros_like(f2)
    for d, (dy, dx) in enumerate(_displacements(md)):
        out = out + m[:, d:d + 1] * f2p[:, :, md + dy:md + dy + H, md + dx:md + dx + W]
    return out / C


def local_correlation_transpose_f2(m, f1, max_displacement=4):
    """The adjoint of ``local_correlation`` with respect to f2:
    df2[b,c,y,x] = (1/C) sum_d m[b,d,y-dy,x-dx] f1[b,c,y-dy,x-dx].

    m [B,(2md+1)^2,H,W], f1 [B,C,H,W] -> [B,C,H,W]."""
    C, H, W = f1.shape[-3:]
    md = max_displacement
    out = torch.zeros_like(f1)
    for d, (dy, dx) in enumerate(_displacements(md)):
        # the product at (y, x) lands on (y + dy, x + dx); what leaves the
        # image is dropped
        moved = F.pad(m[:, d:d + 1] * f1, (md + dx, md - dx, md + dy, md - dy))
        out = out + moved[:, :, md:md + H, md:md + W]
    return out / C
