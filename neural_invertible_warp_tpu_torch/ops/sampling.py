"""Depth and ray-subset sampling (port of neural_invertible_warp_tpu/ops/sampling.py).

Random draws come from an explicit ``torch.Generator``, or are passed in as
``rand`` / ``u`` so that tests can hand both packages the same numbers.
"""

from __future__ import annotations

import torch


def sample_depth(batch_size, num_rays, num_samples, depth_range,
                 param="metric", stratified=True, generator=None, rand=None,
                 device=None, dtype=torch.float32):
    """Stratified depth samples, [B,R,K,1].

    depth = (u + arange(K)) / K * (far - near) + near with u ~ U[0,1)
    (``rand``, or drawn from ``generator``) or u = 0.5 when not stratified;
    param "inverse" returns 1 / max(depth, 1e-6): the floor caps a sample
    that rounds to depth 0 at 1e6 instead of infinity.
    """
    depth_min, depth_max = depth_range
    shape = (batch_size, num_rays, num_samples, 1)
    if not stratified:
        rand = torch.full(shape, 0.5, dtype=dtype, device=device)
    elif rand is None:
        rand = torch.rand(shape, generator=generator, dtype=dtype,
                          device=device)
    rand = rand + torch.arange(num_samples, dtype=dtype,
                               device=rand.device)[None, None, :, None]
    depth = rand / num_samples * (depth_max - depth_min) + depth_min
    if param == "inverse":
        depth = 1.0 / torch.clamp(depth, min=1e-6)
    elif param != "metric":
        raise ValueError("unknown depth param: {}".format(param))
    return depth


def sample_ray_subset(n_total, n_pick, mode="stratified", generator=None,
                      u=None, device=None):
    """Distinct random n_pick-subset of range(n_total).

    mode "stratified" (the flagship's ``tpu.ray_sample``): split
    range(n_total) into n_pick equal strata and pick one index uniformly in
    each, from u ~ U[0,1)^n_pick. Mode "topk": the indices of the n_pick
    largest of u ~ U[0,1)^n_total, largest first, a tie in index order (as
    ``jax.lax.top_k`` orders them). Mode "permutation": the first n_pick of
    ``torch.randperm(n_total)`` (the reference's draw; it takes no ``u``).
    Both draw every n_pick-subset with equal probability.
    """
    if mode == "permutation":
        return torch.randperm(n_total, generator=generator, device=device)[:n_pick]
    if mode == "topk":
        if u is None:
            u = torch.rand((n_total,), generator=generator, device=device)
        return torch.sort(u, descending=True, stable=True).indices[:n_pick]
    if mode != "stratified":
        raise ValueError("unknown ray_sample mode: {}".format(mode))
    if u is None:
        u = torch.rand((n_pick,), generator=generator, device=device)
    i = torch.arange(n_pick + 1, dtype=torch.int64, device=u.device)
    bounds = (i * n_total) // n_pick
    lo, hi = bounds[:-1], bounds[1:]
    return lo + (u * (hi - lo).to(u.dtype)).to(torch.int64)


def sample_depth_from_pdf(pdf, num_samples, num_samples_fine, depth_range):
    """Deterministic inverse-transform sampling from per-ray weights.

    pdf [B,R,N]: compositing weights of the N coarse bins (not normalized,
    as the reference takes them). The cdf is inverted at the midpoints of
    ``num_samples_fine`` equal bins of [0,1]: ``searchsorted(right=True)``
    brackets each, and the depth is interpolated between the bracketing
    bin edges of the linear depth grid. A midpoint beyond an unnormalized
    cdf's end lands in the last bin (index clipped to N). Returns metric
    depths [B,R,Nf,1].
    """
    depth_min, depth_max = depth_range
    N = num_samples
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)     # [B,R,N+1]
    grid = torch.linspace(0.0, 1.0, num_samples_fine + 1, dtype=pdf.dtype,
                          device=pdf.device)
    unif = (0.5 * (grid[:-1] + grid[1:])).expand(
        cdf.shape[:-1] + (num_samples_fine,)).contiguous()
    idx = torch.searchsorted(cdf, unif, right=True)                    # in 1..N+1
    lo = torch.clamp(idx - 1, min=0)
    hi = torch.clamp(idx, max=N)
    step = (depth_max - depth_min) / N
    depth_low = depth_min + lo.to(pdf.dtype) * step
    depth_high = depth_min + hi.to(pdf.dtype) * step
    cdf_low = torch.gather(cdf, -1, lo)
    cdf_high = torch.gather(cdf, -1, hi)
    t = (unif - cdf_low) / (cdf_high - cdf_low + 1e-8)
    return (depth_low + t * (depth_high - depth_low))[..., None]
