"""Depth and ray-subset sampling (port of neural_invertible_warp_tpu/ops/sampling.py).

Random draws come from an explicit ``torch.Generator``, or are passed in as
``rand`` / ``u`` so that tests can hand both packages the same numbers.
Fine (inverse-CDF) sampling is not ported yet (ROADMAP M9).
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
    each, from u ~ U[0,1)^n_pick. The other modes (``topk``,
    ``permutation``) are not ported yet (ROADMAP M9).
    """
    if mode != "stratified":
        raise NotImplementedError(
            "ray_sample mode {!r} is not ported yet (ROADMAP M9)".format(mode))
    if u is None:
        u = torch.rand((n_pick,), generator=generator, device=device)
    i = torch.arange(n_pick + 1, dtype=torch.int64, device=u.device)
    bounds = (i * n_total) // n_pick
    lo, hi = bounds[:-1], bounds[1:]
    return lo + (u * (hi - lo).to(u.dtype)).to(torch.int64)
