"""Ray-axis data parallelism over several GPUs (port of
neural_invertible_warp_tpu/parallel/mesh.py).

The JAX package runs one process over a device mesh and lets GSPMD insert
the collectives. Here there is one process per GPU under
``torch.distributed``, with the same semantics:

* one global draw per step: every rank draws the step's ray indices, depth
  jitter and density noise at their global shapes from the same (seed,
  step) generator, and then keeps its own rays. A rank that drew only its
  own share would make the result depend on the GPU count;
* rays sharded: rank r takes the contiguous ``[lo, hi)`` of
  ``torch.tensor_split``'s bounds, uneven where the count does not divide,
  so no pad rays are needed;
* weights replicated; gradients summed over the ranks by one all-reduce
  over a flat buffer (summed, not averaged as DistributedDataParallel does,
  which would be wrong for uneven shards and for replicated terms);
* results invariant to the GPU count up to the fp32 order of the sums.

The rule that makes the summed gradient the global one: **a term computed
identically on every rank is divided by the world size; a term over the
rank's rays is divided by the global count of its terms.** A rank with no
rays still joins every collective.

``use_group(group)`` installs a ``RayGroup`` for the code under it; every
helper is a no-op without one, so the one-process path is unchanged. The
caller creates the process group and names its backend: ``nccl`` for one
GPU per rank, ``gloo`` for CPU tensors or for several ranks on one GPU.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch


@dataclasses.dataclass(frozen=True)
class RayGroup:
    process_group: object
    rank: int
    world_size: int


_active = None


def make_group(process_group=None):
    """A RayGroup over ``process_group`` (default: the default group, which
    ``torch.distributed.init_process_group`` must have created)."""
    import torch.distributed as dist
    pg = process_group if process_group is not None else dist.group.WORLD
    return RayGroup(pg, dist.get_rank(pg), dist.get_world_size(pg))


@contextmanager
def use_group(group):
    global _active
    previous, _active = _active, group
    try:
        yield group
    finally:
        _active = previous


def active_group():
    return _active


def world_size():
    return 1 if _active is None else _active.world_size


def _shard_sizes(n):
    """Ray counts of the group's shards of ``n`` rays, as torch.tensor_split
    cuts them."""
    return [t.numel() for t in torch.empty(n, device="meta").tensor_split(_active.world_size)]


def shard_bounds(n):
    """This rank's ``[lo, hi)`` of ``n`` rays; ``(0, n)`` without a group."""
    if _active is None:
        return 0, n
    sizes = _shard_sizes(n)
    lo = sum(sizes[:_active.rank])
    return lo, lo + sizes[_active.rank]


def shard_rays(x, dim=1):
    """This rank's rays of ``x`` along ``dim``: a view; ``x`` itself
    without a group."""
    if _active is None:
        return x
    return x.tensor_split(_active.world_size, dim)[_active.rank]


def all_reduce_sum(t):
    """``t`` summed over the group, in place; ``t`` itself without a group."""
    if _active is not None:
        import torch.distributed as dist
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_active.process_group)
    return t


def all_reduce_grads(params):
    """Sum every gradient of ``params`` over the group with one all-reduce
    over a flat buffer. A parameter without a gradient counts as zeros; it
    keeps ``grad = None`` only where no rank has a gradient for it, as the
    one-process step would leave it."""
    if _active is None:
        return
    params = list(params)
    if not params:
        return
    dev, dtype = params[0].device, params[0].dtype
    parts = [p.grad.reshape(-1) if p.grad is not None
             else torch.zeros(p.numel(), device=dev, dtype=dtype) for p in params]
    parts.append(torch.tensor([float(p.grad is not None) for p in params],
                              device=dev, dtype=dtype))
    flat = all_reduce_sum(torch.cat(parts))
    chunks = flat.split([p.numel() for p in params] + [len(params)])
    has_grad = chunks[-1].tolist()
    for p, chunk, flag in zip(params, chunks, has_grad):
        if flag == 0:
            p.grad = None
        elif p.grad is None:
            p.grad = chunk.view_as(p).clone()
        else:
            p.grad.copy_(chunk.view_as(p))


def all_gather_rays(t, n, dim=1):
    """The ranks' shards of ``n`` rays along ``dim``, in rank order: every
    rank gets the whole ``[..., n, ...]``; ``t`` itself without a group.
    The shards are padded to the largest one for the collective."""
    if _active is None:
        return t
    import torch.distributed as dist
    sizes = _shard_sizes(n)
    if t.shape[dim] != sizes[_active.rank]:
        raise ValueError("rank {} holds {} rays of {}, not its shard of {}".format(
            _active.rank, t.shape[dim], n, sizes[_active.rank]))
    width = max(sizes)
    pad = list(t.shape)
    pad[dim] = width - t.shape[dim]
    padded = torch.cat([t, t.new_zeros(pad)], dim=dim).contiguous()
    parts = [torch.empty_like(padded) for _ in sizes]
    dist.all_gather(parts, padded, group=_active.process_group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim=dim)
