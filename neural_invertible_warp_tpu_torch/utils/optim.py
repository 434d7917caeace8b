"""Per-label Adam with per-step learning-rate schedules (port of
neural_invertible_warp_tpu/utils/flat_optim.py with the ``make_optimizers``
schedules of models/system.py, barf.py and inn_warp.py).

One ``torch.optim.Adam`` holds a parameter group per label. Before update
number ``count`` (0 for the first) each group's lr is set to its schedule
at ``count``, as optax's ``scale_by_schedule`` does. Parameters labelled
``frozen`` are left out, so they never change. In front of Adam, per group
and in this order: a gate (GARF's pose warmup), then a clip to a global
norm (``optim.clip_norm`` / ``clip_norm_pose``), as the JAX package chains
them. Under a ray-sharded step both see the gradients summed over the ranks.
"""

from __future__ import annotations

import torch


def exp_decay_gamma(max_iter, lr, lr_end):
    """gamma = (lr_end / lr)^(1 / max_iter), or 1 without lr_end."""
    if lr_end:
        return (lr_end / lr) ** (1.0 / max_iter)
    return 1.0


def exp_schedule(lr, gamma, warmup=None):
    """count -> lr * gamma^count (* min(1, count / warmup))."""
    def sched(count):
        out = lr * gamma ** count
        if warmup:
            out = out * min(1.0, count / warmup)
        return out
    return sched


class MultiAdam:

    def __init__(self, groups, schedules, gates=None, clips=None):
        """groups: dict label -> list of parameters; schedules: dict label ->
        callable(count) -> lr; gates: dict label -> n, whose gradients are
        zeroed in the first n updates; clips: dict label -> max_norm, the
        limit of the global norm of the group's gradients (optax's
        ``clip_by_global_norm``: g * max_norm / norm where norm >= max_norm,
        no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``). The label
        "frozen" is not optimized.

        A gate sits in front of Adam as optax's does: a gated update still
        counts, with zero gradients, so the moments stay zero, the
        parameters do not move, and Adam's bias correction and the schedule
        run on. Its gradients are written as zeros, not left as None, since
        ``torch.optim.Adam`` skips a parameter without a gradient and would
        not count the update."""
        self.schedules = schedules
        self.gates = dict(gates or {})
        self.clips = dict(clips or {})
        self.labels = [k for k in groups if k != "frozen"]
        self.opt = torch.optim.Adam(
            [dict(params=list(groups[k]), label=k) for k in self.labels],
            lr=0.0, betas=(0.9, 0.999), eps=1e-8)
        self.count = 0

    def parameters(self):
        """Every optimized parameter, group by group."""
        return [p for group in self.opt.param_groups for p in group["params"]]

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self):
        for group in self.opt.param_groups:
            group["lr"] = self.schedules[group["label"]](self.count)
            if self.count < self.gates.get(group["label"], 0):
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    else:
                        p.grad.zero_()
            max_norm = self.clips.get(group["label"])
            if max_norm:
                grads = [p.grad for p in group["params"] if p.grad is not None]
                if grads:
                    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                    keep = norm < max_norm    # on the device: no host sync
                    for g in grads:
                        g.copy_(torch.where(keep, g, g / norm * max_norm))
        self.opt.step()
        self.count += 1

    def moments(self, param):
        """(exp_avg, exp_avg_sq) of a parameter, zeros before its first update."""
        st = self.opt.state.get(param)
        if not st:
            return torch.zeros_like(param), torch.zeros_like(param)
        return st["exp_avg"], st["exp_avg_sq"]

    def load_moments(self, param, exp_avg, exp_avg_sq, count):
        """Set a parameter's Adam moments and the update count (restoring a
        checkpoint); the count is also what Adam's bias correction reads."""
        self.opt.state[param] = dict(
            step=torch.tensor(float(count)),
            exp_avg=exp_avg.to(param.device, param.dtype).clone(),
            exp_avg_sq=exp_avg_sq.to(param.device, param.dtype).clone())
        self.count = int(count)
