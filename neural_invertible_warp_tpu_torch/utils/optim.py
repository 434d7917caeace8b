"""Per-label Adam with per-step learning-rate schedules (port of
neural_invertible_warp_tpu/utils/flat_optim.py with the ``make_optimizers``
schedules of models/system.py, barf.py and inn_warp.py).

One ``torch.optim.Adam`` holds a parameter group per label. Before update
number ``count`` (0 for the first) each group's lr is set to its schedule
at ``count``, as optax's ``scale_by_schedule`` does. Parameters labelled
``frozen`` are left out, so they never change.
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

    def __init__(self, groups, schedules):
        """groups: dict label -> list of parameters; schedules: dict label ->
        callable(count) -> lr. The label "frozen" is not optimized."""
        self.schedules = schedules
        self.labels = [k for k in groups if k != "frozen"]
        self.opt = torch.optim.Adam(
            [dict(params=list(groups[k]), label=k) for k in self.labels],
            lr=0.0, betas=(0.9, 0.999), eps=1e-8)
        self.count = 0

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self):
        for group in self.opt.param_groups:
            group["lr"] = self.schedules[group["label"]](self.count)
        self.opt.step()
        self.count += 1

    def moments(self, param):
        """(exp_avg, exp_avg_sq) of a parameter, zeros before its first update."""
        st = self.opt.state.get(param)
        if not st:
            return torch.zeros_like(param), torch.zeros_like(param)
        return st["exp_avg"], st["exp_avg_sq"]
