"""K6 held against the plain warp along a training run's own trajectory
(``probe_b3 --shadow-k6 EVERY``).

At a sampled step the run's current state and the batch of its next step
(the draws ``seed_step`` gives for that step; nothing of the state moves)
go through the INN warp three ways: K6 in fp32 (``fused_inn``, its plain
version on CPU tensors), the plain warp in fp32 (``DeformNetwork.forward``,
what the step runs with ``tpu.fused_inn`` off) and the plain warp in
float64 on the same device (the network and the latents cast to double).
Each leaf's distance from float64 is ``max|x - x64| / max|x64|``:

* ``grid_w``, ``center_w``: the warp's outputs;
* ``dgrid_w``, ``dcenter_w``: the cotangent at those outputs, the step's
  loss (the render, K2 on the card, and the global alignment) differentiated
  at each way's outputs, the float64 way's taken through the same fp32
  render at its outputs;
* every parameter of the warp network and ``warp_latent``: the gradients of
  one cotangent (the float64 way's) pulled back through each warp.

A leaf is a fault where K6 misses the plain fp32 warp by more than ``TOL``
of its max and lies more than ``FAULT_FACTOR`` times as far from float64 as
the plain warp does: the float64 rule of the port's kernel checks
(``chip_smoke.compare`` with ``TOL_SFM_K2_VS_F64``). ``over_factor`` lists
the leaves past the factor alone (two fp32 orders near rounding level part
by more than 1.5x on some leaf at some steps).

``validate_on_off`` reads the final state's held-out PSNR: twice as it is
(validation renders from the pose readout ``aux["global_rigid"]`` and does
not run the warp), then with the readout refitted on the next step's batch
through K6 and through the plain warp.

    python -m neural_invertible_warp_tpu_torch.evidence.shadow_k6 <record.jsonl>

prints a run's shadow as a table, one row per sampled step, each leaf's
largest distance over the steps, the six output biases' K6 / plain ratios
at every sampled step, how the K6 / plain ratios spread, and the pairs the
rule names (``rule_counts``: also read the other way round, where it flags
the plain warp lying 1.5x as far as K6).
"""

from __future__ import annotations

import copy
import json
import sys

import torch

from ..ops.cuda import fused_inn

FAULT_FACTOR = 1.5
TOL = 1e-5


def distance(x, x64):
    """max |x - x64| / max |x64| (0 where both are 0)."""
    x64 = x64.detach().double()
    err = float((x.detach().double() - x64).abs().max())
    scale = float(x64.abs().max())
    return err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))


def _loss_at(system, draws, warped):
    """The step's total loss with the warp's output replaced by ``warped``
    [B,2N,3] (the rest of ``_forward_train`` and ``compute_loss`` as the
    step runs them), and the extras."""
    ray_idx, depth_rand, noise_rand = draws
    system.warp_points = lambda pts, step: warped
    try:
        out, target, extras = system._forward_train(ray_idx, system.step, depth_rand,
                                                     noise_rand)
        losses = system.compute_loss(out, target, extras)
    finally:
        del system.warp_points
    return system.summarize_loss(losses), extras


def _coords(system, ray_idx):
    """The unwarped [grid; center] points of the step's rays [B,2N,3]."""
    from ..ops import rays
    center_cam, grid_cam = rays.get_unwarped_center_and_ray(
        system.train_data["intr"], ray_idx, system.W, pose_init=system._ray_frame())
    return torch.cat([grid_cam, center_cam], dim=1).detach()


def _warp(way, net, feat, coords, alpha):
    if way == "k6":
        return fused_inn.fused_deform_forward(net, feat, coords, alpha)
    return net(feat, coords, alpha)


def shadow_step(system):
    """The three ways at the system's current state and the batch of its next
    step. Returns dict(step, dist={leaf: {"k6": d, "plain": d}}, fault=[leaves
    where K6 misses the plain warp by TOL and lies FAULT_FACTOR x as far from
    float64], over_factor=[leaves past the factor alone])."""
    system.seed_step()
    draws = system.draw_step()
    coords = _coords(system, draws[0])
    n = coords.shape[1] // 2
    net = system.graph.warp_mlp
    alpha = system.alpha_ratio(system.step)
    net64 = copy.deepcopy(net).double()
    feat = system._warp_feat()
    feat64 = feat.detach().double().requires_grad_(True)
    with torch.no_grad():
        outs = {"k6": _warp("k6", net, feat, coords, alpha),
                "plain": _warp("plain", net, feat, coords, alpha),
                "f64": net64(feat64, coords.double(), alpha.double())}
    cots = {}
    for way, out in outs.items():
        leaf = out.float().detach().requires_grad_(True)
        total, _ = _loss_at(system, draws, leaf)
        cots[way], = torch.autograd.grad(total, [leaf])
    cot = cots["f64"]
    params = [p for _, p in net.named_parameters()]
    names = [name for name, _ in net.named_parameters()]
    grads = {}
    for way in ("k6", "plain"):
        with torch.enable_grad():
            out = _warp(way, net, feat, coords, alpha)
            grads[way] = torch.autograd.grad(out, params + [feat], cot,
                                             allow_unused=True)
    with torch.enable_grad():
        out64 = net64(feat64, coords.double(), alpha.double())
        grads["f64"] = torch.autograd.grad(out64, list(net64.parameters()) + [feat64],
                                           cot.double(), allow_unused=True)
    dist = {}

    def add(name, k6, plain, ref):
        dist[name] = {"k6": distance(k6, ref), "plain": distance(plain, ref),
                      "k6_plain": distance(k6, plain)}

    add("grid_w", outs["k6"][:, :n], outs["plain"][:, :n], outs["f64"][:, :n])
    add("center_w", outs["k6"][:, n:], outs["plain"][:, n:], outs["f64"][:, n:])
    add("dgrid_w", cots["k6"][:, :n], cots["plain"][:, :n], cot[:, :n])
    add("dcenter_w", cots["k6"][:, n:], cots["plain"][:, n:], cot[:, n:])
    for name, k6, plain, ref in zip(names + ["warp_latent"], grads["k6"],
                                    grads["plain"], grads["f64"]):
        if ref is None:      # a parameter the warp does not reach
            continue
        add("d" + name, k6, plain, ref)
    over = [name for name, d in dist.items() if d["k6"] > FAULT_FACTOR * d["plain"]]
    fault = [name for name in over if dist[name]["k6_plain"] > TOL]
    return dict(step=int(system.step), dist=dist, over_factor=over, fault=fault)


def summary_line(rec):
    """One line for a run's log: the step, the leaf where K6 is farthest
    from float64 against the plain warp, and the faults."""
    ratios = {k: (d["k6"] / d["plain"] if d["plain"] > 0 else float("inf") if d["k6"] > 0
                  else 1.0) for k, d in rec["dist"].items()}
    worst = max(ratios, key=ratios.get)
    return ("shadow_k6 step {}: outputs k6 {:.3e} plain {:.3e}; cotangent k6 {:.3e} "
            "plain {:.3e}; worst leaf {} k6 {:.3e} plain {:.3e} (x{:.2f}, k6-plain {:.1e}); "
            "past x{} {}; faults {}").format(
        rec["step"], rec["dist"]["grid_w"]["k6"], rec["dist"]["grid_w"]["plain"],
        rec["dist"]["dgrid_w"]["k6"], rec["dist"]["dgrid_w"]["plain"], worst,
        rec["dist"][worst]["k6"], rec["dist"][worst]["plain"], ratios[worst],
        rec["dist"][worst]["k6_plain"], FAULT_FACTOR, rec["over_factor"] or "none",
        rec["fault"] or "none")


def refit_readout(system, way):
    """Set ``aux["global_rigid"]`` to the Procrustes fit of the next step's
    batch warped by ``way`` ("k6" or "plain") at the current state."""
    system.seed_step()
    draws = system.draw_step()
    coords = _coords(system, draws[0])
    net = system.graph.warp_mlp
    with torch.no_grad():
        warped = _warp(way, net, system._warp_feat(), coords,
                       system.alpha_ratio(system.step))
        _, extras = _loss_at(system, draws, warped)
    system.aux["global_rigid"] = extras["svd_poses"]


def validate_on_off(system):
    """Held-out PSNR of the final state: twice as it is (``as_is``, the
    call's repeat noise), then with the readout refitted through K6
    (``k6``) and through the plain warp (``plain``). The readout is put back
    afterwards."""
    saved = system.aux["global_rigid"]
    out = {"as_is": [float(system.validate()["psnr_val"]) for _ in range(2)]}
    try:
        for way in ("k6", "plain"):
            refit_readout(system, way)
            out[way] = float(system.validate()["psnr_val"])
    finally:
        system.aux["global_rigid"] = saved
    return out


def _ratio(d):
    return d["k6"] / d["plain"] if d["plain"] > 0 else (float("inf") if d["k6"] > 0 else 1.0)


def table(record):
    """Markdown lines of a probe record's ``shadow_k6``: per sampled step the
    outputs' and the cotangent's distances (K6 / plain), the largest over the
    parameter and latent leaves of each way, the leaf of the largest K6 /
    plain ratio, the leaves past the factor and the faults; then per leaf its
    largest distance of each way over the steps."""
    lines = ["| step | grid_w k6 / plain | dgrid_w k6 / plain | leaves max k6 / plain | "
             "largest ratio (leaf) | past x{} | faults |".format(FAULT_FACTOR),
             "|---|---|---|---|---|---|---|"]
    for rec in record["shadow_k6"]:
        dist = rec["dist"]
        grads = {k: d for k, d in dist.items() if k.startswith("d") and k not in (
            "dgrid_w", "dcenter_w")}
        worst = max(grads, key=lambda k: _ratio(grads[k]))
        lines.append("| {} | {:.3e} / {:.3e} | {:.3e} / {:.3e} | {:.3e} / {:.3e} | {:.2f} ({}) "
                     "| {} | {} |".format(
                         rec["step"], dist["grid_w"]["k6"], dist["grid_w"]["plain"],
                         dist["dgrid_w"]["k6"], dist["dgrid_w"]["plain"],
                         max(d["k6"] for d in grads.values()),
                         max(d["plain"] for d in grads.values()), _ratio(grads[worst]),
                         worst, len(rec["over_factor"]), ", ".join(rec["fault"]) or "none"))
    leaves = list(record["shadow_k6"][-1]["dist"])
    lines += ["", "| leaf | max k6 | max plain | max k6 / plain | steps past x{} |".format(
        FAULT_FACTOR), "|---|---|---|---|---|"]
    for leaf in leaves:
        ds = [r["dist"][leaf] for r in record["shadow_k6"] if leaf in r["dist"]]
        lines.append("| {} | {:.3e} | {:.3e} | {:.2f} | {} |".format(
            leaf, max(d["k6"] for d in ds), max(d["plain"] for d in ds),
            max(_ratio(d) for d in ds),
            sum(leaf in r["over_factor"] for r in record["shadow_k6"])))
    return lines


BIASES = ["dlin{}_{}_1.bias".format(b, br) for b in range(3) for br in "ab"]


def bias_table(record):
    """Markdown lines: per sampled step the K6 / plain ratio of the six
    output-bias leaves, and the leaves where either way lies past
    FAULT_FACTOR times the other's distance and misses it by TOL (the rule,
    and the rule read the other way round)."""
    lines = ["| step | " + " | ".join(b[1:-5] for b in BIASES) + " | rule: k6 / plain |",
             "|---" * (len(BIASES) + 2) + "|"]
    for rec in record["shadow_k6"]:
        dist = rec["dist"]
        plain_past = [b for b in BIASES if dist[b]["plain"] > FAULT_FACTOR * dist[b]["k6"]
                      and dist[b]["k6_plain"] > TOL]
        k6_past = [b for b in BIASES if b in rec["fault"]]
        lines.append("| {} | {} | {} / {} |".format(
            rec["step"], " | ".join("{:.2f}".format(_ratio(dist[b])) for b in BIASES),
            ", ".join(b[1:-5] for b in k6_past) or "-",
            ", ".join(b[1:-5] for b in plain_past) or "-"))
    return lines


def rule_counts(record):
    """Over every (leaf, sampled step): how many, the pairs where the rule
    names K6 (``fault``), and those where the same rule names the plain warp
    (it lies FAULT_FACTOR times as far from float64 as K6 and misses it by
    TOL)."""
    pairs = [(r["step"], leaf, d) for r in record["shadow_k6"] for leaf, d in r["dist"].items()]
    return dict(pairs=len(pairs),
                k6=[(s, leaf) for s, leaf, d in pairs
                    if d["k6"] > FAULT_FACTOR * d["plain"] and d["k6_plain"] > TOL],
                plain=[(s, leaf) for s, leaf, d in pairs
                       if d["plain"] > FAULT_FACTOR * d["k6"] and d["k6_plain"] > TOL])


def symmetry(record):
    """Over every (leaf, sampled step) after step 0 where the plain warp's
    distance is not 0: how many, the median K6 / plain ratio, the share
    where K6 lies nearer float64, and the shares past FAULT_FACTOR each way
    (K6 past the plain warp, the plain warp past K6)."""
    ratios = sorted(_ratio(d) for r in record["shadow_k6"][1:] for d in r["dist"].values()
                    if d["plain"] > 0)
    n = len(ratios)
    return dict(n=n, median=ratios[n // 2] if n % 2 else 0.5 * (ratios[n // 2 - 1]
                                                                 + ratios[n // 2]),
                k6_nearer=sum(x < 1 for x in ratios) / n,
                k6_past=sum(x > FAULT_FACTOR for x in ratios) / n,
                plain_past=sum(x < 1 / FAULT_FACTOR for x in ratios) / n)


def main(argv=None):
    path, = sys.argv[1:] if argv is None else argv
    with open(path) as f:
        record = json.loads(f.read().splitlines()[-1])
    print("\n".join(table(record)))
    print("\n".join(bias_table(record)))
    print("symmetry: {}".format(symmetry(record)))
    print("rule: {}".format(rule_counts(record)))
    print("faults: {}; validate_k6: {}".format(record["shadow_k6_faults"],
                                              record["validate_k6"]))


if __name__ == "__main__":
    main()
