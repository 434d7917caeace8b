"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each:
  1. environment: torch, CUDA and the card (nvidia-smi name, power limit);
  2. build: nvcc compiles the port's CUDA kernels from csrc/ into build/;
  3. kernels: each kernel, through the wrapper the slice calls (for K2 with
     the render loss backpropagated through its autograd Function; for K4
     with a loss that weighs rgb, depth and opacity, backpropagated through
     the forward render's autograd Function, with and without weight
     gradients), against its plain PyTorch version on the card at the
     flagship shapes, with all PE bands open, and at a ragged ray count with
     a background colour; values and every gradient within the tolerances
     below; the training loss and gradients through K3 + K4 against K2's;
     kernel and plain timed with CUDA events (median of 20 runs after 3
     warm-up runs), beside the least time the card could take;
  4. slice: the flagship model (barf_inn_llff at full width) trains 100
     steps through the port's Trainer on an in-memory synthetic scene, then
     renders the validation view and writes a checkpoint. Checks that every
     step went through the kernels, that the loss is finite and falls, that
     the pose readout is a rotation, that the validation image equals the
     plain render of the same chunks, and that a training view rendered at
     its pose readout reaches a PSNR floor;
  5. evaluation: evaluate_full on the trained system, with test-time pose
     refinement (100 Adam steps through K3 and K4) and the full-image render
     of the validation view, PSNR, SSIM (held against the CPU's), LPIPS
     (unavailable without weights), quant.txt and quant_pose.txt; then a
     training view turned by a known rotation is refined back: its rotation
     error must fall and its PSNR rise;
  6. field kernels: the per-sample field kernels K5 (PE inside) and K1 (PE
     in PyTorch), forward and forward + backward through the wrappers the
     fine-sampling tiers call, with the compositing in PyTorch under
     autograd, against the plain chain at [1,1024] rays x 64 and x 192
     samples (softplus and relu density, with and without density noise, a
     ragged ray count); K1's dxp and dview directly; K2 with its noise
     operand and its compositing-weights output at both sample counts;
  7. fine slice: vanilla NeRF with fine sampling (nerf_llff_repr at full
     width: two 8x256 fields, 64 + 128 samples, 1024 rays, relu density,
     density noise) trains through the Trainer (two K2 calls per step),
     renders the validation view (two K5 calls per chunk) and holds it
     against the plain render of the same chunks and samples, takes a few
     steps each in the fallback tier (K5 forward + backward, K2) and the
     MLP-only tier (K1 forward + backward), and evaluates one view;
  8. inn kernel: the fused INN warp K6, forward and backward through the
     wrapper under autograd, against its plain version and against the plain
     chain (DeformNetwork.forward) on the card, every leaf perturbed, at the
     flagship's warp shape [18,226,3] x 128 latent dims and at a ragged, a
     narrow-latent and a 4096-point shape, under the loss sum(sin(3 out))
     and again under sum(out); two backward runs must give the same bits;
     kernel, plain version and chain timed side by side;
  9. kernel_k7: K7 (PDC-Net's 9x9 local correlation) and its adjoints in f1
     and in f2 through the wrappers against their plain versions on the card,
     at the calls of a 480x640 pair ([1,128,120,160], [1,256,60,80],
     [1,256,32,32]), of a DTU 300x400 pair ([1,128,74,100], [1,256,37,50])
     and at a ragged shape with B = 2; the zero-displacement channel of
     identical maps against their mean of squares; the autograd Function's
     gradients against the adjoint kernels; kernel, plain version and the
     unfold + einsum route timed as CUDA graph replays, beside the bound;
 10. fused-warp slice: the flagship again with ``tpu.fused_inn: true``, 100
     steps through the Trainer: K6 forward, K6 backward and K2 once per step
     each, step-0 losses equal to the fused-off run's of phase 4, the loss
     falls, the pose readout is a rotation, a training view at its pose
     readout reaches the PSNR floor; ms/step beside phase 4's;
 11. pose_init_pdcnet: PDC-Net at its published widths (random weights from
     a seed) through PdcNetMatcher over the pose-nearest pairs of 6 views at
     480x640 and one 300x400 pair: 24 K7 and 9 adjoint launches per pair;
     flow and P_R finite, P_R in [0, 1]; the whole matcher against the same
     module with K7's plain versions; keypoint counts both ways; ms per pair.
Then a JSON line of kernel results, the card line, and the result line
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
then non-zero and no result line is printed. Without a CUDA device it exits
with code 2 before doing anything.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N_STEPS = 100
IMAGE_HW = (480, 640)
N_TRAIN, N_VAL = 18, 1
K = 128
C2F = (0.1, 0.5)
# max |kernel - plain| / max |plain| per compared tensor. Values, sq_sum
# and the weight gradients read <= 1e-6 on an H100 (PERF.md, Findings).
TOL = {"value": 1e-5, "grad": 1e-5}
# dcenter/dray once PE bands 5-9 are open: samples reach depth 1e6, where the
# 2^9*pi band and the depth factor make these sums ill-conditioned in fp32.
# On an H100 the plain version on the card and on the host (another fp32
# summation order) differ there by 6e-3 of the max, and both differ from a
# float64 evaluation by 1e-2; the kernel reads <= 1e-4 against the plain
# version. TF32 anywhere in the MLP would show in the values at 1e-5.
TOL_INPUT_GRAD_ALL_BANDS = 5e-4
# kernel-vs-plain cases: (name, images, rays per image, progress, setbg_opaque
# [, tolerance of dcenter/dray]). At progress 0.3 the c2f schedule closes PE
# bands 5-9; at 1.0 all ten are open.
K2_CASES = [("flagship", N_TRAIN, 113, 0.3, False, 1e-5),
            ("all bands", N_TRAIN, 113, 1.0, False, TOL_INPUT_GRAD_ALL_BANDS),
            ("ragged, bg", 1, 37, 1.0, True, TOL_INPUT_GRAD_ALL_BANDS)]
K3_CASES = [("eval chunk", 1, 2048, 0.3, False),
            ("eval chunk, all bands", 1, 2048, 1.0, False),
            ("ragged, bg", 1, 37, 1.0, True)]
# K4 through the forward wrapper under autograd: (name, images, rays per
# image, progress, setbg_opaque, tolerance of dcenter/dray)
K4_CASES = [("eval chunk", 1, 2048, 0.3, False, 1e-5),
            ("eval chunk, all bands", 1, 2048, 1.0, False, TOL_INPUT_GRAD_ALL_BANDS),
            ("ragged, bg", 1, 37, 1.0, True, TOL_INPUT_GRAD_ALL_BANDS)]
# K4's weight gradients under its test loss: the per-ray coefficients have
# random signs, so each weight gradient is a sum over 262,144 samples that
# largely cancels, and two fp32 summation orders differ by more than under
# K2's squared error. On an H100 the kernel reads up to 1.1e-5 of the max
# against the plain version, and each of the two is as far or farther from a
# float64 evaluation of the same sums (printed beside the comparison).
TOL_K4_WEIGHT_GRAD = 5e-5
# scale of the per-ray depth coefficient in K4's test loss: sample depths run
# from 1 to 256 (one in a few hundred rays up to 1e6), so at 0.01 the depth
# term weighs about as much as the rgb and opacity terms (coefficients ~1)
K4_DEPTH_COEFF = 0.01
# multiply-adds of the field for one sample, forward: layers 0-7 of the
# trunk (skip at 4, 257 outputs at 7) and the 284 -> 128 -> 3 head
MACS_PER_SAMPLE = (63 * 256 + 3 * 256 * 256 + 319 * 256 + 2 * 256 * 256
                   + 256 * 257 + 284 * 128 + 128 * 3)
# H100 SXM data sheet at 700 W: fp32 outside the tensor cores, device memory
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# test-time refinement of training view 0 turned by this rotation (rad, about
# an axis in the image plane): against the field's own render the rotation
# error must fall below MAX_REFINED_ROTATION_SHARE of it, and against either
# target the PSNR must rise by MIN_REFINED_PSNR_GAIN dB. On an H100 the
# rotation error reads 0.0100 -> 0.0033 rad and the PSNR 40.1 -> 69.1 dB
# against the own render, 36.2 -> 39.0 dB against the pixels (PERF.md).
PERTURB_ROTATION = (0.006, -0.008, 0.0)
MAX_REFINED_ROTATION_SHARE = 0.5
MIN_REFINED_PSNR_GAIN = 1.0
# PSNR floor of a training view rendered at its pose readout after the slice
# (reads 36.3 dB on an H100; PERF.md, Findings)
MIN_TRAIN_VIEW_PSNR = 30.0


# The fine-sampling slice (nerf_llff_repr): views, steps per tier, and the
# kernel-vs-plain cases of its field kernels. Depths lie in [0, 1], so the
# PE's arguments stay small and dcenter/dray are well conditioned: every
# softplus case is held to 1e-5 of the max, except dcenter/dray under the
# signed test loss of the K5/K1 cases: all ten PE bands are open (the nerf
# configs have no c2f), so the 2^9*pi band multiplies every rounding
# difference of the points, and the random signs make the per-ray sums
# cancel; they read up to 1.7e-5 on an H100 and are held to 5e-5, as K4's
# weight gradients are under the same loss. With relu density, and above
# all with density noise (which puts many pre-activations near 0), a sample
# whose pre-activation rounds to the other side of 0 in one of the two fp32
# evaluations changes its gradient by a finite amount, so element-wise
# bounds mean nothing there: each gradient leaf is held to a relative L2
# error below 1e-2, as the JAX package's own kernel tests hold it.
FINE_N_TRAIN = 16
FINE_STEPS = 60
FINE_TIER_STEPS = 5
FINE_K = (64, 192)
FINE_RAYS = 1024
TOL_RELU_REL_L2 = 1e-2
TOL_FIELD_INPUT_GRAD = 5e-5
NOISE_REG = 1.0
# (name, rays, samples, density activation, density noise)
K5_CASES = [("{} {}{}".format(K_, activ, ", noise" if noise else ""), FINE_RAYS, K_,
             activ, noise)
            for K_ in FINE_K for activ in ("softplus", "relu") for noise in (False, True)
            ] + [("ragged relu, noise", 37, 64, "relu", True)]
K1_CASES = K5_CASES
K2_NOISE_CASES = [("{} {}, noise, prob".format(K_, activ), FINE_RAYS, K_, activ, True)
                  for K_ in FINE_K for activ in ("softplus", "relu")]


# The fused INN warp (K6): (name, images, points per image, latent width,
# alphas). The flagship warps [grid; center] of 113 rays per image: 226
# points. Every leaf of the network is perturbed by INN_PERTURB * randn (at
# init the output layers are zero and the warp is the identity), as the JAX
# package's kernel test does. Values are held to 1e-5 of the max. Gradients
# of sum(sin(3 out)) are held per leaf to 2e-4 (twice that test's gate: on the
# CPU the JAX package's own kernel and chain differ by 1.4e-4 in such cases),
# as |got - ref|_2 over |ref|_2 for every leaf but the six output biases
# ``lin{b}_{a,b}_1.bias``. Such a bias gradient is the plain sum over all points
# of that output's cotangent, whose terms largely cancel; with every PE column
# of the first layers perturbed, the 2^5 pi band multiplies a rounding
# difference of a coordinate by 100 per block, so every fp32 evaluation is
# far from a float64 one on these leaves (2e-4 at the flagship shape, 1e-2 at
# 4096 points on an H100). They are held to the same 2e-4 with the sum of the
# |terms| of their reduction as the denominator (taken from a float64
# evaluation of the chain on the card): a summation's error scales with that,
# not with the cancelled sum. That denominator would let an error in
# proportion to the cancelled sum pass, so every case is differentiated a
# second time under the loss sum(out), whose cotangent is all ones: there the
# terms of these six sums do not cancel, and all leaves are held to 2e-4 of
# their own norm.
INN_CASES = [("flagship", N_TRAIN, 226, 128, (0.0, 0.37, 1.0)),
             ("ragged", 1, 7, 128, (0.5,)),
             ("d_feat 16", N_TRAIN, 226, 16, (0.5,)),
             ("4096 points", 1, 4096, 128, (0.5,))]
INN_PERTURB = 0.05
TOL_INN_GRAD_REL_L2 = 2e-4
# multiply-adds of the warp per point, forward: three blocks of a 26- and a
# 13-column embedding into 128 units and their 1 + 3 outputs; and per image
# the latent rows of the six first layers
INN_MACS_PER_POINT = 3 * (26 + 13 + 1 + 3) * 128
INN_MACS_PER_IMAGE_AND_LATENT_DIM = 3 * 2 * 128
# losses of the fused-warp slice against the fused-off slice's (same seed,
# same draws), as relative differences: at step 0, where the warp is the
# identity on both routes; and at step 1, after one Adam update from K6's
# gradients, whose first step moves every entry by about lr * sign(g)
TOL_FUSED_STEP0 = 1e-5
TOL_FUSED_STEP1 = 1e-2


# K7, PDC-Net's 9x9 local correlation, and its adjoints: (name, B, C, H, W).
# A 480x640 pair gives the H-Net's VGG levels at 1/4 (128 channels) and 1/8
# (256) and the L-Net's 32x32 (256); a DTU 300x400 pair 74x100 and 37x50. Each
# output is held to 1e-5 of its max against the plain version (fp32 sums of
# C products in another order read ~1e-7).
K7_CASES = [("480x640, 1/4", 1, 128, 120, 160), ("480x640, 1/8", 1, 256, 60, 80),
            ("256x256 net, 32x32", 1, 256, 32, 32), ("300x400, 1/4", 1, 128, 74, 100),
            ("300x400, 1/8", 1, 256, 37, 50), ("ragged", 2, 40, 13, 45)]
TOL_K7 = 1e-5
# The pose-init path: PdcNetMatcher over the pose-nearest pairs of 6 views at
# 480x640 (2 neighbours each) and one DTU-sized pair. Per pair, each of the
# three local levels runs the local GOCor (3 iterations x 2 correlations + 1
# adjoint, then 1 correlation with the query) and one plain local
# correlation: 8 K7 and 3 adjoint launches per level. The whole matcher is
# held against the same module with K7's plain versions: flow to 5e-4 of its
# max, P_R to 2e-3 absolute; keypoints may differ only where P_R lies within
# the pair's P_R difference of min_confidence. Not 1e-4: GOCor's descent
# direction takes sign(score) (the derivative of its leaky-relu objective),
# so a score that rounds to the other side of 0 in one of two fp32
# evaluations moves that filter by a finite step; on an H100 the two routes
# read up to 1.1e-4 (flow) and 7.2e-4 (P_R) apart, and each is as far from a
# float64 evaluation (printed for two pairs).
PDCNET_VIEWS, PDCNET_NEIGHBOURS = 6, 2
PDCNET_DTU_HW = (300, 400)
PDCNET_MIN_CONFIDENCE = 0.1
K7_FWD_PER_PAIR, K7_ADJ_PER_PAIR = 3 * 8, 3 * 3
TOL_PDCNET_FLOW = 5e-4
TOL_PDCNET_PR = 2e-3


def check(ok, msg):
    """Raise (under -O too, unlike assert) when a smoke check fails."""
    if not ok:
        raise AssertionError(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, warmup=3, runs=20):
    """Median device time of fn() in ms, by CUDA events around each run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def graph_ms(fn):
    """Device time of fn()'s launch sequence alone: captured into a CUDA
    graph after a warm-up call and replayed (median of 20 after 3), so that
    no host time lies between or before its kernels."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outputs = fn()      # kept alive while the graph replays
    ms = time_ms(graph.replay)
    del graph, outputs
    return ms


def compare(name, got, ref, tol, failures):
    """Print max |got - ref| against tol * max |ref|; a miss is added to
    ``failures`` (checked once the phase has printed all its lines)."""
    got, ref = got.detach().float(), ref.detach().float()
    check(got.shape == ref.shape, "{}: shape {} != {}".format(name, got.shape, ref.shape))
    check(bool(torch.isfinite(got).all()), "{}: kernel output is not finite".format(name))
    err = float((got - ref).abs().max())
    scale = max(float(ref.abs().max()), 1e-30)
    ok = err <= tol * scale
    print("  {:<14} max_abs_err {:.3e}  rel_to_max {:.3e}  tol {:.0e}  {}".format(
        name, err, err / scale, tol, "ok" if ok else "FAIL"))
    if not ok:
        failures.append(name)
    return err


def bound(flops, tensors_in, tensors_out):
    """(bound_ms, bound_by): the least time the card could take for `flops`
    fp32 operations and for reading each input and writing each output once."""
    n_bytes = sum(t.numel() * t.element_size() for t in tensors_in + tensors_out)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def ray_batch(B, R, seed, device):
    """Forward-facing rays [B,R,3], inverse-depth stratified samples
    [B,R,K,1] over the flagship's depth range, and targets [B,R,3]."""
    from neural_invertible_warp_tpu_torch.ops import sampling
    g = torch.Generator(device="cpu").manual_seed(seed)
    center = torch.randn(B, R, 3, generator=g) * 0.05
    xy = (torch.rand(B, R, 2, generator=g) - 0.5) * 1.2
    ray = torch.cat([xy, torch.ones(B, R, 1)], dim=-1)
    depth = sampling.sample_depth(B, R, K, (1.0, 0.0), param="inverse", generator=g)
    target = torch.rand(B, R, 3, generator=g)
    return [t.to(device) for t in (center, ray, depth, target)]


def k2_wrapper(mlp, center, ray, depth, target, kw, weight):
    """The slice's K2 call: the wrapper, then the render loss scaled as the
    system scales it (``weight`` * sq_sum / n), backpropagated through the
    wrapper's autograd Function."""
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    c = center.clone().requires_grad_(True)
    r = ray.clone().requires_grad_(True)
    out, sq, n = fp.fused_render_rays_pe_train(mlp, c, r, depth, target, **kw)
    grads = torch.autograd.grad(weight * sq / n, [c, r] + list(mlp.parameters()))
    return sq.detach(), out, grads


def k2_plain(mlp, center, ray, depth, target, kw, weight):
    """The same loss through the plain version on flat [B*R] rays."""
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    B, R = depth.shape[:2]
    c = center.clone().requires_grad_(True)
    r = ray.clone().requires_grad_(True)
    t = target.reshape(B * R, 3)
    target8 = torch.cat([t, torch.ones(B * R, 1, device=t.device),
                         torch.zeros(B * R, 4, device=t.device)], dim=1)
    bg = float(kw["bgcolor"]) if kw["setbg_opaque"] else None
    sq, out8 = fp.render_rays_train_plain(
        mlp, c.reshape(B * R, 3), r.reshape(B * R, 3), depth.reshape(B * R, K),
        target8, kw["progress"], kw["barf_c2f"], bg)
    grads = torch.autograd.grad(weight * sq / (B * R * 3),
                                [c, r] + list(mlp.parameters()))
    return sq.detach(), split_plain(out8, B, R, bg), grads


def split_plain(out8, B, R, bg):
    """[B*R,8] plain render -> dict(rgb [B,R,3], depth, opacity [B,R,1])."""
    rgb, depth, opacity = out8[:, :3], out8[:, 3:4], out8[:, 4:5]
    if bg is not None:
        rgb = rgb + bg * (1.0 - opacity)
    return dict(rgb=rgb.reshape(B, R, 3), depth=depth.reshape(B, R, 1),
                opacity=opacity.reshape(B, R, 1))


def k4_coefficients(B, R, seed, device):
    """Per-ray coefficients (a [B,R,3], b, c [B,R,1]) of K4's test loss
    sum(a rgb + b depth + c opacity)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn(B, R, 3, generator=g)
    b = torch.randn(B, R, 1, generator=g) * K4_DEPTH_COEFF
    c = torch.randn(B, R, 1, generator=g)
    return [t.to(device) for t in (a, b, c)]


def k4_loss(rgb, depth, opacity, coeffs):
    a, b, c = coeffs
    return (a * rgb).sum() + (b * depth).sum() + (c * opacity).sum()


class frozen_weights:
    """Within the block, no parameter of ``mlp`` requires a gradient."""

    def __init__(self, mlp, frozen=True):
        self.params = list(mlp.parameters()) if frozen else []

    def __enter__(self):
        for p in self.params:
            p.requires_grad_(False)

    def __exit__(self, *exc):
        for p in self.params:
            p.requires_grad_(True)


def k4_render(mlp, center, ray, depth, kw, plain):
    """(c, r, (rgb, depth, opacity)) with c, r requiring a gradient: through
    the forward wrapper (K3 keeping its activations), or the plain chain."""
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    B, R = depth.shape[:2]
    c = center.clone().requires_grad_(True)
    r = ray.clone().requires_grad_(True)
    if not plain:
        return c, r, fp.fused_render_rays_pe(mlp, c, r, depth, **kw)
    out8 = fp.render_rays_plain(mlp, c.reshape(B * R, 3), r.reshape(B * R, 3),
                                depth.reshape(B * R, K), kw["progress"], kw["barf_c2f"])
    out = split_plain(out8, B, R, float(kw["bgcolor"]) if kw["setbg_opaque"] else None)
    return c, r, (out["rgb"], out["depth"], out["opacity"])


def k4_grads(mlp, center, ray, depth, coeffs, kw, frozen=False, plain=False):
    """(loss, [dcenter, dray] + weight gradients unless frozen) of K4's test
    loss: forward and backward."""
    with frozen_weights(mlp, frozen):
        c, r, out = k4_render(mlp, center, ray, depth, kw, plain)
        loss = k4_loss(*out, coeffs)
        grads = torch.autograd.grad(
            loss, [c, r] + ([] if frozen else list(mlp.parameters())))
    return loss.detach(), grads


def k4_weight_grads_f64(mlp, center, ray, depth, coeffs, kw):
    """Weight gradients of K4's test loss with everything after the PE in
    float64. The points, the unit rays and the PE's sin/cos are taken in fp32,
    as the kernel and the plain version take them: at depths up to 1e6 the
    PE's arguments differ between fp32 and float64 by whole periods."""
    import copy
    from neural_invertible_warp_tpu_torch.ops import nerf_mlp, render
    B, R = depth.shape[:2]
    mlp64 = copy.deepcopy(mlp).double()
    pe32 = nerf_mlp.positional_encoding_c2f

    def pe_fp32(x, *args):
        return pe32(x.float(), *args).double()

    points = center[..., None, :] + ray[..., None, :] * depth
    ray_unit = ray / torch.clamp(torch.linalg.norm(ray, dim=-1, keepdim=True), min=1e-12)
    nerf_mlp.positional_encoding_c2f = pe_fp32
    try:
        rgb_s, dens = mlp64(points.double(), ray_unit[..., None, :].expand(points.shape).double(),
                            progress=kw["progress"], barf_c2f=kw["barf_c2f"])
    finally:
        nerf_mlp.positional_encoding_c2f = pe32
    rgb, d, op, _ = render.composite(ray.double(), rgb_s, dens, depth.double())
    if kw["setbg_opaque"]:
        rgb = rgb + kw["bgcolor"] * (1 - op)
    loss = k4_loss(rgb, d, op, [t.double() for t in coeffs])
    return torch.autograd.grad(loss, list(mlp64.parameters()))


def k4_backward_ms(mlp, center, ray, depth, coeffs, kw, frozen, plain):
    """Time of the backward alone: one forward, then the same graph
    differentiated again and again."""
    with frozen_weights(mlp, frozen):
        c, r, out = k4_render(mlp, center, ray, depth, kw, plain)
        loss = k4_loss(*out, coeffs)
        wrt = [c, r] + ([] if frozen else list(mlp.parameters()))
        return time_ms(lambda: torch.autograd.grad(loss, wrt, retain_graph=True))


def route_k3_k4(mlp, center, ray, depth, target, kw, weight):
    """The training render loss as ``tpu.fused_train: false`` computes it:
    K3 forward, mean squared error outside, K4 backward."""
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    c = center.clone().requires_grad_(True)
    r = ray.clone().requires_grad_(True)
    rgb, _, _ = fp.fused_render_rays_pe(mlp, c, r, depth, **kw)
    loss = weight * torch.mean((rgb - target) ** 2)
    return loss.detach(), torch.autograd.grad(loss, [c, r] + list(mlp.parameters()))


def phase_kernels(mlp, device):
    """K2, K3 and K4, through the wrappers the slice calls, against their
    plain versions. Returns the JSON records."""
    from neural_invertible_warp_tpu_torch.flagship import flagship_options
    from neural_invertible_warp_tpu_torch.ops.cuda import build
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    # summarize_loss's 10^w on the render loss
    weight = 10.0 ** float(flagship_options().loss_weight.render)
    names = ["d" + n.replace("mlp_", "") for n, _ in mlp.named_parameters()]
    failures = []
    records = {"k2": dict(max_abs_err=0.0), "k3": dict(max_abs_err=0.0),
               "k4": dict(max_abs_err=0.0)}
    weights = fp.pack_weights(mlp)
    for i, (case, B, R, progress, bg, tol_in) in enumerate(K2_CASES):
        kw = dict(progress=progress, barf_c2f=C2F, setbg_opaque=bg,
                  bgcolor=1.0 if bg else None)
        inputs = ray_batch(B, R, seed=10 + i, device=device)
        print("kernels: K2 train wrapper, {}: [{},{}] rays x {} samples, c2f {} at "
              "progress {}, setbg_opaque {}".format(case, B, R, K, C2F, progress, bg))
        sq, out, grads = k2_wrapper(mlp, *inputs, kw, weight)
        sq_ref, out_ref, grads_ref = k2_plain(mlp, *inputs, kw, weight)
        for key in ("rgb", "depth", "opacity"):
            err = compare(key, out[key], out_ref[key], TOL["value"], failures)
            if key == "rgb":
                records["k2"]["max_abs_err"] = max(records["k2"]["max_abs_err"], err)
        compare("sq_sum", sq, sq_ref, TOL["value"], failures)
        for name, gk, gr in zip(["dcenter", "dray"] + names, grads, grads_ref):
            compare(name, gk, gr, tol_in if name in ("dcenter", "dray") else TOL["grad"],
                    failures)
        if i == 0:
            records["k2"]["ms"] = time_ms(lambda: k2_wrapper(mlp, *inputs, kw, weight))
            records["k2"]["plain_ms"] = time_ms(
                lambda: k2_plain(mlp, *inputs, kw, weight))
            # forward, input-gradient and weight-gradient products
            records["k2"]["bound_ms"], records["k2"]["bound_by"] = bound(
                3 * 2 * MACS_PER_SAMPLE * B * R * K, inputs + weights,
                [out["rgb"], out["depth"], out["opacity"]] + list(grads))
            # the same loss through K3 + K4 (the tpu.fused_train: false route)
            print("kernels: K3 + K4 route against K2 at [{},{}] rays x {} samples".format(
                B, R, K))
            loss_k2 = weight * sq / (B * R * 3)
            loss_34, grads_34 = route_k3_k4(mlp, *inputs, kw, weight)
            compare("loss", loss_34, loss_k2, TOL["value"], failures)
            for name, g34, g2 in zip(["dcenter", "dray"] + names, grads_34, grads):
                compare(name, g34, g2, tol_in if name in ("dcenter", "dray")
                        else TOL["grad"], failures)
            records["k4"]["route_ms"] = time_ms(
                lambda: route_k3_k4(mlp, *inputs, kw, weight))
    for i, (case, B, R, progress, bg) in enumerate(K3_CASES):
        kw = dict(progress=progress, barf_c2f=C2F, setbg_opaque=bg,
                  bgcolor=1.0 if bg else None)
        center, ray, depth, _ = ray_batch(B, R, seed=20 + i, device=device)
        print("kernels: K3 forward wrapper, {}: [{},{}] rays x {} samples, c2f {} at "
              "progress {}, setbg_opaque {}".format(case, B, R, K, C2F, progress, bg))

        def k3():
            return fp.fused_render_rays_pe(mlp, center, ray, depth, **kw)

        def k3_plain():
            out8 = fp.render_rays_plain(mlp, center.reshape(B * R, 3),
                                        ray.reshape(B * R, 3),
                                        depth.reshape(B * R, K), progress, C2F)
            return split_plain(out8, B, R, kw["bgcolor"])
        with torch.no_grad():
            got, ref = k3(), k3_plain()
            for key, g, r in zip(("rgb", "depth", "opacity"), got, ref.values()):
                err = compare(key, g, r, TOL["value"], failures)
                if key == "rgb":
                    records["k3"]["max_abs_err"] = max(records["k3"]["max_abs_err"], err)
            if i == 0:
                records["k3"]["ms"] = time_ms(k3)
                records["k3"]["plain_ms"] = time_ms(k3_plain)
                records["k3"]["bound_ms"], records["k3"]["bound_by"] = bound(
                    2 * MACS_PER_SAMPLE * B * R * K, [center, ray, depth] + weights,
                    list(got))
    for i, (case, B, R, progress, bg, tol_in) in enumerate(K4_CASES):
        kw = dict(progress=progress, barf_c2f=C2F, setbg_opaque=bg,
                  bgcolor=1.0 if bg else None)
        center, ray, depth, _ = ray_batch(B, R, seed=30 + i, device=device)
        coeffs = k4_coefficients(B, R, seed=40 + i, device=device)
        args = (mlp, center, ray, depth, coeffs, kw)
        print("kernels: K4 backward through the forward wrapper, {}: [{},{}] rays x {} "
              "samples, c2f {} at progress {}, setbg_opaque {}".format(
                  case, B, R, K, C2F, progress, bg))
        loss, grads = k4_grads(*args)
        loss_ref, grads_ref = k4_grads(*args, plain=True)
        compare("loss", loss, loss_ref, TOL["value"], failures)
        for name, gk, gr in zip(["dcenter", "dray"] + names, grads, grads_ref):
            err = compare(name, gk, gr, tol_in if name in ("dcenter", "dray")
                          else TOL_K4_WEIGHT_GRAD, failures)
            if i == 0 and name in ("dcenter", "dray"):
                records["k4"]["max_abs_err"] = max(records["k4"]["max_abs_err"], err)
        if i == 0:
            worst = {"kernel": 0.0, "plain": 0.0}
            for g64, gk, gr in zip(k4_weight_grads_f64(*args[:6]), grads[2:], grads_ref[2:]):
                scale = float(g64.abs().max())
                worst["kernel"] = max(worst["kernel"], float((gk - g64).abs().max()) / scale)
                worst["plain"] = max(worst["plain"], float((gr - g64).abs().max()) / scale)
            print("  weight gradients against float64 (fp32 PE), largest error over the "
                  "20 leaves as a share of the leaf's max: kernel {:.3e}, plain {:.3e}".format(
                      worst["kernel"], worst["plain"]))
        print("  weights frozen (no weight gradients):")
        _, grads_frozen = k4_grads(*args, frozen=True)
        for name, gk, gr in zip(["dcenter", "dray"], grads_frozen, grads_ref):
            compare(name, gk, gr, tol_in, failures)
        if i == 0:
            # K4 as test-time refinement launches it: weights frozen
            rec = records["k4"]
            rec["ms"] = k4_backward_ms(*args, frozen=True, plain=False)
            rec["plain_ms"] = k4_backward_ms(*args, frozen=True, plain=True)
            rec["ms_with_dw"] = k4_backward_ms(*args, frozen=False, plain=False)
            rec["plain_ms_with_dw"] = k4_backward_ms(*args, frozen=False, plain=True)
            rec["k3_k4_ms"] = time_ms(lambda: k4_grads(*args, frozen=True))
            rec["k3_k4_plain_ms"] = time_ms(lambda: k4_grads(*args, frozen=True, plain=True))
            rec["k3_k4_ms_with_dw"] = time_ms(lambda: k4_grads(*args))
            rec["k3_k4_plain_ms_with_dw"] = time_ms(lambda: k4_grads(*args, plain=True))
            # K4 reads the rays, the cotangent, the weights and the kept
            # activations, and does the input-gradient products (and the
            # weight-gradient products when a weight needs them)
            n_samples = B * R * K
            cache = torch.empty(build.load_library().lib.niw_rm_fwd_workspace_floats(
                n_samples, 1), device="meta")
            g8 = torch.empty(B * R, 8, device="meta")
            rec["bound_ms"], rec["bound_by"] = bound(
                2 * MACS_PER_SAMPLE * n_samples,
                [center, ray, depth, g8, cache] + weights, list(grads[:2]))
            rec["bound_ms_with_dw"], _ = bound(
                2 * 2 * MACS_PER_SAMPLE * n_samples,
                [center, ray, depth, g8, cache] + weights, list(grads))
    k2, k3, k4 = records["k2"], records["k3"], records["k4"]
    for rec in records.values():
        rec["library_ms"] = None    # no single PyTorch call computes these chains
    print("kernels: K2 {:.3f} ms (plain {:.3f}, bound {:.3f}) forward+backward at "
          "[18,113]x{}; K3 {:.3f} ms (plain {:.3f}, bound {:.3f}) at [1,2048]x{}; "
          "card: {}".format(k2["ms"], k2["plain_ms"], k2["bound_ms"], K, k3["ms"],
                            k3["plain_ms"], k3["bound_ms"], K, card_line()))
    print("kernels: K4 at [1,2048]x{}, backward alone: weights frozen {:.3f} ms (plain "
          "{:.3f}, bound {:.3f}), with weight gradients {:.3f} ms (plain {:.3f}, bound "
          "{:.3f}); K3 + K4 forward+backward: frozen {:.3f} ms (plain {:.3f}), with "
          "weight gradients {:.3f} ms (plain {:.3f}); K3 + K4 training route at "
          "[18,113]x{} {:.3f} ms (K2 {:.3f}); card: {}".format(
              K, k4["ms"], k4["plain_ms"], k4["bound_ms"], k4["ms_with_dw"],
              k4["plain_ms_with_dw"], k4["bound_ms_with_dw"], k4["k3_k4_ms"],
              k4["k3_k4_plain_ms"], k4["k3_k4_ms_with_dw"], k4["k3_k4_plain_ms_with_dw"],
              K, k4["route_ms"], k2["ms"], card_line()))
    check(not failures, "kernel and plain version disagree: {}".format(failures))
    return records


def _rotation(axis_angle):
    theta = float(np.linalg.norm(axis_angle))
    k = axis_angle / max(theta, 1e-12)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(theta) * K + (1 - math.cos(theta)) * K @ K


def make_scene(H, W, n, seed):
    """n views near identity pose whose colours are a smooth function of the
    world-space ray direction, so that all views agree."""
    rng = np.random.RandomState(seed)
    f = 0.5 * W / np.tan(0.4)
    intr = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
    d_cam = pix @ np.linalg.inv(intr).T
    freq = np.array([[2.0, 0.5, 1.0], [-1.0, 2.5, 0.3], [0.7, -0.4, 2.2]])
    images, poses = [], []
    for _ in range(n):
        R = _rotation(rng.randn(3) * 0.02)
        t = rng.randn(3) * 0.05
        d_world = d_cam @ R          # R^T d for each row: camera-to-world rotation
        d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)
        img = 0.5 + 0.45 * np.sin(3.0 * d_world @ freq.T + np.array([0.0, 1.0, 2.0]))
        images.append(img.reshape(H, W, 3).astype(np.float32))
        poses.append(np.concatenate([R, t[:, None]], 1).astype(np.float32))
    return dict(image=np.stack(images), intr=np.tile(intr, (n, 1, 1)),
                pose=np.stack(poses), idx=np.arange(n, dtype=np.int32))


def plain_image(system, pose, intr, progress):
    """rgb [1,H*W,3] of one view through the plain render, chunk by chunk as
    the system's render_image sends the chunks to K3 (unjittered depths)."""
    from neural_invertible_warp_tpu_torch.ops import rays, sampling
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    opt = system.opt
    check(not opt.nerf.get("setbg_opaque"), "plain_image has no background")
    chunk = min(opt.nerf.rand_rays, system.HW)
    rgbs = []
    for start in range(0, system.HW, chunk):
        idx = torch.arange(start, min(start + chunk, system.HW), device=system.device)
        center, ray = rays.get_center_and_ray(pose, intr, idx, system.W)
        depth = sampling.sample_depth(1, idx.numel(), opt.nerf.sample_intvs,
                                      tuple(opt.nerf.depth.range),
                                      param=opt.nerf.depth.param, stratified=False,
                                      device=system.device)
        out8 = fp.render_rays_plain(system.graph.nerf, center[0], ray[0],
                                    depth[0, :, :, 0], progress, tuple(opt.barf_c2f))
        rgbs.append(out8[:, :3])
    return torch.cat(rgbs)[None]


def psnr(rgb, pixels):
    return -10.0 * math.log10(float(torch.mean((rgb - pixels) ** 2)))


def pose_readout_orthonormality(system):
    """max |R R^T - I| over the pose readout, which must be finite rotations."""
    pose = system.aux["global_rigid"]
    check(bool(torch.isfinite(pose).all()), "global_rigid is not finite")
    R = pose[..., :3]
    ortho = float((R @ R.transpose(-1, -2) - torch.eye(3, device=R.device)).abs().max())
    check(ortho < 1e-4, "global_rigid is not orthonormal: {}".format(ortho))
    return ortho


def train_view_psnr(system, progress):
    """PSNR of training view 0 rendered at its pose readout (through K3),
    which must reach MIN_TRAIN_VIEW_PSNR."""
    with torch.no_grad():
        pose_pred = system.get_all_training_poses()[0]
        train0 = system.render_image(pose_pred[:1], system.train_data["intr"][:1],
                                     progress)["rgb"]
    value = psnr(train0, system.train_data["pixels"][:1])
    check(value > MIN_TRAIN_VIEW_PSNR,
          "train view 0 renders at {:.2f} dB at its pose readout".format(value))
    return value


def phase_slice(device):
    from neural_invertible_warp_tpu_torch.config import process_options
    from neural_invertible_warp_tpu_torch.flagship import flagship_options
    from neural_invertible_warp_tpu_torch.models.engine import Trainer
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    opt = flagship_options()
    opt.data.image_size = list(IMAGE_HW)
    opt.freq.early_termination = N_STEPS
    opt.output_root = os.path.join(HERE, "build", "chip_smoke_run")
    process_options(opt)
    H, W = IMAGE_HW
    print("slice: barf_inn_llff flagship, {} train + {} val views at {}x{}, "
          "{} steps".format(N_TRAIN, N_VAL, H, W, N_STEPS))
    trainer = Trainer(opt, device)
    trainer.build_system(make_scene(H, W, N_TRAIN, seed=0),
                         make_scene(H, W, N_VAL, seed=1))
    system = trainer.system
    reset_counts()
    trainer.train()
    t0 = time.time()
    res = trainer.run_validation(system.step)
    torch.cuda.synchronize()
    val_seconds = time.time() - t0
    launches = {"k2": fp.fused_render_rays_pe_train.launches,
                "k3": fp.fused_render_rays_pe.launches}
    check(field_counts()["k6_fwd"] == 0, "the fused warp is off by default")

    for name, p in system.graph.named_parameters():
        check(p.is_cuda, "parameter {} is not on the card".format(name))
        mu, nu = system.optim.moments(p)
        check(mu.is_cuda and nu.is_cuda, "Adam state of {} is not on the card".format(name))
    check(all(v.is_cuda for v in system.aux.values()), "aux state is not on the card")
    n_chunks = -(-H * W // min(opt.nerf.rand_rays, H * W))
    check(launches["k2"] == N_STEPS, launches)
    check(launches["k3"] == n_chunks * N_VAL, launches)
    losses = torch.stack([torch.stack([m[k] for k in sorted(m)]) for m in trainer.history])
    check(bool(torch.isfinite(losses).all()), "non-finite loss")
    l_first = float(trainer.history[0]["loss_render"])
    l_last = float(trainer.history[-1]["loss_render"])
    check(l_last < l_first, "photometric loss did not fall: {} -> {}".format(l_first, l_last))
    ortho = pose_readout_orthonormality(system)
    check(math.isfinite(res["psnr_val"]), res["psnr_val"])
    check(os.path.isfile(os.path.join(opt.output_path, "model.ckpt")), "no checkpoint")

    # The validation image (K3, at the GT pose moved by the sim(3) fit of the
    # camera centers) against the plain render of the same chunks; then
    # training view 0 at its pose readout, through K3, which the val PSNR
    # cannot show: this scene's colours depend on the ray direction only, so
    # camera centers carry no signal and the centers' sim(3) is arbitrary.
    failures = []
    progress = (torch.tensor(float(system.step)) / opt.max_iter).to(device)
    with torch.no_grad():
        val_pose = system.get_eval_pose(system.test_data["pose"][:1])
        val_plain = plain_image(system, val_pose, system.test_data["intr"][:1], progress)
        compare("val image", torch.as_tensor(res["vis"]["rgb"], device=device),
                val_plain, TOL["value"], failures)
    psnr_train0 = train_view_psnr(system, progress)
    check(not failures, "validation image disagrees with the plain render")
    sim3_angle = math.acos(max(-1.0, min(1.0, (float(torch.trace(system.sim3["R"])) - 1) / 2)))
    print("slice: val PSNR {:.2f} dB at the sim(3)-moved GT pose (camera-center spread "
          "GT {:.4f}, predicted {:.4f}; sim(3) rotation {:.4f} rad); train view 0 at "
          "its pose readout {:.2f} dB".format(
              res["psnr_val"], float(system.sim3["s0"]), float(system.sim3["s1"]),
              sim3_angle, psnr_train0))
    ms = statistics.median(trainer.step_seconds[19:N_STEPS]) * 1e3
    rays = N_TRAIN * (opt.nerf.rand_rays // N_TRAIN)
    print("slice: loss_render {:.5f} -> {:.5f}, global_rigid orthonormal to {:.1e}, "
          "val PSNR {:.2f} dB, rot err {:.4f} rad".format(
              l_first, l_last, ortho, res["psnr_val"], res["error_R"]))
    print("slice: launches K2 {} K3 {}; {:.2f} ms/step (median of steps 20-{}), "
          "{:.0f} rays/s, val render {:.2f} s; card: {}".format(
              launches["k2"], launches["k3"], ms, N_STEPS, rays / (ms / 1e3),
              val_seconds, card_line()))
    keys = ("loss_render", "loss_global_alignment")
    summary = dict(ms=ms, l_last=l_last,
                   step0={k: float(trainer.history[0][k]) for k in keys},
                   step1={k: float(trainer.history[1][k]) for k in keys})
    return trainer, launches, summary


def phase_eval(trainer, device):
    """evaluate_full on the trained system (test-time refinement on), then
    the refinement of a training view turned by a known rotation. Returns
    the evaluation's launch counts."""
    from neural_invertible_warp_tpu_torch.ops import lie, ssim
    from neural_invertible_warp_tpu_torch.ops import pose as pose_ops
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    system, opt = trainer.system, trainer.opt
    H, W = IMAGE_HW
    n_iter = opt.optim.test_iter
    n_chunks = -(-H * W // min(opt.nerf.rand_rays, H * W))
    check(bool(opt.optim.test_photo), "the flagship evaluates with test-time refinement")
    fp.fused_render_rays_pe_train.launches = 0
    fp.fused_render_rays_pe.launches = 0
    fp.fused_render_rays_pe.backward_launches = 0
    t0 = time.time()
    results = system.evaluate_full(dump_images=False)
    torch.cuda.synchronize()
    eval_seconds = time.time() - t0
    launches = {"k2": fp.fused_render_rays_pe_train.launches,
                "k3": fp.fused_render_rays_pe.launches,
                "k4": fp.fused_render_rays_pe.backward_launches}
    check(launches == {"k2": 0, "k3": N_VAL * (n_iter + n_chunks), "k4": N_VAL * n_iter},
          launches)
    check(len(system.eval_log) == N_VAL, "one log entry per evaluated view")
    log = system.eval_log[0]
    losses = log["refine_losses"]
    check(losses.is_cuda and losses.shape == (n_iter,), "refinement losses")
    check(bool(torch.isfinite(losses).all()), "non-finite refinement loss")
    l_first, l_last = float(losses[0]), float(losses[-1])
    check(l_last < l_first, "refinement loss did not fall: {} -> {}".format(l_first, l_last))
    for key in ("PSNR", "SSIM", "rot_error_deg", "trans_error"):
        check(math.isfinite(results[key]), "{} = {}".format(key, results[key]))
    check(results["LPIPS"] is None, "LPIPS without weights: {}".format(results["LPIPS"]))
    for name in ("quant.txt", "quant_pose.txt"):
        check(os.path.isfile(os.path.join(opt.output_path, name)), "no " + name)
    with open(os.path.join(opt.output_path, "quant.txt")) as f:
        check(f.read().split()[-1] == "unavailable", "quant.txt's LPIPS column")
    # SSIM on the card against SSIM of the same two images on the CPU
    progress = (torch.tensor(float(system.step)) / opt.max_iter).to(device)
    with torch.no_grad():
        pred = system.render_image(log["pose"], system.test_data["intr"][:1], progress)["rgb"]
        pred = pred.reshape(H, W, 3).permute(2, 0, 1)[None]
        gt = system.test_data["image"][0].permute(2, 0, 1)[None]
        ssim_card, ssim_cpu = float(ssim.ssim(pred, gt)), float(ssim.ssim(pred.cpu(), gt.cpu()))
    check(abs(ssim_card - ssim_cpu) <= 1e-5 and abs(ssim_card - results["SSIM"]) <= 1e-5,
          "SSIM: card {} cpu {} evaluate_full {}".format(ssim_card, ssim_cpu, results["SSIM"]))
    print("eval: {} view(s) in {:.2f} s: refinement {:.2f} s ({:.2f} ms per iteration, {} "
          "iterations), render {:.2f} s; launches K3 {} K4 {}; refinement loss {:.5f} -> "
          "{:.5f}; PSNR {:.2f} dB, SSIM {:.4f} (cpu {:.4f}), LPIPS unavailable, rot err "
          "{:.3f} deg; card: {}".format(
              N_VAL, eval_seconds, log["refine_seconds"],
              log["refine_seconds"] / n_iter * 1e3, n_iter, log["render_seconds"],
              launches["k3"], launches["k4"], l_first, l_last, results["PSNR"],
              ssim_card, ssim_cpu, results["rot_error_deg"], card_line()))

    # The val view's sim(3) is fit to noise on this scene (its colours depend
    # on the ray direction only), so refinement there proves little. Rotation
    # is observable: turn training view 0's pose readout by a known rotation
    # and refine it, (a) against the field's own render at the readout, where
    # the optimum is the readout itself, so the rotation error must fall; and
    # (b) against view 0's pixels, where the PSNR must rise (the photometric
    # optimum of a rigid pose is not the readout of the warp: PERF.md).
    intr, pixels = system.train_data["intr"][:1], system.train_data["pixels"][:1]
    with torch.no_grad():
        pose0 = system.get_all_training_poses()[0][:1]
        turn = lie.se3_to_SE3(torch.tensor([PERTURB_ROTATION + (0.0, 0.0, 0.0)], device=device))
        pose_turned = pose_ops.compose([turn, pose0])
        own = system.render_image(pose0, intr, progress)["rgb"]
        turned = system.render_image(pose_turned, intr, progress)["rgb"]
    rot_before = float(pose_ops.rotation_distance(pose_turned[..., :3], pose0[..., :3]))
    for label, target, max_share, min_gain in (
            ("the field's own render", own, MAX_REFINED_ROTATION_SHARE, MIN_REFINED_PSNR_GAIN),
            ("view 0's pixels", pixels, None, MIN_REFINED_PSNR_GAIN)):
        pose_refined = system.test_time_optimized_pose(
            pose_turned, intr, target, progress,
            generator=torch.Generator(device=device).manual_seed(7))
        with torch.no_grad():
            refined = system.render_image(pose_refined, intr, progress)["rgb"]
        psnr_before, psnr_after = psnr(turned, target), psnr(refined, target)
        rot_after = float(pose_ops.rotation_distance(pose_refined[..., :3], pose0[..., :3]))
        print("eval: train view 0 turned by {:.5f} rad, refined against {}: rotation error "
              "to the readout {:.5f} -> {:.5f} rad, PSNR {:.2f} -> {:.2f} dB after {} steps "
              "(loss {:.3e} -> {:.3e})".format(
                  rot_before, label, rot_before, rot_after, psnr_before, psnr_after, n_iter,
                  float(system.refine_losses[0]), float(system.refine_losses[-1])))
        check(max_share is None or rot_after < max_share * rot_before,
              "refinement against {} did not reduce the rotation error".format(label))
        check(psnr_after > psnr_before + min_gain,
              "refinement against {} did not raise the PSNR".format(label))
    return launches


# ------------------------------------------- the per-sample field kernels

def fine_batch(R, n_samples, seed, device):
    """Rays [1,R,3], stratified metric depths [1,R,K,1] in [0,1] (the
    nerf_llff_repr range), targets [1,R,3], a standard-normal noise draw
    [1,R,K] and coefficients (a, b, c) of the test loss."""
    from neural_invertible_warp_tpu_torch.ops import sampling
    g = torch.Generator(device="cpu").manual_seed(seed)
    center = torch.randn(1, R, 3, generator=g) * 0.05
    xy = (torch.rand(1, R, 2, generator=g) - 0.5) * 1.2
    ray = torch.cat([xy, torch.ones(1, R, 1)], dim=-1)
    depth = sampling.sample_depth(1, R, n_samples, (0.0, 1.0), generator=g)
    target = torch.rand(1, R, 3, generator=g)
    noise = torch.randn(1, R, n_samples, generator=g)
    coeffs = [torch.randn(1, R, 3, generator=g), torch.randn(1, R, 1, generator=g),
              torch.randn(1, R, 1, generator=g)]
    return [t.to(device) for t in (center, ray, depth, target, noise)], \
        [t.to(device) for t in coeffs]


def field_fn(which):
    """The per-sample field as the tiers call it: "k5", "k1" or "plain"."""
    from neural_invertible_warp_tpu_torch.ops import nerf_mlp
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_field as ff
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    if which == "k5":
        return fp.fused_apply_nerf_samples_pe
    if which == "k1":
        return ff.fused_apply_nerf_samples
    return nerf_mlp.apply_nerf_samples


def field_grads(which, mlp, center, ray, depth, noise, coeffs, activ):
    """(rgb_s, density, loss, [dcenter, dray] + weight gradients): the field
    per sample, composited in PyTorch under autograd as the fallback and
    MLP-only tiers composite it, under the signed test loss of K4's cases."""
    from neural_invertible_warp_tpu_torch.ops import render
    c = center.clone().requires_grad_(True)
    r = ray.clone().requires_grad_(True)
    rgb_s, dens = field_fn(which)(mlp, c, r, depth, density_activ=activ, noise=noise)
    rgb, d, op, _ = render.composite(r, rgb_s, dens, depth)
    loss = k4_loss(rgb, d, op, coeffs)
    grads = torch.autograd.grad(loss, [c, r] + list(mlp.parameters()))
    return rgb_s.detach(), dens.detach(), loss.detach(), grads


def compare_leaves(label, names, got, ref, tol, rel_l2, failures, denoms=None):
    """One line for a list of gradient leaves: the worst leaf's error, as max
    |got - ref| over max |ref|, or with ``rel_l2`` as |got - ref|_2 over
    |ref|_2. ``denoms`` optionally names another denominator for some leaves
    ({name: value}: the L2 norm of the sums of |terms| of a leaf that is a
    cancelling sum). Returns the worst max-abs error."""
    worst, worst_name, worst_abs = 0.0, names[0], 0.0
    for name, g, r in zip(names, got, ref):
        g, r = g.detach().float(), r.detach().float()
        check(g.shape == r.shape, "{}: shape {} != {}".format(name, g.shape, r.shape))
        check(bool(torch.isfinite(g).all()), "{}: kernel output is not finite".format(name))
        if denoms and name in denoms:
            err = float(torch.linalg.norm(g - r)) / max(denoms[name], 1e-30)
        elif rel_l2:
            err = float(torch.linalg.norm(g - r)) / max(float(torch.linalg.norm(r)), 1e-30)
        else:
            err = float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        worst_abs = max(worst_abs, float((g - r).abs().max()))
        if err >= worst:
            worst, worst_name = err, name
    ok = worst <= tol
    print("  {:<14} worst of {} leaves: {} {:.3e} ({})  tol {:.0e}  {}".format(
        label, len(names), "rel_l2" if rel_l2 else "rel_to_max", worst, worst_name, tol,
        "ok" if ok else "FAIL"))
    if not ok:
        failures.append("{} {}".format(label, worst_name))
    return worst_abs


def timed_field(which, mlp, center, ray, depth, noise, activ, backward):
    """Median ms of the field forward without autograd, or of the backward
    alone (with weight gradients) under a fixed per-sample cotangent."""
    fn = field_fn(which)
    if not backward:
        def fwd():
            with torch.no_grad():
                fn(mlp, center, ray, depth, density_activ=activ, noise=noise)
        return time_ms(fwd)
    c = center.clone().requires_grad_(True)
    r = ray.clone().requires_grad_(True)
    rgb_s, dens = fn(mlp, c, r, depth, density_activ=activ, noise=noise)
    g = torch.Generator(device="cpu").manual_seed(5)
    g_rgb = torch.randn(rgb_s.shape, generator=g).to(rgb_s.device)
    g_dens = torch.randn(dens.shape, generator=g).to(dens.device)
    loss = (rgb_s * g_rgb).sum() + (dens * g_dens).sum()
    wrt = [c, r] + list(mlp.parameters())
    return time_ms(lambda: torch.autograd.grad(loss, wrt, retain_graph=True))


def phase_kernels_field(mlp, device):
    """K5 and K1 through the wrappers the fine-sampling tiers call, and K2
    with its noise and prob operands, against their plain versions.
    Returns the JSON records of K5 fwd/bwd and K1 fwd/bwd."""
    from neural_invertible_warp_tpu_torch.ops.cuda import build
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_field as ff
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    names = ["dcenter", "dray"] + ["d" + n.replace("mlp_", "")
                                   for n, _ in mlp.named_parameters()]
    failures = []
    records = {k: dict(max_abs_err=0.0, library_ms=None)
               for k in ("k5_fwd", "k5_bwd", "k1_fwd", "k1_bwd")}
    weights = fp.pack_weights(mlp)
    for which, cases in (("k5", K5_CASES), ("k1", K1_CASES)):
        for i, (case, R, n_samples, activ, noisy) in enumerate(cases):
            (center, ray, depth, _, noise), coeffs = fine_batch(R, n_samples, 50 + i, device)
            noise = noise * NOISE_REG if noisy else None
            print("kernels: {} field wrapper + compositing in PyTorch, {}: [1,{}] rays x {} "
                  "samples".format(which.upper(), case, R, n_samples))
            args = (mlp, center, ray, depth, noise, coeffs, activ)
            rgb_k, dens_k, loss_k, grads_k = field_grads(which, *args)
            rgb_p, dens_p, loss_p, grads_p = field_grads("plain", *args)
            err = compare("rgb", rgb_k, rgb_p, TOL["value"], failures)
            compare("density", dens_k, dens_p, TOL["value"], failures)
            compare("loss", loss_k, loss_p, TOL["value"], failures)
            rel_l2 = activ == "relu"
            compare_leaves("dcenter, dray", names[:2], grads_k[:2], grads_p[:2],
                           TOL_RELU_REL_L2 if rel_l2 else TOL_FIELD_INPUT_GRAD, rel_l2,
                           failures)
            err_g = compare_leaves("weight grads", names[2:], grads_k[2:], grads_p[2:],
                                   TOL_RELU_REL_L2 if rel_l2 else TOL["grad"], rel_l2,
                                   failures)
            if R == FINE_RAYS:
                records[which + "_fwd"]["max_abs_err"] = max(
                    records[which + "_fwd"]["max_abs_err"], err)
                records[which + "_bwd"]["max_abs_err"] = max(
                    records[which + "_bwd"]["max_abs_err"], err_g)
    # K1's own input cotangents, at the encoded inputs of a K = 64 batch
    (center, ray, depth, _, noise), _ = fine_batch(FINE_RAYS, 64, 70, device)
    noise = noise.reshape(-1) * NOISE_REG
    from neural_invertible_warp_tpu_torch.ops import nerf_mlp
    with torch.no_grad():
        xp, view = mlp.encode(*nerf_mlp.sample_points(center, ray, depth))
    xp, view = xp.reshape(-1, 63), view.reshape(-1, 27).contiguous()
    g_out = torch.randn(xp.shape[0], 4, generator=torch.Generator().manual_seed(6)).to(device)
    print("kernels: K1 on encoded inputs [{},63], [{},27], softplus, noise: dxp, "
          "dview".format(xp.shape[0], xp.shape[0]))
    grads = []
    for fn in (ff.fused_mlp, ff.mlp_plain):
        x, v = xp.clone().requires_grad_(True), view.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(mlp, x, v, noise=noise), [x, v], g_out))
    for name, gk, gp in zip(("dxp", "dview"), *grads):
        compare(name, gk, gp, TOL["grad"], failures)

    # times and bounds at the main path's shapes: relu density with noise
    lib = build.load_library().lib
    for which in ("k5", "k1"):
        for n_samples in FINE_K:
            (center, ray, depth, _, noise), _ = fine_batch(FINE_RAYS, n_samples, 80, device)
            noise = noise * NOISE_REG
            sfx = "" if n_samples == FINE_K[0] else "_k{}".format(n_samples)
            N = FINE_RAYS * n_samples
            out = torch.empty(N, 4, device="meta")
            if which == "k5":
                ins = [center, ray, depth, noise]
                douts = [center, ray]
            else:
                douts = [torch.empty(N, 63, device="meta"), torch.empty(N, 27, device="meta")]
                ins = douts + [noise]
            # the kept activations the backward reads
            workspace_floats = (lib.niw_field_pe_fwd_workspace_floats if which == "k5"
                                else lib.niw_field_fwd_workspace_floats)
            cache = torch.empty(workspace_floats(N, 1), device="meta")
            for rec, backward in ((records[which + "_fwd"], False),
                                  (records[which + "_bwd"], True)):
                rec["ms" + sfx] = timed_field(which, mlp, center, ray, depth, noise, "relu",
                                              backward)
                rec["plain_ms" + sfx] = timed_field("plain", mlp, center, ray, depth, noise,
                                                    "relu", backward)
                if backward:   # input- and weight-gradient products
                    b = bound(2 * 2 * MACS_PER_SAMPLE * N, [out, cache] + weights,
                              douts + weights)
                else:
                    b = bound(2 * MACS_PER_SAMPLE * N, ins + weights, [out])
                rec["bound_ms" + sfx] = b[0]
                if not sfx:
                    rec["bound_by"] = b[1]
            f, b = records[which + "_fwd"], records[which + "_bwd"]
            print("kernels: {} at [1,{}]x{}, relu, noise: forward {:.3f} ms (plain {:.3f}, bound "
                  "{:.3f}); backward alone with weight gradients {:.3f} ms (plain {:.3f}, "
                  "bound {:.3f}); card: {}".format(
                      which.upper(), FINE_RAYS, n_samples,
                      f["ms" + sfx], f["plain_ms" + sfx], f["bound_ms" + sfx], b["ms" + sfx],
                      b["plain_ms" + sfx], b["bound_ms" + sfx], card_line()))

    # K2 with the noise operand and the compositing weights
    k2_extra = {}
    for i, (case, R, n_samples, activ, _) in enumerate(K2_NOISE_CASES):
        (center, ray, depth, target, noise), _ = fine_batch(R, n_samples, 90 + i, device)
        noise = noise * NOISE_REG
        print("kernels: K2 train wrapper, {}: [1,{}] rays x {} samples".format(
            case, R, n_samples))
        res = []
        for plain in (False, True):
            c = center.clone().requires_grad_(True)
            r = ray.clone().requires_grad_(True)
            if plain:
                t8 = torch.cat([target[0], torch.ones(R, 1, device=device),
                                torch.zeros(R, 4, device=device)], dim=1)
                sq, out8, prob = fp.render_rays_train_plain(
                    mlp, c[0], r[0], depth[0, :, :, 0], t8, density_activ=activ,
                    noise=noise[0], want_prob=True)
                out = split_plain(out8, 1, R, None)
                out["prob"] = prob[None]
            else:
                out, sq, _ = fp.fused_render_rays_pe_train(
                    mlp, c, r, depth, target, density_activ=activ, noise=noise,
                    want_prob=True)
            grads = torch.autograd.grad(sq / (R * 3), [c, r] + list(mlp.parameters()))
            res.append((out, sq.detach(), grads))
        (out_k, sq_k, grads_k), (out_p, sq_p, grads_p) = res
        for key in ("rgb", "depth", "opacity", "prob"):
            compare(key, out_k[key], out_p[key], TOL["value"], failures)
        compare("sq_sum", sq_k, sq_p, TOL["value"], failures)
        rel_l2 = activ == "relu"
        compare_leaves("gradients", names, grads_k, grads_p,
                       TOL_RELU_REL_L2 if rel_l2 else TOL["grad"], rel_l2, failures)
        if activ == "relu":   # the fine slice's two K2 calls
            def k2():
                c = center.clone().requires_grad_(True)
                out, sq, _ = fp.fused_render_rays_pe_train(
                    mlp, c, ray, depth, target, density_activ=activ, noise=noise,
                    want_prob=True)
                torch.autograd.grad(sq, [c] + list(mlp.parameters()))
            k2_extra["ms_k{}".format(n_samples)] = time_ms(k2)
    print("kernels: K2 with noise and prob, relu, forward+backward: {:.3f} ms at "
          "[1,{}]x{}, {:.3f} ms at [1,{}]x{}; card: {}".format(
              k2_extra["ms_k64"], FINE_RAYS, 64, k2_extra["ms_k192"], FINE_RAYS, 192,
              card_line()))
    check(not failures, "kernel and plain version disagree: {}".format(failures))
    return records, k2_extra


# ------------------------------------------------- the fine-sampling slice

def field_counts():
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_field as ff
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_inn as fi
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    from neural_invertible_warp_tpu_torch.ops.cuda import correlation as k7
    return {"k7_fwd": k7.local_correlation.launches,
            "k7_adj": k7.local_correlation_transpose.launches,
            "k7_adj_f2": k7.local_correlation_transpose_f2.launches,
            "k6_fwd": fi.fused_deform_forward.launches,
            "k6_bwd": fi.fused_deform_forward.backward_launches,
            "k2": fp.fused_render_rays_pe_train.launches,
            "k3": fp.fused_render_rays_pe.launches,
            "k4": fp.fused_render_rays_pe.backward_launches,
            "k5_fwd": fp.fused_apply_nerf_samples_pe.launches,
            "k5_bwd": fp.fused_apply_nerf_samples_pe.backward_launches,
            "k1_fwd": ff.fused_mlp.launches, "k1_bwd": ff.fused_mlp.backward_launches}


def reset_counts():
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_field as ff
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_inn as fi
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    from neural_invertible_warp_tpu_torch.ops.cuda import correlation as k7
    k7.local_correlation.launches = 0
    k7.local_correlation_transpose.launches = 0
    k7.local_correlation_transpose_f2.launches = 0
    fi.fused_deform_forward.launches = 0
    fi.fused_deform_forward.backward_launches = 0
    fp.fused_render_rays_pe_train.launches = 0
    fp.fused_render_rays_pe.launches = 0
    fp.fused_render_rays_pe.backward_launches = 0
    fp.fused_apply_nerf_samples_pe.launches = 0
    fp.fused_apply_nerf_samples_pe.backward_launches = 0
    ff.fused_mlp.launches = 0
    ff.fused_mlp.backward_launches = 0


def plain_image_fine(system, pose, intr):
    """(rgb, rgb_fine) [1,H*W,3] of one view through the plain chain, chunk
    by chunk as render_image renders it. The fine samples are resampled
    from the compositing weights of the system's own coarse field call, as
    render_image resamples them: the plain chain's weights differ from the
    kernel's in the last bits, and so would the samples."""
    from neural_invertible_warp_tpu_torch.ops import nerf_mlp, rays, render, sampling
    opt = system.opt
    check(not opt.nerf.get("setbg_opaque"), "plain_image_fine has no background")
    chunk = min(opt.nerf.rand_rays, system.HW)
    K, activ = opt.nerf.sample_intvs, system.arch.density_activ
    depth_range = tuple(opt.nerf.depth.range)
    rgbs, rgbs_fine = [], []
    for start in range(0, system.HW, chunk):
        idx = torch.arange(start, min(start + chunk, system.HW), device=system.device)
        center, ray = rays.get_center_and_ray(pose, intr, idx, system.W)
        depth = sampling.sample_depth(1, idx.numel(), K, depth_range,
                                      param=opt.nerf.depth.param, stratified=False,
                                      device=system.device)
        prob = render.composite(ray, *system.apply_field_samples(
            system.graph.nerf, center, ray, depth, density_activ=activ), depth)[3]
        depth_fine = sampling.sample_depth_from_pdf(
            prob[..., 0], K, opt.nerf.sample_intvs_fine, depth_range)
        depth_all = torch.sort(torch.cat([depth, depth_fine], dim=2), dim=2).values
        for mlp, d, acc in ((system.graph.nerf, depth, rgbs),
                            (system.graph.nerf_fine, depth_all, rgbs_fine)):
            rgb_s, dens = nerf_mlp.apply_nerf_samples(mlp, center, ray, d,
                                                      density_activ=activ)
            acc.append(render.composite(ray, rgb_s, dens, d)[0])
    return torch.cat(rgbs, dim=1), torch.cat(rgbs_fine, dim=1)


def phase_slice_fine(device):
    """Vanilla NeRF with fine sampling at full width through every tier.
    Returns the launch counts of the whole phase."""
    from neural_invertible_warp_tpu_torch.config import process_options
    from neural_invertible_warp_tpu_torch.models.engine import Trainer
    from neural_invertible_warp_tpu_torch.nerf_llff_repr import nerf_llff_repr_options
    opt = nerf_llff_repr_options()
    opt.data.image_size = list(IMAGE_HW)
    opt.freq.early_termination = FINE_STEPS
    opt.output_root = os.path.join(HERE, "build", "chip_smoke_run_fine")
    process_options(opt)
    H, W = IMAGE_HW
    n_chunks = -(-H * W // min(opt.nerf.rand_rays, H * W))
    K, K_all = opt.nerf.sample_intvs, opt.nerf.sample_intvs + opt.nerf.sample_intvs_fine
    print("fine: nerf (nerf_llff_repr), {} train + {} val views at {}x{}, {} + {} samples, "
          "{} rays, {} steps".format(FINE_N_TRAIN, N_VAL, H, W, K, K_all - K,
                                     opt.nerf.rand_rays, FINE_STEPS))
    trainer = Trainer(opt, device)
    trainer.build_system(make_scene(H, W, FINE_N_TRAIN, seed=2),
                         make_scene(H, W, N_VAL, seed=3))
    system = trainer.system
    check(sorted(n for n, _ in system.graph.named_children()) == ["nerf", "nerf_fine"],
          "the fine-sampling graph holds two fields")
    total = {}

    def window(expected):
        counts = field_counts()
        check(counts == dict(dict.fromkeys(counts, 0), **expected),
              "launches {} but expected {}".format(counts, expected))
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        reset_counts()

    # default tier: both fields through the one-call train kernel
    reset_counts()
    trainer.train()
    window({"k2": 2 * FINE_STEPS})
    hist = trainer.history
    losses = torch.stack([torch.stack([m[k] for k in sorted(m)]) for m in hist])
    check(bool(torch.isfinite(losses).all()), "non-finite loss")
    first = {k: float(hist[0][k]) for k in ("loss_render", "loss_render_fine")}
    last = {k: float(hist[-1][k]) for k in first}
    check(all(last[k] < first[k] for k in first),
          "losses did not fall: {} -> {}".format(first, last))
    ms_step = statistics.median(trainer.step_seconds[9:FINE_STEPS]) * 1e3

    # validation render: the per-sample field kernel, twice per chunk
    t0 = time.time()
    res = trainer.run_validation(system.step)
    torch.cuda.synchronize()
    val_seconds = time.time() - t0
    window({"k5_fwd": 2 * n_chunks * N_VAL})
    check(math.isfinite(res["psnr_val"]), res["psnr_val"])
    failures = []
    with torch.no_grad():
        rgb_plain, rgb_fine_plain = plain_image_fine(
            system, system.test_data["pose"][:1], system.test_data["intr"][:1])
    reset_counts()    # the plain image re-ran the coarse field call per chunk
    compare("val rgb", torch.as_tensor(res["vis"]["rgb"], device=device), rgb_plain,
            TOL["value"], failures)
    compare("val rgb_fine", torch.as_tensor(res["vis"]["rgb_fine"], device=device),
            rgb_fine_plain, TOL["value"], failures)
    check(not failures, "validation image disagrees with the plain render")

    # evaluation of the same view: no pose to align or refine for this model
    t0 = time.time()
    results = system.evaluate_full(dump_images=False)
    torch.cuda.synchronize()
    eval_seconds = time.time() - t0
    window({"k5_fwd": 2 * n_chunks * N_VAL})
    for key in ("PSNR", "SSIM"):
        check(math.isfinite(results[key]), "{} = {}".format(key, results[key]))
    check(abs(results["PSNR"] - res["psnr_val"]) < 1e-3,
          "evaluation PSNR {} is not the validation PSNR {} of the same view".format(
              results["PSNR"], res["psnr_val"]))

    # fallback tier: K5 forward + backward for the coarse field, K2 for the fine
    tier_ms = {}
    opt.tpu.fused_raymarch_full = False
    tier_ms["fallback"] = _tier_steps(system, first)
    window({"k2": FINE_TIER_STEPS, "k5_fwd": FINE_TIER_STEPS, "k5_bwd": FINE_TIER_STEPS})
    # MLP-only tier: K1 forward + backward per field
    opt.tpu.fused_pe = False
    tier_ms["mlp"] = _tier_steps(system, first)
    window({"k1_fwd": 2 * FINE_TIER_STEPS, "k1_bwd": 2 * FINE_TIER_STEPS})
    opt.tpu.fused_pe, opt.tpu.fused_raymarch_full = True, True

    print("fine: loss_render {:.5f} -> {:.5f}, loss_render_fine {:.5f} -> {:.5f} in {} "
          "steps; val PSNR {:.2f} dB (fine field), evaluation PSNR {:.2f} dB, SSIM "
          "{:.4f}".format(first["loss_render"], last["loss_render"], first["loss_render_fine"],
                          last["loss_render_fine"], FINE_STEPS, res["psnr_val"],
                          results["PSNR"], results["SSIM"]))
    print("fine: launches {}; default tier {:.2f} ms/step (median of steps 10-{}), {:.0f} "
          "rays/s; fallback tier {:.2f} ms/step, MLP-only tier {:.2f} ms/step (median of "
          "{}); val render {:.2f} s, evaluation {:.2f} s per view; card: {}".format(
              total, ms_step, FINE_STEPS, opt.nerf.rand_rays / (ms_step / 1e3),
              tier_ms["fallback"], tier_ms["mlp"], FINE_TIER_STEPS, val_seconds,
              eval_seconds, card_line()))
    return total


def _tier_steps(system, first):
    """FINE_TIER_STEPS train steps under the system's current switches;
    the losses must be finite and below the first step's. Returns the
    median ms/step."""
    seconds = []
    for _ in range(FINE_TIER_STEPS):
        torch.cuda.synchronize()
        t0 = time.time()
        metrics = system.train_step()
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        for k, v in first.items():
            check(math.isfinite(float(metrics[k])) and float(metrics[k]) < v,
                  "{} = {} (first step {})".format(k, float(metrics[k]), v))
    return statistics.median(seconds) * 1e3


# --------------------------------------------------- the fused INN warp, K6

def inn_setup(B, N, d_feat, seed, device):
    """(net, code [B,d_feat], pts [B,N,3]): a DeformNetwork of the paper's
    configuration with every leaf perturbed, and random inputs."""
    from neural_invertible_warp_tpu_torch.ops import inn
    g = torch.Generator(device="cpu").manual_seed(seed)
    net = inn.DeformNetwork(d_feat, d_hidden=128, n_blocks=3, n_layers=1, multires=6,
                            generator=g)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(INN_PERTURB * torch.randn(p.shape, generator=g))
    code = torch.randn(B, d_feat, generator=g)
    pts = torch.randn(B, N, 3, generator=g)
    return net.to(device), code.to(device), pts.to(device)


def inn_forward(which, net, code, pts, alpha):
    """The warp through the wrapper ("kernel": K6 on CUDA tensors), through
    the kernel's plain version on the same operands ("plain"), or through
    the plain chain DeformNetwork.forward ("chain")."""
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_inn as fi
    if which == "kernel":
        return fi.fused_deform_forward(net, code, pts, alpha)
    if which == "plain":
        rw1, rw2 = fi.row_windows(pts.shape[1], alpha, pts.device)
        return fi.fused_deform_plain(pts, rw1, rw2, fi.block_codes(net, code),
                                     fi.leaves_of(net))
    return net(code, pts, alpha)


def inn_grads(which, net, code, pts, alpha, loss="sin"):
    """(out, [dpts, dcode] + the gradient of every parameter) under the loss
    sum(sin(3 out)), or with ``loss="sum"`` under sum(out)."""
    c = code.clone().requires_grad_(True)
    x = pts.clone().requires_grad_(True)
    out = inn_forward(which, net, c, x, alpha)
    total = torch.sin(3.0 * out).sum() if loss == "sin" else out.sum()
    grads = torch.autograd.grad(total, [x, c] + list(net.parameters()))
    return out.detach(), grads


def inn_bias_terms(net, code, pts, alpha, loss="sin"):
    """For each output bias of the chain ("dlin0_a_1.bias", ...), whose
    gradient is the sum over all points of that output's cotangent: the L2
    norm over its elements of the sums of the |terms|, with the gradients
    themselves, from one backward of the loss."""
    sums, hooks = {}, []
    for name, layer in net.named_children():
        if name.endswith("_1"):
            def keep(module, args, output, name=name):
                output.register_hook(lambda g: sums.__setitem__(
                    "d{}.bias".format(name),
                    float(torch.linalg.norm(g.abs().sum(dim=tuple(range(g.dim() - 1)))))))
            hooks.append(layer.register_forward_hook(keep))
    _, grads = inn_grads("chain", net, code, pts, alpha, loss)
    for h in hooks:
        h.remove()
    return sums, grads


def inn_backward_ms(which, net, code, pts, alpha):
    """Time of the backward alone: one forward, then the same graph
    differentiated again and again."""
    c = code.clone().requires_grad_(True)
    x = pts.clone().requires_grad_(True)
    loss = torch.sin(3.0 * inn_forward(which, net, c, x, alpha)).sum()
    wrt = [x, c] + list(net.parameters())
    return time_ms(lambda: torch.autograd.grad(loss, wrt, retain_graph=True))


def inn_device_ms(net, code, pts, alpha):
    """(forward, backward) device time of K6's bare launch sequences: each is
    captured into a CUDA graph and replayed, so that no host time lies
    between its kernels (through the wrapper, a call this small is bounded
    by the host)."""
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_inn as fi
    with torch.no_grad():
        rw1, rw2 = fi.row_windows(pts.shape[1], alpha, pts.device)
        codes = fi.block_codes(net, code).contiguous()
        leaves = [l.detach().contiguous() for l in fi.leaves_of(net)]
        g = torch.randn(pts.shape, generator=torch.Generator().manual_seed(9)).to(pts.device)
        _, prep = fi.launch_inn_fwd(pts, rw1, rw2, codes, leaves)
        return [graph_ms(lambda: fi.launch_inn_fwd(pts, rw1, rw2, codes, leaves)),
                graph_ms(lambda: fi.launch_inn_bwd(pts, rw1, rw2, codes, leaves, prep, g))]


def phase_kernel_inn(device):
    """K6 through the wrapper under autograd against its plain version and
    the plain chain. Returns the JSON records of K6 fwd and K6 bwd."""
    import copy
    from neural_invertible_warp_tpu_torch.ops.cuda import build
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_inn as fi
    failures = []
    records = {k: dict(max_abs_err=0.0, library_ms=None) for k in ("k6_fwd", "k6_bwd")}
    for i, (case, B, N, d_feat, alphas) in enumerate(INN_CASES):
        net, code, pts = inn_setup(B, N, d_feat, 100 + i, device)
        names = ["dpts", "dcode"] + ["d" + n for n, _ in net.named_parameters()]
        net64 = copy.deepcopy(net).double()
        for alpha in alphas:
            print("kernels: K6 fused warp wrapper, {}: [{},{},3] points, latent {}, alpha "
                  "{}".format(case, B, N, d_feat, alpha))
            out_k, grads_k = inn_grads("kernel", net, code, pts, alpha)
            _, grads_again = inn_grads("kernel", net, code, pts, alpha)
            check(all(torch.equal(a, b) for a, b in zip(grads_k, grads_again)),
                  "two K6 backward runs differ")
            args64 = (net64, code.double(), pts.double(), alpha)
            denoms, grads_64 = inn_bias_terms(*args64)
            sums_ones, grads_64_ones = inn_bias_terms(*args64, loss="sum")
            check(len(denoms) == 6, "expected six output biases: {}".format(sorted(denoms)))
            norms = {n: float(torch.linalg.norm(g)) for n, g in zip(names, grads_64)}
            norms_ones = {n: float(torch.linalg.norm(g)) for n, g in zip(names, grads_64_ones)}
            print("  output biases, |sum of terms|_2 over |sums of |terms||_2: " + ", ".join(
                "{} {:.1e} (under sum(out) {:.1e})".format(
                    n[1:-5], norms[n] / denoms[n], norms_ones[n] / sums_ones[n])
                for n in sorted(denoms)))
            _, grads_k_ones = inn_grads("kernel", net, code, pts, alpha, "sum")

            def from_f64(grads):
                return max(float(torch.linalg.norm(g - g64)) / norms[n]
                           for n, g, g64 in zip(names, grads, grads_64))
            worst = {"kernel": from_f64(grads_k)}
            for which in ("plain", "chain"):
                out_r, grads_r = inn_grads(which, net, code, pts, alpha)
                _, grads_r_ones = inn_grads(which, net, code, pts, alpha, "sum")
                print("  against the {}:".format(
                    "kernel's plain version" if which == "plain" else "plain chain"))
                check(float((out_r - pts).abs().max()) > 1e-2, "the warp is the identity")
                err = compare("out", out_k, out_r, TOL["value"], failures)
                err_g = compare_leaves("gradients", names, grads_k, grads_r,
                                       TOL_INN_GRAD_REL_L2, True, failures, denoms=denoms)
                compare_leaves("of sum(out)", names, grads_k_ones, grads_r_ones,
                               TOL_INN_GRAD_REL_L2, True, failures)
                if which == "plain" and case == "flagship":
                    records["k6_fwd"]["max_abs_err"] = max(records["k6_fwd"]["max_abs_err"], err)
                    records["k6_bwd"]["max_abs_err"] = max(records["k6_bwd"]["max_abs_err"], err_g)
                worst[which] = from_f64(grads_r)
            print("  gradients against float64, worst leaf's relative L2: kernel {:.3e}, "
                  "plain version {:.3e}, chain {:.3e}".format(
                      worst["kernel"], worst["plain"], worst["chain"]))
    # times and bounds at the flagship's warp shape
    _, B, N, d_feat, _ = INN_CASES[0]
    alpha = 0.37
    net, code, pts = inn_setup(B, N, d_feat, 100, device)
    fwd, bwd = records["k6_fwd"], records["k6_bwd"]
    for which, key in (("kernel", "ms"), ("plain", "plain_ms"), ("chain", "chain_ms")):
        def forward(which=which):
            with torch.no_grad():
                inn_forward(which, net, code, pts, alpha)
        fwd[key] = time_ms(forward)
        bwd[key] = inn_backward_ms(which, net, code, pts, alpha)
        bwd["fwd_bwd_" + key] = time_ms(lambda which=which: inn_grads(which, net, code, pts, alpha))
    fwd["device_ms"], bwd["device_ms"] = inn_device_ms(net, code, pts, alpha)
    leaves = fi.leaves_of(net)
    codes = torch.empty(3, B, d_feat, device="meta")
    rw = torch.empty(N, device="meta")
    prep = torch.empty(build.load_library().lib.niw_inn_prep_floats(B), device="meta")
    flops = 2 * (B * N * INN_MACS_PER_POINT + B * d_feat * INN_MACS_PER_IMAGE_AND_LATENT_DIM)
    fwd["bound_ms"], fwd["bound_by"] = bound(flops, [pts, rw, rw, codes] + leaves, [pts])
    # the recomputed forward, the input-gradient and the weight-gradient products
    bwd["bound_ms"], bwd["bound_by"] = bound(
        3 * flops, [pts, pts, rw, rw, codes, prep] + leaves, [pts, codes] + leaves)
    print("kernels: K6 at [{},{},3] x {} latent dims, alpha {}, through the wrapper (host "
          "included): forward {:.4f} ms (plain version {:.4f}, chain {:.4f}); backward alone "
          "{:.4f} ms (plain version {:.4f}, chain {:.4f}); forward + backward {:.4f} ms (plain "
          "version {:.4f}, chain {:.4f}); the launch sequences alone, replayed from a CUDA "
          "graph: forward {:.4f} ms (bound {:.5f}), backward {:.4f} ms (bound {:.5f}); "
          "card: {}".format(
              B, N, d_feat, alpha, fwd["ms"], fwd["plain_ms"], fwd["chain_ms"],
              bwd["ms"], bwd["plain_ms"], bwd["chain_ms"],
              bwd["fwd_bwd_ms"], bwd["fwd_bwd_plain_ms"], bwd["fwd_bwd_chain_ms"],
              fwd["device_ms"], fwd["bound_ms"], bwd["device_ms"], bwd["bound_ms"],
              card_line()))
    check(not failures, "kernel and plain version disagree: {}".format(failures))
    return records


# --------------------------------------------------- K7, the local correlation

def k7_inputs(B, C, H, W, seed, device):
    """f1, f2 [B,C,H,W] and a cost-volume cotangent m [B,81,H,W]."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(device)
                 for shape in ((B, C, H, W), (B, C, H, W), (B, 81, H, W)))


def k7_library(f1, f2):
    """The nearest PyTorch route to K7: ``F.unfold`` of f2's 9x9 windows,
    then one einsum with f1 (two calls; no single library call computes a
    local cost volume)."""
    B, C, H, W = f1.shape
    u = torch.nn.functional.unfold(f2, 9, padding=4).view(B, C, 81, H * W)
    return torch.einsum("bcp,bcdp->bdp", f1.reshape(B, C, H * W), u).view(B, 81, H, W) / C


def k7_library_adjoint(m, f2):
    """The same route for the adjoint in f1: unfold, then one einsum with m."""
    B, C, H, W = f2.shape
    u = torch.nn.functional.unfold(f2, 9, padding=4).view(B, C, 81, H * W)
    return torch.einsum("bdp,bcdp->bcp", m.reshape(B, 81, H * W), u).view(B, C, H, W) / C


def phase_kernel_k7(device):
    """K7 and its two adjoints through the wrappers against their plain
    versions on the card, at the calls PDC-Net makes for a 480x640 pair and
    a DTU 300x400 pair and at a ragged shape; times beside the bound and the
    unfold + einsum route. Returns the JSON records of K7 and its adjoint in
    f1 (the one the matcher launches)."""
    from neural_invertible_warp_tpu_torch.ops import correlation as plain
    from neural_invertible_warp_tpu_torch.ops.cuda import correlation as k7
    failures = []
    records = {k: dict(max_abs_err=0.0, by_shape={}) for k in ("k7_fwd", "k7_adj")}
    adj2 = records["k7_adj"]["f2_adjoint"] = dict(max_abs_err=0.0, by_shape={})
    for i, (case, B, C, H, W) in enumerate(K7_CASES):
        f1, f2, m = k7_inputs(B, C, H, W, 200 + i, device)
        shape = "[{},{},{},{}]".format(B, C, H, W)
        print("kernels: K7 local correlation, {}: {} x 2 -> [{},81,{},{}]".format(
            case, shape, B, H, W))
        out = k7.local_correlation(f1, f2)
        df1 = k7.local_correlation_transpose(m, f2)
        df2 = k7.local_correlation_transpose_f2(m, f1)
        err = compare("forward", out, plain.local_correlation(f1, f2), TOL_K7, failures)
        err_1 = compare("adjoint in f1", df1, plain.local_correlation_transpose(m, f2), TOL_K7,
                        failures)
        err_2 = compare("adjoint in f2", df2, plain.local_correlation_transpose_f2(m, f1),
                        TOL_K7, failures)
        same = k7.local_correlation(f1, f1)[:, 40]
        compare("d=0 of f1, f1", same, (f1 * f1).mean(dim=1), TOL_K7, failures)
        check(torch.equal(k7.local_correlation(f1, f2), out), "two K7 runs differ")
        # the autograd Function's backward is the two adjoint launches
        a, b = f1.clone().requires_grad_(True), f2.clone().requires_grad_(True)
        ga, gb = torch.autograd.grad((k7.local_correlation(a, b) * m).sum(), [a, b])
        check(torch.equal(ga, df1) and torch.equal(gb, df2),
              "the backward of _LocalCorrelation is not its adjoint kernels")
        records["k7_fwd"]["max_abs_err"] = max(records["k7_fwd"]["max_abs_err"], err)
        records["k7_adj"]["max_abs_err"] = max(records["k7_adj"]["max_abs_err"], err_1)
        adj2["max_abs_err"] = max(adj2["max_abs_err"], err_2)
        flops = 2 * 81 * B * C * H * W
        t = {"k7_fwd": dict(
            ms=graph_ms(lambda: k7.local_correlation(f1, f2)),
            wrapper_ms=time_ms(lambda: k7.local_correlation(f1, f2)),
            plain_ms=graph_ms(lambda: plain.local_correlation(f1, f2)),
            library_ms=graph_ms(lambda: k7_library(f1, f2))),
            "k7_adj": dict(
            ms=graph_ms(lambda: k7.local_correlation_transpose(m, f2)),
            wrapper_ms=time_ms(lambda: k7.local_correlation_transpose(m, f2)),
            plain_ms=graph_ms(lambda: plain.local_correlation_transpose(m, f2)),
            library_ms=graph_ms(lambda: k7_library_adjoint(m, f2))),
            "k7_adj_f2": dict(
            ms=graph_ms(lambda: k7.local_correlation_transpose_f2(m, f1)),
            plain_ms=graph_ms(lambda: plain.local_correlation_transpose_f2(m, f1)))}
        t["k7_fwd"]["bound_ms"], t["k7_fwd"]["bound_by"] = bound(flops, [f1, f2], [out])
        for k in ("k7_adj", "k7_adj_f2"):
            t[k]["bound_ms"], t[k]["bound_by"] = bound(flops, [m, f1], [df1])
        if i == 0:      # the library route computes the same functions
            compare("unfold+einsum", k7_library(f1, f2), plain.local_correlation(f1, f2),
                    TOL_K7, failures)
            compare("unfold+einsum adj", k7_library_adjoint(m, f2),
                    plain.local_correlation_transpose(m, f2), TOL_K7, failures)
        for key, name in (("k7_fwd", "forward"), ("k7_adj", "adjoint in f1"),
                          ("k7_adj_f2", "adjoint in f2")):
            r = t[key]
            print("  {:<14} {:.4f} ms (wrapper {}), plain version {:.4f} ms, unfold + einsum "
                  "(two calls) {}, bound {:.5f} ms ({}); graph replay".format(
                      name, r["ms"], "{:.4f}".format(r["wrapper_ms"]) if "wrapper_ms" in r
                      else "-", r["plain_ms"], "{:.4f} ms".format(r["library_ms"])
                      if "library_ms" in r else "-", r["bound_ms"], r["bound_by"]))
        records["k7_fwd"]["by_shape"][shape] = t["k7_fwd"]
        records["k7_adj"]["by_shape"][shape] = t["k7_adj"]
        adj2["by_shape"][shape] = t["k7_adj_f2"]
        del out, df1, df2, f1, f2, m
        torch.cuda.empty_cache()
    # the record's own times are those of PDC-Net's largest call
    _, B, C, H, W = K7_CASES[0]
    first = "[{},{},{},{}]".format(B, C, H, W)
    for k in ("k7_fwd", "k7_adj"):
        records[k].update({n: records[k]["by_shape"][first][n] for n in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print("kernels: K7 at {}: forward {:.4f} ms, adjoint in f1 {:.4f} ms, adjoint in f2 "
          "{:.4f} ms (CUDA graph replay), bound {:.5f} ms; card: {}".format(
              first, records["k7_fwd"]["ms"], records["k7_adj"]["ms"],
              adj2["by_shape"][first]["ms"], records["k7_fwd"]["bound_ms"], card_line()))
    check(not failures, "kernel and plain version disagree: {}".format(failures))
    return records


# --------------------------------------------- the PDC-Net matcher (pose init)

class plain_correlation:
    """Within the block, PDC-Net's correlations (the module attributes that
    ``ops/pdcnet`` calls) are K7's plain versions on CUDA tensors too: the
    reference route of the matcher's comparison."""

    def __enter__(self):
        from neural_invertible_warp_tpu_torch.ops import correlation as plain
        from neural_invertible_warp_tpu_torch.ops.cuda import correlation as k7
        self.saved = k7.local_correlation, k7.local_correlation_transpose
        k7.local_correlation = plain.local_correlation
        k7.local_correlation_transpose = plain.local_correlation_transpose

    def __exit__(self, *exc):
        from neural_invertible_warp_tpu_torch.ops.cuda import correlation as k7
        k7.local_correlation, k7.local_correlation_transpose = self.saved


def phase_pose_init_pdcnet(device):
    """PDC-Net at its published widths, random weights from a seed, through
    PdcNetMatcher over the pose-nearest pairs of 6 views at 480x640 and one
    pair at 300x400. Returns the launch counts of the path."""
    from neural_invertible_warp_tpu_torch.ops.pdcnet import pdcnet as pdcnet_mod
    from neural_invertible_warp_tpu_torch.ops.pdcnet.pdcnet import PDCNet
    from neural_invertible_warp_tpu_torch.utils import matchers
    net = PDCNet(torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in net.parameters())
    matcher = matchers.PdcNetMatcher(net, min_confidence=PDCNET_MIN_CONFIDENCE)
    check(matcher.device == device, matcher.device)
    H, W = IMAGE_HW
    scene = make_scene(H, W, PDCNET_VIEWS, seed=4)
    pairs = [(scene, i, j) for i, j in matchers.nearest_pose_pairs(
        scene["pose"], PDCNET_NEIGHBOURS)]
    dtu = make_scene(*PDCNET_DTU_HW, 2, seed=5)
    pairs.append((dtu, 0, 1))
    print("pdcnet: PDC-Net ({:.1f} M parameters, random weights) through PdcNetMatcher: {} "
          "pose-nearest pairs of {} views at {}x{}, one pair at {}x{}".format(
              n_params / 1e6, len(pairs) - 1, PDCNET_VIEWS, H, W, *PDCNET_DTU_HW))
    reset_counts()
    matches, seconds = [], []
    for s, i, j in pairs:
        t0 = time.time()
        matches.append(matcher(i, j, s["image"][i], s["image"][j]))
        seconds.append(time.time() - t0)       # the matches are on the host: synced
    launches = {k: v for k, v in field_counts().items() if v}
    check(launches == {"k7_fwd": K7_FWD_PER_PAIR * len(pairs),
                       "k7_adj": K7_ADJ_PER_PAIR * len(pairs)},
          "launches {} for {} pairs".format(launches, len(pairs)))

    # the kernel route against the same module with K7's plain versions, and
    # on two pairs both against a float64 evaluation of the plain route
    net64 = copy.deepcopy(net).double()
    failures, worst = [], dict(flow=0.0, p_r=0.0)
    for n, ((s, i, j), (kp_i, kp_j)) in enumerate(zip(pairs, matches)):
        flow, p_r = matcher.flow_and_confidence(s["image"][i], s["image"][j])
        with plain_correlation():
            flow_p, p_r_p = matcher.flow_and_confidence(s["image"][i], s["image"][j])
        h, w = s["image"].shape[1:3]
        check(flow.shape == (1, 2, h // 4, w // 4) and p_r.shape == (1, 1, h // 4, w // 4),
              (flow.shape, p_r.shape))
        check(bool(torch.isfinite(flow).all() and torch.isfinite(p_r).all()), "not finite")
        check(float(p_r.min()) >= 0.0 and float(p_r.max()) <= 1.0, "P_R outside [0, 1]")
        check(float(flow.abs().max()) > 0.1, "the flow is trivial")
        err_f = float((flow - flow_p).abs().max()) / float(flow_p.abs().max())
        err_p = float((p_r - p_r_p).abs().max())
        worst["flow"], worst["p_r"] = max(worst["flow"], err_f), max(worst["p_r"], err_p)
        if err_f > TOL_PDCNET_FLOW or err_p > TOL_PDCNET_PR:
            failures.append((i, j, err_f, err_p))
        line = ""
        if n in (0, len(pairs) - 1):
            with plain_correlation(), torch.no_grad():
                flow_64, p_r_64 = pdcnet_mod.estimate_flow_and_confidence_map(
                    net64, matcher.image_tensor(s["image"][j]).double(),
                    matcher.image_tensor(s["image"][i]).double())
            scale = float(flow_64.abs().max())
            line = ("; from float64: flow {:.2e} (plain route {:.2e}) of max, P_R {:.2e} "
                    "({:.2e})".format(float((flow - flow_64).abs().max()) / scale,
                                      float((flow_p - flow_64).abs().max()) / scale,
                                      float((p_r - p_r_64).abs().max()),
                                      float((p_r_p - p_r_64).abs().max())))
        # a keypoint can flip only where the two P_R lie on either side of
        # min_confidence, so within this pair's P_R difference of it
        kp_plain = pdcnet_mod.matches_from_flow_and_confidence(
            flow_p, p_r_p, (h, w), PDCNET_MIN_CONFIDENCE)[1]
        near = int(((p_r_p - PDCNET_MIN_CONFIDENCE).abs() <= err_p).sum())
        flips = abs(len(kp_i) - len(kp_plain))
        print("  pair ({},{}) at {}x{}: kernel vs plain route: flow max |diff| / max |flow| "
              "{:.2e}, P_R max |diff| {:.2e}{}; keypoints {} (plain route {}; {} pixels with P_R "
              "within that of {}); P_R in [{:.3f}, {:.3f}]; {:.1f} ms".format(
                  i, j, h, w, err_f, err_p, line, len(kp_i), len(kp_plain), near,
                  PDCNET_MIN_CONFIDENCE, float(p_r.min()), float(p_r.max()), 1e3 * seconds[n]))
        check(flips <= near, "keypoints differ by {} where only {} pixels lie at the "
              "threshold".format(flips, near))
        check(kp_i.shape == kp_j.shape, (kp_i.shape, kp_j.shape))
    del net64
    ms = statistics.median(seconds[1:-1]) * 1e3
    print("pdcnet: launches {} ({} and {} per pair); {:.1f} ms per 480x640 pair (median of "
          "pairs 2-{}, first {:.1f} ms), {:.1f} ms at {}x{}; kernel vs plain route: flow "
          "{:.2e} of max (tol {:.0e}), P_R {:.2e} (tol {:.0e}); card: {}".format(
              launches, K7_FWD_PER_PAIR, K7_ADJ_PER_PAIR, ms, len(pairs) - 1,
              seconds[0] * 1e3, seconds[-1] * 1e3, *PDCNET_DTU_HW, worst["flow"],
              TOL_PDCNET_FLOW, worst["p_r"], TOL_PDCNET_PR, card_line()))
    check(not failures, "kernel and plain routes of the matcher disagree: {}".format(failures))
    return launches


def phase_slice_fused_inn(device, off):
    """The flagship slice again with ``tpu.fused_inn: true``; ``off`` is the
    summary of the fused-off slice (same seed, same scene). Returns the
    launch counts of the path."""
    from neural_invertible_warp_tpu_torch.config import process_options
    from neural_invertible_warp_tpu_torch.flagship import flagship_options
    from neural_invertible_warp_tpu_torch.models.engine import Trainer
    opt = flagship_options()
    opt.data.image_size = list(IMAGE_HW)
    opt.freq.early_termination = N_STEPS
    opt.tpu.fused_inn = True
    opt.output_root = os.path.join(HERE, "build", "chip_smoke_run_fused_inn")
    process_options(opt)
    H, W = IMAGE_HW
    print("fused warp: barf_inn_llff flagship with tpu.fused_inn, {} train views at {}x{}, "
          "{} steps".format(N_TRAIN, H, W, N_STEPS))
    trainer = Trainer(opt, device)
    trainer.build_system(make_scene(H, W, N_TRAIN, seed=0), make_scene(H, W, N_VAL, seed=1))
    system = trainer.system
    reset_counts()
    trainer.train()
    launches = {k: v for k, v in field_counts().items() if v}
    check(launches == {"k6_fwd": N_STEPS, "k6_bwd": N_STEPS, "k2": N_STEPS}, launches)
    losses = torch.stack([torch.stack([m[k] for k in sorted(m)]) for m in trainer.history])
    check(bool(torch.isfinite(losses).all()), "non-finite loss")
    step0 = {k: float(trainer.history[0][k]) for k in off["step0"]}
    for k, v in step0.items():
        rel = abs(v - off["step0"][k]) / max(abs(off["step0"][k]), 1e-30)
        print("  step 0 {:<22} {:.8e} (fused-off {:.8e})  rel {:.3e}  tol {:.0e}".format(
            k, v, off["step0"][k], rel, TOL_FUSED_STEP0))
        check(rel <= TOL_FUSED_STEP0, "step-0 {} differs from the fused-off run's".format(k))
    # at step 0 the warp is the identity and the global-alignment loss 0 on
    # both routes; after one Adam update of the warp through K6's backward it
    # is not, and the two routes must still agree
    for k, v in off["step1"].items():
        got = float(trainer.history[1][k])
        rel = abs(got - v) / abs(v)
        print("  step 1 {:<22} {:.8e} (fused-off {:.8e})  rel {:.3e}  tol {:.0e}".format(
            k, got, v, rel, TOL_FUSED_STEP1))
        check(v > 0 and rel <= TOL_FUSED_STEP1,
              "step-1 {} differs from the fused-off run's".format(k))
    l_last = float(trainer.history[-1]["loss_render"])
    check(l_last < step0["loss_render"], "photometric loss did not fall: {} -> {}".format(
        step0["loss_render"], l_last))
    ortho = pose_readout_orthonormality(system)
    progress = (torch.tensor(float(system.step)) / opt.max_iter).to(device)
    psnr_train0 = train_view_psnr(system, progress)
    launches["k3"] = field_counts()["k3"]
    ms = statistics.median(trainer.step_seconds[19:N_STEPS]) * 1e3
    rays = N_TRAIN * (opt.nerf.rand_rays // N_TRAIN)
    print("fused warp: loss_render {:.5f} -> {:.5f} (fused-off {:.5f} -> {:.5f}), global_rigid "
          "orthonormal to {:.1e}, train view 0 at its pose readout {:.2f} dB".format(
              step0["loss_render"], l_last, off["step0"]["loss_render"], off["l_last"], ortho,
              psnr_train0))
    print("fused warp: launches {}; {:.2f} ms/step, {:.0f} rays/s (fused-off in this run: "
          "{:.2f} ms/step, {:.0f} rays/s; median of steps 20-{}); card: {}".format(
              launches, ms, rays / (ms / 1e3), off["ms"], rays / (off["ms"] / 1e3), N_STEPS,
              card_line()))
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("env: torch {} cuda {}; card: {}".format(torch.__version__,
                                                   torch.version.cuda, card_line()))
    from neural_invertible_warp_tpu_torch.ops.cuda import build
    from neural_invertible_warp_tpu_torch.ops.nerf_mlp import NerfMLP
    from neural_invertible_warp_tpu_torch.flagship import flagship_options
    lib = build.load_library()
    spills = [l.strip() for l in lib.ptxas_log.splitlines() if "spill" in l]
    print("build: {:.1f} s, {}; ptxas: {}".format(
        lib.build_seconds, os.path.relpath(lib.path, HERE),
        "; ".join(sorted(set(spills))) or "no report (cached build)"))
    device = torch.device("cuda", 0)
    mlp = NerfMLP(flagship_options().arch,
                  generator=torch.Generator().manual_seed(0)).to(device)
    records = phase_kernels(mlp, device)
    trainer, launches, summary_off = phase_slice(device)
    launches_eval = phase_eval(trainer, device)
    del trainer
    torch.cuda.empty_cache()
    records_field, k2_extra = phase_kernels_field(mlp, device)
    launches_fine = phase_slice_fine(device)
    records["k2"].update(k2_extra)
    records_inn = phase_kernel_inn(device)
    records_k7 = phase_kernel_k7(device)
    launches_fused = phase_slice_fused_inn(device, summary_off)
    launches_pdcnet = phase_pose_init_pdcnet(device)
    pkg = "neural_invertible_warp_tpu_torch/csrc/"
    pallas = "neural_invertible_warp_tpu/ops/pallas/"
    paths = {"flagship_train": launches, "flagship_eval": launches_eval,
             "fine": launches_fine, "flagship_fused_inn": launches_fused,
             "pose_init_pdcnet": launches_pdcnet}

    def kernel(key, name, source, replaces, record):
        # launches: over the five paths, each counted from 0 by its own phase
        by_path = {path: counts[key] for path, counts in paths.items() if counts.get(key)}
        return dict(name=name, route="cuda", source=pkg + source, replaces=pallas + replaces,
                    launches=sum(by_path.values()), launches_by_path=by_path, **record)
    kernels = [
        kernel("k1_fwd", "K1 field forward (MLP on encoded inputs)", "field.cu",
               "fused_field.py:166", records_field["k1_fwd"]),
        kernel("k1_bwd", "K1 field backward", "field.cu", "fused_field.py:245",
               records_field["k1_bwd"]),
        kernel("k5_fwd", "K5 field_pe forward (PE + MLP per sample)", "field_pe.cu",
               "fused_pe.py:151", records_field["k5_fwd"]),
        kernel("k5_bwd", "K5 field_pe backward", "field_pe.cu", "fused_pe.py:171",
               records_field["k5_bwd"]),
        kernel("k2", "K2 rm_train (one-call train render)", "rm_train.cu",
               "fused_pe.py:886", records["k2"]),
        kernel("k3", "K3 rm_fwd (composited forward render)", "rm_fwd.cu",
               "fused_pe.py:568", records["k3"]),
        kernel("k4", "K4 rm_bwd (backward of the composited render)", "rm_bwd.cu",
               "fused_pe.py:597", records["k4"]),
        kernel("k6_fwd", "K6 inn forward (fused INN warp)", "inn.cu", "fused_inn.py:186",
               records_inn["k6_fwd"]),
        kernel("k6_bwd", "K6 inn backward", "inn.cu", "fused_inn.py:266",
               records_inn["k6_bwd"]),
        kernel("k7_fwd", "K7 local correlation (9x9 cost volume)", "correlation.cu",
               "correlation_kernel.py:23", records_k7["k7_fwd"]),
        kernel("k7_adj", "K7 adjoint in f1 (GOCor's filter gradient)", "correlation.cu",
               "correlation_kernel.py:23", records_k7["k7_adj"]),
    ]
    for k in kernels:
        check(k["launches"] > 0, "{} was not launched on any path".format(k["name"]))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
