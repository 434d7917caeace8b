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
     a background colour; K3 both as a render (its products split on the
     tensor cores) and under autograd (kept for K4, products in fp32); values
     and every gradient within the tolerances below; the training loss and
     gradients through K3 + K4 against K2's; K2's comparisons each beside the
     kernel's and the plain version's distance from a float64 evaluation;
     two launches of K2, of K3 (both modes) and of K4 (frozen and with weight
     gradients) on the same inputs must give the same bits in every output;
     kernel and plain timed with CUDA events (median of 20 runs after 3
     warm-up runs), beside the least time the card could take on the
     kernel's route and all in fp32;
 3b. kernels bf16: K2, K3 and K4 under tpu.compute_dtype: bfloat16 through
     the same wrappers at the same shapes, against their bf16 plain versions
     and a float64 evaluation of the same bf16 math (operands rounded to
     bf16 from their float64 values, float64 sums): each value and gradient
     within TOL or no farther from float64 than TOL_BF16_VS_F64 times the
     plain version; the pack kernel's bf16 plane bit for bit; two launches
     giving the same bits; the bf16 results apart from the fp32 ones; each
     kernel timed beside its fp32 twin in this call, with its bound at the
     dense bf16 rate;
  4. slice: the flagship model (barf_inn_llff at full width) trains 100
     steps through the port's Trainer on an in-memory synthetic scene, then
     renders the validation view and writes a checkpoint. Checks that every
     step went through the kernels, that the weights were packed once per
     step and at most once more for the render, that the loss is finite and
     falls, that the pose readout is a rotation, that the validation image
     equals the plain render of the same chunks, and that a training view
     rendered at its pose readout reaches a PSNR floor;
  5. evaluation: evaluate_full on the trained system, with test-time pose
     refinement (100 Adam steps through K3 and K4) and the full-image render
     of the validation view, at most one weight pack for both (the weights
     are frozen), PSNR, SSIM (held against the CPU's), LPIPS
     (unavailable without weights), quant.txt and quant_pose.txt; then a
     training view turned by a known rotation is refined back: its rotation
     error must fall and its PSNR rise;
 5b. dtu: the paper's Table-2 model (barf_inn_dtu at full width, from the
     noisy_gt start) trains 100 steps on 49 in-memory 300x400 views of an
     opaque object (K2 at [49,41] x 128 metric depths in [1.2, 5.2]),
     validates 2 held-out views (K3) and evaluates them with test-time
     refinement (K3 + K4), the depth errors and the masked metrics; then K2
     on the batch of the next step against its plain version (and float64),
     the validation image against the plain render, the pose readout a
     rotation, the noisy_gt start unmoved; ms/step, rays/s, seconds per
     validation and per evaluated view, depth and pose errors;
  6. field kernels: the per-sample field kernels K5 (PE inside) and K1 (PE
     in PyTorch), forward and forward + backward through the wrappers the
     fine-sampling tiers call, with the compositing in PyTorch under
     autograd, against the plain chain at [1,1024] rays x 64 and x 192
     samples (softplus and relu density, with and without density noise, a
     ragged ray count); K1's render, dxp and dview directly, also at a
     sample count that is not a multiple of 4; two launches of K5 and of K1
     as a render (products split on the tensor cores), kept (products in
     fp32, activations kept) and backward with weight gradients must give
     the same bits; each mode timed beside its route's bound; K2 with its
     noise operand and its compositing-weights output at both sample counts
     (and two launches of each giving the same bits);
  7. fine slice: vanilla NeRF with fine sampling (nerf_llff_repr at full
     width: two 8x256 fields, 64 + 128 samples, 1024 rays, relu density,
     density noise) trains through the Trainer (two K2 calls per step),
     renders the validation view (two K5 calls per chunk) and holds it
     against the plain render of the same chunks and samples (and reports
     how far the fine samples resampled from the kernel's coarse weights
     lie from those of the plain chain's), takes a few steps each in the
     fallback tier (K5 forward + backward, K2) and the MLP-only tier (K1
     forward + backward), and evaluates one view; the weights are packed
     once per field per optimizer step and at most once per field for a
     render or an evaluation;
  8. inn kernel: the fused INN warp K6, forward and backward through the
     wrapper under autograd, against its plain version and against the plain
     chain (DeformNetwork.forward) on the card, every leaf perturbed, at the
     flagship's warp shape [18,226,3] x 128 latent dims and at a ragged, a
     narrow-latent and a 4096-point shape, under the loss sum(sin(3 out))
     and again under sum(out); two backward runs must give the same bits;
     kernel, plain version and chain timed side by side, the launch
     sequences alone (CUDA graph replay) also at 4096 points, and the
     kernels of each launch sequence counted (at most 2 per direction);
     with the output layers zero the warp is the identity and K6's output-
     bias gradients must equal the float64 sums of the cotangent's columns
     rounded once to fp32, bit for bit, on terms that cancel;
  9. kernel_k7: K7 (PDC-Net's 9x9 local correlation) and its adjoints in f1
     and in f2 through the wrappers against their plain versions on the card,
     at the calls of a 480x640 pair ([1,128,120,160], [1,256,60,80],
     [1,256,32,32]), of a DTU 300x400 pair ([1,128,74,100], [1,256,37,50])
     and at a ragged shape with B = 2; the zero-displacement channel of
     identical maps against their mean of squares; the autograd Function's
     gradients against the adjoint kernels; kernel, plain version and the
     unfold + einsum route timed as CUDA graph replays, beside the bound and
     the CTAs of each launch;
 10. fused-warp slice: the flagship again with ``tpu.fused_inn: true``, 100
     steps through the Trainer: K6 forward, K6 backward and K2 once per step
     each, step-0 losses equal to the fused-off run's of phase 4, the loss
     falls, the pose readout is a rotation, a training view at its pose
     readout reaches the PSNR floor; ms/step beside phase 4's;
 11. pose_init_pdcnet: PDC-Net at its published widths (random weights from
     a seed) through PdcNetMatcher over the pose-nearest pairs of 6 views at
     480x640 and one 300x400 pair: 24 K7 and 9 adjoint launches per pair;
     flow and P_R finite, P_R in [0, 1]; the whole matcher against the same
     module with K7's plain versions; keypoint counts both ways; ms per pair,
     and the device time of one pair (torch.profiler) with K7's share;
 12. pose_init_sfm: the SfM pose initialisation of the DTU family. (a)
     barf_inn_dtu at full width from pose.init: colmap with the ZNCC matcher
     (its score matmul on the card, TF32 off) on 30 views at 300x400 of a
     blob cluster before a spotted wall, rendered on the card, the
     reconstruction on the host through the native core built into build/;
     at least 25 views registered, valid and excluded views a partition of
     all, the aligned pose errors under their bounds; then 20 train steps,
     K2 once per step, finite losses; K2 on the batch of the next step (30
     views of 68 rays, 128 metric depths) against its plain version, every
     output and gradient. (b) PDC-Net (random weights) over the
     pose-nearest pairs of 8 of those views into compute_sfm_poses: 24 K7
     and 9 adjoint launches per pair, [8,3,4] finite float32 poses, a
     partition. Matcher ms per pair, and the SfM's host seconds by stage.
 13. garf: the GARF family at garf_llff.yaml's widths (6x256 Gaussian trunk,
     128 samples, 2048 rays) on 18 in-memory 480x640 views, TF32 off:
     garf 100 steps through the Trainer, one view validated and evaluated
     with 100 steps of test-time refinement, nerf_gaussian and
     garf_se3_field 20 steps each, and garf from the GT poses with a pose
     warmup of 5 (se3_refine exactly 0 after 3 steps, moved after 10); each
     system's step 0 against the same step on the CPU and a float64 one on
     18 x 14 rays; losses finite and falling, pose readouts rotations; no
     kernel launches (the Gaussian field takes the plain chain). ms/step,
     rays/s, seconds per validation and per evaluated view.
 14. planar: homography at homography.yaml's widths (360x480 image, 5
     patches of 180x180, a 4x256 neural image with 8 PE bands) from
     perturbations equal to the CPU's: step 0's gradients and the first 3
     losses against the CPU (and float64), then 5,000 steps with the corner
     error required to fall; img_relu at 512x512 (10,000 pixels a step, 3x256
     ReLU) 1,000 steps with the PSNR required to rise; no kernel launches.
 15. sharded: the flagship (barf_inn_llff at full width, phase 4's scene)
     20 steps in 2 processes on the one card, ray-sharded (parallel/mesh.py)
     under a gloo group, spawned by parallel/audit.py, each rank launching
     K2 on its half of the rays and K3 on its half of each render chunk;
     against a one-process run on the same (seed, step) draws: the losses
     of steps 0-2 to 1e-4 relative, every summed gradient leaf of step 0 to
     1e-5 of its max or, where it cancels, no farther from a float64 step
     on the CPU than 1.5x the one-process step's farthest leaf, the
     parameters of the two ranks bit-identical after 20 steps, and the
     sharded render of the validation view equal to the one-process render
     of the same weights to 1e-6 of its max (bit-exact or not, printed);
     then one step under an nccl group of one process, bit-equal to the
     step without a group. ms/step per rank (two processes share the card:
     not a speed result).
 16. evidence: the quality probe (evidence/probe_b3.py's main, the port's
     quality harness) on a small B3 scene rendered on the card (12 views at
     120x160, 11 train / 1 val), the flagship at full width 300 steps on a
     compressed schedule (max_iter 300, the INN warp's c2f horizon 150, so
     every PE band opens), a readout row every 100 steps and a validation
     render: every row finite, K2 launched once per step, K3 in the render;
     then the same probe again, stopped after step 150 as SIGTERM stops a
     row at its deadline, and resumed from its checkpoint in a new Python
     process: every readout row and every record field but the timing
     ones bit-equal to the uncut run's.
 17. evidence_dtu: the DTU probe (evidence/probe_dtu.py's main) for
     barf_inn_dtu from noisy_gt on a small blob DTU scene rendered on the
     card (13 views at 75x100, 11 train / 2 test), 200 steps on the paper's
     schedule, then the full DTU evaluation (5 test-time refinement steps per
     test view, depth errors, masked metrics); then
     evidence/probe_extra_datasets.py's iPhone and Tanks-and-Temples slow
     pans, 100 steps each: every readout, depth error and masked metric
     finite, K2 launched once per step, K3 and K4 in the DTU evaluation; two
     views of the card's DTU scene (images, depth, masks) and the first
     training view of each pan against a CPU render; for each of the three
     runs K2 at the step after its last and K3 at the first chunk of the
     DTU evaluation or of the pan's validation render against their plain
     versions (hold_evidence).
 18. cli: the port's own command line on a scene of PNG files. The B3-class
     blob scene (18 + 1 views) is written as an LLFF tree at 960x1280
     (evidence/scenes.py's write_llff_tree, utils/image_io.write_png), so the
     loader's read_png and its 2x BICUBIC downscale to 480x640 (Pillow's, in
     numpy) run on the card's host; every PNG decodes back to the array
     written. The options the CLI resolves (utils/options_yaml.py, no PyYAML)
     equal flagship.py's with the same overrides, types included. Then
     train.main with the flagship's flags (barf_inn_llff at full width, 100
     steps, a validation and a checkpoint at step 100), evaluate.main (the
     held-out view with 100 steps of test-time pose refinement; no novel-view
     video) in this process, and `python -m
     neural_invertible_warp_tpu_torch.evaluate` with the same flags as a
     subprocess: K2 launched once per step, K3 and K4 launched, every logged
     loss finite, model/100.ckpt, options.yaml, quant.txt and quant_pose.txt
     written, the subprocess's rc 0 and its "restored checkpoint ... (iter
     100)", every test-view PNG decodes at 480x640; then K2 at the step after
     the last and K3 at the first validation chunk against their plain
     versions (hold_evidence).
 19. cli_data: JPEG and DTU files through the same entry points. (a) The
     JPEG decoder (csrc/jpeg_decode.cpp, built with g++ by utils/jpeg.py)
     decodes every fixture of tests/data/jpeg to its manifest's shape and
     PIL hash and equals decode_plain (progressive files included); the
     block-smoothed progressive, CMYK, 2-component, arithmetic, lossless,
     hierarchical and 12-bit fixtures raise naming file and mode; host ms
     per megapixel of both. (b) The flagship's train.main / evaluate.main (40 steps) on
     the committed 19-view LLFF tree of JPEGs at 240x320. (c) A DTU tree of
     9 views written at DTU's raw 1200x1600 on the card
     (scenes.write_dtu_tree), then barf_inn_dtu's train.main (100 steps) and
     evaluate.main (test-view refinement, depth errors, masked PSNR and
     SSIM, all finite); the DTU loader reads the PNGs and PFMs, decomposes
     the projection matrices and resizes to 300x400 through utils/cv_ops,
     and its cameras equal the in-memory scene's to CLI_DATA_CAMERA_TOL.
     (d) The flagship's train.main (40 steps) / evaluate.main on the
     progressive copy of the tree (tests/data/jpeg/llff_progressive) with
     data.augment from an options file (brightness, contrast, saturation,
     hue, hflip, rotate: utils/pil_ops), 3 held-out views and one
     validation with its tensorboard images: the writer the machine has
     is printed; the event file holds val/rgb, val/invdepth and their
     grids, each decoding (utils/image_io) to the uint8 the engine
     encoded; all training views differ from an unaugmented load, the
     validation views equal it; host ms per 240x320 image of the
     progressive and baseline decodes and of the augmentation. In (b),
     (c) and (d): every logged loss finite, K2 once per step, K3 and K4
     launched, then hold_evidence. On an NVIDIA H100 80GB HBM3 at 700.00
     W: (d) 38.70 ms/step, K2 40, K3 528 (114 in training), K4 300;
     writer torch.utils.tensorboard; decode 1.395 / 1.277 ms per image
     progressive / baseline, augmentation 69.122; the path 86.1 s.
 20. flagship_bf16: the flagship's train.main (100 steps) and evaluate.main
     (2 held-out views, test-time refinement) with
     --tpu.compute_dtype=bfloat16 on path cli's tree: the option arrives as
     the string "bfloat16", every logged loss finite, the render loss falls,
     K2 once per step and K3 and K4 launched only in bf16, no fp32 or K5/K1
     launch; then each configuration that would reach K5 or K1 (fine
     sampling, tpu.fused_raymarch: false, density noise outside K2, the
     MLP-only tier) refuses the option before a step, and the plain chain
     ignores it; then hold_evidence.
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
import struct
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
# H100 SXM data sheet at 700 W: fp32 outside the tensor cores, TF32 on the
# tensor cores (dense), device memory
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# A layer product on the tensor cores in split fp32 is three TF32 products
# (lo*hi, hi*lo, hi*hi) for each fp32 one (csrc/gemm_tc.cuh). Every
# backward product (K2, K4, K5, K1) and the render forwards of K3, K5 and K1
# take that route; K2's forward and the forwards under autograd of K3, K5
# and K1 stay fp32 FMAs on the CUDA cores
TF32_PASSES = 3
# tpu.compute_dtype: bfloat16 (phase 3b, path flagship_bf16): the H100 SXM
# data sheet's dense bf16 tensor-core rate at 700 W. The bf16 backward and
# render sum in another order than the plain version, and the PE's sin/cos
# may differ from PyTorch's by an ulp; rounding to bf16 turns such an ulp
# into 2^-8 of the element next to a rounding midpoint, so a value or
# gradient that misses TOL passes if it lies no farther from a float64
# evaluation of the same bf16 math than this factor times the plain
# version's distance (TOL_SFM_K2_VS_F64's rule). On an H100 the kept K3
# forward read 6.5e-7 of max at progress 0.3 and 5.8e-5 with all bands
# open, both as far from float64 as the plain version (PERF.md)
PEAK_BF16_FLOPS = 989e12
TOL_BF16_VS_F64 = 1.5
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
# K1 on encoded inputs also at a sample count that is not a multiple of 4
K1_RAGGED_N = 4093
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


# The DTU path (barf_inn_dtu, the paper's Table-2 model, options as the yaml
# resolves them): 49 training views at 300x400 (41 rays each per step) and
# 2 held-out views of an in-memory scene, an opaque textured sphere seen
# from an inward arc of cameras, as a DTU scan's robot arm sees its object;
# metric depths in the loader's [1.2, 5.2]. barf_c2f is off, so every PE
# band is open, but no sample lies beyond 5.2: K2's gate holds dcenter/dray
# to TOL["grad"], as the flagship's cases with bands 5-9 closed (on an H100
# they read 1.2e-6 and 1.4e-6 of the max against the plain version, both
# 2.5e-4 from a float64 evaluation).
DTU_HW = (300, 400)
DTU_N_TRAIN, DTU_N_VAL = 49, 2
DTU_STEPS = 100
DTU_DEPTH_RANGE = (1.2, 5.2)
DTU_RADIUS = 3.2
DTU_OBJECT_RADIUS = 0.6
DTU_ARC_DEG = 80.0
DTU_FOCAL = 700.0     # pixels at a width of 400


# Path pose_init_sfm: the SfM pose initialisation of the DTU family. (a)
# barf_inn_dtu at full width (as path dtu) starts from pose.init: colmap with
# the weight-free ZNCC matcher, on a capture rendered on the card at
# 300x400: tests/test_sfm_scale.py's ring (an inward arc at radius ~3.2, 170
# px focal at 160 wide, here 425 at 400) around a cluster of small opaque
# blobs before a wall of colour spots (view-stable corners; path dtu's
# smooth sphere gives Harris corners little to hold), then SFM_STEPS train
# steps on K2. Cut: the middle SFM_VIEWS of the ring's 49 views, keeping
# their spacing, since the SfM's host time grows with the square of the
# views (49 views took 140 s on the host of an NVIDIA H100 80GB HBM3,
# 700.00 W machine); 30 views spread over the whole arc double the pose
# error (tools/sfm_smoke_bounds.py, the port on the CPU: 4.73 deg / 0.116
# with --spread, 1.85 deg / 0.0212 for the middle 30). Gates: at most 5 of
# the 30 views excluded (tests/test_sfm_scale.py allows 8 of 49), and the
# aligned pose errors under twice those of that CPU run (not the JAX
# package's 1.44 deg / 0.037, taken at 120x160 with another matcher
# setting). (b) PDC-Net on random weights from a seed (as path
# pose_init_pdcnet) feeds compute_sfm_poses over the pose-nearest pairs of
# SFM_PDCNET_VIEWS of the views: K7's launches per pair, the result's shape
# and the partition are gated, not its quality (random weights).
SFM_HW = (300, 400)
SFM_VIEWS = 30
SFM_STEPS = 20
SFM_FOCAL = 425.0
SFM_MIN_REGISTERED = SFM_VIEWS - 5
SFM_MAX_ROT_DEG, SFM_MAX_TRANS = 3.7, 0.042
SFM_PDCNET_VIEWS = 8
# K2 at this path's batch ([30,68] x 128 metric depths, step 20 from the SfM
# start, every PE band open): the gradients are 15-75x smaller than path
# dtu's at step 100 (max |dcenter| 1.8e-3 against 2.7e-2, the first layer's
# max |dW| 2.5e-5 against 1.8e-3) while the per-sample terms are not, so
# their fp32 sums cancel. On an H100
# the kernel and the plain version each lie 3.3e-3 (dcenter), 3.6e-3 (dray)
# and up to 7.6e-4 (weights) of the max from a float64 evaluation, and
# 2.8e-3 / 3.1e-3 / 3.5e-4 from each other; the kernel's distance from
# float64 over the plain version's reads 0.96-1.22. A gradient that misses
# TOL["grad"] against the plain version passes if it is no farther from
# float64 than this factor times the plain version is; the values
# (rgb, depth, opacity, sq_sum) keep TOL["value"].
TOL_SFM_K2_VS_F64 = 1.5


# Path garf: the GARF family at options/garf_llff.yaml's widths (a 6x256
# Gaussian trunk, skip at 4, a 128-wide view branch, sigma 0.1, a sigmoid;
# 128 samples, 2048 rays) on make_scene's views at 480x640. No kernel covers
# the Gaussian field: every step, render and refinement takes the plain
# chain, and no kernel may launch. Step 0 on the card is held against the
# same step on the CPU (same weights, same draws) on a sub-batch of
# GARF_CPU_RAYS rays per image: the loss to TOL["value"] of its max, every
# gradient leaf to TOL["grad"], or, where it misses, no farther from a
# float64 evaluation on the CPU than TOL_SFM_K2_VS_F64 times the step's
# fp32 noise, the farthest any leaf of the CPU's float32 step lies from it
# (each leaf's distances are printed, and each miss). Sigma 0.1's
# Gaussians turn a rounding difference of a point into a 100x larger one
# of its features: on an H100 the card and the CPU differ by 1.1e-5 to
# 1.7e-5 of max on the trunk's first layers of garf and nerf_gaussian (each
# as far from float64 as the other), and by 1e-4 to 7e-4 on garf_se3_field,
# whose warps from their default init turn the views far apart. garf's
# alpha_linear.bias, a sum over the 32,256 samples that cancels, lies
# 1.62e-5 from float64 on the card and 2.1e-6 on the CPU: on the card in
# float64 the Gaussians alone bring it to 5.4e-6, the softplus to 8.3e-6
# (CUDA's expf, within 2 ulp, in place of the CPU's exp), while the CPU's
# farthest leaf (se3_refine) lies 2.6e-5 from float64
# (tools/plain_chain_grad_probe.py).
GARF_STEPS = 100
GARF_SHORT_STEPS = 20
GARF_CPU_RAYS = 14            # per image: 18 x 14 = 252 rays x 128 samples
GARF_WARMUP = 5
# Path planar: homography at options/homography.yaml's widths (a 360x480
# image, 5 patches of 180x180, a [null,256,256,256,256,3] neural image with 8
# PE bands, fix_first) and img_relu at options/img_relu.yaml's (512x512,
# 10,000 pixels a step, 3x256 ReLU layers), on smooth synthetic images made
# from a seed. homography's step-0 loss and first PLANAR_CPU_STEPS losses on
# the card are held against the CPU's to TOL["value"] of their max, and its
# step-0 gradient leaves, as the fine slice holds a relu field's, to a
# relative L2 error of TOL_RELU_REL_L2; then it trains PLANAR_STEPS steps
# (the yaml's max_iter), and img_relu its 1,000. The neural image is a ReLU
# MLP on all 8 PE bands: the 2^7 pi band turns a rounding difference of a
# warped coordinate into a 400x larger one of its features, and a
# pre-activation that rounds to the other side of 0 changes a point's
# gradient by a finite amount. Even in float64 a warp moved by 1e-8 moves
# the warp gradient by 3.1e-3 of its max (1e-10: by 4e-7), and each fp32
# evaluation lies 1.2e-3 to 4e-3 of max from float64 there
# (tools/plain_chain_cpu_probe.py, and the card's below), so element-wise
# bounds mean nothing. On an H100 (tools/plain_chain_grad_probe.py) the
# card's and the CPU's fp32 warp gradients lie 1.7e-3 and 4.2e-3 in
# relative L2 from the card's float64, TF32 matmuls 3.9e-2 (the loss moves
# only 8.7e-7 under TF32: this gate, not the loss's, would catch it). The
# warps after the first steps are printed beside the CPU's and a float64
# run's, not gated: Adam's first steps pass those differences on to them.
# The sharded path: ranks on the one card (gloo: NCCL refuses two ranks on
# one device), steps, and the gates. Losses: the JAX audit's own gate
# (EVIDENCE_r5.md §2). The render: each ray's K3 result depends on its
# own operands only, whichever half of the chunk it is launched with.
SHARD_RANKS = 2
SHARD_STEPS = 20
TOL_SHARD_LOSS = 1e-4
TOL_SHARD_RENDER = 1e-6
PLANAR_CPU_STEPS = 3
PLANAR_STEPS = 5000
# the corner error after PLANAR_STEPS steps must fall below this share of
# its value at the perturbations. homography.yaml sets no barf_c2f: with all
# 8 PE bands open from step 0 the alignment moves little (BARF's point; on
# the CPU at 72x96, 2,000 steps: 0.1749 -> 0.1737, against 0.1317 with c2f
# [0, 0.6], tools/plain_chain_cpu_probe.py). On an H100 this path's 5,000
# steps take it from 0.1738 to 0.1453, 0.836 of its start; the bound asks
# for a fall of a tenth
MAX_PLANAR_CORNER_SHARE = 0.9
# path evidence: probe_b3 on a small B3 scene, a compressed schedule
EVIDENCE_STEPS = 300
EVIDENCE_ARGS = ["--iters", str(EVIDENCE_STEPS), "--max-iter", str(EVIDENCE_STEPS),
                 "--max-pe-iter", str(EVIDENCE_STEPS // 2), "--log-every", "100",
                 "--n-images", "12", "--size", "120,160", "--device", "cuda"]
# the card's render of that scene against the CPU's, in uint8 levels: the
# tolerance of tests/test_torch_evidence.py (two fp32 orders put a pixel on
# the other side of a level at a few pixels)
EVIDENCE_MAX_LEVELS = 1
EVIDENCE_MAX_PIXEL_SHARE = 1e-3
# the evidence run cut after this step and resumed must equal the uncut one
# bit for bit but in these fields, which time the run
EVIDENCE_CUT_STEP = EVIDENCE_STEPS // 2
EVIDENCE_TIMING_KEYS = ("elapsed", "elapsed_s", "ms_per_step", "segments")
# path evidence_dtu: probe_dtu on a small blob DTU scene (13 views at 75x100,
# 11 train / 2 test), the paper's schedule (max_iter 200000, so the PE bands
# stay closed), 5 test-time refinement steps per test view; then 100 steps
# each of the iPhone and Tanks-and-Temples slow pans
EVIDENCE_DTU_STEPS = 200
EVIDENCE_DTU_ARGS = ["--iters", str(EVIDENCE_DTU_STEPS), "--log-every", "100",
                     "--n-images", "13", "--size", "75,100", "--device", "cuda",
                     "--model", "barf_inn_dtu", "--init", "noisy_gt",
                     "--overrides", "optim.test_iter=5"]
EVIDENCE_EXTRA_STEPS = 100
# the views of the DTU scene held against a CPU render: (split, ring index);
# ring view 0 is the first test view, ring view 1 the first train view
EVIDENCE_DTU_CPU_VIEWS = (("test", 0), ("train", 1))
# the card's DTU depth against the CPU's where both are valid: the CPU
# tests' tolerance against synth_data's PFM
EVIDENCE_DEPTH_REL = 1e-5
EVIDENCE_EXTRA_RUNS = ("iphone_narrow", "tandt_narrow")
# path cli: the flagship's CLI on an LLFF tree of PNGs, 18 train + 1 val views
# (data.val_ratio 0.1) written at twice the flagship's 480x640
CLI_VIEWS = 19
# path flagship_bf16: the flagship's CLI on path cli's tree under
# tpu.compute_dtype: bfloat16; 0.15 holds out the last 2 of the 19 views.
# BF16_REFUSED: the configurations that would reach K5 or K1 (no bf16 variant)
BF16_STEPS = 100
BF16_VAL_RATIO = 0.15
BF16_REFUSED = [
    ("fine sampling (K5)", ["--model=nerf", "--yaml=nerf_llff_repr"]),
    ("tpu.fused_raymarch: false (K5)", ["--tpu.fused_raymarch!"]),
    ("density noise outside the one-call kernel (K5)",
     ["--tpu.fused_train!", "--nerf.density_noise_reg=1.0"]),
    ("the MLP-only tier (K1)", ["--tpu.fused_pe!"]),
]
CLI_WRITE_HW = (960, 1280)
CLI_STEPS = 100
CLI_SUBPROCESS_TIMEOUT = 300
# path cli_data: JPEG and DTU files through the CLI. The JPEG fixtures and
# their manifest (tests/data/jpeg/make_fixtures.py: PIL's decode hashed, the
# card has no encoder), the flagship 40 steps on their 19-view LLFF tree at
# its 240x320, and barf_inn_dtu 100 steps on a DTU tree of 9 views (views 0
# and 8 held out by dtuhold 8) written at DTU's raw 1200x1600 on the card
CLI_DATA_JPEG_DIR = os.path.join(HERE, "tests", "data", "jpeg")
CLI_DATA_LLFF_STEPS = 40
CLI_DATA_LLFF_HW = (240, 320)
CLI_DATA_DTU_VIEWS = 9
CLI_DATA_DTU_STEPS = 100
CLI_DATA_DECODE_REPEATS = 5
# the loader's parse of the written cameras against the in-memory scene's
# (float64 decomposition of float64 matrices, then float32)
CLI_DATA_CAMERA_TOL = 1e-5
# (d): the flagship 40 steps on the progressive copy of the tree, with
# data.augment from an options file (every jitter, hflip, rotate), three
# held-out views (data.val_ratio 0.2, so the grids are written too) and
# one validation's tensorboard images
CLI_DATA_PROG_DIR = os.path.join(CLI_DATA_JPEG_DIR, "llff_progressive")
CLI_DATA_AUG_STEPS = 40
CLI_DATA_AUGMENT = dict(brightness=0.2, contrast=0.2, saturation=0.2, hue=0.05, hflip=True,
                        rotate=5.0)
CLI_DATA_AUG_VAL_RATIO = 0.2
CLI_DATA_TB_TAGS = ("val/rgb", "val/invdepth", "val/rgb_grid", "val/invdepth_grid")


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


def compare(name, got, ref, tol, failures, f64=None, f64_factor=None):
    """Print max |got - ref| against tol * max |ref|; a miss is added to
    ``failures`` (checked once the phase has printed all its lines). With
    ``f64``, a float64 evaluation, also each one's max distance from it as a
    share of its max; with ``f64_factor`` too, a tensor that misses tol
    still passes if it is no farther from float64 than f64_factor times
    ref is (where the sums cancel so far that two fp32 orders differ by
    more than tol, and both are that far from float64)."""
    got, ref = got.detach().float(), ref.detach().float()
    check(got.shape == ref.shape, "{}: shape {} != {}".format(name, got.shape, ref.shape))
    check(bool(torch.isfinite(got).all()), "{}: kernel output is not finite".format(name))
    err = float((got - ref).abs().max())
    scale = max(float(ref.abs().max()), 1e-30)
    ok = err <= tol * scale
    vs64 = ""
    if f64 is not None:
        f64 = f64.detach()
        s64 = max(float(f64.abs().max()), 1e-300)
        got64 = float((got.double() - f64).abs().max()) / s64
        ref64 = float((ref.double() - f64).abs().max()) / s64
        vs64 = "  f64: kernel {:.3e} plain {:.3e}".format(got64, ref64)
        if f64_factor is not None and not ok:
            ok = got64 <= f64_factor * ref64
            vs64 += " (gate: kernel <= {} x plain)".format(f64_factor)
    print("  {:<14} max_abs_err {:.3e}  rel_to_max {:.3e}  tol {:.0e}  {}{}".format(
        name, err, err / scale, tol, "ok" if ok else "FAIL", vs64))
    if not ok:
        failures.append(name)
    return err


def bound(flops, tensors_in, tensors_out, peak=PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): the least time the card could take for `flops`
    operations at `peak` (fp32 by default) and for reading each input and
    writing each output once."""
    n_bytes = sum(t.numel() * t.element_size() for t in tensors_in + tensors_out)
    t_ops, t_bytes = flops / peak, n_bytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def route_bound(n_samples, fp32_products, split_products, tensors_in, tensors_out):
    """bound() of a composited kernel's route: ``fp32_products`` passes over
    the field's layer products (forward, input gradients or weight
    gradients, MACS_PER_SAMPLE multiply-adds per sample each) in fp32 on the
    CUDA cores and ``split_products`` as three TF32 passes on the tensor
    cores."""
    flops = 2 * MACS_PER_SAMPLE * n_samples
    ops_ms = (fp32_products * flops / PEAK_FP32_FLOPS
              + split_products * TF32_PASSES * flops / PEAK_TF32_FLOPS) * 1e3
    bytes_ms, _ = bound(0, tensors_in, tensors_out)
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


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
        target8, kw["progress"], kw["barf_c2f"], bg,
        compute_dtype=kw.get("compute_dtype", "float32"))
    grads = torch.autograd.grad(weight * sq / (B * R * 3),
                                [c, r] + list(mlp.parameters()))
    return sq.detach(), split_plain(out8, B, R, bg), grads


def render_f64(mlp, center, ray, depth, kw):
    """(mlp64, c, r, (rgb, depth, opacity)): the render of kw's options with
    everything after the PE in float64, differentiable in c and r (copies
    of center and ray) and mlp64's parameters (a float64 copy of mlp). The
    points, the unit rays and the PE's sin/cos are taken in fp32, as the
    kernels and the plain versions take them: at depths up to 1e6 the PE's
    arguments differ between fp32 and float64 by whole periods. Under kw's
    compute_dtype bfloat16 every layer product's operands are rounded to
    bf16 from their float64 values (the same bf16 math, summed in float64)."""
    from neural_invertible_warp_tpu_torch.ops import nerf_mlp, render
    mlp64 = copy.deepcopy(mlp).double()
    pe32 = nerf_mlp.positional_encoding_c2f
    c = center.clone().requires_grad_(True)
    r = ray.clone().requires_grad_(True)
    points = c[..., None, :] + r[..., None, :] * depth
    ray_unit = r / torch.clamp(torch.linalg.norm(r, dim=-1, keepdim=True), min=1e-12)
    nerf_mlp.positional_encoding_c2f = lambda x, *args: pe32(x.float(), *args).double()
    try:
        rgb_s, dens = mlp64(points.double(), ray_unit[..., None, :].expand(points.shape).double(),
                            progress=kw["progress"], barf_c2f=kw["barf_c2f"],
                            compute_dtype=kw.get("compute_dtype"))
    finally:
        nerf_mlp.positional_encoding_c2f = pe32
    rgb, d, op, _ = render.composite(r.double(), rgb_s, dens, depth.double())
    if kw["setbg_opaque"]:
        rgb = rgb + kw["bgcolor"] * (1 - op)
    return mlp64, c, r, (rgb, d, op)


def k2_f64(mlp, center, ray, depth, target, kw, weight):
    """k2_plain's (sq_sum, render, gradients) in float64 after the PE
    (render_f64); the gradients are those of sq_sum, scaled afterwards, as
    K2 takes them."""
    B, R = depth.shape[:2]
    mlp64, c, r, (rgb, d, op) = render_f64(mlp, center, ray, depth, kw)
    sq = torch.sum((rgb - target.double()) ** 2)
    grads = torch.autograd.grad(sq, [c, r] + list(mlp64.parameters()))
    return sq.detach(), dict(rgb=rgb, depth=d, opacity=op), [
        g * (weight / (B * R * 3)) for g in grads]


def k2_same_bits(mlp, center, ray, depth, target, kw, density_activ="softplus",
                 noise=None):
    """Two K2 launches on the same inputs (not counted as launches of a
    path): the names of the outputs whose bits differ."""
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    B, R, K_ = depth.shape[:3]
    w3, wv = fp.band_weights(kw.get("progress"), kw.get("barf_c2f"), center.device)
    t = target.reshape(B * R, 3)
    target8 = torch.cat([t, torch.ones_like(t[:, :1]), torch.zeros_like(t[:, :1]).expand(
        B * R, 4)], dim=1).contiguous()
    args = (mlp, center.reshape(B * R, 3).contiguous(), ray.reshape(B * R, 3).contiguous(),
            depth.reshape(B * R, K_).contiguous(), target8, w3, wv,
            float(kw["bgcolor"]) if kw.get("setbg_opaque") else None, density_activ,
            None if noise is None else noise.reshape(B * R, K_).contiguous(), True)
    runs = []
    for _ in range(2):
        out, dcenter, dray, grads, prob = fp.launch_rm_train(
            *args, compute_dtype=kw.get("compute_dtype", "float32"))
        runs.append([out, dcenter, dray, prob] + list(grads))
    names = ["out", "dcenter", "dray", "prob"] + [
        "d" + n.replace("mlp_", "") for n, _ in mlp.named_parameters()]
    return [n for n, a, b in zip(names, *runs) if not torch.equal(a, b)]


def fresh_k2_weights(fn):
    """fn with K2's packed weights dropped before each call, as an optimizer
    step drops them: the time of one training step's K2, packing included."""
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp

    def call():
        fp._K2_WEIGHTS.clear()
        return fn()
    return call


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
                                depth.reshape(B * R, K), kw["progress"], kw["barf_c2f"],
                                compute_dtype=kw.get("compute_dtype", "float32"))
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


def k4_grads_f64(mlp, center, ray, depth, coeffs, kw):
    """[dcenter, dray] + weight gradients of K4's test loss in float64 after
    the PE (render_f64)."""
    mlp64, c, r, out = render_f64(mlp, center, ray, depth, kw)
    loss = k4_loss(*out, [t.double() for t in coeffs])
    return torch.autograd.grad(loss, [c, r] + list(mlp64.parameters()))


def k4_weight_grads_f64(mlp, center, ray, depth, coeffs, kw):
    """k4_grads_f64's weight gradients."""
    return k4_grads_f64(mlp, center, ray, depth, coeffs, kw)[2:]


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


def k3_k4_same_bits(mlp, center, ray, depth, coeffs, kw):
    """Two launches each of K3 (render, and kept for K4), K4 with the weights
    frozen and K4 with weight gradients, on the same inputs, K4 at the
    cotangent of K4's test loss (not counted as launches of a path): the
    names of the outputs whose bits differ."""
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    B, R = depth.shape[:2]
    w3, wv = fp.band_weights(kw["progress"], kw["barf_c2f"], center.device)
    c, r = center.reshape(B * R, 3).contiguous(), ray.reshape(B * R, 3).contiguous()
    d = depth.reshape(B * R, K).contiguous()
    a, b, op = coeffs
    g8 = torch.cat([a, b, op, torch.zeros_like(a)], dim=-1).reshape(B * R, 8).contiguous()
    names = ["K3 render out", "K3 kept out", "K3 kept activations", "K4 frozen dcenter",
             "K4 frozen dray", "K4 dcenter", "K4 dray"] + [
        "K4 d" + n.replace("mlp_", "") for n, _ in mlp.named_parameters()]
    dtype = kw.get("compute_dtype", "float32")
    runs = []
    for _ in range(2):
        out = fp.launch_rm_fwd(mlp, c, r, d, w3, wv, compute_dtype=dtype)
        out_kept, cache, packed = fp._rm_fwd(mlp, c, r, d, w3, wv, "softplus", True, dtype)
        frozen = fp.launch_rm_bwd(mlp, c, r, d, g8, w3, wv, cache, packed, want_dw=False)
        dcenter, dray, grads = fp.launch_rm_bwd(mlp, c, r, d, g8, w3, wv, cache, packed)
        runs.append([out, out_kept, cache] + list(frozen[:2]) + [dcenter, dray] + grads)
    return [n for n, x, y in zip(names, *runs) if not torch.equal(x, y)]


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
        sq64, out64, grads64 = k2_f64(mlp, *inputs, kw, weight)
        for key in ("rgb", "depth", "opacity"):
            err = compare(key, out[key], out_ref[key], TOL["value"], failures, out64[key])
            if key == "rgb":
                records["k2"]["max_abs_err"] = max(records["k2"]["max_abs_err"], err)
        compare("sq_sum", sq, sq_ref, TOL["value"], failures, sq64)
        for name, gk, gr, g64 in zip(["dcenter", "dray"] + names, grads, grads_ref, grads64):
            compare(name, gk, gr, tol_in if name in ("dcenter", "dray") else TOL["grad"],
                    failures, g64)
        differ = k2_same_bits(mlp, *inputs, kw)
        print("  two launches on the same inputs: {}".format(
            "the same bits in every output" if not differ else "bits differ in " + str(differ)))
        if differ:
            failures.append("K2 determinism")
        if i == 0:
            same = torch.equal(fp.k2_planes(mlp), fp.k2_planes_plain(mlp))
            print("  weight planes of the pack kernel against its plain version: {}".format(
                "the same bits" if same else "bits differ"))
            if not same:
                failures.append("K2 weight planes")

            def wrapper():
                return k2_wrapper(mlp, *inputs, kw, weight)
            records["k2"]["ms"] = time_ms(fresh_k2_weights(wrapper))
            records["k2"]["ms_weights_packed"] = time_ms(wrapper)
            records["k2"]["plain_ms"] = time_ms(
                lambda: k2_plain(mlp, *inputs, kw, weight))
            # forward, input-gradient and weight-gradient products: K2's
            # route (route_bound), and all of them in fp32 on the CUDA cores
            io = (inputs + weights, [out["rgb"], out["depth"], out["opacity"]] + list(grads))
            records["k2"]["bound_ms"], records["k2"]["bound_by"] = route_bound(
                B * R * K, 1, 2, *io)
            records["k2"]["bound_ms_fp32_cuda_cores"], _ = bound(
                3 * 2 * MACS_PER_SAMPLE * B * R * K, *io)
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

        def k3_kept():
            # under autograd: K3 keeps its activations, its products in fp32
            c = center.clone().requires_grad_(True)
            with torch.enable_grad():
                return [t.detach() for t in fp.fused_render_rays_pe(mlp, c, ray, depth, **kw)]

        def k3_plain():
            out8 = fp.render_rays_plain(mlp, center.reshape(B * R, 3),
                                        ray.reshape(B * R, 3),
                                        depth.reshape(B * R, K), progress, C2F)
            return split_plain(out8, B, R, kw["bgcolor"])
        with torch.no_grad():
            ref = k3_plain()
            for mode, fn in (("render", k3), ("kept", k3_kept)):
                print("  {} (products {}):".format(
                    mode, "split fp32 on the tensor cores" if mode == "render"
                    else "fp32 on the CUDA cores"))
                got = fn()
                for key, g, r in zip(("rgb", "depth", "opacity"), got, ref.values()):
                    err = compare(key, g, r, TOL["value"], failures)
                    if key == "rgb":
                        records["k3"]["max_abs_err"] = max(records["k3"]["max_abs_err"], err)
            if i == 0:
                rec = records["k3"]
                rec["ms"] = time_ms(k3)
                rec["ms_kept"] = time_ms(k3_kept)
                rec["plain_ms"] = time_ms(k3_plain)
                # the render's products split on the tensor cores (its
                # route), the kept forward's in fp32, which is also the
                # all-fp32 bound
                io = ([center, ray, depth] + weights, list(got))
                rec["bound_ms"], rec["bound_by"] = route_bound(B * R * K, 0, 1, *io)
                rec["bound_ms_fp32"], _ = route_bound(B * R * K, 1, 0, *io)
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
            differ = k3_k4_same_bits(*args)
            print("  two launches each of K3 (render, kept) and K4 (frozen, with weight "
                  "gradients) on the same inputs: {}".format(
                      "the same bits in every output" if not differ
                      else "bits differ in " + str(differ)))
            if differ:
                failures.append("K3/K4 determinism")
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
            # on its route (split fp32 on the tensor cores) and all in fp32
            io_in = [center, ray, depth, g8, cache] + weights
            rec["bound_ms"], rec["bound_by"] = route_bound(
                n_samples, 0, 1, io_in, list(grads[:2]))
            rec["bound_ms_with_dw"], _ = route_bound(n_samples, 0, 2, io_in, list(grads))
            rec["bound_ms_fp32"], _ = route_bound(n_samples, 1, 0, io_in, list(grads[:2]))
            rec["bound_ms_with_dw_fp32"], _ = route_bound(n_samples, 2, 0, io_in, list(grads))
    k2, k3, k4 = records["k2"], records["k3"], records["k4"]
    for rec in records.values():
        rec["library_ms"] = None    # no single PyTorch call computes these chains
    print("kernels: K2 {:.3f} ms with its weights packed in the call ({:.3f} packed before; "
          "plain {:.3f}; bound {:.3f} with the backward's products in split fp32 on the tensor "
          "cores, {:.3f} all fp32 on the CUDA cores) forward+backward at [18,113]x{}; K3 at "
          "[1,2048]x{}: render {:.3f} ms (bound {:.3f} split on the tensor cores), kept "
          "{:.3f} ms (bound {:.3f} fp32), plain {:.3f}; card: {}".format(
              k2["ms"], k2["ms_weights_packed"], k2["plain_ms"], k2["bound_ms"],
              k2["bound_ms_fp32_cuda_cores"], K, K, k3["ms"], k3["bound_ms"], k3["ms_kept"],
              k3["bound_ms_fp32"], k3["plain_ms"], card_line()))
    print("kernels: K4 at [1,2048]x{}, backward alone: weights frozen {:.3f} ms (plain "
          "{:.3f}, bound {:.3f} split, {:.3f} all fp32), with weight gradients {:.3f} ms "
          "(plain {:.3f}, bound {:.3f} split, {:.3f} all fp32); K3 + K4 "
          "forward+backward: frozen {:.3f} ms (plain {:.3f}), with weight gradients {:.3f} "
          "ms (plain {:.3f}); K3 + K4 training route at [18,113]x{} {:.3f} ms (K2 {:.3f}); "
          "card: {}".format(
              K, k4["ms"], k4["plain_ms"], k4["bound_ms"], k4["bound_ms_fp32"],
              k4["ms_with_dw"], k4["plain_ms_with_dw"], k4["bound_ms_with_dw"],
              k4["bound_ms_with_dw_fp32"], k4["k3_k4_ms"], k4["k3_k4_plain_ms"],
              k4["k3_k4_ms_with_dw"], k4["k3_k4_plain_ms_with_dw"], K, k4["route_ms"],
              k2["ms"], card_line()))
    check(not failures, "kernel and plain version disagree: {}".format(failures))
    return records


def bf16_apart(name, bf16, fp32, failures):
    """tpu.compute_dtype: bfloat16 must not compute what float32 does: the
    bf16 result must lie farther from the fp32 one than the value gate."""
    err = float((bf16.float() - fp32.float()).abs().max())
    scale = max(float(fp32.abs().max()), 1e-30)
    ok = err > TOL["value"] * scale
    print("  bf16 apart from fp32, {}: {:.3e} of max (gate > {:.0e}) {}".format(
        name, err / scale, TOL["value"], "ok" if ok else "FAIL"))
    if not ok:
        failures.append("bf16 = fp32 in " + name)


def bf16_bound(n_samples, passes, tensors_in, tensors_out):
    """(bound_ms, bound_by) of a bf16 kernel: ``passes`` passes over the
    field's layer products at the dense bf16 rate, against the bytes of its
    inputs and outputs."""
    return bound(passes * 2 * MACS_PER_SAMPLE * n_samples, tensors_in, tensors_out,
                 peak=PEAK_BF16_FLOPS)


def phase_kernels_bf16(mlp, device):
    """Phase 3b: K2, K3 and K4 under tpu.compute_dtype: bfloat16, through the
    wrappers the slice calls, against their bf16 plain versions at the shapes
    of phase_kernels, each output also against a float64 evaluation of the
    same bf16 math (k2_f64, k4_grads_f64); each timed beside its fp32 twin.
    Returns the JSON records."""
    from neural_invertible_warp_tpu_torch.flagship import flagship_options
    from neural_invertible_warp_tpu_torch.ops.cuda import build
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    weight = 10.0 ** float(flagship_options().loss_weight.render)
    names = ["d" + n.replace("mlp_", "") for n, _ in mlp.named_parameters()]
    failures = []
    records = {key: dict(max_abs_err=0.0, library_ms=None)
               for key in ("k2_bf16", "k3_bf16", "k4_bf16")}
    weights = fp.pack_weights(mlp)
    planes, planes_ref = fp.k2_planes(mlp, "bfloat16"), fp.k2_planes_plain(mlp, "bfloat16")
    same = torch.equal(planes.view(torch.int32), planes_ref.view(torch.int32))
    print("kernels bf16: weight planes with the bf16 plane ({} floats) against the pack's "
          "plain version: {}".format(planes.numel(), "the same bits" if same else "bits differ"))
    if not same:
        failures.append("bf16 weight planes")
    for i, (case, B, R, progress, bg, _) in enumerate(K2_CASES):
        kw = dict(progress=progress, barf_c2f=C2F, setbg_opaque=bg, bgcolor=1.0 if bg else None,
                  compute_dtype="bfloat16")
        inputs = ray_batch(B, R, seed=10 + i, device=device)
        print("kernels bf16: K2 train wrapper, {}: [{},{}] rays x {} samples, progress {}, "
              "setbg_opaque {}".format(case, B, R, K, progress, bg))
        sq, out, grads = k2_wrapper(mlp, *inputs, kw, weight)
        sq_ref, out_ref, grads_ref = k2_plain(mlp, *inputs, kw, weight)
        sq64, out64, grads64 = k2_f64(mlp, *inputs, kw, weight)
        # the forward sums in the plain version's order (Fp32Gemm on rounded
        # operands) but its PE's sin/cos may differ from PyTorch's by an ulp
        # (all bands open: arguments to 1e9), and the backward (Bf16Gemm)
        # sums in another order; rounding to bf16 turns such an ulp into 2^-8
        # of the element next to a rounding midpoint. So values and
        # gradients pass at TOL or by the float64 rule
        for key in ("rgb", "depth", "opacity"):
            err = compare(key, out[key], out_ref[key], TOL["value"], failures, out64[key],
                          TOL_BF16_VS_F64)
            if key == "rgb":
                records["k2_bf16"]["max_abs_err"] = max(records["k2_bf16"]["max_abs_err"], err)
        compare("sq_sum", sq, sq_ref, TOL["value"], failures, sq64)
        for name, gk, gr, g64 in zip(["dcenter", "dray"] + names, grads, grads_ref, grads64):
            compare(name, gk, gr, TOL["grad"], failures, g64, TOL_BF16_VS_F64)
        differ = k2_same_bits(mlp, *inputs, kw)
        print("  two launches on the same inputs: {}".format(
            "the same bits in every output" if not differ else "bits differ in " + str(differ)))
        if differ:
            failures.append("K2 bf16 determinism")
        if i == 0:
            kw32 = dict(kw, compute_dtype="float32")
            sq32, out32, grads32 = k2_wrapper(mlp, *inputs, kw32, weight)
            bf16_apart("K2 rgb", out["rgb"], out32["rgb"], failures)
            bf16_apart("K2 dW0", grads[2], grads32[2], failures)
            rec = records["k2_bf16"]
            rec["ms"] = time_ms(fresh_k2_weights(lambda: k2_wrapper(mlp, *inputs, kw, weight)))
            rec["ms_fp32"] = time_ms(fresh_k2_weights(
                lambda: k2_wrapper(mlp, *inputs, kw32, weight)))
            rec["plain_ms"] = time_ms(lambda: k2_plain(mlp, *inputs, kw, weight))
            io = (inputs + weights, [out["rgb"], out["depth"], out["opacity"]] + list(grads))
            rec["bound_ms"], rec["bound_by"] = bf16_bound(B * R * K, 3, *io)
            # on its route: the forward in fp32 on the CUDA cores
            flops = 2 * MACS_PER_SAMPLE * B * R * K
            rec["bound_ms_route"] = max(
                (flops / PEAK_FP32_FLOPS + 2 * flops / PEAK_BF16_FLOPS) * 1e3,
                bound(0, *io)[0])
    for i, (case, B, R, progress, bg) in enumerate(K3_CASES):
        kw = dict(progress=progress, barf_c2f=C2F, setbg_opaque=bg, bgcolor=1.0 if bg else None,
                  compute_dtype="bfloat16")
        center, ray, depth, _ = ray_batch(B, R, seed=20 + i, device=device)
        coeffs = k4_coefficients(B, R, seed=40 + i, device=device)
        print("kernels bf16: K3 forward wrapper, {}: [{},{}] rays x {} samples, progress {}, "
              "setbg_opaque {}".format(case, B, R, K, progress, bg))

        def k3(kw=kw):
            return fp.fused_render_rays_pe(mlp, center, ray, depth, **kw)

        def k3_kept():
            c = center.clone().requires_grad_(True)
            with torch.enable_grad():
                return [t.detach() for t in fp.fused_render_rays_pe(mlp, c, ray, depth, **kw)]

        def k3_plain():
            with torch.no_grad():
                return k4_render(mlp, center, ray, depth, kw, plain=True)[2]
        ref = k3_plain()
        c64 = [t.detach() for t in render_f64(mlp, center, ray, depth, kw)[3]]
        with torch.no_grad():
            rendered = k3()
            for mode, got in (("render", rendered), ("kept", k3_kept())):
                print("  {} (products {}):".format(
                    mode, "one bf16 pass on the tensor cores" if mode == "render"
                    else "fp32 on the CUDA cores, operands rounded to bf16"))
                for key, g, r, g64 in zip(("rgb", "depth", "opacity"), got, ref, c64):
                    err = compare(key, g, r, TOL["value"], failures, g64, TOL_BF16_VS_F64)
                    if key == "rgb":
                        records["k3_bf16"]["max_abs_err"] = max(
                            records["k3_bf16"]["max_abs_err"], err)
            if i == 0:
                bf16_apart("K3 render rgb", rendered[0],
                           k3(dict(kw, compute_dtype="float32"))[0], failures)
                rec = records["k3_bf16"]
                rec["ms"] = time_ms(k3)
                rec["ms_fp32"] = time_ms(lambda: k3(dict(kw, compute_dtype="float32")))
                rec["ms_kept"] = time_ms(k3_kept)
                rec["plain_ms"] = time_ms(k3_plain)
                rec["bound_ms"], rec["bound_by"] = bf16_bound(
                    B * R * K, 1, [center, ray, depth] + weights, list(rendered))
        # K4 through the forward wrapper under autograd (K3 kept), against the
        # plain version and float64
        print("kernels bf16: K4 backward through the forward wrapper, {}".format(case))
        args = (mlp, center, ray, depth, coeffs, kw)
        loss, grads = k4_grads(*args)
        loss_ref, grads_ref = k4_grads(*args, plain=True)
        grads64 = k4_grads_f64(*args)
        compare("loss", loss, loss_ref, TOL["value"], failures)
        for name, gk, gr, g64 in zip(["dcenter", "dray"] + names, grads, grads_ref, grads64):
            err = compare(name, gk, gr, TOL["grad"], failures, g64, TOL_BF16_VS_F64)
            if i == 0 and name in ("dcenter", "dray"):
                records["k4_bf16"]["max_abs_err"] = max(records["k4_bf16"]["max_abs_err"], err)
        print("  weights frozen (no weight gradients):")
        _, grads_frozen = k4_grads(*args, frozen=True)
        for name, gk, gr, g64 in zip(["dcenter", "dray"], grads_frozen, grads_ref, grads64):
            compare(name, gk, gr, TOL["grad"], failures, g64, TOL_BF16_VS_F64)
        if i == 0:
            differ = k3_k4_same_bits(*args)
            print("  two launches each of K3 (render, kept) and K4 (frozen, with weight "
                  "gradients) on the same inputs: {}".format(
                      "the same bits in every output" if not differ
                      else "bits differ in " + str(differ)))
            if differ:
                failures.append("K3/K4 bf16 determinism")
            _, grads32 = k4_grads(mlp, center, ray, depth, coeffs,
                                  dict(kw, compute_dtype="float32"), frozen=True)
            bf16_apart("K4 dray", grads_frozen[1], grads32[1], failures)
            rec = records["k4_bf16"]
            rec["ms"] = k4_backward_ms(*args, frozen=True, plain=False)
            rec["ms_fp32"] = k4_backward_ms(mlp, center, ray, depth, coeffs,
                                            dict(kw, compute_dtype="float32"), True, False)
            rec["plain_ms"] = k4_backward_ms(*args, frozen=True, plain=True)
            rec["ms_with_dw"] = k4_backward_ms(*args, frozen=False, plain=False)
            rec["plain_ms_with_dw"] = k4_backward_ms(*args, frozen=False, plain=True)
            n_samples = B * R * K
            cache = torch.empty(build.load_library().lib.niw_rm_fwd_workspace_floats(
                n_samples, 1), device="meta")
            g8 = torch.empty(B * R, 8, device="meta")
            io_in = [center, ray, depth, g8, cache] + weights
            rec["bound_ms"], rec["bound_by"] = bf16_bound(n_samples, 1, io_in, list(grads[:2]))
            rec["bound_ms_with_dw"], _ = bf16_bound(n_samples, 2, io_in, list(grads))
    k2, k3, k4 = records["k2_bf16"], records["k3_bf16"], records["k4_bf16"]
    print("kernels bf16: K2 {:.3f} ms (fp32 {:.3f} in this call; plain {:.3f}; bound {:.3f} "
          "at the bf16 rate, {:.3f} on its route with the forward in fp32) at [18,113]x{}; "
          "K3 at [1,2048]x{}: render {:.3f} ms (fp32 {:.3f}; bound {:.3f}), kept {:.3f}, plain "
          "{:.3f}; K4 frozen {:.3f} ms (fp32 {:.3f}; plain {:.3f}; bound {:.3f}), with weight "
          "gradients {:.3f} (plain {:.3f}; bound {:.3f}); card: {}".format(
              k2["ms"], k2["ms_fp32"], k2["plain_ms"], k2["bound_ms"], k2["bound_ms_route"], K,
              K, k3["ms"], k3["ms_fp32"], k3["bound_ms"], k3["ms_kept"], k3["plain_ms"],
              k4["ms"], k4["ms_fp32"], k4["plain_ms"], k4["bound_ms"], k4["ms_with_dw"],
              k4["plain_ms_with_dw"], k4["bound_ms_with_dw"], card_line()))
    check(not failures, "bf16 kernel and plain version disagree: {}".format(failures))
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
    the system's render_image sends the chunks to K3 (unjittered depths, over
    the scene's depth range on DTU)."""
    from neural_invertible_warp_tpu_torch.ops import rays, sampling
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    opt = system.opt
    check(not opt.nerf.get("setbg_opaque"), "plain_image has no background")
    chunk = min(opt.nerf.rand_rays, system.HW)
    depth_range = getattr(system, "scene_depth_range", tuple(opt.nerf.depth.range))
    c2f = tuple(opt.barf_c2f) if opt.get("barf_c2f") else None
    rgbs = []
    for start in range(0, system.HW, chunk):
        idx = torch.arange(start, min(start + chunk, system.HW), device=system.device)
        center, ray = rays.get_center_and_ray(pose, intr, idx, system.W)
        depth = sampling.sample_depth(1, idx.numel(), opt.nerf.sample_intvs, depth_range,
                                      param=opt.nerf.depth.param, stratified=False,
                                      device=system.device)
        out8 = fp.render_rays_plain(system.graph.nerf, center[0], ray[0],
                                    depth[0, :, :, 0], progress, c2f)
        rgbs.append(out8[:, :3])
    return torch.cat(rgbs)[None]


def psnr(rgb, pixels):
    return -10.0 * math.log10(float(torch.mean((rgb - pixels) ** 2)))


def pose_readout_orthonormality(pose):
    """max |R R^T - I| over a pose readout, which must be finite rotations."""
    check(bool(torch.isfinite(pose).all()), "the pose readout is not finite")
    R = pose[..., :3]
    ortho = float((R @ R.transpose(-1, -2) - torch.eye(3, device=R.device)).abs().max())
    check(ortho < 1e-4, "the pose readout is not orthonormal: {}".format(ortho))
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
    # K2's split weights are made once per optimizer step: every Adam step
    # advances the parameters' version counters
    check(fp.fused_render_rays_pe_train.packs == N_STEPS,
          "K2 packed its weights {} times in {} steps".format(
              fp.fused_render_rays_pe_train.packs, N_STEPS))
    t0 = time.time()
    res = trainer.run_validation(system.step)
    torch.cuda.synchronize()
    val_seconds = time.time() - t0
    launches = {"k2": fp.fused_render_rays_pe_train.launches,
                "k3": fp.fused_render_rays_pe.launches}
    # K3 takes K2's weights: the render's chunks pack the last step's once
    check(fp.fused_render_rays_pe_train.packs <= N_STEPS + 1,
          "the validation render packed the weights {} times".format(
              fp.fused_render_rays_pe_train.packs - N_STEPS))
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
    ortho = pose_readout_orthonormality(system.aux["global_rigid"])
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
    fp.fused_render_rays_pe_train.packs = 0
    fp.fused_render_rays_pe.launches = 0
    fp.fused_render_rays_pe.backward_launches = 0
    t0 = time.time()
    results = system.evaluate_full(dump_images=False)
    torch.cuda.synchronize()
    eval_seconds = time.time() - t0
    # the refinement and the render, weights frozen, take K2's cached
    # weights: at most one pack (none when the validation render packed them)
    packs = fp.fused_render_rays_pe_train.packs
    check(packs <= 1, "evaluation packed the weights {} times".format(packs))
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
          "iterations), render {:.2f} s; launches K3 {} K4 {}, weights packed {} time(s); "
          "refinement loss {:.5f} -> {:.5f}; PSNR {:.2f} dB, SSIM {:.4f} (cpu {:.4f}), "
          "LPIPS unavailable, rot err {:.3f} deg; card: {}".format(
              N_VAL, eval_seconds, log["refine_seconds"],
              log["refine_seconds"] / n_iter * 1e3, n_iter, log["render_seconds"],
              launches["k3"], launches["k4"], packs, l_first, l_last, results["PSNR"],
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
    check(fp.fused_render_rays_pe_train.packs == packs,
          "the refinements of a turned view packed the frozen weights again")
    return launches


# ----------------------------------------------------------- the DTU path

def make_dtu_scene(H, W, n, seed):
    """n views of DTU_SCENE's opaque textured sphere from an inward arc of
    cameras at radius ~DTU_RADIUS (OpenCV axes: z toward the object), its
    colours a smooth function of the surface point, black elsewhere; the GT
    depth (z-depth, 0 where the ray misses), its validity and the foreground
    mask come analytically. Depth range [1.2, 5.2], as the DTU loader gives
    it. The seed moves the cameras along the arc."""
    rng = np.random.RandomState(seed)
    f = DTU_FOCAL * W / 400.0
    intr = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    d_cam = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3) @ np.linalg.inv(intr).T
    freq = np.array([[2.0, 0.5, 1.0], [-1.0, 2.5, 0.3], [0.7, -0.4, 2.2]]) * 2.5
    keys = ("image", "pose", "depth_gt", "valid_depth_gt", "fg_mask")
    out = {k: [] for k in keys}
    for i in range(n):
        theta = np.deg2rad(DTU_ARC_DEG * ((i + 0.5) / n - 0.5) + 2.0 * rng.randn())
        phi = np.deg2rad(20.0 + 3.0 * rng.randn())
        radius = DTU_RADIUS + 0.1 * rng.randn()
        eye = radius * np.array([np.sin(theta) * np.cos(phi), np.sin(phi),
                                 -np.cos(theta) * np.cos(phi)])
        z = -eye / np.linalg.norm(eye)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R_c2w = np.stack([x, np.cross(z, x), z], axis=1)
        d = d_cam @ R_c2w.T                    # world directions, z-depth 1 each
        a = np.sum(d * d, -1)
        b = 2.0 * d @ eye
        c = eye @ eye - DTU_OBJECT_RADIUS ** 2
        disc = b * b - 4 * a * c
        hit = disc > 0
        depth = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0.0)
        p = eye + depth[:, None] * d
        rgb = 0.5 + 0.45 * np.sin(p @ freq.T + np.array([0.0, 1.0, 2.0]))
        out["image"].append(np.where(hit[:, None], rgb, 0.0).reshape(H, W, 3))
        out["pose"].append(np.concatenate([R_c2w.T, -R_c2w.T @ eye[:, None]], 1))
        out["depth_gt"].append(depth.reshape(H, W))
        out["valid_depth_gt"].append(hit.reshape(H, W))
        out["fg_mask"].append(hit.reshape(H, W))
    arrays = {k: np.stack(v).astype(np.float32) for k, v in out.items()}
    arrays.update(intr=np.tile(intr, (n, 1, 1)), idx=np.arange(n, dtype=np.int32),
                  depth_range=np.tile(np.array([[1.2, 5.2]], np.float32), (n, 1)))
    return arrays


def dtu_k2_batch(system):
    """K2's inputs of the step the system would take next, drawn as its
    train_step draws them (ray subset, then depth jitter, from the step's
    seed): center/ray [B,R,3] out of the warp, metric depths [B,R,K,1] over
    the scene's range, targets [B,R,3]; and the wrapper's keyword
    arguments."""
    from neural_invertible_warp_tpu_torch.ops import rays, sampling
    opt, data = system.opt, system.train_data
    n_rays = opt.nerf.rand_rays // system.n_train
    system.seed_step()
    ray_idx = sampling.sample_ray_subset(system.HW, n_rays, generator=system.generator,
                                         device=system.device)
    with torch.no_grad():
        center_cam, grid_cam = rays.get_unwarped_center_and_ray(
            data["intr"], ray_idx, system.W, pose_init=system._ray_frame())
        warped = system.warp_points(torch.cat([grid_cam, center_cam], 1), system.step)
    center, ray = warped[:, n_rays:], warped[:, :n_rays] - warped[:, n_rays:]
    depth = sampling.sample_depth(system.n_train, n_rays, opt.nerf.sample_intvs,
                                  system.scene_depth_range, param=opt.nerf.depth.param,
                                  generator=system.generator, device=system.device)
    kw = dict(progress=(torch.tensor(float(system.step)) / opt.max_iter).to(system.device),
              barf_c2f=None, setbg_opaque=False, bgcolor=None)
    return [center, ray, depth, data["pixels"][:, ray_idx]], kw


def phase_slice_dtu(device):
    """The DTU path: barf_inn_dtu at full width trains DTU_STEPS steps on
    DTU_N_TRAIN in-memory 300x400 views from the noisy_gt start, validates,
    and evaluates DTU_N_VAL held-out views (test-time refinement on, then
    the depth errors and masked metrics at the backtracked poses); then K2
    on the batch of the system's next step, and one validation image
    against the plain render. Returns (launch counts of the path, K2's
    times at that batch)."""
    from neural_invertible_warp_tpu_torch.barf_inn_dtu import barf_inn_dtu_options
    from neural_invertible_warp_tpu_torch.config import process_options
    from neural_invertible_warp_tpu_torch.models.dtu import InnDTUSystem
    from neural_invertible_warp_tpu_torch.models.engine import Trainer
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    opt = barf_inn_dtu_options()
    opt.freq.early_termination = DTU_STEPS
    opt.output_root = os.path.join(HERE, "build", "chip_smoke_run_dtu")
    process_options(opt)
    H, W = opt.H, opt.W
    check((H, W) == DTU_HW, (H, W))
    n_iter, K_ = opt.optim.test_iter, opt.nerf.sample_intvs
    n_chunks = -(-H * W // min(opt.nerf.rand_rays, H * W))
    n_rays = opt.nerf.rand_rays // DTU_N_TRAIN
    print("dtu: barf_inn_dtu, {} train + {} held-out views at {}x{}, pose.init {} at noise "
          "{}, loss_weight.global_alignment {}, {} steps of [{},{}] rays x {} metric depths in "
          "{}".format(DTU_N_TRAIN, DTU_N_VAL, H, W, opt.pose.init, opt.pose.noise,
                      opt.loss_weight.global_alignment, DTU_STEPS, DTU_N_TRAIN, n_rays, K_,
                      DTU_DEPTH_RANGE))
    trainer = Trainer(opt, device)
    trainer.build_system(make_dtu_scene(H, W, DTU_N_TRAIN, seed=0),
                         make_dtu_scene(H, W, DTU_N_VAL, seed=1))
    system = trainer.system
    check(type(system) is InnDTUSystem, type(system))
    check(np.allclose(system.scene_depth_range, DTU_DEPTH_RANGE), system.scene_depth_range)
    initial = system.aux["initial_poses_w2c"].clone()
    reset_counts()
    trainer.train()
    packs = fp.fused_render_rays_pe_train.packs
    t0 = time.time()
    res = trainer.run_validation(system.step)
    torch.cuda.synchronize()
    val_seconds = time.time() - t0
    t0 = time.time()
    results = system.evaluate_full(dump_images=False)
    torch.cuda.synchronize()
    eval_seconds = time.time() - t0
    launches = {k: v for k, v in field_counts().items() if v}
    # per held-out view: the validation render, the refinement (K3 kept and
    # K4 per iteration), the refined render and the render at the
    # backtracked pose for the depth errors and masked metrics
    check(launches == {"k2": DTU_STEPS, "k3": DTU_N_VAL * (3 * n_chunks + n_iter),
                       "k4": DTU_N_VAL * n_iter}, launches)
    check(packs == DTU_STEPS, "K2 packed its weights {} times in {} steps".format(
        packs, DTU_STEPS))
    check(torch.equal(system.aux["initial_poses_w2c"], initial), "the noisy_gt start moved")

    losses = torch.stack([torch.stack([m[k] for k in sorted(m)]) for m in trainer.history])
    check(bool(torch.isfinite(losses).all()), "non-finite loss or depth error")
    first, last = trainer.history[0], trainer.history[-1]
    check(float(last["loss_render"]) < float(first["loss_render"]),
          "photometric loss did not fall: {} -> {}".format(
              float(first["loss_render"]), float(last["loss_render"])))
    ortho = pose_readout_orthonormality(system.get_all_training_poses()[0])
    for key in ("PSNR", "SSIM", "rot_error_deg", "trans_error", "depth_abs", "depth_rms",
                "PSNR_masked", "SSIM_masked"):
        check(math.isfinite(results[key]), "{} = {}".format(key, results[key]))
    check(results["LPIPS_masked"] is None, "masked LPIPS without weights")

    failures = []
    print("dtu: K2 wrapper on the batch of step {} ([{},{}] rays x {} metric depths, all PE "
          "bands open: barf_c2f is off) against its plain version".format(
              system.step, DTU_N_TRAIN, n_rays, K_))
    inputs, kw = dtu_k2_batch(system)
    depth = inputs[2]
    lo, hi = system.scene_depth_range
    check(float(depth.min()) >= lo and float(depth.max()) <= hi,
          "K2's depths leave the scene's range")
    mlp = system.graph.nerf
    weight = 10.0 ** float(opt.loss_weight.render)
    names = ["d" + n.replace("mlp_", "") for n, _ in mlp.named_parameters()]
    sq, out, grads = k2_wrapper(mlp, *inputs, kw, weight)
    sq_ref, out_ref, grads_ref = k2_plain(mlp, *inputs, kw, weight)
    sq64, out64, grads64 = k2_f64(mlp, *inputs, kw, weight)
    k2_err = 0.0
    for key in ("rgb", "depth", "opacity"):
        err = compare(key, out[key], out_ref[key], TOL["value"], failures, out64[key])
        k2_err = max(k2_err, err) if key == "rgb" else k2_err
    compare("sq_sum", sq, sq_ref, TOL["value"], failures, sq64)
    for name, gk, gr, g64 in zip(["dcenter", "dray"] + names, grads, grads_ref, grads64):
        compare(name, gk, gr, TOL["grad"], failures, g64)
    k2 = dict(ms=time_ms(fresh_k2_weights(lambda: k2_wrapper(mlp, *inputs, kw, weight))),
              plain_ms=time_ms(lambda: k2_plain(mlp, *inputs, kw, weight)),
              max_abs_err=k2_err)
    progress = (torch.tensor(float(system.step)) / opt.max_iter).to(device)
    with torch.no_grad():
        val_pose = system.get_eval_pose(system.test_data["pose"][:1])
        val_plain = plain_image(system, val_pose, system.test_data["intr"][:1], progress)
        compare("val image", torch.as_tensor(res["vis"]["rgb"], device=device), val_plain,
                TOL["value"], failures)
    check(not failures, "DTU path: kernel and plain version disagree: {}".format(failures))

    ms = statistics.median(trainer.step_seconds[19:DTU_STEPS]) * 1e3
    rays = DTU_N_TRAIN * n_rays
    print("dtu: loss_render {:.5f} -> {:.5f}; train depth_abs {:.4f} -> {:.4f}, depth_rmse "
          "{:.4f} -> {:.4f}; pose readout orthonormal to {:.1e}; card: {}".format(
              float(first["loss_render"]), float(last["loss_render"]),
              float(first["depth_abs"]), float(last["depth_abs"]), float(first["depth_rmse"]),
              float(last["depth_rmse"]), ortho, card_line()))
    print("dtu: {:.2f} ms/step (median of steps 20-{}), {:.0f} rays/s; K2 at [{},{}]x{} "
          "{:.3f} ms (plain {:.3f}); card: {}".format(
              ms, DTU_STEPS, rays / (ms / 1e3), DTU_N_TRAIN, n_rays, K_, k2["ms"],
              k2["plain_ms"], card_line()))
    print("dtu: validation of {} views in {:.2f} s ({:.2f} s per view), val PSNR {:.2f} dB; "
          "evaluate_full of {} views in {:.2f} s ({:.2f} s per evaluated view, refinement "
          "{:.2f} s of it); card: {}".format(
              DTU_N_VAL, val_seconds, val_seconds / DTU_N_VAL, res["psnr_val"], DTU_N_VAL,
              eval_seconds, eval_seconds / DTU_N_VAL,
              sum(e["refine_seconds"] for e in system.eval_log) / DTU_N_VAL, card_line()))
    print("dtu: depth_abs {:.4f} depth_rms {:.4f} (sim(3) scale {:.4f}), PSNR {:.2f} dB, "
          "PSNR_masked {:.2f} dB, SSIM_masked {:.4f}, LPIPS_masked unavailable; aligned "
          "rotation error {:.3f} deg, translation error {:.4f}; launches {}; card: {}".format(
              results["depth_abs"], results["depth_rms"], system.depth_scaling_factor(),
              results["PSNR"], results["PSNR_masked"], results["SSIM_masked"],
              results["rot_error_deg"], results["trans_error"], launches, card_line()))
    return launches, k2


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


def timed_field(which, mlp, center, ray, depth, noise, activ, mode):
    """Median ms of the field forward without autograd (mode "render"),
    under autograd (mode "kept": the kernels keep their activations), or of
    the backward alone (mode "backward", with weight gradients) under a
    fixed per-sample cotangent."""
    fn = field_fn(which)
    if mode == "render":
        def fwd():
            with torch.no_grad():
                fn(mlp, center, ray, depth, density_activ=activ, noise=noise)
        return time_ms(fwd)
    if mode == "kept":
        c = center.clone().requires_grad_(True)
        return time_ms(lambda: fn(mlp, c, ray, depth, density_activ=activ, noise=noise))
    c = center.clone().requires_grad_(True)
    r = ray.clone().requires_grad_(True)
    rgb_s, dens = fn(mlp, c, r, depth, density_activ=activ, noise=noise)
    g = torch.Generator(device="cpu").manual_seed(5)
    g_rgb = torch.randn(rgb_s.shape, generator=g).to(rgb_s.device)
    g_dens = torch.randn(dens.shape, generator=g).to(dens.device)
    loss = (rgb_s * g_rgb).sum() + (dens * g_dens).sum()
    wrt = [c, r] + list(mlp.parameters())
    return time_ms(lambda: torch.autograd.grad(loss, wrt, retain_graph=True))


def field_same_bits(which, mlp, center, ray, depth, noise, activ):
    """Two launches each of K5 or K1 as a render, kept (its activations
    too) and backward with weight gradients, on the same inputs (not counted
    as launches of a path): the names of the outputs whose bits differ."""
    from neural_invertible_warp_tpu_torch.ops import nerf_mlp
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_field as ff
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    R, n_samples = depth.shape[1:3]
    c, r = center.reshape(R, 3).contiguous(), ray.reshape(R, 3).contiguous()
    d = depth.reshape(R, n_samples).contiguous()
    g = torch.randn(R * n_samples, 4, generator=torch.Generator().manual_seed(7)).to(c.device)
    if which == "k5":
        w3, wv = fp.band_weights(None, None, c.device)
        nz = noise.reshape(R, n_samples).contiguous()

        def fwd(keep):
            return fp.launch_field_pe_fwd(mlp, c, r, d, w3, wv, activ, nz, keep)

        def bwd(cache, packed):
            return fp.launch_field_pe_bwd(mlp, c, r, d, g, w3, wv, cache, packed, True, activ)
        inputs = ["dcenter", "dray"]
    else:
        with torch.no_grad():
            xp, view = mlp.encode(*nerf_mlp.sample_points(center, ray, depth))
        xp, view = xp.reshape(-1, 63).contiguous(), view.reshape(-1, 27).contiguous()
        nz = noise.reshape(-1).contiguous()

        def fwd(keep):
            return ff.launch_field_fwd(mlp, xp, view, activ, nz, keep)

        def bwd(cache, packed):
            return ff.launch_field_bwd(mlp, g, cache, packed, True, activ)
        inputs = ["dxp", "dview"]
    names = ["render out", "kept out", "kept activations"] + inputs + [
        "d" + n.replace("mlp_", "") for n, _ in mlp.named_parameters()]
    runs = []
    for _ in range(2):
        out = fwd(False)[0]
        out_kept, cache, packed = fwd(True)
        d_a, d_b, grads = bwd(cache, packed)
        runs.append([out, out_kept, cache, d_a, d_b] + grads)
    return [n for n, x, y in zip(names, *runs) if not torch.equal(x, y)]


def phase_kernels_field(mlp, device):
    """K5 and K1 through the wrappers the fine-sampling tiers call, and K2
    with its noise and prob operands, against their plain versions; K5's
    and K1's modes timed and their bits checked run to run. Returns the
    JSON records of K5 fwd/bwd and K1 fwd/bwd."""
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
            # the same forward without autograd: the render's route
            with torch.no_grad():
                rgb_r, dens_r = field_fn(which)(mlp, center, ray, depth, density_activ=activ,
                                                noise=noise)
            err = max(err, compare("render rgb", rgb_r, rgb_p, TOL["value"], failures))
            compare("render dens", dens_r, dens_p, TOL["value"], failures)
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
    # K1's own input cotangents, at the encoded inputs of a K = 64 batch and
    # at a sample count that is not a multiple of 4 (K1 takes any N)
    (center, ray, depth, _, noise), _ = fine_batch(FINE_RAYS, 64, 70, device)
    noise = noise.reshape(-1) * NOISE_REG
    from neural_invertible_warp_tpu_torch.ops import nerf_mlp
    with torch.no_grad():
        xp, view = mlp.encode(*nerf_mlp.sample_points(center, ray, depth))
    xp, view = xp.reshape(-1, 63), view.reshape(-1, 27).contiguous()
    g_out = torch.randn(xp.shape[0], 4, generator=torch.Generator().manual_seed(6)).to(device)
    for n in (xp.shape[0], K1_RAGGED_N):
        print("kernels: K1 on encoded inputs [{},63], [{},27], softplus, noise: render, "
              "dxp, dview".format(n, n))
        x_n, v_n = xp[:n].contiguous(), view[:n].contiguous()
        with torch.no_grad():
            compare("render out", ff.fused_mlp(mlp, x_n, v_n, noise=noise[:n]),
                    ff.mlp_plain(mlp, x_n, v_n, noise=noise[:n]), TOL["value"], failures)
        grads = []
        for fn in (ff.fused_mlp, ff.mlp_plain):
            x, v = x_n.clone().requires_grad_(True), v_n.clone().requires_grad_(True)
            grads.append(torch.autograd.grad(fn(mlp, x, v, noise=noise[:n]), [x, v],
                                             g_out[:n]))
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
            f, b = records[which + "_fwd"], records[which + "_bwd"]
            for rec, mode in ((f, "render"), (f, "kept"), (b, "backward")):
                key = "_kept" if mode == "kept" else ""
                rec["ms" + key + sfx] = timed_field(which, mlp, center, ray, depth, noise,
                                                    "relu", mode)
                rec["plain_ms" + key + sfx] = timed_field("plain", mlp, center, ray, depth,
                                                          noise, "relu", mode)
            # the render forward's products split on the tensor cores (its
            # route), the kept forward's in fp32 (also the all-fp32 bound);
            # the backward's input- and weight-gradient products split, and
            # both all in fp32
            io_f = (ins + weights, [out])
            io_b = ([out, cache] + weights, douts + weights)
            f["bound_ms" + sfx], by_f = route_bound(N, 0, 1, *io_f)
            f["bound_ms_kept" + sfx], _ = route_bound(N, 1, 0, *io_f)
            b["bound_ms" + sfx], by_b = route_bound(N, 0, 2, *io_b)
            b["bound_ms_fp32" + sfx], _ = route_bound(N, 2, 0, *io_b)
            if not sfx:
                f["bound_by"], b["bound_by"] = by_f, by_b
            differ = field_same_bits(which, mlp, center, ray, depth, noise, "relu")
            print("kernels: {} at [1,{}]x{}, relu, noise: render forward {:.3f} ms (plain "
                  "{:.3f}, bound {:.3f} split); kept forward {:.3f} ms (plain {:.3f}, bound "
                  "{:.3f} fp32); backward alone with weight gradients {:.3f} ms (plain {:.3f}, "
                  "bound {:.3f} split, {:.3f} all fp32); two launches of each on the same "
                  "inputs: {}; card: {}".format(
                      which.upper(), FINE_RAYS, n_samples, f["ms" + sfx], f["plain_ms" + sfx],
                      f["bound_ms" + sfx], f["ms_kept" + sfx], f["plain_ms_kept" + sfx],
                      f["bound_ms_kept" + sfx], b["ms" + sfx], b["plain_ms" + sfx],
                      b["bound_ms" + sfx], b["bound_ms_fp32" + sfx],
                      "the same bits in every output" if not differ
                      else "bits differ in " + str(differ), card_line()))
            if differ:
                failures.append("{} determinism at {} samples".format(which.upper(), n_samples))

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
        differ = k2_same_bits(mlp, center, ray, depth, target, {}, activ, noise)
        print("  two launches on the same inputs: {}".format(
            "the same bits in every output" if not differ else "bits differ in " + str(differ)))
        if differ:
            failures.append("K2 determinism, " + case)
        if activ == "relu":   # the fine slice's two K2 calls
            def k2():
                c = center.clone().requires_grad_(True)
                out, sq, _ = fp.fused_render_rays_pe_train(
                    mlp, c, ray, depth, target, density_activ=activ, noise=noise,
                    want_prob=True)
                torch.autograd.grad(sq, [c] + list(mlp.parameters()))
            k2_extra["ms_k{}".format(n_samples)] = time_ms(fresh_k2_weights(k2))
            k2_extra["bound_ms_k{}".format(n_samples)] = route_bound(
                R * n_samples, 1, 2, [], [])[0]
    print("kernels: K2 with noise and prob, relu, forward+backward: {:.3f} ms at "
          "[1,{}]x{} (bound {:.3f}), {:.3f} ms at [1,{}]x{} (bound {:.3f}); card: {}".format(
              k2_extra["ms_k64"], FINE_RAYS, 64, k2_extra["bound_ms_k64"], k2_extra["ms_k192"],
              FINE_RAYS, 192, k2_extra["bound_ms_k192"], card_line()))
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
            "k2_bf16": fp.fused_render_rays_pe_train.bf16_launches,
            "k3_bf16": fp.fused_render_rays_pe.bf16_launches,
            "k4_bf16": fp.fused_render_rays_pe.bf16_backward_launches,
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
    fp.fused_render_rays_pe_train.packs = 0
    fp.fused_render_rays_pe.launches = 0
    fp.fused_render_rays_pe.backward_launches = 0
    fp.fused_render_rays_pe_train.bf16_launches = 0
    fp.fused_render_rays_pe.bf16_launches = 0
    fp.fused_render_rays_pe.bf16_backward_launches = 0
    fp.fused_apply_nerf_samples_pe.launches = 0
    fp.fused_apply_nerf_samples_pe.backward_launches = 0
    ff.fused_mlp.launches = 0
    ff.fused_mlp.backward_launches = 0


def plain_image_fine(system, pose, intr, depth_errs=None):
    """(rgb, rgb_fine) [1,H*W,3] of one view through the plain chain, chunk
    by chunk as render_image renders it. The fine samples are resampled
    from the compositing weights of the system's own coarse field call, as
    render_image resamples them: the plain chain's weights differ from the
    kernel's in the last bits, and so do the samples. ``depth_errs``, a
    list, receives per chunk the largest difference of those fine depths
    from the ones resampled from the plain chain's coarse weights."""
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
        rgb_s, dens = nerf_mlp.apply_nerf_samples(system.graph.nerf, center, ray, depth,
                                                  density_activ=activ)
        rgb, _, _, prob_plain = render.composite(ray, rgb_s, dens, depth)
        rgbs.append(rgb)
        if depth_errs is not None:
            depth_errs.append(float((sampling.sample_depth_from_pdf(
                prob_plain[..., 0], K, opt.nerf.sample_intvs_fine, depth_range)
                - depth_fine).abs().max()))
        depth_all = torch.sort(torch.cat([depth, depth_fine], dim=2), dim=2).values
        rgb_s, dens = nerf_mlp.apply_nerf_samples(system.graph.nerf_fine, center, ray,
                                                  depth_all, density_activ=activ)
        rgbs_fine.append(render.composite(ray, rgb_s, dens, depth_all)[0])
    return torch.cat(rgbs, dim=1), torch.cat(rgbs_fine, dim=1)


def phase_slice_fine(device):
    """Vanilla NeRF with fine sampling at full width through every tier.
    Returns the launch counts of the whole phase."""
    from neural_invertible_warp_tpu_torch.config import process_options
    from neural_invertible_warp_tpu_torch.models.engine import Trainer
    from neural_invertible_warp_tpu_torch.nerf_llff_repr import nerf_llff_repr_options
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
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
    total, packs = {}, {}

    def window(label, expected, n_packs):
        # n_packs: (least, most) weight packs, K2Weights made for either field
        counts = field_counts()
        check(counts == dict(dict.fromkeys(counts, 0), **expected),
              "launches {} but expected {}".format(counts, expected))
        packs[label] = fp.fused_render_rays_pe_train.packs
        check(n_packs[0] <= packs[label] <= n_packs[1],
              "{}: {} weight packs, expected {} to {}".format(label, packs[label], *n_packs))
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        reset_counts()

    # default tier: both fields through the one-call train kernel, each
    # field's weights packed once per optimizer step
    reset_counts()
    trainer.train()
    window("train", {"k2": 2 * FINE_STEPS}, (2 * FINE_STEPS,) * 2)
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
    # (frozen weights: at most one pack per field)
    window("val", {"k5_fwd": 2 * n_chunks * N_VAL}, (0, 2))
    check(math.isfinite(res["psnr_val"]), res["psnr_val"])
    failures, depth_errs = [], []
    with torch.no_grad():
        rgb_plain, rgb_fine_plain = plain_image_fine(
            system, system.test_data["pose"][:1], system.test_data["intr"][:1], depth_errs)
    reset_counts()    # the plain image re-ran the coarse field call per chunk
    print("  fine samples resampled from the coarse field's weights, kernel against "
          "plain: max |depth difference| {:.3e} (depth range [0, 1])".format(max(depth_errs)))
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
    window("eval", {"k5_fwd": 2 * n_chunks * N_VAL}, (0, 2))
    for key in ("PSNR", "SSIM"):
        check(math.isfinite(results[key]), "{} = {}".format(key, results[key]))
    check(abs(results["PSNR"] - res["psnr_val"]) < 1e-3,
          "evaluation PSNR {} is not the validation PSNR {} of the same view".format(
              results["PSNR"], res["psnr_val"]))

    # fallback tier: K5 forward + backward for the coarse field, K2 for the fine
    tier_ms = {}
    opt.tpu.fused_raymarch_full = False
    # (one pack per field per optimizer step; the first step's weights were
    # packed by the validation render when no step came between)
    tier_packs = (2 * (FINE_TIER_STEPS - 1), 2 * FINE_TIER_STEPS)
    tier_ms["fallback"] = _tier_steps(system, first)
    window("fallback", {"k2": FINE_TIER_STEPS, "k5_fwd": FINE_TIER_STEPS,
                        "k5_bwd": FINE_TIER_STEPS}, tier_packs)
    # MLP-only tier: K1 forward + backward per field
    opt.tpu.fused_pe = False
    tier_ms["mlp"] = _tier_steps(system, first)
    window("mlp", {"k1_fwd": 2 * FINE_TIER_STEPS, "k1_bwd": 2 * FINE_TIER_STEPS},
           tier_packs)
    opt.tpu.fused_pe, opt.tpu.fused_raymarch_full = True, True

    print("fine: loss_render {:.5f} -> {:.5f}, loss_render_fine {:.5f} -> {:.5f} in {} "
          "steps; val PSNR {:.2f} dB (fine field), evaluation PSNR {:.2f} dB, SSIM "
          "{:.4f}".format(first["loss_render"], last["loss_render"], first["loss_render_fine"],
                          last["loss_render_fine"], FINE_STEPS, res["psnr_val"],
                          results["PSNR"], results["SSIM"]))
    print("fine: launches {}; weight packs {}; default tier {:.2f} ms/step (median of steps "
          "10-{}), {:.0f} rays/s; fallback tier {:.2f} ms/step, MLP-only tier {:.2f} ms/step "
          "(median of {}); val render {:.2f} s, evaluation {:.2f} s per view; card: {}".format(
              total, packs, ms_step, FINE_STEPS, opt.nerf.rand_rays / (ms_step / 1e3),
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


# K6's output-bias gradients on cancelling terms: with every output layer
# lin{b}_{a,b}_1 zero (as at init) the warp is the identity and, in block i
# with focus axis f and other axes o0, o1, db1_a = -sum g[..., f] and
# db1_b[1:] = -sum g[..., o0], -sum g[..., o1] over all points, exactly. The
# cotangent g is a multiple of 2^-INN_SUM_BITS under 16 whose columns sum to
# INN_SUM_CANCEL of the sum of their |terms|, so every partial sum is exact
# in float64 and the reference is the exact sum rounded once to fp32: K6 must
# equal it bit for bit.
INN_SUM_BITS = 20
INN_SUM_CANCEL = 1e-3
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


def inn_bias_sum_check(device):
    """K6's nine output-bias gradient entries against the exact sums they
    are (INN_SUM_BITS above) at the flagship's warp shape, beside the kernel's
    plain version's; raises unless K6 equals each bit for bit."""
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_inn as fi
    _, B, N, d_feat, _ = INN_CASES[0]
    alpha = 0.37
    net, code, pts = inn_setup(B, N, d_feat, 104, device)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "_1." in name:
                p.zero_()
    g = torch.Generator().manual_seed(11)
    units = torch.round(torch.randn(B * N, 3, generator=g, dtype=torch.float64)
                        * 2.0 ** INN_SUM_BITS)
    units -= torch.floor(units.mean(dim=0))
    units += torch.round(INN_SUM_CANCEL * units.abs().mean(dim=0))
    cot = (units / 2.0 ** INN_SUM_BITS).float().reshape(B, N, 3).to(device)
    exact = -(units.sum(dim=0) / 2.0 ** INN_SUM_BITS)          # [3], float64
    names = [n for n, _ in net.named_parameters()]
    ulps = {}
    for which in ("kernel", "plain"):
        out = inn_forward(which, net, code, pts, alpha)
        check(torch.equal(out, pts), "the warp with zero output layers is not the identity")
        grads = dict(zip(names, torch.autograd.grad(out, list(net.parameters()), cot)))
        worst = 0.0
        for i, (fx, (oa, ob)) in enumerate(fi._BLOCK_AXES):
            for got, axis in ((grads["lin{}_a_1.bias".format(i)][0], fx),
                              (grads["lin{}_b_1.bias".format(i)][1], oa),
                              (grads["lin{}_b_1.bias".format(i)][2], ob)):
                ref = exact[axis].float()
                ulp = float(torch.nextafter(ref.abs(), torch.tensor(math.inf)) - ref.abs())
                worst = max(worst, abs(float(got) - float(ref)) / ulp)
        ulps[which] = worst
    print("kernels: K6 output-bias gradients on cancelling terms at [{},{},3]: largest miss "
          "of the exact sum rounded to fp32, in its ulps: kernel {:.0f}, plain version {:.0f} "
          "(|sum| / sum of |terms|: {:.1e})".format(
              B, N, ulps["kernel"], ulps["plain"],
              float(exact.abs().max() / units.abs().sum(dim=0).max() * 2.0 ** INN_SUM_BITS)))
    check(ulps["kernel"] == 0, "K6's output-bias gradients miss their exact sums by {:.0f} "
          "ulps".format(ulps["kernel"]))


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


def inn_kernels_per_call(net, code, pts, alpha):
    """(forward, backward): the device kernels of one K6 forward and of one
    K6 backward launch sequence, counted from a torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_inn as fi
    counts = []
    with torch.no_grad():
        rw1, rw2 = fi.row_windows(pts.shape[1], alpha, pts.device)
        codes = fi.block_codes(net, code).contiguous()
        leaves = [l.detach().contiguous() for l in fi.leaves_of(net)]
        g = torch.ones_like(pts)
        _, prep = fi.launch_inn_fwd(pts, rw1, rw2, codes, leaves)
        for fn in (lambda: fi.launch_inn_fwd(pts, rw1, rw2, codes, leaves),
                   lambda: fi.launch_inn_bwd(pts, rw1, rw2, codes, leaves, prep, g)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            counts.append(sum(1 for e in prof.events()
                              if e.device_type == DeviceType.CUDA and "niw::inn::" in e.name))
    return counts


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
    # and at the 4096-point shape: one image, 256 backward CTAs
    _, B4, N4, d4, _ = INN_CASES[3]
    fwd["device_ms_4096"], bwd["device_ms_4096"] = inn_device_ms(
        *inn_setup(B4, N4, d4, 103, device), alpha)
    fwd["kernels_per_call"], bwd["kernels_per_call"] = inn_kernels_per_call(net, code, pts, alpha)
    check(1 <= fwd["kernels_per_call"] <= 2 and 1 <= bwd["kernels_per_call"] <= 2,
          "K6 launches {} kernels forward and {} backward (at most 2 each)".format(
              fwd["kernels_per_call"], bwd["kernels_per_call"]))
    leaves = fi.leaves_of(net)
    codes = torch.empty(3, B, d_feat, device="meta")
    rw = torch.empty(N, device="meta")
    prep = torch.empty(build.load_library().lib.niw_inn_prep_floats(B, N), device="meta")
    flops = 2 * (B * N * INN_MACS_PER_POINT + B * d_feat * INN_MACS_PER_IMAGE_AND_LATENT_DIM)
    fwd["bound_ms"], fwd["bound_by"] = bound(flops, [pts, rw, rw, codes] + leaves, [pts, prep])
    # the recomputed pre-activations, the input-gradient and the weight-gradient products
    bwd["bound_ms"], bwd["bound_by"] = bound(
        3 * flops, [pts, pts, rw, rw, codes, prep] + leaves, [pts, codes] + leaves)
    print("kernels: K6 at [{},{},3] x {} latent dims, alpha {}, through the wrapper (host "
          "included): forward {:.4f} ms (plain version {:.4f}, chain {:.4f}); backward alone "
          "{:.4f} ms (plain version {:.4f}, chain {:.4f}); forward + backward {:.4f} ms (plain "
          "version {:.4f}, chain {:.4f}); the launch sequences alone, replayed from a CUDA "
          "graph: forward {:.4f} ms (bound {:.5f}), backward {:.4f} ms (bound {:.5f}), at "
          "[1,4096,3] forward {:.4f} ms, backward {:.4f} ms; kernels per launch sequence: forward "
          "{}, backward {}; card: {}".format(
              B, N, d_feat, alpha, fwd["ms"], fwd["plain_ms"], fwd["chain_ms"],
              bwd["ms"], bwd["plain_ms"], bwd["chain_ms"],
              bwd["fwd_bwd_ms"], bwd["fwd_bwd_plain_ms"], bwd["fwd_bwd_chain_ms"],
              fwd["device_ms"], fwd["bound_ms"], bwd["device_ms"], bwd["bound_ms"],
              fwd["device_ms_4096"], bwd["device_ms_4096"], fwd["kernels_per_call"],
              bwd["kernels_per_call"], card_line()))
    check(not failures, "kernel and plain version disagree: {}".format(failures))
    inn_bias_sum_check(device)
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
    from neural_invertible_warp_tpu_torch.ops.cuda import build
    from neural_invertible_warp_tpu_torch.ops.cuda import correlation as k7
    lib = build.load_library().lib
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
        for w, k in enumerate(("k7_fwd", "k7_adj", "k7_adj_f2")):   # CTAs of one launch
            t[k]["ctas"] = lib.niw_corr_ctas(w, B, C, H, W)
        if i == 0:      # the library route computes the same functions
            compare("unfold+einsum", k7_library(f1, f2), plain.local_correlation(f1, f2),
                    TOL_K7, failures)
            compare("unfold+einsum adj", k7_library_adjoint(m, f2),
                    plain.local_correlation_transpose(m, f2), TOL_K7, failures)
        for key, name in (("k7_fwd", "forward"), ("k7_adj", "adjoint in f1"),
                          ("k7_adj_f2", "adjoint in f2")):
            r = t[key]
            print("  {:<14} {:.4f} ms (wrapper {}), plain version {:.4f} ms, unfold + einsum "
                  "(two calls) {}, bound {:.5f} ms ({}); graph replay; {} CTAs".format(
                      name, r["ms"], "{:.4f}".format(r["wrapper_ms"]) if "wrapper_ms" in r
                      else "-", r["plain_ms"], "{:.4f} ms".format(r["library_ms"])
                      if "library_ms" in r else "-", r["bound_ms"], r["bound_by"], r["ctas"]))
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
    print("kernels: K7 per shape, forward / adjoint in f1 / adjoint in f2, ms by CUDA graph "
          "replay (CTAs per launch; bound ms): " + "; ".join(
              "{} {:.4f} / {:.4f} / {:.4f} ({} / {} / {}; {:.5f})".format(
                  shape, r["ms"], records["k7_adj"]["by_shape"][shape]["ms"],
                  adj2["by_shape"][shape]["ms"], r["ctas"],
                  records["k7_adj"]["by_shape"][shape]["ctas"], adj2["by_shape"][shape]["ctas"],
                  r["bound_ms"])
              for shape, r in records["k7_fwd"]["by_shape"].items()))
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
    # device time of one 480x640 pair: the durations of its device operations
    # in a torch.profiler trace (once more, after the counts were read)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    s, i, j = pairs[1]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        matcher(i, j, s["image"][i], s["image"][j])
        torch.cuda.synchronize()
    busy = {"all": 0.0, "k7": 0.0}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and "#" not in evt.name:
            busy["all"] += evt.time_range.elapsed_us() / 1e3
            if "niw::corr::" in evt.name:
                busy["k7"] += evt.time_range.elapsed_us() / 1e3

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
          "pairs 2-{}, first {:.1f} ms), {:.1f} ms at {}x{}; device time per 480x640 pair "
          "{:.3f} ms, K7 and its adjoint {:.3f} ms of it (torch.profiler); kernel vs plain "
          "route: flow {:.2e} of max (tol {:.0e}), P_R {:.2e} (tol {:.0e}); card: {}".format(
              launches, K7_FWD_PER_PAIR, K7_ADJ_PER_PAIR, ms, len(pairs) - 1,
              seconds[0] * 1e3, seconds[-1] * 1e3, *PDCNET_DTU_HW, busy["all"], busy["k7"],
              worst["flow"], TOL_PDCNET_FLOW, worst["p_r"], TOL_PDCNET_PR, card_line()))
    check(not failures, "kernel and plain routes of the matcher disagree: {}".format(failures))
    return launches


# ------------------------------------- the SfM pose initialisation (DTU)

def sfm_ring_poses(n_views, H, W, seed=0, n_ring=49):
    """The middle n_views of tests/test_sfm_scale.py's DTU-like inward arc of
    n_ring views (so a cut keeps the views' spacing): w2c poses (OpenCV
    axes) and intrinsics at SFM_FOCAL for a width of 400."""
    rng = np.random.RandomState(seed)
    poses = []
    for i in range(n_ring):
        theta = np.deg2rad(-40 + 80 * i / (n_ring - 1))
        phi = np.deg2rad(20 + 12 * np.sin(3.0 * theta) + 2 * rng.randn())
        r = 3.2 + 0.12 * rng.randn()
        eye = np.array([r * np.sin(theta) * np.cos(phi), r * np.sin(phi),
                        -r * np.cos(theta) * np.cos(phi)])
        target = np.array([0.05 * rng.randn(), 0.05 * rng.randn(), 0.0])
        z = target - eye
        z = z / np.linalg.norm(z)
        x = np.cross(z, np.array([0.0, 1.0, 0.0]))
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        poses.append(np.concatenate([R, (-R @ eye)[:, None]], axis=1))
    first = (n_ring - n_views) // 2
    poses = poses[first:first + n_views]
    f = SFM_FOCAL * W / 400.0
    intr = np.tile(np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32),
                   (n_views, 1, 1))
    return np.stack(poses).astype(np.float32), intr


def blob_render(pose_w2c, intr, H, W, blob, backdrop, device, chunk=4096):
    """The SfM scene's render, ``evidence.scenes.render_blobs`` at 192
    samples over [1.5, 7.0] in chunks of ``chunk`` rays: (rgb, depth,
    opacity). tools/sfm_smoke_bounds.py renders on the CPU through it with
    smaller chunks."""
    from neural_invertible_warp_tpu_torch.evidence.scenes import render_blobs
    return render_blobs(pose_w2c, intr, H, W, blob, depth_range=(1.5, 7.0),
                        backdrop=backdrop, device=device,
                        max_elems=chunk * 192 * len(blob["s"]))


def make_sfm_scene(H, W, n, device):
    """tests/test_sfm_scale.py's ring scene as DTU arrays (the layout of
    make_dtu_scene): n views of 80 small opaque blobs before a wall at z 1.8
    with 800 colour spots, from sfm_ring_poses; GT depth from the render,
    valid everywhere, the blobs' opacity above 0.5 as the foreground mask;
    the loader's depth range [1.2, 5.2]."""
    from neural_invertible_warp_tpu_torch.evidence.scenes import backdrop_params, blob_params
    poses, intr = sfm_ring_poses(n, H, W)
    blob = blob_params(seed=7, n_blobs=80, radius=1.5, axis_scale=(1.3, 1.0, 1.4),
                       s_range=(0.03, 0.07))
    blob["a"] = blob["a"] * 40.0          # opaque: first-hit anchoring
    bd = backdrop_params(point=(0, 0, 1.8), normal=(0, 0, -1), seed=11)
    trng = np.random.RandomState(13)
    n_spots = 800
    bd["spot_uv"] = (trng.rand(n_spots, 2).astype(np.float32) - 0.5) * 14.0
    bd["spot_s"] = (0.015 + 0.025 * trng.rand(n_spots)).astype(np.float32)
    bd["spot_c"] = ((trng.rand(n_spots, 3) - 0.5) * 2.0).astype(np.float32)
    rgb, depth, opacity = blob_render(poses, intr, H, W, blob, bd, device)
    return dict(image=rgb, pose=poses, intr=intr, depth_gt=depth,
                valid_depth_gt=np.ones_like(depth), fg_mask=(opacity > 0.5).astype(np.float32),
                idx=np.arange(n, dtype=np.int32),
                depth_range=np.tile(np.array([[1.2, 5.2]], np.float32), (n, 1)))


def sfm_stage_line(stages):
    """The host seconds of the SfM's stages (``sfm.stage_seconds``; matching
    apart), summed over their entries, largest first."""
    sums = sorted(((sum(v), k) for k, v in stages.items() if k != "matching"), reverse=True)
    return ", ".join("{} {:.2f}".format(k, t) for t, k in sums)


def phase_pose_init_sfm(device):
    """Path pose_init_sfm: (a) barf_inn_dtu at full width from pose.init:
    colmap with the ZNCC matcher on SFM_VIEWS rendered 300x400 views, then
    SFM_STEPS train steps, and K2 on the batch of the next step against its
    plain version; (b) PDC-Net on random weights into compute_sfm_poses on
    SFM_PDCNET_VIEWS of those views. Returns (launch counts of the path, not
    those of the comparisons; K2's times and error at the path's batch)."""
    from neural_invertible_warp_tpu_torch.barf_inn_dtu import barf_inn_dtu_options
    from neural_invertible_warp_tpu_torch.config import process_options
    from neural_invertible_warp_tpu_torch.models.dtu import InnDTUSystem
    from neural_invertible_warp_tpu_torch.models.engine import Trainer
    from neural_invertible_warp_tpu_torch.ops import align
    from neural_invertible_warp_tpu_torch.ops.pdcnet.pdcnet import PDCNet
    from neural_invertible_warp_tpu_torch.utils import colmap_init, matchers, sfm, sfm_native
    H, W = SFM_HW
    t_path = t0 = time.time()
    scene = make_sfm_scene(H, W, SFM_VIEWS, device)
    torch.cuda.synchronize()
    render_seconds = time.time() - t0
    check(np.isfinite(scene["image"]).all() and scene["image"].std() > 0.05,
          "the capture is not a textured image set")
    # the reconstruction runs on the native core (utils/sfm.py::_native)
    sfm_native.reset_cache()
    check(sfm_native.available(), "the native SfM core did not build: g++ -> {}".format(
        sfm_native.LIBRARY))
    check(sfm_native.LIBRARY.startswith(os.path.join(HERE, "build")), sfm_native.LIBRARY)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for the ZNCC matmul")

    # (a) the SfM init through the system, then train steps on K2
    opt = barf_inn_dtu_options()
    opt.pose.init = "colmap"
    opt.pose.sfm.matcher = "zncc"
    opt.freq.early_termination = SFM_STEPS
    opt.output_root = os.path.join(HERE, "build", "chip_smoke_run_sfm")
    process_options(opt)
    check((opt.H, opt.W) == SFM_HW, (opt.H, opt.W))
    print("sfm: barf_inn_dtu from pose.init colmap (matcher {}), {} views at {}x{} rendered "
          "on the card in {:.1f} s; {} train steps".format(
              opt.pose.sfm.matcher, SFM_VIEWS, H, W, render_seconds, SFM_STEPS))
    reset_counts()
    trainer = Trainer(opt, device)
    t0 = time.time()
    with sfm.stage_seconds() as stages:
        # two of the views stand in for the held-out set: no validation runs
        trainer.build_system(scene, {k: v[:2] for k, v in scene.items()})
    init_seconds = time.time() - t0
    system = trainer.system
    check(type(system) is InnDTUSystem, type(system))
    zncc = colmap_init.get_matcher(opt.pose.sfm.matcher, device=system.device)
    check(type(zncc) is matchers.ZnccMatcher and zncc.device == device,
          "pose.sfm.matcher resolves to {} on {}".format(type(zncc).__name__, zncc.device))
    launches_init = {k: v for k, v in field_counts().items() if v}
    check(not launches_init, "the SfM init launched {}".format(launches_init))
    valid, excluded = system.sfm_valid_idx, system.sfm_excluded
    check(sorted(valid + excluded) == list(range(SFM_VIEWS)), (valid, excluded))
    check(len(valid) >= SFM_MIN_REGISTERED, "registered {} of {} views (excluded {})".format(
        len(valid), SFM_VIEWS, excluded))
    initial = system.aux["initial_poses_w2c"].clone()
    check(bool(torch.isfinite(initial).all()), "non-finite initial poses")
    va = np.asarray(valid)
    R_err, t_err = align._pose_errors_np(initial.cpu().numpy()[va], scene["pose"][va])
    rot_deg, trans = float(np.rad2deg(R_err.mean())), float(t_err.mean())
    pair_s = stages["matching"]
    print("sfm: {} ZNCC pairs (retrieval), {:.2f} ms per pair on the card (median; first "
          "{:.1f} ms), {:.1f} s in all; registered {} of {} (excluded {}); aligned rotation "
          "error {:.3f} deg (bound {}), translation {:.4f} (bound {}); card: {}".format(
              len(pair_s), statistics.median(pair_s) * 1e3, pair_s[0] * 1e3, sum(pair_s),
              len(valid), SFM_VIEWS, excluded, rot_deg, SFM_MAX_ROT_DEG, trans, SFM_MAX_TRANS,
              card_line()))
    print("sfm: host seconds by stage: {}; set_initial_poses {:.2f} s in all (native core "
          "{})".format(sfm_stage_line(stages), init_seconds,
                       os.path.relpath(sfm_native.LIBRARY, HERE)))
    check(rot_deg < SFM_MAX_ROT_DEG and trans < SFM_MAX_TRANS,
          "aligned SfM pose errors {:.3f} deg / {:.4f} over their bounds".format(rot_deg, trans))
    trainer.train()
    launches = {k: v for k, v in field_counts().items() if v}
    check(launches == {"k2": SFM_STEPS}, launches)
    losses = torch.stack([torch.stack([m[k] for k in sorted(m)]) for m in trainer.history])
    check(bool(torch.isfinite(losses).all()), "non-finite loss")
    check(torch.equal(system.aux["initial_poses_w2c"], initial), "the SfM start moved")
    ms = statistics.median(trainer.step_seconds[2:]) * 1e3
    print("sfm: loss_render {:.5f} -> {:.5f} in {} steps, {:.2f} ms/step (median of steps "
          "3-{}); launches {}".format(float(trainer.history[0]["loss_render"]),
                                      float(trainer.history[-1]["loss_render"]), SFM_STEPS,
                                      ms, SFM_STEPS, launches))
    # K2 at this path's batch: every view draws rand_rays // SFM_VIEWS rays
    inputs, kw = dtu_k2_batch(system)
    mlp = system.graph.nerf
    weight = 10.0 ** float(opt.loss_weight.render)
    names = ["d" + n.replace("mlp_", "") for n, _ in mlp.named_parameters()]
    sq, out, grads = k2_wrapper(mlp, *inputs, kw, weight)
    sq_ref, out_ref, grads_ref = k2_plain(mlp, *inputs, kw, weight)
    sq64, out64, grads64 = k2_f64(mlp, *inputs, kw, weight)
    failures, errs = [], {}
    for key in ("rgb", "depth", "opacity"):
        errs[key] = compare(key, out[key], out_ref[key], TOL["value"], failures, out64[key])
    errs["sq_sum"] = compare("sq_sum", sq, sq_ref, TOL["value"], failures, sq64)
    for name, gk, gr, g64 in zip(["dcenter", "dray"] + names, grads, grads_ref, grads64):
        errs[name] = compare(name, gk, gr, TOL["grad"], failures, g64, TOL_SFM_K2_VS_F64)
    print("sfm: K2 wrapper on the batch of step {} ({} rays x {} metric depths; mean "
          "opacity {:.3f}, max |dcenter| {:.2e}) against its plain version, max abs errors: "
          "rgb {:.1e}, depth {:.1e}, opacity {:.1e}, sq_sum {:.1e}, dcenter {:.1e}, dray "
          "{:.1e}, weights {:.1e} (tolerances {}, gradients also against float64 at {} x the "
          "plain version's distance)".format(
              system.step, list(inputs[0].shape[:2]), inputs[2].shape[2],
              float(out_ref["opacity"].mean()), float(grads_ref[0].abs().max()), errs["rgb"],
              errs["depth"], errs["opacity"], errs["sq_sum"], errs["dcenter"], errs["dray"],
              max(errs[n] for n in names), TOL, TOL_SFM_K2_VS_F64))
    check(not failures, "SfM path: K2 and its plain version disagree: {}".format(failures))
    k2 = dict(ms_sfm=time_ms(fresh_k2_weights(lambda: k2_wrapper(mlp, *inputs, kw, weight))),
              plain_ms_sfm=time_ms(lambda: k2_plain(mlp, *inputs, kw, weight)),
              max_abs_err_sfm=errs["rgb"])
    print("sfm: K2 at {}x{} {:.3f} ms (plain {:.3f}); card: {}".format(
        list(inputs[0].shape[:2]), inputs[2].shape[2], k2["ms_sfm"], k2["plain_ms_sfm"],
        card_line()))
    del trainer, system, mlp
    torch.cuda.empty_cache()

    # (b) PDC-Net (random weights) into the same pipeline
    net = PDCNet(torch.Generator().manual_seed(0))
    matcher = matchers.PdcNetMatcher(net, min_confidence=PDCNET_MIN_CONFIDENCE)
    check(matcher.device == device, matcher.device)
    views = np.linspace(0, SFM_VIEWS - 1, SFM_PDCNET_VIEWS).round().astype(int)
    c2w = align._np_invert_pose(scene["pose"][views])
    pairs = matchers.nearest_pose_pairs(c2w, PDCNET_NEIGHBOURS)
    reset_counts()
    t0 = time.time()
    with sfm.stage_seconds() as stages_b:
        poses, valid_b, excluded_b = colmap_init.compute_sfm_poses(
            scene["image"][views], scene["intr"][views],
            matcher=matcher, pairs=pairs)
    seconds_b = time.time() - t0
    launches_b = {k: v for k, v in field_counts().items() if v}
    check(launches_b == {"k7_fwd": K7_FWD_PER_PAIR * len(pairs),
                         "k7_adj": K7_ADJ_PER_PAIR * len(pairs)},
          "launches {} for {} pairs".format(launches_b, len(pairs)))
    check(poses.shape == (SFM_PDCNET_VIEWS, 3, 4) and poses.dtype == np.float32
          and np.isfinite(poses).all(), (poses.shape, poses.dtype))
    check(sorted(valid_b + excluded_b) == list(range(SFM_PDCNET_VIEWS)), (valid_b, excluded_b))
    pair_s = stages_b["matching"]
    check(len(pair_s) == len(pairs), "{} matcher calls for {} pairs".format(
        len(pair_s), len(pairs)))
    print("sfm: PDC-Net (random weights) over {} pose-nearest pairs of {} views: {:.1f} ms per "
          "pair (median; first {:.1f} ms); registered {} (excluded {}); host seconds by stage: "
          "{}; {:.1f} s in all; launches {}; card: {}".format(
              len(pairs), SFM_PDCNET_VIEWS, statistics.median(pair_s) * 1e3, pair_s[0] * 1e3,
              len(valid_b), excluded_b, sfm_stage_line(stages_b), seconds_b, launches_b,
              card_line()))
    print("sfm: path pose_init_sfm {:.1f} s wall".format(time.time() - t_path))
    return {k: launches.get(k, 0) + launches_b.get(k, 0)
            for k in {**launches, **launches_b}}, k2


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
    ortho = pose_readout_orthonormality(system.aux["global_rigid"])
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


# ------------------------------------------------ the GARF and planar paths

def no_launches(label):
    """Every kernel counter, and K2's weight packs, still 0."""
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    counts = field_counts()
    check(not any(counts.values()) and fp.fused_render_rays_pe_train.packs == 0,
          "{}: a kernel launched: {}".format(label, counts))
    return {k: 0 for k in counts}


def garf_options(model, steps, out, **init):
    from neural_invertible_warp_tpu_torch.config import process_options
    from neural_invertible_warp_tpu_torch.garf_llff import garf_llff_options
    opt = garf_llff_options(model)
    opt.data.image_size = list(IMAGE_HW)
    opt.freq.early_termination = steps
    opt.freq.val = opt.freq.ckpt = 10 ** 6
    opt.init.update(init)
    opt.output_root = os.path.join(HERE, "build", out)
    return process_options(opt)


def garf_step_grads(system, ray_idx, depth_rand):
    """(loss, {name: grad}) of one step's loss on the given rays and depth
    draws, without an optimizer step."""
    system.optim.zero_grad()
    out, target, extras = system._forward_train(ray_idx, system.step, depth_rand)
    loss = system.summarize_loss(system.compute_loss(out, target, extras))
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in system.graph.named_parameters()}
    system.optim.zero_grad()
    return loss.detach(), grads


def garf_step0_vs_cpu(system, arrays, failures):
    """Step 0's loss and every gradient leaf on the card against the same
    step on the CPU (a system built from the same seed: the same weights),
    on a sub-batch of GARF_CPU_RAYS rays per image, beside a float64 copy on
    the CPU. Returns the largest error over max of any leaf."""
    from neural_invertible_warp_tpu_torch.models import get_system_class
    from neural_invertible_warp_tpu_torch.ops import sampling
    opt = system.opt
    cpu = get_system_class(opt.model)(opt, "cpu")
    cpu.attach_data(*arrays)
    cpu.init_state(opt.seed or 0)
    f64 = get_system_class(opt.model)(opt, "cpu")
    f64.attach_data(*[{k: v.astype(np.float64) if v.dtype == np.float32 else v
                       for k, v in a.items()} for a in arrays])
    f64.init_state(opt.seed or 0)
    f64.graph.double()
    for (name, a), b in zip(system.graph.state_dict().items(), cpu.graph.state_dict().values()):
        check(torch.equal(a.cpu(), b), "{}: the CPU system's init differs".format(name))
    g = torch.Generator().manual_seed(11)
    ray_u = torch.rand(GARF_CPU_RAYS, generator=g)
    depth_rand = torch.rand(system.n_train, GARF_CPU_RAYS, opt.nerf.sample_intvs, 1,
                            generator=g)
    idx = sampling.sample_ray_subset(system.HW, GARF_CPU_RAYS, u=ray_u)
    print("  step 0 on {} x {} rays: \"kernel\" is the card's float32 (the plain chain), "
          "\"plain\" the CPU's".format(system.n_train, GARF_CPU_RAYS))
    loss, grads = garf_step_grads(system, idx.to(system.device), depth_rand.to(system.device))
    loss_c, grads_c = garf_step_grads(cpu, idx, depth_rand)
    loss_64, grads_64 = garf_step_grads(f64, idx, depth_rand.double())
    compare("step-0 loss", loss.cpu(), loss_c, TOL["value"], failures)
    return hold_leaves(grads, grads_c, grads_64, failures)


def hold_leaves(grads, grads_c, grads_64, failures):
    """Every leaf of ``grads`` (the card's) against the CPU's ``grads_c`` to
    TOL["grad"] of its max or, where it misses, no farther from the float64
    ``grads_64`` than TOL_SFM_K2_VS_F64 times the farthest any leaf of the
    CPU's lies from it. Returns the largest error over max of any leaf."""
    def from_f64(t, name):
        f64 = grads_64[name]
        return float((t.double() - f64).abs().max()) / max(float(f64.abs().max()), 1e-300)
    noise = max(from_f64(g, name) for name, g in grads_c.items())
    worst = 0.0
    for name, got in grads.items():
        missed = []
        err = compare(name, got.cpu(), grads_c[name], TOL["grad"], missed, f64=grads_64[name])
        worst = max(worst, err / max(float(grads_c[name].abs().max()), 1e-30))
        if missed:
            dist = from_f64(got.cpu(), name)
            ok = dist <= TOL_SFM_K2_VS_F64 * noise
            print("    missed {:.0e}: {:.3e} from float64 against the CPU step's fp32 noise "
                  "{:.3e} (gate {} x): {}".format(TOL["grad"], dist, noise, TOL_SFM_K2_VS_F64,
                                                  "ok" if ok else "FAIL"))
            if not ok:
                failures.append(name)
    return worst


def phase_garf(device):
    """Path garf: garf trained GARF_STEPS steps through the Trainer, one view
    validated and evaluated with test-time refinement, GARF_SHORT_STEPS steps
    each of nerf_gaussian and garf_se3_field, and garf from the GT poses
    with a pose warmup; step 0 of the first three against the CPU; no kernel
    launches. Returns the path's launch counts (all 0)."""
    from neural_invertible_warp_tpu_torch.models.engine import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False    # this path bypasses train.py
    torch.backends.cudnn.allow_tf32 = False
    H, W = IMAGE_HW
    arrays = (make_scene(H, W, N_TRAIN, seed=0), make_scene(H, W, N_VAL, seed=1))
    reset_counts()
    summary, failures = {}, []
    for model, steps in (("garf", GARF_STEPS), ("nerf_gaussian", GARF_SHORT_STEPS),
                         ("garf_se3_field", GARF_SHORT_STEPS)):
        opt = garf_options(model, steps, "chip_smoke_run_" + model)
        trainer = Trainer(opt, device)
        trainer.build_system(*arrays)
        system = trainer.system
        a = opt.arch
        print("garf: {} at {}x{} (trunk {}x{}, skip {}, sigma {}, {} samples, {} rays), {} "
              "train views at {}x{}, {} steps{}".format(
                  model, a.depth, a.width, a.depth, a.width, list(a.skip), a.gaussian.sigma,
                  opt.nerf.sample_intvs, opt.nerf.rand_rays, N_TRAIN, H, W, steps,
                  "; warp MLP {} skip {} {} sigma {}".format(
                      list(a.layers_warp), list(a.skip_warp), a.actfn_warp, a.sigma_warp)
                  if model == "garf_se3_field" else ""))
        check(system._field_mode() == "off", "the Gaussian field must take the plain chain")
        worst = garf_step0_vs_cpu(system, arrays, failures)
        trainer.train()
        losses = torch.stack([m["loss_render"] for m in trainer.history])
        check(bool(torch.isfinite(torch.stack([m["loss_all"] for m in trainer.history])).all()),
              "{}: non-finite loss".format(model))
        first, last = float(losses[:5].mean()), float(losses[-5:].mean())
        check(last < first, "{}: loss did not fall: {} -> {}".format(model, first, last))
        ms = statistics.median(trainer.step_seconds[5:]) * 1e3
        rays = N_TRAIN * (opt.nerf.rand_rays // N_TRAIN)
        line = "garf: {} loss_render {:.5f} -> {:.5f} (mean of the first and last 5 steps); " \
            "step 0 on the card against the CPU: largest leaf error {:.3e} of its max; " \
            "{:.2f} ms/step (median of steps 6-{}), {:.0f} rays/s".format(
                model, first, last, worst, ms, steps, rays / (ms / 1e3))
        if model != "nerf_gaussian":
            ortho = pose_readout_orthonormality(system.get_all_training_poses()[0])
            line += ", pose readout orthonormal to {:.1e}".format(ortho)
        print(line + "; card: " + card_line())
        summary[model] = dict(ms=ms, rays_per_s=rays / (ms / 1e3))
        if model == "garf":
            t0 = time.time()
            res = trainer.run_validation(system.step)
            torch.cuda.synchronize()
            val_seconds = time.time() - t0
            check(math.isfinite(res["psnr_val"]), res["psnr_val"])
            t0 = time.time()
            results = system.evaluate_full(dump_images=False)
            torch.cuda.synchronize()
            eval_seconds = time.time() - t0
            log = system.eval_log[0]
            refine = log["refine_losses"]
            check(refine.shape == (opt.optim.test_iter,) and bool(torch.isfinite(refine).all()),
                  "refinement losses")
            for key in ("PSNR", "SSIM", "rot_error_deg", "trans_error"):
                check(math.isfinite(results[key]), "{} = {}".format(key, results[key]))
            print("garf: validation {:.2f} s per view (PSNR {:.2f} dB); evaluated view {:.2f} s: "
                  "refinement {:.2f} s ({} iterations, {:.2f} ms each, loss {:.5f} -> {:.5f}), "
                  "render {:.2f} s; PSNR {:.2f} dB, SSIM {:.4f}, rot err {:.3f} deg".format(
                      val_seconds, res["psnr_val"], eval_seconds, log["refine_seconds"],
                      opt.optim.test_iter, log["refine_seconds"] / opt.optim.test_iter * 1e3,
                      float(refine[0]), float(refine[-1]), log["render_seconds"],
                      results["PSNR"], results["SSIM"], results["rot_error_deg"]))
            summary["garf"].update(val_seconds=val_seconds, eval_seconds=eval_seconds)
        del trainer, system
        torch.cuda.empty_cache()
    check(not failures, "the card's step 0 disagrees with the CPU's: {}".format(failures))

    # garf from the GT poses with a pose warmup: se3_refine's gradients are
    # zeroed (not skipped) for GARF_WARMUP updates
    opt = garf_options("garf", 3, "chip_smoke_run_garf_warmup", pose=True,
                       pose_warmup=GARF_WARMUP)
    trainer = Trainer(opt, device)
    trainer.build_system(*arrays)
    se3 = trainer.system.graph.se3_refine.weight
    trainer.train()
    held = float(se3.detach().abs().max())
    check(held == 0.0, "se3_refine moved during the warmup: {}".format(held))
    opt.freq.early_termination = 10
    trainer.train()
    moved = float(se3.detach().abs().max())
    check(moved > 0.0, "se3_refine did not move after the warmup")
    check(trainer.system.optim.count == 10, "Adam counted {} updates".format(
        trainer.system.optim.count))
    print("garf: init.pose with pose_warmup {}: max |se3_refine| {} after 3 steps, {:.3e} "
          "after 10".format(GARF_WARMUP, held, moved))
    del trainer
    torch.cuda.empty_cache()
    launches = no_launches("garf")
    print("garf: no kernel launched on the path ({})".format(
        ", ".join("{} 0".format(k) for k in sorted(launches))))
    return launches, summary


def make_planar_image(H, W, seed):
    """A smooth textured image [H,W,3] in [0,1]: a few random plane waves
    per channel."""
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    img = np.zeros((H, W, 3))
    for c in range(3):
        for _ in range(6):
            f = rng.uniform(1.0, 8.0, 2) * rng.choice([-1, 1], 2)
            img[..., c] += np.sin(2 * np.pi * (f[0] * xs + f[1] * ys) + rng.uniform(0, 6.3))
    return (0.5 + 0.5 * np.tanh(img / 3)).astype(np.float32)


def phase_planar(device):
    """Path planar: homography's step 0 and first steps on the card against
    the CPU's and a float64 run's, then its training, then img_relu; no
    kernel launches. Returns the path's launch counts (all 0)."""
    from neural_invertible_warp_tpu_torch.models import planar
    from neural_invertible_warp_tpu_torch.ops import warp2d
    from neural_invertible_warp_tpu_torch.planar_options import planar_options
    torch.backends.cuda.matmul.allow_tf32 = False    # this path bypasses train.py
    torch.backends.cudnn.allow_tf32 = False
    reset_counts()
    opt = planar_options("homography")
    H, W = opt.data.image_size
    image = make_planar_image(H, W, seed=0)
    print("planar: homography on a {}x{} image, {} patches of {}x{}, layers {}, L_2D {}, "
          "fix_first {}, {} steps".format(H, W, opt.batch_size, *opt.data.patch_crop,
                                          list(opt.arch.layers), opt.arch.posenc.L_2D,
                                          opt.warp.fix_first, PLANAR_STEPS))
    card = planar.PlanarSystem(opt, device, image=image)
    cpu = planar.PlanarSystem(planar_options("homography"), "cpu", image=image)
    f64 = planar.PlanarSystem(planar_options("homography"), "cpu", image=image)
    f64.image, f64.warp_pert, f64.xy_crop = (t.double() for t in (f64.image, f64.warp_pert,
                                                                   f64.xy_crop))
    f64.patches = planar.bilinear_sample(
        f64.image, warp2d.warp_grid(f64.xy_crop, f64.warp_pert, opt.warp.type), H, W)
    for system in (card, cpu, f64):
        system.init_state(opt.seed or 0)
    f64.graph.double()
    failures = []
    check(torch.equal(card.warp_pert.cpu(), cpu.warp_pert), "perturbations differ")
    compare("patches", card.patches.cpu(), cpu.patches, TOL["value"], failures)

    def step0_grads(system):
        system.optim.zero_grad()
        system.loss().backward()
        grads = {n: p.grad.detach().clone() for n, p in system.graph.named_parameters()}
        system.optim.zero_grad()
        return grads
    grads = [step0_grads(system) for system in (card, cpu, f64)]
    names = list(grads[1])
    for name in names:
        g_card, g_cpu, g_64 = (g[name].cpu().double() for g in grads)
        print("  {:<26} card - cpu: rel_l2 {:.3e}; max from float64: card {:.3e}, cpu "
              "{:.3e} of max".format(name, float(torch.linalg.norm(g_card - g_cpu))
                                     / float(torch.linalg.norm(g_cpu)),
                                     *(float((g - g_64).abs().max()) / float(g_64.abs().max())
                                       for g in (g_card, g_cpu))))
    compare_leaves("step-0 grads", names, [grads[0][n].cpu() for n in names],
                   [grads[1][n] for n in names], TOL_RELU_REL_L2, True, failures)
    err0 = card.corner_error()
    for it in range(PLANAR_CPU_STEPS):
        m, m_c, _ = card.train_step(), cpu.train_step(), f64.train_step()
        compare("step {} loss".format(it), m["loss_all"].cpu(), m_c["loss_all"], TOL["value"],
                failures)
        warps = [s_.graph.warp_param.detach().cpu().double() for s_ in (card, cpu, f64)]
        scale = float(warps[2].abs().max())
        print("  warps after step {}: card - cpu {:.3e}, card - float64 {:.3e}, cpu - float64 "
              "{:.3e} of max (not gated)".format(it + 1, *(
                  float((a - b).abs().max()) / scale
                  for a, b in ((warps[0], warps[1]), (warps[0], warps[2]),
                               (warps[1], warps[2])))))
    check(not failures, "the card's steps disagree with the CPU's: {}".format(failures))
    del cpu, f64
    torch.cuda.synchronize()
    t0 = time.time()
    history = [card.train_step()["loss_all"] for _ in range(PLANAR_STEPS - PLANAR_CPU_STEPS)]
    torch.cuda.synchronize()
    ms = (time.time() - t0) / len(history) * 1e3
    losses = torch.stack(history)
    check(bool(torch.isfinite(losses).all()), "homography: non-finite loss")
    err1 = card.corner_error()
    check(err1 < MAX_PLANAR_CORNER_SHARE * err0,
          "homography: corner error {} -> {}".format(err0, err1))
    print("planar: homography loss {:.5f} -> {:.5f}, corner error {:.5f} -> {:.5f} ({:.3f} of "
          "it; bound {}); {:.2f} ms/step (mean of {} steps, host clock); card: {}".format(
              float(losses[0]), float(losses[-1]), err0, err1, err1 / err0,
              MAX_PLANAR_CORNER_SHARE, ms, len(history), card_line()))
    del card

    opt = planar_options("img_relu")
    H, W = opt.data.image_size
    fit = planar.ImageFitSystem(opt, device, image=make_planar_image(H, W, seed=1))
    fit.init_state(opt.seed or 0)
    torch.cuda.synchronize()
    t0 = time.time()
    psnrs = torch.stack([fit.train_step()["psnr"] for _ in range(opt.max_iter)])
    torch.cuda.synchronize()
    ms_fit = (time.time() - t0) / opt.max_iter * 1e3
    check(bool(torch.isfinite(psnrs).all()), "img_relu: non-finite PSNR")
    p0, p1 = float(psnrs[:10].mean()), float(psnrs[-10:].mean())
    check(p1 > p0, "img_relu: PSNR did not rise: {} -> {}".format(p0, p1))
    print("planar: img_relu {}x{}, {} pixels a step, {}x{} ReLU: PSNR {:.2f} -> {:.2f} dB "
          "(mean of the first and last 10 steps of {}); {:.2f} ms/step".format(
              H, W, opt.train_samples, opt.relu.hidden_layers, opt.relu.hidden_features, p0, p1,
              opt.max_iter, ms_fit))
    launches = no_launches("planar")
    print("planar: no kernel launched on the path; card: {}".format(card_line()))
    return launches, dict(ms_homography=ms, ms_img_relu=ms_fit, corner_error=(err0, err1))


# ------------------------------------------------------------ the sharded path

class _Captured(Exception):
    """Raised by capture_call's stand-in once it holds the call's arguments."""


def capture_call(module, name, run):
    """(args, kwargs) of the first call of ``module.<name>`` that ``run()``
    makes. The stand-in raises before the call is made, so nothing launches
    and ``run`` goes no further (no collective is reached)."""
    real, seen = getattr(module, name), {}

    def stand_in(*args, **kw):
        seen.update(args=args, kw=kw)
        raise _Captured
    setattr(module, name, stand_in)
    try:
        run()
    except _Captured:
        pass
    finally:
        setattr(module, name, real)
    check("args" in seen, "{} was not called".format(name))
    return seen["args"], seen["kw"]


def hold_shard_kernels(job, final, device, failures):
    """K2 and K3 at each rank's share, through their wrappers, against their
    plain versions: K2 on the rank's rays of step 0 (its slice of the global
    draws, the warp's center/ray, as the sharded step hands them to K2) with
    the step's loss scale, K3 on the rank's half of the first render chunk at
    the weights after the run (``final``: rank 0's parameters and aux). The
    arguments are captured from the system's own calls under a group of one
    rank of SHARD_RANKS, which needs no process group: the capture stops
    before the first collective. Returns the largest rgb error of each."""
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    from neural_invertible_warp_tpu_torch.parallel import audit, mesh
    errs = {"k2": 0.0, "k3": 0.0}
    system = audit.build_system(job, device)
    system.seed_step()
    draws = system.draw_step()
    n_rays = draws[0].shape[0]
    mlp = system.graph.nerf
    names = ["d" + n.replace("mlp_", "") for n, _ in mlp.named_parameters()]
    for rank in range(SHARD_RANKS):
        with mesh.use_group(mesh.RayGroup(None, rank, SHARD_RANKS)):
            args, kw = capture_call(fp, "fused_render_rays_pe_train", lambda: (
                system._forward_train(draws[0], system.step, *draws[1:])))
        check(kw.get("noise") is None and kw.get("density_activ") == "softplus", kw)
        center, ray, depth, target = [t.detach() for t in args[1:]]
        B, R = depth.shape[:2]
        # the step's scale of this rank's squared error: 10^w over the global count
        weight = 10.0 ** float(system.opt.loss_weight.render) * R / n_rays
        print("  K2 wrapper at rank {}'s share of step 0 ({} rays x {} samples) against its "
              "plain version:".format(rank, [B, R], depth.shape[2]))
        sq, out, grads = k2_wrapper(mlp, center, ray, depth, target, kw, weight)
        sq_ref, out_ref, grads_ref = k2_plain(mlp, center, ray, depth, target, kw, weight)
        sq64, out64, grads64 = k2_f64(mlp, center, ray, depth, target, kw, weight)
        for key in ("rgb", "depth", "opacity"):
            err = compare(key, out[key], out_ref[key], TOL["value"], failures, out64[key])
            if key == "rgb":
                errs["k2"] = max(errs["k2"], err)
        compare("sq_sum", sq, sq_ref, TOL["value"], failures, sq64)
        for name, gk, gr, g64 in zip(["dcenter", "dray"] + names, grads, grads_ref, grads64):
            compare(name, gk, gr, TOL["grad"], failures, g64, TOL_SFM_K2_VS_F64)
    del system
    system = audit.build_system(dict(job, state_dict=final["params"], aux=final["aux"],
                                     step=SHARD_STEPS), device)
    mlp = system.graph.nerf
    pose, intr = system.test_data["pose"][:1], system.test_data["intr"][:1]
    for rank in range(SHARD_RANKS):
        with mesh.use_group(mesh.RayGroup(None, rank, SHARD_RANKS)):
            args, kw = capture_call(fp, "fused_render_rays_pe",
                                    lambda: system.render_image(pose, intr))
        center, ray, depth = args[1:]
        B, R, K_ = depth.shape[:3]
        print("  K3 wrapper at rank {}'s share of the first render chunk ({} rays x {} "
              "samples) against its plain version:".format(rank, [B, R], K_))
        with torch.no_grad():
            got = fp.fused_render_rays_pe(mlp, center, ray, depth, **kw)
            out8 = fp.render_rays_plain(mlp, center.reshape(B * R, 3), ray.reshape(B * R, 3),
                                        depth.reshape(B * R, K_), kw["progress"],
                                        kw["barf_c2f"], kw["density_activ"])
            ref = split_plain(out8, B, R, kw["bgcolor"] if kw["setbg_opaque"] else None)
        for key, g in zip(("rgb", "depth", "opacity"), got):
            err = compare(key, g, ref[key], TOL["value"], failures)
            if key == "rgb":
                errs["k3"] = max(errs["k3"], err)
    del system
    return errs


def phase_sharded(device):
    """Path sharded: the flagship's ray-sharded step and render in
    SHARD_RANKS processes on the one card (gloo), against one process on the
    same (seed, step) draws, and one step under an nccl group of one
    process against the step without a group. Returns the launch counts of
    the ranks, summed."""
    import datetime
    import tempfile
    import torch.distributed as dist
    from neural_invertible_warp_tpu_torch.config import process_options
    from neural_invertible_warp_tpu_torch.flagship import flagship_options
    from neural_invertible_warp_tpu_torch.parallel import audit, mesh
    opt = flagship_options()
    opt.data.image_size = list(IMAGE_HW)
    opt.output_root = os.path.join(HERE, "build", "chip_smoke_run_sharded")
    process_options(opt)
    H, W = IMAGE_HW
    job = dict(options=opt.to_plain(), train=make_scene(H, W, N_TRAIN, seed=0),
               test=make_scene(H, W, N_VAL, seed=1), seed=0, steps=SHARD_STEPS,
               grads_at=[0], render=[0])
    n_rays = opt.nerf.rand_rays // N_TRAIN
    print("sharded: barf_inn_llff flagship, {} ranks on one card (gloo), {} views at {}x{}, "
          "{} rays per view, {} steps".format(SHARD_RANKS, N_TRAIN, H, W, n_rays, SHARD_STEPS))
    t0 = time.time()
    ranks = [r[0] for r in audit.run([job], SHARD_RANKS, backend="gloo", device="cuda",
                                     timeout=300)]
    spawn_seconds = time.time() - t0
    one = audit.run_job(job, device)
    failures = []

    # losses of steps 0-2
    worst = 0.0
    for res in ranks:
        for step in range(3):
            for k, ref in one["metrics"][step].items():
                if k.startswith("loss_"):
                    got = res["metrics"][step][k]
                    worst = max(worst, 0.0 if got == ref else abs(got - ref) / abs(ref))
    print("  losses of steps 0-2, largest deviation from one process {:.3e} (rel)  tol {:.0e}  "
          "{}".format(worst, TOL_SHARD_LOSS, "ok" if worst < TOL_SHARD_LOSS else "FAIL"))
    if not worst < TOL_SHARD_LOSS:
        failures.append("losses")

    # the summed gradients of step 0, against one process and, where a leaf
    # misses, float64 on the CPU on the same draws
    as_t = lambda grads: {k: torch.as_tensor(v) for k, v in grads.items()}
    grads_1 = as_t(one["grads"][0])
    check(sorted(ranks[0]["grads"][0]) == sorted(grads_1), "gradient leaves differ")
    misses = [k for k, g in ranks[0]["grads"][0].items()
              if audit.max_rel(g, one["grads"][0][k]) > TOL["grad"]]
    grads_64 = None
    if misses:
        probe = audit.build_system(job, device)
        probe.seed_step()
        ray_idx, depth_rand, _ = probe.draw_step()
        del probe
        f64 = audit.build_system(dict(job, float64=True), "cpu")
        _, grads_64 = garf_step_grads(f64, ray_idx.cpu(), depth_rand.cpu().double())
        del f64
        print("  step-0 gradients: {} leaves miss {:.0e} of their max; float64 on the CPU "
              "on the step's draws".format(len(misses), TOL["grad"]))
    worst_grad = 0.0
    for r, res in enumerate(ranks):
        print("  step-0 gradient leaves of rank {} (summed) against one process:".format(r))
        grads = as_t(res["grads"][0])
        if grads_64 is None:
            for name, g in grads.items():
                compare(name, g, grads_1[name], TOL["grad"], failures)
                worst_grad = max(worst_grad, audit.max_rel(g, grads_1[name]))
        else:
            worst_grad = max(worst_grad, hold_leaves(grads, grads_1, grads_64, failures))

    # the two ranks' parameters and aux state after SHARD_STEPS steps
    same = all(np.array_equal(ranks[0]["params"][k], res["params"][k])
               for res in ranks[1:] for k in ranks[0]["params"])
    same = same and all(np.array_equal(ranks[0]["aux"][k], res["aux"][k])
                        for res in ranks[1:] for k in ranks[0]["aux"])
    print("  parameters and aux of the {} ranks after {} steps bit-identical: {}".format(
        SHARD_RANKS, SHARD_STEPS, same))
    if not same:
        failures.append("parameters across ranks")

    # the sharded render against one process rendering the same weights
    ref = audit.run_job(dict(job, state_dict=ranks[0]["params"], aux=ranks[0]["aux"],
                             step=SHARD_STEPS, steps=0), device)["renders"][0]
    exact = True
    for r, res in enumerate(ranks):
        for k, v in ref.items():
            got = res["renders"][0][k]
            exact = exact and np.array_equal(got, v)
            compare("render {} r{}".format(k, r), torch.as_tensor(got), torch.as_tensor(v),
                    TOL_SHARD_RENDER, failures)
    print("  sharded render bit-exact against one process: {}".format(exact))

    # K2 and K3 at the shapes the ranks gave them, against their plain versions
    shard_errs = hold_shard_kernels(job, ranks[0], device, failures)

    # one step under an nccl group of one process against no group
    base = dict(job, steps=1, render=[])
    plain = audit.run_job(base, device)
    with tempfile.TemporaryDirectory(prefix="niw_nccl_") as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "rdv"),
                                rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            backend = dist.get_backend()
            nccl = audit.run_job(base, device, mesh.make_group())
        finally:
            dist.destroy_process_group()
    nccl_equal = (nccl["metrics"] == plain["metrics"]
                  and all(np.array_equal(nccl["grads"][0][k], g)
                          for k, g in plain["grads"][0].items())
                  and all(np.array_equal(nccl["params"][k], p)
                          for k, p in plain["params"].items()))
    print("  nccl, world size 1 ({}): step 0 bit-equal to the step without a group: "
          "{}".format(backend, nccl_equal))
    if not nccl_equal:
        failures.append("nccl world size 1")

    n_chunks = -(-H * W // min(opt.nerf.rand_rays, H * W))
    for r, res in enumerate(ranks):
        counts = res["launches"]
        check(counts["train_k2"] == SHARD_STEPS and counts["render_k3"] == n_chunks
              and not counts["train_k6_fwd"],
              "rank {} launched {}".format(r, counts))
    launches = {"k2": sum(res["launches"]["train_k2"] for res in ranks),
                "k3": sum(res["launches"]["render_k3"] for res in ranks)}
    ms = [statistics.median(res["step_seconds"][5:]) * 1e3 for res in ranks]
    ms_one = statistics.median(one["step_seconds"][5:]) * 1e3
    print("sharded: {} ranks on {}: ms/step {} (median of steps 6-{}), render {} s per view; "
          "one process {:.2f} ms/step, {:.2f} s (two processes share one card: not a speed "
          "result); spawn and run {:.1f} s; launches per rank K2 {} K3 {}; card: {}".format(
              SHARD_RANKS, ranks[0]["device"], " / ".join("{:.2f}".format(m) for m in ms),
              SHARD_STEPS, " / ".join("{:.2f}".format(r["render_seconds"][0]) for r in ranks),
              ms_one, one["render_seconds"][0], spawn_seconds, SHARD_STEPS, n_chunks,
              card_line()))
    print("sharded: gates: losses {:.3e} (tol {:.0e}), step-0 leaves {:.3e} of max, "
          "ranks bit-identical {}, render bit-exact {}, nccl world size 1 bit-equal {}; "
          "K2 / K3 at the ranks' shares against their plain versions, rgb max abs errors "
          "{:.3e} / {:.3e}".format(worst, TOL_SHARD_LOSS, worst_grad, same, exact, nccl_equal,
                                   shard_errs["k2"], shard_errs["k3"]))
    check(not failures, "sharded path failed: {}".format(failures))
    return launches


# -------------------------------------------------- the quality harness

def on_all_cores(fn, *args, **kw):
    """``fn(*args, **kw)`` with torch's intra-op threads on every core (a
    render of a scene on the CPU to hold the card's against)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        return fn(*args, **kw)
    finally:
        torch.set_num_threads(threads)


def hold_scene(pairs, failures):
    """Each (label, card arrays, CPU arrays) of ``pairs``: the images in
    uint8 levels (EVIDENCE_MAX_LEVELS at no more than
    EVIDENCE_MAX_PIXEL_SHARE of the pixels), the cameras (and indices) the
    CPU's arrays hold equal; where they hold DTU's maps, fg_mask and
    valid_depth_gt equal but at no more than EVIDENCE_MAX_PIXEL_SHARE of the
    pixels, and depth_gt within EVIDENCE_DEPTH_REL of the CPU's where both
    are valid."""
    for label, got, ref in pairs:
        levels = np.abs(np.round(got["image"] * 255) - np.round(ref["image"] * 255))
        share = float((levels > 0).any(-1).mean())
        ok = (levels.max() <= EVIDENCE_MAX_LEVELS and share <= EVIDENCE_MAX_PIXEL_SHARE
              and all(np.array_equal(got[k], ref[k]) for k in ("pose", "intr", "idx")
                      if k in ref))
        maps = ""
        if "depth_gt" in ref:
            shares = [float((got[k] != ref[k]).mean()) for k in ("fg_mask", "valid_depth_gt")]
            both = (got["valid_depth_gt"] > 0) & (ref["valid_depth_gt"] > 0)
            rel = float(np.max(np.abs(got["depth_gt"] - ref["depth_gt"])[both]
                               / np.abs(ref["depth_gt"][both]))) if both.any() else math.inf
            ok = ok and max(shares) <= EVIDENCE_MAX_PIXEL_SHARE and rel <= EVIDENCE_DEPTH_REL
            maps = "; fg_mask / valid_depth_gt differ at {:.3e} / {:.3e} of the pixels, " \
                   "depth_gt within {:.3e} relative".format(*shares, rel)
        print("  scene {} ({} views at {}x{}): card against CPU, at most {:.0f} level(s) "
              "at {:.3e} of the pixels; cameras equal{}; {}".format(
                  label, len(got["image"]), *got["image"].shape[1:3], levels.max(), share,
                  maps, "ok" if ok else "FAIL"))
        if not ok:
            failures.append("scene " + label)


def hold_evidence(system, failures, render=None):
    """After an evidence path: K2 at the arguments of the step after the
    last (final weights) and K3 at those of the first render chunk of
    ``render`` (``system.validate`` by default), each through its wrapper
    against its plain version (K2's values and weight gradients to TOL,
    dcenter/dray to TOL_INPUT_GRAD_ALL_BANDS; a gradient that misses passes
    if it is no farther from float64 than TOL_SFM_K2_VS_F64 times the plain
    version is). The arguments are captured from the probe's own system
    (``capture_call``: nothing launches, nothing is counted), its compute
    dtype with them; under bfloat16 values too pass by the float64 rule
    (TOL_BF16_VS_F64), K3's against render_f64. Returns the largest rgb
    error of K2 and K3."""
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    errs = {}
    targs, kw = capture_call(fp, "fused_render_rays_pe_train", system.train_step)
    bf16 = kw.get("compute_dtype", "float32") != "float32"
    f64_values = TOL_BF16_VS_F64 if bf16 else None
    check(kw.get("noise") is None and kw.get("density_activ") == "softplus", kw)
    mlp = targs[0]
    names = ["d" + n.replace("mlp_", "") for n, _ in mlp.named_parameters()]
    center, ray, depth, target = [t.detach() for t in targs[1:]]
    B, R = depth.shape[:2]
    weight = 10.0 ** float(system.opt.loss_weight.render)
    print("  K2 wrapper at step {} ({} rays x {} samples, progress {:.3f}, final weights) "
          "against its plain version:".format(system.step, [B, R], depth.shape[2],
                                               float(kw["progress"])))
    sq, out, grads = k2_wrapper(mlp, center, ray, depth, target, kw, weight)
    sq_ref, out_ref, grads_ref = k2_plain(mlp, center, ray, depth, target, kw, weight)
    sq64, out64, grads64 = k2_f64(mlp, center, ray, depth, target, kw, weight)
    for key in ("rgb", "depth", "opacity"):
        err = compare(key, out[key], out_ref[key], TOL["value"], failures, out64[key],
                      f64_values)
        if key == "rgb":
            errs["k2"] = err
    compare("sq_sum", sq, sq_ref, TOL["value"], failures, sq64, f64_values)
    for i, (name, gk, gr, g64) in enumerate(zip(["dcenter", "dray"] + names, grads,
                                                grads_ref, grads64)):
        compare(name, gk, gr, TOL_INPUT_GRAD_ALL_BANDS if i < 2 else TOL["grad"], failures,
                g64, TOL_SFM_K2_VS_F64)

    rargs, kw = capture_call(fp, "fused_render_rays_pe", render or system.validate)
    mlp, (center, ray, depth) = rargs[0], [t.detach() for t in rargs[1:]]
    B, R, K_ = depth.shape[:3]
    print("  K3 wrapper at the first render chunk ({} rays x {} samples) against its plain "
          "version:".format([B, R], K_))
    with torch.no_grad():
        got = fp.fused_render_rays_pe(mlp, center, ray, depth, **kw)
        out8 = fp.render_rays_plain(mlp, center.reshape(B * R, 3), ray.reshape(B * R, 3),
                                    depth.reshape(B * R, K_), kw["progress"],
                                    kw["barf_c2f"], kw["density_activ"],
                                    kw.get("compute_dtype", "float32"))
        ref = split_plain(out8, B, R, kw["bgcolor"] if kw["setbg_opaque"] else None)
        ref64 = ([t.detach() for t in render_f64(mlp, center, ray, depth, kw)[3]] if bf16
                 else [None] * 3)
    for key, g, g64 in zip(("rgb", "depth", "opacity"), got, ref64):
        err = compare(key, g, ref[key], TOL["value"], failures, g64, f64_values)
        if key == "rgb":
            errs["k3"] = err
    return errs


def phase_evidence():
    """Path evidence: probe_b3's main through the kernels on a small B3
    scene, then hold_evidence on what it trained. Returns the launch counts
    of the path."""
    from neural_invertible_warp_tpu_torch.evidence import harness, probe_b3, scenes
    out = os.path.join(HERE, "build", "chip_smoke_evidence")
    seen = {}
    make_trainer = harness.make_trainer

    def keep_trainer(opt, train, val, device):
        seen.update(trainer=make_trainer(opt, train, val, device), train=train, val=val)
        return seen["trainer"]
    harness.make_trainer = keep_trainer
    reset_counts()
    t0 = time.time()
    try:
        rec = probe_b3.main(EVIDENCE_ARGS + ["--out-root", out, "--name", "smoke_evidence",
                                             "--out", os.path.join(out, "results.jsonl")])
        launches = field_counts()
    finally:
        harness.make_trainer = make_trainer
    seconds = time.time() - t0
    values = [v for row in rec["history"] for v in row.values()]
    values += [v for v in rec.values() if isinstance(v, float)]
    print("evidence: {}".format(json.dumps({k: v for k, v in rec.items() if k != "history"})))
    print("evidence: rows {}".format(rec["history"]))
    print("evidence: {:.1f} s, K2 {} launches over {} steps, K3 {}; {}".format(
        seconds, launches["k2"], EVIDENCE_STEPS, launches["k3"], card_line()))
    check(all(math.isfinite(v) for v in values), "evidence: a value is not finite")
    check(launches["k2"] == EVIDENCE_STEPS,
          "evidence: K2 launched {} times in {} steps".format(launches["k2"], EVIDENCE_STEPS))
    check(launches["k3"] > 0, "evidence: the validation render launched no K3")
    failures = []
    t1 = time.time()
    args = probe_b3.parse_args(EVIDENCE_ARGS)
    H, W = (int(x) for x in args.size.split(","))
    cpu = on_all_cores(scenes.blob_llff_arrays, n_images=args.n_images, img_size=(H, W),
                       n_blobs=args.n_blobs, val_ratio=0.1, backdrop=True,
                       spread=args.spread, device="cpu")
    hold_scene([("train", seen["train"], cpu[0]), ("val", seen["val"], cpu[1])], failures)
    print("  CPU render of the scene: {:.1f} s".format(time.time() - t1))
    errs = hold_evidence(seen["trainer"].system, failures)
    hold_resumed_evidence(rec, out, failures)
    print("evidence: gates: scene card against CPU, K2 at the last step and K3 at the "
          "validation render against their plain versions, rgb max abs errors {:.3e} / "
          "{:.3e}; the cut and resumed run against the uncut one; {:.1f} s in all".format(
              errs["k2"], errs["k3"], time.time() - t0))
    check(not failures, "evidence path failed: {}".format(failures))
    return launches


def hold_resumed_evidence(uncut, out, failures):
    """Path evidence's probe run again, stopped after EVIDENCE_CUT_STEP as
    SIGTERM stops a row at its deadline (the checkpoint written after the
    step in hand), then ``--resume`` in a new Python process, as a row is
    resumed in a later call: its readout rows and record (read from its
    ``--out`` file) must equal ``uncut``'s bit for bit but in
    EVIDENCE_TIMING_KEYS. Prints the first row and the fields that differ."""
    import signal
    from neural_invertible_warp_tpu_torch.evidence import harness, probe_b3
    make_trainer = harness.make_trainer

    def stop_at_cut(opt, train, val, device):
        trainer = make_trainer(opt, train, val, device)
        system, train_step = trainer.system, trainer.system.train_step

        def step(*a, **k):
            metrics = train_step(*a, **k)
            if system.step == EVIDENCE_CUT_STEP:
                signal.raise_signal(signal.SIGTERM)
            return metrics
        system.train_step = step
        return trainer
    args = EVIDENCE_ARGS + ["--out-root", os.path.join(out, "cut"), "--name", "smoke_cut",
                            "--out", os.path.join(out, "cut", "results.jsonl")]
    t0 = time.time()
    harness.make_trainer = stop_at_cut
    try:
        probe_b3.main(args)
        rc = None
    except SystemExit as e:
        rc = e.code
    finally:
        harness.make_trainer = make_trainer
    check(rc == harness.STOPPED_RC, "evidence: the cut run ended with {}".format(rc))
    child = subprocess.run(
        [sys.executable, "-m", "neural_invertible_warp_tpu_torch.evidence.probe_b3"]
        + args + ["--resume"], cwd=HERE, capture_output=True, text=True, timeout=600)
    check(child.returncode == 0, "evidence: the resumed process ended with {}:\n{}\n{}".format(
        child.returncode, child.stdout[-3000:], child.stderr[-3000:]))
    with open(args[args.index("--out") + 1]) as f:
        resumed = json.loads(f.read().splitlines()[-1])

    def untimed(rec):
        return {k: v for k, v in rec.items() if k not in EVIDENCE_TIMING_KEYS + ("name",)}
    rows = [(a["it"], untimed(a) == untimed(b)) for a, b in zip(uncut["history"],
                                                                 resumed["history"])]
    fields = [k for k in set(untimed(uncut)) | set(untimed(resumed))
              if k != "history" and uncut.get(k) != resumed.get(k)]
    first = next((it for it, same in rows if not same), None)
    print("evidence: cut after step {} and resumed ({} processes, {:.1f} s): readout rows "
          "{}; first row that differs {}; record fields that differ {}".format(
              EVIDENCE_CUT_STEP, resumed["segments"], time.time() - t0,
              "equal" if first is None else "differ", first, sorted(fields)))
    if first is not None:
        print("evidence: uncut {} resumed {}".format(
            uncut["history"][[it for it, _ in rows].index(first)],
            resumed["history"][[it for it, _ in rows].index(first)]))
    if (first is not None or fields or resumed["segments"] != 2
            or len(resumed["history"]) != len(uncut["history"])):
        failures.append("evidence: the resumed run differs from the uncut one")


def phase_evidence_dtu():
    """Path evidence_dtu: probe_dtu's main (barf_inn_dtu from noisy_gt on a
    small blob DTU scene rendered on the card, the full DTU evaluation with
    a few test-time refinement steps), then probe_extra_datasets' iPhone and
    Tanks-and-Temples slow pans. Then the card's scenes against the CPU's:
    DTU's images, depth and masks at EVIDENCE_DTU_CPU_VIEWS, and the first
    training view of each extra scene. Then ``hold_evidence`` on each run's
    system: K2 at the step after its last, and K3 at the first chunk of the
    DTU evaluation or of the extra run's validation render, against their
    plain versions. Returns the launch counts of the path."""
    from neural_invertible_warp_tpu_torch.data import dtu as dtu_data
    from neural_invertible_warp_tpu_torch.evidence import (harness, probe_dtu,
                                                           probe_extra_datasets, scenes)
    out = os.path.join(HERE, "build", "chip_smoke_evidence_dtu")
    seen = {}
    make_trainer = harness.make_trainer

    def keep_trainer(opt, train, test, device):
        trainer = make_trainer(opt, train, test, device)
        if "dtu" in seen:       # the extra datasets' runs, in EVIDENCE_EXTRA_RUNS' order
            seen.setdefault("extra", []).append(dict(system=trainer.system, train=train,
                                                     opt=opt))
            return trainer
        system, evaluate_full = trainer.system, trainer.system.evaluate_full

        def counted_evaluation(*a, **k):
            before = field_counts()
            results = evaluate_full(*a, **k)
            seen["eval"] = {key: n - before[key] for key, n in field_counts().items()}
            return results
        system.evaluate_full = counted_evaluation
        seen["dtu"] = dict(system=system, train=train, test=test, opt=opt,
                           evaluate_full=evaluate_full)
        return trainer
    harness.make_trainer = keep_trainer
    reset_counts()
    t0 = time.time()
    try:
        rec = probe_dtu.main(EVIDENCE_DTU_ARGS + ["--out-root", out, "--name", "smoke_dtu",
                                                  "--out", os.path.join(out, "results.jsonl")])
        seconds = {"dtu": time.time() - t0}
        extra = {}
        for run in EVIDENCE_EXTRA_RUNS:
            t1 = time.time()
            extra[run] = probe_extra_datasets.main([
                "--run", run, "--horizon", str(EVIDENCE_EXTRA_STEPS), "--device", "cuda",
                "--tag", "smoke_" + run, "--out-dir", os.path.join(out, run)])
            seconds[run] = time.time() - t1
        launches = field_counts()
    finally:
        harness.make_trainer = make_trainer
    steps = EVIDENCE_DTU_STEPS + 2 * EVIDENCE_EXTRA_STEPS
    values = []
    for r in [rec] + list(extra.values()):
        values += [v for row in r["history"] for v in row.values()]
        values += [v for v in r.values() if isinstance(v, (int, float))]
    print("evidence_dtu: {}".format(json.dumps({k: v for k, v in rec.items()
                                               if k != "history"})))
    print("evidence_dtu: rows {}".format(rec["history"]))
    for run, r in extra.items():
        print("evidence_dtu: {} {}".format(run, json.dumps({k: v for k, v in r.items()
                                                           if k != "history"})))
    print("evidence_dtu: {} s; K2 {} launches over {} steps, K3 {}, K4 {}; in the DTU "
          "evaluation K3 {}, K4 {}; {}".format(
              {k: round(v, 1) for k, v in seconds.items()}, launches["k2"], steps,
              launches["k3"], launches["k4"], seen["eval"]["k3"], seen["eval"]["k4"],
              card_line()))
    check(all(math.isfinite(v) for v in values), "evidence_dtu: a value is not finite")
    check(all(k in rec for k in ("depth_abs", "depth_rms", "PSNR_masked", "SSIM_masked")),
          "evidence_dtu: the DTU evaluation's keys are missing")
    check(launches["k2"] == steps,
          "evidence_dtu: K2 launched {} times in {} steps".format(launches["k2"], steps))
    check(len(seen.get("extra", [])) == len(EVIDENCE_EXTRA_RUNS),
          "evidence_dtu: {} extra systems kept".format(len(seen.get("extra", []))))
    check(seen["eval"]["k3"] > 0 and seen["eval"]["k4"] > 0,
          "evidence_dtu: the DTU evaluation launched K3 {} and K4 {} times".format(
              seen["eval"]["k3"], seen["eval"]["k4"]))
    failures = []
    t1 = time.time()
    dtu = seen["dtu"]
    args = probe_dtu.parse_args(EVIDENCE_DTU_ARGS)
    scene = scenes.dtu_scene(args.n_images, (dtu["opt"].H, dtu["opt"].W), args.seed)
    views = EVIDENCE_DTU_CPU_VIEWS
    rgb, depth, opacity = on_all_cores(scenes.render_views, scene,
                                       (dtu["opt"].H, dtu["opt"].W), [v for _, v in views],
                                       device="cpu")
    maps = scenes.dtu_maps(depth, opacity)
    keys = ("image", "pose", "intr") + tuple(maps)
    pairs = []
    for i, (split, view) in enumerate(views):
        got = dtu[split]
        j = dtu_data.split_indices(None, args.n_images, dtu["opt"].data.dtu.dtuhold)[
            split].index(view)
        ref = dict(image=scenes.quantize(rgb[i:i + 1]), pose=scene["pose"][view:view + 1],
                   intr=scene["intr"][view:view + 1])
        ref.update({k: v[i:i + 1] for k, v in maps.items()})
        pairs.append(("DTU {} view {}".format(split, view),
                      {k: got[k][j:j + 1] for k in keys}, ref))
    for run, kept in zip(EVIDENCE_EXTRA_RUNS, seen["extra"]):
        _, make_scene, kw = probe_extra_datasets.run_scene(run, kept["opt"])
        scene = make_scene(**kw)
        view = int(scene["splits"]["train"][0])       # the first training view
        rgb, _, _ = on_all_cores(scenes.render_views, scene, kw["img_size"], [view],
                                 device="cpu")
        ref = dict(image=scenes.quantize(rgb), intr=scene["intr"][view:view + 1])
        if not run.startswith("iphone"):             # the iPhone loader's poses are dummies
            ref["pose"] = scene["render_pose"][view:view + 1]
        pairs.append(("{} train view {}".format(run, view),
                      {k: kept["train"][k][:1] for k in ref}, ref))
    hold_scene(pairs, failures)
    print("  CPU render of {} views: {:.1f} s".format(len(pairs), time.time() - t1))
    errs = {"dtu": hold_evidence(dtu["system"], failures,
                                 render=lambda: dtu["evaluate_full"](dump_images=False))}
    for run, kept in zip(EVIDENCE_EXTRA_RUNS, seen["extra"]):
        print("  {}:".format(run))
        errs[run] = hold_evidence(kept["system"], failures)
    print("evidence_dtu: gates: scenes card against CPU; K2 at the step after each run's last "
          "and K3 at the first chunk of the DTU evaluation or the extra runs' validation "
          "render against their plain versions, rgb max abs errors {}; {:.1f} s in all".format(
              json.dumps({run: ["{:.3e}".format(e["k2"]), "{:.3e}".format(e["k3"])]
                          for run, e in errs.items()}), time.time() - t0))
    check(not failures, "evidence_dtu path failed: {}".format(failures))
    return launches


def cli_flags(root, out, steps=CLI_STEPS):
    """The flagship's command line on the tree under ``root``, writing under
    ``out``, and the same overrides as typed values."""
    flags = ["--model=barf_inn_llff", "--yaml=barf_inn_llff", "--barf_c2f=[0.1,0.5]",
             "--loss_weight.global_alignment=4", "--data.root={}".format(root),
             "--data.scene=blobfern", "--max_iter={}".format(steps),
             "--freq.scalar=20", "--freq.val={}".format(steps),
             "--freq.ckpt={}".format(steps), "--output_root={}".format(out),
             "--novel_view_video!"]
    typed = {"data": {"root": root, "scene": "blobfern"}, "max_iter": steps,
             "freq": {"scalar": 20, "val": steps, "ckpt": steps},
             "output_root": out, "novel_view_video": False}
    return flags, typed


def same_typed(a, b, where="options"):
    """The first place where ``a`` and ``b`` differ in a value or a type, or
    None (``True == 1`` in Python: the types are compared too)."""
    if type(a) is not type(b) and not (isinstance(a, dict) and isinstance(b, dict)):
        return "{}: {!r} ({}) against {!r} ({})".format(where, a, type(a).__name__, b,
                                                        type(b).__name__)
    if isinstance(a, dict):
        if set(a) != set(b):
            return "{}: keys {}".format(where, sorted(set(a) ^ set(b)))
        for k in a:
            diff = same_typed(a[k], b[k], "{}.{}".format(where, k))
            if diff:
                return diff
        return None
    if isinstance(a, list):
        if len(a) != len(b):
            return "{}: lengths {} and {}".format(where, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            diff = same_typed(x, y, "{}[{}]".format(where, i))
            if diff:
                return diff
        return None
    return None if a == b else "{}: {!r} against {!r}".format(where, a, b)


def write_cli_tree(root, device):
    """Path cli's scene, the B3-class blob scene as an LLFF tree of CLI_VIEWS
    PNGs at CLI_WRITE_HW under ``root``; returns the arrays written."""
    from neural_invertible_warp_tpu_torch.evidence import scenes
    scene = scenes.blob_llff_scene(n_images=CLI_VIEWS, val_ratio=0.1, backdrop=True)
    return scenes.write_llff_tree(scene, root, CLI_WRITE_HW, device=device, max_elems=1 << 26)


def phase_flagship_bf16(device):
    """Path flagship_bf16: the flagship's train.main and evaluate.main with
    --tpu.compute_dtype=bfloat16 on path cli's tree (written if absent), 2
    held-out views refined and rendered; then every configuration that
    would reach K5 or K1 under bfloat16 must refuse it. Returns the launch
    counts of the path."""
    from neural_invertible_warp_tpu_torch import config, evaluate, train
    from neural_invertible_warp_tpu_torch.models import get_system_class
    root = os.path.join(HERE, "build", "chip_smoke_cli", "data")
    if not os.path.isdir(os.path.join(root, "blobfern")):
        write_cli_tree(root, device)
    out = os.path.join(HERE, "build", "chip_smoke_bf16")
    flags = cli_flags(root, out, BF16_STEPS)[0] + [
        "--tpu.compute_dtype=bfloat16", "--data.val_ratio={}".format(BF16_VAL_RATIO)]
    opt = config.set_options(flags, makedirs=False)
    check(opt.tpu.compute_dtype == "bfloat16" and type(opt.tpu.compute_dtype) is str,
          "flagship_bf16: the CLI read tpu.compute_dtype as {!r}".format(opt.tpu.compute_dtype))
    reset_counts()
    t0 = time.time()
    trainer = train.main(flags)
    t_train = time.time() - t0
    counts_train = field_counts()
    t1 = time.time()
    results = evaluate.main(flags)
    t_eval = time.time() - t1
    launches = field_counts()
    losses = [float(v) for m in trainer.history for k, v in m.items() if k.startswith("loss")]
    check(len(trainer.history) == BF16_STEPS and all(math.isfinite(v) for v in losses),
          "flagship_bf16: {} steps logged, a loss not finite".format(len(trainer.history)))
    l_first = float(trainer.history[0]["loss_render"])
    l_last = float(trainer.history[-1]["loss_render"])
    check(l_last < l_first, "flagship_bf16: loss_render {} -> {}".format(l_first, l_last))
    check(launches["k2_bf16"] == BF16_STEPS, "flagship_bf16: K2 bf16 launched {} times in {} "
          "steps".format(launches["k2_bf16"], BF16_STEPS))
    check(counts_train["k3_bf16"] > 0 and launches["k3_bf16"] > counts_train["k3_bf16"]
          and launches["k4_bf16"] > 0, "flagship_bf16: K3 bf16 {} in training, {} in all; "
          "K4 bf16 {}".format(counts_train["k3_bf16"], launches["k3_bf16"],
                               launches["k4_bf16"]))
    fp32_launches = {k: v for k, v in launches.items() if not k.endswith("_bf16") and v}
    check(not fp32_launches, "flagship_bf16: fp32 kernels launched: {}".format(fp32_launches))
    n_views = len(trainer.system.test_data["image"])
    check(n_views == 2, "flagship_bf16: {} held-out views".format(n_views))
    for key in ("PSNR", "SSIM", "rot_error_deg", "trans_error"):
        check(math.isfinite(results[key]), "flagship_bf16: {} = {}".format(key, results[key]))
    print("flagship_bf16: train {:.1f} s ({:.2f} ms/step median of steps 6-{}), evaluate "
          "{:.1f} s ({} held-out views refined and rendered); loss_render {:.5f} -> {:.5f}; "
          "evaluation PSNR {:.3f} dB, SSIM {:.4f}, rot err {:.4f} deg; launches K2 {} K3 {} "
          "({} in training's validation) K4 {}, all bf16; card: {}".format(
              t_train, 1e3 * statistics.median(trainer.step_seconds[5:]), BF16_STEPS, t_eval,
              n_views, l_first, l_last, results["PSNR"], results["SSIM"],
              results["rot_error_deg"], launches["k2_bf16"], launches["k3_bf16"],
              counts_train["k3_bf16"], launches["k4_bf16"], card_line()))
    # every tier without a bf16 kernel refuses the option before a step; the
    # plain chain ignores it
    refused = []
    minimal = ["--data.root={}".format(root), "--data.scene=blobfern",
               "--output_root={}".format(out), "--tpu.compute_dtype=bfloat16"]
    for label, extra in BF16_REFUSED:
        # another model: its own YAML, which lacks some of the flagship's keys
        base = minimal if any(e.startswith("--model=") for e in extra) else flags
        opt = config.set_options(base + extra, makedirs=False)
        system = get_system_class(opt.model)(opt, device)
        try:
            system.check_kernel_options()
        except NotImplementedError as e:
            check("tpu.compute_dtype" in str(e), "{}: {}".format(label, e))
            refused.append(label)
        else:
            check(False, "flagship_bf16: {} did not refuse bfloat16".format(label))
    opt = config.set_options(flags + ["--tpu.fused_pe!", "--tpu.fused_kernel!"], makedirs=False)
    get_system_class(opt.model)(opt, device).check_kernel_options()
    print("flagship_bf16: refused before the first step: {}; the plain chain ignores the "
          "option".format("; ".join(refused)))
    failures = []
    hold_evidence(trainer.system, failures)
    check(not failures, "flagship_bf16 path failed: {}".format(failures))
    return launches


def phase_cli(device):
    """Path cli: the port's train and evaluate entry points from their own
    command line on an LLFF tree of PNGs (phase 18 of the docstring).
    Returns the launch counts of the path (train and the in-process
    evaluation)."""
    import shutil
    from neural_invertible_warp_tpu_torch import config, evaluate, train
    from neural_invertible_warp_tpu_torch.dotdict import DotDict
    from neural_invertible_warp_tpu_torch.flagship import flagship_options
    from neural_invertible_warp_tpu_torch.utils import image_io
    out = os.path.join(HERE, "build", "chip_smoke_cli")
    shutil.rmtree(out, ignore_errors=True)
    root = os.path.join(out, "data")
    t0 = time.time()
    written = write_cli_tree(root, device)
    t_scene = time.time() - t0
    images = os.path.join(root, "blobfern", "images")
    names = sorted(os.listdir(images))
    check(len(names) == CLI_VIEWS, "cli: {} PNGs written".format(len(names)))
    for name, img in zip(names, written):
        check(np.array_equal(image_io.read_png(os.path.join(images, name)), img),
              "cli: {} does not decode to the array written".format(name))
    flags, typed = cli_flags(root, out)
    opt = config.set_options(flags, makedirs=False)
    ref = config.process_options(config.override_options(
        DotDict(flagship_options()), DotDict(typed)), makedirs=False)
    diff = same_typed(opt.to_plain(), ref.to_plain())
    check(diff is None, "cli: the CLI's options differ from flagship_options(): {}".format(diff))
    print("cli: {} views written at {}x{} in {:.1f} s ({:.1f} MB of PNG), each decoded back; "
          "options equal flagship_options() with the same overrides".format(
              CLI_VIEWS, *CLI_WRITE_HW, t_scene,
              sum(os.path.getsize(os.path.join(images, n)) for n in names) / 1e6))
    reset_counts()
    t1 = time.time()
    trainer = train.main(flags)
    t_train = time.time() - t1
    counts_train = field_counts()
    t2 = time.time()
    results = evaluate.main(flags)
    t_eval = time.time() - t2
    launches = field_counts()
    losses = [float(v) for m in trainer.history for k, v in m.items() if k.startswith("loss")]
    check(len(trainer.history) == CLI_STEPS and all(math.isfinite(v) for v in losses),
          "cli: {} steps logged, a loss not finite".format(len(trainer.history)))
    check(launches["k2"] == CLI_STEPS, "cli: K2 launched {} times in {} steps".format(
        launches["k2"], CLI_STEPS))
    check(counts_train["k3"] > 0 and launches["k3"] > counts_train["k3"] and launches["k4"] > 0,
          "cli: K3 {} in training, {} in all; K4 {}".format(counts_train["k3"], launches["k3"],
                                                            launches["k4"]))
    run_dir = opt.output_path
    for rel in ("model/{}.ckpt".format(CLI_STEPS), "options.yaml", "quant.txt",
                "quant_pose.txt"):
        check(os.path.isfile(os.path.join(run_dir, rel)), "cli: no {}".format(rel))
    t3 = time.time()
    run = subprocess.run([sys.executable, "-m", "neural_invertible_warp_tpu_torch.evaluate"]
                         + flags, cwd=HERE, capture_output=True, text=True,
                         timeout=CLI_SUBPROCESS_TIMEOUT)
    t_sub = time.time() - t3
    check(run.returncode == 0, "cli: evaluate exited {}: {}".format(run.returncode,
                                                                     run.stderr[-2000:]))
    restored = [l for l in run.stdout.splitlines() if "restored checkpoint" in l]
    check(restored and "(iter {})".format(CLI_STEPS) in restored[-1],
          "cli: evaluate restored no checkpoint of iteration {}: {}".format(
              CLI_STEPS, run.stdout[-2000:]))
    views = sorted(os.listdir(os.path.join(run_dir, "test_view")))
    check(views, "cli: no test-view PNG")
    for name in views:
        img = image_io.read_png(os.path.join(run_dir, "test_view", name))
        check(img.shape[:2] == (480, 640) and img.dtype == np.uint8,
              "cli: {} decodes to {} {}".format(name, img.shape, img.dtype))
    print("cli: train {:.1f} s ({:.2f} ms/step median), evaluate in-process {:.1f} s, "
          "python -m ...evaluate {:.1f} s (rc 0; {}); losses {:.4f} -> {:.4f}; "
          "evaluation {}".format(
              t_train, 1e3 * statistics.median(trainer.step_seconds[5:]), t_eval, t_sub,
              restored[-1].strip(), float(trainer.history[0]["loss_all"]),
              float(trainer.history[-1]["loss_all"]),
              {k: round(float(v), 4) for k, v in results.items()
               if isinstance(v, (int, float)) and v is not None}))
    print("cli: K2 {} launches over {} steps, K3 {} ({} in training's validation), K4 {}; "
          "{}".format(launches["k2"], CLI_STEPS, launches["k3"], counts_train["k3"],
                      launches["k4"], card_line()))
    failures = []
    hold_evidence(trainer.system, failures)
    check(not failures, "cli path failed: {}".format(failures))
    return launches


def decoder_check():
    """Part (a) of path cli_data: every JPEG fixture through the C++ decoder
    (built here by utils/jpeg.load) to its manifest's shape and PIL hash,
    and equal to decode_plain; the modes not decoded raise naming the file
    and the mode; prints host ms per megapixel of both decoders."""
    import hashlib
    from neural_invertible_warp_tpu_torch.utils import jpeg
    built = not os.path.isfile(jpeg.library_path())
    t0 = time.time()
    jpeg.load()
    t_build = time.time() - t0
    with open(os.path.join(CLI_DATA_JPEG_DIR, "manifest.json")) as fh:
        manifest = json.load(fh)
    blobs, pixels, plain_s, raised = [], 0, 0.0, 0
    for entry in manifest:
        path = os.path.join(CLI_DATA_JPEG_DIR, entry["file"])
        with open(path, "rb") as fh:
            data = fh.read()
        if "raises" in entry:
            for fn in (jpeg.decode, jpeg.decode_plain):
                try:
                    fn(data, path)
                    msg = "decoded"
                except ValueError as err:
                    msg = str(err)
                check(path in msg and entry["raises"] in msg,
                      "cli_data: {} through {}: {}".format(entry["file"], fn.__name__, msg))
            raised += 1
            continue
        img = jpeg.decode(data, path)
        check(list(img.shape) == entry["shape"]
              and hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"],
              "cli_data: {} does not decode to its manifest's hash".format(entry["file"]))
        t1 = time.perf_counter()
        plain = jpeg.decode_plain(data, path)
        plain_s += time.perf_counter() - t1
        check(np.array_equal(img, plain),
              "cli_data: {}: the decoder and decode_plain differ".format(entry["file"]))
        blobs.append(data)
        pixels += img.shape[0] * img.shape[1]
    largest = max(blobs, key=len)
    shape = jpeg.decode(largest).shape
    rates = []
    for group, mp in ((blobs, pixels / 1e6), ([largest], shape[0] * shape[1] / 1e6)):
        t1 = time.perf_counter()
        for _ in range(CLI_DATA_DECODE_REPEATS):
            for data in group:
                jpeg.decode(data)
        rates.append(1e3 * (time.perf_counter() - t1) / (CLI_DATA_DECODE_REPEATS * mp))
    plain_ms = 1e3 * plain_s / (pixels / 1e6)
    print("cli_data: JPEG decoder {} in {:.1f} s; {} fixtures ({:.3f} MP) decode to their "
          "PIL hashes and equal decode_plain, {} modes raise; host ms/MP: decoder {:.2f} over "
          "the fixtures, {:.2f} on the {}x{} one; decode_plain {:.1f}".format(
              "built" if built else "loaded", t_build, len(blobs), pixels / 1e6, raised,
              rates[0], rates[1], shape[0], shape[1], plain_ms))


def cli_data_run(label, flags, steps, failures):
    """train.main and evaluate.main on ``flags`` with every counter from 0;
    the run's checks. Returns (launch counts, trainer, evaluation results,
    seconds of each)."""
    from neural_invertible_warp_tpu_torch import evaluate, train
    reset_counts()
    t0 = time.time()
    trainer = train.main(flags)
    t_train = time.time() - t0
    counts_train = field_counts()
    t1 = time.time()
    results = evaluate.main(flags)
    t_eval = time.time() - t1
    launches = field_counts()
    losses = [float(v) for m in trainer.history for k, v in m.items() if k.startswith("loss")]
    check(len(trainer.history) == steps and all(math.isfinite(v) for v in losses),
          "cli_data {}: {} steps logged, a loss not finite".format(label, len(trainer.history)))
    check(launches["k2"] == steps, "cli_data {}: K2 launched {} times in {} steps".format(
        label, launches["k2"], steps))
    check(counts_train["k3"] > 0 and launches["k3"] > counts_train["k3"] and launches["k4"] > 0,
          "cli_data {}: K3 {} in training, {} in all; K4 {}".format(
              label, counts_train["k3"], launches["k3"], launches["k4"]))
    print("cli_data {}: train {:.1f} s ({:.2f} ms/step median), evaluate {:.1f} s; losses "
          "{:.4f} -> {:.4f}; K2 {}, K3 {} ({} in training), K4 {}; evaluation {}".format(
              label, t_train, 1e3 * statistics.median(trainer.step_seconds[5:]
                                                      or trainer.step_seconds), t_eval,
              float(trainer.history[0]["loss_all"]), float(trainer.history[-1]["loss_all"]),
              launches["k2"], launches["k3"], counts_train["k3"], launches["k4"],
              {k: round(float(v), 5) for k, v in results.items()
               if isinstance(v, (int, float)) and v is not None}))
    hold_evidence(trainer.system, failures)
    return launches, trainer, results


def augment_options(out):
    """Write an options file under ``out``: the flagship's with
    CLI_DATA_AUGMENT under ``data.augment`` (the CLI takes no flag for a key
    its options files lack). Returns its ``--yaml`` value, relative to the
    options directory."""
    from neural_invertible_warp_tpu_torch import config
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "barf_inn_llff_augment.yaml")
    with open(path, "w") as fh:
        fh.write("\n".join(["_parent_: options/barf_inn_llff.yaml", "data:", "    augment:"] + [
            "        {}: {}".format(k, json.dumps(v)) for k, v in CLI_DATA_AUGMENT.items()])
            + "\n")
    return os.path.relpath(path[:-len(".yaml")], os.path.join(config.OPTIONS_ROOT, "options"))


def event_images(run_dir, writer):
    """tag -> (step, height, width, colorspace, PNG bytes) of the image
    summaries in the event files of ``run_dir``, read with the Event message
    of the writer's package (``writer``: the trainer's ``tb_writer``) from
    TFRecord framing (length, its CRC, the record, its CRC)."""
    if writer == "tensorboardX":
        from tensorboardX.proto.event_pb2 import Event
    else:
        from tensorboard.compat.proto.event_pb2 import Event
    found = {}
    for name in sorted(os.listdir(run_dir)):
        if not name.startswith("events.out.tfevents"):
            continue
        with open(os.path.join(run_dir, name), "rb") as fh:
            data = fh.read()
        pos = 0
        while pos + 12 <= len(data):
            length, = struct.unpack("<Q", data[pos:pos + 8])
            event = Event.FromString(data[pos + 12:pos + 12 + length])
            pos += 16 + length
            for value in event.summary.value:
                if value.HasField("image"):
                    image = value.image
                    found[value.tag] = (event.step, image.height, image.width,
                                        image.colorspace, image.encoded_image_string)
    return found


def hold_tb_images(trainer, failures):
    """The run's event file holds CLI_DATA_TB_TAGS, each a PNG that decodes
    (utils/image_io) to the uint8 the engine encoded, at its step. Returns
    the writer's package, or None where the machine has no writer."""
    from neural_invertible_warp_tpu_torch.utils import image_io
    if trainer.tb is None:
        return None
    trainer.tb.close()      # tensorboardX's flush leaves queued events to its writer thread
    found = event_images(trainer.opt.output_path, trainer.tb_writer)
    for tag in CLI_DATA_TB_TAGS:
        if tag not in found or tag not in trainer.tb_images:
            failures.append("cli_data: no {} image summary (event file: {}, engine: {})".format(
                tag, sorted(found), sorted(trainer.tb_images)))
            continue
        step, h, w, c, png = found[tag]
        ref_step, pixels = trainer.tb_images[tag]
        img = image_io.decode_png(png, tag)
        if not (step == ref_step and (h, w, c) == pixels.shape and img.shape == pixels.shape
                and np.array_equal(img, pixels)):
            failures.append("cli_data: the {} summary (step {}, {}x{}x{}) is not the engine's "
                            "image (step {}, {})".format(tag, step, h, w, c, ref_step,
                                                         pixels.shape))
    print("cli_data: tensorboard images {} read back from the event file: {}".format(
        ", ".join("{} {}x{}".format(t, *found[t][1:3]) for t in CLI_DATA_TB_TAGS if t in found),
        "equal to the engine's uint8" if not failures else "FAILED"))
    return trainer.tb_writer


def hold_augmentation(trainer, failures):
    """The augmented run's training images all differ from an unaugmented
    load of the same tree and its validation images equal it."""
    from neural_invertible_warp_tpu_torch.data import llff
    from neural_invertible_warp_tpu_torch.dotdict import DotDict
    opt = copy.deepcopy(trainer.opt)
    opt.data.augment = DotDict()
    plain = {split: llff.Dataset(opt, split).all_arrays(opt)["image"] for split in ("train", "val")}
    got = {"train": trainer.system.train_data["image"].cpu().numpy(),
           "val": trainer.system.test_data["image"].cpu().numpy()}
    changed = [not np.array_equal(a, b) for a, b in zip(got["train"], plain["train"])]
    print("cli_data: augmented training views differing from an unaugmented load: {} of {}; "
          "validation views equal to it: {}".format(sum(changed), len(changed),
                                                   np.array_equal(got["val"], plain["val"])))
    if not (all(changed) and len(changed) == len(plain["train"])
            and np.array_equal(got["val"], plain["val"])):
        failures.append("cli_data: data.augment changed {} of {} training views; validation "
                        "equal: {}".format(sum(changed), len(changed),
                                           np.array_equal(got["val"], plain["val"])))


def host_image_ms(trainer):
    """Host ms per image of the decode (the progressive and the baseline
    tree) and of the augmentation (the run's options) at the tree's
    240x320, printed."""
    from neural_invertible_warp_tpu_torch.data import llff
    from neural_invertible_warp_tpu_torch.utils import jpeg
    rates = {}
    for label, root in (("progressive", CLI_DATA_PROG_DIR),
                        ("baseline", os.path.join(CLI_DATA_JPEG_DIR, "llff"))):
        folder = os.path.join(root, "blobfern", "images")
        blobs = []
        for name in sorted(os.listdir(folder)):
            with open(os.path.join(folder, name), "rb") as fh:
                blobs.append(fh.read())
        t0 = time.perf_counter()
        for _ in range(CLI_DATA_DECODE_REPEATS):
            for data in blobs:
                jpeg.decode(data)
        rates[label] = 1e3 * (time.perf_counter() - t0) / (CLI_DATA_DECODE_REPEATS * len(blobs))
    aug_opt = copy.deepcopy(trainer.opt)
    dataset = llff.Dataset(aug_opt, "train")
    rng = np.random.RandomState(0)
    raw = [dataset.get_image(aug_opt, i) for i in range(len(dataset))]
    augs = [dataset.generate_augmentation(aug_opt, rng) for _ in raw]
    t0 = time.perf_counter()
    for image, aug in zip(raw, augs):
        dataset.apply_augmentation(image, aug)
    aug_ms = 1e3 * (time.perf_counter() - t0) / len(raw)
    print("cli_data: host ms per {}x{} image: progressive decode {:.3f}, baseline decode {:.3f}, "
          "augmentation {:.3f} (jitter, hflip, bicubic rotation over {} views)".format(
              *raw[0].shape[:2], rates["progressive"], rates["baseline"], aug_ms, len(raw)))


def phase_cli_data(device):
    """Path cli_data: (a) decoder_check; (b) the flagship's train and
    evaluate entry points on the committed LLFF tree of JPEGs; (c)
    barf_inn_dtu's on a DTU tree written here at 1200x1600 (cameras.npz,
    PNG images and masks, PFM depth), read and resized to 300x400 by the
    DTU loader on utils/cv_ops and image_io. Returns the launch counts of
    the path (both runs' train and in-process evaluation)."""
    import shutil
    from neural_invertible_warp_tpu_torch.evidence import scenes
    out = os.path.join(HERE, "build", "chip_smoke_cli_data")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.time()
    decoder_check()
    failures = []
    flags = cli_flags(os.path.join(CLI_DATA_JPEG_DIR, "llff"), os.path.join(out, "llff"),
                      CLI_DATA_LLFF_STEPS)[0] + [
        "--data.image_size=[{},{}]".format(*CLI_DATA_LLFF_HW)]
    launches_llff, trainer, _ = cli_data_run("LLFF (JPEG)", flags, CLI_DATA_LLFF_STEPS,
                                             failures)
    check(tuple(trainer.system.train_data["image"].shape[1:3]) == CLI_DATA_LLFF_HW,
          "cli_data: the JPEG tree trained at {}".format(
              tuple(trainer.system.train_data["image"].shape)))
    del trainer
    torch.cuda.empty_cache()

    flags = [f for f in cli_flags(CLI_DATA_PROG_DIR, os.path.join(out, "llff_progressive"),
                                  CLI_DATA_AUG_STEPS)[0] if not f.startswith("--yaml=")] + [
        "--yaml=" + augment_options(out), "--data.val_ratio={}".format(CLI_DATA_AUG_VAL_RATIO),
        "--data.image_size=[{},{}]".format(*CLI_DATA_LLFF_HW)]
    launches_prog, trainer, _ = cli_data_run("LLFF (progressive JPEG, data.augment)", flags,
                                             CLI_DATA_AUG_STEPS, failures)
    print("cli_data: tensorboard writer: {}".format(
        trainer.tb_writer or "none on this machine (the image summaries are checked by the "
        "CPU tests only)"))
    hold_tb_images(trainer, failures)
    hold_augmentation(trainer, failures)
    host_image_ms(trainer)
    del trainer
    torch.cuda.empty_cache()

    root = os.path.join(out, "dtu")
    t1 = time.time()
    scene = scenes.write_dtu_tree(root, n_images=CLI_DATA_DTU_VIEWS, device=device,
                                  max_elems=1 << 26)
    t_write = time.time() - t1
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]
    print("cli_data: DTU tree of {} views at {}x{} written in {:.1f} s ({} files, {:.1f} MB)"
          .format(CLI_DATA_DTU_VIEWS, *scenes.DTU_RAW_HW, t_write, len(files),
                  sum(os.path.getsize(f) for f in files) / 1e6))
    flags = ["--model=barf_inn_dtu", "--yaml=barf_inn_dtu", "--data.root={}".format(root),
             "--data.scene=scan1", "--max_iter={}".format(CLI_DATA_DTU_STEPS),
             "--freq.scalar=20", "--freq.val={}".format(CLI_DATA_DTU_STEPS),
             "--freq.ckpt={}".format(CLI_DATA_DTU_STEPS),
             "--output_root={}".format(os.path.join(out, "dtu_run")), "--novel_view_video!"]
    launches_dtu, trainer, results = cli_data_run("DTU (files)", flags, CLI_DATA_DTU_STEPS,
                                                  failures)
    keys = ("depth_abs", "depth_rms", "PSNR_masked", "SSIM_masked")
    check(all(math.isfinite(float(results.get(k, math.nan))) for k in keys),
          "cli_data: the DTU evaluation gave {}".format({k: results.get(k) for k in keys}))
    data = trainer.system.train_data
    views = [i for i in range(CLI_DATA_DTU_VIEWS) if i % 8]      # dtuhold 8
    check(tuple(data["image"].shape[1:3]) == (300, 400) and len(data["image"]) == len(views),
          "cli_data: DTU trained on {}".format(tuple(data["image"].shape)))
    pose_err = float(np.abs(data["pose"].cpu().numpy() - scene["pose"][views]).max())
    intr_ref = scene["intr"][views].copy()
    intr_ref[:, :2] *= 0.25
    intr_err = float(np.abs(data["intr"].cpu().numpy() - intr_ref).max() / intr_ref.max())
    print("cli_data: DTU cameras parsed from the files against the in-memory scene's: pose "
          "{:.3e}, intr {:.3e} relative; training views {}".format(pose_err, intr_err, views))
    check(pose_err <= CLI_DATA_CAMERA_TOL and intr_err <= CLI_DATA_CAMERA_TOL,
          "cli_data: the DTU cameras parsed from the files differ from the scene's")
    launches = {k: launches_llff[k] + launches_prog[k] + launches_dtu[k] for k in launches_llff}
    print("cli_data: {:.1f} s in all; {}".format(time.time() - t0, card_line()))
    check(not failures, "cli_data path failed: {}".format(failures))
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
    records_bf16 = phase_kernels_bf16(mlp, device)
    trainer, launches, summary_off = phase_slice(device)
    launches_eval = phase_eval(trainer, device)
    del trainer
    torch.cuda.empty_cache()
    launches_dtu, k2_dtu = phase_slice_dtu(device)
    records["k2"].update(ms_dtu=k2_dtu["ms"], plain_ms_dtu=k2_dtu["plain_ms"],
                         max_abs_err_dtu=k2_dtu["max_abs_err"])
    torch.cuda.empty_cache()
    records_field, k2_extra = phase_kernels_field(mlp, device)
    launches_fine = phase_slice_fine(device)
    records["k2"].update(k2_extra)
    records_inn = phase_kernel_inn(device)
    records_k7 = phase_kernel_k7(device)
    launches_fused = phase_slice_fused_inn(device, summary_off)
    launches_pdcnet = phase_pose_init_pdcnet(device)
    torch.cuda.empty_cache()
    launches_sfm, k2_sfm = phase_pose_init_sfm(device)
    records["k2"].update(k2_sfm)
    torch.cuda.empty_cache()
    launches_garf, _ = phase_garf(device)
    launches_planar, _ = phase_planar(device)
    torch.cuda.empty_cache()
    launches_sharded = phase_sharded(device)
    torch.cuda.empty_cache()
    launches_evidence = phase_evidence()
    torch.cuda.empty_cache()
    launches_evidence_dtu = phase_evidence_dtu()
    torch.cuda.empty_cache()
    launches_cli = phase_cli(device)
    torch.cuda.empty_cache()
    launches_cli_data = phase_cli_data(device)
    torch.cuda.empty_cache()
    launches_bf16 = phase_flagship_bf16(device)
    pkg = "neural_invertible_warp_tpu_torch/csrc/"
    pallas = "neural_invertible_warp_tpu/ops/pallas/"
    paths = {"flagship_train": launches, "flagship_eval": launches_eval,
             "dtu": launches_dtu, "fine": launches_fine,
             "flagship_fused_inn": launches_fused, "pose_init_pdcnet": launches_pdcnet,
             "pose_init_sfm": launches_sfm, "sharded": launches_sharded,
             "evidence": launches_evidence, "evidence_dtu": launches_evidence_dtu,
             "cli": launches_cli, "cli_data": launches_cli_data,
             "flagship_bf16": launches_bf16}
    # paths that run no kernel, listed with their zeros
    plain_paths = {"garf": launches_garf, "planar": launches_planar}

    def kernel(key, name, source, replaces, record):
        # launches: over the paths, each counted from 0 by its own phase
        by_path = {path: counts[key] for path, counts in paths.items() if counts.get(key)}
        by_path.update({path: counts[key] for path, counts in plain_paths.items()})
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
        kernel("k2_bf16", "K2 rm_train under tpu.compute_dtype: bfloat16", "rm_train.cu",
               "fused_pe.py:886", records_bf16["k2_bf16"]),
        kernel("k3_bf16", "K3 rm_fwd under tpu.compute_dtype: bfloat16", "rm_fwd.cu",
               "fused_pe.py:568", records_bf16["k3_bf16"]),
        kernel("k4_bf16", "K4 rm_bwd under tpu.compute_dtype: bfloat16", "rm_bwd.cu",
               "fused_pe.py:597", records_bf16["k4_bf16"]),
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
