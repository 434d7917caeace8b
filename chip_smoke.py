"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each:
  1. environment: torch, CUDA and the card (nvidia-smi name, power limit);
  2. build: nvcc compiles the port's CUDA kernels from csrc/ into build/;
  3. kernels: each kernel, through the wrapper the slice calls (for K2 with
     the render loss backpropagated through its autograd Function), against
     its plain PyTorch version on the card at the flagship shapes, with all
     PE bands open, and at a ragged ray count with a background colour;
     values and every gradient within the tolerances below; kernel and plain
     timed with CUDA events (median of 20 runs after 3 warm-up runs);
  4. slice: the flagship model (barf_inn_llff at full width) trains 100
     steps through the port's Trainer on an in-memory synthetic scene, then
     renders the validation view and writes a checkpoint. Checks that every
     step went through the kernels, that the loss is finite and falls, that
     the pose readout is a rotation, that the validation image equals the
     plain render of the same chunks, and that a training view rendered at
     its pose readout reaches a PSNR floor.
Then a JSON line of kernel results, the card line, and the result line
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
then non-zero and no result line is printed. Without a CUDA device it exits
with code 2 before doing anything.
"""

from __future__ import annotations

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
# PSNR floor of a training view rendered at its pose readout after the slice
# (reads 36.3 dB on an H100; PERF.md, Findings)
MIN_TRAIN_VIEW_PSNR = 30.0


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


def phase_kernels(mlp, device):
    """K2 and K3, through the wrappers the slice calls, against their plain
    versions. Returns the JSON records."""
    from neural_invertible_warp_tpu_torch.flagship import flagship_options
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    # summarize_loss's 10^w on the render loss
    weight = 10.0 ** float(flagship_options().loss_weight.render)
    names = ["d" + n.replace("mlp_", "") for n, _ in mlp.named_parameters()]
    failures = []
    records = {"k2": dict(max_abs_err=0.0), "k3": dict(max_abs_err=0.0)}
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
    print("kernels: K2 {:.3f} ms (plain {:.3f} ms) forward+backward at [18,113]x{}; "
          "K3 {:.3f} ms (plain {:.3f} ms) at [1,2048]x{}; card: {}".format(
              records["k2"]["ms"], records["k2"]["plain_ms"], K, records["k3"]["ms"],
              records["k3"]["plain_ms"], K, card_line()))
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
    fp.fused_render_rays_pe_train.launches = 0
    fp.fused_render_rays_pe.launches = 0
    trainer.train()
    t0 = time.time()
    res = trainer.run_validation(system.step)
    torch.cuda.synchronize()
    val_seconds = time.time() - t0
    launches = {"k2": fp.fused_render_rays_pe_train.launches,
                "k3": fp.fused_render_rays_pe.launches}

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
    R = system.aux["global_rigid"][..., :3]
    check(bool(torch.isfinite(system.aux["global_rigid"]).all()), "global_rigid is not finite")
    ortho = float((R @ R.transpose(-1, -2) - torch.eye(3, device=R.device)).abs().max())
    check(ortho < 1e-4, "global_rigid is not orthonormal: {}".format(ortho))
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
        pose_pred = system.get_all_training_poses()[0]
        train0 = system.render_image(pose_pred[:1], system.train_data["intr"][:1],
                                     progress)["rgb"]
        psnr_train0 = psnr(train0, system.train_data["pixels"][:1])
    check(not failures, "validation image disagrees with the plain render")
    sim3_angle = math.acos(max(-1.0, min(1.0, (float(torch.trace(system.sim3["R"])) - 1) / 2)))
    print("slice: val PSNR {:.2f} dB at the sim(3)-moved GT pose (camera-center spread "
          "GT {:.4f}, predicted {:.4f}; sim(3) rotation {:.4f} rad); train view 0 at "
          "its pose readout {:.2f} dB".format(
              res["psnr_val"], float(system.sim3["s0"]), float(system.sim3["s1"]),
              sim3_angle, psnr_train0))
    check(psnr_train0 > MIN_TRAIN_VIEW_PSNR,
          "train view 0 renders at {:.2f} dB at its pose readout".format(psnr_train0))
    ms = statistics.median(trainer.step_seconds[19:N_STEPS]) * 1e3
    rays = N_TRAIN * (opt.nerf.rand_rays // N_TRAIN)
    print("slice: loss_render {:.5f} -> {:.5f}, global_rigid orthonormal to {:.1e}, "
          "val PSNR {:.2f} dB, rot err {:.4f} rad".format(
              l_first, l_last, ortho, res["psnr_val"], res["error_R"]))
    print("slice: launches K2 {} K3 {}; {:.2f} ms/step (median of steps 20-{}), "
          "{:.0f} rays/s, val render {:.2f} s; card: {}".format(
              launches["k2"], launches["k3"], ms, N_STEPS, rays / (ms / 1e3),
              val_seconds, card_line()))
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
    launches = phase_slice(device)
    pkg = "neural_invertible_warp_tpu_torch/csrc/"
    kernels = [
        dict(name="K2 rm_train (one-call train render)", route="cuda",
             source=pkg + "rm_train.cu",
             replaces="neural_invertible_warp_tpu/ops/pallas/fused_pe.py:886",
             launches=launches["k2"], **records["k2"]),
        dict(name="K3 rm_fwd (composited forward render)", route="cuda",
             source=pkg + "rm_fwd.cu",
             replaces="neural_invertible_warp_tpu/ops/pallas/fused_pe.py:568",
             launches=launches["k3"], **records["k3"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
