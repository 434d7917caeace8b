"""Where the time goes in the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_profile.py

Builds the flagship system (barf_inn_llff at full width) on chip_smoke.py's
synthetic 480x640 scene and profiles three steady windows with
torch.profiler (CPU and CUDA activities):
  train   10 train steps after 30 warm-up steps (K2 each);
  train, fused warp   the same 10 steps with ``tpu.fused_inn: true`` (K6
          forward and backward each step in place of the warp's plain
          chain), after 5 more warm-up steps, beside the window above;
  train, again        the first window once more, switch off, so that the
          fused window stands between two of its kind;
  refine  20 iterations of test-time pose refinement after 5 (K3 under
          autograd, K4 with the weights frozen, Adam on one se(3));
  render  one full-image render (150 chunks through K3).
Then the fine-sampling system (nerf, nerf_llff_repr at full width: 64 + 128
samples, 1024 rays, two fields), two windows:
  fine train   10 train steps after 20 (K2 at 64 samples returning the
               compositing weights, the resample, K2 at 192 samples);
  fine render  one full-image render (300 chunks, K5 at 64 and at 192
               samples each, compositing and the resample in PyTorch);
  fine K5 backward, fine K1 backward   10 backward calls with weight
               gradients of the coarse field at [1,1024] rays x 64 samples
               (relu, density noise) after 3, as the fallback (K5) and
               MLP-only (K1) tiers call it, under the loss sum(rgb) +
               sum(density).
Then PDC-Net (random weights from a seed) through PdcNetMatcher, one window:
  matcher      5 pairs of 480x640 views after 3 (24 K7 and 9 adjoint
               launches per pair), with K7's share of the device time.
For each window it prints the wall time per unit (host clock,
device-synced, taken without the profiler), the device-busy time per unit
(the sum of the durations of all device kernels and copies in the trace),
the idle share, the count of device operations (kernels and copies) per
unit, the device time per unit of K6's and K7's kernels (forward and
backward, the adjoints apart), the peak device memory, and the device time
by kernel name (the twelve largest, and every kernel of the fused warp and
of K7).
Every line names the card and its power limit. Needs one CUDA device.
"""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict

import torch

import chip_smoke as cs

N_WARM_STEPS, N_TRAIN_STEPS = 30, 10
N_WARM_FUSED = 5
N_WARM_REFINE, N_REFINE = 5, 20
N_WARM_FINE = 20
N_WARM_FIELD, N_FIELD = 3, 10
N_WARM_MATCH, N_MATCH = 3, 5
TOP = 12


def device_time_by_name(prof):
    """({kernel name: total device microseconds}, number of device events)
    over the trace's device events. Annotation ranges that the profiler
    mirrors onto the device track (``Optimizer.step#Adam.step``) span
    kernels already counted."""
    from torch.autograd import DeviceType
    by_name = defaultdict(float)
    n_events = 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and "#" not in evt.name:
            by_name[evt.name] += evt.time_range.elapsed_us()
            n_events += 1
    return by_name, n_events


def short(name):
    name = name.replace("(bool)0", "0").replace("(bool)1", "1").replace("void ", "")
    return name if len(name) <= 76 else name[:73] + "..."


def window(label, unit, n_units, fn):
    """Run fn() once unprofiled (wall time) and once under the profiler
    (device time by kernel)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / n_units
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, n_events = device_time_by_name(prof)
    busy_ms = sum(by_name.values()) / 1e3 / n_units
    cs.check(busy_ms > 0, "the profiler saw no device time")
    def ms(*keys):
        return sum(t for n, t in by_name.items() if any(k in n for k in keys)) / 1e3 / n_units
    ours, k7 = ms("niw::"), ms("niw::corr::")
    # K6's and K7's kernels per unit (the first K6 design's reduce_ctas and dcode
    # kernels too), so that two trees compare on this line
    per_kernel = "K6 forward {:.4f} ms (prep {:.4f}), backward {:.4f} ms (epilogue {:.4f}); " \
        "K7 forward {:.4f} ms, adjoint in f1 {:.4f}, adjoint in f2 {:.4f}".format(
            ms("niw::inn::prep_kernel", "niw::inn::fwd_kernel"), ms("niw::inn::prep_kernel"),
            ms("niw::inn::bwd_kernel", "niw::inn::reduce_ctas_kernel", "niw::inn::epilogue_kernel",
               "niw::inn::dcode_kernel"),
            ms("niw::inn::reduce_ctas_kernel", "niw::inn::epilogue_kernel", "niw::inn::dcode_kernel"),
            ms("niw::corr::fwd_kernel"), ms("niw::corr::adj_kernel<false>"),
            ms("niw::corr::adj_kernel<true>"))
    print("profile {}: {:.2f} ms wall per {} (unprofiled), device busy {:.2f} ms, idle share "
          "{:.1f}%; {:.0f} device operations per {}; hand-written kernels {:.2f} ms (K7 and its "
          "adjoint {:.3f} ms, {:.1f}% of busy; {}), everything else {:.2f} ms; peak device "
          "memory {:.2f} GB; card: {}".format(
              label, wall_ms, unit, busy_ms, 100 * max(0.0, 1 - busy_ms / wall_ms),
              n_events / n_units, unit, ours, k7, 100 * k7 / busy_ms, per_kernel, busy_ms - ours,
              peak_gb, cs.card_line()))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, t in ranked[:TOP] + [kv for kv in ranked[TOP:]
                                   if "niw::inn::" in kv[0] or "niw::corr::" in kv[0]]:
        print("  {:9.3f} ms per {}  {}".format(t / 1e3 / n_units, unit, short(name)))


def train_steps(system):
    def train():
        for _ in range(N_TRAIN_STEPS):
            system.train_step()
    return train


def main():
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(2)
    from neural_invertible_warp_tpu_torch.config import process_options
    from neural_invertible_warp_tpu_torch.flagship import flagship_options
    from neural_invertible_warp_tpu_torch.models.engine import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    opt = flagship_options()
    opt.data.image_size = list(cs.IMAGE_HW)
    opt.output_root = os.path.join(cs.HERE, "build", "chip_profile_run")
    process_options(opt)
    H, W = cs.IMAGE_HW
    trainer = Trainer(opt, device)
    trainer.build_system(cs.make_scene(H, W, cs.N_TRAIN, seed=0),
                         cs.make_scene(H, W, cs.N_VAL, seed=1))
    system = trainer.system
    print("profile: barf_inn_llff flagship, {} train views at {}x{}; torch {}; card: {}".format(
        cs.N_TRAIN, H, W, torch.__version__, cs.card_line()))
    for _ in range(N_WARM_STEPS):
        system.train_step()

    window("train", "step", N_TRAIN_STEPS, train_steps(system))
    opt.tpu.fused_inn = True
    for _ in range(N_WARM_FUSED):
        system.train_step()
    window("train, fused warp", "step", N_TRAIN_STEPS, train_steps(system))
    opt.tpu.fused_inn = False
    for _ in range(N_WARM_FUSED):
        system.train_step()
    window("train, again", "step", N_TRAIN_STEPS, train_steps(system))

    system.prealign()
    intr, pixels = system.train_data["intr"][:1], system.train_data["pixels"][:1]
    pose = system.get_all_training_poses()[0][:1]
    progress = (torch.tensor(float(system.step)) / opt.max_iter).to(device)

    def refine(n):
        opt.optim.test_iter = n
        system.test_time_optimized_pose(
            pose, intr, pixels, progress,
            generator=torch.Generator(device=device).manual_seed(0))
    refine(N_WARM_REFINE)
    window("refine", "iteration", N_REFINE, lambda: refine(N_REFINE))

    n_chunks = -(-H * W // opt.nerf.rand_rays)
    window("render", "chunk", n_chunks, lambda: system.render_image(pose, intr, progress))

    del trainer, system
    torch.cuda.empty_cache()
    from neural_invertible_warp_tpu_torch.nerf_llff_repr import nerf_llff_repr_options
    opt = nerf_llff_repr_options()
    opt.data.image_size = list(cs.IMAGE_HW)
    opt.output_root = os.path.join(cs.HERE, "build", "chip_profile_run_fine")
    process_options(opt)
    trainer = Trainer(opt, device)
    trainer.build_system(cs.make_scene(H, W, cs.FINE_N_TRAIN, seed=2),
                         cs.make_scene(H, W, cs.N_VAL, seed=3))
    system = trainer.system
    print("profile: nerf (nerf_llff_repr), {} train views at {}x{}, {} + {} samples, {} rays; "
          "card: {}".format(cs.FINE_N_TRAIN, H, W, opt.nerf.sample_intvs,
                            opt.nerf.sample_intvs_fine, opt.nerf.rand_rays, cs.card_line()))
    for _ in range(N_WARM_FINE):
        system.train_step()
    window("fine train", "step", N_TRAIN_STEPS, train_steps(system))
    pose, intr = system.test_data["pose"][:1], system.test_data["intr"][:1]
    n_chunks = -(-H * W // opt.nerf.rand_rays)
    window("fine render", "chunk", n_chunks, lambda: system.render_image(pose, intr))
    # the per-sample field kernels' backward with weight gradients alone, as
    # the fallback (K5) and MLP-only (K1) tiers call it at 64 samples
    (center, ray, depth, _, noise), _ = cs.fine_batch(cs.FINE_RAYS, cs.FINE_K[0], 80, device)
    for which in ("k5", "k1"):
        c = center.clone().requires_grad_(True)
        rgb_s, dens = cs.field_fn(which)(system.graph.nerf, c, ray, depth,
                                         density_activ="relu", noise=noise)
        loss = rgb_s.sum() + dens.sum()
        wrt = [c] + list(system.graph.nerf.parameters())

        def backward(n):
            for _ in range(n):
                torch.autograd.grad(loss, wrt, retain_graph=True)
        backward(N_WARM_FIELD)
        window("fine {} backward".format(which.upper()), "call", N_FIELD,
               lambda: backward(N_FIELD))
        del loss, rgb_s, dens

    del trainer, system
    torch.cuda.empty_cache()
    from neural_invertible_warp_tpu_torch.ops.pdcnet.pdcnet import PDCNet
    from neural_invertible_warp_tpu_torch.utils import matchers
    matcher = matchers.PdcNetMatcher(PDCNet(torch.Generator().manual_seed(0)),
                                     min_confidence=cs.PDCNET_MIN_CONFIDENCE)
    images = cs.make_scene(H, W, 2, seed=4)["image"]

    def match(n):
        for _ in range(n):
            matcher(0, 1, images[0], images[1])
    print("profile: PDC-Net through PdcNetMatcher, one pair at {}x{}; card: {}".format(
        H, W, cs.card_line()))
    match(N_WARM_MATCH)
    window("matcher", "pair", N_MATCH, lambda: match(N_MATCH))


if __name__ == "__main__":
    main()
