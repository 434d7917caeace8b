"""The DTU probe: joint pose and field recovery for the paper's Table-2
models on a synthetic DTU scene,

    python -m neural_invertible_warp_tpu_torch.evidence.probe_dtu \\
        [--model barf_inn_dtu] [--init noisy_gt] [--iters 30000]

``barf_inn_dtu`` (the INN warp), ``barf_dtu`` (the SE(3) control) or
``nerf_dtu`` (known poses) on the blob DTU scene (a 49-view inward camera
arc at 150x200 over an opaque textured blob cluster before a spotted wall,
42 train / 7 test views; ``scenes.blob_dtu_arrays``, rendered in memory on
the run's device), at the paper's hyperparameters: BARF c2f [0.1, 0.5],
global-alignment weight 10^3, the depth range widened by 15%, max_iter
200000. Initial poses (``--init``): ``noisy_gt`` (se(3) noise sigma=0.15 on
the GT), ``colmap`` (the in-process SfM with the ZNCC matcher, on the
card), ``identity`` or ``given``.

Prints the initial pose error, a readout row every ``--log-every`` steps,
then runs the full DTU evaluation (prealign, test-time refinement of every
test view, depth errors, foreground-masked PSNR/SSIM/LPIPS; LPIPS is None
without its weights) and appends one JSON record (``harness.run_record``'s
fields, ``horizon`` = max_iter, and ``harness.dtu_record``'s) to ``--out``.
``--seed`` moves the scene, the initial weights and the draws, as the JAX
package's tool does. ``--overrides`` takes ``key=value`` pairs with JSON
values (``optim.test_iter=5``). Runs on the card; ``--device=cpu`` runs the
plain PyTorch paths, and without a card and without that flag it fails.
"""

from __future__ import annotations

import argparse
import os
import time

from .. import config
from . import harness, scenes

OUT_DIR = os.path.join("build", "evidence")
# data.root of the options: the scene is made in memory, nothing is read there
SCENE_ROOT = os.path.join(OUT_DIR, "scenes", "dtu")
MODELS = ("barf_inn_dtu", "barf_dtu", "nerf_dtu")
INITS = ("noisy_gt", "identity", "colmap", "given")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30000)
    ap.add_argument("--model", default="barf_inn_dtu", choices=MODELS)
    ap.add_argument("--init", default="noisy_gt", choices=INITS)
    ap.add_argument("--size", default="150,200")
    ap.add_argument("--n-images", type=int, default=49)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=2000)
    ap.add_argument("--ga-weight", type=float, default=3.0,
                    help="log10 global-alignment weight (paper: 2..4)")
    ap.add_argument("--overrides", nargs="*", default=[],
                    help="extra key=value config overrides, values as JSON")
    ap.add_argument("--out-root", default=os.path.join(OUT_DIR, "probe_dtu_out"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "results.jsonl"),
                    help="JSON-lines file the record is appended to")
    ap.add_argument("--name", default="probe_dtu", help="the record's name")
    return ap.parse_args(argv)


def probe_options(args):
    """The probe's options: tools/probe_dtu.py's overrides (the pose ones
    for the pose models only), then ``--overrides``; ``barf_dtu`` with the
    SE(3) parameterization."""
    H, W = (int(x) for x in args.size.split(","))
    over = {
        "model": args.model, "yaml": args.model,
        "data.root": SCENE_ROOT, "data.scene": "scan1", "data.image_size": [H, W],
        "data.dtu.increase_depth_range_by_x_percent": 0.15,
        "max_iter": 200000,
        "freq.scalar": 1000000, "freq.val": 1000000, "freq.ckpt": 1000000,
        "output_root": args.out_root, "group": "r3",
        "name": "{}_{}".format(args.model, args.init), "seed": args.seed,
    }
    if args.model != "nerf_dtu":
        over.update({"barf_c2f": [0.1, 0.5], "pose.init": args.init,
                     "loss_weight.global_alignment": args.ga_weight})
    over.update(harness.parse_overrides(args.overrides))
    opt = harness.build(args.model, over)
    if args.model == "barf_dtu":
        opt.pose.parameterization = "se3"
    return opt


def main(argv=None):
    """Run the probe; returns its record."""
    args = parse_args(argv)
    device = config.check_device(args.device)
    t0 = time.time()
    opt = probe_options(args)
    train, test, _ = scenes.blob_dtu_arrays(
        n_images=args.n_images, img_size=(opt.H, opt.W), seed=args.seed,
        widen=opt.data.dtu.increase_depth_range_by_x_percent,
        dtuhold=opt.data.dtu.dtuhold, device=device)
    print("scene built: {} train / {} test views at {}x{} in {:.1f} s".format(
        len(train["idx"]), len(test["idx"]), opt.H, opt.W, time.time() - t0), flush=True)
    trainer = harness.make_trainer(opt, train, test, device)
    system = trainer.system
    pose = opt.model != "nerf_dtu"
    init = None
    if pose:
        init = harness.initial_pose_error(system)
        print("initial: rot {:.2f} deg, trans {:.4f}".format(init["rot"], init["trans"]),
              flush=True)
    t1 = time.time()
    history = harness.train_loop(system, args.iters, log_every=args.log_every,
                                 pose_errors=pose)
    train_s = time.time() - t1
    if pose:
        system.prealign()   # the sim(3) for the test poses' backtracking and the depth scale
    results = system.evaluate_full(dump_images=False)
    print("final eval:", {k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in results.items()}, flush=True)
    rec = dict(name=args.name, model=opt.model, yaml=opt.yaml, init=args.init,
               note="{} from {} on the blob DTU scene, {} views at {}x{}".format(
                   opt.model, args.init, args.n_images, opt.H, opt.W),
               seed=args.seed, overrides=args.overrides)
    rec.update(harness.run_record(system, history, init, train_s, args.iters,
                                  opt.max_iter, pose=pose))
    rec.update(harness.dtu_record(results))
    rec["elapsed_s"] = round(time.time() - t0, 1)
    harness.append_record(args.out, rec)
    return rec


if __name__ == "__main__":
    main()
