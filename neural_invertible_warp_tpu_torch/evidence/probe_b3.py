"""The flagship's pose-recovery probe on the B3 scene:

    python -m neural_invertible_warp_tpu_torch.evidence.probe_b3 [--iters 30000]

``barf_inn_llff`` (the paper's model, identity pose init, BARF c2f
[0.1, 0.5], global-alignment weight 1e4) on the blob+backdrop LLFF scene
(40 views at 240x320, 36 train / 4 val; full-frame textured, so no empty
space to hide degenerate per-view solutions in), rendered in memory on the
run's device. Prints the initial pose error, a readout row every
``--log-every`` steps, the final readout and the held-out PSNR, and appends
one JSON record (tools/probe_zoo_r4.py's fields, the rows under
``history``) to ``--out``.

``--max-iter`` is the schedule horizon (the c2f and lr-decay fractions scale
with it; ``--max-pe-iter`` is the INN warp's absolute c2f horizon), so
``--iters 20000 --max-iter 20000 --max-pe-iter 10000`` is the compressed
protocol under which a late c2f kick shows at ~8k. ``--overrides`` takes
``key=value`` pairs with JSON values (``tpu.fused_pe=false``). ``--seed``
moves the initial weights and the per-step draws; the scene stays at seed
0. Runs on the card; ``--device=cpu`` runs the plain PyTorch paths instead,
and without a card and without that flag it fails. ``--scene-root`` names
``data.root`` (the scene is made in memory, no file is read or written).
The run keeps its latest checkpoint in ``<run dir>/<name>.row.ckpt``
(``harness.RowCheckpoint``; at each readout row and on SIGTERM) and deletes it once the record is
written; ``--resume`` continues from it.
"""

from __future__ import annotations

import argparse
import os
import time

from .. import config
from . import harness, scenes

OUT_DIR = os.path.join("build", "evidence")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30000)
    ap.add_argument("--scene-root", default=os.path.join(OUT_DIR, "scenes", "llff"))
    ap.add_argument("--size", default="240,320")
    ap.add_argument("--n-images", type=int, default=40)
    ap.add_argument("--n-blobs", type=int, default=24)
    ap.add_argument("--spread", type=float, default=0.5)
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-iter", type=int, default=200000,
                    help="config max_iter (schedule horizon: c2f/lr-decay "
                         "fractions scale with it)")
    ap.add_argument("--max-pe-iter", type=int, default=100000)
    ap.add_argument("--ckpt-freq", type=int, default=1000000)
    ap.add_argument("--out-root", default=os.path.join(OUT_DIR, "probe_b3_out"))
    ap.add_argument("--log-every", type=int, default=2000)
    ap.add_argument("--overrides", nargs="*", default=[],
                    help="extra key=value config overrides, values as JSON")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "results.jsonl"),
                    help="JSON-lines file the record is appended to")
    ap.add_argument("--name", default="probe_b3", help="the record's name")
    harness.add_arguments(ap)
    return ap.parse_args(argv)


def probe_options(args):
    """The B3 probe's options: tools/probe_b3.py's overrides, then ``--overrides``."""
    H, W = (int(x) for x in args.size.split(","))
    over = {
        "model": "barf_inn_llff", "yaml": "barf_inn_llff",
        "data.root": args.scene_root, "data.scene": "blobfern",
        "data.image_size": [H, W], "data.val_ratio": 0.1,
        "barf_c2f": [0.1, 0.5],
        "inn.real_nvp.max_pe_iter": args.max_pe_iter,
        "loss_weight.global_alignment": 4,
        "max_iter": args.max_iter,
        "freq.scalar": 1000000, "freq.val": 1000000, "freq.ckpt": args.ckpt_freq,
        "output_root": args.out_root, "group": "r2", "name": "probe",
        "seed": args.seed,
    }
    over.update(harness.parse_overrides(args.overrides))
    return harness.build("barf_inn_llff", over)


def main(argv=None):
    """Run the probe; returns its record."""
    args = parse_args(argv)
    device = config.check_device(args.device)
    t0 = time.time()
    opt = probe_options(args)
    train, val, _ = scenes.blob_llff_arrays(
        n_images=args.n_images, img_size=(opt.H, opt.W), n_blobs=args.n_blobs,
        val_ratio=opt.data.val_ratio, backdrop=True, spread=args.spread,
        dense=args.dense, device=device)
    print("scene built: {} train / {} val views at {}x{} in {:.1f} s".format(
        len(train["idx"]), len(val["idx"]), opt.H, opt.W, time.time() - t0), flush=True)
    trainer = harness.make_trainer(opt, train, val, device)
    system = trainer.system
    init = harness.initial_pose_error(system)
    print("initial:", init, flush=True)
    row = harness.RowCheckpoint(opt.output_path, args.name, args.resume, t0)
    row.begin(system, init)
    history, train_s = harness.train_loop(system, args.iters, row,
                                          log_every=args.log_every)
    rec = dict(name=args.name, model=opt.model, yaml=opt.yaml,
               note="identity init on the blob+backdrop LLFF scene, {} views at "
                    "{}x{}".format(args.n_images, opt.H, opt.W),
               seed=args.seed, overrides=args.overrides)
    rec.update(harness.run_record(system, history, init, train_s, args.iters,
                                  opt.max_iter, pose=True))
    rec.update(segments=row.segments, elapsed_s=round(row.elapsed_s(), 1))
    print("final:", {k: rec[k] for k in ("final_rot_deg", "final_rot_rel_deg",
                                         "final_trans", "train_psnr")}, flush=True)
    print("probe val PSNR: {:.2f}".format(rec["val_psnr"]), flush=True)
    harness.append_record(args.out, rec)
    row.finish()
    return rec


if __name__ == "__main__":
    main()
