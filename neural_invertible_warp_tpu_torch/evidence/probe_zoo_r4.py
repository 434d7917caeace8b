"""The zoo-wide validation matrix at compressed and full horizons:

    python -m neural_invertible_warp_tpu_torch.evidence.probe_zoo_r4 --run <name>

A late c2f kick (a converged pose thrown off when the finest PE bands open,
at 0.40-0.45 of the schedule) only shows on the whole schedule, so every
model family runs a compressed 20k horizon with ALL schedule fractions kept
(``max_iter`` 20000: lr decay reaches lr_end, barf_c2f fractions and the INN
max_pe_iter scale with it), and a 200k one:

* ``barf_inn_blender`` (noisy-GT init sigma=0.15) on the dense Blender ball;
* ``barf`` on Blender (noisy init) and on LLFF (identity init);
* ``garf`` / ``garf_se3_field`` from the identity on LLFF, and on the
  tighter recovery scenes;
* ``nerf_gaussian``, ``nerf_blender_repr``, ``nerf_llff_repr`` at known
  poses (field quality only).

Scenes are made in memory on the run's device (``scenes.PROBE_SCENES``).
``--run`` runs one entry in this process and appends its record to
``<out-dir>/results.jsonl``; ``evidence.rows`` runs entries side by side or
in sequence (``DEFAULT_ORDER``), each its own process with its own log.
``--over key=value`` adds a config override (JSON value). Runs on the card; ``--device=cpu`` runs the
plain PyTorch paths.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from .. import config
from . import harness, scenes

OUT_DIR = os.path.join("build", "evidence", "zoo_r4")


def spec(model, yaml, scene, horizon, overrides=None, pose=True, note=""):
    return dict(model=model, yaml=yaml, scene=scene, horizon=horizon,
                overrides=dict(overrides or {}), pose=pose, note=note)


def _inn_over(horizon):
    # max_pe_iter is the one absolute-iteration schedule knob; keep its
    # fraction of the horizon at the config's 100k/200k = 0.5.
    return {"inn.real_nvp.max_pe_iter": horizon // 2,
            "loss_weight.global_alignment": 3}


def build_runs():
    runs = {}
    for tag, horizon in (("20k", 20000), ("200k", 200000)):
        runs["barf_inn_blender_" + tag] = spec(
            "barf_inn_blender", "barf_blender_inn", "blender_dense", horizon,
            _inn_over(horizon),
            note="noisy init sigma=0.15 (yaml default); dense scene (the "
                 "sparse blob ball is the EVIDENCE_r2 B2 degenerate gauge)")
        runs["barf_blender_" + tag] = spec(
            "barf", "barf_blender", "blender", horizon,
            {"barf_c2f": [0.1, 0.5]}, note="noisy init sigma=0.15, BARF c2f")
        runs["barf_llff_" + tag] = spec(
            "barf", "barf_llff", "llff", horizon,
            {"barf_c2f": [0.1, 0.5]}, note="identity init, BARF c2f")
        runs["garf_" + tag] = spec(
            "garf", "garf_llff", "llff", horizon,
            note="identity init, gaussian field, no PE/c2f")
        runs["garf_se3_field_" + tag] = spec(
            "garf_se3_field", "garf_llff_se3", "llff", horizon,
            note="identity init, se3 from warp MLP")
        runs["garf_recovery_" + tag] = spec(
            "garf", "garf_llff", "llff_garf", horizon,
            note="recovery-regime probe: dense+textured full-frame scene, "
                 "tight cluster (~5 deg init)")
        runs["garf_recovery_tight_" + tag] = spec(
            "garf", "garf_llff", "llff_garf_tight", horizon,
            note="clean-recovery regime: spread-0.12 face-forward cluster "
                 "(~3 deg pairwise init, the real-LLFF class the GARF "
                 "paper recovers); pass the reference's own "
                 "optim.warmup_pose pose-lr ramp via --over")
        runs["garf_se3_recovery_" + tag] = spec(
            "garf_se3_field", "garf_llff_se3", "llff_garf_tight", horizon,
            note="se3-from-warp-MLP on the clean-recovery scene; "
                 "optim.warmup_pose via --over")
        runs["nerf_gaussian_" + tag] = spec(
            "nerf_gaussian", "nerf_gaussian_llff", "llff", horizon,
            pose=False, note="known GT poses, field quality only")
        runs["nerf_blender_repr_" + tag] = spec(
            "nerf", "nerf_blender_repr", "blender", horizon, pose=False,
            note="NeRF-paper repro: relu+noise0+fine sampling; schedule "
                 "compressed from 500k")
        runs["nerf_llff_repr_" + tag] = spec(
            "nerf", "nerf_llff_repr", "llff", horizon,
            {"nerf.depth.range": [1, 8]}, pose=False,
            note="NeRF-paper repro: relu+noise1+fine; depth range overridden "
                 "to the synthetic scene's metric extent (config's [0,1] "
                 "assumes real-LLFF NDC-style bounds); schedule compressed "
                 "from 500k")
    return runs


RUNS = build_runs()

# Execution order: all compressed probes first (fast failure surface),
# then full-horizon runs in family-importance order.
DEFAULT_ORDER = [
    "barf_inn_blender_20k", "barf_blender_20k", "barf_llff_20k",
    "garf_20k", "garf_se3_field_20k", "nerf_gaussian_20k",
    "nerf_blender_repr_20k", "nerf_llff_repr_20k",
    "barf_inn_blender_200k", "barf_blender_200k", "garf_200k",
    "garf_se3_field_200k", "barf_llff_200k", "nerf_gaussian_200k",
    "nerf_llff_repr_200k", "nerf_blender_repr_200k",
]


def run_options(name, extra_over=None, horizon_over=None, out_dir=OUT_DIR):
    """(options, spec) of RUNS[name]: tools/probe_zoo_r4.py's overrides,
    the scene's loader options, the run's own, then ``extra_over``."""
    s = RUNS[name]
    if horizon_over:
        s = dict(s, horizon=horizon_over)
    over = {"model": s["model"], "yaml": s["yaml"], "max_iter": s["horizon"],
            "freq.scalar": 1000000, "freq.val": 1000000, "freq.ckpt": 1000000,
            "output_root": os.path.join(out_dir, "out"), "group": "zoo_r4",
            "name": name, "seed": 0,
            "data.root": os.path.join(out_dir, "scenes", s["scene"])}
    over.update(scenes.probe_scene_options(s["scene"]))
    over.update(s["overrides"])
    over.update(extra_over or {})
    return harness.build(s["yaml"], over), s


def run_one(name, extra_over=None, tag=None, horizon_over=None, device="cuda",
            out_dir=OUT_DIR):
    """Train RUNS[name] for its horizon on its scene; returns the record,
    also appended to ``<out_dir>/results.jsonl``."""
    device = config.check_device(device)
    t0 = time.time()
    opt, s = run_options(name, extra_over, horizon_over, out_dir)
    horizon = s["horizon"]
    train, val, _ = scenes.probe_scene(s["scene"], device=device)
    trainer = harness.make_trainer(opt, train, val, device)
    system = trainer.system
    print("[{}] built in {:.1f}s".format(name, time.time() - t0), flush=True)
    rec = dict(name=(tag or name), model=s["model"], yaml=s["yaml"],
               horizon=horizon, note=s["note"])
    has_pose = s["pose"] and hasattr(system, "evaluate_camera_alignment")
    init = None
    if has_pose:
        init = harness.initial_pose_error(system)
        print("[{}] initial: rot {:.3f} deg trans {:.4f}".format(
            name, init["rot"], init["trans"]), flush=True)
    t1 = time.time()
    history = harness.train_loop(system, horizon, log_every=max(2000, horizon // 10),
                                 pose_errors=has_pose)
    train_s = time.time() - t1
    rec.update(harness.run_record(system, history, init, train_s, horizon, horizon,
                                  pose=has_pose))
    rec["elapsed_s"] = round(time.time() - t0, 1)
    print("[{}] RESULT {}".format(name, json.dumps(
        {k: v for k, v in rec.items() if k != "history"})), flush=True)
    harness.append_record(os.path.join(out_dir, "results.jsonl"), rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", required=True, choices=sorted(RUNS), help="the entry to run")
    ap.add_argument("--over", action="append", default=[],
                    help="extra key=value override, value as JSON (one-off controls)")
    ap.add_argument("--tag", help="record the result under this name")
    ap.add_argument("--horizon", type=int,
                    help="override the spec horizon (one-off controls)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    return run_one(args.run, extra_over=harness.parse_overrides(args.over), tag=args.tag,
                   horizon_over=args.horizon, device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
