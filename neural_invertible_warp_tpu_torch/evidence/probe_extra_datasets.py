"""Training evidence for the iPhone and Tanks-and-Temples dataset families,

    python -m neural_invertible_warp_tpu_torch.evidence.probe_extra_datasets \\
        --run iphone|iphone_narrow|tandt|tandt_narrow [--horizon 20000]

``barf`` with the paper's LLFF c2f schedule [0.1, 0.5] from identity poses,
on 3-D-consistent blob scenes made in memory on the run's device, in the
layouts the two loaders give:

* ``iphone`` (``barf_iphone``, 24 frames at 108x192): the unposed-video
  protocol. The loader's poses are dummy identities, so the pose readout is
  held against the TRUE generation poses: the gauge-free mean relative
  rotation over random pairs (``rel_rot_err_deg``) and the Umeyama
  sim(3)-aligned camera-center error (``aligned_center_err``). ``_narrow``:
  the slow pan (path_scale 0.35, ~3 deg mean pairwise rotation) instead of
  the wide orbit.
* ``tandt`` (``barf_llff`` with the Tanks-and-Temples loader, 24 views at
  180x320, NoPe split): the loader reports real GT, so the system's own
  aligned readout gives the errors. ``_narrow``: a gentle ~7 deg pan
  (arc_scale 0.1) instead of the 69 deg walk-through.

The record (tools/probe_extra_datasets.py's fields, with the readout rows
under ``history``) is appended to ``<out-dir>/results.jsonl``; ``--tag``
names it. Runs on the card; ``--device=cpu`` runs the plain PyTorch paths,
and without a card and without that flag it fails.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .. import config
from ..ops import align
from . import harness, scenes

OUT_DIR = os.path.join("build", "evidence", "zoo_r4")
N_IMAGES = 24
RUNS = {"iphone": 1.0, "iphone_narrow": 0.35, "tandt": 1.0, "tandt_narrow": 0.1}


def rel_rot_err_deg(pred_w2c, true_w2c, n_pairs=300, seed=0):
    """Gauge-free pose metric: the mean relative-rotation error (deg) over
    random camera pairs (pairs of a camera with itself dropped)."""
    rng = np.random.RandomState(seed)
    B = pred_w2c.shape[0]
    i = rng.randint(0, B, n_pairs)
    j = rng.randint(0, B, n_pairs)
    keep = i != j
    i, j = i[keep], j[keep]
    Rp = pred_w2c[:, :, :3]
    Rt = true_w2c[:, :, :3]
    Rp_rel = Rp[i] @ Rp[j].transpose(0, 2, 1)
    Rt_rel = Rt[i] @ Rt[j].transpose(0, 2, 1)
    dR = Rp_rel @ Rt_rel.transpose(0, 2, 1)
    tr = np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1)
    return float(np.rad2deg(np.mean(np.arccos(tr))))


def aligned_center_err(pred_w2c, true_w2c):
    """The Umeyama sim(3)-aligned camera-center error, as a fraction of the
    true centers' mean distance from their mean; NaN where the fit fails."""

    def centers(w2c):
        R, t = w2c[:, :, :3], w2c[:, :, 3]
        return -np.einsum("bij,bi->bj", R, t)

    cp, ct = centers(pred_w2c), centers(true_w2c)
    try:
        s, R, t = align.align_umeyama(ct, cp)
        cp_al = s * cp @ np.asarray(R).T + np.asarray(t)
    except Exception:
        return float("nan")
    scale = np.linalg.norm(ct - ct.mean(0), axis=-1).mean() + 1e-9
    return float(np.linalg.norm(cp_al - ct, axis=-1).mean() / scale)


def run_options(run, horizon=20000, out_dir=OUT_DIR):
    """The options of ``run``: tools/probe_extra_datasets.py's overrides."""
    over = {"model": "barf", "barf_c2f": [0.1, 0.5],
            "data.root": os.path.join(out_dir, "scenes", run), "max_iter": horizon,
            "freq.scalar": 1000000, "freq.val": 1000000, "freq.ckpt": 1000000,
            "output_root": os.path.join(out_dir, "out"), "group": "zoo_r5", "seed": 0}
    if run.startswith("iphone"):
        over.update({"yaml": "barf_iphone", "data.scene": "vid",
                     "data.image_size": [108, 192], "name": "barf_iphone_probe"})
    else:
        over.update({"yaml": "barf_llff", "data.dataset": "tandt", "data.scene": "Ballroom",
                     "data.image_size": [180, 320], "data.val_ratio": 8,
                     "name": "barf_tandt_probe"})
    return harness.build(over["yaml"], over)


def run_scene(run, opt):
    """(the arrays' maker, the scene's maker, their arguments) of ``run``'s
    scene: ``scenes.blob_iphone_arrays`` and ``scenes.iphone_scene``, or
    the Tanks-and-Temples pair, at N_IMAGES views of opt's size."""
    kw = dict(n_images=N_IMAGES, img_size=(opt.H, opt.W), val_ratio=opt.data.val_ratio)
    if run.startswith("iphone"):
        return scenes.blob_iphone_arrays, scenes.iphone_scene, dict(kw, path_scale=RUNS[run])
    return scenes.blob_tandt_arrays, scenes.tandt_scene, dict(kw, arc_scale=RUNS[run])


def run_one(run, horizon=20000, tag=None, device="cuda", out_dir=OUT_DIR):
    """Train ``run`` for ``horizon`` steps on its scene; returns the record,
    also appended to ``<out_dir>/results.jsonl``."""
    device = config.check_device(device)
    t0 = time.time()
    opt = run_options(run, horizon, out_dir)
    narrow = run.endswith("_narrow")
    iphone = run.startswith("iphone")
    make_arrays, _, kw = run_scene(run, opt)
    train, val, extra = make_arrays(device=device, **kw)
    if iphone:
        true_train = extra[:len(train["idx"])]
    trainer = harness.make_trainer(opt, train, val, device)
    system = trainer.system
    print("[{}] built in {:.1f}s".format(run, time.time() - t0), flush=True)

    def pose_errors():
        pred, _ = system.get_all_training_poses()
        pred = pred.cpu().numpy()
        return rel_rot_err_deg(pred, true_train), aligned_center_err(pred, true_train)

    log_every = max(2000, horizon // 10)
    if iphone:
        r0, c0 = pose_errors()
        print("[{}] init: rel-rot {:.3f} deg, center {:.4f}".format(run, r0, c0), flush=True)
        note = "unposed-video protocol: identity init on a {}; pose metrics vs the TRUE " \
               "generation poses (gauge-free rel-rot + sim3-aligned centers)".format(
                   "slow-pan narrow-baseline video (path_scale=0.35)" if narrow
                   else "smooth handheld orbit")
        t1 = time.time()
        history = harness.train_loop(system, horizon, log_every=log_every, pose_errors=False)
        train_s = time.time() - t1
        r1, c1 = pose_errors()
        val_psnr = system.validate()["psnr_val"]
        rec = dict(name=tag or "barf_iphone{}_{}k".format("_narrow" if narrow else "",
                                                          horizon // 1000),
                   model="barf", yaml="barf_iphone", horizon=horizon, note=note,
                   init_rel_rot_deg=round(r0, 4), init_center_err=round(c0, 5),
                   final_rel_rot_deg=round(r1, 4), final_center_err=round(c1, 5),
                   train_psnr=round(float(history[-1]["psnr"]), 3),
                   val_psnr=round(float(val_psnr), 3),
                   ms_per_step=round(1000.0 * train_s / horizon, 3), iters=horizon,
                   route=harness.step_route(system), device=str(system.device),
                   card=harness.card_line(), history=history)
    else:
        init = harness.initial_pose_error(system)
        print("[{}] init: rot {:.3f} deg trans {:.4f}".format(run, init["rot"],
                                                              init["trans"]), flush=True)
        note = "tandt {} arc, barf-class identity init; loader GT (centered/spherified) " \
               "via evaluate_camera_alignment".format(
                   "gentle ~7-deg pan (arc_scale=0.1)" if narrow else "walk-through")
        t1 = time.time()
        history = harness.train_loop(system, horizon, log_every=log_every)
        train_s = time.time() - t1
        rec = dict(name=tag or "barf_tandt{}_{}k".format("_narrow" if narrow else "",
                                                         horizon // 1000),
                   model="barf", yaml="barf_llff+tandt", horizon=horizon, note=note)
        rec.update(harness.run_record(system, history, init, train_s, horizon, horizon,
                                      pose=True))
    rec["elapsed_s"] = round(time.time() - t0, 1)
    print("[{}] RESULT {}".format(run, json.dumps(
        {k: v for k, v in rec.items() if k != "history"})), flush=True)
    harness.append_record(os.path.join(out_dir, "results.jsonl"), rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", required=True, choices=sorted(RUNS), help="the run")
    ap.add_argument("--horizon", type=int, default=20000)
    ap.add_argument("--tag", help="record the result under this name")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    return run_one(args.run, horizon=args.horizon, tag=args.tag, device=args.device,
                   out_dir=args.out_dir)


if __name__ == "__main__":
    main()
