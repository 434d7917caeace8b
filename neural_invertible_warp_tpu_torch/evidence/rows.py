"""The quality rows on the card, each its own process with its own log:

    python -m neural_invertible_warp_tpu_torch.evidence.rows R1 R2 [--out-dir DIR]

``ROWS`` names each row's probe and arguments (PERF.md, "Quality rows on
the card"); every entry of ``probe_zoo_r4.RUNS`` is a row too, under its
own name (``probe_zoo_r4.DEFAULT_ORDER`` is the zoo's order). The rows given run side by side, each a
``python -m neural_invertible_warp_tpu_torch.evidence.<probe>`` child that
logs to ``<out-dir>/<row>.log`` and appends its record to
``<out-dir>/<row>.jsonl``; ``--serial`` runs them one after another
instead (alone on the card, for their ms/step). ``--iters N`` cuts every
row to N steps on the same schedule (probe_b3, probe_dtu) or to a horizon
of N (probe_zoo_r4, probe_extra_datasets), for a short check. The kernels are built once before any
row starts. Past ``--deadline`` seconds every row still running is
stopped; its log keeps the readout rows it had written. Exits non-zero if
a row failed or was stopped. ``--summary`` prints, for every row with a
log in ``--out-dir``, its record (or, for a row stopped early, the last
readout row its log holds and the step of its checkpoint: partial) and its
readout rows from 0.35 to 0.55 of its schedule, where a late c2f kick
would show.

Rows outlive their processes. Every probe keeps the latest checkpoint of its
run under ``--out-dir`` (``<row>.row.ckpt``, 8.4 MB for a B3 row, deleted
once the row's record is written); a row stopped at ``--deadline`` writes
it after the step in hand. ``--resume`` skips every row whose record is
already in ``--out-dir``, continues a row that has a checkpoint from its
step, starts the others from step 0, and appends to each row's log. Where
the card runs on a copy of the checkout that brings back only an output
directory, carry a row's directory into the copy's ``build/`` (git-ignored,
but part of the copy), run with ``--out-dir build/<dir> --resume``, and
copy ``build/<dir>`` to the output directory at the end:

    python3 -m neural_invertible_warp_tpu_torch.evidence.rows R7 --resume \
        --out-dir build/<dir> --deadline 3420; rc=$?; cp -r build/<dir> <out>/; exit $rc
"""

from __future__ import annotations

import argparse
import ast
import glob
import json
import os
import subprocess
import sys
import time

from .harness import DTU_EVAL_KEYS, RowCheckpoint
from .probe_zoo_r4 import RUNS

_B3_20K = ["--iters", "20000", "--max-iter", "20000", "--max-pe-iter", "10000",
           "--log-every", "1000"]
_30K = ["--iters", "30000", "--log-every", "1000"]
_200K = ["--iters", "200000", "--log-every", "2000"]
_PLAIN = ["--overrides", "tpu.fused_pe=false", "tpu.fused_kernel=false"]

ROWS = {
    # the compressed horizon, where the late c2f kick of a PE precision
    # fault sits at ~8k: the kernel path, then the plain chain
    "R1": ("probe_b3", _B3_20K),
    "R2": ("probe_b3", _B3_20K + _PLAIN),
    # R1, R2 and R6 at other seeds: each path's spread
    "R1s1": ("probe_b3", _B3_20K + ["--seed", "1"]),
    "R1s2": ("probe_b3", _B3_20K + ["--seed", "2"]),
    "R2s1": ("probe_b3", _B3_20K + ["--seed", "1"] + _PLAIN),
    "R2s2": ("probe_b3", _B3_20K + ["--seed", "2"] + _PLAIN),
    # the flagship B3 row at three seeds
    "R3s0": ("probe_b3", _30K + ["--seed", "0"]),
    "R3s1": ("probe_b3", _30K + ["--seed", "1"]),
    "R3s2": ("probe_b3", _30K + ["--seed", "2"]),
    # fine sampling (K2 at 64 and 192 samples, K5 in the validation render)
    "R4": ("probe_zoo_r4", ["--run", "nerf_llff_repr_20k"]),
    "R5": ("probe_zoo_r4", ["--run", "nerf_blender_repr_20k"]),
    # R1 with the INN warp on K6
    "R6": ("probe_b3", _B3_20K + ["--overrides", "tpu.fused_inn=true"]),
    "R6s1": ("probe_b3", _B3_20K + ["--seed", "1", "--overrides", "tpu.fused_inn=true"]),
    "R6s2": ("probe_b3", _B3_20K + ["--seed", "2", "--overrides", "tpu.fused_inn=true"]),
    # R6s2 (R6's largest val-PSNR gap under R1) with K6 held against the plain
    # warp and float64 on its own trajectory every 1,000 steps
    "R6s2_shadow": ("probe_b3", _B3_20K + ["--seed", "2", "--shadow-k6", "1000",
                                           "--overrides", "tpu.fused_inn=true"]),
    # the same every 250 steps: how often the float64 rule fires on K6 and on
    # the plain warp
    "R6s2_shadow250": ("probe_b3", _B3_20K + ["--seed", "2", "--shadow-k6", "250",
                                              "--overrides", "tpu.fused_inn=true"]),
    # R1 and R6 at two more seeds, paired by seed
    "R1s3": ("probe_b3", _B3_20K + ["--seed", "3"]),
    "R1s4": ("probe_b3", _B3_20K + ["--seed", "4"]),
    "R6s3": ("probe_b3", _B3_20K + ["--seed", "3", "--overrides", "tpu.fused_inn=true"]),
    "R6s4": ("probe_b3", _B3_20K + ["--seed", "4", "--overrides", "tpu.fused_inn=true"]),
    # R1 in the JAX package's bf16 kernel mode: K2, K3 and K4 with bf16
    # operands (tpu.compute_dtype: bfloat16)
    "R1bf16": ("probe_b3", _B3_20K + ["--overrides", "tpu.compute_dtype=bfloat16"]),
    # the plain chain at seed 3, where R1s3 and R6s3 stick from 3k
    "R2s3": ("probe_b3", _B3_20K + ["--seed", "3"] + _PLAIN),
    # the paper's horizon, resumed across calls (~127 min alone at R1's
    # ms/step): EVIDENCE_r3 section 5e, JAX 0.086 deg rel / 0.175 abs, trans
    # 0.0040, 44.82 dB, no kick through 80k-92k
    "R7": ("probe_b3", _200K),
    # paper Table 2 on the blob DTU scene (EVIDENCE_r3 section 5b, 30k):
    # JAX 24.5 deg / 0.62 -> 0.51 deg abs / 0.27 rel, trans 0.0096, test PSNR
    # 32.07, masked 26.79 / 0.931, depth 0.097 / 0.334
    "D1": ("probe_dtu", _30K + ["--model", "barf_inn_dtu", "--init", "noisy_gt"]),
    # the SE(3) control: JAX 0.35 deg / 0.19, trans 0.0075, 32.23, masked
    # 29.20 / 0.955, depth 0.083 / 0.293
    "D2": ("probe_dtu", _30K + ["--model", "barf_dtu", "--init", "noisy_gt"]),
    # from the SfM (ZNCC, 42/42 registered): JAX 4.63 deg / 0.047 -> 0.67 deg /
    # 0.26, trans 0.0091, 31.80, masked 25.03 / 0.908, depth 0.097 / 0.308
    "D3": ("probe_dtu", _30K + ["--model", "barf_inn_dtu", "--init", "colmap"]),
    # D1 at 200k (EVIDENCE_r3 section 5f): JAX 24.5 deg -> 0.42 deg abs / 0.126 rel,
    # trans 0.0072, test PSNR 34.20, masked 28.38 / 0.947, depth 0.087 / 0.307
    "D4": ("probe_dtu", _200K + ["--model", "barf_inn_dtu", "--init", "noisy_gt"]),
    # EVIDENCE_r5 section 4, 20k: the iPhone slow pan, JAX 2.30 -> 0.397 deg
    # rel, center 0.057, 44.1 / 18.9 dB
    "X1": ("probe_extra_datasets", ["--run", "iphone_narrow", "--horizon", "20000"]),
    # the Tanks-and-Temples gentle pan, JAX 26.7 -> 1.92 deg / 0.265 rel,
    # trans 0.006, 49.3 / 35.3 dB
    "X2": ("probe_extra_datasets", ["--run", "tandt_narrow", "--horizon", "20000"]),
}
ROWS.update({name: ("probe_zoo_r4", ["--run", name]) for name in RUNS})
# barf on the LLFF blob scene at two more seeds (the scene stays at seed 0)
ROWS.update({"barf_llff_20k_s{}".format(seed): (
    "probe_zoo_r4", ["--run", "barf_llff_20k", "--over", "seed={}".format(seed)])
    for seed in (1, 2)})


def row_command(row, out_dir, device, iters=None, resume=False):
    probe, args = ROWS[row]
    cmd = [sys.executable, "-m", "neural_invertible_warp_tpu_torch.evidence." + probe]
    cmd += list(args) + ["--device", device]
    if probe in ("probe_b3", "probe_dtu"):
        cmd += ["--name", row, "--out", os.path.join(out_dir, row + ".jsonl"),
                "--out-root", os.path.join(out_dir, "runs")]
        if iters:
            cmd += ["--iters", str(iters), "--log-every", str(max(1, iters // 2))]
    else:
        cmd += ["--tag", row, "--out-dir", os.path.join(out_dir, row)]
        if iters:
            cmd += ["--horizon", str(iters)]
    if resume:
        cmd.append("--resume")
    return cmd


def row_record(out_dir, row):
    """The last record of ``row`` in ``out_dir``, or None."""
    for path in (os.path.join(out_dir, row + ".jsonl"),
                 os.path.join(out_dir, row, "results.jsonl")):
        if os.path.exists(path):
            with open(path) as f:
                return json.loads(f.read().splitlines()[-1])
    return None


def row_checkpoint_step(out_dir, row):
    """The step of ``row``'s checkpoint under ``out_dir``, or None."""
    paths = glob.glob(os.path.join(out_dir, "**", row + RowCheckpoint.SUFFIX),
                      recursive=True)
    return RowCheckpoint.step_of(paths[0]) if paths else None


def summary(out_dir):
    """One line per row of ``out_dir``: its record, or the last readout row
    of its log where it has none (partial); then its rows in the window
    0.35-0.55 of the schedule. Returns dict row -> (record or None, rows)."""
    out = {}
    for log in sorted(glob.glob(os.path.join(out_dir, "*.log"))):
        row = os.path.basename(log)[:-4]
        with open(log) as f:
            lines = f.read().splitlines()
        rows = [ast.literal_eval(line) for line in lines if line.startswith("{'it': ")]
        rec = row_record(out_dir, row)
        out[row] = (rec, rows)
        if rec is not None:
            keys = ("iters", "horizon", "init_rot_deg", "init_trans", "final_rot_rel_deg",
                    "final_rot_deg", "final_trans", "rel_at_half", "max_rel_after_half",
                    "init_rel_rot_deg", "init_center_err", "final_rel_rot_deg",
                    "final_center_err", "train_psnr", "val_psnr") + DTU_EVAL_KEYS + (
                        "ms_per_step", "segments", "elapsed_s", "card")
            print("{} complete: {}".format(row, {k: rec[k] for k in keys if k in rec}))
            horizon = rec["horizon"]
        else:
            print("{} partial: checkpoint at step {}, last row {}".format(
                row, row_checkpoint_step(out_dir, row), rows[-1] if rows else None))
            # the schedule horizon from the command, the log's first line
            words = lines[0].split() if lines else []
            at = [i for i, w in enumerate(words) if w in ("--max-iter", "--horizon")]
            horizon = int(words[at[-1] + 1]) if at else None
        if horizon:
            window = [r for r in rows if 0.35 * horizon <= r["it"] <= 0.55 * horizon]
            print("{} rows at 0.35-0.55 of {}: {}".format(row, horizon, window))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="*", choices=sorted(ROWS))
    ap.add_argument("--summary", action="store_true",
                    help="print the rows found in --out-dir and run nothing")
    ap.add_argument("--out-dir", default=os.path.join("build", "evidence", "rows"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--serial", action="store_true")
    ap.add_argument("--iters", type=int)
    ap.add_argument("--deadline", type=float, default=float("inf"),
                    help="seconds after which running rows are stopped (each writes "
                         "its checkpoint first)")
    ap.add_argument("--resume", action="store_true",
                    help="skip the rows whose record is in --out-dir and continue "
                         "those with a checkpoint; to carry rows to a copy of the "
                         "checkout on another machine, put their directory under "
                         "build/ (git-ignored, but copied) and give it as --out-dir")
    args = ap.parse_args(argv)
    if args.summary:
        summary(args.out_dir)
        return 0
    os.makedirs(args.out_dir, exist_ok=True)
    if args.device == "cuda":
        from ..ops.cuda import build
        lib = build.load_library()
        print("rows: kernels built in {:.1f} s".format(lib.build_seconds), flush=True)
    t0 = time.time()
    running, rcs = {}, {}

    def start(row):
        cmd = row_command(row, args.out_dir, args.device, args.iters, args.resume)
        log = open(os.path.join(args.out_dir, row + ".log"), "a" if args.resume else "w")
        log.write(" ".join(cmd) + "\n")
        log.flush()
        print("rows: {} started at {:.0f} s: {}".format(row, time.time() - t0,
                                                       " ".join(cmd[2:])), flush=True)
        running[row] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log)

    queue = list(args.rows)
    if args.resume:
        for row in list(queue):
            if row_record(args.out_dir, row) is not None:
                print("rows: {} has its record; skipped".format(row), flush=True)
                queue.remove(row)
            else:
                step = row_checkpoint_step(args.out_dir, row)
                print("rows: {} {}".format(row, "from step 0" if step is None else
                                          "resumes at step {}".format(step)), flush=True)
    while queue or running:
        if time.time() - t0 > args.deadline:
            queue.clear()
        while queue and (not args.serial or not running):
            start(queue.pop(0))
        time.sleep(2)
        for row, (proc, log) in list(running.items()):
            if proc.poll() is None and time.time() - t0 > args.deadline:
                proc.terminate()
                try:
                    proc.wait(30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            if proc.poll() is not None:
                log.close()
                rcs[row] = proc.returncode
                del running[row]
                print("rows: {} rc={} at {:.0f} s".format(row, proc.returncode,
                                                         time.time() - t0), flush=True)
    return 1 if any(rcs.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
