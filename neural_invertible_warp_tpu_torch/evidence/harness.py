"""The quality harness: build a configuration, train it on an in-memory
scene, and read pose errors and PSNR along the way. The port's counterpart
of tools/evidence_r2.py's ``build`` / ``make_trainer`` / ``train_loop`` /
``relative_pose_error`` / ``fmt_history``, driving the port's ``Trainer``
and systems one ``train_step`` at a time.

A probe run resumes across processes through ``RowCheckpoint``: the latest
state of the run (the system's state tree, the readout rows so far, the
initial readout, the train seconds and the processes taken) in one file
beside the run's output, rewritten at each readout row and on SIGTERM.
Every step seeds its draws from (seed, step), so a run cut and resumed
reads out what an uncut one would.

``make_trainer`` pins TF32 off for cuBLAS and cuDNN (the warp's and the
field's fp32 products must stay fp32), as the entry points do.
"""

from __future__ import annotations

import json
import os
import pickle
import signal
import subprocess
import threading
import time

import numpy as np
import torch

from .. import config
from ..models.engine import Trainer
from ..ops import pose as pose_ops
from ..utils import ckpt
from .configs import apply_overrides, yaml_options


def build(yaml_name, overrides):
    """Options of ``options/<yaml_name>.yaml`` with ``overrides``
    ({"dotted.key": value}, typed), post-processed as the CLI does (run
    name, output directory, H and W)."""
    opt = apply_overrides(yaml_options(yaml_name), overrides)
    return config.process_options(opt)


def make_trainer(opt, train_arrays, val_arrays, device):
    """A ``Trainer`` on ``device`` with its system built on the arrays; TF32
    off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainer = Trainer(opt, device)
    trainer.build_system(train_arrays, val_arrays)
    return trainer


def initial_pose_error(system):
    """dict(rot (deg), trans) of the aligned pose error before training. For
    the INN models ``aux["global_rigid"]`` is set to the identity while it
    is read: before the first alignment it holds the initial poses, and the
    readout global_rigid o initial would count them twice."""
    aux = system.aux
    if "global_rigid" in aux:
        system.aux = dict(aux, global_rigid=pose_ops.identity_pose(
            (aux["global_rigid"].shape[0],), dtype=aux["global_rigid"].dtype,
            device=aux["global_rigid"].device))
    try:
        R, t = system.evaluate_camera_alignment()
    finally:
        system.aux = aux
    return dict(rot=float(np.rad2deg(np.mean(R))), trans=float(np.mean(t)))


def relative_pose_error(system, n_pairs=200, seed=0):
    """Gauge-invariant pose metric: mean relative-rotation error over random
    camera pairs (deg). The absolute (Procrustes-aligned) error is
    meaningless while the predicted camera centers are still collapsed at
    the identity init — the sim3 rotation fit to a degenerate center cloud
    is noise."""
    pose_pred, pose_GT = system.get_all_training_poses()
    if pose_pred is None:
        return float("nan")
    pose_pred = pose_pred.detach().cpu().numpy()
    pose_GT = pose_GT.detach().cpu().numpy()
    rng = np.random.RandomState(seed)
    B = pose_pred.shape[0]
    errs = []
    for _ in range(n_pairs):
        i, j = rng.choice(B, 2, replace=False)
        R_rel = pose_pred[i, :, :3] @ pose_pred[j, :, :3].T
        R_rel_gt = pose_GT[i, :, :3] @ pose_GT[j, :, :3].T
        cos = (np.trace(R_rel @ R_rel_gt.T) - 1) / 2
        errs.append(np.degrees(np.arccos(np.clip(cos, -1, 1))))
    return float(np.mean(errs))


def step_route(system):
    """What carries a train step of ``system``, from its ``tpu.*`` switches
    (the dispatch of ``NerfSystem.render_rays``)."""
    opt = system.opt
    tpu_cfg = opt.get("tpu") or {}
    mode = system._field_mode()
    fine = bool(opt.nerf.fine_sampling)
    if mode == "off":
        route = "the plain chain (no kernel)"
    elif mode == "field":
        route = "K1 (the MLP-only tier), compositing in PyTorch"
    elif not tpu_cfg.get("fused_raymarch", False):
        route = "K5, compositing in PyTorch"
    elif not tpu_cfg.get("fused_train", True):
        route = "K3 with K4 as its backward"
    elif not fine:
        route = "K2 (one-call train kernel)"
    elif tpu_cfg.get("fused_raymarch_full", True):
        route = "K2 for the coarse and the fine field"
    else:
        route = "K5 for the coarse field, K2 for the fine one"
    if tpu_cfg.get("fused_inn") and "global_rigid" in system.aux:
        route += ", the INN warp on K6"
    if system.device.type != "cuda":
        route += " (the kernels' plain versions, on the CPU)"
    return route


# the exit code of a probe stopped by SIGTERM once its checkpoint is written
STOPPED_RC = 128 + signal.SIGTERM


class RowCheckpoint:
    """The latest checkpoint of a probe run, ``<output_path>/<name>.row.ckpt``:
    a pickled dict of the system's state tree (``utils/ckpt.state_tree``:
    parameters, Adam moments and count, step, aux), the readout rows so
    far, the initial readout, the train and wall seconds so far and the
    processes taken. Written to a temporary file, then renamed over the
    last one, so a process stopped mid-write leaves the last whole file;
    only the renamed file is ever read. At each readout row, after the
    last step and on SIGTERM."""

    SUFFIX = ".row.ckpt"

    def __init__(self, output_path, name, resume=False, t0=None):
        self.path = os.path.join(output_path, name + self.SUFFIX)
        self.resume = resume
        self.init = None
        self.history = []
        self.shadow = []      # the records of train_loop's ``shadow`` calls
        self.train_s = 0.0
        self.wall_s = 0.0     # wall seconds of the earlier processes
        self.segments = 1
        self.t0 = time.time() if t0 is None else t0   # this process's start
        self.stopping = False

    def request_stop(self, signum=None, frame=None):
        """Ask ``train_loop`` to write the checkpoint after the step in hand
        and exit with ``STOPPED_RC`` (its SIGTERM handler)."""
        self.stopping = True

    def begin(self, system, init):
        """Take ``init`` (the initial readout of the freshly built system) as
        the run's; where ``resume`` is set and a checkpoint exists, load it
        into ``system`` and continue from its step. The rebuilt start must
        equal the checkpoint's (a scene, a draw or an SfM that does not
        repeat raises)."""
        self.init = init
        if not (self.resume and os.path.exists(self.path)):
            return
        with open(self.path, "rb") as f:
            payload = pickle.load(f)
        if json.dumps(payload["init"], sort_keys=True) != json.dumps(init, sort_keys=True):
            raise ValueError("{}: the rebuilt run starts at {}, the checkpoint's at {}".format(
                self.path, init, payload["init"]))
        ckpt.load_state_tree(system, payload["state"])
        self.history = payload["history"]
        self.shadow = payload.get("shadow", [])
        self.train_s = payload["train_s"]
        self.wall_s = payload["wall_s"]
        self.segments = payload["segments"] + 1
        print("resumed {} at step {} (process {})".format(self.path, system.step,
                                                          self.segments), flush=True)

    def save(self, system, history, train_s):
        payload = dict(state=ckpt.state_tree(system), history=history, init=self.init,
                       shadow=self.shadow, train_s=train_s,
                       wall_s=self.wall_s + time.time() - self.t0,
                       segments=self.segments)
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    @staticmethod
    def step_of(path):
        """The step of the checkpoint at ``path``."""
        with open(path, "rb") as f:
            return int(pickle.load(f)["state"]["step"])

    def elapsed_s(self):
        """Wall seconds of the run over all its processes."""
        return self.wall_s + time.time() - self.t0

    def finish(self):
        """Delete the checkpoint once the run's record is written."""
        for path in (self.path, self.path + ".tmp"):
            if os.path.exists(path):
                os.remove(path)


def train_loop(system, iters, row, log_every=5000, pose_errors=True, shadow=None,
               shadow_every=0):
    """Train steps up to ``iters`` with a readout row every ``log_every``
    steps and after the last: it, psnr (of the step), loss_ga (INN models),
    err_R_deg / err_t (Procrustes-aligned, mean over the training views),
    err_R_rel (``relative_pose_error``), elapsed (train s so far). Metrics
    reach the host only at those rows. The loop continues from the
    system's step and the rows of ``row`` (a ``RowCheckpoint`` after its
    ``begin``), writes the checkpoint at each readout row, and on SIGTERM
    writes it after the step in hand and exits with ``STOPPED_RC``.
    ``shadow(system)``, where given, is called on the untrained system and
    after every ``shadow_every``-th step; its records go to ``row.shadow``
    (kept in the checkpoint, outside the train seconds).
    Returns (the rows, the train seconds over all processes)."""
    print("train_loop: {} steps on {}; each carried by {}".format(
        iters, system.device, step_route(system)), flush=True)
    history = list(row.history)
    t0 = time.time() - row.train_s
    # only the main thread may install a signal handler
    handles_sigterm = threading.current_thread() is threading.main_thread()
    if handles_sigterm:
        previous = signal.signal(signal.SIGTERM, row.request_stop)
    try:
        if shadow is not None and system.step == 0:
            row.shadow = [shadow(system)]
            t0 = time.time()
        for it in range(system.step + 1, iters + 1):
            metrics = system.train_step()
            if shadow is not None and it % shadow_every == 0:
                t_shadow = time.time()
                row.shadow.append(shadow(system))
                t0 += time.time() - t_shadow
            readout = not (it % log_every and it != iters)
            if readout:
                rec = dict(it=it, psnr=float(metrics["psnr"]))
                if "loss_global_alignment" in metrics:
                    rec["loss_ga"] = float(metrics["loss_global_alignment"])
                if pose_errors:
                    R, t = system.evaluate_camera_alignment()
                    rec["err_R_deg"] = float(np.rad2deg(np.mean(R)))
                    rec["err_t"] = float(np.mean(t))
                    rec["err_R_rel"] = relative_pose_error(system)
                rec["elapsed"] = time.time() - t0
                history.append(rec)
                print(rec, flush=True)
            if readout or row.stopping:
                row.save(system, history, time.time() - t0)
            if row.stopping:
                print("train_loop: stopped after step {}; checkpoint {}".format(
                    it, row.path), flush=True)
                raise SystemExit(STOPPED_RC)
    finally:
        if handles_sigterm:
            signal.signal(signal.SIGTERM, previous)
    return history, time.time() - t0


def fmt_history(history):
    keys = list(history[0].keys())
    lines = ["| " + " | ".join(keys) + " |",
             "|" + "---|" * len(keys)]
    for r in history:
        cells = []
        for k in keys:
            v = r[k]
            cells.append("{:.4g}".format(v) if isinstance(v, float) else str(v))
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines) + "\n"


def card_line():
    """The card's name and power limit as nvidia-smi gives them, or None
    off the card."""
    if not torch.cuda.is_available():
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def parse_overrides(pairs):
    """``["a.b=value", ...]`` -> {"a.b": value}, each value parsed as JSON
    (``false``, ``3``, ``[0.1, 0.5]``, ``"text"``); a value that is not
    JSON stays a string."""
    out = {}
    for pair in pairs:
        key, value = pair.split("=", 1)
        try:
            out[key] = json.loads(value)
        except json.JSONDecodeError:
            out[key] = value
    return out


def run_record(system, history, init, train_s, iters, horizon, pose):
    """The result fields of a probe run (tools/probe_zoo_r4.py's record):
    the initial and final pose errors, ``max_rel_after_half`` (the worst
    err_R_rel from half the run on: the late kick of a c2f schedule shows
    there) beside ``rel_at_half``, loss_ga, the held-out PSNR (a
    ``validate`` pass), ms per step (readouts included) and the rows."""
    rec = {}
    if pose:
        rec["init_rot_deg"] = round(init["rot"], 4)
        rec["init_trans"] = round(init["trans"], 5)
    last = history[-1]
    rec["train_psnr"] = round(float(last["psnr"]), 3)
    if pose:
        rec["final_rot_deg"] = round(float(last["err_R_deg"]), 4)
        rec["final_rot_rel_deg"] = round(float(last["err_R_rel"]), 4)
        rec["final_trans"] = round(float(last["err_t"]), 5)
        mid = [h for h in history if h["it"] >= iters // 2]
        if len(mid) > 1:
            rec["max_rel_after_half"] = round(max(float(h["err_R_rel"]) for h in mid), 4)
            rec["rel_at_half"] = round(float(mid[0]["err_R_rel"]), 4)
    if "loss_ga" in last:
        rec["loss_ga"] = float(last["loss_ga"])
    val = system.validate()
    rec["val_psnr"] = round(float(val["psnr_val"]), 3)
    rec["ms_per_step"] = round(1000.0 * train_s / iters, 3)
    rec.update(iters=iters, horizon=horizon, route=step_route(system),
               device=str(system.device), card=card_line(), history=history)
    return rec


# the keys of the DTU evaluation (``DTUMixin.evaluate_full``): the aligned
# pose error (pose models), the test views' PSNR, SSIM and LPIPS after
# test-time refinement, the depth errors and the foreground-masked metrics
DTU_EVAL_KEYS = ("rot_error_deg", "trans_error", "PSNR", "SSIM", "LPIPS", "depth_abs",
                 "depth_rms", "PSNR_masked", "SSIM_masked", "LPIPS_masked")


def dtu_record(results):
    """The DTU evaluation's fields of a probe record, beside ``run_record``'s:
    each of ``DTU_EVAL_KEYS`` that ``results`` has, rounded to 5 places
    (LPIPS stays None without its weights)."""
    return {k: None if results[k] is None else round(float(results[k]), 5)
            for k in DTU_EVAL_KEYS if k in results}


def add_arguments(ap):
    """A probe's resume option, ``--resume``."""
    ap.add_argument("--resume", action="store_true",
                    help="continue from the run's checkpoint where there is one")


def append_record(path, rec):
    """Append ``rec`` as one JSON line to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
