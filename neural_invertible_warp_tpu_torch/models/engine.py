"""Training engine (port of neural_invertible_warp_tpu/models/engine.py):
dataset loading, a plain Python train loop, logging (to the console and,
where ``tb`` is set and a writer is importable, to tensorboard, with the
validation images, encoded here without PIL or matplotlib), validation, the
live pose view ``poses.html`` every ``freq.vis`` steps, and checkpoints.
One ``train_step`` per iteration (the JAX package's ``lax.scan`` step
batching has no counterpart here).
``debug.nan_check`` runs the loop under autograd's anomaly detection and
checks the loss and every gradient after each step, raising
``FloatingPointError`` at the first non-finite one; ``tpu.profile_dir``
writes a ``torch.profiler`` trace of the loop there.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from . import get_system_class
from ..data import get_dataset
from ..utils import ckpt as ckpt_util
from ..utils import image_io
from ..utils.log import info as log
from ..utils.log import warn


def image_summary(summary_cls, tag, image):
    """(the ``Summary`` of one image, the uint8 it encodes) for float
    [H,W,C] ``image`` in [0, 1], as tensorboardX's ``summary.image`` makes
    it: ``(x * 255.0).astype(np.uint8)`` (no clip), PNG-encoded (here by
    ``image_io.encode_png``, without PIL); ``summary_cls`` is the
    ``Summary`` message of the writer's own proto module."""
    pixels = (np.asarray(image) * 255.0).astype(np.uint8)
    height, width, channels = pixels.shape
    encoded = summary_cls.Image(height=height, width=width, colorspace=channels,
                                encoded_image_string=image_io.encode_png(pixels))
    return summary_cls(value=[summary_cls.Value(tag=tag, image=encoded)]), pixels


class Trainer:

    def __init__(self, opt, device):
        self.opt = opt
        self.device = torch.device(device)
        os.makedirs(opt.output_path, exist_ok=True)
        self.system = None
        self.train_image_names = None   # per-image file names of the training split
        self.step_seconds = []     # wall time of each step (device-synced)
        self.history = []          # per-step metrics, 0-d device tensors
        self.tb = None             # tensorboard writer (setup_visualizer)
        self.tb_writer = None      # the writer's package, its Summary message
        self.tb_summary = None
        self.tb_images = {}        # tag -> (step, uint8) of the last validation's images
        self.live_pose_frames = []     # (step, aligned poses) of poses.html

    def load_dataset(self, eval_split="val"):
        """(train_arrays, test_arrays) of the configured dataset."""
        opt = self.opt
        data_mod = get_dataset(opt.data.dataset)
        log("loading training data...")
        train = data_mod.Dataset(opt, split="train", subset=opt.data.get("train_sub"))
        self.train_image_names = train.image_names()
        log("loading test data...")
        if opt.data.get("val_on_test"):
            eval_split = "test"
        test = data_mod.Dataset(opt, split=eval_split, subset=opt.data.get("val_sub"))
        return train.all_arrays(opt), test.all_arrays(opt)

    def build_system(self, train_arrays, test_arrays):
        """The system on the arrays; the training images' file names (from
        ``load_dataset``, or None for in-memory arrays) go to
        ``system.train_image_names`` before the initial poses are set, since
        ``pose.init: colmap_files`` matches COLMAP's images by name."""
        log("building networks...")
        self.system = get_system_class(self.opt.model)(self.opt, self.device)
        self.system.attach_data(train_arrays, test_arrays)
        self.system.train_image_names = self.train_image_names
        self.system.init_state(self.opt.seed or 0)

    def restore_checkpoint(self):
        """``--resume`` (latest, or ``--resume=<iter>``) continues a run;
        ``--load=<path>`` loads weights and state from a file."""
        opt = self.opt
        if opt.get("resume"):
            return ckpt_util.restore(opt.output_path, self.system, resume=opt.resume)
        if opt.get("load"):
            return ckpt_util.restore(opt.output_path, self.system, load_name=opt.load)
        log("initializing weights from scratch...")
        return 0

    def setup_visualizer(self):
        """A tensorboard writer into the run directory where ``tb`` is set:
        tensorboardX's, else torch.utils.tensorboard's, with the ``Summary``
        message of that writer's proto module (the validation images are
        encoded here, ``image_summary``); without either the run goes on
        without one, with a warning, as the JAX engine's does."""
        if self.opt.get("tb") is None:
            return
        try:
            from tensorboardX import SummaryWriter
            from tensorboardX.proto.summary_pb2 import Summary
            self.tb = SummaryWriter(logdir=self.opt.output_path, flush_secs=10)
            self.tb_writer = "tensorboardX"
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter
                from tensorboard.compat.proto.summary_pb2 import Summary
                self.tb = SummaryWriter(log_dir=self.opt.output_path, flush_secs=10)
                self.tb_writer = "torch.utils.tensorboard"
            except ImportError as e:
                warn("tensorboard writer unavailable: {}".format(e))
                return
        self.tb_summary = Summary
        log("tensorboard writer: {}".format(self.tb_writer))

    def train(self):
        opt = self.opt
        log("training start")
        nan_check = bool((opt.get("debug") or {}).get("nan_check"))
        profile_dir = (opt.get("tpu") or {}).get("profile_dir")
        t_start = time.time()
        with contextlib.ExitStack() as stack:
            if nan_check:
                stack.enter_context(torch.autograd.set_detect_anomaly(True))
            profiler = None
            if profile_dir:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = stack.enter_context(torch.profiler.profile(activities=activities))
            self._loop(nan_check)
        elapsed = time.time() - t_start
        log("trained {} iters in {:.1f}s".format(len(self.step_seconds), elapsed))
        self.save_checkpoint(self.system.step)
        if profiler is not None:
            os.makedirs(profile_dir, exist_ok=True)
            path = os.path.join(profile_dir, "trace.json")
            profiler.export_chrome_trace(path)
            log("profiler trace written to {}".format(path))
        if self.tb:
            self.tb.flush()
        log("training done")

    def _loop(self, nan_check):
        opt = self.opt
        end = min(opt.max_iter, opt.freq.get("early_termination") or opt.max_iter)
        freq_vis = opt.freq.get("vis")
        while self.system.step < end:
            t0 = time.time()
            try:
                metrics = self.system.train_step()
            except RuntimeError as e:
                # anomaly detection names the backward function that made a NaN
                if nan_check and "nan values" in str(e):
                    raise FloatingPointError("step {}: {}".format(self.system.step, e)) from e
                raise
            if nan_check:
                self.check_finite(metrics, self.system.step - 1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.step_seconds.append(time.time() - t0)
            self.history.append(metrics)
            it = self.system.step
            if it % opt.freq.scalar == 0:
                self.log_scalars(metrics, it)
            if it % opt.freq.val == 0:
                self.run_validation(it)
            if freq_vis and it % freq_vis == 0:
                self.update_live_pose_view(it)
            if it % opt.freq.ckpt == 0:
                self.save_checkpoint(it)

    def check_finite(self, metrics, step):
        """Raise FloatingPointError naming ``step`` and what is not finite
        among the step's metrics and the gradients it left (one host sync)."""
        named = list(metrics.items()) + [
            (name + ".grad", p.grad) for name, p in self.system.graph.named_parameters()
            if p.grad is not None]
        finite = torch.stack([torch.isfinite(v).all() for _, v in named]).tolist()
        bad = [name for (name, _), ok in zip(named, finite) if not ok]
        if bad:
            raise FloatingPointError("non-finite values at step {}: {}".format(
                step, ", ".join(bad)))

    def log_scalars(self, metrics, step, split="train"):
        host = {k: float(v) for k, v in metrics.items()}
        log("{} it {}: {}".format(split, step, " ".join(
            "{}={:.4g}".format(k, v) for k, v in sorted(host.items()))))
        if self.tb:
            for k, v in host.items():
                self.tb.add_scalar("{}/{}".format(split, k), v, step)

    def run_validation(self, step):
        res = self.system.validate(max_views=self.opt.data.get("val_sub"))
        self.log_scalars({k: v for k, v in res.items() if np.isscalar(v)}, step,
                         split="val")
        if self.tb and res.get("vis"):
            self._write_val_images(res, step)
        return res

    def _write_val_images(self, res, step):
        """The first validation view's rgb and inverse depth, and with
        ``tb.num_images`` [rows, cols] both as grids of the first views."""
        from ..ops.render import invdepth_map
        from ..utils.vis import colorize_depth, tile_images
        opt = self.opt

        def to_rgb(vis):
            return np.clip(vis["rgb"].reshape(opt.H, opt.W, 3), 0, 1)

        def to_invdepth(vis):
            inv = invdepth_map(torch.as_tensor(vis["depth"]), torch.as_tensor(vis["opacity"]),
                               ndc=bool(opt.camera.ndc))
            return colorize_depth(inv.numpy().reshape(opt.H, opt.W))

        vis_all = res.get("vis_all") or [res["vis"]]
        images = [("val/rgb", to_rgb(vis_all[0])), ("val/invdepth", to_invdepth(vis_all[0]))]
        if len(vis_all) > 1 and opt.get("tb") and opt.tb.get("num_images"):
            rows, cols = (int(x) for x in opt.tb.num_images)
            images += [("val/rgb_grid", tile_images([to_rgb(v) for v in vis_all], rows, cols)),
                       ("val/invdepth_grid",
                        tile_images([to_invdepth(v) for v in vis_all], rows, cols))]
        writer = self.tb._get_file_writer()
        self.tb_images = {}
        for tag, image in images:
            summary, pixels = image_summary(self.tb_summary, tag, image)
            writer.add_summary(summary, step)
            self.tb_images[tag] = (step, pixels)

    def update_live_pose_view(self, step):
        """Rewrite ``<output_path>/poses.html``, the interactive viewer of
        the pose trajectory so far (the reference's live visdom window):
        the training poses, aligned to the GT by the validation-time sim(3)
        where the model has one, as one more frame. Returns its path, or
        None for a model that predicts no poses."""
        from ..ops import align
        from ..utils.pose_viewer import export_interactive_poses
        system = self.system
        pose, pose_ref = system.get_all_training_poses()
        if pose is None:
            return None
        try:
            system.prealign()
            if system.sim3 is not None:
                pose = align.apply_sim3_to_poses(pose, system.sim3, "pred_to_GT")
        except (np.linalg.LinAlgError, ValueError) as e:   # early in training
            warn("live pose view: prealign skipped ({})".format(e))
        self.live_pose_frames.append((int(step), pose.detach().cpu().numpy()))
        out = os.path.join(self.opt.output_path, "poses.html")
        cam_depth = (self.opt.get("visdom") or {}).get("cam_depth", 0.2)
        return export_interactive_poses(
            out, self.live_pose_frames,
            pose_ref=None if pose_ref is None else pose_ref.detach().cpu().numpy(),
            cam_depth=cam_depth)

    def save_checkpoint(self, it):
        path = ckpt_util.save(self.opt.output_path, self.system, it)
        log("checkpoint saved: {}".format(path))
        return path


def run_training(opt, device):
    """Load the dataset, build the system, train; the planar experiments
    (``homography``, ``planar``, ``img_relu``) go to their own training loop, as
    in the JAX package (its models/engine.py:232-234)."""
    if opt.model in ("homography", "planar", "img_relu"):
        from .planar import run_planar_training
        return run_planar_training(opt, device)
    trainer = Trainer(opt, device)
    trainer.build_system(*trainer.load_dataset())
    trainer.restore_checkpoint()
    trainer.setup_visualizer()
    trainer.train()
    return trainer
