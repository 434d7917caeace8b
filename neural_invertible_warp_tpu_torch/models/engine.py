"""Training engine (port of neural_invertible_warp_tpu/models/engine.py):
dataset loading, a plain Python train loop, logging, validation and
checkpoints. One ``train_step`` per iteration (the JAX package's
``lax.scan`` step batching has no counterpart here).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import get_system_class
from ..data import get_dataset
from ..utils import ckpt as ckpt_util
from ..utils.log import info as log


class Trainer:

    def __init__(self, opt, device):
        self.opt = opt
        self.device = torch.device(device)
        os.makedirs(opt.output_path, exist_ok=True)
        self.system = None
        self.train_image_names = None   # per-image file names of the training split
        self.step_seconds = []     # wall time of each step (device-synced)
        self.history = []          # per-step metrics, 0-d device tensors

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

    def train(self):
        opt = self.opt
        log("training start")
        end = min(opt.max_iter, opt.freq.get("early_termination") or opt.max_iter)
        t_start = time.time()
        while self.system.step < end:
            t0 = time.time()
            metrics = self.system.train_step()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.step_seconds.append(time.time() - t0)
            self.history.append(metrics)
            it = self.system.step
            if it % opt.freq.scalar == 0:
                self.log_scalars(metrics, it)
            if it % opt.freq.val == 0:
                self.run_validation(it)
            if it % opt.freq.ckpt == 0:
                self.save_checkpoint(it)
        elapsed = time.time() - t_start
        log("trained {} iters in {:.1f}s".format(len(self.step_seconds), elapsed))
        self.save_checkpoint(self.system.step)
        log("training done")

    def log_scalars(self, metrics, step, split="train"):
        host = {k: float(v) for k, v in metrics.items()}
        log("{} it {}: {}".format(split, step, " ".join(
            "{}={:.4g}".format(k, v) for k, v in sorted(host.items()))))

    def run_validation(self, step):
        res = self.system.validate(max_views=self.opt.data.get("val_sub"))
        self.log_scalars({k: v for k, v in res.items() if np.isscalar(v)}, step,
                         split="val")
        return res

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
    trainer.train()
    return trainer
