"""Pose-optimizing systems' shared machinery (port of
neural_invertible_warp_tpu/models/barf.py): the pose-group learning-rate
schedule with optional warmup, the validation-time Procrustes sim(3)
pre-alignment (host, float64), eval poses moved into the optimized frame,
and the aligned pose error. The SE(3)-refinement BARF model itself and
test-time pose refinement are not ported yet (ROADMAP M8, M9).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import align
from ..ops import pose as pose_ops
from .system import NerfSystem


class BarfSystem(NerfSystem):

    model_name = "barf"

    def make_schedules(self):
        from ..utils.optim import exp_decay_gamma, exp_schedule
        scheds = super().make_schedules()
        opt = self.opt
        gamma = exp_decay_gamma(opt.max_iter, opt.optim.lr_pose,
                                opt.optim.get("lr_pose_end"))
        scheds["pose"] = exp_schedule(opt.optim.lr_pose, gamma,
                                      warmup=opt.optim.get("warmup_pose"))
        return scheds

    def get_all_training_poses(self):
        """(predicted w2c poses, GT poses) of the training images."""
        raise NotImplementedError

    def prealign(self):
        """sim(3) between predicted and GT camera centers, in float64 on the host."""
        pose_pred, pose_GT = self.get_all_training_poses()
        zero = torch.zeros((pose_pred.shape[0], 1, 3), dtype=torch.float32)
        center_pred = pose_ops.cam2world(zero, pose_pred.float().cpu())[:, 0]
        center_GT = pose_ops.cam2world(zero, pose_GT.float().cpu())[:, 0]
        try:
            sim3 = align.procrustes_analysis_np(center_GT.numpy(), center_pred.numpy())
        except np.linalg.LinAlgError:
            sim3 = dict(t0=np.zeros(3, np.float32), t1=np.zeros(3, np.float32),
                        s0=np.float32(1), s1=np.float32(1),
                        R=np.eye(3, dtype=np.float32))
        self.sim3 = {k: torch.as_tensor(v, device=self.device) for k, v in sim3.items()}
        return self.sim3

    def get_eval_pose(self, pose_GT):
        if self.sim3 is None:
            return pose_GT
        return align.apply_sim3_to_poses(pose_GT, self.sim3, direction="GT_to_pred")

    def evaluate_camera_alignment(self):
        """Procrustes-aligned rotation (rad) and translation errors per image."""
        pose_pred, pose_GT = self.get_all_training_poses()
        sim3 = self.prealign()
        pose_aligned = align.apply_sim3_to_poses(pose_pred, sim3, direction="pred_to_GT")
        R_err, t_err = pose_ops.pose_distance(pose_aligned, pose_GT)
        return R_err.cpu().numpy(), t_err.cpu().numpy()

    def validate(self, max_views=None):
        res = super().validate(max_views=max_views)
        R_err, t_err = self.evaluate_camera_alignment()
        res["error_R"] = float(np.mean(R_err))
        res["error_t"] = float(np.mean(t_err))
        return res
