"""BARF: joint NeRF + per-image SE(3) pose refinement (port of
neural_invertible_warp_tpu/models/barf.py), and the machinery every
pose-optimizing system shares: a per-image learnable se(3) vector composed
onto the initial pose (identity on LLFF), the pose-group learning-rate
schedule with optional warmup, the validation-time Procrustes sim(3)
pre-alignment (host, float64), eval poses moved into the optimized frame,
the aligned pose error, and test-time photometric pose refinement of an
evaluation view (a per-view se(3) correction under Adam, differentiated
through K3 and K4 on the card). On LLFF the initial poses are the identity,
on Blender the GT poses composed with a seeded se(3) noise
(``camera.noise``), kept in ``aux["pose_noise"]``; on DTU those of
``pose.init`` (models/dtu.py); on iPhone and Tanks-and-Temples, as on
LLFF, the identity.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import align, lie, rays, sampling
from ..ops import pose as pose_ops
from .system import NerfSystem


class BarfSystem(NerfSystem):

    model_name = "barf"

    def build_graph(self, generator):
        graph = super().build_graph(generator)
        graph.se3_refine = nn.Embedding(self.n_train, 6)
        nn.init.zeros_(graph.se3_refine.weight)
        return graph

    def init_aux(self):
        """On Blender with ``camera.noise``: the se(3) noise composed onto
        the GT poses, drawn once from the system's generator."""
        aux = super().init_aux()
        opt = self.opt
        if opt.data.dataset == "blender" and opt.camera.get("noise"):
            se3_noise = torch.randn((self.n_train, 6), generator=self.generator,
                                    device=self.device) * opt.camera.noise
            aux["pose_noise"] = lie.se3_to_SE3(se3_noise)
        return aux

    def param_labels(self):
        labels = super().param_labels()
        labels["se3_refine"] = "pose"
        return labels

    def make_schedules(self):
        from ..utils.optim import exp_decay_gamma, exp_schedule
        scheds = super().make_schedules()
        opt = self.opt
        gamma = exp_decay_gamma(opt.max_iter, opt.optim.lr_pose,
                                opt.optim.get("lr_pose_end"))
        scheds["pose"] = exp_schedule(opt.optim.lr_pose, gamma,
                                      warmup=opt.optim.get("warmup_pose"))
        return scheds

    # ----------------------------------------------------------------- poses

    def _initial_pose(self):
        """The poses before refinement: the GT poses (with the pose noise,
        where there is one) on Blender, else the identity."""
        if self.opt.data.dataset == "blender":
            pose = self.train_data["pose"]
            if "pose_noise" in self.aux:
                pose = pose_ops.compose([self.aux["pose_noise"], pose])
            return pose
        return pose_ops.identity_pose((self.n_train,), dtype=self.train_data["pose"].dtype,
                                      device=self.device)

    def get_train_pose(self):
        pose_refine = lie.se3_to_SE3(self.graph.se3_refine.weight)
        return pose_ops.compose([pose_refine, self._initial_pose()])

    def get_all_training_poses(self):
        """(predicted w2c poses, GT poses) of the training images."""
        with torch.no_grad():
            return self.get_train_pose(), self.train_data["pose"]

    # ------------------------------------------------------------- alignment

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

    # ------------------------------------------- test-time photometric optim

    def test_time_optimized_pose(self, pose, intr, pixels, progress=1.0,
                                 generator=None, ray_u=None):
        """``optim.test_iter`` Adam steps (constant lr ``optim.lr_pose``) on a
        per-view se(3) correction composed onto ``pose`` [1,3,4], against the
        view's ``pixels`` [1,HW,3]: each step draws a fresh ray subset and
        renders it in mode "test-optim". The field's weights are frozen for
        the loop, so the render's backward skips its weight gradients.
        ``generator`` drives the ray draws; ``ray_u`` [test_iter, n_rays]
        optionally supplies them. Returns the refined pose [1,3,4]; the
        per-step losses stay in ``self.refine_losses`` (a device tensor)."""
        opt = self.opt
        n_rays = min(opt.nerf.rand_rays, self.HW)
        mode = (opt.get("tpu") or {}).get("ray_sample", "stratified")
        se3 = torch.zeros((1, 6), dtype=torch.float32, device=self.device,
                          requires_grad=True)
        optim = torch.optim.Adam([se3], lr=opt.optim.lr_pose, betas=(0.9, 0.999),
                                 eps=1e-8)
        params = [p for p in self.graph.parameters() if p.requires_grad]
        for p in params:
            p.requires_grad_(False)
        losses = []
        try:
            with torch.enable_grad():
                for it in range(opt.optim.test_iter):
                    ray_idx = sampling.sample_ray_subset(
                        self.HW, n_rays, mode=mode,
                        generator=generator if generator is not None else self.generator,
                        u=None if ray_u is None else ray_u[it], device=self.device)
                    pose_it = pose_ops.compose([lie.se3_to_SE3(se3), pose])
                    center, ray = rays.get_center_and_ray(pose_it, intr, ray_idx, self.W)
                    out = self.render_rays(center, ray, mode="test-optim",
                                           progress=progress, intr=intr)
                    loss = torch.mean((out["rgb"] - pixels[:, ray_idx]) ** 2)
                    optim.zero_grad(set_to_none=True)
                    loss.backward()
                    optim.step()
                    losses.append(loss.detach())
        finally:
            for p in params:
                p.requires_grad_(True)
        self.refine_losses = torch.stack(losses) if losses else torch.zeros(0)
        with torch.no_grad():
            return pose_ops.compose([lie.se3_to_SE3(se3), pose])
