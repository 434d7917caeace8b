"""Invertible-neural-warp pose model, the paper's flagship (port of
neural_invertible_warp_tpu/models/inn_warp.py).

Each image has a learnable latent code (``l2fbarf``); a shared invertible
DeformNetwork warps camera-frame ray points ([pixel grid on z=1; camera
center]) into world space; rays are re-derived as warped grid minus warped
center and rendered; a global-alignment loss fits a rigid pose to the
(camera-frame, warped) point pairs with the quaternion Procrustes solver,
keeps it as the pose readout ``aux["global_rigid"]`` and penalizes the
warp's deviation from it. LLFF only: the Blender pose-noise variants, the
``posenc``/``extrinsic`` latents and fine sampling under the warp are not
ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import align, inn, rays
from ..ops import pose as pose_ops
from ..ops.nerf_mlp import NerfMLP
from .barf import BarfSystem
from .system import Graph


class InnWarpSystem(BarfSystem):

    model_name = "barf_inn_llff"

    def __init__(self, opt, device):
        super().__init__(opt, device)
        wl = opt.get("warp_latent")
        if not wl or wl.enc_type != "l2fbarf":
            raise NotImplementedError(
                "warp latents other than l2fbarf are not ported yet (ROADMAP M3)")
        self.multires = opt.inn.real_nvp.multires
        self.actfn = opt.inn.get("actfn", "softplus")
        self.anneal_mode = opt.inn.real_nvp.get("anneal") or "reference"

    def build_graph(self, generator):
        opt = self.opt
        nerf = NerfMLP(self.arch, view_dep=opt.nerf.view_dep, generator=generator)
        warp = inn.DeformNetwork(opt.warp_latent.embed_dim,
                                 d_hidden=opt.inn.real_nvp.d_hidden, n_blocks=3,
                                 n_layers=1, multires=self.multires,
                                 actfn=self.actfn, anneal=self.anneal_mode,
                                 generator=generator)
        latent = nn.Embedding(self.n_train, opt.warp_latent.embed_dim)
        with torch.no_grad():   # torch.nn.Embedding default init: N(0, 1)
            latent.weight.normal_(0.0, 1.0, generator=generator)
        return Graph(nerf=nerf, warp_mlp=warp, warp_latent=latent)

    def init_aux(self):
        # pose readout, refreshed every step by the Procrustes fit
        return {"global_rigid": pose_ops.identity_pose(
            (self.n_train,), device=self.device).contiguous()}

    def param_labels(self):
        opt = self.opt
        return {"nerf": "main",
                "warp_mlp": "pose" if opt.inn.optimize.enabled else "frozen",
                "warp_latent": ("latent" if opt.warp_latent.optimize.enabled
                                else "frozen")}

    def make_schedules(self):
        """main + pose (with warmup) + latent: the pose lr and schedule
        without warmup, like the reference's second pose param group."""
        from ..utils.optim import exp_decay_gamma, exp_schedule
        scheds = super().make_schedules()
        opt = self.opt
        gamma = exp_decay_gamma(opt.max_iter, opt.optim.lr_pose,
                                opt.optim.get("lr_pose_end"))
        scheds["latent"] = exp_schedule(opt.optim.lr_pose, gamma)
        return scheds

    # ----------------------------------------------------------------- poses

    def alpha_ratio(self, step):
        opt = self.opt
        if opt.inn.real_nvp.get("c2f"):
            ratio = torch.tensor(float(step), dtype=torch.float32) \
                / opt.inn.real_nvp.max_pe_iter
            return torch.clamp(ratio, 0.0, 1.0).to(self.device)
        return torch.tensor(1.0, device=self.device)

    def get_all_training_poses(self):
        """Pose readout = global_rigid o initial (identity on LLFF)."""
        pose_init = pose_ops.identity_pose((self.n_train,), device=self.device)
        pose = pose_ops.compose([self.aux["global_rigid"], pose_init])
        return pose, self.train_data["pose"]

    def render_rays(self, center, ray, **kwargs):
        if self.opt.nerf.fine_sampling:
            raise NotImplementedError(
                "fine sampling under the INN warp is not ported yet (ROADMAP M9)")
        return super().render_rays(center, ray, **kwargs)

    # ------------------------------------------------------------- train fwd

    def _forward_train(self, ray_idx, step, depth_rand=None, noise_rand=None):
        opt = self.opt
        data = self.train_data
        center_cam, grid_cam = rays.get_unwarped_center_and_ray(
            data["intr"], ray_idx, self.W)
        center_cam, grid_cam = center_cam.detach(), grid_cam.detach()
        N = ray_idx.shape[0]
        coords = torch.cat([grid_cam, center_cam], dim=1)             # [B,2N,3]
        warped = self.graph.warp_mlp(self.graph.warp_latent.weight, coords,
                                     self.alpha_ratio(step))
        grid_w, center_w = warped[:, :N], warped[:, N:]
        ray = grid_w - center_w
        progress = (torch.tensor(float(step), dtype=torch.float32)
                    / opt.max_iter).to(self.device)
        target = data["pixels"][:, ray_idx]
        out = self.render_rays(center_w, ray, mode="train", progress=progress,
                               target=target, depth_rand=depth_rand,
                               noise_rand=noise_rand)
        extras = dict(grid_cam=grid_cam, center_cam=center_cam,
                      grid_w=grid_w, center_w=center_w)
        return out, target, extras

    def compute_loss(self, out, target, extras):
        losses = super().compute_loss(out, target, extras)
        if self.opt.loss_weight.get("global_alignment") is not None:
            source = torch.cat([extras["grid_cam"], extras["center_cam"]], 1)
            target_pts = torch.cat([extras["grid_w"], extras["center_w"]], 1)
            R, t = align.rigid_points_registration(
                target_pts, source, method=self.opt.tpu.get("procrustes", "svd"))
            svd_poses = torch.cat([R, t[..., None]], dim=-1)            # w2c readout
            losses["global_alignment"] = torch.mean(
                (target_pts - pose_ops.cam2world(source, svd_poses)) ** 2)
            extras["svd_poses"] = svd_poses.detach()
        return losses

    def update_aux(self, extras):
        if "svd_poses" in extras:
            self.aux["global_rigid"] = extras["svd_poses"]
