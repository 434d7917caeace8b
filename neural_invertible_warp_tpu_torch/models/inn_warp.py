"""Invertible-neural-warp pose models, the paper's contribution (port of
neural_invertible_warp_tpu/models/inn_warp.py): ``barf_inn_llff``,
``nerf_inn_llff`` and ``barf_inn_blender``; models/dtu.py builds the DTU
variant on it.

Each image has a conditioning code (``warp_latent.enc_type``: ``l2fbarf`` a
learnable embedding, ``posenc`` a fixed encoding of the frame id,
``extrinsic`` a learnable 6-vector pushed through a PE); a shared invertible
DeformNetwork warps camera-frame ray points ([pixel grid on z=1; camera
center], on Blender first moved by the noisy initial poses) into world
space; rays are re-derived as warped grid minus warped center and rendered;
a global-alignment loss fits a rigid pose to the (camera-frame, warped)
point pairs with a Procrustes solver, keeps it as the pose readout
``aux["global_rigid"]`` and penalizes the warp's deviation from it. With
``tpu.fused_inn`` the warp runs as one CUDA kernel per direction (K6), which
covers the paper's configuration of the network; the switch raises on any
other. With the switch off (the default) the warp is the plain chain.

Under a ray-sharded step (``parallel.mesh``) every rank warps the points of
all the step's rays, fits the alignment on the full set and renders only
its own rays: the alignment term, the same on every rank, is divided by the
world size before the backward (``replicated_losses``), so the summed
gradient is the global one, and ``aux["global_rigid"]`` comes out the same
on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import align, inn, lie, posenc, rays
from ..ops import pose as pose_ops
from ..ops.cuda import fused_inn
from ..parallel import mesh
from .barf import BarfSystem
from .system import NerfSystem


class InnWarpSystem(BarfSystem):

    model_name = "barf_inn_llff"
    replicated_losses = ("global_alignment",)

    def __init__(self, opt, device):
        super().__init__(opt, device)
        wl = opt.get("warp_latent")
        self.enc_type = wl.enc_type if wl else "l2fbarf"
        self.multires = opt.inn.real_nvp.multires
        self.actfn = opt.inn.get("actfn", "softplus")
        self.anneal_mode = opt.inn.real_nvp.get("anneal") or "reference"

    def latent_dim(self):
        opt = self.opt
        if self.enc_type == "l2fbarf":
            return opt.warp_latent.embed_dim
        if self.enc_type == "posenc":
            return 2 * opt.warp_latent.posenc.freq_len
        if self.enc_type == "extrinsic":
            return 6 + 2 * 6 * opt.warp_latent.extrinsic.L
        raise NotImplementedError(self.enc_type)

    def build_graph(self, generator):
        """The field(s) (no se3_refine: the warp carries the poses), the
        warp and its latent table."""
        opt = self.opt
        graph = NerfSystem.build_graph(self, generator)
        graph.warp_mlp = inn.DeformNetwork(
            self.latent_dim(), d_hidden=opt.inn.real_nvp.d_hidden, n_blocks=3,
            n_layers=1, multires=self.multires, actfn=self.actfn,
            anneal=self.anneal_mode, generator=generator)
        if self.enc_type in ("l2fbarf", "extrinsic"):   # posenc has no learnable latent
            width = self.latent_dim() if self.enc_type == "l2fbarf" else 6
            graph.warp_latent = nn.Embedding(self.n_train, width)
            with torch.no_grad():   # torch.nn.Embedding default init: N(0, 1)
                graph.warp_latent.weight.normal_(0.0, 1.0, generator=generator)
        return graph

    def init_aux(self):
        """On Blender the pose noise composed onto the GT poses (``barf``: an
        se(3) draw; ``l2g``: a rotation and a translation draw), from the
        system's generator; and the pose readout, which starts at the
        initial poses and is refreshed every step by the Procrustes fit."""
        opt = self.opt
        aux = {}
        if opt.data.dataset == "blender":
            # an empty ``noise_type:`` means the default se(3) noise
            noise_type = opt.camera.get("noise_type") or "barf"
            draw = dict(generator=self.generator, device=self.device)
            if noise_type == "barf" and opt.camera.get("noise_barf"):
                se3_noise = torch.randn((self.n_train, 6), **draw) * opt.camera.noise_barf
                aux["pose_noise"] = lie.se3_to_SE3(se3_noise)
            elif noise_type == "l2g":
                so3_noise = torch.randn((self.n_train, 3), **draw) * opt.camera.noise_l2g_r
                t_noise = torch.randn((self.n_train, 3), **draw) * opt.camera.noise_l2g_t
                aux["pose_noise"] = torch.cat(
                    [lie.so3_to_SO3(so3_noise), t_noise[..., None]], dim=-1)
        aux["global_rigid"] = self._initial_pose_all(aux).contiguous()
        return aux

    def param_labels(self):
        opt = self.opt
        labels = {name: "main" for name, _ in self.graph.named_children()}
        labels["warp_mlp"] = "pose" if opt.inn.optimize.enabled else "frozen"
        if "warp_latent" in labels:
            labels["warp_latent"] = ("latent" if opt.warp_latent.optimize.enabled
                                     else "frozen")
        return labels

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

    def _initial_pose_all(self, aux=None):
        """Initial w2c poses of the training images: identity on LLFF, the
        GT poses with the pose noise on Blender (``l2g`` noise is applied
        after the pose, ``barf`` noise before it)."""
        opt = self.opt
        aux = self.aux if aux is None else aux
        if opt.data.dataset == "blender" and self.train_data is not None:
            pose = self.train_data["pose"]
            if "pose_noise" in aux:
                if opt.camera.get("noise_type") == "l2g":
                    pose = pose_ops.compose([pose, aux["pose_noise"]])
                else:
                    pose = pose_ops.compose([aux["pose_noise"], pose])
            return pose
        return pose_ops.identity_pose((self.n_train,), device=self.device)

    def _ray_frame(self):
        """The w2c poses the unwarped rays are cast from: none (the camera
        frame) on LLFF, the noisy initial poses on Blender."""
        return self._initial_pose_all() if self.opt.data.dataset == "blender" else None

    def _warp_feat(self):
        """The per-image conditioning code [n_train, latent_dim]."""
        opt = self.opt
        if self.enc_type == "l2fbarf":
            return self.graph.warp_latent.weight
        if self.enc_type == "posenc":
            frame_id = (torch.arange(1, self.n_train + 1, dtype=torch.float32,
                                     device=self.device) / self.n_train)[:, None]
            return posenc.positional_encoding(frame_id, opt.warp_latent.posenc.freq_len)
        if self.enc_type == "extrinsic":
            latent = self.graph.warp_latent.weight
            rot, trans = latent[:, :3], latent[:, 3:]
            rot_pe = posenc.positional_encoding(rot, opt.warp_latent.extrinsic.L)
            # The translation is encoded with the PE of the ROTATION part, as
            # the reference does (it passes ``rot`` to both encodings).
            # Checkpoints and the paper's extrinsic-latent ablation depend on
            # this feature layout: do not repair it.
            return torch.cat([rot, rot_pe, trans, rot_pe], dim=-1)
        raise NotImplementedError(self.enc_type)

    def alpha_ratio(self, step):
        opt = self.opt
        if opt.inn.real_nvp.get("c2f"):
            ratio = torch.tensor(float(step), dtype=torch.float32) \
                / opt.inn.real_nvp.max_pe_iter
            return torch.clamp(ratio, 0.0, 1.0).to(self.device)
        return torch.tensor(1.0, device=self.device)

    def warp_points(self, pts, step):
        """Warp [B,N,3] camera-frame points into world space: through the
        fused kernel's wrapper under ``tpu.fused_inn`` (which raises for a
        network the kernel does not cover), else through the plain chain."""
        feat = self._warp_feat()
        alpha = self.alpha_ratio(step)
        net = self.graph.warp_mlp
        if (self.opt.get("tpu") or {}).get("fused_inn", False):
            return fused_inn.fused_deform_forward(net, feat, pts, alpha)
        return net(feat, pts, alpha)

    def get_train_pose(self):
        raise RuntimeError("INN models render from warped local rays; "
                           "use _forward_train")

    def get_all_training_poses(self):
        """Pose readout = global_rigid o initial."""
        with torch.no_grad():
            pose = pose_ops.compose([self.aux["global_rigid"], self._initial_pose_all()])
        return pose, self.train_data["pose"]

    # ------------------------------------------------------------- train fwd

    def _l2g_depth_range(self, aux=None):
        """The Blender ``l2g`` variant rescales the depth range every step
        from the spread of the pose readout's camera centers. Returns
        (near, far) as 0-d tensors."""
        aux = self.aux if aux is None else aux
        depth_min, depth_max = self.opt.nerf.depth.range
        position = pose_ops.invert_pose(aux["global_rigid"])[..., 3]        # [B,3]
        diameter = torch.max(torch.linalg.norm(
            position[:, None, :] - position[None, :, :], dim=-1))
        total = depth_max + depth_min
        return depth_min / total * diameter, depth_max / total * diameter

    def _forward_train(self, ray_idx, step, depth_rand=None, noise_rand=None):
        opt = self.opt
        data = self.train_data
        depth_range = None
        if opt.data.dataset == "blender" and opt.camera.get("noise_type") == "l2g":
            depth_range = self._l2g_depth_range()
        center_cam, grid_cam = rays.get_unwarped_center_and_ray(
            data["intr"], ray_idx, self.W, pose_init=self._ray_frame())
        center_cam, grid_cam = center_cam.detach(), grid_cam.detach()
        N = ray_idx.shape[0]
        coords = torch.cat([grid_cam, center_cam], dim=1)             # [B,2N,3]
        warped = self.warp_points(coords, step)
        grid_w, center_w = warped[:, :N], warped[:, N:]
        ray = grid_w - center_w
        progress = (torch.tensor(float(step), dtype=torch.float32)
                    / opt.max_iter).to(self.device)
        # every rank warps all N rays (the alignment fits them all) and
        # renders its own
        ray_idx, depth_rand, noise_rand = self._shard_draws(ray_idx, depth_rand, noise_rand)
        target = data["pixels"][:, ray_idx]
        out = self.render_rays(mesh.shard_rays(center_w), mesh.shard_rays(ray), mode="train",
                               progress=progress, depth_range=depth_range, target=target,
                               depth_rand=depth_rand, noise_rand=noise_rand,
                               intr=data["intr"])
        extras = dict(grid_cam=grid_cam, center_cam=center_cam,
                      grid_w=grid_w, center_w=center_w, n_rays=N)
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


def verify_warp_rigidity(system, n_probes=10, seed=0):
    """Diagnostic: how rigid is the learned warp? For random vector pairs
    anchored at the warped origin, the angle between them before and after
    the warp of image 0 and the norm ratio; an exactly rigid warp preserves
    both. Returns dict of per-probe arrays (angles in degrees)."""
    rng = np.random.RandomState(seed)
    net = system.graph.warp_mlp
    alpha = system.alpha_ratio(system.step)

    def ang(a, b):
        c = np.dot(a, b) / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12)
        return float(np.degrees(np.arccos(np.clip(c, -1, 1))))

    with torch.no_grad():
        feat = system._warp_feat()[:1]

        def warp(p):
            pts = torch.as_tensor(p, dtype=torch.float32, device=system.device)
            return net(feat, pts[None, None], alpha)[0, 0].cpu().numpy()

        origin_w = warp(np.zeros(3, np.float32))
        angles_before, angles_after, norm_ratios = [], [], []
        for _ in range(n_probes):
            v1 = rng.randn(3).astype(np.float32)
            v2 = rng.randn(3).astype(np.float32)
            w1, w2 = warp(v1) - origin_w, warp(v2) - origin_w
            angles_before.append(ang(v1, v2))
            angles_after.append(ang(w1, w2))
            norm_ratios.append(float(np.linalg.norm(w1) / max(np.linalg.norm(v1), 1e-12)))
    return dict(angle_before=np.array(angles_before),
                angle_after=np.array(angles_after),
                norm_ratio=np.array(norm_ratios))
