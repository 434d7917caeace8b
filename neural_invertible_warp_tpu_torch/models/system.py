"""Base NeRF system (port of neural_invertible_warp_tpu/models/system.py).

Holds the data on the device, the field (``self.graph``), the optimizer,
the step counter and the non-optimized ``aux`` state; runs the train step
as an eager autograd pass and renders full images as a loop over ray
chunks. The render core sends the flagship's branches to the CUDA kernels
(K2 for training with a target; K3 for eval, and K3 with K4 as its backward
for test-time pose refinement and for training under ``tpu.fused_train:
false``); the branches not ported yet raise ``NotImplementedError`` naming
the ROADMAP item that brings them. ``evaluate_full`` is the full test-set
evaluation: pose error, test-time refinement, PSNR, SSIM, LPIPS.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch import nn

from ..ops import rays, sampling
from ..ops.cuda import fused_pe
from ..utils import log


class Graph(nn.Module):
    """Learnable state, one child per top-level group, named as the
    reference Graph names them (nerf, se3_refine, warp_mlp, warp_latent)."""

    def __init__(self, **children):
        super().__init__()
        for name, child in children.items():
            setattr(self, name, child)


class NerfSystem:

    model_name = "nerf"

    def __init__(self, opt, device):
        self.opt = opt
        self.device = torch.device(device)
        self.H, self.W = opt.H, opt.W
        self.HW = opt.H * opt.W
        self.arch = opt.arch
        self.n_train = None
        self.train_data = None
        self.test_data = None
        self.sim3 = None
        self.graph = None
        self.optim = None
        self.aux = {}
        self.step = 0
        self.generator = None

    # ------------------------------------------------------------------ data

    def attach_data(self, train_arrays, test_arrays):
        """Upload the split arrays (image [B,H,W,3], intr, pose, ...) to the device."""
        def to_device(arrays):
            d = {k: torch.as_tensor(np.asarray(v), device=self.device)
                 for k, v in arrays.items()}
            d["pixels"] = d["image"].reshape(d["image"].shape[0], -1, 3)
            return d
        self.train_data = to_device(train_arrays)
        self.test_data = to_device(test_arrays)
        self.n_train = int(self.train_data["image"].shape[0])

    # ---------------------------------------------------------------- state

    def build_graph(self, generator):
        raise NotImplementedError

    def init_aux(self):
        return {}

    def param_labels(self):
        """dict top-level graph child -> optimizer label."""
        return {name: "main" for name, _ in self.graph.named_children()}

    def label_keys(self):
        keys = {}
        for name, label in self.param_labels().items():
            keys.setdefault(label, []).append(name)
        return keys

    def make_schedules(self):
        from ..utils.optim import exp_decay_gamma, exp_schedule
        opt = self.opt
        if opt.optim.get("clip_norm") or opt.optim.get("clip_norm_pose"):
            raise NotImplementedError(
                "gradient clipping is not ported yet (ROADMAP M5)")
        gamma = exp_decay_gamma(opt.max_iter, opt.optim.lr, opt.optim.get("lr_end"))
        return {"main": exp_schedule(opt.optim.lr, gamma)}

    def init_state(self, seed=0):
        """Parameters from a seeded CPU generator (device-independent), then
        the optimizer and aux state on the device."""
        from ..utils.optim import MultiAdam
        gen = torch.Generator().manual_seed(int(seed))
        self.graph = self.build_graph(gen).to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        groups = {}
        for name, label in self.param_labels().items():
            groups.setdefault(label, []).extend(getattr(self.graph, name).parameters())
        for p in groups.get("frozen", []):
            p.requires_grad_(False)
        self.optim = MultiAdam(groups, self.make_schedules())
        self.aux = self.init_aux()
        self.step = 0

    # ---------------------------------------------------------------- render

    def render_rays(self, center, ray, mode="train", progress=1.0,
                    depth_range=None, target=None, depth_rand=None):
        """Stratified samples -> field -> compositing for center/ray [B,R,3].

        ``mode`` is "train" (stratified depths), "eval" or "test-optim"
        (midpoint depths; the latter is differentiated by test-time pose
        refinement). ``depth_rand`` [B,R,K,1] optionally supplies the
        stratification draw. Returns dict(rgb, depth, opacity[,
        render_sq_sum, render_n]).
        """
        opt = self.opt
        if opt.nerf.fine_sampling:
            raise NotImplementedError("fine sampling is not ported yet (ROADMAP M9)")
        if mode == "train" and opt.nerf.get("density_noise_reg"):
            raise NotImplementedError(
                "density_noise_reg is not ported yet (ROADMAP M9)")
        if opt.camera.ndc:
            raise NotImplementedError("NDC rays are not ported yet (ROADMAP M1)")
        if mode not in ("train", "eval", "test-optim"):
            raise ValueError("unknown render mode: {!r}".format(mode))
        B, R = center.shape[0], center.shape[1]
        depth_range = depth_range if depth_range is not None \
            else tuple(opt.nerf.depth.range)
        depth = sampling.sample_depth(
            B, R, opt.nerf.sample_intvs, depth_range, param=opt.nerf.depth.param,
            stratified=bool(opt.nerf.sample_stratified and mode == "train"),
            generator=self.generator, rand=depth_rand, device=center.device)
        kw = dict(progress=progress,
                  barf_c2f=tuple(opt.barf_c2f) if opt.get("barf_c2f") else None,
                  setbg_opaque=bool(opt.nerf.get("setbg_opaque")),
                  bgcolor=opt.data.get("bgcolor"),
                  density_activ=self.arch.get("density_activ", "softplus"))
        if (mode == "train" and target is not None
                and (opt.get("tpu") or {}).get("fused_train", True)):
            out, sq, n_terms = fused_pe.fused_render_rays_pe_train(
                self.graph.nerf, center, ray, depth, target, **kw)
            out["render_sq_sum"] = sq
            out["render_n"] = n_terms
            return out
        rgb, d, opac = fused_pe.fused_render_rays_pe(
            self.graph.nerf, center, ray, depth, **kw)
        return dict(rgb=rgb, depth=d, opacity=opac)

    # ---------------------------------------------------------------- losses

    def compute_loss(self, out, target, extras):
        if "render_sq_sum" in out:    # the one-call train kernel's squared error
            return {"render": out["render_sq_sum"] / out["render_n"]}
        return {"render": torch.mean((out["rgb"] - target) ** 2)}

    def summarize_loss(self, losses):
        """total = sum 10^w_k * L_k over the weighted losses."""
        total = 0.0
        for k, l in losses.items():
            w = self.opt.loss_weight.get(k)
            if w is not None:
                total = total + (10.0 ** float(w)) * l
        return total

    # ------------------------------------------------------------ train step

    def get_train_pose(self):
        """w2c poses [n_train,3,4] the training rays are cast from."""
        return self.train_data["pose"]

    def _forward_train(self, ray_idx, step, depth_rand=None):
        """One training forward over the drawn rays of every image; returns
        (out, target, extras)."""
        data = self.train_data
        center, ray = rays.get_center_and_ray(self.get_train_pose(), data["intr"],
                                              ray_idx, self.W)
        progress = (torch.tensor(float(step), dtype=torch.float32)
                    / self.opt.max_iter).to(self.device)
        target = data["pixels"][:, ray_idx]
        out = self.render_rays(center, ray, mode="train", progress=progress,
                               target=target, depth_rand=depth_rand)
        return out, target, {}

    def update_aux(self, extras):
        pass

    def train_step(self, ray_u=None, depth_rand=None):
        """One optimization step over all training images. One ray-index
        draw is shared by every image (``rand_rays // n_train`` rays each).
        ``ray_u`` / ``depth_rand`` optionally supply the step's random draws.
        Returns the step's metrics as 0-d tensors (no host sync)."""
        opt = self.opt
        n_rays = opt.nerf.rand_rays // self.n_train
        ray_idx = sampling.sample_ray_subset(
            self.HW, n_rays, mode=(opt.get("tpu") or {}).get("ray_sample", "stratified"),
            generator=self.generator, u=ray_u, device=self.device)
        self.optim.zero_grad()
        out, target, extras = self._forward_train(ray_idx, self.step, depth_rand)
        losses = self.compute_loss(out, target, extras)
        total = self.summarize_loss(losses)
        total.backward()
        self.optim.step()
        self.update_aux(extras)
        self.step += 1
        metrics = {"loss_" + k: v.detach() for k, v in losses.items()}
        metrics["loss_all"] = total.detach()
        metrics["psnr"] = -10.0 * torch.log10(metrics["loss_render"])
        return metrics

    # ----------------------------------------------------------- eval render

    @torch.no_grad()
    def render_image(self, pose, intr, progress=1.0):
        """Full image for pose [1,3,4], intr [1,3,3]: a loop over chunks of
        ``min(rand_rays, H*W)`` rays. Returns dict of [1, H*W, C] tensors."""
        chunk = min(self.opt.nerf.rand_rays, self.HW)
        outs = []
        for start in range(0, self.HW, chunk):
            idx = torch.arange(start, min(start + chunk, self.HW), device=self.device)
            center, ray = rays.get_center_and_ray(pose, intr, idx, self.W)
            outs.append(self.render_rays(center, ray, mode="eval", progress=progress))
        return {k: torch.cat([o[k] for o in outs], dim=1) for k in outs[0]}

    # ------------------------------------------------------------ validation

    def prealign(self):
        return None

    def get_eval_pose(self, pose_GT):
        return pose_GT

    def validate(self, max_views=None):
        """Render held-out views; returns psnr_val, the first view's maps
        (``vis``) and those of the first ``tb.num_images`` views (``vis_all``)."""
        self.prealign()
        data = self.test_data
        n = int(data["image"].shape[0])
        if max_views:
            n = min(n, max_views)
        progress = torch.tensor(float(self.step), dtype=torch.float32) / self.opt.max_iter
        n_vis = 1
        tb_cfg = self.opt.get("tb")
        if tb_cfg and tb_cfg.get("num_images"):
            rows, cols = tb_cfg.num_images
            n_vis = int(rows) * int(cols)
        psnrs, vis_all = [], []
        for i in range(n):
            pose = self.get_eval_pose(data["pose"][i:i + 1])
            out = self.render_image(pose, data["intr"][i:i + 1], progress.to(self.device))
            mse = float(torch.mean((out["rgb"] - data["pixels"][i:i + 1]) ** 2))
            psnrs.append(-10.0 * np.log10(mse))
            if len(vis_all) < n_vis:
                vis_all.append({k: v.cpu().numpy() for k, v in out.items()})
        return dict(psnr_val=float(np.mean(psnrs)), vis=vis_all[0], vis_all=vis_all)

    # -------------------------------------------------------- full evaluation

    def evaluate_full(self, output_path=None, dump_images=True, test_optim=None):
        """Evaluate every test view: Procrustes-aligned pose error (pose
        models), optional test-time pose refinement, full-image render, PSNR,
        SSIM and LPIPS (``None`` / "unavailable" without AlexNet weights).
        Writes ``quant.txt``, ``quant_pose.txt`` and, with ``dump_images``,
        ``test_view/{rgb,rgb_GT,depth}_<i>.png``. Returns dict(rot_error_deg,
        trans_error, PSNR, SSIM, LPIPS). ``self.eval_log`` keeps, per view,
        the pose rendered, the refinement losses and the seconds spent
        refining and rendering."""
        from ..ops import lpips as lpips_mod
        from ..ops import ssim as ssim_mod
        from ..ops.render import invdepth_map
        opt = self.opt
        self.prealign()
        if output_path is None:
            output_path = opt.output_path
        test_path = os.path.join(output_path, "test_view")
        if dump_images:
            os.makedirs(test_path, exist_ok=True)

        results = {}
        if hasattr(self, "evaluate_camera_alignment"):
            R_err, t_err = self.evaluate_camera_alignment()
            results["rot_error_deg"] = float(np.rad2deg(np.mean(R_err)))
            results["trans_error"] = float(np.mean(t_err))
            with open(os.path.join(output_path, "quant_pose.txt"), "w") as f:
                for i, (r, t) in enumerate(zip(R_err, t_err)):
                    f.write("{} {} {}\n".format(i, float(r), float(t)))

        if test_optim is None:
            test_optim = bool(opt.optim.get("test_photo")) and \
                hasattr(self, "test_time_optimized_pose")
        lpips_ok = lpips_mod.available()
        if not lpips_ok:
            log.warn("LPIPS unavailable: no AlexNet-LPIPS weights found; set {}=<npz>. "
                     "quant.txt will record 'unavailable'.".format(lpips_mod.WEIGHTS_ENV))
        if self.device.type == "cuda":   # cuDNN's TF32 would change SSIM and LPIPS
            torch.backends.cudnn.allow_tf32 = False

        data = self.test_data
        n = int(data["image"].shape[0])
        progress = (torch.tensor(float(self.step), dtype=torch.float32)
                    / opt.max_iter).to(self.device)
        rows = []
        self.eval_log = []
        for i in range(n):
            intr = data["intr"][i:i + 1]
            pose = self.get_eval_pose(data["pose"][i:i + 1])
            entry = {}
            t0 = self._synced_time()
            if test_optim:
                generator = torch.Generator(device=self.device).manual_seed(1000 + i)
                pose = self.test_time_optimized_pose(
                    pose, intr, data["pixels"][i:i + 1], progress, generator=generator)
                entry["refine_losses"] = self.refine_losses
            t1 = self._synced_time()
            out = self.render_image(pose, intr, progress)
            t2 = self._synced_time()
            entry.update(pose=pose, refine_seconds=t1 - t0, render_seconds=t2 - t1)
            self.eval_log.append(entry)
            pred = out["rgb"].reshape(self.H, self.W, 3)
            gt = data["image"][i]
            psnr = -10.0 * float(torch.log10(torch.mean((pred - gt) ** 2)))
            pred_t = pred.permute(2, 0, 1)[None]
            gt_t = gt.permute(2, 0, 1)[None]
            ssim_v = float(ssim_mod.ssim(pred_t, gt_t))
            lpips_v = lpips_mod.lpips(pred_t * 2 - 1, gt_t * 2 - 1) if lpips_ok else None
            rows.append((psnr, ssim_v, lpips_v))
            if dump_images:
                inv = invdepth_map(out["depth"], out["opacity"],
                                   ndc=bool(opt.camera.ndc)).reshape(self.H, self.W)
                inv = inv.cpu().numpy()
                _save_png(os.path.join(test_path, "rgb_{}.png".format(i)), pred.cpu().numpy())
                _save_png(os.path.join(test_path, "rgb_GT_{}.png".format(i)), gt.cpu().numpy())
                _save_png(os.path.join(test_path, "depth_{}.png".format(i)),
                          inv / max(inv.max(), 1e-8))
        results["PSNR"] = float(np.mean([r[0] for r in rows]))
        results["SSIM"] = float(np.mean([r[1] for r in rows]))
        results["LPIPS"] = float(np.mean([r[2] for r in rows])) if lpips_ok else None
        lpips_str = "{:.4f}".format(results["LPIPS"]) if lpips_ok else "unavailable"
        with open(os.path.join(output_path, "quant.txt"), "w") as f:
            for i, (p, s, l) in enumerate(rows):
                f.write("{} {} {} {}\n".format(i, p, s, l if l is not None else "unavailable"))
        log.info("PSNR {:.2f} | SSIM {:.3f} | LPIPS {}".format(
            results["PSNR"], results["SSIM"], lpips_str))
        return results

    def _synced_time(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time()


def _save_png(path, arr):
    import imageio.v2 as imageio
    arr = np.clip(np.asarray(arr), 0.0, 1.0)
    imageio.imwrite(path, (arr * 255).astype(np.uint8))
