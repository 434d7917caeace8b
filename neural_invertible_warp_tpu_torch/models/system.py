"""Base NeRF system (port of neural_invertible_warp_tpu/models/system.py).

Holds the data on the device, the field (``self.graph``), the optimizer,
the step counter and the non-optimized ``aux`` state; runs the train step
as an eager autograd pass and renders full images as a loop over ray
chunks. The render core reads the same ``tpu.*`` switches as the JAX
package's and sends each tier to its CUDA kernels: the composited render
(K2 for training with a target; K3 for eval, and K3 with K4 as its backward
for test-time pose refinement and for training under ``tpu.fused_train:
false``), for fine sampling two K2 calls per step (the coarse one returning
the weights to resample from) and the per-sample field K5 in eval and in
the fallback tier, the MLP-only field K1 under ``tpu.fused_pe: false``, and
the plain chain with both kernel switches off. On CUDA tensors a tier
launches its kernels or raises; on CPU tensors it takes their plain
versions. ``tpu.compute_dtype: bfloat16`` runs K2, K3 and K4 with bf16
operands (and their plain versions so on the CPU); a configuration that
would reach K5 or K1 under it raises before the first step, and the plain
chain ignores it. ``evaluate_full`` is the full test-set evaluation: pose
error, test-time refinement, PSNR, SSIM, LPIPS.

Under a ``parallel.mesh`` group the train step and ``render_image`` shard
the ray axis over the ranks (one process per GPU): every rank makes the
step's draws at their global shapes and renders its own rays, the losses
over rays are normalised by the global count, a term every rank computes
identically (``replicated_losses``) is divided by the world size, and the
gradients are summed over the ranks before the optimizer step, so every
rank's parameters stay identical. Test-time pose refinement stays
replicated: every rank runs the same draws and gets the same pose.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch import nn

from ..ops import nerf_mlp, rays, render, sampling
from ..ops.cuda import fused_field, fused_pe
from ..parallel import mesh
from ..utils import image_io, log


class Graph(nn.Module):
    """Learnable state, one child per top-level group, named as the
    reference Graph names them (nerf, nerf_fine, se3_refine, warp_mlp,
    warp_latent)."""

    def __init__(self, **children):
        super().__init__()
        for name, child in children.items():
            setattr(self, name, child)


class NerfSystem:

    model_name = "nerf"
    # losses every rank computes identically under a ray-sharded step
    replicated_losses = ()

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
        self.seed = 0
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

    def make_field(self, generator):
        """One field (the GARF family swaps in the Gaussian one)."""
        return nerf_mlp.NerfMLP(self.arch, view_dep=self.opt.nerf.view_dep,
                                generator=generator)

    def build_graph(self, generator):
        """The field, and with fine sampling a second one of its own init."""
        graph = Graph(nerf=self.make_field(generator))
        if self.opt.nerf.fine_sampling:
            graph.nerf_fine = self.make_field(generator)
        return graph

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
        gamma = exp_decay_gamma(opt.max_iter, opt.optim.lr, opt.optim.get("lr_end"))
        return {"main": exp_schedule(opt.optim.lr, gamma)}

    def make_clips(self):
        """dict label -> global-norm limit of its gradients: ``optim.clip_norm``
        for the main group, ``optim.clip_norm_pose`` for the pose and latent
        groups (the JAX package's ``clip_wrap``); none by default."""
        opt = self.opt
        limits = {"main": opt.optim.get("clip_norm"),
                  "pose": opt.optim.get("clip_norm_pose"),
                  "latent": opt.optim.get("clip_norm_pose")}
        return {label: float(v) for label, v in limits.items() if v}

    def make_gates(self):
        """dict label -> number of first updates whose gradients are zeroed
        (GARF's pose warmup); none by default."""
        return {}

    def init_state(self, seed=0):
        """Parameters from a seeded CPU generator (device-independent), then
        the optimizer and aux state on the device."""
        from ..utils.optim import MultiAdam
        self.check_kernel_options()
        gen = torch.Generator().manual_seed(int(seed))
        self.graph = self.build_graph(gen).to(self.device)
        # the draws of init_aux (pose noise, DTU's noisy_gt start) come from
        # the seed itself; train_step re-seeds the generator for every step
        self.seed = int(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        groups = {}
        for name, label in self.param_labels().items():
            groups.setdefault(label, []).extend(getattr(self.graph, name).parameters())
        for p in groups.get("frozen", []):
            p.requires_grad_(False)
        self.optim = MultiAdam(groups, self.make_schedules(), self.make_gates(),
                               self.make_clips())
        self.aux = self.init_aux()
        self.step = 0

    # ---------------------------------------------------------------- render

    def _field_mode(self):
        """Which field kernel the render core uses: "pe" (the kernels with
        the PE inside: K2-K5), "field" (K1, the PE in PyTorch) or "off" (the
        plain chain), from ``tpu.fused_pe`` and ``tpu.fused_kernel``."""
        tpu_cfg = self.opt.get("tpu") or {}
        if tpu_cfg.get("fused_pe", True):
            return "pe"
        return "field" if tpu_cfg.get("fused_kernel", True) else "off"

    def kernel_compute_dtype(self):
        """``tpu.compute_dtype`` of the field kernels ("float32" or
        "bfloat16"; another value raises ValueError), as the JAX package's
        ``_kernel_compute_dtype`` reads it; "float32" for the plain chain,
        which ignores it."""
        dtype = fused_pe.resolve_compute_dtype((self.opt.get("tpu") or {}).get("compute_dtype"))
        return "float32" if self._field_mode() == "off" else dtype

    def check_kernel_options(self):
        """Raise before the first step where ``tpu.compute_dtype: bfloat16``
        would reach a field kernel without a bf16 variant (K5, K1): fine
        sampling (K5 in the validation render), ``tpu.fused_raymarch: false``,
        density noise outside the one-call kernel (``tpu.fused_train:
        false``) and the MLP-only tier."""
        if self.kernel_compute_dtype() == "float32":
            return
        opt, tpu_cfg = self.opt, self.opt.get("tpu") or {}
        why = None
        if self._field_mode() == "field":
            why = "K1 (the MLP-only tier, tpu.fused_pe: false)"
        elif opt.nerf.fine_sampling:
            why = "K5 (fine sampling renders through it)"
        elif not tpu_cfg.get("fused_raymarch", False):
            why = "K5 (tpu.fused_raymarch: false renders through it)"
        elif opt.nerf.get("density_noise_reg") and not tpu_cfg.get("fused_train", True):
            why = "K5 (density noise outside the one-call kernel, tpu.fused_train: false)"
        if why:
            fused_pe.refuse_bf16("bfloat16", why)

    def apply_field_samples(self, mlp, center, ray, depth, noise=None, **kw):
        """(rgb [B,R,K,3], density [B,R,K]) of one field along the rays."""
        mode = self._field_mode()
        if mode == "pe":
            return fused_pe.fused_apply_nerf_samples_pe(mlp, center, ray, depth,
                                                        noise=noise, **kw)
        if mode == "field":
            return fused_field.fused_apply_nerf_samples(mlp, center, ray, depth,
                                                        noise=noise, **kw)
        return nerf_mlp.apply_nerf_samples(mlp, center, ray, depth, noise=noise, **kw)

    def _field_composite(self, mlp, center, ray, depth, noise, kw, bg):
        """Field + alpha compositing in PyTorch. Returns (rgb [B,R,3], depth
        [B,R,1], opacity [B,R,1], prob [B,R,K])."""
        rgb_s, dens = self.apply_field_samples(mlp, center, ray, depth, noise, **kw)
        rgb, d, opac, prob = render.composite(ray, rgb_s, dens, depth, **bg)
        return rgb, d, opac, prob[..., 0]

    def render_rays(self, center, ray, mode="train", progress=1.0,
                    depth_range=None, target=None, depth_rand=None,
                    noise_rand=None, intr=None):
        """Stratified samples -> field -> compositing for center/ray [B,R,3].

        ``mode`` is "train" (stratified depths, density noise), "eval" or
        "test-optim" (midpoint depths; the latter is differentiated by
        test-time pose refinement). ``depth_rand`` [B,R,K,1] optionally
        supplies the stratification draw, ``noise_rand`` the standard-normal
        draws of the density noise: a list of [B,R,K] tensors, one per
        field (coarse, then fine over all its samples). With ``camera.ndc``
        the rays go to normalized device coordinates after the depth draw,
        with the per-image ``intr`` [B,3,3]. Returns dict(rgb, depth,
        opacity[, *_fine][, render_sq_sum, render_n][, render_fine_sq_sum,
        render_fine_n]); for no rays (a rank's empty share) empty maps.
        """
        opt = self.opt
        if mode not in ("train", "eval", "test-optim"):
            raise ValueError("unknown render mode: {!r}".format(mode))
        B, R = center.shape[0], center.shape[1]
        if R == 0:
            fields = ("", "_fine") if opt.nerf.fine_sampling else ("",)
            return {k + f: center.new_zeros((B, 0, c)) for f in fields
                    for k, c in (("rgb", 3), ("depth", 1), ("opacity", 1))}
        depth_range = depth_range if depth_range is not None \
            else tuple(opt.nerf.depth.range)
        K = opt.nerf.sample_intvs
        fine = bool(opt.nerf.fine_sampling)
        K_all = K + opt.nerf.sample_intvs_fine if fine else K
        depth = sampling.sample_depth(
            B, R, K, depth_range, param=opt.nerf.depth.param,
            stratified=bool(opt.nerf.sample_stratified and mode == "train"),
            generator=self.generator, rand=depth_rand, device=center.device)
        if opt.camera.ndc:
            center, ray = rays.convert_NDC(center, ray, intr)
        # independent draws for the two fields
        noise = [None, None]
        noise_reg = opt.nerf.get("density_noise_reg") if mode == "train" else None
        if noise_reg:
            for i, k in enumerate([K, K_all] if fine else [K]):
                draw = noise_rand[i] if noise_rand is not None else torch.randn(
                    (B, R, k), generator=self.generator, device=center.device)
                noise[i] = draw * noise_reg
        kw = dict(progress=progress,
                  barf_c2f=tuple(opt.barf_c2f) if opt.get("barf_c2f") else None,
                  density_activ=self.arch.get("density_activ", "softplus"))
        if self.kernel_compute_dtype() != "float32":
            kw["compute_dtype"] = self.kernel_compute_dtype()
        bg = dict(setbg_opaque=bool(opt.nerf.get("setbg_opaque")),
                  bgcolor=opt.data.get("bgcolor"))
        tpu_cfg = opt.get("tpu") or {}
        raymarch = self._field_mode() == "pe" and tpu_cfg.get("fused_raymarch", False)
        one_call = bool(raymarch and mode == "train" and target is not None
                        and tpu_cfg.get("fused_train", True))
        graph = self.graph

        def resample(prob):
            depth_fine = sampling.sample_depth_from_pdf(
                prob.detach(), K, opt.nerf.sample_intvs_fine, depth_range)
            return torch.sort(torch.cat([depth, depth_fine], dim=2), dim=2).values

        def train_fine(out, depth_all):
            out_f, sq_f, n_f = fused_pe.fused_render_rays_pe_train(
                graph.nerf_fine, center, ray, depth_all, target, noise=noise[1],
                **kw, **bg)
            out.update(rgb_fine=out_f["rgb"], depth_fine=out_f["depth"],
                       opacity_fine=out_f["opacity"], render_fine_sq_sum=sq_f,
                       render_fine_n=n_f)
            return out

        if raymarch and not fine:
            # the composited render in one kernel
            if one_call:
                out, sq, n_terms = fused_pe.fused_render_rays_pe_train(
                    graph.nerf, center, ray, depth, target, noise=noise[0], **kw, **bg)
                out["render_sq_sum"] = sq
                out["render_n"] = n_terms
                return out
            if noise[0] is None:    # the forward kernel has no noise operand
                rgb, d, opac = fused_pe.fused_render_rays_pe(
                    graph.nerf, center, ray, depth, **kw, **bg)
                return dict(rgb=rgb, depth=d, opacity=opac)
        if fine and one_call and tpu_cfg.get("fused_raymarch_full", True):
            # both fields through the one-call train kernel: the resample
            # carries no gradient, so the coarse field's only gradient is its
            # own photometric loss, and its compositing weights come out of
            # the kernel for the resample
            out, sq, n_terms = fused_pe.fused_render_rays_pe_train(
                graph.nerf, center, ray, depth, target, noise=noise[0],
                want_prob=True, **kw, **bg)
            out.update(render_sq_sum=sq, render_n=n_terms)
            return train_fine(out, resample(out.pop("prob")))
        rgb, d, opac, prob = self._field_composite(
            graph.nerf, center, ray, depth, noise[0], kw, bg)
        out = dict(rgb=rgb, depth=d, opacity=opac)
        if fine:
            depth_all = resample(prob)
            if one_call:
                # fallback tier: the coarse field through the per-sample
                # kernel with compositing under autograd, the fine field
                # through the one-call train kernel
                return train_fine(out, depth_all)
            rgb_f, d_f, opac_f, _ = self._field_composite(
                graph.nerf_fine, center, ray, depth_all, noise[1], kw, bg)
            out.update(rgb_fine=rgb_f, depth_fine=d_f, opacity_fine=opac_f)
        return out

    # ---------------------------------------------------------------- losses

    def compute_loss(self, out, target, extras):
        """The photometric MSE of each field. Under a ray-sharded step each
        rank's term is its squared error over the global count of terms:
        its own mean times its share of the step's ``extras["n_rays"]``."""
        share = target.shape[1] / extras["n_rays"] if "n_rays" in extras else 1.0

        def mse(sq_sum, n_terms, rgb):
            if sq_sum is None:
                if share == 0:      # no rays on this rank
                    return torch.sum((rgb - target) ** 2)
                loss = torch.mean((rgb - target) ** 2)
            else:                   # the one-call train kernel's squared error
                loss = sq_sum / n_terms
            return loss if share == 1.0 else loss * share

        losses = {"render": mse(out.get("render_sq_sum"), out.get("render_n"), out["rgb"])}
        if self.opt.loss_weight.get("render_fine") is not None:
            losses["render_fine"] = mse(out.get("render_fine_sq_sum"),
                                        out.get("render_fine_n"), out["rgb_fine"])
        return losses

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

    def get_all_training_poses(self):
        """(predicted poses, GT poses) of the training images; a model that
        optimizes no pose predicts none."""
        return None, self.train_data["pose"]

    @staticmethod
    def _shard_draws(ray_idx, depth_rand, noise_rand):
        """This rank's rays of the step's global draws (all of them without
        a group)."""
        return (mesh.shard_rays(ray_idx, 0),
                None if depth_rand is None else mesh.shard_rays(depth_rand),
                None if noise_rand is None else [mesh.shard_rays(n) for n in noise_rand])

    def _forward_train(self, ray_idx, step, depth_rand=None, noise_rand=None):
        """One training forward over the drawn rays of every image (this
        rank's share of them under a group); returns (out, target, extras),
        ``extras["n_rays"]`` the step's global ray count."""
        data = self.train_data
        n_rays = ray_idx.shape[0]
        ray_idx, depth_rand, noise_rand = self._shard_draws(ray_idx, depth_rand, noise_rand)
        center, ray = rays.get_center_and_ray(self.get_train_pose(), data["intr"],
                                              ray_idx, self.W)
        progress = (torch.tensor(float(step), dtype=torch.float32)
                    / self.opt.max_iter).to(self.device)
        target = data["pixels"][:, ray_idx]
        out = self.render_rays(center, ray, mode="train", progress=progress,
                               target=target, depth_rand=depth_rand,
                               noise_rand=noise_rand, intr=data["intr"])
        return out, target, {"n_rays": n_rays}

    def update_aux(self, extras):
        pass

    def seed_step(self):
        """Seed the generator for the draws of step ``self.step`` from
        (seed, step), as the JAX package folds the step into its base key, so
        that a run resumed at step N draws what an uninterrupted run would.
        The mixing is numpy's SeedSequence: its first 32-bit word of state."""
        word = np.random.SeedSequence([self.seed, self.step]).generate_state(1)[0]
        self.generator.manual_seed(int(word))

    def draw_step(self, ray_u=None, depth_rand=None, noise_rand=None):
        """The step's random draws at their global shapes, from the
        generator as ``seed_step`` seeded it, in the order the render makes
        them: the ray indices (``rand_rays // n_train`` rays, one draw shared
        by every image), the stratified depth jitter [B,N,K,1], then the
        density noise [B,N,K] per field. Each given one is taken as is.
        Returns (ray_idx [N], depth_rand, noise_rand)."""
        opt = self.opt
        n_rays = opt.nerf.rand_rays // self.n_train
        draw = dict(generator=self.generator, device=self.device)
        ray_idx = sampling.sample_ray_subset(
            self.HW, n_rays, mode=(opt.get("tpu") or {}).get("ray_sample", "stratified"),
            u=ray_u, **draw)
        K = opt.nerf.sample_intvs
        if depth_rand is None and opt.nerf.sample_stratified:
            depth_rand = torch.rand((self.n_train, n_rays, K, 1), **draw)
        if noise_rand is None and opt.nerf.get("density_noise_reg"):
            ks = [K, K + opt.nerf.sample_intvs_fine] if opt.nerf.fine_sampling else [K]
            noise_rand = [torch.randn((self.n_train, n_rays, k), **draw) for k in ks]
        return ray_idx, depth_rand, noise_rand

    def train_step(self, ray_u=None, depth_rand=None, noise_rand=None):
        """One optimization step over all training images. ``ray_u`` /
        ``depth_rand`` / ``noise_rand`` optionally supply the step's random
        draws (``draw_step``); the others come from ``seed_step``'s
        generator. Under a ``parallel.mesh`` group the step renders this
        rank's share of the rays, sums the gradients over the ranks before
        the optimizer step and returns the global metrics. Returns the
        step's metrics as 0-d tensors (no host sync without a group): the
        losses, and the scalar diagnostics a model records in ``extras``
        (DTU's depth errors)."""
        self.seed_step()
        ray_idx, depth_rand, noise_rand = self.draw_step(ray_u, depth_rand, noise_rand)
        self.optim.zero_grad()
        out, target, extras = self._forward_train(ray_idx, self.step, depth_rand,
                                                  noise_rand)
        losses = self.compute_loss(out, target, extras)
        n_ranks = mesh.world_size()
        total = self.summarize_loss({
            k: v / n_ranks if n_ranks > 1 and k in self.replicated_losses else v
            for k, v in losses.items()})
        # under a group a rank without rays has nothing to differentiate
        if total.requires_grad or mesh.active_group() is None:
            total.backward()
        mesh.all_reduce_grads(self.optim.parameters())
        self.optim.step()
        self.update_aux(extras)
        self.step += 1
        losses = {k: v.detach() for k, v in losses.items()}
        if mesh.active_group() is None:
            total = total.detach()
        else:    # the global losses: the ranks' shares of each per-ray term summed
            keys = [k for k in losses if k not in self.replicated_losses]
            summed = mesh.all_reduce_sum(torch.stack([losses[k] for k in keys]))
            losses.update(zip(keys, summed.unbind()))
            total = self.summarize_loss(losses)
        metrics = {"loss_" + k: v for k, v in losses.items()}
        metrics["loss_all"] = total
        metrics["psnr"] = -10.0 * torch.log10(metrics["loss_render"])
        metrics.update({k: v.detach() for k, v in extras.items()
                        if torch.is_tensor(v) and v.ndim == 0})
        return metrics

    # ----------------------------------------------------------- eval render

    @torch.no_grad()
    def render_image(self, pose, intr, progress=1.0):
        """Full image for pose [1,3,4], intr [1,3,3]: a loop over chunks of
        ``min(rand_rays, H*W)`` rays. Under a ``parallel.mesh`` group each
        chunk's rays are split over the ranks, each renders its part and the
        parts are gathered in rank order, so every rank holds the whole
        image. Returns dict of [1, H*W, C] tensors."""
        chunk = min(self.opt.nerf.rand_rays, self.HW)
        outs = []
        for start in range(0, self.HW, chunk):
            idx = torch.arange(start, min(start + chunk, self.HW), device=self.device)
            center, ray = rays.get_center_and_ray(pose, intr, mesh.shard_rays(idx, 0),
                                                  self.W)
            out = self.render_rays(center, ray, mode="eval", progress=progress, intr=intr)
            if mesh.active_group() is not None:   # one collective per chunk
                keys = list(out)
                packed = mesh.all_gather_rays(torch.cat([out[k] for k in keys], dim=-1),
                                              len(idx))
                out = dict(zip(keys, packed.split([out[k].shape[-1] for k in keys], -1)))
            outs.append(out)
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
            key = "rgb_fine" if "rgb_fine" in out else "rgb"
            mse = float(torch.mean((out[key] - data["pixels"][i:i + 1]) ** 2))
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
            fine = "_fine" if "rgb_fine" in out else ""
            pred = out["rgb" + fine].reshape(self.H, self.W, 3)
            gt = data["image"][i]
            psnr = -10.0 * float(torch.log10(torch.mean((pred - gt) ** 2)))
            pred_t = pred.permute(2, 0, 1)[None]
            gt_t = gt.permute(2, 0, 1)[None]
            ssim_v = float(ssim_mod.ssim(pred_t, gt_t))
            lpips_v = lpips_mod.lpips(pred_t * 2 - 1, gt_t * 2 - 1) if lpips_ok else None
            rows.append((psnr, ssim_v, lpips_v))
            if dump_images:
                inv = invdepth_map(out["depth" + fine], out["opacity" + fine],
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
    arr = np.clip(np.asarray(arr), 0.0, 1.0)
    image_io.write_png(path, (arr * 255).astype(np.uint8))
