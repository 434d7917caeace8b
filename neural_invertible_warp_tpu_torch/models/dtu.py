"""DTU model family (port of neural_invertible_warp_tpu/models/dtu.py): NeRF,
SE(3) BARF and the INN warp with depth-error evaluation.

* ``nerf_dtu``: the scene's depth range from the dataset (metric depth in
  [1.2, 5.2]), the depth errors of the drawn rays as train metrics, masked
  eval metrics, the rendered depth rescaled by the recovered sim(3) scale;
* ``barf_dtu``: initial poses ``identity`` / ``noisy_gt`` / ``given``, or
  from SfM: ``colmap`` (matches from ``pose.sfm.matcher`` on the system's
  device, the reconstruction on the host) or ``colmap_files`` (an existing
  COLMAP model in ``pose.model_dir``), sim(3)-aligned onto the GT frame; an
  SE(3) refinement composed onto them, ATE alignment of more than 9 cameras
  or the exhaustive pairwise search at 9 or fewer, eval poses backtracked
  into the optimized frame;
* ``barf_inn_dtu`` / ``nerf_inn_dtu``: the paper's Table-2 model, a
  per-image latent and the shared invertible warp applied to rays cast from
  the initial poses; the Procrustes readout ``global_rigid`` starts at the
  identity, and the pose readout is ``global_rigid`` composed with the
  initial poses.

Every render of these systems (training, ``render_image``, the fine
resample and test-time refinement) takes its depth range from
``DTUMixin.render_rays``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import align, lie
from ..ops import metrics as metrics_ops
from ..ops import pose as pose_ops
from ..parallel import mesh
from ..utils import log
from .barf import BarfSystem
from .inn_warp import InnWarpSystem
from .system import NerfSystem


class DTUMixin:
    """The scene's depth range, the depth metrics and the DTU evaluation."""

    def attach_data(self, train_arrays, test_arrays):
        super().attach_data(train_arrays, test_arrays)
        # constant scene depth range (near 1.2 / far 5.2; data/dtu.py)
        self.scene_depth_range = tuple(
            float(x) for x in np.asarray(train_arrays["depth_range"])[0])
        for split in (self.train_data, self.test_data):
            if "depth_gt" in split:
                B = split["depth_gt"].shape[0]
                split["depth_gt_pixels"] = split["depth_gt"].reshape(B, -1)
                split["valid_depth_pixels"] = split["valid_depth_gt"].reshape(B, -1)

    def render_rays(self, center, ray, mode="train", progress=1.0, depth_range=None,
                    **kwargs):
        """The base render with the scene's depth range unless one is given."""
        if depth_range is None:
            depth_range = self.scene_depth_range
        return super().render_rays(center, ray, mode=mode, progress=progress,
                                   depth_range=depth_range, **kwargs)

    def _forward_train(self, ray_idx, step, depth_rand=None, noise_rand=None):
        out, target, extras = super()._forward_train(ray_idx, step, depth_rand, noise_rand)
        extras["ray_idx"] = mesh.shard_rays(ray_idx, 0)    # the rays rendered here
        return out, target, extras

    def compute_loss(self, out, target, extras):
        """The base losses; records the depth errors of the drawn rays
        (``depth_abs``, ``depth_rmse``) in ``extras`` for the metrics, over
        every rank's rays under a ray-sharded step."""
        losses = super().compute_loss(out, target, extras)
        data = self.train_data
        if "depth_gt_pixels" in data and "ray_idx" in extras:
            sums = mesh.all_reduce_sum(metrics_ops.depth_error_sums_on_rays(
                out["depth"].detach(), data["depth_gt_pixels"], data["valid_depth_pixels"],
                extras["ray_idx"]))
            extras["depth_abs"], extras["depth_rmse"] = metrics_ops.abs_rmse_from_sums(sums)
        return losses

    def depth_scaling_factor(self):
        """sim(3) scale that rescales rendered depth (model/nerf_dtu.py:227-235)."""
        ssim = getattr(self, "ssim_est_gt_c2w", None)
        return float(ssim["s"]) if ssim else 1.0

    def evaluate_full(self, output_path=None, dump_images=True, test_optim=None):
        """The base evaluation (with test-time refinement where
        ``optim.test_photo`` is on), then every test view rendered again at
        its backtracked pose without refinement for the depth errors (scaled
        by the stored sim(3) scale) and the foreground-masked PSNR, SSIM and
        LPIPS of white-composited images (reference model/nerf_dtu.py:202-300).
        Adds depth_abs, depth_rms, PSNR_masked, SSIM_masked, LPIPS_masked."""
        from ..ops import lpips as lpips_mod
        from ..ops import ssim as ssim_mod
        results = super().evaluate_full(output_path=output_path, dump_images=dump_images,
                                        test_optim=test_optim)
        data = self.test_data
        n = int(data["image"].shape[0])
        scale = self.depth_scaling_factor()
        progress = (torch.tensor(float(self.step), dtype=torch.float32)
                    / self.opt.max_iter).to(self.device)
        lpips_ok = lpips_mod.available()
        depth_abs, depth_rms = [], []
        psnr_masked, ssim_masked, lpips_masked = [], [], []
        for i in range(n):
            pose = self.get_eval_pose(data["pose"][i:i + 1])
            out = self.render_image(pose, data["intr"][i:i + 1], progress)
            fine = "_fine" if "rgb_fine" in out else ""
            a, r = metrics_ops.depth_error_full(
                out["depth" + fine].reshape(-1), data["depth_gt"][i],
                data["valid_depth_gt"][i], scaling_factor=scale)
            depth_abs.append(float(a))
            depth_rms.append(float(r))
            pred = out["rgb" + fine].reshape(self.H, self.W, 3)
            mask = data["fg_mask"][i] > 0.5
            pred_fg = metrics_ops.white_composite(pred, mask).permute(2, 0, 1)[None]
            gt_fg = metrics_ops.white_composite(data["image"][i], mask).permute(2, 0, 1)[None]
            psnr_masked.append(float(metrics_ops.masked_psnr(pred, data["image"][i], mask)))
            ssim_masked.append(float(ssim_mod.ssim(pred_fg, gt_fg)))
            if lpips_ok:
                lpips_masked.append(lpips_mod.lpips(pred_fg * 2 - 1, gt_fg * 2 - 1))
        results["depth_abs"] = float(np.mean(depth_abs))
        results["depth_rms"] = float(np.mean(depth_rms))
        results["PSNR_masked"] = float(np.mean(psnr_masked))
        results["SSIM_masked"] = float(np.mean(ssim_masked))
        results["LPIPS_masked"] = float(np.mean(lpips_masked)) if lpips_ok else None
        log.info("DTU depth abs {:.4f} | rms {:.4f} | masked PSNR {:.2f} | masked SSIM "
                 "{:.3f} | masked LPIPS {}".format(
                     results["depth_abs"], results["depth_rms"], results["PSNR_masked"],
                     results["SSIM_masked"], "{:.4f}".format(results["LPIPS_masked"])
                     if lpips_ok else "unavailable"))
        return results


class PoseInitMixin:
    """Initial-pose modes for DTU (reference model/barf_dtu.py:31-71)."""

    def set_initial_poses(self):
        """Initial w2c poses [n_train,3,4]; the ``noisy_gt`` se(3) noise is
        drawn once, from the generator as ``init_state`` seeds it. The SfM
        modes set ``sfm_valid_idx`` and ``sfm_excluded``."""
        opt = self.opt
        gt = self.train_data["pose"]
        mode = opt.pose.init
        if mode == "identity":
            init = np.tile(np.eye(3, 4, dtype=np.float32), (self.n_train, 1, 1))
            init = torch.as_tensor(align.align_translations(gt.cpu().numpy(), init),
                                   device=self.device)
        elif mode == "noisy_gt":
            se3_noise = torch.randn((self.n_train, 6), generator=self.generator,
                                    device=self.device) * opt.pose.noise
            init = pose_ops.compose([lie.se3_to_SE3(se3_noise), gt])
        elif mode == "given":
            init = gt.clone()
        elif mode == "colmap_files":
            # Seed from an EXISTING on-disk COLMAP reconstruction
            # (images.bin/cameras.bin), matching the reference's
            # get_poses_and_idx semantics (utils/colmap_initialization/
            # sfm.py:246-284): match by image name, identity + excluded for
            # unreconstructed images, then sim3-align onto the GT frame.
            from ..utils import colmap_io
            model_dir = opt.pose.get("model_dir")
            if not model_dir:
                raise ValueError("pose.init=colmap_files needs pose.model_dir")
            names = getattr(self, "train_image_names", None)
            init, valid, excluded = colmap_io.poses_from_model(model_dir, image_names=names)
            if init.shape[0] != self.n_train:
                raise ValueError(
                    "COLMAP model has {} images but the split has {} (and "
                    "no per-image names to match by)".format(init.shape[0], self.n_train))
            self.sfm_valid_idx = valid
            self.sfm_excluded = excluded
            log.info("COLMAP-file pose init: {} valid, excluded {}".format(
                len(valid), excluded))
            init = self._align_sfm_to_gt(init, gt.cpu().numpy(), valid)
        elif mode == "colmap":
            # SfM initialization (reference model/barf_dtu.py:55-67 +
            # utils/colmap_initialization/sfm.py:337-406): matcher on the
            # system's device -> reconstruction on the host -> sim3-align
            # the recovered trajectory onto the GT frame (fixes the
            # arbitrary SfM gauge/scale, as the reference does via
            # prealign_w2c_small_camera_systems).
            import os
            from ..utils import colmap_init
            sfm_cfg = opt.pose.get("sfm") or {}
            save_dir = None
            if opt.get("output_path"):
                save_dir = os.path.join(opt.output_path, "sfm")
            matcher_kwargs = {}
            if sfm_cfg.get("weights_path"):   # e.g. pdcnet checkpoint
                matcher_kwargs["weights_path"] = sfm_cfg["weights_path"]
            init, valid, excluded = colmap_init.compute_sfm_poses(
                self.train_data["image"].cpu().numpy(),
                self.train_data["intr"].cpu().numpy(),
                matcher=sfm_cfg.get("matcher") or "zncc",
                quant_px=sfm_cfg.get("quant_px") or 1.0,
                save_dir=save_dir, matcher_kwargs=matcher_kwargs, device=self.device)
            self.sfm_valid_idx = valid
            self.sfm_excluded = excluded
            log.info("SfM pose init: {} valid, excluded {}".format(len(valid), excluded))
            init = self._align_sfm_to_gt(init, gt.cpu().numpy(), valid)
        else:
            raise ValueError("unknown pose.init: {}".format(mode))
        return torch.as_tensor(init, device=self.device).float().contiguous()

    def _align_sfm_to_gt(self, init, gt, valid):
        """Sim3-align reconstructed poses onto the GT frame, FITTING on the
        valid subset only (identity placeholders for excluded images must
        not bias the fit), then applying to the full set; with no valid
        camera the fit takes them all."""
        idx = np.asarray(valid if len(valid) else np.arange(init.shape[0]))
        fit = align.prealign_w2c_small_camera_systems if len(idx) <= 9 \
            else align.prealign_w2c_large_camera_systems
        _, ssim = fit(init[idx], gt[idx])
        return align.apply_traj_align_ssim(init, ssim)


class DTUAlignmentMixin:
    """Trajectory alignment for evaluation: ATE above 9 cameras, the pairwise
    search at 9 or fewer (host numpy, float64)."""

    def _align_trajectory(self):
        """(aligned predicted w2c, GT w2c) as numpy; keeps the fitted sim(3)
        in ``ssim_est_gt_c2w``."""
        pose_pred, pose_GT = self.get_all_training_poses()
        pose_pred, pose_GT = pose_pred.cpu().numpy(), pose_GT.cpu().numpy()
        if pose_pred.shape[0] > 9:
            aligned, ssim = align.prealign_w2c_large_camera_systems(pose_pred, pose_GT)
        else:
            aligned, ssim = align.prealign_w2c_small_camera_systems(pose_pred, pose_GT)
        self.ssim_est_gt_c2w = ssim
        return aligned, pose_GT

    def prealign(self):
        self._align_trajectory()
        return self.ssim_est_gt_c2w

    def get_eval_pose(self, pose_GT):
        ssim = getattr(self, "ssim_est_gt_c2w", None)
        if ssim is None:
            return pose_GT
        return torch.as_tensor(align.backtrack_from_aligning_the_trajectory(
            pose_GT.cpu().numpy(), ssim), device=self.device)

    def evaluate_camera_alignment(self):
        """Aligned rotation (rad) and translation errors per training image,
        in the c2w convention (model/barf_dtu.py:140-194)."""
        return align._pose_errors_np(*self._align_trajectory())


# ---------------------------------------------------------------------------
# systems
# ---------------------------------------------------------------------------

class NerfDTUSystem(DTUMixin, NerfSystem):
    model_name = "nerf_dtu"


class BarfDTUSystem(DTUMixin, PoseInitMixin, DTUAlignmentMixin, BarfSystem):
    model_name = "barf_dtu"

    def init_aux(self):
        return {"initial_poses_w2c": self.set_initial_poses()}

    def _initial_pose(self):
        return self.aux["initial_poses_w2c"]


class InnDTUSystem(DTUMixin, PoseInitMixin, DTUAlignmentMixin, InnWarpSystem):
    """barf_inn_dtu: the INN warp on rays cast from the initial poses."""

    model_name = "barf_inn_dtu"

    def init_aux(self):
        """The initial poses, and the Procrustes readout at the identity: the
        readout is composed with the initial poses, so it must not start at
        them."""
        opt = self.opt
        if opt.get("pose") and opt.pose.get("parameterization") \
                and opt.pose.parameterization != "inn":
            raise ValueError("barf_inn_dtu requires pose.parameterization == inn "
                             "(reference model/barf_inn_dtu.py:323)")
        return {"initial_poses_w2c": self.set_initial_poses(),
                "global_rigid": pose_ops.identity_pose((self.n_train,), device=self.device)}

    def latent_dim(self):
        """A plain per-image embedding sized by ``inn.real_nvp.latent_dim``
        (the DTU options have no ``warp_latent`` section)."""
        real_nvp = self.opt.inn.real_nvp
        return real_nvp.get("latent_dim", real_nvp.d_hidden)

    def param_labels(self):
        labels = {name: "main" for name, _ in self.graph.named_children()}
        labels["warp_mlp"] = "pose"
        labels["warp_latent"] = "latent"
        return labels

    def _initial_pose_all(self, aux=None):
        return (self.aux if aux is None else aux)["initial_poses_w2c"]

    def _ray_frame(self):
        return self.aux["initial_poses_w2c"]
