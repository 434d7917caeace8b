"""Evaluation entry point of the port:

    python -m neural_invertible_warp_tpu_torch.evaluate --model=barf_inn_llff \\
        --yaml=barf_inn_llff [--resume | --load=<ckpt>] [--device=cpu] \\
        [--export_dtu_cameras] [--key.sub=value ...]

Same CLI surface as the JAX package's ``evaluate.py``: loads the latest (or
the given) checkpoint, reports the pose errors and the novel-view PSNR, SSIM
and LPIPS (with test-time pose refinement where ``optim.test_photo`` is on),
writes ``quant.txt``, ``quant_pose.txt`` and the test-view PNGs, assembles
the test-view videos when ffmpeg is available, renders the circular
novel-view sequence and, for pose-optimizing models, replays the
checkpoints into the pose plots ``poses/<it>.png``, ``poses.html`` and,
with ffmpeg, ``poses.mp4`` (matplotlib needed; a failure there is logged
as a warning). DTU is evaluated on ``val``, Blender on ``test``; on
DTU, ``--export_dtu_cameras`` also writes the training cameras as
``cameras_refined.npz`` in the original DTU frame. Runs on the first CUDA
device; ``--device=cpu`` runs the plain PyTorch paths instead. Without a
CUDA device and without that flag it fails.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import numpy as np
import torch


def generate_videos_synthesis(opt):
    """ffmpeg assembly of the dumped test views."""
    from .utils import log
    if shutil.which("ffmpeg") is None:
        log.warn("ffmpeg not found; skipping video export")
        return
    test_path = os.path.join(opt.output_path, "test_view")
    for name, pattern in [("test_view_rgb.mp4", "rgb_%d.png"),
                          ("test_view_depth.mp4", "depth_%d.png")]:
        out = os.path.join(opt.output_path, name)
        subprocess.run(["ffmpeg", "-y", "-framerate", "30", "-i",
                        os.path.join(test_path, pattern), "-pix_fmt", "yuv420p", out],
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        log.info("wrote {}".format(out))


def generate_novel_view(opt, system, n_views=60):
    """Circular novel-view render around the central training camera (the
    pose readout, or the GT pose for a model that optimizes none), as
    ``novel_view/rgb_<i>.png`` (and a video when ffmpeg is available)."""
    from .ops import pose as pose_ops
    from .utils import image_io, log
    pose_pred, pose_GT = system.get_all_training_poses()
    poses = pose_pred if pose_pred is not None else pose_GT
    scale = 1.0
    if (pose_pred is not None and opt.data.dataset in ("llff", "iphone", "tandt")
            and getattr(system, "sim3", None)):
        scale = float(system.sim3["s1"]) / float(system.sim3["s0"])
    centers = poses[..., 3]
    idx_center = int(torch.linalg.norm(
        centers - centers.mean(0, keepdim=True), dim=-1).argmin())
    pose_novel = pose_ops.get_novel_view_poses(poses[idx_center], N=n_views, scale=scale)
    novel_path = os.path.join(opt.output_path, "novel_view")
    os.makedirs(novel_path, exist_ok=True)
    intr = system.test_data["intr"][:1]
    progress = (torch.tensor(float(system.step)) / opt.max_iter).to(system.device)
    for i in range(n_views):
        out = system.render_image(pose_novel[i:i + 1], intr, progress)
        rgb = np.clip(out["rgb"].reshape(opt.H, opt.W, 3).cpu().numpy(), 0, 1)
        image_io.write_png(os.path.join(novel_path, "rgb_{}.png".format(i)),
                           (rgb * 255).astype(np.uint8))
    if shutil.which("ffmpeg") is not None:
        subprocess.run(["ffmpeg", "-y", "-framerate", "30", "-i",
                        os.path.join(novel_path, "rgb_%d.png"), "-pix_fmt", "yuv420p",
                        os.path.join(opt.output_path, "novel_view_rgb.mp4")],
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    log.info("novel views written to {}".format(novel_path))


def export_dtu_cameras(opt, system, dataset, mode="refined"):
    """IDR-style camera export for DTU mesh evaluation (reference
    model/barf_dtu.py:74-133, save_projection_matrix_for_dtu). Writes
    ``<output_path>/cameras_<mode>.npz`` with one ``world_mat_i`` =
    ``[K @ w2c; 0 0 0 1]`` per training camera (the system's pose readout),
    its translation mapped back to the original DTU frame: the loader's
    recentering by ``dataset.norm_trans`` and its 1/300 scaling undone."""
    from .data.dtu import SCALING_FACTOR
    from .utils import log
    poses_w2c = system.get_all_training_poses()[0].detach().cpu().numpy()
    R, t = poses_w2c[:, :3, :3], poses_w2c[:, :3, 3:]
    c2w_R = np.transpose(R, (0, 2, 1))
    c2w_t = -c2w_R @ t
    # undo the normalization: t_raw = t_norm / scaling_factor + norm_trans
    c2w_t = c2w_t / SCALING_FACTOR + dataset.norm_trans[None]
    w2c_R = np.transpose(c2w_R, (0, 2, 1))
    w2c_t = -w2c_R @ c2w_t
    K = np.asarray(dataset.intrinsics)[:, :3, :3]
    P = K @ np.concatenate([w2c_R, w2c_t], axis=-1)       # [B,3,4]
    bottom = np.tile(np.array([[[0, 0, 0, 1.0]]], np.float32), (P.shape[0], 1, 1))
    world_mats = np.concatenate([P, bottom], axis=1).astype(np.float32)
    cameras = {"world_mat_%d" % i: world_mats[i] for i in range(world_mats.shape[0])}
    out = os.path.join(opt.output_path, "cameras_{}.npz".format(mode))
    np.savez(out, **cameras)
    log.info("wrote {} ({} cameras)".format(out, len(cameras)))
    return out


def main(argv=None):
    from .config import pop_device, set_options
    from .models.engine import Trainer
    from .utils import log
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device, argv = pop_device(sys.argv[1:] if argv is None else argv)
    export_cameras = "--export_dtu_cameras" in argv
    argv = [a for a in argv if a != "--export_dtu_cameras"]
    if not any(a.split("=")[0].rstrip("!") in ("--resume", "--load") for a in argv):
        argv = argv + ["--resume"]
    opt = set_options(argv)
    log.info("device: {}".format(device))
    trainer = Trainer(opt, device)
    trainer.build_system(*trainer.load_dataset(
        eval_split="test" if opt.data.dataset == "blender" else "val"))
    trainer.restore_checkpoint()
    results = trainer.system.evaluate_full()
    log.info("evaluation results: {}".format(results))
    if opt.data.dataset == "dtu" and export_cameras:
        from .data import get_dataset
        train = get_dataset("dtu").Dataset(opt, split="train", subset=opt.data.get("train_sub"))
        export_dtu_cameras(opt, trainer.system, train)
    generate_videos_synthesis(opt)
    if opt.data.dataset != "blender" and opt.get("novel_view_video", True):
        generate_novel_view(opt, trainer.system)
    if hasattr(trainer.system, "evaluate_camera_alignment"):
        from .utils.vis import generate_videos_pose
        try:
            generate_videos_pose(opt, trainer)
        except Exception as e:
            log.warn("pose video failed: {}".format(e))
    return results


if __name__ == "__main__":
    main()
