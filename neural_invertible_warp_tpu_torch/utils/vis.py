"""Visualization: pose-evolution plots, depth colorization, video export
(port of neural_invertible_warp_tpu/utils/vis.py). The pose plots need
matplotlib, imported inside the functions that draw, so importing this
module (and the evaluation entry point) does not; ``colorize_depth`` needs
no matplotlib (viridis is carried as a table, ``utils/viridis.py``).

Capability parity with reference util_vis.py (matplotlib pose plots
:195-403, depth colorization :404-563) and the pose-evolution video replay
(model/barf.py:171-204). visdom camera wireframes are intentionally not
ported (interactive-server dependency); the same content is saved as
matplotlib figures.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from .viridis import VIRIDIS


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _invert_pose(pose):
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = np.swapaxes(R, -1, -2)
    return R_inv, (-R_inv @ t)[..., 0]


def camera_frustums(poses_w2c, depth=0.5):
    """[N,3,4] w2c -> list of (5,3) frustum vertex sets in world space."""
    verts_cam = np.array([
        [0, 0, 0],
        [-0.5, -0.375, 1], [0.5, -0.375, 1],
        [0.5, 0.375, 1], [-0.5, 0.375, 1],
    ]) * depth
    out = []
    for pose in np.asarray(poses_w2c):
        R_inv, c = _invert_pose(pose)
        out.append(verts_cam @ R_inv.T + c)
    return out


def _draw_cameras(ax, poses, color, depth):
    for v in camera_frustums(poses, depth):
        # frustum edges: apex->corners and the image-plane rectangle
        for i in range(1, 5):
            ax.plot(*zip(v[0], v[i]), color=color, linewidth=0.5)
        rect = [1, 2, 3, 4, 1]
        ax.plot(v[rect, 0], v[rect, 1], v[rect, 2], color=color, linewidth=0.5)
        ax.scatter(*v[0], color=color, s=4)


def plot_save_poses(path, pose, pose_ref=None, ep=0, cam_depth=0.2,
                    title=None):
    """Save a 3D pose plot (optimized blue vs reference magenta) to
    <path>/<ep>.png (parity: util_vis.plot_save_poses)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    ax.set_title(title or "iteration {}".format(ep))
    if pose_ref is not None:
        _draw_cameras(ax, pose_ref, color="magenta", depth=cam_depth)
    _draw_cameras(ax, pose, color="blue", depth=cam_depth)
    all_pts = np.concatenate([v for v in camera_frustums(
        pose if pose_ref is None else np.concatenate([pose, pose_ref]),
        cam_depth)])
    lo, hi = all_pts.min(0), all_pts.max(0)
    c = (lo + hi) / 2
    r = max((hi - lo).max() / 2, 1e-3)
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, "{}.png".format(ep))
    fig.savefig(fname, dpi=75)
    plt.close(fig)
    return fname


plot_save_poses_blender = plot_save_poses
plot_save_poses_dtu = plot_save_poses


def _viridis(x):
    """matplotlib's viridis of float ``x`` in [0, 1] as float32 RGB, as
    ``Colormap.__call__`` indexes its table: ``x * N`` in ``x``'s dtype, 1.0
    to the last colour, truncated to an index; NaN gives black."""
    lut = np.array(VIRIDIS, np.float64)
    n = len(lut)
    xa = np.array(x, copy=True)
    xa *= n
    xa[xa == n] = n - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[xa < 0] = 0
    idx[(xa >= n) | bad] = n - 1
    rgb = lut[idx].astype(np.float32)
    rgb[bad] = 0
    return rgb


def colorize_depth(depth, valid=None, cmap="viridis"):
    """[H,W] depth -> [H,W,3] colormapped float image (util_vis.py:404-563):
    the JAX package's matplotlib colouring, bit for bit, without matplotlib
    (viridis only)."""
    if cmap != "viridis":
        raise ValueError("colorize_depth carries viridis only, not {!r}".format(cmap))
    depth = np.asarray(depth, np.float32)
    if valid is None:
        valid = np.isfinite(depth)
    vals = depth[valid]
    lo = np.percentile(vals, 1) if vals.size else 0.0
    hi = np.percentile(vals, 99) if vals.size else 1.0
    norm = np.clip((depth - lo) / max(hi - lo, 1e-8), 0, 1)
    rgb = _viridis(norm)
    rgb[~valid] = 0
    return rgb


def tile_images(images, rows, cols):
    """Tile a list of [H,W,3] images into one [rows*H, cols*W, 3] grid,
    zero-padding missing cells (reference util_vis.py:34-51 tb.num_images
    grids)."""
    assert images, "no images to tile"
    H, W, C = images[0].shape
    grid = np.zeros((rows * H, cols * W, C), np.float32)
    for i, img in enumerate(images[:rows * cols]):
        r, c = divmod(i, cols)
        grid[r * H:(r + 1) * H, c * W:(c + 1) * W] = img
    return grid


def write_video(frame_dir, pattern, out_path, fps=30):
    """ffmpeg assembly; no-op with a warning when ffmpeg is unavailable."""
    if shutil.which("ffmpeg") is None:
        return False
    os.system("ffmpeg -y -framerate {fps} -i {d}/{p} -pix_fmt yuv420p {o} "
              ">/dev/null 2>&1".format(fps=fps, d=frame_dir, p=pattern,
                                       o=out_path))
    return os.path.isfile(out_path)


def generate_videos_pose(opt, trainer):
    """Replay checkpoints into a pose-evolution video (model/barf.py:171-204):
    ``poses/<it>.png`` for the current state (it 0) and for every numbered
    checkpoint ``model/<it>.ckpt`` (restored into ``trainer.system``),
    ``poses.mp4`` where ffmpeg is present and the interactive ``poses.html``.
    Returns the iterations plotted."""
    import torch
    from . import ckpt as ckpt_util
    from ..ops import align
    system = trainer.system
    cam_path = os.path.join(opt.output_path, "poses")
    os.makedirs(cam_path, exist_ok=True)
    ep_list = []
    pose_frames = []
    last_ref = None
    cam_depth = (opt.get("visdom") or {}).get("cam_depth", 0.2)
    for ep in range(0, opt.max_iter + 1, opt.freq.ckpt):
        if ep > 0:
            try:
                ckpt_util.restore(opt.output_path, system, resume=ep)
            except FileNotFoundError:
                continue
        pose, pose_ref = system.get_all_training_poses()
        if pose is None:
            continue
        if hasattr(system, "prealign"):
            system.prealign()
            sim3 = system.sim3
            if sim3 is not None:
                with torch.no_grad():
                    pose = align.apply_sim3_to_poses(pose, sim3, "pred_to_GT")
        pose = pose.detach().cpu().numpy() if torch.is_tensor(pose) else np.asarray(pose)
        if torch.is_tensor(pose_ref):
            pose_ref = pose_ref.detach().cpu().numpy()
        plot_save_poses(cam_path, pose, pose_ref, ep=ep, cam_depth=cam_depth)
        ep_list.append(ep)
        pose_frames.append((ep, np.asarray(pose)))
        last_ref = np.asarray(pose_ref) if pose_ref is not None else None
    out = os.path.join(opt.output_path, "poses.mp4")
    write_video(cam_path, "%d.png", out)
    if pose_frames:
        # interactive 3D viewer (visdom-wireframe equivalent, offline HTML)
        from .pose_viewer import export_interactive_poses
        export_interactive_poses(
            os.path.join(opt.output_path, "poses.html"), pose_frames,
            pose_ref=last_ref, cam_depth=cam_depth)
    return ep_list
