"""LLFF forward-facing dataset loader. The port's own copy of
neural_invertible_warp_tpu/data/llff.py (numpy; images through
``utils/image_io``: PNG and baseline or progressive JPEG read and resized
without PIL).

Format parity with reference data/llff.py:17-134:
* ``poses_bounds.npy``: [N,17] rows = 3x5 camera matrix (c2w OpenGL
  [down? right? see axis swap] + [H,W,focal] column) ++ 2 depth bounds;
* axis swap col0 <- col1, col1 <- -col0 (data/llff.py:51);
* world rescale by 1/(bounds.min()*0.75) (data/llff.py:56);
* pose centering by the inverse of the average pose (data/llff.py:63-72);
* per-camera conversion to w2c OpenCV with a 180-degree x-flip on both sides
  (``raw_to_w2c``, data/llff.py:107-134);
* sequential train/val split by ``val_ratio`` from the END of the list
  (data/llff.py:32-33).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import image_io
from . import base
from .base import np_compose_pair, np_invert, np_pose


def parse_poses_bounds(data, raw_H=3024, raw_W=4032):
    """The camera parse of a ``poses_bounds.npy`` array [N,17]: (poses_raw
    [N,3,4] float32, axis-swapped, rescaled by 1/(bounds.min()*0.75) and
    centred by the inverse of the average pose; bounds [N,2] rescaled alike;
    the focal length in raw pixels). The raw image size the rows carry must
    be ``raw_H`` x ``raw_W``."""
    data = np.asarray(data).astype(np.float32)
    cam_data = data[:, :-2].reshape(-1, 3, 5)
    poses_raw = cam_data[..., :4].copy()
    # swap conventions: new col0 = old col1, new col1 = -old col0
    col0, col1 = poses_raw[..., 0].copy(), poses_raw[..., 1].copy()
    poses_raw[..., 0], poses_raw[..., 1] = col1, -col0
    got_H, got_W, focal = cam_data[0, :, -1]
    assert raw_H == got_H and raw_W == got_W, \
        "unexpected LLFF raw image size: {}x{}".format(got_H, got_W)
    bounds = data[:, -2:]
    scale = 1.0 / (bounds.min() * 0.75)
    poses_raw[..., 3] *= scale
    bounds = bounds * scale
    return center_camera_poses(poses_raw), bounds, focal


def center_camera_poses(poses):
    """Subtract the average pose (reference data/llff.py:63-72)."""
    center = poses[..., 3].mean(axis=0)
    v1 = poses[..., 1].mean(axis=0)
    v1 /= np.linalg.norm(v1)
    v2 = poses[..., 2].mean(axis=0)
    v2 /= np.linalg.norm(v2)
    v0 = np.cross(v1, v2)
    pose_avg = np.stack([v0, v1, v2, center], axis=-1)
    return np_compose_pair(poses, np_invert(pose_avg)[None])


def raw_to_w2c(pose_raw):
    """OpenGL c2w -> OpenCV w2c with the double x-flip (data/llff.py:107-134)."""
    flip = np_pose(R=np.diag([1.0, -1.0, -1.0]))
    pose = np_compose_pair(flip, pose_raw[:3])
    pose = np_invert(pose)
    return np_compose_pair(flip, pose)


class Dataset(base.Dataset):

    def __init__(self, opt, split="train", subset=None):
        self.raw_H, self.raw_W = 3024, 4032
        super().__init__(opt, split)
        self.root = opt.data.get("root") or "data/llff"
        self.path = os.path.join(self.root, opt.data.scene)
        self.path_image = os.path.join(self.path, "images")
        image_fnames = sorted(os.listdir(self.path_image))
        poses_raw, bounds = self.parse_cameras_and_bounds(opt)
        self.list = list(zip(image_fnames, poses_raw, bounds))
        num_val = int(len(self.list) * opt.data.val_ratio)
        self.list = self.list[:-num_val] if split == "train" else self.list[-num_val:]
        if subset:
            self.list = self.list[:subset]
        if opt.data.preload:
            self.images = self.preload_threading(opt, self.get_image)
            self.cameras = self.preload_threading(opt, self.get_camera, "cameras")

    def parse_cameras_and_bounds(self, opt):
        data = np.load(os.path.join(self.path, "poses_bounds.npy"))
        poses_raw, bounds, self.focal = parse_poses_bounds(data, self.raw_H, self.raw_W)
        return poses_raw, bounds

    def get_all_camera_poses(self, opt):
        return np.stack([raw_to_w2c(tup[1]) for tup in self.list])

    def get_image(self, opt, idx):
        fname = os.path.join(self.path_image, self.list[idx][0])
        return image_io.read_image(fname)

    def get_camera(self, opt, idx):
        intr = np.array([[self.focal, 0, self.raw_W / 2],
                         [0, self.focal, self.raw_H / 2],
                         [0, 0, 1]], dtype=np.float32)
        pose = raw_to_w2c(self.list[idx][1])
        return intr, pose

    def __getitem__(self, idx):
        opt = self.opt
        image = self.images[idx] if opt.data.preload else self.get_image(opt, idx)
        image = self.preprocess_image(opt, image)[..., :3]
        intr, pose = self.cameras[idx] if opt.data.preload else self.get_camera(opt, idx)
        intr, pose = self.preprocess_camera(opt, intr, pose)
        return dict(image=image, intr=intr, pose=pose)
