"""LLFF forward-facing dataset loader. The port's own copy of
neural_invertible_warp_tpu/data/llff.py (numpy, PIL and imageio only).

Format parity with reference data/llff.py:17-134:
* ``poses_bounds.npy``: [N,17] rows = 3x5 camera matrix (c2w OpenGL
  [down? right? see axis swap] + [H,W,focal] column) ++ 2 depth bounds;
* axis swap col0 <- col1, col1 <- -col0 (data/llff.py:51);
* world rescale by 1/(bounds.min()*0.75) (data/llff.py:56);
* pose centering by the inverse of the average pose (data/llff.py:63-72);
* per-camera conversion to w2c OpenCV with a 180-degree x-flip on both sides
  (``parse_raw_camera``, data/llff.py:107-134);
* sequential train/val split by ``val_ratio`` from the END of the list
  (data/llff.py:32-33).
"""

from __future__ import annotations

import os

import numpy as np
import PIL.Image
import imageio.v2 as imageio

from . import base
from .base import np_compose_pair, np_invert, np_pose


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
        fname = os.path.join(self.path, "poses_bounds.npy")
        data = np.load(fname).astype(np.float32)
        cam_data = data[:, :-2].reshape(-1, 3, 5)
        poses_raw = cam_data[..., :4].copy()
        # swap conventions: new col0 = old col1, new col1 = -old col0
        col0, col1 = poses_raw[..., 0].copy(), poses_raw[..., 1].copy()
        poses_raw[..., 0], poses_raw[..., 1] = col1, -col0
        raw_H, raw_W, self.focal = cam_data[0, :, -1]
        assert self.raw_H == raw_H and self.raw_W == raw_W, \
            "unexpected LLFF raw image size: {}x{}".format(raw_H, raw_W)
        bounds = data[:, -2:]
        scale = 1.0 / (bounds.min() * 0.75)
        poses_raw[..., 3] *= scale
        bounds = bounds * scale
        poses_raw = self.center_camera_poses(poses_raw)
        return poses_raw, bounds

    def center_camera_poses(self, poses):
        """Subtract the average pose (reference data/llff.py:63-72)."""
        center = poses[..., 3].mean(axis=0)
        v1 = poses[..., 1].mean(axis=0)
        v1 /= np.linalg.norm(v1)
        v2 = poses[..., 2].mean(axis=0)
        v2 /= np.linalg.norm(v2)
        v0 = np.cross(v1, v2)
        pose_avg = np.stack([v0, v1, v2, center], axis=-1)
        return np_compose_pair(poses, np_invert(pose_avg)[None])

    def parse_raw_camera(self, pose_raw):
        """OpenGL c2w -> OpenCV w2c with the double x-flip (data/llff.py:107-134)."""
        flip = np_pose(R=np.diag([1.0, -1.0, -1.0]))
        pose = np_compose_pair(flip, pose_raw[:3])
        pose = np_invert(pose)
        pose = np_compose_pair(flip, pose)
        return pose

    def get_all_camera_poses(self, opt):
        return np.stack([self.parse_raw_camera(tup[1]) for tup in self.list])

    def get_image(self, opt, idx):
        fname = os.path.join(self.path_image, self.list[idx][0])
        return PIL.Image.fromarray(imageio.imread(fname))

    def get_camera(self, opt, idx):
        intr = np.array([[self.focal, 0, self.raw_W / 2],
                         [0, self.focal, self.raw_H / 2],
                         [0, 0, 1]], dtype=np.float32)
        pose = self.parse_raw_camera(self.list[idx][1])
        return intr, pose

    def __getitem__(self, idx):
        opt = self.opt
        image = self.images[idx] if opt.data.preload else self.get_image(opt, idx)
        image = self.preprocess_image(opt, image)[..., :3]
        intr, pose = self.cameras[idx] if opt.data.preload else self.get_camera(opt, idx)
        intr, pose = self.preprocess_camera(opt, intr, pose)
        return dict(image=image, intr=intr, pose=pose)
