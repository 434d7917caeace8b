"""Blender synthetic dataset loader. The port's own copy of
neural_invertible_warp_tpu/data/blender.py (numpy; images through
``utils/image_io``: PNG read and resized without PIL).

Format parity with reference data/blender.py:17-90:
* ``transforms_{split}.json`` frame list with 4x4 c2w matrices;
* focal = 0.5 * W / tan(0.5 * camera_angle_x);
* RGBA images composited onto ``opt.data.bgcolor`` via the alpha channel;
* pose conversion: x-flip then invert -> w2c OpenCV.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils import image_io
from . import base
from .base import np_compose_pair, np_invert, np_pose


def focal_length(meta, raw_W=800):
    """The focal length in raw pixels of a ``transforms_*.json`` dict."""
    return 0.5 * raw_W / np.tan(0.5 * meta["camera_angle_x"])


def raw_to_w2c(pose_raw):
    """A frame's ``transform_matrix`` (OpenGL c2w) -> OpenCV w2c [3,4]:
    x-flip, then invert."""
    flip = np_pose(R=np.diag([1.0, -1.0, -1.0]))
    pose = np_compose_pair(flip, np.asarray(pose_raw)[:3].astype(np.float32))
    return np_invert(pose)


def parse_frames(meta):
    """w2c poses [N,3,4] float32 of every frame of a ``transforms_*.json``
    dict, as the loader reads them."""
    return np.stack([raw_to_w2c(np.array(f["transform_matrix"], np.float32))
                     for f in meta["frames"]])


class Dataset(base.Dataset):

    def __init__(self, opt, split="train", subset=None):
        self.raw_H, self.raw_W = 800, 800
        super().__init__(opt, split)
        self.root = opt.data.get("root") or "data/blender"
        self.path = os.path.join(self.root, opt.data.scene)
        with open(os.path.join(self.path, "transforms_{}.json".format(split))) as f:
            self.meta = json.load(f)
        self.list = self.meta["frames"]
        self.focal = focal_length(self.meta, self.raw_W)
        if subset:
            self.list = self.list[:subset]
        if opt.data.preload:
            self.images = self.preload_threading(opt, self.get_image)
            self.cameras = self.preload_threading(opt, self.get_camera, "cameras")

    def get_all_camera_poses(self, opt):
        return parse_frames({"frames": self.list})

    def get_image(self, opt, idx):
        fname = os.path.join(self.path, "{}.png".format(self.list[idx]["file_path"]))
        return image_io.read_image(fname)

    def get_camera(self, opt, idx):
        intr = np.array([[self.focal, 0, self.raw_W / 2],
                         [0, self.focal, self.raw_H / 2],
                         [0, 0, 1]], dtype=np.float32)
        pose_raw = np.array(self.list[idx]["transform_matrix"], np.float32)
        return intr, raw_to_w2c(pose_raw)

    def __getitem__(self, idx):
        opt = self.opt
        image = self.images[idx] if opt.data.preload else self.get_image(opt, idx)
        image = self.preprocess_image(opt, image)
        rgb, mask = image[..., :3], image[..., 3:]
        if opt.data.get("bgcolor") is not None:
            rgb = rgb * mask + opt.data.bgcolor * (1 - mask)
        intr, pose = self.cameras[idx] if opt.data.preload else self.get_camera(opt, idx)
        intr, pose = self.preprocess_camera(opt, intr, pose)
        return dict(image=rgb, intr=intr, pose=pose)
