"""iPhone unposed-video loader. The port's own copy of
neural_invertible_warp_tpu/data/iphone.py (numpy; images through
``utils/image_io``: PNG and baseline or progressive JPEG without PIL).

Format parity with reference data/iphone.py: numbered frames under
``<root>/<scene>/images``, sorted by number; the last ``val_ratio`` of them
are the validation split; hard-coded iPhone intrinsics
(focal = W * 4.2mm / (12.8mm sensor diagonal / 2.55)); dummy identity poses
(the poses are unknown: pose optimization starts from the identity).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import image_io
from . import base

RAW_HW = (1080, 1920)


def focal_length(raw_W=RAW_HW[1]):
    """The hard-coded iPhone focal length in raw pixels (reference
    data/iphone.py): 4.2 mm over a 12.8 mm / 2.55 sensor width."""
    return raw_W * 4.2 / (12.8 / 2.55)


def split_frames(frames, val_ratio, split):
    """The frames of ``split``: the last int(N * val_ratio) are the
    validation split, the rest the training split."""
    num_val = int(len(frames) * val_ratio)
    return frames[:-num_val] if split == "train" else frames[-num_val:]


class Dataset(base.Dataset):

    def __init__(self, opt, split="train", subset=None):
        self.raw_H, self.raw_W = RAW_HW
        super().__init__(opt, split)
        self.root = opt.data.get("root") or "data/iphone"
        self.path = os.path.join(self.root, opt.data.scene)
        self.path_image = os.path.join(self.path, "images")
        self.list = sorted(os.listdir(self.path_image), key=lambda f: int(f.split(".")[0]))
        self.list = split_frames(self.list, opt.data.val_ratio, split)
        if subset:
            self.list = self.list[:subset]
        self.focal = focal_length(self.raw_W)
        if opt.data.preload:
            self.images = self.preload_threading(opt, self.get_image)
            self.cameras = self.preload_threading(opt, self.get_camera, "cameras")

    def get_all_camera_poses(self, opt):
        # unknown poses: dummy identities (reference data/iphone.py:40-42)
        return np.tile(np.eye(3, 4, dtype=np.float32), (len(self), 1, 1))

    def get_image(self, opt, idx):
        return image_io.read_image(os.path.join(self.path_image, self.list[idx]))

    def get_camera(self, opt, idx):
        intr = np.array([[self.focal, 0, self.raw_W / 2],
                         [0, self.focal, self.raw_H / 2],
                         [0, 0, 1]], dtype=np.float32)
        return intr, np.eye(3, 4, dtype=np.float32)

    def __getitem__(self, idx):
        opt = self.opt
        image = self.images[idx] if opt.data.preload else self.get_image(opt, idx)
        image = self.preprocess_image(opt, image)[..., :3]
        intr, pose = self.cameras[idx] if opt.data.preload else self.get_camera(opt, idx)
        intr, pose = self.preprocess_camera(opt, intr, pose)
        return dict(image=image, intr=intr, pose=pose)
