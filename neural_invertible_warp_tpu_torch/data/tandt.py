"""Tanks and Temples loader (the NoPe-NeRF layout). The port's own copy of
neural_invertible_warp_tpu/data/tandt.py (numpy; images read as
``data/llff.py`` reads them).

Format parity with reference data/tandt.py: LLFF's ``poses_bounds.npy``
with LLFF's axis swap, rescale and centering at a raw size of 540x960, then
NoPe-NeRF's spherification (recentre on the point nearest to every camera
axis and rescale to unit radius; data/tandt.py:111-170) and NoPe-NeRF's
split: every ``val_ratio``-th image from ``val_ratio // 2`` on is a test
image, the first two test images are the validation split
(data/tandt.py:46-58).
"""

from __future__ import annotations

import os

import numpy as np

from . import base
from . import llff
from ..utils import log


def _normalize(x):
    return x / np.linalg.norm(x)


def spherify_poses(poses, bds):
    """NoPe-NeRF spherification (reference data/tandt.py:111-170)."""
    poses = np.asarray(poses, np.float32)
    bds = np.asarray(bds, np.float32)

    def p34_to_44(p):
        bottom = np.tile(np.eye(4)[-1].reshape(1, 1, 4), (p.shape[0], 1, 1))
        return np.concatenate([p, bottom], 1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]
    A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -A_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(A_i, [0, 2, 1]) @ A_i).mean(0)) @ b_i.mean(0))

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)
    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])

    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    return poses_reset[:, :3, :4].astype(np.float32), bds.astype(np.float32)


def split_indices(n, val_ratio):
    """NoPe's split of ``n`` images: every ``val_ratio``-th from
    ``val_ratio // 2`` on is a test image, the first two test images are the
    validation split, the rest train. Returns dict(train, val, test) of
    index arrays."""
    ids = np.arange(n)
    step = int(val_ratio)
    i_test = ids[step // 2::step]
    i_train = np.array([i for i in ids if i not in i_test])
    return dict(train=i_train, val=i_test[:2], test=i_test)


class Dataset(llff.Dataset):

    def __init__(self, opt, split="train", subset=None):
        self.raw_H, self.raw_W = 540, 960
        base.Dataset.__init__(self, opt, split)
        self.root = opt.data.get("root") or "data/tandt"
        self.path = os.path.join(self.root, opt.data.scene)
        self.path_image = os.path.join(self.path, "images")
        image_fnames = sorted(os.listdir(self.path_image))
        poses_raw, bounds = self.parse_cameras_and_bounds(opt)
        poses_raw, bounds = spherify_poses(poses_raw, bounds)
        self.list = list(zip(image_fnames, poses_raw, bounds))

        pick = split_indices(len(self.list), opt.data.val_ratio)[split]
        self.list = [self.list[i] for i in pick]
        log.info("tandt split {}: {} images".format(split, len(self.list)))
        if subset:
            self.list = self.list[:subset]
        if opt.data.preload:
            self.images = self.preload_threading(opt, self.get_image)
            self.cameras = self.preload_threading(opt, self.get_camera, "cameras")
