"""DTU dataset loader (pixelNeRF-processed DVR format). The port's own copy
of neural_invertible_warp_tpu/data/dtu.py, on numpy alone: images through
``utils/image_io`` (PNG, and JPEG through ``utils/jpeg``), the mask as
PIL's ``Image.open`` gives it (a palette PNG as its indices), and cv2's
projection-matrix decomposition and resizes through ``utils/cv_ops``
(OpenCV's own arithmetic, not its IPP path: the resized image can differ
from a cv2 built with IPP by an ulp or so, and a mask pixel at exactly 1 by
one ulp under it, which ``np.floor`` then drops).

Format parity with reference data/dtu.py:
* ``rs_dtu_4/DTU/<scan>/cameras.npz`` holds projection matrices
  ``world_mat_i`` = K [R|t]; decomposed as cv2.decomposeProjectionMatrix does,
  translations recentered by ``scale_mat_i`` and rescaled by 1/300
  (data/dtu.py:212-248); the removed recentering is kept as ``norm_trans``
  so that ``evaluate --export_dtu_cameras`` can write poses back in the
  original DTU frame;
* splits: pixelnerf / all / pixelnerf_reduced_testset / every-``dtuhold``-th
  (data/dtu.py:121-139);
* IDR foreground masks from ``submission_data/idrmasks`` (data/dtu.py:257-282);
* GT depth from PFM files under ``Depths/<scan>/depth_map_xxxx.pfm``, scaled by
  1/300 (data/dtu.py:285-290);
* fixed depth range near 1.2 / far 5.2, optionally widened (data/dtu.py:362-364).
"""

from __future__ import annotations

import os
import re

import numpy as np

from . import base
from ..utils import cv_ops, image_io

NEAR_DEPTH = 1.2
FAR_DEPTH = 5.2
SCALING_FACTOR = 1.0 / 300.0

PIXELNERF_TRAIN = [25, 22, 28, 40, 44, 48, 0, 8, 13]
PIXELNERF_EXCLUDE = [3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 36, 37, 38, 39]
PIXELNERF_REDUCED_TRAIN = [25, 22, 28, 40, 44, 48, 0, 8, 13, 24, 30, 41, 47,
                           43, 29, 45, 34, 33]
PIXELNERF_REDUCED_TEST = [1, 2, 9, 10, 11, 12, 14, 15, 23, 26, 27, 31, 32, 35,
                          42, 46]
IDR_SCANS = ["scan40", "scan55", "scan63", "scan110", "scan114"]


def read_pfm(filename):
    """PFM depth map reader (reference data/dtu.py:45-88)."""
    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("not a PFM file: {}".format(filename))
        dims = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("utf-8"))
        if not dims:
            raise ValueError("malformed PFM header")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy(), abs(scale)


def split_indices(split_type, n, dtuhold):
    """dict(train=[...], test=[...]) image indices of one split type."""
    if split_type == "pixelnerf":
        test_idx = [i for i in range(49) if i not in PIXELNERF_TRAIN + PIXELNERF_EXCLUDE]
        return dict(train=PIXELNERF_TRAIN, test=test_idx)
    if split_type == "all":
        idx = list(range(n))
        return dict(train=idx, test=idx)
    if split_type == "pixelnerf_reduced_testset":
        return dict(train=PIXELNERF_REDUCED_TRAIN, test=PIXELNERF_REDUCED_TEST)
    all_idx = np.arange(n)
    return dict(test=all_idx[all_idx % dtuhold == 0].tolist(),
                train=all_idx[all_idx % dtuhold != 0].tolist())


class Dataset(base.Dataset):

    def __init__(self, opt, split="train", subset=None):
        self.raw_H, self.raw_W = 300, 400
        super().__init__(opt, split)
        self.root = opt.data.get("root") or "data/dtu"
        self.depth_dir = os.path.join(self.root, "Depths")
        self.mask_path = os.path.join(self.root, "submission_data", "idrmasks")
        self.data_path = os.path.join(self.root, "rs_dtu_4", "DTU")
        self.scene = opt.data.scene
        rgb_files, intrinsics, poses_c2w = self.load_scene_data(
            os.path.join(self.data_path, self.scene))

        dtu_cfg = opt.data.dtu
        n = len(rgb_files)
        indices = split_indices(dtu_cfg.split_type, n, dtu_cfg.dtuhold)[
            "train" if "train" in split else "test"]
        if opt.get("pose") and opt.pose.get("dtu_reconstruction") and "train" in split:
            indices = list(range(n))
        sub_key = "train_sub" if "train" in split else "val_sub"
        if dtu_cfg.get(sub_key) is not None:
            indices = indices[:dtu_cfg[sub_key]]
        if subset:
            indices = indices[:subset]

        self.indices = list(indices)
        self.rgb_files = [rgb_files[i] for i in self.indices]
        self.poses_c2w = np.stack([poses_c2w[i] for i in self.indices])
        self.intrinsics = np.stack([intrinsics[i] for i in self.indices])
        self.mask_files = self._mask_paths(self.scene, self.indices)
        self.list = self.rgb_files  # for __len__

    # ----------------------------------------------------------- scene files

    def load_scene_data(self, scene_path):
        """(image files, intrinsics [3,3] each, normalized c2w [4,4] each);
        sets ``norm_trans`` [3,1], the scale_mat translation removed from
        every camera center before the 1/300 scaling."""
        img_dir = os.path.join(scene_path, "image")
        if not os.path.isdir(img_dir):
            raise FileNotFoundError(img_dir)
        rgb_files = [os.path.join(img_dir, f) for f in sorted(os.listdir(img_dir))]
        pose_indices = [int(os.path.basename(f)[:-4]) for f in rgb_files]
        cam = np.load(os.path.join(scene_path, "cameras.npz"))
        intrinsics, poses_c2w = [], []
        self.norm_trans = np.zeros((3, 1), dtype=np.float32)
        for p in pose_indices:
            P = cam["world_mat_{}".format(p)][:3]
            K, R, t = cv_ops.decompose_projection_matrix(P)
            K = K / K[2, 2]
            pose_c2w = np.eye(4, dtype=np.float32)
            pose_c2w[:3, :3] = R.transpose()
            pose_c2w[:3, 3] = (t[:3] / t[3])[:, 0]
            scale_mat = cam.get("scale_mat_{}".format(p))
            if scale_mat is not None:
                pose_c2w[:3, 3:] -= scale_mat[:3, 3:]
                self.norm_trans = scale_mat[:3, 3:].astype(np.float32)
                norm_scale = np.diagonal(scale_mat[:3, :3])
                if not np.allclose(norm_scale, norm_scale[0]):
                    raise ValueError("anisotropic DTU scale_mat")
            pose_c2w[:3, 3:] *= SCALING_FACTOR
            intr = np.eye(3, dtype=np.float32)
            intr[:] = K
            intrinsics.append(intr)
            poses_c2w.append(pose_c2w)
        return rgb_files, intrinsics, poses_c2w

    def _mask_paths(self, scene, indices):
        sub = ("mask",) if scene in IDR_SCANS else ()
        return [os.path.join(self.mask_path, scene, *sub, "{:03d}.png".format(i))
                for i in indices]

    def read_depth(self, fname):
        depth, _ = read_pfm(fname)
        return depth.astype(np.float32) * SCALING_FACTOR

    # ----------------------------------------------------------------- items

    def get_all_camera_poses(self, opt):
        w2c = np.linalg.inv(self.poses_c2w)
        return w2c[:, :3].astype(np.float32)

    def __getitem__(self, idx):
        opt = self.opt
        rgb = image_io.read_image(self.rgb_files[idx])
        h, w = rgb.shape[:2]
        pose_w2c = np.linalg.inv(self.poses_c2w[idx])[:3].astype(np.float32)
        intr = self.intrinsics[idx][:3, :3].astype(np.float32).copy()

        mask_file = self.mask_files[idx]
        if os.path.exists(mask_file):
            # [..., :3] as the reference slices PIL's array: a gray mask
            # [H,W] loses its width here, as it does there
            m = np.asarray(image_io.read_image(mask_file, expand_palette=False),
                           dtype=np.float32)[..., :3] / 255.0
            mask = (m[..., 0] == 1)
        else:
            mask = np.ones((h, w), bool)

        depth_file = os.path.join(self.depth_dir, self.scene,
                                  "depth_map_{:04d}.pfm".format(self.indices[idx]))
        if os.path.exists(depth_file):
            depth_gt = self.read_depth(depth_file)
        else:
            depth_gt = np.zeros((h, w), np.float32)

        # resize image + intrinsics + depth + mask to opt.H/W
        image = np.asarray(rgb, np.float32) / 255.0
        if (opt.H, opt.W) != (h, w):
            image = cv_ops.resize_linear(image, (opt.W, opt.H))
            depth_gt = cv_ops.resize_nearest(depth_gt, (opt.W, opt.H))
            mask = np.floor(cv_ops.resize_linear(mask.astype(np.float32),
                                                 (opt.W, opt.H))).astype(bool)
            intr[0] *= opt.W / w
            intr[1] *= opt.H / h
        valid_depth_gt = depth_gt > 0

        if opt.data.dtu.get("mask_img"):
            m = mask[..., None].astype(np.float32)
            image = image * m + 1 - m
            valid_depth_gt = valid_depth_gt & mask

        widen = opt.data.dtu.get("increase_depth_range_by_x_percent") or 0
        depth_range = np.array([NEAR_DEPTH * (1 - widen), FAR_DEPTH * (1 + widen)],
                               np.float32)
        return dict(image=image.astype(np.float32), intr=intr, pose=pose_w2c,
                    depth_gt=depth_gt.astype(np.float32),
                    valid_depth_gt=valid_depth_gt.astype(np.float32),
                    fg_mask=mask.astype(np.float32),
                    depth_range=depth_range)
