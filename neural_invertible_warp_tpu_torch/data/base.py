"""Shared dataset machinery: image preprocessing, intrinsics adjustment,
threaded preloading, whole-split collation. The port's own copy of
neural_invertible_warp_tpu/data/base.py. Images are uint8 numpy arrays
(``utils/image_io.read_image``), center-cropped by slicing and resized by
``image_io.resize``, Pillow's BICUBIC bit for bit; the augmentation branch
(``data.augment``) runs Pillow's jitter, mirror and bicubic rotation on the
arrays through ``utils/pil_ops``, bit for bit.

Parity with reference data/base.py:16-130; images come out as float32
[H,W,C] in [0,1], intrinsics are adjusted for center-crop and resize
(data/base.py:109-117).
"""

from __future__ import annotations

import concurrent.futures as futures

import numpy as np

from ..utils import image_io, log, pil_ops


class Dataset:
    """Base dataset: subclasses must set ``self.raw_H/raw_W`` and ``self.list``
    before calling super().__init__, then implement get_image/get_camera."""

    def __init__(self, opt, split="train"):
        self.opt = opt
        self.split = split
        self.augment = bool(opt.data.get("augment")) and split == "train"
        if opt.data.get("center_crop") is not None:
            self.crop_H = int(self.raw_H * opt.data.center_crop)
            self.crop_W = int(self.raw_W * opt.data.center_crop)
        else:
            self.crop_H, self.crop_W = self.raw_H, self.raw_W
        if not opt.get("H") or not opt.get("W"):
            opt.H, opt.W = self.crop_H, self.crop_W

    def __len__(self):
        return len(self.list)

    # -- loading ------------------------------------------------------------

    def preload_threading(self, opt, load_func, data_str="images"):
        """Parallel preloading (reference data/base.py:45-66)."""
        n_workers = max(1, int(opt.data.num_workers or 1))
        with futures.ThreadPoolExecutor(n_workers) as ex:
            out = list(ex.map(lambda i: load_func(opt, i), range(len(self))))
        log.info("preloaded {} {}".format(len(out), data_str))
        return out

    def get_image(self, opt, idx):
        raise NotImplementedError

    def get_camera(self, opt, idx):
        raise NotImplementedError

    # -- photometric augmentation (reference data/base.py:74-90) -------------

    def generate_augmentation(self, opt, rng=None):
        """Sample one augmentation: color-jitter factors (brightness /
        contrast / saturation multiplicative, hue additive) in the same
        ranges as torchvision ColorJitter.get_params, plus optional hflip
        and rotation. torchvision-free (Pillow's ImageEnhance + HSV, in
        ``utils/pil_ops``)."""
        rng = rng or np.random
        a = opt.data.augment
        jitter_order = rng.permutation(4)   # ColorJitter randomizes order
        jitter = dict(
            brightness=1 + (rng.rand() * 2 - 1) * (a.get("brightness") or 0.0),
            contrast=1 + (rng.rand() * 2 - 1) * (a.get("contrast") or 0.0),
            saturation=1 + (rng.rand() * 2 - 1) * (a.get("saturation") or 0.0),
            hue=(rng.rand() * 2 - 1) * (a.get("hue") or 0.0),
        )
        return dict(
            jitter=jitter, jitter_order=jitter_order,
            flip=bool(rng.randn() > 0) if a.get("hflip") else False,
            rot_angle=(rng.rand() * 2 - 1) * a.rotate if a.get("rotate")
            else 0.0,
        )

    @staticmethod
    def apply_color_jitter(image, jitter, order):
        """The colour jitter of the JAX package's PIL branch on uint8 [H,W,3]
        or [H,W,4] (the alpha channel carried through), bit for bit
        (``utils/pil_ops``)."""
        image = np.asarray(image)
        if image.ndim != 3 or image.shape[2] not in (3, 4):
            # PIL.Image.merge("RGB", ...) of the image's bands refuses it there
            raise ValueError("colour jitter of a {} image: wrong number of bands".format(
                image.shape))
        rgb = image[..., :3]
        for op in order:
            if op == 0 and jitter["brightness"] != 1:
                rgb = pil_ops.enhance_brightness(rgb, jitter["brightness"])
            elif op == 1 and jitter["contrast"] != 1:
                rgb = pil_ops.enhance_contrast(rgb, jitter["contrast"])
            elif op == 2 and jitter["saturation"] != 1:
                rgb = pil_ops.enhance_color(rgb, jitter["saturation"])
            elif op == 3 and jitter["hue"] != 0:
                rgb = pil_ops.shift_hue(rgb, jitter["hue"])
        if image.shape[2] == 4:
            return np.concatenate([rgb, image[..., 3:]], axis=-1)
        return np.ascontiguousarray(rgb)

    def apply_augmentation(self, image, aug):
        image = self.apply_color_jitter(image, aug["jitter"], aug["jitter_order"])
        if aug["flip"]:
            image = pil_ops.flip_lr(image)
        if aug["rot_angle"]:
            image = pil_ops.rotate_bicubic(image, aug["rot_angle"])
        return image

    # -- preprocessing ------------------------------------------------------

    def preprocess_image(self, opt, image, aug=None):
        """uint8 [H,W(,C)] -> float32 [H,W,C] in [0,1], with optional
        photometric augmentation, then center-crop + resize."""
        if aug is None and self.augment:
            aug = self.generate_augmentation(opt)
        if aug is not None:
            image = self.apply_augmentation(image, aug)
        if opt.data.get("center_crop") is not None:
            left = (self.raw_W - self.crop_W) // 2
            top = (self.raw_H - self.crop_H) // 2
            image = image[top:top + self.crop_H, left:left + self.crop_W]
        if opt.data.image_size[0] is not None:
            # PIL's default resample (reference data/base.py:105 calls
            # image.resize() with no resample argument -> BICUBIC)
            image = image_io.resize(image, (opt.W, opt.H), "bicubic")
        arr = np.asarray(image, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr

    def preprocess_camera(self, opt, intr, pose):
        """Adjust intrinsics for crop/resize (reference data/base.py:109-117)."""
        intr = np.array(intr, dtype=np.float32)
        intr[0, 2] -= (self.raw_W - self.crop_W) / 2
        intr[1, 2] -= (self.raw_H - self.crop_H) / 2
        intr[0] *= opt.W / self.crop_W
        intr[1] *= opt.H / self.crop_H
        return intr, np.array(pose, dtype=np.float32)

    # -- whole-split collation ----------------------------------------------

    def __getitem__(self, idx):
        raise NotImplementedError

    def image_names(self):
        """Best-effort per-sample image file names (basename), or None.

        Used to match samples against external reconstructions by name
        (pose.init=colmap_files, utils/colmap_io.poses_from_model).
        """
        import os as _os
        names = []
        for entry in self.list:
            if isinstance(entry, str):
                names.append(_os.path.basename(entry))
            elif isinstance(entry, (tuple, list)) and entry \
                    and isinstance(entry[0], str):
                names.append(_os.path.basename(entry[0]))
            elif isinstance(entry, dict) and "file_path" in entry:
                names.append(
                    _os.path.basename(str(entry["file_path"])) + ".png")
            else:
                return None
        return names

    def all_arrays(self, opt):
        """Stack the whole split into a dict of numpy arrays (device-ready)."""
        samples = [self[i] for i in range(len(self))]
        out = {}
        for k in samples[0]:
            out[k] = np.stack([np.asarray(s[k]) for s in samples]).astype(
                np.float32 if np.asarray(samples[0][k]).dtype.kind == "f" else None)
        out["idx"] = np.arange(len(self), dtype=np.int32)
        return out


# -- host-side pose helpers (numpy mirrors of ops.pose, used by loaders) -----

def np_pose(R=None, t=None):
    if R is None:
        R = np.eye(3, dtype=np.float32)
    if t is None:
        t = np.zeros(3, dtype=np.float32)
    R = np.asarray(R, np.float32)
    t = np.asarray(t, np.float32)
    return np.concatenate([R, t[..., None]], axis=-1)


def np_invert(pose):
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = np.swapaxes(R, -1, -2)
    t_inv = (-R_inv @ t)[..., 0]
    return np.concatenate([R_inv, t_inv[..., None]], axis=-1).astype(np.float32)


def np_compose_pair(pose_a, pose_b):
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    R = R_b @ R_a
    t = R_b @ t_a + t_b
    return np.concatenate([R, t], axis=-1).astype(np.float32)
