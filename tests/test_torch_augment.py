"""The port's ``data.augment`` branch without PIL (``utils/pil_ops`` and the
array methods of ``data/base.py``) held bit for bit against Pillow and
against the JAX package's ``Dataset`` methods, which run on PIL images, on
seeded RGB and RGBA images of odd sizes; then both packages' LLFF loaders
with ``data.augment`` on the committed progressive JPEG tree."""

import os

import numpy as np
import PIL.Image
import PIL.ImageEnhance
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from neural_invertible_warp_tpu.data import base as jax_base
from neural_invertible_warp_tpu_torch.data import base
from neural_invertible_warp_tpu_torch.dotdict import DotDict
from neural_invertible_warp_tpu_torch.utils import pil_ops

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(7, 11), (13, 9), (16, 16), (21, 34), (131, 29)]
FACTORS = [0.0, 1.0, 1e-3, 0.3, 0.5, 0.999, 1.0001, 1.37, 2.0]
HUES = [-0.5, -0.31, -0.01, 0.0, 0.004, 0.01, 0.25, 0.5]
ANGLES = [0.0, 90.0, -90.0, 180.0, 270.0, 360.0, 0.5, -3.7, 12.25, -29.9, 45.0, 1e-9]
ENHANCE = {"brightness": (PIL.ImageEnhance.Brightness, pil_ops.enhance_brightness),
           "contrast": (PIL.ImageEnhance.Contrast, pil_ops.enhance_contrast),
           "color": (PIL.ImageEnhance.Color, pil_ops.enhance_color)}
AUGMENT = dict(brightness=0.2, contrast=0.2, saturation=0.2, hue=0.05, hflip=True, rotate=5.0)


def image(h, w, channels, seed):
    """Seeded uint8 [h,w,channels]: smooth colour and noise; an alpha channel
    holds 0, 255 and values between."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    phase = np.arange(channels)
    a = 128 + 90 * np.sin(xx[..., None] / 3.0 + phase) * np.cos(yy[..., None] / 5.0 - phase)
    a = np.clip(a + 30 * rng.randn(h, w, channels), 0, 255).astype(np.uint8)
    if channels == 4:
        a[..., 3] = rng.choice([0, 255, 1, 128, 200], (h, w))
    return a


def assert_same(got, ref, what):
    ref = np.asarray(ref)
    assert got.dtype == np.uint8 and got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.array_equal(got, ref), (what, int((got != ref).sum()))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("op", sorted(ENHANCE))
def test_enhancements_match_pillow(op, size):
    cls, fn = ENHANCE[op]
    rgb = image(*size, 3, seed=size[0] * 31 + size[1])
    for factor in FACTORS:
        assert_same(fn(rgb, factor), cls(PIL.Image.fromarray(rgb)).enhance(factor),
                    (op, size, factor))


@settings(max_examples=40, deadline=None)
@given(factor=st.floats(-1.0, 3.0, allow_nan=False), op=st.sampled_from(sorted(ENHANCE)),
       seed=st.integers(0, 1000))
def test_enhancement_factor_sweep(factor, op, seed):
    """Any factor, inside [0, 1] (Blend.c's truncating path) and outside it
    (the clipping path)."""
    cls, fn = ENHANCE[op]
    rgb = image(9, 13, 3, seed)
    assert_same(fn(rgb, factor), cls(PIL.Image.fromarray(rgb)).enhance(factor), (op, factor))


def test_blend_luma_and_hsv_match_pillow():
    """``blend`` over every pair of byte values, ``to_luma`` and the HSV
    conversions both ways over a lattice of the colour cube and seeded
    colours."""
    a = np.repeat(np.arange(256, dtype=np.uint8), 256).reshape(256, 256)
    pairs = [np.stack([a] * 3, -1), np.stack([a.T] * 3, -1)]
    for alpha in (0.0, 1.0, 0.1, 0.5, 0.7, 1e-7, 1 - 1e-7, -0.3, 1.5, 2.0):
        ref = PIL.Image.blend(*(PIL.Image.fromarray(p) for p in pairs), alpha)
        assert_same(pil_ops.blend(*pairs, alpha), ref, alpha)
    axis = np.r_[0:256:5, 254, 255]
    cube = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    cube = np.concatenate([cube, np.random.RandomState(0).randint(0, 256, (62536, 3))])
    cube = cube.astype(np.uint8).reshape(-1, 100, 3)
    im = PIL.Image.fromarray(cube)
    assert_same(pil_ops.to_luma(cube), im.convert("L"), "luma")
    assert_same(pil_ops.rgb_to_hsv(cube), im.convert("HSV"), "rgb -> hsv")
    hsv = PIL.Image.frombytes("HSV", im.size, cube.tobytes())
    assert_same(pil_ops.hsv_to_rgb(cube), hsv.convert("RGB"), "hsv -> rgb")


@pytest.mark.parametrize("size", SIZES)
def test_hue_shift_matches_pillow(size):
    """The jitter's hue step as the JAX package writes it with PIL."""
    rgb = image(*size, 3, seed=7)
    for hue in HUES:
        h, s, v = PIL.Image.fromarray(rgb).convert("HSV").split()
        h = h.point(lambda x: (x + int(hue * 255)) % 256)
        ref = PIL.Image.merge("HSV", (h, s, v)).convert("RGB")
        assert_same(pil_ops.shift_hue(rgb, hue), ref, hue)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("size", SIZES)
def test_flip_and_bicubic_rotation_match_pillow(size, channels):
    """Angles 0, +-90, 180 and small ones, on odd and square sizes; RGBA
    through Pillow's premultiplied round trip."""
    img = image(*size, channels, seed=size[0] + 100 * channels)
    pil = PIL.Image.fromarray(img)
    assert_same(pil_ops.flip_lr(img), pil.transpose(PIL.Image.FLIP_LEFT_RIGHT), "flip")
    for angle in ANGLES + list(np.random.RandomState(size[1]).uniform(-180, 180, 4)):
        assert_same(pil_ops.rotate_bicubic(img, angle),
                    pil.rotate(angle, resample=PIL.Image.BICUBIC), (size, channels, angle))


class _JaxData(jax_base.Dataset):
    def __init__(self, opt, h, w):
        self.raw_H, self.raw_W, self.list = h, w, []
        super().__init__(opt, "train")


class _PortData(base.Dataset):
    def __init__(self, opt, h, w):
        self.raw_H, self.raw_W, self.list = h, w, []
        super().__init__(opt, "train")


def _options(h, w, size, crop=None):
    opt = DotDict(dict(data=dict(augment=dict(AUGMENT), center_crop=crop, image_size=size)))
    if size[0] is not None:
        opt.H, opt.W = size
    return opt


@pytest.mark.parametrize("channels", [3, 4])
def test_augmentation_and_preprocessing_match_the_jax_dataset(channels):
    """The same seeded draws of ``generate_augmentation`` (also equal), then
    ``apply_color_jitter`` / ``apply_augmentation`` on arrays against the
    JAX package's on PIL images, and ``preprocess_image`` (with a center
    crop and a resize, and without) against its float32 output."""
    h, w = 23, 31
    for seed in range(6):
        img = image(h, w, channels, seed)
        for size, crop in (([None, None], None), ([12, 16], 0.8)):
            opt = _options(h, w, size, crop)
            port, ref = _PortData(opt, h, w), _JaxData(opt.copy(), h, w)
            aug = port.generate_augmentation(opt, np.random.RandomState(seed))
            aug_ref = ref.generate_augmentation(opt, np.random.RandomState(seed))
            assert aug["flip"] == aug_ref["flip"] and aug["rot_angle"] == aug_ref["rot_angle"]
            assert aug["jitter"] == aug_ref["jitter"]
            assert np.array_equal(aug["jitter_order"], aug_ref["jitter_order"])
            jit = port.apply_color_jitter(img, aug["jitter"], aug["jitter_order"])
            assert_same(jit, ref.apply_color_jitter(PIL.Image.fromarray(img), aug["jitter"],
                                                    aug["jitter_order"]), ("jitter", seed))
            assert_same(port.apply_augmentation(img, aug),
                        ref.apply_augmentation(PIL.Image.fromarray(img), aug), ("aug", seed))
            got = port.preprocess_image(opt, img, aug)
            want = ref.preprocess_image(opt, PIL.Image.fromarray(img), aug)
            assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want), seed


def test_a_gray_image_cannot_be_jittered_in_either_package():
    opt = _options(9, 11, [None, None])
    gray = image(9, 11, 1, 0)[..., 0]
    aug = _PortData(opt, 9, 11).generate_augmentation(opt, np.random.RandomState(0))
    with pytest.raises(ValueError):
        _JaxData(opt.copy(), 9, 11).apply_color_jitter(PIL.Image.fromarray(gray), aug["jitter"],
                                                       aug["jitter_order"])
    with pytest.raises(ValueError, match="wrong number of bands"):
        _PortData(opt, 9, 11).apply_color_jitter(gray, aug["jitter"], aug["jitter_order"])


def test_llff_loader_with_augment_matches_jax():
    """Both packages' LLFF loaders on the committed progressive JPEG tree
    (19 views at 240x320; the JAX one reads it through imageio and PIL)
    with every augmentation on and ``np.random`` seeded the same: equal
    arrays in both splits, the training views augmented (unlike an
    unaugmented load) and the validation view not."""
    from neural_invertible_warp_tpu.data import llff as jax_llff
    from neural_invertible_warp_tpu_torch.data import llff
    from neural_invertible_warp_tpu_torch.flagship import flagship_options
    opt = flagship_options()
    opt.data.update(root=os.path.join(ROOT, "tests", "data", "jpeg", "llff_progressive"),
                    scene="blobfern", image_size=[60, 80], val_ratio=0.1, preload=True,
                    augment=DotDict(AUGMENT))
    opt.H, opt.W = 60, 80
    plain = opt.copy()
    plain.data.augment = {}
    for split in ("train", "val"):
        np.random.seed(11)
        got = llff.Dataset(opt, split).all_arrays(opt)
        np.random.seed(11)
        ref = jax_llff.Dataset(opt.copy(), split).all_arrays(opt.copy())
        assert set(got) == set(ref) and len(got["image"]) == (18 if split == "train" else 1)
        for k in got:
            assert np.array_equal(got[k], ref[k]), (split, k)
        unaugmented = llff.Dataset(plain, split).all_arrays(plain)["image"]
        changed = [not np.array_equal(a, b) for a, b in zip(got["image"], unaugmented)]
        assert all(changed) if split == "train" else not any(changed), (split, changed)
