"""The port's numpy versions of the DTU loader's three OpenCV steps
(``utils/cv_ops.py``) against cv2: bit for bit against OpenCV's own code
(IPP off), within the measured gap against cv2's default (IPP on, with
which the JAX package's loader runs), and the port's DTU loader against the JAX
package's on ``synth_data.make_dtu_scene`` trees read at a downscale."""

import contextlib
import os

import cv2
import numpy as np
import pytest
import torch

import synth_data
from neural_invertible_warp_tpu.data import dtu as jdtu
from neural_invertible_warp_tpu_torch.data import get_dataset
from neural_invertible_warp_tpu_torch.dotdict import DotDict
from neural_invertible_warp_tpu_torch.utils import cv_ops

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

RAW = (1200, 1600)                   # DTU's raw images
SIZES = [(300, 400), (480, 640), (360, 500), (600, 800), (1500, 2000)]
# cv_ops against cv2's default (IPP on), measured with cv2 5.0.0 and IPP
# 2026.0.0 (AVX-512) on random float32 images: at most 1 ulp near 1
# (1.19e-7) where the scale is 2 or 4, up to 6.59e-5 at 360x500 and
# 1500x2000 (IPP's own coordinates)
IPP_GAP = {(300, 400): 1.2e-7, (480, 640): 1.2e-7, (600, 800): 1.2e-7,
           (360, 500): 7e-5, (1500, 2000): 7e-5}


@contextlib.contextmanager
def ipp(on):
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(on)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


@pytest.fixture(scope="module")
def raw_images():
    rng = np.random.RandomState(0)
    image = rng.rand(*RAW, 3).astype(np.float32)
    # a binary foreground mask (a disc with holes), as the IDR masks are
    yy, xx = np.mgrid[:RAW[0], :RAW[1]]
    mask = ((yy - 600.0) ** 2 + (xx - 800.0) ** 2 < 450.0 ** 2) & (rng.rand(*RAW) > 0.02)
    depth = (rng.rand(*RAW) * 1500 + 400).astype(np.float32) * mask
    return image, mask.astype(np.float32), depth


@pytest.mark.parametrize("size", SIZES)
def test_resize_linear_equals_opencv_bit_for_bit(size, raw_images):
    """DTU's 1200x1600 to each size (600x800 is exactly 2x: INTER_AREA), one
    and three channels, the mask too; nearest on the depth."""
    image, mask, depth = raw_images
    H, W = size
    with ipp(False):
        for a in (image, mask, image[..., :1]):
            assert np.array_equal(cv_ops.resize_linear(a, (W, H)),
                                  cv2.resize(a, (W, H), interpolation=cv2.INTER_LINEAR))
        assert np.array_equal(cv_ops.resize_nearest(depth, (W, H)),
                              cv2.resize(depth, (W, H), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("seed", range(4))
def test_resizes_equal_opencv_on_a_seeded_sweep(seed):
    """Random sizes up and down, 1 to 4 channels, a third of them exactly
    halved (the INTER_AREA switch, SIMD and scalar column blocks)."""
    rng = np.random.RandomState(seed)
    with ipp(False):
        for _ in range(40):
            h, w = rng.randint(1, 80, 2)
            H, W = (2 * h, 2 * w) if rng.rand() < 0.35 else rng.randint(1, 120, 2)
            x = rng.rand(H, W, rng.randint(1, 5)).astype(np.float32)
            x = x[..., 0] if x.shape[2] == 1 and rng.rand() < 0.5 else x
            for fn, flag in ((cv_ops.resize_linear, cv2.INTER_LINEAR),
                             (cv_ops.resize_nearest, cv2.INTER_NEAREST)):
                got = fn(x, (int(w), int(h)))
                assert np.array_equal(got, cv2.resize(x, (int(w), int(h)), interpolation=flag)), \
                    (fn.__name__, x.shape, h, w)


def _projections(n, seed):
    """DTU-like P = s K [R | -R c] (a negative s in half of them: det < 0)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        K = np.array([[rng.uniform(500, 3000), rng.uniform(-5, 5), rng.uniform(100, 900)],
                      [0, rng.uniform(500, 3000), rng.uniform(100, 700)], [0, 0, 1]])
        q, _ = np.linalg.qr(rng.randn(3, 3))
        R = q * np.sign(np.linalg.det(q))
        c = rng.randn(3) * 300
        out.append(K @ np.concatenate([R, -R @ c[:, None]], 1)
                   * rng.uniform(0.2, 3) * (-1) ** i)
    return out


def test_decomposition_equals_opencv(tmp_path):
    """K and R bit for bit on 200 DTU-like matrices and on make_dtu_scene's;
    the centre t4[:3] / t4[3] to 1e-12 relative (cv2's is an SVD's)."""
    synth_data.make_dtu_scene(str(tmp_path), n_images=12)
    cam = np.load(os.path.join(str(tmp_path), "rs_dtu_4", "DTU", "scan1", "cameras.npz"))
    mats = _projections(200, 0) + [cam["world_mat_{}".format(i)][:3] for i in range(12)]
    worst = 0.0
    for P in mats:
        K, R, t = cv_ops.decompose_projection_matrix(P)
        K_cv, R_cv, t_cv = cv2.decomposeProjectionMatrix(P)[:3]
        assert np.array_equal(K, K_cv) and np.array_equal(R, R_cv)
        assert np.isclose(np.linalg.det(R), 1.0) and abs(np.linalg.norm(t) - 1) < 1e-15
        c, c_cv = t[:3, 0] / t[3, 0], t_cv[:3, 0] / t_cv[3, 0]
        worst = max(worst, np.abs(c - c_cv).max() / np.abs(c_cv).max())
    assert worst < 1e-12, worst


@pytest.mark.parametrize("size", SIZES)
def test_resize_against_default_cv2_within_the_measured_gap(size, raw_images):
    """Against cv2 with IPP on: the image within IPP_GAP, the depth equal;
    the mask pixels that ``np.floor`` keeps differently are counted (none at
    these sizes with that cv2)."""
    image, mask, depth = raw_images
    H, W = size
    with ipp(True):
        ref = cv2.resize(image, (W, H), interpolation=cv2.INTER_LINEAR)
        ref_mask = np.floor(cv2.resize(mask, (W, H), interpolation=cv2.INTER_LINEAR))
        ref_depth = cv2.resize(depth, (W, H), interpolation=cv2.INTER_NEAREST)
    gap = float(np.abs(cv_ops.resize_linear(image, (W, H)) - ref).max())
    assert gap <= IPP_GAP[size], gap
    differ = int((np.floor(cv_ops.resize_linear(mask, (W, H))) != ref_mask).sum())
    print("{}x{}: image within {:.3g} of IPP's, {} mask pixels differ".format(H, W, gap, differ))
    assert differ == 0
    assert np.array_equal(cv_ops.resize_nearest(depth, (W, H)), ref_depth)


def test_inputs_are_checked():
    with pytest.raises(ValueError, match="float32"):
        cv_ops.resize_linear(np.zeros((4, 4), np.uint8), (2, 2))
    with pytest.raises(ValueError, match="resize to"):
        cv_ops.resize_nearest(np.zeros((4, 4), np.float32), (0, 2))
    with pytest.raises(ValueError, match="3x4"):
        cv_ops.decompose_projection_matrix(np.eye(3))
    same = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = cv_ops.resize_linear(same, (4, 3))
    assert np.array_equal(out, same) and out is not same


@pytest.fixture(scope="module")
def dtu_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu_cv_ops"))
    synth_data.make_dtu_scene(root, n_images=10, H=60, W=80)
    return root


# the image's largest gap to the JAX loader under cv2's IPP (cv2 5.0.0),
# measured on make_dtu_scene's 60x80 tree read at each size (1, 2, 0 and 3
# ulps near 1)
LOADER_GAP = {(30, 40): 1.2e-7, (24, 32): 2.4e-7, (15, 20): 0.0, (45, 60): 3.6e-7}


@pytest.mark.parametrize("size", sorted(LOADER_GAP))
def test_dtu_loader_against_the_jax_loader_with_default_cv2(size, dtu_tree):
    """The port's DTU loader against the JAX package's, which runs cv2 as
    installed (IPP on), on a 60x80 tree read at 2x, 2.5x, 4x and 1.33x
    smaller: cameras, depth, validity and masks equal (no mask pixel
    differs), the image within LOADER_GAP. (With IPP off the two agree bit
    for bit: tests/test_torch_dtu.py::test_loader_matches_jax.)"""
    opt = synth_data.dtu_opt(dtu_tree, *size)
    opt.data.dtu.mask_img = True
    popt = DotDict(opt.to_plain())
    with ipp(True):
        for split in ("train", "val"):
            ref = jdtu.Dataset(opt, split=split).all_arrays(opt)
            got = get_dataset("dtu").Dataset(popt, split=split).all_arrays(popt)
            assert sorted(got) == sorted(ref) and got["image"].shape[1:3] == size
            for k in ref:
                assert got[k].dtype == ref[k].dtype, k
                if k == "image":
                    assert float(np.abs(got[k] - ref[k]).max()) <= LOADER_GAP[size]
                else:
                    assert np.array_equal(got[k], ref[k]), k


def test_write_dtu_tree_reads_back_as_the_in_memory_scene(tmp_path):
    """``scenes.write_dtu_tree`` (chip_smoke.py's DTU files, here at 12x16)
    through the port's loader: at the written size the in-memory scene's
    arrays (``blob_dtu_arrays``), but intr within 1e-14 (the decomposition's
    rounding in K's zero entries); through the JAX package's loader (IPP
    off) the same arrays bit for bit, at that size and at half of it."""
    from neural_invertible_warp_tpu_torch.evidence import scenes
    root = str(tmp_path)
    scenes.write_dtu_tree(root, n_images=9, size=(12, 16))
    memory = scenes.blob_dtu_arrays(n_images=9, img_size=(12, 16), widen=0.0)[:2]
    for size in ((12, 16), (6, 8)):
        opt = synth_data.dtu_opt(root, *size)
        popt = DotDict(opt.to_plain())
        for split, mem in zip(("train", "val"), memory):
            got = get_dataset("dtu").Dataset(popt, split=split).all_arrays(popt)
            with ipp(False):
                ref = jdtu.Dataset(opt, split=split).all_arrays(opt)
            for k in ref:
                assert np.array_equal(got[k], ref[k]), (size, split, k)
            if size == (12, 16):
                for k in mem:
                    if k == "intr":
                        assert np.abs(got[k] - mem[k]).max() < 1e-14
                    else:
                        assert np.array_equal(got[k], mem[k]), (split, k)
