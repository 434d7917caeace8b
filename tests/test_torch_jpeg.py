"""The port's JPEG decoder (``csrc/jpeg_decode.cpp`` through ``utils/jpeg.py``)
and its plain numpy version, held bit for bit against PIL's decode (what
the JAX package's loaders read through imageio), on files the tests make with
PIL and cv2 and on the committed fixtures of ``tests/data/jpeg``."""

import hashlib
import io
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import cv2
import imageio.v2 as imageio
import numpy as np
import PIL.Image
import pytest
import torch

from neural_invertible_warp_tpu_torch.utils import image_io, jpeg

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
with open(os.path.join(FIXTURES, "manifest.json")) as _fh:
    MANIFEST = json.load(_fh)


def content(h, w, seed, channels=3):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    phase = np.arange(channels)
    a = (128 + 70 * np.sin(xx[..., None] / 4.0 + phase) * np.cos(yy[..., None] / 6.0 - phase)
         + 40 * rng.randn(h, w, channels))
    return np.clip(a, 0, 255).astype(np.uint8)


def pil_jpeg(arr, **kw):
    buf = io.BytesIO()
    PIL.Image.fromarray(arr[..., 0] if arr.shape[2] == 1 else arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def cv2_jpeg(arr, params):
    ok, buf = cv2.imencode(".jpg", arr[..., ::-1] if arr.shape[2] == 3 else arr[..., 0], params)
    assert ok
    return buf.tobytes()


def pil_decode(data):
    return np.asarray(PIL.Image.open(io.BytesIO(data)))


def assert_both_equal_pil(data, name):
    ref = pil_decode(data)
    for fn in (jpeg.decode, jpeg.decode_plain):
        got = fn(data, name)
        assert got.dtype == np.uint8 and got.shape == ref.shape, (fn.__name__, name, got.shape)
        assert np.array_equal(got, ref), (fn.__name__, name,
                                          int(np.abs(got.astype(int) - ref).max()))


SAMPLING = {name: getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + name)
            for name in ("444", "422", "420", "440", "411")}
SIZES = [(1, 1), (2, 3), (3, 5), (8, 8), (9, 17), (16, 16), (17, 33), (37, 53), (64, 48)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_pil_sampling_modes(size, subsampling):
    """PIL's 4:4:4, 4:2:2 and 4:2:0 at qualities 50 to 100, at sizes that
    leave partial MCUs (and chroma 1 or 2 samples wide, where libjpeg
    replicates instead of its fancy upsampling)."""
    arr = content(*size, seed=subsampling)
    for q in (50, 75, 95, 100):
        assert_both_equal_pil(pil_jpeg(arr, quality=q, subsampling=subsampling),
                              "{} {} q{}".format(size, subsampling, q))


@pytest.mark.parametrize("size", SIZES)
def test_cv2_sampling_factors_and_restarts(size):
    """4:4:0 and 4:1:1 (which Pillow does not write), every sampling at
    restart intervals 1 and 3, and grayscale with restarts."""
    arr = content(*size, seed=7)
    for name, factor in SAMPLING.items():
        for rst in (0, 1, 3):
            params = [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
                      cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
            assert_both_equal_pil(cv2_jpeg(arr, params), "{} {} rst{}".format(size, name, rst))
    gray = content(*size, seed=8, channels=1)
    assert_both_equal_pil(cv2_jpeg(gray, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]), "gray rst2")


@pytest.mark.parametrize("size", SIZES)
def test_gray_optimized_tables_and_segments(size):
    """Grayscale, ``optimize=True`` Huffman tables, and EXIF (orientation 6:
    the decode stays unrotated, as PIL's array), ICC, COM and Adobe (RGB
    without conversion, ``keep_rgb``) segments."""
    arr = content(*size, seed=9)
    exif = PIL.Image.Exif()
    exif[0x0112] = 6
    files = [pil_jpeg(content(*size, seed=10, channels=1), quality=q) for q in (60, 100)]
    files += [pil_jpeg(arr, quality=85, optimize=True),
              pil_jpeg(arr, quality=90, exif=exif.tobytes()),
              pil_jpeg(arr, quality=90, icc_profile=bytes(range(256)) * 70),
              pil_jpeg(arr, quality=90, comment=b"x" * 300),
              pil_jpeg(arr, quality=90, keep_rgb=True)]
    for i, data in enumerate(files):
        assert_both_equal_pil(data, "{} case {}".format(size, i))


@pytest.mark.parametrize("seed", range(6))
def test_seeded_sweep_of_sizes_and_modes(seed):
    """Random sizes up to 70x90 at random qualities and samplings, smooth and
    noisy content (the noise drives the IDCT's range limit)."""
    rng = np.random.RandomState(100 + seed)
    for _ in range(8):
        h, w = rng.randint(1, 71), rng.randint(1, 91)
        arr = content(h, w, seed=int(rng.randint(1 << 30)))
        if rng.rand() < 0.3:
            arr = rng.randint(0, 256, arr.shape).astype(np.uint8)
        q = int(rng.choice([5, 30, 50, 75, 90, 97, 100]))
        if rng.rand() < 0.5:
            data = pil_jpeg(arr, quality=q, subsampling=int(rng.randint(3)))
        else:
            name = list(SAMPLING)[rng.randint(len(SAMPLING))]
            data = cv2_jpeg(arr, [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                  SAMPLING[name], cv2.IMWRITE_JPEG_RST_INTERVAL,
                                  int(rng.choice([0, 1, 2, 5]))])
        assert_both_equal_pil(data, "seed {} {}x{} q{}".format(seed, h, w, q))


@pytest.mark.parametrize("entry", MANIFEST, ids=[e["file"] for e in MANIFEST])
def test_committed_fixture_matches_its_manifest(entry):
    """Each fixture: PIL's decode still hashes to the manifest, and both
    decoders give those bytes; the modes not decoded raise ValueError naming
    the file and the mode."""
    path = os.path.join(FIXTURES, entry["file"])
    with open(path, "rb") as fh:
        data = fh.read()
    if "raises" in entry:
        for fn in (jpeg.decode, jpeg.decode_plain):
            with pytest.raises(ValueError) as err:
                fn(data, path)
            assert path in str(err.value) and entry["raises"] in str(err.value)
        return
    ref = pil_decode(data)
    assert list(ref.shape) == entry["shape"]
    assert hashlib.sha256(ref.tobytes()).hexdigest() == entry["sha256"]
    for fn in (jpeg.decode, jpeg.decode_plain):
        got = fn(data, path)
        assert got.shape == ref.shape and np.array_equal(got, ref), fn.__name__


def test_unsupported_modes_raise_naming_file_and_mode(tmp_path):
    """Progressive, CMYK, arithmetic-coded and 12-bit files raise through
    ``image_io.read_image`` (no PIL fallback)."""
    arr = content(20, 30, seed=11)
    base = pil_jpeg(arr, quality=90)
    sof = base.index(b"\xff\xc0")
    buf = io.BytesIO()
    PIL.Image.fromarray(arr).convert("CMYK").save(buf, "JPEG")
    cases = {"progressive (SOF2)": pil_jpeg(arr, progressive=True),
             "4-component": buf.getvalue(),
             "arithmetic-coded (SOF9)": base[:sof + 1] + b"\xc9" + base[sof + 2:],
             "12-bit samples (SOF0)": base[:sof + 4] + b"\x0c" + base[sof + 5:]}
    for mode, data in cases.items():
        path = str(tmp_path / "f.jpg")
        with open(path, "wb") as fh:
            fh.write(data)
        with pytest.raises(ValueError, match=r"f\.jpg: a .*{}".format(mode.split(" ")[0])):
            image_io.read_image(path)


def test_read_image_equals_imageio_at_llff_size(tmp_path):
    """A 3024x4032 4:2:0 frame (an LLFF raw) through ``image_io.read_image``
    equals ``imageio.imread``, the JAX loaders' read."""
    rng = np.random.RandomState(12)
    small = content(189, 252, seed=12)
    arr = np.repeat(np.repeat(small, 16, 0), 16, 1)
    arr = np.clip(arr.astype(int) + rng.randint(-20, 21, arr.shape), 0, 255).astype(np.uint8)
    path = str(tmp_path / "raw.jpg")
    PIL.Image.fromarray(arr).save(path, quality=95)
    assert np.array_equal(image_io.read_image(path), imageio.imread(path))


def test_threads_decode_in_parallel_to_the_same_bytes():
    data = [pil_jpeg(content(64, 80, seed=s), quality=80) for s in range(12)]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(jpeg.decode, data))
    for g, d in zip(got, data):
        assert np.array_equal(g, pil_decode(d))


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("int niw_jpeg_info( {\n")
    monkeypatch.setattr(jpeg, "SOURCE", str(src))
    monkeypatch.setattr(jpeg, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(jpeg, "_lib", None)
    with pytest.raises(RuntimeError, match="broken.cpp"):
        jpeg.load()
    assert not os.listdir(tmp_path / "build")


def test_the_library_is_named_by_its_source(tmp_path, monkeypatch):
    """A changed source builds a library of its own name (no stale build)."""
    src = tmp_path / "jpeg_decode.cpp"
    shutil.copy(jpeg.SOURCE, src)
    monkeypatch.setattr(jpeg, "SOURCE", str(src))
    first = jpeg.library_path()
    with open(src, "a") as fh:
        fh.write("// changed\n")
    assert jpeg.library_path() != first and jpeg.library_path().startswith(jpeg.BUILD_DIR)


def test_llff_jpeg_tree_loads_as_through_pil():
    """The committed JPEG LLFF tree (19 views at 240x320) read by the port's
    LLFF loader and by the JAX package's (imageio and PIL), resized to
    120x160: the same arrays in both splits."""
    from neural_invertible_warp_tpu.data import llff as jax_llff
    from neural_invertible_warp_tpu_torch.data import llff
    from neural_invertible_warp_tpu_torch.flagship import flagship_options
    opt = flagship_options()
    opt.data.update(root=os.path.join(FIXTURES, "llff"), scene="blobfern",
                    image_size=[120, 160], val_ratio=0.1, preload=True)
    opt.H, opt.W = 120, 160
    for split in ("train", "val"):
        got = llff.Dataset(opt, split).all_arrays(opt)
        ref = jax_llff.Dataset(opt.copy(), split).all_arrays(opt.copy())
        assert set(got) == set(ref) and len(got["image"]) == (18 if split == "train" else 1)
        for k in got:
            assert np.array_equal(got[k], ref[k]), (split, k)
