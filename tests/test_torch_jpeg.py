"""The port's JPEG decoder (``csrc/jpeg_decode.cpp`` through ``utils/jpeg.py``)
and its plain numpy version, held bit for bit against PIL's decode (what
the JAX package's loaders read through imageio), on files the tests make with
PIL and cv2 and on the committed fixtures of ``tests/data/jpeg``."""

import hashlib
import io
import json
import os
import re
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


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_progressive_pil_sampling_modes(size, subsampling):
    """PIL's progressive files (libjpeg's standard scan script: DC first
    and refine, spectral selection and successive approximation, EOB runs,
    correction bits) at every sampling, with and without optimized
    tables."""
    arr = content(*size, seed=size[0] * 100 + size[1] + subsampling)
    for q, optimize in ((75, False), (92, True)):
        data = pil_jpeg(arr, quality=q, subsampling=subsampling, progressive=True,
                        optimize=optimize)
        assert_both_equal_pil(data, "{} sub {} q{}".format(size, subsampling, q))


@pytest.mark.parametrize("size", SIZES)
def test_progressive_gray_and_cv2_restarts(size):
    """Gray progressive files (the one-component script), and cv2's
    progressive files with restart intervals (the EOB runs and DC
    predictions restart with them) at every sampling factor."""
    files = [pil_jpeg(content(*size, seed=3, channels=1), quality=q, progressive=True,
                      optimize=opt) for q, opt in ((60, False), (95, True))]
    for i, name in enumerate(SAMPLING):
        arr = content(*size, seed=40 + i)
        files.append(cv2_jpeg(arr, [cv2.IMWRITE_JPEG_QUALITY, 70 + 5 * i,
                                    cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[name],
                                    cv2.IMWRITE_JPEG_RST_INTERVAL, i % 4]))
    files.append(cv2_jpeg(content(*size, seed=9, channels=1), [
        cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
        cv2.IMWRITE_JPEG_RST_INTERVAL, 1]))
    for i, data in enumerate(files):
        assert_both_equal_pil(data, "{} case {}".format(size, i))


@pytest.mark.parametrize("seed", range(4))
def test_seeded_progressive_sweep(seed):
    """Random sizes up to 70x90, qualities, samplings and restart intervals
    of progressive files from PIL and cv2, smooth and noisy content."""
    rng = np.random.RandomState(200 + seed)
    for _ in range(8):
        h, w = rng.randint(1, 71), rng.randint(1, 91)
        channels = 1 if rng.rand() < 0.2 else 3
        arr = content(h, w, seed=int(rng.randint(1 << 30)), channels=channels)
        if rng.rand() < 0.3:
            arr = rng.randint(0, 256, arr.shape).astype(np.uint8)
        q = int(rng.choice([5, 30, 50, 75, 90, 97, 100]))
        if rng.rand() < 0.5:
            kw = dict(quality=q, progressive=True, optimize=bool(rng.rand() < 0.5))
            if channels == 3:
                kw["subsampling"] = int(rng.randint(3))
            data = pil_jpeg(arr, **kw)
        else:
            params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                      cv2.IMWRITE_JPEG_RST_INTERVAL, int(rng.choice([0, 1, 2, 5]))]
            if channels == 3:
                name = list(SAMPLING)[rng.randint(len(SAMPLING))]
                params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[name]]
            data = cv2_jpeg(arr, params)
        assert_both_equal_pil(data, "seed {} {}x{}x{} q{}".format(seed, h, w, channels, q))


def _scans(data):
    """(the bytes before the first DHT / SOS of ``data``, [each scan with the
    DHT segments before it], the bytes from EOI on) of a progressive file."""
    i = data.index(b"\xff\xc2")
    i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    head, scans, cur = data[:i], [], b""
    while data[i:i + 2] != b"\xff\xd9":
        marker = data[i + 1]
        j = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
        if marker == 0xDA:   # the entropy-coded data runs to the next marker
            while not (data[j] == 0xFF and data[j + 1] not in (0x00,) and
                       not 0xD0 <= data[j + 1] <= 0xD7):
                j += 1
            scans.append(cur + data[i:j])
            cur = b""
        else:
            cur += data[i:j]
        i = j
    return head, scans, data[i:]


def test_progressive_scans_reordered_and_cut():
    """Scans of a PIL progressive file put in another order that the spec
    allows (the chroma AC scans before the luma ones, each refinement right
    after its band) decode as PIL decodes them; with the last refinement
    cut, libjpeg smooths the blocks (PIL's decode differs from the
    unsmoothed one) and both decoders refuse the file, naming the mode."""
    arr = content(37, 53, seed=5)
    data = pil_jpeg(arr, quality=90, subsampling=2, progressive=True, optimize=True)
    head, scans, tail = _scans(data)
    assert len(scans) == 10
    # libjpeg's script: DC 0-2 first, Y 1-5, Cr 1-63, Cb 1-63, Y 6-63, Y 1-63
    # refine, DC refine, Cr, Cb, Y refine
    for order in ([0, 2, 3, 8, 7, 1, 4, 5, 9, 6], [0, 6, 3, 2, 1, 4, 5, 9, 8, 7]):
        reordered = head + b"".join(scans[k] for k in order) + tail
        assert_both_equal_pil(reordered, "order {}".format(order))
    cut = head + b"".join(scans[:-1]) + tail
    for fn in (jpeg.decode, jpeg.decode_plain):
        with pytest.raises(ValueError, match=r"cut\.jpg: a block-smoothed progressive"):
            fn(cut, "cut.jpg")


def _coefficients(rng, shape):
    """Seeded quantized coefficients [rows, cols, 64]: DC spread, AC sparse
    and smaller at high frequencies (so EOB runs and long zero runs come)."""
    coef = np.zeros(shape + (64,), np.int64)
    coef[..., 0] = rng.randint(-70, 71, shape)
    keep = rng.rand(*shape, 64) < 0.7 * np.exp(-np.arange(64) / 9.0)
    coef[..., 1:] = (rng.laplace(0, 7, shape + (64,)) * keep).astype(np.int64)[..., 1:]
    return coef


def _random_script(rng, nc, smoothed):
    """A valid random scan script for ``nc`` components: DC interleaved or
    per component, AC bands cut anywhere, each first sent at a random bit
    then refined bit by bit; the refinements run to bit 0 except, at
    random, DC's and those of bands past coefficient 9 (libjpeg smooths
    nothing then); with ``smoothed``, one band inside 1-9 stops early.
    The first DC scans lead; the other scans of the components and bands
    are interleaved at random in their own order."""
    comps = tuple(range(nc))
    tracks, head = [], []
    for group in ([comps] if nc > 1 and rng.rand() < 0.5 else [(c,) for c in comps]):
        a0 = int(rng.randint(0, 4))
        stop = 0 if rng.rand() < 0.7 else int(rng.randint(0, a0 + 1))
        head.append((group, 0, 0, 0, a0))
        tracks.append([(group, 0, 0, al + 1, al) for al in range(a0 - 1, stop - 1, -1)])
    stopped = int(rng.randint(nc)) if smoothed else -1
    for c in comps:
        cuts = sorted(rng.choice(np.arange(2, 64), int(rng.randint(0, 5)), replace=False))
        bands = list(zip([1] + list(cuts), list(np.array(cuts) - 1) + [63]))
        for i, (lo, hi) in enumerate(bands):
            a0 = int(rng.randint(0, 4))
            stop = int(rng.randint(0, a0 + 1)) if lo >= 10 and rng.rand() < 0.4 else 0
            if c == stopped and i == 0:
                a0, stop = max(a0, 1), max(a0, 1)
            tracks.append([((c,), int(lo), int(hi), 0, a0)] + [
                ((c,), int(lo), int(hi), al + 1, al) for al in range(a0 - 1, stop - 1, -1)])
    script = list(head)
    while any(tracks):
        track = [t for t in tracks if t][rng.randint(sum(1 for t in tracks if t))]
        script.append(track.pop(0))
    return script


@pytest.mark.parametrize("seed", range(10))
def test_any_scan_script(seed):
    """Files of ``tests/jpeg_scan_writer.py`` (libjpeg's progressive
    encoder, flat Huffman tables) on seeded coefficients, sizes, samplings,
    restart intervals and random scan scripts: both decoders give PIL's
    decode; where a band inside AC 1-9 was left unrefined (seeds 8 and 9)
    libjpeg would smooth, and both refuse, naming the mode."""
    from jpeg_scan_writer import blocks, progressive_jpeg
    rng = np.random.RandomState(300 + seed)
    nc = 1 if seed % 4 == 0 else 3
    sampling = [(1, 1)] * nc
    if nc == 3:
        sampling[0] = (int(rng.randint(1, 3)), int(rng.randint(1, 3)))
    size = (int(rng.randint(1, 45)), int(rng.randint(1, 60)))
    coef = [_coefficients(rng, shape) for shape in blocks(size, sampling)]
    smoothed = seed >= 8
    script = _random_script(rng, nc, smoothed)
    data = progressive_jpeg(size, coef, sampling, rng.randint(1, 24, 64), script,
                            restart=int(rng.choice([0, 0, 1, 2, 5])))
    name = "seed {} {} {} scans".format(seed, size, len(script))
    if not smoothed:
        assert_both_equal_pil(data, name)
        return
    for fn in (jpeg.decode, jpeg.decode_plain):
        with pytest.raises(ValueError, match="block-smoothed progressive"):
            fn(data, name)


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
    """A progressive file libjpeg would block-smooth (its last refinement
    cut), CMYK, 2-component, arithmetic-coded, lossless, hierarchical and
    12-bit files raise through ``image_io.read_image`` (no PIL fallback)."""
    arr = content(20, 30, seed=11)
    base = pil_jpeg(arr, quality=90)
    sof = base.index(b"\xff\xc0")
    buf = io.BytesIO()
    PIL.Image.fromarray(arr).convert("CMYK").save(buf, "JPEG")
    prog = pil_jpeg(arr, progressive=True)
    cases = {"block-smoothed progressive (SOF2": prog[:prog.rindex(b"\xff\xda")] + b"\xff\xd9",
             "4-component": buf.getvalue(),
             "2-component": (base[:sof + 2] + b"\x00\x0e" + base[sof + 4:sof + 9] + b"\x02"
                             + base[sof + 10:sof + 16] + base[sof + 19:]),
             "arithmetic-coded (SOF9)": base[:sof + 1] + b"\xc9" + base[sof + 2:],
             "lossless (SOF3)": base[:sof + 1] + b"\xc3" + base[sof + 2:],
             "hierarchical (SOF5)": base[:sof + 1] + b"\xc5" + base[sof + 2:],
             "12-bit samples (SOF0)": base[:sof + 4] + b"\x0c" + base[sof + 5:]}
    for mode, data in cases.items():
        path = str(tmp_path / "f.jpg")
        with open(path, "wb") as fh:
            fh.write(data)
        with pytest.raises(ValueError, match=r"f\.jpg: a {}".format(re.escape(mode))):
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
