"""The port's YAML, PNG and resampling code (``utils/options_yaml.py``,
``utils/image_io.py``), which its CLI runs on the card's machine in place of
PyYAML, imageio and PIL, held against those libraries here."""

import glob
import math
import os
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import PIL.Image
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from neural_invertible_warp_tpu import config as jax_config
from neural_invertible_warp_tpu_torch import config
from neural_invertible_warp_tpu_torch.evidence import scenes
from neural_invertible_warp_tpu_torch.flagship import flagship_options
from neural_invertible_warp_tpu_torch.utils import image_io, options_yaml

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTION_FILES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "options",
                                                                          "*.yaml")))
MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def same(a, b):
    """Equal in value and in type, all the way down (NaN equal to NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


# ------------------------------------------------------------------- YAML

def test_all_option_files_are_read():
    assert len(OPTION_FILES) == 21


@pytest.mark.parametrize("name", OPTION_FILES)
def test_option_file_loads_as_pyyaml(name):
    """Each option file alone, and with its ``_parent_`` chain resolved by
    the port's ``load_options`` against the JAX package's (PyYAML)."""
    with open(os.path.join(ROOT, "options", name)) as f:
        text = f.read()
    assert same(options_yaml.load(text), yaml.safe_load(text))
    port = config.load_options("options/" + name).to_plain()
    ref = jax_config.load_options(os.path.join(ROOT, "options", name))
    assert same(port, ref.to_plain() if hasattr(ref, "to_plain") else dict(ref))


@pytest.mark.parametrize("text, value", [
    ("1e-3", "1e-3"), ("5.e-4", 5e-4), ("yes", True), ("off", False), ("~", None),
    ("", None), ("010", 8), ("0x10", 16), ("1_000", 1000), ("1:30", 90), (".inf", math.inf),
    ("[null, null]", [None, None]), ("{}", {}), ("[0.1,0.5]", [0.1, 0.5]),
    ("'a # b' # c", "a # b"), ("http://x:1", "http://x:1"), ("[-, 1]", ["-", 1])])
def test_cli_values_resolve_as_pyyaml(text, value):
    """The table of PyYAML 6's YAML 1.1 resolution the CLI depends on."""
    assert same(options_yaml.load_scalar(text), value)
    assert same(yaml.safe_load(text), value)


def test_dates_resolve_as_pyyaml():
    for text in ("2024-01-01", "2001-12-14t21:59:43.10-05:00", "2001-12-14 21:59:43.10",
                 "2002-12-14T21:59:43Z"):
        assert options_yaml.load_scalar(text) == yaml.safe_load(text)


_WORD = st.text("abcxyzAZ019_-./+", min_size=1, max_size=8)
_NUMBER = st.one_of(
    st.integers(-10 ** 6, 10 ** 6).map(str),
    st.floats(allow_nan=True, allow_infinity=True).map(repr),
    st.builds("{}{}{}.{}{}".format, st.sampled_from(["", "-", "+"]),
              st.text("0123456789_", max_size=4), st.sampled_from(["", "0", "1"]),
              st.text("0123456789_", max_size=3),
              st.sampled_from(["", "e-3", "E+10", "e5", "e"])),
    st.builds("{}0{}{}".format, st.sampled_from(["", "-", "+"]), st.sampled_from("xbo0"),
              st.text("0123456789abcdefABCDEF_", max_size=5)),
    st.builds("{}:{}".format, st.integers(0, 200), st.integers(0, 99)),
    st.sampled_from([".inf", "-.inf", "+.INF", ".nan", ".NaN", ".Inf", "1.", ".5", "-.5"]))
_WORDS = st.sampled_from(["yes", "No", "TRUE", "off", "On", "null", "Null", "~", "y", "n",
                          "none", "True", "nan", "inf", "<<", "="])
_SCALAR = st.one_of(_NUMBER, _WORDS, _WORD)
_FLOW = st.lists(_SCALAR, max_size=4).map(lambda xs: "[" + ", ".join(xs) + "]")


@settings(max_examples=400, deadline=None)
@given(st.one_of(_SCALAR, _FLOW))
def test_load_scalar_equals_pyyaml(text):
    """Numbers in every YAML 1.1 form, bools, nulls, words and flow lists:
    the same value and type as ``yaml.safe_load``, or both raise."""
    try:
        ref = yaml.safe_load(text)
    except Exception:
        with pytest.raises(ValueError):
            options_yaml.load_scalar(text)
        return
    assert same(options_yaml.load_scalar(text), ref), (text, ref)


def _long_options():
    opt = flagship_options().to_plain()
    opt["note"] = "a long string " * 12 + "ends here"
    opt["quoted"] = "it's: # not a comment " * 5
    opt["odd"] = {"s": "yes", "n": "1e-3", "e": "", "x": [1, [2, 3], [], {}],
                  "f": [1e-5, 1e17, -0.0, math.inf]}
    return opt


def test_dump_round_trips_through_pyyaml_and_load():
    """``dump`` of the flagship's options with long strings: PyYAML and
    ``load`` both read back the same dict, and PyYAML's own dump reads back
    through ``load``; the bytes are ``yaml.safe_dump``'s (indent 4)."""
    opt = _long_options()
    text = options_yaml.dump(opt)
    assert same(yaml.safe_load(text), opt)
    assert same(options_yaml.load(text), opt)
    assert text == yaml.safe_dump(opt, default_flow_style=False, indent=4)
    for width in (30, 80, 200):
        assert same(options_yaml.load(yaml.safe_dump(opt, default_flow_style=False, indent=4,
                                                     width=width)), opt)


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n    x\n", "a: >\n    x\n", "? a\n: 1\n",
    "--- 1\n--- 2\n", "a: 1\n  b: 2\n", "a: [1, 2\n", "a: 'x\n", "a:\n\t- 1\n",
    "a: b: c\n", "a: 1\n- 2\n"])
def test_outside_the_subset_raises_naming_the_line(text):
    with pytest.raises(ValueError, match="line"):
        options_yaml.load(text)


# -------------------------------------------------------------------- PNG

def _chunk(ctype, payload):
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def _encode(arr, filters, idat_parts=1, interlace=0, depth=8):
    """A PNG of uint8 ``arr`` [H,W,C] whose rows use ``filters`` in turn
    (0-4, the forward filters written out here), its data split over
    ``idat_parts`` IDAT chunks."""
    H, W, C = arr.shape
    x = arr.reshape(H, W * C).astype(np.int64)
    rows = []
    for r in range(H):
        f = filters[r % len(filters)]
        cur = x[r]
        prev = x[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(C, np.int64), cur[:-C]])
        upleft = np.concatenate([np.zeros(C, np.int64), prev[:-C]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([f]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
    comp = zlib.compress(b"".join(rows))
    step = -(-len(comp) // idat_parts)
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, interlace))
    body += b"".join(_chunk(b"IDAT", comp[i:i + step]) for i in range(0, len(comp), step))
    return image_io.PNG_SIGNATURE + body + _chunk(b"IEND", b"")


def _image(shape, seed):
    rng = np.random.RandomState(seed)
    smooth = np.add.outer(np.arange(shape[0]), 2 * np.arange(shape[1]))[..., None]
    return ((smooth * 7 + rng.randint(0, 40, shape)) % 256).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_read_png_equals_imageio_on_every_filter_and_idat_split(tmp_path, channels):
    """Rows in each of the five filters (and all in Paeth, all in Average),
    the data over 1, 3 or 7 IDAT chunks, every 8-bit colour type."""
    arr = _image((13, 17, channels), channels)
    path = str(tmp_path / "f.png")
    for filters, parts in (((0, 1, 2, 3, 4), 1), ((4,), 3), ((3,), 7), ((2, 1), 2)):
        with open(path, "wb") as f:
            f.write(_encode(arr, filters, parts))
        ref = imageio.imread(path)
        got = image_io.read_png(path)
        assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
        assert np.array_equal(got, ref)
        assert np.array_equal(got.reshape(arr.shape), arr)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P2", "P4", "P16", "P256"])
def test_read_png_equals_imageio_on_pil_and_imageio_files(tmp_path, mode):
    """Files PIL writes (its adaptive filters, palettes at 1, 2, 4 and 8
    bits) and imageio writes."""
    rng = np.random.RandomState(len(mode))
    path = str(tmp_path / "a.png")
    for shape in ((1, 1), (7, 5), (40, 61)):
        if mode.startswith("P"):
            n = int(mode[1:])
            im = PIL.Image.fromarray(rng.randint(0, n, shape).astype(np.uint8), "P")
            im.putpalette(list(rng.randint(0, 256, 3 * n)))
            writers = [lambda p: im.save(p)]
        else:
            arr = _image(shape + (len(mode),), shape[0])
            arr = arr[..., 0] if mode == "L" else arr
            writers = [lambda p: PIL.Image.fromarray(arr, mode).save(p),
                       lambda p: PIL.Image.fromarray(arr, mode).save(p, optimize=True),
                       lambda p: imageio.imwrite(p, arr)]
        for write in writers:
            write(path)
            ref = imageio.imread(path)
            got = image_io.read_png(path)
            assert got.dtype == ref.dtype and got.shape == ref.shape
            assert np.array_equal(got, ref)


@pytest.mark.parametrize("channels", [None, 1, 2, 3, 4])
def test_pil_reads_back_what_write_png_wrote(tmp_path, channels):
    shape = (23, 31) if channels is None else (23, 31, channels)
    arr = _image(shape if channels else shape + (1,), 5).reshape(shape)
    path = str(tmp_path / "w.png")
    image_io.write_png(path, arr)
    back = np.asarray(PIL.Image.open(path))
    assert np.array_equal(back.reshape(arr.shape), arr)
    assert np.array_equal(image_io.read_png(path).reshape(arr.shape), arr)


def test_unread_pngs_and_jpegs_raise(tmp_path):
    """Interlaced and 16-bit files, a bad CRC and a JPEG raise ValueError in
    ``read_png``; ``read_image`` decodes the JPEG without PIL (``utils/jpeg``)
    to what imageio gives."""
    arr = _image((6, 7, 3), 1)
    cases = {"interlaced": _encode(arr, (0,), interlace=1),
             "16bit": _encode(arr, (0,), depth=16)}
    bad = bytearray(_encode(arr, (0,)))
    bad[40] ^= 1
    cases["crc"] = bytes(bad)
    for name, data in cases.items():
        path = str(tmp_path / (name + ".png"))
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError):
            image_io.read_png(path)
    path = str(tmp_path / "photo.jpg")
    PIL.Image.fromarray(_image((16, 24, 3), 2)).save(path)
    with pytest.raises(ValueError, match="is a JPEG"):
        image_io.read_png(path)
    assert np.array_equal(image_io.read_image(path), imageio.imread(path))


# ------------------------------------------------------------- resampling

RESIZE_CASES = [((20, 30), (9, 13)), ((9, 13), (20, 30)), ((16, 16), (16, 9)),
                ((7, 40), (21, 4)), ((1, 5), (3, 2)),
                # 4032x3024 raws read at 640x480 and 400x300 (ratios 6.3, 10.08)
                ((3024 // 48, 4032 // 48), (480 // 48, 640 // 48)),
                ((3024 // 24, 4032 // 24), (300 // 24, 400 // 24))]


@pytest.mark.parametrize("method, pil", [("bicubic", PIL.Image.BICUBIC),
                                         ("bilinear", PIL.Image.BILINEAR)])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_resize_equals_pil_bit_for_bit(method, pil, channels):
    """Up and down, one axis or both, at LLFF's raw-to-trained ratios; alpha
    images with alpha 0, 1, 254 and 255 (Pillow's premultiplied round trip
    is where a float version would be off by one)."""
    rng = np.random.RandomState(channels)
    for (h, w), (oh, ow) in RESIZE_CASES:
        arr = rng.randint(0, 256, (h, w, channels)).astype(np.uint8)
        if channels in (2, 4):
            arr[..., -1] = rng.choice([0, 1, 2, 128, 254, 255], (h, w))
        arr = arr[..., 0] if channels == 1 else arr
        ref = np.asarray(PIL.Image.fromarray(arr, MODES[channels]).resize((ow, oh), pil))
        got = image_io.resize(arr, (ow, oh), method)
        assert got.shape == ref.shape and np.array_equal(got, ref), ((h, w), (oh, ow))


def test_llff_tree_loads_as_through_pil(tmp_path):
    """``scenes.write_llff_tree`` at twice the trained size, read by the
    port's LLFF loader (read_png, crop, resize) and by the JAX package's
    (imageio and PIL): the same arrays."""
    from neural_invertible_warp_tpu.data import llff as jax_llff
    from neural_invertible_warp_tpu_torch.data import llff
    scene = scenes.blob_llff_scene(n_images=6, val_ratio=0.34, backdrop=True)
    written = scenes.write_llff_tree(scene, str(tmp_path), (24, 32), name="tree")
    assert written.shape == (6, 24, 32, 3) and written.dtype == np.uint8
    opt = flagship_options()
    opt.data.update(root=str(tmp_path), scene="tree", image_size=[12, 16], val_ratio=0.34,
                    preload=False)
    opt.H, opt.W = 12, 16
    for split in ("train", "val"):
        got = llff.Dataset(opt, split).all_arrays(opt)
        ref = jax_llff.Dataset(opt.copy(), split).all_arrays(opt.copy())
        assert set(got) == set(ref)
        for k in got:
            assert np.array_equal(got[k], ref[k]), (split, k)
