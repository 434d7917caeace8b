"""PNG reading and writing and Pillow's resampling, on ``zlib`` and numpy,
and JPEG reading through ``utils/jpeg``, without PIL, imageio or cv2.

* ``read_png(path)`` (``decode_png(data)`` of bytes) -> uint8 [H,W]
  (gray) or [H,W,C] (gray+alpha, RGB, RGBA; a palette image expands to
  RGB, its ``tRNS`` alpha dropped), as
  ``imageio.imread`` gives it. Bit depth 8, and 1, 2 or 4 for a palette
  image (as PIL writes one of up to 16 colours); with
  ``expand_palette=False`` a palette image gives its indices [H,W], as
  PIL's ``Image.open`` does); every filter, any number of ``IDAT`` chunks,
  each chunk's CRC checked. An interlaced or 16-bit file, a gray image
  under 8 bits (imageio gives bools), a ``tRNS`` key colour of a gray or
  RGB image, an unknown critical chunk and a JPEG raise ``ValueError``.
* ``read_image(path)``: ``read_png``, or for a JPEG ``jpeg.read_jpeg``
  (PIL's decode, bit for bit, baseline or progressive; an arithmetic-coded
  JPEG, or another mode it does not read, raises ``ValueError`` naming the
  file and the mode).
* ``encode_png(array)`` -> the bytes of an 8-bit PNG of uint8 [H,W],
  [H,W,1], [H,W,2], [H,W,3] or [H,W,4]; each row filtered by None, Sub or
  Up, whichever gives the smallest sum of |filtered bytes| (those decode
  as cumulative sums); ``write_png(path, array)`` writes them to a file.
* ``resize(array, (W, H), "bicubic" | "bilinear")``: Pillow's
  ``Image.resize`` on uint8 L, LA, RGB and RGBA images, bit for bit
  (libImaging/Resample.c): separable, the horizontal pass first; filter
  support scaled by max(scale, 1); bicubic with a = -0.5; coefficients
  normalized in double and rounded to 22 fractional bits, the accumulator
  starting at 1 << 21; each pass clipped to uint8; LA and RGBA resized
  premultiplied by alpha (Pillow's ``La`` / ``RGBa`` round trip). A resize
  to the same size returns a copy.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_IDAT_BYTES = 1 << 20          # the most image data ``write_png`` puts in one chunk


def _chunks(data, path):
    """(type, payload) of every chunk after the signature, CRC checked."""
    pos = len(PNG_SIGNATURE)
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("{}: truncated PNG chunk".format(path))
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(payload) != length or zlib.crc32(ctype + payload) != crc:
            raise ValueError("{}: bad CRC or truncated {} chunk".format(path, ctype))
        yield ctype, payload
        pos += 12 + length
        if ctype == b"IEND":
            return
    raise ValueError("{}: no IEND chunk".format(path))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw, height, row_bytes, bpp):
    """The reconstructed bytes [height, row_bytes] of the filtered scanlines
    ``raw`` (each led by its filter type)."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, row_bytes + 1)
    ftype, filt = rows[:, 0], rows[:, 1:].reshape(height, row_bytes // bpp, bpp)
    if ftype.max(initial=0) > 4:
        raise ValueError("unknown PNG filter type {}".format(int(ftype.max())))
    units = row_bytes // bpp
    if not np.isin(ftype, (3, 4)).any():
        # None, Sub and Up: a row at a time, Sub as a cumulative sum
        out = np.empty((height, units, bpp), np.uint8)
        prev = np.zeros((units, bpp), np.int64)
        for r in range(height):
            row = filt[r].astype(np.int64)
            if ftype[r] == 1:
                row = np.cumsum(row, axis=0)
            elif ftype[r] == 2:
                row = row + prev
            prev = row & 255
            out[r] = prev
        return out.reshape(height, row_bytes)
    # Average and Paeth read the reconstructed byte to the left: an
    # anti-diagonal wavefront, each diagonal's pixels (r, u) at once
    # (they read only the two diagonals before)
    rec = np.zeros((height + 1, units + 1, bpp), np.int64)
    f = filt.astype(np.int64)
    for d in range(height + units - 1):
        r = np.arange(max(0, d - units + 1), min(height, d + 1))
        u = d - r
        a, b, c = rec[r + 1, u], rec[r, u + 1], rec[r, u]
        t = ftype[r][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[r + 1, u + 1] = (f[r, u] + pred) & 255
    return rec[1:, 1:].astype(np.uint8).reshape(height, row_bytes)


def read_png(path, expand_palette=True):
    """uint8 [H,W] or [H,W,C] of the PNG at ``path`` (see the module docstring)."""
    with open(path, "rb") as fh:
        return decode_png(fh.read(), path, expand_palette)


def decode_png(data, path="<bytes>", expand_palette=True):
    """``read_png`` of the bytes ``data``; ``path`` names them in errors."""
    if data.startswith(jpeg.SIGNATURE):
        raise ValueError("{} is a JPEG: read it with read_image".format(path))
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("{} is not a PNG".format(path))
    header, palette, trns, idat = None, None, None, []
    for ctype, payload in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(payload, np.uint8)
        elif ctype == b"IDAT":
            idat.append(payload)
        elif ctype != b"IEND" and ctype[:1].isupper():
            raise ValueError("{}: unknown critical chunk {}".format(path, ctype))
    if header is None or not idat:
        raise ValueError("{}: no IHDR or no IDAT".format(path))
    width, height, depth, ctype, compression, filter_method, interlace = header
    if ctype not in _CHANNELS or compression or filter_method:
        raise ValueError("{}: colour type {} / method {} {} outside PNG".format(
            path, ctype, compression, filter_method))
    if interlace:
        raise ValueError("{}: interlaced PNGs are not read here".format(path))
    allowed = (1, 2, 4, 8) if ctype == 3 else (8,)
    if depth not in allowed:
        raise ValueError("{}: bit depth {} is not read here (only {})".format(
            path, depth, allowed))
    if trns is not None and ctype != 3:
        raise ValueError("{}: a tRNS key colour is not read here".format(path))
    channels = _CHANNELS[ctype]
    row_bytes = (width * channels * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (row_bytes + 1):
        raise ValueError("{}: {} bytes of image data for {}x{}".format(
            path, len(raw), height, width))
    rows = _unfilter(raw, height, row_bytes, max(1, channels * depth // 8))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        rows = (bits * weights).sum(-1).astype(np.uint8)[:, :width]
    img = rows.reshape(height, width, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError("{}: a palette image without PLTE".format(path))
        idx = img[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError("{}: a palette index past PLTE".format(path))
        return palette[idx] if expand_palette else idx
    return img[..., 0] if channels == 1 else img


def read_image(path, expand_palette=True):
    """uint8 [H,W] or [H,W,C] of a PNG (``read_png``) or a JPEG (``jpeg.read_jpeg``)."""
    with open(path, "rb") as fh:
        is_jpeg = fh.read(len(jpeg.SIGNATURE)) == jpeg.SIGNATURE
    return jpeg.read_jpeg(path) if is_jpeg else read_png(path, expand_palette)


def _chunk(ctype, payload):
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def encode_png(array):
    """The bytes of uint8 ``array`` ([H,W] or [H,W,C], C 1-4) as an 8-bit PNG."""
    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        raise ValueError("encode_png takes uint8, not {}".format(arr.dtype))
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or not 1 <= arr.shape[2] <= 4:
        raise ValueError("encode_png takes [H,W] or [H,W,1-4], not {}".format(arr.shape))
    height, width, channels = arr.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    x = arr.reshape(height, width * channels).astype(np.int16)
    sub = x.copy()
    sub[:, channels:] -= x[:, :-channels]
    up = x.copy()
    up[1:] -= x[:-1]
    candidates = np.stack([x, sub & 255, up & 255]).astype(np.uint8)   # None, Sub, Up
    cost = np.abs(candidates.astype(np.int8).astype(np.int64)).sum(-1)  # [3, H]
    best = cost.argmin(0)
    rows = candidates[best, np.arange(height)]
    raw = np.concatenate([best.astype(np.uint8)[:, None], rows], axis=1).tobytes()
    comp = zlib.compress(raw, 6)
    header = struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0)
    parts = [PNG_SIGNATURE, _chunk(b"IHDR", header)]
    parts += [_chunk(b"IDAT", comp[i:i + _IDAT_BYTES])
              for i in range(0, max(len(comp), 1), _IDAT_BYTES)]
    parts.append(_chunk(b"IEND", b""))
    return b"".join(parts)


def write_png(path, array):
    """Write ``encode_png(array)`` to ``path``."""
    data = encode_png(array)
    with open(path, "wb") as fh:
        fh.write(data)


# ------------------------------------------------------------- resampling

PRECISION_BITS = 32 - 8 - 2


def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x):
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _coefficients(in_size, out_size, method):
    """(xmin [out], fixed-point taps [out, ksize] int64) of Pillow's
    ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` over the whole input."""
    fn, support = _FILTERS[method]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)   # C truncation
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = fn(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros((out_size, 1))
    for t in taps:                    # in tap order, as the C loop adds them
        ww = ww + w[:, t:t + 1]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    scaled = w * (1 << PRECISION_BITS)
    k = np.where(w < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)
    return xmin, k


def _pass(img, out_size, method, axis):
    """One 8-bit resampling pass along ``axis`` (0 rows, 1 columns) of uint8
    [H,W,C]: each output adds its ksize input taps times their fixed-point
    coefficients in int32, as Pillow's sums are (exact: they stay under 2^31)."""
    n_in = img.shape[axis]
    xmin, k = _coefficients(n_in, out_size, method)
    shape = [1, 1, 1]
    shape[axis] = out_size
    k = k.astype(np.int32).T.reshape([-1] + shape)               # [ksize, ...]
    out_shape = list(img.shape)
    out_shape[axis] = out_size
    acc = np.full(out_shape, 1 << (PRECISION_BITS - 1), np.int32)
    for t in range(k.shape[0]):         # a tap past the input has coefficient 0
        acc += np.take(img, np.minimum(xmin + t, n_in - 1), axis=axis) * k[t]
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _premultiply(img):
    alpha = img[..., -1:].astype(np.int64)
    tmp = img[..., :-1].astype(np.int64) * alpha + 128
    color = ((tmp >> 8) + tmp) >> 8
    return np.concatenate([color, alpha], -1).astype(np.uint8)


def _unpremultiply(img):
    alpha = img[..., -1:].astype(np.int64)
    color = img[..., :-1].astype(np.int64)
    keep = (alpha == 255) | (alpha == 0)
    div = np.clip((255 * color) // np.where(keep, 1, alpha), 0, 255)
    return np.concatenate([np.where(keep, color, div), alpha], -1).astype(np.uint8)


def resize(array, size, method="bicubic"):
    """Pillow's ``Image.resize(size, BICUBIC | BILINEAR)`` of uint8 [H,W] or
    [H,W,C] (C 1-4; 2 and 4 carry alpha); ``size`` is (W, H)."""
    if method not in _FILTERS:
        raise ValueError("resize method must be one of {}: {}".format(sorted(_FILTERS), method))
    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        raise ValueError("resize takes uint8, not {}".format(arr.dtype))
    out_w, out_h = int(size[0]), int(size[1])
    if out_w < 1 or out_h < 1:
        raise ValueError("resize to {}".format(size))
    if (out_h, out_w) == arr.shape[:2]:
        return arr.copy()
    img = arr[..., None] if arr.ndim == 2 else arr
    alpha = img.shape[2] in (2, 4)
    if alpha:
        img = _premultiply(img)
    if out_w != img.shape[1]:
        img = _pass(img, out_w, method, 1)
    if out_h != img.shape[0]:
        img = _pass(img, out_h, method, 0)
    if alpha:
        img = _unpremultiply(img)
    return img[..., 0] if arr.ndim == 2 else img
