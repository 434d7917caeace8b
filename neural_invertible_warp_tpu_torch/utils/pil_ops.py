"""Pillow's colour enhancements, HSV conversion, mirror and bicubic rotation
on uint8 numpy arrays, bit for bit (Pillow 12.1.0): the operations of the
``data.augment`` branch (``data/base.py``), which the card's machine runs
without PIL.

* ``blend(a, b, alpha)``: ``Image.blend`` (libImaging/Blend.c). ``alpha`` is
  rounded to float32; 0 and 1 copy an input; inside [0, 1] each byte is
  ``a + alpha * (b - a)`` in float32, truncated; outside it the same sum
  is clipped to [0, 255], then truncated.
* ``enhance_brightness`` / ``enhance_contrast`` / ``enhance_color`` of
  uint8 [H,W,3]: ``ImageEnhance.Brightness / Contrast / Color(im).enhance``,
  each ``blend(degenerate, image, factor)``. Brightness's degenerate is
  black; contrast's is grey at ``int(mean + 0.5)`` of ``to_luma``
  (``ImageStat``'s mean: the histogram's sum over the pixel count, in
  double); colour's is ``to_luma`` repeated in the three channels.
* ``to_luma``: ``convert("L")``, ITU-R 601-2 in 16-bit fixed point,
  ``(r*19595 + g*38470 + b*7471 + 0x8000) >> 16`` (Convert.c's ``L24``).
* ``rgb_to_hsv`` / ``hsv_to_rgb``: ``convert("HSV")`` and back
  (Convert.c's ``rgb2hsv_row`` and ``hsv2rgb``, which mix float32
  variables with double constants; the mix is kept here as it is there).
* ``shift_hue(rgb, hue)``: the jitter's hue step, ``h.point(lambda x: (x +
  int(hue * 255)) % 256)`` between the two conversions.
* ``flip_lr``: ``transpose(FLIP_LEFT_RIGHT)``.
* ``rotate_bicubic(image, angle)``: ``Image.rotate(angle,
  resample=BICUBIC)`` of uint8 [H,W,3] or [H,W,4]: multiples of 180
  degrees (and of 90 for a square image) as transposes; otherwise
  Image.py's inverse matrix (cos and sin rounded to 15 places, centred at
  ``(w/2, h/2)``) applied at each output pixel's centre, and Geometry.c's
  affine bicubic filter (a = -1 cubic convolution in double, rows then
  columns, taps clipped to the image, a source point outside the image
  filled with 0, the result clipped and truncated). RGBA goes through
  premultiplied RGBa and back, as ``Image.transform`` does.
"""

from __future__ import annotations

import math

import numpy as np

from .image_io import _premultiply, _unpremultiply

ROWS = 128     # output rows per block of the per-pixel float work (host memory)


def _rgb(image, what):
    arr = np.asarray(image)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError("{} takes uint8 [H,W,3], not {} {}".format(what, arr.dtype, arr.shape))
    return arr


def blend(image1, image2, alpha):
    """``Image.blend(image1, image2, alpha)`` of two uint8 arrays of one shape."""
    a, b = np.asarray(image1), np.asarray(image2)
    alpha = np.float32(alpha)
    if alpha == 0:
        return a.copy()
    if alpha == 1:
        return b.copy()
    a32 = a.astype(np.float32)
    out = a32 + alpha * (b.astype(np.float32) - a32)
    if not 0 <= alpha <= 1:
        out = np.clip(out, 0, 255)
    return out.astype(np.uint8)


def to_luma(rgb):
    """``convert("L")`` of uint8 [H,W,3]: uint8 [H,W]."""
    x = _rgb(rgb, "to_luma").astype(np.int32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16
            ).astype(np.uint8)


def enhance_brightness(rgb, factor):
    """``ImageEnhance.Brightness(im).enhance(factor)``."""
    rgb = _rgb(rgb, "enhance_brightness")
    return blend(np.zeros_like(rgb), rgb, factor)


def enhance_contrast(rgb, factor):
    """``ImageEnhance.Contrast(im).enhance(factor)``."""
    rgb = _rgb(rgb, "enhance_contrast")
    hist = np.bincount(to_luma(rgb).ravel(), minlength=256)
    total = 0.0
    for level in range(256):         # ImageStat's sum, in its order
        total += level * int(hist[level])
    count = rgb.shape[0] * rgb.shape[1]
    mean = int((total / count if count else 0) + 0.5)
    return blend(np.full_like(rgb, mean), rgb, factor)


def enhance_color(rgb, factor):
    """``ImageEnhance.Color(im).enhance(factor)``."""
    rgb = _rgb(rgb, "enhance_color")
    return blend(np.repeat(to_luma(rgb)[..., None], 3, axis=2), rgb, factor)


def rgb_to_hsv(rgb):
    """``convert("HSV")`` of uint8 [H,W,3]."""
    x = _rgb(rgb, "rgb_to_hsv").astype(np.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc, minc = x.max(-1), x.min(-1)
    grey = maxc == minc
    f32 = np.float32
    with np.errstate(divide="ignore", invalid="ignore"):
        cr = (maxc - minc).astype(f32)
        s = cr / maxc.astype(f32)
        rc = (maxc - r).astype(f32) / cr
        gc = (maxc - g).astype(f32) / cr
        bc = (maxc - b).astype(f32) / cr
        # float h = bc - gc (float), or a double sum stored to float
        h = np.where(r == maxc, bc - gc,
                     np.where(g == maxc, (2.0 + rc.astype(np.float64) - bc).astype(f32),
                              (4.0 + gc.astype(np.float64) - rc).astype(f32)))
        h = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(f32)
        uh = np.clip((h.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
        us = np.clip((s.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    uh = np.where(grey, 0, uh)
    us = np.where(grey, 0, us)
    return np.stack([uh, us, maxc], -1).astype(np.uint8)


def _c_round(x):
    """C's ``round`` (half away from zero) of non-negative doubles."""
    fl = np.floor(x)
    return np.where(x - fl >= 0.5, fl + 1, fl)


def hsv_to_rgb(hsv):
    """``convert("RGB")`` of an HSV image, uint8 [H,W,3]."""
    x = _rgb(hsv, "hsv_to_rgb").astype(np.int64)
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    f32, f64 = np.float32, np.float64
    sixth = h.astype(f64) * 6.0 / 255.0
    i = np.floor(sixth).astype(np.int64)
    f = (sixth - i.astype(f64)).astype(f32)
    fs = (s.astype(f64) / 255.0).astype(f32)
    vd = v.astype(f64)
    p = np.clip(_c_round(vd * (1.0 - fs.astype(f64))), 0, 255).astype(np.int64)
    q = np.clip(_c_round(vd * (1.0 - (fs * f).astype(f64))), 0, 255).astype(np.int64)
    t = np.clip(_c_round(vd * (1.0 - fs.astype(f64) * (1.0 - f.astype(f64)))), 0,
                255).astype(np.int64)
    sector = i % 6
    choices = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = [np.select([sector == k for k in range(6)], [c[ch] for c in choices])
           for ch in range(3)]
    out = np.stack(out, -1)
    out = np.where((s == 0)[..., None], v[..., None], out)
    return out.astype(np.uint8)


def shift_hue(rgb, hue):
    """The hue step of the colour jitter: to HSV, ``(h + int(hue * 255)) % 256``, back."""
    rgb = _rgb(rgb, "shift_hue")
    out = np.empty_like(rgb)
    for r0 in range(0, rgb.shape[0], ROWS):     # per pixel: row blocks bound the temporaries
        hsv = rgb_to_hsv(rgb[r0:r0 + ROWS])
        hsv[..., 0] = (hsv[..., 0].astype(np.int64) + int(hue * 255)) % 256
        out[r0:r0 + ROWS] = hsv_to_rgb(hsv)
    return out


def flip_lr(image):
    """``transpose(FLIP_LEFT_RIGHT)``."""
    return np.ascontiguousarray(np.asarray(image)[:, ::-1])


def _rotation_matrix(angle, w, h):
    """Image.rotate's inverse affine matrix (a, b, c, d, e, f) for ``angle`` degrees."""
    cx, cy = w / 2, h / 2
    rad = -math.radians(angle)
    a, b = round(math.cos(rad), 15), round(math.sin(rad), 15)
    d, e = round(-math.sin(rad), 15), round(math.cos(rad), 15)
    c = a * -cx + b * -cy + 0.0
    f = d * -cx + e * -cy + 0.0
    return a, b, c + cx, d, e, f + cy


def _cubic(v1, v2, v3, v4, d):
    """Geometry.c's BICUBIC macro, in its order of operations."""
    p1 = v2
    p2 = -v1 + v3
    p3 = 2 * (v1 - v2) + v3 - v4
    p4 = -v1 + v2 - v3 + v4
    return p1 + d * (p2 + d * (p3 + d * p4))


def _affine_bicubic(img, matrix):
    """Geometry.c's affine transform with the bicubic filter of uint8 [H,W,C],
    ROWS output rows at a time."""
    return np.concatenate([_affine_bicubic_rows(img, matrix, r0, min(r0 + ROWS, img.shape[0]))
                           for r0 in range(0, img.shape[0], ROWS)])


def _affine_bicubic_rows(img, matrix, r0, r1):
    H, W, _ = img.shape
    a, b, c, d, e, f = matrix
    yin, xin = np.mgrid[r0:r1, :W].astype(np.float64) + 0.5
    xx = a * xin + b * yin + c
    yy = d * xin + e * yin + f
    inside = (xx >= 0.0) & (xx < W) & (yy >= 0.0) & (yy < H)
    xx, yy = xx - 0.5, yy - 0.5
    x0, y0 = np.floor(xx), np.floor(yy)
    dx, dy = (xx - x0)[..., None], (yy - y0)[..., None]
    x0 = x0.astype(np.int64) - 1
    y0 = y0.astype(np.int64) - 1
    src = img.astype(np.float64)     # the taps' int sums are exact in double
    cols = [np.clip(x0 + k, 0, W - 1) for k in range(4)]
    rows = [_cubic(*[src[np.clip(y0 + k, 0, H - 1), cx] for cx in cols], dx)
            for k in range(4)]
    v = _cubic(*rows, dy)
    out = np.where(v <= 0.0, 0, np.where(v >= 255.0, 255, v)).astype(np.uint8)
    out[~inside] = 0
    return out


def rotate_bicubic(image, angle):
    """``Image.rotate(angle, resample=BICUBIC)`` of uint8 [H,W,3] or [H,W,4]."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError("rotate_bicubic takes uint8 [H,W,3] or [H,W,4], not {} {}".format(
            img.dtype, img.shape))
    H, W, _ = img.shape
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270) and W == H:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    matrix = _rotation_matrix(angle, W, H)
    if img.shape[2] == 4:
        return _unpremultiply(_affine_bicubic(_premultiply(img), matrix))
    return _affine_bicubic(img, matrix)
