"""The three OpenCV steps of the DTU loader in numpy (the card's machine has
no cv2), as OpenCV's own code computes them (not its IPP path, which cv2
takes by default where it was built with IPP: see ``resize_linear``).

* ``decompose_projection_matrix(P)``: ``cv2.decomposeProjectionMatrix``'s
  (K, R, t4) of a 3x4 camera matrix P = K [R | -R c]. K and R are
  ``RQDecomp3x3``'s, bit for bit (``_rq_decomp3x3``: Givens rotations with
  z = 1 / sqrt(c^2 + s^2); K[0,0], K[1,1] > 0, K[2,2] with the sign of
  det P[:, :3], R a rotation). t4 is the camera centre [c; 1] / |[c; 1]|,
  the unit null vector of P: cv2's comes from an SVD and may carry the
  other sign and differ in the last bits; t4[:3] / t4[3] agrees to ~1e-14
  relative.
* ``resize_linear(img, (W, H))``: ``cv2.resize(img, (W, H),
  interpolation=cv2.INTER_LINEAR)`` of float32 [H,W] or [H,W,C] (one
  channel comes back [H,W], as from cv2; imgproc/resize.cpp's ``resizeGeneric_``): source coordinate
  fx = float((dx + 0.5) * scale - 0.5) with scale = 1 / (out / in) in
  double, sx = floor(fx), weights (1 - f, f) in float32; columns before 0
  or past the last take weights (1, 0) (a copy), rows are clamped to the
  image with their weights kept; the horizontal pass first, each output
  a*w0 + b*w1 in float32 (no fused multiply-add). Where both sides shrink by
  exactly 2, OpenCV switches to INTER_AREA: each output the mean of its
  2x2 block, summed ((a + b) + c) + d and scaled by 0.25, or
  (a + b) + (c + d) where OpenCV's SIMD loop takes it (one channel: all
  but the last out_w % 4 columns; four channels: every column).
* ``resize_nearest(img, (W, H))``: ``cv2.resize(..., INTER_NEAREST)``:
  source index floor(dx * (1 / (out / in))), clamped to the last.
"""

from __future__ import annotations

import numpy as np

# float32 lanes of OpenCV's baseline SIMD registers (128-bit on x86-64 and
# ARM), the block of output columns its 2x2 area loop takes at once
_AREA_LANES = 4


def _givens(c, s):
    z = 1.0 / np.sqrt(c * c + s * s)
    return c * z, s * z


def _matmul3(a, b):
    """a @ b of 3x3 float64, each entry summed in k order (as cv::Matx)."""
    return np.array([[(a[i, 0] * b[0, j] + a[i, 1] * b[1, j]) + a[i, 2] * b[2, j]
                      for j in range(3)] for i in range(3)])


def _rq_decomp3x3(M):
    """cv2.RQDecomp3x3's (R upper triangular, Q a rotation) of 3x3 ``M``:
    Givens rotations about x, y and z in that order, then the 180-degree
    turn that makes R[0,0] and R[1,1] positive."""
    M = np.asarray(M, np.float64)
    c, s = _givens(M[2, 2], M[2, 1])
    qx = np.array([[1.0, 0, 0], [0, c, s], [0, -s, c]])
    r = _matmul3(M, qx)
    r[2, 1] = 0.0
    c, s = _givens(r[2, 2], -r[2, 0])
    qy = np.array([[c, 0, -s], [0, 1.0, 0], [s, 0, c]])
    m = _matmul3(r, qy)
    m[2, 0] = 0.0
    c, s = _givens(m[1, 1], m[1, 0])
    qz = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])
    r = _matmul3(m, qz)
    r[1, 0] = 0.0
    if r[0, 0] < 0:
        if r[1, 1] < 0:       # about z
            r[0, 0], r[0, 1], r[1, 1] = -r[0, 0], -r[0, 1], -r[1, 1]
            qz[:2, :2] = -qz[:2, :2]
        else:                 # about y
            r[0, 0], r[0, 2], r[1, 2], r[2, 2] = -r[0, 0], -r[0, 2], -r[1, 2], -r[2, 2]
            qz = qz.T.copy()
            qy[0, 0], qy[0, 2], qy[2, 0], qy[2, 2] = -qy[0, 0], -qy[0, 2], -qy[2, 0], -qy[2, 2]
    elif r[1, 1] < 0:         # about x
        r[0, 1], r[0, 2], r[1, 1], r[1, 2], r[2, 2] = (-r[0, 1], -r[0, 2], -r[1, 1], -r[1, 2],
                                                       -r[2, 2])
        qz, qy = qz.T.copy(), qy.T.copy()
        qx[1:, 1:] = -qx[1:, 1:]
    return r, _matmul3(_matmul3(qz.T, qy.T), qx.T)


def decompose_projection_matrix(P):
    """(K [3,3], R [3,3], t4 [4,1]) of the 3x4 projection matrix ``P``, in float64."""
    P = np.asarray(P, np.float64)
    if P.shape != (3, 4):
        raise ValueError("a projection matrix is 3x4, not {}".format(P.shape))
    K, R = _rq_decomp3x3(P[:, :3])
    t4 = np.append(-np.linalg.solve(P[:, :3], P[:, 3]), 1.0)
    return K, R, (t4 / np.linalg.norm(t4))[:, None]


def _check(img, size):
    img = np.asarray(img)
    if img.dtype != np.float32 or img.ndim not in (2, 3):
        raise ValueError("resize takes float32 [H,W] or [H,W,C], not {} {}".format(
            img.dtype, img.shape))
    out_w, out_h = int(size[0]), int(size[1])
    if out_w < 1 or out_h < 1:
        raise ValueError("resize to {}".format(size))
    return img, out_w, out_h


def _linear_taps(n_in, n_out, clamp_weights):
    """(sx [n_out] int, w0, w1 [n_out] float32) of OpenCV's linear taps."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(f).astype(np.int64)
    f = f - sx.astype(np.float32)
    if clamp_weights:   # the horizontal pass: a copy past either edge
        low, high = sx < 0, sx >= n_in - 1
        f = np.where(low | high, np.float32(0), f)
        sx = np.where(low, 0, np.where(high, n_in - 1, sx))
    return sx, (np.float32(1) - f).astype(np.float32), f.astype(np.float32)


def _area2(img):
    """OpenCV's 2x2 INTER_AREA of float32 [H,W,C] with even H and W."""
    a, b = img[0::2, 0::2], img[0::2, 1::2]
    c, d = img[1::2, 0::2], img[1::2, 1::2]
    out = ((a + b) + c) + d
    # OpenCV's SIMD loop: one channel in blocks of _AREA_LANES columns, four
    # channels a pixel per register (every column)
    simd = {1: (out.shape[1] // _AREA_LANES) * _AREA_LANES, 4: out.shape[1]}.get(img.shape[2], 0)
    out[:, :simd] = (a[:, :simd] + b[:, :simd]) + (c[:, :simd] + d[:, :simd])
    return out * np.float32(0.25)


def resize_linear(img, size):
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` of float32
    ``img`` without IPP; ``size`` is (W, H)."""
    img, out_w, out_h = _check(img, size)
    if (out_h, out_w) == img.shape[:2]:
        return img.copy()
    x = img[..., None] if img.ndim == 2 else img
    H, W = x.shape[:2]
    if W == 2 * out_w and H == 2 * out_h:
        out = _area2(x)
    else:
        sx, a0, a1 = _linear_taps(W, out_w, True)
        sx1 = np.minimum(sx + 1, W - 1)
        rows = x[:, sx] * a0[None, :, None] + x[:, sx1] * a1[None, :, None]
        sy, b0, b1 = _linear_taps(H, out_h, False)
        r0 = rows[np.clip(sy, 0, H - 1)]
        r1 = rows[np.clip(sy + 1, 0, H - 1)]
        out = r0 * b0[:, None, None] + r1 * b1[:, None, None]
    return out[..., 0] if out.shape[2] == 1 else out   # cv2 drops a single channel


def resize_nearest(img, size):
    """``cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)``; ``size`` is (W, H)."""
    img = np.asarray(img)
    out_w, out_h = int(size[0]), int(size[1])
    if out_w < 1 or out_h < 1:
        raise ValueError("resize to {}".format(size))
    H, W = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(out_w) * (1.0 / (out_w / W))).astype(np.int64), W - 1)
    sy = np.minimum(np.floor(np.arange(out_h) * (1.0 / (out_h / H))).astype(np.int64), H - 1)
    out = img[sy[:, None], sx[None, :]]
    return out[..., 0] if out.ndim == 3 and out.shape[2] == 1 else out
