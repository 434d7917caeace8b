"""2D warps: SO(2), SE(2) and SL(3) Lie maps and planar warp grids (port
of neural_invertible_warp_tpu/ops/warp2d.py, reference warp.py).

* the Taylor series of sin(x)/x and its relatives (warp.py:238-271);
* ``so2``/``se2`` exp and log (warp.py:170-226); ``sl3_to_SL3`` by the
  matrix exponential of the sl(3) generator (warp.py:228-236);
* normalized pixel grids, centre-crop grids and crop corners (warp.py:29-54);
* ``warp_grid`` for translation, rotation, rigid and homography warps
  (warp.py:67-87), and the corner range check that the planar experiment's
  perturbations are drawn against (warp.py:157-161).
"""

from __future__ import annotations

import torch


# -- Taylor series ------------------------------------------------------------

def _taylor(x, coeff_fn, nth=10):
    ans = torch.zeros_like(x)
    denom = 1.0
    for i in range(nth + 1):
        denom, term = coeff_fn(i, denom, x)
        ans = ans + term / denom
    return ans


def taylor_A(x, nth=10):  # sin(x)/x
    def f(i, denom, x):
        if i > 0:
            denom *= (2 * i) * (2 * i + 1)
        return denom, ((-1) ** i) * x ** (2 * i)
    return _taylor(x, f, nth)


def taylor_B(x, nth=10):  # (1-cos(x))/x
    def f(i, denom, x):
        denom *= (2 * i + 1) * (2 * i + 2)
        return denom, ((-1) ** i) * x ** (2 * i + 1)
    return _taylor(x, f, nth)


def taylor_C(x, nth=10):  # (x*cos(x)-sin(x))/x^2
    def f(i, denom, x):
        denom *= (2 * i + 2) * (2 * i + 3)
        return denom, ((-1) ** (i + 1)) * x ** (2 * i + 1) * (2 * i + 2)
    return _taylor(x, f, nth)


def taylor_D(x, nth=10):  # (x*sin(x)+cos(x)-1)/x^2
    def f(i, denom, x):
        denom *= (2 * i + 1) * (2 * i + 2)
        return denom, ((-1) ** i) * x ** (2 * i) * (2 * i + 1)
    return _taylor(x, f, nth)


# -- Lie groups ---------------------------------------------------------------

def _rows2(a, b, c, d):
    """[[a, b], [c, d]] of [...,1] entries -> [...,2,2]."""
    return torch.stack([torch.cat([a, b], dim=-1), torch.cat([c, d], dim=-1)], dim=-2)


def so2_to_SO2(theta):
    """[...,1] -> [...,2,2]."""
    c, s = torch.cos(theta), torch.sin(theta)
    return _rows2(c, -s, s, c)


def SO2_to_so2(R):
    return torch.atan2(R[..., 1, 0], R[..., 0, 0])[..., None]


def se2_to_SE2(delta):
    """[...,3] (u, theta) -> [...,2,3]."""
    u, theta = delta[..., :2], delta[..., 2:]
    A, B = taylor_A(theta), taylor_B(theta)
    V = _rows2(A, -B, B, A)
    return torch.cat([so2_to_SO2(theta), V @ u[..., None]], dim=-1)


def SE2_to_se2(Rt, eps=1e-7):
    R, t = Rt[..., :2], Rt[..., 2:]
    theta = SO2_to_so2(R)
    A, B = taylor_A(theta), taylor_B(theta)
    denom = (A ** 2 + B ** 2 + eps)[..., None]
    invV = _rows2(A, B, -B, A) / denom
    u = (invV @ t)[..., 0]
    return torch.cat([u, theta], dim=-1)


def sl3_to_SL3(h):
    """[...,8] -> [...,3,3] homography, the matrix exponential of the
    traceless generator."""
    h1, h2, h3, h4, h5, h6, h7, h8 = torch.split(h, 1, dim=-1)
    A = torch.stack([torch.cat([h5, h3, h1], dim=-1),
                     torch.cat([h4, -h5 - h6, h2], dim=-1),
                     torch.cat([h7, h8, h6], dim=-1)], dim=-2)
    return torch.linalg.matrix_exp(A)


# -- grids --------------------------------------------------------------------

def _grid(ys, xs, H, W, batch_size):
    m = max(H, W)
    y = ((ys.float() + 0.5) / H * 2 - 1) * (H / m)
    x = ((xs.float() + 0.5) / W * 2 - 1) * (W / m)
    Y, X = torch.meshgrid(y, x, indexing="ij")
    grid = torch.stack([X, Y], dim=-1).reshape(-1, 2)
    return grid.expand((batch_size,) + grid.shape)


def normalized_pixel_grid(H, W, batch_size=1, device=None):
    """[B,HW,2] grid in [-1,1] scaled by the aspect ratio (warp.py:29-35)."""
    return _grid(torch.arange(H, device=device), torch.arange(W, device=device), H, W,
                 batch_size)


def normalized_pixel_grid_crop(H, W, H_crop, W_crop, batch_size=1, device=None):
    """The centre crop's part of that grid, [B,H_crop W_crop,2] (warp.py:37-45)."""
    ys = torch.arange(H // 2 - H_crop // 2, H // 2 + H_crop // 2, device=device)
    xs = torch.arange(W // 2 - W_crop // 2, W // 2 + W_crop // 2, device=device)
    return _grid(ys, xs, H, W, batch_size)


def normalized_pixel_corners_crop(H, W, H_crop, W_crop, batch_size=1, device=None):
    """The crop's corners [B,4,2] (warp.py:47-54)."""
    m = max(H, W)
    y_crop = (H // 2 - H_crop // 2, H // 2 + H_crop // 2)
    x_crop = (W // 2 - W_crop // 2, W // 2 + W_crop // 2)
    Y = [((y + 0.5) / H * 2 - 1) * (H / m) for y in y_crop]
    X = [((x + 0.5) / W * 2 - 1) * (W / m) for x in x_crop]
    corners = torch.tensor([(X[0], Y[0]), (X[0], Y[1]), (X[1], Y[1]), (X[1], Y[0])],
                           dtype=torch.float32, device=device)
    return corners.expand(batch_size, 4, 2)


# -- warping ------------------------------------------------------------------

def _to_hom(X):
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def warp_grid(xy_grid, warp, warp_type="homography"):
    """A parametric 2D warp of [B,N,2] points (warp.py:67-87)."""
    if warp_type == "translation":
        return xy_grid + warp[..., None, :]
    if warp_type == "rotation":
        return xy_grid @ so2_to_SO2(warp).transpose(-1, -2)
    if warp_type == "rigid":
        return _to_hom(xy_grid) @ se2_to_SE2(warp).transpose(-1, -2)
    if warp_type == "homography":
        warped = _to_hom(xy_grid) @ sl3_to_SL3(warp).transpose(-1, -2)
        return warped[..., :2] / (warped[..., 2:] + 1e-8)
    raise ValueError(warp_type)


def warp_corners(warp, H, W, H_crop, W_crop, warp_type="homography"):
    corners = normalized_pixel_corners_crop(H, W, H_crop, W_crop,
                                            batch_size=warp.shape[0], device=warp.device)
    return warp_grid(corners, warp, warp_type)


def check_corners_in_range(warp, H, W, H_crop, W_crop, warp_type="homography"):
    """True when every warped crop corner stays inside the image (warp.py:157-161)."""
    corners = warp_corners(warp, H, W, H_crop, W_crop, warp_type)
    m = max(H, W)
    X = (corners[..., 0] / W * m + 1) / 2 * W - 0.5
    Y = (corners[..., 1] / H * m + 1) / 2 * H - 0.5
    return bool(torch.all((0 <= X) & (X < W) & (0 <= Y) & (Y < H)))
