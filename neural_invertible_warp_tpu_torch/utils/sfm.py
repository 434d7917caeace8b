"""Incremental structure-from-motion with known intrinsics (host numpy and
scipy; port of neural_invertible_warp_tpu/utils/sfm.py, a copy apart from
``bundle_adjust``, which is torch autograd here in place of a jitted JAX
loop with optax).

In-process replacement for the reference's pycolmap triangulation backend
(reference utils/colmap_initialization/sfm.py:337-406 and
reconstruction_know_intrinsics_for_hloc.py:1-148): the reference dumps images
to disk, runs hloc + pycolmap as an external C++ process, and reads poses
back from images.bin. Here the same capability is an in-process pipeline —
matcher-agnostic correspondences -> track graph -> essential-matrix seed ->
DLT triangulation -> PnP registration -> bundle adjustment (a numpy
Levenberg-Marquardt solver with a Schur complement, ``lm_bundle_adjust``).

Conventions: poses are [3,4] w2c ([R|t], x_cam = R @ x_world + t), matching
the rest of the framework (ops/pose.py). Intrinsics are [3,3]. All geometry
below operates on NORMALIZED camera coordinates (pixels premultiplied by
K^-1); reprojection thresholds are therefore in normalized units
(≈ pixels / focal).
"""

from __future__ import annotations

import contextlib
import functools
import time

import numpy as np

from . import log


# ---------------------------------------------------------------------------
# stage clock: host seconds per stage of the pipeline
# ---------------------------------------------------------------------------

_clock = None       # {stage: [seconds of each entry]} inside stage_seconds()
_nested = []        # per open stage, the seconds of the stages nested in it


@contextlib.contextmanager
def stage_seconds():
    """Within the block, the host seconds of every entry into each stage of
    the pipeline (``stage``) are kept in the dict it yields, {name:
    [seconds]}. A stage's seconds leave out those of the stages nested in
    it, so the sums add up to the time spent in all of them. Stages:
    matching (one entry per matcher call, whose matches reach the host),
    verify_and_track, incremental (seed choice and PnP registration), global
    (pair poses and the camera graph), rotation_averaging, center_init
    (known_rotation_init), triangulation and bundle_adjustment."""
    global _clock
    saved, _clock = _clock, {}
    try:
        yield _clock
    finally:
        _clock = saved


@contextlib.contextmanager
def stage(name):
    """Counts the block's host seconds under ``name`` inside
    ``stage_seconds``; does nothing outside it."""
    if _clock is None:
        yield
        return
    clock = _clock
    _nested.append(0.0)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        clock.setdefault(name, []).append(dt - _nested.pop())
        if _nested:
            _nested[-1] += dt


def _staged(name):
    """Decorator: every call of the function is one entry of stage ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with stage(name):
                return fn(*args, **kwargs)
        return call
    return wrap


# ---------------------------------------------------------------------------
# basic geometry (host, float64)
# ---------------------------------------------------------------------------

def normalize_pixels(kp, K):
    """[N,2] pixels -> normalized camera coords via K^-1."""
    kp = np.asarray(kp, np.float64)
    Kinv = np.linalg.inv(np.asarray(K, np.float64))
    h = np.concatenate([kp, np.ones_like(kp[:, :1])], axis=1)
    x = h @ Kinv.T
    return x[:, :2] / x[:, 2:]


def eight_point_essential(x1, x2):
    """Essential matrix from >=8 normalized correspondences (8-point +
    rank/singular-value projection). x1,x2: [N,2]."""
    N = x1.shape[0]
    A = np.empty((N, 9))
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    # x2^T E x1 = 0, E raveled row-major
    A[:, 0] = u2 * u1
    A[:, 1] = u2 * v1
    A[:, 2] = u2
    A[:, 3] = v2 * u1
    A[:, 4] = v2 * v1
    A[:, 5] = v2
    A[:, 6] = u1
    A[:, 7] = v1
    A[:, 8] = 1.0
    _, _, Vt = np.linalg.svd(A, full_matrices=False)
    E = Vt[-1].reshape(3, 3)
    U, _, Vt = np.linalg.svd(E)
    return U @ np.diag([1.0, 1.0, 0.0]) @ Vt


def sampson_distance(E, x1, x2):
    """First-order epipolar distance per correspondence (normalized units)."""
    h1 = np.concatenate([x1, np.ones_like(x1[:, :1])], axis=1)
    h2 = np.concatenate([x2, np.ones_like(x2[:, :1])], axis=1)
    Ex1 = h1 @ E.T          # [N,3]
    Etx2 = h2 @ E           # [N,3]
    num = np.sum(h2 * Ex1, axis=1) ** 2
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return num / np.maximum(den, 1e-12)


def ransac_essential(x1, x2, thresh=2e-3, iters=500, seed=0):
    """RANSAC 8-point essential. Returns (E, inlier_mask) or (None, None)."""
    N = x1.shape[0]
    if N < 8:
        return None, None
    rng = np.random.RandomState(seed)
    best_E, best_inl = None, None
    best_n = 0
    for _ in range(iters):
        idx = rng.choice(N, 8, replace=False)
        try:
            E = eight_point_essential(x1[idx], x2[idx])
        except np.linalg.LinAlgError:
            continue
        inl = sampson_distance(E, x1, x2) < thresh ** 2
        n = int(inl.sum())
        if n > best_n:
            best_n, best_E, best_inl = n, E, inl
    if best_E is None or best_n < 8:
        return None, None
    # refit on inliers
    E = eight_point_essential(x1[best_inl], x2[best_inl])
    inl = sampson_distance(E, x1, x2) < thresh ** 2
    return E, inl


def ransac_homography(x1, x2, thresh=2e-3, iters=300, seed=0):
    """RANSAC 4-point homography (normalized coords, symmetric transfer
    error). Used only as a DEGENERACY TEST: an essential matrix estimated
    from (near-)coplanar correspondences is ill-determined (a one-parameter
    family fits), so seed pairs whose matches a homography explains are
    rejected (COLMAP's E-vs-H model selection, simplified)."""
    N = x1.shape[0]
    if N < 4:
        return None, None
    h1 = np.concatenate([x1, np.ones((N, 1))], axis=1)
    h2 = np.concatenate([x2, np.ones((N, 1))], axis=1)

    def fit(idx):
        A = []
        for k in idx:
            x, y = x1[k]
            u, v = x2[k]
            A.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
            A.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
        _, _, Vt = np.linalg.svd(np.asarray(A))
        return Vt[-1].reshape(3, 3)

    def sym_err(Hm):
        p2 = h1 @ Hm.T
        e_fwd = np.linalg.norm(p2[:, :2] / np.where(
            np.abs(p2[:, 2:]) < 1e-12, 1e-12, p2[:, 2:]) - x2, axis=1)
        try:
            Hi = np.linalg.inv(Hm)
        except np.linalg.LinAlgError:
            return np.full(N, np.inf)
        p1 = h2 @ Hi.T
        e_bwd = np.linalg.norm(p1[:, :2] / np.where(
            np.abs(p1[:, 2:]) < 1e-12, 1e-12, p1[:, 2:]) - x1, axis=1)
        return np.maximum(e_fwd, e_bwd)

    rng = np.random.RandomState(seed)
    best_H, best_inl, best_n = None, None, 0
    for _ in range(iters):
        idx = rng.choice(N, 4, replace=False)
        try:
            Hm = fit(idx)
        except np.linalg.LinAlgError:
            continue
        inl = sym_err(Hm) < thresh
        n = int(inl.sum())
        if n > best_n:
            best_n, best_H, best_inl = n, Hm, inl
    return best_H, best_inl


def triangulate(P1, P2, x1, x2):
    """DLT triangulation. P: [3,4] w2c (normalized projection), x: [N,2]
    normalized. Returns [N,3] world points."""
    N = x1.shape[0]
    X = np.empty((N, 3))
    for k in range(N):
        A = np.stack([
            x1[k, 0] * P1[2] - P1[0],
            x1[k, 1] * P1[2] - P1[1],
            x2[k, 0] * P2[2] - P2[0],
            x2[k, 1] * P2[2] - P2[1],
        ])
        _, _, Vt = np.linalg.svd(A)
        Xh = Vt[-1]
        X[k] = Xh[:3] / Xh[3]
    return X


def triangulate_multiview(Ps, xs):
    """Multi-view DLT: one world point from M >= 2 views.

    Ps: [M,3,4] w2c normalized projections; xs: [M,2] normalized obs.
    Returns [3] point. On a thin-baseline arc the two-view pair choice
    dominates accuracy (adjacent registered cameras triangulate depth
    1/sin(angle)-badly); stacking every registered view conditions the
    solve on the WIDEST available baseline automatically.
    """
    rows = []
    for m in range(Ps.shape[0]):
        rows.append(xs[m, 0] * Ps[m, 2] - Ps[m, 0])
        rows.append(xs[m, 1] * Ps[m, 2] - Ps[m, 1])
    _, _, Vt = np.linalg.svd(np.stack(rows))
    Xh = Vt[-1]
    return Xh[:3] / (Xh[3] if abs(Xh[3]) > 1e-12 else 1e-12)


def triangulate_track_robust(Ps, xs, ths, err_mult=2.0):
    """Robust triangulation of ONE track over M >= 2 registered views:
    RANSAC over view PAIRS (COLMAP's estimate_triangulation). A track can
    carry wrong observations (a verified-but-wrong match link); plain
    multiview DLT fits all of them at once and the poisoned point then
    fails every observation. Here each view pair proposes a point, support
    is counted over all views, and the best-support point is refined by
    multiview DLT on its inliers only.

    Ps: [M,3,4] w2c, xs: [M,2] normalized obs, ths: [M] per-view inlier
    thresholds (normalized units; scaled by err_mult).
    Returns (X [3], inlier_mask [M]) — X is None if no pair yields a point
    with >= 2 cheirality-positive inliers.
    """
    M = Ps.shape[0]
    best_X, best_inl, best_n = None, None, 1
    for a in range(M):
        for b in range(a + 1, M):
            X = triangulate(Ps[a], Ps[b], xs[a][None], xs[b][None])[0]
            good = np.zeros(M, bool)
            for m in range(M):
                e, z = reprojection_error(Ps[m], X[None], xs[m][None])
                good[m] = z[0] > 0 and e[0] <= err_mult * ths[m]
            n = int(good.sum())
            if n > best_n:
                best_n, best_X, best_inl = n, X, good
                if n == M:
                    break
        if best_n == M:
            break
    if best_X is None:
        return None, None
    if best_n > 2:     # refine on inliers
        idx = np.nonzero(best_inl)[0]
        X = triangulate_multiview(Ps[idx], xs[idx])
        good = np.zeros(M, bool)
        for m in range(M):
            e, z = reprojection_error(Ps[m], X[None], xs[m][None])
            good[m] = z[0] > 0 and e[0] <= err_mult * ths[m]
        if int(good.sum()) >= best_n:
            return X, good
    return best_X, best_inl


def depth_in_camera(P, X):
    """Per-point depth (z in camera frame) for w2c P=[R|t]."""
    return X @ P[:3, :3].T[:, 2] + P[2, 3]


def pose_from_essential(E, x1, x2):
    """Decompose E into the (R,t) of camera 2 w.r.t. camera 1 world frame
    (camera 1 = identity) choosing the candidate with maximal cheirality.
    Returns ([3,4] w2c pose of camera 2, inlier cheirality mask)."""
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    t = U[:, 2]
    P1 = np.eye(3, 4)
    best, best_n, best_front = None, -1, None
    for R in (U @ W @ Vt, U @ W.T @ Vt):
        for tt in (t, -t):
            P2 = np.concatenate([R, tt[:, None]], axis=1)
            X = triangulate(P1, P2, x1, x2)
            front = (depth_in_camera(P1, X) > 0) & (depth_in_camera(P2, X) > 0)
            n = int(front.sum())
            if n > best_n:
                best, best_n, best_front = P2, n, front
    return best, best_front


def pnp_dlt(X, x):
    """Linear PnP: DLT for the full projection matrix from >=6 2D-3D
    correspondences in normalized coords, then orthogonalize R via SVD.
    X: [N,3] world, x: [N,2] normalized. Returns [3,4] w2c pose."""
    N = X.shape[0]
    A = np.zeros((2 * N, 12))
    Xh = np.concatenate([X, np.ones((N, 1))], axis=1)
    A[0::2, 0:4] = Xh
    A[0::2, 8:12] = -x[:, 0:1] * Xh
    A[1::2, 4:8] = Xh
    A[1::2, 8:12] = -x[:, 1:2] * Xh
    _, _, Vt = np.linalg.svd(A, full_matrices=False)
    P = Vt[-1].reshape(3, 4)
    # fix sign: points must be in front
    if np.median(Xh @ P[2]) < 0:
        P = -P
    U, s, Vt = np.linalg.svd(P[:, :3])
    R = U @ Vt
    scale = float(np.mean(s))
    if np.linalg.det(R) < 0:
        # P[:,:3] ≈ (-scale)·(-U Vt): keep det(R)=+1 by flipping both
        R, scale = -R, -scale
    t = P[:, 3] / scale
    return np.concatenate([R, t[:, None]], axis=1)


def reprojection_error(P, X, x):
    """Normalized-coords reprojection error per point."""
    Xc = X @ P[:3, :3].T + P[:3, 3]
    proj = Xc[:, :2] / np.maximum(Xc[:, 2:], 1e-9)
    return np.linalg.norm(proj - x, axis=1), Xc[:, 2]


def refine_pose_pnp(P0, X, x, huber, iters=60):
    """Huber-IRLS Levenberg-Marquardt refinement of ONE camera pose against
    fixed 3D points (the nonlinear PnP polish; cf. COLMAP's pose refinement
    after P3P). Returns the refined [3,4] pose.

    This is load-bearing, not just polish: the linear 6-point DLT that
    seeds `ransac_pnp` is degenerate for coplanar points, and real
    candidate sets can be wall-dominated — measured on the DTU-scale
    fixture, a camera with 42/51 correct observations drew ZERO 6-point
    RANSAC consensus at any threshold because every minimal sample was
    near-planar, while an LM refine seeded from a neighboring registered
    camera registered it with 37/51 inliers (tests/test_sfm_scale.py)."""
    X = np.asarray(X, np.float64)
    x = np.asarray(x, np.float64)
    R = np.asarray(P0, np.float64)[:, :3].copy()
    t = np.asarray(P0, np.float64)[:, 3].copy()

    def residuals(R, t):
        Xc = X @ R.T + t
        z = np.maximum(Xc[:, 2], 1e-9)
        return Xc[:, :2] / z[:, None] - x, Xc, z

    def hcost(r):
        nn = np.sqrt((r ** 2).sum(1))
        return float(np.where(nn < huber, 0.5 * nn * nn,
                              huber * (nn - 0.5 * huber)).mean())

    r, Xc, z = residuals(R, t)
    cost = hcost(r)
    lam = 1e-4
    for _ in range(iters):
        iz = 1.0 / z
        A = np.zeros((len(r), 2, 3))
        A[:, 0, 0] = iz
        A[:, 1, 1] = iz
        A[:, 0, 2] = -Xc[:, 0] * iz * iz
        A[:, 1, 2] = -Xc[:, 1] * iz * iz
        Sk = np.zeros((len(r), 3, 3))
        Sk[:, 0, 1] = -Xc[:, 2]
        Sk[:, 0, 2] = Xc[:, 1]
        Sk[:, 1, 0] = Xc[:, 2]
        Sk[:, 1, 2] = -Xc[:, 0]
        Sk[:, 2, 0] = -Xc[:, 1]
        Sk[:, 2, 1] = Xc[:, 0]
        J = np.concatenate([A, -A @ Sk], axis=2)   # [K,2,6]
        nn = np.sqrt((r ** 2).sum(1))
        w = np.where(nn < huber, 1.0, huber / np.maximum(nn, 1e-12))
        sw = np.sqrt(w)[:, None, None]
        Jw = J * sw
        rw = r * np.sqrt(w)[:, None]
        H = np.einsum("kli,klj->ij", Jw, Jw)
        g = -np.einsum("kli,kl->i", Jw, rw)
        stepped = False
        for _t in range(8):
            try:
                d = np.linalg.solve(
                    H + lam * np.diag(np.diag(H)) + 1e-12 * np.eye(6), g)
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            dR = _so3_exp(d[3:][None])[0]
            R_new, t_new = dR @ R, dR @ t + d[:3]
            r_new, Xc_new, z_new = residuals(R_new, t_new)
            c_new = hcost(r_new)
            if c_new < cost:
                R, t, r, Xc, z, cost = R_new, t_new, r_new, Xc_new, \
                    z_new, c_new
                lam = max(lam / 3.0, 1e-12)
                stepped = True
                break
            lam *= 10.0
        if not stepped:
            break
    return np.concatenate([R, t[:, None]], axis=1)


def ransac_pnp(X, x, thresh=2e-3, iters=300, seed=0):
    """RANSAC over pnp_dlt. Returns (pose, inlier_mask) or (None, None)."""
    N = X.shape[0]
    if N < 6:
        return None, None
    rng = np.random.RandomState(seed)
    best_P, best_inl, best_n = None, None, 0
    for _ in range(iters):
        idx = rng.choice(N, 6, replace=False)
        try:
            P = pnp_dlt(X[idx], x[idx])
        except np.linalg.LinAlgError:
            continue
        err, z = reprojection_error(P, X, x)
        inl = (err < thresh) & (z > 0)
        n = int(inl.sum())
        if n > best_n:
            best_n, best_P, best_inl = n, P, inl
    if best_P is None or best_n < 6:
        return None, None
    P = pnp_dlt(X[best_inl], x[best_inl])
    err, z = reprojection_error(P, X, x)
    inl = (err < thresh) & (z > 0)
    return P, inl


# ---------------------------------------------------------------------------
# track graph: merge pairwise matches into multi-view tracks
# ---------------------------------------------------------------------------

class TrackGraph:
    """Union-find over (image, quantized-keypoint) observations.

    Merges are CONFLICT-AWARE: a match that would fuse two components
    already observing the same image at different keypoints is rejected —
    a single epipolar-consistent wrong match must not glue two real tracks
    (unchecked, 49-view exhaustive ZNCC matching collapsed ~3.2k
    observations into ONE contaminated mega-track that the consistency
    filter then discarded wholesale)."""

    def __init__(self, quant=1.0):
        self.quant = quant
        self.parent = {}
        self.obs = {}      # node -> (img, xy)
        self.imgs = {}     # root -> {img: node}

    def _key(self, img, xy):
        return (img, int(round(xy[0] / self.quant)),
                int(round(xy[1] / self.quant)))

    def _find(self, a):
        root = a
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[a] != root:
            self.parent[a], a = root, self.parent[a]
        return root

    def add_match(self, i, j, xy_i, xy_j):
        a, b = self._key(i, xy_i), self._key(j, xy_j)
        for node, img, xy in ((a, i, xy_i), (b, j, xy_j)):
            if node not in self.parent:
                self.parent[node] = node
                self.obs[node] = (img, np.asarray(xy, np.float64))
                self.imgs[node] = {img: node}
        ra, rb = self._find(a), self._find(b)
        if ra == rb:
            return
        ma, mb = self.imgs[ra], self.imgs[rb]
        if len(mb) > len(ma):
            ra, rb = rb, ra
            ma, mb = mb, ma
        for img, node in mb.items():
            if ma.get(img, node) != node:
                return                      # conflicting merge: reject
        ma.update(mb)
        self.parent[rb] = ra
        del self.imgs[rb]

    def tracks(self, min_len=2):
        """-> list of {img: xy} dicts (one observation per image per track)."""
        groups = {}
        for node in self.parent:
            groups.setdefault(self._find(node), []).append(node)
        out = []
        for nodes in groups.values():
            track = {}
            ok = True
            for node in nodes:
                img, xy = self.obs[node]
                if img in track:
                    # conflicting observations in one image -> drop ambiguity
                    if np.linalg.norm(track[img] - xy) > 2 * self.quant:
                        ok = False
                        break
                else:
                    track[img] = xy
            if ok and len(track) >= min_len:
                out.append(track)
        return out


# ---------------------------------------------------------------------------
# bundle adjustment (torch autograd, Adam on Huber reprojection error)
# ---------------------------------------------------------------------------

def bundle_adjust(poses, points, obs_cam, obs_pt, obs_xy, fixed_cam=0,
                  iters=200, lr=1e-3, huber=5e-3, device=None):
    """Refine poses+points by minimizing Huber reprojection error (Adam).

    The pipeline's BA is ``lm_bundle_adjust``; this first-order solver is
    kept for callers that want it.

    Args:
        poses: [M,3,4] w2c initial poses.
        points: [P,3] initial world points.
        obs_cam / obs_pt: [K] int indices into poses / points.
        obs_xy: [K,2] normalized observations.
        fixed_cam: gauge-fixing camera (its delta stays zero).
        device: ``cuda:0`` unless the caller asks for another (``"cpu"``);
            raises when no card is present and no CPU was asked for.
    Returns: (poses [M,3,4], points [P,3]) refined, as numpy, and the final
    loss.
    """
    import torch
    from ..ops import lie, pose as pose_ops
    from .matchers import resolve_device
    device = resolve_device(device)

    poses0 = torch.as_tensor(np.asarray(poses), dtype=torch.float32, device=device)
    delta = torch.zeros((poses0.shape[0], 6), dtype=torch.float32, device=device,
                        requires_grad=True)
    pts = torch.tensor(np.asarray(points), dtype=torch.float32, device=device,
                       requires_grad=True)
    obs_cam = torch.as_tensor(np.asarray(obs_cam), dtype=torch.long, device=device)
    obs_pt = torch.as_tensor(np.asarray(obs_pt), dtype=torch.long, device=device)
    obs_xy = torch.as_tensor(np.asarray(obs_xy), dtype=torch.float32, device=device)
    fix = torch.arange(poses0.shape[0], device=device) == fixed_cam

    def current_poses():
        d = torch.where(fix[:, None], torch.zeros_like(delta), delta)
        return pose_ops.compose([lie.se3_to_SE3(d), poses0])

    def loss_fn():
        P = current_poses()                            # [M,3,4]
        Rc = P[obs_cam, :, :3]                         # [K,3,3]
        tc = P[obs_cam, :, 3]                          # [K,3]
        Xc = torch.einsum("kij,kj->ki", Rc, pts[obs_pt]) + tc
        proj = Xc[:, :2] / torch.clamp(Xc[:, 2:], min=1e-6)
        r = proj - obs_xy
        # Huber; eps-safe norm (d|r|/dr is NaN at exactly 0, which perfect
        # synthetic observations do reach)
        n = torch.sqrt(torch.sum(r ** 2, dim=1) + 1e-16)
        l = torch.where(n < huber, 0.5 * n ** 2, huber * (n - 0.5 * huber))
        # discourage points behind cameras
        behind = torch.relu(1e-3 - Xc[:, 2])
        return torch.mean(l) + 10.0 * torch.mean(behind)

    opt = torch.optim.Adam([delta, pts], lr=lr)
    for _ in range(iters):
        opt.zero_grad()
        loss_fn().backward()
        opt.step()
    with torch.no_grad():
        return (current_poses().double().cpu().numpy(),
                pts.double().cpu().numpy(), float(loss_fn()))


def _so3_exp(w):
    """Batched Rodrigues: [M,3] axis-angle -> [M,3,3] rotations (numpy)."""
    th = np.linalg.norm(w, axis=-1)
    small = th < 1e-12
    th_safe = np.where(small, 1.0, th)
    a = np.where(small, 1.0, np.sin(th) / th_safe)
    b = np.where(small, 0.5, (1.0 - np.cos(th)) / th_safe ** 2)
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1] = -w[..., 2]
    K[..., 0, 2] = w[..., 1]
    K[..., 1, 0] = w[..., 2]
    K[..., 1, 2] = -w[..., 0]
    K[..., 2, 0] = -w[..., 1]
    K[..., 2, 1] = w[..., 0]
    I = np.broadcast_to(np.eye(3), K.shape)
    return I + a[..., None, None] * K + b[..., None, None] * (K @ K)


def lm_bundle_adjust(poses, points, obs_cam, obs_pt, obs_xy, fixed_cam=0,
                     iters=50, huber=5e-3):
    """Levenberg-Marquardt bundle adjustment with a Schur-complement
    reduced camera system (the standard sparse-BA structure; cf. COLMAP's
    ceres setup, which the reference invokes as an external process —
    reference utils/colmap_initialization/sfm.py:337-406).

    Second-order: at these problem sizes (<=49 cams, a few thousand points)
    the reduced camera system is a <=294x294 dense solve, so each LM step is
    milliseconds and the solver reaches the measurement-noise floor in tens
    of iterations — where the first-order `bundle_adjust` above stalls ~10x
    above it and the drifting map stalls camera registration
    (tests/test_sfm_scale.py).

    Same contract as `bundle_adjust`; Huber robustification via IRLS
    weights. Returns (poses [M,3,4], points [P,3], mean huber loss).

    Gauge: fixing one camera pins 6 of the 7 similarity-gauge DoF; SCALE
    remains a null direction of the reprojection cost. Marquardt damping
    (lam * diag(J^T J)) is zero along a null direction, so LM steps drift
    freely down it — measured: a 49-camera reconstruction shrank ~5000x
    about the fixed camera over a few hundred LM iterations, which keeps
    the cost identical (scale is pure gauge for reprojection) but destroys
    the conditioning of every downstream PnP registration. Each accepted
    step therefore renormalizes the scale gauge: structure and camera
    centers are rescaled about the fixed camera's center so the RMS
    camera-center distance keeps its entry value (cost-invariant by
    construction).
    """
    M = int(poses.shape[0])
    Pn = int(points.shape[0])
    obs_cam = np.asarray(obs_cam, np.int64)
    obs_pt = np.asarray(obs_pt, np.int64)
    obs_xy = np.asarray(obs_xy, np.float64)
    R = np.asarray(poses, np.float64)[:, :, :3].copy()
    t = np.asarray(poses, np.float64)[:, :, 3].copy()
    X = np.asarray(points, np.float64).copy()

    # all same-point observation pairs, for the Schur off-diagonal blocks
    # (structure is fixed across iterations)
    pt_obs = [[] for _ in range(Pn)]
    for k in range(len(obs_cam)):
        pt_obs[obs_pt[k]].append(k)
    pa, pb = [], []
    for ks in pt_obs:
        for a_ in ks:
            for b_ in ks:
                pa.append(a_)
                pb.append(b_)
    pa = np.asarray(pa, np.int64)
    pb = np.asarray(pb, np.int64)
    free = np.asarray([c for c in range(M) if c != fixed_cam], np.int64)
    fidx = (6 * free[:, None] + np.arange(6)).ravel()

    def compute(R, t, X):
        Xc = np.einsum("kij,kj->ki", R[obs_cam], X[obs_pt]) + t[obs_cam]
        z = np.maximum(Xc[:, 2], 1e-9)
        r = Xc[:, :2] / z[:, None] - obs_xy
        return r, Xc, z

    def huber_cost(r):
        n = np.sqrt((r ** 2).sum(1))
        return float(np.where(n < huber, 0.5 * n * n,
                              huber * (n - 0.5 * huber)).mean())

    def centers(R, t):
        return -np.einsum("mji,mj->mi", R, t)   # c_m = -R_m^T t_m

    def gauge_scale(R, t):
        c = centers(R, t)
        o = c[fixed_cam]
        d = c[np.arange(M) != fixed_cam] - o
        return float(np.sqrt((d ** 2).sum(axis=1).mean())) if M > 1 else 1.0

    def renormalize(R, t, X, d0):
        d = gauge_scale(R, t)
        if not (np.isfinite(d) and d > 1e-12):
            return t, X
        s = d0 / d
        if abs(s - 1.0) < 1e-9:
            return t, X
        c = centers(R, t)
        o = c[fixed_cam]
        c_new = o + s * (c - o)
        t_new = -np.einsum("mij,mj->mi", R, c_new)
        X_new = o + s * (X - o)
        return t_new, X_new

    d0 = gauge_scale(R, t)
    lam = 1e-6
    r, Xc, z = compute(R, t, X)
    cost = huber_cost(r)
    n_stall = 0
    for _ in range(iters):
        K2 = len(r)
        iz = 1.0 / z
        A = np.zeros((K2, 2, 3))
        A[:, 0, 0] = iz
        A[:, 1, 1] = iz
        A[:, 0, 2] = -Xc[:, 0] * iz * iz
        A[:, 1, 2] = -Xc[:, 1] * iz * iz
        Sk = np.zeros((K2, 3, 3))
        Sk[:, 0, 1] = -Xc[:, 2]
        Sk[:, 0, 2] = Xc[:, 1]
        Sk[:, 1, 0] = Xc[:, 2]
        Sk[:, 1, 2] = -Xc[:, 0]
        Sk[:, 2, 0] = -Xc[:, 1]
        Sk[:, 2, 1] = Xc[:, 0]
        # camera delta ordered [trans(3), rot(3)], left-multiplicative:
        # X_c' ~= X_c + dt + dw x X_c  =>  dXc/dw = -[X_c]x
        Jc = np.concatenate([A, -A @ Sk], axis=2)          # [K,2,6]
        Jp = A @ R[obs_cam]                                # [K,2,3]
        n = np.sqrt((r ** 2).sum(1))
        w = np.where(n < huber, 1.0, huber / np.maximum(n, 1e-12))
        sw = np.sqrt(w)[:, None, None]
        Jc = Jc * sw
        Jp = Jp * sw
        rw = r * np.sqrt(w)[:, None]

        Uc = np.zeros((M, 6, 6))
        np.add.at(Uc, obs_cam, np.einsum("kli,klj->kij", Jc, Jc))
        V = np.zeros((Pn, 3, 3))
        np.add.at(V, obs_pt, np.einsum("kli,klj->kij", Jp, Jp))
        Wk = np.einsum("kli,klj->kij", Jc, Jp)             # [K,6,3]
        gc = np.zeros((M, 6))
        np.add.at(gc, obs_cam, -np.einsum("kli,kl->ki", Jc, rw))
        gp = np.zeros((Pn, 3))
        np.add.at(gp, obs_pt, -np.einsum("kli,kl->ki", Jp, rw))

        stepped = False
        for _try in range(8):
            dU = Uc + lam * Uc * np.eye(6) + 1e-12 * np.eye(6)
            dV = V + lam * V * np.eye(3) + 1e-12 * np.eye(3)
            try:
                Vinv = np.linalg.inv(dV)
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            Y = np.einsum("kij,kjl->kil", Wk, Vinv[obs_pt])  # [K,6,3]
            b = gc.copy()
            np.add.at(b, obs_cam, -np.einsum("kij,kj->ki", Y, gp[obs_pt]))
            Sb = np.zeros((M, M, 6, 6))
            np.add.at(Sb, (obs_cam[pa], obs_cam[pb]),
                      np.einsum("qij,qkj->qik", Y[pa], Wk[pb]))
            Sfull = np.zeros((M, 6, M, 6))
            Sfull[np.arange(M), :, np.arange(M), :] = dU
            Sfull -= Sb.transpose(0, 2, 1, 3)
            Sfull = Sfull.reshape(6 * M, 6 * M)
            try:
                dc_free = np.linalg.solve(Sfull[np.ix_(fidx, fidx)],
                                          b.ravel()[fidx])
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            dc = np.zeros((M, 6))
            dc[free] = dc_free.reshape(-1, 6)
            tmp = gp.copy()
            np.add.at(tmp, obs_pt,
                      -np.einsum("kij,ki->kj", Wk, dc[obs_cam]))
            dX = np.einsum("pij,pj->pi", Vinv, tmp)

            dR = _so3_exp(dc[:, 3:])
            R_new = dR @ R
            t_new = np.einsum("mij,mj->mi", dR, t) + dc[:, :3]
            X_new = X + dX
            r_new, Xc_new, z_new = compute(R_new, t_new, X_new)
            c_new = huber_cost(r_new)
            if c_new < cost:
                rel = (cost - c_new) / max(cost, 1e-300)
                t_new, X_new = renormalize(R_new, t_new, X_new, d0)
                r_new, Xc_new, z_new = compute(R_new, t_new, X_new)
                R, t, X = R_new, t_new, X_new
                r, Xc, z = r_new, Xc_new, z_new
                cost = huber_cost(r_new)
                lam = max(lam / 3.0, 1e-12)
                stepped = True
                n_stall = n_stall + 1 if rel < 1e-10 else 0
                break
            lam *= 10.0
        if not stepped or n_stall >= 2 or lam > 1e8:
            break

    return (np.concatenate([R, t[:, :, None]], axis=2), X, cost)


# ---------------------------------------------------------------------------
# incremental reconstruction
# ---------------------------------------------------------------------------

def _native():
    """The C++ geometry core (native/sfm_core.cpp, built by sfm_native into
    build/niw_sfm/) when buildable/loadable; None -> numpy fallbacks above.
    NIW_NO_NATIVE=1 forces numpy."""
    from . import sfm_native
    return sfm_native if sfm_native.available() else None


@_staged("bundle_adjustment")
def _run_ba(poses, pts, track_obs, iters, filter_th=None):
    """In-place LM bundle adjustment of the registered cameras AND points,
    with optional post-BA observation filtering (COLMAP's pattern).

    Called after seed triangulation (the linear 8-point essential pose is
    several degrees off at realistic noise — unpolished, every subsequent
    PnP starves), periodically during registration (local BA), and at the
    end. With filter_th (per-camera normalized thresholds), observations
    whose post-BA reprojection error exceeds 3x the threshold are deleted
    from their tracks and starved points leave the map — without this,
    wide-baseline wrong matches inside otherwise-good tracks keep dragging
    the map away and PnP consensus collapses after a few registrations.

    `iters` is interpreted as LM iterations (clamped to [15, 100]); the
    solver usually terminates earlier on its own convergence test."""
    reg_cams = sorted(poses)
    cam_index = {c: k for k, c in enumerate(reg_cams)}
    tids = sorted(pts)
    tid_index = {t: k for k, t in enumerate(tids)}
    obs_cam, obs_pt, obs_xy = [], [], []
    for tid in tids:
        for c, xy in track_obs[tid].items():
            if c in cam_index:
                obs_cam.append(cam_index[c])
                obs_pt.append(tid_index[tid])
                obs_xy.append(xy)
    if not tids or len(obs_xy) < 8:
        return
    P_stack = np.stack([poses[c] for c in reg_cams])
    X_stack = np.stack([pts[t] for t in tids])
    P_new, X_new, ba_loss = lm_bundle_adjust(
        P_stack, X_stack, np.array(obs_cam), np.array(obs_pt),
        np.array(obs_xy), fixed_cam=0,
        iters=int(np.clip(iters, 15, 100)))
    log.info("sfm: BA over {} cams / {} pts / {} obs (loss {:.3e})".format(
        len(reg_cams), len(tids), len(obs_xy), ba_loss))
    for c in reg_cams:
        poses[c] = np.asarray(P_new[cam_index[c]])
    for t in tids:
        pts[t] = np.asarray(X_new[tid_index[t]])
    if filter_th is None:
        return
    n_dropped = 0
    for t in tids:
        bad = []
        for c in list(track_obs[t]):
            if c not in cam_index:
                continue
            e, z = reprojection_error(poses[c], pts[t][None],
                                      track_obs[t][c][None])
            if z[0] <= 0 or e[0] > 3.0 * filter_th[c]:
                bad.append(c)
        for c in bad:
            del track_obs[t][c]
            n_dropped += 1
        reg_support = sum(1 for c in track_obs[t] if c in cam_index)
        if reg_support < 2 and t in pts:
            del pts[t]
    if n_dropped:
        log.info("sfm: BA filter dropped {} observations "
                 "({} pts remain)".format(n_dropped, len(pts)))


@_staged("verify_and_track")
def _verify_and_track(pair_matches, intr, th, seed=0, quant=1.0,
                      min_track_len=2, min_pair_inliers=12):
    """Two-view geometric verification + track graph, shared by the
    incremental and global reconstruction paths.

    1. RANSAC-essential per pair (COLMAP's verification stage), keeping
       inlier matches only. Without it, one wrong match in any of the
       O(N^2) exhaustive pairs glues unrelated tracks together; the
       union-find then drops the contaminated track wholesale and a
       49-view reconstruction starves (measured: 1176 raw ZNCC pairs ->
       6 surviving tracks; verified -> hundreds).
    2. Track build is BEST-PAIR-FIRST: the conflict-aware union-find keeps
       whatever merge arrives first, so link insertion order decides
       whether a wrong link poisons a track or is rejected. Exhaustive
       iteration order interleaves wide-baseline pairs (whose few
       "verified" inliers are mostly wrong on low-overlap views) before
       adjacent ones; sorting by inlier count inserts the trustworthy
       links first (measured: 50.4% bad track observations in insertion
       order -> best-first fixes the bulk).

    Returns (verified, norm, track_obs):
        verified: dict (i,j) -> (E, inlier_mask, (px_i, px_j) inliers)
        norm:     dict (i,j) -> (x1, x2) normalized inlier matches
        track_obs: list of {img: normalized xy} dicts (may be empty)
    """
    nat = _native()
    if nat is not None:
        log.info("sfm: using native geometry core (libniw_sfm.so)")
    ransac_e = nat.ransac_essential if nat else \
        (lambda a, b, thresh, seed: ransac_essential(a, b, thresh=thresh,
                                                     seed=seed))
    norm = {}
    verified = {}
    for (i, j), (xi, xj) in pair_matches.items():
        xi, xj = np.asarray(xi, np.float64), np.asarray(xj, np.float64)
        if len(xi) < 8:
            continue
        x1 = normalize_pixels(xi, intr[i])
        x2 = normalize_pixels(xj, intr[j])
        E, inl = ransac_e(x1, x2, thresh=max(th[i], th[j]), seed=seed)
        if E is None or int(inl.sum()) < max(8, min_pair_inliers):
            continue
        norm[(i, j)] = (x1[inl], x2[inl])
        verified[(i, j)] = (E, inl, (xi[inl], xj[inl]))
    log.info("sfm: {} / {} pairs geometrically verified".format(
        len(verified), len(pair_matches)))

    graph = TrackGraph(quant=quant)
    for (i, j), (_, _, (xi, xj)) in sorted(
            verified.items(), key=lambda kv: -len(kv[1][2][0])):
        for k in range(len(xi)):
            graph.add_match(i, j, xi[k], xj[k])
    tracks = graph.tracks(min_len=min_track_len)
    track_obs = []
    for t in tracks:
        track_obs.append({img: normalize_pixels(xy[None], intr[img])[0]
                          for img, xy in t.items()})
    return verified, norm, track_obs


@_staged("rotation_averaging")
def rotation_averaging(pair_R, n, anchor=0, iters=25, sigma_deg=5.0):
    """Robust global rotation averaging (IRLS chordal L2).

    pair_R: dict (i,j) -> R_ij with R_j = R_ij @ R_i (w2c rotations).
    Solves for all R_i with R_anchor = I by iterating a weighted linear
    least squares over unconstrained 3x3 blocks followed by SO(3)
    projection — the classical chordal relaxation (Martinec & Pajdla),
    with Huber-style reweighting at scale sigma_deg so wrong pair
    geometries are downweighted. Init is BFS spanning-tree composition.

    This is the backbone of the GLOBAL SfM path: each camera is
    constrained by ALL its verified pairs simultaneously, so the
    correlated per-pair pose bias of weak patch matches averages down
    instead of accumulating along an incremental chain.

    Returns: [n,3,3] rotations (identity for cameras not in the graph).
    """
    adj = {i: [] for i in range(n)}
    for (i, j), Rij in pair_R.items():
        adj[i].append((j, Rij, False))
        adj[j].append((i, Rij, True))    # reversed: R_i = R_ij^T R_j

    R = np.tile(np.eye(3), (n, 1, 1))
    seen = {anchor}
    frontier = [anchor]
    while frontier:
        nxt = []
        for i in frontier:
            for j, Rij, rev in adj[i]:
                if j in seen:
                    continue
                R[j] = (Rij.T @ R[i]) if rev else (Rij @ R[i])
                seen.add(j)
                nxt.append(j)
        frontier = nxt
    in_graph = sorted(seen)
    if len(in_graph) < 2:
        return R
    col = {c: k for k, c in enumerate(in_graph)}
    m = len(in_graph)
    pairs = [(i, j, Rij) for (i, j), Rij in pair_R.items()
             if i in seen and j in seen]
    w = np.ones(len(pairs))
    sig = np.deg2rad(sigma_deg)
    for _ in range(iters):
        # weighted LS on X (3m x 3), columns decouple; anchor moves to rhs
        A = np.zeros((3 * len(pairs), 3 * m))
        b = np.zeros((3 * len(pairs), 3))
        for p, (i, j, Rij) in enumerate(pairs):
            sw = np.sqrt(w[p])
            r0 = 3 * p
            if i == anchor:
                b[r0:r0 + 3] += sw * Rij
            else:
                A[r0:r0 + 3, 3 * col[i]:3 * col[i] + 3] = -sw * Rij
            if j == anchor:
                b[r0:r0 + 3] -= sw * np.eye(3)
            else:
                A[r0:r0 + 3, 3 * col[j]:3 * col[j] + 3] += sw * np.eye(3)
        X, _, _, _ = np.linalg.lstsq(A, b, rcond=None)
        for c in in_graph:
            if c == anchor:
                continue
            U, _, Vt = np.linalg.svd(X[3 * col[c]:3 * col[c] + 3])
            Rc = U @ Vt
            if np.linalg.det(Rc) < 0:
                Rc = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
            R[c] = Rc
        # reweight by residual angle
        ang = np.empty(len(pairs))
        for p, (i, j, Rij) in enumerate(pairs):
            dR = R[j] @ (Rij @ R[i]).T
            ang[p] = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1.0, 1.0))
        w_new = np.minimum(1.0, sig / np.maximum(ang, 1e-9))
        if np.allclose(w_new, w, atol=1e-4):
            w = w_new
            break
        w = w_new
    return R


def translation_recovery(pair_t, R, anchor=0, iters=25):
    """Robust global camera-center recovery with known rotations.

    pair_t: dict (i,j) -> unit direction u_ij of (c_i - c_j) in WORLD
    coordinates (sign resolved by two-view cheirality). Minimizes the IRLS
    L1 cross-product residual || (c_i - c_j) x u_ij || over centers, with
    c_anchor = 0 and the scale gauge fixed by sum_p u_ij . (c_i - c_j) =
    #pairs (each pair's projected baseline ~1 on average).

    Returns: centers [n,3] (zeros for cameras without constraints).
    """
    n = R.shape[0]
    involved = sorted({i for p in pair_t for i in p} | {anchor})
    col = {c: k for k, c in enumerate(involved)}
    m = len(involved)
    pairs = [(i, j, u) for (i, j), u in pair_t.items()]
    if not pairs:
        return np.zeros((n, 3))
    w = np.ones(len(pairs))
    c_sol = np.zeros((n, 3))
    for _ in range(iters):
        rows = []
        rhs = []
        for p, (i, j, u) in enumerate(pairs):
            sw = np.sqrt(w[p])
            ux = np.array([[0.0, -u[2], u[1]],
                           [u[2], 0.0, -u[0]],
                           [-u[1], u[0], 0.0]])
            row = np.zeros((3, 3 * m))
            row[:, 3 * col[i]:3 * col[i] + 3] = ux
            row[:, 3 * col[j]:3 * col[j] + 3] = -ux
            rows.append(sw * row)
            rhs.append(np.zeros(3))
        # scale gauge: sum of projected baselines = #pairs (weight large)
        srow = np.zeros((1, 3 * m))
        for (i, j, u) in pairs:
            srow[0, 3 * col[i]:3 * col[i] + 3] += u
            srow[0, 3 * col[j]:3 * col[j] + 3] -= u
        rows.append(10.0 * srow)
        rhs.append(np.array([10.0 * len(pairs)]))
        # anchor gauge: c_anchor = 0 (weight large)
        arow = np.zeros((3, 3 * m))
        arow[:, 3 * col[anchor]:3 * col[anchor] + 3] = np.eye(3)
        rows.append(100.0 * arow)
        rhs.append(np.zeros(3))
        A = np.concatenate(rows)
        b = np.concatenate(rhs)
        sol, _, _, _ = np.linalg.lstsq(A, b, rcond=None)
        C = sol.reshape(m, 3)
        res = np.empty(len(pairs))
        for p, (i, j, u) in enumerate(pairs):
            d = C[col[i]] - C[col[j]]
            res[p] = np.linalg.norm(np.cross(d, u))
        scale = max(np.median(res), 1e-6)
        w_new = np.minimum(1.0, scale / np.maximum(res, 1e-12))
        conv = np.allclose(w_new, w, atol=1e-4)
        w = w_new
        for c in involved:
            c_sol[c] = C[col[c]]
        if conv:
            break
    return c_sol


@_staged("center_init")
def known_rotation_init(R_glob, cams, track_obs, anchor, pair_u=None,
                        iters=12):
    """Linear camera-center + point recovery with KNOWN rotations.

    With rotations fixed, the reprojection constraint becomes linear: the
    world-frame ray r = R_i^T [x, y, 1] of an observation must be parallel
    to (X_p - c_i), i.e. cross(r, X_p - c_i) = 0 — linear in BOTH the
    point X_p and the center c_i. Solving all tracks and centers in one
    sparse IRLS least squares uses every multi-view constraint at once,
    which is what actually determines the geometry when individual
    two-view translation directions are uninformative (thin baselines +
    tens-of-matches pairs put two-view t-direction errors at 30-80 deg
    even under pure iid noise — measured in tests/test_sfm_scale.py's
    regime — so translation averaging over pair directions cannot work
    there, while the track system remains well-conditioned).

    Gauge: c_anchor = 0; scale fixed by sum of pair-direction projections
    (pair_u: dict (i,j) -> world baseline direction) or, if absent, by
    ||sum of squared center norms|| via a unit-mean-depth row.

    Returns (centers dict cam->[3], pts dict tid->[3]).
    """
    from scipy import sparse
    from scipy.sparse import linalg as splinalg

    cams = sorted(cams)
    cam_col = {c: k for k, c in enumerate(cams)}
    tids = [tid for tid, t in enumerate(track_obs)
            if sum(1 for c in t if c in cam_col) >= 2]
    tid_col = {t: k for k, t in enumerate(tids)}
    M, P = len(cams), len(tids)
    if P < 8:
        return {}, {}
    # unknowns: [centers (3M) | points (3P)]
    obs = []     # (cam, tid, r_world)
    for tid in tids:
        for c, xy in track_obs[tid].items():
            if c in cam_col:
                r = R_glob[c].T @ np.array([xy[0], xy[1], 1.0])
                obs.append((c, tid, r / np.linalg.norm(r)))
    K = len(obs)
    w = np.ones(K)
    centers_out, pts_out = {}, {}
    for _ in range(iters):
        rows_i, cols_i, vals = [], [], []
        rhs = []
        nrow = 0

        def add_block(r0, col0, B):
            for a in range(3):
                for b_ in range(3):
                    if B[a, b_] != 0.0:
                        rows_i.append(r0 + a)
                        cols_i.append(col0 + b_)
                        vals.append(B[a, b_])

        for k, (c, tid, r) in enumerate(obs):
            rx = np.array([[0.0, -r[2], r[1]],
                           [r[2], 0.0, -r[0]],
                           [-r[1], r[0], 0.0]])
            sw = np.sqrt(w[k])
            add_block(nrow, 3 * M + 3 * tid_col[tid], sw * rx)
            add_block(nrow, 3 * cam_col[c], -sw * rx)
            rhs.extend([0.0, 0.0, 0.0])
            nrow += 3
        # anchor gauge
        a0 = cam_col[anchor]
        for a in range(3):
            rows_i.append(nrow + a)
            cols_i.append(3 * a0 + a)
            vals.append(100.0)
            rhs.append(0.0)
        nrow += 3
        # scale gauge
        if pair_u:
            srow = np.zeros(3 * M)
            cnt = 0
            for (i, j), u in pair_u.items():
                if i in cam_col and j in cam_col:
                    srow[3 * cam_col[i]:3 * cam_col[i] + 3] += u
                    srow[3 * cam_col[j]:3 * cam_col[j] + 3] -= u
                    cnt += 1
            for cidx in np.nonzero(srow)[0]:
                rows_i.append(nrow)
                cols_i.append(int(cidx))
                vals.append(10.0 * srow[cidx])
            rhs.append(10.0 * max(cnt, 1))
            nrow += 1
        A = sparse.csr_matrix(
            (vals, (rows_i, cols_i)), shape=(nrow, 3 * (M + P)))
        sol = splinalg.lsqr(A, np.asarray(rhs), atol=1e-10, btol=1e-10,
                            iter_lim=4000)[0]
        C = sol[:3 * M].reshape(M, 3)
        X = sol[3 * M:].reshape(P, 3)
        res = np.empty(K)
        for k, (c, tid, r) in enumerate(obs):
            d = X[tid_col[tid]] - C[cam_col[c]]
            res[k] = np.linalg.norm(np.cross(r, d)) / max(
                np.linalg.norm(d), 1e-9)
        scale = max(np.median(res), 1e-9)
        w_new = np.minimum(1.0, (3.0 * scale) / np.maximum(res, 1e-12))
        conv = np.allclose(w_new, w, atol=1e-4)
        w = w_new
        for c in cams:
            centers_out[c] = C[cam_col[c]]
        for t in tids:
            pts_out[t] = X[tid_col[t]]
        if conv:
            break
    return centers_out, pts_out


@_staged("global")
def global_sfm(pair_matches, intrinsics, n_images, thresh_px=2.0,
               min_track_len=2, ba_iters=300, seed=0, quant=1.0,
               min_pair_inliers=12, debug_out=None):
    """Global SfM with known intrinsics (rotation averaging + translation
    recovery + robust triangulation + LM bundle adjustment).

    The modern alternative (cf. glomap) to the incremental chain below,
    kept as a non-default option for unordered wide-baseline collections.
    On thin-baseline arcs it is the WORSE path (measured,
    tests/test_sfm_scale.py): small-baseline two-view rotations carry
    degrees of R/t-ambiguity error, the averaged init lands outside the
    bundle-adjustment basin, and BA then freezes the distortion. The
    incremental path sidesteps two-view rotation quality entirely after
    its seed pair (PnP + refine against the growing multi-view map).

    Same contract as `incremental_sfm` (replaces the reference's external
    COLMAP mapper, reference utils/colmap_initialization/sfm.py:337-406).
    """
    intr = np.asarray(intrinsics, np.float64)
    focal = 0.5 * (intr[:, 0, 0] + intr[:, 1, 1])
    th = thresh_px / focal
    nat = _native()
    pose_from_e = nat.pose_from_essential if nat else pose_from_essential

    def fail():
        return (np.tile(np.eye(3, 4), (n_images, 1, 1)).astype(np.float32),
                [], list(range(n_images)))

    verified, norm, track_obs = _verify_and_track(
        pair_matches, intr, th, seed=seed, quant=quant,
        min_track_len=min_track_len, min_pair_inliers=min_pair_inliers)
    if not track_obs or not verified:
        log.warn("sfm(global): no verified tracks")
        return fail()

    # 1. per-pair relative poses from the verified essential matrices
    pair_R, pair_u = {}, {}
    for (i, j), (E, _, _) in verified.items():
        x1, x2 = norm[(i, j)]
        P2, _ = pose_from_e(E, x1, x2)
        if P2 is None:
            continue
        pair_R[(i, j)] = P2[:, :3]
        # P2 = pose of cam j in cam i's frame: t_rel = R_j(c_i - c_j) in
        # that 2-view frame; express the baseline direction in world coords
        # later, once R_j is known globally.
        pair_u[(i, j)] = P2[:, 3] / max(np.linalg.norm(P2[:, 3]), 1e-12)
    if not pair_R:
        log.warn("sfm(global): no pair poses")
        return fail()

    # anchor = camera with most verified pairs, in the largest component
    deg = np.zeros(n_images)
    for (i, j) in pair_R:
        deg[i] += 1
        deg[j] += 1
    anchor = int(deg.argmax())

    # 2. rotation averaging
    R_glob = rotation_averaging(pair_R, n_images, anchor=anchor)

    # cameras actually reached by the pair graph
    reach = {anchor}
    edges = list(pair_R)
    changed = True
    while changed:
        changed = False
        for (i, j) in edges:
            if (i in reach) != (j in reach):
                reach |= {i, j}
                changed = True
    reached = sorted(reach)
    if len(reached) < 3:
        log.warn("sfm(global): pair graph too small")
        return fail()

    # 3. camera centers: linear known-rotation solve over ALL track
    # constraints at once (two-view translation DIRECTIONS are near-
    # uninformative at tens-of-matches/thin-baseline pairs — see
    # known_rotation_init's docstring; the pair directions only set the
    # scale gauge here)
    pair_u_world = {}
    for (i, j), u in pair_u.items():
        if i in reach and j in reach:
            pair_u_world[(i, j)] = R_glob[j].T @ u
    centers, _ = known_rotation_init(R_glob, reached, track_obs, anchor,
                                     pair_u=pair_u_world)
    if not centers:
        log.warn("sfm(global): center recovery failed")
        return fail()
    poses = {c: np.concatenate(
        [R_glob[c], (-R_glob[c] @ centers[c])[:, None]], axis=1)
        for c in reached}

    # 4. robust triangulation of every track over the global poses
    pts = {}
    with stage("triangulation"):
        for tid, t in enumerate(track_obs):
            reg = [c for c in t if c in poses]
            if len(reg) < 2:
                continue
            P_reg = np.stack([poses[c] for c in reg])
            x_reg = np.stack([t[c] for c in reg])
            X, inl = triangulate_track_robust(P_reg, x_reg,
                                              np.asarray(th)[reg],
                                              err_mult=4.0)
            if X is None:
                continue
            pts[tid] = X
            for m_, c in enumerate(reg):
                if not inl[m_]:
                    del t[c]

    if len(pts) < 8:
        log.warn("sfm(global): triangulation starved ({} pts)".format(
            len(pts)))
        return fail()

    # 5. two LM BA + filter rounds with a retriangulation pass between
    # (poses improve -> previously-failed tracks triangulate)
    _run_ba(poses, pts, track_obs, max(60, ba_iters // 5), filter_th=th)
    with stage("triangulation"):
        for tid, t in enumerate(track_obs):
            if tid in pts:
                continue
            reg = [c for c in t if c in poses]
            if len(reg) < 2:
                continue
            P_reg = np.stack([poses[c] for c in reg])
            x_reg = np.stack([t[c] for c in reg])
            X, inl = triangulate_track_robust(P_reg, x_reg,
                                              np.asarray(th)[reg])
            if X is None:
                continue
            pts[tid] = X
            for m_, c in enumerate(reg):
                if not inl[m_]:
                    del t[c]
    _run_ba(poses, pts, track_obs, max(60, ba_iters // 5), filter_th=th)

    # 6. health check: a camera kept by the averaging but with too few
    # surviving observations is not actually constrained — exclude it
    support = {c: 0 for c in poses}
    for tid in pts:
        for c in track_obs[tid]:
            if c in support:
                support[c] += 1
    weak = [c for c, s in support.items() if s < 6]
    if weak:
        log.warn("sfm(global): dropping weakly-supported cameras {}".format(
            sorted(weak)))
        for c in weak:
            del poses[c]
        _run_ba(poses, pts, track_obs, max(60, ba_iters // 5), filter_th=th)

    if debug_out is not None:
        debug_out.update(poses=dict(poses), pts=dict(pts),
                         track_obs=track_obs, norm=norm, th=th)

    out = np.tile(np.eye(3, 4), (n_images, 1, 1))
    valid, excluded = [], []
    for i in range(n_images):
        if i in poses:
            out[i] = poses[i]
            valid.append(i)
        else:
            excluded.append(i)
    if excluded:
        log.warn("sfm(global): excluded images: {}".format(excluded))
    return out.astype(np.float32), valid, excluded


@_staged("incremental")
def incremental_sfm(pair_matches, intrinsics, n_images, thresh_px=2.0,
                    min_track_len=2, ba_iters=300, seed=0, quant=1.0,
                    min_pair_inliers=12, debug_out=None):
    """Incremental SfM with known intrinsics.

    Args:
        pair_matches: dict (i,j) -> (kps_i [N,2] px, kps_j [N,2] px), i<j.
        intrinsics: [n,3,3].
        n_images: number of cameras.
        thresh_px: inlier / acceptance threshold in PIXELS (converted to
            normalized units per camera via its focal length, like COLMAP's
            pixel-space max reprojection error).
    Returns:
        poses [n,3,4] w2c (identity for failures), valid list, excluded list.
        The reconstruction's global scale/frame is arbitrary (as with COLMAP).
    """
    intr = np.asarray(intrinsics, np.float64)
    focal = 0.5 * (intr[:, 0, 0] + intr[:, 1, 1])
    th = thresh_px / focal          # per-camera normalized threshold

    nat = _native()
    verified, norm, track_obs = _verify_and_track(
        pair_matches, intr, th, seed=seed, quant=quant,
        min_track_len=min_track_len, min_pair_inliers=min_pair_inliers)
    pose_from_e = nat.pose_from_essential if nat else pose_from_essential
    if not track_obs:
        log.warn("sfm: no tracks; returning identity poses")
        return (np.tile(np.eye(3, 4), (n_images, 1, 1)).astype(np.float32),
                [], list(range(n_images)))

    # 2. seed pair: RANSAC-verified inliers AND sufficient triangulation
    # angle (COLMAP's init criterion — a near-zero-baseline neighbor pair
    # can have the most inliers but triangulates ill-conditioned points
    # that poison every subsequent PnP registration)
    candidates = sorted(
        ((len(norm[p][0]), p, E) for p, (E, _, _) in verified.items()),
        key=lambda c: -c[0])
    seed_pair = None
    best_score = 0.0
    # evaluate a WIDE candidate pool: in a dense rig the top pairs by
    # inlier count are all tiny-baseline neighbors, and a small-angle seed
    # triangulates depth so badly that every subsequent PnP fails
    for n_inl, (i, j), E in candidates[:300]:
        x1i, x2i = norm[(i, j)]
        P2, _ = pose_from_e(E, x1i, x2i)   # 2nd value differs native/python
        if P2 is None:
            continue
        X = triangulate(np.eye(3, 4), P2, x1i, x2i)
        keep = (depth_in_camera(np.eye(3, 4), X) > 0) \
            & (depth_in_camera(P2, X) > 0)
        if int(keep.sum()) < 8:
            continue
        X = X[keep]
        # median triangulation angle over the cheirality-positive points
        c2 = -P2[:, :3].T @ P2[:, 3]
        r1 = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
        r2 = X - c2[None]
        r2 = r2 / np.maximum(np.linalg.norm(r2, axis=1, keepdims=True), 1e-12)
        ang = np.degrees(np.arccos(np.clip(np.sum(r1 * r2, axis=1),
                                           -1.0, 1.0)))
        med_ang = float(np.median(ang))
        if med_ang < 2.0 and best_score > 0:
            continue                        # near-degenerate baseline
        score = n_inl * min(med_ang / 4.0, 1.0) ** 2
        if score > best_score:
            # planar-degeneracy test: if a homography explains (almost)
            # all the E-inliers, the pair's matches are (near-)coplanar
            # and the essential pose is unreliable — reject as seed
            _, h_inl = ransac_homography(x1i, x2i,
                                         thresh=max(th[i], th[j]),
                                         seed=seed)
            if h_inl is not None and int(h_inl.sum()) >= 0.9 * len(x1i):
                continue
            best_score = score
            seed_pair, seed_P2 = (i, j), P2
    if seed_pair is None:
        log.warn("sfm: no valid seed pair; returning identity poses")
        return (np.tile(np.eye(3, 4), (n_images, 1, 1)).astype(np.float32),
                [], list(range(n_images)))
    i0, j0 = seed_pair
    log.info("sfm: seed pair {} (score {:.1f})".format(seed_pair,
                                                       best_score))
    poses = {i0: np.eye(3, 4), j0: seed_P2}

    # 3. triangulate every track observed in both seed views
    pts = {}
    for tid, t in enumerate(track_obs):
        if i0 in t and j0 in t:
            X = triangulate(poses[i0], poses[j0], t[i0][None], t[j0][None])[0]
            e1, z1 = reprojection_error(poses[i0], X[None], t[i0][None])
            e2, z2 = reprojection_error(poses[j0], X[None], t[j0][None])
            if z1[0] > 0 and z2[0] > 0 and e1[0] < 2 * th[i0] \
                    and e2[0] < 2 * th[j0]:
                pts[tid] = X
    # polish the two-view seed: the linear essential pose is degrees off
    _run_ba(poses, pts, track_obs, max(2000, ba_iters), filter_th=th)

    # 4. register remaining cameras by PnP, triangulating as we go; a
    # failed PnP tries the next-best candidate camera instead of aborting
    # the whole reconstruction (a camera can fail now and register later
    # once more of its tracks are triangulated)
    remaining = [i for i in range(n_images) if i not in poses]
    ransac_pnp_fn = nat.ransac_pnp if nat is not None else ransac_pnp

    @_staged("triangulation")
    def _triangulate_new():
        # triangulate tracks now visible from >=2 registered cameras:
        # robust pair-RANSAC triangulation (a wrong link in the track must
        # not poison the point), and the outlier observations of registered
        # cameras are pruned from the track immediately — they are wrong
        # links, and left in place they feed BA and later PnP candidates
        for tid, t in enumerate(track_obs):
            if tid in pts:
                continue
            reg = [c for c in t if c in poses]
            if len(reg) < 2:
                continue
            P_reg = np.stack([poses[c] for c in reg])
            x_reg = np.stack([t[c] for c in reg])
            X, inl = triangulate_track_robust(P_reg, x_reg,
                                              np.asarray(th)[reg])
            if X is None:
                continue
            pts[tid] = X
            for m, c in enumerate(reg):
                if not inl[m]:
                    del t[c]

    def _register_sweep():
        made = 0
        while remaining:
            cand = [(sum(1 for tid in pts if c in track_obs[tid]), c)
                    for c in remaining]
            cand.sort(reverse=True)
            cam, P, used_mult = None, None, 1.0
            # threshold escalation: the two-view seed frame can carry a
            # couple of degrees of rotation error that the data cannot
            # determine better (measured: converged 2-view BA still 2.4 deg
            # off at ZNCC noise); an escalated-threshold registration lets
            # a third camera join, after which multi-view BA pins the
            # frame properly
            for mult in (2.0, 4.0, 8.0):
                for n_vis, c in cand:
                    if n_vis < 6:
                        break
                    tids_c = [tid for tid in pts if c in track_obs[tid]]
                    X = np.stack([pts[t] for t in tids_c])
                    x = np.stack([track_obs[t][c] for t in tids_c])
                    P_c, inl = ransac_pnp_fn(X, x, thresh=mult * th[c],
                                             seed=seed)
                    if P_c is None:
                        # The 6-point DLT inside RANSAC is degenerate for
                        # coplanar points (wall-dominated candidate sets
                        # draw zero consensus even when most observations
                        # are correct — see refine_pose_pnp). Seed a
                        # nonlinear refine from the registered camera
                        # sharing the most tracks instead.
                        shared = {}
                        for tid in tids_c:
                            for cc in track_obs[tid]:
                                if cc in poses:
                                    shared[cc] = shared.get(cc, 0) + 1
                        if not shared:
                            continue
                        nb = max(shared, key=shared.get)
                        P_c = refine_pose_pnp(poses[nb], X, x,
                                              huber=2 * th[c])
                    else:
                        P_c = refine_pose_pnp(P_c, X, x, huber=2 * th[c])
                    e, z = reprojection_error(P_c, X, x)
                    inl = (e < mult * th[c]) & (z > 0)
                    # COLMAP-style acceptance: absolute minimum + inlier
                    # RATIO (0.25); demanding a high fraction of n_vis
                    # starves real cameras whose candidate set carries
                    # matcher outliers
                    if int(inl.sum()) >= max(6, int(0.25 * n_vis)):
                        cam, P, used_mult = c, P_c, mult
                        break
                if cam is not None:
                    break
            if cam is None:
                if cand and cand[0][0] >= 6:
                    log.info("sfm: registration stalled with {} cams; best "
                             "candidate cam {} saw {} pts but PnP found no "
                             "consensus".format(len(poses), cand[0][1],
                                                cand[0][0]))
                break
            poses[cam] = P
            remaining.remove(cam)
            made += 1
            log.info("sfm: registered cam {} (mult {:.0f}, {} pts in "
                     "map)".format(cam, used_mult, len(pts)))
            if used_mult > 2.0 or len(poses) % 2 == 0:   # local BA
                _run_ba(poses, pts, track_obs, max(800, ba_iters // 2),
                        filter_th=th)
            _triangulate_new()
        return made

    # Retry sweeps: a camera that fails PnP in one sweep can succeed after
    # a full BA polishes the map and retriangulation densifies it (the
    # classic resection-intersection alternation); stop at a fixpoint.
    while remaining:
        if _register_sweep() == 0:
            break
        if not remaining:
            break
        _run_ba(poses, pts, track_obs, max(2000, ba_iters), filter_th=th)
        _triangulate_new()

    # 5. final bundle adjustment over all registered cameras + points,
    # with a retriangulation pass between two rounds (poses improve ->
    # previously-failed tracks triangulate -> more constraints)
    _run_ba(poses, pts, track_obs, max(2000, ba_iters), filter_th=th)
    _triangulate_new()
    _run_ba(poses, pts, track_obs, max(2000, ba_iters), filter_th=th)

    if debug_out is not None:
        debug_out.update(poses=dict(poses), pts=dict(pts),
                         track_obs=track_obs, norm=norm, th=th)

    out = np.tile(np.eye(3, 4), (n_images, 1, 1))
    valid, excluded = [], []
    for i in range(n_images):
        if i in poses:
            out[i] = poses[i]
            valid.append(i)
        else:
            excluded.append(i)
    if excluded:
        log.warn("sfm: excluded images (registration failed): {}".format(
            excluded))
    return out.astype(np.float32), valid, excluded
