"""Correspondence matchers of the SfM pose-initialisation subsystem (port of
neural_invertible_warp_tpu/utils/matchers.py).

A matcher is any callable ``matcher(i, j, img_i, img_j) -> (kps_i [N,2],
kps_j [N,2])`` (pixel coordinates, x right, y down). Provided:

* ``PdcNetMatcher`` — the learned dense matcher (PDC-Net, reference
  utils/colmap_initialization/pdcnet_for_hloc.py:154-494), on the card by
  default; ``pdcnet(weights_path)`` builds it from the reference checkpoint.
* ``ZnccMatcher`` — weight-free: Harris corners + mutual-best ZNCC patch
  matching (the all-pairs patch correlation is one ``torch.matmul``).
* ``SyntheticGTMatcher`` — projects a known 3D point set with the GT poses and
  adds noise and outliers; validates the SfM orchestration without a
  learned matcher.
* pair selection: ``exhaustive_pairs``, ``retrieval_pairs`` and the
  pose-nearest ``nearest_pose_pairs``.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device):
    """``cuda:0`` unless the caller asks for another device; raises when no
    card is present and no CPU was asked for."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def exhaustive_pairs(n):
    """All (i, j) with i < j (reference hloc pairs_from_exhaustive)."""
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def retrieval_pairs(images, num_neighbors=8, thumb=(24, 32)):
    """Appearance-retrieval pair proposal: each image is linked to its
    ``num_neighbors`` most similar images by normalised-thumbnail
    correlation, a weight-free stand-in for the retrieval stage (NetVLAD
    top-k) of hloc pipelines. Pruning low-overlap pairs also removes the
    wrong matches that repetitive structure lets through epipolar
    verification (the JAX package's tests/test_sfm_scale.py)."""
    descs = []
    th, tw = thumb
    for im in images:
        g = _to_gray(im)
        H, W = g.shape
        bh, bw = max(1, H // th), max(1, W // tw)
        g = g[:bh * (H // bh), :bw * (W // bw)]
        d = g.reshape(H // bh, bh, W // bw, bw).mean(axis=(1, 3)).ravel()
        d = d - d.mean()
        n = np.linalg.norm(d)
        descs.append(d / n if n > 1e-9 else d)
    # thumbnails can differ in shape if inputs do; crop to a common length
    L = min(len(d) for d in descs)
    D = np.stack([d[:L] for d in descs])
    S = D @ D.T
    np.fill_diagonal(S, -np.inf)
    pairs = set()
    for i in range(len(images)):
        for j in np.argsort(S[i])[::-1][:num_neighbors]:
            pairs.add((min(i, int(j)), max(i, int(j))))
    return sorted(pairs)


def _to_gray(img):
    img = np.asarray(img, np.float64)
    if img.ndim == 3:
        img = img @ np.array([0.299, 0.587, 0.114])
    return img


def _harris_corners(gray, k=0.05, n_corners=300, nms=5):
    """Harris corners with a simple NMS and per-detection subpixel
    refinement (numpy only)."""
    gy, gx = np.gradient(gray)
    Ixx, Iyy, Ixy = gx * gx, gy * gy, gx * gy

    def box(a, r=2):
        # separable box filter via cumsum
        c = np.cumsum(np.cumsum(np.pad(a, r + 1), axis=0), axis=1)
        H, W = a.shape
        return (c[2 * r + 1:2 * r + 1 + H, 2 * r + 1:2 * r + 1 + W]
                - c[:H, 2 * r + 1:2 * r + 1 + W]
                - c[2 * r + 1:2 * r + 1 + H, :W] + c[:H, :W])

    Sxx, Syy, Sxy = box(Ixx), box(Iyy), box(Ixy)
    R = (Sxx * Syy - Sxy ** 2) - k * (Sxx + Syy) ** 2
    H, W = gray.shape
    border = min(nms + 8, max(2, min(H, W) // 4))
    R[:border], R[-border:] = -np.inf, -np.inf
    R[:, :border], R[:, -border:] = -np.inf, -np.inf
    # NMS: keep pixels that are the max of their (2 nms + 1)^2 window
    corners = []
    flat = np.argsort(R.ravel())[::-1]
    taken = np.zeros_like(R, bool)
    for idx in flat[:n_corners * 20]:
        y, x = divmod(int(idx), W)
        if not np.isfinite(R[y, x]) or R[y, x] <= 0:
            break
        if taken[max(0, y - nms):y + nms + 1, max(0, x - nms):x + nms + 1].any():
            continue
        taken[y, x] = True
        # subpixel: 1-D quadratic fits through the response's central cross,
        # once per detection so that a corner has one position in every pair
        dx = dy = 0.0
        den_x = R[y, x - 1] - 2.0 * R[y, x] + R[y, x + 1]
        if np.isfinite(den_x) and den_x < -1e-12:
            dx = float(np.clip(0.5 * (R[y, x - 1] - R[y, x + 1]) / den_x, -0.5, 0.5))
        den_y = R[y - 1, x] - 2.0 * R[y, x] + R[y + 1, x]
        if np.isfinite(den_y) and den_y < -1e-12:
            dy = float(np.clip(0.5 * (R[y - 1, x] - R[y + 1, x]) / den_y, -0.5, 0.5))
        corners.append((x + dx, y + dy))
        if len(corners) >= n_corners:
            break
    return np.array(corners, np.float64).reshape(-1, 2)


def _patches(img, kps, r):
    """Zero-mean, unit-norm patches at the nearest-integer keypoints: img
    [H,W] gray or [H,W,C] colour -> [N, (2r+1)^2 C]. Colour patches tell
    apart look-alike features that differ only chromatically."""
    img = np.asarray(img, np.float64)
    if img.ndim == 2:
        img = img[:, :, None]
    C = img.shape[2]
    out = []
    for x, y in np.round(kps).astype(int):
        p = img[y - r:y + r + 1, x - r:x + r + 1].reshape(-1, C)
        p = (p - p.mean(axis=0)).ravel()   # zero-mean per channel
        n = np.linalg.norm(p)
        out.append(p / n if n > 1e-9 else p)
    return np.stack(out) if out else np.zeros((0, (2 * r + 1) ** 2 * C))


class ZnccMatcher:
    """Harris + mutual-best ZNCC patch matching (weight-free). Corners and
    patches are cached per image index. The all-pairs score matrix is one
    float32 ``torch.matmul`` on ``device`` (``cuda:0`` unless the caller
    asks for another; raises without a card)."""

    def __init__(self, n_corners=300, patch_radius=6, min_score=0.7, ratio_margin=0.03,
                 color=True, device=None):
        self.n_corners = n_corners
        self.r = patch_radius
        self.min_score = min_score
        # descriptors from RGB patches (Harris stays on luminance)
        self.color = color
        # Lowe-style distinctiveness: reject a mutual-best match whose
        # second-best score is within ratio_margin of the best
        self.ratio_margin = ratio_margin
        self.device = resolve_device(device)
        self._cache = {}

    def _features(self, idx, img):
        if idx in self._cache:
            return self._cache[idx]
        g = _to_gray(img)
        k = _harris_corners(g, n_corners=self.n_corners, nms=self.r)
        if len(k):   # keep corners whose full patch is in bounds
            H, W = g.shape
            kr = np.round(k)
            ok = (kr[:, 0] >= self.r) & (kr[:, 0] < W - self.r) \
                & (kr[:, 1] >= self.r) & (kr[:, 1] < H - self.r)
            k = k[ok]
        desc_img = img if (self.color and np.asarray(img).ndim == 3) else g
        p = _patches(desc_img, k, self.r) if len(k) else None
        self._cache[idx] = (k, p)
        return k, p

    def __call__(self, i, j, img_i, img_j):
        k1, p1 = self._features(i, img_i)
        k2, p2 = self._features(j, img_j)
        if len(k1) == 0 or len(k2) == 0:
            return np.zeros((0, 2)), np.zeros((0, 2))
        a = torch.as_tensor(p1, dtype=torch.float32, device=self.device)
        b = torch.as_tensor(p2, dtype=torch.float32, device=self.device)
        S = torch.matmul(a, b.T).cpu().numpy()                  # [N1,N2]
        best12 = S.argmax(axis=1)
        best21 = S.argmax(axis=0)
        if S.shape[1] >= 2:
            second12 = np.partition(S, -2, axis=1)[:, -2]
        else:
            second12 = np.full(S.shape[0], -np.inf)
        keep = [(a_, b_) for a_, b_ in enumerate(best12)
                if best21[b_] == a_ and S[a_, b_] >= self.min_score
                and S[a_, b_] - second12[a_] >= self.ratio_margin]
        if not keep:
            return np.zeros((0, 2)), np.zeros((0, 2))
        ia, ib = zip(*keep)
        return k1[list(ia)].astype(np.float64), k2[list(ib)].astype(np.float64)


class SyntheticGTMatcher:
    """GT-projected correspondences for pipeline tests: a fixed 3D point set
    through the GT w2c poses; points visible in both views become matches,
    with Gaussian pixel noise and an optional outlier fraction."""

    def __init__(self, poses_w2c, intrinsics, points3d, H, W, noise_px=0.3,
                 outlier_frac=0.0, seed=0):
        self.poses = np.asarray(poses_w2c, np.float64)
        self.intr = np.asarray(intrinsics, np.float64)
        self.pts = np.asarray(points3d, np.float64)
        self.H, self.W = H, W
        self.noise = noise_px
        self.outlier_frac = outlier_frac
        self.rng = np.random.RandomState(seed)
        # detection noise per (image, point), drawn once: a detector finds a
        # landmark at the same pixel in every pair, so tracks chain
        self._noisy_uv = {}

    def _project(self, i):
        P, K = self.poses[i], self.intr[i]
        Xc = self.pts @ P[:, :3].T + P[:, 3]
        z = Xc[:, 2]
        uv = Xc @ K.T
        uv = uv[:, :2] / np.maximum(uv[:, 2:], 1e-9)
        vis = (z > 1e-3) & (uv[:, 0] >= 0) & (uv[:, 0] < self.W) \
            & (uv[:, 1] >= 0) & (uv[:, 1] < self.H)
        return uv, vis

    def _detect(self, i):
        if i not in self._noisy_uv:
            uv, vis = self._project(i)
            uv = uv + self.rng.randn(*uv.shape) * self.noise
            self._noisy_uv[i] = (uv, vis)
        return self._noisy_uv[i]

    def __call__(self, i, j, img_i=None, img_j=None):
        uv_i, vis_i = self._detect(i)
        uv_j, vis_j = self._detect(j)
        both = vis_i & vis_j
        a, b = uv_i[both].copy(), uv_j[both].copy()
        if self.outlier_frac > 0 and len(a):
            n_out = int(len(a) * self.outlier_frac)
            idx = self.rng.choice(len(a), n_out, replace=False)
            b[idx] = self.rng.rand(n_out, 2) * [self.W, self.H]
        return a, b


class PdcNetMatcher:
    """The learned dense matcher (PDC-Net). Matches come from the final flow
    at ``scaling`` x the image resolution, masked by the Laplace-mixture
    confidence P_R >= min_confidence, rescaled to image pixels.

    Args:
        module: an ``ops.pdcnet.pdcnet.PDCNet`` (``convert.load_pdcnet_checkpoint``
            for the reference weights, ``PDCNet(generator)`` for random ones).
        device: ``cuda:0`` unless the caller asks for another (``"cpu"``);
            raises when no card is present and no CPU was asked for.

    Runs under ``torch.no_grad()`` with TF32 off in cuDNN and in matmul (PDC-
    Net's convolutions would take TF32 in cuDNN by default); both flags are
    restored on exit.
    """

    def __init__(self, module, min_confidence=0.1, scaling=0.25, min_matches=0, device=None):
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()
        self.min_confidence = min_confidence
        self.scaling = scaling
        self.min_matches = min_matches

    def image_tensor(self, img):
        arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        if arr.max() <= 1.0 + 1e-6:
            arr = arr * 255.0
        return torch.as_tensor(arr.transpose(2, 0, 1)[None].copy(), device=self.device)

    def flow_and_confidence(self, img_target, img_source):
        """(flow [1,2,h,w], P_R [1,1,h,w]) from target to source."""
        from ..ops.pdcnet import pdcnet as pdcnet_mod
        cudnn_tf32 = torch.backends.cudnn.allow_tf32
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.no_grad():
                return pdcnet_mod.estimate_flow_and_confidence_map(
                    self.module, self.image_tensor(img_source), self.image_tensor(img_target),
                    scaling=self.scaling)
        finally:
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32

    def __call__(self, i, j, img_i, img_j):
        from ..ops.pdcnet import pdcnet as pdcnet_mod
        # matcher contract: kps_i[k] in image i corresponds to kps_j[k]. The
        # flow goes from target to source: i is the target, j the source.
        flow, p_r = self.flow_and_confidence(img_i, img_j)
        kp_s, kp_t, _ = pdcnet_mod.matches_from_flow_and_confidence(
            flow, p_r, np.asarray(img_i).shape[:2], self.min_confidence, self.min_matches)
        return kp_t, kp_s


def pdcnet(weights_path=None, **kwargs):
    """PDC-Net matcher factory (pose.sfm.matcher=pdcnet). Needs the
    reference's PDCNet_megadepth checkpoint on disk."""
    if weights_path is None:
        raise RuntimeError(
            "PDC-Net needs pretrained weights: pass pose.sfm.weights_path="
            "<PDCNet_megadepth.pth.tar> (loaded by ops/pdcnet/convert.load_pdcnet_checkpoint). "
            "The network is bundled; only the trained checkpoint is not. ZnccMatcher is the "
            "weight-free alternative.")
    from ..ops.pdcnet import convert
    return PdcNetMatcher(convert.load_pdcnet_checkpoint(weights_path), **kwargs)


# ---------------------------------------------------------------------------
# pair selection (reference data/data_utils.py:248-330): match each view only
# against its pose-nearest neighbours instead of all O(N^2) pairs
# ---------------------------------------------------------------------------

def angular_dist_rot(R1, R2):
    """Angle (rad) between rotation matrices, batched [N,3,3]."""
    tr = np.trace(np.matmul(np.swapaxes(R2, -1, -2), R1), axis1=-2, axis2=-1)
    return np.arccos(np.clip((tr - 1) / 2.0, -1 + 1e-8, 1 - 1e-8))


def get_nearest_pose_ids(tar_pose_c2w, ref_poses_c2w, num_select, tar_id=-1,
                         angular_dist_method="vector", scene_center=(0, 0, 0), rng=None):
    """Nearest reference views to a target pose (reference
    data/data_utils.py:267-330). angular_dist_method: 'matrix' (rotation
    distance), 'vector' (angle between camera-center vectors from
    scene_center), 'dist' (center distance), 'random'."""
    tar = np.asarray(tar_pose_c2w, np.float64)
    refs = np.asarray(ref_poses_c2w, np.float64)
    n = len(refs)
    num_select = min(num_select, n - 1 if tar_id > 0 else n)
    if angular_dist_method == "matrix":
        dists = angular_dist_rot(np.tile(tar[None, :3, :3], (n, 1, 1)), refs[:, :3, :3])
    elif angular_dist_method == "vector":
        c = np.asarray(scene_center, np.float64)[None]
        a = tar[None, :3, 3] - c
        b = refs[:, :3, 3] - c
        a = a / (np.linalg.norm(a, axis=1, keepdims=True) + 1e-8)
        b = b / (np.linalg.norm(b, axis=1, keepdims=True) + 1e-8)
        dists = np.arccos(np.clip(np.sum(a * b, axis=-1), -1.0, 1.0))
    elif angular_dist_method == "dist":
        dists = np.linalg.norm(tar[None, :3, 3] - refs[:, :3, 3], axis=1)
    elif angular_dist_method == "random":
        dists = (rng or np.random).rand(n)
    else:
        raise ValueError("unknown angular distance method: {}".format(angular_dist_method))
    if tar_id >= 0:
        dists[tar_id] = 1e3
    return np.argsort(dists)[:num_select]


def nearest_pose_pairs(poses_c2w, num_neighbors, **kwargs):
    """(i, j) pairs (i < j) linking each view to its pose-nearest neighbours,
    the sparse alternative to exhaustive_pairs."""
    poses_c2w = np.asarray(poses_c2w)
    pairs = set()
    for i in range(len(poses_c2w)):
        ids = get_nearest_pose_ids(poses_c2w[i], poses_c2w, num_neighbors, tar_id=i, **kwargs)
        for j in ids:
            pairs.add((min(i, int(j)), max(i, int(j))))
    return sorted(pairs)
