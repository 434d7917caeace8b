"""The quality probes' synthetic scenes, in memory.

Copies of tests/synth_data.py's band-limited Gaussian-blob scene makers
that return the arrays ``Dataset.all_arrays`` would read back from the
files those write (image [B,H,W,3] float32 in [0,1], intr [B,3,3], pose
[B,3,4] w2c, idx [B] int32), per split, instead of writing PNGs:

* ``blob_llff_arrays``: the wide forward-facing LLFF cluster with the blob
  slab at the cameras' common look-at point (``backdrop``: a textured wall
  behind it; ``dense``: a thick frustum-filling blob cloud);
* ``blob_blender_arrays``: cameras on the r=4 sphere around a blob ball;
* ``blob_dtu_arrays``: the DTU arc over an opaque textured blob cluster
  before a spotted wall, with GT depth, its validity and the foreground
  mask, as the DTU loader gives them;
* ``blob_iphone_arrays``: an unposed video of a blob cloud before a wall
  (the loader's identity poses, and the true ones beside them);
* ``blob_tandt_arrays``: a Tanks-and-Temples walk-through arc over a blob
  slab and a wall.

Poses come from the loaders' own parses (``data.llff.parse_poses_bounds``,
``data.blender.raw_to_w2c``, ``data.tandt.spherify_poses``; the DTU
loader's parse of the projection matrices is reproduced from the cameras
by ``dtu_loader_w2c``), so they equal what the loaders read. Images
are rendered in torch on ``device`` (the blob field composited over
unjittered samples, as ``analytic_blob_render``) and quantized through
uint8 as the PNG round trip does; the loaders' same-size BICUBIC resize is
a copy. ``render_blobs`` also renders chip_smoke.py's SfM scene (a wall
with colour spots; its depth and opacity maps). ``dtu_scene``,
``iphone_scene`` and ``tandt_scene`` hold the cameras and content of the
last three without rendering them, ``blob_llff_scene`` those of the first,
which ``write_llff_tree`` writes as an LLFF tree of PNGs, and
``write_dtu_tree`` writes ``dtu_scene`` in DTU's file layout at DTU's raw
1200x1600; ``render_views`` renders any of their views alone.
``PROBE_SCENES`` names the five scenes of the quality probes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data import blender, dtu, iphone, llff, tandt
from ..ops import rays, render, sampling
from ..utils import image_io

LLFF_RAW_HW = (3024, 4032)
LLFF_FOCAL = 3260.0
BLENDER_RAW_W = 800
BLENDER_CAMERA_ANGLE_X = 0.8


def look_at_c2w(eye, target=(0, 0, 0), up=(0, 1, 0)):
    """OpenGL-style camera-to-world matrix (camera looks down -z)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = eye - target  # OpenGL: camera z points backwards
    fwd /= np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    R = np.stack([right, true_up, fwd], axis=1)
    return np.concatenate([R, eye[:, None]], axis=1).astype(np.float32)  # [3,4]


def blob_params(seed=0, n_blobs=24, radius=1.1, center=(0.0, 0.0, 0.0),
                axis_scale=(1.0, 1.0, 1.0), s_range=(0.16, 0.38)):
    """Random bounded blob-field parameters (numpy, reproducible)."""
    r = np.random.RandomState(seed)
    v = r.randn(n_blobs, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    rad = radius * r.rand(n_blobs) ** (1.0 / 3.0)
    mu = v * rad[:, None] * np.asarray(axis_scale) + np.asarray(center)
    s = s_range[0] + (s_range[1] - s_range[0]) * r.rand(n_blobs)
    a = 25.0 + 35.0 * r.rand(n_blobs)
    c = 0.06 + 0.88 * r.rand(n_blobs, 3)
    return dict(mu=mu.astype(np.float32), s=s.astype(np.float32),
                a=a.astype(np.float32), c=c.astype(np.float32))


def backdrop_params(point, normal, seed=0):
    """A band-limited textured wall (plane) giving every pixel view-consistent
    content; without it the empty background lets joint pose+field
    optimization fall into the 'every camera its own region' gauge."""
    r = np.random.RandomState(seed)
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    u = np.cross(n, [0.0, 1.0, 0.1])
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    # low-frequency color field: 3 octaves, max ~4 rad/unit (band-limited)
    freqs = np.stack([r.uniform(0.8, 4.0, (3, 2)) for _ in range(3)])  # [3,3,2]
    phases = r.uniform(0, 2 * np.pi, (3, 3))
    amps = np.array([0.25, 0.15, 0.08])
    return dict(point=np.asarray(point, np.float32),
                normal=n.astype(np.float32), u=u.astype(np.float32),
                v=v.astype(np.float32), freqs=freqs.astype(np.float32),
                phases=phases.astype(np.float32), amps=amps.astype(np.float32))


def render_blobs(pose_w2c, intr, H, W, blob, n_samples=192, depth_range=(2.0, 6.0),
                 bgcolor=1.0, backdrop=None, device="cpu", max_elems=1 << 23):
    """The blob field seen from w2c poses [B,3,4] with intrinsics [B,3,3]:
    3-sigma-truncated Gaussian densities, colours weighted by the
    untruncated ones (times 1 + amp sin(fx x) sin(fy y + 1.3) sin(fz z + 2.1)
    where ``blob`` has ``tex`` = dict(freq=(fx, fy, fz), amp=amp): a 3-D
    colour texture on the blob bodies), composited over ``n_samples``
    unjittered depths; where
    a ray leaves the field, ``bgcolor`` or, with ``backdrop``, the textured
    wall (with Gaussian colour spots where it has ``spot_uv``, ``spot_s``
    and ``spot_c``). Rendered in chunks of rays on ``device``, at most
    ``max_elems`` sample-blob pairs each. Returns rgb [B,H,W,3], the
    expected ray parameter (the z-depth: the pixel grid lies on z=1) with
    the wall's hit or, without one, ``depth_range[1]`` where the ray leaves
    the field, and the field's opacity [B,H,W], as numpy float32."""
    f32 = dict(dtype=torch.float32, device=device)
    mu, s, a, c = (torch.as_tensor(blob[k], **f32) for k in ("mu", "s", "a", "c"))
    bd = None if backdrop is None else {
        k: torch.as_tensor(v, **f32) for k, v in backdrop.items() if k != "amps"}
    # truncate tails at 3-sigma (smoothly) so the blobs stay compact
    w_cut = float(np.exp(-4.5))
    tex = blob.get("tex")
    if tex is not None:
        fx, fy, fz = (float(v) for v in tex["freq"])
        amp = float(tex["amp"])
    chunk = max(1, max_elems // (n_samples * len(blob["s"])))
    rgbs, depths, opacities = [], [], []
    for b in range(pose_w2c.shape[0]):
        pose = torch.as_tensor(np.asarray(pose_w2c[b:b + 1]), **f32)
        K = torch.as_tensor(np.asarray(intr[b:b + 1]), **f32)
        parts = []
        for start in range(0, H * W, chunk):
            idx = torch.arange(start, min(start + chunk, H * W), device=device)
            center, ray = rays.get_center_and_ray(pose, K, idx, W)          # [1,R,3]
            depth = sampling.sample_depth(1, len(idx), n_samples, depth_range,
                                          stratified=False, device=device)
            pts = center[..., None, :] + ray[..., None, :] * depth          # [1,R,K,3]
            d2 = torch.sum((pts[..., None, :] - mu) ** 2, dim=-1)           # [1,R,K,NB]
            w_raw = torch.exp(-0.5 * d2 / s ** 2)
            w = a * torch.clamp(w_raw - w_cut, min=0.0) / (1.0 - w_cut)
            sigma = torch.sum(w, dim=-1)
            wc = w_raw + 1e-8
            rgb = torch.sum(wc[..., None] * c, dim=-2) / torch.sum(wc, -1)[..., None]
            if tex is not None:
                rgb = rgb * (1.0 + amp * torch.sin(fx * pts[..., 0])
                             * torch.sin(fy * pts[..., 1] + 1.3)
                             * torch.sin(fz * pts[..., 2] + 2.1))[..., None]
            out_rgb, out_d, opac, _ = render.composite(ray, rgb, sigma, depth)
            if bd is None:
                parts.append((out_rgb + bgcolor * (1 - opac),
                              out_d + depth_range[1] * (1 - opac), opac))
                continue
            # ray-plane intersection: x = center + t*ray with (x-p).n = 0
            denom = torch.sum(ray * bd["normal"], dim=-1)
            t = torch.sum((bd["point"] - center) * bd["normal"], dim=-1) / torch.where(
                torch.abs(denom) < 1e-6, torch.full_like(denom, 1e-6), denom)
            hit = center + t[..., None] * ray
            uu = torch.sum((hit - bd["point"]) * bd["u"], dim=-1)
            vv = torch.sum((hit - bd["point"]) * bd["v"], dim=-1)
            col = 0.5 * torch.ones(uu.shape + (3,), **f32)
            for o in range(3):
                f = bd["freqs"][o]                                          # [3,2]
                col = col + float(backdrop["amps"][o]) * torch.sin(
                    uu[..., None] * f[:, 0] + vv[..., None] * f[:, 1] + bd["phases"][o])
            if "spot_uv" in bd:
                d2s = (uu[..., None] - bd["spot_uv"][:, 0]) ** 2 \
                    + (vv[..., None] - bd["spot_uv"][:, 1]) ** 2              # [1,R,S]
                wspot = torch.exp(-0.5 * d2s / bd["spot_s"] ** 2)
                col = col + wspot @ bd["spot_c"]
            col = torch.clamp(col, 0.02, 0.98)
            parts.append((out_rgb + col * (1 - opac), out_d + t[..., None] * (1 - opac), opac))
        rgbs.append(torch.cat([p[0] for p in parts], 1).reshape(H, W, 3).cpu().numpy())
        depths.append(torch.cat([p[1] for p in parts], 1).reshape(H, W).cpu().numpy())
        opacities.append(torch.cat([p[2] for p in parts], 1).reshape(H, W).cpu().numpy())
    return np.stack(rgbs), np.stack(depths), np.stack(opacities)


def quantize(images):
    """Float images through uint8 and back, as a PNG written and read by the
    loaders: (clip(x, 0, 1) * 255) truncated to uint8, then / 255 in float32."""
    img8 = (np.clip(images, 0, 1) * 255).astype(np.uint8)
    return img8.astype(np.float32) / 255.0


def _intrinsics(focal, raw_H, raw_W, H, W, n):
    """[n,3,3] intrinsics as ``Dataset.preprocess_camera`` scales them to
    H x W (no center crop)."""
    intr = np.array([[focal, 0, raw_W / 2],
                     [0, focal, raw_H / 2],
                     [0, 0, 1]], dtype=np.float32)
    intr[0] *= W / raw_W
    intr[1] *= H / raw_H
    return np.tile(intr[None], (n, 1, 1))


def _split(images, intr, pose):
    return dict(image=quantize(images), intr=intr.astype(np.float32),
                pose=np.asarray(pose, np.float32),
                idx=np.arange(len(pose), dtype=np.int32))


# ------------------------------------------------------------------ LLFF

def wide_llff_poses_bounds(n_images=40, seed=0, spread=0.5):
    """The ``poses_bounds.npy`` rows [N,17] of a WIDER forward-facing camera
    cluster (so identity pose init has a meaningfully large error to
    recover); make_wide_llff_scene's draw."""
    rng = np.random.RandomState(seed)
    raw_H, raw_W = LLFF_RAW_HW
    rows = []
    for _ in range(n_images):
        eye = np.array([spread * rng.randn(), spread * rng.randn(),
                        4.0 + 0.6 * spread * rng.randn()])
        c2w = look_at_c2w(eye, target=(0.3 * spread * rng.randn(),
                                       0.3 * spread * rng.randn(), 0))
        raw = c2w.copy()
        raw[..., 0], raw[..., 1] = -c2w[..., 1], c2w[..., 0]
        hwf = np.array([raw_H, raw_W, LLFF_FOCAL], np.float32)[:, None]
        rows.append(np.concatenate([np.concatenate([raw, hwf], axis=1).reshape(-1),
                                    np.array([2.0 + rng.rand() * 0.1, 8.0])]))
    return np.stack(rows)


def look_at_point(pose):
    """(target, dist, look) of w2c poses [B,3,4]: the least-squares
    intersection of the view axes (the cameras' common look-at point), the
    mean distance of the camera centers from it, and each camera's viewing
    direction [B,3]."""
    R, t = pose[:, :, :3], pose[:, :, 3]
    centers = -np.einsum("bij,bi->bj", R, t)                # c2w centers
    look = R[:, 2, :]                                       # c2w z-axis rows
    P = np.eye(3)[None] - look[:, :, None] * look[:, None, :]
    A = P.sum(0) + 1e-4 * np.eye(3)
    b = np.einsum("bij,bj->i", P, centers)
    target = np.linalg.solve(A, b)
    dist = float(np.mean(np.linalg.norm(target - centers, axis=-1)))
    return target, dist, look


def llff_cameras(poses_bounds, img_size, val_ratio):
    """(train, val) of dict(intr, pose) as the LLFF loader splits and parses
    ``poses_bounds``: the last int(N * val_ratio) views are the val split."""
    H, W = img_size
    poses_raw, _, focal = llff.parse_poses_bounds(poses_bounds, *LLFF_RAW_HW)
    pose = np.stack([llff.raw_to_w2c(p) for p in poses_raw])
    intr = _intrinsics(focal, *LLFF_RAW_HW, H, W, len(pose))
    num_val = int(len(pose) * val_ratio)
    cut = slice(None, -num_val), slice(-num_val, None)
    return tuple(dict(intr=intr[s], pose=pose[s]) for s in cut)


def blob_llff_scene(n_images=40, seed=0, spread=0.5, n_blobs=24, val_ratio=0.1,
                    backdrop=False, dense=False):
    """The cameras and content of ``blob_llff_arrays``'s scene, unrendered:
    dict(poses_bounds [N,17], blob, backdrop (or None), depth_range,
    val_ratio). The blob slab is placed in the PARSED world frame (after the
    loader's centering + bounds rescale) at the training cameras'
    least-squares common look-at point."""
    poses_bounds = wide_llff_poses_bounds(n_images, seed, spread)
    train, _ = llff_cameras(poses_bounds, LLFF_RAW_HW, val_ratio)
    target, dist, look = look_at_point(train["pose"])
    if dense:
        # full-frame 3D structure at many depths: breaks both the
        # empty-space memorization gauge AND the planar ambiguity
        blob = blob_params(seed=seed + 11, n_blobs=n_blobs, center=tuple(target),
                           radius=1.25, axis_scale=(1.7, 1.3, 0.9),
                           s_range=(0.10, 0.26))
    else:
        blob = blob_params(seed=seed + 11, n_blobs=n_blobs, center=tuple(target),
                           radius=0.9, axis_scale=(1.3, 1.0, 0.55),
                           s_range=(0.14, 0.32))
    near = max(0.3, dist - 1.6)
    bd = None
    if backdrop:
        # wall 1.4 units behind the blob slab, facing the cameras
        mean_look = look.mean(0)
        mean_look /= np.linalg.norm(mean_look)
        bd = backdrop_params(point=target + 1.4 * mean_look, normal=-mean_look,
                             seed=seed + 23)
    return dict(poses_bounds=poses_bounds, blob=blob, backdrop=bd,
                depth_range=(near, dist + 1.8), val_ratio=val_ratio)


def blob_llff_arrays(n_images=40, img_size=(240, 320), seed=0, spread=0.5,
                     n_blobs=24, val_ratio=0.1, backdrop=False, dense=False,
                     device="cpu"):
    """make_blob_llff_scene in memory (``blob_llff_scene`` rendered at
    ``img_size``). Returns (train arrays, val arrays, blob)."""
    H, W = img_size
    scene = blob_llff_scene(n_images, seed, spread, n_blobs, val_ratio, backdrop, dense)
    out = []
    for cams in llff_cameras(scene["poses_bounds"], img_size, val_ratio):
        imgs, _, _ = render_blobs(cams["pose"], cams["intr"], H, W, scene["blob"],
                                  depth_range=scene["depth_range"],
                                  backdrop=scene["backdrop"], device=device)
        out.append(_split(imgs, cams["intr"], cams["pose"]))
    return out[0], out[1], scene["blob"]


def write_llff_tree(scene, root, size, name="blobfern", device="cpu", max_elems=1 << 23):
    """Write ``scene`` (``blob_llff_scene``) as the LLFF tree
    ``<root>/<name>/{images/NNN.png, poses_bounds.npy}``, every view rendered
    at ``size`` (H, W) and quantized as ``quantize`` does, the PNGs through
    ``utils/image_io.write_png``. The LLFF loader reads it with
    ``data.root=<root> data.scene=<name>`` (and resizes it to
    ``data.image_size``). Returns the uint8 images written [N,H,W,3]."""
    H, W = size
    poses_raw, _, focal = llff.parse_poses_bounds(scene["poses_bounds"], *LLFF_RAW_HW)
    pose = np.stack([llff.raw_to_w2c(p) for p in poses_raw])
    intr = _intrinsics(focal, *LLFF_RAW_HW, H, W, len(pose))
    imgs, _, _ = render_blobs(pose, intr, H, W, scene["blob"], depth_range=scene["depth_range"],
                              backdrop=scene["backdrop"], device=device, max_elems=max_elems)
    img8 = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
    path = os.path.join(root, name)
    os.makedirs(os.path.join(path, "images"), exist_ok=True)
    for i, img in enumerate(img8):
        image_io.write_png(os.path.join(path, "images", "{:03d}.png".format(i)), img)
    np.save(os.path.join(path, "poses_bounds.npy"), scene["poses_bounds"])
    return img8


# --------------------------------------------------------------- Blender

def blender_c2w(n_train=6, n_val=2, radius=4.0, seed=0):
    """dict split -> [n,4,4] float32 ``transform_matrix`` of
    make_blender_scene's train and val cameras (drawn in that order; its
    test cameras come after them)."""
    rng = np.random.RandomState(seed)
    out = {}
    for split, n in (("train", n_train), ("val", n_val)):
        mats = []
        for _ in range(n):
            theta = rng.rand() * 2 * np.pi
            phi = 0.3 + rng.rand() * 0.5
            eye = radius * np.array([np.cos(theta) * np.cos(phi), np.sin(phi),
                                     np.sin(theta) * np.cos(phi)])
            mats.append(np.concatenate([look_at_c2w(eye), [[0, 0, 0, 1]]], axis=0))
        out[split] = np.array(mats, np.float32).reshape(n, 4, 4)
    return out


def blob_blender_arrays(n_train=100, n_val=4, img_size=128, seed=0,
                        n_blobs=24, radius=1.2, depth_range=(2.0, 6.0),
                        s_range=(0.16, 0.38), device="cpu"):
    """make_blob_blender_scene in memory (white background, opaque alpha).
    A DENSE ball (n_blobs >~ 150, wider s_range) approximates a solid
    textured object, as the INN-warp recovery probes need. Returns (train
    arrays, val arrays, blob)."""
    mats = blender_c2w(n_train, n_val, seed=seed)
    blob = blob_params(seed=seed + 7, n_blobs=n_blobs, radius=radius, s_range=s_range)
    focal = blender.focal_length({"camera_angle_x": BLENDER_CAMERA_ANGLE_X}, BLENDER_RAW_W)
    out = []
    for split in ("train", "val"):
        pose = np.stack([blender.raw_to_w2c(m) for m in mats[split]])
        intr = _intrinsics(focal, BLENDER_RAW_W, BLENDER_RAW_W, img_size, img_size, len(pose))
        imgs, _, _ = render_blobs(pose, intr, img_size, img_size, blob,
                                  depth_range=depth_range, device=device)
        out.append(_split(imgs, intr, pose))
    return out[0], out[1], blob


# ------------------------------------------------------------------- DTU

DTU_SCALE = 300.0
DTU_TRANS_OFFSET = np.array([3.0, -2.0, 5.0])
DTU_RAW_HW = (1200, 1600)


def dtu_ring_poses(n_views=49, seed=0, radius=3.2, theta_span=80.0):
    """DTU-like inward-facing camera arc (OpenCV convention, c2w z toward
    the scene), the geometry of a DTU robot-arm scan: cameras on a wobbly
    arc at about constant distance, all looking at the table center.
    Returns c2w [N,3,4] float64."""
    rng = np.random.RandomState(seed)
    c2ws = []
    for i in range(n_views):
        theta = np.deg2rad(theta_span * (i / (n_views - 1) - 0.5))
        phi = np.deg2rad(20 + 12 * np.sin(3.0 * theta) + 2 * rng.randn())
        r = radius + 0.12 * rng.randn()
        eye = np.array([r * np.sin(theta) * np.cos(phi),
                        r * np.sin(phi),
                        -r * np.cos(theta) * np.cos(phi)])
        target = np.array([0.05 * rng.randn(), 0.05 * rng.randn(), 0.0])
        c2ws.append(_look_at_opencv(eye, target))
    return np.stack(c2ws)


def _look_at_opencv(eye, target):
    """c2w [3,4] float64 of a camera at ``eye`` whose z axis points at
    ``target`` (OpenCV convention, y down-ish from the world's +y up)."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x_ax = np.cross([0.0, 1.0, 0.0], z)
    x_ax /= np.linalg.norm(x_ax)
    y_ax = np.cross(z, x_ax)
    return np.concatenate([np.stack([x_ax, y_ax, z], axis=1), eye[:, None]], axis=1)


def _w2c(c2w):
    """w2c [3,4] float32 of c2w [3,4] float64, inverted in float64."""
    return np.linalg.inv(np.concatenate([c2w, [[0, 0, 0, 1]]], 0))[:3].astype(np.float32)


def dtu_loader_w2c(c2w):
    """The w2c pose [3,4] float32 the DTU loader parses from the projection
    matrix of c2w [3,4] written at DTU's raw scale (translation x300 plus
    ``DTU_TRANS_OFFSET``, the offset in ``scale_mat``): c2w in float32, the
    offset taken off and the 1/300 applied in the loader's order, inverted
    in float32 (data/dtu.py, ``load_scene_data``)."""
    pose_c2w = np.eye(4, dtype=np.float32)
    pose_c2w[:3, :3] = c2w[:, :3]
    pose_c2w[:3, 3] = DTU_SCALE * c2w[:, 3] + DTU_TRANS_OFFSET
    pose_c2w[:3, 3:] -= DTU_TRANS_OFFSET[:, None]
    pose_c2w[:3, 3:] *= dtu.SCALING_FACTOR
    return np.linalg.inv(pose_c2w)[:3].astype(np.float32)


def dtu_scene(n_images=49, img_size=(150, 200), seed=0):
    """The cameras and content of make_blob_dtu_scene: dict(render_pose
    (the generation w2c [N,3,4] float32 the views are rendered from), pose
    (the loader's parse of them), intr [N,3,3], blob (50 medium textured
    blobs and 40 small opaque dots), backdrop (a wall at z=1.6 with 800
    colour spots), n_samples and depth_range (256 in [1.2, 6.2]), as
    ``render_views`` reads them)."""
    H, W = img_size
    f = 1.1 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float64)
    c2ws = dtu_ring_poses(n_views=n_images, seed=seed)
    body = blob_params(seed=seed + 7, n_blobs=50, radius=1.2,
                       axis_scale=(1.2, 1.0, 1.3), s_range=(0.09, 0.22))
    body["a"] = body["a"] * 4.0
    dots = blob_params(seed=seed + 19, n_blobs=40, radius=1.45,
                       axis_scale=(1.2, 1.0, 1.3), s_range=(0.03, 0.06))
    dots["a"] = dots["a"] * 40.0
    blob = {k: np.concatenate([body[k], dots[k]]) for k in ("mu", "s", "a", "c")}
    blob["tex"] = dict(freq=(9.0, 8.0, 10.0), amp=0.35)
    bd = backdrop_params(point=(0, 0, 1.6), normal=(0, 0, -1.0), seed=seed + 23)
    trng = np.random.RandomState(seed + 13)
    n_spots = 800
    bd["spot_uv"] = (trng.rand(n_spots, 2).astype(np.float32) - 0.5) * 10.0
    bd["spot_s"] = (0.015 + 0.03 * trng.rand(n_spots)).astype(np.float32)
    bd["spot_c"] = ((trng.rand(n_spots, 3) - 0.5) * 1.6).astype(np.float32)
    return dict(render_pose=np.stack([_w2c(c) for c in c2ws]),
                pose=np.stack([dtu_loader_w2c(c) for c in c2ws]),
                intr=np.tile(K.astype(np.float32), (n_images, 1, 1)), blob=blob, backdrop=bd,
                n_samples=256, depth_range=(1.2, 6.2))


def render_views(scene, img_size, views, device="cpu", max_elems=1 << 23):
    """(rgb, depth, opacity) of the views ``views`` (indices into its
    cameras) of a scene of ``dtu_scene``, ``iphone_scene`` or
    ``tandt_scene``, as its maker renders them. Each view is rendered on
    its own, so a view comes out the same alone as among the others."""
    views = list(views)
    return render_blobs(scene["render_pose"][views], scene["intr"][views], *img_size,
                        scene["blob"], n_samples=scene["n_samples"],
                        depth_range=scene["depth_range"], backdrop=scene["backdrop"],
                        device=device, max_elems=max_elems)


def dtu_maps(depth, opacity):
    """The DTU loader's per-pixel maps of rendered depth and opacity:
    depth_gt (through the PFM's x300 and the loader's /300, in float32),
    valid_depth_gt (depth > 0) and fg_mask (opacity > 0.5, the IDR mask)."""
    depth_gt = (depth.astype(np.float32) * np.float32(DTU_SCALE)) \
        * np.float32(dtu.SCALING_FACTOR)
    return dict(depth_gt=depth_gt, valid_depth_gt=(depth_gt > 0).astype(np.float32),
                fg_mask=(opacity > 0.5).astype(np.float32))


def write_pfm(path, depth):
    """``depth`` [H,W] as a grayscale little-endian PFM, bottom row first
    (what ``dtu.read_pfm`` reads back)."""
    depth = np.asarray(depth, np.float32)
    with open(path, "wb") as fh:
        fh.write(b"Pf\n")
        fh.write("{} {} \n".format(depth.shape[1], depth.shape[0]).encode())
        fh.write(b"-1.0\n")
        np.flipud(depth).astype("<f4").tofile(fh)


def write_dtu_tree(root, n_images=17, size=DTU_RAW_HW, seed=0, scan="scan1", device="cpu",
                   max_elems=1 << 23):
    """Write ``dtu_scene(n_images, size, seed)`` in DTU's file layout, as
    tests/synth_data.py's ``make_dtu_scene`` lays it out, for the DTU
    loader (``data.root=<root> data.scene=<scan>``):

    * ``rs_dtu_4/DTU/<scan>/cameras.npz``: ``world_mat_i`` = [K [R|t]; 0 0 0 1]
      of each camera at DTU's raw scale (its centre x300 plus
      ``DTU_TRANS_OFFSET``) and ``scale_mat_i`` (diag 300 and the offset);
    * ``rs_dtu_4/DTU/<scan>/image/NNNNNN.png``: the view, through uint8 as
      ``quantize`` has it;
    * ``submission_data/idrmasks/<scan>/NNN.png``: the IDR mask (opacity >
      0.5) as RGB 0 / 255;
    * ``Depths/<scan>/depth_map_NNNN.pfm``: the z-depth x300.

    Each view is rendered at ``size`` (H, W; DTU's raw 1200x1600 by default)
    on ``device`` and written before the next. Returns the scene."""
    scene = dtu_scene(n_images, size, seed)
    K = scene["intr"][0].astype(np.float64)
    scan_dir = os.path.join(root, "rs_dtu_4", "DTU", scan)
    dirs = dict(image=os.path.join(scan_dir, "image"),
                mask=os.path.join(root, "submission_data", "idrmasks", scan),
                depth=os.path.join(root, "Depths", scan))
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    cams = {}
    scale_mat = np.diag([DTU_SCALE, DTU_SCALE, DTU_SCALE, 1.0])
    scale_mat[:3, 3] = DTU_TRANS_OFFSET
    for i, c2w in enumerate(dtu_ring_poses(n_views=n_images, seed=seed)):
        c2w_raw = np.concatenate([c2w, [[0.0, 0, 0, 1]]], 0)
        c2w_raw[:3, 3] = DTU_SCALE * c2w[:, 3] + DTU_TRANS_OFFSET
        cams["world_mat_{}".format(i)] = np.concatenate(
            [K @ np.linalg.inv(c2w_raw)[:3], [[0.0, 0, 0, 1]]], 0)
        cams["scale_mat_{}".format(i)] = scale_mat
    np.savez(os.path.join(scan_dir, "cameras.npz"), **cams)
    for i in range(n_images):
        rgb, depth, opacity = render_views(scene, size, [i], device, max_elems)
        image_io.write_png(os.path.join(dirs["image"], "{:06d}.png".format(i)),
                           (np.clip(rgb[0], 0, 1) * 255).astype(np.uint8))
        mask = np.where(opacity[0] > 0.5, 255, 0).astype(np.uint8)
        image_io.write_png(os.path.join(dirs["mask"], "{:03d}.png".format(i)),
                           np.repeat(mask[..., None], 3, -1))
        write_pfm(os.path.join(dirs["depth"], "depth_map_{:04d}.pfm".format(i)),
                  depth[0].astype(np.float32) * np.float32(DTU_SCALE))
    return scene


def blob_dtu_arrays(n_images=49, img_size=(150, 200), seed=0, widen=0.15, dtuhold=8,
                    device="cpu"):
    """make_blob_dtu_scene in memory: a ``n_images``-view inward camera arc
    over an opaque textured blob cluster before a spotted wall. Returns
    (train arrays, test arrays, scene) in the layout the DTU loader gives
    ``DTUMixin.attach_data``, every ``dtuhold``-th view in the test split
    (``dtu.split_indices``): image (through uint8, as the PNGs), intr, pose
    (the loader's parse), idx, ``dtu_maps``' depth_gt, valid_depth_gt and
    fg_mask, and depth_range [1.2 (1 - widen), 5.2 (1 + widen)]."""
    scene = dtu_scene(n_images, img_size, seed)
    rgb, depth, opacity = render_views(scene, img_size, range(n_images), device)
    maps = dtu_maps(depth, opacity)
    depth_range = np.array([dtu.NEAR_DEPTH * (1 - widen), dtu.FAR_DEPTH * (1 + widen)],
                           np.float32)
    out = []
    for split in ("train", "test"):
        idx = dtu.split_indices(None, n_images, dtuhold)[split]
        arrays = _split(rgb[idx], scene["intr"][idx], scene["pose"][idx])
        arrays.update({k: v[idx] for k, v in maps.items()},
                      depth_range=np.tile(depth_range, (len(idx), 1)))
        out.append(arrays)
    return out[0], out[1], scene


# ---------------------------------------------------------------- iPhone

def iphone_true_w2c(n_images=24, path_scale=1.0):
    """The generation w2c poses [N,3,4] float32 of make_blob_iphone_scene's
    video: a slow orbit with a handheld bob, always looking at the blob
    cloud (OpenCV convention). ``path_scale`` shrinks the excursion (1.0:
    a wide orbit, ~8.6 deg mean pairwise rotation; 0.35: a slow pan)."""
    poses = []
    for i in range(n_images):
        t = i / (n_images - 1)
        eye = np.array([0.9 * path_scale * np.sin(1.6 * t * np.pi),
                        0.15 * path_scale * np.sin(2.3 * t * np.pi + 0.4),
                        4.0 + 0.4 * path_scale * np.sin(0.9 * t * np.pi)])
        target = np.array([0.15 * np.sin(2 * t * np.pi), 0.0, 0.0])
        poses.append(_w2c(_look_at_opencv(eye, target)))
    return np.stack(poses)


def iphone_scene(n_images=24, img_size=(108, 192), seed=0, n_blobs=40, path_scale=1.0,
                 val_ratio=0.1):
    """The cameras and content of make_blob_iphone_scene: dict(render_pose
    (the true w2c of every frame), intr (the iPhone loader's), blob (a blob
    cloud), backdrop (a textured wall), n_samples and depth_range (192 in
    [2.2, 6.2]), splits (the frames of train and val: the last
    int(N * val_ratio) are the validation split, ``iphone.split_frames``))."""
    H, W = img_size
    raw_H, raw_W = iphone.RAW_HW
    frames = np.arange(n_images)
    return dict(render_pose=iphone_true_w2c(n_images, path_scale),
                intr=_intrinsics(iphone.focal_length(raw_W), raw_H, raw_W, H, W, n_images),
                blob=blob_params(seed=seed + 31, n_blobs=n_blobs, radius=1.15,
                                 axis_scale=(1.5, 1.1, 0.7), s_range=(0.12, 0.30)),
                backdrop=backdrop_params(point=(0.0, 0.0, -1.7), normal=(0.0, 0.0, 1.0),
                                         seed=seed + 23),
                n_samples=192, depth_range=(2.2, 6.2),
                splits={s: iphone.split_frames(frames, val_ratio, s) for s in ("train", "val")})


def blob_iphone_arrays(n_images=24, img_size=(108, 192), seed=0, n_blobs=40,
                       path_scale=1.0, val_ratio=0.1, device="cpu"):
    """make_blob_iphone_scene in memory: an unposed video of a blob cloud
    before a textured wall, rendered at the iPhone loader's intrinsics
    (``iphone_scene``). Returns (train arrays, val arrays, true w2c [N,3,4]
    of every frame): the arrays carry the loader's identity poses."""
    scene = iphone_scene(n_images, img_size, seed, n_blobs, path_scale, val_ratio)
    imgs, _, _ = render_views(scene, img_size, range(n_images), device)
    identity = np.tile(np.eye(3, 4, dtype=np.float32), (n_images, 1, 1))
    train, val = (_split(imgs[f], scene["intr"][f], identity[f])
                  for f in (scene["splits"][s] for s in ("train", "val")))
    return train, val, scene["render_pose"]


# ------------------------------------------------------ Tanks and Temples

TANDT_RAW_HW = (540, 960)
TANDT_FOCAL = 800.0


def tandt_poses_bounds(n_images=24, seed=0, arc_scale=1.0):
    """The ``poses_bounds.npy`` rows [N,17] of make_blob_tandt_scene's
    forward-facing walk-through arc (``arc_scale`` 1.0: a 69 deg spread;
    0.1: a gentle ~7 deg pan)."""
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n_images):
        th = (i / n_images - 0.5) * 1.2 * arc_scale
        eye = np.array([2.5 * np.sin(th), 0.3 + 0.05 * rng.randn(), 2.5 * np.cos(th)])
        c2w = look_at_c2w(eye)
        raw = c2w.copy()
        raw[..., 0], raw[..., 1] = -c2w[..., 1], c2w[..., 0]
        hwf = np.array([*TANDT_RAW_HW, TANDT_FOCAL], np.float32)[:, None]
        rows.append(np.concatenate([np.concatenate([raw, hwf], axis=1).reshape(-1),
                                    np.array([1.5 + rng.rand() * 0.1, 6.0])]))
    return np.stack(rows)


def tandt_scene(n_images=24, img_size=(180, 320), seed=0, n_blobs=40, arc_scale=1.0,
                val_ratio=8):
    """The cameras and content of make_blob_tandt_scene: dict(render_pose
    (the Tanks-and-Temples loader's parse of the walk-through arc: LLFF's
    parse at 540x960, then NoPe's spherification), intr, blob (a blob slab
    past the training cameras' look-at point at ~2.2x its distance),
    backdrop (a textured wall at ~3x), n_samples and depth_range (192
    inside barf_llff's inverse-depth sampling range), splits (NoPe's,
    ``tandt.split_indices``))."""
    H, W = img_size
    poses_raw, bounds, focal = llff.parse_poses_bounds(
        tandt_poses_bounds(n_images, seed, arc_scale), *TANDT_RAW_HW)
    poses_raw, _ = tandt.spherify_poses(poses_raw, bounds)
    pose = np.stack([llff.raw_to_w2c(p) for p in poses_raw])
    splits = tandt.split_indices(n_images, val_ratio)
    target, dist, look = look_at_point(pose[splits["train"]])
    mean_look = look.mean(0)
    mean_look /= np.linalg.norm(mean_look)
    return dict(render_pose=pose, intr=_intrinsics(focal, *TANDT_RAW_HW, H, W, n_images),
                blob=blob_params(seed=seed + 17, n_blobs=n_blobs,
                                 center=tuple(target + 1.2 * dist * mean_look),
                                 radius=0.5 * dist, axis_scale=(1.5, 1.1, 0.8),
                                 s_range=(0.10, 0.26)),
                backdrop=backdrop_params(point=target + 2.0 * dist * mean_look,
                                         normal=-mean_look, seed=seed + 23),
                n_samples=192, depth_range=(max(0.2, 1.35 * dist), 3.3 * dist),
                splits=splits)


def blob_tandt_arrays(n_images=24, img_size=(180, 320), seed=0, n_blobs=40,
                      arc_scale=1.0, val_ratio=8, device="cpu"):
    """make_blob_tandt_scene in memory (``tandt_scene``), its train and val
    splits rendered. Returns (train arrays, val arrays, blob)."""
    scene = tandt_scene(n_images, img_size, seed, n_blobs, arc_scale, val_ratio)
    out = []
    for split in ("train", "val"):
        idx = scene["splits"][split]
        imgs, _, _ = render_views(scene, img_size, idx, device)
        out.append(_split(imgs, scene["intr"][idx], scene["render_pose"][idx]))
    return out[0], out[1], scene["blob"]


# ------------------------------------------------------ the probes' scenes

# tools/probe_zoo_r4.py's scenes: the scene maker, its arguments, and the
# loader options (data.scene, data.image_size[, data.val_ratio]) its files
# are read with
PROBE_SCENES = {
    "llff": (blob_llff_arrays, dict(n_images=40, img_size=(240, 320), n_blobs=24,
                                    val_ratio=0.1, backdrop=True, spread=0.5)),
    "blender": (blob_blender_arrays, dict(n_train=100, n_val=4, img_size=128, n_blobs=24)),
    # content-rich: 160 overlapping blobs fill the frame, as the INN-warp
    # recovery probes need (the sparse ball is a degenerate gauge)
    "blender_dense": (blob_blender_arrays, dict(n_train=100, n_val=4, img_size=128,
                                                n_blobs=160, radius=1.3,
                                                s_range=(0.22, 0.45))),
    # GARF recovery: full-frame structure, a tighter forward-facing cluster
    "llff_garf": (blob_llff_arrays, dict(n_images=40, img_size=(240, 320), n_blobs=90,
                                         val_ratio=0.1, backdrop=True, spread=0.25,
                                         dense=True)),
    "llff_garf_tight": (blob_llff_arrays, dict(n_images=40, img_size=(240, 320),
                                               n_blobs=90, val_ratio=0.1, backdrop=True,
                                               spread=0.12, dense=True)),
}


def probe_scene_options(name):
    """The loader options a probe scene is read with, dotted (data.root
    aside, which names the directory its files would be in)."""
    make, kw = PROBE_SCENES[name]
    if make is blob_llff_arrays:
        return {"data.scene": "blobfern", "data.image_size": list(kw["img_size"]),
                "data.val_ratio": kw["val_ratio"]}
    return {"data.scene": "blobs", "data.image_size": [kw["img_size"]] * 2}


def probe_scene(name, device="cpu"):
    """(train arrays, val arrays, blob) of the probe scene ``name``."""
    make, kw = PROBE_SCENES[name]
    return make(device=device, **kw)
