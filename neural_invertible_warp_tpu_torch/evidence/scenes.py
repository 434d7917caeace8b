"""The quality probes' synthetic scenes, in memory.

Copies of tests/synth_data.py's band-limited Gaussian-blob scene makers
that return the arrays ``Dataset.all_arrays`` would read back from the
files those write (image [B,H,W,3] float32 in [0,1], intr [B,3,3], pose
[B,3,4] w2c, idx [B] int32), per split, instead of writing PNGs:

* ``blob_llff_arrays``: the wide forward-facing LLFF cluster with the blob
  slab at the cameras' common look-at point (``backdrop``: a textured wall
  behind it; ``dense``: a thick frustum-filling blob cloud);
* ``blob_blender_arrays``: cameras on the r=4 sphere around a blob ball.

Poses come from the loaders' own parses (``data.llff.parse_poses_bounds``,
``data.blender.raw_to_w2c``), so they equal what the loaders read. Images
are rendered in torch on ``device`` (the blob field composited over
unjittered samples, as ``analytic_blob_render``) and quantized through
uint8 as the PNG round trip does; the loaders' same-size BICUBIC resize is
a copy. ``render_blobs`` also renders chip_smoke.py's SfM scene (a wall
with colour spots; its depth and opacity maps). ``PROBE_SCENES`` names the five scenes of the quality probes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import blender, llff
from ..ops import rays, render, sampling

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
    untruncated ones, composited over ``n_samples`` unjittered depths; where
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


def blob_llff_arrays(n_images=40, img_size=(240, 320), seed=0, spread=0.5,
                     n_blobs=24, val_ratio=0.1, backdrop=False, dense=False,
                     device="cpu"):
    """make_blob_llff_scene in memory: the blob slab is placed in the
    PARSED world frame (after the loader's centering + bounds rescale) at
    the cameras' least-squares common look-at point. Returns (train arrays,
    val arrays, blob)."""
    H, W = img_size
    train, val = llff_cameras(wide_llff_poses_bounds(n_images, seed, spread),
                              img_size, val_ratio)
    pose = train["pose"]                                    # w2c [B,3,4]
    R, t = pose[:, :, :3], pose[:, :, 3]
    centers = -np.einsum("bij,bi->bj", R, t)                # c2w centers
    look = R[:, 2, :]                                       # c2w z-axis rows
    # triangulate the common look-at point: least-squares intersection of the
    # view axes (the centered origin is the mean CAMERA position)
    P = np.eye(3)[None] - look[:, :, None] * look[:, None, :]
    A = P.sum(0) + 1e-4 * np.eye(3)
    b = np.einsum("bij,bj->i", P, centers)
    target = np.linalg.solve(A, b)
    dist = float(np.mean(np.linalg.norm(target - centers, axis=-1)))
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
    out = []
    for cams in (train, val):
        imgs, _, _ = render_blobs(cams["pose"], cams["intr"], H, W, blob,
                                  depth_range=(near, dist + 1.8), backdrop=bd, device=device)
        out.append(_split(imgs, cams["intr"], cams["pose"]))
    return out[0], out[1], blob


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
