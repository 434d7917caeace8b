"""COLMAP model-file interop (port of neural_invertible_warp_tpu/utils/
colmap_io.py, a copy: struct + numpy): read/write ``cameras``/``images``/
``points3D`` in COLMAP's binary and text formats.

A user with an EXISTING real COLMAP reconstruction can seed pose
initialization from it (``pose.init: colmap_files``), matching the semantics the reference gets from
`third_party/colmap_read_write_model.py` (consumed at
`utils/colmap_initialization/sfm.py:246-284`). Implemented from the COLMAP
binary format specification (src/colmap/scene/reconstruction_io.cc layout:
little-endian; cameras.bin = u64 count, then {i32 camera_id, i32 model_id,
u64 width, u64 height, f64 params[n]}; images.bin = u64 count, then
{i32 image_id, f64 qvec[4] (w,x,y,z), f64 tvec[3], i32 camera_id,
name\\0, u64 n_points2D, {f64 x, f64 y, i64 point3D_id}*}; points3D.bin =
u64 count, then {i64 id, f64 xyz[3], u8 rgb[3], f64 error, u64 track_len,
{i32 image_id, i32 point2D_idx}*}), not ported from the reference's reader.
"""

from __future__ import annotations

import collections
import os
import struct

import numpy as np

Camera = collections.namedtuple("Camera", ["id", "model", "width", "height",
                                           "params"])
Image = collections.namedtuple("Image", ["id", "qvec", "tvec", "camera_id",
                                         "name", "xys", "point3D_ids"])
Point3D = collections.namedtuple("Point3D", ["id", "xyz", "rgb", "error",
                                             "image_ids", "point2D_idxs"])

# model_id <-> (name, num_params), per COLMAP's camera model registry
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


def qvec2rotmat(qvec):
    """COLMAP (w,x,y,z) quaternion -> rotation matrix."""
    w, x, y, z = [float(v) for v in qvec]
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0.0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ])


def rotmat2qvec(R):
    """Rotation matrix -> COLMAP (w,x,y,z) quaternion (Shepperd's method)."""
    R = np.asarray(R, dtype=np.float64)
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0.0, 0.0, 0.0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0.0, 0.0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0.0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    if q[0] < 0:
        q = -q
    return q


# ------------------------------------------------------------------ binary IO

def _read(f, fmt):
    return struct.unpack("<" + fmt, f.read(struct.calcsize("<" + fmt)))


def _write(f, fmt, *vals):
    f.write(struct.pack("<" + fmt, *vals))


def _read_string(f):
    out = bytearray()
    while True:
        c = f.read(1)
        if not c or c == b"\x00":
            break
        out += c
    return out.decode("utf-8")


def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "d" * n_params))
            cameras[cam_id] = Camera(cam_id, name, width, height, params)
    return cameras


def write_cameras_binary(cameras, path):
    with open(path, "wb") as f:
        _write(f, "Q", len(cameras))
        for cam in cameras.values():
            model_id, n_params = CAMERA_MODEL_IDS[cam.model]
            assert len(cam.params) == n_params, (cam.model, len(cam.params))
            _write(f, "iiQQ", cam.id, model_id, cam.width, cam.height)
            _write(f, "d" * n_params, *[float(p) for p in cam.params])


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            (image_id,) = _read(f, "i")
            qvec = np.array(_read(f, "dddd"))
            tvec = np.array(_read(f, "ddd"))
            (camera_id,) = _read(f, "i")
            name = _read_string(f)
            (n_pts,) = _read(f, "Q")
            if n_pts:
                data = np.frombuffer(f.read(24 * n_pts),
                                     dtype=[("x", "<f8"), ("y", "<f8"),
                                            ("id", "<i8")])
                xys = np.stack([data["x"], data["y"]], axis=-1)
                p3d = data["id"].astype(np.int64)
            else:
                xys = np.zeros((0, 2))
                p3d = np.zeros((0,), np.int64)
            images[image_id] = Image(image_id, qvec, tvec, camera_id, name,
                                     xys, p3d)
    return images


def write_images_binary(images, path):
    with open(path, "wb") as f:
        _write(f, "Q", len(images))
        for im in images.values():
            _write(f, "i", im.id)
            _write(f, "dddd", *[float(v) for v in im.qvec])
            _write(f, "ddd", *[float(v) for v in im.tvec])
            _write(f, "i", im.camera_id)
            f.write(im.name.encode("utf-8") + b"\x00")
            _write(f, "Q", len(im.xys))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                _write(f, "ddq", float(x), float(y), int(pid))


def read_points3D_binary(path):
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            (pid,) = _read(f, "q")
            xyz = np.array(_read(f, "ddd"))
            rgb = np.array(_read(f, "BBB"), dtype=np.uint8)
            (error,) = _read(f, "d")
            (track_len,) = _read(f, "Q")
            track = np.frombuffer(f.read(8 * track_len),
                                  dtype=[("im", "<i4"), ("pt", "<i4")])
            points[pid] = Point3D(pid, xyz, rgb, error,
                                  track["im"].astype(np.int64),
                                  track["pt"].astype(np.int64))
    return points


def write_points3D_binary(points, path):
    with open(path, "wb") as f:
        _write(f, "Q", len(points))
        for p in points.values():
            _write(f, "q", p.id)
            _write(f, "ddd", *[float(v) for v in p.xyz])
            _write(f, "BBB", *[int(v) for v in p.rgb])
            _write(f, "d", float(p.error))
            _write(f, "Q", len(p.image_ids))
            for im, pt in zip(p.image_ids, p.point2D_idxs):
                _write(f, "ii", int(im), int(pt))


# -------------------------------------------------------------------- text IO

def read_cameras_text(path):
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cam_id, model = int(el[0]), el[1]
            cameras[cam_id] = Camera(cam_id, model, int(el[2]), int(el[3]),
                                     np.array([float(v) for v in el[4:]]))
    return cameras


def write_cameras_text(cameras, path):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cameras.values():
            f.write("{} {} {} {} {}\n".format(
                cam.id, cam.model, cam.width, cam.height,
                " ".join(repr(float(p)) for p in cam.params)))


def read_images_text(path):
    images = {}
    with open(path) as f:
        body = [ln.rstrip("\n") for ln in f if not ln.startswith("#")]
    i = 0
    while i < len(body):
        if not body[i].strip():  # a 0-point image writes an empty 2nd line
            i += 1
            continue
        el = body[i].split()
        image_id = int(el[0])
        qvec = np.array([float(v) for v in el[1:5]])
        tvec = np.array([float(v) for v in el[5:8]])
        camera_id = int(el[8])
        name = el[9]
        pel = body[i + 1].split() if i + 1 < len(body) else []
        if pel:
            arr = np.array([float(v) for v in pel]).reshape(-1, 3)
            xys, p3d = arr[:, :2], arr[:, 2].astype(np.int64)
        else:
            xys = np.zeros((0, 2))
            p3d = np.zeros((0,), np.int64)
        images[image_id] = Image(image_id, qvec, tvec, camera_id, name,
                                 xys, p3d)
        i += 2
    return images


def write_images_text(images, path):
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in images.values():
            f.write("{} {} {} {}\n".format(
                im.id,
                " ".join(repr(float(v)) for v in list(im.qvec) + list(im.tvec)),
                im.camera_id, im.name))
            f.write(" ".join("{!r} {!r} {}".format(float(x), float(y), int(p))
                             for (x, y), p in zip(im.xys, im.point3D_ids)))
            f.write("\n")


def read_points3D_text(path):
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            pid = int(el[0])
            xyz = np.array([float(v) for v in el[1:4]])
            rgb = np.array([int(v) for v in el[4:7]], dtype=np.uint8)
            error = float(el[7])
            track = np.array([int(v) for v in el[8:]], dtype=np.int64)
            points[pid] = Point3D(pid, xyz, rgb, error, track[0::2],
                                  track[1::2])
    return points


def write_points3D_text(points, path):
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for p in points.values():
            track = " ".join("{} {}".format(int(im), int(pt))
                             for im, pt in zip(p.image_ids, p.point2D_idxs))
            f.write("{} {} {} {} {}\n".format(
                p.id, " ".join(repr(float(v)) for v in p.xyz),
                " ".join(str(int(v)) for v in p.rgb), repr(float(p.error)),
                track).rstrip() + "\n")


# ------------------------------------------------------------------ model API

def detect_model_format(path):
    for ext in (".bin", ".txt"):
        if all(os.path.isfile(os.path.join(path, n + ext))
               for n in ("cameras", "images")):
            return ext
    raise FileNotFoundError(
        "no COLMAP model (cameras/images .bin or .txt) in {}".format(path))


def read_model(path, ext=None):
    """Read a COLMAP model dir -> (cameras, images, points3D).

    points3D is optional on disk (pose seeding only needs images); an empty
    dict is returned when the file is absent.
    """
    ext = ext or detect_model_format(path)
    readers = dict(
        bin=(read_cameras_binary, read_images_binary, read_points3D_binary),
        txt=(read_cameras_text, read_images_text, read_points3D_text),
    )[ext.lstrip(".")]
    cameras = readers[0](os.path.join(path, "cameras" + ext))
    images = readers[1](os.path.join(path, "images" + ext))
    p3d_path = os.path.join(path, "points3D" + ext)
    points3D = readers[2](p3d_path) if os.path.isfile(p3d_path) else {}
    return cameras, images, points3D


def write_model(cameras, images, points3D, path, ext=".bin"):
    os.makedirs(path, exist_ok=True)
    writers = dict(
        bin=(write_cameras_binary, write_images_binary, write_points3D_binary),
        txt=(write_cameras_text, write_images_text, write_points3D_text),
    )[ext.lstrip(".")]
    writers[0](cameras, os.path.join(path, "cameras" + ext))
    writers[1](images, os.path.join(path, "images" + ext))
    writers[2](points3D, os.path.join(path, "points3D" + ext))


def image_w2c_pose(image):
    """COLMAP image -> [3,4] world-to-camera pose (R|t)."""
    return np.concatenate(
        [qvec2rotmat(image.qvec), np.asarray(image.tvec, np.float64)[:, None]],
        axis=1)


def poses_from_model(path, image_names=None, ext=None):
    """Seed poses from an existing COLMAP reconstruction.

    Mirrors the reference's get_poses_and_idx
    (utils/colmap_initialization/sfm.py:246-284): images matched by NAME in
    the given order; unreconstructed images get identity and are reported as
    excluded. With image_names=None, images are taken in image_id order.

    Returns: (poses_w2c [N,3,4] float32, valid_idx, excluded_idx).
    """
    _, images, _ = read_model(path, ext=ext)
    if image_names is None:
        ordered = [images[k] for k in sorted(images)]
        poses = np.stack([image_w2c_pose(im) for im in ordered]).astype(
            np.float32)
        return poses, list(range(len(ordered))), []
    by_name = {im.name: im for im in images.values()}
    poses, valid, excluded = [], [], []
    for i, name in enumerate(image_names):
        if name in by_name:
            poses.append(image_w2c_pose(by_name[name]))
            valid.append(i)
        else:
            poses.append(np.eye(3, 4))
            excluded.append(i)
    return np.stack(poses).astype(np.float32), valid, excluded


def intrinsics_from_camera(camera):
    """COLMAP camera -> [3,3] pinhole K (fx, fy, cx, cy; radial ignored)."""
    p = camera.params
    if camera.model == "SIMPLE_PINHOLE":
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    elif camera.model == "PINHOLE":
        fx, fy, cx, cy = p[:4]
    elif camera.model in ("SIMPLE_RADIAL", "SIMPLE_RADIAL_FISHEYE"):
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    elif camera.model in ("RADIAL", "RADIAL_FISHEYE", "FOV"):
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    elif camera.model in ("OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV",
                          "THIN_PRISM_FISHEYE"):
        fx, fy, cx, cy = p[:4]
    else:
        raise ValueError("unsupported camera model: {}".format(camera.model))
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)
