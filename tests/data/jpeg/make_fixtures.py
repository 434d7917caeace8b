"""Writes the JPEG fixtures of this directory and their ``manifest.json``.

    python tests/data/jpeg/make_fixtures.py

Needs PIL and cv2 (cv2 only for the sampling factors and restart intervals
Pillow does not write). Every file is encoded from a seeded image; the
manifest gives, for each, the call that made it, the shape of PIL's decode
and that decode's sha256 (``np.asarray(PIL.Image.open(f))``, unrotated), or,
for a mode the port does not decode, the mode its ValueError names. Also
writes ``llff/blobfern/``: the blob LLFF scene of chip_smoke.py's path
``cli`` (19 views, ``backdrop=True``) rendered at 240x320 and saved by PIL
at quality 90, beside its ``poses_bounds.npy``; ``llff_progressive/blobfern/``,
the same rendered views saved by PIL at quality 90 with
``progressive=True`` beside a copy of that ``poses_bounds.npy``; and
``large_1008x1344.jpg`` (the first view upscaled) to time the decoder on.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import sys
import tempfile

import cv2
import numpy as np
import PIL.Image

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, REPO)

LLFF_VIEWS = 19
LLFF_HW = (240, 320)


def content(h, w, seed, channels=3):
    """A smooth pattern plus noise, uint8 [h,w,channels]."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    phase = np.arange(channels)
    a = (128 + 70 * np.sin(xx[..., None] / 4.0 + phase) * np.cos(yy[..., None] / 6.0 - phase)
         + 40 * rng.randn(h, w, channels))
    return np.clip(a, 0, 255).astype(np.uint8)


def pil_jpeg(arr, **kw):
    img = PIL.Image.fromarray(arr[..., 0] if arr.shape[2] == 1 else arr)
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def cv2_jpeg(arr, params):
    ok, buf = cv2.imencode(".jpg", arr[..., ::-1] if arr.shape[2] == 3 else arr[..., 0], params)
    assert ok
    return buf.tobytes()


def exif_orientation_6():
    exif = PIL.Image.Exif()
    exif[0x0112] = 6
    return exif.tobytes()


def patched(data, old, new):
    """``data`` with the first ``old`` replaced by ``new``."""
    i = data.index(old)
    return data[:i] + new + data[i + len(old):]


# name -> (shape, seed, how: "pil" keyword arguments or "cv2" parameters, as text)
CASES = {
    "s444_37x53": ((37, 53, 3), 1, "pil", "quality=90, subsampling=0"),
    "s422_37x53": ((37, 53, 3), 2, "pil", "quality=90, subsampling=1"),
    "s420_37x53": ((37, 53, 3), 3, "pil", "quality=90, subsampling=2"),
    "s440_37x53": ((37, 53, 3), 4, "cv2", "[cv2.IMWRITE_JPEG_QUALITY, 90, "
                   "cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440]"),
    "s411_37x53": ((37, 53, 3), 5, "cv2", "[cv2.IMWRITE_JPEG_QUALITY, 90, "
                   "cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]"),
    "gray_37x53": ((37, 53, 1), 6, "pil", "quality=90"),
    "q50_48x64": ((48, 64, 3), 7, "pil", "quality=50"),
    "q75_48x64": ((48, 64, 3), 7, "pil", "quality=75"),
    "q95_48x64": ((48, 64, 3), 7, "pil", "quality=95"),
    "q100_48x64": ((48, 64, 3), 7, "pil", "quality=100"),
    "q100_444_48x64": ((48, 64, 3), 7, "pil", "quality=100, subsampling=0"),
    "optimize_48x64": ((48, 64, 3), 8, "pil", "quality=85, optimize=True"),
    "rst1_40x56": ((40, 56, 3), 9, "cv2",
                   "[cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 1]"),
    "rst3_gray_40x56": ((40, 56, 1), 10, "cv2",
                        "[cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 3]"),
    "rst2_444_40x56": ((40, 56, 3), 11, "cv2", "[cv2.IMWRITE_JPEG_QUALITY, 95, "
                       "cv2.IMWRITE_JPEG_RST_INTERVAL, 2, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, "
                       "cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]"),
    "s420_1x1": ((1, 1, 3), 12, "pil", "quality=90"),
    "s420_2x3": ((2, 3, 3), 13, "pil", "quality=90"),
    "s420_9x17": ((9, 17, 3), 14, "pil", "quality=90"),
    "s422_9x17": ((9, 17, 3), 15, "pil", "quality=90, subsampling=1"),
    "gray_9x17": ((9, 17, 1), 16, "pil", "quality=90"),
    "exif_orientation6_30x40": ((30, 40, 3), 17, "pil", "quality=90, exif=exif_orientation_6()"),
    "icc_30x40": ((30, 40, 3), 18, "pil", "quality=90, icc_profile=bytes(range(256)) * 8"),
    "comment_30x40": ((30, 40, 3), 19, "pil", "quality=90, comment=b'fixture'"),
    "adobe_rgb_30x40": ((30, 40, 3), 20, "pil", "quality=90, keep_rgb=True"),
    # progressive (SOF2): libjpeg's standard scan scripts, with and without
    # optimized tables and restart intervals
    "progressive_30x40": ((30, 40, 3), 21, "pil", "quality=90, progressive=True"),
    "prog_444_37x53": ((37, 53, 3), 25, "pil", "quality=90, subsampling=0, progressive=True"),
    "prog_422_37x53": ((37, 53, 3), 26, "pil", "quality=90, subsampling=1, progressive=True"),
    "prog_420_37x53": ((37, 53, 3), 27, "pil", "quality=90, subsampling=2, progressive=True, "
                       "optimize=True"),
    "prog_gray_37x53": ((37, 53, 1), 28, "pil", "quality=90, progressive=True, optimize=True"),
    "prog_q50_9x17": ((9, 17, 3), 29, "pil", "quality=50, progressive=True, optimize=True"),
    "prog_q100_1x1": ((1, 1, 3), 30, "pil", "quality=100, progressive=True"),
    "prog_rst1_40x56": ((40, 56, 3), 31, "cv2", "[cv2.IMWRITE_JPEG_QUALITY, 80, "
                        "cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 1]"),
    "prog_rst3_gray_40x56": ((40, 56, 1), 32, "cv2", "[cv2.IMWRITE_JPEG_QUALITY, 80, "
                             "cv2.IMWRITE_JPEG_PROGRESSIVE, 1, "
                             "cv2.IMWRITE_JPEG_RST_INTERVAL, 3]"),
    "prog_rst2_411_40x56": ((40, 56, 3), 33, "cv2", "[cv2.IMWRITE_JPEG_QUALITY, 95, "
                            "cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2, "
                            "cv2.IMWRITE_JPEG_SAMPLING_FACTOR, "
                            "cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]"),
    # modes the port does not decode
    "progressive_partial_30x40": ((30, 40, 3), 34, "patch", "progressive s420 with its last "
                                  "scan (luma AC 1-63, bit 0) cut"),
    "cmyk_30x40": ((30, 40, 3), 22, "pil-cmyk", "quality=90"),
    "arithmetic_30x40": ((30, 40, 3), 23, "patch", "s420 baseline with SOF0 rewritten as SOF9"),
    "12bit_30x40": ((30, 40, 3), 24, "patch", "s420 baseline with its SOF0 precision set to 12"),
    "lossless_30x40": ((30, 40, 3), 35, "patch", "s420 baseline with SOF0 rewritten as SOF3"),
    "hierarchical_30x40": ((30, 40, 3), 36, "patch", "s420 baseline with SOF0 rewritten as SOF5"),
    "2comp_30x40": ((30, 40, 3), 37, "patch", "s420 baseline with its third SOF0 component "
                    "dropped"),
}
RAISES = {"cmyk_30x40": "4-component", "arithmetic_30x40": "arithmetic-coded (SOF9)",
          "12bit_30x40": "12-bit samples (SOF0)",
          "progressive_partial_30x40": "block-smoothed progressive (SOF2",
          "lossless_30x40": "lossless (SOF3)", "hierarchical_30x40": "hierarchical (SOF5)",
          "2comp_30x40": "2-component"}


def encode(name):
    shape, seed, how, args = CASES[name]
    arr = content(*shape[:2], seed, shape[2])
    if how == "pil":
        return (eval("pil_jpeg(arr, {})".format(args)),
                "PIL.Image.fromarray(a).save(f, 'JPEG', {})".format(args))
    if how == "pil-cmyk":
        buf = io.BytesIO()
        PIL.Image.fromarray(arr).convert("CMYK").save(buf, "JPEG", quality=90)
        return buf.getvalue(), "PIL.Image.fromarray(a).convert('CMYK').save(f, 'JPEG', quality=90)"
    if how == "cv2":
        return cv2_jpeg(arr, eval(args)), "cv2.imencode('.jpg', a[..., ::-1], {})".format(args)
    if name.startswith("progressive_partial"):
        data = pil_jpeg(arr, quality=90, progressive=True)
        return data[:data.rindex(b"\xff\xda")] + b"\xff\xd9", args
    base = pil_jpeg(arr, quality=90)
    for prefix, sof in (("arithmetic", b"\xc9"), ("lossless", b"\xc3"), ("hierarchical", b"\xc5")):
        if name.startswith(prefix):
            return patched(base, b"\xff\xc0", b"\xff" + sof), args
    sof = base.index(b"\xff\xc0")
    if name.startswith("2comp"):
        # length 8 + 3 * 2, two components, the third's 3 bytes dropped
        return (base[:sof + 2] + (14).to_bytes(2, "big") + base[sof + 4:sof + 9] + b"\x02"
                + base[sof + 10:sof + 16] + base[sof + 19:]), args
    return base[:sof + 4] + bytes([12]) + base[sof + 5:], args


def record(path, data, made_by):
    entry = dict(file=os.path.relpath(path, HERE), made_by=made_by)
    try:
        dec = np.asarray(PIL.Image.open(io.BytesIO(data)))
        entry.update(shape=list(dec.shape), sha256=hashlib.sha256(dec.tobytes()).hexdigest())
    except OSError:
        pass
    return entry


def write_llff(manifest):
    import torch
    from neural_invertible_warp_tpu_torch.evidence import scenes
    torch.set_num_threads(os.cpu_count() or 1)
    out = os.path.join(HERE, "llff", "blobfern")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(os.path.join(out, "images"))
    scene = scenes.blob_llff_scene(n_images=LLFF_VIEWS, val_ratio=0.1, backdrop=True)
    with tempfile.TemporaryDirectory() as tmp:
        imgs = scenes.write_llff_tree(scene, tmp, LLFF_HW)
        shutil.copy(os.path.join(tmp, "blobfern", "poses_bounds.npy"), out)
    out_prog = os.path.join(HERE, "llff_progressive", "blobfern")
    shutil.rmtree(out_prog, ignore_errors=True)
    os.makedirs(os.path.join(out_prog, "images"))
    shutil.copy(os.path.join(out, "poses_bounds.npy"), out_prog)
    for folder, kw, args in ((out, {}, "quality=90"),
                             (out_prog, dict(progressive=True), "quality=90, progressive=True")):
        for i, img in enumerate(imgs):
            path = os.path.join(folder, "images", "{:03d}.jpg".format(i))
            data = pil_jpeg(img, quality=90, **kw)
            with open(path, "wb") as fh:
                fh.write(data)
            manifest.append(record(path, data, "scenes.write_llff_tree(scenes.blob_llff_scene("
                                   "n_images=19, val_ratio=0.1, backdrop=True), root, (240, "
                                   "320)) view {}, then PIL.Image.fromarray(a).save(f, 'JPEG', "
                                   "{})".format(i, args)))


def write_large(manifest):
    """LLFF view 0 upscaled (BICUBIC) to 1008x1344 and saved at quality 90:
    a frame large enough to time the decoder per megapixel."""
    path = os.path.join(HERE, "large_1008x1344.jpg")
    view = PIL.Image.open(os.path.join(HERE, "llff", "blobfern", "images", "000.jpg"))
    buf = io.BytesIO()
    view.resize((1344, 1008), PIL.Image.BICUBIC).save(buf, "JPEG", quality=90)
    with open(path, "wb") as fh:
        fh.write(buf.getvalue())
    manifest.append(record(path, buf.getvalue(), "PIL.Image.open('llff/blobfern/images/000.jpg')"
                           ".resize((1344, 1008), PIL.Image.BICUBIC).save(f, 'JPEG', "
                           "quality=90)"))


def main():
    manifest = []
    for name in CASES:
        data, made_by = encode(name)
        path = os.path.join(HERE, name + ".jpg")
        with open(path, "wb") as fh:
            fh.write(data)
        entry = record(path, data, made_by)
        if name in RAISES:
            entry = dict(file=entry["file"], made_by=made_by, raises=RAISES[name])
        manifest.append(entry)
    write_llff(manifest)
    write_large(manifest)
    with open(os.path.join(HERE, "manifest.json"), "w") as fh:
        fh.write("[\n" + ",\n".join(json.dumps(e) for e in manifest) + "\n]\n")
    total = sum(os.path.getsize(os.path.join(HERE, e["file"])) for e in manifest)
    print("{} files, {} bytes".format(len(manifest), total))


if __name__ == "__main__":
    main()
