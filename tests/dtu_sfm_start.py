"""The SfM start of the DTU probe's ``colmap`` row in both packages.

    JAX_PLATFORMS=cpu python tests/dtu_sfm_start.py [--n-images 49]
        [--size 150,200] [--threads 4] [--matches <run>/sfm/matches.npz]

Renders the blob DTU scene (``evidence.scenes.blob_dtu_arrays``) on the
CPU and runs the port's and the JAX package's ``compute_sfm_poses`` (the
ZNCC matcher, incremental SfM, as ``pose.init: colmap`` calls it) on its
training views. With ``--matches`` (the ``matches.npz`` a ``colmap`` run
dumps under its output's ``sfm/``), both packages' SfM also run on those
matches instead of their own. For each it prints the verified pairs and
correspondences, the registered views, whether the two packages' matches
and poses are identical, and the initial readout: the mean rotation error
(degrees) and translation error after the sim(3) fit the DTU systems make
(``_align_sfm_to_gt``, then ``evaluate_camera_alignment``'s alignment).
At the probe's 49 views of 150x200 the render takes ~15 minutes on 4
threads and each SfM ~2 minutes. Not collected by pytest.
"""

import argparse
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from neural_invertible_warp_tpu.utils import colmap_init as jax_colmap_init  # noqa: E402
from neural_invertible_warp_tpu_torch.evidence import scenes  # noqa: E402
from neural_invertible_warp_tpu_torch.ops import align  # noqa: E402
from neural_invertible_warp_tpu_torch.utils import colmap_init  # noqa: E402


def readout(init, gt, valid):
    """(rot deg, trans) of SfM poses as the DTU systems read them out."""
    idx = np.asarray(valid if len(valid) else np.arange(init.shape[0]))
    _, ssim = align.prealign_w2c_large_camera_systems(init[idx], gt[idx])
    init = align.apply_traj_align_ssim(init, ssim).astype(np.float32)
    aligned, _ = align.prealign_w2c_large_camera_systems(init, gt)
    R, t = align._pose_errors_np(aligned, gt)
    return float(np.rad2deg(np.mean(R))), float(np.mean(t))


def run_both(label, images, intr, gt, **kw):
    """Both packages' compute_sfm_poses on the same input; prints and
    returns {package: (poses, matches)}."""
    out = {}
    for name, module, extra in (("port", colmap_init, dict(device="cpu")),
                                ("jax", jax_colmap_init, {})):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            init, valid, excluded = module.compute_sfm_poses(
                images, intr, quant_px=1.0, save_dir=tmp, **kw, **extra)
            m = np.load(os.path.join(tmp, "matches.npz"))
            matches = {k: m[k] for k in m.files}
        init = np.asarray(init)
        rot, trans = readout(init, gt, valid)
        print("{} {}: {} pairs, {} correspondences, {} registered, excluded {}; start "
              "{!r} deg / {!r}; {:.1f} s".format(
                  label, name, len(matches), sum(len(v) for v in matches.values()),
                  len(valid), excluded, rot, trans, time.time() - t0), flush=True)
        out[name] = (init, matches)
    (p, pm), (j, jm) = out["port"], out["jax"]
    same = sorted(pm) == sorted(jm) and all(np.array_equal(pm[k], jm[k]) for k in pm)
    print("{}: matches identical {}; poses max abs difference {!r}".format(
        label, same, float(np.abs(p - j).max())), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-images", type=int, default=49)
    ap.add_argument("--size", default="150,200")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--matches", help="a matches.npz to run both packages' SfM on")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    H, W = (int(x) for x in args.size.split(","))
    t0 = time.time()
    train, _, _ = scenes.blob_dtu_arrays(args.n_images, (H, W), args.seed, widen=0.15)
    print("scene: {} training views at {}x{} rendered on the CPU in {:.1f} s".format(
        len(train["idx"]), H, W, time.time() - t0), flush=True)
    run_both("ZNCC on the CPU render", train["image"], train["intr"], train["pose"],
             matcher="zncc")
    if args.matches:
        m = np.load(args.matches)
        pairs = sorted(tuple(int(x) for x in k.split("_")) for k in m.files)

        def dumped(i, j, img_i, img_j):
            x = m["{}_{}".format(i, j)]
            return x[:, :2], x[:, 2:]
        run_both("the dumped matches", [np.zeros((H, W, 3))] * len(train["idx"]),
                 train["intr"], train["pose"], matcher=dumped, pairs=pairs)


if __name__ == "__main__":
    main()
