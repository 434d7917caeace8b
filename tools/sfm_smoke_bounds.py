"""The port's SfM pose init on the CPU, on chip_smoke.py's pose_init_sfm
capture: the run that sets that path's bounds on the aligned pose errors.

    python tools/sfm_smoke_bounds.py [--spread] [--threads=8]

Renders chip_smoke.make_sfm_scene on the CPU (about 40 s per 300x400 view
with 8 threads), builds barf_inn_dtu with a tiny field (the field does not
take part in the SfM) and pose.init: colmap with the ZNCC matcher on the
CPU, and prints the registered views, the aligned mean rotation and
translation errors of the valid views (as the smoke computes them) and the
SfM's host seconds by stage. ``--spread`` takes SFM_VIEWS views spread over
the whole arc instead of the middle SFM_VIEWS of its 49.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main(argv):
    spread = "--spread" in argv
    threads = [int(a.split("=")[1]) for a in argv if a.startswith("--threads=")]
    torch.set_num_threads(threads[0] if threads else 8)
    from neural_invertible_warp_tpu_torch.barf_inn_dtu import barf_inn_dtu_options
    from neural_invertible_warp_tpu_torch.models import get_system_class
    from neural_invertible_warp_tpu_torch.ops import align
    H, W = cs.SFM_HW
    ring = cs.sfm_ring_poses
    if spread:
        cs.sfm_ring_poses = lambda n, H, W: ring(n, H, W, n_ring=n)
    render = cs.blob_render
    cs.blob_render = lambda *a, **k: render(*a, **dict(k, chunk=1024))
    t0 = time.time()
    scene = cs.make_sfm_scene(H, W, cs.SFM_VIEWS, torch.device("cpu"))
    print("rendered {} views at {}x{} in {:.0f} s".format(cs.SFM_VIEWS, H, W, time.time() - t0))
    opt = barf_inn_dtu_options()
    opt.update(H=H, W=W, output_path=os.path.join(cs.HERE, "build", "sfm_smoke_bounds"),
               max_iter=20)
    opt.arch.update(layers_feat=[None, 16, 16, 16], layers_rgb=[None, 8, 3], skip=[1])
    opt.inn.real_nvp.update(d_hidden=8, latent_dim=4)
    opt.nerf.update(rand_rays=cs.SFM_VIEWS * 4, sample_intvs=8)
    opt.pose.init = "colmap"
    system = get_system_class("barf_inn_dtu")(opt, "cpu")
    system.attach_data(scene, {k: v[:2] for k, v in scene.items()})
    t0 = time.time()
    with cs.sfm_stage_timers() as timers:
        system.init_state(0)
    valid, excluded = system.sfm_valid_idx, system.sfm_excluded
    va = np.asarray(valid)
    R_err, t_err = align._pose_errors_np(system.aux["initial_poses_w2c"].numpy()[va],
                                         scene["pose"][va])
    print("{} views{}: registered {} (excluded {}); aligned rotation error {:.4f} deg, "
          "translation {:.5f}; {} ZNCC pairs; host seconds: verification and tracks {:.2f}, "
          "bundle adjustment {:.2f}, reconstruction {:.2f}, in all {:.2f}".format(
              cs.SFM_VIEWS, " (spread over the arc)" if spread else " (middle of the arc)",
              len(valid), excluded, np.rad2deg(R_err.mean()), t_err.mean(), len(timers.pairs),
              timers.seconds["verify_and_track"], timers.seconds["ba"],
              timers.seconds["reconstruction"], time.time() - t0))


if __name__ == "__main__":
    main(sys.argv[1:])
