"""CPU measurements behind the planar path's gates in chip_smoke.py (no
card needed; the port only, torch on the CPU):

1. homography at 72x96 (5 patches of 36x36, a [null,64,64,64,3] neural
   image on 8 PE bands, homography.yaml's noise), 2,000 steps without c2f
   (as homography.yaml has it) and with c2f [0, 0.6]: the corner error at
   the start and the end;
2. homography at homography.yaml's widths: its step-0 warp gradient in
   float64 with the warps moved by 1e-12, 1e-10 and 1e-8, and the CPU's
   float32 gradient, each as max distance from the float64 one over its max.

    python3 tools/plain_chain_cpu_probe.py      (from the repository root)
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from neural_invertible_warp_tpu_torch.models import planar  # noqa: E402
from neural_invertible_warp_tpu_torch.ops import warp2d  # noqa: E402
from neural_invertible_warp_tpu_torch.planar_options import planar_options  # noqa: E402


def corner_errors():
    for c2f in (None, [0, 0.6]):
        opt = planar_options("homography")
        opt.data.update(image_size=[72, 96], patch_crop=[36, 36])
        opt.arch.layers = [None, 64, 64, 64, 3]
        opt.max_iter = 2000
        opt.barf_c2f = c2f
        system = planar.PlanarSystem(opt, "cpu", image=cs.make_planar_image(72, 96, 0))
        system.init_state(0)
        err0 = system.corner_error()
        for _ in range(opt.max_iter):
            system.train_step()
        print("72x96, c2f {}: corner error {:.4f} -> {:.4f} in {} steps".format(
            c2f, err0, system.corner_error(), opt.max_iter))


def warp_gradient_conditioning():
    opt = planar_options("homography")
    H, W = opt.data.image_size
    image = cs.make_planar_image(H, W, 0)

    def system(dtype, shift=0.0):
        s = planar.PlanarSystem(planar_options("homography"), "cpu", image=image)
        s.init_state(opt.seed or 0)
        if dtype == np.float64:
            s.image, s.warp_pert, s.xy_crop = (t.double() for t in (s.image, s.warp_pert,
                                                                     s.xy_crop))
            s.patches = planar.bilinear_sample(
                s.image, warp2d.warp_grid(s.xy_crop, s.warp_pert, opt.warp.type), H, W)
            s.graph.double()
        with torch.no_grad():
            s.graph.warp_param.add_(shift)
        s.optim.zero_grad()
        s.loss().backward()
        return s.graph.warp_param.grad.double()

    ref = system(np.float64)

    def rel(g):
        return float((g - ref).abs().max()) / float(ref.abs().max())
    for shift in (1e-12, 1e-10, 1e-8):
        print("full size, float64, warps + {:g}: warp gradient moves {:.2e} of max".format(
            shift, rel(system(np.float64, shift))))
    print("full size, float32 on the CPU: {:.2e} of max from float64".format(
        rel(system(np.float32))))


if __name__ == "__main__":
    torch.set_num_threads(4)
    corner_errors()
    warp_gradient_conditioning()
