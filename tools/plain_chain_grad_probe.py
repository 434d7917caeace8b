"""Which fp32 operation sets the card's distance from float64 on the step-0
gradients of chip_smoke.py's plain-chain paths, and how far TF32 moves
them: path garf (garf at full width on make_scene's 18 views at 480x640,
14 rays per image x 128 samples) and path planar (homography at
homography.yaml's widths). Prints each of a few gradient leaves' max
distance from the card's float64 evaluation, over its max, for the CPU in
float32, the card in float32 (twice), the card with TF32 matmuls, and the
card in float32 with one part of the chain in float64.

    python3 tools/plain_chain_grad_probe.py      (from the repository root, on a card)
"""

import os
import sys
import types

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from neural_invertible_warp_tpu_torch.models import get_system_class, planar  # noqa: E402
from neural_invertible_warp_tpu_torch.ops import (  # noqa: E402
    garf_field, nerf_mlp, render, sampling, warp2d)
from neural_invertible_warp_tpu_torch.planar_options import planar_options  # noqa: E402

GARF_LEAVES = ["nerf.alpha_linear.bias", "nerf.alpha_linear.weight",
               "nerf.pts_linears.0.weight", "nerf.gaussian_linear_d.weight",
               "se3_refine.weight", "nerf.rgb_linear.bias"]
PLANAR_LEAVES = ["warp_param", "image_mlp.layers.0.weight", "image_mlp.layers.3.weight",
                 "image_mlp.layers.4.bias"]


class swapped:
    """Set ``obj.name`` to ``value`` inside the block."""

    def __init__(self, obj, name, value):
        self.obj, self.name, self.value = obj, name, value

    def __enter__(self):
        self.old = getattr(self.obj, self.name)
        setattr(self.obj, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.old)


def in_f64(fn):
    """fn on float64 copies of its tensor arguments, its outputs in float32."""
    def wrapped(*args, **kwargs):
        args = [a.double() if torch.is_tensor(a) else a for a in args]
        out = fn(*args, **kwargs)
        return tuple(o.float() for o in out) if isinstance(out, tuple) else out.float()
    return wrapped


def reporter(ref, leaves):
    """report(label, (loss, grads)): the loss's relative distance from the
    float64 step's ``ref`` = (loss, grads), then each leaf's."""
    def report(label, step):
        loss, grads = step
        print("  {:<28}loss {:.2e} ".format(label, abs(float(loss) - float(ref[0]))
                                            / abs(float(ref[0])))
              + " ".join("{} {:.2e}/{:.2e}".format(n, *distances(grads[n], ref[1][n]))
                         for n in leaves))
    return report


def distances(got, ref):
    """(max |got - ref| / max |ref|, |got - ref|_2 / |ref|_2)."""
    d = got.double().cpu() - ref.cpu()
    return (float(d.abs().max()) / float(ref.abs().max()),
            float(torch.linalg.norm(d)) / float(torch.linalg.norm(ref)))


def tf32(on):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def probe_garf(dev):
    H, W = cs.IMAGE_HW
    arrays = (cs.make_scene(H, W, cs.N_TRAIN, seed=0), cs.make_scene(H, W, cs.N_VAL, seed=1))
    opt = cs.garf_options("garf", cs.GARF_STEPS, "plain_chain_grad_probe")

    def system(device, dtype):
        s = get_system_class("garf")(opt, device)
        s.attach_data(*[{k: v.astype(dtype) if v.dtype == np.float32 else v
                         for k, v in a.items()} for a in arrays])
        s.init_state(opt.seed or 0)
        if dtype == np.float64:
            s.graph.double()
        return s

    g = torch.Generator().manual_seed(11)
    ray_u = torch.rand(cs.GARF_CPU_RAYS, generator=g)
    depth_rand = torch.rand(cs.N_TRAIN, cs.GARF_CPU_RAYS, opt.nerf.sample_intvs, 1, generator=g)
    idx = sampling.sample_ray_subset(H * W, cs.GARF_CPU_RAYS, u=ray_u)
    report = reporter(cs.garf_step_grads(system(dev, np.float64), idx.to(dev),
                                         depth_rand.double().to(dev)), GARF_LEAVES)
    print("garf, 18 x 14 rays x 128 samples:")
    report("cpu f32", cs.garf_step_grads(system("cpu", np.float32), idx, depth_rand))
    card = system(dev, np.float32)

    def card_step(label):
        report(label, cs.garf_step_grads(card, idx.to(dev), depth_rand.to(dev)))
    card_step("card f32")
    card_step("card f32 again")
    tf32(True)
    card_step("card, TF32 matmuls")
    tf32(False)
    with swapped(garf_field, "F", types.SimpleNamespace(linear=in_f64(F.linear))):
        card_step("card, field linears f64")
    gauss = garf_field.GaussianNerf._gauss
    with swapped(garf_field.GaussianNerf, "_gauss", lambda self, x: gauss(self, x.double()).float()):
        card_step("card, gaussians f64")
    with swapped(render, "composite", in_f64(render.composite)):
        card_step("card, composite f64")
    with swapped(nerf_mlp, "_DENSITY_ACTIV", dict(
            nerf_mlp._DENSITY_ACTIV, softplus=in_f64(nerf_mlp._DENSITY_ACTIV["softplus"]))):
        card_step("card, softplus f64")


def probe_planar(dev):
    opt = planar_options("homography")
    H, W = opt.data.image_size
    image = cs.make_planar_image(H, W, seed=0)

    def system(device, dtype):
        s = planar.PlanarSystem(planar_options("homography"), device, image=image)
        s.init_state(opt.seed or 0)
        if dtype == np.float64:
            s.image, s.warp_pert, s.xy_crop = (t.double() for t in (s.image, s.warp_pert,
                                                                     s.xy_crop))
            s.patches = planar.bilinear_sample(
                s.image, warp2d.warp_grid(s.xy_crop, s.warp_pert, opt.warp.type), H, W)
            s.graph.double()
        return s

    def grads(s):
        s.optim.zero_grad()
        loss = s.loss()
        loss.backward()
        return loss.detach(), {n: p.grad.detach().clone() for n, p in s.graph.named_parameters()}
    report = reporter(grads(system(dev, np.float64)), PLANAR_LEAVES)
    print("homography, 5 patches of 180x180, 8 PE bands:")
    report("cpu f32", grads(system("cpu", np.float32)))
    card = system(dev, np.float32)
    report("card f32", grads(card))
    report("card f32 again", grads(card))
    tf32(True)
    report("card, TF32 matmuls", grads(card))
    tf32(False)
    with swapped(planar, "F", types.SimpleNamespace(linear=in_f64(F.linear))):
        report("card, MLP linears f64", grads(card))
    with swapped(planar, "positional_encoding_c2f", in_f64(planar.positional_encoding_c2f)):
        report("card, PE f64", grads(card))
    with swapped(planar.warp2d, "warp_grid", in_f64(warp2d.warp_grid)):
        report("card, warp_grid f64", grads(card))


def main():
    tf32(False)
    print(cs.card_line(), torch.__version__, torch.version.cuda)
    dev = torch.device("cuda", 0)
    probe_garf(dev)
    probe_planar(dev)


if __name__ == "__main__":
    main()
