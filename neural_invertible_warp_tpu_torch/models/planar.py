"""Planar image alignment (homography) and 2D neural image fitting (port of
neural_invertible_warp_tpu/models/planar.py).

* ``homography`` / ``planar``: BARF's planar experiment. ``batch_size``
  patches are cut from one image at random SL(3) perturbations; a neural
  image (a coordinate MLP with coarse-to-fine PE) and per-patch warp
  parameters are optimized jointly; ``warp.fix_first`` anchors the gauge by
  holding the first patch at its perturbation (zero).
* ``img_relu``: 2D image regression with a ReLU MLP (optional PE),
  reporting PSNR.

These are not systems of the model registry: ``run_planar_training`` is
their training loop, and ``engine.run_training`` routes the three names to it.
Plain PyTorch: no kernel covers either model.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import warp2d
from ..ops.posenc import positional_encoding_c2f
from ..utils import image_io, log
from ..utils.optim import MultiAdam
from .system import Graph


def load_image(opt):
    """``data.image_fname`` resized (bilinear, as PIL's) to ``data.image_size``;
    [H,W,3] float32 in [0,1]."""
    img = image_io.read_image(opt.data.image_fname)
    H, W = opt.data.image_size
    img = image_io.resize(img, (W, H), "bilinear")
    return np.asarray(img, np.float32)[..., :3] / 255.0


def bilinear_sample(image, xy_norm, H, W):
    """Sample image [H,W,3] at normalized coordinates [...,2] (the warp.py
    coordinate map). The weights come from the unclipped floor; x0 and y0
    are then clipped into the image, and x1, y1 are the clipped x0 + 1,
    y0 + 1 clipped again, as the JAX package does (not ``F.grid_sample``'s
    border rule)."""
    m = max(H, W)
    X = (xy_norm[..., 0] / W * m + 1) / 2 * W - 0.5
    Y = (xy_norm[..., 1] / H * m + 1) / 2 * H - 0.5
    x0, y0 = torch.floor(X), torch.floor(Y)
    wx, wy = X - x0, Y - y0
    x0 = torch.clamp(x0.long(), 0, W - 1)
    y0 = torch.clamp(y0.long(), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    wa = ((1 - wx) * (1 - wy))[..., None]
    wb = (wx * (1 - wy))[..., None]
    wc = ((1 - wx) * wy)[..., None]
    wd = (wx * wy)[..., None]
    return (image[y0, x0] * wa + image[y0, x1] * wb + image[y1, x0] * wc
            + image[y1, x1] * wd)


class ImageMLP(nn.Module):
    """Coordinate MLP 2D -> rgb: the coordinates and their PE (``L_2D``
    bands, none at 0), ReLU layers, a sigmoid. Weights U(+-gain
    sqrt(6/(in+out))) with gain sqrt(2), 1 on the last layer; zero biases."""

    def __init__(self, layers, L_2D, generator=None):
        super().__init__()
        self.L_2D = L_2D
        dims = list(zip(layers[:-1], layers[1:]))
        self.layers = nn.ModuleList()
        for li, (k_in, k_out) in enumerate(dims):
            if li == 0:
                k_in = 2 + 4 * L_2D if L_2D else 2
            lin = nn.Linear(k_in, k_out)
            gain = 1.0 if li == len(dims) - 1 else math.sqrt(2.0)
            bound = gain * math.sqrt(6.0 / (k_in + k_out))
            with torch.no_grad():
                lin.weight.uniform_(-bound, bound, generator=generator)
                lin.bias.zero_()
            self.layers.append(lin)

    def forward(self, xy, progress=None, c2f=None):
        feat = xy
        if self.L_2D:
            feat = torch.cat([xy, positional_encoding_c2f(xy, self.L_2D, progress, c2f)],
                             dim=-1)
        for li, lin in enumerate(self.layers):
            feat = F.linear(feat, lin.weight, lin.bias)
            if li != len(self.layers) - 1:
                feat = torch.relu(feat)
        return torch.sigmoid(feat)


def _metrics(loss):
    loss = loss.detach()
    return dict(loss_render=loss, loss_all=loss, psnr=-10 * torch.log10(loss))


def _image(opt, image, device):
    return torch.as_tensor(np.asarray(image if image is not None else load_image(opt),
                                      np.float32), device=device)


class PlanarSystem:
    """Joint neural image and per-patch SL(3) warps."""

    model_name = "homography"

    def __init__(self, opt, device, image=None):
        self.opt = opt
        self.device = torch.device(device)
        self.H, self.W = opt.data.image_size
        self.H_crop, self.W_crop = opt.data.patch_crop
        opt.H, opt.W = self.H, self.W
        self.image = _image(opt, image, self.device)
        self.B = opt.batch_size
        self.warp_pert = self._generate_perturbations().to(self.device)
        self.xy_crop = warp2d.normalized_pixel_grid_crop(
            self.H, self.W, self.H_crop, self.W_crop, batch_size=self.B, device=self.device)
        # the patches: the image at the perturbed crops
        xy_pert = warp2d.warp_grid(self.xy_crop, self.warp_pert, opt.warp.type)
        self.patches = bilinear_sample(self.image, xy_pert, self.H, self.W)
        self.graph = None
        self.optim = None
        self.step = 0

    def _generate_perturbations(self):
        """Random warps whose crop corners stay in the image, drawn from
        numpy's RandomState(seed) in the JAX package's order; patch 0 stays
        at zero with ``fix_first``. Returns [B, dof] on the CPU."""
        opt = self.opt
        rng = np.random.RandomState(opt.seed or 0)
        perts = []
        for b in range(self.B):
            if b == 0 and opt.warp.fix_first:
                perts.append(np.zeros(opt.warp.dof, np.float32))
                continue
            for _ in range(1000):
                p = rng.randn(opt.warp.dof).astype(np.float32) * opt.warp.noise_h
                p[:2] += rng.randn(2).astype(np.float32) * opt.warp.noise_t
                if warp2d.check_corners_in_range(torch.from_numpy(p)[None], self.H, self.W,
                                                 self.H_crop, self.W_crop, opt.warp.type):
                    break
            perts.append(p)
        return torch.from_numpy(np.stack(perts))

    def init_state(self, seed=0):
        """The neural image from a seeded CPU generator, zero warps, and Adam
        at constant rates: ``optim.lr`` for the image, ``optim.lr_warp`` for
        the warps."""
        opt = self.opt
        gen = torch.Generator().manual_seed(int(seed))
        self.graph = Graph(
            image_mlp=ImageMLP(opt.arch.layers, opt.arch.posenc.L_2D, generator=gen),
            warp_param=nn.Parameter(torch.zeros(self.B, opt.warp.dof))).to(self.device)
        lr, lr_warp = opt.optim.lr, opt.optim.lr_warp
        self.optim = MultiAdam(
            {"mlp": list(self.graph.image_mlp.parameters()), "warp": [self.graph.warp_param]},
            {"mlp": lambda count: lr, "warp": lambda count: lr_warp})
        self.step = 0

    def effective_warp(self):
        """The warps in use: with ``fix_first`` patch 0 at its perturbation."""
        warp = self.graph.warp_param
        if self.opt.warp.fix_first:
            return torch.cat([self.warp_pert[:1], warp[1:]], dim=0)
        return warp

    def loss(self):
        opt = self.opt
        progress = (torch.tensor(float(self.step), dtype=torch.float32)
                    / opt.max_iter).to(self.device)
        c2f = tuple(opt.barf_c2f) if opt.get("barf_c2f") else None
        xy = warp2d.warp_grid(self.xy_crop, self.effective_warp(), opt.warp.type)
        rgb = self.graph.image_mlp(xy, progress, c2f)
        return torch.mean((rgb - self.patches) ** 2)

    def train_step(self):
        """One Adam step on every patch; the metrics as 0-d tensors."""
        self.optim.zero_grad()
        loss = self.loss()
        loss.backward()
        self.optim.step()
        self.step += 1
        return _metrics(loss)

    @torch.no_grad()
    def corner_error(self):
        """Mean L2 distance between the estimated and the true warped corners."""
        args = (self.H, self.W, self.H_crop, self.W_crop, self.opt.warp.type)
        est = warp2d.warp_corners(self.effective_warp(), *args)
        gt = warp2d.warp_corners(self.warp_pert, *args)
        return float(torch.mean(torch.linalg.norm(est - gt, dim=-1)))


class ImageFitSystem:
    """2D neural image regression with PSNR."""

    model_name = "img_relu"

    def __init__(self, opt, device, image=None):
        self.opt = opt
        self.device = torch.device(device)
        self.H, self.W = opt.data.image_size
        opt.H, opt.W = self.H, self.W
        self.image = _image(opt, image, self.device)
        self.grid = warp2d.normalized_pixel_grid(self.H, self.W, device=self.device)[0]
        self.pixels = self.image.reshape(-1, 3)
        self.graph = None
        self.optim = None
        self.generator = None
        self.step = 0

    def init_state(self, seed=0):
        """The MLP from a seeded CPU generator, Adam at ``optim.Adam.lr``, and
        the generator of the pixel draws on the device."""
        opt = self.opt
        L = opt.relu.posenc.L_2D if opt.relu.posenc.get("enabled") else 0
        layers = [None] + [opt.relu.hidden_features] * opt.relu.hidden_layers + [3]
        gen = torch.Generator().manual_seed(int(seed))
        self.graph = Graph(mlp=ImageMLP(layers, L, generator=gen)).to(self.device)
        lr = opt.optim.Adam.lr
        self.optim = MultiAdam({"main": list(self.graph.parameters())},
                               {"main": lambda count: lr})
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self.step = 0

    def train_step(self, idx=None):
        """One Adam step on ``train_samples`` pixels drawn without
        replacement from the system's generator; ``idx`` optionally supplies
        them."""
        n = self.grid.shape[0]
        if idx is None:
            n_samples = min(self.opt.get("train_samples") or n, n)
            idx = torch.randperm(n, generator=self.generator, device=self.device)[:n_samples]
        self.optim.zero_grad()
        loss = torch.mean((self.graph.mlp(self.grid[idx]) - self.pixels[idx]) ** 2)
        loss.backward()
        self.optim.step()
        self.step += 1
        return _metrics(loss)


def run_planar_training(opt, device, image=None):
    """Training loop of the 2D experiments: ``max_iter`` steps, the metrics logged
    every ``freq.scalar``. ``image`` [H,W,3] replaces ``data.image_fname``.
    Returns the trained system."""
    cls = PlanarSystem if opt.model in ("homography", "planar") else ImageFitSystem
    system = cls(opt, device, image=image)
    system.init_state(opt.seed or 0)
    for it in range(opt.max_iter):
        metrics = system.train_step()
        if (it + 1) % opt.freq.scalar == 0:
            log.info("it {}: {}".format(it + 1, " ".join(
                "{}={:.4g}".format(k, float(v)) for k, v in sorted(metrics.items()))))
    return system
