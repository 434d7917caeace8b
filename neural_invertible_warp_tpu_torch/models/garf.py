"""GARF family (port of neural_invertible_warp_tpu/models/garf.py): the
Gaussian-activation field of ops/garf_field.py in place of the NeRF MLP.

* ``nerf_gaussian``: the field with known poses;
* ``garf``: per-image se(3) refinement on the identity, or on the given
  poses with ``init.pose``; ``init.pose_warmup`` zeroes the pose group's
  gradients for its first updates (reference model/garf.py:47-62);
* ``garf_se3_field``: the se(3) correction of each image comes from a small
  MLP (``warp_mlp``, Gaussian or ReLU activations) on a per-image embedding
  (``warp_embedding``; reference model/garf_se3_field.py:281-314).

No field kernel covers the Gaussian field, so ``_field_mode`` is "off": the
render core takes the plain chain in training, validation and test-time
refinement, on the card as on the CPU, as the JAX package's dispatch does
(its kernels' ``supports`` refuses the field).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import garf_field, lie
from ..ops import pose as pose_ops
from .barf import BarfSystem
from .system import NerfSystem


class _GaussianFieldMixin:

    def make_field(self, generator):
        return garf_field.GaussianNerf(self.arch, view_dep=self.opt.nerf.view_dep,
                                       init_cfg=self.opt.get("init"), generator=generator)

    def _field_mode(self):
        return "off"

    def apply_field_samples(self, field, center, ray, depth, noise=None, progress=None,
                            barf_c2f=None, density_activ="softplus"):
        # no positional encoding: progress and barf_c2f are unused
        return garf_field.apply_gaussian_nerf_samples(field, center, ray, depth, noise=noise,
                                                      density_activ=density_activ)


class NerfGaussianSystem(_GaussianFieldMixin, NerfSystem):

    model_name = "nerf_gaussian"


class GarfSystem(_GaussianFieldMixin, BarfSystem):

    model_name = "garf"

    def __init__(self, opt, device):
        super().__init__(opt, device)
        if opt.get("init") and not opt.init.get("pose") and opt.init.get("pose_warmup"):
            raise ValueError("pose optimization must start at iter 0 without known poses "
                             "(init.pose_warmup needs init.pose; reference model/garf.py:22-23)")

    def _initial_pose(self):
        """The GT poses under ``init.pose`` (but on Blender), else BARF's."""
        if self.opt.data.dataset != "blender" and (self.opt.get("init") or {}).get("pose"):
            return self.train_data["pose"]
        return super()._initial_pose()

    def make_gates(self):
        gates = super().make_gates()
        warmup = (self.opt.get("init") or {}).get("pose_warmup") or 0
        if warmup:
            gates["pose"] = int(warmup)
        return gates


class GarfSE3FieldSystem(GarfSystem):
    """garf_se3_field: embedding -> warp MLP -> se(3) correction."""

    model_name = "garf_se3_field"

    def build_graph(self, generator):
        """The field(s), the per-image embedding (N(0,1), as torch's
        ``Embedding``) and the warp MLP with torch's default ``Linear`` init
        on every layer. The reference guards a near-zero init of the last
        layer with ``li == len(L)``, which never holds: the guard is dead
        code, and the last layer keeps the default init here too."""
        arch = self.opt.arch
        graph = NerfSystem.build_graph(self, generator)
        graph.warp_embedding = nn.Embedding(self.n_train, arch.embedding_dim)
        with torch.no_grad():
            graph.warp_embedding.weight.normal_(generator=generator)
        layers = []
        for li, (k_in, k_out) in enumerate(zip(arch.layers_warp[:-1], arch.layers_warp[1:])):
            if li == 0:
                k_in = arch.embedding_dim
            if li in arch.skip_warp:
                k_in += arch.embedding_dim
            layers.append(garf_field.linear_layer(k_in, k_out, generator))
        graph.warp_mlp = nn.ModuleList(layers)
        return graph

    def param_labels(self):
        labels = NerfSystem.param_labels(self)
        labels["warp_embedding"] = "pose"
        labels["warp_mlp"] = "pose"
        return labels

    def _local_warp(self, embedding):
        """embedding [B,C] -> se(3) [B,6]."""
        arch = self.opt.arch
        sigma = arch.sigma_warp
        feat = embedding
        n = len(self.graph.warp_mlp)
        for li, lin in enumerate(self.graph.warp_mlp):
            if li in arch.skip_warp:
                feat = torch.cat([feat, embedding], dim=-1)
            feat = F.linear(feat, lin.weight, lin.bias)
            if li != n - 1:
                if arch.get("actfn_warp") == "gaussian":
                    feat = torch.exp(-0.5 * feat ** 2 / sigma ** 2)
                else:
                    feat = torch.relu(feat)
        return feat

    def get_train_pose(self):
        se3 = self._local_warp(self.graph.warp_embedding.weight)
        return pose_ops.compose([lie.se3_to_SE3(se3), self._initial_pose()])
