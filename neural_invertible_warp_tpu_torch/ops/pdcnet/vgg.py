"""VGG-16 feature pyramid of PDC-Net (port of
neural_invertible_warp_tpu/ops/pdcnet/vgg.py; reference
third_party/DenseMatching/models/feature_backbones/VGG_features.py).

Level splits follow the reference's iteration over torchvision vgg16
features (split at the first ReLU, then at every MaxPool), and so do the
``state_dict`` names ``level_{i}.{0,2,4}.weight``:
  level_0: conv1_1+relu              -> full res, 64ch
  level_1: conv1_2+relu+pool         -> 1/2, 64ch
  level_2: conv2_1..relu+pool        -> 1/4, 128ch
  level_3: conv3_1..relu+pool        -> 1/8, 256ch
  level_4: conv4_1..relu+pool        -> 1/16, 512ch
"""

from __future__ import annotations

import torch.nn as nn

from . import layers as L

# (level, [(c_in, c_out), ...]) conv stacks; pool after each level >= 1
VGG_LEVELS = [
    [(3, 64)],
    [(64, 64)],
    [(64, 128), (128, 128)],
    [(128, 256), (256, 256), (256, 256)],
    [(256, 512), (512, 512), (512, 512)],
]


class VGGPyramid(nn.Module):
    def __init__(self, generator):
        super().__init__()
        for li, convs in enumerate(VGG_LEVELS):
            mods = []
            for c_in, c_out in convs:
                conv = nn.Conv2d(c_in, c_out, 3, padding=1)
                L.kaiming_(conv.weight, generator)
                nn.init.zeros_(conv.bias)
                mods += [conv, nn.ReLU()]
            if li >= 1:
                mods.append(nn.MaxPool2d(2, 2))
            setattr(self, "level_{}".format(li), nn.Sequential(*mods))

    def forward(self, x, n_levels=5):
        """``vgg_pyramid``: x [B,3,H,W] imagenet-normalised -> the first
        n_levels outputs."""
        outs = []
        for li in range(n_levels):
            x = getattr(self, "level_{}".format(li))(x)
            outs.append(x)
        return outs


def vgg_eighth(pyramid, x):
    """eigth_resolution mode: [full (64ch), quarter (128ch), eighth (256ch)]."""
    outs = pyramid(x, n_levels=4)
    return [outs[0], outs[2], outs[3]]
