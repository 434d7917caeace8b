"""LPIPS (AlexNet) perceptual metric, gated on weight availability (port of
neural_invertible_warp_tpu/ops/lpips.py).

No pretrained weights ship with the repository, so the metric degrades
gracefully: ``available()`` reports whether a weight file can be found, and
``lpips()`` returns NaN when it cannot. Drop pretrained AlexNet weights (an
.npz with conv0..conv4 kernels, conv{i}_b biases and lin0..lin4 1x1 weights)
at ``NIW_LPIPS_WEIGHTS`` to enable it.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

WEIGHTS_ENV = "NIW_LPIPS_WEIGHTS"
_cache = {"checked": False, "weights": None}


def reset_cache():
    """Forget the cached weight lookup (tests change the env var)."""
    _cache["checked"] = False
    _cache["weights"] = None


def _load_weights():
    if _cache["checked"]:
        return _cache["weights"]
    _cache["checked"] = True
    path = os.environ.get(WEIGHTS_ENV)
    if path and os.path.isfile(path):
        try:
            _cache["weights"] = dict(np.load(path))
        except Exception:
            _cache["weights"] = None
    return _cache["weights"]


def available():
    return _load_weights() is not None


def lpips(img1, img2, weights=None):
    """[B,C,H,W] tensors in [-1,1] -> scalar LPIPS (a float), or NaN if
    weights are unavailable.

    ``weights`` overrides the env-located npz (used by tests); layout:
    conv0..conv4 [out,in,kh,kw] + conv{i}_b biases (torchvision AlexNet
    features) and lin0..lin4 per-channel LPIPS head weights."""
    w = weights if weights is not None else _load_weights()
    if w is None:
        return float("nan")
    img1 = torch.as_tensor(img1, dtype=torch.float32)
    img2 = torch.as_tensor(img2, dtype=torch.float32, device=img1.device)

    def const(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=img1.device)

    mean = const([-0.030, -0.088, -0.188]).reshape(1, 3, 1, 1)
    std = const([0.458, 0.448, 0.450]).reshape(1, 3, 1, 1)

    def alexnet_feats(x):
        feats = []
        strides = [4, 1, 1, 1, 1]
        pads = [2, 2, 1, 1, 1]
        for i in range(5):
            x = F.conv2d(x, const(w["conv{}".format(i)]),
                         const(w["conv{}_b".format(i)]),
                         stride=strides[i], padding=pads[i])
            x = F.relu(x)
            feats.append(x)
            if i in (0, 1):
                x = F.max_pool2d(x, kernel_size=3, stride=2)
        return feats

    f1 = alexnet_feats((img1 - mean) / std)
    f2 = alexnet_feats((img2 - mean) / std)
    total = 0.0
    for i, (a, b) in enumerate(zip(f1, f2)):
        a = a / torch.sqrt(torch.sum(a ** 2, dim=1, keepdim=True) + 1e-10)
        b = b / torch.sqrt(torch.sum(b ** 2, dim=1, keepdim=True) + 1e-10)
        lin = const(w["lin{}".format(i)]).reshape(1, -1, 1, 1)
        total = total + torch.mean(torch.sum((a - b) ** 2 * lin, dim=1))
    return float(total)
