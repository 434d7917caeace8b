"""Dataset loaders (host-side numpy; the system uploads the arrays).

The port's own copies of the JAX package's loaders
(neural_invertible_warp_tpu/data): each loader module exposes a ``Dataset``
class constructed with ``(opt, split, subset)``, with ``len()``,
``get_all_camera_poses(opt)`` and ``all_arrays(opt)``, which returns the
whole split as stacked numpy arrays. The five formats: LLFF, Blender, DTU,
iPhone and Tanks and Temples.
"""

import importlib

_DATASETS = ("llff", "blender", "dtu", "iphone", "tandt")


def get_dataset(name):
    """Resolve a dataset module by its reference name (llff, blender, ...)."""
    if name not in _DATASETS:
        raise KeyError("unknown dataset: {}".format(name))
    return importlib.import_module(
        "neural_invertible_warp_tpu_torch.data.{}".format(name))
