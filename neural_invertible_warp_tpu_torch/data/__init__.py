"""Dataset loaders (host-side numpy; the system uploads the arrays).

The port's own copies of the JAX package's loaders
(neural_invertible_warp_tpu/data): each loader module exposes a ``Dataset``
class constructed with ``(opt, split, subset)``, with ``len()``,
``get_all_camera_poses(opt)`` and ``all_arrays(opt)``, which returns the
whole split as stacked numpy arrays. LLFF, Blender and DTU are ported so
far; iPhone and Tanks-and-Temples raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""

import importlib

_NOT_YET = {"iphone": "M14", "tandt": "M14"}


def get_dataset(name):
    """Resolve a dataset module by its reference name (llff, blender, ...)."""
    if name in _NOT_YET:
        raise NotImplementedError(
            "the {!r} data loader is not ported yet (ROADMAP {})".format(
                name, _NOT_YET[name]))
    if name not in ("llff", "blender", "dtu"):
        raise KeyError("unknown dataset: {}".format(name))
    return importlib.import_module(
        "neural_invertible_warp_tpu_torch.data.{}".format(name))
