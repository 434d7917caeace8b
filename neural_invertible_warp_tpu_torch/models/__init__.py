"""Model registry of the port. Only the paper's LLFF INN-warp models are
ported so far; every other name of the JAX registry raises ``KeyError``
naming the ROADMAP item that brings it."""

from __future__ import annotations

_NOT_YET = {
    "nerf": "M9", "barf": "M9", "barf_se3_field": "M9", "barf_inn_blender": "M10",
    "nerf_dtu": "M10", "barf_dtu": "M10", "barf_inn_dtu": "M10",
    "nerf_inn_dtu": "M10", "nerf_gaussian": "M11", "garf": "M11",
    "garf_se3_field": "M11", "homography": "M11", "planar": "M11",
    "img_relu": "M11",
}


def get_system_class(name):
    if name in ("barf_inn_llff", "nerf_inn_llff"):
        from .inn_warp import InnWarpSystem
        return InnWarpSystem
    if name in _NOT_YET:
        raise KeyError("model {!r} is not ported yet (ROADMAP {})".format(
            name, _NOT_YET[name]))
    raise KeyError("unknown model: {}".format(name))
