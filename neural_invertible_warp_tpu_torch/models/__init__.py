"""Model registry of the port. The paper's INN-warp models on LLFF, Blender
and DTU, vanilla NeRF (with fine sampling), SE(3) BARF on LLFF and Blender and
the DTU family are ported so far; every other name of the JAX registry raises
``KeyError`` naming the ROADMAP item that brings it."""

from __future__ import annotations

_NOT_YET = {
    "barf_se3_field": "M9", "nerf_gaussian": "M11", "garf": "M11",
    "garf_se3_field": "M11", "homography": "M11", "planar": "M11",
    "img_relu": "M11",
}


def get_system_class(name):
    if name in ("barf_inn_llff", "nerf_inn_llff", "barf_inn_blender"):
        from .inn_warp import InnWarpSystem
        return InnWarpSystem
    if name == "nerf":
        from .system import NerfSystem
        return NerfSystem
    if name == "barf":
        from .barf import BarfSystem
        return BarfSystem
    if name == "nerf_dtu":
        from .dtu import NerfDTUSystem
        return NerfDTUSystem
    if name == "barf_dtu":
        from .dtu import BarfDTUSystem
        return BarfDTUSystem
    if name in ("barf_inn_dtu", "nerf_inn_dtu"):
        from .dtu import InnDTUSystem
        return InnDTUSystem
    if name in _NOT_YET:
        raise KeyError("model {!r} is not ported yet (ROADMAP {})".format(
            name, _NOT_YET[name]))
    raise KeyError("unknown model: {}".format(name))
