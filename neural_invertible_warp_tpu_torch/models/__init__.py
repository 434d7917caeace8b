"""Model registry of the port: every name the JAX package's registry
resolves, to the port's class of the same name. The planar experiments
(``homography``, ``planar``, ``img_relu``) are not systems of this
registry, as in the JAX package: ``engine.run_training`` sends them to
``planar.run_planar_training`` before any system is looked up."""

from __future__ import annotations


def get_system_class(name):
    if name in ("barf_inn_llff", "nerf_inn_llff", "barf_inn_blender"):
        from .inn_warp import InnWarpSystem
        return InnWarpSystem
    if name == "nerf":
        from .system import NerfSystem
        return NerfSystem
    if name in ("barf", "barf_se3_field"):
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
    if name == "nerf_gaussian":
        from .garf import NerfGaussianSystem
        return NerfGaussianSystem
    if name == "garf":
        from .garf import GarfSystem
        return GarfSystem
    if name == "garf_se3_field":
        from .garf import GarfSE3FieldSystem
        return GarfSE3FieldSystem
    raise KeyError("unknown model: {}".format(name))
