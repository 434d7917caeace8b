"""Package-level checks of the port: what its GPU path imports, the
flagship options it carries, and how it refuses what is not ported yet."""

import os
import subprocess
import sys

import pytest

from neural_invertible_warp_tpu import config
from neural_invertible_warp_tpu import dotdict as jax_dotdict
from neural_invertible_warp_tpu_torch.dotdict import DotDict
from neural_invertible_warp_tpu_torch.flagship import flagship_options

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "neural_invertible_warp_tpu_torch",
    "neural_invertible_warp_tpu_torch.flagship",
    "neural_invertible_warp_tpu_torch.config",
    "neural_invertible_warp_tpu_torch.models",
    "neural_invertible_warp_tpu_torch.models.engine",
    "neural_invertible_warp_tpu_torch.models.inn_warp",
    "neural_invertible_warp_tpu_torch.ops.cuda.build",
    "neural_invertible_warp_tpu_torch.ops.cuda.fused_pe",
    "neural_invertible_warp_tpu_torch.utils.ckpt",
    "neural_invertible_warp_tpu_torch.train",
    "chip_smoke",
]

PROBE = """
import importlib, sys
for m in {mods!r}:
    importlib.import_module(m)
import chip_smoke
from neural_invertible_warp_tpu_torch.flagship import flagship_options
from neural_invertible_warp_tpu_torch.config import process_options
from neural_invertible_warp_tpu_torch.models import get_system_class
opt = flagship_options()
opt.output_root = {out!r}
process_options(opt)
get_system_class(opt.model)(opt, "cpu")
chip_smoke.make_scene(8, 8, 2, seed=0)
banned = ("jax", "jaxlib", "yaml", "PIL", "imageio", "neural_invertible_warp_tpu")
print(sorted(m for m in sys.modules if m.split(".")[0] in banned))
"""


def test_gpu_path_imports_no_jax_yaml_pil_imageio(tmp_path):
    """The port's slice modules and chip_smoke.py, imported and driven up to
    building the system, load none of jax, yaml, PIL, imageio, nor the JAX
    package (the card's machine has none of the first four)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(mods=SLICE_MODULES, out=str(tmp_path))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_flagship_dict_equals_yaml_resolution():
    opt = config.load_options("options/barf_inn_llff.yaml")
    over = config.parse_arguments([
        "--model=barf_inn_llff", "--yaml=barf_inn_llff", "--barf_c2f=[0.1,0.5]",
        "--loss_weight.global_alignment=4"])
    opt = config.override_options(opt, over, key_stack=[], safe_check=True)
    assert opt.to_plain() == flagship_options()
    assert flagship_options() is not flagship_options()


def test_port_set_options_matches_yaml(tmp_path):
    """The port's CLI options: the YAML loader's resolution plus the output
    path and H, W (the JAX package's process_options is not called)."""
    from neural_invertible_warp_tpu_torch.config import set_options
    opt = set_options(["--model=barf_inn_llff", "--yaml=barf_inn_llff",
                       "--barf_c2f=[0.1,0.5]", "--loss_weight.global_alignment=4",
                       "--output_root={}".format(tmp_path)])
    assert (opt.H, opt.W) == (480, 640)
    assert opt.output_path == os.path.join(str(tmp_path), "0_test", "debug")
    assert os.path.isdir(opt.output_path)
    assert type(opt) is DotDict and type(opt.nerf.depth) is DotDict
    plain = opt.to_plain()
    for k in ("H", "W", "output_path"):
        plain.pop(k)
    expected = dict(flagship_options())
    expected["output_root"] = str(tmp_path)
    assert plain == expected


def _dotdict_ops(cls):
    """What the options code does with a DotDict, as plain data."""
    d = cls({"a": 1, "n": {"x": [1, {"y": 2}]}}, b=3)
    got = [d.a, d.n.x[1].y, type(d.n).__name__, type(d.n.x[1]).__name__]
    d.c = {"z": 4}
    got.append(d.c.z)
    c = d.copy()
    c.n.x = [0]
    c.a = 5
    got += [type(c).__name__, type(c.n).__name__, d.n.x, d.a, c.to_plain()]
    del d.b
    got.append(sorted(d))
    for attempt in (lambda: d.missing, lambda: delattr(d, "missing")):
        with pytest.raises(AttributeError):
            attempt()
    got.append(d.get("missing", 6))
    return got


def test_port_dotdict_behaves_as_the_jax_one():
    """The port keeps its own DotDict (its GPU path imports nothing of the
    JAX package); it must behave exactly as the JAX package's."""
    assert _dotdict_ops(DotDict) == _dotdict_ops(jax_dotdict.DotDict)
    assert set(vars(DotDict)) - {"__doc__", "__module__"} == \
        set(vars(jax_dotdict.DotDict)) - {"__doc__", "__module__"}


@pytest.mark.parametrize("name,item", [("nerf", "M9"), ("barf_dtu", "M10"),
                                       ("garf", "M11"), ("homography", "M11")])
def test_registry_names_the_roadmap_item(name, item):
    from neural_invertible_warp_tpu_torch.models import get_system_class
    with pytest.raises(KeyError, match=item):
        get_system_class(name)


def test_unported_render_branches_raise(tmp_path):
    import torch
    from neural_invertible_warp_tpu_torch.config import process_options
    from neural_invertible_warp_tpu_torch.models import get_system_class
    opt = flagship_options()
    opt.output_root = str(tmp_path)
    opt.nerf.rand_rays = 8
    opt.nerf.sample_intvs = 4
    opt.data.image_size = [4, 4]
    process_options(opt)
    system = get_system_class("barf_inn_llff")(opt, "cpu")
    center = torch.zeros(1, 2, 3)
    ray = torch.ones(1, 2, 3)
    with pytest.raises(NotImplementedError, match="M8"):
        system.render_rays(center, ray, mode="test-optim")
    for key, value, item in (("fine_sampling", True, "M9"),
                             ("density_noise_reg", 1.0, "M9")):
        opt.nerf[key] = value
        with pytest.raises(NotImplementedError, match=item):
            system.render_rays(center, ray, mode="train", target=torch.zeros(1, 2, 3))
        opt.nerf[key] = flagship_options().nerf[key]
    opt.camera.ndc = True
    with pytest.raises(NotImplementedError, match="M1"):
        system.render_rays(center, ray, mode="eval")


def test_chip_smoke_plain_references_match_the_wrappers_on_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's plain references (K2 loss and gradients, the chunked
    validation image) equal what the port's wrappers and render_image give
    on the CPU, where the wrappers run the plain version: so on the card a
    difference can only come from the kernels."""
    import torch
    import chip_smoke as cs
    from neural_invertible_warp_tpu_torch.config import process_options
    from neural_invertible_warp_tpu_torch.models import get_system_class
    from neural_invertible_warp_tpu_torch.ops.nerf_mlp import NerfMLP
    monkeypatch.setattr(cs, "K", 8)
    mlp = NerfMLP(flagship_options().arch, generator=torch.Generator().manual_seed(0))
    for progress, bg in ((0.3, False), (1.0, True)):
        kw = dict(progress=progress, barf_c2f=cs.C2F, setbg_opaque=bg,
                  bgcolor=1.0 if bg else None)
        inputs = cs.ray_batch(2, 3, seed=0, device="cpu")
        got = cs.k2_wrapper(mlp, *inputs, kw, 0.5)
        ref = cs.k2_plain(mlp, *inputs, kw, 0.5)
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1], ref[1], rtol=0, atol=0)
        for g, r in zip(got[2], ref[2]):
            torch.testing.assert_close(g, r, rtol=0, atol=0)

    opt = flagship_options()
    opt.output_root = str(tmp_path)
    opt.nerf.rand_rays = 6
    opt.nerf.sample_intvs = 4
    opt.data.image_size = [4, 5]
    process_options(opt)
    system = get_system_class("barf_inn_llff")(opt, "cpu")
    system.attach_data(cs.make_scene(4, 5, 2, seed=0), cs.make_scene(4, 5, 1, seed=1))
    system.init_state(0)
    pose, intr = system.test_data["pose"][:1], system.test_data["intr"][:1]
    with torch.no_grad():
        image = system.render_image(pose, intr, torch.tensor(0.7))["rgb"]
        torch.testing.assert_close(cs.plain_image(system, pose, intr, torch.tensor(0.7)),
                                   image, rtol=0, atol=0)
