"""Package-level checks of the port: what its GPU path imports, the
flagship options it carries, and how it refuses what is not ported yet."""

import os
import subprocess
import sys

import pytest
import torch

from neural_invertible_warp_tpu import config
from neural_invertible_warp_tpu import dotdict as jax_dotdict
from neural_invertible_warp_tpu_torch.dotdict import DotDict
from neural_invertible_warp_tpu_torch.flagship import flagship_options

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "neural_invertible_warp_tpu_torch",
    "neural_invertible_warp_tpu_torch.flagship",
    "neural_invertible_warp_tpu_torch.nerf_llff_repr",
    "neural_invertible_warp_tpu_torch.config",
    "neural_invertible_warp_tpu_torch.models",
    "neural_invertible_warp_tpu_torch.models.engine",
    "neural_invertible_warp_tpu_torch.models.inn_warp",
    "neural_invertible_warp_tpu_torch.ops.cuda.build",
    "neural_invertible_warp_tpu_torch.ops.cuda.fused_pe",
    "neural_invertible_warp_tpu_torch.ops.cuda.fused_field",
    "neural_invertible_warp_tpu_torch.ops.cuda.fused_inn",
    "neural_invertible_warp_tpu_torch.ops.cuda.correlation",
    "neural_invertible_warp_tpu_torch.ops.correlation",
    "neural_invertible_warp_tpu_torch.ops.pdcnet.pdcnet",
    "neural_invertible_warp_tpu_torch.ops.pdcnet.convert",
    "neural_invertible_warp_tpu_torch.utils.matchers",
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
from neural_invertible_warp_tpu_torch.nerf_llff_repr import nerf_llff_repr_options
opt = nerf_llff_repr_options()
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


@pytest.mark.parametrize("name,item", [("barf_se3_field", "M9"), ("barf_dtu", "M10"),
                                       ("garf", "M11"), ("homography", "M11")])
def test_registry_names_the_roadmap_item(name, item):
    from neural_invertible_warp_tpu_torch.models import get_system_class
    with pytest.raises(KeyError, match=item):
        get_system_class(name)


def test_registry_resolves_the_inn_warp_models():
    """The three INN-warp names of the JAX registry are one system class."""
    from neural_invertible_warp_tpu_torch.models import get_system_class
    from neural_invertible_warp_tpu_torch.models.inn_warp import InnWarpSystem
    for name in ("barf_inn_llff", "nerf_inn_llff", "barf_inn_blender"):
        assert get_system_class(name) is InnWarpSystem
    with pytest.raises(KeyError, match="unknown model"):
        get_system_class("barf_inn_mars")


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
    with pytest.raises(ValueError, match="render mode"):
        system.render_rays(center, ray, mode="test")
    from neural_invertible_warp_tpu_torch.ops import sampling
    for mode in ("topk", "permutation"):       # the other ray draws of tpu.ray_sample
        with pytest.raises(NotImplementedError, match="M9"):
            sampling.sample_ray_subset(16, 4, mode=mode)
    opt.camera.ndc = True
    with pytest.raises(NotImplementedError, match="M1"):
        system.render_rays(center, ray, mode="eval")
    with pytest.raises(NotImplementedError, match="M1"):
        system.render_rays(center, ray, mode="train", target=torch.zeros(1, 2, 3))


def test_chip_smoke_plain_references_match_the_wrappers_on_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's plain references (K2 loss and gradients, K6's output
    and gradients, the chunked validation image) equal what the port's
    wrappers and render_image give
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

    # K6: through the wrapper ("kernel") the CPU runs the plain version; the
    # chain associates the first-layer product otherwise (5e-4 per leaf, as
    # tests/test_torch_fused_inn.py holds it)
    net, code, pts = cs.inn_setup(2, 7, 8, seed=0, device="cpu")
    for alpha in (0.0, 0.37, 1.0):
        out_k, grads_k = cs.inn_grads("kernel", net, code, pts, alpha)
        out_p, grads_p = cs.inn_grads("plain", net, code, pts, alpha)
        out_c, grads_c = cs.inn_grads("chain", net, code, pts, alpha)
        assert torch.equal(out_k, out_p) and float((out_k - pts).abs().max()) > 1e-2
        assert len(grads_k) == len(grads_p) == len(grads_c) == 2 + 36
        torch.testing.assert_close(out_c, out_k, rtol=1e-5, atol=1e-5)
        for g, r, c in zip(grads_k, grads_p, grads_c):
            assert torch.equal(g, r) and float(r.abs().max()) > 0
            assert float(torch.linalg.norm(c - g)) <= 5e-4 * float(torch.linalg.norm(c))

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


# ------------------------------------------------- nothing of the JAX package

BANNED_IMPORTS = ("jax", "jaxlib", "neural_invertible_warp_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "neural_invertible_warp_tpu_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "chip_profile.py")]
    for base, _, files in os.walk(pkg):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_roots(path):
    """Top-level names of every absolute import in a source file, at module
    level or inside a function."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots += [(a.name.split(".")[0], node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.append((node.module.split(".")[0], node.lineno))
    return roots


def test_matchers_run_on_the_card_unless_the_cpu_is_asked_for():
    """``PdcNetMatcher`` and ``ZnccMatcher`` take ``cuda:0`` by default and
    raise without a card instead of running on the CPU."""
    from neural_invertible_warp_tpu_torch.ops.pdcnet.pdcnet import PDCNet
    from neural_invertible_warp_tpu_torch.utils import matchers
    net = PDCNet(torch.Generator().manual_seed(0))
    if torch.cuda.is_available():
        assert matchers.PdcNetMatcher(net).device == torch.device("cuda", 0)
        return
    for make in (lambda: matchers.PdcNetMatcher(net), matchers.ZnccMatcher,
                 lambda: matchers.PdcNetMatcher(net, device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert matchers.PdcNetMatcher(net, device="cpu").device == torch.device("cpu")
    assert next(net.parameters()).device == torch.device("cpu")


def test_no_port_source_imports_jax_or_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports jax, jaxlib or
    the JAX package (the bare name, not the port's), anywhere in the file."""
    sources = _port_sources()
    assert len(sources) > 30
    pkg = os.path.join(ROOT, "neural_invertible_warp_tpu_torch")
    assert {os.path.join(pkg, *p.split("/")) for p in (
        "ops/correlation.py", "ops/cuda/correlation.py", "ops/pdcnet/layers.py",
        "ops/pdcnet/vgg.py", "ops/pdcnet/blocks.py", "ops/pdcnet/gocor.py",
        "ops/pdcnet/pdcnet.py", "ops/pdcnet/convert.py", "utils/matchers.py")} <= set(sources)
    found =["{}:{} imports {}".format(os.path.relpath(path, ROOT), line, root)
             for path in sources for root, line in _imported_roots(path)
             if root in BANNED_IMPORTS]
    assert not found, found
    # the walker sees imports inside functions: the port's config.py imports
    # yaml only there
    cfg = os.path.join(ROOT, "neural_invertible_warp_tpu_torch", "config.py")
    assert "yaml" in [r for r, _ in _imported_roots(cfg)]


# ------------------------------------------------------ the port's own copies

def test_port_config_copies_resolve_as_the_jax_ones(tmp_path):
    """parse_arguments, load_options (with ``_parent_``) and override_options
    of the port against the JAX package's, on the repo's option files and on
    a two-parent chain."""
    from neural_invertible_warp_tpu_torch import config as pconfig
    args = ["--a.b=3", "--a.c=[1,2]", "--d", "--e!", "--f=", "--g.h.i=text"]
    assert pconfig.parse_arguments(args).to_plain() == config.parse_arguments(args).to_plain()
    for name in ("barf_inn_llff", "barf_llff", "nerf_llff", "base"):
        fname = "options/{}.yaml".format(name)
        assert pconfig.load_options(fname).to_plain() == config.load_options(fname).to_plain()
    (tmp_path / "p1.yaml").write_text("a: {x: 1, y: 2}\nb: 1\n")
    (tmp_path / "p2.yaml").write_text("a: {y: 5}\nc: [1, 2]\n")
    (tmp_path / "child.yaml").write_text(
        "_parent_: [{0}/p1.yaml, {0}/p2.yaml]\na: {{z: 9}}\n".format(tmp_path))
    child = str(tmp_path / "child.yaml")
    got = pconfig.load_options(child)
    assert got.to_plain() == config.load_options(child).to_plain()
    assert type(got) is DotDict and type(got.a) is DotDict
    over = ["--a.x=7", "--b=2"]
    assert pconfig.override_options(got, pconfig.parse_arguments(over), safe_check=True).to_plain() \
        == config.override_options(config.load_options(child), config.parse_arguments(over),
                                   safe_check=True).to_plain()
    with pytest.raises(KeyError, match="a.nope"):
        pconfig.override_options(got, pconfig.parse_arguments(["--a.nope=1"]), safe_check=True)


def test_port_run_name_follows_the_seed(tmp_path):
    from neural_invertible_warp_tpu_torch.config import set_options
    base = ["--model=barf_inn_llff", "--yaml=barf_inn_llff",
            "--output_root={}".format(tmp_path)]
    assert set_options(base + ["--seed=3"], makedirs=False).name == "debug_seed3"
    assert set_options(base + ["--seed=0"], makedirs=False).name == "debug"
    name = set_options(base + ["--seed="], makedirs=False).name
    assert len(name) == len("debug_ABCD") and name[-4:].isupper()


def test_port_llff_loader_gives_the_jax_arrays(tmp_path):
    """The synthetic LLFF scene through both Dataset classes: every array
    of all_arrays, for both splits, is equal bit for bit."""
    import numpy as np
    import synth_data
    from neural_invertible_warp_tpu.data import get_dataset as jax_get_dataset
    from neural_invertible_warp_tpu_torch.data import get_dataset
    root = str(tmp_path)
    synth_data.make_llff_scene(root, n_images=8)
    opt = synth_data.llff_opt(root)
    popt = DotDict(opt.to_plain())
    for split in ("train", "val"):
        ref_ds = jax_get_dataset("llff").Dataset(opt, split=split)
        got_ds = get_dataset("llff").Dataset(popt, split=split)
        ref, got = ref_ds.all_arrays(opt), got_ds.all_arrays(popt)
        assert len(got_ds) == len(ref_ds) > 0
        assert sorted(got) == sorted(ref) and {"image", "intr", "pose"} <= set(got)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(np.asarray(got_ds.get_all_camera_poses(popt)),
                                      np.asarray(ref_ds.get_all_camera_poses(opt)))


@pytest.mark.parametrize("name,item", [("dtu", "M10"), ("iphone", "M14"),
                                       ("tandt", "M14")])
def test_unported_data_loaders_name_the_roadmap_item(name, item):
    from neural_invertible_warp_tpu_torch.data import get_dataset
    with pytest.raises(NotImplementedError, match=item):
        get_dataset(name)


# ----------------------------------------------------------------- checkpoints

def _tiny_llff_system(tmp_path, seed=0):
    import torch
    import chip_smoke as cs
    from neural_invertible_warp_tpu_torch.config import process_options
    from neural_invertible_warp_tpu_torch.models import get_system_class
    opt = flagship_options()
    opt.output_root = str(tmp_path)
    opt.arch.layers_feat = [None, 16, 16, 16]
    opt.arch.layers_rgb = [None, 8, 3]
    opt.arch.skip = [1]
    opt.inn.real_nvp.d_hidden = 8
    opt.warp_latent.embed_dim = 4
    opt.nerf.rand_rays = 10
    opt.nerf.sample_intvs = 4
    opt.data.image_size = [4, 5]
    opt.max_iter = 20
    process_options(opt)
    system = get_system_class("barf_inn_llff")(opt, "cpu")
    system.attach_data(cs.make_scene(4, 5, 2, seed=0), cs.make_scene(4, 5, 1, seed=1))
    system.init_state(seed)
    assert torch.is_tensor(system.aux["global_rigid"])
    return system


def test_restore_latest_and_numbered_checkpoints(tmp_path):
    """``resume=True`` picks the latest checkpoint, an integer that snapshot;
    parameters, Adam moments, the step and the pose readout come back, and
    the restored system takes the same next step as the one that went on."""
    import torch
    from neural_invertible_warp_tpu_torch.models.engine import Trainer
    from neural_invertible_warp_tpu_torch.utils import ckpt
    system = _tiny_llff_system(tmp_path / "a")
    out = system.opt.output_path
    draws = torch.rand(3, 5, generator=torch.Generator().manual_seed(0))
    depth_rand = torch.rand(3, 2, 5, 4, 1, generator=torch.Generator().manual_seed(1))
    system.train_step(draws[0], depth_rand[0])
    ckpt.save(out, system, system.step)
    system.train_step(draws[1], depth_rand[1])
    ckpt.save(out, system, system.step)
    assert sorted(os.listdir(os.path.join(out, "model"))) == ["1.ckpt", "2.ckpt"]

    other = _tiny_llff_system(tmp_path / "b", seed=5)
    assert ckpt.restore(out, other, resume=1) == 1 and other.step == 1
    trainer = Trainer(other.opt, "cpu")
    trainer.system = other
    other.opt.output_path = out
    other.opt.resume = True
    assert trainer.restore_checkpoint() == 2
    assert other.step == 2 and other.optim.count == system.optim.count
    for (name, a), b in zip(system.graph.named_parameters(), other.graph.parameters()):
        assert torch.equal(a, b), name
        for ma, mb in zip(system.optim.moments(a), other.optim.moments(b)):
            assert torch.equal(ma, mb), name
    assert torch.equal(system.aux["global_rigid"], other.aux["global_rigid"])
    m_a = system.train_step(draws[2], depth_rand[2])
    m_b = other.train_step(draws[2], depth_rand[2])
    assert float(m_a["loss_all"]) == float(m_b["loss_all"])
    for a, b in zip(system.graph.parameters(), other.graph.parameters()):
        assert torch.equal(a, b)
    other.opt.resume = None
    other.opt.load = os.path.join(out, "model", "1.ckpt")
    assert trainer.restore_checkpoint() == 1 and other.step == 1


def test_jax_written_checkpoint_restores_into_the_port(tmp_path):
    """A model.ckpt written by the JAX package's save_checkpoint after one
    train step loads into the port (parameters over the weight bridge, Adam
    moments, step, pose readout) and renders the same two-chunk image."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import torch
    from neural_invertible_warp_tpu.models import get_system_class as jax_system_class
    from neural_invertible_warp_tpu.utils import ckpt as jckpt
    from neural_invertible_warp_tpu_torch.utils import ckpt, weights
    import chip_smoke as cs
    psys = _tiny_llff_system(tmp_path / "port")
    jopt = jax_dotdict.DotDict(psys.opt.to_plain())
    jsys = jax_system_class("barf_inn_llff")(jopt)
    jsys.attach_data(cs.make_scene(4, 5, 2, seed=0), cs.make_scene(4, 5, 1, seed=1))
    state = jsys.init_state(jax.random.PRNGKey(1))
    state, _ = jax.jit(jsys.make_train_step())(state, jsys.train_data, jax.random.PRNGKey(2))
    out = str(tmp_path / "jax_run")
    jckpt.save_checkpoint(out, state, int(state["step"]))

    assert ckpt.restore(out, psys) == 1
    assert psys.step == 1 and psys.optim.count == 1
    p_t = weights.to_jax_params(psys.graph)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(state["params"]),
                            jax.tree_util.tree_leaves(p_t)):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=jax.tree_util.keystr(path))
    np.testing.assert_array_equal(psys.aux["global_rigid"].numpy(),
                                  np.asarray(state["aux"]["global_rigid"]))
    # the moments, raveled again in the JAX layout, are the file's
    tree = ckpt.state_tree(psys)
    for label in ("main", "pose", "latent"):
        (cnt, mu, nu), _ = tree["opt_state"][label]
        (cnt_j, mu_j, nu_j), _ = state["opt_state"][label]
        assert int(cnt) == int(cnt_j) == 1
        np.testing.assert_array_equal(mu, np.asarray(mu_j))
        np.testing.assert_array_equal(nu, np.asarray(nu_j))
        if label == "main":
            assert float(np.abs(np.asarray(mu_j)).max()) > 0
    pose, intr = jsys.test_data["pose"][:1], jsys.test_data["intr"][:1]
    ref = jsys.render_image(state["params"], state["aux"], pose, intr, 0.5)
    got = psys.render_image(psys.test_data["pose"][:1], psys.test_data["intr"][:1],
                            torch.tensor(0.5))
    assert psys.HW == 2 * psys.opt.nerf.rand_rays
    # inverse-depth samples run out to 1e6 and beyond, where the two fp32
    # evaluations of the PE's sin/cos arguments differ: 1e-4
    for k in ("rgb", "depth", "opacity"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


# ------------------------------------------------------------ the entry points

CLI_FLAGS = [
    "--model=barf_inn_llff", "--yaml=barf_inn_llff", "--barf_c2f=[0.1,0.5]",
    "--loss_weight.global_alignment=4", "--data.scene=toyfern",
    "--data.image_size=[24,32]", "--data.num_workers=2", "--data.val_ratio=0.25",
    "--arch.layers_feat=[null,16,16,16]", "--arch.layers_rgb=[null,8,3]",
    "--arch.skip=[1]", "--inn.real_nvp.d_hidden=8", "--warp_latent.embed_dim=4",
    "--nerf.sample_intvs=8", "--nerf.rand_rays=384", "--max_iter=4",
    "--freq.scalar=2", "--freq.val=100", "--freq.ckpt=2", "--optim.test_iter=3",
    "--group=cli", "--name=run0",
]


def test_train_and_evaluate_entry_points_on_cpu(tmp_path):
    """``train`` in-process and ``python -m ...evaluate --device=cpu`` as a
    subprocess on the synthetic LLFF fixture: checkpoints, then quant.txt,
    quant_pose.txt, the test-view PNGs and the novel views. Without a CUDA
    device and without ``--device=cpu`` both entry points refuse to start."""
    import torch
    import synth_data
    from neural_invertible_warp_tpu_torch import evaluate, train
    root = str(tmp_path / "data")
    synth_data.make_llff_scene(root, n_images=8, img_size=(24, 32))
    flags = CLI_FLAGS + ["--data.root={}".format(root),
                         "--output_root={}".format(tmp_path / "out")]
    if not torch.cuda.is_available():
        for main in (train.main, evaluate.main):
            with pytest.raises(RuntimeError, match="--device=cpu"):
                main(flags)
    trainer = train.main(flags + ["--device=cpu"])
    out_dir = os.path.join(str(tmp_path), "out", "cli", "run0")
    assert trainer.system.step == 4
    assert sorted(os.listdir(os.path.join(out_dir, "model"))) == ["2.ckpt", "4.ckpt"]

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"                  # as torch.set_num_threads(1) above
    run = subprocess.run(
        [sys.executable, "-m", "neural_invertible_warp_tpu_torch.evaluate"] + flags
        + ["--device=cpu"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "restored checkpoint" in run.stdout and "(iter 4)" in run.stdout
    assert "ROADMAP M15" in run.stdout            # the pose video is not ported
    n_val = 2                                     # 8 images at val_ratio 0.25
    rows = open(os.path.join(out_dir, "quant.txt")).read().split("\n")[:-1]
    assert len(rows) == n_val
    for i, row in enumerate(rows):
        idx, psnr, ssim, lpips = row.split()
        assert int(idx) == i and lpips == "unavailable"
        assert 0 < float(psnr) < 100 and -1 <= float(ssim) <= 1
    assert len(open(os.path.join(out_dir, "quant_pose.txt")).read().split("\n")) == 6 + 1
    views = os.listdir(os.path.join(out_dir, "test_view"))
    assert sorted(views) == sorted("{}_{}.png".format(n, i) for n in ("rgb", "rgb_GT", "depth")
                                   for i in range(n_val))
    assert len(os.listdir(os.path.join(out_dir, "novel_view"))) == 60


def test_chip_smoke_k7_references_on_cpu():
    """chip_smoke.py's K7 yardsticks on the CPU: the unfold + einsum routes
    compute K7 and its adjoint in f1 (to 1e-5, another summation order), and
    ``plain_correlation`` routes the matcher's correlations to the plain
    versions and back."""
    import chip_smoke as cs
    from neural_invertible_warp_tpu_torch.ops import correlation as plain
    from neural_invertible_warp_tpu_torch.ops.cuda import correlation as k7
    f1, f2, m = cs.k7_inputs(2, 20, 9, 33, seed=0, device="cpu")
    torch.testing.assert_close(cs.k7_library(f1, f2), plain.local_correlation(f1, f2),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cs.k7_library_adjoint(m, f2),
                               plain.local_correlation_transpose(m, f2), rtol=1e-5, atol=1e-5)
    wrappers = k7.local_correlation, k7.local_correlation_transpose
    with cs.plain_correlation():
        assert k7.local_correlation is plain.local_correlation
        assert k7.local_correlation_transpose is plain.local_correlation_transpose
    assert (k7.local_correlation, k7.local_correlation_transpose) == wrappers
    assert (cs.K7_FWD_PER_PAIR, cs.K7_ADJ_PER_PAIR) == (24, 9)
    assert {"k7_fwd", "k7_adj", "k7_adj_f2"} <= set(cs.field_counts())


def test_chip_smoke_k4_references_match_the_wrappers_on_cpu(monkeypatch):
    """chip_smoke.py's K4 references on the CPU, where the wrappers run the
    plain version: the test loss and its gradients through the forward
    wrapper equal those through the plain chain bit for bit, with the
    weights trainable and frozen; the K3 + K4 training route gives K2's loss
    and gradients (another summation order of the squared error: 1e-6); the
    float64 evaluation agrees with fp32 to 1e-4 of each leaf's max."""
    import torch
    import chip_smoke as cs
    from neural_invertible_warp_tpu_torch.ops.nerf_mlp import NerfMLP
    monkeypatch.setattr(cs, "K", 8)
    mlp = NerfMLP(flagship_options().arch, generator=torch.Generator().manual_seed(0))
    n_params = len(list(mlp.parameters()))
    for progress, bg in ((0.3, False), (1.0, True)):
        kw = dict(progress=progress, barf_c2f=cs.C2F, setbg_opaque=bg,
                  bgcolor=1.0 if bg else None)
        center, ray, depth, target = cs.ray_batch(2, 3, seed=0, device="cpu")
        coeffs = cs.k4_coefficients(2, 3, seed=1, device="cpu")
        args = (mlp, center, ray, depth, coeffs, kw)
        loss, grads = cs.k4_grads(*args)
        loss_ref, grads_ref = cs.k4_grads(*args, plain=True)
        assert len(grads) == len(grads_ref) == 2 + n_params
        assert torch.equal(loss, loss_ref)
        for g, r in zip(grads, grads_ref):
            assert torch.equal(g, r) and float(r.abs().max()) > 0
        _, frozen = cs.k4_grads(*args, frozen=True)
        assert len(frozen) == 2
        assert torch.equal(frozen[0], grads[0]) and torch.equal(frozen[1], grads[1])
        assert all(p.requires_grad for p in mlp.parameters())
        for g64, g in zip(cs.k4_weight_grads_f64(*args), grads[2:]):
            assert g64.dtype == torch.float64 and g64.shape == g.shape
            assert float((g64 - g).abs().max()) <= 1e-4 * float(g64.abs().max())

        sq, _, grads_k2 = cs.k2_wrapper(mlp, center, ray, depth, target, kw, 0.5)
        loss_34, grads_34 = cs.route_k3_k4(mlp, center, ray, depth, target, kw, 0.5)
        torch.testing.assert_close(loss_34, 0.5 * sq / 18, rtol=1e-6, atol=0)
        for g, r in zip(grads_34, grads_k2):
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6 * float(r.abs().max()))
