"""The port's quality harness (neural_invertible_warp_tpu_torch/evidence)
against the JAX package's (tools/evidence_r2.py, tools/probe_b3.py,
tools/probe_zoo_r4.py) on the CPU: the in-memory scenes against the files
tests/synth_data.py writes, the dict configs against their YAML, ``build``
against ``evidence_r2.build``, ``relative_pose_error``, ``RUNS``, and a tiny
run of probe_b3 whose initial readout is held against the JAX harness's on
the same arrays."""

import math
import os
import sys

import numpy as np
import pytest
import torch

import synth_data
from neural_invertible_warp_tpu import config as jax_config
from neural_invertible_warp_tpu_torch.data import get_dataset
from neural_invertible_warp_tpu_torch.dotdict import DotDict
from neural_invertible_warp_tpu_torch.evidence import (configs, harness, probe_b3,
                                                       probe_zoo_r4, scenes)

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import evidence_r2 as jax_harness  # noqa: E402
import probe_b3 as jax_b3  # noqa: E402
import probe_zoo_r4 as jax_zoo  # noqa: E402

# a render on the card may differ from the PNGs by one level at a few pixels
MAX_LEVEL_DIFF = 1
MAX_PIXEL_SHARE = 1e-3
TOL_CAMERA = 1e-6
TOL_READOUT = 1e-5
# keys of tools/probe_zoo_r4.py::run_one's record (max_rel_after_half where
# two or more rows lie in the second half)
JAX_RECORD_KEYS = {"name", "model", "yaml", "horizon", "note", "init_rot_deg",
                   "init_trans", "train_psnr", "final_rot_deg", "final_rot_rel_deg",
                   "final_trans", "max_rel_after_half", "loss_ga", "val_psnr",
                   "ms_per_step", "elapsed_s"}
# options left out of the build comparison: none differ
LEFT_OUT = ()

# the scenes at 8 views of 24x32 (Blender: 6 + 2 views of 24x24)
SCENE_CASES = {
    "llff": dict(backdrop=False, dense=False),
    "llff_backdrop": dict(backdrop=True, dense=False),
    "llff_dense": dict(backdrop=True, dense=True),
    "blender": None,
}


@pytest.fixture(scope="module")
def written_scenes(tmp_path_factory):
    """dict case -> (port arrays per split, loader arrays per split), the
    loaders reading what synth_data wrote at the same seed."""
    out = {}
    for case, kw in SCENE_CASES.items():
        root = str(tmp_path_factory.mktemp(case))
        if kw is None:
            opt, _ = synth_data.make_blob_blender_scene(root, n_train=6, n_val=2, n_test=2,
                                                        img_size=24)
            train, val, _ = scenes.blob_blender_arrays(n_train=6, n_val=2, img_size=24)
        else:
            opt, _ = synth_data.make_blob_llff_scene(root, n_images=8, img_size=(24, 32),
                                                     val_ratio=0.25, **kw)
            train, val, _ = scenes.blob_llff_arrays(n_images=8, img_size=(24, 32),
                                                    val_ratio=0.25, **kw)
        popt = DotDict(opt.to_plain())
        loader = get_dataset(popt.data.dataset)
        ref = {split: loader.Dataset(popt, split=split).all_arrays(popt)
               for split in ("train", "val")}
        out[case] = ({"train": train, "val": val}, ref)
    return out


@pytest.mark.parametrize("case", sorted(SCENE_CASES))
def test_scene_arrays_equal_what_the_loaders_read(written_scenes, case):
    """Each in-memory scene equals the port's loaders on synth_data's files:
    images in uint8 levels (at most one level at 0.1% of the pixels), poses
    and intrinsics to 1e-6, the same keys, dtypes and indices."""
    got_splits, ref_splits = written_scenes[case]
    for split in ("train", "val"):
        got, ref = got_splits[split], ref_splits[split]
        assert sorted(got) == sorted(ref) and len(ref["idx"]) > 0, split
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, (split, k)
        levels = np.abs(np.round(got["image"] * 255) - np.round(ref["image"] * 255))
        differ = (levels > 0).any(-1)
        print("{}/{}: {} of {} pixels differ, by at most {} level(s)".format(
            case, split, int(differ.sum()), differ.size, levels.max()))
        assert levels.max() <= MAX_LEVEL_DIFF, (split, levels.max())
        assert differ.mean() <= MAX_PIXEL_SHARE, (split, int(differ.sum()))
        for k in ("pose", "intr"):
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=TOL_CAMERA, err_msg=k)
        np.testing.assert_array_equal(got["idx"], ref["idx"])


# render_blobs' float maps against tests/synth_data.py's JAX render: two
# fp32 evaluations of the same sums in other orders. The SfM scene's opaque
# blobs (densities x40) condition the opacity worst: 9.3e-6 of max on the
# CPU, the other maps 2e-7 to 6e-6
TOL_MAPS = 5e-5


@pytest.mark.parametrize("wall", ["none", "spots", "tex"])
def test_render_blobs_maps_equal_synth_data(wall, monkeypatch):
    """render_blobs' rgb, depth and opacity against
    synth_data.analytic_blob_render(return_depth=True): without a wall on
    the Blender cameras, with chip_smoke.py's SfM wall of colour spots
    (make_sfm_scene's own arguments, 2 views of 12x16), and with the blob
    DTU scene's textured blobs (``tex``) and spotted wall (2 views of
    12x16), within TOL_MAPS of each map's max."""
    if wall == "tex":
        scene = scenes.dtu_scene(2, (12, 16))
        assert "tex" in scene["blob"]
        args = (scene["render_pose"], scene["intr"], 12, 16, scene["blob"])
        kw = dict(n_samples=256, depth_range=(1.2, 6.2), backdrop=scene["backdrop"])
        got = scenes.render_blobs(*args, **kw)
    elif wall == "none":
        pose = np.stack([scenes.blender.raw_to_w2c(m)
                         for m in scenes.blender_c2w(2, 0)["train"]])
        intr = scenes._intrinsics(200.0, 800, 800, 12, 12, 2)
        args = (pose, intr, 12, 12, scenes.blob_params(seed=7, n_blobs=12))
        kw = dict(depth_range=(2.0, 6.0))
        got = scenes.render_blobs(*args, **kw)
    else:
        sys.path.insert(0, ROOT)
        import chip_smoke
        seen = {}
        real = chip_smoke.blob_render

        def spy(*a, **k):
            seen.update(args=a, out=real(*a, **k))
            return seen["out"]
        monkeypatch.setattr(chip_smoke, "blob_render", spy)
        scene = chip_smoke.make_sfm_scene(12, 16, 2, "cpu")
        got = seen["out"]
        assert got[0] is scene["image"] and got[1] is scene["depth_gt"]
        args, bd = seen["args"][:5], seen["args"][5]
        assert "spot_uv" in bd
        kw = dict(depth_range=(1.5, 7.0), backdrop=bd)
    ref = synth_data.analytic_blob_render(*args, return_depth=True, **kw)
    for name, g, r in zip(("rgb", "depth", "opacity"), got, ref):
        err = float(np.abs(g - r).max()) / float(np.abs(r).max())
        print("{} {}: {:.3e} of max".format(wall, name, err))
        assert g.shape == r.shape and err <= TOL_MAPS, (name, err)


def test_rows_run_each_probe_by_its_module_name():
    """Every row's command runs its probe as python -m <the probe's full
    module name>, and every zoo run is a row of its own."""
    import importlib
    from neural_invertible_warp_tpu_torch.evidence import rows
    assert set(probe_zoo_r4.RUNS) <= set(rows.ROWS)
    for row in rows.ROWS:
        cmd = rows.row_command(row, "out", "cpu", iters=10)
        assert cmd[1] == "-m" and cmd[2].startswith("neural_invertible_warp_tpu_torch.evidence.")
        assert hasattr(importlib.import_module(cmd[2]), "main"), row
    assert rows.row_command("garf_20k", "out", "cpu")[3:5] == ["--run", "garf_20k"]
    with pytest.raises(SystemExit):
        probe_zoo_r4.main(["--device=cpu"])


@pytest.mark.parametrize("name", sorted(configs.YAMLS))
def test_dict_configs_equal_their_yaml(name):
    got = configs.yaml_options(name)
    assert type(got) is DotDict
    assert got.to_plain() == jax_config.load_options("options/{}.yaml".format(name)).to_plain()
    assert configs.yaml_options(name) is not got


def test_apply_overrides_sets_typed_values_as_the_cli_does():
    over = {"barf_c2f": [0.1, 0.5], "nerf.depth.range": [1, 8], "tpu.fused_pe": False,
            "data.root": "/x/y", "optim.warmup_pose": None, "max_iter": 20000}
    cli = ["--barf_c2f=[0.1,0.5]", "--nerf.depth.range=[1,8]", "--tpu.fused_pe=false",
           "--data.root=/x/y", "--optim.warmup_pose=", "--max_iter=20000"]
    got = configs.apply_overrides(configs.yaml_options("barf_llff"), over)
    ref = jax_config.override_options(jax_config.load_options("options/barf_llff.yaml"),
                                      jax_config.parse_arguments(cli), safe_check=True)
    assert got.to_plain() == ref.to_plain()
    with pytest.raises(KeyError, match="nerf.nope"):
        configs.apply_overrides(configs.yaml_options("barf_llff"), {"nerf.nope": 1})
    assert harness.parse_overrides(["tpu.fused_pe=false", "barf_c2f=[0.1, 0.5]",
                                    "data.root=/x/y", "a.b=3"]) == {
        "tpu.fused_pe": False, "barf_c2f": [0.1, 0.5], "data.root": "/x/y", "a.b": 3}


class _Captured(Exception):
    pass


def _jax_build(yaml_name, overrides):
    """evidence_r2.build, with the settings its process_options gives JAX
    (matmul precision, a compilation cache) set back afterwards, so the
    tests that run after these in the same process see JAX as before."""
    import jax
    keys = ("jax_default_matmul_precision", "jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        return jax_harness.build(yaml_name, overrides)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


@pytest.fixture
def jax_build(monkeypatch, tmp_path):
    """A function: the JAX options of probe_b3 ("b3", with its arguments) or
    of a RUNS entry. The JAX probe is run until it calls evidence_r2.build
    (its scene makers stubbed: no file is written), then that build is
    made; both packages' builds take the same output and scene roots."""
    calls = []

    def capture(yaml_name, overrides):
        calls.append((yaml_name, list(overrides)))
        raise _Captured

    monkeypatch.setattr(jax_harness, "build", capture)
    for maker in ("make_blob_llff_scene", "make_blob_blender_scene"):
        monkeypatch.setattr(synth_data, maker, lambda *a, **k: None)
    monkeypatch.setattr(jax_zoo, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(jax_zoo, "SCENE_ROOT", str(tmp_path / "scenes"))
    monkeypatch.chdir(tmp_path)

    def build(name, b3_args=()):
        calls.clear()
        with pytest.raises(_Captured):
            if name == "b3":
                monkeypatch.setattr(sys, "argv", ["probe_b3.py"] + list(b3_args))
                jax_b3.main()
            else:
                jax_zoo.run_one(name)
        (yaml_name, overrides), = calls
        monkeypatch.undo()
        return _jax_build(yaml_name, overrides)

    return build


def _comparable(opt):
    plain = opt.to_plain()
    for dotted in LEFT_OUT:
        *keys, last = dotted.split(".")
        sub = plain
        for k in keys:
            sub = sub[k]
        sub.pop(last)
    return plain


@pytest.mark.parametrize("name", ["b3"] + sorted(probe_zoo_r4.RUNS))
def test_build_equals_the_jax_build(jax_build, tmp_path, name):
    """The port's options of probe_b3 (with an --overrides pair) and of each
    RUNS entry equal what the JAX probes build, key for key."""
    b3_args = ["--scene-root", str(tmp_path / "scene"), "--out-root", str(tmp_path / "out"),
               "--iters", "4", "--seed", "2"]
    ref = jax_build(name, b3_args + ["--overrides", "tpu.fused_pe=false"])
    if name == "b3":
        got = probe_b3.probe_options(probe_b3.parse_args(
            b3_args + ["--overrides", "tpu.fused_pe=false"]))
    else:
        got, _ = probe_zoo_r4.run_options(name, out_dir=str(tmp_path))
    assert _comparable(got) == _comparable(ref)


def test_runs_equal_the_jax_runs():
    """RUNS and DEFAULT_ORDER equal tools/probe_zoo_r4.py's; each entry's
    overrides as the JAX CLI parses them."""
    assert probe_zoo_r4.DEFAULT_ORDER == jax_zoo.DEFAULT_ORDER
    assert sorted(probe_zoo_r4.RUNS) == sorted(jax_zoo.RUNS)

    def dotted(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(dotted(v, prefix + k + "."))
            else:
                out[prefix + k] = v
        return out

    for name, ref in jax_zoo.RUNS.items():
        got = probe_zoo_r4.RUNS[name]
        assert {k: v for k, v in got.items() if k != "overrides"} == \
            {k: v for k, v in ref.items() if k != "overrides"}, name
        assert got["overrides"] == dotted(
            jax_config.parse_arguments(ref["overrides"]).to_plain()), name


class _Poses:
    """A system stand-in that returns given training poses."""

    def __init__(self, pred, gt, to):
        self.poses = (None if pred is None else to(pred), to(gt))

    def get_all_training_poses(self, state=None):
        return self.poses


def test_relative_pose_error_equals_the_jax_one():
    rng = np.random.RandomState(0)
    from scipy.spatial.transform import Rotation
    pred, gt = (np.concatenate([Rotation.from_rotvec(rng.randn(12, 3)).as_matrix(),
                                rng.randn(12, 3, 1)], -1).astype(np.float32)
                for _ in range(2))
    for n_pairs, seed in ((200, 0), (17, 3)):
        got = harness.relative_pose_error(_Poses(pred, gt, torch.as_tensor), n_pairs, seed)
        ref = jax_harness.relative_pose_error(_Poses(pred, gt, np.asarray), None,
                                              n_pairs, seed)
        assert got == ref and 0 < got < 180
    assert math.isnan(harness.relative_pose_error(_Poses(None, gt, torch.as_tensor)))


def test_probes_refuse_to_fall_back_to_the_cpu(tmp_path):
    """Without a card and without --device=cpu the probes raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device=cpu"):
        probe_b3.main(["--iters", "1", "--out-root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device=cpu"):
        probe_zoo_r4.main(["--run", "garf_20k", "--out-dir", str(tmp_path)])


TINY = ["--device=cpu", "--iters", "4", "--log-every", "2", "--n-images", "8",
        "--size", "24,32", "--max-iter", "4", "--max-pe-iter", "2"]
TINY_OVER = ["data.val_ratio=0.25", "nerf.rand_rays=32", "nerf.sample_intvs=8"]


def test_probe_b3_tiny_run_on_cpu(tmp_path, monkeypatch):
    """probe_b3's main on the CPU (6 train views of 24x32, 4 steps of 32
    rays x 8 samples): its initial readout (aligned error, and the relative
    rotation error) agrees with the JAX harness's on the same arrays within
    1e-5, and its record has the JAX record's keys and finite values."""
    seen = {}
    make_trainer = harness.make_trainer

    def spy_trainer(opt, train, val, device):
        seen.update(opt=opt, train=train, val=val)
        return make_trainer(opt, train, val, device)

    def spy_initial(system):
        seen["rel"] = harness.relative_pose_error(system)
        seen["init"] = initial(system)
        return seen["init"]

    initial = harness.initial_pose_error
    monkeypatch.setattr(harness, "make_trainer", spy_trainer)
    monkeypatch.setattr(harness, "initial_pose_error", spy_initial)
    out = tmp_path / "rows.jsonl"
    rec = probe_b3.main(TINY + ["--out-root", str(tmp_path), "--out", str(out),
                                "--overrides"] + TINY_OVER)
    assert len(seen["train"]["idx"]) == 6 and len(seen["val"]["idx"]) == 2

    # the JAX harness on the same arrays: its build, system and readout
    import jax
    from neural_invertible_warp_tpu.models import get_system_class
    from neural_invertible_warp_tpu.ops import pose as jax_pose
    opt = _jax_build("barf_inn_llff", [
        "--model=barf_inn_llff", "--yaml=barf_inn_llff", "--data.val_ratio=0.25",
        "--data.image_size=[24,32]", "--barf_c2f=[0.1,0.5]",
        "--inn.real_nvp.max_pe_iter=2", "--loss_weight.global_alignment=4",
        "--max_iter=4", "--output_root={}".format(tmp_path / "jax"),
        "--nerf.rand_rays=32", "--nerf.sample_intvs=8"])
    system = get_system_class(opt.model)(opt)
    system.attach_data(seen["train"], seen["val"])
    state = system.init_state(jax.random.PRNGKey(0))
    rel = jax_harness.relative_pose_error(system, state)
    aux0 = dict(state["aux"])
    aux0["global_rigid"] = np.asarray(jax_pose.identity_pose((aux0["global_rigid"].shape[0],)))
    R0, t0 = system.evaluate_camera_alignment(dict(state, aux=aux0))
    ref = dict(rot=float(np.rad2deg(np.mean(R0))), trans=float(np.mean(t0)))
    print("initial readout: port {} rel {}; JAX {} rel {}".format(
        seen["init"], seen["rel"], ref, rel))
    for k in ("rot", "trans"):
        assert abs(seen["init"][k] - ref[k]) <= TOL_READOUT * max(1.0, abs(ref[k])), k
    assert abs(seen["rel"] - rel) <= TOL_READOUT * max(1.0, rel)

    assert JAX_RECORD_KEYS <= set(rec), JAX_RECORD_KEYS - set(rec)
    assert [r["it"] for r in rec["history"]] == [2, 4]
    assert list(rec["history"][0]) == ["it", "psnr", "loss_ga", "err_R_deg", "err_t",
                                       "err_R_rel", "elapsed"]
    values = [v for r in rec["history"] for v in r.values()]
    values += [v for v in rec.values() if isinstance(v, (int, float))]
    assert all(math.isfinite(v) for v in values)
    assert rec["device"] == "cpu" and rec["card"] is None
    import json
    assert [json.loads(line) for line in out.read_text().splitlines()] == [rec]
    assert "| it | psnr | loss_ga |" in harness.fmt_history(rec["history"])
