"""The port's DTU and extra-dataset probes (neural_invertible_warp_tpu_torch/
evidence: probe_dtu, probe_extra_datasets, the DTU, iPhone and
Tanks-and-Temples scenes) against the JAX package's tools
(tools/probe_dtu.py, tools/probe_extra_datasets.py) on the CPU: the
in-memory scenes against the files tests/synth_data.py writes, read back by
the port's loaders; each probe's options against the JAX probe's; the
metric helpers; and a tiny probe_dtu run whose initial readout is held
against the JAX DTU system's on the same arrays."""

import math
import os
import sys

import numpy as np
import pytest
import torch

import synth_data
from neural_invertible_warp_tpu_torch.data import get_dataset
from neural_invertible_warp_tpu_torch.dotdict import DotDict
from neural_invertible_warp_tpu_torch.evidence import (harness, probe_dtu,
                                                       probe_extra_datasets, scenes)

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import evidence_r2 as jax_harness  # noqa: E402
import probe_dtu as jax_dtu  # noqa: E402
import probe_extra_datasets as jax_extra  # noqa: E402

# a render here may differ from synth_data's JAX render by one uint8 level
# at a few pixels, and put a pixel's opacity on the other side of 0.5
MAX_LEVEL_DIFF = 1
MAX_PIXEL_SHARE = 1e-3
TOL_CAMERA = 1e-6
TOL_DEPTH_REL = 1e-5
TOL_READOUT = 1e-5

# the tiny scenes: 8 DTU views at 15x20, 24 frames at 18x32
DTU_VIEWS, DTU_HW = 8, (15, 20)
VIDEO_FRAMES, VIDEO_HW = 24, (18, 32)
WIDEN = 0.15


def _loader_opt(kind, root):
    """Port options that read synth_data's files of ``kind`` as the probes
    read theirs (barf_iphone's val_ratio 0.1, tandt's 8, DTU widened 15%)."""
    H, W = DTU_HW if kind == "dtu" else VIDEO_HW
    if kind == "dtu":
        opt = DotDict(synth_data.dtu_opt(root, H, W).to_plain())
        opt.data.dtu.increase_depth_range_by_x_percent = WIDEN
        return opt
    scene = dict(iphone="vid", tandt="Ballroom")[kind]
    return DotDict(dict(H=H, W=W, data=dict(
        root=root, dataset=kind, scene=scene, image_size=[H, W], num_workers=2,
        preload=True, val_ratio=0.1 if kind == "iphone" else 8, augment={},
        center_crop=None)))


@pytest.fixture(scope="module")
def written_scenes(tmp_path_factory):
    """dict kind -> (port arrays per split, loader arrays per split, extra):
    the loaders read what synth_data wrote at the same seed; extra holds
    the iPhone's true poses, the port's and the file's."""
    out = {}
    for kind in ("dtu", "iphone", "tandt"):
        root = str(tmp_path_factory.mktemp(kind))
        extra = None
        if kind == "dtu":
            synth_data.make_blob_dtu_scene(root, n_images=DTU_VIEWS, H=DTU_HW[0], W=DTU_HW[1])
            train, test, _ = scenes.blob_dtu_arrays(DTU_VIEWS, DTU_HW, widen=WIDEN)
            got, splits = {"train": train, "test": test}, ("train", "test")
        elif kind == "iphone":
            synth_data.make_blob_iphone_scene(root, n_images=VIDEO_FRAMES, img_size=VIDEO_HW,
                                              path_scale=0.35)
            train, val, true_w2c = scenes.blob_iphone_arrays(VIDEO_FRAMES, VIDEO_HW,
                                                             path_scale=0.35)
            got, splits = {"train": train, "val": val}, ("train", "val")
            extra = (true_w2c, np.load(os.path.join(root, "vid", "poses_true_w2c.npy")))
        else:
            synth_data.make_blob_tandt_scene(root, n_images=VIDEO_FRAMES, img_size=VIDEO_HW,
                                             arc_scale=0.1)
            train, val, _ = scenes.blob_tandt_arrays(VIDEO_FRAMES, VIDEO_HW, arc_scale=0.1)
            got, splits = {"train": train, "val": val}, ("train", "val")
        opt = _loader_opt(kind, root)
        loader = get_dataset(kind)
        ref = {split: loader.Dataset(opt, split=split).all_arrays(opt) for split in splits}
        out[kind] = (got, ref, extra)
    return out


def _share_differ(got, ref):
    """(largest difference, share of the pixels that differ) of two
    [B,H,W(,C)] maps."""
    diff = np.abs(got - ref)
    differ = diff > 0 if diff.ndim == 3 else (diff > 0).any(-1)
    return float(diff.max()), float(differ.mean())


@pytest.mark.parametrize("kind", ["dtu", "iphone", "tandt"])
def test_scene_arrays_equal_what_the_loaders_read(written_scenes, kind):
    """Each in-memory scene equals the port's loader on synth_data's files:
    the same keys, dtypes, shapes and indices; images in uint8 levels (at
    most one level, at no more than 0.1% of the pixels); poses and
    intrinsics to 1e-6; DTU's depth to 1e-5 relative where both are valid,
    its masks equal but at 0.1% of the pixels, its depth range equal; the
    iPhone's true poses equal to poses_true_w2c.npy."""
    got_splits, ref_splits, extra = written_scenes[kind]
    for split, ref in ref_splits.items():
        got = got_splits[split]
        assert sorted(got) == sorted(ref) and len(ref["idx"]) > 0, split
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, (split, k)
        levels, share = _share_differ(np.round(got["image"] * 255), np.round(ref["image"] * 255))
        print("{}/{}: images differ at {:.3e} of the pixels, by at most {} level(s)".format(
            kind, split, share, levels))
        assert levels <= MAX_LEVEL_DIFF and share <= MAX_PIXEL_SHARE, (split, levels, share)
        for k in ("pose", "intr"):
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=TOL_CAMERA, err_msg=k)
        np.testing.assert_array_equal(got["idx"], ref["idx"])
        if kind != "dtu":
            continue
        for k in ("fg_mask", "valid_depth_gt"):
            _, share = _share_differ(got[k], ref[k])
            print("{}/{}: {} differs at {:.3e} of the pixels".format(kind, split, k, share))
            assert share <= MAX_PIXEL_SHARE, (split, k, share)
        both = (got["valid_depth_gt"] > 0) & (ref["valid_depth_gt"] > 0)
        rel = np.abs(got["depth_gt"] - ref["depth_gt"])[both] / np.abs(ref["depth_gt"][both])
        print("{}/{}: depth within {:.3e} relative".format(kind, split, rel.max()))
        assert both.any() and rel.max() <= TOL_DEPTH_REL, (split, rel.max())
        np.testing.assert_array_equal(got["depth_range"], ref["depth_range"])
    if kind == "iphone":
        np.testing.assert_array_equal(*extra)


class _Captured(Exception):
    pass


@pytest.fixture
def jax_probe_options(monkeypatch, tmp_path):
    """A function: the JAX options that tools/probe_dtu.py ("dtu", with its
    arguments) or tools/probe_extra_datasets.py (a ``--run`` name) hands to
    evidence_r2.make_trainer, after its own edits. The probe runs with its
    scene makers stubbed (no scene is rendered) and its output root moved
    to ``tmp_path / "out"`` (probe_dtu) or ``tmp_path`` (the extra
    datasets' OUT_DIR)."""
    import jax
    seen = {}
    real_build = jax_harness.build
    jax_keys = ("jax_default_matmul_precision", "jax_compilation_cache_dir",
                "jax_persistent_cache_min_compile_time_secs")

    def build(yaml_name, overrides):
        # the settings the JAX build gives JAX are set back afterwards, so
        # the tests after these in the same process see JAX as before
        overrides = ["--output_root={}".format(tmp_path / "out")
                     if o.startswith("--output_root=/tmp/probe_dtu") else o for o in overrides]
        saved = {k: getattr(jax.config, k) for k in jax_keys}
        try:
            return real_build(yaml_name, overrides)
        finally:
            for k, v in saved.items():
                jax.config.update(k, v)

    def capture(opt):
        seen["opt"] = opt
        raise _Captured

    def iphone_scene(root, n_images=24, path_scale=1.0, **kw):
        os.makedirs(os.path.join(root, "vid"), exist_ok=True)
        np.save(os.path.join(root, "vid", "poses_true_w2c.npy"),
                np.zeros((n_images, 3, 4), np.float32))

    def probe(name, dtu_args=()):
        monkeypatch.setattr(jax_harness, "build", build)
        monkeypatch.setattr(jax_harness, "make_trainer", capture)
        monkeypatch.setattr(synth_data, "make_blob_dtu_scene", lambda *a, **k: None)
        monkeypatch.setattr(synth_data, "make_blob_tandt_scene", lambda *a, **k: None)
        monkeypatch.setattr(synth_data, "make_blob_iphone_scene", iphone_scene)
        monkeypatch.setattr(jax_extra, "OUT_DIR", str(tmp_path))
        monkeypatch.setattr(jax_extra, "SCENE_ROOT", str(tmp_path / "scenes"))
        seen.clear()
        try:
            with pytest.raises(_Captured):
                if name == "dtu":
                    monkeypatch.setattr(sys, "argv", ["probe_dtu.py"] + list(dtu_args))
                    jax_dtu.main()
                else:
                    monkeypatch.setattr(sys, "argv", ["probe_extra_datasets.py", "--run", name,
                                                      "--horizon", "20000"])
                    jax_extra.main()
        finally:
            monkeypatch.undo()
        return seen["opt"]

    return probe


def _dtu_args(tmp_path, model, init):
    """(the JAX probe's arguments, the port probe's) for one (model, init)
    with an override and a seed."""
    common = ["--model", model, "--init", init, "--seed", "2", "--size", "30,40"]
    return (common + ["--scene-root", probe_dtu.SCENE_ROOT, "--overrides=--nerf.rand_rays=512"],
            common + ["--out-root", str(tmp_path / "out"), "--overrides", "nerf.rand_rays=512"])


@pytest.mark.parametrize("init", probe_dtu.INITS)
@pytest.mark.parametrize("model", probe_dtu.MODELS)
def test_probe_dtu_options_equal_the_jax_build(jax_probe_options, tmp_path, model, init):
    """probe_dtu's options for every (model, init) equal tools/probe_dtu.py's
    as it hands them to make_trainer (barf_dtu's se3 edit included), key for
    key."""
    jax_args, port_args = _dtu_args(tmp_path, model, init)
    ref = jax_probe_options("dtu", jax_args)
    got = probe_dtu.probe_options(probe_dtu.parse_args(port_args))
    assert got.to_plain() == ref.to_plain()
    if model == "barf_dtu":
        assert got.pose.parameterization == "se3"


@pytest.mark.parametrize("run", sorted(probe_extra_datasets.RUNS))
def test_probe_extra_datasets_options_equal_the_jax_build(jax_probe_options, tmp_path, run):
    """probe_extra_datasets' options for every --run (each one of the JAX
    tool's choices) equal tools/probe_extra_datasets.py's, key for key."""
    ref = jax_probe_options(run)
    got = probe_extra_datasets.run_options(run, 20000, out_dir=str(tmp_path))
    assert got.to_plain() == ref.to_plain()


def _random_w2c(rng, n, spread):
    from scipy.spatial.transform import Rotation
    return np.concatenate([Rotation.from_rotvec(spread * rng.randn(n, 3)).as_matrix(),
                           rng.randn(n, 3, 1)], -1)


@pytest.mark.parametrize("spread", [0.05, 1.0])
def test_metric_helpers_equal_the_jax_tools(spread):
    """rel_rot_err_deg and aligned_center_err against the JAX tool's on
    random poses (near each other and far apart); a collapsed prediction
    (every center at the origin) too."""
    rng = np.random.RandomState(3)
    true = _random_w2c(rng, 22, 1.0)
    pred = true.copy()
    pred[:, :, :3] = _random_w2c(rng, 22, spread)[:, :, :3] @ true[:, :, :3]
    pred[:, :, 3] += spread * rng.randn(22, 3)
    for n_pairs, seed in ((300, 0), (17, 5)):
        assert probe_extra_datasets.rel_rot_err_deg(pred, true, n_pairs, seed) == \
            jax_extra.rel_rot_err_deg(pred, true, n_pairs, seed)
    collapsed = np.tile(np.eye(3, 4), (22, 1, 1))
    for p in (pred, collapsed):
        got = probe_extra_datasets.aligned_center_err(p, true)
        ref = jax_extra.aligned_center_err(p, true)
        assert math.isfinite(got) and got == pytest.approx(ref, rel=1e-12, abs=1e-15)


def test_probes_refuse_to_fall_back_to_the_cpu(tmp_path):
    """Without a card and without --device=cpu both probes raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device=cpu"):
        probe_dtu.main(["--iters", "1", "--out-root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device=cpu"):
        probe_extra_datasets.main(["--run", "tandt_narrow", "--out-dir", str(tmp_path)])


TINY = ["--device=cpu", "--iters", "4", "--log-every", "2", "--n-images", str(DTU_VIEWS),
        "--size", "{},{}".format(*DTU_HW), "--init", "identity"]
TINY_OVER = ["nerf.rand_rays=32", "nerf.sample_intvs=8", "optim.test_iter=2"]


def test_probe_dtu_tiny_run_on_cpu(jax_probe_options, tmp_path, monkeypatch):
    """probe_dtu's main on the CPU (barf_inn_dtu from the identity, 7 train
    views of 15x20, 4 steps of 32 rays x 8 samples, 2 refinement steps per
    test view): its initial readout agrees with the JAX DTU system's on the
    same arrays within 1e-5, and its record has the DTU evaluation's keys
    beside run_record's, finite values and LPIPS None."""
    seen = {}
    make_trainer = harness.make_trainer

    def spy_trainer(opt, train, test, device):
        seen.update(train=train, test=test)
        return make_trainer(opt, train, test, device)

    def spy_initial(system):
        seen["init"] = initial(system)
        return seen["init"]

    initial = harness.initial_pose_error
    monkeypatch.setattr(harness, "make_trainer", spy_trainer)
    monkeypatch.setattr(harness, "initial_pose_error", spy_initial)
    out = tmp_path / "rows.jsonl"
    rec = probe_dtu.main(TINY + ["--out-root", str(tmp_path / "out"), "--out", str(out),
                                 "--overrides"] + TINY_OVER)
    assert len(seen["train"]["idx"]) == DTU_VIEWS - 1 and len(seen["test"]["idx"]) == 1

    # the JAX DTU system on the same arrays, from the JAX probe's options
    import jax
    from neural_invertible_warp_tpu.models import get_system_class
    opt = jax_probe_options("dtu", TINY[1:] + [
        "--scene-root", probe_dtu.SCENE_ROOT,
        "--overrides=" + ",".join("--" + o for o in TINY_OVER)])
    system = get_system_class(opt.model)(opt)
    system.attach_data(seen["train"], seen["test"])
    state = system.init_state(jax.random.PRNGKey(0))
    R0, t0 = system.evaluate_camera_alignment(state)
    ref = dict(rot=float(np.rad2deg(np.mean(R0))), trans=float(np.mean(t0)))
    print("initial readout: port {}; JAX {}".format(seen["init"], ref))
    for k in ("rot", "trans"):
        assert abs(seen["init"][k] - ref[k]) <= TOL_READOUT * max(1.0, abs(ref[k])), k

    keys = set(harness.DTU_EVAL_KEYS) | {"init_rot_deg", "final_rot_deg", "final_rot_rel_deg",
                                         "final_trans", "train_psnr", "val_psnr",
                                         "ms_per_step", "horizon", "history"}
    assert keys <= set(rec), keys - set(rec)
    assert rec["horizon"] == 200000 and rec["iters"] == 4 and rec["init"] == "identity"
    assert rec["LPIPS"] is None and rec["LPIPS_masked"] is None
    values = [v for r in rec["history"] for v in r.values()]
    values += [v for v in rec.values() if isinstance(v, (int, float))]
    assert all(math.isfinite(v) for v in values)
    import json
    assert [json.loads(line) for line in out.read_text().splitlines()] == [rec]


def test_rows_d_and_x_cut_as_the_others():
    """Rows D1-D3 run probe_dtu and X1-X2 probe_extra_datasets; --iters cuts
    probe_dtu's steps (its schedule stays) and the extra datasets' horizon."""
    from neural_invertible_warp_tpu_torch.evidence import rows
    for row, model, init in (("D1", "barf_inn_dtu", "noisy_gt"), ("D2", "barf_dtu", "noisy_gt"),
                             ("D3", "barf_inn_dtu", "colmap")):
        cmd = rows.row_command(row, "out", "cpu", iters=300)
        assert cmd[2] == "neural_invertible_warp_tpu_torch.evidence.probe_dtu"
        args = probe_dtu.parse_args(cmd[3:])
        assert (args.model, args.init, args.iters, args.log_every, args.name) == (
            model, init, 300, 150, row)
        assert args.out == os.path.join("out", row + ".jsonl")
        assert probe_dtu.parse_args(rows.row_command(row, "out", "cpu")[3:]).iters == 30000
    for row, run in (("X1", "iphone_narrow"), ("X2", "tandt_narrow")):
        cmd = rows.row_command(row, "out", "cpu", iters=300)
        assert cmd[2] == "neural_invertible_warp_tpu_torch.evidence.probe_extra_datasets"
        assert cmd[cmd.index("--run") + 1] == run
        at = [i for i, w in enumerate(cmd) if w == "--horizon"]
        assert [cmd[i + 1] for i in at] == ["20000", "300"]
        assert cmd[cmd.index("--tag") + 1] == row
        assert cmd[cmd.index("--out-dir") + 1] == os.path.join("out", row)
