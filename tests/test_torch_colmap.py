"""The port's COLMAP I/O, the SfM pose inits of the DTU systems and the pose
video against the JAX package on the CPU.

* ``utils/colmap_io.py``: a model written by one package and read by the
  other, binary and text, and the same bytes from both writers; the
  quaternion helpers, name matching and intrinsics, exactly.
* ``barf_dtu`` with ``pose.init: colmap`` (an injected GT-projection matcher,
  as tests/test_sfm.py drives it) and ``colmap_files`` (a binary model of
  the GT poses under another gauge, image 1 missing) on tests/synth_data.py's
  ``make_dtu_scene`` at 32x40, built through the port's Trainer (which
  hands the training images' names to the system): the initial poses equal
  to the JAX system's to 1e-6, the same valid and excluded images, the
  ``sfm/`` dumps, and one finite train step.
* ``generate_videos_pose`` writes ``poses/<it>.png`` and ``poses.html``.
* SfM on matches that verify nothing: the identity start, all images
  excluded, aligned on all of them, as the JAX package does.
"""

import os
import time

import numpy as np
import jax
import pytest
import torch

import synth_data
from neural_invertible_warp_tpu import config
from neural_invertible_warp_tpu.data import dtu as jdtu
from neural_invertible_warp_tpu.dotdict import DotDict as JDotDict
from neural_invertible_warp_tpu.models import get_system_class as jax_system_class
from neural_invertible_warp_tpu.utils import colmap_io as jcolmap_io
from neural_invertible_warp_tpu.utils import matchers as jmatchers
from neural_invertible_warp_tpu_torch import config as pconfig
from neural_invertible_warp_tpu_torch.dotdict import DotDict
from neural_invertible_warp_tpu_torch.models.engine import Trainer
from neural_invertible_warp_tpu_torch.ops import align
from neural_invertible_warp_tpu_torch.utils import colmap_io, matchers
from test_colmap_io import _assert_models_equal, _random_model

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

H, W = 32, 40


# ------------------------------------------------------------ colmap_io

@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_models_cross_between_the_packages(tmp_path, ext):
    """Each package reads the other's model; both write the same bytes."""
    model = _random_model(np.random.RandomState(0))
    colmap_io.write_model(*model, str(tmp_path / "port"), ext=ext)
    jcolmap_io.write_model(*model, str(tmp_path / "jax"), ext=ext)
    for name in ("cameras", "images", "points3D"):
        got = (tmp_path / "port" / (name + ext)).read_bytes()
        assert got == (tmp_path / "jax" / (name + ext)).read_bytes(), name
        assert len(got) > 20
    assert colmap_io.detect_model_format(str(tmp_path / "jax")) == ext
    _assert_models_equal(model, colmap_io.read_model(str(tmp_path / "jax")))
    _assert_models_equal(model, jcolmap_io.read_model(str(tmp_path / "port")))
    names = ["img_001.png", "missing.png", "img_003.png", "img_005.png"]
    got = colmap_io.poses_from_model(str(tmp_path / "jax"), image_names=names)
    ref = jcolmap_io.poses_from_model(str(tmp_path / "jax"), image_names=names)
    assert got[1:] == ref[1:] == ([0, 2, 3], [1])
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(colmap_io.poses_from_model(str(tmp_path / "port"))[0],
                                  jcolmap_io.poses_from_model(str(tmp_path / "port"))[0])


def test_quaternions_and_intrinsics_are_the_jax_packages():
    rng = np.random.RandomState(1)
    for _ in range(20):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        R = colmap_io.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jcolmap_io.qvec2rotmat(q))
        np.testing.assert_array_equal(colmap_io.rotmat2qvec(R), jcolmap_io.rotmat2qvec(R))
    for model, n in colmap_io.CAMERA_MODEL_IDS.values():
        name = colmap_io.CAMERA_MODELS[model][0]
        cam = colmap_io.Camera(1, name, 640, 480, 100.0 + rng.rand(n) * 300)
        np.testing.assert_array_equal(colmap_io.intrinsics_from_camera(cam),
                                      jcolmap_io.intrinsics_from_camera(cam))
    assert colmap_io.CAMERA_MODELS == jcolmap_io.CAMERA_MODELS


# ---------------------------------------------------- the systems' SfM inits

def _overrides(root, init):
    return ["--model=barf_dtu", "--yaml=barf_dtu", "--data.root={}".format(root),
            "--data.scene=scan1", "--data.image_size=[32,40]", "--data.num_workers=2",
            "--arch.layers_feat=[null,32,32,32,32]", "--arch.layers_rgb=[null,16,3]",
            "--arch.skip=[2]", "--arch.posenc.L_3D=4", "--arch.posenc.L_view=2",
            "--nerf.sample_intvs=16", "--nerf.rand_rays=128",
            "--pose.init={}".format(init), "--max_iter=2", "--freq.ckpt=1"]


def _options(cfg, overrides, out):
    opt = cfg.load_options("options/barf_dtu.yaml")
    opt = cfg.override_options(opt, cfg.parse_arguments(overrides), key_stack=[],
                               safe_check=True)
    opt.H, opt.W = H, W
    opt.output_path = str(out)
    return opt


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The DTU scene, its training split's GT poses, intrinsics and names,
    and a COLMAP binary model of those poses under an arbitrary rigid gauge
    (the sim(3) alignment must undo it), image 1 left out."""
    tmp = tmp_path_factory.mktemp("colmap_scene")
    root = str(tmp / "dtu")
    synth_data.make_dtu_scene(root, H=H, W=W)
    opt = _options(config, _overrides(root, "given"), tmp / "probe")
    ds = jdtu.Dataset(opt, split="train")
    arrays, names = ds.all_arrays(opt), ds.image_names()
    poses_gt = np.asarray(arrays["pose"], np.float64)
    rng = np.random.RandomState(0)
    Q, _ = np.linalg.qr(rng.randn(3, 3))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    g = np.concatenate([Q, rng.randn(3, 1)], axis=1)
    cameras = {1: jcolmap_io.Camera(1, "PINHOLE", W, H, np.array([30.0, 30.0, 20.0, 16.0]))}
    images = {}
    for i, name in enumerate(names):
        if i == 1:
            continue
        Rg = poses_gt[i, :, :3] @ Q.T
        tg = poses_gt[i, :, 3] - Rg @ g[:, 3]
        images[i + 1] = jcolmap_io.Image(i + 1, jcolmap_io.rotmat2qvec(Rg), tg, 1, name,
                                         np.zeros((0, 2)), np.zeros((0,), np.int64))
    model_dir = str(tmp / "colmap_model")
    jcolmap_io.write_model(cameras, images, {}, model_dir, ext=".bin")
    return dict(root=root, tmp=tmp, poses=poses_gt, intr=np.asarray(arrays["intr"], np.float64),
                names=names, model_dir=model_dir)


def _gt_matcher(pkg, scene):
    """tests/test_sfm.py's GT-projection matcher on the scene's poses (a
    fresh one per package: it draws its noise as it goes)."""
    pts = np.random.RandomState(0).randn(120, 3) * 0.5
    return pkg.SyntheticGTMatcher(scene["poses"], scene["intr"], pts, H, W, noise_px=0.2)


def _configure(opt, init, scene, dotdict, matchers_pkg):
    if init == "colmap":
        # tiny 40x32 frames: sub-pixel track quantization avoids merging
        # distinct landmarks that land on the same integer pixel
        opt.pose.sfm = dotdict(dict(matcher=_gt_matcher(matchers_pkg, scene), quant_px=0.25))
    else:
        opt.pose.model_dir = scene["model_dir"]
    return opt


def _load_native_cores():
    """Both packages' native SfM cores loaded, so that both reconstruct on
    them. Another test process may be linking the JAX package's library at
    this moment (it builds in place), so a failed load is tried again."""
    from neural_invertible_warp_tpu.utils import sfm_native as jnative
    from neural_invertible_warp_tpu_torch.utils import sfm_native
    for _ in range(5):
        sfm_native.reset_cache()
        jnative.reset_cache()
        if sfm_native.available() and jnative.available():
            return
        time.sleep(3)
    raise AssertionError("g++ did not build the native core")


@pytest.fixture(scope="module")
def runs(scene):
    """Per init mode: (port Trainer with its system built, the JAX system's
    initial poses, valid and excluded images)."""
    _load_native_cores()
    out = {}
    for init in ("colmap", "colmap_files"):
        over = _overrides(scene["root"], init)
        jopt = _configure(_options(config, over, scene["tmp"] / init / "jax"), init, scene,
                          JDotDict, jmatchers)
        jsys = jax_system_class("barf_dtu")(jopt)
        jsys.attach_data(jdtu.Dataset(jopt, split="train").all_arrays(jopt),
                         jdtu.Dataset(jopt, split="val").all_arrays(jopt))
        jsys.train_image_names = scene["names"]
        init_j = np.asarray(jsys.set_initial_poses(jax.random.PRNGKey(0)))
        popt = _configure(_options(pconfig, over, scene["tmp"] / init / "port"), init, scene,
                          DotDict, matchers)
        trainer = Trainer(popt, "cpu")
        trainer.build_system(*trainer.load_dataset())
        out[init] = (trainer, init_j, jsys.sfm_valid_idx, jsys.sfm_excluded)
    return out


@pytest.mark.parametrize("init", ["colmap", "colmap_files"])
def test_sfm_initial_poses_are_the_jax_systems(init, runs, scene):
    trainer, init_j, valid_j, excluded_j = runs[init]
    system = trainer.system
    assert system.train_image_names == scene["names"]
    assert (system.sfm_valid_idx, system.sfm_excluded) == (valid_j, excluded_j)
    assert sorted(valid_j + excluded_j) == list(range(len(scene["names"])))
    assert excluded_j == ([] if init == "colmap" else [1])
    got = system.aux["initial_poses_w2c"]
    assert got.dtype == torch.float32 and got.shape == init_j.shape
    np.testing.assert_allclose(got.numpy(), init_j, rtol=0, atol=1e-6)
    # aligned into the GT frame: close to the GT poses already
    valid = np.asarray(valid_j)
    R_err, t_err = align._pose_errors_np(got.numpy()[valid], scene["poses"][valid])
    assert np.rad2deg(R_err.mean()) < (2.0 if init == "colmap" else 0.5)
    assert t_err.mean() < 0.05
    if init == "colmap":
        sfm_dir = os.path.join(trainer.opt.output_path, "sfm")
        ref_dir = os.path.join(str(scene["tmp"] / init / "jax"), "sfm")
        for name in ("matches.npz", "initial_poses.npz"):
            got_npz, ref_npz = np.load(os.path.join(sfm_dir, name)), np.load(
                os.path.join(ref_dir, name))
            assert sorted(got_npz.files) == sorted(ref_npz.files)
            for k in ref_npz.files:
                np.testing.assert_array_equal(got_npz[k], ref_npz[k])
    metrics = system.train_step()
    assert np.isfinite(float(metrics["loss_all"]))


def test_pose_video_writes_the_plots_and_the_viewer(runs):
    """generate_videos_pose on the CPU: the current state as iteration 0 and
    the numbered checkpoint of iteration 1 (2 has none and is skipped)."""
    from neural_invertible_warp_tpu_torch.utils import ckpt, vis
    trainer = runs["colmap_files"][0]
    opt = trainer.opt
    ckpt.save(opt.output_path, trainer.system, 1)
    assert vis.generate_videos_pose(opt, trainer) == [0, 1]
    assert sorted(os.listdir(os.path.join(opt.output_path, "poses"))) == ["0.png", "1.png"]
    html = open(os.path.join(opt.output_path, "poses.html")).read()
    assert html.startswith("<!DOCTYPE html>") and '"iters": [0, 1]' in html


def test_sfm_without_verified_matches_starts_as_the_jax_package(scene, tmp_path):
    """A matcher that finds nothing: the SfM returns identity poses with
    every image excluded, and the sim(3) fit then takes all of them, in
    both packages alike."""
    def no_matches(i, j, img_i, img_j):
        return np.zeros((0, 2)), np.zeros((0, 2))
    over = _overrides(scene["root"], "colmap")
    jopt = _options(config, over, tmp_path / "jax")
    jopt.pose.sfm = JDotDict(dict(matcher=no_matches))
    jsys = jax_system_class("barf_dtu")(jopt)
    jsys.attach_data(jdtu.Dataset(jopt, split="train").all_arrays(jopt),
                     jdtu.Dataset(jopt, split="val").all_arrays(jopt))
    init_j = np.asarray(jsys.set_initial_poses(jax.random.PRNGKey(0)))
    popt = _options(pconfig, over, tmp_path / "port")
    popt.pose.sfm = DotDict(dict(matcher=no_matches))
    trainer = Trainer(popt, "cpu")
    trainer.build_system(*trainer.load_dataset())
    system = trainer.system
    n = len(scene["names"])
    assert system.sfm_valid_idx == jsys.sfm_valid_idx == []
    assert system.sfm_excluded == jsys.sfm_excluded == list(range(n))
    got = system.aux["initial_poses_w2c"].numpy()
    np.testing.assert_allclose(got, init_j, rtol=0, atol=1e-6)
    assert np.isfinite(got).all()
