"""The port's iPhone and Tanks-and-Temples loaders against the JAX
package's, on tests/test_data_extra.py's fixture layouts (10 numbered
frames at 36x64 for iPhone; 16 frames of a forward-facing arc with
``poses_bounds.npy`` at 27x48 for Tanks and Temples): every array of
``all_arrays``, the camera poses and the image names, split by split,
exactly."""

import numpy as np
import pytest
import torch

from neural_invertible_warp_tpu.data import get_dataset as jax_get_dataset
from neural_invertible_warp_tpu.dotdict import DotDict as JaxDotDict
from neural_invertible_warp_tpu_torch.data import get_dataset
from neural_invertible_warp_tpu_torch.dotdict import DotDict

from test_data_extra import _tandt_opt, iphone_root, tandt_root  # noqa: F401 (fixtures)

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)


def _iphone_opt(root):
    return JaxDotDict(dict(
        H=18, W=32,
        data=dict(root=root, dataset="iphone", scene="vid", image_size=[18, 32],
                  num_workers=2, preload=True, val_ratio=0.2, augment={},
                  center_crop=None)))


def _same(name, opt, split):
    ref_ds = jax_get_dataset(name).Dataset(opt, split=split)
    popt = DotDict(opt.to_plain())
    got_ds = get_dataset(name).Dataset(popt, split=split)
    assert type(got_ds).__module__ == "neural_invertible_warp_tpu_torch.data." + name
    assert len(got_ds) == len(ref_ds) > 0
    ref, got = ref_ds.all_arrays(opt), got_ds.all_arrays(popt)
    assert sorted(got) == sorted(ref) and {"image", "intr", "pose"} <= set(got)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(got_ds.get_all_camera_poses(popt)),
                                  np.asarray(ref_ds.get_all_camera_poses(opt)))
    assert got_ds.image_names() == ref_ds.image_names()
    return got


@pytest.mark.parametrize("split", ["train", "val"])
def test_iphone_loader_gives_the_jax_arrays(iphone_root, split):  # noqa: F811
    got = _same("iphone", _iphone_opt(iphone_root), split)
    np.testing.assert_array_equal(got["pose"], np.tile(np.eye(3, 4), (len(got["pose"]), 1, 1)))


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_tandt_loader_gives_the_jax_arrays(tandt_root, split):  # noqa: F811
    got = _same("tandt", _tandt_opt(tandt_root), split)
    assert len(got["image"]) == {"train": 14, "val": 2, "test": 2}[split]


def test_spherify_poses_matches_jax():
    from neural_invertible_warp_tpu.data import tandt as jtandt
    from neural_invertible_warp_tpu_torch.data import tandt
    rng = np.random.RandomState(0)
    poses = np.concatenate([np.tile(np.eye(3), (7, 1, 1)) + rng.randn(7, 3, 3) * 0.1,
                            rng.randn(7, 3, 1)], -1).astype(np.float32)
    bds = rng.rand(7, 2).astype(np.float32) + 1
    for a, b in zip(tandt.spherify_poses(poses, bds), jtandt.spherify_poses(poses, bds)):
        np.testing.assert_array_equal(a, b)
