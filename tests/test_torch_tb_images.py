"""The engine's tensorboard validation images without PIL or matplotlib:
``vis.colorize_depth`` against the JAX package's matplotlib colouring,
``image_io.encode_png`` read back by PIL, and the four image summaries a
validation writes (through tensorboardX or torch.utils.tensorboard, with
PIL and matplotlib blocked in the port's process) against what
tensorboardX's ``add_image`` writes for the same arrays."""

import io
import os
import subprocess
import sys
import warnings

import numpy as np
import PIL.Image
import pytest
import torch

from neural_invertible_warp_tpu.utils import vis as jax_vis
from neural_invertible_warp_tpu_torch.utils import image_io, vis

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the event-file reader of path cli_data)


def _depth_maps():
    """(name, depth, valid) cases: spreads of scale, NaN and inf, a constant
    map, one with no valid pixel, a single pixel, float64 input."""
    rng = np.random.RandomState(0)
    base = rng.rand(13, 17).astype(np.float32)
    nan = base.copy()
    nan[rng.rand(13, 17) < 0.2] = np.nan
    inf = base * 50
    inf[rng.rand(13, 17) < 0.1] = np.inf
    inf[0, 0] = -np.inf
    cases = [("unit", base, None), ("tiny", base * 1e-6, None), ("huge", base * 1e6, None),
             ("nan", nan, None), ("inf", inf, None), ("constant", np.full((9, 11), 3.0), None),
             ("all_nan", np.full((5, 7), np.nan, np.float32), None),
             ("empty_valid", base, np.zeros((13, 17), bool)),
             ("masked", base, rng.rand(13, 17) < 0.6), ("nan_in_valid", nan, np.ones((13, 17),
                                                                                   bool)),
             ("one_pixel", np.float32([[2.5]]), None), ("float64", rng.rand(8, 9), None)]
    return cases


@pytest.mark.parametrize("name,depth,valid", _depth_maps(), ids=[c[0] for c in _depth_maps()])
def test_colorize_depth_matches_matplotlib(name, depth, valid):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_vis.colorize_depth(depth, valid)
        got = vis.colorize_depth(depth, valid)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got, ref, equal_nan=True), (name, np.nanmax(np.abs(got - ref)))


def test_colorize_depth_refuses_other_colormaps():
    with pytest.raises(ValueError, match="viridis"):
        vis.colorize_depth(np.ones((2, 2)), cmap="magma")


@pytest.mark.parametrize("channels", [None, 1, 2, 3, 4])
def test_encode_png_reads_back_through_pil(channels):
    rng = np.random.RandomState(3)
    for h, w in ((1, 1), (5, 7), (33, 18)):
        shape = (h, w) if channels is None else (h, w, channels)
        arr = rng.randint(0, 256, shape).astype(np.uint8)
        arr[: h // 2] = arr[: h // 2, :1]           # runs that favour the Sub filter
        data = image_io.encode_png(arr)
        ref = np.asarray(PIL.Image.open(io.BytesIO(data)))
        assert np.array_equal(ref, arr[..., 0] if channels == 1 else arr)
        assert np.array_equal(image_io.decode_png(data), ref)


# the port's train.main in a process where PIL, matplotlib and, for the
# torch writer, tensorboardX raise on import, and TensorFlow is absent (the
# card's machine has none of them; tensorboard's writers take their stubs
# without it; a None entry in sys.modules is what importlib.util.find_spec,
# which torch probes optional modules with, reads as not installed); the
# float images the engine hands to its summaries are saved for the
# comparison
ENGINE_RUN = """
import sys
import numpy as np


class Blocked:
    names = {blocked!r}

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError("blocked: " + name)
        return None


sys.meta_path.insert(0, Blocked())
sys.modules["tensorflow"] = None
from neural_invertible_warp_tpu_torch.models import engine
from neural_invertible_warp_tpu_torch import train
seen = {{}}
summary = engine.image_summary


def spy(summary_cls, tag, image):
    seen[tag] = np.array(image)
    return summary(summary_cls, tag, image)


engine.image_summary = spy
trainer = train.main({flags!r})
np.savez({npz!r}, **{{tag.replace("/", "__"): img for tag, img in seen.items()}})
print("WRITER", trainer.tb_writer, trainer.opt.output_path)
print(sorted(m for m in sys.modules if m.split(".")[0] in Blocked.names
             or m.startswith("tensorflow.")))
"""


@pytest.mark.parametrize("writer", ["tensorboardX", "torch.utils.tensorboard"])
def test_engine_image_summaries_match_tensorboardx(writer, tmp_path):
    """One validation of the tiny flagship on the committed JPEG tree (three
    held-out views, so ``tb.num_images`` gives the grids too): the event
    file holds val/rgb, val/invdepth and their grids at the validation's
    step, each a PNG of the tag, height, width, colorspace and pixels that
    tensorboardX's ``add_image(..., dataformats="HWC")`` writes for the
    same float arrays; the writer is named once in the log."""
    from tensorboardX import SummaryWriter
    llff = os.path.join(ROOT, "tests", "data", "jpeg", "llff")
    flags = ["--model=barf_inn_llff", "--yaml=barf_inn_llff", "--data.root=" + llff,
             "--data.scene=blobfern", "--data.image_size=[12,16]", "--data.val_ratio=0.2",
             "--arch.layers_feat=[null,16,16,16]", "--arch.layers_rgb=[null,8,3]",
             "--arch.skip=[1]", "--inn.real_nvp.d_hidden=8", "--nerf.sample_intvs=8",
             "--nerf.rand_rays=64", "--max_iter=2", "--freq.scalar=1", "--freq.val=2",
             "--freq.ckpt=2", "--device=cpu", "--output_root=" + str(tmp_path / "run")]
    blocked = ("PIL", "matplotlib") + (
        ("tensorboardX",) if writer != "tensorboardX" else ())
    npz = str(tmp_path / "images.npz")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", ENGINE_RUN.format(blocked=blocked, flags=flags,
                                                                  npz=npz)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "[]", lines[-1]
    _, name, run_dir = next(l for l in lines if l.startswith("WRITER")).split(" ", 2)
    assert name == writer
    assert sum("tensorboard writer: " + writer in l for l in lines) == 1
    got = chip_smoke.event_images(run_dir, writer)
    images = {k.replace("__", "/"): v for k, v in np.load(npz).items()}
    assert sorted(images) == sorted(got) == sorted(chip_smoke.CLI_DATA_TB_TAGS)
    ref_dir = str(tmp_path / "ref")
    tb = SummaryWriter(logdir=ref_dir)
    for tag, image in images.items():
        tb.add_image(tag, image, 2, dataformats="HWC")
    tb.close()
    ref = chip_smoke.event_images(ref_dir, "tensorboardX")
    for tag in images:
        step, h, w, c, png = got[tag]
        assert (step, h, w, c) == ref[tag][:4] and (h, w, c) == images[tag].shape, tag
        pixels = np.asarray(PIL.Image.open(io.BytesIO(png)))
        assert np.array_equal(pixels, np.asarray(PIL.Image.open(io.BytesIO(ref[tag][4])))), tag
        assert np.array_equal(pixels, (images[tag] * 255.0).astype(np.uint8)), tag
