"""The planar experiments in the port (``homography`` / ``planar``,
``img_relu``; models/planar.py, ops/warp2d.py) against the JAX package on
the CPU, at tests/test_planar.py's sizes: a 48x64 image, 4 patches of
24x24, a [null,64,64,64,3] neural image with 6 PE bands and c2f [0,0.6];
the image fit at 32x32 with 3x64 layers, 6 PE bands and 512 pixels a step.

Both sides start from the JAX init over the weight layout (the neural
image's layers are [in,out] in JAX, [out,in] in torch); the image fit's
pixel draw is JAX's permutation, injected. Tolerances: the warp toolkit
rtol 1e-5 plus 1e-6 (``sl3_to_SL3``: torch's matrix_exp against
jax.scipy's expm, 1e-5 plus 1e-6); the patches and bilinear samples 1e-6;
the perturbations bit for bit; losses rtol 1e-5; parameters after Adam
steps 1e-6 plus 1e-5 relative, and to 2 lr where the gradient is
noise-level (as tests/test_torch_barf.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import synth_data
from neural_invertible_warp_tpu import config
from neural_invertible_warp_tpu.models import planar as jplanar
from neural_invertible_warp_tpu.ops import warp2d as jwarp
from neural_invertible_warp_tpu_torch.dotdict import DotDict
from neural_invertible_warp_tpu_torch.models import planar
from neural_invertible_warp_tpu_torch.ops import warp2d
from neural_invertible_warp_tpu_torch.planar_options import planar_options

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

RNG = np.random.RandomState(0)
THETA = (RNG.randn(8, 1) * 1.5).astype(np.float32)
DELTA = (RNG.randn(8, 3) * 0.5).astype(np.float32)
H8 = (RNG.randn(6, 8) * 0.2).astype(np.float32)
XY = (RNG.rand(2, 30, 2) * 2 - 1).astype(np.float32)
X_TAYLOR = np.linspace(-2.0, 2.0, 31).astype(np.float32)

# name -> (port call, JAX call) on numpy inputs
WARP2D_CASES = {
    "taylor_A": lambda m, t: m.taylor_A(t(X_TAYLOR)),
    "taylor_B": lambda m, t: m.taylor_B(t(X_TAYLOR)),
    "taylor_C": lambda m, t: m.taylor_C(t(X_TAYLOR)),
    "taylor_D": lambda m, t: m.taylor_D(t(X_TAYLOR)),
    "so2_to_SO2": lambda m, t: m.so2_to_SO2(t(THETA)),
    "SO2_to_so2": lambda m, t: m.SO2_to_so2(m.so2_to_SO2(t(THETA))),
    "se2_to_SE2": lambda m, t: m.se2_to_SE2(t(DELTA)),
    "SE2_to_se2": lambda m, t: m.SE2_to_se2(m.se2_to_SE2(t(DELTA))),
    "sl3_to_SL3": lambda m, t: m.sl3_to_SL3(t(H8)),
    "normalized_pixel_grid": lambda m, t: m.normalized_pixel_grid(6, 10, batch_size=2),
    "normalized_pixel_grid_crop": lambda m, t: m.normalized_pixel_grid_crop(36, 48, 18, 20,
                                                                            batch_size=2),
    "normalized_pixel_corners_crop": lambda m, t: m.normalized_pixel_corners_crop(
        36, 48, 18, 20, batch_size=3),
    "warp_grid_translation": lambda m, t: m.warp_grid(t(XY), t(DELTA[:2, :2]), "translation"),
    "warp_grid_rotation": lambda m, t: m.warp_grid(t(XY), t(THETA[:2]), "rotation"),
    "warp_grid_rigid": lambda m, t: m.warp_grid(t(XY), t(DELTA[:2]), "rigid"),
    "warp_grid_homography": lambda m, t: m.warp_grid(t(XY), t(H8[:2]), "homography"),
    "warp_corners": lambda m, t: m.warp_corners(t(H8), 36, 48, 18, 18),
    "check_corners_in_range": lambda m, t: np.array(
        [m.check_corners_in_range(t(H8[i:i + 1] * s), 36, 48, 18, 18)
         for i in range(6) for s in (0.0, 1.0, 5.0)]),
}


@pytest.fixture
def jit_sl3(monkeypatch):
    """The JAX package's sl3_to_SL3 under jit (the same function; its
    expm compiled as one program instead of primitive by primitive)."""
    monkeypatch.setattr(jwarp, "sl3_to_SL3", jax.jit(jwarp.sl3_to_SL3))


@pytest.fixture
def jit_warps(jit_sl3, monkeypatch):
    """Also warp_grid and bilinear_sample under jit."""
    monkeypatch.setattr(jwarp, "warp_grid",
                        jax.jit(jwarp.warp_grid, static_argnames=("warp_type",)))
    monkeypatch.setattr(jplanar, "bilinear_sample",
                        jax.jit(jplanar.bilinear_sample, static_argnums=(2, 3)))


@pytest.mark.parametrize("name", list(WARP2D_CASES))
def test_warp2d_against_jax(name, jit_sl3):
    got = WARP2D_CASES[name](warp2d, torch.tensor)
    if name == "check_corners_in_range" or name.startswith("normalized"):
        # Python bools; the grids eager, where they equal the port's bit for
        # bit (under jit XLA turns their divisions into products)
        ref = WARP2D_CASES[name](jwarp, jnp.asarray)
    else:
        ref = jax.jit(lambda: WARP2D_CASES[name](jwarp, jnp.asarray))()
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if name == "check_corners_in_range":
        assert ref.any() and not ref.all()
    if got.dtype == bool or name.startswith("normalized"):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_bilinear_sample_clips_as_jax():
    """Coordinates inside and well outside the image: the weights from the
    unclipped floor, the corners clipped separately."""
    image = synth_data._toy_image(12, 16, seed=1).astype(np.float32) / 255.0
    xy = (np.random.RandomState(1).rand(3, 200, 2) * 3.0 - 1.5).astype(np.float32)
    got = planar.bilinear_sample(torch.tensor(image), torch.tensor(xy), 12, 16)
    ref = jplanar.bilinear_sample(jnp.asarray(image), jnp.asarray(xy), 12, 16)
    m = max(12, 16)
    X = (xy[..., 0] / 16 * m + 1) / 2 * 16 - 0.5
    assert (X < 0).any() and (X > 15).any()
    assert got.shape == (3, 200, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_planar_option_dicts_equal_yaml_resolution():
    for model in ("homography", "img_relu"):
        opt = config.load_options("options/{}.yaml".format(model))
        over = config.parse_arguments(["--model={}".format(model), "--yaml={}".format(model)])
        opt = config.override_options(opt, over, key_stack=[], safe_check=True)
        assert planar_options(model).to_plain() == opt.to_plain(), model


# ------------------------------------------------------------- homography

def _planar_opt(n_iter=2000):
    """tests/test_planar.py's configuration."""
    opt = config.load_options("options/homography.yaml")
    over = config.parse_arguments([
        "--model=homography", "--yaml=homography", "--data.image_size=[48,64]",
        "--data.patch_crop=[24,24]", "--arch.layers=[null,64,64,64,3]",
        "--arch.posenc.L_2D=6", "--barf_c2f=[0,0.6]", "--warp.noise_h=0.05",
        "--warp.noise_t=0.1", "--batch_size=4", "--max_iter={}".format(n_iter),
        "--optim.lr=1.e-3", "--optim.lr_warp=3.e-3",
    ])
    return config.override_options(opt, over, key_stack=[], safe_check=True)


def _load_mlp(mlp, layers):
    with torch.no_grad():
        for lin, layer in zip(mlp.layers, layers):
            lin.weight.copy_(torch.tensor(np.asarray(layer["w"]).T))
            lin.bias.copy_(torch.tensor(np.asarray(layer["b"])))


def _params_close(mlp, layers_j, lr):
    """The port's layers after Adam steps against the JAX ones: 1e-6 plus
    1e-5 relative, 2 lr where the last step's gradient is noise-level."""
    for li, (lin, layer) in enumerate(zip(mlp.layers, layers_j)):
        for got, a, gv in ((lin.weight.detach().numpy().T, layer["w"], lin.weight.grad.T),
                           (lin.bias.detach().numpy(), layer["b"], lin.bias.grad)):
            a, gv = np.asarray(a), np.abs(gv.numpy())
            noisy = gv < 1e-4 * gv.max()
            err = np.abs(got - a)
            assert np.all(err[~noisy] <= 1e-6 + 1e-5 * np.abs(a[~noisy])), li
            assert np.all(err[noisy] <= 2 * lr + 1e-6), li


def test_homography_perturbations_patches_and_three_steps(jit_warps):
    """The perturbations bit for bit (numpy's RandomState, the same corner
    test), the crop grid and patches, then the first 3 steps' losses, warps
    and neural image against the JAX system's jitted steps."""
    image = synth_data._toy_image(48, 64, seed=3).astype(np.float32) / 255.0
    jsys = jplanar.PlanarSystem(_planar_opt(), image=image)
    psys = planar.PlanarSystem(DotDict(_planar_opt().to_plain()), "cpu", image=image)
    np.testing.assert_array_equal(psys.warp_pert.numpy(), np.asarray(jsys.warp_pert))
    assert np.abs(np.asarray(jsys.warp_pert)[1:]).min(axis=1).max() > 0
    np.testing.assert_array_equal(psys.xy_crop.numpy(), np.asarray(jsys.xy_crop))
    np.testing.assert_allclose(psys.patches.numpy(), np.asarray(jsys.patches), rtol=1e-6,
                               atol=1e-6)
    state = jsys.init_state(jax.random.PRNGKey(0))
    psys.init_state(0)
    _load_mlp(psys.graph.image_mlp, state["params"]["image_mlp"])
    assert psys.corner_error() == pytest.approx(jsys.corner_error(state), rel=1e-5)
    key = jax.random.PRNGKey(0)
    for it in range(3):
        state, m_j = jsys.train_step(state, jax.random.fold_in(key, it))
        m_t = psys.train_step()
        np.testing.assert_allclose(float(m_t["loss_all"]), float(m_j["loss_all"]), rtol=1e-5)
        np.testing.assert_allclose(float(m_t["psnr"]), float(m_j["psnr"]), rtol=1e-5)
        warp_j = np.asarray(state["params"]["warp_param"])
        warp_t = psys.graph.warp_param.detach().numpy()
        assert np.all(warp_t[0] == 0) and np.abs(warp_j[1:]).min() > 0
        np.testing.assert_allclose(warp_t, warp_j, rtol=1e-5, atol=1e-6)
    _params_close(psys.graph.image_mlp, state["params"]["image_mlp"], 1e-3)
    assert psys.step == 3
    assert psys.corner_error() == pytest.approx(jsys.corner_error(state), rel=1e-4)


def test_image_fit_step_with_the_jax_permutation():
    opt = config.load_options("options/img_relu.yaml")
    over = config.parse_arguments([
        "--model=img_relu", "--yaml=img_relu", "--data.image_size=[32,32]",
        "--relu.hidden_layers=3", "--relu.hidden_features=64", "--relu.posenc.enabled",
        "--relu.posenc.L_2D=6", "--optim.Adam.lr=3.e-3", "--train_samples=512",
        "--max_iter=300"])
    opt = config.override_options(opt, over, key_stack=[], safe_check=True)
    image = synth_data._toy_image(32, 32, seed=5).astype(np.float32) / 255.0
    jsys = jplanar.ImageFitSystem(opt, image=image)
    psys = planar.ImageFitSystem(DotDict(opt.to_plain()), "cpu", image=image)
    np.testing.assert_array_equal(psys.grid.numpy(), np.asarray(jsys.grid))
    state = jsys.init_state(jax.random.PRNGKey(0))
    psys.init_state(0)
    _load_mlp(psys.graph.mlp, state["params"]["mlp"])
    key = jax.random.PRNGKey(1)
    idx = np.asarray(jax.random.permutation(key, 32 * 32)[:512])
    state, m_j = jsys.train_step(state, key)
    m_t = psys.train_step(torch.tensor(idx))
    np.testing.assert_allclose(float(m_t["loss_all"]), float(m_j["loss_all"]), rtol=1e-5)
    _params_close(psys.graph.mlp, state["params"]["mlp"], 3e-3)
    # without an injected draw the step draws 512 distinct pixels itself
    m = psys.train_step()
    assert psys.step == 2 and np.isfinite(float(m["psnr"]))


def test_train_entry_point_runs_homography_on_cpu(tmp_path, monkeypatch):
    """``python -m neural_invertible_warp_tpu_torch.train --model=homography``
    on a PNG: run_training sends the planar names to run_planar_training,
    which trains from the file."""
    import imageio.v2 as imageio
    from neural_invertible_warp_tpu_torch import train
    from neural_invertible_warp_tpu_torch.models import engine
    fname = str(tmp_path / "toy.png")
    imageio.imwrite(fname, synth_data._toy_image(40, 56, seed=2))
    system = train.main([
        "--model=homography", "--yaml=homography", "--device=cpu",
        "--data.image_fname={}".format(fname), "--data.image_size=[24,32]",
        "--data.patch_crop=[12,12]", "--arch.layers=[null,16,16,3]", "--batch_size=3",
        "--max_iter=4", "--freq.scalar=2", "--output_root={}".format(tmp_path)])
    assert isinstance(system, planar.PlanarSystem) and system.step == 4
    assert system.image.shape == (24, 32, 3) and np.isfinite(system.corner_error())
    ref = jplanar.load_image(config.override_options(
        config.load_options("options/homography.yaml"), config.parse_arguments([
            "--data.image_fname={}".format(fname), "--data.image_size=[24,32]"])))
    np.testing.assert_array_equal(system.image.numpy(), ref)
    seen = []
    monkeypatch.setattr(planar, "run_planar_training",
                        lambda opt, device, image=None: seen.append((opt.model, device)))
    for model in ("planar", "img_relu"):
        engine.run_training(DotDict(model=model), "cpu")
    assert seen == [("planar", "cpu"), ("img_relu", "cpu")]
