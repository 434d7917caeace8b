"""What the fine-sampling path adds below the kernels, port against JAX
package on the CPU: inverse-CDF depth sampling, the density-noise operand of
the field MLP, the Blender loader and the Blender pose noise of BARF.

Tolerances: ``sample_depth_from_pdf`` is the same fp32 arithmetic on both
sides up to the order of the cumulative sum. A bin that holds a share m of
the weight turns a cdf rounding difference of ~1e-7 into 1e-7 / m of its
width, and bins of the test hold down to ~1e-4, so depths are held to
2e-3 of a coarse bin's width (and rtol 1e-6); the MLP with noise is the plain fp32 chain on both sides
(rtol 1e-5, atol 1e-6); loader arrays and poses composed from the same
noise must be equal bit for bit, respectively to fp32 rounding (1e-6).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import synth_data
from neural_invertible_warp_tpu.dotdict import DotDict as JDotDict
from neural_invertible_warp_tpu.ops import nerf_mlp as jmlp
from neural_invertible_warp_tpu.ops import sampling as jsampling
from neural_invertible_warp_tpu_torch.dotdict import DotDict
from neural_invertible_warp_tpu_torch.ops import sampling
from neural_invertible_warp_tpu_torch.ops.nerf_mlp import NerfMLP, apply_nerf_samples
from neural_invertible_warp_tpu_torch.utils import weights


def _composite_like_pdf(rng, shape):
    """Weights T * alpha of random densities: non-negative, sum <= 1."""
    sd = rng.rand(*shape).astype(np.float32) * 0.3
    T = np.exp(-np.concatenate([np.zeros_like(sd[..., :1]), np.cumsum(sd, -1)[..., :-1]], -1))
    return (T * (1 - np.exp(-sd))).astype(np.float32)


PDF_CASES = ["compositing weights", "sums to 0.3", "sums to 2.5", "an all-zero ray",
             "one spike"]


@pytest.mark.parametrize("case", PDF_CASES, ids=[c.replace(" ", "_") for c in PDF_CASES])
@pytest.mark.parametrize("n_coarse,n_fine", [(16, 16), (64, 128)])
def test_sample_depth_from_pdf_matches_jax(case, n_coarse, n_fine):
    """searchsorted + gather against the JAX package's dense compare: the
    same depths, including a midpoint beyond an unnormalized cdf's end
    (index clipped to N, cdf[N] as the upper bracket) and a ray without any
    weight (every midpoint lands in the last bin)."""
    rng = np.random.RandomState(len(case) + n_coarse)
    pdf = _composite_like_pdf(rng, (2, 5, n_coarse))
    if case.startswith("sums to"):
        pdf = pdf / pdf.sum(-1, keepdims=True) * float(case.split()[-1])
    elif case == "an all-zero ray":
        pdf[0, 2] = 0.0
    elif case == "one spike":
        pdf[:] = 0.0
        pdf[..., n_coarse // 3] = 0.7
    ref = jsampling.sample_depth_from_pdf(jnp.asarray(pdf), n_coarse, n_fine, (2.0, 6.0))
    got = sampling.sample_depth_from_pdf(torch.tensor(pdf), n_coarse, n_fine, (2.0, 6.0))
    assert got.shape == (2, 5, n_fine, 1) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=2e-3 * (6.0 - 2.0) / n_coarse)
    assert float(got.min()) >= 2.0 - 1e-6 and float(got.max()) <= 6.0 + 1e-6


@pytest.mark.parametrize("activ", ["softplus", "relu"])
def test_mlp_density_noise_matches_jax(activ):
    """The noise is added to the density before its activation: the port
    takes the draw as a tensor, the JAX package draws it from a key."""
    arch = JDotDict(dict(layers_feat=[None, 32, 32, 32, 32], layers_rgb=[None, 16, 3],
                         skip=[2], posenc=dict(L_3D=4, L_view=2), tf_init=True))
    params = jmlp.init_nerf_params(jax.random.PRNGKey(0), arch)
    mlp = NerfMLP(DotDict(arch.to_plain()))
    mlp.load_state_dict(weights.nerf_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.RandomState(1)
    center = rng.randn(2, 3, 3).astype(np.float32) * 0.2
    ray = rng.randn(2, 3, 3).astype(np.float32)
    depth = np.sort(rng.rand(2, 3, 8, 1), axis=2).astype(np.float32) * 3 + 1
    key, reg = jax.random.PRNGKey(3), 0.7
    rgb_j, dens_j = jmlp.apply_nerf_samples(
        params, arch, jnp.asarray(center), jnp.asarray(ray), jnp.asarray(depth),
        density_activ=activ, density_noise_reg=reg, noise_key=key)
    noise = np.asarray(jax.random.normal(key, (2, 3, 8))) * reg
    with torch.no_grad():
        rgb_t, dens_t = apply_nerf_samples(mlp, torch.tensor(center), torch.tensor(ray),
                                           torch.tensor(depth), density_activ=activ,
                                           noise=torch.tensor(noise))
        _, dens_clean = apply_nerf_samples(mlp, torch.tensor(center), torch.tensor(ray),
                                           torch.tensor(depth), density_activ=activ)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dens_t.numpy(), np.asarray(dens_j), rtol=1e-5, atol=1e-6)
    assert not torch.equal(dens_t, dens_clean)


@pytest.mark.parametrize("bgcolor", [1, None])
def test_port_blender_loader_gives_the_jax_arrays(tmp_path, bgcolor):
    """The synthetic Blender scene through both Dataset classes: every array
    of all_arrays, for all three splits, is equal bit for bit."""
    from neural_invertible_warp_tpu.data import get_dataset as jax_get_dataset
    from neural_invertible_warp_tpu_torch.data import get_dataset
    root = str(tmp_path)
    synth_data.make_blender_scene(root, n_train=3, n_val=2, n_test=2, img_size=20)
    opt = synth_data.blender_opt(root, H=10, W=10, bgcolor=bgcolor)
    popt = DotDict(opt.to_plain())
    for split in ("train", "val", "test"):
        ref_ds = jax_get_dataset("blender").Dataset(opt, split=split)
        got_ds = get_dataset("blender").Dataset(popt, split=split)
        ref, got = ref_ds.all_arrays(opt), got_ds.all_arrays(popt)
        assert len(got_ds) == len(ref_ds) > 0
        assert sorted(got) == sorted(ref) and {"image", "intr", "pose"} <= set(got)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(np.asarray(got_ds.get_all_camera_poses(popt)),
                                      np.asarray(ref_ds.get_all_camera_poses(opt)))


def _barf_blender_systems(tmp_path, noise):
    from neural_invertible_warp_tpu import config
    from neural_invertible_warp_tpu.models import get_system_class as jax_system_class
    from neural_invertible_warp_tpu_torch.models import get_system_class

    def options(sub):
        opt = config.load_options("options/barf_blender.yaml")
        over = config.parse_arguments([
            "--model=barf", "--yaml=barf_blender", "--data.image_size=[8,8]",
            "--arch.layers_feat=[null,16,16,16]", "--arch.layers_rgb=[null,8,3]",
            "--arch.skip=[1]", "--nerf.sample_intvs=4", "--nerf.rand_rays=8",
            "--camera.noise={}".format(noise if noise else "")])
        opt = config.override_options(opt, over, key_stack=[], safe_check=True)
        opt.H, opt.W = 8, 8
        opt.output_path = str(tmp_path / sub)
        return opt
    rng = np.random.RandomState(0)
    from neural_invertible_warp_tpu.ops import lie
    R = np.asarray(lie.so3_to_SO3(jnp.asarray(rng.randn(3, 3) * 0.3, jnp.float32)))
    arrays = dict(image=rng.rand(3, 8, 8, 3).astype(np.float32),
                  intr=np.tile(np.array([[8.0, 0, 4], [0, 8.0, 4], [0, 0, 1]], np.float32),
                               (3, 1, 1)),
                  pose=np.concatenate([R, rng.randn(3, 3, 1)], -1).astype(np.float32),
                  idx=np.arange(3, dtype=np.int32))
    jsys = jax_system_class("barf")(options("jax"))
    jsys.attach_data(dict(arrays), dict(arrays))
    state = jsys.init_state(jax.random.PRNGKey(0))
    psys = get_system_class("barf")(DotDict(options("port").to_plain()), "cpu")
    psys.attach_data(dict(arrays), dict(arrays))
    psys.init_state(0)
    return jsys, state, psys


@pytest.mark.parametrize("noise", [0.15, None])
def test_blender_pose_noise_matches_jax(tmp_path, noise):
    """BARF on Blender starts from the GT poses composed with an se(3) noise
    of scale ``camera.noise``, kept in aux. The draw itself is each
    package's own; with the JAX draw handed to the port, the initial and
    the training poses agree to fp32 rounding (1e-6)."""
    jsys, state, psys = _barf_blender_systems(tmp_path, noise)
    assert ("pose_noise" in psys.aux) == ("pose_noise" in state["aux"]) == bool(noise)
    if noise:
        own = psys.aux["pose_noise"]
        assert own.shape == (3, 3, 4) and bool(torch.isfinite(own).all())
        # a seeded draw of the right scale: rotations within a few sigma
        angle = torch.acos(torch.clamp((own[:, 0, 0] + own[:, 1, 1] + own[:, 2, 2] - 1) / 2,
                                       -1, 1))
        assert 0 < float(angle.max()) < 6 * noise
        psys.aux["pose_noise"] = torch.tensor(np.asarray(state["aux"]["pose_noise"]))
    se3 = (np.random.RandomState(1).randn(3, 6) * 0.05).astype(np.float32)
    with torch.no_grad():
        psys.graph.se3_refine.weight.copy_(torch.tensor(se3))
    params = dict(state["params"], se3_refine=jnp.asarray(se3))
    ref_init = jsys._initial_pose(state["aux"], jsys.train_data["pose"])
    ref = jsys.get_train_pose(params, state["aux"], jsys.train_data)
    np.testing.assert_allclose(psys._initial_pose().numpy(), np.asarray(ref_init), atol=1e-6)
    np.testing.assert_allclose(psys.get_train_pose().detach().numpy(), np.asarray(ref),
                               atol=1e-6)
