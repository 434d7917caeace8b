"""Vanilla NeRF with fine sampling (``--model=nerf --yaml=nerf_llff_repr``):
the port's NerfSystem against the JAX package's on the CPU, tier by tier, at
full width and a tiny size (2 images of 8x8, 8 rays, 16 + 16 samples, relu
density, density noise 1).

The JAX system is forced onto the tier under test, with its Pallas kernels
in interpret mode (on the CPU it would otherwise take the jnp path, and the
comparison would say nothing about the kernels' contracts): "default" (both
fields through the one-call train kernel, the coarse one returning the
weights to resample from), "fallback" (``tpu.fused_raymarch_full: false``:
coarse field through the per-sample PE kernel, fine field through the train
kernel), "mlp" (``tpu.fused_pe: false``: the MLP-only kernel, no noise),
"mlp_noise" (the same tier with the config's noise, where the JAX package
takes its plain chain and the port its MLP-only kernel with the noise) and
"off" (the plain chain). The port reads the same switches and runs, on CPU
tensors, the same tier's plain versions. Both start from the JAX init over
the weight bridge; every draw of the step (ray indices, depth jitter, both
noise tensors) is taken from the JAX step's keys and handed to the port.

Tolerances, as tests/test_fused_pe.py holds the kernels to the jnp path:
losses rtol 2e-4; with noise active every gradient leaf to a relative L2
error below 1e-2 (relu masks near 0 flip), without noise rtol 5e-3 / atol
5e-6. Adam's first update is lr * g / (|g| + eps), about lr * sign(g):
parameters after the step are held to 1e-6 where the gradient is above
1e-3 of the leaf's largest entry and to 2 lr elsewhere. Eval renders: rtol
1e-4 / atol 1e-5 (the resampled depths inherit the last bits of the
coarse weights).
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from neural_invertible_warp_tpu import config
from neural_invertible_warp_tpu.models import get_system_class as jax_system_class
from neural_invertible_warp_tpu.models import system as jsystem_mod
from neural_invertible_warp_tpu.ops import sampling as jsampling
from neural_invertible_warp_tpu.ops.pallas import fused_field as jff
from neural_invertible_warp_tpu.ops.pallas import fused_pe as jfp
from neural_invertible_warp_tpu.utils import ckpt as jckpt
from neural_invertible_warp_tpu_torch.dotdict import DotDict
from neural_invertible_warp_tpu_torch.models import get_system_class
from neural_invertible_warp_tpu_torch.models.system import NerfSystem
from neural_invertible_warp_tpu_torch.nerf_llff_repr import nerf_llff_repr_options
from neural_invertible_warp_tpu_torch.utils import ckpt, weights

H = W = 8
N_IMG, N_RAYS, K, K_FINE = 2, 4, 16, 16
OVERRIDES = ["--model=nerf", "--yaml=nerf_llff_repr", "--data.image_size=[8,8]",
             "--nerf.sample_intvs=16", "--nerf.sample_intvs_fine=16", "--nerf.rand_rays=8",
             "--max_iter=100"]
# tier -> (what the JAX system's _use_fused_field is forced to, option overrides)
TIERS = {
    "default": ("pe", []),
    "fallback": ("pe", ["--tpu.fused_raymarch_full!"]),
    "mlp": ("field", ["--tpu.fused_pe!", "--nerf.density_noise_reg="]),
    # with noise the JAX package leaves its MLP-only kernel (which has no
    # noise operand) for the plain chain; the port's takes the noise
    "mlp_noise": ("field", ["--tpu.fused_pe!"]),
    "off": ("off", ["--tpu.fused_pe!", "--tpu.fused_kernel!"]),
}
JAX_KERNEL_FNS = [(jfp, "fused_render_rays_pe_train"), (jfp, "fused_render_rays_pe"),
                  (jfp, "fused_apply_nerf_samples_pe"),
                  (jfp, "fused_apply_nerf_samples_pe_soa"),
                  (jff, "fused_apply_nerf_samples")]


def _options(tier, out):
    opt = config.load_options("options/nerf_llff_repr.yaml")
    opt = config.override_options(opt, config.parse_arguments(OVERRIDES + TIERS[tier][1]),
                                  key_stack=[], safe_check=True)
    opt.H, opt.W = H, W
    opt.output_path = str(out)
    return opt


def _arrays():
    rng = np.random.RandomState(0)
    return dict(image=rng.rand(N_IMG, H, W, 3).astype(np.float32),
                intr=np.tile(np.array([[8.0, 0, 4], [0, 8.0, 4], [0, 0, 1]], np.float32),
                             (N_IMG, 1, 1)),
                pose=np.tile(np.eye(3, 4, dtype=np.float32), (N_IMG, 1, 1)),
                idx=np.arange(N_IMG, dtype=np.int32))


def _draws(key):
    """The JAX step's own draws from its key chain: ray_u, depth_rand and
    the standard-normal noise of the coarse and of the fine field."""
    k_perm, k_render = jax.random.split(key)
    k_depth, k_noise = jax.random.split(k_render)
    noise = [jax.random.normal(jax.random.fold_in(k_noise, i), (N_IMG, N_RAYS, k))
             for i, k in enumerate((K, K + K_FINE))]
    return (np.asarray(jax.random.uniform(k_perm, (N_RAYS,))),
            np.asarray(jax.random.uniform(k_depth, (N_IMG, N_RAYS, K, 1))),
            [np.asarray(n) for n in noise])


def _force_jax_tier(monkeypatch, mode):
    for mod, name in JAX_KERNEL_FNS:
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
    monkeypatch.setattr(jsystem_mod.NerfSystem, "_use_fused_field", lambda self: mode)


def _systems(tier, tmp_path):
    jsys = jax_system_class("nerf")(_options(tier, tmp_path / "jax"))
    jsys.attach_data(_arrays(), _arrays())
    state = jsys.init_state(jax.random.PRNGKey(0))
    popt = DotDict(_options(tier, tmp_path / "port").to_plain())
    assert get_system_class("nerf") is NerfSystem
    psys = NerfSystem(popt, "cpu")
    psys.attach_data(_arrays(), _arrays())
    psys.init_state(0)
    psys.graph.load_state_dict(weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, state["params"])))
    return jsys, state, psys


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _rel_l2(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return np.linalg.norm(a - b) / max(float(np.linalg.norm(b)), 1e-12)


@pytest.mark.parametrize("tier", list(TIERS))
def test_step0_losses_gradients_and_adam_step(tier, tmp_path, monkeypatch):
    mode, _ = TIERS[tier]
    _force_jax_tier(monkeypatch, mode)
    jsys, state, psys = _systems(tier, tmp_path)
    assert jsys._use_fused_field() == mode == psys._field_mode()
    noisy = bool(jsys.opt.nerf.density_noise_reg)
    assert noisy == (tier != "mlp")
    key = jax.random.PRNGKey(1)
    ray_u, depth_rand, noise_rand = _draws(key)
    k_perm, k_render = jax.random.split(key)
    ray_idx = jsampling.sample_ray_subset(k_perm, H * W, N_RAYS, mode="stratified")

    def loss_fn(params):
        out, target, extras = jsys._forward_train(params, state["aux"], jsys.train_data,
                                                  ray_idx, k_render, state["step"])
        losses = jsys.compute_loss(params, state["aux"], jsys.train_data, out, target,
                                   state["step"], extras)
        return jsys.summarize_loss(losses), (losses, out)
    (total_j, (losses_j, out_j)), g_j = jax.value_and_grad(loss_fn, has_aux=True)(
        state["params"])
    # which kernels the JAX tier went through
    assert ("render_sq_sum" in out_j) == (tier == "default")
    assert ("render_fine_sq_sum" in out_j) == (tier in ("default", "fallback"))
    updates, _ = jsys.tx.update(g_j, state["opt_state"], state["params"])
    params_j = optax.apply_updates(state["params"], updates)

    metrics = psys.train_step(torch.tensor(ray_u), torch.tensor(depth_rand),
                              [torch.tensor(n) for n in noise_rand])
    assert psys.step == 1
    for k in ("render", "render_fine"):
        np.testing.assert_allclose(float(metrics["loss_" + k]), float(losses_j[k]), rtol=2e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(metrics["loss_all"]), float(total_j), rtol=2e-4)
    g_t = weights.to_jax_params(psys.graph, get=lambda p: p.grad)
    p_t = weights.to_jax_params(psys.graph)
    assert sorted(g_t) == ["nerf", "nerf_fine"]
    leaves = list(zip(_leaves(g_j), jax.tree_util.tree_leaves(g_t),
                      jax.tree_util.tree_leaves(params_j), jax.tree_util.tree_leaves(p_t)))
    assert len(leaves) == 40
    lr = jsys.opt.optim.lr
    for (path, gj), gt, pj, pt in leaves:
        name, gj, pj = jax.tree_util.keystr(path), np.asarray(gj), np.asarray(pj)
        assert np.abs(gj).max() > 0, name
        if noisy:
            assert _rel_l2(gt, gj) < 1e-2, name
        else:
            np.testing.assert_allclose(gt, gj, rtol=5e-3, atol=5e-6, err_msg=name)
        small = np.abs(gj) < 1e-3 * np.abs(gj).max()
        err = np.abs(pt - pj)
        assert np.all(err[~small] <= 1e-6 + 1e-5 * np.abs(pj[~small])), name
        assert np.all(err[small] <= 2 * lr + 1e-6), name


def test_eval_render_and_validation_read_the_fine_field(tmp_path, monkeypatch):
    """Eval-mode render_rays in the default tier (per chunk: the per-sample
    PE kernel for the coarse field, compositing and resampling outside, the
    same kernel for the fine field) against the JAX system's; then
    ``validate`` and ``evaluate_full`` of the port report the fine field's
    image."""
    _force_jax_tier(monkeypatch, "pe")
    jsys, state, psys = _systems("default", tmp_path)
    center = np.zeros((1, 8, 3), np.float32)
    ray = np.concatenate([np.linspace(-0.2, 0.2, 8, dtype=np.float32)[None, :, None],
                          np.full((1, 8, 1), 0.1, np.float32),
                          np.ones((1, 8, 1), np.float32)], axis=-1)
    ref = jsys.render_rays(state["params"], jnp.asarray(center), jnp.asarray(ray),
                           jax.random.PRNGKey(2), mode="eval", progress=0.6)
    with torch.no_grad():
        got = psys.render_rays(torch.tensor(center), torch.tensor(ray), mode="eval",
                               progress=0.6)
    assert sorted(got) == sorted(ref) == ["depth", "depth_fine", "opacity", "opacity_fine",
                                          "rgb", "rgb_fine"]
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert not np.allclose(got["rgb"].numpy(), got["rgb_fine"].numpy(), atol=1e-3)

    res = psys.validate()
    image = torch.as_tensor(res["vis"]["rgb_fine"])
    assert image.shape == (1, H * W, 3) and sorted(res["vis"]) == sorted(got)
    mse = [float(torch.mean((torch.as_tensor(v["rgb_fine"]) - psys.test_data["pixels"][i:i + 1])
                            ** 2)) for i, v in enumerate(res["vis_all"])]
    np.testing.assert_allclose(res["psnr_val"], np.mean(-10 * np.log10(mse)), rtol=1e-6)
    results = psys.evaluate_full(output_path=str(tmp_path), dump_images=True)
    np.testing.assert_allclose(results["PSNR"], res["psnr_val"], rtol=1e-5)
    assert "rot_error_deg" not in results          # GT poses: nothing to align
    assert sorted(os.listdir(tmp_path / "test_view")) == sorted(
        "{}_{}.png".format(n, i) for n in ("rgb", "rgb_GT", "depth") for i in range(N_IMG))


def test_mlp_only_tier_with_noise_goes_through_the_k1_wrapper(tmp_path, monkeypatch):
    """The port's MLP-only kernel takes the density noise, unlike the JAX
    package's: with ``tpu.fused_pe`` off every field call of a train step
    (noise on, as nerf_llff_repr has it, or off) and of an eval render goes
    through K1's wrapper, the training calls with that field's own draw."""
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_field as ff
    opt = nerf_llff_repr_options()
    opt.data.image_size = [H, W]
    opt.nerf.update(sample_intvs=4, sample_intvs_fine=4, rand_rays=8)
    opt.tpu.fused_pe = False
    opt.H, opt.W, opt.output_path = H, W, str(tmp_path)
    psys = NerfSystem(opt, "cpu")
    psys.attach_data(_arrays(), _arrays())
    psys.init_state(0)
    calls = []
    orig = ff.fused_apply_nerf_samples
    monkeypatch.setattr(ff, "fused_apply_nerf_samples",
                        lambda *a, noise=None, **kw: calls.append(noise)
                        or orig(*a, noise=noise, **kw))
    draws = [torch.randn(N_IMG, 4, k, generator=torch.Generator().manual_seed(k))
             for k in (4, 8)]
    psys.train_step(noise_rand=draws)
    assert len(calls) == 2
    reg = opt.nerf.density_noise_reg
    assert all(torch.equal(n, d * reg) for n, d in zip(calls, draws))
    with torch.no_grad():
        psys.render_rays(torch.zeros(1, 2, 3), torch.ones(1, 2, 3), mode="eval")
    opt.nerf.density_noise_reg = None
    psys.train_step()
    assert len(calls) == 6 and calls[2:] == [None] * 4


def test_nerf_llff_repr_dict_equals_yaml_resolution():
    opt = config.load_options("options/nerf_llff_repr.yaml")
    over = config.parse_arguments(["--model=nerf", "--yaml=nerf_llff_repr"])
    opt = config.override_options(opt, over, key_stack=[], safe_check=True)
    assert opt.to_plain() == nerf_llff_repr_options()
    assert nerf_llff_repr_options() is not nerf_llff_repr_options()
    assert nerf_llff_repr_options().nerf.fine_sampling is True


def test_nerf_fine_checkpoint_interop(tmp_path):
    """A port checkpoint after one step restores into the JAX state (both
    fields, the raveled Adam moments of the main group), and a checkpoint
    written by the JAX package restores into the port."""
    jsys, state, psys = _systems("off", tmp_path)
    psys.train_step()
    ckpt.save(str(tmp_path / "port_run"), psys, psys.step)
    restored, it = jckpt.restore_checkpoint(str(tmp_path / "port_run"), state)
    assert it == 1 and int(restored["step"]) == 1
    p_t = weights.to_jax_params(psys.graph)
    assert sorted(restored["params"]) == ["nerf", "nerf_fine"]
    for (path, a), b in zip(_leaves(restored["params"]), jax.tree_util.tree_leaves(p_t)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))
    (cnt, mu, nu), _ = restored["opt_state"]["main"]
    n_params = sum(p.numel() for p in psys.graph.parameters())
    assert int(cnt) == 1 and np.asarray(mu).shape == (n_params,)
    n_coarse = sum(p.numel() for p in psys.graph.nerf.parameters())
    bias0 = psys.optim.moments(psys.graph.nerf_fine.mlp_feat[0].bias)[0].numpy()
    np.testing.assert_array_equal(          # JAX leaf order: nerf, then nerf_fine.feat[0].b
        np.asarray(mu)[n_coarse:n_coarse + bias0.size], bias0)
    assert float(np.abs(np.asarray(mu)).max()) > 0

    jstate, _ = jax.jit(jsys.make_train_step())(state, jsys.train_data, jax.random.PRNGKey(2))
    jckpt.save_checkpoint(str(tmp_path / "jax_run"), jstate, int(jstate["step"]))
    other = NerfSystem(psys.opt, "cpu")
    other.attach_data(_arrays(), _arrays())
    other.init_state(5)
    assert ckpt.restore(str(tmp_path / "jax_run"), other) == 1 and other.optim.count == 1
    for (path, a), b in zip(_leaves(jstate["params"]),
                            jax.tree_util.tree_leaves(weights.to_jax_params(other.graph))):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=jax.tree_util.keystr(path))
    (_, mu_j, nu_j), _ = jstate["opt_state"]["main"]
    (_, mu_o, nu_o), _ = ckpt.state_tree(other)["opt_state"]["main"]
    np.testing.assert_array_equal(mu_o, np.asarray(mu_j))
    np.testing.assert_array_equal(nu_o, np.asarray(nu_j))


def test_chip_smoke_field_references_match_the_wrappers_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's references for the fine-sampling phases on the CPU,
    where the wrappers run the plain version: the K5 and K1 routes of
    ``field_grads`` give the plain route's values bit for bit and its
    gradients to 1e-6 of the max (the wrappers flatten rays and samples
    before the layers, so gradients are summed in another order), and the
    chunked plain image equals render_image's: so on the card a difference
    can only come from the kernels."""
    import chip_smoke as cs
    from neural_invertible_warp_tpu_torch.ops.nerf_mlp import NerfMLP
    mlp = NerfMLP(nerf_llff_repr_options().arch, generator=torch.Generator().manual_seed(0))
    (center, ray, depth, _, noise), coeffs = cs.fine_batch(3, 8, seed=0, device="cpu")
    for which, nz in (("k5", noise), ("k1", noise), ("k1", None)):
        got = cs.field_grads(which, mlp, center, ray, depth, nz, coeffs, "relu")
        ref = cs.field_grads("plain", mlp, center, ray, depth, nz, coeffs, "relu")
        assert all(torch.equal(a, b) for a, b in zip(got[:3], ref[:3]))
        assert len(got[3]) == 22
        for a, b in zip(got[3], ref[3]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))
    failures = []
    cs.compare_leaves("same", ["a", "b"], got[3][:2], ref[3][:2], 1e-5, False, failures)
    cs.compare_leaves("off", ["a"], [got[3][0] * 1.1], [ref[3][0]], 1e-2, True, failures)
    assert failures == ["off a"]

    opt = nerf_llff_repr_options()
    opt.data.image_size = [4, 5]
    opt.nerf.update(sample_intvs=4, sample_intvs_fine=6, rand_rays=6)
    opt.H, opt.W, opt.output_path = 4, 5, str(tmp_path)
    system = NerfSystem(opt, "cpu")
    system.attach_data(cs.make_scene(4, 5, 2, seed=0), cs.make_scene(4, 5, 1, seed=1))
    system.init_state(0)
    pose, intr = system.test_data["pose"][:1], system.test_data["intr"][:1]
    with torch.no_grad():
        image = system.render_image(pose, intr)
        rgb, rgb_fine = cs.plain_image_fine(system, pose, intr)
    assert torch.equal(rgb, image["rgb"]) and torch.equal(rgb_fine, image["rgb_fine"])
    cs.reset_counts()
    assert set(cs.field_counts().values()) == {0}


def test_nerf_entry_points_on_cpu(tmp_path):
    """``train`` and ``evaluate`` with ``--model=nerf --yaml=nerf_llff_repr``
    in-process on the synthetic LLFF fixture, at a narrow width."""
    import synth_data
    from neural_invertible_warp_tpu_torch import evaluate, train
    root = str(tmp_path / "data")
    synth_data.make_llff_scene(root, n_images=8, img_size=(24, 32))
    flags = ["--model=nerf", "--yaml=nerf_llff_repr", "--data.scene=toyfern",
             "--data.image_size=[12,16]", "--data.num_workers=2", "--data.val_ratio=0.25",
             "--arch.layers_feat=[null,16,16,16]", "--arch.layers_rgb=[null,8,3]",
             "--arch.skip=[1]", "--nerf.sample_intvs=6", "--nerf.sample_intvs_fine=6",
             "--nerf.rand_rays=96", "--max_iter=3", "--freq.scalar=1", "--freq.val=2",
             "--freq.ckpt=2", "--novel_view_video!", "--group=cli", "--name=nerf0",
             "--data.root={}".format(root), "--output_root={}".format(tmp_path / "out"),
             "--device=cpu"]
    trainer = train.main(flags)
    assert trainer.system.step == 3
    assert float(trainer.history[-1]["loss_render_fine"]) > 0
    results = evaluate.main(flags)
    out_dir = os.path.join(str(tmp_path), "out", "cli", "nerf0")
    assert sorted(results) == ["LPIPS", "PSNR", "SSIM"] and 0 < results["PSNR"] < 100
    assert len(open(os.path.join(out_dir, "quant.txt")).read().split("\n")) == 2 + 1
    assert not os.path.exists(os.path.join(out_dir, "quant_pose.txt"))
