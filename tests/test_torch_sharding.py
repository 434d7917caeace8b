"""The ray-sharded train step and render of the port (parallel/mesh.py,
parallel/audit.py) on the CPU, in 2 and 3 worker processes with the gloo
backend (3 gives uneven shards), against the port's one-process step and
the JAX package's step under a 2-device mesh.

Models at the JAX sharding tests' size (tests/test_sharding.py: 16x16
images, a 4x32 trunk, 16 samples, 256 rays over 4 images): barf_inn_llff,
barf (Blender, pose noise), barf_inn_dtu (noisy_gt start) and nerf with
fine sampling (16 + 16 samples, relu density, density noise 1). Every
system starts from the port's init, handed to the JAX system over the
weight bridge with the port's aux (the initial poses and pose noise), and,
for the INN models, the warp's zero output layers filled with small random
values, so that the alignment term is not zero; the two steps' draws (ray indices, depth
jitter, density noise) come from the JAX steps' own keys. One spawn per
world size serves every test of the module (module-scoped fixture); the
two spawns run side by side.

Tolerances. Sharded against one process (the same code; only the order of
the fp32 sums over the rays differs): every gradient leaf within 1e-5 of
its largest entry or, for a leaf that cancels past that, no farther from
the one-process step in float64 than 1.5 times the farthest any leaf of
the one-process fp32 step lies from it (the rule chip_smoke.py holds
cancelling leaves to, its ``hold_leaves``), and the losses to 1e-6 relative at step 0; at step 1 the
losses to 1e-4 relative (the gate of the JAX audit, EVIDENCE_r5.md §2:
Adam's first update is about lr * sign(g), so an entry whose gradient is
noise-level moves either way); the render to 1e-6 of its largest entry. Against the JAX package's sharded step: its own test's
rtol 5e-4 / atol 1e-5 on the metrics (tests/test_sharding.py) and the leaf
rule of tests/test_torch_train_step.py (rtol 1e-4 plus 1e-5 of the leaf's
largest entry) on the gradients, where a leaf that misses it passes only
if the jitted JAX leaf lies farther than 1e-5 of its largest entry from the
port's float64 step and the port's leaf nearer to it (XLA's fused sin/cos
under jit move the JAX gradients at DTU's points by up to 5e-3 of a leaf's
largest entry, as tests/test_torch_dtu.py finds, the port's by 6e-5); where the density noise is on with relu
density, the fine-sampling test's rule instead (relative L2 below 1e-2 per
leaf, tests/test_torch_nerf_system.py: a relu mask near 0 flips between two
fp32 orders). The render against JAX's sharded render: rtol 2e-4 / atol
1e-5 (tests/test_sharding.py). After two steps the parameters of every rank
are bit-identical.
"""

import concurrent.futures

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neural_invertible_warp_tpu import config
from neural_invertible_warp_tpu.models import get_system_class as jax_system_class
from neural_invertible_warp_tpu.ops import sampling as jsampling
from neural_invertible_warp_tpu.parallel import mesh as mesh_lib
from neural_invertible_warp_tpu_torch.dotdict import DotDict
from neural_invertible_warp_tpu_torch.models import get_system_class
from neural_invertible_warp_tpu_torch.parallel import audit, mesh
from neural_invertible_warp_tpu_torch.utils import weights

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

H = W = 16
N_IMG = 4
COMMON = ["--data.image_size=[16,16]", "--arch.layers_feat=[null,32,32,32,32]",
          "--arch.layers_rgb=[null,16,3]", "--arch.skip=[2]", "--arch.posenc.L_3D=4",
          "--arch.posenc.L_view=2", "--nerf.sample_intvs=16", "--nerf.rand_rays=256",
          "--max_iter=100"]
INN = ["--inn.real_nvp.d_hidden=32", "--loss_weight.global_alignment=3"]
MODELS = {
    "barf_inn_llff": ("barf_inn_llff", INN + ["--warp_latent.embed_dim=16"]),
    "barf": ("barf_blender", []),
    "barf_inn_dtu": ("barf_inn_dtu", INN + ["--pose.init=noisy_gt"]),
    "nerf": ("nerf_llff_repr", ["--nerf.sample_intvs_fine=16"]),
}
# a step with fewer rays per image than ranks: a rank renders none
FEW_RAYS = {"barf_inn_llff_few": "barf_inn_llff", "nerf_few": "nerf"}
KEYS = [jax.random.PRNGKey(42), jax.random.PRNGKey(43)]
# step 0, step 1 (after an Adam step from gradients that agree to ~1e-6)
RTOL_LOSSES = (1e-6, 1e-4)


def _options(model):
    yaml, flags = MODELS[model]
    opt = config.load_options("options/{}.yaml".format(yaml))
    over = config.parse_arguments(["--model=" + model, "--yaml=" + yaml] + COMMON + flags)
    opt = config.override_options(opt, over, key_stack=[], safe_check=True)
    opt.H, opt.W = H, W
    opt.output_path = "unused"
    return opt


def _arrays(n, seed, dtu):
    rng = np.random.RandomState(seed)
    out = dict(image=rng.rand(n, H, W, 3).astype(np.float32),
               intr=np.tile(np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]],
                                     np.float32), (n, 1, 1)),
               pose=np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1)),
               idx=np.arange(n, dtype=np.int32))
    if dtu:
        rng = np.random.RandomState(seed + 100)
        out.update(depth_range=np.tile(np.array([1.2, 5.2], np.float32), (n, 1)),
                   depth_gt=(rng.rand(n, H, W) * 4 + 1.2).astype(np.float32),
                   valid_depth_gt=np.ones((n, H, W), np.float32),
                   fg_mask=np.ones((n, H, W), np.float32))
    return out


def _draws(opt, key, n_rays):
    """One JAX step's draws from its key chain: ray_u, depth_rand and, with
    the density noise on, its standard-normal draw for each field."""
    k_perm, k_render = jax.random.split(key)
    k_depth, k_noise = jax.random.split(k_render)
    K = opt.nerf.sample_intvs
    draws = dict(ray_u=np.asarray(jax.random.uniform(k_perm, (n_rays,))),
                 depth_rand=np.asarray(jax.random.uniform(k_depth, (N_IMG, n_rays, K, 1))))
    if opt.nerf.get("density_noise_reg"):
        ks = [K, K + opt.nerf.sample_intvs_fine] if opt.nerf.fine_sampling else [K]
        draws["noise_rand"] = [np.asarray(jax.random.normal(jax.random.fold_in(k_noise, i),
                                                            (N_IMG, n_rays, k)))
                               for i, k in enumerate(ks)]
    return draws


def _systems(opt, dtu):
    """The JAX system and a state for it made from the port's init (no JAX
    init to compile): the port's weights over the bridge, the warp's zero
    output layers filled with small random values, and the port's aux."""
    psys = get_system_class(opt.model)(DotDict(opt.to_plain()), "cpu")
    psys.attach_data(_arrays(N_IMG, 0, dtu), _arrays(2, 1, dtu))
    psys.init_state(0)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for p in getattr(psys.graph, "warp_mlp", torch.nn.Module()).parameters():
            if not torch.any(p):
                p.copy_(torch.tensor(rng.randn(*p.shape) * 0.02))
    jsys = jax_system_class(opt.model)(opt)
    jsys.attach_data(_arrays(N_IMG, 0, dtu), _arrays(2, 1, dtu))
    state = dict(params=jax.tree_util.tree_map(jnp.asarray, weights.to_jax_params(psys.graph)),
                 aux={k: jnp.asarray(v.numpy()) for k, v in psys.aux.items()},
                 step=jnp.int32(0))
    return jsys, state


def _job(opt, dtu, state, steps, draws, render=()):
    return dict(options=opt.to_plain(), train=_arrays(N_IMG, 0, dtu), test=_arrays(2, 1, dtu),
                state_dict={k: v.numpy() for k, v in weights.from_jax_params(
                    jax.tree_util.tree_map(np.asarray, state["params"])).items()},
                aux={k: np.asarray(v) for k, v in state["aux"].items()},
                steps=steps, draws=draws, grads_at=[0], render=list(render))


def _jax_sharded_step0(jsys, state, key):
    """(metrics, gradient tree) of the JAX step on ``key`` under a 2-device
    mesh, jitted (eager JAX dispatch is too slow here)."""
    opt = jsys.opt
    k_perm, k_render = jax.random.split(key)
    ray_idx = jsampling.sample_ray_subset(k_perm, jsys.HW, opt.nerf.rand_rays // N_IMG,
                                          mode=opt.tpu.ray_sample)

    def loss_fn(params):
        out, target, extras = jsys._forward_train(params, state["aux"], jsys.train_data,
                                                  ray_idx, k_render, state["step"])
        losses = jsys.compute_loss(params, state["aux"], jsys.train_data, out, target,
                                   state["step"], extras)
        return jsys.summarize_loss(losses), (losses, extras)
    with mesh_lib.use_mesh(mesh_lib.make_mesh(2)):
        (total, (losses, extras)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(state["params"])
    metrics = {"loss_" + k: float(v) for k, v in losses.items()}
    metrics["loss_all"] = float(total)
    metrics["psnr"] = -10.0 * np.log10(metrics["loss_render"])
    metrics.update({k: float(v) for k, v in extras.items() if getattr(v, "ndim", 1) == 0})
    return metrics, jax.tree_util.tree_map(np.asarray, grads)


@pytest.fixture(scope="module")
def setup():
    """Per model: the job, the JAX sharded step 0 and the port's one-process
    run; the render job and JAX's sharded render of its view."""
    jobs, jax_ref = {}, {}
    for model in MODELS:
        opt = _options(model)
        dtu = model == "barf_inn_dtu"
        jsys, state = _systems(opt, dtu)
        n_rays = opt.nerf.rand_rays // N_IMG
        jobs[model] = _job(opt, dtu, state, 2, [_draws(opt, key, n_rays) for key in KEYS])
        jax_ref[model] = _jax_sharded_step0(jsys, state, KEYS[0])
        if model == "barf_inn_llff":
            with mesh_lib.use_mesh(mesh_lib.make_mesh(2)):
                render = jsys.render_image(state["params"], state["aux"],
                                           jsys.test_data["pose"][:1],
                                           jsys.test_data["intr"][:1])
            jax_ref["render"] = np.asarray(render["rgb"])
            jobs["render"] = _job(opt, dtu, state, 0, None, render=[0])
        few = [name for name, m in FEW_RAYS.items() if m == model]
        if few:     # 2 rays per image from the same state
            opt.nerf.rand_rays = 2 * N_IMG
            jobs[few[0]] = _job(opt, dtu, state, 2, [_draws(opt, key, 2) for key in KEYS])
    one = {name: audit.run_job(job, "cpu") for name, job in jobs.items()}
    return list(jobs), jobs, one, jax_ref


@pytest.fixture(scope="module")
def spawned(setup):
    """n_ranks -> per rank, {job name: run_job result}: one spawn per world
    size for the whole module, the two spawned side by side."""
    names, jobs, _, _ = setup
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(audit.run, [jobs[k] for k in names], n, backend="gloo",
                               device="cpu")
                   for n in (2, 3)}
        runs = {n: [dict(zip(names, results)) for results in f.result()]
                for n, f in futures.items()}
    return runs.__getitem__


@pytest.fixture(scope="module")
def one_f64(setup):
    """model -> the one-process step-0 gradients in float64 (computed once)."""
    _, jobs, _, _ = setup
    cache = {}

    def get(model):
        if model not in cache:
            cache[model] = audit.run_job(dict(jobs[model], steps=1, float64=True),
                                         "cpu")["grads"][0]
        return cache[model]
    return get


@pytest.mark.parametrize("n_ranks", [2, 3])
@pytest.mark.parametrize("model", list(MODELS) + list(FEW_RAYS))
def test_sharded_step_matches_one_process(spawned, setup, one_f64, model, n_ranks):
    """Every rank's metrics and summed gradients equal the one-process step's."""
    ranks = spawned(n_ranks)
    one = setup[2][model]
    for res in ranks:
        for step, rtol in enumerate(RTOL_LOSSES):
            for k, v in one["metrics"][step].items():
                np.testing.assert_allclose(res[model]["metrics"][step][k], v, rtol=rtol,
                                           atol=1e-12, err_msg="{} step {}".format(k, step))
        assert sorted(res[model]["grads"][0]) == sorted(one["grads"][0])
        for name, ref in one["grads"][0].items():
            got = res[model]["grads"][0][name]
            if audit.max_rel(got, ref) > 1e-5:
                f64 = one_f64(model)
                noise = max(audit.max_rel(g, f64[k]) for k, g in one["grads"][0].items())
                assert audit.max_rel(got, f64[name]) <= 1.5 * noise, name


@pytest.mark.parametrize("n_ranks", [2, 3])
@pytest.mark.parametrize("model", list(MODELS) + list(FEW_RAYS))
def test_parameters_bit_identical_across_ranks(spawned, model, n_ranks):
    ranks = spawned(n_ranks)
    for res in ranks[1:]:
        for name, p in ranks[0][model]["params"].items():
            assert np.array_equal(res[model]["params"][name], p), name
        for name, a in ranks[0][model]["aux"].items():
            assert np.array_equal(res[model]["aux"][name], a), name


@pytest.mark.parametrize("model", list(MODELS))
def test_sharded_step_matches_jax_mesh(spawned, setup, one_f64, model):
    """Step 0 on 2 ranks against the JAX package's step on a 2-device mesh."""
    ranks = spawned(2)
    metrics_j, grads_j = setup[3][model]
    res = ranks[0][model]
    assert sorted(res["metrics"][0]) == sorted(metrics_j)
    for k, v in metrics_j.items():
        np.testing.assert_allclose(res["metrics"][0][k], v, rtol=5e-4, atol=1e-5, err_msg=k)
    ref = {k: v.numpy() for k, v in weights.from_jax_params(grads_j).items()}
    assert sorted(res["grads"][0]) == sorted(ref)
    noisy = bool(setup[1][model]["options"]["nerf"].get("density_noise_reg"))
    for name, gj in ref.items():
        got = res["grads"][0][name]
        if noisy:
            rel_l2 = np.linalg.norm(got - gj) / max(float(np.linalg.norm(gj)), 1e-12)
            assert rel_l2 < 1e-2, name
        elif not np.allclose(got, gj, rtol=1e-4, atol=1e-5 * np.abs(gj).max() + 1e-9):
            # then the jitted JAX leaf is off float64 (XLA's fused sin/cos),
            # and the port must lie nearer float64 than it
            f64 = one_f64(model)[name]
            assert 1e-5 < audit.max_rel(gj, f64), name
            assert audit.max_rel(got, f64) < audit.max_rel(gj, f64), name


@pytest.mark.parametrize("n_ranks", [2, 3])
def test_sharded_render(spawned, setup, n_ranks):
    """render_image's chunks split over the ranks and gathered: every rank
    holds the image of one process, and of the JAX package's sharded render."""
    ranks = spawned(n_ranks)
    one = setup[2]["render"]["renders"][0]
    for res in ranks:
        out = res["render"]["renders"][0]
        assert sorted(out) == sorted(one)
        for k, v in one.items():
            assert out[k].shape == v.shape
            assert audit.max_rel(out[k], v) <= 1e-6, k
        np.testing.assert_allclose(out["rgb"], setup[3]["render"], rtol=2e-4, atol=1e-5)
        assert res["render"]["metrics"] == []


def test_helpers_are_noops_without_a_group():
    x = torch.arange(24.0).reshape(2, 4, 3)
    assert mesh.active_group() is None and mesh.world_size() == 1
    assert mesh.shard_bounds(7) == (0, 7)
    assert mesh.shard_rays(x) is x
    assert mesh.all_reduce_sum(x) is x and mesh.all_gather_rays(x, 4) is x
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    mesh.all_reduce_grads([p])
    assert torch.equal(p.grad, torch.full((3,), 2.0))
    # under a group of 3 (no collective is made): each rank's bounds are
    # those of the rays shard_rays gives it, in rank order, 0 of 2 for rank 2
    for n, sizes in ((64, [22, 21, 21]), (2, [1, 1, 0])):
        lo = 0
        for rank, size in enumerate(sizes):
            with mesh.use_group(mesh.RayGroup(None, rank, 3)):
                assert mesh.shard_bounds(n) == (lo, lo + size)
                assert torch.equal(mesh.shard_rays(torch.arange(n), 0),
                                   torch.arange(lo, lo + size))
            lo += size
