"""The port's fused INN warp (ops/cuda/fused_inn.py) on the CPU, where its
wrapper runs the kernel's plain version: against the JAX package's Pallas
kernel in interpret mode (ops/pallas/fused_inn.py) and against the JAX plain
chain (ops/inn.py::deform_forward).

One set-up, as tests/test_fused_inn.py builds it: the JAX init with every
leaf perturbed by 0.05 * randn (at init the output layers are zero and the
warp is the identity), carried into the port over the weight bridge;
d_feat 16, the kernel's hidden width 128, points [3,40,3] and a ragged
[1,7,3]. Values: rtol = atol = 1e-5, that test's own (the same fp32 products
in another order). Gradients of sum(sin(3 out)) with respect to pts, code
and every leaf: relative L2 error below 5e-4 per leaf. That test holds 1e-4
at its one alpha (0.6); at the alphas here the JAX package's own two
evaluations (Pallas kernel and chain) differ by up to 1.4e-4 on the leaf
with the most cancellation (a one-element output bias), and every fp32
evaluation is 1e-4 to 1e-2 from a float64 one: with every PE column of the
first layers perturbed, the 2^5 pi band multiplies each rounding difference
of a coordinate by 100 per block.

Then the flagship train step with ``tpu.fused_inn: true`` against the JAX
system's step (which on the CPU takes its plain chain): losses to 1e-5, as
tests/test_torch_train_step.py holds the fused-off step; every gradient leaf
to 1e-4 plus 1e-4 of the leaf's largest entry (that test: 1e-5 of it; the
kernel's contract takes the window past the first-layer product, so entries
of the warp's weight gradients far below the leaf's largest differ by up to
5e-5 of it from the chain's).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neural_invertible_warp_tpu import config
from neural_invertible_warp_tpu.models import get_system_class as jax_system_class
from neural_invertible_warp_tpu.ops import inn as jinn
from neural_invertible_warp_tpu.ops import sampling as jsampling
from neural_invertible_warp_tpu.ops.pallas import fused_inn as jfused
from neural_invertible_warp_tpu_torch.models import get_system_class
from neural_invertible_warp_tpu_torch.ops import inn
from neural_invertible_warp_tpu_torch.ops.cuda import fused_inn
from neural_invertible_warp_tpu_torch.utils import weights

from test_torch_train_step import H, W, N_IMG, OVERRIDES, _arrays, _draws, _leaves

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

D_FEAT = 16
TOL_GRAD_REL_L2 = 5e-4
CASES = {"3x40": (slice(0, 3), slice(0, 40)), "ragged 1x7": (slice(0, 1), slice(0, 7))}


@pytest.fixture(scope="module")
def setup():
    params = jinn.init_deform_params(jax.random.PRNGKey(0), d_feature=D_FEAT, d_hidden=128,
                                     n_blocks=3, n_layers=1, multires=6)
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(1)
    leaves = [np.asarray(l) + 0.05 * rng.randn(*l.shape).astype(np.float32) for l in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    code = rng.randn(3, D_FEAT).astype(np.float32)
    pts = rng.randn(3, 40, 3).astype(np.float32)
    net = inn.DeformNetwork(D_FEAT, d_hidden=128, multires=6)
    net.load_state_dict(weights.deform_from_jax(params))
    return params, net, code, pts


def _jax_fused(params, code, pts, alpha):
    return jfused.fused_deform_forward(params, code, pts, alpha, multires=6,
                                       actfn="softplus", anneal="reference", interpret=True)


def _jax_chain(params, code, pts, alpha):
    return jinn.deform_forward(params, code, pts, alpha, multires=6, actfn="softplus",
                               anneal="reference")


def test_supports(setup):
    _, net, _, _ = setup
    assert fused_inn.supports(net)
    for kw in (dict(anneal="bands"), dict(actfn="relu"), dict(multires=4),
               dict(d_hidden=64), dict(n_layers=2), dict(n_blocks=2)):
        other = inn.DeformNetwork(D_FEAT, **dict(dict(d_hidden=128, multires=6), **kw))
        assert not fused_inn.supports(other), kw
        (name, value), = kw.items()
        with pytest.raises(ValueError, match="paper's configuration.*{}={} ".format(name, value)):
            fused_inn.fused_deform_forward(other, torch.zeros(1, D_FEAT),
                                           torch.zeros(1, 2, 3), 0.5)


@pytest.mark.parametrize("alpha", [0.0, 0.37, 1.0])
@pytest.mark.parametrize("D", [1, 2])
def test_row_windows(alpha, D):
    for N in (7, 40, 226):
        ref = np.asarray(jfused._row_windows(N, D, 6, jnp.float32(alpha)))
        got = fused_inn.row_windows(N, torch.tensor(alpha), "cpu")[D - 1]
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("alpha", [0.0, 0.37, 1.0])
@pytest.mark.parametrize("case", sorted(CASES))
def test_values(setup, case, alpha):
    params, net, code, pts = setup
    b, n = CASES[case]
    code, pts = code[b], pts[b, n]
    with torch.no_grad():
        got = fused_inn.fused_deform_forward(net, torch.tensor(code), torch.tensor(pts), alpha)
        rw1, rw2 = fused_inn.row_windows(pts.shape[1], alpha, "cpu")
        plain = fused_inn.fused_deform_plain(
            torch.tensor(pts), rw1, rw2, fused_inn.block_codes(net, torch.tensor(code)),
            fused_inn.leaves_of(net))
        chain = net(torch.tensor(code), torch.tensor(pts), alpha)
    assert torch.equal(got, plain)       # on CPU tensors the wrapper is the plain version
    assert float((got - torch.tensor(pts)).abs().max()) > 1e-2     # not the identity
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    for name, ref in (("pallas", _jax_fused), ("chain", _jax_chain)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref(jp, code, pts, jnp.float32(alpha))),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got.numpy(), chain.numpy(), rtol=1e-5, atol=1e-5)


def _rel(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-12)


@pytest.mark.parametrize("alpha", [0.0, 0.37, 1.0])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients(setup, case, alpha):
    params, net, code, pts = setup
    b, n = CASES[case]
    code, pts = code[b], pts[b, n]
    jp = jax.tree_util.tree_map(jnp.asarray, params)

    def loss_of(fn):
        return lambda p, c, x: jnp.sum(jnp.sin(fn(p, c, x, jnp.float32(alpha)) * 3.0))
    refs = {name: jax.grad(loss_of(fn), argnums=(0, 1, 2))(jp, jnp.asarray(code),
                                                           jnp.asarray(pts))
            for name, fn in (("pallas", _jax_fused), ("chain", _jax_chain))}
    c = torch.tensor(code, requires_grad=True)
    x = torch.tensor(pts, requires_grad=True)
    net.zero_grad()
    torch.sum(torch.sin(3.0 * fused_inn.fused_deform_forward(net, c, x, alpha))).backward()
    g_t = jax.tree_util.tree_leaves(weights.deform_to_jax(net, get=lambda q: q.grad))
    for name, (g_p, g_c, g_x) in refs.items():
        assert _rel(g_c, c.grad.numpy()) < TOL_GRAD_REL_L2, name
        assert _rel(g_x, x.grad.numpy()) < TOL_GRAD_REL_L2, name
        leaves_j = jax.tree_util.tree_leaves_with_path(g_p)
        assert len(leaves_j) == len(g_t) == 36
        for (path, a), got in zip(leaves_j, g_t):
            assert _rel(a, got) < TOL_GRAD_REL_L2, (name, jax.tree_util.keystr(path))


# ------------------------------------------------ the train step, switch on

FUSED_OVERRIDES = [o for o in OVERRIDES if "d_hidden" not in o] + [
    "--inn.real_nvp.d_hidden=128", "--tpu.fused_inn=true"]


def _options(tmp_path):
    opt = config.load_options("options/barf_inn_llff.yaml")
    opt = config.override_options(opt, config.parse_arguments(FUSED_OVERRIDES),
                                  key_stack=[], safe_check=True)
    opt.H, opt.W = H, W
    opt.output_path = str(tmp_path)
    return opt


def test_step0_with_the_fused_warp(tmp_path, monkeypatch):
    """``tpu.fused_inn: true`` sends the warp of the train step through the
    wrapper (here its plain version), with the same result as the chain
    with the switch off; with the switch on, a configuration the kernel does
    not cover raises and names the setting."""
    opt = _options(tmp_path / "jax")
    jsys = jax_system_class("barf_inn_llff")(opt)
    train, test = _arrays(N_IMG, 0), _arrays(1, 1)
    jsys.attach_data(train, test)
    state = jsys.init_state(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def fill(x):
        x = np.asarray(x)
        return (rng.randn(*x.shape) * 0.02).astype(np.float32) if not np.any(x) else x
    params = jax.tree_util.tree_map(np.asarray, state["params"])
    params["warp_mlp"] = jax.tree_util.tree_map(fill, params["warp_mlp"])
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    step = jnp.int32(2)

    psys = get_system_class("barf_inn_llff")(_options(tmp_path / "port"), "cpu")
    psys.attach_data(train, test)
    psys.init_state(0)
    psys.graph.load_state_dict(weights.from_jax_params(params))
    psys.step = 2

    n_rays, K = opt.nerf.rand_rays // N_IMG, opt.nerf.sample_intvs
    key = jax.random.PRNGKey(42)
    _, depth_rand = _draws(key, n_rays, K)
    k_perm, k_render = jax.random.split(key)
    ray_idx = jsampling.sample_ray_subset(k_perm, H * W, n_rays, mode="stratified")

    def loss_fn(p):
        out, target, extras = jsys._forward_train(p, state["aux"], jsys.train_data, ray_idx,
                                                  k_render, step)
        losses = jsys.compute_loss(p, state["aux"], jsys.train_data, out, target, step, extras)
        return jsys.summarize_loss(losses), losses
    (total_j, losses_j), g_j = jax.value_and_grad(loss_fn, has_aux=True)(jparams)

    calls = []
    real = fused_inn.fused_deform_forward
    monkeypatch.setattr(fused_inn, "fused_deform_forward",
                        lambda *a: calls.append(1) or real(*a))
    idx_t = torch.from_numpy(np.array(ray_idx)).long()

    def port_step0():
        psys.optim.zero_grad()
        out, target, extras = psys._forward_train(idx_t, psys.step, torch.tensor(depth_rand))
        losses = psys.compute_loss(out, target, extras)
        total = psys.summarize_loss(losses)
        total.backward()
        return (float(total.detach()), {k: float(v.detach()) for k, v in losses.items()},
                jax.tree_util.tree_leaves(
                    weights.to_jax_params(psys.graph, get=lambda p: p.grad.clone())))
    total_t, losses_t, g_t = port_step0()
    assert calls == [1]
    for k in ("render", "global_alignment"):
        np.testing.assert_allclose(losses_t[k], float(losses_j[k]), rtol=1e-5, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_allclose(total_t, float(total_j), rtol=1e-5)
    lj = _leaves(g_j)
    assert len(lj) == len(g_t) > 30
    for (path, a), b in zip(lj, g_t):
        a = np.asarray(a)
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4 * np.abs(a).max() + 1e-9,
                                   err_msg=jax.tree_util.keystr(path))

    # switch off: the chain, the same step
    psys.opt.tpu.fused_inn = False
    total_off, _, g_off = port_step0()
    assert calls == [1]
    np.testing.assert_allclose(total_off, total_t, rtol=1e-6)
    for a, b in zip(g_off, g_t):   # entries far below the leaf's largest are rounding noise
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4 * np.abs(a).max() + 1e-9)
    # switch on, a network the kernel does not cover: no silent plain chain
    psys.opt.tpu.fused_inn = True
    psys.graph.warp_mlp.anneal = "bands"
    with pytest.raises(ValueError, match="anneal=bands"):
        port_step0()
