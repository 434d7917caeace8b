"""The plain versions of the port's per-sample field kernels K5
(ops/cuda/fused_pe.py::fused_apply_nerf_samples_pe) and K1
(ops/cuda/fused_field.py::fused_apply_nerf_samples), and of K2's noise and
``prob`` operands, against the JAX package's Pallas kernels run in interpret
mode on the CPU, at full width on 2 x 3 rays with 16 samples and R_BLK = 2
(three grid steps, so the kernels' dW accumulation runs).

Depths are powers of two, so center + ray * depth is exact on both sides
(the Pallas kernel may contract it into an FMA) and values and gradients
must agree tightly: values rtol 1e-4 / atol 1e-6; gradients rtol 5e-3 with
atol 1e-6 (center, ray) and 5e-6 (weight leaves), for fp32 summation order,
as tests/test_fused_pe.py holds the kernels to their jnp path. With density
noise many relu pre-activations lie near 0, a mask can land on the other
side, and element-wise bounds mean nothing: each gradient leaf is then held
to a relative L2 error below 1e-2, as that file's fine-sampling test does.

The CUDA kernels themselves need the card: chip_smoke.py holds them against
these plain versions there.
"""

import ctypes
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neural_invertible_warp_tpu.ops.pallas import fused_field as jff
from neural_invertible_warp_tpu.ops.pallas import fused_pe as jfp
from neural_invertible_warp_tpu_torch.ops.cuda import fused_field as ff
from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
from neural_invertible_warp_tpu_torch.ops.nerf_mlp import NerfMLP
from neural_invertible_warp_tpu_torch.utils import weights

from test_torch_fused_pe import ARCH, C2F, PROGRESS, _rel_l2, setup, small_blocks  # noqa: F401

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

K = 16
NOISE_REG = 0.7
# (name, images, c2f, density activation, noise)
CASES = [
    ("softplus c2f", 2, C2F, "softplus", False),
    ("relu all bands", 2, None, "relu", False),
    ("softplus noise", 2, C2F, "softplus", True),
    ("relu noise", 2, None, "relu", True),
    ("ragged relu noise", 1, None, "relu", True),
]
IDS = [c[0].replace(" ", "_") for c in CASES]


def _depth(seed, B, R=3):
    rng = np.random.RandomState(seed)
    return np.sort(rng.choice([0.5, 1.0, 2.0, 4.0], (B, R, K)), axis=-1)[
        ..., None].astype(np.float32)


def _noise(key, shape):
    """The JAX wrappers' own draw (``_make_noise``), for the port's operand."""
    return np.asarray(jax.random.normal(key, shape, jnp.float32)) * NOISE_REG


def _check_grads(g_port, g_jax, mlp, rel_l2):
    """g_port: [dcenter, dray] + grads of mlp.parameters(); g_jax: (params
    tree, dcenter, dray)."""
    g_w = weights.nerf_to_jax(mlp, get=dict(zip(mlp.parameters(), g_port[2:])).__getitem__)
    leaves_j = jax.tree_util.tree_leaves_with_path(g_jax[0])
    leaves_t = jax.tree_util.tree_leaves(g_w)
    assert len(leaves_j) == len(leaves_t) == 20
    pairs = [("dcenter", g_jax[1], g_port[0].numpy(), 1e-6),
             ("dray", g_jax[2], g_port[1].numpy(), 1e-6)]
    pairs += [(jax.tree_util.keystr(p), a, b, 5e-6) for (p, a), b in zip(leaves_j, leaves_t)]
    for name, a, b, atol in pairs:
        a = np.asarray(a)
        assert np.abs(a).max() > 0, name
        if rel_l2:
            assert _rel_l2(b, a) < 1e-2, name
        else:
            np.testing.assert_allclose(b, a, rtol=5e-3, atol=atol, err_msg=name)


def _field_case(setup, n_img, c2f, activ, noisy, jax_fn, port_fn):
    params, mlp, center, ray = setup
    c, r = center[:n_img], ray[:n_img]
    depth = _depth(17, n_img)
    rng = np.random.RandomState(17)
    cot = (rng.randn(n_img, 3, K, 3).astype(np.float32),
           rng.randn(n_img, 3, K).astype(np.float32))
    key = jax.random.PRNGKey(4)
    kw = dict(progress=PROGRESS, barf_c2f=c2f, density_activ=activ)
    jkw = dict(kw, density_noise_reg=NOISE_REG, noise_key=key) if noisy else kw
    out_j, vjp = jax.vjp(
        lambda p, cc, rr: jax_fn(p, ARCH, cc, rr, jnp.asarray(depth), interpret=True, **jkw),
        params, jnp.asarray(c), jnp.asarray(r))
    g_j = vjp(tuple(jnp.asarray(x) for x in cot))

    c_t = torch.tensor(c, requires_grad=True)
    r_t = torch.tensor(r, requires_grad=True)
    pkw = dict(kw, noise=torch.tensor(_noise(key, (n_img, 3, K)))) if noisy else kw
    out_t = port_fn(mlp, c_t, r_t, torch.tensor(depth), **pkw)
    grads = torch.autograd.grad(out_t, [c_t, r_t] + list(mlp.parameters()),
                                [torch.tensor(x) for x in cot])
    for name, a, b in zip(("rgb", "density"), out_t, out_j):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    _check_grads(grads, g_j, mlp, rel_l2=noisy)


@pytest.mark.parametrize("case,n_img,c2f,activ,noisy", CASES, ids=IDS)
def test_k5_plain_matches_pallas(setup, small_blocks, case, n_img, c2f, activ, noisy):
    """K5's plain version (the port's CPU wrapper under autograd) against
    ``fused_apply_nerf_samples_pe`` and its VJP kernel: per-sample rgb and
    density, dcenter, dray and all 20 weight leaves."""
    _field_case(setup, n_img, c2f, activ, noisy, jfp.fused_apply_nerf_samples_pe,
                fp.fused_apply_nerf_samples_pe)


@pytest.mark.parametrize("case,n_img,c2f,activ,noisy", CASES, ids=IDS)
def test_k1_plain_matches_pallas(setup, small_blocks, case, n_img, c2f, activ, noisy):
    """K1's plain version (PE under autograd, then the MLP on encoded
    inputs) against ``fused_field.fused_apply_nerf_samples`` and its VJP
    kernel. The Pallas K1 has no noise operand, the port's has one that must
    mean what K5's means: the noise cases are held to the Pallas K5."""
    _field_case(setup, n_img, c2f, activ, noisy,
                jfp.fused_apply_nerf_samples_pe if noisy else jff.fused_apply_nerf_samples,
                ff.fused_apply_nerf_samples)


@pytest.mark.parametrize("activ,bg", [("softplus", None), ("relu", 1.0)])
def test_k2_plain_noise_and_prob_match_pallas(setup, small_blocks, activ, bg):
    """K2's plain version with the density-noise operand and the
    compositing-weights output against ``fused_render_rays_pe_train(
    want_prob=True)``: loss, metric outputs, prob (rtol 1e-3 / atol 1e-5 as
    tests/test_fused_pe.py::test_train_kernel_want_prob_parity), every
    gradient (relative L2, noise being active), and no gradient through
    prob."""
    params, mlp, center, ray = setup
    depth = _depth(19, 2)
    target = np.random.RandomState(19).rand(2, 3, 3).astype(np.float32)
    key = jax.random.PRNGKey(6)
    kw = dict(progress=PROGRESS, barf_c2f=C2F, setbg_opaque=bg is not None, bgcolor=bg,
              density_activ=activ)

    def loss(params, cc, rr):
        out, sq, n = jfp.fused_render_rays_pe_train(
            params, ARCH, cc, rr, jnp.asarray(depth), jnp.asarray(target), interpret=True,
            want_prob=True, density_noise_reg=NOISE_REG, noise_key=key, **kw)
        return sq / n, out
    (l_j, out_j), g_j = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(center), jnp.asarray(ray))

    c_t = torch.tensor(center, requires_grad=True)
    r_t = torch.tensor(ray, requires_grad=True)
    out_t, sq, n = fp.fused_render_rays_pe_train(
        mlp, c_t, r_t, torch.tensor(depth), torch.tensor(target),
        noise=torch.tensor(_noise(key, (2, 3, K))), want_prob=True, **kw)
    assert not out_t["prob"].requires_grad and out_t["prob"].shape == (2, 3, K)
    grads = torch.autograd.grad(sq / n, [c_t, r_t] + list(mlp.parameters()))
    np.testing.assert_allclose(float(sq.detach() / n), float(l_j), rtol=1e-5)
    for k in ("rgb", "depth", "opacity"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(out_t["prob"].numpy(), np.asarray(out_j["prob"]), rtol=1e-3,
                               atol=1e-5)
    _check_grads(grads, g_j, mlp, rel_l2=True)


def test_k2_plain_prob_is_the_compositing_weight(setup):
    """prob sums to the opacity, and without noise equals what the plain
    chain composites with."""
    _, mlp, center, ray = setup
    c, r = torch.tensor(center), torch.tensor(ray)
    depth = torch.tensor(_depth(3, 2))
    target = torch.rand(2, 3, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out, _, _ = fp.fused_render_rays_pe_train(mlp, c, r, depth, target, want_prob=True)
        plain = fp.fused_render_rays_pe_train(mlp, c, r, depth, target)[0]
    assert "prob" not in plain
    torch.testing.assert_close(out["prob"].sum(-1, keepdim=True), out["opacity"],
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(out["rgb"], plain["rgb"])


def test_cpu_field_wrappers_run_plain_and_launch_nothing(setup):
    """On CPU tensors the K5 and K1 wrappers run their plain versions
    (equal to the plain chain bit for bit); no launch counter moves."""
    from neural_invertible_warp_tpu_torch.ops.nerf_mlp import apply_nerf_samples
    _, mlp, center, ray = setup
    counts = lambda: (fp.fused_apply_nerf_samples_pe.launches,  # noqa: E731
                      fp.fused_apply_nerf_samples_pe.backward_launches,
                      ff.fused_mlp.launches, ff.fused_mlp.backward_launches)
    before = counts()
    c = torch.tensor(center, requires_grad=True)
    r, depth = torch.tensor(ray), torch.tensor(_depth(3, 2))
    noise = torch.randn(2, 3, K, generator=torch.Generator().manual_seed(0))
    ref = apply_nerf_samples(mlp, c, r, depth, density_activ="relu", noise=noise)
    got = fp.fused_apply_nerf_samples_pe(mlp, c, r, depth, density_activ="relu", noise=noise)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    got[0].sum().backward()
    assert c.grad is not None
    for nz in (None, noise):
        ref = apply_nerf_samples(mlp, c, r, depth, noise=nz)
        got = ff.fused_apply_nerf_samples(mlp, c, r, depth, noise=nz)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    ref = apply_nerf_samples(mlp, c, r, depth)
    flat = fp.field_samples_plain(mlp, c[0], r[0], depth[0, :, :, 0])
    assert torch.equal(flat[:, 3].reshape(3, K), ref[1][0])
    assert counts() == before


@pytest.mark.parametrize("launch", ["k5_fwd", "k5_bwd", "k1_fwd", "k1_bwd", "k2_noise"])
def test_field_launchers_reject_cpu_tensors(setup, launch):
    """The launchers take CUDA tensors only; on CPU tensors they raise
    before any pointer reaches the kernel library."""
    _, mlp, _, _ = setup
    c, r, d = torch.zeros(2, 3), torch.ones(2, 3), torch.ones(2, 8)
    w3, wv = fp.band_weights(None, None, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        if launch == "k5_fwd":
            fp.launch_field_pe_fwd(mlp, c, r, d, w3, wv, noise=torch.zeros(2, 8))
        elif launch == "k5_bwd":
            fp.launch_field_pe_bwd(mlp, c, r, d, torch.zeros(16, 4), w3, wv, torch.zeros(4),
                                   fp.k2_weights(mlp))
        elif launch == "k1_fwd":
            ff.launch_field_fwd(mlp, torch.zeros(4, 63), torch.zeros(4, 27),
                                noise=torch.zeros(4))
        elif launch == "k1_bwd":
            ff.launch_field_bwd(mlp, torch.zeros(4, 4), torch.zeros(4), fp.k2_weights(mlp))
        else:
            fp.launch_rm_train(mlp, c, r, d, torch.zeros(2, 8), w3, wv,
                               noise=torch.zeros(2, 8), want_prob=True)


class _FakeFieldLibrary:
    """The kernel library's K5 and K1 entry points on the CPU: each launch
    records its weight operands; the outputs are zeros, and the weight
    gradients are the packed weights themselves, so that unpacking them must
    give back the parameters."""

    def __init__(self, mlp):
        self.packed = fp.pack_weights(mlp)
        self.calls = []

    def niw_field_pe_fwd_workspace_floats(self, n, keep):
        return 4

    niw_field_fwd_workspace_floats = niw_field_pe_fwd_workspace_floats

    def niw_field_pe_bwd_workspace_floats(self, n):
        return 4

    niw_field_bwd_workspace_floats = niw_field_pe_bwd_workspace_floats

    def niw_field_pe_fwd(self, center, ray, depth, noise, R, K, w3, wv, W, W_split, w_lo,
                         activ, keep, out, ws, stream):
        self.calls.append(("k5 fwd", W, W_split, w_lo, keep))
        ctypes.memset(out, 0, R * K * 4 * 4)
        return 0

    def niw_field_fwd(self, xp, view, noise, N, W, W_split, w_lo, activ, keep, out, ws,
                      stream):
        self.calls.append(("k1 fwd", W, W_split, w_lo, keep))
        ctypes.memset(out, 0, N * 4 * 4)
        return 0

    def _grads(self, want_dw, dW):
        for i, w in enumerate(self.packed if want_dw else []):
            ctypes.memmove(dW[i], w.data_ptr(), w.numel() * 4)

    def niw_field_pe_bwd(self, center, ray, depth, g, R, K, w3, wv, W_split, w_lo, activ,
                         cache, want_dw, dcenter, dray, dW, ws, stream):
        self.calls.append(("k5 bwd", None, W_split, w_lo, want_dw))
        ctypes.memset(dcenter, 0, R * 3 * 4)
        ctypes.memset(dray, 0, R * 3 * 4)
        self._grads(want_dw, dW)
        return 0

    def niw_field_bwd(self, g, N, W_split, w_lo, activ, cache, want_dw, dxp, dview, dW, ws,
                      stream):
        self.calls.append(("k1 bwd", None, W_split, w_lo, want_dw))
        ctypes.memset(dxp, 0, N * 63 * 4)
        ctypes.memset(dview, 0, N * 27 * 4)
        self._grads(want_dw, dW)
        return 0


def test_k5_k1_take_the_k2_weights_cache_entry(monkeypatch):
    """K5 and K1 launch on ``k2_weights(mlp)``: each forward with the
    entry's fp32 and split pointers and its ``keep`` flag (the kernel reads
    the split ones in a render, the fp32 ones when it keeps its activations),
    each backward with the split pointers of the entry that its forward kept
    (``_FieldSamples`` holds it, also when the cache has dropped it). Two
    fields rendered over several chunks pack once each; an optimizer step
    makes a new entry. The weight gradients come back in the packed layout
    and are unpacked onto ``mlp.parameters()``. The library is a fake here,
    so only the operands are checked."""
    fields = [NerfMLP(ARCH, generator=torch.Generator().manual_seed(i)) for i in range(2)]
    lib = _FakeFieldLibrary(fields[0])
    monkeypatch.setattr(fp.build, "load_library", lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(fp, "_check_inputs", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    R, n_samples = 3, 16
    c, r = torch.zeros(R, 3), torch.ones(R, 3)
    d = torch.linspace(0.1, 1.0, n_samples).expand(R, n_samples).contiguous()
    w3, wv = fp.band_weights(None, None, "cpu")
    xp, view = torch.zeros(R * n_samples, 63), torch.zeros(R * n_samples, 27)
    packs = fp.fused_render_rays_pe_train.packs
    for _ in range(3):   # render chunks: the coarse and the fine field, K5 and K1
        for mlp in fields:
            fp.launch_field_pe_fwd(mlp, c, r, d, w3, wv)
            ff.launch_field_fwd(mlp, xp, view)
    assert fp.fused_render_rays_pe_train.packs == packs + 2
    entries = [fp.k2_weights(mlp) for mlp in fields]
    assert [call[0] for call in lib.calls] == ["k5 fwd", "k1 fwd"] * 6
    for i, (_, W, W_split, w_lo, keep) in enumerate(lib.calls):
        entry = entries[(i // 2) % 2]
        assert W is entry.ptrs and W_split is entry.split_ptrs
        assert w_lo == entry.lo == fp.PLANE_FLOATS and keep == 0

    def k5(mlp, c_t):
        return fp.run_field_kernel(
            fp.fused_apply_nerf_samples_pe, mlp, c_t, r,
            lambda c, r, keep: fp.launch_field_pe_fwd(mlp, c, r, d, w3, wv, keep=keep),
            lambda c, r, g, cache, packed, want_dw: fp.launch_field_pe_bwd(
                mlp, c, r, d, g, w3, wv, cache, packed, want_dw))

    def k1(mlp, x_t):
        return fp.run_field_kernel(
            ff.fused_mlp, mlp, x_t, view,
            lambda x, v, keep: ff.launch_field_fwd(mlp, x, v, keep=keep),
            lambda x, v, g, cache, packed, want_dw: ff.launch_field_bwd(
                mlp, g, cache, packed, want_dw))
    for frozen in (True, False):   # with the weights frozen, then with dW
        for mlp in fields:
            mlp.requires_grad_(not frozen)
            for run, a in ((k5, c), (k1, xp)):
                lib.calls.clear()
                a_t = a.clone().requires_grad_(True)
                out = run(mlp, a_t)
                hit = fp._K2_WEIGHTS.pop(mlp)   # the backward reads the entry kept with it
                out.sum().backward()
                fp._K2_WEIGHTS[mlp] = hit
                kept = entries[fields.index(mlp)]
                (_, W, W_split, w_lo, keep), (_, _, W_split_b, w_lo_b, want_dw) = lib.calls
                assert keep == 1 and W is kept.ptrs and W_split is kept.split_ptrs
                assert W_split_b is kept.split_ptrs and w_lo == w_lo_b == fp.PLANE_FLOATS
                assert want_dw == (0 if frozen else 1)
                assert torch.equal(a_t.grad, torch.zeros_like(a))
                if not frozen:
                    for p, w in zip(mlp.parameters(), fp.unpack_grads(lib.packed)):
                        assert torch.equal(p.grad, w)
                    mlp.zero_grad()
    assert fp.fused_render_rays_pe_train.packs == packs + 2
    opt = torch.optim.SGD(fields[0].parameters(), lr=1e-3)
    sum(p.sum() for p in fields[0].parameters()).backward()
    opt.step()
    lib.calls.clear()
    for mlp in fields:
        fp.launch_field_pe_fwd(mlp, c, r, d, w3, wv)
    second = fp.k2_weights(fields[0])
    assert second is not entries[0] and lib.calls[0][2] is second.split_ptrs
    assert lib.calls[1][2] is entries[1].split_ptrs
    assert fp.fused_render_rays_pe_train.packs == packs + 3
