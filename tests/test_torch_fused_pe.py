"""The plain versions of the port's K2/K3/K4 (neural_invertible_warp_tpu_torch/
ops/cuda/fused_pe.py) against the JAX package's Pallas kernels run in
interpret mode on the CPU (fused_render_rays_pe_train, fused_render_rays_pe
and its VJP), at the shapes of tests/test_fused_pe.py: 2 x 3 rays, K = 128,
full width, R_BLK = 2 (three grid steps, so the kernels' dW accumulation runs).

Tolerances mirror tests/test_fused_pe.py. With power-of-two depths,
center + ray * depth is exact on both sides, so values and every gradient
must match tightly (loss rtol 1e-5; gradients rtol 5e-3 with tiny atol, for
fp32 summation order). With realistic depths the two sides round the
points differently (the Pallas kernel may contract center + ray * depth
into an FMA), and a ReLU pre-activation near 0 can land on the other side,
which moves one ray's gradient by a finite amount: per-ray gradients must
agree to 1e-3 for all rays but one, weight gradients by relative L2
(< 2e-2, as the JAX tests use).

The CUDA kernels themselves need the card: chip_smoke.py holds them
against these plain versions there.
"""

import ctypes
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neural_invertible_warp_tpu.dotdict import DotDict
from neural_invertible_warp_tpu.ops import nerf_mlp as jmlp
from neural_invertible_warp_tpu.ops.pallas import fused_pe as jfp
from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
from neural_invertible_warp_tpu_torch.ops.nerf_mlp import NerfMLP
from neural_invertible_warp_tpu_torch.utils import weights

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

ARCH = DotDict(dict(
    layers_feat=[None, 256, 256, 256, 256, 256, 256, 256, 256],
    layers_rgb=[None, 128, 3], skip=[4], posenc=dict(L_3D=10, L_view=4),
    density_activ="softplus", tf_init=True))
C2F, PROGRESS = (0.1, 0.5), 0.4


@pytest.fixture(scope="module")
def setup():
    params = jmlp.init_nerf_params(jax.random.PRNGKey(0), ARCH)
    mlp = NerfMLP(ARCH)
    mlp.load_state_dict(weights.nerf_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.RandomState(0)
    B, R = 2, 3
    center = rng.randn(B, R, 3).astype(np.float32) * 0.2
    ray = rng.randn(B, R, 3).astype(np.float32)
    return params, mlp, center, ray


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setattr(jfp, "R_BLK", 2)


def _exact_depth(seed, B, R, K=128):
    rng = np.random.RandomState(seed)
    return np.sort(rng.choice([0.5, 1.0, 2.0, 4.0], (B, R, K)), axis=-1)[
        ..., None].astype(np.float32)


def _jax_train(params, center, ray, depth, target, bg):
    def loss(params, center, ray):
        out, sq, n = jfp.fused_render_rays_pe_train(
            params, ARCH, center, ray, jnp.asarray(depth), jnp.asarray(target),
            progress=PROGRESS, barf_c2f=C2F, setbg_opaque=bg is not None,
            bgcolor=bg, interpret=True)
        return sq / n, out
    (l, out), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(center), jnp.asarray(ray))
    return float(l), out, g


def _port_train(mlp, center, ray, depth, target, bg):
    mlp.zero_grad()
    c = torch.tensor(center, requires_grad=True)
    r = torch.tensor(ray, requires_grad=True)
    out, sq, n = fp.fused_render_rays_pe_train(
        mlp, c, r, torch.tensor(depth), torch.tensor(target), progress=PROGRESS,
        barf_c2f=C2F, setbg_opaque=bg is not None, bgcolor=bg)
    (sq / n).backward()
    grads = weights.nerf_to_jax(mlp, get=lambda p: p.grad)
    return float(sq.detach() / n), out, (grads, c.grad.numpy(), r.grad.numpy())


def _rel_l2(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


@pytest.mark.parametrize("bg", [None, 1.0])
def test_train_plain_matches_pallas_exact(setup, small_blocks, bg):
    """K2's plain version: loss, metric outputs, dcenter, dray and all 20
    weight gradients, with c2f and with/without setbg_opaque."""
    params, mlp, center, ray = setup
    depth = _exact_depth(7, 2, 3)
    target = np.random.RandomState(7).rand(2, 3, 3).astype(np.float32)
    l_j, out_j, g_j = _jax_train(params, center, ray, depth, target, bg)
    l_t, out_t, (g_w, g_c, g_r) = _port_train(mlp, center, ray, depth, target, bg)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5)
    for k in ("rgb", "depth", "opacity"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(g_c, np.asarray(g_j[1]), rtol=5e-3, atol=1e-7)
    np.testing.assert_allclose(g_r, np.asarray(g_j[2]), rtol=5e-3, atol=1e-7)
    leaves_j = jax.tree_util.tree_leaves_with_path(g_j[0])
    leaves_t = jax.tree_util.tree_leaves(g_w)
    assert len(leaves_j) == len(leaves_t) == 20
    for (path, a), b in zip(leaves_j, leaves_t):
        np.testing.assert_allclose(b, np.asarray(a), rtol=5e-3, atol=5e-7,
                                   err_msg=jax.tree_util.keystr(path))


def test_train_plain_matches_pallas_realistic(setup, small_blocks):
    params, mlp, center, ray = setup
    rng = np.random.RandomState(9)
    depth = (np.sort(rng.rand(2, 3, 128, 1), axis=2) * 3 + 1).astype(np.float32)
    target = rng.rand(2, 3, 3).astype(np.float32)
    l_j, out_j, g_j = _jax_train(params, center, ray, depth, target, None)
    l_t, out_t, (g_w, g_c, g_r) = _port_train(mlp, center, ray, depth, target, None)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-3)
    np.testing.assert_allclose(out_t["rgb"].numpy(), np.asarray(out_j["rgb"]),
                               rtol=1e-3, atol=1e-3)
    # per ray: a sample whose ReLU pre-activation rounds to the other side
    # of 0 changes that ray's gradient by a finite amount, so all rays but
    # at most one must agree to 1e-3 (with these inputs one ray does flip)
    for got, ref in ((g_c, g_j[1]), (g_r, g_j[2])):
        got, ref = got.reshape(-1, 3), np.asarray(ref).reshape(-1, 3)
        off = np.linalg.norm(got - ref, axis=1) > 1e-3 * np.linalg.norm(ref, axis=1)
        assert off.sum() <= 1, off
    for a, b in zip(jax.tree_util.tree_leaves(g_j[0]), jax.tree_util.tree_leaves(g_w)):
        assert _rel_l2(b, a) < 2e-2


def test_train_plain_ragged_rays(setup, small_blocks):
    """3 rays: the Pallas wrapper pads to the ray block with valid = 0; the
    pad rays must contribute nothing, and the port (which does not pad)
    must give the same loss and weight gradients."""
    params, mlp, center, ray = setup
    c1, r1 = center[:1], ray[:1]
    depth = _exact_depth(11, 1, 3)
    target = np.random.RandomState(11).rand(1, 3, 3).astype(np.float32)
    l_j, _, g_j = _jax_train(params, c1, r1, depth, target, None)
    l_t, _, (g_w, g_c, _) = _port_train(mlp, c1, r1, depth, target, None)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5)
    np.testing.assert_allclose(g_c, np.asarray(g_j[1]), rtol=5e-3, atol=1e-7)
    for a, b in zip(jax.tree_util.tree_leaves(g_j[0]), jax.tree_util.tree_leaves(g_w)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=5e-3, atol=5e-7)


@pytest.mark.parametrize("n_img,c2f", [(2, C2F), (2, None), (1, C2F)])
def test_fwd_plain_matches_pallas(setup, small_blocks, n_img, c2f):
    """K3's plain version: rgb, depth, opacity; n_img=1 is the ragged case."""
    params, mlp, center, ray = setup
    rng = np.random.RandomState(5)
    depth = (np.sort(rng.rand(n_img, 3, 128, 1), axis=2) * 3 + 1).astype(np.float32)
    c, r = center[:n_img], ray[:n_img]
    ref = jfp.fused_render_rays_pe(params, ARCH, jnp.asarray(c), jnp.asarray(r),
                                   jnp.asarray(depth), progress=0.3, barf_c2f=c2f,
                                   interpret=True)
    with torch.no_grad():
        got = fp.fused_render_rays_pe(mlp, torch.tensor(c), torch.tensor(r),
                                      torch.tensor(depth), progress=0.3, barf_c2f=c2f)
    for name, a, b in zip(("rgb", "depth", "opacity"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-3,
                                   err_msg=name)


K4_CASES = [  # (name, images, c2f, bgcolor, density activation)
    ("c2f", 2, C2F, None, "softplus"),
    ("all bands", 2, None, None, "softplus"),
    ("background", 2, C2F, 1.0, "softplus"),
    ("ragged", 1, C2F, None, "softplus"),
    ("relu density", 2, C2F, None, "relu"),
]


@pytest.mark.parametrize("case,n_img,c2f,bg,activ", K4_CASES,
                         ids=[c[0].replace(" ", "_") for c in K4_CASES])
def test_bwd_plain_matches_pallas_exact(setup, small_blocks, case, n_img, c2f, bg, activ):
    """K4's plain version (autograd through the port's CPU wrapper) against
    the Pallas backward kernel in interpret mode (jax.vjp of
    fused_render_rays_pe), for a cotangent on rgb, depth and opacity:
    dcenter, dray and all 20 weight leaves. Power-of-two depths, so the
    points agree exactly; tolerances as
    tests/test_fused_pe.py::test_composited_gradient_parity_exact: rtol 5e-3
    with atol 1e-6 (center, ray) and 5e-6 (weight leaves), for fp32
    summation order."""
    params, mlp, center, ray = setup
    c, r = center[:n_img], ray[:n_img]
    depth = _exact_depth(13, n_img, 3)
    rng = np.random.RandomState(13)
    cot = [rng.randn(n_img, 3, 3).astype(np.float32),
           (rng.randn(n_img, 3, 1) * 0.1).astype(np.float32),
           rng.randn(n_img, 3, 1).astype(np.float32)]
    kw = dict(progress=PROGRESS, barf_c2f=c2f, setbg_opaque=bg is not None, bgcolor=bg,
              density_activ=activ)

    out_j, vjp = jax.vjp(
        lambda p, cc, rr: jfp.fused_render_rays_pe(
            p, ARCH, cc, rr, jnp.asarray(depth), interpret=True, **kw),
        params, jnp.asarray(c), jnp.asarray(r))
    g_j = vjp(tuple(jnp.asarray(x) for x in cot))

    c_t = torch.tensor(c, requires_grad=True)
    r_t = torch.tensor(r, requires_grad=True)
    out_t = fp.fused_render_rays_pe(mlp, c_t, r_t, torch.tensor(depth), **kw)
    grads = torch.autograd.grad(out_t, [c_t, r_t] + list(mlp.parameters()),
                                [torch.tensor(x) for x in cot])
    for name, a, b in zip(("rgb", "depth", "opacity"), out_t, out_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(g_j[1]), rtol=5e-3, atol=1e-6)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(g_j[2]), rtol=5e-3, atol=1e-6)
    g_w = weights.nerf_to_jax(mlp, get=dict(zip(mlp.parameters(), grads[2:])).__getitem__)
    leaves_j = jax.tree_util.tree_leaves_with_path(g_j[0])
    leaves_t = jax.tree_util.tree_leaves(g_w)
    assert len(leaves_j) == len(leaves_t) == 20
    for (path, a), b in zip(leaves_j, leaves_t):
        assert np.abs(np.asarray(a)).max() > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(b, np.asarray(a), rtol=5e-3, atol=5e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_backward_plain_is_the_wrappers_vjp(setup):
    """``render_rays_backward_plain`` (what the card holds K4 against) is the
    VJP of the CPU wrapper, with and without the weight gradients."""
    _, mlp, center, ray = setup
    c = torch.tensor(center).reshape(-1, 3)
    r = torch.tensor(ray).reshape(-1, 3)
    depth = torch.tensor(_exact_depth(3, 2, 3)).reshape(6, 128)
    g8 = torch.randn(6, 8, generator=torch.Generator().manual_seed(1))
    c_t, r_t = c.clone().requires_grad_(True), r.clone().requires_grad_(True)
    rgb, d, op = fp.fused_render_rays_pe(mlp, c_t[None], r_t[None], depth[None, ..., None],
                                         progress=PROGRESS, barf_c2f=C2F)
    ref = torch.autograd.grad([rgb, d, op], [c_t, r_t] + list(mlp.parameters()),
                              [g8[None, :, :3], g8[None, :, 3:4], g8[None, :, 4:5]])
    dc, dr, dws = fp.render_rays_backward_plain(mlp, c, r, depth, g8, PROGRESS, C2F)
    for a, b in zip([dc, dr] + dws, ref):
        assert torch.equal(a, b)
    dc2, dr2, none = fp.render_rays_backward_plain(mlp, c, r, depth, g8, PROGRESS, C2F,
                                                   want_dw=False)
    assert torch.equal(dc2, dc) and torch.equal(dr2, dr) and none == []


def test_pack_unpack_roundtrip(setup):
    """The kernels' weight layout: unpacking the packed weights as if they
    were gradients gives back every parameter, in ``parameters()`` order."""
    _, mlp, _, _ = setup
    packed = fp.pack_weights(mlp)
    assert [tuple(t.shape) for t in packed[:10]] == [
        (63, 256), (256, 256), (256, 256), (256, 256), (319, 256), (256, 256),
        (256, 256), (256, 257), (284, 128), (128, 3)]
    assert float(packed[8][256].abs().max()) == 0.0     # density slot of Wr0p
    for a, p in zip(fp.unpack_grads(packed), mlp.parameters()):
        assert a.shape == p.shape
        assert torch.equal(a, p.detach())


def test_band_weights_match_pallas_mask_rows():
    w3, wv = fp.band_weights(0.3, C2F, "cpu")
    ws3, wc3, wsv, wcv = jfp.pe_mask_rows(0.3, C2F)
    np.testing.assert_allclose(w3.numpy()[jfp._BAND3D[3:63]],
                               np.asarray(ws3 + wc3)[0, 3:63], rtol=1e-7)
    np.testing.assert_allclose(wv.numpy()[jfp._BANDV[3:27]],
                               np.asarray(wsv + wcv)[0, 3:27], rtol=1e-7)


def test_cpu_wrappers_run_plain_and_launch_nothing(setup):
    """On CPU tensors the wrappers run the plain version; the kernel
    launch counters do not move."""
    _, mlp, center, ray = setup
    n_train = fp.fused_render_rays_pe_train.launches
    n_fwd = fp.fused_render_rays_pe.launches
    n_bwd = fp.fused_render_rays_pe.backward_launches
    depth = torch.tensor(_exact_depth(3, 2, 3))
    target = torch.rand(2, 3, 3, generator=torch.Generator().manual_seed(0))
    c, r = torch.tensor(center), torch.tensor(ray)
    out, sq, n = fp.fused_render_rays_pe_train(mlp, c, r, depth, target)
    t8 = torch.cat([target.reshape(-1, 3), torch.ones(6, 1), torch.zeros(6, 4)], 1)
    sq_ref, out_ref = fp.render_rays_train_plain(mlp, c.reshape(-1, 3), r.reshape(-1, 3),
                                                 depth.reshape(6, 128), t8)
    assert torch.equal(sq, sq_ref) and n == 18.0
    assert torch.equal(out["rgb"].reshape(-1, 3), out_ref[:, :3].detach())
    with torch.no_grad():
        fp.fused_render_rays_pe(mlp, c, r, depth)
    c.requires_grad_(True)
    fp.fused_render_rays_pe(mlp, c, r, depth)[0].sum().backward()
    assert c.grad is not None
    assert fp.fused_render_rays_pe_train.launches == n_train
    assert fp.fused_render_rays_pe.launches == n_fwd
    assert fp.fused_render_rays_pe.backward_launches == n_bwd


@pytest.mark.parametrize("launch", ["fwd", "train", "bwd"])
def test_kernel_launchers_reject_cpu_tensors(setup, launch):
    """The launchers take CUDA tensors only; on CPU tensors they raise
    before any pointer reaches the kernel library."""
    _, mlp, _, _ = setup
    c, r, d = torch.zeros(2, 3), torch.ones(2, 3), torch.ones(2, 8)
    w3, wv = fp.band_weights(None, None, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        if launch == "fwd":
            fp.launch_rm_fwd(mlp, c, r, d, w3, wv)
        elif launch == "bwd":
            fp.launch_rm_bwd(mlp, c, r, d, torch.zeros(2, 8), w3, wv, torch.zeros(4),
                             fp.k2_weights(mlp))
        else:
            fp.launch_rm_train(mlp, c, r, d, torch.zeros(2, 8), w3, wv)


@pytest.mark.parametrize("R,K,match", [(2, fp.MAX_K + 1, "samples per ray"),
                                       (fp.MAX_SAMPLES // 128 + 1, 128, "samples per call")])
def test_kernel_launchers_reject_unsupported_shapes(setup, R, K, match):
    """Sample counts beyond the kernels' launch limits raise up front."""
    _, mlp, _, _ = setup
    c, r, d = torch.zeros(R, 3), torch.ones(R, 3), torch.empty(R, K)
    w3, wv = fp.band_weights(None, None, "cpu")
    with pytest.raises(ValueError, match=match):
        fp.launch_rm_fwd(mlp, c, r, d, w3, wv)
    with pytest.raises(ValueError, match=match):
        fp.launch_rm_bwd(mlp, c, r, d, torch.zeros(R, 8), w3, wv, torch.zeros(4),
                         fp.k2_weights(mlp))
    with pytest.raises(ValueError, match=match):
        fp.launch_rm_train(mlp, c, r, d, torch.zeros(R, 8), w3, wv)


class _FakeLibrary:
    """The kernel library's K3/K4 entry points on the CPU: each launch
    records the weight operands it receives; the outputs are zeros, and K4's
    weight gradients are the packed weights themselves, so that unpacking
    them must give back the parameters."""

    def __init__(self, mlp):
        self.packed = fp.pack_weights(mlp)
        self.calls = []

    def niw_rm_fwd_workspace_floats(self, n, keep):
        return 4

    def niw_rm_bwd_workspace_floats(self, n, r):
        return 4

    def niw_rm_fwd(self, center, ray, depth, R, K, w3, wv, W, W_split, w_lo, W_bf16, bf16,
                   activ, keep, out, ws, stream):
        assert W_bf16 is None and bf16 == 0   # float32
        self.calls.append(("fwd", W, W_split, w_lo, keep))
        ctypes.memset(out, 0, R * 8 * 4)
        return 0

    def niw_rm_bwd(self, center, ray, depth, g8, R, K, w3, wv, W_split, w_lo, W_bf16, bf16,
                   activ, cache, want_dw, dcenter, dray, dW, ws, stream):
        assert W_bf16 is None and bf16 == 0
        self.calls.append(("bwd", None, W_split, w_lo, want_dw))
        ctypes.memset(dcenter, 0, R * 3 * 4)
        ctypes.memset(dray, 0, R * 3 * 4)
        for i, w in enumerate(self.packed if want_dw else []):
            ctypes.memmove(dW[i], w.data_ptr(), w.numel() * 4)
        return 0


def test_k3_k4_take_the_k2_weights_cache_entry(monkeypatch):
    """K3 and K4 launch on ``k2_weights(mlp)``: K3 with its fp32 pointers
    and its split pointers, K4 with the split pointers of the same entry,
    which ``_RmFwd`` keeps for its backward; the entry stays while no
    parameter changes (a render or a refinement with frozen weights packs
    once), and an optimizer step makes a new one. K4's weight gradients are
    allocated in the packed layout and unpacked onto ``mlp.parameters()``.
    The library is a fake here, so only the operands are checked."""
    mlp = NerfMLP(ARCH)
    lib = _FakeLibrary(mlp)
    monkeypatch.setattr(fp.build, "load_library", lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(fp, "_check_inputs", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    R = 3
    c, r = torch.zeros(R, 3), torch.ones(R, 3)
    d = torch.linspace(1.0, 2.0, 128).expand(R, 128).contiguous()
    w3, wv = fp.band_weights(None, None, "cpu")
    packs = fp.fused_render_rays_pe_train.packs
    for _ in range(3):   # render chunks
        fp.launch_rm_fwd(mlp, c, r, d, w3, wv)
    first = fp.k2_weights(mlp)
    for p in mlp.parameters():
        p.requires_grad_(False)
    for _ in range(2):   # refinement iterations: K3 kept, K4 frozen
        c_t = c.clone().requires_grad_(True)
        fp._RmFwd.apply(c_t, r, d, w3, wv, mlp, "softplus", "float32",
                        *mlp.parameters()).sum().backward()
        assert torch.equal(c_t.grad, torch.zeros(R, 3))
    assert fp.fused_render_rays_pe_train.packs == packs + 1
    assert [call[0] for call in lib.calls] == ["fwd"] * 3 + ["fwd", "bwd"] * 2
    for kind, W, W_split, w_lo, flag in lib.calls:
        assert W_split is first.split_ptrs and w_lo == first.lo == fp.PLANE_FLOATS
        assert W is (first.ptrs if kind == "fwd" else None)
    assert [call[4] for call in lib.calls] == [0, 0, 0, 1, 0, 1, 0]
    for p in mlp.parameters():
        p.requires_grad_(True)
    opt = torch.optim.SGD(mlp.parameters(), lr=1e-3)
    fp._RmFwd.apply(c, r, d, w3, wv, mlp, "softplus", "float32",
                    *mlp.parameters()).sum().backward()
    assert lib.calls[-1][4] == 1
    for p, w in zip(mlp.parameters(), fp.unpack_grads(lib.packed)):
        assert torch.equal(p.grad, w)
    opt.step()
    fp.launch_rm_fwd(mlp, c, r, d, w3, wv)
    second = fp.k2_weights(mlp)
    assert second is not first and lib.calls[-1][2] is second.split_ptrs
    assert fp.fused_render_rays_pe_train.packs == packs + 2
