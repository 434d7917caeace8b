"""``tpu.compute_dtype: bfloat16`` on the CPU: the plain versions of the
port's K2, K3 and K4 (neural_invertible_warp_tpu_torch/ops/cuda/fused_pe.py,
the layer products through ``nerf_mlp``'s bf16 rounding) against the JAX
package's Pallas kernels in interpret mode with ``compute_dtype="bfloat16"``,
at the shapes of tests/test_torch_fused_pe.py (2 x 3 rays, K = 128, full
width, R_BLK = 2); the flagship system's step 0 in that mode against the
JAX system forced onto its kernel tier; and what the option refuses.

The semantics held: every operand of every layer product (the weights, the
activations, the PE and view features entering W0, W4 and Wr0, the
cotangents of both backward products) rounded to bf16 to nearest even,
products summed in fp32; positions, the PE, biases, activations and the
compositing unrounded.

Tolerances and why:
- XLA's CPU dot with bf16 operands and an f32 result sums in f32: within
  1e-6 of max of a float64 sum of the same rounded operands (a bf16
  accumulation would be ~1e-3 off); so JAX's interpret-mode kernels are a
  fair reference.
- Power-of-two depths (the points exact on both sides): the fp32 tests'
  gates of tests/test_torch_fused_pe.py (losses rtol 1e-5, values rtol
  1e-4, gradients rtol 5e-3 with atol 5e-6 of the leaf's max). Both sides
  then agree to ~1e-7 in relative L2: the same roundings, fp32 order noise
  only. The float64 rule of chip_smoke.py is held there too: each leaf no
  farther from a float64 evaluation of the same bf16 math (operands rounded
  to bf16 from their float64 values, sums in float64) than 1.5x the JAX
  kernel is.
- Realistic depths: the Pallas kernel may contract center + ray * depth
  into an FMA, so the points differ by an ulp, the finest PE band by up to
  2^9 pi ulps, and rounding the features to bf16 turns such a difference
  into 2^-8 of the element wherever it sits next to a rounding midpoint;
  summed over only 128 samples per ray (768 per weight) that does not
  average away. Losses rtol 1e-4, values relative L2 1e-3, every gradient
  leaf relative L2 5e-2 (measured up to 4.4e-2, on dcenter; the fp32 test
  holds weight leaves to 2e-2 and lets one ray's input gradient off).
- bf16 apart from fp32: at power-of-two depths the port's bf16 result lies
  ten times or more farther from its fp32 result than the gates allow
  (loss, rgb, W0's and dray's gradients), so that the option cannot be
  ignored unseen.
- Positions unrounded: with every PE band open, rounding the positions to
  bf16 instead of the features moves the finest band's features by O(1)
  and the render far outside the value gate.

The CUDA kernels themselves need the card: chip_smoke.py's phase 3b holds
them against these plain versions there, and its path flagship_bf16 trains
and evaluates the flagship in this mode.
"""

import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from neural_invertible_warp_tpu import config as jconfig
from neural_invertible_warp_tpu.dotdict import DotDict
from neural_invertible_warp_tpu.models import get_system_class as jax_system_class
from neural_invertible_warp_tpu.models import system as jsystem_mod
from neural_invertible_warp_tpu.ops import lie as jlie
from neural_invertible_warp_tpu.ops import nerf_mlp as jmlp
from neural_invertible_warp_tpu.ops import sampling as jsampling
from neural_invertible_warp_tpu.ops.pallas import fused_pe as jfp
from neural_invertible_warp_tpu_torch import config
from neural_invertible_warp_tpu_torch.dotdict import DotDict as PDotDict
from neural_invertible_warp_tpu_torch.models import get_system_class
from neural_invertible_warp_tpu_torch.ops import nerf_mlp, render
from neural_invertible_warp_tpu_torch.ops.cuda import fused_field as ff
from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
from neural_invertible_warp_tpu_torch.ops.nerf_mlp import NerfMLP, round_bf16
from neural_invertible_warp_tpu_torch.utils import weights

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

ARCH = DotDict(dict(
    layers_feat=[None, 256, 256, 256, 256, 256, 256, 256, 256],
    layers_rgb=[None, 128, 3], skip=[4], posenc=dict(L_3D=10, L_view=4),
    density_activ="softplus", tf_init=True))
C2F, PROGRESS = (0.1, 0.5), 0.4
BF16 = "bfloat16"
TOL_LOSS = 1e-4
TOL_VALUE_REL_L2 = 1e-3
TOL_GRAD_REL_L2 = 5e-2
TOL_BF16_VS_F64 = 1.5
# power-of-two depths: tests/test_torch_fused_pe.py's gates
EXACT = dict(loss=1e-5, value_rtol=1e-4, value_atol=1e-6, grad_rtol=5e-3, grad_atol=5e-6)


@pytest.fixture(scope="module")
def setup():
    params = jmlp.init_nerf_params(jax.random.PRNGKey(0), ARCH)
    mlp = NerfMLP(ARCH)
    mlp.load_state_dict(weights.nerf_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.RandomState(0)
    center = rng.randn(2, 3, 3).astype(np.float32) * 0.2
    ray = rng.randn(2, 3, 3).astype(np.float32)
    return params, mlp, copy.deepcopy(mlp).double(), center, ray


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setattr(jfp, "R_BLK", 2)


def _depth(kind, seed, n_img=2):
    rng = np.random.RandomState(seed)
    if kind == "exact":   # power-of-two depths: the points are exact on both sides
        d = np.sort(rng.choice([0.5, 1.0, 2.0, 4.0], (n_img, 3, 128)), axis=-1)[..., None]
    else:
        d = np.sort(rng.rand(n_img, 3, 128, 1), axis=2) * 3 + 1
    return d.astype(np.float32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _dist(a, ref64):
    """Largest distance from the float64 evaluation, as a share of its max."""
    ref64 = np.asarray(ref64, np.float64)
    return np.abs(np.asarray(a, np.float64) - ref64).max() / np.abs(ref64).max()


def _hold(name, kind, port, jax_, f64):
    """A gradient leaf of the port's bf16 plain version against JAX's: at
    power-of-two depths to EXACT's gates and the float64 rule, else to
    relative L2 TOL_GRAD_REL_L2."""
    port, jax_ = np.asarray(port), np.asarray(jax_)
    assert np.isfinite(port).all() and np.abs(jax_).max() > 0, name
    if kind == "exact":
        np.testing.assert_allclose(port, jax_, rtol=EXACT["grad_rtol"],
                                   atol=EXACT["grad_atol"] * np.abs(jax_).max(), err_msg=name)
        assert _dist(port, f64) <= TOL_BF16_VS_F64 * _dist(jax_, f64), (
            name, _dist(port, f64), _dist(jax_, f64))
    else:
        assert _rel_l2(port, jax_) < TOL_GRAD_REL_L2, (name, _rel_l2(port, jax_))


def _hold_values(name, kind, port, jax_):
    port, jax_ = np.asarray(port), np.asarray(jax_)
    if kind == "exact":
        np.testing.assert_allclose(port, jax_, rtol=EXACT["value_rtol"],
                                   atol=EXACT["value_atol"], err_msg=name)
    else:
        assert _rel_l2(port, jax_) < TOL_VALUE_REL_L2, (name, _rel_l2(port, jax_))


def _apart(a, b, tol):
    """The largest difference of a from b beyond ten times tol of b's max."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() > 10 * tol * np.abs(b).max()


def _f64_render(mlp64, center, ray, depth, progress, c2f, compute_dtype=BF16):
    """(rgb, depth, opacity) of the field after the points in float64: the
    points in fp32 as both kernels form them, the PE and everything after it
    in float64, each layer product's operands rounded to bf16 from their
    float64 values."""
    points, ray_unit = nerf_mlp.sample_points(center, ray, depth)
    rgb_s, dens = mlp64(points.double(), ray_unit.double(), progress=progress,
                        barf_c2f=c2f, compute_dtype=compute_dtype)
    rgb, d, op, _ = render.composite(ray.double(), rgb_s, dens, depth.double())
    return rgb, d, op


def _grads64(mlp64, outputs, wrt_inputs, cotangents):
    mlp64.zero_grad()
    grads = torch.autograd.grad(outputs, wrt_inputs + list(mlp64.parameters()), cotangents)
    g_w = weights.nerf_to_jax(mlp64, get=dict(zip(mlp64.parameters(), grads[2:])).__getitem__)
    return [g.numpy() for g in grads[:2]] + [np.asarray(x) for x in jax.tree_util.tree_leaves(g_w)]


# ------------------------------------------------------------- references

def test_xla_bf16_dot_sums_in_f32():
    """XLA's CPU dot on bf16 operands with preferred_element_type=f32 (what
    the kernels' _dot computes in interpret mode) sums in f32: it equals a
    float64 sum of the same rounded operands to 1e-6 of max, as an fp32
    product of the rounded operands does, while a bf16 result is ~1e-3 off."""
    rng = np.random.RandomState(0)
    x = rng.randn(512, 256).astype(np.float32)
    w = (rng.randn(256, 256) * 0.06).astype(np.float32)
    xb, wb = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16)
    got = np.asarray(jnp.dot(xb, wb, preferred_element_type=jnp.float32))
    ref = (round_bf16(torch.tensor(x).double()) @ round_bf16(torch.tensor(w).double())).numpy()
    port = (round_bf16(torch.tensor(x)) @ round_bf16(torch.tensor(w))).numpy()
    in_bf16 = np.asarray(jnp.dot(xb, wb)).astype(np.float32)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 1e-6
    assert np.abs(port - ref).max() / scale < 1e-6
    assert np.abs(in_bf16 - ref).max() / scale > 1e-4


def test_round_bf16_is_round_to_nearest_even():
    """round_bf16: PyTorch's (and JAX's) cast for fp32; float64 rounded once,
    from its own value; ties to the even neighbour; a truncating conversion
    would differ in about half of all values."""
    x = torch.randn(100000, generator=torch.Generator().manual_seed(0)) * 10
    assert torch.equal(round_bf16(x), x.to(torch.bfloat16).float())
    assert np.array_equal(round_bf16(x).numpy(),
                          np.asarray(jnp.asarray(x.numpy()).astype(jnp.bfloat16)
                                     .astype(jnp.float32)))
    assert torch.equal(round_bf16(x.double()), round_bf16(x).double())
    ties = torch.tensor([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8)],
                        dtype=torch.float64)
    assert round_bf16(ties).tolist() == [1.0, 1 + 2.0 ** -6, -1.0]
    assert torch.equal(round_bf16(ties.float()), round_bf16(ties).float())
    # a float64 value just above a tie rounds up; through fp32 it would tie
    above = torch.tensor([1 + 2.0 ** -8 + 2.0 ** -40], dtype=torch.float64)
    assert round_bf16(above).item() == 1 + 2.0 ** -7
    truncated = (x.view(torch.int32) & -0x10000).view(torch.float32)
    share = float((truncated != round_bf16(x)).float().mean())
    assert 0.4 < share < 0.6


# ------------------------------------------------------------------ K2

@functools.partial(jax.jit, static_argnums=5)
@functools.partial(jax.value_and_grad, argnums=(0, 1, 2), has_aux=True)
def _jax_train_loss(params, center, ray, depth, target, compute_dtype):
    out, sq, n = jfp.fused_render_rays_pe_train(
        params, ARCH, center, ray, depth, target, progress=PROGRESS, barf_c2f=C2F,
        interpret=True, compute_dtype=compute_dtype)
    return sq / n, out


def _jax_train(params, center, ray, depth, target, compute_dtype):
    (l, out), g = _jax_train_loss(params, *(jnp.asarray(x) for x in (center, ray, depth, target)),
                                  compute_dtype)
    return float(l), out, [np.asarray(g[1]), np.asarray(g[2])] + [
        np.asarray(x) for x in jax.tree_util.tree_leaves(g[0])]


def _port_train(mlp, center, ray, depth, target, compute_dtype):
    mlp.zero_grad()
    c = torch.tensor(center, requires_grad=True)
    r = torch.tensor(ray, requires_grad=True)
    out, sq, n = fp.fused_render_rays_pe_train(
        mlp, c, r, torch.tensor(depth), torch.tensor(target), progress=PROGRESS,
        barf_c2f=C2F, compute_dtype=compute_dtype)
    (sq / n).backward()
    g_w = weights.nerf_to_jax(mlp, get=lambda p: p.grad)
    return float(sq.detach() / n), out, [c.grad.numpy(), r.grad.numpy()] + [
        np.asarray(x) for x in jax.tree_util.tree_leaves(g_w)]


def _f64_train(mlp64, center, ray, depth, target):
    c = torch.tensor(center, requires_grad=True)
    r = torch.tensor(ray, requires_grad=True)
    rgb, _, _ = _f64_render(mlp64, c, r, torch.tensor(depth), PROGRESS, C2F)
    # the gradients of the squared error's sum, scaled afterwards, as K2 and
    # the JAX kernel take them (_PlainTrain)
    sq = torch.sum((rgb - torch.tensor(target).double()) ** 2)
    return [g / rgb.numel() for g in _grads64(mlp64, sq, [c, r], None)]


@pytest.mark.parametrize("kind", ["exact", "realistic"])
def test_k2_bf16_plain_matches_pallas(setup, small_blocks, kind):
    """K2's plain version under bfloat16 against the Pallas train kernel in
    that mode: loss, render, dcenter, dray and all 20 weight gradients; then
    apart from the fp32 result."""
    params, mlp, mlp64, center, ray = setup
    depth = _depth(kind, 7)
    target = np.random.RandomState(7).rand(2, 3, 3).astype(np.float32)
    l_j, out_j, g_j = _jax_train(params, center, ray, depth, target, BF16)
    l_t, out_t, g_t = _port_train(mlp, center, ray, depth, target, BF16)
    g_64 = _f64_train(mlp64, center, ray, depth, target)
    assert abs(l_t - l_j) <= (EXACT["loss"] if kind == "exact" else TOL_LOSS) * l_j
    for k in ("rgb", "depth", "opacity"):
        _hold_values(k, kind, out_t[k].numpy(), out_j[k])
    assert len(g_t) == len(g_j) == 22
    for i, (a, b, c) in enumerate(zip(g_t, g_j, g_64)):
        _hold("K2 leaf {}".format(i), kind, a, b, c)
    if kind == "exact":   # the fp32 result lies beyond those gates
        l_32, out_32, g_32 = _port_train(mlp, center, ray, depth, target, "float32")
        assert abs(l_t - l_32) > 10 * EXACT["loss"] * l_32
        assert _apart(out_t["rgb"].numpy(), out_32["rgb"].numpy(), EXACT["value_rtol"])
        assert _apart(g_t[2], g_32[2], EXACT["grad_rtol"])     # W0


# ---------------------------------------------------------------- K3, K4

@pytest.mark.parametrize("kind", ["exact", "realistic"])
def test_k3_bf16_plain_matches_pallas(setup, small_blocks, kind):
    """K3's plain version under bfloat16 against the Pallas forward kernel in
    that mode; apart from the fp32 render."""
    params, mlp, _, center, ray = setup
    depth = _depth(kind, 5)
    ref = jfp.fused_render_rays_pe(params, ARCH, jnp.asarray(center), jnp.asarray(ray),
                                   jnp.asarray(depth), progress=PROGRESS, barf_c2f=C2F,
                                   interpret=True, compute_dtype=BF16)
    c, r, d = torch.tensor(center), torch.tensor(ray), torch.tensor(depth)
    with torch.no_grad():
        got = fp.fused_render_rays_pe(mlp, c, r, d, progress=PROGRESS, barf_c2f=C2F,
                                      compute_dtype=BF16)
        got_32 = fp.fused_render_rays_pe(mlp, c, r, d, progress=PROGRESS, barf_c2f=C2F)
    for name, a, b in zip(("rgb", "depth", "opacity"), got, ref):
        _hold_values(name, kind, a.numpy(), b)
    if kind == "exact":
        assert _apart(got[0].numpy(), got_32[0].numpy(), EXACT["value_rtol"])


@jax.jit
def _jax_k4(params, center, ray, depth, cot):
    """The Pallas backward kernel in bfloat16: jax.vjp of fused_render_rays_pe
    at the cotangent cot (rgb, depth, opacity), with a background colour."""
    _, vjp = jax.vjp(
        lambda p, c, r: jfp.fused_render_rays_pe(
            p, ARCH, c, r, depth, interpret=True, compute_dtype=BF16, progress=PROGRESS,
            barf_c2f=C2F, setbg_opaque=True, bgcolor=1.0),
        params, center, ray)
    return vjp(cot)


@pytest.mark.parametrize("kind", ["exact", "realistic"])
def test_k4_bf16_plain_matches_pallas(setup, small_blocks, kind):
    """K4's plain version (autograd through the CPU wrapper in bfloat16)
    against the Pallas backward kernel in that mode (jax.vjp of
    fused_render_rays_pe), for a cotangent on rgb, depth and opacity, with a
    background colour: dcenter, dray and all 20 weight leaves."""
    params, mlp, mlp64, center, ray = setup
    depth = _depth(kind, 13)
    rng = np.random.RandomState(13)
    cot = [rng.randn(2, 3, 3).astype(np.float32),
           (rng.randn(2, 3, 1) * 0.1).astype(np.float32),
           rng.randn(2, 3, 1).astype(np.float32)]
    kw = dict(progress=PROGRESS, barf_c2f=C2F, setbg_opaque=True, bgcolor=1.0)
    g_j = _jax_k4(params, *(jnp.asarray(x) for x in (center, ray, depth)),
                  tuple(jnp.asarray(x) for x in cot))
    g_j = [np.asarray(g_j[1]), np.asarray(g_j[2])] + [
        np.asarray(x) for x in jax.tree_util.tree_leaves(g_j[0])]

    def port(compute_dtype):
        c_t = torch.tensor(center, requires_grad=True)
        r_t = torch.tensor(ray, requires_grad=True)
        out = fp.fused_render_rays_pe(mlp, c_t, r_t, torch.tensor(depth),
                                      compute_dtype=compute_dtype, **kw)
        grads = torch.autograd.grad(out, [c_t, r_t] + list(mlp.parameters()),
                                    [torch.tensor(x) for x in cot])
        g_w = weights.nerf_to_jax(mlp, get=dict(zip(mlp.parameters(), grads[2:])).__getitem__)
        return [g.numpy() for g in grads[:2]] + [
            np.asarray(x) for x in jax.tree_util.tree_leaves(g_w)]
    g_t = port(BF16)
    c64 = torch.tensor(center, dtype=torch.float64, requires_grad=True)
    r64 = torch.tensor(ray, dtype=torch.float64, requires_grad=True)
    rgb, d, op = _f64_render(mlp64, c64.float(), r64.float(), torch.tensor(depth), PROGRESS,
                             C2F)
    rgb = rgb + 1.0 * (1 - op)
    g_64 = _grads64(mlp64, [rgb, d, op], [c64, r64],
                    [torch.tensor(x).double() for x in cot])
    assert len(g_t) == len(g_j) == 22
    for i, (a, b, c) in enumerate(zip(g_t, g_j, g_64)):
        _hold("K4 leaf {}".format(i), kind, a, b, c)
    if kind == "exact":
        assert _apart(g_t[1], port("float32")[1], EXACT["grad_rtol"])     # dray


def test_positions_are_not_rounded(setup, small_blocks, monkeypatch):
    """With every PE band open (progress 1), the bf16 render rounds the PE
    features, not the positions: rounding the positions to bf16 before the
    PE moves the finest band's features by O(1) (2^9 pi times a position
    error of up to 2^-9 of it) and the render far outside the gate the
    port meets against the JAX kernel."""
    params, mlp, _, center, ray = setup
    depth = _depth("realistic", 21)
    ref = np.asarray(jfp.fused_render_rays_pe(
        params, ARCH, jnp.asarray(center), jnp.asarray(ray), jnp.asarray(depth),
        progress=1.0, barf_c2f=C2F, interpret=True, compute_dtype=BF16)[0])
    c, r, d = torch.tensor(center), torch.tensor(ray), torch.tensor(depth)

    def render_rgb():
        with torch.no_grad():
            return fp.fused_render_rays_pe(mlp, c, r, d, progress=1.0, barf_c2f=C2F,
                                           compute_dtype=BF16)[0].numpy()
    err = _rel_l2(render_rgb(), ref)
    points, ray_unit = nerf_mlp.sample_points(c, r, d)
    feat = mlp.encode(points, ray_unit, 1.0, C2F)[0]
    feat_rounded = mlp.encode(round_bf16(points), ray_unit, 1.0, C2F)[0]
    finest = [3 + dim * 20 + k for dim in range(3) for k in (9, 19)]   # sin, cos of band 9
    assert float((feat - feat_rounded)[..., finest].abs().max()) > 0.5

    def rounded_positions(field, center, ray, depth, **kw):
        points, ray_unit = nerf_mlp.sample_points(center, ray, depth)
        return field(round_bf16(points), ray_unit, **kw)
    monkeypatch.setattr(fp, "apply_nerf_samples", rounded_positions)
    err_rounded = _rel_l2(render_rgb(), ref)
    assert err < TOL_VALUE_REL_L2 < err_rounded and err_rounded > 10 * err, (err, err_rounded)


# ----------------------------------------------------- weights and options

def test_weight_cache_is_keyed_by_compute_dtype(setup):
    """k2_weights keeps one entry per compute dtype: the bfloat16 entry's
    planes add the bf16 plane (the packed weights, leading dimensions
    rounded up to 8, rounded to nearest even) after the fp32 rows and tail,
    and its bf16 pointers point into it; each entry is reused while no
    parameter changes, and an optimizer step makes both anew."""
    mlp = copy.deepcopy(setup[1])
    packs = fp.fused_render_rays_pe_train.packs
    f32, bf = fp.k2_weights(mlp), fp.k2_weights(mlp, BF16)
    assert f32 is not bf and fp.k2_weights(mlp) is f32 and fp.k2_weights(mlp, BF16) is bf
    assert fp.fused_render_rays_pe_train.packs == packs + 2
    assert f32.bf16 == 0 and f32.bf16_ptrs is None and bf.bf16 == 1
    n32 = 3 * fp.PLANE_FLOATS + fp.PLANES_TAIL
    assert f32.planes.numel() == n32 == fp.planes_floats()
    assert bf.planes.numel() == fp.BF16_BASE + fp.PLANE_HALVES // 2 == fp.planes_floats(BF16)
    assert torch.equal(bf.planes[:n32], f32.planes)
    assert not torch.any(bf.planes[n32:fp.BF16_BASE])
    halves = bf.planes[fp.BF16_BASE:].view(torch.bfloat16)
    base = bf.planes.data_ptr() + 4 * fp.BF16_BASE
    for i, (w, off) in enumerate(zip(fp.pack_weights(mlp)[:fp.N_SPLIT], fp.BF16_OFFSETS)):
        n_in, n_out = w.shape
        ld = -(-n_out // 8) * 8
        plane = halves[off:off + n_in * ld].view(n_in, ld)
        assert torch.equal(plane[:, :n_out], w.to(torch.bfloat16))
        assert not torch.any(plane[:, n_out:].float())
        assert bf.bf16_ptrs[i] == base + 2 * off and base % 16 == 0 and (2 * off) % 16 == 0
    for slot in range(fp.N_SPLIT, 20):   # Wr1 and the biases: as the fp32 products read them
        assert bf.bf16_ptrs[slot] == bf.ptrs[slot]
    opt = torch.optim.SGD(mlp.parameters(), lr=1e-3)
    sum(p.sum() for p in mlp.parameters()).backward()
    opt.step()
    assert fp.k2_weights(mlp, BF16) is not bf and fp.k2_weights(mlp) is not f32
    assert fp.fused_render_rays_pe_train.packs == packs + 4


def test_unknown_compute_dtype_raises(setup):
    _, mlp, _, center, ray = setup
    for value in ("float16", "bf16"):
        with pytest.raises(ValueError, match="tpu.compute_dtype"):
            fp.resolve_compute_dtype(value)
        with pytest.raises(ValueError, match="tpu.compute_dtype"):
            fp.fused_render_rays_pe(mlp, torch.tensor(center), torch.tensor(ray),
                                    torch.tensor(_depth("exact", 1)), compute_dtype=value)
    assert fp.resolve_compute_dtype(None) == "float32"


def _system_options(extra, out):
    opt = config.set_options(
        ["--model=barf_inn_llff", "--yaml=barf_inn_llff", "--output_root={}".format(out),
         "--data.root={}".format(out)] + extra, makedirs=False)
    return opt


# (label, flags): every tier that would reach K5 or K1 under bfloat16
REFUSED = [
    ("fine sampling", ["--nerf.fine_sampling"]),
    ("fused_raymarch off", ["--tpu.fused_raymarch!"]),
    ("noise outside K2", ["--tpu.fused_train!", "--nerf.density_noise_reg=1.0"]),
    ("MLP-only tier", ["--tpu.fused_pe!"]),
]


@pytest.mark.parametrize("label,extra", REFUSED, ids=[r[0].replace(" ", "_") for r in REFUSED])
def test_k5_k1_tiers_refuse_bf16_before_the_first_step(label, extra, tmp_path):
    """A configuration whose train step or render reaches K5 or K1 (no bf16
    variant) raises NotImplementedError naming the option in init_state,
    before anything is built; in fp32 it starts."""
    opt = _system_options(["--tpu.compute_dtype=bfloat16"] + extra, tmp_path)
    system = get_system_class(opt.model)(opt, "cpu")
    with pytest.raises(NotImplementedError, match="tpu.compute_dtype"):
        system.init_state(0)
    assert system.graph is None and system.step == 0
    opt32 = _system_options(extra, tmp_path)
    get_system_class(opt32.model)(opt32, "cpu").check_kernel_options()


def test_option_reaches_the_system_from_the_cli(tmp_path):
    """--tpu.compute_dtype=bfloat16 arrives as the string "bfloat16"; the
    plain chain ignores it; an unknown value raises ValueError; K5's and
    K1's wrappers refuse bfloat16 themselves."""
    opt = _system_options(["--tpu.compute_dtype=bfloat16"], tmp_path)
    assert opt.tpu.compute_dtype == "bfloat16" and type(opt.tpu.compute_dtype) is str
    system = get_system_class(opt.model)(opt, "cpu")
    assert system.kernel_compute_dtype() == BF16
    plain = _system_options(["--tpu.compute_dtype=bfloat16", "--tpu.fused_pe!",
                             "--tpu.fused_kernel!"], tmp_path)
    system = get_system_class(plain.model)(plain, "cpu")
    assert system.kernel_compute_dtype() == "float32"
    system.check_kernel_options()
    bad = _system_options(["--tpu.compute_dtype=float16"], tmp_path)
    with pytest.raises(ValueError, match="tpu.compute_dtype"):
        get_system_class(bad.model)(bad, "cpu").init_state(0)
    mlp = NerfMLP(ARCH)
    c, r = torch.zeros(1, 2, 3), torch.ones(1, 2, 3)
    d = torch.linspace(1.0, 2.0, 8).expand(1, 2, 8)[..., None].contiguous()
    with pytest.raises(NotImplementedError, match="K5"):
        fp.fused_apply_nerf_samples_pe(mlp, c, r, d, compute_dtype=BF16)
    with pytest.raises(NotImplementedError, match="K1"):
        ff.fused_apply_nerf_samples(mlp, c, r, d, compute_dtype=BF16)


# ------------------------------------------------------ the system, step 0

H = W = 8
N_IMG = 2
# the field at full width (K2 covers only the reference architecture), the
# INN warp narrowed as tests/test_torch_train_step.py narrows it
SYSTEM_OVERRIDES = ["--model=barf_inn_llff", "--yaml=barf_inn_llff", "--barf_c2f=[0.1,0.5]",
                    "--data.image_size=[8,8]", "--nerf.sample_intvs=16", "--nerf.rand_rays=8",
                    "--inn.real_nvp.d_hidden=16", "--warp_latent.embed_dim=8", "--max_iter=8",
                    "--tpu.compute_dtype=bfloat16"]


def _arrays(n, seed):
    rng = np.random.RandomState(seed)
    f = 0.5 * W / np.tan(0.4)
    R = np.asarray(jlie.so3_to_SO3(jnp.asarray(rng.randn(n, 3) * 0.02, jnp.float32)))
    pose = np.concatenate([R, rng.randn(n, 3, 1) * 0.05], -1)
    return dict(image=rng.rand(n, H, W, 3).astype(np.float32),
                intr=np.tile(np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32),
                             (n, 1, 1)),
                pose=pose.astype(np.float32), idx=np.arange(n, dtype=np.int32))


def test_flagship_step0_under_bf16_matches_the_jax_kernel_tier(tmp_path, monkeypatch):
    """barf_inn_llff at full width (8x256 field, INN warp) under bfloat16:
    the port's step 0 (K2's plain version in that mode) against the JAX
    system on its kernel tier (the one-call train kernel in interpret mode,
    compute_dtype bfloat16), at step 2 so that the c2f bands are partly
    open, on the JAX step's own draws: losses rtol 1e-4, every gradient
    leaf to relative L2 2e-2 (the field's, for the reason above; the warp's
    and the pose's follow the rays through the same gradients), then one
    Adam step: parameters to 1e-6 where the gradient is above 1e-2 of the
    leaf's largest entry (Adam's first update is about lr * sign(g), and a
    bf16 gradient below that share can change sign), to 2 lr elsewhere."""
    monkeypatch.setattr(jfp, "fused_render_rays_pe_train",
                        functools.partial(jfp.fused_render_rays_pe_train, interpret=True))
    monkeypatch.setattr(jsystem_mod.NerfSystem, "_use_fused_field", lambda self: "pe")
    opt = jconfig.load_options("options/barf_inn_llff.yaml")
    opt = jconfig.override_options(opt, jconfig.parse_arguments(SYSTEM_OVERRIDES),
                                   key_stack=[], safe_check=True)
    opt.H, opt.W, opt.output_path = H, W, str(tmp_path / "jax")
    jsys = jax_system_class("barf_inn_llff")(opt)
    train, test = _arrays(N_IMG, 0), _arrays(1, 1)
    jsys.attach_data(train, test)
    state = dict(jax.jit(jsys.init_state)(jax.random.PRNGKey(0)), step=jnp.int32(2))
    popt = PDotDict(opt.to_plain())
    popt.output_path = str(tmp_path / "port")
    psys = get_system_class("barf_inn_llff")(popt, "cpu")
    psys.attach_data(train, test)
    psys.init_state(0)
    params = jax.tree_util.tree_map(np.asarray, state["params"])
    psys.graph.load_state_dict(weights.from_jax_params(params))
    psys.step = 2
    psys.aux["global_rigid"] = torch.tensor(np.asarray(state["aux"]["global_rigid"]))
    assert psys.kernel_compute_dtype() == BF16

    n_rays, K = opt.nerf.rand_rays // N_IMG, opt.nerf.sample_intvs
    key = jax.random.PRNGKey(42)
    k_perm, k_render = jax.random.split(key)
    k_depth, _ = jax.random.split(k_render)
    depth_rand = np.asarray(jax.random.uniform(k_depth, (N_IMG, n_rays, K, 1)))
    ray_idx = jsampling.sample_ray_subset(k_perm, H * W, n_rays, mode="stratified")

    def loss_fn(params):
        out, target, extras = jsys._forward_train(params, state["aux"], jsys.train_data,
                                                  ray_idx, k_render, state["step"])
        losses = jsys.compute_loss(params, state["aux"], jsys.train_data, out, target,
                                   state["step"], extras)
        return jsys.summarize_loss(losses), (losses, out)
    (total_j, (losses_j, out_j)), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state["params"])
    assert "render_sq_sum" in out_j   # the one-call train kernel ran
    @jax.jit
    def adam_step(g, opt_state, params):
        return optax.apply_updates(params, jsys.tx.update(g, opt_state, params)[0])
    params_j = adam_step(g_j, state["opt_state"], state["params"])

    psys.optim.zero_grad()
    out, target, extras = psys._forward_train(torch.from_numpy(np.array(ray_idx)).long(),
                                              psys.step, torch.tensor(depth_rand))
    losses_t = psys.compute_loss(out, target, extras)
    total_t = psys.summarize_loss(losses_t)
    total_t.backward()
    for k in losses_j:
        np.testing.assert_allclose(float(losses_t[k].detach()), float(losses_j[k]),
                                   rtol=TOL_LOSS, atol=1e-12, err_msg=k)
    g_t = weights.to_jax_params(psys.graph, get=lambda p: p.grad)
    psys.optim.step()
    p_t = weights.to_jax_params(psys.graph)
    leaves = list(zip(jax.tree_util.tree_leaves_with_path(g_j), jax.tree_util.tree_leaves(g_t),
                      jax.tree_util.tree_leaves(params_j), jax.tree_util.tree_leaves(p_t)))
    assert len(leaves) > 30
    lr = opt.optim.lr
    for (path, gj), gt, pj, pt in leaves:
        name, gj, pj = jax.tree_util.keystr(path), np.asarray(gj), np.asarray(pj)
        if not np.abs(gj).max() > 0:
            assert not np.abs(gt).max() > 0, name
            continue
        assert _rel_l2(gt, gj) < TOL_GRAD_REL_L2, (name, _rel_l2(gt, gj))
        small = np.abs(gj) < 1e-2 * np.abs(gj).max()
        err = np.abs(pt - pj)
        assert np.all(err[~small] <= 1e-6 + 1e-5 * np.abs(pj[~small])), name
        assert np.all(err[small] <= 2 * lr + 1e-6), name
