"""The split-fp32 (3xTF32) product of the tensor-core GEMM of K2, K3 and K4
(neural_invertible_warp_tpu_torch/csrc/gemm_tc.cuh), emulated on the CPU.

``split_tf32`` is the plain version of the kernel's operand split. The
emulation rounds both operands of a layer product to a TF32 hi and lo part
and sums lo*hi + hi*lo + hi*hi in fp32, as the kernel does. K2 takes it in
its backward's products (input and weight gradients) and keeps its forward
products in fp32; the rgb output layer (128 -> 3) is fp32 in K2's
compositing kernel. At full width (8 x 256 trunk, 128 head) on a small ray
batch, K2's scheme must meet the gates that chip_smoke.py applies to K2
against the fp32 plain chain: 1e-5 of the max for the render, sq_sum and
the weight gradients, and for dcenter/dray with PE bands 5-9 closed; 5e-4
for dcenter/dray with all ten bands open (chip_smoke.py,
TOL_INPUT_GRAD_ALL_BANDS). Single-pass TF32 in the same products must miss
the gradient gates: the gates tell the two schemes apart.

The split product in the forward too holds the gates only with the sign of
each layer output held to the fp32 chain's: a pre-activation within
rounding of 0 (a ReLU decision that two fp32-class evaluations take
differently) moves a sample's gradient by a finite amount, and the
correctly rounded fp32 product shows it as well (printed). With the signs
held, the scheme meets every gate there too, and single-pass TF32 misses
the value gate. Each evaluation's distance from a float64 one (the points
and the PE's sin/cos in fp32, as chip_smoke.py's k2_f64 takes them) is
printed.

K3's render (no backward reads it) takes the split product in every forward
product, signs free: rgb, depth and opacity must meet chip_smoke.py's value
gate, and single-pass TF32 there must miss it. K4 takes K2's scheme (an
fp32 forward, split input-gradient and weight-gradient products) under
chip_smoke.py's K4 test loss, signed per-ray coefficients on rgb, depth and
opacity: dcenter/dray must meet their gates and the weight gradients
TOL_K4_WEIGHT_GRAD, with the weights frozen and with weight gradients, and
single-pass TF32 must miss them.

K5 and K1, the per-sample field kernels of the fine model, take the same
two routes, at a fine-sampling shape (32 rays x 64 samples, depths in
[0,1], all ten PE bands open, the compositing in PyTorch): their render
forward (no autograd) every product split, signs free, held to the value
gate on per-sample rgb and density (single-pass TF32 must miss it); under
autograd an fp32 forward and every backward product split, held to
chip_smoke.py's field gates under its signed test loss, with and without
density noise, for K5's dcenter/dray and K1's dxp/dview alike (K1's PE in
PyTorch is the same fp32 chain as K5's in-kernel PE).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neural_invertible_warp_tpu_torch.flagship import flagship_options
from neural_invertible_warp_tpu_torch.ops import nerf_mlp, render
from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
from neural_invertible_warp_tpu_torch.ops.nerf_mlp import NerfMLP

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

B, R, K = 2, 16, 128
C2F = (0.1, 0.5)
TOL = 1e-5                 # chip_smoke.py: TOL["value"], TOL["grad"]
TOL_ALL_BANDS = 5e-4       # chip_smoke.py: TOL_INPUT_GRAD_ALL_BANDS
TOL_K4_WEIGHT_GRAD = 5e-5  # chip_smoke.py: TOL_K4_WEIGHT_GRAD
K4_DEPTH_COEFF = 0.01      # chip_smoke.py: K4_DEPTH_COEFF
FINE_R, FINE_K = 32, 64    # a fine-sampling chunk cut to 32 rays
TOL_FIELD_INPUT_GRAD = 5e-5  # chip_smoke.py: TOL_FIELD_INPUT_GRAD
TOL_RELU_REL_L2 = 1e-2     # chip_smoke.py: TOL_RELU_REL_L2
NOISE_REG = 1.0            # chip_smoke.py: NOISE_REG


def _low_bits(x):
    return x.view(torch.int32) & 0x1FFF


def test_split_tf32_parts():
    rng = np.random.RandomState(0)
    w = torch.tensor(np.concatenate([
        rng.randn(4096) * 10.0 ** rng.uniform(-30, 30, 4096),
        [0.0, -0.0, 1.0, -3.0, 1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11]]),
        dtype=torch.float32)
    hi, lo = fp.split_tf32(w)
    assert not torch.any(_low_bits(hi)) and not torch.any(_low_bits(lo))
    # hi: w to nearest TF32 (half a TF32 ulp), ties away from zero
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-38))) - 10)
    assert torch.all((w - hi).abs() <= 0.5 * ulp)
    assert hi[-3].item() == 1 + 2.0 ** -10 and hi[-2].item() == -(1 + 2.0 ** -10)
    assert hi[-1].item() == 1 + 2.0 ** -9
    # w - hi is exact in fp32; lo is it rounded to TF32
    rest = (w - hi).double()
    assert torch.all((rest - lo.double()).abs() <= 2.0 ** -11 * rest.abs())
    assert torch.all((w.double() - hi.double() - lo.double()).abs()
                     <= 2.0 ** -22 * w.double().abs())


def _mm_3xtf32(a, b):
    a_hi, a_lo = fp.split_tf32(a)
    b_hi, b_lo = fp.split_tf32(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mm_tf32(a, b):
    return fp.split_tf32(a)[0] @ fp.split_tf32(b)[0]


def _mm_fp32(a, b):
    return a @ b


class _EmulatedLinear(torch.autograd.Function):
    """x @ w.T + b with the product ``fwd`` in the forward and ``bwd`` in
    the input gradient and the weight gradient (whose reduction runs over
    samples), or ``bwd_w`` in the weight gradient where it is given."""

    @staticmethod
    def forward(ctx, x, w, b, fwd, bwd, bwd_w=None):
        ctx.save_for_backward(x, w)
        ctx.bwd, ctx.bwd_w = bwd, bwd_w or bwd
        x2 = x.reshape(-1, x.shape[-1])
        return (fwd(x2, w.t()) + b).reshape(x.shape[:-1] + (w.shape[0],))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        dw = ctx.bwd_w(x2.t(), g2).t() if ctx.needs_input_grad[1] else None
        db = g2.sum(0) if ctx.needs_input_grad[2] else None
        return ctx.bwd(g2, w).reshape(x.shape), dw, db, None, None, None


class _HoldSigns(torch.autograd.Function):
    """y with each value on the other side of 0 than ``positive`` says set
    to 1e-30 or 0; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, y, positive):
        return torch.where(positive, y.clamp(min=1e-30), y.clamp(max=0.0))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _flagship_mlp():
    return NerfMLP(flagship_options().arch, generator=torch.Generator().manual_seed(0))


def _rays(seed):
    """Forward-facing rays, inverse-depth stratified samples to depth 1e6
    (as chip_smoke.py's ray_batch), targets; flat [B*R]."""
    rng = np.random.RandomState(seed)
    center = rng.randn(B * R, 3) * 0.05
    ray = np.concatenate([(rng.rand(B * R, 2) - 0.5) * 1.2, np.ones((B * R, 1))], -1)
    u = (rng.rand(B * R, K) + np.arange(K)) / K
    depth = 1.0 / np.maximum(1.0 - u, 1e-6)
    target = rng.rand(B * R, 3)
    t8 = np.concatenate([target, np.ones((B * R, 1)), np.zeros((B * R, 4))], -1)
    return [torch.tensor(a, dtype=torch.float32) for a in (center, ray, depth, t8)]


def _k4_coefficients(seed):
    """Per-ray coefficients [R,8] of chip_smoke.py's K4 test loss
    sum(a rgb + b depth + c opacity): a ~ N(0, 1), b ~ 0.01 N(0, 1), c ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    coeffs = np.concatenate([rng.randn(B * R, 3), rng.randn(B * R, 1) * K4_DEPTH_COEFF,
                             rng.randn(B * R, 1), np.zeros((B * R, 3))], -1)
    return torch.tensor(coeffs, dtype=torch.float32)


def _k2_plain(mlp, center, ray, depth, t8, progress, **kw):
    """sq_sum, the [R,8] render and the gradients of sq_sum in (center, ray,
    weights) through K2's plain chain (_chain's options)."""
    return _chain(mlp, center, ray, depth, progress,
                  lambda out: fp.sq_sum_from_out(out, t8.to(out.dtype)), **kw)


def _chain(mlp, center, ray, depth, progress, loss=None, mm=None, f64=False, signs=None,
           fwd=None, frozen=False):
    """[loss, the render's first 5 columns] and the gradients of ``loss(out)``
    in (center, ray, weights, or without the weights when ``frozen``) through
    the plain chain; without ``loss`` only the render's rgb, depth and
    opacity. With ``mm`` every layer product but the rgb output layer's
    through it, in the forward as well unless ``fwd`` names the forward's
    product; with ``f64`` everything after the points and the PE in float64.
    ``signs``: a list that receives whether each layer output (but the rgb
    output layer's) is > 0, or, where it already holds them, to which each
    such output is held: a value on the other side of 0 becomes 0 or 1e-30,
    with the gradient passed through."""
    if f64 or frozen:
        # a new module, not a deepcopy: copying would add __slotnames__ to the
        # port's DotDict class (its arch), which test_torch_package.py compares
        # with the JAX package's
        copied = NerfMLP(mlp.arch, mlp.view_dep)
        copied.load_state_dict(mlp.state_dict())
        mlp = copied
    if f64:
        mlp = mlp.double()
    if frozen:
        mlp.requires_grad_(False)
    last = mlp.mlp_rgb[-1].weight
    linear, pe = F.linear, nerf_mlp.positional_encoding_c2f
    record = signs is not None and not signs
    calls = iter(range(len(signs))) if signs else None

    def emulated(x, w, b=None):
        if w is last:
            return linear(x, w, b)
        y = linear(x, w, b) if mm is None else _EmulatedLinear.apply(x, w, b, fwd or mm, mm)
        if record:
            signs.append(y.detach() > 0)
        elif calls is not None:
            y = _HoldSigns.apply(y, signs[next(calls)])
        return y

    def pe_fp32(x, *args):
        return pe(x.float(), *args).double()
    c = center.clone().requires_grad_(True)
    r = ray.clone().requires_grad_(True)
    if f64:
        nerf_mlp.positional_encoding_c2f = pe_fp32
    F.linear = emulated
    try:
        if f64:
            points = (c[:, None, :] + r[:, None, :] * depth[..., None]).double()
            ru = r / torch.clamp(torch.linalg.norm(r, dim=-1, keepdim=True), min=1e-12)
            rgb_s, dens = mlp(points, ru[:, None, :].expand(points.shape).double(),
                              progress=progress, barf_c2f=C2F)
            rgb, d, op, _ = render.composite(r.double(), rgb_s, dens,
                                             depth.double()[..., None])
            out = torch.cat([rgb, d, op, torch.zeros_like(rgb)], dim=-1)
        else:
            out = fp.render_rays_plain(mlp, c, r, depth, progress, C2F)
        if loss is None:
            return [out.detach()[:, :3], out.detach()[:, 3], out.detach()[:, 4]]
        value = loss(out)
        grads = torch.autograd.grad(value, [c, r] + [p for p in mlp.parameters()
                                                     if p.requires_grad])
    finally:
        F.linear = linear
        nerf_mlp.positional_encoding_c2f = pe
    return [value.detach(), out.detach()[:, :5]] + [g.detach() for g in grads]


def _rel(got, ref):
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


def _rel_l2(got, ref):
    return float(torch.linalg.norm(got.double() - ref.double())
                 / torch.linalg.norm(ref.double()))


def _report(names, gates, ref, f64, runs, rel_l2=()):
    """Print each run's distance from the fp32 chain (and float64's), as
    max |x - ref| / max |ref|, or for the names in ``rel_l2`` as
    |x - ref|_2 / |ref|_2; the names of the tensors where each run misses
    its gate."""
    print("  {:<24} {}  f64: plain {}".format(
        "max |x - fp32| / max", "  ".join("{:>14}".format(k) for k in runs),
        "  ".join("{:>9}".format(k[:9]) for k in runs)))
    misses = {k: [] for k in runs}
    for i, (name, gate) in enumerate(zip(names, gates)):
        dist = _rel_l2 if name in rel_l2 else _rel
        errs = {k: dist(run[i], ref[i]) for k, run in runs.items()}
        print("  {:<24} {}  (gate {:.0e}{})  f64: {:.2e} {}".format(
            name, "  ".join("{:14.2e}".format(e) for e in errs.values()), gate,
            ", L2" if name in rel_l2 else "", dist(ref[i], f64[i]),
            " ".join("{:.2e}".format(dist(run[i], f64[i])) for run in runs.values())))
        for k, e in errs.items():
            if e > gate:
                misses[k].append(name)
    return misses


@pytest.mark.parametrize("progress,tol_in", [(0.3, TOL), (1.0, TOL_ALL_BANDS)])
def test_3xtf32_holds_k2_gates_and_tf32_does_not(progress, tol_in):
    mlp = _flagship_mlp()
    names = (["sq_sum", "out", "dcenter", "dray"]
             + ["d" + n for n, _ in mlp.named_parameters()])
    gates = [TOL, TOL, tol_in, tol_in] + [TOL] * (len(names) - 4)
    inputs = _rays(seed=int(progress * 10))
    signs = []
    ref = _k2_plain(mlp, *inputs, progress, signs=signs)
    f64 = _k2_plain(mlp, *inputs, progress, f64=True, signs=signs)
    print("\nprogress {}: K2's scheme (fp32 forward, split backward) and single-pass "
          "TF32 in its place".format(progress))
    misses = _report(names, gates, ref, f64, {
        "K2 3xTF32": _k2_plain(mlp, *inputs, progress, mm=_mm_3xtf32, fwd=_mm_fp32),
        "TF32": _k2_plain(mlp, *inputs, progress, mm=_mm_tf32, fwd=_mm_fp32)})
    assert not misses["K2 3xTF32"], misses
    assert misses["TF32"], "single-pass TF32 in the backward meets every gate"
    print("every product split, signs free: correctly rounded fp32 and 3xTF32")
    _report(names, gates, ref, f64, {
        "fp32 rounded": _k2_plain(mlp, *inputs, progress,
                                  mm=lambda a, b: (a.double() @ b.double()).float()),
        "3xTF32": _k2_plain(mlp, *inputs, progress, mm=_mm_3xtf32)})
    print("every product split, signs held to the fp32 chain's")
    held = _report(names, gates, ref, f64, {
        "3xTF32": _k2_plain(mlp, *inputs, progress, mm=_mm_3xtf32, signs=signs),
        "TF32": _k2_plain(mlp, *inputs, progress, mm=_mm_tf32, signs=signs)})
    assert not held["3xTF32"], held
    assert {"sq_sum", "out"} <= set(held["TF32"]), held


@pytest.mark.parametrize("progress", [0.3, 1.0])
def test_3xtf32_holds_k3_render_gate_and_tf32_does_not(progress):
    """K3 without ``keep``: every forward product split, signs free."""
    mlp = _flagship_mlp()
    names = ["rgb", "depth", "opacity"]
    gates = [TOL] * 3
    inputs = _rays(seed=20 + int(progress * 10))[:3]
    ref = _chain(mlp, *inputs, progress)
    f64 = _chain(mlp, *inputs, progress, f64=True)
    print("\nprogress {}: K3's render (every forward product split, signs free) and "
          "single-pass TF32 in its place".format(progress))
    misses = _report(names, gates, ref, f64, {
        "K3 3xTF32": _chain(mlp, *inputs, progress, mm=_mm_3xtf32),
        "TF32": _chain(mlp, *inputs, progress, mm=_mm_tf32)})
    assert not misses["K3 3xTF32"], misses
    assert misses["TF32"], "single-pass TF32 in the forward meets the value gate"


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "with_dw"])
@pytest.mark.parametrize("progress,tol_in", [(0.3, TOL), (1.0, TOL_ALL_BANDS)])
def test_3xtf32_holds_k4_gates_and_tf32_does_not(progress, tol_in, frozen):
    """K4 after K3's kept forward: fp32 forward, split input-gradient and
    weight-gradient products, under K4's test loss."""
    mlp = _flagship_mlp()
    names = ["loss", "out", "dcenter", "dray"] + (
        [] if frozen else ["d" + n for n, _ in mlp.named_parameters()])
    gates = [TOL, TOL, tol_in, tol_in] + [TOL_K4_WEIGHT_GRAD] * (len(names) - 4)
    inputs = _rays(seed=30 + int(progress * 10))[:3]
    coeffs = _k4_coefficients(seed=40 + int(progress * 10))

    def loss(out):
        return torch.sum(coeffs.to(out.dtype) * out)

    def run(**kw):
        return _chain(mlp, *inputs, progress, loss, frozen=frozen, **kw)
    ref, f64 = run(), run(f64=True)
    print("\nprogress {}, weights {}: K4's scheme (fp32 forward, split backward) and "
          "single-pass TF32 in its place".format(progress, "frozen" if frozen else "free"))
    misses = _report(names, gates, ref, f64, {
        "K4 3xTF32": run(mm=_mm_3xtf32, fwd=_mm_fp32),
        "TF32": run(mm=_mm_tf32, fwd=_mm_fp32)})
    assert not misses["K4 3xTF32"], misses
    assert misses["TF32"], "single-pass TF32 in the backward meets every gate"


def _fine_rays(seed):
    """Rays [R,3], stratified depths [R,K] in [0,1] (nerf_llff_repr's
    range, as chip_smoke.py's fine_batch), a standard-normal density-noise
    draw [R,K] (NOISE_REG 1) and per-ray coefficients [R,5] of the field test
    loss sum(a rgb + b depth + c opacity), all N(0, 1), as there."""
    rng = np.random.RandomState(seed)
    center = rng.randn(FINE_R, 3) * 0.05
    ray = np.concatenate([(rng.rand(FINE_R, 2) - 0.5) * 1.2, np.ones((FINE_R, 1))], -1)
    depth = (rng.rand(FINE_R, FINE_K) + np.arange(FINE_K)) / FINE_K
    noise = rng.randn(FINE_R, FINE_K)
    coeffs = rng.randn(FINE_R, 5)
    return [torch.tensor(a, dtype=torch.float32) for a in (center, ray, depth, noise, coeffs)]


def _field_chain(mlp, center, ray, depth, activ, noise=None, coeffs=None, mm=None, fwd=None,
                 f64=False):
    """The field per sample as K5 and K1 compute it: the points, the unit
    rays and their PE in fp32 (in K5's kernel, or in PyTorch ahead of K1's),
    then the layers. Without ``coeffs``, [rgb [R*K,3], density [R*K]]; with
    them, [loss, dcenter, dray, dxp, dview] + the weight gradients of the
    field test loss, the field composited in PyTorch as the fallback and
    MLP-only tiers composite it (dxp, dview: K1's own input cotangents). With
    ``mm`` every layer product through it, in the forward as well unless
    ``fwd`` names the forward's product; the rgb output layer (128 -> 3), in
    fp32 in the kernels' per-sample head, takes ``mm`` in its weight
    gradient only, as the kernels do. With ``f64`` the layers and the
    compositing in float64."""
    if f64:
        copied = NerfMLP(mlp.arch, mlp.view_dep)   # not a deepcopy: see _chain
        copied.load_state_dict(mlp.state_dict())
        mlp = copied.double()
    last = mlp.mlp_rgb[-1].weight
    linear = F.linear

    def emulated(x, w, b=None):
        if mm is None:
            return linear(x, w, b)
        if w is last:
            return _EmulatedLinear.apply(x, w, b, _mm_fp32, _mm_fp32, mm)
        return _EmulatedLinear.apply(x, w, b, fwd or mm, mm)
    dtype = torch.float64 if f64 else torch.float32
    c = center.clone().requires_grad_(True)
    r = ray.clone().requires_grad_(True)
    xp, view = mlp.encode(*nerf_mlp.sample_points(c, r, depth[..., None]))
    F.linear = emulated
    try:
        rgb_s, dens = mlp.forward_encoded(xp.to(dtype), view.to(dtype), activ,
                                          None if noise is None else noise.to(dtype))
    finally:
        F.linear = linear
    if coeffs is None:
        return [rgb_s.detach().reshape(-1, 3), dens.detach().reshape(-1)]
    rgb, d, op, _ = render.composite(r.to(dtype), rgb_s, dens, depth.to(dtype)[..., None])
    coeffs = coeffs.to(dtype)
    loss = (torch.sum(coeffs[:, :3] * rgb) + torch.sum(coeffs[:, 3:4] * d)
            + torch.sum(coeffs[:, 4:] * op))
    grads = torch.autograd.grad(loss, [c, r, xp, view] + list(mlp.parameters()))
    return [loss.detach()] + [g.detach() for g in grads]


@pytest.mark.parametrize("activ", ["softplus", "relu"])
def test_3xtf32_holds_field_render_gate_and_tf32_does_not(activ):
    """K5's and K1's render forward (no autograd, no noise: every validation
    and evaluation chunk of the fine model): every layer product split,
    signs free; per-sample rgb and density must meet the value gate, and
    single-pass TF32 there must miss it."""
    mlp = _flagship_mlp()
    center, ray, depth, _, _ = _fine_rays(seed=60 + len(activ))
    args = (mlp, center, ray, depth, activ)
    ref, f64 = _field_chain(*args), _field_chain(*args, f64=True)
    print("\n{}: K5's and K1's render (every forward product split, signs free) and "
          "single-pass TF32 in its place, {} rays x {} samples in [0,1]".format(
              activ, FINE_R, FINE_K))
    misses = _report(["rgb", "density"], [TOL] * 2, ref, f64, {
        "K5/K1 3xTF32": _field_chain(*args, mm=_mm_3xtf32),
        "TF32": _field_chain(*args, mm=_mm_tf32)})
    assert not misses["K5/K1 3xTF32"], misses
    assert misses["TF32"], "single-pass TF32 in the forward meets the value gate"


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noise"])
@pytest.mark.parametrize("activ", ["softplus", "relu"])
def test_3xtf32_holds_field_gates(activ, noisy):
    """K5 and K1 under autograd: the kept forward in fp32 (gemm_kernel's
    order), every backward product split, under the field test loss, with
    and without density noise. The gates are chip_smoke.py's for its field
    cases: softplus weight gradients and K1's dxp/dview 1e-5 of max,
    dcenter/dray TOL_FIELD_INPUT_GRAD; with relu density every gradient leaf
    relative L2 1e-2. Single-pass TF32 in the backward must miss the
    softplus gates."""
    mlp = _flagship_mlp()
    center, ray, depth, noise, coeffs = _fine_rays(seed=70 + 2 * len(activ) + noisy)
    args = (mlp, center, ray, depth, activ, noise * NOISE_REG if noisy else None, coeffs)
    names = ["loss", "dcenter", "dray", "dxp", "dview"] + [
        "d" + n for n, _ in mlp.named_parameters()]
    if activ == "relu":
        gates, rel_l2 = [TOL] + [TOL_RELU_REL_L2] * (len(names) - 1), set(names[1:])
    else:
        gates, rel_l2 = [TOL] + [TOL_FIELD_INPUT_GRAD] * 2 + [TOL] * (len(names) - 3), ()
    ref, f64 = _field_chain(*args), _field_chain(*args, f64=True)
    print("\n{}{}: K5's and K1's scheme (fp32 forward, split backward) and single-pass "
          "TF32 in its place".format(activ, ", noise" if noisy else ""))
    misses = _report(names, gates, ref, f64, {
        "K5/K1 3xTF32": _field_chain(*args, mm=_mm_3xtf32, fwd=_mm_fp32),
        "TF32": _field_chain(*args, mm=_mm_tf32, fwd=_mm_fp32)}, rel_l2)
    assert not misses["K5/K1 3xTF32"], misses
    if activ == "softplus":
        assert misses["TF32"], "single-pass TF32 in the backward meets every gate"


def test_k2_weights_packed_once_per_step():
    """K2's weight planes (the plain version of its pack kernel): made once,
    reused while no parameter changes, made anew after an optimizer step and
    after load_state_dict. The weight row holds the packed weights (leading
    dimensions rounded up to 4 with zero columns), the hi and lo rows add up
    to them, the tail holds Wr1 and b7p, and the pointers K2 reads point
    into the planes or at the module's own biases."""
    mlp = _flagship_mlp()
    packs = fp.fused_render_rays_pe_train.packs
    first = fp.k2_weights(mlp)
    assert fp.k2_weights(mlp) is first
    assert fp.fused_render_rays_pe_train.packs == packs + 1
    weights = fp.pack_weights(mlp)
    P = fp.PLANE_FLOATS
    assert first.lo == P and first.planes.numel() == 3 * P + fp.PLANES_TAIL
    rows = first.planes[:3 * P].view(3, P)
    base = first.planes.data_ptr()
    for i, (w, off) in enumerate(zip(weights[:fp.N_SPLIT], fp.PLANE_OFFSETS)):
        assert tuple(w.shape) == fp.PLANE_SHAPES[i] == first.grad_shapes[i]
        assert first.ptrs[i] == base + 4 * off
        assert first.split_ptrs[i] == base + 4 * (P + off)
        n_in, n_out = w.shape
        ld = -(-n_out // 4) * 4
        flat, hi, lo = (row[off:off + n_in * ld].view(n_in, ld) for row in rows)
        assert torch.equal(flat[:, :n_out], w) and not torch.any(flat[:, n_out:])
        assert not torch.any(_low_bits(hi)) and not torch.any(_low_bits(lo))
        got = hi.double() + lo.double()
        assert torch.all((got[:, :n_out] - w.double()).abs() <= 2.0 ** -22 * w.double().abs())
    tail = first.planes[3 * P:]
    assert torch.equal(tail[:384].view(128, 3), weights[9])
    assert torch.equal(tail[384:], weights[17])
    params = list(mlp.parameters())
    for slot, ptr in [(9, tail.data_ptr()), (17, tail.data_ptr() + 4 * 384)] + [
            (10 + i, params[2 * i + 1].data_ptr()) for i in range(7)] + [
            (18, params[17].data_ptr()), (19, params[19].data_ptr())]:
        assert first.ptrs[slot] == first.split_ptrs[slot] == ptr
    assert [tuple(w.shape) for w in weights] == first.grad_shapes
    opt = torch.optim.Adam(mlp.parameters(), lr=1e-3)
    sum(p.sum() for p in mlp.parameters()).backward()
    opt.step()
    second = fp.k2_weights(mlp)
    assert second is not first and fp.k2_weights(mlp) is second
    assert not torch.equal(second.planes, first.planes)
    mlp.load_state_dict(_flagship_mlp().state_dict())
    third = fp.k2_weights(mlp)
    assert third is not second and torch.equal(third.planes, first.planes)
    assert fp.fused_render_rays_pe_train.packs == packs + 3
