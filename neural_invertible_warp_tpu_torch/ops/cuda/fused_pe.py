"""NeRF field kernels with the PE inside: the composited render's CUDA
kernels K2 (train), K3 (forward) and K4 (backward of K3), and the per-sample
field kernel K5 (forward and backward), each with its plain PyTorch version
(port of neural_invertible_warp_tpu/ops/pallas/fused_pe.py:
``fused_render_rays_pe`` with its VJP, ``fused_render_rays_pe_train`` and
``fused_apply_nerf_samples_pe``).

K2-K4 compute, per ray: the PE of center + ray * depth (BARF c2f weights
folded in), the 8x256 NeRF MLP, quadrature and alpha compositing, giving
[R,8] = (rgb, depth, opacity, 0, 0, 0). K2 also forms the photometric MSE
cotangent in-kernel and returns d(sq_sum)/d(center, ray, weights); it takes
an optional density-noise operand and can return the per-sample compositing
weights that fine sampling resamples from. K3 under autograd keeps its
activations, and K4 turns an arbitrary cotangent of the [R,8] output into
d/d(center, ray) and, where a weight needs one, the weight gradients. K5
stops before the compositing: per sample (rgb, density), with the same
noise operand, and under autograd a backward kernel to d/d(center, ray,
weights).

The wrappers take the plain version only for CPU tensors. For CUDA tensors
they launch the kernel or raise. ``compute_dtype`` is the JAX package's
``tpu.compute_dtype``: "float32", or "bfloat16" for K2-K4 (both operands of
every layer product rounded to bf16, products summed in fp32; positions, the
PE, biases and activations in fp32), whose plain versions then round the
same operands (``nerf_mlp``'s ``compute_dtype``). K5 (and K1,
``fused_field``) have no bf16 variant yet and refuse "bfloat16". Sources:
``csrc/rm_fwd.cu``, ``csrc/rm_bwd.cu``, ``csrc/rm_train.cu``,
``csrc/field_pe.cu``, ``csrc/nerf_field.cuh`` and ``csrc/gemm_tc.cuh``, the
layer products of
K1-K5: on the tensor cores in split fp32 for every backward and for the
renders of K3, K5 and K1 (forwards that no backward reads), in fp32 on the
CUDA cores for K2's forward and the forwards under autograd of K3, K5 and
K1; under bfloat16 K2-K4's products on the same split by mode, the fp32 route
with its operands rounded and one bf16 pass on the tensor cores in place of
the split one. They read the layer weights padded and as TF32 hi and lo
planes (``split_tf32``), and under bfloat16 also as a bf16 plane, packed by
one kernel launch once per parameter version and compute dtype
(``k2_weights``).
"""

from __future__ import annotations

import ctypes
import math
import weakref

import torch
import torch.nn.functional as F

from .. import posenc, render
from ..nerf_mlp import apply_nerf_samples
from . import build

L3D = 10
LVIEW = 4
# input_backward_kernel keeps K x 33 floats in dynamic shared memory, which
# launches without opt-in up to 48 KB (K <= 372); fine sampling needs 192.
MAX_K = 256
# the SGEMMs put 128-row tiles of the R*K samples on grid y (at most 65535)
MAX_SAMPLES = 65535 * 128
_ACTIV = {"softplus": 0, "relu": 1}
COMPUTE_DTYPES = ("float32", "bfloat16")


def _activ(density_activ):
    """The kernels' code for a density activation; they implement softplus
    and relu only."""
    if density_activ not in _ACTIV:
        raise NotImplementedError(
            "the field kernels K1-K5 implement arch.density_activ softplus and relu, "
            "not {!r}: set tpu.fused_pe and tpu.fused_kernel to false to take the "
            "plain chain".format(density_activ))
    return _ACTIV[density_activ]


def resolve_compute_dtype(compute_dtype):
    """``tpu.compute_dtype`` checked: "float32" (also for None) or
    "bfloat16"; anything else raises ValueError."""
    compute_dtype = compute_dtype or "float32"
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError("tpu.compute_dtype must be float32 or bfloat16, not {!r}".format(
            compute_dtype))
    return compute_dtype


def refuse_bf16(compute_dtype, kernel):
    """The per-sample field kernels (K5, K1) have no bf16 variant yet: raise
    rather than run in fp32 under ``tpu.compute_dtype: bfloat16``."""
    if resolve_compute_dtype(compute_dtype) != "float32":
        raise NotImplementedError(
            "tpu.compute_dtype: bfloat16 is ported for K2, K3 and K4 only; {} has no bf16 "
            "variant yet: set tpu.compute_dtype: float32".format(kernel))


def supports(mlp):
    """Whether the kernels cover this field: the reference architecture."""
    a = mlp.arch
    return (list(a.layers_feat) == [None] + [256] * 8
            and list(a.layers_rgb) == [None, 128, 3]
            and list(a.skip) == [4]
            and a.posenc.L_3D == L3D and a.posenc.L_view == LVIEW
            and mlp.view_dep)


def band_weights(progress, c2f, device):
    """(w3 [10], wv [4]) BARF c2f band weights, ones without c2f."""
    if c2f is None:
        return (torch.ones(L3D, device=device), torch.ones(LVIEW, device=device))
    return (posenc.barf_c2f_weights(progress, L3D, c2f, device=device),
            posenc.barf_c2f_weights(progress, LVIEW, c2f, device=device))


# ------------------------------------------------------------ weight packing
# Kernel layout (csrc/nerf_field.cuh): weights [in, out]; W7 with the
# density column moved last; Wr0 with a zero row for the density slot of
# the kernel's [feature, density, view] head input.

def pack_weights(mlp):
    """The 20 kernel weight tensors (W0..W6, W7p, Wr0p, Wr1, b0..b6, b7p,
    br0, br1), contiguous fp32."""
    f, r = mlp.mlp_feat, mlp.mlp_rgb
    Ws = [f[i].weight.detach().t() for i in range(8)]
    bs = [f[i].bias.detach() for i in range(8)]
    Ws[7] = torch.cat([Ws[7][:, 1:], Ws[7][:, :1]], dim=1)
    bs[7] = torch.cat([bs[7][1:], bs[7][:1]])
    wr0 = r[0].weight.detach().t()
    wr0 = torch.cat([wr0[:256], torch.zeros_like(wr0[:1]), wr0[256:]], dim=0)
    Ws += [wr0, r[1].weight.detach().t()]
    bs += [r[0].bias.detach(), r[1].bias.detach()]
    return [t.contiguous() for t in Ws + bs]


def unpack_grads(dws):
    """Kernel-layout gradients -> gradients of ``mlp.parameters()`` in order
    (mlp_feat.i.weight, mlp_feat.i.bias, ..., mlp_rgb.1.bias)."""
    dW, db = list(dws[:10]), list(dws[10:])
    dW[7] = torch.cat([dW[7][:, 256:], dW[7][:, :256]], dim=1)
    db[7] = torch.cat([db[7][256:], db[7][:256]])
    dW[8] = torch.cat([dW[8][:256], dW[8][257:]], dim=0)
    out = []
    for w, b in zip(dW, db):
        out += [w.t(), b]
    return out


# K2's layer weights W0..W7p and Wr0p, each [in, out rounded up to 4 with
# zero columns] (csrc/gemm_tc.cuh, TcGemm::ld), go to its forward products
# as they are and to its backward's tensor-core products (the input
# gradients) as TF32 hi and lo planes. K2's planes buffer holds the three
# rows of PLANE_FLOATS (weights, hi, lo), then Wr1 [128, 3] and b7p [257]
# (csrc/rm_train.cu, pack_planes_kernel); under bfloat16 then zeros up to
# BF16_BASE floats and the bf16 plane: the same weights, each [in, out
# rounded up to 8] (Bf16Gemm::ld), as PLANE_HALVES bf16 values.
N_SPLIT = 9
PLANE_SHAPES = [(63, 256)] + [(256, 256)] * 3 + [(319, 256)] + [(256, 256)] * 2 + [
    (256, 257), (284, 128)]
PLANES_TAIL = 128 * 3 + 257


def _plane_offsets(align):
    offsets = [0]
    for n_in, n_out in PLANE_SHAPES:
        offsets.append(offsets[-1] + n_in * (-(-n_out // align) * align))
    return offsets


*PLANE_OFFSETS, PLANE_FLOATS = _plane_offsets(4)
*BF16_OFFSETS, PLANE_HALVES = _plane_offsets(8)
BF16_BASE = -(-(3 * PLANE_FLOATS + PLANES_TAIL) // 4) * 4


def planes_floats(compute_dtype="float32"):
    """Floats in K2's planes buffer for ``compute_dtype``."""
    return (BF16_BASE + PLANE_HALVES // 2 if compute_dtype == "bfloat16"
            else 3 * PLANE_FLOATS + PLANES_TAIL)


def split_tf32(w):
    """(hi, lo) with w = hi + lo up to lo's rounding, both TF32 values in
    fp32 (the low 13 mantissa bits zero): hi is w rounded to TF32, to
    nearest with ties away from zero as ``cvt.rna.tf32.f32`` rounds, and lo
    is w - hi rounded the same way. The plain version of the split that
    K2's tensor-core GEMM applies to its operands."""
    hi = _round_tf32(w)
    return hi, _round_tf32(w - hi)


def _round_tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def k2_planes_plain(mlp, compute_dtype="float32"):
    """K2's planes buffer through PyTorch operations: the plain version of
    ``niw_rm_train_pack``."""
    weights = pack_weights(mlp)
    flat = torch.cat([F.pad(w, (0, -w.shape[1] % 4)).reshape(-1)
                      for w in weights[:N_SPLIT]])
    planes = torch.cat((flat,) + split_tf32(flat) + (weights[9].reshape(-1), weights[17]))
    if compute_dtype != "bfloat16":
        return planes
    halves = torch.cat([F.pad(w, (0, -w.shape[1] % 8)).reshape(-1)
                        for w in weights[:N_SPLIT]]).to(torch.bfloat16)
    return torch.cat([planes, planes.new_zeros(BF16_BASE - planes.numel()),
                      halves.view(torch.float32)])


def k2_planes(mlp, compute_dtype="float32"):
    """K2's planes buffer for ``compute_dtype``: one ``niw_rm_train_pack``
    launch on CUDA, the plain version on the CPU."""
    params = [p.detach() for p in mlp.parameters()]
    if not params[0].is_cuda:
        return k2_planes_plain(mlp, compute_dtype)
    lib = build.load_library().lib
    if (lib.niw_rm_train_plane_offset(N_SPLIT) != PLANE_FLOATS
            or lib.niw_rm_train_bf16_offset(N_SPLIT) != PLANE_HALVES
            or lib.niw_rm_train_bf16_offset(-1) != BF16_BASE):
        raise RuntimeError("K2's plane layout differs between fused_pe.py and rm_train.cu")
    planes = torch.empty(planes_floats(compute_dtype), dtype=torch.float32,
                         device=params[0].device)
    build.check(lib.niw_rm_train_pack(_ptrs(params), planes.data_ptr(),
                                      int(compute_dtype == "bfloat16"),
                                      torch.cuda.current_stream(planes.device).cuda_stream),
                "niw_rm_train_pack")
    return planes


class K2Weights:
    """The weight operands of K1-K5: ``planes`` (k2_planes);
    ``ptrs``, the 20 weight pointers of the fp32 products (W0..Wr0p into the
    weight row, Wr1 and b7p into the tail, the other biases the module's
    own), and ``split_ptrs``, the same with the hi row in the slots of
    W0..Wr0p, for the split products; under bfloat16 ``bf16_ptrs``, the
    same with the bf16 plane in those slots (else None), and ``bf16`` 1;
    ``lo``, the lo row's offset from the hi row in floats; ``grad_shapes``,
    the shapes of the 20 gradients K2, K4, K5 and K1 write (unpack_grads'
    layout)."""

    def __init__(self, mlp, planes, compute_dtype="float32"):
        params = [p.detach() for p in mlp.parameters()]
        self.planes = planes
        self.lo = PLANE_FLOATS
        base = planes.data_ptr()
        tail = base + 4 * 3 * PLANE_FLOATS
        biases = [params[2 * i + 1].data_ptr() for i in range(7)] + [
            tail + 4 * 128 * 3, params[17].data_ptr(), params[19].data_ptr()]
        self.ptrs = (ctypes.c_void_p * 20)(
            *[base + 4 * off for off in PLANE_OFFSETS], tail, *biases)
        self.split_ptrs = (ctypes.c_void_p * 20)(
            *[base + 4 * (PLANE_FLOATS + off) for off in PLANE_OFFSETS], tail, *biases)
        self.bf16 = int(compute_dtype == "bfloat16")
        self.bf16_ptrs = (ctypes.c_void_p * 20)(
            *[base + 4 * BF16_BASE + 2 * off for off in BF16_OFFSETS], tail,
            *biases) if self.bf16 else None
        self.grad_shapes = PLANE_SHAPES + [(128, 3)] + [(256,)] * 7 + [(257,), (128,), (3,)]


# mlp -> {compute dtype: (parameter versions, K2Weights)}
_K2_WEIGHTS = weakref.WeakKeyDictionary()


def k2_weights(mlp, compute_dtype="float32"):
    """The packed and split weights of K1-K5 for ``compute_dtype``, made
    anew only when a parameter of ``mlp`` changed (its storage or its
    version counter, which an optimizer step, an in-place update or
    ``load_state_dict`` advances): once per optimizer step in training, at
    most once per render or refinement with frozen weights, not once per
    launch. Each compute dtype keeps its own entry."""
    key = tuple((p.data_ptr(), p._version) for p in mlp.parameters())
    entries = _K2_WEIGHTS.setdefault(mlp, {})
    hit = entries.get(compute_dtype)
    if hit is None or hit[0] != key:
        hit = (key, K2Weights(mlp, k2_planes(mlp, compute_dtype), compute_dtype))
        entries[compute_dtype] = hit
        fused_render_rays_pe_train.packs += 1
    return hit[1]


# ----------------------------------------------------------- plain versions

def _render_plain(mlp, center, ray, depth, progress, barf_c2f, density_activ, noise,
                  compute_dtype="float32"):
    """PE -> MLP -> composite on flat rays -> (out [R,8], prob [R,K]); the
    layer products in ``compute_dtype`` (nerf_mlp's)."""
    depth4 = depth.detach()[..., None]
    rgb_s, dens = apply_nerf_samples(mlp, center, ray, depth4,
                                     progress=progress, barf_c2f=barf_c2f,
                                     density_activ=density_activ, noise=noise,
                                     compute_dtype=resolve_compute_dtype(compute_dtype))
    rgb, d, op, prob = render.composite(ray, rgb_s, dens, depth4)
    return torch.cat([rgb, d, op, torch.zeros_like(rgb)], dim=-1), prob[..., 0]


def render_rays_plain(mlp, center, ray, depth, progress=None, barf_c2f=None,
                      density_activ="softplus", compute_dtype="float32"):
    """PE -> MLP -> composite. center/ray [R,3]; depth [R,K] -> [R,8]."""
    return _render_plain(mlp, center, ray, depth, progress, barf_c2f, density_activ,
                         None, compute_dtype)[0]


def render_rays_backward_plain(mlp, center, ray, depth, g8, progress=None,
                               barf_c2f=None, density_activ="softplus",
                               want_dw=True, compute_dtype="float32"):
    """K4's plain version: the VJP of ``render_rays_plain`` at the cotangent
    g8 [R,8], by autograd. Returns (dcenter, dray, grads of
    ``mlp.parameters()``, or [] without ``want_dw``)."""
    c = center.detach().requires_grad_(True)
    r = ray.detach().requires_grad_(True)
    with torch.enable_grad():
        out = render_rays_plain(mlp, c, r, depth, progress, barf_c2f, density_activ,
                                compute_dtype)
    params = list(mlp.parameters()) if want_dw else []
    grads = torch.autograd.grad(out, [c, r] + params, g8)
    return grads[0], grads[1], list(grads[2:])


def sq_sum_from_out(out, target8, bg=None):
    """sum over rays of valid * |rgb_final - target|^2."""
    rgb = out[:, :3]
    if bg is not None:
        rgb = rgb + bg * (1.0 - out[:, 4:5])
    return torch.sum(target8[:, 3:4] * (rgb - target8[:, :3]) ** 2)


def _train_plain(mlp, center, ray, depth, target8, progress, barf_c2f, bg, density_activ,
                 noise, compute_dtype):
    out, prob = _render_plain(mlp, center, ray, depth, progress, barf_c2f,
                              density_activ, noise, compute_dtype)
    return sq_sum_from_out(out, target8, bg), out, prob


class _PlainTrain(torch.autograd.Function):
    """sq_sum, out [R,8] and prob [R,K] of K2's plain version under
    bfloat16, differentiated as K2 (and the JAX kernel) is: the gradients of
    sq_sum itself, taken in the forward, then scaled by d(loss)/d(sq_sum).
    Each cotangent thus reaches its bf16 rounding unscaled, as in the
    kernels; rounding does not commute with a scale that is not a power of
    two, so autograd through the loss would round other values (relative L2
    ~1e-2 in the weight gradients)."""

    @staticmethod
    def forward(ctx, center, ray, args, *params):
        leaves = [center.detach().requires_grad_(center.requires_grad),
                  ray.detach().requires_grad_(ray.requires_grad)]
        with torch.enable_grad():
            sq, out, prob = _train_plain(args[0], *leaves, *args[1:])
        wrt = leaves + list(params)
        grads = iter(torch.autograd.grad(sq, [t for t in wrt if t.requires_grad])
                     if any(t.requires_grad for t in wrt) else ())
        ctx.grads = [next(grads) if t.requires_grad else None for t in wrt]
        out, prob = out.detach(), prob.detach()
        ctx.mark_non_differentiable(out, prob)
        return sq.detach(), out, prob

    @staticmethod
    def backward(ctx, g_sq, g_out, g_prob):
        scaled = [None if g is None else g * g_sq for g in ctx.grads]
        return (scaled[0], scaled[1], None) + tuple(scaled[2:])


def render_rays_train_plain(mlp, center, ray, depth, target8, progress=None,
                            barf_c2f=None, bg=None, density_activ="softplus",
                            noise=None, want_prob=False, compute_dtype="float32"):
    """(sq_sum, out [R,8]) through the plain chain, and with ``want_prob``
    also the compositing weights [R,K], detached; gradients by autograd
    (under bfloat16 those of sq_sum, scaled afterwards: _PlainTrain).
    noise [R,K] on the density pre-activation, optional."""
    args = (mlp, depth, target8, progress, barf_c2f, bg, density_activ, noise, compute_dtype)
    if resolve_compute_dtype(compute_dtype) == "float32":
        sq, out, prob = _train_plain(mlp, center, ray, *args[1:])
    else:
        sq, out, prob = _PlainTrain.apply(center, ray, args, *mlp.parameters())
    res = (sq, out)
    return res + (prob.detach(),) if want_prob else res


# ---------------------------------------------------------------- launches

def _check_inputs(mlp, tensors, K):
    if not supports(mlp):
        raise ValueError("the CUDA field kernels cover only the reference "
                         "architecture (8x256 trunk, skip 4, 128 head, L 10/4)")
    if not 1 <= K <= MAX_K:
        raise ValueError("samples per ray must be in [1, {}]: {}".format(MAX_K, K))
    if tensors[0].shape[0] * K > MAX_SAMPLES:
        raise ValueError("at most {} samples per call: {} rays x {}".format(
            MAX_SAMPLES, tensors[0].shape[0], K))
    dev = tensors[0].device
    for t in tensors + list(mlp.parameters()):
        if (not t.is_cuda or t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("kernel inputs and weights must be contiguous "
                             "float32 on one CUDA device")


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _grad_buffers(packed, device):
    """The 20 weight gradients in K2's packed layout (``grad_shapes``), as
    views of one allocation."""
    sizes = [math.prod(shape) for shape in packed.grad_shapes]
    return [t.view(shape) for t, shape in zip(
        torch.empty(sum(sizes), dtype=torch.float32, device=device).split(sizes),
        packed.grad_shapes)]


def _rm_fwd(mlp, center, ray, depth, w3, wv, density_activ, keep, compute_dtype="float32"):
    """One K3 launch. Returns (out [R,8], workspace, K2Weights); with
    ``keep`` the workspace holds every layer's activations, for K4."""
    R, K = depth.shape
    _check_inputs(mlp, [center, ray, depth, w3, wv], K)
    lib = build.load_library().lib
    packed = k2_weights(mlp, resolve_compute_dtype(compute_dtype))
    out = torch.empty((R, 8), dtype=torch.float32, device=depth.device)
    ws = torch.empty(lib.niw_rm_fwd_workspace_floats(R * K, int(keep)),
                     dtype=torch.float32, device=depth.device)
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    err = lib.niw_rm_fwd(center.data_ptr(), ray.data_ptr(), depth.data_ptr(), R, K,
                         w3.data_ptr(), wv.data_ptr(), packed.ptrs, packed.split_ptrs,
                         packed.lo, packed.bf16_ptrs, packed.bf16, _activ(density_activ),
                         int(keep), out.data_ptr(), ws.data_ptr(), stream)
    build.check(err, "niw_rm_fwd")
    return out, ws, packed


def launch_rm_fwd(mlp, center, ray, depth, w3, wv, density_activ="softplus",
                  compute_dtype="float32"):
    """K3 on CUDA tensors: center/ray [R,3], depth [R,K] -> out [R,8]."""
    return _rm_fwd(mlp, center, ray, depth, w3, wv, density_activ, False, compute_dtype)[0]


def launch_rm_bwd(mlp, center, ray, depth, g8, w3, wv, cache, packed,
                  want_dw=True, density_activ="softplus"):
    """K4 on CUDA tensors: the cotangent g8 [R,8] of K3's output, with the
    activation ``cache`` and the weights ``packed`` (K2Weights) of the K3
    launch that kept them, in that launch's compute dtype, -> (dcenter, dray
    [R,3], grads of ``mlp.parameters()`` or None without ``want_dw``)."""
    R, K = depth.shape
    _check_inputs(mlp, [center, ray, depth, g8, w3, wv, cache, packed.planes], K)
    lib = build.load_library().lib
    if g8.shape != (R, 8) or cache.numel() != lib.niw_rm_fwd_workspace_floats(R * K, 1):
        raise ValueError("cotangent must be [R,8] and the cache that of a "
                         "kept K3 launch on the same rays")
    dws = _grad_buffers(packed, depth.device) if want_dw else []
    dcenter = torch.empty((R, 3), dtype=torch.float32, device=depth.device)
    dray = torch.empty((R, 3), dtype=torch.float32, device=depth.device)
    ws = torch.empty(lib.niw_rm_bwd_workspace_floats(R * K, R),
                     dtype=torch.float32, device=depth.device)
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    err = lib.niw_rm_bwd(center.data_ptr(), ray.data_ptr(), depth.data_ptr(),
                         g8.data_ptr(), R, K, w3.data_ptr(), wv.data_ptr(),
                         packed.split_ptrs, packed.lo, packed.bf16_ptrs, packed.bf16,
                         _activ(density_activ), cache.data_ptr(), int(want_dw),
                         dcenter.data_ptr(),
                         dray.data_ptr(), _ptrs(dws) if want_dw else None, ws.data_ptr(),
                         stream)
    build.check(err, "niw_rm_bwd")
    return dcenter, dray, unpack_grads(dws) if want_dw else None


def launch_rm_train(mlp, center, ray, depth, target8, w3, wv, bg=None,
                    density_activ="softplus", noise=None, want_prob=False,
                    compute_dtype="float32"):
    """K2 on CUDA tensors. Returns (out [R,8], dcenter, dray [R,3], grads of
    ``mlp.parameters()``, prob [R,K] or None), the gradients being those of
    sq_sum. ``noise`` [R,K] is added to the density pre-activation."""
    R, K = depth.shape
    _check_inputs(mlp, [center, ray, depth, target8, w3, wv]
                  + ([] if noise is None else [noise]), K)
    if noise is not None and noise.shape != (R, K):
        raise ValueError("noise must be [R,K] like depth: {}".format(tuple(noise.shape)))
    lib = build.load_library().lib
    packed = k2_weights(mlp, resolve_compute_dtype(compute_dtype))
    dws = _grad_buffers(packed, depth.device)
    out = torch.empty((R, 8), dtype=torch.float32, device=depth.device)
    dcenter = torch.empty((R, 3), dtype=torch.float32, device=depth.device)
    dray = torch.empty((R, 3), dtype=torch.float32, device=depth.device)
    prob = (torch.empty((R, K), dtype=torch.float32, device=depth.device)
            if want_prob else None)
    ws = torch.empty(lib.niw_rm_train_workspace_floats(R * K, R),
                     dtype=torch.float32, device=depth.device)
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    err = lib.niw_rm_train(center.data_ptr(), ray.data_ptr(), depth.data_ptr(),
                           target8.data_ptr(),
                           None if noise is None else noise.data_ptr(), R, K,
                           w3.data_ptr(), wv.data_ptr(), packed.ptrs, packed.split_ptrs,
                           packed.lo, packed.bf16_ptrs, packed.bf16,
                           _activ(density_activ), int(bg is not None),
                           float(bg or 0.0), out.data_ptr(), dcenter.data_ptr(),
                           dray.data_ptr(), _ptrs(dws),
                           None if prob is None else prob.data_ptr(),
                           ws.data_ptr(), stream)
    build.check(err, "niw_rm_train")
    return out, dcenter, dray, unpack_grads(dws), prob


def _count(wrapper, name, compute_dtype):
    """One more launch in ``wrapper``'s count ``name``, or in its bf16 twin
    (``bf16_`` + name) under bfloat16."""
    name = name if compute_dtype == "float32" else "bf16_" + name
    setattr(wrapper, name, getattr(wrapper, name) + 1)


class _RmTrain(torch.autograd.Function):
    """sq_sum (differentiable), out [R,8] and prob [R,K] (neither; prob is
    empty without ``want_prob``) from one K2 launch; the backward scales the
    kernel's saved gradients by d(loss)/d(sq_sum)."""

    N_LEADING = 12   # arguments before *params

    @staticmethod
    def forward(ctx, center, ray, depth, target8, w3, wv, mlp, bg,
                density_activ, noise, want_prob, compute_dtype, *params):
        out, dcenter, dray, grads, prob = launch_rm_train(
            mlp, center.detach().contiguous(), ray.detach().contiguous(),
            depth, target8, w3, wv, bg, density_activ, noise, want_prob, compute_dtype)
        _count(fused_render_rays_pe_train, "launches", compute_dtype)
        ctx.save_for_backward(dcenter, dray, *grads)
        if prob is None:
            prob = out.new_empty(0)
        ctx.mark_non_differentiable(out, prob)
        return sq_sum_from_out(out, target8, bg), out, prob

    @staticmethod
    def backward(ctx, g_sq, g_out, g_prob):
        dcenter, dray, *grads = ctx.saved_tensors
        return ((dcenter * g_sq, dray * g_sq) + (None,) * (_RmTrain.N_LEADING - 2)
                + tuple(g * g_sq for g in grads))


class _RmFwd(torch.autograd.Function):
    """out [R,8] from one K3 launch that keeps its activations; the backward
    is one K4 launch on the same K2Weights, without the weight-gradient part
    when no weight needs a gradient."""

    N_LEADING = 8   # arguments before *params

    @staticmethod
    def forward(ctx, center, ray, depth, w3, wv, mlp, density_activ, compute_dtype, *params):
        c, r = center.detach().contiguous(), ray.detach().contiguous()
        out, cache, packed = _rm_fwd(mlp, c, r, depth, w3, wv, density_activ, True,
                                     compute_dtype)
        _count(fused_render_rays_pe, "launches", compute_dtype)
        ctx.save_for_backward(c, r, depth, w3, wv, cache)
        ctx.mlp, ctx.packed, ctx.density_activ = mlp, packed, density_activ
        ctx.compute_dtype = compute_dtype
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        c, r, depth, w3, wv, cache = ctx.saved_tensors
        want_dw = any(ctx.needs_input_grad[_RmFwd.N_LEADING:])
        dcenter, dray, grads = launch_rm_bwd(
            ctx.mlp, c, r, depth, g_out.contiguous(), w3, wv, cache, ctx.packed,
            want_dw, ctx.density_activ)
        _count(fused_render_rays_pe, "backward_launches", ctx.compute_dtype)
        n_params = len(ctx.needs_input_grad) - _RmFwd.N_LEADING
        return ((dcenter, dray) + (None,) * (_RmFwd.N_LEADING - 2)
                + (tuple(grads) if want_dw else (None,) * n_params))


# ------------------------------------------------------------------ wrappers

def _split(out, B, R_img, setbg_opaque, bgcolor):
    rgb = out[:, :3].reshape(B, R_img, 3)
    depth = out[:, 3:4].reshape(B, R_img, 1)
    opacity = out[:, 4:5].reshape(B, R_img, 1)
    if setbg_opaque:
        rgb = rgb + bgcolor * (1 - opacity)
    return rgb, depth, opacity


def fused_render_rays_pe(mlp, center, ray, depth, *, progress=None,
                         barf_c2f=None, setbg_opaque=False, bgcolor=None,
                         density_activ="softplus", compute_dtype="float32"):
    """Composited forward render (K3). center/ray [B,R,3]; depth [B,R,K,1]
    sorted ascending. Returns (rgb [B,R,3], depth [B,R,1], opacity [B,R,1]),
    differentiable in center, ray and the weights: on CUDA, where grad is
    enabled and one of them requires it, K3 keeps its activations and the
    backward runs K4. The background colour is composited here, outside the
    kernels, so autograd carries its term into K4's opacity cotangent."""
    compute_dtype = resolve_compute_dtype(compute_dtype)
    B, R_img, K = depth.shape[0], depth.shape[1], depth.shape[2]
    c = center.reshape(B * R_img, 3)
    r = ray.reshape(B * R_img, 3)
    d = depth.detach().reshape(B * R_img, K)
    if not c.is_cuda:
        out = render_rays_plain(mlp, c, r, d, progress, barf_c2f, density_activ,
                                compute_dtype)
        return _split(out, B, R_img, setbg_opaque, bgcolor)
    w3, wv = band_weights(progress, barf_c2f, c.device)
    if torch.is_grad_enabled() and (c.requires_grad or r.requires_grad or any(
            p.requires_grad for p in mlp.parameters())):
        out = _RmFwd.apply(c, r, d.contiguous(), w3, wv, mlp, density_activ, compute_dtype,
                           *mlp.parameters())
    else:
        out = launch_rm_fwd(mlp, c.contiguous(), r.contiguous(), d.contiguous(),
                            w3, wv, density_activ, compute_dtype)
        _count(fused_render_rays_pe, "launches", compute_dtype)
    return _split(out, B, R_img, setbg_opaque, bgcolor)


fused_render_rays_pe.launches = 0             # K3 launches
fused_render_rays_pe.backward_launches = 0    # K4 launches
fused_render_rays_pe.bf16_launches = 0            # K3 launches under bfloat16
fused_render_rays_pe.bf16_backward_launches = 0   # K4 launches under bfloat16


def fused_render_rays_pe_train(mlp, center, ray, depth, target, *,
                               progress=None, barf_c2f=None,
                               setbg_opaque=False, bgcolor=None,
                               density_activ="softplus", noise=None,
                               want_prob=False, compute_dtype="float32"):
    """Training render + MSE (K2). center/ray [B,R,3]; depth [B,R,K,1]
    sorted ascending; target [B,R,3]; noise [B,R,K]: the density-noise
    draw, already scaled, optional. Returns (out_dict, sq_sum, n_terms):
    out_dict's rgb/depth/opacity are detached (metrics only); sq_sum / n_terms
    is the photometric MSE, differentiable in center, ray and the weights.
    With ``want_prob`` out_dict also holds ``prob`` [B,R,K], the per-sample
    compositing weights, detached: what a fine-sampling step resamples from."""
    compute_dtype = resolve_compute_dtype(compute_dtype)
    B, R_img, K = depth.shape[0], depth.shape[1], depth.shape[2]
    n_rays = B * R_img
    c = center.reshape(n_rays, 3)
    r = ray.reshape(n_rays, 3)
    d = depth.detach().reshape(n_rays, K).contiguous()
    t = target.detach().reshape(n_rays, 3)
    target8 = torch.cat([t, torch.ones_like(t[:, :1]),
                         torch.zeros_like(t[:, :1]).expand(n_rays, 4)], dim=1)
    bg = float(bgcolor) if setbg_opaque else None
    if noise is not None:
        noise = noise.detach().reshape(n_rays, K).contiguous()
    if not c.is_cuda:
        sq, out, *prob = render_rays_train_plain(
            mlp, c, r, d, target8, progress, barf_c2f, bg, density_activ, noise,
            want_prob, compute_dtype)
    else:
        w3, wv = band_weights(progress, barf_c2f, c.device)
        sq, out, *prob = _RmTrain.apply(
            c, r, d, target8.contiguous(), w3, wv, mlp, bg, density_activ, noise,
            want_prob, compute_dtype, *mlp.parameters())
    rgb, depth_out, opacity = _split(out.detach(), B, R_img, setbg_opaque,
                                     bgcolor)
    out_dict = dict(rgb=rgb, depth=depth_out, opacity=opacity)
    if want_prob:
        out_dict["prob"] = prob[0].reshape(B, R_img, K)
    return out_dict, sq, float(n_rays * 3)


fused_render_rays_pe_train.launches = 0
fused_render_rays_pe_train.bf16_launches = 0   # K2 launches under bfloat16
fused_render_rays_pe_train.packs = 0   # K2Weights made (once per parameter version)


# ------------------------------------------------ K5: the field per sample

def field_samples_plain(mlp, center, ray, depth, progress=None, barf_c2f=None,
                        density_activ="softplus", noise=None):
    """K5's plain version: PE -> MLP on flat rays. center/ray [R,3]; depth
    [R,K]; noise [R,K] optional -> [R*K,4] = (rgb, density)."""
    rgb, dens = apply_nerf_samples(mlp, center, ray, depth.detach()[..., None],
                                   progress=progress, barf_c2f=barf_c2f,
                                   density_activ=density_activ, noise=noise)
    return torch.cat([rgb, dens[..., None]], dim=-1).reshape(-1, 4)


def field_launch_fwd(symbol, mlp, head, tensors, N, K, density_activ, keep):
    """One forward launch of a per-sample field kernel: ``symbol`` is
    ``niw_field_pe`` (K5) or ``niw_field`` (K1), ``head`` its arguments ahead
    of the weights, ``tensors`` the operands to check. The weights are K2's
    (``k2_weights``): the split pointers for a render, the fp32 ones for a
    forward that keeps its activations. Returns (out [N,4], workspace,
    K2Weights); with ``keep`` the workspace holds every layer's activations,
    for the backward launch."""
    _check_inputs(mlp, tensors, K)
    lib = build.load_library().lib
    packed = k2_weights(mlp)
    device = tensors[0].device
    out = torch.empty((N, 4), dtype=torch.float32, device=device)
    ws = torch.empty(getattr(lib, symbol + "_fwd_workspace_floats")(N, int(keep)),
                     dtype=torch.float32, device=device)
    err = getattr(lib, symbol + "_fwd")(
        *head, packed.ptrs, packed.split_ptrs, packed.lo, _activ(density_activ), int(keep),
        out.data_ptr(), ws.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    build.check(err, symbol + "_fwd")
    return out, ws, packed


def field_launch_bwd(symbol, mlp, head, tensors, g, cache, packed, N, K, grad_shapes,
                     want_dw, density_activ):
    """One backward launch of a per-sample field kernel: the cotangent g
    [N,4] with the activation ``cache`` and the weights ``packed``
    (K2Weights) of the forward launch that kept them -> (the two input
    gradients of ``grad_shapes``, grads of ``mlp.parameters()`` or None
    without ``want_dw``)."""
    _check_inputs(mlp, tensors + [g, cache, packed.planes], K)
    lib = build.load_library().lib
    if (g.shape != (N, 4)
            or cache.numel() != getattr(lib, symbol + "_fwd_workspace_floats")(N, 1)):
        raise ValueError("cotangent must be [N,4] and the cache that of a kept "
                         "forward launch on the same samples")
    dws = _grad_buffers(packed, g.device) if want_dw else []
    d_a, d_b = (torch.empty(shape, dtype=torch.float32, device=g.device)
                for shape in grad_shapes)
    ws = torch.empty(getattr(lib, symbol + "_bwd_workspace_floats")(N),
                     dtype=torch.float32, device=g.device)
    err = getattr(lib, symbol + "_bwd")(
        *head, packed.split_ptrs, packed.lo, _activ(density_activ), cache.data_ptr(),
        int(want_dw), d_a.data_ptr(), d_b.data_ptr(), _ptrs(dws) if want_dw else None,
        ws.data_ptr(), torch.cuda.current_stream(g.device).cuda_stream)
    build.check(err, symbol + "_bwd")
    return d_a, d_b, unpack_grads(dws) if want_dw else None


def _check_noise(noise, shape):
    if noise is not None and noise.shape != shape:
        raise ValueError("noise must be {}, one value per sample: {}".format(
            list(shape), list(noise.shape)))
    return [] if noise is None else [noise]


def launch_field_pe_fwd(mlp, center, ray, depth, w3, wv, density_activ="softplus",
                        noise=None, keep=False):
    """One K5 forward launch on CUDA tensors: center/ray [R,3], depth [R,K],
    noise [R,K] or None. Returns (out [R*K,4], workspace, K2Weights)."""
    R, K = depth.shape
    tensors = [center, ray, depth, w3, wv] + _check_noise(noise, (R, K))
    head = (center.data_ptr(), ray.data_ptr(), depth.data_ptr(),
            None if noise is None else noise.data_ptr(), R, K, w3.data_ptr(),
            wv.data_ptr())
    return field_launch_fwd("niw_field_pe", mlp, head, tensors, R * K, K, density_activ,
                            keep)


def launch_field_pe_bwd(mlp, center, ray, depth, g, w3, wv, cache, packed,
                        want_dw=True, density_activ="softplus"):
    """One K5 backward launch: g [R*K,4], with the ``cache`` and the
    K2Weights ``packed`` of the kept forward launch -> (dcenter, dray [R,3],
    grads of ``mlp.parameters()`` or None without ``want_dw``)."""
    R, K = depth.shape
    head = (center.data_ptr(), ray.data_ptr(), depth.data_ptr(), g.data_ptr(), R, K,
            w3.data_ptr(), wv.data_ptr())
    return field_launch_bwd("niw_field_pe", mlp, head, [center, ray, depth, w3, wv], g,
                            cache, packed, R * K, K, [(R, 3), (R, 3)], want_dw,
                            density_activ)


class _FieldSamples(torch.autograd.Function):
    """out [N,4] of a per-sample field kernel (K5 or K1) from one forward
    launch that keeps its activations (the noised density pre-activation
    among them); the backward is one backward launch on the same K2Weights,
    without the weight-gradient part when no weight needs a gradient. ``a``
    and ``b`` are the kernel's two differentiable inputs; ``fwd(a, b,
    keep)`` and ``bwd(a, b, g, cache, packed, want_dw)`` launch it with its
    other operands bound; ``wrapper`` carries the launch counts."""

    N_LEADING = 5   # arguments before *params

    @staticmethod
    def forward(ctx, a, b, fwd, bwd, wrapper, *params):
        a, b = a.detach().contiguous(), b.detach().contiguous()
        out, cache, packed = fwd(a, b, True)
        wrapper.launches += 1
        ctx.save_for_backward(a, b, cache)
        ctx.bwd, ctx.wrapper, ctx.packed = bwd, wrapper, packed
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        a, b, cache = ctx.saved_tensors
        want_dw = any(ctx.needs_input_grad[_FieldSamples.N_LEADING:])
        d_a, d_b, grads = ctx.bwd(a, b, g_out.contiguous(), cache, ctx.packed, want_dw)
        ctx.wrapper.backward_launches += 1
        n_params = len(ctx.needs_input_grad) - _FieldSamples.N_LEADING
        return ((d_a, d_b) + (None,) * (_FieldSamples.N_LEADING - 2)
                + (tuple(grads) if want_dw else (None,) * n_params))


def run_field_kernel(wrapper, mlp, a, b, fwd, bwd):
    """A per-sample field kernel on CUDA inputs ``a``, ``b``: where grad is
    enabled and an input or a weight requires it, through the autograd
    Function; else one forward launch that keeps nothing."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad or any(
            p.requires_grad for p in mlp.parameters())):
        return _FieldSamples.apply(a, b, fwd, bwd, wrapper, *mlp.parameters())
    out = fwd(a.contiguous(), b.contiguous(), False)[0]
    wrapper.launches += 1
    return out


def fused_apply_nerf_samples_pe(mlp, center, ray, depth, *, progress=None,
                                barf_c2f=None, density_activ="softplus",
                                noise=None, compute_dtype="float32"):
    """The field along rays with the PE inside (K5). center/ray [B,R,3];
    depth [B,R,K,1]; noise [B,R,K]: the density-noise draw, already scaled,
    optional. Returns (rgb [B,R,K,3], density [B,R,K]), differentiable in
    center, ray and the weights (not in depth): on CUDA, where grad is
    enabled and one of them requires it, the forward keeps its activations
    and the backward is a second kernel launch. ``compute_dtype``
    "bfloat16" raises NotImplementedError (no bf16 K5 yet)."""
    refuse_bf16(compute_dtype, "K5 (the per-sample field kernel)")
    B, R_img, K = depth.shape[0], depth.shape[1], depth.shape[2]
    c = center.reshape(B * R_img, 3)
    r = ray.reshape(B * R_img, 3)
    d = depth.detach().reshape(B * R_img, K).contiguous()
    if noise is not None:
        noise = noise.detach().reshape(B * R_img, K).contiguous()
    if not c.is_cuda:
        out = field_samples_plain(mlp, c, r, d, progress, barf_c2f, density_activ,
                                  noise)
    else:
        w3, wv = band_weights(progress, barf_c2f, c.device)
        out = run_field_kernel(
            fused_apply_nerf_samples_pe, mlp, c, r,
            lambda c, r, keep: launch_field_pe_fwd(mlp, c, r, d, w3, wv, density_activ,
                                                   noise, keep),
            lambda c, r, g, cache, packed, want_dw: launch_field_pe_bwd(
                mlp, c, r, d, g, w3, wv, cache, packed, want_dw, density_activ))
    return out[:, :3].reshape(B, R_img, K, 3), out[:, 3].reshape(B, R_img, K)


fused_apply_nerf_samples_pe.launches = 0             # K5 forward launches
fused_apply_nerf_samples_pe.backward_launches = 0    # K5 backward launches
