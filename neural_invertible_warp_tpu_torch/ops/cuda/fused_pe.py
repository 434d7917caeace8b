"""Composited NeRF field render: the CUDA kernels K2 (train) and K3 (forward)
with their plain PyTorch versions (port of
neural_invertible_warp_tpu/ops/pallas/fused_pe.py, ``fused_render_rays_pe``
and ``fused_render_rays_pe_train``).

Both compute, per ray: the PE of center + ray * depth (BARF c2f weights
folded in), the 8x256 NeRF MLP, quadrature and alpha compositing, giving
[R,8] = (rgb, depth, opacity, 0, 0, 0). K2 also forms the photometric MSE
cotangent in-kernel and returns d(sq_sum)/d(center, ray, weights).

The wrappers take the plain version only for CPU tensors. For CUDA tensors
they launch the kernel or raise. Sources: ``csrc/rm_fwd.cu``,
``csrc/rm_train.cu``, ``csrc/nerf_field.cuh``.
"""

from __future__ import annotations

import ctypes

import torch

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


# ----------------------------------------------------------- plain versions

def render_rays_plain(mlp, center, ray, depth, progress=None, barf_c2f=None,
                      density_activ="softplus"):
    """PE -> MLP -> composite. center/ray [R,3]; depth [R,K] -> [R,8]."""
    depth4 = depth.detach()[..., None]
    rgb_s, dens = apply_nerf_samples(mlp, center, ray, depth4,
                                     progress=progress, barf_c2f=barf_c2f,
                                     density_activ=density_activ)
    rgb, d, op, _ = render.composite(ray, rgb_s, dens, depth4)
    return torch.cat([rgb, d, op, torch.zeros_like(rgb)], dim=-1)


def sq_sum_from_out(out, target8, bg=None):
    """sum over rays of valid * |rgb_final - target|^2."""
    rgb = out[:, :3]
    if bg is not None:
        rgb = rgb + bg * (1.0 - out[:, 4:5])
    return torch.sum(target8[:, 3:4] * (rgb - target8[:, :3]) ** 2)


def render_rays_train_plain(mlp, center, ray, depth, target8, progress=None,
                            barf_c2f=None, bg=None, density_activ="softplus"):
    """(sq_sum, out [R,8]) through the plain chain; gradients by autograd."""
    out = render_rays_plain(mlp, center, ray, depth, progress, barf_c2f,
                            density_activ)
    return sq_sum_from_out(out, target8, bg), out


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


def launch_rm_fwd(mlp, center, ray, depth, w3, wv, density_activ="softplus"):
    """K3 on CUDA tensors: center/ray [R,3], depth [R,K] -> out [R,8]."""
    R, K = depth.shape
    _check_inputs(mlp, [center, ray, depth, w3, wv], K)
    lib = build.load_library().lib
    weights = pack_weights(mlp)
    out = torch.empty((R, 8), dtype=torch.float32, device=depth.device)
    ws = torch.empty(lib.niw_rm_fwd_workspace_floats(R * K), dtype=torch.float32,
                     device=depth.device)
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    err = lib.niw_rm_fwd(center.data_ptr(), ray.data_ptr(), depth.data_ptr(), R, K,
                         w3.data_ptr(), wv.data_ptr(), _ptrs(weights),
                         _ACTIV[density_activ], out.data_ptr(), ws.data_ptr(),
                         stream)
    build.check(err, "niw_rm_fwd")
    return out


def launch_rm_train(mlp, center, ray, depth, target8, w3, wv, bg=None,
                    density_activ="softplus"):
    """K2 on CUDA tensors. Returns (out [R,8], dcenter, dray [R,3], grads of
    ``mlp.parameters()``), the gradients being those of sq_sum."""
    R, K = depth.shape
    _check_inputs(mlp, [center, ray, depth, target8, w3, wv], K)
    lib = build.load_library().lib
    weights = pack_weights(mlp)
    dws = [torch.empty_like(w) for w in weights]
    out = torch.empty((R, 8), dtype=torch.float32, device=depth.device)
    dcenter = torch.empty((R, 3), dtype=torch.float32, device=depth.device)
    dray = torch.empty((R, 3), dtype=torch.float32, device=depth.device)
    ws = torch.empty(lib.niw_rm_train_workspace_floats(R * K, R),
                     dtype=torch.float32, device=depth.device)
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    err = lib.niw_rm_train(center.data_ptr(), ray.data_ptr(), depth.data_ptr(),
                           target8.data_ptr(), R, K, w3.data_ptr(), wv.data_ptr(),
                           _ptrs(weights), _ACTIV[density_activ],
                           int(bg is not None), float(bg or 0.0), out.data_ptr(),
                           dcenter.data_ptr(), dray.data_ptr(), _ptrs(dws),
                           ws.data_ptr(), stream)
    build.check(err, "niw_rm_train")
    return out, dcenter, dray, unpack_grads(dws)


class _RmTrain(torch.autograd.Function):
    """sq_sum (differentiable) and out [R,8] (not) from one K2 launch; the
    backward scales the kernel's saved gradients by d(loss)/d(sq_sum)."""

    @staticmethod
    def forward(ctx, center, ray, depth, target8, w3, wv, mlp, bg,
                density_activ, *params):
        out, dcenter, dray, grads = launch_rm_train(
            mlp, center.detach().contiguous(), ray.detach().contiguous(),
            depth, target8, w3, wv, bg, density_activ)
        fused_render_rays_pe_train.launches += 1
        ctx.save_for_backward(dcenter, dray, *grads)
        ctx.mark_non_differentiable(out)
        return sq_sum_from_out(out, target8, bg), out

    @staticmethod
    def backward(ctx, g_sq, g_out):
        dcenter, dray, *grads = ctx.saved_tensors
        return ((dcenter * g_sq, dray * g_sq) + (None,) * 7
                + tuple(g * g_sq for g in grads))


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
                         density_activ="softplus"):
    """Composited forward render (K3). center/ray [B,R,3]; depth [B,R,K,1]
    sorted ascending. Returns (rgb [B,R,3], depth [B,R,1], opacity [B,R,1]).
    On CUDA it runs K3, which has no backward yet: calling it where a
    gradient is needed raises."""
    B, R_img, K = depth.shape[0], depth.shape[1], depth.shape[2]
    c = center.reshape(B * R_img, 3)
    r = ray.reshape(B * R_img, 3)
    d = depth.detach().reshape(B * R_img, K)
    if not c.is_cuda:
        out = render_rays_plain(mlp, c, r, d, progress, barf_c2f, density_activ)
        return _split(out, B, R_img, setbg_opaque, bgcolor)
    if torch.is_grad_enabled() and (c.requires_grad or r.requires_grad or any(
            p.requires_grad for p in mlp.parameters())):
        raise RuntimeError("the CUDA forward render kernel has no backward yet "
                           "(ROADMAP K4); call it under torch.no_grad()")
    w3, wv = band_weights(progress, barf_c2f, c.device)
    out = launch_rm_fwd(mlp, c.contiguous(), r.contiguous(), d.contiguous(),
                        w3, wv, density_activ)
    fused_render_rays_pe.launches += 1
    return _split(out, B, R_img, setbg_opaque, bgcolor)


fused_render_rays_pe.launches = 0


def fused_render_rays_pe_train(mlp, center, ray, depth, target, *,
                               progress=None, barf_c2f=None,
                               setbg_opaque=False, bgcolor=None,
                               density_activ="softplus"):
    """Training render + MSE (K2). center/ray [B,R,3]; depth [B,R,K,1]
    sorted ascending; target [B,R,3]. Returns (out_dict, sq_sum, n_terms):
    out_dict's rgb/depth/opacity are detached (metrics only); sq_sum / n_terms
    is the photometric MSE, differentiable in center, ray and the weights."""
    B, R_img, K = depth.shape[0], depth.shape[1], depth.shape[2]
    n_rays = B * R_img
    c = center.reshape(n_rays, 3)
    r = ray.reshape(n_rays, 3)
    d = depth.detach().reshape(n_rays, K).contiguous()
    t = target.detach().reshape(n_rays, 3)
    target8 = torch.cat([t, torch.ones_like(t[:, :1]),
                         torch.zeros_like(t[:, :1]).expand(n_rays, 4)], dim=1)
    bg = float(bgcolor) if setbg_opaque else None
    if not c.is_cuda:
        sq, out = render_rays_train_plain(mlp, c, r, d, target8, progress,
                                          barf_c2f, bg, density_activ)
    else:
        w3, wv = band_weights(progress, barf_c2f, c.device)
        sq, out = _RmTrain.apply(c, r, d, target8.contiguous(), w3, wv, mlp, bg,
                                 density_activ, *mlp.parameters())
    rgb, depth_out, opacity = _split(out.detach(), B, R_img, setbg_opaque,
                                     bgcolor)
    return dict(rgb=rgb, depth=depth_out, opacity=opacity), sq, float(n_rays * 3)


fused_render_rays_pe_train.launches = 0
