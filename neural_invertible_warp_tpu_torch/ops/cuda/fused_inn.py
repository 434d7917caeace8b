"""The INN warp's three coupling blocks as one CUDA kernel per direction
(K6), with its plain PyTorch version (port of
neural_invertible_warp_tpu/ops/pallas/fused_inn.py: ``fused_deform`` with its
VJP, ``supports``, ``_row_windows`` and ``fused_deform_forward``).

The kernel's contract, which ``fused_deform_plain`` repeats op for op:

    pts    [B,N,3]      points, image-major
    rw1    [N]          the reference row window of a 1-D embedding
    rw2    [N]          ... of a 2-D embedding (both shared by the images)
    codes  [3,B,d_feat] the per-block latent codes ``lin{b}_c(code) + code``
    leaves 30 tensors   per block, branch a then b: the raw ``weight_v``
                        [128, n_emb + d_feat], ``weight_g`` [128,1] and
                        ``bias`` [128] of the weight-normalized first layer
                        (n_emb 26 for a, 13 for b) and ``weight`` [n_out,128]
                        and ``bias`` [n_out] of the output layer (n_out 1, 3)
    ->     [B,N,3]

Per block: W = v * g / max(|v|_row, 1e-12); s = MLP_a on the embedding of the
two other coordinates, focus' = focus - s; (theta, t) = MLP_b on the
embedding of focus'; other' = R(-theta) (other - t). The embedding is
full-frequency in its own column order [x, sin(f_0 x), cos(f_0 x), ...]; the
row window scales the embed part of a first layer's pre-activation only,
never the latent part; the latent part is the same for every point of an
image. The backward returns gradients for pts, codes and the 30 leaves, none
for the row windows. The ``lin{b}_c`` projection stays PyTorch under
autograd.

The wrapper takes the plain version only for CPU tensors. For CUDA tensors
it launches the kernel or raises. Source: ``csrc/inn.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from ..posenc import full_embed, reference_row_window
from . import build

MULTIRES = 6
D_HID = 128
N_BLOCKS = 3
# (focus_axis, other_axes) per block (ops/inn.py::_AXES for three blocks)
_BLOCK_AXES = [(2, (0, 1)), (1, (0, 2)), (0, (1, 2))]


def uncovered(net):
    """The settings of this DeformNetwork that the kernel does not cover, as
    "name=value (kernel: value)" strings; empty for the paper's
    configuration (reference anneal, softplus, multires 6, three blocks, one
    128-wide hidden layer per branch)."""
    have = dict(anneal=net.anneal, actfn=net.actfn, multires=net.multires,
                n_blocks=net.n_blocks, n_layers=net.n_layers,
                d_hidden=net.lin0_a_0.bias.shape[0])
    want = dict(anneal="reference", actfn="softplus", multires=MULTIRES,
                n_blocks=N_BLOCKS, n_layers=1, d_hidden=D_HID)
    return ["{}={} (kernel: {})".format(k, have[k], want[k])
            for k in want if have[k] != want[k]]


def supports(net):
    """Whether the kernel covers this DeformNetwork."""
    return not uncovered(net)


def leaves_of(net):
    """The 30 parameters the kernel reads, in its order."""
    out = []
    for b in range(N_BLOCKS):
        for branch in ("a", "b"):
            first = getattr(net, "lin{}_{}_0".format(b, branch))
            last = getattr(net, "lin{}_{}_1".format(b, branch))
            out += [first.weight_v, first.weight_g, first.bias, last.weight, last.bias]
    return out


def block_codes(net, code):
    """[3,B,d_feat]: each block's residual latent projection of code [B,d_feat]."""
    return torch.stack([getattr(net, "lin{}_c".format(b))(code) + code
                        for b in range(N_BLOCKS)])


def row_windows(N, alpha_ratio, device):
    """(rw1, rw2) [N] each: the reference's point-axis window for the 1-D and
    the 2-D embedding. No gradient."""
    with torch.no_grad():
        return (reference_row_window(N, 1, MULTIRES, alpha_ratio, device=device),
                reference_row_window(N, 2, MULTIRES, alpha_ratio, device=device))


# ------------------------------------------------------------ plain version

def _softplus100(x):
    return torch.logaddexp(100.0 * x, torch.zeros_like(x)) / 100.0


def _branch_plain(x, rw, code, v, g, b0, w1, b1):
    norm = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
    W = v * (g / torch.clamp(norm, min=1e-12))                      # [128, n_in]
    emb = full_embed(x, MULTIRES)
    n_emb = emb.shape[-1]
    pre = (rw[:, None] * (emb @ W[:, :n_emb].t())
           + (code @ W[:, n_emb:].t() + b0)[:, None, :])
    return _softplus100(pre) @ w1.t() + b1


def fused_deform_plain(pts, rw1, rw2, codes, leaves):
    """K6's plain version on the kernel's operands (see the module
    docstring); differentiable by autograd."""
    x = pts
    for i, (fx, (oa, ob)) in enumerate(_BLOCK_AXES):
        la, lb = leaves[10 * i:10 * i + 5], leaves[10 * i + 5:10 * i + 10]
        other = torch.stack([x[..., oa], x[..., ob]], dim=-1)
        focus = x[..., fx:fx + 1] - _branch_plain(other, rw2, codes[i], *la)
        out = _branch_plain(focus, rw1, codes[i], *lb)               # [B,N,3]
        c, s = torch.cos(out[..., 0]), torch.sin(out[..., 0])
        u0, u1 = other[..., 0] - out[..., 1], other[..., 1] - out[..., 2]
        cols = [None, None, None]
        cols[fx] = focus[..., 0]
        cols[oa] = c * u0 + s * u1
        cols[ob] = -s * u0 + c * u1
        x = torch.stack(cols, dim=-1)
    return x


# ---------------------------------------------------------------- launches

def _check(tensors, B, N, d_feat, leaves):
    dev = tensors[0].device
    for t in tensors + list(leaves):
        if (not t.is_cuda or t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("kernel inputs and weights must be contiguous "
                             "float32 on one CUDA device")
    if B < 1 or N < 1 or d_feat < 1:
        raise ValueError("the warp kernel needs B, N, d_feat >= 1: {} {} {}".format(
            B, N, d_feat))
    shapes = []
    for _ in range(N_BLOCKS):
        for n_emb, n_out in ((26, 1), (13, 3)):
            shapes += [(D_HID, n_emb + d_feat), (D_HID, 1), (D_HID,), (n_out, D_HID),
                       (n_out,)]
    if len(leaves) != len(shapes) or any(tuple(l.shape) != s
                                         for l, s in zip(leaves, shapes)):
        raise ValueError("the warp kernel covers three blocks of one {}-wide hidden "
                         "layer per branch at multires {}".format(D_HID, MULTIRES))


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def launch_inn_fwd(pts, rw1, rw2, codes, leaves):
    """One K6 forward launch on CUDA tensors. Returns (out [B,N,3], prep):
    ``prep`` holds the column scales g / |v|, the norms, the per-image
    first-layer biases, the scaled embed rows of the first layers and, per
    point, each block's output and (theta, t0, t1), which the backward
    launch reads."""
    B, N = pts.shape[0], pts.shape[1]
    d_feat = codes.shape[-1]
    if (pts.shape != (B, N, 3) or rw1.shape != (N,) or rw2.shape != (N,)
            or codes.shape != (N_BLOCKS, B, d_feat)):
        raise ValueError("operands must be pts [B,N,3], rw1/rw2 [N], codes [3,B,d_feat]")
    _check([pts, rw1, rw2, codes], B, N, d_feat, leaves)
    lib = build.load_library().lib
    out = torch.empty_like(pts)
    prep = torch.empty(lib.niw_inn_prep_floats(B, N), dtype=torch.float32, device=pts.device)
    err = lib.niw_inn_fwd(pts.data_ptr(), rw1.data_ptr(), rw2.data_ptr(), codes.data_ptr(),
                          B, N, d_feat, _ptrs(leaves), prep.data_ptr(), out.data_ptr(),
                          torch.cuda.current_stream(pts.device).cuda_stream)
    build.check(err, "niw_inn_fwd")
    return out, prep


def launch_inn_bwd(pts, rw1, rw2, codes, leaves, prep, g):
    """One K6 backward launch: the cotangent g [B,N,3] -> (dpts [B,N,3],
    dcodes [3,B,d_feat], gradients of the 30 leaves)."""
    B, N = pts.shape[0], pts.shape[1]
    d_feat = codes.shape[-1]
    _check([pts, rw1, rw2, codes, prep, g], B, N, d_feat, leaves)
    lib = build.load_library().lib
    if g.shape != pts.shape or prep.numel() != lib.niw_inn_prep_floats(B, N):
        raise ValueError("cotangent must be [B,N,3] and prep that of the forward launch")
    dpts = torch.empty_like(pts)
    dcodes = torch.empty_like(codes)
    dleaves = [torch.empty_like(l) for l in leaves]
    ws = torch.empty(lib.niw_inn_bwd_workspace_floats(B, N), dtype=torch.float32,
                     device=pts.device)
    err = lib.niw_inn_bwd(pts.data_ptr(), rw1.data_ptr(), rw2.data_ptr(), codes.data_ptr(),
                          g.data_ptr(), B, N, d_feat, _ptrs(leaves), prep.data_ptr(),
                          dpts.data_ptr(), dcodes.data_ptr(), _ptrs(dleaves), ws.data_ptr(),
                          torch.cuda.current_stream(pts.device).cuda_stream)
    build.check(err, "niw_inn_bwd")
    return dpts, dcodes, dleaves


class _FusedDeform(torch.autograd.Function):
    """out [B,N,3] from one K6 forward launch; the backward is one K6
    backward launch, which reads the blocks' outputs the forward kept."""

    @staticmethod
    def forward(ctx, pts, rw1, rw2, codes, *leaves):
        pts, codes = pts.detach().contiguous(), codes.detach().contiguous()
        leaves = [l.detach().contiguous() for l in leaves]
        out, prep = launch_inn_fwd(pts, rw1, rw2, codes, leaves)
        fused_deform_forward.launches += 1
        ctx.save_for_backward(pts, rw1, rw2, codes, prep, *leaves)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        pts, rw1, rw2, codes, prep, *leaves = ctx.saved_tensors
        dpts, dcodes, dleaves = launch_inn_bwd(pts, rw1, rw2, codes, leaves, prep,
                                               g.contiguous())
        fused_deform_forward.backward_launches += 1
        return (dpts, None, None, dcodes) + tuple(dleaves)


def fused_deform_forward(net, code, pts, alpha_ratio):
    """Drop-in for ``DeformNetwork.forward`` on a network that ``supports``
    accepts: K6 on CUDA tensors, the plain version on CPU tensors. code
    [B,d_feat]; pts [B,N,3] -> [B,N,3], differentiable in code, pts and the
    network's parameters."""
    if not supports(net):
        raise ValueError("the warp kernel covers the paper's configuration only; "
                         "this network has " + ", ".join(uncovered(net))
                         + ". Turn tpu.fused_inn off for it")
    rw1, rw2 = row_windows(pts.shape[1], alpha_ratio, pts.device)
    codes, leaves = block_codes(net, code), leaves_of(net)
    if not pts.is_cuda:
        return fused_deform_plain(pts, rw1, rw2, codes, leaves)
    return _FusedDeform.apply(pts, rw1, rw2, codes, *leaves)


fused_deform_forward.launches = 0             # K6 forward launches
fused_deform_forward.backward_launches = 0    # K6 backward launches
