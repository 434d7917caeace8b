"""The reduction orders of K6 (csrc/inn.cu) and K7 (csrc/correlation.cu),
emulated in float32 on the CPU.

The CUDA kernels run only on the card; these tests repeat, with plain
PyTorch float32 operations, the orders in which the kernels add: where the
order is what changes between two correct kernels, the gates of
``chip_smoke.py`` must hold for it. Inputs are made with numpy from a seed.

K6: the warp's output layer (per lane 4 units in order, then the xor
butterfly over 32 lanes), the input cotangent (per lane each column's 4
units, times the column's chain factor, per coordinate in column order, then
the butterfly), and the weight gradients (a 16-point tile in point order, a
CTA's tiles in order; then over the CTAs of each image and of all images,
each lane every 32nd CTA in order and the butterfly; the latent rows and db0
from the per-image sums, the images in order; the output-bias gradients db1
in that order in double, rounded to fp32 once). At the
flagship warp shape [18,226,3] x 128 latent dims with the smoke's
perturbation (0.05 randn on every leaf), against the kernel's plain version
``fused_deform_plain`` under sum(sin(3 out)) and under sum(out), with the
smoke's gates: values 1e-5 of the max, every gradient leaf 2e-4 relative L2
(the six output biases against the L2 norm of their sums of |terms|, taken
from a float64 evaluation); the distance of both from float64 is printed.

K6's entry points through a fake library: ``launch_inn_fwd`` sizes the prep
buffer (which now also holds the forward's kept state) from
``niw_inn_prep_floats(B, N)`` and the backward hands the same buffer back;
the gradients land on pts, the codes and the 30 leaves.

K7: the plans of the kernels (a copy of ``fwd_plan`` and ``adj_plan``)
cover every output exactly once at PDC-Net's shapes and a ragged one, and
launch more CTAs than the first design; where the forward splits the
channels over KS slices of a CTA (each slice every KS-th chunk of 4
channels in channel order, the slices added in slice order), the emulated
sums stay within 1e-5 of the max of the plain version.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

import chip_smoke
from neural_invertible_warp_tpu_torch.ops import correlation as plain_corr
from neural_invertible_warp_tpu_torch.ops import inn
from neural_invertible_warp_tpu_torch.ops.cuda import fused_inn as fi
from neural_invertible_warp_tpu_torch.ops.posenc import full_embed

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

# ------------------------------------------------------------------- K6
LANES, UPL, PT, N_SM = 32, 4, 16, 132      # csrc/inn.cu: lanes, units per lane, tile, SMs
BWD_MINB = 3                               # csrc/inn.cu: backward CTAs per SM
TOL_VALUE, TOL_GRAD = 1e-5, 2e-4           # chip_smoke.py: TOL["value"], TOL_INN_GRAD_REL_L2
FLAGSHIP = (18, 226, 128)                  # images, points per image, latent dims
ALPHA = 0.37


def _seq(x, dim):
    """x added left to right along dim."""
    x = x.movedim(dim, 0)
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def _butterfly(x):
    """Lane values x[..., 32] after the xor butterfly (offsets 16, 8, ..., 1)."""
    for off in (16, 8, 4, 2, 1):
        x = x[..., :off] + x[..., off:2 * off]
    return x[..., 0]


def _lanes(x):
    """[..., 128] per unit -> [..., 32] per lane: each lane's 4 units in order."""
    return _seq(x.reshape(x.shape[:-1] + (LANES, UPL)), -1)


def _ctas_per_image(B, N):
    return max(1, min(-(-N // PT), BWD_MINB * N_SM // B))


def _cta_sum(parts):
    """Partials [T, ...] of T backward CTAs, added as the epilogue adds them:
    lane l adds CTAs l, l + 32, ... in order, then the butterfly."""
    T = parts.shape[0]
    pad = torch.zeros((-T % LANES,) + parts.shape[1:], dtype=parts.dtype)
    lanes = _seq(torch.cat([parts, pad]).reshape((-1, LANES) + parts.shape[1:]), 0)
    return _butterfly(lanes.movedim(0, -1))


def _tree(x, cpi):
    """x [B,N,...] added as K6's backward adds a weight gradient: each CTA's
    16-point tiles in point order, its tiles (c, c + cpi, ...) in order; then
    the CTAs by _cta_sum, of each image and of all. (per-image sums, total)."""
    B, N = x.shape[:2]
    T = -(-N // PT)
    pad = torch.zeros((B, T * PT - N) + x.shape[2:], dtype=x.dtype)
    tiles = _seq(torch.cat([x, pad], 1).reshape((B, T, PT) + x.shape[2:]), 2)
    ctas = torch.stack([_seq(tiles[:, c::cpi], 1) for c in range(cpi)], 1)
    per_image = torch.stack([_cta_sum(ctas[b]) for b in range(B)])
    return per_image, _cta_sum(ctas.reshape((B * cpi,) + ctas.shape[2:]))


def _chain(e, D):
    """Each embed column's derivative factor onto its coordinate (column % D)."""
    out = torch.ones_like(e)
    for l in range(fi.MULTIRES):
        f = float(np.float32(2.0 ** l) * np.float32(np.pi))
        band = D + 2 * D * l
        for d in range(D):
            out[..., band + d] = f * e[..., band + D + d]
            out[..., band + D + d] = -f * e[..., band + d]
    return out


def _prep(v, g, b0, code, ne):
    norm = torch.clamp(torch.sqrt((v * v).sum(1)), min=1e-12)
    scale = g.reshape(-1) / norm
    return norm, scale, v[:, :ne] * scale[:, None], (code @ v[:, ne:].t()) * scale + b0


def _branch_forward(u, rw, W, cb, w1, b1):
    e = full_embed(u, fi.MULTIRES)
    acc = _seq(e[..., :, None] * W.t(), 2)
    pre = rw[:, None] * acc + cb[:, None, :]
    h = fi._softplus100(pre)
    out = torch.stack([_butterfly(_lanes(h * w1[c])) for c in range(w1.shape[0])], -1) + b1
    return out, (e, pre, h)


def _branch_backward(saved, rw, W, w1, dout, cpi):
    """(cotangent of the D input coordinates, dW embed rows, per-image dh
    sums, dw1, db1, sums of |dout| over the points)."""
    e, pre, h = saved
    B, N, ne = e.shape
    D = 2 if ne == 26 else 1
    dh = _seq(dout[..., :, None] * w1, 2) * torch.sigmoid(100.0 * pre)
    dE = rw[:, None] * dh
    de = _seq((dE[..., None, :] * W.t()).reshape(B, N, ne, LANES, UPL), -1)
    terms = de * _chain(e, D)[..., None]
    dcoord = torch.stack([_butterfly(_seq(terms[:, :, d::D], 2)) for d in range(D)], -1)
    dW = _tree(e[..., None, :] * dE[..., :, None], cpi)[1]
    dcb = _tree(dh, cpi)[0]
    dw1 = _tree(h[..., None, :] * dout[..., :, None], cpi)[1]
    db1 = _tree(dout.double(), cpi)[1].to(dout.dtype)
    return dcoord, dW, dcb, dw1, db1, dout.abs().sum((0, 1))


def _weight_norm_backward(v, g, norm, scale, dW, dcb, code, ne):
    lat = _seq(code[:, :, None] * dcb[:, None, :], 0)           # [d_feat, 128]
    full = torch.cat([dW, lat.t()], 1)
    t = (full * v).sum(1)
    dv = full * scale[:, None] - v * (g.reshape(-1) * t / norm ** 3)[:, None]
    return dv, (t / norm).reshape(-1, 1), _seq(dcb, 0)


def k6_emulated(pts, rw1, rw2, codes, leaves, cotangent):
    """K6 forward and backward in the kernels' orders: (out, [dpts, dcodes]
    + the 30 leaf gradients, {output-bias leaf index: L2 norm of its sums of
    |terms|}). ``cotangent(out)`` gives dL/dout."""
    B, N = pts.shape[:2]
    cpi = _ctas_per_image(B, N)
    x, saved = pts, []
    for i, (fx, (oa, ob)) in enumerate(fi._BLOCK_AXES):
        la, lb = leaves[10 * i:10 * i + 5], leaves[10 * i + 5:10 * i + 10]
        pa, pb = _prep(*la[:3], codes[i], 26), _prep(*lb[:3], codes[i], 13)
        other = torch.stack([x[..., oa], x[..., ob]], -1)
        s, sa = _branch_forward(other, rw2, pa[2], pa[3], la[3], la[4])
        focus = x[..., fx] - s[..., 0]
        o, sb = _branch_forward(focus[..., None], rw1, pb[2], pb[3], lb[3], lb[4])
        c, sn = torch.cos(o[..., 0]), torch.sin(o[..., 0])
        u0, u1 = other[..., 0] - o[..., 1], other[..., 1] - o[..., 2]
        cols = [None, None, None]
        cols[fx], cols[oa], cols[ob] = focus, c * u0 + sn * u1, -sn * u0 + c * u1
        saved.append((x, torch.stack(cols, -1), o, sa, sb, pa, pb))
        x = saved[-1][1]
    dx = cotangent(x).clone()
    grads, dcodes, terms = [None] * 30, torch.zeros_like(codes), {}
    for i in (2, 1, 0):
        xin, xout, o, sa, sb, pa, pb = saved[i]
        fx, (oa, ob) = fi._BLOCK_AXES[i]
        la, lb = leaves[10 * i:10 * i + 5], leaves[10 * i + 5:10 * i + 10]
        c, sn = torch.cos(o[..., 0]), torch.sin(o[..., 0])
        don0, don1 = dx[..., oa].clone(), dx[..., ob].clone()
        du0, du1 = c * don0 - sn * don1, sn * don0 + c * don1
        dout_b = torch.stack([don0 * xout[..., ob] - don1 * xout[..., oa], -du0, -du1], -1)
        dx[..., oa], dx[..., ob] = du0, du1
        dc_b, dW_b, dcb_b, dw1_b, db1_b, t_b = _branch_backward(sb, rw1, pb[2], lb[3], dout_b, cpi)
        dx[..., fx] = dx[..., fx] + dc_b[..., 0]
        dc_a, dW_a, dcb_a, dw1_a, db1_a, t_a = _branch_backward(
            sa, rw2, pa[2], la[3], -dx[..., fx:fx + 1], cpi)
        dx[..., oa] = dx[..., oa] + dc_a[..., 0]
        dx[..., ob] = dx[..., ob] + dc_a[..., 1]
        for k, (lv, p, dW, dcb, dw1, db1, t, ne) in enumerate((
                (la, pa, dW_a, dcb_a, dw1_a, db1_a, t_a, 26),
                (lb, pb, dW_b, dcb_b, dw1_b, db1_b, t_b, 13))):
            dv, dg, db0 = _weight_norm_backward(lv[0], lv[1], p[0], p[1], dW, dcb, codes[i], ne)
            base = 10 * i + 5 * k
            grads[base:base + 5] = [dv, dg, db0, dw1, db1]
            terms[base + 4] = float(torch.linalg.norm(t))
        # per branch the units in order, then branch a + branch b
        dcodes[i] = (_seq((dcb_a * pa[1])[:, :, None] * la[0][:, 26:], 1)
                     + _seq((dcb_b * pb[1])[:, :, None] * lb[0][:, 13:], 1))
    return x, [dx, dcodes] + grads, terms


def _k6_operands(dtype=torch.float32):
    B, N, d_feat = FLAGSHIP
    rng = np.random.RandomState(100)
    net = inn.DeformNetwork(d_feat, d_hidden=128, n_blocks=3, n_layers=1, multires=6,
                            generator=torch.Generator().manual_seed(100))
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.tensor(0.05 * rng.randn(*p.shape), dtype=torch.float32))
    code = torch.tensor(rng.randn(B, d_feat), dtype=torch.float32)
    pts = torch.tensor(rng.randn(B, N, 3), dtype=torch.float32)
    rw1, rw2 = fi.row_windows(N, ALPHA, "cpu")
    with torch.no_grad():
        codes = fi.block_codes(net, code)
    leaves = [l.detach().clone() for l in fi.leaves_of(net)]
    return [t.to(dtype) for t in (pts, rw1, rw2, codes)], [l.to(dtype) for l in leaves]


def _plain_grads(ops, leaves, loss):
    pts, rw1, rw2, codes = ops
    p = pts.clone().requires_grad_(True)
    c = codes.clone().requires_grad_(True)
    ls = [l.clone().requires_grad_(True) for l in leaves]
    out = fi.fused_deform_plain(p, rw1, rw2, c, ls)
    total = torch.sin(3.0 * out).sum() if loss == "sin" else out.sum()
    return out.detach(), list(torch.autograd.grad(total, [p, c] + ls))


def _cotangent(loss):
    return (lambda out: 3.0 * torch.cos(3.0 * out)) if loss == "sin" else torch.ones_like


def _rel(got, ref, denom=None):
    err = float(torch.linalg.norm((got - ref).double()))
    return err / max(denom if denom is not None else float(torch.linalg.norm(ref.double())), 1e-30)


@pytest.mark.parametrize("loss", ["sin", "sum"])
def test_k6_reduction_orders_meet_the_smoke_gates(loss):
    ops, leaves = _k6_operands()
    ops64, leaves64 = _k6_operands(torch.float64)
    with torch.no_grad():
        out_e, grads_e, _ = k6_emulated(*ops, leaves, _cotangent(loss))
        out_64, grads_64, terms = k6_emulated(*ops64, leaves64, _cotangent(loss))
    out_p, grads_p = _plain_grads(ops, leaves, loss)
    scale = float(out_p.abs().max())
    err = float((out_e - out_p).abs().max())
    assert err <= TOL_VALUE * scale, err / scale
    # under sum(sin(3 out)) the six output biases are cancelling sums: held
    # against the norm of their sums of |terms|; under sum(out) every leaf
    # against its own norm
    names = ["dpts", "dcodes"] + ["leaf {}".format(k) for k in range(30)]
    worst = {"plain": (0.0, ""), "emulated vs f64": (0.0, ""), "plain vs f64": (0.0, "")}
    for k, (name, ge, gp, g64) in enumerate(zip(names, grads_e, grads_p, grads_64)):
        denom = terms.get(k - 2) if loss == "sin" else None
        for key, (a, b) in (("plain", (ge, gp)), ("emulated vs f64", (ge, g64)),
                            ("plain vs f64", (gp, g64))):
            e = _rel(a.double(), b.double(), denom)
            if e >= worst[key][0]:
                worst[key] = (e, name)
    print("K6 emulated orders at [18,226,3] x 128, loss {}: out {:.2e} of max; worst leaf "
          "against the plain version {:.2e} ({}); from float64: emulated {:.2e} ({}), plain "
          "{:.2e} ({})".format(loss, err / scale, *worst["plain"], *worst["emulated vs f64"],
                               *worst["plain vs f64"]))
    assert worst["plain"][0] <= TOL_GRAD, worst["plain"]


def test_k6_tree_adds_every_point_once():
    """The tile / CTA / image tree of the weight gradients covers each point
    once, whatever the CTAs per image (the ragged last tile included)."""
    for B, N in ((18, 226), (1, 4096), (1, 7), (3, 33)):
        cpi = _ctas_per_image(B, N)
        assert 1 <= cpi <= -(-N // PT) and B * cpi <= max(B, BWD_MINB * N_SM)
        x = torch.arange(B * N, dtype=torch.float64).reshape(B, N)
        per_image, total = _tree(x, cpi)
        assert torch.equal(per_image, x.sum(1)) and float(total) == float(x.sum())


def _cancelling_terms(B, N, seed):
    """fp32 terms [B,N] (multiples of 2^-INN_SUM_BITS) whose sum is
    INN_SUM_CANCEL of the sum of their |terms| (``chip_smoke.
    inn_bias_sum_check``'s cotangent columns), and that sum, exact."""
    rng = np.random.default_rng(seed)
    units = np.round(rng.standard_normal(B * N) * 2.0 ** chip_smoke.INN_SUM_BITS)
    units -= np.floor(units.mean())
    units += np.round(chip_smoke.INN_SUM_CANCEL * np.abs(units).mean())
    terms = torch.from_numpy((units / 2.0 ** chip_smoke.INN_SUM_BITS).reshape(B, N)).float()
    return terms, units.sum() / 2.0 ** chip_smoke.INN_SUM_BITS


def _ulps(got, exact):
    ref = np.float32(exact)
    assert float(ref) == exact          # the exact sum is an fp32 number here
    return abs(float(got) - exact) / float(np.spacing(np.abs(ref)))


@pytest.mark.parametrize("B, N", [(18, 226), (1, 4096), (1, 7)])
def test_k6_output_bias_sums_are_the_exact_sum_rounded_once(B, N):
    """db1 in K6's order, added in double and rounded once, is the exact sum
    of cancelling terms at each shape of the smoke's K6 cases, as
    ``chip_smoke.inn_bias_sum_check`` holds the kernel on the card."""
    for seed in range(3):
        terms, exact = _cancelling_terms(B, N, seed)
        got = _tree(terms.double(), _ctas_per_image(B, N))[1].float()
        assert _ulps(got, exact) == 0


def test_k6_output_bias_sums_in_fp32_miss_the_cancelled_sum():
    """The same order in fp32 (K6's db1 before it was taken to double)
    misses the exact sum at the flagship warp shape by 2 ulps or more at
    every seed."""
    misses = []
    for seed in range(3):
        terms, exact = _cancelling_terms(18, 226, seed)
        misses.append(_ulps(_tree(terms, _ctas_per_image(18, 226))[1], exact))
    assert min(misses) >= 2, misses


class _FakeInnLibrary:
    """K6's C entry points on the CPU: each launch records its sizes and
    pointers; the forward writes out = pts + 1 and fills prep with 7s, the
    backward writes dpts = 2 g, dcodes = 3 and the gradient of leaf k = k."""

    def __init__(self):
        self.calls = []

    def niw_inn_prep_floats(self, B, N):
        return 6 * (2 + B + 26) * 128 + 18 * B * N

    def niw_inn_bwd_workspace_floats(self, B, N):
        return 17304 * B

    def niw_inn_fwd(self, pts, rw1, rw2, codes, B, N, d_feat, W, prep, out, stream):
        self.calls.append(("fwd", B, N, d_feat, [W[k] for k in range(30)], prep))
        _write(out, self._pts.reshape(-1) + 1.0)
        _write(prep, torch.full((self.niw_inn_prep_floats(B, N),), 7.0))
        return 0

    def niw_inn_bwd(self, pts, rw1, rw2, codes, g, B, N, d_feat, W, prep, dpts, dcodes, dW, ws,
                    stream):
        self.calls.append(("bwd", B, N, d_feat, [W[k] for k in range(30)], prep, ws))
        self.prep_seen = _read(prep, self.niw_inn_prep_floats(B, N))
        self.ws_floats = self.niw_inn_bwd_workspace_floats(B, N)
        _write(dpts, 2.0 * _read(g, B * N * 3))
        _write(dcodes, torch.full((3 * B * d_feat,), 3.0))
        for k in range(30):
            _write(dW[k], torch.full((self._sizes[k],), float(k)))
        return 0


def _write(ptr, values):
    values = values.contiguous().float()
    ctypes.memmove(ptr, values.data_ptr(), values.numel() * 4)


def _read(ptr, n):
    out = torch.empty(n)
    ctypes.memmove(out.data_ptr(), ptr, n * 4)
    return out


def test_k6_launches_pass_the_kept_state_and_gradients_land_on_the_leaves(monkeypatch):
    B, N, d_feat = 2, 5, 6
    net = inn.DeformNetwork(d_feat, d_hidden=128, n_blocks=3, n_layers=1, multires=6,
                            generator=torch.Generator().manual_seed(3))
    rng = np.random.RandomState(3)
    pts = torch.tensor(rng.randn(B, N, 3), dtype=torch.float32, requires_grad=True)
    code = torch.tensor(rng.randn(B, d_feat), dtype=torch.float32)
    rw1, rw2 = fi.row_windows(N, 0.5, "cpu")
    codes = fi.block_codes(net, code).detach().requires_grad_(True)
    leaves = fi.leaves_of(net)
    lib = _FakeInnLibrary()
    lib._pts, lib._sizes = pts.detach(), [l.numel() for l in leaves]
    monkeypatch.setattr(fi.build, "load_library", lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(fi, "_check", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    out = fi._FusedDeform.apply(pts, rw1, rw2, codes, *leaves)
    assert torch.equal(out, pts.detach() + 1.0)
    g = torch.tensor(rng.randn(B, N, 3), dtype=torch.float32)
    out.backward(g)
    (kind_f, *sizes_f, w_f, prep_f), (kind_b, *sizes_b, w_b, prep_b, _) = lib.calls
    assert (kind_f, kind_b) == ("fwd", "bwd") and sizes_f == sizes_b == [B, N, d_feat]
    # the backward reads the very buffer the forward wrote, of the new size
    assert prep_b == prep_f and torch.equal(lib.prep_seen, torch.full_like(lib.prep_seen, 7.0))
    assert w_f == w_b == [l.data_ptr() for l in leaves]
    assert torch.equal(pts.grad, 2.0 * g) and torch.equal(codes.grad, torch.full_like(codes, 3.0))
    for k, leaf in enumerate(leaves):
        assert torch.equal(leaf.grad, torch.full_like(leaf, float(k)))


# ------------------------------------------------------------------- K7
MD, D, FCC, TW, TH, ATW, ATH = 4, 9, 4, 32, 8, 32, 4   # csrc/correlation.cu
K7_SHAPES = [(1, 128, 120, 160), (1, 256, 60, 80), (1, 256, 32, 32), (1, 128, 74, 100),
             (1, 256, 37, 50), (2, 40, 13, 45)]
FIRST_DESIGN_CTAS = [150, 45, 8, 76, 20]     # 4 x 32 pixel tiles x B


def fwd_plan(B, C, H, W):
    """(DG, KS): csrc/correlation.cu::fwd_plan."""
    tiles, chunks = B * -(-W // TW) * -(-H // TH), -(-C // FCC)
    dg = 3 if tiles * (D // 3) >= N_SM else 1
    ks = 2 if tiles * (D // dg) >= N_SM else 4
    while ks > chunks:
        ks //= 2
    return dg, ks


def adj_plan(B, C, H, W):
    """Channels per CTA: csrc/correlation.cu::adj_plan."""
    tiles = B * -(-W // ATW) * -(-H // ATH)
    return 32 if tiles * -(-C // 32) >= 2 * N_SM else 16


@pytest.mark.parametrize("shape", K7_SHAPES)
def test_k7_plans_cover_every_output_once(shape):
    B, C, H, W = shape
    dg, ks = fwd_plan(*shape)
    gx, gy, gz = -(-W // TW), -(-H // TH), B * (D // dg)
    count = np.zeros((B, D * D, H, W), np.int64)
    # thread (warp w, lane) of the writing slice: row 4 w + lane // 8, pixels
    # 4 (lane % 8) .. + 3; displacement rows grp DG .. + DG - 1
    ty = np.array([4 * (t // 32) + (t % 32) // 8 for t in range(64)])
    tx = np.array([4 * (t % 8) for t in range(64)])
    for bz in range(gz):
        b, grp = divmod(bz, D // dg)
        for by in range(gy):
            for bx in range(gx):
                for p in range(4):
                    y, x = by * TH + ty, bx * TW + tx + p
                    ok = (y < H) & (x < W)
                    for i in range(dg):
                        for j in range(D):
                            np.add.at(count[b, (grp * dg + i) * D + j], (y[ok], x[ok]), 1)
    assert (count == 1).all()
    cg = adj_plan(*shape)
    ngrp = -(-C // cg)
    seen = np.zeros(C, np.int64)
    for g in range(ngrp):
        seen[g * cg:min(C, g * cg + cg)] += 1
    assert (seen == 1).all()
    ctas = (gx * gy * gz, -(-W // ATW) * -(-H // ATH) * B * ngrp)
    print("K7 {}: forward DG {} KS {} -> {} CTAs; adjoints {} channels per CTA -> {} CTAs".format(
        shape, dg, ks, ctas[0], cg, ctas[1]))
    if shape in K7_SHAPES[:5]:
        first = FIRST_DESIGN_CTAS[K7_SHAPES.index(shape)]
        assert min(ctas) > first


@pytest.mark.parametrize("shape", [(1, 256, 32, 32), (2, 40, 13, 45)])
def test_k7_channel_split_sums(shape):
    B, C, H, W = shape
    dg, ks = fwd_plan(*shape)
    assert ks > 1      # these shapes take the split
    rng = np.random.RandomState(sum(shape))
    f1 = torch.tensor(rng.randn(*shape).astype(np.float32))
    f2 = torch.tensor(rng.randn(*shape).astype(np.float32))
    f2p = torch.nn.functional.pad(f2, (MD, MD, MD, MD))
    prod = torch.stack([f1 * f2p[:, :, MD + dy:MD + dy + H, MD + dx:MD + dx + W]
                        for dy in range(-MD, MD + 1) for dx in range(-MD, MD + 1)], 1)
    chunks = -(-C // FCC)
    # slice s: chunks s, s + KS, ..., each 4 channels in order; then the slices in order
    parts = []
    for s in range(ks):
        chans = [c for k in range(s, chunks, ks) for c in range(k * FCC, min(C, k * FCC + FCC))]
        parts.append(_seq(prod[:, :, chans], 2))
    got = _seq(torch.stack(parts), 0) / C
    ref = plain_corr.local_correlation(f1, f2, MD)
    ref64 = plain_corr.local_correlation(f1.double(), f2.double(), MD)
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    print("K7 {} with KS {}: {:.2e} of max from the plain version; from float64: split {:.2e}, "
          "plain {:.2e}".format(shape, ks, err / scale,
                                float((got.double() - ref64).abs().max()) / scale,
                                float((ref.double() - ref64).abs().max()) / scale))
    assert err <= 1e-5 * scale
