"""K2's layer GEMMs alone on one NVIDIA GPU (csrc/gemm_tc.cuh).

    python3 chip_k2_gemm.py

Builds a small library of entry points around the shipped gemm_tc.cuh and
nerf_field.cuh into build/k2_gemm/ (nvcc, sm_90a), then:
  1. checks every route against a float64 product at K2's ragged shapes
     (bias, ReLU, ReLU' mask, beta accumulate, split mode, the weight
     gradient's column sums), each output within 1e-5 of the sum of the
     |terms| of its dot product, and the columns outside N untouched;
  2. holds K2's fp32 forward route (gemm_fp32_kernel) against gemm_kernel:
     the same bits at six shapes;
  3. times one 260,352 x 256 x 256 product (K2's flagship layer: 2034 rays x
     128 samples) on each route: gemm_kernel, the fp32 route and the
     tensor-core route, as the forward, the input gradient (with its ReLU'
     mask) and the weight gradient (64 splits), beside the bounds;
  4. measures the rounding of the tensor core's own accumulation: the
     shipped route (each k-tile's products chained from zero, then an fp32
     add) against a build of the same header with the products accumulated
     in place, on a weight gradient of positive terms (4,072 samples per
     split): the mean relative error of each.
Prints the card line; exits non-zero on a failed check, and with code 2
without a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "k2_gemm")
M_FLAGSHIP = 2034 * 128
TOL = 1e-5

ENTRIES = r'''
#include "gemm_tc.cuh"
using namespace niw;

// route 0: forward (B [K, ld] weight), 1: input gradient (B [N, ld] weight,
// op(B) transposed), 2: weight gradient (A [K, lda] transposed, B [K, ldb]);
// impl 0: gemm_kernel, 1: tensor cores (B of routes 0 and 1 as hi plane with
// the lo plane b_lo floats after it), 2: K2's fp32 forward route
extern "C" int k2_gemm(int route, int impl, const float* A, int lda, const float* B, int ldb,
                       long long b_lo, float* C, int ldc, int M, int N, int K,
                       const float* bias, int relu_cols, const float* mask, int ldm, int beta,
                       int splits, int k_split, float* col_sums, void* stream) {
  GemmArgs p = gemm_args(A, lda, B, ldb, C, ldc, M, N, K);
  p.bias = bias; p.relu_cols = relu_cols; p.mask = mask; p.ldm = ldm;
  p.mask_cols = mask ? N : 0; p.beta = beta; p.k_split = k_split;
  p.c_split_stride = (long long)M * N;
  cudaStream_t s = (cudaStream_t)stream;
  if (impl == 2) return route == 0 ? Fp32Gemm().launch<false, false, true>(p, splits, s) : -1;
  if (impl == 1) {
    const TcGemm g{b_lo};
    if (route == 0) return g.launch<false, false, true>(p, splits, s);
    if (route == 1) return g.launch<false, true, true>(p, splits, s);
    return g.launch<true, false, false>(p, splits, s, col_sums);
  }
  if (col_sums) return -1;
  const SimtGemm g;
  if (route == 0) return g.launch<false, false, true>(p, splits, s);
  if (route == 1) return g.launch<false, true, true>(p, splits, s);
  return g.launch<true, false, false>(p, splits, s);
}
'''

# the k-tile chain of gemm_tc_kernel, and the same products accumulated in place
CHAIN = """        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < TC_KS; ks++) {
          mma_tf32(d, al[ks], bh[ks][j][0], bh[ks][j][1]);
          mma_tf32(d, ah[ks], bl[ks][j][0], bl[ks][j][1]);
          mma_tf32(d, ah[ks], bh[ks][j][0], bh[ks][j][1]);
        }
#pragma unroll
        for (int q = 0; q < 4; q++) acc[i][j][q] += d[q];"""
IN_PLACE = """#pragma unroll
        for (int ks = 0; ks < TC_KS; ks++) {
          mma_tf32(acc[i][j], al[ks], bh[ks][j][0], bh[ks][j][1]);
          mma_tf32(acc[i][j], ah[ks], bl[ks][j][0], bl[ks][j][1]);
          mma_tf32(acc[i][j], ah[ks], bh[ks][j][0], bh[ks][j][1]);
        }"""


def build(variant_dir=None):
    """The entry points as a shared library; with variant_dir, its
    gemm_tc.cuh in place of the shipped one."""
    from neural_invertible_warp_tpu_torch.ops.cuda import build as nb
    name = "k2_gemm_in_place" if variant_dir else "k2_gemm"
    src, so = os.path.join(OUT, name + ".cu"), os.path.join(OUT, name + ".so")
    with open(src, "w") as f:
        f.write(ENTRIES)
    inc = (["-I", variant_dir] if variant_dir else []) + ["-I", nb.CSRC]
    r = subprocess.run([nb._nvcc()] + nb.NVCC_FLAGS + inc + ["-shared", "-o", so, src],
                       capture_output=True, text=True)
    nb._check_nvcc(r.returncode, r.stdout, r.stderr)
    fn = ctypes.CDLL(so).k2_gemm
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, I, P, I, P, I, ctypes.c_longlong, P, I, I, I, I, P, I, P, I, I, I, I, P, P]
    fn.restype = I
    return fn


def planes(w):
    """[rows, cols] weight -> (hi and lo planes [2, rows * ld], ld)."""
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    ld = -(-w.shape[1] // 4) * 4
    padded = torch.nn.functional.pad(w, (0, ld - w.shape[1]))
    return torch.stack(fp.split_tf32(padded.reshape(-1))).contiguous(), ld


def stream():
    return torch.cuda.current_stream().cuda_stream


def check_route(fn, route, impl, M, N, K, g, pad=0, bias=False, relu=0, mask=False,
                beta=False, splits=1, col_sums=False):
    """One product against float64; returns the largest error over the sum
    of the |terms| and whether the columns outside N were left alone."""
    dev = torch.device("cuda")
    if route == 2:   # C[M,N] = A[K,M]^T @ G[K,N]
        A = torch.relu(torch.randn(K, M + pad, generator=g)).to(dev)
        B = torch.randn(K, -(-N // 4) * 4, generator=g).to(dev)
        ref = A[:, :M].double().t() @ B[:, :N].double()
        scale = A[:, :M].double().abs().t() @ B[:, :N].double().abs()
        b_ptr, ldb, b_lo = B, B.shape[1], 0
    else:
        A = torch.randn(M, K + pad, generator=g).to(dev)
        W = torch.randn(K, N, generator=g).to(dev) if route == 0 else torch.randn(
            N, K, generator=g).to(dev)
        prod = W.double() if route == 0 else W.double().t()
        ref, scale = A[:, :K].double() @ prod, A[:, :K].double().abs() @ prod.abs()
        if impl == 1:
            b_ptr, ldb = planes(W)
            b_lo = b_ptr.shape[1]
        else:
            b_ptr = W if impl == 0 else torch.nn.functional.pad(W, (0, -N % 4)).contiguous()
            ldb, b_lo = b_ptr.shape[1], 0
    bias_t = torch.randn(N, generator=g).to(dev) if bias else None
    mask_t = torch.randn(M, N, generator=g).to(dev) if mask else None
    ldc = N + 5
    C = torch.randn(M, ldc, generator=g).to(dev) if splits == 1 else torch.zeros(
        splits, M, N, device=dev)
    C0 = C.clone()
    k_split = K if splits == 1 else ((-(-K // splits)) + 7) // 8 * 8
    cols = torch.zeros(splits, N, device=dev) if col_sums else None
    if splits == 1:
        if bias:
            ref = ref + bias_t.double()
        if beta:
            ref = ref + C[:, :N].double()
        if relu:
            ref[:, :relu] = ref[:, :relu].clamp(min=0)
        if mask:
            ref[mask_t.double() <= 0] = 0
    err = fn(route, impl, A.data_ptr(), A.shape[1], b_ptr.data_ptr(), ldb, b_lo, C.data_ptr(),
             ldc if splits == 1 else N, M, N, K, bias_t.data_ptr() if bias else None, relu,
             mask_t.data_ptr() if mask else None, N, int(beta), splits, k_split,
             cols.data_ptr() if col_sums else None, stream())
    torch.cuda.synchronize()
    if err:
        raise AssertionError("k2_gemm route {} impl {} returned {}".format(route, impl, err))
    got = C.sum(0) if splits > 1 else C[:, :N]
    e = float(((got.double() - ref).abs() / scale.clamp(min=1e-30)).max())
    untouched = splits > 1 or bool(torch.equal(C[:, N:], C0[:, N:]))
    if col_sums:
        col_ref = B[:, :N].double().sum(0)
        e = max(e, float(((cols.double().sum(0) - col_ref).abs()
                          / B[:, :N].double().abs().sum(0)).max()))
    return e, untouched


CHECKS = [  # route, M, N, K, options
    (0, 4736, 256, 63, dict(pad=1, bias=True, relu=256)),
    (0, 1031, 257, 256, dict(bias=True, relu=256)),
    (0, 517, 256, 319, dict(pad=1, bias=True, relu=256)),
    (1, 1031, 284, 128, dict(mask=True)),
    (1, 1031, 256, 257, dict(pad=31, mask=True)),
    (1, 4736, 63, 256, dict(beta=True)),
    (2, 128, 3, 4736, dict(splits=3, col_sums=True)),
    (2, 284, 128, 9999, dict(pad=4, splits=5, col_sums=True)),
    (2, 256, 257, 8192, dict(pad=32, splits=4, col_sums=True)),
    (2, 319, 256, 20000, dict(pad=1, splits=10, col_sums=True)),
]


def main():
    if not torch.cuda.is_available():
        print("chip_k2_gemm: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(2)
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda")
    fn = build()
    g = torch.Generator(device="cpu").manual_seed(0)
    failures = []

    # 1. every route against float64
    for route, M, N, K, kw in CHECKS:
        for impl in (0, 1) if route else (0, 1, 2):
            if kw.get("col_sums") and impl == 0:
                continue
            e, untouched = check_route(fn, route, impl, M, N, K, g, **kw)
            ok = e <= TOL and untouched
            print("check: route {} impl {} M {} N {} K {}: error / sum of |terms| {:.2e}, "
                  "columns outside N untouched {}: {}".format(
                      route, impl, M, N, K, e, untouched, "ok" if ok else "FAIL"))
            if not ok:
                failures.append((route, impl, M, N, K))

    # 2. the fp32 forward route gives gemm_kernel's bits
    for M, N, K, lda, off in [(4736, 256, 63, 320, 256), (1031, 257, 256, 256, 0),
                              (1031, 128, 284, 288, 0), (517, 256, 319, 320, 0),
                              (M_FLAGSHIP, 256, 256, 256, 0), (37, 256, 63, 320, 256)]:
        A = (torch.relu(torch.randn(M * lda + off, generator=g)) * 1000).to(dev)[off:]
        W = (torch.randn(K, N, generator=g) * 0.1).to(dev)
        Wp = torch.nn.functional.pad(W, (0, -N % 4)).contiguous()
        bias = torch.randn(N, generator=g).to(dev)
        outs = []
        for impl, B in ((0, W), (2, Wp)):
            C = torch.full((M, N + 3), 7.0, device=dev)
            err = fn(0, impl, A.data_ptr(), lda, B.data_ptr(), B.shape[1], 0, C.data_ptr(),
                     N + 3, M, N, K, bias.data_ptr(), N - 1, None, 0, 0, 1, K, None, stream())
            torch.cuda.synchronize()
            check(err == 0, "k2_gemm returned {}".format(err))
            outs.append(C)
        same = torch.equal(*outs)
        print("bits: fp32 route against gemm_kernel, M {} N {} K {}: {}".format(
            M, N, K, "the same bits" if same else "FAIL"))
        if not same:
            failures.append(("bits", M, N, K))

    # 3. times at K2's flagship layer
    M = M_FLAGSHIP
    A = torch.relu(torch.randn(M, 256, generator=g)).to(dev)
    W = (torch.randn(256, 256, generator=g) * 0.06).to(dev)
    G = torch.randn(M, 256, generator=g).to(dev)
    Bp, _ = planes(W)
    C = torch.empty(M, 256, device=dev)
    part = torch.empty(64, 256, 256, device=dev)
    cols = torch.empty(64, 256, device=dev)
    flops = 2.0 * M * 256 * 256

    def run(route, impl, col_sums=None):
        B = Bp if impl == 1 and route < 2 else (G if route == 2 else W)
        a = G if route == 1 else A
        splits, k_split, out = (64, 4072, part) if route == 2 else (1, 256, C)
        return lambda: fn(route, impl, a.data_ptr(), 256, B.data_ptr(), 256, Bp.shape[1],
                          out.data_ptr(), 256, 256 if route == 2 else M, 256,
                          M if route == 2 else 256, None, 0,
                          A.data_ptr() if route == 1 else None, 256, 0, splits, k_split,
                          col_sums, stream())
    times = {}
    for name, route, impl, extra in [
            ("forward, gemm_kernel", 0, 0, None), ("forward, fp32 route", 0, 2, None),
            ("forward, tensor cores", 0, 1, None),
            ("input gradient, gemm_kernel", 1, 0, None),
            ("input gradient, tensor cores", 1, 1, None),
            ("weight gradient, gemm_kernel", 2, 0, None),
            ("weight gradient, tensor cores", 2, 1, None),
            ("weight gradient + column sums, tensor cores", 2, 1, cols)]:
        call = run(route, impl, None if extra is None else extra.data_ptr())
        check(call() == 0, name)
        times[name] = cs.time_ms(call)
    times["torch.matmul (fp32)"] = cs.time_ms(lambda: torch.matmul(A, W))
    for name, ms in times.items():
        print("time: {} {:.3f} ms at {} x 256 x 256".format(name, ms, M))
    print("bound: {:.3f} ms fp32 on the CUDA cores, {:.3f} ms as three TF32 passes".format(
        flops / cs.PEAK_FP32_FLOPS * 1e3, 3 * flops / cs.PEAK_TF32_FLOPS * 1e3))

    # 4. the tensor core's accumulation rounding on a sum of positive terms
    from neural_invertible_warp_tpu_torch.ops.cuda import build as nb
    with open(os.path.join(nb.CSRC, "gemm_tc.cuh")) as f:
        header = f.read()
    check(CHAIN in header, "gemm_tc_kernel's k-tile chain not found")
    variant = os.path.join(OUT, "in_place")
    os.makedirs(variant, exist_ok=True)
    with open(os.path.join(variant, "gemm_tc.cuh"), "w") as f:
        f.write(header.replace(CHAIN, IN_PLACE))
    fn_in_place = build(variant)
    Gp = G.abs()
    ref = A.double().t() @ Gp.double()
    for name, f in (("k-tile chains (shipped)", fn), ("in place", fn_in_place)):
        call = lambda: f(2, 1, A.data_ptr(), 256, Gp.data_ptr(), 256, 0, part.data_ptr(), 256,
                         256, 256, M, None, 0, None, 0, 0, 64, 4072, None, stream())
        check(call() == 0, name)
        torch.cuda.synchronize()
        rel = (part.sum(0).double() - ref) / ref
        print("rounding: weight gradient of positive terms, {}: mean relative error {:+.2e}, "
              "max {:.2e}; {:.3f} ms".format(name, float(rel.mean()), float(rel.abs().max()),
                                             cs.time_ms(call)))
    print(cs.card_line())
    check(not failures, "failed: {}".format(failures))


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


if __name__ == "__main__":
    main()
