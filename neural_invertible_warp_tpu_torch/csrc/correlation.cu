// K7: PDC-Net's local correlation (the 9x9 cost volume) and its two adjoints.
//
// Replaces neural_invertible_warp_tpu/ops/pallas/correlation_kernel.py::
// _corr_kernel (wrapper local_correlation_pallas), forward only there; the
// JAX package takes the adjoint with respect to the filter map from jax.vjp of
// its XLA twin (ops/pdcnet/gocor.py), which the reference ran as the CuPy
// kernel FunctionCorrelationTranspose. For displacements (dy, dx) in
// [-md, md]^2, d = (dy + md) (2 md + 1) + (dx + md), zero outside the image:
//   forward  out[b,d,y,x] = (1/C) sum_c f1[b,c,y,x] f2[b,c,y+dy,x+dx]
//   adj f1   df1[b,c,y,x] = (1/C) sum_d m[b,d,y,x] f2[b,c,y+dy,x+dx]
//   adj f2   df2[b,c,y,x] = (1/C) sum_d m[b,d,y-dy,x-dx] f1[b,c,y-dy,x-dx]
// All operands [B,C,H,W] or [B,81,H,W] float32, contiguous; any B, C, H, W >= 1;
// md = 4, PDC-Net's radius.
//
// Bound: per output pixel 81 C multiply-adds against 2 C + 81 floats moved.
// At [1,128,120,160] that is 199 M multiply-adds (0.0059 ms at 67 TFLOP/s)
// and 25.9 MB (0.0077 ms at 3.35 TB/s). PDC-Net's maps (10 MB at most) stay
// in L2, so what bounds a kernel here is how many SMs and warps it keeps
// busy, how well the staging from L2 overlaps the multiply-adds, and the
// shared-memory reads per multiply-add (128 bytes per cycle per SM: one
// 4-byte read per FMA caps the FMAs at a quarter of the card's rate).
// Design:
// - Staging: each CTA walks its channels in chunks; a chunk's boxes (the
//   pixel tile of the map read in place, or the tile grown by the md-pixel
//   halo) go to shared memory through a 3-stage ring of cp.async copies, so
//   chunk k + 2 loads while chunk k's multiply-adds run (one barrier per
//   chunk). Copies are 16 bytes where W % 4 == 0 and the maps are 16-byte
//   aligned, 8 where W is even, else 4 (a copy's columns then lie wholly
//   inside or outside the image); outside the image and past channel C they
//   are the zero-fill form (src-size 0): zero padding never exists in
//   device memory.
// - Forward: a thread owns 4 pixels along x (a warp 8 lanes x 4 rows, a
//   quarter-warp one row, so its 16-byte shared reads stay free of bank
//   conflicts) and one group of DG dy rows (grid z = B x 9/DG): per channel
//   and dy row, three 16-byte reads of f2 feed 36 FMAs. A CTA is KS slices of
//   two warps (an 8 x 32 pixel tile); slice s takes chunks s, s + KS, ... of
//   4 channels, and the slices' sums are added in slice order through shared
//   memory. fwd_plan picks DG = 3 (108 sums per thread) or 1 (36) and KS = 2
//   or 4 by the CTAs a shape gives; at PDC-Net's shapes 36-360 CTAs, where
//   the first design launched 8-150. Each output is KS sums in channel order
//   added in slice order (KS = 1, only for C <= 4, gives the plain loop's
//   bits).
// - Adjoints: a thread owns one pixel of a 4 x 32 tile and keeps its 81
//   cotangents in registers (for df2 gathered from the 81 source pixels);
//   the channels are split across CTAs (grid z = B x groups of 16 or 32,
//   adj_plan), and each output channel is one sum over d in d order: no
//   cross-CTA sum, the bits of the first design.
// - fp32 FMAs in a fixed order, no fast-math, no TF32, no atomics: two runs
//   give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace niw {
namespace corr {

constexpr int MD = 4;             // search radius
constexpr int D = 2 * MD + 1;     // 9 displacements per axis
constexpr int ND = D * D;         // 81
constexpr int NS = 3;             // stages of the cp.async ring
constexpr int N_SM = 132;         // the H100's SMs, against which the plans count CTAs

// ------------------------------------------------------------------ staging
// One copy of BYTES (16, 8 or 4) into shared memory; src-size 0 fills zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(BYTES), "r"(in ? BYTES : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy channels [c0, c0 + CH) x rows [yb, yb + R) x columns [xb, xb + Q) of the
// [C,H,W] map x into s[CH][R][Q] (thread t of NTH), zero outside the map, in
// copies of VW floats: needs W % VW == 0, x aligned to VW floats, xb % VW == 0
// (a group of VW columns then lies wholly inside or outside the image).
template <int CH, int R, int Q, int NTH, int VW>
__device__ __forceinline__ void stage_box_w(const float* __restrict__ x, int C, int H, int W,
                                            int c0, int yb, int xb, float* s, int t) {
  static_assert(Q % VW == 0, "a row of whole groups");
  constexpr int QV = Q / VW, N = CH * R * QV, IT = (N + NTH - 1) / NTH;
  const long long plane = (long long)H * W;
#pragma unroll 8
  for (int k = 0; k < IT; k++) {
    const int i = t + k * NTH;
    if (N % NTH == 0 || i < N) {
      const int c = i / (R * QV), r = (i / QV) % R, q = (i % QV) * VW;
      const int cg = c0 + c, y = yb + r, xx = xb + q;
      const bool in = cg < C && y >= 0 && y < H && xx >= 0 && xx < W;
      cp_async<4 * VW>(s + VW * i, in ? x + cg * plane + (long long)y * W + xx : x, in);
    }
  }
}

// vw: 4 (W % 4 == 0, 16-byte aligned maps), 2 (W even, 8-byte aligned) or 1
template <int CH, int R, int Q, int NTH>
__device__ __forceinline__ void stage_box(const float* __restrict__ x, int C, int H, int W,
                                          int vw, int c0, int yb, int xb, float* s, int t) {
  if (vw == 4)
    stage_box_w<CH, R, Q, NTH, 4>(x, C, H, W, c0, yb, xb, s, t);
  else if (vw == 2)
    stage_box_w<CH, R, Q, NTH, 2>(x, C, H, W, c0, yb, xb, s, t);
  else
    stage_box_w<CH, R, Q, NTH, 1>(x, C, H, W, c0, yb, xb, s, t);
}

// ------------------------------------------------------------------ forward
constexpr int PX = 4;             // pixels per thread along x
constexpr int LX = 8;             // lanes of a warp along x; 4 rows of lanes
constexpr int TW = LX * PX;       // tile columns (32)
constexpr int WY = 2;             // warps per channel slice, stacked along y
constexpr int TH = 4 * WY;        // tile rows (8)
constexpr int SLICE = 32 * WY;    // threads per channel slice
constexpr int FCC = 4;            // channels per chunk
constexpr int QF = TW + 2 * MD;   // staged f2 columns (40)

template <int DG>
struct FwdRing {
  static constexpr int F1 = FCC * TH * TW;                 // f1 tile [FCC][TH][TW]
  static constexpr int STAGE = F1 + FCC * (TH + DG - 1) * QF;  // + f2 box [FCC][TH+DG-1][QF]
  static constexpr int SLICE_FLOATS = NS * STAGE;
};

// Grid: (W / TW, H / TH, B x 9/DG) rounded up; KS slices of SLICE threads.
template <int DG, int KS>
__global__ void __launch_bounds__(SLICE * KS) fwd_kernel(const float* __restrict__ f1,
                                                         const float* __restrict__ f2, int C,
                                                         int H, int W, int vw,
                                                         float* __restrict__ out) {
  using Ring = FwdRing<DG>;
  extern __shared__ __align__(16) float smem[];
  constexpr int NG = D / DG;
  const int b = blockIdx.z / NG, grp = blockIdx.z % NG;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW, dy0 = grp * DG - MD;
  const int slice = threadIdx.x / SLICE, t = threadIdx.x % SLICE;
  const int lane = t % 32, ty = (t / 32) * 4 + lane / LX, tx = (lane % LX) * PX;
  const long long plane = (long long)H * W;
  const float* f1b = f1 + (long long)b * C * plane;
  const float* f2b = f2 + (long long)b * C * plane;
  float* ring = smem + slice * Ring::SLICE_FLOATS;
  const int nk = ((C + FCC - 1) / FCC + KS - 1) / KS;   // chunks per slice
  // slice s takes chunks s, s + KS, ...; past C the copies fill zeros, which
  // add exactly 0
  auto stage = [&](int k) {
    float* s = ring + (k % NS) * Ring::STAGE;
    const int c0 = (slice + k * KS) * FCC;
    stage_box<FCC, TH, TW, SLICE>(f1b, C, H, W, vw, c0, y0, x0, s, t);
    stage_box<FCC, TH + DG - 1, QF, SLICE>(f2b, C, H, W, vw, c0, y0 + dy0, x0 - MD,
                                           s + Ring::F1, t);
  };
  float acc[DG][D][PX];
#pragma unroll
  for (int i = 0; i < DG; i++)
#pragma unroll
    for (int j = 0; j < D; j++)
#pragma unroll
      for (int p = 0; p < PX; p++) acc[i][j][p] = 0.f;
  for (int k = 0; k < NS - 1; k++) {
    if (k < nk) stage(k);
    cp_async_commit();
  }
#pragma unroll 1
  for (int k = 0; k < nk; k++) {
    cp_async_wait<NS - 2>();
    __syncthreads();   // chunk k landed for every thread; chunk k - 1's buffer is free
    if (k + NS - 1 < nk) stage(k + NS - 1);
    cp_async_commit();
    const float* s1 = ring + (k % NS) * Ring::STAGE;
    const float* s2 = s1 + Ring::F1;
#pragma unroll
    for (int c = 0; c < FCC; c++) {
      const float4 a4 = *reinterpret_cast<const float4*>(s1 + (c * TH + ty) * TW + tx);
      const float a[PX] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int i = 0; i < DG; i++) {
        // f2 at columns x - md .. x + PX - 1 + md of row y + dy0 + i
        const float* row = s2 + (c * (TH + DG - 1) + ty + i) * QF + tx;
        const float4 v0 = *reinterpret_cast<const float4*>(row);
        const float4 v1 = *reinterpret_cast<const float4*>(row + 4);
        const float4 v2 = *reinterpret_cast<const float4*>(row + 8);
        const float seg[12] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y,
                               v1.z, v1.w, v2.x, v2.y, v2.z, v2.w};
#pragma unroll
        for (int j = 0; j < D; j++)
#pragma unroll
          for (int p = 0; p < PX; p++) acc[i][j][p] = fmaf(a[p], seg[p + j], acc[i][j][p]);
      }
    }
  }
  cp_async_wait<0>();
  if (KS > 1) {
    // the slices' sums added in slice order through the (now free) ring
    static_assert(DG * D * PX * SLICE <= KS * Ring::SLICE_FLOATS, "the reduction fits the ring");
    float* red = smem + t;
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < KS - 1; r++) {
      if (slice == r)
#pragma unroll
        for (int i = 0; i < DG; i++)
#pragma unroll
          for (int j = 0; j < D; j++)
#pragma unroll
            for (int p = 0; p < PX; p++) {
              float* e = red + ((i * D + j) * PX + p) * SLICE;
              *e = r == 0 ? acc[i][j][p] : *e + acc[i][j][p];
            }
      __syncthreads();
    }
    if (slice != KS - 1) return;
#pragma unroll
    for (int i = 0; i < DG; i++)
#pragma unroll
      for (int j = 0; j < D; j++)
#pragma unroll
        for (int p = 0; p < PX; p++)
          acc[i][j][p] = red[((i * D + j) * PX + p) * SLICE] + acc[i][j][p];
  }
  const int y = y0 + ty, x = x0 + tx;
  if (y >= H || x >= W) return;
  float* o = out + ((long long)b * ND + (dy0 + MD) * D) * plane + (long long)y * W + x;
  const float fc = (float)C;
#pragma unroll
  for (int i = 0; i < DG; i++)
#pragma unroll
    for (int j = 0; j < D; j++) {
      float* od = o + (long long)(i * D + j) * plane;
      if (vw == 4) {   // W % 4 == 0: the 4 pixels are all inside
        *reinterpret_cast<float4*>(od) = make_float4(acc[i][j][0] / fc, acc[i][j][1] / fc,
                                                     acc[i][j][2] / fc, acc[i][j][3] / fc);
      } else if (vw == 2) {   // W even: pairs wholly inside or outside
        *reinterpret_cast<float2*>(od) = make_float2(acc[i][j][0] / fc, acc[i][j][1] / fc);
        if (x + 2 < W)
          *reinterpret_cast<float2*>(od + 2) = make_float2(acc[i][j][2] / fc, acc[i][j][3] / fc);
      } else {
#pragma unroll
        for (int p = 0; p < PX; p++)
          if (x + p < W) od[p] = acc[i][j][p] / fc;
      }
    }
}

// ----------------------------------------------------------------- adjoints
constexpr int ATH = 4, ATW = 32;        // pixel tile; a warp one row
constexpr int ANT = ATH * ATW;          // threads per CTA, one pixel each
constexpr int ACC = 8;                  // channels per chunk
constexpr int AR = ATH + 2 * MD, AQ = ATW + 2 * MD;
constexpr int ASTAGE = ACC * AR * AQ;   // staged box [ACC][AR][AQ]

// ADJ_F2 false: out = df1 with x = f2 read at (y + dy, x + dx) and m at (y, x).
// ADJ_F2 true:  out = df2 with x = f1 read at (y - dy, x - dx) and m there too.
// Grid: (W / ATW, H / ATH, B x groups of cg channels) rounded up.
template <bool ADJ_F2>
__global__ void __launch_bounds__(ANT) adj_kernel(const float* __restrict__ m,
                                                  const float* __restrict__ x, int C, int H,
                                                  int W, int cg, int vw,
                                                  float* __restrict__ out) {
  __shared__ __align__(16) float ring[NS * ASTAGE];
  const int ngrp = (C + cg - 1) / cg;
  const int b = blockIdx.z / ngrp, c_begin = blockIdx.z % ngrp * cg;
  const int c_end = min(C, c_begin + cg), nk = (c_end - c_begin + ACC - 1) / ACC;
  const int y0 = blockIdx.y * ATH, x0 = blockIdx.x * ATW;
  const int ty = threadIdx.x / ATW, tx = threadIdx.x % ATW;
  const int y = y0 + ty, xo = x0 + tx;
  const long long plane = (long long)H * W;
  const float* xb = x + (long long)b * C * plane;
  auto stage = [&](int k) {
    stage_box<ACC, AR, AQ, ANT>(xb, C, H, W, vw, c_begin + k * ACC, y0 - MD, x0 - MD,
                                ring + (k % NS) * ASTAGE, threadIdx.x);
  };
  for (int k = 0; k < NS - 1; k++) {
    if (k < nk) stage(k);
    cp_async_commit();
  }
  // the pixel's 81 cotangents, once per CTA, while the first chunks load
  const float* mb = m + (long long)b * ND * plane;
  float mr[ND];
#pragma unroll
  for (int i = 0; i < D; i++)
#pragma unroll
    for (int j = 0; j < D; j++) {
      const int yy = ADJ_F2 ? y - (i - MD) : y, xx = ADJ_F2 ? xo - (j - MD) : xo;
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      mr[i * D + j] = in ? mb[(i * D + j) * plane + (long long)yy * W + xx] : 0.f;
    }
  const bool own = y < H && xo < W;
  float* o = out + (long long)b * C * plane + (long long)y * W + xo;
  const float fc = (float)C;
#pragma unroll 1
  for (int k = 0; k < nk; k++) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (k + NS - 1 < nk) stage(k + NS - 1);
    cp_async_commit();
    const float* sx = ring + (k % NS) * ASTAGE;
    const int c0 = c_begin + k * ACC, cn = min(ACC, c_end - c0);
#pragma unroll 1
    for (int c = 0; c < cn; c++) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < D; i++)
#pragma unroll
        for (int j = 0; j < D; j++) {
          const int r = ADJ_F2 ? ty + 2 * MD - i : ty + i;
          const int q = ADJ_F2 ? tx + 2 * MD - j : tx + j;
          acc = fmaf(mr[i * D + j], sx[(c * AR + r) * AQ + q], acc);
        }
      if (own) o[(c0 + c) * plane] = acc / fc;
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- host side
inline unsigned cdiv(long long a, long long b) { return (unsigned)((a + b - 1) / b); }

// The widest copy (in floats) that W and the maps' alignment allow.
inline int vec_width(int W, const void* a, const void* b, const void* c) {
  const uintptr_t any = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c;
  return W % 4 == 0 && any % 16 == 0 ? 4 : W % 2 == 0 && any % 8 == 0 ? 2 : 1;
}

struct FwdPlan {
  int dg, ks;
};

// DG = 3 where its CTAs still give every SM one, else DG = 1; two channel
// slices per CTA, four where the CTAs give fewer than one per SM, and at most
// one per chunk. Chosen by timing every (DG, KS) at PDC-Net's shapes on the
// H100 (PERF.md): KS = 1 keeps the channel order but leaves too few warps.
inline FwdPlan fwd_plan(int B, int C, int H, int W) {
  const long long tiles = (long long)B * cdiv(W, TW) * cdiv(H, TH), chunks = cdiv(C, FCC);
  const int dg = tiles * (D / 3) >= N_SM ? 3 : 1;
  int ks = tiles * (D / dg) >= N_SM ? 2 : 4;
  while (ks > chunks) ks /= 2;
  return {dg, ks};
}

inline dim3 fwd_grid(FwdPlan p, int B, int H, int W) {
  return dim3(cdiv(W, TW), cdiv(H, TH), (unsigned)(B * (D / p.dg)));
}

// Channels per CTA: 32 where that gives every SM two CTAs, else 16 (timed
// against 8 to 64 at PDC-Net's shapes on the H100).
inline int adj_plan(int B, int C, int H, int W) {
  const long long tiles = (long long)B * cdiv(W, ATW) * cdiv(H, ATH);
  return tiles * cdiv(C, 32) >= 2 * N_SM ? 32 : 16;
}

inline dim3 adj_grid(int cg, int B, int C, int H, int W) {
  return dim3(cdiv(W, ATW), cdiv(H, ATH), (unsigned)(B * cdiv(C, cg)));
}

template <int DG, int KS>
int launch_fwd_t(const float* f1, const float* f2, int B, int C, int H, int W, int vw,
                 float* out, cudaStream_t s) {
  const size_t smem = (size_t)KS * FwdRing<DG>::SLICE_FLOATS * sizeof(float);
  // set on every launch: a function-local static would be one object across
  // every library that compiles this file, and another's kernel would go
  // without the attribute
  const cudaError_t attr = cudaFuncSetAttribute(
      fwd_kernel<DG, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  fwd_kernel<DG, KS><<<fwd_grid({DG, KS}, B, H, W), SLICE * KS, smem, s>>>(f1, f2, C, H, W,
                                                                             vw, out);
  return (int)cudaGetLastError();
}

inline int launch_fwd(FwdPlan p, const float* f1, const float* f2, int B, int C, int H, int W,
                      float* out, cudaStream_t s) {
  const int vw = vec_width(W, f1, f2, out);
  if (p.dg == 3 && p.ks == 1) return launch_fwd_t<3, 1>(f1, f2, B, C, H, W, vw, out, s);
  if (p.dg == 3 && p.ks == 2) return launch_fwd_t<3, 2>(f1, f2, B, C, H, W, vw, out, s);
  if (p.dg == 1 && p.ks == 1) return launch_fwd_t<1, 1>(f1, f2, B, C, H, W, vw, out, s);
  if (p.dg == 1 && p.ks == 2) return launch_fwd_t<1, 2>(f1, f2, B, C, H, W, vw, out, s);
  if (p.dg == 1 && p.ks == 4) return launch_fwd_t<1, 4>(f1, f2, B, C, H, W, vw, out, s);
  return (int)cudaErrorInvalidValue;
}

template <bool ADJ_F2>
int launch_adj(int cg, const float* m, const float* x, int B, int C, int H, int W, float* out,
               cudaStream_t s) {
  const int vw = vec_width(W, m, x, out);
  adj_kernel<ADJ_F2><<<adj_grid(cg, B, C, H, W), ANT, 0, s>>>(m, x, C, H, W, cg, vw, out);
  return (int)cudaGetLastError();
}

}  // namespace corr
}  // namespace niw

using namespace niw::corr;

// f1, f2 [B,C,H,W] -> out [B,81,H,W]
extern "C" int niw_corr_fwd(const float* f1, const float* f2, int B, int C, int H, int W,
                            float* out, void* stream) {
  return launch_fwd(fwd_plan(B, C, H, W), f1, f2, B, C, H, W, out, (cudaStream_t)stream);
}

// m [B,81,H,W], f2 [B,C,H,W] -> df1 [B,C,H,W]
extern "C" int niw_corr_adj_f1(const float* m, const float* f2, int B, int C, int H, int W,
                               float* df1, void* stream) {
  return launch_adj<false>(adj_plan(B, C, H, W), m, f2, B, C, H, W, df1,
                           (cudaStream_t)stream);
}

// m [B,81,H,W], f1 [B,C,H,W] -> df2 [B,C,H,W]
extern "C" int niw_corr_adj_f2(const float* m, const float* f1, int B, int C, int H, int W,
                               float* df2, void* stream) {
  return launch_adj<true>(adj_plan(B, C, H, W), m, f1, B, C, H, W, df2,
                          (cudaStream_t)stream);
}

// CTAs of one launch: which 0 the forward, 1 and 2 the adjoints (the same grid).
extern "C" long long niw_corr_ctas(int which, int B, int C, int H, int W) {
  const dim3 g = which == 0 ? fwd_grid(fwd_plan(B, C, H, W), B, H, W)
                            : adj_grid(adj_plan(B, C, H, W), B, C, H, W);
  return (long long)g.x * g.y * g.z;
}
