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
// and 25.9 MB (0.0077 ms at 3.35 TB/s): memory and FMA bound in about equal
// measure, if every float were read once. Design:
// - A CTA of 128 threads owns a 4 x 32 tile of output pixels, one pixel per
//   thread; a warp is one row of 32 pixels, so every shared-memory read of a
//   warp hits 32 consecutive words (no bank conflicts).
// - It walks the channels in chunks of 16: the chunk's f1 tile and its f2 tile
//   with the md-pixel halo ((4 + 2 md) x (32 + 2 md)) are staged in shared
//   memory (39 KB). The halo loads are masked: zero padding never
//   exists in device memory (the TPU wrapper padded f2 in HBM).
// - The forward keeps its pixel's 81 sums in registers across all channels
//   and writes each once. The adjoints keep the pixel's 81 cotangents in
//   registers (for df2, gathered from the 81 source pixels) and write one
//   channel of the output per 81 multiply-adds.
// - What bounds it on this card: the staging's L2 latency, before the
//   shared-memory reads (each multiply-add reads one word: a warp issues 81
//   shared loads per channel against 81 FMAs). PDC-Net's 256-channel maps
//   give 8-45 CTAs, one per SM, each walking 16 chunks; a thread keeps 10
//   staging loads in flight. The halo re-reads f2 2.5x from L2 (the maps,
//   10 MB at most, stay there). PERF.md has the times against the bound.
// - fp32 FMAs in a fixed order (channel by channel, then d by d); no
//   fast-math, no TF32, no atomics: two runs give the same bits.
#include <cuda_runtime.h>

namespace niw {
namespace corr {

constexpr int MD = 4;             // search radius: 9x9 windows, 81 displacements
constexpr int TH = 4;             // tile rows
constexpr int TW = 32;            // tile columns = warp width
constexpr int NT = TH * TW;       // threads per CTA, one output pixel each
constexpr int CC = 16;            // channels per shared-memory chunk
constexpr int STAGE_BATCH = 10;   // global loads in flight per thread while staging

// Stage channels [c0, c0 + CC) of the [C,H,W] map x over the tile at (y0, x0)
// grown by `halo` on every side into s[CC][TH + 2 halo][TW + 2 halo], zero
// outside the image and past channel C.
template <int HALO>
__device__ __forceinline__ void stage(const float* __restrict__ x, int C, int H, int W,
                                      int c0, int y0, int x0,
                                      float (*s)[TH + 2 * HALO][TW + 2 * HALO]) {
  constexpr int HH = TH + 2 * HALO, WW = TW + 2 * HALO, N = CC * HH * WW;
  constexpr int ITERS = (N + NT - 1) / NT;
  const long long plane = (long long)H * W;
  // STAGE_BATCH loads in flight per thread before their stores: the staging
  // is latency bound (a CTA has 4 warps, and one or two CTAs share an SM).
  // The batches stay a loop: unrolled, they spill the 81 sums.
#pragma unroll 1
  for (int k0 = 0; k0 < ITERS; k0 += STAGE_BATCH) {
    float v[STAGE_BATCH];
#pragma unroll
    for (int k = 0; k < STAGE_BATCH; k++) {
      const int i = threadIdx.x + (k0 + k) * NT;
      const int c = i / (HH * WW), r = i % (HH * WW);
      const int yy = y0 - HALO + r / WW, xx = x0 - HALO + r % WW;
      v[k] = 0.f;
      if (k0 + k < ITERS && i < N && c0 + c < C && yy >= 0 && yy < H && xx >= 0 && xx < W)
        v[k] = x[(c0 + c) * plane + (long long)yy * W + xx];
    }
#pragma unroll
    for (int k = 0; k < STAGE_BATCH; k++) {
      const int i = threadIdx.x + (k0 + k) * NT;
      if (k0 + k < ITERS && i < N) s[i / (HH * WW)][i % (HH * WW) / WW][i % WW] = v[k];
    }
  }
}

__global__ void __launch_bounds__(NT) fwd_kernel(const float* __restrict__ f1,
                                                 const float* __restrict__ f2, int C, int H,
                                                 int W, float* __restrict__ out) {
  constexpr int D = 2 * MD + 1;
  __shared__ float s1[CC][TH][TW];
  __shared__ float s2[CC][TH + 2 * MD][TW + 2 * MD];
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int ty = threadIdx.x / TW, tx = threadIdx.x % TW;
  const long long plane = (long long)H * W;
  const float* f1b = f1 + (long long)b * C * plane;
  const float* f2b = f2 + (long long)b * C * plane;
  float acc[D * D];
#pragma unroll
  for (int d = 0; d < D * D; d++) acc[d] = 0.f;
  for (int c0 = 0; c0 < C; c0 += CC) {
    stage<0>(f1b, C, H, W, c0, y0, x0, s1);
    stage<MD>(f2b, C, H, W, c0, y0, x0, s2);
    __syncthreads();
    // channels past C were staged as zeros and add exactly 0
#pragma unroll 2
    for (int c = 0; c < CC; c++) {
      const float a = s1[c][ty][tx];
#pragma unroll
      for (int i = 0; i < D; i++)
#pragma unroll
        for (int j = 0; j < D; j++)
          acc[i * D + j] = fmaf(a, s2[c][ty + i][tx + j], acc[i * D + j]);
    }
    __syncthreads();
  }
  const int y = y0 + ty, x = x0 + tx;
  if (y >= H || x >= W) return;
  float* o = out + (long long)b * D * D * plane + (long long)y * W + x;
#pragma unroll
  for (int d = 0; d < D * D; d++) o[d * plane] = acc[d] / (float)C;
}

// ADJ_F2 false: out = df1 with x = f2 read at (y + dy, x + dx) and m at (y, x).
// ADJ_F2 true:  out = df2 with x = f1 read at (y - dy, x - dx) and m there too.
template <bool ADJ_F2>
__global__ void __launch_bounds__(NT) adj_kernel(const float* __restrict__ m,
                                                 const float* __restrict__ x, int C, int H,
                                                 int W, float* __restrict__ out) {
  constexpr int D = 2 * MD + 1;
  __shared__ float sx[CC][TH + 2 * MD][TW + 2 * MD];
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int ty = threadIdx.x / TW, tx = threadIdx.x % TW;
  const int y = y0 + ty, xo = x0 + tx;
  const long long plane = (long long)H * W;
  const float* xb = x + (long long)b * C * plane;
  const float* mb = m + (long long)b * D * D * plane;
  float mr[D * D];
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
  for (int c0 = 0; c0 < C; c0 += CC) {
    stage<MD>(xb, C, H, W, c0, y0, x0, sx);
    __syncthreads();
    const int cn = C - c0 < CC ? C - c0 : CC;
    for (int c = 0; c < cn; c++) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < D; i++)
#pragma unroll
        for (int j = 0; j < D; j++) {
          const int r = ADJ_F2 ? ty + 2 * MD - i : ty + i;
          const int q = ADJ_F2 ? tx + 2 * MD - j : tx + j;
          s = fmaf(mr[i * D + j], sx[c][r][q], s);
        }
      if (own) o[(c0 + c) * plane] = s / (float)C;
    }
    __syncthreads();
  }
}

inline dim3 grid_of(int B, int H, int W) {
  return dim3((unsigned)((W + TW - 1) / TW), (unsigned)((H + TH - 1) / TH), (unsigned)B);
}

}  // namespace corr
}  // namespace niw

using namespace niw::corr;

// f1, f2 [B,C,H,W] -> out [B,81,H,W]
extern "C" int niw_corr_fwd(const float* f1, const float* f2, int B, int C, int H, int W,
                            float* out, void* stream) {
  fwd_kernel<<<grid_of(B, H, W), NT, 0, (cudaStream_t)stream>>>(f1, f2, C, H, W, out);
  return (int)cudaGetLastError();
}

// m [B,81,H,W], f2 [B,C,H,W] -> df1 [B,C,H,W]
extern "C" int niw_corr_adj_f1(const float* m, const float* f2, int B, int C, int H, int W,
                               float* df1, void* stream) {
  adj_kernel<false><<<grid_of(B, H, W), NT, 0, (cudaStream_t)stream>>>(m, f2, C, H, W, df1);
  return (int)cudaGetLastError();
}

// m [B,81,H,W], f1 [B,C,H,W] -> df2 [B,C,H,W]
extern "C" int niw_corr_adj_f2(const float* m, const float* f1, int B, int C, int H, int W,
                               float* df2, void* stream) {
  adj_kernel<true><<<grid_of(B, H, W), NT, 0, (cudaStream_t)stream>>>(m, f1, C, H, W, df2);
  return (int)cudaGetLastError();
}
