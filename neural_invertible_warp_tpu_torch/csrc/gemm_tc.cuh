// The layer GEMMs of the NeRF field kernels K1 (field.cu), K2 (rm_train.cu),
// K3 (rm_fwd.cu), K4 (rm_bwd.cu) and K5 (field_pe.cu), the three routes their
// launch sequences run (mlp_forward / mlp_backward of nerf_field.cuh):
// TcGemm (gemm_tc_kernel), on the tensor cores in split fp32; Fp32Gemm
// (gemm_fp32_kernel), fp32 on the CUDA cores in gemm_kernel's summation
// order; and, under tpu.compute_dtype: bfloat16 (K2, K3 and K4), Bf16Gemm
// (gemm_bf16_kernel), one bf16 pass on the tensor cores. Which product takes
// which route follows one rule: a forward whose ReLU decisions a backward
// reads keeps gemm_kernel's order, because the plain version's decisions
// follow that rounding and a moved decision changes a gradient by a finite
// amount (rm_train.cu). So K2's forward and the forwards under autograd
// (`keep`) of K3, K5 and K1 take Fp32Gemm; every backward product (input
// gradients, weight gradients with the bias sums: K2, K4, K5, K1) and every
// forward that no backward reads (the render forwards of K3, K5 and K1) take
// TcGemm. No kernel of the port launches gemm_kernel (SimtGemm) any more: it
// stays as chip_k2_gemm.py's baseline.
//
// bfloat16 (the JAX package's tpu.compute_dtype: both operands of every
// layer product rounded to bf16, to nearest with ties to even, products
// summed in fp32; positions, the PE, biases and activations stay fp32). The
// same rule picks the route: K2's forward and K3's kept forward take
// Fp32Gemm with both operand tiles rounded to bf16 in shared memory
// (round_bf16): the product of two bf16 values is exact in fp32, so that
// forward sums the bf16 plain version's products in its order (cuBLAS's
// fp32 SGEMM on rounded operands) and keeps its ReLU decisions. Every
// backward product of K2 and K4 and K3's render forward take Bf16Gemm:
// mma.sync.m16n8k16 on bf16 operands, the weight read from a bf16 plane
// (rm_train.cu, rounded by __float2bfloat16_rn once per parameter version),
// the fp32 activation or cotangent tile staged as on TcGemm and rounded in
// registers (cvt.rn.bf16x2.f32) as its fragment is read. TcGemm's two
// safeguards stay: each k-tile's 16 products chain from zero in the tensor
// core and are added to the fp32 accumulator with a round-to-nearest add,
// and the weight gradients keep the fixed-order split-K partials.
// Bound at K2's flagship step (260,352 samples): 3 x 528,000 multiply-adds
// per sample at 989 TFLOP/s dense bf16, 0.83 ms; but the fp32 activations,
// written once and read once (9,088 bytes per sample each way, 4.7 GB),
// take 1.41 ms at 3.35 TB/s, and the forward on its route 4.10 ms on the
// CUDA cores at 67 TFLOP/s, so K2 under bf16 stays bound by its forward
// (4.10 + 0.56 ms). K3's render chunk (262,144 samples): 0.28 ms of bf16
// products against 1.42 ms of activation traffic; K4 0.28 / 0.56 ms of
// products without / with the weight gradients.
//
// Replaces the MLP dots of neural_invertible_warp_tpu/ops/pallas/
// fused_pe.py::_rm_train_pe_kernel (fused_pe.py:886, call :1075),
// _rm_fwd_pe_kernel (:568), _rm_bwd_pe_kernel (:597), _fwd_pe_kernel (:151)
// and _bwd_pe_kernel (:171), and of fused_field.py::_fwd_kernel (:166) and
// _bwd_kernel (:245). The TPU kernels take those dots at Precision.DEFAULT,
// bf16x3-class passes with f32 accumulation (fused_field.py:74-83); the
// split product is of that class: each operand x is split into hi =
// tf32(x) and lo = tf32(x - hi) (to nearest, ties away from zero, as cvt.rna
// rounds), and hi*hi + hi*lo + lo*hi is summed in fp32, which keeps about 21
// significand bits.
// Single-pass TF32 (10 bits) is not used anywhere.
//
// What bounds them on Hopper: 528,000 multiply-adds per sample for each of
// the forward, the input gradients and the weight gradients. At K2's
// flagship step (260,352 samples) that is ~0.41 T multiply-adds: 12.3 ms all
// on the CUDA cores at 67 TFLOP/s; on these routes the forward's third in
// fp32 (4.1 ms) and the backward's two thirds as three TF32 passes at 495
// TFLOP/s (3.3 ms): 7.4 ms. At K3's and K4's render chunk (262,144 samples)
// one third is 4.13 ms in fp32 and 1.68 ms split; at K5's and K1's fine
// render chunks (65,536 and 196,608 samples) 1.033 / 3.099 ms in fp32 and
// 0.419 / 1.258 ms split. Every operand tile is reused 128 times from shared
// memory, so device memory does not bound them.
//
// Design of gemm_tc_kernel: one CTA computes a 128x128 output tile with 8
// warps (64x32 each, 4x4 mma.sync.m16n8k8 tiles), k-tiles of 16 in a
// 3-stage shared-memory ring fed by cp.async (16-byte copies with zero
// fill: the ragged edges in M, N and K are masked by the copy, so any R and
// any K <= 256 work). Tiles are stored as the operand lies in device memory
// (k-contiguous rows padded to 20 floats, read with ldmatrix, or 128-wide
// rows padded to 136), so that every fragment read is free of bank
// conflicts. A layer weight arrives already split: the pack kernel writes
// hi and lo planes once per parameter version (rm_train.cu, leading
// dimensions rounded up to 4 floats) and the kernel reads both planes. An activation
// operand is split in registers as its fragment is read (two integer
// operations each way, faster than the cvt). Each k-tile's products (two
// k-steps of 8, three products each) chain from zero inside the tensor core
// and their sum is added to the fp32 accumulator with an ordinary
// (round-to-nearest) add, so the tensor core's own accumulation rounding
// acts on 16 products only, also over the weight gradients' reductions of
// ~4,000 samples per split. Accumulating in place instead is faster, but
// the tensor core's rounding toward zero then biases a 4,072-sample sum of
// positive terms by -3.6e-5 of itself (chip_k2_gemm.py on an H100), more
// than chip_smoke.py's 1e-5 gate. The weight-gradient product also sums the
// cotangent's columns (the bias gradient) from the tiles it stages. The
// epilogue is gemm_epilogue's (bias, beta accumulate, ReLU, ReLU' mask,
// with its operands read two columns at a time) on the same column layouts
// as the CUDA-core route; the weight-gradient product keeps the split-K
// partials and the fixed-order reduce_splits_kernel, so two launches on the
// same inputs give the same bits.
//
// Why mma.sync and not wgmma: a wgmma.m64n128k8 version of the
// input-gradient product (A split in registers, B's planes in a no-swizzle
// K-major core-matrix layout) gave the same bits but was slower than this
// one at 260,352 x 256 x 256 on an H100: the fresh chain per
// k-tile needs a wait before each fp32 add, and overlapping k-tiles through
// a second accumulator made ptxas serialize the wgmmas. The weight-gradient
// product's operands are both M- or N-major, which TF32 wgmma does not read
// from shared memory. A wgmma route needs a producer warp, deeper k-tiles
// and its own accumulator schedule: a later PR's work.
#pragma once

#include "nerf_field.cuh"

namespace niw {

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 16, TC_STAGES = 3;
// 8 warps, each TC_MT x TC_NT tiles of 16x8 (64x32 outputs); TC_KS k-steps
// of 8 per k-tile
constexpr int TC_MT = 4, TC_NT = 4, TC_KS = TC_BK / 8;

// One operand tile in shared memory. K_CONTIG: 128 rows (m or n) of TC_BK
// k-contiguous floats, padded to 20; else TC_BK rows (k) of 128 floats,
// padded to 136. Both strides keep 16-byte rows and conflict-free fragment
// reads (lanes g = 0..7, t = 0..3 read (g, t) or (t, g)).
template <bool K_CONTIG>
struct TcTile {
  static constexpr int LD = K_CONTIG ? TC_BK + 4 : 128 + 8;
  static constexpr int FLOATS = (K_CONTIG ? 128 : TC_BK) * LD;
  static __device__ __forceinline__ int at(int mn, int k) {
    return K_CONTIG ? mn * LD + k : k * LD + mn;
  }
};

// 16 bytes from src to dst, of which the first n_bytes are read and the rest
// zero-filled.
__device__ __forceinline__ void cp_async16_bytes(void* dst, const void* src, int n_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(n_bytes) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int n_floats) {
  cp_async16_bytes(dst, src, n_floats * 4);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One 128 x TC_BK tile of an operand, rows mn0.. (< MN) and k0.. (< kend),
// as 512 copies of 4 floats (two per thread) into the layout of Tile;
// outside the bounds zero. Requires ld % 4 == 0 and a 16-byte aligned g
// (checked at launch).
template <bool K_CONTIG, class Tile = TcTile<K_CONTIG>>
__device__ __forceinline__ void tc_load_tile(float* s, const float* g, int ld, int mn0,
                                             int MN, int k0, int kend) {
#pragma unroll
  for (int i = 0; i < 2; i++) {
    const int c = threadIdx.x + i * 256;
    const int mn = K_CONTIG ? c >> 2 : (c & 31) * 4;
    const int k = K_CONTIG ? (c & 3) * 4 : c >> 5;
    const int gm = mn0 + mn, gk = k0 + k;
    const int n = max(0, min(4, K_CONTIG ? (gm < MN ? kend - gk : 0)
                                         : (gk < kend ? MN - gm : 0)));
    const float* src = n == 0 ? g
        : g + (K_CONTIG ? (size_t)gm * ld + gk : (size_t)gk * ld + gm);
    cp_async16(s + Tile::at(mn, k), src, n);
  }
}

// The chunks of a TcTile that this thread copied (tc_load_tile's mapping),
// rounded to bf16 in place: once its copies landed, before the barrier.
template <bool K_CONTIG>
__device__ __forceinline__ void round_tile_bf16(float* s) {
#pragma unroll
  for (int i = 0; i < 2; i++) {
    const int c = threadIdx.x + i * 256;
    float4* q = reinterpret_cast<float4*>(
        s + TcTile<K_CONTIG>::at(K_CONTIG ? c >> 2 : (c & 31) * 4,
                                 K_CONTIG ? (c & 3) * 4 : c >> 5));
    float4 v = *q;
    v.x = bf16_rn(v.x); v.y = bf16_rn(v.y); v.z = bf16_rn(v.z); v.w = bf16_rn(v.w);
    *q = v;
  }
}

// x rounded to TF32 (10 stored mantissa bits), to nearest with ties away
// from zero: what cvt.rna.tf32.f32 computes, in two integer operations
// (faster here than the cvt).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo (+ the rounding of lo), both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Four 8x8 matrices of 32-bit words (rows of 16 bytes, one row address per
// lane: lanes 8q..8q+7 give matrix q's rows); lane l receives word l % 4 of
// row l / 4 of each matrix, which is an mma.m16n8k8.tf32 fragment layout.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a (16x8, row) * b (8x8, col), TF32 operands, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The outputs of a warp's TC_MT x TC_NT tiles of 16x8 at rows m0.., columns
// n0.. (the m16n8 accumulator layout: the thread holds rows g, g + 8 and
// columns 2t, 2t + 1 of each tile), through gemm_epilogue, or as split-K
// partials without it.
__device__ __forceinline__ void tc_store(const GemmArgs& p, const float (&acc)[TC_MT][TC_NT][4],
                                         int m0, int n0, int g, int t) {
  float* C = p.C + (long long)blockIdx.z * p.c_split_stride;
  const bool split = gridDim.z > 1;
  const bool vec = (p.ldc % 2 == 0) && ((uintptr_t)C % 8 == 0);
  // the epilogue's operands can be read two columns at a time
  const bool pair = vec && (uintptr_t)p.bias % 8 == 0 && (uintptr_t)p.mask % 8 == 0
      && p.ldm % 2 == 0;
#pragma unroll
  for (int i = 0; i < TC_MT; i++)
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const int m = m0 + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < TC_NT; j++) {
        const int n = n0 + j * 8 + 2 * t;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        float* dst = C + (size_t)m * p.ldc + n;
        if (!split) {
          if (pair && n + 1 < p.N) {   // gemm_epilogue on both, its reads as float2s
            if (p.bias) {
              const float2 b = *reinterpret_cast<const float2*>(p.bias + n);
              v0 += b.x; v1 += b.y;
            }
            if (p.beta) {
              const float2 c = *reinterpret_cast<const float2*>(dst);
              v0 += c.x; v1 += c.y;
            }
            if (n < p.relu_cols) v0 = fmaxf(v0, 0.f);
            if (n + 1 < p.relu_cols) v1 = fmaxf(v1, 0.f);
            if (p.mask) {
              const float2 k = *reinterpret_cast<const float2*>(p.mask + (size_t)m * p.ldm + n);
              if (n < p.mask_cols && !(k.x > 0.f)) v0 = 0.f;
              if (n + 1 < p.mask_cols && !(k.y > 0.f)) v1 = 0.f;
            }
          } else {
            if (n < p.N) v0 = gemm_epilogue(p, C, m, n, v0);
            if (n + 1 < p.N) v1 = gemm_epilogue(p, C, m, n + 1, v1);
          }
        }
        if (vec && n + 1 < p.N) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (n < p.N) dst[0] = v0;
          if (n + 1 < p.N) dst[1] = v1;
        }
      }
    }
}

// C[M,N] (+)= epi(op(A) @ op(B) + bias) as gemm_kernel computes it (GemmArgs,
// split mode over gridDim.z included), in split fp32. B_SPLIT: B is a weight
// given as its hi plane with the lo plane b_lo floats after it. col_sums
// (TB false, or null): the CTAs of the first row of tiles also sum op(B)'s
// columns over their k range into col_sums[z * N + n], in a fixed order.
template <bool TA, bool TB, bool B_SPLIT>
static __global__ void __launch_bounds__(256, 2) gemm_tc_kernel(GemmArgs p, long long b_lo,
                                                               float* col_sums) {
  using TileA = TcTile<!TA>;
  using TileB = TcTile<TB>;
  constexpr int STAGE = TileA::FLOATS + (B_SPLIT ? 2 : 1) * TileB::FLOATS;
  extern __shared__ __align__(16) float tc_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int WARPS_M = TC_BM / (16 * TC_MT);
  const int wm = (warp % WARPS_M) * 16 * TC_MT, wn = (warp / WARPS_M) * 8 * TC_NT;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int kbeg = blockIdx.z * p.k_split;
  const int kend = min(p.K, kbeg + p.k_split);
  const int ktiles = max(0, (kend - kbeg + TC_BK - 1) / TC_BK);

  float acc[TC_MT][TC_NT][4];
  // column sums of the raw B tiles (TB false: a tile's rows are k): each
  // thread sums the 4 columns of the chunks it copied, rows tid / 32 and
  // tid / 32 + 8 of every k-tile
  const bool col_sum = !TB && col_sums && blockIdx.y == 0;
  float csum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < TC_MT; i++)
#pragma unroll
    for (int j = 0; j < TC_NT; j++)
#pragma unroll
      for (int q = 0; q < 4; q++) acc[i][j][q] = 0.f;

  auto load_stage = [&](int stage, int k0) {
    float* s = tc_smem + stage * STAGE;
    tc_load_tile<!TA>(s, p.A, p.lda, m0, p.M, k0, kend);
    tc_load_tile<TB>(s + TileA::FLOATS, p.B, p.ldb, n0, p.N, k0, kend);
    if (B_SPLIT)
      tc_load_tile<TB>(s + TileA::FLOATS + TileB::FLOATS, p.B + b_lo, p.ldb, n0, p.N, k0,
                       kend);
  };
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; st++) {
    if (st < ktiles) load_stage(st, kbeg + st * TC_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; kt++) {
    const float* As = tc_smem + (kt % TC_STAGES) * STAGE;
    const float* Bh = As + TileA::FLOATS;
    const float* Bl = Bh + TileB::FLOATS;
    cp_async_wait<TC_STAGES - 2>();
    if (col_sum) {   // this thread's copies of tile kt landed: their columns
#pragma unroll
      for (int i = 0; i < 2; i++) {
        const int c = threadIdx.x + i * 256;
        const float4 v = *reinterpret_cast<const float4*>(Bh + TileB::at((c & 31) * 4, c >> 5));
        csum[0] += v.x; csum[1] += v.y; csum[2] += v.z; csum[3] += v.w;
      }
    }
    __syncthreads();   // tile kt landed for all; all are done with tile kt - 1
    const int next = kt + TC_STAGES - 1;
    if (next < ktiles) load_stage(next % TC_STAGES, kbeg + next * TC_BK);
    cp_async_commit();
    // The k-tile's B fragments of the warp's TC_NT n-tiles (k = t, t + 4;
    // n = g), for each of its TC_KS k-steps of 8, hi and lo
    uint32_t bh[TC_KS][TC_NT][2], bl[TC_KS][TC_NT][2];
#pragma unroll
    for (int ks = 0; ks < TC_KS; ks++) {
      const int kb = ks * 8;
      if (TB) {   // k-contiguous rows: one ldmatrix.x4 per two n-tiles
#pragma unroll
        for (int j = 0; j < TC_NT; j += 2) {
          const int off = TileB::at(wn + (j + (lane >> 4)) * 8 + (lane & 7),
                                    kb + 4 * ((lane >> 3) & 1));
          uint32_t r[4];
          ldsm_x4(r, Bh + off);
          if (B_SPLIT) {
            bh[ks][j][0] = r[0]; bh[ks][j][1] = r[1];
            bh[ks][j + 1][0] = r[2]; bh[ks][j + 1][1] = r[3];
            ldsm_x4(r, Bl + off);
            bl[ks][j][0] = r[0]; bl[ks][j][1] = r[1];
            bl[ks][j + 1][0] = r[2]; bl[ks][j + 1][1] = r[3];
          } else {
#pragma unroll
            for (int q = 0; q < 4; q++)
              split_tf32(__uint_as_float(r[q]), bh[ks][j + q / 2][q % 2],
                         bl[ks][j + q / 2][q % 2]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < TC_NT; j++) {
          const int n = wn + j * 8 + g;
#pragma unroll
          for (int h = 0; h < 2; h++) {
            const float x = Bh[TileB::at(n, kb + t + 4 * h)];
            if (B_SPLIT) {
              bh[ks][j][h] = __float_as_uint(x);
              bl[ks][j][h] = __float_as_uint(Bl[TileB::at(n, kb + t + 4 * h)]);
            } else {
              split_tf32(x, bh[ks][j][h], bl[ks][j][h]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TC_MT; i++) {
      // A fragments (m = g, g + 8; k = t, t + 4) of the k-steps, split
      uint32_t ah[TC_KS][4], al[TC_KS][4];
#pragma unroll
      for (int ks = 0; ks < TC_KS; ks++) {
        const int kb = ks * 8;
        if (!TA) {   // k-contiguous rows: one ldmatrix.x4
          uint32_t r[4];
          ldsm_x4(r, As + TileA::at(wm + i * 16 + (lane & 7) + 8 * ((lane >> 3) & 1),
                                    kb + 4 * (lane >> 4)));
#pragma unroll
          for (int q = 0; q < 4; q++) split_tf32(__uint_as_float(r[q]), ah[ks][q], al[ks][q]);
        } else {
          const int m = wm + i * 16 + g;
          split_tf32(As[TileA::at(m, kb + t)], ah[ks][0], al[ks][0]);
          split_tf32(As[TileA::at(m + 8, kb + t)], ah[ks][1], al[ks][1]);
          split_tf32(As[TileA::at(m, kb + t + 4)], ah[ks][2], al[ks][2]);
          split_tf32(As[TileA::at(m + 8, kb + t + 4)], ah[ks][3], al[ks][3]);
        }
      }
      // each n-tile's products over the k-tile chain from zero in the
      // tensor core; their sum goes to the fp32 accumulator
#pragma unroll
      for (int j = 0; j < TC_NT; j++) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < TC_KS; ks++) {
          mma_tf32(d, al[ks], bh[ks][j][0], bh[ks][j][1]);
          mma_tf32(d, ah[ks], bl[ks][j][0], bl[ks][j][1]);
          mma_tf32(d, ah[ks], bh[ks][j][0], bh[ks][j][1]);
        }
#pragma unroll
        for (int q = 0; q < 4; q++) acc[i][j][q] += d[q];
      }
    }
  }
  cp_async_wait<0>();
  if (col_sum) {   // the 8 row lanes of each column, in that order
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; q++)
      tc_smem[(threadIdx.x >> 5) * 128 + (threadIdx.x & 31) * 4 + q] = csum[q];
    __syncthreads();
    const int n = n0 + threadIdx.x;
    if (threadIdx.x < 128 && n < p.N) {
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < 8; r++) sum += tc_smem[r * 128 + threadIdx.x];
      col_sums[(long long)blockIdx.z * p.N + n] = sum;
    }
  }
  tc_store(p, acc, m0 + wm, n0 + wn, g, t);
}

// The tensor-core route (the interface of SimtGemm in nerf_field.cuh): a
// layer weight is read from its hi plane (leading dimension rounded up to 4
// floats) with the lo plane b_lo floats after it.
struct TcGemm {
  long long b_lo;
  static int ld(int natural) { return (natural + 3) & ~3; }

  template <bool TA, bool TB, bool B_WEIGHT>
  int launch(const GemmArgs& p, int splits, cudaStream_t s, float* col_sums = nullptr) const {
    constexpr int smem = (int)sizeof(float) * TC_STAGES
        * (TcTile<!TA>::FLOATS + (B_WEIGHT ? 2 : 1) * TcTile<TB>::FLOATS);
    if (TB && col_sums) return (int)cudaErrorInvalidValue;
    // the 16-byte copies need 16-byte aligned operands and rows
    if ((uintptr_t)p.A % 16 || (uintptr_t)p.B % 16 || p.lda % 4 || p.ldb % 4
        || (B_WEIGHT && b_lo % 4))
      return (int)cudaErrorMisalignedAddress;
    // set on every launch: a function-local static here would be one object
    // across every library that compiles this header (an inline function's
    // static), and another library's kernel would go without the attribute
    const cudaError_t attr = cudaFuncSetAttribute(
        gemm_tc_kernel<TA, TB, B_WEIGHT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid((p.N + TC_BN - 1) / TC_BN, (p.M + TC_BM - 1) / TC_BM, splits);
    NIW_LAUNCH(gemm_tc_kernel<TA, TB, B_WEIGHT><<<grid, 256, smem, s>>>(
        p, B_WEIGHT ? b_lo : 0, col_sums));
    return 0;
  }
};

// ------------------------------------------------ the fp32 forward route
// K2's forward and the kept forwards of K3, K5 and K1: fp32 FMAs on the CUDA
// cores, in gemm_kernel's summation order: each output is fmaf over k = 0,
// 1, ... from 0.f, then gemm_epilogue, the same thread mapping (8x8 outputs
// per thread of a 128x128 tile), so its bits are gemm_kernel's (rm_train.cu
// says why such a forward needs them). What changes is the staging: the 4-stage
// cp.async ring of the tensor-core route (the same tiles, with zero fill at
// the edges) instead of gemm_kernel's loads through registers, and A read as
// it lies in device memory, k-contiguous, as float4s of 4 k per row. With
// round_bf16 (tpu.compute_dtype: bfloat16), each thread rounds the chunks it
// copied to bf16 in shared memory once they land, before the barrier; the
// FMAs then sum exact products in the same order.
constexpr int FP_STAGES = 4;

static __global__ void __launch_bounds__(256, 2) gemm_fp32_kernel(GemmArgs p, int round_bf16) {
  using TileA = TcTile<true>;
  using TileB = TcTile<false>;
  constexpr int STAGE = TileA::FLOATS + TileB::FLOATS;
  extern __shared__ __align__(16) float fp_smem[];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int ktiles = (p.K + TC_BK - 1) / TC_BK;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; i++)
#pragma unroll
    for (int j = 0; j < 8; j++) acc[i][j] = 0.f;

  auto load_stage = [&](int stage, int k0) {
    float* s = fp_smem + stage * STAGE;
    tc_load_tile<true>(s, p.A, p.lda, m0, p.M, k0, p.K);
    tc_load_tile<false>(s + TileA::FLOATS, p.B, p.ldb, n0, p.N, k0, p.K);
  };
#pragma unroll
  for (int st = 0; st < FP_STAGES - 1; st++) {
    if (st < ktiles) load_stage(st, st * TC_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; kt++) {
    cp_async_wait<FP_STAGES - 2>();
    if (round_bf16) {   // this thread's copies of tile kt landed
      float* s = fp_smem + (kt % FP_STAGES) * STAGE;
      round_tile_bf16<true>(s);
      round_tile_bf16<false>(s + TileA::FLOATS);
    }
    __syncthreads();
    const int next = kt + FP_STAGES - 1;
    if (next < ktiles) load_stage(next % FP_STAGES, next * TC_BK);
    cp_async_commit();
    const float* As = fp_smem + (kt % FP_STAGES) * STAGE;
    const float* Bs = As + TileA::FLOATS;
#pragma unroll
    for (int kq = 0; kq < TC_BK; kq += 4) {
      float4 a4[8];
#pragma unroll
      for (int i = 0; i < 8; i++)
        a4[i] = *reinterpret_cast<const float4*>(
            &As[TileA::at(i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4, kq)]);
#pragma unroll
      for (int kk = 0; kk < 4; kk++) {
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[TileB::at(tx * 4, kq + kk)]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[TileB::at(tx * 4 + 64, kq + kk)]);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; i++) {
          const float a = kk == 0 ? a4[i].x : kk == 1 ? a4[i].y : kk == 2 ? a4[i].z : a4[i].w;
#pragma unroll
          for (int j = 0; j < 8; j++) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // gemm_kernel's epilogue (no split mode here)
  float* C = p.C;
  const bool vec = (p.ldc % 4 == 0) && ((uintptr_t)C % 16 == 0);
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= p.M) continue;
#pragma unroll
    for (int g = 0; g < 2; g++) {
      const int nb = n0 + g * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; j++)
        v[j] = nb + j >= p.N ? acc[i][g * 4 + j]
                             : gemm_epilogue(p, C, m, nb + j, acc[i][g * 4 + j]);
      if (vec && nb + 3 < p.N) {
        *reinterpret_cast<float4*>(&C[(size_t)m * p.ldc + nb]) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; j++)
          if (nb + j < p.N) C[(size_t)m * p.ldc + nb + j] = v[j];
      }
    }
  }
}

// The fp32 forward route (mlp_forward): gemm_fp32_kernel on a layer weight
// padded to a leading dimension of a multiple of 4 floats. It takes the
// forward products only (A and B as they lie, no split mode); round_bf16
// rounds both operands to bf16 first.
struct Fp32Gemm {
  int round_bf16 = 0;
  static int ld(int natural) { return TcGemm::ld(natural); }

  template <bool TA, bool TB, bool B_WEIGHT>
  int launch(const GemmArgs& p, int splits, cudaStream_t s) const {
    static_assert(!TA && !TB && B_WEIGHT, "Fp32Gemm takes the forward products only");
    constexpr int smem = (int)sizeof(float) * FP_STAGES * (TcTile<true>::FLOATS
                                                           + TcTile<false>::FLOATS);
    if (splits != 1) return (int)cudaErrorInvalidValue;
    if ((uintptr_t)p.A % 16 || (uintptr_t)p.B % 16 || p.lda % 4 || p.ldb % 4)
      return (int)cudaErrorMisalignedAddress;
    const cudaError_t attr = cudaFuncSetAttribute(
        gemm_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid((p.N + TC_BN - 1) / TC_BN, (p.M + TC_BM - 1) / TC_BM, 1);
    NIW_LAUNCH(gemm_fp32_kernel<<<grid, 256, smem, s>>>(p, round_bf16));
    return 0;
  }
};

// ------------------------------------------------ the bf16 route
// Bf16Gemm (tpu.compute_dtype: bfloat16): every backward product of K2 and
// K4 and K3's render forward. One CTA computes a 128x128 output tile with 8
// warps of 4x4 mma.sync.m16n8k16 tiles, k-tiles of 16 (one k-step) in a
// 3-stage cp.async ring, as gemm_tc_kernel does. A fp32 operand tile
// (activations, cotangents) is staged as it lies and rounded to bf16 in
// registers as its fragment is read: k-contiguous rows padded to 24 floats
// (a fragment's two k are adjacent: one 64-bit read), or rows of 128 padded
// to 132; both give conflict-free reads. A layer weight arrives as bf16
// (the pack kernel's bf16 plane, leading dimension rounded up to 8) and is
// staged as 16-bit rows, k-contiguous (the input-gradient product) read by
// ldmatrix, or n-contiguous (the forward) read by ldmatrix.trans. The
// fragments hold k in its natural order (lane (g, t): k = 2t, 2t + 1, 2t +
// 8, 2t + 9).
constexpr int BF_STAGES = 3;

// A fp32 operand tile of the bf16 route: K_CONTIG: 128 rows of TC_BK k,
// padded to 24 floats; else TC_BK rows (k) of 128, padded to 132.
template <bool K_CONTIG>
struct BfTile {
  static constexpr int LD = K_CONTIG ? TC_BK + 8 : 128 + 4;
  static constexpr int FLOATS = (K_CONTIG ? 128 : TC_BK) * LD;
  static __device__ __forceinline__ int at(int mn, int k) {
    return K_CONTIG ? mn * LD + k : k * LD + mn;
  }
};

// A bf16 weight tile (16-bit elements): K_CONTIG: 128 rows (n) of TC_BK k,
// padded to 24; else TC_BK rows (k) of 128 n, padded to 136. Rows of 48 or
// 272 bytes: 16-byte aligned, and the 8 rows of an ldmatrix phase fall on
// distinct banks.
template <bool K_CONTIG>
struct BfWTile {
  static constexpr int LD = K_CONTIG ? TC_BK + 8 : 128 + 8;
  static constexpr int FLOATS = (K_CONTIG ? 128 : TC_BK) * LD / 2;
  static __device__ __forceinline__ int at(int mn, int k) {
    return K_CONTIG ? mn * LD + k : k * LD + mn;
  }
};

// One 128 x TC_BK tile of a bf16 weight (g: bf16 elements, ld % 8 == 0),
// rows mn0.. (< MN) and k0.. (< kend), as 256 copies of 8 elements (one per
// thread); outside the bounds zero.
template <bool K_CONTIG>
__device__ __forceinline__ void bf_load_weight_tile(uint16_t* s, const uint16_t* g, int ld,
                                                    int mn0, int MN, int k0, int kend) {
  const int c = threadIdx.x;
  const int mn = K_CONTIG ? c >> 1 : (c & 15) * 8;
  const int k = K_CONTIG ? (c & 1) * 8 : c >> 4;
  const int gm = mn0 + mn, gk = k0 + k;
  const int n = max(0, min(8, K_CONTIG ? (gm < MN ? kend - gk : 0)
                                       : (gk < kend ? MN - gm : 0)));
  const uint16_t* src = n == 0 ? g
      : g + (K_CONTIG ? (size_t)gm * ld + gk : (size_t)gk * ld + gm);
  cp_async16_bytes(s + BfWTile<K_CONTIG>::at(mn, k), src, n * 2);
}

// (lo, hi) rounded to bf16 (to nearest, ties to even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void ldsm_x4_b16(uint32_t (&r)[4], const uint16_t* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const uint16_t* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d = a (16x16, row) * b (16x8, col), bf16 operands, fp32 accumulate, from 0.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
}

// C[M,N] (+)= epi(op(A) @ op(B) + bias) with both operands rounded to bf16
// (GemmArgs, split mode over gridDim.z included). B_WEIGHT: B is a layer
// weight in bf16 (the pack kernel's bf16 plane); else fp32, n-contiguous.
// col_sums (TB false, or null): as gemm_tc_kernel's, over the fp32 tiles.
template <bool TA, bool TB, bool B_WEIGHT>
static __global__ void __launch_bounds__(256, 2) gemm_bf16_kernel(GemmArgs p, float* col_sums) {
  static_assert(B_WEIGHT || !TB, "a k-contiguous B is a weight");
  using TileA = BfTile<!TA>;
  using TileB = BfTile<false>;     // fp32 B (not a weight): rows k
  using TileW = BfWTile<TB>;       // bf16 B (a weight)
  constexpr int B_FLOATS = B_WEIGHT ? TileW::FLOATS : TileB::FLOATS;
  constexpr int STAGE = TileA::FLOATS + B_FLOATS;
  extern __shared__ __align__(16) float bf_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int WARPS_M = TC_BM / (16 * TC_MT);
  const int wm = (warp % WARPS_M) * 16 * TC_MT, wn = (warp / WARPS_M) * 8 * TC_NT;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int kbeg = blockIdx.z * p.k_split;
  const int kend = min(p.K, kbeg + p.k_split);
  const int ktiles = max(0, (kend - kbeg + TC_BK - 1) / TC_BK);
  const uint16_t* Bw = reinterpret_cast<const uint16_t*>(p.B);

  float acc[TC_MT][TC_NT][4];
  const bool col_sum = !B_WEIGHT && col_sums && blockIdx.y == 0;
  float csum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < TC_MT; i++)
#pragma unroll
    for (int j = 0; j < TC_NT; j++)
#pragma unroll
      for (int q = 0; q < 4; q++) acc[i][j][q] = 0.f;

  auto load_stage = [&](int stage, int k0) {
    float* s = bf_smem + stage * STAGE;
    tc_load_tile<!TA, TileA>(s, p.A, p.lda, m0, p.M, k0, kend);
    if (B_WEIGHT)
      bf_load_weight_tile<TB>(reinterpret_cast<uint16_t*>(s + TileA::FLOATS), Bw, p.ldb, n0,
                              p.N, k0, kend);
    else
      tc_load_tile<false, TileB>(s + TileA::FLOATS, p.B, p.ldb, n0, p.N, k0, kend);
  };
#pragma unroll
  for (int st = 0; st < BF_STAGES - 1; st++) {
    if (st < ktiles) load_stage(st, kbeg + st * TC_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; kt++) {
    const float* As = bf_smem + (kt % BF_STAGES) * STAGE;
    const float* Bs = As + TileA::FLOATS;
    const uint16_t* Ws = reinterpret_cast<const uint16_t*>(Bs);
    cp_async_wait<BF_STAGES - 2>();
    if (col_sum) {   // this thread's copies of tile kt landed: their columns
#pragma unroll
      for (int i = 0; i < 2; i++) {
        const int c = threadIdx.x + i * 256;
        const float4 v = *reinterpret_cast<const float4*>(Bs + TileB::at((c & 31) * 4, c >> 5));
        csum[0] += v.x; csum[1] += v.y; csum[2] += v.z; csum[3] += v.w;
      }
    }
    __syncthreads();   // tile kt landed for all; all are done with tile kt - 1
    const int next = kt + BF_STAGES - 1;
    if (next < ktiles) load_stage(next % BF_STAGES, kbeg + next * TC_BK);
    cp_async_commit();
    // B fragments of the warp's TC_NT n-tiles: (k = 2t, 2t + 1; n = g) and
    // (k = 2t + 8, 2t + 9; n = g)
    uint32_t b[TC_NT][2];
    if (B_WEIGHT) {   // one ldmatrix.x4 per two n-tiles: matrices (j, k 0-7),
                      // (j, k 8-15), (j + 1, k 0-7), (j + 1, k 8-15)
      const int q = lane >> 3, r = lane & 7;
#pragma unroll
      for (int j = 0; j < TC_NT; j += 2) {
        uint32_t x[4];
        const int nt = wn + (j + (q >> 1)) * 8;
        if (TB)
          ldsm_x4_b16(x, Ws + TileW::at(nt + r, (q & 1) * 8));
        else
          ldsm_x4_trans(x, Ws + TileW::at(nt, (q & 1) * 8 + r));
        b[j][0] = x[0]; b[j][1] = x[1]; b[j + 1][0] = x[2]; b[j + 1][1] = x[3];
      }
    } else {
#pragma unroll
      for (int j = 0; j < TC_NT; j++) {
        const int n = wn + j * 8 + g;
#pragma unroll
        for (int h = 0; h < 2; h++)
          b[j][h] = pack_bf16(Bs[TileB::at(n, 2 * t + 8 * h)],
                              Bs[TileB::at(n, 2 * t + 8 * h + 1)]);
      }
    }
#pragma unroll
    for (int i = 0; i < TC_MT; i++) {
      // A fragment: (m = g, g + 8) x (k = 2t, 2t + 1) and (2t + 8, 2t + 9)
      const int m = wm + i * 16 + g;
      uint32_t a[4];
#pragma unroll
      for (int q = 0; q < 4; q++) {
        const int mq = m + 8 * (q & 1), kq = 2 * t + 8 * (q >> 1);
        if (!TA) {
          const float2 v = *reinterpret_cast<const float2*>(As + TileA::at(mq, kq));
          a[q] = pack_bf16(v.x, v.y);
        } else {
          a[q] = pack_bf16(As[TileA::at(mq, kq)], As[TileA::at(mq, kq + 1)]);
        }
      }
      // each n-tile's 16 products chain from zero in the tensor core; their
      // sum goes to the fp32 accumulator
#pragma unroll
      for (int j = 0; j < TC_NT; j++) {
        float d[4];
        mma_bf16(d, a, b[j][0], b[j][1]);
#pragma unroll
        for (int q = 0; q < 4; q++) acc[i][j][q] += d[q];
      }
    }
  }
  cp_async_wait<0>();
  if (col_sum) {   // the 8 row lanes of each column, in that order
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; q++)
      bf_smem[(threadIdx.x >> 5) * 128 + (threadIdx.x & 31) * 4 + q] = csum[q];
    __syncthreads();
    const int n = n0 + threadIdx.x;
    if (threadIdx.x < 128 && n < p.N) {
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < 8; r++) sum += bf_smem[r * 128 + threadIdx.x];
      col_sums[(long long)blockIdx.z * p.N + n] = sum;
    }
  }
  tc_store(p, acc, m0 + wm, n0 + wn, g, t);
}

// The bf16 route (the interface of SimtGemm in nerf_field.cuh): a layer
// weight is read from the bf16 plane, leading dimension rounded up to 8
// elements (16 bytes).
struct Bf16Gemm {
  static int ld(int natural) { return (natural + 7) & ~7; }

  template <bool TA, bool TB, bool B_WEIGHT>
  int launch(const GemmArgs& p, int splits, cudaStream_t s, float* col_sums = nullptr) const {
    constexpr int smem = (int)sizeof(float) * BF_STAGES
        * (BfTile<!TA>::FLOATS + (B_WEIGHT ? BfWTile<TB>::FLOATS : BfTile<false>::FLOATS));
    if ((TB && !B_WEIGHT) || (B_WEIGHT && col_sums)) return (int)cudaErrorInvalidValue;
    // the 16-byte copies need 16-byte aligned operands and rows
    if ((uintptr_t)p.A % 16 || (uintptr_t)p.B % 16 || p.lda % 4
        || p.ldb % (B_WEIGHT ? 8 : 4))
      return (int)cudaErrorMisalignedAddress;
    const cudaError_t attr = cudaFuncSetAttribute(
        gemm_bf16_kernel<TA, TB, B_WEIGHT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid((p.N + TC_BN - 1) / TC_BN, (p.M + TC_BM - 1) / TC_BM, splits);
    NIW_LAUNCH(gemm_bf16_kernel<TA, TB, B_WEIGHT><<<grid, 256, smem, s>>>(p, col_sums));
    return 0;
  }
};

}  // namespace niw
