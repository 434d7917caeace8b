// Shared device code of the NeRF field kernels: the composited ones (K2 train,
// K3 forward, K4 backward of K3) and the per-sample ones (K5: PE + MLP,
// field_pe.cu; K1: MLP on encoded inputs, field.cu).
//
// Replaces the Pallas TPU kernels in neural_invertible_warp_tpu/ops/pallas/
// fused_pe.py (_rm_fwd_pe_kernel, _rm_bwd_pe_kernel, _rm_train_pe_kernel,
// _fwd_pe_kernel, _bwd_pe_kernel) and fused_field.py (_fwd_kernel,
// _bwd_kernel) with the MLP math they share (_forward_block, _mlp_backward).
//
// What bounds this on Hopper: the 8x256 trunk is ~1.06 MFLOP per sample
// forward and ~2.1 MFLOP backward, fp32-class (the PE must stay true fp32;
// the MLP dots are fp32 on the CUDA cores or split fp32 on the tensor cores,
// on the routes of gemm_tc.cuh; single-pass TF32 nowhere; under
// tpu.compute_dtype: bfloat16, K2-K4's dots take bf16 operands summed in
// fp32, on gemm_tc.cuh's bf16 route). At the flagship train
// shape (2034 rays x 128 samples) that is ~0.83 TFLOP per step, so the
// arithmetic rate bounds it, not memory.
//
// Design: one launch sequence per call. Samples are rows of dense [N, C]
// fp32 buffers in a workspace the wrapper allocates; each MLP layer is one
// GEMM with a fused bias/ReLU/ReLU'-mask epilogue, on one of the two routes
// of gemm_tc.cuh (split fp32 on the tensor cores, or fp32 in gemm_kernel's
// summation order), which every field kernel (K1-K5) runs; gemm_kernel
// below, the first route (a register-blocked CUDA-core SGEMM), is left as
// the baseline that chip_k2_gemm.py times the routes against. The
// activation cache that the TPU kept in VMEM lives in the workspace (~9 KB
// per sample forward, ~14 KB with the backward buffers).
// Per-ray work (PE, compositing with a sequential exclusive scan, the MSE
// cotangent, the PE/view/quadrature backward) runs one CTA per ray.
// Weight gradients reduce over samples in two passes: each CTA of a split
// writes its partial sum, then a second kernel adds the splits in a fixed
// order, so results are deterministic run to run.
//
// Column layouts (the wrappers pack the module's weights to match, once per
// parameter version: fused_pe.py's k2_weights, rm_train.cu's pack kernel):
//   C4 [N, 320]: cols 0..255 = h3, cols 256..318 = xp (63-wide PE), 319 = 0
//   V  [N, 288]: cols 0..255 = relu feature, 256 = density pre-activation,
//                cols 257..283 = view PE (27 wide), 284..287 = 0
//   W0 [63,256], W1..W3 [256,256], W4 [319,256] (rows: h3 then xp),
//   W5, W6 [256,256], W7p [256,257] (cols: features then density),
//   Wr0p [284,128] (rows: feature, a zero row for the density, view),
//   Wr1 [128,3]; biases b0..b6 [256], b7p [257], br0 [128], br1 [3].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Launch, then return the launch's error code from the enclosing function.
#define NIW_LAUNCH(...)                                   \
  do {                                                    \
    __VA_ARGS__;                                          \
    cudaError_t e_ = cudaGetLastError();                  \
    if (e_ != cudaSuccess) return (int)e_;                \
  } while (0)

namespace niw {

constexpr int L3D = 10;
constexpr int LVIEW = 4;
constexpr int D_X = 63;       // 3 + 6 * L3D
constexpr int D_V = 27;       // 3 + 6 * LVIEW
constexpr int LD_C4 = 320;
constexpr int LD_V = 288;
constexpr int COL_XP = 256;
constexpr int COL_DENS = 256;
constexpr int COL_VIEW = 257;
constexpr int D_HID = 256;
constexpr int D_HEAD = 128;
constexpr int K_WR0 = 284;
constexpr int N_W7 = 257;

// Weight pointer slots, in the order the wrapper passes them.
enum { W0 = 0, W1, W2, W3, W4, W5, W6, W7, WR0, WR1,
       B0, B1, B2, B3, B4, B5, B6, B7, BR0, BR1 };

// ------------------------------------------------------------------ SGEMM
// C[M,N] (+)= epi(op(A)[M,K] @ op(B)[K,N] + bias); op(A)(m,k) =
// TA ? A[k*lda+m] : A[m*lda+k], op(B)(k,n) = TB ? B[n*ldb+k] : B[k*ldb+n].
// Split mode (gridDim.z > 1): split z reduces k in [z*k_split, ...) and
// writes its partial to C + z*c_split_stride with no epilogue.
struct GemmArgs {
  const float* A; const float* B; float* C;
  int M, N, K, lda, ldb, ldc;
  const float* bias;      // [N] or null
  int relu_cols;          // columns n < relu_cols get ReLU
  const float* mask;      // ReLU' mask source or null
  int ldm, mask_cols;     // columns n < mask_cols keep v only where mask > 0
  int beta;               // 1: C += result
  int k_split;
  long long c_split_stride;
};

constexpr int GB_M = 128, GB_N = 128, GB_K = 16, G_PAD = 4;
constexpr int G_LOADS = GB_M * GB_K / 256;   // elements of A (and of B) per thread per k-tile

// One k-tile of op(A) and op(B) from global memory into registers (zero
// outside [M, kend) x [N, kend)). Lanes run along the contiguous dimension.
template <bool TA, bool TB>
__device__ __forceinline__ void gemm_load_tile(const GemmArgs& p, int m0, int n0, int k0,
                                               int kend, float (&ra)[G_LOADS],
                                               float (&rb)[G_LOADS]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < G_LOADS; i++) {
    const int e = tid + i * 256;
    int kk, mm, nn;
    if (TA) { mm = e & (GB_M - 1); kk = e >> 7; } else { kk = e & (GB_K - 1); mm = e >> 4; }
    int gm = m0 + mm, gk = k0 + kk;
    ra[i] = (gm < p.M && gk < kend)
        ? (TA ? p.A[(size_t)gk * p.lda + gm] : p.A[(size_t)gm * p.lda + gk]) : 0.f;
    if (TB) { kk = e & (GB_K - 1); nn = e >> 4; } else { nn = e & (GB_N - 1); kk = e >> 7; }
    const int gn = n0 + nn;
    gk = k0 + kk;
    rb[i] = (gn < p.N && gk < kend)
        ? (TB ? p.B[(size_t)gn * p.ldb + gk] : p.B[(size_t)gk * p.ldb + gn]) : 0.f;
  }
}

template <bool TA, bool TB>
__device__ __forceinline__ void gemm_store_tile(float (*As)[GB_M + G_PAD],
                                                float (*Bs)[GB_N + G_PAD],
                                                const float (&ra)[G_LOADS],
                                                const float (&rb)[G_LOADS]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < G_LOADS; i++) {
    const int e = tid + i * 256;
    if (TA) As[e >> 7][e & (GB_M - 1)] = ra[i]; else As[e & (GB_K - 1)][e >> 4] = ra[i];
    if (TB) Bs[e & (GB_K - 1)][e >> 4] = rb[i]; else Bs[e >> 7][e & (GB_N - 1)] = rb[i];
  }
}

// Epilogue of one output element (bias, accumulate, ReLU, ReLU' mask).
__device__ __forceinline__ float gemm_epilogue(const GemmArgs& p, const float* C, int m,
                                               int n, float v) {
  if (p.bias) v += p.bias[n];
  if (p.beta) v += C[(size_t)m * p.ldc + n];
  if (n < p.relu_cols) v = fmaxf(v, 0.f);
  if (p.mask && n < p.mask_cols && !(p.mask[(size_t)m * p.ldm + n] > 0.f)) v = 0.f;
  return v;
}

// 128x128 output tile per CTA, 8x8 outputs per thread, k-tiles of 16
// double-buffered in shared memory: the next tile's global loads are in
// flight while the current tile's FMAs run; one barrier per k-tile.
template <bool TA, bool TB>
static __global__ void __launch_bounds__(256, 2) gemm_kernel(GemmArgs p) {
  __shared__ __align__(16) float As[2][GB_K][GB_M + G_PAD];
  __shared__ __align__(16) float Bs[2][GB_K][GB_N + G_PAD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;
  const int kbeg = blockIdx.z * p.k_split;
  const int kend = min(p.K, kbeg + p.k_split);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; i++)
#pragma unroll
    for (int j = 0; j < 8; j++) acc[i][j] = 0.f;

  float ra[G_LOADS], rb[G_LOADS];
  gemm_load_tile<TA, TB>(p, m0, n0, kbeg, kend, ra, rb);
  gemm_store_tile<TA, TB>(As[0], Bs[0], ra, rb);
  __syncthreads();
  int buf = 0;
  for (int k0 = kbeg; k0 < kend; k0 += GB_K) {
    const bool next = k0 + GB_K < kend;
    if (next) gemm_load_tile<TA, TB>(p, m0, n0, k0 + GB_K, kend, ra, rb);
#pragma unroll
    for (int kk = 0; kk < GB_K; kk++) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4 + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; i++)
#pragma unroll
        for (int j = 0; j < 8; j++) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (next) gemm_store_tile<TA, TB>(As[buf ^ 1], Bs[buf ^ 1], ra, rb);
    __syncthreads();
    buf ^= 1;
  }

  float* C = p.C + (long long)blockIdx.z * p.c_split_stride;
  const bool split = gridDim.z > 1;
  // float4 stores where every row start of C is 16-byte aligned
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
        v[j] = (split || nb + j >= p.N) ? acc[i][g * 4 + j]
                                        : gemm_epilogue(p, C, m, nb + j, acc[i][g * 4 + j]);
      if (vec && nb + 3 < p.N) {
        *reinterpret_cast<float4*>(&C[(size_t)m * p.ldc + nb]) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; j++)
          if (nb + j < p.N) C[(size_t)m * p.ldc + nb + j] = v[j];
      }
    }
  }
}

static GemmArgs gemm_args(const float* A, int lda, const float* B, int ldb,
                          float* C, int ldc, int M, int N, int K) {
  GemmArgs p;
  p.A = A; p.B = B; p.C = C; p.M = M; p.N = N; p.K = K;
  p.lda = lda; p.ldb = ldb; p.ldc = ldc;
  p.bias = nullptr; p.relu_cols = 0; p.mask = nullptr; p.ldm = 0;
  p.mask_cols = 0; p.beta = 0; p.k_split = K; p.c_split_stride = 0;
  return p;
}

template <bool TA, bool TB>
static int launch_gemm(const GemmArgs& p, int splits, cudaStream_t s) {
  dim3 grid((p.N + GB_N - 1) / GB_N, (p.M + GB_M - 1) / GB_M, splits);
  NIW_LAUNCH(gemm_kernel<TA, TB><<<grid, 256, 0, s>>>(p));
  return 0;
}

// The GEMM route of a launch sequence, a template parameter of mlp_forward
// and mlp_backward: the routes of gemm_tc.cuh (every field kernel, K1-K5) or
// this CUDA-core SGEMM, which no kernel launches any more (chip_k2_gemm.py's
// baseline). launch<TA, TB, B_WEIGHT>: B_WEIGHT says that B is a layer
// weight (the forward and input-gradient products), which a route may read
// in its own packing; ld(natural) is a weight's leading dimension in that
// packing. With col_sums, a route also writes, in split mode, each split's
// column sums of op(B) to col_sums[z * N + n] (the bias gradient of a
// weight-gradient product, which weight_grad asks for); this one refuses.
struct SimtGemm {
  static int ld(int natural) { return natural; }

  template <bool TA, bool TB, bool B_WEIGHT>
  int launch(const GemmArgs& p, int splits, cudaStream_t s, float* col_sums = nullptr) const {
    return col_sums ? (int)cudaErrorInvalidValue : launch_gemm<TA, TB>(p, splits, s);
  }
};

// out[i] = sum_z part[z * stride + i], in split order (deterministic).
static __global__ void reduce_splits_kernel(const float* part, long long stride,
                                            int splits, int count, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int z = 0; z < splits; z++) s += part[(long long)z * stride + i];
  out[i] = s;
}

// Split plan for reductions over the N sample rows: splits of at least
// 1,024 rows, at most 64. A 256 x 256 weight gradient then has 4 tiles x 64
// splits = 256 CTAs, about one wave of the card's 132 SMs x 2, from 65,536
// samples (K5 and K1 at [1,1024] x 64) up; 2,048-row splits left it at 128
// CTAs there, and its products 1.3x slower (PERF.md, section 5).
struct Splits {
  int n, rows;
};
static Splits plan_splits(int M) {
  Splits sp;
  sp.n = min(64, max(1, (M + 1023) / 1024));
  sp.rows = (((M + sp.n - 1) / sp.n) + 7) / 8 * 8;
  sp.n = (M + sp.rows - 1) / sp.rows;
  return sp;
}

// dW[Kin, Nout] = A[M, Kin]^T @ G[M, Nout] and db[Nout] = colsum(G), the
// column sums taken inside the product, with deterministic two-pass split
// reductions through `part`.
template <class Gemm>
static int weight_grad(const Gemm& gemm, const float* A, int lda, int Kin, const float* G,
                       int ldg, int Nout, int M, float* dW, float* db, float* part,
                       cudaStream_t s) {
  const Splits sp = plan_splits(M);
  GemmArgs p = gemm_args(A, lda, G, ldg, part, Nout, Kin, Nout, M);
  p.k_split = sp.rows;
  p.c_split_stride = (long long)Kin * Nout;
  const int cnt = Kin * Nout;
  // the bias gradient's partials: after the product's (cnt + Nout <= PART_PER_SPLIT)
  float* col_part = part + (long long)sp.n * cnt;
  int err = gemm.template launch<true, false, false>(p, sp.n, s, col_part);
  if (err) return err;
  NIW_LAUNCH(reduce_splits_kernel<<<(cnt + 255) / 256, 256, 0, s>>>(
      part, (long long)cnt, sp.n, cnt, dW));
  NIW_LAUNCH(reduce_splits_kernel<<<(Nout + 255) / 256, 256, 0, s>>>(
      col_part, (long long)Nout, sp.n, Nout, db));
  return 0;
}

// x rounded to bf16 (to nearest, ties to even, as __float2bfloat16_rn and
// PyTorch's .to(torch.bfloat16) round), as an fp32 value.
__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------- PE and density
__device__ __forceinline__ float pe_freq(int k) {
  // f32(2^k) * f32(pi), the JAX package's rounding of the band frequency
  return __fmul_rn((float)(1 << k), 3.14159265358979323846f);
}

__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// Density activation (activ 0 softplus, 1 relu) and its derivative.
__device__ __forceinline__ float density_f(int activ, float pre) {
  return activ == 0 ? softplus_f(pre) : fmaxf(pre, 0.f);
}
__device__ __forceinline__ float density_grad_f(int activ, float pre) {
  return activ == 0 ? sigmoid_f(pre) : (pre > 0.f ? 1.f : 0.f);
}

// Point PE of one sample into C4[s, 256..319] and view PE into V[s, 257..287].
// xp = [pts, per dim d: w_k sin(f_k p_d) (k<L), w_k cos(f_k p_d) (k<L)];
// pts = center + ray * depth rounded per operation (no FMA contraction), as
// the plain path computes it.
static __global__ void encode_kernel(const float* center, const float* ray,
                                     const float* depth, int R, int K,
                                     const float* w3, const float* wv,
                                     float* C4, float* V) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= (long long)R * K) return;
  const int r = (int)(s / K);
  const float d = depth[s];
  float pts[3], ru[3];
  float nrm2 = 0.f;
  for (int c = 0; c < 3; c++) {
    const float rc = ray[r * 3 + c];
    pts[c] = __fadd_rn(center[r * 3 + c], __fmul_rn(rc, d));
    nrm2 = __fmaf_rn(rc, rc, nrm2);
  }
  const float nrm = fmaxf(sqrtf(nrm2), 1e-12f);
  for (int c = 0; c < 3; c++) ru[c] = __fdiv_rn(ray[r * 3 + c], nrm);
  float* x = C4 + s * LD_C4 + COL_XP;
  for (int c = 0; c < 3; c++) x[c] = pts[c];
  for (int c = 0; c < 3; c++)
    for (int k = 0; k < L3D; k++) {
      const float pre = __fmul_rn(pts[c], pe_freq(k));
      x[3 + c * 2 * L3D + k] = w3[k] * sinf(pre);
      x[3 + c * 2 * L3D + L3D + k] = w3[k] * cosf(pre);
    }
  x[D_X] = 0.f;
  float* v = V + s * LD_V + COL_VIEW;
  for (int c = 0; c < 3; c++) v[c] = ru[c];
  for (int c = 0; c < 3; c++)
    for (int k = 0; k < LVIEW; k++) {
      const float pre = __fmul_rn(ru[c], pe_freq(k));
      v[3 + c * 2 * LVIEW + k] = wv[k] * sinf(pre);
      v[3 + c * 2 * LVIEW + LVIEW + k] = wv[k] * cosf(pre);
    }
  for (int i = D_V; i < LD_V - COL_VIEW; i++) v[i] = 0.f;
}

// ---------------------------------------------------------- MLP forward
struct Cache {      // activation buffers of one call
  float *C4, *H0, *H1, *H2, *H4, *H5, *H6, *V, *R0;
};

// Trunk + first head layer for N samples; writes the caches. W[W0..WR0] in
// the route's packing (Gemm::ld).
template <class Gemm>
static int mlp_forward(const Gemm& gemm, const float* const* W, const Cache& c, int N,
                       cudaStream_t s) {
  int err;
  GemmArgs p;
  // layer 0: xp [N,63] -> H0
  p = gemm_args(c.C4 + COL_XP, LD_C4, W[W0], gemm.ld(D_HID), c.H0, D_HID, N, D_HID, D_X);
  p.bias = W[B0]; p.relu_cols = D_HID;
  if ((err = gemm.template launch<false, false, true>(p, 1, s))) return err;
  p = gemm_args(c.H0, D_HID, W[W1], gemm.ld(D_HID), c.H1, D_HID, N, D_HID, D_HID);
  p.bias = W[B1]; p.relu_cols = D_HID;
  if ((err = gemm.template launch<false, false, true>(p, 1, s))) return err;
  p = gemm_args(c.H1, D_HID, W[W2], gemm.ld(D_HID), c.H2, D_HID, N, D_HID, D_HID);
  p.bias = W[B2]; p.relu_cols = D_HID;
  if ((err = gemm.template launch<false, false, true>(p, 1, s))) return err;
  // layer 3 writes h3 into the skip buffer C4[:, :256]
  p = gemm_args(c.H2, D_HID, W[W3], gemm.ld(D_HID), c.C4, LD_C4, N, D_HID, D_HID);
  p.bias = W[B3]; p.relu_cols = D_HID;
  if ((err = gemm.template launch<false, false, true>(p, 1, s))) return err;
  // layer 4 (skip): [h3, xp] [N,319] -> H4
  p = gemm_args(c.C4, LD_C4, W[W4], gemm.ld(D_HID), c.H4, D_HID, N, D_HID, D_HID + D_X);
  p.bias = W[B4]; p.relu_cols = D_HID;
  if ((err = gemm.template launch<false, false, true>(p, 1, s))) return err;
  p = gemm_args(c.H4, D_HID, W[W5], gemm.ld(D_HID), c.H5, D_HID, N, D_HID, D_HID);
  p.bias = W[B5]; p.relu_cols = D_HID;
  if ((err = gemm.template launch<false, false, true>(p, 1, s))) return err;
  p = gemm_args(c.H5, D_HID, W[W6], gemm.ld(D_HID), c.H6, D_HID, N, D_HID, D_HID);
  p.bias = W[B6]; p.relu_cols = D_HID;
  if ((err = gemm.template launch<false, false, true>(p, 1, s))) return err;
  // layer 7: relu(features) into V[:, :256], raw density into V[:, 256]
  p = gemm_args(c.H6, D_HID, W[W7], gemm.ld(N_W7), c.V, LD_V, N, N_W7, D_HID);
  p.bias = W[B7]; p.relu_cols = D_HID;
  if ((err = gemm.template launch<false, false, true>(p, 1, s))) return err;
  // head layer 0: [feature, density(zero row), view] [N,284] -> R0
  p = gemm_args(c.V, LD_V, W[WR0], gemm.ld(D_HEAD), c.R0, D_HEAD, N, D_HEAD, K_WR0);
  p.bias = W[BR0]; p.relu_cols = D_HEAD;
  return gemm.template launch<false, false, true>(p, 1, s);
}

// ------------------------------------------------------- compositing
// One CTA per ray, one thread per sample (blockDim >= K; the wrapper caps K).
// Forward: rgb head output layer + sigmoid, density activation, quadrature
// dist = intv * |ray| (last interval 1e10), alpha, exclusive transmittance
// scan, per-ray sums -> out [R,8] = (rgb, depth, opacity, 0, 0, 0).
// With `train` != 0, also the compositing backward for a per-ray cotangent
// (g_rgb, g_depth, g_opacity), and writes GR0 [N,128] (cotangent at head
// layer 0, ReLU'-masked), GRP [N,4] (cotangent of the rgb pre-activation),
// GDENS [N] (of the density pre-activation) and dray_quad [R,3] (the |ray|
// quadrature chain). train == COMPOSITE_MSE forms the cotangent in-kernel:
// g_rgb = 2 valid (rgb_final - target), with the background term in
// g_opacity when has_bg, and no depth term. train == COMPOSITE_COTANGENT
// reads it from g8 [R,8] = (g_rgb, g_depth, g_opacity, unused); a
// background colour is then the caller's business (it reaches this kernel
// inside g_opacity). `out` may be null when the forward sums are not wanted.
// `noise` [R,K] (or null) is added to the density pre-activation before its
// activation, whose derivative is then taken at the noised value; `prob`
// [R,K] (or null) receives the per-sample compositing weights T * alpha.
// With `round_bf16` (tpu.compute_dtype: bfloat16) both operands of the head's
// output-layer product (R0 and Wr1) and of its input gradient (the rgb
// pre-activation's cotangent and Wr1) are rounded to bf16 first.
enum { COMPOSITE_FORWARD = 0, COMPOSITE_MSE = 1, COMPOSITE_COTANGENT = 2 };

struct CompositeArgs {
  const float *ray, *depth, *R0, *V, *Wr1, *br1, *target8, *g8, *noise;
  int R, K, activ, train, has_bg, round_bf16;
  float bg;
  float *out, *GR0, *GRP, *GDENS, *dray_quad, *prob;
};

static __global__ void composite_kernel(CompositeArgs a) {
  extern __shared__ float sm[];
  const int K = a.K;
  float* s_sd = sm;            // sigma * dist, then g_prefix
  float* s_x = sm + K;         // exclusive prefix / suffix sums
  float* s_red = sm + 2 * K;   // [K][6] per-sample terms for per-ray sums
  __shared__ float wr1[D_HEAD * 3];
  __shared__ float ray_s[8];   // ray(3), ray_len, sums(4)...
  __shared__ float tot[8];
  const int r = blockIdx.x, k = threadIdx.x;
  for (int i = k; i < D_HEAD * 3; i += blockDim.x)
    wr1[i] = a.round_bf16 ? bf16_rn(a.Wr1[i]) : a.Wr1[i];
  if (k == 0) {
    float n2 = 0.f;
    for (int c = 0; c < 3; c++) { ray_s[c] = a.ray[r * 3 + c]; n2 = __fmaf_rn(ray_s[c], ray_s[c], n2); }
    ray_s[3] = sqrtf(n2);
  }
  __syncthreads();
  const bool act = k < K;
  const long long s = (long long)r * K + k;
  float rgb[3] = {0.f, 0.f, 0.f}, sigma = 0.f, pre = 0.f, dist = 0.f, sd = 0.f, d = 0.f;
  const float* r0 = a.R0 + s * D_HEAD;
  if (act) {
    float acc[3] = {a.br1[0], a.br1[1], a.br1[2]};
    for (int j = 0; j < D_HEAD; j++) {
      const float h = a.round_bf16 ? bf16_rn(r0[j]) : r0[j];
      for (int c = 0; c < 3; c++) acc[c] = fmaf(h, wr1[j * 3 + c], acc[c]);
    }
    for (int c = 0; c < 3; c++) rgb[c] = sigmoid_f(acc[c]);
    pre = a.V[s * LD_V + COL_DENS];
    if (a.noise) pre += a.noise[s];
    sigma = density_f(a.activ, pre);
    d = a.depth[s];
    const float intv = (k + 1 < K) ? a.depth[s + 1] - d : 1e10f;
    dist = intv * ray_s[3];
    sd = sigma * dist;
    s_sd[k] = sd;
  }
  __syncthreads();
  if (k == 0) {
    float acc = 0.f;
    for (int i = 0; i < K; i++) { s_x[i] = acc; acc += s_sd[i]; }
  }
  __syncthreads();
  float e_sd = 0.f, alpha = 0.f, T = 0.f, w = 0.f;
  if (act) {
    e_sd = expf(-sd);
    alpha = 1.f - e_sd;
    T = expf(-s_x[k]);
    w = T * alpha;
    if (a.prob) a.prob[s] = w;
    float* red = s_red + k * 6;
    red[0] = w * rgb[0]; red[1] = w * rgb[1]; red[2] = w * rgb[2];
    red[3] = w * d; red[4] = w;
  }
  __syncthreads();
  if (k == 0) {
    for (int c = 0; c < 5; c++) {
      float acc = 0.f;
      for (int i = 0; i < K; i++) acc += s_red[i * 6 + c];
      tot[c] = acc;
    }
    if (a.out) {
      float* o = a.out + r * 8;
      for (int c = 0; c < 5; c++) o[c] = tot[c];
      o[5] = o[6] = o[7] = 0.f;
    }
    if (a.train == COMPOSITE_COTANGENT) {
      const float* g = a.g8 + r * 8;
      for (int c = 0; c < 3; c++) tot[c] = g[c];
      tot[5] = g[4];
      tot[6] = g[3];
    } else if (a.train == COMPOSITE_MSE) {   // MSE cotangent of the per-ray rgb (and opacity)
      const float* t = a.target8 + r * 8;
      const float valid = t[3];
      float gop = 0.f;
      for (int c = 0; c < 3; c++) {
        const float fin = a.has_bg ? tot[c] + a.bg * (1.f - tot[4]) : tot[c];
        tot[c] = 2.f * valid * (fin - t[c]);
        gop -= tot[c] * a.bg;
      }
      tot[5] = a.has_bg ? gop : 0.f;
    }
  }
  __syncthreads();
  if (!a.train) return;
  // compositing backward
  float g_wgt = 0.f, g_alpha = 0.f;
  if (act) {
    g_wgt = tot[0] * rgb[0] + tot[1] * rgb[1] + tot[2] * rgb[2] + tot[5];
    if (a.train == COMPOSITE_COTANGENT) g_wgt += tot[6] * d;   // depth = sum_k w_k d_k
    g_alpha = g_wgt * T;
    s_sd[k] = -(g_wgt * alpha) * T;      // g_prefix
  }
  __syncthreads();
  if (k == 0) {   // suffix: sum_{j>i} g_prefix[j]
    float acc = 0.f;
    for (int i = K - 1; i >= 0; i--) { s_x[i] = acc; acc += s_sd[i]; }
  }
  __syncthreads();
  if (act) {
    const float g_s = g_alpha * e_sd + s_x[k];
    s_red[k * 6] = (g_s * sigma) * dist;   // g_dist * dist
    const float g_sigma = g_s * dist;
    a.GDENS[s] = g_sigma * density_grad_f(a.activ, pre);
    float grp[3];
    for (int c = 0; c < 3; c++) {
      const float g_rgb = w * tot[c];
      grp[c] = g_rgb * rgb[c] * (1.f - rgb[c]);
      a.GRP[s * 4 + c] = grp[c];
    }
    a.GRP[s * 4 + 3] = 0.f;
    if (a.round_bf16)
      for (int c = 0; c < 3; c++) grp[c] = bf16_rn(grp[c]);
    float* gr0 = a.GR0 + s * D_HEAD;
    for (int j = 0; j < D_HEAD; j++) {
      const float g = grp[0] * wr1[j * 3] + grp[1] * wr1[j * 3 + 1] + grp[2] * wr1[j * 3 + 2];
      gr0[j] = r0[j] > 0.f ? g : 0.f;
    }
  }
  __syncthreads();
  if (k == 0) {
    float acc = 0.f;
    for (int i = 0; i < K; i++) acc += s_red[i * 6];
    const float g_len = acc / ray_s[3];
    for (int c = 0; c < 3; c++) a.dray_quad[r * 3 + c] = ray_s[c] * (g_len / ray_s[3]);
  }
}

static int launch_composite(const CompositeArgs& a, cudaStream_t s) {
  const int threads = ((a.K + 31) / 32) * 32;
  const size_t smem = sizeof(float) * (size_t)a.K * 8;
  NIW_LAUNCH(composite_kernel<<<a.R, threads, smem, s>>>(a));
  return 0;
}

// ------------------------------------------------- per-sample head
// The output layer without compositing (K5, K1): rgb = sigmoid(R0 @ Wr1 +
// br1), density = activ(V[:, 256] + noise) -> out [N,4]. One warp per
// sample at a time, each warp striding over the samples: lane l reads
// columns l, l + 32, l + 64, l + 96 of the sample's R0 row (coalesced 128-byte
// rows; a thread per sample would read 512 bytes apart) and keeps its 12
// weights of Wr1 in registers; the three dot products are summed per lane
// in column order, then across the warp in a fixed butterfly, so forward
// and backward compute the same bits. Memory bounds both: R0 is 512 bytes
// per sample, the backward writes as much again (GR0). `out` and GRP take
// 16-byte stores (the wrapper's [N,4] output and grads_at's buffer are
// 16-byte aligned).
constexpr int HEAD_WARPS = 8;             // warps per block
constexpr int HEAD_SAMPLES_PER_WARP = 8;  // samples per warp, on average

struct HeadWeights {
  float w[D_HEAD / 32][3];
};

__device__ __forceinline__ HeadWeights head_weights(const float* Wr1, int lane) {
  HeadWeights hw;
#pragma unroll
  for (int i = 0; i < D_HEAD / 32; i++)
#pragma unroll
    for (int c = 0; c < 3; c++) hw.w[i][c] = Wr1[(lane + 32 * i) * 3 + c];
  return hw;
}

// rgb of one sample from its R0 row (h: the lane's four columns), on every lane.
__device__ __forceinline__ void head_rgb(const float (&h)[D_HEAD / 32], const HeadWeights& hw,
                                         const float* br1, float (&rgb)[3]) {
#pragma unroll
  for (int c = 0; c < 3; c++) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < D_HEAD / 32; i++) acc = fmaf(h[i], hw.w[i][c], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    rgb[c] = sigmoid_f(acc + br1[c]);
  }
}

static unsigned head_blocks(long long N) {
  const long long per_block = (long long)HEAD_WARPS * HEAD_SAMPLES_PER_WARP;
  return (unsigned)((N + per_block - 1) / per_block);
}

// With noise, the noised pre-activation is written back into V[:, 256] so
// that a backward on the kept cache needs no noise operand (the head reads
// that column through a zero row of Wr0p, and its weight-gradient row is
// dropped when the gradients are unpacked).
static __global__ void head_forward_kernel(const float* R0, float* V, const float* Wr1,
                                           const float* br1, const float* noise,
                                           long long N, int activ, float* out) {
  const int lane = threadIdx.x & 31;
  const HeadWeights hw = head_weights(Wr1, lane);
  const long long stride = (long long)gridDim.x * HEAD_WARPS;
  for (long long s = (long long)blockIdx.x * HEAD_WARPS + (threadIdx.x >> 5); s < N;
       s += stride) {
    float h[D_HEAD / 32], rgb[3];
#pragma unroll
    for (int i = 0; i < D_HEAD / 32; i++) h[i] = R0[s * D_HEAD + lane + 32 * i];
    head_rgb(h, hw, br1, rgb);
    if (lane == 0) {
      float pre = V[s * LD_V + COL_DENS];
      if (noise) {
        pre += noise[s];
        V[s * LD_V + COL_DENS] = pre;
      }
      *reinterpret_cast<float4*>(out + s * 4) =
          make_float4(rgb[0], rgb[1], rgb[2], density_f(activ, pre));
    }
  }
}

// Backward of the head for a per-sample cotangent g [N,4] of (rgb, density):
// fills GR0 [N,128] (ReLU'-masked cotangent at head layer 0), GRP [N,4] (of
// the rgb pre-activation) and GDENS [N] (of the density pre-activation), as
// composite_kernel's backward does, from the kept R0 and V.
static __global__ void head_backward_kernel(const float* R0, const float* V,
                                            const float* Wr1, const float* br1,
                                            const float* g, long long N, int activ,
                                            float* GR0, float* GRP, float* GDENS) {
  const int lane = threadIdx.x & 31;
  const HeadWeights hw = head_weights(Wr1, lane);
  const long long stride = (long long)gridDim.x * HEAD_WARPS;
  for (long long s = (long long)blockIdx.x * HEAD_WARPS + (threadIdx.x >> 5); s < N;
       s += stride) {
    float h[D_HEAD / 32], rgb[3], grp[3];
#pragma unroll
    for (int i = 0; i < D_HEAD / 32; i++) h[i] = R0[s * D_HEAD + lane + 32 * i];
    head_rgb(h, hw, br1, rgb);
#pragma unroll
    for (int c = 0; c < 3; c++) grp[c] = g[s * 4 + c] * rgb[c] * (1.f - rgb[c]);
    if (lane == 0) {
      *reinterpret_cast<float4*>(GRP + s * 4) = make_float4(grp[0], grp[1], grp[2], 0.f);
      GDENS[s] = g[s * 4 + 3] * density_grad_f(activ, V[s * LD_V + COL_DENS]);
    }
#pragma unroll
    for (int i = 0; i < D_HEAD / 32; i++) {
      const float v = grp[0] * hw.w[i][0] + grp[1] * hw.w[i][1] + grp[2] * hw.w[i][2];
      GR0[s * D_HEAD + lane + 32 * i] = h[i] > 0.f ? v : 0.f;
    }
  }
}

// K1's inputs arrive encoded: xp [N,63] into C4[:, 256:320] and view [N,27]
// into V[:, 257:288] (zero beyond), where encode_kernel would write them.
static __global__ void copy_in_kernel(const float* xp, const float* view, long long N,
                                      float* C4, float* V) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int W = (LD_C4 - COL_XP) + (LD_V - COL_VIEW);
  if (i >= N * W) return;
  const long long s = i / W;
  const int j = (int)(i % W);
  if (j < LD_C4 - COL_XP) {
    C4[s * LD_C4 + COL_XP + j] = j < D_X ? xp[s * D_X + j] : 0.f;
  } else {
    const int v = j - (LD_C4 - COL_XP);
    V[s * LD_V + COL_VIEW + v] = v < D_V ? view[s * D_V + v] : 0.f;
  }
}

// ... and its input cotangents leave the same way: dxp [N,63] from
// GC4[:, 256:319], dview [N,27] from GV[:, 257:284].
static __global__ void copy_out_kernel(const float* GC4, const float* GV, long long N,
                                       float* dxp, float* dview) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int W = D_X + D_V;
  if (i >= N * W) return;
  const long long s = i / W;
  const int j = (int)(i % W);
  if (j < D_X) dxp[s * D_X + j] = GC4[s * LD_C4 + COL_XP + j];
  else dview[s * D_V + j - D_X] = GV[s * LD_V + COL_VIEW + j - D_X];
}

// ------------------------------------------------ per-ray input backward
// One CTA per ray, one thread per sample: PE backward of dxp (C4-gradient
// cols 256..318) to dpts, summed to dcenter and dray (dpts * depth); the
// view chain from dview (V-gradient cols 257..283) through ray / |ray|;
// plus the quadrature chain dray_quad where it is given (null for the
// per-sample kernels, whose compositing lies outside).
static __global__ void input_backward_kernel(const float* center, const float* ray,
                                             const float* depth, int K,
                                             const float* w3, const float* wv,
                                             const float* GC4, const float* GV,
                                             const float* dray_quad,
                                             float* dcenter, float* dray) {
  extern __shared__ float sm[];   // [K][6 + D_V]
  const int W = 6 + D_V;
  const int r = blockIdx.x, k = threadIdx.x;
  if (k < K) {
    const long long s = (long long)r * K + k;
    const float d = depth[s];
    float pts[3];
    for (int c = 0; c < 3; c++)
      pts[c] = __fadd_rn(center[r * 3 + c], __fmul_rn(ray[r * 3 + c], d));
    const float* dx = GC4 + s * LD_C4 + COL_XP;
    float dp[3];
    for (int c = 0; c < 3; c++) {
      float acc = dx[c];
      for (int kk = 0; kk < L3D; kk++) {
        const float f = pe_freq(kk);
        const float pre = __fmul_rn(pts[c], f);
        const float g_sin = dx[3 + c * 2 * L3D + kk] * w3[kk] * cosf(pre);
        const float g_cos = -dx[3 + c * 2 * L3D + L3D + kk] * w3[kk] * sinf(pre);
        acc += (g_sin + g_cos) * f;
      }
      dp[c] = acc;
    }
    float* row = sm + k * W;
    for (int c = 0; c < 3; c++) { row[c] = dp[c]; row[3 + c] = dp[c] * d; }
    const float* gv = GV + s * LD_V + COL_VIEW;
    for (int i = 0; i < D_V; i++) row[6 + i] = gv[i];
  }
  __syncthreads();
  if (k != 0) return;
  float tot[6 + D_V];
  for (int i = 0; i < W; i++) {
    float acc = 0.f;
    for (int kk = 0; kk < K; kk++) acc += sm[kk * W + i];
    tot[i] = acc;
  }
  float rr[3], n2 = 0.f;
  for (int c = 0; c < 3; c++) { rr[c] = ray[r * 3 + c]; n2 = __fmaf_rn(rr[c], rr[c], n2); }
  const float inv = 1.f / fmaxf(sqrtf(n2), 1e-12f);
  float ru[3], dru[3];
  for (int c = 0; c < 3; c++) ru[c] = __fdiv_rn(rr[c], fmaxf(sqrtf(n2), 1e-12f));
  const float* dvi = tot + 6;
  for (int c = 0; c < 3; c++) {
    float acc = dvi[c];
    for (int kk = 0; kk < LVIEW; kk++) {
      const float f = pe_freq(kk);
      const float pre = __fmul_rn(ru[c], f);
      acc += (dvi[3 + c * 2 * LVIEW + kk] * wv[kk] * cosf(pre)
              - dvi[3 + c * 2 * LVIEW + LVIEW + kk] * wv[kk] * sinf(pre)) * f;
    }
    dru[c] = acc;
  }
  const float dot = dru[0] * ru[0] + dru[1] * ru[1] + dru[2] * ru[2];
  for (int c = 0; c < 3; c++) {
    dcenter[r * 3 + c] = tot[c];
    const float quad = dray_quad ? dray_quad[r * 3 + c] : 0.f;
    dray[r * 3 + c] = tot[3 + c] + dru[c] * inv - ru[c] * (dot * inv) + quad;
  }
}

static __global__ void set_column_kernel(float* dst, int ld, int col, const float* src,
                                         long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i * ld + col] = src[i];
}

// --------------------------------------------------- buffers of one call
static long long cache_floats(long long N) {
  return N * (LD_C4 + 6 * D_HID + LD_V + D_HEAD);
}
// GDENS takes N floats rounded up to a multiple of 4, so that every buffer
// stays 16-byte aligned (the tensor-core route copies 16-byte chunks).
static long long grad_floats(long long N) {
  return N * (D_HEAD + 4 + LD_V + 2 * D_HID + LD_C4) + ((N + 3) & ~3LL);
}
static const long long PART_PER_SPLIT = 320 * 288;   // >= every Kin * Nout

// The full activation cache (every layer kept for a backward) at p.
static Cache cache_at(float* p, long long N) {
  Cache c;
  c.C4 = p; p += N * LD_C4;
  c.H0 = p; p += N * D_HID;
  c.H1 = p; p += N * D_HID;
  c.H2 = p; p += N * D_HID;
  c.H4 = p; p += N * D_HID;
  c.H5 = p; p += N * D_HID;
  c.H6 = p; p += N * D_HID;
  c.V = p; p += N * LD_V;
  c.R0 = p;
  return c;
}

// A forward that no backward follows reuses two hidden buffers layer to
// layer (ping-pong): scratch_floats(N) floats at p.
static long long scratch_floats(long long N) {
  return N * (LD_C4 + 2 * D_HID + LD_V + D_HEAD);
}
static Cache scratch_at(float* p, long long N) {
  Cache c;
  c.C4 = p;
  float* HA = c.C4 + N * LD_C4;
  float* HB = HA + N * D_HID;
  c.V = HB + N * D_HID;
  c.R0 = c.V + N * LD_V;
  c.H0 = HA; c.H1 = HB; c.H2 = HA; c.H4 = HB; c.H5 = HA; c.H6 = HB;
  return c;
}

struct GradBufs {   // cotangent buffers of one backward
  float *GR0, *GRP, *GDENS, *GV, *GA, *GB, *GC4, *part, *DRQ;
};

// grad_floats(N) + plan_splits(N).n * PART_PER_SPLIT + 3 R floats at p.
static GradBufs grads_at(float* p, long long N) {
  GradBufs g;
  g.GR0 = p; p += N * D_HEAD;
  g.GRP = p; p += N * 4;
  g.GDENS = p; p += (N + 3) & ~3LL;
  g.GV = p; p += N * LD_V;
  g.GA = p; p += N * D_HID;
  g.GB = p; p += N * D_HID;
  g.GC4 = p; p += N * LD_C4;
  g.part = p; p += plan_splits((int)N).n * PART_PER_SPLIT;
  g.DRQ = p;
  return g;
}

// ---------------------------------------------------------- MLP backward
// out (+)= G @ W^T for W [n_out, ldw] row-major, zeroed where mask <= 0 on
// columns < mask_cols (the ReLU derivative of the layer's input).
template <class Gemm>
static int grad_in(const Gemm& gemm, const float* G, int ldg, const float* Wt, int ldw,
                   float* out, int ldo, int N, int n_out, int k, const float* mask,
                   int ldm, int mask_cols, int beta, cudaStream_t s) {
  GemmArgs p = gemm_args(G, ldg, Wt, gemm.ld(ldw), out, ldo, N, n_out, k);
  p.mask = mask; p.ldm = ldm; p.mask_cols = mask_cols; p.beta = beta;
  return gemm.template launch<false, true, true>(p, 1, s);
}

// From the compositing backward's GR0, GRP and GDENS down to the input
// cotangents: GC4[:, 256:319] (of the point PE) and GV[:, 257:284] (of the
// view PE). With want_dw, also the 20 weight gradients into dW (split-K
// partial sums added in a fixed order); without, those ten GEMMs and bias
// sums are skipped and dW is not touched.
template <class Gemm>
static int mlp_backward(const Gemm& gemm, const float* const* W, const Cache& c,
                        const GradBufs& g, int n, int want_dw, float* const* dW,
                        cudaStream_t s) {
  int err;
  const long long N = n;
  float *GR0 = g.GR0, *GRP = g.GRP, *GV = g.GV, *GA = g.GA, *GB = g.GB, *GC4 = g.GC4;
  float* part = g.part;
  // rgb head
  if (want_dw) {
    if ((err = weight_grad(gemm, c.R0, D_HEAD, D_HEAD, GRP, 4, 3, n, dW[WR1], dW[BR1], part, s))) return err;
    if ((err = weight_grad(gemm, c.V, LD_V, K_WR0, GR0, D_HEAD, D_HEAD, n, dW[WR0], dW[BR0], part, s))) return err;
  }
  if ((err = grad_in(gemm, GR0, D_HEAD, W[WR0], D_HEAD, GV, LD_V, n, K_WR0, D_HEAD,
                     c.V, LD_V, D_HID, 0, s))) return err;
  NIW_LAUNCH(set_column_kernel<<<(unsigned)((N + 255) / 256), 256, 0, s>>>(
      GV, LD_V, COL_DENS, g.GDENS, N));
  // trunk, top down
  if (want_dw && (err = weight_grad(gemm, c.H6, D_HID, D_HID, GV, LD_V, N_W7, n, dW[W7], dW[B7], part, s))) return err;
  if ((err = grad_in(gemm, GV, LD_V, W[W7], N_W7, GA, D_HID, n, D_HID, N_W7, c.H6, D_HID, D_HID, 0, s))) return err;
  if (want_dw && (err = weight_grad(gemm, c.H5, D_HID, D_HID, GA, D_HID, D_HID, n, dW[W6], dW[B6], part, s))) return err;
  if ((err = grad_in(gemm, GA, D_HID, W[W6], D_HID, GB, D_HID, n, D_HID, D_HID, c.H5, D_HID, D_HID, 0, s))) return err;
  if (want_dw && (err = weight_grad(gemm, c.H4, D_HID, D_HID, GB, D_HID, D_HID, n, dW[W5], dW[B5], part, s))) return err;
  if ((err = grad_in(gemm, GB, D_HID, W[W5], D_HID, GA, D_HID, n, D_HID, D_HID, c.H4, D_HID, D_HID, 0, s))) return err;
  // skip layer: [h3, xp]
  if (want_dw && (err = weight_grad(gemm, c.C4, LD_C4, D_HID + D_X, GA, D_HID, D_HID, n, dW[W4], dW[B4], part, s))) return err;
  if ((err = grad_in(gemm, GA, D_HID, W[W4], D_HID, GC4, LD_C4, n, D_HID + D_X, D_HID,
                     c.C4, LD_C4, D_HID, 0, s))) return err;
  if (want_dw && (err = weight_grad(gemm, c.H2, D_HID, D_HID, GC4, LD_C4, D_HID, n, dW[W3], dW[B3], part, s))) return err;
  if ((err = grad_in(gemm, GC4, LD_C4, W[W3], D_HID, GB, D_HID, n, D_HID, D_HID, c.H2, D_HID, D_HID, 0, s))) return err;
  if (want_dw && (err = weight_grad(gemm, c.H1, D_HID, D_HID, GB, D_HID, D_HID, n, dW[W2], dW[B2], part, s))) return err;
  if ((err = grad_in(gemm, GB, D_HID, W[W2], D_HID, GA, D_HID, n, D_HID, D_HID, c.H1, D_HID, D_HID, 0, s))) return err;
  if (want_dw && (err = weight_grad(gemm, c.H0, D_HID, D_HID, GA, D_HID, D_HID, n, dW[W1], dW[B1], part, s))) return err;
  if ((err = grad_in(gemm, GA, D_HID, W[W1], D_HID, GB, D_HID, n, D_HID, D_HID, c.H0, D_HID, D_HID, 0, s))) return err;
  if (want_dw && (err = weight_grad(gemm, c.C4 + COL_XP, LD_C4, D_X, GB, D_HID, D_HID, n, dW[W0], dW[B0], part, s))) return err;
  // dxp = skip-path part (already in GC4[:, 256:319]) + layer-0 part
  return grad_in(gemm, GB, D_HID, W[W0], D_HID, GC4 + COL_XP, LD_C4, n, D_X, D_HID,
                 nullptr, 0, 0, 1, s);
}

static int launch_input_backward(const float* center, const float* ray, const float* depth,
                                 int R, int K, const float* w3, const float* wv,
                                 const GradBufs& g, bool quadrature, float* dcenter,
                                 float* dray, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)K * (6 + D_V);
  NIW_LAUNCH(input_backward_kernel<<<R, ((K + 31) / 32) * 32, smem, s>>>(
      center, ray, depth, K, w3, wv, g.GC4, g.GV, quadrature ? g.DRQ : nullptr,
      dcenter, dray));
  return 0;
}

}  // namespace niw
