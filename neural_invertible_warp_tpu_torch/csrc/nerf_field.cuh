// Shared device code of the composited NeRF field kernels (K2 train, K3 forward).
//
// Replaces the Pallas TPU kernels in neural_invertible_warp_tpu/ops/pallas/
// fused_pe.py (_rm_fwd_pe_kernel, _rm_train_pe_kernel) and the MLP math they
// share from fused_field.py (_forward_block, _mlp_backward).
//
// What bounds this on Hopper: the 8x256 trunk is ~1.06 MFLOP per sample
// forward and ~2.1 MFLOP backward, all fp32 (the PE must stay true fp32, and
// the MLP dots are fp32 until a quality A/B allows TF32). At the flagship
// train shape (2034 rays x 128 samples) that is ~0.83 TFLOP per step, so the
// CUDA-core fp32 FMA rate bounds it, not memory.
//
// Design (first, simple and correct): one launch sequence per call. Samples
// are rows of dense [N, C] fp32 buffers in a workspace the wrapper allocates;
// each MLP layer is one register-blocked SGEMM (128x128 tile, 8x8 outputs per
// thread, k-tiles of 16 double-buffered in shared memory, fp32 FMA, no
// tensor cores) with a fused bias/ReLU/ReLU'-mask
// epilogue. The activation cache that the TPU kept in VMEM lives in the
// workspace (~9 KB per sample forward, ~14 KB with the backward buffers).
// Per-ray work (PE, compositing with a sequential exclusive scan, the MSE
// cotangent, the PE/view/quadrature backward) runs one CTA per ray.
// Weight gradients reduce over samples in two passes: each CTA of a split
// writes its partial sum, then a second kernel adds the splits in a fixed
// order, so results are deterministic run to run.
//
// Column layouts (the wrapper packs the module's weights to match):
//   C4 [N, 320]: cols 0..255 = h3, cols 256..318 = xp (63-wide PE), 319 = 0
//   V  [N, 288]: cols 0..255 = relu feature, 256 = density pre-activation,
//                cols 257..283 = view PE (27 wide), 284..287 = 0
//   W0 [63,256], W1..W3 [256,256], W4 [319,256] (rows: h3 then xp),
//   W5, W6 [256,256], W7p [256,257] (cols: features then density),
//   Wr0p [284,128] (rows: feature, a zero row for the density, view),
//   Wr1 [128,3]; biases b0..b6 [256], b7p [257], br0 [128], br1 [3].
#pragma once

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

// out[i] = sum_z part[z * stride + i], in split order (deterministic).
static __global__ void reduce_splits_kernel(const float* part, long long stride,
                                            int splits, int count, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int z = 0; z < splits; z++) s += part[(long long)z * stride + i];
  out[i] = s;
}

// part[z * N + n] = sum over rows m of split z of G[m * ldg + n]. A block
// (32, 8) takes 32 columns; its 8 row lanes stride the split's rows and are
// added in a fixed order, so the sum is deterministic.
static __global__ void colsum_partial_kernel(const float* G, int ldg, int M, int N,
                                             int rows_per_split, float* part) {
  __shared__ float red[8][33];
  const int n = blockIdx.x * 32 + threadIdx.x;
  const int mb = blockIdx.y * rows_per_split;
  const int me = min(M, mb + rows_per_split);
  float s = 0.f;
  if (n < N) {
#pragma unroll 8
    for (int m = mb + threadIdx.y; m < me; m += 8) s += G[(size_t)m * ldg + n];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float t = 0.f;
    for (int y = 0; y < 8; y++) t += red[y][threadIdx.x];
    part[(size_t)blockIdx.y * N + n] = t;
  }
}

// Split plan for reductions over the N sample rows.
struct Splits {
  int n, rows;
};
static Splits plan_splits(int M) {
  Splits sp;
  sp.n = min(64, max(1, (M + 2047) / 2048));
  sp.rows = (((M + sp.n - 1) / sp.n) + 7) / 8 * 8;
  sp.n = (M + sp.rows - 1) / sp.rows;
  return sp;
}

// dW[Kin, Nout] = A[M, Kin]^T @ G[M, Nout] and db[Nout] = colsum(G), with
// deterministic two-pass split reductions through `part`.
static int weight_grad(const float* A, int lda, int Kin, const float* G, int ldg,
                       int Nout, int M, float* dW, float* db, float* part,
                       cudaStream_t s) {
  const Splits sp = plan_splits(M);
  GemmArgs p = gemm_args(A, lda, G, ldg, part, Nout, Kin, Nout, M);
  p.k_split = sp.rows;
  p.c_split_stride = (long long)Kin * Nout;
  int err = launch_gemm<true, false>(p, sp.n, s);
  if (err) return err;
  const int cnt = Kin * Nout;
  NIW_LAUNCH(reduce_splits_kernel<<<(cnt + 255) / 256, 256, 0, s>>>(
      part, (long long)cnt, sp.n, cnt, dW));
  dim3 g2((Nout + 31) / 32, sp.n);
  NIW_LAUNCH(colsum_partial_kernel<<<g2, dim3(32, 8), 0, s>>>(G, ldg, M, Nout, sp.rows, part));
  NIW_LAUNCH(reduce_splits_kernel<<<(Nout + 255) / 256, 256, 0, s>>>(
      part, (long long)Nout, sp.n, Nout, db));
  return 0;
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

// Trunk + first head layer for N samples; writes the caches.
static int mlp_forward(const float* const* W, const Cache& c, int N, cudaStream_t s) {
  int err;
  GemmArgs p;
  // layer 0: xp [N,63] -> H0
  p = gemm_args(c.C4 + COL_XP, LD_C4, W[W0], D_HID, c.H0, D_HID, N, D_HID, D_X);
  p.bias = W[B0]; p.relu_cols = D_HID;
  if ((err = launch_gemm<false, false>(p, 1, s))) return err;
  p = gemm_args(c.H0, D_HID, W[W1], D_HID, c.H1, D_HID, N, D_HID, D_HID);
  p.bias = W[B1]; p.relu_cols = D_HID;
  if ((err = launch_gemm<false, false>(p, 1, s))) return err;
  p = gemm_args(c.H1, D_HID, W[W2], D_HID, c.H2, D_HID, N, D_HID, D_HID);
  p.bias = W[B2]; p.relu_cols = D_HID;
  if ((err = launch_gemm<false, false>(p, 1, s))) return err;
  // layer 3 writes h3 into the skip buffer C4[:, :256]
  p = gemm_args(c.H2, D_HID, W[W3], D_HID, c.C4, LD_C4, N, D_HID, D_HID);
  p.bias = W[B3]; p.relu_cols = D_HID;
  if ((err = launch_gemm<false, false>(p, 1, s))) return err;
  // layer 4 (skip): [h3, xp] [N,319] -> H4
  p = gemm_args(c.C4, LD_C4, W[W4], D_HID, c.H4, D_HID, N, D_HID, D_HID + D_X);
  p.bias = W[B4]; p.relu_cols = D_HID;
  if ((err = launch_gemm<false, false>(p, 1, s))) return err;
  p = gemm_args(c.H4, D_HID, W[W5], D_HID, c.H5, D_HID, N, D_HID, D_HID);
  p.bias = W[B5]; p.relu_cols = D_HID;
  if ((err = launch_gemm<false, false>(p, 1, s))) return err;
  p = gemm_args(c.H5, D_HID, W[W6], D_HID, c.H6, D_HID, N, D_HID, D_HID);
  p.bias = W[B6]; p.relu_cols = D_HID;
  if ((err = launch_gemm<false, false>(p, 1, s))) return err;
  // layer 7: relu(features) into V[:, :256], raw density into V[:, 256]
  p = gemm_args(c.H6, D_HID, W[W7], N_W7, c.V, LD_V, N, N_W7, D_HID);
  p.bias = W[B7]; p.relu_cols = D_HID;
  if ((err = launch_gemm<false, false>(p, 1, s))) return err;
  // head layer 0: [feature, density(zero row), view] [N,284] -> R0
  p = gemm_args(c.V, LD_V, W[WR0], D_HEAD, c.R0, D_HEAD, N, D_HEAD, K_WR0);
  p.bias = W[BR0]; p.relu_cols = D_HEAD;
  return launch_gemm<false, false>(p, 1, s);
}

// ------------------------------------------------------- compositing
// One CTA per ray, one thread per sample (blockDim >= K; the wrapper caps K).
// Forward: rgb head output layer + sigmoid, density activation, quadrature
// dist = intv * |ray| (last interval 1e10), alpha, exclusive transmittance
// scan, per-ray sums -> out [R,8] = (rgb, depth, opacity, 0, 0, 0).
// With `train`, also the MSE cotangent g = 2 valid (rgb_final - target)
// (background term when has_bg), the compositing backward, and writes
// GR0 [N,128] (cotangent at head layer 0, ReLU'-masked), GRP [N,4]
// (cotangent of the rgb pre-activation), GDENS [N] (of the density
// pre-activation) and dray_quad [R,3] (the |ray| quadrature chain).
struct CompositeArgs {
  const float *ray, *depth, *R0, *V, *Wr1, *br1, *target8;
  int R, K, activ, train, has_bg;
  float bg;
  float *out, *GR0, *GRP, *GDENS, *dray_quad;
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
  for (int i = k; i < D_HEAD * 3; i += blockDim.x) wr1[i] = a.Wr1[i];
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
      const float h = r0[j];
      for (int c = 0; c < 3; c++) acc[c] = fmaf(h, wr1[j * 3 + c], acc[c]);
    }
    for (int c = 0; c < 3; c++) rgb[c] = sigmoid_f(acc[c]);
    pre = a.V[s * LD_V + COL_DENS];
    sigma = a.activ == 0 ? softplus_f(pre) : fmaxf(pre, 0.f);
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
    float* o = a.out + r * 8;
    for (int c = 0; c < 5; c++) o[c] = tot[c];
    o[5] = o[6] = o[7] = 0.f;
    if (a.train) {   // MSE cotangent of the per-ray rgb (and opacity)
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
    a.GDENS[s] = g_sigma * (a.activ == 0 ? sigmoid_f(pre) : (pre > 0.f ? 1.f : 0.f));
    float grp[3];
    for (int c = 0; c < 3; c++) {
      const float g_rgb = w * tot[c];
      grp[c] = g_rgb * rgb[c] * (1.f - rgb[c]);
      a.GRP[s * 4 + c] = grp[c];
    }
    a.GRP[s * 4 + 3] = 0.f;
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

// ------------------------------------------------ per-ray input backward
// One CTA per ray, one thread per sample: PE backward of dxp (C4-gradient
// cols 256..318) to dpts, summed to dcenter and dray (dpts * depth); the
// view chain from dview (V-gradient cols 257..283) through ray / |ray|;
// plus the quadrature chain dray_quad.
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
    dray[r * 3 + c] = tot[3 + c] + dru[c] * inv - ru[c] * (dot * inv) + dray_quad[r * 3 + c];
  }
}

static __global__ void set_column_kernel(float* dst, int ld, int col, const float* src,
                                         long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i * ld + col] = src[i];
}

}  // namespace niw
