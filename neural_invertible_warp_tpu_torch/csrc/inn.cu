// K6: the INN warp's three RealNVP coupling blocks in one kernel per
// direction, forward and backward.
//
// Replaces neural_invertible_warp_tpu/ops/pallas/fused_inn.py::_fwd_kernel and
// ::_bwd_kernel (fused_deform; wrapper fused_deform_forward). Per block i
// (focus axis 2, 1, 0; the two other axes in ascending order):
//   W_a = v_a g_a / max(|v_a|_row, 1e-12)          (weight norm, rows = units)
//   s   = w1_a . softplus100(rw2 (emb2(o0, o1) W_a[emb]) + code_i W_a[lat] + b_a) + b1_a
//   f'  = f - s
//   (th, t0, t1) = w1_b . softplus100(rw1 (emb1(f') W_b[emb]) + code_i W_b[lat] + b_b) + b1_b
//   (o0', o1') = R(-th) (o0 - t0, o1 - t1)
// emb_D(x) = [x, sin(f_0 x), cos(f_0 x), ..., sin(f_5 x), cos(f_5 x)] over the
// D coordinates (26 columns for D = 2, 13 for D = 1), f_l = f32(2^l) f32(pi);
// rw1 / rw2 [N] are the reference's point-axis windows, which scale the embed
// part of the pre-activation only; softplus100(x) = log(1 + exp(100 x)) / 100.
// Operands: pts [B,N,3], rw1, rw2 [N], codes [3,B,d_feat] (the per-block
// latent codes) and 30 weight tensors in the layout of the port's modules:
// per block, branch a then b: v [128, n_emb + d_feat], g [128], b [128],
// w1 [n_out,128], b1 [n_out]. Any B, N, d_feat >= 1.
//
// Bound: about 17,000 multiply-adds per point forward (3 x (26 + 13 + 4) x
// 128) and 30 weight tensors of 0.5 MB together: microseconds on this card.
// What the caller pays for is launches and host time, so the design is few
// launches, not peak arithmetic:
// - The latent part of a first layer is the same for every point of an
//   image. A preparation kernel (one warp per hidden unit and branch) takes
//   the row norm, the scale g / |v|, and per image the bias
//   cb = scale (code . v[lat]) + b. The [P, d_feat] latent operands and the
//   per-point latent matmul of the TPU kernel do not exist here; dcode is a
//   per-image sum.
// - Main kernels: one CTA of 128 threads per tile of 16 points of one image;
//   thread j owns hidden unit j, holds its 26 (13) scaled embed weights in
//   registers and walks the tile's points, whose embeddings sit in shared
//   memory (broadcast reads). Output layers reduce over the 128 units through
//   shared memory in a fixed order.
// - The backward recomputes (the TPU kernel does too): keeping the six
//   pre-activations would be 3 KB per point written and read back for 39
//   FMAs per unit; instead the forward pass of a tile keeps only each block's
//   input point and branch-b output in shared memory.
// - Weight gradients without atomics: thread j accumulates its own column of
//   dW over the tile in registers and adds it to the CTA's own partial
//   buffer; a second kernel adds the partials per image in a fixed order, and
//   an epilogue (one warp per unit and branch) adds the images, forms the
//   latent rows of dW from the per-image sums, and runs the weight-norm
//   backward. Two runs give the same bits.
// - fp32 FMAs, precise sinf / cosf / expf / log1pf, no fast-math, no TF32.
#include "nerf_field.cuh"

namespace niw {
namespace inn {

constexpr int H = 128;            // hidden width = threads per CTA
constexpr int PT = 16;            // points per tile
constexpr int LB = 6;             // PE bands
constexpr int NE_A = 2 + 4 * LB;  // embed columns of branch a (26)
constexpr int NE_B = 1 + 2 * LB;  // ... of branch b (13)
constexpr int HS = H + 1;         // padded shared-memory row
constexpr int MAX_CTAS = 528;     // 4 per SM
static_assert(PT * 8 == H, "the output reduction maps 8 lanes to each point");

// Partial weight-gradient buffer of one CTA (and of one image after the first
// reduction), per block: rows of H floats
//   0..25 dW_a embed rows | 26 dh_a sum (db0_a, and the image's dcb_a) |
//   27 dw1_a | 28..40 dW_b embed rows | 41 dh_b sum | 42..44 dw1_b
// then 8 floats: db1_a, db1_b[3], unused.
constexpr int ROW_A = 0, ROW_DH_A = NE_A, ROW_W1_A = NE_A + 1;
constexpr int ROW_B = NE_A + 2, ROW_DH_B = ROW_B + NE_B, ROW_W1_B = ROW_DH_B + 1;
constexpr int ROWS = ROW_W1_B + 3;
constexpr int PBLK = ROWS * H + 8;
constexpr int PCTA = 3 * PBLK;

// prep: per branch bi = 2 i + br, (2 + B) rows of H floats: scale, norm, cb[B]
__host__ __device__ inline long long prep_stride(int B) { return (long long)(2 + B) * H; }

__device__ __forceinline__ int focus_axis(int i) { return 2 - i; }
__device__ __forceinline__ int other_axis0(int i) { return i == 2 ? 1 : 0; }
__device__ __forceinline__ int other_axis1(int i) { return i == 0 ? 1 : 2; }

__device__ __forceinline__ float softplus100(float x) {
  return __fdiv_rn(softplus_f(100.f * x), 100.f);
}

struct Args {
  const float *pts, *rw1, *rw2, *codes, *g, *prep;
  const float* W[30];
  int B, N, d_feat, cpi;   // cpi: CTAs per image
  float *out, *dpts, *part;
};

// ------------------------------------------------------------- preparation
// One warp per (branch, hidden unit): norm, scale, and per image the bias.
static __global__ void prep_kernel(Args a, float* prep) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (warp >= 6 * H) return;
  const int bi = warp / H, j = warp % H, i = bi >> 1, br = bi & 1;
  const int ne = br ? NE_B : NE_A, n_in = ne + a.d_feat;
  const float* v = a.W[i * 10 + br * 5] + (size_t)j * n_in;
  float n2 = 0.f;
  for (int k = lane; k < n_in; k += 32) n2 = fmaf(v[k], v[k], n2);
  for (int off = 16; off; off >>= 1) n2 += __shfl_xor_sync(0xffffffffu, n2, off);
  const float norm = fmaxf(sqrtf(n2), 1e-12f);
  const float scale = __fdiv_rn(a.W[i * 10 + br * 5 + 1][j], norm);
  float* p = prep + bi * prep_stride(a.B);
  if (lane == 0) { p[j] = scale; p[H + j] = norm; }
  const float b0 = a.W[i * 10 + br * 5 + 2][j];
  for (int img = 0; img < a.B; img++) {
    const float* code = a.codes + ((size_t)i * a.B + img) * a.d_feat;
    float dot = 0.f;
    for (int d = lane; d < a.d_feat; d += 32) dot = fmaf(code[d], v[ne + d], dot);
    for (int off = 16; off; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) p[(2 + img) * H + j] = fmaf(dot, scale, b0);
  }
}

// ------------------------------------------------------------ shared state
struct Smem {
  float x[PT][3];        // the tile's points, updated block by block
  float e[PT][NE_A];     // embedding of the current branch's input
  float rw1[PT], rw2[PT];
  float hid[PT][HS];     // hidden activations (backward: dE)
  float w1[3][H];        // output-layer rows
  float out[PT][3];      // output of the current branch
};

struct SmemBwd : Smem {
  float xs[4][PT][3];    // input points of blocks 0..2, and the final output
  float th[3][PT][3];    // (theta, t0, t1) of each block
  float Ws[NE_A][HS];    // effective embed rows of the current branch, [k][j]
  float dx[PT][3];       // cotangent of the current block's output, then input
  float de[PT][NE_A];    // cotangent of each embed column, chained to its coordinate
  float dout[PT][3];     // cotangent of the current branch's output
};

// e[p][:] = emb_D of D coordinates of src[p]: column c < D the coordinate,
// then per band l: sin over the coordinates, cos over the coordinates.
template <int D>
__device__ __forceinline__ void embed(Smem& s, float (*src)[3], int ax0, int ax1) {
  constexpr int NE = D * (1 + 2 * LB);
  for (int idx = threadIdx.x; idx < PT * NE; idx += H) {
    const int p = idx / NE, c = idx % NE;
    float val;
    if (c < D) {
      val = src[p][c == 0 ? ax0 : ax1];
    } else {
      const int cc = c - D, l = cc / (2 * D), r = cc % (2 * D), d = r % D;
      const float ang = __fmul_rn(src[p][d == 0 ? ax0 : ax1], pe_freq(l));
      val = (r / D) ? cosf(ang) : sinf(ang);
    }
    s.e[p][c] = val;
  }
}

// The chain factor of embed column c onto its coordinate: 1 for the raw
// column, f_l cos(ang) for a sin column, -f_l sin(ang) for a cos column
// (both read from the partner column of the same band).
template <int D>
__device__ __forceinline__ float embed_chain(const Smem& s, int p, int c) {
  if (c < D) return 1.f;
  const int cc = c - D, l = cc / (2 * D), r = cc % (2 * D), d = r % D;
  const int band = D + l * 2 * D;
  return (r / D) ? -pe_freq(l) * s.e[p][band + d] : pe_freq(l) * s.e[p][band + D + d];
}

// Thread j's scaled embed weights of one branch.
template <int NE>
__device__ __forceinline__ void load_weights(const float* v, int n_in, float scale,
                                             float (&w)[NE]) {
  const float* row = v + (size_t)threadIdx.x * n_in;
#pragma unroll
  for (int k = 0; k < NE; k++) w[k] = row[k] * scale;
}

template <int NE>
__device__ __forceinline__ float pre_activation(const Smem& s, int p, const float (&w)[NE],
                                                float rw, float cb) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < NE; k++) acc = fmaf(s.e[p][k], w[k], acc);
  return fmaf(rw, acc, cb);
}

// out[p][c] = sum_j hid[p][j] w1[c][j] + b1[c]: 8 lanes per point, each over
// 16 strided units, then a butterfly over the 8 (a fixed order).
template <int NO>
__device__ __forceinline__ void output_layer(Smem& s, int np, const float* b1) {
  const int p = threadIdx.x >> 3, q = threadIdx.x & 7;
  float part[NO];
#pragma unroll
  for (int c = 0; c < NO; c++) part[c] = 0.f;
  if (p < np) {
#pragma unroll
    for (int i = 0; i < H / 8; i++) {
      const int j = q + 8 * i;
      const float h = s.hid[p][j];
#pragma unroll
      for (int c = 0; c < NO; c++) part[c] = fmaf(h, s.w1[c][j], part[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < NO; c++)
    for (int off = 4; off; off >>= 1) part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
  if (q == 0 && p < np)
#pragma unroll
    for (int c = 0; c < NO; c++) s.out[p][c] = part[c] + b1[c];
}

// One branch forward on the embedding in s.e: fills s.out[p][0..NO).
// Ends with a barrier.
template <int NE, int NO>
__device__ __forceinline__ void branch_forward(Smem& s, int np, const Args& a, int i, int br,
                                               int img, const float* rw) {
  const int j = threadIdx.x, n_in = NE + a.d_feat;
  const float* const* W = a.W + i * 10 + br * 5;
  const float* prep = a.prep + (i * 2 + br) * prep_stride(a.B);
  float w[NE];
  load_weights<NE>(W[0], n_in, prep[j], w);
  const float cb = prep[(2 + img) * H + j];
  for (int p = 0; p < np; p++) s.hid[p][j] = softplus100(pre_activation<NE>(s, p, w, rw[p], cb));
#pragma unroll
  for (int c = 0; c < NO; c++) s.w1[c][j] = W[3][c * H + j];
  __syncthreads();
  output_layer<NO>(s, np, W[4]);
  __syncthreads();
}

// The rotation of block i on s.x from s.out = (theta, t0, t1). One thread
// per point; the caller puts a barrier after it.
__device__ __forceinline__ void rotate(Smem& s, int np, int i) {
  const int t = threadIdx.x;
  if (t >= np) return;
  const int oa = other_axis0(i), ob = other_axis1(i);
  const float th = s.out[t][0];
  const float cth = cosf(th), sth = sinf(th);
  const float u0 = s.x[t][oa] - s.out[t][1], u1 = s.x[t][ob] - s.out[t][2];
  s.x[t][oa] = cth * u0 + sth * u1;
  s.x[t][ob] = -sth * u0 + cth * u1;
}

// The three blocks on the tile in s.x. With `keep`, a SmemBwd's xs and th
// are filled for the backward.
template <bool KEEP>
__device__ __forceinline__ void blocks_forward(Smem& s, SmemBwd* k, int np, const Args& a,
                                               int img) {
  const int t = threadIdx.x;
  for (int i = 0; i < 3; i++) {
    if (KEEP && t < PT)
      for (int c = 0; c < 3; c++) k->xs[i][t][c] = s.x[t][c];
    embed<2>(s, s.x, other_axis0(i), other_axis1(i));
    __syncthreads();
    branch_forward<NE_A, 1>(s, np, a, i, 0, img, s.rw2);
    if (t < np) s.x[t][focus_axis(i)] -= s.out[t][0];
    __syncthreads();
    embed<1>(s, s.x, focus_axis(i), 0);
    __syncthreads();
    branch_forward<NE_B, 3>(s, np, a, i, 1, img, s.rw1);
    if (KEEP && t < PT)
      for (int c = 0; c < 3; c++) k->th[i][t][c] = s.out[t][c];
    rotate(s, np, i);
    __syncthreads();
  }
  if (KEEP && t < PT)
    for (int c = 0; c < 3; c++) k->xs[3][t][c] = s.x[t][c];
}

// The tile's points (zero beyond np) and row windows into shared memory.
__device__ __forceinline__ void load_tile(Smem& s, const Args& a, int img, int n0, int np) {
  const int t = threadIdx.x;
  if (t < PT * 3) {
    const int p = t / 3, c = t % 3;
    s.x[p][c] = p < np ? a.pts[((size_t)img * a.N + n0 + p) * 3 + c] : 0.f;
  }
  if (t < PT) {
    s.rw1[t] = t < np ? a.rw1[n0 + t] : 1.f;
    s.rw2[t] = t < np ? a.rw2[n0 + t] : 1.f;
  }
  __syncthreads();
}

static __global__ void __launch_bounds__(H) fwd_kernel(Args a) {
  __shared__ Smem s;
  const int img = blockIdx.x / a.cpi, t = threadIdx.x;
  for (int tile = blockIdx.x % a.cpi; tile * PT < a.N; tile += a.cpi) {
    const int n0 = tile * PT, np = min(PT, a.N - n0);
    load_tile(s, a, img, n0, np);
    blocks_forward<false>(s, nullptr, np, a, img);
    if (t < np * 3) a.out[((size_t)img * a.N + n0) * 3 + t] = s.x[t / 3][t % 3];
    __syncthreads();
  }
}

// ---------------------------------------------------------------- backward
// One branch backward. In: s.e (the branch's embedding), s.dout[p][0..NO)
// (cotangent of its output), rw. Out: s.de[p][k], the cotangent of embed
// column k chained onto its coordinate; the CTA's partial rows of dW (embed
// rows), dh sum, dw1 and db1 (stored when `first`, else added). Ends with a
// barrier.
template <int NE, int NO, int D>
__device__ __forceinline__ void branch_backward(SmemBwd& s, int np, const Args& a, int i,
                                                int br, int img, const float* rw,
                                                float* part, bool first) {
  const int j = threadIdx.x, n_in = NE + a.d_feat;
  const float* const* W = a.W + i * 10 + br * 5;
  const float* prep = a.prep + (i * 2 + br) * prep_stride(a.B);
  float w[NE], dW[NE], w1[NO], dw1[NO];
  load_weights<NE>(W[0], n_in, prep[j], w);
#pragma unroll
  for (int k = 0; k < NE; k++) { s.Ws[k][j] = w[k]; dW[k] = 0.f; }
#pragma unroll
  for (int c = 0; c < NO; c++) { w1[c] = W[3][c * H + j]; dw1[c] = 0.f; }
  const float cb = prep[(2 + img) * H + j];
  float dh_sum = 0.f;
  for (int p = 0; p < np; p++) {
    const float pre = pre_activation<NE>(s, p, w, rw[p], cb);
    const float h = softplus100(pre);
    float dh = 0.f;
#pragma unroll
    for (int c = 0; c < NO; c++) {
      const float g = s.dout[p][c];
      dh = fmaf(g, w1[c], dh);
      dw1[c] = fmaf(h, g, dw1[c]);
    }
    dh *= sigmoid_f(100.f * pre);
    dh_sum += dh;
    const float dE = rw[p] * dh;      // the window scales the embed part only
#pragma unroll
    for (int k = 0; k < NE; k++) dW[k] = fmaf(s.e[p][k], dE, dW[k]);
    s.hid[p][j] = dE;
  }
  float* rows = part + (br ? ROW_B : ROW_A) * H;
  if (first) {
#pragma unroll
    for (int k = 0; k < NE; k++) rows[k * H + j] = dW[k];
    rows[NE * H + j] = dh_sum;
#pragma unroll
    for (int c = 0; c < NO; c++) rows[(NE + 1 + c) * H + j] = dw1[c];
  } else {
#pragma unroll
    for (int k = 0; k < NE; k++) rows[k * H + j] += dW[k];
    rows[NE * H + j] += dh_sum;
#pragma unroll
    for (int c = 0; c < NO; c++) rows[(NE + 1 + c) * H + j] += dw1[c];
  }
  if (j < NO) {
    float db1 = 0.f;
    for (int p = 0; p < np; p++) db1 += s.dout[p][j];
    float* slot = part + ROWS * H + (br ? 1 + j : 0);
    *slot = first ? db1 : *slot + db1;
  }
  __syncthreads();
  // cotangent of the embed columns: de[p][k] = sum_j dE[p][j] W[k][j]
  for (int idx = j; idx < np * NE; idx += H) {
    const int p = idx / NE, k = idx % NE;
    float acc = 0.f;
#pragma unroll 8
    for (int jj = 0; jj < H; jj++) acc = fmaf(s.hid[p][jj], s.Ws[k][jj], acc);
    s.de[p][k] = acc * embed_chain<D>(s, p, k);
  }
  __syncthreads();
}

static __global__ void __launch_bounds__(H) bwd_kernel(Args a) {
  __shared__ SmemBwd s;
  const int img = blockIdx.x / a.cpi, t = threadIdx.x;
  float* part = a.part + (size_t)blockIdx.x * PCTA;
  bool first = true;
  for (int tile = blockIdx.x % a.cpi; tile * PT < a.N; tile += a.cpi) {
    const int n0 = tile * PT, np = min(PT, a.N - n0);
    load_tile(s, a, img, n0, np);
    blocks_forward<true>(s, &s, np, a, img);
    if (t < PT * 3) {
      const int p = t / 3, c = t % 3;
      s.dx[p][c] = p < np ? a.g[((size_t)img * a.N + n0 + p) * 3 + c] : 0.f;
    }
    __syncthreads();
    for (int i = 2; i >= 0; i--) {
      const int fx = focus_axis(i), oa = other_axis0(i), ob = other_axis1(i);
      // rotation backward: (o0', o1') = R(-th) (o - t)
      if (t < np) {
        const float th = s.th[i][t][0];
        const float cth = cosf(th), sth = sinf(th);
        const float on0 = s.xs[i + 1][t][oa], on1 = s.xs[i + 1][t][ob];
        const float don0 = s.dx[t][oa], don1 = s.dx[t][ob];
        const float du0 = cth * don0 - sth * don1, du1 = sth * don0 + cth * don1;
        s.dout[t][0] = don0 * on1 - don1 * on0;
        s.dout[t][1] = -du0;
        s.dout[t][2] = -du1;
        s.dx[t][oa] = du0;
        s.dx[t][ob] = du1;
      }
      embed<1>(s, s.xs[i + 1], fx, 0);
      __syncthreads();
      branch_backward<NE_B, 3, 1>(s, np, a, i, 1, img, s.rw1, part + i * PBLK, first);
      // focus' = focus - s: the cotangent of focus', and of s
      if (t < np) {
        float dfn = s.dx[t][fx];
        for (int k = 0; k < NE_B; k++) dfn += s.de[t][k];
        s.dx[t][fx] = dfn;
        s.dout[t][0] = -dfn;
      }
      embed<2>(s, s.xs[i], oa, ob);
      __syncthreads();
      branch_backward<NE_A, 1, 2>(s, np, a, i, 0, img, s.rw2, part + i * PBLK, first);
      if (t < np) {
        float d0 = s.dx[t][oa], d1 = s.dx[t][ob];
        for (int k = 0; k < NE_A; k += 2) { d0 += s.de[t][k]; d1 += s.de[t][k + 1]; }
        s.dx[t][oa] = d0;
        s.dx[t][ob] = d1;
      }
      __syncthreads();
    }
    if (t < np * 3) a.dpts[((size_t)img * a.N + n0) * 3 + t] = s.dx[t / 3][t % 3];
    first = false;
    __syncthreads();
  }
}

// per_img[img][e] = sum over the image's CTAs of part[cta][e], in CTA order.
static __global__ void reduce_ctas_kernel(const float* part, int cpi, float* per_img) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x, img = blockIdx.y;
  if (e >= PCTA) return;
  const float* p = part + (size_t)img * cpi * PCTA + e;
  float acc = 0.f;
  for (int c = 0; c < cpi; c++) acc += p[(size_t)c * PCTA];
  per_img[(size_t)img * PCTA + e] = acc;
}

struct EpilogueArgs {
  const float *per_img, *codes, *prep;
  const float* W[30];
  float* dW[30];
  float* dcodes;
  int B, d_feat;
};

// One warp per (branch, hidden unit): the images added in order, the latent
// rows of dW = sum_img code[img] (x) dcb[img], and the weight-norm backward
//   t = sum_k dW_k v_k;  dg = t / norm;  dv = dW scale - v g t / norm^3
// for unit j's row of v; lane 0 writes dg, db0, dw1; unit 0's warp db1.
static __global__ void epilogue_kernel(EpilogueArgs a) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (warp >= 6 * H) return;
  const int bi = warp / H, j = warp % H, i = bi >> 1, br = bi & 1;
  const int ne = br ? NE_B : NE_A, n_in = ne + a.d_feat, no = br ? 3 : 1;
  const float* const* W = a.W + i * 10 + br * 5;
  float* const* dW = a.dW + i * 10 + br * 5;
  const float* v = W[0] + (size_t)j * n_in;
  const float* prep = a.prep + bi * prep_stride(a.B);
  const float scale = prep[j], norm = prep[H + j];
  const float* rows = a.per_img + (size_t)i * PBLK + (br ? ROW_B : ROW_A) * H + j;
  const float* codes = a.codes + (size_t)i * a.B * a.d_feat;
  auto dw_of = [&](int k) {
    float acc = 0.f;
    if (k < ne) {
      for (int img = 0; img < a.B; img++) acc += rows[(size_t)img * PCTA + k * H];
    } else {
      for (int img = 0; img < a.B; img++)
        acc = fmaf(codes[(size_t)img * a.d_feat + k - ne], rows[(size_t)img * PCTA + ne * H], acc);
    }
    return acc;
  };
  // each lane parks its dW_k in dv's row and corrects them in place once t is known
  float* dv = dW[0] + (size_t)j * n_in;
  float t = 0.f;
  for (int k = lane; k < n_in; k += 32) {
    dv[k] = dw_of(k);
    t = fmaf(dv[k], v[k], t);
  }
  for (int off = 16; off; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  const float g = W[1][j];
  const float back = __fdiv_rn(g * t, norm * norm * norm);
  for (int k = lane; k < n_in; k += 32) dv[k] = dv[k] * scale - v[k] * back;
  if (lane == 0) {
    dW[1][j] = __fdiv_rn(t, norm);
    float db0 = 0.f;
    for (int img = 0; img < a.B; img++) db0 += rows[(size_t)img * PCTA + ne * H];
    dW[2][j] = db0;
  }
  if (lane < no) {
    float acc = 0.f;
    for (int img = 0; img < a.B; img++) acc += rows[(size_t)img * PCTA + (ne + 1 + lane) * H];
    dW[3][lane * H + j] = acc;
    if (j == 0) {
      const float* slot = a.per_img + (size_t)i * PBLK + ROWS * H + (br ? 1 + lane : 0);
      float b1 = 0.f;
      for (int img = 0; img < a.B; img++) b1 += slot[(size_t)img * PCTA];
      dW[4][lane] = b1;
    }
  }
}

// dcodes[i][img][d] = sum_j dcb_a[img][j] W_a[lat d][j] + dcb_b[img][j] W_b[lat d][j]
static __global__ void dcode_kernel(EpilogueArgs a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 3 * a.B * a.d_feat) return;
  const int d = idx % a.d_feat, img = (idx / a.d_feat) % a.B, i = idx / (a.d_feat * a.B);
  float acc = 0.f;
  for (int br = 0; br < 2; br++) {
    const int ne = br ? NE_B : NE_A, n_in = ne + a.d_feat;
    const float* v = a.W[i * 10 + br * 5];
    const float* scale = a.prep + (i * 2 + br) * prep_stride(a.B);
    const float* dcb = a.per_img + (size_t)img * PCTA + (size_t)i * PBLK
        + (br ? ROW_DH_B : ROW_DH_A) * H;
    for (int j = 0; j < H; j++)
      acc = fmaf(dcb[j] * scale[j], v[(size_t)j * n_in + ne + d], acc);
  }
  a.dcodes[idx] = acc;
}

static int ctas_per_image(int B, int N) {
  const int tiles = (N + PT - 1) / PT;
  return max(1, min(tiles, MAX_CTAS / B));
}

}  // namespace inn
}  // namespace niw

using namespace niw::inn;

extern "C" long long niw_inn_prep_floats(int B) { return 6 * prep_stride(B); }

// The CTAs' partial buffers, and the per-image sums where an image has more
// than one CTA.
extern "C" long long niw_inn_bwd_workspace_floats(int B, int N) {
  const int cpi = ctas_per_image(B, N);
  return (long long)B * cpi * PCTA + (cpi > 1 ? (long long)B * PCTA : 0);
}

// pts [B,N,3]; rw1, rw2 [N]; codes [3,B,d_feat]; W: the 30 weight tensors;
// prep: niw_inn_prep_floats(B) floats (written; the backward reads them);
// out [B,N,3].
extern "C" int niw_inn_fwd(const float* pts, const float* rw1, const float* rw2,
                           const float* codes, int B, int N, int d_feat,
                           const float* const* W, float* prep, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Args a;
  a.pts = pts; a.rw1 = rw1; a.rw2 = rw2; a.codes = codes; a.g = nullptr; a.prep = prep;
  for (int k = 0; k < 30; k++) a.W[k] = W[k];
  a.B = B; a.N = N; a.d_feat = d_feat; a.cpi = ctas_per_image(B, N);
  a.out = out; a.dpts = nullptr; a.part = nullptr;
  NIW_LAUNCH(prep_kernel<<<6 * H / 8, 256, 0, s>>>(a, prep));
  NIW_LAUNCH(fwd_kernel<<<(unsigned)((long long)B * a.cpi), H, 0, s>>>(a));
  return 0;
}

// g [B,N,3]: the cotangent of out; prep: as niw_inn_fwd wrote it for the same
// operands; dpts [B,N,3]; dcodes [3,B,d_feat]; dW: 30 gradient buffers shaped
// as W; ws: niw_inn_bwd_workspace_floats(B, N) floats.
extern "C" int niw_inn_bwd(const float* pts, const float* rw1, const float* rw2,
                           const float* codes, const float* g, int B, int N, int d_feat,
                           const float* const* W, const float* prep, float* dpts,
                           float* dcodes, float* const* dW, float* ws, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Args a;
  a.pts = pts; a.rw1 = rw1; a.rw2 = rw2; a.codes = codes; a.g = g; a.prep = prep;
  for (int k = 0; k < 30; k++) a.W[k] = W[k];
  a.B = B; a.N = N; a.d_feat = d_feat; a.cpi = ctas_per_image(B, N);
  a.out = nullptr; a.dpts = dpts; a.part = ws;
  NIW_LAUNCH(bwd_kernel<<<(unsigned)((long long)B * a.cpi), H, 0, s>>>(a));
  EpilogueArgs e;
  e.per_img = ws; e.codes = codes; e.prep = prep; e.dcodes = dcodes;
  e.B = B; e.d_feat = d_feat;
  for (int k = 0; k < 30; k++) { e.W[k] = W[k]; e.dW[k] = dW[k]; }
  if (a.cpi > 1) {
    float* per_img = ws + (size_t)B * a.cpi * PCTA;
    dim3 grid((PCTA + 255) / 256, B);
    NIW_LAUNCH(reduce_ctas_kernel<<<grid, 256, 0, s>>>(ws, a.cpi, per_img));
    e.per_img = per_img;
  }
  NIW_LAUNCH(epilogue_kernel<<<6 * H / 8, 256, 0, s>>>(e));
  const int n_codes = 3 * B * d_feat;
  NIW_LAUNCH(dcode_kernel<<<(n_codes + 127) / 128, 128, 0, s>>>(e));
  return 0;
}
