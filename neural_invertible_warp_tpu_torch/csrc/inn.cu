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
// 128), three times that backward, and 30 weight tensors of 0.5 MB together:
// a few microseconds on this card. What sets the time is the serial chain per
// point (embedding, a 26-long FMA chain per unit, a precise softplus, an
// output reduction over 128 units, six times per direction) and how many
// warps run it side by side, so the points run in parallel across warps:
// - Preparation (one warp per hidden unit, branch and pair of images): the
//   row norm, the scale g / |v|, per image the bias cb = scale (code . v[lat])
//   + b, and the scaled embed rows W_eff[k][j] = v[j][k] scale[j] in
//   unit-contiguous rows. The [P, d_feat] latent operands and the per-point
//   latent matmul of the TPU kernel do not exist here; dcode is a per-image
//   sum. It stays a launch of its own: folded into the main kernel, every
//   CTA would read all six first layers (0.47 MB at d_feat 128), ~250 MB
//   from L2 per forward.
// - Forward: a warp per point, 4 warps per CTA; lane l owns units 4 l ..
//   4 l + 3 and reads their W_eff as 16-byte loads (the same lines for every
//   warp: L1 hits). The warp writes the point's embedding into its own shared
//   row between two __syncwarp (a lane per column), and each output layer is
//   a fixed-order butterfly of __shfl_xor_sync over the lanes' 4-unit partial
//   sums, which leaves the result in every lane: the coupling updates and the
//   rotation need no barrier. A forward CTA runs no CTA-wide barrier (the
//   first design ran 26 per 16-point tile). It keeps, per point, each block's
//   output and (theta, t0, t1) (18 floats) after the preparation rows.
// - Backward: a warp owns 2 points of a 16-point tile (8 warps) and reads
//   their kept state instead of recomputing the blocks. Per branch the warp
//   recomputes the pre-activations, forms dh = (dL/dout . w1) softplus' and
//   the cotangent of its inputs (per lane the 4 units' sum of dE W_eff over
//   each column times the column's chain factor, then one butterfly per
//   coordinate), and writes the embedding, h, dh and dout of its points into
//   a double-buffered tile buffer. After one barrier per branch (6 per tile)
//   thread t adds, for unit t % 128 and every other row, the tile's terms of
//   dW (embed rows), the dh sum (db0, and per image dcb), dw1 and db1 in point
//   order into the CTA's partial buffer. Three CTAs per SM (80 registers).
// - The output-bias gradients db1 are sums over every point of an output's
//   cotangent whose terms largely cancel; an fp32 chain of partial sums lost
//   more of them than the plain warp's reduction does, so they are added in
//   double from the tile up and rounded to fp32 once.
// - Weight gradients without atomics: a CTA walks the tiles of one image
//   (about three CTAs per SM over all images, one tile each at the flagship
//   shape) and owns one partial buffer. One epilogue launch: CTAs of 8 units
//   of a branch add each row of their units over the backward CTAs (a lane
//   every 32nd CTA in order, two 16-byte loads per CTA, then the butterfly)
//   and per image the dh row over the image's CTAs, form the latent rows of
//   dW from the per-image sums (the images in order) and run the weight-norm
//   backward (a warp per unit); CTAs of their own per (block, image) form the
//   dcodes. Two launches per direction; two runs give the same bits.
// - fp32 FMAs, precise sinf / cosf / expf / log1pf, no fast-math, no TF32.
#include "nerf_field.cuh"

namespace niw {
namespace inn {

constexpr int H = 128;            // hidden width
constexpr int LB = 6;             // PE bands
constexpr int NE_A = 2 + 4 * LB;  // embed columns of branch a (26)
constexpr int NE_B = 1 + 2 * LB;  // ... of branch b (13)
constexpr int UPL = H / 32;       // units per lane
constexpr int FWD_WARPS = 4;      // forward CTA: 4 warps
constexpr int FWD_NP = 1;         // points per forward warp
constexpr int NPB = 2;            // points per backward warp
constexpr int BWD_WARPS = 8;      // backward CTA: 8 warps, a tile of 16 points
constexpr int PT = BWD_WARPS * NPB;
constexpr int BWD_NT = 32 * BWD_WARPS;
constexpr int BWD_MINB = 3;       // backward CTAs resident per SM
constexpr int N_SM = 132;         // the H100's SMs
constexpr int STATE = 18;         // floats kept per point: x1, x2, x3, o0, o1, o2
static_assert(UPL == 4, "a lane's units are one 16-byte row segment");

// Partial weight-gradient buffer of one backward CTA, per block: rows of H floats
//   0..25 dW_a embed rows | 26 dh_a sum (db0_a, and the image's dcb_a) |
//   27 dw1_a | 28..40 dW_b embed rows | 41 dh_b sum | 42..44 dw1_b
// then 8 floats holding 4 doubles: db1_a, db1_b[3].
constexpr int ROW_A = 0, ROW_DH_A = NE_A;
constexpr int ROW_B = NE_A + 2, ROW_DH_B = ROW_B + NE_B;
constexpr int ROWS = ROW_DH_B + 4;
constexpr int PBLK = ROWS * H + 8;
constexpr int PCTA = 3 * PBLK;

// prep: per branch bi = 2 i + br, rows of H floats: scale, norm, cb[B], then
// NE rows of W_eff[k][j] (26 rows reserved for either branch); after the six
// branches the forward's kept state, STATE floats per point.
__host__ __device__ inline long long prep_w(int B) { return (long long)(2 + B) * H; }
__host__ __device__ inline long long prep_stride(int B) { return prep_w(B) + NE_A * H; }

__device__ __forceinline__ float softplus100(float x) {
  return __fdiv_rn(softplus_f(100.f * x), 100.f);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Args {
  const float *pts, *rw1, *rw2, *codes, *g, *prep;
  const float* W[30];
  int B, N, d_feat, cpi;   // cpi: backward CTAs per image
  float *out, *dpts, *part, *state;
};

// ------------------------------------------------------------- preparation
constexpr int PREP_IMGS = 2;      // images per preparation warp

// One warp per (branch, hidden unit, group of PREP_IMGS images): norm, scale,
// the group's biases; the first group's warp writes scale, norm and W_eff.
static __global__ void prep_kernel(Args a, float* prep) {
  const int groups = (a.B + PREP_IMGS - 1) / PREP_IMGS, lane = threadIdx.x & 31;
  const long long gw = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (gw >= 6LL * H * groups) return;
  const int warp = (int)(gw / groups), ig = (int)(gw % groups);
  const int bi = warp / H, j = warp % H, i = bi >> 1, br = bi & 1;
  const int ne = br ? NE_B : NE_A, n_in = ne + a.d_feat;
  const float* v = a.W[i * 10 + br * 5] + (size_t)j * n_in;
  float n2 = 0.f;
  for (int k = lane; k < n_in; k += 32) n2 = fmaf(v[k], v[k], n2);
  for (int off = 16; off; off >>= 1) n2 += __shfl_xor_sync(0xffffffffu, n2, off);
  const float norm = fmaxf(sqrtf(n2), 1e-12f);
  const float scale = __fdiv_rn(a.W[i * 10 + br * 5 + 1][j], norm);
  float* p = prep + bi * prep_stride(a.B);
  if (ig == 0) {
    if (lane == 0) { p[j] = scale; p[H + j] = norm; }
    if (lane < ne) p[prep_w(a.B) + lane * H + j] = v[lane] * scale;
  }
  const float b0 = a.W[i * 10 + br * 5 + 2][j];
  const int img_end = min(a.B, (ig + 1) * PREP_IMGS);
#pragma unroll
  for (int img = ig * PREP_IMGS; img < img_end; img++) {
    const float* code = a.codes + ((size_t)i * a.B + img) * a.d_feat;
    float dot = 0.f;
    for (int d = lane; d < a.d_feat; d += 32) dot = fmaf(code[d], v[ne + d], dot);
    for (int off = 16; off; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) p[(2 + img) * H + j] = fmaf(dot, scale, b0);
  }
}

// ------------------------------------------------------- one warp's points
// A branch's operands for one image: W_eff [NE][H], cb [H], w1 [NO][H], b1 [NO].
struct Branch {
  const float *Wt, *cb, *w1, *b1;
};

__device__ __forceinline__ Branch branch_of(const Args& a, int i, int br, int img) {
  const float* p = a.prep + (2 * i + br) * prep_stride(a.B);
  return {p + prep_w(a.B), p + (2 + img) * H, a.W[i * 10 + br * 5 + 3], a.W[i * 10 + br * 5 + 4]};
}

// Column c of emb_D(u0, u1): c < D the coordinate, then per band l: sin over
// the coordinates, cos over the coordinates.
template <int D>
__device__ __forceinline__ float embed_col(int c, float u0, float u1) {
  if (c < D) return c == 0 ? u0 : u1;
  const int cc = c - D, l = cc / (2 * D), r = cc % (2 * D), d = r % D;
  const float ang = __fmul_rn(d == 0 ? u0 : u1, pe_freq(l));
  return (r / D) ? cosf(ang) : sinf(ang);
}

// The chain factor of embed column c onto its coordinate (c % D): 1 for the
// raw column, f_l cos(ang) for a sin column, -f_l sin(ang) for a cos column
// (both read from the partner column of the same band of the row e).
template <int D>
__device__ __forceinline__ float chain_col(const float* e, int c) {
  if (c < D) return 1.f;
  const int cc = c - D, l = cc / (2 * D), r = cc % (2 * D), d = r % D;
  const int band = D + l * 2 * D;
  return (r / D) ? -pe_freq(l) * e[band + d] : pe_freq(l) * e[band + D + d];
}

// The warp's NP points' embeddings into their rows e[p][0..NE), a lane per entry.
template <int D, int NE, int NP>
__device__ __forceinline__ void write_embed(float (*e)[NE_A], const float (&u)[NP][2],
                                            int lane) {
  for (int idx = lane; idx < NP * NE; idx += 32) {
    const int p = idx / NE, c = idx % NE;
    float u0 = u[0][0], u1 = u[0][1];
#pragma unroll
    for (int q = 1; q < NP; q++)
      if (p == q) { u0 = u[q][0]; u1 = u[q][1]; }
    e[p][c] = embed_col<D>(c, u0, u1);
  }
}

// pre[p][u] = rw[p] (sum_k e[p][k] W_eff[k][4 lane + u]) + cb[4 lane + u]:
// the columns in order, as fmaf from 0.
template <int NE, int NP>
__device__ __forceinline__ void pre_acts(float (*e)[NE_A], const Branch& br,
                                         const float (&rw)[NP], int lane,
                                         float (&pre)[NP][UPL]) {
  float acc[NP][UPL];
#pragma unroll
  for (int p = 0; p < NP; p++)
#pragma unroll
    for (int u = 0; u < UPL; u++) acc[p][u] = 0.f;
#pragma unroll
  for (int k = 0; k < NE; k++) {
    const float4 w = ldg4(br.Wt + k * H + 4 * lane);
#pragma unroll
    for (int p = 0; p < NP; p++) {
      const float ev = e[p][k];
      acc[p][0] = fmaf(ev, w.x, acc[p][0]);
      acc[p][1] = fmaf(ev, w.y, acc[p][1]);
      acc[p][2] = fmaf(ev, w.z, acc[p][2]);
      acc[p][3] = fmaf(ev, w.w, acc[p][3]);
    }
  }
  const float4 cb = ldg4(br.cb + 4 * lane);
#pragma unroll
  for (int p = 0; p < NP; p++) {
    pre[p][0] = fmaf(rw[p], acc[p][0], cb.x);
    pre[p][1] = fmaf(rw[p], acc[p][1], cb.y);
    pre[p][2] = fmaf(rw[p], acc[p][2], cb.z);
    pre[p][3] = fmaf(rw[p], acc[p][3], cb.w);
  }
}

// out[p][c] = sum_j h[p][j] w1[c][j] + b1[c]: per lane over its 4 units in
// order, then the butterfly over the lanes; the same bits in every lane.
template <int NO, int NP>
__device__ __forceinline__ void out_layer(const float (&h)[NP][UPL], const Branch& br, int lane,
                                          float (&out)[NP][NO]) {
#pragma unroll
  for (int c = 0; c < NO; c++) {
    float w[UPL];
#pragma unroll
    for (int u = 0; u < UPL; u++) w[u] = __ldg(br.w1 + c * H + 4 * lane + u);
    const float b1 = __ldg(br.b1 + c);
#pragma unroll
    for (int p = 0; p < NP; p++) {
      float part = 0.f;
#pragma unroll
      for (int u = 0; u < UPL; u++) part = fmaf(h[p][u], w[u], part);
      out[p][c] = warp_sum(part) + b1;
    }
  }
}

// One branch forward on the warp's points with coordinates u: out[p][0..NO).
template <int D, int NE, int NO, int NP>
__device__ __forceinline__ void branch_forward(float (*e)[NE_A], const Branch& br,
                                               const float (&u)[NP][2], const float (&rw)[NP],
                                               int lane, float (&out)[NP][NO]) {
  __syncwarp();   // the warp is done reading the previous embedding
  write_embed<D, NE, NP>(e, u, lane);
  __syncwarp();
  float pre[NP][UPL], h[NP][UPL];
  pre_acts<NE, NP>(e, br, rw, lane, pre);
#pragma unroll
  for (int p = 0; p < NP; p++)
#pragma unroll
    for (int v = 0; v < UPL; v++) h[p][v] = softplus100(pre[p][v]);
  out_layer<NO, NP>(h, br, lane, out);
}

template <int I>
struct Axes {
  static constexpr int FX = 2 - I, OA = I == 2 ? 1 : 0, OB = I == 0 ? 1 : 2;
};

// Block I on the warp's points x (in place); o: its (theta, t0, t1).
template <int I, int NP>
__device__ __forceinline__ void block_forward(const Args& a, int img, float (*e)[NE_A],
                                              const float (&rw1)[NP], const float (&rw2)[NP],
                                              int lane, float (&x)[NP][3], float (&o)[NP][3]) {
  constexpr int FX = Axes<I>::FX, OA = Axes<I>::OA, OB = Axes<I>::OB;
  float u[NP][2], s[NP][1];
#pragma unroll
  for (int p = 0; p < NP; p++) { u[p][0] = x[p][OA]; u[p][1] = x[p][OB]; }
  branch_forward<2, NE_A, 1, NP>(e, branch_of(a, I, 0, img), u, rw2, lane, s);
#pragma unroll
  for (int p = 0; p < NP; p++) {
    x[p][FX] -= s[p][0];
    u[p][0] = x[p][FX];
    u[p][1] = 0.f;
  }
  branch_forward<1, NE_B, 3, NP>(e, branch_of(a, I, 1, img), u, rw1, lane, o);
#pragma unroll
  for (int p = 0; p < NP; p++) {
    const float th = o[p][0];
    const float cth = cosf(th), sth = sinf(th);
    const float u0 = x[p][OA] - o[p][1], u1 = x[p][OB] - o[p][2];
    x[p][OA] = cth * u0 + sth * u1;
    x[p][OB] = -sth * u0 + cth * u1;
  }
}

// Three floats per point n0 + p of image img from src (row stride `stride`,
// offset `off`); zeros past N.
template <int NP>
__device__ __forceinline__ void load3(const Args& a, const float* src, int stride, int off,
                                      int img, int n0, float (&v)[NP][3]) {
#pragma unroll
  for (int p = 0; p < NP; p++)
#pragma unroll
    for (int c = 0; c < 3; c++)
      v[p][c] = n0 + p < a.N ? src[((size_t)img * a.N + n0 + p) * stride + off + c] : 0.f;
}

// dst[img][n0 + p][off + c] = v[p][c] for the points inside N, a lane per entry.
template <int NP>
__device__ __forceinline__ void store3(float* dst, int stride, int off, const Args& a, int img,
                                       int n0, const float (&v)[NP][3], int lane) {
#pragma unroll
  for (int p = 0; p < NP; p++)
#pragma unroll
    for (int c = 0; c < 3; c++)
      if (lane == p * 3 + c && n0 + p < a.N)
        dst[((size_t)img * a.N + n0 + p) * stride + off + c] = v[p][c];
}

template <int NP>
__device__ __forceinline__ void load_windows(const Args& a, int n0, float (&rw1)[NP],
                                             float (&rw2)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; p++) {
    const bool in = n0 + p < a.N;
    rw1[p] = in ? a.rw1[n0 + p] : 1.f;
    rw2[p] = in ? a.rw2[n0 + p] : 1.f;
  }
}

// Grid: B x ceil(N / (FWD_WARPS NP)) CTAs, NP points per warp. Besides out,
// it keeps each block's output and (theta, t0, t1) for the backward.
static __global__ void __launch_bounds__(32 * FWD_WARPS) fwd_kernel(Args a) {
  constexpr int NP = FWD_NP;
  __shared__ float es[FWD_WARPS][NP][NE_A];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (a.N + FWD_WARPS * NP - 1) / (FWD_WARPS * NP);
  const int img = blockIdx.x / tiles, n0 = (blockIdx.x % tiles * FWD_WARPS + warp) * NP;
  float x[NP][3], rw1[NP], rw2[NP], o[NP][3];
  load3<NP>(a, a.pts, 3, 0, img, n0, x);
  load_windows<NP>(a, n0, rw1, rw2);
  block_forward<0, NP>(a, img, es[warp], rw1, rw2, lane, x, o);
  store3<NP>(a.state, STATE, 0, a, img, n0, x, lane);
  store3<NP>(a.state, STATE, 9, a, img, n0, o, lane);
  block_forward<1, NP>(a, img, es[warp], rw1, rw2, lane, x, o);
  store3<NP>(a.state, STATE, 3, a, img, n0, x, lane);
  store3<NP>(a.state, STATE, 12, a, img, n0, o, lane);
  block_forward<2, NP>(a, img, es[warp], rw1, rw2, lane, x, o);
  store3<NP>(a.state, STATE, 6, a, img, n0, x, lane);
  store3<NP>(a.state, STATE, 15, a, img, n0, o, lane);
  store3<NP>(a.out, 3, 0, a, img, n0, x, lane);
}

// ---------------------------------------------------------------- backward
// One branch's operands of the weight-gradient sums, per point of the tile.
struct Tile {
  float e[PT][NE_A];     // embedding
  float h[PT][H];        // hidden activations
  float dh[PT][H];       // dL/dh softplus'(pre), before the window
  float dout[PT][4];     // cotangent of the branch output
  float rw[PT];          // the branch's window
};

// One branch backward on the warp's points (rows warp NPB.. of the tile
// buffer): recompute the pre-activations on the embedding of u, write e, h,
// dh, dout and rw, and return the cotangent of the D coordinates of u (the
// same bits in every lane).
template <int D, int NE, int NO>
__device__ __forceinline__ void branch_backward(Tile& tb, int warp, int lane, const Branch& br,
                                                const float (&u)[NPB][2],
                                                const float (&rw)[NPB],
                                                const float (&dout)[NPB][NO],
                                                float (&dcoord)[NPB][D]) {
  float (*e)[NE_A] = tb.e + warp * NPB;
  write_embed<D, NE, NPB>(e, u, lane);
#pragma unroll
  for (int p = 0; p < NPB; p++) {
    if (lane == p) tb.rw[warp * NPB + p] = rw[p];
#pragma unroll
    for (int c = 0; c < NO; c++)
      if (lane == NPB + p * NO + c) tb.dout[warp * NPB + p][c] = dout[p][c];
  }
  __syncwarp();
  float pre[NPB][UPL];
  pre_acts<NE, NPB>(e, br, rw, lane, pre);
  float w1[NO][UPL];
#pragma unroll
  for (int c = 0; c < NO; c++)
#pragma unroll
    for (int v = 0; v < UPL; v++) w1[c][v] = __ldg(br.w1 + c * H + 4 * lane + v);
  float dE[NPB][UPL];
#pragma unroll
  for (int p = 0; p < NPB; p++) {
    float h[UPL], dh[UPL];
#pragma unroll
    for (int v = 0; v < UPL; v++) {
      h[v] = softplus100(pre[p][v]);
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < NO; c++) d = fmaf(dout[p][c], w1[c][v], d);
      dh[v] = d * sigmoid_f(100.f * pre[p][v]);
      dE[p][v] = rw[p] * dh[v];       // the window scales the embed part only
    }
    *reinterpret_cast<float4*>(&tb.h[warp * NPB + p][4 * lane]) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(&tb.dh[warp * NPB + p][4 * lane]) =
        make_float4(dh[0], dh[1], dh[2], dh[3]);
  }
  // cotangent of the inputs: per lane sum_k chain_k (sum_u dE_u W_eff[k][u]),
  // per coordinate, then over the lanes
  float part[NPB][D];
#pragma unroll
  for (int p = 0; p < NPB; p++)
#pragma unroll
    for (int d = 0; d < D; d++) part[p][d] = 0.f;
#pragma unroll
  for (int k = 0; k < NE; k++) {
    const float4 w = ldg4(br.Wt + k * H + 4 * lane);
#pragma unroll
    for (int p = 0; p < NPB; p++) {
      float de = 0.f;
      de = fmaf(dE[p][0], w.x, de);
      de = fmaf(dE[p][1], w.y, de);
      de = fmaf(dE[p][2], w.z, de);
      de = fmaf(dE[p][3], w.w, de);
      part[p][k % D] = fmaf(de, chain_col<D>(e[p], k), part[p][k % D]);
    }
  }
#pragma unroll
  for (int p = 0; p < NPB; p++)
#pragma unroll
    for (int d = 0; d < D; d++) dcoord[p][d] = warp_sum(part[p][d]);
}

// The db1 slots of a block's partial buffer (8-byte aligned: PBLK and ROWS * H
// are even and the workspace is 16-byte aligned).
__device__ __forceinline__ double* db1_slots(float* blk) {
  return reinterpret_cast<double*>(blk + ROWS * H);
}

// The tile's terms of one branch's partial rows (rows: the branch's first row
// in the CTA's buffer; db1: its bias slots), added in point order: thread t
// owns unit t % H and the rows t / H, t / H + BWD_NT / H, ...
template <int NE, int NO>
__device__ __forceinline__ void weight_grads(const Tile& tb, int np, float* rows, double* db1,
                                             bool first) {
  constexpr int NQ = BWD_NT / H, NR = NE + 1 + NO, RPT = (NR + NQ - 1) / NQ;
  const int j = threadIdx.x % H, q = threadIdx.x / H;
  float acc[RPT];
#pragma unroll
  for (int m = 0; m < RPT; m++) acc[m] = 0.f;
  for (int p = 0; p < np; p++) {
    const float dh = tb.dh[p][j], dE = tb.rw[p] * dh, h = tb.h[p][j];
#pragma unroll
    for (int m = 0; m < RPT; m++) {
      const int r = q + NQ * m;
      if (r < NE) acc[m] = fmaf(tb.e[p][r], dE, acc[m]);
      else if (r == NE) acc[m] += dh;
      else if (r < NR) acc[m] = fmaf(h, tb.dout[p][r - NE - 1], acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < RPT; m++) {
    const int r = q + NQ * m;
    if (r < NR) {
      float* dst = rows + r * H + j;
      *dst = first ? acc[m] : *dst + acc[m];
    }
  }
  if (threadIdx.x < NO) {
    double s = 0.0;
    for (int p = 0; p < np; p++) s += tb.dout[p][threadIdx.x];
    db1[threadIdx.x] = first ? s : db1[threadIdx.x] + s;
  }
}

// Block I backward for the warp's points nw, nw + 1, from the forward's kept
// state; dx: the cotangent of the block's output in, of its input out. Runs
// two CTA-wide barriers (one per branch); nb counts the branches done, whose
// parity picks the tile buffer.
template <int I>
__device__ __forceinline__ void block_backward(const Args& a, int img, int nw, Tile* tiles,
                                               int& nb, int warp, int lane, int np, float* part,
                                               bool first, const float (&rw1)[NPB],
                                               const float (&rw2)[NPB], float (&dx)[NPB][3]) {
  constexpr int FX = Axes<I>::FX, OA = Axes<I>::OA, OB = Axes<I>::OB;
  float* blk = part + I * PBLK;
  float xout[NPB][3], o[NPB][3];
  load3<NPB>(a, a.state, STATE, 3 * I, img, nw, xout);
  load3<NPB>(a, a.state, STATE, 9 + 3 * I, img, nw, o);
  // rotation backward: (o0', o1') = R(-th) (o - t)
  float dout_b[NPB][3], u[NPB][2];
#pragma unroll
  for (int p = 0; p < NPB; p++) {
    const float th = o[p][0];
    const float cth = cosf(th), sth = sinf(th);
    const float on0 = xout[p][OA], on1 = xout[p][OB];
    const float don0 = dx[p][OA], don1 = dx[p][OB];
    const float du0 = cth * don0 - sth * don1, du1 = sth * don0 + cth * don1;
    dout_b[p][0] = don0 * on1 - don1 * on0;
    dout_b[p][1] = -du0;
    dout_b[p][2] = -du1;
    dx[p][OA] = du0;
    dx[p][OB] = du1;
    u[p][0] = xout[p][FX];       // focus' (the rotation leaves it)
    u[p][1] = 0.f;
  }
  float dc_b[NPB][1], dout_a[NPB][1];
  Tile& tb = tiles[nb & 1];
  branch_backward<1, NE_B, 3>(tb, warp, lane, branch_of(a, I, 1, img), u, rw1, dout_b, dc_b);
  // focus' = focus - s: the cotangent of focus', and of s
  float xin[NPB][3];
  if (I == 0)
    load3<NPB>(a, a.pts, 3, 0, img, nw, xin);
  else
    load3<NPB>(a, a.state, STATE, 3 * (I - 1), img, nw, xin);
#pragma unroll
  for (int p = 0; p < NPB; p++) {
    dx[p][FX] += dc_b[p][0];
    dout_a[p][0] = -dx[p][FX];
    u[p][0] = xin[p][OA];
    u[p][1] = xin[p][OB];
  }
  __syncthreads();
  weight_grads<NE_B, 3>(tb, np, blk + ROW_B * H, db1_slots(blk) + 1, first);
  nb++;
  float dc_a[NPB][2];
  Tile& ta = tiles[nb & 1];
  branch_backward<2, NE_A, 1>(ta, warp, lane, branch_of(a, I, 0, img), u, rw2, dout_a, dc_a);
#pragma unroll
  for (int p = 0; p < NPB; p++) {
    dx[p][OA] += dc_a[p][0];
    dx[p][OB] += dc_a[p][1];
  }
  __syncthreads();
  weight_grads<NE_A, 1>(ta, np, blk + ROW_A * H, db1_slots(blk), first);
  nb++;
}

// Grid: B x cpi CTAs; CTA c of an image walks its tiles c, c + cpi, ...
static __global__ void __launch_bounds__(BWD_NT, BWD_MINB) bwd_kernel(Args a) {
  __shared__ __align__(16) Tile tiles[2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int img = blockIdx.x / a.cpi;
  float* part = a.part + (size_t)blockIdx.x * PCTA;
  int nb = 0;
  bool first = true;
  for (int tile = blockIdx.x % a.cpi; tile * PT < a.N; tile += a.cpi) {
    const int n0 = tile * PT, np = min(PT, a.N - n0), nw = n0 + warp * NPB;
    float rw1[NPB], rw2[NPB], dx[NPB][3];
    load_windows<NPB>(a, nw, rw1, rw2);
    load3<NPB>(a, a.g, 3, 0, img, nw, dx);
    block_backward<2>(a, img, nw, tiles, nb, warp, lane, np, part, first, rw1, rw2, dx);
    block_backward<1>(a, img, nw, tiles, nb, warp, lane, np, part, first, rw1, rw2, dx);
    block_backward<0>(a, img, nw, tiles, nb, warp, lane, np, part, first, rw1, rw2, dx);
    store3<NPB>(a.dpts, 3, 0, a, img, nw, dx, lane);
    first = false;
  }
}

// ---------------------------------------------------------------- epilogue
struct EpilogueArgs {
  const float *part, *codes, *prep;
  const float* W[30];
  float* dW[30];
  float* dcodes;
  int B, d_feat, cpi;
};

constexpr int EPI_NT = 512, EPI_WARPS = EPI_NT / 32;
constexpr int EPI_UNITS = 8;                     // units per weight-norm CTA
constexpr int EPI_WN_CTAS = 6 * H / EPI_UNITS;   // weight-norm CTAs
constexpr int EPI_ROWS = NE_A + 2;               // a branch's rows at most
constexpr int EPI_IMGS = 1024;                   // images per pass of the latent rows

// The 8 consecutive floats at offset e (32-byte aligned) of the partial
// buffers of the backward CTAs [t0, t1), each added in a fixed order: lane l
// adds CTAs t0 + l, t0 + l + 32, ... in order, then the butterfly. Every lane
// calls it and gets the same bits; a load fills a whole 32-byte sector.
__device__ __forceinline__ void cta_sum8(const float* part, long long e, int t0, int t1,
                                         int lane, float (&out)[8]) {
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int t = t0 + lane; t < t1; t += 32) {
    const float4 x = ldg4(part + (long long)t * PCTA + e);
    const float4 y = ldg4(part + (long long)t * PCTA + e + 4);
    s[0] += x.x; s[1] += x.y; s[2] += x.z; s[3] += x.w;
    s[4] += y.x; s[5] += y.y; s[6] += y.z; s[7] += y.w;
  }
#pragma unroll
  for (int u = 0; u < 8; u++) out[u] = warp_sum(s[u]);
}

// The 4 db1 doubles at offset e of the partial buffers of the backward CTAs
// [t0, t1), added in double in cta_sum8's order and rounded to fp32 once.
__device__ __forceinline__ void cta_sum_db1(const float* part, long long e, int t0, int t1,
                                            int lane, float (&out)[8]) {
  double s[4] = {0.0, 0.0, 0.0, 0.0};
  for (int t = t0 + lane; t < t1; t += 32) {
    const double* x = reinterpret_cast<const double*>(part + (long long)t * PCTA + e);
#pragma unroll
    for (int u = 0; u < 4; u++) s[u] += x[u];
  }
#pragma unroll
  for (int u = 0; u < 4; u++) {
#pragma unroll
    for (int off = 16; off; off >>= 1) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    out[u] = (float)s[u];
    out[4 + u] = 0.f;
  }
}

// CTAs [0, EPI_WN_CTAS): one per (branch, 8 hidden units j0 .. j0 + 7). Its
// warps add the rows of those units over all backward CTAs (embed rows of dW,
// the dh row, dw1; the CTA of units 0-7 also the db1 slots) and per image the
// dh row over the image's CTAs (dcb[img]); then warp u, for unit j0 + u, forms
// the latent rows of dW = sum_img code[img] dcb[img] (the images in order)
// and runs the weight-norm backward
//   t = sum_k dW_k v_k;  dg = t / norm;  dv = dW scale - v g t / norm^3
// for the unit's row of v; db0 = sum_img dcb[img]. CTAs after: one per (block
// i, image): dcodes[i][img][d] = sum_j dcb_a[j] scale_a[j] v_a[j][lat d] plus
// the same sum for branch b, with dcb added as above.
static __global__ void __launch_bounds__(EPI_NT) epilogue_kernel(EpilogueArgs a) {
  extern __shared__ float sh[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nct = a.B * a.cpi;
  if (blockIdx.x >= EPI_WN_CTAS) {
    const int blk = blockIdx.x - EPI_WN_CTAS, i = blk / a.B, img = blk % a.B;
    for (int grp = warp; grp < 2 * H / 8; grp += EPI_WARPS) {   // sh[br H + j] = dcb scale
      const int br = grp / (H / 8), j0 = grp % (H / 8) * 8;
      float s[8];
      cta_sum8(a.part, (long long)i * PBLK + (br ? ROW_DH_B : ROW_DH_A) * H + j0,
               img * a.cpi, (img + 1) * a.cpi, lane, s);
      if (lane < 8) {
        float v = s[0];
#pragma unroll
        for (int u = 1; u < 8; u++)
          if (lane == u) v = s[u];
        sh[br * H + j0 + lane] = v * a.prep[(i * 2 + br) * prep_stride(a.B) + j0 + lane];
      }
    }
    __syncthreads();
    // a thread per (branch, latent column): the units in order; then a + b
    for (int t = threadIdx.x; t < 2 * a.d_feat; t += EPI_NT) {
      const int b = t / a.d_feat, d = t % a.d_feat, ne = b ? NE_B : NE_A, n_in = ne + a.d_feat;
      const float* v = a.W[i * 10 + b * 5] + ne + d;
      float acc = 0.f;
#pragma unroll 16
      for (int jj = 0; jj < H; jj++) acc = fmaf(sh[b * H + jj], v[(size_t)jj * n_in], acc);
      sh[2 * H + t] = acc;
    }
    __syncthreads();
    for (int d = threadIdx.x; d < a.d_feat; d += EPI_NT)
      a.dcodes[((size_t)i * a.B + img) * a.d_feat + d] = sh[2 * H + d] + sh[2 * H + a.d_feat + d];
    return;
  }
  const int bi = blockIdx.x / (H / EPI_UNITS), j0 = blockIdx.x % (H / EPI_UNITS) * EPI_UNITS;
  const int i = bi >> 1, br = bi & 1;
  const int ne = br ? NE_B : NE_A, no = br ? 3 : 1, nr = ne + 1 + no;
  const long long col = (long long)i * PBLK + (br ? ROW_B : ROW_A) * H + j0;
  float (*rows)[EPI_UNITS] = reinterpret_cast<float (*)[EPI_UNITS]>(sh);   // [nr + 1][8]
  float (*dcb)[EPI_UNITS] = rows + EPI_ROWS + 1;                          // [EPI_IMGS][8]
  for (int r = warp; r <= nr; r += EPI_WARPS) {       // row nr: the block's db1 slots
    float s[8];
    if (r < nr)
      cta_sum8(a.part, col + (long long)r * H, 0, nct, lane, s);
    else
      cta_sum_db1(a.part, (long long)i * PBLK + ROWS * H, 0, nct, lane, s);
    if (lane == 0)
#pragma unroll
      for (int u = 0; u < 8; u++) rows[r][u] = s[u];
  }
  // warp u < 8: unit j0 + u
  const int j = j0 + warp, n_in = ne + a.d_feat;
  const float* const* W = a.W + i * 10 + br * 5;
  float* const* dW = a.dW + i * 10 + br * 5;
  const float* codes = a.codes + (size_t)i * a.B * a.d_feat;
  float* dv = dW[0] + (size_t)j * n_in;
  float db0 = 0.f;
  for (int i0 = 0; i0 < a.B; i0 += EPI_IMGS) {
    const int n_img = min(EPI_IMGS, a.B - i0);
    __syncthreads();   // the previous pass is done with dcb
    for (int img = warp; img < n_img; img += EPI_WARPS) {
      float s[8];
      cta_sum8(a.part, col + (long long)ne * H, (i0 + img) * a.cpi, (i0 + img + 1) * a.cpi,
               lane, s);
      if (lane == 0)
#pragma unroll
        for (int u = 0; u < 8; u++) dcb[img][u] = s[u];
    }
    __syncthreads();
    if (warp < EPI_UNITS) {
      // the latent rows, parked in dv's row across passes
      for (int d = lane; d < a.d_feat; d += 32) {
        float g = i0 ? dv[ne + d] : 0.f;
#pragma unroll 8
        for (int img = 0; img < n_img; img++)
          g = fmaf(codes[(size_t)(i0 + img) * a.d_feat + d], dcb[img][warp], g);
        dv[ne + d] = g;
      }
      if (lane == 0)
        for (int img = 0; img < n_img; img++) db0 += dcb[img][warp];
    }
  }
  if (warp >= EPI_UNITS) return;
  const float* v = W[0] + (size_t)j * n_in;
  const float* prep = a.prep + bi * prep_stride(a.B);
  const float scale = prep[j], norm = prep[H + j];
  __syncwarp();      // another lane of the warp parked dv[k]
  float t = 0.f;
  for (int k = lane; k < n_in; k += 32) t = fmaf(k < ne ? rows[k][warp] : dv[k], v[k], t);
  t = warp_sum(t);
  __syncwarp();
  const float back = __fdiv_rn(W[1][j] * t, norm * norm * norm);
  for (int k = lane; k < n_in; k += 32)
    dv[k] = (k < ne ? rows[k][warp] : dv[k]) * scale - v[k] * back;
  if (lane == 0) {
    dW[1][j] = __fdiv_rn(t, norm);
    dW[2][j] = db0;
  }
  if (lane < no) {
    dW[3][lane * H + j] = rows[ne + 1 + lane][warp];
    if (j == 0) dW[4][lane] = rows[nr][br ? 1 + lane : 0];
  }
}

// Backward CTAs per image: as many as tiles, up to BWD_MINB per SM over all
// images.
static int ctas_per_image(int B, int N) {
  const int tiles = (N + PT - 1) / PT;
  return max(1, min(tiles, BWD_MINB * N_SM / B));
}

static size_t epilogue_smem(int B, int d_feat) {
  return sizeof(float) * max(2 * H + 2 * d_feat,
                             (EPI_ROWS + 1 + min(B, EPI_IMGS)) * EPI_UNITS);
}

}  // namespace inn
}  // namespace niw

using namespace niw::inn;

// prep: the six branches' rows, then the forward's kept state.
extern "C" long long niw_inn_prep_floats(int B, int N) {
  return 6 * prep_stride(B) + (long long)B * N * STATE;
}

// The backward CTAs' partial buffers.
extern "C" long long niw_inn_bwd_workspace_floats(int B, int N) {
  return (long long)B * ctas_per_image(B, N) * PCTA;
}

// pts [B,N,3]; rw1, rw2 [N]; codes [3,B,d_feat]; W: the 30 weight tensors;
// prep: niw_inn_prep_floats(B, N) floats, 16-byte aligned (written; the
// backward reads them); out [B,N,3]. Two launches.
extern "C" int niw_inn_fwd(const float* pts, const float* rw1, const float* rw2,
                           const float* codes, int B, int N, int d_feat,
                           const float* const* W, float* prep, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Args a;
  a.pts = pts; a.rw1 = rw1; a.rw2 = rw2; a.codes = codes; a.g = nullptr; a.prep = prep;
  for (int k = 0; k < 30; k++) a.W[k] = W[k];
  a.B = B; a.N = N; a.d_feat = d_feat; a.cpi = 0;
  a.out = out; a.dpts = nullptr; a.part = nullptr; a.state = prep + 6 * prep_stride(B);
  const long long prep_warps = 6LL * H * ((B + PREP_IMGS - 1) / PREP_IMGS);
  NIW_LAUNCH(prep_kernel<<<(unsigned)((prep_warps + 7) / 8), 256, 0, s>>>(a, prep));
  const long long tiles = (N + FWD_WARPS * FWD_NP - 1) / (FWD_WARPS * FWD_NP);
  NIW_LAUNCH(fwd_kernel<<<(unsigned)(B * tiles), 32 * FWD_WARPS, 0, s>>>(a));
  return 0;
}

// g [B,N,3]: the cotangent of out; prep: as niw_inn_fwd wrote it for the same
// operands; dpts [B,N,3]; dcodes [3,B,d_feat]; dW: 30 gradient buffers shaped
// as W; ws: niw_inn_bwd_workspace_floats(B, N) floats. Two launches.
extern "C" int niw_inn_bwd(const float* pts, const float* rw1, const float* rw2,
                           const float* codes, const float* g, int B, int N, int d_feat,
                           const float* const* W, const float* prep, float* dpts,
                           float* dcodes, float* const* dW, float* ws, void* stream) {
  if (epilogue_smem(B, d_feat) > 48 * 1024) return (int)cudaErrorInvalidValue;
  Args a;
  a.pts = pts; a.rw1 = rw1; a.rw2 = rw2; a.codes = codes; a.g = g; a.prep = prep;
  for (int k = 0; k < 30; k++) a.W[k] = W[k];
  a.B = B; a.N = N; a.d_feat = d_feat; a.cpi = ctas_per_image(B, N);
  a.out = nullptr; a.dpts = dpts; a.part = ws;
  a.state = const_cast<float*>(prep) + 6 * prep_stride(B);
  cudaStream_t s = (cudaStream_t)stream;
  NIW_LAUNCH(bwd_kernel<<<(unsigned)((long long)B * a.cpi), BWD_NT, 0, s>>>(a));
  EpilogueArgs e;
  e.part = ws; e.codes = codes; e.prep = prep; e.dcodes = dcodes;
  e.B = B; e.d_feat = d_feat; e.cpi = a.cpi;
  for (int k = 0; k < 30; k++) { e.W[k] = W[k]; e.dW[k] = dW[k]; }
  NIW_LAUNCH(epilogue_kernel<<<(unsigned)(EPI_WN_CTAS + 3 * B), EPI_NT,
                               epilogue_smem(B, d_feat), s>>>(e));
  return 0;
}
