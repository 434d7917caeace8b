// K2: one-call train render of the NeRF field: forward, in-kernel MSE
// cotangent and backward.
//
// Replaces neural_invertible_warp_tpu/ops/pallas/fused_pe.py::
// _rm_train_pe_kernel (wrapper fused_render_rays_pe_train). Outputs the
// per-ray [R,8] render, d(sq_sum)/d(center, ray) [R,3] each and the 20
// packed weight gradients, where sq_sum = sum_rays valid * |rgb_final -
// target|^2. Optional operands, as in the TPU kernel: `noise` [R,K], added to
// the density pre-activation (the derivative is taken at the noised value),
// and `prob` [R,K], the per-sample compositing weights T * alpha that a
// fine-sampling step resamples from (not differentiated). The backward's
// layer products (input gradients and weight gradients) run on the tensor
// cores in split fp32 (gemm_tc.cuh: bound and design), or under
// tpu.compute_dtype: bfloat16 in one bf16 pass (Bf16Gemm, with the forward's
// operands rounded to bf16 on the same fp32 route). The forward's stay
// fp32 FMAs on the CUDA cores in gemm_kernel's summation order, which the
// plain version's shares (gemm_fp32_kernel, gemm_tc.cuh): at the flagship's
// depths (to 1e6) pre-activations reach 1e5, a rounding difference there
// moves ReLU decisions, and each moved decision changes a gradient by a
// finite amount, so a forward in another summation order misses the plain
// version's 1e-5 gradient gates (a float64 forward misses them too;
// PERF.md, PR 7). The backward makes no such decision. The per-ray kernels
// are those of nerf_field.cuh. Weight gradients use per-split partial sums
// and a fixed-order second pass (no atomics).
#include "gemm_tc.cuh"

using namespace niw;

namespace niw {

// ------------------------------------------------------- weight planes
// K2's layer weights W0..W6, W7p, Wr0p, each [in, out rounded up to 4] with
// zero columns (Fp32Gemm::ld, TcGemm::ld), one after the other: a row of
// PLANE_FLOATS. The planes buffer holds three such rows (the weights, their
// TF32 hi parts, their lo parts), then Wr1 [128, 3] and b7p [257]; for
// tpu.compute_dtype: bfloat16 it goes on, from the next multiple of 4 floats
// (BF16_BASE, the floats between zero), with the bf16 plane: the same
// weights, each [in, out rounded up to 8] (Bf16Gemm::ld), rounded to bf16
// to nearest even (PLANE_HALVES 16-bit values). What fused_pe.py's
// k2_planes_plain computes with PyTorch operations, in one launch from the
// module's parameters.
__host__ __device__ constexpr int plane_in(int slot) {
  return slot == 0 ? D_X : slot == 4 ? D_HID + D_X : slot == 8 ? K_WR0 : D_HID;
}
__host__ __device__ constexpr int plane_n(int slot) {
  return slot == 7 ? N_W7 : slot == 8 ? D_HEAD : D_HID;
}
__host__ __device__ constexpr int plane_ld(int slot) { return (plane_n(slot) + 3) & ~3; }
__host__ __device__ constexpr int plane_ld16(int slot) { return (plane_n(slot) + 7) & ~7; }
constexpr long long plane_offset(int slot) {
  return slot == 0 ? 0 : plane_offset(slot - 1) + (long long)plane_in(slot - 1) * plane_ld(slot - 1);
}
constexpr long long plane_offset16(int slot) {
  return slot == 0 ? 0
                   : plane_offset16(slot - 1) + (long long)plane_in(slot - 1) * plane_ld16(slot - 1);
}
constexpr long long PLANE_FLOATS = plane_offset(9);
constexpr long long PLANES_TAIL = D_HEAD * 3 + N_W7;
constexpr long long BF16_BASE = (3 * PLANE_FLOATS + PLANES_TAIL + 3) & ~3LL;
constexpr long long BF16_PAD = BF16_BASE - 3 * PLANE_FLOATS - PLANES_TAIL;
constexpr long long PLANE_HALVES = plane_offset16(9);


struct Params { const float* p[20]; };

// Element (r, c) of packed layer weight `slot` (zero in the padding columns).
// params: the module's 20 parameters in mlp.parameters() order (mlp_feat.i
// weight [out, in] and bias, i = 0..7, then mlp_rgb.0 and .1).
__device__ __forceinline__ float packed_weight(const Params& params, int s, int r, int c) {
  if (c >= plane_n(s)) return 0.f;
  if (s < 7) return params.p[2 * s][(long long)c * plane_in(s) + r];   // W_s = weight^T
  if (s == 7) return params.p[14][(c < D_HID ? c + 1 : 0) * D_HID + r];   // density last
  // Wr0p: a zero row for the density slot
  return r == COL_DENS ? 0.f : params.p[16][c * (K_WR0 - 1) + (r < COL_DENS ? r : r - 1)];
}

// (slot, row, column) of element i of an fp32 row (leading dimensions
// plane_ld) or of the bf16 plane (plane_ld16).
__device__ __forceinline__ void plane_coords(long long i, bool bf16, int& s, int& r, int& c) {
  s = 0;
  long long off = 0;
  while (s < 8 && i >= off + (long long)plane_in(s) * (bf16 ? plane_ld16(s) : plane_ld(s))) {
    off += (long long)plane_in(s) * (bf16 ? plane_ld16(s) : plane_ld(s));
    s++;
  }
  const int ld = bf16 ? plane_ld16(s) : plane_ld(s);
  r = (int)((i - off) / ld);
  c = (int)((i - off) % ld);
}

// Threads 0.. PLANE_FLOATS: the three fp32 rows; then the tail; then, with
// bf16, the padding to BF16_BASE and the bf16 plane.
static __global__ void pack_planes_kernel(Params params, float* planes, int bf16) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int s, r, c;
  if (i >= PLANE_FLOATS) {
    const long long j = i - PLANE_FLOATS;
    float* tail = planes + 3 * PLANE_FLOATS;
    if (j < D_HEAD * 3) {   // Wr1 = mlp_rgb.1.weight^T
      tail[j] = params.p[18][(j % 3) * D_HEAD + j / 3];
    } else if (j < PLANES_TAIL) {   // b7p: the density bias last
      const int k = (int)(j - D_HEAD * 3);
      tail[j] = params.p[15][k < D_HID ? k + 1 : 0];
    } else if (bf16 && j < PLANES_TAIL + BF16_PAD) {
      tail[j] = 0.f;
    } else if (bf16 && j < PLANES_TAIL + BF16_PAD + PLANE_HALVES) {
      const long long h = j - PLANES_TAIL - BF16_PAD;
      plane_coords(h, true, s, r, c);
      reinterpret_cast<__nv_bfloat16*>(planes + BF16_BASE)[h] =
          __float2bfloat16_rn(packed_weight(params, s, r, c));
    }
    return;
  }
  plane_coords(i, false, s, r, c);
  const float v = packed_weight(params, s, r, c);
  uint32_t hi, lo;
  split_tf32(v, hi, lo);
  planes[i] = v;
  planes[PLANE_FLOATS + i] = __uint_as_float(hi);
  planes[2 * PLANE_FLOATS + i] = __uint_as_float(lo);
}

}  // namespace niw

extern "C" long long niw_rm_train_plane_offset(int slot) { return plane_offset(slot); }
// The bf16 plane's slot offsets in 16-bit elements (slot 9: PLANE_HALVES), and
// with slot -1 its start in the planes buffer in floats (BF16_BASE).
extern "C" long long niw_rm_train_bf16_offset(int slot) {
  return slot < 0 ? BF16_BASE : plane_offset16(slot);
}

// planes: 3 * niw_rm_train_plane_offset(9) + 128 * 3 + 257 floats, and with
// bf16 BF16_BASE + PLANE_HALVES / 2.
extern "C" int niw_rm_train_pack(const float* const* params, float* planes, int bf16,
                                 void* stream) {
  Params a;
  for (int k = 0; k < 20; k++) a.p[k] = params[k];
  const long long n = PLANE_FLOATS + PLANES_TAIL + (bf16 ? BF16_PAD + PLANE_HALVES : 0);
  NIW_LAUNCH(pack_planes_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      a, planes, bf16));
  return 0;
}

extern "C" long long niw_rm_train_workspace_floats(long long N, int R) {
  const Splits sp = plan_splits((int)N);
  return cache_floats(N) + grad_floats(N) + sp.n * PART_PER_SPLIT + 3LL * R;
}

// center, ray [R,3]; depth [R,K]; target8 [R,8] (rgb, valid flag, 0...);
// w3 [10], wv [4]; W: the 20 packed weights, W[W0..WR0] with leading
// dimensions rounded up to 4 (Fp32Gemm::ld); W_split: the same with
// W_split[W0..WR0] the hi planes of the split layer weights (TcGemm::ld),
// each lo plane w_lo floats after its hi plane; W_bf16 (read with bf16):
// the same with W_bf16[W0..WR0] in the bf16 plane (Bf16Gemm::ld); bf16:
// tpu.compute_dtype is bfloat16; dW: the 20 gradients in the packed layout;
// activ 0 softplus, 1 relu; has_bg / bg: setbg_opaque background; noise and
// prob [R,K] or null.
extern "C" int niw_rm_train(const float* center, const float* ray, const float* depth,
                            const float* target8, const float* noise, int R, int K,
                            const float* w3, const float* wv,
                            const float* const* W, const float* const* W_split,
                            long long w_lo, const float* const* W_bf16, int bf16, int activ,
                            int has_bg, float bg, float* out, float* dcenter,
                            float* dray, float* const* dW, float* prob, float* ws,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long N = (long long)R * K;
  const int n = (int)N;
  const Cache c = cache_at(ws, N);
  const GradBufs g = grads_at(ws + cache_floats(N), N);

  NIW_LAUNCH(encode_kernel<<<(unsigned)((N + 127) / 128), 128, 0, s>>>(
      center, ray, depth, R, K, w3, wv, c.C4, c.V));
  int err = mlp_forward(Fp32Gemm{bf16}, W, c, n, s);
  if (err) return err;
  CompositeArgs a = {};
  a.ray = ray; a.depth = depth; a.R0 = c.R0; a.V = c.V;
  a.Wr1 = W[WR1]; a.br1 = W[BR1]; a.target8 = target8; a.noise = noise; a.prob = prob;
  a.R = R; a.K = K; a.activ = activ; a.train = COMPOSITE_MSE; a.has_bg = has_bg;
  a.bg = has_bg ? bg : 0.f;
  a.round_bf16 = bf16;
  a.out = out; a.GR0 = g.GR0; a.GRP = g.GRP; a.GDENS = g.GDENS; a.dray_quad = g.DRQ;
  if ((err = launch_composite(a, s))) return err;
  err = bf16 ? mlp_backward(Bf16Gemm(), W_bf16, c, g, n, 1, dW, s)
             : mlp_backward(TcGemm{w_lo}, W_split, c, g, n, 1, dW, s);
  if (err) return err;
  return launch_input_backward(center, ray, depth, R, K, w3, wv, g, true, dcenter, dray, s);
}
