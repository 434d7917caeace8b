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
// cores in split fp32 (gemm_tc.cuh: bound and design). The forward's stay
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
// TF32 hi parts, their lo parts), then Wr1 [128, 3] and b7p [257]: what
// fused_pe.py's k2_planes_plain computes with PyTorch operations, in one
// launch from the module's parameters.
__host__ __device__ constexpr int plane_in(int slot) {
  return slot == 0 ? D_X : slot == 4 ? D_HID + D_X : slot == 8 ? K_WR0 : D_HID;
}
__host__ __device__ constexpr int plane_ld(int slot) {
  return slot == 7 ? (N_W7 + 3) & ~3 : slot == 8 ? D_HEAD : D_HID;
}
constexpr long long plane_offset(int slot) {
  return slot == 0 ? 0 : plane_offset(slot - 1) + (long long)plane_in(slot - 1) * plane_ld(slot - 1);
}
constexpr long long PLANE_FLOATS = plane_offset(9);
constexpr long long PLANES_TAIL = D_HEAD * 3 + N_W7;


struct Params { const float* p[20]; };

// params: the module's 20 parameters in mlp.parameters() order (mlp_feat.i
// weight [out, in] and bias, i = 0..7, then mlp_rgb.0 and .1).
static __global__ void pack_planes_kernel(Params params, float* planes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= PLANE_FLOATS) {
    const long long j = i - PLANE_FLOATS;
    float* tail = planes + 3 * PLANE_FLOATS;
    if (j < D_HEAD * 3) {   // Wr1 = mlp_rgb.1.weight^T
      tail[j] = params.p[18][(j % 3) * D_HEAD + j / 3];
    } else if (j < PLANES_TAIL) {   // b7p: the density bias last
      const int k = (int)(j - D_HEAD * 3);
      tail[j] = params.p[15][k < D_HID ? k + 1 : 0];
    }
    return;
  }
  int s = 0;
  long long off = 0;
  while (s < 8 && i >= off + (long long)plane_in(s) * plane_ld(s)) {
    off += (long long)plane_in(s) * plane_ld(s);
    s++;
  }
  const int ld = plane_ld(s);
  const int r = (int)((i - off) / ld), c = (int)((i - off) % ld);
  float v = 0.f;
  if (s < 7) {           // W_s = weight^T
    v = params.p[2 * s][(long long)c * plane_in(s) + r];
  } else if (s == 7) {   // W7p: features, then the density column
    if (c < N_W7) v = params.p[14][(c < D_HID ? c + 1 : 0) * D_HID + r];
  } else if (r != COL_DENS) {   // Wr0p: a zero row for the density slot
    v = params.p[16][c * (K_WR0 - 1) + (r < COL_DENS ? r : r - 1)];
  }
  uint32_t hi, lo;
  split_tf32(v, hi, lo);
  planes[i] = v;
  planes[PLANE_FLOATS + i] = __uint_as_float(hi);
  planes[2 * PLANE_FLOATS + i] = __uint_as_float(lo);
}

}  // namespace niw

extern "C" long long niw_rm_train_plane_offset(int slot) { return plane_offset(slot); }

// planes: 3 * niw_rm_train_plane_offset(9) + 128 * 3 + 257 floats.
extern "C" int niw_rm_train_pack(const float* const* params, float* planes, void* stream) {
  Params a;
  for (int k = 0; k < 20; k++) a.p[k] = params[k];
  const long long n = PLANE_FLOATS + PLANES_TAIL;
  NIW_LAUNCH(pack_planes_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      a, planes));
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
// each lo plane w_lo floats after its hi plane; dW: the 20 gradients in the
// packed layout; activ 0 softplus, 1 relu; has_bg / bg: setbg_opaque background; noise and
// prob [R,K] or null.
extern "C" int niw_rm_train(const float* center, const float* ray, const float* depth,
                            const float* target8, const float* noise, int R, int K,
                            const float* w3, const float* wv,
                            const float* const* W, const float* const* W_split,
                            long long w_lo, int activ,
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
  int err = mlp_forward(Fp32Gemm(), W, c, n, s);
  if (err) return err;
  CompositeArgs a = {};
  a.ray = ray; a.depth = depth; a.R0 = c.R0; a.V = c.V;
  a.Wr1 = W[WR1]; a.br1 = W[BR1]; a.target8 = target8; a.noise = noise; a.prob = prob;
  a.R = R; a.K = K; a.activ = activ; a.train = COMPOSITE_MSE; a.has_bg = has_bg;
  a.bg = has_bg ? bg : 0.f;
  a.out = out; a.GR0 = g.GR0; a.GRP = g.GRP; a.GDENS = g.GDENS; a.dray_quad = g.DRQ;
  if ((err = launch_composite(a, s))) return err;
  if ((err = mlp_backward(TcGemm{w_lo}, W_split, c, g, n, 1, dW, s))) return err;
  return launch_input_backward(center, ray, depth, R, K, w3, wv, g, true, dcenter, dray, s);
}
