// K4: backward of the composited forward render (K3) for an arbitrary
// per-ray cotangent.
//
// Replaces neural_invertible_warp_tpu/ops/pallas/fused_pe.py::
// _rm_bwd_pe_kernel (the VJP of fused_mlp_pe_rm). Given g8 [R,8] =
// d(loss)/d(rgb, depth, opacity) per ray, it returns d(loss)/d(center, ray)
// [R,3] each and, on demand, the 20 weight gradients in K2's packed layout:
// the compositing backward with its depth and opacity terms, the |ray|
// quadrature chain, the MLP backward and the PE backward.
//
// Keep, not recompute: the TPU kernel recomputes the forward per block
// because its fast memory is small. Here K3, when called under autograd,
// keeps every layer's activations in its workspace (9 KB per sample, 2.4 GB
// at 2048 rays x 128 samples) and this kernel starts at the compositing
// backward, which re-derives the per-sample rgb, density and transmittance
// from the cached head activations. That saves the nine forward GEMMs, a
// third of the arithmetic of a recomputing backward.
//
// Weight gradients on demand: with want_dw == 0 (test-time pose refinement
// differentiates with respect to the pose only) the ten weight-gradient
// GEMMs and bias sums are skipped, half of what is left. A background
// colour is composited outside this kernel by the wrapper, so its term
// arrives inside g_opacity.
//
// Layer products: K2's backward route (gemm_tc.cuh), on the tensor cores in
// split fp32 on K2's weight planes: the input-gradient products, and with
// want_dw the split-K weight-gradient products with the bias sums inside and
// the fixed-order reduce_splits_kernel (two launches give the same bits).
// This kernel makes no ReLU decision: the masks it applies are those K3's
// kept fp32 forward took. Bound on that route: 528,000 multiply-adds per
// sample (twice that with want_dw) as three TF32 passes at 495 TFLOP/s,
// 1.68 ms (3.36 ms) at 2048 rays x 128 samples; all fp32 at 67 TFLOP/s 4.13
// ms (8.26 ms). The 16-byte copies of that route need 16-byte aligned
// operands: every buffer of K3's cache (cache_at) and of this workspace
// (grads_at) starts at a multiple of 4 floats. Under tpu.compute_dtype:
// bfloat16 the products take the bf16 tensor-core route (Bf16Gemm: 0.28 /
// 0.56 ms of products at that shape) and the head's input gradient rounds
// its operands (composite_kernel), on a cache that K3 kept in that mode.
#include "gemm_tc.cuh"

using namespace niw;

extern "C" long long niw_rm_bwd_workspace_floats(long long N, int R) {
  return grad_floats(N) + plan_splits((int)N).n * PART_PER_SPLIT + 3LL * R;
}

// center, ray [R,3]; depth [R,K]; g8 [R,8]; w3 [10], wv [4]; W_split, w_lo,
// W_bf16, bf16: K2's split and bf16 weight operands (niw_rm_train's); cache:
// the workspace of
// niw_rm_fwd(..., keep = 1) on the same inputs; dW: the 20 gradients in the
// packed layout (read only when want_dw); ws: niw_rm_bwd_workspace_floats(R*K,
// R) floats.
extern "C" int niw_rm_bwd(const float* center, const float* ray, const float* depth,
                          const float* g8, int R, int K, const float* w3,
                          const float* wv, const float* const* W_split, long long w_lo,
                          const float* const* W_bf16, int bf16, int activ, float* cache,
                          int want_dw, float* dcenter,
                          float* dray, float* const* dW, float* ws, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long N = (long long)R * K;
  const Cache c = cache_at(cache, N);
  const GradBufs g = grads_at(ws, N);
  CompositeArgs a = {};
  a.ray = ray; a.depth = depth; a.R0 = c.R0; a.V = c.V;
  a.Wr1 = W_split[WR1]; a.br1 = W_split[BR1]; a.g8 = g8;
  a.R = R; a.K = K; a.activ = activ; a.train = COMPOSITE_COTANGENT; a.round_bf16 = bf16;
  a.GR0 = g.GR0; a.GRP = g.GRP; a.GDENS = g.GDENS; a.dray_quad = g.DRQ;
  int err = launch_composite(a, s);
  if (err) return err;
  err = bf16 ? mlp_backward(Bf16Gemm(), W_bf16, c, g, (int)N, want_dw, dW, s)
             : mlp_backward(TcGemm{w_lo}, W_split, c, g, (int)N, want_dw, dW, s);
  if (err) return err;
  return launch_input_backward(center, ray, depth, R, K, w3, wv, g, true, dcenter, dray, s);
}
