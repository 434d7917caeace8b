// K4: backward of the composited forward render (K3) for an arbitrary
// per-ray cotangent.
//
// Replaces neural_invertible_warp_tpu/ops/pallas/fused_pe.py::
// _rm_bwd_pe_kernel (the VJP of fused_mlp_pe_rm). Given g8 [R,8] =
// d(loss)/d(rgb, depth, opacity) per ray, it returns d(loss)/d(center, ray)
// [R,3] each and, on demand, the 20 packed weight gradients: the compositing
// backward with its depth and opacity terms, the |ray| quadrature chain, the
// MLP backward and the PE backward.
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
// arrives inside g_opacity. Bound and design of the parts: nerf_field.cuh.
#include "nerf_field.cuh"

using namespace niw;

extern "C" long long niw_rm_bwd_workspace_floats(long long N, int R) {
  return grad_floats(N) + plan_splits((int)N).n * PART_PER_SPLIT + 3LL * R;
}

// center, ray [R,3]; depth [R,K]; g8 [R,8]; w3 [10], wv [4]; W: the 20
// packed weights; cache: the workspace of niw_rm_fwd(..., keep = 1) on the
// same inputs; dW: 20 gradient buffers (read only when want_dw);
// ws: niw_rm_bwd_workspace_floats(R*K, R) floats.
extern "C" int niw_rm_bwd(const float* center, const float* ray, const float* depth,
                          const float* g8, int R, int K, const float* w3,
                          const float* wv, const float* const* W, int activ,
                          float* cache, int want_dw, float* dcenter, float* dray,
                          float* const* dW, float* ws, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long N = (long long)R * K;
  const Cache c = cache_at(cache, N);
  const GradBufs g = grads_at(ws, N);
  CompositeArgs a = {};
  a.ray = ray; a.depth = depth; a.R0 = c.R0; a.V = c.V;
  a.Wr1 = W[WR1]; a.br1 = W[BR1]; a.g8 = g8;
  a.R = R; a.K = K; a.activ = activ; a.train = COMPOSITE_COTANGENT;
  a.GR0 = g.GR0; a.GRP = g.GRP; a.GDENS = g.GDENS; a.dray_quad = g.DRQ;
  int err = launch_composite(a, s);
  if (err) return err;
  if ((err = mlp_backward(SimtGemm(), W, c, g, (int)N, want_dw, dW, s))) return err;
  return launch_input_backward(center, ray, depth, R, K, w3, wv, g, true, dcenter, dray, s);
}
