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
// fine-sampling step resamples from (not differentiated). Bound and design:
// see nerf_field.cuh. Weight gradients use per-split partial sums and a
// fixed-order second pass (no atomics).
#include "nerf_field.cuh"

using namespace niw;

extern "C" long long niw_rm_train_workspace_floats(long long N, int R) {
  const Splits sp = plan_splits((int)N);
  return cache_floats(N) + grad_floats(N) + sp.n * PART_PER_SPLIT + 3LL * R;
}

// center, ray [R,3]; depth [R,K]; target8 [R,8] (rgb, valid flag, 0...);
// w3 [10], wv [4]; W / dW: the 20 packed weights and their gradients;
// activ 0 softplus, 1 relu; has_bg / bg: setbg_opaque background; noise and
// prob [R,K] or null.
extern "C" int niw_rm_train(const float* center, const float* ray, const float* depth,
                            const float* target8, const float* noise, int R, int K,
                            const float* w3, const float* wv,
                            const float* const* W, int activ,
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
  int err = mlp_forward(W, c, n, s);
  if (err) return err;
  CompositeArgs a = {};
  a.ray = ray; a.depth = depth; a.R0 = c.R0; a.V = c.V;
  a.Wr1 = W[WR1]; a.br1 = W[BR1]; a.target8 = target8; a.noise = noise; a.prob = prob;
  a.R = R; a.K = K; a.activ = activ; a.train = COMPOSITE_MSE; a.has_bg = has_bg;
  a.bg = has_bg ? bg : 0.f;
  a.out = out; a.GR0 = g.GR0; a.GRP = g.GRP; a.GDENS = g.GDENS; a.dray_quad = g.DRQ;
  if ((err = launch_composite(a, s))) return err;
  if ((err = mlp_backward(W, c, g, n, 1, dW, s))) return err;
  return launch_input_backward(center, ray, depth, R, K, w3, wv, g, true, dcenter, dray, s);
}
