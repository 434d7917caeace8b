// K5: the NeRF field per sample, PE included, without compositing: forward
// and its backward.
//
// Replaces neural_invertible_warp_tpu/ops/pallas/fused_pe.py::_fwd_pe_kernel
// and ::_bwd_pe_kernel (fused_mlp_pe; wrappers fused_apply_nerf_samples_pe
// and its channel-separated twin, which exists for TPU lanes only: this one
// kernel serves both). Forward: the c2f PE of center + ray * depth, the
// per-ray view PE, the 8x256 MLP, an optional [R,K] noise on the density
// pre-activation -> out [R*K,4] = (rgb, density). Backward: the VJP for a
// per-sample cotangent g [R*K,4] -> per-ray dcenter, dray (PE and view
// chains; the quadrature's |ray| chain belongs to the compositing, which
// lies outside this kernel) and, on demand, the 20 weight gradients.
//
// Bound: operations (1.06 MFLOP per sample forward in fp32 FMAs against 16
// bytes out), as for K2-K4. Design: the launch sequence of K3 and K4 with a
// per-sample head (head_forward_kernel, head_backward_kernel) in place of the
// per-ray compositing. Keep, not recompute: a forward under autograd keeps
// every layer's activations (9 KB per sample) and the backward starts at the
// head; the TPU kernel recomputes only for want of fast memory. Without
// `keep` (an eval render) two hidden buffers are reused layer to layer. Any
// R and any K <= 256: no ray blocks, no K % 8 rule, no lane padding.
#include "nerf_field.cuh"

using namespace niw;

extern "C" long long niw_field_pe_fwd_workspace_floats(long long N, int keep) {
  return keep ? cache_floats(N) : scratch_floats(N);
}

extern "C" long long niw_field_pe_bwd_workspace_floats(long long N) {
  return grad_floats(N) + plan_splits((int)N).n * PART_PER_SPLIT;
}

// center, ray [R,3]; depth [R,K]; noise [R,K] or null; w3 [10], wv [4] c2f
// band weights; W: the 20 packed weights; activ 0 softplus, 1 relu;
// out [R*K,4]; ws: niw_field_pe_fwd_workspace_floats(R*K, keep) floats.
extern "C" int niw_field_pe_fwd(const float* center, const float* ray, const float* depth,
                                const float* noise, int R, int K, const float* w3,
                                const float* wv, const float* const* W, int activ,
                                int keep, float* out, float* ws, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long N = (long long)R * K;
  const Cache c = keep ? cache_at(ws, N) : scratch_at(ws, N);
  NIW_LAUNCH(encode_kernel<<<(unsigned)((N + 127) / 128), 128, 0, s>>>(
      center, ray, depth, R, K, w3, wv, c.C4, c.V));
  int err = mlp_forward(SimtGemm(), W, c, (int)N, s);
  if (err) return err;
  NIW_LAUNCH(head_forward_kernel<<<(unsigned)((N + 127) / 128), 128, 0, s>>>(
      c.R0, c.V, W[WR1], W[BR1], noise, N, activ, out));
  return 0;
}

// g [R*K,4]; cache: the workspace of niw_field_pe_fwd(..., keep = 1) on the
// same inputs (it holds the noised density pre-activation); dW: 20 gradient
// buffers (read only when want_dw); ws: niw_field_pe_bwd_workspace_floats(R*K)
// floats.
extern "C" int niw_field_pe_bwd(const float* center, const float* ray, const float* depth,
                                const float* g, int R, int K, const float* w3,
                                const float* wv, const float* const* W, int activ,
                                float* cache, int want_dw, float* dcenter, float* dray,
                                float* const* dW, float* ws, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long N = (long long)R * K;
  const Cache c = cache_at(cache, N);
  const GradBufs gb = grads_at(ws, N);
  NIW_LAUNCH(head_backward_kernel<<<(unsigned)((N + 127) / 128), 128, 0, s>>>(
      c.R0, c.V, W[WR1], W[BR1], g, N, activ, gb.GR0, gb.GRP, gb.GDENS));
  int err = mlp_backward(SimtGemm(), W, c, gb, (int)N, want_dw, dW, s);
  if (err) return err;
  return launch_input_backward(center, ray, depth, R, K, w3, wv, gb, false, dcenter,
                               dray, s);
}
