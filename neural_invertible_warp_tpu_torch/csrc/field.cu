// K1: the NeRF field MLP on encoded inputs (the PE stays outside, under
// autograd): forward and its backward.
//
// Replaces neural_invertible_warp_tpu/ops/pallas/fused_field.py::_fwd_kernel
// and ::_bwd_kernel (fused_mlp; wrapper fused_apply_nerf_samples). Forward:
// xp [N,63] (points and their PE), view [N,27] (unit ray and its PE, per
// sample) -> the 8x256 trunk with the skip at layer 4, density from the last
// trunk layer (softplus or relu), the 283 -> 128 -> 3 sigmoid head ->
// out [N,4] = (rgb, density). Backward: the VJP for g [N,4] -> dxp [N,63],
// dview [N,27] and, on demand, the 20 weight gradients. An optional [N] noise
// is added to the density pre-activation, as in K5 and K2 (the TPU kernel
// has no such operand, and its caller leaves it for the plain chain when
// noise is active): the kept cache holds the noised value, so the backward
// takes the activation's derivative there.
//
// Bound: operations, as for K5 (the PE is 0.2% of the work). Design: K5's
// launch sequence with a copy of the encoded inputs into the skip and head
// buffers in place of the in-kernel PE, and a copy of their cotangents out
// in place of the per-ray PE backward. A forward under autograd keeps its
// activations for the backward; without, two hidden buffers are reused. No
// 63 -> 64 / 27 -> 32 / 257 -> 384 padding of the operands.
#include "nerf_field.cuh"

using namespace niw;

extern "C" long long niw_field_fwd_workspace_floats(long long N, int keep) {
  return keep ? cache_floats(N) : scratch_floats(N);
}

extern "C" long long niw_field_bwd_workspace_floats(long long N) {
  return grad_floats(N) + plan_splits((int)N).n * PART_PER_SPLIT;
}

// xp [N,63], view [N,27]; noise [N] or null; W: the 20 packed weights; activ
// 0 softplus, 1 relu; out [N,4]; ws: niw_field_fwd_workspace_floats(N, keep)
// floats.
extern "C" int niw_field_fwd(const float* xp, const float* view, const float* noise,
                             int N, const float* const* W, int activ, int keep,
                             float* out, float* ws, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Cache c = keep ? cache_at(ws, N) : scratch_at(ws, N);
  const long long n_in = (long long)N * ((LD_C4 - COL_XP) + (LD_V - COL_VIEW));
  NIW_LAUNCH(copy_in_kernel<<<(unsigned)((n_in + 255) / 256), 256, 0, s>>>(
      xp, view, N, c.C4, c.V));
  int err = mlp_forward(SimtGemm(), W, c, N, s);
  if (err) return err;
  NIW_LAUNCH(head_forward_kernel<<<(unsigned)((N + 127) / 128), 128, 0, s>>>(
      c.R0, c.V, W[WR1], W[BR1], noise, N, activ, out));
  return 0;
}

// g [N,4]; cache: the workspace of niw_field_fwd(..., keep = 1) on the same
// inputs (it holds the noised density pre-activation); dW: 20 gradient
// buffers (read only when want_dw); ws: niw_field_bwd_workspace_floats(N)
// floats.
extern "C" int niw_field_bwd(const float* g, int N, const float* const* W, int activ,
                             float* cache, int want_dw, float* dxp, float* dview,
                             float* const* dW, float* ws, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Cache c = cache_at(cache, N);
  const GradBufs gb = grads_at(ws, N);
  NIW_LAUNCH(head_backward_kernel<<<(unsigned)((N + 127) / 128), 128, 0, s>>>(
      c.R0, c.V, W[WR1], W[BR1], g, N, activ, gb.GR0, gb.GRP, gb.GDENS));
  int err = mlp_backward(SimtGemm(), W, c, gb, N, want_dw, dW, s);
  if (err) return err;
  const long long n_out = (long long)N * (D_X + D_V);
  NIW_LAUNCH(copy_out_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(
      gb.GC4, gb.GV, N, dxp, dview));
  return 0;
}
