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
// Design: K5's launch sequence (field_pe.cu) with a copy of the encoded
// inputs into the skip and head buffers in place of the in-kernel PE, and a
// copy of their cotangents out in place of the per-ray PE backward; the PE
// is 0.2% of the work. The routes and bounds are K5's, for the same reasons:
// a forward without `keep` (no autograd) on the tensor cores in split fp32
// (TcGemm, 0.419 / 1.258 ms at 65,536 / 196,608 samples), a forward with
// `keep` in fp32 in gemm_kernel's summation order (Fp32Gemm, 1.033 / 3.099
// ms), because the backward applies its ReLU decisions, and every backward
// product split (TcGemm, with the weight gradients 0.839 / 2.517 ms), all on
// K2's weight planes. Any N: the workspace buffers start at multiples of 4
// floats for every N (the 16-byte copies of both routes need that), and the
// routes mask the ragged edge. No 63 -> 64 / 27 -> 32 / 257 -> 384 padding
// of the operands.
#include "gemm_tc.cuh"

using namespace niw;

extern "C" long long niw_field_fwd_workspace_floats(long long N, int keep) {
  return keep ? cache_floats(N) : scratch_floats(N);
}

extern "C" long long niw_field_bwd_workspace_floats(long long N) {
  return grad_floats(N) + plan_splits((int)N).n * PART_PER_SPLIT;
}

// xp [N,63], view [N,27]; noise [N] or null; W, W_split, w_lo: K2's weight
// operands as niw_rm_fwd takes them; activ 0 softplus, 1 relu; out [N,4];
// ws: niw_field_fwd_workspace_floats(N, keep) floats.
extern "C" int niw_field_fwd(const float* xp, const float* view, const float* noise,
                             int N, const float* const* W, const float* const* W_split,
                             long long w_lo, int activ, int keep, float* out, float* ws,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Cache c = keep ? cache_at(ws, N) : scratch_at(ws, N);
  const long long n_in = (long long)N * ((LD_C4 - COL_XP) + (LD_V - COL_VIEW));
  NIW_LAUNCH(copy_in_kernel<<<(unsigned)((n_in + 255) / 256), 256, 0, s>>>(
      xp, view, N, c.C4, c.V));
  const int err = keep ? mlp_forward(Fp32Gemm(), W, c, N, s)
                       : mlp_forward(TcGemm{w_lo}, W_split, c, N, s);
  if (err) return err;
  NIW_LAUNCH(head_forward_kernel<<<head_blocks(N), 32 * HEAD_WARPS, 0, s>>>(
      c.R0, c.V, W[WR1], W[BR1], noise, N, activ, out));
  return 0;
}

// g [N,4]; W_split, w_lo: K2's split weight operands; cache: the workspace
// of niw_field_fwd(..., keep = 1) on the same inputs (it holds the noised
// density pre-activation); dW: the 20 gradients in K2's packed layout (read
// only when want_dw); ws: niw_field_bwd_workspace_floats(N) floats.
extern "C" int niw_field_bwd(const float* g, int N, const float* const* W_split,
                             long long w_lo, int activ, float* cache, int want_dw,
                             float* dxp, float* dview, float* const* dW, float* ws,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Cache c = cache_at(cache, N);
  const GradBufs gb = grads_at(ws, N);
  NIW_LAUNCH(head_backward_kernel<<<head_blocks(N), 32 * HEAD_WARPS, 0, s>>>(
      c.R0, c.V, W_split[WR1], W_split[BR1], g, N, activ, gb.GR0, gb.GRP, gb.GDENS));
  int err = mlp_backward(TcGemm{w_lo}, W_split, c, gb, N, want_dw, dW, s);
  if (err) return err;
  const long long n_out = (long long)N * (D_X + D_V);
  NIW_LAUNCH(copy_out_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(
      gb.GC4, gb.GV, N, dxp, dview));
  return 0;
}
