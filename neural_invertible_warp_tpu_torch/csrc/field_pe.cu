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
// Design: K3's and K4's launch sequence with a per-sample head
// (head_forward_kernel, head_backward_kernel) in place of the per-ray
// compositing, on K2's GEMM routes (gemm_tc.cuh) and K2's weight planes
// (packed once per parameter version, not per launch). Keep, not recompute:
// a forward under autograd keeps every layer's activations (9 KB per sample)
// and the backward starts at the head; the TPU kernel recomputes only for
// want of fast memory. Any R and any K <= 256: no ray blocks, no K % 8 rule,
// no lane padding.
//
// Which route each product takes, and its bound (528,000 multiply-adds per
// sample per set of layer products; at [1,1024] rays x 64 / x 192 samples):
// - Forward without `keep` (every render chunk of the fine model's
//   validation and evaluation, no autograd): split fp32 on the tensor cores
//   (TcGemm), three TF32 passes at 495 TFLOP/s, 0.419 / 1.258 ms. No
//   gradient reads this forward's ReLU decisions, and relu, softplus and
//   sigmoid are continuous, so a decision that rounding moves changes a
//   value by a rounding-sized amount only.
// - Forward with `keep` (under autograd, feeding the backward): fp32 FMAs on
//   the CUDA cores in gemm_kernel's summation order (Fp32Gemm, the same bits
//   as the plain SGEMM), 67 TFLOP/s, 1.033 / 3.099 ms: the backward applies
//   this forward's ReLU decisions, and the plain version's decisions follow
//   that rounding (rm_train.cu says why a moved decision misses the
//   gradient gates). With density noise the kept cache holds the noised
//   pre-activation, whose derivative the backward takes.
// - Backward: the input-gradient products and, on demand, the split-K
//   weight-gradient products with the bias sums inside, split fp32
//   (TcGemm), 0.839 / 2.517 ms with the weight gradients; the fixed-order
//   reduce_splits_kernel keeps two launches' bits equal. It makes no ReLU
//   decision of its own.
// The 16-byte copies of both routes need 16-byte aligned operands: every
// buffer of the workspaces (cache_at, scratch_at, grads_at) starts at a
// multiple of 4 floats, whatever R and K.
#include "gemm_tc.cuh"

using namespace niw;

extern "C" long long niw_field_pe_fwd_workspace_floats(long long N, int keep) {
  return keep ? cache_floats(N) : scratch_floats(N);
}

extern "C" long long niw_field_pe_bwd_workspace_floats(long long N) {
  return grad_floats(N) + plan_splits((int)N).n * PART_PER_SPLIT;
}

// center, ray [R,3]; depth [R,K]; noise [R,K] or null; w3 [10], wv [4] c2f
// band weights; W, W_split, w_lo: K2's weight operands as niw_rm_fwd takes
// them; activ 0 softplus, 1 relu; out [R*K,4]; ws:
// niw_field_pe_fwd_workspace_floats(R*K, keep) floats. Returns the first CUDA
// error of the launch sequence, or 0.
extern "C" int niw_field_pe_fwd(const float* center, const float* ray, const float* depth,
                                const float* noise, int R, int K, const float* w3,
                                const float* wv, const float* const* W,
                                const float* const* W_split, long long w_lo, int activ,
                                int keep, float* out, float* ws, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long N = (long long)R * K;
  const Cache c = keep ? cache_at(ws, N) : scratch_at(ws, N);
  NIW_LAUNCH(encode_kernel<<<(unsigned)((N + 127) / 128), 128, 0, s>>>(
      center, ray, depth, R, K, w3, wv, c.C4, c.V));
  const int err = keep ? mlp_forward(Fp32Gemm(), W, c, (int)N, s)
                       : mlp_forward(TcGemm{w_lo}, W_split, c, (int)N, s);
  if (err) return err;
  NIW_LAUNCH(head_forward_kernel<<<head_blocks(N), 32 * HEAD_WARPS, 0, s>>>(
      c.R0, c.V, W[WR1], W[BR1], noise, N, activ, out));
  return 0;
}

// g [R*K,4]; W_split, w_lo: K2's split weight operands; cache: the workspace
// of niw_field_pe_fwd(..., keep = 1) on the same inputs (it holds the noised
// density pre-activation); dW: the 20 gradients in K2's packed layout (read
// only when want_dw); ws: niw_field_pe_bwd_workspace_floats(R*K) floats.
extern "C" int niw_field_pe_bwd(const float* center, const float* ray, const float* depth,
                                const float* g, int R, int K, const float* w3,
                                const float* wv, const float* const* W_split,
                                long long w_lo, int activ, float* cache, int want_dw,
                                float* dcenter, float* dray, float* const* dW, float* ws,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long N = (long long)R * K;
  const Cache c = cache_at(cache, N);
  const GradBufs gb = grads_at(ws, N);
  NIW_LAUNCH(head_backward_kernel<<<head_blocks(N), 32 * HEAD_WARPS, 0, s>>>(
      c.R0, c.V, W_split[WR1], W_split[BR1], g, N, activ, gb.GR0, gb.GRP, gb.GDENS));
  int err = mlp_backward(TcGemm{w_lo}, W_split, c, gb, (int)N, want_dw, dW, s);
  if (err) return err;
  return launch_input_backward(center, ray, depth, R, K, w3, wv, gb, false, dcenter,
                               dray, s);
}
