// K3: composited forward render of the NeRF field, per-ray [R,8] outputs.
//
// Replaces neural_invertible_warp_tpu/ops/pallas/fused_pe.py::_rm_fwd_pe_kernel
// (wrapper fused_render_rays_pe). Same math: in-kernel PE of
// center + ray * depth, the 8x256 MLP, quadrature and alpha compositing with
// an exclusive transmittance scan. The per-ray kernels are nerf_field.cuh's;
// the layer products take K2's GEMM routes (gemm_tc.cuh) on K2's weight
// planes (packed once per parameter version, not per launch).
//
// Without `keep` (every validation and evaluation render chunk), activation
// buffers are reused layer to layer (ping-pong), since no backward reads
// them, and the layer products run on the tensor cores in split fp32
// (TcGemm): no gradient depends on this forward's ReLU decisions, and ReLU,
// softplus and sigmoid are continuous, so a decision that rounding moves
// changes a value by a rounding-sized amount only. Bound on that route: the
// 528,000 multiply-adds per sample as three TF32 passes at 495 TFLOP/s
// (1.68 ms at 2048 rays x 128 samples; 4.13 ms all fp32 at 67).
//
// With `keep` (a call under autograd), every layer's activations stay in the
// workspace, which the caller hands to K4 (rm_bwd.cu) in place of a
// recomputed forward. K4's gradients follow this forward's ReLU decisions,
// and at the flagship's depths (to 1e6) pre-activations reach 1e5, where
// another summation order moves decisions and each moved one changes a
// gradient by a finite amount (rm_train.cu). So this mode keeps the plain
// version's order: fp32 FMAs on the CUDA cores in gemm_kernel's order
// (Fp32Gemm), bound 4.13 ms at that shape. The two modes therefore differ in
// their low bits; each meets the value gate against the plain version.
//
// Under tpu.compute_dtype: bfloat16 the same split by mode holds: the render
// takes the bf16 tensor-core route (Bf16Gemm, 0.28 ms of products at that
// shape), the kept forward Fp32Gemm on operands rounded to bf16, and the
// head's output layer rounds its operands too (composite_kernel).
#include "gemm_tc.cuh"

using namespace niw;

extern "C" long long niw_rm_fwd_workspace_floats(long long N, int keep) {
  return keep ? cache_floats(N) : scratch_floats(N);
}

// center, ray [R,3]; depth [R,K]; w3 [10], wv [4] c2f band weights;
// W, W_split, w_lo, W_bf16, bf16: K2's weight operands as niw_rm_train takes
// them (the packed weights with leading dimensions rounded up to 4, the same
// with the hi planes of the layer weights, each lo plane w_lo floats after
// its hi plane, and with bf16 the same in the bf16 plane); activ 0 softplus,
// 1 relu. out [R,8]; ws:
// niw_rm_fwd_workspace_floats(R*K, keep) floats. Returns the first CUDA
// error of the launch sequence, or 0.
extern "C" int niw_rm_fwd(const float* center, const float* ray, const float* depth,
                          int R, int K, const float* w3, const float* wv,
                          const float* const* W, const float* const* W_split,
                          long long w_lo, const float* const* W_bf16, int bf16, int activ,
                          int keep, float* out, float* ws, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long N = (long long)R * K;
  const Cache c = keep ? cache_at(ws, N) : scratch_at(ws, N);
  NIW_LAUNCH(encode_kernel<<<(unsigned)((N + 127) / 128), 128, 0, s>>>(
      center, ray, depth, R, K, w3, wv, c.C4, c.V));
  const int err = keep ? mlp_forward(Fp32Gemm{bf16}, W, c, (int)N, s)
                  : bf16 ? mlp_forward(Bf16Gemm(), W_bf16, c, (int)N, s)
                         : mlp_forward(TcGemm{w_lo}, W_split, c, (int)N, s);
  if (err) return err;
  CompositeArgs a = {};
  a.ray = ray; a.depth = depth; a.R0 = c.R0; a.V = c.V;
  a.Wr1 = W[WR1]; a.br1 = W[BR1];
  a.R = R; a.K = K; a.activ = activ; a.train = COMPOSITE_FORWARD; a.round_bf16 = bf16;
  a.out = out;
  return launch_composite(a, s);
}
