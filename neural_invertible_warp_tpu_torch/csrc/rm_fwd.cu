// K3: composited forward render of the NeRF field, per-ray [R,8] outputs.
//
// Replaces neural_invertible_warp_tpu/ops/pallas/fused_pe.py::_rm_fwd_pe_kernel
// (wrapper fused_render_rays_pe). Same math: in-kernel PE of
// center + ray * depth, the 8x256 MLP, quadrature and alpha compositing with
// an exclusive transmittance scan. Bound and design: see nerf_field.cuh.
// Without `keep`, activation buffers are reused layer to layer (ping-pong),
// since no backward reads them. With `keep` (a call under autograd), every
// layer's activations stay in the workspace, which the caller hands to K4
// (rm_bwd.cu) in place of a recomputed forward. The GEMMs and their inputs
// are the same either way, so the outputs are bit-identical.
#include "nerf_field.cuh"

using namespace niw;

extern "C" long long niw_rm_fwd_workspace_floats(long long N, int keep) {
  return keep ? cache_floats(N) : scratch_floats(N);
}

// center, ray [R,3]; depth [R,K]; w3 [10], wv [4] c2f band weights;
// W: the 20 packed weights (see nerf_field.cuh); activ 0 softplus, 1 relu.
// out [R,8]; ws: niw_rm_fwd_workspace_floats(R*K, keep) floats. Returns the
// first CUDA error of the launch sequence, or 0.
extern "C" int niw_rm_fwd(const float* center, const float* ray, const float* depth,
                          int R, int K, const float* w3, const float* wv,
                          const float* const* W, int activ, int keep, float* out,
                          float* ws, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long N = (long long)R * K;
  const Cache c = keep ? cache_at(ws, N) : scratch_at(ws, N);
  NIW_LAUNCH(encode_kernel<<<(unsigned)((N + 127) / 128), 128, 0, s>>>(
      center, ray, depth, R, K, w3, wv, c.C4, c.V));
  int err = mlp_forward(SimtGemm(), W, c, (int)N, s);
  if (err) return err;
  CompositeArgs a = {};
  a.ray = ray; a.depth = depth; a.R0 = c.R0; a.V = c.V;
  a.Wr1 = W[WR1]; a.br1 = W[BR1];
  a.R = R; a.K = K; a.activ = activ; a.train = COMPOSITE_FORWARD;
  a.out = out;
  return launch_composite(a, s);
}
