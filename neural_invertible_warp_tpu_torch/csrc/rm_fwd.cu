// K3: composited forward render of the NeRF field, per-ray [R,8] outputs.
//
// Replaces neural_invertible_warp_tpu/ops/pallas/fused_pe.py::_rm_fwd_pe_kernel
// (wrapper fused_render_rays_pe). Same math: in-kernel PE of
// center + ray * depth, the 8x256 MLP, quadrature and alpha compositing with
// an exclusive transmittance scan. Forward only: its backward (K4) is not
// ported yet. Bound and design: see nerf_field.cuh. Activation buffers are
// reused layer to layer (ping-pong), since no backward reads them.
#include "nerf_field.cuh"

using namespace niw;

extern "C" long long niw_rm_fwd_workspace_floats(long long N) {
  return N * (LD_C4 + 2 * D_HID + LD_V + D_HEAD);
}

// center, ray [R,3]; depth [R,K]; w3 [10], wv [4] c2f band weights;
// W: the 20 packed weights (see nerf_field.cuh); activ 0 softplus, 1 relu.
// out [R,8]; ws: niw_rm_fwd_workspace_floats(R*K) floats. Returns the first
// CUDA error of the launch sequence, or 0.
extern "C" int niw_rm_fwd(const float* center, const float* ray, const float* depth,
                          int R, int K, const float* w3, const float* wv,
                          const float* const* W, int activ, float* out, float* ws,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long N = (long long)R * K;
  Cache c;
  c.C4 = ws;
  float* HA = c.C4 + N * LD_C4;
  float* HB = HA + N * D_HID;
  c.V = HB + N * D_HID;
  c.R0 = c.V + N * LD_V;
  c.H0 = HA; c.H1 = HB; c.H2 = HA; c.H4 = HB; c.H5 = HA; c.H6 = HB;
  NIW_LAUNCH(encode_kernel<<<(unsigned)((N + 127) / 128), 128, 0, s>>>(
      center, ray, depth, R, K, w3, wv, c.C4, c.V));
  int err = mlp_forward(W, c, (int)N, s);
  if (err) return err;
  CompositeArgs a = {};
  a.ray = ray; a.depth = depth; a.R0 = c.R0; a.V = c.V;
  a.Wr1 = W[WR1]; a.br1 = W[BR1];
  a.R = R; a.K = K; a.activ = activ; a.train = 0;
  a.out = out;
  return launch_composite(a, s);
}
