// K2: one-call train render of the NeRF field: forward, in-kernel MSE
// cotangent and backward.
//
// Replaces neural_invertible_warp_tpu/ops/pallas/fused_pe.py::
// _rm_train_pe_kernel (wrapper fused_render_rays_pe_train). Outputs the
// per-ray [R,8] render, d(sq_sum)/d(center, ray) [R,3] each and the 20
// packed weight gradients, where sq_sum = sum_rays valid * |rgb_final -
// target|^2. The `noise` and `want_prob` operands of the TPU kernel are not
// ported yet. Bound and design: see nerf_field.cuh. Weight gradients use
// per-split partial sums and a fixed-order second pass (no atomics).
#include "nerf_field.cuh"

using namespace niw;

static long long cache_floats(long long N) {
  return N * (LD_C4 + 6 * D_HID + LD_V + D_HEAD);
}
static long long grad_floats(long long N) {
  return N * (D_HEAD + 4 + 1 + LD_V + 2 * D_HID + LD_C4);
}
static const long long PART_PER_SPLIT = 320 * 288;   // >= every Kin * Nout

extern "C" long long niw_rm_train_workspace_floats(long long N, int R) {
  const Splits sp = plan_splits((int)N);
  return cache_floats(N) + grad_floats(N) + sp.n * PART_PER_SPLIT + 3LL * R;
}

// out (+)= G @ W^T for W [n_out, ldw] row-major, zeroed where mask <= 0 on
// columns < mask_cols (the ReLU derivative of the layer's input).
static int grad_in(const float* G, int ldg, const float* Wt, int ldw, float* out, int ldo,
                   int N, int n_out, int k, const float* mask, int ldm, int mask_cols,
                   int beta, cudaStream_t s) {
  GemmArgs p = gemm_args(G, ldg, Wt, ldw, out, ldo, N, n_out, k);
  p.mask = mask; p.ldm = ldm; p.mask_cols = mask_cols; p.beta = beta;
  return launch_gemm<false, true>(p, 1, s);
}

// center, ray [R,3]; depth [R,K]; target8 [R,8] (rgb, valid flag, 0...);
// w3 [10], wv [4]; W / dW: the 20 packed weights and their gradients;
// activ 0 softplus, 1 relu; has_bg / bg: setbg_opaque background.
extern "C" int niw_rm_train(const float* center, const float* ray, const float* depth,
                            const float* target8, int R, int K, const float* w3,
                            const float* wv, const float* const* W, int activ,
                            int has_bg, float bg, float* out, float* dcenter,
                            float* dray, float* const* dW, float* ws, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long N = (long long)R * K;
  const int n = (int)N;
  Cache c;
  float* p = ws;
  c.C4 = p; p += N * LD_C4;
  c.H0 = p; p += N * D_HID;
  c.H1 = p; p += N * D_HID;
  c.H2 = p; p += N * D_HID;
  c.H4 = p; p += N * D_HID;
  c.H5 = p; p += N * D_HID;
  c.H6 = p; p += N * D_HID;
  c.V = p; p += N * LD_V;
  c.R0 = p; p += N * D_HEAD;
  float* GR0 = p; p += N * D_HEAD;
  float* GRP = p; p += N * 4;
  float* GDENS = p; p += N;
  float* GV = p; p += N * LD_V;
  float* GA = p; p += N * D_HID;
  float* GB = p; p += N * D_HID;
  float* GC4 = p; p += N * LD_C4;
  float* part = p; p += plan_splits(n).n * PART_PER_SPLIT;
  float* DRQ = p;

  NIW_LAUNCH(encode_kernel<<<(unsigned)((N + 127) / 128), 128, 0, s>>>(
      center, ray, depth, R, K, w3, wv, c.C4, c.V));
  int err = mlp_forward(W, c, n, s);
  if (err) return err;
  CompositeArgs a = {};
  a.ray = ray; a.depth = depth; a.R0 = c.R0; a.V = c.V;
  a.Wr1 = W[WR1]; a.br1 = W[BR1]; a.target8 = target8;
  a.R = R; a.K = K; a.activ = activ; a.train = 1; a.has_bg = has_bg;
  a.bg = has_bg ? bg : 0.f;
  a.out = out; a.GR0 = GR0; a.GRP = GRP; a.GDENS = GDENS; a.dray_quad = DRQ;
  if ((err = launch_composite(a, s))) return err;

  // rgb head
  if ((err = weight_grad(c.R0, D_HEAD, D_HEAD, GRP, 4, 3, n, dW[WR1], dW[BR1], part, s))) return err;
  if ((err = weight_grad(c.V, LD_V, K_WR0, GR0, D_HEAD, D_HEAD, n, dW[WR0], dW[BR0], part, s))) return err;
  if ((err = grad_in(GR0, D_HEAD, W[WR0], D_HEAD, GV, LD_V, n, K_WR0, D_HEAD,
                     c.V, LD_V, D_HID, 0, s))) return err;
  NIW_LAUNCH(set_column_kernel<<<(unsigned)((N + 255) / 256), 256, 0, s>>>(
      GV, LD_V, COL_DENS, GDENS, N));
  // trunk, top down
  if ((err = weight_grad(c.H6, D_HID, D_HID, GV, LD_V, N_W7, n, dW[W7], dW[B7], part, s))) return err;
  if ((err = grad_in(GV, LD_V, W[W7], N_W7, GA, D_HID, n, D_HID, N_W7, c.H6, D_HID, D_HID, 0, s))) return err;
  if ((err = weight_grad(c.H5, D_HID, D_HID, GA, D_HID, D_HID, n, dW[W6], dW[B6], part, s))) return err;
  if ((err = grad_in(GA, D_HID, W[W6], D_HID, GB, D_HID, n, D_HID, D_HID, c.H5, D_HID, D_HID, 0, s))) return err;
  if ((err = weight_grad(c.H4, D_HID, D_HID, GB, D_HID, D_HID, n, dW[W5], dW[B5], part, s))) return err;
  if ((err = grad_in(GB, D_HID, W[W5], D_HID, GA, D_HID, n, D_HID, D_HID, c.H4, D_HID, D_HID, 0, s))) return err;
  // skip layer: [h3, xp]
  if ((err = weight_grad(c.C4, LD_C4, D_HID + D_X, GA, D_HID, D_HID, n, dW[W4], dW[B4], part, s))) return err;
  if ((err = grad_in(GA, D_HID, W[W4], D_HID, GC4, LD_C4, n, D_HID + D_X, D_HID,
                     c.C4, LD_C4, D_HID, 0, s))) return err;
  if ((err = weight_grad(c.H2, D_HID, D_HID, GC4, LD_C4, D_HID, n, dW[W3], dW[B3], part, s))) return err;
  if ((err = grad_in(GC4, LD_C4, W[W3], D_HID, GB, D_HID, n, D_HID, D_HID, c.H2, D_HID, D_HID, 0, s))) return err;
  if ((err = weight_grad(c.H1, D_HID, D_HID, GB, D_HID, D_HID, n, dW[W2], dW[B2], part, s))) return err;
  if ((err = grad_in(GB, D_HID, W[W2], D_HID, GA, D_HID, n, D_HID, D_HID, c.H1, D_HID, D_HID, 0, s))) return err;
  if ((err = weight_grad(c.H0, D_HID, D_HID, GA, D_HID, D_HID, n, dW[W1], dW[B1], part, s))) return err;
  if ((err = grad_in(GA, D_HID, W[W1], D_HID, GB, D_HID, n, D_HID, D_HID, c.H0, D_HID, D_HID, 0, s))) return err;
  if ((err = weight_grad(c.C4 + COL_XP, LD_C4, D_X, GB, D_HID, D_HID, n, dW[W0], dW[B0], part, s))) return err;
  // dxp = skip-path part (already in GC4[:, 256:319]) + layer-0 part
  if ((err = grad_in(GB, D_HID, W[W0], D_HID, GC4 + COL_XP, LD_C4, n, D_X, D_HID,
                     nullptr, 0, 0, 1, s))) return err;
  const size_t smem = sizeof(float) * (size_t)K * (6 + D_V);
  NIW_LAUNCH(input_backward_kernel<<<R, ((K + 31) / 32) * 32, smem, s>>>(
      center, ray, depth, K, w3, wv, GC4, GV, DRQ, dcenter, dray));
  return 0;
}
