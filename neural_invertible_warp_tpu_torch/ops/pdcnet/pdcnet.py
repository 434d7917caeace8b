"""PDC-Net dense matcher, inference only (port of
neural_invertible_warp_tpu/ops/pdcnet/pdcnet.py): the 'PDCNet' (megadepth)
configuration the reference uses for real-image pose initialisation
(utils/colmap_initialization/pdcnet_for_hloc.py:154-494; model built in
third_party/DenseMatching/model_selection.py:144-161).

Two-net coarse-to-fine architecture (GLU-Net layout, models/PDCNet/PDCNet.py):
  L-Net (256x256 input): level 4, the global GOCor at 16x16 -> residual
    mapping decoder -> flow4; level 3 (32x32), the local GOCor -> residual
    flow decoder + adaptive-resolution PWC refinement -> flow3.
  H-Net (original resolution): levels 2 (1/8) and 1 (1/4), the local GOCor
    -> residual flow decoders, upfeat from level 2, final PWC refinement.
Each level also carries a mixture-density uncertainty estimate, combined at
inference into the confidence P_R of a Laplace mixture.

Every local level runs the local GOCor (three iterations of two
correlations and one adjoint, then one correlation with the query) and one
plain local correlation for the uncertainty decoder: on CUDA tensors 8 K7
launches and 3 launches of its adjoint kernel per level, 24 and 9 per image
pair.

``PDCNet`` carries the reference's ``state_dict`` names, so the reference
checkpoint loads into it (``convert.load_pdcnet_checkpoint``); a fresh one is
initialised from an explicit generator with the JAX package's distributions
(``init_pdcnet_params``), not its bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from ..cuda import correlation as corr_ops
from . import blocks as B
from . import layers as L
from .gocor import GlobalGOCor, LocalGOCor
from .vgg import VGGPyramid, vgg_eighth

MD = 4                       # local search radius -> 9x9 windows
VAR_1 = 1.0
VAR_2_MINUS = 2.0
VAR_2_PLUS = 520.0 ** 2
VAR_2_PLUS_256 = 256.0 ** 2


class GlobalCorrelation(nn.Module):
    """Holds the global GOCor as ``corr_module`` (the reference's
    ``corr.corr_module.*`` names)."""

    def __init__(self, generator):
        super().__init__()
        self.corr_module = GlobalGOCor(generator)


class PDCNet(nn.Module):
    """PDC-Net at its published widths: VGG-16 pyramid, 512-channel global
    GOCor at 16x16, three local levels. Inference only: BatchNorm uses its
    running statistics and no parameter takes a gradient."""

    def __init__(self, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        corr_dim = (2 * MD + 1) ** 2
        self.pyramid = VGGPyramid(g)
        self.corr = GlobalCorrelation(g)
        self.local_corr = LocalGOCor()
        # level 4 (16x16 global)
        self.decoder4 = B.ResidualDecoder(16 * 16 + 2, g, "final")
        self.deconv4 = L.deconv(2, 2)
        self.corr_uncertainty_decoder4 = B.MdnFromCorr(16, g)
        self.uncertainty_decoder4 = B.MdnFromFlow(6 + 32, g)
        # level 3 (32x32 local)
        self.decoder3 = B.ResidualDecoder(corr_dim + 4 + 2, g, "predict_flow")
        self.corr_uncertainty_decoder3 = B.MdnFromCorr(9, g)
        self.uncertainty_decoder3 = B.MdnFromFlow(6 + 32 + 2 + 4, g)
        for i, m in enumerate(B.refinement_convs(32 + 2, g), 1):
            setattr(self, "dc_conv{}".format(i), m)
        # level 2 (1/8)
        self.decoder2 = B.ResidualDecoder(corr_dim + 4 + 2, g, "predict_flow")
        self.corr_uncertainty_decoder2 = B.MdnFromCorr(9, g)
        self.uncertainty_decoder2 = B.MdnFromFlow(6 + 32 + 2 + 4, g)
        self.upfeat2 = L.deconv(32, 2, g)
        self.deconv2 = L.deconv(2, 2)
        # level 1 (1/4)
        self.decoder1 = B.ResidualDecoder(corr_dim + 4 + 2 + 2, g, "predict_flow")
        self.corr_uncertainty_decoder1 = B.MdnFromCorr(9, g)
        self.uncertainty_decoder1 = B.MdnFromFlow(6 + 32 + 2 + 4, g)
        for i, m in enumerate(B.refinement_convs(32 + 2, g), 1):
            setattr(self, "l_dc_conv{}".format(i), m)
        self.requires_grad_(False)
        self.eval()

    def refinement_convs(self, prefix):
        return [getattr(self, "{}{}".format(prefix, i)) for i in range(1, 8)]


def _global_corr(net, c14, c24):
    """get_global_correlation with GOCor + normalize='leakyrelu'
    (base_matching_net.py:829-878)."""
    return L.lrelu(net.corr.corr_module(L.l2norm_channel(c14), L.l2norm_channel(c24)))


def _plain_global_corr(c_t, c_s):
    """use_global_corr_layer (base_pdcnet.py:84-103): the plain feature
    correlation of L2-normed features, relu + L2 norm over channels; source
    positions in the channel dim."""
    b, d, H, W = c_t.shape
    tn = L.l2norm_channel(c_t).reshape(b, d, H * W)
    sn = L.l2norm_channel(c_s).reshape(b, d, H * W)
    corr = torch.matmul(sn.transpose(1, 2), tn).reshape(b, H * W, H, W)
    return L.l2norm_channel(torch.relu(corr))


def _uncertainty_at_level(net, lvl, corr_for_unc, x_layer, up_flow, up_unc, var_max):
    """estimate_uncertainty_components + the variance constraint of one
    level: (log_var_map [b,2,h,w], weight_map [b,2,h,w])."""
    corr_unc = getattr(net, "corr_uncertainty_decoder" + lvl)(corr_for_unc)
    if up_flow is None:
        inp = torch.cat([corr_unc, x_layer], dim=1)
    else:
        inp = torch.cat([corr_unc, x_layer, up_unc, up_flow], dim=1)
    large_log_var, weight = getattr(net, "uncertainty_decoder" + lvl)(inp)
    large_log_var = B.constrain_large_log_var_map(VAR_2_MINUS, var_max, large_log_var)
    small = torch.full_like(large_log_var, math.log(VAR_1))
    return torch.cat([small, large_log_var], dim=1), weight


def _upsampled_uncertainty(log_var, weight, hw):
    up_lv = L.interp_bilinear(log_var[:, 1:2], hw)
    up_lv = torch.cat([torch.full_like(up_lv, math.log(VAR_1)), up_lv], dim=1)
    return torch.cat([up_lv, L.interp_bilinear(weight, hw)], dim=1)


def _scaled(flow, sx, sy):
    return torch.stack([flow[:, 0] * sx, flow[:, 1] * sy], dim=1)


def _flow_level(net, lvl, c_t, c_s, up_flow, up_unc, ratio, var_max, up_feat=None,
                refine=None):
    c_s_warped = L.warp(c_s, _scaled(up_flow, ratio, ratio))
    corr = L.lrelu(net.local_corr(c_t, c_s_warped))
    pieces = [corr, up_flow] + ([up_feat] if up_feat is not None else []) + [up_unc]
    x, res_flow = getattr(net, "decoder" + lvl)(torch.cat(pieces, dim=1))
    x_ = torch.zeros_like(x)
    if refine is not None:
        x_, res_flow_ = B.refinement(net.refinement_convs(refine),
                                     torch.cat([x, res_flow + up_flow], dim=1))
        res_flow = res_flow + res_flow_
    flow = res_flow + up_flow
    # use_local_corr_layer: the PWC-style local correlation + leaky relu
    corr_unc_in = L.lrelu(corr_ops.local_correlation(c_t, c_s_warped, MD))
    log_var, weight = _uncertainty_at_level(net, lvl, corr_unc_in, x_ + x, up_flow, up_unc,
                                            var_max)
    return x, flow, log_var, weight


def pdcnet_forward(net, im_target, im_source, im_target_256, im_source_256):
    """The two-net forward (PDCNet.py:481-657). Images imagenet-normalised,
    NCHW; original-resolution H, W divisible by 8. Returns (output_256,
    output) dicts with the flow and (log_var, weight) of each level."""
    b, _, h_original, w_original = im_target.shape
    h_256, w_256 = im_target_256.shape[-2:]

    c11, c12 = vgg_eighth(net.pyramid, im_target)[-2:]
    c21, c22 = vgg_eighth(net.pyramid, im_source)[-2:]
    c13, c14 = net.pyramid(im_target_256)[-2:]
    c23, c24 = net.pyramid(im_source_256)[-2:]

    # ---------------- level 4 (global, 16x16)
    corr4 = _global_corr(net, c14, c24)
    init_map = corr4.new_zeros(b, 2, corr4.shape[2], corr4.shape[3])
    x4, est_map4 = net.decoder4(torch.cat([corr4, init_map], dim=1))
    flow4 = L.unnormalise_and_convert_mapping_to_flow(est_map4)
    flow4 = _scaled(flow4, float(w_256) / 16.0, float(h_256) / 16.0)
    log_var4, weight4 = _uncertainty_at_level(net, "4", _plain_global_corr(c14, c24), x4,
                                              None, None, VAR_2_PLUS_256)
    up_flow4 = net.deconv4(flow4)                                   # -> 32x32
    up_unc4 = _upsampled_uncertainty(log_var4, weight4, (32, 32))

    # ---------------- level 3 (local, 32x32)
    x3, flow3, log_var3, weight3 = _flow_level(
        net, "3", c13, c23, up_flow4, up_unc4, 32.0 / float(w_256), VAR_2_PLUS_256,
        refine="dc_conv")

    # ---------------- upscale to H-Net (1/8 of original)
    h8, w8 = h_original // 8, w_original // 8
    up_flow3 = _scaled(L.interp_bilinear(flow3, (h8, w8)), float(w_original) / float(w_256),
                       float(h_original) / float(h_256))
    up_unc3 = _upsampled_uncertainty(log_var3, weight3, (h8, w8))

    # ---------------- level 2 (local, 1/8)
    x2, flow2, log_var2, weight2 = _flow_level(
        net, "2", c12, c22, up_flow3, up_unc3, 1.0 / 8.0, VAR_2_PLUS)
    up_flow2 = net.deconv2(flow2)
    up_feat2 = net.upfeat2(x2)
    up_unc2 = _upsampled_uncertainty(log_var2, weight2, (h_original // 4, w_original // 4))

    # ---------------- level 1 (local, 1/4)
    x1, flow1, log_var1, weight1 = _flow_level(
        net, "1", c11, c21, up_flow2, up_unc2, 1.0 / 4.0, VAR_2_PLUS, up_feat=up_feat2,
        refine="l_dc_conv")

    output_256 = dict(flow_estimates=[flow4, flow3],
                      uncertainty_estimates=[(log_var4, weight4), (log_var3, weight3)])
    output = dict(flow_estimates=[flow2, flow1],
                  uncertainty_estimates=[(log_var2, weight2), (log_var1, weight1)])
    return output_256, output


# ------------------------------------------------------------- inference

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def pre_process_data(source_img, target_img):
    """pre_process_image_pair_glunet (base_matching_net.py:75-145):
    [B,3,H,W] images in [0, 255] -> (src, tgt, src_256, tgt_256, rx, ry)."""
    b, _, h, w = target_img.shape
    h2 = 256 if h < 256 else int(math.floor(h / 8.0) * 8)
    w2 = 256 if w < 256 else int(math.floor(w / 8.0) * 8)
    mean = torch.as_tensor(IMAGENET_MEAN, device=target_img.device)[None, :, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=target_img.device)[None, :, None, None]

    def norm(x):
        return (x / 255.0 - mean) / std

    src = norm(L.interp_area(source_img, (h2, w2)))
    tgt = norm(L.interp_area(target_img, (h2, w2)))
    src256 = norm(L.interp_area(source_img, (256, 256)))
    tgt256 = norm(L.interp_area(target_img, (256, 256)))
    return src, tgt, src256, tgt256, float(w) / w2, float(h) / h2


def estimate_flow_and_confidence_map(net, source_img, target_img, scaling=0.25, R=1.0):
    """Direct single-pass inference (base_pdcnet.py:645-757): the flow
    (target -> source) [B,2,h,w] and the P_R confidence [B,1,h,w] at
    ``scaling`` x the target's resolution."""
    b, _, h, w = target_img.shape
    output_shape = (int(h * scaling), int(w * scaling))
    src, tgt, src256, tgt256, rx, ry = pre_process_data(source_img, target_img)
    rx *= float(output_shape[1]) / float(w)
    ry *= float(output_shape[0]) / float(h)
    _, output = pdcnet_forward(net, tgt, src, tgt256, src256)
    flow = _scaled(L.interp_bilinear(output["flow_estimates"][-1], output_shape), rx, ry)
    log_var, weight = output["uncertainty_estimates"][-1]
    p_r = B.estimate_probability_of_confidence_interval_of_mixture_density(
        L.interp_bilinear(weight, output_shape), L.interp_bilinear(log_var, output_shape),
        R=R, gaussian=False)
    return flow, p_r


def matches_from_flow_and_confidence(flow, p_r, target_hw, min_confidence,
                                     min_number_of_pts=0):
    """get_matches_and_confidence (base_pdcnet.py:518-570): mask
    proba_interval_1_above_X, discard mappings outside the source, rescale
    the keypoints to the original resolution, sort by confidence. Takes the
    first image of the batch; returns numpy (kp_source, kp_target, conf)."""
    if torch.is_tensor(flow):
        flow, p_r = flow.detach().cpu().numpy(), p_r.detach().cpu().numpy()
    fl = np.asarray(flow)[0]                                # [2,h,w]
    pr = np.asarray(p_r)[0, 0]
    h, w = pr.shape
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    map_x = xx + fl[0]
    map_y = yy + fl[1]
    mask = (pr >= min_confidence) & (map_x >= 0) & (map_y >= 0) & \
        (map_x <= w - 1) & (map_y <= h - 1)
    scale_y = float(target_hw[0]) / h
    scale_x = float(target_hw[1]) / w
    kp_t = np.stack([xx[mask] * scale_x, yy[mask] * scale_y], axis=-1)
    kp_s = np.stack([map_x[mask] * scale_x, map_y[mask] * scale_y], axis=-1)
    conf = pr[mask]
    order = np.argsort(-conf)
    kp_s, kp_t, conf = kp_s[order], kp_t[order], conf[order]
    if len(kp_s) < min_number_of_pts:
        return (np.empty((0, 2), np.float32), np.empty((0, 2), np.float32),
                np.empty((0,), np.float32))
    return kp_s.astype(np.float32), kp_t.astype(np.float32), conf.astype(np.float32)
