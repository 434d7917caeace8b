"""GOCor correlation modules of PDC-Net (port of
neural_invertible_warp_tpu/ops/pdcnet/gocor.py; reference
third_party/DenseMatching/third_party/GOCor/GOCor/{global_gocor,
global_corr_initializer,local_gocor,distance,activation,fourdim}.py).

GOCor refines a per-position filter map, initialised from the reference
features, by ``num_iter`` steepest-descent steps on a learned robust
objective, then correlates it with the query features. filter_size 1
throughout (the only case the reference supports).

The global module (16x16 positions, 512 channels) is plain PyTorch: its
filter applications are batched matrix products. The local module's
correlations and its filter gradient, the adjoint of the correlation in the
filter map (the reference's ``FunctionCorrelationTranspose``), are K7 and its
adjoint kernel on CUDA tensors (``ops/cuda/correlation.py``); nothing here
builds an autograd graph. Parameters carry the reference's ``state_dict``
names (``filter_initializer.*``, ``filter_optimizer.*``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..cuda import correlation as corr_ops


# ----------------------------------------------------------- distance map

def distance_bins(center_yx, out_hw, num_bins, bin_displacement, like):
    """Soft histogram of the euclidean distance from center, per pixel
    (GOCor/distance.py): triangular bins, the last one clamped. -> [bins,H,W]
    of ``like``'s dtype and device."""
    kw = dict(dtype=like.dtype, device=like.device)
    k0 = torch.arange(out_hw[0], **kw)[:, None]
    k1 = torch.arange(out_hw[1], **kw)[None, :]
    d0 = k0 - center_yx[0]
    d1 = k1 - center_yx[1]
    dist = torch.sqrt(d0 * d0 + d1 * d1)
    bc = torch.arange(num_bins, **kw)[:, None, None]
    bin_diff = dist[None] / bin_displacement - bc
    main = torch.relu(1.0 - torch.abs(bin_diff[:-1]))
    last = torch.clamp(1.0 + bin_diff[-1:], 0.0, 1.0)
    return torch.cat([main, last], dim=0)


def apply_bin_weights(conv, bins):
    """The 1x1 conv [1,bins,1,1] over the bin axis -> [H,W]."""
    return torch.einsum("b,bhw->hw", conv.weight.reshape(-1), bins)


def leaky_relu_par(x, a):
    return (1.0 - a) / 2.0 * torch.abs(x) + (1.0 + a) / 2.0 * x


def leaky_relu_par_deriv(x, a):
    return (1.0 - a) / 2.0 * torch.sign(x) + (1.0 + a) / 2.0


def _bin_predictor(weights):
    conv = nn.Conv2d(len(weights), 1, 1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(weights, dtype=torch.float32).reshape(1, -1, 1, 1))
    return conv


class FilterOptimizerParams(nn.Module):
    """The learned objective's parameters shared by both GOCor optimisers:
    step length, filter regularisation, and the distance-bin predictors of
    the label map, the spatial weight and the target mask."""

    def __init__(self, num_dist_bins=10, init_gauss_sigma=1.0, v_minus_init_factor=4.0,
                 init_step_length=1.0, init_filter_reg=1e-2):
        super().__init__()
        d = np.arange(num_dist_bins, dtype=np.float32) * 0.5          # bin_displacement
        init_gauss = np.exp(-0.5 * (d / init_gauss_sigma) ** 2)
        self.log_step_length = nn.Parameter(torch.full((1,), math.log(init_step_length)))
        self.filter_reg = nn.Parameter(torch.full((1,), init_filter_reg))
        self.label_map_predictor = _bin_predictor(init_gauss - init_gauss.min())
        self.spatial_weight_predictor = _bin_predictor(np.ones(num_dist_bins, np.float32))
        self.target_mask_predictor = nn.Sequential(
            _bin_predictor(v_minus_init_factor * np.tanh(2.0 - d)), nn.Sigmoid())


# ----------------------------------------------------------- 4D regularizer

class SeparableConv4d(nn.Module):
    """GOCor/fourdim.py, permute_back_output=False as PDC-Net uses it."""

    def __init__(self, generator, kernel_size=3, inter_dim=16, output_dim=16):
        super().__init__()
        self.weight1 = nn.Parameter(torch.randn(inter_dim, 1, kernel_size, kernel_size,
                                                generator=generator) * 1e-3)
        self.weight2 = nn.Parameter(torch.randn(output_dim, inter_dim, kernel_size,
                                                kernel_size, generator=generator) * 1e-3)

    def forward(self, x):
        """[b, H2, W2, H1, W1] -> [b, H1, W1, out_dim, H2, W2]."""
        b, H2, W2, H1, W1 = x.shape
        inter, out_dim = self.weight1.shape[0], self.weight2.shape[0]
        x2 = F.conv2d(x.reshape(-1, 1, H1, W1), self.weight1, padding=1)
        x2 = x2.reshape(b, H2 * W2, inter, H1 * W1).permute(0, 3, 2, 1)
        x3 = F.conv2d(x2.reshape(-1, inter, H2, W2), self.weight2, padding=1)
        return x3.reshape(b, H1, W1, out_dim, H2, W2)

    def transpose(self, x):
        """The adjoint: [b, H1, W1, out_dim, H2, W2] -> [b, H2, W2, H1, W1]."""
        b, H1, W1, out_dim, H2, W2 = x.shape
        inter = self.weight1.shape[0]
        x2 = F.conv_transpose2d(x.reshape(-1, out_dim, H2, W2), self.weight2, padding=1)
        x2 = x2.reshape(b, H1 * W1, inter, H2 * W2).permute(0, 3, 2, 1)
        x3 = F.conv_transpose2d(x2.reshape(-1, inter, H1, W1), self.weight1, padding=1)
        return x3.reshape(b, H2, W2, H1, W1)


# ----------------------------------------------------------- global GOCor

class GlobalInitializer(nn.Module):
    """GlobalCorrFlexibleContextAwareInitializer (filter_size 1)."""

    def __init__(self, num_features=512):
        super().__init__()
        self.target_fg = nn.Parameter(torch.ones(num_features))
        self.target_bg = nn.Parameter(torch.zeros(num_features))

    def forward(self, ref):
        """ref [b,d,H,W] -> filters [b,HW,d]."""
        b, d, H, W = ref.shape
        f = ref.reshape(b, d, H * W)
        bg = f.mean(dim=2, keepdim=True)
        ff = (f * f).sum(dim=1, keepdim=True)
        bb = (bg * bg).sum(dim=1, keepdim=True)
        fb = (f * bg).sum(dim=1, keepdim=True)
        den = torch.clamp(ff * bb - fb * fb, min=1e-6)
        tfg = self.target_fg[None, :, None]
        tbg = self.target_bg[None, :, None]
        fg_scale = tfg * bb - tbg * fb
        bg_scale = tfg * fb - tbg * ff
        return ((fg_scale * f - bg_scale * bg) / den).transpose(1, 2)


class GlobalOptimizer(FilterOptimizerParams):
    def __init__(self, generator, reg_inter_dim=16, reg_output_dim=16, **kw):
        super().__init__(**kw)
        self.reg_layer = SeparableConv4d(generator, 3, reg_inter_dim, reg_output_dim)


def _unfolded_map(values_2h1, H, W):
    """reference _unfold_map: from a (2H-1, 2W-1) center-anchored map, the
    (H,W) window aligned to each filter position p=(i,j):
    out[p, y, x] = full[H-1 + y - i, W-1 + x - j] -> [HW,H,W]."""
    dev = values_2h1.device
    i = torch.arange(H, device=dev)
    j = torch.arange(W, device=dev)
    r = (H - 1) + i[None, :, None, None] - i[:, None, None, None]     # (i, y, ., .)
    c = (W - 1) + j[None, None, None, :] - j[None, None, :, None]     # (., ., j, x)
    out = values_2h1[r, c]                                            # [H,H,W,W]
    return out.permute(0, 2, 1, 3).reshape(H * W, H, W)


class GlobalGOCor(nn.Module):
    """GlobalGOCor with the flexible context-aware initializer and the query
    loss (PDC-Net config: apply_query_loss, train_label_map False)."""

    def __init__(self, generator, num_features=512, num_iter=3, steplength_reg=0.1,
                 min_filter_reg=1e-5, num_dist_bins=10, bin_displacement=0.5):
        super().__init__()
        self.filter_initializer = GlobalInitializer(num_features)
        self.filter_optimizer = GlobalOptimizer(generator, num_dist_bins=num_dist_bins)
        self.num_iter, self.steplength_reg = num_iter, steplength_reg
        self.min_filter_reg = min_filter_reg
        self.num_dist_bins, self.bin_displacement = num_dist_bins, bin_displacement

    def forward(self, ref, query):
        """ref, query [b,d,H,W] (same H,W) -> scores [b, H*W, H, W], query
        positions in the channel dim."""
        b, d, H, W = ref.shape
        opt = self.filter_optimizer
        filt = self.filter_initializer(ref)                          # [b,HW,d]
        dist_hw = (2 * H - 1, 2 * W - 1)
        bins = distance_bins((dist_hw[0] // 2, dist_hw[1] // 2), dist_hw,
                             self.num_dist_bins, self.bin_displacement, ref)
        target_map = _unfolded_map(apply_bin_weights(opt.label_map_predictor, bins), H, W)[None]
        v_plus = _unfolded_map(apply_bin_weights(opt.spatial_weight_predictor, bins), H, W)[None]
        weight_m = _unfolded_map(torch.sigmoid(apply_bin_weights(
            opt.target_mask_predictor[0], bins)), H, W)[None]
        step_length = torch.exp(opt.log_step_length)
        reg_weight = torch.clamp(opt.filter_reg ** 2, min=self.min_filter_reg ** 2)
        ref_flat = ref.reshape(b, d, H * W)
        query_flat = query.reshape(b, d, H * W)

        def apply_filter(f, feat_flat):
            # [b,HW,d] @ [b,d,HW2] -> [b,HW,H,W]
            return torch.matmul(f, feat_flat).reshape(b, -1, H, W)

        def apply_feat_transpose(feat_flat, scores):
            # the adjoint of apply_filter in f
            return torch.matmul(scores.reshape(b, -1, H * W), feat_flat.transpose(1, 2))

        for _ in range(self.num_iter):
            scores_ref = apply_filter(filt, ref_flat)
            act = v_plus * leaky_relu_par(scores_ref, weight_m)
            dact = v_plus * leaky_relu_par_deriv(scores_ref, weight_m)
            mapped = dact * (act - v_plus * target_map)
            grad = apply_feat_transpose(ref_flat, mapped) + reg_weight * filt

            # query loss L_q
            scores_q = apply_filter(filt, query_flat)
            lq_res = opt.reg_layer(scores_q.reshape(b, H, W, H, W))
            reg_tp = opt.reg_layer.transpose(lq_res).reshape(scores_q.shape)
            grad = grad + apply_feat_transpose(query_flat, reg_tp)

            # step length (sums over all filters: apply_query_loss mode)
            den_res = dact * apply_filter(grad, ref_flat)
            alpha_den = (den_res ** 2).reshape(b, -1).sum(dim=1)
            den_q = opt.reg_layer(apply_filter(grad, query_flat).reshape(b, H, W, H, W))
            alpha_den = alpha_den + (den_q ** 2).reshape(b, -1).sum(dim=1)
            alpha_num = (grad ** 2).reshape(b, -1).sum(dim=1)
            alpha_den = torch.clamp(alpha_den + reg_weight[0] * alpha_num, min=1e-8)
            alpha_den = alpha_den + self.steplength_reg * alpha_num
            alpha = alpha_num / alpha_den                           # [b]
            filt = filt - (step_length[0] * alpha)[:, None, None] * grad

        scores = apply_filter(filt, query_flat)
        return scores.reshape(b, H * W, H * W).transpose(1, 2).reshape(b, H * W, H, W)


# ----------------------------------------------------------- local GOCor

class LocalInitializer(nn.Module):
    """SimpleInitializer of the local GOCor."""

    def __init__(self):
        super().__init__()
        self.scaling = nn.Parameter(torch.ones(1))


class LocalGOCor(nn.Module):
    """LocalGOCor with the simple initializer: ref, query [b,d,H,W] ->
    scores [b, search_size^2, H, W]."""

    def __init__(self, num_iter=3, search_size=9, min_filter_reg=1e-5, num_dist_bins=10,
                 bin_displacement=0.5):
        super().__init__()
        self.filter_initializer = LocalInitializer()
        self.filter_optimizer = FilterOptimizerParams(num_dist_bins=num_dist_bins)
        self.num_iter, self.search_size = num_iter, search_size
        self.min_filter_reg = min_filter_reg
        self.num_dist_bins, self.bin_displacement = num_dist_bins, bin_displacement

    def forward(self, ref, query):
        b, d, H, W = ref.shape
        md = self.search_size // 2
        opt = self.filter_optimizer
        filt = self.filter_initializer.scaling[0] * ref / (
            (ref * ref).mean(dim=1, keepdim=True) + 1e-6)
        bins = distance_bins((md, md), (self.search_size, self.search_size),
                             self.num_dist_bins, self.bin_displacement, ref)
        target_map = apply_bin_weights(opt.label_map_predictor, bins).reshape(1, -1, 1, 1)
        v_plus = apply_bin_weights(opt.spatial_weight_predictor, bins).reshape(1, -1, 1, 1)
        weight_m = torch.sigmoid(apply_bin_weights(
            opt.target_mask_predictor[0], bins)).reshape(1, -1, 1, 1)
        step_length = torch.exp(opt.log_step_length)
        reg_weight = torch.clamp(opt.filter_reg ** 2, min=self.min_filter_reg ** 2) / (d ** 2)

        for _ in range(self.num_iter):
            scores_ref = corr_ops.local_correlation(filt, ref, md)          # K7
            act = v_plus * leaky_relu_par(scores_ref, weight_m)
            dact = v_plus * leaky_relu_par_deriv(scores_ref, weight_m)
            mapped = dact * (act - v_plus * target_map)
            # FunctionCorrelationTranspose: the exact adjoint in the filter map
            grad = corr_ops.local_correlation_transpose(mapped, ref, md) + reg_weight * filt
            sg_ref = dact * corr_ops.local_correlation(grad, ref, md)      # K7
            alpha_den = (sg_ref * sg_ref).sum(dim=1, keepdim=True)
            alpha_num = (grad * grad).sum(dim=1, keepdim=True)
            alpha_den = torch.clamp(alpha_den + reg_weight * alpha_num, min=1e-8)
            filt = filt - step_length[0] * (alpha_num / alpha_den) * grad

        return corr_ops.local_correlation(filt, query, md)                 # K7
