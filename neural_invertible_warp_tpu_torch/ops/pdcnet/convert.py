"""Weights into the port's PDC-Net (port of
neural_invertible_warp_tpu/ops/pdcnet/convert.py, which maps the same
reference checkpoint into the JAX package's parameter pytree).

``PDCNet`` carries the reference's ``state_dict`` names, so the reference
``PDCNet_megadepth.pth.tar`` loads as it is (``load_pdcnet_checkpoint``).
``from_jax_params`` fills the module from the JAX package's pytree, given as
numpy arrays: the weight bridge of the parity tests.
"""

from __future__ import annotations

import numpy as np
import torch

from .pdcnet import PDCNet


def load_reference_state_dict(net, sd):
    """Load a reference-layout state_dict into ``net``. Reads the keys the
    port's modules have, as the JAX converter does, and ignores others; a
    tensor whose size matches but whose shape differs (the GOCor bin
    predictors) is reshaped to the module's; a missing
    ``num_batches_tracked`` keeps the module's. Raises on a missing key."""
    own = net.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError("the checkpoint lacks {} of PDC-Net's tensors: {}".format(
            len(missing), missing[:8]))
    out = {}
    for k, mine in own.items():
        v = torch.tensor(np.array(sd[k])) if k in sd else mine
        if v.numel() != mine.numel():
            raise ValueError("{}: {} values, the module has {}".format(
                k, v.numel(), mine.numel()))
        out[k] = v.reshape(mine.shape).to(mine.dtype)
    net.load_state_dict(out, strict=True)
    return net


def load_pdcnet_checkpoint(path):
    """PDCNet_megadepth.pth.tar (a torch checkpoint) -> PDCNet on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    return load_reference_state_dict(PDCNet(), sd)


# ------------------------------------------------------------ JAX pytree

def _conv(sd, name, p):
    sd[name + ".0.weight"] = p["w"]
    if "b" in p:
        sd[name + ".0.bias"] = p["b"]
    if "bn" in p:
        bn = p["bn"]
        sd[name + ".1.weight"], sd[name + ".1.bias"] = bn["scale"], bn["bias"]
        sd[name + ".1.running_mean"], sd[name + ".1.running_var"] = bn["mean"], bn["var"]


def _plain(sd, name, p):
    sd[name + ".weight"], sd[name + ".bias"] = p["w"], p["b"]


def _residual_decoder(sd, name, final_name, p):
    for k in ("conv_0", "conv0_skip", "conv_1", "conv_2", "conv2_skip", "conv_3", "conv_4"):
        _conv(sd, "{}.{}".format(name, k), p[k])
    _plain(sd, "{}.{}".format(name, final_name), p["final"])


def _refinement(sd, prefix, p):
    for i in range(1, 7):
        _conv(sd, "{}{}".format(prefix, i), p["dc_conv{}".format(i)])
    _plain(sd, prefix + "7", p["dc_conv7"])


def _mdn_corr(sd, name, p):
    for k in ("conv_0", "conv_1", "conv_2"):
        _conv(sd, "{}.{}".format(name, k), p[k])
    _plain(sd, name + ".predict_uncertainty", p["predict"])


def _mdn_flow(sd, name, p):
    for k in ("conv_0", "conv_1"):
        _conv(sd, "{}.{}".format(name, k), p[k])
    _plain(sd, name + ".predict_uncertainty_final", p["predict"])


def _gocor_optimizer(sd, opt, p):
    sd[opt + "log_step_length"], sd[opt + "filter_reg"] = p["log_step_length"], p["filter_reg"]
    sd[opt + "label_map_predictor.weight"] = p["label_map_w"]
    sd[opt + "spatial_weight_predictor.weight"] = p["spatial_weight_w"]
    sd[opt + "target_mask_predictor.0.weight"] = p["target_mask_w"]


def state_dict_from_jax_params(tree):
    """The JAX package's PDC-Net pytree (arrays) -> a reference-layout
    state_dict of numpy arrays (the inverse of its ``pdcnet_params_from_torch``)."""
    sd = {}
    conv_ids = [[0], [0], [0, 2], [0, 2, 4], [0, 2, 4]]
    for lvl, ids in enumerate(conv_ids):
        for ci, p in zip(ids, tree["pyramid"][lvl]):
            _plain(sd, "pyramid.level_{}.{}".format(lvl, ci), p)
    g, glob = "corr.corr_module.", tree["global_gocor"]
    sd[g + "filter_initializer.target_fg"] = glob["target_fg"]
    sd[g + "filter_initializer.target_bg"] = glob["target_bg"]
    _gocor_optimizer(sd, g + "filter_optimizer.", glob)
    sd[g + "filter_optimizer.reg_layer.weight1"] = glob["reg_layer"]["weight1"]
    sd[g + "filter_optimizer.reg_layer.weight2"] = glob["reg_layer"]["weight2"]
    loc = tree["local_gocor"]
    sd["local_corr.filter_initializer.scaling"] = loc["scaling"]
    _gocor_optimizer(sd, "local_corr.filter_optimizer.", loc)
    _residual_decoder(sd, "decoder4", "final", tree["decoder4"])
    for lvl in "321":
        _residual_decoder(sd, "decoder" + lvl, "predict_flow", tree["decoder" + lvl])
    for lvl in "4321":
        _mdn_corr(sd, "corr_uncertainty_decoder" + lvl, tree["corr_uncertainty_decoder" + lvl])
        _mdn_flow(sd, "uncertainty_decoder" + lvl, tree["uncertainty_decoder" + lvl])
    for name in ("deconv4", "deconv2", "upfeat2"):
        _plain(sd, name, tree[name])
    _refinement(sd, "dc_conv", tree["refinement_adaptive"])
    _refinement(sd, "l_dc_conv", tree["refinement_final"])
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def from_jax_params(tree, net=None):
    """Fill ``net`` (a new PDCNet if None) from the JAX package's pytree."""
    return load_reference_state_dict(net if net is not None else PDCNet(),
                                     state_dict_from_jax_params(tree))
