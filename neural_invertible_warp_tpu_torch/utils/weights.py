"""Weight bridge between the JAX package's parameter pytrees and the port's
``nn.Module`` state_dicts.

``from_jax_params(tree)`` maps a JAX params dict (top-level groups ``nerf``,
``warp_mlp``, ``warp_latent``) of numpy arrays to a state_dict keyed as the
reference torch Graph (``nerf.mlp_feat.i.weight``,
``warp_mlp.lin{b}_a_{l}.weight_v``, ``warp_latent.weight``, ...);
``to_jax_params(module)`` is its inverse and returns numpy arrays. JAX
stores linear weights [in, out], torch [out, in].
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _np(t):
    return t.detach().cpu().numpy().astype(np.float32)


def _ident(p):
    return p


def nerf_from_jax(tree, prefix=""):
    sd = {}
    for name, layers in (("mlp_feat", tree["feat"]), ("mlp_rgb", tree["rgb"])):
        for i, layer in enumerate(layers):
            sd["{}{}.{}.weight".format(prefix, name, i)] = _t(np.asarray(layer["w"]).T)
            sd["{}{}.{}.bias".format(prefix, name, i)] = _t(layer["b"])
    return sd


def nerf_to_jax(mlp, get=_ident):
    return dict(
        feat=[dict(w=_np(get(l.weight)).T, b=_np(get(l.bias)))
              for l in mlp.mlp_feat],
        rgb=[dict(w=_np(get(l.weight)).T, b=_np(get(l.bias)))
             for l in mlp.mlp_rgb])


def _layer_from_jax(layer, name, sd):
    if "v" in layer:
        sd[name + ".weight_v"] = _t(np.asarray(layer["v"]).T)
        sd[name + ".weight_g"] = _t(np.asarray(layer["g"]).reshape(-1, 1))
    else:
        sd[name + ".weight"] = _t(np.asarray(layer["w"]).T)
    sd[name + ".bias"] = _t(layer["b"])


def _layer_to_jax(mod, get):
    if hasattr(mod, "weight_v"):
        return dict(v=_np(get(mod.weight_v)).T,
                    g=_np(get(mod.weight_g)).reshape(-1), b=_np(get(mod.bias)))
    return dict(w=_np(get(mod.weight)).T, b=_np(get(mod.bias)))


def deform_from_jax(tree, prefix=""):
    sd = {}
    for b, block in enumerate(tree["blocks"]):
        for branch in ("a", "b"):
            for l, layer in enumerate(block[branch]):
                _layer_from_jax(layer, "{}lin{}_{}_{}".format(prefix, b, branch, l), sd)
        _layer_from_jax(block["c"], "{}lin{}_c".format(prefix, b), sd)
    return sd


def deform_to_jax(net, get=_ident):
    blocks = []
    for b in range(net.n_blocks):
        block = {}
        for branch, n_hidden in (("a", net.n_layers), ("b", 1)):
            block[branch] = [
                _layer_to_jax(getattr(net, "lin{}_{}_{}".format(b, branch, l)), get)
                for l in range(n_hidden + 1)]
        block["c"] = _layer_to_jax(getattr(net, "lin{}_c".format(b)), get)
        blocks.append(block)
    return dict(blocks=blocks)


def from_jax_params(tree):
    """JAX params dict of numpy arrays -> reference-named state_dict."""
    sd = {}
    if "nerf" in tree:
        sd.update(nerf_from_jax(tree["nerf"], prefix="nerf."))
    if "warp_mlp" in tree:
        sd.update(deform_from_jax(tree["warp_mlp"], prefix="warp_mlp."))
    if "warp_latent" in tree:
        sd["warp_latent.weight"] = _t(tree["warp_latent"])
    return sd


def to_jax_params(module, get=_ident):
    """The port's Graph module (children nerf, warp_mlp, warp_latent) ->
    JAX params dict of numpy arrays. ``get`` maps each parameter to the
    tensor to export (the parameter itself by default; the checkpoint uses
    it to export Adam moments in the same layout)."""
    tree = {}
    if hasattr(module, "nerf"):
        tree["nerf"] = nerf_to_jax(module.nerf, get)
    if hasattr(module, "warp_mlp"):
        tree["warp_mlp"] = deform_to_jax(module.warp_mlp, get)
    if hasattr(module, "warp_latent"):
        tree["warp_latent"] = _np(get(module.warp_latent.weight))
    return tree
