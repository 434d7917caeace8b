"""Weight bridge between the JAX package's parameter pytrees and the port's
``nn.Module`` state_dicts.

``from_jax_params(tree)`` maps a JAX params dict (top-level groups ``nerf``,
``nerf_fine``, ``se3_refine``, ``warp_mlp``, ``warp_latent``,
``warp_embedding``) of numpy arrays to a state_dict keyed as the reference
torch Graph (``nerf.mlp_feat.i.weight``, ``se3_refine.weight``,
``warp_mlp.lin{b}_a_{l}.weight_v``, ``warp_latent.weight``, ...);
``to_jax_params(module)`` is its inverse and returns numpy arrays. JAX
stores linear weights [in, out], torch [out, in].

Two layouts live under each of two keys. ``nerf`` / ``nerf_fine`` is the
NeRF MLP (``{"feat": [...], "rgb": [...]}``) or the GARF field (the
reference's ``gaussian_linear_d``, ``pts_linears``, ... by name).
``warp_mlp`` is the INN warp (``{"blocks": [...]}``) or, in
``garf_se3_field``, a list of ``{w, b}`` layers (``warp_mlp.<i>.weight``).
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


def _linear_from_jax(layer, name, sd):
    sd[name + ".weight"] = _t(np.asarray(layer["w"]).T)
    sd[name + ".bias"] = _t(layer["b"])


def _linear_to_jax(lin, get):
    return dict(w=_np(get(lin.weight)).T, b=_np(get(lin.bias)))


def nerf_from_jax(tree, prefix=""):
    sd = {}
    if "pts_linears" in tree:       # the GARF field: its children by name
        groups = tree.items()
    else:
        groups = (("mlp_feat", tree["feat"]), ("mlp_rgb", tree["rgb"]))
    for name, value in groups:
        if isinstance(value, (list, tuple)):
            for i, layer in enumerate(value):
                _linear_from_jax(layer, "{}{}.{}".format(prefix, name, i), sd)
        else:
            _linear_from_jax(value, prefix + name, sd)
    return sd


def nerf_to_jax(mlp, get=_ident):
    if hasattr(mlp, "pts_linears"):
        tree = {}
        for name, child in mlp.named_children():
            if isinstance(child, torch.nn.ModuleList):
                tree[name] = [_linear_to_jax(lin, get) for lin in child]
            else:
                tree[name] = _linear_to_jax(child, get)
        return tree
    return dict(feat=[_linear_to_jax(l, get) for l in mlp.mlp_feat],
                rgb=[_linear_to_jax(l, get) for l in mlp.mlp_rgb])


def _layer_from_jax(layer, name, sd):
    if "v" in layer:
        sd[name + ".weight_v"] = _t(np.asarray(layer["v"]).T)
        sd[name + ".weight_g"] = _t(np.asarray(layer["g"]).reshape(-1, 1))
        sd[name + ".bias"] = _t(layer["b"])
    else:
        _linear_from_jax(layer, name, sd)


def _layer_to_jax(mod, get):
    if hasattr(mod, "weight_v"):
        return dict(v=_np(get(mod.weight_v)).T,
                    g=_np(get(mod.weight_g)).reshape(-1), b=_np(get(mod.bias)))
    return _linear_to_jax(mod, get)


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
    for name in ("nerf", "nerf_fine"):
        if name in tree:
            sd.update(nerf_from_jax(tree[name], prefix=name + "."))
    if isinstance(tree.get("warp_mlp"), (list, tuple)):     # garf_se3_field
        for i, layer in enumerate(tree["warp_mlp"]):
            _linear_from_jax(layer, "warp_mlp.{}".format(i), sd)
    elif "warp_mlp" in tree:
        sd.update(deform_from_jax(tree["warp_mlp"], prefix="warp_mlp."))
    for name in ("se3_refine", "warp_latent", "warp_embedding"):    # per-image tables
        if name in tree:
            sd[name + ".weight"] = _t(tree[name])
    return sd


def to_jax_params(module, get=_ident):
    """The port's Graph module (children nerf, nerf_fine, se3_refine,
    warp_mlp, warp_latent, warp_embedding) ->
    JAX params dict of numpy arrays. ``get`` maps each parameter to the
    tensor to export (the parameter itself by default; the checkpoint uses
    it to export Adam moments in the same layout)."""
    tree = {}
    for name in ("nerf", "nerf_fine"):
        if hasattr(module, name):
            tree[name] = nerf_to_jax(getattr(module, name), get)
    if isinstance(getattr(module, "warp_mlp", None), torch.nn.ModuleList):
        tree["warp_mlp"] = [_linear_to_jax(lin, get) for lin in module.warp_mlp]
    elif hasattr(module, "warp_mlp"):
        tree["warp_mlp"] = deform_to_jax(module.warp_mlp, get)
    for name in ("se3_refine", "warp_latent", "warp_embedding"):
        if hasattr(module, name):
            tree[name] = _np(get(getattr(module, name).weight))
    return tree
