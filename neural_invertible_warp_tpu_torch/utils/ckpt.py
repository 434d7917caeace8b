"""Checkpoints in the JAX package's layout (neural_invertible_warp_tpu/utils/ckpt.py):

    <output_path>/model.ckpt          (latest)
    <output_path>/model/<iter>.ckpt   (numbered snapshots)

each a pickled ``dict(iter, state)`` of numpy arrays, where ``state`` is the
JAX system's state tree: ``params`` (through the weight bridge), ``opt_state``
per label as optax's adam state ``((count, mu, nu), (count,))`` with mu and nu
raveled over the label's params in JAX leaf order (behind a gradient clip,
``((), adam state)``; behind a gradient gate, GARF's pose warmup, the chain
``((count,), ...)``), ``step`` and ``aux``.
The JAX package's ``restore_checkpoint`` loads it into its own state, and
``restore`` here loads a file written by either package into a port system.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from . import log
from .weights import from_jax_params, to_jax_params


def ravel_like_jax(tree):
    """Flatten a nested dict/list of arrays in jax.tree_util leaf order
    (dict keys sorted) into one float32 vector."""
    leaves = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            leaves.append(np.asarray(x, np.float32).ravel())
    walk(tree)
    return np.concatenate(leaves)


def state_tree(system):
    """The JAX-layout state tree of a port system, as numpy."""
    optim = system.optim
    mu = to_jax_params(system.graph, get=lambda p: optim.moments(p)[0])
    nu = to_jax_params(system.graph, get=lambda p: optim.moments(p)[1])
    count = np.int32(optim.count)
    opt_state = {}
    for label, keys in system.label_keys().items():
        if label != "frozen":
            opt_state[label] = ((count, ravel_like_jax({k: mu[k] for k in keys}),
                                 ravel_like_jax({k: nu[k] for k in keys})),
                                (count,))
            if label in optim.clips:    # clip_by_global_norm's empty state
                opt_state[label] = ((), opt_state[label])
            if label in optim.gates:
                opt_state[label] = ((count,), opt_state[label])
    return dict(params=to_jax_params(system.graph), opt_state=opt_state,
                step=np.int32(system.step),
                aux={k: v.detach().cpu().numpy() for k, v in system.aux.items()})


def save(output_path, system, it, latest_name="model.ckpt"):
    payload = dict(iter=int(it), state=state_tree(system))
    os.makedirs(os.path.join(output_path, "model"), exist_ok=True)
    numbered = os.path.join(output_path, "model", "{}.ckpt".format(int(it)))
    with open(numbered, "wb") as f:
        pickle.dump(payload, f)
    latest = os.path.join(output_path, latest_name)
    tmp = latest + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, latest)
    return numbered


def unravel_like_jax(flat, template):
    """Inverse of ``ravel_like_jax``: cut ``flat`` into arrays shaped and
    nested like ``template``."""
    flat = np.asarray(flat, np.float32)
    pos = 0

    def walk(x):
        nonlocal pos
        if isinstance(x, dict):
            return {k: walk(x[k]) for k in sorted(x)}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        n = int(np.size(x))
        out = flat[pos:pos + n].reshape(np.shape(x))
        pos += n
        return out
    tree = walk(template)
    if pos != flat.size:
        raise ValueError("optimizer state has {} entries, the parameters {}".format(
            flat.size, pos))
    return tree


class _Tuple(tuple):
    """Stands in for optax's state namedtuples when a checkpoint written by
    the JAX package is unpickled: the fields in order, as a tuple."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


class _Unpickler(pickle.Unpickler):

    def find_class(self, module, name):
        if module.split(".")[0] == "optax":
            return _Tuple
        return super().find_class(module, name)


def load_state_tree(system, state):
    """Load a JAX-layout state tree into a port system: parameters through
    the weight bridge (a top-level group the file lacks keeps its init),
    Adam moments and count, the step and the aux state."""
    template = to_jax_params(system.graph)
    missing = [k for k in template if k not in state["params"]]
    for k in missing:
        log.warn("checkpoint missing key '{}'; keeping init".format(k))
    system.graph.load_state_dict(from_jax_params(state["params"]), strict=not missing)
    named = dict(system.graph.named_parameters())
    for label, keys in system.label_keys().items():
        if label == "frozen" or label not in state.get("opt_state", {}):
            continue
        entry = state["opt_state"][label]
        if len(entry[0]) == 1:      # a gate's (count,) in front of Adam
            entry = entry[1]
        if len(entry[0]) == 0:      # a clip's empty state in front of Adam
            entry = entry[1]
        (count, mu, nu), _ = entry
        sub = {k: template[k] for k in keys}
        mu_sd = from_jax_params(unravel_like_jax(mu, sub))
        nu_sd = from_jax_params(unravel_like_jax(nu, sub))
        for name in mu_sd:
            system.optim.load_moments(named[name], mu_sd[name], nu_sd[name], int(count))
    system.step = int(state["step"])
    for k in system.aux:
        if k in state.get("aux", {}):
            system.aux[k] = torch.as_tensor(np.asarray(state["aux"][k]),
                                            device=system.device)


def restore(output_path, system, resume=True, load_name=None):
    """Load a checkpoint into ``system``. ``resume=True`` loads the latest,
    an integer that numbered snapshot; ``load_name`` an explicit path.
    Returns the checkpoint's iteration."""
    if load_name is not None:
        path = load_name
    elif resume is True:
        path = os.path.join(output_path, "model.ckpt")
    else:
        path = os.path.join(output_path, "model", "{}.ckpt".format(int(resume)))
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    load_state_tree(system, payload["state"])
    log.info("restored checkpoint {} (iter {})".format(path, payload["iter"]))
    return payload["iter"]
