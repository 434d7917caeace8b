"""Checkpoints in the JAX package's layout (neural_invertible_warp_tpu/utils/ckpt.py):

    <output_path>/model.ckpt          (latest)
    <output_path>/model/<iter>.ckpt   (numbered snapshots)

each a pickled ``dict(iter, state)`` of numpy arrays, where ``state`` is the
JAX system's state tree: ``params`` (through the weight bridge), ``opt_state``
per label as optax's adam state ``((count, mu, nu), (count,))`` with mu and nu
raveled over the label's params in JAX leaf order, ``step`` and ``aux``.
The JAX package's ``restore_checkpoint`` loads it into its own state.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .weights import to_jax_params


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
