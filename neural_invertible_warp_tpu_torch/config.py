"""Options for the port: YAML files with ``_parent_`` inheritance plus a
dot-notation CLI.

``parse_arguments``, ``load_options`` and ``override_options`` are the
port's own copies of the JAX package's (neural_invertible_warp_tpu/config.py).
They read and write YAML through ``utils/options_yaml.py``, which resolves
scalars as PyYAML does, so no YAML library is needed. CLI syntax:

    --key1.key2=value  -> YAML-parsed value
    --key1.key2=       -> None
    --key1.key2        -> True
    --key1.key2!       -> False

A YAML file may name one or more parents via ``_parent_``; parents load
first and are overridden leaf-wise by the child. CLI overrides are checked
against existing keys (``safe_check``): an unknown key prompts on a TTY and
raises otherwise. The JAX package's ``process_options`` is not copied: it
also configures JAX. The port's own names the run after its seed, as that one
does, and sets the output path and ``H, W``. ``save_options_file`` writes the
resolved options into the run directory, as the JAX package's does.
"""

from __future__ import annotations

import os
import random
import string
import sys

from .dotdict import DotDict
from .utils import options_yaml

# Root against which relative option paths (e.g. "options/base.yaml") resolve.
# Defaults to the repo root (parent of this package); overridable for tests.
OPTIONS_ROOT = os.environ.get(
    "NIW_OPTIONS_ROOT",
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
)


def parse_arguments(args):
    """Parse ``--a.b.c=val`` style CLI arguments into a nested DotDict."""
    opt_cmd = {}
    for arg in args:
        assert arg.startswith("--"), "arguments must start with '--': {}".format(arg)
        if "=" not in arg[2:]:
            key_str, value = (arg[2:-1], "false") if arg.endswith("!") else (arg[2:], "true")
        else:
            key_str, value = arg[2:].split("=", 1)
        keys_sub = key_str.split(".")
        opt_sub = opt_cmd
        for k in keys_sub[:-1]:
            opt_sub = opt_sub.setdefault(k, {})
        assert keys_sub[-1] not in opt_sub, "duplicate CLI key: {}".format(key_str)
        opt_sub[keys_sub[-1]] = options_yaml.load_scalar(value)
    return DotDict(opt_cmd)


def load_options(fname):
    """Load a YAML options file, resolving the ``_parent_`` chain."""
    path = fname if os.path.isabs(fname) else os.path.join(OPTIONS_ROOT, fname)
    with open(path) as f:
        opt = DotDict(options_yaml.load(f.read()) or {})
    if "_parent_" in opt:
        parents = opt.pop("_parent_")
        if isinstance(parents, str):
            parents = [parents]
        for parent in parents:
            opt_parent = load_options(parent)
            opt_parent = override_options(opt_parent, opt, key_stack=[])
            opt = opt_parent
    return opt


def override_options(opt, opt_over, key_stack=None, safe_check=False):
    """Recursively override ``opt`` with ``opt_over`` (leaf-wise)."""
    key_stack = key_stack or []
    for key, value in opt_over.items():
        if isinstance(value, dict):
            opt[key] = override_options(
                opt.get(key, DotDict()), value,
                key_stack=key_stack + [key], safe_check=safe_check,
            )
        else:
            if safe_check and key not in opt:
                key_str = ".".join(key_stack + [key])
                if sys.stdin.isatty():
                    add_new = None
                    while add_new not in ["y", "n"]:
                        add_new = input('"{}" not found in original opt, add? (y/n) '.format(key_str))
                    if add_new == "n":
                        print("safe exiting...")
                        sys.exit(0)
                else:
                    raise KeyError(
                        'unknown option "{}" (not present in the YAML config); '
                        "add it to the YAML or fix the flag".format(key_str)
                    )
            opt[key] = value
    return opt


def process_options(opt, makedirs=True):
    """Run name (``_seed<n>`` for a non-zero seed, four random letters
    without a seed), output dir ``<output_root>/<group>/<name>`` and
    ``opt.H, opt.W``."""
    if opt.get("seed") is not None:
        if opt.seed != 0:
            opt.name = "{}_seed{}".format(opt.name, opt.seed)
    else:
        randkey = "".join(random.choice(string.ascii_uppercase) for _ in range(4))
        opt.name = "{}_{}".format(opt.name, randkey)
    opt.output_path = os.path.join(opt.output_root, str(opt.group), str(opt.name))
    if makedirs:
        os.makedirs(opt.output_path, exist_ok=True)
    opt.H, opt.W = opt.data.image_size
    return opt


def pop_device(argv):
    """Split ``--device=<cpu|cuda>`` off the option arguments. Returns
    (device, remaining arguments); the default device is the card, and
    asking for it without one raises."""
    device, rest = "cuda", []
    for arg in argv:
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    return check_device(device), rest


def check_device(device):
    """``device`` ("cpu" or "cuda") if it can run here: asking for the card
    without one raises instead of falling back to the CPU."""
    import torch
    if device not in ("cpu", "cuda"):
        raise ValueError("--device must be cpu or cuda: {}".format(device))
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device=cpu to run the plain "
                           "PyTorch paths on the CPU")
    return device


def set_options(argv, makedirs=True):
    """``--model=<name> --yaml=<file> [--key.sub=value ...]`` -> options."""
    opt_cmd = parse_arguments(argv)
    for key in ("model", "yaml"):
        if key not in opt_cmd:
            raise ValueError("--{}=<...> is required".format(key))
    opt = load_options("options/{}.yaml".format(opt_cmd.yaml))
    opt = override_options(opt, opt_cmd, key_stack=[], safe_check=True)
    return process_options(opt, makedirs=makedirs)


def save_options_file(opt):
    """Dump the resolved options into ``<output_path>/options.yaml``. Where a
    different one is there already (a rerun into the same directory), ask on
    a TTY whether to override it; otherwise warn, keep the old file as
    ``options_prev.yaml`` and write the new one. The ``device`` key is left
    out."""
    opt_fname = os.path.join(opt.output_path, "options.yaml")
    plain = {k: v for k, v in opt.to_plain().items() if k not in ("device",)}
    if os.path.isfile(opt_fname):
        with open(opt_fname) as f:
            opt_old = options_yaml.load(f.read())
        if plain != opt_old:
            if sys.stdin.isatty():
                override = None
                while override not in ["y", "n"]:
                    override = input("existing options file differs; override? (y/n) ")
                if override == "n":
                    print("safe exiting...")
                    sys.exit(0)
            else:
                from .utils import log
                log.warn("existing options file differs from current run; overwriting "
                         "(previous file saved as options_prev.yaml)")
                os.replace(opt_fname, os.path.join(opt.output_path, "options_prev.yaml"))
    with open(opt_fname, "w") as f:
        f.write(options_yaml.dump(plain))
