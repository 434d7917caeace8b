"""Options for the port.

The YAML loader and CLI parser are the JAX package's
(``neural_invertible_warp_tpu.config``: ``load_options``,
``parse_arguments``, ``override_options``), imported inside
``set_options`` only, since they need PyYAML. Its ``process_options`` is
not used: it also configures JAX. The port's own ``process_options`` sets
the output path and ``H, W`` only. ``set_options`` returns the port's own
``DotDict``, like ``flagship.flagship_options``.
"""

from __future__ import annotations

import os

from .dotdict import DotDict


def process_options(opt, makedirs=True):
    """Output dir ``<output_root>/<group>/<name>`` and ``opt.H, opt.W``."""
    opt.output_path = os.path.join(opt.output_root, str(opt.group), str(opt.name))
    if makedirs:
        os.makedirs(opt.output_path, exist_ok=True)
    opt.H, opt.W = opt.data.image_size
    return opt


def set_options(argv, makedirs=True):
    """``--model=<name> --yaml=<file> [--key.sub=value ...]`` -> options."""
    from neural_invertible_warp_tpu import config as yaml_config
    opt_cmd = yaml_config.parse_arguments(argv)
    for key in ("model", "yaml"):
        if key not in opt_cmd:
            raise ValueError("--{}=<...> is required".format(key))
    opt = yaml_config.load_options("options/{}.yaml".format(opt_cmd.yaml))
    opt = yaml_config.override_options(opt, opt_cmd, key_stack=[],
                                       safe_check=True)
    return process_options(DotDict(opt.to_plain()), makedirs=makedirs)
