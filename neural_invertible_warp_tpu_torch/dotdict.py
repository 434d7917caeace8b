"""Attribute-access dictionary for options (``opt.nerf.depth.range``).

The same class as the JAX package's ``DotDict``, method for method
(tests/test_torch_package.py holds the two to the same behaviour). It
lives here so that the port's GPU path, and ``chip_smoke.py``, import
nothing from the JAX package; options the YAML loader returns are
converted to it (``config.set_options``), so the port handles one class.
"""

from __future__ import annotations


class DotDict(dict):
    """dict with attribute access; nested dicts are converted on insertion."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        for k, v in {**(d or {}), **kwargs}.items():
            self[k] = v

    @staticmethod
    def _convert(v):
        if isinstance(v, dict) and not isinstance(v, DotDict):
            return DotDict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(DotDict._convert(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, DotDict._convert(v))

    __setattr__ = __setitem__

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __delattr__(self, k):
        try:
            del self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def copy(self):
        return DotDict({k: (v.copy() if isinstance(v, DotDict) else v)
                        for k, v in self.items()})

    def to_plain(self):
        """Recursively convert back to plain dict/list."""
        def conv(v):
            if isinstance(v, DotDict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [conv(x) for x in v]
            return v
        return conv(self)
