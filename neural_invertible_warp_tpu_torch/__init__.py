"""neural_invertible_warp_tpu_torch — the PyTorch/CUDA port of
``neural_invertible_warp_tpu``.

The JAX package beside it is the reference this port is held against. The
port keeps its layout (``ops/``, ``models/``, ``utils/``) and its numerics,
and replaces each Pallas TPU kernel with a hand-written CUDA kernel for
Hopper (``csrc/``), built with ``nvcc`` at first use. Every kernel has a
plain PyTorch version beside it, which is what runs for CPU tensors.

Importing this package imports only the standard library, numpy and torch.
"""

__version__ = "0.1.0"
