"""Training entry point of the port:

    python -m neural_invertible_warp_tpu_torch.train --model=barf_inn_llff \\
        --yaml=barf_inn_llff --barf_c2f=[0.1,0.5] --data.scene=fern \\
        --loss_weight.global_alignment=4

Same CLI surface as the JAX package's ``train.py``; runs on the first CUDA
device, or on the CPU through the plain PyTorch paths when there is none.
"""

from __future__ import annotations

import sys

import torch


def main(argv=None):
    from .config import set_options
    from .models.engine import log, run_training
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = set_options(sys.argv[1:] if argv is None else argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    log("device: {}".format(device))
    return run_training(opt, device)


if __name__ == "__main__":
    main()
