"""Training entry point of the port:

    python -m neural_invertible_warp_tpu_torch.train --model=barf_inn_llff \\
        --yaml=barf_inn_llff --barf_c2f=[0.1,0.5] --data.scene=fern \\
        --loss_weight.global_alignment=4

Same CLI surface as the JAX package's ``train.py`` (``--resume`` and
``--load=<ckpt>`` included; the resolved options are written to
``<output_path>/options.yaml``); ``--model=homography|planar|img_relu`` runs the
2D experiments of models/planar.py on ``--data.image_fname``. Runs on the
first CUDA device; ``--device=cpu`` runs the plain PyTorch paths instead.
Without a CUDA device and without that flag it fails.
"""

from __future__ import annotations

import sys

import torch


def main(argv=None):
    from .config import pop_device, save_options_file, set_options
    from .models.engine import log, run_training
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device, argv = pop_device(sys.argv[1:] if argv is None else argv)
    opt = set_options(argv)
    save_options_file(opt)
    log("device: {}".format(device))
    return run_training(opt, device)


if __name__ == "__main__":
    main()
