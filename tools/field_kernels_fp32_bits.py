"""K2, K3 and K4 in fp32 on fixed inputs, every output reduced to a digest
of its bits, to hold one tree's kernels against another's (a change against
its parent) on one card:

    python3 tools/field_kernels_fp32_bits.py <tree> <out.pt>   # once per tree
    python3 tools/field_kernels_fp32_bits.py --compare <a.pt> <b.pt>

The first form imports the port and chip_smoke.py from <tree>, builds its
kernels into <tree>/build/, and runs K2 (with compositing weights) at
[18,113] x 128 samples with PE bands 5-9 closed and open and at [1,2048]
x 128, each followed by K3 (render and kept), K4 without and with weight
gradients on a fixed cotangent, and K2's weight planes: 156 tensors.
"""

import os
import sys


def digest(x):
    import torch
    v = x.detach().contiguous().view(-1).view(torch.int32).long()
    w = torch.arange(v.numel(), device=v.device) % 1000003 + 1
    return int(v.sum()), int((v * w).sum()), tuple(x.shape)


def run(root, out_path):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from neural_invertible_warp_tpu_torch.flagship import flagship_options
    from neural_invertible_warp_tpu_torch.ops.cuda import build
    from neural_invertible_warp_tpu_torch.ops.cuda import fused_pe as fp
    from neural_invertible_warp_tpu_torch.ops.nerf_mlp import NerfMLP
    if not build.CSRC.startswith(os.path.abspath(root)):
        raise RuntimeError("imported the port from {}, not {}".format(build.CSRC, root))
    build.load_library()
    dev = torch.device("cuda", 0)
    mlp = NerfMLP(flagship_options().arch, generator=torch.Generator().manual_seed(0)).to(dev)
    out = {}
    for tag, (B, R, progress) in {"k2a": (18, 113, 0.3), "k2b": (18, 113, 1.0),
                                  "k3": (1, 2048, 1.0)}.items():
        c, r, d, t = cs.ray_batch(B, R, seed=11, device=dev)
        n = B * R
        w3, wv = fp.band_weights(progress, cs.C2F, dev)
        c, r, d = (x.reshape(n, -1).contiguous() for x in (c, r, d))
        t8 = torch.cat([t.reshape(n, 3), torch.ones(n, 1, device=dev),
                        torch.zeros(n, 4, device=dev)], 1).contiguous()
        o, dc, dr, grads, prob = fp.launch_rm_train(mlp, c, r, d, t8, w3, wv, None,
                                                    "softplus", None, True)
        out[tag + "_train"] = [o, dc, dr, prob] + list(grads)
        rendered = fp.launch_rm_fwd(mlp, c, r, d, w3, wv)
        kept, cache, packed = fp._rm_fwd(mlp, c, r, d, w3, wv, "softplus", keep=True)
        g8 = torch.randn(n, 8, generator=torch.Generator().manual_seed(5)).to(dev)
        frozen = fp.launch_rm_bwd(mlp, c, r, d, g8, w3, wv, cache, packed, want_dw=False)
        dc4, dr4, g4 = fp.launch_rm_bwd(mlp, c, r, d, g8, w3, wv, cache, packed)
        out[tag + "_k3k4"] = [rendered, kept, cache, frozen[0], frozen[1], dc4, dr4] + list(g4)
        out[tag + "_planes"] = [fp.k2_planes(mlp)]
    torch.save({k: [digest(x) for x in v] for k, v in out.items()}, out_path)
    print("saved {}: {} tensors".format(out_path, sum(len(v) for v in out.values())))


def compare(path_a, path_b):
    import torch
    a, b = torch.load(path_a), torch.load(path_b)
    differ = ["{}[{}]".format(k, i) for k in a for i, (x, y) in enumerate(zip(a[k], b[k]))
              if x != y]
    print("fp32 K2/K3/K4 outputs of {} against {} on the same inputs: {}".format(
        path_a, path_b, "the same bits in all {} tensors".format(
            sum(len(v) for v in a.values())) if not differ else "bits differ in " + str(differ)))
    return 1 if differ else 0


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    run(sys.argv[1], sys.argv[2])
