"""The K6 shadow of the quality harness (``evidence/shadow_k6.py``,
``probe_b3 --shadow-k6``) on the CPU at a tiny shape, where the "K6" way is
the kernel's plain version (``fused_deform_plain``): both fp32 warps lie at
rounding level from the float64 warp, no leaf is a fault, the hook leaves the
run's own steps untouched, and a warp that is off shows as a fault."""

import json

import torch

from neural_invertible_warp_tpu_torch.evidence import probe_b3, shadow_k6
from neural_invertible_warp_tpu_torch.ops.cuda import fused_inn

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

TINY = ["--device=cpu", "--iters", "4", "--log-every", "2", "--n-images", "8", "--size",
        "12,16", "--max-iter", "4", "--max-pe-iter", "2", "--overrides",
        "data.val_ratio=0.25", "nerf.rand_rays=48", "nerf.sample_intvs=8",
        "tpu.fused_inn=true"]


def _run(tmp_path, name, extra=()):
    return probe_b3.main(TINY + ["--name", name, "--out", str(tmp_path / (name + ".jsonl")),
                                 "--out-root", str(tmp_path / name)] + list(extra))


def test_shadow_hook_leaves_the_run_alone_and_finds_no_fault(tmp_path):
    plain = _run(tmp_path, "plain")
    shadow = _run(tmp_path, "shadow", ["--shadow-k6", "2"])
    timing = ("elapsed", "elapsed_s", "ms_per_step")
    strip = [{k: v for k, v in row.items() if k not in timing} for row in plain["history"]]
    assert strip == [{k: v for k, v in row.items() if k not in timing}
                     for row in shadow["history"]]
    assert plain["val_psnr"] == shadow["val_psnr"]
    records = shadow["shadow_k6"]
    assert [r["step"] for r in records] == [0, 2, 4]
    leaves = set(records[-1]["dist"])
    assert {"grid_w", "center_w", "dgrid_w", "dcenter_w", "dwarp_latent",
            "dlin0_a_0.weight_v", "dlin2_b_1.bias", "dlin1_c.weight"} <= leaves
    for rec in records[1:]:
        for leaf in ("grid_w", "center_w"):
            d = rec["dist"][leaf]
            assert 0 < d["plain"] < 1e-6 and d["k6"] < 1e-6, (rec["step"], leaf, d)
        for leaf, d in rec["dist"].items():
            if leaf.startswith("dlin") or leaf == "dwarp_latent":
                assert d["k6"] < 1e-4 and d["plain"] < 1e-4, (rec["step"], leaf, d)
    assert shadow["shadow_k6_faults"] == []
    val = shadow["validate_k6"]
    # the record rounds val_psnr to 3 places; the readout refitted through
    # either fp32 warp moves this barely trained tiny scene's PSNR by ~5e-3 dB
    assert val["as_is"][0] == val["as_is"][1]
    assert abs(val["as_is"][0] - shadow["val_psnr"]) <= 5e-4
    assert abs(val["k6"] - val["plain"]) < 0.05
    sym = shadow_k6.symmetry(shadow)
    assert sym["n"] == sum(len(r["dist"]) for r in records[1:])
    assert 0 <= sym["k6_past"] <= 1 and 0 <= sym["plain_past"] <= 1 and sym["median"] > 0
    assert len(shadow_k6.table(shadow)) == 2 + len(records) + 3 + len(leaves)
    json.dumps(shadow)


def test_an_off_warp_is_a_fault(tmp_path, monkeypatch):
    """K6's way moved by 1e-4 of its outputs: its outputs and their
    cotangents are named faults."""
    args = probe_b3.parse_args(TINY + ["--out-root", str(tmp_path)])
    from neural_invertible_warp_tpu_torch.evidence import harness, scenes
    opt = probe_b3.probe_options(args)
    train, val, _ = scenes.blob_llff_arrays(n_images=8, img_size=(12, 16),
                                            val_ratio=0.25, backdrop=True)
    system = harness.make_trainer(opt, train, val, "cpu").system
    for _ in range(2):
        system.train_step()
    good = shadow_k6.shadow_step(system)
    assert good["fault"] == []
    real = fused_inn.fused_deform_forward

    def off(net, code, pts, alpha):
        out = real(net, code, pts, alpha)
        return out + 1e-4 * out.detach().abs().amax()
    monkeypatch.setattr(fused_inn, "fused_deform_forward", off)
    bad = shadow_k6.shadow_step(system)
    assert {"grid_w", "center_w"} <= set(bad["fault"]), bad["fault"]
