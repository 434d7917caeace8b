"""The port's PDC-Net and matchers (neural_invertible_warp_tpu_torch/ops/pdcnet,
utils/matchers.py) against the JAX package's, on the CPU.

Weights: a synthetic state_dict in the reference checkpoint's layout, made
with numpy from a seed for every name of the port's module, goes through the
JAX package's ``convert.pdcnet_params_from_torch`` and through the port's
``load_state_dict``: both read the same names, which are the names the JAX
converter reads from the reference checkpoint. Inputs are made with numpy
and handed to both sides; the JAX side runs once per module (fixtures), its
whole forward under ``jax.jit``. On CPU tensors the port's local correlation
takes K7's plain version.

Tolerances, all fp32 on both sides: resizes, warps and blocks agree to
atol 1e-5 (values of order 1, sums of up to a few hundred terms in another
order); the VGG pyramid and the GOCor scores to rtol 1e-4 of each output's
max (ten stacked convolutions; GOCor's three descent steps divide by sums of
squares); the whole forward's flow to 1e-4 of its max and P_R to atol 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neural_invertible_warp_tpu.ops.pdcnet import blocks as jblocks
from neural_invertible_warp_tpu.ops.pdcnet import convert as jconvert
from neural_invertible_warp_tpu.ops.pdcnet import gocor as jgocor
from neural_invertible_warp_tpu.ops.pdcnet import layers as jlayers
from neural_invertible_warp_tpu.ops.pdcnet import pdcnet as jpdcnet
from neural_invertible_warp_tpu.ops.pdcnet import vgg as jvgg
from neural_invertible_warp_tpu.utils import matchers as jmatchers
from neural_invertible_warp_tpu_torch.ops.pdcnet import blocks, convert, layers, pdcnet, vgg
from neural_invertible_warp_tpu_torch.ops.cuda import correlation as k7
from neural_invertible_warp_tpu_torch.utils import matchers

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

HW = (64, 80)
MIN_CONFIDENCE = 0.3
TOL_REL = 1e-4


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def _synthetic_state_dict(net, seed=0):
    """Every tensor of the port's state_dict, in the reference layout, drawn
    with numpy: kaiming kernels, small biases, BatchNorm with U(0,1) scales
    and non-trivial running statistics, GOCor parameters near their init."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in net.state_dict().items():
        own = v.numpy()
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("running_mean"):
            x = 0.1 * rng.randn(*own.shape)
        elif k.endswith("running_var"):
            x = rng.uniform(0.5, 1.5, own.shape)
        elif "filter_" in k or k.endswith("scaling"):
            # GOCor: around the deterministic init (reg_layer: 1e-2 randn)
            x = own + (0.01 if "reg_layer" in k else 0.1) * rng.randn(*own.shape)
        elif own.ndim == 4:
            x = rng.randn(*own.shape) * np.sqrt(2.0 / (own.shape[1] * own[0, 0].size))
        elif k.endswith(".1.weight"):
            x = rng.uniform(0.0, 1.0, own.shape)
        else:
            x = 0.05 * rng.randn(*own.shape)
        sd[k] = x.astype(np.float32)
    return sd


class _Recording(dict):
    """A state_dict that records which names a converter reads."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


@pytest.fixture(scope="module")
def weights():
    """(port module, reference-layout state_dict, JAX params, names the JAX
    converter read)."""
    net = pdcnet.PDCNet(torch.Generator().manual_seed(0))
    sd = _Recording(_synthetic_state_dict(net))
    params = jconvert.pdcnet_params_from_torch(sd)
    result = net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    assert not result.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in result.missing_keys)
    return net, dict(sd), params, sd.read


def _image(seed):
    """A smooth [H,W,3] image in [0,1] with some structure."""
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.linspace(0, 1, HW[0]), np.linspace(0, 1, HW[1]), indexing="ij")
    img = np.stack([0.5 + 0.4 * np.sin(6 * xs + 3 * ys + p) for p in rng.rand(3) * 6], -1)
    return np.clip(img + 0.05 * rng.randn(*img.shape), 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(img_i, img_j) [H,W,3] and the [1,3,H,W] arrays in [0,255] that the
    matcher makes of them."""
    imgs = [_image(1), _image(2)]
    return imgs, [(255.0 * im).transpose(2, 0, 1)[None] for im in imgs]


@pytest.fixture(scope="module")
def jax_flow(weights, pair):
    """JAX flow and P_R of target i, source j, jitted once."""
    _, _, params, _ = weights
    _, (tgt, src) = pair
    fn = jax.jit(lambda p, s, t: jpdcnet.estimate_flow_and_confidence_map(p, s, t,
                                                                          scaling=0.25))
    flow, p_r = fn(params, jnp.asarray(src), jnp.asarray(tgt))
    return np.asarray(flow), np.asarray(p_r)


# ------------------------------------------------------------ weights

def test_state_dict_names_are_the_reference_checkpoints(weights):
    """The JAX converter, which reads the reference checkpoint, reads every
    tensor of the port's module and nothing else."""
    net, sd, _, read = weights
    own = {k for k in net.state_dict() if not k.endswith("num_batches_tracked")}
    assert read == own == set(sd)
    assert len(own) == 421


def test_from_jax_params_fills_the_same_module(weights):
    net, sd, params, _ = weights
    tree = jax.tree_util.tree_map(np.asarray, params)
    back = convert.state_dict_from_jax_params(tree)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].reshape(sd[k].shape), sd[k], err_msg=k)
    other = convert.from_jax_params(tree)
    for k, v in net.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k


def test_load_pdcnet_checkpoint(weights, tmp_path):
    """A reference-style checkpoint (``state_dict`` under DataParallel's
    ``module.`` prefix, the bin predictors flattened) loads into the port,
    and ``pdcnet(weights_path)`` builds the matcher from it."""
    net, sd, _, _ = weights
    ckpt = {"module." + k: torch.from_numpy(v.reshape(-1) if "predictor" in k else v)
            for k, v in sd.items()}
    ckpt["module.extra.unused"] = torch.zeros(3)
    path = str(tmp_path / "PDCNet_megadepth.pth.tar")
    torch.save({"state_dict": ckpt, "epoch": 1}, path)
    loaded = convert.load_pdcnet_checkpoint(path)
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(loaded.state_dict()[k], v), k
    m = matchers.pdcnet(weights_path=path, device="cpu", min_confidence=0.2)
    assert isinstance(m, matchers.PdcNetMatcher) and m.min_confidence == 0.2
    del ckpt["module.decoder2.conv_0.0.weight"]
    torch.save({"state_dict": ckpt}, path)
    with pytest.raises(KeyError, match="decoder2.conv_0.0.weight"):
        convert.load_pdcnet_checkpoint(path)


def test_pdcnet_gate_needs_weights():
    with pytest.raises(RuntimeError, match="weights"):
        matchers.pdcnet()
    with pytest.raises(RuntimeError):
        jmatchers.pdcnet()


# ------------------------------------------------------------ layers

def test_resizes_warp_and_deconv_match_jax(weights):
    net, _, params, _ = weights
    rng = np.random.RandomState(0)
    x = rng.rand(2, 3, 17, 23).astype(np.float32)
    for out_hw in [(8, 12), (34, 46), (5, 50)]:
        np.testing.assert_allclose(
            layers.interp_bilinear(torch.tensor(x), out_hw).numpy(),
            np.asarray(jlayers.interp_bilinear(jnp.asarray(x), out_hw)), atol=1e-5)
        np.testing.assert_allclose(
            layers.interp_area(torch.tensor(x), out_hw).numpy(),
            np.asarray(jlayers.interp_area(jnp.asarray(x), out_hw)), atol=1e-5)
    f = rng.rand(1, 4, 10, 14).astype(np.float32)
    flow = ((rng.rand(1, 2, 10, 14) - 0.5) * 6).astype(np.float32)
    np.testing.assert_allclose(layers.warp(torch.tensor(f), torch.tensor(flow)).numpy(),
                               np.asarray(jlayers.warp(jnp.asarray(f), jnp.asarray(flow))),
                               atol=1e-5)
    vgrid = ((rng.rand(1, 2, 10, 14) - 0.5) * 2.4).astype(np.float32)
    np.testing.assert_allclose(
        layers.grid_sample_zeros(torch.tensor(f), torch.tensor(vgrid)).numpy(),
        np.asarray(jlayers.grid_sample_zeros(jnp.asarray(f), jnp.asarray(vgrid))), atol=1e-5)
    mapping = (rng.rand(1, 2, 6, 7) * 2 - 1).astype(np.float32)
    np.testing.assert_allclose(
        layers.unnormalise_and_convert_mapping_to_flow(torch.tensor(mapping)).numpy(),
        np.asarray(jlayers.unnormalise_and_convert_mapping_to_flow(jnp.asarray(mapping))),
        atol=1e-5)
    np.testing.assert_allclose(layers.l2norm_channel(torch.tensor(f)).numpy(),
                               np.asarray(jlayers.l2norm_channel(jnp.asarray(f))), atol=1e-6)
    feat = rng.randn(1, 32, 6, 7).astype(np.float32)
    fl = rng.randn(1, 2, 6, 7).astype(np.float32)
    with torch.no_grad():
        for name, inp in (("upfeat2", feat), ("deconv2", fl), ("deconv4", fl)):
            got = getattr(net, name)(torch.tensor(inp)).numpy()
            ref = np.asarray(jlayers.deconv2d(params[name], jnp.asarray(inp)))
            assert got.shape == (1, 2, 12, 14)
            np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=name)
    # at init the deconvs are the reference's bilinear upsampling kernels
    np.testing.assert_array_equal(pdcnet.PDCNet().deconv4.weight.numpy(),
                                  np.asarray(jlayers.bilinear_deconv_kernel(2)))


def test_vgg_pyramid_matches_jax(weights):
    net, _, params, _ = weights
    x = np.random.RandomState(3).randn(1, 3, 32, 48).astype(np.float32)
    with torch.no_grad():
        got = net.pyramid(torch.tensor(x))
        eighth = vgg.vgg_eighth(net.pyramid, torch.tensor(x))
    ref = jax.jit(jvgg.vgg_pyramid)(params["pyramid"], jnp.asarray(x))
    assert [tuple(o.shape) for o in got] == [
        (1, 64, 32, 48), (1, 64, 16, 24), (1, 128, 8, 12), (1, 256, 4, 6), (1, 512, 2, 3)]
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r) <= TOL_REL
    assert [torch.equal(a, got[i]) for a, i in zip(eighth, (0, 2, 3))] == [True] * 3


# ------------------------------------------------------------ GOCor

def test_global_gocor_matches_jax(weights):
    net, _, params, _ = weights
    rng = np.random.RandomState(4)
    ref = rng.randn(1, 512, 6, 7).astype(np.float32)
    qry = rng.randn(1, 512, 6, 7).astype(np.float32)
    with torch.no_grad():
        got = net.corr.corr_module(torch.tensor(ref), torch.tensor(qry)).numpy()
    want = jax.jit(jgocor.global_gocor)(params["global_gocor"], jnp.asarray(ref),
                                        jnp.asarray(qry))
    assert got.shape == (1, 42, 6, 7)
    assert _rel(got, want) <= TOL_REL


def test_local_gocor_matches_jax(weights):
    """The local GOCor through the K7 wrappers (plain versions on the CPU):
    7 correlations and 3 adjoints, none of them a kernel launch here."""
    net, _, params, _ = weights
    rng = np.random.RandomState(5)
    ref = rng.randn(1, 64, 10, 12).astype(np.float32)
    qry = rng.randn(1, 64, 10, 12).astype(np.float32)
    with torch.no_grad():
        got = net.local_corr(torch.tensor(ref), torch.tensor(qry)).numpy()
    want = jax.jit(jgocor.local_gocor)(params["local_gocor"], jnp.asarray(ref),
                                       jnp.asarray(qry))
    assert got.shape == (1, 81, 10, 12)
    assert _rel(got, want) <= TOL_REL
    assert k7.local_correlation.launches == k7.local_correlation_transpose.launches == 0


# ------------------------------------------------------------ blocks

@pytest.mark.parametrize("block", ["decoder4", "decoder1", "refinement", "mdn_corr9",
                                   "mdn_corr16", "mdn_flow", "confidence"])
def test_blocks_match_jax(weights, block):
    net, _, params, _ = weights
    rng = np.random.RandomState(6)

    def x(c, h=6, w=7):
        return rng.randn(2, c, h, w).astype(np.float32)
    if block.startswith("decoder"):
        inp = x(258 if block == "decoder4" else 89)
        got = getattr(net, block)(torch.tensor(inp))
        ref = jblocks.residual_decoder(params[block], jnp.asarray(inp))
    elif block == "refinement":
        inp = x(34)
        got = blocks.refinement(net.refinement_convs("l_dc_conv"), torch.tensor(inp))
        ref = jblocks.refinement(params["refinement_final"], jnp.asarray(inp))
    elif block.startswith("mdn_corr"):
        s = int(block[len("mdn_corr"):])
        lvl = "4" if s == 16 else "2"
        inp = x(s * s, 3, 4)
        got = getattr(net, "corr_uncertainty_decoder" + lvl)(torch.tensor(inp))
        ref = jblocks.mdn_from_corr(params["corr_uncertainty_decoder" + lvl],
                                    jnp.asarray(inp), s)
    elif block == "mdn_flow":
        inp = x(44)
        got = net.uncertainty_decoder3(torch.tensor(inp))
        ref = jblocks.mdn_from_flow(params["uncertainty_decoder3"], jnp.asarray(inp))
    else:
        w, lv = x(2), 3.0 * x(2)
        got = (blocks.constrain_large_log_var_map(2.0, 520.0 ** 2, torch.tensor(lv)),
               blocks.estimate_probability_of_confidence_interval_of_mixture_density(
                   torch.tensor(w), torch.tensor(lv)),
               blocks.estimate_probability_of_confidence_interval_of_mixture_density(
                   torch.tensor(w), torch.tensor(lv), R=2.0, gaussian=True))
        ref = (jblocks.constrain_large_log_var_map(2.0, 520.0 ** 2, jnp.asarray(lv)),
               jblocks.estimate_probability_of_confidence_interval_of_mixture_density(
                   jnp.asarray(w), jnp.asarray(lv)),
               jblocks.estimate_probability_of_confidence_interval_of_mixture_density(
                   jnp.asarray(w), jnp.asarray(lv), R=2.0, gaussian=True))
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5)


# ------------------------------------------------------------ whole forward

def test_estimate_flow_and_confidence_map_matches_jax(weights, pair, jax_flow, monkeypatch):
    """The whole forward at 64x80; it calls the local correlation 24 times
    and its adjoint in f1 9 times (3 local levels x (3 GOCor iterations x
    (2 + 1) + 1 + 1)): on the card, K7's and the adjoint kernel's launches."""
    net, _, _, _ = weights
    _, (tgt, src) = pair
    calls = {}
    for name in ("local_correlation", "local_correlation_transpose",
                 "local_correlation_transpose_f2"):
        def counted(*args, _fn=getattr(k7, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(k7, name, counted)
    with torch.no_grad():
        flow, p_r = pdcnet.estimate_flow_and_confidence_map(net, torch.tensor(src),
                                                            torch.tensor(tgt))
    flow, p_r = flow.numpy(), p_r.numpy()
    ref_flow, ref_pr = jax_flow
    assert flow.shape == (1, 2, 16, 20) and p_r.shape == (1, 1, 16, 20)
    assert np.isfinite(flow).all() and 0.0 <= p_r.min() and p_r.max() <= 1.0
    assert float(np.abs(ref_flow).max()) > 0.5          # the flow is not trivial
    assert _rel(flow, ref_flow) <= TOL_REL
    np.testing.assert_allclose(p_r, ref_pr, atol=1e-4)
    assert calls == {"local_correlation": 24, "local_correlation_transpose": 9}


def test_matches_and_the_matcher_on_cpu(weights, pair, jax_flow):
    """``matches_from_flow_and_confidence`` equals the JAX one on the same
    flow; ``PdcNetMatcher(device='cpu')`` gives the JAX matches but where P_R
    lies within 1e-4 of min_confidence."""
    net, _, _, _ = weights
    imgs, _ = pair
    ref_flow, ref_pr = jax_flow
    assert ref_pr.min() < MIN_CONFIDENCE < ref_pr.max()
    got = pdcnet.matches_from_flow_and_confidence(torch.tensor(ref_flow), torch.tensor(ref_pr),
                                                  HW, MIN_CONFIDENCE)
    ref = jpdcnet.matches_from_flow_and_confidence(ref_flow, ref_pr, HW, MIN_CONFIDENCE)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    empty = pdcnet.matches_from_flow_and_confidence(ref_flow, ref_pr, HW, MIN_CONFIDENCE,
                                                    min_number_of_pts=10 ** 6)
    assert [e.shape for e in empty] == [(0, 2), (0, 2), (0,)]

    m = matchers.PdcNetMatcher(net, min_confidence=MIN_CONFIDENCE, device="cpu")
    tf32 = torch.backends.cudnn.allow_tf32
    kp_i, kp_j = m(0, 1, imgs[0], imgs[1])
    assert torch.backends.cudnn.allow_tf32 is tf32       # restored after the call
    assert kp_i.shape == kp_j.shape and kp_i.shape[1] == 2 and len(kp_i) > 0
    near = np.abs(ref_pr - MIN_CONFIDENCE) <= 1e-4
    assert abs(len(kp_i) - len(ref[1])) <= int(near.sum())
    if len(kp_i) == len(ref[1]):
        # P_R orders the matches; near-equal confidences may swap: compare
        # in the order of the target pixels
        o, r = np.lexsort(kp_i.T), np.lexsort(ref[1].T)
        np.testing.assert_allclose(kp_i[o], ref[1][r], atol=1e-6)
        np.testing.assert_allclose(kp_j[o], ref[0][r],
                                   atol=4 * TOL_REL * np.abs(ref_flow).max())


# ------------------------------------------------------------ other matchers

def _corner_image(seed, shift=(0, 0)):
    rng = np.random.RandomState(seed)
    img = np.full((72, 96, 3), 0.2, np.float32)
    for _ in range(14):
        y, x = rng.randint(8, 56), rng.randint(8, 80)
        img[y:y + 9, x:x + 7] = rng.rand(3)
    return np.roll(img, shift, axis=(0, 1))


def test_zncc_matcher_matches_jax():
    a, b = _corner_image(0), _corner_image(0, shift=(2, 3))
    got = matchers.ZnccMatcher(device="cpu")(0, 1, a, b)
    ref = jmatchers.ZnccMatcher()(0, 1, a, b)
    assert len(ref[0]) > 5
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_synthetic_gt_matcher_matches_jax():
    rng = np.random.RandomState(7)
    pts = rng.randn(60, 3) * [1.0, 1.0, 0.5] + [0, 0, 4.0]
    poses = np.stack([np.concatenate([np.eye(3), [[0.1 * i], [0.0], [0.0]]], 1)
                      for i in range(3)])
    intr = np.tile([[50.0, 0, 40], [0, 50.0, 30], [0, 0, 1]], (3, 1, 1))
    args = (poses, intr, pts, 60, 80)
    got = matchers.SyntheticGTMatcher(*args, outlier_frac=0.2, seed=3)
    ref = jmatchers.SyntheticGTMatcher(*args, outlier_frac=0.2, seed=3)
    for i, j in ((0, 1), (1, 2), (0, 2)):
        for g, r in zip(got(i, j), ref(i, j)):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("method", ["vector", "matrix", "dist", "random"])
def test_pair_selection_matches_jax(method):
    rng = np.random.RandomState(8)
    poses = []
    for _ in range(9):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        poses.append(np.concatenate([q, rng.randn(3, 1)], 1))
    poses = np.stack(poses)
    kw = dict(angular_dist_method=method)
    if method == "random":
        got = matchers.nearest_pose_pairs(poses, 3, rng=np.random.RandomState(0), **kw)
        ref = jmatchers.nearest_pose_pairs(poses, 3, rng=np.random.RandomState(0), **kw)
    else:
        got = matchers.nearest_pose_pairs(poses, 3, **kw)
        ref = jmatchers.nearest_pose_pairs(poses, 3, **kw)
        np.testing.assert_array_equal(
            matchers.get_nearest_pose_ids(poses[2], poses, 4, tar_id=2, **kw),
            jmatchers.get_nearest_pose_ids(poses[2], poses, 4, tar_id=2, **kw))
    assert got == ref and len(got) >= 9
    assert matchers.exhaustive_pairs(5) == jmatchers.exhaustive_pairs(5)
    images = [_corner_image(s) for s in range(6)]
    assert matchers.retrieval_pairs(images, 2) == jmatchers.retrieval_pairs(images, 2)
    with pytest.raises(ValueError, match="unknown"):
        matchers.get_nearest_pose_ids(poses[0], poses, 2, angular_dist_method="nope")
