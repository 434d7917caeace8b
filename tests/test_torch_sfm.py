"""The port's SfM pose initialisation against the JAX package on the CPU:
the two-view and PnP geometry, the track graph, both bundle adjusters, the
native core, the whole ``compute_sfm_poses`` pipeline, and the numpy
geometry helpers and the batched epipolar projection.

The same numpy inputs go into both packages in one process. The SfM is
host numpy and its RANSAC draws come from seeded numpy and from the native
library's own seeded generator, so the numpy routes, the pipeline and the
port's build of ``native/sfm_core.cpp`` against the JAX package's build
(same source, same flags) are held exactly (poses to 1e-9). The port's
native route against its numpy route, which draw from different
generators, is held to the agreement ``tests/test_sfm_native.py`` asks
(inlier sets agree on > 95%, triangulation rtol 1e-6, PnP atol 1e-5).
``bundle_adjust`` is torch autograd with ``torch.optim.Adam`` in the port and
a jitted optax loop in the JAX package: float32 Adam steps that differ in
their last bits, held to atol 2e-6 in poses and points after 100
iterations and the loss to rtol 1e-3. The batched projection
(``ops/epipolar.py``) is float32 torch against float32 ``jnp``: rtol 1e-5.
Sizes are those of ``tests/test_sfm.py``.
"""

import os
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from neural_invertible_warp_tpu.ops import epipolar as jepipolar
from neural_invertible_warp_tpu.utils import colmap_init as jcolmap_init
from neural_invertible_warp_tpu.utils import geometry_np as jgnp
from neural_invertible_warp_tpu.utils import matchers as jmatchers
from neural_invertible_warp_tpu.utils import sfm as jsfm
from neural_invertible_warp_tpu.utils import sfm_native as jnative
from neural_invertible_warp_tpu_torch.ops import epipolar
from neural_invertible_warp_tpu_torch.utils import colmap_init
from neural_invertible_warp_tpu_torch.utils import geometry_np as gnp
from neural_invertible_warp_tpu_torch.utils import matchers, sfm, sfm_native
from test_sfm import make_rig

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _equal(got, ref):
    """Exact equality of nested results (arrays, tuples, dicts, scalars)."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            _equal(got[k], ref[k])
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _equal(g, r)
    elif ref is None:
        assert got is None
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.fixture(scope="module")
def two_view():
    """Normalized matches of two views of make_rig: 0.3 px noise, 15% outliers."""
    poses, intr, pts, H, W = make_rig(2, seed=9)
    m = matchers.SyntheticGTMatcher(poses, intr, pts, H, W, noise_px=0.3,
                                    outlier_frac=0.15, seed=3)
    a, b = m(0, 1)
    return poses, intr, sfm.normalize_pixels(a, intr[0]), sfm.normalize_pixels(b, intr[1])


@pytest.fixture
def numpy_route(monkeypatch):
    """Both packages on their numpy route; the library caches reset on both
    sides of the test."""
    monkeypatch.setenv("NIW_NO_NATIVE", "1")
    sfm_native.reset_cache()
    jnative.reset_cache()
    yield
    monkeypatch.delenv("NIW_NO_NATIVE")
    sfm_native.reset_cache()
    jnative.reset_cache()


@pytest.fixture(scope="module")
def native():
    """Both packages' native cores. Another test process may be linking the
    JAX package's library at this moment (it builds in place), so a failed
    load is tried again."""
    for _ in range(5):
        sfm_native.reset_cache()
        jnative.reset_cache()
        if sfm_native.available() and jnative.available():
            return sfm_native
        time.sleep(3)
    raise AssertionError("g++ did not build the native core")


# ----------------------------------------------------------- the geometry

def test_two_view_geometry_is_the_jax_packages(two_view):
    """normalize_pixels, the 8-point solver, Sampson distances, RANSAC over
    the essential matrix and the homography, the pose from E and the
    triangulation: the same bits."""
    poses, intr, x1, x2 = two_view
    kp = np.random.RandomState(0).rand(20, 2) * 100
    _equal(sfm.normalize_pixels(kp, intr[0]), jsfm.normalize_pixels(kp, intr[0]))
    _equal(sfm.eight_point_essential(x1[:20], x2[:20]), jsfm.eight_point_essential(x1[:20], x2[:20]))
    thresh = 2.0 / intr[0, 0, 0]
    E, inl = sfm.ransac_essential(x1, x2, thresh=thresh, seed=1)
    E_j, inl_j = jsfm.ransac_essential(x1, x2, thresh=thresh, seed=1)
    _equal((E, inl), (E_j, inl_j))
    assert 0.8 < inl.mean() < 0.9                 # the outliers are rejected
    _equal(sfm.sampson_distance(E, x1, x2), jsfm.sampson_distance(E_j, x1, x2))
    _equal(sfm.ransac_homography(x1, x2, seed=2), jsfm.ransac_homography(x1, x2, seed=2))
    P2 = sfm.pose_from_essential(E, x1[inl], x2[inl])
    _equal(P2, jsfm.pose_from_essential(E_j, x1[inl], x2[inl]))
    X = sfm.triangulate(np.eye(3, 4), P2[0], x1[inl], x2[inl])
    _equal(X, jsfm.triangulate(np.eye(3, 4), P2[0], x1[inl], x2[inl]))
    _equal(sfm.depth_in_camera(P2[0], X), jsfm.depth_in_camera(P2[0], X))
    _equal(sfm.reprojection_error(P2[0], X, x2[inl]),
           jsfm.reprojection_error(P2[0], X, x2[inl]))


def test_pnp_and_multiview_triangulation_are_the_jax_packages():
    """pnp_dlt, the Huber refinement, RANSAC PnP, and the multi-view and
    robust track triangulation on three noisy views: the same bits."""
    poses, intr, pts, H, W = make_rig(3, seed=11)
    m = matchers.SyntheticGTMatcher(poses, intr, pts, H, W, noise_px=0.3, seed=2)
    xs = [sfm.normalize_pixels(m._detect(c)[0], intr[c]) for c in range(3)]
    vis = m._detect(0)[1] & m._detect(1)[1] & m._detect(2)[1]
    X, x = pts[vis][:120], xs[2][vis][:120]
    x_out = x.copy()
    x_out[::7] += 0.05                            # outliers for RANSAC
    P = sfm.pnp_dlt(X, x)
    _equal(P, jsfm.pnp_dlt(X, x))
    _equal(sfm.refine_pose_pnp(P, X, x, huber=2e-3), jsfm.refine_pose_pnp(P, X, x, huber=2e-3))
    P_r, inl = sfm.ransac_pnp(X, x_out, thresh=1e-2, seed=3)
    _equal((P_r, inl), jsfm.ransac_pnp(X, x_out, thresh=1e-2, seed=3))
    assert 0.8 < inl.mean() < 0.9
    Ps = poses[:3]
    obs = [np.stack([xs[c][vis][k] for c in range(3)]) for k in range(20)]
    for o in obs:
        _equal(sfm.triangulate_multiview(Ps, o), jsfm.triangulate_multiview(Ps, o))
        ths = np.full(3, 4e-3)
        _equal(sfm.triangulate_track_robust(Ps, o, ths), jsfm.triangulate_track_robust(Ps, o, ths))


def test_track_graph_is_the_jax_packages():
    """The conflict-aware union-find over the matches of a 4-camera rig with
    outliers, at two quantizations: the same tracks in the same order."""
    poses, intr, pts, H, W = make_rig(4, seed=6)
    m = matchers.SyntheticGTMatcher(poses, intr, pts, H, W, noise_px=0.3,
                                    outlier_frac=0.1, seed=8)
    pairs = [(i, j, *m(i, j)) for i, j in matchers.exhaustive_pairs(4)]
    for quant in (1.0, 0.25):
        g, g_j = sfm.TrackGraph(quant=quant), jsfm.TrackGraph(quant=quant)
        for i, j, a, b in pairs:
            for xa, xb in zip(a, b):
                g.add_match(i, j, xa, xb)
                g_j.add_match(i, j, xa, xb)
        tracks, tracks_j = g.tracks(min_len=2), g_j.tracks(min_len=2)
        assert len(tracks) > 100
        assert [sorted(t) for t in tracks] == [sorted(t) for t in tracks_j]
        _equal([[t[k] for k in sorted(t)] for t in tracks],
               [[t[k] for k in sorted(t)] for t in tracks_j])


@pytest.fixture(scope="module")
def ba_problem():
    """tests/test_sfm.py::test_bundle_adjust_reduces_error's problem."""
    poses, intr, pts, H, W = make_rig(4, seed=3)
    rng = np.random.RandomState(0)
    noisy_poses = poses.copy()
    noisy_poses[1:, :, 3] += rng.randn(3, 3) * 0.02
    noisy_pts = pts + rng.randn(*pts.shape) * 0.02
    obs_cam, obs_pt, obs_xy = [], [], []
    for c in range(4):
        x = sfm.normalize_pixels(
            matchers.SyntheticGTMatcher(poses, intr, pts, H, W, noise_px=0)._project(c)[0],
            intr[c])
        for p in range(0, len(pts), 4):
            obs_cam.append(c)
            obs_pt.append(p)
            obs_xy.append(x[p])
    return noisy_poses, noisy_pts, np.array(obs_cam), np.array(obs_pt), np.array(obs_xy)


def _mean_reprojection(P_stack, X_stack, obs_cam, obs_pt, obs_xy):
    return float(np.mean([sfm.reprojection_error(P_stack[c], X_stack[p][None], xy[None])[0][0]
                          for c, p, xy in zip(obs_cam, obs_pt, obs_xy)]))


def test_lm_bundle_adjust_is_the_jax_packages(ba_problem):
    """The Schur-complement Levenberg-Marquardt solver: the same bits, and
    it reaches the noise floor."""
    out = sfm.lm_bundle_adjust(*ba_problem, iters=20)
    _equal(out, jsfm.lm_bundle_adjust(*ba_problem, iters=20))
    assert _mean_reprojection(out[0], out[1], *ba_problem[2:]) < 1e-6


def test_bundle_adjust_against_the_jax_packages(ba_problem):
    """The torch Adam bundle adjuster on the CPU against the JAX package's
    jitted optax loop at test_sfm.py's lr 3e-3: after 100 iterations (the
    loss down from 3e-5 to 6e-10) poses and points to 2e-6 and the loss
    rtol 1e-3, and the mean reprojection error cut below a fifth (test_sfm.py's
    bound). Not at test_sfm.py's 400 iterations: past 200 the loss sits at
    float32's floor (2e-14), where Adam's normalized steps follow rounding
    noise and the two runs part (by 7e-4 after 400, both at a loss of
    1e-9)."""
    before = _mean_reprojection(*ba_problem[:2], *ba_problem[2:])
    P, X, loss = sfm.bundle_adjust(*ba_problem, iters=100, lr=3e-3, device="cpu")
    P_j, X_j, loss_j = jsfm.bundle_adjust(*ba_problem, iters=100, lr=3e-3)
    assert P.dtype == X.dtype == np.float64 and P.shape == P_j.shape
    np.testing.assert_allclose(P, P_j, rtol=0, atol=2e-6)
    np.testing.assert_allclose(X, X_j, rtol=0, atol=2e-6)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-3)
    assert loss < 1e-8
    np.testing.assert_array_equal(P[0], ba_problem[0][0].astype(np.float32))   # the gauge
    assert _mean_reprojection(P, X, *ba_problem[2:]) < 0.2 * before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sfm.bundle_adjust(*ba_problem, iters=1)


# ------------------------------------------------------------- the native core

def test_native_library_is_built_under_build(native):
    path = sfm_native.LIBRARY
    assert path == os.path.join(ROOT, "build", "niw_sfm", "libniw_sfm.so")
    assert os.path.isfile(path)
    assert os.path.getmtime(path) >= os.path.getmtime(os.path.join(ROOT, "native",
                                                                   "sfm_core.cpp"))
    assert sfm._native() is sfm_native
    assert not [f for f in os.listdir(os.path.dirname(path)) if ".tmp" in f]


def test_native_core_is_the_jax_packages_build(native, two_view):
    """The port's build against the JAX package's library on the same
    inputs and seeds: the same bits from every entry point."""
    poses, intr, x1, x2 = two_view
    thresh = 2.0 / intr[0, 0, 0]
    E, inl = native.ransac_essential(x1, x2, thresh=thresh, seed=1)
    _equal((E, inl), jnative.ransac_essential(x1, x2, thresh=thresh, seed=1))
    P2, n_front = native.pose_from_essential(E, x1[inl], x2[inl])
    _equal((P2, n_front), jnative.pose_from_essential(E, x1[inl], x2[inl]))
    X = native.triangulate(np.eye(3, 4), P2, x1[inl], x2[inl])
    _equal(X, jnative.triangulate(np.eye(3, 4), P2, x1[inl], x2[inl]))
    P, inl_p = native.ransac_pnp(X, x2[inl], thresh=thresh, seed=2)
    _equal((P, inl_p), jnative.ransac_pnp(X, x2[inl], thresh=thresh, seed=2))


def test_native_route_agrees_with_the_numpy_route(native, two_view):
    """tests/test_sfm_native.py's agreement, on the port alone."""
    poses, intr, x1, x2 = two_view
    thresh = 2.0 / intr[0, 0, 0]
    E_np, inl_np = sfm.ransac_essential(x1, x2, thresh=thresh, seed=1)
    E_nat, inl_nat = native.ransac_essential(x1, x2, thresh=thresh, seed=1)
    assert (inl_np == inl_nat).mean() > 0.95
    d_np = sfm.sampson_distance(E_np, x1[inl_np], x2[inl_np]).mean()
    assert sfm.sampson_distance(E_nat, x1[inl_nat], x2[inl_nat]).mean() < max(2 * d_np, 1e-8)
    P2, n_front = native.pose_from_essential(E_nat, x1[inl_nat], x2[inl_nat])
    assert n_front > 0.9 * inl_nat.sum()
    X_np = sfm.triangulate(np.eye(3, 4), P2, x1[inl_nat][:50], x2[inl_nat][:50])
    X_nat = native.triangulate(np.eye(3, 4), P2, x1[inl_nat][:50], x2[inl_nat][:50])
    np.testing.assert_allclose(X_nat, X_np, rtol=1e-6, atol=1e-8)
    rig, intr3, pts, H, W = make_rig(3, seed=11)
    uv, vis = matchers.SyntheticGTMatcher(rig, intr3, pts, H, W, noise_px=0.0)._project(2)
    x = sfm.normalize_pixels(uv[vis][:100], intr3[2])
    P, inl = native.ransac_pnp(pts[vis][:100], x, thresh=1e-4, seed=2)
    assert inl.mean() > 0.95
    np.testing.assert_allclose(P, rig[2], atol=1e-5)
    P_np, _ = sfm.ransac_pnp(pts[vis][:100], x, thresh=1e-4, seed=2)
    np.testing.assert_allclose(P, P_np, atol=1e-5)


def test_no_native_switch_takes_the_numpy_route(numpy_route):
    assert not sfm_native.available() and sfm._native() is None


# ------------------------------------------------------------- the pipeline

def _outlier_matcher(inner):
    def matcher(i, j, img_i, img_j):
        if 5 in (i, j):   # sabotage camera 5 entirely
            return np.zeros((0, 2)), np.zeros((0, 2))
        return inner(i, j, img_i, img_j)
    return matcher


def _pipeline(pkg, case, tmp_path, **kw):
    """compute_sfm_poses of one package on tests/test_sfm.py's rigs: the
    8-camera rig, or the 6-camera one with 20% outliers and camera 5
    without matches (dumps under tmp_path)."""
    if case == "rig8":
        poses, intr, pts, H, W = make_rig(8, seed=4)
        m = pkg[1].SyntheticGTMatcher(poses, intr, pts, H, W, noise_px=0.3, seed=1)
        save_dir = None
    else:
        poses, intr, pts, H, W = make_rig(6, seed=5)
        m = _outlier_matcher(pkg[1].SyntheticGTMatcher(poses, intr, pts, H, W, noise_px=0.3,
                                                       outlier_frac=0.2, seed=2))
        save_dir = str(tmp_path)
    out = pkg[0].compute_sfm_poses([np.zeros((H, W, 3))] * len(poses), intr, matcher=m,
                                   save_dir=save_dir, **kw)
    return out, poses


@pytest.mark.parametrize("case,route,method", [
    ("rig8", "native", "incremental"), ("outliers6", "numpy", "incremental"),
    ("rig8", "native", "global")])
def test_compute_sfm_poses_is_the_jax_packages(case, route, method, tmp_path, request):
    """The same valid / excluded cameras and poses equal to 1e-9 (the
    incremental route through each package's native core or both on numpy;
    the global route's rotation averaging, translation recovery and
    known-rotation init), and the dumps."""
    if route == "numpy":
        request.getfixturevalue("numpy_route")
    else:
        request.getfixturevalue("native")
    (rec, valid, excluded), poses = _pipeline((colmap_init, matchers), case, tmp_path / "port",
                                              method=method)
    (rec_j, valid_j, excluded_j), _ = _pipeline((jcolmap_init, jmatchers), case,
                                                tmp_path / "jax", method=method)
    assert (valid, excluded) == (valid_j, excluded_j)
    assert rec.dtype == np.float32 and rec.shape == (len(poses), 3, 4)
    np.testing.assert_allclose(rec, rec_j, rtol=0, atol=1e-9)
    if case == "rig8":
        assert valid == list(range(8)) and excluded == []
    else:
        assert valid == [0, 1, 2, 3, 4] and excluded == [5]
        np.testing.assert_array_equal(rec[5], np.eye(3, 4, dtype=np.float32))
        for name in ("matches.npz", "initial_poses.npz"):
            got, ref = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
            assert sorted(got.files) == sorted(ref.files)
            for k in ref.files:
                np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("method", ["incremental", "global"])
def test_stage_seconds_time_the_pipeline_and_change_nothing(method, native, tmp_path):
    """Under ``sfm.stage_seconds`` every matcher call is one entry of
    ``matching`` (the 28 exhaustive pairs of 8 views), each stage of the
    route is entered, the stages' exclusive seconds add up to no more than
    the wall time, and the poses are those of a run outside the clock."""
    (rec, valid, excluded), _ = _pipeline((colmap_init, matchers), "rig8", tmp_path,
                                          method=method)
    t0 = time.perf_counter()
    with sfm.stage_seconds() as stages:
        (rec_t, valid_t, excluded_t), _ = _pipeline((colmap_init, matchers), "rig8", tmp_path,
                                                    method=method)
    wall = time.perf_counter() - t0
    assert sfm._clock is None and sfm._nested == []
    route = {"incremental"} if method == "incremental" else {
        "global", "rotation_averaging", "center_init"}
    assert set(stages) == {"matching", "verify_and_track", "triangulation",
                           "bundle_adjustment"} | route
    assert len(stages["matching"]) == 28
    assert min(min(v) for v in stages.values()) >= 0.0
    assert sum(sum(v) for v in stages.values()) <= wall
    assert (valid_t, excluded_t) == (valid, excluded)
    np.testing.assert_array_equal(rec_t, rec)


def test_named_matchers_resolve_on_the_callers_device(tmp_path):
    """``zncc`` is the port's ZnccMatcher on the device asked for; ``pdcnet``
    with ``weights_path`` a PdcNetMatcher there on the checkpoint's weights,
    and without weights it raises as the JAX package's does; a callable
    passes through."""
    from neural_invertible_warp_tpu_torch.ops.pdcnet.pdcnet import PDCNet
    m = colmap_init.get_matcher("zncc", device="cpu")
    assert isinstance(m, matchers.ZnccMatcher) and m.device == torch.device("cpu")
    net = PDCNet(torch.Generator().manual_seed(3))
    torch.save({"state_dict": net.state_dict()}, tmp_path / "pdcnet.pth.tar")
    m = colmap_init.get_matcher("pdcnet", device="cpu",
                                weights_path=str(tmp_path / "pdcnet.pth.tar"))
    assert isinstance(m, matchers.PdcNetMatcher) and m.device == torch.device("cpu")
    for (name, a), b in zip(net.state_dict().items(), m.module.state_dict().values()):
        assert torch.equal(a, b), name
    with pytest.raises(RuntimeError, match="weights"):
        colmap_init.get_matcher("pdcnet", device="cpu")
    with pytest.raises(RuntimeError, match="weights"):
        jcolmap_init.get_matcher("pdcnet")
    with pytest.raises(ValueError, match="unknown sfm matcher"):
        colmap_init.get_matcher("sift")
    assert colmap_init.get_matcher(len) is len
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            colmap_init.get_matcher("zncc")


# --------------------------------------------- geometry_np and ops/epipolar

def test_geometry_np_is_the_jax_packages():
    rng = np.random.RandomState(0)
    _equal(gnp.get_absolute_coordinates(4, 5), jgnp.get_absolute_coordinates(4, 5))
    angles = [0.1, -0.2, 0.3]
    _equal(gnp.angles2rotation_matrix(angles), jgnp.angles2rotation_matrix(angles))
    K = np.array([[100.0, 0, 50], [0, 120, 40], [0, 0, 1]])
    for inv in (True, False):
        _equal(gnp.scale_intrinsics(K, (2.0, 0.5), invert_scales=inv),
               jgnp.scale_intrinsics(K, (2.0, 0.5), invert_scales=inv))
    kpi = rng.rand(20, 2) * [100, 80]
    di = 2.0 + rng.rand(20)
    T = np.eye(4)
    T[:3, :3] = gnp.angles2rotation_matrix([0.05, 0.1, -0.07])
    T[:3, 3] = [0.2, -0.1, 0.3]
    _equal(gnp.to_homogeneous(kpi), jgnp.to_homogeneous(kpi))
    _equal(gnp.from_homogeneous(kpi), jgnp.from_homogeneous(kpi))
    _equal(gnp.backproject_to_3d(kpi, di, K, T_itoj=T), jgnp.backproject_to_3d(kpi, di, K, T_itoj=T))
    X = gnp.backproject_to_3d(kpi, di, K)
    _equal(gnp.project(X, T, K), jgnp.project(X, T, K))
    R2 = gnp.angles2rotation_matrix([0.0, 0.02, 0.01])
    _equal(gnp.angle_error_mat(T[:3, :3], R2), jgnp.angle_error_mat(T[:3, :3], R2))
    _equal(gnp.angle_error_vec(kpi[0], kpi[1]), jgnp.angle_error_vec(kpi[0], kpi[1]))
    for t in (T[:3, 3], -T[:3, 3], T[:3, 3] + 0.1):
        _equal(gnp.compute_pose_error(T, R2, t), jgnp.compute_pose_error(T, R2, t))


def _epipolar_inputs():
    """tests/test_epipolar.py's inputs, with a rotation in T and a depth map
    that agrees with half of the points."""
    rng = np.random.RandomState(0)
    B, N = 2, 40
    K = np.tile(np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]], np.float32), (B, 1, 1))
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3] = jgnp.angles2rotation_matrix([0.02, -0.03, 0.01])
    T[:, 0, 3] = 0.1
    kpi = rng.rand(B, N, 2).astype(np.float32) * np.array([64, 48], np.float32)
    di = (rng.rand(B, N).astype(np.float32) + 1.0) * 2
    depthj = (rng.rand(B, 48, 64).astype(np.float32) + 1.0) * 2
    validi = rng.rand(B, N) > 0.2
    return K, T, kpi, di, depthj, validi


def test_epipolar_projection_against_jnp():
    """batch_project_to_other_img (with its depths), the depth-map lookup
    and the depth check in torch against jnp, float32 both: rtol 1e-5; the
    lookups and masks equal."""
    K, T, kpi, di, depthj, validi = _epipolar_inputs()
    t = [torch.tensor(a) for a in (kpi, di, K, K, T)]
    j = [jnp.asarray(a) for a in (kpi, di, K, K, T)]
    kpj, dj = epipolar.batch_project_to_other_img(*t, return_depth=True)
    kpj_j, dj_j = jepipolar.batch_project_to_other_img(*j, return_depth=True)
    np.testing.assert_allclose(kpj.numpy(), np.asarray(kpj_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(dj.numpy(), np.asarray(dj_j), rtol=1e-5)
    np.testing.assert_allclose(epipolar.batch_project_to_other_img(*t).numpy(),
                               np.asarray(jepipolar.batch_project_to_other_img(*j)),
                               rtol=1e-5, atol=1e-4)
    d, ok = epipolar.sample_depth_map(kpj, torch.tensor(depthj))
    d_j, ok_j = jepipolar.sample_depth_map(kpj_j, jnp.asarray(depthj))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    assert 0 < ok.numpy().mean() < 1                # some land outside image j
    # a depth map that agrees with the projected depths where it is written
    d_proj = dj.numpy()
    depth_ok = depthj.copy()
    x = np.clip(np.round(kpj_j[..., 0]).astype(int), 0, 63)
    y = np.clip(np.round(kpj_j[..., 1]).astype(int), 0, 47)
    for b in range(2):
        depth_ok[b, y[b, ::2], x[b, ::2]] = d_proj[b, ::2]
    for dm in (depthj, depth_ok):
        kp, vis, err = epipolar.batch_project_to_other_img_and_check_depth(
            *t[:2], torch.tensor(dm), *t[2:], torch.tensor(validi), return_repro_error=True)
        kp_j, vis_j, err_j = jepipolar.batch_project_to_other_img_and_check_depth(
            *j[:2], jnp.asarray(dm), *j[2:], jnp.asarray(validi), return_repro_error=True)
        np.testing.assert_allclose(kp.numpy(), np.asarray(kp_j), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(err.numpy(), np.asarray(err_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(vis.numpy(), np.asarray(vis_j))
    assert vis.numpy().mean() > 0.2
    _, vis_none = epipolar.batch_project_to_other_img_and_check_depth(
        *t[:2], torch.tensor(depthj) * 50.0, *t[2:], torch.tensor(validi))
    assert not vis_none.numpy().any()
