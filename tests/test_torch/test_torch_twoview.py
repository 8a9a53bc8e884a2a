"""Agreement of the port's two-view geometry with the JAX package.

The same numpy-seeded correspondences go through both packages in
float64.  The JAX package takes its null spaces from Jacobi sweeps, the
port from torch.linalg.eigh: eigenvector signs differ, and inside the
repeated eigenvalue of an essential matrix the basis is arbitrary.  So
what is compared is what does not depend on them, at 1e-8: an essential
matrix up to its sign, points, homographies (normalized by h22), poses
(sign fixed by depth votes), errors.  The robust estimators are fed the
JAX package's own draws (its jax.random calls, in _torch_port_cases) and
must return the same inliers; with the port's own generator they repeat
for a seed and recover the true pose under 20 % gross outliers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.sfm.twoview as t_tv
import mayamatchmovesolver_torch.solver.linalg as t_linalg
import mayamatchmovesolver_tpu.sfm.twoview as j_tv
import mayamatchmovesolver_tpu.solver.linalg as j_linalg
from _torch_port_cases import (
    jax_relative_pose_draws,
    jax_resection_draws,
    to_numpy,
)
from mayamatchmovesolver_tpu.core.transform import euler_to_rotation_matrix

TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _two_views(seed=0, n=40, outliers=0):
    """World points in front of two cameras [I|0] and [R|t] (|t| = 1),
    their normalized projections, and gross outliers in the first
    `outliers` correspondences of view 2."""
    rng = np.random.RandomState(seed)
    x = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 9, n)], -1)
    r = np.asarray(euler_to_rotation_matrix(
        jnp.asarray(3.0), jnp.asarray(-8.0), jnp.asarray(2.0), 0))
    t = np.array([0.9, 0.1, 0.2])
    t /= np.linalg.norm(t)
    x2 = x @ r.T + t
    pts1 = x[:, :2] / x[:, 2:]
    pts2 = x2[:, :2] / x2[:, 2:]
    pts2[:outliers] = rng.uniform(-0.5, 0.5, (outliers, 2))
    return dict(x=x, r=r, t=t, pts1=pts1, pts2=pts2)


def _t(a):
    return torch.as_tensor(np.array(a))


def _same_up_to_sign(got, want, tol=TOL):
    """Arrays equal up to one sign per matrix (or vector) of the batch."""
    got, want = to_numpy(got), np.asarray(want)
    assert got.shape == want.shape
    lead = got.shape[:-2] if got.ndim > 1 else ()
    g = got.reshape((-1,) + got.shape[len(lead):])
    w = want.reshape(g.shape)
    for gi, wi in zip(g, w):
        sign = np.sign(np.sum(gi * wi))
        np.testing.assert_allclose(gi * sign, wi, atol=tol)


@pytest.fixture(scope="module")
def views():
    return _two_views()


def test_linalg_matches_up_to_sign():
    rng = np.random.RandomState(1)
    a = rng.normal(size=(6, 12, 5))
    ata = np.swapaxes(a, -1, -2) @ a
    j_w, j_v = j_linalg.jacobi_eigh(jnp.asarray(ata))
    t_w, t_v = t_linalg.eigh(_t(ata))
    np.testing.assert_allclose(to_numpy(t_w), np.asarray(j_w), atol=1e-10)
    assert bool((t_w[..., 1:] >= t_w[..., :-1]).all())
    for k in range(5):
        _same_up_to_sign(t_v[..., :, k][..., None], j_v[..., :, k][..., None])
    _same_up_to_sign(
        t_linalg.smallest_eigenvector(_t(ata))[..., None],
        j_linalg.smallest_eigenvector(jnp.asarray(ata))[..., None])
    m = rng.normal(size=(7, 3, 3))
    m[3] *= -1.0
    np.testing.assert_allclose(to_numpy(t_linalg.det3(_t(m))),
                               np.asarray(j_linalg.det3(jnp.asarray(m))),
                               atol=1e-12)
    rot = t_linalg.svd3_rotation(_t(m))
    np.testing.assert_allclose(
        to_numpy(rot), np.asarray(j_linalg.svd3_rotation(jnp.asarray(m))),
        atol=TOL)
    np.testing.assert_allclose(to_numpy(t_linalg.det3(rot)), 1.0, atol=1e-10)


def test_eigh_of_a_non_finite_matrix_is_nan_not_an_error():
    a = torch.eye(3, dtype=torch.float64).repeat(2, 1, 1)
    a[1, 0, 0] = float("nan")
    w, v = t_linalg.eigh(a)
    assert bool(w[0].isfinite().all()) and bool(v[0].isfinite().all())
    assert bool(w[1].isnan().all()) and bool(v[1].isnan().all())


@pytest.mark.parametrize("batched", [False, True])
def test_eight_point_essential_matches(views, batched):
    pts1, pts2 = views["pts1"], views["pts2"]
    if batched:
        idx = np.random.RandomState(2).randint(0, len(pts1), (5, 10))
        pts1, pts2 = pts1[idx], pts2[idx]
    want = j_tv.eight_point_essential(jnp.asarray(pts1), jnp.asarray(pts2))
    got = t_tv.eight_point_essential(_t(pts1), _t(pts2))
    _same_up_to_sign(got, want)
    if not batched:
        # The true essential matrix [t]x R, up to scale and sign.
        tx = np.cross(np.eye(3), views["t"]).T
        truth = tx @ views["r"]
        g = to_numpy(got)
        _same_up_to_sign(g / np.linalg.norm(g),
                         truth / np.linalg.norm(truth), tol=1e-7)


def test_project_to_essential_matches():
    e = np.random.RandomState(3).normal(size=(4, 3, 3))
    want = np.asarray(j_tv.project_to_essential(jnp.asarray(e)))
    got = to_numpy(t_tv.project_to_essential(_t(e)))
    np.testing.assert_allclose(got, want, atol=TOL)
    s = np.linalg.svd(got, compute_uv=False)
    np.testing.assert_allclose(s[:, 0], s[:, 1], atol=1e-10)
    np.testing.assert_allclose(s[:, 2], 0.0, atol=1e-10)


def test_sampson_error_matches(views):
    es = np.random.RandomState(4).normal(size=(3, 3, 3))
    want = j_tv.sampson_error(jnp.asarray(es), jnp.asarray(views["pts1"]),
                              jnp.asarray(views["pts2"]))
    got = t_tv.sampson_error(_t(es), _t(views["pts1"]), _t(views["pts2"]))
    assert got.shape == (3, 40)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-10,
                               atol=1e-14)


def test_triangulate_linear_matches_and_recovers_the_points(views):
    args = (np.eye(3), np.zeros(3), views["r"], views["t"], views["pts1"],
            views["pts2"])
    want = j_tv.triangulate_linear(*[jnp.asarray(a) for a in args])
    got = t_tv.triangulate_linear(*[_t(a) for a in args])
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(to_numpy(got), views["x"], atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_decompose_essential_matches_and_recovers_the_pose(views, masked):
    e = np.asarray(j_tv.eight_point_essential(
        jnp.asarray(views["pts1"]), jnp.asarray(views["pts2"])))
    mask = None
    if masked:
        mask = np.arange(40) % 3 != 0
    j_r, j_t = j_tv.decompose_essential(
        jnp.asarray(e), jnp.asarray(views["pts1"]),
        jnp.asarray(views["pts2"]),
        None if mask is None else jnp.asarray(mask))
    t_r, t_t = t_tv.decompose_essential(
        _t(e), _t(views["pts1"]), _t(views["pts2"]),
        None if mask is None else _t(mask))
    np.testing.assert_allclose(to_numpy(t_r), np.asarray(j_r), atol=TOL)
    np.testing.assert_allclose(to_numpy(t_t), np.asarray(j_t), atol=TOL)
    np.testing.assert_allclose(to_numpy(t_r), views["r"], atol=1e-7)
    np.testing.assert_allclose(to_numpy(t_t), views["t"], atol=1e-7)
    # The same pose from the matrix with the other sign.
    n_r, n_t = t_tv.decompose_essential(
        _t(-e), _t(views["pts1"]), _t(views["pts2"]))
    np.testing.assert_allclose(to_numpy(n_r), to_numpy(t_r), atol=TOL)
    np.testing.assert_allclose(to_numpy(n_t), to_numpy(t_t), atol=TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_estimate_homography_matches(weighted):
    rng = np.random.RandomState(5)
    pts1 = rng.uniform(-0.5, 0.5, (20, 2))
    h_true = np.array([[1.1, 0.05, 0.02], [-0.04, 0.95, -0.03],
                       [0.1, -0.05, 1.0]])
    p = np.concatenate([pts1, np.ones((20, 1))], -1) @ h_true.T
    pts2 = p[:, :2] / p[:, 2:]
    weights = None
    if weighted:
        weights = np.ones(20)
        weights[:5] = 0.0
        pts2[:5] += rng.uniform(-0.3, 0.3, (5, 2))
    want = j_tv.estimate_homography(
        jnp.asarray(pts1), jnp.asarray(pts2),
        None if weights is None else jnp.asarray(weights))
    got = t_tv.estimate_homography(
        _t(pts1), _t(pts2), None if weights is None else _t(weights))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(to_numpy(got), h_true, atol=1e-7)
    err_j = j_tv.homography_transfer_error(
        want, jnp.asarray(pts1), jnp.asarray(pts2))
    err_t = t_tv.homography_transfer_error(got, _t(pts1), _t(pts2))
    np.testing.assert_allclose(to_numpy(err_t), np.asarray(err_j), atol=TOL)
    assert float(err_t[5:].max()) < 1e-12


@pytest.mark.parametrize("weighted", [False, True])
def test_resection_pose_matches_and_recovers_the_pose(views, weighted):
    x, pts2 = views["x"], views["pts2"].copy()
    weights = None
    if weighted:
        weights = np.ones(40)
        weights[::4] = 0.0
        pts2[::4] = 0.3
    j_r, j_t = j_tv.resection_pose(
        jnp.asarray(x), jnp.asarray(pts2),
        None if weights is None else jnp.asarray(weights))
    t_r, t_t = t_tv.resection_pose(
        _t(x), _t(pts2), None if weights is None else _t(weights))
    np.testing.assert_allclose(to_numpy(t_r), np.asarray(j_r), atol=TOL)
    np.testing.assert_allclose(to_numpy(t_t), np.asarray(j_t), atol=TOL)
    np.testing.assert_allclose(to_numpy(t_r), views["r"], atol=1e-7)
    np.testing.assert_allclose(to_numpy(t_t), views["t"], atol=1e-7)


def test_resection_pose_broadcasts_one_point_set_over_frames(views):
    """One (N, 3) point set against (F, N, 2) observations with (F, N)
    weights is the batch of single resections; a frame with no
    observation gives NaN and raises nothing."""
    x = _t(views["x"])
    obs = torch.stack([_t(views["pts1"]), _t(views["pts2"]),
                       _t(views["pts2"])])
    weights = torch.ones(3, 40, dtype=torch.float64)
    weights[2] = 0.0
    rs, ts = t_tv.resection_pose(x, obs, weights=weights)
    assert rs.shape == (3, 3, 3) and ts.shape == (3, 3)
    for f in range(2):
        r, t = t_tv.resection_pose(x, obs[f], weights=weights[f])
        np.testing.assert_allclose(to_numpy(rs[f]), to_numpy(r), atol=1e-12)
        np.testing.assert_allclose(to_numpy(ts[f]), to_numpy(t), atol=1e-12)
    np.testing.assert_allclose(to_numpy(rs[0]), np.eye(3), atol=1e-7)
    assert not bool(rs[2].isfinite().any())


def test_reprojection_error_sq_matches(views):
    x = views["x"].copy()
    x[:3, 2] = -5.0  # behind both cameras
    rs = np.stack([np.eye(3), views["r"]])
    ts = np.stack([np.zeros(3), views["t"]])
    want = np.asarray(j_tv.reprojection_error_sq(
        jnp.asarray(rs), jnp.asarray(ts), jnp.asarray(x),
        jnp.asarray(views["pts2"])))
    got = to_numpy(t_tv.reprojection_error_sq(
        _t(rs), _t(ts), _t(x), _t(views["pts2"])))
    assert got.shape == (2, 40) and np.all(np.isinf(got[:, :3]))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-10,
                               atol=1e-14)


def _assert_pose(got, want, fields):
    for field in fields:
        g, w = to_numpy(getattr(got, field)), np.asarray(getattr(want, field))
        if w.dtype == bool or w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=field)
        elif field == "essential":
            _same_up_to_sign(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=TOL, err_msg=field)


def test_robust_relative_pose_with_the_jax_draws_matches():
    v = _two_views(seed=6, n=40, outliers=8)
    key = jax.random.PRNGKey(7)
    kw = dict(num_hypotheses=48, sample_size=8, inlier_threshold=1e-6)
    want = jax.jit(lambda a, b, k: j_tv.robust_relative_pose(
        a, b, key=k, **kw))(jnp.asarray(v["pts1"]), jnp.asarray(v["pts2"]),
                            key)
    draws = np.array(jax_relative_pose_draws(key, 40, 48, 8))
    got = t_tv.robust_relative_pose(_t(v["pts1"]), _t(v["pts2"]),
                                    sample_indices=draws, **kw)
    _assert_pose(got, want, want._fields)
    np.testing.assert_array_equal(to_numpy(got.inliers), np.arange(40) >= 8)
    np.testing.assert_allclose(to_numpy(got.rotation), v["r"], atol=1e-7)
    np.testing.assert_allclose(to_numpy(got.translation), v["t"], atol=1e-7)


def test_robust_resection_pose_with_the_jax_draws_matches():
    v = _two_views(seed=8, n=40, outliers=6)
    weights = np.ones(40)
    weights[10:16] = 0.0
    key = jax.random.PRNGKey(9)
    kw = dict(num_hypotheses=32, sample_size=6, inlier_threshold=1e-6)
    want = jax.jit(lambda p3, p2, w, k: j_tv.robust_resection_pose(
        p3, p2, key=k, weights=w, **kw))(
            jnp.asarray(v["x"]), jnp.asarray(v["pts2"]),
            jnp.asarray(weights), key)
    draws = np.array(jax_resection_draws(key, jnp.asarray(weights), 32, 6))
    assert not np.isin(draws, np.arange(10, 16)).any()
    got = t_tv.robust_resection_pose(
        _t(v["x"]), _t(v["pts2"]), weights=_t(weights),
        sample_indices=draws, **kw)
    _assert_pose(got, want, want._fields)
    expected = (np.arange(40) >= 6) & (weights > 0)
    np.testing.assert_array_equal(to_numpy(got.inliers), expected)
    np.testing.assert_allclose(to_numpy(got.rotation), v["r"], atol=1e-7)
    np.testing.assert_allclose(to_numpy(got.translation), v["t"], atol=1e-7)


def test_draw_samples_never_draws_a_zero_weight_and_repeats_for_a_seed():
    weights = np.ones(30)
    weights[::3] = 0.0
    draws = [t_tv.draw_samples(30, 64, 6, torch.Generator().manual_seed(s),
                               weights) for s in (5, 5, 6)]
    assert draws[0].shape == (64, 6) and draws[0].dtype == torch.int64
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert not np.isin(to_numpy(draws[0]), np.arange(0, 30, 3)).any()
    assert all(len(set(row.tolist())) == 6 for row in draws[0])
    uniform = t_tv.draw_samples(30, 256, 8, torch.Generator().manual_seed(1))
    assert set(uniform.reshape(-1).tolist()) == set(range(30))


@pytest.mark.parametrize("estimator", ["relative", "resection"])
def test_robust_poses_with_the_ports_generator(estimator):
    """20 % gross outliers: the same result for the same seed (also with
    no generator: a CPU generator seeded 0), the true pose recovered."""
    v = _two_views(seed=10, n=50, outliers=10)

    def run(generator):
        if estimator == "relative":
            return t_tv.robust_relative_pose(
                _t(v["pts1"]), _t(v["pts2"]), generator=generator,
                num_hypotheses=128, inlier_threshold=1e-6)
        return t_tv.robust_resection_pose(
            _t(v["x"]), _t(v["pts2"]), generator=generator,
            num_hypotheses=64, inlier_threshold=1e-6)

    first = run(torch.Generator().manual_seed(3))
    again = run(torch.Generator().manual_seed(3))
    default = run(None)
    seeded_0 = run(torch.Generator().manual_seed(0))
    for field in ("rotation", "translation", "inliers"):
        assert torch.equal(getattr(first, field), getattr(again, field))
        assert torch.equal(getattr(default, field), getattr(seeded_0, field))
    assert int(first.num_inliers) == 40
    np.testing.assert_array_equal(to_numpy(first.inliers),
                                  np.arange(50) >= 10)
    np.testing.assert_allclose(to_numpy(first.rotation), v["r"], atol=1e-6)
    np.testing.assert_allclose(to_numpy(first.translation), v["t"],
                               atol=1e-6)
