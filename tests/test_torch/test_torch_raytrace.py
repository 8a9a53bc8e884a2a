"""Agreement of the port's ray-mesh intersection (utils/raytrace.py) and
2D line math (core/line.py) with the JAX package's, at 1e-10 in float64.

intersect_rays_mesh ranks every (ray, triangle) pair and picks the
first minimum; for a ray with no hit both packages report triangle 0
with a false mask, and its point and distance are whatever that
triangle's t gives.  So the mask is compared everywhere, and the point,
normal and distance only where it is true.  Every intersection call has
the one shape (RAYS, TRIANGLES), so the JAX side compiles once for each
test_both_directions setting.  The reference's own raytrace and line
cases run on the port too.
"""

import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.core.line as t_line
import mayamatchmovesolver_torch.utils.raytrace as t_raytrace
import mayamatchmovesolver_tpu.core.line as j_line
import mayamatchmovesolver_tpu.utils.raytrace as j_raytrace
from _torch_port_cases import to_numpy
from _torch_reference_cases import port_cases

TOL = 1e-10
RAYS, TRIANGLES = 48, 30


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(seed):
    """TRIANGLES seeded triangles: a 5 x 3 grid of quads on the plane
    z = -4 (tilted by the seed), so rays toward -z hit, rays beside it
    miss, and rays along the plane run parallel to every face."""
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.linspace(-2.5, 2.5, 6), np.linspace(-1.5, 1.5, 4))
    vertices = np.stack([xs.ravel(), ys.ravel(),
                         -4.0 + 0.2 * rng.uniform(-1, 1) * xs.ravel()],
                        axis=-1)
    vertices[:, :2] += rng.uniform(-0.05, 0.05, (vertices.shape[0], 2))
    return vertices, _mesh_triangles()


def _mesh_triangles():
    triangles = []
    for r in range(3):
        for c in range(5):
            a, b = r * 6 + c, r * 6 + c + 1
            triangles += [[a, b, b + 6], [a, b + 6, a + 6]]
    return np.asarray(triangles, np.int32)


def _rays(seed, vertices):
    """RAYS rays: toward the mesh from in front, from behind it (hits only
    with test_both_directions), beside it (misses), parallel to a face,
    and some just inside an edge."""
    rng = np.random.RandomState(seed)
    n = RAYS // 6
    front = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n),
                      np.full(n, 3.0)], -1)
    behind = front * [1, 1, -3]
    beside = front + [8.0, 0, 0]
    origins = np.concatenate([front, behind, beside, front, front, front])
    to_mesh = np.stack([rng.uniform(-0.2, 0.2, n), rng.uniform(-0.2, 0.2, n),
                        -np.ones(n)], -1)
    # Points 1e-6 inside an edge of a triangle (an exact edge or vertex
    # is a tie that round-off decides, in either package).
    tri = _mesh_triangles()[rng.randint(0, TRIANGLES, n)]
    v0, v1, v2 = (vertices[tri[:, k]] for k in range(3))
    u, v = rng.uniform(1e-6, 2e-6, n), rng.uniform(0.2, 0.8, n)
    edge = (v0 + u[:, None] * (v1 - v0) + v[:, None] * (v2 - v0)) - front
    along_plane = np.stack([np.ones(n), rng.uniform(-1, 1, n), np.zeros(n)],
                           -1)
    parallel_origin = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n),
                                np.full(n, -4.0)], -1)
    origins[4 * n:5 * n] = parallel_origin
    directions = np.concatenate([to_mesh, to_mesh, to_mesh, edge,
                                 along_plane, 3.0 * to_mesh])
    return origins, directions


@pytest.mark.parametrize("max_dist", [9999.9, 5.0, np.inf],
                         ids=["default", "short", "inf"])
@pytest.mark.parametrize("both", [False, True], ids=["forward", "both"])
@pytest.mark.parametrize("seed", [0, 1])
def test_intersect_rays_mesh_matches(seed, both, max_dist):
    vertices, triangles = _mesh(seed)
    origins, directions = _rays(seed + 10, vertices)
    want = j_raytrace.intersect_rays_mesh(
        origins, directions, vertices, triangles, max_dist=max_dist,
        test_both_directions=both)
    got = t_raytrace.intersect_rays_mesh(
        torch.as_tensor(origins), torch.as_tensor(directions), vertices,
        triangles, max_dist=max_dist, test_both_directions=both)
    assert got[0].dtype == torch.float64
    mask = np.asarray(want[3])
    np.testing.assert_array_equal(to_numpy(got[3]), mask)
    assert 0 < mask.sum() < RAYS
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(to_numpy(g)[mask], np.asarray(w)[mask],
                                   rtol=0, atol=TOL)


def test_intersect_rays_mesh_from_arrays_and_lists():
    """No tensor argument: float64 on the CPU, as the reference under
    x64; a single ray as a flat list."""
    vertices, triangles = _mesh(2)
    got = t_raytrace.intersect_rays_mesh([0.3, 0.2, 3.0], [0.0, 0.0, -1.0],
                                         vertices.tolist(), triangles)
    want = j_raytrace.intersect_rays_mesh(
        np.array([0.3, 0.2, 3.0]), np.array([0.0, 0.0, -1.0]), vertices,
        triangles)
    assert got[0].dtype == torch.float64 and got[0].device.type == "cpu"
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("both", [False, True], ids=["forward", "both"])
def test_closest_intersect_matches(both):
    vertices, triangles = _mesh(3)
    for point, direction in (([0.1, 0.2, 3.0], [0, 0, -1.0]),
                             ([0.1, 0.2, -9.0], [0, 0, -1.0]),
                             ([9.0, 9.0, 3.0], [0, 0, -1.0])):
        want = j_raytrace.closest_intersect(point, direction, vertices,
                                            triangles,
                                            test_both_directions=both)
        got = t_raytrace.closest_intersect(point, direction, vertices,
                                           triangles,
                                           test_both_directions=both)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                       rtol=0, atol=TOL)
        want = j_raytrace.closest_intersect_with_normal(
            point, direction, vertices, triangles,
            test_both_directions=both)
        got = t_raytrace.closest_intersect_with_normal(
            point, direction, vertices, triangles,
            test_both_directions=both)
        assert (got[0] is None) == (want[0] is None)
        if want[0] is None:
            assert got == (None, None)
            continue
        for g, w in zip(got, want):
            np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=0,
                                       atol=TOL)


@pytest.mark.parametrize("case", port_cases(
    "tests/test_utils/test_misc_utils.py",
    ("test_raytrace_hit_and_miss", "test_raytrace_normal_and_batch")))
def test_reference_raytrace_case_on_the_port(case):
    case()


def _points(seed, batch=(3, 4), n=9):
    rng = np.random.RandomState(seed)
    return rng.normal(0.0, 1.0, batch + (n,)), rng.normal(0.0, 1.0,
                                                         batch + (n,))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_line_to_points_matches(seed):
    x, y = _points(seed)
    y = y * 0.1 + x * (seed - 1.0)  # steep, flat and negative slopes
    want = j_line.fit_line_to_points(x, y)
    got = t_line.fit_line_to_points(torch.as_tensor(x), torch.as_tensor(y))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=0,
                                   atol=TOL)
    # Lists of Python floats: float64, as under the reference's x64.
    got = t_line.fit_line_to_points(x[0, 0].tolist(), y[0, 0].tolist())
    assert got[0].dtype == torch.float64
    np.testing.assert_allclose(to_numpy(got[2]), np.asarray(want[2])[0, 0],
                               rtol=0, atol=TOL)


def test_line_point_intersection_matches():
    rng = np.random.RandomState(4)
    point, a, b = (rng.normal(0.0, 2.0, (5, 6, 2)) for _ in range(3))
    b[0, 0] = a[0, 0]  # a degenerate segment: the clamped denominator
    want = j_line.line_point_intersection(point, a, b)
    got = t_line.line_point_intersection(
        torch.as_tensor(point), torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                               atol=TOL)


def test_line_line_intersection_matches():
    rng = np.random.RandomState(5)
    p1, d1, p2, d2 = (rng.normal(0.0, 1.0, (7, 2)) for _ in range(4))
    d2[0] = 2.5 * d1[0]  # a parallel pair
    d2[1] = -d1[1]  # an anti-parallel pair
    want, want_parallel = j_line.line_line_intersection(p1, d1, p2, d2)
    got, parallel = t_line.line_line_intersection(
        *(torch.as_tensor(v) for v in (p1, d1, p2, d2)))
    np.testing.assert_array_equal(to_numpy(parallel),
                                  np.asarray(want_parallel))
    assert to_numpy(parallel)[:2].all() and not to_numpy(parallel)[2:].any()
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("case", port_cases(
    "tests/test_core/test_line_reproject.py",
    ("test_fit_line_to_points", "test_line_point_intersection",
     "test_line_line_intersection")))
def test_reference_line_case_on_the_port(case):
    case()
