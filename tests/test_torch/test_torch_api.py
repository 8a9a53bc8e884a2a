"""Agreement of the port's Collection API with the JAX package.

Frame, Lens and Collection behave alike; validate gives the same
messages; execute returns early with the reference's wording for every
refusal, restricts the solve to the collection's markers, drops locked
and unused attributes, carries stiffness, smoothness and lines into the
solve, keeps last_results, and a whole SolverStandard run (automatic
roots, root pass, per-frame pass, global pass) lands on the same
attributes at 1e-8, float64 on the CPU.
"""

import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.api as t_api
import mayamatchmovesolver_tpu.api as j_api
from _torch_port_cases import PACKAGES, to_numpy
from mayamatchmovesolver_tpu.core.constants import FilmFit

TOL = 1e-8
APIS = {"jax": j_api, "torch": t_api}
FRAMES = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _execute(pkg, col, **kw):
    if pkg == "torch":
        return t_api.execute(col, device="cpu", **kw)
    return j_api.execute(col, **kw)


def _graph(pkg, lens=True):
    """A tracked shot through a classic lens, built through the API of
    `pkg`: 8 frames, 7 bundles (the last seen by no collection marker
    unless asked), exact marker tracks, then the camera's tx and ry, the
    focal length and the distortion moved off the truth."""
    api = APIS[pkg]
    _, lens_mod = PACKAGES[pkg]
    rng = np.random.RandomState(6)
    n = FRAMES
    sg = api.SceneGraph(frame_range=(1, n))
    cam = sg.create_camera(
        "cam", film_fit=FilmFit.HORIZONTAL, render_width=1920,
        render_height=1080, tx=np.linspace(-3, 3, n),
        ty=1.5 + 0.3 * np.sin(np.linspace(0, 6, n)),
        tz=12.0 + np.linspace(0, 2, n), rx=2.0 * np.sin(np.linspace(0, 3, n)),
        ry=np.linspace(-8, 8, n), rz=np.zeros(n), focal_length_mm=35.0)
    if lens:
        lens_mod.attach_lens(sg, cam, lens_mod.LENS_MODEL_CLASSIC,
                             distortion=0.08)
    bundles = [sg.create_bundle("b%d" % i, tx=rng.uniform(-5, 5),
                                ty=rng.uniform(-2, 4),
                                tz=rng.uniform(-14, -6)) for i in range(7)]
    markers = [sg.create_marker("m%d" % i, camera=cam, bundle=b,
                                tx=np.zeros(n), ty=np.zeros(n))
               for i, b in enumerate(bundles)]
    # Exact tracks from the package's own evaluate and lens.
    if pkg == "torch":
        from mayamatchmovesolver_torch.scene import flatscene as fs
        scene, attrs = sg.bake(device="cpu")
        fi = torch.arange(n)
        pts = fs.evaluate(scene, attrs, fi).point_xy
        if lens:
            baked = lens_mod.bake_scene_lens(sg, device="cpu")
            pts = lens_mod.apply_scene_lens(baked, scene, attrs, fi, pts,
                                            scene.mkr_cam_index)
        fsx, fsy = fs.marker_fit_scale(scene, attrs, fi)
    else:
        import jax.numpy as jnp
        from mayamatchmovesolver_tpu.scene import flatscene as fs
        scene, attrs = sg.bake()
        fi = jnp.arange(n)
        pts = fs.evaluate_jit(scene, attrs, fi).point_xy
        if lens:
            baked = lens_mod.bake_scene_lens(sg)
            pts = lens_mod.apply_scene_lens(baked, scene, attrs, fi, pts,
                                            scene.mkr_cam_index)
        fsx, fsy = fs.marker_fit_scale(scene, attrs, fi)
    pts, fsx, fsy = to_numpy(pts), to_numpy(fsx), to_numpy(fsy)
    for i, m in enumerate(markers):
        sg.set_value(m.attr("tx"), pts[i, :, 0] / fsx[i])
        sg.set_value(m.attr("ty"), pts[i, :, 1] / fsy[i])
    sg.set_value(cam.attr("tx"), np.linspace(-3, 3, n) + 0.1)
    sg.set_value(cam.attr("ry"), np.linspace(-8, 8, n) - 0.8)
    sg.set_value(cam.attr("focal_length_mm"), 36.5)
    if lens:
        sg.set_value(cam.attr("lens_distortion"), 0.05)
    return sg, cam, bundles, markers


def _collection(pkg, solver=None, lens=True, markers=slice(0, 6)):
    api = APIS[pkg]
    sg, cam, bundles, mkrs = _graph(pkg, lens=lens)
    col = api.Collection(sg)
    col.add_marker(*mkrs[markers])
    col.add_attribute(*[cam.attr(ch)
                        for ch in ("tx", "ty", "tz", "rx", "ry", "rz")])
    col.add_attribute(cam.attr("focal_length_mm"))
    if lens:
        col.add_attribute(cam.attr("lens_distortion"))
    col.options = api.SolverOptions(image_width=1920.0)
    if solver is not None:
        col.set_solver(solver(api))
    return col, cam, bundles, mkrs


def _assert_same_run(got, want, tol=TOL):
    (t_attrs, t_results), (j_attrs, j_results) = got, want
    assert len(t_results) == len(j_results)
    for t_r, j_r in zip(t_results, j_results):
        assert (t_r.success, t_r.stop_reason, t_r.iterations,
                t_r.reason_string) == (j_r.success, j_r.stop_reason,
                                       j_r.iterations, j_r.reason_string)
        np.testing.assert_allclose(t_r.error_final, j_r.error_final,
                                   atol=tol)
        np.testing.assert_allclose(t_r.error_initial, j_r.error_initial,
                                   atol=tol)
    if j_attrs is None:
        assert t_attrs is None
        return
    for field in ("static_values", "anim_values"):
        np.testing.assert_allclose(to_numpy(getattr(t_attrs, field)),
                                   np.asarray(getattr(j_attrs, field)),
                                   atol=tol, err_msg=field)


def test_frame_behaves_alike():
    for api in APIS.values():
        f = api.Frame(12, tags=["key"], primary=True)
        assert (int(f), f.get_number(), f.get_tags()) == (12, 12,
                                                          ["key", "primary"])
        assert f.primary and not f.secondary
        assert repr(f) == "Frame(12, tags=['key', 'primary'])"
        assert repr(api.Frame(3, secondary=True)) == (
            "Frame(3, tags=['secondary'])")
        assert repr(api.Frame(4)) == "Frame(4)"
        solver = api.SolverStandard([api.Frame(2), 5])
        assert solver.frame_indices == [2, 5]


def test_lens_wrapper_behaves_alike():
    described = []
    for pkg, api in APIS.items():
        sg, cam, _, _ = _graph(pkg)
        lens = api.Lens(cam)
        assert lens.attr("distortion") is cam.attr("lens_distortion")
        assert api.Lens.layer_count(cam) == 1
        bare = sg.create_camera("bare")
        assert api.Lens.layer_count(bare) == 0
        with pytest.raises(ValueError, match="has no lens layers"):
            api.Lens(bare)
        described.append((repr(lens), lens.parameter_names,
                          [a.name for a in lens.get_attribute_list()]))
    assert described[0] == described[1]
    assert "distortion" in described[0][1]


def test_collection_methods_behave_alike():
    kept = []
    for pkg in APIS:
        col, cam, bundles, mkrs = _collection(pkg)
        col.add_marker(mkrs[0]).add_attribute(cam.attr("tx"))  # no twice
        assert len(col.get_marker_list()) == 6
        assert len(col.get_attribute_list()) == 8
        assert col.get_marker_list() is not col.markers
        col.set_attribute_stiffness(cam.attr("tx"), 0.5, variance=2.0)
        col.set_attribute_smoothness(cam.attr("ry"), 0.25)
        line = col.scene_graph.create_line("l", mkrs[:3])
        col.add_line(line, line)
        assert col.lines == [line] and col.solver is None
        assert col.set_solver("s") is col and col.solver == "s"
        kept.append((col.stiffness_weights, col.stiffness_variances,
                     col.smoothness_weights, col.smoothness_variances))
    assert kept[0] == kept[1]
    assert list(kept[0][0].values()) == [0.5]


def _validate_cases(api, pkg):
    sg, cam, bundles, mkrs = _graph(pkg)
    empty = api.Collection(sg)
    no_attrs = api.Collection(sg).add_marker(*mkrs).set_solver(
        api.SolverStandard(range(FRAMES)))
    camera_only = api.Collection(sg).add_marker(*mkrs).set_solver(
        api.SolverCamera(range(FRAMES)))
    too_many = api.Collection(sg).add_marker(mkrs[0]).add_attribute(
        *[cam.attr(ch) for ch in ("tx", "ty", "tz")],
        cam.attr("focal_length_mm")).set_solver(api.SolverStep([0, 1]))
    fine = api.Collection(sg).add_marker(*mkrs).add_attribute(
        cam.attr("tx")).set_solver(api.SolverStep([0, 1]))
    return dict(empty=empty, no_attrs=no_attrs, camera_only=camera_only,
                too_many=too_many, fine=fine)


@pytest.mark.parametrize("case", ["empty", "no_attrs", "camera_only",
                                  "too_many", "fine"])
def test_validate_gives_the_same_messages(case):
    got = t_api.validate(_validate_cases(t_api, "torch")[case])
    want = j_api.validate(_validate_cases(j_api, "jax")[case])
    assert got == want
    expected = dict(
        empty=["collection has no markers", "collection has no attributes",
               "collection has no solver"],
        no_attrs=["collection has no attributes"], camera_only=[],
        too_many=["not enough marker errors (4) for parameters (7)"],
        fine=[])[case]
    assert got == (not expected, expected)


def test_execute_returns_early_on_a_failed_validation():
    out = []
    for pkg, api in APIS.items():
        col = _validate_cases(api, pkg)["too_many"]
        attrs, results = _execute(pkg, col)
        assert attrs is None and len(results) == 1
        assert not results[0].success
        out.append(results[0].reason_string)
    assert out[0] == out[1]
    assert out[0] == "not enough marker errors (4) for parameters (7)"


def test_execute_refuses_all_locked_and_all_unused_attributes():
    reasons = {}
    for pkg, api in APIS.items():
        col, cam, bundles, _ = _collection(
            pkg, lambda api: api.SolverStep([0, 3, 7]))
        for a in col.attributes:
            a.lock()
        assert col.attributes[0].is_locked()
        attrs, results = _execute(pkg, col)
        assert attrs is None and col.last_results == results
        reasons.setdefault("locked", []).append(results[0].reason_string)
        # Attributes of the bundle that no collection marker sees.
        col, cam, bundles, _ = _collection(
            pkg, lambda api: api.SolverStep([0, 3, 7]))
        col.attributes = [bundles[6].attr("tx"), bundles[6].attr("ty")]
        attrs, results = _execute(pkg, col)
        assert attrs is None and col.last_results == results
        reasons.setdefault("unused", []).append(results[0].reason_string)
    assert reasons["locked"] == ["all attributes are locked"] * 2
    assert reasons["unused"] == [
        "no attribute affects any collection marker"] * 2


def _step_run(pkg, prepare=None, **kw):
    col, cam, bundles, mkrs = _collection(
        pkg, lambda api: api.SolverStep([0, 3, 7]), **kw)
    if prepare is not None:
        prepare(col, cam, bundles, mkrs)
    out = _execute(pkg, col)
    assert col.last_results is out[1]
    return out


def test_execute_of_a_marker_subset_with_locked_and_unused_attributes():
    """Six of seven markers measure; a locked attribute and those of the
    unseen bundle are dropped before the solve."""
    def prepare(col, cam, bundles, mkrs):
        cam.attr("rz").lock()
        col.add_attribute(bundles[6].attr("tx"), bundles[6].attr("tz"))

    got, want = _step_run("torch", prepare), _step_run("jax", prepare)
    _assert_same_run(got, want)
    assert got[1][0].success
    assert len(got[1][0].solved_parameters) == 5 * 3 + 2
    plain = _step_run("torch")
    assert len(plain[1][0].solved_parameters) == 6 * 3 + 2


def test_execute_with_stiffness_smoothness_and_lines():
    def prepare(col, cam, bundles, mkrs):
        col.set_attribute_stiffness(cam.attr("tx"), 0.5, variance=2.0)
        col.set_attribute_smoothness(cam.attr("ry"), 0.25)
        col.add_line(col.scene_graph.create_line("l", mkrs[:4], weight=0.5))

    got, want = _step_run("torch", prepare), _step_run("jax", prepare)
    _assert_same_run(got, want)
    plain = _step_run("torch")
    assert not torch.equal(got[0].anim_values, plain[0].anim_values)


def test_execute_takes_options_lens_and_dtype():
    """options= overrides the collection's; lens= a baked lens; dtype=
    the tensors' type."""
    col, cam, _, _ = _collection("torch",
                                 lambda api: api.SolverStep([0, 3, 7]))
    attrs, results = t_api.execute(
        col, t_api.SolverOptions(image_width=1920.0, iterations=1),
        device="cpu")
    assert results[0].iterations == 1
    lens = t_api.scenelens.bake_scene_lens(col.scene_graph, device="cpu")
    again, _ = t_api.execute(
        col, t_api.SolverOptions(image_width=1920.0, iterations=1),
        lens=lens, device="cpu")
    assert torch.equal(again.static_values, attrs.static_values)
    single, _ = t_api.execute(col, device="cpu", dtype=np.float32)
    assert single.static_values.dtype == torch.float32
    assert attrs.static_values.dtype == torch.float64


def test_execute_of_solver_standard_matches_and_recovers_the_lens():
    make = lambda api: api.SolverStandard(  # noqa: E731
        range(FRAMES), root_frame_indices=None, global_solve=True,
        root_frame_span=4)
    runs = {}
    for pkg in APIS:
        col, cam, _, _ = _collection(pkg, make)
        runs[pkg] = _execute(pkg, col) + (cam,)
    _assert_same_run(runs["torch"][:2], runs["jax"][:2])
    attrs, results, cam = runs["torch"]
    assert len(results) == 3 and all(r.success for r in results)
    assert len(results[1].per_frame_stop_reason) == FRAMES
    static = to_numpy(attrs.static_values)
    assert abs(static[cam.attr("focal_length_mm").code // 2] - 35.0) < 1e-6
    assert abs(static[cam.attr("lens_distortion").code // 2] - 0.08) < 1e-8
    merged = [api.combine_results(runs[pkg][1]) for pkg, api in APIS.items()]
    for key in ("success", "total_iterations", "total_function_evals"):
        assert merged[0][key] == merged[1][key], key
    np.testing.assert_allclose(merged[1]["error_final"],
                               merged[0]["error_final"], atol=TOL)
    assert sorted(merged[1]["per_frame_error"]) == list(range(FRAMES))
    for frame, err in merged[0]["per_frame_error"].items():
        np.testing.assert_allclose(merged[1]["per_frame_error"][frame], err,
                                   atol=TOL)
    assert merged[1]["total_solve_seconds"] > 0.0


def test_combine_results_of_nothing():
    assert t_api.combine_results([]) == j_api.combine_results([])
    assert t_api.combine_results([])["error_final"] is None
