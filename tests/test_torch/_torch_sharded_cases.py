"""Seeded inputs of the sharded-solver agreement tests, shared by the test
files and the torch-only worker processes of test_torch_multihost.py.

The BA problems are tests/test_parallel/test_sharded.py's
`_synthetic_ba` as numpy arrays: observations made at the truth by the
port's own residual (float64 on the CPU), then the start moved off it.
Either package builds its BAProblem from the same arrays.  The
comparison helpers hold a port result against a JAX one.  Importing this
module imports no jax.
"""

import numpy as np

# name: (perturb, border focal start or None, contaminated, robust loss,
# CG steps) — the cases of tests/test_parallel/test_sharded.py.
BA_CASES = {
    "converge": (0.03, None, False, False, 40),
    "border": (0.01, 37.0, False, False, 50),
    "robust": (0.01, None, True, True, 40),
    "early": (1e-7, None, False, False, 40),
}
BA_ITERATIONS = 30


def ba_arrays(case, num_frames, num_bundles=10, seed=3):
    """make_ba_problem keyword arguments (numpy, float64) of one case,
    and the replacements to apply after it (start, border, loss)."""
    import torch

    from mayamatchmovesolver_torch.solver import ba as t_ba

    perturb, focal, contaminated, robust, _ = BA_CASES[case]
    rng = np.random.RandomState(seed)
    cam_true = np.zeros((num_frames, 6))
    cam_true[:, 0] = np.linspace(-2, 2, num_frames)
    cam_true[:, 1] = 1.0
    cam_true[:, 2] = 10.0
    cam_true[:, 4] = np.linspace(-5, 5, num_frames)
    bnd_true = np.stack([rng.uniform(-4, 4, num_bundles),
                         rng.uniform(-2, 2, num_bundles),
                         rng.uniform(-8, -3, num_bundles)], axis=-1)
    kwargs = dict(
        marker_uv=np.zeros((num_bundles, num_frames, 2)),
        weight=np.ones((num_bundles, num_frames)),
        mkr_bnd_index=np.arange(num_bundles),
        cam_params=cam_true, bnd_params=bnd_true,
    )
    truth = t_ba.make_ba_problem(**kwargs, device="cpu")
    r = t_ba.ba_residuals(truth, truth.cam_params, truth.bnd_params)
    uv = -r.numpy() / truth.image_width
    replace = dict(
        marker_uv=uv,
        cam_params=cam_true + rng.normal(0, perturb, cam_true.shape),
        bnd_params=bnd_true + rng.normal(0, perturb, bnd_true.shape),
    )
    if focal is not None:
        replace.update(solve_focal=True, shared_params=np.array([focal]))
    if contaminated:
        # 2 of the markers with per-frame random ~4 px track jitter.
        noise = np.random.RandomState(17)
        uv = uv.copy()
        uv[0] += noise.normal(0.0, 0.002, uv[0].shape)
        uv[1] += noise.normal(0.0, 0.002, uv[1].shape)
        replace["marker_uv"] = uv
    if robust:
        replace.update(loss_type=1, loss_scale=5.0)  # soft-L1
    return kwargs, replace


def ba_problem(ba_mod, kwargs, replace, device=None):
    """The BAProblem of ba_arrays' output in the package of `ba_mod`
    (the port's when `device` is given)."""
    extra = {} if device is None else {"device": device}
    problem = ba_mod.make_ba_problem(**kwargs, **extra)
    like = problem.marker_uv
    arrays = {k: v for k, v in replace.items() if isinstance(v, np.ndarray)}
    if device is None:
        import jax.numpy as jnp

        arrays = {k: jnp.asarray(v) for k, v in arrays.items()}
    else:
        import torch

        arrays = {k: torch.as_tensor(v, dtype=like.dtype, device=like.device)
                  for k, v in arrays.items()}
    scalars = {k: v for k, v in replace.items()
               if not isinstance(v, np.ndarray)}
    return problem._replace(**arrays, **scalars)


def static_lm_problem(pkg, n, device="cpu"):
    """tests/test_parallel/test_sharded.py::test_sharded_lm_static_params'
    problem in package `pkg` ("jax" or "torch", the latter on `device`):
    one bundle's tx and ty solved over n frames, tx started 0.3 off the
    truth (0.5)."""
    scene, attrs, solve_attrs, build_problem, options = static_lm_scene(
        pkg, n, device)
    return build_problem(scene, attrs, np.arange(n), solve_attrs, options)


def static_lm_scene(pkg, n, device="cpu"):
    """static_lm_problem's scene: (scene, attrs, solve_attrs, the
    package's build_problem, SolverOptions)."""
    if pkg == "torch":
        import torch as xp

        from mayamatchmovesolver_torch.core.constants import FilmFit
        from mayamatchmovesolver_torch.scene import SceneGraph, evaluate
        from mayamatchmovesolver_torch.scene.flatscene import (
            set_marker_screen_positions,
        )
        from mayamatchmovesolver_torch.solver import (
            SolverOptions,
            build_problem,
        )
        bake = {"device": device}
    else:
        import jax.numpy as xp

        from mayamatchmovesolver_tpu.core.constants import FilmFit
        from mayamatchmovesolver_tpu.scene import SceneGraph, evaluate
        from mayamatchmovesolver_tpu.scene.flatscene import (
            set_marker_screen_positions,
        )
        from mayamatchmovesolver_tpu.solver import (
            SolverOptions,
            build_problem,
        )
        bake = {}
    sg = SceneGraph(frame_range=(1, n))
    cam = sg.create_camera(
        "cam", tx=np.linspace(-1, 1, n), tz=10.0,
        film_fit=FilmFit.HORIZONTAL, render_width=1920, render_height=1080,
    )
    bnd = sg.create_bundle("b", tx=0.5, ty=0.3, tz=-5.0)
    sg.create_marker("m", camera=cam, bundle=bnd, tx=np.zeros(n),
                     ty=np.zeros(n))
    scene, attrs = sg.bake(**bake)
    frames = xp.arange(n) if pkg == "jax" else xp.arange(n, device=device)
    ev = evaluate(scene, attrs, frames)
    attrs = set_marker_screen_positions(scene, attrs, frames, ev.point_xy)
    static = np.array(_numpy(attrs.static_values))
    static[bnd.attr("tx").code // 2] += 0.3
    if pkg == "torch":
        import dataclasses

        attrs = dataclasses.replace(
            attrs, static_values=xp.as_tensor(static, device=device))
    else:
        attrs = attrs._replace(static_values=xp.asarray(static))
    return (scene, attrs, [bnd.attr("tx"), bnd.attr("ty")], build_problem,
            SolverOptions(image_width=1920.0))


def ba_scene(n, num_bundles=10, seed=3):
    """A BA-shaped shot for the port's solve(), on the CPU: one camera
    animated over n frames, static bundles, markers at the exact
    projections; the camera and the bundles then moved off the truth.
    Returns (scene, attrs, solve_attrs): the camera's six channels and
    every bundle's position."""
    import dataclasses

    import torch

    from mayamatchmovesolver_torch.core.constants import FilmFit
    from mayamatchmovesolver_torch.scene import SceneGraph, evaluate
    from mayamatchmovesolver_torch.scene.flatscene import (
        set_marker_screen_positions,
    )

    rng = np.random.RandomState(seed)
    sg = SceneGraph(frame_range=(1, n))
    channels = ("tx", "ty", "tz", "rx", "ry", "rz")
    cam = sg.create_camera(
        "cam", film_fit=FilmFit.HORIZONTAL, render_width=1920,
        render_height=1080, tx=np.linspace(-2, 2, n), ty=np.ones(n),
        tz=np.full(n, 10.0), rx=np.zeros(n), ry=np.linspace(-5, 5, n),
        rz=np.zeros(n))
    bundles = [sg.create_bundle("b%d" % i, tx=rng.uniform(-4, 4),
                                ty=rng.uniform(-2, 2),
                                tz=rng.uniform(-8, -3))
               for i in range(num_bundles)]
    for i, bnd in enumerate(bundles):
        sg.create_marker("m%d" % i, camera=cam, bundle=bnd, tx=np.zeros(n),
                         ty=np.zeros(n))
    scene, attrs = sg.bake(device="cpu")
    frames = torch.arange(n)
    attrs = set_marker_screen_positions(
        scene, attrs, frames, evaluate(scene, attrs, frames).point_xy)
    solve_attrs = [cam.attr(ch) for ch in channels] + [
        b.attr(ch) for b in bundles for ch in ("tx", "ty", "tz")]
    static, anim = attrs.static_values.clone(), attrs.anim_values.clone()
    for attr in solve_attrs:
        if attr.code % 2:
            anim[attr.code // 2] += torch.as_tensor(rng.normal(0, 0.02, n))
        else:
            static[attr.code // 2] += rng.normal(0, 0.02)
    return scene, dataclasses.replace(
        attrs, static_values=static, anim_values=anim), solve_attrs


def close(got, want, tol, scale=None, err_msg=""):
    """got against want within `tol` relative to each entry and to
    `scale`, by default the largest entry of want."""
    got, want = _numpy(got), _numpy(want)
    if scale is None:
        scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=err_msg)


def _numpy(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.array(x)


def projections(t_prob, result):
    """(M, F, 2) film-fit positions of every bundle in every frame at a
    result's parameters (either package's), through the port's residual
    with no observation, weight or loss: the gauge-free image of the
    cameras and bundles."""
    import torch

    from mayamatchmovesolver_torch.solver import ba as t_ba

    bare = t_prob._replace(marker_uv=torch.zeros_like(t_prob.marker_uv),
                           weight=torch.ones_like(t_prob.weight), loss_type=0)
    params = [torch.as_tensor(_numpy(x)) for x in (
        result.cam_params, result.bnd_params, result.shared_params)]
    return -t_ba.ba_residuals(bare, *params) / bare.image_width


def assert_agree(t_prob, t_res, j_res, tol, direct=False):
    """A port sharded-BA result against a JAX one of the same problem:
    equal iterations, stop reason and counters; the cost within `tol` of
    the initial cost, the border and the projections within `tol` of
    their largest entries, and with `direct` the cameras and bundles too
    (see test_torch_sharded.py's docstring for why not always)."""
    for name in ("iterations", "stop_reason", "func_evals",
                 "jacobian_evals"):
        assert int(getattr(t_res, name)) == int(getattr(j_res, name)), name
    close(t_res.cost_initial, j_res.cost_initial, tol, err_msg="cost_initial")
    close(t_res.cost, j_res.cost, tol, scale=float(j_res.cost_initial),
          err_msg="cost")
    close(t_res.shared_params, j_res.shared_params, tol, err_msg="border")
    close(projections(t_prob, t_res), projections(t_prob, j_res), tol,
          err_msg="projections")
    for name in ("cam_params", "bnd_params")[:2 * direct]:
        close(getattr(t_res, name), getattr(j_res, name), tol, err_msg=name)
