"""Agreement of the torch port's Schur bundle adjustment with the JAX
package.

The same numpy-seeded problems go through both packages' `make_ba_problem`
and are held together in float64: residuals, every NormalBlocks field of
both assemblies, the Cholesky and CG Schur steps and whole `solve_ba`
runs.  Tolerance 1e-10, relative to each tensor's largest entry (the
behind-camera factor scales residuals by 1e6); the linear solves use
1e-8, since the reduced system's conditioning (focal against depth)
amplifies the last bits of its two factorizations, which differ (torch's
LAPACK Cholesky against the reference's own).  A BA with free cameras and
bundles is defined only up to a similarity of the world; where CG's
round-off moves a solution along it, the tests hold the gauge-free
quantities (see test_solve_ba_matches).  Robust losses are compared
without the behind-camera bundle: at |r| ~ 1e9 their rescale cancels in
any implementation (the JAX package's own tests exclude that case too).

The reference picks its assembly by a module constant read at import
(`_BA_ASSEMBLY`, from MMSOLVER_TPU_BA_ASSEMBLY); the tests set that
constant for the duration of one test, as the environment variable would.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.solver.ba as t_ba
import mayamatchmovesolver_tpu.solver.ba as j_ba
from _torch_port_cases import to_numpy
from mayamatchmovesolver_tpu.solver.loss import RobustLossType

TOL = 1e-10
STEP_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol=TOL, err_msg=""):
    """got (torch) against want (JAX): rtol relative to each entry and to
    the largest entry of want."""
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(to_numpy(got), want, rtol=rtol,
                               atol=rtol * scale, err_msg=err_msg)


def _inputs(case, loss_type=RobustLossType.TRIVIAL, behind=True):
    """make_ba_problem keyword arguments (numpy) and a border vector.

    'lens_focal': one camera, 8 frames, 6 bundles, 3DE classic lens
    (distortion solved, curvature fixed) and focal in the border, a
    disabled marker and down-weighted observations, and optionally a
    bundle behind the camera.  'two_cams': a two-camera rig, 6 frames,
    5 bundles seen by both cameras, one border focal per camera, no lens.
    """
    rng = np.random.RandomState(5)
    if case == "lens_focal":
        frames, bundles = 8, 6
        cam = np.zeros((frames, 6))
        cam[:, 0] = np.linspace(-1, 1, frames)
        cam[:, 1] = 0.3 * np.sin(np.linspace(0, 3, frames))
        cam[:, 2] = 8.0
        cam[:, 3] = np.linspace(-2, 2, frames)
        cam[:, 4] = np.linspace(-4, 4, frames)
        bnd = np.stack([rng.uniform(-3, 3, bundles),
                        rng.uniform(-2, 2, bundles),
                        rng.uniform(-8, -2, bundles)], -1)
        if behind:
            bnd[0, 2] = 20.0
        weight = np.ones((bundles, frames))
        weight[1, :] = 0.0
        weight[2, ::2] = 0.25
        kwargs = dict(
            marker_uv=rng.rand(bundles, frames, 2) * 0.2 - 0.1,
            weight=weight, mkr_bnd_index=np.arange(bundles),
            cam_params=cam, bnd_params=bnd, solve_focal=True,
            lens_model_type="tde_classic",
            lens_params=dict(distortion=0.1, curvature_x=0.02),
            lens_solve_names=["distortion"], loss_type=int(loss_type),
            loss_scale=20.0,
        )
        return kwargs, np.array([36.0, 0.07])
    frames, bundles = 6, 5
    cam = np.zeros((2 * frames, 6))
    cam[:frames, 0] = np.linspace(-1, 1, frames)
    cam[:frames, 2] = 9.0
    cam[frames:, 0] = np.linspace(-1, 1, frames) + 1.5
    cam[frames:, 2] = 9.5
    cam[frames:, 4] = -4.0
    bnd = np.stack([rng.uniform(-2, 2, bundles),
                    rng.uniform(-2, 2, bundles),
                    rng.uniform(-7, -3, bundles)], -1)
    kwargs = dict(
        marker_uv=rng.rand(2 * bundles, frames, 2) * 0.2 - 0.1,
        weight=np.ones((2 * bundles, frames)),
        mkr_bnd_index=np.concatenate([np.arange(bundles)] * 2),
        mkr_cam_index=np.repeat([0, 1], bundles),
        cam_params=cam, bnd_params=bnd, solve_focal=True,
        loss_type=int(loss_type), loss_scale=20.0,
    )
    return kwargs, np.array([34.0, 36.5])


def _problems(case, **kw):
    kwargs, sh = _inputs(case, **kw)
    return (j_ba.make_ba_problem(**kwargs),
            t_ba.make_ba_problem(**kwargs, device="cpu"), sh)


def _synthetic(frames=8, bundles=6, perturb=0.05, lens=True, seed=3):
    """A noiseless one-camera shot close to its bundles (so focal and
    depth are well separated), observations made by the JAX package's
    own residual, started off the truth: (JAX, torch) problems."""
    rng = np.random.RandomState(seed)
    cam = np.zeros((frames, 6))
    cam[:, 0] = np.linspace(-3, 3, frames)
    cam[:, 1] = 1.0 + 0.5 * np.sin(np.linspace(0, 3, frames))
    cam[:, 2] = 4.0 + np.linspace(0, 2, frames)
    cam[:, 3] = np.linspace(-5, 5, frames)
    cam[:, 4] = np.linspace(-20, 20, frames)
    bnd = np.stack([rng.uniform(-3, 3, bundles),
                    rng.uniform(-2, 2, bundles),
                    rng.uniform(-6, 0, bundles)], -1)
    kwargs = dict(weight=np.ones((bundles, frames)),
                  mkr_bnd_index=np.arange(bundles), bnd_params=bnd,
                  solve_focal=True, focal_length_mm=35.0)
    if lens:
        kwargs.update(lens_model_type="tde_classic",
                      lens_params=dict(distortion=0.1),
                      lens_solve_names=["distortion"])
    truth = j_ba.make_ba_problem(
        marker_uv=np.zeros((bundles, frames, 2)), cam_params=cam, **kwargs)
    uv = -np.asarray(j_ba.ba_residuals(truth, jnp.asarray(cam),
                                       jnp.asarray(bnd))) / truth.image_width
    kwargs.update(
        marker_uv=uv,
        cam_params=cam + rng.normal(0, perturb, cam.shape),
        bnd_params=bnd + rng.normal(0, perturb, bnd.shape),
        focal_length_mm=36.0,
    )
    if lens:
        kwargs["lens_params"] = dict(distortion=0.07)
    return (j_ba.make_ba_problem(**kwargs),
            t_ba.make_ba_problem(**kwargs, device="cpu"))


def test_make_ba_problem_matches():
    for case in ("lens_focal", "two_cams"):
        j_prob, t_prob, _ = _problems(case)
        for name in ("marker_uv", "weight", "mkr_bnd_index", "mkr_cam_block",
                     "cam_params", "bnd_params", "shared_params",
                     "intrinsics", "lens_params", "lens_pixel_aspect"):
            got, want = getattr(t_prob, name), getattr(j_prob, name)
            assert got.device.type == "cpu", name
            np.testing.assert_array_equal(to_numpy(got), np.asarray(want),
                                          err_msg=name)
        assert t_ba._static_cfg(t_prob) == j_ba._static_cfg(j_prob)
        assert t_prob.num_cameras == j_prob.num_cameras
        assert t_prob.num_shared == j_prob.num_shared


@pytest.mark.parametrize("case,loss_type,behind", [
    ("lens_focal", RobustLossType.TRIVIAL, True),
    ("lens_focal", RobustLossType.SOFT_L1, False),
    ("lens_focal", RobustLossType.CAUCHY, False),
    ("two_cams", RobustLossType.SOFT_L1, False),
])
def test_ba_residuals_match(case, loss_type, behind):
    j_prob, t_prob, sh = _problems(case, loss_type=loss_type, behind=behind)
    args = (j_prob.cam_params, j_prob.bnd_params, jnp.asarray(sh))
    want = jax.jit(j_ba.ba_residuals)(j_prob, *args)
    got = t_ba.ba_residuals(t_prob, t_prob.cam_params, t_prob.bnd_params,
                            torch.as_tensor(sh))
    assert got.shape == want.shape
    if behind:
        assert float(np.abs(np.asarray(want)).max()) > 1e6
    _close(got, want)
    _close(t_ba.ba_cost(t_prob, t_prob.cam_params, t_prob.bnd_params,
                        torch.as_tensor(sh)),
           j_ba.ba_cost(j_prob, *args))


@pytest.mark.parametrize("assembly", t_ba.ASSEMBLIES)
@pytest.mark.parametrize("case,loss_type,behind", [
    ("lens_focal", RobustLossType.TRIVIAL, True),
    ("lens_focal", RobustLossType.SOFT_L1, False),
    ("two_cams", RobustLossType.TRIVIAL, False),
])
def test_normal_blocks_match(monkeypatch, assembly, case, loss_type, behind):
    monkeypatch.setattr(j_ba, "_BA_ASSEMBLY", assembly)
    j_prob, t_prob, sh = _problems(case, loss_type=loss_type, behind=behind)
    want = jax.jit(j_ba.assemble_normal_blocks)(
        j_prob, j_prob.cam_params, j_prob.bnd_params, jnp.asarray(sh))
    got = t_ba.assemble_normal_blocks(
        t_prob, t_prob.cam_params, t_prob.bnd_params, torch.as_tensor(sh),
        assembly=assembly)
    assert got._fields == want._fields
    for name in want._fields:
        assert getattr(got, name).shape == getattr(want, name).shape, name
        _close(getattr(got, name), getattr(want, name), err_msg=name)


def test_assemblies_match_each_other_and_refuse_lens_on_a_rig():
    """The port's two assemblies agree on every block, and 'analytic' says
    so when asked for a multi-camera rig with a lens, where the reference
    falls back to AD without notice."""
    _, t_prob, sh = _problems("lens_focal", loss_type=RobustLossType.CAUCHY,
                              behind=False)
    sh = torch.as_tensor(sh)
    args = (t_prob, t_prob.cam_params, t_prob.bnd_params, sh)
    ad = t_ba.assemble_normal_blocks(*args, assembly="ad")
    an = t_ba.assemble_normal_blocks(*args, assembly="analytic")
    for name in ad._fields:
        _close(getattr(an, name), to_numpy(getattr(ad, name)), rtol=1e-9,
               err_msg=name)
    with pytest.raises(ValueError, match="assembly must be one of"):
        t_ba.assemble_normal_blocks(*args, assembly="fused")

    kwargs, _ = _inputs("two_cams")
    kwargs.update(solve_focal=False, lens_model_type="tde_classic",
                  lens_params=dict(distortion=0.1))
    rig = t_ba.make_ba_problem(**kwargs, device="cpu")
    rig_args = (rig, rig.cam_params, rig.bnd_params, rig.shared_params)
    t_ba.assemble_normal_blocks(*rig_args, assembly="ad")
    with pytest.raises(ValueError, match="multi-camera rig with a lens"):
        t_ba.assemble_normal_blocks(*rig_args, assembly="analytic")


def _step_close(got, want, names):
    for name, a, b in zip(names, got, want):
        _close(a, b, rtol=STEP_TOL, err_msg=name)


STEP_NAMES = ("dx_cam", "dx_bnd", "dx_sh", "cost", "gnorm", "pred")


@pytest.mark.parametrize("assembly", t_ba.ASSEMBLIES)
def test_schur_normal_step_matches(monkeypatch, assembly):
    monkeypatch.setattr(j_ba, "_BA_ASSEMBLY", assembly)
    j_prob, t_prob = _synthetic()
    mu = 1e-3
    want = jax.jit(j_ba._schur_normal_step)(
        j_prob, j_prob.cam_params, j_prob.bnd_params, j_prob.shared_params,
        mu)
    got = t_ba._schur_normal_step(
        t_prob, t_prob.cam_params, t_prob.bnd_params, t_prob.shared_params,
        torch.tensor(mu, dtype=torch.float64), assembly=assembly)
    _step_close(got, want, STEP_NAMES)


@pytest.mark.parametrize("exit_by,cg_iterations", [
    ("tolerance", 200), ("cap", 4),
])
def test_schur_cg_step_matches(exit_by, cg_iterations):
    """CG that stops at its tolerance (well before 200 steps) and CG cut
    at the cap give the reference's steps; past the tolerance, more
    steps change nothing, bit for bit.  mu = 0.1 keeps the gauge-free
    reduced system conditioned well enough that CG reaches its tolerance
    before round-off steers it: at mu = 1e-3 it runs past the system's
    size and the two packages' round-off, amplified by CG, parts them
    by 1e-6."""
    j_prob, t_prob = _synthetic()
    mu = 0.1
    want = jax.jit(j_ba._schur_cg_step, static_argnums=5)(
        j_prob, j_prob.cam_params, j_prob.bnd_params, j_prob.shared_params,
        mu, cg_iterations)

    def port(n):
        return t_ba._schur_cg_step(
            t_prob, t_prob.cam_params, t_prob.bnd_params,
            t_prob.shared_params, torch.tensor(mu, dtype=torch.float64), n)

    got = port(cg_iterations)
    _step_close(got, want, STEP_NAMES)
    more = port(cg_iterations + 1)
    if exit_by == "tolerance":
        for a, b in zip(got, more):
            assert torch.equal(a, b)
    else:
        assert not torch.equal(got[0], more[0])


@pytest.mark.parametrize("linear_solver", ["cholesky", "cg"])
def test_solve_ba_matches(linear_solver):
    """A solve to convergence: the same iterations, stop reason, counted
    evaluations and final parameters.  With CG the camera and bundle
    parameters are held only up to the similarity gauge (translation,
    rotation and scale of the world change no residual): CG's round-off,
    which differs between the two packages' factorizations, moves the
    converged solution along it, by up to 1e-4 here.  The border (focal,
    distortion) and the cost are gauge-free and held at STEP_TOL; the
    camera and bundle parameters of CG steps are held at STEP_TOL by
    test_solve_ba_fixed_envelope_and_resumable_blocks."""
    j_prob, t_prob = _synthetic()
    kw = dict(max_iterations=15, linear_solver=linear_solver,
              cg_iterations=40)
    want = jax.jit(lambda p: j_ba.solve_ba(p, **kw))(j_prob)
    got = t_ba.solve_ba(t_prob, **kw)
    assert int(got.iterations) == int(want.iterations) < 15
    assert int(got.stop_reason) == int(want.stop_reason) in (1, 2, 3)
    assert int(got.func_evals) == int(want.func_evals)
    assert int(got.jacobian_evals) == int(want.jacobian_evals)
    names = ["shared_params"]
    if linear_solver == "cholesky":
        names += ["cam_params", "bnd_params"]
    for name in names:
        _close(getattr(got, name), getattr(want, name), rtol=STEP_TOL,
               err_msg=name)
    np.testing.assert_allclose(to_numpy(got.shared_params), [35.0, 0.1],
                               rtol=STEP_TOL)
    assert float(got.cost) < 1e-16 * float(got.cost_initial)
    assert float(want.cost) < 1e-16 * float(want.cost_initial)
    np.testing.assert_allclose(float(got.cost_initial),
                               float(want.cost_initial), rtol=TOL)


@pytest.mark.parametrize("linear_solver", ["cholesky", "cg"])
def test_solve_ba_fixed_envelope_and_resumable_blocks(linear_solver):
    """eps = 0 runs exactly max_iterations (counted evaluations as in the
    reference) and gives the reference's parameters; ba_run_block resumed
    in blocks lands on the same state, bit for bit.  tau = 0.1 for the
    reason given in test_schur_cg_step_matches."""
    j_prob, t_prob = _synthetic(lens=False)
    kw = dict(max_iterations=3, tau=0.1, eps1=0.0, eps2=0.0, eps3=0.0,
              linear_solver=linear_solver, cg_iterations=40)
    want = jax.jit(lambda p: j_ba.solve_ba(p, **kw))(j_prob)
    got = t_ba.solve_ba(t_prob, **kw, assembly="analytic")
    assert (int(got.iterations), int(got.func_evals),
            int(got.jacobian_evals), int(got.stop_reason)) == (3, 4, 3, 4)
    assert int(want.stop_reason) == 4
    for name in ("cam_params", "bnd_params", "shared_params", "cost"):
        _close(getattr(got, name), getattr(want, name), rtol=STEP_TOL,
               err_msg=name)

    state = t_ba.ba_init(t_prob, tau=0.1)
    for limit in (1, 2, 3):
        state = t_ba.ba_run_block(t_prob, state, limit, max_iterations=3,
                                  eps1=0.0, eps2=0.0, eps3=0.0,
                                  linear_solver=linear_solver,
                                  cg_iterations=40, assembly="analytic")
        assert int(state.it) == limit
    blocks = t_ba.ba_finalize(state, got.cost_initial)
    for name in ("cam_params", "bnd_params", "shared_params", "cost"):
        assert torch.equal(getattr(blocks, name), getattr(got, name)), name


def test_solve_ba_rejects_bad_linear_solver():
    _, t_prob, _ = _problems("two_cams")
    with pytest.raises(ValueError, match="'cholesky' or 'cg'"):
        t_ba.solve_ba(t_prob, linear_solver="lu")
    with pytest.raises(ValueError, match="multi-camera"):
        t_ba.solve_ba(t_prob, linear_solver="cholesky")
