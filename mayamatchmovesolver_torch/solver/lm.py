"""Levenberg-Marquardt core.

Port of mayamatchmovesolver_tpu/solver/lm.py (ref:
src/mmSolver/adjust/adjust_cminpack_lmdif.cpp:61-202): analytic
Jacobians by forward-mode AD (torch.func.jvp over the identity basis,
batched by torch.func.vmap) where the reference differences the scene
graph, Marquardt diagonal damping like cminpack's mode-1 scaling, and
the Nielsen mu/nu update.  The iteration loop is a Python while loop on
the host; each iteration's body is branch-free tensor code, selected
with torch.where exactly like the reference's while_loop body.

Stop reasons mirror cminpack's info codes in spirit:
  1 ftol (relative cost reduction), 2 xtol (step size), 3 gtol
  (gradient inf-norm), 4 max iterations, 5 singular/failed step.

Precision: J^T J, J^T r and the factorization run in the working dtype
with TF32 off (torch's default, which this module does not change): the
normal equations lose the digits TF32 drops.
"""

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.func import jacrev, jvp, vmap


class LMConfig(NamedTuple):
    """Tolerances follow the reference solver flags: iterations, tau,
    eps1 (gtol), eps2 (xtol), eps3 (ftol)
    (ref: docs/source/commands_solve.rst:28-36, adjust_data.h:133-186)."""

    max_iterations: int = 20
    tau: float = 1e-3
    eps1: float = 1e-6  # gradient inf-norm tolerance (gtol)
    eps2: float = 1e-6  # parameter step tolerance (xtol)
    eps3: float = 1e-6  # relative cost-reduction tolerance (ftol)
    jacobian_mode: str = "fwd"  # 'fwd' (n_params JVPs) or 'rev' (m VJPs)


@dataclasses.dataclass(frozen=True)
class LMResult:
    x: torch.Tensor
    residuals: torch.Tensor
    cost: torch.Tensor  # 0.5 * ||r||^2
    cost_initial: torch.Tensor
    iterations: torch.Tensor
    func_evals: torch.Tensor
    jacobian_evals: torch.Tensor
    stop_reason: torch.Tensor  # int32, see module docstring
    gradient_norm: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LMState:
    """The resumable-solve state passed between lm_init / lm_run_block."""

    x: torch.Tensor
    r: torch.Tensor
    jtj: torch.Tensor
    jtr: torch.Tensor
    cost: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    it: torch.Tensor
    nfev: torch.Tensor
    njev: torch.Tensor
    stop: torch.Tensor


def _make_normal_system(residual_fn, mode):
    """residual + JtJ + Jtr in one pass.

    fwd mode: one jvp per parameter, batched by vmap over the identity
    basis.  The primal is unbatched inside vmap, so the scene is
    evaluated once per system and only the tangents carry the batch —
    the counterpart of the reference's jax.linearize.  rev mode: one VJP
    per residual row via jacrev (better when m << n).
    """
    if mode == "rev":
        jac_fn = jacrev(residual_fn)

        def system(x):
            r = residual_fn(x)
            j = jac_fn(x)
            return r, j.T @ j, j.T @ r

        return system

    def system(x):
        basis = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
        r, jt = vmap(
            lambda t: jvp(residual_fn, (x,), (t,)), out_dims=(None, 0)
        )(basis)  # jt: (n, m), row i = J @ e_i
        return r, jt @ jt.T, jt @ r

    return system


def _solve_damped(jtj, jtr, mu, diag_floor=1e-12):
    """Solve (JtJ + mu*diag(JtJ)) dx = -Jtr via Cholesky.

    The system is solved in Jacobi-scaled form — S (JtJ + mu D) S y =
    -S Jtr with S = diag(JtJ)^-1/2, dx = S y — the same linear system
    with unit diagonal, so mixed-unit parameter sets (mm focal + degrees
    + world units) stay within float32's conditioning budget.  A failed
    factorization (not positive definite) gives a NaN step, which the
    caller turns into stop reason 5.
    """
    d = torch.clamp(torch.diagonal(jtj), min=diag_floor)
    s = torch.rsqrt(d)
    a = jtj * (s[:, None] * s[None, :])
    a = a + mu * torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    chol, info = torch.linalg.cholesky_ex(a)
    y = torch.cholesky_solve(-(s * jtr)[:, None], chol)[:, 0]
    y = torch.where(info == 0, y, torch.nan)
    return s * y


def lm_init(residual_fn: Callable, x0, config: LMConfig = LMConfig()):
    """Initial LM state: residual + normal system at x0.

    mu is dimensionless (Marquardt convention): the damping term is
    mu*diag(JtJ), so mu0 = tau directly.
    """
    normal_system = _make_normal_system(residual_fn, config.jacobian_mode)
    r0, jtj0, jtr0 = normal_system(x0)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=x0.device)

    return LMState(
        x=x0,
        r=r0,
        jtj=jtj0,
        jtr=jtr0,
        cost=0.5 * torch.sum(r0 * r0),
        mu=scalar(config.tau, x0.dtype),
        nu=scalar(2.0, x0.dtype),
        it=scalar(0, torch.int32),
        nfev=scalar(1, torch.int32),
        njev=scalar(1, torch.int32),
        stop=scalar(0, torch.int32),
    )


def lm_run_block(
    residual_fn: Callable,
    state: LMState,
    config: LMConfig = LMConfig(),
    iteration_limit=None,
) -> LMState:
    """Run LM iterations until convergence or `iteration_limit` total
    iterations.  Resumable: feed the returned state back in with a
    larger limit.  Reads the stop flag on the host once per iteration.
    """
    normal_system = _make_normal_system(residual_fn, config.jacobian_mode)
    if iteration_limit is None:
        iteration_limit = config.max_iterations
    limit = min(int(iteration_limit), config.max_iterations)
    body = _make_body(normal_system, config)
    while int(state.stop) == 0 and int(state.it) < limit:
        state = body(state)
    return state


def lm_finalize(state: LMState, cost_initial) -> LMResult:
    """Wrap a (possibly interrupted) state as an LMResult."""
    return LMResult(
        x=state.x,
        residuals=state.r,
        cost=state.cost,
        cost_initial=cost_initial,
        iterations=state.it,
        func_evals=state.nfev,
        jacobian_evals=state.njev,
        stop_reason=torch.where(state.stop == 0, 4, state.stop),
        gradient_norm=torch.max(torch.abs(state.jtr)),
    )


def levenberg_marquardt(
    residual_fn: Callable, x0, config: LMConfig = LMConfig()
) -> LMResult:
    """Minimize 0.5*||residual_fn(x)||^2."""
    state = lm_init(residual_fn, x0, config)
    final = lm_run_block(residual_fn, state, config)
    return lm_finalize(final, state.cost)


def _make_body(normal_system, config: LMConfig):
    """One LM iteration, shared by the fused and the resumable loops."""
    where = torch.where

    def body(s: LMState):
        dx = _solve_damped(s.jtj, s.jtr, s.mu)
        dx_ok = torch.all(torch.isfinite(dx))
        dx = where(dx_ok, dx, 0.0)

        xnorm = torch.linalg.norm(s.x)
        step_small = torch.linalg.norm(dx) <= config.eps2 * (
            xnorm + config.eps2
        )

        x_new = s.x + dx
        # The trial point's residual AND normal system in one pass; on
        # rejection they are discarded by the selects below.
        r_new, jtj_new, jtr_new = normal_system(x_new)
        cost_new = 0.5 * torch.sum(r_new * r_new)

        d = torch.clamp(torch.diagonal(s.jtj), min=1e-12)
        predicted = 0.5 * torch.dot(dx, s.mu * d * dx - s.jtr)
        predicted = torch.clamp(predicted, min=1e-300)
        rho = (s.cost - cost_new) / predicted

        accept = dx_ok & (rho > 0.0) & torch.isfinite(cost_new)

        mu_accept = s.mu * torch.clamp(
            1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0
        )
        mu_new = where(accept, mu_accept, s.mu * s.nu)
        nu_new = where(accept, 2.0, s.nu * 2.0)
        jtr2 = where(accept, jtr_new, s.jtr)

        gnorm = torch.max(torch.abs(jtr2))
        ftol_hit = accept & (
            (s.cost - cost_new)
            <= config.eps3 * torch.clamp(s.cost, min=1e-300)
        )
        gtol_hit = gnorm <= config.eps1
        failed = (~dx_ok) | (~torch.isfinite(mu_new))

        stop = where(
            failed,
            5,
            where(gtol_hit, 3, where(step_small, 2, where(ftol_hit, 1, 0))),
        ).to(torch.int32)
        accepted = accept.to(torch.int32)

        return LMState(
            x=where(accept, x_new, s.x),
            r=where(accept, r_new, s.r),
            jtj=where(accept, jtj_new, s.jtj),
            jtr=jtr2,
            cost=where(accept, cost_new, s.cost),
            mu=mu_new,
            nu=nu_new,
            it=s.it + 1,
            nfev=s.nfev + 1 + accepted,
            njev=s.njev + accepted,
            stop=stop,
        )

    return body
