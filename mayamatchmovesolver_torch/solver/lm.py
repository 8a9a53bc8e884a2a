"""Levenberg-Marquardt core.

Port of mayamatchmovesolver_tpu/solver/lm.py (ref:
src/mmSolver/adjust/adjust_cminpack_lmdif.cpp:61-202): analytic
Jacobians by forward-mode AD (torch.func.jvp over the identity basis,
batched by torch.func.vmap) where the reference differences the scene
graph, Marquardt diagonal damping like cminpack's mode-1 scaling, and
the Nielsen mu/nu update.  The iteration loop is a Python while loop on
the host; each iteration's body is branch-free tensor code, selected
with torch.where exactly like the reference's while_loop body.

Every function here also takes a batch of independent problems: x of
shape (B, P) and a residual function (B, P) -> (B, m) whose row b
depends on x[b] alone.  The state then carries the leading axis in every
field, a problem that has stopped is held in all of them (counters
included) while the others iterate, and each problem ends with the
iterations, evaluation counts and stop reason of its own unbatched
solve — the counterpart of the reference's jax.vmap over its
while_loop.

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
from torch.func import jacrev, jvp, vjp, vmap


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

    For a batch x of shape (B, P) the basis vector e_p is the tangent of
    parameter p in every problem at once (the Jacobian is block-diagonal
    over the batch), so a batch costs as many passes as one problem.
    """

    def system_batched(x):
        if mode == "rev":
            r, pullback = vjp(residual_fn, x)
            basis = torch.eye(r.shape[-1], dtype=x.dtype, device=x.device)
            j = vmap(lambda c: pullback(c.expand(r.shape))[0])(basis)
            jt = j.permute(1, 2, 0)  # (B, n, m)
        else:
            basis = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
            r, jt = vmap(
                lambda t: jvp(residual_fn, (x,), (t.expand(x.shape),)),
                out_dims=(None, 0),
            )(basis)
            jt = jt.permute(1, 0, 2)  # (B, n, m), row i = J_b @ e_i
        return r, jt @ jt.mT, (jt @ r[..., None])[..., 0]

    if mode == "rev":
        jac_fn = jacrev(residual_fn)

        def system(x):
            if x.dim() == 2:
                return system_batched(x)
            r = residual_fn(x)
            j = jac_fn(x)
            return r, j.T @ j, j.T @ r

        return system

    def system(x):
        if x.dim() == 2:
            return system_batched(x)
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
    caller turns into stop reason 5.  jtj (..., P, P), jtr (..., P) and
    mu (...) may carry leading batch axes.
    """
    d = torch.clamp(torch.diagonal(jtj, dim1=-2, dim2=-1), min=diag_floor)
    s = torch.rsqrt(d)
    a = jtj * (s[..., :, None] * s[..., None, :])
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    a = a + mu[..., None, None] * eye
    # One factorization for the whole batch; info is per problem, so a
    # failed one gets the NaN step alone.
    chol, info = torch.linalg.cholesky_ex(a)
    y = torch.cholesky_solve(-(s * jtr)[..., None], chol)[..., 0]
    y = torch.where((info == 0)[..., None], y, torch.nan)
    return s * y


def lm_init(residual_fn: Callable, x0, config: LMConfig = LMConfig()):
    """Initial LM state: residual + normal system at x0.

    mu is dimensionless (Marquardt convention): the damping term is
    mu*diag(JtJ), so mu0 = tau directly.
    """
    normal_system = _make_normal_system(residual_fn, config.jacobian_mode)
    r0, jtj0, jtr0 = normal_system(x0)

    def full(v, dtype):
        return torch.full(x0.shape[:-1], v, dtype=dtype, device=x0.device)

    return LMState(
        x=x0,
        r=r0,
        jtj=jtj0,
        jtr=jtr0,
        cost=0.5 * torch.sum(r0 * r0, dim=-1),
        mu=full(config.tau, x0.dtype),
        nu=full(2.0, x0.dtype),
        it=full(0, torch.int32),
        nfev=full(1, torch.int32),
        njev=full(1, torch.int32),
        stop=full(0, torch.int32),
    )


def _hold(active, old: LMState, new: LMState) -> LMState:
    """`new` where `active`, else `old`, in every field of a batched
    state."""
    def pick(a, b):
        return torch.where(active.reshape(active.shape + (1,) * (a.dim() - 1)),
                           a, b)

    return LMState(**{
        f.name: pick(getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(LMState)
    })


def lm_run_block(
    residual_fn: Callable,
    state: LMState,
    config: LMConfig = LMConfig(),
    iteration_limit=None,
) -> LMState:
    """Run LM iterations until convergence or `iteration_limit` total
    iterations.  Resumable: feed the returned state back in with a
    larger limit.  Reads one flag on the host per iteration: whether any
    problem of the state is still running.  In a batched state the
    problems that are not are held as they are.
    """
    normal_system = _make_normal_system(residual_fn, config.jacobian_mode)
    if iteration_limit is None:
        iteration_limit = config.max_iterations
    limit = min(int(iteration_limit), config.max_iterations)
    body = _make_body(normal_system, config)
    batched = state.stop.dim() > 0
    while True:
        active = (state.stop == 0) & (state.it < limit)
        if not bool(active.any()):
            return state
        new = body(state)
        state = _hold(active, state, new) if batched else new


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
        gradient_norm=torch.amax(torch.abs(state.jtr), dim=-1),
    )


def levenberg_marquardt(
    residual_fn: Callable, x0, config: LMConfig = LMConfig()
) -> LMResult:
    """Minimize 0.5*||residual_fn(x)||^2."""
    state = lm_init(residual_fn, x0, config)
    final = lm_run_block(residual_fn, state, config)
    return lm_finalize(final, state.cost)


def _make_body(normal_system, config: LMConfig):
    """One LM iteration, shared by the fused and the resumable loops;
    every reduction runs over the last axis, so a state with a leading
    batch axis iterates all its problems at once."""
    where = torch.where

    def body(s: LMState):
        dx = _solve_damped(s.jtj, s.jtr, s.mu)
        dx_ok = torch.all(torch.isfinite(dx), dim=-1)
        dx = where(dx_ok[..., None], dx, 0.0)

        xnorm = torch.linalg.norm(s.x, dim=-1)
        step_small = torch.linalg.norm(dx, dim=-1) <= config.eps2 * (
            xnorm + config.eps2
        )

        x_new = s.x + dx
        # The trial point's residual AND normal system in one pass; on
        # rejection they are discarded by the selects below.
        r_new, jtj_new, jtr_new = normal_system(x_new)
        cost_new = 0.5 * torch.sum(r_new * r_new, dim=-1)

        d = torch.clamp(torch.diagonal(s.jtj, dim1=-2, dim2=-1), min=1e-12)
        predicted = 0.5 * torch.sum(
            dx * (s.mu[..., None] * d * dx - s.jtr), dim=-1
        )
        predicted = torch.clamp(predicted, min=1e-300)
        rho = (s.cost - cost_new) / predicted

        accept = dx_ok & (rho > 0.0) & torch.isfinite(cost_new)
        accept_v, accept_m = accept[..., None], accept[..., None, None]

        mu_accept = s.mu * torch.clamp(
            1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0
        )
        mu_new = where(accept, mu_accept, s.mu * s.nu)
        nu_new = where(accept, 2.0, s.nu * 2.0)
        jtr2 = where(accept_v, jtr_new, s.jtr)

        gnorm = torch.amax(torch.abs(jtr2), dim=-1)
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
            x=where(accept_v, x_new, s.x),
            r=where(accept_v, r_new, s.r),
            jtj=where(accept_m, jtj_new, s.jtj),
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
