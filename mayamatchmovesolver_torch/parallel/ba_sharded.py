"""Distributed bundle adjustment: frame-sharded Schur + collective CG.

Port of mayamatchmovesolver_tpu/parallel/ba_sharded.py, the path for
long shots split by frame blocks over the ranks of a process group (one
rank per device).  Each rank owns its frame block's camera parameters,
observations and Jacobian blocks; bundles (the 3D points) and the shared
border parameters (static focal / lens coefficients — the arrowhead;
ref: docs/source/solver_design.rst:188-218) are the *replicated* state,
summed over the group.

Per LM iteration:
  1. each rank builds its local per-observation Jacobian blocks
     (solver/ba.py assemble_normal_blocks) — no communication;
  2. bundle blocks A_b, border blocks (Hbs, Hss, g_s) and gradients are
     summed in one all_reduce ((B, 3, 3) + (B, 3) + O(S) floats);
  3. the reduced arrowhead system over [camera blocks | border] is
     solved by a fixed number of preconditioned conjugate-gradient steps
     with three all_reduces a step: one a matvec,
       v_b   = sum_{m,f} W_mf x_f + Hbs_b x_s
       z_b   = A_b^-1 v_b
       out_c = B_f x_f + Hcs_f x_s - sum_m W_mf^T z_b     (local)
       out_s = sum_f Hcs_f^T x_f + Hss x_s - sum_b Hbs_b^T z_b
     (v_b and sum_f Hcs_f^T x_f in one buffer), one for the two inner
     products that give alpha, one for the one that gives beta; the
     preconditioner is the exact per-frame Schur diagonal block plus the
     border's own reduced block;
  4. the bundle back-substitution and the predicted reduction share one
     all_reduce, the gradient norm one MAX all_reduce, the trial cost
     one, the step and parameter norms one.

The communication volume an iteration is O(B + S) floats times
(CG steps + a few), independent of the frame count.  The LM loop uses
the true gain ratio with Nielsen's mu update and the eps1/2/3 stops of
solver/lm.py; a host while loop reads the stop flag and the iteration
count once an iteration, computed on every rank from all-reduced tensors
by the same operations, so all ranks leave together.

Objective parity with the single-device path: every residual and
Jacobian block comes from solver/ba.py's ba_cost / assemble_normal_blocks
on a view of the SAME BAProblem restricted to the rank's frames, so the
robust loss, the behind-camera inflation and the NaN guards are those of
solver/ba.py.
"""

import dataclasses
from typing import NamedTuple

import torch

from mayamatchmovesolver_torch.core import transform as tfm_math
from mayamatchmovesolver_torch.solver import ba as ba_mod


class ShardedBAResult(NamedTuple):
    cam_params: torch.Tensor  # (F, 6) global
    bnd_params: torch.Tensor  # (B, 3)
    shared_params: torch.Tensor  # (S,)
    cost: torch.Tensor
    cost_initial: torch.Tensor
    iterations: torch.Tensor
    stop_reason: torch.Tensor  # 1 ftol, 2 xtol, 3 gtol, 4 maxiter
    func_evals: int = 0  # counted trial-cost evaluations (+ initial)
    jacobian_evals: int = 0  # counted block assemblies


_TENSOR_FIELDS = ("marker_uv", "weight", "mkr_bnd_index", "mkr_cam_block",
                  "cam_params", "bnd_params", "shared_params", "intrinsics",
                  "lens_params", "lens_pixel_aspect")


def shard_ba_problem(problem: ba_mod.BAProblem, mesh,
                     axis_name="frames") -> ba_mod.BAProblem:
    """Put the problem's tensors on the mesh's device.  Every rank keeps
    the whole problem; sharded_solve_ba takes the rank's frame block."""
    return dataclasses.replace(problem, **{
        name: getattr(problem, name).to(mesh.device)
        for name in _TENSOR_FIELDS
    })


def sharded_solve_ba(
    problem: ba_mod.BAProblem,
    mesh,
    max_iterations=20,
    tau=1e-3,
    cg_iterations=30,
    eps1=1e-8,
    eps2=1e-8,
    eps3=1e-8,
    axis_name="frames",
    assembly="ad",
) -> ShardedBAResult:
    """Frame-sharded LM/Schur/CG bundle adjustment with a replicated
    shared-parameter border.

    Every rank passes the whole problem; each solves with its frame
    block.  Returns the global results on every rank.  assembly: the
    Jacobian assembly of solver/ba.py (ASSEMBLIES).
    """
    if problem.num_cameras > 1:
        raise ValueError(
            "the frame-sharded BA supports one camera per problem; "
            "solve multi-camera rigs with ba.solve_ba(linear_solver="
            "'cg') on one chip, or split per camera"
        )
    num_frames = problem.cam_params.shape[0]
    n_dev = mesh.size
    if num_frames % n_dev != 0:
        raise ValueError(
            "frame count %d not divisible by %d devices"
            % (num_frames, n_dev)
        )
    num_bundles = problem.bnd_params.shape[0]
    num_shared = int(problem.shared_params.shape[0])
    mkr_bnd_index = problem.mkr_bnd_index
    einsum, where = torch.einsum, torch.where
    all_reduce = mesh.all_reduce

    # The rank's frame block; bundles and the border are whole.
    local = problem._replace(
        marker_uv=mesh.block(problem.marker_uv, 1),
        weight=mesh.block(problem.weight, 1),
        cam_params=mesh.block(problem.cam_params, 0),
        intrinsics=mesh.block(problem.intrinsics, 0),
    )
    dtype, device = local.cam_params.dtype, local.cam_params.device

    def cost_of(cam, bnd, sh):
        return all_reduce(ba_mod.ba_cost(local, cam, bnd, sh))

    def segment_bundles(v_m):
        return ba_mod._segment_sum(v_m, mkr_bnd_index, num_bundles)

    def gn_step(cam, bnd, sh, mu):
        blocks = ba_mod.assemble_normal_blocks(local, cam, bnd, sh, assembly)
        # Sum the bundle/border members over the group; the frame-local
        # members (b_blocks, g_cam, w_mf, hcs) stay local.
        if num_shared:
            a_blocks, g_bnd, hbs, hss, g_sh = all_reduce(
                blocks.a_blocks, blocks.g_bnd, blocks.hbs, blocks.hss,
                blocks.g_sh)
        else:
            a_blocks, g_bnd = all_reduce(blocks.a_blocks, blocks.g_bnd)
            hbs, hss, g_sh = blocks.hbs, blocks.hss, blocks.g_sh
        w_mf, hcs = blocks.w_mf, blocks.hcs

        p_c = cam.shape[-1]
        eye_c = torch.eye(p_c, dtype=dtype, device=device)
        b_damped = ba_mod._damp(blocks.b_blocks, mu)
        a_inv = tfm_math.inverse3(ba_mod._damp(a_blocks, mu))
        a_inv_m = a_inv[mkr_bnd_index]

        g_bnd_pre = einsum("mab,mb->ma", a_inv_m, g_bnd[mkr_bnd_index])
        rhs_c = -(blocks.g_cam - einsum("mfab,ma->fb", w_mf, g_bnd_pre))
        if num_shared:
            hss_damped = ba_mod._damp(hss, mu)
            y_bs = einsum("bac,bcs->bas", a_inv, hbs)
            rhs_s = -(g_sh - einsum("bas,ba->s", y_bs, g_bnd))
        else:
            rhs_s = torch.zeros((0,), dtype=dtype, device=device)

        def matvec(x_c, x_s):
            # One arrowhead-reduced-system matvec; one all_reduce.
            v_b = segment_bundles(einsum("mfab,fb->ma", w_mf, x_c))
            if num_shared:
                v_b, hcs_x = all_reduce(v_b, einsum("fas,fa->s", hcs, x_c))
                v_b = v_b + einsum("bas,s->ba", hbs, x_s)
            else:
                v_b = all_reduce(v_b)
            z_b = einsum("bac,bc->ba", a_inv, v_b)
            out_c = einsum("fab,fb->fa", b_damped, x_c)
            out_c = out_c - einsum("mfab,ma->fb", w_mf, z_b[mkr_bnd_index])
            if not num_shared:
                return out_c, x_s
            out_c = out_c + einsum("fas,s->fa", hcs, x_s)
            out_s = hcs_x + hss_damped @ x_s
            out_s = out_s - einsum("bas,ba->s", hbs, z_b)
            return out_c, out_s

        # Preconditioner: the *exact* per-frame Schur diagonal block
        # S_ff = B_f - sum_m W_mf^T A_m^-1 W_mf (all local), plus the
        # border's reduced block, factored once.  Plain B_f block-Jacobi
        # is far too weak for this pixel^2-scaled system.
        s_diag = b_damped - einsum("mfab,mac,mfcd->fbd", w_mf, a_inv_m, w_mf)
        s_diag = s_diag + 1e-8 * torch.clamp(
            torch.diagonal(s_diag, dim1=-2, dim2=-1), min=1e-12
        )[..., None] * eye_c
        factor_c = ba_mod._cholesky_factor(s_diag)
        if num_shared:
            s_ss = hss_damped - einsum("bas,bat->st", hbs, y_bs)
            s_ss = s_ss + 1e-8 * torch.clamp(
                torch.diagonal(s_ss), min=1e-12
            ) * torch.eye(num_shared, dtype=dtype, device=device)
            factor_s = ba_mod._cholesky_factor(s_ss)

        def precond(v_c, v_s):
            p_ss = ba_mod._cholesky_apply(factor_s, v_s) if num_shared else v_s
            return ba_mod._cholesky_apply(factor_c, v_c), p_ss

        # Fixed-count preconditioned CG with breakdown guards: a
        # non-positive curvature (rounding-induced indefiniteness)
        # freezes the iterate instead of exploding.  No host read.  In
        # the inner products the camera parts vary over the ranks and are
        # summed; the border parts are replicated and added once (summing
        # them over the group would count them n times).
        x_c, x_s = torch.zeros_like(rhs_c), torch.zeros_like(rhs_s)
        r_c, r_s = rhs_c, rhs_s
        z_c, z_s = precond(r_c, r_s)
        p_cv, p_sv = z_c, z_s
        for _ in range(int(cg_iterations)):
            ap_c, ap_s = matvec(p_cv, p_sv)
            rz, pap = all_reduce(torch.sum(r_c * z_c), torch.sum(p_cv * ap_c))
            rz = rz + torch.sum(r_s * z_s)
            pap = pap + torch.sum(p_sv * ap_s)
            ok = (pap > 0.0) & (rz > 0.0)
            alpha = where(ok, rz / where(ok, pap, 1.0), 0.0)
            x_c = x_c + alpha * p_cv
            x_s = x_s + alpha * p_sv
            r_c = where(ok, r_c - alpha * ap_c, r_c)
            r_s = where(ok, r_s - alpha * ap_s, r_s)
            z_c, z_s = precond(r_c, r_s)
            rz_new = all_reduce(torch.sum(r_c * z_c)) + torch.sum(r_s * z_s)
            beta = where(ok, rz_new / where(ok, rz, 1.0), 0.0)
            p_cv = where(ok, z_c + beta * p_cv, p_cv)
            p_sv = where(ok, z_s + beta * p_sv, p_sv)
        dx_cam, dx_sh = x_c, x_s

        # Bundle back-substitution and the frame-local part of the
        # predicted reduction, in one all_reduce.
        diag_b = torch.clamp(
            torch.diagonal(blocks.b_blocks, dim1=-2, dim2=-1), min=1e-12)
        w_dx, pred = all_reduce(
            segment_bundles(einsum("mfab,fb->ma", w_mf, dx_cam)),
            0.5 * mu * torch.sum(diag_b * dx_cam * dx_cam)
            - 0.5 * torch.sum(dx_cam * blocks.g_cam),
        )
        rhs_b = g_bnd + w_dx
        if num_shared:
            rhs_b = rhs_b + einsum("bas,s->ba", hbs, dx_sh)
        dx_bnd = -einsum("bij,bj->bi", a_inv, rhs_b)

        # Gradient inf-norm (MAX over the ranks) + predicted reduction
        # (replicated).
        gnorm = all_reduce(torch.max(torch.abs(blocks.g_cam)), op="max")
        gnorm = torch.maximum(gnorm, torch.max(torch.abs(g_bnd)))
        if num_shared:
            gnorm = torch.maximum(gnorm, torch.max(torch.abs(g_sh)))
        diag_a = torch.clamp(
            torch.diagonal(a_blocks, dim1=-2, dim2=-1), min=1e-12)
        pred = pred + 0.5 * mu * torch.sum(diag_a * dx_bnd * dx_bnd)
        pred = pred - 0.5 * torch.sum(dx_bnd * g_bnd)
        if num_shared:
            diag_s = torch.clamp(torch.diagonal(hss), min=1e-12)
            pred = pred + 0.5 * (
                mu * torch.sum(diag_s * dx_sh * dx_sh)
                - torch.sum(dx_sh * g_sh)
            )
        return dx_cam, dx_bnd, dx_sh, gnorm, pred

    def scalar(v, dt=dtype):
        return torch.tensor(v, dtype=dt, device=device)

    cam, bnd, sh = local.cam_params, problem.bnd_params, problem.shared_params
    cost0 = cost_of(cam, bnd, sh)
    cost, mu, nu = cost0, scalar(tau), scalar(2.0)
    it, stop = scalar(0, torch.int32), scalar(0, torch.int32)
    nfev, njev = scalar(1, torch.int32), scalar(0, torch.int32)
    while True:
        stop_now, it_now = torch.stack([stop, it]).tolist()
        if stop_now != 0 or it_now >= max_iterations:
            break
        dx_cam, dx_bnd, dx_sh, gnorm, pred = gn_step(cam, bnd, sh, mu)
        # Acceptance is decided from replicated quantities only: dx_bnd,
        # dx_sh and the all-reduced cost; a NaN in any rank's dx_cam
        # poisons cost_new, so it is caught there.
        cam_new, bnd_new, sh_new = cam + dx_cam, bnd + dx_bnd, sh + dx_sh
        cost_new = cost_of(cam_new, bnd_new, sh_new)
        # In float32 the 1e-300 floor is 0.0, as in the reference.
        pred = torch.clamp(pred, min=1e-300)
        rho = (cost - cost_new) / pred
        accept = (
            (rho > 0.0)
            & torch.isfinite(cost_new)
            & torch.all(torch.isfinite(dx_bnd))
            & torch.all(torch.isfinite(dx_sh))
        )
        cam = where(accept, cam_new, cam)
        bnd = where(accept, bnd_new, bnd)
        sh = where(accept, sh_new, sh)
        mu_accept = mu * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                     min=1.0 / 3.0)
        mu, nu = where(accept, mu_accept, mu * nu), where(accept, 2.0, nu * 2.0)

        # eps1/2/3 stops (replicated scalars; the camera parts of the
        # step and parameter norms are summed over the ranks).
        step_cam_sq, x_cam_sq = all_reduce(torch.sum(dx_cam * dx_cam),
                                           torch.sum(cam * cam))
        step_norm = torch.sqrt(step_cam_sq + torch.sum(dx_bnd * dx_bnd)
                               + torch.sum(dx_sh * dx_sh))
        x_norm = torch.sqrt(x_cam_sq + torch.sum(bnd * bnd)
                            + torch.sum(sh * sh))
        ftol_hit = accept & (
            (cost - cost_new) <= eps3 * torch.clamp(cost, min=1e-300))
        xtol_hit = step_norm <= eps2 * (x_norm + eps2)
        gtol_hit = gnorm <= eps1
        stop = where(gtol_hit, 3, where(xtol_hit, 2, where(ftol_hit, 1, 0))
                     ).to(torch.int32)
        cost = where(accept, cost_new, cost)
        # Counted evaluations: one block assembly and one trial cost per
        # iteration.
        it, nfev, njev = it + 1, nfev + 1, njev + 1
    stop = where(stop == 0, 4, stop)

    # The global (F, 6) camera tensor: each rank's block in a zero-filled
    # tensor, summed over the group (all_reduce is the one device
    # collective every backend carries on CUDA tensors).
    cam_global = torch.zeros_like(problem.cam_params)
    mesh.block(cam_global, 0).copy_(cam)
    return ShardedBAResult(
        cam_params=all_reduce(cam_global),
        bnd_params=bnd,
        shared_params=sh,
        cost=cost,
        cost_initial=cost0,
        iterations=it,
        stop_reason=stop,
        func_evals=nfev,
        jacobian_evals=njev,
    )
