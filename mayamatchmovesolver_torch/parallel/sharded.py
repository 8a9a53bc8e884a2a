"""Multi-device least squares: the frame axis split over the ranks of a
torch.distributed process group.

Port of mayamatchmovesolver_tpu/parallel/sharded.py.  The frame axis —
the reference's only batch axis (ref: lib/rust/mmscenegraph/src/scene/
flat.rs:172 evaluates all frames in a flat array) — is the split axis:

  * every rank holds the whole problem and evaluates its own contiguous
    frame block [r*F/n, (r+1)*F/n): animated channels (A, F) and the
    (M, F) marker-frame mask are sliced along F;
  * each rank accumulates its block's contribution J_f^T J_f and
    J_f^T r_f to the normal equations of the shared (static) parameters;
  * one all_reduce over the group sums the camera system, which is small
    and replicated on every rank.

One rank drives one device.  Without an initialised process group the
mesh is world size 1 and every collective is the identity, as a psum
over a one-device mesh is; with a group of any size, including 1, the
collectives are real torch.distributed calls.  Every rank computes the
replicated quantities (the damped solve, the gain ratio, the stop flag)
from the same all-reduced tensors with the same operations, so all ranks
read the same exit on the host and leave the loop together: a rank that
left early would block the others in their next collective.

Precision: every product runs in the working dtype with TF32 off
(torch's default, which this module does not change).
"""

import dataclasses

import torch
import torch.distributed as dist

from mayamatchmovesolver_torch.scene.attrblock import AttrBlock
from mayamatchmovesolver_torch.solver import ba as ba_mod
from mayamatchmovesolver_torch.solver import lm as lm_mod
from mayamatchmovesolver_torch.solver import problem as problem_mod

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class FrameMesh:
    """The frame axis over the ranks of a process group, one rank per
    device: this rank's device, and the group (None without an
    initialised process group: world size 1, identity collectives)."""

    device: torch.device
    group: object = None
    axis_name: str = "frames"

    @property
    def size(self):
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self):
        return 0 if self.group is None else dist.get_rank(self.group)

    def block(self, x, dim):
        """This rank's contiguous block of `x` along `dim`, the layout a
        blocked frame sharding gives."""
        width, rest = divmod(x.shape[dim], self.size)
        if rest:
            raise ValueError("axis of %d not divisible by %d devices"
                             % (x.shape[dim], self.size))
        return x.narrow(dim, self.rank * width, width)

    def all_reduce(self, *tensors, op="sum"):
        """The tensors summed (or maxed) over the group, in one collective
        on one flat buffer: a tuple for several tensors, the tensor for
        one.  All share a dtype and lie on the mesh's device."""
        if self.group is not None:
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.all_reduce(flat, op=_REDUCE_OPS[op], group=self.group)
            tensors = tuple(
                part.reshape(t.shape) for t, part in zip(
                    tensors, flat.split([t.numel() for t in tensors]))
            )
        return tensors if len(tensors) > 1 else tensors[0]


def make_frame_mesh(device=None, axis_name="frames"):
    """The 1-D frame mesh of this rank on `device` (default the current
    CUDA device; tests and CPU runs pass "cpu"): the default process group
    when one is initialised and its backend carries the device's tensors
    (NCCL carries CUDA tensors only), else world size 1."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    group = None
    if (dist.is_available() and dist.is_initialized()
            and (device.type == "cuda" or dist.get_backend() != "nccl")):
        group = dist.group.WORLD
    return FrameMesh(device=device, group=group, axis_name=axis_name)


def _local_problem(problem, anim_block, mask_block, num_local_frames):
    """Rebuild the problem as seen by one rank: its anim columns are the
    whole (local) frame range."""
    attrs_local = AttrBlock(
        static_values=problem.attrs.static_values, anim_values=anim_block
    )
    return dataclasses.replace(
        problem,
        attrs=attrs_local,
        frame_indices=torch.arange(num_local_frames,
                                   device=anim_block.device),
        marker_frame_mask=mask_block,
    )


@dataclasses.dataclass(frozen=True)
class ShardedLMState:
    params: torch.Tensor
    cost: torch.Tensor
    jtj: torch.Tensor
    jtr: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    it: torch.Tensor
    stop: torch.Tensor
    nfev: torch.Tensor  # counted residual evaluations (real, not derived)
    njev: torch.Tensor  # counted Jacobian evaluations


def sharded_normal_system(problem, mesh, axis_name="frames"):
    """Returns a function params -> (cost, jtj, jtr), all-reduced over the
    mesh.

    Requires: all parameters static (param_frames == -1); solve frames ==
    baked frames (problem.frame_indices covers the anim axis in order).
    """
    n = mesh.size
    num_frames = int(problem.num_frames)
    if num_frames % n != 0:
        raise ValueError(
            "frame count %d not divisible by %d devices — pad frames"
            % (num_frames, n)
        )
    local = _local_problem(
        problem,
        mesh.block(problem.attrs.anim_values, 1),
        mesh.block(problem.marker_frame_mask, 1),
        num_frames // n,
    )
    # The rank's frame block through the dense LM's own normal system
    # (vmap of jvp over the identity basis).
    system = lm_mod._make_normal_system(problem_mod.residual_fn(local), "fwd")

    def normal(params):
        r, jtj, jtr = system(params)
        return mesh.all_reduce(0.5 * torch.sum(r * r), jtj, jtr)

    return normal


def sharded_levenberg_marquardt(
    problem,
    x0,
    mesh,
    max_iterations=20,
    tau=1e-3,
    eps1=1e-6,
    eps2=1e-6,
    eps3=1e-6,
    axis_name="frames",
):
    """LM over frame-sharded normal equations.  The damping loop runs
    replicated; each iteration re-reduces JtJ/Jtr across the mesh.

    Semantics mirror solver/lm.py (which mirrors the reference's
    cminpack LM, adjust_cminpack_lmdif.cpp:61) with two differences
    kept from the reference: a non-finite step is rejected (mu grows)
    rather than stopping with 5, and a rejected step is not counted
    apart.  A host while loop reads the stop flag and the iteration count
    once an iteration.
    """
    normal_fn = sharded_normal_system(problem, mesh, axis_name)
    where = torch.where
    cost0, jtj0, jtr0 = normal_fn(x0)

    def body(s: ShardedLMState):
        # The state CARRIES the normal system at the current iterate
        # (like solver/lm.py): one sharded evaluation per iteration —
        # the trial point's system doubles as the next iteration's on
        # acceptance and is discarded by the selects on rejection.
        # Dimensionless Marquardt mu: damping is mu*diag(JtJ).
        d = torch.clamp(torch.diagonal(s.jtj), min=1e-12)
        dx = ba_mod._solve_spd(s.jtj + s.mu * torch.diag(d), -s.jtr)
        x_new = s.params + dx
        cost_new, jtj_new, jtr_new = normal_fn(x_new)

        # In float32 the 1e-300 floor is 0.0, as in the reference.
        predicted = torch.clamp(
            0.5 * torch.dot(dx, s.mu * d * dx - s.jtr), min=1e-300
        )
        rho = (s.cost - cost_new) / predicted
        accept = (rho > 0.0) & torch.all(torch.isfinite(dx))

        mu_new = where(
            accept,
            s.mu * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
            s.mu * s.nu,
        )
        nu_new = where(accept, 2.0, s.nu * 2.0)
        jtr2 = where(accept, jtr_new, s.jtr)

        small_step = torch.linalg.norm(dx) <= eps2 * (
            torch.linalg.norm(s.params) + eps2
        )
        small_grad = torch.max(torch.abs(jtr2)) <= eps1
        small_red = accept & (
            (s.cost - cost_new) <= eps3 * torch.clamp(s.cost, min=1e-300)
        )
        stop = where(
            small_grad, 3, where(small_step, 2, where(small_red, 1, 0))
        ).to(torch.int32)
        return ShardedLMState(
            params=where(accept, x_new, s.params),
            cost=where(accept, cost_new, s.cost),
            jtj=where(accept, jtj_new, s.jtj),
            jtr=jtr2,
            mu=mu_new, nu=nu_new, it=s.it + 1, stop=stop,
            nfev=s.nfev + 1, njev=s.njev + 1,
        )

    def scalar(v, dtype=x0.dtype):
        return torch.tensor(v, dtype=dtype, device=x0.device)

    state = ShardedLMState(
        params=x0, cost=cost0, jtj=jtj0, jtr=jtr0,
        mu=scalar(tau), nu=scalar(2.0),
        it=scalar(0, torch.int32), stop=scalar(0, torch.int32),
        nfev=scalar(1, torch.int32), njev=scalar(1, torch.int32),
    )
    while True:
        stop, it = torch.stack([state.stop, state.it]).tolist()
        if stop != 0 or it >= max_iterations:
            return state
        state = body(state)


def shard_problem_arrays(problem, mesh, axis_name="frames"):
    """Put the frame-split leaves (animated channels, marker-frame mask)
    and the static values on the mesh's device.  Every rank keeps the
    whole arrays; the solvers take the rank's frame block."""
    attrs = AttrBlock(
        static_values=problem.attrs.static_values.to(mesh.device),
        anim_values=problem.attrs.anim_values.to(mesh.device),
    )
    return dataclasses.replace(
        problem, attrs=attrs,
        marker_frame_mask=problem.marker_frame_mask.to(mesh.device),
    )
