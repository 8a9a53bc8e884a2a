"""Multi-process entry point: torch.distributed bootstrap and meshes.

Port of mayamatchmovesolver_tpu/parallel/multihost.py.  One process
(rank) drives one device:

  * `initialize()` joins the process group from the torchrun contract
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK); after it
    the frame mesh spans every rank and its collectives cross hosts.
    NCCL on CUDA devices, gloo on the CPU; gloo also carries all_reduce
    on CUDA tensors, which lets two ranks share one card.
  * `host_mesh()` builds a 2-D (hosts, chips) DeviceMesh whose outer axis
    crosses hosts and inner axis stays on a host; `frame_mesh()` is the
    1-D frame mesh over every rank that parallel.sharded and
    parallel.ba_sharded take.  Ranks are numbered host by host, so a
    blocked frame split keeps neighbouring frame blocks on one host.
  * rank 0 is the result owner: `gather_to_primary()` collects every
    rank's piece on every rank (allgather semantics) so rank 0 can write
    results; `is_primary()` gates file output.

Launch with `torchrun --nproc-per-node=N script.py` (one rank a card,
NCCL), or start the processes yourself with the variables above set.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from mayamatchmovesolver_torch.parallel.sharded import make_frame_mesh


def _initialized():
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_rank=None, device="cuda",
               backend=None):
    """Join the process group (no-op when single-process).

    Reads MASTER_ADDR:MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK when
    arguments are omitted — the torchrun contract.  Safe to call
    unconditionally: with no address configured the process stays
    single-process and this returns False.  The backend follows
    `device`: NCCL for "cuda" (the rank's card is cuda:local_rank), gloo
    for "cpu"; `backend="gloo"` with "cuda" lets several ranks share one
    card (pass local_rank=0 to each).
    """
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = "%s:%s" % (
            os.environ["MASTER_ADDR"], os.environ.get("MASTER_PORT", "29500"))
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
        if backend == "nccl":
            kwargs["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(
        backend, init_method="tcp://%s" % coordinator_address,
        world_size=int(num_processes), rank=int(process_id), **kwargs,
    )
    return True


def is_primary():
    """True on the result-owning process (global rank 0)."""
    return not _initialized() or dist.get_rank() == 0


def _local_world():
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def num_hosts():
    """Nodes: the world size over the ranks on one host (torchrun's
    LOCAL_WORLD_SIZE; all on one host when it is unset)."""
    if not _initialized():
        return 1
    return max(1, dist.get_world_size() // _local_world())


def host_mesh(axis_names=("dcn", "chips"), device_type="cuda"):
    """Global 2-D DeviceMesh (hosts x ranks on a host).

    The outer axis crosses hosts, the inner axis stays on a host.
    Requires an initialised process group and the same number of ranks
    on every host.
    """
    if not _initialized():
        raise RuntimeError("host_mesh needs a process group: call "
                           "initialize() first")
    from torch.distributed.device_mesh import init_device_mesh

    world, n_hosts = dist.get_world_size(), num_hosts()
    per_host = world // n_hosts
    if per_host * n_hosts != world:
        raise ValueError(
            "uneven device distribution: %d devices / %d hosts"
            % (world, n_hosts)
        )
    return init_device_mesh(device_type, (n_hosts, per_host),
                            mesh_dim_names=tuple(axis_names))


def frame_mesh(axis_name="frames", device=None):
    """1-D mesh over every rank — the frame-block axis used by
    parallel.sharded / parallel.ba_sharded — on this rank's device
    (default the current CUDA device; "cpu" for gloo on the CPU)."""
    return make_frame_mesh(device, axis_name)


def gather_to_primary(x):
    """Every rank's piece of `x`, concatenated along axis 0 in rank order,
    as a host numpy array on every rank (allgather semantics; rank 0
    writes results, as the reference writes solved values back to Maya
    attrs, adjust_base.cpp:297-342).  Single-process: `x` as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if not _initialized():
        return x
    pieces = [None] * dist.get_world_size()
    dist.all_gather_object(pieces, x)
    return np.concatenate(pieces, axis=0)


def sync_hosts(name="barrier"):
    """Barrier over every rank (useful before timing sections).  `name`
    labels the call site, as in the reference."""
    if not _initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
