"""Process groups, solver meshes, and the collectives of the sharded paths.

A port of `clarabel_tpu/parallel/multihost.py`.  The reference is
single-controller: one process holds a `jax.sharding.Mesh` and `lax.psum`
reduces over an axis.  The port runs one process per rank (SPMD, as
`torchrun` or `torch.multiprocessing` start them): the mesh is a
`torch.distributed.device_mesh.DeviceMesh` with dims ("dp", "tp"), and a
psum over an axis is `all_reduce` over that dim's process group
(DEVIATIONS.md #20).  The two axes of the solver sit on the two tiers of
the interconnect:

* dp (independent instances of a batch): no communication until the one
  gather at the end, so it may cross nodes;
* tp (the block-arrow factorization of one problem): all-reduces in every
  IPM iteration, so it stays within one node, on NVLink.

    initialize_distributed()          # no-op without torchrun's environment
    mesh = make_solver_mesh(dp=2, tp=4)
    print(mesh_placement_report(mesh))
"""

import os
import time
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Initialize the default process group of a multi-process run and
    return True; a no-op returning False when neither the arguments nor
    the torchrun environment (MASTER_ADDR with WORLD_SIZE) ask for more
    than one process, so single-process scripts may call it.  The backend
    is NCCL on a card; gloo only when the caller asks for it."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ
    if world_size is None and env:
        world_size = int(os.environ["WORLD_SIZE"])
    if world_size is None or world_size <= 1:
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for NCCL; pass "
                               "backend='gloo' to run on the CPU")
        backend = "nccl"
    if backend == "nccl":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def local_rank() -> int:
    """This process's rank on its node: LOCAL_RANK where the launcher sets
    it, else its global rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def _local_world_size(world: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def make_solver_mesh(dp: Optional[int] = None, tp: int = 1,
                     device_type: Optional[str] = None):
    """A ("dp", "tp") DeviceMesh over the first dp·tp ranks of the
    initialized default group, tp within one node and dp across them
    (the reference's placement: tp on ICI, here NVLink).  dp defaults to
    world // tp; device_type to "cuda" when a card is present, else
    "cpu".  Raises ValueError for a mesh larger than the world, or a tp
    that does not fit, or split, one node's ranks (LOCAL_WORLD_SIZE)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_solver_mesh needs an initialized process "
                           "group (initialize_distributed)")
    world = dist.get_world_size()
    if dp is None:
        dp = world // tp
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh {dp}x{tp} is empty")
    if dp * tp > world:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks, have "
                         f"{world}")
    local = _local_world_size(world)
    if tp > local or local % tp:
        raise ValueError(
            f"tp={tp} does not split the {local} ranks of one node; "
            "per-iteration Schur collectives must stay on NVLink")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cuda":
        # the rank's own card, before DeviceMesh picks one
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    ranks = torch.arange(dp * tp).view(dp, tp)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("dp", "tp"))


def mesh_placement_report(mesh) -> str:
    """Which axis of a solver mesh stays on a node and which crosses
    nodes."""
    check_mesh(mesh)
    names = mesh.mesh_dim_names or tuple(str(i) for i in
                                         range(mesh.ndim))
    world = dist.get_world_size()
    nodes = max(1, world // _local_world_size(world))
    lines = [f"mesh axes: {dict(zip(names, mesh.shape))}",
             f"processes: {world} on {nodes} node(s), device "
             f"{mesh.device_type}"]
    if nodes > 1:
        lines.append("dp axis: across nodes, then a node's ranks")
        lines.append("tp axis: one node's ranks only (NVLink collectives)")
    else:
        lines.append("single node: all axes on local devices")
    return "\n".join(lines)


# ---- the sharded paths' helpers ----

def check_mesh(mesh):
    """`mesh` itself, or TypeError when it is not a DeviceMesh."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed.device_mesh."
                        f"DeviceMesh, got {type(mesh).__name__}")
    return mesh


def tp_axis_of(mesh):
    """The axis the block-arrow factorization shards over: "tp" where the
    mesh names it, else its first dim (reference api.py:128-132)."""
    names = mesh.mesh_dim_names
    if names is None:
        return 0
    return "tp" if "tp" in names else names[0]


def mesh_key(mesh) -> tuple:
    """What a built solve depends on: the mesh's shape, dim names and this
    rank's coordinates."""
    return (tuple(mesh.shape), mesh.mesh_dim_names,
            tuple(mesh.get_coordinate() or ()))


def mesh_device(device) -> torch.device:
    """A rank's device: its own card, cuda:{LOCAL_RANK % device_count()},
    when None (RuntimeError with no card; a CPU mesh passes "cpu")."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run a "
                "CPU mesh")
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def capturable(group) -> bool:
    """Whether collectives over `group` can run inside a CUDA graph: NCCL's
    can (once the communicator is live), gloo's cannot."""
    return dist.get_backend(group) == "nccl"


def same_on_every_rank(value: int, mesh, device) -> bool:
    """Whether an integer (below 2**62) is the same on every rank of the
    mesh: its least and greatest values, all-reduced dim by dim."""
    lo = torch.tensor([value], dtype=torch.int64, device=device)
    hi = lo.clone()
    for d in range(mesh.ndim):
        group = mesh.get_group(d)
        all_reduce(lo, group, dist.ReduceOp.MIN)
        all_reduce(hi, group, dist.ReduceOp.MAX)
    return int(lo) == int(hi)


class CollectiveStats:
    """The all-reduces the sharded paths ran: `calls` (a captured one
    counts once, at its capture) and, with `timed` set, the host seconds
    spent in the eager ones, each bracketed by synchronizations with the
    card (which the timing itself adds)."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self):
        self.calls = 0
        self.seconds = 0.0


collectives = CollectiveStats()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce `t` in place over `group` and return it: the port's
    psum over a mesh axis."""
    timed = collectives.timed and not (
        t.is_cuda and torch.cuda.is_current_stream_capturing())
    if timed:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
    dist.all_reduce(t, op=op, group=group)
    if timed:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        collectives.seconds += time.perf_counter() - t0
    collectives.calls += 1
    return t
