"""The process mesh: one process per rank over torch.distributed.

The counterpart of the JAX package's parallel/mesh.py. There a single controller drives
every chip through a jax.sharding.Mesh with the named axes dp, sp and tp. Here each rank
is a process of its own (parallel/launch.py starts local ranks, `dllama --pod` joins one
process per host), and a `Mesh` is what one rank knows of the job: its rank, the axis
sizes, the process groups of its tp and sp axes and of the whole job, and the device it
runs on.

The axes keep the JAX names (dp: independent sequences, sp: ring attention over the KV
sequence axis, tp: tensor parallelism, the reference's nSlices). The grid is (sp, tp):
rank r sits at s = r // tp, t = r % tp, as JAX's `reshape(dp, sp, tp)` lays devices
out. Each s has a tp group (the merge points' collectives), each t an sp group (the
ring's shifts); the world group carries what every rank must hear (the sampled token,
the stop decision). dp > 1 is refused (ROADMAP Queue A: dp on this grid).

The rank's device is always the caller's: nothing here picks a device by local rank, so
several ranks may share one card (gloo stages CUDA tensors through the host) or run on
the CPU. The backend follows the device (cpu: gloo, cuda: nccl) unless the caller names
one, and nothing switches it after a failure.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from .traffic import TrafficCounter

AXIS_DP, AXIS_SP, AXIS_TP = "dp", "sp", "tp"

# seconds a collective (and the rendezvous) may wait for a peer before it raises: a dead
# peer fails the job instead of hanging it
DEFAULT_TIMEOUT = 300.0


@dataclass
class Mesh:
    """One rank's view of a (dp, sp, tp) job: `rank` is its rank in the job (r = s·tp +
    t), `group` the tp axis's process group and `sp_group` the sp axis's (None for a
    one-member axis that needs no peers), `world_group` every rank of the job (None: the
    tp group, which a job without sp is), `device` the torch device this rank computes
    on, `counter` the collectives this rank issued (parallel/traffic.py)."""

    rank: int
    shape: dict
    group: object
    device: torch.device
    backend: str | None = None
    counter: TrafficCounter = field(default_factory=TrafficCounter)
    sp_group: object = None
    world_group: object = None

    @property
    def tp(self) -> int:
        return self.shape[AXIS_TP]

    @property
    def sp(self) -> int:
        return self.shape.get(AXIS_SP, 1)

    @property
    def size(self) -> int:
        """Ranks in the job: dp·sp·tp."""
        return self.shape.get(AXIS_DP, 1) * self.sp * self.tp

    @property
    def tp_rank(self) -> int:
        """This rank's index on the tp axis (its weight and KV-head shard)."""
        return self.rank % self.tp

    @property
    def sp_rank(self) -> int:
        """This rank's index on the sp axis (its stripe of the KV sequence axis)."""
        return self.rank // self.tp % self.sp

    @property
    def everyone(self):
        """The group of every rank in the job (None for a job of one)."""
        return self.world_group if self.world_group is not None else self.group


def backend_for(device) -> str:
    """The default backend of a device type: gloo on the CPU, nccl on a card."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _refuse_dp(dp: int | None) -> None:
    if dp not in (None, 1):
        raise ValueError(f"dp={dp}: data parallelism over the mesh is not in the port yet "
                         "(ROADMAP Queue A item 1 (a): dp, on the (sp, tp) grid)")


def make_mesh(tp: int | None = None, sp: int = 1, dp: int = 1, *, device=None,
              group=None, timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """This rank's (dp, sp, tp) mesh. tp defaults to the world size of the initialized
    process group over sp (1 without one); `group` (default: the whole world) holds the
    job's sp·tp ranks. More than one rank needs an initialized process group of exactly
    that many; a mesh of one needs none. Under sp > 1 and tp > 1 every rank creates every
    tp group and then every sp group, in one order, as torch.distributed's new_group
    needs (`timeout`: their collectives' wait for a peer). `device` is this rank's device
    (default: the current CUDA device)."""
    _refuse_dp(dp)
    if sp < 1:
        raise ValueError(f"sp={sp} must be at least 1")
    ready = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size(group) if ready else 1
    if tp is None:
        if world % sp:
            raise ValueError(f"sp={sp} must divide the process group's {world} ranks")
        tp = world // sp
    if tp < 1:
        raise ValueError(f"tp={tp} must be at least 1")
    n = sp * tp
    if n > 1 and not ready:
        raise RuntimeError(f"a mesh of {n} ranks (sp={sp}, tp={tp}) needs an initialized "
                           "torch.distributed process group (parallel.mesh.init_multihost, "
                           "or the ranks that parallel/launch.py starts)")
    if n > 1 and world != n:
        raise ValueError(f"mesh 1x{sp}x{tp} needs {n} ranks, the process group has "
                         f"{world}")
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    if n == 1:
        return Mesh(rank=0, shape={AXIS_DP: 1, AXIS_SP: 1, AXIS_TP: 1}, group=None,
                    device=dev)
    whole = group if group is not None else dist.group.WORLD
    rank = dist.get_rank(whole)
    members = dist.get_process_group_ranks(whole)
    tp_grp, sp_grp = _axis_groups(whole, members, rank, sp, tp, timeout)
    return Mesh(rank=rank, shape={AXIS_DP: 1, AXIS_SP: sp, AXIS_TP: tp}, group=tp_grp,
                device=dev, backend=dist.get_backend(whole), sp_group=sp_grp,
                world_group=whole)


def _axis_groups(whole, members: list[int], rank: int, sp: int, tp: int,
                 timeout: float):
    """This rank's tp and sp groups of the (sp, tp) grid over the group `whole`, whose
    global ranks are `members` in group rank order: `whole` where one axis spans it,
    None for a one-member axis, else one new group per row (tp) or column (sp), every
    one created in one order on every rank."""
    if sp == 1 or tp == 1:
        return (whole if tp > 1 else None), (whole if sp > 1 else None)
    s, t = divmod(rank, tp)
    td = datetime.timedelta(seconds=timeout)
    rows = [dist.new_group([members[i * tp + j] for j in range(tp)], timeout=td)
            for i in range(sp)]
    cols = [dist.new_group([members[i * tp + j] for i in range(sp)], timeout=td)
            for j in range(tp)]
    return rows[s], cols[t]


def init_multihost(coordinator: str | None, num_processes: int, process_id: int,
                   backend: str, timeout: float = DEFAULT_TIMEOUT) -> int:
    """Join a job of `num_processes` processes (the reference's `dllama worker` plus
    `--workers host:port` bootstrap, src/apps/dllama/dllama.cpp:205-221). Every process
    runs the same program; `coordinator` is the rendezvous: "host:port" (TCP, the
    process with id 0 listens there) or a "tcp://" or "file://" URL. The backend is the
    caller's choice (backend_for gives the device's default). Collectives and the
    rendezvous raise after `timeout` seconds without a peer. Returns this process's
    rank."""
    if not coordinator:
        raise ValueError("a torch.distributed job needs its coordinator: --coordinator "
                         "host:port (or a tcp:// or file:// URL)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside a job of {num_processes}")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))
    return dist.get_rank()


def make_pod_mesh(tp: int | None = None, sp: int = 1, dp: int | None = None, *,
                  device=None) -> Mesh:
    """The (sp, tp) mesh over every process of a multi-process job (after
    init_multihost); tp defaults to world // sp. The JAX package places dp across slices
    and sp and tp inside one; with dp refused here, the job is one (sp, tp) grid."""
    _refuse_dp(dp)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_pod_mesh needs init_multihost first")
    world = dist.get_world_size()
    if sp < 1 or world % sp:
        raise ValueError(f"sp={sp} must divide the job's {world} processes")
    if tp is None:
        tp = world // sp
    if tp * sp != world:
        raise ValueError(f"tp={tp} x sp={sp} must span the job's {world} processes (dp "
                         "is not in the port yet)")
    return make_mesh(tp=tp, sp=sp, device=device)
