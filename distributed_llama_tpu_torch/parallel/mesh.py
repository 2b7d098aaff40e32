"""The process mesh: one process per rank over torch.distributed.

The counterpart of the JAX package's parallel/mesh.py. There a single controller drives
every chip through a jax.sharding.Mesh with the named axes dp, sp and tp. Here each rank
is a process of its own (parallel/launch.py starts local ranks, `dllama --pod` joins one
process per host), and a `Mesh` is what one rank knows of the job: its rank, the axis
sizes, the process group of the tp axis and the device it runs on.

The axes keep the JAX names (dp: independent sequences, sp: ring attention over the KV
sequence axis, tp: tensor parallelism, the reference's nSlices). Only tp is wired in the
port so far; dp > 1 and sp > 1 are refused (ROADMAP Queue A items 1 (a) and 2).

The rank's device is always the caller's: nothing here picks a device by local rank, so
two ranks may share one card (gloo stages CUDA tensors through the host) or run on the
CPU. The backend follows the device (cpu: gloo, cuda: nccl) unless the caller names one,
and nothing switches it after a failure.
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
    """One rank's view of a (dp, sp, tp) job: `group` is the tp axis's process group
    (None for a one-member axis that needs no peers), `device` the torch device this rank
    computes on, `counter` the collectives this rank issued (parallel/traffic.py)."""

    rank: int
    shape: dict
    group: object
    device: torch.device
    backend: str | None = None
    counter: TrafficCounter = field(default_factory=TrafficCounter)

    @property
    def tp(self) -> int:
        return self.shape[AXIS_TP]


def backend_for(device) -> str:
    """The default backend of a device type: gloo on the CPU, nccl on a card."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _refuse_axes(sp: int, dp: int | None) -> None:
    if sp != 1:
        raise ValueError(f"sp={sp}: ring attention and --sp are not in the port yet "
                         "(ROADMAP Queue A item 2)")
    if dp not in (None, 1):
        raise ValueError(f"dp={dp}: data parallelism over the mesh is not in the port yet "
                         "(ROADMAP Queue A item 1 (a): dp, a two-axis process grid)")


def make_mesh(tp: int | None = None, sp: int = 1, dp: int = 1, *, device=None,
              group=None) -> Mesh:
    """This rank's (dp, sp, tp) mesh. tp defaults to the world size of the initialized
    process group (1 without one); `group` (default: the whole world) carries the tp
    axis. A tp > 1 needs an initialized process group whose world is tp ranks; a tp of 1
    needs none. `device` is this rank's device (default: the current CUDA device)."""
    _refuse_axes(sp, dp)
    ready = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size(group) if ready else 1
    if tp is None:
        tp = world
    if tp < 1:
        raise ValueError(f"tp={tp} must be at least 1")
    if tp > 1 and not ready:
        raise RuntimeError(f"tp={tp} needs an initialized torch.distributed process group "
                           "(parallel.mesh.init_multihost, or the ranks that "
                           "parallel/launch.py starts)")
    if tp > 1 and world != tp:
        raise ValueError(f"mesh 1x1x{tp} needs {tp} ranks, the process group has {world}")
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    rank = dist.get_rank(group) if ready and tp > 1 else 0
    grp = (group if group is not None else dist.group.WORLD) if tp > 1 else None
    return Mesh(rank=rank, shape={AXIS_DP: 1, AXIS_SP: 1, AXIS_TP: tp}, group=grp,
                device=dev, backend=dist.get_backend(grp) if grp is not None else None)


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
    """The mesh over every process of a multi-process job (after init_multihost): all
    ranks on the tp axis. The JAX package places dp across slices and tp inside one;
    with dp and sp refused here, the whole job is one tp group."""
    _refuse_axes(sp, dp)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_pod_mesh needs init_multihost first")
    world = dist.get_world_size()
    if tp is not None and tp != world:
        raise ValueError(f"tp={tp} must span the job's {world} processes (dp and sp are "
                         "not in the port yet)")
    return make_mesh(tp=world, device=device)
