"""Start local ranks, run a named port function on each, and fail the job as one.

The JAX package needs no launcher: its single controller drives every local device. The
port runs one process per rank (parallel/mesh.py), so `dllama --tp N --sp M` and the
tests start N·M processes here with the `spawn` start method (a fresh interpreter that
imports torch and the port, never the parent's state) and a `file://` rendezvous in a
directory the job owns (no TCP port to race for). Each rank joins the process group,
builds its Mesh on the device it is given, calls `module:function(mesh, *args)` and
leaves its return value in a file for the parent.

The parent watches every rank: one that exits nonzero (an exception, a collective that
timed out) or outlives the job's deadline makes it stop the others and raise, so a dead
peer fails the job instead of hanging it.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import shutil
import signal
import tempfile
import time

import torch
import torch.distributed as dist

from .mesh import DEFAULT_TIMEOUT, backend_for, make_mesh

_POLL_S = 0.05


class RankFailed(RuntimeError):
    """A rank of a launched job exited nonzero or did not finish in time."""


def _rank_main(rank: int, world: int, target: str, init_url: str, backend: str,
               device: str, timeout: float, args: tuple, result_path: str,
               sp: int = 1) -> None:
    """One rank: join the job, run target(mesh, *args), save what it returns."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # CPU ranks share the host's cores: with torch's default pools each rank's
        # threads spin-wait for cores the other ranks hold, and a step slows by more
        # than an order of magnitude
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init_url, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(make_mesh(tp=world // sp, sp=sp, device=dev, timeout=timeout), *args)
        torch.save(result, result_path)
        # the ranks leave together: a rank that tore its connections down first could cut
        # a peer's last receive short (a follower still reading rank 0's "close" aborted
        # with "terminate called without an active exception" under load)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _stop(procs) -> None:
    procs = [p for p in procs if p.pid is not None]  # started ones only
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def _forward_to(proc, signums):
    """Install handlers that pass each of `signums` on to `proc` (the launcher's main
    thread only); returns the handlers to restore."""
    old = {}
    for sig in signums:
        try:
            old[sig] = signal.signal(sig, lambda s, _f: proc.pid and os.kill(proc.pid, s))
        except ValueError:  # not the main thread: nothing is forwarded
            break
    return old


def run(target: str, world: int, devices, *, args: tuple = (), backend: str | None = None,
        timeout: float = DEFAULT_TIMEOUT, deadline: float | None = None,
        workdir: str | None = None, forward_signals: tuple = (), sp: int = 1) -> list:
    """Run `target` ("package.module:function", called as function(mesh, *args)) on
    `world` local ranks and return each rank's result, rank order. `sp` of them lie on
    the mesh's sp axis and world // sp on its tp axis (rank r at s = r // tp, t = r % tp).

    devices: one device for every rank ("cpu", "cuda:0": ranks may share a card) or a
    list with one device per rank. backend: gloo or nccl (default: the device's,
    parallel.mesh.backend_for). timeout: seconds a collective waits for a peer before its
    rank raises. deadline: seconds the whole job may take (None: no limit beyond the
    ranks' own timeouts). workdir: the rendezvous file and the results go there (default:
    a temporary directory, removed afterwards). forward_signals: signals this process
    passes on to rank 0 while the job runs (the tp server's SIGTERM drain, which rank 0
    runs and ends the other ranks with). Raises RankFailed when a rank exits nonzero or
    the deadline passes; every rank is stopped first."""
    devs = list(devices) if isinstance(devices, (list, tuple)) else [devices] * world
    if len(devs) != world:
        raise ValueError(f"{len(devs)} devices for {world} ranks")
    if sp < 1 or world % sp:
        raise ValueError(f"sp={sp} must divide the {world} ranks")
    backend = backend or backend_for(devs[0])
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="dllama_ranks_") if own else workdir
    rendezvous = os.path.join(os.path.abspath(workdir), "rendezvous")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)  # a file store left by an earlier job would join it
    init_url = "file://" + rendezvous
    paths = [os.path.join(workdir, f"rank{r}.pt") for r in range(world)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, world, target, init_url, backend, str(devs[r]), timeout,
                               args, paths[r], sp))
             for r in range(world)]
    end = None if deadline is None else time.monotonic() + deadline
    restore = {}
    try:
        for p in procs:
            p.start()
        restore = _forward_to(procs[0], forward_signals)
        while True:
            codes = [p.exitcode for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                _stop(procs)
                raise RankFailed(f"rank {failed[0][0]} of {world} exited with code "
                                 f"{failed[0][1]} ({target}); the job was stopped")
            if all(c == 0 for c in codes):
                break
            if end is not None and time.monotonic() > end:
                _stop(procs)
                raise RankFailed(f"{target} on {world} ranks did not finish within "
                                 f"{deadline:.0f} s; the job was stopped")
            time.sleep(_POLL_S)
        return [torch.load(p, weights_only=False) for p in paths]
    finally:
        for sig, handler in restore.items():
            signal.signal(sig, handler)
        _stop(procs)
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
