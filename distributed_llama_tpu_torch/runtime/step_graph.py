"""Captured decode steps: the port's counterpart of `jax.jit` on the T=1 decode paths.

A step is a function of static device buffers: it reads its inputs from tensors that
live as long as the engine (token(s), position(s), block tables, sampler state,
temperature, top-p, budgets and a step counter) and writes its results into buffers of
the same kind, or returns them. On the card `StepGraphs.run` captures a step once per
key — (path, sampling mode, window bucket, rows) — in a CUDA graph and replays it: one
graph launch for the whole step in place of the ~40 launches per layer the host queues
one by one. Before a capture the step runs once on a side stream, so lazy set-up
(kernel libraries, occupancy queries, workspace buffers) happens outside the capture;
the buffers the step advances from their own values (`carry`) are put back afterwards,
so that warm-up costs no step. Every graph of one StepGraphs shares one memory pool,
and graphs are replayed one at a time on the caller's stream: a graph's static output
is valid until the next replay of any of them.

A capture or replay that fails raises; nothing continues eagerly in its place. On the
CPU (and on the card with graphs off) `run` calls the step itself: that is how the CPU
tests cover the device-position forward pass and the loops' semantics.

`copy_to_host` is the fence of the loops: a non-blocking copy of device results into
pinned host memory, waited for only when the host reads them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


class _Captured:
    __slots__ = ("graph", "out", "replays")

    def __init__(self, graph, out):
        self.graph = graph
        self.out = out
        self.replays = 0


class StepGraphs:
    """A cache of captured steps for one engine (one memory pool).

    `enabled` only on a CUDA device. `keep` keeps each captured graph's
    cudaGraph_t (and its debug dump) so a caller can read its nodes and edges
    (`graph(key)`); it is off on the serving path."""

    def __init__(self, device, enabled: bool, keep: bool = False):
        self.enabled = bool(enabled)
        if self.enabled and torch.device(device).type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
        self.keep = keep
        self._pool = None
        self._graphs: dict[tuple, _Captured] = {}
        self.captures = 0  # graphs captured (each after one warm-up step)
        self.replays = 0  # graph replays, all keys

    def keys(self) -> list[tuple]:
        return list(self._graphs)

    def reset(self) -> None:
        """Drop every captured graph and their memory pool (an engine re-initialization:
        each key is captured again at its next use, in a fresh pool). The counters
        stay. Calls nothing that waits for the device; a graph's memory returns to the
        allocator once nothing holds its static outputs."""
        self._graphs = {}
        self._pool = None

    def graph(self, key: tuple) -> torch.cuda.CUDAGraph:
        return self._graphs[key].graph

    def replays_of(self, key: tuple) -> int:
        return self._graphs[key].replays

    def run(self, key: tuple, step: Callable[[], object], carry: tuple = ()):
        """One step: replay key's graph, capturing `step` first; where graphs are off,
        step(). `carry` lists the buffers the step updates from their own values (a
        token fed back, a position, a step counter, sampler state); the warm-up before
        a capture restores them. Returns the step's result."""
        if not self.enabled:
            return step()
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._graphs[key] = self._capture(key, step, carry)
        cap.graph.replay()
        cap.replays += 1
        self.replays += 1
        return cap.out

    def _capture(self, key: tuple, step, carry) -> _Captured:
        cur = torch.cuda.current_stream()
        saved = [t.clone() for t in carry]
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            step()  # warm-up: lazy set-up outside the capture; its KV writes are the
            for t, s in zip(carry, saved):  # ones the first replay makes again
                t.copy_(s)
        cur.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph(keep_graph=self.keep)
        if self.keep:
            graph.enable_debug_mode()
        # thread_local: the serving engine captures on its scheduler thread while
        # other threads (HTTP handlers, a profiler) stay alive
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            out = step()
        if self.keep:
            graph.instantiate()
        self.captures += 1
        return _Captured(graph, out)


def copy_to_host(*tensors: torch.Tensor) -> Callable[[], list[np.ndarray]]:
    """Start copying `tensors` to the host without waiting (pinned buffers, one event on
    the current stream); returns a function that waits for the copies and gives numpy
    arrays. CPU tensors are copied at once (a later step may overwrite them)."""
    if not tensors or tensors[0].device.type != "cuda":
        arrays = [t.numpy().copy() for t in tensors]
        return lambda: arrays
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait() -> list[np.ndarray]:
        done.synchronize()
        return [h.numpy() for h in hosts]
    return wait


def upload(dst: torch.Tensor, values) -> None:
    """Write host values into a device buffer in stream order, without waiting for the
    card (pinned staging on CUDA; the caching host allocator keeps the staging buffer
    until the copy has run)."""
    src = torch.as_tensor(np.asarray(values), dtype=dst.dtype).reshape(dst.shape)
    if dst.device.type == "cuda":
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)
