"""Serving over tensor (and sequence) parallelism: rank 0 leads, the other ranks replay
its dispatches.

This module has no JAX counterpart. The JAX package serves over tp from a single
controller: one process drives every chip of the mesh, so its scheduler, samplers and
caches exist once and each jitted dispatch runs on every device. The port runs one
process per rank (parallel/mesh.py, parallel/launch.py), and its scheduler depends on
timing (admission, TTL, deadlines, preemption, pipelining), so the ranks cannot each run
a scheduler of their own and stay in step. Rank 0 runs the whole host side (HTTP, the
scheduler thread, the samplers, the prefix directory, tenancy and the constraint
automata); every other rank runs a follower loop that receives, for each device-side
operation, a descriptor of host data only (the op kind, token ids, positions, window,
rows and T, the block-table rows that changed, each row's sampler state and coin and
mask rows, the block ids to copy, demote or promote) and runs the same operation on its
shard in the same order, so that its collectives pair with rank 0's.

Descriptors travel over a gloo control group of their own (`ControlChannel`), kept
apart from the tp group even when that is NCCL: a pickled descriptor is host data, and
its broadcast must never interleave with the collectives of the forward pass. Rank 0
sends at most one descriptor at a time (the BatchEngine sends under its scheduler lock;
the --batch 1 server under its generation lock), and a heartbeat keeps an idle
follower's receive inside the group's timeout. A follower that raises ends its process:
the launcher then stops every local rank, and under --pod rank 0's next collective
raises.

- `ControlChannel`: the gloo group, send/recv, the heartbeat.
- `follow`: a follower's receive loop over an `apply(kind, payload)`.
- `EngineLeader` / `follow_engine`: the --batch 1 server's single-sequence Engine,
  whose generate calls are mirrored whole (the Engine broadcasts rank 0's tokens and
  stops itself: runtime/engine.py `_deliver`), over tp, sp or both: world rank 0 leads.
- The BatchEngine's operations are mirrored by the engine itself
  (runtime/batch_engine.py `_mirror` on rank 0, `follow()` / `_replay` on the others).
"""

from __future__ import annotations

import datetime
import threading
import time

import torch.distributed as dist

from .mesh import DEFAULT_TIMEOUT

# seconds of silence after which rank 0 sends a no-op descriptor: well inside the
# control group's timeout, so an idle follower's receive never times out
HEARTBEAT_S = 10.0


class ControlChannel:
    """The job's control group (gloo, every rank of the mesh, its tp and sp axes alike):
    rank 0 broadcasts (kind, payload) descriptors, every other rank receives them in
    order. Creating it is a collective: every rank constructs it at the same point."""

    def __init__(self, mesh, timeout: float = DEFAULT_TIMEOUT):
        self.rank = mesh.rank
        self.group = dist.new_group(ranks=dist.get_process_group_ranks(mesh.everyone),
                                    backend="gloo",
                                    timeout=datetime.timedelta(seconds=timeout))
        self._src = dist.get_global_rank(self.group, 0)
        self._lock = threading.Lock()
        self.sent = 0  # descriptors rank 0 sent
        self.last_t = time.monotonic()
        self.closed = False
        self._stop = threading.Event()
        self._beat: threading.Thread | None = None

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def send(self, kind: str, payload: dict | None = None) -> None:
        """Rank 0: one descriptor to every follower. A "close" ends their loops; nothing
        is sent after it."""
        if not self.leader:
            raise RuntimeError("only rank 0 sends descriptors")
        with self._lock:
            if self.closed:
                raise RuntimeError(f"control channel closed (sending {kind!r})")
            dist.broadcast_object_list([(kind, payload or {})], src=self._src,
                                       group=self.group)
            self.sent += 1
            self.last_t = time.monotonic()
            self.closed = kind == "close"

    def recv(self) -> tuple[str, dict]:
        """A follower: the next descriptor, (kind, payload)."""
        box = [None]
        dist.broadcast_object_list(box, src=self._src, group=self.group)
        return box[0]

    def start_heartbeat(self, lock_of, interval: float = HEARTBEAT_S) -> None:
        """Rank 0: send a no-op after `interval` seconds without a descriptor, under the
        lock every sender holds (`lock_of()`), so it never lands inside an operation."""
        def beat():
            while not self._stop.wait(interval / 4):
                if time.monotonic() - self.last_t < interval:
                    continue
                lock = lock_of()
                if not lock.acquire(timeout=interval / 4):
                    continue
                try:
                    if not self.closed and time.monotonic() - self.last_t >= interval:
                        self.send("noop")
                except Exception:
                    return  # the world failed: rank 0's next operation raises it
                finally:
                    lock.release()

        self._beat = threading.Thread(target=beat, daemon=True, name="tp-heartbeat")
        self._beat.start()

    def stop_heartbeat(self) -> None:
        self._stop.set()
        if self._beat is not None and self._beat is not threading.current_thread():
            self._beat.join(timeout=5)


def follow(channel: ControlChannel, apply) -> int:
    """A follower's loop: apply(kind, payload) each descriptor rank 0 sends, in order,
    until its "close"; no-ops only prove rank 0 alive. Returns the descriptors
    applied. An exception in apply propagates: the rank fails, and with it the job."""
    n = 0
    while True:
        kind, payload = channel.recv()
        if kind == "close":
            return n
        if kind != "noop":
            apply(kind, payload)
            n += 1


class EngineLeader:
    """Rank 0's single-sequence Engine in the --batch 1 server under tp: each
    generate_with call is mirrored to the followers whole (the start position after the
    prefix rewind, the tokens, the sampler's parameters and xorshift* state, the
    speculation and device-loop settings), then run here. Every other attribute is the
    Engine's. The caller's lock (the server's generation lock) serializes the calls."""

    def __init__(self, engine, channel: ControlChannel):
        self._engine = engine
        self._ctl = channel
        # set when a generation failed where the followers may not have stopped with it
        # (anything but a token callback's own exception, which the Engine broadcasts):
        # the ranks may no longer pair their collectives, and the server exits nonzero
        self.broken: BaseException | None = None

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def generate_with(self, prompt_tokens: list[int], max_tokens: int, sampler, *,
                      device_loop_chunk: int = 0, speculative_k: int = 0,
                      history_tokens: list[int] | None = None, **kw):
        eng = self._engine
        self._ctl.send("generate", {
            "pos": eng.pos, "tokens": list(prompt_tokens), "max_tokens": max_tokens,
            "temperature": float(getattr(sampler, "temperature", 0.0)),
            "topp": float(getattr(sampler, "topp", 0.9)),
            "state": int(getattr(sampler, "state", 0)),
            "device_loop_chunk": device_loop_chunk, "speculative_k": speculative_k,
            "history_tokens": None if history_tokens is None else list(history_tokens)})
        try:
            return eng.generate_with(prompt_tokens, max_tokens, sampler,
                                     device_loop_chunk=device_loop_chunk,
                                     speculative_k=speculative_k,
                                     history_tokens=history_tokens, **kw)
        except BaseException as e:
            if not getattr(e, "tp_synced", False):
                self.broken = e
            raise

    def close(self) -> None:
        """Stop the heartbeat and end the followers' loops (after the last generation:
        the caller holds the generation lock)."""
        self._ctl.stop_heartbeat()
        if not self._ctl.closed:
            self._ctl.send("close")


def follow_engine(engine, channel: ControlChannel) -> int:
    """A follower of EngineLeader: rewind to rank 0's start position, then run the same
    generate_with with a sampler in rank 0's state. Rank 0 decides every token and stop
    (the Engine broadcasts them); a generation rank 0 ended by raising ends here with
    the same cache position. Returns the generations run."""
    from ..runtime.engine import LeaderAborted
    from ..runtime.sampler import Sampler

    def apply(kind: str, p: dict) -> None:
        if kind != "generate":
            raise ValueError(f"an Engine follower cannot apply {kind!r}")
        engine.seek(p["pos"])
        smp = Sampler(engine.spec.vocab_size, p["temperature"], p["topp"])
        smp.state = type(smp.state)(p["state"])
        try:
            engine.generate_with(p["tokens"], p["max_tokens"], smp,
                                 device_loop_chunk=p["device_loop_chunk"],
                                 speculative_k=p["speculative_k"],
                                 history_tokens=p["history_tokens"])
        except LeaderAborted:
            pass

    return follow(channel, apply)
