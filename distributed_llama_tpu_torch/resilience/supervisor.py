"""Hung-engine supervisor: a copy of the JAX package's resilience/supervisor.py without
its state gauge.

A daemon thread polls `engine.dispatch_age()`; past `threshold` seconds it escalates:

1. this supervisor (and so the server's /healthz) turns unhealthy, so a fleet router
   takes the replica out of rotation and resumes its journaled requests elsewhere;
2. `engine.recover_wedged()` fails every in-flight and queued request with the
   retriable EngineWedged, abandons the stuck scheduler thread (an epoch bump) and
   re-initializes the engine (runtime/batch_engine.py);
3. after a re-init that succeeded it is healthy again. `max_recoveries` escalations
   with no completed dispatch between them mark the engine FAILED: /healthz stays
   unhealthy and the operator takes over, rather than the supervisor re-initializing a
   dead device for ever.
"""

from __future__ import annotations

import threading
import time

__all__ = ["EngineSupervisor"]


class EngineSupervisor:
    """Watch one BatchEngine-shaped object (`dispatch_age()`, `recover_wedged()`,
    `scheduler_alive()`) and act on a hang.

    `threshold` — dispatch age (seconds) past which the engine counts as wedged; it
    must exceed the slowest legitimate dispatch, a CUDA graph capture (the first
    dispatch after a recovery captures again) or an eager prefill included: the
    recovery cannot stop a thread that is still launching, whose kernels then write
    into the pool the next requests are given. `poll` — the sampling period; detection
    takes up to threshold + poll. `max_recoveries` — consecutive recoveries (no
    completed dispatch between them) before the supervisor gives up."""

    def __init__(self, engine, threshold: float = 60.0, poll: float = 1.0,
                 max_recoveries: int = 3):
        assert threshold > 0, "use threshold > 0 (0 disables the supervisor)"
        self.engine = engine
        self.threshold = float(threshold)
        self.poll = float(poll)
        self.max_recoveries = max_recoveries
        self.state = "ok"  # ok | recovering | failed
        self.recoveries = 0  # lifetime escalations
        self._consecutive = 0  # escalations without dispatch progress between them
        self._progress_mark = self._progress()
        self.last_recovery_t: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def healthy(self) -> bool:
        """False while a recovery runs or after the engine failed: what /healthz folds
        in."""
        return self.state == "ok"

    def stats(self) -> dict:
        return {"state": self.state, "threshold_s": self.threshold,
                "recoveries": self.recoveries,
                "dispatch_age_s": round(self.engine.dispatch_age(), 3)}

    def start(self) -> "EngineSupervisor":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="engine-supervisor")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll + 1.0)

    def _run(self) -> None:
        while not self._stop.wait(self.poll):
            try:
                self.check_once()
            except Exception as e:  # the supervisor itself must not die
                print(f"⚠️  supervisor check failed: {e!r}")

    def _progress(self) -> tuple:
        """Counters only a completed dispatch advances. An idle age of 0 right after a
        recovery is no evidence that the engine works, so the consecutive-escalation
        count resets only on these: a device that fails every launch reaches the
        terminal 'failed' state instead of cycling ok -> wedged for ever."""
        eng = self.engine
        return (getattr(eng, "decode_steps", 0), getattr(eng, "prefilled_tokens", 0))

    def check_once(self) -> None:
        """One watchdog sample and escalation decision (the loop's body; tests call it
        directly)."""
        if self.state == "failed":
            return
        age = self.engine.dispatch_age()
        if age <= self.threshold:
            if self._consecutive and self._progress() != self._progress_mark:
                # dispatches completed since the last escalation: isolated wedges over
                # a long uptime never add up to "failed"
                self._consecutive = 0
            return
        self._escalate(age)

    def _escalate(self, age: float) -> None:
        self.state = "recovering"
        self.recoveries += 1
        self._consecutive += 1
        self._progress_mark = self._progress()
        self.last_recovery_t = time.monotonic()
        print(f"🔴 supervisor: engine made no dispatch progress for {age:.1f}s "
              f"(threshold {self.threshold:.1f}s) — failing in-flight requests "
              f"(retriable) and re-initializing (recovery "
              f"{self._consecutive}/{self.max_recoveries})")
        ok = False
        try:
            ok = self.engine.recover_wedged()
        except Exception as e:
            print(f"🔴 supervisor: recover_wedged raised: {e!r}")
        if not ok or self._consecutive >= self.max_recoveries:
            self.state = "failed"
            print(f"🔴 supervisor: engine marked FAILED (reinit_ok={ok}, "
                  f"consecutive={self._consecutive}) — /healthz stays unhealthy; "
                  "restart the replica")
        else:
            self.state = "ok"
