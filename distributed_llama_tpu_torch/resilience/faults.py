"""Deterministic fault injection for the port's serving runtime: a copy of the JAX
package's resilience/faults.py, with its metric family and flight-recorder hook.

- **Injection points** are `faults.fire("name", **ctx)` calls in the runtime:
  `batch.submit`, `batch.dispatch` (kind, attempt), `batch.prefill` (slot, pending),
  `batch.emit` (slot, n_out), `batch.cache_seed` (slot), `batch.verify` (rows, block),
  `engine.dispatch` (t, pos), `engine.reinit`, `device_loop.dispatch` (n_steps),
  `device_loop.batched_dispatch` (n_steps), `device_loop.verify_dispatch` (block),
  `api.request` (replica), `constrain.compile` (kind), `constrain.mask` (slot: an error
  degrades that row to unconstrained decoding), `draft.load`, `draft.propose` (rows) and
  `draft.dispatch` (steps) (an error gives way to n-gram drafting), `paged.append` (pos)
  and `paged.cold_attend` (layer) (the host KV spill). Every point fires on
  the host before the device work it guards, never inside a step a CUDA graph captures
  (there it would fire only at the capture).
- **FaultSpec** says what happens at a point: raise an error (with a declared
  blast-radius `scope`), raise a TransientDispatchError (the scheduler retries these),
  or sleep (a latency spike). Specs select by point name (fnmatch glob), a context
  match (e.g. `match={"slot": 1}`), a per-fire probability, a skip-first-N `after`, a
  max-fires `count` and a sustained window `duration_s`.
- **Determinism**: probability draws come from one `random.Random(seed)` per plan, so
  a chaos run replays exactly under the same seed and schedule.
- **Activation**: `faults.active(...)` (a context manager, tests), `faults.install(...)`
  (process-wide) or the `DLLAMA_FAULTS` environment variable, read by
  `install_from_env()` in the dllama and api_server entry points:

      DLLAMA_FAULTS="point:kind[:prob[:count[:delay_ms[:duration_s]]]][,...]"
      DLLAMA_FAULT_SEED=7

With no plan installed `fire()` is one module-global None check. `release()` (not in
the JAX module) wakes every thread parked in a latency fault at once: a test or the
chip smoke parks the scheduler in a long stall, recovers the engine, then wakes the
abandoned thread to show it makes no launch.
"""

from __future__ import annotations

import fnmatch
import os
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from ..obs import flight, metrics
from .errors import FaultInjected, TransientDispatchError

__all__ = ["KINDS", "FaultSpec", "FaultPlan", "fire", "install", "uninstall", "active",
           "current", "parse_faults", "install_from_env", "release"]

KINDS = ("error", "transient", "latency")

_INJECTED = metrics.counter(
    "faults_injected_total",
    "Faults fired by the injection framework (docs/ROBUSTNESS.md)",
    labelnames=("point", "kind"))

_WAKE = threading.Condition()  # guards: _wakes
_wakes = 0  # release() calls


def _stall(seconds: float) -> None:
    """A latency fault's sleep, cut short by release()."""
    with _WAKE:
        mark = _wakes
        _WAKE.wait_for(lambda: _wakes != mark, timeout=seconds)


def release() -> None:
    """Wake every thread parked in a latency fault now."""
    global _wakes
    with _WAKE:
        _wakes += 1
        _WAKE.notify_all()


@dataclass
class FaultSpec:
    """One injection rule. `point` is an exact name or fnmatch glob ("batch.*"); `kind`
    is error | transient | latency; `scope` is the blast radius an error fault promises
    (the point fires before the guarded operation touches shared state, so "request" is
    sound at the per-request points); `match` filters on the fire site's context."""

    point: str
    kind: str = "error"
    prob: float = 1.0
    count: int | None = None  # max fires (None = unlimited)
    after: int = 0  # skip the first N matching hits
    delay_ms: float = 25.0  # latency kind: the injected stall
    scope: str = "request"  # error kind: request | engine
    match: dict = field(default_factory=dict)
    # sustained window: the spec stops firing duration_s seconds after its first fire
    duration_s: float | None = None
    seen: int = 0  # matching hits observed
    fired: int = 0  # faults injected
    first_fire_t: float = 0.0  # monotonic time of the first fire

    def __post_init__(self):
        assert self.kind in KINDS, f"unknown fault kind {self.kind!r}"
        assert self.scope in ("request", "engine"), self.scope
        assert 0.0 <= self.prob <= 1.0, self.prob


class FaultPlan:
    """An installed set of FaultSpecs sharing one seeded RNG."""

    def __init__(self, specs, seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()  # guards: specs' seen/fired/first_fire_t, _rng

    def fired(self) -> int:
        return sum(s.fired for s in self.specs)

    def fire(self, point: str, **ctx) -> None:
        for spec in self.specs:
            if not fnmatch.fnmatchcase(point, spec.point):
                continue
            if any(ctx.get(k) != v for k, v in spec.match.items()):
                continue
            with self._lock:
                spec.seen += 1
                if spec.seen <= spec.after:
                    continue
                if spec.count is not None and spec.fired >= spec.count:
                    continue
                if (spec.duration_s is not None and spec.first_fire_t
                        and time.monotonic() - spec.first_fire_t > spec.duration_s):
                    continue
                if spec.prob < 1.0 and self._rng.random() >= spec.prob:
                    continue
                spec.fired += 1
                if not spec.first_fire_t:
                    spec.first_fire_t = time.monotonic()
            _INJECTED.labels(point=point, kind=spec.kind).inc()
            # a point that fires inside a request's bound trace context lands the fault
            # on that request's flight timeline (GET /v1/requests/<id>)
            flight.note_fault(point, spec.kind)
            if spec.kind == "latency":
                _stall(spec.delay_ms / 1000.0)
                continue  # a latency spike does not shadow later error specs
            if spec.kind == "transient":
                raise TransientDispatchError(f"injected transient fault at {point}")
            raise FaultInjected(f"injected fault at {point}", scope=spec.scope)


_PLAN: FaultPlan | None = None


def fire(point: str, **ctx) -> None:
    """Injection-point hook: a no-op unless a plan is installed. The context kwargs are
    matched against each spec's `match`."""
    plan = _PLAN
    if plan is not None:
        plan.fire(point, **ctx)


def install(specs, seed: int = 0) -> FaultPlan:
    """Install a plan process-wide (replacing any previous one). Takes a FaultPlan or an
    iterable of FaultSpecs."""
    global _PLAN
    plan = specs if isinstance(specs, FaultPlan) else FaultPlan(specs, seed=seed)
    _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    _PLAN = None


def current() -> FaultPlan | None:
    return _PLAN


@contextmanager
def active(*specs, seed: int = 0):
    """Scoped activation: installs the specs and uninstalls on exit (only if the plan is
    still this one: a nested install wins)."""
    plan = install(list(specs), seed=seed)
    try:
        yield plan
    finally:
        if _PLAN is plan:
            uninstall()


def parse_faults(text: str) -> list[FaultSpec]:
    """Parse the DLLAMA_FAULTS grammar:

        spec[,spec...]
        spec = point:kind[:prob[:count[:delay_ms[:duration_s]]]]

    `count` may be empty or "inf" for unlimited; `duration_s` (empty = none) arms the
    sustained window. Raises ValueError naming the malformed spec."""
    specs = []
    for raw in text.split(","):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        if len(parts) < 2 or len(parts) > 6:
            raise ValueError(f"bad fault spec {raw!r} "
                             "(point:kind[:prob[:count[:delay_ms[:duration_s]]]])")
        point, kind = parts[0], parts[1]
        if kind not in KINDS:
            raise ValueError(f"bad fault kind {kind!r} in {raw!r} (one of {KINDS})")
        try:
            prob = float(parts[2]) if len(parts) > 2 and parts[2] else 1.0
            count = (None if len(parts) <= 3 or parts[3] in ("", "inf")
                     else int(parts[3]))
            delay = float(parts[4]) if len(parts) > 4 and parts[4] else 25.0
            duration = float(parts[5]) if len(parts) > 5 and parts[5] else None
        except ValueError:
            raise ValueError(f"bad numeric field in fault spec {raw!r}")
        specs.append(FaultSpec(point=point, kind=kind, prob=prob, count=count,
                               delay_ms=delay, duration_s=duration))
    return specs


def install_from_env(environ=None) -> FaultPlan | None:
    """Install a plan from DLLAMA_FAULTS / DLLAMA_FAULT_SEED; None when unset. An
    installed plan is kept (an explicit install() wins over the environment)."""
    env = os.environ if environ is None else environ
    text = env.get("DLLAMA_FAULTS")
    if not text:
        return None
    if _PLAN is not None:
        return _PLAN
    seed = int(env.get("DLLAMA_FAULT_SEED", "0"))
    return install(parse_faults(text), seed=seed)
