"""Counters / gauges / histograms with Prometheus text exposition (the port's copy of the
JAX package's obs/metrics.py).

Dependency-free replacement for prometheus_client, scoped to what the
serving stack needs:

- `Counter` — monotonically increasing float (tokens, requests, rollbacks).
- `Gauge` — set/inc/dec value (slot occupancy, queue depth, resident pages).
- `Histogram` — fixed log-scale buckets with cumulative counts + sum + count
  (latencies: TTFT, TPOT, queue wait, per-dispatch times). Buckets are fixed
  at construction — observation is a bisect + one add under the metric's
  lock, cheap enough for per-dispatch hot paths.
- `Registry.render()` — Prometheus text exposition format 0.0.4, served by
  api_server's `GET /metrics`.
- `Registry.snapshot()` — the same data as plain JSON-able dicts, served by
  `GET /v1/stats`.

Metric constructors are get-or-create on (name) so module wiring can declare
metrics at call sites without import-order coupling; re-declaring a name with
a different type or label set raises (silent merging would corrupt scrapes).

Labels follow the prometheus_client child model: a metric declared with
`labelnames` is a family; `.labels(k=v)` returns the child holding the
values. Unlabeled metrics hold their value directly.

All values are process-local and reset on restart, exactly like
prometheus_client's default registry; rates are the scraper's job.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "counter", "gauge", "histogram", "log_buckets", "render",
           "snapshot"]


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> tuple[float, ...]:
    """Log-scale bucket upper bounds from `lo` to >= `hi`, `per_decade` per
    decade, rounded to 4 significant digits so the exposition's `le` labels
    are stable across platforms (no 0.30000000000000004)."""
    assert 0 < lo < hi and per_decade >= 1
    out = []
    i = math.floor(per_decade * math.log10(lo) + 0.5)
    while True:
        b = 10.0 ** (i / per_decade)
        b = float(f"{b:.4g}")
        out.append(b)
        if b >= hi:
            return tuple(out)
        i += 1


# latency buckets in SECONDS (Prometheus convention): 100 µs .. 100 s
DEFAULT_TIME_BUCKETS = log_buckets(1e-4, 100.0, per_decade=4)
# size buckets (tokens, rows, bytes-ish counts): 1 .. 100k
DEFAULT_SIZE_BUCKETS = log_buckets(1.0, 1e5, per_decade=4)


def _fmt(v: float) -> str:
    """Prometheus sample value formatting: integers without the trailing .0."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _label_str(labelnames: tuple[str, ...], labelvalues: tuple[str, ...]) -> str:
    if not labelnames:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in zip(labelnames, labelvalues))
    return "{" + inner + "}"


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


class _Metric:
    """Family: owns children keyed by label values; unlabeled metrics are
    their own single child."""

    typ = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple[str, ...], _Metric] = {}
        self._lock = threading.Lock()  # guards: _children
        self._init_value()

    def _init_value(self) -> None:
        self.value = 0.0

    def labels(self, **kv) -> "_Metric":
        assert set(kv) == set(self.labelnames), (
            f"{self.name}: labels {sorted(kv)} != declared {self.labelnames}")
        key = tuple(str(kv[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = type(self)(self.name, self.help)
                self._children[key] = child
        return child

    def _samples(self) -> list[tuple[str, str, float]]:
        """[(suffix, label_str, value)] for exposition."""
        raise NotImplementedError

    def _iter_children(self):
        if self.labelnames:
            with self._lock:
                items = sorted(self._children.items())
            for key, child in items:
                yield _label_str(self.labelnames, key), child
        else:
            yield "", self

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.typ}"]
        for lbl, child in self._iter_children():
            for suffix, extra_lbl, v in child._samples():
                # histogram bucket samples carry their own {le=...}; merge
                lab = lbl
                if extra_lbl:
                    lab = (lbl[:-1] + "," + extra_lbl[1:]) if lbl else extra_lbl
                lines.append(f"{self.name}{suffix}{lab} {_fmt(v)}")
        return "\n".join(lines)

    def snapshot(self):
        if self.labelnames:
            return {lbl or "{}": child.snapshot()
                    for lbl, child in self._iter_children()}
        return self._snapshot_self()

    def _snapshot_self(self):
        return self.value


class Counter(_Metric):
    typ = "counter"

    def inc(self, v: float = 1.0) -> None:
        assert v >= 0, f"counter {self.name} decremented by {v}"
        with self._lock:
            self.value += v

    def _samples(self):
        return [("", "", self.value)]


class Gauge(_Metric):
    typ = "gauge"

    def _init_value(self) -> None:
        self.value = 0.0
        self._fn = None

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v

    def dec(self, v: float = 1.0) -> None:
        with self._lock:
            self.value -= v

    def set_function(self, fn) -> None:
        """Evaluate `fn()` at scrape time instead of a stored value — the
        prometheus_client callback-gauge idiom, for values that are a
        *reading* of live state (e.g. seconds since the last scheduler
        dispatch) rather than an event stream. A raising callback degrades
        to the last stored value: a scrape must never 500 because the
        subject died (that being exactly when the scrape matters)."""
        self._fn = fn

    def _read(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                pass
        return self.value

    def _samples(self):
        return [("", "", self._read())]

    def _snapshot_self(self):
        return self._read()


class Histogram(_Metric):
    typ = "histogram"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = DEFAULT_TIME_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        assert self.buckets, "histogram needs at least one finite bucket"
        super().__init__(name, help, labelnames)

    def _init_value(self) -> None:
        self.counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def labels(self, **kv):
        # children must share the family's bucket layout
        child = super().labels(**kv)
        child.buckets = self.buckets
        if len(child.counts) != len(self.buckets) + 1:
            child._init_value()
        return child

    def observe(self, v: float) -> None:
        # bisect_left: a value exactly on a bound belongs IN that bucket
        # (Prometheus le="x" means observations <= x)
        i = bisect_left(self.buckets, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def _samples(self):
        out = []
        cum = 0
        with self._lock:
            counts = list(self.counts)
            total, s = self.count, self.sum
        for b, c in zip(self.buckets, counts):
            cum += c
            out.append(("_bucket", '{le="' + _fmt(b) + '"}', cum))
        out.append(("_bucket", '{le="+Inf"}', total))
        out.append(("_sum", "", s))
        out.append(("_count", "", total))
        return out

    def _snapshot_self(self):
        with self._lock:
            counts = list(self.counts)
            total, s = self.count, self.sum
        return {"count": total, "sum": s,
                "buckets": {_fmt(b): c for b, c in zip(self.buckets, counts)},
                "overflow": counts[-1]}


class Registry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()  # guards: _metrics

    def _get_or_create(self, cls, name: str, help: str, labelnames=(), **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                assert type(m) is cls and m.labelnames == tuple(labelnames), (
                    f"metric {name} re-declared as {cls.__name__}"
                    f"({labelnames}) but exists as {type(m).__name__}"
                    f"({m.labelnames})")
                if cls is Histogram:
                    # a silent bucket-layout merge would put a second call
                    # site's observations in wrong-scale buckets
                    want = tuple(sorted(kw.get("buckets",
                                               DEFAULT_TIME_BUCKETS)))
                    assert m.buckets == want, (
                        f"histogram {name} re-declared with buckets {want} "
                        f"but exists with {m.buckets}")
                return m
            m = cls(name, help, tuple(labelnames), **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str, labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str, labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str, labelnames=(),
                  buckets: tuple[float, ...] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def render(self) -> str:
        """Prometheus text exposition (format 0.0.4), trailing newline
        included per spec."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        return "\n".join(m.render() for m in metrics) + "\n"

    def snapshot(self) -> dict:
        """JSON-able {name: value|histogram-dict} of every metric."""
        with self._lock:
            metrics = dict(self._metrics)
        return {name: m.snapshot() for name, m in sorted(metrics.items())}

    def clear(self) -> None:
        """Drop every metric (tests only — live handles go stale)."""
        with self._lock:
            self._metrics.clear()


REGISTRY = Registry()

# module-level conveniences bound to the default registry — the repo's wiring
# calls these at use sites (get-or-create keeps that cheap and order-free)
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
render = REGISTRY.render
snapshot = REGISTRY.snapshot
