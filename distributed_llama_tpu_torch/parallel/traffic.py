"""Collective traffic, counted where the port issues it.

The counterpart of the JAX package's parallel/hlo_stats.py. The reference counts real
socket bytes per token (src/socket.cpp:280-285) and prints them as the S/R columns
(dllama.cpp:76-93); the JAX package walks the traced step's jaxpr for its collectives.
The port has no program to walk: every collective goes through parallel/collectives.py,
which records its kind, payload bytes and group size on the mesh's `TrafficCounter` as it
issues it. Per-device wire bytes use hlo_stats' ring-algorithm costs:

    all-reduce        payload P          sends 2 (n-1)/n * P
    all-gather        output P           sends (n-1)/n * P   (each shard passed n-1 hops)
    reduce-scatter    output P           sends (n-1) * P     (input = n * P)
    all-to-all        payload P          sends (n-1)/n * P
    anything else     payload P          sends P (collective-permute, broadcast)

where n is the group size. The payload is the collective's output, as hlo_stats takes
it from the jaxpr's out-vars.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field


def _sent_factor(op: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op == "all-gather":
        return (n - 1) / n
    if op == "reduce-scatter":
        return float(n - 1)
    if op == "all-to-all":
        return (n - 1) / n
    return 1.0  # collective-permute, broadcast


@dataclass
class CollectiveTraffic:
    """Collective accounting over a window (one decode step, say)."""

    counts: dict[str, int] = field(default_factory=dict)
    payload_bytes: dict[str, int] = field(default_factory=dict)
    sent_bytes_per_device: float = 0.0  # == received, for the ring algorithms above

    @property
    def total_payload_bytes(self) -> int:
        return sum(self.payload_bytes.values())

    def add(self, op: str, payload: int, n: int) -> None:
        self.counts[op] = self.counts.get(op, 0) + 1
        self.payload_bytes[op] = self.payload_bytes.get(op, 0) + payload
        self.sent_bytes_per_device += _sent_factor(op, n) * payload


class TrafficCounter:
    """Every collective one rank issues on a mesh: the running total, and each open
    window (`window()`), which sees only what is issued while it is open. A rank is one
    process and its engine issues collectives from one thread."""

    def __init__(self):
        self.total = CollectiveTraffic()
        self._windows: list[CollectiveTraffic] = []

    def record(self, op: str, payload: int, n: int) -> None:
        self.total.add(op, payload, n)
        for w in self._windows:
            w.add(op, payload, n)

    @contextlib.contextmanager
    def window(self):
        """Count the collectives issued inside the `with` block into a fresh
        CollectiveTraffic, which the block receives."""
        w = CollectiveTraffic()
        self._windows.append(w)
        try:
            yield w
        finally:
            self._windows.remove(w)


def publish_traffic(traffic: CollectiveTraffic, program: str) -> None:
    """Export a program's counted collective traffic as gauges (obs/metrics.py) under the
    JAX package's names, so `GET /metrics` serves it. `program` names the step the
    numbers belong to (e.g. "decode_t1")."""
    from ..obs import metrics

    metrics.gauge(
        "collective_sent_bytes_per_device",
        "Measured per-device ring-algorithm wire bytes per program execution",
        labelnames=("program",)).labels(program=program).set(
            traffic.sent_bytes_per_device)
    payload = metrics.gauge(
        "collective_payload_bytes",
        "Measured collective payload bytes per program execution, by op",
        labelnames=("program", "op"))
    count = metrics.gauge(
        "collective_count",
        "Collective ops executed per program execution, by op",
        labelnames=("program", "op"))
    for op, b in traffic.payload_bytes.items():
        payload.labels(program=program, op=op).set(b)
    for op, c in traffic.counts.items():
        count.labels(program=program, op=op).set(c)
