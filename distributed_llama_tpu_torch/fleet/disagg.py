"""Prefill/decode disaggregation, the replica's side: a copy of the replica-side half of
the JAX package's fleet/disagg.py, with its replica-side metric families and the
`disagg.import` span. The router's half (the planner and its families) stays in the JAX
package's stdlib router, which fronts the port's servers over HTTP.

A replica advertises a ROLE in its /healthz replica block: ``prefill`` (long-prompt
admissions land here), ``decode`` (short chains and the decode half of split requests)
or ``both`` (the monolithic default). A router splits a long-prompt completion in two:

1. the prefill replica answers ``POST /v1/kv``: it runs the prompt's prefill, snapshots
   the committed prompt KV blocks to the host (`BatchEngine.submit(export_kv=True)`),
   registers them in its `KVTransferTable` and returns a transfer descriptor (id, token
   count, block geometry, token hash, wire mode), which the router injects into the
   request as ``kv_source``;
2. the decode replica, before admission, checks the descriptor against its own
   tokenization, pulls the blocks in bounded chunks (``GET /v1/kv/<id>?from=F&n=N``:
   every range re-fetchable, so a broken transfer resumes per chunk) and inserts them
   into its prefix cache (`BatchEngine.import_kv_blocks`, host bookkeeping only); the
   admission then reuses the shipped span instead of prefilling it.

Every failure of the split path degrades to the monolithic behaviour: a failed fetch
abandons the import (`import_kv_source` returns 0) and the decode replica prefills
locally, with the same output.
"""

from __future__ import annotations

import hashlib
import threading
import time
import uuid
from http.client import HTTPConnection

from ..obs import metrics, trace
from ..resilience import faults

__all__ = ["ROLES", "KVTransferTable", "tokens_hash", "fetch_kv_blocks",
           "import_kv_source", "note_reprefill"]

ROLES = ("prefill", "decode", "both")

# Decode-replica-side import telemetry (the JAX package's families).
_IMPORTS = metrics.counter(
    "disagg_import_requests_total",
    "kv_source imports attempted at the decode replica, by outcome: "
    "imported, config_mismatch (block geometry differs), hash_mismatch "
    "(tokenizations disagree), error (fetch/decode failed -> local "
    "prefill), empty (descriptor carried no blocks)",
    labelnames=("outcome",))
_IMPORT_TOKENS = metrics.counter(
    "disagg_import_tokens_total",
    "Prompt tokens whose KV arrived over the wire and entered the prefix "
    "cache (the span admission reuses instead of re-prefilling)")
_IMPORT_BYTES = metrics.counter(
    "disagg_import_bytes_total",
    "Wire bytes fetched from prefill replicas (post-codec payload)")
_IMPORT_SECONDS = metrics.histogram(
    "disagg_import_seconds",
    "Wall time of one kv_source import (all chunk fetches + host insert)")
_FETCH_HEDGES = metrics.counter(
    "disagg_fetch_hedges_total",
    "Duplicate KV-chunk fetches raced against a chunk quiet past the "
    "adaptive soft deadline (ranges are independently re-fetchable and "
    "idempotent, so first result wins — the gray-failure hedging idiom "
    "applied to the transfer leg)")
_REPREFILL = metrics.counter(
    "disagg_reprefill_tokens_total",
    "Shipped-span tokens a disaggregated admission re-prefilled anyway "
    "(0 in a healthy fleet — the mixed-context bench asserts it in-run; "
    "nonzero means the imported blocks missed the radix lookup)")


def tokens_hash(tokens) -> str:
    """Short stable hash of a token-id sequence. The decode replica compares it with its
    own tokenization of the prompt before importing: a mismatch means a fleet of mixed
    tokenizers or models, and the shipped KV would seed garbage."""
    h = hashlib.sha1()
    for t in tokens:
        h.update(int(t).to_bytes(4, "little"))
    return h.hexdigest()[:16]


def _parse_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad replica address {addr!r} (want host:port)")
    return host, int(port)


# ----------------------------------------------------------------------
# prefill-replica side: the transfer table
# ----------------------------------------------------------------------

class _Transfer:
    __slots__ = ("xfer_id", "tokens", "blocks", "block_tokens", "created")

    def __init__(self, xfer_id, tokens, blocks, block_tokens):
        self.xfer_id = xfer_id
        self.tokens = tokens          # token ids the blocks cover
        self.blocks = blocks          # [(k, v)] host rows per block
        self.block_tokens = block_tokens
        self.created = time.monotonic()


class KVTransferTable:
    """Bounded TTL'd table of exportable prefill transfers on a replica. Entries hold
    host snapshots of the committed prompt blocks (taken on the scheduler thread at
    request finish), so any range stays servable for the whole TTL whatever the device
    pool does meanwhile — what makes the chunked transfer resumable. Once a fetch covers
    the final block the transfer is consumed: its remaining lifetime drops to
    `consumed_ttl`, so completed transfers stop crowding still-pending ones out of the
    capped table."""

    def __init__(self, cap: int = 32, ttl: float = 120.0, consumed_ttl: float = 10.0):
        self.cap = max(int(cap), 1)
        self.ttl = ttl
        self.consumed_ttl = max(consumed_ttl, 0.0)
        self._lock = threading.Lock()  # guards: _live
        self._live: dict[str, _Transfer] = {}

    def _sweep_locked(self) -> None:  # holds: self._lock
        """TTL expiry only: the cap evicts in open(), never to make room for a read."""
        now = time.monotonic()
        dead = [x for x, t in self._live.items() if now - t.created > self.ttl]
        for x in dead:
            del self._live[x]

    def open(self, tokens: list[int], blocks: list, block_tokens: int, wire: str) -> dict:
        """Register a transfer; returns the descriptor a router injects as
        ``kv_source`` (without the replica address, which the router fills in)."""
        xfer_id = f"kv-{uuid.uuid4().hex[:12]}"
        with self._lock:
            self._sweep_locked()
            while len(self._live) >= self.cap:  # room for the new entry
                oldest = min(self._live.values(), key=lambda t: t.created)
                del self._live[oldest.xfer_id]
            self._live[xfer_id] = _Transfer(xfer_id, list(tokens), list(blocks),
                                            block_tokens)
        return {"xfer_id": xfer_id, "n_tokens": len(tokens), "n_blocks": len(blocks),
                "block_tokens": block_tokens, "tokens_hash": tokens_hash(tokens),
                "wire": wire}

    def get(self, xfer_id: str) -> _Transfer | None:
        with self._lock:
            # a full sweep, so expiry does not wait for the next open()
            self._sweep_locked()
            return self._live.get(xfer_id)

    def note_served(self, t: _Transfer, frm: int, n: int) -> None:
        """A range covering the final block marks the transfer consumed: its clock is
        rebased so that only `consumed_ttl` of lifetime remains (never extended)."""
        if frm + n < len(t.blocks):
            return
        with self._lock:
            t.created = min(t.created,
                            time.monotonic() - max(self.ttl - self.consumed_ttl, 0.0))

    def stats(self) -> dict:
        with self._lock:
            self._sweep_locked()
            return {"live": len(self._live), "cap": self.cap, "ttl_s": self.ttl}


# ----------------------------------------------------------------------
# decode-replica side: fetch and import
# ----------------------------------------------------------------------

def fetch_kv_blocks(host: str, port: int, xfer_id: str, frm: int, n: int,
                    timeout: float = 30.0, record: dict | None = None) -> list:
    """Fetch blocks [frm, frm+n) of a transfer and decode them to host (k, v) pairs. One
    HTTP request per call: any range is independently re-fetchable. `record["bytes"]`
    (when given) adds the wire bytes received."""
    from ..cache.wire import decode_blocks

    faults.fire("disagg.fetch", xfer=xfer_id)
    conn = HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", f"/v1/kv/{xfer_id}?from={frm}&n={n}")
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"kv fetch {xfer_id}[{frm}:{frm + n}] -> {resp.status}")
    finally:
        conn.close()
    _IMPORT_BYTES.inc(len(data))
    if record is not None:
        record["bytes"] = record.get("bytes", 0) + len(data)
    blocks = decode_blocks(data)
    if len(blocks) != n:
        raise RuntimeError(f"kv fetch {xfer_id}[{frm}:{frm + n}] returned {len(blocks)} "
                           "blocks")
    return blocks


class _ChunkTime:
    """The observed chunk fetch times of one import: a count and an EWMA (the part of the
    JAX package's fleet/latency.py LatencyStat the hedged fetch reads)."""

    def __init__(self, alpha: float = 0.2):
        self._alpha = alpha
        self._lock = threading.Lock()  # guards: _n, _ewma
        self._n = 0
        self._ewma = 0.0

    def note(self, v: float) -> None:
        with self._lock:
            self._n += 1
            self._ewma = v if self._n == 1 else self._ewma + self._alpha * (v - self._ewma)

    def count(self) -> int:
        with self._lock:
            return self._n

    def ewma(self) -> float:
        with self._lock:
            return self._ewma


def _fetch_chunk_hedged(host: str, port: int, xfer_id: str, frm: int, n: int, *,
                        timeout: float, chunk_lat: _ChunkTime,
                        record: dict | None = None) -> list:
    """One chunk fetch with the gray-failure treatment: once earlier chunks of this
    import have landed, the per-chunk timeout tightens to a multiple of the observed
    chunk time (capped at `timeout`), and a fetch quiet past that soft deadline races one
    duplicate fetch of the same range — ranges are idempotent, so the first result wins.
    The first chunk (no evidence yet) runs plain. Raises when every attempt failed."""
    if chunk_lat.count() == 0:
        t0 = time.perf_counter()
        out = fetch_kv_blocks(host, port, xfer_id, frm, n, timeout=timeout, record=record)
        chunk_lat.note(time.perf_counter() - t0)
        return out
    soft = min(max(4.0 * chunk_lat.ewma(), 0.25), timeout)
    hard = min(max(4.0 * soft, 1.0), timeout)
    cv = threading.Condition()
    state: dict = {"ok": None, "errs": 0, "started": 1, "err": None}

    def settled() -> bool:
        return state["ok"] is not None or state["errs"] >= state["started"]

    def attempt():
        t0 = time.perf_counter()
        try:
            got = fetch_kv_blocks(host, port, xfer_id, frm, n, timeout=hard,
                                  record=record)
            chunk_lat.note(time.perf_counter() - t0)
            with cv:
                if state["ok"] is None:
                    state["ok"] = got
                cv.notify_all()
        except Exception as e:
            with cv:
                state["errs"] += 1
                state["err"] = e
                cv.notify_all()

    threading.Thread(target=attempt, daemon=True, name="kv-fetch").start()
    with cv:
        cv.wait_for(settled, timeout=soft)
        hedge = not settled()
        if hedge:
            state["started"] += 1
    if hedge:
        _FETCH_HEDGES.inc()
        threading.Thread(target=attempt, daemon=True, name="kv-fetch-hedge").start()
    with cv:
        # the final wait is bounded by the configured cap: `hard` bounds each socket
        # operation, and a chunk making steady progress may take longer in total
        if not cv.wait_for(settled, timeout=timeout + 1.0):
            raise TimeoutError(f"kv fetch {xfer_id}[{frm}:{frm + n}] timed out after "
                               f"{timeout:.1f}s")
        if state["ok"] is not None:
            return state["ok"]
        raise state["err"]


def import_kv_source(engine, prompt: list[int], ks: dict, *, timeout: float = 30.0,
                     chunk_blocks: int = 4, record: dict | None = None) -> int:
    """Pull a ``kv_source`` transfer into `engine`'s prefix cache; returns the token span
    now servable from the cache (0 on any failure: the caller admits with a local
    prefill). Each chunk gets one retry, at the full timeout, before the import is
    abandoned: a transient blip resumes mid-transfer, a dead prefill replica fails both
    attempts. `record` (when given) receives the outcome ("imported", "error", "empty",
    "config_mismatch", "hash_mismatch"), the wire bytes, and the wall ms of the fetches
    with their decoding and of the insert."""
    rec = record if record is not None else {}
    rec.update(outcome="error", bytes=0, fetch_ms=0.0, insert_ms=0.0, tokens=0)
    t0 = time.perf_counter()

    def outcome(name: str) -> int:
        rec["outcome"] = name
        _IMPORTS.labels(outcome=name).inc()
        return 0
    try:
        n_tokens = int(ks["n_tokens"])
        n_blocks = int(ks["n_blocks"])
        bt = int(ks["block_tokens"])
        host, port = _parse_addr(str(ks["replica"]))
        xfer_id = str(ks["xfer_id"])
    except (KeyError, TypeError, ValueError):
        return outcome("error")
    if n_blocks <= 0:
        return outcome("empty")
    pc = getattr(engine, "prefix_cache", None)
    if pc is None or bt != pc.block_tokens or n_tokens > len(prompt) \
            or n_tokens != n_blocks * bt:
        return outcome("config_mismatch")
    if tokens_hash(prompt[:n_tokens]) != ks.get("tokens_hash"):
        # another tokenization (mixed fleet): the shipped rows would seed KV for tokens
        # this replica never saw
        return outcome("hash_mismatch")
    blocks: list = []
    chunk_lat = _ChunkTime()
    try:
        with trace.span("disagg.import", {"xfer": xfer_id, "blocks": n_blocks}):
            for frm in range(0, n_blocks, max(chunk_blocks, 1)):
                want = min(max(chunk_blocks, 1), n_blocks - frm)
                for attempt in (0, 1):  # a per-chunk retry: ranges are resumable
                    try:
                        if attempt == 0:
                            blocks.extend(_fetch_chunk_hedged(
                                host, port, xfer_id, frm, want, timeout=timeout,
                                chunk_lat=chunk_lat, record=rec))
                        else:
                            # the retry runs untightened: the hedged attempt's deadline
                            # may be exactly why the first try failed
                            blocks.extend(fetch_kv_blocks(host, port, xfer_id, frm,
                                                          want, timeout=timeout,
                                                          record=rec))
                        break
                    except Exception:
                        if attempt:
                            raise
            t1 = time.perf_counter()
            imported = engine.import_kv_blocks(prompt[:n_tokens], blocks)
            rec["fetch_ms"] = (t1 - t0) * 1e3
            rec["insert_ms"] = (time.perf_counter() - t1) * 1e3
    except Exception:
        return outcome("error")
    if imported <= 0:
        return outcome("empty")
    _IMPORTS.labels(outcome="imported").inc()
    _IMPORT_TOKENS.inc(imported)
    _IMPORT_SECONDS.observe(time.perf_counter() - t0)
    rec.update(outcome="imported", tokens=imported)
    return imported


def note_reprefill(shipped: int, reused: int) -> int:
    """Admission accounting for a streamed-KV request: how many shipped tokens were
    re-prefilled anyway (the reuse fell short of the shipped span). 0 in a healthy
    fleet."""
    missed = max(shipped - reused, 0)
    if missed:
        _REPREFILL.inc(missed)
    return missed
