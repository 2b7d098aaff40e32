"""OpenAI-compatible HTTP API server for the PyTorch/CUDA port.

A subset of the JAX package's apps/api_server.py with the same HTTP contract
(reference: src/apps/dllama-api/dllama-api.cpp): `POST /v1/chat/completions`, streaming
SSE via chunked transfer and non-streaming JSON, per-request temperature / top_p / seed /
max_tokens / stop overrides (dllama-api.cpp:351-380), `GET /v1/models` and `/health`
(`/healthz`). Errors are OpenAI-style `{"error": {"message", "type"}}` bodies.

With `--batch 1` requests serialize behind a generation lock on the single-sequence
Engine, as the reference's accept loop does (dllama-api.cpp:418-429), and reuse KV
through cache/single_slot.py: the resident conversation's common prefix rewinds, and a
longer prefix in the shared-prefix cache is written into the cache instead of
re-prefilled. With `--batch N` (N >= 2) the server runs the port's continuous-batching
BatchEngine (paged KV, `--no-paged-kv` for dense caches): up to N requests decode
concurrently, in K-step device super-steps (`--superstep`, default 8), pipelined
(`--pipeline`, on by default), and prompts that share full blocks with earlier requests
get them from the prefix cache. `--no-prefix-cache` turns the cache off in both modes.
`--speculative K` drafts up to K tokens per request from its own context and verifies
them in one step: in the BatchEngine's batched verify (greedy and seeded sampling alike)
at `--batch N`, through the Engine's greedy-only generate_speculative at `--batch 1`.
`--draft-model PATH` (`--batch N` only; implies `--speculative 8` when K is unset) adds
a second, small model that drafts for every row (`--draft-k` caps its draft length),
n-gram lookup staying the per-row fallback. A request's `response_format` (`json_schema`,
`regex`, `grammar` or `text`; `--batch N` only) constrains its output to the grammar,
compiled at the edge against the served vocab: a malformed grammar is a 400.

Request control and recovery (resilience/): typed errors map to honest statuses (503
with Retry-After when `--max-queue` sheds, 503 `server_wedged` for a request the
supervisor failed, 503 while closing or draining, 408 for an expired queue TTL or
deadline, 400 for caller errors); `--queue-ttl`, `--request-deadline` and the
`X-Deadline-Ms` header (min-combined) bound a request; SIGTERM drains (`/healthz`
answers 503 "draining", in-flight requests finish within `--drain-timeout`);
`--supervisor-threshold` recovers a hung engine and folds its state into `/healthz`,
whose `replica` block (slots, free slots, queue depth, draining, pid, uptime) a fleet
router polls. A durable router resumes a request elsewhere with `{"resume": {"tokens":
[...]}}` and reads the token ids of each SSE chunk (`"dllama": {"n", "toks"}`) when it
sends `X-Dllama-Journal`. `DLLAMA_FAULTS` injects faults (resilience/faults.py).

Tenancy (resilience/tenancy.py): `--tenants` configures weights and token-bucket quotas;
a request names its tenant in `X-Tenant` and its class ("interactive", the default, or
"batch") in the body's `"class"` or an `X-Class` header. An exhausted quota is a 429
with Retry-After; `--slo-ttft-interactive`, `--slo-ttft-batch` and `--slo-tpot` shed by
class. Disaggregated prefill (fleet/disagg.py): `--role` is advertised in /healthz;
`POST /v1/kv` runs a prompt's prefill and registers its KV blocks for export, `GET
/v1/kv/<id>?from=F&n=N` serves them (`--kv-wire-q80` compresses the wire), and a
completion carrying a router's `kv_source` imports them before admission, falling back
to a local prefill on any failure.

Observability (obs/): `GET /metrics` (Prometheus text), `GET /v1/stats` (a JSON snapshot
of every metric with the replica, engine, cache, tenancy and disaggregation state), `GET
/v1/requests[?slowest=K&tenant=T]` and `/v1/requests/<id>` (the flight recorder's
per-request timelines, by completion id or trace id; `--flight-requests`, `--slow-log`,
`--slow-threshold`) and `GET /v1/trace` (the live Chrome trace under `--trace`). A W3C
`traceparent` header is adopted, and its trace id follows the request into the
scheduler's spans and flight events.

Tensor parallelism (`--tp N`, parallel/): the model split over N ranks, started as
local processes (parallel/launch.py) or joined one per host with `--pod`; `--buffer-
float-type` picks the wire (q80 by default), `--dist-backend` the backend. Rank 0 binds
the port, prints, writes the trace and runs the whole host side; the other ranks replay
its device operations on their shards (parallel/replay.py: the BatchEngine's at `--batch
N`, each generation of the single-sequence Engine at `--batch 1`, which keeps its
resident-conversation rewind but no cross-conversation pool under tp). `/v1/stats` and
`/metrics` carry the counted collectives. A rank that fails ends the job with a nonzero
exit; SIGTERM drains on rank 0, which then ends the other ranks. Refused under tp
(ValueError, naming its ROADMAP item): `--draft-model`, `--supervisor-threshold`,
`--role prefill|decode` and `/v1/kv`, the KV spill.

Sequence parallelism (`--sp N`, ops/ring_attention.py) serves `--batch 1` only: the
single-sequence Engine's KV cache striped over N ranks (with `--tp M`, N x M ranks),
rank 0 leading as under tp. `--batch > 1 --sp > 1` is refused, as the JAX server
refuses it: per-row cache positions do not fit the ring cache.

Runs on the GPU unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import queue
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler
from urllib.parse import parse_qs, urlsplit

import torch

from ..fleet.disagg import ROLES, KVTransferTable
from ..obs import flight, metrics, reqctx, trace
from ..obs.process import install_process_metrics
from ..ops import matmul as matmul_ops
from ..resilience import faults
from ..resilience.quiet_http import QuietServer
from ..resilience.errors import (DeadlineExceeded, EngineClosed, EngineDraining,
                                 EngineSaturated, EngineWedged, InvalidRequest,
                                 QuotaExceeded, retriable)
from ..resilience.tenancy import CLASSES, DEFAULT_TENANT, TenantRegistry, sanitize_tenant
from ..runtime.engine import Engine
from ..runtime.sampler import Sampler
from ..tokenizer import ChatItem, ChatTemplate, EosDetector, TemplateType
from ..tokenizer.eos import TokenStreamer

# Per-request serving latencies (the JAX server's families): TTFT is request arrival to
# the first text delta (queue wait + prefill + first decode), TPOT the mean inter-token
# time after it, E2E the whole completion.
_TTFT = metrics.histogram(
    "api_request_ttft_seconds", "Request arrival to first streamed text delta")
_TPOT = metrics.histogram(
    "api_request_tpot_seconds",
    "Mean per-token time after the first token, per request")
_E2E = metrics.histogram(
    "api_request_e2e_seconds", "Request arrival to completion")
_HTTP = metrics.counter(
    "api_http_requests_total", "HTTP requests by route and status code",
    labelnames=("route", "code"))
# durable-request resume admissions: how many, the resumed tokens they carried, and how
# much of each resume's prompt + delivered prefix the admission reused
_RESUMED = metrics.counter(
    "api_resumed_requests_total",
    "Completions admitted with a resume payload (router failover re-submits)")
_RESUME_TOKENS = metrics.counter(
    "api_resume_tokens_total",
    "Delivered-elsewhere tokens carried by resume payloads (RNG coins "
    "fast-forwarded; tokens re-fed through the stop detector)")
_RESUME_PREFIX = metrics.counter(
    "api_resume_prefix_tokens_total",
    "Total prompt ⊕ delivered prefix length of resume admissions")
_RESUME_REUSED = metrics.counter(
    "api_resume_reused_tokens_total",
    "Resume prefix tokens whose prefill was skipped (slot rewind + radix "
    "prefix-cache seed) at resume admission")

_KNOWN_ROUTES = ("/v1/chat/completions", "/chat/completions", "/v1/models",
                 "/v1/stats", "/metrics", "/health", "/healthz",
                 "/v1/requests", "/v1/trace", "/v1/kv")

# the prefill replica's side of the disaggregation transfer: /v1/kv prefill-only
# admissions and the chunked block export they feed
_KV_PREFILLS = metrics.counter(
    "disagg_prefill_requests_total",
    "POST /v1/kv prefill-only admissions by outcome (ok, empty = prompt "
    "shorter than one full block, error)", labelnames=("outcome",))
_KV_EXPORT_BLOCKS = metrics.counter(
    "disagg_export_blocks_total",
    "KV blocks served to decode replicas over GET /v1/kv/<id>")
_KV_EXPORT_BYTES = metrics.counter(
    "disagg_export_bytes_total",
    "Wire bytes served to decode replicas (post-codec payload)")


def _count_http(path: str, code: int) -> None:
    # unknown paths fold into one label value so scrapes stay bounded; per-request
    # flight lookups and per-transfer chunk fetches fold into their route
    path = path.split("?", 1)[0]
    if path.startswith("/v1/requests/"):
        path = "/v1/requests"
    if path.startswith("/v1/kv/"):
        path = "/v1/kv"
    route = path if path in _KNOWN_ROUTES else "other"
    _HTTP.labels(route=route, code=str(code)).inc()


class ApiState:
    def __init__(self, engine: Engine | None, template_type: TemplateType,
                 default_sampler: Sampler, batch_engine=None, prefix_cache=True,
                 prefix_cache_blocks: int = 0, prefix_block_tokens: int = 16,
                 prefix_cache_q80: bool = False, speculative_k: int = 0,
                 request_deadline: float = 0.0, tenants: TenantRegistry | None = None,
                 role: str = "both", kv_wire_q80: bool = False,
                 kv_transfer_ttl: float = 120.0, kv_transfer_cap: int = 32):
        self.engine = engine
        # disaggregation: the role advertised in /healthz (a routing preference: the
        # engine serves anything), the export wire's mode, and the bounded table of host
        # snapshots GET /v1/kv/<id> serves
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        self.role = role
        self.kv_wire_q80 = kv_wire_q80
        self.kv_transfers = (KVTransferTable(cap=kv_transfer_cap, ttl=kv_transfer_ttl)
                             if batch_engine is not None else None)
        # the last kv_source import's record (outcome, wire bytes, fetch and insert ms)
        self.last_import: dict | None = None
        # the tenant registry: the batch engine's own (it enforces at submit), or the
        # --batch 1 server's, which debits the quota here
        self.tenants = tenants
        self.batch_engine = batch_engine  # BatchEngine when --batch > 1, else None
        # the replica's identity (host:port, set once the socket binds) and start time:
        # the /healthz replica block a fleet router polls
        self.replica_id = ""
        self.started_mono = time.monotonic()
        # set by begin_drain (SIGTERM): /healthz answers 503 "draining" and new
        # completions are refused while in-flight ones finish
        self.draining = False
        # the server's wall-clock deadline per request (seconds, 0 = none)
        self.request_deadline = request_deadline
        # the hung-engine supervisor (serve(supervisor_threshold > 0)), folded into
        # /healthz
        self.supervisor = None
        # --batch 1 speculation (the BatchEngine speculates on its own)
        self.speculative_k = speculative_k
        self.lock = threading.Lock()  # serializes the --batch 1 engine
        # --batch 1 prefix reuse: the resident-conversation rewind plus the
        # cross-conversation pool (the BatchEngine owns its own prefix cache)
        self.cache = None
        if engine is not None:
            from ..cache import SingleSlotCache, make_prefix_cache

            # a paged engine (the host KV spill) keeps resident-only reuse: no pool; nor
            # does a tp or sp engine, whose followers hold no pool of their heads' rows
            pc = None if engine.paged or engine.ranks > 1 else make_prefix_cache(
                engine.k_cache.shape, engine.k_cache.element_size(), slots=1,
                prefix_cache=prefix_cache, blocks=prefix_cache_blocks,
                block_tokens=prefix_block_tokens, q80=prefix_cache_q80)
            self.cache = SingleSlotCache(engine, pc)
        tok = (batch_engine or engine).tokenizer
        self.template = ChatTemplate(template_type, tok.chat_template, tok.eos_piece())
        self.default_sampler = default_sampler
        # constrained decoding: the per-token byte pieces grammars compile against,
        # resolved at the first response_format request
        self.constrain_vocab: list[bytes] | None = None
        self.model_name = "distributed-llama-tpu"


def _now() -> int:
    return int(time.time())


def model_config_hash(spec) -> str:
    """A short stable hash of the model configuration (the ModelSpec fields, not the
    weights): the replica-identity field a fleet router compares across replicas."""
    d = {f.name: str(getattr(spec, f.name)) for f in dataclasses.fields(spec)}
    return hashlib.sha1(json.dumps(d, sort_keys=True).encode()).hexdigest()[:12]


def _load_block(state: ApiState) -> dict:
    """The replica's identity and load, served in /healthz: what a fleet router's
    membership poller reads (slots, free slots, queue depth, draining). No device
    work."""
    be = state.batch_engine
    if be is not None:
        load = be.load_stats()
        load["draining"] = bool(state.draining or be.draining)
    else:
        # one slot, free unless the generation lock is held; requests queue on the lock
        locked = state.lock.locked()
        load = {"slots": 1, "free_slots": 0 if locked else 1, "queue_depth": 0,
                "draining": state.draining}
    spec = (be or state.engine).spec
    return {"id": state.replica_id, "model": state.model_name,
            "model_hash": model_config_hash(spec),
            # the disaggregation role, which role-aware routers key on
            "role": state.role, "batched": be is not None,
            "pid": os.getpid(),
            "uptime_s": round(time.monotonic() - state.started_mono, 1), **load}


def _stats_payload(state: ApiState) -> dict:
    """GET /v1/stats: one JSON snapshot of every metric plus the scheduler, cache and
    engine state — the numbers of /metrics shaped for people and scripts. Host state
    only: no block reads the device, so a scrape never waits on the scheduler's
    stream."""
    out: dict = {"model": state.model_name, "time": _now(),
                 "replica": _load_block(state), "metrics": metrics.snapshot()}
    if state.supervisor is not None:
        out["supervisor"] = state.supervisor.stats()
    if state.kv_transfers is not None:
        out["disagg"] = {"role": state.role,
                         "kv_wire": "q80" if state.kv_wire_q80 else "raw",
                         "transfers": state.kv_transfers.stats()}
    if state.tenants is not None:
        out["tenants"] = state.tenants.stats()
    be = state.batch_engine
    pc = (be.prefix_cache if be is not None
          else state.cache.cache if state.cache is not None else None)
    if pc is not None:
        out["prefix_cache"] = pc.stats()
    if be is not None:
        out["batch_engine"] = {
            "slots": be.slots_n, "superstep": be.superstep, "pipeline": be.pipeline,
            "prefilled_tokens": be.prefilled_tokens, "decode_steps": be.decode_steps,
            "super_steps": be.super_steps, "mixed_steps": be.mixed_steps,
            "occupied": sum(1 for s in be._slots if s.req is not None),
            "scheduler_alive": be.scheduler_alive(), "draining": be.draining,
            "max_queue": be.max_queue, "queue_ttl": be.queue_ttl,
        }
        if be.kv_pool is not None:  # the paged KV pool's metadata
            out["batch_engine"]["paged_kv"] = dict(
                be.kv_pool.stats(), seed_bytes=be.seed_bytes,
                seed_ms=round(be.seed_ms, 3))
        spec_block = be.spec_stats()
        if spec_block is not None:
            out["speculative"] = spec_block
        # constrained decoding: the edge's compile cache and the engine's table
        from ..constrain import compile_stats

        out["constrain"] = dict(be.constrain_stats(), compile=compile_stats())
        if be.collective_stats() is not None:
            out["collectives"] = be.collective_stats()
    elif state.engine is not None:
        eng = state.engine
        out["engine"] = {"pos": eng.pos, "seq_len": eng.spec.seq_len, "paged": eng.paged,
                         "device": str(eng.device), "cuda_graph": eng.cuda_graph}
        if eng.ranks > 1:
            # the decode step's counted collectives (measured once, on every rank, at
            # start-up) and the rank's running total
            t = eng.collective_stats()
            out["collectives"] = {
                "tp": eng.tp, "sp": eng.sp, "wire": "q80" if eng.compress else "f32",
                "decode_t1": {"sent_bytes_per_device": t.sent_bytes_per_device,
                              "counts": dict(t.counts)},
                "sent_bytes_total": eng.mesh.counter.total.sent_bytes_per_device}
    # which kernel each matmul shape took: the readable view of
    # matmul_kernel_selected_total
    inner = be.engine if be is not None else state.engine
    if inner is not None:
        out["kernels"] = {"policy": str(inner.use_kernels),
                          "fused_matmul": bool(inner.fused_matmul),
                          "selections": matmul_ops.kernel_selections()}
    return out


def _observe_done(t_start: float, ttft: list, n_tokens: int,
                  finish: str | None = None) -> None:
    dt = time.perf_counter() - t_start
    _E2E.observe(dt)
    tpot = None
    if ttft[0] is not None and n_tokens > 1:
        tpot = (dt - ttft[0]) / (n_tokens - 1)
        _TPOT.observe(tpot)
    # complete the flight record with the request-level numbers only the HTTP layer
    # knows (the request id resolves from the bound trace context)
    flight.finish(
        None, finish,
        ttft_ms=round(ttft[0] * 1e3, 3) if ttft[0] is not None else None,
        tpot_ms=round(tpot * 1e3, 3) if tpot is not None else None,
        e2e_ms=round(dt * 1e3, 3), tokens=n_tokens)


def _completion_payload(state: ApiState, text: str, finish: str, rid: str) -> dict:
    return {
        "id": rid,
        "object": "chat.completion",
        "created": _now(),
        "model": state.model_name,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": text},
            "finish_reason": finish,
        }],
    }


def _chunk_payload(state: ApiState, completion_id: str, delta: dict,
                   finish: str | None) -> dict:
    # one id across all chunks of a completion, per the OpenAI streaming contract
    return {
        "id": completion_id,
        "object": "chat.completion.chunk",
        "created": _now(),
        "model": state.model_name,
        "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
    }


def _opt(body: dict, key: str, default):
    """Request override with OpenAI null semantics: explicit null == unset."""
    v = body.get(key)
    return default if v is None else v


def _class_from(body: dict) -> str:
    """The scheduling class of the body's "class" field (do_POST folds an X-Class header
    into it; the body wins): "interactive" when absent, a 400 when unknown."""
    raw = str(body.get("class") or "interactive").strip().lower()
    if raw not in CLASSES:
        raise InvalidRequest(f"'class' must be one of {CLASSES}, got {raw!r}")
    return raw


def _parse_resume(body: dict, spec) -> list[int]:
    """The durable-resume payload `{"resume": {"tokens": [...]}}`: the tokens a failed
    replica already generated and delivered, which this replica takes as committed
    output (prefilled, mostly from the prefix cache; the sampler fast-forwarded past
    their coins; fed through the stop detector), so generation continues as the
    uninterrupted run would."""
    raw = body.get("resume")
    if raw is None:
        return []
    if not isinstance(raw, dict) or not isinstance(raw.get("tokens"), list):
        raise InvalidRequest("'resume' must be {\"tokens\": [int, ...]}")
    toks = raw["tokens"]
    if not all(isinstance(t, int) and not isinstance(t, bool) and 0 <= t < spec.vocab_size
               for t in toks):
        raise InvalidRequest(
            f"'resume.tokens' must be token ids in [0, {spec.vocab_size})")
    return list(toks)


def _parse_response_format(state: ApiState, body: dict, runner):
    """Validate and compile `response_format` at the edge, before any queue work, so a
    malformed or unsupported grammar is a 400 invalid_request_error, never a stalled
    slot. Returns (TokenAutomaton, grammar hash) or (None, "").

    Accepted forms (the grammar under its own key; OpenAI's `{"json_schema": {"schema":
    {...}}}` nesting is honored too):

      {"type": "json_schema", "json_schema": {...}}
      {"type": "regex",       "regex": "..."}
      {"type": "grammar",     "grammar": "root ::= ..."}
      {"type": "text"}   (no constraint)

    Compiles are LRU-cached by grammar hash (constrain/compiler.py)."""
    rf = body.get("response_format")
    if rf is None:
        return None, ""
    if not isinstance(rf, dict) or not isinstance(rf.get("type"), str):
        raise InvalidRequest("'response_format' must be an object with a string 'type' "
                             "(json_schema | regex | grammar | text)")
    kind = rf["type"]
    if kind == "text":
        return None, ""
    if kind not in ("json_schema", "regex", "grammar"):
        raise InvalidRequest(f"unsupported response_format type {kind!r} "
                             "(want json_schema | regex | grammar | text)")
    if state.batch_engine is None:
        raise InvalidRequest("response_format requires the batched engine (--batch >= 2); "
                             "this server runs the sequential engine")
    tok = runner.tokenizer
    if tok is None:
        raise InvalidRequest("response_format requires a tokenizer (token-level grammar "
                             "masks are compiled against the served vocab)")
    source = rf.get(kind)
    if kind == "json_schema" and isinstance(source, dict) and "schema" in source:
        source = source["schema"]  # OpenAI response_format nesting
    if source is None:
        raise InvalidRequest(f"response_format type {kind!r} needs the grammar under the "
                             f"{kind!r} key")
    from ..constrain import CompileError, compile_grammar, vocab_bytes

    if state.constrain_vocab is None:
        state.constrain_vocab = vocab_bytes(tok)
    eos = getattr(tok, "chat_eos_id", None) or tok.eos_id
    try:
        aut, ghash = compile_grammar(kind, source, state.constrain_vocab, eos)
    except CompileError as e:
        raise InvalidRequest(f"invalid response_format: {e}") from None
    flight.event(None, "constrain_compiled", kind=kind, grammar=ghash,
                 states=aut.n_states)
    return aut, ghash


def run_completion(state: ApiState, body: dict, emit, *, journal=None,
                   deadline_s: float | None = None):
    """Shared completion core. `emit(text_delta)` streams; returns (text, finish).

    `journal` (a durable router's request): a {"toks": [], "n": 0} the caller owns; the
    token ids of each text delta are appended, and "n" advanced to the delivered count,
    before emit runs, so the stream can put them on the chunk that carries their text.
    `deadline_s` is the client's remaining deadline (X-Deadline-Ms), min-combined with
    the server's --request-deadline. The tenant (X-Tenant) rides on the bound trace
    context (do_POST); the class comes from the body. The flight record opens here, under
    the context's request id, and closes with the request-level numbers.

    Raises typed errors before any generation work, for the HTTP layer to map:
    InvalidRequest (400) for a prompt at or past the context, a bad max_tokens, a
    malformed resume or an unknown class; EngineDraining (503) while draining;
    QuotaExceeded (429) for an exhausted tenant; the engine's own at submit. A
    response_format compiles here too (a malformed grammar is InvalidRequest)."""
    faults.fire("api.request", replica=state.replica_id)
    if state.draining:
        raise EngineDraining("server is draining (shutting down)")
    rc = reqctx.current()
    tenant = rc.tenant if rc is not None and rc.tenant else DEFAULT_TENANT
    klass = _class_from(body)
    if rc is not None:
        # the HTTP boundary opens the record; the BatchEngine enriches the same one
        flight.start(rc.request_id, rc.trace_id, replica=state.replica_id,
                     stream=bool(body.get("stream", False)),
                     **{"tenant": tenant, "class": klass})
    t_start = time.perf_counter()
    ttft: list = [None]
    user_emit = emit

    def emit(text):
        if ttft[0] is None:
            ttft[0] = time.perf_counter() - t_start
            _TTFT.observe(ttft[0])
        user_emit(text)

    runner = state.batch_engine or state.engine
    tok = runner.tokenizer
    spec = runner.spec
    messages = [ChatItem(m.get("role", "user"), m.get("content", ""))
                for m in body.get("messages", [])]
    prompt = tok.encode(state.template.generate(messages), add_bos=True)
    resume = _parse_resume(body, spec)
    if len(prompt) >= spec.seq_len:
        raise InvalidRequest(
            f"prompt is {len(prompt)} tokens but the model context is "
            f"{spec.seq_len}; reduce the conversation or raise --max-seq-len")
    if len(prompt) + len(resume) > spec.seq_len:
        # more than the context could ever have generated; exactly seq_len is the run
        # that ended at the context wall after its last delivered token
        raise InvalidRequest(
            f"resume carries {len(resume)} tokens but the context has room for "
            f"{spec.seq_len - len(prompt)} past the prompt")
    mt_raw = _opt(body, "max_tokens", 0)
    if isinstance(mt_raw, bool) or not isinstance(mt_raw, int) or mt_raw < 0:
        raise InvalidRequest(
            f"'max_tokens' must be a non-negative integer, got {mt_raw!r}")
    # the grammar compiles at the edge: the engine gets a ready automaton
    constraint, constraint_hash = _parse_response_format(state, body, runner)
    imported = 0
    ks = body.get("kv_source")
    if isinstance(ks, dict) and state.batch_engine is not None:
        if state.batch_engine.engine.tp > 1:
            # refused loudly, not a silent local prefill
            raise ValueError("KV import (kv_source) under tp > 1 is not in the port yet "
                             "(ROADMAP Queue A item 1 (c): /v1/kv under tp)")
        # a disaggregated admission: a prefill replica already computed this prompt's
        # KV; its blocks go into the prefix cache before admission, so the lookup remaps
        # them instead of prefilling. Any failure returns 0: a plain local prefill
        from ..fleet.disagg import import_kv_source

        rec: dict = {}
        imported = import_kv_source(state.batch_engine, prompt, ks, record=rec)
        state.last_import = rec
        if imported:
            flight.event(None, "kv_imported", tokens=imported)
    sampler = Sampler(
        spec.vocab_size,
        float(_opt(body, "temperature", state.default_sampler.temperature)),
        float(_opt(body, "top_p", state.default_sampler.topp)),
        int(_opt(body, "seed", _now())),
    )
    # the whole budget comes from the original prompt, so a resumed request stops where
    # the uninterrupted run would; the delivered tokens spent part of it
    max_tokens = max(min((mt_raw or (spec.seq_len - len(prompt))) - len(resume),
                         spec.seq_len - len(prompt) - len(resume)), 0)
    if resume:
        # every stochastic sample drew one xorshift* coin (greedy none): skip the
        # delivered tokens' coins so the continuation draws the uninterrupted stream
        sampler.fast_forward(len(resume))
        _RESUMED.inc()
        _RESUME_TOKENS.inc(len(resume))
        _RESUME_PREFIX.inc(len(prompt) + len(resume))
        flight.event(None, "resume_admitted", tokens=len(resume))
    deadlines = [d for d in (state.request_deadline, deadline_s) if d]
    eff_deadline = min(deadlines) if deadlines else 0.0
    if state.batch_engine is None and state.tenants is not None:
        # --batch 1 has no scheduler to enforce the quota: it is debited here (the
        # batched path leaves it to BatchEngine.submit, on the same registry)
        state.tenants.acquire(tenant, float(len(prompt) + max(max_tokens, 1)))
    stops = tok.chat_stops()
    stop_param = _opt(body, "stop", [])
    if isinstance(stop_param, str):  # OpenAI allows string-or-array
        stop_param = [stop_param]
    stops.extend(s.encode() for s in stop_param)
    detector = EosDetector(tok.chat_eos_id, stops, padding_left=2, padding_right=2)
    pieces: list[str] = []
    prompt_full = prompt + resume

    if state.batch_engine is not None:
        # socket writes are decoupled from the scheduler thread through a queue: a slow
        # client backpressures only its own handler thread, never the shared decode loop
        deltas: queue.Queue = queue.Queue()
        # token ids delivered since the last text flush: on_token appends them on the
        # scheduler thread and the streamer's emit moves them into the queue entry of
        # the text they produced (the pairing a durable router's journal rides on)
        pending_toks: list[int] = []

        def emit_queued(d: bytes):
            text = d.decode("utf-8", errors="replace")
            pieces.append(text)
            toks, pending_toks[:] = pending_toks[:], []
            deltas.put((text, toks))

        streamer = TokenStreamer(detector, lambda t: tok.decode_piece(0, t), emit_queued)

        def on_token(t: int):
            pending_toks.append(t)
            streamer.on_token(t)

        # a resume feeds the delivered tokens through the same streamer first: their
        # text is emitted again (a router splices by position) and the stop detector
        # reaches the failed replica's state, so a stop spanning the failover fires
        for t in resume:
            if streamer.stopped:
                break
            on_token(t)
        req = None
        # a resume with no budget left (the original run ended right after its last
        # delivered token) needs no engine work
        if not streamer.stopped and not (resume and max_tokens == 0):
            # the request id, trace context and tenant come from the bound context
            req = state.batch_engine.submit(prompt_full, max_tokens, sampler,
                                            on_token=on_token,
                                            stop_check=streamer.stop_check,
                                            deadline=eff_deadline or None,
                                            resume_tokens=len(resume), klass=klass,
                                            constraint=constraint,
                                            constraint_hash=constraint_hash)
            # the sentinel closes the drain loop once the request completes (the puts
            # happen-before done.set(), so everything queued is drained first)
            threading.Thread(target=lambda: (req.done.wait(), deltas.put(None)),
                             daemon=True).start()
        else:
            deltas.put(None)
        try:
            while (item := deltas.get()) is not None:
                text, toks = item
                if journal is not None:
                    journal["toks"].extend(toks)
                    journal["n"] += len(toks)
                emit(text)
        except Exception:
            if req is not None:
                req.cancel()  # client went away mid-stream: free the slot
            raise
        if req is not None and req.error is not None:
            raise req.error
        finish = "length"
        if streamer.stopped:
            finish = "stop"
        elif req is not None and req.finish == "deadline":
            # the deadline passed mid-generation: the partial output is the answer
            finish = "deadline"
        if req is not None:
            if resume:
                _RESUME_REUSED.inc(req.stats.reused_tokens)
            if imported:
                # the shipped span less the last token's mandatory inference: any
                # shortfall is KV that crossed the wire and was prefilled again anyway
                from ..fleet.disagg import note_reprefill

                note_reprefill(min(imported, len(prompt) - 1), req.stats.reused_tokens)
        _observe_done(t_start, ttft, req.stats.generated_tokens if req is not None else 0,
                      finish)
        return "".join(pieces), finish

    jpending: list[int] = []  # tokens since the last flush (the journal's pairing)

    def emit_bytes(d: bytes):
        text = d.decode("utf-8", errors="replace")
        pieces.append(text)
        if journal is not None:
            journal["toks"].extend(jpending)
            journal["n"] += len(jpending)
        jpending.clear()
        emit(text)

    streamer = TokenStreamer(detector, lambda t: tok.decode_piece(0, t), emit_bytes)

    def on_token(t: int):
        jpending.append(t)
        streamer.on_token(t)

    # the single engine's deadline: checked per decoded token through stop_check
    # (finish "deadline", partial output delivered); the lock wait precedes it
    finish = ["length"]
    deadline_t = time.perf_counter() + eff_deadline if eff_deadline else None

    def stop_or_deadline(t):
        if streamer.stop_check(t):
            return True
        if deadline_t is not None and time.perf_counter() >= deadline_t:
            finish[0] = "deadline"
            return True
        return False

    for t in resume:  # the resume re-feed, as in the batched path
        if streamer.stopped:
            break
        on_token(t)
    if streamer.stopped:
        _observe_done(t_start, ttft, 0, "stop")
        return "".join(pieces), "stop"
    if resume and max_tokens == 0:
        _observe_done(t_start, ttft, 0, "length")
        return "".join(pieces), "length"
    engine = state.engine
    # prefix reuse: rewind over the resident conversation's common prefix and/or seed
    # rows from the cross-conversation pool; prefill covers only the rest (for a resume,
    # prompt plus the delivered tokens, whose prompt half is usually cached)
    reuse = state.cache.begin(prompt_full)
    if resume:
        _RESUME_REUSED.inc(reuse)
    try:
        # the proposer drafts from the whole conversation, not only the delta
        out, _ = engine.generate_with(prompt_full[reuse:], max_tokens, sampler,
                                      on_token=on_token, stop_check=stop_or_deadline,
                                      speculative_k=state.speculative_k,
                                      history_tokens=prompt_full)
    except Exception:
        # the cache may hold a half-written conversation: drop the reuse record
        state.cache.invalidate()
        raise
    # only tokens whose KV is written are reusable (a final stop token is sampled but
    # never inferred, so engine.pos may be one short of prompt + out)
    state.cache.end((prompt_full + out)[:engine.pos])
    if streamer.stopped:
        finish[0] = "stop"
    _observe_done(t_start, ttft, len(out), finish[0])
    return "".join(pieces), finish[0]


def _flight_error(rid: str, e: Exception) -> None:
    """Complete or discard the flight record of a failed completion. Admission sheds
    (saturated, draining or closed 503s, quota 429s) and caller errors (ValueError
    covers InvalidRequest and template or encode failures: the 400s) are dropped: they
    arrive at client-request rate, and finishing each would flood --slow-log and churn
    every real timeline out of the ring. Server-side failures (500s, deadline expiries)
    stay as exemplars."""
    if isinstance(e, (EngineSaturated, EngineClosed, QuotaExceeded, ValueError)):
        flight.drop(rid)
    else:
        flight.finish(rid, None, error=str(e))


def _map_error(e: Exception) -> tuple[int, str, float | None]:
    """A typed error -> (status, OpenAI error type, Retry-After seconds or None).
    InvalidRequest subclasses ValueError, so the specific mappings come first and any
    other ValueError (a template or encode failure on caller input) stays a 400."""
    if isinstance(e, QuotaExceeded):
        return 429, "rate_limit_error", getattr(e, "retry_after", 1.0)
    if isinstance(e, EngineSaturated):
        return 503, "overloaded_error", getattr(e, "retry_after", 1.0)
    if isinstance(e, EngineWedged):
        # failed while the supervisor recovers the engine: retriable, elsewhere or later
        return 503, "server_wedged", 1.0
    if isinstance(e, EngineClosed):  # covers EngineDraining
        return 503, "server_shutting_down", None
    if isinstance(e, DeadlineExceeded):
        return 408, "timeout_error", None
    if isinstance(e, ValueError):  # covers InvalidRequest
        return 400, "invalid_request_error", None
    return 500, "server_error", None


class Handler(BaseHTTPRequestHandler):
    state: ApiState  # injected by serve()
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        print(f"🔷 {self.command} {self.path}")

    def _json(self, code: int, payload: dict, headers: dict | None = None):
        self._raw(code, "application/json", json.dumps(payload).encode(), headers)

    def _error(self, code: int, message: str, etype: str,
               retry_after: float | None = None, headers: dict | None = None):
        """OpenAI-style error body; a load-shed 503 carries Retry-After."""
        hdrs = dict(headers or {})
        if retry_after is not None:
            hdrs["Retry-After"] = str(max(int(retry_after + 0.5), 1))
        self._json(code, {"error": {"message": message, "type": etype}}, hdrs or None)

    def _mapped_error(self, e: Exception, rid: str | None = None):
        # an errored request is the flight recorder's first exemplar: its response
        # names the lookup key (X-Request-Id) for GET /v1/requests/<id>
        code, etype, retry_after = _map_error(e)
        hdrs = ({"X-Request-Id": rid, "X-Replica": self._replica_addr()}
                if rid else None)
        self._error(code, str(e), etype, retry_after, hdrs)

    def _replica_addr(self) -> str:
        """This replica's routable address for the X-Replica header: the address the
        client connected to when the server is bound to 0.0.0.0."""
        rid = self.state.replica_id
        if not rid.startswith("0.0.0.0:"):
            return rid
        try:
            host, port = self.connection.getsockname()[:2]
            return f"{host}:{port}"
        except (OSError, ValueError):
            return rid

    def _raw(self, code: int, ctype: str, data: bytes, headers: dict | None = None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)
        _count_http(self.path, code)

    def _write_chunk(self, data: bytes):
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def do_GET(self):
        if self.path.startswith("/v1/kv/"):
            self._get_kv()
        elif self.path == "/v1/models":
            self._json(200, {"object": "list", "data": [
                {"id": self.state.model_name, "object": "model", "created": _now(),
                 "owned_by": "user"}]})
        elif self.path in ("/health", "/healthz"):
            # the load balancer's probe, no device work: 503 "draining" once SIGTERM or
            # begin_drain flips the state, 503 "unhealthy" when the scheduler thread died
            # or the supervisor is recovering (or gave up on) the engine
            state = self.state
            be = state.batch_engine
            sup = state.supervisor
            replica = _load_block(state)
            if state.draining or (be is not None and be.draining):
                self._json(503, {"status": "draining", "replica": replica})
            elif be is not None and not be.scheduler_alive():
                self._json(503, {"status": "unhealthy",
                                 "reason": "scheduler thread dead", "replica": replica})
            elif sup is not None and not sup.healthy:
                self._json(503, {"status": "unhealthy",
                                 "reason": f"supervisor: engine {sup.state}",
                                 "supervisor": sup.stats(), "replica": replica})
            else:
                payload = {"status": "ok", "replica": replica}
                if sup is not None:
                    payload["supervisor"] = sup.stats()
                self._json(200, payload)
        elif self.path == "/metrics":
            self._raw(200, "text/plain; version=0.0.4; charset=utf-8",
                      metrics.render().encode())
        elif self.path == "/v1/stats":
            self._json(200, _stats_payload(self.state))
        elif (self.path.split("?", 1)[0] == "/v1/requests"
              or self.path.startswith("/v1/requests/")):
            self._get_requests()
        elif self.path == "/v1/trace":
            # this replica's live Chrome trace (a fleet router's /v1/trace merges them)
            t = trace.current()
            if t is None:
                self._error(404, "tracing is not enabled on this replica (start with "
                            "--trace)", "invalid_request_error")
            else:
                self._json(200, t.to_chrome_trace())
        else:
            self._error(404, f"Unknown route: {self.path}", "invalid_request_error")

    def _get_requests(self):
        """GET /v1/requests[?slowest=K&tenant=T] | /v1/requests/<id>: the flight
        recorder's per-request timelines."""
        rec = flight.current()
        if rec is None:
            self._error(404, "flight recorder is not enabled", "invalid_request_error")
            return
        parts = urlsplit(self.path)
        if parts.path.startswith("/v1/requests/"):
            key = parts.path[len("/v1/requests/"):]
            r = rec.get(key)
            if r is None:
                self._error(404, f"no flight record for {key!r} (the ring keeps the "
                            f"last {rec.capacity} completed requests)",
                            "invalid_request_error")
            else:
                self._json(200, r)
            return
        qs = parse_qs(parts.query)
        try:
            slowest = int(qs.get("slowest", ["0"])[0])
        except ValueError:
            self._error(400, "'slowest' must be an integer", "invalid_request_error")
            return
        tenant = qs.get("tenant", [None])[0]
        self._json(200, rec.requests(slowest=slowest, tenant=tenant))

    def _post_kv(self):
        """POST /v1/kv: the prefill-only admission of a disaggregated request. The
        messages are tokenized as a completion's, the prefill runs through the batch
        scheduler (one throwaway greedy token: the decode replica generates from token
        zero with its own sampler) charged to the relayed X-Tenant at its X-Class, and
        the prompt's host-snapshot blocks are registered in the transfer table. The
        answer is the descriptor a router injects as ``kv_source``; n_blocks 0 says the
        prompt holds no full block to ship."""
        state = self.state
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body.get("messages"), list) or not body["messages"]:
                raise ValueError("'messages' must be a non-empty array")
        except (ValueError, json.JSONDecodeError):
            self._error(400, "Request body is not valid JSON with a non-empty 'messages' "
                        "array", "invalid_request_error")
            return
        be = state.batch_engine
        if be is None or state.kv_transfers is None:
            self._error(501, "KV transfer requires a batched engine (--batch > 1)",
                        "invalid_request_error")
            return
        if be.engine.tp > 1:
            self._error(501, "KV export under tp > 1 is not in the port yet (ROADMAP "
                        "Queue A item 1 (c): /v1/kv under tp)", "invalid_request_error")
            return
        try:
            faults.fire("disagg.prefill")
            if state.draining:
                raise EngineDraining("server is draining (shutting down)")
            tok = be.tokenizer
            messages = [ChatItem(m.get("role", "user"), m.get("content", ""))
                        for m in body["messages"] if isinstance(m, dict)]
            prompt = tok.encode(state.template.generate(messages), add_bos=True)
            if len(prompt) >= be.spec.seq_len:
                raise InvalidRequest(f"prompt is {len(prompt)} tokens but the model "
                                     f"context is {be.spec.seq_len}")
            # the remote prefill is charged to the requesting tenant at its real class:
            # a batch tenant's split prefills must not jump the queue as interactive
            tenant = sanitize_tenant(self.headers.get("X-Tenant"))
            klass = str(self.headers.get("X-Class") or "interactive").strip().lower()
            if klass not in CLASSES:
                klass = "interactive"
            req = be.submit(prompt, 1, Sampler(be.spec.vocab_size, 0.0, 0.9, 0),
                            export_kv=True, tenant=tenant, klass=klass)
            req.wait(timeout=300)
        except Exception as e:
            _KV_PREFILLS.labels(outcome="error").inc()
            self._mapped_error(e)
            return
        exp = req.kv_export
        if not exp or not exp[1]:
            _KV_PREFILLS.labels(outcome="empty").inc()
            self._json(200, {"xfer_id": None, "n_tokens": 0, "n_blocks": 0})
            return
        tokens, blocks, bt = exp
        desc = state.kv_transfers.open(tokens, blocks, bt,
                                       "q80" if state.kv_wire_q80 else "raw")
        _KV_PREFILLS.labels(outcome="ok").inc()
        self._json(200, desc)

    def _get_kv(self):
        """GET /v1/kv/<xfer_id>?from=F&n=N: wire-encoded blocks [F, F+N) of a registered
        transfer. Every range is an independent read of the host snapshot, so a decode
        replica resumes a broken transfer by fetching the range again; an unknown or
        expired id is a 404."""
        state = self.state
        parts = urlsplit(self.path)
        xfer_id = parts.path[len("/v1/kv/"):]
        t = state.kv_transfers.get(xfer_id) if state.kv_transfers is not None else None
        if t is None:
            self._error(404, f"no KV transfer {xfer_id!r} (unknown or expired)",
                        "invalid_request_error")
            return
        qs = parse_qs(parts.query)
        try:
            frm = int(qs.get("from", ["0"])[0])
            n = int(qs.get("n", [str(len(t.blocks) - max(frm, 0))])[0])
        except ValueError:
            self._error(400, "'from' and 'n' must be integers", "invalid_request_error")
            return
        if frm < 0 or n < 0 or frm + n > len(t.blocks):
            self._error(400, f"range [{frm}, {frm + n}) outside [0, {len(t.blocks)})",
                        "invalid_request_error")
            return
        try:
            faults.fire("disagg.export", xfer=xfer_id)
            from ..cache.wire import encode_blocks

            payload = encode_blocks(t.blocks[frm:frm + n], q80=state.kv_wire_q80)
        except Exception as e:
            self._error(500, f"export failed: {e}", "server_error")
            return
        _KV_EXPORT_BLOCKS.inc(n)
        _KV_EXPORT_BYTES.inc(len(payload))
        # a range covering the final block consumes the transfer: its place in the
        # capped table frees after a short retry grace instead of the full TTL
        state.kv_transfers.note_served(t, frm, n)
        self._raw(200, "application/octet-stream", payload,
                  {"X-KV-From": str(frm), "X-KV-Count": str(n)})

    def do_POST(self):
        if self.path == "/v1/kv":
            self._post_kv()
            return
        if self.path not in ("/v1/chat/completions", "/chat/completions"):
            self._error(404, f"Unknown route: {self.path}", "invalid_request_error")
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._error(400, "Request body is not valid JSON", "invalid_request_error")
            return
        if not isinstance(body.get("messages"), list) or not body["messages"]:
            self._error(400, "'messages' must be a non-empty array",
                        "invalid_request_error")
            return
        state = self.state
        # the client's remaining deadline: a durable router relays the original
        # X-Deadline-Ms less the time spent, across every retry and resume; a budget
        # already spent is an immediate 408
        deadline_s = None
        hdr = self.headers.get("X-Deadline-Ms")
        if hdr is not None:
            try:
                v = float(hdr)
                if v != v or v in (float("inf"), float("-inf")):
                    raise ValueError(hdr)
                deadline_s = max(v, 0.0) / 1000.0
            except ValueError:
                self._error(400, "X-Deadline-Ms must be a finite number (ms)",
                            "invalid_request_error")
                return
            if deadline_s <= 0.0:
                self._error(408, "client deadline already expired", "timeout_error")
                return
        # journal mode: a durable router asks for the token ids of each SSE delta
        journal = {"toks": [], "n": 0} if self.headers.get("X-Dllama-Journal") else None
        # the request's identity: the completion id doubles as the flight-recorder key,
        # and an inbound W3C traceparent (a fleet router stamps one on every proxied
        # hop) is adopted, or a trace originated here. The tenant (X-Tenant, relayed by
        # a router on every try and resume) rides the context into the engine
        rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
        ctx = reqctx.adopt(self.headers.get("traceparent"), request_id=rid,
                           tenant=sanitize_tenant(self.headers.get("X-Tenant")))
        # an X-Class header, which the body's "class" overrides
        if "class" not in body and self.headers.get("X-Class"):
            body["class"] = self.headers.get("X-Class")
        # batched mode: the scheduler serializes device access itself
        guard = contextlib.nullcontext() if state.batch_engine is not None else state.lock
        with guard, reqctx.use(ctx):
            if body.get("stream", False):
                self._stream(state, body, rid, journal, deadline_s)
                return
            try:
                text, finish = run_completion(state, body, lambda _t: None,
                                              deadline_s=deadline_s)
            except Exception as e:
                _flight_error(rid, e)
                self._mapped_error(e, rid)
                return
            self._json(200, _completion_payload(state, text, finish, rid),
                       {"X-Request-Id": rid, "X-Replica": self._replica_addr()})

    def _stream(self, state: ApiState, body: dict, rid: str, journal=None,
                deadline_s: float | None = None):
        # SSE headers are deferred to the first delta: an error raised before any
        # output gets its real status code instead of a 200 stream with an error event
        started = [False]

        def start():
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Request-Id", rid)
            self.send_header("X-Replica", self._replica_addr())
            self.end_headers()
            _count_http(self.path, 200)
            started[0] = True

        def emit(text):
            if not started[0]:
                start()
            payload = _chunk_payload(state, rid, {"content": text}, None)
            if journal is not None:
                # the token ids whose text this chunk carries and the delivered count:
                # the router's journal entry (it strips the field before the client)
                payload["dllama"] = {"n": journal["n"], "toks": journal["toks"]}
                journal["toks"] = []
            self._write_chunk(f"data: {json.dumps(payload)}\n\n".encode())

        try:
            _text, finish = run_completion(state, body, emit, journal=journal,
                                           deadline_s=deadline_s)
        except Exception as e:
            _flight_error(rid, e)
            if not started[0]:
                self._mapped_error(e, rid)
                return
            # mid-stream: an error event, then the end of the stream. `retriable` is the
            # durable router's failover switch: True when the replica failed around an
            # innocent request (wedged, closed, an engine-scope fault)
            code, etype, _ = _map_error(e)
            self._write_chunk(("data: " + json.dumps(
                {"error": {"message": str(e), "type": etype, "code": code,
                           "retriable": retriable(e)}})
                + "\n\n").encode())
            self._write_chunk(b"data: [DONE]\n\n")
            self._write_chunk(b"")
            return
        if not started[0]:  # a zero-delta completion still streams
            start()
        self._write_chunk(("data: " + json.dumps(
            _chunk_payload(state, rid, {}, finish)) + "\n\n").encode())
        self._write_chunk(b"data: [DONE]\n\n")
        self._write_chunk(b"")


def serve(engine: Engine | None, host: str = "0.0.0.0", port: int = 9990,
          template_type: TemplateType = TemplateType.UNKNOWN,
          default_sampler: Sampler | None = None, batch_engine=None, prefix_cache=True,
          prefix_cache_blocks: int = 0, prefix_block_tokens: int = 16,
          prefix_cache_q80: bool = False, speculative_k: int = 0,
          request_deadline: float = 0.0, supervisor_threshold: float = 0.0,
          supervisor_poll: float = 1.0, tenants: TenantRegistry | None = None,
          role: str = "both", kv_wire_q80: bool = False, kv_transfer_ttl: float = 120.0,
          kv_transfer_cap: int = 32, flight_requests: int = 256,
          slow_log: str | None = None,
          slow_threshold: float = 1.0) -> QuietServer:
    """Bind the server (port 0 = an ephemeral port) and return it; the caller runs
    serve_forever(). Pass `engine` for --batch 1 serving (the prefix_* arguments size
    its prefix cache, speculative_k > 0 verifies drafts of greedy requests), or
    `batch_engine`, which speculates only when built with speculative=K.
    `request_deadline` (seconds, 0 = none) bounds every request; `supervisor_threshold`
    > 0 starts an EngineSupervisor on the batch engine (`server.api_state.supervisor`;
    the caller stops it). `tenants` is the --batch 1 server's registry (a batch engine
    brings its own); `role`, `kv_wire_q80` and the kv_transfer_* bounds configure the
    disaggregated prefill's export side. The flight recorder is always on: a ring of the
    last `flight_requests` timelines, and `slow_log` appends every request slower than
    `slow_threshold` seconds (or failed) as one JSON line."""
    # a batch engine built without speculation would leave speculative_k silently inert
    if (batch_engine is not None and speculative_k > 0
            and not getattr(batch_engine, "spec_k", 0)):
        raise ValueError("speculative_k > 0 with a batch_engine requires the engine to be "
                         "constructed with speculative=K (the BatchEngine owns the "
                         "batched draft-verify path)")
    runner = batch_engine or engine
    if (supervisor_threshold > 0 and batch_engine is not None
            and batch_engine.engine.tp > 1):
        raise ValueError("--supervisor-threshold under tp > 1 is not in the port yet "
                         "(ROADMAP Queue A item 1 (c): the hung-engine supervisor "
                         "under tp)")
    # one policy authority per replica: the batch engine's own registry, so the server
    # and the scheduler agree on every tenant's weight and bucket
    if tenants is None and batch_engine is not None:
        tenants = batch_engine.tenants
    state = ApiState(engine, template_type,
                     default_sampler or Sampler(runner.spec.vocab_size, 0.7, 0.9, 0),
                     batch_engine=batch_engine, prefix_cache=prefix_cache,
                     prefix_cache_blocks=prefix_cache_blocks,
                     prefix_block_tokens=prefix_block_tokens,
                     prefix_cache_q80=prefix_cache_q80, speculative_k=speculative_k,
                     request_deadline=request_deadline, tenants=tenants, role=role,
                     kv_wire_q80=kv_wire_q80, kv_transfer_ttl=kv_transfer_ttl,
                     kv_transfer_cap=kv_transfer_cap)
    handler = type("BoundHandler", (Handler,), {"state": state})
    server = QuietServer((host, port), handler)
    server.daemon_threads = True
    server.api_state = state
    state.replica_id = f"{host}:{server.server_address[1]}"
    # the flight recorder, always on: GET /v1/requests answers "why was this one slow"
    # without a restart. A recorder already installed (tests, two servers in one
    # process) is kept only when this server asks for the defaults
    if (flight.current() is None or slow_log is not None or flight_requests != 256
            or slow_threshold != 1.0):
        flight.install(flight_requests, slow_log=slow_log, slow_threshold=slow_threshold)
    install_process_metrics()
    trace.set_process_name(f"api_server {state.replica_id}")
    if supervisor_threshold > 0 and batch_engine is not None:
        from ..resilience.supervisor import EngineSupervisor

        state.supervisor = EngineSupervisor(batch_engine, threshold=supervisor_threshold,
                                            poll=supervisor_poll).start()
        print(f"🛡️  supervisor armed: a dispatch hung past {supervisor_threshold:g} s "
              "fails the in-flight requests (retriable) and re-initializes the engine")
    print(f"🟢 dllama-api listening on {host}:{server.server_address[1]}")
    return server


def begin_drain(server: QuietServer, state: ApiState,
                drain_timeout: float = 30.0) -> None:
    """Graceful drain (the SIGTERM body): flip state.draining (/healthz answers 503
    "draining", new completions get 503), let in-flight and queued requests finish for
    at most drain_timeout seconds (BatchEngine.close(drain=True); --batch 1 waits for
    the generation lock), then stop the server. A second call goes straight to the
    shutdown."""
    already = state.draining
    state.draining = True
    be = state.batch_engine
    if not already:
        print(f"🟡 draining: letting in-flight requests finish (timeout "
              f"{drain_timeout:g} s)")
        if be is not None:
            be.close(drain=True, timeout=drain_timeout)
        else:
            end = time.monotonic() + drain_timeout
            while time.monotonic() < end:
                if state.lock.acquire(timeout=0.1):
                    state.lock.release()
                    break
    server.shutdown()
    print("🔴 drained, server stopped")


def install_sigterm_drain(server: QuietServer, state: ApiState,
                          drain_timeout: float = 30.0) -> bool:
    """Install the SIGTERM -> begin_drain handler (main thread only; False where a
    handler cannot be installed). The drain runs on a thread of its own, so the signal
    frame returns at once; serve_forever() returns when the drain shuts the server."""
    import signal

    def on_term(signum, frame):
        threading.Thread(target=begin_drain, args=(server, state, drain_timeout),
                         name="drain", daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, on_term)
    except ValueError:  # not the main thread
        return False
    return True


def build_parser() -> argparse.ArgumentParser:
    from .dllama import _FT, add_kv_storage_flags, add_parallel_flags

    p = argparse.ArgumentParser(prog="dllama-api", description=__doc__.split("\n\n")[0])
    p.add_argument("--model", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9990)
    p.add_argument("--batch", type=int, default=1,
                   help="continuous-batching slots: up to N requests decode "
                        "concurrently in one batched step (1 = serialized serving)")
    p.add_argument("--max-seq-len", type=int, default=0)
    p.add_argument("--weights-float-type", default=None, choices=list(_FT))
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default) or cpu")
    p.add_argument("--dtype", default="auto", choices=["auto", "float32", "bfloat16"],
                   help="auto = bfloat16 on the GPU, float32 on the CPU")
    p.add_argument("--superstep", type=int, default=8,
                   help="--batch > 1: decode K tokens per device dispatch, sampling on "
                        "the device (one host fence per K tokens); the scheduler takes "
                        "single steps while a new request waits, so admission latency "
                        "stays one step. 1 = host sampling every token")
    p.add_argument("--pipeline", action=argparse.BooleanOptionalAction, default=True,
                   help="--batch > 1, --superstep >= 2: issue super-step N+1 from N's "
                        "device state while N's block is delivered on the host; the "
                        "output stays token-identical (a diverging chained dispatch is "
                        "discarded)")
    p.add_argument("--fused-matmul", action="store_true",
                   help="--batch 1: run prefill chunks through the q4 kernels with the "
                        "residual and gate-pair epilogues fused (always on for "
                        "--batch > 1 wherever the kernels run)")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable the cross-request shared-prefix KV cache; prefix reuse "
                        "falls back to the reference-style resident/slot rewind only")
    p.add_argument("--prefix-cache-blocks", type=int, default=0, metavar="N",
                   help="prefix-cache host pool capacity in blocks (the paged engine's "
                        "cold tier; 0 = auto: 4 contexts per slot set, capped at ~1 GiB "
                        "of host RAM)")
    p.add_argument("--prefix-cache-block-tokens", type=int, default=16, metavar="T",
                   help="tokens per prefix-cache block of the dense caches (--batch 1, "
                        "--no-paged-kv; paged engines reuse in --kv-block-tokens blocks)")
    p.add_argument("--prefix-cache-q80", action="store_true",
                   help="Q80-compress cold prefix-cache blocks (~3.8x denser than f32): "
                        "capacity over bit-exactness, a cold hit is a dequantized seed")
    p.add_argument("--no-paged-kv", action="store_true",
                   help="--batch > 1: dense per-slot KV caches instead of the device block "
                        "pool and block tables; prefix hits then copy rows host->device "
                        "instead of remapping tables")
    p.add_argument("--kv-block-tokens", type=int, default=16, metavar="T",
                   help="paged KV (--batch > 1): tokens per device pool block")
    p.add_argument("--kv-pool-blocks", type=int, default=0, metavar="N",
                   help="paged KV (--batch > 1): pool capacity in blocks (0 = slots x "
                        "blocks per context + headroom)")
    p.add_argument("--chat-template", default=None,
                   choices=[t.value for t in TemplateType])
    p.add_argument("--no-kernels", action="store_true",
                   help="run the dequantize path instead of the CUDA kernels")
    p.add_argument("--prologue", action="store_true", default=None,
                   help="fused rmsnorm+Q80 prologue kernels on the decode path (also "
                        "DLT_PROLOGUE=1); single-row decode only, so it takes effect at "
                        "--batch 1")
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="prompt-lookup speculative decoding: draft up to K tokens per "
                        "request from its context and verify them in one step; --batch > "
                        "1 verifies every row's block in one batched dispatch (greedy and "
                        "seeded sampling, token-identical either way), --batch 1 speeds up "
                        "greedy requests only")
    p.add_argument("--draft-model", default=None, metavar="PATH",
                   help="--batch > 1: model-based drafting — a second, small model (a .m "
                        "file of the same vocab) beside the target drafts k tokens per "
                        "row in one scan dispatch; n-gram lookup stays the per-row "
                        "fallback. Implies --speculative 8 when K is unset")
    p.add_argument("--draft-k", type=int, default=0, metavar="K",
                   help="cap the model drafter's draft length per row (default: the "
                        "--speculative K)")
    p.add_argument("--prefill-kernel", action="store_true",
                   help="--batch 1: run prefill chunks through the q4 dequant-matmul "
                        "kernel (--batch > 1 always does, through the fused rung)")
    p.add_argument("--max-queue", type=int, default=0, metavar="N",
                   help="--batch > 1: refuse new requests with 503 + Retry-After once N "
                        "wait for a slot (0 = unbounded)")
    p.add_argument("--queue-ttl", type=float, default=0.0, metavar="S",
                   help="--batch > 1: expire requests that waited more than S seconds "
                        "for a slot: 408, finish reason 'deadline' (0 = no TTL)")
    p.add_argument("--request-deadline", type=float, default=0.0, metavar="S",
                   help="wall-clock deadline per request: generation past S seconds stops "
                        "with finish reason 'deadline' and the partial output; with "
                        "--batch > 1 it bounds queue and generation and an expiry before "
                        "the first token is a 408, with --batch 1 it is checked per token "
                        "(0 = none). An X-Deadline-Ms header tightens it per request")
    p.add_argument("--drain-timeout", type=float, default=30.0, metavar="S",
                   help="SIGTERM drain: /healthz answers 503 'draining', admissions "
                        "stop, and in-flight requests get up to S seconds to finish")
    p.add_argument("--flight-requests", type=int, default=256, metavar="N",
                   help="flight recorder ring: keep the last N completed "
                        "request timelines for GET /v1/requests")
    p.add_argument("--slow-log", default=None, metavar="OUT.jsonl",
                   help="append every request slower than --slow-threshold "
                        "as one JSON line (its full flight-recorder "
                        "timeline) — durable exemplars after the ring "
                        "rotates")
    p.add_argument("--slow-threshold", type=float, default=1.0, metavar="S",
                   help="E2E seconds over which a request lands in "
                        "--slow-log (default 1.0)")
    p.add_argument("--trace", default=None, metavar="OUT.json",
                   help="record runtime spans (prefill chunks, decode "
                        "dispatches, super-steps) and write a Chrome trace-event JSON "
                        "at exit — load it in Perfetto (ui.perfetto.dev) or "
                        "chrome://tracing; GET /v1/trace serves it live")
    p.add_argument("--trace-annotate", action="store_true",
                   help="with --trace: also enter each span as a "
                        "torch.profiler.record_function range, so spans appear "
                        "around their kernels in a torch.profiler trace")
    p.add_argument("--supervisor-threshold", type=float, default=0.0, metavar="S",
                   help="--batch > 1: when no device dispatch completes for S seconds "
                        "while requests are in flight, fail them with a retriable 503 "
                        "and re-initialize the engine (its step graphs are captured "
                        "again); /healthz is unhealthy meanwhile (0 = off). S must exceed "
                        "the slowest legitimate dispatch, a graph capture or an eager "
                        "prefill included: a dispatch still launching when the recovery "
                        "starts writes into the pool that the recovery hands to new "
                        "requests")
    p.add_argument("--supervisor-poll", type=float, default=1.0, metavar="S",
                   help="the supervisor's sampling period (detection takes up to "
                        "threshold + poll)")
    p.add_argument("--role", choices=ROLES, default="both",
                   help="disaggregation role advertised in /healthz: a role-aware router "
                        "sends long-prompt admissions to 'prefill' replicas (which ship "
                        "the prompt's KV blocks over /v1/kv) and decode chains to "
                        "'decode' replicas. A routing preference, not a capability: the "
                        "engine serves anything")
    p.add_argument("--kv-wire-q80", action="store_true",
                   help="Q80-compress KV blocks on the /v1/kv export wire (fewer bytes; "
                        "bounded error, not bit-exact)")
    p.add_argument("--kv-transfer-ttl", type=float, default=120.0, metavar="S",
                   help="how long an exported KV transfer stays servable for decode "
                        "replicas' fetches (fully fetched transfers free their place "
                        "after a short retry grace instead)")
    p.add_argument("--kv-transfer-cap", type=int, default=32, metavar="N",
                   help="most KV export transfers held at once (each a host snapshot of "
                        "one prompt's KV blocks); beyond N the oldest is evicted")
    p.add_argument("--tenants", default=None, metavar="SPEC",
                   help="multi-tenant policy: ';'-separated name[:weight=W,rate=R,burst=B] "
                        "entries; W drives weighted-fair scheduling, R/B a token-bucket "
                        "quota in tokens/s (429 + Retry-After when exhausted; absent = "
                        "unlimited). A request names its tenant in X-Tenant; unknown ids "
                        "share the 'default' entry. Example: "
                        "'gold:weight=4;free:weight=1,rate=50,burst=100'")
    p.add_argument("--slo-ttft-interactive", type=float, default=0.0, metavar="S",
                   help="--batch > 1: refuse an interactive admission when the measured "
                        "queue drain rate projects its wait past S seconds, after first "
                        "evicting queued batch-class work; 0 = off")
    p.add_argument("--slo-ttft-batch", type=float, default=0.0, metavar="S",
                   help="--batch > 1: refuse batch admissions whose projected queue wait "
                        "exceeds S seconds (503 + Retry-After); 0 = off")
    p.add_argument("--slo-tpot", type=float, default=0.0, metavar="S",
                   help="--batch > 1: interactive seconds-per-token target; while the "
                        "measured decode pace exceeds it, batch-class admissions are "
                        "refused; 0 = off")
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--topp", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=None)
    add_kv_storage_flags(p)
    add_parallel_flags(p)
    return p


def check_args(p: argparse.ArgumentParser, args) -> None:
    """Refuse flag combinations the engines cannot serve (argparse exit 2)."""
    if args.pod and None in (args.coordinator, args.num_processes, args.process_id):
        p.error("--pod needs --coordinator, --num-processes and --process-id")
    if args.batch > 1 and args.sp > 1:
        # JAX apps/api_server.py:1490-1492
        p.error("--batch > 1 requires --sp 1: per-row cache positions are "
                "incompatible with the sequence-sharded (ring) cache")
    if args.batch > 1 and args.kv_cache_storage in ("host", "disc"):
        # refuse loudly rather than allocate the full-seq_len device cache in exactly
        # the overflow case the flag exists for
        p.error("--kv-cache-storage host|disc requires --batch 1: the paged cache is "
                "single-sequence. For long-context serving use --batch 1.")


def check_tp(args) -> None:
    """What the server cannot run under tp > 1 or sp > 1, before any rank starts: the
    CLI's refusals (dllama.check_tp) and the server's own, each a ValueError naming its
    ROADMAP item (the engines refuse the same)."""
    from . import dllama

    dllama.check_tp(args)
    if dllama.job_ranks(args) <= 1:
        return
    if args.supervisor_threshold > 0:
        raise ValueError("--supervisor-threshold under tp > 1 is not in the port yet "
                         "(ROADMAP Queue A item 1 (c): the hung-engine supervisor "
                         "under tp)")
    if args.role != "both":
        raise ValueError(f"--role {args.role} (KV export and import over /v1/kv) under "
                         "tp > 1 is not in the port yet (ROADMAP Queue A item 1 (c): "
                         "/v1/kv under tp)")


def engine_kwargs(args) -> dict:
    """Engine keyword arguments of parsed `main` arguments. Batched serving always
    fuses: every serving dispatch has M = slots x T > 1 rows, which without the fused
    rung would dequantize every weight on every step. Where the kernels do not run (the
    CPU, or --no-kernels) the Engine turns fused_matmul off itself. A rank of a tp job
    (`args.mesh`) runs on its mesh's device, with the wire --buffer-float-type picks."""
    mesh = getattr(args, "mesh", None)
    kw = dict(device=args.device if mesh is None else mesh.device,
              dtype=(None if args.dtype == "auto"
                     else torch.bfloat16 if args.dtype == "bfloat16" else torch.float32),
              use_kernels=False if args.no_kernels else None,
              prefill_kernel=args.prefill_kernel,
              fused_matmul=args.fused_matmul or args.batch > 1,
              fused_prologue=args.prologue, moe_sharding=args.moe_sharding)
    if mesh is not None:
        # the Q80 wire reduces the tp partial sums: an sp-only job (tp = 1) has none
        kw.update(mesh=mesh,
                  compress_collectives=args.buffer_float_type == "q80" and mesh.tp > 1)
    return kw


def build_engines(args, tenants=None):
    """The engines of parsed `main` arguments: (Engine or None, BatchEngine or None,
    the --batch 1 control channel under tp or None). Every rank of a tp job builds the
    same (each constructor is collective there); rank 0's --batch 1 Engine is wrapped
    in an EngineLeader, whose generations the others replay."""
    from .dllama import _FT

    kw = engine_kwargs(args)
    cache_kw = dict(prefix_cache=not args.no_prefix_cache,
                    prefix_cache_blocks=args.prefix_cache_blocks,
                    prefix_block_tokens=args.prefix_cache_block_tokens,
                    prefix_cache_q80=args.prefix_cache_q80)
    load_kw = dict(max_seq_len=args.max_seq_len,
                   weights_ftype=_FT[args.weights_float_type]
                   if args.weights_float_type else None)
    if args.batch > 1:
        from ..runtime.batch_engine import BatchEngine

        be = BatchEngine.load(args.model, args.tokenizer, slots=args.batch,
                              superstep=max(args.superstep, 1),
                              pipeline=args.pipeline, paged_kv=not args.no_paged_kv,
                              # the drafter needs the verify path: --draft-model without
                              # --speculative takes the default width
                              speculative=(args.speculative or (
                                  (args.draft_k or 8) if args.draft_model else 0)),
                              draft_model=args.draft_model, draft_k=args.draft_k,
                              kv_block_tokens=args.kv_block_tokens,
                              kv_pool_blocks=args.kv_pool_blocks,
                              max_queue=args.max_queue, queue_ttl=args.queue_ttl,
                              tenants=tenants,
                              slo_ttft_interactive=args.slo_ttft_interactive,
                              slo_ttft_batch=args.slo_ttft_batch,
                              slo_tpot_interactive=args.slo_tpot,
                              **cache_kw, **load_kw, **kw)
        return None, be, None
    engine = Engine.load(args.model, args.tokenizer, **load_kw, **kw,
                         kv_cache_storage=args.kv_cache_storage,
                         kv_cache_resident=args.kv_cache_resident,
                         kv_cache_dir=args.kv_cache_dir)
    if engine.ranks <= 1:
        return engine, None, None
    from ..parallel.replay import ControlChannel, EngineLeader

    # every rank measures the decode step's collectives at the same point (the
    # /metrics and /v1/stats gauges), then opens the control channel
    engine.collective_stats()
    channel = ControlChannel(engine.mesh)
    return (EngineLeader(engine, channel) if channel.leader else engine), None, channel


def build_server(args) -> QuietServer:
    """The engine and the bound server of parsed `main` arguments; the server's
    `api_state` holds both engines."""
    # tenant policy is operator configuration: a malformed spec fails before any load
    tenants = TenantRegistry.parse(args.tenants) if args.tenants else None
    cache_kw = dict(prefix_cache=not args.no_prefix_cache,
                    prefix_cache_blocks=args.prefix_cache_blocks,
                    prefix_block_tokens=args.prefix_cache_block_tokens,
                    prefix_cache_q80=args.prefix_cache_q80)
    if args.batch <= 1:
        from .dllama import check_kv_storage

        if args.draft_model:
            print("⚠️  --draft-model needs the batched verify path: add --batch N (N > 1). "
                  "Serving WITHOUT model-based drafting.", file=sys.stderr)
        check_kv_storage(args)  # the paged mode's cost notice, as the CLI's
    engine, batch_engine, channel = build_engines(args, tenants)
    tp_note = ""
    inner = batch_engine.engine if batch_engine is not None else engine
    if inner.tp > 1:
        tp_note = (f", tp={inner.tp} over {inner.mesh.backend}, "
                   f"{'Q80' if inner.compress else 'f32'} wire")
    if inner.sp > 1:
        tp_note += f", sp={inner.sp} ring over {inner.mesh.backend}"
    if batch_engine is not None:
        spec = batch_engine.spec
        pool = batch_engine.kv_pool
        print(f"⏩ Continuous batching: {args.batch} slots, "
              + (f"paged KV blocks {pool.n_blocks} x {pool.block_tokens} tokens"
                 if pool is not None else "dense KV caches")
              + f", prefix cache {'on' if batch_engine.prefix_cache else 'off'}, "
              f"super-step K={batch_engine.superstep}, pipelined decode "
              f"{'on' if batch_engine.pipeline else 'off'}"
              + (f", speculative k={batch_engine.spec_k}" if batch_engine.spec_k else "")
              + (" (model drafter co-resident)" if batch_engine.drafter is not None
                 else "")
              + f" (device="
              f"{batch_engine.engine.device}, kernels={batch_engine.engine.use_kernels}, "
              f"CUDA graphs={batch_engine.engine.cuda_graph}{tp_note})")
    else:
        spec = engine.spec
        print(f"⏩ Serving one sequence at a time (device={engine.device}, "
              f"kernels={engine.use_kernels}, prefix cache "
              + ("resident rewind only" if engine.ranks > 1 else
                 "off" if args.no_prefix_cache or engine.paged else "on")
              + (f", paged KV ring of {engine.kv_resident}" if engine.paged else "")
              + f"{tp_note})")
    seed = args.seed if args.seed is not None else _now()
    server = serve(engine, args.host, args.port,
                 TemplateType(args.chat_template) if args.chat_template
                 else TemplateType.UNKNOWN,
                 Sampler(spec.vocab_size, args.temperature, args.topp, seed),
                 batch_engine=batch_engine, speculative_k=args.speculative,
                 request_deadline=args.request_deadline,
                 supervisor_threshold=args.supervisor_threshold,
                 supervisor_poll=args.supervisor_poll, tenants=tenants, role=args.role,
                 kv_wire_q80=args.kv_wire_q80, kv_transfer_ttl=args.kv_transfer_ttl,
                 kv_transfer_cap=args.kv_transfer_cap,
                 flight_requests=args.flight_requests, slow_log=args.slow_log,
                 slow_threshold=args.slow_threshold,
                 **(cache_kw if batch_engine is None else {}))
    if channel is not None:
        # the --batch 1 followers hear from rank 0 at least every HEARTBEAT_S, between
        # generations (the generation lock is every sender's)
        channel.start_heartbeat(lambda: server.api_state.lock)
    return server


def _watch_world(server: QuietServer, failed: list) -> None:
    """Rank 0 of a tp job: stop serving once the world failed (an operation that
    failed after the other ranks were sent it); the server then exits nonzero."""
    state = server.api_state
    while True:
        time.sleep(0.25)
        be = state.batch_engine
        broken = be.broken if be is not None else getattr(state.engine, "broken", None)
        if broken is not None:
            failed.append(broken)
            print(f"🔴 the tp world failed ({broken!r}): stopping the server",
                  file=sys.stderr, flush=True)
            server.shutdown()
            return


def run_server(args) -> None:
    """Build and serve until shutdown (the single-card server, or rank 0 of a tp job);
    raises SystemExit(1) when a tp world failed."""
    from .dllama import dump_trace, install_trace

    install_trace(args)  # --trace: before the load, so its spans are recorded too
    server = build_server(args)
    # SIGTERM: /healthz turns to draining, admissions stop, in-flight requests finish
    install_sigterm_drain(server, server.api_state, args.drain_timeout)
    failed: list = []
    if getattr(args, "mesh", None) is not None:
        threading.Thread(target=_watch_world, args=(server, failed), daemon=True,
                         name="tp-watch").start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        state = server.api_state
        if state.supervisor is not None:
            state.supervisor.stop()
        if state.batch_engine is not None:
            # after a drain this finds nothing left; on Ctrl-C the waiters get
            # EngineClosed instead of a scheduler left running (under tp it ends the
            # other ranks' replay)
            state.batch_engine.close()
        elif hasattr(state.engine, "close") and not failed:
            with state.lock:  # after the last generation: ends the followers' replay
                state.engine.close()
        dump_trace(args)  # --trace: write the span buffer on shutdown
    if failed:
        raise SystemExit(1)


def follow_rank(args) -> None:
    """A rank > 0 of a tp job: build the same engines, then replay rank 0's device
    operations until rank 0 closes (stdout silenced: only rank 0 prints)."""
    from ..parallel.replay import follow_engine

    sys.stdout = open(os.devnull, "w")
    engine, batch_engine, channel = build_engines(args)
    mesh = args.mesh
    print(f"🔷 tp rank {mesh.rank}/{mesh.size} replaying rank 0 (pid {os.getpid()})",
          file=sys.stderr, flush=True)
    if batch_engine is not None:
        batch_engine.follow()
        batch_engine.close()
    else:
        follow_engine(engine, channel)


def rank_main(mesh, argv: list[str]) -> None:
    """One local rank of `api_server --tp N` (parallel/launch.py): rank 0 serves, the
    others follow it."""
    args = build_parser().parse_args(argv)
    args.mesh = mesh
    if mesh.rank == 0:
        faults.install_from_env()  # chaos applies to the leader's host side
        run_server(args)
    else:
        follow_rank(args)


def _launch_local(args, argv: list[str]) -> None:
    """--tp N --sp M without --pod: N·M local ranks; SIGTERM is passed on to rank 0,
    whose drain ends the others. A rank that fails stops every rank and exits nonzero."""
    import signal

    from ..parallel import launch
    from ..parallel.mesh import backend_for
    from .dllama import local_ranks, rank_devices

    n = local_ranks(args)
    devices = rank_devices(args.device, n)
    try:
        launch.run("distributed_llama_tpu_torch.apps.api_server:rank_main", n,
                   devices, args=(argv,), sp=args.sp,
                   backend=args.dist_backend or backend_for(devices[0]),
                   forward_signals=(signal.SIGTERM,))
    except launch.RankFailed as e:
        raise SystemExit(f"❌ {e}") from e


def main(argv=None) -> None:
    p = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = p.parse_args(argv)
    check_args(p, args)
    check_tp(args)
    from .dllama import local_ranks

    if local_ranks(args) > 1 and not args.pod:
        _launch_local(args, argv)
        return
    if args.pod:
        from ..parallel.mesh import backend_for, init_multihost, make_pod_mesh

        device = torch.device(args.device)
        init_multihost(args.coordinator, args.num_processes, args.process_id,
                       args.dist_backend or backend_for(device))
        args.mesh = make_pod_mesh(tp=args.tp, sp=args.sp, device=device)
        print(f"🌐 Pod process {args.mesh.rank}/{args.num_processes} on {device} "
              f"({args.mesh.backend})", file=sys.stderr)
        if args.mesh.rank != 0:
            follow_rank(args)
            return
    faults.install_from_env()  # DLLAMA_FAULTS chaos configuration
    run_server(args)


if __name__ == "__main__":
    main()
