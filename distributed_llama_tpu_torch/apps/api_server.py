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

Runs on the GPU unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ..runtime.engine import Engine
from ..runtime.errors import EngineClosed, InvalidRequest
from ..runtime.sampler import Sampler
from ..tokenizer import ChatItem, ChatTemplate, EosDetector, TemplateType
from ..tokenizer.eos import TokenStreamer


class ApiState:
    def __init__(self, engine: Engine | None, template_type: TemplateType,
                 default_sampler: Sampler, batch_engine=None, prefix_cache=True,
                 prefix_cache_blocks: int = 0, prefix_block_tokens: int = 16,
                 prefix_cache_q80: bool = False, speculative_k: int = 0):
        self.engine = engine
        self.batch_engine = batch_engine  # BatchEngine when --batch > 1, else None
        # --batch 1 speculation (the BatchEngine speculates on its own)
        self.speculative_k = speculative_k
        self.lock = threading.Lock()  # serializes the --batch 1 engine
        # --batch 1 prefix reuse: the resident-conversation rewind plus the
        # cross-conversation pool (the BatchEngine owns its own prefix cache)
        self.cache = None
        if engine is not None:
            from ..cache import SingleSlotCache, make_prefix_cache

            pc = make_prefix_cache(engine.k_cache.shape, engine.k_cache.element_size(),
                                   slots=1, prefix_cache=prefix_cache,
                                   blocks=prefix_cache_blocks,
                                   block_tokens=prefix_block_tokens, q80=prefix_cache_q80)
            self.cache = SingleSlotCache(engine, pc)
        tok = (batch_engine or engine).tokenizer
        self.template = ChatTemplate(template_type, tok.chat_template, tok.eos_piece())
        self.default_sampler = default_sampler
        self.model_name = "distributed-llama-tpu"


def _now() -> int:
    return int(time.time())


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


def run_completion(state: ApiState, body: dict, emit):
    """Shared completion core. `emit(text_delta)` streams; returns (text, finish).
    Raises InvalidRequest (400) before any generation work for a prompt at or past the
    context or a bad max_tokens."""
    runner = state.batch_engine or state.engine
    tok = runner.tokenizer
    spec = runner.spec
    messages = [ChatItem(m.get("role", "user"), m.get("content", ""))
                for m in body.get("messages", [])]
    prompt = tok.encode(state.template.generate(messages), add_bos=True)
    if len(prompt) >= spec.seq_len:
        raise InvalidRequest(
            f"prompt is {len(prompt)} tokens but the model context is "
            f"{spec.seq_len}; reduce the conversation or raise --max-seq-len")
    mt_raw = _opt(body, "max_tokens", 0)
    if isinstance(mt_raw, bool) or not isinstance(mt_raw, int) or mt_raw < 0:
        raise InvalidRequest(
            f"'max_tokens' must be a non-negative integer, got {mt_raw!r}")
    sampler = Sampler(
        spec.vocab_size,
        float(_opt(body, "temperature", state.default_sampler.temperature)),
        float(_opt(body, "top_p", state.default_sampler.topp)),
        int(_opt(body, "seed", _now())),
    )
    max_tokens = min(mt_raw or (spec.seq_len - len(prompt)), spec.seq_len - len(prompt))
    stops = tok.chat_stops()
    stop_param = _opt(body, "stop", [])
    if isinstance(stop_param, str):  # OpenAI allows string-or-array
        stop_param = [stop_param]
    stops.extend(s.encode() for s in stop_param)
    detector = EosDetector(tok.chat_eos_id, stops, padding_left=2, padding_right=2)
    pieces: list[str] = []

    if state.batch_engine is not None:
        # socket writes are decoupled from the scheduler thread through a queue: a slow
        # client backpressures only its own handler thread, never the shared decode loop
        deltas: queue.Queue = queue.Queue()

        def emit_queued(d: bytes):
            text = d.decode("utf-8", errors="replace")
            pieces.append(text)
            deltas.put(text)

        streamer = TokenStreamer(detector, lambda t: tok.decode_piece(0, t), emit_queued)
        req = state.batch_engine.submit(prompt, max_tokens, sampler,
                                        on_token=streamer.on_token,
                                        stop_check=streamer.stop_check)
        # the sentinel closes the drain loop once the request completes (the puts
        # happen-before done.set(), so everything queued is drained first)
        threading.Thread(target=lambda: (req.done.wait(), deltas.put(None)),
                         daemon=True).start()
        try:
            while (text := deltas.get()) is not None:
                emit(text)
        except Exception:
            req.cancel()  # client went away mid-stream: free the slot
            raise
        if req.error is not None:
            raise req.error
        return "".join(pieces), "stop" if streamer.stopped else "length"

    def emit_bytes(d: bytes):
        text = d.decode("utf-8", errors="replace")
        pieces.append(text)
        emit(text)

    streamer = TokenStreamer(detector, lambda t: tok.decode_piece(0, t), emit_bytes)
    engine = state.engine
    # prefix reuse: rewind over the resident conversation's common prefix and/or seed
    # rows from the cross-conversation pool; prefill covers only the rest
    reuse = state.cache.begin(prompt)
    try:
        # the proposer drafts from the whole conversation, not only the delta
        out, _ = engine.generate_with(prompt[reuse:], max_tokens, sampler,
                                      on_token=streamer.on_token,
                                      stop_check=streamer.stop_check,
                                      speculative_k=state.speculative_k,
                                      history_tokens=prompt)
    except Exception:
        # the cache may hold a half-written conversation: drop the reuse record
        state.cache.invalidate()
        raise
    # only tokens whose KV is written are reusable (a final stop token is sampled but
    # never inferred, so engine.pos may be one short of prompt + out)
    state.cache.end((prompt + out)[:engine.pos])
    return "".join(pieces), "stop" if streamer.stopped else "length"


def _map_error(e: Exception) -> tuple[int, str]:
    if isinstance(e, EngineClosed):
        return 503, "server_shutting_down"
    if isinstance(e, ValueError):  # covers InvalidRequest
        return 400, "invalid_request_error"
    return 500, "server_error"


class Handler(BaseHTTPRequestHandler):
    state: ApiState  # injected by serve()
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        print(f"🔷 {self.command} {self.path}")

    def _json(self, code: int, payload: dict, headers: dict | None = None):
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _error(self, code: int, message: str, etype: str):
        self._json(code, {"error": {"message": message, "type": etype}})

    def _write_chunk(self, data: bytes):
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def do_GET(self):
        if self.path == "/v1/models":
            self._json(200, {"object": "list", "data": [
                {"id": self.state.model_name, "object": "model", "created": _now(),
                 "owned_by": "user"}]})
        elif self.path in ("/health", "/healthz"):
            be = self.state.batch_engine
            if be is not None and not be.scheduler_alive():
                self._json(503, {"status": "unhealthy",
                                 "reason": "scheduler thread dead"})
            else:
                self._json(200, {"status": "ok"})
        else:
            self._error(404, f"Unknown route: {self.path}", "invalid_request_error")

    def do_POST(self):
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
        rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
        # batched mode: the scheduler serializes device access itself
        guard = contextlib.nullcontext() if state.batch_engine is not None else state.lock
        with guard:
            if body.get("stream", False):
                self._stream(state, body, rid)
                return
            try:
                text, finish = run_completion(state, body, lambda _t: None)
            except Exception as e:
                code, etype = _map_error(e)
                self._error(code, str(e), etype)
                return
            self._json(200, _completion_payload(state, text, finish, rid),
                       {"X-Request-Id": rid})

    def _stream(self, state: ApiState, body: dict, rid: str):
        # SSE headers are deferred to the first delta: an error raised before any
        # output gets its real status code instead of a 200 stream with an error event
        started = [False]

        def start():
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Request-Id", rid)
            self.end_headers()
            started[0] = True

        def emit(text):
            if not started[0]:
                start()
            payload = _chunk_payload(state, rid, {"content": text}, None)
            self._write_chunk(f"data: {json.dumps(payload)}\n\n".encode())

        try:
            _text, finish = run_completion(state, body, emit)
        except Exception as e:
            code, etype = _map_error(e)
            if not started[0]:
                self._error(code, str(e), etype)
                return
            self._write_chunk(("data: " + json.dumps(
                {"error": {"message": str(e), "type": etype, "code": code}})
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
          prefix_cache_q80: bool = False, speculative_k: int = 0) -> ThreadingHTTPServer:
    """Bind the server (port 0 = an ephemeral port) and return it; the caller runs
    serve_forever(). Pass `engine` for --batch 1 serving (the prefix_* arguments size
    its prefix cache, speculative_k > 0 verifies drafts of greedy requests), or
    `batch_engine`, which speculates only when built with speculative=K."""
    # a batch engine built without speculation would leave speculative_k silently inert
    if (batch_engine is not None and speculative_k > 0
            and not getattr(batch_engine, "spec_k", 0)):
        raise ValueError("speculative_k > 0 with a batch_engine requires the engine to be "
                         "constructed with speculative=K (the BatchEngine owns the "
                         "batched draft-verify path)")
    runner = batch_engine or engine
    state = ApiState(engine, template_type,
                     default_sampler or Sampler(runner.spec.vocab_size, 0.7, 0.9, 0),
                     batch_engine=batch_engine, prefix_cache=prefix_cache,
                     prefix_cache_blocks=prefix_cache_blocks,
                     prefix_block_tokens=prefix_block_tokens,
                     prefix_cache_q80=prefix_cache_q80, speculative_k=speculative_k)
    handler = type("BoundHandler", (Handler,), {"state": state})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    server.api_state = state
    print(f"🟢 dllama-api listening on {host}:{server.server_address[1]}")
    return server


def build_parser() -> argparse.ArgumentParser:
    from .dllama import _FT

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
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--topp", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=None)
    return p


def engine_kwargs(args) -> dict:
    """Engine keyword arguments of parsed `main` arguments. Batched serving always
    fuses: every serving dispatch has M = slots x T > 1 rows, which without the fused
    rung would dequantize every weight on every step. Where the kernels do not run (the
    CPU, or --no-kernels) the Engine turns fused_matmul off itself."""
    return dict(device=args.device,
                dtype=(None if args.dtype == "auto"
                       else torch.bfloat16 if args.dtype == "bfloat16" else torch.float32),
                use_kernels=False if args.no_kernels else None,
                fused_matmul=args.fused_matmul or args.batch > 1,
                fused_prologue=args.prologue)


def build_server(args) -> ThreadingHTTPServer:
    """The engine and the bound server of parsed `main` arguments; the server's
    `api_state` holds both engines."""
    from .dllama import _FT

    kw = engine_kwargs(args)
    cache_kw = dict(prefix_cache=not args.no_prefix_cache,
                    prefix_cache_blocks=args.prefix_cache_blocks,
                    prefix_block_tokens=args.prefix_cache_block_tokens,
                    prefix_cache_q80=args.prefix_cache_q80)
    load_kw = dict(max_seq_len=args.max_seq_len,
                   weights_ftype=_FT[args.weights_float_type]
                   if args.weights_float_type else None)
    batch_engine = engine = None
    if args.batch > 1:
        from ..runtime.batch_engine import BatchEngine

        batch_engine = BatchEngine.load(args.model, args.tokenizer, slots=args.batch,
                                        superstep=max(args.superstep, 1),
                                        pipeline=args.pipeline, paged_kv=not args.no_paged_kv,
                                        speculative=args.speculative,
                                        kv_block_tokens=args.kv_block_tokens,
                                        kv_pool_blocks=args.kv_pool_blocks,
                                        **cache_kw, **load_kw, **kw)
        spec = batch_engine.spec
        pool = batch_engine.kv_pool
        print(f"⏩ Continuous batching: {args.batch} slots, "
              + (f"paged KV blocks {pool.n_blocks} x {pool.block_tokens} tokens"
                 if pool is not None else "dense KV caches")
              + f", prefix cache {'on' if batch_engine.prefix_cache else 'off'}, "
              f"super-step K={batch_engine.superstep}, pipelined decode "
              f"{'on' if batch_engine.pipeline else 'off'}"
              + (f", speculative k={batch_engine.spec_k}" if batch_engine.spec_k else "")
              + f" (device="
              f"{batch_engine.engine.device}, kernels={batch_engine.engine.use_kernels}, "
              f"CUDA graphs={batch_engine.engine.cuda_graph})")
    else:
        engine = Engine.load(args.model, args.tokenizer, **load_kw, **kw)
        spec = engine.spec
        print(f"⏩ Serving one sequence at a time (device={engine.device}, "
              f"kernels={engine.use_kernels}, prefix cache "
              f"{'off' if args.no_prefix_cache else 'on'})")
    seed = args.seed if args.seed is not None else _now()
    return serve(engine, args.host, args.port,
                 TemplateType(args.chat_template) if args.chat_template
                 else TemplateType.UNKNOWN,
                 Sampler(spec.vocab_size, args.temperature, args.topp, seed),
                 batch_engine=batch_engine, speculative_k=args.speculative,
                 **(cache_kw if batch_engine is None else {}))


def main(argv=None) -> None:
    server = build_server(build_parser().parse_args(argv))
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if server.api_state.batch_engine is not None:
            server.api_state.batch_engine.close()


if __name__ == "__main__":
    main()
