"""dllama CLI for the PyTorch/CUDA port — inference / generate / chat on one sequence.

Counterpart of the JAX package's apps/dllama.py (reference:
src/apps/dllama/dllama.cpp) with the flags that apply to one sequence on one card.
Runs on the GPU unless `--device cpu` is given.

Modes (dllama.cpp:230-245):
    inference  — run prompt + --steps tokens, print per-token stats
    generate   — stream tokens until EOS or --steps
    chat       — interactive REPL with chat template + stop detection (dllama.cpp:111-194)

The first SIGTERM stops a generation after its current token (the partial output and the
stats still print); a second one stops at once. `DLLAMA_FAULTS` injects faults
(resilience/faults.py). `--trace out.json` records the runtime's spans (obs/trace.py) and
writes a Chrome trace at exit; open it in Perfetto (ui.perfetto.dev).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..models.spec import ModelSpec
from ..quants import FloatType
from ..resilience import faults
from ..runtime.engine import Engine
from ..runtime.sampler import Sampler
from ..tokenizer import ChatItem, ChatTemplate, EosDetector, TemplateType
from ..tokenizer.eos import TokenStreamer

_FT = {"f32": FloatType.F32, "f16": FloatType.F16, "q40": FloatType.Q40,
       "q80": FloatType.Q80}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dllama", description=__doc__)
    p.add_argument("mode", choices=["inference", "generate", "chat"])
    p.add_argument("--model", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--prompt", default=None)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--topp", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--chat-template", default=None,
                   choices=[t.value for t in TemplateType])
    p.add_argument("--max-seq-len", type=int, default=0)
    p.add_argument("--weights-float-type", default=None, choices=list(_FT))
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default) or cpu")
    p.add_argument("--dtype", default="auto", choices=["auto", "float32", "bfloat16"],
                   help="auto = bfloat16 on the GPU, float32 on the CPU")
    p.add_argument("--no-kernels", action="store_true",
                   help="run the dequantize path instead of the CUDA kernels")
    p.add_argument("--prefill-kernel", action="store_true",
                   help="run prefill chunks through the q4 dequant-matmul kernel")
    p.add_argument("--prologue", action="store_true", default=None,
                   help="fused rmsnorm+Q80 prologue kernels on the decode path "
                        "(ops/prologue.py; also DLT_PROLOGUE=1)")
    p.add_argument("--device-loop", type=int, default=0, metavar="CHUNK",
                   help="decode CHUNK tokens per dispatch with the device loop, sampling "
                        "on the device (runtime/device_loop.py); 0 = per-token host loop")
    p.add_argument("--trace", default=None, metavar="OUT.json",
                   help="record runtime spans (prefill chunks, decode "
                        "dispatches, device-loop chunks) and write a Chrome "
                        "trace-event JSON at exit — load it in Perfetto "
                        "(ui.perfetto.dev) or chrome://tracing")
    p.add_argument("--trace-annotate", action="store_true",
                   help="with --trace: also enter each span as a "
                        "torch.profiler.record_function range, so spans appear "
                        "around their kernels in a torch.profiler trace")
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="prompt-lookup speculative decoding: draft up to K tokens from "
                        "context n-gram matches and verify them in one step "
                        "(runtime/speculative.py); greedy only (temperature 0), a sampled "
                        "run falls back to the loop it would take without it")
    p.add_argument("--draft-model", default=None, metavar="PATH",
                   help="model-based drafting (api_server --batch > 1 only): load a "
                        "second, small model from PATH (a .m file of the same vocab) "
                        "that drafts k tokens per row in one scan dispatch; this "
                        "single-sequence CLI keeps prompt-lookup drafting")
    p.add_argument("--draft-k", type=int, default=0, metavar="K",
                   help="cap the model drafter's draft length per row (default: the "
                        "--speculative K)")
    return p


_GRACEFUL_STOP = None  # threading.Event set by the first SIGTERM


def install_graceful_stop():
    """SIGTERM during a generation stops it after the current token instead of killing
    the process mid-dispatch; a second SIGTERM hard-stops (KeyboardInterrupt). Returns
    the Event, or None where a handler cannot be installed (not the main thread)."""
    global _GRACEFUL_STOP
    import signal
    import threading

    ev = threading.Event()

    def on_term(signum, frame):
        if ev.is_set():
            raise KeyboardInterrupt
        ev.set()
        print("\n🟡 SIGTERM: finishing the current token, then stopping (send again to "
              "hard-stop)", file=sys.stderr)

    try:
        signal.signal(signal.SIGTERM, on_term)
    except ValueError:  # not the main thread
        return None
    _GRACEFUL_STOP = ev
    return ev


def stop_requested() -> bool:
    """True once SIGTERM asked the generation loop to wind down."""
    return _GRACEFUL_STOP is not None and _GRACEFUL_STOP.is_set()


def make_engine(args) -> Engine:
    t0 = time.perf_counter()
    engine = Engine.load(
        args.model, args.tokenizer, max_seq_len=args.max_seq_len,
        weights_ftype=_FT[args.weights_float_type] if args.weights_float_type else None,
        device=args.device,
        dtype=(None if args.dtype == "auto"
               else torch.bfloat16 if args.dtype == "bfloat16" else torch.float32),
        use_kernels=False if args.no_kernels else None,
        prefill_kernel=args.prefill_kernel, fused_prologue=args.prologue)
    print(f"⏩ Loaded model in {time.perf_counter() - t0:.1f}s "
          f"(device={engine.device}, kernels={engine.use_kernels}, "
          f"prologue={engine.fused_prologue})")
    spec = engine.spec
    moe = ("n_experts", "n_active_experts") if spec.is_moe else ()
    for k in ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size",
              "seq_len", *moe):
        print(f"💡 {k}: {getattr(spec, k)}")
    return engine


def make_sampler(args, spec: ModelSpec) -> Sampler:
    seed = args.seed if args.seed is not None else int(time.time())
    return Sampler(spec.vocab_size, args.temperature, args.topp, seed)


def mode_inference(args) -> None:
    engine = make_engine(args)
    sampler = make_sampler(args, engine.spec)
    tok = engine.tokenizer
    prompt = tok.encode(args.prompt or "Hello world", add_bos=True)
    pieces: list[bytes] = []

    def on_token(t):
        pieces.append(tok.decode_piece(prompt[-1] if not pieces else 0, t))

    _, stats = engine.generate_with(prompt, args.steps, sampler, on_token=on_token,
                                    stop_check=lambda t: stop_requested(),
                                    device_loop_chunk=args.device_loop,
                                    speculative_k=args.speculative)
    print(b"".join(pieces).decode("utf-8", errors="replace"))
    # G = total per token, I = the device step including the logits copy to the host,
    # H = host sampling and bookkeeping
    for i, (g, inf) in enumerate(zip(stats.token_ms, stats.infer_ms)):
        print(f"🔶 G {g:7.2f} ms I {inf:7.2f} ms H {g - inf:7.2f} ms "
              f"{pieces[i].decode('utf-8', 'replace')}")
    print(f"Generated tokens:    {stats.generated_tokens}")
    print(f"Avg tokens / second: {stats.tokens_per_second:.2f}")
    print(f"Avg generation time: {stats.avg_token_ms:.2f} ms")
    print(f"Avg inference time:  {stats.avg_infer_ms:.2f} ms")
    if stats.avg_infer_ms > 0:
        gbps = engine.decode_weight_bytes / 1e9 / (stats.avg_infer_ms / 1e3)
        print(f"Weight stream:       {gbps:.1f} GB/s "
              f"({engine.decode_weight_bytes / 1e9:.3f} GB/step)")
    print(f"Prefill time:        {stats.prefill_ms:.2f} ms "
          f"({stats.prompt_tokens} tokens)")
    if stats.spec_steps:
        # speculative decoding: dispatches against tokens
        acc = stats.spec_accepted / max(stats.spec_drafted, 1)
        print(f"Speculative:         {stats.generated_tokens} tokens in "
              f"{stats.spec_steps} verify steps "
              f"({stats.spec_accepted}/{stats.spec_drafted} drafts accepted, {acc:.0%})")


def mode_generate(args) -> None:
    engine = make_engine(args)
    sampler = make_sampler(args, engine.spec)
    tok = engine.tokenizer
    prompt = tok.encode(args.prompt or "", add_bos=True)
    prev = prompt[-1] if prompt else -1

    def on_token(t):
        nonlocal prev
        sys.stdout.buffer.write(tok.decode_piece(prev, t))
        sys.stdout.flush()
        prev = t

    engine.generate_with(prompt, args.steps, sampler, on_token=on_token,
                         stop_check=lambda t: t == tok.eos_id or stop_requested(),
                         device_loop_chunk=args.device_loop,
                         speculative_k=args.speculative)
    print()


def mode_chat(args) -> None:
    """Interactive REPL (Chat::chat, dllama.cpp:132-193): KV position persists across
    turns; generation stops on chat EOS or stop strings."""
    engine = make_engine(args)
    sampler = make_sampler(args, engine.spec)
    tok = engine.tokenizer
    template = ChatTemplate(args.chat_template or TemplateType.UNKNOWN,
                            tok.chat_template, tok.eos_piece())
    stops = tok.chat_stops()

    print("💻 System prompt (optional): ", end="", flush=True)
    system = sys.stdin.readline().strip()
    first = True
    while True:
        print("\n👱 User\n> ", end="", flush=True)
        user = sys.stdin.readline()
        if not user:
            break
        items = []
        if first and system:
            items.append(ChatItem("system", system))
        items.append(ChatItem("user", user.strip()))
        prompt = tok.encode(template.generate(items), add_bos=first)
        if engine.pos + len(prompt) >= engine.spec.seq_len:
            print("\n(context end reached)")
            break
        first = False

        print("\n🤖 Assistant\n", flush=True)
        detector = EosDetector(tok.chat_eos_id, stops, padding_left=2, padding_right=2)

        def emit(delta: bytes):
            sys.stdout.buffer.write(delta)
            sys.stdout.flush()

        streamer = TokenStreamer(detector, lambda t: tok.decode_piece(0, t), emit)
        engine.generate_with(prompt, engine.spec.seq_len - engine.pos - 1, sampler,
                             on_token=streamer.on_token,
                             stop_check=lambda t: streamer.stop_check(t) or stop_requested(),
                             device_loop_chunk=args.device_loop,
                             speculative_k=args.speculative)
        if stop_requested():
            print("\n(terminated)")
            break
        if engine.pos >= engine.spec.seq_len - 1:
            print("\n(context end reached)")
            break


def install_trace(args) -> bool:
    """--trace: install the process-wide tracer before any engine work, so the load's
    spans are recorded too (shared by dllama and api_server). True when tracing is
    on."""
    if not getattr(args, "trace", None):
        return False
    from ..obs import trace

    trace.install(annotate=getattr(args, "trace_annotate", False))
    return True


def dump_trace(args) -> None:
    """Write the Chrome trace to args.trace (a no-op without --trace)."""
    from ..obs import trace

    t = trace.current()
    if getattr(args, "trace", None) and t is not None:
        t.dump(args.trace)
        print(f"🧭 wrote {len(t.events())} trace events to {args.trace} "
              f"({t.dropped_events} dropped) — open in ui.perfetto.dev", file=sys.stderr)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.draft_model:
        print("⚠️  --draft-model needs the batched verify path — it is an api_server "
              "--batch > 1 feature; the sequential CLI keeps prompt-lookup drafting "
              "(--speculative).", file=sys.stderr)
    install_trace(args)
    faults.install_from_env()  # DLLAMA_FAULTS chaos configuration
    install_graceful_stop()  # SIGTERM: stop after the current token
    try:
        {"inference": mode_inference, "generate": mode_generate,
         "chat": mode_chat}[args.mode](args)
    finally:
        dump_trace(args)


if __name__ == "__main__":
    main()
