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
`--kv-cache-storage host|disc` runs the paged KV cache (runtime/paged_cache.py): a device
ring of `--kv-cache-resident` positions and the whole history in host RAM or a memmap'd
file pair. `--nthreads` is accepted and ignored, and `--pipeline` is accepted (only the
batched server reads it), as the JAX package's shared parser takes them.

Tensor parallelism (the reference's `--workers`, the JAX package's `--tp N`): `--tp N`
starts N local ranks (parallel/launch.py), rank i on cuda:i, or every rank on the one
device `--device` names (`--device cuda:0` with `--dist-backend gloo` shares one card;
`--device cpu` runs on the CPU). `--pod` instead joins a job of one process per host
(`--coordinator`, `--num-processes`, `--process-id`): run the same command on every host.
`--buffer-float-type q80` (the default) reduces the partial sums through the Q80 wire.
`--dist-backend` is the port's own: torch.distributed needs its backend named where ranks
share a card or run on the CPU. Only rank 0 prints; in chat mode it reads the console
and hands every line to the other ranks.

Sequence parallelism (the JAX package's `--sp N`, ops/ring_attention.py): the KV cache's
sequence axis is striped over N ranks and each step's attention runs as a ring over
them; with `--tp M` the job is an N x M grid of N·M ranks (rank r at sp index r // M, tp
index r % M), started and placed as --tp's ranks are. The long-context path that needs
no host spill: refused with --kv-cache-storage host|disc and --draft-model.
"""

from __future__ import annotations

import argparse
import os
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
    p.add_argument("--fused-matmul", action="store_true",
                   help="--prefill-kernel plus the residual-add and gate-pair epilogues "
                        "of the q4 kernels (Engine(fused_matmul=True))")
    p.add_argument("--cache-write", default=None, choices=["deferred", "inscan"],
                   help="KV cache discipline: the port's forward is deferred-only (the "
                        "caches are read by every layer and the new rows committed once "
                        "after the last); 'inscan' is refused")
    p.add_argument("--pipeline", action=argparse.BooleanOptionalAction, default=True,
                   help="pipelined super-steps of batched serving (api_server --batch > "
                        "1); accepted here, where one sequence has nothing to pipeline")
    p.add_argument("--nthreads", type=int, default=None,
                   help="ignored (CUDA owns the card)")
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
    add_kv_storage_flags(p)
    add_parallel_flags(p)
    return p


def add_parallel_flags(p: argparse.ArgumentParser) -> None:
    """--tp, --sp, --moe-sharding, --buffer-float-type, --pod and its rendezvous,
    --dist-backend."""
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel ranks: every projection sharded, the KV cache by "
                        "heads, the partial sums reduced per layer (parallel/)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ranks (ring attention over the KV cache): the "
                        "cache's sequence axis striped over them, the KV blocks rotating "
                        "around the ring each step (ops/ring_attention.py); with --tp, "
                        "sp x tp ranks")
    p.add_argument("--moe-sharding", default="slice", choices=["slice", "expert"],
                   help="MoE expert placement over the tp axis: 'slice' TP-slices "
                        "every expert's hidden dim (the reference's scheme); "
                        "'expert' shards WHOLE experts (each chip owns E/tp experts "
                        "— the capacity axis for Grok-1-314B-class expert weights; "
                        "requires n_experts %% tp == 0)")
    p.add_argument("--buffer-float-type", default="q80",
                   choices=["f32", "f16", "q40", "q80"],
                   help="the tp wire: q80 reduces the partial sums through the Q80-"
                        "compressed all-reduce (the reference's wire compression, "
                        "tasks.cpp:96-135); any other value sends f32")
    p.add_argument("--pod", action="store_true",
                   help="join a job of one process per host over torch.distributed, "
                        "--sp of them on the sp axis and the rest on tp (the reference's "
                        "`dllama worker` + --workers bootstrap, dllama.cpp:205-221); needs "
                        "--coordinator, --num-processes and --process-id. Run the same "
                        "command on every host")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="--pod rendezvous: host:port where process 0 listens (or a "
                        "tcp:// or file:// URL)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="processes in the --pod job")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank in the --pod job")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend of the tp ranks (default: nccl on the "
                        "GPU, gloo on the CPU); gloo lets ranks share one card (--device "
                        "cuda:0), staging the wire through the host. The port's own flag")


def add_kv_storage_flags(p: argparse.ArgumentParser) -> None:
    """--kv-cache-storage, --kv-cache-resident and --kv-cache-dir (dllama and
    api_server)."""
    p.add_argument("--kv-cache-storage", default=None, choices=["ram", "host", "disc"],
                   help="'ram' (default): the KV cache in device memory. 'host'/'disc': "
                        "the paged out-of-core cache (runtime/paged_cache.py): a device "
                        "ring of --kv-cache-resident recent positions plus the full "
                        "history in host RAM / an mmap'd file pair (the reference's disc "
                        "cache, transformer.cpp:312-318, rebuilt flash-attention-style). "
                        "A capacity valve: exact attention over the whole context at "
                        "host-bandwidth speed")
    p.add_argument("--kv-cache-resident", type=int, default=1024, metavar="R",
                   help="paged mode: positions kept in device memory (rounded up to a "
                        "multiple of 64)")
    p.add_argument("--kv-cache-dir", default=None, metavar="DIR",
                   help="paged 'disc' mode: directory for the key/value cache files "
                        "(default: a fresh temp dir, removed at exit)")


def check_kv_storage(args) -> None:
    """The reference's `--kv-cache-storage disc` spills the KV cache to mmap'd files
    (src/transformer.cpp:312-318, utils.cpp:50-67). The paged cache is its counterpart:
    the hot ring on the card, the full history on the host, exact merged attention. It
    states the cost up front: every decoded token reads the cold history from host
    memory, so throughput falls as the context grows."""
    if args.kv_cache_storage in ("host", "disc"):
        print(f"💡 paged KV cache ({args.kv_cache_storage}): hot ring of "
              f"{args.kv_cache_resident} positions on the card, full history "
              f"{'on disk (mmap)' if args.kv_cache_storage == 'disc' else 'in host RAM'}."
              " Decode slows as the cold history grows.", file=sys.stderr)


def check_args(p: argparse.ArgumentParser, args) -> None:
    """Refuse what the port cannot run (argparse exit 2)."""
    if args.cache_write == "inscan":
        p.error("--cache-write inscan: the port's forward is deferred-only "
                "(models/forward.py); use --cache-write deferred or leave it out")
    if args.pod and None in (args.coordinator, args.num_processes, args.process_id):
        p.error("--pod needs --coordinator, --num-processes and --process-id")


def check_tp(args) -> None:
    """What tp > 1 or sp > 1 cannot be combined with yet, before any rank starts (the
    engine refuses the same; ROADMAP Queue A). api_server's check_tp adds the server's
    own refusals to these."""
    if args.sp < 1:
        raise ValueError(f"--sp {args.sp} must be at least 1")
    ranks = job_ranks(args)
    if ranks <= 1:
        return
    from ..runtime.engine import Engine

    if args.draft_model:
        raise ValueError("--draft-model under tp > 1 or sp > 1 is not in the port yet "
                         "(ROADMAP Queue A item 1 (c): the drafter under tp)")
    if ranks > args.sp:
        Engine._refuse_under_tp(kv_cache_storage=args.kv_cache_storage)
    if args.sp > 1:
        Engine._refuse_under_sp(kv_cache_storage=args.kv_cache_storage)
    check_moe_layout(args)


def check_moe_layout(args) -> None:
    """--moe-sharding expert needs --tp to divide the model's experts (the header's
    n_experts): the JAX package's check_divisibility message, before any rank
    starts."""
    tp = args.tp or 1
    if args.moe_sharding != "expert" or tp <= 1:
        return
    from ..formats.mfile import read_spec

    spec, _, _ = read_spec(args.model)
    if spec.is_moe and spec.n_experts % tp:
        raise ValueError(f"expert sharding: tp={tp} must divide "
                         f"n_experts={spec.n_experts}")


def job_ranks(args) -> int:
    """Ranks of the job: --num-processes under --pod, else the local ones."""
    return args.num_processes if args.pod else local_ranks(args)


def local_ranks(args) -> int:
    """Ranks a local job starts: --tp x --sp."""
    return (args.tp or 1) * args.sp


def rank_devices(device: str, n: int) -> list[str]:
    """Each of n local ranks' device: `cpu` for all on the CPU, rank i on cuda:i for a
    bare `cuda`, or every rank on the one card a `cuda:K` names. More ranks than visible
    cards raise unless one card is named."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return ["cpu"] * n
    if dev.index is not None:
        return [str(dev)] * n
    visible = torch.cuda.device_count()
    if n > visible:
        raise ValueError(f"{n} ranks (--tp x --sp) need {n} cards, {visible} visible; "
                         "name one card (--device cuda:0 --dist-backend gloo) to run "
                         "every rank on it")
    return [f"cuda:{i}" for i in range(n)]


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
    """The mode's Engine: on args.device, or on the rank's mesh (`args.mesh`, set by
    rank_main and --pod) with the wire --buffer-float-type names."""
    t0 = time.perf_counter()
    mesh = getattr(args, "mesh", None)
    tp = mesh.tp if mesh is not None else 1
    engine = Engine.load(
        args.model, args.tokenizer, max_seq_len=args.max_seq_len,
        weights_ftype=_FT[args.weights_float_type] if args.weights_float_type else None,
        device=args.device if mesh is None else None, mesh=mesh,
        compress_collectives=args.buffer_float_type == "q80" and tp > 1,
        moe_sharding=args.moe_sharding,
        dtype=(None if args.dtype == "auto"
               else torch.bfloat16 if args.dtype == "bfloat16" else torch.float32),
        use_kernels=False if args.no_kernels else None,
        prefill_kernel=args.prefill_kernel, fused_matmul=args.fused_matmul,
        fused_prologue=args.prologue, kv_cache_storage=args.kv_cache_storage,
        kv_cache_resident=args.kv_cache_resident, kv_cache_dir=args.kv_cache_dir)
    print(f"⏩ Loaded model in {time.perf_counter() - t0:.1f}s "
          f"(device={engine.device}, kernels={engine.use_kernels}, "
          f"prologue={engine.fused_prologue}"
          + (f", paged KV ring of {engine.kv_resident}" if engine.paged else "")
          + (f", tp={engine.tp} over {mesh.backend}"
             + (", Q80 wire" if engine.compress else ", f32 wire")
             + (", experts whole over tp" if engine.moe_sharding == "expert" else "")
             if tp > 1 else "")
          + (f", sp={engine.sp} ring over {mesh.backend}"
             + (" (host-staged)" if mesh.backend == "gloo"
                and engine.device.type == "cuda" else "") if engine.sp > 1 else "")
          + ")")
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
    if engine.ranks > 1:
        # the decode step's collectives, counted as issued, so the S/R columns are
        # measured (the reference counted socket bytes; dllama.cpp:76-93)
        mt = engine.collective_stats()
        counts = " ".join(f"{k}x{v}" for k, v in sorted(mt.counts.items()))
        print(f"🔷 Collectives/step: {counts} "
              f"({mt.total_payload_bytes / 1024:.0f} kB payload)")

    def on_token(t):
        pieces.append(tok.decode_piece(prompt[-1] if not pieces else 0, t))

    _, stats = engine.generate_with(prompt, args.steps, sampler, on_token=on_token,
                                    stop_check=lambda t: stop_requested(),
                                    device_loop_chunk=args.device_loop,
                                    speculative_k=args.speculative)
    print(b"".join(pieces).decode("utf-8", errors="replace"))
    # G = total per token, I = the device step including the logits copy to the host,
    # H = host sampling and bookkeeping; under tp, S/R = wire kB a token per device
    for i, (g, inf) in enumerate(zip(stats.token_ms, stats.infer_ms)):
        sr = (f"S {stats.sent_kbytes_per_token:8.0f} kB R "
              f"{stats.recv_kbytes_per_token:8.0f} kB " if engine.ranks > 1 else "")
        print(f"🔶 G {g:7.2f} ms I {inf:7.2f} ms H {g - inf:7.2f} ms "
              f"{sr}{pieces[i].decode('utf-8', 'replace')}")
    if engine.ranks > 1:
        print(f"S/R source:          {stats.traffic_source} per-device ring bytes")
    print(f"Generated tokens:    {stats.generated_tokens}")
    print(f"Avg tokens / second: {stats.tokens_per_second:.2f}")
    print(f"Avg generation time: {stats.avg_token_ms:.2f} ms")
    print(f"Avg inference time:  {stats.avg_infer_ms:.2f} ms")
    if stats.avg_infer_ms > 0:
        # a card streams its shard: 1/tp of every shard's bytes
        gbps = engine.decode_weight_bytes / engine.tp / 1e9 / (stats.avg_infer_ms / 1e3)
        print(f"Weight stream:       {gbps:.1f} GB/s"
              + (f" per card ({engine.decode_weight_bytes / 1e9:.3f} GB/step over "
                 f"{engine.tp} cards)" if engine.tp > 1 else
                 f" ({engine.decode_weight_bytes / 1e9:.3f} GB/step)"))
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


def _line_reader(mesh, inbox):
    """The chat's console: stdin on one process; under tp or sp rank 0 reads it (local
    ranks: the lines the launching process forwards to `inbox`, "" at the end; --pod:
    its own stdin) and every rank receives rank 0's line."""
    if mesh is None or mesh.size <= 1:
        return sys.stdin.readline
    import torch.distributed as dist

    group = mesh.everyone

    def read() -> str:
        line = None
        if mesh.rank == 0:
            line = inbox.get() if inbox is not None else sys.stdin.readline()
        box = [line]
        dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
        return box[0]
    return read


def mode_chat(args) -> None:
    """Interactive REPL (Chat::chat, dllama.cpp:132-193): KV position persists across
    turns; generation stops on chat EOS or stop strings."""
    engine = make_engine(args)
    readline = _line_reader(getattr(args, "mesh", None), getattr(args, "inbox", None))
    sampler = make_sampler(args, engine.spec)
    tok = engine.tokenizer
    template = ChatTemplate(args.chat_template or TemplateType.UNKNOWN,
                            tok.chat_template, tok.eos_piece())
    stops = tok.chat_stops()

    print("💻 System prompt (optional): ", end="", flush=True)
    system = readline().strip()
    first = True
    while True:
        print("\n👱 User\n> ", end="", flush=True)
        user = readline()
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


def rank_main(mesh, argv: list[str], inbox=None) -> None:
    """One local rank of `dllama --tp N --sp M` (parallel/launch.py): the mode on this
    rank's mesh. Only rank 0 prints and writes the trace."""
    args = build_parser().parse_args(argv)
    args.mesh, args.inbox = mesh, inbox
    if mesh.rank != 0:
        sys.stdout = open(os.devnull, "w")
    _run(args)


def _run(args) -> None:
    install_trace(args)
    faults.install_from_env()  # DLLAMA_FAULTS chaos configuration
    install_graceful_stop()  # SIGTERM: stop after the current token
    mesh = getattr(args, "mesh", None)
    try:
        {"inference": mode_inference, "generate": mode_generate,
         "chat": mode_chat}[args.mode](args)
    finally:
        if mesh is None or mesh.rank == 0:
            dump_trace(args)


def _launch_local(args, argv: list[str]) -> None:
    """--tp N --sp M without --pod: N·M local ranks, the console forwarded to rank 0 in
    chat."""
    from ..parallel import launch
    from ..parallel.mesh import backend_for

    n = local_ranks(args)
    devices = rank_devices(args.device, n)
    inbox = None
    if args.mode == "chat":
        import multiprocessing
        import threading

        inbox = multiprocessing.get_context("spawn").Queue()

        def forward_console():
            for line in sys.stdin:
                inbox.put(line)
            inbox.put("")
        threading.Thread(target=forward_console, daemon=True).start()
    try:
        launch.run("distributed_llama_tpu_torch.apps.dllama:rank_main", n, devices,
                   args=(argv, inbox), backend=args.dist_backend or backend_for(devices[0]),
                   sp=args.sp)
    except launch.RankFailed as e:
        raise SystemExit(f"❌ {e}") from e


def main(argv=None) -> None:
    p = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = p.parse_args(argv)
    check_args(p, args)
    check_kv_storage(args)
    check_tp(args)
    if args.draft_model:
        print("⚠️  --draft-model needs the batched verify path — it is an api_server "
              "--batch > 1 feature; the sequential CLI keeps prompt-lookup drafting "
              "(--speculative).", file=sys.stderr)
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
            sys.stdout = open(os.devnull, "w")
    _run(args)


if __name__ == "__main__":
    main()
