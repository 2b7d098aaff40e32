"""Chip smoke test of the PyTorch/CUDA port (distributed_llama_tpu_torch) on one GPU.

    python3 chip_smoke.py                      # every phase, as the check runs it
    python3 chip_smoke.py --phases env,build,kernels

Phases, each printing its own line(s); any failure raises and exits nonzero:
  env       torch/CUDA versions, the card's name and power limit (nvidia-smi)
  build     nvcc for every kernel source, all started together; build seconds
  parity    a 2-layer model at full Llama-2-7B width in f32 with seeded weights: the
            card with kernels against the CPU with the plain versions — the Engine on
            Q40 weights, and with the fused prologue on Q40 and on Q80 weights (logits
            within tolerance, identical greedy tokens for 8 steps), and the fused
            BatchEngine on 4 staggered requests (identical greedy tokens, logits step by
            step within tolerance); then the fused BatchEngine with two constrained
            rows (a JSON schema, a regex) and two free ones, speculation off (masked
            super-steps) and on (masked verify blocks), and the model drafter's scan (a
            self-draft, 4 rows, 4 turns): the card's tokens and drafts the CPU's outside
            near-ties held by the CPU's and an exact-sum run's logits
  model     Engine at full Llama-2-7B (32 layers, random Q40 weights drawn on the card in
            i4p layout, bf16, prefill_kernel), each one-token step a CUDA graph replay: a
            100-token prompt (chunks 64, 8, 1) and 64 greedy tokens, every kernel's
            launches over that run (graph replays x each graph's launches) against the
            schedule; the eager step (cuda_graph=False) beside it, 16 steps' logits
            bit-identical; the device loop (generate_chunked, chunks of 16) with the host
            loop's greedy tokens; ms/token and idle share of eager, graph and loop. Then
            the same with the fused prologue, 32 greedy tokens, and the count of
            programmatic (PDL) edges in the step's graph
  q80       the same on random Q80 weights drawn on the card in the i8 layout: (a) the
            default engine, (b) the fused prologue, 64 greedy tokens each
  serve     BatchEngine at full Llama-2-7B (8 slots, fused_matmul, paged KV of 1033
            blocks of 16 tokens): 8 staggered requests of 16-300 prompt tokens and 48
            greedy tokens each, run at superstep 1 and at superstep 8 pipelined (each
            step a graph replay), the tokens identical; launch counts against the
            schedule, tokens/s, time to first token, peak memory, the pool drained, and
            the device-busy share of the decode step, greedy and seeded; the host cost
            of the seeded picks, one device_sample_coin call against one per row
  http      the port's api_server serve() on the same 7B engine with a synthetic
            32000-piece tokenizer: 4 concurrent chat completions (one SSE) over HTTP
  prefix    the prefix cache over paged KV on the serve phase's weights (the serve phase
            itself runs with the cache off): (1) 2 slots at superstep 1 and 8, hits on a
            512-token prefix P one at a time, each remapping 32 directory blocks (0 bytes
            moved) and prefilling 512 tokens fewer, with every host-sampled logits row
            bit-identical to the cache-off run; a hit of exactly P (31 blocks remapped, the
            boundary block copied) held by the near-tie rule with an f64 witness; (2) 8
            slots, superstep 8 pipelined, 8 hits on P together: every first logits row
            bit-identical to a serial cache-off reference, first tokens identical to
            the cache-off run; time to first token, prefill, dispatches, launches
            against the serve schedule, and the super-step period and profiled device
            busy with and without the cache; (3)
            a pool of 130 blocks whose pressure demotes the directory to the host tier, hot
            and Q80, and a hit that promotes it back: the promoted rows against the rows
            read before the demotion (hot bit for bit), the seed bytes, the pool drained;
            (4) the single-sequence Engine through SingleSlotCache: a 512-row seed after a
            displacing conversation, 16 steps' logits bit-identical to a fresh prefill,
            graph replays, and a follow-up turn on the resident rewind. Any cache
            degradation (warn_degraded) fails the phase
  spec      speculative decoding: (1) the fused BatchEngine(speculative=8) at 2 layers of
            Llama-2-7B width in f32, card against CPU, 4 staggered requests whose blocks
            are drafted from a speculation-off run's tokens (half of them corrupted at
            the third draft): the card's tokens and verify turns the CPU's (a near-tie
            held by the CPU's and an exact-sum run's logits); (2) at full Llama-2-7B on the serve phase's
            weights, 8 slots, superstep 8 pipelined: 8 prompts (a repeated random
            segment extended by the speculation-off engine's own greedy continuation),
            speculation off then on, tokens held by the near-tie rule (f64 witness),
            at least one accepted draft, launches against the serve schedule, verify
            blocks replayed per bucket, tok/s, dispatches, accept rate, the graphs and
            their memory, ms per batched step at T = 1, 2, 3, 5, 9, the pool drained;
            (3) the single-sequence Engine's generate_speculative at 7B
            (prefill_kernel), graphs against eager (identical) and against generate()
            under the near-tie rule, ms per token
  resil     request control and recovery on the serve phase's weights, in the 8-slot
            fused BatchEngine with the serving defaults (superstep 8 pipelined, paged KV,
            the prefix cache), every run of 8 requests (4 greedy, 4 seeded) started from
            emptied caches and admitted in one pass: (1) a victim killed by a fault at
            its prefill, and one at its token delivery mid-super-step: the survivors'
            tokens those of the fault-free runs; (2) two transient super-step dispatch
            failures retried (tokens identical, no new capture); (3) with every slot
            held by callbacks waiting on an event, a queue TTL expiry and a max_queue
            shed, and a deadline after the first token keeping the partial output; (5)
            the supervisor recovering a dispatch parked for 600 s: the in-flight requests
            fail EngineWedged, recover_wedged within 1.5 s with the pool's storage kept,
            the abandoned thread making no launch when woken, the graphs captured again
            and the same tokens after; (6) 8 seeded requests resumed at k = 1, 7, 23,
            each continuation the uninterrupted run's, their prompts remapped; (4) a
            drain with 8 requests in flight; (7) the server on a fresh engine: 503 with
            Retry-After, 408 for an expired X-Deadline-Ms, begin_drain with a stream in
            flight (/healthz 503 "draining", the stream completes). Times: detection to
            healthy, the first super-step after recovery against a warm one, a retry, the
            drain
  tenancy   tenancy on the serve phase's weights, in the resil phase's engine: 8 batch
            requests of tenant flood (100-token prompts, 128 tokens) admitted in one
            pass from emptied caches; request 7's token callback submits an
            interactive request of tenant gold at its 16th token, which preempts request
            7 (the batch row with the least output) at the next super-step boundary:
            the victim's tokens equal its uninterrupted run's (all greedy, then 4 greedy
            and 4 seeded), its re-admission remaps 7 blocks and prefills its 5-token
            tail; the interactive TTFT (its wait for admission and its prefill
            dispatches) beside the super-step period, the rollback, the launches
  disagg    disaggregated prefill on the same weights: two port servers in this process
            (roles prefill and decode, each its own 8-slot engine); the script plays
            the router: POST /v1/kv (X-Tenant gold, X-Class batch) with a 517-token
            prompt, then the streamed completion with that kv_source to the decode
            server, whose 32 greedy tokens equal its monolithic run from emptied caches
            and which prefills only the 5-token tail; again on the Q80 wire (fewer
            bytes); export ms a block, wire bytes, fetch-and-decode, insert_cold and
            promotion ms, seed bytes, the split TTFT against the monolithic one
  obs       observability on the same weights in the resil phase's engine: the port's
            server with the tracer annotating serves 8 staggered streamed requests of
            64 tokens, each with its own traceparent; the deltas of the decode- and
            prefill-token counters, the requests by finish and the super-step dispatch
            count equal the engine's counts, the matmul selections name only the Q40
            dequant-matmuls, every /metrics line passes the strict exposition rule,
            every /v1/requests/<id> holds admitted, prefill_chunk and super_step,
            /v1/trace's super-step spans run in sequence and carry each request's trace
            id; under torch.profiler an annotated range encloses its graph launch; the
            disabled per-dispatch bundle against a one-token graph replay (under 1%),
            and the super-step period with the defaults, the tracer on and the flight
            recorder off
  constrain grammar-constrained decoding on the same weights (8 slots, superstep 8
            pipelined, speculative 8): 8 requests of 48 tokens admitted together, 2 under
            a JSON schema and 2 under the regex [a-z]{24} (compiled against the synthetic
            tokenizer's 32000 pieces), 4 unconstrained; all greedy, then 4 greedy and 4
            seeded: every constrained output valid; speculation off, the unconstrained
            rows identical to the grammar-free batch and the constrained greedy rows equal
            to their unconstrained stream up to the grammar's first veto; seeded runs
            repeat; speculation on (the grammar proposer's forced chains in masked verify
            blocks) against off, greedy rows under the near-tie rule; each seeded row's
            stream held exactly at its own dispatch shapes from the device sampler's
            records (`_seeded_exact`: every token the pick of its own coin, mask and
            logits row), where on and off part the same coin on each run's own logits;
            masked graphs replayed, no row degraded, the kernels launched on the path;
            ms per masked step against unmasked at T = 1, 2, 3, 5, 9, compile ms, the
            grammar proposer's accept rate
  draft     the model drafter on the same weights: a TinyLlama-1.1B-shaped drafter
            (random Q40 drawn on the card) beside the 8-slot engine (speculative 8):
            tokens against speculation off (the same rules), the drafter live with no
            proposer error, the kernels launched in the target's and the drafter's graphs;
            scan ms per step at each bucket (CUDA events) against the drafter's byte
            floor, drafted and accepted counts, frontier hits, the serving period with
            the drafter against n-gram drafting; then the 7B self-draft on the target's
            own weights (no copy): every greedy turn accepts every draft, or a rejection
            is a near-tie of the f64 witness
  moe       Mixtral-8x7B at full size (32 layers, random Q40 drawn on the card in i4p
            with the merged [up | gate] expert stack, bf16, prefill_kernel): the model
            phase's checks (100-token prompt, 64 greedy tokens as graph replays, the
            launches per token against the schedule — 193 q4_matvec launches, 128 of
            them through the expert entry — 16 steps' logits bit-identical graph and
            eager, the device loop's tokens the host loop's, ms/token, idle share and
            busy against the token's byte floor), the distinct experts each layer chose,
            and the peak memory; Mixtral on random Q80 weights (i8, 8 layers: the
            q8_matvec expert entry's path); Mixtral at 1 layer in f32, card against CPU
            (the Engine, and the fused BatchEngine on 4 staggered requests); Grok-1's
            block at full width (grok1_l2: 2 layers, 16 greedy tokens, graph against
            eager; its first layer card against CPU in f32)
  spill     the host KV spill at Llama-2-7B (random Q40 drawn on the card, bf16, kernels
            on, prefill_kernel): Engine(kv_cache_storage="host", kv_cache_resident=512)
            beside a dense Engine on the same weights; a warm run (100-token prompt, 32
            greedy tokens inside the ring, one-token steps as graph replays) bit-identical
            to the dense engine; run (a): a 1600-token prompt through the (64, 8, 1)
            ladder (the ring wraps three times) and 32 greedy tokens, every step's logits
            within NEAR_TIE·max|logits| of the dense engine's, the picks equal outside
            near-ties the f64 witness confirms, the store's rows [0, 512) bit-identical to
            the dense cache's, the cold counters on the cost model L·2·hk·(pos-R)·hs·2 at
            every step; the kernels' launches over both runs; run (b): a disc store at 7B
            width and 4 layers (1200-token prompt, 8 tokens), the file pair's sizes and
            the owned temp dir's cleanup; ms/token warm and paged (with the cold
            attention's host share from its span and its GB/s), prefill ms, the dense
            engine's beside them
  tp        tensor parallelism (parallel/), two ranks on cuda:0 over gloo (host-staged: a
            wiring figure, not a tensor-parallel speed): q4_matvec, q4_matmul, q8_matvec,
            decode_attention and the wire's quantize against their plain versions at
            Llama-2-7B's tp = 2 shard shapes, each timed by the profiler with its
            weights rotated past the L2 and its bound beside it; (a) 2 layers at 7B
            width in f32, the parity phase's Q40 and Q80 weights, raw and Q80 wire:
            tp = 2 on the card against the CPU (tp = 1 for the raw wire, its own tp = 2
            run over a CPU gloo world for the Q80 wire; engine_parity's tolerances,
            identical greedy tokens for 8 steps), each rank's launches on the schedule,
            the counted wire bytes on collective_kbytes_per_token; (b) Llama-2-7B at 32
            layers (Q40, bf16, prefill_kernel), Q80 and raw wire: a 100-token prompt and
            32 greedy tokens, ms/token, the wire bytes a token exactly on the model,
            launches per rank on the schedule, each rank's peak on the card held within
            its shard + KV + TP_PEAK_MARGIN (the weights drawn into host memory, each
            Engine repacking and cutting there), the first step's logits against the
            tp = 1 engine within a set tolerance and where the greedy tokens part; (c)
            an NCCL world of one (the collectives eager and in a CUDA graph), two NCCL
            ranks on one card (NCCL's words), NCCL across two cards where the machine
            has them
  kernels   each kernel against its plain torch version on the card at the main paths'
            shapes: max|err| against its tolerance, time per launch after warm-up,
            the plain version's time, the bound, and a PyTorch yardstick where one
            exists; the two attention kernels, the three Q40 dequant-matmul rows and
            the decode matvec rows (with the output dtype of their paths) must show
            one launch per call in a CUDA graph captured around one call (the Q40 rows
            also print GB/s, TFLOP/s, their share of the bound and, as context only,
            cuBLAS on the weight dequantized to bf16 beforehand, except at the verify
            shapes M = 2, 3, 5, 9, 16, 24, 40, 72; the matvec rows their
            sums per 7B decode token beside their times before the redesign), and
            decode_attention is captured once in a CUDA graph and replayed at two
            positions written to its device position tensor; the prologue at the path's
            rows and at rows that span several CTAs, and one 7B layer's four prologue ->
            pre-quantized matvec pairs on Q40 and on Q80 weights (the chain's outputs
            bit-identical, queued behind a spin kernel so the programmatic launches
            overlap, to synchronized calls and to its CUDA graph's replay; its device
            time beside the matvecs alone and its byte bound); the matvecs' expert
            entries at Mixtral-8x7B's expert shapes, each call reading another expert of
            an 8-expert stack from its device index, beside the 2-D entry on the same
            planes
  cli       `python -m distributed_llama_tpu_torch.apps.dllama generate` on a tiny
            .m/.t pair written by the port's writers, then with `--device-loop 8
            --trace`: the trace holds engine.prefill and engine.device_loop spans; then
            `--dtype float32` with and without `--tp 2 --device cuda:0 --dist-backend
            gloo --buffer-float-type f32`: the same text; then `--tp 2` on the Q80 wire
            (the default): its text is that of the same generation in a world of 2 on
            cuda:0, whose logits are held (2e-3·max|logits|, the near-tie rule) against
            the same wire's world of 2 on the CPU fed its tokens; where its tokens part
            from tp = 1's, tp = 1's own top-two gap there is logged

When the model, q80, serve, spec, moe and kernels phases all ran, it prints before the
last line {"kernels": [...]} (per kernel: route, source, the TPU kernel it replaces,
launches in its path's run — `path` names the run: the model phase and its prologue
run, the q80 phase's runs (a) and (b), the spec phase's speculating run (the four
serving kernels: prefill, super-steps and verify blocks), the moe phase's Mixtral
runs (Q40 and Q80); the precise mode of
q8_matvec has no path and
reports its launches in the kernels phase — max_abs_err, ms, plain_ms, bound_ms,
bound_by, library_ms). The last line is {"ok": true, "device": {...}}. Exits nonzero
without printing a result when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# the model phase runs before the profiler-timed kernel phase, so its host-side step
# times are not taken with profiler hooks installed
ALL_PHASES = ("env", "build", "parity", "model", "q80", "serve", "http", "prefix", "spec",
              "resil", "tenancy", "disagg", "obs", "constrain", "draft", "moe", "spill",
              "tp", "kernels", "cli")
SOURCES = ("q4_matvec", "q4_matmul", "decode_attention", "q4_gated_matmul",
           "paged_attention", "q8_matvec", "prologue")
_TPU = "distributed_llama_tpu/ops/"
# the run that counts the launches of the serving kernels: the spec phase's speculating
# engine (its prefill and mixed steps, single decode steps, super-steps and verify blocks)
SPEC_PATH = "spec, speculation-on run (8 slots, superstep 8 pipelined, speculative 8)"
# kernel row -> (CUDA source, TPU kernel it replaces, the run that counts its launches)
KERNELS = {
    "q4_matvec": ("q4_matvec", _TPU + "pallas_q4.py:142", "model"),
    "q4_matvec_q80": ("q4_matvec", _TPU + "pallas_q4.py:168", "model, prologue run"),
    "q4_matmul": ("q4_matmul", _TPU + "pallas_q4_mm.py:200", SPEC_PATH),
    "q4_matmul_res": ("q4_matmul", _TPU + "pallas_q4_mm.py:220", SPEC_PATH),
    "q4_gated_matmul": ("q4_gated_matmul", _TPU + "pallas_q4_mm.py:246", SPEC_PATH),
    "q4_matvec_expert": ("q4_matvec", _TPU + "pallas_q4.py:142", "moe, Mixtral-8x7B"),
    "q8_matvec": ("q8_matvec", _TPU + "pallas_q8.py:107", "q80, run (a)"),
    "q8_matvec_expert": ("q8_matvec", _TPU + "pallas_q8.py:107", "moe, Mixtral Q80"),
    "q8_matvec_precise": ("q8_matvec", _TPU + "pallas_q8.py:107",
                          "kernels phase (the precise body, _matvec_kernel_f32 at "
                          "pallas_q8.py:56, has no path: no entry point passes precise)"),
    "q8_matvec_q80": ("q8_matvec", _TPU + "pallas_q8.py:132", "q80, run (b)"),
    "decode_attention": ("decode_attention", _TPU + "pallas_attention.py:191", "model"),
    "paged_attention": ("paged_attention", _TPU + "pallas_paged_attention.py:176",
                        SPEC_PATH),
    "rmsnorm_q80": ("prologue", _TPU + "pallas_prologue.py:78", "q80, run (b)"),
    "quantize_q80": ("prologue", _TPU + "pallas_prologue.py:98", "q80, run (b)"),
}
# decode projections of Llama-2-7B as (N, K): wqkv, wo, w13, w2, wcls
SHAPES_7B = ((12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008), (32000, 4096))
# data-sheet memory rate (bytes/s) by card name; dense peaks from the H100 SXM data sheet
MEM_RATE = (("H200", 4.8e12), ("NVL", 3.9e12), ("PCIe", 2.0e12), ("H100", 3.35e12))
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
L2_BYTES = 50 << 20
# cycles per second a spin kernel is sized with: above the H100's boost clock, so the
# spin lasts at least the time asked for
SPIN_HZ = 2.0e9
# the kernels phase's profiler windows: taken, retaken because they lost records, given
# up after every retake lost records (late in a long run the profiler loses records on
# the card; PERF.md §6), and retaken because their time disagreed with the queued one
PROFILE_WINDOWS = {"taken": 0, "retaken": 0, "given_up": 0, "disagreed": 0}
# how far a one-launch call's profiled kernel time may lie from the queued time of the
# whole call (which adds the gap between back-to-back launches): relative, absolute
# ms. A full run on the card once read half the queued time (PERF.md §7).
PROFILE_AGREE = (0.1, 0.003)
# the serve phase's query tokens per row (decode, 8- and 64-token prefill chunks) and
# its matmul row counts, 8 slots x T
SERVE_CHUNKS = (1, 8, 64)
SERVE_ROWS = tuple(8 * t for t in SERVE_CHUNKS)
# the spec phase's verify blocks: T = 2, 3, 5 and 9 positions a row (SPEC_BUCKETS), so
# M = 8 slots x T in the batched engine and M = T in the single-sequence Engine
VERIFY_T = (2, 3, 5, 9)
VERIFY_ROWS = tuple(8 * t for t in VERIFY_T)


def log(msg: str) -> None:
    print(msg, flush=True)


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no data-sheet memory rate for card {name!r}")


def bound(nbytes: float, ops: float, peak_key: str, rate: float) -> tuple[float, str]:
    t_bytes = nbytes / rate * 1e3
    t_ops = ops / PEAK[peak_key] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def event_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call from CUDA events around `iters` back-to-back calls fn(i)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int, names: tuple[str, ...],
                   per_call: int | None = None, tries: int = 3) -> tuple[float | None, float]:
    """Device time per call of the kernels whose CUDA names contain any of `names`, and
    their launches per call, from torch.profiler. The profiler can lose records: a
    window whose count of matching launches is not within one of `per_call`·iters is
    taken again, up to `tries` windows, and the time is None when none holds up or no
    device time was recorded. With per_call None the count must be within one of a
    whole multiple of iters in two windows in a row that agree within one: lost records
    can leave a whole multiple too."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    count, prev = 0, None
    for attempt in range(tries):
        PROFILE_WINDOWS["taken"] += 1
        PROFILE_WINDOWS["retaken"] += attempt > 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if any(n in ev.key for n in names):
                us = getattr(ev, "self_device_time_total", 0.0) or getattr(
                    ev, "self_cuda_time_total", 0.0)
                total += us
                count += ev.count if us > 0 else 0
        want = per_call if per_call is not None else max(1, round(count / iters))
        whole = total > 0 and abs(count - want * iters) <= 1
        if whole and (per_call is not None or (prev is not None and abs(count - prev) <= 1)):
            return total / count * want / 1e3, count / iters
        prev = count if whole else None
    PROFILE_WINDOWS["given_up"] += 1
    return None, count / iters


def graph_launches(fn, name: str) -> tuple[int, int]:
    """Launches of the kernels whose CUDA names contain `name` in one call fn(0), and the
    nodes of all kinds, read from a CUDA graph captured around that call: a count that,
    unlike the profiler's records, cannot be lost."""
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn(0)
    dot = _graph_dot(graph)
    graph.reset()
    nodes = _dot_nodes(dot)
    return sum(name in n for n in nodes), len(nodes)


def _dot_nodes(dot: str) -> list[str]:
    """The node records of a CUDA graph's DOT dump (cudaGraphDebugDotPrint): a kernel
    node's record names its function."""
    nodes = re.split(r'"graph_\d+_node_\d+"\s*\[', dot)[1:]
    if not nodes:
        raise AssertionError(f"no nodes in the CUDA graph's dump: {dot[:400]!r}")
    return nodes


def _graph_dot(graph) -> str:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            return f.read()


def programmatic_edges(graph) -> tuple[int, int]:
    """(programmatic, all) dependency edges of a kept CUDA graph, read through the
    libcuda's cuGraphGetEdges_v2: an edge of type CU_GRAPH_DEPENDENCY_TYPE_PROGRAMMATIC
    lets its consumer launch before its producer ends (PDL kept by the capture)."""
    import ctypes

    fn = ctypes.CDLL("libcuda.so.1").cuGraphGetEdges_v2
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    rc = fn(raw, None, None, None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetEdges_v2 (count) returned {rc}")
    src, dst = (ctypes.c_void_p * n.value)(), (ctypes.c_void_p * n.value)()
    data = (ctypes.c_uint8 * (8 * n.value))()  # CUgraphEdgeData: ports, type, reserved
    rc = fn(raw, src, dst, data, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetEdges_v2 returned {rc}")
    return bytes(data)[2::8].count(1), n.value


def queued_ms(fn, iters: int, warmup: int = 3) -> tuple[float, bool]:
    """Mean ms per call of fn(0), ..., fn(iters - 1) from CUDA events, the calls queued
    behind a spin kernel sized to outlast their enqueueing, so the card runs them back to
    back: the device time of the whole call, host gaps hidden, without the profiler. The
    flag says whether the spin did outlast it; it cannot where fn waits on the card (a
    copy from pageable host memory), and the time then includes host gaps."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    spin_s = 2 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(2):
        torch.cuda._sleep(int(spin_s * SPIN_HZ))
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        covered = not start.query()  # the spin still ran when the last call was queued
        torch.cuda.synchronize()
        if covered:
            break
        spin_s *= 4
    return start.elapsed_time(end) / iters, covered


def device_time(fn, iters: int, names: tuple[str, ...], per_call: int | None = None
                ) -> tuple[float, str]:
    """Device ms per call of the kernels named, and its source: the profiler's, or, where
    the profiler lost records in every window, queued events' time of the whole call."""
    dv, _ = device_profile(fn, iters, names, per_call)
    if dv is not None:
        return dv, "profiler"
    ms, covered = queued_ms(fn, iters)
    src = "queued events: the profiler lost records" + ("" if covered else
                                                        ", host gaps included")
    what = "every kernel" if names == ("",) else "/".join(names)
    log(f"[kernels] {what}: {src} in every window")
    return ms, src


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env(state: dict) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    state["name"], state["rate"] = name, mem_rate(name)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    log(smi)
    log(f"[env] memory rate {state['rate'] / 1e12:.2f} TB/s (data sheet for {name})")


def phase_build(state: dict) -> None:
    from distributed_llama_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build(list(SOURCES))
    log(f"[build] {len(SOURCES)} kernel sources in {time.perf_counter() - t0:.1f} s "
        f"({cuda_build.nvcc_path()})")
    for name in SOURCES:
        path = os.path.join(cuda_build.BUILD_DIR, f"{name}.log")
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    if "registers" in line or "spill" in line:
                        log(f"[build] {name}: {line.strip()}")


def _random_i4p(n: int, k: int, gen: torch.Generator, dev, lead: tuple = (),
                lo: int = 0) -> tuple[torch.Tensor, ...]:
    """Random i4p planes (*lead, N, K/2) u8 and f16 scales (*lead, N, K/32): bytes
    uniform over 0..255, or with `lo` each nibble uniform over lo..15."""
    shape = (*lead, n, k // 2)
    if lo:
        packed = torch.randint(lo, 16, shape, dtype=torch.uint8, generator=gen, device=dev)
        packed |= torch.randint(lo, 16, shape, dtype=torch.uint8, generator=gen,
                                device=dev) << 4
    else:
        packed = torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen, device=dev)
    scales = (torch.rand((*lead, n, k // 32), generator=gen, device=dev) * 0.004 + 0.002
              ).to(torch.float16)
    return packed, scales


def _record(state, name, err, tol, ms, plain, bnd, lib_ms, work):
    rec = state["kernel_rows"].setdefault(name, {
        "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
        "bound_by": {}, "library_ms": None if lib_ms is None else 0.0, "work": []})
    if err > tol:
        raise AssertionError(f"{name} {work}: max|err| {err:.3e} > tolerance {tol:.3e}")
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["ms"] += ms
    rec["plain_ms"] += plain
    rec["bound_ms"] += bnd[0]
    rec["bound_by"][bnd[1]] = rec["bound_by"].get(bnd[1], 0.0) + bnd[0]
    if lib_ms is not None:
        rec["library_ms"] += lib_ms
    rec["work"].append(work)


def _one_launch_time(fn, iters: int, name: str) -> tuple[float, float, str, float]:
    """Events ms and device ms per call of a kernel that must be one launch per call, a
    note on how they were read, and queued events' time of the whole call: a CUDA graph
    of one call must hold exactly one launch of the kernel. A profiled time that
    disagrees with the queued one (PROFILE_AGREE) is retaken, and after three
    disagreeing windows the queued time stands. (A kernel launched with programmatic
    stream serialization starts before the one ahead of it ends, so back to back its
    profiled time includes that wait; the queued time is what a stream of its calls
    takes.)"""
    named, nodes = graph_launches(fn, name)
    if named != 1:
        raise AssertionError(f"{name}: a CUDA graph of one call holds {named} launches "
                             f"of it ({nodes} nodes in all), want exactly 1")
    ev = event_ms(fn, iters)
    whole, covered = queued_ms(fn, iters)
    rel, ab = PROFILE_AGREE
    for _ in range(3):
        dv, src = device_time(fn, iters, (name,), per_call=1)
        # the kernel's time cannot exceed the whole call's, and is all of it where the
        # call is one node queued without host gaps
        if dv <= whole * (1 + rel) + ab and (nodes > 1 or not covered
                                             or dv >= whole * (1 - rel) - ab):
            break
        PROFILE_WINDOWS["disagreed"] += 1
    else:
        log(f"[kernels] {name}: profiled {dv:.5f} ms against {whole:.5f} ms queued for the "
            f"whole call ({nodes} nodes) in 3 windows; the queued time stands")
        dv, src = whole, "queued events: the profiler's time disagreed with them"
    gaps = "" if covered else ", host gaps included"
    return ev, dv, (f"{src}, whole call {whole:.5f} ms queued{gaps}; 1 launch/call in a "
                    f"CUDA graph of one call, {nodes} nodes"), whole


BF16 = torch.bfloat16  # the Q40 dequant-matmuls' output on the bf16 paths


def _bf16_err(y: torch.Tensor, ref: torch.Tensor, rel: float = 1e-3) -> tuple[float, float]:
    """A bf16 kernel output against its plain version's f32 result: every element of y
    within the f32 tolerance rel·max|ref| (the Q40 dequant-matmuls 1e-3: the same bf16
    operands, f32 sums in another order; the decode matvecs 1e-4: exact integer block
    dots) plus one bf16 ulp at its own magnitude (rounding two f32 values to bf16 moves
    them at most one ulp further apart) of bf16(ref). Raises where one is not; returns
    max|y - bf16(ref)| and the largest element's tolerance."""
    if y.dtype != BF16:
        raise AssertionError(f"the kernel wrote {y.dtype}, not bf16")
    want = ref.to(BF16).float()
    diff = (y.float() - want).abs()
    big = torch.maximum(ref.abs(), y.float().abs()).clamp_min(2.0 ** -126)
    tol = rel * ref.abs().max() + torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8)
    bad = diff > tol
    if bad.any():
        at = int(bad.flatten().nonzero()[0])
        raise AssertionError(f"bf16 output off at element {at}: {float(y.flatten()[at])} "
                             f"against {float(ref.flatten()[at])} (tolerance "
                             f"{float(tol.flatten()[at]):.3e})")
    return diff.max().item(), tol.max().item()


def _cublas_ms(x, copies: list, iters: int, res=None) -> float:
    """Context yardstick for the Q40 dequant-matmuls, not the same function: torch.matmul
    (cuBLAS) of x against each weight of a copy, dequantized to bf16 beforehand (3.6x
    the weight bytes), plus the residual where there is one; copies (lists of
    (packed, scales) planes) rotate past the L2; device ms per call."""
    from distributed_llama_tpu_torch.ops.q4_matmul import dequant_bf16

    per = sum(p.numel() * 4 for p, _ in copies[0])  # bf16 bytes of one copy
    cb = max(1, min(len(copies), math.ceil(2 * L2_BYTES / per)))
    wd = [[dequant_bf16(*p) for p in c] for c in copies[:cb]]
    rb = None if res is None else res.to(torch.bfloat16)
    fn = ((lambda i: [x @ w.T for w in wd[i % cb]]) if rb is None
          else (lambda i: torch.add(rb, x @ wd[i % cb][0].T)))
    ms = _all_kernels_ms(fn, iters)
    del wd
    return ms


def _q4_log(row: str, shape: str, err, tol, dv, how, ev, plain, bnd, nbytes, flops,
            cublas) -> None:
    """One Q40 dequant-matmul row's line; cublas None: the context yardstick was not
    timed (the verify shapes, to keep the phase short)."""
    ctx = ("" if cublas is None else f"; cuBLAS on the bf16 weight dequantized beforehand "
           f"(context, not the same function) {cublas:.5f} ms")
    log(f"[kernels] {row} {shape}: max|err| {err:.3e} (tol {tol:.3e}) device "
        f"{round(dv, 5)} ms ({how}), events {ev:.5f} ms, plain {plain:.3f} ms, bound "
        f"{bnd[0]:.5f} ms ({bnd[1]}), {bnd[0] / dv:.3f} of the bound, "
        f"{nbytes / (dv * 1e-3) / 1e9:.0f} GB/s, {flops / (dv * 1e-3) / 1e12:.2f} TFLOP/s"
        f"{ctx}")


def _all_kernels_ms(fn, iters: int) -> float:
    """Device time per call of every kernel fn launches (the plain versions and the
    PyTorch yardstick)."""
    return device_time(fn, iters, ("",))[0]


def phase_kernels(state: dict) -> None:
    from distributed_llama_tpu_torch.ops import decode_attention as da
    from distributed_llama_tpu_torch.ops import q4_matvec as mv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    rate = state["rate"]
    state["q4"] = {}  # (row, M, N, K) -> (device ms, bound ms) of the Q40 dequant-matmuls

    state["mv"] = {}  # (row, N, K, x dtype) -> (device ms, bound ms) of the matvecs

    # kernel 1 — as the model phase calls it: a bf16 row, bf16 output (`_matvec_row`)
    for n, k in SHAPES_7B:
        wbytes = n * k // 2 + n * k // 32 * 2
        copies = max(1, min(16, math.ceil(2 * L2_BYTES / wbytes)))  # defeat L2 reuse
        ws = [_random_i4p(n, k, gen, dev) for _ in range(copies)]
        x = _test_row(k, gen, dev, BF16)
        _matvec_row(state, "q4_matvec", lambda i: mv._launch(x, *ws[i % copies], BF16),
                    lambda i: mv.q4_matvec_plain(x, *ws[i % copies]),
                    wbytes + k * 2 + n * 2, n, k, rate, "q4_matvec_kernel", "bfloat16")
        del ws

    # kernel 2 — tolerance 1e-3·max|y| plus one bf16 ulp per element (`_bf16_err`): bf16
    # operands are rounded identically, so only the accumulation order and the tensor
    # cores' f32 accumulate rounding differ; the output is bf16, as the paths take it
    # M = 8 and 64: the model phase's 8- and 64-token chunks (all five projections) and
    # the serve phase's decode and 8-token mixed steps; M = 512: the serve phase's
    # 64-token mixed steps, where wqkv and wcls are this kernel's
    cases = [(m, n, k) for m in (8, 64) for n, k in SHAPES_7B]
    cases += [(512, n, k) for n, k in (SHAPES_7B[0], SHAPES_7B[4])]
    for m, n, k in cases:
        _q4_matmul_row(state, m, n, k, gen, dev, rate)
    # the verify blocks of the spec phase: the single-sequence Engine's (M = T, every
    # projection) and the batched engine's wqkv and wcls (M = 8 x T)
    cases = [(m, n, k) for m in VERIFY_T for n, k in SHAPES_7B]
    cases += [(m, n, k) for m in VERIFY_ROWS for n, k in (SHAPES_7B[0], SHAPES_7B[4])]
    for m, n, k in cases:
        _q4_matmul_row(state, m, n, k, gen, dev, rate, cublas=False)

    # kernel 3 — tolerance 1e-4·max|out|: q and p enter the tensor cores as bf16 hi/lo
    # pairs against exact bf16 K/V rows (~2^-16 relative), the softmax runs in f32 in
    # both, and the order of the sums (split merge) differs. NaN fills every slot at or
    # past the position: the kernel must never read one. Position and layer are device
    # tensors, as the forward pass hands them.
    n_layers, s_len = 8, 2048
    layers = [torch.tensor([li], dtype=torch.int32, device=dev) for li in range(n_layers)]
    from distributed_llama_tpu_torch.ops import cuda_build
    from distributed_llama_tpu_torch.ops import paged_attention as pa

    fits = {f"{src} {dt} hs={hs} rows={r}": getattr(
        cuda_build.load(src, mod._SIGNATURES), f"{src}_blocks_per_sm")(
        int(dt == "bf16"), hs, r)
        for src, mod in (("decode_attention", da), ("paged_attention", pa))
        for dt in ("bf16", "f32") for hs in (64, 128) for r in (8, 64)}
    log(f"[kernels] attention blocks per SM: {json.dumps(fits)}")
    for hk, g in ((32, 1), (8, 4)):
        hs = 128
        kc = torch.randn(n_layers, 1, hk, s_len, hs, generator=gen, device=dev).to(
            torch.bfloat16)
        vc = torch.randn(n_layers, 1, hk, s_len, hs, generator=gen, device=dev).to(
            torch.bfloat16)
        q = torch.randn(hk, g, hs, generator=gen, device=dev)
        kn = torch.randn(hk, 1, hs, generator=gen, device=dev).to(torch.bfloat16)
        vn = torch.randn(hk, 1, hs, generator=gen, device=dev).to(torch.bfloat16)
        # longest position first: each case fills NaN past its position only
        cases = sorted(((w, p) for w in (256, 2048) for p in (w // 2 + 3, w)),
                       key=lambda c: -c[1])
        for win, pos in cases:
            if pos < s_len:
                kc[:, :, :, pos:] = float("nan")
                vc[:, :, :, pos:] = float("nan")
            pt = torch.tensor([pos], dtype=torch.int64, device=dev)
            out = da._launch(q, kc, vc, kn, vn, layers[2], pt, win)
            ref = da.decode_attention_plain(q, kc, vc, kn, vn, 2, pos, win)
            if not torch.isfinite(out).all():
                raise AssertionError(f"decode_attention win={win} pos={pos}: "
                                     "non-finite output")
            err = (out - ref).abs().max().item()
            tol = 1e-4 * ref.abs().max().item()
            ev, dv, how, _ = _one_launch_time(
                lambda i: da._launch(q, kc, vc, kn, vn, layers[i % n_layers], pt, win),
                50, "decode_attn_kernel")
            plain = _all_kernels_ms(lambda i: da.decode_attention_plain(
                q, kc, vc, kn, vn, i % n_layers, pos, win), 10)
            # yardstick: one SDPA call over the same keys (committed slots + the
            # current token), inputs prebuilt outside the timed call
            ks = [torch.cat([kc[li, 0, :, :pos], kn], dim=1).repeat_interleave(g, 0)
                  for li in range(n_layers)]
            vs = [torch.cat([vc[li, 0, :, :pos], vn], dim=1).repeat_interleave(g, 0)
                  for li in range(n_layers)]
            qb = q.reshape(1, hk * g, 1, hs).to(torch.bfloat16)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = _all_kernels_ms(
                lambda i: sdpa(qb, ks[i % n_layers][None], vs[i % n_layers][None]), 50)
            nbytes = 2 * hk * pos * hs * 2 + q.numel() * 4 + 2 * hk * hs * 2 + \
                out.numel() * 4
            # bf16 tensor-core operations: scores and P·V, each issued for the hi and
            # the lo part of q and p
            bnd = bound(nbytes, 2 * 4 * hk * g * (pos + 1) * hs, "bf16", rate)
            ms = dv
            log(f"[kernels] decode_attention hk={hk} g={g} win={win} pos={pos}: "
                f"max|err| {err:.3e} (tol {tol:.3e}) device {round(dv, 5)} ms ({how}), "
                f"events {ev:.5f} ms, plain {plain:.3f} ms, sdpa "
                f"{lib:.5f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}), "
                f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
            _record(state, "decode_attention", err, tol, ms, plain, bnd, lib,
                    f"hk={hk},g={g},win={win},pos={pos}")
            del ks, vs
        del kc, vc
    _decode_graph_check(gen, dev)
    torch.cuda.empty_cache()
    _kernels_serving(state, gen, dev, rate)
    torch.cuda.empty_cache()
    _kernels_q80(state, gen, dev, rate)
    torch.cuda.empty_cache()
    _kernels_moe(state, gen, dev, rate)
    torch.cuda.empty_cache()
    _q4_step_sums(state["q4"])
    log(f"[kernels] profiler windows: {json.dumps(PROFILE_WINDOWS)}")


def _q4_matmul_row(state: dict, m: int, n: int, k: int, gen, dev, rate: float,
                   cublas: bool = True) -> None:
    """Hold q4_matmul at M x N x K (bf16 row and output) against its plain version
    (`_bf16_err`), time it as one launch per call and record the row with its bound
    (and, with `cublas`, time the cuBLAS context yardstick)."""
    from distributed_llama_tpu_torch.ops import q4_matmul as mm

    wbytes = n * k // 2 + n * k // 32 * 2
    copies = max(1, min(16, math.ceil(2 * L2_BYTES / wbytes)))  # defeat L2 reuse
    ws = [_random_i4p(n, k, gen, dev) for _ in range(copies)]
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    y = mm._launch(x, *ws[0], out_dtype=BF16)
    ref = mm.q4_matmul_plain(x, *ws[0])
    err, tol = _bf16_err(y, ref)
    ev, dv, how, _ = _one_launch_time(
        lambda i: mm._launch(x, *ws[i % copies], out_dtype=BF16), 20,
        "q4_matmul_tc_kernel")
    plain = _all_kernels_ms(lambda i: mm.q4_matmul_plain(x, *ws[i % copies]), 3)
    nbytes = wbytes + m * k * 2 + m * n * 2
    flops = 2 * m * n * k
    bnd = bound(nbytes, flops, "bf16", rate)
    _q4_log("q4_matmul", f"M={m} N={n} K={k}", err, tol, dv, how, ev, plain, bnd,
            nbytes, flops, _cublas_ms(x, [[w] for w in ws], 20) if cublas else None)
    _record(state, "q4_matmul", err, tol, dv, plain, bnd, None, f"M={m},N={n},K={k}")
    state["q4"][("q4_matmul", m, n, k)] = (dv, bnd[0])


def _q4_step_sums(t: dict) -> None:
    """Log the Q40 dequant-matmuls' device ms and bound summed over the 7B shapes of a
    step: a serving step of 8 rows x T (wqkv and wcls on q4_matmul, wo and w2 on its
    residual mode, w1·w3 on q4_gated_matmul) and a single-sequence prefill chunk (every
    projection on q4_matmul), 32 layers and wcls once."""
    wqkv, wo, w13, w2, wcls = SHAPES_7B
    steps = {f"serving step M={m}": [
        (32, "q4_matmul", m, wqkv), (1, "q4_matmul", m, wcls), (32, "q4_matmul_res", m, wo),
        (32, "q4_matmul_res", m, w2), (32, "q4_gated_matmul", m, (11008, 4096))]
        for m in SERVE_ROWS + VERIFY_ROWS}
    for m in (64, 8) + VERIFY_T:
        steps[f"single-sequence {m}-token chunk"] = [
            (32, "q4_matmul", m, w) for w in (wqkv, wo, w13, w2)] + [
            (1, "q4_matmul", m, wcls)]
    parts = []
    for what, terms in steps.items():
        got = [(c, t.get((row, m, *w))) for c, row, m, w in terms]
        if all(v is not None for _, v in got):
            parts.append(f"{what} {sum(c * v[0] for c, v in got):.3f} ms (bound "
                         f"{sum(c * v[1] for c, v in got):.3f})")
    log("[kernels] Q40 dequant-matmuls summed over a step's 7B shapes: " + "; ".join(parts))


def _decode_graph_check(gen, dev) -> None:
    """decode_attention captured once in a CUDA graph at 7B width (32 heads, window
    2048), replayed at two positions after the device position is updated in place;
    each replay within 1e-4·max|out| of the plain version."""
    from distributed_llama_tpu_torch.ops import decode_attention as da

    hk, hs, s_len, top = 32, 128, 2048, 1500
    kc = torch.randn(2, 1, hk, s_len, hs, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(2, 1, hk, s_len, hs, generator=gen, device=dev).to(torch.bfloat16)
    kc[:, :, :, top:] = float("nan")
    vc[:, :, :, top:] = float("nan")
    q = torch.randn(hk, 1, hs, generator=gen, device=dev)
    kn = torch.randn(hk, 1, hs, generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn(hk, 1, hs, generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.ones(1, dtype=torch.int64, device=dev)
    layer = torch.ones(1, dtype=torch.int32, device=dev)
    da._launch(q, kc, vc, kn, vn, layer, pos, s_len)  # warm-up outside the capture
    torch.cuda.synchronize()
    before = da.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da._launch(q, kc, vc, kn, vn, layer, pos, s_len)
    errs = []
    for p in (131, top):
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        ref = da.decode_attention_plain(q, kc, vc, kn, vn, 1, p, s_len)
        err = (out - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()
        if not torch.isfinite(out).all() or err > tol:
            raise AssertionError(f"decode_attention graph replay at pos {p}: max|err| "
                                 f"{err:.3e} > {tol:.3e}")
        errs.append(f"pos {p} max|err| {err:.3e} (tol {tol:.3e})")
    log(f"[kernels] decode_attention captured once ({da.launches - before} launch) and "
        f"replayed from a CUDA graph: " + "; ".join(errs))


def _kernels_serving(state: dict, gen, dev, rate: float) -> None:
    """Kernels 4, 5 and 9 against their plain versions at the serve phase's shapes."""
    from distributed_llama_tpu_torch.ops import paged_attention as pa
    from distributed_llama_tpu_torch.ops import q4_gated_matmul as gm
    from distributed_llama_tpu_torch.ops import q4_matmul as mm

    # every row count the serve and spec phases send kernels 4 and 5: M = 8 slots x T for
    # decode steps (T = 1), 8- and 64-token mixed steps and the verify blocks (T = 2, 3,
    # 5, 9; their cuBLAS yardstick is not timed)
    # kernel 4 — tolerance as kernel 2's: identical bf16 operands, f32 sums in another
    # order, the residual added in f32 on both sides, the output bf16
    for m in SERVE_ROWS + VERIFY_ROWS:
        for n, k in ((4096, 4096), (4096, 11008)):
            wbytes = n * k // 2 + n * k // 32 * 2
            copies = max(1, min(16, math.ceil(2 * L2_BYTES / wbytes)))
            ws = [_random_i4p(n, k, gen, dev) for _ in range(copies)]
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            res = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
            y = mm._launch(x, *ws[0], res, out_dtype=BF16)
            ref = mm.q4_matmul_res_plain(x, *ws[0], res)
            err, tol = _bf16_err(y, ref)
            ev, dv, how, _ = _one_launch_time(
                lambda i: mm._launch(x, *ws[i % copies], res, out_dtype=BF16), 20,
                "q4_matmul_tc_kernel")
            plain = _all_kernels_ms(
                lambda i: mm.q4_matmul_res_plain(x, *ws[i % copies], res), 3)
            nbytes = wbytes + m * k * 2 + m * n * 2 + m * n * 2
            flops = 2 * m * n * k
            bnd = bound(nbytes, flops, "bf16", rate)
            ms = dv
            _q4_log("q4_matmul_res", f"M={m} N={n} K={k}", err, tol, dv, how, ev, plain, bnd,
                    nbytes, flops, _cublas_ms(x, [[w] for w in ws], 20, res)
                    if m in SERVE_ROWS else None)
            _record(state, "q4_matmul_res", err, tol, ms, plain, bnd, None,
                    f"M={m},N={n},K={k}")
            state["q4"][("q4_matmul_res", m, n, k)] = (dv, bnd[0])

    # kernel 5 — tolerance as kernel 2's: both products as kernel 2, the activation on
    # the same f32 sums (expf/tanhf on the card against torch's on the card), bf16 out
    n, k = 11008, 4096
    wbytes = 2 * (n * k // 2 + n * k // 32 * 2)
    copies = max(1, min(16, math.ceil(2 * L2_BYTES / wbytes)))
    pairs = [(_random_i4p(n, k, gen, dev), _random_i4p(n, k, gen, dev))
             for _ in range(copies)]
    for m in SERVE_ROWS + VERIFY_ROWS:
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        y = gm._launch(x, *pairs[0], "silu", out_dtype=BF16)
        ref = gm.q4_gated_matmul_plain(x, *pairs[0], "silu")
        err, tol = _bf16_err(y, ref)
        ev, dv, how, _ = _one_launch_time(
            lambda i: gm._launch(x, *pairs[i % copies], "silu", out_dtype=BF16), 20,
            "q4_gated_tc_kernel")
        plain = _all_kernels_ms(
            lambda i: gm.q4_gated_matmul_plain(x, *pairs[i % copies], "silu"), 3)
        nbytes = wbytes + m * k * 2 + m * n * 2
        flops = 4 * m * n * k
        bnd = bound(nbytes, flops, "bf16", rate)
        ms = dv
        _q4_log("q4_gated_matmul", f"M={m} N={n} K={k} silu", err, tol, dv, how, ev, plain,
                bnd, nbytes, flops, _cublas_ms(x, [list(p) for p in pairs], 20)
                if m in SERVE_ROWS else None)
        _record(state, "q4_gated_matmul", err, tol, ms, plain, bnd, None,
                f"M={m},N={n},K={k}")
        state["q4"][("q4_gated_matmul", m, n, k)] = (dv, bnd[0])
    del pairs

    # kernel 9 — tolerance 1e-4·max|out|: q and p enter the tensor cores as bf16 hi/lo
    # pairs against exact bf16 K/V rows (~2^-16 relative), the softmax runs in f32 in
    # both, and the order of the sums differs. NaN fills the scratch block, the blocks no
    # table holds, and the rows past each length in live blocks.
    b, hk, hs, bt, n_layers = 8, 32, 128, 16, 2
    n_blocks = b * (2048 // bt) + 1
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for win in (256, 2048):
        for t in SERVE_CHUNKS + VERIFY_T:
            kc = torch.randn(n_layers, n_blocks, hk, bt, hs, generator=gen,
                             device=dev).to(torch.bfloat16)
            vc = torch.randn(n_layers, n_blocks, hk, bt, hs, generator=gen,
                             device=dev).to(torch.bfloat16)
            n_read = win // bt
            lengths = [max(win - t - 37 * i, 0) for i in range(b)]
            perm = torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(
                win + t)) + 1
            tables = torch.zeros(b, 2048 // bt, dtype=torch.int32)
            used, live = 0, []
            for r, ln in enumerate(lengths):
                nb = -(-ln // bt)
                tables[r, :nb] = perm[used:used + nb].to(torch.int32)
                live += perm[used:used + nb].tolist()
                used += nb
            dead = torch.ones(n_blocks, dtype=torch.bool)
            dead[live] = False
            dead = dead.to(dev)
            kc[:, dead] = float("nan")
            vc[:, dead] = float("nan")
            for r, ln in enumerate(lengths):
                if ln % bt:
                    kc[:, int(tables[r, ln // bt]), :, ln % bt:] = float("nan")
                    vc[:, int(tables[r, ln // bt]), :, ln % bt:] = float("nan")
            tables = tables.to(dev)
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            layer = torch.ones(1, dtype=torch.int32, device=dev)
            q = torch.randn(b, t, hk, hs, generator=gen, device=dev)
            kn = torch.randn(b, hk, t, hs, generator=gen, device=dev).to(torch.bfloat16)
            vn = torch.randn(b, hk, t, hs, generator=gen, device=dev).to(torch.bfloat16)
            out = pa._launch(q, kc, vc, kn, vn, tables, lens, layer, n_read)
            ref = pa.paged_attention_plain(q, kc, vc, kn, vn, tables, lens, 1,
                                           n_read=n_read)
            if not torch.isfinite(out).all():
                raise AssertionError(f"paged_attention win={win} T={t}: non-finite output")
            err = (out - ref).abs().max().item()
            tol = 1e-4 * ref.abs().max().item()
            ev, dv, how, _ = _one_launch_time(
                lambda i: pa._launch(q, kc, vc, kn, vn, tables, lens, layer, n_read), 30,
                "paged_attn_kernel")
            plain = _all_kernels_ms(lambda i: pa.paged_attention_plain(
                q, kc, vc, kn, vn, tables, lens, 1, n_read=n_read), 5)
            # yardstick: one SDPA call over the same keys gathered contiguous (committed
            # rows ++ chunk, padded to the longest row under a boolean mask)
            lmax = max(lengths) + t
            kf = torch.zeros(b, hk, lmax, hs, dtype=torch.bfloat16, device=dev)
            vf = torch.zeros_like(kf)
            mask = torch.zeros(b, 1, t, lmax, dtype=torch.bool, device=dev)
            for r, ln in enumerate(lengths):
                kw, vw = pa.paged_gather_kv(kc, vc, 1, tables[r:r + 1], -(-ln // bt) or 1)
                kf[r, :, :ln] = kw[0, :, :ln]
                vf[r, :, :ln] = vw[0, :, :ln]
                kf[r, :, ln:ln + t] = kn[r]
                vf[r, :, ln:ln + t] = vn[r]
                mask[r, 0, :, :ln] = True
                mask[r, 0, :, ln:ln + t] = torch.ones(t, t, dtype=torch.bool,
                                                      device=dev).tril()
            qb = q.permute(0, 2, 1, 3).to(torch.bfloat16)
            lib = _all_kernels_ms(lambda i: sdpa(qb, kf, vf, attn_mask=mask), 30)
            kv_bytes = sum(2 * hk * ln * hs * 2 for ln in lengths)
            nbytes = kv_bytes + q.numel() * 4 + 2 * kn.numel() * 2 + out.numel() * 4
            # bf16 tensor-core operations the data needs (committed slots, the chunk
            # keys under the causal mask), scores and P·V each issued for the hi and the
            # lo part of q and p
            ops = sum(2 * 4 * hk * hs * (t * ln + t * (t + 1) // 2) for ln in lengths)
            bnd = bound(nbytes, ops, "bf16", rate)
            ms = dv
            log(f"[kernels] paged_attention B={b} T={t} win={win} hk={hk}: max|err| "
                f"{err:.3e} (tol {tol:.3e}) device {round(dv, 5)} ms ({how}), "
                f"events {ev:.5f} ms, plain {plain:.3f} ms, sdpa {lib:.5f} ms, bound "
                f"{bnd[0]:.5f} ms ({bnd[1]}), {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
            _record(state, "paged_attention", err, tol, ms, plain, bnd, lib,
                    f"B={b},T={t},win={win}")
            del kf, vf, kc, vc


def _random_i8(gen: torch.Generator, dev, *shape: int) -> tuple[torch.Tensor, ...]:
    """Random int8 planes (..., N, K) and f32 block scales (..., N, K/32) — the f16
    deltas of a Q80 file widened to f32 — spread near the i4p draw's weights."""
    w8 = torch.randint(-127, 128, shape, dtype=torch.int8, generator=gen, device=dev)
    scales = (torch.rand((*shape[:-1], shape[-1] // 32), generator=gen, device=dev)
              * 5e-5 + 2e-4).to(torch.float16).float()
    return w8, scales


def _test_row(k: int, gen: torch.Generator, dev, dtype) -> torch.Tensor:
    """A random activation row with an all-zero block (block 1)."""
    x = torch.randn(k, generator=gen, device=dev)
    x[32:64] = 0.0
    return x.to(dtype)


def _matvec_row(state, name: str, kern, plain_fn, nbytes: int, n: int, k: int,
                rate: float, kname: str, xdt: str) -> None:
    """Hold a decode matvec kern(i) (weights copy i) against plain_fn(i): f32 output
    within 1e-4·max|y| (exact integer block dots, or the precise body's f32 block sums
    of the same products; the f32 sum over K/32 block terms in another order), bf16
    output within that plus one bf16 ulp of the plain result rounded (`_bf16_err`). The
    kernel must be one launch per call in a CUDA graph of one call; time both and record
    the row with its byte bound (2·N·K int8 ops, or f32 ops for the precise body)."""
    y, ref = kern(0), plain_fn(0)
    if y.dtype == BF16:
        err, tol = _bf16_err(y, ref, 1e-4)
    else:
        err, tol = (y - ref).abs().max().item(), 1e-4 * ref.abs().max().item()
    ev, dv, how, whole = _one_launch_time(kern, 50, kname)
    # the pre-quantized entries launch with programmatic serialization: back to back
    # each profiled time includes the wait for the call ahead, so they are also timed
    # alone, the card synchronized after each call
    alone = dv if not name.endswith("_q80") else device_profile(
        lambda i: (kern(i), torch.cuda.synchronize()), 20, (kname,), per_call=1)[0]
    alone = math.nan if alone is None else alone  # every window lost records
    plain = _all_kernels_ms(plain_fn, 5)
    bnd = bound(nbytes, 2 * n * k, "f32" if "precise" in name else "int8", rate)
    work = f"N={n},K={k},{xdt}->{str(y.dtype)[6:]}"
    log(f"[kernels] {name} {work}: max|err| {err:.3e} (tol {tol:.3e}) device "
        f"{round(dv, 5)} ms ({how}), events {ev:.5f} ms, plain {plain:.3f} ms, bound "
        f"{bnd[0]:.5f} ms ({bnd[1]}), {bnd[0] / dv:.3f} of the bound, "
        f"{nbytes / (dv * 1e-3) / 1e9:.0f} GB/s"
        + (f"; alone (synchronized after each call) {alone} ms" if alone != dv else ""))
    _record(state, name, err, tol, dv, plain, bnd, None, work)
    state["mv"][(name, n, k, xdt)] = (dv, bnd[0], whole, alone)


# the decode matvecs' device time per 7B decode token in kernels-only runs before the
# prologue's redesign (PERF.md §6; bf16 rows for the float entries)
MV_TOKEN_BEFORE = {"q4_matvec": 1.663, "q4_matvec_q80": 1.662, "q8_matvec": 2.789,
                   "q8_matvec_precise": 3.233, "q8_matvec_q80": 2.790}


def _matvec_token_sums(t: dict) -> None:
    """Log each matvec row's device ms, queued whole-call ms and bound per decode token
    of Llama-2-7B: wqkv, wo, w13 and w2 x 32 layers, wcls once; for the pre-quantized
    entries also the device ms of calls timed alone. The queued time is what a stream of
    the calls takes; back to back, a programmatic launch's profiled time includes its
    wait for the call ahead, the time alone does not."""
    parts = []
    for name, xdt in (("q4_matvec", "bfloat16"), ("q4_matvec_q80", "int8"),
                      ("q8_matvec", "bfloat16"), ("q8_matvec", "float32"),
                      ("q8_matvec_precise", "bfloat16"), ("q8_matvec_precise", "float32"),
                      ("q8_matvec_q80", "int8")):
        got = [t.get((name, n, k, xdt)) for n, k in SHAPES_7B]
        if all(v is not None for v in got):
            ms, bnd, whole, alone = (32 * sum(v[j] for v in got[:4]) + got[4][j]
                                     for j in range(4))
            parts.append(f"{name} ({xdt} row) {ms:.3f} ms, queued {whole:.3f} ms"
                         + (f", alone {alone:.3f} ms" if name.endswith("_q80") else "")
                         + f" (bound {bnd:.3f}, before {MV_TOKEN_BEFORE[name]:.3f})")
    log("[kernels] decode matvecs per 7B token (device; queued whole calls): "
        + "; ".join(parts))


def _kernels_q80(state: dict, gen, dev, rate: float) -> None:
    """Kernels 2, 6 (both bodies), 7, 10 and 11 against their plain versions at the
    decode shapes of Llama-2-7B (q80 phase and the model phase's prologue run), and one
    layer's prologue -> pre-quantized matvec chain on Q40 and Q80 weights."""
    from distributed_llama_tpu_torch.ops import prologue as pro
    from distributed_llama_tpu_torch.ops import q4_matvec as mv
    from distributed_llama_tpu_torch.ops import q8_matvec as q8

    # kernels 6, 7 and 2, with the output dtype of their paths: the row's dtype for
    # q8_matvec (the bf16 engine, and the f32 one of the parity phase), bf16 for the
    # pre-quantized entries (the bf16 engine's prologue); tolerances as `_matvec_row`
    q8.precise_launches = 0
    for n, k in SHAPES_7B:
        wbytes = n * k + n * k // 32 * 4
        copies = max(1, min(16, math.ceil(2 * L2_BYTES / wbytes)))
        ws = [_random_i8(gen, dev, n, k) for _ in range(copies)]
        for dtype in (torch.float32, torch.bfloat16):
            x = _test_row(k, gen, dev, dtype)
            esz = x.element_size()
            for precise in (False, True):
                plain_fn = q8.q8_matvec_precise_plain if precise else q8.q8_matvec_plain
                _matvec_row(state, "q8_matvec_precise" if precise else "q8_matvec",
                            lambda i: q8._launch(x, *ws[i % copies], precise, dtype),
                            lambda i: plain_fn(x, *ws[i % copies]),
                            wbytes + k * esz + n * esz, n, k, rate, "q8_matvec_kernel",
                            str(dtype)[6:])
        xq, sx = mv.quantize_row(_test_row(k, gen, dev, torch.float32))
        _matvec_row(state, "q8_matvec_q80",
                    lambda i: q8._launch_q80(xq, sx, *ws[i % copies], BF16),
                    lambda i: q8.q8_matvec_q80_plain(xq, sx, *ws[i % copies]),
                    wbytes + k + k // 32 * 4 + n * 2, n, k, rate, "q8_matvec_kernel", "int8")
        del ws
        wbytes = n * k // 2 + n * k // 32 * 2
        copies = max(1, min(16, math.ceil(2 * L2_BYTES / wbytes)))
        ws = [_random_i4p(n, k, gen, dev) for _ in range(copies)]
        _matvec_row(state, "q4_matvec_q80",
                    lambda i: mv._launch_q80(xq, sx, *ws[i % copies], BF16),
                    lambda i: mv.q4_matvec_q80_plain(xq, sx, *ws[i % copies]),
                    wbytes + k + k // 32 * 4 + n * 2, n, k, rate, "q4_matvec_kernel", "int8")
        del ws
    state["launches"]["q8_matvec_precise"] = q8.precise_launches
    _matvec_token_sums(state["mv"])

    # kernels 10 and 11 — quantize_q80 bit-exact (xq and sx equal); rmsnorm_q80 at most 4
    # xq values one step off (its sum of squares runs in another order than torch.mean)
    # and sx within rtol 1e-6. max_abs_err is taken on the dequantized rows xq·sx, and
    # the tolerance is one quantization step of the widest block. The path's shapes
    # (K = 4096 and 11008) make the rows; 14336 and 65536, where the row spans several
    # CTAs, are checked and logged only. Device time with the card synchronized after
    # each call: back to back, a programmatic launch starts while the one before runs,
    # and its time would include that wait.
    fill = torch.zeros(1, device=dev)
    empty_ms = event_ms(lambda i: fill.fill_(0.0), 200)
    cases = [("rmsnorm_q80", 4096, dt) for dt in (torch.float32, torch.bfloat16)]
    cases += [("quantize_q80", k, dt) for k in (4096, 11008)
              for dt in (torch.float32, torch.bfloat16)]
    wide = [(name, k, dt) for name in ("rmsnorm_q80", "quantize_q80")
            for k in (14336, 65536) for dt in (torch.float32, torch.bfloat16)]
    for name, k, dtype in cases + wide:
        norm = name == "rmsnorm_q80"
        xs = [_test_row(k, gen, dev, dtype) * 3.0 for _ in range(4)]
        w = 1.0 + 0.1 * torch.randn(k, generator=gen, device=dev) if norm else None
        kern, plain_fn = _prologue_fns(xs, w)
        flips, sx_rel, err, tol = _prologue_check(name, k, dtype, kern, plain_fn)
        ev = event_ms(kern, 200)
        dv = _synced_time(kern, 50, ("prologue_kernel",))
        plain = _all_kernels_ms(plain_fn, 20)
        nbytes = k * xs[0].element_size() + (4 * k if norm else 0) + k + k // 32 * 4
        bnd = bound(nbytes, (5 if norm else 3) * k, "f32", rate)
        on_path = (name, k, dtype) in cases
        log(f"[kernels] {name} K={k} x {str(dtype)[6:]}: {flips} xq flips over 4 rows, sx "
            f"rel err {sx_rel:.2e}, max|err| of xq·sx {err:.3e} (tol {tol:.3e}) device "
            f"{round(dv, 5)} ms, events back to back {ev:.5f} ms (a 1-element "
            f"torch fill: {empty_ms:.5f} ms), plain {plain:.3f} ms, bound "
            f"{bnd[0]:.6f} ms ({bnd[1]})" + ("" if on_path else
                                             " (no path's shape: not in the kernels line)"))
        if on_path:
            _record(state, name, err, tol, dv, plain, bnd, None,
                    f"K={k},{str(dtype)[6:]},{flips} flips")
    for fmt in ("Q40", "Q80"):
        _layer_chain(fmt, gen, dev, rate)
        torch.cuda.empty_cache()


# the expert matmuls of a Mixtral-8x7B decode token as (N, K): moe_gu and moe_down
SHAPES_MIXTRAL = ((28672, 4096), (4096, 14336))
# grok1_l2's: moe_gu and moe_down
SHAPES_GROK_EXPERTS = ((65536, 6144), (6144, 32768))
# the moe phase's 2-D projections the 7B shapes do not cover: Mixtral's wqkv (its wo and
# wcls are the 7B shapes), grok1_l2's wqkv, wo and wcls
SHAPES_MOE_2D = ((6144, 4096), (8192, 6144), (6144, 6144), (131072, 6144))


def _kernels_moe(state: dict, gen, dev, rate: float) -> None:
    """The moe phase's kernels at its own shapes against their plain versions: the 2-D
    q4_matvec (and q8_matvec at Mixtral's wqkv, the Q80 run's) at the projections the 7B
    rows do not cover, q4_matmul at M = 8 and 64 (the prefill chunks) at every
    projection of the two models' that is not a 7B shape, and the expert entries."""
    from distributed_llama_tpu_torch.ops import q4_matvec as mv
    from distributed_llama_tpu_torch.ops import q8_matvec as q8

    for n, k in SHAPES_MOE_2D:
        wbytes = n * k // 2 + n * k // 32 * 2
        copies = max(1, min(16, math.ceil(2 * L2_BYTES / wbytes)))
        ws = [_random_i4p(n, k, gen, dev) for _ in range(copies)]
        x = _test_row(k, gen, dev, BF16)
        _matvec_row(state, "q4_matvec", lambda i: mv._launch(x, *ws[i % copies], BF16),
                    lambda i: mv.q4_matvec_plain(x, *ws[i % copies]),
                    wbytes + k * 2 + n * 2, n, k, rate, "q4_matvec_kernel", "bfloat16")
        del ws
    n, k = SHAPES_MOE_2D[0]
    wbytes = n * k + n * k // 32 * 4
    copies = max(1, min(16, math.ceil(2 * L2_BYTES / wbytes)))
    ws = [_random_i8(gen, dev, n, k) for _ in range(copies)]
    x = _test_row(k, gen, dev, BF16)
    _matvec_row(state, "q8_matvec", lambda i: q8._launch(x, *ws[i % copies], False, BF16),
                lambda i: q8.q8_matvec_plain(x, *ws[i % copies]),
                wbytes + k * 2 + n * 2, n, k, rate, "q8_matvec_kernel", "bfloat16")
    del ws
    for m in (8, 64):
        for n, k in SHAPES_MOE_2D[:1] + SHAPES_MIXTRAL + SHAPES_MOE_2D[1:] + \
                SHAPES_GROK_EXPERTS:
            _q4_matmul_row(state, m, n, k, gen, dev, rate)
        torch.cuda.empty_cache()
    _kernels_experts(state, gen, dev, rate)


def _kernels_experts(state: dict, gen, dev, rate: float) -> None:
    """The expert entries of the decode matvecs at Mixtral-8x7B's expert shapes (q4 and
    q8) and grok1_l2's (q4), bf16 row and output as the moe phase calls them: one
    layer's stack of 8 experts, the call i reading expert i % 8 from its device index
    (the stack is 2x past the L2, so each call streams its expert from device memory),
    against the plain version on the same expert (`_matvec_row`: tolerance, one launch
    per call, bound); and beside it the 2-D entry on the same expert's planes, the time
    the index read and the offset may add to."""
    from distributed_llama_tpu_torch.ops import q4_matvec as mv
    from distributed_llama_tpu_torch.ops import q8_matvec as q8

    n_e = 8
    es = [torch.tensor([e], dtype=torch.int64, device=dev) for e in range(n_e)]
    per_token = {}
    cases = [("q4", s, "Mixtral-8x7B") for s in SHAPES_MIXTRAL]
    cases += [("q8", s, "Mixtral-8x7B") for s in SHAPES_MIXTRAL]
    cases += [("q4", s, "grok1_l2") for s in SHAPES_GROK_EXPERTS]
    for fmt, (n, k), model in cases:
        name = f"{fmt}_matvec_expert"
        if fmt == "q4":
            wbytes = n * k // 2 + n * k // 32 * 2
            w, sc = _random_i4p(n_e * n, k, gen, dev)
            w, sc = w.reshape(n_e, n, k // 2), sc.reshape(n_e, n, k // 32)
            launch, plain, two_d = mv._launch, mv.q4_matvec_expert_plain, mv._launch
            kname = "q4_matvec_kernel"
        else:
            wbytes = n * k + n * k // 32 * 4
            w, sc = _random_i8(gen, dev, n_e, n, k)
            launch, plain, two_d = q8._launch, q8.q8_matvec_expert_plain, q8._launch
            kname = "q8_matvec_kernel"
        x = _test_row(k, gen, dev, BF16)
        kw = {} if fmt == "q4" else {"precise": False}
        _matvec_row(state, name,
                    lambda i: launch(x, w, sc, out_dtype=BF16, e=es[i % n_e], **kw),
                    lambda i: plain(x, w, sc, es[i % n_e]),
                    wbytes + k * 2 + n * 2, n, k, rate, kname, "bfloat16")
        y2 = two_d(x, w[3], sc[3], out_dtype=BF16, **kw)
        ye = launch(x, w, sc, out_dtype=BF16, e=es[3], **kw)
        if not torch.equal(y2, ye):
            raise AssertionError(f"{name} N={n} K={k}: expert 3 differs from the 2-D "
                                 f"entry on its planes")
        _, dv2, how2, _ = _one_launch_time(
            lambda i: two_d(x, w[i % n_e], sc[i % n_e], out_dtype=BF16, **kw), 50, kname)
        dv = state["mv"][(name, n, k, "bfloat16")][0]
        log(f"[kernels] {name} N={n} K={k}: the 2-D entry on the same experts' planes "
            f"{round(dv2, 5)} ms ({how2}); the expert entry {round(dv, 5)} ms, "
            f"{dv - dv2:+.5f} ms for the index read; expert 3 bit-identical to the 2-D "
            f"entry on its planes")
        # a decode token: 2 experts in each layer, each once through gu and once
        # through down (Mixtral-8x7B 32 layers, grok1_l2 2)
        calls = 2 * (32 if model == "Mixtral-8x7B" else 2)
        acc = per_token.setdefault((name, model, calls), [0.0, 0.0, 0.0])
        for j, v in enumerate((dv, dv2, state["mv"][(name, n, k, "bfloat16")][1])):
            acc[j] += calls * v
        del w, sc
    for (name, model, calls), (dv, dv2, bnd) in per_token.items():
        log(f"[kernels] {name} per {model} decode token ({calls} gu + {calls} down "
            f"calls): {dv:.3f} ms, the 2-D entry {dv2:.3f} ms, bound {bnd:.3f} ms")


def _synced_time(fn, iters: int, names: tuple[str, ...]) -> float:
    """Device ms per call of the kernels named, the card synchronized after each call so
    no launch overlaps the one before; where the profiler lost every window, their time
    back to back (`device_time`)."""
    dv, _ = device_profile(lambda i: (fn(i), torch.cuda.synchronize()), iters, names,
                           per_call=1)
    if dv is None:
        dv, src = device_time(fn, iters, names)
        log(f"[kernels] {'/'.join(names)}: synchronized calls lost their records in "
            f"every window; timed back to back ({src})")
    return dv


def _prologue_fns(xs: list, w, eps: float = 1e-5):
    """The prologue kernel on row i % len(xs) (rmsnorm_q80 with the norm weight w, else
    quantize_q80), and its plain version."""
    from distributed_llama_tpu_torch.ops import prologue as pro

    n = len(xs)
    if w is None:
        return (lambda i: pro._launch(xs[i % n], None, 0.0),
                lambda i: pro.quantize_q80_plain(xs[i % n]))
    return (lambda i: pro._launch(xs[i % n], w, eps),
            lambda i: pro.rmsnorm_q80_plain(xs[i % n], w, eps))


def _prologue_check(name: str, k: int, dtype, kern, plain_fn, rows: int = 4,
                    flip_budget: int = 4) -> tuple[int, float, float, float]:
    """Hold the prologue kern(i) against plain_fn(i) on `rows` rows: quantize_q80 bit
    for bit, rmsnorm_q80 at most `flip_budget` xq values one step off and sx within rtol
    1e-6. Returns the flips, sx's relative error, max|xq·sx - plain| and one
    quantization step of the widest block."""
    flips, sx_rel, err, tol = 0, 0.0, 0.0, 0.0
    for i in range(rows):
        (xq, sx), (pq, ps) = kern(i), plain_fn(i)
        d = (xq.int() - pq.int()).abs()
        flips += int((d > 0).sum())
        if int(d.max()) > 1:
            raise AssertionError(f"{name} K={k}: an xq value {int(d.max())} steps off")
        sx_rel = max(sx_rel, ((sx - ps).abs() / ps.abs().clamp_min(1e-30)).max().item())
        xhat = xq.float().reshape(-1, 32) * sx[:, None]
        phat = pq.float().reshape(-1, 32) * ps[:, None]
        err = max(err, (xhat - phat).abs().max().item())
        tol = max(tol, ps.max().item())
    exact = name == "quantize_q80"
    if (exact and (flips or sx_rel)) or flips > flip_budget or sx_rel > 1e-6:
        raise AssertionError(f"{name} K={k} {dtype}: {flips} xq flips, sx rel err "
                             f"{sx_rel:.2e} over {rows} rows")
    return flips, sx_rel, err, tol


# One Llama-2-7B layer's four prologue -> pre-quantized matvec pairs, in path order:
# (prologue, N, K) — rmsnorm_q80 -> wqkv, quantize_q80 -> wo, rmsnorm_q80 -> w13,
# quantize_q80 (K = 11008) -> w2. Rows are bf16 and outputs bf16, as on the path.
LAYER_PAIRS = (("rmsnorm_q80", 12288, 4096), ("quantize_q80", 4096, 4096),
               ("rmsnorm_q80", 22016, 4096), ("quantize_q80", 4096, 11008))
# the prologue's visible cost per layer (chain - matvecs alone, us) the redesign aims at
CHAIN_AIM_US = 4.0


def _layer_chain(fmt: str, gen, dev, rate: float) -> None:
    """The four pairs of LAYER_PAIRS on Q40 (q4_matvec_q80) or Q80 (q8_matvec_q80)
    weights, layer copies rotated past the L2: the outputs of the same calls with
    torch.cuda.synchronize() between them bit-identical to the chain queued behind a
    spin kernel (the card runs it back to back, its programmatic launches early; the
    row blocks it takes hold other rows' bits, so a matvec that read its row before the
    prologue wrote it would differ), to the matvecs alone and to a CUDA graph of the
    chain replayed; the chain's device time per layer (queued events), the four
    matvecs alone on rows quantized beforehand, the graph's replay, and the chain's
    byte bound. (tests/test_torch_cuda.py also forces the matvec resident while its
    prologue waits, and holds deliberately broken matvecs to that check.)"""
    from distributed_llama_tpu_torch.ops import prologue as pro
    from distributed_llama_tpu_torch.ops import q4_matvec as mv
    from distributed_llama_tpu_torch.ops import q8_matvec as q8

    if fmt == "Q40":
        launch, draw = mv._launch_q80, lambda n, k: _random_i4p(n, k, gen, dev)
        wbytes = [n * k // 2 + n * k // 32 * 2 for _, n, k in LAYER_PAIRS]
    else:
        launch, draw = q8._launch_q80, lambda n, k: _random_i8(gen, dev, n, k)
        wbytes = [n * k + n * k // 32 * 4 for _, n, k in LAYER_PAIRS]
    copies = max(2, math.ceil(2 * L2_BYTES / sum(wbytes)))
    layers = [[draw(n, k) for _, n, k in LAYER_PAIRS] for _ in range(copies)]
    norm_w = [1.0 + 0.1 * torch.randn(k, generator=gen, device=dev)
              if name == "rmsnorm_q80" else None for name, _, k in LAYER_PAIRS]
    rows, others = ([(_test_row(k, gen, dev, BF16) * 3.0, w)
                     for (_, _, k), w in zip(LAYER_PAIRS, norm_w)] for _ in range(2))
    eps = 1e-5

    def chain(i, sync=False, xs=rows):
        out = []
        for (x, w), wt in zip(xs, layers[i % copies]):
            xq, sx = pro._launch(x, w, eps)
            if sync:
                torch.cuda.synchronize()
            out.append(launch(xq, sx, *wt, BF16))
            if sync:
                torch.cuda.synchronize()
        return out

    quantized = [pro._launch(x, w, eps) for x, w in rows]

    def alone(i):
        return [launch(xq, sx, *wt, BF16) for (xq, sx), wt in zip(quantized,
                                                                   layers[i % copies])]

    synced = chain(0, True)
    chain(0, True, others)  # the xq/sx blocks the queued chain takes now hold others'
    torch.cuda._sleep(int(0.05 * SPIN_HZ))
    queued = chain(0)
    end = torch.cuda.Event()
    end.record()
    if end.query():
        raise AssertionError(f"{fmt} layer chain: the spin ended before the chain was queued")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = chain(0)
    graph.replay()
    torch.cuda.synchronize()
    for what, ys in (("queued behind a spin kernel", queued),
                     ("as the matvecs alone on the rows quantized beforehand", alone(0)),
                     ("replayed from a CUDA graph", captured)):
        if not all(torch.equal(a, b) for a, b in zip(synced, ys)):
            raise AssertionError(f"{fmt} layer chain: the outputs of the synchronized calls "
                                 f"differ from the chain {what}")
    graph_ms, _ = queued_ms(lambda i: graph.replay(), 20)
    chain_ms, c1 = queued_ms(chain, 20)
    alone_ms, c2 = queued_ms(alone, 20)

    # the four matvecs each on its own, the card synchronized after each call (as on a
    # host-bound path, where no kernel waits queued behind another): profiled device time
    def isolated(i):
        for (xq, sx), wt in zip(quantized, layers[i % copies]):
            launch(xq, sx, *wt, BF16)
            torch.cuda.synchronize()

    kname = "q4_matvec_kernel" if fmt == "Q40" else "q8_matvec_kernel"
    iso_ms = device_profile(isolated, 10, (kname,), per_call=4)[0]
    del graph, captured
    nbytes = 0
    for (name, n, k), wb in zip(LAYER_PAIRS, wbytes):
        nbytes += k * 2 + (4 * k if name == "rmsnorm_q80" else 0) + k + k // 32 * 4
        nbytes += wb + k + k // 32 * 4 + n * 2
    t = {"chain": chain_ms * 1e3, "alone": alone_ms * 1e3, "graph": graph_ms * 1e3,
         "isolated": math.nan if iso_ms is None else iso_ms * 1e3,
         "bound": nbytes / rate * 1e6}
    gaps = "" if c1 and c2 else " (host gaps included)"
    log(f"[kernels] {fmt} layer chain (4 prologue -> {launch.__module__.split('.')[-1]}"
        f"_q80 pairs, bf16 rows and outputs): {t['chain']:.2f} us per layer queued, "
        f"matvecs alone {t['alone']:.2f} us (each synchronized: {t['isolated']:.2f} us), "
        f"the prologue's visible cost {t['chain'] - t['alone']:.2f} us (aim "
        f"{CHAIN_AIM_US}), CUDA graph replay {t['graph']:.2f} us, bound {t['bound']:.2f} "
        f"us (bytes){gaps}; the synchronized calls' outputs bit-identical to the queued "
        f"chain, the matvecs alone and the graph's replay")


def _random_i4p_params(spec, dev, seed: int, gate_pair: bool = False, lo: int = 0,
                       to=None):
    """Llama params with random Q40 weights drawn on `dev` directly in the i4p layout
    the kernels take, from a seeded torch.Generator: wqkv, wo, w2, wcls, and either the
    merged w13 (the single-sequence Engine) or the separate w1/w3 of the gate-pair
    kernel (`gate_pair`, the fused serving engine). `lo` as `_random_i4p`'s: nibbles
    from 1..15 have no bias toward one sign (0..15 centre on -0.5). With `to`, each
    tensor moves there as soon as it is drawn: the same weights, and `dev` never holds
    more than one of them."""
    from distributed_llama_tpu_torch.quants import FloatType, QTensor

    gen = torch.Generator(device=dev).manual_seed(seed)
    L, d, h = spec.n_layers, spec.dim, spec.hidden_dim
    out = dev if to is None else torch.device(to)

    def q40(*shape):
        packed, scales = _random_i4p(shape[-2], shape[-1], gen, dev, shape[:-2], lo)
        return QTensor(FloatType.Q40, packed.to(out), scales.to(out), layout="i4p")

    def norm(*shape):
        return (1.0 + 0.02 * torch.randn(*shape, generator=gen, device=dev)).to(out)

    blocks = {"wqkv": q40(L, d + 2 * spec.kv_dim, d), "wo": q40(L, d, d)}
    if gate_pair:
        blocks.update(w1=q40(L, h, d), w3=q40(L, h, d))
    else:
        blocks["w13"] = q40(L, 2 * h, d)
    blocks.update(w2=q40(L, d, h), rms_att=norm(L, d), rms_ffn=norm(L, d))
    emb = (0.02 * torch.randn(spec.vocab_size, d, generator=gen, device=dev)).to(out)
    return {"embedding": emb, "blocks": blocks, "rms_final": norm(d),
            "wcls": q40(spec.vocab_size, d)}


def _random_i8_params(spec, dev, seed: int):
    """Llama params with random Q80 weights drawn on `dev` directly in the i8 layout the
    q8 kernel takes (`_random_i8`), from a seeded torch.Generator: wqkv, wo, w13, w2 and
    wcls."""
    from distributed_llama_tpu_torch.quants import FloatType, QTensor

    gen = torch.Generator(device=dev).manual_seed(seed)
    L, d, h = spec.n_layers, spec.dim, spec.hidden_dim

    def q80(*shape):
        return QTensor(FloatType.Q80, *_random_i8(gen, dev, *shape), layout="i8")

    def norm(*shape):
        return 1.0 + 0.02 * torch.randn(*shape, generator=gen, device=dev)

    blocks = {"wqkv": q80(L, d + 2 * spec.kv_dim, d), "wo": q80(L, d, d),
              "w13": q80(L, 2 * h, d), "w2": q80(L, d, h), "rms_att": norm(L, d),
              "rms_ffn": norm(L, d)}
    return {"embedding": 0.02 * torch.randn(spec.vocab_size, d, generator=gen, device=dev),
            "blocks": blocks, "rms_final": norm(d), "wcls": q80(spec.vocab_size, d)}


def _first_layer(params):
    """Params cut to their first layer: every block tensor's leading layer axis."""
    from distributed_llama_tpu_torch.quants import QTensor

    def cut(t):
        if isinstance(t, QTensor):
            return QTensor(t.ftype, t.data[:1], None if t.scales is None else t.scales[:1],
                           t.layout, t.groups, t.row_groups)
        return t[:1]
    return dict(params, blocks={k: cut(v) for k, v in params["blocks"].items()})


def _random_moe_params(spec, dev, seed: int, fmt: str = "q40"):
    """Mixtral or Grok-1 params with random weights drawn on `dev` directly in the
    kernels' layouts, one layer at a time (the transient is one layer's), from a seeded
    torch.Generator: wqkv, wo, the merged [up | gate] expert stack moe_gu and moe_down,
    and wcls in i4p (fmt "q40") or i8 ("q80"); the router planar in the same type (the
    forward pass dequantizes it, as the JAX package runs it); the norms (and Grok-1's
    rms_moe and rms_ffn2).

    Two choices keep the routing alive over 32 layers of random weights. The embedding
    has unit scale after Grok-1's multiplier, as a projection of a unit-RMS row has: at
    0.02 (the 7B draws) a token's own row is lost under the first attention output, and
    each decode step feeds the next layers nearly the same row, so greedy decoding
    repeats one token and every layer but the first picks one pair of experts for good
    (this script's moe phase on the card, with the 7B draws). Q40
    nibbles come from 1..15, so a weight (q - 8)·d is symmetric about zero as a
    quantized trained weight is; uniform over 0..15 they have mean -0.5·d, a component
    every output row shares."""
    from distributed_llama_tpu_torch.models.forward import GROK_EMBEDDING_SCALE
    from distributed_llama_tpu_torch.models.spec import ArchType
    from distributed_llama_tpu_torch.quants import FloatType, QTensor

    gen = torch.Generator(device=dev).manual_seed(seed)
    L, d, h, e = spec.n_layers, spec.dim, spec.hidden_dim, spec.n_experts
    q40 = fmt == "q40"
    ft = FloatType.Q40 if q40 else FloatType.Q80

    def draw(shape):  # one (..., N, K) block of weights in the kernel layout
        if q40:
            return _random_i4p(shape[-2], shape[-1], gen, dev, shape[:-2], lo=1)
        return _random_i8(gen, dev, *shape)

    def layered(*shape):  # (L, ..., N, K), drawn layer by layer
        first = draw(shape[1:])
        data = torch.empty((L, *first[0].shape), dtype=first[0].dtype, device=dev)
        scales = torch.empty((L, *first[1].shape), dtype=first[1].dtype, device=dev)
        data[0], scales[0] = first
        del first
        for li in range(1, L):
            data[li], scales[li] = draw(shape[1:])
        return QTensor(ft, data, scales, layout="i4p" if q40 else "i8")

    def norm(*shape):
        return 1.0 + 0.02 * torch.randn(*shape, generator=gen, device=dev)

    # the router as the file holds it: planar blocks of the weights' type
    data, scales = draw((L, e, d))
    router = QTensor(ft, data.reshape(L, e, d // 32, -1), scales.half())
    blocks = {"wqkv": layered(L, d + 2 * spec.kv_dim, d), "wo": layered(L, d, d),
              "router": router, "moe_gu": layered(L, e, 2 * h, d),
              "moe_down": layered(L, e, d, h), "rms_att": norm(L, d), "rms_ffn": norm(L, d)}
    if spec.arch_type == ArchType.GROK1:
        blocks.update(rms_moe=norm(L, d), rms_ffn2=norm(L, d))
    wcls = QTensor(ft, *draw((spec.vocab_size, d)), layout="i4p" if q40 else "i8")
    emb = 1.0 / GROK_EMBEDDING_SCALE if spec.arch_type == ArchType.GROK1 else 1.0
    return {"embedding": emb * torch.randn(spec.vocab_size, d, generator=gen, device=dev),
            "blocks": blocks, "rms_final": norm(d), "wcls": wcls}


def _param_bytes(params) -> int:
    """Bytes of every tensor of a params dict."""
    from distributed_llama_tpu_torch.quants import QTensor

    leaves = [*params["blocks"].values(), params["wcls"], params["embedding"],
              params["rms_final"]]
    return sum(t.nbytes() if isinstance(t, QTensor) else t.nbytes for t in leaves)


def _mixtral_8x7b(n_layers: int = 32):
    """Mixtral-8x7B (the repo's mixtral_8x7b configuration at its full 32 layers)."""
    from distributed_llama_tpu_torch.models.spec import ArchType, ModelSpec, RopeType

    return ModelSpec(arch_type=ArchType.MIXTRAL, dim=4096, hidden_dim=14336,
                     n_layers=n_layers, n_heads=32, n_kv_heads=8, vocab_size=32000,
                     seq_len=2048, n_experts=8, n_active_experts=2,
                     rope_type=RopeType.FALCON).resolved()


def _grok1(n_layers: int = 2):
    """Grok-1's block at full width (the repo's grok1_l2 configuration)."""
    from distributed_llama_tpu_torch.models.spec import (ArchType, HiddenAct, ModelSpec,
                                                         RopeType)

    return ModelSpec(arch_type=ArchType.GROK1, dim=6144, hidden_dim=32768,
                     n_layers=n_layers, n_heads=48, n_kv_heads=8, vocab_size=131072,
                     seq_len=2048, n_experts=8, n_active_experts=2,
                     hidden_act=HiddenAct.GELU, rope_type=RopeType.FALCON).resolved()


def _llama2_7b(n_layers: int = 32):
    from distributed_llama_tpu_torch.models.spec import ArchType, ModelSpec

    return ModelSpec(arch_type=ArchType.LLAMA, dim=4096, hidden_dim=11008,
                     n_layers=n_layers, n_heads=32, n_kv_heads=32, vocab_size=32000,
                     seq_len=2048).resolved()


class _CheckedSampler:
    """Greedy sampling that asserts every logits row it sees is finite, optionally
    keeping a copy of each row. With `force` it returns force[j] at its j-th row
    instead of its own choice (another run's tokens, so two runs decode the same
    sequence). With `mark` it keeps mark()'s value at each row (where a recorder of the
    forward pass's calls stood when the row was sampled)."""

    def __init__(self, vocab_size: int, keep: bool = False, force: list | None = None,
                 mark=None):
        from distributed_llama_tpu_torch.runtime.sampler import Sampler

        self.inner = Sampler(vocab_size, temperature=0.0)
        self.rows = 0
        self.kept: list[np.ndarray] = [] if keep else None
        self.force = force
        self.mark, self.marks = mark, []

    def sample(self, logits: np.ndarray) -> int:
        if not np.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        self.rows += 1
        if self.mark is not None:
            self.marks.append(self.mark())
        if self.kept is not None:
            self.kept.append(np.array(logits, dtype=np.float32))
        tok = self.inner.sample(logits)
        return tok if self.force is None else self.force[self.rows - 1]


def staggered(be, prompts, max_tokens: int, after: int, keep: bool = False,
              force: list | None = None, mark=None):
    """Submit prompts[0]; submit prompts[i+1] from request i's token callback once it
    has `after` tokens, so every engine sees the same schedule (prefill chunks with
    decode rows riding them, then batched decode steps). force[i], where given, are the
    tokens request i's sampler returns. Returns (requests, samplers) after all
    finished; raises the first request error."""
    vocab = be.spec.vocab_size
    reqs, samplers = [None] * len(prompts), [None] * len(prompts)

    def submit(i):
        n = [0]

        def on_token(_tok):
            n[0] += 1
            if n[0] == after and i + 1 < len(prompts):
                submit(i + 1)
        samplers[i] = _CheckedSampler(vocab, keep, None if force is None else force[i],
                                      mark)
        reqs[i] = be.submit(prompts[i], max_tokens, samplers[i], on_token=on_token)
    submit(0)
    reqs[0].wait(timeout=900)
    for i, r in enumerate(reqs):
        if r is None:
            raise AssertionError(f"request {i} was never submitted")
        r.wait(timeout=900)
    return reqs, samplers


class _ExactSums:
    """While open, the Q40 matmul family's plain versions on the CPU sum in f64: each
    output is the exact sum of the same bf16 products, rounded once to f32 (what no
    f32 accumulation order can improve on). A third evaluation of the same function,
    for the near-ties of `serving_parity`."""

    def __enter__(self):
        from distributed_llama_tpu_torch.ops import q4_gated_matmul as gm
        from distributed_llama_tpu_torch.ops import q4_matmul as mm

        def exact(x, packed, scales):
            w = mm.dequant_bf16(packed, scales).double()
            return (x.to(torch.bfloat16).double() @ w.T).float()
        self._orig = [(mod, mod.q4_matmul_plain) for mod in (mm, gm)]
        for mod, _ in self._orig:
            mod.q4_matmul_plain = exact
        return self

    def __exit__(self, *exc):
        for mod, fn in self._orig:
            mod.q4_matmul_plain = fn


class _SharedDequant:
    """While open, the bf16 decode of Q40 planes on the CPU (`q4_matmul.dequant_bf16`,
    under the plain versions of the dequant-matmul family) runs once per weight and is
    kept, beside a reference to the planes so that their storage is not reused: the
    parities' CPU runs read the same weights in every chunk and dispatch. The decode is
    a pure function of the planes, so every result is bit-identical to an uncached
    run's."""

    def __enter__(self):
        from distributed_llama_tpu_torch.ops import q4_matmul as mm

        self._mm, self._fn, cache = mm, mm.dequant_bf16, {}

        def dequant(packed, scales):
            if packed.device.type != "cpu":
                return self._fn(packed, scales)
            key = (packed.data_ptr(), packed.shape, packed.stride(), scales.data_ptr(),
                   scales.shape, scales.stride())
            if key not in cache:
                cache[key] = (packed, scales, self._fn(packed, scales))
            return cache[key][2]
        mm.dequant_bf16 = dequant
        return self

    def __exit__(self, *exc):
        self._mm.dequant_bf16 = self._fn


def serving_parity(n_layers: int = 2, max_tokens: int = 6, spec=None,
                   prompt_lens=(8, 12, 4, 19), crossing_tol: bool = False,
                   after: int = 2, fed: bool = False, params=None) -> str:
    """The fused BatchEngine at full Llama-2-7B width (or `spec`'s) in f32 with seeded
    weights: the card with the kernels against the CPU with their plain versions, on 4
    staggered requests (prompts of `prompt_lens` tokens), the card decoding the CPU's
    tokens. At every step the logits must be within 2e-3·max|logits| (as the Engine
    parity: sum order, and an activation whose last bits differ can move one bf16
    rounding of an operand) — with crossing_tol, `engine_parity`'s rule: 2e-2·max|logits|
    once an activation value has rounded differently in the two runs' calls up to that
    row — and the card's greedy token the CPU's, unless the CPU's logits of the two lie
    closer than that tolerance: a near-tie the check cannot order. Each near-tie is then
    held against a third run, the CPU with every matmul summed exactly (`_ExactSums`),
    which must put the two tokens within the tolerance too; the report says which one
    it picks. Request i+1 arrives at request i's `after`-th token. With crossing_tol the
    report gives where the first value rounded differently and the router choices that
    differ; with `fed` (crossing_tol too) another card run takes the CPU run's operands
    at every kernel call, as `engine_parity`'s, and its logits must be within
    2e-3·max|logits| at every row. `params` (CPU tensors) replace the seeded draw."""
    from distributed_llama_tpu_torch.models.params import params_to
    from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine

    spec = spec or _llama2_7b(n_layers=n_layers)
    if params is None:  # CPU tensors: the gate-pair layout the fused engine takes
        params = _random_i4p_params(spec, torch.device("cpu"), seed=8, gate_pair=True)
    kw = dict(slots=4, dtype=torch.float32, use_kernels=True, fused_matmul=True)
    rng = np.random.RandomState(4)
    prompts = [[1] + rng.randint(3, spec.vocab_size, n).tolist() for n in prompt_lens]
    # the BatchEngine at superstep 1 runs its steps eagerly, so the recorder can copy
    # each call's rows to the host
    rec = _Crossings() if crossing_tol else None
    mark = (lambda: len(rec.calls)) if rec else None

    def run(dev, force=None):
        be = BatchEngine(spec, params_to(params, dev), device=dev, **kw)
        assert be.engine.use_kernels == "fused" and be.engine.paged_kernel
        try:
            return staggered(be, prompts, max_tokens, after=after, keep=True,
                             force=force, mark=mark)
        finally:
            be.close()

    fed_report = ""
    try:
        rc, sc = run("cpu")
        calls_c, routes_c = (rec.take(), rec.take_routes()) if rec else ([], [])
        tokens = [r.out for r in rc]
        rg, sg = run("cuda", force=tokens)
        calls_g, routes_g = (rec.take(), rec.take_routes()) if rec else ([], [])
        if fed:
            rec.feed = calls_c
            try:
                _, sf = run("cuda", force=tokens)
            finally:
                rec.feed = None
                rec.take()
            fed_worst = 0.0
            for i in range(len(prompts)):
                for step, (lf, lc) in enumerate(zip(sf[i].kept, sc[i].kept)):
                    err, tol = float(np.abs(lf - lc).max()), 2e-3 * float(np.abs(lc).max())
                    fed_worst = max(fed_worst, err / tol)
                    if err > tol:
                        raise AssertionError(f"fed serving parity: request {i} step {step}:"
                                             f" max|Δlogits| {err:.3e} > {tol:.3e} on the "
                                             f"CPU's operands")
            fed_report = (f"; fed the CPU's operands at every kernel call: logits worst "
                          f"max|Δ|/(2e-3·max) {fed_worst:.3f}, each kernel's worst error / "
                          f"its tolerance " + json.dumps(
                              {k: round(v, 4) for k, v in rec.fed_worst.items()}))
    finally:
        if rec:
            rec.close()
    crossed_at: dict[int, int] = {}  # the calls before a row -> values rounded differently

    def crossed(i, step) -> int:
        if rec is None:
            return 0
        n = sc[i].marks[step]
        if sg[i].marks[step] != n:
            raise AssertionError(f"serving parity: request {i} step {step} came after "
                                 f"{sg[i].marks[step]} calls on the card, {n} on the CPU")
        if n not in crossed_at:
            crossed_at[n] = _Crossings.count(calls_c[:n], calls_g[:n])
        return crossed_at[n]

    worst, steps, ties = 0.0, 0, []
    for i in range(len(prompts)):
        if rg[i].out != tokens[i] or len(sg[i].kept) != len(sc[i].kept):
            raise AssertionError(f"serving parity: request {i} decoded {rg[i].out} on the "
                                 f"card, not the CPU's {tokens[i]}")
        for step, (lg, lc) in enumerate(zip(sg[i].kept, sc[i].kept)):
            err = float(np.abs(lg - lc).max())
            tol = (2e-2 if crossed(i, step) else 2e-3) * float(np.abs(lc).max())
            worst = max(worst, err / tol)
            steps += 1
            if err > tol:
                raise AssertionError(f"serving parity: request {i} step {step}: "
                                     f"max|Δlogits| {err:.3e} > {tol:.3e} ({crossed(i, step)} "
                                     f"values rounded differently)")
            tg, tc = int(np.argmax(lg)), int(np.argmax(lc))
            if tg != tc:
                gap = float(lc[tc] - lc[tg])
                if gap >= tol:
                    raise AssertionError(
                        f"serving parity: request {i} greedy tokens differ at step {step}: "
                        f"card {tg}, CPU {tc}, {gap:.3e} apart in the CPU's logits "
                        f"(tolerance {tol:.3e})")
                ties.append((i, step, tc, tg, gap, tol))
    report = (f"BatchEngine fused, 4 staggered requests x {max_tokens} greedy tokens: "
              f"tokens identical {tokens}")
    if rec:
        flips, pairs = _Crossings.route_flips(routes_c, routes_g)
        report += (f"; {max(crossed_at.values(), default=0)} activation values rounded "
                   f"differently (first at {_Crossings.first(calls_c, calls_g)}); router "
                   f"choices differing {flips} of {pairs} token-layer pairs{fed_report}")
    if ties:
        with _ExactSums():
            _, sw = run("cpu", force=tokens)
        seen = []
        for i, step, tc, tg, gap, tol in ties:
            lw, lc, lg = sw[i].kept[step], sc[i].kept[step], sg[i].kept[step]
            gw = abs(float(lw[tc] - lw[tg]))
            if gw >= tol:
                raise AssertionError(f"serving parity: request {i} step {step}: exact sums "
                                     f"put tokens {tc} and {tg} {gw:.3e} apart, no near-tie "
                                     f"(tol {tol:.3e})")
            tw = int(np.argmax(lw))
            side = "the CPU's" if tw == tc else "the card's" if tw == tg else f"{tw}"
            seen.append(f"request {i} step {step}: CPU {tc}, card {tg}, {gap:.2e} apart "
                        f"(tol {tol:.2e}); exact sums {gw:.2e} apart, pick {side}, lie "
                        f"{float(np.abs(lw - lc).max()):.2e} from the CPU's logits and "
                        f"{float(np.abs(lw - lg).max()):.2e} from the card's")
        report += (f" outside {len(ties)} near-tie(s), where the card decoded the CPU's "
                   f"token: " + "; ".join(seen))
    torch.cuda.empty_cache()
    return (f"{report}; {steps} logits rows, worst max|Δlogits|/tol {worst:.3f}")


class _Crossings:
    """Counts the activation values whose rounding differs between two runs of the
    same step: the Q80 codes of every quantized row (the prologue's outputs, and the
    rows the float matvec entries quantize inside their kernels) and the bf16 operands
    of the M > 1 dequant-matmul. Installed around the forward pass's calls, it records
    each call's row and output on the host, and the experts each MoE router chose
    (`take_routes`), then restores the originals on close().

    Fed (`feed` set to another run's calls, in the same order): each float-row matvec
    and dequant-matmul call takes that run's input (and residual) in place of its own,
    and its output is held against that run's output for the call — within
    1e-4·max|y| for the matvecs (`_matvec_row`'s rule) and 1e-3·max|y| for the
    dequant-matmul (tests/test_torch_cuda.py's): every kernel of the path at its own
    shapes and operands, without the propagation of earlier roundings. `fed_worst`
    keeps each kernel's worst error over its tolerance."""

    FED_TOL = {"row": 1e-4, "bf16": 1e-3}

    def __init__(self):
        from distributed_llama_tpu_torch.models import forward as fw
        from distributed_llama_tpu_torch.ops import matmul as mt

        self.calls: list[tuple] = []  # (kind, row (M, K), output, name, residual)
        self.routes: list[torch.Tensor] = []
        self.feed: list | None = None
        self.fed_worst: dict[str, float] = {}
        self._orig = []

        def wrap(mod, name, kind, quantizes):
            fn = getattr(mod, name)
            self._orig.append((mod, name, fn))

            def rec(*a, **kw):
                ref = None
                if self.feed is not None and not quantizes:
                    a, kw, ref = self._fed(name, a, kw)
                out = fn(*a, **kw)
                row = (out[0] if quantizes else a[0]).detach().float().cpu()
                y = None if quantizes else out.detach().float().cpu()
                if ref is not None:
                    self._hold(name, kind, y, ref[2])
                res = kw.get("residual")
                self.calls.append((kind, row.reshape(-1, row.shape[-1]), y, name,
                                   None if res is None else res.detach().float().cpu()))
                return out
            setattr(mod, name, rec)

        wrap(fw, "rmsnorm_quantize_q80", "q80", True)
        wrap(fw, "quantize_q80_row", "q80", True)
        wrap(mt, "q4_matvec", "row", False)
        wrap(mt, "q8_matvec", "row", False)
        wrap(mt, "q4_matvec_expert", "row", False)
        wrap(mt, "q8_matvec_expert", "row", False)
        wrap(mt, "q4_matmul", "bf16", False)
        route = fw._route
        self._orig.append((fw, "_route", route))

        def routed(xb, bp, spec):
            top_i, w = route(xb, bp, spec)
            self.routes.append(top_i.detach().cpu())
            return top_i, w
        fw._route = routed

    def _fed(self, name, a, kw):
        """The call's arguments with the fed run's input (and residual) for this call."""
        i = len(self.calls)
        if i >= len(self.feed) or self.feed[i][3] != name:
            raise AssertionError(f"fed parity: call {i} is {name}, the fed run's "
                                 f"{self.feed[i][3] if i < len(self.feed) else 'none'}")
        x, r = a[0], kw.get("residual")
        a = (self.feed[i][1].reshape(x.shape).to(x.device, x.dtype), *a[1:])
        if r is not None:
            kw = {**kw, "residual": self.feed[i][4].reshape(r.shape).to(r.device, r.dtype)}
        return a, kw, self.feed[i]

    def _hold(self, name, kind, y, ref) -> None:
        tol = self.FED_TOL[kind] * float(ref.abs().max())
        err = float((y - ref).abs().max())
        self.fed_worst[name] = max(self.fed_worst.get(name, 0.0), err / tol)
        if not err <= tol:
            raise AssertionError(f"fed parity: {name} call {len(self.calls)} "
                                 f"{tuple(ref.shape)}: max|err| {err:.3e} > {tol:.3e} on "
                                 f"the fed run's operands")

    def take(self) -> list:
        out, self.calls = self.calls, []
        return out

    def take_routes(self) -> list:
        out, self.routes = self.routes, []
        return out

    @staticmethod
    def route_flips(a: list, b: list) -> tuple[int, int]:
        """Token-layer pairs whose chosen expert set differs between two runs' routes,
        and the pairs."""
        n = sum(int((torch.sort(ra, -1)[0] != torch.sort(rb, -1)[0]).any(-1).sum())
                for ra, rb in zip(a, b))
        return n, sum(r[..., 0].numel() for r in a)

    @staticmethod
    def per_call(a: list, b: list) -> list[int]:
        """The values rounded differently in each call of two runs of the same step."""
        from distributed_llama_tpu_torch.ops.q4_matvec import quantize_row

        if [c[0] for c in a] != [c[0] for c in b]:
            raise AssertionError("parity: the two runs took different kernel routes")
        out = []
        for (kind, xa, *_), (_, xb, *_) in zip(a, b):
            if kind == "q80":
                out.append(int((xa != xb).sum()))
            elif kind == "row":
                out.append(int((quantize_row(xa[0])[0] != quantize_row(xb[0])[0]).sum()))
            else:
                out.append(int((xa.to(torch.bfloat16) != xb.to(torch.bfloat16)).sum()))
        return out

    @staticmethod
    def count(a: list, b: list) -> int:
        return sum(_Crossings.per_call(a, b))

    @staticmethod
    def first(a: list, b: list) -> str:
        """Where the first value rounded differently: the call, its kernel and rows."""
        for i, n in enumerate(_Crossings.per_call(a, b)):
            if n:
                return f"call {i} of {len(a)} ({a[i][3]}, {tuple(a[i][1].shape)}): {n}"
        return "none"

    def close(self) -> None:
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)


def engine_parity(spec, params, crossing_tol: bool = False, steps: int = 8,
                  fed: bool = False, **kw) -> str:
    """The Engine on the card with the kernels against the CPU with their plain versions
    on the same weights (CPU tensors), f32: a 9-token prompt and `steps` greedy steps. Greedy
    tokens must be identical at every step, and the logits within 2e-3·max|logits|
    (kernels and plain versions differ in sum order). With crossing_tol, the rule of
    tests/test_torch_cuda.py::test_engine_kernels_match_cpu_plain: 2e-3·max|logits| while
    no activation value has rounded differently in the two runs, 2e-2·max|logits| once
    one has — one Q80 code one step off moves the next rows' codes and the logits with
    them (on the Q80 weights here, a single attention-output code one step off in layer 1
    moved the logits by 7e-3·max, card and CPU alike).

    With `fed`, a second card run takes the CPU run's operands at every kernel call
    (`_Crossings` fed): each call's output is held to the CPU's for that call, and the
    logits to 2e-3·max|logits| at every step, so what rounded differently in the first
    run is shown to be the cause of any excess over 2e-3. The report also gives where the
    first value rounded differently and the router choices (token-layer pairs) that
    differ between the card's and the CPU's first runs."""
    from distributed_llama_tpu_torch.models.params import params_to
    from distributed_llama_tpu_torch.runtime.engine import Engine

    kw = dict(dtype=torch.float32, use_kernels=True, **kw)

    # eager steps: _Crossings copies each row to the host, which a graph capture cannot
    # hold (the model and q80 phases hold the replay to the eager step bit for bit)
    def card():
        return Engine(spec, params_to(params, "cuda"), device="cuda", cuda_graph=False, **kw)
    gpu = card()
    cpu = Engine(spec, params, device="cpu", **kw)
    prompt = [1] + [int(t) for t in np.random.RandomState(3).randint(3, 32000, 8)]
    rec = _Crossings()
    cpu_steps = []  # (chunk, the CPU's calls, the CPU's logits) of every step
    try:
        lg, cg, rg = gpu.prefill(prompt), rec.take(), rec.take_routes()
        lc, cc, rc = cpu.prefill(prompt), rec.take(), rec.take_routes()
        worst, crossed, first, flips, pairs = 0.0, 0, None, 0, 0
        toks_g, toks_c, chunk = [], [], prompt
        for step in range(steps + 1):
            crossed += rec.count(cg, cc)
            if first is None and crossed:
                first = f"step {step}, " + rec.first(cc, cg)
            f, p = rec.route_flips(rg, rc)
            flips, pairs = flips + f, pairs + p
            cpu_steps.append((chunk, cc, lc))
            err = float(np.abs(lg - lc).max())
            tol = (2e-2 if crossed and crossing_tol else 2e-3) * float(np.abs(lc).max())
            worst = max(worst, err / tol)
            if err > tol or not np.isfinite(lg).all():
                raise AssertionError(f"parity step {step}: max|Δlogits| {err:.3e} > "
                                     f"{tol:.3e} ({crossed} values rounded differently; "
                                     f"{flips} router choices differ)")
            if step == steps:
                break
            tg, tc = int(np.argmax(lg)), int(np.argmax(lc))
            toks_g.append(tg)
            toks_c.append(tc)
            if tg != tc:
                raise AssertionError(f"parity: greedy tokens diverge at step {step}: "
                                     f"{toks_g} vs {toks_c}")
            chunk = [tc]
            lg, cg, rg = gpu.infer_chunk(chunk), rec.take(), rec.take_routes()
            lc, cc, rc = cpu.infer_chunk(chunk), rec.take(), rec.take_routes()
        routes = (f"; router choices differing {flips} of {pairs} token-layer pairs"
                  if pairs else "")
        report = (f"prefill {len(prompt)} tokens + {steps} greedy steps, tokens identical "
                  f"{toks_g}; {crossed} activation values rounded differently (first at "
                  f"{first or 'none'}){routes}; worst max|Δlogits|/tol {worst:.3f}")
        if fed:
            del gpu
            torch.cuda.empty_cache()
            gpu, fed_worst = card(), 0.0
            for step, (chunk, cc, lc) in enumerate(cpu_steps):
                rec.feed = cc
                lf = gpu.prefill(chunk) if step == 0 else gpu.infer_chunk(chunk)
                rec.feed = None
                rec.take()
                err, tol = float(np.abs(lf - lc).max()), 2e-3 * float(np.abs(lc).max())
                fed_worst = max(fed_worst, err / tol)
                if err > tol:
                    raise AssertionError(f"fed parity step {step}: max|Δlogits| {err:.3e} "
                                         f"> {tol:.3e} on the CPU's operands")
            report += (f"; fed the CPU's operands at every kernel call: logits worst "
                       f"max|Δ|/(2e-3·max) {fed_worst:.3f}, each kernel's worst error / "
                       f"its tolerance " + json.dumps(
                           {k: round(v, 4) for k, v in rec.fed_worst.items()}))
    finally:
        rec.close()
    del gpu
    torch.cuda.empty_cache()
    return report


def phase_parity(state: dict) -> None:
    from distributed_llama_tpu_torch.ops import prologue as pro
    from distributed_llama_tpu_torch.ops import q4_matvec as mv
    from distributed_llama_tpu_torch.ops import q8_matvec as q8

    spec = _llama2_7b(n_layers=2)
    cpu = torch.device("cpu")
    q40 = _random_i4p_params(spec, cpu, seed=7)
    with _SharedDequant():
        log(f"[parity] 2-layer Llama-2-7B width, f32, Q40: "
            f"{engine_parity(spec, q40, prefill_kernel=True)}")
        for label, params, counter in (("Q40", q40, lambda: mv.q80_launches),
                                       ("Q80", _random_i8_params(spec, cpu, seed=9),
                                        lambda: q8.q80_launches)):
            before = (counter(), pro.rmsnorm_launches, pro.quantize_launches)
            report = engine_parity(spec, params, crossing_tol=True, prefill_kernel=True,
                                   fused_prologue=True)
            after = (counter(), pro.rmsnorm_launches, pro.quantize_launches)
            if not all(a > b for a, b in zip(after, before)):
                raise AssertionError(f"parity {label} prologue: kernels not launched "
                                     f"{before} -> {after}")
            log(f"[parity] 2-layer Llama-2-7B width, f32, {label} with the fused prologue: "
                f"{report}")
        log(f"[parity] 2-layer Llama-2-7B width, f32: {serving_parity()}")
        p8 = _random_i4p_params(spec, cpu, seed=8, gate_pair=True, lo=1)
        for label, check in (("constrained", constrain_parity), ("the drafter",
                                                                  drafter_parity)):
            t0 = time.perf_counter()
            report = check(p8)
            log(f"[parity] 2-layer Llama-2-7B width, f32, {label}: {report} "
                f"({time.perf_counter() - t0:.1f} s)")


def phase_model(state: dict) -> None:
    spec = _llama2_7b()
    params = _random_i4p_params(spec, torch.device("cuda"), seed=11)
    per_step = 4 * spec.n_layers + 1
    # T=1 steps (the 4 one-token prefill chunks and the decode steps) replay the step's
    # graph; the M > 1 chunks (64, 8 x4) run q4_matmul eagerly
    launches = _decode_path(state, "model", spec, params, 64,
                            dict(prefill_kernel=True, fused_prologue=False),
                            {"q4_matvec": per_step, "decode_attention": spec.n_layers},
                            {"q4_matmul": per_step})
    for name in ("q4_matvec", "q4_matmul", "decode_attention"):
        state["launches"][name] = launches[name]
    # the fused prologue on the same weights: rmsnorm_q80 and quantize_q80 twice per
    # layer and the pre-quantized matvec on the four projections; the logits keep the
    # float entry
    launches = _decode_path(state, "model, prologue", spec, params, 32,
                            dict(prefill_kernel=True, fused_prologue=True),
                            {"q4_matvec": 1, "q4_matvec_q80": 4 * spec.n_layers,
                             "decode_attention": spec.n_layers,
                             "rmsnorm_q80": 2 * spec.n_layers,
                             "quantize_q80": 2 * spec.n_layers},
                            {"q4_matmul": per_step})
    state["launches"]["q4_matvec_q80"] = launches["q4_matvec_q80"]
    del params
    torch.cuda.empty_cache()


def _prompt_100(spec) -> list[int]:
    return [1] + torch.randint(3, spec.vocab_size, (99,),
                               generator=torch.Generator().manual_seed(5)).tolist()


def host_loop_tokens(eng, prompt: list[int], n: int, sampler=None) -> list[int]:
    """The host loop's greedy tokens after the device loop's prefill (the prompt but
    its last token in chunks, the last token as a one-token step), from position 0."""
    from distributed_llama_tpu_torch.runtime.engine import GenerationStats

    eng.reset()
    if len(prompt) > 1:
        eng.prefill(prompt[:-1])
    logits = eng.infer_chunk(prompt[-1:])
    return eng._decode(logits, n, sampler or _CheckedSampler(eng.spec.vocab_size),
                       GenerationStats())


# tokens of the eager-against-graph comparison and the device loop's chunk
COMPARE_TOKENS, LOOP_CHUNK = 16, 16


def _decode_path(state: dict, tag: str, spec, params, n: int, kw: dict, t1: dict,
                 chunked: dict, label: str = "Llama-2-7B") -> dict:
    """One single-sequence decode path of the model `label` names: the Engine (CUDA graphs on)
    on a 100-token prompt (chunks 64, 8 x4, 1 x4) and n greedy tokens, its launches held
    to `t1` per one-token step (graph replays times each graph's launches, read from
    its captures and its node dump) and `chunked` per M > 1 chunk; its decode step
    profiled. Then the eager step beside it (cuda_graph=False, same weights):
    COMPARE_TOKENS steps whose logits must equal the graph's bit for bit; and the device
    loop (generate_chunked, chunks of LOOP_CHUNK replays), whose greedy tokens must equal
    the host loop's after the same prefill. ms/token and the idle share of each; the
    programmatic edges of the step's graph. Returns the counted run's launches."""
    from distributed_llama_tpu_torch.runtime.engine import Engine
    from distributed_llama_tpu_torch.runtime.sampler import Sampler

    vocab = spec.vocab_size
    prompt = _prompt_100(spec)
    counters = _single_counters()
    eng = Engine(spec, params, device="cuda", **kw)
    eng.graphs = counting_graphs(eng.device, counters)
    assert eng.dtype == torch.bfloat16 and eng.cuda_graph
    eng.generate(prompt[:9], 2, _CheckedSampler(vocab))  # warm-up: builds, captures
    eng.reset()
    torch.cuda.synchronize()
    _zero(counters)
    snap = graph_snapshot(counters, eng.graphs)
    sampler = _CheckedSampler(vocab)
    out, stats = eng.generate(prompt, n, sampler)
    launches, replays, new = run_launches(counters, eng.graphs, snap)
    t1_steps, chunks = 4 + n, 5
    key = ("step", "logits", eng._window_for(len(prompt) + n), 1)
    want = {name: t1.get(name, 0) * (t1_steps + new) + chunked.get(name, 0) * chunks
            for name in counters}
    per_replay = {name: t1.get(name, 0) for name in counters}
    if (launches != want or replays != t1_steps or eng.graphs.per_step[key] != per_replay
            or len(out) != n or sampler.rows != n):
        raise AssertionError(f"{tag} run: launches {launches} (want {want}), {replays} "
                             f"replays of {t1_steps} steps, a step's graph "
                             f"{eng.graphs.per_step[key]}, {len(out)} tokens")
    fmt = "Q40" if "q4_matvec" in t1 else "Q80"
    log(f"[{tag}] {label} {fmt} bf16 ({spec.n_layers} layers, "
        f"random weights), CUDA graphs: prefill {stats.prompt_tokens} tokens "
        f"{stats.prefill_ms:.1f} ms, decode {stats.avg_infer_ms:.2f} ms/token (step), "
        f"{stats.tokens_per_second:.2f} tok/s; weights "
        f"{eng.decode_weight_bytes / 1e9:.3f} GB/token -> "
        f"{eng.decode_weight_bytes / (stats.avg_infer_ms * 1e-3) / 1e9:.0f} GB/s; floor "
        f"{eng.decode_weight_bytes / state['rate'] * 1e3:.3f} ms/token at the data-sheet "
        f"rate")
    log(f"[{tag}] launches in the run: {json.dumps(launches)} = per one-token step "
        f"{json.dumps({k: v for k, v in t1.items()})} x {t1_steps} ({replays} graph "
        f"replays of {eng.graphs.nodes[key]} nodes, {new} captured in the run) + per "
        f"chunk {json.dumps(chunked)} x {chunks}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    pdl = ""
    if kw.get("fused_prologue"):
        prog, edges = programmatic_edges(eng.graphs.graph(key))
        pdl = f"; the step's graph keeps {prog} programmatic edges of {edges}"
        log(f"[{tag}] programmatic (PDL) edges in the captured step: {prog} of {edges} "
            f"edges ({prog / spec.n_layers:.0f} per layer)")
    busy_g, wall_g = _profile_decode(eng, out[-1], stats.avg_infer_ms, tag=tag)

    eager = Engine(spec, params, device="cuda", cuda_graph=False, **kw)
    eager.generate(prompt[:9], 2, _CheckedSampler(vocab))
    runs = []
    for e in (eng, eager):
        e.reset()
        smp = _CheckedSampler(vocab, keep=True)
        o, st = e.generate(prompt, COMPARE_TOKENS, smp)
        runs.append((o, smp.kept, st))
    (og, lg, _), (oe, le, se) = runs
    if og != oe or not all(np.array_equal(a, b) for a, b in zip(lg, le)):
        raise AssertionError(f"{tag}: the graph's logits differ from the eager step's")
    busy_e, wall_e = _profile_decode(eager, oe[-1], se.avg_infer_ms, tag=f"{tag}, eager")
    del eager

    host = host_loop_tokens(eng, prompt, n)
    eng.reset()
    loop_out, lst = eng.generate_chunked(prompt, n, Sampler(vocab, 0.0), chunk=LOOP_CHUNK)
    if loop_out != host:
        raise AssertionError(f"{tag}: the device loop's tokens {loop_out} differ from the "
                             f"host loop's {host}")
    busy_l, loop_ms = _profile_loop(eng, loop_out[-1])
    log(f"[{tag}] ms/token (idle share): eager {se.avg_infer_ms:.3f} "
        f"({1 - busy_e / wall_e:.3f}), CUDA graph {stats.avg_infer_ms:.3f} "
        f"({1 - busy_g / wall_g:.3f}), device loop of {LOOP_CHUNK} {loop_ms:.3f} "
        f"({1 - busy_l / loop_ms:.3f}; its first {n} tokens, the loop's capture included, "
        f"{np.mean(lst.token_ms):.3f}); busy per token eager {busy_e:.3f}, graph "
        f"{busy_g:.3f}, loop {busy_l:.3f} ms; {COMPARE_TOKENS} steps' logits bit-identical "
        f"graph and eager; the loop's {n} greedy tokens the host loop's{pdl}")
    state.setdefault("decode", {})[tag] = dict(
        eager_ms=se.avg_infer_ms, graph_ms=stats.avg_infer_ms, loop_ms=loop_ms,
        busy_eager=busy_e, busy_graph=busy_g, busy_loop=busy_l)
    del eng
    torch.cuda.empty_cache()
    return launches


def _profile_loop(eng, token: int, calls: int = 3) -> tuple[float, float]:
    """Device busy and wall ms per token of the device loop: one chunk of LOOP_CHUNK
    replays from the engine's position and its fence, timed `calls` times without the
    profiler, then once under it (the writes past the position are the same each
    time)."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_llama_tpu_torch.runtime.device_loop import prng_key, split
    from distributed_llama_tpu_torch.runtime.step_graph import copy_to_host

    loop = eng._decode_loop(LOOP_CHUNK, "greedy", eng._window_for(eng.pos + LOOP_CHUNK))
    key = split(prng_key(0))[1].tolist()

    def chunk():
        toks = loop(eng.rope, token, eng.k_cache, eng.v_cache, eng.pos, key, 0.0, 0.9)[0]
        copy_to_host(toks)()
    chunk()
    t0 = time.perf_counter()
    for _ in range(calls):
        chunk()
    wall = (time.perf_counter() - t0) * 1e3 / calls / LOOP_CHUNK
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chunk()
    return _device_union_ms(prof) / LOOP_CHUNK, wall


def _single_counters():
    """Launch counters of the single-sequence decode kernels: name -> (module, attr)."""
    from distributed_llama_tpu_torch.ops import decode_attention as da
    from distributed_llama_tpu_torch.ops import prologue as pro
    from distributed_llama_tpu_torch.ops import q4_matmul as mm
    from distributed_llama_tpu_torch.ops import q4_matvec as mv
    from distributed_llama_tpu_torch.ops import q8_matvec as q8

    return {"q4_matvec": (mv, "launches"), "q4_matvec_q80": (mv, "q80_launches"),
            "q4_matvec_expert": (mv, "expert_launches"),
            "q8_matvec_expert": (q8, "expert_launches"),
            "q4_matmul": (mm, "launches"), "q8_matvec": (q8, "launches"),
            "q8_matvec_q80": (q8, "q80_launches"), "decode_attention": (da, "launches"),
            "rmsnorm_q80": (pro, "rmsnorm_launches"),
            "quantize_q80": (pro, "quantize_launches")}


def _zero(counters) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def _read(counters) -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


# the CUDA function each launch counter's kernel runs, as a graph's node dump names it
KERNEL_NODES = {"q4_matvec": "q4_matvec_kernel", "q4_matvec_q80": "q4_matvec_kernel",
                "q4_matvec_expert": "q4_matvec_kernel", "q8_matvec_expert": "q8_matvec_kernel",
                "q8_matvec": "q8_matvec_kernel", "q8_matvec_q80": "q8_matvec_kernel",
                "q4_matmul": "q4_matmul_tc_kernel", "q4_matmul_res": "q4_matmul_tc_kernel",
                "q4_gated_matmul": "q4_gated_tc_kernel",
                "decode_attention": "decode_attn_kernel",
                "paged_attention": "paged_attn_kernel",
                "rmsnorm_q80": "prologue_kernel", "quantize_q80": "prologue_kernel"}


def counting_graphs(device, counters):
    """The engine's StepGraphs, keeping each captured graph and recording its kernel
    launches per replay. A wrapper counts once per call, and a capture calls each
    wrapper twice per launch of the step (its warm-up step, which launches, and the
    captured call, which adds a node): half of the counters' rise over a capture is the
    graph's launches, which must match the kernel nodes of its dump by function name. A
    replay calls no wrapper, so a run's launches are its counters' rise, less the
    captured calls, plus each graph's launches times its replays (`run_launches`)."""
    from distributed_llama_tpu_torch.runtime.step_graph import StepGraphs

    class CountingGraphs(StepGraphs):
        def __init__(self):
            super().__init__(device, True, keep=True)
            self.per_step: dict[tuple, dict[str, int]] = {}
            self.nodes: dict[tuple, int] = {}

        def _capture(self, key, step, carry):
            before = _read(counters)
            cap = super()._capture(key, step, carry)
            rise = {n: v - before[n] for n, v in _read(counters).items()}
            if any(v % 2 for v in rise.values()):
                raise AssertionError(f"graph {key}: odd counter rise {rise} over a capture")
            per = {n: v // 2 for n, v in rise.items()}
            nodes = _dot_nodes(_graph_dot(cap.graph))
            for fn in sorted({KERNEL_NODES[n] for n in per}):
                got = sum(fn in nd for nd in nodes)
                want = sum(c for n, c in per.items() if KERNEL_NODES[n] == fn)
                if got != want:
                    raise AssertionError(f"graph {key}: {got} {fn} nodes, {want} launches "
                                         f"captured")
            self.per_step[key], self.nodes[key] = per, len(nodes)
            return cap
    return CountingGraphs()


def graph_snapshot(counters, graphs) -> tuple:
    """The counters (zeroed just before a counted run) and each graph's replays."""
    return (_read(counters), {k: graphs.replays_of(k) for k in graphs.keys()})


def run_launches(counters, graphs, snap, more=()) -> tuple[dict, int, int]:
    """Each counted kernel's launches since `snap` (eager calls, warm-up steps and graph
    replays; see counting_graphs), the graph replays, and the graphs captured. `more`
    holds (graphs, snap) pairs of other engines run meanwhile: the counters are
    module-wide, each engine's graphs its own."""
    out = {n: v - snap[0][n] for n, v in _read(counters).items()}
    n_replays = n_new = 0
    for g, (_before, replays) in ((graphs, snap), *more):
        for key in g.keys():
            per = g.per_step[key]
            dr = g.replays_of(key) - replays.get(key, 0)
            new = key not in replays
            n_replays += dr
            n_new += new
            for n, c in per.items():
                out[n] += c * dr - (c if new else 0)
    return out, n_replays, n_new


# Q80 decode launches per T=1 step of Llama-2-7B: (a) the default engine — wqkv, wo,
# w13, w2 per layer and wcls through q8_matvec; (b) the fused prologue — the four
# projections through q8_matvec_q80, rmsnorm_q80 before wqkv and w13, quantize_q80
# before wo and w2, wcls through q8_matvec. Attention once per layer in both.
Q80_PER_STEP = {"q8_matvec": 129, "decode_attention": 32}
Q80_PROLOGUE_PER_STEP = {"q8_matvec": 1, "q8_matvec_q80": 128, "decode_attention": 32,
                         "rmsnorm_q80": 64, "quantize_q80": 64}


def phase_q80(state: dict) -> None:
    spec = _llama2_7b()
    torch.cuda.reset_peak_memory_stats()
    params = _random_i8_params(spec, torch.device("cuda"), seed=17)
    for run, prologue, per_step in (("a", False, Q80_PER_STEP),
                                    ("b", True, Q80_PROLOGUE_PER_STEP)):
        # the M > 1 prefill chunks dequantize the i8 weights (the JAX package's route
        # too; no kernel computes it)
        launches = _decode_path(state, f"q80 ({run})", spec, params, 64,
                                dict(fused_prologue=prologue), per_step, {})
        if prologue:
            for name in ("q8_matvec_q80", "rmsnorm_q80", "quantize_q80"):
                state["launches"][name] = launches[name]
        else:
            state["launches"]["q8_matvec"] = launches["q8_matvec"]
    del params
    torch.cuda.empty_cache()


# device busy per single-sequence decode step of each profiled run while the steps ran
# eagerly, before they were captured (a full run, PERF.md §6), beside which each run
# reports its own
BUSY_BEFORE = {"model": 4.661, "model, prologue": 3.823, "q80 (a)": 5.845, "q80 (b)": 4.992}


def _device_union_ms(prof) -> float:
    """ms during which the card ran at least one of the profiled window's device
    activities: the union of their intervals. Kernels launched with programmatic stream
    serialization overlap their predecessors, and the profiler gives each its own
    duration, so their sum overstates the busy time."""
    from torch.autograd import DeviceType

    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA and ev.time_range.end > 0)
    total, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _device_gaps_ms(prof) -> tuple[list[float], dict[tuple[str, str], float]]:
    """The gaps (ms) between the profiled window's device activities, the stretches
    inside its span during which the card ran none of them, and their sum by the pair
    of activities around each (the one that ended last before it, the one after)."""
    from torch.autograd import DeviceType

    def short(name: str) -> str:
        name = re.sub(r"^void |\(anonymous namespace\)::|at::native::", "", name)
        return name.split("<")[0].split("(")[0][:40]

    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA and ev.time_range.end > 0)
    gaps, by_pair, end, last = [], {}, None, ""
    for a, b, name in spans:
        if end is not None and a > end:
            gaps.append((a - end) / 1e3)
            pair = (short(last), short(name))
            by_pair[pair] = by_pair.get(pair, 0.0) + gaps[-1]
        if end is None or b > end:
            end, last = b, name
    return gaps, by_pair


def _profile_decode(eng, token: int, counted_ms: float, steps: int = 8,
                    tag: str = "model") -> tuple[float, float]:
    """Where one decode step's time goes: device time by kernel name from torch.profiler
    over `steps` steps (after the counted run; kineto records the kernels of a graph
    replay one by one); busy is the union of the device intervals (`_device_union_ms`),
    beside their sum. The idle share is taken against step times measured without the
    profiler, whose hooks inflate the host clock: the same `steps` steps timed just
    before, and the counted run's mean step (`counted_ms`). Returns (busy, unprofiled
    step) ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.infer_chunk([token])  # each step ends on its logits' host copy
    plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.infer_chunk([token])
        profiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0) or getattr(
            ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3 / steps, ev.count // steps, ev.key[:60]))
    rows.sort(reverse=True)
    summed = sum(r[0] for r in rows)
    busy = _device_union_ms(prof) / steps
    if busy <= 0:
        raise AssertionError(f"[{tag}] the profiler recorded no device time")
    before = BUSY_BEFORE.get(tag)
    log(f"[{tag}] decode step: device busy {busy:.3f} ms (profiled, union of the kernels' "
        f"intervals; their sum {summed:.3f}"
        + (f"; eager before the graphs: {before:.3f}" if before else "")
        + "); step wall without "
        f"the profiler {plain_ms:.2f} ms ({steps} steps) and {counted_ms:.2f} ms (counted "
        f"run), with it {profiled_ms:.2f} ms; idle share {1 - busy / plain_ms:.3f} "
        f"({steps} steps), {1 - busy / counted_ms:.3f} (counted run)")
    for ms, n, key in rows[:8]:
        log(f"[{tag}]   {ms:.4f} ms/step in {n} launches/step: {key}")
    pro = [r for r in rows if "prologue_kernel" in r[2]]
    if pro:
        log(f"[{tag}]   prologue kernels: {sum(r[0] for r in pro):.4f} ms/step in "
            f"{sum(r[1] for r in pro)} launches/step")
    return busy, plain_ms


# prompt lengths of the serve phase's 8 requests (16-300 tokens, staggered arrivals)
SERVE_PROMPTS = (300, 16, 137, 64, 250, 33, 190, 90)
SERVE_TOKENS = 48
# kernel launches per batched dispatch of the 7B serving step (every dispatch has
# M = 8 slots x T > 1 rows): wqkv x 32 + wcls, wo + w2 x 32, the gate pair x 32,
# attention x 32
SERVE_PER_DISPATCH = {"q4_matmul": 33, "q4_matmul_res": 64, "q4_gated_matmul": 32,
                      "paged_attention": 32}


def _serve_counters():
    from distributed_llama_tpu_torch.ops import paged_attention as pa
    from distributed_llama_tpu_torch.ops import q4_gated_matmul as gm
    from distributed_llama_tpu_torch.ops import q4_matmul as mm

    return {"q4_matmul": (mm, "launches"), "q4_matmul_res": (mm, "res_launches"),
            "q4_gated_matmul": (gm, "launches"), "paged_attention": (pa, "launches")}


def _serve_engine(params, superstep: int, speculative: int = 0):
    """The 8-slot fused BatchEngine at full Llama-2-7B, super-steps of `superstep`
    (pipelined from 2), speculating `speculative` tokens a row, its graphs counted
    (`counting_graphs`)."""
    from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine

    spec = _llama2_7b()
    be = BatchEngine(spec, params, slots=8, device="cuda", fused_matmul=True,
                     kv_block_tokens=16, superstep=superstep, prefix_cache=False,
                     speculative=speculative)
    eng = be.engine
    eng.graphs = counting_graphs(eng.device, _serve_counters())
    assert eng.dtype == torch.bfloat16 and eng.use_kernels == "fused" and eng.paged_kernel
    assert be.kv_pool.n_blocks == 8 * (spec.seq_len // 16) + 8 + 1
    assert be.pipeline == (superstep >= 2) and be.spec_k == speculative
    # warm-up: loads the kernel libraries, warms the allocator and, from superstep 2,
    # captures a super-step's graph
    be.generate([1] + list(range(5, 80)), 2 + superstep, _CheckedSampler(spec.vocab_size))
    be.release_idle()
    return be


# the serve phase's super-step and the runs it compares: superstep 1 (host sampling
# every step) and the server's default, SERVE_K steps per dispatch, pipelined
SERVE_K = 8


def phase_serve(state: dict) -> None:
    spec = _llama2_7b()
    params = _random_i4p_params(spec, torch.device("cuda"), seed=13, gate_pair=True)
    state["serve_params"] = params  # the prefix phase runs on the same weights
    gen = torch.Generator().manual_seed(21)
    prompts = [[1] + torch.randint(3, spec.vocab_size, (n - 1,), generator=gen).tolist()
               for n in SERVE_PROMPTS]
    tokens = {}
    for k in (1, SERVE_K):
        torch.cuda.reset_peak_memory_stats()
        be = _serve_engine(params, k)
        tokens[k] = _serve_run(state, be, prompts, k)
        if k == 1:
            be.close()
            del be
            torch.cuda.empty_cache()
    if tokens[1] != tokens[SERVE_K]:
        diff = [i for i, (a, b) in enumerate(zip(tokens[1], tokens[SERVE_K])) if a != b]
        raise AssertionError(f"serve: superstep {SERVE_K} tokens differ from superstep 1 "
                             f"in requests {diff}")
    log(f"[serve] superstep {SERVE_K} pipelined: every request's {SERVE_TOKENS} greedy "
        f"tokens identical to superstep 1")
    if "http" in state["phases"]:
        state["serve_engine"] = be
    else:
        be.close()
        torch.cuda.empty_cache()


def _serve_run(state: dict, be, prompts, k: int) -> list[list[int]]:
    """The 8 staggered requests on one engine (request i+1 submitted at request i's
    first token: both engines then take the same mixed steps, and decode rows the same
    M = 8 kernels), launches against the schedule (SERVE_PER_DISPATCH per forward step:
    eager steps, super-step graph replays, and a warm-up step per capture), tok/s,
    TTFT and the decode step; returns each request's tokens."""
    spec = be.spec
    graphs = be.engine.graphs
    counters = _serve_counters()
    be.dispatches = be.decode_steps = be.mixed_steps = be.super_steps = 0
    be.loop_steps = be.chained = 0
    for times in be.dispatch_ms.values():
        times.clear()
    _zero(counters)
    snap = graph_snapshot(counters, graphs)
    t0 = time.perf_counter()
    reqs, samplers = staggered(be, prompts, SERVE_TOKENS, after=1)
    wall = time.perf_counter() - t0
    launches, replays, new = run_launches(counters, graphs, snap)
    eager_steps = be.dispatches - be.loop_steps // k
    steps = eager_steps + replays + new
    want = {name: n * steps for name, n in SERVE_PER_DISPATCH.items()}
    outs = [len(r.out) for r in reqs]
    if launches != want or outs != [SERVE_TOKENS] * len(prompts) or replays != be.loop_steps:
        raise AssertionError(f"serve run (superstep {k}): launches {launches} (want {want} "
                             f"for {eager_steps} eager steps, {replays} replays, {new} "
                             f"captures; {be.loop_steps} loop steps), tokens {outs}")
    host_sampled = sum(s.rows for s in samplers)
    if (k == 1 and host_sampled != sum(outs)) or host_sampled > sum(outs):
        raise AssertionError("serve run: a host-sampled token without its logits row")
    free = be.release_idle()
    if free != be.kv_pool.n_blocks - 1:
        raise AssertionError(f"serve run: {free} blocks free after the run, want "
                             f"{be.kv_pool.n_blocks - 1} (all but scratch)")
    if k == SERVE_K:
        state["launches"].update({n: v for n, v in launches.items() if n != "q4_matmul"})
    ttft = [(r.first_token_t - r.submit_t) * 1e3 for r in reqs]
    dec = be.dispatch_ms["decode"]
    sup = be.dispatch_ms["super"]
    tag = f"[serve] superstep {k}" + (", pipelined" if be.pipeline else "")
    log(f"{tag}: Llama-2-7B Q40 bf16 fused, 8 slots, paged KV {be.kv_pool.n_blocks} x 16 "
        f"tokens: {len(prompts)} staggered requests, prompts {list(SERVE_PROMPTS)}, "
        f"{SERVE_TOKENS} greedy tokens each, in {wall:.2f} s: {sum(outs) / wall:.1f} tok/s "
        f"aggregate; {be.dispatches} dispatches ({be.decode_steps - be.super_steps} "
        f"single decode, {be.super_steps} super-steps of {k} delivered, {be.chained} "
        f"chained, {dict(be.flushes)} flushed, {be.mixed_steps} mixed, "
        f"{len(be.dispatch_ms['prefill'])} prefill-only)")
    log(f"{tag}: time to first token mean {np.mean(ttft):.1f} ms, max {np.max(ttft):.1f} "
        f"ms; single decode dispatch {np.mean(dec) if dec else math.nan:.2f} ms mean over "
        f"{len(dec)}; super-step {np.mean(sup) if sup else math.nan:.2f} ms mean over "
        f"{len(sup)} ({np.mean(sup) / k if sup else math.nan:.3f} ms per step); mixed "
        f"dispatch {np.mean(be.dispatch_ms['mixed']):.2f} ms mean; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; pool drained to {free} "
        f"free blocks")
    log(f"{tag}: launches in the run: {json.dumps(launches)} = per forward step "
        f"{json.dumps(SERVE_PER_DISPATCH)} x {steps} ({eager_steps} eager, {replays} graph "
        f"replays, {new} warm-up steps of captures)")
    serve = state.setdefault("serve", {})
    serve[k] = dict(tok_s=sum(outs) / wall, ttft_mean=float(np.mean(ttft)),
                    ttft_max=float(np.max(ttft)))
    if k == 1:
        serve[k].update(_profile_serve_decode(be, np.mean(dec)))
        seeded = _profile_serve_decode(be, np.mean(dec), seeded=True)
        serve[k].update(seeded_busy=seeded["busy"], seeded_period=seeded["period"])
        _pick_paths(be.spec.vocab_size)
    else:
        serve[k].update(_profile_serve_superstep(be, k))
    return [r.out for r in reqs]


def _profile_serve_superstep(be, k: int, warm: int = 3, window: int = 4, submit=None,
                             tag: str = "[serve]") -> dict:
    """The pipelined super-step in steady state: the requests `submit()` returns (by
    default 8 requests of 8-token prompts) decode together; the first `warm` + 1 full
    deliveries (8 rows, K tokens each) are timed without the profiler (the step period:
    their spacing over K). Then the scheduler pauses after a delivery while
    this thread drains the card and starts the profiler, runs on through `window` full
    deliveries, and pauses again while the card drains and the profiler stops. Busy per
    step is the union of the recorded kernels' intervals over the steps they hold
    (paged_attention launches over the layers); the idle share is the rest of the
    period."""
    from torch.profiler import ProfilerActivity, profile

    marks: list[float] = []
    gates = [threading.Event() for _ in range(4)]  # at start, started, at end, stopped
    orig = be._deliver_super_step
    gc_ms = [0.0, 0, 0.0]  # ms in collections, full ones, start of the running one

    def gc_timed(phase, info):
        if phase == "start":
            gc_ms[2] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_ms[2]) * 1e3
            gc_ms[1] += info["generation"] == 2

    def wrapped(fl):
        status = orig(fl)
        if len(fl.rows) == be.slots_n and all(fl.budget[s.index] == k for s, _ in fl.rows):
            marks.append(time.perf_counter())
            if len(marks) == warm + 1:
                gates[0].set()
                gates[1].wait(300)
            elif len(marks) == warm + 1 + window:
                gates[2].set()
                gates[3].wait(300)
        return status

    be._deliver_super_step = wrapped
    chain0 = (be.chained, dict(be.flushes))
    gc.callbacks.append(gc_timed)
    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        reqs = submit() if submit else [
            be.submit([1] + list(range(100 + 10 * i, 107 + 10 * i)), k * (warm + window + 4),
                      _CheckedSampler(be.spec.vocab_size)) for i in range(8)]
        for start in (True, False):
            gate = gates[0 if start else 2]
            t0 = time.perf_counter()
            while not gate.wait(1.0):
                if all(r.done.is_set() for r in reqs) or time.perf_counter() - t0 > 900:
                    raise AssertionError(f"{tag} profile: only {len(marks)} full "
                                         f"super-steps")
            torch.cuda.synchronize()
            prof.start() if start else prof.stop()
            gates[1 if start else 3].set()
        for r in reqs:
            r.wait(timeout=900)
    finally:
        be._deliver_super_step = orig
        gc.callbacks.remove(gc_timed)
        for e in gates:
            e.set()
    be.release_idle()
    chained = be.chained - chain0[0]
    flushes = {r: n - chain0[1].get(r, 0) for r, n in be.flushes.items()
               if n != chain0[1].get(r, 0)}
    rows, attn = [], 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0) or getattr(
            ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key[:60]))
            if "paged_attn_kernel" in ev.key:
                attn += ev.count
    steps = attn / be.spec.n_layers
    if steps < (window - 1) * k:
        raise AssertionError(f"{tag} profile: {steps} steps recorded in the window")
    busy = _device_union_ms(prof) / steps
    gaps, by_pair = _device_gaps_ms(prof)
    pairs = sorted(by_pair.items(), key=lambda kv: -kv[1])[:4]
    span = (busy * steps + sum(gaps)) / steps
    big = [g for g in gaps if g > 0.25]
    period = (marks[warm] - marks[0]) / warm / k * 1e3
    # the full deliveries after the profiler stopped (the first one spans the pause)
    tail = marks[warm + window + 2:]
    after = (tail[-1] - tail[0]) / (len(tail) - 1) / k * 1e3 if len(tail) > 3 else math.nan
    rows.sort(reverse=True)
    log(f"{tag} superstep {k} step (8 rows): device busy {busy:.3f} ms (profiled over "
        f"{steps:.0f} replayed steps, union of the kernels' intervals); step period "
        f"without the profiler {period:.3f} ms ({warm} full super-steps); idle share "
        f"{1 - busy / period:.3f} of the period"
        + (f"; after the profiled window {after:.3f} ms ({len(tail) - 1} full "
           f"super-steps)" if len(tail) > 3 else ""))
    log(f"{tag} the profiled window spans {span:.3f} ms/step: idle {span - busy:.3f} "
        f"ms/step, of it {len(big)} gaps over 0.25 ms ({sum(big) / steps:.3f} ms/step; "
        f"largest {max(gaps, default=0.0):.3f} ms) in {steps / k:.0f} super-steps; "
        f"{chained} dispatches chained, flushed {flushes}; Python's "
        f"collector ran {gc_ms[0]:.1f} ms ({gc_ms[1]} full collections) in the run; the "
        f"idle by the kernels around it, ms/step: "
        + ", ".join(f"{a} -> {b} {ms / steps:.3f}" for (a, b), ms in pairs))
    for ms, n, key in rows[:8]:
        log(f"{tag}   {ms / steps:.4f} ms/step in {n / steps:.1f} launches/step: {key}")
    return dict(busy=busy, period=period, period_after=after, span=span, big_gaps=len(big),
                big_gap_ms=sum(big) / steps, chained=chained, gc_ms=gc_ms[0])


def _profile_serve_decode(be, counted_ms: float, steps: int = 8,
                          seeded: bool = False) -> dict:
    """Where one batched decode step's time goes: 8 requests decode together (greedy,
    or `seeded`: temperature 0.8, top-p 0.9, each its own seed); of the decode steps
    with all 8 rows active, `steps` are timed without the profiler and the next `steps`
    under it. The scheduler thread pauses at both edges of the
    profiled window while this thread starts and stops the profiler, so the window
    holds exactly those steps' device work. The idle share is the profiled device time
    against the unprofiled step period: the time from one decode step's start to the
    next one's, host sampling and scheduling included (a dispatch's own time,
    `dispatch_ms`, starts after its rows are sampled)."""
    from torch.profiler import ProfilerActivity, profile

    full: list[float] = []  # dispatch ms of full decode steps, in order
    starts: list[float] = []  # perf_counter at the start of each full decode step
    edges = [threading.Event() for _ in range(4)]  # at start, started, at end, stopped
    orig = be._decode_step

    def wrapped(active):
        track = len(active) == be.slots_n
        if track:
            starts.append(time.perf_counter())
        if track and len(full) == steps:
            edges[0].set()
            edges[1].wait(300)
        before = len(be.dispatch_ms["decode"])
        orig(active)
        if track and len(be.dispatch_ms["decode"]) > before:
            full.append(be.dispatch_ms["decode"][-1])
            if len(full) == 2 * steps:
                edges[2].set()
                edges[3].wait(300)

    be._decode_step = wrapped
    try:
        from distributed_llama_tpu_torch.runtime.sampler import Sampler

        prompts = [[1] + list(range(100 + 10 * i, 107 + 10 * i)) for i in range(8)]
        reqs = [be.submit(p, 8 + 3 * steps,
                          Sampler(be.spec.vocab_size, 0.8, 0.9, seed=17 + i) if seeded
                          else _CheckedSampler(be.spec.vocab_size))
                for i, p in enumerate(prompts)]
        prof = profile(activities=[ProfilerActivity.CUDA])
        if not edges[0].wait(900):
            raise AssertionError(f"serve profile: only {len(full)} full decode steps")
        prof.start()
        edges[1].set()
        if not edges[2].wait(900):
            raise AssertionError(f"serve profile: only {len(full)} full decode steps")
        torch.cuda.synchronize()
        prof.stop()
        edges[3].set()
        for r in reqs:
            r.wait(timeout=900)
    finally:
        be._decode_step = orig
        for e in edges:
            e.set()
    be.release_idle()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0) or getattr(
            ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3 / steps, ev.count // steps, ev.key[:60]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if len(full) < 2 * steps:
        raise AssertionError(f"serve profile: {len(full)} full decode steps timed")
    period = (starts[steps] - starts[0]) * 1e3 / steps
    dispatch = float(np.mean(full[:steps]))
    profiled = float(np.mean(full[steps:2 * steps]))
    rows_tag = "8 seeded rows" if seeded else "8 rows"
    log(f"[serve] superstep 1 step ({rows_tag}): device busy {busy:.3f} ms (profiled); "
        f"without the profiler, step period {period:.2f} ms and dispatch {dispatch:.2f} "
        f"ms ({steps} steps), dispatch {counted_ms:.2f} ms (counted run); dispatch with "
        f"the profiler {profiled:.2f} ms; idle share {1 - busy / period:.3f} of the period"
        f", {1 - busy / dispatch:.3f} of the dispatch ({steps} steps), "
        f"{1 - busy / counted_ms:.3f} of the dispatch (counted run)")
    for ms, n, key in rows[:10]:
        log(f"[serve]   {ms:.4f} ms/step in {n} launches/step: {key}")
    return dict(busy=busy, period=period)


def _pick_paths(vocab: int, rows: int = 8, iters: int = 20) -> None:
    """The host cost of picking a one-token step's seeded tokens on the card, at full
    vocabulary: one device_sample_coin call on the step's (rows, vocab) logits with one
    upload of the coins (the BatchEngine's one-token and prefill steps), against one
    call per row from the host copy of its logits (an upload of the row and three
    scalars, the call, a wait on its pick). Both pick the same tokens."""
    from distributed_llama_tpu_torch.runtime.device_loop import device_sample_coin

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    logits = (torch.randn(rows, vocab, generator=gen) * 3).to(dev)
    host = logits.cpu().numpy()
    u = torch.rand(rows, generator=gen).tolist()
    temps, topps = [0.8] * rows, [0.9] * rows

    def batched():
        vals = torch.tensor([u, temps, topps], dtype=torch.float32).to(dev)
        return device_sample_coin(logits, vals[0], vals[1], vals[2]).cpu().tolist()

    def per_row():
        return [int(device_sample_coin(
            torch.from_numpy(host[r:r + 1]).to(dev),
            torch.tensor([u[r]], dtype=torch.float32, device=dev),
            torch.tensor([temps[r]], dtype=torch.float32, device=dev),
            torch.tensor([topps[r]], dtype=torch.float32, device=dev))[0])
            for r in range(rows)]

    if batched() != per_row():
        raise AssertionError("serve: the batched device pick differs from the per-row "
                             "one")
    ms = {}
    for name, fn in (("batched", batched), ("per_row", per_row)) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms[name] = (time.perf_counter() - t0) * 1e3 / iters  # the later of two rounds
    log(f"[serve] seeded picks of {rows} rows x {vocab} on the card (host wall, {iters} "
        f"calls): one device_sample_coin call {ms['batched']:.3f} ms, one call per row "
        f"from the host copy {ms['per_row']:.3f} ms; same tokens")


def _synthetic_tokenizer(path: str, vocab_size: int) -> None:
    """A `.t` file of `vocab_size` pieces: <unk>, <s>, </s>, the 256 byte tokens, then
    synthetic word pieces."""
    from distributed_llama_tpu_torch.formats.tfile import TokenizerData, write_tokenizer

    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{i:02X}>".encode() for i in range(256)]
    vocab += [f" w{i}".encode() for i in range(vocab_size - len(vocab))]
    scores = [0.0] * 259 + [-1e-3 * i for i in range(vocab_size - 259)]
    write_tokenizer(path, TokenizerData(vocab=vocab, scores=scores, bos_id=1, eos_id=2,
                                        max_token_length=max(len(v) for v in vocab)))


def _http_post(url: str, body: dict):
    req = urllib.request.Request(url + "/v1/chat/completions", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def phase_http(state: dict) -> None:
    from distributed_llama_tpu_torch.apps.api_server import serve
    from distributed_llama_tpu_torch.runtime.sampler import Sampler
    from distributed_llama_tpu_torch.tokenizer import TemplateType, Tokenizer

    be = state.pop("serve_engine", None) or _serve_engine(
        _random_i4p_params(_llama2_7b(), torch.device("cuda"), seed=13, gate_pair=True),
        SERVE_K)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tpath = os.path.join(tmp, "synthetic.t")
            _synthetic_tokenizer(tpath, be.spec.vocab_size)
            be.tokenizer = Tokenizer.load(tpath)
        srv = serve(None, "127.0.0.1", 0, TemplateType.LLAMA2,
                    Sampler(be.spec.vocab_size, 0.0, 0.9, 1), batch_engine=be)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            with urllib.request.urlopen(url + "/v1/models", timeout=60) as r:
                models = json.loads(r.read())
            bodies = [{"messages": [{"role": "user", "content": f"hello w{i} w{7 * i}"}],
                       "max_tokens": 16, "temperature": 0, "seed": i,
                       "stream": i == 0} for i in range(4)]
            results: list = [None] * 4

            def call(i):
                try:
                    results[i] = _http_post(url, bodies[i])
                except Exception as e:  # noqa: BLE001 — reported below
                    results[i] = e
            threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(900)
            wall = time.perf_counter() - t0
        finally:
            srv.shutdown()
            srv.server_close()
        summary = []
        for i, res in enumerate(results):
            if not isinstance(res, tuple):
                raise AssertionError(f"http request {i} failed: {res!r}")
            status, ctype, raw = res
            if status != 200:
                raise AssertionError(f"http request {i}: status {status}")
            if bodies[i]["stream"]:
                events = [ln[6:] for ln in raw.split("\n") if ln.startswith("data: ")]
                if ctype != "text/event-stream" or events[-1] != "[DONE]":
                    raise AssertionError(f"http request {i}: malformed SSE {raw[-300:]!r}")
                chunks = [json.loads(e) for e in events[:-1]]
                finish = chunks[-1]["choices"][0]["finish_reason"]
                text = "".join(c["choices"][0]["delta"].get("content", "")
                               for c in chunks)
            else:
                payload = json.loads(raw)
                finish = payload["choices"][0]["finish_reason"]
                text = payload["choices"][0]["message"]["content"]
            if finish not in ("stop", "length"):
                raise AssertionError(f"http request {i}: finish_reason {finish!r}")
            summary.append(f"{'SSE' if bodies[i]['stream'] else 'JSON'} {finish} "
                           f"{len(text)} chars")
        log(f"[http] api_server on the 7B BatchEngine, synthetic 32000-piece tokenizer: "
            f"/v1/models {models['data'][0]['id']!r}; 4 concurrent chat completions in "
            f"{wall:.2f} s: {'; '.join(summary)}")
    finally:
        be.close()
        del be
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ the prefix phase

# the shared prefix P (32 blocks of 16, a multiple of the 64-token prefill chunk), the
# suffixes of the requests that hit it, and the tokens each generates
PREFIX_P = 512
PREFIX_SUFFIXES = (17, 24, 33, 40)
PREFIX_CONCURRENT = (17, 20, 24, 28, 31, 35, 38, 40)
PREFIX_TOKENS = 16
# part 2's tokens a hit: enough that every row still decodes after the slowest prefill
# for PREFIX_PERIOD_STEPS + PREFIX_PROFILED + 1 full super-steps (the cache-off run's
# first row rides ~100 mixed dispatches), and every position stays under 1024
PREFIX_CONCURRENT_TOKENS = 288
PREFIX_PERIOD_STEPS, PREFIX_PROFILED = 12, 4
# a near-tie: two greedy picks closer than this share of max|logits| in a run's logits
# (bf16 activations over 32 layers; the parity phase's f32 bound is 2e-3)
NEAR_TIE = 1e-2


class _CountDegraded:
    """While open, counts every prefix-cache degradation (`cache.warn_degraded`): on
    the card a broken promotion or copy-on-write must not pass as a cache miss."""

    def __enter__(self):
        from distributed_llama_tpu_torch import cache

        self._mod, self._fn, self.calls = cache, cache.warn_degraded, []

        def counted(what, exc):
            self.calls.append(f"{what}: {type(exc).__name__}: {exc}")
            self._fn(what, exc)
        cache.warn_degraded = counted
        return self

    def __exit__(self, *exc):
        self._mod.warn_degraded = self._fn


class _F64Dequant:
    """While open, the dequantize path's products (`matmul._qmatmul_dequant`) run in
    f64 on the card: the witness of a near-tie, a third evaluation of the same function
    that sums every product in f64."""

    def __enter__(self):
        from distributed_llama_tpu_torch.ops import matmul as mm

        def exact(x, w, *, out_dtype=None, residual=None):
            y = torch.matmul(x.double(), w.dequantize(dtype=torch.float64).transpose(-1, -2))
            if residual is not None:
                y = residual.double() + y
            return y.to(out_dtype or x.dtype)
        self._mm, self._fn = mm, mm._qmatmul_dequant
        mm._qmatmul_dequant = exact
        return self

    def __exit__(self, *exc):
        self._mm._qmatmul_dequant = self._fn


def _prefix_tokens(spec) -> dict:
    """The phase's prompts, from one seed. Leading tokens keep the slot choice fixed:
    P starts with 1, the primers with 2, the displacing requests with 3, so every
    request shares no token with another role's history and lands on the lowest free
    slot."""
    rng = np.random.RandomState(61)

    def toks(first: int, n: int) -> list[int]:
        return [first] + rng.randint(4, spec.vocab_size, n - 1).tolist()
    p = toks(1, PREFIX_P)
    return {"P": p, "sd": toks(4, 24)[1:] + [5], "R0": toks(2, 4), "R1": toks(2, 600),
            "W": toks(3, 1900), "Y": [toks(3, 20) for _ in range(8)],
            "hits": [p + toks(6, n)[1:] + [7] for n in PREFIX_SUFFIXES],
            "many": [p + toks(8, n)[1:] + [9] for n in PREFIX_CONCURRENT],
            "s3": toks(10, 30)[1:] + [11]}


def _prefix_engine(spec, params, slots: int, superstep: int, on: bool,
                   counted: bool = False, **kw):
    """The serve phase's BatchEngine with the cache on or off; with `counted` its graphs
    record their launches (`counting_graphs`)."""
    from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine

    be = BatchEngine(spec, params, slots=slots, device="cuda", fused_matmul=True,
                     kv_block_tokens=16, superstep=superstep, prefix_cache=on, **kw)
    assert be.engine.dtype == torch.bfloat16 and be.engine.paged_kernel
    if counted:
        be.engine.graphs = counting_graphs(be.engine.device, _serve_counters())
    return be


def _ask(be, prompt, n: int, keep: bool = False):
    """One request, waited for: (request, its sampler)."""
    smp = _CheckedSampler(be.spec.vocab_size, keep)
    req = be.submit(prompt, n, smp)
    req.wait(timeout=900)
    return req, smp


def _primers(be, t: dict) -> None:
    """R0 (4 tokens) then R1 (600) submitted back to back: R0 takes slot 0, R1 slot 1,
    where its history (608 tokens) stays parked, so every prefill chunk of P reads the
    1024-token window in both runs of a comparison."""
    reqs = [be.submit(t[k], 8, _CheckedSampler(be.spec.vocab_size)) for k in ("R0", "R1")]
    for r in reqs:
        r.wait(timeout=900)
    held = be._slots[1].history
    if not (PREFIX_P - 64 < len(held) <= 1024 - 64 and held[0] == 2):
        raise AssertionError(f"prefix: the long primer is not parked on slot 1 "
                             f"({len(held)} tokens)")


def _settle_cache(be) -> None:
    """Every lease released and the last harvest landed (the scheduler harvests inside
    the pass that holds _slock)."""
    t0 = time.perf_counter()
    while be.prefix_cache is not None and be.prefix_cache.total_refs():
        if time.perf_counter() - t0 > 60:
            raise AssertionError("prefix: leases still held 60 s after the last request")
        time.sleep(0.01)
    with be._slock:
        pass


def _drained(be, tag: str) -> int:
    _settle_cache(be)
    free = be.release_idle()
    if free != be.kv_pool.n_blocks - 1:
        raise AssertionError(f"prefix {tag}: {free} blocks free after the run, want "
                             f"{be.kv_pool.n_blocks - 1} (all but scratch)")
    return free


def _witness_logits(state: dict, spec, params, history: list[int]) -> np.ndarray:
    """The f64 witness: the single-sequence Engine on the dequantize path (f32
    activations, every product summed in f64) prefills `history`; its last logits row."""
    from distributed_llama_tpu_torch.runtime.engine import Engine

    eng = state.get("prefix_witness")
    if eng is None:
        eng = state["prefix_witness"] = Engine(spec, params, device="cuda",
                                               dtype=torch.float32, use_kernels=False,
                                               cuda_graph=False)
    eng.reset()
    with _F64Dequant():
        return eng.prefill(history)


def _witness(state: dict, spec, params, history: list[int], a: int, b: int
             ) -> tuple[float, float]:
    """(|logits[a] - logits[b]|, the near-tie bound) in the witness's last row."""
    logits = _witness_logits(state, spec, params, history)
    return abs(float(logits[a] - logits[b])), NEAR_TIE * float(np.abs(logits).max())


def _held(state, spec, params, tag: str, prompt, got: list[int], want: list[int],
          got_rows=None, want_rows=None) -> str:
    """Greedy tokens of two runs of one request under the near-tie rule: identical, or
    identical up to a step j where the runs' logits (where the host sampled them) and
    the f64 witness on the common history put the two picks within NEAR_TIE·max|logits|.
    Returns "" or a description of the near-tie."""
    if got == want:
        return ""
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if j is None:
        raise AssertionError(f"{tag}: {len(got)} tokens against {len(want)}")
    a, b = got[j], want[j]
    for rows in (got_rows, want_rows):
        if rows is not None and j < len(rows):
            gap, tol = abs(float(rows[j][a] - rows[j][b])), NEAR_TIE * float(
                np.abs(rows[j]).max())
            if gap >= tol:
                raise AssertionError(f"{tag}: step {j} picks {a} against {b}, "
                                     f"{gap:.3e} apart in a run's logits (bound {tol:.3e})")
    gap, tol = _witness(state, spec, params, list(prompt) + want[:j], a, b)
    if gap >= tol:
        raise AssertionError(f"{tag}: step {j} picks {a} against {b}; the f64 "
                             f"witness puts them {gap:.3e} apart (bound {tol:.3e})")
    return f"{tag} near-tie at step {j} ({a} vs {b}, f64 witness {gap:.2e} < {tol:.2e})"


class _SampleTap:
    """While open, every call of the device sampler (`device_loop.device_sample_coin`:
    inside the serving engine's super-step and verify graphs captured while it is open,
    and in its eager prefill picks) also writes the logits rows it samples from (after
    the grammar's mask), their coins, temperatures and picks into device histories at a
    device counter, so each graph replay records what it sampled. `take()` returns the
    records since the last take (coins, temperatures, picks on the host; the rows stay
    on the card, a copy) and clears the count."""

    CAP = 8192

    def __init__(self, vocab_size: int):
        from distributed_llama_tpu_torch.runtime import device_loop

        dev = torch.device("cuda")
        self._dl, self._fn = device_loop, device_loop.device_sample_coin
        self.rows = torch.zeros((self.CAP, vocab_size), dtype=torch.float32, device=dev)
        self.meta = torch.zeros((3, self.CAP), dtype=torch.float64, device=dev)
        self.count = torch.zeros(1, dtype=torch.int64, device=dev)

    def __enter__(self):
        def tapped(logits, u, temperature, topp):
            picks = self._fn(logits, u, temperature, topp)
            idx = (self.count + torch.arange(logits.shape[0], device=logits.device)
                   ) % self.CAP
            self.rows.index_copy_(0, idx, logits.float())
            self.meta.index_copy_(1, idx, torch.stack([u.double(), temperature.double(),
                                                       picks.double()]))
            self.count += logits.shape[0]
            return picks
        self._dl.device_sample_coin = tapped
        return self

    def __exit__(self, *exc):
        self._dl.device_sample_coin = self._fn

    def take(self) -> tuple[np.ndarray, torch.Tensor]:
        n = int(self.count)
        if n > self.CAP:
            raise AssertionError(f"sample tap: {n} samples overflow its {self.CAP} rows")
        meta = np.array(self.meta[:, :n].cpu())  # a copy: the history is reused
        self.count.zero_()
        return meta, self.rows[:n].clone()


class _LayerTap:
    """While open, keeps the output of every transformer block the forward pass runs
    (`models.forward._block`): calls[i][layer] is call i's (T, dim) block output in f32
    on the host."""

    def __enter__(self):
        from distributed_llama_tpu_torch.models import forward as fw

        self._fw, self._fn, self.calls = fw, fw._block, []

        def tapped(x, bp, li, st, kc, vc):
            out = self._fn(x, bp, li, st, kc, vc)
            if li == 0:
                self.calls.append([])
            self.calls[-1].append(out[0][0].float().cpu())
            return out
        fw._block = tapped
        return self

    def __exit__(self, *exc):
        self._fw._block = self._fn


def _two_evaluations(spec, params, eng, full: list[int], n: int, served: np.ndarray,
                     allowed: np.ndarray) -> str:
    """Where two evaluations of one prefix full[:n] disagree (`_seeded_exact`'s second
    evaluation): the logits of position n - 1 from (A) `eng.infer_chunk_logits` of the
    whole stream full[:-1], (B) `eng.prefill(full[:n])`, (D) the whole stream on the
    dequantize path in bf16 (kernels off: no Q40 tile) and (C) the whole stream and (C')
    the prefill in f32 with the kernels and TF32 off, each against C in max|logits| of
    C, the served row (its allowed entries) beside them; and layer by layer the relative
    distance
    |h - h_C| / |h_C| of the block outputs at that position, with the first layer where A
    departs from B by more than 10x. Returns the report line."""
    from distributed_llama_tpu_torch.runtime.engine import Engine

    plain = Engine(spec, params, device="cuda", dtype=torch.float32, use_kernels=False,
                   cuda_graph=False)
    bf16 = Engine(spec, params, device="cuda", dtype=torch.bfloat16, use_kernels=False,
                  cuda_graph=False)
    rows, layers, first = {}, {}, {}
    for tag, e, whole in (("A", eng, True), ("B", eng, False), ("D", bf16, True),
                          ("C", plain, True), ("C'", plain, False)):
        e.reset()
        with _LayerTap() as tap:
            if whole:
                rows[tag] = e.infer_chunk_logits(full[:-1])[n - 1]
                layers[tag] = [h[n - 1] for h in tap.calls[0]]
                first[tag] = tap.calls[0][0][:n]
            else:
                rows[tag] = e.prefill(full[:n])
                layers[tag] = [h[-1] for h in tap.calls[-1]]
    del plain, bf16
    torch.cuda.empty_cache()
    ref = rows["C"]
    scale = float(np.abs(ref).max())
    off = {tag: float(np.abs(r - ref).max()) / scale for tag, r in rows.items() if tag != "C"}
    off["served"] = float(np.where(allowed, np.abs(served - ref), 0).max()) / scale

    def rel(tag):
        return [float((h - c).norm() / c.norm()) for h, c in zip(layers[tag], layers["C"])]
    dist = {tag: rel(tag) for tag in ("A", "B", "D")}
    first_layer = next((i for i, (a, b) in enumerate(zip(dist["A"], dist["B"]))
                        if a > 10 * max(b, 1e-6)), None)
    fmt = "; ".join(f"{tag} {' '.join(f'{d:.1e}' for d in ds)}" for tag, ds in dist.items())
    # layer 1's attention at the position, recomputed in f32 from each whole-stream
    # evaluation's layer-0 output: the key each head weighs most, and its margin
    att = {tag: _layer_scores(spec, params, first[tag], 1) for tag in ("C", "D", "A")}
    top = {tag: sc.topk(2, dim=-1) for tag, sc in att.items()}
    moved = {tag: (top[tag].indices[:, 0] != top["C"].indices[:, 0]).nonzero().flatten()
             for tag in ("D", "A")}
    gap = top["C"].values[:, 0] - top["C"].values[:, 1]
    p_max = torch.softmax(att["C"], dim=-1).max(dim=-1).values
    heads = "; ".join(
        f"{tag}: {len(h)} of {len(gap)} heads (" + ", ".join(
            f"head {i}: key {int(top['C'].indices[i, 0])} -> {int(top[tag].indices[i, 0])}, "
            f"f32 top-2 gap {float(gap[i]):.3f} of scores to {float(top['C'].values[i, 0]):.1f}"
            for i in h.tolist()[:4]) + ")" for tag, h in moved.items())
    return (f"position {n - 1} (prefix of {n}): max|logits| {scale:.2f} (f32 C); off C "
            f"by {', '.join(f'{k} {v:.2e}' for k, v in off.items())}; A departs from B "
            f"first at layer {first_layer}; |h - h_C| / |h_C| by layer: {fmt}; layer 1's "
            f"attention at the position (f32 from each layer-0 output): max softmax weight "
            f"{float(p_max.min()):.3f}-{float(p_max.max()):.3f} over the heads, the top key "
            f"moved from C's in {heads}")


def _layer_scores(spec, params, h: torch.Tensor, layer: int) -> torch.Tensor:
    """Attention scores (heads, n) of the last of n positions at `layer`, in f32 on the
    dequantize path, from the (n, dim) input rows `h` of that layer (the block output of
    the layer before)."""
    from distributed_llama_tpu_torch.models.forward import layer_params
    from distributed_llama_tpu_torch.ops.kernels import rmsnorm
    from distributed_llama_tpu_torch.ops.matmul import qmatmul
    from distributed_llama_tpu_torch.ops.rope import RopeTables, apply_rope

    n, hs = h.shape[0], spec.head_size
    bp = layer_params(params["blocks"], layer)
    x = rmsnorm(h.to("cuda")[None], bp["rms_att"].float(), spec.norm_eps)
    qkv = qmatmul(x, bp["wqkv"], out_dtype=torch.float32)
    pos = torch.arange(n, device="cuda")
    rope = RopeTables.create(spec, "cuda")
    q = apply_rope(qkv[..., :spec.dim].reshape(1, n, spec.n_heads, hs), rope, pos)
    k = apply_rope(qkv[..., spec.dim:spec.dim + spec.kv_dim].reshape(1, n, spec.n_kv_heads,
                                                                      hs), rope, pos)
    g = spec.n_heads // spec.n_kv_heads
    k = k[0].repeat_interleave(g, dim=1)  # (n, hq, hs)
    return torch.einsum("hd,nhd->hn", q[0, -1], k) / math.sqrt(hs)


def _seeded_exact(state, spec, params, tag: str, prompt, out: list[int], seed: int,
                  rec: tuple, aut=None) -> tuple[torch.Tensor, list[int]]:
    """A seeded row's stream held exactly at its own dispatch shapes, from the device
    sampler's records of its run (`_SampleTap`): every delivered token k is the pick of
    a sample drawn with the row's k-th coin (temperature 0.8, top-p 0.9; the last such
    sample that picked it), and the port's sampler picks it again from that sample's
    logits row under the grammar's mask at the state after out[:k] (`aut`, where given;
    else no entry masked), whose allowed set the row must show; the row is within
    NEAR_TIE·max|logits| of the fused bf16 Engine's logits after prompt + out[:k] (one
    forward of the whole stream), or else of its prefill of prompt + out[:k]. Catches a
    misaligned coin, another row's or state's mask, and a row that is no evaluation of
    this prefix (as far as the logits of random weights tell prefixes apart). Returns
    the rows sampled, (len(out), V) on the card, and the tokens held by the prefill."""
    from distributed_llama_tpu_torch.runtime.device_loop import MASK_NEG, device_sample_coin
    from distributed_llama_tpu_torch.runtime.engine import Engine
    from distributed_llama_tpu_torch.runtime.sampler import Sampler

    meta, rows = rec
    smp = Sampler(spec.vocab_size, 0.8, 0.9, seed)
    coins = [smp.next_coin() for _ in range(len(out))]
    # every sample drawn with each coin: a row parked in a super-step draws its next
    # coin at every step until a live step draws it again
    drawn: dict[float, list[int]] = {}
    for i in np.nonzero(meta[1] != 0)[0]:
        drawn.setdefault(float(meta[0, i]), []).append(int(i))
    lost = [k for k, c in enumerate(coins) if c not in drawn]
    if lost:
        raise AssertionError(f"{tag}: no device sample drew the coins of tokens {lost}")
    # the last sample with the coin that picked the delivered token, else the last one
    idx = [next((i for i in reversed(drawn[c]) if int(meta[2, i]) == t), drawn[c][-1])
           for c, t in zip(coins, out)]
    picks = meta[2, idx].astype(np.int64).tolist()
    if picks != out:
        k = next(k for k, (p, t) in enumerate(zip(picks, out)) if p != t)
        raise AssertionError(f"{tag}: token {k} is {out[k]}, the sample drawn with its "
                             f"coin picked {picks[k]}")
    got = rows[idx]
    eng = state.get("tie_engine")
    if eng is None:
        eng = state["tie_engine"] = Engine(spec, params, device="cuda", fused_matmul=True,
                                           cuda_graph=False)
    eng.reset()
    full = list(prompt) + out
    ref = eng.infer_chunk_logits(full[:-1])[len(prompt) - 1:]
    allowed = np.ones((len(out), spec.vocab_size), bool)
    if aut is not None:
        st = 0
        for k, t in enumerate(out):
            allowed[k] = aut.mask_bool(st)[:spec.vocab_size]
            st = aut.advance(st, t)
    host = got.cpu().numpy()
    shown = host > MASK_NEG / 2
    if not (shown == allowed).all():
        k = int(np.nonzero((shown != allowed).any(1))[0][0])
        raise AssertionError(f"{tag}: token {k} was sampled from a row masked otherwise "
                             f"than its grammar state allows")
    again = device_sample_coin(got, torch.tensor(coins, device=got.device),
                               torch.full((len(out),), 0.8, device=got.device),
                               torch.full((len(out),), 0.9, device=got.device)).tolist()
    if again != out:
        raise AssertionError(f"{tag}: the sampler picks {again} from the recorded rows, "
                             f"the run delivered {out}")
    err = np.where(allowed, np.abs(host - ref), 0).max(1)
    tol = NEAR_TIE * np.where(allowed, np.abs(ref), 0).max(1)
    second = []
    for k in np.nonzero(err > tol)[0].tolist():
        # a second evaluation at other shapes (the Engine's prefill chunks): with random
        # weights a position can turn on one rounding (an attention softmax flipping
        # between keys), so the two evaluations of one prefix may disagree there
        eng.reset()
        alt = eng.prefill(full[:len(prompt) + k])
        e2 = float(np.where(allowed[k], np.abs(host[k] - alt), 0).max())
        t2 = NEAR_TIE * float(np.where(allowed[k], np.abs(alt), 0).max())
        if e2 > t2:
            near = np.abs(host[k][None] - ref).max(1)
            raise AssertionError(
                f"{tag}: token {k} was sampled from a row {err[k]:.3e} from the stream's "
                f"logits there (bound {tol[k]:.3e}) and {e2:.3e} from its prefill's "
                f"(bound {t2:.3e}), nearest the stream's logits for token "
                f"{int(near.argmin())} ({near.min():.3e})")
        second.append(k)
        log(f"[two evaluations] {tag}, token {k}: "
            f"{_two_evaluations(spec, params, eng, full, len(prompt) + k, host[k], allowed[k])}")
    return got, second


def _seeded_pair(state, spec, params, tag: str, prompt, got: list[int], want: list[int],
                 seed: int, recs: tuple, aut=None) -> str:
    """Seeded tokens of two runs of one request at other dispatch shapes (a verify
    block's M against a super-step's): each run held exactly at its own shapes
    (`_seeded_exact`), so where they part, at step j, both drew the same coin and the
    same sampler picked each run's token from that run's own logits, rows within
    NEAR_TIE·max|logits| of one forward of the stream. Returns "" or a description of
    the step, with how far apart the two runs' rows lay."""
    a_rows, a_alt = _seeded_exact(state, spec, params, f"{tag} (got)", prompt, got, seed,
                                  recs[0], aut)
    b_rows, b_alt = _seeded_exact(state, spec, params, f"{tag} (want)", prompt, want,
                                  seed, recs[1], aut)
    alt = (f" (held by their prefill's logits: tokens {a_alt} and {b_alt})"
           if a_alt or b_alt else "")
    if got == want:
        return f"{tag} identical{alt}" if alt else ""
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if j is None:
        raise AssertionError(f"{tag}: {len(got)} tokens against {len(want)}")
    x, y = a_rows[j], b_rows[j]
    live = (x > -1e29) & (y > -1e29)
    gap = float(((x - y).abs() * live).max() / (y.abs() * live).max())
    return (f"{tag} parts at step {j} ({got[j]} vs {want[j]}): the same coin, each run's "
            f"own logits rows {gap:.2e}·max|logits| apart{alt}")


def _prefix_serial(state: dict, spec, params, t: dict, k: int) -> dict:
    """Part 1: 2 slots, superstep k. R0/R1 primers, the donor P + sd, then for each hit
    a displacing request Y_i and the hit P + s_i (one at a time), the last hit exactly P
    (511 tokens remapped, the boundary block copied). The same on an engine with the
    cache off; every host-sampled logits row of the 64-aligned hits bit-identical."""
    runs = {}
    for on in (False, True):
        be = _prefix_engine(spec, params, 2, k, on)
        try:
            _primers(be, t)
            _ask(be, t["P"] + t["sd"], 8)
            rows = []
            for i, prompt in enumerate(t["hits"] + [t["P"]]):
                _ask(be, t["Y"][i], 4)
                _settle_cache(be)
                c0 = (be.prefilled_tokens, be.remapped_blocks, be.kv_pool.cow_blocks,
                      be.seed_bytes, be.seed_ms)
                t0 = time.perf_counter()
                req, smp = _ask(be, prompt, PREFIX_TOKENS, keep=True)
                rows.append(dict(
                    out=req.out, kept=smp.kept, ttft=(req.first_token_t - req.submit_t) * 1e3,
                    e2e=(time.perf_counter() - t0) * 1e3,
                    prefilled=be.prefilled_tokens - c0[0], remapped=be.remapped_blocks - c0[1],
                    cow=be.kv_pool.cow_blocks - c0[2], seed_bytes=be.seed_bytes - c0[3],
                    seed_ms=be.seed_ms - c0[4]))
            stats = be.prefix_cache.stats() if on else {}
            _drained(be, f"part 1 (superstep {k}, cache {'on' if on else 'off'})")
            if on and be.prefix_cache.total_refs():
                raise AssertionError("prefix part 1: leases held after the run")
            runs[on] = (rows, stats)
        finally:
            be.close()
            del be
            gc.collect()  # the engine's graphs and pool sit in reference cycles
            torch.cuda.empty_cache()
    (off, _), (hot, stats) = runs[False], runs[True]
    ties = []
    for i, (a, b) in enumerate(zip(hot, off)):
        last = i == len(PREFIX_SUFFIXES)
        want_remap, want_cow = (31, 1) if last else (32, 0)
        if (a["remapped"], a["cow"], a["seed_bytes"]) != (want_remap, want_cow, 0):
            raise AssertionError(f"prefix part 1 hit {i}: remapped {a['remapped']}, copied "
                                 f"{a['cow']}, seed bytes {a['seed_bytes']} (want "
                                 f"{want_remap}, {want_cow}, 0)")
        skipped = b["prefilled"] - a["prefilled"]
        if skipped != (511 if last else 512):
            raise AssertionError(f"prefix part 1 hit {i}: prefill fell by {skipped} tokens")
        if last:
            note = _held(state, spec, params, f"prefix part 1 superstep {k} exact-P hit", t["P"],
                         a["out"], b["out"], a["kept"], b["kept"])
            if note:
                ties.append(note)
            continue
        if a["out"] != b["out"] or len(a["kept"]) != len(b["kept"]) or not all(
                np.array_equal(x, y) for x, y in zip(a["kept"], b["kept"])):
            raise AssertionError(f"prefix part 1 (superstep {k}) hit {i}: tokens or logits "
                                 f"differ from the cache-off run")
    wnote = ""
    if k == 1:
        # the witness on every run: P's next token against the exact-P hit's first one
        wl = _witness_logits(state, spec, params, t["P"])
        pick, card = int(np.argmax(wl)), hot[-1]["out"][0]
        gap, tol = abs(float(wl[pick] - wl[card])), NEAR_TIE * float(np.abs(wl).max())
        if gap >= tol:
            raise AssertionError(f"prefix part 1: the f64 witness picks {pick} after P, "
                                 f"the card {card}, {gap:.3e} apart (bound {tol:.3e})")
        wnote = f"; the f64 witness after P picks {pick} (the card {card}, {gap:.2e} apart)"
    n_rows = sum(len(a["kept"]) for a in hot[:-1])
    log(f"[prefix] part 1, 2 slots, superstep {k}" + (", pipelined" if k > 1 else "")
        + f": {len(PREFIX_SUFFIXES)} hits on P ({PREFIX_P} tokens) each remapped 32 blocks "
        f"(0 bytes moved) and prefilled 512 tokens fewer; every token and all {n_rows} "
        f"host-sampled logits rows bit-identical to the cache-off run; the exact-P hit "
        f"remapped 31 blocks and copied 1, its tokens "
        + ("identical" if not ties else "; ".join(ties)) + wnote + "; time to first token on "
        f"{[round(a['ttft'], 1) for a in hot]} ms, off {[round(b['ttft'], 1) for b in off]} "
        f"ms; seed ms {[round(a['seed_ms'], 3) for a in hot]}; directory {stats}")
    return {"ttft_on": [a["ttft"] for a in hot], "ttft_off": [b["ttft"] for b in off],
            "seed_ms": [a["seed_ms"] for a in hot], "ties": ties}


def _prefix_reference(spec, params, t: dict) -> list[tuple[int, np.ndarray]]:
    """Part 2's bit-exact reference, cache off on the 8-slot engine: each hit alone on
    slot 0 (after a displacing request) while the long primer stays parked on slot 1, so
    every chunk of P and of the suffix runs at the chunk size, batch shape (8 rows) and
    window (1024) at which the cache-on run's donor and its hits ran it. Each hit's first
    token and its logits row."""
    be = _prefix_engine(spec, params, 8, SERVE_K, False)
    try:
        _primers(be, t)
        out = []
        for y, p in zip(t["Y"], t["many"]):
            _ask(be, y, 4)
            req, smp = _ask(be, p, 1, keep=True)
            if be._slots[0].history[:len(p)] != p:
                raise AssertionError("prefix part 2 reference: a hit left slot 0")
            out.append((req.out[0], smp.kept[0]))
        held = be._slots[1].history
        if not (PREFIX_P - 64 < len(held) <= 1024 - 64 and held[0] == 2):
            raise AssertionError("prefix part 2 reference: the long primer left slot 1")
        return out
    finally:
        be.close()
        del be
        gc.collect()  # the engine's graphs and pool sit in reference cycles
        torch.cuda.empty_cache()


def _prefix_concurrent(state: dict, spec, params, t: dict) -> dict:
    """Part 2: the serve phase's engine (8 slots, superstep 8 pipelined, pool of 1033
    blocks, its graphs counted): the primers, the donor, 8 displacing requests, then 8
    hits on P submitted together, PREFIX_CONCURRENT_TOKENS greedy tokens each, with the
    cache on and off. The hits' launches (eager prefill chunks, graph replays) are held
    to the serve phase's schedule; the super-step period is the spacing of full
    deliveries and device busy a step comes from torch.profiler over the next ones
    (`_profile_serve_superstep`). Every hit's first logits row is bit-identical to the
    serial reference's (`_prefix_reference`) and its first token is the cache-off run's."""
    ref = _prefix_reference(spec, params, t)
    counters = _serve_counters()
    runs = {}
    for on in (False, True):
        held = torch.cuda.memory_allocated()
        be = _prefix_engine(spec, params, 8, SERVE_K, on, counted=True)
        try:
            _primers(be, t)
            _ask(be, t["P"] + t["sd"], 8)
            ys = [be.submit(y, 4, _CheckedSampler(spec.vocab_size)) for y in t["Y"]]
            for r in ys:
                r.wait(timeout=900)
            _settle_cache(be)
            graphs = be.engine.graphs
            _zero(counters)
            snap = graph_snapshot(counters, graphs)
            c0 = (be.prefilled_tokens, be.remapped_blocks, be.kv_pool.cow_blocks,
                  be.seed_bytes, be.seed_ms, {k: len(v) for k, v in be.dispatch_ms.items()},
                  be.dispatches, be.loop_steps)
            smps = [_CheckedSampler(spec.vocab_size, keep=True) for _ in t["many"]]
            reqs = []

            def submit():
                reqs.extend(be.submit(p, PREFIX_CONCURRENT_TOKENS, s)
                            for p, s in zip(t["many"], smps))
                return reqs
            prof = _profile_serve_superstep(
                be, SERVE_K, warm=PREFIX_PERIOD_STEPS, window=PREFIX_PROFILED, submit=submit,
                tag=f"[prefix] part 2, cache {'on' if on else 'off'},")
            launches, replays, new = run_launches(counters, graphs, snap)
            loop = be.loop_steps - c0[7]
            eager = be.dispatches - c0[6] - loop // SERVE_K
            steps = eager + replays + new
            want = {name: n * steps for name, n in SERVE_PER_DISPATCH.items()}
            if launches != want or replays != loop or any(
                    len(r.out) != PREFIX_CONCURRENT_TOKENS for r in reqs):
                raise AssertionError(f"prefix part 2 (cache {'on' if on else 'off'}): "
                                     f"launches {launches} (want {want} for {eager} eager "
                                     f"steps, {replays} replays, {new} captures; {loop} "
                                     f"loop steps), tokens {[len(r.out) for r in reqs]}")
            runs[on] = dict(
                outs=[r.out for r in reqs], first=[s.kept[0] for s in smps],
                ttft=[(r.first_token_t - r.submit_t) * 1e3 for r in reqs],
                prefilled=be.prefilled_tokens - c0[0], remapped=be.remapped_blocks - c0[1],
                cow=be.kv_pool.cow_blocks - c0[2], seed_bytes=be.seed_bytes - c0[3],
                seed_ms=be.seed_ms - c0[4],
                dispatches={k: len(v) - c0[5][k] for k, v in be.dispatch_ms.items()},
                launches=launches, steps=(eager, replays, new), period=prof["period"],
                busy=prof["busy"], prof=prof, held=held)
            _drained(be, f"part 2 (cache {'on' if on else 'off'})")
        finally:
            be.close()
            del be
            gc.collect()  # the engine's graphs and pool sit in reference cycles
            torch.cuda.empty_cache()
    on, off = runs[True], runs[False]
    if on["remapped"] != 32 * len(t["many"]) or on["seed_bytes"] or on["cow"]:
        raise AssertionError(f"prefix part 2: remapped {on['remapped']}, copied "
                             f"{on['cow']}, seed bytes {on['seed_bytes']}")
    worst, ties = 0.0, []
    for i, p in enumerate(t["many"]):
        a, b = on["first"][i], off["first"][i]
        if not np.array_equal(a, ref[i][1]) or on["outs"][i][0] != ref[i][0]:
            raise AssertionError(f"prefix part 2 request {i}: its first logits differ from "
                                 f"the serial cache-off reference's")
        if on["outs"][i][0] != off["outs"][i][0]:
            raise AssertionError(f"prefix part 2 request {i}: first token "
                                 f"{on['outs'][i][0]} with the cache, {off['outs'][i][0]} "
                                 f"without")
        # the cache-off run's prefill of P read other windows (the other rows' positions)
        err, tol = float(np.abs(a - b).max()), NEAR_TIE * float(np.abs(b).max())
        worst = max(worst, err / tol)
        if err > tol:
            raise AssertionError(f"prefix part 2 request {i}: first logits {err:.3e} from "
                                 f"the cache-off run's (bound {tol:.3e})")
        note = _held(state, spec, params, f"prefix part 2 request {i}", p, on["outs"][i],
                     off["outs"][i], [a], [b])
        if note:
            ties.append(note)
    log(f"[prefix] part 2, 8 slots, superstep {SERVE_K} pipelined, pool 1033 x 16: 8 hits "
        f"on P submitted together, {PREFIX_CONCURRENT_TOKENS} greedy tokens each: time to "
        f"first token mean {np.mean(on['ttft']):.1f} ms, max {np.max(on['ttft']):.1f} ms "
        f"with the cache, {np.mean(off['ttft']):.1f} / {np.max(off['ttft']):.1f} ms without; "
        f"prefilled {on['prefilled']} against {off['prefilled']} tokens; dispatches "
        f"{on['dispatches']} against {off['dispatches']}; remapped {on['remapped']} "
        f"blocks, copied {on['cow']}, seed {on['seed_ms']:.3f} ms ({on['seed_bytes']} "
        f"bytes); launches {json.dumps(on['launches'])} against {json.dumps(off['launches'])}"
        f" = per forward step {json.dumps(SERVE_PER_DISPATCH)} x (eager, replays, captures) "
        f"{on['steps']} against {off['steps']}; super-step period "
        f"{on['period']:.3f} ms/step against {off['period']:.3f} ({PREFIX_PERIOD_STEPS} full "
        f"super-steps each), device busy {on['busy']:.3f} against {off['busy']:.3f} ms/step "
        f"(profiled over the next {PREFIX_PROFILED}; idle in its span "
        f"{on['prof']['span'] - on['busy']:.3f} against {off['prof']['span'] - off['busy']:.3f}"
        f" ms/step, gaps over 0.25 ms {on['prof']['big_gaps']} against "
        f"{off['prof']['big_gaps']}; after it {on['prof']['period_after']:.3f} against "
        f"{off['prof']['period_after']:.3f} ms/step); device memory held when the engine "
        f"was built {on['held'] / 2**30:.2f} against {off['held'] / 2**30:.2f} GiB; chained "
        f"{on['prof']['chained']} against {off['prof']['chained']}, Python's collector "
        f"{on['prof']['gc_ms']:.1f} against {off['prof']['gc_ms']:.1f} ms; all 8 first "
        f"logits rows "
        f"bit-identical to the serial cache-off reference, first tokens identical, the "
        f"cache-off run's first rows within {worst:.3f} of {NEAR_TIE}·max|logits|; tokens "
        + ("identical" if not ties else "; ".join(ties)))
    return {"ttft_mean_on": float(np.mean(on["ttft"])), "ttft_max_on": float(np.max(on["ttft"])),
            "ttft_mean_off": float(np.mean(off["ttft"])),
            "ttft_max_off": float(np.max(off["ttft"])), "prefilled_on": on["prefilled"],
            "prefilled_off": off["prefilled"], "dispatches_on": on["dispatches"],
            "dispatches_off": off["dispatches"], "seed_ms": on["seed_ms"],
            "remapped": on["remapped"], "cow": on["cow"], "period_on": on["period"],
            "period_off": off["period"], "busy_on": on["busy"], "busy_off": off["busy"],
            "host_on": on["prof"], "host_off": off["prof"],
            "first_logits_worst": worst, "ties": ties}


def _tier_run(spec, params, t: dict, on: bool, q80: bool = False) -> dict:
    """One run of part 3's sequence: the primers, the donor, a 1900-token request W, a
    displacing request, then the hit P + s3. With the cache on, the smallest pool the
    engine takes (one context, the scratch block and one spare) and a host tier of 72
    blocks (Q80 with `q80`), and the P rows read before W and after the hit; the
    cache-off run keeps the default pool, so its primer stays parked."""
    tag = "Q80" if q80 else "hot"
    kw = dict(kv_pool_blocks=130, prefix_cache_blocks=72, prefix_cache_q80=q80) if on \
        else {}
    be = _prefix_engine(spec, params, 2, SERVE_K, on, **kw)
    try:
        _primers(be, t)
        _ask(be, t["P"] + t["sd"], 8)
        _settle_cache(be)
        if on:
            with be._slock:
                before = [be._read_block(b) for b in be._slots[0].blocks[:32]]
            st0 = be.prefix_cache.stats()
        t0 = time.perf_counter()
        _ask(be, t["W"], 8)
        w_ms = (time.perf_counter() - t0) * 1e3
        # a displacing request rewinds W's slot to its first token, so W's blocks
        # belong to the directory alone and can make room for the promotions
        _ask(be, t["Y"][0], 4)
        _settle_cache(be)
        c0 = (be.seed_bytes, be.seed_ms, be.prefix_cache.stats() if on else None)
        req, smp = _ask(be, t["P"] + t["s3"], PREFIX_TOKENS, keep=True)
        run = dict(out=req.out, kept=smp.kept, w_ms=w_ms,
                   ttft=(req.first_token_t - req.submit_t) * 1e3)
        if on:
            _settle_cache(be)
            with be._slock:
                after = [be._read_block(b) for b in be._slots[0].blocks[:32]]
            st1 = be.prefix_cache.stats()
            run.update(before=before, after=after, st0=st0, mid=c0[2], st1=st1,
                       seed_bytes=be.seed_bytes - c0[0], seed_ms=be.seed_ms - c0[1],
                       demoted=st1["demoted_blocks"] - st0["demoted_blocks"],
                       promoted=st1["promoted_blocks"] - c0[2]["promoted_blocks"])
        d0 = be.prefix_cache.stats()["demoted_blocks"] if on else 0
        t0 = time.perf_counter()
        run["free"] = _drained(be, f"part 3 {tag} (cache {'on' if on else 'off'})")
        if on:
            # the drain demotes the rest of the directory: a pure demotion pass
            n = be.prefix_cache.stats()["demoted_blocks"] - d0
            run["demote_ms"] = (time.perf_counter() - t0) * 1e3 / max(n, 1)
            run["drain_demoted"] = n
        if on and be.prefix_cache.total_refs():
            raise AssertionError(f"prefix part 3 {tag}: leases held after the run")
        return run
    finally:
        be.close()
        del be
        gc.collect()  # the engine's graphs and pool sit in reference cycles
        torch.cuda.empty_cache()


def _prefix_tiers(state: dict, spec, params, t: dict, q80: bool, off: dict) -> dict:
    """Part 3: 2 slots, a pool of 130 blocks. After the primers and the donor, a
    1900-token request W needs more blocks than are free: its growth reclaims the
    directory, demoting LRU blocks to the host tier (the primer's, then P's first ones),
    and after a displacing request the hit on P promotes them back (one upload each).
    The P rows the hit's table reads afterwards against the donor's rows read before the
    demotion: hot, bit for bit; Q80, within the Q80 round trip's bound. `off` is the
    cache-off run of the same sequence (`_tier_run`), shared by both tiers."""
    tag = "Q80" if q80 else "hot"
    runs = {True: _tier_run(spec, params, t, True, q80), False: off}
    on, off = runs[True], runs[False]
    if on["promoted"] < 1 or on["mid"]["demoted_blocks"] <= on["st0"]["demoted_blocks"]:
        raise AssertionError(f"prefix part 3 {tag}: demoted {on['demoted']}, promoted "
                             f"{on['promoted']}: the directory did not go through the tier")
    block_bytes = 2 * spec.n_layers * spec.n_kv_heads * 16 * spec.head_size * 2
    if on["seed_bytes"] != on["promoted"] * block_bytes:
        raise AssertionError(f"prefix part 3 {tag}: seed bytes {on['seed_bytes']} for "
                             f"{on['promoted']} promoted blocks")
    exact, worst = 0, 0.0
    for (bk, bv), (ak, av) in zip(on["before"], on["after"]):
        for x, y in ((bk, ak), (bv, av)):
            if torch.equal(x.view(torch.int16), y.view(torch.int16)):
                exact += 1
                continue
            # one Q80 step (max|x|/127 over the block, the CPU tests' bound) plus the
            # bf16 rounding of the restored value
            bound_ = float(x.float().abs().max()) / 127 * 1.01 + 2 ** -8 * float(
                x.float().abs().max())
            err = float((x.float() - y.float()).abs().max())
            worst = max(worst, err / bound_)
            if q80 and err <= bound_:
                continue
            raise AssertionError(f"prefix part 3 {tag}: a promoted block differs from "
                                 f"the rows read before its demotion (max|err| {err:.3e})")
    if q80 and exact == 64:
        raise AssertionError("prefix part 3 Q80: no promoted block went through Q80")
    if not q80:
        if on["out"] != off["out"] or not all(
                np.array_equal(x, y) for x, y in zip(on["kept"], off["kept"])):
            raise AssertionError("prefix part 3 hot: tokens or logits differ from the "
                                 "cache-off run")
    same = sum(a == b for a, b in zip(on["out"], off["out"]))
    grew = on["mid"]["demoted_blocks"] - on["st0"]["demoted_blocks"]
    log(f"[prefix] part 3 {tag} tier, 2 slots, pool 130 x 16, host tier 72 blocks: the "
        f"1900-token request's growth demoted {grew} directory blocks in "
        f"{on['w_ms']:.1f} ms (its whole request); the hit promoted "
        f"{on['promoted']} blocks ({on['seed_bytes']} bytes, seed {on['seed_ms']:.2f} ms) "
        f"and remapped {32 - on['promoted']}; P's 32 blocks after it: {exact} of 64 K/V "
        f"halves bit-identical to the rows read before the demotion"
        + (f", the rest within the Q80 bound (worst {worst:.3f} of it)" if q80 else "")
        + f"; tokens {'identical to' if on['out'] == off['out'] else f'{same} of 16 equal to'} "
        f"the cache-off run's ({on['out']})"
        + ("" if q80 else ", logits bit-identical") + f"; demoted {on['st1']['demoted_blocks']}, "
        f"promoted {on['st1']['promoted_blocks']} in all; the drain demoted "
        f"{on['drain_demoted']} more at {on['demote_ms']:.2f} ms a block; pool drained to "
        f"{on['free']} free")
    return {"promoted": on["promoted"], "seed_ms": on["seed_ms"], "w_ms": on["w_ms"],
            "demote_ms_per_block": on["demote_ms"], "drain_demoted": on["drain_demoted"],
            "demoted": grew,
            "exact_halves": exact}


def _prefix_single(state: dict, spec, params, t: dict) -> dict:
    """Part 4: the single-sequence Engine (dense bf16 cache, graph-replayed steps)
    through SingleSlotCache: A = P + s, an unrelated B of 600 tokens, then A' = P + s'
    (a radix seed of 512 rows, 256 MiB host->device) whose 16 steps' logits must equal a
    fresh Engine's prefill of A' bit for bit, and a follow-up turn served by the
    resident rewind."""
    from distributed_llama_tpu_torch.cache import SingleSlotCache, make_prefix_cache
    from distributed_llama_tpu_torch.runtime.engine import Engine

    eng = Engine(spec, params, device="cuda", fused_matmul=True)
    assert eng.cuda_graph and eng.dtype == torch.bfloat16
    ptrs = (eng.k_cache.data_ptr(), eng.v_cache.data_ptr())
    pc = make_prefix_cache(eng.k_cache.shape, eng.k_cache.element_size(), slots=1)
    ssc = SingleSlotCache(eng, pc)
    vocab = spec.vocab_size

    def turn(prompt, n, keep=False):
        smp = _CheckedSampler(vocab, keep)
        first = []
        t0 = time.perf_counter()
        reuse = ssc.begin(prompt)
        t_seed = time.perf_counter()
        out, _ = eng.generate(prompt[reuse:], n, smp,
                              on_token=lambda _t: first or first.append(time.perf_counter()))
        ssc.end((prompt + out)[:eng.pos])
        return dict(reuse=reuse, out=out, kept=smp.kept, seed_ms=(t_seed - t0) * 1e3,
                    ttft=(first[0] - t0) * 1e3)

    a = t["P"] + t["sd"]
    a2 = t["P"] + t["s3"]
    turn(a, 8)
    turn(t["R1"], 8)
    replays = eng.graphs.replays
    got = turn(a2, PREFIX_TOKENS, keep=True)
    replayed = eng.graphs.replays - replays
    follow = a2 + got["out"] + t["sd"][:5]
    hits = pc.hits
    again = turn(follow, 4)
    fresh = Engine(spec, params, device="cuda", fused_matmul=True)
    smp = _CheckedSampler(vocab, keep=True)
    first = []
    t0 = time.perf_counter()
    want, _ = fresh.generate(a2, PREFIX_TOKENS, smp,
                             on_token=lambda _t: first or first.append(time.perf_counter()))
    off_ttft = (first[0] - t0) * 1e3
    del fresh
    if got["reuse"] != PREFIX_P:
        raise AssertionError(f"prefix part 4: A' reused {got['reuse']} tokens, want the "
                             f"{PREFIX_P}-row seed")
    if got["out"] != want or not all(np.array_equal(x, y)
                                     for x, y in zip(got["kept"], smp.kept)):
        raise AssertionError("prefix part 4: the seeded A' differs from a fresh prefill")
    if again["reuse"] < len(a2) or pc.hits != hits or pc.total_refs():
        raise AssertionError(f"prefix part 4: the follow-up reused {again['reuse']} tokens, "
                             f"hits {hits} -> {pc.hits}, refs {pc.total_refs()}")
    if (eng.k_cache.data_ptr(), eng.v_cache.data_ptr()) != ptrs or replayed < PREFIX_TOKENS - 1:
        raise AssertionError("prefix part 4: the cache moved, or the steps did not replay")
    log(f"[prefix] part 4, single sequence (dense bf16 cache, graph replays): A' seeded "
        f"{PREFIX_P} rows ({PREFIX_P * 4 * spec.n_layers * spec.n_kv_heads * spec.head_size} "
        f"bytes) in {got['seed_ms']:.2f} "
        f"ms, time to first token {got['ttft']:.1f} ms against {off_ttft:.1f} ms for a "
        f"fresh prefill; {PREFIX_TOKENS} steps' logits bit-identical ({replayed} graph "
        f"replays); the follow-up turn rewound {again['reuse']} resident tokens; "
        f"{pc.stats()}")
    return {"seed_ms": got["seed_ms"], "ttft_on": got["ttft"], "ttft_off": off_ttft}


# the phases after serve that run on its 7B weights, in their order
SERVE_WEIGHT_PHASES = ("prefix", "spec", "resil", "tenancy", "disagg", "obs", "constrain",
                       "draft")


def _take_serve_params(state: dict, phase: str):
    """The serve phase's 7B weights (drawn here when that phase did not run), kept in
    `state` while a later phase of SERVE_WEIGHT_PHASES still reads them."""
    later = SERVE_WEIGHT_PHASES[SERVE_WEIGHT_PHASES.index(phase) + 1:]
    keep = bool(set(later) & set(state["phases"]))
    params = (state.get if keep else state.pop)("serve_params", None) or \
        _random_i4p_params(_llama2_7b(), torch.device("cuda"), seed=13, gate_pair=True)
    if keep:
        state["serve_params"] = params
    return params


def phase_prefix(state: dict) -> None:
    """The prefix cache over paged KV at Llama-2-7B (the serve phase's weights)."""
    spec = _llama2_7b()
    params = _take_serve_params(state, "prefix")
    t = _prefix_tokens(spec)
    numbers, seconds = {}, {}
    with _CountDegraded() as deg:
        t0 = time.perf_counter()
        for k in (1, SERVE_K):
            numbers[f"part1_k{k}"] = _prefix_serial(state, spec, params, t, k)
        seconds["part1"], t0 = time.perf_counter() - t0, time.perf_counter()
        numbers["part2"] = _prefix_concurrent(state, spec, params, t)
        seconds["part2"], t0 = time.perf_counter() - t0, time.perf_counter()
        off = _tier_run(spec, params, t, False)
        for q80 in (False, True):
            numbers["part3_q80" if q80 else "part3_hot"] = _prefix_tiers(state, spec,
                                                                         params, t, q80, off)
        seconds["part3"], t0 = time.perf_counter() - t0, time.perf_counter()
        numbers["part4"] = _prefix_single(state, spec, params, t)
        seconds["part4"] = time.perf_counter() - t0
    numbers["seconds"] = seconds
    state.pop("prefix_witness", None)
    if deg.calls:
        raise AssertionError(f"prefix: {len(deg.calls)} cache degradation(s): {deg.calls}")
    log("[prefix] numbers: " + json.dumps(numbers, default=float))
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ speculative decoding

SPEC_K = 8  # draft tokens a row at most: verify blocks of T = 2, 3, 5 and 9
SPEC_BUCKETS = VERIFY_T
# the full-size run: 8 prompts of a 24-token random segment three times (73 tokens),
# each extended by the SPEC_PROBE greedy tokens the speculation-off engine decodes after
# it, then SPEC_TOKENS greedy tokens a request
SPEC_SEGMENT, SPEC_PROBE, SPEC_TOKENS = 24, 32, 64


def _spec_run(state: dict, be, prompts, tag: str) -> dict:
    """The 8 staggered requests (request i+1 at request i's first token) on one engine:
    SPEC_TOKENS greedy tokens each, launches held to SERVE_PER_DISPATCH per forward step
    (eager steps, graph replays of super-steps and verify blocks, a warm-up step per
    capture), the pool drained after; the run's numbers."""
    counters = _serve_counters()
    graphs = be.engine.graphs
    be.dispatches = be.decode_steps = be.mixed_steps = be.super_steps = 0
    be.loop_steps = be.chained = be.verify_steps = be.spec_drafted = be.spec_accepted = 0
    be.flushes.clear()
    for times in be.dispatch_ms.values():
        times.clear()
    _zero(counters)
    snap = graph_snapshot(counters, graphs)
    t0 = time.perf_counter()
    reqs, _ = staggered(be, prompts, SPEC_TOKENS, after=1)
    wall = time.perf_counter() - t0
    launches, replays, new = run_launches(counters, graphs, snap)
    eager = be.dispatches - be.loop_steps // SERVE_K - be.verify_steps
    steps = eager + replays + new
    want = {name: n * steps for name, n in SERVE_PER_DISPATCH.items()}
    outs = [r.out for r in reqs]
    if launches != want or [len(o) for o in outs] != [SPEC_TOKENS] * len(prompts):
        raise AssertionError(f"spec run ({tag}): launches {launches} (want {want} for "
                             f"{eager} eager steps, {replays} replays, {new} captures), "
                             f"tokens {[len(o) for o in outs]}")
    free = be.release_idle()
    if free != be.kv_pool.n_blocks - 1:
        raise AssertionError(f"spec run ({tag}): {free} blocks free after the run, want "
                             f"{be.kv_pool.n_blocks - 1} (all but scratch)")
    verify_replays = {f"T={k[4]} win={k[2]}": graphs.replays_of(k) - snap[1].get(k, 0)
                      for k in graphs.keys() if k[0] == "batched_verify"}
    turns = [t for r in reqs for t in r.stats.spec_turns]
    n_tok = sum(len(o) for o in outs)
    ver, sup = be.dispatch_ms["verify"], be.dispatch_ms["super"]
    out = dict(outs=outs, wall=wall, tok_s=n_tok / wall, launches=launches,
               dispatches=be.dispatches, eager=eager, replays=replays, captures=new,
               verify=be.verify_steps, super=be.super_steps, chained=be.chained,
               flushes=dict(be.flushes), drafted=be.spec_drafted,
               accepted=be.spec_accepted, accepting_turns=sum(t[2] >= 1 for t in turns),
               turns=len(turns), verify_replays=verify_replays,
               verify_ms=float(np.mean(ver)) if ver else None,
               super_ms=float(np.mean(sup)) if sup else None, free=free,
               decode_dispatches=be.verify_steps + be.super_steps)
    log(f"[spec] {tag}: Llama-2-7B Q40 bf16 fused, 8 slots, superstep {SERVE_K} "
        f"pipelined, speculative {be.spec_k}: {n_tok} tokens in {wall:.2f} s, "
        f"{out['tok_s']:.1f} tok/s; {be.dispatches} dispatches ({eager} eager, "
        f"{be.super_steps} super-steps, {be.verify_steps} verify blocks, {be.chained} "
        f"chained, flushes {dict(be.flushes)}); drafted {be.spec_drafted}, accepted "
        f"{be.spec_accepted} in {out['accepting_turns']} of {len(turns)} row turns; "
        f"verify replays by bucket {json.dumps(verify_replays)}; dispatch ms: verify "
        f"{out['verify_ms']}, super-step {out['super_ms']}; launches {json.dumps(launches)}"
        f" = per forward step x {steps}; pool drained to {free} free blocks")
    return out


def _spec_step_ms(be) -> dict:
    """Device ms of one batched step of the 8-slot engine at each block length: T = 1
    (a super-step of SERVE_K steps over SERVE_K) and the verify buckets, greedy, every
    row at positions 200-221 (window 256), by CUDA events over graph replays."""
    eng = be.engine
    starts = [200 + 3 * i for i in range(8)]
    rng = np.zeros((8, 2), np.int64)
    window = eng._window_for(256)
    out = {}
    with be._slock:  # the scheduler is idle; this thread drives the loops
        for sl in be._slots:
            be._paged_ensure(sl, 256)
        tables = be._tables()
        loop = be._batched_loop(SERVE_K, "greedy", window)
        out[1] = event_ms(lambda i: loop(eng.rope, [5] * 8, eng.k_cache, eng.v_cache,
                                         starts, rng, [0.0] * 8, [0.9] * 8,
                                         [SERVE_K] * 8, tables), 10) / SERVE_K
        for t in SPEC_BUCKETS:
            vloop = be._verify_loop(t, "greedy", window)
            props = [[5] * t for _ in range(8)]
            out[t] = event_ms(lambda i: vloop(eng.rope, props, eng.k_cache, eng.v_cache,
                                              starts, rng, [0.0] * 8, [0.9] * 8,
                                              [t - 1] * 8, tables), 20)
    free = be.release_idle()
    if free != be.kv_pool.n_blocks - 1:
        raise AssertionError(f"spec: {free} blocks free after the step timing")
    return out


def _spec_full(state: dict, spec, params) -> dict:
    """Speculation at full Llama-2-7B on the serve phase's weights: speculation off,
    then on, on the same prompts (a repeated random segment, extended by the
    speculation-off engine's own greedy continuation), tokens held by the near-tie
    rule, at least one accepted draft, verify blocks replayed per bucket, tok/s and ms
    per step at each block length."""
    gen = torch.Generator().manual_seed(71)
    bases = [[1] + torch.randint(3, spec.vocab_size, (SPEC_SEGMENT,),
                                 generator=gen).tolist() * 3 for _ in range(8)]
    be = _serve_engine(params, SERVE_K)
    try:
        # the probe: its tokens extend the prompts, so each prompt ends in the model's
        # own greedy continuation
        probe, _ = staggered(be, bases, SPEC_PROBE, after=1)
        prompts = [b + r.out for b, r in zip(bases, probe)]
        be.release_idle()
        off = _spec_run(state, be, prompts, "speculation off")
    finally:
        be.close()
    del be
    gc.collect()
    torch.cuda.empty_cache()
    be = _serve_engine(params, SERVE_K, SPEC_K)
    try:
        alloc, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        warm, _ = staggered(be, prompts, SPEC_TOKENS, after=1)  # captures the graphs
        be.release_idle()
        graph_mem = (torch.cuda.memory_allocated() - alloc,
                     torch.cuda.memory_reserved() - reserved)
        on = _spec_run(state, be, prompts, "speculation on")
        if on["outs"] != [r.out for r in warm]:
            raise AssertionError("spec: the speculating engine's two runs decoded "
                                 "different tokens")
        step_ms = _spec_step_ms(be)
        keys = be.engine.graphs.keys()
    finally:
        be.close()
    del be
    gc.collect()
    torch.cuda.empty_cache()
    notes = [n for i in range(8) if (n := _held(state, spec, params, f"spec request {i}",
                                                 prompts[i], on["outs"][i],
                                                 off["outs"][i]))]
    if on["accepting_turns"] < 1:
        raise AssertionError(f"spec: no verify turn accepted a draft ({on['turns']} row "
                             f"turns, {on['drafted']} drafted)")
    missing = [t for t in SPEC_BUCKETS if not any(f"T={t} " in k and n > 0
                                                  for k, n in on["verify_replays"].items())]
    if missing:
        raise AssertionError(f"spec: the speculating run replayed no verify graph at T = "
                             f"{missing} ({on['verify_replays']})")
    state["launches"].update(on["launches"])
    verify_keys = [k for k in keys if k[0] == "batched_verify"]
    log(f"[spec] speculation on against off: tokens "
        + ("identical" if not notes else "identical outside " + "; ".join(notes))
        + f"; tok/s {off['tok_s']:.1f} -> {on['tok_s']:.1f}; decode dispatches (super-"
        f"steps + verify blocks) {off['decode_dispatches']} -> {on['decode_dispatches']}"
        f" for {8 * SPEC_TOKENS} tokens; tokens per decode dispatch and row "
        f"{8 * SPEC_TOKENS / max(off['decode_dispatches'], 1) / 8:.2f} -> "
        f"{8 * SPEC_TOKENS / max(on['decode_dispatches'], 1) / 8:.2f}; accept rate "
        f"{on['accepted'] / max(on['drafted'], 1):.3f} ({on['accepted']}/{on['drafted']});"
        f" every bucket T = {list(SPEC_BUCKETS)} replayed in the run")
    log(f"[spec] ms per batched step, 8 rows, window 256 (CUDA events over graph "
        f"replays): " + ", ".join(f"T={t} {ms:.3f}" for t, ms in step_ms.items())
        + "; against T=1: " + ", ".join(f"T={t} {step_ms[t] / step_ms[1]:.2f}x"
                                        for t in SPEC_BUCKETS))
    log(f"[spec] graphs: {len(keys)} captured in the speculating engine ({len(verify_keys)}"
        f" verify: {sorted((k[1], k[2], k[4]) for k in verify_keys)}), one memory pool; "
        f"memory allocated grew {graph_mem[0] / 2**20:.1f} MiB and reserved "
        f"{graph_mem[1] / 2**20:.1f} MiB over the run that captured them")
    return dict(off={k: v for k, v in off.items() if k != "outs"},
                on={k: v for k, v in on.items() if k != "outs"}, step_ms=step_ms,
                graphs=len(keys), verify_graphs=len(verify_keys),
                graph_mem_mib=[m / 2**20 for m in graph_mem], near_ties=notes)


def _spec_single(state: dict, spec, params) -> dict:
    """Engine.generate_speculative at full Llama-2-7B (the serve weights, prefill_kernel:
    the verify blocks run q4_matmul at M = T), CUDA graphs per verify bucket against
    the eager engine (identical tokens and turns), and against generate() under the
    near-tie rule; ms per token of both. The graph engine's run is counted: q4_matmul
    once per projection (161 on the serve weights: wqkv, wo, w1, w3, w2 x 32 and wcls)
    per verify forward step (replays and the warm-up step of each capture) and per
    prefill chunk of M > 1, q4_matvec as often and decode_attention once a layer per
    T = 1 step, every verify graph's capture holding exactly that q4_matmul count."""
    from distributed_llama_tpu_torch.runtime.engine import Engine

    gen = torch.Generator().manual_seed(72)
    base = [1] + torch.randint(3, spec.vocab_size, (SPEC_SEGMENT,),
                               generator=gen).tolist() * 3
    counters = _single_counters()
    eng = Engine(spec, params, device="cuda", prefill_kernel=True)
    eng.graphs = counting_graphs(eng.device, counters)
    eager = Engine(spec, params, device="cuda", prefill_kernel=True, cuda_graph=False)
    assert eng.cuda_graph and not eager.cuda_graph
    vocab = spec.vocab_size
    prompt = base + eng.generate(base, SPEC_PROBE, _CheckedSampler(vocab))[0]
    n = SPEC_TOKENS
    eng.reset()
    plain, pstats = eng.generate(prompt, n, _CheckedSampler(vocab))
    runs = []
    for e in (eng, eager):
        e.reset()
        torch.cuda.synchronize()
        if e is eng:
            _zero(counters)
            snap = graph_snapshot(counters, eng.graphs)
        t0 = time.perf_counter()
        toks, st = e.generate_speculative(prompt, n, _CheckedSampler(vocab), k=SPEC_K)
        runs.append((toks, st, time.perf_counter() - t0 - st.prefill_ms / 1e3))
        if e is eng:
            launches, _, _ = run_launches(counters, eng.graphs, snap)
    (got, st, wall), (got_e, st_e, wall_e) = runs
    if got != got_e or st.spec_turns != st_e.spec_turns:
        raise AssertionError("spec single sequence: the graph engine's tokens or turns "
                             "differ from the eager engine's")
    note = _held(state, spec, params, "spec single sequence", prompt, got, plain)
    per_step = (4 + ("w1" in params["blocks"])) * spec.n_layers + 1
    t1 = {"q4_matvec": per_step, "decode_attention": spec.n_layers}
    # forward steps in the run (replays, and the warm-up step of each capture) and the
    # replays alone (one per verify turn or one-token prefill chunk)
    steps, replays = {"verify": 0, "step": 0}, {"verify": 0, "step": 0}
    for key in eng.graphs.keys():
        dr = eng.graphs.replays_of(key) - snap[1].get(key, 0)
        want = {"q4_matmul": per_step} if key[0] == "verify" else t1
        if dr and eng.graphs.per_step[key] != {c: want.get(c, 0) for c in counters}:
            raise AssertionError(f"spec single sequence: graph {key} launches "
                                 f"{eng.graphs.per_step[key]}, want {want}")
        steps[key[0]] += dr + (key not in snap[1])
        replays[key[0]] += dr
    m = len(prompt) - 1  # the prefill: prompt[:-1] in chunks of 64, 8 and 1
    chunks, t1_chunks = m // 64 + m % 64 // 8, m % 8
    want = {c: 0 for c in counters}
    want["q4_matmul"] = per_step * (steps["verify"] + chunks)
    for c, v in t1.items():
        want[c] = v * steps["step"]
    if (launches != want or not steps["verify"]
            or replays["verify"] + replays["step"] != st.spec_steps + t1_chunks):
        raise AssertionError(f"spec single sequence: launches {launches} (want {want} for "
                             f"{steps['verify']} verify and {steps['step']} one-token "
                             f"forward steps, {chunks} prefill chunks of M > 1), "
                             f"{st.spec_steps} verify turns")
    verify = {f"T={k[3]} win={k[2]}": eng.graphs.replays_of(k)
              for k in eng.graphs.keys() if k[0] == "verify"}
    out = dict(tokens=len(got), spec_steps=st.spec_steps, drafted=st.spec_drafted,
               accepted=st.spec_accepted, ms_per_token=wall * 1e3 / len(got),
               eager_ms_per_token=wall_e * 1e3 / len(got),
               plain_ms_per_token=float(np.mean(pstats.infer_ms)),
               verify_replays=verify, launches=launches, near_tie=note)
    log(f"[spec] single sequence, Llama-2-7B Q40 bf16 prefill_kernel: generate_speculative"
        f" k={SPEC_K}, {len(got)} tokens in {st.spec_steps} verify steps, accepted "
        f"{st.spec_accepted}/{st.spec_drafted}; graph and eager tokens and turns "
        f"identical; against generate(): " + (note or "identical") + f"; ms/token "
        f"{out['ms_per_token']:.2f} (eager {out['eager_ms_per_token']:.2f}) against the "
        f"one-token graph step's {out['plain_ms_per_token']:.2f}; verify graph replays "
        f"{json.dumps(verify)}; launches {json.dumps({c: v for c, v in launches.items() if v})}"
        f" = q4_matmul {per_step} x ({steps['verify']} verify forward steps + {chunks} "
        f"prefill chunks), {json.dumps(t1)} x {steps['step']} one-token steps")
    del eng, eager
    gc.collect()
    torch.cuda.empty_cache()
    return out


class _ReferenceDrafts:
    """A proposer (the n-gram proposer's interface, in its place on the engine) that
    drafts each request's reference continuation: the tokens a speculation-off run gave
    the same prompt. For requests whose index is odd the third draft of every block is
    replaced by another token, so their blocks take the correction path; the others'
    blocks are accepted whole wherever the verify's target at each position is the
    reference token, which checks the verify step's argmax at every position. The drafts
    depend on the reference and the count of delivered tokens, not on their values.
    `log` lists the verify turns in delivery order: (request index, its turn number)."""

    name = "reference"

    def __init__(self, prompts, refs, vocab: int):
        self.ref = {tuple(p): (i, list(r)) for i, (p, r) in enumerate(zip(prompts, refs))}
        self.vocab = vocab
        self.rows: dict[int, list] = {}  # row -> [request index, reference, delivered]
        self.log: list[tuple[int, int]] = []

    def attach(self, row, tokens):
        i, ref = self.ref[tuple(tokens)]
        self.rows[row] = [i, ref, 0]

    def detach(self, row):
        self.rows.pop(row, None)

    def push(self, row, tok):
        if row in self.rows:
            self.rows[row][2] += 1

    def propose(self, row, k):
        if row not in self.rows or k <= 0:
            return []
        i, ref, n = self.rows[row]
        d = ref[n:n + k]
        if i % 2 and len(d) > 2:
            d[2] = (d[2] + 1) % self.vocab
        return d

    def propose_batch(self, want):
        return {r: d for r, k in want.items() if (d := self.propose(r, k))}

    def observe(self, row, accepted):
        i = self.rows[row][0]
        self.log.append((i, sum(r == i for r, _ in self.log)))

    def ready(self, row, k, min_draft):
        return len(self.propose(row, k)) >= min_draft


def spec_parity(n_layers: int = 2, max_tokens: int = 16) -> str:
    """The fused BatchEngine(speculative=8) at full Llama-2-7B width, 2 layers, f32 with
    seeded weights (nibbles 1..15, so greedy streams vary), on 4 staggered requests
    (superstep 4, pipelined): a speculation-off CPU run gives each request's reference
    tokens; then the CPU with the kernels' plain versions and the card with the kernels
    run with every block drafted from the reference (`_ReferenceDrafts`: half the
    requests' blocks corrupted at their third draft), so both decode the same (B, T)
    blocks. The CPU must accept drafts (how many requests keep the reference's tokens is
    reported: the reference ran each position at another M, and the plain versions
    round activations to bf16), and the card's tokens must be the CPU's, unless a
    request's tokens part at a near-tie: there the CPU's logits (the single-sequence
    Engine on the plain versions) and an exact-sum run (`_ExactSums`) must both put the
    two picks within 2e-3·max|logits|, and tokens past that point are not compared.
    The verify turns (request, output length, drafted, accepted), in delivery order,
    must be the CPU's: all of them without a near-tie, else every turn delivered before
    the first turn a tie can reach: one of the tied request's turns that emits a later
    token, or that emits the tied step as its correction (a bonus token, past a fully
    accepted draft, leaves its turn as it was). The drafts ignore the tokens' values,
    so nothing before that turn can differ."""
    import contextlib

    from distributed_llama_tpu_torch.models.params import params_to
    from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
    from distributed_llama_tpu_torch.runtime.engine import Engine

    spec = _llama2_7b(n_layers=n_layers)
    params = _random_i4p_params(spec, torch.device("cpu"), seed=8, gate_pair=True, lo=1)
    kw = dict(slots=4, dtype=torch.float32, use_kernels=True, fused_matmul=True,
              superstep=4, prefix_cache=False)
    rng = np.random.RandomState(7)
    prompts = [[1] + rng.randint(3, spec.vocab_size, n).tolist() for n in (18, 27, 15, 21)]

    def run(dev, refs=None):
        be = BatchEngine(spec, params_to(params, dev), device=dev,
                         speculative=SPEC_K if refs else 0, **kw)
        assert be.engine.use_kernels == "fused" and be.engine.paged_kernel
        if refs:
            be.proposer = _ReferenceDrafts(prompts, refs, spec.vocab_size)
        try:
            reqs, _ = staggered(be, prompts, max_tokens, after=1)
            turns = ([(i,) + reqs[i].stats.spec_turns[n] for i, n in be.proposer.log]
                     if refs else [])
            return ([r.out for r in reqs], turns, be.verify_steps, be.spec_accepted,
                    be.spec_drafted)
        finally:
            be.close()

    with _SharedDequant():
        refs = run("cpu")[0]
        cpu = run("cpu", refs)
        if not cpu[3]:
            raise AssertionError(f"spec parity: the CPU's speculating run accepted no draft "
                                 f"of {cpu[4]}")
        # against the reference only reported: the speculation-off run decoded each
        # position at another M, and the plain versions round activations to bf16, so a
        # near-tie may part the two CPU runs
        same = sum(a == b for a, b in zip(cpu[0], refs))
        card = run("cuda", refs)
        ties = _parity_streams(spec, params, prompts, card[0], cpu[0],
                               "spec parity request")
        cut = len(cpu[1])  # the verify turns held equal
        for i, j, _ in ties:
            # a turn of request i that emits past step j, or corrects at j, is the first
            # the tie can reach (a bonus token at j leaves its own turn as it was)
            cut = min(cut, next((x for x, (r, o, nd, acc) in enumerate(cpu[1])
                                 if r == i and (o + acc > j or o + acc == j < o + nd)),
                                cut))
    if card[1][:cut] != cpu[1][:cut] or (not ties and card[1] != cpu[1]):
        raise AssertionError(f"spec parity: verify turns differ in the first {cut}: card "
                             f"{card[1]}, CPU {cpu[1]}")
    torch.cuda.empty_cache()
    return (f"fused BatchEngine(speculative={SPEC_K}), 4 staggered requests x {max_tokens} "
            f"greedy tokens drafted from a speculation-off run's tokens (requests 1 and 3 "
            f"corrupted at each block's third draft): the CPU's tokens equal that run's in "
            f"{same} of 4 requests ({cpu[2]} verify blocks, {cpu[3]}/{cpu[4]} drafts "
            f"accepted); the card's "
            + (f"identical outside near-ties: {'; '.join(t for _, _, t in ties)}" if ties else
               f"identical ({card[2]} verify blocks, {card[3]}/{card[4]} drafts "
               f"accepted)") + f"; verify turns (request, output length, drafted, "
            f"accepted) equal in delivery order: {cut} of the CPU's {len(cpu[1])}"
            + (" (those before the first turn a near-tie reaches)" if ties else "")
            + f" {cpu[1][:cut]}; tokens {cpu[0]}")


def _parity_tie(spec, params, history: list[int], a: int, b: int, what: str) -> str:
    """Two greedy picks a (card) and b (CPU) after `history`, held as a near-tie: the
    CPU's logits (the single-sequence Engine on the plain versions) and an exact-sum run
    (`_ExactSums`) must both put them within 2e-3·max|logits|."""
    import contextlib

    from distributed_llama_tpu_torch.runtime.engine import Engine

    eng = Engine(spec, params, device="cpu", dtype=torch.float32, use_kernels=True,
                 fused_matmul=True)
    gaps = []
    for exact in (False, True):
        eng.reset()
        with _ExactSums() if exact else contextlib.nullcontext():
            logits = eng.infer_chunk_logits(history)[-1]
        gap = abs(float(logits[a] - logits[b]))
        tol = 2e-3 * float(np.abs(logits).max())
        if gap >= tol:
            raise AssertionError(f"{what}: card {a}, CPU {b}, {gap:.3e} apart in the "
                                 f"{'exact-sum' if exact else 'CPU'} logits (tolerance "
                                 f"{tol:.3e})")
        gaps.append(f"{gap:.2e} (tol {tol:.2e})")
    return f"{what}: card {a}, CPU {b}, CPU gap {gaps[0]}, exact-sum gap {gaps[1]}"


def _parity_streams(spec, params, prompts, card, cpu, what: str
                    ) -> list[tuple[int, int, str]]:
    """Greedy streams of the card against the CPU's: identical, or identical up to a
    near-tie (`_parity_tie`) past which they are not compared. Returns (stream, step,
    description) of each near-tie."""
    ties = []
    for i, (a, b) in enumerate(zip(card, cpu)):
        if a == b:
            continue
        j = next((x for x, (p, q) in enumerate(zip(a, b)) if p != q), None)
        if j is None:
            raise AssertionError(f"{what} {i}: {len(a)} tokens on the card, {len(b)} on "
                                 f"the CPU")
        ties.append((i, j, _parity_tie(spec, params, list(prompts[i]) + b[:j], a[j], b[j],
                                       f"{what} {i} step {j}")))
    return ties


def constrain_parity(params, n_layers: int = 2, max_tokens: int = 16) -> str:
    """The masked super-step and the masked verify in the fused BatchEngine at full
    Llama-2-7B width, 2 layers, f32 with seeded weights (nibbles 1..15): the card with
    the kernels against the CPU with their plain versions, 4 requests admitted together
    (the schema, the branchy regex, 2 unconstrained; prompts of 8 and 16 tokens, so the
    prefill takes few dispatches), greedy, speculative 8: the grammar proposer's forced
    chains run in masked verify blocks and the branch points in masked super-steps. The
    card's tokens are the CPU's outside near-ties, every constrained output is valid,
    and both masked builds run on both. `params`: the 2-layer CPU weights (seed 8,
    nibbles 1..15) in the gate-pair layout."""
    from distributed_llama_tpu_torch.constrain import compile_grammar
    from distributed_llama_tpu_torch.models.params import params_to
    from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine

    spec = _llama2_7b(n_layers=n_layers)
    # the synthetic tokenizer's vocab: one token a byte, so the schema has forced chains
    vocab, eos = _constrain_vocab(spec.vocab_size)
    grammars = [compile_grammar("json_schema", CONSTRAIN_SCHEMA, vocab, eos),
                compile_grammar("regex", CONSTRAIN_REGEX, vocab, eos), None, None]
    rng = np.random.RandomState(9)
    prompts = [[1] + rng.randint(3, spec.vocab_size, n).tolist() for n in (7, 15, 7, 15)]
    runs = {}
    for dev in ("cpu", "cuda"):
        be = BatchEngine(spec, params_to(params, dev), device=dev, slots=4,
                         dtype=torch.float32, use_kernels=True, fused_matmul=True,
                         superstep=4, speculative=SPEC_K, prefix_cache=False)
        try:
            with be._slock:
                reqs = [be.submit(list(p), max_tokens, _CheckedSampler(spec.vocab_size),
                                  **({} if g is None else dict(constraint=g[0])))
                        for p, g in zip(prompts, grammars)]
            outs = [r.wait(timeout=900) for r in reqs]
            keys = be.engine.graphs.keys() if dev == "cuda" else list(be._loops)
            masked = sorted({"verify" if "verify" in str(k[0]) else "scan"
                             for k in keys if k[-1] == "mask"})
            runs[dev] = (outs, masked, be.verify_steps)
            if masked != ["scan", "verify"] or be.constrain_degraded:
                raise AssertionError(f"constrain parity ({dev}): masked builds run {masked}"
                                     f", {be.constrain_degraded} degraded")
        finally:
            be.close()
        for i in range(2):
            _constrain_valid(grammars[i][0], runs[dev][0][i], eos,
                             f"constrain parity {dev} {i}")
    ties = _parity_streams(spec, params, prompts, runs["cuda"][0], runs["cpu"][0],
                           "constrain parity request")
    torch.cuda.empty_cache()
    return (f"fused BatchEngine(speculative={SPEC_K}), schema + regex + 2 free rows x "
            f"{max_tokens} greedy tokens: masked super-steps and verify blocks on both, "
            f"{runs['cuda'][2]} verify blocks on the card ({runs['cpu'][2]} on the CPU); "
            f"tokens " + ("identical" if not ties else "identical outside "
                          + "; ".join(t for _, _, t in ties)) + f" {runs['cpu'][0]}")


def drafter_parity(params, n_layers: int = 2, turns: int = 3) -> str:
    """The drafter's catch-up + draft scan at full Llama-2-7B width, 2 layers, f32 with
    seeded weights (a self-draft): the card with the kernels (each scan step a CUDA
    graph) against the CPU with their plain versions, 4 rows of different prompts, each
    turn's pushes the CPU's drafts' first two and one correction token: the card's
    drafts the CPU's outside near-ties, turn after turn, and its prefill and scan ran.
    `params`: as constrain_parity's."""
    from distributed_llama_tpu_torch.draft.drafter import ModelDrafter
    from distributed_llama_tpu_torch.models.params import params_to

    spec = _llama2_7b(n_layers=n_layers)
    rng = np.random.RandomState(11)
    prompts = [[1] + rng.randint(3, spec.vocab_size, n).tolist() for n in (12, 30, 7, 44)]
    drafters = {dev: ModelDrafter(spec, params_to(params, dev), slots=4, target_spec=spec,
                                  device=dev, dtype=torch.float32, use_kernels="fused")
                for dev in ("cpu", "cuda")}
    streams = {dev: [list(p) for p in prompts] for dev in drafters}
    for d in drafters.values():
        for r, p in enumerate(prompts):
            d.attach(r, p)
    ties = []
    for turn in range(turns):
        want = {r: 8 for r in range(4)}
        cpu = drafters["cpu"].propose_batch(want)
        card = drafters["cuda"].propose_batch(want)
        if set(cpu) != set(card):
            raise AssertionError(f"drafter parity turn {turn}: rows {sorted(card)} on the "
                                 f"card, {sorted(cpu)} on the CPU")
        rows = sorted(cpu)
        ties += [t for _, _, t in _parity_streams(
            spec, params, [streams["cpu"][r] for r in rows], [card[r] for r in rows],
            [cpu[r] for r in rows], f"drafter parity turn {turn} row")]
        for r in rows:
            push = cpu[r][:2] + [(cpu[r][2] + 1) % spec.vocab_size]
            for dev, d in drafters.items():
                for t in push:
                    d.push(r, t)
            streams["cpu"][r] += push
    g = drafters["cuda"].graphs
    if not g.enabled or not g.keys() or drafters["cuda"].prefill_tokens <= 0:
        raise AssertionError(f"drafter parity: scans captured {g.keys()}, prefill tokens "
                             f"{drafters['cuda'].prefill_tokens}")
    torch.cuda.empty_cache()
    return (f"self-draft scans over {turns} turns of 4 rows x 8 drafts: the card's drafts "
            + ("identical" if not ties else "identical outside " + "; ".join(ties))
            + f"; scan graphs {sorted(k[1] for k in g.keys())}, prefill tokens "
            f"{drafters['cuda'].prefill_tokens}")


def phase_spec(state: dict) -> None:
    """Speculative decoding: card-against-CPU parity at 2 layers, then full Llama-2-7B
    (the serve phase's weights) in the batched engine and the single-sequence Engine."""
    t0 = time.perf_counter()
    log(f"[spec] parity: {spec_parity()} ({time.perf_counter() - t0:.1f} s)")
    spec = _llama2_7b()
    params = _take_serve_params(state, "spec")
    numbers = {"full": _spec_full(state, spec, params),
               "single": _spec_single(state, spec, params)}
    state.pop("prefix_witness", None)
    log("[spec] numbers: " + json.dumps(numbers, default=float))
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ request control

# the resil phase's requests: prompt lengths whose positions all stay under the first
# 256-position attention window (so every run's steps read the same window bucket) and
# the tokens each generates; rows 0-3 greedy, rows 4-7 seeded (temperature 0.8)
RESIL_PROMPTS = (21, 48, 17, 60, 33, 25, 52, 40)
RESIL_TOKENS = 96
# resume: 32-token prompts (two full 16-token blocks) and 24 tokens, so every resumed
# prompt (32 + k, k in RESIL_K) leaves under 8 tokens past its last full block: its tail
# is prefilled one token a step, the (8, 1) shape the uninterrupted run decoded it in,
# and all the rest is remapped from the directory
RESIL_RESUME_P = 32
RESIL_RESUME_N = 24
RESIL_K = (1, 7, RESIL_RESUME_N - 1)
RESIL_HOLD = 1.0  # seconds a held scheduler waits past a TTL of RESIL_HOLD / 10


def _resil_engine(params):
    """The 8-slot fused BatchEngine at full Llama-2-7B with the serving defaults: paged
    KV with the prefix cache, super-steps of SERVE_K, pipelined."""
    from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine

    be = BatchEngine(_llama2_7b(), params, slots=8, device="cuda", fused_matmul=True,
                     kv_block_tokens=16, superstep=SERVE_K)
    assert be.prefix_cache is not None and be.kv_pool is not None and be.pipeline
    assert be.engine.use_kernels == "fused" and be.engine.cuda_graph
    return be


def _resil_fresh(be) -> None:
    """Empty every cache of an idle engine — the slots' rewind stock, the prefix
    directory, the pool metadata — so that each run starts from the state a recovery
    leaves and takes the same schedule."""
    with be._slock:
        assert all(s.req is None for s in be._slots)
        for sl in be._slots:
            be._paged_release_slot(sl)
        be.prefix_cache.reset()
        be.kv_pool.reset()


_RESIL_ROWS: list = []  # logits rows the greedy rows' samplers saw (host-side picks)


def _resil_smp(i: int, vocab: int):
    from distributed_llama_tpu_torch.runtime.sampler import Sampler

    if i < 4:
        smp = _CheckedSampler(vocab, keep=True)
        _RESIL_ROWS.append(smp.kept)
        return smp
    return Sampler(vocab, 0.8, 0.9, 1000 + i)


def _sampler_paths(rows, dev, temperature: float = 0.8, topp: float = 0.9,
                   coins: int = 256) -> tuple[int, int]:
    """The host Sampler's nucleus pick against the device sampler's
    (device_loop.device_sample_coin) on the same 7B logits rows and coins: (picks that
    differ, picks). Why the engine picks host-side stochastic tokens on the card with
    the device sampler."""
    from distributed_llama_tpu_torch.runtime.device_loop import device_sample_coin
    from distributed_llama_tpu_torch.runtime.sampler import Sampler, _softmax

    gen = np.random.default_rng(5)
    differ = total = 0
    for row in rows:
        row = np.asarray(row, np.float32)
        us = (gen.integers(0, 1 << 24, coins) / 16777216.0).astype(np.float32)
        host = Sampler(len(row), temperature, topp)
        probs = _softmax(row / host.temperature)
        picks = [host._sample_topp(probs, float(u)) for u in us]
        picked = device_sample_coin(
            torch.from_numpy(row).to(dev).expand(coins, -1).contiguous(),
            torch.from_numpy(us).to(dev), torch.full((coins,), temperature, device=dev),
            torch.full((coins,), topp, device=dev)).tolist()
        differ += sum(a != b for a, b in zip(picks, picked))
        total += coins
    return differ, total


def _resil_submit(be, prompts, n: int, samplers, **kw) -> list:
    """Submit while holding the scheduler lock: one pass admits every request, so a run
    from the same state takes the same schedule."""
    with be._slock:
        return [be.submit(list(p), n, s, **kw) for p, s in zip(prompts, samplers)]


def _resil_outs(reqs) -> list[list[int]]:
    return [r.wait(timeout=600) for r in reqs]


def _resil_until(cond, timeout: float = 300.0, what: str = "condition") -> None:
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"resil: timed out waiting for {what}")
        time.sleep(0.002)


def _resil_raises(req, err, what: str) -> None:
    try:
        req.wait(timeout=600)
    except err:
        return
    raise AssertionError(f"resil: {what}: expected {err.__name__}, got finish "
                         f"{req.finish!r} error {req.error!r}")


class _ResilHold:
    """Blockers on every slot whose token callback waits on an event once all slots hold
    a request: the scheduler thread (the callback's thread) is parked until release(), so
    nothing is admitted, reaped or dispatched meanwhile — no timing race."""

    def __init__(self, be, first: int = 100):
        from distributed_llama_tpu_torch.runtime.sampler import Sampler

        self.event, self.parked = threading.Event(), threading.Event()

        def on_token(_t):
            if all(s.req is not None for s in be._slots):
                self.parked.set()
                self.event.wait(120)
        self.reqs = [be.submit([1, first + i], 200, Sampler(be.spec.vocab_size),
                               on_token=on_token) for i in range(be.slots_n)]
        if not self.parked.wait(300):
            raise AssertionError("resil: the blockers never held every slot")

    def release(self) -> None:
        self.event.set()
        for r in self.reqs:
            r.cancel()
        for r in self.reqs:
            r.done.wait(120)


def _resil_blast(be, prompts, numbers: dict) -> list[list[int]]:
    """Part 1: a victim killed at its prefill (run P), and one killed mid-super-step at
    its token delivery (run E): the survivors' tokens equal a fault-free run's. Returns
    the fault-free tokens of all 8 requests (run R8)."""
    from distributed_llama_tpu_torch.resilience import faults
    from distributed_llama_tpu_torch.resilience.errors import FaultInjected
    from distributed_llama_tpu_torch.resilience.faults import FaultSpec

    v = be.spec.vocab_size
    n = RESIL_TOKENS
    _resil_fresh(be)
    ref7 = _resil_outs(_resil_submit(be, prompts[:7], n, [_resil_smp(i, v)
                                                          for i in range(7)]))
    _resil_fresh(be)
    surv = _resil_submit(be, prompts[:7], n, [_resil_smp(i, v) for i in range(7)])
    _resil_until(lambda: all(r.out for r in surv), what="the survivors' first tokens")
    free = [s.index for s in be._slots if s.req is None]
    assert free == [7], free
    with faults.active(FaultSpec("batch.prefill", kind="error", count=1,
                                 match={"slot": 7})) as plan:
        victim = be.submit(prompts[7], n, _resil_smp(7, v))
        _resil_raises(victim, FaultInjected, "prefill victim")
        got = _resil_outs(surv)
        assert plan.fired() == 1
    if got != ref7:
        raise AssertionError("resil: survivors of the prefill victim differ in rows "
                             f"{[i for i in range(7) if got[i] != ref7[i]]}")
    _resil_fresh(be)
    ref8 = _resil_outs(_resil_submit(be, prompts, n, [_resil_smp(i, v) for i in range(8)]))
    _resil_fresh(be)
    reqs = _resil_submit(be, prompts, n, [_resil_smp(i, v) for i in range(8)])
    _resil_until(lambda: all(r.out for r in reqs), what="every first token")
    s0 = be.super_steps
    with faults.active(FaultSpec("batch.emit", kind="error", count=1, after=2,
                                 match={"slot": 7})) as plan:
        _resil_raises(reqs[7], FaultInjected, "emit victim")
        got = _resil_outs(reqs[:7])
        assert plan.fired() == 1
    if got != ref8[:7]:
        raise AssertionError("resil: survivors of the emit victim differ in rows "
                             f"{[i for i in range(7) if got[i] != ref8[i]]}")
    if not be.scheduler_alive() or be.super_steps == s0:
        raise AssertionError("resil: the scheduler died, or no super-step ran")
    numbers["blast"] = {"prefill_victim_survivors": 7, "emit_victim_tokens":
                        len(reqs[7].out), "super_steps": be.super_steps - s0}
    log(f"[resil] blast radius: prefill victim and emit victim (after "
        f"{len(reqs[7].out)} tokens, inside super-step delivery) each failed alone; 7 "
        f"survivors x {n} tokens (4 greedy, 3 seeded) identical to the fault-free runs")
    return ref8


def _resil_transient(be, prompts, ref8, wall_ref: float, numbers: dict) -> None:
    """Part 2: two transient failures of super-step dispatches, retried before their
    first launch: the same tokens, 2 retries, no new graph capture."""
    from distributed_llama_tpu_torch.resilience import faults
    from distributed_llama_tpu_torch.resilience.faults import FaultSpec

    v = be.spec.vocab_size
    _resil_fresh(be)
    r0, caps0 = be.retries, be.engine.graphs.captures
    # each super-step issue's wall, with its retries: the retried one against the rest
    issues: list[tuple[float, int]] = []
    real = be._dispatched

    def timed(kind, call):
        n, t = be.retries, time.perf_counter()
        out = real(kind, call)
        if kind == "super_step":
            issues.append((time.perf_counter() - t, be.retries - n))
        return out
    be._dispatched = timed
    t0 = time.perf_counter()
    try:
        with faults.active(FaultSpec("batch.dispatch", kind="transient", count=2,
                                     match={"kind": "super_step"})) as plan:
            got = _resil_outs(_resil_submit(be, prompts, RESIL_TOKENS,
                                            [_resil_smp(i, v) for i in range(8)]))
            assert plan.fired() == 2
    finally:
        del be._dispatched
    wall = time.perf_counter() - t0
    if got != ref8:
        raise AssertionError("resil: tokens changed under retried transient faults")
    if be.retries - r0 != 2 or be.engine.graphs.captures != caps0:
        raise AssertionError(f"resil: retries {be.retries - r0}, captures "
                             f"{caps0} -> {be.engine.graphs.captures}")
    retried = [(dt, n) for dt, n in issues if n]
    plain = float(np.median([dt for dt, n in issues if not n]))
    per = (sum(dt for dt, _ in retried) - plain * len(retried)) / 2
    numbers["transient"] = {"retries": 2, "retried_issues": len(retried),
                            "retried_issue_ms": [dt * 1e3 for dt, _ in retried],
                            "plain_issue_ms": plain * 1e3, "ms_per_retry": per * 1e3,
                            "wall_s": wall, "wall_ref_s": wall_ref}
    log(f"[resil] transient: 2 super-step dispatch attempts failed and were retried before "
        f"their first launch, tokens identical, captures unchanged ({caps0}); the retried "
        f"issue took {', '.join(f'{dt * 1e3:.1f}' for dt, _ in retried)} ms against "
        f"{plain * 1e3:.2f} ms for a plain one: {per * 1e3:.1f} ms a retry (backoff 50 "
        f"then 100 ms); run wall {wall:.3f} s against {wall_ref:.3f} s fault-free (the "
        f"backoff overlaps the super-step in flight)")


def _resil_admission(be, numbers: dict) -> None:
    """Part 3: with all 8 slots held, a queue TTL expires (DeadlineExceeded) and
    max_queue sheds (EngineSaturated, Retry-After > 0); a generation deadline that
    passes after the first token keeps the partial output."""
    from distributed_llama_tpu_torch.resilience.errors import (DeadlineExceeded,
                                                               EngineSaturated)
    from distributed_llama_tpu_torch.runtime.sampler import Sampler

    v = be.spec.vocab_size
    _resil_fresh(be)
    hold = _ResilHold(be)
    try:
        ttl = be.submit([1, 2, 3], 4, Sampler(v), ttl=RESIL_HOLD / 10)
        be.max_queue = 2
        queued = be.submit([1, 4, 5], 4, Sampler(v))
        try:
            be.submit([1, 6, 7], 4, Sampler(v))
            raise AssertionError("resil: max_queue did not shed")
        except EngineSaturated as e:
            retry_after = e.retry_after
        load = be.load_stats()
        time.sleep(RESIL_HOLD)
    finally:
        be.max_queue = 0
        hold.release()
    _resil_raises(ttl, DeadlineExceeded, "queue TTL")
    queued.cancel()
    queued.done.wait(120)
    if retry_after <= 0 or load["free_slots"] or load["queue_depth"] != 2:
        raise AssertionError(f"resil: retry_after {retry_after}, load {load}")
    first = []

    def on_token(_t):
        if not first:
            first.append(time.perf_counter())
            time.sleep(2 * RESIL_HOLD)
    req = be.submit([1, 9], 200, Sampler(v), on_token=on_token, deadline=RESIL_HOLD)
    out = req.wait(timeout=600)
    if req.finish != "deadline" or req.error is not None or not 1 <= len(out) <= 9:
        raise AssertionError(f"resil: generation deadline: finish {req.finish!r}, "
                             f"{len(out)} tokens, error {req.error!r}")
    numbers["admission"] = {"retry_after_s": retry_after, "deadline_tokens": len(out)}
    log(f"[resil] admission: queue TTL {RESIL_HOLD / 10:g} s expired with all 8 slots "
        f"held (DeadlineExceeded), max_queue=2 shed with retry_after {retry_after:.3f} s, "
        f"a {RESIL_HOLD:g} s deadline kept {len(out)} tokens (finish 'deadline')")


def _resil_wedge(be, prompts, ref8, numbers: dict) -> None:
    """Part 5: the supervisor recovers a dispatch parked for 600 s: every in-flight
    request fails with EngineWedged, recover_wedged keeps the pool's storage and takes
    about the 1 s join, the abandoned thread makes no launch when woken, the graphs are
    captured again and the same prompts give the same tokens."""
    from distributed_llama_tpu_torch.resilience import faults
    from distributed_llama_tpu_torch.resilience.errors import EngineWedged
    from distributed_llama_tpu_torch.resilience.faults import FaultSpec
    from distributed_llama_tpu_torch.resilience.supervisor import EngineSupervisor

    v = be.spec.vocab_size
    eng, graphs = be.engine, be.engine.graphs
    slowest = max(max(ms) for ms in be.dispatch_ms.values() if ms) / 1e3
    threshold = slowest + 2.0
    sup = EngineSupervisor(be, threshold=threshold, poll=0.05)
    timing = {}
    recover = be.recover_wedged

    def timed(*a, **kw):
        timing["detect"] = time.perf_counter()
        ok = recover(*a, **kw)
        timing["done"] = time.perf_counter()
        return ok
    be.recover_wedged = timed
    ptrs = (eng.k_cache.data_ptr(), eng.v_cache.data_ptr(), be._tables_dev.data_ptr())
    _resil_fresh(be)
    reqs = _resil_submit(be, prompts, RESIL_TOKENS, [_resil_smp(i, v) for i in range(8)])
    _resil_until(lambda: all(r.out for r in reqs), what="every first token")
    try:
        plan = faults.install([FaultSpec("batch.dispatch", kind="latency",
                                         delay_ms=600_000, count=1)])
        _resil_until(lambda: plan.fired() == 1, what="the parked dispatch")
        zombie = be._thread
        old = {k: graphs._graphs[k] for k in graphs.keys()}
        replays = {k: c.replays for k, c in old.items()}
        sup.start()
        for i, r in enumerate(reqs):
            _resil_raises(r, EngineWedged, f"in-flight request {i}")
        _resil_until(lambda: sup.recoveries == 1 and sup.healthy and "done" in timing,
                     what="the supervisor's recovery")
        sup.stop()
        counters = _serve_counters()
        before = (_read(counters), be.dispatches, graphs.replays)
        faults.release()  # wake the abandoned thread
        zombie.join(60)
        if zombie.is_alive():
            raise AssertionError("resil: the abandoned scheduler thread did not exit")
        after = (_read(counters), be.dispatches, graphs.replays)
        stale = {k: c.replays - replays[k] for k, c in old.items() if c.replays != replays[k]}
        if after != before or stale:
            raise AssertionError(f"resil: the abandoned thread launched: {before} -> "
                                 f"{after}, replays on the old keys {stale}")
    finally:
        faults.release()
        faults.uninstall()
        sup.stop()
        del be.recover_wedged
    recovered = timing["done"] - timing["detect"]
    if (eng.k_cache.data_ptr(), eng.v_cache.data_ptr(),
            be._tables_dev.data_ptr()) != ptrs:
        raise AssertionError("resil: the recovery moved the pool or the block table")
    if recovered > 1.5 or graphs.keys():
        raise AssertionError(f"resil: recover_wedged took {recovered:.3f} s, graphs left "
                             f"{graphs.keys()}")
    caps0 = graphs.captures
    n_super = len(be.dispatch_ms["super"])
    got = _resil_outs(_resil_submit(be, prompts, RESIL_TOKENS,
                                    [_resil_smp(i, v) for i in range(8)]))
    if got != ref8:
        raise AssertionError("resil: tokens after the recovery differ in rows "
                             f"{[i for i in range(8) if got[i] != ref8[i]]}")
    if graphs.captures <= caps0:
        raise AssertionError("resil: no graph was captured again after the recovery")
    free = be.release_idle()
    if free != be.kv_pool.n_blocks - 1:
        raise AssertionError(f"resil: {free} free blocks after release_idle, want "
                             f"{be.kv_pool.n_blocks - 1}")
    # the first super-step after the recovery captures its graph again; the warm ones
    # are the same run's later super-steps
    post = list(be.dispatch_ms["super"])[n_super:]
    first_ms, warm_ms = post[0], float(np.median(post[1:]))
    numbers["wedge"] = {"threshold_s": threshold, "recover_s": recovered,
                        "captures_after": graphs.captures - caps0,
                        "first_super_ms": first_ms, "warm_super_ms": warm_ms}
    log(f"[resil] wedge: supervisor (threshold {threshold:.2f} s) recovered a dispatch "
        f"parked for 600 s: 8 in-flight requests failed EngineWedged, recover_wedged "
        f"{recovered:.3f} s (detection to healthy), pool and table storage kept, the "
        f"abandoned thread made no launch and no replay on the {len(old)} old graph(s), "
        f"{graphs.captures - caps0} graph(s) captured again, 8 x {RESIL_TOKENS} tokens "
        f"identical to before the wedge, pool whole ({free} free); first super-step "
        f"after recovery {first_ms:.1f} ms (with the capture) against {warm_ms:.1f} ms "
        f"warm")


def _resil_resume(be, numbers: dict) -> None:
    """Part 6: 8 seeded requests resumed at k in RESIL_K (prompt plus k delivered
    tokens, the sampler fast-forwarded by k): each continuation equals the
    uninterrupted run, and the prompt half comes from the directory (remapped)."""
    from distributed_llama_tpu_torch.runtime.sampler import Sampler

    v = be.spec.vocab_size
    gen = torch.Generator().manual_seed(61)
    prompts = [[1] + torch.randint(3, v, (RESIL_RESUME_P - 1,), generator=gen).tolist()
               for _ in range(8)]

    def smp(i, ff=0):
        s = Sampler(v, 0.8, 0.9, 2000 + i)
        s.fast_forward(ff)
        return s
    _resil_fresh(be)
    # the uninterrupted runs one at a time: no request rides another's prefill, so every
    # generated token was ingested in an (8, 1) step
    refs = [be.submit(p, RESIL_RESUME_N, smp(i)).wait(timeout=600)
            for i, p in enumerate(prompts)]
    remapped = {}
    for k in RESIL_K:
        # 8 fillers take every slot, so the resumes find their prompts in the directory
        _resil_outs(_resil_submit(be, [[1, 300 + i] for i in range(8)], 2,
                                  [Sampler(v) for _ in range(8)]))
        r0 = be.remapped_blocks
        reqs = [None] * 8
        with be._slock:
            for i, p in enumerate(prompts):
                reqs[i] = be.submit(p + refs[i][:k], RESIL_RESUME_N - k, smp(i, k),
                                    resume_tokens=k)
        got = _resil_outs(reqs)
        bad = [i for i in range(8) if got[i] != refs[i][k:]]
        if bad:
            raise AssertionError(f"resil: resume at k={k} differs in requests {bad}")
        remapped[k] = be.remapped_blocks - r0
        if remapped[k] < 8 * (RESIL_RESUME_P // 16):
            raise AssertionError(f"resil: resume at k={k} remapped {remapped[k]} blocks")
    rows = [r for kept in _RESIL_ROWS for r in kept][:16]
    differ, total = _sampler_paths(rows, be.engine.device)
    numbers["resume"] = {"remapped_blocks": remapped, "sampler_paths_differ": differ,
                         "sampler_paths_picks": total}
    log(f"[resil] resume: 8 seeded requests resumed at k = {RESIL_K}: every "
        f"continuation identical to the uninterrupted run; blocks remapped {remapped}; "
        f"on {len(rows)} of the run's 7B logits rows x 256 coins (temperature 0.8, "
        f"top-p 0.9) the host Sampler's pick and the device sampler's differ in "
        f"{differ} of {total}")


def _resil_drain(be, prompts, ref8, numbers: dict) -> None:
    """Part 4: close(drain=True) with 8 requests in flight: a new submit gets
    EngineDraining and all 8 finish "length" with the fault-free tokens."""
    from distributed_llama_tpu_torch.resilience.errors import EngineDraining
    from distributed_llama_tpu_torch.runtime.sampler import Sampler

    v = be.spec.vocab_size
    _resil_fresh(be)
    reqs = _resil_submit(be, prompts, RESIL_TOKENS, [_resil_smp(i, v) for i in range(8)])
    _resil_until(lambda: all(r.out for r in reqs), what="every first token")
    t0 = time.perf_counter()
    th = threading.Thread(target=be.close, kwargs={"drain": True, "timeout": 120})
    th.start()
    _resil_until(lambda: be.draining, what="the drain")
    try:
        be.submit([1, 2], 2, Sampler(v))
        raise AssertionError("resil: a submit while draining was admitted")
    except EngineDraining:
        pass
    th.join(300)
    drain_s = time.perf_counter() - t0
    got = [r.wait(timeout=1) for r in reqs]
    if got != ref8 or any(r.finish != "length" for r in reqs):
        raise AssertionError("resil: the drained requests did not finish as fault-free")
    numbers["drain"] = {"drain_s": drain_s}
    log(f"[resil] drain: close(drain=True) with 8 requests in flight: a new submit got "
        f"EngineDraining, all 8 finished 'length' with the fault-free tokens, drained in "
        f"{drain_s:.3f} s")


def _resil_sse(url: str, body: dict, first: threading.Event, out: dict) -> None:
    req = urllib.request.Request(url + "/v1/chat/completions", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        out["status"] = r.status
        events = []
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: "):
                events.append(line[6:])
                first.set()
        out["events"] = events


def _resil_http(params, numbers: dict) -> None:
    """Part 7: the port's server on a fresh 8-slot engine: 503 with Retry-After under
    max_queue, 408 for an X-Deadline-Ms that expires in the queue, and an in-process
    begin_drain with a stream in flight: /healthz answers 503 "draining" and the stream
    completes."""
    from distributed_llama_tpu_torch.apps.api_server import begin_drain, serve
    from distributed_llama_tpu_torch.resilience import faults
    from distributed_llama_tpu_torch.resilience.faults import FaultSpec
    from distributed_llama_tpu_torch.runtime.sampler import Sampler
    from distributed_llama_tpu_torch.tokenizer import TemplateType, Tokenizer

    be = _resil_engine(params)
    with tempfile.TemporaryDirectory() as tmp:
        tpath = os.path.join(tmp, "synthetic.t")
        _synthetic_tokenizer(tpath, be.spec.vocab_size)
        be.tokenizer = Tokenizer.load(tpath)
    srv = serve(None, "127.0.0.1", 0, TemplateType.LLAMA2,
                Sampler(be.spec.vocab_size, 0.0, 0.9, 1), batch_engine=be)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    body = {"messages": [{"role": "user", "content": "hello w1 w7"}], "max_tokens": 8,
            "temperature": 0}

    def call(b, headers=None, path="/v1/chat/completions"):
        req = urllib.request.Request(url + path, None if b is None else
                                     json.dumps(b).encode(),
                                     {"Content-Type": "application/json",
                                      **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, dict(r.headers), r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read().decode()
    try:
        status, _, raw = call(body)  # warm: the graphs of this engine
        assert status == 200, raw
        hold = _ResilHold(be)
        got = {}
        try:
            be.max_queue = 1
            queued = be.submit([1, 2, 3], 4, Sampler(be.spec.vocab_size))
            shed = call(body)
            be.max_queue = 0
            th = threading.Thread(target=lambda: got.update(
                r=call(body, {"X-Deadline-Ms": str(RESIL_HOLD * 100)})))
            th.start()
            _resil_until(lambda: len(be._queue) == 2, what="the deadline request queued")
            time.sleep(RESIL_HOLD)
        finally:
            be.max_queue = 0
            hold.release()
        queued.cancel()
        th.join(300)
        code, headers, raw = shed
        if code != 503 or int(headers.get("Retry-After", 0)) < 1 or json.loads(
                raw)["error"]["type"] != "overloaded_error":
            raise AssertionError(f"resil http: shed {code} {headers} {raw}")
        code, _, raw = got["r"]
        if code != 408 or json.loads(raw)["error"]["type"] != "timeout_error":
            raise AssertionError(f"resil http: deadline {code} {raw}")
        # the drain: each dispatch held 200 ms, so the stream outlives the checks by
        # seconds
        first, out = threading.Event(), {}
        with faults.active(FaultSpec("batch.dispatch", kind="latency", delay_ms=200)):
            th = threading.Thread(target=_resil_sse, args=(
                url, {**body, "max_tokens": 48, "stream": True}, first, out))
            th.start()
            if not first.wait(300):
                raise AssertionError("resil http: the stream never started")
            drain = threading.Thread(target=begin_drain, args=(srv, srv.api_state, 120.0))
            drain.start()
            _resil_until(lambda: srv.api_state.draining, what="draining")
            code, _, raw = call(None, path="/healthz")
            if code != 503 or json.loads(raw)["status"] != "draining":
                raise AssertionError(f"resil http: /healthz {code} {raw}")
            th.join(600)
            drain.join(600)
        events = out.get("events", [])
        finish = json.loads(events[-2])["choices"][0]["finish_reason"] if len(
            events) >= 2 else None
        if out.get("status") != 200 or events[-1:] != ["[DONE]"] or finish not in (
                "length", "stop"):
            raise AssertionError(f"resil http: the drained stream: {out}")
        numbers["http"] = {"retry_after_header": headers.get("Retry-After")}
        log("[resil] http: 503 + Retry-After under max_queue, 408 for an X-Deadline-Ms "
            "expired in the queue, begin_drain with a stream in flight: /healthz 503 "
            f"'draining', the stream finished {finish!r}")
    finally:
        srv.server_close()
        be.close()


def phase_resil(state: dict) -> None:
    """Request control and recovery at Llama-2-7B on the serve phase's weights."""
    spec = _llama2_7b()
    params = _take_serve_params(state, "resil")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(29)
    prompts = [[1] + torch.randint(3, spec.vocab_size, (n - 1,), generator=gen).tolist()
               for n in RESIL_PROMPTS]
    numbers: dict = {"card": smi}
    be = _resil_engine(params)
    try:
        be.generate([1] + list(range(5, 40)), 10, _CheckedSampler(spec.vocab_size))
        ref8 = _resil_blast(be, prompts, numbers)
        _resil_fresh(be)
        t0 = time.perf_counter()
        again = _resil_outs(_resil_submit(be, prompts, RESIL_TOKENS,
                                          [_resil_smp(i, spec.vocab_size)
                                           for i in range(8)]))
        wall_ref = time.perf_counter() - t0
        if again != ref8:
            raise AssertionError("resil: two fault-free runs from one state differ")
        _resil_transient(be, prompts, ref8, wall_ref, numbers)
        _resil_admission(be, numbers)
        _resil_wedge(be, prompts, ref8, numbers)
        _resil_resume(be, numbers)
        _resil_drain(be, prompts, ref8, numbers)
    finally:
        be.close()
    _resil_http(params, numbers)
    log(f"[resil] {smi}: numbers " + json.dumps(numbers, default=float))
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ tenancy

TENANCY_P = 100  # the flood's prompt tokens
TENANCY_N = 128  # tokens a flood request
# the victim's tokens when the interactive request arrives: request 7, prefilled last,
# has 1 token after its prefill and 8 a super-step, so it is preempted with 17 tokens at
# the boundary after its 16th; re-admitted with prompt + 17 = 117 tokens, 7 blocks
# remapped, its 5-token tail prefilled one token a step: the (8, 1) shape it decoded in
TENANCY_AT = 16
TENANCY_INTERACTIVE = (24, 16)  # the interactive request's prompt tokens and tokens


def _counted_engine(params):
    """_resil_engine with its graphs counted (counting_graphs), warmed up."""
    be = _resil_engine(params)
    be.engine.graphs = counting_graphs(be.engine.device, _serve_counters())
    be.generate([1] + list(range(5, 40)), 10, _CheckedSampler(be.spec.vocab_size))
    return be


def _tenancy_run(be, prompts, samplers, interactive: list | None = None):
    """The 8 flood requests (tenant flood, class batch) admitted in one pass; with
    `interactive` (a prompt), request 7's callback submits it (tenant gold, class
    interactive) at its TENANCY_AT-th token. Returns (requests, interactive request)."""
    _resil_fresh(be)
    got: list = []

    def on_token(_t, n=[0]):
        n[0] += 1
        if interactive is not None and n[0] == TENANCY_AT:
            got.append(be.submit(list(interactive), TENANCY_INTERACTIVE[1],
                                 _CheckedSampler(be.spec.vocab_size), tenant="gold"))
    with be._slock:
        reqs = [be.submit(list(p), TENANCY_N, s, tenant="flood", klass="batch",
                          on_token=on_token if i == 7 else None)
                for i, (p, s) in enumerate(zip(prompts, samplers))]
    _resil_outs(reqs)
    if got:
        got[0].wait(timeout=600)
    return reqs, (got[0] if got else None)


def phase_tenancy(state: dict) -> None:
    """Tenancy at Llama-2-7B on the serve phase's weights (8 slots, superstep 8
    pipelined, prefix cache): an interactive arrival preempts the batch row with the
    least output, which resumes with its uninterrupted run's tokens."""
    from distributed_llama_tpu_torch.runtime.sampler import Sampler

    spec = _llama2_7b()
    params = _take_serve_params(state, "tenancy")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    v = spec.vocab_size
    gen = torch.Generator().manual_seed(37)
    prompts = [[1] + torch.randint(3, v, (TENANCY_P - 1,), generator=gen).tolist()
               for _ in range(8)]
    inter = [1] + torch.randint(3, v, (TENANCY_INTERACTIVE[0] - 1,), generator=gen).tolist()
    counters = _serve_counters()
    numbers: dict = {"card": smi}
    be = _counted_engine(params)
    try:
        for mode in ("greedy", "seeded"):
            def smps():
                return [_CheckedSampler(v) if mode == "greedy" or i < 4
                        else Sampler(v, 0.8, 0.9, 3000 + i) for i in range(8)]
            for times in be.dispatch_ms.values():
                times.clear()
            ref, _ = _tenancy_run(be, prompts, smps())
            period = float(np.mean(be.dispatch_ms["super"]))
            r0, m0, s0 = be.rollback_tokens, be.remapped_blocks, be.seed_bytes
            _zero(counters)
            snap = graph_snapshot(counters, be.engine.graphs)
            reqs, gold = _tenancy_run(be, prompts, smps(), inter)
            launches, replays, _new = run_launches(counters, be.engine.graphs, snap)
            victim = reqs[7]
            if [r.preemptions for r in reqs] != [0] * 7 + [1] or gold.preemptions:
                raise AssertionError(f"tenancy ({mode}): preemptions "
                                     f"{[r.preemptions for r in reqs]}, gold "
                                     f"{gold.preemptions}")
            if victim.out != ref[7].out:
                first = next(i for i, (a, b) in enumerate(zip(victim.out, ref[7].out))
                             if a != b)
                raise AssertionError(f"tenancy ({mode}): the victim's tokens differ from "
                                     f"its uninterrupted run from token {first}")
            prefilled = victim.stats.prompt_tokens - victim.stats.reused_tokens
            remapped = be.remapped_blocks - m0
            if remapped < 1 or prefilled > 16 or len(gold.out) != TENANCY_INTERACTIVE[1]:
                raise AssertionError(f"tenancy ({mode}): re-admission remapped {remapped} "
                                     f"blocks and prefilled {prefilled} tokens; gold "
                                     f"{len(gold.out)} tokens")
            if min(launches.values()) <= 0:
                raise AssertionError(f"tenancy ({mode}): launches {launches}")
            ttft = (gold.first_token_t - gold.submit_t) * 1e3
            numbers[mode] = {
                "interactive_ttft_ms": ttft, "superstep_period_ms": period,
                "interactive_queue_ms": (gold.admit_t - gold.submit_t) * 1e3,
                "interactive_prefill_ms": gold.stats.prefill_ms,
                "victim_out_at_preemption": victim.stats.prompt_tokens - TENANCY_P,
                "victim_prefilled_tokens": prefilled,
                "victim_reused_tokens": victim.stats.reused_tokens,
                "remapped_blocks": remapped, "seed_bytes": be.seed_bytes - s0,
                "rollback_tokens": be.rollback_tokens - r0, "launches": launches,
                "graph_replays": replays}
            mix = "4 greedy and 4 seeded" if mode == "seeded" else "greedy"
            log(f"[tenancy] {mode}: 8 batch requests of tenant flood ({TENANCY_P}-token "
                f"prompts, {TENANCY_N} tokens, {mix}); "
                f"an interactive request of tenant gold ({TENANCY_INTERACTIVE[0]}-token "
                f"prompt) arrived at request 7's token {TENANCY_AT} and preempted it at "
                f"{victim.stats.prompt_tokens - TENANCY_P} tokens: TTFT {ttft:.2f} ms "
                f"({(gold.admit_t - gold.submit_t) * 1e3:.2f} ms to its admission, "
                f"{gold.stats.prefill_ms:.2f} ms in its prefill dispatches) against a "
                f"super-step period of {period:.2f} ms; the victim's "
                f"{TENANCY_N} tokens identical to its uninterrupted run; re-admission "
                f"remapped {remapped} blocks ({be.seed_bytes - s0} seed bytes) and "
                f"prefilled {prefilled} tokens; {be.rollback_tokens - r0} rollback tokens; "
                f"launches {json.dumps(launches)} ({replays} graph replays)")
    finally:
        be.close()
    log(f"[tenancy] {smi}: numbers " + json.dumps(numbers, default=float))
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ disaggregated prefill

# the split prompt's tokens: 32 full blocks shipped and a 5-token tail, which both the
# monolithic run and the split prefill one token a step (the chunk rule takes 64-token
# chunks up to 512), so their dispatch shapes match and the tokens are bit-identical
DISAGG_P = 517
DISAGG_N = 32


def _disagg_messages(tok, template, n: int) -> list:
    """Chat messages whose rendered prompt is `n` tokens: one user turn of letters, each
    a byte-fallback token of the synthetic tokenizer."""
    from distributed_llama_tpu_torch.tokenizer import ChatItem

    gen = np.random.default_rng(41)
    size = n
    for _ in range(8):
        text = "".join(chr(97 + int(c)) for c in gen.integers(0, 22, size))
        got = len(tok.encode(template.generate([ChatItem("user", text)]), add_bos=True))
        if got == n:
            return [{"role": "user", "content": text}]
        size += n - got
    raise AssertionError(f"disagg: no prompt of {n} tokens (last {got})")


def _disagg_stream(url: str, body: dict, headers: dict | None = None) -> dict:
    """A streamed completion in journal mode: its token ids, text, and the seconds to
    its first chunk."""
    req = urllib.request.Request(url + "/v1/chat/completions", json.dumps(body).encode(),
                                 {"Content-Type": "application/json",
                                  "X-Dllama-Journal": "1", **(headers or {})})
    t0 = time.perf_counter()
    toks, first = [], None
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            payload = json.loads(line[6:])
            if "error" in payload:
                raise AssertionError(f"disagg: stream error {payload}")
            if first is None:
                first = time.perf_counter()
            toks.extend(payload.get("dllama", {}).get("toks", []))
    return {"toks": toks, "t0": t0, "first": first}


def _kv_post(url: str, messages: list) -> tuple[dict, float]:
    req = urllib.request.Request(url + "/v1/kv",
                                 json.dumps({"messages": messages}).encode(),
                                 {"Content-Type": "application/json", "X-Tenant": "gold",
                                  "X-Class": "batch"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read()), t0


def phase_disagg(state: dict) -> None:
    """Disaggregated prefill at Llama-2-7B on the serve phase's weights: two port
    servers in this process (roles prefill and decode, each its own 8-slot engine on the
    same weights); this script plays the router: POST /v1/kv to the prefill server, then
    the completion with that kv_source to the decode server."""
    from distributed_llama_tpu_torch.apps.api_server import serve
    from distributed_llama_tpu_torch.runtime.sampler import Sampler
    from distributed_llama_tpu_torch.tokenizer import ChatTemplate, TemplateType, Tokenizer

    spec = _llama2_7b()
    params = _take_serve_params(state, "disagg")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    counters = _serve_counters()
    engines, servers = [], []
    numbers: dict = {"card": smi}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tpath = os.path.join(tmp, "synthetic.t")
            _synthetic_tokenizer(tpath, spec.vocab_size)
            tok = Tokenizer.load(tpath)
        for role in ("prefill", "decode"):
            be = _counted_engine(params)
            be.tokenizer = tok
            srv = serve(None, "127.0.0.1", 0, TemplateType.LLAMA2,
                        Sampler(spec.vocab_size, 0.0, 0.9, 1), batch_engine=be, role=role)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            engines.append(be)
            servers.append(srv)
        pre, dec = engines
        purl, durl = (f"http://127.0.0.1:{s.server_address[1]}" for s in servers)
        for url, role in ((purl, "prefill"), (durl, "decode")):
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                if json.loads(r.read())["replica"]["role"] != role:
                    raise AssertionError(f"disagg: /healthz role of the {role} server")
        template = ChatTemplate(TemplateType.LLAMA2, tok.chat_template, tok.eos_piece())
        messages = _disagg_messages(tok, template, DISAGG_P)
        body = {"messages": messages, "max_tokens": DISAGG_N, "temperature": 0,
                "stream": True}
        _resil_fresh(dec)
        mono = _disagg_stream(durl, body)
        mono_ttft = (mono["first"] - mono["t0"]) * 1e3
        runs = {}
        for wire in ("raw", "q80"):
            servers[0].api_state.kv_wire_q80 = wire == "q80"
            _resil_fresh(dec)
            e0, x0 = pre.export_ms, pre.exported_blocks
            p0, s0, sm0, m0 = (dec.prefilled_tokens, dec.seed_bytes, dec.seed_ms,
                               dec.remapped_blocks)
            _zero(counters)
            snaps = [graph_snapshot(counters, be.engine.graphs) for be in engines]
            desc, t0 = _kv_post(purl, messages)
            t_desc = time.perf_counter()
            got = _disagg_stream(durl, {**body, "kv_source": {
                **desc, "replica": f"127.0.0.1:{servers[0].server_address[1]}"}})
            launches, _r, _n = run_launches(
                counters, pre.engine.graphs, snaps[0],
                more=[(dec.engine.graphs, snaps[1])])
            rec = servers[1].api_state.last_import or {}
            n_blocks = pre.exported_blocks - x0
            runs[wire] = {
                "split_ttft_ms": (got["first"] - t0) * 1e3,
                "kv_post_ms": (t_desc - t0) * 1e3,
                "export_ms": pre.export_ms - e0, "exported_blocks": n_blocks,
                "export_ms_per_block": (pre.export_ms - e0) / max(n_blocks, 1),
                "wire_bytes": rec.get("bytes"), "fetch_decode_ms": rec.get("fetch_ms"),
                "insert_cold_ms": rec.get("insert_ms"),
                "promotion_seed_ms": dec.seed_ms - sm0, "seed_bytes": dec.seed_bytes - s0,
                "remapped_blocks": dec.remapped_blocks - m0,
                "decode_prefilled_tokens": dec.prefilled_tokens - p0, "launches": launches}
            r = runs[wire]
            if (desc.get("n_tokens") != DISAGG_P // 16 * 16 or desc.get("wire") != wire
                    or rec.get("outcome") != "imported"
                    or r["decode_prefilled_tokens"] != DISAGG_P % 16
                    or len(got["toks"]) != DISAGG_N or min(launches.values()) <= 0):
                raise AssertionError(f"disagg ({wire}): descriptor {desc}, import {rec}, "
                                     f"run {r}, {len(got['toks'])} tokens")
            if wire == "raw" and got["toks"] != mono["toks"]:
                raise AssertionError("disagg: the split's tokens differ from the "
                                     "monolithic run's")
            log(f"[disagg] {wire} wire: /v1/kv on the prefill server {r['kv_post_ms']:.1f} "
                f"ms (export {r['export_ms']:.1f} ms for {n_blocks} blocks, "
                f"{r['export_ms_per_block']:.2f} ms a block); {r['wire_bytes']} wire bytes "
                f"fetched and decoded in {r['fetch_decode_ms']:.1f} ms, insert_cold "
                f"{r['insert_cold_ms']:.1f} ms; admission promoted {r['remapped_blocks']} "
                f"blocks ({r['seed_bytes']} seed bytes, {r['promotion_seed_ms']:.1f} ms) "
                f"and prefilled {r['decode_prefilled_tokens']} tokens; split TTFT "
                f"{r['split_ttft_ms']:.1f} ms against monolithic {mono_ttft:.1f} ms"
                + ("; tokens identical to the monolithic run" if wire == "raw" else "")
                + f"; launches {json.dumps(launches)}")
        if not runs["q80"]["wire_bytes"] < runs["raw"]["wire_bytes"]:
            raise AssertionError(f"disagg: the Q80 wire shipped "
                                 f"{runs['q80']['wire_bytes']} bytes, the raw "
                                 f"{runs['raw']['wire_bytes']}")
        numbers.update(monolithic_ttft_ms=mono_ttft, **runs)
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        for be in engines:
            be.close()
    log(f"[disagg] {smi}: numbers " + json.dumps(numbers, default=float))
    del params, engines
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ observability

# the obs phase's served run: 8 chat requests, each started at the previous one's first
# streamed token, OBS_TOKENS greedy tokens each (the synthetic tokenizer has no stop in
# its byte tokens' reach, so each runs to its budget unless it samples </s>)
OBS_REQUESTS = 8
OBS_TOKENS = 64
# the steady-state period runs: 8 requests admitted in one pass, short prompts,
# OBS_PERIOD_TOKENS tokens each (OBS_PERIOD_TOKENS / SERVE_K full super-steps)
OBS_PERIOD_TOKENS = 96
# iterations of the disabled per-dispatch bundle, and replays of the one-token graph
OBS_BUNDLE_ITERS = 200_000
OBS_REPLAYS = 50
_PROM_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*")*\})? '
    r"(-?\d+(\.\d+)?([eE][+-]?\d+)?|\+Inf|-Inf|NaN)$")


def _prometheus_samples(text: str) -> dict:
    """The strict exposition rule (every non-comment line a valid sample of a family
    declared by a # TYPE line above it); {sample with labels: value}."""
    if not text.endswith("\n"):
        raise AssertionError("obs: /metrics does not end with a newline")
    samples, typed = {}, set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            typed.add(line.split()[2])
        if not line or line.startswith("#"):
            continue
        if not _PROM_SAMPLE.match(line):
            raise AssertionError(f"obs: bad exposition line {line!r}")
        name, val = line.rsplit(" ", 1)
        base = name.split("{")[0]
        if base not in typed and re.sub(r"_(bucket|sum|count)$", "", base) not in typed:
            raise AssertionError(f"obs: sample {base} without a # TYPE line")
        samples[name] = float(val.replace("+Inf", "inf"))
    return samples


def _obs_bundle_us() -> float:
    """Microseconds of the per-dispatch instrumentation with the tracer and the flight
    recorder off (the JAX package's perf/obs_overhead.py bundle, without its constrain
    scan, which the port does not have): a disabled span with its args dict, two clock
    reads, a histogram observe, a counter inc, a disabled flight event and a trace
    context re-entry."""
    from distributed_llama_tpu_torch.obs import flight, metrics, reqctx, trace

    trace.uninstall()
    flight.uninstall()
    hist = metrics.histogram("obs_overhead_bench_seconds", "bench-only")
    ctr = metrics.counter("obs_overhead_bench_total", "bench-only")
    ctx = reqctx.new_context("req-bench")
    try:
        t_start = time.perf_counter()
        for i in range(OBS_BUNDLE_ITERS):
            with reqctx.use(ctx):
                with trace.span("engine.dispatch", {"t": 1, "pos": i}):
                    pass
                t0 = time.perf_counter()
                hist.observe(time.perf_counter() - t0)
                ctr.inc()
                flight.event("req-bench", "super_step", k=8, delivered=8)
        return (time.perf_counter() - t_start) / OBS_BUNDLE_ITERS * 1e6
    finally:
        flight.install()  # the server's always-on recorder, as serve() installs it


def _obs_flight_event_us(n: int = 20_000) -> float:
    """Microseconds of one flight.event with a recorder installed (a delivery records
    one per row of a super-step)."""
    from distributed_llama_tpu_torch.obs import flight

    rec = flight.FlightRecorder(capacity=64, live_capacity=64, max_events=n + 1)
    rec.start("req-bench")
    t0 = time.perf_counter()
    for _ in range(n):
        rec.event("req-bench", "super_step", k=8, budget=8, delivered=8, chained=True)
    return (time.perf_counter() - t0) / n * 1e6


def _obs_replay_ms(spec, params) -> tuple[float, object]:
    """Device ms of one Llama-2-7B one-token CUDA graph replay (the single-sequence
    Engine's step on the serve weights, CUDA events over OBS_REPLAYS replays), and the
    engine."""
    from distributed_llama_tpu_torch.runtime.engine import Engine

    eng = Engine(spec, params, device="cuda", prefill_kernel=True)
    eng.generate([1] + list(range(5, 40)), 4, _CheckedSampler(spec.vocab_size))
    key = next(k for k in eng.graphs.keys() if k[0] == "step")
    g = eng.graphs.graph(key)
    for _ in range(3):
        g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(OBS_REPLAYS):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / OBS_REPLAYS, eng


def _obs_period_ms(be, prompts, tracer: bool, recorder: bool) -> float:
    """Steady-state super-step period per step (ms): the 8 requests admitted in one
    pass, the mean of their delivered super-steps' dispatch times over SERVE_K, the
    tracer (annotated) and the flight recorder on or off."""
    from distributed_llama_tpu_torch.obs import flight, trace

    trace.uninstall()
    if tracer:
        trace.install(annotate=True)
    if not recorder:
        flight.uninstall()
    elif flight.current() is None:
        flight.install()
    try:
        _resil_fresh(be)
        for times in be.dispatch_ms.values():
            times.clear()
        with be._slock:
            reqs = [be.submit(list(p), OBS_PERIOD_TOKENS, _CheckedSampler(be.spec.vocab_size))
                    for p in prompts]
        _resil_outs(reqs)
        sup = list(be.dispatch_ms["super"])[2:]
        return float(np.mean(sup)) / SERVE_K
    finally:
        trace.uninstall()
        if flight.current() is None:
            flight.install()


def _obs_sse(url: str, body: dict, tid: str, first: threading.Event, out: dict) -> None:
    """One streamed completion with its own traceparent: its id, text chunks and
    finish; `first` is set at its first chunk."""
    req = urllib.request.Request(
        url + "/v1/chat/completions", json.dumps(body).encode(),
        {"Content-Type": "application/json", "traceparent": f"00-{tid}-{'5a' * 8}-01"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            out["id"] = r.headers.get("X-Request-Id")
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                payload = json.loads(line[6:])
                if "error" in payload:
                    raise AssertionError(f"obs: stream error {payload['error']}")
                first.set()
                fin = payload["choices"][0]["finish_reason"]
                if fin:
                    out["finish"] = fin
    except Exception as e:  # noqa: BLE001 — reported by the caller
        out["error"] = e
    finally:
        first.set()


def _obs_get(url: str, path: str):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.status, r.read().decode()


def _obs_annotation(be, eng) -> str:
    """Under torch.profiler (started on this thread) with the tracer annotating: a
    scheduler-thread super-step's issue range around its graph launch, or, where the
    profiler records no range of the scheduler thread, the single-sequence Engine's
    engine.dispatch range around its step's graph launch. Returns which one held."""
    from distributed_llama_tpu_torch.obs import trace

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def enclosed(prof, name):
        evs = prof.events()
        ranges = [e for e in evs if e.name == name]
        launches = [e for e in evs if "GraphLaunch" in e.name]
        return ranges, any(r.time_range.start <= g.time_range.start
                           and g.time_range.end <= r.time_range.end
                           for r in ranges for g in launches)

    trace.install(annotate=True)
    try:
        _resil_fresh(be)
        with torch.profiler.profile(activities=acts) as prof:
            be.generate([1] + list(range(7, 30)), 3 * SERVE_K, _CheckedSampler(
                be.spec.vocab_size))
            torch.cuda.synchronize()
        ranges, ok = enclosed(prof, "batch.super_step_issue")
        if ok:
            return f"scheduler thread: {len(ranges)} batch.super_step_issue ranges"
        with torch.profiler.profile(activities=acts) as prof:
            eng.infer_chunk([5])
            torch.cuda.synchronize()
        eranges, eok = enclosed(prof, "engine.dispatch")
        if not eok:
            raise AssertionError(
                f"obs: no annotated range encloses a graph launch ({len(ranges)} "
                f"batch.super_step_issue ranges from the scheduler thread, "
                f"{len(eranges)} engine.dispatch ranges from the main thread)")
        return (f"main thread only ({len(ranges)} batch.super_step_issue ranges from the "
                f"scheduler thread enclose no graph launch): engine.dispatch encloses "
                f"the Engine's graph launch")
    finally:
        trace.uninstall()


def phase_obs(state: dict) -> None:
    """Observability at Llama-2-7B on the serve weights (8 slots, superstep 8 pipelined,
    prefix cache on): the port's server with the tracer annotating serves 8 staggered
    streamed requests, each with its own traceparent; the counters' deltas against the
    engine's own counts, the strict exposition, the flight records, the Chrome trace and
    the profiler ranges; then the costs: the disabled per-dispatch bundle against a
    one-token graph replay (under 1%), and the serving period with the tracer and the
    flight recorder on and off."""
    from distributed_llama_tpu_torch.apps.api_server import serve
    from distributed_llama_tpu_torch.obs import flight, metrics, trace
    from distributed_llama_tpu_torch.ops import matmul as matmul_ops
    from distributed_llama_tpu_torch.runtime.sampler import Sampler
    from distributed_llama_tpu_torch.tokenizer import TemplateType, Tokenizer

    spec = _llama2_7b()
    params = _take_serve_params(state, "obs")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    numbers: dict = {"card": smi}
    replay_ms, eng = _obs_replay_ms(spec, params)
    bundle_us = _obs_bundle_us()
    numbers.update(replay_ms=replay_ms, bundle_us=bundle_us,
                   bundle_share=bundle_us / (replay_ms * 1e3),
                   flight_event_us=_obs_flight_event_us())
    if numbers["bundle_share"] >= 0.01:
        raise AssertionError(f"obs: the disabled bundle takes {bundle_us:.3f} us, "
                             f"{100 * numbers['bundle_share']:.2f}% of a {replay_ms:.3f} "
                             "ms one-token graph replay (the gate is 1%)")
    be = _resil_engine(params)
    with tempfile.TemporaryDirectory() as tmp:
        tpath = os.path.join(tmp, "synthetic.t")
        _synthetic_tokenizer(tpath, spec.vocab_size)
        be.tokenizer = Tokenizer.load(tpath)
    be.generate([1] + list(range(5, 40)), 10, _CheckedSampler(spec.vocab_size))
    trace.install(annotate=True)  # the server's --trace --trace-annotate
    srv = serve(None, "127.0.0.1", 0, TemplateType.LLAMA2,
                Sampler(spec.vocab_size, 0.0, 0.9, 1), batch_engine=be)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        snap0 = metrics.snapshot()
        kernels0 = dict(snap0.get("matmul_kernel_selected_total", {}))
        matmul_ops.reset_kernel_selections()
        c0 = (be.super_steps, be.prefilled_tokens)
        tids = [f"{i + 1:032x}" for i in range(OBS_REQUESTS)]
        outs = [{} for _ in tids]
        firsts = [threading.Event() for _ in tids]
        threads = []
        t0 = time.perf_counter()
        for i, tid in enumerate(tids):
            body = {"messages": [{"role": "user", "content": f"hello w{i} w{3 * i + 1}"}],
                    "max_tokens": OBS_TOKENS, "temperature": 0, "stream": True}
            th = threading.Thread(target=_obs_sse, args=(url, body, tid, firsts[i],
                                                         outs[i]))
            th.start()
            threads.append(th)
            firsts[i].wait(600)
        for th in threads:
            th.join(900)
        wall = time.perf_counter() - t0
        for i, o in enumerate(outs):
            if "error" in o or o.get("finish") not in ("length", "stop"):
                raise AssertionError(f"obs: request {i}: {o}")
        snap1 = metrics.snapshot()

        def grew(name, key="{}"):
            def val(s):
                v = s.get(name, 0)
                return v.get(key, 0) if isinstance(v, dict) else v
            return val(snap1) - val(snap0)

        # the flight records: the request-level numbers and the scheduler's events
        recs = []
        for i, o in enumerate(outs):
            status, raw = _obs_get(url, f"/v1/requests/{o['id']}")
            rec = json.loads(raw)
            names = {e["event"] for e in rec["events"]}
            if (status != 200 or rec["trace_id"] != tids[i] or rec["finish"] != o["finish"]
                    or not {"admitted", "prefill_chunk", "super_step"} <= names):
                raise AssertionError(f"obs: request {i}'s flight record {rec}")
            recs.append(rec)
        status, raw = _obs_get(url, "/v1/requests?slowest=3")
        if status != 200 or len(json.loads(raw)["completed"]) != 3:
            raise AssertionError(f"obs: /v1/requests?slowest=3 answered {raw[:300]}")
        delivered = sum(r["tokens"] for r in recs)
        finishes = collections.Counter(r["finish"] for r in recs)
        sup_count = (snap1["batch_dispatch_seconds"]['{kind="super_step"}']["count"]
                     - snap0["batch_dispatch_seconds"].get('{kind="super_step"}',
                                                           {"count": 0})["count"])
        checks = {
            "batch_decode_tokens_total": (grew("batch_decode_tokens_total"), delivered),
            "batch_prefill_tokens_total": (grew("batch_prefill_tokens_total"),
                                           be.prefilled_tokens - c0[1]),
            "batch_dispatch_seconds{kind=super_step} count": (sup_count,
                                                              be.super_steps - c0[0]),
        }
        for fin, n in finishes.items():
            checks[f"batch_requests_total{{finish={fin}}}"] = (
                grew("batch_requests_total", f'{{finish="{fin}"}}'), n)
        off = {k: v for k, v in checks.items() if v[0] != v[1]}
        if off:
            raise AssertionError(f"obs: counters against the engine's counts {off}")
        kernels1 = metrics.snapshot()["matmul_kernel_selected_total"]
        picked = {k: kernels1[k] - kernels0.get(k, 0) for k in kernels1}
        sel = set(matmul_ops.kernel_selections().values())
        want = {"q4_mm", "q4_mm+res", "q4_gated_mm"}
        if (not all(picked.get(f'{{kernel="{k}"}}', 0) > 0 for k in want)
                or picked.get('{kernel="dequant"}', 0) or not sel <= want):
            raise AssertionError(f"obs: kernel selections {picked}, {sel}")
        # the exposition, under the strict rule
        samples = _prometheus_samples(_obs_get(url, "/metrics")[1])
        # the Chrome trace: super-step spans in sequence on the scheduler thread, every
        # request's trace id on its scheduler-side events
        doc = json.loads(_obs_get(url, "/v1/trace")[1])
        evs = doc["traceEvents"]
        supers = sorted((e for e in evs if e.get("name") == "batch.super_step"),
                        key=lambda e: e["ts"])
        overlap = [(a["ts"], b["ts"]) for a, b in zip(supers, supers[1:])
                   if a["ts"] + a["dur"] > b["ts"] + 1e-3]
        stamped = collections.defaultdict(set)
        for e in evs:
            t = (e.get("args") or {}).get("trace_id")
            if t:
                stamped[t].add(e["name"])
        # a request's prefill chunks are batch.prefill, or batch.mixed_step where
        # decode rows ride them
        missing = [t for t in tids if "batch.row_delivered" not in stamped.get(t, set())
                   or not {"batch.prefill", "batch.mixed_step"} & stamped[t]]
        issue_ms = [e["dur"] / 1e3 for e in evs if e.get("name") == "batch.super_step_issue"]
        if not supers or not issue_ms or overlap or missing:
            raise AssertionError(f"obs: {len(supers)} batch.super_step spans, overlapping "
                                 f"{overlap[:3]}; trace ids without their spans {missing}")
        numbers["served"] = {
            "requests": OBS_REQUESTS, "tokens": delivered, "wall_s": wall,
            "finishes": dict(finishes), "super_steps": be.super_steps - c0[0],
            "prefilled_tokens": be.prefilled_tokens - c0[1],
            "metrics_samples": len(samples), "trace_events": len(evs),
            "super_step_spans": len(supers),
            "super_step_span_ms": float(np.mean([e["dur"] for e in supers]) / 1e3),
            "super_step_issue_ms": float(np.mean(issue_ms)),
            "ttft_ms": float(np.mean([r["ttft_ms"] for r in recs])),
            "kernels_selected": picked}
        log(f"[obs] {smi}: 8 staggered streamed requests with their own traceparent, "
            f"{delivered} tokens in {wall:.2f} s: batch_decode_tokens_total, "
            f"batch_prefill_tokens_total, batch_requests_total and the super-step "
            f"dispatch count equal the engine's counts ({json.dumps(checks)}); "
            f"{len(samples)} exposition samples pass the strict rule; every flight "
            f"record holds admitted, prefill_chunk and super_step; {len(supers)} "
            f"batch.super_step spans (mean {numbers['served']['super_step_span_ms']:.3f} "
            f"ms) in sequence, issue spans mean "
            f"{numbers['served']['super_step_issue_ms']:.3f} ms; every trace id on its "
            f"prefill (or mixed) span and batch.row_delivered instants; kernels selected "
            f"{picked}")
    finally:
        srv.shutdown()
        srv.server_close()
        trace.uninstall()
    try:
        numbers["annotation"] = _obs_annotation(be, eng)
        log(f"[obs] torch.profiler with annotated spans: {numbers['annotation']}")
        gen = torch.Generator().manual_seed(53)
        prompts = [[1] + torch.randint(3, spec.vocab_size, (7,), generator=gen).tolist()
                   for _ in range(8)]
        periods = {}
        for tag, tr, rec in (("defaults", False, True), ("tracer", True, True),
                             ("defaults", False, True), ("tracer", True, True),
                             ("no_flight", False, False)):
            periods.setdefault(tag, []).append(_obs_period_ms(be, prompts, tr, rec))
        numbers["period_ms"] = periods
        log(f"[obs] {smi}: disabled bundle {bundle_us:.3f} us = "
            f"{100 * numbers['bundle_share']:.4f}% of a {replay_ms:.3f} ms Llama-2-7B "
            f"one-token graph replay; flight event {numbers['flight_event_us']:.2f} us "
            f"(x8 rows a delivery); super-step period per step, 8 rows: "
            + ", ".join(f"{k} {', '.join(f'{p:.3f}' for p in v)} ms"
                        for k, v in periods.items()))
    finally:
        be.close()
    log(f"[obs] {smi}: numbers " + json.dumps(numbers, default=float))
    del params, be, eng
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ constrained decoding

# the grammars of tests/test_constrain.py: the schema (forced chains: the grammar
# proposer drafts them) and the branchy regex (no forced chain: the masked super-step)
CONSTRAIN_SCHEMA = {"type": "object", "properties": {
    "name": {"enum": ["alpha", "beta"]}, "ok": {"type": "boolean"}}}
CONSTRAIN_REGEX = "[a-z]{24}"
CONSTRAIN_PROMPTS = (21, 48, 17, 60, 33, 25, 52, 40)  # inside the first 256-position window
CONSTRAIN_TOKENS = 48


def _constrain_vocab(vocab_size: int):
    """The synthetic tokenizer's served vocab (`_synthetic_tokenizer`: its <0xNN> byte
    tokens spell every byte, so grammars compile against it) and its EOS id."""
    from distributed_llama_tpu_torch.constrain import vocab_bytes
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "synthetic.t")
        _synthetic_tokenizer(path, vocab_size)
        tok = Tokenizer.load(path)
    return vocab_bytes(tok), tok.eos_id


def _constrain_valid(aut, out: list[int], eos: int, what: str) -> None:
    """A constrained output is grammar-valid: the stream up to its first EOS is a word of
    the grammar (EOS then repeats: the done state's self-loop), or, without an EOS, a
    prefix of one."""
    if eos in out:
        i = out.index(eos)
        ok = set(out[i:]) == {eos} and aut.validate(out[:i + 1]) == (True, True)
    else:
        ok = aut.validate(out)[0]
    if not ok:
        raise AssertionError(f"{what}: output leaves its grammar: {out}")


def _constrain_run(be, prompts, grammars, seeded: bool) -> tuple[list, list]:
    """The 8 requests admitted in one pass (submitted under the scheduler lock), the
    grammars attached where given; odd rows seeded (temperature 0.8, top-p 0.9) when
    `seeded`. Returns (outputs, requests)."""
    from distributed_llama_tpu_torch.runtime.sampler import Sampler

    v = be.spec.vocab_size
    smps = [Sampler(v, 0.8, 0.9, 300 + i) if seeded and i % 2 else _CheckedSampler(v)
            for i in range(len(prompts))]
    with be._slock:
        reqs = [be.submit(list(p), CONSTRAIN_TOKENS, s,
                          **({} if g is None else dict(constraint=g[0],
                                                       constraint_hash=g[1])))
                for p, s, g in zip(prompts, smps, grammars)]
    outs = [r.wait(timeout=600) for r in reqs]
    be.release_idle()
    return outs, reqs


def _metric_sum(name: str, label: str = "") -> float:
    """A counter family's total (over the samples whose labels contain `label`)."""
    from distributed_llama_tpu_torch.obs import metrics

    v = metrics.snapshot().get(name, 0)
    if isinstance(v, dict):
        return float(sum(x for k, x in v.items() if label in k))
    return float(v)


def _constrain_step_ms(be, auts) -> dict:
    """Device ms of one batched step of the 8-slot engine, masked against unmasked: a
    super-step of SERVE_K steps over SERVE_K, and the verify buckets, greedy, rows 0-1
    under the schema, 2-3 under the regex, 4-7 on the universal state, every row at
    positions 200-221 (window 256), by CUDA events over graph replays."""
    eng = be.engine
    starts = [200 + 3 * i for i in range(8)]
    rng = np.zeros((8, 2), np.int64)
    window = eng._window_for(256)
    out = {}
    with be._slock:  # the scheduler is idle; this thread drives the loops
        tbl = be.constrain_table
        offs = [tbl.alloc(i, auts[i // 2]) for i in range(4)]
        cons = ([o for o in offs] + [0] * 4, *tbl.device())
        try:
            for sl in be._slots:
                be._paged_ensure(sl, 256)
            tables = be._tables()
            for masked in (False, True):
                kw = dict(constrain=cons) if masked else {}
                loop = be._batched_loop(SERVE_K, "greedy", window, masked)
                out[(1, masked)] = event_ms(
                    lambda i: loop(eng.rope, [5] * 8, eng.k_cache, eng.v_cache, starts,
                                   rng, [0.0] * 8, [0.9] * 8, [SERVE_K] * 8, tables, **kw),
                    10) / SERVE_K
                for t in SPEC_BUCKETS:
                    vloop = be._verify_loop(t, "greedy", window, masked)
                    props = [[5] * t for _ in range(8)]
                    out[(t, masked)] = event_ms(
                        lambda i: vloop(eng.rope, props, eng.k_cache, eng.v_cache, starts,
                                        rng, [0.0] * 8, [0.9] * 8, [t - 1] * 8, tables,
                                        **kw), 20)
        finally:
            for i in range(4):
                tbl.free(i)
    free = be.release_idle()
    if free != be.kv_pool.n_blocks - 1:
        raise AssertionError(f"constrain: {free} blocks free after the step timing")
    return out


def phase_constrain(state: dict) -> None:
    """Grammar-constrained decoding at Llama-2-7B on the serve weights (8 slots,
    superstep 8 pipelined, speculative 8): 8 requests of 48 tokens admitted together, 2
    under the JSON schema, 2 under the branchy regex, 4 unconstrained co-batched. Every
    constrained output is valid; with speculation off, the unconstrained rows are
    byte-identical to the batch with no grammar attached (the same dispatch shapes) and
    each constrained greedy row equals its unconstrained stream up to the grammar's first
    veto; seeded runs repeat; speculation on (the grammar proposer drafting forced
    chains into masked verify blocks) gives speculation off's tokens (greedy under the
    near-tie rule `_held`; each seeded run held exactly at its own dispatch shapes,
    `_seeded_pair`, the two runs parting only where each run's own logits pick another
    token with the same coin); the masked graphs replay; nothing degrades. Then ms
    per masked step against the unmasked one, the grammar compile at V = 32000, and the
    grammar proposer's accept rate."""
    from distributed_llama_tpu_torch.constrain import automaton, compile_grammar
    from distributed_llama_tpu_torch.constrain.compiler import schema_to_regex

    spec = _llama2_7b()
    params = _take_serve_params(state, "constrain")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    vocab, eos = _constrain_vocab(spec.vocab_size)
    numbers: dict = {"card": smi, "compile_ms": {}}
    grammars = []
    for kind, src, pattern in (("json_schema", CONSTRAIN_SCHEMA,
                                schema_to_regex(CONSTRAIN_SCHEMA)),
                               ("regex", CONSTRAIN_REGEX, CONSTRAIN_REGEX)):
        # a cold compile is the uncached lowering (an earlier phase may have filled the
        # LRU cache with these grammars); compile_grammar's own call may be a hit
        t0 = time.perf_counter()
        automaton.regex_token_automaton(pattern, vocab, eos)
        numbers["compile_ms"][kind] = (time.perf_counter() - t0) * 1e3
        grammars.append(compile_grammar(kind, src, vocab, eos))
    auts = [g[0] for g in grammars]
    per_row = [grammars[0], grammars[0], grammars[1], grammars[1]] + [None] * 4
    gen = torch.Generator().manual_seed(37)
    prompts = [[1] + torch.randint(3, spec.vocab_size, (n - 1,), generator=gen).tolist()
               for n in CONSTRAIN_PROMPTS]
    tap = _SampleTap(spec.vocab_size).__enter__()  # before any graph is captured
    be = _serve_engine(params, SERVE_K, SPEC_K)
    eng = be.engine
    degraded0 = _metric_sum("constrain_degraded_total")
    try:
        k = be.spec_k
        be.spec_k = 0
        off, _ = _constrain_run(be, prompts, per_row, False)
        plain, _ = _constrain_run(be, prompts, [None] * 8, False)
        tap.take()
        off_s, _ = _constrain_run(be, prompts, per_row, True)
        rec_off = tap.take()
        again_s, _ = _constrain_run(be, prompts, per_row, True)
        be.spec_k = k
        # the main path: speculation on, the counts zeroed just before and read after
        counters = _serve_counters()
        _zero(counters)
        snap = graph_snapshot(counters, eng.graphs)
        drafted0 = _metric_sum("batch_spec_proposer_drafted_total", "grammar")
        accepted0 = _metric_sum("batch_spec_proposer_accepted_total", "grammar")
        t0 = time.perf_counter()
        on, _ = _constrain_run(be, prompts, per_row, False)
        tap.take()
        on_s, _ = _constrain_run(be, prompts, per_row, True)
        wall = time.perf_counter() - t0
        rec_on = tap.take()
        launches, replays, new = run_launches(counters, eng.graphs, snap)
        g_drafted = _metric_sum("batch_spec_proposer_drafted_total", "grammar") - drafted0
        g_accepted = _metric_sum("batch_spec_proposer_accepted_total", "grammar") - accepted0
        masked = {k_: eng.graphs.replays_of(k_) for k_ in eng.graphs.keys()
                  if k_[-1] == "mask"}
        step_ms = _constrain_step_ms(be, auts)
    finally:
        be.close()
        tap.__exit__()
    del be
    gc.collect()
    torch.cuda.empty_cache()
    for outs, what in ((off, "greedy"), (off_s, "seeded"), (on, "greedy, speculating"),
                       (on_s, "seeded, speculating")):
        for i in range(4):
            _constrain_valid(auts[i // 2], outs[i], eos, f"constrain {what} request {i}")
    if off[4:] != plain[4:]:
        raise AssertionError("constrain: the unconstrained rows differ from the batch with "
                             "no grammar attached")
    for i in range(4):
        st = 0
        for c, u in zip(off[i], plain[i]):
            if c != u:
                if auts[i // 2].allows(st, u):
                    raise AssertionError(f"constrain: request {i} replaced {u}, which its "
                                         f"grammar allows, by {c}")
                break
            st = auts[i // 2].advance(st, c)
    if again_s != off_s:
        raise AssertionError("constrain: two seeded runs from one state differ")
    notes = [n for i in range(8) if (n := _held(
        state, spec, params, f"constrain request {i}", prompts[i], on[i], off[i]))]
    for i in range(8):
        tag = f"constrain seeded-run request {i}"
        aut = auts[i // 2] if i < 4 else None
        n = (_seeded_pair(state, spec, params, tag, prompts[i], on_s[i], off_s[i],
                          300 + i, (rec_on, rec_off), aut) if i % 2
             else _held(state, spec, params, tag, prompts[i], on_s[i], off_s[i]))
        if n:
            notes.append(n)
    del tap, rec_on, rec_off
    state.pop("prefix_witness", None)
    state.pop("tie_engine", None)
    if _metric_sum("constrain_degraded_total") != degraded0:
        raise AssertionError("constrain: a constrained row degraded")
    if not masked or not any(n > 0 for n in masked.values()):
        raise AssertionError(f"constrain: no masked graph replayed ({masked})")
    if not any(k_[0] == "batched_verify" for k_ in masked) or g_drafted <= 0:
        raise AssertionError(f"constrain: no masked verify block ({masked}; grammar "
                             f"proposer drafted {g_drafted})")
    lost = [n for n in SERVE_PER_DISPATCH if launches.get(n, 0) <= 0]
    if lost:
        raise AssertionError(f"constrain: kernels {lost} not launched on the path "
                             f"({launches})")
    n_tok = sum(len(o) for o in on + on_s)
    numbers.update(launches=launches, replays=replays, captures=new,
                   masked_replays={str(k_): n for k_, n in masked.items()},
                   tok_s=n_tok / wall, grammar_drafted=g_drafted,
                   grammar_accepted=g_accepted,
                   grammar_accept_rate=g_accepted / max(g_drafted, 1),
                   step_ms={f"T={t} {'masked' if m else 'unmasked'}": v
                            for (t, m), v in step_ms.items()},
                   near_ties=notes)
    log(f"[constrain] {smi}: Llama-2-7B Q40 bf16 fused, 8 slots, superstep {SERVE_K} "
        f"pipelined, speculative {SPEC_K}; grammars lowered cold against the 32000-piece "
        f"vocab in {numbers['compile_ms']['json_schema']:.1f} ms (schema, "
        f"{auts[0].n_states} states) and {numbers['compile_ms']['regex']:.1f} ms (regex, "
        f"{auts[1].n_states} states)")
    log(f"[constrain] 2 schema + 2 regex + 4 unconstrained rows x {CONSTRAIN_TOKENS} "
        f"tokens: every constrained output valid; unconstrained rows identical to the "
        f"grammar-free batch; constrained greedy rows equal their unconstrained stream "
        f"up to the first veto; seeded runs repeat; speculation on against off "
        + ("identical" if not notes else "identical outside " + "; ".join(notes))
        + f"; 0 degraded; speculating runs {n_tok} tokens in {wall:.2f} s; the grammar "
        f"proposer drafted {g_drafted:.0f} tokens, accepted {g_accepted:.0f} "
        f"({numbers['grammar_accept_rate']:.3f}); masked graph replays "
        f"{json.dumps(numbers['masked_replays'])}; launches on the path "
        f"{json.dumps(launches)} ({replays} replays, {new} captures)")
    log(f"[constrain] ms per batched step, 8 rows, window 256 (CUDA events over graph "
        f"replays), unmasked -> masked: " + ", ".join(
            f"T={t} {step_ms[(t, False)]:.3f} -> {step_ms[(t, True)]:.3f} "
            f"({step_ms[(t, True)] / step_ms[(t, False)]:.3f}x)" for t in (1, *SPEC_BUCKETS)))
    log("[constrain] numbers: " + json.dumps(numbers, default=float))


# ------------------------------------------------------------------ the model drafter

DRAFT_PROMPTS = (40, 72, 33, 96, 57, 25, 80, 48)
DRAFT_TOKENS = 48


def _tinyllama():
    """TinyLlama-1.1B's shape (bench.py's tinyllama_1_1b): Llama-2's 32000 vocab."""
    from distributed_llama_tpu_torch.models.spec import ArchType, ModelSpec

    return ModelSpec(arch_type=ArchType.LLAMA, dim=2048, hidden_dim=5632, n_layers=22,
                     n_heads=32, n_kv_heads=4, vocab_size=32000, seq_len=2048).resolved()


def _draft_engine(params, draft_model):
    """The 8-slot fused serving engine (superstep 8 pipelined, speculative 8) with a
    model drafter; its graphs and the drafter's counted (`counting_graphs`)."""
    from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine

    be = BatchEngine(_llama2_7b(), params, slots=8, device="cuda", fused_matmul=True,
                     kv_block_tokens=16, superstep=SERVE_K, prefix_cache=False,
                     speculative=SPEC_K, draft_model=draft_model)
    if be.drafter is None:
        raise AssertionError("draft: the drafter did not load")
    dev = be.engine.device
    be.engine.graphs = counting_graphs(dev, _serve_counters())
    be.drafter.graphs = counting_graphs(dev, _serve_counters())
    assert be.drafter.use_kernels == "fused" and be.drafter.graphs.enabled
    return be


def _draft_run(be, prompts, seeded: bool):
    """The 8 requests admitted in one pass; odd rows seeded when `seeded`."""
    from distributed_llama_tpu_torch.runtime.sampler import Sampler

    v = be.spec.vocab_size
    smps = [Sampler(v, 0.8, 0.9, 500 + i) if seeded and i % 2 else _CheckedSampler(v)
            for i in range(len(prompts))]
    with be._slock:
        reqs = [be.submit(list(p), DRAFT_TOKENS, s) for p, s in zip(prompts, smps)]
    outs = [r.wait(timeout=600) for r in reqs]
    be.release_idle()
    return outs, reqs


def _draft_scan_ms(be) -> dict:
    """Device ms of one drafter scan step, 8 rows, at each scan length the run used, by
    CUDA events over graph replays (rows at positions 200-221: window 256)."""
    dr = be.drafter
    out = {}
    starts = np.array([200 + 3 * i for i in range(8)])
    with be._slock:
        for steps in sorted({s for s, _w in dr._loops}):
            loop = dr._loop(steps, dr._window_for(int(starts.max()) + steps))
            catchup = np.full((8, steps), 5)
            out[steps] = event_ms(lambda i: loop(dr.rope, catchup, dr.k_cache, dr.v_cache,
                                                 starts, [1] * 8, [steps] * 8), 10) / steps
    return out


def _self_draft(state: dict, spec, params, prompts) -> dict:
    """Self-draft: the target drafting for itself on its own weights (no copy). Every
    greedy verify turn accepts every draft, unless its first rejected draft and the
    target's token are a near-tie of the f64 witness (the drafter's dense scan and the
    target's paged verify run the same weights at other shapes)."""
    be = _draft_engine(params, (spec, params))
    eng = be.engine
    try:
        shared = all(be.drafter.params["blocks"][n].data.data_ptr()
                     == eng.params["blocks"][n].data.data_ptr() for n in ("wqkv", "w1"))
        if not shared:
            raise AssertionError("draft: the self-drafter copied the target's weights")
        drafts: dict = {}
        orig = be.proposer.propose_batch

        def spy(want):
            out = orig(want)
            for r, d in out.items():
                req = be._slots[r].req
                drafts[(req.rid, len(req.out))] = (be.proposer.last_src[r], list(d))
            return out
        be.proposer.propose_batch = spy
        hits0 = _metric_sum("batch_draft_frontier_hits_total")
        outs, reqs = _draft_run(be, prompts[:4], False)
        turns = rejected = 0
        notes = []
        for i, r in enumerate(reqs):
            for n_out, nd, acc in r.stats.spec_turns:
                src, d = drafts.get((r.rid, n_out), ("?", []))
                if src != "model":
                    continue
                turns += 1
                if acc < nd:
                    rejected += 1
                    a, b = d[acc], outs[i][n_out + acc]
                    gap, tol = _witness(state, spec, params,
                                        list(prompts[i]) + outs[i][:n_out + acc], a, b)
                    if gap >= tol:
                        raise AssertionError(f"draft: self-draft request {i} rejected draft "
                                             f"{a} for {b} at output {n_out + acc}, "
                                             f"{gap:.3e} apart (bound {tol:.3e})")
                    notes.append(f"request {i} output {n_out + acc}: {a} vs {b}, f64 "
                                 f"witness {gap:.2e} < {tol:.2e}")
        if turns < 3:
            raise AssertionError(f"draft: only {turns} self-draft turns")
        return dict(turns=turns, rejected_turns=rejected, near_ties=notes,
                    drafted=be.spec_drafted, accepted=be.spec_accepted,
                    frontier_hits=_metric_sum("batch_draft_frontier_hits_total") - hits0)
    finally:
        be.close()
        state.pop("prefix_witness", None)


def phase_draft(state: dict) -> None:
    """The model drafter at Llama-2-7B on the serve weights (8 slots, superstep 8
    pipelined, speculative 8) with a TinyLlama-1.1B-shaped drafter (random Q40 drawn on
    the card): tokens against speculation off (greedy under the near-tie rule `_held`,
    each seeded run held exactly at its own dispatch shapes, `_seeded_pair`), the
    drafter live (no
    proposer error, not disabled), the kernels launched on the path (the target's and
    the drafter's graphs counted); the drafter's scan ms per bucket against its byte
    floor, drafted and accepted counts, frontier hits, and the serving period with the
    drafter against n-gram drafting. Then the self-draft."""
    from distributed_llama_tpu_torch.models.params import decode_stream_bytes

    spec = _llama2_7b()
    params = _take_serve_params(state, "draft")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    dspec = _tinyllama()
    dparams = _random_i4p_params(dspec, torch.device("cuda"), seed=29, gate_pair=True)
    gen = torch.Generator().manual_seed(41)
    prompts = [[1] + torch.randint(3, spec.vocab_size, (n - 1,), generator=gen).tolist()
               for n in DRAFT_PROMPTS]
    numbers: dict = {"card": smi}
    tap = _SampleTap(spec.vocab_size).__enter__()  # before any graph is captured
    be = _draft_engine(params, (dspec, dparams))
    eng, dr = be.engine, be.drafter
    try:
        dbytes = decode_stream_bytes(dr.params, dspec)
        kv_bytes = 2 * dr.k_cache.numel() * dr.k_cache.element_size()
        k = be.spec_k
        be.spec_k = 0
        off, _ = _draft_run(be, prompts, False)
        tap.take()
        off_s, _ = _draft_run(be, prompts, True)
        rec_off = tap.take()
        be.spec_k = k
        counters = _serve_counters()
        _zero(counters)
        snap = graph_snapshot(counters, eng.graphs)
        dsnap = graph_snapshot(counters, dr.graphs)
        d0 = (dr.dispatches, _metric_sum("batch_draft_frontier_hits_total"),
              be.spec_drafted, be.spec_accepted)
        model0 = (_metric_sum("batch_spec_proposer_drafted_total", "model"),
                  _metric_sum("batch_spec_proposer_accepted_total", "model"))
        t0 = time.perf_counter()
        on, _ = _draft_run(be, prompts, False)
        wall_model = time.perf_counter() - t0
        tap.take()
        on_s, _ = _draft_run(be, prompts, True)
        rec_on = tap.take()
        launches, replays, new = run_launches(counters, eng.graphs, snap,
                                              more=((dr.graphs, dsnap),))
        d_launches = {n: sum(c * (dr.graphs.replays_of(key) - dsnap[1].get(key, 0))
                             for key in dr.graphs.keys()
                             for n2, c in dr.graphs.per_step[key].items() if n2 == n)
                      for n in counters}
        model = (_metric_sum("batch_spec_proposer_drafted_total", "model") - model0[0],
                 _metric_sum("batch_spec_proposer_accepted_total", "model") - model0[1])
        runs = dict(dispatches=dr.dispatches - d0[0],
                    frontier_hits=_metric_sum("batch_draft_frontier_hits_total") - d0[1],
                    drafted=be.spec_drafted - d0[2], accepted=be.spec_accepted - d0[3])
        desc = be.proposer.describe()
        if desc["disabled"] or desc["errors"] or be.drafter is None:
            raise AssertionError(f"draft: the drafter is not live ({desc})")
        # the serving period with n-gram drafting alone (the mux skips a disabled drafter)
        be.proposer.disabled = True
        t0 = time.perf_counter()
        ngram, _ = _draft_run(be, prompts, False)
        wall_ngram = time.perf_counter() - t0
        be.proposer.disabled = False
        scan_ms = _draft_scan_ms(be)
    finally:
        be.close()
        tap.__exit__()
    del be, dr, dparams
    gc.collect()
    torch.cuda.empty_cache()
    notes = [n for i in range(8) if (n := _held(state, spec, params, f"draft request {i}",
                                                 prompts[i], on[i], off[i]))]
    notes += [n for i in range(8) if (n := _held(state, spec, params,
                                                 f"draft n-gram run request {i}",
                                                 prompts[i], ngram[i], off[i]))]
    for i in range(8):
        tag = f"draft seeded-run request {i}"
        n = (_seeded_pair(state, spec, params, tag, prompts[i], on_s[i], off_s[i],
                          500 + i, (rec_on, rec_off)) if i % 2
             else _held(state, spec, params, tag, prompts[i], on_s[i], off_s[i]))
        if n:
            notes.append(n)
    del tap, rec_on, rec_off
    state.pop("prefix_witness", None)
    state.pop("tie_engine", None)
    lost = [n for n in SERVE_PER_DISPATCH if launches.get(n, 0) <= 0]
    d_lost = [n for n in ("q4_matmul", "q4_matmul_res", "q4_gated_matmul")
              if d_launches.get(n, 0) <= 0]
    if lost or d_lost or runs["dispatches"] <= 0:
        raise AssertionError(f"draft: kernels not launched on the path: target {lost}, "
                             f"drafter {d_lost} ({launches}; drafter {d_launches}; "
                             f"{runs['dispatches']} scans)")
    rate = mem_rate(torch.cuda.get_device_name(0))
    floor_ms = dbytes / rate * 1e3
    n_tok = 8 * DRAFT_TOKENS
    numbers.update(drafter=dict(weights_gb=dbytes / 1e9, kv_gb=kv_bytes / 1e9,
                                step_floor_ms=floor_ms),
                   launches=launches, drafter_launches=d_launches, replays=replays,
                   captures=new, run=runs, model_drafted=model[0], model_accepted=model[1],
                   accept_rate=runs["accepted"] / max(runs["drafted"], 1),
                   scan_step_ms=scan_ms,
                   period_ms=dict(drafter=wall_model / n_tok * 1e3,
                                  ngram=wall_ngram / n_tok * 1e3),
                   near_ties=notes)
    numbers["self_draft"] = _self_draft(state, spec, params, prompts)
    log(f"[draft] {smi}: Llama-2-7B Q40 bf16 fused target, 8 slots, superstep {SERVE_K} "
        f"pipelined, speculative {SPEC_K}; TinyLlama-1.1B-shaped drafter (random Q40 "
        f"{dbytes / 1e9:.3f} GB, dense KV {kv_bytes / 1e9:.3f} GB, step floor "
        f"{floor_ms:.3f} ms at {rate / 1e12:.2f} TB/s)")
    log(f"[draft] tokens against speculation off "
        + ("identical" if not notes else "identical outside " + "; ".join(notes))
        + f" (greedy and seeded); drafter live, 0 proposer errors; {runs['dispatches']} "
        f"scans, drafted {runs['drafted']}, accepted {runs['accepted']} "
        f"({numbers['accept_rate']:.3f}), model-drafted {model[0]:.0f}, accepted "
        f"{model[1]:.0f}; frontier hits {runs['frontier_hits']:.0f}; scan ms per step by "
        f"length (CUDA events) {json.dumps({s: round(v, 4) for s, v in scan_ms.items()})}"
        f"; serving period "
        f"{numbers['period_ms']['drafter']:.3f} ms/token with the drafter, "
        f"{numbers['period_ms']['ngram']:.3f} with n-gram drafting; launches on the path "
        f"(target and drafter) {json.dumps(launches)}, of them in the drafter's scan "
        f"graphs {json.dumps(d_launches)}")
    sd = numbers["self_draft"]
    log(f"[draft] self-draft (the 7B target drafting for itself, no copy of its "
        f"weights): {sd['turns']} model-drafted greedy turns, {sd['rejected_turns']} with "
        f"a rejected draft" + (f" (near-ties: {'; '.join(sd['near_ties'])})"
                               if sd["near_ties"] else "")
        + f"; drafted {sd['drafted']}, accepted {sd['accepted']}, frontier hits "
        f"{sd['frontier_hits']:.0f}")
    log("[draft] numbers: " + json.dumps(numbers, default=float))
    gc.collect()
    torch.cuda.empty_cache()


class _ExpertLog:
    """While open, every one-row forward pass also writes the k experts each layer chose
    into a device history (MAX_STEPS, L, k) at a device step counter: at the last layer
    the layers' choices are stacked and copied in, four small kernels a step, captured
    into a step's CUDA graph like the route itself, so each replay records the experts
    that replay chose (a routing frozen into the graph would record one set per layer).
    `distinct()` reads the history after the run."""

    MAX_STEPS = 4096

    def __init__(self, spec, dev):
        from distributed_llama_tpu_torch.models import forward as fw

        self.fw, self.spec = fw, spec
        self.hist = torch.full((self.MAX_STEPS, spec.n_layers, spec.n_active_experts), -1,
                               dtype=torch.int64, device=dev)
        self.count = torch.zeros(1, dtype=torch.int64, device=dev)
        self.layers: list[torch.Tensor] = []
        self._route = fw._route

    def __enter__(self):
        def route(xb, bp, spec):
            top_i, w = self._route(xb, bp, spec)
            if xb.shape[0] * xb.shape[1] == 1:  # forward routes once per layer, in order
                self.layers.append(top_i.reshape(1, -1))
                if len(self.layers) == spec.n_layers:
                    self.hist.index_copy_(0, self.count % self.MAX_STEPS,
                                          torch.stack(self.layers, dim=1))
                    self.count += 1
                    self.layers = []
            return top_i, w
        self.fw._route = route
        return self

    def __exit__(self, *exc):
        self.fw._route = self._route

    def distinct(self) -> tuple[list[int], int]:
        """Distinct experts each layer chose over the recorded one-row steps, and the
        steps recorded."""
        n = min(int(self.count), self.MAX_STEPS)
        hist = self.hist[:n].cpu()
        return [len(set(hist[:, li].flatten().tolist()))
                for li in range(self.spec.n_layers)], n


def _moe_decode(state: dict, tag: str, spec, params, n: int, kw: dict, t1: dict,
                chunked: dict, label: str) -> dict:
    """`_decode_path` for a MoE model with the experts it chose recorded
    (`_ExpertLog`): every layer must pick more than k distinct experts over the run's
    one-token steps. Returns the counted run's launches."""
    t0 = time.perf_counter()
    with _ExpertLog(spec, torch.device("cuda")) as experts:
        launches = _decode_path(state, tag, spec, params, n, kw, t1, chunked, label=label)
    per, steps = experts.distinct()
    log(f"[{tag}] distinct experts each layer chose over {steps} one-token steps (graph, "
        f"eager, host loop, device loop): {per}; the path in "
        f"{time.perf_counter() - t0:.1f} s")
    if min(per) <= spec.n_active_experts:
        raise AssertionError(f"{tag}: a layer kept one set of {spec.n_active_experts} "
                             f"experts over {steps} steps: {per}")
    return launches


def phase_moe(state: dict) -> None:
    """Mixtral-8x7B at full size, its Q80 path, parity at Mixtral width, Grok-1's block."""
    from distributed_llama_tpu_torch.models.params import params_to

    dev = torch.device("cuda")
    gc.collect()  # the earlier phases' engines, caught in reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    spec = _mixtral_8x7b()
    t0 = time.perf_counter()
    params = _random_moe_params(spec, dev, seed=21)
    torch.cuda.synchronize()
    log(f"[moe] Mixtral-8x7B random Q40 weights drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s: {_param_bytes(params) / 1e9:.2f} GB "
        f"({held / 2**30:.2f} GiB still allocated from the earlier phases)")
    # per one-token step: wqkv and wo through q4_matvec and two experts' gu and down
    # through the expert entry in each layer, wcls once; attention once per layer. Each
    # M > 1 prefill chunk (64 and 8 tokens: k·T > E) runs the expert-major loop: wqkv, wo
    # and the 8 experts' gu and down through q4_matmul in each layer, wcls once.
    L = spec.n_layers
    t1 = {"q4_matvec": 2 * L + 1, "q4_matvec_expert": 4 * L, "decode_attention": L}
    launches = _moe_decode(state, "moe", spec, params, 64,
                           dict(prefill_kernel=True, fused_prologue=False), t1,
                           {"q4_matmul": 18 * L + 1}, "Mixtral-8x7B")
    log(f"[moe] q4_matvec launches per decode token: {t1['q4_matvec']} + "
        f"{t1['q4_matvec_expert']} through the expert entry = "
        f"{t1['q4_matvec'] + t1['q4_matvec_expert']}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f} GiB")
    state["launches"]["q4_matvec_expert"] = launches["q4_matvec_expert"]
    del params
    torch.cuda.empty_cache()

    # Q80 Mixtral (i8 layout) at 8 layers: the q8_matvec expert entry's path; the M > 1
    # prefill chunks dequantize the i8 experts (the JAX package's route too)
    spec8 = _mixtral_8x7b(n_layers=8)
    params = _random_moe_params(spec8, dev, seed=23, fmt="q80")
    L = spec8.n_layers
    launches = _moe_decode(state, "moe q80", spec8, params, 16, dict(fused_prologue=False),
                           {"q8_matvec": 2 * L + 1, "q8_matvec_expert": 4 * L,
                            "decode_attention": L}, {}, "Mixtral-8x7B")
    state["launches"]["q8_matvec_expert"] = launches["q8_matvec_expert"]
    del params
    torch.cuda.empty_cache()

    # Grok-1's block at full width: the graph run against eager
    spec_g = _grok1()
    params = _random_moe_params(spec_g, dev, seed=27)
    L = spec_g.n_layers
    _moe_decode(state, "moe grok1", spec_g, params, 16,
                dict(prefill_kernel=True, fused_prologue=False),
                {"q4_matvec": 2 * L + 1, "q4_matvec_expert": 4 * L, "decode_attention": L},
                {"q4_matmul": 18 * L + 1}, "Grok-1 (grok1_l2)")

    # card against CPU in f32 on the weights drawn on the card (copied to the host):
    # grok1_l2's first layer, then 1 layer of Mixtral width (the Engine, and the fused
    # BatchEngine).
    # Each takes the crossing rule (`engine_parity`) and a fed run, which must hold
    # 2e-3·max|logits| and every kernel call to its plain version on the CPU's
    # operands: the card runs of this script found these models' logits moved past
    # 2e-3·max by values that rounded differently (grok1_l2: 3.3e-2 against 7.5e-3, with
    # 1.86M values rounded differently), and the fed run and the router choices show
    # where that comes from. Depth of the CPU side cut to keep the run short: grok1_l2's
    # first layer prefill + 1 step, Mixtral width at 1 layer (2 until the tp phase came)
    # 4 steps, the serving parity 4 requests x 2 tokens, each arriving at the previous
    # one's first token.
    t0 = time.perf_counter()
    cpu_params = params_to(_first_layer(params), "cpu")
    del params
    torch.cuda.empty_cache()
    report = engine_parity(_grok1(n_layers=1), cpu_params, True, steps=1, fed=True,
                           prefill_kernel=True)
    log(f"[moe] parity, grok1_l2's first layer, f32, Q40: {report} "
        f"({time.perf_counter() - t0:.1f} s)")
    del cpu_params
    spec2 = _mixtral_8x7b(n_layers=1)
    t0 = time.perf_counter()
    cpu_params = params_to(_random_moe_params(spec2, dev, seed=25), "cpu")
    torch.cuda.empty_cache()
    with _SharedDequant():  # one CPU model for both: its experts decoded once
        report = engine_parity(spec2, cpu_params, True, steps=4, fed=True,
                               prefill_kernel=True)
        log(f"[moe] parity, 1-layer Mixtral width, f32, Q40: {report} "
            f"({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        report = serving_parity(spec=spec2, max_tokens=2, prompt_lens=(8, 9, 1, 8),
                                crossing_tol=True, after=1, fed=True, params=cpu_params)
    del cpu_params
    log(f"[moe] parity, 1-layer Mixtral width, f32: {report} "
        f"({time.perf_counter() - t0:.1f} s)")


# the spill phase: the paged engine's ring (`kv_cache_resident`), run (a)'s prompt and
# greedy tokens (the ring wraps three times), the warm run's prompt (`_prompt_100`) and
# tokens, all inside the ring, and run (b)'s disc store: layers, prompt, tokens
SPILL_R = 512
SPILL_PROMPT, SPILL_TOKENS = 1600, 32
SPILL_WARM_TOKENS = 32
SPILL_DISC = (4, 1200, 8)


def _ladder(n: int) -> list[int]:
    """The chunk lengths `Engine.prefill` takes for an n-token prompt (64, 8, 1)."""
    from distributed_llama_tpu_torch.runtime.engine import PREFILL_CHUNKS

    out = []
    while n:
        c = next(c for c in PREFILL_CHUNKS if c <= n)
        out.append(c)
        n -= c
    return out


def _spill_step(tag: str, paged, dense, toks: list[int], times: dict) -> tuple:
    """One chunk through both engines, each timed to its logits' host copy; the paged
    logits held to the dense engine's within NEAR_TIE·max|logits|, and the cold counters'
    rise to the cost model: L calls and L·2·hk·(pos-R)·hs·itemsize bytes when the step
    starts past the ring, none before; a warm-phase step's logits bit-identical. The
    dense engine's rise of the launch counters (`times["counters"]`) is summed into
    `times["dense_rise"]`. Returns (paged logits, dense logits)."""
    from distributed_llama_tpu_torch.runtime import paged_cache as pc

    spec, pos = paged.spec, paged.pos
    calls0, bytes0 = pc._COLD_CALLS.value, pc._COLD_BYTES.value
    t0 = time.perf_counter()
    lp = paged.infer_chunk(toks)
    t1 = time.perf_counter()
    got = (pc._COLD_CALLS.value - calls0, pc._COLD_BYTES.value - bytes0)
    before = _read(times["counters"])
    ld = dense.infer_chunk(toks)
    t2 = time.perf_counter()
    rise = times.setdefault("dense_rise", collections.Counter())
    rise.update({n: v - before[n] for n, v in _read(times["counters"]).items()})
    phase = "warm" if pos + len(toks) <= paged.kv_resident else "paged"
    key = (phase, "decode" if len(toks) == 1 else "prefill")
    times.setdefault(key, []).append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
    cold = max(0, pos - paged.kv_resident)
    item = paged.store.k.element_size()
    want = (spec.n_layers * (cold > 0),
            spec.n_layers * 2 * spec.n_kv_heads * cold * spec.head_size * item)
    if got != want:
        raise AssertionError(f"{tag}: at pos {pos} the cold counters rose by {got}, the "
                             f"cost model says {want}")
    err, tol = float(np.abs(lp - ld).max()), NEAR_TIE * float(np.abs(ld).max())
    if not err <= tol:
        raise AssertionError(f"{tag}: at pos {pos} ({len(toks)} tokens, {phase}) the paged "
                             f"logits lie {err:.3e} from the dense engine's (bound {tol:.3e})")
    times.setdefault("err", []).append(err / float(np.abs(ld).max()))
    if phase == "warm" and not np.array_equal(lp, ld):
        raise AssertionError(f"{tag}: at pos {pos} the warm phase's logits differ from the "
                             f"dense engine's (the same steps on a ring-sized cache)")
    return lp, ld


def _spill_decode(state, tag: str, spec, params, paged, dense, prompt, n: int,
                  times: dict) -> tuple[list[str], list[int]]:
    """n greedy steps, both engines fed the dense engine's pick: each step's logits held
    by `_spill_step`, and the paged engine's pick the dense one's unless the two are a
    near-tie in both runs' logits that the f64 witness confirms. Returns the near-ties and
    the tokens fed; the paged rows are kept in times["rows"]."""
    ties, fed = [], []
    lp, ld = times.pop("last")
    for j in range(n):
        a, b = int(np.argmax(lp)), int(np.argmax(ld))
        if a != b:
            for row in (lp, ld):
                gap = abs(float(row[a] - row[b]))
                if gap >= NEAR_TIE * float(np.abs(row).max()):
                    raise AssertionError(f"{tag}: step {j} picks {a} against {b}, "
                                         f"{gap:.3e} apart in a run's logits")
            gap, tol = _witness(state, spec, params, list(prompt) + fed, a, b)
            if gap >= tol:
                raise AssertionError(f"{tag}: step {j} picks {a} against {b}; the f64 "
                                     f"witness puts them {gap:.3e} apart (bound {tol:.3e})")
            ties.append(f"step {j} ({a} vs {b}, f64 witness {gap:.2e} < {tol:.2e})")
        fed.append(b)
        lp, ld = _spill_step(tag, paged, dense, [b], times)
        times.setdefault("rows", []).append(lp)
    return ties, fed


def _ms(times: dict, key, i: int) -> float:
    rows = times.get(key, [])
    return float(np.mean([r[i] for r in rows])) if rows else float("nan")


def _spill_alone(eng, start: int, fed: list[int]) -> tuple[float, list]:
    """The engine rewound to `start` (seek) and stepped alone through `fed`: mean ms per
    step to its logits' host copy, and the logits."""
    eng.seek(start)
    rows, t = [], []
    for tok in fed:
        t0 = time.perf_counter()
        rows.append(eng.infer_chunk([tok]))
        t.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(t)), rows


def phase_spill(state: dict) -> None:
    """The host KV spill at Llama-2-7B (random Q40 drawn on the card, bf16, kernels on,
    prefill_kernel): Engine(kv_cache_storage="host", kv_cache_resident=512) beside a dense
    Engine on the same weights. A warm run (100-token prompt, 32 greedy tokens, all inside
    the ring: its one-token steps graph replays) bit-identical to the dense engine; then
    run (a): a 1600-token prompt through the (64, 8, 1) ladder (the ring wraps three
    times) and 32 greedy tokens, every step's logits within NEAR_TIE·max|logits| of the
    dense engine's and the picks equal outside near-ties the f64 witness confirms, the
    store's rows [0, 512) bit-identical to the dense cache's, the cold counters on the
    cost model at every step; the paged engine's launches over both runs (counted from 0,
    the dense engine's calls taken out) on the schedule: 4L+1 q4_matvec a one-token step,
    L decode_attention a warm one, 4L+1 q4_matmul a chunk. Then each engine rewound
    (seek) and stepped alone through run (a)'s 32 tokens, timed: the paged steps under
    the tracer, the cold attention's host time from its spans. Run (b): a disc store at
    7B width and 4 layers, a 1200-token prompt and 8 tokens against the dense engine, the
    file pair's sizes, the owned temp dir gone after cleanup()."""
    from distributed_llama_tpu_torch.obs import trace
    from distributed_llama_tpu_torch.quants import QTensor
    from distributed_llama_tpu_torch.runtime.engine import Engine

    spec = _llama2_7b()
    dev = torch.device("cuda")
    params = _random_i4p_params(spec, dev, seed=11)  # the model phase's weights, drawn once
    kw = dict(device="cuda", prefill_kernel=True)
    dense = Engine(spec, params, **kw)
    paged = Engine(spec, params, kv_cache_storage="host", kv_cache_resident=SPILL_R, **kw)
    on_card = [t.data.is_cuda for t in paged.params["blocks"].values()
               if isinstance(t, QTensor)] + [paged.k_cache.is_cuda, paged.v_cache.is_cuda]
    if not (paged.paged and all(on_card) and paged.k_cache.shape[3] == SPILL_R
            and paged.cuda_graph and paged.use_kernels == "all"
            and paged.store.k.dtype == torch.bfloat16):
        raise AssertionError(f"spill: the paged engine is not on the card with its kernels "
                             f"(paged {paged.paged}, ring {tuple(paged.k_cache.shape)}, "
                             f"kernels {paged.use_kernels}, graphs {paged.cuda_graph})")
    counters = _single_counters()
    paged.graphs = counting_graphs(paged.device, counters)
    vocab = spec.vocab_size
    for e in (paged, dense):  # warm-up: builds, captures
        e.generate(_prompt_100(spec)[:9], 2, _CheckedSampler(vocab))
        e.reset()
    torch.cuda.synchronize()

    # the main path: the counts zeroed just before the warm run and read after run (a)
    _zero(counters)
    snap = graph_snapshot(counters, paged.graphs)
    warm = _prompt_100(spec)
    times = {"counters": counters}
    pos = 0
    for c in _ladder(len(warm)):
        times["last"] = _spill_step("spill warm", paged, dense, warm[pos:pos + c], times)
        pos += c
    ties, _ = _spill_decode(state, "spill warm", spec, params, paged, dense, warm,
                            SPILL_WARM_TOKENS, times)
    warm_ms = (_ms(times, ("warm", "decode"), 0), _ms(times, ("warm", "decode"), 1))
    for e in (paged, dense):
        e.reset()
    prompt = [1] + torch.randint(3, vocab, (SPILL_PROMPT - 1,),
                                 generator=torch.Generator().manual_seed(71)).tolist()
    times = {"counters": counters, "dense_rise": times["dense_rise"]}
    pos = 0
    for c in _ladder(len(prompt)):
        times["last"] = _spill_step("spill (a)", paged, dense, prompt[pos:pos + c], times)
        pos += c
    for side, cache in ((paged.store.k, dense.k_cache), (paged.store.v, dense.v_cache)):
        if not torch.equal(side[:, :, :, :SPILL_R], cache[:, :, :, :SPILL_R].cpu()):
            raise AssertionError("spill (a): the store's warm rows differ from the dense "
                                 "cache's")
    prefill_ms = [sum(r[i] for k in (("warm", "prefill"), ("paged", "prefill"))
                      for r in times.get(k, [])) for i in (0, 1)]
    more, fed = _spill_decode(state, "spill (a)", spec, params, paged, dense, prompt,
                              SPILL_TOKENS, times)
    ties += more
    launches, replays, new = run_launches(counters, paged.graphs, snap)
    path = {n: v - times["dense_rise"][n] for n, v in launches.items()
            if v - times["dense_rise"][n]}
    per_step, t1_warm = 4 * spec.n_layers + 1, _ladder(len(warm)).count(1) + SPILL_WARM_TOKENS
    chunks = sum(c > 1 for c in _ladder(len(warm)) + _ladder(SPILL_PROMPT))
    want = {"q4_matvec": per_step * (t1_warm + SPILL_TOKENS),
            "q4_matmul": per_step * chunks, "decode_attention": spec.n_layers * t1_warm}
    if path != want:
        raise AssertionError(f"spill: the paged engine's launches {path}, the schedule "
                             f"says {want}")

    # each engine alone through run (a)'s tokens again: the step times without the other
    # engine's work between them, the paged steps' cold spans under the tracer
    trace.install()
    try:
        paged_ms, rows = _spill_alone(paged, SPILL_PROMPT, fed)
        events = [e for e in trace.current().events() if e.get("name") == "paged.cold_attend"]
    finally:
        trace.uninstall()
    dense_ms, _ = _spill_alone(dense, SPILL_PROMPT, fed)
    again = max(float(np.abs(a - b).max()) for a, b in zip(rows, times["rows"]))
    if len(events) != spec.n_layers * SPILL_TOKENS:
        raise AssertionError(f"spill (a): {len(events)} cold spans over {SPILL_TOKENS} "
                             f"paged steps")
    cold_ms = sum(e["dur"] for e in events) / 1e3 / SPILL_TOKENS
    item = paged.store.k.element_size()
    # the store bytes the cold partials of those steps read, at pos SPILL_PROMPT ..
    cold_gb = sum(spec.n_layers * 2 * spec.n_kv_heads * (p - SPILL_R) * spec.head_size
                  * item for p in range(SPILL_PROMPT, SPILL_PROMPT + SPILL_TOKENS)) / 1e9
    # the warm phase's append of one step's rows, alone
    ring = (paged.k_cache[:, :, :, 7:8], paged.v_cache[:, :, :, 7:8])
    append_ms = event_ms(lambda i: paged.store.append(*ring, 7), 20)
    # what a cold partial on the card would first pay: one token's cold rows (at pos
    # SPILL_PROMPT) copied to the card from pinned host memory
    n = spec.n_layers * 2 * spec.n_kv_heads * (SPILL_PROMPT - SPILL_R) * spec.head_size
    src = torch.empty(n, dtype=torch.bfloat16, pin_memory=True)
    dst = torch.empty(n, dtype=torch.bfloat16, device=dev)
    h2d_ms = event_ms(lambda i: dst.copy_(src, non_blocking=True), 5, warmup=2)
    del src, dst
    log(f"[spill] Llama-2-7B Q40 bf16, kernels on, ring {SPILL_R} of seq_len "
        f"{spec.seq_len}, host store {paged.store.nbytes() / 1e9:.3f} GB bf16: warm run "
        f"({len(warm)}-token prompt, {SPILL_WARM_TOKENS} tokens) logits bit-identical to "
        f"the dense engine's; run (a) {SPILL_PROMPT}-token prompt "
        f"({len(_ladder(SPILL_PROMPT))} chunks) and {SPILL_TOKENS} tokens, logits within "
        f"{max(times['err']):.2e}·max|logits| (bound {NEAR_TIE}), store rows [0, "
        f"{SPILL_R}) bit-identical, cold counters on the cost model at every step; the "
        f"steps again after seek({SPILL_PROMPT}) within {again:.2e} of the first pass; "
        f"near-ties {ties or 'none'}")
    log(f"[spill] ms/token (paged / dense engine, each step to its logits' host copy): "
        f"warm phase {warm_ms[0]:.3f} / {warm_ms[1]:.3f} (graph replays, steps "
        f"interleaved; the paged step's store append alone {append_ms:.3f} ms); paged "
        f"phase at pos {SPILL_PROMPT}-{SPILL_PROMPT + SPILL_TOKENS - 1}, each engine "
        f"alone: {paged_ms:.3f} / {dense_ms:.3f}, of it cold attention on the host "
        f"{cold_ms:.3f} ms ({cold_ms / paged_ms:.3f} of the step; "
        f"{cold_gb / SPILL_TOKENS:.3f} GB of bf16 rows a token -> "
        f"{cold_gb / (cold_ms * SPILL_TOKENS * 1e-3):.2f} GB/s); interleaved "
        f"{_ms(times, ('paged', 'decode'), 0):.3f} / {_ms(times, ('paged', 'decode'), 1):.3f};"
        f" prefill of {SPILL_PROMPT} tokens {prefill_ms[0]:.1f} / {prefill_ms[1]:.1f} ms; "
        f"one token's cold rows ({n * 2 / 1e9:.3f} GB) pinned host -> card {h2d_ms:.3f} ms "
        f"({n * 2 / (h2d_ms * 1e-3) / 1e9:.1f} GB/s)")
    log(f"[spill] the paged engine's launches over the warm run and run (a), counted from "
        f"0: {json.dumps(path)} = the schedule ({replays} graph replays, {new} graphs "
        f"captured in the run)")
    state["spill"] = dict(launches=path, warm_ms=warm_ms, paged_ms=paged_ms,
                          dense_ms=dense_ms, cold_ms=cold_ms, prefill_ms=prefill_ms,
                          h2d_ms=h2d_ms)
    del paged, dense, params
    gc.collect()
    torch.cuda.empty_cache()

    # run (b): the disc store at 7B width, depth cut to 4 layers
    n_layers, n_prompt, n_tok = SPILL_DISC
    spec4 = _llama2_7b(n_layers)
    params = _random_i4p_params(spec4, dev, seed=11)
    dense = Engine(spec4, params, **kw)
    paged = Engine(spec4, params, kv_cache_storage="disc", kv_cache_resident=SPILL_R, **kw)
    files = paged.store.paths
    size = spec4.n_layers * spec4.n_kv_heads * spec4.seq_len * spec4.head_size * 2
    sizes = [os.path.getsize(p) for p in files]
    if sizes != [size, size] or not paged.store._owned_dir:
        raise AssertionError(f"spill (b): the disc pair is {sizes} bytes, want {size} each")
    times = {"counters": counters}
    pos = 0
    for c in _ladder(n_prompt):
        times["last"] = _spill_step("spill (b)", paged, dense, prompt[pos:pos + c], times)
        pos += c
    ties, _ = _spill_decode(state, "spill (b)", spec4, params, paged, dense,
                            prompt[:n_prompt], n_tok, times)
    d = os.path.dirname(files[0])
    paged.store.cleanup()
    if os.path.exists(d):
        raise AssertionError(f"spill (b): cleanup() left the owned directory {d}")
    log(f"[spill] run (b): disc store, {n_layers} layers at 7B width, {n_prompt}-token "
        f"prompt and {n_tok} tokens: logits within {max(times['err']):.2e}·max|logits| "
        f"of the dense engine's, near-ties {ties or 'none'}; two files of {size} bytes "
        f"(L·hk·S·hs·2), the owned temp dir removed by cleanup(); paged-phase ms/token "
        f"{_ms(times, ('paged', 'decode'), 0):.3f} / dense "
        f"{_ms(times, ('paged', 'decode'), 1):.3f} (interleaved)")
    del paged, dense, params
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------------------
# tp: tensor parallelism over torch.distributed (parallel/), two ranks on one card
# --------------------------------------------------------------------------------------

TP = 2
TP_STEPS = 8  # (a): greedy steps after the 9-token prompt, as engine_parity
TP_TOKENS = 32  # (b): greedy tokens after the 100-token prompt
# (b): the first step's logits against the tp = 1 engine on the card, x max|logits| (bf16
# roundings of the partial sums and the Q80 wire's steps; PERF.md §6, set before the run)
TP_FIRST_TOL = {"raw": 5e-2, "q80": 1e-1}
# (b): what a rank's card may hold beyond its shard and KV caches at its peak, from the
# Engine's construction through the run: activations, logits, the wire's buffers and
# the kernels' workspaces (PERF.md §6, set before the run). The whole 7B draw is 3.5 GiB.
TP_PEAK_MARGIN = 512 << 20
# the decode shard shapes of Llama-2-7B at tp = 2 as (N, K): wqkv, wo, w13, w2, wcls
SHAPES_7B_TP2 = ((6144, 4096), (4096, 2048), (11008, 4096), (4096, 5504), (16000, 4096))


def _tp_prompt9() -> list[int]:
    return [1] + [int(t) for t in np.random.RandomState(3).randint(3, 32000, 8)]


def _tp_params(weights: str, dev):
    """(a)'s weights, drawn again by every rank from their seeds: the parity phase's Q40
    set, or its Q80 set."""
    spec = _llama2_7b(n_layers=2)
    if weights == "q40":
        return spec, _random_i4p_params(spec, dev, seed=7)
    return spec, _random_i8_params(spec, dev, seed=9)


def _wire_launches(t: int, spec, tp: int) -> int:
    """Kernel 11's launches in one forward step of t tokens on the Q80 wire: two merge
    points a layer, each quantizing the (t, dim) partial and the (t, dim/tp) reduced
    chunk in pieces of at most the prologue's row."""
    from distributed_llama_tpu_torch.ops import prologue_plan

    def pieces(n):
        return -(-n // prologue_plan.MAX_K)
    return 2 * spec.n_layers * (pieces(t * spec.dim) + pieces(t * spec.dim // tp))


def _mm_launches(spec, tp: int) -> int:
    """q4_matmul's launches in one M > 1 step of a rank: the projections whose shard
    passes the card's route gate (ops/matmul.py q4_mm_supported: K a multiple of 64, as
    csrc/q4_matmul.cu takes it), at tp = 2 all four, w2's K = 5504 included, and
    wcls."""
    ks = (spec.dim, spec.dim // tp, spec.dim, spec.hidden_dim // tp)  # wqkv wo w13 w2
    return spec.n_layers * sum(k % 64 == 0 for k in ks) + 1  # + wcls


def tp_rank_parity(mesh, cases):
    """(a) on one rank: each case (weights, compress, feed) runs the 9-token prompt and
    TP_STEPS one-token steps in f32 with the kernels (their plain versions on the CPU),
    feeding `feed`'s tokens (None: its own greedy picks). Returns per case rank 0's
    logits of every step, the tokens fed, this rank's launches and counted wire bytes."""
    from distributed_llama_tpu_torch.parallel.collectives import broadcast_int
    from distributed_llama_tpu_torch.runtime.engine import Engine

    if mesh.device.type == "cpu":
        torch.set_num_threads(4)
    counters = _single_counters()
    out = []
    for weights, compress, feed in cases:
        spec, params = _tp_params(weights, torch.device("cpu"))
        eng = Engine(spec, params, mesh=mesh, dtype=torch.float32, use_kernels=True,
                     prefill_kernel=True, compress_collectives=compress)
        del params
        _zero(counters)
        logits = [eng.prefill(_tp_prompt9())]
        fed, sent = [], 0.0
        for step in range(TP_STEPS):
            tok = feed[step] if feed is not None else broadcast_int(
                int(np.argmax(logits[-1])), mesh)
            fed.append(tok)
            with mesh.counter.window() as traffic:
                logits.append(eng.infer_chunk([tok]))
            sent += traffic.sent_bytes_per_device
        out.append({"logits": logits if mesh.rank == 0 else None, "tokens": fed,
                    "launches": _read(counters), "bytes_per_step": sent / TP_STEPS})
        del eng
    return out


def _tree_bytes(tree) -> int:
    """Bytes of every tensor (QTensor data and scales) in a params dict."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if hasattr(tree, "nbytes") and callable(tree.nbytes):
        return tree.nbytes()
    return tree.numel() * tree.element_size()


def tp_rank_full(mesh, wires):
    """(b) on one rank: Llama-2-7B (the model phase's seed) drawn on the card tensor by
    tensor into host memory, as Engine.load holds a `.m` file, then for each wire an
    Engine on the card from those host weights: bf16, prefill_kernel, the 100-token
    prompt and TP_TOKENS greedy tokens, ms per one-token step (this rank's wall, the
    logits on the host), the counted wire bytes of every step, launches against the
    schedule, and the card's memory from the Engine on: resident, peak, and what the
    rank must hold (its shard and its KV caches)."""
    from distributed_llama_tpu_torch.parallel.collectives import broadcast_int
    from distributed_llama_tpu_torch.runtime.engine import Engine

    spec = _llama2_7b()
    dev = mesh.device
    counters = _single_counters()
    host = _random_i4p_params(spec, dev, seed=11, to="cpu")
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    for wire in wires:
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        eng = Engine(spec, host, mesh=mesh, prefill_kernel=True,
                     compress_collectives=wire == "q80")
        load_s = time.perf_counter() - t0
        gc.collect()
        resident = torch.cuda.memory_allocated(dev) - base  # shard, caches, tables
        held = (_tree_bytes(eng.params) + eng.k_cache.numel() * eng.k_cache.element_size()
                + eng.v_cache.numel() * eng.v_cache.element_size())
        eng.collective_stats()  # the decode step's traffic (a probe step at position 0)
        _zero(counters)
        t0 = time.perf_counter()
        logits = eng.prefill(_prompt_100(spec))
        prefill_ms = (time.perf_counter() - t0) * 1e3
        first = logits if mesh.rank == 0 else None
        prefill_launches = _read(counters)
        _zero(counters)
        tokens, ms, sent = [], [], 0.0
        for _ in range(TP_TOKENS):
            tok = broadcast_int(int(np.argmax(logits)), mesh)
            tokens.append(tok)
            t0 = time.perf_counter()
            with mesh.counter.window() as traffic:
                logits = eng.infer_chunk([tok])
            ms.append((time.perf_counter() - t0) * 1e3)
            sent += traffic.sent_bytes_per_device
        out[wire] = {"first": first, "tokens": tokens, "ms": ms, "prefill_ms": prefill_ms,
                     "bytes_per_token": sent / TP_TOKENS,
                     "counted": eng.collective_stats().sent_bytes_per_device,
                     "prefill_launches": prefill_launches, "launches": _read(counters),
                     "resident": resident, "held": held, "load_s": load_s,
                     "peak": torch.cuda.max_memory_allocated(dev) - base}
        del eng
        torch.cuda.empty_cache()
    return out


def tp_rank_nccl_one(mesh):
    """(c): an NCCL world of one on this card: the port's all-reduce, Q80 two-phase wire
    and logits gather over the one-member group (a real collective each: the public
    entries return x for one member), eager and captured in a CUDA graph, then replayed
    on new inputs."""
    import torch.distributed as dist

    from distributed_llama_tpu_torch.parallel import collectives as coll
    from distributed_llama_tpu_torch.parallel.mesh import Mesh

    m = Mesh(rank=0, shape=dict(mesh.shape), group=dist.group.WORLD, device=mesh.device,
             backend=dist.get_backend())
    gen = torch.Generator(device=mesh.device).manual_seed(3)
    x = torch.randn(1, 1, 4096, generator=gen, device=mesh.device).to(torch.bfloat16)
    lg = torch.randn(1, 1, 16000, generator=gen, device=mesh.device)

    def step():
        return (coll._all_reduce_f32(x, m), coll._two_phase(x, m), coll._gather_last(lg, m))

    def want():
        v, s = coll.wire_quantize(x)
        v, s = coll.wire_quantize(coll.wire_dequantize(v, s))
        return x, coll.wire_dequantize(v, s).reshape(x.shape).to(x.dtype), lg

    def same(got, ref):
        return all(torch.equal(g, r) for g, r in zip(got, ref))

    eager = same(step(), want())
    side = torch.cuda.Stream(mesh.device)
    side.wait_stream(torch.cuda.current_stream(mesh.device))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(mesh.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    x.copy_(torch.randn(x.shape, generator=gen, device=mesh.device))
    lg.copy_(torch.randn(lg.shape, generator=gen, device=mesh.device))
    graph.replay()
    torch.cuda.synchronize(mesh.device)
    return {"eager": eager, "graph": same(outs, want())}


def _nccl_pair_one_card(q, rank: int, rendezvous: str) -> None:
    """One of two NCCL ranks on cuda:0: what NCCL says."""
    import datetime

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=rendezvous, rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=60),
                                device_id=torch.device("cuda:0"))
        t = torch.ones(8, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        q.put((rank, f"ran: all_reduce gave {float(t[0])}"))
        dist.destroy_process_group()
    except Exception as e:  # the words are the result: reported, and the phase goes on
        q.put((rank, " / ".join(str(e).strip().splitlines()[-2:])))


def _tp_held(tag: str, got: list, want: list, tol_rel: float = 2e-3) -> tuple[float, list]:
    """engine_parity's rule on a tp run's logits against a reference's, the run fed the
    reference's tokens: every step within tol_rel·max|logits|, and the same greedy pick
    unless the reference's own logit of the run's pick lies within that tolerance of its
    top (a near-tie, serving_parity's rule). Returns the worst max|Δ|/max|ref| and the
    near-tie steps."""
    worst, ties = 0.0, []
    for step, (g, w) in enumerate(zip(got, want)):
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        worst = max(worst, err / scale)
        if err > tol_rel * scale or not np.isfinite(g).all():
            raise AssertionError(f"[tp] {tag} step {step}: max|Δlogits| {err:.3e} > "
                                 f"{tol_rel:.0e}·{scale:.3e}")
        pick = int(np.argmax(g))
        if pick != int(np.argmax(w)):
            gap = float(w.max() - w[pick])
            if gap > tol_rel * scale:
                raise AssertionError(f"[tp] {tag}: greedy picks part at step {step}, the "
                                     f"reference's top two {gap:.3e} apart")
            ties.append((step, round(gap / scale, 6)))
    return worst, ties


def _tp_cpu_reference(weights: str) -> tuple[list, list]:
    """(a)'s tp = 1 reference on the CPU with the plain versions: the logits of every
    step and its greedy tokens."""
    from distributed_llama_tpu_torch.runtime.engine import Engine

    spec, params = _tp_params(weights, torch.device("cpu"))
    eng = Engine(spec, params, device="cpu", dtype=torch.float32, use_kernels=True,
                 prefill_kernel=True)
    logits, toks = [eng.prefill(_tp_prompt9())], []
    for _ in range(TP_STEPS):
        toks.append(int(np.argmax(logits[-1])))
        logits.append(eng.infer_chunk([toks[-1]]))
    return logits, toks


def _tp_shard_kernels(gen, dev, rate: float) -> None:
    """The kernels this slice runs, each against its plain version at Llama-2-7B's tp = 2
    shard shapes (the kernels phase's tolerances) and timed as the kernels phase times
    them: torch.profiler's device time, one launch a call, the weights (and caches)
    rotated past the L2, a bound beside each. q4_matvec and q8_matvec (bf16 row and
    output) and q4_matmul (M = 64, bf16) on every decode projection's shard,
    decode_attention over a rank's 16 of 32 heads, and the wire's quantize at a one-token
    partial (4096), its reduced chunk (2048) and a whole prefill piece (65536), the card
    synchronized after each call (its launch is programmatic)."""
    from distributed_llama_tpu_torch.ops import decode_attention as da
    from distributed_llama_tpu_torch.ops import prologue as pro
    from distributed_llama_tpu_torch.ops import q4_matmul as mm
    from distributed_llama_tpu_torch.ops import q4_matvec as mv
    from distributed_llama_tpu_torch.ops import q8_matvec as q8

    rows = []

    def row(what, err, dv, plain, nbytes, ops, peak):
        bnd = bound(nbytes, ops, peak, rate)
        rows.append(f"{what}: max|err| {err:.2e}, device {dv:.5f} ms, plain {plain:.4f} "
                    f"ms, bound {bnd[0]:.3g} ms ({bnd[1]}), {bnd[0] / dv:.3f} of it")

    for n, k in SHAPES_7B_TP2:
        wbytes = n * k // 2 + n * k // 32 * 2
        copies = max(1, min(16, math.ceil(2 * L2_BYTES / wbytes)))
        ws = [_random_i4p(n, k, gen, dev) for _ in range(copies)]
        x = _test_row(k, gen, dev, BF16)
        err, _ = _bf16_err(mv._launch(x, *ws[0], BF16), mv.q4_matvec_plain(x, *ws[0]), 1e-4)
        dv = _one_launch_time(lambda i: mv._launch(x, *ws[i % copies], BF16), 50,
                              "q4_matvec_kernel")[1]
        plain = _all_kernels_ms(lambda i: mv.q4_matvec_plain(x, *ws[i % copies]), 5)
        row(f"q4_matvec N={n} K={k}", err, dv, plain, wbytes + k * 2 + n * 2, 2 * n * k,
            "int8")
        xm = torch.randn(64, k, generator=gen, device=dev).to(BF16)
        err, _ = _bf16_err(mm._launch(xm, *ws[0], out_dtype=BF16),
                           mm.q4_matmul_plain(xm, *ws[0]))
        dv = _one_launch_time(lambda i: mm._launch(xm, *ws[i % copies], out_dtype=BF16),
                              20, "q4_matmul_tc_kernel")[1]
        plain = _all_kernels_ms(lambda i: mm.q4_matmul_plain(xm, *ws[i % copies]), 3)
        row(f"q4_matmul M=64 N={n} K={k}", err, dv, plain,
            wbytes + 64 * k * 2 + 64 * n * 2, 2 * 64 * n * k, "bf16")
        del ws
        w8bytes = n * k + n * k // 32 * 4
        copies = max(1, min(16, math.ceil(2 * L2_BYTES / w8bytes)))
        w8s = [_random_i8(gen, dev, n, k) for _ in range(copies)]
        err, _ = _bf16_err(q8._launch(x, *w8s[0], False, BF16),
                           q8.q8_matvec_plain(x, *w8s[0]), 1e-4)
        dv = _one_launch_time(lambda i: q8._launch(x, *w8s[i % copies], False, BF16), 50,
                              "q8_matvec_kernel")[1]
        plain = _all_kernels_ms(lambda i: q8.q8_matvec_plain(x, *w8s[i % copies]), 5)
        row(f"q8_matvec N={n} K={k}", err, dv, plain, w8bytes + k * 2 + n * 2, 2 * n * k,
            "int8")
        del w8s
    hk, hs, s_len, n_layers = 16, 128, 2048, 8  # 8 layers of caches: 128 MiB, past the L2
    layers = [torch.tensor([li], dtype=torch.int32, device=dev) for li in range(n_layers)]
    kc = torch.randn(n_layers, 1, hk, s_len, hs, generator=gen, device=dev).to(BF16)
    vc = torch.randn(n_layers, 1, hk, s_len, hs, generator=gen, device=dev).to(BF16)
    q = torch.randn(hk, 1, hs, generator=gen, device=dev)
    kn = torch.randn(hk, 1, hs, generator=gen, device=dev).to(BF16)
    vn = torch.randn(hk, 1, hs, generator=gen, device=dev).to(BF16)
    for pos, win in ((131, 256), (1027, 2048)):
        pt = torch.tensor([pos], dtype=torch.int64, device=dev)
        y = da._launch(q, kc, vc, kn, vn, layers[2], pt, win)
        ref = da.decode_attention_plain(q, kc, vc, kn, vn, 2, pos, win)
        err, tol = float((y - ref).abs().max()), 1e-4 * float(ref.abs().max())
        if err > tol or not torch.isfinite(y).all():
            raise AssertionError(f"[tp] decode_attention 16 heads pos {pos}: {err:.3e}")
        dv = _one_launch_time(
            lambda i: da._launch(q, kc, vc, kn, vn, layers[i % n_layers], pt, win), 50,
            "decode_attn_kernel")[1]
        plain = _all_kernels_ms(lambda i: da.decode_attention_plain(
            q, kc, vc, kn, vn, i % n_layers, pos, win), 10)
        nbytes = 2 * hk * pos * hs * 2 + q.numel() * 4 + 2 * hk * hs * 2 + y.numel() * 4
        row(f"decode_attention 16 heads pos {pos} win {win}", err, dv, plain, nbytes,
            2 * 4 * hk * (pos + 1) * hs, "bf16")
    del kc, vc
    for k in (4096, 2048, 65536):
        xs = [torch.randn(k, generator=gen, device=dev) for _ in range(4)]
        xq, sx = pro.quantize_q80_row(xs[0])
        pq, ps = pro.quantize_q80_plain(xs[0])
        if not (torch.equal(xq[0], pq) and torch.equal(sx[0], ps)):
            raise AssertionError(f"[tp] quantize_q80 K={k}: not bit-identical to plain")
        dv = _synced_time(lambda i: pro.quantize_q80_row(xs[i % 4]), 50,
                          ("prologue_kernel",))
        plain = _all_kernels_ms(lambda i: pro.quantize_q80_plain(xs[i % 4]), 10)
        row(f"quantize_q80 K={k} (exact)", 0.0, dv, plain, k * 4 + k + k // 32 * 4, 3 * k,
            "f32")
    log("[tp] shard-shape kernels against their plain versions, device times from the "
        "profiler, weights rotated past the L2: " + "; ".join(rows))


def phase_tp(state: dict) -> None:
    """Tensor parallelism on one card: (a) f32 parity of two ranks on cuda:0 over gloo
    against the CPU, (b) Llama-2-7B at full depth with tp = 2, (c) NCCL. Two ranks
    time-slice one card and their wire is staged through the host: the times are a
    wiring figure, not a tensor-parallel speed."""
    import multiprocessing

    from distributed_llama_tpu_torch.parallel import launch
    from distributed_llama_tpu_torch.runtime.engine import (Engine, GenerationStats,
                                                            collective_kbytes_per_token)

    dev = torch.device("cuda")
    _tp_shard_kernels(torch.Generator(device=dev).manual_seed(17), dev, state["rate"])

    # (a) f32 parity, 2 layers at full 7B width, raw and Q80 wire, Q40 and Q80 weights
    t0 = time.perf_counter()
    ref1 = {w: _tp_cpu_reference(w) for w in ("q40", "q80")}
    # the Q80 wire's own CPU run (tp = 2 over gloo, plain versions): its numerics are the
    # wire's, which tp = 1 has not
    ref2 = launch.run("chip_smoke:tp_rank_parity", TP, "cpu",
                      args=([("q40", True, None), ("q80", True, None)],), deadline=600)
    cases = [("q40", False, ref1["q40"][1]), ("q40", True, ref2[0][0]["tokens"]),
             ("q80", False, ref1["q80"][1]), ("q80", True, ref2[0][1]["tokens"])]
    card = launch.run("chip_smoke:tp_rank_parity", TP, "cuda:0", backend="gloo",
                      args=(cases,), deadline=600)
    spec2 = _llama2_7b(n_layers=2)
    matvec = {"q40": "q4_matvec", "q80": "q8_matvec"}
    for i, (weights, compress, _) in enumerate(cases):
        tag = f"{weights.upper()} weights, {'Q80' if compress else 'raw'} wire"
        # the Q40 weights' rule is 2e-3; Q80 weights take engine_parity's crossing
        # rule's 2e-2: the tp split sums each projection in another f32 order than one
        # card, and q8_matvec quantizes every activation row to Q80, where a value within
        # an ulp of a rounding boundary moves a code
        tol = 2e-3 if weights == "q40" else 2e-2
        want = ref2[0][i // 2]["logits"] if compress else ref1[weights][0]
        worst, ties = _tp_held(f"(a) {tag}", card[0][i]["logits"], want, tol)
        wire_note = ""
        if compress:
            # the Q80 wire against tp = 1: the wire's own error, over the steps whose
            # fed history is still tp = 1's (the wire's greedy tokens may part from it)
            fed, toks1 = card[0][i]["tokens"], ref1[weights][1]
            part = next((k for k, (a, b) in enumerate(zip(fed, toks1)) if a != b), None)
            upto = TP_STEPS + 1 if part is None else part + 1
            dev1 = max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in
                       zip(card[0][i]["logits"][:upto], ref1[weights][0][:upto]))
            wire_note = (f"; against the CPU's tp=1 {dev1:.3e}·max over the first {upto} "
                         f"steps, the wire's greedy tokens "
                         + ("tp=1's" if part is None else f"part from tp=1's at step {part}"))
        steps = TP_STEPS + 1  # the 1-token tail of the prompt and the fed steps
        per = 4 * spec2.n_layers + 1
        sched = {matvec[weights]: steps * per, "decode_attention": steps * spec2.n_layers,
                 "q4_matmul": _mm_launches(spec2, TP) if weights == "q40" else 0,
                 "quantize_q80": (_wire_launches(8, spec2, TP) + steps
                                  * _wire_launches(1, spec2, TP)) if compress else 0}
        for r in range(TP):
            got = {k: card[r][i]["launches"][k] for k in sched}
            if got != sched:
                raise AssertionError(f"[tp] (a) {tag} rank {r}: launches {got}, "
                                     f"schedule {sched}")
        model = collective_kbytes_per_token(spec2, TP, compress) * 1024
        if any(card[r][i]["bytes_per_step"] != model for r in range(TP)):
            raise AssertionError(f"[tp] (a) {tag}: counted bytes "
                                 f"{[c[i]['bytes_per_step'] for c in card]} != {model}")
        log(f"[tp] (a) 2-layer Llama-2-7B width, f32, {tag}, 2 ranks on cuda:0 over gloo "
            f"against the CPU {'tp=2 run of the same wire' if compress else 'tp=1 run'}: "
            f"9-token prompt + {TP_STEPS} steps, greedy picks "
            + (f"identical but at near-ties (step, gap/max) {ties}" if ties
               else "identical")
            + f", worst max|Δlogits|/max {worst:.3e} (rule {tol:.0e}){wire_note}; "
            f"launches per rank {json.dumps(sched)}; wire {model:.0f} B a step")
    log(f"[tp] (a) done in {time.perf_counter() - t0:.1f} s")

    # (b) Llama-2-7B at 32 layers, bf16, tp = 2 on cuda:0, Q80 wire and raw wire
    t0 = time.perf_counter()
    spec = _llama2_7b()
    ref = Engine(spec, _random_i4p_params(spec, dev, seed=11), prefill_kernel=True)
    first1 = ref.prefill(_prompt_100(spec))
    toks1 = ref._decode(first1, TP_TOKENS, _CheckedSampler(spec.vocab_size),
                        GenerationStats())
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    full = launch.run("chip_smoke:tp_rank_full", TP, "cuda:0", backend="gloo",
                      args=(("q80", "raw"),), deadline=900)
    per, L = 4 * spec.n_layers + 1, spec.n_layers
    for wire in ("q80", "raw"):
        r0 = full[0][wire]
        model = collective_kbytes_per_token(spec, TP, wire == "q80") * 1024
        sched = {"q4_matvec": TP_TOKENS * per, "decode_attention": TP_TOKENS * L,
                 "quantize_q80": TP_TOKENS * _wire_launches(1, spec, TP)
                 if wire == "q80" else 0}
        pre = {"q4_matmul": 5 * _mm_launches(spec, TP), "q4_matvec": 4 * per,
               "decode_attention": 4 * L,
               "quantize_q80": (_wire_launches(64, spec, TP) + 4 * _wire_launches(8, spec, TP)
                                + 4 * _wire_launches(1, spec, TP)) if wire == "q80" else 0}
        for r in range(TP):
            row = full[r][wire]
            got = {k: row["launches"][k] for k in sched}
            got_pre = {k: row["prefill_launches"][k] for k in pre}
            if got != sched or got_pre != pre:
                raise AssertionError(f"[tp] (b) {wire} rank {r}: launches {got} / prefill "
                                     f"{got_pre}, schedule {sched} / {pre}")
            if row["bytes_per_token"] != model or row["counted"] != model:
                raise AssertionError(f"[tp] (b) {wire} rank {r}: counted "
                                     f"{row['bytes_per_token']} B a token, model {model}")
            if row["tokens"] != r0["tokens"]:
                raise AssertionError(f"[tp] (b) {wire}: ranks decoded different tokens")
            if row["peak"] > row["held"] + TP_PEAK_MARGIN:
                raise AssertionError(
                    f"[tp] (b) {wire} rank {r}: peak {row['peak'] / 2**30:.3f} GiB on the "
                    f"card against its shard and KV caches {row['held'] / 2**30:.3f} GiB "
                    f"+ {TP_PEAK_MARGIN / 2**30:.2f}")
        err = float(np.abs(r0["first"] - first1).max() / np.abs(first1).max())
        if err > TP_FIRST_TOL[wire] or not np.isfinite(r0["first"]).all():
            raise AssertionError(f"[tp] (b) {wire}: first-step logits {err:.3e}·max from "
                                 f"tp=1, tolerance {TP_FIRST_TOL[wire]}")
        part = next((i for i, (a, b) in enumerate(zip(r0["tokens"], toks1)) if a != b),
                    None)
        ms = np.array(r0["ms"])
        log(f"[tp] (b) Llama-2-7B 32 layers bf16 Q40, tp=2 ({wire} wire), two ranks "
            f"time-slicing cuda:0 over gloo (host-staged: a wiring figure, not a tp "
            f"speed): 100-token prompt {r0['prefill_ms']:.1f} ms, {TP_TOKENS} greedy "
            f"tokens {ms.mean():.3f} ms/token (rank 0 wall; min {ms.min():.3f}, median "
            f"{np.median(ms):.3f}, max {ms.max():.3f}); wire {r0['bytes_per_token']:.1f} B a "
            f"token = collective_kbytes_per_token {model / 1024:.1f} kB (exact); launches "
            f"per rank on the schedule {json.dumps(sched)} + prefill {json.dumps(pre)}; "
            f"first-step logits {err:.3e}·max from tp=1 (tolerance {TP_FIRST_TOL[wire]}); "
            f"greedy tokens part from tp=1 at "
            f"{'none of ' + str(TP_TOKENS) if part is None else 'position ' + str(part)}; "
            f"memory per rank on the card, the Engine built from host weights in "
            + ", ".join(f"{full[r][wire]['load_s']:.1f}" for r in range(TP))
            + " s: shard + KV caches "
            + ", ".join(f"{full[r][wire]['held'] / 2**30:.3f}" for r in range(TP))
            + " GiB, resident "
            + ", ".join(f"{full[r][wire]['resident'] / 2**30:.3f}" for r in range(TP))
            + " GiB, peak " + ", ".join(f"{full[r][wire]['peak'] / 2**30:.3f}"
                                        for r in range(TP))
            + f" GiB (held within shard + KV + {TP_PEAK_MARGIN / 2**30:.2f} GiB)")
    log(f"[tp] (b) done in {time.perf_counter() - t0:.1f} s")

    # (c) NCCL: a world of one, eager and captured; two ranks on one card; two cards
    t0 = time.perf_counter()
    one = launch.run("chip_smoke:tp_rank_nccl_one", 1, "cuda:0", backend="nccl",
                     deadline=300)[0]
    if not (one["eager"] and one["graph"]):
        raise AssertionError(f"[tp] (c) NCCL world of one: {one}")
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_nccl_pair_one_card,
                             args=(q, r, "file://" + os.path.join(tmp, "rdv")))
                 for r in range(2)]
        for p in procs:
            p.start()
        words = dict(q.get(timeout=120) for _ in procs)
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
    log(f"[tp] (c) NCCL world of one on cuda:0: all-reduce, the Q80 two-phase wire and "
        f"the logits gather bit-exact eager and in a CUDA graph replayed on new inputs; "
        f"two NCCL ranks on cuda:0: rank 0 {words[0]!r}; rank 1 {words[1]!r}")
    if torch.cuda.device_count() >= 2:
        across = launch.run("chip_smoke:tp_rank_parity", TP, ["cuda:0", "cuda:1"],
                            backend="nccl", args=(cases[:1],), deadline=600)
        worst, _ = _tp_held("(c) NCCL cuda:0 + cuda:1", across[0][0]["logits"],
                            ref1["q40"][0])
        log(f"[tp] (c) (a)'s Q40 raw-wire case over NCCL on cuda:0 and cuda:1: worst "
            f"{worst:.3e}")
    else:
        log(f"[tp] (c) NCCL across cards not run: torch.cuda.device_count() is "
            f"{torch.cuda.device_count()} on this machine")
    log(f"[tp] (c) done in {time.perf_counter() - t0:.1f} s")


def phase_cli(state: dict) -> None:
    from distributed_llama_tpu_torch.formats.mfile import params_file_order, write_model
    from distributed_llama_tpu_torch.formats.tfile import TokenizerData, write_tokenizer
    from distributed_llama_tpu_torch.models.params import init_random_params
    from distributed_llama_tpu_torch.models.spec import ArchType, ModelSpec
    from distributed_llama_tpu_torch.quants import FloatType

    vocab = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)] + [b" ", b"he",
                                                                          b"llo"]
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=256, hidden_dim=512, n_layers=2,
                     n_heads=4, n_kv_heads=2, vocab_size=len(vocab), seq_len=128).resolved()
    with tempfile.TemporaryDirectory() as tmp:
        mpath, tpath = os.path.join(tmp, "tiny.m"), os.path.join(tmp, "tiny.t")
        params = init_random_params(spec, FloatType.Q40, seed=2)
        write_model(mpath, spec, params_file_order(spec, params), FloatType.Q40)
        write_tokenizer(tpath, TokenizerData(vocab=vocab, scores=[0.0] * 259 + [-1.0] * 3,
                                             bos_id=1, eos_id=2, max_token_length=4))
        cmd = [sys.executable, "-m", "distributed_llama_tpu_torch.apps.dllama", "generate",
               "--model", mpath, "--tokenizer", tpath, "--steps", "16", "--prompt",
               "hello", "--temperature", "0", "--seed", "1"]
        tpath_json = os.path.join(tmp, "trace.json")
        f32 = cmd + ["--dtype", "float32"]
        tp2 = f32 + ["--tp", "2", "--device", "cuda:0", "--dist-backend", "gloo"]
        runs = [subprocess.run(c, cwd=ROOT, capture_output=True, timeout=300)
                for c in (cmd, cmd + ["--device-loop", "8", "--trace", tpath_json], f32,
                          tp2 + ["--buffer-float-type", "f32"], tp2)]
        for res in runs:
            # random weights emit arbitrary byte pieces: decode leniently
            out = res.stdout.decode("utf-8", "replace")
            if res.returncode != 0:
                raise AssertionError(f"CLI exited {res.returncode}:\n{out}\n"
                                     f"{res.stderr.decode('utf-8', 'replace')}")
        with open(tpath_json) as f:
            spans = collections.Counter(e["name"] for e in json.load(f)["traceEvents"]
                                        if e.get("ph") == "X")
        texts = [r.stdout.rstrip(b"\n").split(b"\n")[-1] for r in runs]
        q80_note = _cli_q80_wire(mpath, tpath, texts[4], texts[2])
    if not spans["engine.prefill"] or not spans["engine.device_loop"]:
        raise AssertionError(f"cli: dllama --trace wrote the spans {dict(spans)}")
    out = runs[0].stdout.decode("utf-8", "replace")
    loaded = [ln for ln in out.splitlines() if ln.startswith("⏩")]
    text1, text2 = texts[2:4]
    if text1 != text2:
        raise AssertionError(f"cli: --tp 2 printed {text2!r}, --tp 1 {text1!r}")
    loaded2 = [ln for ln in runs[3].stdout.decode("utf-8", "replace").splitlines()
               if ln.startswith("⏩")]
    log(f"[cli] dllama generate exited 0: {loaded[0] if loaded else out[-200:]!r}; "
        f"with --device-loop 8 --trace: spans {json.dumps(dict(spans))}; --tp 2 --device "
        f"cuda:0 --dist-backend gloo --dtype float32 --buffer-float-type f32 "
        f"({loaded2[0] if loaded2 else ''}) printed --tp 1's f32 text; the same on the "
        f"Q80 wire (the CLI's default): {q80_note}")


CLI_STEPS = 16  # the cli phase's generated tokens


def cli_rank_q80(mesh, mpath: str, tpath: str, feed):
    """The cli phase's Q80-wire generation on one rank as `dllama generate --tp 2 --dtype
    float32 --temperature 0 --prompt hello` runs it (Engine.load on the rank's mesh,
    the kernels on (their plain versions on the CPU), the Q80 wire): rank 0's greedy
    picks broadcast, or `feed`'s tokens where given. Returns the tokens, the text the
    CLI prints for them, and on rank 0 the logits each token was picked from."""
    from distributed_llama_tpu_torch.parallel.collectives import broadcast_int
    from distributed_llama_tpu_torch.runtime.engine import Engine

    if mesh.device.type == "cpu":
        torch.set_num_threads(4)
    eng = Engine.load(mpath, tpath, mesh=mesh, dtype=torch.float32, use_kernels=True,
                      compress_collectives=True)
    tok = eng.tokenizer
    prompt = tok.encode("hello", add_bos=True)
    logits, toks = [eng.prefill(prompt)], []
    for step in range(CLI_STEPS):
        toks.append(feed[step] if feed is not None
                    else broadcast_int(int(np.argmax(logits[-1])), mesh))
        if step + 1 < CLI_STEPS:
            logits.append(eng.infer_chunk([toks[-1]]))
    text, prev = b"", prompt[-1]
    for t in toks:
        text, prev = text + tok.decode_piece(prev, t), t
    return {"tokens": toks, "text": text, "logits": logits if mesh.rank == 0 else None}


def _cli_q80_wire(mpath: str, tpath: str, printed: bytes, printed_tp1: bytes) -> str:
    """The card's Q80-wire CLI text, held: the same generation in a world of 2 on
    cuda:0 must print it; that run's logits, held by `_tp_held` (2e-3·max|logits|, the
    near-tie rule) against the same wire's world of 2 on the CPU fed the same tokens;
    where its tokens part from tp = 1's (the CPU, fed the same tokens), tp = 1's own
    top-two gap there and the wire's deviation, logged. Returns the log's note."""
    from distributed_llama_tpu_torch.parallel import launch
    from distributed_llama_tpu_torch.runtime.engine import Engine

    card = launch.run("chip_smoke:cli_rank_q80", 2, "cuda:0", backend="gloo",
                      args=(mpath, tpath, None), deadline=300)
    if any(r["text"] != printed for r in card):
        raise AssertionError(f"cli: the Q80 wire's CLI printed {printed!r}, the same run "
                             f"in a world of 2 {card[0]['text']!r}")
    toks = card[0]["tokens"]
    cpu = launch.run("chip_smoke:cli_rank_q80", 2, "cpu", args=(mpath, tpath, toks),
                     deadline=300)
    worst, ties = _tp_held("cli Q80 wire, the card against the CPU", card[0]["logits"],
                           cpu[0]["logits"])
    eng = Engine.load(mpath, tpath, device="cpu", dtype=torch.float32, use_kernels=True)
    ref = [eng.prefill(eng.tokenizer.encode("hello", add_bos=True))]
    for t in toks[:-1]:
        ref.append(eng.infer_chunk([t]))
    part = next((i for i, (t, w) in enumerate(zip(toks, ref)) if t != int(np.argmax(w))),
                None)
    if part is None:
        wire1 = "its tokens are tp=1's"
    else:
        w, g = ref[part], card[0]["logits"][part]
        scale = float(np.abs(w).max())
        wire1 = (f"its pick parts from tp=1's at step {part} ({toks[part]} against "
                 f"{int(np.argmax(w))}), where tp=1's own top two lie "
                 f"{float(w.max() - w[toks[part]]) / scale:.3e}·max|logits| apart and the "
                 f"wire moves the logits {float(np.abs(g - w).max()) / scale:.3e}·max")
    return (f"printed {printed!r} (--tp 1: {printed_tp1!r}), the text of the same run in a "
            f"world of 2 on cuda:0, whose logits lie within {worst:.3e}·max|logits| of "
            f"the same wire's world of 2 on the CPU fed its tokens (rule 2e-03"
            + (f", near-ties (step, gap/max) {ties}" if ties else ", picks identical")
            + f"); {wire1}")


def kernels_line(state: dict) -> str:
    rows = []
    for name, (source, replaces, path) in KERNELS.items():
        rec = state["kernel_rows"][name]
        by = rec["bound_by"]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"distributed_llama_tpu_torch/csrc/{source}.cu",
            "replaces": replaces,
            "launches": state["launches"][name], "path": path,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": max(by, key=by.get), "library_ms": rec["library_ms"],
            "work": "sum over " + "; ".join(rec["work"]),
        })
    return json.dumps({"kernels": rows})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import distributed_llama_tpu_torch  # noqa: F401 — fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state: dict = {"kernel_rows": {}, "launches": {}, "phases": phases}
    t0 = time.perf_counter()
    for name in ALL_PHASES:
        if name in phases or name == "env":
            t = time.perf_counter()
            globals()[f"phase_{name}"](state)
            log(f"[{name}] done in {time.perf_counter() - t:.1f} s")
    log(f"[total] {time.perf_counter() - t0:.1f} s")
    # launches come from the model, q80, serve, spec and moe phases' runs
    if {"kernels", "model", "q80", "serve", "spec", "moe"} <= set(phases):
        log(kernels_line(state))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
