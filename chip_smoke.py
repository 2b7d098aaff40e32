"""Chip smoke test of the PyTorch/CUDA port (distributed_llama_tpu_torch) on one GPU.

    python3 chip_smoke.py                      # every phase, as the check runs it
    python3 chip_smoke.py --phases env,build,kernels

Phases, each printing its own line(s); any failure raises and exits nonzero:
  env       torch/CUDA versions, the card's name and power limit (nvidia-smi)
  build     nvcc for every kernel source, all started together; build seconds
  parity    a 2-layer model at full Llama-2-7B width in f32 with seeded weights: the
            card with kernels against the CPU with the plain versions — the Engine
            (logits within tolerance, identical greedy tokens for 8 steps) and the
            fused BatchEngine on 4 staggered requests (identical greedy tokens, logits
            step by step within tolerance)
  model     Engine at full Llama-2-7B (32 layers, random Q40 weights drawn on the card in
            i4p layout, bf16, prefill_kernel): a 100-token prompt (chunks 64, 8, 1) and
            64 greedy tokens, with every kernel's launch count over that run
  serve     BatchEngine at full Llama-2-7B (8 slots, fused_matmul, paged KV of 1033
            blocks of 16 tokens): 8 staggered requests of 16-300 prompt tokens and 48
            greedy tokens each; launch counts against the schedule, tokens/s, ms per
            batched decode step, time to first token, peak memory, the pool drained,
            and the device-busy share of 8 profiled decode steps
  http      the port's api_server serve() on the same 7B engine with a synthetic
            32000-piece tokenizer: 4 concurrent chat completions (one SSE) over HTTP
  kernels   each kernel against its plain torch version on the card at the main paths'
            shapes: max|err| against its tolerance, time per launch after warm-up,
            the plain version's time, the bound, and a PyTorch yardstick where one exists
  cli       `python -m distributed_llama_tpu_torch.apps.dllama generate` on a tiny
            .m/.t pair written by the port's writers

When the model, serve and kernels phases all ran, it prints before the last line
{"kernels": [...]} (per kernel: route, source, the TPU kernel it replaces, launches in
its path's run — the model phase for the single-sequence kernels, the serve phase for
the serving kernels — max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms). The
last line is {"ok": true, "device": {...}}. Exits nonzero without printing a result when
no CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# the model phase runs before the profiler-timed kernel phase, so its host-side step
# times are not taken with profiler hooks installed
ALL_PHASES = ("env", "build", "parity", "model", "serve", "http", "kernels", "cli")
SOURCES = ("q4_matvec", "q4_matmul", "decode_attention", "q4_gated_matmul",
           "paged_attention")
# kernel row -> (CUDA source, TPU kernel it replaces, the phase whose run counts it)
KERNELS = {
    "q4_matvec": ("q4_matvec", "distributed_llama_tpu/ops/pallas_q4.py:142", "model"),
    "q4_matmul": ("q4_matmul", "distributed_llama_tpu/ops/pallas_q4_mm.py:200", "model"),
    "decode_attention": ("decode_attention",
                         "distributed_llama_tpu/ops/pallas_attention.py:191", "model"),
    "q4_matmul_res": ("q4_matmul", "distributed_llama_tpu/ops/pallas_q4_mm.py:220",
                      "serve"),
    "q4_gated_matmul": ("q4_gated_matmul",
                        "distributed_llama_tpu/ops/pallas_q4_mm.py:246", "serve"),
    "paged_attention": ("paged_attention",
                        "distributed_llama_tpu/ops/pallas_paged_attention.py:176",
                        "serve"),
}
# decode projections of Llama-2-7B as (N, K): wqkv, wo, w13, w2, wcls
SHAPES_7B = ((12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008), (32000, 4096))
# data-sheet memory rate (bytes/s) by card name; dense peaks from the H100 SXM data sheet
MEM_RATE = (("H200", 4.8e12), ("NVL", 3.9e12), ("PCIe", 2.0e12), ("H100", 3.35e12))
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
L2_BYTES = 50 << 20
# the serve phase's query tokens per row (decode, 8- and 64-token prefill chunks) and
# its matmul row counts, 8 slots x T
SERVE_CHUNKS = (1, 8, 64)
SERVE_ROWS = tuple(8 * t for t in SERVE_CHUNKS)


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


def device_ms(fn, iters: int, names: tuple[str, ...]) -> float | None:
    """Device time per call of the kernels whose CUDA names contain any of `names`,
    from torch.profiler; None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if any(n in ev.key for n in names):
            total += getattr(ev, "self_device_time_total", 0.0) or getattr(
                ev, "self_cuda_time_total", 0.0)
    return total / iters / 1e3 if total > 0 else None


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


def _random_i4p(n: int, k: int, gen: torch.Generator, dev) -> tuple[torch.Tensor, ...]:
    packed = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, generator=gen, device=dev)
    scales = (torch.rand((n, k // 32), generator=gen, device=dev) * 0.004 + 0.002
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


def _kernel_time(fn, iters: int, names: tuple[str, ...]) -> tuple[float, float | None]:
    return event_ms(fn, iters), device_ms(fn, iters, names)


def _all_kernels_ms(fn, iters: int) -> float:
    """Device time per call of every kernel fn launches (the plain versions and the
    PyTorch yardstick), falling back to CUDA events."""
    dv = device_ms(fn, iters, ("",))
    return dv if dv is not None else event_ms(fn, iters)


def phase_kernels(state: dict) -> None:
    from distributed_llama_tpu_torch.ops import decode_attention as da
    from distributed_llama_tpu_torch.ops import q4_matmul as mm
    from distributed_llama_tpu_torch.ops import q4_matvec as mv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    rate = state["rate"]

    # kernel 1 — tolerance 1e-4·max|y|: the block dots are exact integers and only the
    # order of the f32 sum over K/32 block terms differs (relative error ~K/32·2^-24)
    for n, k in SHAPES_7B:
        wbytes = n * k // 2 + n * k // 32 * 2
        copies = max(1, min(16, math.ceil(2 * L2_BYTES / wbytes)))  # defeat L2 reuse
        ws = [_random_i4p(n, k, gen, dev) for _ in range(copies)]
        x = torch.randn(k, generator=gen, device=dev).to(torch.bfloat16)
        y = mv._launch(x, *ws[0])
        ref = mv.q4_matvec_plain(x, *ws[0])
        err = (y - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()
        ev, dv = _kernel_time(lambda i: mv._launch(x, *ws[i % copies]), 50, ("q4_matvec",))
        plain = _all_kernels_ms(lambda i: mv.q4_matvec_plain(x, *ws[i % copies]), 5)
        nbytes = wbytes + k * 2 + n * 4
        bnd = bound(nbytes, 2 * n * k, "int8", rate)
        ms = dv if dv is not None else ev
        log(f"[kernels] q4_matvec N={n} K={k}: max|err| {err:.3e} (tol {tol:.3e}) "
            f"device {dv if dv is None else round(dv, 5)} ms, events {ev:.5f} ms, "
            f"plain {plain:.3f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}), "
            f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
        _record(state, "q4_matvec", err, tol, ms, plain, bnd, None, f"N={n},K={k}")

    # kernel 2 — tolerance 1e-3·max|y|: bf16 operands are rounded identically, so only
    # the accumulation order and the tensor cores' f32 accumulate rounding differ
    # M = 8 and 64: the model phase's 8- and 64-token chunks (all five projections) and
    # the serve phase's decode and 8-token mixed steps; M = 512: the serve phase's
    # 64-token mixed steps, where wqkv and wcls are this kernel's
    cases = [(m, n, k) for m in (8, 64) for n, k in SHAPES_7B]
    cases += [(512, n, k) for n, k in (SHAPES_7B[0], SHAPES_7B[4])]
    for m, n, k in cases:
        wbytes = n * k // 2 + n * k // 32 * 2
        copies = max(1, min(16, math.ceil(2 * L2_BYTES / wbytes)))
        ws = [_random_i4p(n, k, gen, dev) for _ in range(copies)]
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        y = mm._launch(x, *ws[0])
        ref = mm.q4_matmul_plain(x, *ws[0])
        err = (y - ref).abs().max().item()
        tol = 1e-3 * ref.abs().max().item()
        ev, dv = _kernel_time(lambda i: mm._launch(x, *ws[i % copies]), 20,
                              ("q4_matmul",))
        plain = _all_kernels_ms(lambda i: mm.q4_matmul_plain(x, *ws[i % copies]), 3)
        nbytes = wbytes + m * k * 2 + m * n * 4
        bnd = bound(nbytes, 2 * m * n * k, "bf16", rate)
        ms = dv if dv is not None else ev
        log(f"[kernels] q4_matmul M={m} N={n} K={k}: max|err| {err:.3e} "
            f"(tol {tol:.3e}) device {dv if dv is None else round(dv, 5)} ms, "
            f"events {ev:.5f} ms, plain {plain:.3f} ms, bound {bnd[0]:.5f} ms "
            f"({bnd[1]}), {2 * m * n * k / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
        _record(state, "q4_matmul", err, tol, ms, plain, bnd, None, f"M={m},N={n},K={k}")

    # kernel 3 — tolerance 1e-4·max|out|: bf16 rows widen exactly to f32 and the
    # softmax runs in f32 in both; only the order of the sums (split merge) differs
    n_layers, s_len = 8, 2048
    for hk, g in ((32, 1), (8, 4)):
        hs = 128
        kc = torch.randn(n_layers, 1, hk, s_len, hs, generator=gen, device=dev).to(
            torch.bfloat16)
        vc = torch.randn(n_layers, 1, hk, s_len, hs, generator=gen, device=dev).to(
            torch.bfloat16)
        q = torch.randn(hk, g, hs, generator=gen, device=dev)
        kn = torch.randn(hk, 1, hs, generator=gen, device=dev).to(torch.bfloat16)
        vn = torch.randn(hk, 1, hs, generator=gen, device=dev).to(torch.bfloat16)
        for win in (256, 2048):
            for pos in (win // 2 + 3, win):
                out = da._launch(q, kc, vc, kn, vn, 2, pos, win)
                ref = da.decode_attention_plain(q, kc, vc, kn, vn, 2, pos, win)
                err = (out - ref).abs().max().item()
                tol = 1e-4 * ref.abs().max().item()
                ev, dv = _kernel_time(
                    lambda i: da._launch(q, kc, vc, kn, vn, i % n_layers, pos, win), 50,
                    ("attn_split_kernel", "attn_merge_kernel"))
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
                bnd = bound(nbytes, 4 * hk * g * (pos + 1) * hs, "f32", rate)
                ms = dv if dv is not None else ev
                log(f"[kernels] decode_attention hk={hk} g={g} win={win} pos={pos}: "
                    f"max|err| {err:.3e} (tol {tol:.3e}) device "
                    f"{dv if dv is None else round(dv, 5)} ms, events {ev:.5f} ms, "
                    f"plain {plain:.3f} ms, sdpa {lib:.5f} ms, bound {bnd[0]:.5f} ms "
                    f"({bnd[1]}), {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
                _record(state, "decode_attention", err, tol, ms, plain, bnd, lib,
                        f"hk={hk},g={g},win={win},pos={pos}")
        del kc, vc
    torch.cuda.empty_cache()
    _kernels_serving(state, gen, dev, rate)
    torch.cuda.empty_cache()


def _kernels_serving(state: dict, gen, dev, rate: float) -> None:
    """Kernels 4, 5 and 9 against their plain versions at the serve phase's shapes."""
    from distributed_llama_tpu_torch.ops import paged_attention as pa
    from distributed_llama_tpu_torch.ops import q4_gated_matmul as gm
    from distributed_llama_tpu_torch.ops import q4_matmul as mm

    # every row count the serve phase sends kernels 4 and 5: M = 8 slots x T for decode
    # steps (T = 1) and 8- and 64-token mixed steps
    # kernel 4 — tolerance 1e-3·max|y|, as kernel 2: identical bf16 operands, f32 sums in
    # another order, and the residual added in f32 on both sides
    for m in SERVE_ROWS:
        for n, k in ((4096, 4096), (4096, 11008)):
            wbytes = n * k // 2 + n * k // 32 * 2
            copies = max(1, min(16, math.ceil(2 * L2_BYTES / wbytes)))
            ws = [_random_i4p(n, k, gen, dev) for _ in range(copies)]
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            res = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
            y = mm._launch(x, *ws[0], res)
            ref = mm.q4_matmul_res_plain(x, *ws[0], res)
            err = (y - ref).abs().max().item()
            tol = 1e-3 * ref.abs().max().item()
            ev, dv = _kernel_time(lambda i: mm._launch(x, *ws[i % copies], res), 20,
                                  ("q4_matmul_kernel", "sum_splits_kernel"))
            plain = _all_kernels_ms(
                lambda i: mm.q4_matmul_res_plain(x, *ws[i % copies], res), 3)
            nbytes = wbytes + m * k * 2 + m * n * 2 + m * n * 4
            bnd = bound(nbytes, 2 * m * n * k, "bf16", rate)
            ms = dv if dv is not None else ev
            log(f"[kernels] q4_matmul_res M={m} N={n} K={k}: max|err| {err:.3e} "
                f"(tol {tol:.3e}) device {dv if dv is None else round(dv, 5)} ms, "
                f"events {ev:.5f} ms, plain {plain:.3f} ms, bound {bnd[0]:.5f} ms "
                f"({bnd[1]}), {2 * m * n * k / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
            _record(state, "q4_matmul_res", err, tol, ms, plain, bnd, None,
                    f"M={m},N={n},K={k}")

    # kernel 5 — tolerance 1e-3·max|y|: both products as kernel 2, the activation on the
    # same f32 sums (expf/tanhf on the card against torch's on the card)
    n, k = 11008, 4096
    wbytes = 2 * (n * k // 2 + n * k // 32 * 2)
    copies = max(1, min(16, math.ceil(2 * L2_BYTES / wbytes)))
    pairs = [(_random_i4p(n, k, gen, dev), _random_i4p(n, k, gen, dev))
             for _ in range(copies)]
    for m in SERVE_ROWS:
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        y = gm._launch(x, *pairs[0], "silu")
        ref = gm.q4_gated_matmul_plain(x, *pairs[0], "silu")
        err = (y - ref).abs().max().item()
        tol = 1e-3 * ref.abs().max().item()
        ev, dv = _kernel_time(lambda i: gm._launch(x, *pairs[i % copies], "silu"), 20,
                              ("gated_kernel", "gated_sum_kernel"))
        plain = _all_kernels_ms(
            lambda i: gm.q4_gated_matmul_plain(x, *pairs[i % copies], "silu"), 3)
        nbytes = wbytes + m * k * 2 + m * n * 4
        bnd = bound(nbytes, 4 * m * n * k, "bf16", rate)
        ms = dv if dv is not None else ev
        log(f"[kernels] q4_gated_matmul M={m} N={n} K={k} silu: max|err| {err:.3e} "
            f"(tol {tol:.3e}) device {dv if dv is None else round(dv, 5)} ms, events "
            f"{ev:.5f} ms, plain {plain:.3f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}), "
            f"{4 * m * n * k / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
        _record(state, "q4_gated_matmul", err, tol, ms, plain, bnd, None,
                f"M={m},N={n},K={k}")
    del pairs

    # kernel 9 — tolerance 1e-4·max|out|: bf16 rows widen exactly to f32 and the softmax
    # runs in f32 in both; only the order of the sums differs. NaN fills the scratch
    # block, the blocks no table holds, and the rows past each length in live blocks.
    b, hk, hs, bt, n_layers = 8, 32, 128, 16, 2
    n_blocks = b * (2048 // bt) + 1
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for win in (256, 2048):
        for t in SERVE_CHUNKS:
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
            ev, dv = _kernel_time(
                lambda i: pa._launch(q, kc, vc, kn, vn, tables, lens, layer, n_read), 30,
                ("paged_split_kernel", "paged_merge_kernel"))
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
            ops = sum(4 * hk * t * (ln + t) * hs for ln in lengths)
            bnd = bound(nbytes, ops, "f32", rate)
            ms = dv if dv is not None else ev
            log(f"[kernels] paged_attention B={b} T={t} win={win} hk={hk}: max|err| "
                f"{err:.3e} (tol {tol:.3e}) device {dv if dv is None else round(dv, 5)} "
                f"ms, events {ev:.5f} ms, plain {plain:.3f} ms, sdpa {lib:.5f} ms, bound "
                f"{bnd[0]:.5f} ms ({bnd[1]}), {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
            _record(state, "paged_attention", err, tol, ms, plain, bnd, lib,
                    f"B={b},T={t},win={win}")
            del kf, vf, kc, vc


def _random_i4p_params(spec, dev, seed: int, gate_pair: bool = False):
    """Llama params with random Q40 weights drawn on `dev` directly in the i4p layout
    the kernels take, from a seeded torch.Generator: wqkv, wo, w2, wcls, and either the
    merged w13 (the single-sequence Engine) or the separate w1/w3 of the gate-pair
    kernel (`gate_pair`, the fused serving engine)."""
    from distributed_llama_tpu_torch.quants import FloatType, QTensor

    gen = torch.Generator(device=dev).manual_seed(seed)
    L, d, h = spec.n_layers, spec.dim, spec.hidden_dim

    def q40(*shape):
        n, k = shape[-2], shape[-1]
        packed = torch.randint(0, 256, (*shape[:-2], n, k // 2), dtype=torch.uint8,
                               generator=gen, device=dev)
        scales = (torch.rand((*shape[:-2], n, k // 32), generator=gen, device=dev)
                  * 0.004 + 0.002).to(torch.float16)
        return QTensor(FloatType.Q40, packed, scales, layout="i4p")

    def norm(*shape):
        return 1.0 + 0.02 * torch.randn(*shape, generator=gen, device=dev)

    blocks = {"wqkv": q40(L, d + 2 * spec.kv_dim, d), "wo": q40(L, d, d)}
    if gate_pair:
        blocks.update(w1=q40(L, h, d), w3=q40(L, h, d))
    else:
        blocks["w13"] = q40(L, 2 * h, d)
    blocks.update(w2=q40(L, d, h), rms_att=norm(L, d), rms_ffn=norm(L, d))
    return {"embedding": 0.02 * torch.randn(spec.vocab_size, d, generator=gen, device=dev),
            "blocks": blocks, "rms_final": norm(d), "wcls": q40(spec.vocab_size, d)}


def _llama2_7b(n_layers: int = 32):
    from distributed_llama_tpu_torch.models.spec import ArchType, ModelSpec

    return ModelSpec(arch_type=ArchType.LLAMA, dim=4096, hidden_dim=11008,
                     n_layers=n_layers, n_heads=32, n_kv_heads=32, vocab_size=32000,
                     seq_len=2048).resolved()


class _CheckedSampler:
    """Greedy sampling that asserts every logits row it sees is finite, optionally
    keeping a copy of each row."""

    def __init__(self, vocab_size: int, keep: bool = False):
        from distributed_llama_tpu_torch.runtime.sampler import Sampler

        self.inner = Sampler(vocab_size, temperature=0.0)
        self.rows = 0
        self.kept: list[np.ndarray] = [] if keep else None

    def sample(self, logits: np.ndarray) -> int:
        if not np.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        self.rows += 1
        if self.kept is not None:
            self.kept.append(np.array(logits, dtype=np.float32))
        return self.inner.sample(logits)


def staggered(be, prompts, max_tokens: int, after: int, keep: bool = False):
    """Submit prompts[0]; submit prompts[i+1] from request i's token callback once it
    has `after` tokens, so every engine sees the same schedule (prefill chunks with
    decode rows riding them, then batched decode steps). Returns (requests, samplers)
    after all finished; raises the first request error."""
    vocab = be.spec.vocab_size
    reqs, samplers = [None] * len(prompts), [None] * len(prompts)

    def submit(i):
        n = [0]

        def on_token(_tok):
            n[0] += 1
            if n[0] == after and i + 1 < len(prompts):
                submit(i + 1)
        samplers[i] = _CheckedSampler(vocab, keep)
        reqs[i] = be.submit(prompts[i], max_tokens, samplers[i], on_token=on_token)
    submit(0)
    reqs[0].wait(timeout=900)
    for i, r in enumerate(reqs):
        if r is None:
            raise AssertionError(f"request {i} was never submitted")
        r.wait(timeout=900)
    return reqs, samplers


def serving_parity(n_layers: int = 2, max_tokens: int = 6, spec=None) -> str:
    """The fused BatchEngine at full Llama-2-7B width in f32 with seeded weights: the
    card with the kernels against the CPU with their plain versions, on 4 staggered
    requests. Greedy tokens must be identical per request and the logits of every
    step within 2e-3·max|logits| (as the Engine parity: sum order, and an activation
    whose last bits differ can move one bf16 rounding of an operand)."""
    from distributed_llama_tpu_torch.models.params import params_to
    from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine

    spec = spec or _llama2_7b(n_layers=n_layers)
    params = _random_i4p_params(spec, torch.device("cpu"), seed=8, gate_pair=True)
    kw = dict(slots=4, dtype=torch.float32, use_kernels=True, fused_matmul=True)
    rng = np.random.RandomState(4)
    prompts = [[1] + rng.randint(3, spec.vocab_size, n).tolist() for n in (8, 12, 4, 19)]
    results = []
    for dev in ("cuda", "cpu"):
        be = BatchEngine(spec, params_to(params, dev), device=dev, **kw)
        assert be.engine.use_kernels == "fused" and be.engine.paged_kernel
        try:
            results.append(staggered(be, prompts, max_tokens, after=2, keep=True))
        finally:
            be.close()
        del be
    (rg, sg), (rc, sc) = results
    worst, steps = 0.0, 0
    for i in range(len(prompts)):
        if rg[i].out != rc[i].out:
            raise AssertionError(f"serving parity: request {i} greedy tokens differ: "
                                 f"{rg[i].out} vs {rc[i].out}")
        for step, (lg, lc) in enumerate(zip(sg[i].kept, sc[i].kept)):
            err = float(np.abs(lg - lc).max())
            tol = 2e-3 * float(np.abs(lc).max())
            worst = max(worst, err / tol)
            steps += 1
            if err > tol:
                raise AssertionError(f"serving parity: request {i} step {step}: "
                                     f"max|Δlogits| {err:.3e} > {tol:.3e}")
    torch.cuda.empty_cache()
    return (f"BatchEngine fused, 4 staggered requests x {max_tokens} greedy tokens: "
            f"tokens identical {[r.out for r in rg]}; {steps} logits rows, worst "
            f"max|Δlogits|/tol {worst:.3f}")


def phase_parity(state: dict) -> None:
    from distributed_llama_tpu_torch.models.params import params_to
    from distributed_llama_tpu_torch.runtime.engine import Engine

    spec = _llama2_7b(n_layers=2)
    params = _random_i4p_params(spec, torch.device("cpu"), seed=7)
    kw = dict(dtype=torch.float32, use_kernels=True, prefill_kernel=True)
    gpu = Engine(spec, params_to(params, "cuda"), device="cuda", **kw)
    cpu = Engine(spec, params, device="cpu", **kw)
    prompt = [1] + [int(t) for t in np.random.RandomState(3).randint(3, 32000, 8)]
    lg, lc = gpu.prefill(prompt), cpu.prefill(prompt)
    # tolerance 2e-3·max|logits|: kernels and plain versions differ in sum order, and
    # an activation that differs in its last bits can move one Q80 step of a block
    worst = 0.0
    toks_g, toks_c = [], []
    for step in range(9):
        err = float(np.abs(lg - lc).max())
        tol = 2e-3 * float(np.abs(lc).max())
        worst = max(worst, err / tol)
        if err > tol or not np.isfinite(lg).all():
            raise AssertionError(f"parity step {step}: max|Δlogits| {err:.3e} > {tol:.3e}")
        if step == 8:
            break
        tg, tc = int(np.argmax(lg)), int(np.argmax(lc))
        toks_g.append(tg)
        toks_c.append(tc)
        if tg != tc:
            raise AssertionError(f"parity: greedy tokens diverge at step {step}: "
                                 f"{toks_g} vs {toks_c}")
        lg, lc = gpu.infer_chunk([tg]), cpu.infer_chunk([tc])
    log(f"[parity] 2-layer Llama-2-7B width, f32: prefill {len(prompt)} tokens + 8 "
        f"greedy steps, tokens identical {toks_g}; worst max|Δlogits|/tol {worst:.3f}")
    del gpu
    torch.cuda.empty_cache()
    log(f"[parity] 2-layer Llama-2-7B width, f32: {serving_parity()}")


def phase_model(state: dict) -> None:
    from distributed_llama_tpu_torch.ops import decode_attention as da
    from distributed_llama_tpu_torch.ops import q4_matmul as mm
    from distributed_llama_tpu_torch.ops import q4_matvec as mv
    from distributed_llama_tpu_torch.runtime.engine import Engine

    spec = _llama2_7b()
    dev = torch.device("cuda")
    eng = Engine(spec, _random_i4p_params(spec, dev, seed=11), device="cuda",
                 prefill_kernel=True)
    assert eng.dtype == torch.bfloat16 and eng.use_kernels == "all"
    prompt = [1] + torch.randint(3, spec.vocab_size, (99,),
                                 generator=torch.Generator().manual_seed(5)).tolist()
    eng.generate(prompt[:9], 2, _CheckedSampler(spec.vocab_size))  # warm-up
    eng.reset()
    torch.cuda.synchronize()
    mods = {"q4_matvec": mv, "q4_matmul": mm, "decode_attention": da}
    for mod in mods.values():
        mod.launches = 0
    sampler = _CheckedSampler(spec.vocab_size)
    out, stats = eng.generate(prompt, 64, sampler)
    launches = {name: mod.launches for name, mod in mods.items()}
    state["launches"].update(launches)
    # T=1 steps: the 4 one-token prefill chunks + 64 decode steps; M>1 chunks: 64, 8 x4
    t1_steps, mm_chunks = 4 + 64, 5
    per_step = 4 * spec.n_layers + 1
    want = {"q4_matvec": t1_steps * per_step, "q4_matmul": mm_chunks * per_step,
            "decode_attention": t1_steps * spec.n_layers}
    if launches != want or len(out) != 64 or sampler.rows != 64:
        raise AssertionError(f"model run: launches {launches} (want {want}), "
                             f"{len(out)} tokens, {sampler.rows} logits rows")
    log(f"[model] Llama-2-7B Q40 bf16 (32 layers, random weights): prefill "
        f"{stats.prompt_tokens} tokens {stats.prefill_ms:.1f} ms, decode "
        f"{stats.avg_infer_ms:.2f} ms/token (step), {stats.tokens_per_second:.2f} tok/s; "
        f"weights {eng.decode_weight_bytes / 1e9:.3f} GB/token -> "
        f"{eng.decode_weight_bytes / (stats.avg_infer_ms * 1e-3) / 1e9:.0f} GB/s; "
        f"floor {eng.decode_weight_bytes / state['rate'] * 1e3:.3f} ms/token at the "
        f"data-sheet rate")
    log(f"[model] launches in the run: {json.dumps(launches)}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    _profile_decode(eng, out[-1], stats.avg_infer_ms)
    del eng
    torch.cuda.empty_cache()


def _profile_decode(eng, token: int, counted_ms: float, steps: int = 8) -> None:
    """Where one decode step's time goes: device time by kernel name from torch.profiler
    over `steps` steps (after the counted run). The idle share is taken against step
    times measured without the profiler, whose hooks inflate the host clock: the same
    `steps` steps timed just before, and the counted run's mean step (`counted_ms`)."""
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
    busy = sum(r[0] for r in rows)
    log(f"[model] decode step: device busy {busy:.3f} ms (profiled); step wall without "
        f"the profiler {plain_ms:.2f} ms ({steps} steps) and {counted_ms:.2f} ms (counted "
        f"run), with it {profiled_ms:.2f} ms; idle share {1 - busy / plain_ms:.3f} "
        f"({steps} steps), {1 - busy / counted_ms:.3f} (counted run)")
    for ms, n, key in rows[:8]:
        log(f"[model]   {ms:.4f} ms/step in {n} launches/step: {key}")


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


def _serve_engine():
    from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine

    spec = _llama2_7b()
    be = BatchEngine(spec, _random_i4p_params(spec, torch.device("cuda"), seed=13,
                                              gate_pair=True),
                     slots=8, device="cuda", fused_matmul=True, kv_block_tokens=16)
    eng = be.engine
    assert eng.dtype == torch.bfloat16 and eng.use_kernels == "fused" and eng.paged_kernel
    assert be.kv_pool.n_blocks == 8 * (spec.seq_len // 16) + 8 + 1
    # warm-up: loads the kernel libraries and warms the allocator
    be.generate([1] + list(range(5, 80)), 2, _CheckedSampler(spec.vocab_size))
    be.release_idle()
    return be


def phase_serve(state: dict) -> None:
    torch.cuda.reset_peak_memory_stats()
    be = _serve_engine()
    spec = be.spec
    counters = _serve_counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    be.dispatches = be.decode_steps = be.mixed_steps = 0
    be.dispatch_ms = {k: [] for k in be.dispatch_ms}
    gen = torch.Generator().manual_seed(21)
    prompts = [[1] + torch.randint(3, spec.vocab_size, (n - 1,), generator=gen).tolist()
               for n in SERVE_PROMPTS]
    t0 = time.perf_counter()
    reqs, samplers = staggered(be, prompts, SERVE_TOKENS, after=4)
    wall = time.perf_counter() - t0
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    want = {name: n * be.dispatches for name, n in SERVE_PER_DISPATCH.items()}
    outs = [len(r.out) for r in reqs]
    if launches != want or outs != [SERVE_TOKENS] * len(prompts):
        raise AssertionError(f"serve run: launches {launches} (want {want} for "
                             f"{be.dispatches} dispatches), tokens {outs}")
    if sum(s.rows for s in samplers) != sum(outs):
        raise AssertionError("serve run: a delivered token without its logits row")
    free = be.release_idle()
    if free != be.kv_pool.n_blocks - 1:
        raise AssertionError(f"serve run: {free} blocks free after the run, want "
                             f"{be.kv_pool.n_blocks - 1} (all but scratch)")
    state["launches"].update({k: v for k, v in launches.items() if k != "q4_matmul"})
    ttft = [(r.first_token_t - r.submit_t) * 1e3 for r in reqs]
    dec = be.dispatch_ms["decode"]
    log(f"[serve] Llama-2-7B Q40 bf16 fused, 8 slots, paged KV "
        f"{be.kv_pool.n_blocks} x 16 tokens: {len(prompts)} staggered requests, prompts "
        f"{list(SERVE_PROMPTS)}, {SERVE_TOKENS} greedy tokens each, in {wall:.2f} s: "
        f"{sum(outs) / wall:.1f} tok/s aggregate; {be.dispatches} dispatches "
        f"({be.decode_steps} decode, {be.mixed_steps} mixed, "
        f"{len(be.dispatch_ms['prefill'])} prefill-only)")
    log(f"[serve] batched decode dispatch (host sampling excluded) {np.mean(dec):.2f} ms "
        f"mean, {np.median(dec):.2f} ms median over {len(dec)} steps; mixed dispatch "
        f"{np.mean(be.dispatch_ms['mixed']):.2f} ms mean; time to first token mean {np.mean(ttft):.1f} ms, max "
        f"{np.max(ttft):.1f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; pool drained to "
        f"{free} free blocks")
    log(f"[serve] launches in the run: {json.dumps(launches)} = per dispatch "
        f"{json.dumps(SERVE_PER_DISPATCH)} x {be.dispatches}")
    _profile_serve_decode(be, np.mean(dec))
    if "http" in state["phases"]:
        state["serve_engine"] = be
    else:
        be.close()
        torch.cuda.empty_cache()


def _profile_serve_decode(be, counted_ms: float, steps: int = 8) -> None:
    """Where one batched decode step's time goes: 8 requests decode together; of the
    decode steps with all 8 rows active, `steps` are timed without the profiler and
    the next `steps` under it. The scheduler thread pauses at both edges of the
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
        prompts = [[1] + list(range(100 + 10 * i, 107 + 10 * i)) for i in range(8)]
        reqs = [be.submit(p, 8 + 3 * steps, _CheckedSampler(be.spec.vocab_size))
                for p in prompts]
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
    log(f"[serve] batched decode step (8 rows): device busy {busy:.3f} ms (profiled); "
        f"without the profiler, step period {period:.2f} ms and dispatch {dispatch:.2f} "
        f"ms ({steps} steps), dispatch {counted_ms:.2f} ms (counted run); dispatch with "
        f"the profiler {profiled:.2f} ms; idle share {1 - busy / period:.3f} of the period"
        f", {1 - busy / dispatch:.3f} of the dispatch ({steps} steps), "
        f"{1 - busy / counted_ms:.3f} of the dispatch (counted run)")
    for ms, n, key in rows[:10]:
        log(f"[serve]   {ms:.4f} ms/step in {n} launches/step: {key}")


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

    be = state.pop("serve_engine", None) or _serve_engine()
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
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, timeout=300)
    # random weights emit arbitrary byte pieces: decode leniently
    out = res.stdout.decode("utf-8", "replace")
    if res.returncode != 0:
        raise AssertionError(f"CLI exited {res.returncode}:\n{out}\n"
                             f"{res.stderr.decode('utf-8', 'replace')}")
    loaded = [ln for ln in out.splitlines() if ln.startswith("⏩")]
    log(f"[cli] dllama generate exited 0: {loaded[0] if loaded else out[-200:]!r}")


def kernels_line(state: dict) -> str:
    rows = []
    for name, (source, replaces, _phase) in KERNELS.items():
        rec = state["kernel_rows"][name]
        by = rec["bound_by"]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"distributed_llama_tpu_torch/csrc/{source}.cu",
            "replaces": replaces,
            "launches": state["launches"][name],
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
    # launches come from the model and serve phases' runs
    if {"kernels", "model", "serve"} <= set(phases):
        log(kernels_line(state))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
