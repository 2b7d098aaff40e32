"""Chip smoke test of the PyTorch/CUDA port (distributed_llama_tpu_torch) on one GPU.

    python3 chip_smoke.py                      # every phase, as the check runs it
    python3 chip_smoke.py --phases env,build,kernels

Phases, each printing its own line(s); any failure raises and exits nonzero:
  env       torch/CUDA versions, the card's name and power limit (nvidia-smi)
  build     nvcc for every kernel source, all started together; build seconds
  kernels   each kernel against its plain torch version on the card at the main path's
            shapes: max|err| against its tolerance, time per launch after warm-up,
            the plain version's time, the bound, and a PyTorch yardstick where one exists
  parity    a 2-layer model at full Llama-2-7B width in f32 with seeded weights: the
            card with kernels against the CPU with the plain versions (logits within
            tolerance, identical greedy tokens for 8 steps)
  model     Engine at full Llama-2-7B (32 layers, random Q40 weights drawn on the card in
            i4p layout, bf16, prefill_kernel): a 100-token prompt (chunks 64, 8, 1) and
            64 greedy tokens, with every kernel's launch count over that run
  cli       `python -m distributed_llama_tpu_torch.apps.dllama generate` on a tiny
            .m/.t pair written by the port's writers

When both the model and the kernels phases ran, it prints before the last line
{"kernels": [...]} (per kernel: route, source, the TPU kernel it replaces, launches in
the model phase, max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms); a subset
without either phase prints no kernels line. The last line is {"ok": true, "device":
{...}}. Exits nonzero without printing a result when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# the model phase runs before the profiler-timed kernel phase, so its host-side step
# times are not taken with profiler hooks installed
ALL_PHASES = ("env", "build", "parity", "model", "kernels", "cli")
KERNELS = ("q4_matvec", "q4_matmul", "decode_attention")
REPLACES = {
    "q4_matvec": "distributed_llama_tpu/ops/pallas_q4.py:142",
    "q4_matmul": "distributed_llama_tpu/ops/pallas_q4_mm.py:200",
    "decode_attention": "distributed_llama_tpu/ops/pallas_attention.py:191",
}
# decode projections of Llama-2-7B as (N, K): wqkv, wo, w13, w2, wcls
SHAPES_7B = ((12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008), (32000, 4096))
# data-sheet memory rate (bytes/s) by card name; dense peaks from the H100 SXM data sheet
MEM_RATE = (("H200", 4.8e12), ("NVL", 3.9e12), ("PCIe", 2.0e12), ("H100", 3.35e12))
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
L2_BYTES = 50 << 20


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
    cuda_build.build(list(KERNELS))
    log(f"[build] {len(KERNELS)} kernels in {time.perf_counter() - t0:.1f} s "
        f"({cuda_build.nvcc_path()})")
    for name in KERNELS:
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
    for m in (8, 64):
        for n, k in SHAPES_7B:
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
            _record(state, "q4_matmul", err, tol, ms, plain, bnd, None,
                    f"M={m},N={n},K={k}")

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


def _random_i4p_params(spec, dev, seed: int):
    """Llama params with random Q40 weights drawn on `dev` directly in the fused i4p
    layout (wqkv, wo, w13, w2, wcls) from a seeded torch.Generator."""
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

    blocks = {"wqkv": q40(L, d + 2 * spec.kv_dim, d), "wo": q40(L, d, d),
              "w13": q40(L, 2 * h, d), "w2": q40(L, d, h),
              "rms_att": norm(L, d), "rms_ffn": norm(L, d)}
    return {"embedding": 0.02 * torch.randn(spec.vocab_size, d, generator=gen, device=dev),
            "blocks": blocks, "rms_final": norm(d), "wcls": q40(spec.vocab_size, d)}


def _llama2_7b(n_layers: int = 32):
    from distributed_llama_tpu_torch.models.spec import ArchType, ModelSpec

    return ModelSpec(arch_type=ArchType.LLAMA, dim=4096, hidden_dim=11008,
                     n_layers=n_layers, n_heads=32, n_kv_heads=32, vocab_size=32000,
                     seq_len=2048).resolved()


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


class _CheckedSampler:
    """Greedy sampling that asserts every logits row it sees is finite."""

    def __init__(self, vocab_size: int):
        from distributed_llama_tpu_torch.runtime.sampler import Sampler

        self.inner = Sampler(vocab_size, temperature=0.0)
        self.rows = 0

    def sample(self, logits: np.ndarray) -> int:
        if not np.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        self.rows += 1
        return self.inner.sample(logits)


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
    state["launches"] = launches
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
    for name in KERNELS:
        rec = state["kernel_rows"][name]
        by = rec["bound_by"]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"distributed_llama_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
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
    state: dict = {"kernel_rows": {}}
    t0 = time.perf_counter()
    for name in ALL_PHASES:
        if name in phases or name == "env":
            t = time.perf_counter()
            globals()[f"phase_{name}"](state)
            log(f"[{name}] done in {time.perf_counter() - t:.1f} s")
    log(f"[total] {time.perf_counter() - t0:.1f} s")
    if "kernels" in phases and "model" in phases:  # launches come from the model phase
        log(kernels_line(state))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
