"""Rank-side work of the port's sequence-parallel tests (tests/test_torch_ring.py), run on
every rank of a world that distributed_llama_tpu_torch.parallel.launch starts. Imports
torch and the port only: a rank never imports jax or the JAX package. Inputs come in a
file the test wrote with torch.save (numpy arrays and plain dicts); each function returns
what the test compares with the JAX package. A case's (sp, tp) grid is built over the
launcher's world (parallel.mesh.make_mesh), so one world serves every grid of its size.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_llama_tpu_torch.models.params import params_from_numpy
from distributed_llama_tpu_torch.models.spec import ArchType, ModelSpec
from distributed_llama_tpu_torch.ops.ring_attention import ring_attention
from distributed_llama_tpu_torch.ops.rope import RopeTables
from distributed_llama_tpu_torch.parallel.mesh import make_mesh
from distributed_llama_tpu_torch.parallel.tp import (init_sharded_kv_cache,
                                                     make_sharded_forward, shard_params)
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.sampler import Sampler


def _load(path):
    return torch.load(path, weights_only=False)


def _grid(mesh, sp: int, tp: int):
    """The (sp, tp) mesh of a case over the launcher's world (`mesh` itself where it
    is that grid already)."""
    if (mesh.sp, mesh.tp) == (sp, tp):
        return mesh
    return make_mesh(tp=tp, sp=sp, device=mesh.device)


def ring_cases(mesh, path):
    """Each case: the full cache (B, hk, S, hs) of K and V, q, the query positions and
    the layout; this rank attends its shard (contiguous block or stripe), on its
    device, with ring_attention. Returns every case's output (on the host) and its
    counted shift bytes."""
    out = []
    for case in _load(path):
        sp = case["sp"]
        grid = _grid(mesh, sp, mesh.size // sp)
        idx = grid.sp_rank
        dev = mesh.device
        kc, vc = (torch.from_numpy(case[k]).to(dev) for k in ("k", "v"))
        if case["striped"]:
            ks, vs = kc[:, :, idx::sp], vc[:, :, idx::sp]
        else:
            sb = kc.shape[2] // sp
            ks, vs = kc[:, :, idx * sb:(idx + 1) * sb], vc[:, :, idx * sb:(idx + 1) * sb]
        chunk = None
        if case.get("chunk") is not None:
            kn, vn, start = case["chunk"]
            chunk = (torch.from_numpy(kn).to(dev), torch.from_numpy(vn).to(dev), start)
        with grid.counter.window() as traffic:
            y = ring_attention(torch.from_numpy(case["q"]).to(dev), ks, vs,
                               torch.from_numpy(case["positions"]).to(dev), mesh=grid,
                               live_end=case.get("live_end"), chunk=chunk,
                               striped=case["striped"],
                               window_slots=case.get("window_slots"))
        out.append({"out": y.cpu().numpy(), "permute": traffic.payload_bytes.get(
            "collective-permute", 0), "count": traffic.counts.get("collective-permute", 0)})
    return out


def forward_cases(mesh, path):
    """Each case: the JAX package's params as numpy leaves, the spec's fields, the grid,
    the window and the chunks (tokens, start position); this rank's sharded forward runs
    them in turn. Returns every chunk's logits and this rank's caches after the last."""
    out = []
    for case in _load(path):
        spec = ModelSpec(**case["spec"]).resolved()
        grid = _grid(mesh, case["sp"], case["tp"])
        params = params_from_numpy(case["params"])
        shard = shard_params(params, grid, spec)
        kc, vc = init_sharded_kv_cache(spec, grid)
        step = make_sharded_forward(spec, grid, attn_window=case.get("window"))
        rope = RopeTables.create(spec)
        logits = []
        for toks, start in case["chunks"]:
            lg, kc, vc = step(shard, rope, torch.tensor([toks], dtype=torch.int64), kc, vc,
                              start)
            logits.append(lg[0].numpy())
        out.append({"logits": logits, "k": kc.numpy(), "v": vc.numpy(),
                    "s": grid.sp_rank, "t": grid.tp_rank})
    return out


def engine_cases(mesh, model_path, tokenizer_path, runs):
    """Engine(tp=, sp=) of the launcher's grid on a .m/.t pair: each run is (how, prompt,
    n, temperature, seed, chunk), how one of generate, chunked (the device loop) or
    speculative; a fresh position each. Returns the tokens of every run, the decode
    step's counted traffic (collective_stats at position 0, before the runs), and the
    largest difference between this rank's first logits and rank 0's (each sp rank
    combines the ring in its own order)."""
    import torch.distributed as dist

    eng = Engine.load(model_path, tokenizer_path, tp=mesh.tp, sp=mesh.sp,
                      device=mesh.device)
    traffic = eng.collective_stats()
    first = torch.from_numpy(eng.prefill(runs[0][1])).float()
    ref = first.clone()
    dist.broadcast(ref, 0)
    eng.reset()
    tokens = []
    for how, prompt, n, temperature, seed, chunk in runs:
        eng.reset()
        smp = Sampler(eng.spec.vocab_size, temperature, 0.9, seed=seed)
        if how == "generate":
            got, _ = eng.generate(prompt, n, smp)
        elif how == "chunked":
            got, _ = eng.generate_chunked(prompt, n, smp, chunk=chunk)
        else:
            got, st = eng.generate_speculative(prompt, n, smp, k=chunk)
            assert st.spec_steps > 0
        tokens.append(got)
    return {"tokens": tokens, "payload": dict(traffic.payload_bytes),
            "counts": dict(traffic.counts), "sent": traffic.sent_bytes_per_device,
            "first_diff": float((first - ref).abs().max()),
            "first_finite": bool(np.isfinite(first.numpy()).all())}


def refusals(mesh):
    """What an sp engine and step refuse, on a live sp mesh: the messages."""
    from distributed_llama_tpu_torch.models.forward import forward

    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=1,
                     n_heads=4, n_kv_heads=2, vocab_size=64, seq_len=32).resolved()
    said = []
    for fn in (lambda: init_sharded_kv_cache(spec, mesh, kv_pool=(4, 8)),
               lambda: forward({}, spec, None, torch.zeros((2, 1), dtype=torch.int64),
                               None, None, torch.zeros(2, dtype=torch.int64),
                               sp_mesh=mesh)):
        try:
            fn()
        except ValueError as e:
            said.append(str(e))
    return said
