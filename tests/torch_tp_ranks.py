"""Rank-side work of the port's tensor-parallel tests (tests/test_torch_tp.py and
tests/test_torch_collectives.py), run on every rank of a world that
distributed_llama_tpu_torch.parallel.launch starts. Imports torch and the port only: a
rank never imports jax or the JAX package. Inputs come in a file the test wrote with
torch.save (numpy arrays and plain dicts); each function returns what the test compares
with the JAX package."""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from distributed_llama_tpu_torch.models.params import params_from_numpy, prepare_for_cuda
from distributed_llama_tpu_torch.models.spec import ModelSpec
from distributed_llama_tpu_torch.ops.rope import RopeTables
from distributed_llama_tpu_torch.parallel import collectives
from distributed_llama_tpu_torch.parallel.tp import (init_sharded_kv_cache,
                                                     make_sharded_forward, shard_params)
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.sampler import Sampler


def _load(path):
    return torch.load(path, weights_only=False)


def collective_cases(mesh, path):
    """Every case's partials (tp, *shape) f32: this rank's row, on the mesh's device,
    through psum, quantized_psum and quantized_psum_gather (results on the host), each
    call's counted traffic beside it."""
    out = []
    for case in _load(path):
        x = torch.from_numpy(case["partials"][mesh.rank]).to(mesh.device)
        row = {}
        for name, fn in (("psum", lambda t: collectives.psum(t, mesh)),
                         ("quantized_psum", lambda t: collectives.psum(t, mesh, True)),
                         ("quantized_psum_gather",
                          lambda t: collectives.quantized_psum_gather(t, mesh))):
            with mesh.counter.window() as traffic:
                row[name] = fn(x).cpu().numpy()
            row[name + "_traffic"] = (traffic.sent_bytes_per_device,
                                      traffic.total_payload_bytes, dict(traffic.counts))
        out.append(row)
    return out


def forward_cases(mesh, path):
    """Each case: the JAX package's params as numpy leaves, the spec's fields, the
    kernel regime and the wire; the chunks run in turn from position 0 through this
    rank's sharded forward. Rank 0 returns every chunk's logits; every rank returns its
    shard's cache head count."""
    out = []
    for case in _load(path):
        spec = ModelSpec(**case["spec"]).resolved()
        params = params_from_numpy(case["params"])
        if case["use_kernels"]:
            params = prepare_for_cuda(params, tp=mesh.tp, spec=spec)
        shard = shard_params(params, mesh, spec)
        kc, vc = init_sharded_kv_cache(spec, mesh)
        step = make_sharded_forward(spec, mesh, use_kernels=case["use_kernels"],
                                    compress_collectives=case["compress"])
        rope = RopeTables.create(spec)
        pos, logits = 0, []
        for chunk in case["chunks"]:
            toks = torch.tensor([chunk], dtype=torch.int64)
            lg, kc, vc = step(shard, rope, toks, kc, vc, pos)
            logits.append(lg[0].numpy() if mesh.rank == 0 else None)
            pos += len(chunk)
        out.append({"logits": logits, "kv_heads": kc.shape[2]})
    return out


def engine_cases(mesh, model_path, tokenizer_path, prompt, cases):
    """Engine(tp=) on a .m/.t pair for each (compress, temperature, seed), its mesh built
    over the launcher's world (dllama's ranks pass theirs as mesh=): the decode step's
    counted traffic (collective_stats, before generating) and 8 generated tokens."""
    out = []
    for compress, temperature, seed in cases:
        eng = Engine.load(model_path, tokenizer_path, tp=mesh.tp, device=mesh.device,
                          compress_collectives=compress)
        traffic = eng.collective_stats()
        tokens, stats = eng.generate(prompt, 8, Sampler(eng.spec.vocab_size, temperature,
                                                        0.9, seed=seed))
        out.append({"tokens": tokens, "sent": traffic.sent_bytes_per_device,
                    "counts": dict(traffic.counts), "source": stats.traffic_source,
                    "kb": stats.sent_kbytes_per_token})
    return out


def fail_on_rank_one(mesh):
    """Rank 1 raises while rank 0 waits for it in an all-reduce."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    t = torch.ones(4)
    dist.all_reduce(t, group=mesh.group)
    return float(t[0])


def sleep_forever(mesh):
    time.sleep(3600)


def ranks_and_devices(mesh):
    return mesh.rank, mesh.tp, str(mesh.device), mesh.backend
