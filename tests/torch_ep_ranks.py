"""Rank-side work of the port's expert-parallel tests (tests/test_torch_moe_ep.py), run on
every rank of a world that distributed_llama_tpu_torch.parallel.launch starts. Imports
torch and the port only: a rank never imports jax or the JAX package. Inputs come in a
file the test wrote with torch.save (numpy arrays and plain dicts); each function returns
what the test compares with the JAX package. Every case shards the MoE stacks by whole
experts (moe_sharding="expert"); a case's (sp, tp) grid is built over the launcher's
world, so one world serves every grid of its size."""

from __future__ import annotations

import torch

from distributed_llama_tpu_torch.models.params import params_from_numpy, prepare_for_cuda
from distributed_llama_tpu_torch.models.spec import ModelSpec
from distributed_llama_tpu_torch.ops.rope import RopeTables
from distributed_llama_tpu_torch.parallel.mesh import make_mesh
from distributed_llama_tpu_torch.parallel.tp import (init_sharded_kv_cache,
                                                     make_sharded_forward, shard_params)
from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.sampler import Sampler

EP = "expert"


def _load(path):
    return torch.load(path, weights_only=False)


def forward_cases(mesh, path):
    """Each case: the JAX package's params as numpy leaves, the spec's fields, the
    kernel regime and the steps [(tokens (B, T), start: int or per-row list)], run in
    turn through this rank's expert-sharded forward from zeroed caches of `batch` rows.
    Returns every step's logits (rank 0), and this rank's local expert count and the
    layout of its MoE stacks."""
    out = []
    for case in _load(path):
        spec = ModelSpec(**case["spec"]).resolved()
        params = params_from_numpy(case["params"])
        if case["use_kernels"]:
            params = prepare_for_cuda(params, tp=mesh.tp, spec=spec, moe_sharding=EP)
        shard = shard_params(params, mesh, spec, moe_sharding=EP)
        kc, vc = init_sharded_kv_cache(spec, mesh, batch=case["batch"])
        step = make_sharded_forward(spec, mesh, use_kernels=case["use_kernels"],
                                    moe_sharding=EP)
        rope = RopeTables.create(spec)
        logits = []
        for toks, start in case["steps"]:
            pos = start if isinstance(start, int) else torch.tensor(start)
            lg, kc, vc = step(shard, rope, torch.tensor(toks, dtype=torch.int64), kc, vc,
                              pos)
            logits.append(lg.numpy() if mesh.rank == 0 else None)
        stacks = {k: (tuple(t.shape), t.layout, t.groups, t.row_groups)
                  for k, t in shard["blocks"].items() if k.startswith("moe_")}
        out.append({"logits": logits, "stacks": stacks})
    return out


def engine_cases(mesh, path):
    """Each case: params (numpy leaves), the spec's fields, the (sp, tp) grid and the
    runs [(how, prompt, n, k)]: Engine(mesh=, moe_sharding="expert") greedy through
    generate, generate_chunked (the device loop, chunk k) or generate_speculative
    (n-gram drafts of k). Returns each run's tokens and the decode step's counted
    traffic."""
    out = []
    for case in _load(path):
        spec = ModelSpec(**case["spec"]).resolved()
        sp, tp = case["grid"]
        grid = mesh if (mesh.sp, mesh.tp) == (sp, tp) else make_mesh(tp=tp, sp=sp,
                                                                      device=mesh.device)
        eng = Engine(spec, params_from_numpy(case["params"]), mesh=grid,
                     compress_collectives=case["compress"], moe_sharding=EP,
                     use_kernels=case["use_kernels"])
        traffic = eng.collective_stats()
        tokens = []
        for how, prompt, n, k in case["runs"]:
            eng.reset()
            smp = Sampler(spec.vocab_size, 0.0)
            if how == "generate":
                got, _ = eng.generate(list(prompt), n, smp)
            elif how == "chunked":
                got, _ = eng.generate_chunked(list(prompt), n, smp, chunk=k)
            else:
                got, st = eng.generate_speculative(list(prompt), n, smp, k=k)
                assert st.spec_steps > 0
            tokens.append(got)
        out.append({"tokens": tokens, "moe_sharding": eng.moe_sharding,
                    "sent": traffic.sent_bytes_per_device, "counts": dict(traffic.counts),
                    "experts": eng.params["blocks"]["moe_gu" if "moe_gu" in eng.params[
                        "blocks"] else "moe_up"].shape[1]})
    return out


def batch_case(mesh, path):
    """BatchEngine(tp=, moe_sharding="expert") on the case's params: rank 0 submits the
    prompts together, greedy, waits and closes; the other ranks follow. Returns the
    outputs (rank 0), the rank's device-sampled token blocks, and on rank 0 the
    dispatch counters."""
    case = _load(path)
    spec = ModelSpec(**case["spec"]).resolved()
    be = BatchEngine(spec, params_from_numpy(case["params"]), mesh=mesh, moe_sharding=EP,
                     **case["kw"])
    be.token_log = []
    row = {}
    if mesh.rank == 0:
        try:
            reqs = [be.submit(list(p), n, Sampler(spec.vocab_size, 0.0))
                    for p, n in case["prompts"]]
            row["outs"] = [r.wait(timeout=300) for r in reqs]
            row["counts"] = {"super_steps": be.super_steps, "verify_steps": be.verify_steps}
            row["moe_sharding"] = be._eng.moe_sharding
        finally:
            be.close()
    else:
        row["replayed"] = be.follow()
    row["blocks"] = be.token_blocks()
    return row
