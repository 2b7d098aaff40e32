"""Drafter device steps: the chunked catch-up prefill and the catch-up + greedy-draft
scan (the port's counterpart of the JAX package's draft/loop.py).

The drafter is a second, small model with its own dense KV caches on the card, so its
steps are the target's idioms at the drafter's own ModelSpec:

- make_draft_step: the plain (B, T) forward for chunked catch-up prefill, when a row's
  pending history exceeds what a scan should carry (a fresh attach with a long prompt).
  It runs eagerly, as every prefill chunk of the port does.

- make_draft_loop: one proposal turn. Each row first force-ingests its catch-up tokens
  (target-delivered tokens the drafter has not seen yet — typically the correction or
  bonus token of the previous verify turn), then free-runs greedy argmax on f32 logits,
  each draft fed back as the next input. Both phases share one step: step j of row r
  takes catchup[r, j] while j < ncatch[r], its own previous argmax afterwards, and parks
  (position clamped inside the cache, its write on a masked slot) past budget[r] =
  ncatch[r] + k[r] - 1. The host slices row r's drafts from the returned (S, B) argmax
  block at [ncatch[r] - 1, ncatch[r] - 1 + k[r]). The step is a function of static
  device buffers, so on the card with `graphs` enabled it is captured once per (scan
  length, window bucket, rows) and replayed S times; scan lengths are bucketed
  (runtime/speculative.py verify_block_bucket), so the graphs stay O(log k).

Drafting is greedy-only by design: drafts are proposals — the target's verify samples
with the request's real temperature and top-p, and the acceptance identity holds for any
proposal — so the drafter never needs the xorshift* machinery. The fault point
`draft.dispatch` fires on the host before a scan touches the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.forward import forward
from ..models.spec import ModelSpec
from ..resilience import faults
from ..runtime.speculative import DrafterError
from ..runtime.step_graph import StepGraphs, upload


def make_draft_step(spec: ModelSpec, params, *, dtype=torch.float32, use_kernels=False):
    """Chunked drafter forward: fn(rope, tokens (B, T), kc, vc, start_pos (B,),
    window) -> (logits, kc, vc), the rows committed in place."""

    def run(rope, tokens, kc, vc, start_pos, window=None):
        dev = kc.device
        toks = torch.as_tensor(np.asarray(tokens, np.int64)).to(dev)
        start = torch.as_tensor(np.asarray(start_pos, np.int64)).to(dev)
        return forward(params, spec, rope, toks, kc, vc, start, dtype=dtype,
                       use_kernels=use_kernels, attn_window=window)

    return run


def make_draft_loop(spec: ModelSpec, params, steps: int, *, dtype=torch.float32,
                    use_kernels=False, window: int | None = None,
                    graphs: StepGraphs | None = None):
    """Build the drafter's catch-up + draft scan.

    fn(rope, catchup (B, S), kc, vc, start_pos (B,), ncatch (B,), budget (B,)) ->
    (toks (S, B), pos (B,)), both static device buffers valid until the next call.

    Per row r: steps j < ncatch[r] force-ingest catchup[r, j] at position start_pos[r] +
    j; steps ncatch[r] <= j < budget[r] ingest the previous argmax. toks[j, r] is the
    argmax after step j's ingestion, so row r's k drafts are toks[ncatch[r] - 1 :
    ncatch[r] - 1 + k, r]. Rows with budget 0 park: their writes land clamped inside the
    cache on masked slots, which the row's next real catch-up overwrites. The KV of live
    rows advances budget[r] positions. `window` bounds the positions attention reads (it
    must cover every row's start_pos + S); a captured step runs on the caches it was
    first called with."""
    assert steps >= 1
    seq_len = spec.seq_len
    st: dict = {}

    def step():
        j = st["step"]
        tok, pos, ncatch, budget = st["ints"]  # views: rows of one buffer
        live = j < budget  # (B,)
        forced = st["catchup"].index_select(1, j.clamp(max=steps - 1))[:, 0]
        inp = torch.where(j < ncatch, forced, tok)
        step_pos = torch.where(live, pos, pos.clamp(max=seq_len - 1))
        logits, _, _ = forward(params, spec, st["rope"], inp[:, None], st["kc"], st["vc"],
                               step_pos, dtype=dtype, use_kernels=use_kernels,
                               attn_window=window)
        nxt = logits[:, -1].float().argmax(-1)
        st["toks"].index_copy_(0, j, nxt[None])
        tok.copy_(torch.where(live, nxt, tok))
        pos.copy_(torch.where(live, pos + 1, pos))
        j.add_(1)

    def run(rope, catchup, kc, vc, start_pos, ncatch, budget):
        faults.fire("draft.dispatch", steps=steps)
        cu = np.asarray(catchup, np.int64)
        b = cu.shape[0]
        if not st:
            dev = kc.device
            st.update(rope=rope, kc=kc, vc=vc,
                      catchup=torch.zeros(b, steps, dtype=torch.int64, device=dev),
                      ints=torch.zeros(4, b, dtype=torch.int64, device=dev),
                      step=torch.zeros(1, dtype=torch.int64, device=dev),
                      toks=torch.zeros(steps, b, dtype=torch.int64, device=dev))
        elif kc is not st["kc"] or vc is not st["vc"]:
            raise DrafterError("a draft loop runs on the caches it was built on")
        upload(st["catchup"], cu)
        upload(st["ints"], np.stack([cu[:, 0], np.asarray(start_pos, np.int64),
                                     np.asarray(ncatch, np.int64),
                                     np.asarray(budget, np.int64)]))
        st["step"].zero_()
        carry = (st["ints"], st["step"])
        for _ in range(steps):
            if graphs is None:
                step()
            else:
                graphs.run(("draft_scan", steps, window, b), step, carry)
        return st["toks"], st["ints"][1]

    return run
