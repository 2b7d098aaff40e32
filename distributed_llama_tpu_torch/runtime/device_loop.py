"""On-device multi-token decode loops: forward + sampling, K steps per dispatch.

The counterpart of the JAX package's runtime/device_loop.py. There a `lax.scan` of
forward + sample is one compiled program; here one decode step — forward, sampling on
the device, the sample fed back as the next input — is a function of static device
buffers that a CUDA graph captures once (runtime/step_graph.py) and the loop replays K
times back to back. The host gets a chunk of tokens per dispatch instead of one, and
reads them after one fence.

Two loops and one verify step: make_decode_loop (one sequence, the `--device-loop` CLI
path and Engine.generate_chunked), make_batched_decode_loop (per-row positions, budgets
and sampler state: the BatchEngine's K-step super-step) and make_batched_verify_loop
(one (B, T) forward over each row's speculative draft block, acceptance on the device:
the BatchEngine's verify dispatch). The two batched builds take `masked=True` for
grammar-constrained decoding (constrain/): each row's automaton state rides the carry,
the row's packed bitmask is gathered from the device constraint table and disallowed
logits are lowered to MASK_NEG before the sampler (_apply_token_mask); the unmasked
builds are unchanged. The batched loop and the verify step sample with
the host Sampler's own xorshift* generator, bit-exact with runtime/sampler._random_u32,
so a request's sample stream stays one sequence across host- and device-sampled
tokens. The
single-sequence loop draws its coins from JAX's counter-based PRNG (threefry2x32,
`jax.random.PRNGKey` / `split` / `fold_in` / `uniform`), ported bit for bit so a seeded
stochastic loop gives the JAX engine's tokens.

Sampling follows the reference Sampler (temperature softmax, top-p nucleus with the
(1 - topp)/(n - 1) pre-filter cutoff, src/tokenizer.cpp:307-415) in the JAX loop's
formulation: each row computes the greedy and both stochastic picks and `torch.where`
selects, as `lax.cond` does. Unsigned 32-bit arithmetic runs in int64 with masks: torch
has no complete uint32 arithmetic on CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.forward import forward
from ..models.spec import ModelSpec
from ..parallel.collectives import broadcast_tensor
from ..resilience import faults
from .step_graph import StepGraphs, upload

M32 = 0xFFFFFFFF

# disallowed-logit fill for grammar masking (constrain/): finite so the softmax shift
# never meets inf - inf, large enough that exp underflows to 0 exactly. The host mask
# path (batch_engine._advance_row) uses the same constant, in f32, so host and device
# masked picks agree
MASK_NEG = -1e30


def _apply_token_mask(rows: torch.Tensor, mrow: torch.Tensor) -> torch.Tensor:
    """Lower disallowed logits: `mrow` is the packed allowed bitmask gathered per row
    (..., W) int32 from the constraint table; bit v & 31 of word v >> 5 covers token v
    (an arithmetic shift and `& 1` read the bit whatever the word's sign). Universal
    rows (all ones) make this the identity, so unconstrained co-batched rows are
    bit-identical to the unmasked step."""
    vi = torch.arange(rows.shape[-1], device=rows.device)
    words = torch.index_select(mrow, -1, vi >> 5)  # (..., V)
    allowed = ((words >> (vi & 31).to(words.dtype)) & 1).bool()
    return rows.masked_fill(~allowed, MASK_NEG)


# ------------------------------------------------------------------
# sampling
# ------------------------------------------------------------------


def device_sample_coin(logits: torch.Tensor, u: torch.Tensor, temperature: torch.Tensor,
                       topp: torch.Tensor) -> torch.Tensor:
    """Sample one token id per row of (B, vocab) f32 logits, reference semantics, with
    the row's coin u in [0, 1). temperature, topp: (B,) f32. Returns (B,) int64.

    Greedy rows (temperature 0) take the argmax; the others softmax(logits / T), then
    multinomial (topp outside (0, 1)) or nucleus over the pre-filter survivors, whose
    all-filtered degenerate case decays to the argmax (the reference reads
    probindex[-1], which is undefined)."""
    n = logits.shape[-1]
    greedy = logits.argmax(-1)
    # greedy rows divide by 1, so their unused stochastic branch stays finite
    t = torch.where(temperature == 0, torch.ones_like(temperature), temperature)
    x = logits / t[:, None]
    e = torch.exp(x - x.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)  # tensor / tensor, as jax.nn.softmax divides
    # multinomial
    csum = probs.cumsum(-1)
    mult = torch.searchsorted(csum, (u * csum[:, -1])[:, None], right=True)[:, 0]
    mult = mult.clamp(max=n - 1)
    # nucleus: pre-filter cutoff (tokenizer.cpp:338-345), sort the survivors
    cutoff = (1.0 - topp) / torch.full_like(topp, n - 1)
    masked = torch.where(probs >= cutoff[:, None], probs, torch.zeros_like(probs))
    order = torch.argsort(-masked, dim=-1, stable=True)
    csum = torch.gather(masked, 1, order).cumsum(-1)
    over = csum > topp[:, None]
    last = torch.where(over.any(-1), over.int().argmax(-1), torch.full_like(greedy, n - 1))
    r = u * torch.gather(csum, 1, last[:, None])[:, 0]
    pick = torch.searchsorted(csum, r[:, None], right=True)[:, 0]
    nucleus = torch.gather(order, 1, torch.minimum(pick, last)[:, None])[:, 0]
    stochastic = torch.where((topp > 0) & (topp < 1), nucleus, mult)
    return torch.where(temperature == 0, greedy, stochastic)


def device_sample(logits: torch.Tensor, key: torch.Tensor, temperature: torch.Tensor,
                  topp: torch.Tensor) -> torch.Tensor:
    """device_sample_coin with each row's coin drawn by jax.random.uniform(key) from its
    (B, 2) threefry key."""
    return device_sample_coin(logits, uniform(key), temperature, topp)


# ------------------------------------------------------------------
# xorshift* (the host Sampler's RNG, utils.cpp:79-90)
# ------------------------------------------------------------------
# The uint64 state is carried as two uint32 halves held in int64 tensors; every product
# below fits in 63 bits, and each result is masked back to 32.

_XSM_HI = 0x2545F491  # 0x2545F4914F6CDD1D, the xorshift* multiplier
_XSM_LO = 0x4F6CDD1D


def _xor_shr(hi, lo, n: int):
    """s ^ (s >> n) on a split uint64, 0 < n < 32."""
    return hi ^ (hi >> n), lo ^ (((lo >> n) | (hi << (32 - n))) & M32)


def _xor_shl(hi, lo, n: int):
    """s ^ (s << n) on a split uint64, 0 < n < 32."""
    return hi ^ (((hi << n) | (lo >> (32 - n))) & M32), lo ^ ((lo << n) & M32)


def xorshift_star_step(hi: torch.Tensor, lo: torch.Tensor):
    """One xorshift* round on int64 tensors holding uint32 halves; returns (hi', lo',
    out_u32). Bit-exact with sampler._random_u32 (the state, and the high 32 bits of the
    64-bit product)."""
    hi, lo = _xor_shr(hi, lo, 12)
    hi, lo = _xor_shl(hi, lo, 25)
    hi, lo = _xor_shr(hi, lo, 27)
    # ((s * M) mod 2^64) >> 32 = hi32(lo * M_lo) + lo * M_hi + hi * M_lo (mod 2^32);
    # lo * M_lo < 2^63, so its high half is one shift
    out = ((lo * _XSM_LO) >> 32) + ((lo * _XSM_HI) & M32) + ((hi * _XSM_LO) & M32)
    return hi, lo, out & M32


def xorshift_coin(hi: torch.Tensor, lo: torch.Tensor):
    """Advance the state; returns (hi', lo', coin in [0, 1) f32), the host Sampler's
    randomF32 (utils.cpp:88-90)."""
    hi, lo, out = xorshift_star_step(hi, lo)
    return hi, lo, (out >> 8).to(torch.float32) * (1.0 / 16777216.0)


# ------------------------------------------------------------------
# threefry2x32: jax.random's default PRNG, keys as int64 (..., 2) [k0, k1]
# ------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds), as jax._src.prng lowers it; returns the
    two output words. Broadcasts over tensors or Python ints."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """jax.random.PRNGKey(seed) with 64-bit types off (the JAX package's setting): the
    seed becomes an int32 first, so the key is [0, seed mod 2^32] for any non-negative
    seed (tests/test_torch_device_loop.py holds this against jax)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split (partitionable threefry): key i hashes the counter (0, i)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(i), i)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in(key, data) for data in [0, 2^32): the hash of (0, data)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([b0, b1], dim=-1)


def uniform(key: torch.Tensor) -> torch.Tensor:
    """jax.random.uniform(key) (shape (), f32, [0, 1)): the 32 random bits of counter 0
    (the two hash words xored), 23 of them as the mantissa of a float in [1, 2), minus
    1. key (..., 2) -> (...,)."""
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], 0, 0)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


# ------------------------------------------------------------------
# the loops
# ------------------------------------------------------------------


def make_decode_loop(spec: ModelSpec, params, n_steps: int, *, mode: str = "greedy",
                     dtype=torch.float32, use_kernels=False,
                     attn_window: int | None = None, fused_prologue: bool = False,
                     graphs: StepGraphs | None = None, mesh=None,
                     compress_collectives: bool = False, sp_mesh=None):
    """Build fn(rope, token, kc, vc, start_pos, key, temperature, topp) ->
    (tokens (n_steps,), last_logits (vocab,), kc, vc).

    `token` is the last prompt token (one sequence); the loop decodes n_steps tokens,
    each sample fed back as the next input, and the caches advance n_steps positions.
    `key` is a threefry key (2,) (prng_key / split): step i samples with
    uniform(fold_in(key, i)), as the JAX loop does. `mode` is fixed at build: "greedy"
    (argmax only) or "sample" (runtime temperature and top-p).

    The outputs are the loop's static device buffers, valid until its next call; a
    captured step runs on the caches it was first called with. With `graphs` enabled
    each step is one CUDA graph replay. `mesh` and `compress_collectives` are forward's:
    this rank's tp step (every rank runs the loop with the same inputs, and the gathered
    logits, hence the samples, are the same on every rank). `sp_mesh` is forward's too:
    the caches are this rank's sp stripe, and since each sp rank's logits may differ in
    their last bits, every step feeds rank 0's pick, broadcast over the whole job."""
    assert mode in ("greedy", "sample"), mode
    st: dict = {}

    def step():
        tok, pos, i = st["tok"], st["pos"], st["step"]
        logits, _, _ = forward(params, spec, st["rope"], tok[None, :], st["kc"], st["vc"],
                               pos[0], dtype=dtype, use_kernels=use_kernels,
                               attn_window=attn_window, fused_prologue=fused_prologue,
                               mesh=mesh, compress_collectives=compress_collectives,
                               sp_mesh=sp_mesh)
        row = logits[:, -1].float()  # (1, vocab)
        if mode == "greedy":
            nxt = row.argmax(-1)
        else:
            nxt = device_sample(row, fold_in(st["key"], i), st["temp"], st["topp"])
        if sp_mesh is not None:
            nxt = broadcast_tensor(nxt.contiguous(), sp_mesh)
        st["toks"].index_copy_(0, i, nxt)
        st["row"].copy_(row[0])
        tok.copy_(nxt)
        pos.add_(1)
        i.add_(1)

    def run(rope, token, kc, vc, start_pos, key, temperature=0.0, topp=0.9):
        faults.fire("device_loop.dispatch", n_steps=n_steps)
        if not st:
            dev = kc.device
            st.update(rope=rope, kc=kc, vc=vc,
                      tok=torch.zeros(1, dtype=torch.int64, device=dev),
                      pos=torch.zeros(1, dtype=torch.int64, device=dev),
                      step=torch.zeros(1, dtype=torch.int64, device=dev),
                      key=torch.zeros(2, dtype=torch.int64, device=dev),
                      temp=torch.zeros(1, dtype=torch.float32, device=dev),
                      topp=torch.zeros(1, dtype=torch.float32, device=dev),
                      toks=torch.zeros(n_steps, dtype=torch.int64, device=dev),
                      row=torch.zeros(spec.vocab_size, dtype=torch.float32, device=dev))
        elif kc is not st["kc"] or vc is not st["vc"]:
            raise ValueError("a decode loop runs on the caches it was built on")
        st["tok"].fill_(int(token))
        st["pos"].fill_(int(start_pos))
        st["step"].zero_()
        k = [int(v) for v in key]
        st["key"][0].fill_(k[0])
        st["key"][1].fill_(k[1])
        st["temp"].fill_(float(temperature))
        st["topp"].fill_(float(topp))
        carry = (st["tok"], st["pos"], st["step"])
        for _ in range(n_steps):
            if graphs is None:
                step()
            else:
                graphs.run((f"decode_loop/{n_steps}", mode, attn_window, 1), step, carry)
        return st["toks"], st["row"], kc, vc

    return run


def make_batched_decode_loop(spec: ModelSpec, params, n_steps: int, *,
                             mode: str = "greedy", dtype=torch.float32, use_kernels=False,
                             attn_window: int | None = None,
                             fused_prologue: bool = False, kv_block_tokens: int = 0,
                             paged_kernel: bool = False,
                             graphs: StepGraphs | None = None, masked: bool = False,
                             mesh=None, compress_collectives: bool = False):
    """Batched K-step super-step: n_steps decode steps for all B cache rows, sampling on
    the device — the serving-path counterpart of make_decode_loop.

    Builds fn(rope, tokens (B,), kc, vc, start_pos (B,), rng (B, 2) [hi, lo],
    temperature (B,), topp (B,), budget (B,), tables=None) ->
    (toks (n_steps, B), last_tok (B,), pos (B,), rng (B, 2), kc, vc).

    Inputs are host values, or the device tensors a previous call returned: the
    (last_tok, pos, rng) trailer is the loop's final carry — last_tok each row's
    block-tail sample (its KV not yet written), pos the row's position after its
    budgeted steps, rng the advanced xorshift* state — so a scheduler can chain the
    next dispatch from them without a host round trip. The outputs are this loop's
    static device buffers, valid until its next call (a carry handed to another loop is
    copied on the device).

    Row r decodes at its own start_pos and stops advancing after budget[r] steps; a
    parked row keeps riding with its position pinned at min(pos, seq_len - 1), so its
    writes land on slots its reads mask and its next real token overwrites. "sample"
    mode draws exactly one xorshift* coin per live stochastic step (greedy rows none),
    the host Sampler's state evolution, so the scheduler uploads sampler.state before
    the dispatch and writes the returned state back after.

    kv_block_tokens > 0: kc/vc are (L, N, hk, bt, hs) block pools read through the
    (B, W) int32 `tables`. A captured step runs on the caches and table it was first
    called with.

    The fault point `device_loop.batched_dispatch` fires on the host before anything is
    uploaded or replayed; then `guard()`, where given, may still refuse the dispatch by
    raising (the BatchEngine's epoch check).

    masked=True builds the grammar-constrained variant (constrain/): the per-row GLOBAL
    automaton state rides the carry, each step gathers the state's packed bitmask row
    from the device constraint table, lowers disallowed logits to MASK_NEG before the
    argmax or the sampler, and advances the state through the emitted token. run() then
    takes constrain=(cstate (B,), mask (S, W) int32, delta (S, V) int32) — cstate host
    values or a previous masked call's device carry, mask and delta the table's static
    buffers, which the captured steps read — and appends the final state to its outputs.
    Rows at state 0 (the universal row) sample as the unmasked build does. Each step of
    the masked build is its own graph (key suffix "mask").

    `mesh` and `compress_collectives` are forward's: under tp every rank runs the loop
    on the same inputs, and since the gathered logits are the same on every rank, so
    are the samples and the carry (a follower chains from its own carry)."""
    assert mode in ("greedy", "sample"), mode
    paged = kv_block_tokens > 0
    seq_len = spec.seq_len
    st: dict = {}

    def step():
        ints, i = st["ints"], st["step"]
        tok, pos, hi, lo, budget = ints[:5]  # views: rows of one buffer
        temp, topp = st["floats"]
        live = i < budget
        step_pos = torch.where(live, pos, pos.clamp(max=seq_len - 1))
        logits, _, _ = forward(params, spec, st["rope"], tok[:, None], st["kc"], st["vc"],
                               step_pos, dtype=dtype, use_kernels=use_kernels,
                               attn_window=attn_window,
                               block_tables=st["tables"] if paged else None,
                               block_tokens=kv_block_tokens, paged_kernel=paged_kernel,
                               fused_prologue=fused_prologue, mesh=mesh,
                               compress_collectives=compress_collectives)
        rows = logits[:, -1].float()  # (B, vocab)
        if masked:
            cst = ints[5]
            rows = _apply_token_mask(rows, st["cmask"][cst])
        if mode == "greedy":
            nxt = rows.argmax(-1)
        else:
            nhi, nlo, coin = xorshift_coin(hi, lo)
            nxt = device_sample_coin(rows, coin, temp, topp)
            drew = live & (temp != 0)
            hi.copy_(torch.where(drew, nhi, hi))
            lo.copy_(torch.where(drew, nlo, lo))
        if masked:
            # advance the automaton through the emitted token (a masked sample is always
            # an allowed transition)
            cst.copy_(torch.where(live, st["cdelta"][cst, nxt].long(), cst))
        st["toks"].index_copy_(0, i, nxt[None])
        tok.copy_(torch.where(live, nxt, tok))
        pos.copy_(torch.where(live, pos + 1, pos))
        i.add_(1)

    def run(rope, tokens, kc, vc, start_pos, rng, temperature, topp, budget, tables=None,
            guard=None, constrain=None):
        faults.fire("device_loop.batched_dispatch", n_steps=n_steps)
        if guard is not None:
            guard()  # the caller's last word before anything reaches the stream
        b = len(budget)
        cstate, cmask, cdelta = constrain if masked else (None, None, None)
        if not st:
            dev = kc.device
            st.update(rope=rope, kc=kc, vc=vc, tables=tables, cmask=cmask, cdelta=cdelta,
                      ints=torch.zeros(6 if masked else 5, b, dtype=torch.int64,
                                       device=dev),
                      floats=torch.zeros(2, b, dtype=torch.float32, device=dev),
                      step=torch.zeros(1, dtype=torch.int64, device=dev),
                      toks=torch.zeros(n_steps, b, dtype=torch.int64, device=dev))
            ints = st["ints"]
            st["carry"] = (ints[0], ints[1], ints[2:4].T) + ((ints[5],) if masked else ())
        elif (kc is not st["kc"] or vc is not st["vc"] or tables is not st["tables"]
              or cmask is not st["cmask"] or cdelta is not st["cdelta"]):
            raise ValueError("a batched decode loop runs on the caches, block table and "
                             "constraint table it was built on")
        ints = st["ints"]
        for dst, v in zip(st["carry"], (tokens, start_pos, rng, cstate)):
            if not isinstance(v, torch.Tensor):  # host state
                upload(dst, np.asarray(v, np.int64).reshape(dst.shape))
            elif v is not dst:  # another loop's carry: a copy on the device
                dst.copy_(v)
        upload(ints[4], budget)
        upload(st["floats"], np.stack([np.asarray(temperature, np.float32),
                                       np.asarray(topp, np.float32)]))
        st["step"].zero_()
        carry = (ints, st["step"])
        key = ("batched_loop", mode, attn_window, b, n_steps) + (("mask",) if masked else ())
        for _ in range(n_steps):
            if graphs is None:
                step()
            else:
                graphs.run(key, step, carry)
        if masked:
            return (st["toks"], *st["carry"][:3], kc, vc, st["carry"][3])
        return (st["toks"], *st["carry"], kc, vc)

    return run


def make_batched_verify_loop(spec: ModelSpec, params, block: int, *,
                             mode: str = "greedy", dtype=torch.float32, use_kernels=False,
                             attn_window: int | None = None,
                             fused_prologue: bool = False, kv_block_tokens: int = 0,
                             paged_kernel: bool = False,
                             graphs: StepGraphs | None = None, masked: bool = False,
                             mesh=None, compress_collectives: bool = False):
    """Batched draft-verify step: ONE (B, T=block) forward ingests each row's proposal
    block, and acceptance on the device turns it into up to T tokens per row — the
    speculative counterpart of make_batched_decode_loop (the JAX package's
    make_batched_verify_loop, unmasked).

    Builds fn(rope, proposals (B, T), kc, vc, start_pos (B,), rng (B, 2) [hi, lo],
    temperature (B,), topp (B,), ndraft (B,), tables=None) ->
    (targets (T, B), acc (B,), last_tok (B,), pos (B,), rng (B, 2), kc, vc).

    Row r: proposals[r] = [pending token, draft_0 .. draft_{nd-1}, pad ...] with
    nd = ndraft[r]; -1 parks the row (its start_pos must already be clamped so all T
    scratch writes stay in the cache, as the scheduler's _park_positions does). The
    forward writes the block's KV at start_pos .. start_pos + T - 1; a target is sampled
    at every position with the host Sampler's semantics (argmax for greedy; for
    sampling, T xorshift* coins in the host stream's order, coin i for position i), and
    acc[r] counts the leading drafts whose target matched: the emitted tokens are
    targets[0 .. acc], where targets[acc] is the correction (the first mismatch's own
    sample) or the bonus token (every draft accepted). Rejected positions hold KV of
    rejected inputs past the verified frontier start_pos + acc + 1, where every read
    masks them.

    The (last_tok, pos, rng) trailer is the carry rewound to the frontier on the
    device: last_tok = targets[acc] (sampled, its KV not yet written), pos = start_pos +
    acc + 1, and rng the xorshift* state after exactly acc + 1 coins for live
    stochastic rows (greedy and parked rows draw none), so a super-step chained from it
    (make_batched_decode_loop) continues the stream for any accept outcome. The inputs
    are host values (a verify is never chained from a device carry: its proposals are
    drafted from delivered tokens); the outputs are static device buffers, valid until
    the next call. The step reads only its input buffers and writes only its output
    buffers and the caches, so a capture's warm-up needs no restore; on the card with
    `graphs` enabled it is one CUDA graph per (mode, window bucket, rows, T). The fault
    point `device_loop.verify_dispatch` and then `guard()` run before any upload, as in
    make_batched_decode_loop.

    masked=True is the grammar-constrained variant (constrain/): the automaton state
    chain runs along each row's PROPOSAL tokens, so position i's target is sampled under
    the mask of the state reached after drafts 0 .. i-1 — a draft token the grammar
    disallows can never be accepted (its position's masked target cannot equal it).
    run() takes constrain=(cstate, mask, delta) as the masked decode loop does and
    appends the frontier state: the chain state at the accept boundary advanced through
    the emitted correction or bonus token. Its graph key ends in "mask"."""
    assert mode in ("greedy", "sample"), mode
    assert block >= 2, "a verify block needs at least one draft position"
    paged = kv_block_tokens > 0
    st: dict = {}

    def step():
        pos, hi, lo, nd = st["ints"][:4]  # views: rows of one buffer
        temp, topp = st["floats"]
        props = st["props"]
        b, t = props.shape
        live = nd >= 0
        logits, _, _ = forward(params, spec, st["rope"], props, st["kc"], st["vc"], pos,
                               dtype=dtype, use_kernels=use_kernels,
                               attn_window=attn_window,
                               block_tables=st["tables"] if paged else None,
                               block_tokens=kv_block_tokens, paged_kernel=paged_kernel,
                               fused_prologue=fused_prologue, mesh=mesh,
                               compress_collectives=compress_collectives)
        rows = logits.float()  # (B, T, vocab)
        if masked:
            # automaton states along the proposal path: position i is masked by the state
            # after drafts 0 .. i-1 (chain[i]); the chain equals the emitted path up to and
            # including the first mismatch, all the scheduler ever delivers
            cdelta = st["cdelta"]
            sts = [st["ints"][4]]
            for i in range(1, t):
                sts.append(cdelta[sts[-1], props[:, i]].long())
            chain = torch.stack(sts)  # (T, B)
            rows = _apply_token_mask(rows, st["cmask"][chain.T])  # (B, T, V)
        if mode == "greedy":
            targets = rows.argmax(-1)  # (B, T)
        else:
            # T coins per row in the host stream's order: coin i (and the state after
            # i + 1 draws) samples the block's i-th emitted token
            coins, his, los = [], [], []
            h, l = hi, lo
            for _ in range(t):
                h, l, c = xorshift_coin(h, l)
                coins.append(c)
                his.append(h)
                los.append(l)
            flat = device_sample_coin(rows.reshape(b * t, -1),
                                      torch.stack(coins, 1).reshape(-1),
                                      temp.repeat_interleave(t), topp.repeat_interleave(t))
            targets = flat.reshape(b, t)
        # accepted length: leading draft positions whose target matched (the sum of the
        # cumulative product of matches), capped by the row's real draft count
        di = torch.arange(t - 1, device=props.device)
        match = (targets[:, :-1] == props[:, 1:]) & (di[None, :] < nd[:, None])
        acc = torch.cumprod(match.long(), dim=1).sum(1)
        acc = torch.where(live, acc, torch.zeros_like(acc))
        out = st["out"]
        st["targets"].copy_(targets.T)
        st["acc"].copy_(acc)
        out[0].copy_(torch.where(live, targets.gather(1, acc[:, None])[:, 0], props[:, 0]))
        out[1].copy_(torch.where(live, pos + acc + 1, pos))
        if mode == "sample":
            # the carry rewound to the verified frontier: acc + 1 coins drawn
            drew = live & (temp != 0)
            out[2].copy_(torch.where(drew, torch.stack(his).gather(0, acc[None])[0], hi))
            out[3].copy_(torch.where(drew, torch.stack(los).gather(0, acc[None])[0], lo))
        else:
            out[2:4].copy_(st["ints"][1:3])
        if masked:
            # the frontier state: `out[0]` was sampled under chain[acc]'s mask, so the
            # transition is always an allowed one
            front = chain.gather(0, acc[None])[0]
            out[4].copy_(torch.where(live, cdelta[front, out[0]].long(), st["ints"][4]))

    def run(rope, proposals, kc, vc, start_pos, rng, temperature, topp, ndraft,
            tables=None, guard=None, constrain=None):
        faults.fire("device_loop.verify_dispatch", block=block)
        if guard is not None:
            guard()
        props = np.asarray(proposals, np.int64)
        b, t = props.shape
        if t != block:
            raise ValueError(f"a verify loop of block {block} got {t} positions")
        cstate, cmask, cdelta = constrain if masked else (None, None, None)
        rows = 5 if masked else 4
        if not st:
            dev = kc.device
            st.update(rope=rope, kc=kc, vc=vc, tables=tables, cmask=cmask, cdelta=cdelta,
                      props=torch.zeros(b, t, dtype=torch.int64, device=dev),
                      ints=torch.zeros(rows, b, dtype=torch.int64, device=dev),
                      floats=torch.zeros(2, b, dtype=torch.float32, device=dev),
                      targets=torch.zeros(t, b, dtype=torch.int64, device=dev),
                      acc=torch.zeros(b, dtype=torch.int64, device=dev),
                      out=torch.zeros(rows, b, dtype=torch.int64, device=dev))
            out = st["out"]
            st["carry"] = (out[0], out[1], out[2:4].T) + ((out[4],) if masked else ())
        elif (kc is not st["kc"] or vc is not st["vc"] or tables is not st["tables"]
              or cmask is not st["cmask"] or cdelta is not st["cdelta"]):
            raise ValueError("a batched verify loop runs on the caches, block table and "
                             "constraint table it was built on")
        rng = np.asarray(rng, np.int64).reshape(b, 2)
        upload(st["props"], props)
        ints = [np.asarray(start_pos, np.int64), rng[:, 0], rng[:, 1],
                np.asarray(ndraft, np.int64)]
        if masked:
            ints.append(np.asarray(cstate, np.int64))
        upload(st["ints"], np.stack(ints))
        upload(st["floats"], np.stack([np.asarray(temperature, np.float32),
                                       np.asarray(topp, np.float32)]))
        if graphs is None:
            step()
        else:
            graphs.run(("batched_verify", mode, attn_window, b, t)
                       + (("mask",) if masked else ()), step)
        if masked:
            return (st["targets"], st["acc"], *st["carry"][:3], kc, vc, st["carry"][3])
        return (st["targets"], st["acc"], *st["carry"], kc, vc)

    return run
