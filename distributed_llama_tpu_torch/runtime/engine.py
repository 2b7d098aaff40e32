"""Inference engine: model loading, chunked prefill, the generation loop, stats.

The single-card counterpart of the JAX package's runtime/engine.py (reference: App::run
+ Inference, src/app.cpp:123-155, src/tasks.cpp:158-230). Prefill runs in chunks of
[64, 8, 1] tokens; decode runs one token per step against the KV cache; attention reads
a power-of-two window bucket of the cache that covers the live context.

Two cache layouts: one sequence in dense (L, 1, hk, S, hs) caches (the generation loop
below), or, for the batched serving engine (runtime/batch_engine.py), `batch` rows in
dense (L, B, hk, S, hs) caches or, with `kv_pool=(n_blocks, block_tokens)`, in
(L, N, hk, bt, hs) block pools read through per-row block tables (`step_rows`).

One-token steps of the single-sequence loop run a step function of static device
buffers (the token and a 0-d position tensor): on the card with the kernels on it is
captured once per window bucket as a CUDA graph and replayed (runtime/step_graph.py, the
counterpart of the JAX engine's jitted step; `cuda_graph=False` runs the same step
eagerly beside it), on the CPU it runs eagerly. Prefill chunks of more than one token
run eagerly. generate_chunked runs the K-step device loop (runtime/device_loop.py).
generate_speculative verifies prompt-lookup drafts (runtime/speculative.py) in T > 1
steps through infer_chunk_logits; a block is padded to its verify bucket (2, 3, 5, 9,
...), and on the card with the kernels on each bucket's step is a CUDA graph.

Host KV spill (`kv_cache_storage="host"|"disc"`, runtime/paged_cache.py): the device
caches are a ring of the `kv_cache_resident` newest positions and a HostKVStore holds the
whole history. While pos + T <= R (the warm phase) the ring is a plain cache prefix and
the ordinary steps run (one-token steps as CUDA graphs), the new rows copied into the
store after each; past it every step runs forward(paged_cold=store.cold_attend) eagerly
and appends its rows before pos advances.

Tensor parallelism (`tp`, `mesh`, parallel/): one Engine per rank, each holding its
shard of the weights and its KV heads (parallel/tp.py; a block pool is sharded by KV
heads too), every rank running the same steps on the same tokens; the forward pass
reduces the partial sums over the mesh (through the Q80 wire with
`compress_collectives`). Rank 0 decides what every rank decodes: its sampled token, and
whether its stop check or its token callback ended the generation, are broadcast
(`_deliver`), so no rank can decode another token or stop elsewhere. The device loop and
n-gram speculation run on every rank alike: the gathered logits are the same on every
rank, so are their picks, and only each chunk's or turn's stop is broadcast. A tp step
runs eagerly: the gloo wire is host-side and cannot be captured in a CUDA graph, so
cuda_graph is off under tp > 1. The host KV spill is refused there (single-card, as in
the JAX package). A MoE model's experts split over tp in one of two layouts
(`moe_sharding`): "slice" cuts every expert's hidden axis, "expert" gives each rank E/tp
whole experts (expert parallelism), of which it computes the active ones it owns; the
same merge point sums the MoE output in both.

Sequence parallelism (`sp`, ops/ring_attention.py): the ranks of the (sp, tp) grid
(parallel/mesh.py) each hold a stripe of the KV cache's sequence axis, and every step's
attention is the ring over them. One sequence at one scalar position, so batch > 1, the
block pool and the host KV spill are refused under sp (the JAX engine's rules). Each sp
rank combines the ring's blocks in its own order, so its logits may differ from
another's in their last bits: rank 0 decides every token over the whole job (the host
loop's `_deliver`, one broadcast a step in the device loop, the verify turn's tokens in
speculation). Steps run eagerly, as under tp; a mesh of one keeps its graphs.

The engine runs on `cuda` unless the caller passes device="cpu" (or a mesh on the CPU);
without a GPU and without device="cpu" it raises. It never moves to the CPU on its own.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.forward import forward, init_kv_cache, init_kv_pool
from ..models.params import Params, decode_stream_bytes, params_to, prepare_for_cuda
from ..models.spec import ModelSpec
from ..obs import flight, metrics, trace
from ..ops.rope import RopeTables
from ..parallel.collectives import broadcast_ints
from ..parallel.sharding import check_moe_sharding
from ..parallel.traffic import CollectiveTraffic, publish_traffic
from ..quants import FloatType
from ..resilience import faults
from ..tokenizer.bpe import Tokenizer
from .step_graph import StepGraphs, copy_to_host, upload

PREFILL_CHUNKS = (64, 8, 1)

# the JAX engine's families: per-dispatch wall times (the step and its logits' host
# copy), prompt tokens prefilled and tokens decoded by the single-sequence loops. All
# are observed on the host around a dispatch, never inside a captured step
_DISPATCH_SECONDS = metrics.histogram(
    "engine_dispatch_seconds",
    "Wall time of one device dispatch (incl. the logits host transfer)",
    labelnames=("kind",))
_DISP_PREFILL = _DISPATCH_SECONDS.labels(kind="prefill")
_DISP_DECODE = _DISPATCH_SECONDS.labels(kind="decode")
_DISP_LOOP = _DISPATCH_SECONDS.labels(kind="device_loop")
_PREFILL_TOKENS = metrics.counter(
    "engine_prefill_tokens_total", "Prompt tokens run through prefill")
_DECODE_TOKENS = metrics.counter(
    "engine_decode_tokens_total", "Tokens decoded by the sequential engine")


@dataclass
class GenerationStats:
    """Per-token timing, the analog of the reference's G/I/T printout
    (dllama.cpp:76-93)."""

    prompt_tokens: int = 0
    generated_tokens: int = 0
    # prompt tokens whose prefill admission skipped (same-slot rewind and prefix-cache
    # remap or seed): for a resumed request, the share of prompt + delivered tokens the
    # new replica did not run again
    reused_tokens: int = 0
    prefill_ms: float = 0.0
    # per decoded token: total (sample + step) and step-only wall times, in ms. Where
    # one dispatch covers several tokens (a verify block, a device-loop chunk, a
    # super-step) each entry is the dispatch time over its token count: an average
    token_ms: list[float] = field(default_factory=list)
    infer_ms: list[float] = field(default_factory=list)
    # speculative decoding (runtime/speculative.py, the BatchEngine's verify path):
    # verify dispatches, draft tokens proposed and accepted, each verify dispatch's
    # wall ms, and one (tokens out before the turn, drafted, accepted) per verify turn
    spec_steps: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_step_ms: list[float] = field(default_factory=list)
    spec_turns: list = field(default_factory=list)
    # collective wire bytes per decoded token, per device (the reference's S/R socket
    # columns, dllama.cpp:76-93): "measured" counts the decode step's collectives
    # (Engine.collective_stats), "modeled" is collective_kbytes_per_token
    sent_kbytes_per_token: float = 0.0
    recv_kbytes_per_token: float = 0.0
    traffic_source: str = "modeled"

    @property
    def avg_token_ms(self) -> float:
        return float(np.mean(self.token_ms)) if self.token_ms else 0.0

    @property
    def avg_infer_ms(self) -> float:
        return float(np.mean(self.infer_ms)) if self.infer_ms else 0.0

    @property
    def tokens_per_second(self) -> float:
        return 1000.0 / self.avg_token_ms if self.token_ms else 0.0


class LeaderAborted(RuntimeError):
    """Raised on a tp follower when rank 0's generation ended in an exception of its
    own (a token callback or stop check that raised): the follower's generation ends
    where rank 0's did, with the same cache position."""


def resolve_device(device=None) -> torch.device:
    """`cuda` unless told otherwise; raise when CUDA is asked for and absent."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(CLI: --device cpu) to run on the CPU")
    return dev


def collective_kbytes_per_token(spec: ModelSpec, tp: int, compress: bool) -> float:
    """Bytes each device exchanges per decoded token (the JAX package's model, unchanged).
    Mirrors the reference's S/R socket counters (root broadcast+gather per layer,
    tasks.cpp:44-94) with ring-collective wire costs:

    - per layer, two activation all-reduces (attention-out + ffn-out), each
      2x(tp-1)/tp of its payload. Compressed, the payload is the Q80 wire format (int8
      values + f16 scale per 32-block = 34/32 bytes/elem) moved by the two-phase
      quantized reduce (parallel/collectives.py): all-to-all then all-gather, each
      (tp-1)/tp of the compressed payload, so the same 2x(tp-1)/tp factor holds;
    - one logits all-gather: each device contributes its vocab/tp slice and receives
      the rest, (tp-1)/tp of the full f32 logits row."""
    if tp <= 1:
        return 0.0
    elem = 34 / 32 if compress else 4  # Q80 wire bytes/elem vs f32
    per_layer = 2 * spec.dim * elem  # attention-out psum + ffn-out psum payloads
    layers = 2 * (tp - 1) / tp * spec.n_layers * per_layer
    logits = (tp - 1) / tp * spec.vocab_size * 4
    return (layers + logits) / 1024.0


def collective_bytes_per_step(spec: ModelSpec, tp: int, compress: bool, rows: int,
                              t: int) -> float:
    """Bytes each device exchanges for one batched forward step of `rows` rows of `t`
    tokens (the BatchEngine's prefill, mixed, one-token and verify steps; a super-step
    of K steps sends K times this at t = 1): collective_kbytes_per_token for every token
    position the step computes, parked and scratch positions included, since each
    all-reduce and the logits gather carry the whole (B, T) activation. The payload of
    each merge point is (rows·t) rows of dim, so the per-token model scales exactly
    while dim/32 divides by tp (the two-phase Q80 wire; otherwise its one-phase
    fallback moves more)."""
    return collective_kbytes_per_token(spec, tp, compress) * 1024.0 * rows * t


def window_bucket(pos_end: int, seq_len: int, minimum: int) -> int | None:
    """Smallest window bucket (a power of two from `minimum` up) covering cache positions
    [0, pos_end) of a seq_len cache; None: the whole cache."""
    if seq_len <= minimum:
        return None  # tiny contexts: no bucketing
    w = minimum
    while w < pos_end:
        w *= 2
    return None if w >= seq_len else w


class Engine:
    def __init__(self, spec: ModelSpec, params: Params, tokenizer: Tokenizer | None = None,
                 *, device=None, dtype=None, use_kernels: bool | None = None,
                 prefill_kernel: bool = False, fused_matmul: bool = False,
                 batch: int = 1, kv_pool: tuple[int, int] | None = None,
                 paged_kernel: bool | None = None, fused_prologue: bool | None = None,
                 cuda_graph: bool = True, kv_cache_storage: str | None = None,
                 kv_cache_resident: int = 1024, kv_cache_dir: str | None = None,
                 mesh=None, tp: int | None = None, sp: int = 1,
                 compress_collectives: bool = False, moe_sharding: str = "slice"):
        self.spec = spec
        # the MoE experts' placement over tp (parallel/sharding.py), "slice" for a dense
        # model as in the JAX engine; inert on one card and at tp = 1 (whole experts
        # over one rank are the model), as the JAX engine's is
        check_moe_sharding(moe_sharding)
        self.moe_sharding = moe_sharding if spec.is_moe else "slice"
        self.tokenizer = tokenizer
        # tp= and sp= (the JAX Engine's) build this rank's mesh over the process group
        # the caller initialised (parallel/mesh.py init_multihost, or
        # parallel/launch.py); mesh= takes one built already, as dllama's ranks do
        if mesh is None and ((tp is not None and tp > 1) or sp > 1):
            from ..parallel.mesh import make_mesh

            mesh = make_mesh(tp=tp, sp=sp, device=resolve_device(device))
        if mesh is not None:
            if tp is not None and tp != mesh.tp:
                raise ValueError(f"tp={tp} against a mesh of tp={mesh.tp}")
            if sp != 1 and sp != mesh.sp:
                raise ValueError(f"sp={sp} against a mesh of sp={mesh.sp}")
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} against the mesh's {mesh.device}")
            device = mesh.device
        self.mesh = mesh
        self.tp = mesh.tp if mesh is not None else 1
        self.sp = mesh.sp if mesh is not None else 1
        self.compress = bool(compress_collectives)
        if self.tp > 1:
            self._refuse_under_tp(kv_cache_storage=kv_cache_storage)
        if self.sp > 1:
            self._refuse_under_sp(kv_cache_storage=kv_cache_storage, kv_pool=kv_pool,
                                  batch=batch)
        self.device = resolve_device(device)
        on_gpu = self.device.type == "cuda"
        # bf16 activations and caches on the card halve cache traffic (the matvec
        # numerics are Q80 in the kernel either way); f32 on the CPU keeps parity exact
        self.dtype = dtype if dtype is not None else (torch.bfloat16 if on_gpu
                                                      else torch.float32)
        has_quant = any(getattr(t, "ftype", None) in (FloatType.Q40, FloatType.Q80)
                        for t in params["blocks"].values())
        if use_kernels is None:
            use_kernels = on_gpu
        self.use_kernels = bool(use_kernels) and has_quant
        # the M > 1 dequant-matmul kernel for prefill chunks is opt-in (the kwarg, or
        # the CLI's --prefill-kernel)
        self.prefill_kernel = bool(prefill_kernel) and self.use_kernels
        if self.prefill_kernel:
            self.use_kernels = "all"
        # the fused serving rung (the kwarg, or the server's --fused-matmul): everything
        # "all" runs plus the residual-add epilogue for wo/w2 and the gate-pair kernel
        # for separate w1/w3 (kept unmerged for it); subsumes prefill_kernel
        self.fused_matmul = bool(fused_matmul) and bool(self.use_kernels)
        if self.fused_matmul:
            self.use_kernels = "fused"
        # the fused activation prologue (ops/prologue.py): opt-in through the kwarg or
        # DLT_PROLOGUE=1 (0 means off), as in the JAX engine; forward applies it where it
        # can (kernels on, one row of one token)
        if fused_prologue is None:
            fused_prologue = os.environ.get("DLT_PROLOGUE", "").lower() in ("1", "true",
                                                                           "yes")
        self.fused_prologue = bool(fused_prologue)
        # device block pool for batched serving: (n_blocks, block_tokens)
        self.batch = batch
        self.kv_pool = kv_pool
        # the paged-attention kernel follows use_kernels unless asked for explicitly
        self.paged_kernel = bool(paged_kernel if paged_kernel is not None
                                 else self.use_kernels) and kv_pool is not None
        # the host KV spill: one rounded resident size drives the fits-check and the ring
        self.kv_resident = max(64, (kv_cache_resident + 63) // 64 * 64)
        if kv_cache_storage not in (None, "ram", "host", "disc"):
            raise ValueError(f"kv_cache_storage {kv_cache_storage!r}: ram, host or disc")
        self.paged = (kv_cache_storage in ("host", "disc")
                      and spec.seq_len > self.kv_resident)
        self.store = None
        if kv_cache_storage in ("host", "disc") and not self.paged:
            import sys

            print(f"💡 kv-cache-storage={kv_cache_storage} ignored: the full "
                  f"seq_len {spec.seq_len} cache fits the {self.kv_resident}-"
                  "slot resident budget (nothing to page)", file=sys.stderr)
        if self.paged:
            if batch != 1 or kv_pool is not None:
                raise ValueError("the paged KV cache is single-sequence: batch=1 and no "
                                 "kv_pool")
            from .paged_cache import HostKVStore

            self.store = HostKVStore(spec, self.kv_resident, storage=kv_cache_storage,
                                     directory=kv_cache_dir, dtype=self.dtype)
        # one card repacks the weights on itself; a rank repacks and cuts them where the
        # caller holds them (the host, for Engine.load) and moves only its shard, so its
        # card never holds the whole model (the JAX package's device_put of each shard)
        if mesh is None:
            params = params_to(params, self.device)
        if self.use_kernels:
            params = prepare_for_cuda(params, tp=self.tp, spec=spec,
                                      keep_gate_pair=self.fused_matmul,
                                      moe_sharding=self.moe_sharding)
        # every shard's weight bytes one decode step streams; a card streams 1/tp of it
        self.decode_weight_bytes = decode_stream_bytes(params, spec)
        # the rank's step over the mesh where it has merge points (None: the one-card
        # step)
        self._sharded = None
        # the mesh the batched steps and the device loops reduce over (None: no merge
        # points), the same rule as the one-sequence step's
        self._merge = None
        if mesh is not None:
            from ..parallel.tp import make_sharded_forward, merge_mesh, shard_params

            params = params_to(shard_params(params, mesh, spec,
                                            moe_sharding=self.moe_sharding), self.device)
            self._merge = merge_mesh(mesh, self.compress)
            if self._merge is not None or self.sp > 1:
                self._sharded = make_sharded_forward(
                    spec, mesh, dtype=self.dtype, use_kernels=self.use_kernels,
                    compress_collectives=self.compress,
                    fused_prologue=self.fused_prologue, moe_sharding=self.moe_sharding)
        self.params = params
        self._measured_traffic = None  # the decode step's CollectiveTraffic, once counted
        self.rope = RopeTables.create(spec, self.device)
        if self.tp > 1 or self.sp > 1:
            from ..parallel.tp import init_sharded_kv_cache

            self.k_cache, self.v_cache = init_sharded_kv_cache(
                spec, mesh, batch, dtype=self.dtype, kv_pool=kv_pool)
        elif kv_pool is not None:
            self.k_cache, self.v_cache = init_kv_pool(spec, *kv_pool, dtype=self.dtype,
                                                      device=self.device)
        elif self.paged:
            from .paged_cache import init_ring_cache

            self.k_cache, self.v_cache = init_ring_cache(
                spec, self.kv_resident, dtype=self.dtype, device=self.device)
        else:
            self.k_cache, self.v_cache = init_kv_cache(spec, batch, dtype=self.dtype,
                                                       device=self.device)
        self.pos = 0
        # the decode steps replay CUDA graphs on the card with the kernels on; a tp or sp
        # step runs eagerly (its collectives are host calls a capture cannot hold on gloo)
        self.cuda_graph = (bool(cuda_graph) and on_gpu and bool(self.use_kernels)
                           and self.ranks == 1)
        self.graphs = StepGraphs(self.device, self.cuda_graph)
        self._init_steps()

    @property
    def ranks(self) -> int:
        """Ranks that run this engine's steps together: tp·sp (1 on one card)."""
        return self.tp * self.sp

    @staticmethod
    def _refuse_under_sp(kv_cache_storage=None, kv_pool=None, batch: int = 1) -> None:
        """What an sp > 1 engine cannot run (the JAX Engine's rules, engine.py:187-191 and
        :308-310): the ring cache holds one sequence at one scalar position."""
        if kv_cache_storage in ("host", "disc"):
            raise ValueError("the host KV spill is single-card (sp=1): the sequence-sharded "
                             "(ring) cache is the other long-context path, not one to "
                             "combine with it")
        if kv_pool is not None:
            raise ValueError("the device KV block pool is incompatible with sp > 1: the "
                             "sequence-sharded (ring) cache is dense")
        if batch != 1:
            raise ValueError("sp > 1 runs one sequence (batch=1): per-row cache positions "
                             "are incompatible with the sequence-sharded (ring) cache")

    @staticmethod
    def _refuse_under_tp(kv_cache_storage=None) -> None:
        """What a tp > 1 engine cannot run, naming its ROADMAP item."""
        if kv_cache_storage in ("host", "disc"):
            raise ValueError("the host KV spill is single-card (tp=1), as in the JAX "
                             "package; the spill under tp is ROADMAP Queue A item 1 (c)")

    def collective_stats(self) -> CollectiveTraffic:
        """The collectives of one T=1 decode step, counted as they are issued
        (parallel/traffic.py): the port's counterpart of the JAX engine's traced-step
        accounting. Runs one decode step of token 0 at the current position without
        advancing it (the next step at this position writes its own rows over the
        probe's); every rank must call it, as every rank runs the step. Memoized, and
        published as the decode_t1 gauges."""
        if self._measured_traffic is None:
            if self._sharded is None:
                self._measured_traffic = CollectiveTraffic()
            else:
                if self.pos >= self.spec.seq_len:
                    raise ValueError("collective_stats needs a free cache position")
                window = self._window_for(self.pos + 1)
                self._tok1.fill_(0)
                self._pos1.fill_(self.pos)
                with self.mesh.counter.window() as traffic:
                    self._step_t1(window)
                self._measured_traffic = traffic
            publish_traffic(self._measured_traffic, program="decode_t1")
        return self._measured_traffic

    def _fill_traffic(self, stats: GenerationStats) -> None:
        """Per-token S/R from the counted decode step where one was counted, else the
        model; the provenance goes with the numbers."""
        if self._measured_traffic is not None:
            kb = self._measured_traffic.sent_bytes_per_device / 1024.0
            stats.sent_kbytes_per_token = stats.recv_kbytes_per_token = kb
            stats.traffic_source = "measured"
        else:
            stats.sent_kbytes_per_token = stats.recv_kbytes_per_token = (
                collective_kbytes_per_token(self.spec, self.tp, self.compress))
            stats.traffic_source = "modeled"

    def _init_steps(self) -> None:
        """The static step buffers and the step caches built on them."""
        # the one-token step's static inputs: the token and a 0-d position
        self._tok1 = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
        self._pos1 = torch.zeros((), dtype=torch.int64, device=self.device)
        self._decode_loops: dict = {}
        self._verify_toks: dict[int, torch.Tensor] = {}  # bucket -> static (1, T) tokens

    def reset_backend(self) -> None:
        """Re-initialize the device side after a wedge (BatchEngine.recover_wedged):
        drop every captured step graph, the device loops and the static step buffers,
        so each step is captured again at its next use, and zero the KV caches (a paged
        engine's ring; its host store is left as it is) in place.
        The cache tensors keep their storage (a second pool of a large model may not fit
        beside the first while an abandoned thread still holds it), and nothing here
        waits for the device: on a hung stream the zeroing only queues."""
        self.graphs.reset()
        self._init_steps()
        self.k_cache.zero_()
        self.v_cache.zero_()
        self.pos = 0

    @classmethod
    def load(cls, model_path: str, tokenizer_path: str | None = None, *,
             max_seq_len: int = 0, weights_ftype: FloatType | None = None,
             **kw) -> "Engine":
        from ..formats.mfile import load_model

        spec, params = load_model(model_path, max_seq_len, weights_ftype)
        tokenizer = Tokenizer.load(tokenizer_path) if tokenizer_path else None
        if tokenizer is not None and tokenizer.vocab_size != spec.vocab_size:
            raise ValueError(
                f"tokenizer vocab {tokenizer.vocab_size} != model vocab {spec.vocab_size}")
        return cls(spec, params, tokenizer, **kw)

    # attention reads only the first `window` cache positions — a bucket so decode
    # cache traffic tracks the live context, not the allocated seq_len. Buckets are
    # powers of two from 256 up.
    _WINDOW_MIN = 256

    def _window_for(self, pos_end: int) -> int | None:
        """Smallest window bucket covering cache positions [0, pos_end) (of the ring in
        paged mode, whose warm phase is the only user there)."""
        s = self.kv_resident if self.paged else self.spec.seq_len
        return window_bucket(pos_end, s, self._WINDOW_MIN)

    def reset(self) -> None:
        self.pos = 0

    def seek(self, pos: int) -> None:
        """Set the decode position (prefix reuse rewind); the cache keeps every row.

        Paged mode: after a wrap, ring slots hold rows of the abandoned continuation's
        later positions, which the slot-position formula would take for earlier rows,
        so the ring is restored from the host store, in place (captured steps read these
        tensors): a rollback of fewer than R positions returns each rolled-back slot to
        its previous occupant (position q - R; a slot with none stays masked), a longer
        one rebuilds the ring."""
        assert 0 <= pos <= self.pos, f"seek({pos}) past live context {self.pos}"
        if self.paged and pos < self.pos:
            r = self.kv_resident
            if self.pos - pos < r:
                # the speculative rollback runs this after every rejected draft
                prev = torch.arange(pos, self.pos) - r
                prev = prev[prev >= 0]
                if prev.numel():
                    slots = (prev % r).to(self.device)
                    for cache, store in ((self.k_cache, self.store.k),
                                         (self.v_cache, self.store.v)):
                        cache.index_copy_(3, slots, store[:, :, :, prev].to(self.device))
            else:
                lo = max(0, pos - r)
                slots = (torch.arange(lo, pos) % r).to(self.device)
                for cache, store in ((self.k_cache, self.store.k),
                                     (self.v_cache, self.store.v)):
                    cache.zero_()
                    cache.index_copy_(3, slots, store[:, :, :, lo:pos].to(self.device))
        self.pos = pos

    def seed_rows(self, start: int, k_rows: torch.Tensor, v_rows: torch.Tensor) -> None:
        """Write cached KV rows (L, hk, n, hs) of one sequence into cache positions
        [start, start + n) of every batch row, in place (the captured steps read these
        tensors), then move pos forward to start + n: the prefix cache's seed
        (cache/single_slot.py). The one forward move of pos; seek only rewinds."""
        if self.kv_pool is not None or self.paged or self.sp > 1:
            raise RuntimeError("seed_rows writes the dense cache layout (not a block pool, "
                               "a hot ring or an sp stripe)")
        assert start == self.pos, f"seed at {start} with the live context at {self.pos}"
        end = start + k_rows.shape[2]
        if end > self.spec.seq_len:
            raise ValueError(f"context overflow: seed to {end} > {self.spec.seq_len}")
        for cache, rows in ((self.k_cache, k_rows), (self.v_cache, v_rows)):
            rows = rows.to(self.device, self.dtype)
            cache[:, :, :, start:end].copy_(rows[:, None].expand(-1, cache.shape[1],
                                                                 -1, -1, -1))
        self.pos = end

    def read_rows(self, t0: int, t1: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Committed KV rows [t0, t1) of batch row 0 as CPU tensors (L, hk, t1 - t0, hs)
        in the cache dtype: the prefix cache's harvest. The copy queues behind the
        steps already issued."""
        from ..cache.wire import host_rows

        if self.paged or self.sp > 1:
            raise RuntimeError("read_rows reads the dense cache layout; a paged engine's "
                               "history is its host store, an sp rank's a stripe")
        return (host_rows(self.k_cache[:, 0, :, t0:t1]),
                host_rows(self.v_cache[:, 0, :, t0:t1]))

    def infer_chunk(self, tokens: list[int] | np.ndarray) -> np.ndarray:
        """Run a chunk of tokens at the current position; returns last-token logits
        (vocab,) and advances pos. Bounds-checked against seq_len (the reference
        hard-stops at context end, dllama.cpp:190-192)."""
        return self._infer(tokens)[-1]

    def _infer(self, tokens: list[int] | np.ndarray) -> np.ndarray:
        """One step over T tokens; returns all T positions' logits (T, vocab)."""
        if self.batch != 1 or self.kv_pool is not None:
            raise RuntimeError("the single-sequence loop needs batch=1 dense caches; "
                               "batched engines step through step_rows")
        tokens = np.asarray(tokens, dtype=np.int64)
        t = len(tokens)
        if self.pos + t > self.spec.seq_len:
            raise ValueError(f"context overflow: pos {self.pos} + {t} > {self.spec.seq_len}")
        with trace.span("engine.dispatch", {"t": t, "pos": self.pos}):
            faults.fire("engine.dispatch", t=t, pos=self.pos)
            t0 = time.perf_counter()
            if self.paged and self.pos + t > self.kv_resident:
                logits = self._step_paged(tokens)
            else:
                window = self._window_for(self.pos + t)
                if t == 1:
                    self._tok1.fill_(int(tokens[0]))
                    self._pos1.fill_(self.pos)
                    logits = self.graphs.run(("step", "logits", window, 1),
                                             lambda: self._step_t1(window))
                else:
                    toks = torch.from_numpy(tokens)[None, :].to(self.device)
                    logits = self._dense_step(toks, self.pos, window)
                if self.paged:
                    # warm phase: slot == position; the new rows go to the authoritative
                    # store, which the cold partials read once the ring wraps
                    self.store.append(self.k_cache[:, :, :, self.pos:self.pos + t],
                                      self.v_cache[:, :, :, self.pos:self.pos + t],
                                      self.pos)
            self.pos += t
            out = logits[0].cpu().numpy()  # host transfer: the step's fence
            # a one-token dispatch is decode-shaped whichever loop issued it; decode
            # tokens are counted by the loops, which know a decoded token from a prompt
            # token
            (_DISP_PREFILL if t > 1 else _DISP_DECODE).observe(time.perf_counter() - t0)
            return out

    def _step_paged(self, tokens: np.ndarray) -> torch.Tensor:
        """A paged-phase step, eager: the hot ring's attention merged with the host's
        cold partial per layer, then the rows appended to the store before pos
        advances. Returns (1, T, vocab) logits."""
        toks = torch.from_numpy(tokens)[None, :].to(self.device)
        logits, _, _, (k_rows, v_rows) = forward(
            self.params, self.spec, self.rope, toks, self.k_cache, self.v_cache, self.pos,
            dtype=self.dtype, use_kernels=self.use_kernels,
            fused_prologue=self.fused_prologue, paged_cold=self.store.cold_attend)
        self.store.append(k_rows, v_rows, self.pos)
        return logits

    def infer_chunk_logits(self, tokens: list[int] | np.ndarray) -> np.ndarray:
        """infer_chunk, but returns all T positions' logits (T, vocab): the verify step
        of speculative decoding (runtime/speculative.py), which needs every position's
        argmax. Advances pos by T; speculative callers seek() back to the verified
        frontier. A block of T > 1 runs at its verify bucket (one step, and on the card
        one CUDA graph, per bucket), the padding positions being scratch writes past the
        frontier that every read masks and the caller's seek() rewinds. A block whose
        bucket would pass the end of the cache runs eagerly at its own length, as the
        BatchEngine's _plan_verify keeps its buckets inside the cache. A paged engine runs
        every block at its own length, as the JAX engine does: padding would scatter
        scratch rows into live ring slots that seek() does not restore."""
        tokens = np.asarray(tokens, dtype=np.int64)
        t = len(tokens)
        from .speculative import verify_block_bucket

        b = verify_block_bucket(t, self.spec.seq_len)
        if t == 1 or self.paged or self.pos + b > self.spec.seq_len:
            return self._infer(tokens)
        if self.batch != 1 or self.kv_pool is not None:
            raise RuntimeError("the single-sequence loop needs batch=1 dense caches")
        with trace.span("engine.dispatch", {"t": t, "pos": self.pos}):
            faults.fire("engine.dispatch", t=t, pos=self.pos)
            t0 = time.perf_counter()
            window = self._window_for(self.pos + b)
            buf = self._verify_toks.get(b)
            if buf is None:
                buf = self._verify_toks[b] = torch.zeros((1, b), dtype=torch.int64,
                                                         device=self.device)
            upload(buf, np.concatenate([tokens, np.zeros(b - t, np.int64)])[None])
            self._pos1.fill_(self.pos)
            logits = self.graphs.run(("verify", "logits", window, b),
                                     lambda: self._step_block(buf, window))
            self.pos += t
            out = logits[0, :t].cpu().numpy()  # host transfer: the step's fence
            _DISP_PREFILL.observe(time.perf_counter() - t0)
            return out

    def _dense_step(self, toks: torch.Tensor, pos, window: int | None) -> torch.Tensor:
        """One forward step of (1, T) tokens at `pos` on the dense caches, written in
        place: on one card, or this rank's step over the mesh (parallel/tp.py
        make_sharded_forward). Returns (1, T, vocab) logits."""
        if self._sharded is not None:
            logits, _, _ = self._sharded(self.params, self.rope, toks, self.k_cache,
                                         self.v_cache, pos, attn_window=window)
            return logits
        logits, _, _ = forward(
            self.params, self.spec, self.rope, toks, self.k_cache, self.v_cache, pos,
            dtype=self.dtype, use_kernels=self.use_kernels, attn_window=window,
            fused_prologue=self.fused_prologue)
        return logits

    def _step_block(self, toks: torch.Tensor, window: int | None) -> torch.Tensor:
        """A verify block's step on its static tokens and the static position."""
        return self._dense_step(toks, self._pos1, window)

    def _step_t1(self, window: int | None) -> torch.Tensor:
        """The one-token step on the static token and position: (1, 1, vocab) logits."""
        return self._dense_step(self._tok1, self._pos1, window)

    def step_rows(self, tokens_rows, starts, tables: torch.Tensor | None,
                  reads: list[tuple[int, int]], coins: tuple | None = None):
        """One batched (B, T) step for the serving engine: row b's T tokens at its own
        start position starts[b], through the (B, W) int32 block `tables` on this
        engine's device in pool mode. Returns the logits of the (row, position) pairs in
        `reads` as a (len(reads), vocab) array; the host copy is the step's fence. With
        `coins` = (read indices, coins, temperatures, top-ps, masks) it also samples
        those reads on this device (device_loop.device_sample_coin, one call; masks,
        where not None, are (n, W) int32 packed grammar bitmasks applied first) and
        returns (logits, their tokens)."""
        tok = torch.from_numpy(np.asarray(tokens_rows, dtype=np.int64)).to(self.device)
        t = tok.shape[1]
        start = torch.from_numpy(np.asarray(starts, dtype=np.int64)).to(self.device)
        bt = self.kv_pool[1] if self.kv_pool is not None else 0
        logits, self.k_cache, self.v_cache = forward(
            self.params, self.spec, self.rope, tok, self.k_cache, self.v_cache, start,
            dtype=self.dtype, use_kernels=self.use_kernels,
            attn_window=self._window_for(max(s + t for s in starts)),
            block_tables=tables if self.kv_pool is not None else None,
            block_tokens=bt, paged_kernel=self.paged_kernel,
            fused_prologue=self.fused_prologue, mesh=self._merge,
            compress_collectives=self.compress)
        rows = torch.tensor([r for r, _ in reads], dtype=torch.long, device=self.device)
        cols = torch.tensor([c for _, c in reads], dtype=torch.long, device=self.device)
        sel = logits[rows, cols]
        if coins is None:
            return sel.cpu().numpy()
        from .device_loop import _apply_token_mask, device_sample_coin

        idx, u, temps, topps, masks = coins
        vals = torch.tensor([u, temps, topps], dtype=torch.float32).to(self.device)
        rows = sel[idx].float()
        if masks is not None:
            rows = _apply_token_mask(rows, torch.from_numpy(masks).to(self.device))
        toks = device_sample_coin(rows, vals[0], vals[1], vals[2])
        return sel.cpu().numpy(), toks.cpu().tolist()

    def prefill(self, tokens: list[int], stats: GenerationStats | None = None) -> np.ndarray:
        """Chunked prompt ingestion; returns logits after the last prompt token."""
        t0 = time.perf_counter()
        tokens = list(tokens)
        logits = None
        i = 0
        with trace.span("engine.prefill", {"tokens": len(tokens)}):
            while i < len(tokens):
                for chunk in PREFILL_CHUNKS:
                    if len(tokens) - i >= chunk:
                        logits = self.infer_chunk(tokens[i:i + chunk])
                        i += chunk
                        break
        _PREFILL_TOKENS.inc(len(tokens))
        dt_ms = (time.perf_counter() - t0) * 1000.0
        # the single-sequence server's timeline entry: the request id resolves from the
        # caller's bound trace context (a no-op outside a recorded request)
        flight.event(None, "prefill", tokens=len(tokens), ms=round(dt_ms, 3))
        if stats is not None:
            stats.prefill_ms = dt_ms
            stats.prompt_tokens = len(tokens)
        return logits

    def _decode(self, logits: np.ndarray, max_tokens: int, sampler, stats: GenerationStats,
                on_token=None, stop_check=None) -> list[int]:
        """Sample/step until max_tokens, context end, or stop_check truth."""
        out: list[int] = []
        for _ in range(max_tokens):
            if self.pos >= self.spec.seq_len:
                break
            t0 = time.perf_counter()
            # under tp, rank 0's pick and its stop decision, on every rank
            (token,), stop = self._deliver([sampler.sample(logits)], on_token, stop_check,
                                           sync_tokens=True)
            out.append(token)
            stats.generated_tokens += 1
            if stop is not None:
                break
            if self.pos >= self.spec.seq_len:
                break
            t1 = time.perf_counter()
            logits = self.infer_chunk([token])
            t2 = time.perf_counter()
            _DECODE_TOKENS.inc()
            stats.infer_ms.append((t2 - t1) * 1000.0)
            stats.token_ms.append((t2 - t0) * 1000.0)
        return out

    def _deliver(self, tokens: list[int], on_token, stop_check, sync_tokens: bool = False
                 ) -> tuple[list[int], int | None]:
        """Hand `tokens` out through on_token until stop_check holds: returns the tokens
        and the index of the one that stopped (None: no stop). Under tp or sp rank 0 (of
        the whole job) decides:
        its callbacks run, and its stop index goes to every rank in one broadcast (with
        its tokens too when `sync_tokens`, rank 0's host samples); the other ranks call
        on_token on what rank 0 delivered and never their stop_check. A callback that
        raises on rank 0 is raised there, and LeaderAborted on the other ranks, before
        any of them moves its position."""
        stop, err = None, None
        if self.ranks <= 1 or self.mesh.rank == 0:
            try:
                for i, t in enumerate(tokens):
                    if on_token is not None:
                        on_token(t)
                    if stop_check is not None and stop_check(t):
                        stop = i
                        break
            except BaseException as e:
                if self.ranks <= 1:
                    raise
                err = e
        if self.ranks <= 1:
            return tokens, stop
        code = -2 if err is not None else (-1 if stop is None else stop)
        got = broadcast_ints([code] + (list(tokens) if sync_tokens else []), self.mesh)
        if err is not None:
            try:
                err.tp_synced = True  # every rank stopped here: the world is intact
            except AttributeError:  # an exception type without instance attributes
                pass
            raise err
        if got[0] == -2:
            raise LeaderAborted("rank 0's generation raised in its token callback")
        if sync_tokens:
            tokens = got[1:]
        stop = None if got[0] == -1 else got[0]
        if self.mesh.rank != 0 and on_token is not None:
            for t in tokens[:len(tokens) if stop is None else stop + 1]:
                on_token(t)
        return tokens, stop

    def _agree(self, tokens: list[int], cap: int) -> list[int]:
        """Rank 0's list of at most `cap` tokens on every rank of an sp job (a verify
        turn's picks, which each sp rank takes from logits of its own combine order), in
        one broadcast; unchanged without sp."""
        if self.sp <= 1:
            return tokens
        got = broadcast_ints([len(tokens)] + list(tokens) + [0] * (cap - len(tokens)),
                             self.mesh)
        return got[1:1 + got[0]]

    def generate(self, prompt_tokens: list[int], max_tokens: int, sampler,
                 on_token=None, stop_check=None) -> tuple[list[int], GenerationStats]:
        """Host generation loop: prefill + sample/step until max_tokens, context end, or
        stop_check truth. on_token(token_id) streams tokens out."""
        stats = GenerationStats()
        self._fill_traffic(stats)
        logits = self.prefill(prompt_tokens, stats)
        return self._decode(logits, max_tokens, sampler, stats, on_token, stop_check), stats

    def generate_speculative(self, prompt_tokens: list[int], max_tokens: int, sampler, *,
                             k: int = 8, on_token=None, stop_check=None,
                             history_tokens: list[int] | None = None):
        """Greedy prompt-lookup speculative decoding (runtime/speculative.py): emits
        exactly generate()'s tokens, usually in fewer dispatches."""
        from .speculative import generate_speculative

        return generate_speculative(self, prompt_tokens, max_tokens, sampler, k=k,
                                    on_token=on_token, stop_check=stop_check,
                                    history_tokens=history_tokens)

    def generate_with(self, prompt_tokens: list[int], max_tokens: int, sampler, *,
                      device_loop_chunk: int = 0, speculative_k: int = 0,
                      history_tokens: list[int] | None = None,
                      **kw) -> tuple[list[int], GenerationStats]:
        """generate, generate_chunked or generate_speculative: the single switch point
        for the entry points' --device-loop and --speculative flags, as in the JAX
        engine. Speculation is greedy-only and wins over the device loop; a sampled
        request falls back (one warning per engine). history_tokens (speculative only):
        the whole cached context for the n-gram proposer when prompt_tokens is a
        prefix-reuse delta."""
        if speculative_k > 0:
            if getattr(sampler, "temperature", 0.0) == 0.0:
                return self.generate_speculative(prompt_tokens, max_tokens, sampler,
                                                 k=speculative_k,
                                                 history_tokens=history_tokens, **kw)
            if not getattr(self, "_warned_spec_fallback", False):
                self._warned_spec_fallback = True
                import sys

                print("⚠️  --speculative is greedy-only (temperature 0); falling back "
                      "to the " + ("on-device loop" if device_loop_chunk > 0
                                   and not self.paged else "sequential host loop")
                      + " for sampled requests.", file=sys.stderr)
        if device_loop_chunk > 0:
            if not self.paged:
                return self.generate_chunked(prompt_tokens, max_tokens, sampler,
                                             chunk=device_loop_chunk, **kw)
            import sys

            print("⚠️  --device-loop is incompatible with the paged KV cache (host-store "
                  "appends happen between dispatches); using the host loop.",
                  file=sys.stderr)
        return self.generate(prompt_tokens, max_tokens, sampler, **kw)

    def _decode_loop(self, chunk: int, mode: str, window: int | None):
        key = (chunk, mode, window)
        if key not in self._decode_loops:
            from .device_loop import make_decode_loop

            self._decode_loops[key] = make_decode_loop(
                self.spec, self.params, chunk, mode=mode, dtype=self.dtype,
                use_kernels=self.use_kernels, attn_window=window,
                fused_prologue=self.fused_prologue, graphs=self.graphs, mesh=self._merge,
                compress_collectives=self.compress,
                sp_mesh=self.mesh if self.sp > 1 else None)
        return self._decode_loops[key]

    def generate_chunked(self, prompt_tokens: list[int], max_tokens: int, sampler,
                         on_token=None, stop_check=None, chunk: int = 16,
                         ) -> tuple[list[int], GenerationStats]:
        """Generate with the device loop (runtime/device_loop.py): forward and sampling
        stay on the card, and each dispatch of `chunk` steps (a CUDA graph replayed
        `chunk` times on the card) returns `chunk` tokens after one host fence, their
        copy to pinned memory. The prompt minus its last token is prefilled; the last
        prompt token enters as the first loop step. Greedy output is the host loop's;
        stochastic coins come from the JAX engine's threefry stream (key PRNGKey(seed),
        split per chunk, fold_in per step), so a seeded run gives the JAX
        generate_chunked's tokens, not the xorshift* host sampler's.

        Near the context end (fewer than `chunk` positions left) the host loop decodes
        the tail. A stop inside a chunk advances the position only to the stop: the
        cache rows past it are overwritten by later writes."""
        from .device_loop import prng_key, split

        if self.paged:
            raise RuntimeError("the device loop writes a plain cache; a paged engine "
                               "decodes through the host loop (generate_with)")
        stats = GenerationStats()
        if len(prompt_tokens) > 1:
            self.prefill(prompt_tokens[:-1], stats)
        stats.prompt_tokens = len(prompt_tokens)
        # sampler.state is a full-range uint64; the JAX engine masks it to an int64 seed
        key = prng_key(int(getattr(sampler, "state", 0)) & (2**63 - 1))
        temperature = getattr(sampler, "temperature", 0.0)
        topp = getattr(sampler, "topp", 0.9)
        mode = "greedy" if temperature == 0.0 else "sample"
        out: list[int] = []
        token = prompt_tokens[-1]
        done = False
        while not done and len(out) < max_tokens:
            want = max_tokens - len(out)
            seq_left = self.spec.seq_len - self.pos
            if seq_left <= 0:
                break
            if seq_left < chunk:
                tail, tail_stats = self.generate([token], min(want, seq_left), sampler,
                                                 on_token=on_token, stop_check=stop_check)
                out.extend(tail)
                stats.generated_tokens += len(tail)
                stats.token_ms.extend(tail_stats.token_ms)
                stats.infer_ms.extend(tail_stats.infer_ms)
                break
            # the full chunk always runs; a short tail (want < chunk) keeps its first
            # tokens, and the cache rows past pos are overwritten later
            loop = self._decode_loop(chunk, mode, self._window_for(self.pos + chunk))
            t0 = time.perf_counter()
            with trace.span("engine.device_loop", {"chunk": chunk, "pos": self.pos}):
                key, sub = split(key)
                toks, _, _, _ = loop(self.rope, token, self.k_cache, self.v_cache,
                                     self.pos, sub.tolist(), temperature, topp)
                tokens = copy_to_host(toks)()[0][:want].tolist()  # the chunk's one fence
            dt_full = (time.perf_counter() - t0) * 1000.0
            _DISP_LOOP.observe(dt_full / 1000.0)
            _DECODE_TOKENS.inc(len(tokens))
            flight.event(None, "device_loop", chunk=chunk, emitted=len(tokens),
                         ms=round(dt_full, 3))
            # per-token time: the dispatch computes `chunk` tokens even when fewer are kept
            dt_ms = dt_full / chunk
            # every rank's loop sampled the same tokens; under tp rank 0's stop decides
            _, stop = self._deliver(tokens, on_token, stop_check)
            kept = tokens if stop is None else tokens[:stop + 1]
            for t in kept:
                out.append(t)
                stats.generated_tokens += 1
                stats.token_ms.append(dt_ms)
                stats.infer_ms.append(dt_ms)
            self.pos += len(kept)
            if stop is not None:
                done = True
            else:
                token = tokens[-1]
        return out, stats
