"""Paged (out-of-core) KV cache: a host/disc-resident history and a device hot ring.

The port's copy of the JAX package's runtime/paged_cache.py, the counterpart of the
reference's `--kv-cache-storage disc` (src/transformer.cpp:312-318, src/utils.cpp:50-67:
the KV cache mmap'd to a file pair so contexts larger than RAM still run). The card
attends only keys in its own memory, so the capacity valve is built the flash-attention
way:

- The device cache keeps a RING of the R most recent positions (slot = position mod R):
  decode's hot window stays in HBM.
- Every committed row is also appended to an authoritative HOST store (RAM for "host",
  an np.memmap'd file pair for "disc": cache/block_pool.py `HostKVArena`).
- Attention over the cold history [0, pos - R) is computed ON THE HOST per layer, in
  float32 torch on CPU tensors, and merged with the card's hot partial by the segment
  identity (ops/attention.py `merge_attention_partials`): exact, not an approximation.

The engine calls forward(paged_cold=store.cold_attend) eagerly (runtime/engine.py): a
host round trip per layer cannot live inside a CUDA graph, so this module makes no
jitted step.

Cost model: each decoded token reads the whole cold history from host memory — bytes =
L * 2 * hk * (pos - R) * hs * itemsize — plus L host<->device round trips per step. A
capacity valve for a context whose KV does not fit the card, not a fast path.
`paged_cold_bytes_total` counts the bytes read from the store in its own dtype (the JAX
package counts its float32 copy: the same for an f32 engine, twice the port's for bf16).
"""

from __future__ import annotations

import math

import torch

from ..models.forward import init_kv_cache
from ..models.spec import ModelSpec
from ..obs import metrics, trace
from ..resilience import faults

_RESIDENT = metrics.gauge(
    "paged_resident_positions", "HBM hot-ring slots (--kv-cache-resident)")
_STORE_BYTES = metrics.gauge(
    "paged_store_bytes", "Authoritative host/disc KV store allocation")
_APPENDED = metrics.counter(
    "paged_appended_rows_total", "Positions committed to the host store")
_SPILL_BYTES = metrics.counter(
    "paged_spill_bytes_total", "Bytes written to the disc-backed store (mmap)")
_COLD_CALLS = metrics.counter(
    "paged_cold_attend_calls_total", "Host cold-attention callbacks served")
_COLD_BYTES = metrics.counter(
    "paged_cold_bytes_total", "Cold K/V bytes read from the host store")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class HostKVStore:
    """Authoritative full-context KV store in host RAM ("host") or over an np.memmap'd
    file pair ("disc"), layout (L, B, hk, S, hs) as the device caches, rows CPU tensors
    in the engine dtype. Storage (allocation, memmap files, the owned temp dir's
    cleanup) is cache/block_pool.py `HostKVArena`; this class keeps the append
    discipline and the per-layer cold attention."""

    def __init__(self, spec: ModelSpec, resident: int, *, batch: int = 1,
                 storage: str = "host", directory: str | None = None,
                 dtype: torch.dtype = torch.float32):
        from ..cache.block_pool import HostKVArena

        self.spec = spec
        self.resident = resident
        self.storage = storage
        shape = (spec.n_layers, batch, spec.n_kv_heads, spec.seq_len, spec.head_size)
        self._arena = HostKVArena(shape, dtype, storage=storage, directory=directory)
        _RESIDENT.set(resident)
        _STORE_BYTES.set(self.nbytes())

    # the storage facade: live views of the arena
    @property
    def k(self) -> torch.Tensor:
        return self._arena.k

    @property
    def v(self) -> torch.Tensor:
        return self._arena.v

    @property
    def paths(self):
        return self._arena.paths

    @property
    def _owned_dir(self):
        return self._arena._owned_dir

    def cleanup(self) -> None:
        """Delete the cache file pair and its directory IF the arena created the
        directory itself (a fresh temp dir). Idempotent."""
        self._arena.cleanup()

    def nbytes(self) -> int:
        return self._arena.nbytes()

    def append(self, k_rows: torch.Tensor, v_rows: torch.Tensor, pos: int) -> None:
        """Write the step's new rows (L, B, hk, T, hs), on any device, at positions
        [pos, pos + T). From the card this is the device->host copy, queued behind the
        step that produced the rows."""
        faults.fire("paged.append", pos=pos)
        t = k_rows.shape[3]
        self.k[:, :, :, pos:pos + t].copy_(k_rows)
        self.v[:, :, :, pos:pos + t].copy_(v_rows)
        _APPENDED.inc(t)
        if self.storage == "disc":
            _SPILL_BYTES.inc(_nbytes(k_rows) + _nbytes(v_rows))

    def cold_attend(self, layer: int, q: torch.Tensor, start_pos
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The host's attention partial over the cold history [0, start_pos - R).

        q: (B, T, hq, hs) float32 on any device. Returns CPU tensors (normalized out
        (B, T, hq, hs) f32, lse (B, T, hq) f32); an empty cold segment returns lse -inf
        (zero weight under the merge). Every cold position precedes every query
        position, so no causal mask is needed."""
        faults.fire("paged.cold_attend", layer=layer)
        b, t, hq, hs = q.shape
        cold = max(0, int(start_pos) - self.resident)
        if cold <= 0:
            return (torch.zeros((b, t, hq, hs), dtype=torch.float32),
                    torch.full((b, t, hq), -torch.inf, dtype=torch.float32))
        # the copy off the card waits for the layer's projections: outside the span,
        # which times the host's own work, as the JAX callback's span does
        q = q.detach().to("cpu", torch.float32)
        with trace.span("paged.cold_attend", {"layer": layer, "cold": cold}):
            return self._cold_attend_traced(layer, q, cold)

    def _cold_attend_traced(self, layer: int, q: torch.Tensor, cold: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        b, t, hq, hs = q.shape
        hk = self.k.shape[2]
        g = hq // hk
        k_src = self.k[layer, :, :, :cold]  # (B, hk, C, hs)
        v_src = self.v[layer, :, :, :cold]
        _COLD_CALLS.inc()
        _COLD_BYTES.inc(_nbytes(k_src) + _nbytes(v_src))
        kc, vc = k_src.float(), v_src.float()
        qg = q.reshape(b, t, hk, g, hs) * (1.0 / math.sqrt(hs))
        scores = torch.einsum("btkgd,bkcd->btkgc", qg, kc)  # (B, T, hk, g, C)
        m = scores.amax(dim=-1)
        e = torch.exp(scores - m[..., None])
        denom = e.sum(dim=-1)
        out = torch.einsum("btkgc,bkcd->btkgd", e, vc) / denom[..., None]
        lse = m + torch.log(denom)
        return out.reshape(b, t, hq, hs), lse.reshape(b, t, hq)


def init_ring_cache(spec: ModelSpec, resident: int, *, batch: int = 1,
                    dtype: torch.dtype = torch.float32, device="cpu"):
    """The device hot-ring caches (L, B, hk, R, hs): the seq axis sized to the resident
    window instead of seq_len."""
    return init_kv_cache(spec, batch, dtype=dtype, device=device, seq_len=resident)
