"""PyTorch port: the tp collectives (distributed_llama_tpu_torch/parallel/collectives.py)
over gloo worlds of 2 and 4 CPU ranks (parallel/launch.py, a file:// rendezvous under
tmp_path), against the JAX package's psum, quantized_psum and quantized_psum_gather under
shard_map on the same per-rank partials.

Bounds: the uncompressed all-reduce within f32 summation order of JAX's psum (|Δ| <=
n·2^-23·Σ|x_i| elementwise); the Q80 wire's phase-1 codes (the quantized partials)
identical to jnp_quantize_q80's, and the compressed results equal to JAX's bit for bit
(both sum the dequantized partials, exact products of an int8 and an f16 scale, in rank
order, and re-quantize the same f32 sums); every rank's result identical; the counted
wire bytes of each call the ring formula of parallel/hlo_stats.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from distributed_llama_tpu.compat import shard_map
from distributed_llama_tpu.parallel import collectives as jcoll
from distributed_llama_tpu.quants import jnp_quantize_q80
from distributed_llama_tpu_torch.parallel import collectives, launch
from distributed_llama_tpu_torch.parallel.mesh import Mesh, make_mesh
from distributed_llama_tpu_torch.parallel.traffic import (CollectiveTraffic,
                                                          TrafficCounter, publish_traffic)

# (name, per-rank shape): whole chunks for tp 2 and 4, a block count (3) neither divides
# (the single-phase fallback), and several rows
SHAPES = (("decode_row", (1, 1, 256)), ("odd_blocks", (2, 3, 96)),
          ("prefill_rows", (1, 5, 128)), ("wide_row", (1, 1, 4096)))
WORLDS = (2, 4)


def _partials(n: int, shape, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    x = rng.randn(n, *shape).astype(np.float32)
    x[:, ..., :32] *= 40.0  # blocks of very different scales
    x[0, ..., 32:64] = 0.0  # an all-zero block on one rank (scale 0)
    return x


def _jax_reduce(fn, partials: np.ndarray) -> np.ndarray:
    """fn(local, "tp") on each of n virtual CPU devices, device d holding partials[d]."""
    n = partials.shape[0]
    mesh = JMesh(np.array(jax.devices()[:n]), ("tp",))
    f = shard_map(lambda x: fn(x[0], "tp")[None], mesh=mesh, in_specs=P("tp"),
                  out_specs=P("tp"), check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(partials)))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case on worlds of 2 and 4 ranks, one launch per world."""
    out = {}
    for n in WORLDS:
        tmp = tmp_path_factory.mktemp(f"coll{n}")
        cases = [{"name": name, "partials": _partials(n, shape, seed=10 * n + i)}
                 for i, (name, shape) in enumerate(SHAPES)]
        torch.save(cases, tmp / "cases.pt")
        rows = launch.run("torch_tp_ranks:collective_cases", n, "cpu",
                          args=(str(tmp / "cases.pt"),), workdir=str(tmp), deadline=120)
        out[n] = (cases, rows)
    return out


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", range(len(SHAPES)), ids=[s[0] for s in SHAPES])
def test_psum_matches_jax_within_f32_order(worlds, n, case):
    cases, rows = worlds[n]
    partials = cases[case]["partials"]
    want = _jax_reduce(jax.lax.psum, partials)
    bound = n * 2.0 ** -23 * np.abs(partials).sum(axis=0)
    for r in range(n):
        got = rows[r][case]["psum"]
        assert got.dtype == np.float32 and got.shape == partials.shape[1:]
        assert np.all(np.abs(got - want[r]) <= bound)
        np.testing.assert_array_equal(got, rows[0][case]["psum"])  # ranks agree


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", range(len(SHAPES)), ids=[s[0] for s in SHAPES])
def test_quantized_psum_bit_identical_to_jax(worlds, n, case):
    cases, rows = worlds[n]
    partials = cases[case]["partials"]
    want = _jax_reduce(jcoll.quantized_psum, partials)
    want_gather = _jax_reduce(jcoll.quantized_psum_gather, partials)
    for r in range(n):
        np.testing.assert_array_equal(rows[r][case]["quantized_psum"], want[r])
        np.testing.assert_array_equal(rows[r][case]["quantized_psum_gather"],
                                      want_gather[r])
    # the wire's error budget: within a Q80 step or two of the exact sum
    exact = partials.astype(np.float64).sum(axis=0)
    step = np.abs(partials).max() / 127.0 * n
    assert np.abs(rows[0][case]["quantized_psum"] - exact).max() <= 2 * step


@pytest.mark.parametrize("n", WORLDS)
def test_phase_one_codes_identical_to_jnp_quantize_q80(worlds, n):
    cases, _ = worlds[n]
    for case in cases:
        for part in case["partials"]:
            vals, scales = collectives.wire_quantize(torch.from_numpy(part))
            jv, js = jnp_quantize_q80(jnp.asarray(part))
            np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
            np.testing.assert_array_equal(scales.numpy().view(np.uint16),
                                          np.asarray(js).view(np.uint16))


@pytest.mark.parametrize("n", WORLDS)
def test_counted_bytes_are_the_ring_formula(worlds, n):
    cases, rows = worlds[n]
    for i, case in enumerate(cases):
        elems = case["partials"][0].size
        nb = case["partials"].shape[-1] // 32
        for r in range(n):
            row = rows[r][i]
            sent, payload, counts = row["psum_traffic"]
            assert counts == {"all-reduce": 1} and payload == 4 * elems
            assert sent == pytest.approx(2 * (n - 1) / n * 4 * elems, rel=1e-12)
            sent, payload, counts = row["quantized_psum_traffic"]
            wire = elems * 34 // 32
            if nb % n == 0:
                assert counts == {"all-to-all": 1, "all-gather": 1}
                assert payload == 2 * wire
                assert sent == pytest.approx(2 * (n - 1) / n * wire, rel=1e-12)
            else:  # the single-phase fallback
                assert counts == {"all-gather": 1} and payload == n * wire
                assert sent == pytest.approx((n - 1) * wire, rel=1e-12)
            sent, payload, counts = row["quantized_psum_gather_traffic"]
            assert counts == {"all-gather": 1} and payload == n * wire
            assert sent == pytest.approx((n - 1) * wire, rel=1e-12)


def test_one_member_group_returns_x_and_counts_nothing():
    """A one-member tp axis reduces nothing (the JAX package's quantized_psum returns x
    there too) and needs no process group."""
    mesh = make_mesh(tp=1, device="cpu")
    assert mesh.group is None and mesh.tp == 1
    x = torch.randn(2, 64)
    for fn in (lambda t: collectives.psum(t, mesh), lambda t: collectives.psum(t, mesh, True),
               lambda t: collectives.quantized_psum_gather(t, mesh),
               lambda t: collectives.all_gather_last(t, mesh)):
        assert fn(x) is x
    assert collectives.broadcast_int(5, mesh) == 5
    assert mesh.counter.total.counts == {}


def test_traffic_counter_windows_and_gauges():
    """The counter's windows, and its gauges under the JAX package's names and types:
    both packages publish one program's traffic, and each registry holds the same three
    families."""
    from distributed_llama_tpu.obs import metrics as jmetrics
    from distributed_llama_tpu.parallel import hlo_stats
    from distributed_llama_tpu_torch.obs import metrics

    counter = TrafficCounter()
    with counter.window() as outer:
        counter.record("all-reduce", 1000, 4)
        with counter.window() as inner:
            counter.record("all-gather", 400, 4)
    counter.record("broadcast", 8, 4)
    assert outer.counts == {"all-reduce": 1, "all-gather": 1}
    assert inner.counts == {"all-gather": 1} and inner.sent_bytes_per_device == 300.0
    assert outer.sent_bytes_per_device == 1500.0 + 300.0
    assert counter.total.total_payload_bytes == 1408
    assert CollectiveTraffic().sent_bytes_per_device == 0.0
    publish_traffic(outer, "unit_test_program")
    hlo_stats.publish_traffic(hlo_stats.CollectiveTraffic(
        dict(outer.counts), dict(outer.payload_bytes), outer.sent_bytes_per_device),
        "unit_test_program")
    snaps = metrics.snapshot(), jmetrics.snapshot()
    names = ("collective_sent_bytes_per_device", "collective_payload_bytes",
             "collective_count")
    for name in names:
        mine, theirs = ({k: v for k, v in snap[name].items() if "unit_test_program" in k}
                        for snap in snaps)
        assert mine and mine == theirs, name
        assert (type(metrics.REGISTRY._metrics[name]).__name__
                == type(jmetrics.REGISTRY._metrics[name]).__name__ == "Gauge")
    assert any("unit_test_program" in k for k in snaps[0][names[0]])


def test_mesh_refuses_sp_dp_and_needs_a_group():
    with pytest.raises(ValueError, match="Queue A item 2"):
        make_mesh(tp=1, sp=2, device="cpu")
    with pytest.raises(ValueError, match="Queue A item 1"):
        make_mesh(tp=1, dp=2, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(tp=2, device="cpu")
    m = Mesh(rank=1, shape={"dp": 1, "sp": 1, "tp": 4}, group=None,
             device=torch.device("cpu"))
    assert m.tp == 4 and m.counter.total.counts == {}
