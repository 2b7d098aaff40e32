"""PyTorch port on the card: each CUDA kernel against its plain torch version on the same
CUDA tensors, and a tiny engine with kernels against the CPU plain path. Marked `cuda`;
skips where no GPU is present (the kernels have no CPU mode). Run on a GPU machine with
`python -m pytest -q -m cuda tests/test_torch_cuda.py`.

Tolerances, relative to max|reference|: q4_matvec 1e-4 (exact integer block dots, f32
block sum in another order), q4_matmul 1e-3 (identical bf16 operands, tensor-core f32
accumulation order), decode_attention 1e-4 (f32 softmax, split merge order)."""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.models.params import init_random_params
from distributed_llama_tpu_torch.models.spec import ArchType, ModelSpec
from distributed_llama_tpu_torch.ops import decode_attention as da
from distributed_llama_tpu_torch.ops import matmul as matmul_mod
from distributed_llama_tpu_torch.ops import q4_matmul as mm
from distributed_llama_tpu_torch.ops import q4_matvec as mv
from distributed_llama_tpu_torch.quants import FloatType
from distributed_llama_tpu_torch.runtime.engine import Engine


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _planes(n, k, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, generator=g, device=dev)
    scales = (torch.rand((n, k // 32), generator=g, device=dev) * 0.01).to(torch.float16)
    return packed, scales


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(300, 704), (4096, 11008), (32000, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q4_matvec_kernel_matches_plain(cuda, n, k, dtype):
    packed, scales = _planes(n, k, cuda, seed=n)
    x = torch.randn(k, device=cuda).to(dtype)
    before = mv.launches
    got = mv._launch(x, packed, scales)
    torch.cuda.synchronize()
    assert mv.launches == before + 1
    assert _rel_err(got, mv.q4_matvec_plain(x, packed, scales)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(2, 130, 256), (8, 4096, 11008), (64, 12288, 4096),
                                   (70, 96, 704)])
def test_q4_matmul_kernel_matches_plain(cuda, m, n, k):
    packed, scales = _planes(n, k, cuda, seed=m)
    x = torch.randn(m, k, device=cuda)
    got = mm._launch(x, packed, scales)
    torch.cuda.synchronize()
    assert _rel_err(got, mm.q4_matmul_plain(x, packed, scales)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hk,g,hs", [(4, 1, 64), (2, 4, 128), (3, 8, 32)])
@pytest.mark.parametrize("pos,window", [(0, 256), (1, 256), (130, 256), (256, 256),
                                        (700, 1024)])
def test_decode_attention_kernel_matches_plain(cuda, dtype, hk, g, hs, pos, window):
    s = 1024
    kc = torch.randn(2, 1, hk, s, hs, device=cuda).to(dtype)
    vc = torch.randn(2, 1, hk, s, hs, device=cuda).to(dtype)
    kc[:, :, :, pos:] = float("nan")  # never read: slots >= pos
    vc[:, :, :, pos:] = float("nan")
    q = torch.randn(hk, g, hs, device=cuda)
    kn = torch.randn(hk, 1, hs, device=cuda).to(dtype)
    vn = torch.randn(hk, 1, hs, device=cuda).to(dtype)
    got = da._launch(q, kc, vc, kn, vn, 1, pos, window)
    torch.cuda.synchronize()
    want = da.decode_attention_plain(q, kc, vc, kn, vn, 1, pos, window)
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) < 1e-4


def _recording(monkeypatch) -> list:
    """Record the activations every kernel-path matmul receives, as CPU f32 copies."""
    calls = []

    def wrap(name, fn):
        def rec(x, w, **kw):
            calls.append((name, x.detach().float().cpu().reshape(-1, x.shape[-1])))
            return fn(x, w, **kw)
        return rec

    monkeypatch.setattr(matmul_mod, "q4_matvec", wrap("q4_matvec", matmul_mod.q4_matvec))
    monkeypatch.setattr(matmul_mod, "q4_matmul", wrap("q4_matmul", matmul_mod.q4_matmul))
    return calls


def _crossings(calls_g, calls_c) -> int:
    """Activation elements whose Q80 code (matvec rows) or bf16 rounding (matmul rows)
    differs between the two runs: a last-bit difference that crossed a rounding boundary."""
    assert [c[0] for c in calls_g] == [c[0] for c in calls_c]
    n = 0
    for (kind, xg), (_, xc) in zip(calls_g, calls_c):
        if kind == "q4_matvec":
            n += int((mv.quantize_row(xg[0])[0] != mv.quantize_row(xc[0])[0]).sum())
        else:
            n += int((xg.to(torch.bfloat16) != xc.to(torch.bfloat16)).sum())
    return n


@pytest.mark.cuda
def test_engine_kernels_match_cpu_plain(cuda, monkeypatch):
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=256, hidden_dim=512, n_layers=2,
                     n_heads=4, n_kv_heads=2, vocab_size=300, seq_len=512).resolved()
    params = init_random_params(spec, FloatType.Q40, seed=5)
    kw = dict(dtype=torch.float32, use_kernels=True, prefill_kernel=True)
    gpu = Engine(spec, params, device="cuda", **kw)
    cpu = Engine(spec, params, device="cpu", **kw)
    calls = _recording(monkeypatch)

    def run(fn):
        del calls[:]
        return fn(), list(calls)

    prompt = [1] + list(range(3, 80))
    before = (mv.launches, mm.launches, da.launches)
    lg, cg = run(lambda: gpu.prefill(prompt))
    lc, cc = run(lambda: cpu.prefill(prompt))
    crossed = 0
    for step in range(13):
        crossed += _crossings(cg, cc)
        # 2e-3·max|logits| while no activation has crossed a rounding boundary (only
        # the sum order differs); once one has, the caches carry it and each crossing
        # moves the logits by ~1e-3·max at this width: 2e-2·max (card reading before
        # this check: 3.9e-3 at max 1.25, i.e. 3.1e-3·max, ~90 positions in)
        tol = (2e-2 if crossed else 2e-3) * np.abs(lc).max()
        err = np.abs(lg - lc).max()
        assert err < tol, f"step {step}: max|Δlogits| {err:.3e}, {crossed} crossings"
        tg, tc = int(np.argmax(lg)), int(np.argmax(lc))
        assert tg == tc, f"greedy tokens diverge at step {step}"
        lg, cg = run(lambda: gpu.infer_chunk([tg]))
        lc, cc = run(lambda: cpu.infer_chunk([tc]))
    assert all(a > b for a, b in zip((mv.launches, mm.launches, da.launches), before))
