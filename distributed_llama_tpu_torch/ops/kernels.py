"""Elementwise / normalization ops (reference: src/funcs.{hpp,cpp}).

rmsnorm (funcs.cpp rms+rmsnorm, eps=1e-5, reduction in f32), masked softmax, SiLU and
tanh-GELU (funcs.cpp:498-517), each a plain torch expression computed in float32 and
cast back to the input's dtype, as the JAX package's ops/kernels.py does.
"""

import torch

RMS_EPS = 1e-5  # reference: funcs.cpp rms() `ss += 1e-5f`


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = RMS_EPS) -> torch.Tensor:
    """RMS-normalize the last axis; reduction in f32 regardless of activation dtype."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    inv = torch.reciprocal(torch.sqrt(ms + eps))
    return (weight.float() * (xf * inv)).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) (reference: funcs.cpp:510-517)."""
    xf = x.float()
    return (xf / (1.0 + torch.exp(-xf))).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximation GELU, coefficients as in reference funcs.cpp:498-508."""
    xf = x.float()
    c = 0.79788456080286535587989211986876  # sqrt(2/pi)
    out = 0.5 * xf * (1.0 + torch.tanh(c * xf * (1.0 + 0.044715 * xf * xf)))
    return out.to(x.dtype)


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Numerically-stable softmax over the last axis with a boolean validity mask.

    Invalid lanes are driven to the f32 minimum before the max, so fully-masked rows
    produce zeros (not NaN).
    """
    neg = torch.finfo(torch.float32).min
    # a fill on the device, not a host copy: a captured step (a verify block) runs it
    s = torch.where(mask, scores.float(), scores.new_full((), neg, dtype=torch.float32))
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    e = torch.where(mask, e, torch.zeros((), device=e.device))
    denom = torch.sum(e, dim=-1, keepdim=True)
    return e / torch.clamp(denom, min=1e-30)
