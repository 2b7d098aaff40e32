"""Token sampler: greedy argmax / temperature softmax / top-p nucleus.

Behavior-parity port of the reference Sampler (src/tokenizer.cpp:307-415) including its
xorshift* RNG (src/utils.cpp:79-90) so seeded runs reproduce the reference's sampling
sequence exactly. Runs host-side on the logits vector (the reference samples on the root
CPU; here logits are one small device->host transfer per token). A fused on-device
sampler is a future optimization — EOS detection needs the decoded text host-side anyway
(SURVEY.md §7 hard parts).
"""

from __future__ import annotations

import numpy as np


def _random_u32(state: np.uint64) -> tuple[np.uint64, int]:
    """xorshift* (utils.cpp:79-86)."""
    s = int(state)
    s ^= (s >> 12) & 0xFFFFFFFFFFFFFFFF
    s = (s ^ (s << 25)) & 0xFFFFFFFFFFFFFFFF
    s ^= s >> 27
    out = ((s * 0x2545F4914F6CDD1D) & 0xFFFFFFFFFFFFFFFF) >> 32
    return np.uint64(s), int(out)


def _softmax(x: np.ndarray) -> np.ndarray:
    m = np.max(x)
    e = np.exp(x - m)
    return e / e.sum()


class Sampler:
    def __init__(self, vocab_size: int, temperature: float = 0.0, topp: float = 0.9,
                 seed: int = 0):
        self.vocab_size = vocab_size
        self.temperature = float(temperature)
        self.topp = float(topp)
        self.state = np.uint64(seed)

    def set_temp(self, temperature: float) -> None:
        self.temperature = float(temperature)

    def set_seed(self, seed: int) -> None:
        self.state = np.uint64(seed)

    def next_coin(self) -> float:
        """Draw the coin of the next stochastic sample (one per sample): what a device
        sampler picks with in this Sampler's place."""
        self.state, u = _random_u32(self.state)
        return (u >> 8) / 16777216.0  # randomF32, utils.cpp:88-90

    def fast_forward(self, n_tokens: int) -> None:
        """Advance the xorshift* stream past the coins `n_tokens` already
        sampled tokens consumed — the RNG half of a durable-request resume
        (docs/FLEET.md "Resume protocol"): a replica re-admitting a request
        whose first k generated tokens were delivered elsewhere prefills
        prompt ⊕ those tokens and fast-forwards the sampler by k, so its
        continuation is byte-identical to the uninterrupted run. Every
        stochastic sample() draws EXACTLY one coin (mult and top-p alike);
        greedy (temperature 0) draws none, so this is a no-op there."""
        if self.temperature == 0.0:
            return
        for _ in range(n_tokens):
            self.state, _ = _random_u32(self.state)

    def sample(self, logits: np.ndarray) -> int:
        logits = np.asarray(logits, dtype=np.float32).reshape(-1)[: self.vocab_size]
        if self.temperature == 0.0:
            return int(np.argmax(logits))
        probs = _softmax(logits / self.temperature)
        coin = self.next_coin()
        if self.topp <= 0 or self.topp >= 1:
            return self._sample_mult(probs, coin)
        return self._sample_topp(probs, coin)

    def _sample_mult(self, probs: np.ndarray, coin: float) -> int:
        cdf = np.cumsum(probs)
        idx = int(np.searchsorted(cdf, coin, side="right"))
        return min(idx, self.vocab_size - 1)

    # first argpartition selection width: the topp=0.9 nucleus of a peaked
    # softmax is almost always a handful of tokens, so one O(n) partition
    # beats the old full-survivor O(n log n) sort per token — host sampling
    # now sits directly on the delivery loop the pipelined batched scheduler
    # overlaps with device decode (docs/SERVING.md "Pipelined decode")
    _TOPP_SELECT = 64

    def _sample_topp(self, probs: np.ndarray, coin: float) -> int:
        """Nucleus sampling with the reference's cutoff pre-filter
        (tokenizer.cpp:328-369), the sort taken over an np.argpartition
        top-M selection instead of every pre-filter survivor. M doubles
        until the selected mass covers topp (worst case: the full-sort
        fallback, the exact old path). Bit-identical with _sample_topp_full:
        the selection keeps EVERY survivor >= the partition pivot, so
        boundary ties are all present and the stable (prob desc, index asc)
        sort of the selection is exactly the full sort's prefix — same
        cumsum partials, same crossing index, same pick."""
        n = len(probs)
        cutoff = (1.0 - self.topp) / (n - 1)
        idx = np.nonzero(probs >= cutoff)[0]
        if len(idx) == 0:
            # degenerate params (huge temperature + tiny topp): nothing passes the
            # pre-filter; the reference indexes probindex[-1] (UB) — fall back to mult
            return self._sample_mult(probs, coin)
        p_all = probs[idx]
        m = self._TOPP_SELECT
        while True:
            if m < len(idx):
                part = np.argpartition(-p_all, m - 1)[:m]
                pivot = p_all[part].min()  # the m-th largest survivor prob
                cand = np.nonzero(p_all >= pivot)[0]
                order = idx[cand[np.argsort(-p_all[cand], kind="stable")]]
            else:
                # descending sort by prob over every survivor (stable, like
                # the reference qsort by prob only) — the pre-selection path
                order = idx[np.argsort(-p_all, kind="stable")]
            p = probs[order]
            csum = np.cumsum(p)
            cut = np.nonzero(csum > self.topp)[0]
            if len(cut) == 0 and m < len(idx):
                m *= 2  # selection mass short of topp: widen and retry
                continue
            last = cut[0] if len(cut) else len(p) - 1
            r = coin * csum[last]
            pick = int(np.searchsorted(csum[: last + 1], r, side="right"))
            pick = min(pick, last)
            return int(order[pick])

    def _sample_topp_full(self, probs: np.ndarray, coin: float) -> int:
        """The pre-selection full-survivor-sort nucleus path, kept verbatim
        as the bit-identity oracle for _sample_topp (tests/test_pipeline.py
        asserts new == old over adversarial tie-heavy distributions)."""
        n = len(probs)
        cutoff = (1.0 - self.topp) / (n - 1)
        idx = np.nonzero(probs >= cutoff)[0]
        if len(idx) == 0:
            return self._sample_mult(probs, coin)
        order = idx[np.argsort(-probs[idx], kind="stable")]
        p = probs[order]
        csum = np.cumsum(p)
        cut = np.nonzero(csum > self.topp)[0]
        last = cut[0] if len(cut) else len(p) - 1
        r = coin * csum[last]
        pick = int(np.searchsorted(csum[: last + 1], r, side="right"))
        pick = min(pick, last)
        return int(order[pick])
