"""Self-speculative decoding (port of ``repro.serve.speculative``): a
low-bit CLAQ draft proposes, the high-bit target verifies — lossless for
greedy decoding, from ONE checkpoint and ONE calibration pass
(``launch.quantize.claq_quantize_with_draft``).

Window protocol (γ = SpecConfig.gamma, one engine step):

  propose   γ+1 draft decode steps — feed last_token, then each proposed
            token; the last one is write-only, so both caches end the
            window at fill+γ+1 and one rollback length serves both.
  verify    ONE target span decode over [last_token, d_1..d_γ]
            (``models.api.decode_span``).
  accept    per slot: the longest prefix with d_i == g_i (g = the
            target's greedy tokens from the verify logits), then the
            target's g_{k+1} — between 1 and γ+1 tokens per window.
  rollback  both caches rewind to fill + accepted (``engine
            ._rollback_tail``: K/V tail zeroed in place, fill counter
            rewound); paged caches rewind by their fill counter alone.

Every phase has a fixed shape — (n_slots,) draft steps, (n_slots, γ+1)
verify, whole-cache rollback — so the number of distinct shapes a run
uses does not grow with the number of windows.

On the card the verify's matmuls run at M = n_slots·(γ+1) and successive
decodes at M = n_slots, which K1's launch plan may sum in another order:
the target's greedy token can then differ from vanilla decode's where its
two best logits are within that rounding (a near tie).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from repro_torch.models import api as model_api


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculation knobs: window length and the draft's code bit-width
    (the latter consumed by the quantization side — see
    `launch.quantize.claq_quantize_with_draft` / `core.draft_config`)."""
    gamma: int = 4
    draft_bits: int = 2

    def __post_init__(self):
        if self.gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {self.gamma}")
        if self.draft_bits < 1:
            raise ValueError(
                f"draft_bits must be >= 1, got {self.draft_bits}")


def validate_spec_support(cfg) -> None:
    """Reject configs that cannot serve as a speculation target (the
    models layer's ``validate_span_support``, shared with the
    ``decode_span`` primitive)."""
    model_api.validate_span_support(cfg)


def accept_greedy(draft: Sequence[int],
                  target: Sequence[int]) -> Tuple[int, List[int]]:
    """Greedy acceptance for one slot.

    ``draft``: the γ proposed tokens d_1..d_γ.  ``target``: the γ+1
    target-greedy tokens from the verify logits (g_i = argmax after the
    history ending in d_i; g_0 after last_token).  Returns
    ``(n_accepted, emitted)`` where emitted = the accepted prefix plus the
    target's correction/bonus token — each emitted token is exactly what
    vanilla greedy decode would have produced (lossless)."""
    gamma = len(draft)
    if len(target) != gamma + 1:
        raise ValueError(
            f"verify returned {len(target)} tokens for gamma={gamma}")
    k = 0
    while k < gamma and int(draft[k]) == int(target[k]):
        k += 1
    return k, [int(t) for t in draft[:k]] + [int(target[k])]


def window_summary(gamma: int, accepted: Sequence[int]) -> dict:
    """Aggregate one speculation window's per-slot acceptance counts:
    proposed/accepted totals, the window's acceptance rate, and the
    full-window count (slots that kept all γ draft tokens)."""
    acc = [int(k) for k in accepted]
    proposed = gamma * len(acc)
    return {
        "gamma": gamma,
        "slots": len(acc),
        "proposed": proposed,
        "accepted": sum(acc),
        "accept_rate": (sum(acc) / proposed) if proposed else 0.0,
        "full_windows": sum(1 for k in acc if k == gamma),
    }
