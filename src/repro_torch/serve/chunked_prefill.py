"""Chunked prefill: admission-time prompt processing split into fixed-size
token chunks interleaved with decode steps (a copy of
``repro.serve.chunked_prefill``: the port imports nothing of the JAX
package).

A monolithic bucketed prefill stalls every in-flight decode stream for the
full prompt length; under a latency SLO that stall IS the tail.  Chunking
bounds the per-step prefill work: an admitted group's prompts advance
``chunk_tokens`` positions per processed chunk, and the engine interleaves
chunks with decode steps under a per-step token budget (fixed here, or set
dynamically by ``serve.admission.AdmissionController``).

Requests being chunk-prefilled occupy a first-class lifecycle state,
``PREFILLING``: their slot is reserved (popped from the free list) and
their cache fragment fills chunk by chunk, but NOTHING is written into the
batched slot cache until the final chunk — completion runs the same masked
group-insert (or paged scatter) as monolithic admission.  That makes
mid-``PREFILLING`` preemption trivial: drop the fragment, free the slot,
re-queue — no cache rollback, because the slot row was never written.

The model layers' uniform-fill prefill branch (``layers.gqa_attention``)
is already chunk-shaped — monolithic prefill is the single-chunk case.
Each chunk appends K/V at ``cache.length`` and attends with
``q_offset=start`` / ``kv_len=start+C``; for a query at global position i
the effective mask (causal and fill) is ``kv_pos <= i`` in both the
chunked and the monolithic call, and rows are batch-independent.  Chunk
garbage past a row's true length n (zero-padding tokens) writes K/V only
at positions >= n, which are causally invisible to the row's logits at
n-1 and zeroed by the completion masked insert.  Chunked prefill is
bitwise monolithic prefill, in the reference and in the port on the CPU:
tests/test_torch_chunked_prefill.py asserts the chunk's logits at each
row's last token and every K/V row written equal (``torch.equal``), and
chunked tokens equal monolithic tokens exactly.

Every chunk call has the fixed operand shape ``(batch_bucket,
chunk_tokens)``, so chunking runs at most one shape per batch bucket
(``floor(log2(n_slots)) + 1`` in all).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class ChunkedPrefillConfig:
    """Engine-level chunked-prefill knobs.

    ``chunk_tokens`` is the fixed chunk length C (the chunk call's
    token-axis shape).  ``budget_tokens`` caps the PADDED prefill tokens
    (batch_bucket * C per chunk) processed per engine step; ``None``
    drains every pending chunk each step (chunking then only changes
    the work's shape, not its schedule — the parity-test default).  A
    wired ``AdmissionController`` overrides the budget dynamically.
    Regardless of budget, at least one chunk runs per step whenever any
    group is pending — forward progress is unconditional, so a tiny
    budget can throttle prefill but never livelock it."""

    chunk_tokens: int = 64
    budget_tokens: Optional[int] = None

    def __post_init__(self):
        if self.chunk_tokens < 1:
            raise ValueError(
                f"chunk_tokens must be >= 1, got {self.chunk_tokens}")
        if self.budget_tokens is not None and self.budget_tokens < 1:
            raise ValueError(
                f"budget_tokens must be >= 1 or None, got "
                f"{self.budget_tokens}")


@dataclasses.dataclass
class PrefillGroup:
    """One batch of requests mid-chunked-prefill.

    Rows of the fragment cache align with ``reqs``; ``bb`` is the batch
    bucket (the fragment's batch dim — tail rows past ``len(reqs)``
    are bucketing dummies).  ``progress`` counts tokens prefilled so far,
    uniform across rows (the model's uniform-fill branch requires it).
    Members cancelled mid-flight (deadline, pressure preemption) go into
    ``cancelled``; their rows keep being computed — a chunk's rows are
    batch-independent, so dead-row garbage can't leak — but completion
    skips them."""

    reqs: List[Any]                      # engine.Request, row-aligned
    slots: List[int]                     # reserved slot per row
    lens: List[int]                      # true prompt length per row
    bb: int                              # fragment batch bucket
    frag: Any                            # target fragment cache
    draft_frag: Any = None               # draft fragment cache (spec)
    plans: Dict[int, Any] = dataclasses.field(default_factory=dict)
    progress: int = 0
    t0: float = 0.0                      # admit-start time (telemetry)
    cancelled: set = dataclasses.field(default_factory=set)
    # row -> first-token argmax / non-finite count, stashed by the chunk
    # containing the row's TRUE last prompt token, consumed at completion
    firsts: Dict[int, int] = dataclasses.field(default_factory=dict)
    nf: Dict[int, int] = dataclasses.field(default_factory=dict)

    def live(self) -> List[Any]:
        return [r for r in self.reqs if r.uid not in self.cancelled]

    def live_rows(self) -> List[int]:
        return [i for i, r in enumerate(self.reqs)
                if r.uid not in self.cancelled]

    def cancel(self, uid: int) -> None:
        self.cancelled.add(uid)

    @property
    def target_len(self) -> int:
        """Tokens the group must prefill: the longest LIVE prompt (a
        cancelled long row no longer forces extra chunks)."""
        return max((self.lens[i] for i in self.live_rows()), default=0)

    @property
    def done(self) -> bool:
        return self.progress >= self.target_len

    def chunks_remaining(self, chunk_tokens: int) -> int:
        rem = self.target_len - self.progress
        return max(0, -(-rem // chunk_tokens))
