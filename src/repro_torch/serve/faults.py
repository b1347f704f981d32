"""Seeded, deterministic fault injection for the serving engine (port of
``repro.serve.faults``: ``FaultInjector`` is the reference's numpy plan,
value for value; ``nonfinite_rows`` is torch).

A robustness claim is only testable if the faults are reproducible: a
``FaultInjector`` derives its entire fault plan from one seed at
construction time, so the same seed plus the same workload replays the
same outcomes bit-for-bit (asserted in tests/test_torch_lifecycle.py).
Four fault families, mirroring what low-bit serving actually meets in
production:

  * **non-finite logits** — NaN/Inf injected into the decode (or
    speculative-verify) logits of one occupied slot at a planned engine
    step.  Injection is an ``(n_slots,)`` vector ADDED to the logits on
    the device before the argmax and the guard, so the engine's
    ``guards`` finite check sees injected faults exactly as it would see
    a genuine 2-bit-layer blowup.
  * **cache pressure** — windows of engine steps during which the
    effective slot-cache limit drops below ``max_len``, forcing the
    engine's preemption (or opt-in truncation) path.
  * **transient step failures** — planned ``step()`` calls raise a
    transient ``EngineFault`` BEFORE any state mutation (so a retry is
    idempotent); each planned step fails a bounded number of consecutive
    attempts and then succeeds, which is what a bounded-retry driver
    must survive.
  * **bursty arrivals** — a Poisson arrival process with periodic bursts
    layered on top, consumed by the load driver (``serve.replay``) to
    exercise admission backpressure and deadline abandonment.

``nonfinite_rows`` is the numeric guard itself: one ``isfinite``
reduction over the trailing axes on the logits' own device, returning a
per-slot non-finite count the engine brings to the host in the same
transfer as the sampled tokens — a non-finite row quarantines only the
offending request while the rest of the batch proceeds.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def nonfinite_rows(logits: torch.Tensor) -> torch.Tensor:
    """Per-slot count of non-finite logit entries, reduced over every
    axis but the batch, on the logits' device.  Shape (B,) int32; a zero
    row is clean, a positive row quarantines its request."""
    return (~torch.isfinite(logits)).reshape(logits.shape[0], -1).sum(
        dim=1, dtype=torch.int32)


class FaultInjector:
    """One seed -> one immutable fault plan (see module docstring).

    ``horizon`` bounds the engine-step indices faults are planned at; the
    plan is fixed at construction, so two injectors with equal arguments
    behave identically.  The only mutable state is the per-step attempt
    counter behind ``should_fail_step`` (bounded consecutive failures);
    ``reset()`` rewinds it for an exact replay.
    """

    def __init__(self, seed: int = 0, horizon: int = 64,
                 nan_faults: int = 1, inf_faults: int = 1,
                 pressure_windows: int = 1,
                 pressure_len: Tuple[int, int] = (3, 8),
                 pressure_frac: Tuple[float, float] = (0.25, 0.5),
                 transient_failures: int = 2,
                 max_consecutive_failures: int = 2,
                 arrival_lambda: float = 0.6,
                 burst_every: int = 12, burst_size: int = 3):
        if horizon < 8:
            raise ValueError(f"horizon must be >= 8, got {horizon}")
        self.seed = seed
        self.horizon = horizon
        rng = np.random.default_rng(seed)
        span = np.arange(2, horizon)

        # non-finite logit injections: step -> [(slot_hint, kind)]
        kinds = ["nan"] * nan_faults + ["inf"] * inf_faults
        steps = rng.choice(span, size=min(len(kinds), len(span)),
                           replace=False)
        self.logit_faults: Dict[int, List[Tuple[int, str]]] = {}
        for step, kind in zip(steps, kinds):
            self.logit_faults.setdefault(int(step), []).append(
                (int(rng.integers(0, 1 << 16)), kind))

        # cache-pressure windows: (start, end, frac of max_len)
        self.pressure_spans: List[Tuple[int, int, float]] = []
        for _ in range(pressure_windows):
            start = int(rng.integers(4, max(5, horizon - 8)))
            length = int(rng.integers(pressure_len[0], pressure_len[1] + 1))
            frac = float(rng.uniform(*pressure_frac))
            self.pressure_spans.append((start, start + length, frac))

        # transient step failures: step -> consecutive attempts that fail
        fsteps = rng.choice(span, size=min(transient_failures, len(span)),
                            replace=False)
        self.fail_steps: Dict[int, int] = {
            int(s): int(rng.integers(1, max_consecutive_failures + 1))
            for s in fsteps}

        # bursty Poisson arrivals per driver step
        counts = rng.poisson(arrival_lambda, size=horizon)
        if burst_every > 0:
            for s in range(0, horizon, burst_every):
                counts[s] += burst_size
        self.arrival_counts: Dict[int, int] = {
            i: int(c) for i, c in enumerate(counts) if c > 0}

        self._fail_attempts: Dict[int, int] = {}

    # ------------------------------------------------------------- consumers
    def should_fail_step(self, step: int) -> bool:
        """True while engine step ``step`` has planned failures left; each
        call consumes one attempt, so a bounded retry eventually passes
        (transient by construction)."""
        planned = self.fail_steps.get(step, 0)
        if planned == 0:
            return False
        seen = self._fail_attempts.get(step, 0)
        self._fail_attempts[step] = seen + 1
        return seen < planned

    def inject_vector(self, step: int, n_slots: int,
                      occupied: Sequence[int] = ()) -> np.ndarray:
        """(n_slots,) f32 additive fault vector for this step's logits:
        zeros normally; NaN/Inf at one OCCUPIED slot per planned fault
        (the hint picks deterministically among occupied slots, so a
        planned fault always lands on a live request when one exists)."""
        vec = np.zeros((n_slots,), np.float32)
        for hint, kind in self.logit_faults.get(step, ()):
            if not occupied:
                continue
            slot = occupied[hint % len(occupied)]
            vec[slot] = np.nan if kind == "nan" else np.inf
        return vec

    def pressure(self, step: int, max_len: int) -> Optional[int]:
        """Effective slot-cache limit at this step (< max_len inside a
        pressure window), or None when no window is active."""
        for start, end, frac in self.pressure_spans:
            if start <= step < end:
                return max(2, int(frac * max_len))
        return None

    def arrivals(self, step: int) -> int:
        """Requests the load driver should submit at this driver step."""
        return self.arrival_counts.get(step, 0)

    def reset(self) -> None:
        """Rewind the transient-failure attempt counters for replay."""
        self._fail_attempts = {}

    def describe(self) -> dict:
        """JSON-able plan summary for diagnostics / bench output."""
        return {
            "seed": self.seed,
            "horizon": self.horizon,
            "logit_faults": {
                str(s): [k for _, k in v]
                for s, v in sorted(self.logit_faults.items())},
            "pressure_spans": [
                {"start": s, "end": e, "frac": round(f, 3)}
                for s, e, f in self.pressure_spans],
            "fail_steps": {str(s): n
                           for s, n in sorted(self.fail_steps.items())},
            "total_arrivals": sum(self.arrival_counts.values()),
        }
