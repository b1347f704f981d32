"""Request lifecycle for the serving engine: an explicit state machine,
typed serving errors, and a bounded admission queue with deadlines.

A production serving claim needs a failure model, not just a fast path.
This module gives every request an explicit lifecycle,

    QUEUED -> RUNNING -> {FINISHED, TRUNCATED, ABANDONED, FAILED, PREEMPTED}
    QUEUED -> PREFILLING -> RUNNING   (chunked prefill: slot reserved, cache
    PREFILLING -> {PREEMPTED, ...}     filling chunk by chunk)
    PREEMPTED -> QUEUED            (preempted work re-queues and resumes)

with transitions enforced (an illegal transition is a bug and raises
``ValueError``), and splits the error surface in two:

  * **bug class** — misuse and engine defects keep raising bare
    ``ValueError`` (constructor misconfiguration, illegal transitions);
  * **serving class** — expected runtime outcomes raise typed
    ``ServeError`` subclasses so callers can distinguish backpressure
    from bugs: ``AdmissionRejected`` (queue full / request cannot fit),
    ``DeadlineExceeded`` (SLO already blown at submission),
    ``EngineFault`` (a step failed; ``transient`` marks retryable
    faults), ``IncompleteRun`` (``run_to_completion`` exhausted its step
    budget — carries the partial outputs and lifecycle states of every
    unfinished request, so callers never lose already-generated work).

``ServeError`` derives from ``RuntimeError`` (and ``AdmissionRejected``
additionally from ``ValueError``) so pre-lifecycle callers that caught
the bare builtins keep working.

``AdmissionQueue`` is the backpressure point: a bounded FIFO with
priority-aware pop (highest priority first, FIFO within a priority) and
deadline expiry.  Preempted requests re-enter at the FRONT and are exempt
from the bound — preemption frees a slot, so re-queueing can never grow
the system's total admitted work.

Deadlines are absolute timestamps from an injectable ``clock`` (defaults
to ``time.monotonic``); ``StepClock`` is a deterministic virtual clock
for tests and the fault-injection bench, advanced explicitly by the
driver so abandonment outcomes replay bit-identically.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Dict, List, Optional


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    RUNNING = "running"
    FINISHED = "finished"
    TRUNCATED = "truncated"
    ABANDONED = "abandoned"
    FAILED = "failed"
    PREEMPTED = "preempted"


TERMINAL_STATES = frozenset({
    RequestState.FINISHED, RequestState.TRUNCATED,
    RequestState.ABANDONED, RequestState.FAILED,
})

# Legal lifecycle transitions; anything else is an engine bug.
_TRANSITIONS: Dict[RequestState, frozenset] = {
    RequestState.QUEUED: frozenset({
        RequestState.RUNNING, RequestState.PREFILLING,
        RequestState.ABANDONED, RequestState.FAILED}),
    RequestState.PREFILLING: frozenset({
        RequestState.RUNNING, RequestState.PREEMPTED,
        RequestState.TRUNCATED,
        RequestState.ABANDONED, RequestState.FAILED}),
    RequestState.RUNNING: frozenset({
        RequestState.FINISHED, RequestState.TRUNCATED,
        RequestState.ABANDONED, RequestState.FAILED,
        RequestState.PREEMPTED}),
    RequestState.PREEMPTED: frozenset({RequestState.QUEUED}),
    RequestState.FINISHED: frozenset(),
    RequestState.TRUNCATED: frozenset(),
    RequestState.ABANDONED: frozenset(),
    RequestState.FAILED: frozenset(),
}


def transition(obj, new_state: RequestState) -> None:
    """Advance ``obj.state`` to ``new_state``, enforcing the machine.
    Illegal transitions are bugs (``ValueError``), not serving outcomes."""
    cur = obj.state
    if new_state not in _TRANSITIONS[cur]:
        raise ValueError(
            f"illegal lifecycle transition {cur.name} -> {new_state.name} "
            f"for request {getattr(obj, 'uid', '?')}")
    obj.state = new_state


# --------------------------------------------------------------------- errors

class ServeError(RuntimeError):
    """Base of the serving-outcome error class (vs. bug-class ValueError)."""


class AdmissionRejected(ServeError, ValueError):
    """Backpressure / will-never-fit: the queue is full, the engine lacks
    free slots for a direct admission, or the request cannot fit its slot
    cache.  Also a ``ValueError`` for pre-lifecycle callers."""


class DeadlineExceeded(ServeError):
    """The request's SLO deadline is already in the past at submission."""


class EngineFault(ServeError):
    """A step-level failure.  ``transient=True`` marks faults a driver may
    retry (bounded, with backoff — see ``RetryPolicy``); ``diagnostics``
    carries structured context (fault kind, engine step)."""

    def __init__(self, message: str, transient: bool = False,
                 diagnostics: Optional[dict] = None):
        super().__init__(message)
        self.transient = transient
        self.diagnostics = diagnostics or {}


class IncompleteRun(ServeError):
    """``run_to_completion`` exhausted ``max_steps`` with work in flight.
    Unlike a bare error, the partial outputs survive: ``partial`` maps
    uid -> tokens generated so far, ``states`` maps uid -> RequestState."""

    def __init__(self, message: str, partial: Dict[int, List[int]],
                 states: Dict[int, RequestState]):
        super().__init__(message)
        self.partial = partial
        self.states = states


# ---------------------------------------------------------------- retry/clock

@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff for transient EngineFaults
    at the step() driver level.  ``sleep`` is injectable so tests and the
    deterministic bench never wall-sleep."""
    max_attempts: int = 3
    backoff_s: float = 0.05
    multiplier: float = 2.0
    sleep: Callable[[float], None] = time.sleep

    def run(self, fn):
        """Call ``fn`` retrying transient EngineFaults; returns
        ``(result, retries_used)``.  Non-transient faults and exhausted
        budgets re-raise."""
        delay = self.backoff_s
        for attempt in range(self.max_attempts):
            try:
                return fn(), attempt
            except EngineFault as e:
                if not e.transient or attempt + 1 >= self.max_attempts:
                    raise
                if delay > 0:
                    self.sleep(delay)
                delay *= self.multiplier
        raise AssertionError("unreachable")


class StepClock:
    """Deterministic virtual clock: the driver advances it explicitly, so
    deadline abandonment replays bit-identically under a seeded fault
    plan (a wall clock would make outcomes load-dependent)."""

    def __init__(self, step_ms: float = 10.0):
        self.step_ms = step_ms
        self._t = 0.0

    def __call__(self) -> float:
        return self._t

    def advance(self, ms: Optional[float] = None) -> None:
        self._t += (self.step_ms if ms is None else ms) / 1e3


# -------------------------------------------------------------------- queue

class AdmissionQueue:
    """Bounded admission queue with priority-aware pop and deadline expiry.

    ``push`` raises ``AdmissionRejected`` at the bound (the backpressure
    signal); ``push_front`` re-queues preempted work ahead of everything
    at its priority and is exempt from the bound (preemption freed a slot,
    so total admitted work never grows).  Pop order: highest priority
    first, FIFO within a priority, preempted-first within both.
    """

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self.depth = depth
        self.peak_depth = 0               # high-water mark (telemetry)
        self._items: List[tuple] = []     # (order, request)
        self._next_order = 0
        self._front_order = -1

    def __len__(self) -> int:
        return len(self._items)

    def uids(self) -> List[int]:
        return [r.uid for _, r in self._ranked()]

    def requests(self) -> List:
        return [r for _, r in self._ranked()]

    def _ranked(self) -> List[tuple]:
        return sorted(self._items, key=lambda it: (-it[1].priority, it[0]))

    def push(self, req) -> None:
        if len(self._items) >= self.depth:
            raise AdmissionRejected(
                f"admission queue full ({self.depth} deep): request "
                f"rejected — backpressure, retry later or raise queue_depth")
        self._items.append((self._next_order, req))
        self._next_order += 1
        self.peak_depth = max(self.peak_depth, len(self._items))

    def push_front(self, req) -> None:
        self._items.append((self._front_order, req))
        self._front_order -= 1
        self.peak_depth = max(self.peak_depth, len(self._items))

    def expire(self, now: float) -> List:
        """Remove and return every queued request whose deadline passed —
        deadline-based abandonment of queued work."""
        expired = [r for _, r in self._items
                   if r.deadline is not None and now >= r.deadline]
        if expired:
            dead = {id(r) for r in expired}
            self._items = [(o, r) for o, r in self._items
                           if id(r) not in dead]
        return expired

    def peek_best(self, admissible=None):
        """Highest-ranked request passing ``admissible`` (or any), without
        removing it; None if none qualifies."""
        for _, r in self._ranked():
            if admissible is None or admissible(r):
                return r
        return None

    def pop_best(self, admissible=None):
        """Remove and return the highest-ranked admissible request."""
        best = self.peek_best(admissible)
        if best is not None:
            self._items = [(o, r) for o, r in self._items if r is not best]
        return best

    def pop_worst(self, admissible=None):
        """Remove and return the LOWEST-ranked admissible request — the
        load-shedding victim.  Rank order is the exact reverse of
        ``pop_best``, so fresh low-priority work sheds before anything
        preempted (preempted entries carry negative order and outrank
        fresh arrivals at the same priority)."""
        worst = None
        for _, r in reversed(self._ranked()):
            if admissible is None or admissible(r):
                worst = r
                break
        if worst is not None:
            self._items = [(o, r) for o, r in self._items if r is not worst]
        return worst

    def reset_peaks(self) -> None:
        """Drop the high-water mark to the CURRENT depth.  Back-to-back A/B
        replays reuse one process; without an explicit reset the second
        run's report inherits the first run's peak."""
        self.peak_depth = len(self._items)
