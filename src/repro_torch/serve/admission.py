"""SLO-guarded admission control and the graceful-degradation ladder (a
copy of ``repro.serve.admission``: the port imports nothing of the JAX
package; its decision stream is held byte for byte against the
reference's in tests/test_torch_admission.py).

The replayer can MEASURE tail latency under a seeded trace;
``AdmissionController`` lets the engine DEFEND a latency target on the
same trace.  Each engine step the
controller evaluates a deterministic pressure signal and drives three
levers:

* **prefill budget** — how many padded prefill tokens the engine's
  chunked-prefill machinery may process this step (halved per rung,
  floored at ``min_prefill_tokens``);
* **admit / defer / shed** — fresh admissions are deferred while the
  prefill backlog exceeds its bound (and while shedding under an active
  breach); at the top rung, queued fresh work beyond
  ``shed_target_depth`` is ABANDONED through the existing typed
  retirement machinery (``diagnostics={"kind": "shed", ...}``);
* **operating point** — a deterministic ladder of cheaper modes,
  stepped one rung at a time:

      nominal -> spec_half -> spec_off -> kv_int8 -> shed

  Rungs are CUMULATIVE (rung i implies every cheaper degradation below
  it) and capability-gated at attach: the spec rungs exist only on a
  speculative engine (γ > 1 for spec_half), kv_int8 only when resident
  pages aren't already int8; ``mode="admission"`` keeps just
  ``[nominal, shed]``.  spec_half shrinks the effective window to
  ``max(1, γ//2)`` (greedy speculation is lossless at ANY γ, so emitted
  tokens never change); spec_off falls back to vanilla decode while
  feeding the same tokens through the draft so both caches stay
  uniformly filled and re-enabling is seamless; kv_int8 admits NEW
  requests with their prefill K/V quantize-dequantized through the
  int8-resident-page numerics (such requests are non-preemptible, like
  an int8-paged engine's — an fp resume replay cannot reproduce the
  quantized history).

The pressure signal is LIVE, so it recovers when pressure clears (the
report-side p99 histograms never forget, which would latch the
controller at the top rung): a breach is (a) any fresh queued request
already waiting ``queue_wait_frac`` of the TTFT target, or (b) the last
step's modeled cost exceeding the TPOT target.  Hysteresis makes
flapping impossible: stepping up needs ``up_patience`` consecutive
breached steps, stepping down ``down_patience`` consecutive clear ones,
and every change starts a ``min_dwell_steps`` refractory window.  Every
decision is a typed ``ControllerDecision`` (and a telemetry event +
counter-track sample), so an overload episode replays byte-identically
and renders on the Perfetto timeline.

``StepCostModel`` makes the control problem REAL under the virtual
``StepClock``: a fixed per-step clock advance would invert the actual
tradeoffs (a monolithic 512-token prefill would be free; chunking would
look slower).  The model prices each step from what the engine actually
ran — padded prefill tokens, decode/draft calls, verify span tokens —
as pure host arithmetic (bit-deterministic, platform-independent), and
the replayer advances the StepClock by ``engine.last_step_cost_ms``, so
virtual TTFT/TPOT percentiles respond to scheduling decisions exactly
as wall-clock ones would.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .lifecycle import RequestState

RUNG_NOMINAL = "nominal"
RUNG_SPEC_HALF = "spec_half"
RUNG_SPEC_OFF = "spec_off"
RUNG_KV_INT8 = "kv_int8"
RUNG_SHED = "shed"


@dataclasses.dataclass(frozen=True)
class StepCostModel:
    """Deterministic per-step cost (ms) from the work the step ran.

    Coefficients are a smoke-scale stand-in for a measured roofline:
    prefill is priced per PADDED token row (batch_bucket x bucket for a
    monolithic admission, batch_bucket x chunk_tokens per chunk), decode
    and draft per batched call, verify per span position.  The absolute
    scale is arbitrary — control behavior depends only on ratios."""

    base_ms: float = 1.0
    prefill_ms_per_token: float = 0.05
    decode_ms: float = 4.0
    draft_ms: float = 1.0
    verify_ms_per_token: float = 1.0

    def cost_ms(self, prefill_tokens: int = 0, decode_calls: int = 0,
                draft_calls: int = 0, verify_tokens: int = 0) -> float:
        return (self.base_ms
                + prefill_tokens * self.prefill_ms_per_token
                + decode_calls * self.decode_ms
                + draft_calls * self.draft_ms
                + verify_tokens * self.verify_ms_per_token)


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Targets and controller tuning.

    ``ttft_p99_ms`` is the controlled objective; ``tpot_p99_ms``
    optionally adds a per-step cost bound (needs a ``StepCostModel`` on
    the engine to be meaningful).  ``queue_wait_frac`` sets the leading
    indicator: a fresh request queued longer than this fraction of the
    TTFT target counts as a breach NOW (waiting for the blown retirement
    would react a full request-lifetime late).  Patience/dwell are the
    hysteresis: flapping would switch the verify's shape (spec_half)
    back and forth and thrash admissions."""

    ttft_p99_ms: float
    tpot_p99_ms: Optional[float] = None
    prefill_budget_tokens: int = 512
    min_prefill_tokens: int = 32
    queue_wait_frac: float = 0.5
    defer_backlog_tokens: Optional[int] = None   # default: 4x budget
    shed_target_depth: Optional[int] = None      # default: engine n_slots
    up_patience: int = 2
    down_patience: int = 8
    min_dwell_steps: int = 4

    def __post_init__(self):
        if self.ttft_p99_ms <= 0:
            raise ValueError(
                f"ttft_p99_ms must be > 0, got {self.ttft_p99_ms}")
        if not (0 < self.queue_wait_frac <= 1):
            raise ValueError(
                f"queue_wait_frac must be in (0, 1], got "
                f"{self.queue_wait_frac}")
        if self.min_prefill_tokens < 1 or self.prefill_budget_tokens < 1:
            raise ValueError("prefill budgets must be >= 1")
        if self.up_patience < 1 or self.down_patience < 1:
            raise ValueError("patience values must be >= 1")
        if self.min_dwell_steps < 0:
            raise ValueError("min_dwell_steps must be >= 0")


@dataclasses.dataclass(frozen=True)
class ControllerDecision:
    """One replayable controller decision: rung changes, sheds, defers.
    The stream of these (``controller.decisions``) is the byte-exact
    record the overload-storm test pins across runs."""

    step: int
    t: float
    kind: str          # "rung_up" | "rung_down" | "shed" | "defer"
    rung: int
    rung_name: str
    details: Dict[str, Any]

    def as_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "t": self.t, "kind": self.kind,
                "rung": self.rung, "rung_name": self.rung_name,
                "details": dict(self.details)}


class AdmissionController:
    """Per-engine SLO controller.  Construct with an ``SLOConfig`` and
    pass as ``ServingEngine(controller=...)``; the engine attaches it at
    init (building the capability-gated ladder) and calls ``on_step``
    from ``pump()`` once per engine step.  One controller serves ONE
    engine."""

    def __init__(self, slo: SLOConfig, mode: str = "full"):
        if mode not in ("admission", "full"):
            raise ValueError(
                f"mode must be 'admission' or 'full', got {mode!r}")
        self.slo = slo
        self.mode = mode
        self.engine = None
        self.ladder: List[str] = [RUNG_NOMINAL, RUNG_SHED]
        self.rung = 0
        self.decisions: List[ControllerDecision] = []
        self.rung_changes = 0
        self.sheds = 0
        self.defers = 0
        self._hot = 0              # consecutive breached steps
        self._cool = 0             # consecutive clear steps
        self._breached = False     # last evaluated breach state
        self._last_change = -10**9
        self._last_step = -1
        self._last_defer_step = -1

    # -- wiring ----------------------------------------------------------
    def attach(self, engine) -> None:
        if self.engine is not None:
            raise ValueError(
                "AdmissionController is already attached to an engine — "
                "construct one controller per ServingEngine")
        self.engine = engine
        ladder = [RUNG_NOMINAL]
        if self.mode == "full":
            if engine.spec is not None and engine.spec.gamma > 1:
                ladder.append(RUNG_SPEC_HALF)
                # the shrunk window adds ONE verify shape for the
                # engine lifetime
                engine.verify_gammas.add(max(1, engine.spec.gamma // 2))
            if engine.spec is not None:
                ladder.append(RUNG_SPEC_OFF)
            if engine.kv_dtype != "int8":
                ladder.append(RUNG_KV_INT8)
        ladder.append(RUNG_SHED)
        self.ladder = ladder
        self._apply(engine)

    @property
    def rung_name(self) -> str:
        return self.ladder[self.rung]

    def prefill_budget(self) -> int:
        """Padded prefill tokens the engine may chunk this step: halved
        per rung, floored — deeper degradation trades TTFT of admitted
        work for TPOT of running work."""
        return max(self.slo.min_prefill_tokens,
                   self.slo.prefill_budget_tokens >> self.rung)

    # -- signal ----------------------------------------------------------
    def _breach(self, eng) -> bool:
        now = eng._clock()
        lim_s = self.slo.queue_wait_frac * self.slo.ttft_p99_ms / 1e3
        for r in eng.queue.requests():
            if not r.tokens and now - r.submitted_at >= lim_s:
                return True
        if (self.slo.tpot_p99_ms is not None
                and eng.last_step_cost_ms is not None
                and eng.last_step_cost_ms > self.slo.tpot_p99_ms):
            return True
        return False

    # -- per-step evaluation --------------------------------------------
    def on_step(self, eng) -> None:
        step = eng.engine_steps
        if step == self._last_step:      # pump() may run twice a step
            return
        self._last_step = step
        self._breached = breach = self._breach(eng)
        if breach:
            self._hot += 1
            self._cool = 0
        else:
            self._cool += 1
            self._hot = 0
        dwell_ok = step - self._last_change >= self.slo.min_dwell_steps
        if (breach and self._hot >= self.slo.up_patience and dwell_ok
                and self.rung < len(self.ladder) - 1):
            self.rung += 1
            self._step_changed(eng, "rung_up", step)
        elif (not breach and self._cool >= self.slo.down_patience
                and dwell_ok and self.rung > 0):
            self.rung -= 1
            self._step_changed(eng, "rung_down", step)
        if self.rung_name == RUNG_SHED:
            self._shed(eng, step)
        tel = eng.telemetry
        if tel is not None:
            tel.sample("controller_rung", step, self.rung)
            tel.sample("controller_prefill_budget", step,
                       self.prefill_budget())

    def _step_changed(self, eng, kind: str, step: int) -> None:
        self._last_change = step
        self._hot = 0
        self._cool = 0
        self.rung_changes += 1
        self._apply(eng)
        self._decide(eng, kind, step,
                     prefill_budget=self.prefill_budget())

    def _apply(self, eng) -> None:
        """Project the current rung onto the engine's knobs.  Rungs are
        cumulative: every degradation at or below the current rung is
        active."""
        active = set(self.ladder[:self.rung + 1])
        if eng.spec is not None:
            eng._gamma_eff = (max(1, eng.spec.gamma // 2)
                              if RUNG_SPEC_HALF in active
                              else eng.spec.gamma)
            eng._spec_enabled = RUNG_SPEC_OFF not in active
        eng._kv_int8_admission = RUNG_KV_INT8 in active

    def _shed(self, eng, step: int) -> None:
        """Top rung: ABANDON queued fresh work beyond the target depth,
        worst-ranked first (``pop_worst``).  Previously-preempted work is
        never shed — not by emitted tokens alone (a mid-``PREFILLING``
        preempt holds none) but by its preemption count: its slot debt is
        already paid."""
        target = (self.slo.shed_target_depth
                  if self.slo.shed_target_depth is not None
                  else eng.n_slots)
        while len(eng.queue) > target:
            victim = eng.queue.pop_worst(
                lambda r: not r.tokens and r.preemptions == 0)
            if victim is None:
                break
            self.sheds += 1
            self._decide(eng, "shed", step, uid=victim.uid,
                         queued=len(eng.queue))
            eng._retire(victim, RequestState.ABANDONED, diagnostics={
                "kind": "shed", "rung": self.rung,
                "rung_name": self.rung_name, "engine_step": step})

    # -- admission gating (called by the engine's _pump_queue) -----------
    def allow_fresh(self, eng) -> bool:
        """May fresh (never-run) queued work admit this step?  Resumes
        are ALWAYS admitted — preempted work must drain or preemption
        would leak slots of progress."""
        if not eng.active and not eng.pending_prefills:
            # nothing running to protect — deferring fresh work on an
            # idle engine is a livelock, not load shedding (the deferred
            # requests' own queue wait IS the breach signal)
            return True
        if self.rung_name == RUNG_SHED and self._breached:
            return False
        lim = self.slo.defer_backlog_tokens
        if lim is None:
            lim = 4 * self.slo.prefill_budget_tokens
        return eng.prefill_backlog_tokens <= lim

    def note_defer(self, eng, blocked: int) -> None:
        step = eng.engine_steps
        if step != self._last_defer_step:   # one event per step, not per pump
            self._last_defer_step = step
            self.defers += 1                # counter mirrors the event stream
            self._decide(eng, "defer", step, blocked=blocked,
                         backlog=eng.prefill_backlog_tokens)

    # -- record ----------------------------------------------------------
    def _decide(self, eng, kind: str, step: int, **details) -> None:
        d = ControllerDecision(step=step, t=eng._clock(), kind=kind,
                               rung=self.rung, rung_name=self.rung_name,
                               details=details)
        self.decisions.append(d)
        tel = eng.telemetry
        if tel is not None:
            tel.on_controller(kind, step, self.rung, self.rung_name,
                              **details)

    def decision_log(self) -> List[Dict[str, Any]]:
        return [d.as_dict() for d in self.decisions]

    def stats(self) -> Dict[str, Any]:
        return {
            "mode": self.mode,
            "ladder": list(self.ladder),
            "rung": self.rung,
            "rung_name": self.rung_name,
            "rung_changes": self.rung_changes,
            "sheds": self.sheds,
            "defers": self.defers,
            "decisions": len(self.decisions),
            "ttft_p99_ms_target": self.slo.ttft_p99_ms,
        }
