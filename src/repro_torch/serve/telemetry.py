"""Serving telemetry: metrics registry, per-request span recorder, and
Chrome/Perfetto trace export (a copy of ``repro.serve.telemetry``: the
port imports nothing of the JAX package; its event stream and report are
held field for field against the reference's in
tests/test_torch_telemetry.py and tests/test_torch_replay.py).

Everything here is pure-Python, host-side, and dependency-free.  The
engine calls into a ``Telemetry`` object (when one is wired via
``ServingEngine(telemetry=...)``) strictly outside its device work —
recording an event is a list append plus a couple of dict writes, and a
disabled engine (``telemetry=None``) pays a single ``is not None`` check
per call site, so the hot path is untouched either way: no tensor is
read, so telemetry adds no host sync.

Clocking: the recorder reads time exclusively through an injectable
monotonic clock.  By default it binds the ENGINE's clock at attach time
(``lifecycle.StepClock`` in deterministic runs, ``time.monotonic`` in
production), so seeded tests produce byte-identical event streams —
every ``t`` is virtual-clock time and every duration collapses to 0.0.
``monotonic()`` below is the one wall-clock source on the serve path.

Metrics model (all pure counters/lists — snapshots are plain JSON):

* ``Counter``   — monotonically increasing int.
* ``Gauge``     — last-written value.
* ``Timeline``  — (step, t, value) samples; one per engine step (same-
  step samples overwrite, so an idle driver loop cannot grow it).
* ``Histogram`` — fixed-bucket log-scale: bucket ``i`` covers
  ``(lo * 10**((i-1)/per_decade), lo * 10**(i/per_decade)]`` with an
  explicit zero/underflow bucket below ``lo`` and an overflow bucket
  above ``hi``.  Percentiles walk the cumulative counts and report the
  geometric bucket midpoint clamped to the observed [min, max] — exact
  to a bucket's relative width (~33% per bucket at the default 8
  buckets/decade), deterministic, O(1) memory regardless of sample
  count.

Span model: per-request lifecycle events (``submit``, ``admit``,
``first_token``, ``step`` (decode/spec), ``resume``, ``preempt``,
``retire``) each carry the clock time ``t`` AND the engine step index,
plus a per-uid record (submit/admit/first/last timestamps, tokens_out,
preemptions, terminal state) from which TTFT/TPOT are derived at
retirement and fed into the ``ttft_ms`` / ``tpot_ms`` /
``queue_wait_ms`` histograms.

``perfetto_trace`` renders the event list as Chrome ``trace_event``
JSON — one track (tid) per engine slot plus a queue track, "X" complete
spans for prefill/decode/spec/resume work, instants for
submit/preempt/retire, and "C" counter tracks for the sampled
queue-depth / active-slot / page-occupancy timelines — loadable
directly in ui.perfetto.dev.
"""
from __future__ import annotations

import json
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


def monotonic() -> float:
    """The sanctioned serve-path wall clock: every serve module reads time
    through an injected clock that defaults to this.  Tests inject
    ``lifecycle.StepClock`` instead."""
    return time.monotonic()


# ------------------------------------------------------------------ metrics

class Counter:
    """Monotonically increasing integer metric."""

    kind = "counter"

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set(self, v) -> None:
        self.value = v

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written value metric (set, not accumulated)."""

    kind = "gauge"

    def __init__(self) -> None:
        self.value: Any = None

    def set(self, v) -> None:
        self.value = v

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Timeline:
    """Per-engine-step samples of a scalar (queue depth, pool occupancy).
    Same-step samples overwrite the previous one, so a driver idling on
    an empty engine cannot grow the series."""

    kind = "timeline"

    def __init__(self) -> None:
        self.samples: List[Tuple[int, float, float]] = []  # (step, t, value)

    def sample(self, step: int, t: float, value) -> None:
        v = (int(step), float(t), float(value))
        if self.samples and self.samples[-1][0] == v[0]:
            self.samples[-1] = v
        else:
            self.samples.append(v)

    def snapshot(self) -> Dict[str, Any]:
        vals = [v for _, _, v in self.samples]
        return {
            "type": "timeline",
            "n": len(vals),
            "last": vals[-1] if vals else None,
            "max": max(vals) if vals else None,
            "mean": (sum(vals) / len(vals)) if vals else None,
            "steps": [s for s, _, _ in self.samples],
            "values": vals,
        }


class Histogram:
    """Fixed-bucket log-scale histogram with O(1) memory and
    deterministic percentiles.

    Bucket 0 holds zeros/underflow (values <= ``lo``); bucket ``i >= 1``
    covers ``(lo * 10**((i-1)/per_decade), lo * 10**(i/per_decade)]``;
    the last bucket absorbs overflow (> ``hi``).  ``percentile`` walks
    the cumulative counts and returns the geometric midpoint of the
    selected bucket, clamped to the observed [min, max] — so reported
    percentiles are always within the data range and exact min/max/mean
    are tracked separately."""

    kind = "histogram"

    def __init__(self, lo: float = 1e-3, hi: float = 1e5,
                 per_decade: int = 8) -> None:
        if lo <= 0 or hi <= lo or per_decade < 1:
            raise ValueError(
                f"histogram needs 0 < lo < hi and per_decade >= 1, got "
                f"lo={lo} hi={hi} per_decade={per_decade}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.per_decade = int(per_decade)
        n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
        self.counts = [0] * (n + 1)     # [zero/underflow, ..., overflow]
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if v <= self.lo:
            self.counts[0] += 1
            return
        i = int(math.ceil(math.log10(v / self.lo) * self.per_decade))
        self.counts[min(max(i, 1), len(self.counts) - 1)] += 1

    def _bucket_mid(self, i: int) -> float:
        if i == 0:
            return 0.0
        lo_e = self.lo * 10.0 ** ((i - 1) / self.per_decade)
        hi_e = self.lo * 10.0 ** (i / self.per_decade)
        return math.sqrt(lo_e * hi_e)

    def percentile(self, q: float) -> float:
        """q in [0, 1]; 0.0 for an empty histogram."""
        if self.count == 0:
            return 0.0
        rank = max(1, int(math.ceil(q * self.count)))
        cum = 0
        val = 0.0
        for i, c in enumerate(self.counts):
            cum += c
            if rank <= cum:
                val = self._bucket_mid(i)
                break
        else:
            val = self.max if self.max is not None else 0.0
        return min(max(val, self.min or 0.0), self.max or 0.0)

    def summary(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "mean": (self.total / self.count) if self.count else 0.0,
            "min": self.min if self.min is not None else 0.0,
            "max": self.max if self.max is not None else 0.0,
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
        }

    def snapshot(self) -> Dict[str, Any]:
        return dict({"type": "histogram"}, **self.summary())


class MetricsRegistry:
    """Named metrics with create-on-first-use accessors.  A name is
    bound to one metric type for the registry's lifetime — re-requesting
    it as a different type is a bug and raises."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(**kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested as {cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def timeline(self, name: str) -> Timeline:
        return self._get(name, Timeline)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(name, Histogram, **kw)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def get(self, name: str):
        return self._metrics.get(name)

    def snapshot(self) -> Dict[str, Any]:
        return {n: self._metrics[n].snapshot() for n in self.names()}

    def render(self, prefix: str = "", title: str = "metrics") -> str:
        """One uniform human-readable report (the ``--stats`` output):
        one line per metric, optionally restricted to a name prefix."""
        lines = [f"[{title}]"]
        for n in self.names():
            if prefix and not n.startswith(prefix):
                continue
            m = self._metrics[n]
            if isinstance(m, Histogram):
                s = m.summary()
                lines.append(
                    f"  {n}: n={s['count']} mean={s['mean']:.3f} "
                    f"p50={s['p50']:.3f} p90={s['p90']:.3f} "
                    f"p99={s['p99']:.3f} max={s['max']:.3f}")
            elif isinstance(m, Timeline):
                s = m.snapshot()
                if s["n"]:
                    lines.append(
                        f"  {n}: n={s['n']} last={s['last']:g} "
                        f"max={s['max']:g} mean={s['mean']:.3f}")
            else:
                v = m.value
                lines.append(f"  {n}: {v:g}" if isinstance(v, float)
                             else f"  {n}: {v}")
        return "\n".join(lines)


def registry_from_stats(stats: Dict[str, Any],
                        reg: Optional[MetricsRegistry] = None,
                        prefix: str = "serve") -> MetricsRegistry:
    """Project an engine ``stats()`` dict onto a registry as dotted-name
    gauges (nested dicts recurse: ``serve.paged.pages_in_use``), so the
    ad-hoc stats surfaces — spec counters, paged byte ladder, lifecycle
    tallies — render through the ONE uniform report."""
    reg = reg if reg is not None else MetricsRegistry()
    def put(name: str, v) -> None:
        if isinstance(v, dict):
            for k in sorted(v):
                put(f"{name}.{k}", v[k])
        elif isinstance(v, bool):
            reg.gauge(name).set(int(v))
        elif isinstance(v, (int, float)):
            reg.gauge(name).set(v)
        elif isinstance(v, str):
            reg.gauge(name).set(v)
        # lists (bucket ladders) and None are not scalar metrics: skip
    put(prefix, stats)
    return reg


# ------------------------------------------------------------------- spans

class Telemetry:
    """Per-request span recorder + metrics registry for one engine.

    Construct one, pass it as ``ServingEngine(telemetry=...)``; the
    engine attaches it at init (binding its injectable clock unless one
    was given explicitly) and invokes the ``on_*`` hooks host-side at
    each lifecycle edge.  All state is plain Python: ``events`` is the
    ordered structured event stream, ``records`` maps uid -> span record,
    ``registry`` holds the histograms/timelines the end-of-run report
    reads.  One Telemetry serves ONE engine — re-attaching is a bug."""

    def __init__(self, clock: Optional[Callable[[], float]] = None) -> None:
        self.clock = clock
        self.registry = MetricsRegistry()
        self.events: List[Dict[str, Any]] = []
        self.records: Dict[int, Dict[str, Any]] = {}
        self.n_slots = 0
        self._attached = False

    # -- wiring ---------------------------------------------------------
    def attach(self, n_slots: int, clock: Callable[[], float]) -> None:
        if self._attached:
            raise ValueError(
                "Telemetry is already attached to an engine — construct "
                "one recorder per ServingEngine")
        self._attached = True
        self.n_slots = n_slots
        if self.clock is None:
            self.clock = clock

    def now(self) -> float:
        return self.clock() if self.clock is not None else 0.0

    def _emit(self, kind: str, step: int, **data) -> Dict[str, Any]:
        ev = {"t": self.now(), "step": int(step), "kind": kind}
        ev.update(data)
        self.events.append(ev)
        self.registry.counter(f"events.{kind}").inc()
        return ev

    # -- lifecycle hooks (called by the engine, host-side only) ---------
    def on_submit(self, req, step: int) -> None:
        t = self.now()
        self.records[req.uid] = {
            "uid": req.uid, "n_prompt": len(req.prompt),
            "max_new_tokens": req.max_new_tokens,
            "priority": req.priority,
            "submit_t": t, "submit_step": int(step),
            "admit_t": None, "admit_step": None,
            "first_token_t": None, "first_token_step": None,
            "last_token_t": None, "tokens_out": 0,
            "preemptions": 0, "slot": None, "state": None,
        }
        self._emit("submit", step, uid=req.uid, n_prompt=len(req.prompt),
                   max_new_tokens=req.max_new_tokens, priority=req.priority)

    def on_admit(self, uids: Sequence[int], slots: Sequence[int],
                 bucket: int, batch: int, dur: float, step: int) -> None:
        t = self.now()
        for uid, slot in zip(uids, slots):
            r = self.records.get(uid)
            if r is not None:
                if r["admit_t"] is None:
                    r["admit_t"] = t
                    r["admit_step"] = int(step)
                r["slot"] = int(slot)
        self._emit("admit", step, uids=[int(u) for u in uids],
                   slots=[int(s) for s in slots], bucket=int(bucket),
                   batch=int(batch), dur=float(dur))
        self.registry.histogram("prefill_ms").observe(dur * 1e3)

    def on_resume(self, uid: int, slot: int, replayed: int, dur: float,
                  step: int) -> None:
        r = self.records.get(uid)
        if r is not None:
            r["slot"] = int(slot)
        self._emit("resume", step, uid=int(uid), slot=int(slot),
                   replayed=int(replayed), dur=float(dur))

    def on_token(self, req, step: int) -> None:
        r = self.records.get(req.uid)
        if r is None:
            return
        t = self.now()
        r["tokens_out"] = len(req.tokens)
        r["last_token_t"] = t
        if r["first_token_t"] is None:
            r["first_token_t"] = t
            r["first_token_step"] = int(step)
            self._emit("first_token", step, uid=req.uid)

    def on_step(self, mode: str, emitted: Dict[int, int],
                slots: Dict[int, int], dur: float, step: int,
                **extra) -> None:
        uids = sorted(emitted)
        self._emit("step", step, mode=mode, uids=uids,
                   tokens=[int(emitted[u]) for u in uids],
                   slots=[int(slots[u]) for u in uids], dur=float(dur),
                   **extra)
        self.registry.histogram(f"{mode}_step_ms").observe(dur * 1e3)

    def on_preempt(self, victims: Sequence[Tuple[int, int]], reason: str,
                   step: int) -> None:
        """``victims``: (uid, slot) pairs captured BEFORE the slots are
        cleared, so the Perfetto instants land on the right track."""
        for uid, _ in victims:
            r = self.records.get(uid)
            if r is not None:
                r["preemptions"] += 1
                r["slot"] = None
        self._emit("preempt", step, uids=[int(u) for u, _ in victims],
                   slots=[int(s) for _, s in victims], reason=reason)

    def on_chunk(self, uids: Sequence[int], slots: Sequence[int],
                 start: int, chunk_tokens: int, batch: int,
                 step: int) -> None:
        """One chunked-prefill chunk advanced: ``uids``/``slots`` are the
        group's LIVE rows, ``start`` the chunk's base position."""
        self._emit("chunk", step, uids=[int(u) for u in uids],
                   slots=[int(s) for s in slots], start=int(start),
                   chunk_tokens=int(chunk_tokens), batch=int(batch))

    def on_controller(self, kind: str, step: int, rung: int,
                      rung_name: str, **details) -> None:
        """A typed admission-controller decision (rung move, shed,
        defer) — the replayable record of the degradation ladder."""
        self._emit("controller", step, decision=kind, rung=int(rung),
                   rung_name=rung_name, **details)

    def on_retire(self, req, state, step: int) -> None:
        r = self.records.get(req.uid)
        slot = req.slot if req.slot is not None and req.slot >= 0 else None
        # the engine sets diagnostics BEFORE this hook, so shed/deadline/
        # pressure retirements carry their reason into the event stream
        reason = (req.diagnostics or {}).get("kind")
        extra = {"reason": reason} if reason else {}
        self._emit("retire", step, uid=req.uid, state=state.value,
                   tokens_out=len(req.tokens),
                   slot=slot if slot is not None else -1, **extra)
        if r is None:
            return
        r["state"] = state.value
        r["tokens_out"] = len(req.tokens)
        r["slot"] = None
        if r["first_token_t"] is not None and r["submit_t"] is not None:
            self.registry.histogram("ttft_ms").observe(
                (r["first_token_t"] - r["submit_t"]) * 1e3)
        if r["admit_t"] is not None and r["submit_t"] is not None:
            self.registry.histogram("queue_wait_ms").observe(
                (r["admit_t"] - r["submit_t"]) * 1e3)
        if (r["first_token_t"] is not None and r["last_token_t"] is not None
                and r["tokens_out"] >= 2):
            self.registry.histogram("tpot_ms").observe(
                (r["last_token_t"] - r["first_token_t"]) * 1e3
                / (r["tokens_out"] - 1))

    def sample(self, name: str, step: int, value) -> None:
        self.registry.timeline(name).sample(step, self.now(), value)


# ----------------------------------------------------------------- perfetto

# Track ids: tid 0 is engine metadata, 1..n_slots the slot tracks,
# n_slots+1 the queue track, n_slots+2 the admission controller (the
# controller metadata row appears only when controller events exist, so
# uncontrolled traces are byte-stable).  Span names by event kind/mode.
_SPAN_NAMES = {"admit": "prefill", "resume": "resume",
               "decode": "decode", "spec": "spec"}


def perfetto_trace(tel: Telemetry) -> Dict[str, Any]:
    """Render a recorded event stream as Chrome ``trace_event`` JSON
    (the dict form: ``{"traceEvents": [...]}``) — drop the output of
    ``write_perfetto`` onto ui.perfetto.dev / chrome://tracing.

    Layout: one thread track per engine slot (named ``slot N``) plus a
    ``queue`` track; "X" complete events for prefill/resume/decode/spec
    work with their host-measured duration (0-length under a StepClock);
    instant events for submit (queue track), preempt and retire (slot
    track); "C" counter events for every sampled timeline."""
    pid = 1
    qtid = tel.n_slots + 1
    ctid = tel.n_slots + 2
    evs: List[Dict[str, Any]] = [
        {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
         "args": {"name": "repro_torch.serve"}},
        {"ph": "M", "pid": pid, "tid": qtid, "name": "thread_name",
         "args": {"name": "queue"}},
    ]
    for s in range(tel.n_slots):
        evs.append({"ph": "M", "pid": pid, "tid": s + 1,
                    "name": "thread_name", "args": {"name": f"slot {s}"}})
    if any(ev["kind"] == "controller" for ev in tel.events):
        evs.append({"ph": "M", "pid": pid, "tid": ctid,
                    "name": "thread_name", "args": {"name": "controller"}})

    def us(t: float) -> float:
        return round(t * 1e6, 3)

    for ev in tel.events:
        t, step, kind = ev["t"], ev["step"], ev["kind"]
        if kind == "admit":
            for uid, slot in zip(ev["uids"], ev["slots"]):
                evs.append({"ph": "X", "pid": pid, "tid": slot + 1,
                            "name": "prefill", "cat": "serve",
                            "ts": us(t - ev["dur"]), "dur": us(ev["dur"]),
                            "args": {"uid": uid, "step": step,
                                     "bucket": ev["bucket"]}})
        elif kind == "resume":
            evs.append({"ph": "X", "pid": pid, "tid": ev["slot"] + 1,
                        "name": "resume", "cat": "serve",
                        "ts": us(t - ev["dur"]), "dur": us(ev["dur"]),
                        "args": {"uid": ev["uid"], "step": step,
                                 "replayed": ev["replayed"]}})
        elif kind == "step":
            name = _SPAN_NAMES.get(ev["mode"], ev["mode"])
            for uid, slot, ntok in zip(ev["uids"], ev["slots"],
                                       ev["tokens"]):
                evs.append({"ph": "X", "pid": pid, "tid": slot + 1,
                            "name": name, "cat": "serve",
                            "ts": us(t - ev["dur"]), "dur": us(ev["dur"]),
                            "args": {"uid": uid, "step": step,
                                     "tokens": ntok}})
        elif kind == "preempt":
            for uid, slot in zip(ev["uids"], ev["slots"]):
                evs.append({"ph": "i", "pid": pid, "tid": slot + 1,
                            "name": "preempt", "cat": "serve", "s": "t",
                            "ts": us(t),
                            "args": {"uid": uid, "reason": ev["reason"]}})
        elif kind == "submit":
            evs.append({"ph": "i", "pid": pid, "tid": qtid,
                        "name": "submit", "cat": "serve", "s": "t",
                        "ts": us(t), "args": {"uid": ev["uid"]}})
        elif kind == "chunk":
            for uid, slot in zip(ev["uids"], ev["slots"]):
                evs.append({"ph": "X", "pid": pid, "tid": slot + 1,
                            "name": "chunk", "cat": "serve",
                            "ts": us(t), "dur": 0.0,
                            "args": {"uid": uid, "step": step,
                                     "start": ev["start"],
                                     "chunk_tokens": ev["chunk_tokens"]}})
        elif kind == "controller":
            evs.append({"ph": "i", "pid": pid, "tid": ctid,
                        "name": f"ctl:{ev['decision']}:{ev['rung_name']}",
                        "cat": "serve", "s": "t", "ts": us(t),
                        "args": {k: v for k, v in ev.items()
                                 if k not in ("t", "kind")}})
        elif kind == "retire":
            tid = ev["slot"] + 1 if ev["slot"] >= 0 else qtid
            name = (f"retire:{ev['state']}:{ev['reason']}"
                    if ev.get("reason") else f"retire:{ev['state']}")
            evs.append({"ph": "i", "pid": pid, "tid": tid,
                        "name": name, "cat": "serve",
                        "s": "t", "ts": us(t),
                        "args": {"uid": ev["uid"],
                                 "tokens_out": ev["tokens_out"]}})
    for name in tel.registry.names():
        m = tel.registry.get(name)
        if isinstance(m, Timeline):
            for _, t, v in m.samples:
                evs.append({"ph": "C", "pid": pid, "name": name,
                            "ts": us(t), "args": {name: v}})
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def write_perfetto(path: str, tel: Telemetry) -> None:
    with open(path, "w") as f:
        json.dump(perfetto_trace(tel), f)
