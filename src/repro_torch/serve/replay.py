"""Trace-driven workload replay: load (or synthesize) an arrival trace,
drive ``submit()`` against the engine's clock, and produce the
end-of-run scheduling report (port of ``repro.serve.replay``: numpy
and the port's own ``faults``, ``lifecycle`` and ``telemetry``; under
``StepClock`` + ``StepCostModel`` its report equals the reference's byte
for byte, tests/test_torch_replay.py).

The trace format is JSONL — one arrival per line:

    {"t": 0.02, "prompt": [5, 17, 3], "max_new_tokens": 8,
     "priority": 0, "deadline_ms": 150.0}

``t`` is seconds since trace start; ``deadline_ms``/``priority`` are
optional.  ``synthesize_trace`` derives a trace from the fault
injector's Poisson+burst arrival plan (one seed -> one byte-identical
trace), so CI and the bench replay a seeded storm with no fixture file.

The ``Replayer`` releases arrivals when the engine clock passes each
``t`` and steps the engine until every request reaches a terminal
state.  Under a ``lifecycle.StepClock`` it advances the clock one step
per ``step()`` (fully deterministic — the bit-identical-replay tests
ride this); under a wall clock it free-runs.  Backpressure
(``AdmissionRejected``) parks the arrival until the next step;
``DeadlineExceeded`` at submission is counted as expired-at-submit.

The report is plain JSON (schema ``replay-report/v1``): TTFT / TPOT /
queue-wait p50/p90/p99 from the telemetry histograms, tokens/s and
tokens/s/slot, queue-depth / active-slot / page-occupancy timelines,
preemption/resume/abandonment accounting, and a per-request span table.
``validate_report`` is the jsonschema-free structural check.

    PYTHONPATH=src python -m repro_torch.serve.replay --smoke --faults \
        --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .faults import FaultInjector
from .lifecycle import (AdmissionRejected, DeadlineExceeded, RetryPolicy,
                        ServeError, StepClock)
from .telemetry import Telemetry, Timeline, write_perfetto


# ------------------------------------------------------------------- trace

@dataclasses.dataclass(frozen=True)
class Arrival:
    """One trace line: a request arriving ``t`` seconds into the run."""
    t: float
    prompt: Tuple[int, ...]
    max_new_tokens: int = 8
    priority: int = 0
    deadline_ms: Optional[float] = None

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"t": self.t, "prompt": list(self.prompt),
                             "max_new_tokens": self.max_new_tokens}
        if self.priority:
            d["priority"] = self.priority
        if self.deadline_ms is not None:
            d["deadline_ms"] = self.deadline_ms
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Arrival":
        return cls(t=float(d["t"]), prompt=tuple(int(x) for x in d["prompt"]),
                   max_new_tokens=int(d.get("max_new_tokens", 8)),
                   priority=int(d.get("priority", 0)),
                   deadline_ms=(float(d["deadline_ms"])
                                if d.get("deadline_ms") is not None else None))


def save_trace(path: str, trace: Sequence[Arrival]) -> None:
    with open(path, "w") as f:
        for a in trace:
            f.write(json.dumps(a.to_json(), sort_keys=True) + "\n")


def load_trace(path: str) -> List[Arrival]:
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(Arrival.from_json(json.loads(line)))
            except (ValueError, KeyError, TypeError) as e:
                raise ValueError(
                    f"{path}:{i + 1}: bad trace line ({e}): {line[:80]}")
    out.sort(key=lambda a: a.t)
    return out


def synthesize_trace(seed: int = 0, steps: int = 24, vocab: int = 64,
                     step_ms: float = 10.0,
                     arrival_lambda: float = 0.6,
                     burst_every: int = 12, burst_size: int = 3,
                     prompt_len: Tuple[int, int] = (3, 10),
                     max_new: Tuple[int, int] = (4, 10),
                     deadline_frac: float = 0.25,
                     deadline_ms: float = 200.0) -> List[Arrival]:
    """Seeded Poisson+burst trace off the fault injector's arrival plan:
    arrivals at driver step ``s`` land at ``t = s * step_ms / 1e3``;
    prompt contents / lengths / budgets come from a derived seeded rng;
    a ``deadline_frac`` fraction carries a tight SLO so abandonment
    accounting is exercised.  Same seed -> byte-identical trace."""
    inj = FaultInjector(seed=seed, horizon=max(8, steps),
                        nan_faults=0, inf_faults=0, pressure_windows=0,
                        transient_failures=0,
                        arrival_lambda=arrival_lambda,
                        burst_every=burst_every, burst_size=burst_size)
    rng = np.random.default_rng(seed + 1)
    out: List[Arrival] = []
    for s in range(steps):
        for _ in range(inj.arrivals(s)):
            n = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
            prompt = tuple(int(x) for x in rng.integers(1, vocab, size=n))
            mn = int(rng.integers(max_new[0], max_new[1] + 1))
            dl = deadline_ms if float(rng.random()) < deadline_frac else None
            out.append(Arrival(t=s * step_ms / 1e3, prompt=prompt,
                               max_new_tokens=mn, deadline_ms=dl))
    return out


# ----------------------------------------------------------------- replayer

class Replayer:
    """Drive one engine through one arrival trace to full drain.

    Arrivals are released when ``engine.clock() - t0`` passes their
    ``t``; each loop iteration submits everything due, absorbs
    backpressure, runs one ``step()`` (through ``retry`` when given, so
    seeded transient faults don't abort the run), and — when the engine
    clock is a ``StepClock`` — advances it by one step.  Returns the
    scheduling report (None when the engine has no telemetry: the run
    still drains, which is what the telemetry-on/off parity check
    drives)."""

    def __init__(self, engine, trace: Sequence[Arrival],
                 retry: Optional[RetryPolicy] = None,
                 max_steps: Optional[int] = None) -> None:
        self.engine = engine
        self.trace = sorted(trace, key=lambda a: a.t)
        self.retry = retry
        self.max_steps = (max_steps if max_steps is not None
                          else 64 * max(len(self.trace), 1) + 256)

    def run(self) -> Optional[Dict[str, Any]]:
        eng = self.engine
        # back-to-back A/B replays may reuse one engine/process: peaks
        # (queue depth, page occupancy) must not leak across runs
        eng.reset_peaks()
        clock = eng.clock
        step_clock = isinstance(clock, StepClock)
        t0 = clock()
        i = 0
        pending: List[Arrival] = []
        counts = {"backpressure_waits": 0, "expired_at_submit": 0,
                  "rejected_unfittable": 0, "transient_retries": 0}
        steps = 0
        while True:
            now = clock() - t0
            while i < len(self.trace) and self.trace[i].t <= now + 1e-12:
                pending.append(self.trace[i])
                i += 1
            blocked = False
            while pending and not blocked:
                a = pending[0]
                try:
                    eng.submit(list(a.prompt),
                               max_new_tokens=a.max_new_tokens,
                               priority=a.priority,
                               deadline_ms=a.deadline_ms)
                except DeadlineExceeded:
                    counts["expired_at_submit"] += 1
                except AdmissionRejected:
                    if len(eng.queue) or eng.active:
                        # queue full behind live work: wait a step
                        counts["backpressure_waits"] += 1
                        blocked = True
                        continue
                    # rejected by an EMPTY engine: it can never fit
                    counts["rejected_unfittable"] += 1
                pending.pop(0)
            if self.retry is not None:
                _, r = self.retry.run(eng.step)
                counts["transient_retries"] += r
            else:
                eng.step()
            if step_clock:
                # with a StepCostModel the virtual clock advances by the
                # step's modeled cost, so scheduling decisions (chunking,
                # degradation) move the TTFT/TPOT percentiles exactly as
                # wall time would; without one, the fixed advance
                clock.advance(eng.last_step_cost_ms)
            steps += 1
            drained = (i >= len(self.trace) and not pending
                       and not eng.active and not len(eng.queue)
                       and not eng.pending_prefills)
            if drained:
                break
            if steps >= self.max_steps:
                raise ServeError(
                    f"replay did not drain in {self.max_steps} driver "
                    f"steps: {len(eng.active)} active, {len(eng.queue)} "
                    f"queued, {len(pending) + len(self.trace) - i} "
                    f"arrivals not yet admitted")
        elapsed = clock() - t0
        if eng.telemetry is None:
            return None
        span = self.trace[-1].t - self.trace[0].t if self.trace else 0.0
        return build_report(
            eng, elapsed=elapsed, driver_steps=steps, extra=counts,
            trace_meta={"n_arrivals": len(self.trace),
                        "span_s": round(span, 6)})


# ------------------------------------------------------------------- report

def build_report(engine, elapsed: float, driver_steps: Optional[int] = None,
                 extra: Optional[Dict[str, int]] = None,
                 trace_meta: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """The end-of-run scheduling report, straight off the engine's
    telemetry spans + stats().  Works after any driven run, not just a
    ``Replayer`` one (``launch/serve.py --report-json`` uses it too)."""
    tel = engine.telemetry
    if tel is None:
        raise ValueError("build_report needs ServingEngine(telemetry=...)")
    st = engine.stats()
    reg = tel.registry
    by_state: Dict[str, int] = {}
    per_request = []
    total_out = 0
    for uid in sorted(tel.records):
        r = tel.records[uid]
        total_out += r["tokens_out"]
        if r["state"] is not None:
            by_state[r["state"]] = by_state.get(r["state"], 0) + 1
        ttft = (None if r["first_token_t"] is None
                else (r["first_token_t"] - r["submit_t"]) * 1e3)
        tpot = None
        if (r["first_token_t"] is not None and r["tokens_out"] >= 2
                and r["last_token_t"] is not None):
            tpot = ((r["last_token_t"] - r["first_token_t"]) * 1e3
                    / (r["tokens_out"] - 1))
        per_request.append({
            "uid": uid, "state": r["state"], "n_prompt": r["n_prompt"],
            "tokens_out": r["tokens_out"],
            "preemptions": r["preemptions"],
            "submit_step": r["submit_step"],
            "admit_step": r["admit_step"],
            "first_token_step": r["first_token_step"],
            "ttft_ms": None if ttft is None else round(ttft, 6),
            "tpot_ms": None if tpot is None else round(tpot, 6),
        })
    n_slots = engine.n_slots
    per_s = total_out / elapsed if elapsed > 0 else 0.0
    scheduling = {
        "preemptions": st["preemptions"],
        "resumes": st["resumes"],
        "admission_rejections": st["admission_rejections"],
        "queue_peak_depth": st["queue_peak_depth"],
    }
    scheduling.update(extra or {})
    timelines = {}
    for name in reg.names():
        m = reg.get(name)
        if isinstance(m, Timeline):
            timelines[name] = m.snapshot()
    report: Dict[str, Any] = {
        "schema": "replay-report/v1",
        "trace": trace_meta or {},
        "n_slots": n_slots,
        "elapsed_s": round(elapsed, 6),
        "driver_steps": driver_steps,
        "engine_steps": st["engine_steps"],
        "requests": {"submitted": len(tel.records), "by_state": by_state},
        "ttft_ms": reg.histogram("ttft_ms").summary(),
        "tpot_ms": reg.histogram("tpot_ms").summary(),
        "queue_wait_ms": reg.histogram("queue_wait_ms").summary(),
        "tokens": {
            "total_out": total_out,
            "per_step": st["tokens_per_step"],
            "per_s": round(per_s, 6),
            "per_s_per_slot": round(per_s / n_slots, 6) if n_slots else 0.0,
        },
        "scheduling": scheduling,
        "timelines": timelines,
        "per_request": per_request,
    }
    if "paged" in st:
        report["paged"] = {k: st["paged"][k] for k in (
            "n_pages", "pages_in_use", "peak_pages_in_use",
            "prefix_hits", "cow_copies", "page_evictions")}
    if "spec_gamma" in st:
        report["spec"] = {k: st[k] for k in (
            "spec_gamma", "spec_drafted", "spec_accepted",
            "acceptance_rate")}
    if "chunked" in st:
        report["chunked"] = dict(st["chunked"])
    if "controller" in st:
        report["controller"] = dict(st["controller"])
        ctl = getattr(engine, "controller", None)
        if ctl is not None:
            report["controller"]["decision_log"] = ctl.decision_log()
    return report


_PCT_KEYS = ("count", "mean", "min", "max", "p50", "p90", "p99")


def validate_report(report: Dict[str, Any]) -> Dict[str, Any]:
    """Structural (jsonschema-free) validation of a replay report —
    raises ``ValueError`` listing every problem; returns the report so
    callers can chain it."""
    errs: List[str] = []

    def need(key: str, typ) -> Any:
        v = report.get(key)
        if not isinstance(v, typ):
            errs.append(f"{key}: expected {typ}, got {type(v).__name__}")
            return None
        return v

    if report.get("schema") != "replay-report/v1":
        errs.append(f"schema: expected 'replay-report/v1', got "
                    f"{report.get('schema')!r}")
    for k in ("elapsed_s",):
        if not isinstance(report.get(k), (int, float)):
            errs.append(f"{k}: missing or non-numeric")
    for k in ("requests", "tokens", "scheduling", "timelines", "trace"):
        need(k, dict)
    for k in ("ttft_ms", "tpot_ms", "queue_wait_ms"):
        h = need(k, dict)
        if h is None:
            continue
        missing = [p for p in _PCT_KEYS if not isinstance(h.get(p),
                                                          (int, float))]
        if missing:
            errs.append(f"{k}: missing/non-numeric {missing}")
        elif not (h["p50"] <= h["p90"] <= h["p99"]):
            errs.append(f"{k}: percentiles not monotone: {h}")
        elif h["count"] > 0 and not (h["min"] - 1e-9 <= h["p50"]
                                     <= h["max"] + 1e-9):
            errs.append(f"{k}: p50 outside [min, max]: {h}")
    toks = report.get("tokens")
    if isinstance(toks, dict):
        for k in ("total_out", "per_step", "per_s", "per_s_per_slot"):
            if not isinstance(toks.get(k), (int, float)):
                errs.append(f"tokens.{k}: missing or non-numeric")
    reqs = report.get("requests")
    if isinstance(reqs, dict):
        by_state = reqs.get("by_state")
        if not isinstance(by_state, dict):
            errs.append("requests.by_state: missing")
        elif sum(by_state.values()) != reqs.get("submitted"):
            errs.append(
                f"requests.by_state sums to {sum(by_state.values())}, "
                f"submitted={reqs.get('submitted')}")
    pr = report.get("per_request")
    if not isinstance(pr, list):
        errs.append("per_request: expected list")
    else:
        for j, row in enumerate(pr):
            for k in ("uid", "state", "tokens_out"):
                if k not in row:
                    errs.append(f"per_request[{j}]: missing {k!r}")
                    break
    if errs:
        raise ValueError("invalid replay report:\n  " + "\n  ".join(errs))
    return report


# ---------------------------------------------------------------------- cli

def _smoke_engine(telemetry: Optional[Telemetry], seed: int,
                  verify_contracts: bool, n_slots: int, max_len: int,
                  faults: bool, chunk_tokens: Optional[int] = None,
                  controller=None, cost_model=None,
                  queue_depth: Optional[int] = None, device="cuda"):
    """A small fp dense engine (the llama1_7b smoke config, vocab 128, 2
    layers, random init from ``seed``) on ``device`` — torch is imported
    here, not at module load, so trace tooling stays cheap."""
    import dataclasses as dc
    import torch
    from repro_torch import device as dev_lib
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api
    from .engine import ServingEngine
    device = dev_lib.resolve(device)
    cfg = dc.replace(get_smoke_config("llama1_7b"), vocab=128, n_layers=2)
    params = api.init_params(torch.Generator(device=device).manual_seed(seed),
                             cfg, device)
    inj = None
    if faults:
        # pressure_frac tuned so the windows' page/position limit falls
        # BELOW running fills (prompt 3-10 + decode) — a window that
        # never preempts anything exercises nothing
        inj = FaultInjector(seed=seed, horizon=64, nan_faults=0,
                            inf_faults=0, transient_failures=0,
                            pressure_windows=2, pressure_len=(3, 6),
                            pressure_frac=(0.12, 0.22))
    return ServingEngine(
        params, cfg, n_slots=n_slots, max_len=max_len, min_bucket=8,
        clock=StepClock(10.0), telemetry=telemetry, faults=inj,
        on_pressure="preempt", verify_contracts=verify_contracts,
        chunked_prefill=chunk_tokens, controller=controller,
        cost_model=cost_model, queue_depth=queue_depth, device=device)


def overload_trace(seed: int, steps: int = 32,
                   vocab: int = 128) -> List[Arrival]:
    """The seeded burst trace the overload-smoke / bench A/B rides:
    long prompts arriving in bursts, no deadlines (abandonment must be
    the CONTROLLER's decision, not the trace's)."""
    return synthesize_trace(seed=seed, steps=steps, vocab=vocab,
                            arrival_lambda=1.4, burst_every=4,
                            burst_size=7, prompt_len=(20, 36),
                            max_new=(4, 8), deadline_frac=0.0)


def _overload_ab(args) -> int:
    """--slo-ttft-p99-ms: replay the SAME seeded burst trace twice —
    uncontrolled baseline vs SLO-guarded (chunked prefill + degradation
    ladder) — under the SAME step-cost model, and hold the guarded run
    to the target the baseline blows."""
    from .admission import AdmissionController, SLOConfig, StepCostModel
    target = args.slo_ttft_p99_ms
    trace = overload_trace(args.seed, steps=max(args.steps, 40))
    cost = StepCostModel()
    # the bounded default queue (2*n_slots) would cap queue wait — and
    # therefore TTFT — via submit backpressure, hiding the overload the
    # controller exists to manage; both sides get the same deep queue
    depth = 16 * args.slots
    tel_base = Telemetry()
    base = _smoke_engine(tel_base, args.seed, False, args.slots,
                         args.max_len, False, cost_model=cost,
                         queue_depth=depth, device=args.device)
    base_report = Replayer(base, trace,
                           retry=RetryPolicy(backoff_s=0.0)).run()
    tel = Telemetry()
    ctl = AdmissionController(
        SLOConfig(ttft_p99_ms=target), mode=args.controller_mode)
    eng = _smoke_engine(tel, args.seed, args.verify_contracts, args.slots,
                        args.max_len, False,
                        chunk_tokens=args.chunk_tokens, controller=ctl,
                        cost_model=cost, queue_depth=depth,
                        device=args.device)
    report = Replayer(eng, trace, retry=RetryPolicy(backoff_s=0.0)).run()
    validate_report(report)
    base_p99 = base_report["ttft_ms"]["p99"]
    ctl_p99 = report["ttft_ms"]["p99"]
    cstats = report["controller"]
    report["slo"] = {"ttft_p99_ms_target": target,
                     "baseline_ttft_p99_ms": base_p99,
                     "guarded_ttft_p99_ms": ctl_p99}
    print(f"[overload] baseline ttft p99={base_p99:.1f}ms "
          f"(n={base_report['ttft_ms']['count']}) vs guarded "
          f"p99={ctl_p99:.1f}ms (n={report['ttft_ms']['count']}), "
          f"target={target:.1f}ms")
    print(f"[overload] controller: rung_changes={cstats['rung_changes']} "
          f"sheds={cstats['sheds']} defers={cstats['defers']} "
          f"final rung={cstats['rung_name']}")
    errs = []
    if base_p99 <= target:
        errs.append(f"baseline p99 TTFT {base_p99:.1f}ms already meets the "
                    f"{target:.1f}ms target: the storm is not a storm")
    if ctl_p99 > target:
        errs.append(f"guarded p99 TTFT {ctl_p99:.1f}ms misses the "
                    f"{target:.1f}ms target")
    if ctl_p99 >= base_p99:
        errs.append(f"guarded p99 TTFT {ctl_p99:.1f}ms does not beat the "
                    f"baseline {base_p99:.1f}ms")
    if cstats["rung_changes"] == 0 or (cstats["sheds"] == 0
                                       and cstats["defers"] == 0):
        errs.append(f"vacuous controller run: rung_changes="
                    f"{cstats['rung_changes']} sheds={cstats['sheds']} "
                    f"defers={cstats['defers']}")
    if errs:
        raise SystemExit("[overload] FAIL:\n  " + "\n  ".join(errs))
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"[overload] report -> {args.report_json}")
    if args.perfetto:
        write_perfetto(args.perfetto, tel)
        print(f"[overload] perfetto trace -> {args.perfetto}")
    print("[overload] OK: SLO-guarded replay beats the uncontrolled "
          "baseline and meets the target")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.replay",
        description="Replay a JSONL arrival trace (or a seeded synthetic "
                    "one) against a smoke serving engine and emit the "
                    "scheduling report.")
    ap.add_argument("--trace", help="JSONL arrival trace; omit to "
                                    "synthesize one from --seed")
    ap.add_argument("--smoke", action="store_true",
                    help="small synthesized trace + small engine (CI)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=24,
                    help="synthesized-trace driver steps")
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--faults", action="store_true",
                    help="seeded pressure window (preempt/resume storm)")
    ap.add_argument("--verify-contracts", action="store_true",
                    help="run the contract gate on the engine (with "
                         "telemetry attached) before replaying")
    ap.add_argument("--report-json", help="write the replay report here")
    ap.add_argument("--perfetto", help="write a Chrome/Perfetto "
                                       "trace_event JSON here")
    ap.add_argument("--slo-ttft-p99-ms", type=float, default=None,
                    help="overload A/B mode: replay a seeded burst trace "
                         "uncontrolled vs SLO-guarded and hold the "
                         "guarded run to this p99 TTFT target")
    ap.add_argument("--chunk-tokens", type=int, default=8,
                    help="prefill chunk size for the SLO-guarded run "
                         "(must divide --max-len)")
    ap.add_argument("--controller-mode", choices=("admission", "full"),
                    default="full",
                    help="degradation ladder for the SLO-guarded run")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the smoke engine (default cuda; "
                         "no silent CPU fallback)")
    args = ap.parse_args(argv)

    if args.slo_ttft_p99_ms is not None:
        return _overload_ab(args)

    tel = Telemetry()
    eng = _smoke_engine(tel, args.seed, args.verify_contracts,
                        args.slots, args.max_len, args.faults or args.smoke,
                        device=args.device)
    if args.trace:
        trace = load_trace(args.trace)
    else:
        trace = synthesize_trace(seed=args.seed, steps=args.steps,
                                 vocab=eng.cfg.vocab)
    report = Replayer(eng, trace, retry=RetryPolicy(backoff_s=0.0)).run()
    validate_report(report)
    if report["ttft_ms"]["count"] == 0:
        raise SystemExit("vacuous replay: no request produced a first "
                         "token — grow the trace")
    print(f"[replay] {report['requests']['submitted']} arrivals, "
          f"{report['engine_steps']} engine steps, "
          f"states={report['requests']['by_state']}")
    print(f"[replay] ttft_ms p50={report['ttft_ms']['p50']:.2f} "
          f"p90={report['ttft_ms']['p90']:.2f} "
          f"p99={report['ttft_ms']['p99']:.2f} "
          f"(n={report['ttft_ms']['count']})")
    print(f"[replay] tpot_ms p50={report['tpot_ms']['p50']:.2f} "
          f"p99={report['tpot_ms']['p99']:.2f} "
          f"(n={report['tpot_ms']['count']})")
    print(f"[replay] tokens/s/slot={report['tokens']['per_s_per_slot']:.1f} "
          f"preemptions={report['scheduling']['preemptions']} "
          f"resumes={report['scheduling']['resumes']}")
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"[replay] report -> {args.report_json}")
    if args.perfetto:
        write_perfetto(args.perfetto, tel)
        print(f"[replay] perfetto trace -> {args.perfetto}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
