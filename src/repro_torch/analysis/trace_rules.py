"""Trace-level rules: the call-shape discipline (port of
``repro.analysis.trace_rules``).

The reference's jits are keyed on abstract signatures; PR 2's contract
is that admission bucketing bounds the number of distinct signatures,
and therefore compiles, by

    compile_budget = (ceil(log2(max_len / min_bucket)) + 1) * n_batch_buckets

per jit family.  PyTorch runs eagerly and traces nothing, so the port's
"traces" are the distinct operand shapes each call kind ran: the
engine's ``call_shapes`` sets and the bucketing policy's per-shape
stats, which ``stats()`` reports as the ``*_traces`` counters.  The
``TraceSentinel`` below is a second, independent record: the engine
calls ``observe(name, signature)`` at the reference's call sites, right
before each call, and these rules cross-check three numbers that must
agree:

  * distinct signatures observed per call kind (sentinel),
  * the engine's own count of distinct call shapes ("traces"),
  * the static budget from the bucketing config.

TRC-CC1 enforces the budget; TRC-SG1 catches a counter that drifted from
the calls: more "traces" than distinct signatures (plus the gate's
profiled steps, which ``observe_lowering`` records as the reference
records its ``.lower()`` calls) means a call site records a shape it
did not run; fewer means a call site runs without recording its shape.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Tuple

from .core import Finding, Rule, Severity, register


class TraceSentinel:
    """Host-side observer of call signatures.

    The engine calls ``observe(name, signature)`` right before every step
    call with a hashable signature key (the call's operand shape).
    ``lowerings`` counts steps run outside the call path (the contract
    gate's profiled decode; the reference's explicit ``.lower()``).
    """

    def __init__(self) -> None:
        self.signatures: Dict[str, collections.Counter] = (
            collections.defaultdict(collections.Counter))
        self.lowerings: collections.Counter = collections.Counter()

    def observe(self, jit_name: str, signature: Tuple[Any, ...]) -> None:
        self.signatures[jit_name][signature] += 1

    def observe_lowering(self, jit_name: str) -> None:
        self.lowerings[jit_name] += 1

    def distinct(self, jit_name: str) -> int:
        return len(self.signatures.get(jit_name, ()))

    def calls(self, jit_name: str) -> int:
        return sum(self.signatures.get(jit_name,
                                       collections.Counter()).values())

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        return {name: {"distinct": len(ctr), "calls": sum(ctr.values()),
                       "lowerings": self.lowerings.get(name, 0)}
                for name, ctr in sorted(self.signatures.items())}


class CompileCountBudget(Rule):
    id = "TRC-CC1"
    severity = Severity.ERROR
    invariant = ("distinct abstract signatures per jit stay within the "
                 "bucketing compile budget: "
                 "(ceil(log2(max_len/min_bucket))+1) * n_batch_buckets")
    origin = "PR 2"

    def check(self, ctx: Dict[str, Any]) -> Optional[List[Finding]]:
        sentinel: Optional[TraceSentinel] = ctx.get("sentinel")
        budgets: Optional[Dict[str, int]] = ctx.get("compile_budget")
        if sentinel is None or not budgets:
            return None
        out: List[Finding] = []
        for jit_name, budget in sorted(budgets.items()):
            distinct = sentinel.distinct(jit_name)
            if distinct > budget:
                out.append(self.finding(
                    f"{jit_name} saw {distinct} distinct signatures, "
                    f"budget is {budget}: bucketing is leaking shapes",
                    subject=jit_name, distinct=distinct, budget=budget,
                    calls=sentinel.calls(jit_name)))
        return out


class RetraceSentinel(Rule):
    id = "TRC-SG1"
    severity = Severity.ERROR
    invariant = ("a jit's actual trace count never exceeds distinct "
                 "signatures + explicit lowerings: more means the compile "
                 "cache is thrashing on a non-signature input")
    origin = "PR 8"

    def check(self, ctx: Dict[str, Any]) -> Optional[List[Finding]]:
        sentinel: Optional[TraceSentinel] = ctx.get("sentinel")
        traces: Optional[Dict[str, int]] = ctx.get("trace_counts")
        if sentinel is None or traces is None:
            return None
        out: List[Finding] = []
        for jit_name, n_traces in sorted(traces.items()):
            distinct = sentinel.distinct(jit_name)
            if distinct == 0 and n_traces == 0:
                continue
            allowed = distinct + sentinel.lowerings.get(jit_name, 0)
            if n_traces > allowed:
                out.append(self.finding(
                    f"{jit_name} traced {n_traces}x for only {distinct} "
                    f"distinct signatures (+{allowed - distinct} explicit "
                    f"lowerings): silent retrace",
                    subject=jit_name, traces=n_traces, distinct=distinct,
                    allowed=allowed))
            elif n_traces < distinct:
                out.append(self.finding(
                    f"{jit_name} reports {n_traces} traces for {distinct} "
                    f"distinct signatures: the trace counter itself is "
                    f"broken (traced fn no longer bumps it)",
                    subject=jit_name, traces=n_traces, distinct=distinct))
        return out


COMPILE_COUNT_BUDGET = register(CompileCountBudget())
RETRACE_SENTINEL = register(RetraceSentinel())

TRACE_RULES = [COMPILE_COUNT_BUDGET, RETRACE_SENTINEL]
