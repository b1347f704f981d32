"""Step-artifact rules: invariants checked on the op trace of one profiled
decode step of the serving engine (port of ``repro.analysis.hlo_rules``,
which reads the compiled HLO of the reference's decode jit).

The seven rule ids and severities are the reference's, so reports of the
two packages compare rule for rule; each rule reads ``op_trace`` records
(``op_trace.py``) where the reference reads HLO instructions.

Context keys consumed (all optional unless a rule says otherwise; a rule
whose keys are absent returns None = skipped):

  * ``ops``: {name: OpTrace} — the steps under test.
  * ``dense_ops``: {name: OpTrace} — the same step of the dense twin (the
    engine over the dequantized weights), the gather-parity baseline.
  * ``plan``: plan-tree stats from ``artifacts.plan_stats``:
    {"has_plans", "n_permuted_groups", "max_bk", "bm", "itemsize"}.
  * ``weight_shard_bytes``: largest sharded plan-plane payload in bytes
    (None / absent on single-device engines -> collective rules skip).
  * ``collective_budget_bytes``: per-op collective budget (defaults to
    ``weight_shard_bytes``).
  * ``pool_slice_elems``: one layer's int8 page-pool slice element count
    (absent unless the engine holds int8 resident pages).
  * ``cache_leaf_bytes``: largest cache leaf in bytes (whole-cache-copy
    audit).
  * ``donation_expected``: bool — the engine updates its cache in place
    (the port's counterpart of buffer donation).

What each rule means in torch:

  * HLO-HT1: the step's one sanctioned transfer is ``_sample``'s (the
    tokens, with the guard counts, in one copy), so the invariant is
    exactly one ``to_host`` a step and no transfer outside the engine's
    two helpers (the reference's transfer sits outside its jit, so it
    asserts zero);
  * HLO-GA1 is scoped to K1: kernel-mode decode adds no torch gather over
    the dense twin (K1 gathers x inside the kernel: its scope is folded),
    and permuted groups reach K1 in "gathered" mode at most once a group at
    each call site; plans with no permuted group launch no gathered K1;
  * HLO-DN1: every cache leaf keeps its storage across the step (the port
    updates in place); a leaf returned as a new tensor is a WARNING;
  * HLO-DT1 / HLO-CP1 read the ``aten::copy_`` records: an s8 -> f32 copy
    wider than one layer's pool slice, a copy of a whole cache leaf;
  * HLO-AG1 / HLO-CB1 read c10d collective records; on one device they
    skip.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

from . import op_trace as T
from .core import Finding, Rule, Severity, register


class NoWeightAllGather(Rule):
    id = "HLO-AG1"
    severity = Severity.ERROR
    invariant = ("no all-gather in a serving step has a weight-shard-sized "
                 "result: decode moves activations between shards, never "
                 "the sharded CLAQ plan payload")
    origin = "PR 3"

    def check(self, ctx: Dict[str, Any]) -> Optional[List[Finding]]:
        threshold = ctx.get("weight_shard_bytes")
        ops = ctx.get("ops")
        if not ops or threshold is None:
            return None
        out: List[Finding] = []
        for name, trace in ops.items():
            big = [b for kind, b in T.collective_instructions(trace)
                   if kind == "all-gather" and b >= threshold]
            if big:
                out.append(self.finding(
                    f"weight-sized all-gather in {name}: "
                    f"{sorted(big, reverse=True)[:4]} B vs largest sharded "
                    f"plane {threshold} B",
                    subject=name, bytes=sorted(big, reverse=True),
                    threshold=threshold))
        return out


class CollectiveBudget(Rule):
    id = "HLO-CB1"
    severity = Severity.ERROR
    invariant = ("every collective in a serving step stays under the "
                 "per-op byte budget (activations are small; anything "
                 "bigger is a sharding regression)")
    origin = "PR 3"

    def check(self, ctx: Dict[str, Any]) -> Optional[List[Finding]]:
        budget = ctx.get("collective_budget_bytes",
                         ctx.get("weight_shard_bytes"))
        ops = ctx.get("ops")
        if not ops or budget is None:
            return None
        out: List[Finding] = []
        for name, trace in ops.items():
            over = [(kind, b) for kind, b in T.collective_instructions(trace)
                    if b >= budget]
            if over:
                out.append(self.finding(
                    f"collective(s) over the {budget} B budget in {name}: "
                    f"{over[:4]}",
                    subject=name, over=over, budget=budget))
        return out


class NoHostTransfer(Rule):
    id = "HLO-HT1"
    severity = Severity.ERROR
    invariant = ("a decode step makes exactly one device-to-host transfer "
                 "(the sampled tokens, through the engine's to_host) and no "
                 "other host transfer or sync outside the engine's helpers")
    origin = "PR 8"

    def check(self, ctx: Dict[str, Any]) -> Optional[List[Finding]]:
        ops = ctx.get("ops")
        if not ops:
            return None
        out: List[Finding] = []
        for name, trace in ops.items():
            hits = T.host_transfer_instructions(trace)
            if hits:
                out.append(self.finding(
                    f"host transfer in {name} outside the engine's "
                    f"helpers: {hits[:4]}",
                    subject=name, transfers=hits))
            n = T.transfer_counts(trace)["to_host"]
            if n != 1:
                out.append(self.finding(
                    f"{name} brought results to the host {n}x in one "
                    f"step: one transfer a step",
                    subject=name, to_host=n))
        return out


class DtypeDiscipline(Rule):
    id = "HLO-DT1"
    severity = Severity.ERROR
    invariant = ("int8 resident pages never silently upcast: no s8->f32 "
                 "copy wider than one layer's gathered pool slice "
                 "(dequant happens at the gathered view, never on the "
                 "whole pool)")
    origin = "PRs 5/7"

    def check(self, ctx: Dict[str, Any]) -> Optional[List[Finding]]:
        limit = ctx.get("pool_slice_elems")
        ops = ctx.get("ops")
        if not ops or limit is None:
            return None
        out: List[Finding] = []
        for name, trace in ops.items():
            wide = [(src, dst, n) for src, dst, n
                    in T.convert_instructions(trace)
                    if src in ("s8", "u8") and dst in ("f32", "f64")
                    and n > limit]
            if wide:
                out.append(self.finding(
                    f"pool-sized s8->f32 upcast in {name}: {wide[:4]} "
                    f"(limit {limit} elems — one layer's gathered slice)",
                    subject=name, converts=wide, limit_elems=limit))
        return out


class GatherParity(Rule):
    id = "HLO-GA1"
    severity = Severity.ERROR
    invariant = ("kernel-mode decode over CLAQ plans adds no torch gather "
                 "over the dense baseline (K1 gathers x in the kernel), and "
                 "permuted plan groups reach K1 'gathered' at most once a "
                 "group at each call site — never when every group is "
                 "x-aligned")
    origin = "PR 5"

    def check(self, ctx: Dict[str, Any]) -> Optional[List[Finding]]:
        ops = ctx.get("ops")
        base = ctx.get("dense_ops")
        plan = ctx.get("plan")
        if not ops or not base or not plan or not plan.get("has_plans"):
            return None
        out: List[Finding] = []
        for name, trace in ops.items():
            if name not in base:
                continue
            added = (collections.Counter(T.gather_instructions(trace))
                     - collections.Counter(T.gather_instructions(base[name])))
            if added:
                out.append(self.finding(
                    f"kernel-mode {name} adds {sum(added.values())} torch "
                    f"gather(s) over the dense twin: "
                    f"{sorted(added.elements())[:4]}",
                    subject=name, added=sorted(added.elements())))
            over = [(perm, modes) for perm, modes in T.kernel_sites(trace)
                    if modes.count("gathered") > perm]
            if over:
                out.append(self.finding(
                    f"{len(over)} prepared matmul(s) in {name} launch K1 "
                    f"'gathered' more often than their plan has permuted "
                    f"groups: {over[:4]}",
                    subject=name, sites=over[:16]))
            if plan["n_permuted_groups"] == 0:
                n = T.k1_modes(trace).get("gathered", 0)
                if n:
                    out.append(self.finding(
                        f"x-aligned plans must launch no gathered K1 in "
                        f"{name}: {n} gathered launches",
                        subject=name, gathered=n))
        return out


class WholeCacheCopy(Rule):
    id = "HLO-CP1"
    severity = Severity.WARNING
    invariant = ("the step contains no cache-sized copy — the slot cache "
                 "updates in place; the one known whole-cache copy lives in "
                 "admission, outside the step")
    origin = "PR 7"

    def check(self, ctx: Dict[str, Any]) -> Optional[List[Finding]]:
        limit = ctx.get("cache_leaf_bytes")
        ops = ctx.get("ops")
        if not ops or limit is None:
            return None
        out: List[Finding] = []
        for name, trace in ops.items():
            big = [b for op, b in T.copy_instructions(trace) if b >= limit]
            if big:
                out.append(self.finding(
                    f"cache-sized copy in {name}: "
                    f"{sorted(big, reverse=True)[:4]} B (largest cache "
                    f"leaf {limit} B)",
                    subject=name, bytes=sorted(big, reverse=True),
                    threshold=limit))
        return out


class CacheDonation(Rule):
    id = "HLO-DN1"
    severity = Severity.WARNING
    invariant = ("the step updates its cache in place (every cache leaf "
                 "keeps its storage) so decode never holds two live caches")
    origin = "PR 8"

    def check(self, ctx: Dict[str, Any]) -> Optional[List[Finding]]:
        ops = ctx.get("ops")
        if not ops or not ctx.get("donation_expected"):
            return None
        out: List[Finding] = []
        for name, trace in ops.items():
            moved = T.moved_leaves(trace)
            if moved:
                out.append(self.finding(
                    f"{len(moved)} cache leaves replaced, not updated in "
                    f"place, in {name}: {moved[:4]}",
                    subject=name, moved=moved))
        return out


NO_WEIGHT_ALLGATHER = register(NoWeightAllGather())
COLLECTIVE_BUDGET = register(CollectiveBudget())
NO_HOST_TRANSFER = register(NoHostTransfer())
DTYPE_DISCIPLINE = register(DtypeDiscipline())
GATHER_PARITY = register(GatherParity())
WHOLE_CACHE_COPY = register(WholeCacheCopy())
CACHE_DONATION = register(CacheDonation())

# named as the reference's list, so the two packages export the same names
HLO_RULES = [NO_WEIGHT_ALLGATHER, COLLECTIVE_BUDGET, NO_HOST_TRANSFER,
            DTYPE_DISCIPLINE, GATHER_PARITY, WHOLE_CACHE_COPY,
            CACHE_DONATION]
