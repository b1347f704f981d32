"""Reading a ``torch.profiler`` window: device busy time, device time under
the program's op-trace scopes, the top device operations, and the idle
gaps named by what the host was doing.

The reader walks the profiler's raw event list once (the kineto result,
before torch builds its own event tree, which takes far longer on a
window of millions of ops).  Host ops and annotations are the host events
that link to no other (runtime calls link to the op that made them); a
device operation (a kernel, a memcpy or a memset) is a device event whose
name no host event has (the device's copies of annotations do).  It was
launched where the host op it links to started or, where it links to
none, where the runtime call of its correlation id ran: K1 is launched
through ``ctypes`` inside its annotation, with no op of its own.  It
belongs to a scope when that launch lies inside one of the scope's ranges
on the same thread; a scope none of whose launches is found reads the busy
time inside the device's copies of its annotation.  Times are in
seconds.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

from .stats import merge_intervals

MAIN_SPAN = "bench::step"
TOP = 10


@dataclasses.dataclass
class Summary:
    window_s: float                   # first to last host event
    busy_s: float                     # union of device operations
    scope_s: Dict[str, float]         # device time under each scope prefix
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    n_events: int


def profiler():
    """A profiler of host ops and device activity, shapes and memory off."""
    import torch
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(activities=[act.CPU, act.CUDA],
                                  record_shapes=False, profile_memory=False,
                                  with_stack=False)


def raw_events(prof) -> list:
    """The profiler's raw event list (kineto's), without its event tree."""
    res = getattr(prof.profiler, "kineto_results", None)
    if res is None:
        raise RuntimeError("the profiler kept no kineto result")
    return res.events()


# CUDA runtime and driver calls (cudaLaunchKernel, cuLaunchKernelEx, ...)
RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def summarize(events: Sequence, scopes: Sequence[str]) -> Summary:
    """Read ``events`` (``raw_events``); ``scopes`` are name prefixes of
    host annotations whose device time is wanted."""
    from torch.autograd import DeviceType
    dev: List[Tuple[int, int, str, int, int]] = []
    host_start: Dict[int, Tuple[int, int]] = {}
    launch: Dict[int, Tuple[int, int]] = {}
    ranges = {s: collections.defaultdict(list) for s in scopes}
    main_tid: Optional[int] = None
    host: List[Tuple[int, int, int, str]] = []
    lo, hi = None, None
    for e in events:
        dt = e.device_type()
        if dt == DeviceType.CPU:
            s, tid, name = e.start_ns(), e.start_thread_id(), e.name()
            t = s + e.duration_ns()
            host.append((s, t, tid, name))
            lo = s if lo is None else min(lo, s)
            hi = t if hi is None else max(hi, t)
            if e.linked_correlation_id() or RUNTIME.match(name):
                launch[e.correlation_id()] = (s, tid)
                continue
            host_start[e.correlation_id()] = (s, tid)
            if name == MAIN_SPAN:
                main_tid = tid
            for p in scopes:
                if name.startswith(p):
                    ranges[p][tid].append((s, t))
        elif dt == DeviceType.CUDA:
            s = e.start_ns()
            dev.append((s, s + e.duration_ns(), e.name(),
                        e.correlation_id(), e.linked_correlation_id()))
    host_names = {h[3] for h in host}
    marks = [d for d in dev if d[2] in host_names]
    dev = [d for d in dev if d[2] not in host_names]
    busy = merge_intervals((d[0], d[1]) for d in dev)
    merged = {p: {tid: merge_intervals(r) for tid, r in by.items()}
              for p, by in ranges.items()}
    starts = {p: {tid: [s for s, _ in r] for tid, r in by.items()}
              for p, by in merged.items()}
    scope_ns = {p: 0 for p in scopes}
    by_name: Dict[str, int] = collections.defaultdict(int)
    for s, t, name, corr, link in dev:
        by_name[name] += t - s
        at = host_start.get(link) if link else None
        if at is None:
            at = launch.get(corr)
        if at is None:
            continue
        for p in scopes:
            r = merged[p].get(at[1])
            if not r:
                continue
            i = bisect.bisect_right(starts[p][at[1]], at[0]) - 1
            if i >= 0 and at[0] < r[i][1]:
                scope_ns[p] += t - s
    for p in scopes:
        if not scope_ns[p]:
            # no launch found inside the scope: read its device time as
            # the busy time inside the device's copies of its annotation
            scope_ns[p] = _overlap(busy, merge_intervals(
                (d[0], d[1]) for d in marks if d[2].startswith(p)))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = _idle_gaps(busy, lo, hi, [h for h in host if h[2] == main_tid])
    return Summary(
        window_s=0.0 if lo is None else (hi - lo) / 1e9,
        busy_s=sum(t - s for s, t in busy) / 1e9,
        scope_s={p: v / 1e9 for p, v in scope_ns.items()},
        device_ops=[(_short(n), v / 1e9) for n, v in top],
        idle_gaps=gaps, n_events=len(events))


def _overlap(a, b) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _short(name: str, n: int = 100) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def _idle_gaps(busy, lo, hi, host) -> List[Tuple[str, float]]:
    """Idle device time between ``lo`` and ``hi`` summed by what the main
    thread was in at each gap's middle: its outermost and innermost host
    events (``host``: (start, end, tid, name) of that thread)."""
    if lo is None:
        return []
    gaps, prev = [], lo
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if hi > prev:
        gaps.append((prev, hi))
    host.sort(key=lambda h: (h[0], -h[1]))
    total: Dict[str, int] = collections.defaultdict(int)
    stack: List[Tuple[int, int, int, str]] = []
    i = 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        live = [h for h in stack if h[1] > mid]
        if not live:
            name = "host outside any op"
        elif len(live) == 1:
            name = live[0][3]
        else:
            name = f"{live[0][3]} > {live[-1][3]}"
        total[_short(name)] += g1 - g0
    top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
    return [(n, v / 1e9) for n, v in top]
