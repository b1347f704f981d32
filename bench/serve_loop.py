"""The closed loop of clients over the engine's ``submit`` / ``step``.

Timestamps are host clock readings (``time.perf_counter``) at the return
of ``step()``: the step has brought its tokens to the host, so its device
work is done.  The window opens at the end of the step that first fills
the slots and closes at the end of the step running ``seconds`` later, so
it holds whole steps (a prefill step can last seconds): what they emit is
its work, and their time its time.  Every step is recorded (when it started
and ended, which requests it admitted and into which slot, how many rows
its decode emitted) and every request (client, submit time, each token's
time).

A traced run serves the first half of its window untraced and the second
half under the profiler: the host clock's per-layer readings come from
the first half (``Run.host_span``), the device's from the second.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from .traffic import Traffic

DRAIN_LIMIT_S = 60.0


@dataclasses.dataclass
class Served:
    client: int
    prompt: List[int]
    max_new: int
    submit_t: float
    in_window: bool                  # submitted after the window opened
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    admit_step: int = -1
    slot: int = -1
    state: str = "queued"


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    admit: List[List[int]]           # [uid, slot] in admission order
    prompt_tokens: int               # true prompt tokens admitted
    emitted: int                     # rows the decode emitted
    in_window: bool                  # ended inside the window


@dataclasses.dataclass
class Run:
    requests: Dict[int, Served]
    steps: List[Step]
    first_step: int                  # the step of the first admissions
    window_open: float
    window_close: float              # the end of the step running at
                                     # window_open + the window's seconds
    n_slots: int
    split: Optional[float] = None    # the profiler started (traced runs)

    @property
    def window_s(self) -> float:
        return self.window_close - self.window_open

    def window_steps(self) -> List[Step]:
        return [s for s in self.steps if s.in_window]

    def host_span(self) -> Tuple[float, float]:
        """The part of the window that ran without the profiler."""
        return (self.window_open,
                self.window_close if self.split is None else self.split)

    def host_steps(self) -> List[Step]:
        """The window's steps that ended before the profiler started."""
        hi = self.host_span()[1]
        return [s for s in self.window_steps() if s.t1 <= hi]


def _span(trace: bool, name: str):
    if not trace:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)


class Loop:
    """One run of ``traffic`` on ``engine``."""

    def __init__(self, engine, traffic: Traffic):
        self.eng = engine
        self.traffic = traffic
        self.tracing = False                # under the profiler: spans on
        self.requests: Dict[int, Served] = {}
        self.steps: List[Step] = []
        self.next_req = [0] * len(traffic.clients)
        self.open: Dict[int, int] = {}      # uid -> client, not yet done
        self.in_window = False
        self.submitting = True
        self.close_at: Optional[float] = None
        self.closed_t = 0.0                 # the end of the window's last step

    def _submit(self, client: int) -> None:
        seq = self.traffic.clients[client]
        i = self.next_req[client]
        if i >= len(seq):
            raise RuntimeError(f"client {client} ran out of requests: raise "
                               f"requests_per_client")
        self.next_req[client] = i + 1
        r = seq[i]
        t = time.perf_counter()
        uid = self.eng.submit(r.prompt, max_new_tokens=r.max_new)
        self.requests[uid] = Served(client, r.prompt, r.max_new, t,
                                    self.in_window)
        self.open[uid] = client

    def step(self) -> None:
        eng = self.eng
        t0 = time.perf_counter()
        with _span(self.tracing, "bench::step"):
            emitted = eng.step()
        t1 = time.perf_counter()
        with _span(self.tracing, "bench::clients"):
            admit, prompt_tokens, done = [], 0, []
            for uid, client in self.open.items():
                req = eng.active.get(uid) or eng.finished.get(uid)
                if req is None:
                    continue                # still queued
                rec = self.requests[uid]
                if rec.admit_step < 0:
                    rec.admit_step = len(self.steps)
                    rec.slot = req.slot if req.slot >= 0 else rec.slot
                    admit.append([uid, rec.slot])
                    prompt_tokens += len(rec.prompt)
                new = len(req.tokens) - len(rec.times)
                rec.times.extend([t1] * new)
                if req.done:
                    rec.tokens = list(req.tokens)
                    rec.state = req.state.value
                    done.append(uid)
            closed = (self.in_window and self.close_at is not None
                      and t1 >= self.close_at)
            self.steps.append(Step(t0, t1, admit, prompt_tokens,
                                   len(emitted), self.in_window))
            if closed:
                self.closed_t = t1
                self.submitting = False     # no request after the close
            for uid in done:
                client = self.open.pop(uid)
                if self.submitting:
                    self._submit(client)

    def warm_up(self) -> None:
        """One short request through prefill and decode, alone."""
        w = self.traffic.warmup
        self.eng.submit(w.prompt, max_new_tokens=w.max_new)
        self.eng.run_to_completion(max_steps=w.max_new + 4)
        self.eng.take_finished()

    def first_admissions(self) -> int:
        """Every client's first request sent; the first step fills every
        slot, and the rest wait in the engine's queue."""
        for c in range(len(self.traffic.clients)):
            self._submit(c)
        self.step()
        admitted = sum(1 for r in self.requests.values()
                       if r.admit_step >= 0)
        if admitted < min(len(self.requests), self.traffic.slots):
            raise RuntimeError(f"the first step admitted {admitted} "
                               f"requests, not one a slot")
        return len(self.steps) - 1

    def window(self, seconds: float, tracer=None) -> Run:
        """Serve for ``seconds`` from now, the second half under
        ``tracer`` where one is given.  The step running at the close
        ends; then no more requests are sent, and steps go on until every
        request sent in the window has its first token (at most
        ``DRAIN_LIMIT_S``)."""
        first = len(self.steps) - 1
        split = None
        with contextlib.ExitStack() as stack:
            self.in_window = True
            t_open = time.perf_counter()
            self.close_at = t_open + seconds
            half = t_open + seconds / 2
            while self.submitting:
                self.step()
                if (tracer is not None and split is None and self.submitting
                        and self.steps[-1].t1 >= half):
                    split = time.perf_counter()
                    stack.enter_context(tracer)
                    self.tracing = True
            self.in_window = False
            self.tracing = False
        deadline = time.perf_counter() + DRAIN_LIMIT_S
        while (any(not self.requests[u].times and self.requests[u].in_window
                   for u in self.open)
               and time.perf_counter() < deadline):
            self.step()
        for uid in self.open:
            req = self.eng.active.get(uid) or self.eng.finished.get(uid)
            rec = self.requests[uid]
            if req is not None:
                rec.tokens = list(req.tokens)
                rec.state = req.state.value
        return Run(self.requests, self.steps, first, t_open,
                   self.closed_t, self.traffic.slots, split)
