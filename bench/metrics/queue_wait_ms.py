"""Engine (``serve/engine.py``: the admission queue in front of the
slots): mean host ms from a request's ``submit`` to the start of the step
that admitted it, over the requests sent in the window and admitted in
the part of it that ran without the profiler."""


def read(rec):
    run = rec.run
    hi = run.host_span()[1]
    waits = [run.steps[r.admit_step].t0 - r.submit_t
             for r in run.requests.values()
             if r.in_window and r.admit_step >= 0
             and run.steps[r.admit_step].t1 <= hi]
    if not waits:
        return None
    return sum(waits) * 1e3 / len(waits)
