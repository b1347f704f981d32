"""Model step, decode (``models/api.decode_step``): mean host ms of the
steps that admitted nothing, in the part of the window that ran without
the profiler."""


def read(rec):
    steps = [s for s in rec.run.host_steps() if not s.admit and s.emitted]
    if not steps:
        return None
    return sum(s.t1 - s.t0 for s in steps) * 1e3 / len(steps)
