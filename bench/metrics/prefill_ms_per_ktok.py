"""Model step, prefill (``models/api.prefill_step``): host ms of the steps
that admitted requests, per thousand prompt tokens they admitted (the
step's decode of the other slots included), in the part of the window
that ran without the profiler."""


def read(rec):
    steps = [s for s in rec.run.host_steps() if s.admit]
    tokens = sum(s.prompt_tokens for s in steps)
    if not tokens:
        return None
    return sum(s.t1 - s.t0 for s in steps) * 1e3 / (tokens / 1e3)
