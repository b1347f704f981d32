"""The whole step: model FLOPs of the prompt and output tokens over the
seconds of the part of the window that ran without the profiler, times the
card's 989 TFLOP/s bf16 dense peak, in %.  A prompt admitted there counts
each position over its causal context and the head once; each later token
counts 2 x the weights it touches (its top-k experts only), the head and
attention over its context."""
from bench import roofline


def read(rec):
    run, m = rec.run, rec.model
    lo, hi = run.host_span()
    flops = 0.0
    for s in run.host_steps():
        for uid, _ in s.admit:
            flops += roofline.prefill_flops(m, len(run.requests[uid].prompt))
    for r in run.requests.values():
        for j, t in enumerate(r.times[1:], start=1):
            if lo < t <= hi:
                flops += roofline.decode_flops(m, len(r.prompt) + j)
    if flops <= 0:
        return None
    return 100.0 * flops / ((hi - lo) * roofline.PEAK_BF16_FLOPS)
