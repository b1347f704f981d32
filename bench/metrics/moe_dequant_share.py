"""MoE experts (``models/moe.py`` ``expert_weight`` through the plan's
dequantize): device time under the ``repro_torch::dequantize`` scopes over
the device's busy time in the traced window, in %."""

SCOPES = ("repro_torch::dequantize",)


def read(rec):
    t = rec.trace.scope_s.get(SCOPES[0], 0.0)
    if t <= 0 or rec.trace.busy_s <= 0:
        return None
    return 100.0 * t / rec.trace.busy_s
