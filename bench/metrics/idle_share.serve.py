"""The device: share of the traced window in which no kernel, copy or set
ran on the card (``torch.profiler``), in %."""


def read(rec):
    if rec.trace.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - rec.trace.busy_s / rec.trace.window_s)
