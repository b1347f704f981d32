"""Faults planted in the timed path underneath a run, each a context
manager: a decode step that returns its caches unchanged, half of the
batch's logits replaced by the mean of the other half's, a sampled token
altered where it is produced.  A run under any of them has to come out not
correct (``bench/tests/test_bench_faults.py`` on the CPU, ``limits.py
--fault`` on the card)."""
import contextlib


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def keeps_state():
    from repro_torch.models import api

    def make(orig):
        def step(params, cfg, token, cache):
            logits, _ = orig(params, cfg, token, cache)
            return logits, cache       # the caches' fill never advances
        return step
    return _patched(api, "decode_step", make)


def half_batch():
    from repro_torch.models import api

    def make(orig):
        def step(params, cfg, token, cache):
            logits, out = orig(params, cfg, token, cache)
            half = logits.shape[0] // 2
            logits = logits.clone()
            logits[half:] = logits[:half].mean(0)   # the rest's mean
            return logits, out
        return step
    return _patched(api, "decode_step", make)


def altered_token():
    from repro_torch.serve import engine as engine_lib
    count = [0]

    def make(orig):
        def sample(self, logits, split=False):
            toks, nf = orig(self, logits, split)
            count[0] += 1
            toks = toks.copy()
            row = count[0] % toks.shape[0]
            toks[row] = (toks[row] + 1) % logits.shape[-1]
            return toks, nf
        return sample
    return _patched(engine_lib.ServingEngine, "_sample", make)


FAULTS = {"keeps_state": keeps_state, "half_batch": half_batch,
          "altered_token": altered_token}
