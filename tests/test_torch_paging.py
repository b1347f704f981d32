"""Port parity for the page bookkeeping: ``repro_torch.serve.paging`` is a
copy of ``repro.serve.paging``, and a seeded stream of allocator and
prefix-registry operations (alloc, retain, free, writable / copy-on-write,
register, lookup, evict) driven through both gives the same return value
or the same exception at every step, and the same refcounts, free list and
registry afterwards."""
import numpy as np
import pytest

from repro.serve import paging as jpg
from repro_torch.serve import paging as tpg
from repro_torch.serve.lifecycle import AdmissionRejected

N_PAGES, PAGE_SIZE = 12, 4


def _outcome(fn, *args):
    """(result, None) or (None, exception type name): exceptions are part
    of the decision stream (PoolExhausted is typed backpressure)."""
    try:
        return fn(*args), None
    except (ValueError, jpg.PoolExhausted, tpg.PoolExhausted) as e:
        return None, type(e).__name__


def _state(alloc, reg):
    return (list(alloc._free), dict(alloc._refs), alloc.pages_in_use,
            alloc.pages_allocated_total, alloc.pages_freed_total,
            [(k, list(p), n) for k, (p, n) in reg._entries.items()])


def _drive(mod, seed, steps=300):
    """Apply a seeded operation stream to one package's allocator and
    registry; returns the list of outcomes and the states after each."""
    rng = np.random.default_rng(seed)
    alloc = mod.PageAllocator(N_PAGES, PAGE_SIZE)
    reg = mod.PrefixRegistry(alloc)
    held = []          # page lists the stream holds references to
    prompts = [list(rng.integers(1, 6, size=rng.integers(1, 14)))
               for _ in range(8)]
    log = []
    for _ in range(steps):
        op = rng.integers(0, 8)
        if op == 0:
            out = _outcome(alloc.alloc, int(rng.integers(0, 5)))
            if out[0]:
                held.append(out[0])
        elif op == 1 and held:
            pages = held[int(rng.integers(0, len(held)))]
            out = _outcome(alloc.retain, pages)
            if out[1] is None:
                held.append(list(pages))
        elif op == 2 and held:
            out = _outcome(alloc.free, held.pop(int(rng.integers(
                0, len(held)))))
        elif op == 3 and held:
            pages = held[int(rng.integers(0, len(held)))]
            if pages:
                i = int(rng.integers(0, len(pages)))
                out = _outcome(alloc.writable, pages[i])
                if out[0] is not None and out[0][1]:
                    pages[i] = out[0][0]      # this holder moved to the copy
            else:
                out = ("empty", None)
        elif op == 4 and held:
            pages = held[int(rng.integers(0, len(held)))]
            p = prompts[int(rng.integers(0, len(prompts)))]
            out = _outcome(reg.register, p, pages)
        elif op == 5:
            p = prompts[int(rng.integers(0, len(prompts)))]
            ext = p + list(rng.integers(1, 6, size=rng.integers(0, 6)))
            out = _outcome(reg.lookup, ext, bool(rng.integers(0, 2)))
        elif op == 6:
            out = _outcome(reg.evict_one)
        elif op == 7:
            # bad ids: freeing / retaining pages nobody holds
            bad = [int(rng.integers(0, N_PAGES + 2))]
            out = _outcome(alloc.free if rng.integers(0, 2) else alloc.retain,
                           bad)
        else:
            out = ("noop", None)
        refs = [alloc.refcount(p) for p in range(N_PAGES + 1)]
        log.append((int(op), out, refs, alloc.n_free, len(reg)))
    reg.clear()
    log.append(_state(alloc, reg))
    return log


@pytest.mark.parametrize("seed", range(6))
def test_seeded_operation_stream_matches_reference(seed):
    want = _drive(jpg, seed)
    got = _drive(tpg, seed)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
    # the stream exercised every decision it is meant to compare
    kinds = {(op, out[1]) for op, out, *_ in want[:-1]}
    assert (0, "PoolExhausted") in kinds
    assert any(op == 3 and out[0] not in (None, "empty") and out[0][1]
               for op, out, *_ in want[:-1]), "no copy-on-write happened"
    assert any(op == 5 and out[0] is not None and out[0][0] > 0
               for op, out, *_ in want[:-1]), "no prefix was ever shared"


def test_pool_exhausted_is_typed_backpressure():
    assert issubclass(tpg.PoolExhausted, AdmissionRejected)
    a = tpg.PageAllocator(n_pages=3, page_size=8)
    a.alloc(2)
    with pytest.raises(tpg.PoolExhausted):
        a.alloc(2)
    assert a.n_free == 1 and a.alloc(1) == [2]

