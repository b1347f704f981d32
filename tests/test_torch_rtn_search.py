"""Port parity for the quantizer's leftovers: ``core.rtn`` (the RTN
baselines: a uniform min-max grid, K-Means codebooks without GPTQ) and
``core.search`` (the cross-matrix adaptive-precision search, paper
Appendix G).  Codes and assignments are equal to the reference's;
uniform grids and Q to f32 rounding of the grid arithmetic (atol 1e-6),
K-Means codebooks to 1e-5 (Lloyd sums in another order)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import CLAQConfig as JCLAQ  # noqa: E402
from repro.core.rtn import rtn_quantize_matrix as j_rtn  # noqa: E402
from repro.core.search import (MatrixInfo as JInfo,  # noqa: E402
                               assignment_to_claq_configs as j_assign,
                               heuristic_ap_search as j_search)
from repro_torch.core import (CLAQConfig, MatrixInfo,  # noqa: E402
                              assignment_to_claq_configs,
                              heuristic_ap_search, rtn_quantize_matrix)

jax.config.update("jax_platform_name", "cpu")


def _matrix(seed, rows=64, cols=48):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(rows, cols)).astype(np.float32)
    W[rng.random((rows, cols)) < 0.02] *= 8          # a few outliers
    mask = np.abs(W) > 2.5
    return W, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_rtn_uniform_equals_reference(bits, masked):
    W, mask = _matrix(bits)
    m = mask if masked else None
    jq, jc, jcb = j_rtn(jnp.asarray(W), bits, "uniform",
                        reserved_mask=None if m is None else jnp.asarray(m))
    tq, tc, tcb = rtn_quantize_matrix(
        torch.from_numpy(W), bits, "uniform",
        reserved_mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tcb.numpy(), np.asarray(jcb), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6, rtol=0)
    if masked:
        np.testing.assert_array_equal(tq.numpy()[mask], W[mask])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bits", [2, 3])
def test_rtn_kmeans_equals_reference(bits, masked):
    W, mask = _matrix(10 + bits)
    m = mask if masked else None
    jq, jc, jcb = j_rtn(jnp.asarray(W), bits, "kmeans", kmeans_iters=6,
                        reserved_mask=None if m is None else jnp.asarray(m))
    tq, tc, tcb = rtn_quantize_matrix(
        torch.from_numpy(W), bits, "kmeans", kmeans_iters=6,
        reserved_mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tcb.numpy(), np.asarray(jcb), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5, rtol=0)


def test_rtn_rejects_unknown_method():
    with pytest.raises(ValueError):
        rtn_quantize_matrix(torch.zeros(4, 4), 2, "nearest")


def _infos(seed, n):
    rng = np.random.default_rng(seed)
    shapes = [(128, 128), (256, 128), (128, 344), (4096, 4096)]
    return [(f"m{i}", *shapes[i % len(shapes)], float(r))
            for i, r in enumerate(rng.random(n))]


CASES = [("paper_e2e", _infos(0, 24), 2.5)] + [
    (f"seed{s}", _infos(s, n), t)
    for s, n, t in ((1, 7, 2.2), (2, 40, 2.3), (3, 3, 3.0), (4, 70, 2.15))]


@pytest.mark.parametrize("name,infos,target", CASES,
                         ids=[c[0] for c in CASES])
def test_ap_search_equals_reference(name, infos, target):
    if name == "paper_e2e":       # the case of tests/test_pipeline_e2e.py
        infos = [(n, 128, 128, r) for n, _, _, r in infos]
    want = j_search([JInfo(*i) for i in infos], target_bits=target)
    got = heuristic_ap_search([MatrixInfo(*i) for i in infos],
                              target_bits=target)
    assert got.assignment == want.assignment
    assert got.avg_bits == want.avg_bits
    assert got.score == want.score
    assert got.avg_bits <= target + 1e-9

    tc = assignment_to_claq_configs(got, CLAQConfig(bits=2))
    jc = j_assign(want, JCLAQ(bits=2))
    assert sorted(tc) == sorted(jc)
    for k in tc:
        assert dataclasses.asdict(tc[k]) == dataclasses.asdict(jc[k])
