"""Port parity on the five other dense configs: the smoke versions of
glm4_9b (qkv bias, partial RoPE), granite_8b (tied embeddings),
qwen2_1p5b (both), qwen3_32b (qk norm) and phi3_vision_4p2b (the vision
prefix stub), cut to vocab 128 and 2 layers, f32.

The reference's fp params cross into the port (``from_numpy_tree``); the
AP+OR CLAQ params are made once by the port's quantizer and cross back
into the reference (``to_numpy_tree``), so both packages hold the same
codes.  Right-padded prefill logits, the K/V caches and two decode steps'
logits then match the reference to atol 1e-4 (f32 sums in another
order), the qwen2_1p5b engines emit the same greedy tokens exactly, and a
(B, P, D) ``prefix_embeds`` reaches the model in both packages: logits,
caches over P + S positions and the loss.
"""
import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core.quantized import QuantizedTensor, QuantStripe  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import from_numpy_tree, to_numpy_tree  # noqa: E402
from repro_torch.core import APConfig, CLAQConfig, ORConfig  # noqa: E402
from repro_torch.data import calibration_set  # noqa: E402
from repro_torch.kernels.plan import prepare_tree  # noqa: E402
from repro_torch.launch.quantize import claq_quantize  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.serve import ServingEngine  # noqa: E402
from test_torch_models import ATOL, jax_tree_to_numpy  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCHS = ("glm4_9b", "granite_8b", "qwen2_1p5b", "qwen3_32b",
         "phi3_vision_4p2b")
QCFG = CLAQConfig(bits=2, method="kmeans", kmeans_iters=4,
                  gptq_blocksize=32, ap=APConfig(2.2, 2, 4),
                  orr=ORConfig(0.1))


def numpy_to_reference(tree):
    """The numpy tree (QuantizedTensors in dict form) as the reference's
    params."""
    if isinstance(tree, dict) and "stripes" in tree:
        return QuantizedTensor(
            stripes=tuple(QuantStripe(jnp.asarray(s["packed"]),
                                      jnp.asarray(s["codebook"]), s["bits"])
                          for s in tree["stripes"]),
            **{f: jnp.asarray(tree[f])
               for f in ("col_perm", "out_idx", "out_val", "out_count")},
            shape=tuple(tree["shape"]))
    if isinstance(tree, dict):
        return {k: numpy_to_reference(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def cfgs(arch):
    kw = dict(vocab=128, n_layers=2)
    jcfg = dataclasses.replace(get_smoke_config(arch), **kw)
    tcfg = dataclasses.replace(t_smoke(arch), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _build(arch):
    jcfg, tcfg = cfgs(arch)
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tm = from_numpy_tree(jax_tree_to_numpy(jp), tcfg, device="cpu")
    qm, report = claq_quantize(copy.deepcopy(tm), tcfg,
                               calibration_set(tcfg.vocab, 4, 32), QCFG)
    assert 2.0 < report.mean_effective_bits < 2.6
    jq = numpy_to_reference(to_numpy_tree(qm, tcfg))
    return jcfg, tcfg, {"fp": (jp, tm), "claq": (jq, prepare_tree(qm))}


@pytest.fixture(scope="module")
def built():
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = _build(arch)
        return made[arch]
    return get


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def _check_cache(tcache, jcache):
    for i, c in enumerate(tcache):
        _close(c.k, jcache.k[i])
        _close(c.v, jcache.v[i])
        np.testing.assert_array_equal(c.length.numpy(),
                                      np.asarray(jcache.length[i]))


@pytest.mark.parametrize("tag", ["fp", "claq"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_and_cache(built, arch, tag):
    jcfg, tcfg, m = built(arch)
    jp, tm = m[tag]
    rng = np.random.default_rng(1)
    lens = np.array([5, 9])
    toks = np.zeros((2, 16), np.int64)           # right-padded to a bucket
    for r, n in enumerate(lens):
        toks[r, :n] = rng.integers(0, jcfg.vocab, size=n)
    jcache = japi.make_cache(jcfg, 2, 32, dtype=jnp.float32)
    tcache = tapi.make_cache(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    jl, jcache = jax.jit(lambda p, t, c, at: japi.prefill_step(
        p, jcfg, {"tokens": t}, c, logits_at=at))(
        jp, jnp.asarray(toks, jnp.int32), jcache,
        jnp.asarray(lens - 1, jnp.int32))
    tl, tcache = tapi.prefill_step(tm, tcfg, {"tokens": torch.from_numpy(toks)},
                                   tcache,
                                   logits_at=torch.from_numpy(lens - 1))
    _close(tl, jl)
    _check_cache(tcache, jcache)
    jdec = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c))
    tok = np.asarray(jnp.argmax(jl, axis=-1))
    for _ in range(2):
        jl, jcache = jdec(jp, jnp.asarray(tok, jnp.int32), jcache)
        tl, tcache = tapi.decode_step(tm, tcfg, torch.tensor(tok), tcache)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1))
    _check_cache(tcache, jcache)


@pytest.mark.parametrize("tag", ["fp", "claq"])
def test_engine_tokens_exact_qwen2(built, tag):
    jcfg, tcfg, m = built("qwen2_1p5b")
    jp, tm = m[tag]
    prompts = [[1, 2], [3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15, 16],
               [20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32]]

    def serve(eng):
        uids = eng.add_requests(prompts, max_new_tokens=6)
        eng.run_to_completion()
        fin = eng.take_finished()
        return [fin[u].tokens for u in uids]

    want = serve(JaxEngine(jp, jcfg, n_slots=4, max_len=64, min_bucket=8))
    got = serve(ServingEngine(tm, tcfg, n_slots=4, max_len=64, min_bucket=8,
                              device="cpu"))
    assert all(len(t) == 6 for t in got)
    assert got == want


@pytest.mark.parametrize("tag", ["fp", "claq"])
def test_prefix_embeds_reach_the_model(built, tag):
    """The vision stub: prefill with a (B, P, D) prefix covers P + S
    positions in both packages, decode continues after it, and the loss
    skips the prefix positions."""
    jcfg, tcfg, m = built("phi3_vision_4p2b")
    jp, tm = m[tag]
    rng = np.random.default_rng(3)
    B, P, S = 2, 4, 7
    prefix = (rng.normal(size=(B, P, jcfg.d_model)) * 0.5).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, size=(B, S))
    jcache = japi.make_cache(jcfg, B, 32, dtype=jnp.float32)
    tcache = tapi.make_cache(tcfg, B, 32, dtype=torch.float32, device="cpu")
    jl, jcache = japi.prefill_step(
        jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32),
                   "prefix_embeds": jnp.asarray(prefix)}, jcache)
    tl, tcache = tapi.prefill_step(
        tm, tcfg, {"tokens": torch.from_numpy(toks),
                   "prefix_embeds": torch.from_numpy(prefix)}, tcache)
    _close(tl, jl)
    _check_cache(tcache, jcache)
    assert int(tcache[0].length[0]) == P + S
    tok = np.asarray(jnp.argmax(jl, axis=-1))
    jl, jcache = japi.decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32),
                                  jcache)
    tl, tcache = tapi.decode_step(tm, tcfg, torch.tensor(tok), tcache)
    _close(tl, jl)

    jloss, jmet = japi.loss_fn(jp, jcfg, {
        "tokens": jnp.asarray(toks, jnp.int32),
        "prefix_embeds": jnp.asarray(prefix)})
    tloss, tmet = tapi.loss_fn(tm, tcfg, {
        "tokens": torch.from_numpy(toks),
        "prefix_embeds": torch.from_numpy(prefix)})
    assert abs(float(tloss) - float(jloss)) < 1e-5
    assert abs(float(tmet["nll"]) - float(jmet["nll"])) < 1e-5
