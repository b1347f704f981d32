"""Port parity for the hybrid family (Mamba2 + one shared windowed
attention block) on the smoke ``zamba2_1p2b`` (vocab 128, 6 Mamba2
layers, a shared site every 2 of them: 3 sites, window 64, d 128, state
16, chunk 16, f32): the reference's params cross in through
``from_numpy_tree``; the same numpy-seeded inputs go through both
packages.

``_ssd_chunked`` with T not a multiple of the chunk, with and without an
initial state, in f32 and bf16; ``mamba_block`` chunked and in decode;
forward logits, ``loss_fn`` and its gradients; prefill then decode
(logits and every cache leaf: the layers' conv/ssm state and the sites'
ring caches) for a prompt shorter than the window, one longer (the
prefill rolls the ring) and decode steps that wrap it, fp and CLAQ;
``ServingEngine`` tokens and ``stats()`` equal to the JAX engine's with a
preemption and resume; a dense config whose window is shorter than its
linear cache.  f32 logits and caches agree to 1e-4, tokens and integer
leaves exactly.  Calibration, the quantizer, checkpoints and the
launchers are in ``test_torch_hybrid_pipeline.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import api as japi  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402
from test_torch_models import jax_tree_to_numpy  # noqa: E402
from test_torch_rwkv import (ATOL, build, check_caches, close,  # noqa: E402
                             engine_parity, refusals)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def hy():
    made = build("zamba2_1p2b")
    assert (made["tcfg"].n_layers, made["tcfg"].n_sites,
            made["tcfg"].attn_window) == (6, 3, 64)
    return made


def _ssd_inputs(rng, B, T, H, P, N):
    x = rng.normal(size=(B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(-1.0, 0.5, size=(B, T, H)))).astype(
        np.float32)
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, T, N)).astype(np.float32)
              for _ in range(2))
    s0 = rng.normal(size=(B, H, P, N)).astype(np.float32) * 0.1
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_chunked_matches_reference(dtype, init):
    """T = 37 over 16-token chunks (padded), with and without a carried
    state.  bf16: x/B/C in bf16, and the operands the reference rounds to
    the activation dtype (w_ts, sdecay, exp(cum), S_in) rounded alike,
    then summed in f32 — 1e-4 of the output's scale in both dtypes."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(np.random.default_rng(0), 2, 37, 3,
                                       8, 16)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    jy, jS = jm2._ssd_chunked(
        jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A),
        jnp.asarray(Bm, jdt), jnp.asarray(Cm, jdt), 16,
        jnp.asarray(s0) if init else None)
    ty, tS = tm2._ssd_chunked(
        torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
        torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
        torch.from_numpy(Cm).to(tdt), 16,
        torch.from_numpy(s0) if init else None)
    assert ty.shape == (2, 37, 3, 8) and tS.shape == (2, 3, 8, 16)
    close(ty, jy, ATOL * max(1.0, float(np.abs(np.asarray(jy)).max())))
    close(tS, jS, ATOL * max(1.0, float(np.abs(np.asarray(jS)).max())))


@pytest.mark.parametrize("mode", ["chunked", "decode"])
def test_mamba_block(hy, mode):
    """One Mamba2 block from a cache carrying conv inputs and an SSM
    state: 21 tokens through the chunked SSD, or one O(1) decode step."""
    jcfg, tcfg = hy["jcfg"], hy["tcfg"]
    rng = np.random.default_rng(3)
    T = 21 if mode == "chunked" else 1
    x = rng.normal(size=(2, T, 128)).astype(np.float32)
    d_inner, H, conv_dim = tm2.mamba_dims(tcfg)
    cache = dict(
        conv=rng.normal(size=(2, tcfg.ssm_conv - 1, conv_dim)).astype(
            np.float32),
        ssm=rng.normal(size=(2, H, tcfg.ssm_headdim, tcfg.ssm_state)).astype(
            np.float32) * 0.1,
        length=np.array([5, 9], np.int32))
    jc = jm2.MambaCache(**{k: jnp.asarray(v) for k, v in cache.items()})
    tc = tm2.MambaCache(**{k: torch.from_numpy(v) for k, v in cache.items()})
    jb = jax.tree_util.tree_map(lambda a: a[0], hy["jp"]["blocks"])
    jy, jnew = jm2.mamba_block(jb, jnp.asarray(x), jcfg, jc)
    ty, tnew = tm2.mamba_block(hy["tm"].blocks[0].mamba, torch.from_numpy(x),
                               tcfg, tc)
    close(ty, jy)
    check_caches([tnew], jax.tree_util.tree_map(lambda a: a[None], jnew))
    # without a cache: the same output as from an empty one
    jy0, _ = jm2.mamba_block(jb, jnp.asarray(x), jcfg)
    ty0, none = tm2.mamba_block(hy["tm"].blocks[0].mamba,
                                torch.from_numpy(x), tcfg)
    assert none is None
    close(ty0, jy0)


def test_forward_loss_and_gradients(hy):
    jcfg, tcfg, jp, tm = hy["jcfg"], hy["tcfg"], hy["jp"], hy["tm"]
    toks = np.random.default_rng(4).integers(1, 128, size=(2, 23))
    jlog, _, _ = jax.jit(lambda p, t: japi.tf.forward(p, jcfg, t))(
        jp, jnp.asarray(toks))
    tlog, _, _ = tapi.tf.forward(tm, tcfg, torch.from_numpy(toks))
    close(tlog, jlog)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(jp)
    tl, _, tg = loss_and_grads(tm, tcfg, {"tokens": torch.from_numpy(toks)})
    assert abs(float(tl) - float(jl)) < 1e-5
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [n for n, _ in tree_lib.flatten(tg)] == [
        jax.tree_util.keystr(p) for p, _ in jflat]
    assert "['site_lora']['lora_a']" in [n for n, _ in tree_lib.flatten(tg)]
    for (name, g), (_, want) in zip(tree_lib.flatten(tg), jflat):
        got = (torch.stack(list(g)) if isinstance(g, tree_lib.LayerStack)
               else g)
        want = np.asarray(want)
        close(got, want, ATOL * max(1.0, float(np.abs(want).max())))


def _check_hybrid_caches(tc, jc, tcfg):
    L = tcfg.n_layers
    check_caches(tc[:L], jc["mamba"])
    check_caches(tc[L:], jc["attn"])


def _prefill_decode(hy, tag, S, steps, max_len=128):
    jcfg, tcfg = hy["jcfg"], hy["tcfg"]
    jp, tm = (hy["jp"], hy["tm"]) if tag == "fp" else (hy["jq"], hy["qm"])
    toks = np.random.default_rng(S).integers(1, 128, size=(2, S))
    jc = japi.make_cache(jcfg, 2, max_len, dtype=jnp.float32)
    tc = tapi.make_cache(tcfg, 2, max_len, torch.float32, "cpu")
    W = tcfg.attn_window
    assert tc[-1].k.shape[1] == W == jc["attn"].k.shape[2]
    jl, jc = jax.jit(lambda p, t, c: japi.prefill_step(
        p, jcfg, {"tokens": t}, c))(jp, jnp.asarray(toks), jc)
    jdec = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c))
    tl, tc = tapi.prefill_step(tm, tcfg, {"tokens": torch.from_numpy(toks)},
                               tc)
    close(tl, jl)
    _check_hybrid_caches(tc, jc, tcfg)
    for _ in range(steps):
        tok = np.asarray(jl).argmax(-1)
        jl, jc = jdec(jp, jnp.asarray(tok), jc)
        tl, tc = tapi.decode_step(tm, tcfg, torch.from_numpy(tok), tc)
        close(tl, jl)
    _check_hybrid_caches(tc, jc, tcfg)
    return tc


@pytest.mark.parametrize("S,steps", [(60, 6), (70, 4)])
def test_ring_prefill_decode_wraps(hy, S, steps):
    """S < W fills the ring's first S slots and 6 decode steps wrap it;
    S >= W keeps the last W keys rolled so position p sits in slot
    p % W, and decode overwrites the oldest."""
    tc = _prefill_decode(hy, "fp", S, steps)
    assert int(tc[-1].length[0]) == S + steps > hy["tcfg"].attn_window


def test_quantized_prefill_decode(hy):
    _prefill_decode(hy, "claq", 11, 3)


def test_engine_tokens_and_stats_with_preemption(hy):
    """fp weights (the CLAQ engine is held on rwkv; the CLAQ hybrid's
    logits in ``test_quantized_prefill_decode``)."""
    engine_parity(hy["jp"], hy["jcfg"], hy["tm"], hy["tcfg"])


def test_engine_refuses_speculation_paging_and_chunking(hy):
    refusals(hy["tm"], hy["tcfg"])


def test_windowed_linear_cache_matches_reference():
    """A dense config with a window shorter than its cache keeps a linear
    cache: prefill (chunked, uniform fill) and decode mask keys older
    than the window, as the reference's ``_decode_attention`` and
    ``blocked_attention`` do; logits and caches to 1e-4 over steps that
    pass the window."""
    from test_torch_rwkv import pair
    jcfg, tcfg = pair("llama1_7b", n_layers=2, attn_window=6)
    jp = japi.init_params(jax.random.PRNGKey(3), jcfg)
    tm = from_numpy_tree(jax_tree_to_numpy(jp), tcfg, device="cpu")
    toks = np.random.default_rng(9).integers(1, 128, size=(2, 9))
    jc = japi.make_cache(jcfg, 2, 32, dtype=jnp.float32)
    tc = tapi.make_cache(tcfg, 2, 32, torch.float32, "cpu")
    assert tc[0].k.shape[1] == 32 > tcfg.attn_window
    jl, jc = japi.prefill_step(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = tapi.prefill_step(tm, tcfg, {"tokens": torch.from_numpy(toks)},
                               tc)
    close(tl, jl)
    for _ in range(4):
        tok = np.asarray(jl).argmax(-1)
        jl, jc = japi.decode_step(jp, jcfg, jnp.asarray(tok), jc)
        tl, tc = tapi.decode_step(tm, tcfg, torch.from_numpy(tok), tc)
        close(tl, jl)
    check_caches(tc, jc)
    # the window masks something: without it the prefill reads otherwise
    full = dataclasses.replace(tcfg, attn_window=None)
    lf, _ = tapi.prefill_step(tm, full, {"tokens": torch.from_numpy(toks)},
                              tapi.make_cache(full, 2, 32, torch.float32,
                                              "cpu"))
    assert not torch.allclose(lf, tapi.prefill_step(
        tm, tcfg, {"tokens": torch.from_numpy(toks)},
        tapi.make_cache(tcfg, 2, 32, torch.float32, "cpu"))[0])
