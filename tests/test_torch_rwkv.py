"""Port parity for the rwkv family on the smoke ``rwkv6_7b`` (vocab 128,
2 layers, d 128, 8 heads of 16, chunk 8, f32): the reference's params
cross in through ``from_numpy_tree``; the same numpy-seeded inputs go
through both packages.

``_wkv_chunked`` with T not a multiple of the chunk, with and without an
initial state, in f32 and bf16; ``time_mix``/``channel_mix`` chunked and
in decode; forward logits, ``loss_fn`` and its gradients; prefill then
decode (logits and every cache leaf) of the fp and the CLAQ model; the
chunked prefill against recurrent decode steps; ``ServingEngine`` tokens
and ``stats()`` equal to the JAX engine's with a preemption and resume;
calibration tap names; the quantizer's codes (weight space) and the keys
it quantizes with a Hessian and with the identity (the port's Hessians
fed to both quantizers); a checkpoint written by each package and
restored by the other; the CPU launchers.  f32 logits and caches agree to
1e-4, tokens, codes and integer leaves exactly.

The helpers here (``pair``, ``check_caches``, ``hessian_keys``,
``checkpoint_both_ways``) serve ``test_torch_hybrid.py`` and
``test_torch_encdec.py`` too."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.core import CLAQConfig as JCLAQ  # noqa: E402
from repro.data import calibration_set as jcalib  # noqa: E402
from repro.launch import quantize as jlq  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import (from_numpy_tree, param_tree,  # noqa: E402
                                 to_numpy_tree)
from repro_torch.core import APConfig, CLAQConfig, ORConfig  # noqa: E402
from repro_torch.kernels.plan import prepare_tree  # noqa: E402
from repro_torch.launch import quantize as tlq  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.serve import ServingEngine, SpecConfig  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402
from test_torch_dense_configs import numpy_to_reference  # noqa: E402
from test_torch_models import jax_tree_to_numpy  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ATOL = 1e-4
QCFG = dict(bits=2, method="kmeans", kmeans_iters=4, gptq_blocksize=32)
AP_OR = dict(ap=APConfig(2.2, 2, 4), orr=ORConfig(0.1))
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10, 11],
           [12, 13, 14, 15, 16, 17, 18]]


# ------------------------------------------------------------- helpers

def pair(arch, **kw):
    """The same smoke config from both packages (vocab 128)."""
    kw = dict(dict(vocab=128), **kw)
    jcfg = dataclasses.replace(get_smoke_config(arch), **kw)
    tcfg = dataclasses.replace(t_smoke(arch), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def build(arch, **kw):
    """Reference fp params, their port, the port's AP+OR quantization of
    the same weights (its own calibration) and that model back in the
    reference."""
    jcfg, tcfg = pair(arch, **kw)
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tm = from_numpy_tree(jax_tree_to_numpy(jp), tcfg, device="cpu")
    calib = torch.from_numpy(np.array(jcalib(vocab=128, n_segments=4,
                                             seq_len=32)))
    if tcfg.family == "encdec":
        calib = calib[:, :16]
    qm, rep = tlq.claq_quantize(
        from_numpy_tree(jax_tree_to_numpy(jp), tcfg, device="cpu"), tcfg,
        calib, CLAQConfig(**QCFG, **AP_OR), batch_size=2)
    assert 2.0 < rep.mean_effective_bits < 2.6
    jq = numpy_to_reference(to_numpy_tree(qm, tcfg))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tm=tm, jq=jq,
                qm=prepare_tree(qm), calib=calib)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def check_caches(tcaches, jstacked):
    """The port's per-layer cache list against the reference's
    layer-stacked cache: every leaf, integer leaves exactly."""
    for i, c in enumerate(tcaches):
        for f in c._fields:
            got, want = getattr(c, f), np.asarray(getattr(jstacked, f)[i])
            if got.dtype in (torch.int32, torch.int64):
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
            else:
                close(got, want)


def hessian_keys(jfn, tfn):
    """(keys quantized with a Hessian, keys quantized in weight space) in
    each package: a matrix whose codes from the given Hessians equal its
    weight-space codes took the identity.  ``jfn``/``tfn`` map a Hessian
    dict to {stats key: packed planes}; the weight-space planes come
    back third."""
    out = []
    for fn in (jfn, tfn):
        with_h, no_h = fn(True), fn(False)
        same = {k for k in with_h
                if all(np.array_equal(a, b)
                       for a, b in zip(with_h[k], no_h[k]))}
        out.append((set(with_h) - same, same, no_h))
    return out


def ref_planes(jq, prefix_paths):
    """{stats key: packed planes} of a reference CLAQ tree: the kernels
    at ``prefix_paths`` ((key prefix, subtree, n stacked or None))."""
    out = {}

    def walk(key, node, n):
        if isinstance(node, dict):
            if "kernel" in node and hasattr(node["kernel"], "stripes"):
                qt = node["kernel"]
                for i in range(n or 1):
                    planes = [np.asarray(s.packed if n is None
                                         else s.packed[i])
                              for s in qt.stripes]
                    k = key.format(i) if n else key
                    out[k] = planes
                return
            for name, sub in node.items():
                walk(f"{key}.{name}", sub, n)
    for key, sub, n in prefix_paths:
        walk(key, sub, n)
    return out


def port_planes(model):
    """{module path: packed planes} of every quantized matrix."""
    return {n: [s.packed.numpy() for s in m.kernel.stripes]
            for n, m in model.named_modules()
            if hasattr(m, "kernel") and not isinstance(m.kernel,
                                                       torch.Tensor)}


def checkpoint_both_ways(tmp_path, jp, tm, tcfg):
    """The reference writes {params} and the port restores it bitwise
    into a fresh model; the port writes and the reference restores."""
    JManager(str(tmp_path / "ref")).save(1, {"params": jp})
    fresh = tapi.init_params(torch.Generator().manual_seed(5), tcfg, "cpu")
    got = CheckpointManager(str(tmp_path / "ref")).restore(
        1, {"params": param_tree(fresh, tcfg)})
    tree_lib.copy_into(param_tree(fresh, tcfg), got["params"])
    want = jax_tree_to_numpy(jp)
    for (name, a), (_, b) in zip(tree_lib.flatten(to_numpy_tree(fresh,
                                                                tcfg)),
                                 tree_lib.flatten(want)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    CheckpointManager(str(tmp_path / "port")).save(
        2, {"params": param_tree(tm, tcfg)})
    back = JManager(str(tmp_path / "port")).restore(
        2, {"params": jax.tree_util.tree_map(jnp.zeros_like, jp)})
    for (pa, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back["params"])[0],
            jax.tree_util.tree_flatten_with_path(jp)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(pa))
    return fresh


def serve_with_preemption(eng):
    """Two requests in the engine's 2 slots, a higher-priority third
    preempts one, a fourth queues; tokens, states and stats."""
    uids = eng.add_requests(PROMPTS[:2], max_new_tokens=8)
    eng.step()
    eng.step()
    uids.append(eng.submit(PROMPTS[2], max_new_tokens=6, priority=5))
    eng.step()
    uids.append(eng.submit(PROMPTS[3], max_new_tokens=5))
    eng.run_to_completion()
    fin = eng.take_finished()
    st = eng.stats()
    return ([fin[u].tokens for u in uids],
            [(fin[u].state.value, fin[u].preemptions) for u in uids], st)


def engine_parity(jp, jcfg, tm, tcfg):
    got = serve_with_preemption(ServingEngine(tm, tcfg, n_slots=2,
                                              max_len=64, device="cpu"))
    want = serve_with_preemption(JaxEngine(jp, jcfg, n_slots=2, max_len=64))
    assert got == want
    tokens, states, st = got
    assert st["preemptions"] == 1 and st["resumes"] == 1
    assert sum(p for _, p in states) == 1
    assert all(s == "finished" for s, _ in states)
    assert not ServingEngine(tm, tcfg, n_slots=2, max_len=64,
                             device="cpu").bucketing.enabled
    return tokens


def refusals(tm, tcfg):
    """Speculation, paging and chunked prefill refused, with the
    reference's messages."""
    with pytest.raises(NotImplementedError, match="recurrent state"):
        ServingEngine(tm, tcfg, n_slots=2, max_len=32, draft_params=tm,
                      spec=SpecConfig(gamma=2), device="cpu")
    with pytest.raises(NotImplementedError, match="nothing to page"):
        ServingEngine(tm, tcfg, n_slots=2, max_len=32, kv_layout="paged",
                      device="cpu")
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        ServingEngine(tm, tcfg, n_slots=2, max_len=32, chunked_prefill=8,
                      device="cpu")


# --------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def rw():
    return build("rwkv6_7b")


def _wkv_inputs(rng, B, T, H, N, dtype):
    r, k, v = (rng.normal(size=(B, T, H, N)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.normal(-1.0, 0.5, size=(B, T, H, N))).astype(
        np.float32)
    u = rng.normal(size=(H, N)).astype(np.float32) * 0.3
    s0 = rng.normal(size=(B, H, N, N)).astype(np.float32) * 0.1
    cast = (lambda a: torch.from_numpy(a).to(torch.bfloat16)) \
        if dtype == "bf16" else torch.from_numpy
    return (r, k, v, logw, u, s0), cast


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wkv_chunked_matches_reference(dtype, init):
    """T = 21 over 8-token chunks (padded), with and without a carried
    state; bf16 inputs are widened to f32 in both, as the reference
    does, so both dtypes hold to 1e-4 of the output's scale."""
    (r, k, v, logw, u, s0), cast = _wkv_inputs(np.random.default_rng(0), 2,
                                               21, 3, 8, dtype)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jout, jS = jrwkv._wkv_chunked(
        *(jnp.asarray(a, jdt) for a in (r, k, v)), jnp.asarray(logw),
        jnp.asarray(u), 8, jnp.asarray(s0) if init else None)
    tout, tS = trwkv._wkv_chunked(
        cast(r), cast(k), cast(v), torch.from_numpy(logw),
        torch.from_numpy(u), 8, torch.from_numpy(s0) if init else None)
    assert tout.shape == (2, 21, 3, 8) and tS.shape == (2, 3, 8, 8)
    scale = max(1.0, float(np.abs(np.asarray(jout)).max()))
    close(tout, jout, ATOL * scale)
    close(tS, jS, ATOL * max(1.0, float(np.abs(np.asarray(jS)).max())))


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


@pytest.mark.parametrize("mode", ["chunked", "decode"])
def test_time_mix_and_channel_mix(rw, mode):
    """One layer's time-mix and channel-mix against the reference, from
    a cache carrying a state and token-shift rows: 13 tokens through the
    chunked form, or one through the exact recurrence."""
    jcfg, tcfg = rw["jcfg"], rw["tcfg"]
    rng = np.random.default_rng(3)
    T = 13 if mode == "chunked" else 1
    x = rng.normal(size=(2, T, 128)).astype(np.float32)
    H, N = trwkv.rwkv_dims(tcfg)
    cache = dict(state=rng.normal(size=(2, H, N, N)).astype(np.float32),
                 prev_tm=rng.normal(size=(2, 128)).astype(np.float32),
                 prev_cm=rng.normal(size=(2, 128)).astype(np.float32),
                 length=np.array([4, 7], np.int32))
    jc = jrwkv.RWKVCache(**{k: jnp.asarray(v) for k, v in cache.items()})
    tc = trwkv.RWKVCache(**{k: torch.from_numpy(v) for k, v in cache.items()})
    jb = _layer0(rw["jp"]["blocks"])
    tb = rw["tm"].blocks[0]
    jy, jS, jlast = jrwkv.time_mix(jb["tm"], jnp.asarray(x), jcfg, jc)
    ty, tS, tlast = trwkv.time_mix(tb.tm, torch.from_numpy(x), tcfg, tc)
    close(ty, jy)
    close(tS, jS)
    close(tlast, jlast)
    jy, jlast = jrwkv.channel_mix(jb["cm"], jnp.asarray(x), jc)
    ty, tlast = trwkv.channel_mix(tb.cm, torch.from_numpy(x), tc)
    close(ty, jy)
    close(tlast, jlast)


def test_forward_loss_and_gradients(rw):
    """Logits, loss and every parameter's gradient against jax.grad (to
    1e-4 of each leaf's scale; the chunk form's exp(-cw) factors make the
    largest gradients the least exact)."""
    jcfg, tcfg, jp, tm = rw["jcfg"], rw["tcfg"], rw["jp"], rw["tm"]
    toks = np.random.default_rng(4).integers(1, 128, size=(2, 19))
    jlog, _, _ = jax.jit(lambda p, t: japi.tf.forward(p, jcfg, t))(
        jp, jnp.asarray(toks))
    tlog, _, _ = tapi.tf.forward(tm, tcfg, torch.from_numpy(toks))
    close(tlog, jlog)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(jp)
    tl, metrics, tg = loss_and_grads(tm, tcfg,
                                     {"tokens": torch.from_numpy(toks)})
    assert abs(float(tl) - float(jl)) < 1e-5
    assert set(metrics) == {"nll", "aux"}
    names = [n for n, _ in tree_lib.flatten(tg)]
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert names == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (name, g), (_, want) in zip(tree_lib.flatten(tg), jflat):
        got = (torch.stack(list(g)) if isinstance(g, tree_lib.LayerStack)
               else g)
        want = np.asarray(want)
        close(got, want, ATOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("tag", ["fp", "claq"])
def test_prefill_decode_logits_and_cache(rw, tag):
    """Prefill of two 11-token prompts, then three decode steps: logits
    and every cache leaf (state, token-shift rows, lengths)."""
    jcfg, tcfg = rw["jcfg"], rw["tcfg"]
    jp, tm = (rw["jp"], rw["tm"]) if tag == "fp" else (rw["jq"], rw["qm"])
    toks = np.random.default_rng(5).integers(1, 128, size=(2, 11))
    jc = japi.make_cache(jcfg, 2, 32, dtype=jnp.float32)
    tc = tapi.make_cache(tcfg, 2, 32, torch.float32, "cpu")
    jl, jc = jax.jit(lambda p, t, c: japi.prefill_step(
        p, jcfg, {"tokens": t}, c))(jp, jnp.asarray(toks), jc)
    jdec = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c))
    tl, tc = tapi.prefill_step(tm, tcfg, {"tokens": torch.from_numpy(toks)},
                               tc)
    close(tl, jl)
    check_caches(tc, jc)
    for _ in range(3):
        tok = np.asarray(jl).argmax(-1)
        jl, jc = jdec(jp, jnp.asarray(tok), jc)
        tl, tc = tapi.decode_step(tm, tcfg, torch.from_numpy(tok), tc)
        close(tl, jl)
    check_caches(tc, jc)


def test_chunked_prefill_equals_recurrent_decode(rw):
    """The port's own invariant, as the reference tests it: a 21-token
    prefill (chunked WKV) and 21 recurrent decode steps give the same
    last logits and state."""
    tcfg, tm = rw["tcfg"], rw["tm"]
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, 128, size=(1, 21)))
    lp, cp = tapi.prefill_step(tm, tcfg, {"tokens": toks},
                               tapi.make_cache(tcfg, 1, 32, torch.float32,
                                               "cpu"))
    cd = tapi.make_cache(tcfg, 1, 32, torch.float32, "cpu")
    for t in range(21):
        ld, cd = tapi.decode_step(tm, tcfg, toks[:, t], cd)
    close(ld, lp.numpy())
    for a, b in zip(cd, cp):
        close(a.state, b.state.numpy())
        assert int(a.length[0]) == int(b.length[0]) == 21


@pytest.mark.parametrize("tag", ["fp", "claq"])
def test_engine_tokens_and_stats_with_preemption(rw, tag):
    jp, tm = (rw["jp"], rw["tm"]) if tag == "fp" else (rw["jq"], rw["qm"])
    engine_parity(jp, rw["jcfg"], tm, rw["tcfg"])


def test_engine_refuses_speculation_paging_and_chunking(rw):
    refusals(rw["tm"], rw["tcfg"])


def test_quantizer_codes_and_hessian_keys(rw):
    """The port's calibration taps are the reference's names
    (``layers.{i}.tm.r`` ... ``layers.{i}.cm.v``, the decay LoRA's too,
    ``lm_head``).  In weight space every matrix gets the reference's codes
    exactly; from those Hessians both packages quantize the same keys with
    a Hessian (tm r/k/v/g/o, cm k/v/r) and none with the identity; the
    decay LoRA stays fp in both (``lora_a``/``lora_b`` are skipped
    names)."""
    jcfg, tcfg, jp = rw["jcfg"], rw["tcfg"], rw["jp"]
    th = tlq.calibrate(rw["tm"], tcfg, rw["calib"], batch_size=2)
    assert set(th) == {"lm_head"} | {
        f"layers.{i}.{n}" for i in range(tcfg.n_layers)
        for n in ("tm.r", "tm.k", "tm.v", "tm.g", "tm.w_lora_a",
                  "tm.w_lora_b", "tm.o", "cm.k", "cm.v", "cm.r")}
    jh = {k: jnp.asarray(v.numpy()) for k, v in th.items()}

    def jfn(with_h):
        q, rep = jlq.quantize_model_params(jp, jcfg, jh if with_h else {},
                                           JCLAQ(**QCFG))
        planes = ref_planes(q, [("layers.{}", q["blocks"], 2)])
        assert set(planes) == set(rep.stats)
        return planes

    def tfn(with_h):
        m, rep = tlq.quantize_model_params(
            from_numpy_tree(jax_tree_to_numpy(jp), tcfg, "cpu"), tcfg,
            th if with_h else {}, CLAQConfig(**QCFG))
        assert isinstance(m.blocks[0].tm.w_lora_a.kernel, torch.Tensor)
        planes = port_planes(m)
        return {"layers." + k.partition(".")[2]: v
                for k, v in planes.items()}
    (jh_keys, jid, j0), (th_keys, tid, t0) = hessian_keys(jfn, tfn)
    assert (th_keys, tid) == (jh_keys, jid)
    assert len(th_keys) == 8 * tcfg.n_layers and not tid
    assert sorted(j0) == sorted(t0)
    for k in j0:
        for a, b in zip(t0[k], j0[k]):
            np.testing.assert_array_equal(a.view(np.uint32), b, err_msg=k)


def test_checkpoint_written_by_each_restored_by_the_other(rw, tmp_path):
    fresh = checkpoint_both_ways(tmp_path, rw["jp"], rw["tm"], rw["tcfg"])
    toks = torch.arange(1, 13).reshape(2, 6)
    assert torch.equal(tapi.tf.forward(fresh, rw["tcfg"], toks)[0],
                       tapi.tf.forward(rw["tm"], rw["tcfg"], toks)[0])


def test_launchers_on_cpu(capsys):
    st = tserve.main(["--arch", "rwkv6_7b", "--smoke", "--bits", "2.2",
                      "--requests", "3", "--max-new", "4", "--device",
                      "cpu"])
    out = capsys.readouterr().out
    assert "CLAQ-quantized to" in out
    assert "[serve] 3 requests, 12 tokens" in out
    assert st["lifecycle"]["finished"] == 3
    ttrain.main(["--arch", "rwkv6_7b", "--smoke", "--steps", "2",
                 "--device", "cpu"])
    assert "[train] done" in capsys.readouterr().out
