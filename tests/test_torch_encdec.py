"""Port parity for the encdec family on the smoke ``seamless_m4t_medium``
(vocab 128, 2 encoder + 2 decoder layers, d 128, GELU MLPs, f32): the
reference's params cross in through ``from_numpy_tree``; the same
numpy-seeded frames and tokens go through both packages.

``make_cache`` needs ``src_len`` (and refuses pages); prefill over
encoded frames then decode steps (logits, the self-attention caches, the
cross K/V strips and ``enc_len``) of the fp and the CLAQ model; the
decode steps against a teacher-forced ``decode_blocks`` forward;
``loss_fn`` and its gradients; calibration taps (``enc.{i}.*``,
``dec.{i}.*``; none for the cross K/V projections) and the quantizer's
codes in weight space and Hessian/identity key sets, the cross K/V in
weight space in both packages; ``ServingEngine`` refuses the family;
checkpoints across packages; the CPU launchers.  f32 logits and caches
agree to 1e-4, codes and integer leaves exactly.

The reference's own ``calibrate`` raises on this family (its cross K/V
tap leaks a tracer out of ``lax.map``), so the Hessians here are the
port's, fed to both quantizers."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import CLAQConfig as JCLAQ  # noqa: E402
from repro.launch import quantize as jlq  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.core import CLAQConfig  # noqa: E402
from repro_torch.launch import quantize as tlq  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import modules as tmods  # noqa: E402
from repro_torch.serve import ServingEngine  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402
from test_torch_models import jax_tree_to_numpy  # noqa: E402
from test_torch_rwkv import (ATOL, QCFG, build, check_caches,  # noqa: E402
                             checkpoint_both_ways, close, hessian_keys,
                             port_planes, ref_planes)

jax.config.update("jax_platform_name", "cpu")

SRC = 13


@pytest.fixture(scope="module")
def ed():
    return build("seamless_m4t_medium")


def _batch(seed, B=2, St=9):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, SRC, 128)).astype(np.float32),
            rng.integers(1, 128, size=(B, St)))


def test_make_cache_needs_src_len_and_refuses_pages(ed):
    tcfg = ed["tcfg"]
    with pytest.raises(ValueError, match="src_len"):
        tapi.make_cache(tcfg, 2, 32, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="encdec serving"):
        tapi.make_cache(tcfg, 2, 32, torch.float32, "cpu", src_len=SRC,
                        page_size=8)
    c = tapi.make_cache(tcfg, 2, 32, torch.float32, "cpu", src_len=SRC)
    jc = japi.make_cache(ed["jcfg"], 2, 32, src_len=SRC, dtype=jnp.float32)
    assert len(c.self_kv) == tcfg.dec_layers
    assert tuple(c.cross_k.shape) == jc.cross_k.shape
    assert tuple(c.self_kv[0].k.shape) == jc.self_kv.k.shape[1:]


def _check(tc, jc):
    check_caches(tc.self_kv, jc.self_kv)
    close(tc.cross_k, jc.cross_k)
    close(tc.cross_v, jc.cross_v)
    np.testing.assert_array_equal(tc.enc_len.numpy(), np.asarray(jc.enc_len))


@pytest.mark.parametrize("tag", ["fp", "claq"])
def test_prefill_decode_logits_and_cache(ed, tag):
    jcfg, tcfg = ed["jcfg"], ed["tcfg"]
    jp, tm = (ed["jp"], ed["tm"]) if tag == "fp" else (ed["jq"], ed["qm"])
    frames, toks = _batch(5)
    jc = japi.make_cache(jcfg, 2, 32, src_len=SRC, dtype=jnp.float32)
    tc = tapi.make_cache(tcfg, 2, 32, torch.float32, "cpu", src_len=SRC)
    jl, jc = jax.jit(lambda p, b, c: japi.prefill_step(p, jcfg, b, c))(
        jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}, jc)
    tl, tc = tapi.prefill_step(tm, tcfg, {"frames": torch.from_numpy(frames),
                                          "tokens": torch.from_numpy(toks)},
                               tc)
    close(tl, jl)
    _check(tc, jc)
    jdec = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c))
    for _ in range(3):
        tok = np.asarray(jl).argmax(-1)
        jl, jc = jdec(jp, jnp.asarray(tok), jc)
        tl, tc = tapi.decode_step(tm, tcfg, torch.from_numpy(tok), tc)
        close(tl, jl)
    _check(tc, jc)


def test_decode_steps_equal_teacher_forced_forward(ed):
    """Prefill 5 tokens, decode the next 6 one by one: each step's logits
    equal the teacher-forced ``decode_blocks`` forward's at that position
    (the phase-12c check, here at smoke size)."""
    tcfg, tm = ed["tcfg"], ed["tm"]
    frames, toks = _batch(6, St=11)
    f, t = torch.from_numpy(frames), torch.from_numpy(toks)
    enc = ted.encode(tm, tcfg, f)
    x, _, _ = ted.decode_blocks(tm, tcfg, tmods.embed(tm.embedding, t),
                                enc_out=enc)
    full = tmods.dense(tm.lm_head, tmods.rms_norm(tm.final_norm, x,
                                                  tcfg.norm_eps))
    lg, c = tapi.prefill_step(tm, tcfg, {"frames": f, "tokens": t[:, :5]},
                              tapi.make_cache(tcfg, 2, 16, torch.float32,
                                              "cpu", src_len=SRC))
    close(lg, full[:, 4].numpy())
    for j in range(5, 11):
        lg, c = tapi.decode_step(tm, tcfg, t[:, j], c)
        close(lg, full[:, j].numpy())


def test_loss_and_gradients(ed):
    jcfg, tcfg, jp, tm = ed["jcfg"], ed["tcfg"], ed["jp"], ed["tm"]
    frames, toks = _batch(7)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(p, jcfg, {"frames": jnp.asarray(frames),
                                         "tokens": jnp.asarray(toks)}),
        has_aux=True))(jp)
    tl, metrics, tg = loss_and_grads(tm, tcfg, {
        "frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks)})
    assert abs(float(tl) - float(jl)) < 1e-5 and set(metrics) == set(jm)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [n for n, _ in tree_lib.flatten(tg)] == [
        jax.tree_util.keystr(p) for p, _ in jflat]
    for (name, g), (_, want) in zip(tree_lib.flatten(tg), jflat):
        got = (torch.stack(list(g)) if isinstance(g, tree_lib.LayerStack)
               else g)
        want = np.asarray(want)
        close(got, want, ATOL * max(1.0, float(np.abs(want).max())))


def test_calibration_taps(ed):
    """The port taps ``enc.{i}.attn.q`` ... ``dec.{i}.cross.o`` and
    ``lm_head``, and no cross K/V projection; the reference's calibrate
    raises on this family (a tracer leaks from its cross K/V tap)."""
    tcfg = ed["tcfg"]
    th = tlq.calibrate(ed["tm"], tcfg, ed["calib"], batch_size=2)
    want = {f"enc.{i}.{n}" for i in range(tcfg.enc_layers)
            for n in ("attn.q", "attn.k", "attn.v", "attn.o", "mlp.up",
                      "mlp.down")}
    want |= {f"dec.{i}.{n}" for i in range(tcfg.dec_layers)
             for n in ("attn.q", "attn.k", "attn.v", "attn.o", "cross.q",
                       "cross.o", "mlp.up", "mlp.down")}
    assert set(th) == want | {"lm_head"}
    with pytest.raises(jax.errors.UnexpectedTracerError):
        jlq.calibrate(ed["jp"], ed["jcfg"],
                      jnp.asarray(ed["calib"].numpy()), batch_size=2)


def test_quantizer_codes_and_hessian_keys(ed):
    """From the port's Hessians in both quantizers: the same ``dec.``
    keys take a Hessian and the same quantize as in weight space (the
    cross K/V, which have no tap; the encoder and the cross output, whose
    zero-frame Hessians are zero); in weight space the codes are the
    reference's exactly."""
    jcfg, tcfg, jp = ed["jcfg"], ed["tcfg"], ed["jp"]
    th = tlq.calibrate(ed["tm"], tcfg, ed["calib"], batch_size=2)
    jh = {k: jnp.asarray(v.numpy()) for k, v in th.items()}

    def jfn(with_h):
        q, rep = jlq.quantize_model_params(jp, jcfg, jh if with_h else {},
                                           JCLAQ(**QCFG))
        planes = ref_planes(q, [("enc.{}", q["enc_blocks"], tcfg.enc_layers),
                                ("dec.{}", q["dec_blocks"],
                                 tcfg.dec_layers)])
        assert set(planes) == set(rep.stats)
        return planes

    def tfn(with_h):
        m, rep = tlq.quantize_model_params(
            from_numpy_tree(jax_tree_to_numpy(jp), tcfg, "cpu"), tcfg,
            th if with_h else {}, CLAQConfig(**QCFG))
        assert isinstance(m.lm_head.kernel, torch.Tensor)
        planes = {k.replace("enc_blocks", "enc").replace("dec_blocks",
                                                         "dec"): v
                  for k, v in port_planes(m).items()}
        assert set(planes) == set(rep.stats)
        return planes
    (jh_keys, jid, j0), (th_keys, tid, t0) = hessian_keys(jfn, tfn)
    assert (th_keys, tid) == (jh_keys, jid)
    # zero frames leave every encoder activation zero, and so the cross
    # attention's output: those Hessians are zero and the matrices
    # quantize as in weight space, in both packages
    assert tid == ({f"dec.{i}.cross.{n}" for i in range(tcfg.dec_layers)
                    for n in "kvo"}
                   | {k for k in t0 if k.startswith("enc.")})
    assert len(th_keys) == 7 * tcfg.dec_layers
    assert all(not th[f"enc.{i}.attn.q"].any()
               for i in range(tcfg.enc_layers))
    for k in j0:
        for a, b in zip(t0[k], j0[k]):
            np.testing.assert_array_equal(a.view(np.uint32), b, err_msg=k)


def test_engine_refuses_encdec(ed):
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServingEngine(ed["tm"], ed["tcfg"], n_slots=2, max_len=32,
                      device="cpu")


def test_checkpoint_written_by_each_restored_by_the_other(ed, tmp_path):
    fresh = checkpoint_both_ways(tmp_path, ed["jp"], ed["tm"], ed["tcfg"])
    frames, toks = _batch(8)
    b = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks)}
    assert torch.equal(tapi.loss_fn(fresh, ed["tcfg"], b)[0],
                       tapi.loss_fn(ed["tm"], ed["tcfg"], b)[0])


def test_launchers_on_cpu(capsys):
    """The serve launcher is refused by the engine, as the reference's
    is; the train launcher trains (zero frames)."""
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tserve.main(["--arch", "seamless_m4t_medium", "--smoke",
                     "--requests", "2", "--device", "cpu"])
    ttrain.main(["--arch", "seamless_m4t_medium", "--smoke", "--steps", "2",
                 "--device", "cpu"])
    assert "[train] done" in capsys.readouterr().out
