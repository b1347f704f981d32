"""Port parity for self-speculative decoding, the quantized half (split
from tests/test_torch_speculative.py so the suite's workers can
balance it): on the CLAQ target/draft pair from the reference's
``claq_quantize_with_draft`` (γ 1 and 4, f32 and int8 activations)
speculative tokens equal the port's vanilla tokens exactly and the JAX
engine's speculative ones (near-tie rule); the draft's plan tiles;
the port's own ``claq_quantize_with_draft`` against the reference's
plans; the speculative and paged CPU launcher."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import APConfig, CLAQConfig, ORConfig  # noqa: E402
from repro.data import calibration_set  # noqa: E402
from repro.launch.quantize import claq_quantize_with_draft  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro.serve import SpecConfig as JaxSpec  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.data import calibration_set as t_calib  # noqa: E402
from repro_torch.kernels.plan import PreparedQuantizedTensor  # noqa: E402
from repro_torch.launch import quantize as tlq  # noqa: E402
from repro_torch.serve import ServingEngine, SpecConfig  # noqa: E402
from test_torch_serving import _assert_tokens_match, _serve  # noqa: E402
from test_torch_speculative import (ENG, PROMPTS, _port_pair,  # noqa: E402,F401
                                    _to_torch, fp_model, quantized_pair)

jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("act", ["f32", "int8"])
@pytest.mark.parametrize("gamma", [1, 4])
def test_spec_matches_vanilla_and_reference_on_quantized_pair(
        fp_model, quantized_pair, gamma, act):
    """The flagship bar: the port's speculative tokens equal its vanilla
    tokens exactly, and the JAX engine's speculative tokens (near-tie
    rule), on the AP+OR target with its one-calibration 2-bit draft."""
    jcfg, tcfg, _, _, _, _ = fp_model
    jq, jdq = quantized_pair
    tq, tdq = _port_pair(quantized_pair, tcfg)
    toks_v = _serve(ServingEngine(tq, tcfg, act_dtype=act, device="cpu",
                                  **ENG), PROMPTS, max_new=8)
    eng = ServingEngine(tq, tcfg, act_dtype=act, device="cpu",
                        draft_params=tdq,
                        spec=SpecConfig(gamma=gamma, draft_bits=2), **ENG)
    toks_s = _serve(eng, PROMPTS, max_new=8)
    assert toks_s == toks_v
    assert all(len(t) == 8 for t in toks_s)
    want = _serve(JaxEngine(jq, jcfg, act_dtype=act, draft_params=jdq,
                            spec=JaxSpec(gamma=gamma, draft_bits=2), **ENG),
                  PROMPTS, max_new=8)
    _assert_tokens_match(tq, tcfg, PROMPTS, toks_s, want)
    st = eng.stats()
    # a constant number of shapes, however many windows ran
    assert st["verify_traces"] == 1 and st["draft_decode_traces"] == 1
    assert st["decode_traces"] == 0
    assert st["draft_prefill_traces"] == st["prefill_traces"]
    assert st["act_dtype"] == act
    assert 0.0 <= st["acceptance_rate"] <= 1.0
    assert st["tokens_per_step"] >= 1.0
    assert st["emitted_tokens"] == sum(len(t) - 1 for t in toks_s)


def test_draft_plan_tiles_tune_independently(fp_model, quantized_pair):
    """draft_plan_bn caps the DRAFT's plan tiles without touching the
    target's; tiles are layout, so speculation stays lossless."""
    _, tcfg, _, _, _, _ = fp_model
    tq, tdq = _port_pair(quantized_pair, tcfg)
    toks_v = _serve(ServingEngine(tq, tcfg, device="cpu", **ENG), PROMPTS,
                    max_new=8)
    eng = ServingEngine(tq, tcfg, device="cpu", draft_params=tdq,
                        spec=SpecConfig(gamma=2), draft_plan_bn=32, **ENG)
    assert _serve(eng, PROMPTS, max_new=8) == toks_v

    def bns(model):
        return [m.kernel.bn for m in model.modules()
                if isinstance(getattr(m, "kernel", None),
                              PreparedQuantizedTensor)]

    assert bns(eng.draft_params) and all(bn <= 32
                                         for bn in bns(eng.draft_params))
    assert max(bns(eng.params)) > 32


def test_claq_quantize_with_draft_one_calibration(fp_model, monkeypatch):
    """The port's claq_quantize_with_draft calibrates ONCE and quantizes
    the same fp weights twice: the target equals ``claq_quantize``'s, the
    draft equals a separate quantization at ``draft_config`` from the same
    Hessians, the draft shares every fp tensor with the target (no weight
    copy), and both reports' effective bits equal the reference's."""
    jcfg, tcfg, jp, _, _, _ = fp_model
    qcfg = tcore.CLAQConfig(bits=2, method="kmeans", kmeans_iters=4,
                            gptq_blocksize=32, ap=tcore.APConfig(2.2, 2, 4),
                            orr=tcore.ORConfig(0.1))
    calib = torch.as_tensor(np.asarray(
        t_calib(vocab=tcfg.vocab, n_segments=4, seq_len=32)))
    calls = []
    inner = tlq.calibrate

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    monkeypatch.setattr(tlq, "calibrate", counted)
    (tq, rep), (tdq, drep) = tlq.claq_quantize_with_draft(
        _to_torch(jp, tcfg), tcfg, calib, qcfg, draft_bits=2)
    assert len(calls) == 1
    monkeypatch.setattr(tlq, "calibrate", inner)
    assert tq.embedding is tdq.embedding
    assert tq.lm_head.kernel is tdq.lm_head.kernel
    assert tq.blocks[0].ln1 is tdq.blocks[0].ln1
    assert tq.blocks[0].attn.q is not tdq.blocks[0].attn.q
    assert 2.0 <= drep.mean_effective_bits < 2.3
    assert drep.mean_effective_bits < rep.mean_effective_bits
    assert all(m.kernel.stripes[0].bits == 2 and len(m.kernel.stripes) == 1
               for _, m in tlq.block_matrices(tdq.blocks[0]))

    fresh = _to_torch(jp, tcfg)
    hess = inner(fresh, tcfg, calib)
    _, rep_d = tlq.quantize_model_params(_to_torch(jp, tcfg), tcfg, hess,
                                         tcore.draft_config(qcfg, 2))
    _, rep_t = tlq.quantize_model_params(fresh, tcfg, hess, qcfg)
    for a, b in ((rep, rep_t), (drep, rep_d)):
        assert a.stats.keys() == b.stats.keys()
        assert a.total_proxy_loss == b.total_proxy_loss

    jqcfg = CLAQConfig(bits=2, method="kmeans", kmeans_iters=4,
                       gptq_blocksize=32, ap=APConfig(2.2, 2, 4),
                       orr=ORConfig(0.1))
    (_, jrep), (_, jdrep) = claq_quantize_with_draft(
        jp, jcfg, calibration_set(vocab=jcfg.vocab, n_segments=4,
                                  seq_len=32), jqcfg, draft_bits=2)
    assert rep.mean_effective_bits == pytest.approx(jrep.mean_effective_bits,
                                                    abs=1e-9)
    assert drep.mean_effective_bits == pytest.approx(
        jdrep.mean_effective_bits, abs=1e-9)


@pytest.mark.parametrize("bits", ["2.2", "0"])
def test_serve_launcher_speculative_and_paged(capsys, bits):
    """``launch.serve --spec-gamma --kv-layout paged``: a quantized target
    gets its draft from the same calibration, an fp one a K-Means + OR
    draft; both serve every request to its budget from a page pool."""
    from repro_torch.launch import serve as tserve
    st = tserve.main(["--arch", "llama1_7b", "--smoke", "--bits", bits,
                      "--spec-gamma", "2", "--draft-plan-bn", "32",
                      "--kv-layout", "paged", "--page-size", "8",
                      "--kv-dtype", "int8", "--requests", "3",
                      "--max-new", "5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert ("one calibration pass" in out if bits != "0"
            else "CLAQ draft" in out)
    assert "paged KV cache: page_size=8" in out and "resident dtype int8" in out
    assert "[serve] 3 requests, 15 tokens" in out
    assert "speculation gamma=2" in out
    assert st["spec_gamma"] == 2 and st["lifecycle"]["finished"] == 3
    assert st["paged"]["kv_dtype"] == "int8"
