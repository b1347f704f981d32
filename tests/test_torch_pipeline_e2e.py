"""Train-then-quantize end to end in the port, as tests/test_pipeline_e2e.py
runs it in the reference: train the smoke llama1_7b (vocab 256, 2 layers)
for 60 steps on the synthetic corpus, calibrate, CLAQ-quantize, and
reproduce the paper's orderings (Tables 1/3/4, trend level); quantized
serving equals quantized evaluation.  Then the training launcher's
resume: run twice into one checkpoint directory, the second run resumes
from the first's last step."""
import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import param_tree  # noqa: E402
from repro_torch.core import APConfig, CLAQConfig, ORConfig  # noqa: E402
from repro_torch.data import (DataConfig, SyntheticCorpus,  # noqa: E402
                              calibration_set)
from repro_torch.launch.quantize import (calibrate,  # noqa: E402
                                         quantize_model_params)
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import OptimConfig, init_opt_state  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# Perplexity over 8 batches of 8 x 64 tokens: on one batch (the
# reference's eval) the 2.0- against 2.24-bit gap is noise (0.978-1.013
# from batch to batch on this model), as the reference's test says.
EVAL_BATCHES = 8


@pytest.fixture(scope="module")
def trained():
    cfg = dataclasses.replace(get_smoke_config("llama1_7b"), vocab=256,
                              n_layers=2)
    model = api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    ocfg = OptimConfig(lr=1e-2, warmup_steps=5, total_steps=80)
    opt = init_opt_state(param_tree(model, cfg), ocfg)
    data = SyntheticCorpus(DataConfig(vocab=256, seq_len=64, batch=8, seed=0))
    step = make_train_step(cfg, ocfg)
    for s in range(60):
        model, opt, _ = step(model, opt, {"tokens": data.batch_at(s)})
    calib = calibration_set(vocab=256, n_segments=8, seq_len=64)
    hess = calibrate(model, cfg, calib, batch_size=4)
    return cfg, model, hess, [{"tokens": data.batch_at(1000 + i)}
                              for i in range(EVAL_BATCHES)]


@torch.no_grad()
def _ppl(cfg, model, batches):
    """exp of the mean next-token NLL over ``batches``."""
    nll = [api.loss_fn(model, cfg, b)[1]["nll"] for b in batches]
    return float(torch.exp(torch.stack(nll).mean()))


def test_tap_names_cover_all_block_matrices(trained):
    cfg, _, hess, _ = trained
    for i in range(cfg.n_layers):
        for name in ("attn.q", "attn.k", "attn.v", "attn.o",
                     "mlp.gate", "mlp.up", "mlp.down"):
            assert f"layers.{i}.{name}" in hess


def test_paper_orderings(trained):
    cfg, model, hess, eval_batches = trained
    ppl_fp = _ppl(cfg, model, eval_batches)

    def q(qcfg):
        qm, rep = quantize_model_params(copy.deepcopy(model), cfg, hess,
                                        qcfg)
        return _ppl(cfg, qm, eval_batches), rep

    ppl_claq3, _ = q(CLAQConfig(bits=3, method="kmeans", kmeans_iters=6,
                                gptq_blocksize=32))
    ppl_gptq3, _ = q(CLAQConfig(bits=3, method="uniform", gptq_blocksize=32))
    ppl_claq2, rep2 = q(CLAQConfig(bits=2, method="kmeans", kmeans_iters=6,
                                   gptq_blocksize=32))
    ppl_fusion, rep = q(CLAQConfig(bits=2, method="kmeans", kmeans_iters=6,
                                   gptq_blocksize=32, ap=APConfig(2.2, 2, 4),
                                   orr=ORConfig(0.1)))
    # Table 1 trend: fp <= CLAQ <= GPTQ at 3 bits
    assert ppl_fp <= ppl_claq3 * 1.001
    assert ppl_claq3 <= ppl_gptq3 * 1.05
    # Fusion beats pure 2-bit on the quantization objective; perplexity
    # only guards a no-regression band (as in the reference's test)
    assert rep.total_proxy_loss < rep2.total_proxy_loss
    assert ppl_fusion < ppl_claq2 * 1.01
    assert 2.0 < rep.mean_effective_bits < 2.6


@torch.no_grad()
def test_quantized_serving_matches_quantized_eval(trained):
    cfg, model, hess, _ = trained
    qm, _ = quantize_model_params(
        copy.deepcopy(model), cfg, hess,
        CLAQConfig(bits=4, method="kmeans", kmeans_iters=5,
                   gptq_blocksize=32))
    toks = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8]])
    full, _, _ = tf.forward(qm, cfg, toks)
    cache = api.make_cache(cfg, 1, 32, dtype=torch.float32, device="cpu")
    logits_p, cache = api.prefill_step(qm, cfg, {"tokens": toks[:, :6]},
                                       cache)
    torch.testing.assert_close(logits_p, full[:, 5], rtol=5e-2, atol=5e-2)
    logits_d, cache = api.decode_step(qm, cfg, toks[:, 6], cache)
    torch.testing.assert_close(logits_d, full[:, 6], rtol=5e-2, atol=5e-2)


def test_train_launcher_resumes(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "llama1_7b", "--smoke", "--steps", "6", "--ckpt-every", "3",
           "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    first = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=120)
    assert first.returncode == 0, first.stderr
    assert "resumed" not in first.stdout
    assert "[train] step 5 loss" in first.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                            "step_0000000006"]
    second = subprocess.run(cmd, env=env, capture_output=True, text=True,
                            timeout=120)
    assert second.returncode == 0, second.stderr
    assert "[train] resumed from step 6" in second.stdout
    assert "[train] done" in second.stdout
    assert "loss" not in second.stdout          # no step left to run


def test_train_launcher_refuses_a_mesh(tmp_path):
    """--mesh single needs the production mesh's 256 ranks: in a world of
    1 it raises make_production_mesh's ValueError (and leaves the group
    it did not bring up)."""
    import torch.distributed as dist
    from repro_torch.launch import train
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="world of 256"):
            train.main(["--arch", "llama1_7b", "--smoke", "--mesh",
                        "single", "--backend", "gloo", "--device", "cpu"])
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
