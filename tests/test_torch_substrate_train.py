"""The port's training substrate, the train-step half (split from
tests/test_torch_substrate.py so the suite's workers can balance
it): learning with microbatch consistency, bitwise CPU gradients,
remat, a train step that leaves a serving model, and parity with the
reference on the same numpy inputs (one train step on the smoke
llama1_7b and qwen2_1p5b: the loss within 1e-5, every gradient within
atol 2e-6, every updated param within atol 1e-4; three steps' losses
within 1e-4)."""
import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.data import DataConfig as JData  # noqa: E402
from repro.data import SyntheticCorpus as JCorpus  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import OptimConfig as JOpt  # noqa: E402
from repro.optim import init_opt_state as j_init  # noqa: E402
from repro.train import make_train_step as j_make  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.convert import (from_numpy_tree, opt_state_to_numpy,  # noqa: E402
                                 param_tree, to_numpy_tree)
from repro_torch.data import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.optim import OptimConfig, init_opt_state  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402
from test_torch_models import jax_tree_to_numpy  # noqa: E402
from test_torch_substrate import (GRAD_ATOL, PARAM_ATOL, _cfg,  # noqa: E402,F401
                                  _model, _state_np)

jax.config.update("jax_platform_name", "cpu")


def test_training_learns_and_microbatch_consistent():
    cfg = _cfg("llama1_7b")
    ocfg = OptimConfig(lr=1e-2, warmup_steps=5, total_steps=60)
    data = SyntheticCorpus(DataConfig(vocab=256, seq_len=64, batch=8, seed=0))
    model = _model(cfg)
    step1 = make_train_step(cfg, ocfg, n_microbatches=1)
    step2 = make_train_step(cfg, ocfg, n_microbatches=2)

    # single-step equivalence of grad accumulation (same params/opt in)
    outs = []
    for fn in (step1, step2):
        m = copy.deepcopy(model)
        fn(m, init_opt_state(param_tree(m, cfg), ocfg),
           {"tokens": data.batch_at(0)})
        outs.append(_state_np(m, cfg))
    d = max(float(np.abs(a - b).max()) for a, b in zip(*outs))
    assert d < 5e-3, d

    # learning
    opt = init_opt_state(param_tree(model, cfg), ocfg)
    losses = []
    for s in range(30):
        model, opt, met = step1(model, opt, {"tokens": data.batch_at(s)})
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0] - 0.3


def test_cpu_gradients_repeat_bitwise():
    """Two backward passes over the same batch give the same gradients bit
    for bit on the CPU, the embedding's too (its rows repeat: 512 tokens
    of a 256-token vocabulary), so a run and its resume can agree."""
    cfg = _cfg("llama1_7b")
    model = _model(cfg)
    batch = {"tokens": SyntheticCorpus(DataConfig(
        vocab=256, seq_len=64, batch=8, seed=0)).batch_at(0)}
    runs = [tree_lib.tensors(loss_and_grads(model, cfg, batch)[2])
            for _ in range(3)]
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


def test_remat_changes_no_number():
    """cfg.remat recomputes each block in the backward pass: the loss and
    every gradient are bitwise those without it."""
    out = []
    for remat in (True, False):
        cfg = _cfg("llama1_7b", remat=remat)
        loss, _, grads = loss_and_grads(
            _model(cfg), cfg,
            {"tokens": SyntheticCorpus(DataConfig(256, 32, 4)).batch_at(0)})
        out.append((loss, tree_lib.tensors(grads)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_train_step_leaves_a_serving_model():
    """requires_grad is on only inside a step: afterwards the weights are
    plain buffers again and a forward records no graph."""
    cfg = _cfg("qwen2_1p5b")
    model = _model(cfg)
    ocfg = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    make_train_step(cfg, ocfg)(model, init_opt_state(param_tree(model, cfg),
                                                     ocfg),
                               {"tokens": torch.zeros((2, 8), dtype=torch.long)})
    assert not any(t.requires_grad
                   for t in tree_lib.tensors(param_tree(model, cfg)))
    logits, _, _ = tapi.tf.forward(model, cfg, torch.zeros((1, 4),
                                                           dtype=torch.long))
    assert logits.grad_fn is None


def _reference_pair(arch, seed=0):
    kw = dict(vocab=256, n_layers=2)
    jcfg = dataclasses.replace(get_smoke_config(arch), **kw)
    tcfg = _cfg(arch)
    jp = japi.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, from_numpy_tree(jax_tree_to_numpy(jp), tcfg,
                                           device="cpu")


def _reference_tokens(vocab, seq_len, batch, steps):
    data = JCorpus(JData(vocab=vocab, seq_len=seq_len, batch=batch, seed=0))
    return [np.array(data.batch_at(s)) for s in range(steps)]


@pytest.mark.parametrize("arch", ["llama1_7b", "qwen2_1p5b"])
def test_train_step_equals_reference(arch):
    jcfg, tcfg, jp, tm = _reference_pair(arch)
    toks = _reference_tokens(256, 32, 4, 3)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)

    # the loss and every gradient
    (jl, _), jg = jax.value_and_grad(
        lambda p: japi.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks[0])}),
        has_aux=True)(jp)
    tl, _, tg = loss_and_grads(tm, tcfg, {"tokens": torch.from_numpy(toks[0])})
    assert abs(float(tl) - float(jl)) < 1e-5
    got = tree_lib.map_with_name(
        lambda _, leaf: np.stack([t.numpy() for t in leaf])
        if isinstance(leaf, tree_lib.LayerStack) else leaf.numpy(), tg)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [
        n for n, _ in tree_lib.flatten(tg)]
    for (path, a), b in zip(jflat, jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), atol=GRAD_ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))

    # one step's params, then three steps' losses
    jstep = jax.jit(j_make(jcfg, JOpt(**kw)))
    tstep = make_train_step(tcfg, OptimConfig(**kw))
    jo = j_init(jp, JOpt(**kw))
    to = init_opt_state(param_tree(tm, tcfg), OptimConfig(**kw))
    for s, t in enumerate(toks):
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(t)})
        tm, to, tmet = tstep(tm, to, {"tokens": torch.from_numpy(t)})
        assert abs(float(tmet["loss"]) - float(jm["loss"])) < 1e-4, s
        assert float(tmet["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        if s == 0:
            for a, b in zip(jax.tree_util.tree_leaves(jp),
                            jax.tree_util.tree_leaves(
                                to_numpy_tree(tm, tcfg))):
                np.testing.assert_allclose(b, np.asarray(a),
                                           atol=PARAM_ATOL, rtol=0)
            on = opt_state_to_numpy(to)
            for a, b in zip(jax.tree_util.tree_leaves(jo.m),
                            jax.tree_util.tree_leaves(on["m"])):
                np.testing.assert_allclose(b, np.asarray(a),
                                           atol=GRAD_ATOL, rtol=0)


def test_microbatched_step_equals_reference():
    jcfg, tcfg, jp, tm = _reference_pair("llama1_7b")
    tok = _reference_tokens(256, 32, 4, 1)[0]
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jstep = jax.jit(j_make(jcfg, JOpt(**kw), n_microbatches=2))
    _, _, jm = jstep(jp, j_init(jp, JOpt(**kw)), {"tokens": jnp.asarray(tok)})
    _, _, tmet = make_train_step(tcfg, OptimConfig(**kw), n_microbatches=2)(
        tm, init_opt_state(param_tree(tm, tcfg), OptimConfig(**kw)),
        {"tokens": torch.from_numpy(tok)})
    assert abs(float(tmet["loss"]) - float(jm["loss"])) < 1e-5
    assert float(tmet["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                     rel=1e-5)
