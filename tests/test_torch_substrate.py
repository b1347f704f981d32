"""The port's training substrate: the counterparts of
tests/test_substrate.py (data determinism and sharding, the schedule,
AdamW, int8 compression, async checkpoints with gc, fallback past a
corrupt tail, an exact resume: bitwise on the CPU), and parity with the
reference on the same numpy inputs:

  * ``schedule`` at every step of a 20-step run: rtol 1e-6 (f32 cos);
  * one ``apply_updates`` from the same params, grads and moments:
    rtol 1e-6.

The train step (learning, microbatches, gradients, parity of one step:
every gradient within atol 2e-6, the largest measured gap 5.5e-7 on the
embedding; every updated param within atol 1e-4, since a first AdamW
step moves a weight by about lr * sign(g) = 5e-4) is in
``test_torch_substrate_train.py``.
"""
import copy
import dataclasses
import os
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import OptimConfig as JOpt  # noqa: E402
from repro.optim import OptState as JState  # noqa: E402
from repro.optim import apply_updates as j_apply  # noqa: E402
from repro.optim import schedule as j_schedule  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import param_tree  # noqa: E402
from repro_torch.data import (DataConfig, SyntheticCorpus,  # noqa: E402
                              calibration_set)
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.optim import (OptimConfig, apply_updates,  # noqa: E402
                               compress_int8, decompress_int8, global_norm,
                               init_opt_state, schedule)
from repro_torch.train import make_train_step  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

GRAD_ATOL = 2e-6
PARAM_ATOL = 1e-4


def _cfg(arch, **kw):
    kw = dict(dict(vocab=256, n_layers=2), **kw)
    return dataclasses.replace(t_smoke(arch), **kw)


def _model(cfg, seed=0):
    return tapi.init_params(torch.Generator().manual_seed(seed), cfg, "cpu")


def _state_np(model, cfg):
    return [t.detach().numpy().copy()
            for t in tree_lib.tensors(param_tree(model, cfg))]


# --------------------------------------------------------------------- data

def test_data_deterministic_and_stateless():
    cfg = DataConfig(vocab=977, seq_len=33, batch=6, seed=4)
    c1, c2 = SyntheticCorpus(cfg), SyntheticCorpus(cfg)
    assert torch.equal(c1.batch_at(17), c2.batch_at(17))
    assert not torch.equal(c1.batch_at(17), c1.batch_at(18))
    assert int(c1.batch_at(5).max()) < 977
    it = c1.iterate(16)
    assert torch.equal(next(it), c1.batch_at(16))
    assert torch.equal(next(it), c1.batch_at(17))


def test_data_sharding_partitions_batch():
    cfg = DataConfig(vocab=500, seq_len=16, batch=8, seed=1)
    full = SyntheticCorpus(cfg).batch_at(3)
    parts = [SyntheticCorpus(cfg, shard=i, num_shards=4).batch_at(3)
             for i in range(4)]
    assert torch.equal(torch.cat(parts), full)


def test_data_families_differ():
    a = SyntheticCorpus(DataConfig(500, 32, 4, seed=0,
                                   name="c4like")).batch_at(0)
    b = SyntheticCorpus(DataConfig(500, 32, 4, seed=0,
                                   name="wikilike")).batch_at(0)
    assert not torch.equal(a, b)


def test_calibration_set_matches_paper_protocol():
    assert calibration_set(vocab=1000, n_segments=16,
                           seq_len=64).shape == (16, 64)


# ---------------------------------------------------------------- optimizer

def test_schedule_warmup_and_decay():
    cfg = OptimConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(schedule(5, cfg)) < 1.0
    assert abs(float(schedule(10, cfg)) - 1.0) < 1e-6
    assert float(schedule(100, cfg)) < 1e-3


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedule_equals_reference(kind):
    kw = dict(lr=3e-4, warmup_steps=5, total_steps=20, schedule=kind)
    for s in range(21):
        want = float(j_schedule(jnp.asarray(s, jnp.int32), JOpt(**kw)))
        got = float(schedule(torch.tensor(s, dtype=torch.int32),
                              OptimConfig(**kw)))
        assert got == pytest.approx(want, rel=1e-6, abs=0), (kind, s)


def test_adamw_decreases_quadratic():
    cfg = OptimConfig(lr=0.1, warmup_steps=0, total_steps=100,
                      weight_decay=0.0, clip_norm=10.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    st = init_opt_state(params, cfg)
    for _ in range(60):
        params, st, _ = apply_updates(params, {"w": 2 * params["w"]}, st, cfg)
    assert float(params["w"].abs().max()) < 0.2
    assert int(st.step) == 60


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_equals_reference(dtype):
    """One clipped AdamW step from the same params, grads and moments; a
    bf16 param is updated in f32 and cast back, as in the reference."""
    rng = np.random.default_rng(0)
    shapes = {"a": (6, 5), "b": {"c": (7,), "d": (3, 4)}}

    def draw(scale):
        return jax.tree_util.tree_map(
            lambda s: (rng.normal(size=s) * scale).astype(np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))
    p, g, m, v = draw(1.0), draw(3.0), draw(0.1), draw(0.1)
    v = jax.tree_util.tree_map(np.abs, v)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=1.0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), p)
    jst = JState(m=jax.tree_util.tree_map(jnp.asarray, m),
                 v=jax.tree_util.tree_map(jnp.asarray, v),
                 step=jnp.asarray(3, jnp.int32), err=None)
    jp2, jst2, jmet = j_apply(jp, jax.tree_util.tree_map(jnp.asarray, g),
                              jst, JOpt(**cfg))

    def tt(tree, dt=torch.float32):
        return jax.tree_util.tree_map(
            lambda a: torch.from_numpy(a.copy()).to(dt), tree)
    tst = init_opt_state(tt(p), OptimConfig(**cfg))
    tst = tst._replace(m=tt(m), v=tt(v), step=torch.tensor(3, dtype=torch.int32))
    tp2, tst2, tmet = apply_updates(tt(p, tdt), tt(g), tst, OptimConfig(**cfg))
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-6)
    assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    assert int(tst2.step) == int(jst2.step) == 4
    for want, got, bf16 in ((jp2, tp2, dtype == "bfloat16"),
                            (jst2.m, tst2.m, False), (jst2.v, tst2.v, False)):
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got)):
            a = np.asarray(a.astype(jnp.float32))
            # a bf16 param may round to the neighbouring bf16 value
            np.testing.assert_allclose(
                b.float().numpy(), a, rtol=1e-6,
                atol=float(np.abs(a).max()) * 2 ** -8 if bf16 else 0)


def test_global_norm_sums_layer_stacks():
    rng = np.random.default_rng(1)
    parts = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(3)]
    tree = {"s": tree_lib.LayerStack(torch.from_numpy(p) for p in parts),
            "t": torch.ones(5)}
    want = np.sqrt(sum(float((p.astype(np.float64) ** 2).sum())
                       for p in parts) + 5)
    assert float(global_norm(tree)) == pytest.approx(want, rel=1e-6)


def test_int8_compression_roundtrip_error_bounded():
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 64)).astype(np.float32))
    q, scale = compress_int8(g)
    assert q.dtype == torch.int8
    assert float((decompress_int8(q, scale) - g).abs().max()) <= \
        float(scale) * 0.5 + 1e-7


# -------------------------------------------------------------------- train


# --------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"a": torch.arange(5, dtype=torch.float32),
             "nested": {"b": torch.ones((3, 3), dtype=torch.bfloat16)}}
    for s in (1, 2, 3):
        mgr.save(s, state, blocking=(s != 3))
    mgr.wait()
    assert sorted(mgr._list_steps()) == [2, 3]   # keep=2 GC
    step, restored = mgr.restore_latest(state)
    assert step == 3
    assert torch.equal(restored["a"], state["a"])
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["nested"]["b"], state["nested"]["b"])


def test_checkpoint_corrupt_tail_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = {"w": torch.arange(8, dtype=torch.float32)}
    mgr.save(10, state)
    mgr.save(20, {"w": state["w"] * 2})
    path = os.path.join(str(tmp_path), "step_0000000020", "arrays.npz")
    with open(path, "r+b") as f:             # a torn write
        f.seek(30)
        f.write(b"\x00" * 20)
    step, restored = mgr.restore_latest(state)
    assert step == 10
    assert torch.equal(restored["w"], torch.arange(8, dtype=torch.float32))


def test_checkpoint_resume_is_exact(tmp_path):
    """A restart mid-run reproduces the uninterrupted trajectory bitwise on
    the CPU (step-indexed data + exact state restore)."""
    cfg = _cfg("qwen2_1p5b", vocab=128, n_layers=1)
    ocfg = OptimConfig(lr=5e-3, warmup_steps=2, total_steps=20)
    data = SyntheticCorpus(DataConfig(vocab=128, seq_len=32, batch=4, seed=0))
    step_fn = make_train_step(cfg, ocfg)

    def run(model, opt, lo, hi):
        for s in range(lo, hi):
            model, opt, m = step_fn(model, opt, {"tokens": data.batch_at(s)})
        return model, opt, m["loss"]

    m0 = _model(cfg)
    m_straight = copy.deepcopy(m0)
    _, _, loss_straight = run(m_straight, init_opt_state(
        param_tree(m_straight, cfg), ocfg), 0, 10)

    mgr = CheckpointManager(str(tmp_path))
    m, o, _ = run(m0, init_opt_state(param_tree(m0, cfg), ocfg), 0, 5)
    mgr.save(5, {"p": param_tree(m, cfg), "o": o})
    # preemption: restore into a fresh model and optimizer state
    fresh = _model(cfg, seed=9)
    fresh_o = init_opt_state(param_tree(fresh, cfg), ocfg)
    st = mgr.restore(5, {"p": param_tree(fresh, cfg), "o": fresh_o})
    tree_lib.copy_into(param_tree(fresh, cfg), st["p"])
    for a, b in zip(tree_lib.tensors({"p": param_tree(m, cfg), "o": o}),
                    tree_lib.tensors({"p": param_tree(fresh, cfg),
                                      "o": st["o"]})):
        assert torch.equal(a, b)
    _, _, loss_resumed = run(fresh, st["o"], 5, 10)
    assert torch.equal(loss_resumed, loss_straight)


class _HeldWriter(CheckpointManager):
    """A manager whose async writer starts only once ``go`` is set."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.go = threading.Event()

    def _write_async(self, *a):
        self.go.wait()
        super()._write_async(*a)


def test_async_save_holds_the_saving_step(tmp_path):
    """An async save of CPU tensors stores the state of the step it was
    called at, while the next steps update those tensors in place before
    the writer runs (bf16 params, f32 moments)."""
    cfg = _cfg("llama1_7b", vocab=128, n_layers=1, dtype="bfloat16")
    ocfg = OptimConfig(lr=5e-3, warmup_steps=2, total_steps=20)
    data = SyntheticCorpus(DataConfig(vocab=128, seq_len=32, batch=4, seed=0))
    step_fn = make_train_step(cfg, ocfg)
    model = _model(cfg)
    opt = init_opt_state(param_tree(model, cfg), ocfg)
    for s in range(3):
        model, opt, _ = step_fn(model, opt, {"tokens": data.batch_at(s)})
    state = {"params": param_tree(model, cfg), "opt": opt}
    saved = [(name, [t.clone() for t in (leaf if isinstance(
        leaf, tree_lib.LayerStack) else [leaf])])
        for name, leaf in tree_lib.flatten(state)]
    mgr = _HeldWriter(str(tmp_path))
    mgr.save(3, state, blocking=False)
    for s in range(3, 5):
        model, opt, _ = step_fn(model, opt, {"tokens": data.batch_at(s)})
    live = dict(tree_lib.flatten(state))
    moved = {name for name, ts in saved if not all(torch.equal(
        a, b) for a, b in zip(ts, live[name] if isinstance(
            live[name], tree_lib.LayerStack) else [live[name]]))}
    # the steps wrote into the saved tensors, stacked leaves and not
    for name in ("['params']['embed']['embedding']",
                 "['params']['lm_head']['kernel']", "['opt'].m['embed']"
                 "['embedding']", "['params']['blocks']['attn']['q']"
                 "['kernel']"):
        assert name in moved, (name, sorted(moved))
    mgr.go.set()
    mgr.wait()
    assert mgr.latest_step() == 3
    fresh = _model(cfg, seed=9)
    st = mgr.restore(3, {"params": param_tree(fresh, cfg),
                         "opt": init_opt_state(param_tree(fresh, cfg), ocfg)})
    got = dict(tree_lib.flatten(st))
    for name, ts in saved:
        back = (got[name] if isinstance(got[name], tree_lib.LayerStack)
                else [got[name]])
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(ts, back)), name
