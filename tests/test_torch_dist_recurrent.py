"""The rwkv family (``rwkv6_7b``) and the hybrid (``zamba2_1p2b``: Mamba2
layers with a shared windowed attention block) on (data, model) meshes of
spawned gloo CPU ranks: serving, training and the dry run, held to the
single-device port, the reference's single-device engine and a real op
trace.

The models are the smoke configs (vocab 128; rwkv 2 layers; the hybrid 4
Mamba2 layers with a shared-attention site before every 2nd, so 2 sites,
and a window of 16, so a 20-token prompt rolls the ring at prefill and
decode wraps it), initialized by the reference with seeded noise on
every leaf but kernels and the embedding (norms, biases, mixes, decays,
the conv and the LoRAs are not uniform, so a misplaced block shows);
serving quantizes them
with the port (AP+OR CLAQ in weight space, converted for the reference's
engine) and prepares plans with ``plan_bn=32``.  Four ranks run in ONE
spawn: the (2, 2) mesh on all four, and (1, 2) and (2, 1) as two
independent submeshes of a (2, 1, 2) and a (2, 2, 1) mesh.  Held:

  * serving tokens on every mesh, f32 and int8 activations, exactly the
    port's single-device engine's (and, with f32 activations, the
    reference's single-device engine's), with a priority arrival that
    preempts the youngest request (slot 3: the second data rank's on a
    data axis of 2) and its resume;
  * each rank holds its share: half the plane bytes of every plan the
    model axis splits (the others whole, as on one device), half the
    slots of every recurrent-state leaf on data=2 with every head and
    channel, and half the ring caches' KV heads on model=2; the contract
    gate finds no weight all-gather;
  * a placed fp model's forward (no cache, and a prefill into a placed
    slot cache) equals the unplaced model's bitwise, so no placed buffer
    is read whole;
  * training, 3 AdamW steps (lr 1e-3), in one batch and (on (2, 1)) in 2
    microbatches: every loss and grad norm within rtol 1e-5 of the
    single-device port's, the gathered params within 1e-3 of each leaf's
    largest magnitude (the tolerances of ``tests/test_torch_dist_moe.py``)
    and the step-0 loss within 1e-5 of the reference's;
  * the dry run's collectives (kind and bytes, in order) of a (2, 2)
    train step, decode step and decode step on CLAQ stand-in plans equal
    a real rank's op trace.

The same four ranks as a (pod 2, data 1, model 2) mesh serve both
models with the single device's tokens, and on (2, 2) and the pod mesh
four prompts of one length prefill in one batch of 4 split over "dp": a
rank prefills 2 of the rows (a hook on ``models.api.prefill_step`` counts
them; the engine's recurrent state and ring rows are per row) and the
tokens are the single device's.

In process: the hybrid's figures extrapolated from 1- and 2-layer traces
and a 2-site trace equal a full 6-layer, 3-site trace's; the dry run's
CLAQ stand-ins cover exactly the matrices the quantizer quantizes (the
shared block's too); ``place_model`` keeps the recurrent families'
``WHOLE_BUFFERS`` whole and splits the site LoRAs on their out dim.  JAX
only in this process.
"""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import ShapeCell  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import from_numpy_tree, param_tree  # noqa: E402
from repro_torch.dist import context as dctx  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.dist.standin import StandInMesh  # noqa: E402
from repro_torch.kernels.plan import (PreparedQuantizedTensor,  # noqa: E402
                                      prepare_tree)
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import ServingEngine  # noqa: E402

ARCHS = ("rwkv6_7b", "zamba2_1p2b")
MESHES = ((1, 2), (2, 1), (2, 2))
PROMPTS = [[1, 2, 3, 4], [4, 5, 6, 7, 8, 9], list(range(30, 50)),
           list(range(60, 72))]
PRIORITY = [90, 91, 92]
ENGINE = dict(n_slots=4, max_len=32, plan_bn=32)
VARIANTS = {"vanilla": {}, "int8": dict(act_dtype="int8")}
POD = ((2, 1, 2), ("pod", "data", "model"))
# one length: one prefill of a batch of 4
SAME_LENGTH = [list(range(i, i + 6)) for i in (1, 11, 21, 31)]
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
LOSS_RTOL = 1e-5
STATE_RTOL = 1e-3
REF_LOSS_ATOL = 1e-5
TRAIN = ShapeCell("smoke_train", 32, 8, "train")
DECODE = ShapeCell("smoke_decode", 32, 4, "decode")


def _kw(arch):
    """The smoke config's changes, the same in both packages."""
    if arch == "zamba2_1p2b":
        return dict(vocab=128, n_layers=4, attn_every=2, attn_window=16)
    return dict(vocab=128, n_layers=2)


def _cfg(arch):
    return dataclasses.replace(t_smoke(arch), **_kw(arch))


def _jittered(tree, path=()):
    """``tree`` (the reference's params as numpy) with seeded noise on
    every float leaf but kernels and the embedding: at init the norm
    scales are 1, the biases 0 and the token-shift mixes 0.5, so a block
    read at another rank's offset would go unseen."""
    if isinstance(tree, dict):
        return {k: _jittered(v, path + (k,)) for k, v in tree.items()}
    if tree.dtype.kind != "f" or path[-1] in ("kernel", "embedding"):
        return tree
    rng = np.random.default_rng(zlib.crc32("/".join(path).encode()))
    return (tree + 0.1 * rng.standard_normal(tree.shape)).astype(tree.dtype)


def _tokens():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 128, size=(8, 32)).astype(np.int32)
            for _ in range(STEPS)]


def _serve(eng):
    """The four prompts in the four slots; after two steps a priority
    arrival preempts the youngest (slot 3), which resumes when a slot
    frees.  Tokens, (state, preemptions) and the preempt/resume counts."""
    uids = eng.add_requests(PROMPTS, max_new_tokens=6)
    eng.step()
    eng.step()
    uids.append(eng.submit(PRIORITY, max_new_tokens=4, priority=5))
    eng.run_to_completion()
    fin = eng.take_finished()
    st = eng.stats()
    return ([fin[u].tokens for u in uids],
            [(fin[u].state.value, fin[u].preemptions) for u in uids],
            (st["preemptions"], st["resumes"]))


def _serve_same_length(eng):
    """``SAME_LENGTH`` admitted at once: their tokens, and the rows of
    every prefill."""
    from repro_torch.models import api
    seen, orig = [], api.prefill_step

    def hook(params, cfg, batch, cache, **kw):
        seen.append(batch["tokens"].shape[0])
        return orig(params, cfg, batch, cache, **kw)
    api.prefill_step = hook
    try:
        uids = eng.add_requests(SAME_LENGTH, max_new_tokens=5)
        eng.run_to_completion()
    finally:
        api.prefill_step = orig
    fin = eng.take_finished()
    return [fin[u].tokens for u in uids], seen


def _engine(tree, arch, mesh=None, **kw):
    cfg = _cfg(arch)
    return ServingEngine(from_numpy_tree(tree, cfg, device="cpu"), cfg,
                         device="cpu", mesh=mesh, **{**ENGINE, **kw})


def _holdings(eng):
    """{module path: (plane bytes, shard)} of every CLAQ plan, and the
    shape of every slot-cache leaf (element, field)."""
    planes = {name: (sum(p.numel() * 4 for g in m.kernel.groups
                         for p in g.planes), m.kernel.shard)
              for name, m in eng.params.named_modules()
              if isinstance(getattr(m, "kernel", None),
                            PreparedQuantizedTensor)}
    cache = {(i, f): tuple(getattr(c, f).shape)
             for i, c in enumerate(eng.cache) for f in c._fields}
    return planes, cache


def _submesh(shape):
    """A (data, model) mesh of ``shape`` over this rank's block of the
    world (independent replicas where the world is larger)."""
    rep = torch.distributed.get_world_size() // (shape[0] * shape[1])
    if rep == 1:
        return mesh_lib.make_debug_mesh(shape)
    mesh = mesh_lib.make_debug_mesh((rep,) + tuple(shape),
                                    ("rep", "data", "model"))
    return mesh["data", "model"]


def _forwards(fp_tree, arch, mesh):
    """(whole, placed) logits of a cacheless forward and of a prefill into
    a slot cache, the placed ones on ``mesh``."""
    cfg = _cfg(arch)
    toks = torch.from_numpy(_tokens()[0][:4, :20]).long()
    out = []
    for placed in (False, True):
        model = from_numpy_tree(fp_tree, cfg, device="cpu")
        cache = tapi.make_cache(cfg, 4, 32, device="cpu")
        if placed:
            shd.place_model(model, cfg, mesh)
            cache = shd.place_cache(cache, cfg, mesh, slots=False)
        with dctx.use_mesh(mesh if placed else None), torch.no_grad():
            logits = tf.forward(model, cfg, toks)[0]
            pre = tapi.prefill_step(model, cfg, {"tokens": toks}, cache)[0]
        out.append((logits, pre))
    return out


def _train(tree, arch, mesh=None, microbatches=1):
    """STEPS train steps from the numpy tree on ``mesh`` (or one device):
    losses, grad norms and the whole params after the last step."""
    from repro_torch.launch.train import gathered_state
    from repro_torch.optim import OptimConfig, init_opt_state
    from repro_torch.train import make_train_step
    cfg = _cfg(arch)
    model = from_numpy_tree(tree, cfg, device="cpu")
    if mesh is not None:
        shd.place_model(model, cfg, mesh)
    ocfg = OptimConfig(**OPT)
    opt = init_opt_state(param_tree(model, cfg), ocfg)
    step = make_train_step(cfg, ocfg, microbatches)
    losses, norms = [], []
    with dctx.use_mesh(mesh):
        for t in _tokens():
            model, opt, met = step(model, opt, {"tokens": torch.from_numpy(t)})
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        params = (param_tree(model, cfg) if mesh is None
                  else gathered_state(model, cfg, opt, mesh)["params"])
    return dict(losses=losses, norms=norms,
                params=[t.numpy().copy() for t in tree_lib.tensors(params)])


def _decode_cache(cfg):
    return tapi.make_cache(cfg, DECODE.global_batch, DECODE.seq_len,
                           device="cpu")


def _real_collectives(arch, fp_tree, q_tree, mesh):
    """A (2, 2) rank's collectives from op traces: a train step, a decode
    step and a decode step on CLAQ plans (the dry run's cells)."""
    from repro_torch.analysis import op_trace
    from repro_torch.optim import OptimConfig, init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.train.step import local_batch
    cfg = _cfg(arch)
    out = {}
    model = from_numpy_tree(fp_tree, cfg, device="cpu")
    shd.place_model(model, cfg, mesh)
    ocfg = OptimConfig(total_steps=10000)
    opt = init_opt_state(param_tree(model, cfg), ocfg)
    step = make_train_step(cfg, ocfg)
    batch = {"tokens": torch.from_numpy(_tokens()[0])}
    with dctx.use_mesh(mesh):
        _, trace = op_trace.capture(lambda: step(model, opt, batch))
    out["train"] = op_trace.collective_instructions(trace)
    for tag, tree in (("decode", fp_tree), ("decode_q", q_tree)):
        model = prepare_tree(from_numpy_tree(tree, cfg, device="cpu"),
                             bn=ENGINE["plan_bn"])
        shd.place_model(model, cfg, mesh)
        cache = shd.place_cache(_decode_cache(cfg), cfg, mesh)
        tok = local_batch({"token": torch.arange(DECODE.global_batch)},
                          cfg, mesh)["token"]
        with dctx.use_mesh(mesh), dctx.rows_over_dp(), torch.no_grad():
            _, trace = op_trace.capture(
                lambda: tapi.decode_step(model, cfg, tok, cache))
        out[tag] = op_trace.collective_instructions(trace)
    return out


def _rank_main(rank, world, dev, fp_trees, q_trees):
    from repro_torch.analysis.artifacts import verify_engine
    out = {}
    for arch in ARCHS:
        for shape in MESHES:
            mesh = _submesh(shape)
            for tag, kw in VARIANTS.items():
                eng = _engine(q_trees[arch], arch, mesh, **kw)
                out[(arch, shape, tag)] = _serve(eng)
                if tag == "vanilla":
                    out[(arch, shape, "holdings")] = _holdings(eng)
            out[(arch, shape, "train")] = _train(fp_trees[arch], arch, mesh)
            if shape != (2, 1):
                out[(arch, shape, "forward")] = _forwards(fp_trees[arch],
                                                          arch, mesh)
        out[(arch, "train_micro")] = _train(fp_trees[arch], arch,
                                            _submesh((2, 1)), microbatches=2)
        mesh = _submesh((2, 2))
        rep = verify_engine(_engine(q_trees[arch], arch, mesh),
                            raise_on_error=False)
        out[(arch, "gate")] = (rep.rules_run, [
            f.rule_id for f in rep.findings if f.severity.name == "ERROR"])
        out[(arch, "collectives")] = _real_collectives(
            arch, fp_trees[arch], q_trees[arch], mesh)
        out[(arch, (2, 2), "same_length")] = _serve_same_length(
            _engine(q_trees[arch], arch, mesh))
    pod = mesh_lib.make_debug_mesh(*POD)
    for arch in ARCHS:
        out[(arch, "pod")] = _serve(_engine(q_trees[arch], arch, pod))
        out[(arch, "pod", "same_length")] = _serve_same_length(
            _engine(q_trees[arch], arch, pod))
    return out


@pytest.fixture(scope="module")
def runs():
    """The reference's params (numpy), the port's CLAQ trees, the
    single-device runs of both packages and the 4 ranks' results (the
    ranks run while this process runs the single-device engines)."""
    import threading

    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models import api as japi
    from repro.serve import ServingEngine as JaxEngine
    from repro_torch.convert import to_numpy_tree
    from repro_torch.core import APConfig, CLAQConfig, ORConfig
    from repro_torch.launch.quantize import quantize_model_params
    from test_torch_dense_configs import numpy_to_reference
    from test_torch_models import jax_tree_to_numpy
    import test_torch_dist_recurrent as me
    qcfg = CLAQConfig(bits=2, method="kmeans", kmeans_iters=4,
                      gptq_blocksize=32, ap=APConfig(2.2, 2, 4),
                      orr=ORConfig(0.1))
    fp_trees, q_trees, jps = {}, {}, {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(get_smoke_config(arch), **_kw(arch))
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(_cfg(arch))
        tree = _jittered(jax_tree_to_numpy(japi.init_params(
            jax.random.PRNGKey(0), jcfg)))
        jps[arch] = jcfg, numpy_to_reference(tree)
        fp_trees[arch] = tree
        cfg = _cfg(arch)
        model, _ = quantize_model_params(
            from_numpy_tree(tree, cfg, device="cpu"), cfg, {}, qcfg)
        q_trees[arch] = to_numpy_tree(model, cfg)
    box = {}
    spawn = threading.Thread(target=lambda: box.update(ranks=mesh_lib.run_local(
        me._rank_main, 4, fp_trees, q_trees)))
    spawn.start()
    ref, single = {}, {}
    try:
        for arch in ARCHS:
            jcfg, jp = jps[arch]
            jq = numpy_to_reference(q_trees[arch])
            ref[(arch, "loss")] = float(japi.loss_fn(
                jp, jcfg, {"tokens": jnp.asarray(_tokens()[0])})[0])
            ref[(arch, "vanilla")] = _serve(JaxEngine(jq, jcfg, **ENGINE))
            for tag, kw in VARIANTS.items():
                eng = _engine(q_trees[arch], arch, **kw)
                single[(arch, tag)] = _serve(eng)
                if tag == "vanilla":
                    single[(arch, "holdings")] = _holdings(eng)
            single[(arch, "same_length")] = _serve_same_length(
                _engine(q_trees[arch], arch))
            single[(arch, "train")] = _train(fp_trees[arch], arch)
            single[(arch, "train_micro")] = _train(fp_trees[arch], arch,
                                                   microbatches=2)
    finally:
        spawn.join()
    assert "ranks" in box, "a rank failed (its error is above)"
    return dict(ref=ref, single=single, ranks=box["ranks"])


# ------------------------------------------------------------- serving

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_tokens_equal_single_device_and_reference(runs, arch, shape):
    """Every rank emits the single-device port's tokens, bit for bit,
    through a preemption and its resume, with f32 and int8 activations;
    with f32 ones they are the reference engine's too."""
    assert runs["single"][(arch, "vanilla")] == runs["ref"][(arch, "vanilla")]
    for tag in VARIANTS:
        want = runs["single"][(arch, tag)]
        tokens, states, counts = want
        assert [len(t) for t in tokens] == [6, 6, 6, 6, 4]
        assert counts == (1, 1)
        assert states[3] == ("finished", 1)
        for r, out in enumerate(runs["ranks"]):
            assert out[(arch, shape, tag)] == want, (arch, shape, tag, r)


@pytest.mark.parametrize("arch", ARCHS)
def test_pod_axis_serves_the_single_device_tokens(runs, arch):
    """(pod 2, data 1, model 2): slots and state rows over "dp" = pod x
    data; every rank emits the single device's tokens through the
    preemption and its resume."""
    for r, out in enumerate(runs["ranks"]):
        assert out[(arch, "pod")] == runs["single"][(arch, "vanilla")], r


@pytest.mark.parametrize("mesh", [(2, 2), "pod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_rows_split_over_data_ranks(runs, arch, mesh):
    """Four prompts of one length: one prefill of 4 rows on one device, 2
    a rank over "dp"; the tokens are the single device's."""
    toks, rows = runs["single"][(arch, "same_length")]
    assert rows == [4] and all(len(t) == 5 for t in toks)
    for r, out in enumerate(runs["ranks"]):
        assert out[(arch, mesh, "same_length")] == (toks, [2]), r


def _state_fields(arch):
    return (("state", "prev_tm", "prev_cm", "length") if arch == ARCHS[0]
            else ("conv", "ssm", "length"))


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_share_of_units_and_state(runs, arch):
    """model=2 halves every plan the model axis splits (the others stay
    whole, as on one device) and the ring caches' KV heads; data=2 halves
    every cache leaf's slots; recurrent leaves keep every head and
    channel."""
    cfg = _cfg(arch)
    planes, cache = runs["single"][(arch, "holdings")]
    n_layers = cfg.n_layers
    assert {f for i, f in cache if i < n_layers} == set(_state_fields(arch))
    for shape in MESHES:
        dp, tp = shape
        for rank, out in enumerate(runs["ranks"]):
            got_p, got_c = out[(arch, shape, "holdings")]
            assert got_p.keys() == planes.keys()
            split = 0
            for name, (b, shard) in got_p.items():
                assert planes[name][1] is None, name
                if shard is None:
                    assert b == planes[name][0], name
                else:
                    split += 1
                    assert tp == 2 and (shard.parts, shard.index) == \
                        (2, rank % 2), name
                    assert 2 * b == planes[name][0], name
            assert (split > 0) == (tp == 2), (shape, split)
            assert got_c.keys() == cache.keys()
            for (i, f), want in cache.items():
                want = list(want)
                want[0] //= dp
                if i >= n_layers and f in ("k", "v"):
                    want[2] //= tp
                assert got_c[(i, f)] == tuple(want), (shape, i, f)


@pytest.mark.parametrize("arch", ARCHS)
def test_gate_finds_no_weight_gather(runs, arch):
    for out in runs["ranks"]:
        rules, errors = out[(arch, "gate")]
        assert "HLO-AG1" in rules and "HLO-CB1" in rules
        assert errors == []


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_forward_equals_the_whole_model(runs, arch, shape):
    for r, out in enumerate(runs["ranks"]):
        (whole, whole_pre), (placed, placed_pre) = \
            out[(arch, shape, "forward")]
        assert torch.equal(placed, whole), (arch, shape, r)
        assert torch.equal(placed_pre, whole_pre), (arch, shape, r)


# ------------------------------------------------------------ training

def _close(got, want, tag):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL,
                               atol=0, err_msg=tag)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=LOSS_RTOL,
                               atol=0, err_msg=tag)
    assert len(got["params"]) == len(want["params"])
    for a, b in zip(got["params"], want["params"]):
        assert a.shape == b.shape, tag
        np.testing.assert_allclose(
            a, b, rtol=0, err_msg=tag,
            atol=STATE_RTOL * float(np.abs(b).max()))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_training_equals_single_device(runs, arch, shape):
    want = runs["single"][(arch, "train")]
    assert abs(want["losses"][0] - runs["ref"][(arch, "loss")]) < \
        REF_LOSS_ATOL
    for r, out in enumerate(runs["ranks"]):
        got = out[(arch, shape, "train")]
        _close(got, want, f"{arch} {shape} rank {r}")
        assert abs(got["losses"][0] - runs["ref"][(arch, "loss")]) < \
            REF_LOSS_ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_on_a_data_mesh_equal_single_device(runs, arch):
    want = runs["single"][(arch, "train_micro")]
    for r, out in enumerate(runs["ranks"]):
        _close(out[(arch, "train_micro")], want, f"{arch} rank {r}")


# ------------------------------------------------------------- dry run

@pytest.mark.parametrize("tag", ["train", "decode", "decode_q"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_collectives_equal_a_real_4_rank_trace(runs, arch, tag):
    from repro_torch.analysis import op_trace
    from repro_torch.launch import dryrun
    cell = TRAIN if tag == "train" else DECODE
    traced = dryrun.trace_cell(_cfg(arch), cell,
                               StandInMesh({"data": 2, "model": 2}),
                               "2.12" if tag == "decode_q" else None,
                               plan_bn=ENGINE["plan_bn"])
    want = op_trace.collective_instructions(traced["trace"])
    assert {k for k, _ in want} == {"all-gather", "all-reduce"}
    for r, out in enumerate(runs["ranks"]):
        assert out[(arch, "collectives")][tag] == want, (arch, tag, r)


# ---------------------------------------------------------- in process

@pytest.mark.parametrize("cell", [TRAIN, DECODE], ids=lambda c: c.kind)
def test_hybrid_figures_count_sites_and_layers_apart(cell):
    """6 Mamba2 layers with a site before every 2nd (3 sites): the figures
    from 1- and 2-layer traces and a 2-site trace equal the full trace's,
    and a plain layer extrapolation (which would charge 1 site) does
    not."""
    from repro_torch.launch import dryrun
    mesh = StandInMesh({"data": 2, "model": 2})
    cfg = dataclasses.replace(_cfg(ARCHS[1]), n_layers=6)
    assert cfg.n_sites == 3
    full = dryrun.figures(dryrun.trace_cell(cfg, cell, mesh))
    got = dryrun.cell_figures(cfg, cell, mesh)
    assert got.keys() == full.keys()
    for k in full:
        assert got[k] == pytest.approx(full[k], rel=1e-12), k
    f1, f2 = (dryrun.figures(dryrun.trace_cell(
        dataclasses.replace(cfg, n_layers=n), cell, mesh)) for n in (1, 2))
    plain = dryrun.extrapolate(f1, f2, 6)
    assert plain["collective_bytes"] < full["collective_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_standins_cover_what_the_quantizer_quantizes(arch):
    """The dry run's CLAQ stand-ins sit on exactly the matrices the
    port's quantizer quantizes: the hybrid's shared block included (its
    products gather f32 K1 outputs, a dense one its activation dtype)."""
    from repro_torch.core import CLAQConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.quantize import quantize_model_params

    def quantized(model):
        return sorted(n for n, m in model.named_modules()
                      if hasattr(m, "kernel")
                      and not isinstance(m.kernel, torch.Tensor))

    cfg = _cfg(arch)
    model = tapi.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    quantize_model_params(model, cfg, {}, CLAQConfig(
        bits=2, method="kmeans", kmeans_iters=1, gptq_blocksize=32))
    meta = tapi.init_params(torch.Generator(), cfg, "meta")
    dryrun.install_standins(meta, cfg, dryrun.quant_config("2.12"), 32)
    assert quantized(meta) == quantized(model)
    assert any(n.startswith("shared_attn.") for n in quantized(meta)) == \
        (arch == ARCHS[1])


def test_place_model_keeps_whole_buffers_and_splits_site_loras():
    mesh = StandInMesh({"data": 1, "model": 2})
    for arch in ARCHS:
        cfg = _cfg(arch)
        model = tapi.init_params(torch.Generator().manual_seed(0), cfg,
                                 "cpu")
        shapes = {n: tuple(b.shape) for n, b in model.named_buffers()}
        shd.place_model(model, cfg, mesh)
        for n, b in model.named_buffers():
            leaf = n.rsplit(".", 1)[-1]
            if leaf in shd.WHOLE_BUFFERS:
                assert tuple(b.shape) == shapes[n], n
                assert not hasattr(b, "_model_shard"), n
            elif leaf in ("lora_a", "lora_b"):
                want = shapes[n][:-1] + (shapes[n][-1] // 2,)
                assert tuple(b.shape) == want, n
                assert b._model_shard == (1, 2, 0), n
        assert any(n.rsplit(".", 1)[-1] in shd.WHOLE_BUFFERS
                   for n in shapes)
