"""The encdec family (``seamless_m4t_medium``: an encoder over frames, a
decoder with self- and cross-attention) on (data, model) meshes of
spawned gloo CPU ranks: prefill and decode through ``models.api`` over
placed cross-attention banks, training and the dry run, held to the
single-device port, the reference's single-device ``api`` and a real op
trace.

The model is the smoke config (vocab 128, 2 encoder + 2 decoder layers,
d 128, 4 heads, f32), initialized by the reference with seeded noise on
every leaf but kernels and the embedding (so a norm read at another
rank's offset shows); prefill and decode run it quantized by the port
(AP+OR CLAQ in weight space, converted for the reference) with plans of
``plan_bn=32``, so every matrix splits into whole tiles over model=2.
Four ranks run in ONE spawn: the (2, 2) mesh on all four, and (1, 2) and
(2, 1) as two independent submeshes of a (2, 1, 2) and a (2, 2, 1) mesh.
Held:

  * prefill over 4 x 13 frames and 6 decode steps on every mesh, each
    data rank on its rows of the batch (``dctx.rows_over_dp``): tokens
    exactly the single device's, every logit within 1e-5 of the single
    device's logit scale, and the single device's within the encdec
    tests' 1e-4 of the reference's ``prefill_step``/``decode_step`` on
    the same weights (tokens exactly); on (2, 2) a prefill of the GLOBAL
    batch into a rank's placed cache keeps its rows' block;
  * ``place_cache`` of an ``EncDecCache`` gives each rank the block of
    every leaf that the reference's ``spec_for_cache`` assigns it;
  * training, 3 AdamW steps (lr 1e-3) on (1, 2) and (2, 1): every loss
    and grad norm within rtol 1e-5 of the single-device port's, the
    gathered params within 1e-3 of each leaf's largest magnitude, and the
    step-0 loss within 1e-5 of the reference's (the tolerances of
    ``tests/test_torch_dist_train.py``);
  * the dry run's collectives (kind and bytes, in order) of a (2, 2)
    train step, decode step and decode step on CLAQ stand-in plans equal
    a real rank's op trace.

In process: the figures extrapolated from (enc, dec) = (1, 1), (2, 1)
and (1, 2) traces equal a whole trace of a 3-encoder, 2-decoder model;
the dry run's stand-ins cover the quantizer's matrices.  JAX only in
this process.
"""
import dataclasses

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
from repro_torch.kernels.plan import prepare_tree  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from test_torch_dist_recurrent import _jittered, _submesh  # noqa: E402

ARCH = "seamless_m4t_medium"
MESHES = ((1, 2), (2, 1), (2, 2))
B, SRC, PROMPT, NEW = 4, 13, 5, 6
MAX_LEN = 16
PLAN_BN = 32
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
LOGIT_RTOL = 1e-5      # of the single device's logit scale
REF_ATOL = 1e-4        # tests/test_torch_encdec.py's
LOSS_RTOL = 1e-5
STATE_RTOL = 1e-3
REF_LOSS_ATOL = 1e-5
TRAIN = ShapeCell("smoke_train", 32, 8, "train")
DECODE = ShapeCell("smoke_decode", 32, 4, "decode")


def _cfg(**kw):
    return dataclasses.replace(t_smoke(ARCH), vocab=128, **kw)


def _inputs():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(B, SRC, 128)).astype(np.float32),
            rng.integers(1, 128, size=(B, PROMPT)))


def _train_batches():
    rng = np.random.default_rng(1)
    return [(rng.normal(size=(8, 32, 128)).astype(np.float32),
             rng.integers(0, 128, size=(8, 32)).astype(np.int32))
            for _ in range(STEPS)]


def _model(tree, mesh=None, plans=False):
    cfg = _cfg()
    model = from_numpy_tree(tree, cfg, device="cpu")
    if plans:
        model = prepare_tree(model, bn=PLAN_BN)
    if mesh is not None:
        shd.place_model(model, cfg, mesh)
    return model


def _rows(mesh):
    """This rank's block of the batch rows (all of them without a data
    axis)."""
    if mesh is None:
        return slice(0, B)
    ax = shd.MeshAxes(mesh)
    parts, index = shd.entry_block(ax.dp, mesh, shd.mesh_coords(mesh))
    n = B // parts
    return slice(index * n, (index + 1) * n)


def _generate(q_tree, mesh=None, whole_batch=False):
    """Prefill the frames and prompts, then ``NEW`` greedy decode steps,
    on ``mesh`` (each data rank on its rows, or, ``whole_batch``, handed
    the global batch): (the logits of every step (rows, NEW + 1, V), the
    tokens)."""
    cfg = _cfg()
    model = _model(q_tree, mesh, plans=True)
    frames, toks = _inputs()
    rows = _rows(mesh)
    cache = tapi.make_cache(cfg, B, MAX_LEN, torch.float32, "cpu",
                            src_len=SRC)
    if mesh is not None:
        cache = shd.place_cache(cache, cfg, mesh)
    batch = {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(toks)}
    if not whole_batch:
        batch = {k: v[rows] for k, v in batch.items()}
    out = []
    with dctx.use_mesh(mesh), torch.no_grad():
        with dctx.rows_over_dp(mesh is not None and not whole_batch):
            lg, cache = tapi.prefill_step(model, cfg, batch, cache)
        with dctx.rows_over_dp(mesh is not None):
            for _ in range(NEW):
                out.append(lg)
                lg, cache = tapi.decode_step(model, cfg, lg.argmax(-1),
                                             cache)
    out.append(lg)
    logits = torch.stack(out, dim=1)
    return logits, logits.argmax(-1)


def _stacked(cache):
    """{reference name: leaf} of a cache, layer stacks stacked."""
    return {n: (torch.stack(list(t)) if isinstance(t, tree_lib.LayerStack)
                else t)
            for n, t in tree_lib.flatten(shd.cache_tree(cache, _cfg()))}


def _distinct_cache():
    """A slot cache whose every leaf holds distinct values."""
    cache = tapi.make_cache(_cfg(), B, MAX_LEN, torch.float32, "cpu",
                            src_len=SRC)
    for t in tree_lib.tensors(cache):
        t.copy_(torch.arange(t.numel()).reshape(t.shape))
    return cache


def _placed_cache(mesh):
    """``_distinct_cache`` placed: {reference name: this rank's block}."""
    return _stacked(shd.place_cache(_distinct_cache(), _cfg(), mesh))


def _train(tree, mesh=None):
    """``STEPS`` steps on ``mesh`` (or one device): losses, grad norms and
    the whole params after the last step."""
    from repro_torch.launch.train import gathered_state
    from repro_torch.optim import OptimConfig, init_opt_state
    from repro_torch.train import make_train_step
    cfg = _cfg()
    model = _model(tree, mesh)
    ocfg = OptimConfig(**OPT)
    opt = init_opt_state(param_tree(model, cfg), ocfg)
    step = make_train_step(cfg, ocfg)
    losses, norms = [], []
    with dctx.use_mesh(mesh):
        for frames, toks in _train_batches():
            model, opt, met = step(model, opt, {
                "frames": torch.from_numpy(frames),
                "tokens": torch.from_numpy(toks)})
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        params = (param_tree(model, cfg) if mesh is None
                  else gathered_state(model, cfg, None, mesh)["params"])
    return dict(losses=losses, norms=norms,
                params=[t.numpy().copy() for t in tree_lib.tensors(params)])


def _real_collectives(fp_tree, q_tree, mesh):
    """A (2, 2) rank's collectives from op traces: a train step, a decode
    step and a decode step on CLAQ plans (the dry run's cells)."""
    from repro_torch.analysis import op_trace
    from repro_torch.optim import OptimConfig, init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.train.step import local_batch
    cfg = _cfg()
    out = {}
    model = _model(fp_tree, mesh)
    ocfg = OptimConfig(total_steps=10000)
    opt = init_opt_state(param_tree(model, cfg), ocfg)
    step = make_train_step(cfg, ocfg)
    frames, toks = _train_batches()[0]
    batch = {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(toks)}
    with dctx.use_mesh(mesh):
        _, trace = op_trace.capture(lambda: step(model, opt, batch))
    out["train"] = op_trace.collective_instructions(trace)
    for tag, tree in (("decode", fp_tree), ("decode_q", q_tree)):
        model = _model(tree, mesh, plans=True)
        cache = shd.place_cache(tapi.make_cache(
            cfg, DECODE.global_batch, DECODE.seq_len, device="cpu",
            src_len=DECODE.seq_len), cfg, mesh)
        tok = local_batch({"token": torch.arange(DECODE.global_batch)},
                          cfg, mesh)["token"]
        with dctx.use_mesh(mesh), dctx.rows_over_dp(), torch.no_grad():
            _, trace = op_trace.capture(
                lambda: tapi.decode_step(model, cfg, tok, cache))
        out[tag] = op_trace.collective_instructions(trace)
    return out


def _rank_main(rank, world, dev, fp_tree, q_tree):
    out = {}
    for shape in MESHES:
        mesh = _submesh(shape)
        out[(shape, "generate")] = _generate(q_tree, mesh)
        out[(shape, "cache")] = _placed_cache(mesh)
        out[(shape, "coords")] = shd.mesh_coords(mesh)
        if shape != (2, 2):
            out[(shape, "train")] = _train(fp_tree, mesh)
    mesh = _submesh((2, 2))
    out["whole_batch"] = _generate(q_tree, mesh, whole_batch=True)
    out["collectives"] = _real_collectives(fp_tree, q_tree, mesh)
    return out


@pytest.fixture(scope="module")
def runs():
    """The reference's params (numpy), the port's CLAQ tree, the single
    device's runs in both packages and the 4 ranks' results (the ranks run
    while this process runs the reference)."""
    import threading

    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models import api as japi
    from repro_torch.convert import to_numpy_tree
    from repro_torch.core import APConfig, CLAQConfig, ORConfig
    from repro_torch.launch.quantize import quantize_model_params
    from test_torch_dense_configs import numpy_to_reference
    from test_torch_models import jax_tree_to_numpy
    import test_torch_dist_encdec as me
    jax.config.update("jax_platform_name", "cpu")
    jcfg = dataclasses.replace(get_smoke_config(ARCH), vocab=128)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(_cfg())
    fp_tree = _jittered(jax_tree_to_numpy(japi.init_params(
        jax.random.PRNGKey(0), jcfg)))
    qcfg = CLAQConfig(bits=2, method="kmeans", kmeans_iters=4,
                      gptq_blocksize=32, ap=APConfig(2.2, 2, 4),
                      orr=ORConfig(0.1))
    qm, _ = quantize_model_params(from_numpy_tree(fp_tree, _cfg(), "cpu"),
                                  _cfg(), {}, qcfg)
    q_tree = to_numpy_tree(qm, _cfg())
    box = {}
    spawn = threading.Thread(target=lambda: box.update(
        ranks=mesh_lib.run_local(me._rank_main, 4, fp_tree, q_tree)))
    spawn.start()
    ref = {}
    try:
        # the reference's single device on the same quantized weights
        jq = numpy_to_reference(q_tree)
        frames, toks = _inputs()
        jc = japi.make_cache(jcfg, B, MAX_LEN, src_len=SRC,
                             dtype=jnp.float32)
        jl, jc = jax.jit(lambda p, b, c: japi.prefill_step(p, jcfg, b, c))(
            jq, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)},
            jc)
        jdec = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c))
        rows = [np.asarray(jl)]
        for _ in range(NEW):
            jl, jc = jdec(jq, jnp.asarray(rows[-1].argmax(-1)), jc)
            rows.append(np.asarray(jl))
        ref["logits"] = np.stack(rows, axis=1)
        tf, tt = _train_batches()[0]
        ref["loss"] = float(japi.loss_fn(
            numpy_to_reference(fp_tree), jcfg,
            {"frames": jnp.asarray(tf), "tokens": jnp.asarray(tt)})[0])
        single = dict(generate=_generate(q_tree), train=_train(fp_tree))
    finally:
        spawn.join()
    assert "ranks" in box, "a rank failed (its error is above)"
    return dict(ref=ref, single=single, ranks=box["ranks"])


# ---------------------------------------------------------- generation

def test_single_device_equals_the_reference(runs):
    """The port's one device against the reference's ``api`` on the same
    quantized weights: tokens exactly (each step fed its own argmax),
    logits within the encdec tests' tolerance."""
    logits, tokens = runs["single"]["generate"]
    want = runs["ref"]["logits"]
    np.testing.assert_allclose(logits.numpy(), want, atol=REF_ATOL, rtol=0)
    assert np.array_equal(tokens.numpy(), want.argmax(-1))


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_tokens_and_logits_equal_single_device(runs, shape):
    """Every rank's rows: the single device's tokens exactly, every
    logit within 1e-5 of the single device's logit scale."""
    logits, tokens = runs["single"]["generate"]
    scale = float(logits.abs().max())
    for r, out in enumerate(runs["ranks"]):
        got_logits, got_tokens = out[(shape, "generate")]
        n = B // shape[0]
        index = out[(shape, "coords")]["data"]
        rows = slice(index * n, (index + 1) * n)
        assert torch.equal(got_tokens, tokens[rows]), (shape, r)
        gap = float((got_logits - logits[rows]).abs().max())
        assert gap <= LOGIT_RTOL * scale, (shape, r, gap, scale)


def test_prefill_of_the_global_batch_keeps_the_ranks_rows(runs):
    """A placed cache holding a data rank's slots, handed the global
    batch at prefill: the rank encodes and prefills its own rows only,
    and decodes them as on its rows alone."""
    for r, out in enumerate(runs["ranks"]):
        got = out["whole_batch"]
        want = out[((2, 2), "generate")]
        assert got[0].shape[0] == B // 2
        assert torch.equal(got[1], want[1]), r
        assert torch.equal(got[0], want[0]), r


@pytest.mark.parametrize("shape", MESHES)
def test_place_cache_gives_each_rank_the_reference_spec_blocks(runs, shape):
    """Each leaf of a placed ``EncDecCache`` (``self_kv`` stacked over
    decoder layers, ``cross_k``/``cross_v``, ``enc_len``) is the block the
    reference's ``spec_for_cache`` assigns the rank: slots over "data",
    KV heads over "model"."""
    from types import SimpleNamespace

    from repro.dist import sharding as jshd
    cfg = _cfg()
    whole = _stacked(_distinct_cache())
    assert list(whole) == [".self_kv.k", ".self_kv.v", ".self_kv.length",
                           ".cross_k", ".cross_v", ".enc_len"]
    ax = jshd.MeshAxes(SimpleNamespace(shape={"data": shape[0],
                                              "model": shape[1]}))
    for r, out in enumerate(runs["ranks"]):
        coords = out[(shape, "coords")]
        placed = out[(shape, "cache")]
        for name, full in whole.items():
            want = full
            for d, entry in enumerate(jshd.spec_for_cache(
                    name, tuple(full.shape), cfg, ax)):
                if entry is not None:
                    n = full.shape[d] // shape[("data", "model").index(entry)]
                    want = want.narrow(d, coords[entry] * n, n)
            got = placed[name]
            assert tuple(got.shape) == tuple(want.shape), (shape, r, name)
            assert torch.equal(got, want), (shape, r, name)


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


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_mesh_training_equals_single_device(runs, shape):
    want = runs["single"]["train"]
    assert abs(want["losses"][0] - runs["ref"]["loss"]) < REF_LOSS_ATOL
    for r, out in enumerate(runs["ranks"]):
        got = out[(shape, "train")]
        _close(got, want, f"{shape} rank {r}")
        assert abs(got["losses"][0] - runs["ref"]["loss"]) < REF_LOSS_ATOL


# ------------------------------------------------------------- dry run

@pytest.mark.parametrize("tag", ["train", "decode", "decode_q"])
def test_dry_run_collectives_equal_a_real_4_rank_trace(runs, tag):
    from repro_torch.analysis import op_trace
    from repro_torch.launch import dryrun
    cell = TRAIN if tag == "train" else DECODE
    traced = dryrun.trace_cell(_cfg(), cell,
                               StandInMesh({"data": 2, "model": 2}),
                               "2.12" if tag == "decode_q" else None,
                               plan_bn=PLAN_BN)
    want = op_trace.collective_instructions(traced["trace"])
    assert {k for k, _ in want} == {"all-gather", "all-reduce"}
    for r, out in enumerate(runs["ranks"]):
        assert out["collectives"][tag] == want, (tag, r)


@pytest.mark.parametrize("cell", [TRAIN, DECODE], ids=lambda c: c.kind)
def test_figures_count_encoder_and_decoder_layers_apart(cell):
    """3 encoder and 2 decoder layers: the figures from the (1, 1),
    (2, 1) and (1, 2) traces equal the whole trace's, op counts and
    collective bytes exactly; a plain layer extrapolation over
    ``n_layers`` traces nothing (encdec does not read it)."""
    from repro_torch.launch import dryrun
    mesh = StandInMesh({"data": 2, "model": 2})
    cfg = _cfg(enc_layers=3, dec_layers=2, n_layers=5)
    full = dryrun.figures(dryrun.trace_cell(cfg, cell, mesh))
    got = dryrun.cell_figures(cfg, cell, mesh)
    assert got.keys() == full.keys()
    for k in full:
        if k == "collective_s":
            assert got[k] == pytest.approx(full[k], rel=1e-12), k
        else:
            assert got[k] == full[k], k
    assert full["collective_bytes"] > 0


def test_standins_cover_what_the_quantizer_quantizes():
    """The dry run's CLAQ stand-ins sit on exactly the matrices the
    port's quantizer quantizes: every encoder and decoder kernel, the
    cross attention's four included; the embedding and lm_head stay
    fp."""
    from repro_torch.core import CLAQConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.quantize import quantize_model_params

    def quantized(model):
        return sorted(n for n, m in model.named_modules()
                      if hasattr(m, "kernel")
                      and not isinstance(m.kernel, torch.Tensor))

    cfg = _cfg()
    model = tapi.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    quantize_model_params(model, cfg, {}, CLAQConfig(
        bits=2, method="kmeans", kmeans_iters=1, gptq_blocksize=32))
    meta = tapi.init_params(torch.Generator(), cfg, "meta")
    dryrun.install_standins(meta, cfg, dryrun.quant_config("2.12"), 32)
    assert quantized(meta) == quantized(model)
    assert {n.split(".", 2)[2] for n in quantized(meta)
            if n.startswith("dec_blocks.")} >= {"cross.q", "cross.k",
                                                "cross.v", "cross.o"}
    assert "lm_head" not in quantized(meta)
