"""The moe family (``qwen3_moe_30b_a3b``: GQA attention) and MLA with
experts (``deepseek_v2_236b``) on (data, model) meshes of spawned gloo
CPU ranks: serving, training and the dry run, held to the single-device
port, the reference's single-device engine and a real op trace.

The models are the smoke configs (vocab 128, 2 layers, f32), initialized
by the reference; serving quantizes them with the port (AP+OR CLAQ in
weight space, converted for the reference's engine) and prepares plans
with ``plan_bn=32``, so every matrix and expert stack splits into whole
tiles over model=2.  Four ranks run in ONE spawn: the (2, 2) mesh on all
four, and (1, 2) and (2, 1) as two independent submeshes of a (2, 1, 2)
and a (2, 2, 1) mesh.  Held:

  * serving tokens on every mesh, vanilla, int8 activations and (MLA)
    fp pages, whole and (``kv_pages=15``: 16 latent page rows) split over
    "data" where it has 2 ranks, 8 rows a rank, exactly the port's
    single-device engine's and the reference's single-device engine's;
    with ``moe_groups`` 1 (a data rank gathers the MoE rows over "data")
    and 2 on (2, 1) (it routes
    its own whole groups), each exactly the single device's at the same
    ``moe_groups``; each rank holds half the plane bytes of every unit
    and the contract gate finds no weight all-gather;
  * training, 3 AdamW steps (lr 1e-3), in one batch and (on (2, 1), both
    routes) in 2 microbatches: every loss and grad norm within rtol 1e-5
    of the single-device port's (f32 sums in another order; measured gaps
    below 1e-6), the aux loss of the initial params, with a gradient and
    from a no-grad loss, within 1e-6 of the single device's, the gathered
    params within 1e-3 of each leaf's largest magnitude (as
    ``tests/test_torch_dist_train.py``),
    and the step-0 loss within 1e-5 of the reference's single-device
    loss on the same numpy tokens;
  * the dry run's collectives (kind and bytes, in order) of a (2, 2)
    train step, decode step and decode step on CLAQ stand-in plans equal
    a real rank's op trace.

The same four ranks as a (pod 2, data 1, model 2) mesh serve the MLA
model (vanilla, and from its split latent pool) with the single device's
tokens and train the moe model 3 steps within the bounds above.

In process: ``place_model`` never splits an expert stack's E or its
contraction dim, and the absorbed MLA decode on a rank's heads is
bitwise those heads of the whole decode.  JAX only in this process.
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
from repro_torch.kernels.plan import (PreparedQuantizedTensor,  # noqa: E402
                                      local_plan, prepare_tree)
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.serve import ServingEngine  # noqa: E402

ARCHS = ("qwen3_moe_30b_a3b", "deepseek_v2_236b")
MESHES = ((1, 2), (2, 1), (2, 2))
# even lengths: a batch-1 prefill splits into moe_groups=2
PROMPTS = [[1, 2, 3, 4], [4, 5, 6, 7, 8, 9], [10, 11],
           [20, 21, 22, 23, 24, 25, 26, 27]]
ENGINE = dict(n_slots=4, max_len=32, plan_bn=32)
VARIANTS = {"vanilla": {}, "int8": dict(act_dtype="int8"),
            "paged": dict(kv_layout="paged", page_size=8),
            # 16 page rows: 8 a data rank on a data axis of 2
            "paged_split": dict(kv_layout="paged", page_size=8, kv_pages=15)}
POD = ((2, 1, 2), ("pod", "data", "model"))
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
LOSS_RTOL = 1e-5
AUX_ATOL = 1e-6
STATE_RTOL = 1e-3
REF_LOSS_ATOL = 1e-5
TRAIN = ShapeCell("smoke_train", 32, 8, "train")
DECODE = ShapeCell("smoke_decode", 32, 4, "decode")


def _cfg(arch, groups=1):
    return dataclasses.replace(t_smoke(arch), vocab=128, n_layers=2,
                               moe_groups=groups)


def _variants(arch):
    return [v for v in VARIANTS
            if not v.startswith("paged") or arch == ARCHS[1]]


def _tokens():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 128, size=(8, 32)).astype(np.int32)
            for _ in range(STEPS)]


def _serve(eng, max_new=5):
    uids = eng.add_requests(PROMPTS, max_new_tokens=max_new)
    eng.run_to_completion()
    fin = eng.take_finished()
    return [fin[u].tokens for u in uids]


def _engine(tree, arch, mesh=None, groups=1, **kw):
    cfg = _cfg(arch, groups)
    return ServingEngine(from_numpy_tree(tree, cfg, device="cpu"), cfg,
                         device="cpu", mesh=mesh, **{**ENGINE, **kw})


def _planes(model):
    """{module path: (plane bytes, shard)} of every CLAQ plan."""
    return {name: (sum(p.numel() * 4 for g in m.kernel.groups
                       for p in g.planes), m.kernel.shard)
            for name, m in model.named_modules()
            if isinstance(getattr(m, "kernel", None),
                          PreparedQuantizedTensor)}


def _submesh(shape):
    """A (data, model) mesh of ``shape`` over this rank's block of the
    world (independent replicas where the world is larger)."""
    rep = torch.distributed.get_world_size() // (shape[0] * shape[1])
    if rep == 1:
        return mesh_lib.make_debug_mesh(shape)
    mesh = mesh_lib.make_debug_mesh((rep,) + tuple(shape),
                                    ("rep", "data", "model"))
    return mesh["data", "model"]


def _train(tree, arch, mesh=None, groups=1, microbatches=1):
    """STEPS train steps from the numpy tree on ``mesh`` (or one device),
    in ``microbatches``: losses, grad norms, the initial params' aux loss
    (with a gradient, and from a no-grad loss) and the whole params after
    the last step."""
    from repro_torch.launch.train import gathered_state
    from repro_torch.optim import OptimConfig, init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.train.step import loss_and_grads, local_batch
    cfg = _cfg(arch, groups)
    model = from_numpy_tree(tree, cfg, device="cpu")
    if mesh is not None:
        shd.place_model(model, cfg, mesh)
    ocfg = OptimConfig(**OPT)
    opt = init_opt_state(param_tree(model, cfg), ocfg)
    step = make_train_step(cfg, ocfg, microbatches)
    losses, norms = [], []
    with dctx.use_mesh(mesh):
        batch = {"tokens": torch.from_numpy(_tokens()[0])}
        split = mesh is not None and mesh.shape[0] > 1
        if split:
            batch = local_batch(batch, cfg, mesh)
        with dctx.rows_over_dp(split):
            _, met, _ = loss_and_grads(model, cfg, batch)
            with torch.no_grad():
                aux_eval = float(tapi.loss_fn(model, cfg, batch)[1]["aux"])
        aux = float(met["aux"])
        for t in _tokens():
            model, opt, met = step(model, opt, {"tokens": torch.from_numpy(t)})
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        params = (param_tree(model, cfg) if mesh is None
                  else gathered_state(model, cfg, opt, mesh)["params"])
    return dict(losses=losses, norms=norms, aux=aux, aux_eval=aux_eval,
                params=[t.numpy().copy() for t in tree_lib.tensors(params)])


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


def _decode_cache(cfg):
    return tapi.make_cache(cfg, DECODE.global_batch, DECODE.seq_len,
                           device="cpu")


def _rank_main(rank, world, dev, fp_trees, q_trees):
    from repro_torch.analysis.artifacts import verify_engine
    out = {}
    for arch in ARCHS:
        for shape in MESHES:
            mesh = _submesh(shape)
            for tag in _variants(arch):
                eng = _engine(q_trees[arch], arch, mesh, **VARIANTS[tag])
                out[(arch, shape, tag)] = _serve(eng)
                if tag == "vanilla":
                    out[(arch, shape, "planes")] = _planes(eng.params)
                if tag == "paged_split":
                    out[(arch, shape, "pool_rows")] = eng.cache[0].cp.shape[0]
            out[(arch, shape, "train")] = _train(fp_trees[arch], arch, mesh)
        mesh = _submesh((2, 1))
        out[(arch, "groups2")] = _serve(_engine(q_trees[arch], arch, mesh,
                                                groups=2))
        for groups in (1, 2):
            out[(arch, "train_micro", groups)] = _train(
                fp_trees[arch], arch, mesh, groups=groups, microbatches=2)
        out[(arch, "train_groups2")] = _train(fp_trees[arch], arch, mesh,
                                              groups=2)
        mesh = _submesh((2, 2))
        rep = verify_engine(_engine(q_trees[arch], arch, mesh),
                            raise_on_error=False)
        out[(arch, "gate")] = (rep.rules_run, [
            f.rule_id for f in rep.findings if f.severity.name == "ERROR"])
        out[(arch, "collectives")] = _real_collectives(
            arch, fp_trees[arch], q_trees[arch], mesh)
    # the pod axis: the MLA model served, the moe model trained
    pod = mesh_lib.make_debug_mesh(*POD)
    for tag in ("vanilla", "paged_split"):
        out[("pod", tag)] = _serve(_engine(q_trees[ARCHS[1]], ARCHS[1], pod,
                                           **VARIANTS[tag]))
    out[("pod", "train")] = _train(fp_trees[ARCHS[0]], ARCHS[0], pod)
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
    import test_torch_dist_moe as me
    qcfg = CLAQConfig(bits=2, method="kmeans", kmeans_iters=4,
                      gptq_blocksize=32, ap=APConfig(2.2, 2, 4),
                      orr=ORConfig(0.1))
    fp_trees, q_trees, jps = {}, {}, {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(get_smoke_config(arch), vocab=128,
                                   n_layers=2)
        jps[arch] = jcfg, japi.init_params(jax.random.PRNGKey(0), jcfg)
        fp_trees[arch] = tree = jax_tree_to_numpy(jps[arch][1])
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
            for tag in _variants(arch):
                ref[(arch, tag)] = _serve(JaxEngine(jq, jcfg, **ENGINE,
                                                    **VARIANTS[tag]))
                eng = _engine(q_trees[arch], arch, **VARIANTS[tag])
                single[(arch, tag)] = _serve(eng)
                if tag == "vanilla":
                    single[(arch, "planes")] = _planes(eng.params)
            single[(arch, "groups2")] = _serve(_engine(q_trees[arch], arch,
                                                       groups=2))
            single[(arch, "train")] = _train(fp_trees[arch], arch)
            single[(arch, "train_groups2")] = _train(fp_trees[arch], arch,
                                                     groups=2)
            for groups in (1, 2):
                single[(arch, "train_micro", groups)] = _train(
                    fp_trees[arch], arch, groups=groups, microbatches=2)
    finally:
        spawn.join()
    assert "ranks" in box, "a rank failed (its error is above)"
    return dict(ref=ref, single=single, ranks=box["ranks"])


# ------------------------------------------------------------- serving

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_tokens_equal_single_device_and_reference(runs, arch, shape):
    """Every rank emits the single-device tokens of both packages, bit for
    bit, in every variant (MoE rows gathered over "data": moe_groups 1)."""
    for tag in _variants(arch):
        want = runs["single"][(arch, tag)]
        assert want == runs["ref"][(arch, tag)], (arch, tag)
        assert all(len(t) == 5 for t in want)
        for r, out in enumerate(runs["ranks"]):
            assert out[(arch, shape, tag)] == want, (arch, shape, tag, r)
    if "paged" in _variants(arch):
        for tag in ("paged", "paged_split"):
            assert runs["single"][(arch, tag)] == \
                runs["single"][(arch, "vanilla")]
        for r, out in enumerate(runs["ranks"]):
            assert out[(arch, shape, "pool_rows")] == (8 if shape[0] == 2
                                                       else 16), (shape, r)


def test_pod_axis_serves_mla_and_trains_moe(runs):
    """(pod 2, data 1, model 2): the MLA model's tokens, vanilla and from
    a latent pool split over "dp" (pod x data), are the single device's;
    the moe model's 3 steps are the single device's within the training
    bounds."""
    for r, out in enumerate(runs["ranks"]):
        for tag in ("vanilla", "paged_split"):
            assert out[("pod", tag)] == runs["single"][(ARCHS[1], tag)], r
        _close(out[("pod", "train")], runs["single"][(ARCHS[0], "train")],
               f"pod rank {r}")


@pytest.mark.parametrize("arch", ARCHS)
def test_local_route_equals_single_device_at_the_same_groups(runs, arch):
    """moe_groups 2 on (2, 1): each data rank routes its own group (no
    gather over "data"), the tokens exactly the single device's at
    moe_groups 2."""
    want = runs["single"][(arch, "groups2")]
    for out in runs["ranks"]:
        assert out[(arch, "groups2")] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_share_of_every_unit(runs, arch):
    """On every mesh with model=2, each CLAQ plan (expert stacks
    included) is a shard-local half of the whole plan's planes."""
    whole = runs["single"][(arch, "planes")]
    assert any(".w_gate" in n for n in whole)
    for shape in ((1, 2), (2, 2)):
        for rank, out in enumerate(runs["ranks"]):
            got = out[(arch, shape, "planes")]
            assert got.keys() == whole.keys()
            for name, (b, shard) in got.items():
                assert whole[name][1] is None and shard is not None, name
                assert (shard.parts, shard.index) == (2, rank % 2), name
                assert 2 * b == whole[name][0], name
    for out in runs["ranks"]:
        got = out[(arch, (2, 1), "planes")]
        assert all(s is None and b == whole[n][0]
                   for n, (b, s) in got.items())


@pytest.mark.parametrize("arch", ARCHS)
def test_gate_finds_no_weight_gather(runs, arch):
    for out in runs["ranks"]:
        rules, errors = out[(arch, "gate")]
        assert "HLO-AG1" in rules and "HLO-CB1" in rules
        assert errors == []


# ------------------------------------------------------------ training

def _close(got, want, tag):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL,
                               atol=0, err_msg=tag)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=LOSS_RTOL,
                               atol=0, err_msg=tag)
    assert abs(got["aux"] - want["aux"]) < AUX_ATOL, tag
    assert abs(got["aux_eval"] - want["aux"]) < AUX_ATOL, tag
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
    assert want["aux"] > 0
    assert abs(want["losses"][0] - runs["ref"][(arch, "loss")]) < \
        REF_LOSS_ATOL
    for r, out in enumerate(runs["ranks"]):
        got = out[(arch, shape, "train")]
        _close(got, want, f"{arch} {shape} rank {r}")
        assert abs(got["losses"][0] - runs["ref"][(arch, "loss")]) < \
            REF_LOSS_ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_local_route_trains_as_single_device(runs, arch):
    """moe_groups 2 on (2, 1): the aux loss's means averaged over "data"
    before their product give the single device's aux (with a gradient
    and from a no-grad loss) and steps."""
    want = runs["single"][(arch, "train_groups2")]
    for r, out in enumerate(runs["ranks"]):
        _close(out[(arch, "train_groups2")], want, f"{arch} rank {r}")


@pytest.mark.parametrize("groups", (1, 2))
@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_on_a_data_mesh_route_the_reference_rows(runs, arch,
                                                              groups):
    """2 microbatches on (2, 1), on both MoE routes: microbatch i is the
    global rows [4i, 4i + 4) that the single device (and the reference)
    routes together, a data rank holding 2 of them, so capacity drops,
    losses, the aux loss and the params are the single device's."""
    want = runs["single"][(arch, "train_micro", groups)]
    for r, out in enumerate(runs["ranks"]):
        _close(out[(arch, "train_micro", groups)], want,
               f"{arch} groups {groups} rank {r}")


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

def test_place_model_keeps_expert_stacks_contraction_and_e_whole():
    """fp expert stacks split on their out dim only: on model=2 every
    stack halves its out dim; on model=4 with d_ff_expert 66 the rule's
    pick for w_gate/w_up (D, their contraction dim) moves to F, which
    does not divide, so they stay whole, and w_down splits D."""
    for model_size, ff in ((2, 64), (4, 66)):
        cfg = dataclasses.replace(_cfg(ARCHS[0]), d_ff_expert=ff)
        model = tapi.init_params(torch.Generator().manual_seed(0), cfg,
                                 "cpu")
        shd.place_model(model, cfg, StandInMesh({"data": 1,
                                                 "model": model_size}))
        E, D = cfg.n_experts, cfg.d_model
        for blk in model.blocks:
            for name, whole in (("w_gate", (E, D, ff)), ("w_up", (E, D, ff)),
                                ("w_down", (E, ff, D))):
                k = getattr(blk.mlp, name).kernel
                if whole[2] % model_size:
                    assert tuple(k.shape) == whole, name
                    assert not hasattr(k, "_model_shard")
                else:
                    assert tuple(k.shape) == whole[:2] + (
                        whole[2] // model_size,), name
                    assert k._model_shard == (2, model_size, 0), name


@pytest.mark.parametrize("kind", ["fp", "claq"])
def test_absorbed_decode_on_local_heads_is_the_whole_decodes_heads(kind):
    """``_absorbed_decode`` with ``kv_up`` placed (a dense column block or
    a shard-local plan) and q cut to its heads equals those heads of the
    whole-head decode, bitwise."""
    cfg = _cfg(ARCHS[1])
    model = tapi.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    if kind == "claq":
        from repro_torch.core import CLAQConfig
        from repro_torch.launch.quantize import quantize_model_params
        quantize_model_params(model, cfg, {}, CLAQConfig(
            bits=3, method="kmeans", kmeans_iters=2, gptq_blocksize=32))
        prepare_tree(model, bn=ENGINE["plan_bn"])
    p = model.blocks[0].attn
    H, dn, dr, dv = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim, \
        cfg.v_head_dim
    gen = torch.Generator().manual_seed(3)
    B, S = 3, 16
    q_nope = torch.randn((B, 1, H, dn), generator=gen)
    q_pe = torch.randn((B, 1, H, dr), generator=gen)
    c_all = torch.randn((B, S, cfg.kv_lora), generator=gen)
    pe_all = torch.randn((B, S, dr), generator=gen)
    kv_len = torch.tensor([5, 16, 9])
    whole = tmla._absorbed_decode(p, q_nope, q_pe, c_all, pe_all, kv_len,
                                  cfg)
    k = p.kv_up.kernel
    for index in range(2):
        if kind == "claq":
            p.kv_up.kernel = local_plan(k, 2, index)
        else:
            n = k.shape[1] // 2
            local = k[:, index * n:(index + 1) * n].contiguous()
            local._model_shard = (1, 2, index)
            p.kv_up.kernel = local
        heads = tmla.head_block(p, cfg)
        assert heads == slice(index * H // 2, (index + 1) * H // 2)
        got = tmla._absorbed_decode(p, q_nope[:, :, heads],
                                    q_pe[:, :, heads], c_all, pe_all, kv_len,
                                    cfg)
        assert torch.equal(got, whole[:, :, heads]), (kind, index)
    p.kv_up.kernel = k
    assert tmla.head_block(p, cfg) is None
