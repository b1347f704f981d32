"""The dry run and its cost accounting (``repro_torch.launch.dryrun``,
``repro_torch.dist.op_analysis``, ``repro_torch.dist.standin``) held to
the reference's analytic functions and to a real 4-rank gloo run.

  * ``count_params`` and ``model_flops`` equal the reference's for every
    arch of ``ARCH_IDS`` and every cell of ``SHAPES``, exactly;
  * ``input_specs`` and ``cache_specs`` (in the reference's stacked
    layout) have the reference's shapes and dtypes for every applicable
    (arch, shape);
  * ``quantize_param_sds`` at quant "2.12" has the reference's stand-in
    shapes (the port's int32 planes are its uint32 ones);
  * the dry run of the smoke llama on a (2, 2) stand-in mesh records the
    collectives (kind, count and bytes, in order) of an op trace of the
    real 4-rank gloo run: a train step, a decode step and a decode step
    on shard-local CLAQ plans;
  * ``analyze_ops`` charges a hand-counted function its FLOPs and
    elementwise weights (the counterpart of ``tests/test_dist.py``'s
    analyzer tests, which fail under this JAX; ``analyze_hlo``'s numbers
    are not a yardstick here);
  * a dense model's figures extrapolated from 1 and 2 layers equal a
    4-layer trace's;
  * ``run_cell`` on the single production mesh gives "ok" for
    ``llama1_7b|train_4k``, ``qwen3_moe_30b_a3b|train_4k``,
    ``rwkv6_7b|decode_32k``, ``zamba2_1p2b|long_500k`` and
    ``seamless_m4t_medium|train_4k``; ``main`` caches finished cells.

The reference's ``launch/dryrun.py`` forces 512 host devices through
``XLA_FLAGS`` at import: it is imported after JAX's backend is up and the
variable is restored.  JAX is imported lazily (the spawned ranks import
this module and run the port only).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.analysis import op_trace  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeCell,  # noqa: E402
                                 cell_applicable, get_config)
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.dist import collectives as coll  # noqa: E402
from repro_torch.dist import context as dctx  # noqa: E402
from repro_torch.dist import op_analysis  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.dist.standin import StandInMesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import api  # noqa: E402

MESH = {"data": 2, "model": 2}
TRAIN = ShapeCell("smoke_train", 32, 8, "train")
DECODE = ShapeCell("smoke_decode", 32, 4, "decode")
PLAN_BN = 32                      # smoke matrices split only with bn 32


def _ref():
    """The reference's dry-run module, imported without its 512-device
    flag taking effect (the backend is up first)."""
    import jax
    jax.config.update("jax_platform_name", "cpu")
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


def _jcfg(arch):
    from repro.configs import get_config as jget
    return jget(arch)


def _ref_leaves(tree):
    import jax
    return [(jax.tree_util.keystr(p), tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


_DTYPE = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.int32: "int32", torch.int64: "int64", torch.int8: "int8",
          torch.float16: "float16", torch.bool: "bool"}


def _port_leaves(tree):
    """(keystr, shape, dtype) in the reference's layout; a LayerStack of
    QuantizedTensors expands into its data leaves with the layer axis."""
    out = []
    for name, leaf in tree_lib.flatten(tree):
        if isinstance(leaf, tree_lib.LayerStack) and \
                not isinstance(leaf[0], torch.Tensor):
            for suffix, t in tree_lib.flatten(leaf[0]):
                out.append((name + suffix, (len(leaf),) + tuple(t.shape),
                            _DTYPE[t.dtype]))
        else:
            t = leaf[0] if isinstance(leaf, tree_lib.LayerStack) else leaf
            out.append((name, shd.leaf_shape(leaf), _DTYPE[t.dtype]))
    return out


# --------------------------------------------------------- analytic parity

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_and_model_flops_equal_reference(arch):
    ref = _ref()
    cfg, jcfg = get_config(arch), _jcfg(arch)
    counts = dryrun.count_params(cfg)
    assert counts == ref.count_params(jcfg)
    for cell in SHAPES:
        assert dryrun.model_flops(cfg, cell, counts) == \
            ref.model_flops(jcfg, cell, counts), cell.name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_specs_equal_reference(arch):
    from repro.models import api as japi
    cfg, jcfg = get_config(arch), _jcfg(arch)
    for cell in SHAPES:
        if not cell_applicable(cfg, cell)[0]:
            continue
        got = {k: (tuple(v.shape), _DTYPE[v.dtype])
               for k, v in api.input_specs(cfg, cell).items()}
        want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
                for k, v in japi.input_specs(jcfg, cell).items()}
        assert got == want, cell.name
        assert all(v.is_meta for v in api.input_specs(cfg, cell).values())
        if cell.kind == "train":
            continue
        cache = api.cache_specs(cfg, cell)
        if cfg.family == "encdec":       # stacked self-attention caches
            tree = cache._replace(self_kv=shd.cache_tree(cache.self_kv, cfg))
        else:
            tree = shd.cache_tree(cache, cfg)
        assert all(t.is_meta for t in tree_lib.tensors(tree))
        assert _port_leaves(tree) == \
            _ref_leaves(japi.cache_specs(jcfg, cell)), cell.name


@pytest.mark.parametrize("arch", ["llama1_7b", "qwen3_moe_30b_a3b",
                                  "deepseek_v2_236b"])
def test_quantized_standins_equal_reference(arch):
    import jax
    from repro.core import APConfig, CLAQConfig, ORConfig
    from repro.models import api as japi
    ref = _ref()
    cfg, jcfg = get_config(arch), _jcfg(arch)
    jq = CLAQConfig(bits=2, ap=APConfig(2 + 0.12 * 0.6, 2, 4),
                    orr=ORConfig(0.12 * 0.4))
    want = _ref_leaves(ref.quantize_param_sds(jax.eval_shape(
        lambda: japi.init_params(jax.random.PRNGKey(0), jcfg)), jcfg, jq))
    params = convert.param_tree(api.init_params(torch.Generator(), cfg,
                                                "meta"), cfg)
    got = _port_leaves(dryrun.quantize_param_sds(
        params, cfg, dryrun.quant_config("2.12")))
    assert [n for n, _, _ in got] == [n for n, _, _ in want]
    for (n, gs, gd), (_, ws, wd) in zip(got, want):
        assert gs == ws, n
        assert gd == wd.replace("uint32", "int32"), n
    assert any(".stripes[1].packed" in n for n, _, _ in got)


# ----------------------------------------------------------- op analysis

def test_op_analysis_counts_a_hand_counted_function():
    """exp(x + x) @ x, a divide, then a transposed copy: the matmul's
    2 * 32^3 FLOPs; 1 per element for the add, 8 for the exp, 4 for the
    divide; the views are free and the result bytes of every other op
    (add, exp, mm, div and the copy) are charged."""
    x = torch.ones((32, 32), device="meta")

    def fn():
        z = torch.exp(x + x) @ x
        return (z / 3.0).T.reshape(-1)

    _, trace = op_trace.record(fn)
    got = op_analysis.analyze_ops(trace)
    n = 32 * 32
    assert got["flops"] == 2 * 32 ** 3
    assert got["elementwise_flops"] == (1 + 8 + 4) * n
    assert got["hbm_bytes"] == 5 * n * 4
    assert got["collective_bytes"] == 0


def test_standin_mesh_takes_meta_tensors_only():
    mesh = StandInMesh(MESH)
    with pytest.raises(TypeError, match="meta"):
        coll.all_gather(torch.zeros((2, 4)), dim=-1, mesh=mesh)
    y, trace = op_trace.record(lambda: coll.all_gather(
        torch.zeros((2, 4), device="meta"), dim=-1, mesh=mesh))
    assert tuple(y.shape) == (2, 8) and y.is_meta
    assert op_trace.collective_instructions(trace) == [("all-gather", 64)]
    assert op_analysis.collective_groups(trace) == [("all-gather", 2, 64)]


def test_standin_mesh_records_the_page_exchange():
    """The page exchange over "dp" on a stand-in mesh (rank 0 of data 2):
    a meta tensor of the rows it receives, one all-to-all recorded with
    its bytes; a real tensor raises."""
    mesh = StandInMesh(MESH)
    counts = ((0, 3), (5, 0))
    with pytest.raises(TypeError, match="meta"):
        coll.exchange(torch.zeros((3, 4, 8)), counts, mesh=mesh)
    y, trace = op_trace.record(lambda: coll.exchange(
        torch.zeros((3, 4, 8), device="meta"), counts, mesh=mesh))
    assert tuple(y.shape) == (5, 4, 8) and y.is_meta
    assert op_trace.collective_instructions(trace) == [("all-to-all",
                                                        5 * 4 * 8 * 4)]


# ------------------------------------------------- against a 4-rank run

def _smoke():
    return dataclasses.replace(t_smoke("llama1_7b"), d_model=64, vocab=128,
                               n_layers=2)


def _quantized_smoke():
    """The smoke llama with every block matrix a shard-splittable CLAQ
    plan (3-bit K-Means codes in weight space)."""
    from repro_torch.core import CLAQConfig
    from repro_torch.kernels.plan import prepare_tree
    from repro_torch.launch.quantize import quantize_model_params
    cfg = _smoke()
    model = api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    quantize_model_params(model, cfg, {}, CLAQConfig(
        bits=3, method="kmeans", kmeans_iters=2, gptq_blocksize=32))
    return prepare_tree(model, bn=PLAN_BN), cfg


def _real_rank(rank, world, dev):
    """One rank of the (2, 2) gloo mesh: the collectives of a train step,
    a decode step, and a decode step on CLAQ plans, from op traces."""
    from repro_torch.optim import OptimConfig, init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.train.step import local_batch
    mesh = mesh_lib.make_debug_mesh((2, 2), device_type="cpu")
    out = {}
    cfg = _smoke()
    model = api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    shd.place_model(model, cfg, mesh)
    ocfg = OptimConfig(total_steps=10000)
    opt = init_opt_state(convert.param_tree(model, cfg), ocfg)
    step = make_train_step(cfg, ocfg)
    batch = {"tokens": torch.randint(0, cfg.vocab, (TRAIN.global_batch,
                                                     TRAIN.seq_len),
                                     generator=torch.Generator()
                                     .manual_seed(1))}
    with dctx.use_mesh(mesh):
        _, trace = op_trace.capture(lambda: step(model, opt, batch))
    out["train"] = op_trace.collective_instructions(trace)
    for tag, (model, cfg) in (("decode", (model, cfg)),
                              ("decode_q", _quantized_smoke())):
        shd.place_model(model, cfg, mesh)
        cache = shd.place_cache(api.make_cache(
            cfg, DECODE.global_batch, DECODE.seq_len, device="cpu"), cfg,
            mesh)
        tok = local_batch({"token": torch.arange(DECODE.global_batch)},
                          cfg, mesh)["token"]
        with dctx.use_mesh(mesh), torch.no_grad():
            _, trace = op_trace.capture(
                lambda: api.decode_step(model, cfg, tok, cache))
        out[tag] = op_trace.collective_instructions(trace)
    with pytest.raises(TypeError, match="stand-in"):
        coll.all_gather(torch.zeros((2, 4), device="meta"), dim=-1,
                        mesh=mesh)
    return out


@pytest.fixture(scope="module")
def real_ranks():
    import test_torch_dryrun as me
    return mesh_lib.run_local(me._real_rank, 4)


def _dry(cell, quant=None, cfg=None):
    mesh = StandInMesh(MESH)
    traced = dryrun.trace_cell(cfg or _smoke(), cell, mesh, quant,
                               plan_bn=PLAN_BN)
    return op_trace.collective_instructions(traced["trace"])


@pytest.mark.parametrize("tag", ["train", "decode", "decode_q"])
def test_dry_run_collectives_equal_a_real_4_rank_trace(real_ranks, tag):
    cell = TRAIN if tag == "train" else DECODE
    want = _dry(cell, quant="2.12" if tag == "decode_q" else None)
    assert want, tag
    kinds = {k for k, _ in want}
    assert "all-gather" in kinds and "all-reduce" in kinds
    for r in real_ranks:
        assert r[tag] == want, (tag, r[tag], want)


def test_layer_extrapolation_equals_a_full_trace():
    mesh = StandInMesh(MESH)
    cfg = dataclasses.replace(_smoke(), n_layers=4)
    full = dryrun.figures(dryrun.trace_cell(cfg, TRAIN, mesh))
    f1, f2 = (dryrun.figures(dryrun.trace_cell(
        dataclasses.replace(cfg, n_layers=n), TRAIN, mesh)) for n in (1, 2))
    got = dryrun.extrapolate(f1, f2, 4)
    assert got.keys() == full.keys()
    for k in full:
        assert got[k] == pytest.approx(full[k], rel=1e-12), k


# ------------------------------------------------------------- the runner

def test_run_cell_on_the_production_mesh():
    res = dryrun.run_cell("llama1_7b", "train_4k", False)
    assert res["status"] == "ok", res.get("traceback")
    assert res["chips"] == 256
    pd, rl = res["per_device"], res["roofline"]
    assert pd["hlo_flops"] > rl["model_flops_per_dev"] > 0
    assert pd["collectives"]["all-gather"] > 0
    assert pd["collectives"]["all-reduce"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert "H100" in rl["hardware"]
    res = dryrun.run_cell("qwen3_moe_30b_a3b", "train_4k", False)
    assert res["status"] == "ok", res.get("traceback")
    assert res["per_device"]["collectives"]["all-gather"] > 0
    for arch, shape in (("rwkv6_7b", "decode_32k"),
                        ("zamba2_1p2b", "long_500k")):
        res = dryrun.run_cell(arch, shape, False)
        assert res["status"] == "ok", (arch, res.get("traceback"))
        assert res["per_device"]["collectives"]["all-gather"] > 0
    res = dryrun.run_cell("seamless_m4t_medium", "train_4k", False)
    assert res["status"] == "ok", res.get("traceback")
    assert res["per_device"]["collectives"]["all-gather"] > 0
    assert dryrun.run_cell("llama1_7b", "long_500k", False)["status"] == \
        "skipped"


def test_main_caches_finished_cells(tmp_path, capsys):
    out = str(tmp_path / "dry.json")
    argv = ["--arch", "qwen2_1p5b,seamless_m4t_medium", "--shape",
            "decode_32k", "--mesh", "single", "--out", out]
    assert dryrun.main(argv) == 0
    first = capsys.readouterr().out
    assert "qwen2_1p5b|decode_32k|single -> ok" in first
    assert "seamless_m4t_medium|decode_32k|single -> ok" in first
    assert "2 ok, 0 skipped, 0 errors" in first
    with open(out) as f:
        cells = json.load(f)
    assert cells["qwen2_1p5b|decode_32k|single"]["status"] == "ok"
    assert dryrun.main(argv) == 0
    second = capsys.readouterr().out
    assert "->" not in second
    assert "2 ok, 0 skipped, 0 errors" in second
