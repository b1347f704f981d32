"""Multi-rank serving (``ServingEngine(mesh=...)``) on a 2x2 (data x
model) gloo mesh of 4 spawned CPU ranks, held to the single-device
engines of both packages.

The model is the AP+OR smoke llama the port's serving tests use,
quantized by the reference and converted, with ``plan_bn=32`` so its
128/256-row matrices split into whole tiles over model=2.  Every rank
runs the same requests (SPMD); the tokens must equal the port's
single-device engine's and the reference's single-device engine's
exactly: vanilla, int8 activations, paged fp pages, speculation (an fp
draft, so windows are rejected and rolled back) against vanilla, and
preemption/resume with the cache blocks unmoved — with the control plane
on (guards, a bounded queue, a priority preemption).  Each rank holds
1/tp of every sharded unit's plane bytes; the contract gate runs HLO-AG1
and HLO-CB1 clean on the profiled step and refuses an injected weight
all-gather.  The launcher runs its ``main`` on the same 4 ranks.  The
same ranks as a (pod 2, data 1, model 2) mesh serve the llama (also
speculatively) and the fp smoke qwen3-moe with exactly the (2, 2) mesh's
tokens and telemetry event streams.

A page pool whose rows split over "dp" (``kv_pages=31``: 32 rows, 16 a
data rank) is served on both meshes, fp and int8 pages: waves, prompts
sharing a prefix whose copy-on-write crosses ranks, preemption and
resume, speculation and chunked prefill, each rank emitting the single
device's tokens (and the reference's), with the single device's page
tables, allocator counters and telemetry event stream; the gate is clean
on it.  Every prefill whose batch "dp" divides runs half its rows on a
rank (a hook on ``models.api.prefill_step`` counts them); batch-1
prefills and resumes run every row.  The page exchange moves exactly the
pages a rank's slots name and another rank holds, bit for bit, and the
op trace records their bytes.  One spawn for the file, run beside the
reference's engines; JAX only in this process.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.kernels.plan import PreparedQuantizedTensor  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.serve import ServingEngine, SpecConfig  # noqa: E402

WAVE1 = [[1, 2, 3], [4, 5, 6, 7, 8, 9],
         [10, 11, 12, 13, 14, 15, 16, 17, 18], [20, 21]]
WAVE2 = [[7, 7, 7, 7, 7], [9, 8, 7]]
ENGINE = dict(n_slots=4, max_len=64, min_bucket=8, plan_bn=32)
VARIANTS = {"vanilla": {}, "int8": dict(act_dtype="int8"),
            "paged": dict(kv_layout="paged", page_size=8)}
# a pool of 32 page rows: 16 a data rank on a data axis of 2
SPLIT = dict(kv_layout="paged", page_size=8, kv_pages=31)
SPLIT_VARIANTS = {"split": SPLIT, "split_int8": {**SPLIT, "kv_dtype": "int8"}}
ROWS_A_RANK = 16
# three whole pages of 8 and a partial one, shared by every prompt
PREFIX = list(range(30, 57))
SHARED = [PREFIX + [1, 2], PREFIX + [3], PREFIX + [5, 6, 7], PREFIX + [8]]
ALLOCATOR = ("pages_in_use", "pages_free", "peak_pages_in_use",
             "peak_pages_per_request", "prefix_hits", "prefix_shared_tokens",
             "cow_copies", "page_evictions", "pages_allocated_total",
             "pages_freed_total", "registry_entries")


def _cfg():
    return dataclasses.replace(t_smoke("llama1_7b"), vocab=128, n_layers=2)


def _serve(eng, prompts, max_new=6):
    uids = eng.add_requests(prompts, max_new_tokens=max_new)
    eng.run_to_completion()
    fin = eng.take_finished()
    return [fin[u].tokens for u in uids]


def _waves(eng):
    return _serve(eng, WAVE1) + _serve(eng, WAVE2)


def _control_plane(eng):
    """Queued admission past the slots, a priority arrival that preempts,
    then a pressure window that preempts everyone: tokens, states and
    lifecycle counters."""
    uids = [eng.submit(p, max_new_tokens=8) for p in WAVE1 + WAVE2[:1]]
    eng.step()
    eng.step()
    uids.append(eng.submit(WAVE2[1], max_new_tokens=5, priority=3))
    eng.step()
    eng.set_cache_pressure(6)
    eng.step()
    eng.set_cache_pressure(None)
    eng.run_to_completion()
    fin = eng.take_finished()
    st = eng.stats()
    return ([fin[u].tokens for u in uids],
            [(fin[u].state.value, fin[u].preemptions) for u in uids],
            (st["preemptions"], st["resumes"], st["queue_peak_depth"]))


def _engine(tree, mesh=None, **kw):
    return ServingEngine(from_numpy_tree(tree, _cfg(), device="cpu"), _cfg(),
                         device="cpu", mesh=mesh, **{**ENGINE, **kw})


def _plane_bytes(model):
    """{module path: bytes of its plan's planes} of every quantized
    Dense."""
    out = {}
    for name, m in model.named_modules():
        k = getattr(m, "kernel", None)
        if isinstance(k, PreparedQuantizedTensor):
            out[name] = (sum(p.numel() * 4 for g in k.groups
                             for p in g.planes), k.shard)
    return out


def _inject_weight_gather(eng):
    """Patch the SwiGLU of the decode step to all-gather the largest
    sharded plane whole: the regression HLO-AG1 exists to catch."""
    from repro_torch.dist import collectives
    from repro_torch.models import layers
    plane = max((p for m in eng.params.modules()
                 if isinstance(getattr(m, "kernel", None),
                               PreparedQuantizedTensor)
                 and m.kernel.shard is not None
                 for g in m.kernel.groups for p in g.planes),
                key=lambda p: p.numel())
    orig = layers.swiglu_mlp

    def leaky(p, x):
        collectives.all_gather(plane, dim=0)
        return orig(p, x)
    return leaky, orig


def _moe_cfg():
    return dataclasses.replace(t_smoke("qwen3_moe_30b_a3b"), vocab=128,
                               n_layers=2)


def _telemetry_run(eng, clock):
    """``WAVE1 + WAVE2`` submitted through the queue, stepping with the
    ``StepClock`` advancing: (tokens, the telemetry event stream as
    sorted JSON: every admission, step and retirement decision)."""
    import json
    uids = [eng.submit(p, max_new_tokens=6) for p in WAVE1 + WAVE2]
    while eng.active or len(eng.queue):
        eng.step()
        clock.advance()
    fin = eng.take_finished()
    return ([fin[u].tokens for u in uids],
            json.dumps(eng.telemetry.events, sort_keys=True))


def _spec_engine(q_tree, fp_tree, mesh=None, **kw):
    """The AP+OR llama speculating with the fp model as its draft (its
    windows are rejected and rolled back)."""
    return _engine(q_tree, mesh, spec=SpecConfig(gamma=2, draft_bits=2),
                   draft_params=from_numpy_tree(fp_tree, _cfg(),
                                                device="cpu"), **kw)


def _pod_axis_runs(q_tree, fp_tree, mesh):
    """On ``mesh``: the AP+OR llama's waves (contiguous, paged and
    speculative), its control plane and its telemetry stream, and the fp
    smoke qwen3-moe's waves and telemetry stream (its MoE rows gathered
    over "dp")."""
    from repro_torch.serve import StepClock, Telemetry
    out = {}
    for tag, kw in (("vanilla", {}), ("paged", VARIANTS["paged"])):
        out[("llama", tag)] = _waves(_engine(q_tree, mesh, **kw))
    out[("llama", "spec")] = _waves(_spec_engine(q_tree, fp_tree, mesh))
    out[("llama", "control")] = _control_plane(
        _engine(q_tree, mesh, guards=True, queue_depth=8))
    clock = StepClock(10.0)
    out[("llama", "telemetry")] = _telemetry_run(_engine(
        q_tree, mesh, telemetry=Telemetry(), clock=clock), clock)
    cfg = _moe_cfg()

    def moe(**kw):
        model = tapi.init_params(torch.Generator().manual_seed(0), cfg,
                                 "cpu")
        return ServingEngine(model, cfg, device="cpu", mesh=mesh,
                             **{**ENGINE, **kw})
    out[("moe", "vanilla")] = _waves(moe())
    clock = StepClock(10.0)
    out[("moe", "telemetry")] = _telemetry_run(
        moe(telemetry=Telemetry(), clock=clock), clock)
    return out


def _shared(eng):
    """A first wave (so that later pages lie in the second half of the
    pool), then ``SHARED``: their prompts share three whole pages, and
    each one's first decode copies the shared partial page.  Tokens, and
    the copy-on-write pairs (old page, new page)."""
    pairs = []
    copy = eng._copy_pages

    def record(p):
        pairs.extend((int(o), int(n)) for o, n in p)
        copy(p)
    eng._copy_pages = record
    toks = _serve(eng, WAVE1)
    toks += _serve(eng, SHARED[:1], max_new=4) + _serve(eng, SHARED[1:])
    return toks, pairs


def _prefill_rows():
    """Patch ``models.api.prefill_step`` to note the (rows, tokens) of
    every prefill and chunk; returns the list and the undo."""
    from repro_torch.models import api
    seen, orig = [], api.prefill_step

    def hook(params, cfg, batch, cache, **kw):
        seen.append(tuple(batch["tokens"].shape))
        return orig(params, cfg, batch, cache, **kw)
    api.prefill_step = hook
    return seen, lambda: setattr(api, "prefill_step", orig)


def _split_runs(q_tree, fp_tree, mesh=None):
    """Serving from a pool whose rows split over "dp" on ``mesh`` (one
    device: the same pool whole): per page variant the waves' tokens,
    page tables, allocator counters and pool rows; prompts sharing a
    prefix; the control plane (preemption and resume); speculation;
    chunked prefill; the telemetry stream; and the (rows, tokens) of
    every prefill of each run."""
    from repro_torch.serve import StepClock, Telemetry
    out = {}
    seen, undo = _prefill_rows()
    try:
        for tag, kw in SPLIT_VARIANTS.items():
            eng = _engine(q_tree, mesh, **kw)
            out[(tag, "waves")] = _waves(eng)
            st = eng.stats()["paged"]
            out[(tag, "tables")] = eng._tables.tolist()
            out[(tag, "allocator")] = {k: st[k] for k in ALLOCATOR}
            out[(tag, "pool_rows")] = sorted({
                t.shape[0] for c in eng.cache for t in (c.kp, c.vp,
                                                        c.k_scale, c.v_scale)
                if t is not None})
            out[(tag, "shared")] = _shared(_engine(q_tree, mesh, **kw))
        out["control"] = _control_plane(
            _engine(q_tree, mesh, guards=True, queue_depth=8, **SPLIT))
        eng = _spec_engine(q_tree, fp_tree, mesh, **SPLIT)
        out["spec"] = _waves(eng)
        out["spec_pool_rows"] = eng.draft_cache[0].kp.shape[0]
        out["chunked"] = _waves(_engine(q_tree, mesh, chunked_prefill=16,
                                        **SPLIT))
        clock = StepClock(10.0)
        out["telemetry"] = _telemetry_run(_engine(
            q_tree, mesh, telemetry=Telemetry(), clock=clock, **SPLIT), clock)
    finally:
        undo()
    out["prefill_rows"] = list(seen)
    if mesh is not None:
        rep = _engine(q_tree, mesh, verify_contracts=True,
                      **SPLIT).contract_report
        out["gate"] = (rep.rules_run, [f.rule_id for f in rep.findings
                                       if f.severity.name == "ERROR"])
    return out


def _exchange_check(mesh):
    """The page exchange alone: a pool of 2 rows a "dp" rank and a seeded
    (2 slots a rank) x 3 table; this rank's view against the whole pool's
    (scratch zeroed), the pages sent and received against the pages this
    rank's slots name elsewhere and others' slots name here, and the
    bytes of the op trace's all-to-all."""
    from repro_torch.analysis import op_trace
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import context as dctx
    from repro_torch.dist import sharding as shd
    from repro_torch.models import layers
    D, me = shd.MeshAxes(mesh).dp_size, coll.dp_index(mesh)
    rows, ps = 2, 4
    whole = torch.arange(D * rows * ps * 6, dtype=torch.float32).reshape(
        D * rows, ps, 6)
    scale = torch.arange(D * rows * ps, dtype=torch.float32).reshape(
        D * rows, ps) + 0.5
    table = np.random.default_rng(1).integers(0, D * rows, (2 * D, 3))
    scratch = D * rows - 1
    blocks = shd.pool_blocks(D * rows, _cfg(), mesh)
    route = shd.page_route(table, blocks, True, "cpu")
    mine = slice(me * rows, (me + 1) * rows)
    with dctx.use_mesh(mesh):
        (pool_view, scale_view), trace = op_trace.capture(
            lambda: layers.placed_pool_view(
                [(whole[mine].clone(), None), (scale[mine].clone(), None)],
                route, torch.float32))
    t = torch.as_tensor(table[2 * me:2 * me + 2])
    keep = (t != scratch)[..., None, None]
    want = torch.where(keep, whole[t], 0).reshape(2, 3 * ps, 6)
    want_sc = torch.where(keep[..., 0], scale[t], 0).reshape(2, 3 * ps)

    def named(r):
        return set(table[2 * r:2 * r + 2].ravel().tolist()) - {scratch}
    sent = sum(p // rows == me for r in range(D) if r != me
               for p in named(r))
    got = sum(p // rows != me for p in named(me))
    page = ps * 6 * 4 + ps * 4
    return dict(view=torch.equal(pool_view, want),
                scale=torch.equal(scale_view, want_sc),
                sent=(sum(route.counts[me]), sent),
                received=(sum(c[me] for c in route.counts), got),
                collectives=op_trace.collective_instructions(trace),
                moved_bytes=max(sent, got) * page, ranks=D)


def _rank_main(rank, world, dev, q_tree, fp_tree):
    from repro_torch.analysis.artifacts import verify_engine
    from repro_torch.launch import serve
    from repro_torch.models import layers
    mesh = mesh_lib.make_debug_mesh((2, 2), device_type="cpu")
    out = {}
    for tag, kw in VARIANTS.items():
        eng = _engine(q_tree, mesh, **kw)
        out[tag] = _waves(eng)
        if tag == "vanilla":
            out["planes"] = _plane_bytes(eng.params)
            out["stats_mesh"] = eng.stats()["mesh"]
            out["cache_shape"] = tuple(eng.cache[0].k.shape)
    eng = _spec_engine(q_tree, fp_tree, mesh)
    out["spec"] = _waves(eng)
    st = eng.stats()
    out["spec_stats"] = (st["verify_traces"], st["draft_decode_traces"],
                         st["spec_drafted"], st["spec_accepted"])
    # control plane, and the cache blocks stay where they were placed
    eng = _engine(q_tree, mesh, guards=True, queue_depth=8)
    ptrs = [(c.k.data_ptr(), c.v.data_ptr()) for c in eng.cache]
    out["control"] = _control_plane(eng)
    out["pinned"] = ptrs == [(c.k.data_ptr(), c.v.data_ptr())
                             for c in eng.cache]
    # the contract gate, clean, then refusing an injected weight gather
    eng = _engine(q_tree, mesh, verify_contracts=True)
    rep = eng.contract_report
    out["gate"] = (rep.rules_run, [f.rule_id for f in rep.findings
                                   if f.severity.name == "ERROR"])
    leaky, orig = _inject_weight_gather(eng)
    layers.swiglu_mlp = leaky
    try:
        bad = verify_engine(eng, raise_on_error=False)
    finally:
        layers.swiglu_mlp = orig
    out["injected"] = sorted({f.rule_id for f in bad.findings})
    st = serve.main(["--arch", "llama1_7b", "--smoke", "--mesh-shape", "2x2",
                     "--backend", "gloo", "--device", "cpu", "--requests",
                     "3", "--max-new", "3", "--max-len", "32"])
    out["launcher"] = (st["mesh"], st["lifecycle"]["finished"])
    # the pod axis: (pod 2, data 1, model 2) against this (2, 2) mesh
    pod = mesh_lib.make_debug_mesh((2, 1, 2), ("pod", "data", "model"),
                                   device_type="cpu")
    out["pod_axis"] = {tag: _pod_axis_runs(q_tree, fp_tree, m)
                       for tag, m in (("data", mesh), ("pod", pod))}
    eng = _engine(q_tree, pod)
    out["pod_stats"] = (eng.stats()["mesh"], eng._rows,
                        tuple(eng.cache[0].k.shape))
    # a pool whose rows split over "dp", on both meshes
    out["split"] = {tag: _split_runs(q_tree, fp_tree, m)
                    for tag, m in (("data", mesh), ("pod", pod))}
    # the page exchange over data (2 ranks) and over pod x data (4)
    pods = mesh_lib.make_debug_mesh((2, 2, 1), ("pod", "data", "model"),
                                    device_type="cpu")
    out["exchange"] = [_exchange_check(m) for m in (mesh, pods)]
    return out


@pytest.fixture(scope="module")
def served():
    """The reference's AP+OR quantization, single-device tokens of both
    packages (the reference's contiguous and from a split-size int8
    pool), and the 4 ranks' results (the ranks run while this process
    runs the single-device engines)."""
    import threading

    import jax
    from repro.models import api as japi
    from repro.serve import ServingEngine as JaxEngine
    from test_torch_models import jax_tree_to_numpy, quantize_reference
    from test_torch_models import smoke_cfgs
    import test_torch_dist_serving as me
    jcfg, tcfg = smoke_cfgs()
    params = japi.init_params(jax.random.PRNGKey(0), jcfg)
    qparams = quantize_reference(params, jcfg)
    q_tree, fp_tree = jax_tree_to_numpy(qparams), jax_tree_to_numpy(params)
    box = {}
    spawn = threading.Thread(target=lambda: box.update(ranks=mesh_lib.run_local(
        me._rank_main, 4, q_tree, fp_tree)))
    spawn.start()
    try:
        ref = _waves(JaxEngine(qparams, jcfg, **ENGINE))
        single = {tag: _waves(_engine(q_tree, **kw))
                  for tag, kw in VARIANTS.items()}
        single["ref_split_int8"] = _waves(JaxEngine(
            qparams, jcfg, **ENGINE, **SPLIT_VARIANTS["split_int8"]))
        eng = _engine(q_tree)
        single["planes"] = _plane_bytes(eng.params)
        single["control"] = _control_plane(_engine(q_tree, guards=True,
                                                   queue_depth=8))
        single["split"] = _split_runs(q_tree, fp_tree)
    finally:
        spawn.join()
    assert "ranks" in box, "a rank failed (its error is above)"
    return ref, single, box["ranks"]


@pytest.mark.parametrize("tag", list(VARIANTS) + ["spec"])
def test_sharded_tokens_equal_single_device_and_reference(served, tag):
    """Every rank emits the single-device tokens, bit for bit: the port's
    engine with the same knob (speculation: vanilla's, as the reference's
    sharded speculative test holds it) and the reference's engine."""
    ref, single, ranks = served
    want = single["vanilla" if tag == "spec" else tag]
    assert single["vanilla"] == ref
    for r in ranks:
        assert r[tag] == want, (tag, r[tag], want)
    assert all(len(t) == 6 for t in want)


def test_speculation_rolls_back_on_the_mesh(served):
    _, _, ranks = served
    verify, draft, drafted, accepted = ranks[0]["spec_stats"]
    assert verify == 1 and draft == 1
    assert 0 < accepted < drafted        # windows were rejected and rolled
    assert all(r["spec_stats"] == ranks[0]["spec_stats"] for r in ranks)


def test_control_plane_decides_alike_on_every_rank(served):
    """Queue, priority preemption and a pressure window: every rank's
    tokens, states and counters are the single device's; the slot cache
    blocks were never re-allocated."""
    _, single, ranks = served
    assert single["control"][2][0] > 0 and single["control"][2][1] > 0
    for r in ranks:
        assert r["control"] == single["control"]
        assert r["pinned"]


def test_each_rank_holds_its_share_of_the_planes(served):
    """Every unit splits over model=2 (plan_bn=32), each rank holds half of
    its plane bytes, and the slot cache holds the rank's 2 of 4 slots and
    its KV head block."""
    _, single, ranks = served
    cfg = _cfg()
    for rank, r in enumerate(ranks):
        assert r["stats_mesh"] == {"data": 2, "model": 2}
        assert r["cache_shape"] == (2, 64, cfg.n_kv_heads // 2,
                                    cfg.head_dim)
        assert r["planes"].keys() == single["planes"].keys()
        for name, (b, shard) in r["planes"].items():
            whole, none = single["planes"][name]
            assert none is None and shard is not None
            assert (shard.parts, shard.index) == (2, rank % 2)
            assert 2 * b == whole, name


def test_gate_runs_collective_rules_and_refuses_a_weight_gather(served):
    _, _, ranks = served
    for r in ranks:
        rules, errors = r["gate"]
        assert "HLO-AG1" in rules and "HLO-CB1" in rules
        assert errors == []
        assert "HLO-AG1" in r["injected"]


def test_serve_launcher_on_four_ranks(served):
    _, _, ranks = served
    assert [r["launcher"] for r in ranks] == \
        [({"data": 2, "model": 2}, 3)] * 4


@pytest.mark.parametrize("arch", ["llama", "moe"])
def test_pod_axis_serves_the_data_mesh_tokens_and_decisions(served, arch):
    """(pod 2, data 1, model 2): slots split over "dp" = pod x data, the
    sampled tokens gathered over both, the MoE's rows routed over both:
    every rank emits the (2, 2) mesh's tokens and telemetry event stream
    exactly (llama also paged, speculatively (gamma 2) and through its
    control plane); both are the single device's tokens."""
    _, single, ranks = served
    for r, out in enumerate(ranks):
        data, pod = out["pod_axis"]["data"], out["pod_axis"]["pod"]
        keys = [k for k in data if k[0] == arch]
        assert len(keys) == (5 if arch == "llama" else 2)
        for k in keys:
            assert pod[k] == data[k], (r, k)
        if arch == "llama":
            assert data[("llama", "vanilla")] == single["vanilla"]
            assert data[("llama", "spec")] == single["vanilla"]
            assert data[("llama", "control")] == single["control"]
        tokens, stream = data[(arch, "telemetry")]
        assert tokens == data[(arch, "vanilla")]
        assert '"kind": "retire"' in stream


def test_pod_axis_check_and_paged_pool_refusal(served):
    """The mesh check admits a pod axis; a rank of (pod 2, data 1, model
    2) holds the slots of its pod (2 of 4) and its KV head block; a pool
    whose page rows split over "dp" is no longer refused: on the pod mesh
    as on the data mesh each rank holds its 16 of the 32 rows and serves
    the single device's tokens."""
    _, single, ranks = served
    cfg = _cfg()
    assert ServingEngine._check_mesh(SimpleNamespace(shape={
        "pod": 2, "data": 1, "model": 2}), cfg) == 4
    for r, out in enumerate(ranks):
        stats_mesh, rows, shape = out["pod_stats"]
        assert stats_mesh == {"pod": 2, "data": 1, "model": 2}
        assert rows == slice(2 * (r // 2), 2 * (r // 2) + 2)
        assert shape == (2, 64, cfg.n_kv_heads // 2, cfg.head_dim)
        pod = out["split"]["pod"]
        assert pod[("split", "pool_rows")] == [ROWS_A_RANK]
        assert pod[("split", "waves")] == single["split"][("split", "waves")]


# ---------------------------------------------------------------------------
# A pool split over "dp"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["data", "pod"])
@pytest.mark.parametrize("tag", list(SPLIT_VARIANTS))
def test_split_pool_serves_the_single_device_tokens_and_decisions(
        served, tag, mesh):
    """fp and int8 pages from a pool split over "dp": every rank holds 16
    of the 32 rows (pools and int8 scales) and emits the single device's
    tokens, which are the reference's (fp pages: its contiguous engine's;
    int8 pages: its engine's from the same pool), with the single
    device's page tables and allocator counters, byte for byte."""
    ref, single, ranks = served
    want = single["split"]
    assert want[("split", "waves")] == single["vanilla"] == ref
    assert want[("split_int8", "waves")] == single["ref_split_int8"]
    assert want[(tag, "pool_rows")] == [32]
    for r, out in enumerate(ranks):
        got = out["split"][mesh]
        assert got[(tag, "pool_rows")] == [ROWS_A_RANK], r
        for what in ("waves", "tables", "allocator"):
            assert got[(tag, what)] == want[(tag, what)], (r, tag, what)


@pytest.mark.parametrize("mesh", ["data", "pod"])
@pytest.mark.parametrize("tag", list(SPLIT_VARIANTS))
def test_split_pool_copies_shared_pages_across_ranks(served, tag, mesh):
    """Prompts sharing a prefix on a split pool: the single device's tokens
    and copy-on-write pairs, at least one of which copies a page one data
    rank holds into a page the other holds."""
    _, single, ranks = served
    toks, pairs = single["split"][(tag, "shared")]
    assert any(o // ROWS_A_RANK != n // ROWS_A_RANK for o, n in pairs)
    for r, out in enumerate(ranks):
        assert out["split"][mesh][(tag, "shared")] == (toks, pairs), r


@pytest.mark.parametrize("mesh", ["data", "pod"])
@pytest.mark.parametrize("what", ["control", "spec", "chunked", "telemetry"])
def test_split_pool_preempts_speculates_and_chunks(served, what, mesh):
    """On a split pool: the control plane's preemptions and resumes,
    speculation (its draft's pool splits too), chunked prefill and the
    telemetry event stream under a ``StepClock`` are the single device's,
    byte for byte."""
    _, single, ranks = served
    want = single["split"][what]
    if what == "control":
        assert want[2][0] > 0 and want[2][1] > 0
    if what in ("spec", "chunked"):
        assert want == single["vanilla"]
    for r, out in enumerate(ranks):
        assert out["split"][mesh][what] == want, (r, what)
        assert out["split"][mesh]["spec_pool_rows"] == ROWS_A_RANK


@pytest.mark.parametrize("mesh", ["data", "pod"])
def test_prefill_rows_split_over_data_ranks(served, mesh):
    """Every prefill and chunk of the split-pool runs, in order: where 2
    divides its batch a rank runs half of it, else (a batch of 1, every
    resume) every row; the tokens are unchanged (the tests above)."""
    _, single, ranks = served
    want = single["split"]["prefill_rows"]
    assert {b for b, _ in want} >= {1, 4}
    for r, out in enumerate(ranks):
        got = out["split"][mesh]["prefill_rows"]
        assert got == [(b // 2 if b % 2 == 0 else b, n) for b, n in want], r


def test_split_pool_gate_is_clean(served):
    """The contract gate on the split-pool engine: HLO-AG1 and HLO-CB1 run
    and find nothing, nor does any other rule."""
    _, _, ranks = served
    for out in ranks:
        for mesh in ("data", "pod"):
            rules, errors = out["split"][mesh]["gate"]
            assert {"HLO-AG1", "HLO-CB1", "HLO-HT1"} <= set(rules)
            assert errors == [], (mesh, errors)


@pytest.mark.parametrize("ranks_", [2, 4])
def test_page_exchange_moves_only_named_pages(served, ranks_):
    """The exchange over "dp" of 2 ranks (data) and 4 (pod x data): each
    rank's view of its slots' pages is the whole pool's, bit for bit
    (scratch read as zeros); it sends exactly the pages it holds that
    another rank's slots name and receives exactly the pages its slots
    name elsewhere, nothing held locally or unnamed; the op trace's one
    all-to-all records the larger of the two in bytes."""
    _, _, ranks = served
    for out in ranks:
        got = next(e for e in out["exchange"] if e["ranks"] == ranks_)
        assert got["view"] and got["scale"]
        assert got["sent"][0] == got["sent"][1]
        assert got["received"][0] == got["received"][1]
        assert got["collectives"] == ([("all-to-all", got["moved_bytes"])]
                                      if got["moved_bytes"] else [])


# ---------------------------------------------------------------------------
# One rank, in process
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank_world(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield mesh_lib.make_debug_mesh((1, 1), device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["llama1_7b", "rwkv6_7b",
                                  "qwen3_moe_30b_a3b"])
def test_one_rank_mesh_serves_every_family_as_no_mesh(one_rank_world, arch):
    """A (1, 1) mesh is the no-mesh engine: same tokens, and stats report
    the mesh."""
    cfg = dataclasses.replace(t_smoke(arch), n_layers=1, vocab=64)
    gen = torch.Generator().manual_seed(0)
    model = tapi.init_params(gen, cfg, "cpu")
    toks = []
    for mesh in (None, one_rank_world):
        eng = ServingEngine(model, cfg, n_slots=2, max_len=32, min_bucket=8,
                            device="cpu", mesh=mesh)
        toks.append(_serve(eng, [[1, 2, 3], [5, 6, 7, 8, 9]], max_new=4))
        st = eng.stats()
    assert toks[0] == toks[1]
    assert st["mesh"] == {"data": 1, "model": 1}


RECURRENT_SERVE = ["--smoke", "--requests", "3", "--max-new", "4",
                   "--max-len", "32", "--device", "cpu"]


def _recurrent_rank(rank, world, dev):
    from repro_torch.launch import serve
    return {arch: serve.main(["--arch", arch, "--mesh-shape", "1x2",
                              "--backend", "gloo"] + RECURRENT_SERVE)
            ["tokens"] for arch in ("rwkv6_7b", "zamba2_1p2b")}


@pytest.fixture(scope="module")
def recurrent_ranks():
    import test_torch_dist_serving as me
    return mesh_lib.run_local(me._recurrent_rank, 2)


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_1p2b",
                                  "seamless_m4t_medium"])
def test_multi_rank_mesh_refuses_unported_families(request, arch):
    """The mesh check admits every family; the engine refuses encdec on a
    mesh as it does without one (it serves decoder-only families, as the
    reference's); rwkv and the hybrid serve there: the serve launcher on
    (1, 2) emits its single-device tokens."""
    cfg = t_smoke(arch)
    mesh = SimpleNamespace(shape={"data": 1, "model": 2})
    assert ServingEngine._check_mesh(mesh, cfg) == 2
    if cfg.family == "encdec":
        model = tapi.init_params(torch.Generator().manual_seed(0), cfg,
                                 "cpu")
        with pytest.raises(NotImplementedError, match="decoder-only"):
            ServingEngine(model, cfg, n_slots=2, max_len=16, device="cpu",
                          mesh=mesh)
        return
    from repro_torch.launch import serve
    want = serve.main(["--arch", arch] + RECURRENT_SERVE)["tokens"]
    assert len(want) == 3 and all(len(t) == 4 for t in want)
    for r in request.getfixturevalue("recurrent_ranks"):
        assert r[arch] == want
