"""Port of tests/test_analysis.py: the contract checker in ``repro_torch``.

One mutation test per registered rule — a deliberately violated
invariant (a synthetic op trace or source file) must make exactly that
rule fire with its declared id/severity — and a skip test per rule on an
empty context; registry completeness against the reference's registry;
``Report`` rendering and JSON and ``TraceSentinel`` accounting equal to
the reference's; the AST rules clean over ``src/repro_torch``; the op
trace of real profiled calls (K1 folded, transfers counted); the engine
reports of the smoke ``dense`` and ``ap_or`` configs built as
``repro_torch.analysis.check`` builds them, pinned exactly, with every
departure from ``tests/golden/contracts_*.json`` named; the gate raising
on an injected violation, green over the moe, MLA, rwkv, hybrid,
paged-int8 and chunked + controller engines, leaving the engine as it
found it; tokens and ``stats()`` unchanged by the gate (fp and AP+OR
plans) and, with the replay report, equal to the JAX engine's under its
gate; and the CLIs on the CPU."""
import copy
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.analysis as JA  # noqa: E402
import repro.serve as J  # noqa: E402
import repro_torch.serve as T  # noqa: E402
from repro.analysis.trace_rules import TraceSentinel as JaxSentinel  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.analysis import (AST_RULES, REGISTRY,  # noqa: E402
                                  ContractViolation, Finding, Report, Rule,
                                  Severity, ast_context, register,
                                  run_rules)
from repro_torch.analysis import artifacts as afx  # noqa: E402
from repro_torch.analysis import check as check_cli  # noqa: E402
from repro_torch.analysis import op_trace as OT  # noqa: E402
from repro_torch.analysis.trace_rules import TraceSentinel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.core import APConfig, CLAQConfig, ORConfig  # noqa: E402
from repro_torch.kernels import dequant_matmul as dm  # noqa: E402
from repro_torch.launch.quantize import quantize_model_params  # noqa: E402
from repro_torch.models import api  # noqa: E402
from test_torch_models import jax_tree_to_numpy, smoke_cfgs  # noqa: E402
from test_torch_serving import _assert_tokens_match  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).parent / "golden"
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8]]


# ---------------------------------------------------------------------------
# synthetic op traces for the step-artifact mutations
# ---------------------------------------------------------------------------

def _rec(name, shapes=(), dtypes=(), kind="op", path=(), site=-1):
    nbytes = sum(OT._bytes(s, d) for s, d in zip(shapes, dtypes))
    return OT.OpRecord(name, kind, tuple(shapes), tuple(dtypes), nbytes,
                       tuple(path), site)


def _trace(*body, leaves=None):
    """A one-step trace: the token upload, ``body``, the one transfer."""
    return OT.OpTrace([_rec(OT.TO_DEVICE), *body, _rec(OT.TO_HOST)],
                      leaves=leaves)


_MM = _rec("aten::mm", ((8, 16), (16, 16)), ("float", "float"))
_CLEAN = _trace(_MM)
_ALIGNED_PLAN = {"has_plans": True, "n_permuted_groups": 0, "max_bk": 0,
                 "bm": 8, "itemsize": 4}
_PERMUTED_PLAN = {"has_plans": True, "n_permuted_groups": 1, "max_bk": 16,
                  "bm": 8, "itemsize": 4}


def _site(permuted, *modes):
    """One prepared matmul (record 0 of the trace) and its K1 launches."""
    return [_rec(f"{OT.QMATMUL}[permuted={permuted}]")] + [
        _rec(f"{OT.K1}[{m}]", path=(f"{OT.QMATMUL}[permuted={permuted}]",),
             site=0) for m in modes]


def _sentinel_over_budget():
    s = TraceSentinel()
    s.observe("prefill", (1, 8))
    s.observe("prefill", (1, 16))
    s.observe("prefill", (2, 8))
    return {"sentinel": s, "compile_budget": {"prefill": 2}}


def _sentinel_retrace():
    s = TraceSentinel()
    s.observe("decode", (2,))
    return {"sentinel": s, "trace_counts": {"decode": 3}}


def _write(tmp: Path, rel: str, source: str) -> Path:
    p = tmp / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(source)
    return p


# Every mutation: rule id -> ctx builder that VIOLATES exactly that
# invariant.  The AST entries lint real files under tmp_path; the step
# bodies are found by path suffix, as in the repo.
MUTATIONS = {
    "HLO-AG1": lambda tmp: {
        "ops": {"decode": _trace(_rec("c10d::all_gather_into_tensor",
                                      ((64, 16), (16, 16)),
                                      ("float", "float")))},
        "weight_shard_bytes": 1024, "collective_budget_bytes": 1 << 30},
    "HLO-CB1": lambda tmp: {
        "ops": {"decode": _trace(_rec("c10d::allreduce_", ((64, 16),),
                                      ("float",)))},
        "collective_budget_bytes": 1024},
    "HLO-HT1": lambda tmp: {
        "ops": {"decode": _trace(_MM, _rec("aten::item", ((),), ("float",)),
                                 _rec("aten::_local_scalar_dense", ((),),
                                      ("float",), path=("aten::item",)))}},
    "HLO-DT1": lambda tmp: {
        "ops": {"decode": _trace(_rec("aten::copy_", ((4, 64), (4, 64)),
                                      ("float", "signed char")))},
        "pool_slice_elems": 64},
    "HLO-GA1": lambda tmp: {
        "ops": {"decode": _trace(_MM, _rec("aten::index", ((2, 16), (2,)),
                                           ("float", "long int")))},
        "dense_ops": {"decode": _CLEAN},
        "plan": dict(_ALIGNED_PLAN)},
    "HLO-CP1": lambda tmp: {
        "ops": {"decode": _trace(_rec("aten::copy_", ((16, 16), (16, 16)),
                                      ("float", "float"),
                                      path=("aten::clone",)))},
        "cache_leaf_bytes": 16 * 16 * 4},
    "HLO-DN1": lambda tmp: {
        "ops": {"decode": _trace(_MM, leaves={"0.k": True,
                                              "0.state": False})},
        "donation_expected": True},
    "TRC-CC1": lambda tmp: _sentinel_over_budget(),
    "TRC-SG1": lambda tmp: _sentinel_retrace(),
    "AST-IM1": lambda tmp: ast_context([_write(
        tmp, "m.py", "import torch\nx = torch.zeros((3,))\n")]),
    "AST-JT1": lambda tmp: ast_context([_write(
        tmp, "repro_torch/models/api.py",
        "def decode_step(x):\n    global evil\n    evil = 1\n"
        "    return x\n")]),
    "AST-HS1": lambda tmp: ast_context([_write(
        tmp, "repro_torch/models/api.py",
        "def decode_step(x):\n    return x.item()\n")]),
    "AST-DT1": lambda tmp: ast_context([_write(
        tmp, "repro_torch/serve/sched.py",
        "import time\ndef tick():\n    return time.time()\n")]),
}


def test_registry_is_complete():
    """Every registered rule has a mutation test, and the registry holds
    the reference's 13 ids at the reference's severities."""
    assert set(MUTATIONS) == set(REGISTRY)
    assert {k: r.severity.name for k, r in REGISTRY.items()} == {
        k: r.severity.name for k, r in JA.REGISTRY.items()}
    assert len(REGISTRY) == 13


@pytest.mark.parametrize("rule_id", sorted(MUTATIONS))
def test_mutation_fires_rule(rule_id, tmp_path):
    rule = REGISTRY[rule_id]
    rep = run_rules([rule], MUTATIONS[rule_id](tmp_path), subject=rule_id)
    assert rep.findings, f"{rule_id} did not fire on a seeded violation"
    assert all(f.rule_id == rule_id for f in rep.findings)
    assert all(f.severity is rule.severity for f in rep.findings)
    assert rep.rules_run == [rule_id]


@pytest.mark.parametrize("rule_id", sorted(MUTATIONS))
def test_mutation_fires_only_its_rule(rule_id, tmp_path):
    """Every other rule stays quiet on one rule's seeded violation."""
    ctx = MUTATIONS[rule_id](tmp_path)
    others = [r for k, r in sorted(REGISTRY.items()) if k != rule_id]
    rep = run_rules(others, ctx)
    assert not rep.findings, rep.render()


@pytest.mark.parametrize("rule_id", sorted(MUTATIONS))
def test_rule_skips_on_empty_context(rule_id):
    """With none of its context keys present every rule reports skipped,
    never a false finding (and never a crash)."""
    rep = run_rules([REGISTRY[rule_id]], {}, subject="empty")
    assert rep.rules_skipped == [rule_id] and not rep.findings


# ---------------------------------------------------------------------------
# targeted clean-path checks (the mutation's conforming twin)
# ---------------------------------------------------------------------------

def test_gather_parity_permuted_branch():
    """Permuted plans: one gathered K1 launch per permuted group at a call
    site passes; more, a gathered launch of an x-aligned plan, or a torch
    gather the dense twin lacks fails."""
    rule = REGISTRY["HLO-GA1"]
    dense = {"decode": _CLEAN}
    ok = OT.OpTrace(_site(1, "aligned", "gathered") + [_rec(OT.TO_HOST)])
    rep = run_rules([rule], {"ops": {"decode": ok}, "dense_ops": dense,
                             "plan": dict(_PERMUTED_PLAN)})
    assert rep.rules_run == ["HLO-GA1"] and not rep.findings
    twice = OT.OpTrace(_site(1, "gathered", "gathered") + [_rec(OT.TO_HOST)])
    assert run_rules([rule], {"ops": {"decode": twice}, "dense_ops": dense,
                              "plan": dict(_PERMUTED_PLAN)}).findings
    aligned = OT.OpTrace(_site(0, "gathered") + [_rec(OT.TO_HOST)])
    assert run_rules([rule], {"ops": {"decode": aligned},
                              "dense_ops": dense,
                              "plan": dict(_ALIGNED_PLAN)}).findings
    # the same gather in both traces cancels
    emb = _rec("aten::embedding", ((128, 16), (2, 1)), ("float", "long int"))
    both = {"decode": _trace(emb)}
    assert not run_rules([rule], {"ops": both, "dense_ops": both,
                                  "plan": dict(_ALIGNED_PLAN)}).findings


def test_host_transfer_budget_on_the_card():
    """On the card each helper call pays for one memcpy in its direction
    and one synchronisation; a further memcpy or sync is a finding, and
    so is a step with no (or two) to_host."""
    rule = REGISTRY["HLO-HT1"]
    ok = OT.OpTrace([
        _rec(OT.TO_DEVICE), _rec("cudaMemcpyAsync", kind="runtime"),
        _rec("cudaStreamSynchronize", kind="runtime"), _MM,
        _rec(OT.TO_HOST), _rec("cudaMemcpyAsync", kind="runtime"),
        _rec("cudaStreamSynchronize", kind="runtime"),
        _rec("Memcpy HtoD (Pageable -> Device)", kind="device"),
        _rec("Memcpy DtoH (Device -> Pageable)", kind="device")])
    assert not run_rules([rule], {"ops": {"decode": ok}}).findings
    assert OT.transfer_counts(ok) == {"to_host": 1, "to_device": 1,
                                      "dtoh": 1, "htod": 1, "sync": 2,
                                      "scalar": 0}
    extra = copy.deepcopy(ok)
    extra.records += [_rec("Memcpy DtoH (Device -> Pageable)", kind="device"),
                      _rec("cudaStreamSynchronize", kind="runtime")]
    rep = run_rules([rule], {"ops": {"decode": extra}})
    assert len(rep.findings) == 1
    assert [t for t, _ in rep.findings[0].details["transfers"]] == [
        "Memcpy DtoH (Device -> Pageable)", "cudaStreamSynchronize"]
    none = OT.OpTrace([_MM])
    rep = run_rules([rule], {"ops": {"decode": none}})
    assert rep.findings and rep.findings[0].details["to_host"] == 0


def test_step_body_counter_allowlist_and_suppression(tmp_path):
    """K1's launch counters may be bumped inside a step body, and a
    ``# contract: ok`` comment suppresses any AST rule on that line."""
    ok = ast_context([_write(
        tmp_path, "a/repro_torch/kernels/dequant_matmul.py",
        "def dequant_matmul(x):\n"
        "    global launch_count, int8_launch_count\n"
        "    global aligned_launch_count, plain_count\n"
        "    launch_count += 1\n    return x\n")])
    assert not run_rules([REGISTRY["AST-JT1"]], ok).findings
    supp = ast_context([_write(
        tmp_path, "b/repro_torch/models/api.py",
        "def decode_step(x):\n"
        "    global evil  # contract: ok - exercised in tests\n"
        "    evil = 1\n    return x\n")])
    assert not run_rules([REGISTRY["AST-JT1"]], supp).findings
    # outside the step bodies the same write is not this rule's business
    other = ast_context([_write(
        tmp_path, "c/repro_torch/models/api.py",
        "def init_params(x):\n    global evil\n    evil = 1\n")])
    assert not run_rules([REGISTRY["AST-JT1"]], other).findings


@pytest.mark.parametrize("expr", ["x.tolist()", "x.cpu()", "x.numpy()",
                                  "float(x)", "int(x.sum())", "bool(x)"])
def test_host_sync_rule_fires_on_each_sync(expr, tmp_path):
    ctx = ast_context([_write(
        tmp_path, "repro_torch/models/layers.py",
        f"def gqa_attention(x):\n    return {expr}\n")])
    rep = run_rules([REGISTRY["AST-HS1"]], ctx)
    assert len(rep.findings) == 1, rep.render()


def test_host_sync_rule_allows_shape_math_and_the_helper(tmp_path):
    src = ("def gqa_attention(x):\n"
           "    n = x.shape[0]\n"
           "    return x * float(n) + float(len(x.shape)) + int(x.size(1))\n")
    ctx = ast_context([_write(tmp_path, "repro_torch/models/layers.py",
                              src)])
    assert not run_rules([REGISTRY["AST-HS1"]], ctx).findings
    helper = ast_context([_write(
        tmp_path, "repro_torch/serve/engine.py",
        "def to_host(t):\n    return t.cpu().numpy()\n")])
    assert not run_rules([REGISTRY["AST-HS1"]], helper).findings


def test_import_time_rule_ignores_function_bodies(tmp_path):
    src = ("import torch\n"
           "DTYPES = {torch.float32: 0}\n"
           "def f():\n    return torch.zeros((3,)).cuda()\n")
    ctx = ast_context([_write(tmp_path, "d.py", src)])
    assert not run_rules([REGISTRY["AST-IM1"]], ctx).findings
    for bad in ("torch.cuda.init()", "W = torch.ones(2).to('cuda')",
                "g = torch.Generator().manual_seed(0).cuda()"):
        ctx = ast_context([_write(tmp_path, "e.py",
                                  f"import torch\n{bad}\n")])
        assert run_rules([REGISTRY["AST-IM1"]], ctx).findings, bad


def test_determinism_rule_is_scoped(tmp_path):
    """time.time() outside the serve scope is not this rule's business."""
    ctx = ast_context([_write(
        tmp_path, "tools/bench.py",
        "import time\ndef t():\n    return time.time()\n")])
    assert not run_rules([REGISTRY["AST-DT1"]], ctx).findings


def test_determinism_rule_telemetry_carveout(tmp_path):
    """serve/telemetry.py is the ONE sanctioned clock source on serve
    paths: a wall-clock read there is clean, while the identical call in
    any OTHER repro_torch/serve file still fires."""
    src = "import time\ndef monotonic():\n    return time.monotonic()\n"
    ok = ast_context([_write(tmp_path, "repro_torch/serve/telemetry.py",
                             src)])
    assert not run_rules([REGISTRY["AST-DT1"]], ok).findings
    bad = ast_context([_write(tmp_path, "repro_torch/serve/engine.py", src)])
    rep = run_rules([REGISTRY["AST-DT1"]], bad)
    assert rep.findings and all(f.rule_id == "AST-DT1"
                                for f in rep.findings)


def test_determinism_rule_torch_rng_needs_a_generator(tmp_path):
    src = ("import torch\ndef f(g):\n"
           "    a = torch.randn(3, generator=g)\n"
           "    return a + torch.randint(0, 4, (3,))\n")
    ctx = ast_context([_write(tmp_path, "repro_torch/serve/x.py", src)])
    rep = run_rules([REGISTRY["AST-DT1"]], ctx)
    assert [f.details["call"] for f in rep.findings] == ["torch.randint"]


def test_donation_rule_clean_when_in_place():
    rep = run_rules([REGISTRY["HLO-DN1"]], {
        "ops": {"decode": _trace(_MM, leaves={"0.k": True, "0.v": True})},
        "donation_expected": True})
    assert rep.rules_run == ["HLO-DN1"] and not rep.findings


# ---------------------------------------------------------------------------
# framework plumbing, against the reference's
# ---------------------------------------------------------------------------

def test_register_rejects_duplicates_and_blank_ids():
    class Dup(Rule):
        id = "HLO-AG1"

    class Blank(Rule):
        id = ""

    with pytest.raises(ValueError, match="duplicate"):
        register(Dup())
    with pytest.raises(ValueError, match="no id"):
        register(Blank())


def test_report_render_and_json_equal_the_reference():
    """The same findings render and serialize byte for byte as the
    reference's ``Report`` does."""
    spec = [("X-1", "ERROR", "boom", "decode", {"n": 3, "b": [1, 2]}),
            ("Y-2", "WARNING", "meh", "", {}),
            ("Z-3", "INFO", "note", "f.py:3", {"call": "time.time"})]

    def build(mod_core):
        fs = [mod_core.Finding(r, mod_core.Severity[s], m, subject=sub,
                               details=d) for r, s, m, sub, d in spec]
        return mod_core.Report(subject="s", findings=fs,
                               rules_run=["Y-2", "X-1"],
                               rules_skipped=["W-0"])

    from repro.analysis import core as jcore
    from repro_torch.analysis import core as tcore
    t, j = build(tcore), build(jcore)
    assert t.render() == j.render()
    assert json.dumps(t.to_json()) == json.dumps(j.to_json())
    assert not t.clean and t.errors == [t.findings[0]]
    assert str(tcore.ContractViolation(t)) == str(jcore.ContractViolation(j))
    with pytest.raises(ContractViolation) as ei:
        raise ContractViolation(t)
    assert ei.value.report is t
    f = Finding("X-1", Severity.ERROR, "boom")
    assert Report("s", [f]).by_severity() == {"INFO": 0, "WARNING": 0,
                                              "ERROR": 1}


def test_trace_sentinel_accounting_equals_the_reference():
    calls = [("decode", (4, False)), ("decode", (4, False)),
             ("decode", (1, False)), ("prefill", (2, 16))]
    sents = []
    for cls in (TraceSentinel, JaxSentinel):
        s = cls()
        for name, sig in calls:
            s.observe(name, sig)
        s.observe_lowering("decode")
        sents.append(s)
    t, j = sents
    assert t.snapshot() == j.snapshot()
    assert t.snapshot()["decode"] == {"distinct": 2, "calls": 3,
                                      "lowerings": 1}
    for counts in ({"decode": 3}, {"decode": 4}, {"decode": 1},
                   {"prefill": 0}):
        got = run_rules([REGISTRY["TRC-SG1"]],
                        {"sentinel": t, "trace_counts": counts})
        want = JA.run_rules([JA.REGISTRY["TRC-SG1"]],
                            {"sentinel": j, "trace_counts": counts})
        assert json.dumps(got.to_json()) == json.dumps(want.to_json())
    got = run_rules([REGISTRY["TRC-CC1"]],
                    {"sentinel": t, "compile_budget": {"decode": 1}})
    want = JA.run_rules([JA.REGISTRY["TRC-CC1"]],
                        {"sentinel": j, "compile_budget": {"decode": 1}})
    assert got.findings and json.dumps(got.to_json()) == json.dumps(
        want.to_json())


def test_ast_rules_clean_over_the_port():
    rep = run_rules(AST_RULES, ast_context([REPO / "src" / "repro_torch"]),
                    subject="port")
    assert rep.rules_run == ["AST-IM1", "AST-JT1", "AST-HS1", "AST-DT1"]
    assert not rep.findings, rep.render()
    files = ast_context([REPO / "src" / "repro_torch"])["files"]
    steps = {f.path.name: [fn.name for fn in f.steps] for f in files
             if f.steps}
    # the step bodies are found where the table says they are
    assert {"dequant_matmul.py", "engine.py", "api.py", "layers.py",
            "moe.py", "ops.py"} <= set(steps)
    assert sorted(steps["engine.py"]) == ["_decode_batch", "_sample",
                                          "to_device", "to_host"]


# ---------------------------------------------------------------------------
# the op trace of real profiled calls
# ---------------------------------------------------------------------------

def test_capture_folds_k1_and_counts_transfers():
    """A plain K1 call is one record (its take is folded away); the
    helpers are counted; an ``item()`` outside ``to_host`` is a host
    transfer, inside it is not."""
    from repro_torch.serve.engine import to_device, to_host
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 64, generator=g)
    planes = (torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 64), generator=g,
                            dtype=torch.int64).to(torch.int32),)
    cb = torch.randn(64, 4, generator=g)
    idx = torch.arange(64, dtype=torch.int32).reshape(1, 64)

    def step():
        t = to_device(np.arange(4), "cpu")
        y = dm.dequant_matmul(x, planes, cb, None, None, bits=2, n=32,
                              x_mode="gathered", x_idx=idx)
        return to_host(y.argmax(-1) + t), y.sum().item()

    (_, _), tr = OT.capture(step)
    assert OT.k1_modes(tr) == {"gathered": 1}
    assert not OT.gather_instructions(tr), "K1's take was not folded"
    assert OT.transfer_counts(tr)["to_host"] == 1
    assert OT.transfer_counts(tr)["to_device"] == 1
    assert [n for n, _ in OT.host_transfer_instructions(tr)] == [
        "aten::_local_scalar_dense"]
    _, inside = OT.capture(lambda: to_host(x.sum()))
    assert not OT.host_transfer_instructions(inside)


def test_capture_reads_copies_and_converts():
    pool = torch.zeros(4, 8, dtype=torch.int8)
    (_, _), tr = OT.capture(lambda: (pool.float(), pool.clone()))
    assert ("s8", "f32", 32) in OT.convert_instructions(tr)
    assert ("aten::clone", 32) in OT.copy_instructions(tr)
    assert ("aten::_to_copy", 128) in OT.copy_instructions(tr)


# ---------------------------------------------------------------------------
# engine-integrated: reports, the gate, parity with the JAX engine
# ---------------------------------------------------------------------------

def _stable(report: Report):
    """Projection pinned by the goldens: which rules ran/skipped and which
    fired at what severity."""
    j = report.to_json()
    return {"subject": j["subject"], "clean": j["clean"],
            "rules_run": j["rules_run"],
            "rules_skipped": j["rules_skipped"],
            "findings": sorted({(f["rule"], f["severity"])
                                for f in j["findings"]})}


def _golden(name: str):
    doc = json.loads((GOLDEN / name).read_text())
    doc["findings"] = sorted(tuple(f) for f in doc["findings"])
    return doc


# The port's departures from the reference's golden reports, each with
# its reason; nothing else differs.
DEPARTURES = {
    "HLO-DN1": "runs (skipped in the goldens): the port updates its cache "
               "in place and the gate holds every cache leaf to it, where "
               "the reference's gate passes donation_expected=False on "
               "the CPU; it is clean on both configs",
}

PORT_DENSE = {
    "subject": "config:dense", "clean": True,
    "rules_run": ["HLO-CP1", "HLO-DN1", "HLO-HT1", "TRC-CC1", "TRC-SG1"],
    "rules_skipped": ["HLO-AG1", "HLO-CB1", "HLO-DT1", "HLO-GA1"],
    "findings": [("HLO-CP1", "WARNING")]}
PORT_AP_OR = {
    "subject": "config:ap_or", "clean": True,
    "rules_run": ["HLO-CP1", "HLO-DN1", "HLO-GA1", "HLO-HT1", "TRC-CC1",
                  "TRC-SG1"],
    "rules_skipped": ["HLO-AG1", "HLO-CB1", "HLO-DT1"],
    "findings": [("HLO-CP1", "WARNING")]}


def _departed(golden):
    """A golden with the named departures applied."""
    out = dict(golden)
    for rid in DEPARTURES:
        out["rules_skipped"] = [r for r in out["rules_skipped"] if r != rid]
        out["rules_run"] = sorted(out["rules_run"] + [rid])
    return out


@pytest.mark.parametrize("config,want,golden", [
    ("dense", PORT_DENSE, "contracts_dense.json"),
    ("ap_or", PORT_AP_OR, "contracts_ap_or.json")])
def test_engine_report(config, want, golden):
    """The smoke configs built as ``repro_torch.analysis.check`` builds
    them (the reference's CLI's configs): the port's report, pinned; it
    is the golden but for ``DEPARTURES``."""
    eng, dense_eng = check_cli._build_engine(config, "cpu")
    if config == "ap_or":
        assert afx.plan_stats(eng.params)["n_permuted_groups"] > 0, \
            "AP model produced no permuted plan -> vacuous report"
    rep = afx.verify_engine(eng, dense_eng, raise_on_error=False,
                            subject=f"config:{config}")
    assert _stable(rep) == want
    assert want == _departed(_golden(golden))


_WEIGHT_SPACE = CLAQConfig(bits=2, method="kmeans", kmeans_iters=2,
                           gptq_blocksize=32, ap=APConfig(2.2, 2, 4),
                           orr=ORConfig(0.1))


def _claq(model, cfg):
    """An AP+OR CLAQ copy of ``model``, quantized in weight space."""
    return quantize_model_params(copy.deepcopy(model), cfg, {},
                                 _WEIGHT_SPACE)[0]


@pytest.fixture(scope="module")
def models():
    """The JAX smoke llama, the port's copy of it, and an AP+OR CLAQ
    quantization of that copy."""
    jcfg, tcfg = smoke_cfgs()
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_numpy_tree(jax_tree_to_numpy(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp, _claq(tp, tcfg)


def test_dense_twin_matches_engine_structure(models):
    """The twin holds no plan, shares every other tensor with the engine's
    model, matches its slots, cache and layout, and serves."""
    _, tcfg, _, _, tq = models
    eng = T.ServingEngine(tq, tcfg, n_slots=2, max_len=32, device="cpu",
                          kv_layout="paged", page_size=8)
    twin = afx.dense_twin_engine(eng)
    assert not afx.plan_stats(twin.params)["has_plans"]
    assert (twin.n_slots, twin.max_len, twin._paged, twin.page_size) == (
        eng.n_slots, eng.max_len, True, 8)
    assert twin.params.embedding is eng.params.embedding
    toks, _ = _serve(twin)
    assert all(len(t) == 6 for t in toks)


def test_weight_shard_threshold(models):
    """One device: no threshold (the collective rules skip); over 4 model
    shards, the largest plane of a plan that splits into whole tiles."""
    _, tcfg, _, tp, _ = models
    eng = T.ServingEngine(_claq(tp, tcfg), tcfg, n_slots=2, max_len=32,
                          plan_bn=32, device="cpu")
    assert afx.weight_shard_threshold(eng.params, 1) is None
    t4 = afx.weight_shard_threshold(eng.params, 4)
    assert t4 is not None and t4 > 0


def _violating_trace(engine):
    return _trace(_MM, _rec("aten::_local_scalar_dense", ((),), ("float",)))


def test_verify_contracts_raises_on_violation(models, monkeypatch):
    """End-to-end mutation: force a violating step trace through the init
    gate and the engine must refuse to come up."""
    _, tcfg, _, tm, _ = models
    monkeypatch.setattr(afx, "decode_ops", _violating_trace)
    with pytest.raises(ContractViolation, match="HLO-HT1"):
        T.ServingEngine(tm, tcfg, n_slots=2, max_len=32, prepare=False,
                        verify_contracts=True, device="cpu")


def _snapshot(eng):
    """Everything of the engine the gate must leave as it was."""
    cache = [[None if t is None else t.clone() for t in c] for c in eng.cache]
    return dict(
        cache=cache, shapes={k: set(v) for k, v in eng.call_shapes.items()},
        per_shape=dict(eng.bucketing.stats.per_shape),
        stats=json.dumps(eng.stats(), sort_keys=True, default=str),
        sentinel=eng.sentinel.snapshot()["decode"]["calls"],
        clock=eng.clock(), last=eng.last_token.copy(),
        tables=None if not eng._paged else eng._tables.copy(),
        events=(None if eng.telemetry is None
                else json.dumps(eng.telemetry.events)))


def _same(a, b):
    for ca, cb in zip(a.pop("cache"), b.pop("cache")):
        for x, y in zip(ca, cb):
            assert (x is None) == (y is None)
            assert x is None or torch.equal(x, y)
    for k in ("last", "tables"):
        x, y = a.pop(k), b.pop(k)
        assert (x is None and y is None) or np.array_equal(x, y)
    assert a == b


@pytest.mark.parametrize("kw", [
    dict(), dict(kv_layout="paged", page_size=8, kv_dtype="int8")],
    ids=["contiguous", "paged_int8"])
def test_gate_leaves_the_engine_as_it_found_it(models, kw):
    """Mid-serve, a profiled decode (the gate's step) changes no cache
    bit, fill counter, call shape, bucketing stat, clock reading,
    telemetry event, page table or sentinel signature; it records one
    lowering, as the reference's ``lower_decode``."""
    _, tcfg, _, _, tq = models
    eng = T.ServingEngine(tq, tcfg, n_slots=2, max_len=32, device="cpu",
                          clock=T.StepClock(10.0), telemetry=T.Telemetry(),
                          **kw)
    eng.add_requests(PROMPTS, max_new_tokens=6)
    eng.step()
    before = _snapshot(eng)
    lowerings = eng.sentinel.lowerings["decode"]
    trace = afx.decode_ops(eng)
    after = _snapshot(eng)
    _same(before, after)
    assert eng.sentinel.lowerings["decode"] == lowerings + 1
    assert OT.k1_modes(trace)["gathered"] > 0
    assert OT.donation_aliases(trace) and not OT.moved_leaves(trace)


def _serve(eng):
    uids = eng.add_requests(PROMPTS, max_new_tokens=6)
    eng.run_to_completion()
    fin = eng.take_finished()
    st = eng.stats()
    return [fin[u].tokens for u in uids], st


@pytest.mark.parametrize("tag", ["fp", "claq"])
def test_gate_changes_no_token_or_stat_and_matches_the_reference(models,
                                                                 tag):
    """Tokens and ``stats()`` with the gate on are those without it (fp
    and AP+OR plans, where the dense twin runs too), and for the fp model
    the JAX engine's with its gate on (tokens under the near-tie rule;
    ``stats()`` equal, ``decode_traces`` included: the reference's
    lowering shares the decode trace, the port's gate records no call
    shape; the rules run differ by ``DEPARTURES`` alone)."""
    jcfg, tcfg, jp, tp, tq = models
    tm = tp if tag == "fp" else tq
    kw = dict(prepare=False) if tag == "fp" else {}
    off = _serve(T.ServingEngine(tm, tcfg, n_slots=2, max_len=32,
                                 device="cpu", **kw))
    on_eng = T.ServingEngine(tm, tcfg, n_slots=2, max_len=32, device="cpu",
                             verify_contracts=True, **kw)
    assert on_eng.contract_report.clean
    on = _serve(on_eng)
    assert on == off
    if tag != "fp":
        assert "HLO-GA1" in on_eng.contract_report.rules_run
        return
    jeng = J.ServingEngine(jp, jcfg, n_slots=2, max_len=32,
                           verify_contracts=True, **kw)
    jtoks, jst = _serve(jeng)
    _assert_tokens_match(tm, tcfg, PROMPTS, on[0], jtoks)
    assert on[1] == jst
    port_run = set(on_eng.contract_report.rules_run)
    ref_run = set(jeng.contract_report.rules_run)
    assert port_run - ref_run == set(DEPARTURES) and ref_run <= port_run


def test_replay_report_under_the_gate_equals_the_reference(models):
    """The reference's replay smoke (the gate stays green with telemetry
    attached): under StepClock + StepCostModel the port's report with the
    gate on is its report without it, and the JAX engine's with its gate
    on, byte for byte."""
    jcfg, tcfg, jp, tp, _ = models
    trace = T.synthesize_trace(seed=0, steps=16, vocab=128)

    def run(mod, params, cfg, gate, **kw):
        inj = mod.FaultInjector(seed=0, horizon=64, nan_faults=0,
                                inf_faults=0, transient_failures=0,
                                pressure_windows=2, pressure_len=(3, 6),
                                pressure_frac=(0.12, 0.22))
        eng = mod.ServingEngine(
            params, cfg, n_slots=3, max_len=48, min_bucket=8,
            clock=mod.StepClock(10.0), telemetry=mod.Telemetry(),
            faults=inj, on_pressure="preempt", verify_contracts=gate,
            cost_model=mod.StepCostModel(), **kw)
        if gate:
            assert eng.contract_report.clean
        return json.dumps(mod.Replayer(eng, trace).run(), sort_keys=True)

    on = run(T, tp, tcfg, True, device="cpu")
    assert on == run(T, tp, tcfg, False, device="cpu")
    jtrace = J.synthesize_trace(seed=0, steps=16, vocab=128)
    assert [a.to_json() for a in jtrace] == [a.to_json() for a in trace]
    assert on == run(J, jp, jcfg, True, prepare=False)


@pytest.mark.parametrize("arch,kw,warn", [
    ("qwen3_moe_30b_a3b", {}, set()),
    ("deepseek_v2_236b", {}, set()),
    ("rwkv6_7b", {}, {"HLO-DN1"}),
    ("zamba2_1p2b", {}, {"HLO-DN1"}),
    ("llama1_7b", dict(kv_layout="paged", page_size=8, kv_dtype="int8"),
     set()),
    ("llama1_7b", dict(chunked_prefill=8, controller=True), set()),
], ids=["moe", "mla", "rwkv", "hybrid", "paged_int8", "chunked_controller"])
def test_gate_green_over_the_families(arch, kw, warn):
    """AP+OR plans (weight space) on every family the engine serves: the
    gate comes up clean and GA1 runs; rwkv's ``state``/token-shift rows
    and Mamba2's ``conv``/``ssm`` are returned as new tensors, so DN1
    warns there (recorded, not an error); the engine then serves."""
    cfg = dataclasses.replace(get_smoke_config(arch), vocab=128)
    model = api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    model, _ = quantize_model_params(model, cfg, {}, _WEIGHT_SPACE)
    kw = dict(kw)
    if kw.pop("controller", False):
        kw.update(controller=T.AdmissionController(T.SLOConfig(
            ttft_p99_ms=100.0)), cost_model=T.StepCostModel())
    eng = T.ServingEngine(model, cfg, n_slots=2, max_len=32, device="cpu",
                          verify_contracts=True, **kw)
    rep = eng.contract_report
    assert rep.clean, rep.render()
    assert {"HLO-GA1", "HLO-HT1", "HLO-DN1", "TRC-CC1",
            "TRC-SG1"} <= set(rep.rules_run)
    assert ("HLO-DT1" in rep.rules_run) == (kw.get("kv_dtype") == "int8")
    assert {f.rule_id for f in rep.findings} - {"HLO-CP1"} == warn
    moved = [f for f in rep.findings if f.rule_id == "HLO-DN1"]
    if moved:
        assert {m.split(".")[-1] for m in moved[0].details["moved"]} <= {
            "state", "prev_tm", "prev_cm", "conv", "ssm"}
    toks, _ = _serve(eng)
    assert all(len(t) == 6 for t in toks)


def test_check_cli_on_the_cpu(capsys):
    rc = check_cli.main(["--config", "dense", "--ast",
                         str(REPO / "src" / "repro_torch"), "--device",
                         "cpu", "--json", "-"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "contract report [config:dense]: CLEAN" in out
    doc = json.loads(out[out.index('{\n  "clean"'):])
    assert doc["clean"] and len(doc["reports"]) == 2


def test_launcher_and_replay_cli_verify_contracts(capsys):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import replay as replay_cli
    launch_serve.main(["--arch", "llama1_7b", "--smoke", "--bits", "2.2",
                       "--requests", "2", "--slots", "2", "--max-new", "3",
                       "--max-len", "32", "--verify-contracts",
                       "--device", "cpu"])
    assert "[serve] contracts: 6 rules clean (1 warning(s))" in (
        capsys.readouterr().out)
    assert replay_cli.main(["--smoke", "--verify-contracts", "--steps",
                            "8", "--device", "cpu"]) == 0
