"""One run of one cell: find the cell's files by name, serve its traffic
through the port, take its metrics, judge the served tokens against the
reference and print the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its
configuration is the file that ``configs`` names for it, its traffic mix
``bench/traffic/<traffic>.json``, each per-layer metric
``bench/metrics/<name>.py`` (a module with ``read(rec)``, and optionally
``SCOPES``, the profiler scopes it reads, and ``probe()``, a context
manager held over the traced window).  Adding a cell, a mix or a metric
adds files and entries; nothing here names one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from . import seeds, stats
from . import traffic as traffic_lib

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict                  # the configuration file
    traffic: dict                 # the traffic file
    end_to_end: List[dict]        # the manifest's entries this cell reports
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    wl = {w["name"]: w for w in manifest["workloads"]}
    if name not in wl:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = wl[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic"
                      / f"{w['traffic']}.json").read_text())
    return Cell(name, int(w["chips"]), config, mix,
                [m for m in manifest["end_to_end"] if _reports(m, name)],
                [m for m in manifest["per_layer"] if _reports(m, name)])


def metric_module(name: str, metrics_dir: Path = BENCH / "metrics"):
    path = metrics_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Record:
    """What a per-layer reader reads."""
    model: dict
    run: Any                      # serve_loop.Run
    trace: Any                    # devtrace.Summary
    probes: Dict[str, Any]


# ------------------------------------------------------------ end to end

def end_to_end(run, setup_s: float) -> Dict[str, float]:
    """The end-to-end metrics from the run's raw samples (``ttft_p95_ms``
    only where requests were sent in the window)."""
    lo, hi = run.window_open, run.window_close
    reqs = list(run.requests.values())
    out_tokens = sum(1 for r in reqs for t in r.times if lo < t <= hi)
    drained = max(s.t1 for s in run.steps)
    ttft = [((r.times[0] if r.times else drained) - r.submit_t) * 1e3
            for r in reqs if r.in_window]
    gaps = [(b - a) * 1e3 for r in reqs
            for a, b in zip(r.times, r.times[1:]) if lo < b <= hi]
    out = {"out_tok_s": out_tokens / run.window_s, "setup_s": setup_s}
    if ttft:
        out["ttft_p95_ms"] = stats.percentile(ttft, 95)
    if gaps:
        out["tpot_p95_ms"] = stats.percentile(gaps, 95)
    return out


def attempted_failed(run):
    win = [r for r in run.requests.values() if r.in_window]
    bad = [r for r in win if not r.times
           or r.state in ("failed", "truncated", "abandoned")]
    return len(win), len(bad)


# ---------------------------------------------------------- correctness

def served_by_close(run) -> Dict[int, List[int]]:
    """Each request's tokens emitted by the window's close."""
    return {uid: r.tokens[:sum(1 for t in r.times if t <= run.window_close)]
            for uid, r in run.requests.items()}


def finished_by_close(run) -> List[int]:
    return sorted(uid for uid, r in run.requests.items()
                  if r.state == "finished" and r.times
                  and r.times[-1] <= run.window_close)


def judge(cell: Cell, seed: int, run, device, control: bool = False):
    """(reference.Judged, error or None) of the served tokens."""
    from . import reference as ref
    m, rule = cell.config["model"], cell.config["correct"]
    served = served_by_close(run)
    done = finished_by_close(run)
    if not done:
        return ref.Judged(), "no request finished in the window"
    if m["family"] == "moe":
        # every step from the first admissions to the last that ended in
        # the window
        last = max(i for i, s in enumerate(run.steps) if s.in_window)
        steps = [{"admit": s.admit, "decode": s.emitted > 0}
                 for s in run.steps[run.first_step:last + 1]]
        try:
            return ref.replay(m, seed, steps,
                              {u: r.prompt for u, r in run.requests.items()},
                              served, done, run.n_slots,
                              cell.traffic["max_len"], device,
                              control), None
        except ref.ReplayMismatch as e:
            return ref.Judged(), str(e)
    rng = np.random.default_rng(seeds.sub_seed(seed, "sample"))
    longest = max(done, key=lambda u: (len(served[u]),
                                       len(run.requests[u].prompt)))
    rest = [u for u in done if u != longest]
    k = min(len(rest), int(rule["sample_requests"]) - 1)
    pick = [longest] + sorted(rng.choice(rest, k, replace=False).tolist()
                              if k else [])
    seqs = [(run.requests[u].prompt, served[u]) for u in pick]
    return ref.judge_sequences(m, seed, seqs, device, control), None


def checks(cell: Cell, judged, error) -> Dict[str, dict]:
    """The numbers compared, each with its limit: the mean logit gap (at
    most its limit) and the tokens judged (at least)."""
    rule = cell.config["correct"]
    out = {"mean_logit_gap": {"value": judged.stat("mean"),
                              "limit": rule["max_mean_logit_gap"]},
           "judged_tokens": {"value": judged.tokens,
                             "limit": rule["min_judged_tokens"]}}
    if error:
        out["schedule"] = {"value": error, "limit": "replayable"}
    return out


def is_correct(ch: Dict[str, dict]) -> bool:
    gap, judged = ch["mean_logit_gap"], ch["judged_tokens"]
    return ("schedule" not in ch and gap["value"] <= gap["limit"]
            and judged["value"] >= judged["limit"])


# ------------------------------------------------------------------ run

def log(t_start: float, msg: str) -> None:
    """A progress line on standard error, seconds since the run began."""
    print(f"[{time.perf_counter() - t_start:8.2f} s] {msg}", file=sys.stderr,
          flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def serve(cell: Cell, seed: int, seconds: float, trace: bool, device,
          t_start: float, sync=None):
    """Set up, serve the window, read the metrics; returns (run, setup_s,
    memory peak, trace summary or None, per-layer values)."""
    import torch
    from . import program
    from . import devtrace as trace_lib
    from .serve_loop import Loop
    m = cell.config["model"]
    cfg = program.port_config(m)
    mix = traffic_lib.generate(cell.traffic, seed, m["vocab"])
    log(t_start, "torch and the port imported")
    model = program.build_model(m, seed, device)
    if sync:
        sync()
    log(t_start, "weights built")
    eng = program.engine(model, cfg, mix, device)
    del model
    log(t_start, "engine ready (plans prepared)")
    loop = Loop(eng, mix)
    loop.warm_up()
    log(t_start, "warm-up request served")
    loop.first_admissions()
    if sync:
        sync()
    setup_s = time.perf_counter() - t_start
    log(t_start, f"first admissions done; window opens "
        f"({len(loop.steps)} steps so far)")
    mods = {p["name"]: metric_module(p["name"]) for p in cell.per_layer} \
        if trace else {}
    probes = {n: mod.probe() for n, mod in mods.items()
              if hasattr(mod, "probe")}
    prof = trace_lib.profiler() if trace else None
    run = loop.window(seconds, _entered([prof, *probes.values()])
                      if trace else None)
    log(t_start, f"window closed after {run.window_s:.2f} s, "
        f"{len(run.window_steps())} steps"
        + (f" ({len(run.host_steps())} before the profiler)" if trace
           else "") + "; drained")
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_available() and str(device).startswith("cuda")
            else 0)
    summary, layer = None, {}
    if trace:
        scopes = sorted({s for mod in mods.values()
                         for s in getattr(mod, "SCOPES", ())})
        summary = trace_lib.summarize(trace_lib.raw_events(prof), scopes)
        log(t_start, f"trace read: {summary.n_events} events")
        rec = Record(m, run, summary, probes)
        for name, mod in mods.items():
            v = mod.read(rec)
            if v is not None:
                layer[name] = float(v)
    loop.eng = None
    del eng, loop
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return run, setup_s, peak, summary, layer


@contextlib.contextmanager
def _entered(parts):
    """Every context manager of ``parts``, entered in order."""
    with contextlib.ExitStack() as stack:
        for p in parts:
            stack.enter_context(p)
        yield


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, sync=None) -> dict:
    """One run: the result line's object (``checks`` last)."""
    run, setup_s, peak, summary, layer = serve(cell, seed, seconds, trace,
                                               device, t_start, sync)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = {n: v for n, v in layer.items()}
    else:
        e2e = end_to_end(run, setup_s)
        values = {m["name"]: e2e[m["name"]] for m in cell.end_to_end
                  if m["name"] in e2e}
    judged, error = judge(cell, seed, run, device)
    log(t_start, f"reference done: {judged.tokens} tokens judged, widest "
        f"gap {judged.stat('widest')}, mean {judged.stat('mean')}")
    ch = checks(cell, judged, error)
    attempted, failed = attempted_failed(run)
    dev = {"platform": "gpu", "kind": _device_name(device), "count": 1,
           "memory_peak_bytes": int(peak)}
    out = {"correct": is_correct(ch), "attempted": attempted,
           "failed": failed,
           "metrics": {n: {"value": v, "unit": units[n]}
                       for n, v in values.items()},
           "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in
                                           summary.device_ops],
                            "idle_gaps": [list(x) for x in
                                          summary.idle_gaps]}
    out["checks"] = ch
    return out


def _device_name(device) -> str:
    import torch
    if str(device).startswith("cuda"):
        return torch.cuda.get_device_name(0)
    return "cpu"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float, root: Path) -> int:
    args = parse(argv)
    cell = find_cell(args.workload, root)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(1)        # the host's work is one Python thread
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start, torch.cuda.synchronize)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0
