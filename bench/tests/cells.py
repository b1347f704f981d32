"""Cells at a size the CPU runs in seconds, written as files into a
temporary checkout (``BENCHMARK.json``, a configuration, a traffic mix),
so the harness finds them by name as it finds the real ones."""
import contextlib
import json
import time
from pathlib import Path
from unittest import mock

from bench import harness, serve_loop

BENCH = Path(__file__).resolve().parents[1]

SMALL = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
             d_ff=256, vocab=512)
SMALL_MOE = dict(SMALL, n_experts=8, top_k=2, d_ff_expert=64)
MIX = {"source": "CPU test", "clients": 6, "slots": 4, "max_len": 128,
       "prompt_tokens": {"median": 16, "sigma": 0.6, "min": 4, "max": 40},
       "output_tokens": {"median": 5, "sigma": 0.5, "min": 3, "max": 12},
       "requests_per_client": 64, "shape_seed": 3,
       "warmup": {"prompt_tokens": 8, "output_tokens": 3}}
# the CPU stands-ins of the two real cells: their configurations at small
# widths; the MoE in f32, whose bf16 routing flips at this width (one
# assignment an expert in a 4-row decode step) would hide a fault
# the limit of the small cells, set as the real cells' limits are: sound
# runs' mean logit gap on seeds 1-6 read dense 0-0.00017, MoE (f32) 0; the
# control's 0.0049-0.0126 and 0.160-0.254
SMALL_CORRECT = {"max_mean_logit_gap": 0.002, "min_judged_tokens": 20,
                 "sample_requests": 8}
CELLS = {"granite8b.small": ("granite_8b", SMALL),
         "qwen3moe.small": ("qwen3_moe_30b_a3b",
                            dict(SMALL_MOE, dtype="float32"))}


def write(root: Path, name: str) -> Path:
    """A checkout at ``root`` holding the one cell ``name``."""
    source, sizes = CELLS[name]
    conf = json.loads((BENCH / "configs" / f"{source}.json").read_text())
    conf["model"].update(sizes)
    conf["correct"] = SMALL_CORRECT
    (root / "bench" / "configs").mkdir(parents=True, exist_ok=True)
    (root / "bench" / "traffic").mkdir(parents=True, exist_ok=True)
    (root / "bench" / "configs" / f"{name}.json").write_text(json.dumps(conf))
    (root / "bench" / "traffic" / "small.json").write_text(json.dumps(MIX))
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    manifest["configs"] = [{"name": name, "source": conf["source"],
                            "file": f"bench/configs/{name}.json",
                            "reduced": [], "why": "CPU test"}]
    manifest["workloads"] = [{"name": name, "config": name,
                              "traffic": "small", "chips": 1,
                              "why": "CPU test"}]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


class _Ticks:
    """A clock that reads 10 ms later at every reading: the serving
    loop's window then holds the same steps on a loaded machine."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += 0.01
        return self.t


@contextlib.contextmanager
def virtual_clock():
    """The serving loop on ``_Ticks``, torch on one thread (test workers
    share the machine's cores)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with mock.patch.object(serve_loop, "time", _Ticks()):
            yield
    finally:
        torch.set_num_threads(threads)


def run(root: Path, name: str, seed: int = 5, seconds: float = 2.0,
        trace: bool = False) -> dict:
    cell = harness.find_cell(name, write(root, name))
    with virtual_clock():
        return harness.run_cell(cell, seed, seconds, trace, "cpu",
                                time.perf_counter())
