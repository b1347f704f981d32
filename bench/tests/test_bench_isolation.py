"""What the benchmark loads: no module whose top-level name, compared
whole, is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX package;
``repro_torch`` only begins with that name), and a reference that loads
nothing of the port."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path[0:0] = [{str(ROOT)!r}, "
         f"{str(ROOT / 'src')!r}]\n{code}\nimport json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_port_load_no_jax_package():
    mods = _loaded("from bench import harness, program, serve_loop, "
                   "devtrace, reference\n"
                   "import repro_torch.serve.engine\n"
                   "for n in ('queue_wait_ms', 'k1_roofline', "
                   "'moe_dequant_share', 'mfu.serve'):\n"
                   "    harness.metric_module(n)")
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_port():
    mods = _loaded("from bench import reference")
    assert not mods & {"repro_torch", "repro", "jax"}


def test_forbidden_modules_compare_whole_names(monkeypatch):
    from bench import harness
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    found = harness.forbidden_modules()
    assert "repro_torch" not in found and "repro_torch_lookalike" not in found
