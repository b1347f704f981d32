"""Readings that set a cell's limit on the logit gap: for each seed, one
run of the cell (set-up, a window of ``--seconds``, the reference), the
program's numbers and the control's, each put through the benchmark's own
comparison (``harness.checks`` / ``is_correct``).  The control is the
reference computed in float8 e4m3 put in the program's place: the gaps of
the tokens it puts first, at the same positions.  With ``--fault`` the
timed path runs with that fault planted (``bench/faults.py``) and is
judged as a benchmark run is.  All seeds in one process.

    python bench/limits.py --workload <name> --seeds 1,2,3 --seconds 10
    python bench/limits.py --workload <name> --seeds 4 --seconds 10 \\
        --fault half_batch

Prints one JSON line a seed.  The benchmark's own runs never run the
control or a fault.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from bench import faults, harness  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = harness.find_cell(args.workload, ROOT)
    t_start = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        planted = (faults.FAULTS[args.fault]() if args.fault
                   else contextlib.nullcontext())
        with planted:
            run, setup_s, peak, _, _ = harness.serve(
                cell, seed, args.seconds, False, "cuda", t_start,
                torch.cuda.synchronize)
        t0 = time.perf_counter()
        control = args.fault is None
        judged, error = harness.judge(cell, seed, run, "cuda",
                                      control=control)
        torch.cuda.synchronize()
        program = harness.checks(cell, judged, error)
        out = {"seed": seed, "fault": args.fault, "tokens": judged.tokens,
               "error": error, "widest": judged.stat("widest"),
               "mean": judged.stat("mean"),
               "correct": harness.is_correct(program)}
        if control:
            ctrl = harness.checks(cell, judged.as_control(), error)
            out.update(widest_control=judged.stat("widest", True),
                       mean_control=judged.stat("mean", True),
                       control_correct=harness.is_correct(ctrl),
                       control_checks=ctrl)
        out.update(checks=program, setup_s=setup_s, window_s=run.window_s,
                   reference_s=time.perf_counter() - t0,
                   memory_peak_bytes=peak,
                   e2e=harness.end_to_end(run, setup_s))
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
