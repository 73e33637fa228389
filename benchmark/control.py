"""The control of a cell's comparison: the plain reference put in the
program's place at a narrower precision, compared as a run compares the
program. It has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--sat 127]

The program computes gapless scores and Smith-Waterman in integers: int8
scores, an int16 profile plus bias, int32 H capped at 32767 (int16
range). The control narrows both DPs to int8 lanes: D, H and E saturate
at 127. For each seed: the cell's DB and as many jobs as a run of the
cell completes (the workload file's "control_jobs"), the run's sample of
them, and the numbers the run compares, each beside the cell's limit. It
runs on the device the reference runs on in a run (cuda; --device cpu for
the tests) and never runs the program.
"""

import argparse
import json
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control(workload, seed, sat=127, device="cuda", overrides=None,
            n_jobs=None):
    """{number: (control's reading, limit)} of one seed."""
    import numpy as np
    from benchmark import run as harness
    from benchmark.entries import common
    from benchmark.reference import gapless
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    run = harness.Run(bench, workload, seed, 0, 0, device, overrides)
    with tempfile.TemporaryDirectory(prefix="bench_control_") as td:
        run.workdir = pathlib.Path(td)
        common.targets(run)
        run.tcodes = common.tcodes(run.tdb)
        n = n_jobs or run.wl["control_jobs"]
        for j in range(n):
            run.jobs[j] = run.entry.make_job(run, j)
        run.gdb = gapless.GaplessDB(run.tdb.codes.astype(np.int64),
                                    run.tdb.offsets, device)
        picks = run.entry.sample(run, list(range(n)))
        want = run.entry.expected(run, picks)
        got = run.entry.expected(run, picks, sat=sat)
        nums = run.entry.compare(run, picks, got, want)
    return {k: (v, run.wl["limits"][k]) for k, v in nums.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sat", type=int, default=127)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = control(args.workload, seed, args.sat, args.device)
        fails = any(v > lim for v, lim in nums.values())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "sat": args.sat, "control_fails": fails,
                          "seconds": time.perf_counter() - t0,
                          "numbers": {k: v for k, (v, _) in nums.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
