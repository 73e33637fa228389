"""The benchmark of metaeuk_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A cell of BENCHMARK.json names a
configuration (benchmark/configs/<config>.json: the entry, its flags, the
target DB) and its traffic (benchmark/workloads/<cell>.json); each metric
is read by benchmark/metrics/<metric>.py. A run:

1. set-up: the target DB from the seed and createdb, a pool of jobs'
   inputs, one small warm job through the same entry (modules, kernels
   and libraries loaded, the target-side caches the program keeps);
2. the window: whole jobs back to back, one at a time, until --seconds
   have passed; the job running then finishes and counts;
3. the metrics: the cell's end-to-end metrics (--trace 0) or, under
   torch.profiler, its per-layer metrics (--trace 1);
4. the comparison with the plain reference (benchmark/reference/) on a
   sample drawn from the seed, once the program's state is freed.

The last line of standard output is the result; the numbers compared, each
beside its limit, are the last lines of standard error.
"""

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
FORBIDDEN = ("jax", "jaxlib", "flax", "metaeuk_tpu")


def process_age():
    """Seconds since this process started (its start time in /proc)."""
    try:
        ticks = int(open("/proc/self/stat").read().rsplit(")", 1)[1]
                    .split()[19])
        btime = next(int(ln.split()[1]) for ln in open("/proc/stat")
                     if ln.startswith("btime"))
        return time.time() - (btime + ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, StopIteration):
        return time.perf_counter() - T_IMPORT


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def load_metric(name):
    """The reader module of metric `name` (metrics/<name>.py)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Run:
    """Everything a run knows: the cell's files, the jobs, the spans, the
    profile; what the metric readers and the entry read."""

    def __init__(self, bench, cell, seed, seconds, trace, device,
                 overrides=None):
        self.bench = bench
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        wl_entry = next(w for w in bench["workloads"] if w["name"] == cell)
        self.chips = wl_entry["chips"]
        self.cfg = json.loads(
            (HERE / "configs" / f"{wl_entry['config']}.json").read_text())
        self.wl = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
        for key, upd in (overrides or {}).items():
            getattr(self, key).update(upd)
        self.entry = importlib.import_module(
            f"benchmark.entries.{self.cfg['entry']}")
        from benchmark.spans import Recorder
        self.rec = Recorder()
        self.jobs = {}
        self.done = []
        self.failed = 0
        self.cache = {}
        self.prof = None
        self.peak = None

    # ---- what the readers use ----
    def window(self):
        t0 = min(self.jobs[j]["t0"] for j in self.done)
        t1 = max(self.jobs[j]["t1"] for j in self.done)
        return t0, t1

    def rate(self):
        """Work units of every completed job over the window."""
        t0, t1 = self.window()
        return sum(self.jobs[j]["work"] for j in self.done) / (t1 - t0)

    def per_job(self, fn):
        return sum(fn(j) for j in self.done) / len(self.done)

    def metrics_of(self, kind):
        """The metrics of BENCHMARK.json's list `kind` that this cell
        reports."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.cell in m["workloads"]]


def make_jobs(run, n):
    for j in range(len(run.jobs), len(run.jobs) + n):
        run.jobs[j] = run.entry.make_job(run, j)


def counts():
    from metaeuk_tpu_torch.ops import sw_cuda, ungapped_cuda
    return ({**sw_cuda.LAUNCHES, **ungapped_cuda.LAUNCHES},
            {**sw_cuda.PLAIN_CALLS, **ungapped_cuda.PLAIN_CALLS})


def phase_seconds():
    from metaeuk_tpu_torch.search import driver
    return sum(driver.PHASE_SECONDS.values())


def setup(run):
    import torch
    from benchmark.entries import common
    run.workdir = pathlib.Path(tempfile.mkdtemp(prefix="bench_"))
    run.entry.setup(run)
    if run.device != "cpu":
        # the kernel libraries the cell's traffic can launch, built (once
        # in a checkout, under metaeuk_tpu_torch/build/) and loaded before
        # the window
        from metaeuk_tpu_torch.ops import _build
        for name in run.wl["libraries"]:
            _build.load(name)
    make_jobs(run, run.wl["pool"])
    warm = run.entry.make_job(run, 1 << 20, cut=run.wl["warm"])
    run.rec.begin_job("warm")
    t0 = time.perf_counter()
    run.entry.run_job(run, warm)
    if run.device != "cpu":
        torch.cuda.synchronize()
    print(f"set-up: warm job {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
    run.tcodes = common.tcodes(run.tdb)


def window(run):
    import torch
    if run.device != "cpu":
        torch.cuda.synchronize()
    launches0, plain0 = counts()
    t_start = time.perf_counter()
    j = 0
    while time.perf_counter() - t_start < run.seconds:
        if j not in run.jobs:
            make_jobs(run, 1)
        job = run.jobs[j]
        run.rec.begin_job(j)
        ph0 = phase_seconds()
        job["t0"] = time.perf_counter()
        try:
            with run.rec.span("job"):
                run.entry.run_job(run, job)
                if run.device != "cpu":
                    torch.cuda.synchronize()
        except Exception as exc:  # a failed job counts, and fails the run
            traceback.print_exc()
            print(f"job {j} failed: {exc!r}", file=sys.stderr)
            run.failed += 1
        else:
            run.done.append(j)
        job["t1"] = time.perf_counter()
        job["phase_s"] = phase_seconds() - ph0
        j += 1
    launches1, plain1 = counts()
    run.launches = {k: launches1[k] - launches0[k] for k in launches1
                    if launches1[k] - launches0[k]}
    run.plain = {k: plain1[k] - plain0[k] for k in plain1
                 if plain1[k] - plain0[k]}
    run.attempted = j


def read_metrics(run, kind):
    out = {}
    for m in run.metrics_of(kind):
        v = load_metric(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def check(run):
    """The numbers compared, each (value, limit)."""
    import torch
    from benchmark.reference import gapless
    checks = {}
    if run.device != "cpu":
        checks["plain_calls"] = (sum(run.plain.values()), 0)
        missing = [k for k in run.wl["kernels"] if not run.launches.get(k)]
        checks["kernels_not_launched"] = (len(missing), 0)
    checks["failed_jobs"] = (run.failed, 0)
    if run.done:
        run.gdb = gapless.GaplessDB(run.tdb.codes.astype(np.int64),
                                    run.tdb.offsets, run.device)
        picks = run.entry.sample(run, run.done)
        got = run.entry.program(run, picks)
        want = run.entry.expected(run, picks)
        for k, v in run.entry.compare(run, picks, got, want).items():
            checks[k] = (v, run.wl["limits"][k])
        print(f"compared: {len(picks)} sampled items of {len(run.done)} "
              "jobs", file=sys.stderr)
        del run.gdb
        if run.device != "cpu":
            torch.cuda.empty_cache()
    return checks


def run_cell(workload, seed, seconds, trace, device="cuda", overrides=None,
             faults=()):
    """One run; returns the result dict (its "checks" last). overrides
    ({"cfg": {...}, "wl": {...}}) and faults (callables given the run after
    set-up) are for the CPU tests."""
    import torch
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    run = Run(bench, workload, seed, seconds, trace, device, overrides)
    try:
        setup(run)
        run.setup_s = process_age()
        for fault in faults:
            fault(run)
        if trace:
            from benchmark.yardstick import Trace, peak_ops_per_s
            run.peak = peak_ops_per_s()
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                window(run)
            run.prof = Trace(prof)
        else:
            window(run)
        if device != "cpu":
            mem = torch.cuda.max_memory_allocated()
            dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": run.chips, "memory_peak_bytes": int(mem)}
        else:
            dev = {"platform": "cpu", "kind": "cpu", "count": 1,
                   "memory_peak_bytes": 0}
        metrics = read_metrics(run, "per_layer" if trace else "end_to_end") \
            if run.done else {}
        result = {"correct": False, "attempted": run.attempted,
                  "failed": run.failed, "metrics": metrics, "device": dev}
        if trace and run.done:
            t0, t1 = run.window()
            busy, _ = run.prof.busy()
            dev["busy_s"] = busy
            dev["window_s"] = t1 - t0
            result["breakdown"] = run.prof.breakdown()
        result["launches"] = run.launches
        result["plain_calls"] = run.plain
        result["job_s"] = [run.jobs[j]["t1"] - run.jobs[j]["t0"]
                           for j in range(run.attempted)]
        # the program's state freed before the reference runs: its
        # target-side cache, and what the spans kept but the outputs
        from metaeuk_tpu_torch.utils import session
        run.rec.unwrap()
        session.clear()
        for j in run.done:
            run.rec.captured[j].pop("run", None)
        run.prof = None
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = check(run)
        result["check_s"] = time.perf_counter() - t_check
        result["correct"] = bool(run.done) and all(
            v <= lim for v, lim in checks.values())
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, (v, lim) in checks.items()}
        return result
    finally:
        if getattr(run, "workdir", None):
            shutil.rmtree(run.workdir, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    import torch
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace)
    bad = forbidden_modules()
    if bad:
        print("loaded in the run's process: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
