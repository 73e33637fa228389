#!/usr/bin/env python3
"""T2 (kb_shift) and T3 (kb_scan) of metaeuk_tpu_torch/csrc/kbench.cu on one
CUDA device, beside their floors, for one or more checkouts of the
repository.

    python3 tools/torch_kbench_floors.py [CHECKOUT ...]

Each CHECKOUT (default: this one) runs in a process of its own, in the order
given (name a parent and a change as parent, change, change, parent; a
parent unpacked by `git archive` into the gitignored smoke_checkout/), with
its own package: its csrc/kbench.cu is built at first use. For each case of
tools/kbench.py's T2 and T3 (CASES) it times, by the tool's own time_ms
(10 calls queued back to back behind a spin):

  - the TPU tool's shape at REPS and at 2 * REPS (the second about twice
    the first, less the fixed cost, where the loop is not folded);
  - the same launch at reps 0 (load and store: the fixed cost);
  - WIDE_COLS columns at REPS (about 31 warps an SM, latency hidden: the
    max pipe's or the shuffle unit's rate);

and, queued for about a second while nvidia-smi reads the SM clock, one
column alone (one warp: its dependent chain) at LAT_REPS reps, roll by 8
on one column (a shuffle and a max a rep: the shuffle's latency) and T1's
int32 chain on one warp (a DPX add-max a step: the max's latency); and the
fixed cost of the same bytes read and written coalesced (kb_alu at reps 0
and torch's clone on the (256, 512) int32 shape). Every
output is checked equal to the plain version's. Prints the card's name and
power limit, one JSON line per checkout, then a line per case and checkout
with the bounds derive() computes from this checkout's kbench_cuda and
chip_smoke.py: the operations (chip_smoke.kbench_bound), the shuffles over
chip_smoke.SHFL_PER_S, and the latency floor (the chain of
kbench_cuda.shift_chain / SCAN_CHAIN at the measured latencies and clock).
"""

import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CASES = ("shift_i32", "shift_i16", "roll_i32", "shift3", "shift8",
         "shift64", "scan256")
WIDE_COLS = 4096
LAT_REPS = {"shift": 8192, "scan": 65536}
ALU_REPS = 16384      # chip_smoke.one_warp_latency's
QUEUE_MS = 1000       # a latency run's queued calls, about


def sm_clock_mhz():
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def queued(torch, kb, fn):
    """(ms per call, SM MHz): calls queued for about QUEUE_MS, the clock
    read by nvidia-smi while they run."""
    per_call = kb.time_ms(fn)
    n = max(20, int(QUEUE_MS / per_call))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    mhz = sm_clock_mhz()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n, mhz


def measure(torch, kbench_cuda, kbench_torch, kb):
    """The raw times of one checkout: {case: {...}, "roll8 one column":
    ..., "alu_i32 one warp": ...}; raises if an output differs from the
    plain version's."""
    def checked(fn, plain, x, reps, kw):
        got = fn(x, reps, **kw)
        if not torch.equal(got, plain(x, reps, **kw)):
            raise AssertionError(f"{fn.__name__} {kw} at reps {reps} "
                                 "differs from the plain version")

    res = {}
    for name in CASES:
        kind, _, kw = kb.CASES[name]
        fn, plain = getattr(kbench_cuda, kind), getattr(kbench_torch, kind)
        x = kb.case_input(name, "cuda", seed=7)
        one = x[:, :1].contiguous()
        wide = kb.case_input(name, "cuda", seed=8,
                             shape=(x.shape[0], WIDE_COLS))
        lat = LAT_REPS[kind]
        for t, reps in ((x, kb.REPS), (x, 2 * kb.REPS), (x, 0),
                        (wide, kb.REPS), (one, lat)):
            checked(fn, plain, t, reps, kw)
        one_ms, mhz = queued(torch, kb, lambda: fn(one, lat, **kw))
        res[name] = {
            "ms": kb.time_ms(lambda: fn(x, kb.REPS, **kw)),
            "ms_2reps": kb.time_ms(lambda: fn(x, 2 * kb.REPS, **kw)),
            "ms_reps0": kb.time_ms(lambda: fn(x, 0, **kw)),
            "wide_ms": kb.time_ms(lambda: fn(wide, kb.REPS, **kw)),
            "one_column_ms": one_ms, "one_column_reps": lat,
            "mhz": mhz}
    one = kb.case_input("shift_i32", "cuda", seed=9)[:, :1].contiguous()
    lat = LAT_REPS["shift"]
    checked(kbench_cuda.shift, kbench_torch.shift, one, lat,
            {"amount": 8, "roll": True})
    ms, mhz = queued(torch, kb, lambda: kbench_cuda.shift(
        one, lat, amount=8, roll=True))
    res["roll8 one column"] = {"ms": ms, "reps": lat, "mhz": mhz}
    x = kb.case_input("alu_i32", "cuda", seed=3, shape=(1, 32))
    ms, mhz = queued(torch, kb, lambda: kbench_cuda.alu(x, ALU_REPS))
    res["alu_i32 one warp"] = {"ms": ms, "steps": ALU_REPS * 4, "mhz": mhz}
    x = kb.case_input("alu_i32", "cuda", seed=4)
    res["launch"] = {"alu_reps0_ms": kb.time_ms(lambda: kbench_cuda.alu(x, 0)),
                     "clone_ms": kb.time_ms(x.clone)}
    return res


def cycles(ms, mhz, n):
    return ms * 1e-3 * mhz * 1e6 / n


def derive(raw, smoke, kbench_cuda, kb):
    """{case: {...}} beside raw's times: the fixed cost, the growth from
    REPS to 2 * REPS less it (and that of the reps or scan steps: the
    scan's ramp does not grow), the operations bound, the shuffle bound,
    the latency floor at the measured latencies, the one column's cycles a
    rep (a scan step) and the wide launch's ms a column."""
    alu = raw["alu_i32 one warp"]
    l_op = cycles(alu["ms"], alu["mhz"], alu["steps"])
    r8 = raw["roll8 one column"]
    l_shfl = cycles(r8["ms"], r8["mhz"], r8["reps"]) - l_op
    out = {"latency": {"op_cycles": l_op, "shuffle_cycles": l_shfl}}
    cols = kb.SHAPE[1]
    for name in CASES:
        r = raw[name]
        kind, _, kw = kb.CASES[name]
        x = kb.case_input(name, "cpu")
        ops_ms, _, _ = smoke.kbench_bound(kb, name, x)
        if kind == "scan":
            n = kbench_cuda.scan_steps(kb.REPS // 8)
            grow = kbench_cuda.scan_steps(kb.REPS // 4) / n
            shfl, ops = kbench_cuda.SCAN_CHAIN
            sent = 1
            one_n = kbench_cuda.scan_steps(r["one_column_reps"] // 8)
        else:
            n, grow = kb.REPS, 2
            shfl, ops = kbench_cuda.shift_chain(kw.get("amount", 1),
                                                kw.get("roll", False))
            sent = kbench_cuda.shuffles_per_rep(kw.get("amount", 1))
            one_n = r["one_column_reps"]
        out[name] = {
            "fixed_ms": r["ms_reps0"],
            "growth": (r["ms_2reps"] - r["ms_reps0"])
            / (r["ms"] - r["ms_reps0"]),
            "growth_of_steps": grow,
            "ops_bound_ms": ops_ms,
            "shuffle_bound_ms": n * sent * cols / smoke.SHFL_PER_S * 32e3,
            "latency_floor_ms": n * (shfl * l_shfl + ops * l_op)
            / (r["mhz"] * 1e3),
            "one_column_cycles": cycles(r["one_column_ms"], r["mhz"], one_n),
            "wide_ms_a_column": r["wide_ms"] / WIDE_COLS}
    return out


def _load_smoke():
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def one(checkout):
    """The raw times of one checkout, in this process."""
    sys.path.insert(0, str(pathlib.Path(checkout).resolve()))
    import torch
    from metaeuk_tpu_torch.ops import kbench_cuda, kbench_torch
    from metaeuk_tpu_torch.tools import kbench as kb
    return measure(torch, kbench_cuda, kbench_torch, kb)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the run needs one GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT))
    from metaeuk_tpu_torch.ops import kbench_cuda
    from metaeuk_tpu_torch.tools import kbench as kb
    smoke = _load_smoke()
    for i, checkout in enumerate(argv or [str(ROOT)]):
        res = subprocess.run([sys.executable, __file__, "--one", checkout],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        raw = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "checkout": checkout, "raw": raw}),
              flush=True)
        report(raw, derive(raw, smoke, kbench_cuda, kb), f"run {i}")
    return 0


def report(raw, der, tag):
    lat = der["latency"]
    print(f"{tag}: latency {lat['shuffle_cycles']:.2f} cycles a shuffle "
          f"(roll8 on one column less a max), {lat['op_cycles']:.2f} a max "
          f"(T1 int32 on one warp); the same bytes' fixed cost coalesced: "
          f"kb_alu at reps 0 {raw['launch']['alu_reps0_ms']:.4f} ms, "
          f"torch clone {raw['launch']['clone_ms']:.4f} ms", flush=True)
    for name in CASES:
        r, d = raw[name], der[name]
        print(f"{tag}: {name}: {r['ms']:.4f} ms at REPS, {r['ms_2reps']:.4f}"
              f" at 2 REPS, {d['fixed_ms']:.4f} at reps 0 (growth "
              f"{d['growth']:.3f}, steps {d['growth_of_steps']:.3f}); bounds: "
              f"operations "
              f"{d['ops_bound_ms']:.5f}, shuffles {d['shuffle_bound_ms']:.5f}"
              f", latency floor {d['latency_floor_ms']:.5f} ms at "
              f"{r['mhz']:.0f} MHz; one column {d['one_column_cycles']:.2f} "
              f"cycles a {'step' if name == 'scan256' else 'rep'}; "
              f"{WIDE_COLS} columns {r['wide_ms']:.4f} ms "
              f"({d['wide_ms_a_column'] * 1e3:.5f} us a column)", flush=True)


if __name__ == "__main__":
    sys.exit(main())
