"""Benchmark: easy-predict end-to-end contigs/s on one NVIDIA GPU (the port
of the JAX package's root bench.py, which `metaeuk-tpu bench` runs).

    python -m metaeuk_tpu_torch bench [--selftest] [--no-ref]
        [--no-selftest] [--device cuda|cpu]

The primary metric is contigs/s for easy-predict on a mid-scale synthetic
metagenome, made at run time by tools/make_metagenome.py (its default
seed; METAEUK_BENCH_MBP, default 4, Mbp of contigs against
METAEUK_BENCH_TARGETS, default 8000, proteins; METAEUK_BENCH_RUNS, default
3, timed runs after one cold run, all in one process). `vs_baseline`
divides by the reference binary's contigs/s on the same inputs
(.refbuild/src/metaeuk); without the binary it is null, and so is
`parity_ok`.

Secondary numbers (same JSON line, under "extra"): stage seconds, aligned
cells, the wall times, the light selftest's verdict and the SW kernels'
device cells/s (CUDA events; null on the CPU, which has no device time).

`--selftest` runs the CUDA kernels K1-K6 (ops/sw_cuda.py) against the numpy
oracle (ops/sw.py) on randomized ragged batches spanning the driver's
bucket boundaries, and exits 1 on any mismatch. Unlike the JAX bench, a
kernel that fails to build or launch, or a mismatch in the light selftest
of the main run, ends the run with a non-zero exit: nothing falls back to
the plain versions. `--device cpu` runs those plain versions (ops/sw_torch.py)
in place of the kernels; `--device cuda` with no card raises.

Run from a checkout: the inputs come from tools/make_metagenome.py.
"""

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..cli import _device
from .dryrun import ROOT, write_slice

REF = ROOT / ".refbuild" / "src" / "metaeuk"

# selftest_qm's (Lq, Lt, tiles) and selftest's (Lq, Lt, pairs) upper bounds;
# (8192, 256) takes the long-query kernels K5/K6. The light sets are the
# main run's.
QM_CONFIGS = ((256, 256, 8), (1024, 512, 4), (512, 4096, 2), (8192, 256, 1))
QM_LIGHT = ((256, 256, 8), (1024, 512, 4))
PAIR_CONFIGS = ((256, 256, 64), (1024, 256, 24), (256, 1024, 24),
                (1024, 4096, 6))
PAIR_LIGHT = ((256, 256, 32), (256, 1024, 8))


def knobs():
    """(Mbp, targets, timed runs) from the JAX bench's environment knobs,
    read when the bench runs."""
    return (float(os.environ.get("METAEUK_BENCH_MBP", "4")),
            int(os.environ.get("METAEUK_BENCH_TARGETS", "8000")),
            int(os.environ.get("METAEUK_BENCH_RUNS", "3")))


def _put(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _device_ms(fn, reps=10):
    """Milliseconds a call of fn on the current CUDA stream: CUDA events
    around `reps` calls, after one call that loads the kernels."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_rate(device):
    """Pair-batched alignment (K1 + K2, sw_cuda.align_full) device cells/s
    at B=1024, 256x256 (the small-candidate-list path); None off the card."""
    from ..ops import sw_cuda
    if device.type != "cuda":
        return None
    B, Lq, Lt = 1024, 256, 256
    rng = np.random.default_rng(0)
    q_enc = _put(rng.integers(0, 20, (B, Lq)).astype(np.int32), device)
    q_bias = torch.zeros((B, Lq), dtype=torch.int32, device=device)
    q_len = torch.full((B,), Lq, dtype=torch.int32, device=device)
    t_enc = _put(rng.integers(0, 20, (B, Lt)).astype(np.int32), device)
    t_len = torch.full((B,), Lt, dtype=torch.int32, device=device)
    ms = _device_ms(lambda: sw_cuda.align_full(q_enc, q_bias, q_len, t_enc,
                                               t_len))
    return float(B) * Lq * Lt / (ms / 1e3)


def kernel_rate_qm(device):
    """Query-major kernel device cells/s at 8 tiles x 128 lanes, 256x256:
    forward ends (K3) and forward then reverse from the ends (K3 + K4), the
    pipeline's hot path (forward on every candidate pair, reverse only on
    E-value survivors); None off the card. The JAX bench feeds its kernels a
    random profile; the port's take sequences, so 8 queries of 256 and 1,024
    targets of 256 (a lane each) are drawn from the same generator: the
    same B * Lq * Lt cells."""
    from ..ops import sw_cuda, sw_torch
    if device.type != "cuda":
        return {"fwd": None, "full": None}
    Lq, Lt = 256, 256
    n_tiles = 8
    B = n_tiles * sw_torch.TB
    rng = np.random.default_rng(0)
    q_mat = _put(rng.integers(0, 20, (n_tiles, Lq)).astype(np.int32), device)
    qb_mat = torch.zeros_like(q_mat)
    q_lens = torch.full((n_tiles,), Lq, dtype=torch.int32, device=device)
    t_mat = _put(rng.integers(0, 20, (B, Lt)).astype(np.int32), device)
    t_lens = torch.full((B,), Lt, dtype=torch.int32, device=device)
    staged = (q_mat, qb_mat, q_lens, t_mat, t_lens,
              torch.arange(n_tiles, dtype=torch.int32, device=device),
              torch.arange(B, dtype=torch.int32, device=device))

    def full():
        _, qe, te = sw_cuda.qm_ends(*staged)
        return sw_cuda.qm_starts(*staged, qe.clamp_min(0), te.clamp_min(0))

    return {name: float(B) * Lq * Lt / (_device_ms(fn) / 1e3)
            for name, fn in (("fwd", lambda: sw_cuda.qm_ends(*staged)),
                             ("full", full))}


def make_inputs(tmp, mbp, n_targets):
    """make_metagenome(mbp, n_targets) as tmp/c.fna and tmp/p.faa, written
    by tools/make_metagenome.py in a process of its own; returns the two
    paths and the number of contigs."""
    cpath, ppath = write_slice(mbp, n_targets, pathlib.Path(tmp))
    with open(cpath, "rb") as f:
        n_contigs = sum(1 for line in f if line.startswith(b">"))
    return str(cpath), str(ppath), n_contigs


def run_ours(cpath, ppath, tmp, n_steady, device):
    """(walls, cold_wall, stage_seconds, cells): one cold easy-predict
    then n_steady timed runs, all in one process. The cold run carries the
    process's one-time costs (loading the kernels and the host library, and
    building them where no build is cached); long-lived deployments pay
    them once, so the steady median is the primary number and the cold
    wall is reported beside it. cells = the last steady run's {fwd, rev}
    aligned residue-cell counts (true lengths)."""
    from ..params import Params
    from ..pipeline.predict import EasyPredict
    from ..search import driver as drv

    t0 = time.perf_counter()
    EasyPredict(Params(), device=device).run(
        cpath, ppath, os.path.join(tmp, "ours_cold"))
    cold = time.perf_counter() - t0
    walls = []
    cells = None
    stages = {}
    for _ in range(n_steady):
        ep = EasyPredict(Params(), device=device)
        drv.CELLS["fwd"] = drv.CELLS["rev"] = 0
        t0 = time.perf_counter()
        ep.run(cpath, ppath, os.path.join(tmp, "ours"))
        walls.append(time.perf_counter() - t0)
        cells = dict(drv.CELLS)
        stages = dict(getattr(ep, "predict_stage_seconds", {}))
        stages.update(getattr(ep, "stage_seconds", {}))
    return walls, cold, {k: round(v, 3) for k, v in stages.items()}, cells


def run_reference(cpath, ppath, tmp, n_steady):
    """(walls, cold) of the reference binary: one cold run then n_steady
    timed runs (fresh tmp dirs each), symmetric with run_ours; (None, None)
    without the binary."""
    if not REF.exists():
        return None, None
    walls = []
    for i in range(n_steady + 1):
        t0 = time.perf_counter()
        r = subprocess.run(
            [str(REF), "easy-predict", cpath, ppath,
             os.path.join(tmp, f"ref{i}"),
             os.path.join(tmp, f"reftmp{i}"), "-v", "0"],
            capture_output=True)
        if r.returncode != 0:
            return None, None
        walls.append(time.perf_counter() - t0)
    return walls[1:], walls[0]


def run_parity(cpath, ppath, tmp):
    """Byte-compares the bench's own outputs with the reference binary's on
    the same inputs, with the goldens' deterministic methodology (createdb
    --shuffle 0, --threads 1). True/False, or None without the binary."""
    if not REF.exists():
        return None
    cdb = os.path.join(tmp, "parityContigsDB")
    tdb = os.path.join(tmp, "parityTargetsDB")
    for src, db in ((cpath, cdb), (ppath, tdb)):
        r = subprocess.run([str(REF), "createdb", src, db, "--shuffle", "0",
                            "-v", "0"], capture_output=True)
        if r.returncode != 0:
            return False
    refout = os.path.join(tmp, "parity_ref")
    r = subprocess.run(
        [str(REF), "easy-predict", cdb, tdb, refout,
         os.path.join(tmp, "parity_reftmp"), "-v", "0", "--threads", "1"],
        capture_output=True)
    if r.returncode != 0:
        return False
    ours = os.path.join(tmp, "ours")
    for suffix in ("fas", "codon.fas", "headersMap.tsv", "gff"):
        with open(f"{ours}.{suffix}", "rb") as a, \
                open(f"{refout}.{suffix}", "rb") as b:
            if a.read() != b.read():
                print(f"PARITY MISMATCH: {suffix}", file=sys.stderr)
                return False
    return True


def _same(ref, got):
    return (got["score"] == 0 if ref["score"] == 0
            else all(got[k] == ref[k] for k in ref))


def selftest_qm(device, light=False):
    """Query-major kernels (forward ends, then the reverse from the ends)
    against the numpy oracle on ragged candidate lists across tile
    boundaries: K3/K4, or K5/K6 where Lq > 2 * TQ_RT as the JAX package
    routes it. Returns (fails, checks)."""
    from ..data.submat import composition_bias_rounded
    from ..ops import sw_cuda
    from ..ops.sw import sw_align
    from ..ops.sw_torch import TB, TQ_RT

    rng = np.random.default_rng(3)
    fails = 0
    checks = 0
    for Lq, Lt, n_tiles in QM_LIGHT if light else QM_CONFIGS:
        nq = n_tiles
        qs = [rng.integers(0, 20, int(rng.integers(Lq // 4, Lq + 1)))
              .astype(np.int32) for _ in range(nq)]
        biases = [composition_bias_rounded(q, 1.0) for q in qs]
        q_mat = np.zeros((nq, Lq), np.int32)
        qb_mat = np.zeros((nq, Lq), np.int32)
        q_lens = np.array([len(q) for q in qs], np.int32)
        for i in range(nq):
            q_mat[i, :q_lens[i]] = qs[i]
            qb_mat[i, :q_lens[i]] = biases[i]
        nt = 64
        ts = [rng.integers(0, 20, int(rng.integers(Lt // 4, Lt + 1)))
              .astype(np.int32) for _ in range(nt)]
        t_mat = np.zeros((nt, Lt), np.int32)
        t_lens = np.array([len(t) for t in ts], np.int32)
        for i in range(nt):
            t_mat[i, :t_lens[i]] = ts[i]
        qidx = np.arange(n_tiles, dtype=np.int32)
        lj = np.full((n_tiles, TB), -1, np.int32)
        for tile in range(n_tiles):
            # sparse lanes keep the host-side numpy oracle tractable; the
            # kernel computes all TB lanes either way
            k = int(rng.integers(1, 17))
            lj[tile, :k] = rng.integers(0, nt, k)
        staged = [_put(a, device) for a in (q_mat, qb_mat, q_lens, t_mat,
                                            t_lens, qidx, lj.reshape(-1))]
        if Lq > 2 * TQ_RT:
            ends, starts = sw_cuda.qm_ends_rt, sw_cuda.qm_starts_rt
        else:
            ends, starts = sw_cuda.qm_ends, sw_cuda.qm_starts
        sc, qe, te = ends(*staged)
        _, qs_, ts_ = starts(*staged, qe.clamp_min(0), te.clamp_min(0))
        sc, qe, te, qs_, ts_ = (o.cpu().numpy() for o in (sc, qe, te, qs_,
                                                           ts_))
        for tile in range(n_tiles):
            for lane in range(TB):
                tj = lj[tile, lane]
                if tj < 0:
                    continue
                b = tile * TB + lane
                ref = sw_align(qs[tile], ts[tj], bias=biases[tile])
                got = dict(score=int(sc[b]), q_start=int(qs_[b]),
                           q_end=int(qe[b]), t_start=int(ts_[b]),
                           t_end=int(te[b]))
                checks += 1
                if not _same(ref, got):
                    fails += 1
                    print(f"QM MISMATCH Lq{Lq}/Lt{Lt} tile {tile} lane "
                          f"{lane}: ref {ref} got {got}", file=sys.stderr)
    return fails, checks


def selftest(device, light=False):
    """SW kernels vs the numpy oracle on ragged batches spanning the driver
    bucket boundaries (Lq/Lt = 256/1024/4096 tiers): selftest_qm, then the
    pair kernels K1 + K2 (sw_cuda.align_full, the counterpart of
    sw_pallas_align_batch: H capped at 32767). Prints and returns (fails,
    checks); light mode runs the reduced sets the main run embeds."""
    from ..data.submat import composition_bias_rounded
    from ..ops import sw_cuda
    from ..ops.sw import sw_align

    rng = np.random.default_rng(7)
    fails, checks = selftest_qm(device, light)
    for Lq_hi, Lt_hi, B in PAIR_LIGHT if light else PAIR_CONFIGS:
        q_lens = rng.integers(max(8, Lq_hi // 8), Lq_hi + 1, B)
        t_lens = rng.integers(max(8, Lt_hi // 8), Lt_hi + 1, B)
        qs = [rng.integers(0, 20, n).astype(np.int32) for n in q_lens]
        ts = [rng.integers(0, 20, n).astype(np.int32) for n in t_lens]
        bias = [composition_bias_rounded(q, 1.0) for q in qs]
        Lq = int(max(q_lens))
        Lt = int(max(t_lens))
        qm = np.zeros((B, Lq), np.int32)
        bm = np.zeros((B, Lq), np.int32)
        tm = np.zeros((B, Lt), np.int32)
        for i in range(B):
            qm[i, :q_lens[i]] = qs[i]
            bm[i, :q_lens[i]] = bias[i]
            tm[i, :t_lens[i]] = ts[i]
        outs = sw_cuda.align_full(*(_put(a, device) for a in (
            qm, bm, q_lens.astype(np.int32), tm, t_lens.astype(np.int32))))
        sc, qsrt, qend, tsrt, tend = (o.cpu().numpy() for o in outs)
        for i in range(B):
            ref = sw_align(qs[i], ts[i], bias=bias[i])
            got = dict(score=int(sc[i]), q_start=int(qsrt[i]),
                       q_end=int(qend[i]), t_start=int(tsrt[i]),
                       t_end=int(tend[i]))
            checks += 1
            if not _same(ref, got):
                fails += 1
                print(f"MISMATCH Lq{Lq_hi}/Lt{Lt_hi} pair {i}: "
                      f"ref {ref} got {got}", file=sys.stderr)
    what = "kernels" if device.type == "cuda" else "plain_versions"
    print(json.dumps({"selftest": f"sw_cuda_{what}_vs_oracle",
                      "fails": fails, "checks": checks}), flush=True)
    return fails, checks


def main(argv=None):
    """`metaeuk-tpu-torch bench ARGV`: the CLI's parser, then run."""
    from ..cli import main as cli_main
    return cli_main(["bench", *(sys.argv[1:] if argv is None else argv)])


def run(args):
    """The bench for the CLI's parsed `bench` flags: selftest, no_ref,
    no_selftest, device. Returns the exit code."""
    dev = _device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    print(f"bench on {dev} ({where})", file=sys.stderr, flush=True)
    if args.selftest:
        fails, _ = selftest(dev)
        return 1 if fails else 0

    mbp, n_targets, n_steady = knobs()
    tmp = tempfile.mkdtemp(prefix="meukbench")
    cpath, ppath, n_contigs = make_inputs(tmp, mbp, n_targets)
    walls, cold_wall, stages, cells = run_ours(cpath, ppath, tmp, n_steady,
                                               dev)
    wall = float(np.median(walls))
    contigs_per_s = n_contigs / wall

    ref_walls, ref_cold_wall = (None, None) if args.no_ref \
        else run_reference(cpath, ppath, tmp, n_steady)
    ref_wall = float(np.median(ref_walls)) if ref_walls else None
    vs = ref_wall / wall if ref_wall else None   # our contigs/s over its

    # the bench verifies the outputs it times: rerun the reference with
    # the goldens' deterministic methodology and byte-compare
    parity_ok = None if args.no_ref else run_parity(cpath, ppath, tmp)

    # the kernels against the oracle on the card, embedded in the artifact;
    # a mismatch ends the run without a result
    st_fails = st_checks = None
    if not args.no_selftest:
        st_fails, st_checks = selftest(dev, light=True)
        if st_fails:
            print(f"selftest: {st_fails} of {st_checks} checks differ from "
                  "the oracle", file=sys.stderr)
            return 1
    krate = kernel_rate(dev)
    krate_qm = kernel_rate_qm(dev)

    total_cells = sum(cells.values()) if cells else 0

    # stall detector: a timed window whose wall exceeds the median by >3x
    # is a host-side stall, not a property of the program; flag it so that
    # a poisoned median is visible
    def stalls(ws, med):
        return [round(w, 2) for w in ws if med and w > 3 * med]
    stalled = {"ours": stalls(walls, wall),
               "ref": stalls(ref_walls or [], ref_wall)}
    stall_suspected = bool(stalled["ours"] or stalled["ref"])
    if stall_suspected:
        print(f"WARNING: stall-suspect timed windows {stalled} "
              f"(>3x median); medians may be poisoned", file=sys.stderr)
    print(json.dumps({
        "metric": "easy_predict_contigs_per_s",
        "value": contigs_per_s,
        "unit": "contigs/s",
        "vs_baseline": vs,
        "extra": {
            "config": {"mbp": mbp, "targets": n_targets,
                       "contigs": n_contigs},
            "ours_wall_s": round(wall, 2),
            "ours_walls_s": [round(w, 2) for w in walls],
            "ours_cold_wall_s": round(cold_wall, 2),
            "ref_wall_s": round(ref_wall, 2) if ref_wall else None,
            "ref_walls_s": [round(w, 2) for w in ref_walls]
            if ref_walls else None,
            "ref_cold_wall_s": round(ref_cold_wall, 2)
            if ref_cold_wall else None,
            "parity_ok": parity_ok,
            "stall_suspected": stall_suspected,
            "stall_windows": stalled if stall_suspected else None,
            "selftest": {"fails": st_fails, "checks": st_checks},
            "stage_seconds": stages,
            "aligned_cells": cells,
            # aligned residue-cells/s over the whole easy-predict wall; at
            # this scale it is workload-limited (the prefilter keeps the
            # candidate pairs sparse), so the kernel rates below are the
            # device-utilisation view
            "aligned_cells_per_s_e2e": total_cells / wall if wall else None,
            "sw_kernel_cells_per_s": krate,
            "sw_kernel_qm_cells_per_s": krate_qm,
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
