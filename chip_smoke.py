#!/usr/bin/env python3
"""Smoke run of metaeuk_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        (from the root of a checkout; needs one card)

Phases, each fatal on failure:
  1. require a CUDA device; print the card's name and power limit
  2. build the CUDA kernels from metaeuk_tpu_torch/csrc with nvcc (one
     process per source, all started together) and the host library from
     native/ with g++
  3. each kernel against its plain PyTorch version on the card, compared
     with torch.equal (all outputs are integers: the tolerance is zero): the
     pair kernels on seeded ragged batches at the driver's bucket shapes (Lq
     up to 4608), the query-major kernels on seeded tiles at Lq 64..4096
     with Lt across 512, the row-tiled query-major kernels at a row tile
     of 64 on Lq 256..1024 and at the real one on the 16384 and 65536 tiers
     (true lengths up to 32,734, Lt up to 4096, equal scores planted in
     different row tiles at different columns) and the gapless kernel on
     seeded pairs, all with padding lanes and tiles, repeated targets
     (ties), implanted shared segments and zero-length sequences
  3b. the microbenchmark kernels against their plain versions, bit for bit
     (floats compared as their bits): every case of tools/kbench.py (T1-T3)
     at its TPU shape (256, 512) and REPS 512 on seeded non-zero inputs,
     T1 also at n_ops 2 and on one warp, every shift amount kb_shift is
     built for with both fills, a scan with values below NEG; every T4
     variant and the uN / tjN sweeps at tools/kernel_variants.py's default
     shape (32 tiles, Lq 256, Lt 2048), a small ragged shape with lanes
     that never score and repeated lanes, and a shape where H passes 32767
  4. easy-predict through the metaeuk-tpu-torch CLI on tests/data: the four
     outputs byte-identical to tests/golden/easypredict.*
  4b. easy-predict --prefilter-mode ungapped on tests/data and on the
     0.01 Mbp / 500-target metagenome: sha256 digests equal to
     tests/golden/ungapped_slice.json (the JAX package's outputs); the
     metagenome run goes through the query-major kernels under the default
     routing
  4c. easy-predict in k-mer and in ungapped mode on the long-frame golden
     input (make_long_slice.GOLDEN_INPUT: fragments in the 16384 and 65536
     tiers): sha256 digests equal to tests/golden/long_slice.json (the JAX
     package's outputs), the row-tiled kernels launched
  5. the k-mer main path at a real size: easy-predict on the 1.6 Mbp /
     3000-target synthetic metagenome of tests/golden/multichip_slice.json;
     the four sha256 digests equal the file's, the pair kernels launched and
     no plain version called in that run; wall, stage and align-phase
     seconds, cells and aligned cells/s
  5b. the ungapped path at a size its users meet: easy-predict
     --prefilter-mode ungapped on the 0.4 Mbp / 3000-target slice; the
     gapless and query-major kernels launched and no plain version called;
     the same candidate pairs aligned again through the driver with
     METAEUK_QM=off (the pair kernels) give a hit array equal field by field
  5c. the row-tiled path at full width: easy-predict --prefilter-mode
     ungapped on the 0.4 Mbp slice plus 48 contigs with frames of 4,200 to
     32,700 aa (make_long_slice.CHIP_SLICE); the gapless, query-major and
     row-tiled kernels launched and no plain version called; the same
     pairs through the pair kernels give an equal hit array; then the
     long-frame contigs alone in k-mer mode under the default routing and
     under METAEUK_QM=off, hits and outputs equal; wall, stage and
     align-phase seconds, cells and launches of each run
  6. kernel and plain-version times at main-path shapes, with CUDA events,
     each kernel's output there equal to its plain version's, beside each
     kernel's bound (the larger of its operations over the card's int32
     rate and its bytes over its memory rate)
  6b. the microbenchmark entry points (python -m metaeuk_tpu_torch.tools.
     kbench, .kernel_variants) over all their cases, the kernels launched
     and no plain version called; each new kernel's time beside its bound
     (T1 at the rate of each dtype's pipe) and its plain version's; T1 on
     one warp in cycles per dependent step at the SM clock nvidia-smi reads
     during the run; 64 x torch.cummax as T3's library yardstick; the SASS
     opcodes of each T1 chain (cuobjdump)
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before either.
"""

import contextlib
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
SUFFIXES = ("fas", "codon.fas", "headersMap.tsv", "gff")
CSRC = "metaeuk_tpu_torch/csrc"
KERNELS = {
    # name: (source, TPU kernel it replaces)
    "sw_pair_ends": ("sw_pair.cu", "metaeuk_tpu/ops/sw_pallas.py:86"),
    "sw_pair_starts": ("sw_pair.cu", "metaeuk_tpu/ops/sw_pallas.py:220"),
    "sw_qm_ends": ("sw_qm.cu", "metaeuk_tpu/ops/sw_pallas.py:405"),
    "sw_qm_starts": ("sw_qm.cu", "metaeuk_tpu/ops/sw_pallas.py:462"),
    "sw_qm_rt_ends": ("sw_qm_rt.cu", "metaeuk_tpu/ops/sw_pallas.py:539"),
    "sw_qm_rt_starts": ("sw_qm_rt.cu", "metaeuk_tpu/ops/sw_pallas.py:627"),
    "gapless_pair": ("gapless.cu", "metaeuk_tpu/ops/ungapped.py:44"),
    "kb_alu": ("kbench.cu", "tools/kbench.py:50"),
    "kb_shift": ("kbench.cu", "tools/kbench.py:79"),
    "kb_scan": ("kbench.cu", "tools/kbench.py:111"),
    "qm_variant_ends": ("qm_variants.cu", "tools/kernel_variants.py:48"),
}
PAIR_KERNELS = ("sw_pair_ends", "sw_pair_starts")
UNGAPPED_KERNELS = ("gapless_pair", "sw_qm_ends", "sw_qm_starts")
RT_KERNELS = ("sw_qm_rt_ends", "sw_qm_rt_starts")
# (Lq, Lt, pairs): the driver's length tiers, plus one tier above the TPU
# kernels' 4096-row bound
CHECK_SHAPES = ((64, 64, 1024), (128, 256, 1024), (256, 512, 2048),
                (1024, 1024, 256), (4096, 1024, 64), (4608, 512, 64))
# (Lq, Lt, query rows, target rows, tiles): query-major tiers up to 4096
# rows, Lt across one 512-column chunk
QM_SHAPES = ((64, 512, 64, 300, 96), (128, 1024, 64, 300, 64),
             (256, 256, 32, 300, 48), (1024, 1024, 8, 200, 12),
             (4096, 1024, 4, 100, 4))
# (Lq, Lt, query rows, target rows, tiles, row tile, query lengths): the
# row-tiled kernels at a shrunk row tile of 64 (many tile boundaries), then
# at the real one (None: sw_torch.TQ_RT) on the 16384 and 65536 tiers with
# true lengths up to 32,734 and Lt up to 4096
QM_RT_SHAPES = ((256, 512, 8, 300, 24, 64, (1, 256)),
                (1024, 1024, 4, 200, 12, 64, (1, 1024)),
                (16384, 512, 4, 300, 8, None, (4097, 16384)),
                (16384, 4096, 2, 64, 3, None, (4097, 6200)),
                (65536, 512, 3, 200, 6, None, (16385, 32734)))
# (Lq, Lt, query rows, target rows): gapless prefilter buckets, the last
# as large as one of the ungapped slice's launches (4.2M pairs)
GAPLESS_SHAPES = ((32, 64, 64, 300), (128, 512, 64, 300),
                  (512, 1024, 16, 100), (4096, 1024, 4, 50),
                  (64, 512, 1400, 3000))
# the ungapped slice of phase 5b: the 1.6 Mbp slice's generator and targets
UNGAPPED_SLICE = dict(mbp=0.4, targets=3000, seed=20260820)
# pair-launch cell budget of phase 5c's METAEUK_QM=off runs: every pair of
# a long-frame tier in one launch (the driver's default is 1 << 32)
OFF_CELL_BUDGET = 1 << 39
# timing shapes: pair kernels (Lq, Lt, pairs); query-major (Lq, Lt, tiles),
# timed with the pair kernels on the same pairs; gapless (Lq, Lt, pairs)
TIME_SHAPE = (256, 512, 4096)
QM_TIME_SHAPE = (128, 512, 512)
# row-tiled (Lq tier, Lt, tiles), query lengths 8192..16384, timed with the
# pair kernels on the same pairs
QM_RT_TIME_SHAPE = (16384, 512, 64)
GAPLESS_TIME_SHAPE = (128, 512, 1 << 18)
# H100 SXM peaks: int32 operations (64 INT32 lanes per SM, half the 128 FP32
# lanes behind the data sheet's 67 TFLOP/s, which counts an FMA as two) and
# device memory bytes per second
INT32_OPS_PER_S = 67e12 / 4
BYTES_PER_S = 3.35e12
# the least integer instructions per DP cell, with the bias folded into a
# per-query profile and each of sm_90's DPX functions (__viaddmax_s32,
# __viaddmax_s32_relu) counted as one instruction at the int32 rate.
# Smith-Waterman: G = max(Hdiag + s, E, 0) 1, H = min(max(G, F), cap) 2,
# E' = max(E - ge, H - go) 2, F' = max(G - go, F - ge) 2, best = max 1; the
# end positions' bookkeeping is not counted. Gapless: run = max(run + s, 0)
# 1, best = max 1.
SW_OPS, GAPLESS_OPS = 8, 2


def phase(name):
    print(f"== {name}", flush=True)


def ragged_batch(torch, rng, Lq, Lt, B, device):
    """Seeded pairs with ragged lengths, zero-length pairs, repeated pairs
    (ties) and pairs that share a segment (real hits)."""
    import numpy as np
    q = rng.integers(0, 21, (B, Lq))
    t = rng.integers(0, 21, (B, Lt))
    qb = rng.integers(-3, 4, (B, Lq))
    ql = rng.integers(1, Lq + 1, B)
    tl = rng.integers(1, Lt + 1, B)
    ql[::17] = 0
    tl[5::19] = 0
    for b in range(3, B, 7):   # implant a shared segment
        n = int(min(ql[b], tl[b], 40))
        t[b, :n] = q[b, :n]
    q[1::11], qb[1::11], ql[1::11] = q[0], qb[0], ql[0]
    t[1::11], tl[1::11] = t[0], tl[0]
    mk = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dt)
    return (mk(q, torch.uint8), mk(qb, torch.int8), mk(ql, torch.int32),
            mk(t, torch.uint8), mk(tl, torch.int32))


def staged_batch(torch, rng, Lq, Lt, nq, nt, device, lo=1):
    """Seeded staged matrices as the driver holds them: (nq, Lq) query codes
    and biases, (nt, Lt) target codes, lengths between lo and the tier
    width, zero-length rows, targets that repeat others (ties) and targets
    that share a segment with a query (real hits)."""
    import numpy as np
    q = rng.integers(0, 21, (nq, Lq))
    qb = rng.integers(-3, 4, (nq, Lq))
    ql = rng.integers(lo, Lq + 1, nq)
    t = rng.integers(0, 21, (nt, Lt))
    tl = rng.integers(lo, Lt + 1, nt)
    ql[5::13] = 0
    tl[7::23] = 0
    for k in range(2, nt, 5):
        qi = k % nq
        n = int(min(ql[qi], tl[k], 60))
        t[k, 3:3 + n] = q[qi, :n]
    t[1::9], tl[1::9] = t[0], tl[0]
    mk = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dt)
    return (mk(q, torch.uint8), mk(qb, torch.int8), mk(ql, torch.int32),
            mk(t, torch.uint8), mk(tl, torch.int32))


@contextlib.contextmanager
def pair_kernels_only(driver):
    """METAEUK_QM=off, with pair launches of up to OFF_CELL_BUDGET cells: one
    thread aligns one pair, so a launch takes as long as its longest pair,
    and the default budget cuts the 65536 tier into launches of 64 pairs."""
    budget = driver.CELL_BUDGET["cuda"]
    os.environ["METAEUK_QM"] = "off"
    driver.CELL_BUDGET["cuda"] = OFF_CELL_BUDGET
    try:
        yield
    finally:
        del os.environ["METAEUK_QM"]
        driver.CELL_BUDGET["cuda"] = budget


def same_hits(np, ref, got, what):
    if len(ref) != len(got) or any(not np.array_equal(ref[f], got[f])
                                   for f in ref.dtype.names):
        raise AssertionError(f"{what}: query-major and pair-kernel hit "
                             "arrays differ")
    print(f"{what}: query-major and pair-kernel hit arrays equal "
          f"({len(ref)} hits)", flush=True)


def max_err(torch, got, ref):
    err = 0
    for g, r in zip(got, ref):
        err = max(err, int((g.long() - r.long()).abs().max().item())
                  if g.numel() else 0)
        if not torch.equal(g, r):
            raise AssertionError("kernel disagrees with its plain version")
    return err


def check_pair_kernels(torch, sw_cuda, sw_torch, errs):
    import numpy as np
    rng = np.random.default_rng(20260820)
    for Lq, Lt, B in CHECK_SHAPES:
        args = ragged_batch(torch, rng, Lq, Lt, B, "cuda")
        got = sw_cuda.sw_ends(*args)
        torch.cuda.synchronize()
        ref = sw_torch.sw_ends(*args)
        errs["sw_pair_ends"] = max(errs["sw_pair_ends"],
                                   max_err(torch, got, ref))
        qe = torch.clamp_min(ref[1], 0)
        te = torch.clamp_min(ref[2], 0)
        # random ends too: rows/columns past the true lengths, and -1
        qe_r = torch.from_numpy(rng.integers(-1, Lq + 2, B)).to("cuda")
        te_r = torch.from_numpy(rng.integers(-1, Lt + 2, B)).to("cuda")
        for ends in ((qe, te), (qe_r.int(), te_r.int())):
            got = sw_cuda.sw_starts(*args, *ends)
            torch.cuda.synchronize()
            ref2 = sw_torch.sw_starts(*args, *ends)
            errs["sw_pair_starts"] = max(errs["sw_pair_starts"],
                                         max_err(torch, got, ref2))
        if not torch.equal(ref[0], sw_torch.sw_starts(*args, qe, te)[0]):
            raise AssertionError("reverse score differs from forward best")
        got = sw_cuda.align_full(*args)
        torch.cuda.synchronize()
        max_err(torch, got, sw_torch.align_full(*args))
        n_hit = int((ref[0] > 0).sum())
        print(f"pair Lq={Lq} Lt={Lt} B={B}: ends and starts equal "
              f"({n_hit} pairs with a hit)", flush=True)


def check_qm_kernels(torch, sw_cuda, sw_torch, errs):
    import numpy as np
    rng = np.random.default_rng(20260821)
    TB = sw_torch.TB
    for Lq, Lt, nq, nt, nT in QM_SHAPES:
        staged = staged_batch(torch, rng, Lq, Lt, nq, nt, "cuda")
        qidx = rng.integers(0, nq, nT)
        qidx[-1] = -1                       # a padding tile
        lj = rng.integers(0, nt, (nT, TB))
        lj[:, 100:] = -1                    # padding lanes
        lj[1, :] = np.arange(TB) % nt       # every target, repeats included
        lj[2, 5:40] = 1                     # one target many times (ties)
        args = (*staged, torch.from_numpy(qidx).int().cuda(),
                torch.from_numpy(lj.reshape(-1)).int().cuda())
        got = sw_cuda.qm_ends(*args)
        torch.cuda.synchronize()
        ref = sw_torch.qm_ends(*args)
        errs["sw_qm_ends"] = max(errs["sw_qm_ends"], max_err(torch, got, ref))
        qe = torch.clamp_min(ref[1], 0)
        te = torch.clamp_min(ref[2], 0)
        B = nT * TB
        qe_r = torch.from_numpy(rng.integers(-1, Lq + 2, B)).int().cuda()
        te_r = torch.from_numpy(rng.integers(-1, Lt + 2, B)).int().cuda()
        for ends in ((qe, te), (qe_r, te_r)):
            got = sw_cuda.qm_starts(*args, *ends)
            torch.cuda.synchronize()
            ref2 = sw_torch.qm_starts(*args, *ends)
            errs["sw_qm_starts"] = max(errs["sw_qm_starts"],
                                       max_err(torch, got, ref2))
        if not torch.equal(ref[0], sw_torch.qm_starts(*args, qe, te)[0]):
            raise AssertionError("reverse score differs from forward best")
        print(f"query-major Lq={Lq} Lt={Lt} tiles={nT}: ends and starts "
              f"equal ({int((ref[0] > 0).sum())} lanes with a hit)",
              flush=True)


def plant_row_tile_ties(q, qb, ql, t, tl, tq, rng, n=24):
    """Query 0 gets a segment A in its first row tile and a permutation B of
    A (the same self-score) two row tiles down, and a bias of -4 on its
    other rows; target 0 (and its repeat, target 1) holds B early and A
    late, target 2 the other way round: equal scores in different row tiles
    at different columns, forward and reverse."""
    rA, rB, cE, cL = 5, 2 * tq + 5, 3, 200
    A = rng.integers(0, 20, n)
    B = rng.permutation(A)
    ql[0] = max(ql[0], rB + n + 1)
    q[0, rA:rA + n], q[0, rB:rB + n] = A, B
    qb[0] = -4
    qb[0, rA:rA + n] = qb[0, rB:rB + n] = 0
    for k, (early, late) in ((0, (B, A)), (2, (A, B))):
        t[k, cE:cE + n], t[k, cL:cL + n] = early, late
        tl[k] = max(tl[k], cL + n + 1)
    t[1], tl[1] = t[0], tl[0]


def check_qm_rt_kernels(torch, sw_cuda, sw_torch, errs):
    import numpy as np
    rng = np.random.default_rng(20260823)
    TB = sw_torch.TB
    for Lq, Lt, nq, nt, nT, tq, (lo, hi) in QM_RT_SHAPES:
        tq = tq or sw_torch.TQ_RT
        q, qb, _, t, tl = (a.numpy().copy() for a in staged_batch(
            torch, rng, Lq, Lt, nq, nt, "cpu"))
        ql = rng.integers(lo, hi + 1, nq).astype(np.int32)
        ql[5::13] = 0
        plant_row_tile_ties(q, qb, ql, t, tl, tq, rng)
        qidx = rng.integers(0, nq, nT).astype(np.int32)
        qidx[:2] = 0                        # query 0's ties
        qidx[-1] = -1                       # a padding tile
        lj = rng.integers(0, nt, (nT, TB)).astype(np.int32)
        lj[:, 100:] = -1                    # padding lanes
        lj[1, :] = np.arange(TB) % nt       # every target, repeats included
        lj[2, 5:40] = 1                     # one target many times (ties)
        args = tuple(torch.from_numpy(a).cuda() for a in (
            q, qb, ql, t, tl, qidx, lj.reshape(-1)))
        got = sw_cuda.qm_ends_rt(*args, tq=tq)
        torch.cuda.synchronize()
        ref = sw_torch.qm_ends_rt(*args, tq=tq)
        errs["sw_qm_rt_ends"] = max(errs["sw_qm_rt_ends"],
                                    max_err(torch, got, ref))
        B = nT * TB
        ends = [(torch.clamp_min(ref[1], 0), torch.clamp_min(ref[2], 0))]
        if tq < sw_torch.TQ_RT:   # random ends, past the lengths and -1
            ends.append(tuple(torch.from_numpy(rng.integers(-1, n + 2, B))
                              .int().cuda() for n in (Lq, Lt)))
        for k, (qe, te) in enumerate(ends):
            got = sw_cuda.qm_starts_rt(*args, qe, te, tq=tq)
            torch.cuda.synchronize()
            ref2 = sw_torch.qm_starts_rt(*args, qe, te, tq=tq)
            errs["sw_qm_rt_starts"] = max(errs["sw_qm_rt_starts"],
                                          max_err(torch, got, ref2))
            if k == 0 and not torch.equal(ref[0], ref2[0]):
                raise AssertionError("reverse score differs from forward "
                                     "best")
        tie = [int(ref[k][TB]) for k in range(3)]   # tile 1, lane 0: target 0
        print(f"row-tiled Lq={Lq} Lt={Lt} tiles={nT} row tile {tq}, query "
              f"lengths up to {int(ql.max())}: ends and starts equal "
              f"({int((ref[0] > 0).sum())} lanes with a hit; planted tie "
              f"won at row {tie[1]}, column {tie[2]}, score {tie[0]})",
              flush=True)


def check_gapless_kernel(torch, ungapped_cuda, ungapped_torch, errs):
    import numpy as np
    rng = np.random.default_rng(20260822)
    for Lq, Lt, nq, nt in GAPLESS_SHAPES:
        staged = staged_batch(torch, rng, Lq, Lt, nq, nt, "cuda")
        # the prefilter's query-major cross product, then seeded pairs with
        # out-of-range indices (score 0)
        flat = torch.arange(nq * nt, device="cuda")
        pairs = [((flat // nt).int(), (flat % nt).int()),
                 tuple(torch.from_numpy(rng.integers(-1, n + 1, 4096))
                       .int().cuda() for n in (nq, nt))]
        for li, lj in pairs:
            got = ungapped_cuda.gapless_scores_gathered(*staged, li, lj)
            torch.cuda.synchronize()
            ref = ungapped_torch.gapless_gathered(*staged, li, lj)
            errs["gapless_pair"] = max(errs["gapless_pair"],
                                       max_err(torch, (got,), (ref,)))
        print(f"gapless Lq={Lq} Lt={Lt} pairs={nq * nt}: equal "
              f"(best {int(ref.max())})", flush=True)


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(cells, ops_per_cell, tensors):
    """(bound_ms, bound_by): the larger of the operations over the int32
    rate and the bytes of every input and output (each moved once) over the
    memory rate."""
    ops_ms = cells * ops_per_cell / INT32_OPS_PER_S * 1e3
    byte_ms = sum(t.numel() * t.element_size() for t in tensors) \
        / BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= byte_ms else \
        (byte_ms, "bytes")


def sha256(path):
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


def digests(prefix):
    return {s: sha256(f"{prefix}.{s}") for s in SUFFIXES}


def reset(torch, counters, driver, prefilter):
    for c in counters:
        c.reset_counts()
    for k in driver.CELLS:
        driver.CELLS[k] = 0
    driver.PHASE_SECONDS.clear()
    prefilter.CELLS["gapless"] = 0
    torch.cuda.synchronize()


def counts(counters):
    launches, plain = {}, {}
    for c in counters:
        launches.update(c.LAUNCHES)
        plain.update(c.PLAIN_CALLS)
    return launches, plain


def fragments(extractor, contigs):
    """The serial path's translated fragments (predict.py predict_exons)."""
    orf_aa = []
    for ci in range(len(contigs)):
        _, frags = extractor.extract_contig(contigs.seq_bytes(ci), ci)
        orf_aa.extend(extractor.translate_fragments(frags))
    return orf_aa


def time_kernels(torch, np, sw_cuda, sw_torch, ungapped_cuda,
                 ungapped_torch, errs):
    """{name: (ms, plain_ms, bound_ms, bound_by)} at main-path shapes; each
    kernel's output there must equal its plain version's (folded into
    errs)."""
    out = {}
    dev = "cuda"
    # pair kernels: lengths between half and all of the tier width
    Lq, Lt, B = TIME_SHAPE
    rng = np.random.default_rng(7)
    args = ragged_batch(torch, rng, Lq, Lt, B, dev)
    args = (*args[:2], torch.from_numpy(rng.integers(
        Lq // 2, Lq + 1, B)).int().cuda(), args[3], torch.from_numpy(
        rng.integers(Lt // 2, Lt + 1, B)).int().cuda())
    _, qe, te = sw_torch.sw_ends(*args)
    qe, te = torch.clamp_min(qe, 0), torch.clamp_min(te, 0)
    fwd = int((args[2].long() * args[4].long()).sum())
    rev = int(((torch.minimum(qe, args[2] - 1).long() + 1)
               * (torch.minimum(te, args[4] - 1).long() + 1)).sum())
    ends = sw_cuda.sw_ends(*args)
    errs["sw_pair_ends"] = max(errs["sw_pair_ends"], max_err(
        torch, ends, sw_torch.sw_ends(*args)))
    errs["sw_pair_starts"] = max(errs["sw_pair_starts"], max_err(
        torch, sw_cuda.sw_starts(*args, qe, te),
        sw_torch.sw_starts(*args, qe, te)))
    out["sw_pair_ends"] = (
        time_ms(torch, lambda: sw_cuda.sw_ends(*args), 10),
        time_ms(torch, lambda: sw_torch.sw_ends(*args), 2),
        *bound(fwd, SW_OPS, (*args, *ends)))
    out["sw_pair_starts"] = (
        time_ms(torch, lambda: sw_cuda.sw_starts(*args, qe, te), 10),
        time_ms(torch, lambda: sw_torch.sw_starts(*args, qe, te), 2),
        *bound(rev, SW_OPS, (*args, qe, te, *ends)))
    print(f"pair B={B} Lq={Lq} Lt={Lt}: {fwd} forward cells, {rev} "
          "reverse cells", flush=True)

    # query-major kernels: one query per tile, 128 distinct targets per
    # tile, lengths between half and all of the tier width; then the pair
    # kernels on the same pairs
    Lq, Lt, nT = QM_TIME_SHAPE
    rng = np.random.default_rng(8)
    TB = sw_torch.TB
    nt = 3000
    staged = staged_batch(torch, rng, Lq, Lt, nT, nt, dev, lo=1)
    q, qb, ql, t, tl = staged
    ql = torch.from_numpy(rng.integers(Lq // 2, Lq + 1, nT)).int().cuda()
    tl = torch.from_numpy(rng.integers(Lt // 2, Lt + 1, nt)).int().cuda()
    staged = (q, qb, ql, t, tl)
    qidx = torch.arange(nT, device=dev, dtype=torch.int32)
    lj = torch.from_numpy(np.stack([rng.choice(nt, TB, replace=False)
                                    for _ in range(nT)]).reshape(-1)).int()
    lj = lj.cuda()
    ends = sw_cuda.qm_ends(*staged, qidx, lj)
    qe, te = torch.clamp_min(ends[1], 0), torch.clamp_min(ends[2], 0)
    lane_q = qidx.long().repeat_interleave(TB)
    q_len, t_len = ql[lane_q], tl[lj.long()]
    fwd = int((q_len.long() * t_len.long()).sum())
    rev = int(((torch.minimum(qe, q_len - 1).long() + 1)
               * (torch.minimum(te, t_len - 1).long() + 1)).sum())
    qm_args = (*staged, qidx, lj)
    errs["sw_qm_ends"] = max(errs["sw_qm_ends"], max_err(
        torch, ends, sw_torch.qm_ends(*qm_args)))
    errs["sw_qm_starts"] = max(errs["sw_qm_starts"], max_err(
        torch, sw_cuda.qm_starts(*qm_args, qe, te),
        sw_torch.qm_starts(*qm_args, qe, te)))
    out["sw_qm_ends"] = (
        time_ms(torch, lambda: sw_cuda.qm_ends(*qm_args), 10),
        time_ms(torch, lambda: sw_torch.qm_ends(*qm_args), 2),
        *bound(fwd, SW_OPS, (*qm_args, *ends)))
    out["sw_qm_starts"] = (
        time_ms(torch, lambda: sw_cuda.qm_starts(*qm_args, qe, te), 10),
        time_ms(torch, lambda: sw_torch.qm_starts(*qm_args, qe, te), 2),
        *bound(rev, SW_OPS, (*qm_args, qe, te, *ends)))
    pair_args = (q[lane_q], qb[lane_q], q_len, t[lj.long()], t_len)
    same = (time_ms(torch, lambda: sw_cuda.sw_ends(*pair_args), 10),
            time_ms(torch, lambda: sw_cuda.sw_starts(*pair_args, qe, te), 10))
    print(f"query-major tiles={nT} (pairs {nT * TB}) Lq={Lq} Lt={Lt}: {fwd} "
          f"forward cells, {rev} reverse cells; pair kernels on the same "
          f"pairs: ends {same[0]:.4f} ms, starts {same[1]:.4f} ms",
          flush=True)

    # gapless kernel: the prefilter's cross product of one bucket pair
    Lq, Lt, B = GAPLESS_TIME_SHAPE
    nq = B // nt + 1
    staged = staged_batch(torch, rng, Lq, Lt, nq, nt, dev, lo=Lq // 2)
    flat = torch.arange(B, device=dev)
    li, lj = (flat // nt).int(), (flat % nt).int()
    cells = int((staged[2][li.long()].long()
                 * staged[4][lj.long()].long()).sum())
    best = ungapped_cuda.gapless_scores_gathered(*staged, li, lj)
    errs["gapless_pair"] = max(errs["gapless_pair"], max_err(
        torch, (best,), (ungapped_torch.gapless_gathered(*staged, li, lj),)))
    out["gapless_pair"] = (
        time_ms(torch, lambda: ungapped_cuda.gapless_scores_gathered(
            *staged, li, lj), 10),
        time_ms(torch, lambda: ungapped_torch.gapless_gathered(
            *staged, li, lj), 2),
        *bound(cells, GAPLESS_OPS, (*staged, li, lj, best)))
    print(f"gapless pairs={B} Lq={Lq} Lt={Lt}: {cells} cells", flush=True)
    return out, same


def time_qm_rt(torch, np, sw_cuda, sw_torch, errs):
    """{name: (ms, plain_ms, bound_ms, bound_by)} of the row-tiled kernels at
    QM_RT_TIME_SHAPE, one query per tile and 128 distinct targets per tile,
    each kernel's output there equal to its plain version's; and the pair
    kernels' (ends, starts) ms on the same pairs."""
    Lq, Lt, nT = QM_RT_TIME_SHAPE
    rng = np.random.default_rng(10)
    TB, nt, dev = sw_torch.TB, 3000, "cuda"
    q, qb, _, t, _ = staged_batch(torch, rng, Lq, Lt, nT, nt, dev)
    ql = torch.from_numpy(rng.integers(Lq // 2, Lq + 1, nT)).int().cuda()
    tl = torch.from_numpy(rng.integers(Lt // 2, Lt + 1, nt)).int().cuda()
    qidx = torch.arange(nT, device=dev, dtype=torch.int32)
    lj = torch.from_numpy(np.stack([rng.choice(nt, TB, replace=False)
                                    for _ in range(nT)]).reshape(-1)).int()
    args = (q, qb, ql, t, tl, qidx, lj.cuda())
    ends = sw_cuda.qm_ends_rt(*args)
    qe, te = torch.clamp_min(ends[1], 0), torch.clamp_min(ends[2], 0)
    lane_q = qidx.long().repeat_interleave(TB)
    q_len, t_len = ql[lane_q], tl[args[-1].long()]
    fwd = int((q_len.long() * t_len.long()).sum())
    rev = int(((torch.minimum(qe, q_len - 1).long() + 1)
               * (torch.minimum(te, t_len - 1).long() + 1)).sum())
    errs["sw_qm_rt_ends"] = max(errs["sw_qm_rt_ends"], max_err(
        torch, ends, sw_torch.qm_ends_rt(*args)))
    starts = sw_cuda.qm_starts_rt(*args, qe, te)
    errs["sw_qm_rt_starts"] = max(errs["sw_qm_rt_starts"], max_err(
        torch, starts, sw_torch.qm_starts_rt(*args, qe, te)))
    out = {
        "sw_qm_rt_ends": (
            time_ms(torch, lambda: sw_cuda.qm_ends_rt(*args), 2),
            time_ms(torch, lambda: sw_torch.qm_ends_rt(*args), 1),
            *bound(fwd, SW_OPS, (*args, *ends))),
        "sw_qm_rt_starts": (
            time_ms(torch, lambda: sw_cuda.qm_starts_rt(*args, qe, te), 2),
            time_ms(torch, lambda: sw_torch.qm_starts_rt(*args, qe, te), 1),
            *bound(rev, SW_OPS, (*args, qe, te, *starts)))}
    pair_args = (q[lane_q], qb[lane_q], q_len, t[args[-1].long()], t_len)
    same = (time_ms(torch, lambda: sw_cuda.sw_ends(*pair_args), 1),
            time_ms(torch, lambda: sw_cuda.sw_starts(*pair_args, qe, te), 1))
    print(f"row-tiled tiles={nT} (pairs {nT * TB}) Lq={Lq} Lt={Lt}: {fwd} "
          f"forward cells, {rev} reverse cells; pair kernels on the same "
          f"pairs: ends {same[0]:.4f} ms, starts {same[1]:.4f} ms",
          flush=True)
    return out, same


def bits(torch, t):
    """Floats as their bit patterns, so equality is exact to the bit."""
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(
        t.dtype)
    return t if view is None else t.view(view)


def check_kbench_kernels(torch, kbench_cuda, kbench_torch, kb, errs):
    """Every kbench case at the TPU shape and REPS on seeded non-zero
    inputs, each dtype's chain also at n_ops 2 and on one warp, and every
    shift amount the kernel is built for, both fills."""
    checks = [(name, kb.SHAPE, kb.REPS, {}) for name in kb.CASES]
    for name in ("alu_i32", "alu_i16", "alu_f32", "alu_bf16"):
        checks.append((name, kb.SHAPE, kb.REPS, {"n_ops": 2}))
        words = 64 if name in ("alu_i16", "alu_bf16") else 32
        checks.append((name, (1, words), kb.REPS, {}))
    for amount in kbench_cuda.SHIFT_AMOUNTS:
        for roll in (False, True):
            checks.append(("shift_i32", kb.SHAPE, 64,
                           {"amount": amount, "roll": roll}))
    checks.append(("shift_i16", kb.SHAPE, kb.REPS, {"amount": 3}))
    checks.append(("shift_i16", kb.SHAPE, kb.REPS, {"amount": 64,
                                                    "roll": True}))
    kernel_of = {"alu": "kb_alu", "shift": "kb_shift", "scan": "kb_scan"}
    for seed, (name, shape, reps, extra) in enumerate(checks, 1):
        kind, _, kw = kb.CASES[name]
        kw = {**kw, **extra}
        x = kb.case_input(name, "cuda", seed=seed, shape=shape)
        got = getattr(kbench_cuda, kind)(x, reps, **kw)
        torch.cuda.synchronize()
        ref = getattr(kbench_torch, kind)(x, reps, **kw)
        k = kernel_of[kind]
        errs[k] = max(errs[k], max_err(torch, (bits(torch, got),),
                                       (bits(torch, ref),)))
    # columns below NEG, where the Pallas scan's fill reaches every row but
    # the last
    x = kb.case_input("scan256", "cuda", seed=len(checks) + 1)
    x[:, :3] = -2_000_000 - torch.arange(256, device="cuda",
                                         dtype=torch.int32)[:, None]
    errs["kb_scan"] = max(errs["kb_scan"], max_err(
        torch, (kbench_cuda.scan(x),), (kbench_torch.scan(x),)))
    print(f"kbench: {len(checks) + 1} cases equal to the plain versions bit "
          f"for bit (the 11 cases at {kb.SHAPE}, REPS {kb.REPS}; n_ops 2; one "
          f"warp; shift amounts {kbench_cuda.SHIFT_AMOUNTS} with zero fill "
          "and wrapped; a scan with columns below NEG)", flush=True)


def variant_checks(torch, np, kvar):
    """(what, prof, tc, variant, tj, unroll) on the card: every variant and
    the uN / tjN sweeps at the TPU tool's default shape; every variant on a
    small shape with lanes that never score (codes at -128 or outside the
    profile), repeated lanes and a narrow score range (ties); every variant
    where H passes 32767."""
    V = ("base", "fold", "nocap", "fold_nocap", "nof")
    for v in V:
        yield (v, *kvar.variant_inputs(v, 256, 2048, 32, "cuda"), v, 256, 8)
    for u in (1, 2, 4, 16):
        yield (f"u{u}", *kvar.variant_inputs("base", 256, 2048, 32, "cuda"),
               "base", 256, u)
    for tj in (100, 1024):
        yield (f"tj{tj}", *kvar.variant_inputs("base", 256, 2048, 32,
                                               "cuda"), "base", tj, 8)
    rng = np.random.default_rng(20261016)
    Lq, Lt, nT = 96, 300, 3
    prof = rng.integers(0, 3, (nT, Lq, 32)).astype(np.float32)
    prof[:, :, 21:] = -128
    tc = rng.integers(0, 20, (Lt, nT * 128)).astype(np.int32)
    tc[:, 7] = 25                          # every cell at -128
    tc[:, 8] = 40                          # outside the profile: 0
    tc[:, 9] = -1
    tc[:, 10:40] = tc[:, 5:6]              # one lane repeated
    cap = np.full((1, 256, 32), 200, np.float32)
    cap[:, :, 21:] = -128
    cap_tc = np.zeros((512, 128), np.int32)
    cap_tc[:, 1] = 25
    for v in V:
        shift = 1 if v in ("fold", "fold_nocap") else 0
        p = prof.copy()
        p[:, :, :21] += shift
        yield (f"ragged {v}", torch.from_numpy(p).bfloat16().cuda(),
               torch.from_numpy(tc).cuda(), v, 100, 8)
        p = cap.copy()
        p[:, :, :21] += shift
        yield (f"cap {v}", torch.from_numpy(p).bfloat16().cuda(),
               torch.from_numpy(cap_tc).cuda(), v, 512, 8)


def check_variant_kernel(torch, np, qm_variants_cuda, qm_variants_torch,
                         kvar, errs):
    for what, prof, tc, v, tj, u in variant_checks(torch, np, kvar):
        got = qm_variants_cuda.qm_variant_ends(prof, tc, v, tj, u)
        torch.cuda.synchronize()
        ref = qm_variants_torch.qm_variant_ends(prof, tc, v, tj, u)
        errs["qm_variant_ends"] = max(errs["qm_variant_ends"],
                                      max_err(torch, got, ref))
        if what.startswith("cap"):
            over = int(ref[0][0]) > 32767
            if over != (v in ("nocap", "fold_nocap")) or int(ref[0][1]):
                raise AssertionError(f"{what}: best {int(ref[0][0])}, the "
                                     "cap case does not pass 32767")
        print(f"variant {what} (Lq {prof.shape[1]}, Lt {tc.shape[0]}, "
              f"tiles {prof.shape[0]}, tj {tj}, u {u}): equal; lane 0 "
              f"{[int(o[0]) for o in ref]}, {int((ref[0] > 0).sum())} lanes "
              "with a hit", flush=True)


# T1's pipes on an H100 SXM: int32 at INT32_OPS_PER_S (one DPX add-max a
# step; __viaddmax_s16x2 two lanes a step); float32 and packed bfloat16 at
# the FP32 instruction rate (128 lanes an SM, half the data sheet's 67
# TFLOP/s that counts an FMA as two), add and max one instruction each,
# two lanes an instruction for bfloat16
FP32_INSTR_PER_S = 67e12 / 2
ALU_PIPE = {   # case: (instructions a step, their rate)
    "alu_i32": (1, INT32_OPS_PER_S), "alu_i16": (0.5, INT32_OPS_PER_S),
    "alu_f32": (2, FP32_INSTR_PER_S), "alu_bf16": (1, FP32_INSTR_PER_S)}


def kbench_bound(kb, name, x):
    """(bound_ms, bound_by, rule) of a kbench case on x: the least
    instructions over the pipe's rate, or its bytes (x read, out written)
    over the memory rate. T2 needs one max an element a rep (the move can be
    a register rename; int16 packed two a word); T3 n - 1 max and one
    subtraction an element a pass."""
    kind = kb.CASES[name][0]
    n = x.numel()
    if kind == "alu":
        per_step, rate = ALU_PIPE[name]
        instr = kb.REPS * 4 * n * per_step
        rule = f"{per_step} instr/step at {rate:.4g}/s"
    elif kind == "shift":
        rate = INT32_OPS_PER_S
        instr = kb.REPS * n * (0.5 if x.dtype.itemsize == 2 else 1)
        rule = f"1 max/element/rep at {rate:.4g}/s"
    else:
        rate = INT32_OPS_PER_S
        instr = (kb.REPS // 8) * 2 * n
        rule = f"2 ops/element/pass at {rate:.4g}/s"
    ops_ms = instr / rate * 1e3
    byte_ms = 2 * n * x.element_size() / BYTES_PER_S * 1e3
    return (ops_ms, "operations", rule) if ops_ms >= byte_ms else \
        (byte_ms, "bytes", rule)


def sm_clock_mhz():
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def one_warp_latency(torch, kbench_cuda, kb):
    """T1 on one warp (32 words): ms per call over about 1.5 s of queued
    calls, the SM clock read by nvidia-smi while they run, and the cycles
    per dependent step (one add-max) and per operation (two a step)."""
    reps = 16384
    for name in ("alu_i32", "alu_i16", "alu_f32", "alu_bf16"):
        words = 64 if name in ("alu_i16", "alu_bf16") else 32
        x = kb.case_input(name, "cuda", seed=3, shape=(1, words))
        run = lambda: kbench_cuda.alu(x, reps)
        per_call = time_ms(torch, run, 20)
        n = max(20, int(1500 / per_call))
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            run()
        stop.record()
        mhz = sm_clock_mhz()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / n
        cyc = ms * 1e-3 * mhz * 1e6 / (reps * 4)
        print(f"{name} on one warp: {ms:.4f} ms per call of {reps} reps x 4 "
              f"dependent steps, SM clock {mhz:.0f} MHz during the run: "
              f"{cyc:.2f} cycles per dependent step, {cyc / 2:.2f} per "
              "operation (latency)", flush=True)


def sass_census(_build):
    """The opcodes of each kb_alu chain at n_ops 8 (the kernel unrolled for
    n_ops / 2 = 4 steps), from cuobjdump -sass of the built library (what
    T1's dtypes end in)."""
    import re
    import shutil
    from collections import Counter
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        print("cuobjdump not found: SASS census not taken", flush=True)
        return
    sass = subprocess.run([tool, "-sass", str(_build.build("kbench"))],
                          capture_output=True, text=True, check=True).stdout
    op = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)")
    found = 0
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        tag = next((t for t in ("AluI16x2", "AluBF16x2", "AluI32", "AluF32")
                    if t in name), None)
        if tag is None or "Li4E" not in name:
            continue
        found += 1
        ops = Counter(op.findall(fn))
        print(f"SASS {tag} (n_ops 8): " + ", ".join(
            f"{k} {v}" for k, v in ops.most_common(8)), flush=True)
    if found != 4:
        raise AssertionError(f"cuobjdump showed {found} of the 4 kb_alu "
                             "chains at n_ops 8")


def run_tools(torch, np, kb, kvar, kbench_cuda, kbench_torch,
              qm_variants_cuda, qm_variants_torch, _build):
    """Both entry points over all their cases, counted; then each new
    kernel's time beside its bound and its plain version's, T1 on one warp,
    T3's torch.cummax yardstick and the SASS census. ({name: (ms, plain_ms,
    bound_ms, bound_by)}, launches, {name: library_ms})."""
    for c in (kbench_cuda, qm_variants_cuda):
        c.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kres = kb.main([])
    kvar.main([])
    kvar.main(["u1", "u2", "u4", "u16", "tj64", "tj1024"])
    torch.cuda.synchronize()
    launches, plain = counts((kbench_cuda, qm_variants_cuda))
    print(f"entry points: {time.perf_counter() - t0:.2f} s, launches "
          f"{launches}, plain {plain}", flush=True)
    if min(launches.values()) == 0 or any(plain.values()):
        raise AssertionError("the entry points did not go through the "
                             "kernels")
    out, library = {}, {}
    rows = {}
    for name in kb.CASES:
        x = kb.case_input(name, "cuda")
        kind, _, kw = kb.CASES[name]
        plain_ms = time_ms(torch, lambda: getattr(kbench_torch, kind)(
            x, kb.REPS, **kw), 2)
        bound_ms, by, rule = kbench_bound(kb, name, x)
        rows[name] = (kres[name][0] / 1e3, plain_ms, bound_ms, by)
        print(f"{name}: kernel {kres[name][0] / 1e3:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({by}: {rule})",
              flush=True)
    for k, name in (("kb_alu", "alu_i32"), ("kb_shift", "shift_i32"),
                    ("kb_scan", "scan256")):
        out[k] = rows[name]
    x = kb.case_input("scan256", "cuda", seed=5)

    def cummax_yardstick():
        a = x
        for _ in range(kb.REPS // 8):
            a = torch.cummax(a, 0).values - 1
        return a
    library["kb_scan"] = time_ms(torch, cummax_yardstick, 10)
    if not torch.equal(cummax_yardstick(), kbench_cuda.scan(x)):
        raise AssertionError("torch.cummax yardstick differs from kb_scan")
    print(f"scan256 library yardstick, {kb.REPS // 8} x (torch.cummax(a, "
          f"0).values - 1): {library['kb_scan']:.4f} ms (equal output)",
          flush=True)
    prof, tc = kvar.variant_inputs("base", 256, 2048, 32, "cuda")
    cells = 32 * 128 * 256 * 2048
    run = lambda: qm_variants_cuda.qm_variant_ends(prof, tc)
    out["qm_variant_ends"] = (
        time_ms(torch, run, 10),
        time_ms(torch, lambda: qm_variants_torch.qm_variant_ends(prof, tc),
                1),
        *bound(cells, SW_OPS, (prof, tc, *run())))
    print(f"qm_variant_ends base, 32 tiles, Lq 256, Lt 2048 ({cells} cells):"
          f" kernel {out['qm_variant_ends'][0]:.4f} ms, plain "
          f"{out['qm_variant_ends'][1]:.4f} ms, bound "
          f"{out['qm_variant_ends'][2]:.4f} ms", flush=True)
    one_warp_latency(torch, kbench_cuda, kb)
    sass_census(_build)
    return out, launches, library


def main():
    if not (ROOT / CSRC / "sw_pair.cu").exists():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch
    phase("1 device")
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    sys.path.insert(0, str(ROOT))
    from metaeuk_tpu_torch import cli, native
    from metaeuk_tpu_torch.io.seqdb import DBTYPE_AA, DBTYPE_NUCL, SeqDB
    from metaeuk_tpu_torch.ops import (_build, sw_cuda, sw_torch,
                                       ungapped_cuda, ungapped_torch)
    from metaeuk_tpu_torch.ops.orf import OrfExtractor
    from metaeuk_tpu_torch.params import Params
    from metaeuk_tpu_torch.pipeline.predict import EasyPredict
    from metaeuk_tpu_torch.ops import (kbench_cuda, kbench_torch,
                                       qm_variants_cuda, qm_variants_torch)
    from metaeuk_tpu_torch.search import driver, prefilter
    from metaeuk_tpu_torch.tools import kbench as kb
    from metaeuk_tpu_torch.tools import kernel_variants as kvar
    counters = (sw_cuda, ungapped_cuda)

    phase("2 build")
    t0 = time.perf_counter()
    sources = sorted({s[:-3] for s, _ in KERNELS.values()})
    with ThreadPoolExecutor(len(sources) + 1) as ex:
        host = ex.submit(native.get_lib)
        for f in [ex.submit(_build.load, s) for s in sources]:
            f.result()
        if host.result() is None:
            raise AssertionError("the native host library did not build")
    print(f"nvcc builds of {sources} and the g++ host library "
          f"{native.library_path().name}: {time.perf_counter() - t0:.2f} s")
    for s in sources:
        b = _build.BUILT.get(s, {})
        print(f"{s}.cu {b.get('seconds', 0.0):.2f} s")
        print(b.get("ptxas", "(cached)"), flush=True)

    phase("3 kernels against their plain versions")
    errs = dict.fromkeys(KERNELS, 0)
    check_pair_kernels(torch, sw_cuda, sw_torch, errs)
    check_qm_kernels(torch, sw_cuda, sw_torch, errs)
    check_qm_rt_kernels(torch, sw_cuda, sw_torch, errs)
    check_gapless_kernel(torch, ungapped_cuda, ungapped_torch, errs)

    phase("3b microbenchmark kernels against their plain versions")
    t0 = time.perf_counter()
    check_kbench_kernels(torch, kbench_cuda, kbench_torch, kb, errs)
    check_variant_kernel(torch, np, qm_variants_cuda, qm_variants_torch,
                         kvar, errs)
    print(f"phase 3b: {time.perf_counter() - t0:.2f} s", flush=True)

    from tools.make_metagenome import make_metagenome, write_fasta
    sys.path.insert(0, str(GOLDEN))
    import make_long_slice as mls
    ungapped = json.loads((GOLDEN / "ungapped_slice.json").read_text())
    launches = {}
    with tempfile.TemporaryDirectory(prefix="meuk_smoke") as td:
        td = pathlib.Path(td)
        phase("4 easy-predict on tests/data against the goldens")
        reset(torch, counters, driver, prefilter)
        out = td / "fixture"
        t0 = time.perf_counter()
        cli.main(["easy-predict", str(ROOT / "tests" / "data" /
                                      "contigs.fna"),
                  str(ROOT / "tests" / "data" / "proteins.faa"), str(out),
                  "--device", "cuda"])
        run_l, run_p = counts(counters)
        print(f"fixture wall {time.perf_counter() - t0:.2f} s, launches "
              f"{run_l}, plain {run_p}")
        for s in SUFFIXES:
            if pathlib.Path(f"{out}.{s}").read_bytes() != \
                    (GOLDEN / f"easypredict.{s}").read_bytes():
                raise AssertionError(f"easypredict.{s} differs from golden")
        if min(run_l[k] for k in PAIR_KERNELS) == 0 or any(run_p.values()):
            raise AssertionError("fixture run did not go through the kernels")
        print("fixture: 4 outputs byte-identical to the goldens", flush=True)

        phase("4b easy-predict --prefilter-mode ungapped against the JAX "
              "package's digests")
        reset(torch, counters, driver, prefilter)
        out = td / "ungapped_fixture"
        cli.main(["easy-predict", str(ROOT / "tests" / "data" /
                                      "contigs.fna"),
                  str(ROOT / "tests" / "data" / "proteins.faa"), str(out),
                  "--device", "cuda", "--prefilter-mode", "ungapped"])
        run_l, run_p = counts(counters)
        print(f"ungapped fixture launches {run_l}, plain {run_p}")
        if digests(out) != ungapped["fixture"]["sha256"]:
            raise AssertionError("ungapped fixture digests differ")
        if run_l["gapless_pair"] == 0 or any(run_p.values()):
            raise AssertionError("ungapped fixture run did not go through "
                                 "the gapless kernel")
        meta = ungapped["metagenome"]
        contigs, proteins = make_metagenome(meta["mbp"], meta["targets"],
                                            meta["seed"])
        write_fasta(td / "m.fna", contigs)
        write_fasta(td / "m.faa", proteins)
        reset(torch, counters, driver, prefilter)
        out = td / "ungapped_meta"
        t0 = time.perf_counter()
        EasyPredict(Params(prefilter_mode="ungapped"), device="cuda").run(
            str(td / "m.fna"), str(td / "m.faa"), str(out))
        run_l, run_p = counts(counters)
        print(f"ungapped {meta['mbp']} Mbp wall "
              f"{time.perf_counter() - t0:.2f} s, launches {run_l}, plain "
              f"{run_p}")
        if digests(out) != meta["sha256"]:
            raise AssertionError("ungapped metagenome digests differ")
        if min(run_l[k] for k in UNGAPPED_KERNELS) == 0 or \
                any(run_p.values()):
            raise AssertionError("ungapped metagenome run did not go "
                                 "through the gapless and query-major "
                                 "kernels")
        print("ungapped: fixture and metagenome digests equal "
              "ungapped_slice.json", flush=True)

        phase("4c easy-predict on long frames against the JAX package's "
              "digests")
        long_golden = json.loads((GOLDEN / "long_slice.json").read_text())
        if long_golden["input"] != mls.GOLDEN_INPUT:
            raise AssertionError("long_slice.json was made from another "
                                 "input than make_long_slice.GOLDEN_INPUT")
        contigs, proteins = mls.long_slice(mls.GOLDEN_INPUT)
        write_fasta(td / "g.fna", contigs)
        write_fasta(td / "g.faa", proteins)
        for mode in ("kmer", "ungapped"):
            reset(torch, counters, driver, prefilter)
            out = td / f"long_{mode}"
            t0 = time.perf_counter()
            EasyPredict(Params(prefilter_mode=mode), device="cuda").run(
                str(td / "g.fna"), str(td / "g.faa"), str(out))
            run_l, run_p = counts(counters)
            print(f"long-frame golden, {mode} mode: wall "
                  f"{time.perf_counter() - t0:.2f} s, launches {run_l}, "
                  f"plain {run_p}")
            if digests(out) != long_golden[mode]["sha256"]:
                raise AssertionError(f"long-frame {mode} digests differ")
            if min(run_l[k] for k in RT_KERNELS) == 0 or any(run_p.values()):
                raise AssertionError(f"long-frame {mode} run did not go "
                                     "through the row-tiled kernels")
        print("long frames: k-mer and ungapped digests equal long_slice.json",
              flush=True)

        phase("5 k-mer main path: 1.6 Mbp / 3000-target slice")
        golden = json.loads((GOLDEN / "multichip_slice.json").read_text())
        t0 = time.perf_counter()
        contigs, proteins = make_metagenome(golden["mbp"], golden["targets"])
        write_fasta(td / "c.fna", contigs)
        write_fasta(td / "p.faa", proteins)
        print(f"generated {len(contigs)} contigs, {len(proteins)} targets "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)
        out = td / "slice"
        reset(torch, counters, driver, prefilter)
        t0 = time.perf_counter()
        ep = EasyPredict(device="cuda")
        ep.run(str(td / "c.fna"), str(td / "p.faa"), str(out))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_l, run_p = counts(counters)
        align_s = sum(driver.PHASE_SECONDS.values())
        cells = driver.CELLS["fwd"] + driver.CELLS["rev"]
        print(f"slice wall {wall:.3f} s")
        print("stage seconds " + json.dumps(
            {**ep.predict_stage_seconds, **ep.stage_seconds}))
        print("align phase seconds " + json.dumps(driver.PHASE_SECONDS))
        print(f"cells {json.dumps(driver.CELLS)}; aligned cells/s over the "
              f"align phases {cells / align_s:.4e}")
        print(f"launches {run_l} plain {run_p}", flush=True)
        if digests(out) != golden["sha256"]:
            raise AssertionError("slice digests differ")
        if min(run_l[k] for k in PAIR_KERNELS) == 0 or any(run_p.values()):
            raise AssertionError("main path did not go through the pair "
                                 "kernels")
        for k in PAIR_KERNELS:
            launches[k] = run_l[k]
        print("slice: 4 sha256 digests equal multichip_slice.json",
              flush=True)

        phase("5b ungapped path: 0.4 Mbp / 3000-target slice")
        t0 = time.perf_counter()
        contigs, proteins = make_metagenome(UNGAPPED_SLICE["mbp"],
                                            UNGAPPED_SLICE["targets"],
                                            UNGAPPED_SLICE["seed"])
        write_fasta(td / "u.fna", contigs)
        write_fasta(td / "u.faa", proteins)
        print(f"generated {len(contigs)} contigs, {len(proteins)} targets "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)
        tmp = td / "u_tmp"
        out = td / "u_slice"
        p = Params(prefilter_mode="ungapped")
        reset(torch, counters, driver, prefilter)
        t0 = time.perf_counter()
        ep = EasyPredict(p, device="cuda")
        ep.run(str(td / "u.fna"), str(td / "u.faa"), str(out),
               tmp_dir=str(tmp))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_l, run_p = counts(counters)
        stages = {**ep.predict_stage_seconds, **ep.stage_seconds}
        gap_cells = prefilter.CELLS["gapless"]
        align_s = sum(driver.PHASE_SECONDS.values())
        cells = driver.CELLS["fwd"] + driver.CELLS["rev"]
        pairs = np.load(tmp / "pref_pairs.npy")
        hits_qm = np.load(tmp / "search_hits.npy")
        print(f"ungapped slice wall {wall:.3f} s, {len(pairs)} candidate "
              f"pairs, {len(hits_qm)} hits")
        print("stage seconds " + json.dumps(stages))
        print("align phase seconds (default routing) "
              + json.dumps(driver.PHASE_SECONDS))
        print(f"gapless cells {gap_cells}; gapless cells/s over the "
              f"ungapped prefilter stage "
              f"{gap_cells / stages['ungapped prefilter']:.4e}")
        print(f"cells {json.dumps(driver.CELLS)}; aligned cells/s over the "
              f"align phases {cells / align_s:.4e}")
        print(f"launches {run_l} plain {run_p}", flush=True)
        if min(run_l[k] for k in UNGAPPED_KERNELS) == 0 or \
                any(run_p.values()):
            raise AssertionError("ungapped path did not go through the "
                                 "gapless and query-major kernels")
        for k in UNGAPPED_KERNELS:
            launches[k] = run_l[k]

        # the same pairs through the pair kernels (K1/K2)
        orf_aa = fragments(OrfExtractor(p),
                           SeqDB.from_fasta(str(td / "u.fna"), DBTYPE_NUCL))
        targets = SeqDB.from_fasta(str(td / "u.faa"), DBTYPE_AA)
        reset(torch, counters, driver, prefilter)
        os.environ["METAEUK_QM"] = "off"
        try:
            t0 = time.perf_counter()
            hits_pair = driver.SearchDriver(p, targets, "cuda").search(
                orf_aa, pair_generator=pairs)
            torch.cuda.synchronize()
            pair_wall = time.perf_counter() - t0
        finally:
            del os.environ["METAEUK_QM"]
        run_l, _ = counts(counters)
        print(f"pair-kernel alignment of the same pairs {pair_wall:.3f} s; "
              "align phase seconds (METAEUK_QM=off) "
              + json.dumps(driver.PHASE_SECONDS))
        print(f"launches {run_l}", flush=True)
        same_hits(np, hits_qm, hits_pair, "ungapped slice")

        phase("5c long frames at full width: the ungapped slice plus "
              f"{mls.CHIP_SLICE['n_mid'] + mls.CHIP_SLICE['n_long']} "
              "long-frame contigs")
        t0 = time.perf_counter()
        contigs, proteins = mls.long_slice(mls.CHIP_SLICE)
        write_fasta(td / "l.fna", contigs)
        write_fasta(td / "l.faa", proteins)
        long_contigs = [c for c in contigs if c[0].startswith("long")]
        write_fasta(td / "lo.fna", long_contigs)
        frames = mls.chip_slice_lengths()
        print(f"generated {len(contigs)} contigs ({len(frames)} long frames "
              f"of {min(frames)}-{max(frames)} aa in "
              f"{sum(len(c[1]) for c in long_contigs)} nt of contigs), "
              f"{len(proteins)} targets in {time.perf_counter() - t0:.2f} s",
              flush=True)
        tmp = td / "l_tmp"
        p = Params(prefilter_mode="ungapped")
        reset(torch, counters, driver, prefilter)
        t0 = time.perf_counter()
        ep = EasyPredict(p, device="cuda")
        ep.run(str(td / "l.fna"), str(td / "l.faa"), str(td / "l_slice"),
               tmp_dir=str(tmp))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_l, run_p = counts(counters)
        pairs = np.load(tmp / "pref_pairs.npy")
        hits_qm = np.load(tmp / "search_hits.npy")
        print(f"long-frame slice wall {wall:.3f} s, {len(pairs)} candidate "
              f"pairs, {len(hits_qm)} hits")
        print("stage seconds " + json.dumps(
            {**ep.predict_stage_seconds, **ep.stage_seconds}))
        print("align phase seconds (default routing) "
              + json.dumps(driver.PHASE_SECONDS))
        print(f"gapless cells {prefilter.CELLS['gapless']}; cells "
              f"{json.dumps(driver.CELLS)}")
        print(f"launches {run_l} plain {run_p}", flush=True)
        if min(run_l[k] for k in (*UNGAPPED_KERNELS, *RT_KERNELS)) == 0 \
                or any(run_p.values()):
            raise AssertionError("long-frame slice did not go through the "
                                 "gapless, query-major and row-tiled "
                                 "kernels")
        for k in RT_KERNELS:
            launches[k] = run_l[k]
        orf_aa = fragments(OrfExtractor(p),
                           SeqDB.from_fasta(str(td / "l.fna"), DBTYPE_NUCL))
        lens = np.array([len(a) for a in orf_aa])
        cands = np.bincount(pairs[:, 0], minlength=len(lens))[lens > 4096]
        print(f"{len(cands)} fragments over 4096 aa: {int(cands.sum())} "
              f"candidate pairs, {int(cands.min())}-{int(cands.max())} each",
              flush=True)

        # the same pairs through the pair kernels (K1/K2)
        targets = SeqDB.from_fasta(str(td / "l.faa"), DBTYPE_AA)
        reset(torch, counters, driver, prefilter)
        with pair_kernels_only(driver):
            t0 = time.perf_counter()
            hits_pair = driver.SearchDriver(p, targets, "cuda").search(
                orf_aa, pair_generator=pairs)
            torch.cuda.synchronize()
            pair_wall = time.perf_counter() - t0
        run_l, _ = counts(counters)
        print(f"pair-kernel alignment of the same pairs {pair_wall:.3f} s; "
              "align phase seconds (METAEUK_QM=off, pair launches up to "
              f"{OFF_CELL_BUDGET} cells) " + json.dumps(driver.PHASE_SECONDS))
        print(f"launches {run_l}", flush=True)
        same_hits(np, hits_qm, hits_pair, "long-frame slice")

        # k-mer mode on the long-frame contigs alone, both routings
        hits_k, align_s = {}, {}
        for mode in ("auto", "off"):
            reset(torch, counters, driver, prefilter)
            ctx = pair_kernels_only(driver) if mode == "off" else \
                contextlib.nullcontext()
            with ctx:
                t0 = time.perf_counter()
                EasyPredict(device="cuda").run(
                    str(td / "lo.fna"), str(td / "l.faa"),
                    str(td / f"lk_{mode}"), tmp_dir=str(td / f"lk_{mode}_tmp"))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            run_l, run_p = counts(counters)
            hits_k[mode] = np.load(td / f"lk_{mode}_tmp" / "search_hits.npy")
            align_s[mode] = sum(driver.PHASE_SECONDS.values())
            print(f"long-frame contigs, k-mer mode, METAEUK_QM={mode}: wall "
                  f"{wall:.3f} s, align phases {align_s[mode]:.3f} s "
                  + json.dumps(driver.PHASE_SECONDS))
            print(f"cells {json.dumps(driver.CELLS)}; launches {run_l} "
                  f"plain {run_p}", flush=True)
            if any(run_p.values()) or (mode == "auto" and min(
                    run_l[k] for k in RT_KERNELS) == 0):
                raise AssertionError("k-mer long-frame run did not go "
                                     "through the kernels")
        same_hits(np, hits_k["auto"], hits_k["off"], "k-mer long-frame run")
        if digests(td / "lk_auto") != digests(td / "lk_off"):
            raise AssertionError("k-mer long-frame outputs differ between "
                                 "the routings")

    phase("6 kernel and plain-version times")
    times, same = time_kernels(torch, np, sw_cuda, sw_torch, ungapped_cuda,
                               ungapped_torch, errs)
    rt_times, _ = time_qm_rt(torch, np, sw_cuda, sw_torch, errs)
    times.update(rt_times)
    for k, (ms, plain_ms, bound_ms, by) in times.items():
        print(f"{k}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}); output equal to the plain "
              "version's", flush=True)

    phase("6b the microbenchmark entry points: kbench (T1-T3) and "
          "kernel_variants (T4)")
    t0 = time.perf_counter()
    tool_times, tool_launches, library = run_tools(
        torch, np, kb, kvar, kbench_cuda, kbench_torch, qm_variants_cuda,
        qm_variants_torch, _build)
    times.update(tool_times)
    launches.update(tool_launches)
    print(f"phase 6b: {time.perf_counter() - t0:.2f} s", flush=True)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": f"{CSRC}/{src}",
         "replaces": rep, "launches": launches[k], "max_abs_err": errs[k],
         "ms": times[k][0], "plain_ms": times[k][1],
         "bound_ms": times[k][2], "bound_by": times[k][3],
         "library_ms": library.get(k)}
        for k, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
