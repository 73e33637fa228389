"""Batched translated-fragment -> target-DB search on one torch device.

Counterpart of metaeuk_tpu/search/driver.py SearchDriver.search (phases
1-4): candidate (fragment, target) pairs are grouped by (Lq, Lt) length
tier, gathered on the device from per-tier staged matrices, and aligned by
the kernels of ops/sw_cuda.py: forward ends for every pair, the host
E-value gate, then the reverse-prefix starts for the survivors only. The
hit array is the JAX driver's, field for field.

realign() and backtraces() are the JAX driver's (driver.py:1167, :1273):
realign's alignments run in (Lq, Lt) buckets through ops/sw_cuda.py
sw_align_batch on the driver's device (K1/K2's uncapped instances: the
JAX package's realign runs sw_jax.sw_align_batch, which does not cap H),
and both trace each hit back on the host with the native banded_sw.

Routing (driver.py _qm_mode, _split_qm and the gate of search()): a query
with at least QM_MIN_CANDS candidates in its bucket goes to the query-major
kernels (K3/K4, one query against tiles of TB = 128 target lanes), every
other pair to the pair kernels (K1/K2). A query longer than QM_MAX_LQ goes
to the long-query kernels (K5/K6, the JAX package's row-tiled ones)
whatever its candidate count, unless its target tier is longer than
QM_MAX_LQ too: such pairs take the pair kernels, which take any length (the
JAX driver's XLA scan). METAEUK_QM=off sends every pair to the pair
kernels, METAEUK_QM=force routes by length and candidate count alone, and
the default auto also needs the dense
queries to carry at least max(100 000, pairs / 20) pairs, on every device,
unless a query longer than QM_MAX_LQ is present. There is none of the
TPU-link machinery (device result accumulators, prewarm, fixed launch
shapes, uint16 result packs).

Device fan-out (driver.py n_devices :263 and _dispatcher :278, which
shard_map each launch's pairs or tiles over a 1D "pairs" mesh): the driver
aligns on a list of devices, by default every CUDA device (capped by
METAEUK_DEVICES) or the one device it is given. Each launch chunk is split
into contiguous sub-chunks, one per listed device, each launched on its
device's current stream from tiers staged once per device; the outputs come
back in the chunks' order, so the hit array is the one-device array, field
for field. Nothing is collective. A list may name one device twice.

The jax-free host helpers of the JAX driver module are copied here, because
that module imports jax at the top; each names its origin.
"""

import contextlib
import os
import threading
import time

import numpy as np
import torch

from .. import state
from ..data.submat import (composition_bias_rounded,
                           composition_bias_rounded_batch, encode_aa,
                           scores_with_bias)
from ..ops import sw_cuda
from ..ops.sw_torch import TB
from ..utils import log
from .evalue import EvalueComputation

# copied from metaeuk_tpu/search/driver.py:27 (HIT_DTYPE)
HIT_DTYPE = np.dtype([
    ("orf_idx", np.int64),
    ("target_idx", np.int64),
    ("score_raw", np.int32),
    ("bit_score", np.int32),
    ("seq_id", np.float32),
    ("evalue", np.float64),
    ("q_start", np.int32),
    ("q_end", np.int32),
    ("q_len", np.int32),
    ("t_start", np.int32),
    ("t_end", np.int32),
    ("t_len", np.int32),
])

# aligned-cell accounting over true sequence lengths (copied from
# driver.py:58): forward cells over every candidate pair, reverse-prefix
# cells over E-value survivors
CELLS = {"fwd": 0, "rev": 0}
# wall seconds per search() phase, and of backtraces() (backtraces) and
# realign() (realign_sw, realign_traceback), summed over calls; reset like
# CELLS
PHASE_SECONDS = {}

# DP cells per launch, by device type. A group of 4 to 32 lanes aligns one
# pair (a warp per pair above 256 fragment rows; csrc/sw_pair.cu), so a
# launch of a few thousand short pairs fills an H100; it holds no H/E
# scratch, only a stripe hand-off of 4 B per (pair, column) when the
# fragment tier is wider than 512. The budget dates from a thread per pair
# and stays until a measurement moves it. The plain CPU version holds a
# (B, Lq, 22) int32 profile, so its launches stay small.
CELL_BUDGET = {"cuda": 1 << 32, "cpu": 1 << 27}
MAX_PAIRS_PER_LAUNCH = 1 << 16

# minimum candidate-list length for a query to take the query-major
# kernels (driver.py:143): below this, padding each query's candidates to
# TB = 128 lanes wastes more than the pair kernels cost
QM_MIN_CANDS = int(os.environ.get("METAEUK_QM_MIN", "48"))
# query-major DP cells per launch (tiles * TB * Lq * Lt_pad), by device
# type. A K3/K4 launch runs a group of 4 to 32 lanes per live lane of its
# tiles (csrc/sw_qm.cu), with no H/E scratch, only a stripe hand-off of 4 B
# per (lane, column) when the query tier is wider than 512. The budget
# dates from the scratch of a thread per lane and stays until a
# measurement moves it; the plain CPU version keeps the pair launches'
# budget.
QM_CELL_BUDGET = {"cuda": 1 << 35, "cpu": 1 << 27}
# device memory a K5/K6 launch may hold for its stripe hand-off: 4 B per
# (lane, query row) of a tile, only when the target tier is wider than
# sw_cuda.RT_STRIPE. K5/K6 hold no other scratch (a warp per lane, its
# state in registers), so a launch without the hand-off takes every tile.
RT_STRIPE_BYTES = 1 << 31
# longest query tier of K3/K4 (driver.py:959, sw_pallas.py 2 * QM_TQ);
# longer queries take K5/K6, which take target tiers up to this length too
# (the bound of the Pallas kernels' per-column boundary scratch)
QM_MAX_LQ = 4096


def _qm_mode():
    """Whether the query-major kernels may take dense queries, and whether
    the gate of search() applies (driver.py:149): METAEUK_QM=off disables
    them, force skips the gate, auto (the default) applies it on every
    device."""
    m = os.environ.get("METAEUK_QM", "auto")
    if m == "off":
        return False, False
    return True, m != "force"

# fragment count from which the x2 length tiers are used (driver.py:90)
FINE_TIER_MIN_FRAGS = 400000


def _bucket(n, lo=None):
    """Length buckets (copied from driver.py:61): x2 from 64 up to 1024,
    x4 above; row-count tiers (lo=8) x4."""
    if lo is not None:
        b = lo
        while b < n:
            b *= 4
        return b
    b = 64
    while b < n:
        b *= 2 if b < 1024 else 4
    return b


_LEN_TIERS = np.array([64, 128, 256, 512, 1024, 4096, 16384, 65536,
                       262144], np.int64)
_LEN_TIERS_COARSE = np.array([256, 1024, 4096, 16384, 65536, 262144],
                             np.int64)


def _bucket_arr(lens, fine=True):
    """Vectorized length tier lookup (copied from driver.py:94)."""
    tiers = _LEN_TIERS if fine else _LEN_TIERS_COARSE
    lens = np.maximum(np.asarray(lens, np.int64), 1)
    idx = np.minimum(np.searchsorted(tiers, lens), len(tiers) - 1)
    return tiers[idx]


def pad_rows(seqs, width, dtype=np.int32):
    """Stack variable-length rows into one padded matrix (copied from
    driver.py:104)."""
    n = len(seqs)
    out = np.zeros((n, width), dtype)
    if n == 0:
        return out
    lens = np.fromiter((len(s) for s in seqs), np.int64, n)
    flat = np.concatenate([np.asarray(s) for s in seqs]) if lens.sum() else \
        np.zeros(0, dtype)
    mask = np.arange(width)[None, :] < lens[:, None]
    out[mask] = flat
    return out


def _pad_rows_to(mat, n_rows):
    """Pad a (n, W) matrix with zero rows up to n_rows (copied from
    driver.py:118)."""
    if mat.shape[0] >= n_rows:
        return mat
    return np.pad(mat, ((0, n_rows - mat.shape[0]), (0, 0)))


def estimate_seq_id(score, q_aln_len, t_aln_len):
    """Matcher::estimateSeqIdByScorePerCol, float32 (copied from
    driver.py:125)."""
    m = np.maximum(np.maximum(q_aln_len, t_aln_len), 1).astype(np.float32)
    est = ((score.astype(np.float32) / m).astype(np.float64)
           * 0.1656 + 0.1141).astype(np.float32)
    return np.clip(est, np.float32(0.0), np.float32(1.0))


def _make_qm_tiles(li_sel, lj_sel, pair_rows):
    """Group candidate pairs by staged query row into TB-lane tiles
    (copied from driver.py:452). Returns (qidx (nT,), lj (nT, TB),
    lane_pair (nT, TB)) with -1 lane padding; lane_pair maps lanes back to
    global pair rows."""
    order = np.argsort(li_sel, kind="stable")
    sorted_li = li_sel[order]
    n = len(order)
    starts = np.concatenate([[0], np.flatnonzero(np.diff(sorted_li)) + 1])
    group_of = np.cumsum(np.diff(sorted_li) != 0)
    group_of = np.concatenate([[0], group_of])
    pos = np.arange(n) - starts[group_of]
    tiles_per_group = (np.diff(np.concatenate([starts, [n]]))
                       + TB - 1) // TB
    tile_base = np.concatenate([[0], np.cumsum(tiles_per_group)[:-1]])
    tile = tile_base[group_of] + pos // TB
    lane = pos % TB
    n_tiles = int(tiles_per_group.sum())
    qidx = np.empty(n_tiles, np.int32)
    qidx[tile] = sorted_li
    ljs = np.full((n_tiles, TB), -1, np.int32)
    prs = np.full((n_tiles, TB), -1, np.int64)
    ljs[tile, lane] = lj_sel[order]
    prs[tile, lane] = pair_rows[order]
    return qidx, ljs, prs


def query_tiers_np(orfs_enc, orf_lens, biases, fine):
    """{Lq: dict(q_mat, qb_mat, q_lens, q_remap, nq)} numpy staging of every
    non-empty fragment, as driver.py _query_stage (:524) builds it."""
    lq_of = _bucket_arr(orf_lens, fine)
    tiers = {}
    for Lq in np.unique(lq_of[orf_lens > 0]):
        q_ids = np.flatnonzero((lq_of == Lq) & (orf_lens > 0))
        nq_pad = _bucket(max(len(q_ids), 1), lo=8)
        q_remap = np.zeros(len(orfs_enc), np.int32)
        q_remap[q_ids] = np.arange(len(q_ids), dtype=np.int32)
        tiers[int(Lq)] = dict(
            q_mat=_pad_rows_to(pad_rows([orfs_enc[i] for i in q_ids], Lq,
                                        dtype=np.uint8), nq_pad),
            qb_mat=_pad_rows_to(pad_rows([biases[i] for i in q_ids], Lq,
                                         dtype=np.int8), nq_pad),
            q_lens=np.pad(orf_lens[q_ids].astype(np.int32),
                          (0, nq_pad - len(q_ids))),
            q_remap=q_remap, nq=len(q_ids))
    return tiers


def target_tier_np(targets_enc, target_lens, Lt, fine):
    """dict(t_mat, t_lens, t_remap): numpy staging of every target whose
    length tier is Lt, as driver.py _target_tier (:497) builds it."""
    t_ids = np.flatnonzero(_bucket_arr(target_lens, fine) == Lt)
    nt_pad = _bucket(max(len(t_ids), 1), lo=8)
    t_remap = np.zeros(len(targets_enc), np.int32)
    t_remap[t_ids] = np.arange(len(t_ids), dtype=np.int32)
    return dict(
        t_mat=_pad_rows_to(pad_rows([targets_enc[i] for i in t_ids], Lt,
                                    dtype=np.uint8), nt_pad),
        t_lens=np.pad(target_lens[t_ids].astype(np.int32),
                      (0, nt_pad - len(t_ids))),
        t_remap=t_remap)


def qm_tiles_per_launch(device_type, Lq, Lt, Lt_pad, n_tiles):
    """Tiles per query-major launch of a (Lq, Lt) bucket of n_tiles tiles.
    K3/K4 and every plain version: QM_CELL_BUDGET cells of tiles * TB * Lq
    * Lt_pad (on the card K3/K4 hold TB * Lt words a tile of stripe
    hand-off when Lq > 512, 2^37 / Lq bytes at the budget). K5/K6 on the
    card (Lq > QM_MAX_LQ): every tile, unless the target tier is wider
    than one stripe; then RT_STRIPE_BYTES of stripe hand-off, TB * Lq
    words a tile."""
    if device_type == "cuda" and Lq > QM_MAX_LQ:
        if Lt <= sw_cuda.RT_STRIPE:
            return max(1, n_tiles)
        return max(8, RT_STRIPE_BYTES // (4 * TB * Lq))
    budget = QM_CELL_BUDGET.get(device_type, QM_CELL_BUDGET["cpu"])
    return max(8, budget // (Lq * Lt_pad * TB))


def n_devices():
    """CUDA devices the driver fans its launches over by default:
    torch.cuda.device_count(), capped by METAEUK_DEVICES (driver.py:263).
    Local devices only: across processes the parallel unit is the contig
    partition (parallel/multihost.py)."""
    n = torch.cuda.device_count()
    cap = os.environ.get("METAEUK_DEVICES")
    if cap:
        n = min(n, max(1, int(cap)))
    return n


def device_list(device, devices=None):
    """The devices a SearchDriver on `device` launches on: `devices` if
    given, else cuda:0 .. cuda:n_devices()-1 for "cuda" (no index), else
    [device]."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a SearchDriver needs at least one device")
        return devs
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and n_devices() > 0:
        return [torch.device("cuda", i) for i in range(n_devices())]
    return [device]


def _on(dev):
    """Makes `dev` the current CUDA device (its current stream the one the
    kernels launch on); nothing for a CPU device."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


class SearchDriver:
    """Aligns encoded fragments against an encoded target DB, its launches
    fanned over `devices` (device_list(device, devices))."""

    def __init__(self, params, target_db, device="cuda", devices=None):
        self.params = params
        self.devices = device_list(device, devices)
        self.device = self.devices[0]
        self.scoring = state.default_scoring(self.device)
        self.targets_enc = [encode_aa(target_db.seq_bytes(i))
                            for i in range(len(target_db))]
        self.target_lens = np.array([len(t) for t in self.targets_enc],
                                    np.int64)
        self.evaluer = EvalueComputation(target_db.total_residues(),
                                         gapped=True)
        # per-tier device staging of the whole target set, kept for the
        # driver's lifetime (repeated and pipelined search() calls)
        self._t_stage = {}
        self._q_cache = None
        # tiers staged on self.device, copied to each other listed device:
        # {(tier key, device): (source tier, copy)}
        self._replicas = {}
        self._fine = True
        self._stage_lock = threading.Lock()
        self.phase_seconds = {}

    def _target_tier(self, Lt):
        with self._stage_lock:
            st = self._t_stage.get((Lt, self._fine))
            if st is None:
                st = state.stage_from_numpy(
                    target_tier_np(self.targets_enc, self.target_lens, Lt,
                                   self._fine), self.device)
                log.MemoryTracker.track(
                    f"align staged targets Lt={Lt}",
                    st["t_mat"].numel() + 4 * st["t_lens"].numel())
                self._t_stage[(Lt, self._fine)] = st
        return st

    def _query_stage(self, orf_aa_seqs):
        """(orfs_enc, orf_lens, {Lq: device tier}) for ALL fragments, cached
        across search() calls on the same list (pipelined batches)."""
        with self._stage_lock:
            cache = self._q_cache
            if cache is not None and cache[0] is orf_aa_seqs:
                return cache[1], cache[2], cache[3]
            p = self.params
            orfs_enc = [encode_aa(s) for s in orf_aa_seqs]
            orf_lens = np.array([len(e) for e in orfs_enc], np.int64)
            if p.comp_bias_correction:
                biases = composition_bias_rounded_batch(
                    orfs_enc, p.comp_bias_correction_scale)
            else:
                biases = [np.zeros(len(e), np.int8) for e in orfs_enc]
            # tier policy for this dataset, and for the matching targets
            self._fine = len(orfs_enc) >= FINE_TIER_MIN_FRAGS
            tiers = {}
            for Lq, tier in query_tiers_np(orfs_enc, orf_lens, biases,
                                           self._fine).items():
                tiers[Lq] = state.stage_from_numpy(tier, self.device)
                log.MemoryTracker.track(
                    f"align staged queries Lq={Lq}",
                    2 * tiers[Lq]["q_mat"].numel()
                    + 4 * tiers[Lq]["q_lens"].numel())
            self._q_cache = (orf_aa_seqs, orfs_enc, orf_lens, tiers)
        return orfs_enc, orf_lens, tiers

    def _replica(self, key, st, dev):
        """`st`, a tier staged on self.device, on `dev`: copied there once
        (again only when the source tier changes)."""
        if dev == self.device:
            return st
        with self._stage_lock:
            got = self._replicas.get((key, dev))
            if got is None or got[0] is not st:
                got = (st, {k: v.to(dev) if torch.is_tensor(v) else v
                            for k, v in st.items()})
                self._replicas[(key, dev)] = got
        return got[1]

    def _stages(self, Lq, qt, Lt, tst):
        """[(device, its staged query and target matrices)] for each listed
        device, in list order."""
        out = []
        for dev in self.devices:
            q = self._replica(("q", Lq), qt, dev)
            t = self._replica(("t", Lt, self._fine), tst, dev)
            out.append((dev, dict(
                q_mat=q["q_mat"], qb_mat=q["qb_mat"], q_lens=q["q_lens"],
                t_mat=t["t_mat"], t_lens=t["t_lens"],
                scoring=state.default_scoring(dev))))
        return out

    def _pairs_per_launch(self, Lq, Lt):
        budget = CELL_BUDGET.get(self.device.type, CELL_BUDGET["cpu"])
        return max(8, min(budget // (Lq * Lt), MAX_PAIRS_PER_LAUNCH))

    def _launch_chunks(self, ctx, rows, oi, ti, ends):
        """Split each chunk of `rows` into one contiguous sub-chunk per
        listed device, gather it on its device and launch the forward
        kernel (ends None) or the reverse one (ends = host (qe, te) arrays)
        there; yields (rows sub-chunk, device outputs)."""
        cap = self._pairs_per_launch(ctx["Lq"], ctx["Lt"])
        stages = ctx["stage"]
        for s in range(0, len(rows), cap):
            for r, (dev, st) in zip(
                    np.array_split(rows[s:s + cap], len(stages)), stages):
                if not len(r):
                    continue
                with _on(dev):
                    li = torch.from_numpy(
                        ctx["q_remap"][oi[r]].astype(np.int64)).to(dev)
                    lj = torch.from_numpy(
                        ctx["t_remap"][ti[r]].astype(np.int64)).to(dev)
                    args = (st["q_mat"][li], st["qb_mat"][li],
                            st["q_lens"][li], st["t_mat"][lj],
                            st["t_lens"][lj])
                    if ends is None:
                        outs = sw_cuda.sw_ends(*args, scoring=st["scoring"])
                    else:
                        qe = torch.from_numpy(ends[0][r]).to(dev)
                        te = torch.from_numpy(ends[1][r]).to(dev)
                        outs = sw_cuda.sw_starts(*args, qe, te,
                                                 scoring=st["scoring"])
                yield r, outs

    def _split_qm(self, ctx, rows, li_rows, qm_on):
        """Route each candidate pair to the query-major kernels (queries with
        >= QM_MIN_CANDS candidates in this bucket) or the pair kernels
        (driver.py:950-968). Returns (qm_rows, pair_rows). A bucket of
        queries longer than QM_MAX_LQ goes to K5/K6 whole, or to the pair
        kernels whole if its target tier is longer too."""
        if not qm_on or not len(rows):
            return rows[:0], rows
        if ctx["Lq"] > QM_MAX_LQ:
            if ctx["Lt"] <= QM_MAX_LQ:
                return rows, rows[:0]
            log.warning(f"SW bucket Lq={ctx['Lq']} Lt={ctx['Lt']}: both axes "
                        "exceed the long-query kernels' bounds; using the "
                        "pair kernels")
            return rows[:0], rows
        counts = np.bincount(li_rows, minlength=ctx["nq"])
        m = counts[li_rows] >= QM_MIN_CANDS
        return rows[m], rows[~m]

    def _qm_chunks(self, ctx, rows, oi, ti, ends):
        """Tile `rows` by query (driver.py _submit_qm :1028) and launch the
        query-major forward kernel (ends None) or the reverse one (ends =
        host (qe, te) arrays), K5/K6 for queries longer than QM_MAX_LQ
        (sw_pallas.py _align_ends_qm :814, _align_starts_qm :832); yields
        (lane -> pair row map, -1 on padding lanes; device outputs) per
        contiguous sub-chunk of tiles, one per listed device in each chunk."""
        if not len(rows):
            return
        Lq, Lt = ctx["Lq"], ctx["Lt"]
        Lt_pad = Lt if Lt <= 512 else ((Lt + 511) // 512) * 512
        qidx, ljt, lane_pair = _make_qm_tiles(
            ctx["q_remap"][oi[rows]], ctx["t_remap"][ti[rows]], rows)
        cap = qm_tiles_per_launch(self.device.type, Lq, Lt, Lt_pad,
                                  len(qidx))
        if Lq > QM_MAX_LQ:
            fwd, rev = sw_cuda.qm_ends_rt, sw_cuda.qm_starts_rt
        else:
            fwd, rev = sw_cuda.qm_ends, sw_cuda.qm_starts
        stages = ctx["stage"]
        for s in range(0, len(qidx), cap):
            tiles = np.arange(s, min(s + cap, len(qidx)))
            for tl, (dev, st) in zip(np.array_split(tiles, len(stages)),
                                     stages):
                if not len(tl):
                    continue
                a, b = int(tl[0]), int(tl[-1]) + 1
                lanes = lane_pair[a:b].reshape(-1)
                with _on(dev):
                    args = (st["q_mat"], st["qb_mat"], st["q_lens"],
                            st["t_mat"], st["t_lens"],
                            torch.from_numpy(qidx[a:b]).to(dev),
                            torch.from_numpy(ljt[a:b].reshape(-1)).to(dev))
                    if ends is None:
                        outs = fwd(*args, scoring=st["scoring"])
                    else:
                        ok = lanes >= 0
                        qe = np.zeros(len(lanes), np.int32)
                        te = np.zeros(len(lanes), np.int32)
                        qe[ok] = ends[0][lanes[ok]]
                        te[ok] = ends[1][lanes[ok]]
                        outs = rev(*args, torch.from_numpy(qe).to(dev),
                                   torch.from_numpy(te).to(dev),
                                   scoring=st["scoring"])
                yield lanes, outs

    @staticmethod
    def _fetch(parts, which):
        """Concatenate output `which[k]` of every part on its device and copy
        it to the host in one transfer per device, then put the parts back
        in their order; drop padding lanes (row -1): (rows, [np.int32 array
        per k])."""
        rows = np.concatenate([r for r, _ in parts])
        by_dev = {}
        for i, (_, o) in enumerate(parts):
            by_dev.setdefault(o[0].device, []).append(i)
        outs = []
        for k in which:
            got = [None] * len(parts)
            for idx in by_dev.values():
                flat = torch.cat([parts[i][1][k] for i in idx]).cpu().numpy()
                ends = np.cumsum([len(parts[i][1][k]) for i in idx])[:-1]
                for i, piece in zip(idx, np.split(flat, ends)):
                    got[i] = piece
            outs.append(np.concatenate(got))
        ok = rows >= 0
        return rows[ok], [o[ok] for o in outs]

    def search(self, orf_aa_seqs, pair_generator=None):
        """Align fragments; returns a HIT_DTYPE array sorted per fragment.

        orf_aa_seqs: list of AA byte strings (translated fragments).
        pair_generator: optional iterable of (orf_idx, target_idx) candidate
          pairs; None = exhaustive.
        """
        p = self.params
        orfs_enc, orf_lens, q_tiers = self._query_stage(orf_aa_seqs)
        n_orfs = len(orfs_enc)
        n_targets = len(self.targets_enc)
        if pair_generator is None:
            oi = np.repeat(np.arange(n_orfs, dtype=np.int64), n_targets)
            ti = np.tile(np.arange(n_targets, dtype=np.int64), n_orfs)
        else:
            pairs = pair_generator if isinstance(pair_generator, np.ndarray) \
                else np.asarray(list(pair_generator), dtype=np.int64)
            if len(pairs) == 0:
                return np.zeros(0, dtype=HIT_DTYPE)
            oi = pairs[:, 0].astype(np.int64)
            ti = pairs[:, 1].astype(np.int64)
        # drop pairs with empty sequences
        keep = (orf_lens[oi] > 0) & (self.target_lens[ti] > 0)
        oi, ti = oi[keep], ti[keep]
        if len(oi) == 0:
            return np.zeros(0, dtype=HIT_DTYPE)

        phase_s = {}
        t_last = time.perf_counter()

        def mark(name):
            nonlocal t_last
            t = time.perf_counter()
            phase_s[name] = phase_s.get(name, 0.0) + (t - t_last)
            t_last = t

        lq_b = _bucket_arr(orf_lens, self._fine)[oi]
        lt_b = _bucket_arr(self.target_lens, self._fine)[ti]
        n_pairs = len(oi)
        qm_on, gated = _qm_mode()
        if qm_on and gated:
            # the query-major path pays only when a meaningful share of the
            # pairs belongs to dense-candidate queries (driver.py:710-720);
            # a query longer than QM_MAX_LQ keeps it open for the long-query
            # kernels
            cand_counts = np.bincount(oi, minlength=n_orfs)
            qm_share = int(cand_counts[cand_counts >= QM_MIN_CANDS].sum())
            if qm_share < max(100_000, n_pairs // 20) \
                    and int(lq_b.max()) <= QM_MAX_LQ:
                qm_on = False
        mark("prep")

        # ---- phase 1: forward ends for every pair, bucket by bucket ----
        prog = log.progress(n_pairs, "align submit")
        buckets, fwd_parts = [], []
        for Lq, Lt in sorted(set(zip(lq_b.tolist(), lt_b.tolist()))):
            sel = np.flatnonzero((lq_b == Lq) & (lt_b == Lt))
            qt, tst = q_tiers[int(Lq)], self._target_tier(Lt)
            ctx = dict(Lq=Lq, Lt=Lt, sel=sel, q_remap=qt["q_remap"],
                       nq=qt["nq"], t_remap=tst["t_remap"],
                       stage=self._stages(int(Lq), qt, Lt, tst))
            buckets.append(ctx)
            qm_rows, pair_rows = self._split_qm(
                ctx, sel, qt["q_remap"][oi[sel]], qm_on)
            for r, outs in self._launch_chunks(ctx, pair_rows, oi, ti, None):
                fwd_parts.append((r, outs))
                prog.update(len(r))
            for lanes, outs in self._qm_chunks(ctx, qm_rows, oi, ti, None):
                fwd_parts.append((lanes, outs))
                prog.update(int((lanes >= 0).sum()))
        prog.finish()
        mark("fwd_submit")

        # ---- phase 2: fetch forward results ----
        rows, (sc, qe, te) = self._fetch(fwd_parts, (0, 1, 2))
        mark("fwd_fetch")
        score_all = np.zeros(n_pairs, np.int32)
        qe_all = np.zeros(n_pairs, np.int32)
        te_all = np.full(n_pairs, -1, np.int32)
        score_all[rows], qe_all[rows], te_all[rows] = sc, qe, te
        mark("fwd_assemble")

        # ---- phase 3: E-value gate on host (exact float64 semantics) ----
        q_len_pairs = orf_lens[oi]
        cutoffs = self._gate_cutoffs(q_len_pairs, p.search_evalue_thr)
        if cutoffs is not None:
            surv = (score_all > 0) & (score_all >= cutoffs)
        else:  # monotonicity verification failed: dense gate
            ev_gate = self.evaluer.compute_evalue(
                score_all.astype(np.float64),
                q_len_pairs.astype(np.float64))
            surv = (score_all > 0) & (ev_gate <= p.search_evalue_thr)
        surv &= te_all >= 0
        CELLS["fwd"] += int((q_len_pairs.astype(np.int64)
                             * self.target_lens[ti]).sum())
        CELLS["rev"] += int(((qe_all[surv].astype(np.int64) + 1)
                             * (te_all[surv].astype(np.int64) + 1)).sum())
        mark("gate")

        # ---- phase 4: reverse pass on survivors only ----
        qs_all = np.full(n_pairs, -1, np.int32)
        ts_all = np.full(n_pairs, -1, np.int32)
        rev_parts = []
        for ctx in buckets:
            rows_s = ctx["sel"][surv[ctx["sel"]]]
            qm_rows, pair_rows = self._split_qm(
                ctx, rows_s, ctx["q_remap"][oi[rows_s]], qm_on)
            rev_parts.extend(self._launch_chunks(ctx, pair_rows, oi, ti,
                                                 (qe_all, te_all)))
            rev_parts.extend(self._qm_chunks(ctx, qm_rows, oi, ti,
                                             (qe_all, te_all)))
        mark("rev_submit")
        if rev_parts:
            rows, (qs, ts) = self._fetch(rev_parts, (1, 2))
            qs_all[rows], ts_all[rows] = qs, ts
        mark("rev_fetch")

        # compact to gate survivors before scoring and sorting
        keep_rows = np.flatnonzero(surv)
        hits = np.zeros(len(keep_rows), dtype=HIT_DTYPE)
        hits["orf_idx"] = oi[keep_rows]
        hits["target_idx"] = ti[keep_rows]
        hits["score_raw"] = score_all[keep_rows]
        hits["q_start"], hits["q_end"] = qs_all[keep_rows], qe_all[keep_rows]
        hits["q_len"] = q_len_pairs[keep_rows]
        hits["t_start"], hits["t_end"] = ts_all[keep_rows], te_all[keep_rows]
        hits["t_len"] = self.target_lens[ti[keep_rows]]
        ev_surv = self.evaluer.compute_evalue(
            score_all[keep_rows].astype(np.float64),
            q_len_pairs[keep_rows].astype(np.float64))
        out = self._filter_and_sort(hits, evalue=ev_surv)
        mark("filter_sort")
        self.phase_seconds = phase_s
        for k, v in phase_s.items():
            PHASE_SECONDS[k] = PHASE_SECONDS.get(k, 0.0) + v
        log.info("align phases: " + "  ".join(
            f"{k}={v:.2f}s" for k, v in phase_s.items())
            + f"  pairs={n_pairs} surv={int(surv.sum())}")
        return out

    def _gate_cutoffs(self, q_len_pairs, thr):
        """Per-pair minimal passing raw score for the E-value gate, via
        per-distinct-qlen bisection over the exact evalue function (copied
        from driver.py:1078, without its METAEUK_GATE_CUTOFF switch). None
        if the boundary verification fails for any length (the caller then
        gates densely)."""
        cache = getattr(self, "_gate_cut_cache", None)
        if cache is None or cache[0] != thr:
            cache = (thr, {})
            self._gate_cut_cache = cache
        cut = cache[1]
        uniq = np.unique(q_len_pairs)
        ev = self.evaluer
        for L in uniq:
            L = int(L)
            if L in cut:
                continue
            fL = float(L)

            def e(s):
                return float(ev.compute_evalue(np.float64(s),
                                               np.float64(fL)))
            hi = 1
            while e(hi) > thr and hi < (1 << 22):
                hi <<= 1
            lo = 0   # e(lo) > thr invariant (score 0 rows never survive)
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if e(mid) <= thr:
                    hi = mid
                else:
                    lo = mid
            # boundary verification of monotonicity
            if e(hi) > thr or (hi > 1 and e(hi - 1) <= thr):
                return None
            cut[L] = hi
        lut_len = int(uniq[-1]) + 1 if len(uniq) else 1
        lut = getattr(self, "_gate_cut_lut", None)
        if lut is None or lut[0] != thr or lut[2] != len(cut) \
                or len(lut[1]) < lut_len:
            arr = np.full(max(lut_len, max(cut, default=1) + 1, 2),
                          np.iinfo(np.int32).max, np.int32)
            for L, s in cut.items():
                arr[L] = s
            self._gate_cut_lut = (thr, arr, len(cut))
            lut = self._gate_cut_lut
        return lut[1][q_len_pairs]

    def _filter_and_sort(self, hits, evalue=None):
        """Alignment::checkCriteria and Matcher::compareHits order (copied
        from driver.py:1128)."""
        p = self.params
        ev = self.evaluer
        score = hits["score_raw"].astype(np.float64)
        hits["evalue"] = evalue if evalue is not None else \
            ev.compute_evalue(score, hits["q_len"].astype(np.float64))
        hits["bit_score"] = ev.compute_bit_score_int(score)
        q_aln = np.maximum(hits["q_end"] - hits["q_start"], 1)
        t_aln = np.maximum(hits["t_end"] - hits["t_start"], 1)
        hits["seq_id"] = estimate_seq_id(hits["score_raw"], q_aln, t_aln)

        aligned = (hits["t_end"] >= 0) & (hits["score_raw"] > 0) \
            & (hits["t_start"] >= 0)
        aln_len = np.maximum(np.abs(hits["q_end"] - hits["q_start"]),
                             np.abs(hits["t_end"] - hits["t_start"])) + 1
        q_cov = (np.abs(hits["q_end"] - hits["q_start"]) + 1) \
            / np.maximum(hits["q_len"], 1)
        t_cov = (np.abs(hits["t_end"] - hits["t_start"]) + 1) \
            / np.maximum(hits["t_len"], 1)
        if p.cov_mode == 1:  # COV_MODE_TARGET
            has_cov = t_cov >= p.cov_thr
        elif p.cov_mode == 2:  # COV_MODE_QUERY
            has_cov = q_cov >= p.cov_thr
        else:
            has_cov = (q_cov >= p.cov_thr) & (t_cov >= p.cov_thr)
        ok = (aligned
              & (hits["evalue"] <= p.search_evalue_thr)
              & (hits["seq_id"] >= p.seq_id_thr)
              & has_cov
              & (aln_len >= p.aln_len_thr))
        hits = hits[ok]
        # evalue asc, score desc, dbLen asc, dbKey asc; grouped by orf
        order = np.lexsort((hits["target_idx"], hits["t_len"],
                            -hits["bit_score"], hits["evalue"],
                            hits["orf_idx"]))
        return hits[order]

    def realign(self, hits, orf_aa_seqs, realign_score_bias=-0.2,
                realign_max_seqs=None, realign_cov=0.0, cov_mode=0):
        """--realign pass (Alignment.cpp:298-446; copied from driver.py:1167):
        recompute alignment boundaries and backtraces with the
        scoreBias-shifted matrix (default -0.2); scores and E-values keep
        the first-pass values, and composition bias is recomputed with the
        realign matrix. The realign alignments run bucket by bucket, in
        launches of at most _pairs_per_launch pairs, through
        sw_cuda.sw_align_batch on the driver's device.

        Returns (hits_out, backtraces, seq_ids): coords replaced by the
        realign pass; rows dropped only by the realign coverage gate,
        and per query at most realign_max_seqs rows survive."""
        native = _traceback_native()

        p = self.params
        t0 = time.perf_counter()
        sub = scores_with_bias(2.0, realign_score_bias)
        enc_cache = {}

        def q_arrays(oi):
            if oi not in enc_cache:
                e = encode_aa(orf_aa_seqs[oi])
                b = composition_bias_rounded(
                    e, p.comp_bias_correction_scale, scores=sub) \
                    if p.comp_bias_correction else np.zeros(len(e), np.int8)
                enc_cache[oi] = (e, b)
            return enc_cache[oi]

        n = len(hits)
        score2 = np.zeros(n, np.int32)
        qs2 = np.zeros(n, np.int32)
        qe2 = np.zeros(n, np.int32)
        ts2 = np.zeros(n, np.int32)
        te2 = np.zeros(n, np.int32)
        # bucket hit pairs and realign in dense batches
        ol = np.array([len(q_arrays(int(h["orf_idx"]))[0]) for h in hits],
                      np.int64)
        tl = hits["t_len"].astype(np.int64)
        lq_b = np.array([_bucket(max(l, 1)) for l in ol])
        lt_b = np.array([_bucket(max(l, 1)) for l in tl])
        for (Lq, Lt) in sorted(set(zip(lq_b.tolist(), lt_b.tolist()))):
            sel_all = np.flatnonzero((lq_b == Lq) & (lt_b == Lt))
            step = self._pairs_per_launch(Lq, Lt)
            for s in range(0, len(sel_all), step):
                sel = sel_all[s:s + step]
                qm = pad_rows([q_arrays(int(hits[i]["orf_idx"]))[0]
                               for i in sel], Lq)
                qb = pad_rows([q_arrays(int(hits[i]["orf_idx"]))[1]
                               for i in sel], Lq)
                tm = pad_rows([self.targets_enc[int(hits[i]["target_idx"])]
                               for i in sel], Lt)
                sc, qs, qe, ts, te = sw_cuda.sw_align_batch(
                    qm, qb, ol[sel].astype(np.int32), tm,
                    tl[sel].astype(np.int32), submat=sub,
                    device=self.device)
                score2[sel], qs2[sel], qe2[sel] = sc, qs, qe
                ts2[sel], te2[sel] = ts, te
        t1 = time.perf_counter()

        keep = np.zeros(n, bool)
        bts, seq_ids = [], []
        per_query = {}
        cap = realign_max_seqs if realign_max_seqs is not None else 1 << 62
        for i in range(n):
            oi = int(hits[i]["orf_idx"])
            if per_query.get(oi, 0) >= cap:
                continue
            if score2[i] <= 0 or te2[i] < 0:
                continue
            q_cov = (abs(int(qe2[i]) - int(qs2[i])) + 1) / max(int(ol[i]), 1)
            t_cov = (abs(int(te2[i]) - int(ts2[i])) + 1) / max(int(tl[i]), 1)
            if cov_mode == 1:  # COV_MODE_TARGET
                cov_ok = t_cov >= realign_cov
            elif cov_mode == 2:  # COV_MODE_QUERY
                cov_ok = q_cov >= realign_cov
            else:
                cov_ok = q_cov >= realign_cov and t_cov >= realign_cov
            if not cov_ok:
                continue
            per_query[oi] = per_query.get(oi, 0) + 1
            keep[i] = True
            q_enc, q_bias = q_arrays(oi)
            t_enc = self.targets_enc[int(hits[i]["target_idx"])]
            qs, qe = int(qs2[i]), int(qe2[i])
            ts, te = int(ts2[i]), int(te2[i])
            band = abs((te - ts + 1) - (qe - qs + 1)) + 1
            bt = native.banded_sw_traceback(
                q_enc[qs:qe + 1], q_bias[qs:qe + 1], t_enc[ts:te + 1],
                int(score2[i]), band, p.gap_open, p.gap_extend, submat=sub)
            if bt is None:
                bt = ""
            bts.append(bt)
            seq_ids.append(_traceback_seq_id(bt, q_enc, qs, t_enc, ts))
        out = hits[keep].copy()
        out["q_start"], out["q_end"] = qs2[keep], qe2[keep]
        out["t_start"], out["t_end"] = ts2[keep], te2[keep]
        t2 = time.perf_counter()
        for k, v in (("realign_sw", t1 - t0), ("realign_traceback", t2 - t1)):
            PHASE_SECONDS[k] = PHASE_SECONDS.get(k, 0.0) + v
        return out, bts, np.asarray(seq_ids, np.float32)

    def backtraces(self, hits, orf_aa_seqs):
        """M/I/D backtraces + exact seqIds for accepted hits, the
        reference's alignment-mode-3 path (banded_sw on the alignment
        window + computeBacktrace, StripedSmithWaterman.cpp:498-581; copied
        from driver.py:1273). Returns (list[str], float32 seqIds by
        alnLen)."""
        native = _traceback_native()

        p = self.params
        t0 = time.perf_counter()
        enc_cache = {}
        bts = []
        seq_ids = np.zeros(len(hits), np.float32)
        for idx, h in enumerate(hits):
            oi = int(h["orf_idx"])
            if oi not in enc_cache:
                e = encode_aa(orf_aa_seqs[oi])
                b = composition_bias_rounded(e, p.comp_bias_correction_scale) \
                    if p.comp_bias_correction else np.zeros(len(e), np.int8)
                enc_cache[oi] = (e, b)
            q_enc, q_bias = enc_cache[oi]
            t_enc = self.targets_enc[int(h["target_idx"])]
            qs, qe = int(h["q_start"]), int(h["q_end"])
            ts, te = int(h["t_start"]), int(h["t_end"])
            band = abs((te - ts + 1) - (qe - qs + 1)) + 1
            bt = native.banded_sw_traceback(
                q_enc[qs:qe + 1], q_bias[qs:qe + 1], t_enc[ts:te + 1],
                int(h["score_raw"]), band, p.gap_open, p.gap_extend)
            if bt is None:
                bt = ""
            bts.append(bt)
            seq_ids[idx] = _traceback_seq_id(bt, q_enc, qs, t_enc, ts)
        PHASE_SECONDS["backtraces"] = PHASE_SECONDS.get("backtraces", 0.0) \
            + time.perf_counter() - t0
        return bts, seq_ids


def _traceback_native():
    """The native module once its library has loaded; raises otherwise, since
    banded_sw_traceback would give every hit an empty backtrace."""
    from .. import native

    if native.get_lib() is None:
        raise RuntimeError("the native host library did not build or load "
                           "(native.get_lib()); backtraces need its "
                           "banded_sw_traceback")
    return native


def _traceback_seq_id(bt, q_enc, qs, t_enc, ts):
    """Identities over the alignment length of backtrace bt from (qs, ts),
    float32; 0 for an empty backtrace (the loop of driver.py:1240 and
    :1302)."""
    if not bt:
        return np.float32(0.0)
    qp, tp, ids = qs, ts, 0
    for op in bt:
        if op == "M":
            ids += int(q_enc[qp] == t_enc[tp])
            qp += 1
            tp += 1
        elif op == "I":
            qp += 1
        else:
            tp += 1
    return np.float32(ids) / np.float32(len(bt))
