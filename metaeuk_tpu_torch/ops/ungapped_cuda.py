"""Gapless diagonal scores: the wrapper over the CUDA kernels in
csrc/gapless.cu, dispatched by the device of the tensors given.

- A CPU tensor goes to the plain PyTorch version (ops/ungapped_torch.py).
- A CUDA tensor launches a kernel, or raises. There is no fallback.
- gapless_scores_cross scores staged query rows r0..r1 against every staged
  target (the ungapped prefilter's launches); the staged query width Lq
  picks the kernel (kernel_for(Lq, cross=True)): gapless_rows below
  LONG_ROWS, gapless_long, a block per (pair, chunk of 256 diagonals), from
  LONG_ROWS up.
- gapless_rows gives a thread one target and a pair of query rows
  (row_pairs: the launch's rows sorted by length on the device, neighbours
  paired, an odd last row with an absent one), a block a group of pairs and
  a tile of targets, each pair's profile staged once in shared memory with
  the two rows' entries in the halves of one 32-bit word. Both rows' runs of
  a diagonal advance in one packed 16 x 2 DPX op wherever 16 bits provably
  hold: the kernel sums each row's largest entries, max(0, max_a S(i, a))
  over its rows, a bound on any of its runs, and a pair whose bounds are
  both at most 32767 takes the packed loop; any other pair runs the same
  walk in int32. Every score is the int32 recurrence's. What bounds it now:
  the dispatch of under two instructions a cell (one row a thread took
  four), then half a shared load a cell.
- gapless_scores_gathered scores arbitrary pairs (li, lj): gapless_pair
  below LONG_ROWS, the int32 band loop, one query row a thread, on a work
  list (pair_plan: the pairs sorted by query on the device and cut into
  groups of a query, each group's profile staged once in shared memory;
  pair_layout: a small launch deals each pair's bands over several
  threads); gapless_long from LONG_ROWS up. All three kernels compute the
  same function.

Counterparts in the JAX package (metaeuk_tpu/ops/ungapped.py):
gapless_scores_gathered is gapless_scores_gathered / gapless_gathered_jit
over gapless_scores_pallas (K7, _gapless_kernel, with _build_S), and
gapless_scores is gapless_scores on a per-pair batch. Per pair, the best of
D(i,j) = max(0, D(i-1,j-1) + S(i,j)) over rows < q_len and columns < t_len,
floored at 0, with S = blosum62[q_i, t_j] + bias_i. Batches need no padding.

LAUNCHES counts kernel launches and PLAIN_CALLS calls that went to the plain
version, each under the kernel the route picked; ROW_LANES counts the query
rows gapless_rows scored in packed 16-bit lanes and in int32, counted on the
device and added in by fold_row_lanes() (search/prefilter.py calls it at its
copy back). reset_counts() sets all three to zero.
"""

import ctypes
import functools

import torch

from . import _build, ungapped_torch
from .sw_cuda import check_scores_fit
from ..state import default_scoring

KERNELS = ("gapless_pair", "gapless_long", "gapless_rows")
# staged query widths from which a launch goes to gapless_long (fragments
# over 512 aa): on the card it beats gapless_pair at every prefilter bucket
# from 1024 up (tools/torch_gapless_rows.py, PERF.md)
LONG_ROWS = 1024
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
# gapless_long: submat, alph, q, qb, q_lens, nq, Lq, t, t_lens, nt, Lt, li,
# lj, B, out, stream
_LONG_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P,
                  ctypes.c_longlong, _P, _P]
# gapless_rows: submat, alph, q, qb, q_lens, nq, Lq, t_words, t_lens, nt,
# Lt, order, r0, rows, pair_rows, out, row_counts, stream
_ROWS_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _I, _I,
                  _P, _P, _P, _P]
# gapless_pair: submat, alph, q, qb, q_lens, nq, Lq, t_words, t_lens, rank,
# nt, Lt, lj, perm, grp_q, grp_p0, grp_n, n_groups, c, split, out, stream
_PAIR_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _P, _P,
                  _P, _P, _P, _I, _I, _I, _P, _P]
_ARGTYPES = {"gapless_long": _LONG_ARGTYPES, "gapless_rows": _ROWS_ARGTYPES,
             "gapless_pair": _PAIR_ARGTYPES}
# gapless_pair's blocks (csrc/gapless.cu kPairThreads): threads, the profile
# bytes a block aims at, and the most its profiles may take (shared memory);
# the threads a launch aims at (about 132 SMs x 2048), which its pairs'
# bands are dealt over when it has fewer pairs
PAIR_THREADS = 128
PAIR_PROF_BYTES = 48 * 1024
PAIR_PROF_BYTES_MAX = 200 * 1024
PAIR_LAUNCH_THREADS = 1 << 18
# gapless_rows's query rows by the lanes that scored them, summed over
# launches once fold_row_lanes() has run; the kernel adds to a (2,) int64
# tensor a device (packed, int32), so a launch syncs nothing
ROW_LANES = {"packed": 0, "int32": 0}
_ROW_LANES_DEV = {}


def reset_counts():
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0
    for k in ROW_LANES:
        ROW_LANES[k] = 0
    for counts in _ROW_LANES_DEV.values():
        counts.zero_()


def _row_lanes_dev(device):
    if device not in _ROW_LANES_DEV:
        _ROW_LANES_DEV[device] = torch.zeros(2, dtype=torch.int64,
                                             device=device)
    return _ROW_LANES_DEV[device]


def fold_row_lanes():
    """Adds the devices' counts of gapless_rows's query rows into
    ROW_LANES and zeroes them: a copy back, so it waits for the launches
    before it (call it where the caller syncs anyway)."""
    for counts in _ROW_LANES_DEV.values():
        packed, wide = counts.tolist()
        ROW_LANES["packed"] += packed
        ROW_LANES["int32"] += wide
        counts.zero_()


@functools.lru_cache(maxsize=None)
def _kernel(name):
    fn = getattr(_build.load("gapless"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def kernel_for(Lq, cross=False):
    """The kernel that scores a launch of staged query width Lq: of
    arbitrary pairs, or with cross, of a cross product."""
    if Lq >= LONG_ROWS:
        return "gapless_long"
    return "gapless_rows" if cross else "gapless_pair"


def _cross_pairs(r0, r1, nt, device):
    """(li, lj) of query rows r0..r1 against targets 0..nt, row-major."""
    flat = torch.arange((r1 - r0) * nt, device=device)
    return ((r0 + flat // nt).to(torch.int32),
            (flat % nt).to(torch.int32))


def gapless_scores_cross(q_mat, qb_mat, q_lens, t_mat, t_lens, r0, r1,
                         scoring=None):
    """(r1 - r0, nt) int32 best gapless diagonal scores of staged query rows
    r0..r1 against every staged target. q_mat, qb_mat: (nq, Lq) codes and
    biases; t_mat: (nt, Lt) codes."""
    scoring = scoring or default_scoring(q_mat.device)
    name = kernel_for(q_mat.shape[1], cross=True)
    _check_rows(q_mat, r0, r1)
    if q_mat.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        li, lj = _cross_pairs(r0, r1, t_mat.shape[0], q_mat.device)
        return ungapped_torch.gapless_gathered(
            q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj,
            scoring=scoring).view(r1 - r0, t_mat.shape[0])
    return launch_cross(name, q_mat, qb_mat, q_lens, t_mat, t_lens, r0, r1,
                        scoring=scoring)


def launch_cross(name, q_mat, qb_mat, q_lens, t_mat, t_lens, r0, r1,
                 scoring=None):
    """gapless_scores_cross on kernel `name` (one of KERNELS), whatever
    kernel_for would pick: CUDA tensors only."""
    nt = t_mat.shape[0]
    _check_rows(q_mat, r0, r1)
    if name != "gapless_rows":
        li, lj = _cross_pairs(r0, r1, nt, q_mat.device)
        return launch(name, q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj,
                      scoring=scoring).view(r1 - r0, nt)
    scoring = scoring or default_scoring(q_mat.device)
    sub, alph = _checked(name, q_mat, qb_mat, q_lens, t_mat, t_lens,
                         scoring)
    (nq, Lq), Lt = q_mat.shape, t_mat.shape[1]
    best = torch.empty((r1 - r0, nt), dtype=torch.int32, device=q_mat.device)
    if best.numel() == 0:
        return best
    tl = t_lens.to(torch.int32).contiguous()
    words, order = target_words(t_mat, tl, alph)
    q = q_mat.to(torch.uint8).contiguous()
    qb = qb_mat.to(torch.int8).contiguous()
    ql = q_lens.to(torch.int32).contiguous()
    pair_rows = row_pairs(ql, r0, r1)
    rc = _kernel(name)(sub.data_ptr(), alph, q.data_ptr(), qb.data_ptr(),
                       ql.data_ptr(), nq, Lq, words.data_ptr(), tl.data_ptr(),
                       nt, Lt, order.data_ptr(), r0, r1 - r0,
                       pair_rows.data_ptr(), best.data_ptr(),
                       _row_lanes_dev(q.device).data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return best


def row_pairs(q_lens, r0, r1):
    """gapless_rows's pairs of query rows r0..r1, on q_lens's device with
    no host sync: a (2 * ceil((r1 - r0) / 2),) int32 tensor of row offsets
    from r0, entries 2k and 2k + 1 a pair, the rows in order of length
    (ties by index) so that a pair's lengths are neighbours, each row once,
    and -1 (an absent row) beside the longest when the count is odd."""
    order = torch.argsort(q_lens[r0:r1], stable=True).to(torch.int32)
    if (r1 - r0) % 2:
        order = torch.cat([order, order.new_full((1,), -1)])
    return order


def target_words(t_mat, t_lens, alph):
    """gapless_rows's targets: ((ceil(Lt / 4) + 4, nt) int32 words, (nt,)
    int32 order), order the target indices longest first (ties by index),
    word (c, s) the codes of columns 4c - 8 .. 4c - 5 of target order[s],
    byte k column 4c - 8 + k, and the code alph (whose profile entry is 0)
    for a column left of 0 or from the target's length on."""
    nt, Lt = t_mat.shape
    order = torch.argsort(t_lens, descending=True, stable=True)
    t = torch.full((nt, 4 * ((Lt + 3) // 4 + 4)), alph, dtype=torch.uint8,
                   device=t_mat.device)
    cols = torch.arange(Lt, device=t_mat.device)
    t[:, 8:8 + Lt] = torch.where(cols[None, :] < t_lens[order, None],
                                 t_mat[order].to(torch.uint8), alph)
    return t.view(torch.int32).t().contiguous(), order.to(torch.int32)


def _check_rows(q_mat, r0, r1):
    if not 0 <= r0 <= r1 <= q_mat.shape[0]:
        raise ValueError(f"gapless kernel: query rows {r0}..{r1} outside "
                         f"0..{q_mat.shape[0]}")


def _checked(name, q_mat, qb_mat, q_lens, t_mat, t_lens, scoring, *idx):
    """(int32 submat, alph) once the inputs of kernel `name` lie on one
    CUDA device with matching shapes and the scores fit its profile."""
    dev = q_mat.device
    tensors = (q_mat, qb_mat, q_lens, t_mat, t_lens, *idx, scoring.submat)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("gapless kernel takes tensors on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    (nq, Lq), nt = q_mat.shape, t_mat.shape[0]
    if (qb_mat.shape != (nq, Lq) or q_lens.shape != (nq,)
            or t_lens.shape != (nt,) or t_mat.dim() != 2
            or any(i.shape != idx[0].shape or i.dim() != 1 for i in idx)):
        raise ValueError("gapless kernel: shapes do not match staged "
                         "(nq, Lq) x (nt, Lt) matrices and (B,) indices")
    alph = scoring.submat.shape[0]
    # gapless_rows and gapless_pair keep one more profile entry, the code of
    # no column
    most = 32 if name == "gapless_long" else 31
    if scoring.submat.shape != (alph, alph) or alph > most:
        raise ValueError(f"{name} takes a square substitution matrix of at "
                         f"most {most} classes")
    # the query profile holds submat + bias (an int8) as int16
    check_scores_fit(scoring.submat, -32640, 32639, name)
    return scoring.submat.to(torch.int32).contiguous(), alph


def gapless_scores_gathered(q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj,
                            scoring=None):
    """(B,) int32 best gapless diagonal score of each pair of staged rows
    (q_mat[li[b]], t_mat[lj[b]]); a pair with an index out of range scores
    0. q_mat, qb_mat: (nq, Lq) codes and biases; t_mat: (nt, Lt) codes."""
    scoring = scoring or default_scoring(q_mat.device)
    name = kernel_for(q_mat.shape[1])
    if q_mat.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return ungapped_torch.gapless_gathered(
            q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj, scoring=scoring)
    return launch(name, q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj,
                  scoring=scoring)


def launch(name, q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj,
           scoring=None):
    """gapless_scores_gathered on kernel `name` (one of KERNELS), whatever
    kernel_for would pick: CUDA tensors only."""
    scoring = scoring or default_scoring(q_mat.device)
    if name not in ("gapless_pair", "gapless_long"):
        raise ValueError(f"{name} does not take gathered pairs")
    sub, alph = _checked(name, q_mat, qb_mat, q_lens, t_mat, t_lens,
                         scoring, li, lj)
    (nq, Lq), (nt, Lt), B = q_mat.shape, t_mat.shape, li.shape[0]
    q = q_mat.to(torch.uint8).contiguous()
    qb = qb_mat.to(torch.int8).contiguous()
    ql = q_lens.to(torch.int32).contiguous()
    tl = t_lens.to(torch.int32).contiguous()
    lj32 = lj.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    if name == "gapless_pair":
        c, split = pair_layout(B, nq, Lq, alph)
        best = torch.zeros(B, dtype=torch.int32, device=q.device)
        if B == 0 or nq == 0 or nt == 0:
            return best
        words, order = target_words(t_mat, tl, alph)
        rank = torch.empty_like(order)
        rank[order.long()] = torch.arange(nt, dtype=torch.int32,
                                          device=q.device)
        perm, grp_q, grp_p0, grp_n = pair_plan(li, lj, rank, nq, nt, c)
        rc = _kernel(name)(sub.data_ptr(), alph, q.data_ptr(), qb.data_ptr(),
                           ql.data_ptr(), nq, Lq, words.data_ptr(),
                           tl.data_ptr(), rank.data_ptr(), nt, Lt,
                           lj32.data_ptr(), perm.data_ptr(),
                           grp_q.data_ptr(), grp_p0.data_ptr(),
                           grp_n.data_ptr(), grp_q.shape[0], c, split,
                           best.data_ptr(), stream)
    else:
        t = t_mat.to(torch.uint8).contiguous()
        li32 = li.to(torch.int32).contiguous()
        best = torch.empty(B, dtype=torch.int32, device=q.device)
        rc = _kernel(name)(sub.data_ptr(), alph, q.data_ptr(), qb.data_ptr(),
                           ql.data_ptr(), nq, Lq, t.data_ptr(), tl.data_ptr(),
                           nt, Lt, li32.data_ptr(), lj32.data_ptr(), B,
                           best.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return best


def pair_layout(B, nq, Lq, alph):
    """gapless_pair's layout of a launch of B pairs over nq staged queries:
    (c, split), c pairs of one query a group, each on `split` threads, a
    group c * split threads and a block PAIR_THREADS // (c * split) groups.
    split, a power of two up to 32, deals each pair's bands over threads
    while B * split is at most PAIR_LAUNCH_THREADS / 2; c, a power of two,
    is at least B / nq (the pairs a staged query has on average) unless a
    group would pass a block, and large enough that a block's profiles fit
    PAIR_PROF_BYTES. Raises if one profile passes PAIR_PROF_BYTES_MAX."""
    row = (Lq + 4) * (22 if alph < 22 else 32) * 2
    if row > PAIR_PROF_BYTES_MAX:
        raise ValueError(f"gapless_pair stages a query profile of {row} "
                         f"bytes at Lq {Lq}, over its {PAIR_PROF_BYTES_MAX}; "
                         "gapless_long takes such widths")
    fit = max(1, PAIR_PROF_BYTES // row)
    split = 1
    while split < 32 and B * split * 2 <= PAIR_LAUNCH_THREADS:
        split *= 2
    avg = -(-B // max(1, nq))
    c = 1
    while c * split < PAIR_THREADS and (
            c < avg or PAIR_THREADS // (c * split) > fit):
        c *= 2
    return c, split


def pair_plan(li, lj, rank, nq, nt, g):
    """gapless_pair's work list, on the pairs' device with no host sync:
    (perm, grp_q, grp_p0, grp_n). perm (B,) int64: the pair indices sorted
    stably by (li, rank[lj]), the pairs with an index out of range last;
    group G holds the grp_n[G] <= g pairs perm[grp_p0[G] ..] of query
    grp_q[G] (g: pair_layout's c), each query's run cut into groups of g
    from its first pair; groups past the last pair are empty (grp_n 0,
    grp_q 0). Every pair in range is in exactly one group. rank: (nt,)
    int32 word column of each target (target_words's order inverted)."""
    dev, B = li.device, li.shape[0]
    li, lj = li.long(), lj.long()
    valid = (li >= 0) & (li < nq) & (lj >= 0) & (lj < nt)
    li, lj = torch.where(valid, li, 0), torch.where(valid, lj, 0)
    key = torch.where(valid, li * nt + rank[lj], nq * nt)
    perm = torch.sort(key, stable=True).indices
    counts = torch.zeros(nq, dtype=torch.long, device=dev).index_add_(
        0, li, valid.long())
    n_grp = (counts + g - 1) // g
    g_end = torch.cumsum(n_grp, 0)
    # each query's last group may be partial: at most B / g full groups and
    # one partial group a query
    G = torch.arange(-(-B // g) + min(nq, B), device=dev)
    q = torch.searchsorted(g_end, G, right=True)
    qc = q.clamp(max=nq - 1)
    k = G - (g_end[qc] - n_grp[qc])
    p0 = torch.cumsum(counts, 0)[qc] - counts[qc] + k * g
    n = torch.where(q < nq, (counts[qc] - k * g).clamp(0, g), 0)
    return (perm, torch.where(q < nq, q, 0).to(torch.int32), p0,
            n.to(torch.int32))


def gapless_scores(q_enc, q_bias, q_len, t_enc, t_len, scoring=None):
    """(B,) int32 best gapless diagonal score of each pair of a per-pair
    batch: (B, Lq) query codes and biases against (B, Lt) target codes."""
    pairs = torch.arange(q_enc.shape[0], device=q_enc.device)
    return gapless_scores_gathered(q_enc, q_bias, q_len, t_enc, t_len, pairs,
                                   pairs, scoring=scoring)
