"""Plain PyTorch Smith-Waterman ends and starts: the contract of the Pallas
pair kernels, vectorised over pairs, one loop step per target column.

These are the plain versions of the CUDA kernels in csrc/sw_pair.cu,
csrc/sw_qm.cu and csrc/sw_qm_rt.cu:

- sw_ends      <-> metaeuk_tpu/ops/sw_pallas.py::_dp_kernel (K1)
- sw_starts    <-> metaeuk_tpu/ops/sw_pallas.py::_dp_kernel_rev (K2)
- sw_ends_prof, sw_starts_prof <-> the same two kernels on a PSSM query
  (sw_pallas.py _align_full_prof over _build_S_prof; with cap=None,
  sw_jax.py sw_batch_ends_prof under sw_align_batch_prof, the
  profile-query aligner's XLA code)
- qm_ends      <-> metaeuk_tpu/ops/sw_pallas.py::_dp_kernel_qm (K3)
- qm_starts    <-> metaeuk_tpu/ops/sw_pallas.py::_dp_kernel_qm_rev (K4)
- qm_ends_rt   <-> metaeuk_tpu/ops/sw_pallas.py::_dp_kernel_qm_rt (K5)
- qm_starts_rt <-> metaeuk_tpu/ops/sw_pallas.py::_dp_kernel_qm_rev_rt (K6)

The pair versions take one query and one target row per pair; the
query-major ones take staged (nq, Lq) / (nt, Lt) matrices, one query row per
tile (qidx) and TB = 128 target rows per tile (lj), through the profile and
lane-major target codes of build_prof_tiles / build_tcodes_T; the PSSM
versions take a caller's (B, Lq, 21) profile a pair. All score cell (i, j)
as submat[q_i, t_j] + bias_i (prof[b, i, t_j], no bias), with -128 on padded
query rows (i >= q_len) and padded target columns (j >= t_len), exactly as
_build_S_gapped builds S. The column recurrence is the Pallas one: E starts
at -go, H at 0, F is the running max over G down the column (torch.cummax),
H is capped at 32767 (cap=None: not capped, sw_jax.sw_align_batch's and
sw_align_batch_prof's contract, which the realign pass and the
profile-query aligner keep). Forward tie-break: highest score,
then the first column, then the smallest row; no hit gives (0, Lq-1, -1).
Reverse: columns te..0 and rows <= qe, tie-break the last column, then the
largest row; no hit gives (0, 0, -1).

Inputs are (B, Lq) / (B, Lt) integer tensors and (B,) lengths on one
device; outputs are (B,) int32 tensors on that device. Like the kernels,
the DP runs only over rows and columns up to the batch's longest sequences:
padded cells never strictly improve the best, so cutting them gives the
same result.
"""

import torch

from ..state import NEG, PAD_SCORE, SCORE_CAP, default_scoring

TB = 128     # target lanes per query-major tile (sw_pallas.py TB)
PCOLS = 32   # profile columns of a query-major tile (sw_pallas.py PCOLS)
# query rows per row tile of the JAX package's row-tiled K5/K6
# (sw_pallas.py QM_TQ), which qm_ends_rt / qm_starts_rt follow; their result
# is the same for any row tile
TQ_RT = 2048


def _profile(scoring, q_enc, q_bias, q_len):
    """(B, Lq, alph + 1) int32: submat[q_i, a] + bias_i, PAD_SCORE on padded
    rows; the extra class alph (a padded target column) scores PAD_SCORE."""
    B, Lq = q_enc.shape
    prof = scoring.submat[q_enc.long()] + q_bias.to(torch.int32)[:, :, None]
    rows = torch.arange(Lq, device=q_enc.device)
    valid = rows[None, :] < q_len.to(torch.int32)[:, None]
    prof = torch.where(valid[:, :, None], prof, PAD_SCORE)
    pad = torch.full((B, Lq, 1), PAD_SCORE, dtype=torch.int32,
                     device=q_enc.device)
    return torch.cat([prof, pad], dim=2)


def _target_classes(scoring, t_enc, t_len):
    """(B, Lt) int64 profile class per target column; padding -> alph."""
    Lt = t_enc.shape[1]
    cols = torch.arange(Lt, device=t_enc.device)
    valid = cols[None, :] < t_len.to(torch.int32)[:, None]
    return torch.where(valid, t_enc.long(), scoring.submat.shape[0])


def _trim(q_enc, q_bias, q_len, t_enc, t_len):
    """Cut the padded axes to the longest sequence of the batch (>= 1)."""
    lq = max(1, min(q_enc.shape[1], int(q_len.max()) if len(q_len) else 1))
    lt = max(1, min(t_enc.shape[1], int(t_len.max()) if len(t_len) else 1))
    return q_enc[:, :lq], q_bias[:, :lq], t_enc[:, :lt]


def _capped(H, cap):
    return H if cap is None else torch.clamp_max(H, cap)


def _column(prof, tcls, j, lo, hi):
    B = prof.shape[0]
    idx = tcls[:, j].view(B, 1, 1).expand(B, hi - lo, 1)
    return prof[:, lo:hi].gather(2, idx).squeeze(2)


def _ends_loop(column, n_cols, B, Lq, Lq_full, scoring, dev, tq=None,
               cap=SCORE_CAP):
    """The forward recurrence over columns 0..n_cols-1; column(j, lo, hi)
    gives the (B, hi - lo) int32 scores of column j on rows lo..hi-1
    (PAD_SCORE on padded cells). The rows run in tiles of tq (one tile when
    tq is None), top tile first, each swept over every column; per column,
    the last row's H (hb) and the inclusive F-chain max A = max_k G(k) +
    k * ge over the rows above (ab) carry into the next tile (sw_pallas.py
    _dp_kernel_qm_rt). The tie-break keeps the earlier column across
    tiles: an earlier tile's best is kept only on an equal score and
    column, which gives its smaller row. H is capped at cap (None: not
    capped)."""
    go, ge = scoring.go, scoring.ge
    i32 = dict(dtype=torch.int32, device=dev)
    hb = torch.zeros((B, n_cols), **i32)
    ab = torch.full((B, n_cols), NEG, **i32)
    neg_row = torch.full((B, 1), NEG, **i32)
    best = torch.zeros(B, **i32)
    q_end = torch.full((B,), Lq_full - 1, **i32)
    t_end = torch.full((B,), -1, **i32)
    tq = tq or Lq
    for lo in range(0, Lq, tq):
        hi = min(lo + tq, Lq)
        rows = torch.arange(lo, hi, **i32)
        igge = rows * ge
        f_base = -go - (rows - 1) * ge
        H = torch.zeros((B, hi - lo), **i32)
        E = torch.full((B, hi - lo), -go, **i32)
        hbp = torch.zeros((B, 1), **i32)   # hb of the previous column
        for j in range(n_cols):
            s = column(j, lo, hi)
            Hd = torch.cat([hbp, H[:, :-1]], dim=1)
            hbp = hb[:, j:j + 1].clone()
            G = torch.clamp_min(torch.maximum(Hd + s, E), 0)
            A = torch.cummax(G + igge, dim=1).values
            Aex = torch.maximum(torch.cat([neg_row, A[:, :-1]], dim=1),
                                ab[:, j:j + 1])
            H = _capped(torch.maximum(G, Aex + f_base), cap)
            col_max, col_row = torch.max(H, dim=1)
            better = (col_max > best) | ((col_max == best) & (best > 0)
                                         & (j < t_end))
            best = torch.where(better, col_max, best)
            q_end = torch.where(better, (col_row + lo).to(torch.int32),
                                q_end)
            t_end = torch.where(better, j, t_end)
            E = torch.maximum(E - ge, H - go)
            hb[:, j] = H[:, -1]
            ab[:, j] = torch.maximum(A[:, -1], ab[:, j])
    return best, q_end, t_end


def _starts_loop(column, n_cols, B, Lq, q_end, t_end, scoring, dev,
                 tq=None, cap=SCORE_CAP):
    """The reverse-prefix recurrence over columns n_cols-1..0, rows <= q_end
    and columns <= t_end; column as for _ends_loop. The rows run in tiles of
    tq (one tile when tq is None), bottom tile first; per column, the first
    row's H and the suffix F-chain max over the rows below carry into the
    tile above (sw_pallas.py _dp_kernel_qm_rev_rt). The tie-break keeps the
    last column across tiles: a lower tile's best is kept only on an equal
    score and column, which gives its larger row. H is capped at cap
    (None: not capped)."""
    go, ge = scoring.go, scoring.ge
    i32 = dict(dtype=torch.int32, device=dev)
    q_end = q_end.to(torch.int32)
    t_end = t_end.to(torch.int32)
    hb = torch.zeros((B, n_cols), **i32)
    ab = torch.full((B, n_cols), NEG, **i32)
    neg_row = torch.full((B, 1), NEG, **i32)
    best = torch.zeros(B, **i32)
    q_start = torch.zeros(B, **i32)
    t_start = torch.full((B,), -1, **i32)
    tq = tq or Lq
    for lo in reversed(range(0, Lq, tq)):
        hi = min(lo + tq, Lq)
        rows = torch.arange(lo, hi, **i32)
        q_mask = rows[None, :] <= q_end[:, None]
        igge = rows * ge
        f_base = -go + (rows + 1) * ge
        H = torch.zeros((B, hi - lo), **i32)
        E = torch.full((B, hi - lo), -go, **i32)
        hbp = torch.zeros((B, 1), **i32)   # hb of column j + 1
        for j in range(n_cols - 1, -1, -1):
            live = q_mask & (j <= t_end)[:, None]
            s = torch.where(live, column(j, lo, hi), NEG)
            # the diagonal predecessor is one row below (i+1, j+1)
            Hd = torch.cat([H[:, 1:], hbp], dim=1)
            hbp = hb[:, j:j + 1].clone()
            G = torch.clamp_min(torch.maximum(Hd + s, E), 0)
            # F(i) = max_{k>i} G(k) - go - (k-1-i)*ge: a suffix cummax
            A = torch.cummax((G - igge).flip(1), dim=1).values.flip(1)
            Aex = torch.maximum(torch.cat([A[:, 1:], neg_row], dim=1),
                                ab[:, j:j + 1])
            H = _capped(torch.maximum(G, Aex + f_base), cap)
            col_max, col_last = torch.max(H.flip(1), dim=1)
            better = (col_max > best) | ((col_max == best) & (best > 0)
                                         & (j > t_start))
            best = torch.where(better, col_max, best)
            q_start = torch.where(better, (hi - 1 - col_last).to(torch.int32),
                                  q_start)
            t_start = torch.where(better, j, t_start)
            E = torch.maximum(E - ge, H - go)
            hb[:, j] = H[:, 0]
            ab[:, j] = torch.maximum(A[:, 0], ab[:, j])
    return best, q_start, t_start


def sw_ends(q_enc, q_bias, q_len, t_enc, t_len, scoring=None,
            cap=SCORE_CAP):
    """Forward ends: (score, q_end, t_end), each (B,) int32; H capped at
    cap (None: not capped)."""
    scoring = scoring or default_scoring(q_enc.device)
    B, Lq_full = q_enc.shape
    q_enc, q_bias, t_enc = _trim(q_enc, q_bias, q_len, t_enc, t_len)
    prof = _profile(scoring, q_enc, q_bias, q_len)
    tcls = _target_classes(scoring, t_enc, t_len)
    return _ends_loop(lambda j, lo, hi: _column(prof, tcls, j, lo, hi),
                      t_enc.shape[1], B, q_enc.shape[1], Lq_full, scoring,
                      q_enc.device, cap=cap)


def sw_starts(q_enc, q_bias, q_len, t_enc, t_len, q_end, t_end,
              scoring=None, cap=SCORE_CAP):
    """Reverse-prefix starts for pairs with known ends:
    (score, q_start, t_start), each (B,) int32; H capped at cap (None: not
    capped)."""
    scoring = scoring or default_scoring(q_enc.device)
    q_enc, q_bias, t_enc = _trim(q_enc, q_bias, q_len, t_enc, t_len)
    B, Lq = q_enc.shape
    prof = _profile(scoring, q_enc, q_bias, q_len)
    tcls = _target_classes(scoring, t_enc, t_len)
    return _starts_loop(lambda j, lo, hi: _column(prof, tcls, j, lo, hi),
                        t_enc.shape[1], B, Lq, q_end, t_end, scoring,
                        q_enc.device, cap=cap)


def _pssm_setup(prof, q_len, t_enc, t_len):
    """(column(j, lo, hi), n_cols, Lq) of the PSSM plain versions: the
    caller's (B, Lq, A) profile as int32 with PAD_SCORE on rows i >= q_len
    and an extra class A (a padded target column) of PAD_SCORE, and the
    target's classes; both axes cut to the batch's longest sequences."""
    B, _, A = prof.shape
    lq = max(1, min(prof.shape[1], int(q_len.max()) if len(q_len) else 1))
    lt = max(1, min(t_enc.shape[1], int(t_len.max()) if len(t_len) else 1))
    dev = prof.device
    rows = torch.arange(lq, device=dev)
    valid = rows[None, :] < q_len.to(torch.int32)[:, None]
    pr = torch.where(valid[:, :, None], prof[:, :lq].to(torch.int32),
                     PAD_SCORE)
    pad = torch.full((B, lq, 1), PAD_SCORE, dtype=torch.int32, device=dev)
    pr = torch.cat([pr, pad], dim=2)
    cols = torch.arange(lt, device=dev)
    tcls = torch.where(cols[None, :] < t_len.to(torch.int32)[:, None],
                       t_enc[:, :lt].long(), A)
    return (lambda j, lo, hi: _column(pr, tcls, j, lo, hi)), lt, lq


def sw_ends_prof(prof, q_len, t_enc, t_len, cap=SCORE_CAP):
    """Forward ends of PSSM-vs-sequence pairs (the PROFILE_SEQ path,
    sw_pallas.py _build_S_prof: cell (i, j) scores prof[b, i, t_j], no
    bias): (score, q_end, t_end), each (B,) int32. prof: (B, Lq, 21). H
    capped at cap (None: not capped)."""
    column, n_cols, lq = _pssm_setup(prof, q_len, t_enc, t_len)
    return _ends_loop(column, n_cols, prof.shape[0], lq, prof.shape[1],
                      default_scoring(prof.device), prof.device, cap=cap)


def sw_starts_prof(prof, q_len, t_enc, t_len, q_end, t_end, cap=SCORE_CAP):
    """Reverse-prefix starts of PSSM-vs-sequence pairs with known ends:
    (score, q_start, t_start), each (B,) int32; H capped at cap (None: not
    capped)."""
    column, n_cols, lq = _pssm_setup(prof, q_len, t_enc, t_len)
    return _starts_loop(column, n_cols, prof.shape[0], lq, q_end, t_end,
                        default_scoring(prof.device), prof.device, cap=cap)


def align_full_prof(prof, q_len, t_enc, t_len, cap=SCORE_CAP):
    """align_full for PSSM-vs-sequence pairs (sw_pallas.py
    _align_full_prof; with cap=None, sw_jax.py sw_align_batch_prof):
    (score, q_start, q_end, t_start, t_end)."""
    score, q_end, t_end = sw_ends_prof(prof, q_len, t_enc, t_len, cap=cap)
    _, q_start, t_start = sw_starts_prof(prof, q_len, t_enc, t_len,
                                         torch.clamp_min(q_end, 0),
                                         torch.clamp_min(t_end, 0), cap=cap)
    aligned = (t_end >= 0) & (score > 0)
    return (score, torch.where(aligned, q_start, -1), q_end,
            torch.where(aligned, t_start, -1), t_end)


def build_prof_tiles(q_mat, qb_mat, q_lens, qidx, scoring=None):
    """Per-tile query profiles of the query-major kernels (sw_pallas.py
    build_prof_tiles): (n_tiles, Lq, PCOLS) int32 from staged (nq, Lq)
    codes and bias rows, submat[q_i, a] + bias_i on the first alph columns
    of rows i < q_len, PAD_SCORE elsewhere; qidx < 0 marks a padding tile
    (all PAD_SCORE)."""
    scoring = scoring or default_scoring(q_mat.device)
    Lq = q_mat.shape[1]
    qidx = qidx.long()
    valid_tile = qidx >= 0
    qi = torch.clamp_min(qidx, 0)
    prof = scoring.submat[q_mat[qi].long()] \
        + qb_mat[qi].to(torch.int32)[:, :, None]          # (nT, Lq, alph)
    prof = torch.nn.functional.pad(prof, (0, PCOLS - prof.shape[2]),
                                   value=PAD_SCORE)
    qlen = torch.where(valid_tile, q_lens[qi].to(torch.int32), 0)
    iq = torch.arange(Lq, device=q_mat.device, dtype=torch.int32)
    return torch.where((iq[None, :] < qlen[:, None])[:, :, None], prof,
                       PAD_SCORE)


def build_tcodes_T(t_mat, t_lens, lj, Lt_pad, scoring=None):
    """Lane-major target codes of the query-major kernels (sw_pallas.py
    build_tcodes_T): (Lt_pad, n_tiles * TB) int32 from staged (nt, Lt)
    codes and lj (n_tiles, TB); padding positions and lanes with lj < 0
    carry the pad class alph (the PAD_SCORE profile column)."""
    scoring = scoring or default_scoring(t_mat.device)
    pad_class = scoring.submat.shape[0]
    lj = lj.long()
    valid = lj >= 0
    ljc = torch.clamp_min(lj, 0)
    tc = t_mat[ljc].to(torch.int32)                      # (nT, TB, Lt)
    tl = torch.where(valid, t_lens[ljc].to(torch.int32), 0)
    if tc.shape[2] < Lt_pad:
        tc = torch.nn.functional.pad(tc, (0, Lt_pad - tc.shape[2]))
    jt = torch.arange(Lt_pad, device=t_mat.device, dtype=torch.int32)
    tc = torch.where(jt[None, None, :] < tl[:, :, None], tc, pad_class)
    return tc.reshape(-1, Lt_pad).T


def _qm_setup(q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj, scoring):
    """(column(j), n_cols, B, Lq) of the query-major plain versions, the
    axes cut to the longest query row and target column in use."""
    nT = qidx.shape[0]
    B = nT * TB
    prof = build_prof_tiles(q_mat, qb_mat, q_lens, qidx, scoring)
    tc = build_tcodes_T(t_mat, t_lens, lj.reshape(nT, TB), t_mat.shape[1],
                        scoring)
    valid_q = qidx.long() >= 0
    ql = q_lens[torch.clamp_min(qidx.long(), 0)][valid_q]
    lq = max(1, min(prof.shape[1], int(ql.max()) if len(ql) else 1))
    valid_t = lj.long() >= 0
    tl = t_lens[torch.clamp_min(lj.long(), 0)][valid_t]
    lt = max(1, min(tc.shape[0], int(tl.max()) if len(tl) else 1))
    prof = prof[:, :lq]

    def column(j, lo, hi):
        # one query profile per tile, gathered at each lane's residue, on
        # query rows lo..hi-1
        idx = tc[j].view(nT, 1, TB).expand(nT, hi - lo, TB).long()
        return prof[:, lo:hi].gather(2, idx).transpose(1, 2).reshape(
            B, hi - lo)
    return column, lt, B, lq


def qm_ends(q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj, scoring=None):
    """Query-major forward ends (K3): (score, q_end, t_end), each
    (n_tiles * TB,) int32, for tile k's query row qidx[k] against the targets
    rows lj[k * TB:(k + 1) * TB] of the staged matrices."""
    scoring = scoring or default_scoring(q_mat.device)
    column, n_cols, B, Lq = _qm_setup(q_mat, qb_mat, q_lens, t_mat, t_lens,
                                      qidx, lj, scoring)
    return _ends_loop(column, n_cols, B, Lq, q_mat.shape[1], scoring,
                      q_mat.device)


def qm_starts(q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj, q_end, t_end,
              scoring=None):
    """Query-major reverse-prefix starts (K4) from known ends:
    (score, q_start, t_start), each (n_tiles * TB,) int32."""
    scoring = scoring or default_scoring(q_mat.device)
    column, n_cols, B, Lq = _qm_setup(q_mat, qb_mat, q_lens, t_mat, t_lens,
                                      qidx, lj, scoring)
    return _starts_loop(column, n_cols, B, Lq, q_end, t_end, scoring,
                        q_mat.device)


def qm_ends_rt(q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj, scoring=None,
               tq=TQ_RT):
    """Row-tiled query-major forward ends (K5), for queries longer than the
    shared memory of a block holds: qm_ends' function, the query rows swept
    in tiles of tq. (score, q_end, t_end), each (n_tiles * TB,) int32."""
    scoring = scoring or default_scoring(q_mat.device)
    column, n_cols, B, Lq = _qm_setup(q_mat, qb_mat, q_lens, t_mat, t_lens,
                                      qidx, lj, scoring)
    return _ends_loop(column, n_cols, B, Lq, q_mat.shape[1], scoring,
                      q_mat.device, tq)


def qm_starts_rt(q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj, q_end,
                 t_end, scoring=None, tq=TQ_RT):
    """Row-tiled query-major reverse-prefix starts (K6) from known ends:
    qm_starts' function, the query rows swept in tiles of tq from the
    bottom. (score, q_start, t_start), each (n_tiles * TB,) int32."""
    scoring = scoring or default_scoring(q_mat.device)
    column, n_cols, B, Lq = _qm_setup(q_mat, qb_mat, q_lens, t_mat, t_lens,
                                      qidx, lj, scoring)
    return _starts_loop(column, n_cols, B, Lq, q_end, t_end, scoring,
                        q_mat.device, tq)


def align_full(q_enc, q_bias, q_len, t_enc, t_len, scoring=None,
               ends=sw_ends, starts=sw_starts, cap=SCORE_CAP):
    """Ends, then starts from the clamped ends; start coordinates of pairs
    that did not align are -1 (sw_pallas.py _align_from_S; with cap=None,
    sw_jax.sw_align_batch). Returns (score, q_start, q_end, t_start,
    t_end)."""
    score, q_end, t_end = ends(q_enc, q_bias, q_len, t_enc, t_len,
                               scoring=scoring, cap=cap)
    _, q_start, t_start = starts(q_enc, q_bias, q_len, t_enc, t_len,
                                 torch.clamp_min(q_end, 0),
                                 torch.clamp_min(t_end, 0), scoring=scoring,
                                 cap=cap)
    aligned = (t_end >= 0) & (score > 0)
    q_start = torch.where(aligned, q_start, -1)
    t_start = torch.where(aligned, t_start, -1)
    return score, q_start, q_end, t_start, t_end
