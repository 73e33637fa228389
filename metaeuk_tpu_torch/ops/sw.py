# Copy of metaeuk_tpu/ops/sw.py; it differs from its original only in this note.
"""Smith-Waterman alignment — host (numpy) reference oracle.

Replicates the score/endpoint contract of the reference's striped SW
(SmithWaterman::ssw_align, lib/mmseqs/src/alignment/StripedSmithWaterman.cpp:278-560):

- integer scoring: S(i,j) = blosum62_2bit[q_i][t_j] + int8-rounded
  composition bias at query position i (ssw_init, :1230-1236)
- affine gaps (open 11 / extend 1), H floored at 0
- end position: smallest target index whose column attains the global max,
  then smallest query index within that column (sw_sse2_byte:879-916)
- start position: same DP on the reversed (q[:qEnd+1], t[:tEnd+1]) prefixes
  (ssw_align_private:398-482)

This module is the correctness oracle for the TPU engines in sw_jax.py /
sw_pallas.py.
"""

import numpy as np

from ..data.submat import BLOSUM62_SCORES

NEG = -(10 ** 6)


def sw_end(profile, target):
    """Forward pass. profile: (Lq, 21) int32 position-specific scores;
    target: (Lt,) residue indices. Returns (score, q_end, t_end);
    t_end=-1 when nothing aligns."""
    Lq = profile.shape[0]
    Lt = len(target)
    H = np.zeros(Lq, dtype=np.int64)
    E = np.zeros(Lq, dtype=np.int64)
    best = 0
    q_end, t_end = Lq - 1, -1
    go, ge = 11, 1
    for j in range(Lt):
        s = profile[:, target[j]]
        Hd = np.concatenate(([0], H[:-1]))
        G = np.maximum(0, np.maximum(Hd + s, E))
        # F via running max: F(i) = max_{k<i} (G(k) - go - (i-1-k)*ge)
        A = G + np.arange(Lq) * ge
        M = np.maximum.accumulate(A)
        F = np.concatenate(([NEG], M[:-1])) - go - (np.arange(Lq) - 1) * ge
        Hn = np.maximum(G, F)
        col_max = Hn.max() if Lq else 0
        if col_max > best:
            best = int(col_max)
            t_end = j
            q_end = int(np.argmax(Hn))
        E = np.maximum(np.maximum(E - ge, Hn - go), 0)
        H = Hn
    return best, q_end, t_end


def sw_align(q_enc, t_enc, bias=None):
    """Full alignment: returns dict(score, q_start, q_end, t_start, t_end).

    q_enc/t_enc: residue-index arrays; bias: int8-rounded per-position
    composition bias for the query (None = zeros).
    """
    q_enc = np.asarray(q_enc, dtype=np.int64)
    t_enc = np.asarray(t_enc, dtype=np.int64)
    if bias is None:
        bias = np.zeros(len(q_enc), dtype=np.int64)
    prof = BLOSUM62_SCORES[q_enc].astype(np.int64) + np.asarray(bias, dtype=np.int64)[:, None]
    score, q_end, t_end = sw_end(prof, t_enc)
    if t_end < 0 or score == 0:
        return dict(score=int(score), q_start=-1, q_end=q_end, t_start=-1, t_end=t_end)
    # reverse pass on the reversed prefixes
    prof_rev = prof[q_end::-1]
    t_rev = t_enc[t_end::-1]
    score2, qr_end, tr_end = sw_end(prof_rev, t_rev)
    assert score2 == score, (score, score2)
    return dict(score=int(score), q_start=q_end - qr_end, q_end=q_end,
                t_start=t_end - tr_end, t_end=t_end)


def sw_score_naive(q_enc, t_enc, bias=None, go=11, ge=1):
    """Cell-by-cell affine SW score (independent second oracle)."""
    q_enc = np.asarray(q_enc, dtype=np.int64)
    t_enc = np.asarray(t_enc, dtype=np.int64)
    if bias is None:
        bias = np.zeros(len(q_enc), dtype=np.int64)
    n, m = len(q_enc), len(t_enc)
    H = np.zeros((n + 1, m + 1), dtype=np.int64)
    E = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    F = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    best = 0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            s = BLOSUM62_SCORES[q_enc[i - 1], t_enc[j - 1]] + bias[i - 1]
            E[i, j] = max(E[i, j - 1] - ge, H[i, j - 1] - go)
            F[i, j] = max(F[i - 1, j] - ge, H[i - 1, j] - go)
            H[i, j] = max(0, H[i - 1, j - 1] + s, E[i, j], F[i, j])
            best = max(best, H[i, j])
    return int(best)
