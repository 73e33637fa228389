# Copy of metaeuk_tpu/search/exhaustive.py; it differs from its original only in this note.
"""ungappedprefilter / gappedprefilter (all-vs-all prefilter modules).

Port of lib/mmseqs/src/prefiltering/ungappedprefilter.cpp
(runFilterOnCpu): for every query x target pair surviving the
canBeCovered length filter, score with either the 8-bit saturated
diagonal scan (SmithWaterman::ungapped_alignment,
StripedSmithWaterman.cpp:1722-1780) or the full gapped SCORE_ONLY
Smith-Waterman; keep hits with score > --min-ungapped-score (and
e-value <= -e for the gapped mode), sorted by (score desc, target key
asc), capped at --max-seqs, written as prefilter lines with diagonal 0.

This exact scalar path is the byte-parity surface; the production
all-vs-all scoring path on TPU is the Pallas gapless kernel
(ops/ungapped.py) and the fused SW kernel (ops/sw_pallas.py).
"""

import numpy as np

from ..data.submat import BLOSUM62_SCORES, composition_bias_rounded
from ..io import mmseqsdb


def _profile_and_bias(q_enc, comp_bias_correction):
    """ssw_init's 8-bit query profile pieces (StripedSmithWaterman.cpp:
    1230-1290): int8 composition bias + bias = |min(mat)| + |min(cb)|."""
    if comp_bias_correction:
        cb = composition_bias_rounded(q_enc).astype(np.int64)
        min_cb = min(0, int(cb.min()) if len(cb) else 0)
    else:
        cb = np.zeros(len(q_enc), np.int64)
        min_cb = 0
    bias = abs(int(BLOSUM62_SCORES.min())) + abs(min_cb)
    prof = BLOSUM62_SCORES[np.asarray(q_enc, np.int64)].astype(np.int64) \
        + cb[:, None]
    return prof, bias


def ungapped_alignment_score(prof, bias, t_enc):
    """SmithWaterman::ungapped_alignment: per-cell
    S(i,j) = sat0(sat255(S(i-1,j-1) + prof[i][t_j] + bias) - bias),
    global max (capped at 255)."""
    Lq = prof.shape[0]
    col = np.zeros(Lq, np.int64)
    pb = prof + bias  # uint8 profile entries
    best = 0
    for tj in np.asarray(t_enc, np.int64):
        prev = np.concatenate(([0], col[:-1]))
        s = np.minimum(prev + pb[:, tj], 255)
        col = np.maximum(s - bias, 0)
        m = int(col.max()) if Lq else 0
        if m > best:
            best = m
    return best


def _can_be_covered(cov_thr, cov_mode, q_len, t_len):
    from .lcaalign import can_be_covered
    return can_be_covered(cov_thr, cov_mode, q_len, t_len)


def exhaustive_prefilter(query_db, target_db, out_db, gapped=False,
                         evalue=1e-3, min_ungapped_score=15, max_seqs=300,
                         cov=0.0, cov_mode=0, comp_bias_correction=True,
                         compressed=False):
    """The ungappedprefilter (gapped=False) / gappedprefilter
    (gapped=True) command."""
    from ..data.submat import AA2NUM
    from .evalue import EvalueComputation

    qdb = mmseqsdb.read_seqdb(query_db)
    same = str(query_db) == str(target_db)
    tdb = qdb if same else mmseqsdb.read_seqdb(target_db)
    tkeys = [int(k) for k in tdb.keys]
    tencs = [AA2NUM[np.asarray(tdb.seq(i), np.uint8)]
             for i in range(len(tdb))]
    tlens = [len(e) for e in tencs]
    evaluer = EvalueComputation(int(tdb.lengths.sum()), gapped=True) \
        if gapped else None

    entries = []
    for qi in range(len(qdb)):
        qkey = int(qdb.keys[qi])
        q = AA2NUM[np.asarray(qdb.seq(qi), np.uint8)]
        prof, bias = _profile_and_bias(q, comp_bias_correction)
        hits = []
        for ti in range(len(tdb)):
            is_identity = same and qkey == tkeys[ti]
            if not _can_be_covered(cov, cov_mode, len(q), tlens[ti]):
                continue
            if not gapped:
                score = ungapped_alignment_score(prof, bias, tencs[ti])
                has_evalue = True
            else:
                if is_identity:
                    score = int((prof[np.arange(len(q)), q]).sum())
                else:
                    from ..ops.sw import sw_end
                    cb = prof - BLOSUM62_SCORES[q].astype(np.int64)
                    score, _qe, _te = sw_end(
                        BLOSUM62_SCORES[q].astype(np.int64) + cb,
                        tencs[ti])
                has_evalue = evaluer.compute_evalue(score, len(q)) <= evalue
            if is_identity or (score > min_ungapped_score and has_evalue):
                hits.append((int(score), tkeys[ti]))
        hits.sort(key=lambda h: (-h[0], h[1]))
        payload = "".join(f"{t}\t{s}\t0\n" for s, t in hits[:max_seqs])
        entries.append((qkey, payload.encode()))
    mmseqsdb.write_db(out_db, entries, mmseqsdb.DBTYPE_PREFILTER_RES,
                      compressed=compressed)
    return out_db
