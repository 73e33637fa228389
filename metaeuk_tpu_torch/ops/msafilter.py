# Copy of metaeuk_tpu/ops/msafilter.py; it differs from its original only in this note.
"""MsaFilter: diversity filtering of MSAs before profile computation.

Port of lib/mmseqs/src/alignment/MsaFilter.cpp:85-555 (filter).  Operates on
a (K, L) uint8 MSA in internal codes (row 0 = query; GAP=21, ENDGAP=22,
ANY/X=20).  The algorithm:

  1. per-sequence coverage / score-per-column (qsc) / query-identity (qid)
     rejection (MsaFilter.cpp:254-318)
  2. a greedy max-pairwise-identity pass over sequences sorted by residue
     count (descending, stable): sequence k is accepted only if it differs
     from every already-accepted sequence j in more than
     (0.9999 - 0.01*seqidk) * min(nres[k], cov_kj) positions
     (MsaFilter.cpp:360-523), where seqidk is the position-dependent
     threshold raised until Ndiff sequences cover every window

The SIMD block-granular diff loop in the reference only affects early
exit, never the accept/reject decision (cov_kj corrections make the block
sum equal the in-range count), so a scalar/numpy count is exact.

Multiple qid buckets (--qid "0.2,0.5,0.9") are supported like the
reference: sequences are bucketed by integer query identity and each
bucket is filtered independently with qid=0 (MsaFilter.cpp:109-141).
"""

import numpy as np

from .pssm import ANY, GAP, NAA
from ..data.submat import scores_with_bias

PLTY_GAPOPEN = np.float32(6.0)
PLTY_GAPEXTD = np.float32(1.0)
WFIL = 25

# result2profile/msa2profile construct their SubstitutionMatrix with
# bitFactor 2.0 and scoreBias -0.2 (result2profile.cpp:127)
_SUBMAT_BIASED = scores_with_bias(2.0, -0.2)


def _filter_bucket(msa, rows, keep, coverage, qid, qsc, max_seqid, ndiff):
    """One filter pass over bucket `rows` (rows[0] = query); mutates keep;
    returns n (accepted count incl. query)."""
    L = msa.shape[1]
    n_in = len(rows)
    X = [msa[r] for r in rows]

    keep[rows[0]] = 2
    for r in rows[1:]:
        keep[r] = 1
    inn = np.zeros(n_in, np.int8)
    inn[0] = 2
    n = 1

    first = np.zeros(n_in, np.int64)
    last = np.zeros(n_in, np.int64)
    nres = np.zeros(n_in, np.int64)
    for k in range(n_in):
        isres = X[k] < NAA
        nz = np.flatnonzero(isres)
        if nz.size:
            first[k], last[k] = nz[0], nz[-1]
            nres[k] = nz.size
        else:
            # reference scans land on first=L, last=0 (MsaFilter.cpp:186-196)
            first[k], last[k] = L, 0
            nres[k] = 0
            keep[rows[k]] = 0

    # stable descending sort by nres, query pinned first (MsaFilter.cpp:212-228)
    order = sorted(range(1, n_in), key=lambda k: -nres[k])
    ksort = [0] + order
    inkk = np.array([inn[ksort[kk]] for kk in range(n_in)], np.int8)

    N = np.zeros(L, np.int64)
    N[first[0]:last[0] + 1] = 1
    nmax = np.zeros(L, np.int64)
    idmaxwin = np.full(L, -1, np.int64)
    seqid_prev = np.full(n_in, -1, np.int64)

    # NOTE: the reference mutates the by-value Ndiff parameter here, and the
    # qid-bucket loop reuses it for later buckets (MsaFilter.cpp:153/247-251)
    # -- bucket 0 clamps Ndiff to its own size, changing later buckets'
    # seqid1/escalation behavior.  The caller threads the mutated value.
    seqid1 = 20
    diff_nmax = ndiff
    if ndiff <= 0 or ndiff >= n_in:
        seqid1 = max_seqid
        ndiff = n_in
        diff_nmax = ndiff

    # coverage / qsc / qid rejection
    qdiff_max_frac = np.float32(0.9999 - 0.01 * qid)
    for k in range(1, n_in):
        if keep[rows[k]] in (0, 2):
            continue
        if 100 * nres[k] < coverage * L:
            keep[rows[k]] = 0
            continue
        if qsc > -10:
            qsc_min = np.float32(np.float32(qsc) * nres[k])
            qsc_sum = np.float32(0.0)
            gapq = gapk = 0
            xq, xk = X[0], X[k]
            for i in range(first[k], last[k] + 1):
                if xk[i] < 20:
                    gapk = 0
                    if xq[i] < 20:
                        gapq = 0
                        qsc_sum = np.float32(
                            qsc_sum + np.float32(_SUBMAT_BIASED[xq[i], xk[i]]))
                    elif xq[i] == ANY:
                        continue
                    else:
                        qsc_sum = np.float32(
                            qsc_sum - (PLTY_GAPEXTD if gapq else PLTY_GAPOPEN))
                        gapq += 1
                elif xk[i] == ANY:
                    continue
                elif xq[i] < 20:
                    gapq = 0
                    qsc_sum = np.float32(
                        qsc_sum - (PLTY_GAPEXTD if gapk else PLTY_GAPOPEN))
                    gapk += 1
            if qsc_sum < qsc_min:
                keep[rows[k]] = 0
                continue
        if qdiff_max_frac < 0.999:
            qdiff_max = int(float(np.float32(qdiff_max_frac
                                             * np.float32(nres[k]))) + 0.9999)
            seg = slice(first[k], last[k] + 1)
            diff = int(np.count_nonzero((X[k][seg] < NAA)
                                        & (X[k][seg] != X[0][seg])))
            if diff >= qdiff_max:
                keep[rows[k]] = 0
                continue

    nn = sum(1 for k in range(n_in) if keep[rows[k]] > 0)
    if nn == 0:
        keep[rows[0]] = 1

    if seqid1 > max_seqid:
        return nn, ndiff

    seqid = seqid1
    seqid_step = 0
    while seqid <= max_seqid:
        stop = True
        diff_nmax_prev = diff_nmax
        diff_nmax = 0
        for i in range(L):
            lo = max(0, min(L - 2 * WFIL + 1, i - WFIL))
            hi = min(L, max(2 * WFIL, i + WFIL))
            m = int(N[lo:hi].max()) if hi > lo else 0
            if nmax[i] < m:
                nmax[i] = m
            if nmax[i] < ndiff:
                stop = False
                idmaxwin[i] = seqid
                if diff_nmax < ndiff - nmax[i]:
                    diff_nmax = ndiff - nmax[i]
        if stop:
            break

        for kk in range(n_in):
            if inkk[kk]:
                continue
            k = ksort[kk]
            if not keep[rows[k]]:
                continue
            if keep[rows[k]] == 2:
                inkk[kk] = 2
                continue
            if seqid >= 100:
                inn[k] = inkk[kk] = 1
                n += 1
                continue

            seqidk = np.float32(seqid1)
            if last[k] >= first[k]:
                w = idmaxwin[first[k]:last[k] + 1]
                mx = int(w.max()) if w.size else -1
                if mx > seqidk:
                    seqidk = np.float32(mx)
            if seqid == seqid_prev[k]:
                continue
            seqid_prev[k] = seqid
            diff_min_frac = np.float32(0.9999 - 0.01 * float(seqidk))

            rejected = False
            for jj in range(kk):
                if not inkk[jj]:
                    continue
                j = ksort[jj]
                first_kj = max(first[k], first[j])
                last_kj = min(last[k], last[j])
                cov_kj = last_kj - first_kj + 1
                diff_suff = int(float(np.float32(
                    diff_min_frac * np.float32(min(int(nres[k]), cov_kj))))
                    + 0.999)
                if last_kj >= first_kj:
                    seg = slice(first_kj, last_kj + 1)
                    xk, xj = X[k][seg], X[j][seg]
                    no_aa = (xk >= NAA) | (xj >= NAA)
                    diff = int(np.count_nonzero(~no_aa & (xk != xj)))
                    cov_kj = cov_kj - int(np.count_nonzero(no_aa))
                else:
                    diff = 0
                if diff < diff_suff \
                        and np.float32(diff) <= diff_min_frac * cov_kj \
                        and cov_kj > 0:
                    rejected = True
                    break
            if not rejected:
                inn[k] = inkk[kk] = 1
                n += 1
                N[first[k]:last[k] + 1] += 1

        seqid_step = max(1, min(5, diff_nmax
                                // (diff_nmax_prev - diff_nmax + 1)
                                * seqid_step // 2))
        seqid += seqid_step

    for k in range(n_in):
        keep[rows[k]] = inn[k]
    return n - 1, ndiff


def msa_filter(msa, coverage=0, qid_vec=(0,), qsc=-20.0, max_seqid=90,
               ndiff=1000, filter_min_enable=0):
    """Returns (keep, filtered_order, filtered_size).

    keep: per-row flags (2 query / 1 kept / 0 dropped); filtered_order: row
    indices in shuffleSequences order (stable compaction, MsaFilter.cpp:
    557-568); filtered_size matches the reference return value.
    """
    K, L = msa.shape
    keep = np.zeros(K, np.int8)
    n_keep_total = 0

    if len(qid_vec) == 1:
        if K < filter_min_enable:
            keep[:] = 1
            keep[0] = 2
            n_keep_total = K - 1
        else:
            n, ndiff = _filter_bucket(msa, list(range(K)), keep, coverage,
                                      qid_vec[0], qsc, max_seqid, ndiff)
            n_keep_total += n
    else:
        for qid_idx in range(len(qid_vec) - 1):
            rows = [0]
            for k in range(1, K):
                nr = int(np.count_nonzero(msa[k] < NAA))
                nid = int(np.count_nonzero((msa[k] < NAA)
                                           & (msa[k] == msa[0])))
                seqid = int(np.float32(100.0)
                            * np.float32(np.float32(nid) / np.float32(nr))) \
                    if nr else 0
                if qid_vec[qid_idx] < seqid <= qid_vec[qid_idx + 1]:
                    rows.append(k)
            if len(rows) < filter_min_enable:
                for r in rows[1:]:
                    keep[r] = 1
                keep[rows[0]] = 2
                n_keep_total += len(rows) - 1
                continue
            n, ndiff = _filter_bucket(msa, rows, keep, coverage, 0, qsc,
                                      max_seqid, ndiff)
            n_keep_total += n

    filtered_order = [k for k in range(K) if keep[k] != 0]
    return keep, filtered_order, n_keep_total + 1
