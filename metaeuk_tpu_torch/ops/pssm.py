# Copy of metaeuk_tpu/ops/pssm.py; it differs from its original only in this note.
"""PSSM computation from MSAs (profile generation).

Port of the reference's PSSMCalculator
(lib/mmseqs/src/alignment/PSSMCalculator.cpp) for the default msa2profile
configuration: Henikoff position-based sequence weights (:312-372),
HHblits-style context-specific per-column weights and Neff
(computeContextSpecificWeights, :419-589, with exact division replacing
the SIMD reciprocal approximation), substitution-matrix pseudocounts
(pcmode 0, :274-283 + :383-398), the fast log2/pow2 approximations of
MathUtil (MathUtil.h:107-145) reproduced bit-level, the 8-bit log PSSM
(:259-272), and the in-place global composition-bias correction
(SubstitutionMatrix::calcGlobalAaBiasCorrection, :205-243, including its
order-dependent in-place updates).

Alphabet codes: 0-19 residues, 20 = X/ANY, 21 = GAP, 22 = ENDGAP
(MultipleAlignment.h:15-18).
"""

import numpy as np

from ..data.submat import BLOSUM62_PBACK, BLOSUM62_PBACK_DERIVED, \
    BLOSUM62_PROB

NAA = 20
ANY = 20
GAP = 21
ENDGAP = 22

PCA = 1.1
PCB = 4.1

# R[a][b] = P(a|b) (subMatrixPseudoCounts, BaseMatrix.cpp:117-122), float32
# subMatrixPseudoCounts[a][b] = P(a|b) over the re-derived background
# (BaseMatrix::generateSubMatrix, BaseMatrix.cpp:117-122), double -> float
R_PSEUDOCOUNTS = (BLOSUM62_PROB / BLOSUM62_PBACK_DERIVED[None, :]
                  ).astype(np.float32)[:20, :20]
PBACK20 = BLOSUM62_PBACK[:20]


def flog2(x):
    """MathUtil::flog2 polynomial approximation, vectorized bit-exact."""
    x = np.asarray(x, np.float32)
    out = np.full(x.shape, -128.0, np.float32)
    ok = x > 0
    xv = x[ok]
    bits = xv.view(np.int32)
    e = (((bits & 0x7F800000) >> 23) - 0x7F).astype(np.float32)
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(np.float32)
    t = m - np.float32(1.0)
    poly = t * (np.float32(1.441740) + t * (np.float32(-0.7077702) + t * (
        np.float32(0.4123442) + t * (np.float32(-0.1903190) +
                                     t * np.float32(0.0440047)))))
    out[ok] = poly + e
    return out if out.shape else float(out)


def fpow2(x):
    """MathUtil::fpow2 polynomial approximation, vectorized bit-exact."""
    x = np.asarray(x, np.float32)
    out = np.empty(x.shape, np.float32)
    hi = x >= 128
    lo = x <= -125
    mid = ~(hi | lo)
    out[hi] = np.finfo(np.float32).max
    out[lo] = 0.0
    xv = x[mid]
    tx = (xv - np.float32(0.5)) + np.float32(3 << 22)
    lx = tx.view(np.int32) - 0x4B400000
    dx = xv - lx.astype(np.float32)
    y = np.float32(1.0) + dx * (np.float32(0.693019) + dx * (
        np.float32(0.241404) + dx * (np.float32(0.0520749) +
                                     dx * np.float32(0.0134929))))
    bits = y.view(np.int32) + (lx << 23)
    out[mid] = bits.view(np.float32)
    return out if out.shape else float(out)


def _normalize_to_1(row, pback=None):
    """MathUtil::NormalizeTo1 with sequential f32 sum semantics."""
    s = np.float32(0.0)
    for v in row:
        s = np.float32(s + np.float32(v))
    if s != 0:
        fac = np.float32(np.float64(1.0) / s)
        return (row * fac).astype(np.float32)
    if pback is not None:
        return np.asarray(pback, np.float32).copy()
    return row


def compute_sequence_weights(msa):
    """Henikoff weights (computeSequenceWeights); msa: (K, L) uint8."""
    K, L = msa.shape
    w = np.full(K, np.float32(1e-6), np.float32)
    is_res = msa != GAP
    number_res = is_res.sum(axis=1).astype(np.float32)
    for pos in range(L):
        col = msa[:, pos]
        resk = col != GAP
        aa = col[resk]
        nl = np.bincount(aa[aa < NAA], minlength=NAA)
        distinct = int((nl > 0).sum())
        if distinct == 0:
            continue
        contrib = np.zeros(K, np.float32)
        sel = resk & (col < NAA)
        denom = (nl[col[sel]].astype(np.float32) * np.float32(distinct)
                 * (number_res[sel] + np.float32(30.0)))
        contrib[sel] = (np.float32(1.0) / denom).astype(np.float32)
        w = (w + contrib).astype(np.float32)
    return w


def compute_context_specific_weights(msa, wg):
    """computeContextSpecificWeights: (matchWeight (L,20), Neff_M (L,)).

    msa is modified like the reference (endgaps inserted/removed around the
    call); wg: normalized global weights.
    """
    MAXENDGAPFRAC = 0.1
    NCOLMIN = 20
    K, L = msa.shape
    X = msa.copy()
    # insert endgaps
    for k in range(K):
        i = 0
        while i < L and X[k, i] == GAP:
            X[k, i] = ENDGAP
            i += 1
        i = L - 1
        while i >= 0 and X[k, i] == GAP:
            X[k, i] = ENDGAP
            i -= 1

    n = np.zeros((L, NAA + 3), np.int64)      # counts per column per symbol
    included = np.zeros(K, bool)
    nseqi = 0
    match_weight = np.zeros((L, NAA), np.float32)
    neff_m = np.zeros(L, np.float32)
    sym = X.astype(np.int64)
    last_wi = np.zeros(K, np.float32)

    for i in range(L):
        inc = X[:, i] < ANY
        change = False
        newly_in = inc & ~included
        newly_out = ~inc & included
        if newly_in.any() or newly_out.any():
            change = True
            for k in np.flatnonzero(newly_in):
                np.add.at(n, (np.arange(L), sym[k]), 1)
                nseqi += 1
            for k in np.flatnonzero(newly_out):
                np.add.at(n, (np.arange(L), sym[k]), -1)
                nseqi -= 1
            included = inc.copy()

        if change:
            wi = np.full(K, np.float32(1e-8), np.float32)
            jmin = 0
            while jmin < L and n[jmin, ENDGAP] > MAXENDGAPFRAC * nseqi:
                jmin += 1
            jmax = L - 1
            while jmax >= 0 and n[jmax, ENDGAP] > MAXENDGAPFRAC * nseqi:
                jmax -= 1
            ncol = jmax - jmin + 1
            if ncol < NCOLMIN:
                wi = np.where(inc, wg, np.float32(0.0)).astype(np.float32)
            else:
                cols = slice(jmin, jmax + 1)
                naa = (n[cols, :ANY] > 0).sum(axis=1)
                w_contrib = np.zeros((L, NAA + 3), np.float32)
                denom = (n[cols, :ANY].astype(np.float32)
                         * naa[:, None].astype(np.float32))
                # reference: hardware rcpps + one Newton-Raphson step
                # (PSSMCalculator.cpp:506-520) -- not an exact division
                from .. import native
                approx = native.rcp_nr(denom)
                with np.errstate(divide="ignore", invalid="ignore"):
                    wc = approx if approx is not None \
                        else (np.float32(1.0) / denom)
                    wc = np.where(denom > 0, wc, np.float32(0.0)
                                  ).astype(np.float32)
                w_contrib[cols, :ANY] = wc
                # wi[k] += w_contrib[j][X[k][j]], strictly sequential f32
                # adds like the reference scalar loop (np.add.accumulate is
                # left-to-right; numpy .sum() is pairwise/unrolled and can
                # round differently)
                for k in np.flatnonzero(inc):
                    terms = w_contrib[np.arange(jmin, jmax + 1),
                                      sym[k, jmin:jmax + 1]]
                    acc = np.concatenate(([wi[k]], terms)).astype(np.float32)
                    wi[k] = np.add.accumulate(acc, dtype=np.float32)[-1]
            # Neff over subalignment columns
            f = np.zeros((L, NAA + 3), np.float32)
            for k in np.flatnonzero(inc):
                np.add.at(f, (np.arange(jmin, jmax + 1),
                              sym[k, jmin:jmax + 1]), wi[k])
            # Neff_M[i] -= f[j][a]*flog2(f[j][a]) is one running scalar over
            # all (j, a): keep strict sequential f32 subtraction order
            neff_terms = []
            for j in range(jmin, jmax + 1):
                row = _normalize_to_1(f[j, :NAA])
                mask = row > 1e-10
                if mask.any():
                    neff_terms.append((row[mask] *
                                       flog2(row[mask])).astype(np.float32))
            if neff_terms:
                acc = np.concatenate([[np.float32(0.0)]] + neff_terms
                                     ).astype(np.float32)
                neff = np.subtract.accumulate(acc, dtype=np.float32)[-1]
            else:
                neff = np.float32(0.0)
            if ncol > 0:
                neff_m[i] = fpow2(np.float32(neff / np.float32(ncol)))
            else:
                neff_m[i] = 1.0
            last_wi = wi
        else:
            neff_m[i] = neff_m[i - 1] if i > 0 else np.float32(0.0)
            wi = last_wi

        row = np.zeros(NAA + 3, np.float32)
        np.add.at(row, sym[:, i], wi)
        match_weight[i] = _normalize_to_1(row[:NAA], PBACK20)
    return match_weight, neff_m


def compute_match_weights(msa, seq_weight):
    """computeMatchWeights (PSSMCalculator.cpp:396-410, the --wg 1
    branch): per column, the globally-weighted residue frequencies,
    normalized to 1 with the pBack fallback. float32 accumulation in
    k order via unbuffered np.add.at (per-cell add order is k-ascending,
    matching the reference loop)."""
    K, L = msa.shape
    match_weight = np.zeros((L, NAA), np.float32)
    ks, ls = np.nonzero((msa != GAP) & (msa < NAA))
    np.add.at(match_weight, (ls, msa[ks, ls]),
              np.asarray(seq_weight, np.float32)[ks])
    for pos in range(L):
        match_weight[pos] = _normalize_to_1(match_weight[pos], PBACK20)
    return match_weight


def compute_neff_m_global(msa, match_weight, seq_weight):
    """computeNeff_M (PSSMCalculator.cpp:283-309): per-column effective
    sequence number from the global weights. Bit-faithful float32
    accumulation order (aa-major inner sums, pos-major outer)."""
    K, L = msa.shape
    neff_hmm = np.float32(0.0)
    for pos in range(L):
        s = np.float32(0.0)
        for aa in range(NAA):
            f = match_weight[pos, aa]
            if f > 1e-10:
                s = np.float32(s - np.float32(f * flog2(f)))
        neff_hmm = np.float32(neff_hmm + fpow2(s))
    neff_hmm = np.float32(neff_hmm / np.float32(L))
    nlim = np.float32(max(10.0, float(neff_hmm) + 1.0))
    scale = flog2(np.float32(
        np.float64(np.float32(nlim - neff_hmm)) / (np.float64(nlim) - 1.0)))
    sw = np.asarray(seq_weight, np.float32)
    neff_m = np.zeros(L, np.float32)
    for pos in range(L):
        w_m = np.float32(-1.0 / K)
        col = msa[:, pos]
        for k in range(K):
            if col[k] != GAP:
                w_m = np.float32(w_m + sw[k])
        if w_m < 0:
            neff_m[pos] = np.float32(1.0)
        else:
            neff_m[pos] = np.float32(
                np.float64(nlim) - (np.float64(nlim) - 1.0)
                * np.float64(fpow2(np.float32(scale * w_m))))
    return neff_m


def compute_pssm_from_msa(msa, wg_mode=False, pcmode=0, context_lib=None):
    """computePSSMFromMSA (pca/pcb defaults, scoreBias 0).

    msa: (K, L) uint8 in internal codes. Returns dict with pssm (L,20) int8,
    profile, neff, consensus indices.

    pcmode 1 (PCMODE_CONTEXT_SPECIFIC) mixes CRF context-library
    pseudocounts instead of substitution-matrix ones
    (PSSMCalculator.cpp:177-185); context_lib is then required (the
    reference bakes K4000.crf into the binary — a missing LFS blob
    upstream, so it is caller-supplied here).
    """
    K, L = msa.shape
    seq_weight = compute_sequence_weights(msa)
    total = np.float32(0.0)
    for v in seq_weight:
        total = np.float32(total + v)
    seq_weight = _normalize_to_1(seq_weight)
    if not wg_mode:
        match_weight, neff_m = compute_context_specific_weights(msa, seq_weight)
    else:
        # --wg 1: global sequence weighting (PSSMCalculator.cpp:161-168)
        match_weight = compute_match_weights(msa, seq_weight)
        neff_m = compute_neff_m_global(msa, match_weight, seq_weight)

    # consensus (computeConsensusSequence, :651-665)
    consensus = np.full(L, ANY, np.int64)
    for pos in range(L):
        maxw = np.float32(1e-8)
        maxa = ANY
        for aa in range(NAA):
            d = np.float32(match_weight[pos, aa] - np.float32(PBACK20[aa]))
            if d > maxw:
                maxw = d
                maxa = aa
        consensus[pos] = maxa

    if pcmode == 1:
        # context-specific pseudocounts (PCMODE_CONTEXT_SPECIFIC):
        # fillCounteProfile + CSProfile::computeProfileCs, pca/pcb .cs()
        # defaults 1.4/5.8 (Parameters.cpp:2497-2498)
        from .csprofile import compute_profile_cs
        if context_lib is None:
            raise ValueError("pcmode 1 requires a CRF context library")
        profile = compute_profile_cs(context_lib, match_weight, neff_m)
        log_prob = flog2((profile / PBACK20[None, :].astype(np.float32)
                          ).astype(np.float32))
        val = np.float32(8.0) * log_prob
        val = np.where(val < 0, val - np.float32(0.5), val + np.float32(0.5))
        pssm = np.clip(val.astype(np.int64).astype(np.float32), -128, 127)
        return dict(pssm=pssm.astype(np.int8), profile=profile, neff=neff_m,
                    consensus=consensus)

    # substitution pseudocounts: ScalarProd20(R[aa], freq) with the exact
    # SSE reduction tree (lib/simd/simd.h:901-955):
    #   r[j] = ((p[j]+p[4+j]) + (p[8+j]+p[12+j])) + p[16+j],
    #   res  = (r[3]+r[2]) + (r[1]+r[0])
    prods = (match_weight[:, None, :] * R_PSEUDOCOUNTS[None, :, :]
             ).astype(np.float32)                    # (L, 20aa, 20b)
    p = prods.reshape(L, NAA, 5, 4)
    r = (((p[:, :, 0] + p[:, :, 1]) + (p[:, :, 2] + p[:, :, 3]))
         + p[:, :, 4]).astype(np.float32)            # (L, 20aa, 4)
    pc = ((r[:, :, 3] + r[:, :, 2]) + (r[:, :, 1] + r[:, :, 0])
          ).astype(np.float32)

    # computePseudoCounts (PSSMCalculator.cpp:375-394): tau and (1.0 - tau)
    # are evaluated in double (the 1.0 literals), Neff/pcb in float
    ratio = (neff_m / np.float32(PCB)).astype(np.float32).astype(np.float64)
    tau = np.minimum(1.0, np.float64(np.float32(PCA)) / (1.0 + ratio)
                     ).astype(np.float32)
    freq_signal = ((1.0 - tau.astype(np.float64))[:, None]
                   * match_weight.astype(np.float64)).astype(np.float32)
    pseudo = (tau[:, None] * pc).astype(np.float32)
    profile = (freq_signal + pseudo).astype(np.float32)

    # log PSSM (computeLogPSSM, bitFactor 8, scoreBias 0)
    log_prob = flog2((profile / PBACK20[None, :].astype(np.float32)
                      ).astype(np.float32))
    val = np.float32(8.0) * log_prob
    val = np.where(val < 0, val - np.float32(0.5), val + np.float32(0.5))
    pssm = np.clip(val.astype(np.int64).astype(np.float32), -128, 127)
    pssm = pssm.astype(np.int8)
    return dict(pssm=pssm, profile=profile, neff=neff_m, consensus=consensus)


def global_aa_bias_correction(pssm):
    """SubstitutionMatrix::calcGlobalAaBiasCorrection — in place, including
    its sequential order dependence (later windows see corrected rows)."""
    N = pssm.shape[0]
    scores = pssm.astype(np.int64).copy()
    pnull = np.zeros(N, np.float32)
    for pos in range(N):
        s = np.float32(0.0)
        for aa in range(NAA):
            s = np.float32(s + np.float32(PBACK20[aa] *
                                          np.float32(scores[pos, aa])))
        pnull[pos] = s
    w = 20
    for i in range(N):
        lo, hi = max(0, i - w), min(N, i + w)
        aa_sum = np.zeros(NAA, np.float32)
        for j in range(lo, hi):
            if j == i:
                continue
            aa_sum = (aa_sum + (scores[j].astype(np.float32) - pnull[j])
                      ).astype(np.float32)
        win_len = hi - lo
        corr = (scores[i].astype(np.float32) - aa_sum / np.float32(win_len))
        scores[i] = corr.astype(np.int64)  # C int truncation
    return np.clip(scores, -128, 127).astype(np.int8)


def convert_neff_to_char(neff):
    """MathUtil::convertNeffToChar (MathUtil.h:216-219).

    The float->unsigned char cast is out-of-range (UB) for small neff; the
    reference binary's behavior is empirically: the constant-folded
    flog2(x<=0)=-128 branch yields 1, while runtime negative values
    truncate toward zero and keep the low byte (e.g. retVal -36.5 -> 220).
    """
    if np.float32(neff) <= np.float32(0.0):
        return 1
    v = np.minimum(np.float32(255.0),
                   np.float32(1.0) + np.float32(64.0) * flog2(np.float32(neff)))
    return max(1, int(np.float32(v) + np.float32(0.5)) & 0xFF)


def profile_to_buffer(pssm, query_seq, consensus, neff):
    """PSSMCalculator::Profile::toBuffer (PSSMCalculator.cpp:671-687):
    25 bytes per position."""
    L = pssm.shape[0]
    out = np.zeros((L, 25), np.uint8)
    out[:, :20] = pssm.view(np.uint8)
    out[:, 20] = query_seq
    out[:, 21] = consensus
    for pos in range(L):
        out[pos, 22] = convert_neff_to_char(neff[pos])
    return out.tobytes()
