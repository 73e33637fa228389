# Copy of metaeuk_tpu/ops/csprofile.py; it differs from its original only in this note.
"""Context-specific profiles (the CS-BLAST / CSProfile role).

Replicates lib/mmseqs/src/commons/CSProfile.cpp bit-for-bit in float32:
a CRF context library (K states, window length wlen) scores every
sequence position against each state (bias + sum of per-offset context
weights, CSProfile.cpp:200-347), a softmax over states (with the
fpow2/log-sum-exp trick, CSProfile.cpp:358-421) yields posterior state
weights, and the states' pseudocount emission vectors are mixed into a
per-position amino-acid distribution which is finally admixed with the
one-hot input sequence at rate (1 - tau) (CSProfile.cpp:444-459).

The reference bakes its 4000-state K4000.crf model into the binary
(CSProfile.cpp:5-12); that blob is a missing LFS object upstream, so
here the library is loaded from a caller-supplied file in the identical
serialization format (ContextLibrary::read, CSProfile.cpp:29-160).
"""

import numpy as np

KSCALE = 1000.0  # ProfileStates.h:13

# ProfileStates::hh2mmseqsAAorder (ProfileStates.h:108-111): the library
# file stores columns in the HH alphabet order (ACDEFGHIKLMNPQRSTVWY);
# this permutation maps HH column index -> mmseqs numeric aa.
HH2MMSEQS = np.array([0, 14, 11, 2, 1, 13, 3, 5, 6, 7, 9, 8,
                      10, 4, 12, 15, 16, 18, 19, 17])

SCALING_LOG2 = np.float32(1.0 / np.log(2.0))  # CSProfile.cpp:385


class ContextLibrary:
    """Parsed CRF context library (ContextLibrary::read)."""

    def __init__(self, text):
        lines = iter(text.splitlines())
        first = next(lines)
        if not first.startswith("CRF"):
            raise ValueError("context library does not start with 'CRF'")
        self.size = _read_int(next(lines), "SIZE")
        self.wlen = _read_int(next(lines), "LENG")
        self.center = (self.wlen - 1) // 2
        bias, cw, pc = [], [], []
        for _ in range(self.size):
            b, w, p = _read_state(lines, self.wlen)
            bias.append(b)
            cw.append(w)
            pc.append(p)
        self.bias = np.array(bias, np.float32)
        # (K, wlen, 21): column 20 zeroed (CSProfile.cpp:119 writes 0.0
        # so X residues contribute nothing to the context score)
        self.context_weights = np.stack(cw)
        self.pc = np.stack(pc)  # (K, 20) float32

    @classmethod
    def from_file(cls, path):
        with open(path) as fh:
            return cls(fh.read())


def _read_int(line, label):
    i = line.find(label)
    if i < 0:
        raise ValueError(f"missing {label!r} in context library")
    return int(float(line[i + len(label):].split()[0]))


def _read_state(lines, wlen):
    """One CrfState block (ContextLibrary::readContextProfile)."""
    line = next(lines)
    while not line.startswith("CrfState"):
        line = next(lines)  # tolerate blank separators
    line = next(lines)
    if "NAME" in line:
        line = next(lines)
    i = line.find("BIAS")
    bias = np.float32(float(line[i + 4:]))
    leng = _read_int(next(lines), "LENG")
    if leng != wlen:
        raise ValueError("CRF state length != library LENG")
    nalph = _read_int(next(lines), "ALPH")
    if nalph != 20:
        raise ValueError("CRF state alphabet must be 20")
    next(lines)  # alphabet description line, skipped by the parser
    cw = np.zeros((wlen, 21), np.float32)
    pc_weight = np.zeros(21, np.float32)
    line = next(lines)
    while not line.startswith("//"):
        toks = line.split()
        vals = np.array([int(t) for t in toks[1:21]], np.float64) / KSCALE
        if line.startswith("PC"):
            pc_weight[HH2MMSEQS] = vals.astype(np.float32)
        else:
            cw[int(toks[0]) - 1, HH2MMSEQS] = vals.astype(np.float32)
        line = next(lines)
    # emission pseudocounts: softmax of pc_weight in double precision
    # with an x87 long-double running sum (CSProfile.cpp:140-159)
    w = pc_weight[:20].astype(np.float64)
    mx = w.max()
    s = np.longdouble(0.0)
    for a in range(20):
        s += np.longdouble(np.exp(w[a] - mx))
    tmp = np.float64(mx + np.log(s))
    pc = (np.finfo(np.float64).tiny + np.exp(w - tmp)).astype(np.float32)
    return bias, cw, pc


def _lane_sum(lanes):
    """score1 + score2 + score3 + score4, left-associated float32
    (the computeSeqContextScore epilogue, CSProfile.cpp:200-346)."""
    return ((lanes[0] + lanes[1]) + lanes[2]) + lanes[3]


def _context_scores(lib, enc):
    """(K, L) float32 context scores: for each state and position the
    4-lane cyclic accumulation over the clipped window, lanes indexed by
    offset *within the clipped slice* (CSProfile.cpp:208 j = beg-idx+center,
    lanes cycle score1..score4 in slice order)."""
    K, wlen, center = lib.size, lib.wlen, lib.center
    L = len(enc)
    cw = lib.context_weights  # (K, wlen, 21)
    out = np.zeros((K, L), np.float32)

    lo = min(center, L)           # positions clipped at the front
    hi = max(L - center, lo)      # first position clipped at the back
    # interior positions i in [lo, hi): full window, lane t%4
    if hi > lo and L >= wlen:
        Li = hi - lo
        lanes = np.zeros((4, K, Li), np.float32)
        for t in range(wlen):
            # seq index for offset t at position i: i - center + t
            lanes[t % 4] += cw[:, t, enc[lo - center + t: lo - center + t + Li]]
        out[:, lo:hi] = _lane_sum(lanes)
        bounds = list(range(lo)) + list(range(hi, L))
    else:
        bounds = range(L)
    for i in bounds:
        beg = max(0, i - center)
        end = min(L, i + center + 1)
        j0 = beg - i + center
        lanes = np.zeros((4, K), np.float32)
        for t in range(end - beg):
            lanes[t % 4] += cw[:, j0 + t, enc[beg + t]]
        out[:, i] = _lane_sum(lanes)
    return out


def _state_posteriors(lib, ppi):
    """Softmax over states per position with the reference's fpow2
    approximation and float32 accumulation order (CSProfile.cpp:365-421).
    Mutates and returns ppi; also returns nothing else needed."""
    from .pssm import fpow2
    K, L = ppi.shape
    maximums = ppi.max(axis=0)  # exact regardless of order
    sums = np.zeros(L, np.float32)
    for k in range(K):  # sequential k accumulation (CSProfile.cpp:387-402)
        sums += fpow2((ppi[k] - maximums) * SCALING_LOG2)
    # maximums[i] += log(sums[i]) in double, stored float (CSProfile.cpp:404)
    maximums = (maximums.astype(np.float64)
                + np.log(sums.astype(np.float64))).astype(np.float32)
    return fpow2((ppi - maximums[None, :]) * SCALING_LOG2)


def _normalize_rows_20(profile):
    """MathUtil::NormalizeTo1 on the first 20 columns of each row:
    sequential float32 sum, double reciprocal stored float32
    (MathUtil.h:241-257)."""
    L = profile.shape[0]
    s = np.zeros(L, np.float32)
    for a in range(20):
        s += profile[:, a]
    nz = s != 0
    fac = np.zeros(L, np.float32)
    fac[nz] = (np.float64(1.0) / s[nz].astype(np.float64)).astype(np.float32)
    profile[nz, :20] *= fac[nz, None]
    return profile


def compute_sequence_cs(lib, enc, tau):
    """CSProfile::computeSequenceCs: (L, 24) float32 profile rows
    (stride PROFILE_AA_SIZE+4 with zero padding, CSProfile.cpp:353-470).

    enc: numeric sequence (mmseqs aa order, X=20), uint8.
    """
    enc = np.asarray(enc, np.uint8)
    L = len(enc)
    ppi = lib.bias[:, None] + _context_scores(lib, enc)
    post = _state_posteriors(lib, ppi)  # (K, L) float32
    profile = np.zeros((L, 24), np.float32)
    for k in range(lib.size):  # sequential k (CSProfile.cpp:424-437)
        profile[:, :20] += post[k][:, None] * lib.pc[k][None, :]
    _normalize_rows_20(profile)
    # admix the one-hot sequence at rate t = 1 - tau, computed in double
    # (CSProfile.cpp:452-459); an X residue (num 20) writes the padding
    # column, which later leaks into the pssm via the stride-20 read
    tau64 = np.float64(np.float32(tau))
    t64 = 1.0 - tau64
    profile[:, :20] = (profile[:, :20].astype(np.float64)
                       * tau64).astype(np.float32)
    idx = np.arange(L)
    profile[idx, enc] = (profile[idx, enc].astype(np.float64)
                         + t64).astype(np.float32)
    _normalize_rows_20(profile)
    return profile


def _profile_context_scores(lib, counts24):
    """(K, L) float32 context scores for the PROFILE path
    (computeProfileContextScore, CSProfile.cpp:164-197). The SSE build
    loads 4 vectors of 4 floats per window column — amino acids 16..19
    never contribute (an upstream quirk of the non-AVX2 build, which the
    parity reference replicates); per column the lane-wise tree is
    (v1+v2)+(v3+v4), accumulated sequentially over the clipped window,
    and the final simdf32_hadd is (l0+l1)+(l2+l3) (simd.h:495-501)."""
    K, wlen, center = lib.size, lib.wlen, lib.center
    L = counts24.shape[0]
    cw16 = lib.context_weights[:, :, :16].reshape(K, wlen, 4, 4)
    cnt16 = np.ascontiguousarray(counts24[:, :16]).reshape(L, 4, 4)
    out = np.zeros((K, L), np.float32)

    def lanes_for(js, i0, Li):
        """vTotal lanes (K, Li, 4) over window offsets js; counts row for
        offset t at position i is i - center + t."""
        tot = np.zeros((K, Li, 4), np.float32)
        for t in js:
            c = cnt16[i0 - center + t: i0 - center + t + Li]  # (Li, 4, 4)
            w = cw16[:, t][:, None]                           # (K, 1, 4, 4)
            prod = w * c[None]                                # (K, Li, 4, 4)
            tot += (prod[:, :, 0] + prod[:, :, 1]) \
                + (prod[:, :, 2] + prod[:, :, 3])
        return tot

    lo = min(center, L)
    hi = max(L - center, lo)
    if hi > lo and L >= wlen:
        tot = lanes_for(range(wlen), lo, hi - lo)
        out[:, lo:hi] = (tot[..., 0] + tot[..., 1]) \
            + (tot[..., 2] + tot[..., 3])
        bounds = list(range(lo)) + list(range(hi, L))
    else:
        bounds = range(L)
    for i in bounds:
        beg = max(0, i - center)
        end = min(L, i + center + 1)
        js = range(beg - i + center, end - i + center)
        tot = lanes_for(js, i, 1)[:, 0]
        out[:, i] = (tot[:, 0] + tot[:, 1]) + (tot[:, 2] + tot[:, 3])
    return out


def compute_profile_cs(lib, match_weight, neff_m, pca=1.4, pcb=5.8):
    """CSProfile::computeProfileCs (CSProfile.cpp:349-351 +
    computeProfile<DBTYPE_HMM_PROFILE>): context-specific pseudocounts
    for an MSA count profile (PSSMCalculator pcmode 1,
    PSSMCalculator.cpp:177-185). Returns the (L, 20) float32 profile.

    match_weight: (L, 20) float32; neff_m: (L,) float32.
    """
    L = match_weight.shape[0]
    # fillCounteProfile: counts = matchWeight * Neff_M, stride 24 with
    # zero padding (PSSMCalculator.cpp:697-704)
    counts24 = np.zeros((L, 24), np.float32)
    counts24[:, :20] = (match_weight *
                        neff_m[:, None].astype(np.float32)).astype(np.float32)
    ppi = lib.bias[:, None] + _profile_context_scores(lib, counts24)
    post = _state_posteriors(lib, ppi)
    profile = np.zeros((L, 24), np.float32)
    for k in range(lib.size):
        profile[:, :20] += post[k][:, None] * lib.pc[k][None, :]
    _normalize_rows_20(profile)
    # tau admix with counts/Neff (CSProfile.cpp:444-451): tau in double
    # ("1.0" literals), the mix itself in float32 as
    # tau*prob + ((t*counts)/Neff)
    ratio = (neff_m.astype(np.float32)
             / np.float32(pcb)).astype(np.float32).astype(np.float64)
    tau = np.minimum(1.0, np.float64(np.float32(pca)) / (1.0 + ratio)
                     ).astype(np.float32)
    t = (np.float32(1.0) - tau).astype(np.float32)
    mixed = (tau[:, None] * profile[:, :20]).astype(np.float32) + \
        ((t[:, None] * counts24[:, :20]).astype(np.float32)
         / neff_m[:, None].astype(np.float32)).astype(np.float32)
    profile[:, :20] = mixed.astype(np.float32)
    _normalize_rows_20(profile)
    return profile[:, :20].copy()


def compute_log_pssm_from_cs(profile24, pback, bit_factor=8.0,
                             score_bias=0.0):
    """PSSMCalculator::computeLogPSSM (PSSMCalculator.cpp:259-272) as
    invoked by sequence2profile.cpp:61: the profile buffer has row
    stride 24 but is read with stride 20, so pssm bytes past the first
    position mix neighbouring rows and padding columns — replicated by
    flattening."""
    from .pssm import flog2
    L = profile24.shape[0]
    flat = profile24.reshape(-1)
    idx = np.arange(L * 20)
    aa = idx % 20
    prob = flat[idx]
    # aaProb / pBack[aa]: double division, then float32 into flog2
    ratio = (prob.astype(np.float64)
             / np.asarray(pback, np.float64)[aa]).astype(np.float32)
    val = np.float32(bit_factor) * flog2(ratio) \
        + np.float32(bit_factor) * np.float32(score_bias)
    val = np.where(val < 0, val - np.float32(0.5), val + np.float32(0.5))
    # static_cast<char>(float): cvttss2si (out-of-range/NaN -> INT_MIN),
    # truncated to the low byte
    as_int = np.full(val.shape, np.iinfo(np.int32).min, np.int64)
    ok = np.isfinite(val) & (val >= -2147483648.0) & (val < 2147483648.0)
    as_int[ok] = np.trunc(val[ok]).astype(np.int64)
    pssm_val = as_int.astype(np.int8).astype(np.float32)
    trunc = np.maximum(np.float32(-128.0),
                       np.minimum(pssm_val, np.float32(127.0)))
    return trunc.astype(np.int8).reshape(L, 20)
