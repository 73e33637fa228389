# Copy of metaeuk_tpu/data/submat.py; only the imports differ.
"""Amino-acid substitution matrix (BLOSUM62) with mmseqs-compatible scaling.

Reproduces the reference pipeline's effective integer scoring matrix:
half-bit log-odds -> probabilities (via precomputed lambda/background) ->
re-derived background -> 2-bit rescaled integer scores, matching
SubstitutionMatrix::readProbMatrix + BaseMatrix::generateSubMatrix
(reference lib/mmseqs/src/commons/SubstitutionMatrix.cpp:327-420,
BaseMatrix.cpp:97-159) with bitFactor=2.0, scoreBias=0.0 as used by the
alignment module (reference lib/mmseqs/src/alignment/Alignment.cpp:152).

The half-bit BLOSUM62 values and background frequencies below are the
standard public BLOSUM62 data (Henikoff & Henikoff 1992), identical to the
values shipped with BLAST and MMseqs2.
"""

import numpy as np

ALPHABET = "ACDEFGHIKLMNPQRSTVWYX"  # mmseqs residue order (blosum62.out row order)
ALPHABET_SIZE = 21
ANY_BACK = 1e-5  # BaseMatrix::ANY_BACK (BaseMatrix.cpp:10)

_BLOSUM62_LAMBDA = 0.34657
_BLOSUM62_BACK = [
    0.07422, 0.02469, 0.05363, 0.05431, 0.04742, 0.07415, 0.02621, 0.06792,
    0.05815, 0.09891, 0.02499, 0.04465, 0.03854, 0.03426, 0.05161, 0.05723,
    0.05089, 0.07292, 0.01303, 0.03228, 0.00001,
]

# BLOSUM62 in half-bits, row/col order = ALPHABET (A C D E F G H I K L M N P Q R S T V W Y X)
_BLOSUM62_HALFBIT = """
 3.9291 -0.4085 -1.7534 -0.8639 -2.2101  0.1596 -1.6251 -1.3218 -0.7340 -1.4646 -0.9353 -1.5307 -0.8143 -0.8040 -1.4135  1.1158 -0.0454 -0.1894 -2.5269 -1.7640 -1.0000
-0.4085  8.5821 -3.4600 -3.6125 -2.3755 -2.5004 -2.9878 -1.2277 -3.0363 -1.2775 -1.4198 -2.6598 -2.7952 -2.9019 -3.3892 -0.8750 -0.8667 -0.8077 -2.3041 -2.4071 -1.0000
-1.7534 -3.4600  5.7742  1.5103 -3.4839 -1.3135 -1.1189 -3.1212 -0.7018 -3.6057 -3.0585  1.2717 -1.4801 -0.3134 -1.6058 -0.2610 -1.0507 -3.1426 -4.2143 -3.0650 -1.0000
-0.8639 -3.6125  1.5103  4.9028 -3.1924 -2.1102 -0.1177 -3.1944  0.7753 -2.8465 -1.9980 -0.2680 -1.1162  1.8546 -0.1154 -0.1469 -0.8633 -2.4423 -2.8354 -2.0205 -1.0000
-2.2101 -2.3755 -3.4839 -3.1924  6.0461 -3.1074 -1.2342 -0.1609 -3.0787  0.4148  0.0126 -2.9940 -3.5973 -3.1644 -2.7863 -2.3690 -2.1076 -0.8490  0.9176  2.9391 -1.0000
 0.1596 -2.5004 -1.3135 -2.1102 -3.1074  5.5633 -2.0409 -3.7249 -1.5280 -3.6270 -2.6766 -0.4228 -2.1335 -1.7852 -2.3041 -0.2925 -1.5754 -3.1387 -2.4915 -3.0398 -1.0000
-1.6251 -2.9878 -1.1189 -0.1177 -1.2342 -2.0409  7.5111 -3.2316 -0.7210 -2.7867 -1.5513  0.5785 -2.1609  0.4480 -0.2499 -0.8816 -1.6859 -3.1175 -2.3422  1.6926 -1.0000
-1.3218 -1.2277 -3.1212 -3.1944 -0.1609 -3.7249 -3.2316  3.9985 -2.6701  1.5216  1.1268 -3.2170 -2.7567 -2.7696 -2.9902 -2.3482 -0.7176  2.5470 -2.5805 -1.3314 -1.0000
-0.7340 -3.0363 -0.7018  0.7753 -3.0787 -1.5280 -0.7210 -2.6701  4.5046 -2.4468 -1.3547 -0.1790 -1.0136  1.2726  2.1087 -0.2034 -0.6696 -2.2624 -2.9564 -1.8200 -1.0000
-1.4646 -1.2775 -3.6057 -2.8465  0.4148 -3.6270 -2.7867  1.5216 -2.4468  3.8494  1.9918 -3.3789 -2.8601 -2.1339 -2.1546 -2.4426 -1.1975  0.7884 -1.6319 -1.0621 -1.0000
-0.9353 -1.4198 -3.0585 -1.9980  0.0126 -2.6766 -1.5513  1.1268 -1.3547  1.9918  5.3926 -2.1509 -2.4764 -0.4210 -1.3671 -1.4809 -0.6663  0.6872 -1.4248 -0.9949 -1.0000
-1.5307 -2.6598  1.2717 -0.2680 -2.9940 -0.4228  0.5785 -3.2170 -0.1790 -3.3789 -2.1509  5.6532 -2.0004  0.0017 -0.4398  0.6009 -0.0461 -2.8763 -3.6959 -2.0818 -1.0000
-0.8143 -2.7952 -1.4801 -1.1162 -3.5973 -2.1335 -2.1609 -2.7567 -1.0136 -2.8601 -2.4764 -2.0004  7.3646 -1.2819 -2.1086 -0.8090 -1.0753 -2.3487 -3.6542 -2.9198 -1.0000
-0.8040 -2.9019 -0.3134  1.8546 -3.1644 -1.7852  0.4480 -2.7696  1.2726 -2.1339 -0.4210  0.0017 -1.2819  5.2851  0.9828 -0.1011 -0.6753 -2.1984 -1.9465 -1.4211 -1.0000
-1.4135 -3.3892 -1.6058 -0.1154 -2.7863 -2.3041 -0.2499 -2.9902  2.1087 -2.1546 -1.3671 -0.4398 -2.1086  0.9828  5.4735 -0.7648 -1.1223 -2.5026 -2.6794 -1.6939 -1.0000
 1.1158 -0.8750 -0.2610 -0.1469 -2.3690 -0.2925 -0.8816 -2.3482 -0.2034 -2.4426 -1.4809  0.6009 -0.8090 -0.1011 -0.7648  3.8844  1.3811 -1.6462 -2.7519 -1.6858 -1.0000
-0.0454 -0.8667 -1.0507 -0.8633 -2.1076 -1.5754 -1.6859 -0.7176 -0.6696 -1.1975 -0.6663 -0.0461 -1.0753 -0.6753 -1.1223  1.3811  4.5453 -0.0555 -2.4289 -1.6060 -1.0000
-0.1894 -0.8077 -3.1426 -2.4423 -0.8490 -3.1387 -3.1175  2.5470 -2.2624  0.7884  0.6872 -2.8763 -2.3487 -2.1984 -2.5026 -1.6462 -0.0555  3.7689 -2.8343 -1.2075 -1.0000
-2.5269 -2.3041 -4.2143 -2.8354  0.9176 -2.4915 -2.3422 -2.5805 -2.9564 -1.6319 -1.4248 -3.6959 -3.6542 -1.9465 -2.6794 -2.7519 -2.4289 -2.8343 10.5040  2.1542 -1.0000
-1.7640 -2.4071 -3.0650 -2.0205  2.9391 -3.0398  1.6926 -1.3314 -1.8200 -1.0621 -0.9949 -2.0818 -2.9198 -1.4211 -1.6939 -1.6858 -1.6060 -1.2075  2.1542  6.5950 -1.0000
-1.0000 -1.0000 -1.0000 -1.0000 -1.0000 -1.0000 -1.0000 -1.0000 -1.0000 -1.0000 -1.0000 -1.0000 -1.0000 -1.0000 -1.0000 -1.0000 -1.0000 -1.0000 -1.0000 -1.0000 -1.0000
"""


def _build():
    half_bit = np.array(
        [[float(x) for x in row.split()] for row in _BLOSUM62_HALFBIT.strip().split("\n")],
        dtype=np.float64,
    )
    assert half_bit.shape == (21, 21)

    lam = _BLOSUM62_LAMBDA
    p_back_file = np.array(_BLOSUM62_BACK, dtype=np.float64)
    # X scores are all <= 0 -> xIsPositive false -> scale non-X background
    # (SubstitutionMatrix.cpp:406-409)
    p_back = p_back_file.copy()
    p_back[:20] = p_back[:20] * (1.0 - p_back[20])
    # reconstruct joint probabilities (SubstitutionMatrix.cpp:413-419)
    prob = np.exp(lam * half_bit) * p_back[:, None] * p_back[None, :]
    # re-derived background with X pinned (BaseMatrix::computeBackground)
    p_back2 = prob.sum(axis=1)
    p_back2[20] = ANY_BACK
    # final scores: round-half-away-from-zero of 2*log2 odds
    sm = 2.0 * np.log2(prob / (p_back2[:, None] * p_back2[None, :]))
    scores = np.where(sm < 0.0, sm - 0.5, sm + 0.5).astype(np.int32)
    return scores, p_back, prob, p_back2


def scores_with_bias(bit_factor=2.0, bias=0.0):
    """Integer substitution scores for an arbitrary bitFactor/scoreBias,
    matching BaseMatrix::generateSubMatrix (BaseMatrix.cpp:141-159):
    round-half-away of bitFactor*log2odds + bias over the re-derived
    background. result2profile/msa2profile use (2.0, -0.2)."""
    half_bit = np.array(
        [[float(x) for x in row.split()]
         for row in _BLOSUM62_HALFBIT.strip().split("\n")], dtype=np.float64)
    lam = _BLOSUM62_LAMBDA
    p_back = np.array(_BLOSUM62_BACK, dtype=np.float64)
    p_back[:20] = p_back[:20] * (1.0 - p_back[20])
    prob = np.exp(lam * half_bit) * p_back[:, None] * p_back[None, :]
    p_back2 = prob.sum(axis=1)
    p_back2[20] = ANY_BACK
    sm = bit_factor * np.log2(prob / (p_back2[:, None] * p_back2[None, :])) \
        + bias
    return np.where(sm < 0.0, sm - 0.5, sm + 0.5).astype(np.int32)


# BLOSUM62_PBACK is the member BaseMatrix::pBack (file background scaled by
# 1-p(X), SubstitutionMatrix.cpp:406-409); BLOSUM62_PBACK_DERIVED is the
# local background generateSubMatrix re-derives as probMatrix row sums
# (BaseMatrix::computeBackground, BaseMatrix.cpp:97-107) and uses for the
# pseudocount matrix R and the integer scores.
BLOSUM62_SCORES, BLOSUM62_PBACK, BLOSUM62_PROB, BLOSUM62_PBACK_DERIVED = _build()


def _build_aa2num():
    """ASCII byte -> residue index, matching setupLetterMapping
    (SubstitutionMatrix.cpp:257-297): J->L, U/O->X, Z->E, B->D, other->X."""
    x_idx = ALPHABET.index("X")
    m = np.full(256, x_idx, dtype=np.uint8)
    for i, ch in enumerate(ALPHABET):
        m[ord(ch)] = i
        m[ord(ch.lower())] = i
    for src, dst in (("J", "L"), ("Z", "E"), ("B", "D")):
        m[ord(src)] = ALPHABET.index(dst)
        m[ord(src.lower())] = ALPHABET.index(dst)
    return m


AA2NUM = _build_aa2num()
NUM2AA = np.frombuffer(ALPHABET.encode(), dtype=np.uint8)


def encode_aa(seq_bytes):
    """Encode an ASCII AA byte string into residue indices (uint8)."""
    return AA2NUM[np.frombuffer(bytes(seq_bytes), dtype=np.uint8)]


def composition_bias(encoded_seq, scale=1.0, scores=None, pback=None):
    """Per-position composition bias correction, float32.

    Port of SubstitutionMatrix::calcLocalAaBiasCorrection
    (SubstitutionMatrix.cpp:79-109): windowed (+/-20) average substitution
    score against the local neighborhood, subtracted from the background
    expectation. Vectorized with a prefix-sum over the score rows.
    scores/pback default to BLOSUM62 (the alignment path); the prefilter
    passes the VTML80 8-bit matrix and its background.
    """
    if scores is None:
        scores = BLOSUM62_SCORES
    if pback is None:
        pback = BLOSUM62_PBACK
    n = len(encoded_seq)
    if n == 0:
        return np.zeros(0, dtype=np.float32)
    from .. import native
    lib = native.get_lib()
    if lib is not None:
        native.bind_comp_bias(lib)
        out = np.empty(n, np.float32)
        lib.comp_bias(np.ascontiguousarray(encoded_seq, np.uint8), n,
                      np.ascontiguousarray(scores, np.int32),
                      scores.shape[1], np.ascontiguousarray(pback,
                                                            np.float64),
                      float(scale), out)
        return out
    w = 20  # windowSize/2
    rows = scores[encoded_seq]  # (n, 21)
    # S[i] = sum over j in window of subMat[seq[i]][seq[j]]
    onehot_counts = np.zeros((n + 1, 21), dtype=np.int64)
    np.add.at(onehot_counts[1:], (np.arange(n), encoded_seq), 1)
    csum = np.cumsum(onehot_counts, axis=0)  # (n+1, 21)
    lo = np.maximum(0, np.arange(n) - w)
    hi = np.minimum(n, np.arange(n) + w)
    win_counts = csum[hi] - csum[lo]  # (n, 21)
    sum_sub = np.einsum("ij,ij->i", rows.astype(np.int64), win_counts)
    # remove own amino acid
    sum_sub -= rows[np.arange(n), encoded_seq]
    win_len = (hi - lo).astype(np.float64)
    # replicate the C float accumulation exactly: deltaS_i is a 32-bit float,
    # each += of a double product rounds back to float32
    delta = (sum_sub.astype(np.float32).astype(np.float64) / (-1.0 * win_len)).astype(np.float32)
    for a in range(ALPHABET_SIZE):
        term = pback[a] * rows[:, a].astype(np.float32).astype(np.float64)
        delta = (delta.astype(np.float64) + term).astype(np.float32)
    return (np.float64(scale) * delta.astype(np.float64)).astype(np.float32)


def composition_bias_rounded_batch(encoded_seqs, scale=1.0):
    """composition_bias_rounded over many fragments in ONE native call
    (OpenMP over sequences) — the per-fragment ctypes round trip costs
    more than the window sums at million-fragment scale. Returns a list
    of int8 arrays; numerically identical to the per-fragment path
    (same comp_bias inner function, same rounding)."""
    from .. import native
    lib = native.get_lib()
    if lib is None:
        return [composition_bias_rounded(e, scale) for e in encoded_seqs]
    native.bind_comp_bias(lib)
    n = len(encoded_seqs)
    offs = np.zeros(n + 1, np.int64)
    for i, e in enumerate(encoded_seqs):
        offs[i + 1] = offs[i] + len(e)
    data = (np.concatenate([np.asarray(e, np.uint8)
                            for e in encoded_seqs])
            if offs[-1] else np.zeros(0, np.uint8))
    out = np.empty(int(offs[-1]), np.int8)
    lib.comp_bias_batch_i8(
        np.ascontiguousarray(data, np.uint8), offs, n,
        np.ascontiguousarray(BLOSUM62_SCORES, np.int32),
        BLOSUM62_SCORES.shape[1],
        np.ascontiguousarray(BLOSUM62_PBACK, np.float64), float(scale),
        out)
    return [out[offs[i]:offs[i + 1]] for i in range(n)]


def composition_bias_rounded(encoded_seq, scale=1.0, scores=None):
    """int8-rounded bias as applied to the SW profile (ssw_init,
    StripedSmithWaterman.cpp:1230-1236): round half away from zero.
    scores: substitution matrix override (the --realign pass computes
    bias with the scoreBias -0.2 matrix, Alignment.cpp:158-162)."""
    b = composition_bias(encoded_seq, scale, scores=scores)
    return np.where(b < 0.0, b - 0.5, b + 0.5).astype(np.int8)
