# Copy of metaeuk_tpu/data/submat_file.py; it differs from its original only in this note.
"""Arbitrary substitution-matrix (.out) file loading.

Replicates the reference's SubstitutionMatrix::readProbMatrix +
BaseMatrix::generateSubMatrix pipeline for user-supplied matrix files
(lib/mmseqs/src/commons/SubstitutionMatrix.cpp:327-420,
BaseMatrix.cpp:97-159): half-bit log-odds body -> joint probabilities
via the precomputed lambda/background comments -> re-derived background
-> bitFactor-scaled integer scores, same float64 arithmetic as
data/submat._build() uses for the baked-in BLOSUM62.

Rows/columns are remapped from the file's letter order into the
canonical mmseqs residue order (data/submat.ALPHABET).
"""

import numpy as np

from .submat import ALPHABET, ANY_BACK


def parse_matrix_file(text):
    """-> dict(halfbit (21,21) float64, lambda, pback_file (21,))
    in canonical ALPHABET order.  Requires the precomputed Lambda /
    Background comment lines every shipped matrix carries (matrices
    without them would need the reference's inverse-matrix lambda
    estimation, SubstitutionMatrix::estimateLambdaAndBackground)."""
    lam = None
    pback = None
    col_letters = None
    rows = {}
    for line in text.splitlines():
        if line.startswith("#"):
            if line.startswith("# Background (precomputed optional):"):
                pback = [float(x) for x in line.split()[4:]]
            elif line.startswith("# Lambda     (precomputed optional):"):
                lam = float(line.split()[4])
            continue
        words = line.split()
        if len(words) <= 1:
            continue
        if col_letters is None and all(len(w) == 1 and w.isalpha()
                                       for w in words):
            col_letters = [w.upper() for w in words]
            continue
        if col_letters is not None and words[0][0].isalpha():
            rows[words[0][0].upper()] = [float(x) for x in words[1:]]
    if lam is None or pback is None:
        raise ValueError(
            "matrix file lacks the precomputed Lambda/Background comments "
            "(runtime lambda estimation is not supported)")
    if col_letters is None or "X" not in rows:
        raise ValueError("matrix file must contain an X row/column")
    n = len(col_letters)
    # remap into canonical order; letters absent from ALPHABET are
    # folded onto X by the reference's aa2num (B/Z/J etc.)
    halfbit = np.zeros((21, 21), np.float64)
    pb = np.zeros(21, np.float64)
    canon = {c: i for i, c in enumerate(ALPHABET)}
    filepos = {c: i for i, c in enumerate(col_letters)}
    for ci, c in enumerate(ALPHABET):
        src = filepos.get(c, filepos["X"])
        pb[ci] = pback[src] if src < len(pback) else 0.0
        row = rows.get(c, rows["X"])
        for cj, c2 in enumerate(ALPHABET):
            halfbit[ci, cj] = row[filepos.get(c2, filepos["X"])]
    return dict(halfbit=halfbit, lam=lam, pback_file=pb)


def build_scores(parsed, bit_factor=2.0, bias=0.0):
    """(scores (21,21) int32, pback (21,), pback_derived (21,), prob):
    the generateSubMatrix pipeline on a parse_matrix_file result."""
    halfbit = parsed["halfbit"]
    lam = parsed["lam"]
    pback = parsed["pback_file"].copy()
    # xIsPositive is false for every shipped matrix (X column <= 0)
    x_positive = (halfbit[20, :] > 0).any() or (halfbit[:, 20] > 0).any()
    if not x_positive:
        pback[:20] = pback[:20] * (1.0 - pback[20])
    prob = np.exp(lam * halfbit) * pback[:, None] * pback[None, :]
    pback2 = prob.sum(axis=1)
    pback2[20] = ANY_BACK
    sm = bit_factor * np.log2(prob / (pback2[:, None] * pback2[None, :])) \
        + bias
    scores = np.where(sm < 0.0, sm - 0.5, sm + 0.5).astype(np.int32)
    return scores, pback, pback2, prob


def load_matrix_file(path, bit_factor=2.0, bias=0.0):
    """File path -> (scores int32 (21,21), pback (21,))."""
    with open(path) as f:
        parsed = parse_matrix_file(f.read())
    scores, pback, pback2, _ = build_scores(parsed, bit_factor, bias)
    return scores, pback
