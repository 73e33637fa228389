# Copy of metaeuk_tpu/data/nucl.py; it differs from its original only in this note.
"""Nucleotide scoring (the NucleotideMatrix role).

Standard public match/mismatch matrix (+2/-3 in half-bits, lambda
0.6337314, uniform background) as shipped in nucleotide matrix files of
BLAST/MMseqs2; reconstructed to integer scores exactly like data/submat.py
does for BLOSUM62 (readProbMatrix + generateSubMatrix semantics).

Alphabet order matches the reference's nucleotide.out: A C T G X
(NucleotideMatrix.cpp:4-31; note T before G), ambiguity codes map to X.
Reverse complement swaps A<->T (0<->2) and C<->G (1<->3).
"""

import numpy as np

from .submat import ANY_BACK

NUCL_ALPHABET = "ACTGX"
_NUCL_LAMBDA = 0.6337314
_NUCL_BACK = [0.2499975, 0.2499975, 0.2499975, 0.2499975, 0.00001]
_NUCL_HALFBIT = np.array([
    [2, -3, -3, -3, -3],
    [-3, 2, -3, -3, -3],
    [-3, -3, 2, -3, -3],
    [-3, -3, -3, 2, -3],
    [-3, -3, -3, -3, -3],
], dtype=np.float64)


def _build(bit_factor):
    p_back = np.array(_NUCL_BACK, dtype=np.float64)
    p_back[:4] = p_back[:4] * (1.0 - p_back[4])
    prob = np.exp(_NUCL_LAMBDA * _NUCL_HALFBIT) \
        * p_back[:, None] * p_back[None, :]
    p_back2 = prob.sum(axis=1)
    p_back2[4] = ANY_BACK
    sm = bit_factor * np.log2(prob / (p_back2[:, None] * p_back2[None, :]))
    return np.where(sm < 0.0, sm - 0.5, sm + 0.5).astype(np.int32)


NUCL_SCORES = _build(2.0)          # alignment units (bitFactor 2.0)
NUCL_X = 4


def _prob_and_pback():
    """BaseMatrix pBack (file background scaled by 1-p(X)) and probMatrix
    (exp(lambda*S)*pb_i*pb_j, SubstitutionMatrix.cpp:406-414)."""
    p_back = np.array(_NUCL_BACK, dtype=np.float64)
    p_back[:4] = p_back[:4] * (1.0 - p_back[4])
    prob = np.exp(_NUCL_LAMBDA * _NUCL_HALFBIT) \
        * p_back[:, None] * p_back[None, :]
    return prob, p_back


NUCL_PROB, NUCL_PBACK = _prob_and_pback()
# tantan likelihood ratios for the nucleotide Masker (ProbabilityMatrix,
# BaseMatrix.h:83-96)
NUCL_LR = NUCL_PROB / (NUCL_PBACK[:, None] * NUCL_PBACK[None, :])

REVCOMP_IDX = np.array([2, 3, 0, 1, 4], dtype=np.uint8)


def _build_nucl2num():
    """ASCII -> index per NucleotideMatrix::setupLetterMapping
    (NucleotideMatrix.cpp:17-60): U/W -> T, K/B/D/V/R/S -> G,
    M/Y/H -> C, everything else (incl. N) -> X."""
    m = np.full(256, NUCL_X, dtype=np.uint8)
    groups = {"A": "A", "C": "C", "G": "G", "T": "T",
              "U": "T", "W": "T",
              "K": "G", "B": "G", "D": "G", "V": "G", "R": "G", "S": "G",
              "M": "C", "Y": "C", "H": "C"}
    for ch, base in groups.items():
        m[ord(ch)] = NUCL_ALPHABET.index(base)
        m[ord(ch.lower())] = NUCL_ALPHABET.index(base)
    return m


NUCL2NUM = _build_nucl2num()


def encode_nucl(seq_bytes):
    return NUCL2NUM[np.frombuffer(bytes(seq_bytes), dtype=np.uint8)]


def revcomp_enc(enc):
    return REVCOMP_IDX[np.asarray(enc, np.uint8)[::-1]]
