# Copy of metaeuk_tpu/data/vtml80.py; only the imports differ.
"""VTML80 seed substitution matrix (Muller, Spang & Vingron 2002).

The k-mer seeding stage of the reference prefilter scores with VTML80 at
bitFactor 8.0 (Prefiltering.cpp:68, seedScoringMatrixFile default
Parameters.cpp:2352).  The half-bit integer table, background frequencies
and lambda below are the standard public VTML80 data as shipped in matrix
files of BLAST/MMseqs2; the score reconstruction mirrors
SubstitutionMatrix::readProbMatrix + BaseMatrix::generateSubMatrix exactly
like data/submat.py does for BLOSUM62.
"""

import numpy as np

from .submat import ANY_BACK

_VTML80_LAMBDA = 0.34657
_VTML80_BACK = [0.0786, 0.0178, 0.0476, 0.0624, 0.034, 0.0616, 0.0203, 0.0523, 0.055, 0.1045, 0.0231, 0.0402, 0.0403, 0.034, 0.0462, 0.07, 0.0572, 0.0784, 0.0158, 0.0374, 1e-05]

_VTML80_HALFBIT = """
  5   0  -2  -2  -4  -1  -3  -3  -2  -3  -2  -2  -1  -2  -3   1   0   0  -5  -4  -1
  0  10  -7  -7  -6  -3  -3  -2  -6  -5  -1  -4  -4  -6  -4   0  -2   0  -8  -1  -1
 -2  -7   7   2  -9  -2  -1  -7  -2  -8  -5   1  -2  -1  -5  -1  -2  -5  -7  -7  -1
 -2  -7   2   6  -7  -3  -2  -5   0  -5  -4  -1  -2   2  -3  -1  -2  -4  -8  -4  -1
 -4  -6  -9  -7   8  -6  -1  -1  -7   0   0  -5  -5  -4  -6  -3  -4  -2   1   3  -1
 -1  -3  -2  -3  -6   7  -3  -8  -3  -7  -6  -1  -4  -4  -3  -1  -4  -5  -5  -6  -1
 -3  -3  -1  -2  -1  -3   9  -5  -1  -3  -5   0  -3   1   0  -1  -2  -4  -2   1  -1
 -3  -2  -7  -5  -1  -8  -5   6  -5   1   1  -5  -6  -5  -5  -5  -2   3  -3  -3  -1
 -2  -6  -2   0  -7  -3  -1  -5   6  -4  -2   0  -2   1   3  -2  -1  -4  -5  -4  -1
 -3  -5  -8  -5   0  -7  -3   1  -4   5   2  -5  -4  -3  -4  -4  -3   0  -2  -2  -1
 -2  -1  -5  -4   0  -6  -5   1  -2   2   8  -4  -5  -2  -3  -4  -1   0  -6  -4  -1
 -2  -4   1  -1  -5  -1   0  -5   0  -5  -4   7  -4  -1  -2   1  -1  -5  -6  -2  -1
 -1  -4  -2  -2  -5  -4  -3  -6  -2  -4  -5  -4   8  -2  -3  -1  -2  -4  -5  -7  -1
 -2  -6  -1   2  -4  -4   1  -5   1  -3  -2  -1  -2   7   1  -1  -2  -3  -8  -5  -1
 -3  -4  -5  -3  -6  -3   0  -5   3  -4  -3  -2  -3   1   7  -2  -3  -5  -4  -3  -1
  1   0  -1  -1  -3  -1  -1  -5  -2  -4  -4   1  -1  -1  -2   5   1  -3  -4  -3  -1
  0  -2  -2  -2  -4  -4  -2  -2  -1  -3  -1  -1  -2  -2  -3   1   6  -1  -7  -4  -1
  0   0  -5  -4  -2  -5  -4   3  -4   0   0  -5  -4  -3  -5  -3  -1   5  -6  -4  -1
 -5  -8  -7  -8   1  -5  -2  -3  -5  -2  -6  -6  -5  -8  -4  -4  -7  -6  11   1  -1
 -4  -1  -7  -4   3  -6   1  -3  -4  -2  -4  -2  -7  -5  -3  -3  -4  -4   1   8  -1
 -1  -1  -1  -1  -1  -1  -1  -1  -1  -1  -1  -1  -1  -1  -1  -1  -1  -1  -1  -1  -1
"""


def _build(bit_factor):
    half_bit = np.array([[float(x) for x in r.split()]
                         for r in _VTML80_HALFBIT.strip().split("\n")],
                        dtype=np.float64)
    assert half_bit.shape == (21, 21)
    p_back = np.array(_VTML80_BACK, dtype=np.float64)
    p_back[:20] = p_back[:20] * (1.0 - p_back[20])
    prob = np.exp(_VTML80_LAMBDA * half_bit) * p_back[:, None] * p_back[None, :]
    p_back2 = prob.sum(axis=1)
    p_back2[20] = ANY_BACK
    sm = bit_factor * np.log2(prob / (p_back2[:, None] * p_back2[None, :]))
    return (np.where(sm < 0.0, sm - 0.5, sm + 0.5).astype(np.int32),
            p_back, prob)


# 8-bit-factor integer scores used for k-mer seeding and the index-table
# self-score threshold (Prefiltering.cpp:68)
VTML80_SCORES_8BIT, VTML80_PBACK, VTML80_PROB = _build(8.0)
