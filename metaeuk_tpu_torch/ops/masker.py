# Copy of metaeuk_tpu/ops/masker.py; only the imports differ.
"""Low-complexity / tandem-repeat masking (the tantan role).

Wraps the native tantan port (native/host_ops.cpp tantan_repeat_probs —
the no-gap forward/backward path used by Masker::maskSequence,
lib/mmseqs/src/commons/Masker.cpp:21-33, parameters maxCycleLength=50,
repeatProb=0.005, repeatEndProb=0.05, decay=0.9) and masks residues whose
repeat posterior reaches --mask-prob (default 0.9) to X, as the reference
does when building the prefilter index (IndexBuilder + --mask-mode 1).
"""

import ctypes

import numpy as np

from ..data.submat import ALPHABET_SIZE, BLOSUM62_PBACK, BLOSUM62_PROB
from .. import native

# likelihoodRatio[x][y] = P(x,y) / (P(x)P(y))  (ProbabilityMatrix,
# commons/BaseMatrix.h:83-96)
LIKELIHOOD_RATIO = (BLOSUM62_PROB /
                    (BLOSUM62_PBACK[:, None] * BLOSUM62_PBACK[None, :]))

MAX_CYCLE_LENGTH = 50
REPEAT_PROB = 0.005
REPEAT_END_PROB = 0.05
DECAY = 0.9
X_INDEX = 20


def _bind(lib):
    if getattr(lib, "_tantan_bound", False):
        return
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.tantan_repeat_probs.restype = None
    lib.tantan_repeat_probs.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, f64p,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, f32p]
    lib._tantan_bound = True


def repeat_probs(enc, lr=None):
    """Per-position repeat posterior (float32) for an encoded sequence.

    lr: likelihood-ratio matrix; defaults to the BLOSUM62-based one (the
    reference's Masker uses whatever subMat it was constructed with -- the
    prefilter index build passes the VTML80-based ratios)."""
    if lr is None:
        lr = LIKELIHOOD_RATIO
    enc = np.ascontiguousarray(enc, np.uint8)
    n = len(enc)
    out = np.zeros(n, np.float32)
    if n == 0:
        return out
    lib = native.get_lib()
    if lib is None:
        return _repeat_probs_py(enc, lr)
    _bind(lib)
    # the lr row stride IS the alphabet size: a 5x5 nucleotide matrix must
    # not be walked with the 21-letter aa stride (out-of-bounds reads)
    lib.tantan_repeat_probs(enc, n, lr.shape[0], MAX_CYCLE_LENGTH,
                            np.ascontiguousarray(lr),
                            REPEAT_PROB, REPEAT_END_PROB, DECAY, out)
    return out


def _repeat_probs_py(enc, lr=None):
    """Python fallback (same algorithm, used for cross-checking)."""
    if lr is None:
        lr = LIKELIHOOD_RATIO
    n = len(enc)
    b2b = 1 - REPEAT_PROB
    f2b = REPEAT_END_PROB
    f2f0 = 1 - REPEAT_END_PROB
    m = MAX_CYCLE_LENGTH
    first = (1 - DECAY) / (1 - DECAY ** m)
    b2f = REPEAT_PROB * first * DECAY ** np.arange(m)
    fg = np.zeros(m)
    probs = np.zeros(n, np.float32)
    scales = np.ones(n // 16)
    background = 1.0
    for pos in range(n):
        lr_row = lr[enc[pos]]
        mo = min(pos, m)
        from_fg = fg.sum()
        new = np.zeros(m)
        if mo:
            prev = enc[pos - mo:pos][::-1]  # offsets 1..mo back
            new[:mo] = (background * b2f[:mo] + fg[:mo] * f2f0) * lr_row[prev]
        fg = new
        background = background * b2b + from_fg * f2b
        if pos % 16 == 15:
            s = 1 / background
            scales[pos // 16] = s
            background *= s
            fg *= s
        probs[pos] = np.float32(background)
    z = background * b2b + fg.sum() * f2b
    background = b2b
    fg = np.full(m, f2b)
    for pos in range(n - 1, -1, -1):
        non_repeat = probs[pos] * background / z
        probs[pos] = 1 - np.float32(non_repeat)
        if pos % 16 == 15:
            s = scales[pos // 16]
            background *= s
            fg *= s
        lr_row = lr[enc[pos]]
        mo = min(pos, m)
        to_bg = f2b * background
        to_fg = 0.0
        for i in range(mo):
            f = fg[i] * lr_row[enc[pos - i - 1]]
            to_fg += b2f[i] * f
            fg[i] = to_bg + f2f0 * f
        for i in range(mo, m):
            fg[i] = to_bg
        background = b2b * background + to_fg
    return probs


def mask_sequence(enc, mask_prob=0.9, lr=None):
    """Returns a masked copy (repeats -> X) + masked-residue count."""
    enc = np.asarray(enc)
    probs = repeat_probs(enc, lr)
    mask = probs >= np.float32(mask_prob)
    out = np.where(mask, np.uint8(X_INDEX), enc.astype(np.uint8))
    return out, int(mask.sum())
