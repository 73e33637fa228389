# Copy of metaeuk_tpu/search/prefilter_nucl.py; it differs from its original only in this note.
"""Nucleotide k-mer prefilter driver (native/prefilter_nucl.cpp).

The reference's --search-type 3 prefilter configuration: exact spaced
15-mers on a 4-letter index, tantan-masked targets, kmer threshold 0,
ungapped diagonal rescore with the scale-1.0 nucleotide matrix, and the
per-target best-diagonal consolidation (QueryMatcher.cpp:109-149).
"""

import ctypes

import numpy as np

from .. import native
from ..data.nucl import NUCL_LR, NUCL_X, encode_nucl
from ..io import mmseqsdb
from ..ops.masker import repeat_probs

MIN_DIAG_SCORE = 15   # --min-ungapped-score default
MAX_SEQS = 300

# spaced seed patterns (informative positions; Sequence.h:19-45).
# blastn (search --search-type 3) uses k=15; plain prefilter auto-detects
# k=6 for small DBs (IndexTable::computeKmerSize).
SPACED_PATTERNS = {
    6: (0, 1, 3, 5, 8, 9),
    7: (0, 1, 3, 5, 6, 9, 10),
    15: (0, 1, 2, 4, 6, 7, 8, 9, 11, 12, 16, 18, 19, 21, 22),
}


def _bind(lib):
    if getattr(lib, "_pfn_bound", False):
        return
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.pfn_create.restype = ctypes.c_void_p
    lib.pfn_create.argtypes = [i64p, ctypes.c_int64]
    lib.pfn_destroy.restype = None
    lib.pfn_destroy.argtypes = [ctypes.c_void_p]
    lib.pfn_add_targets.restype = None
    lib.pfn_add_targets.argtypes = [ctypes.c_void_p, u8p, i64p,
                                    ctypes.c_int64]
    lib.pfn_match.restype = ctypes.c_int64
    lib.pfn_match.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int64,
                              ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_uint32, u32p, i32p, i16p]
    lib._pfn_bound = True


def mask_nucl(enc, mask_prob=0.9):
    """Masker::maskSequence tantan path with the nucleotide likelihood
    ratios; masked residues -> X."""
    enc = np.array(enc, np.uint8)
    probs = repeat_probs(enc, lr=NUCL_LR)
    enc[probs >= mask_prob] = NUCL_X
    return enc


class NuclKmerPrefilter:
    def __init__(self, target_encs, mask_targets=True, mask_prob=0.9,
                 kmer_size=15, spaced=True):
        lib = native.get_lib()
        if lib is None:
            raise RuntimeError("native library required")
        _bind(lib)
        self._lib = lib
        pat = np.array(SPACED_PATTERNS[kmer_size] if spaced
                       else range(kmer_size), np.int64)
        self._h = lib.pfn_create(np.ascontiguousarray(pat), len(pat))
        self.nseq = len(target_encs)
        masked = [mask_nucl(t, mask_prob) if mask_targets
                  else np.asarray(t, np.uint8) for t in target_encs]
        data = np.concatenate([np.asarray(m, np.uint8) for m in masked]) \
            if masked else np.zeros(0, np.uint8)
        offs = np.zeros(len(masked) + 1, np.int64)
        if masked:
            offs[1:] = np.cumsum([len(m) for m in masked])
        lib.pfn_add_targets(self._h, np.ascontiguousarray(data), offs,
                            len(masked))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pfn_destroy(self._h)
            self._h = None

    def match(self, query_enc, identity_id=None, max_seqs=MAX_SEQS,
              min_diag_score=MIN_DIAG_SCORE):
        q = np.ascontiguousarray(query_enc, np.uint8)
        cap = max(self.nseq + 1, 1)
        out_id = np.zeros(cap, np.uint32)
        out_sc = np.zeros(cap, np.int32)
        out_dg = np.zeros(cap, np.int16)
        ident = 0xFFFFFFFF if identity_id is None else int(identity_id)
        n = self._lib.pfn_match(self._h, q, len(q), max_seqs,
                                min_diag_score, ident, out_id, out_sc,
                                out_dg)
        return out_id[:n], out_sc[:n], out_dg[:n]


def prefilter_nucl_db(query_db, target_db, out_db, max_seqs=MAX_SEQS,
                      min_diag_score=MIN_DIAG_SCORE, mask_targets=True,
                      kmer_size=15):
    """prefilter module over nucleotide DB triples; queries in index
    order, output lines via prefilterHitToBuffer."""
    t_entries = mmseqsdb.read_seq_entries(target_db)
    t_encs = [encode_nucl(p) for _, p in t_entries]
    t_keys = [k for k, _ in t_entries]
    pf = NuclKmerPrefilter(t_encs, mask_targets=mask_targets,
                           kmer_size=kmer_size)
    out = []
    for key, payload in mmseqsdb.read_seq_entries(query_db):
        q = encode_nucl(payload)
        ids, scores, diags = pf.match(q, max_seqs=max_seqs,
                                      min_diag_score=min_diag_score)
        lines = [f"{t_keys[i]}\t{int(s)}\t{int(d)}\n"
                 for i, s, d in zip(ids, scores, diags)]
        out.append((key, "".join(lines).encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_PREFILTER_RES)
    return out_db
