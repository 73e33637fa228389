# Copy of metaeuk_tpu/search/prefilter_kmer.py; only the imports differ, and
# a METAEUK_DIST_TMP target split counts the processes of the torch process
# group (parallel/multihost.py) where the original asks jax.
"""Sensitivity-calibrated k-mer prefilter (the reference's default mode).

Python driver for native/prefilter.cpp: similar-k-mer seeding over spaced
6-mers (VTML80 at bitFactor 8), double-diagonal match detection, and
ungapped diagonal rescoring — semantics matching
lib/mmseqs/src/prefiltering/ (Prefiltering.cpp, KmerGenerator.cpp,
IndexTable.h, CacheFriendlyOperations.cpp, UngappedAlignment.cpp,
QueryMatcher.cpp) for byte-identical prefilter result DBs.

Defaults mirror the reference: sensitivity 4.0 -> kmerThr
int(163.2 - 4*8.917) = 127 (Prefiltering::getKmerThreshold k=6 path),
maxResListLen 300, minDiagScoreThr 15, target tantan masking at 0.9 with
the VTML80-derived likelihood ratios, composition-bias correction on.
"""

import ctypes

import numpy as np

from ..data.submat import composition_bias, scores_with_bias
from ..data.vtml80 import VTML80_PBACK, VTML80_PROB, VTML80_SCORES_8BIT
from ..ops.masker import mask_sequence
from .. import native

# the prefilter's matrices both carry scoreBias -0.2
# (Prefiltering::getSubstitutionMatrix, Prefiltering.cpp:978-994); the
# bias never changes the near-integer VTML80 8-bit scores but does shift
# the BLOSUM62 2-bit ungapped matrix
UNGAPPED_SCORES = scores_with_bias(2.0, -0.2)

VTML80_LR = VTML80_PROB / (VTML80_PBACK[:, None] * VTML80_PBACK[None, :])


# queries per native batch call: bounds per-call result-buffer growth and
# gives the chunk loop progress ticks at scale (queries are independent,
# so chunking cannot change per-query outputs)
BATCH_CHUNK = 50_000


def compute_kmer_size(total_residues):
    """IndexTable::computeKmerSize (IndexTable.h:439-449): 6 below
    3.35G target residues, 7 above."""
    return 6 if total_residues < 3_350_000_000 else 7


def kmer_threshold(sensitivity=4.0, kmer_size=6):
    """Prefiltering::getKmerThreshold, amino-acid branch
    (Prefiltering.cpp:1049-1064)."""
    base = {5: 160.75, 6: 163.2, 7: 186.15}[kmer_size]
    per = {5: 12.75, 6: 8.917, 7: 11.22}[kmer_size]
    return int(np.float32(base) - np.float32(sensitivity) * np.float32(per))


def profile_kmer_threshold(sensitivity=4.0, kmer_size=6,
                           context_pseudo_cnts=False):
    """Prefiltering::getKmerThreshold, profile branch
    (Prefiltering.cpp:1019-1048); context_pseudo_cnts reflects the
    DBTYPE_EXTENDED_CONTEXT_PSEUDO_COUNTS bit on either side."""
    if context_pseudo_cnts:
        base = {5: 97.75, 6: 132.75, 7: 158.75}[kmer_size]
        per = {5: 8.75, 6: 8.75, 7: 9.75}[kmer_size]
    else:
        base = {5: 108.8, 6: 134.35, 7: 149.15}[kmer_size]
        per = {5: 4.7, 6: 6.15, 7: 6.85}[kmer_size]
    return int(np.float32(base) - np.float32(sensitivity) * np.float32(per))


def _bind(lib):
    if getattr(lib, "_pf_bound", False):
        return
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i16op = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.pf_create2.restype = ctypes.c_void_p
    lib.pf_create2.argtypes = [i16p, i16p, ctypes.c_int64, ctypes.c_int64]
    lib.pf_destroy.restype = None
    lib.pf_destroy.argtypes = [ctypes.c_void_p]
    lib.pf_add_targets.restype = None
    lib.pf_add_targets.argtypes = [ctypes.c_void_p, u8p, i64p, ctypes.c_int64]
    lib.pf_n_entries.restype = ctypes.c_int64
    lib.pf_n_entries.argtypes = [ctypes.c_void_p]
    lib.pf_match.restype = ctypes.c_int64
    lib.pf_match.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int64, f32p,
                             ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32,
                             u32p, i32p, i16op]
    lib.pf_match_count.restype = ctypes.c_int64
    lib.pf_match_count.argtypes = lib.pf_match.argtypes
    lib.pf_save_index.restype = ctypes.c_int64
    lib.pf_save_index.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pf_load_index.restype = ctypes.c_int64
    lib.pf_load_index.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    lib.pf_match_profile.restype = ctypes.c_int64
    lib.pf_match_profile.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_int64, i16p, i8p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32, u32p, i32p, i16op]
    lib.pf_scratch_new.restype = ctypes.c_void_p
    lib.pf_scratch_new.argtypes = [ctypes.c_void_p]
    lib.pf_scratch_free.restype = None
    lib.pf_scratch_free.argtypes = [ctypes.c_void_p]
    lib.pf_match_profile_sc.restype = ctypes.c_int64
    lib.pf_match_profile_sc.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, u8p, ctypes.c_int64, i16p, i8p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32,
        u32p, i32p, i16op]
    lib._pf_bound = True


class KmerPrefilter:
    """Holds the k-mer index over one (masked) target set."""

    def __init__(self, target_encs, sensitivity=4.0, mask_targets=True,
                 max_res_list_len=300, min_diag_score=15,
                 comp_bias_correction=True, kmer_score=None,
                 index_path=None, diagonal_scoring=True, kmer_size=6):
        lib = native.get_lib()
        if lib is None:
            raise RuntimeError("k-mer prefilter requires the native library")
        _bind(lib)
        self._lib = lib
        self.kmer_size = int(kmer_size)
        self.kmer_thr = kmer_score if kmer_score is not None \
            else kmer_threshold(sensitivity, self.kmer_size)
        self.max_hits = max_res_list_len
        self.min_diag_score = min_diag_score
        self.comp_bias_correction = comp_bias_correction
        self.diagonal_scoring = diagonal_scoring
        vt = np.ascontiguousarray(VTML80_SCORES_8BIT, np.int16)
        bl = np.ascontiguousarray(UNGAPPED_SCORES, np.int16)
        self._h = lib.pf_create2(vt, bl, self.kmer_thr, self.kmer_size)
        if target_encs is None:
            # load a createindex artifact instead of building
            n = lib.pf_load_index(self._h, str(index_path).encode())
            if n < 0:
                raise RuntimeError(f"cannot load index {index_path} "
                                   f"(rc {n}; threshold mismatch?)")
            self.n_targets = int(n)
            return
        self.n_targets = len(target_encs)
        masked = []
        for enc in target_encs:
            enc = np.asarray(enc, np.uint8)
            if mask_targets:
                enc, _ = mask_sequence(enc, 0.9, VTML80_LR)
            masked.append(enc)
        offs = np.zeros(len(masked) + 1, np.int64)
        for i, m in enumerate(masked):
            offs[i + 1] = offs[i] + len(m)
        data = np.concatenate(masked) if masked else np.zeros(0, np.uint8)
        lib.pf_add_targets(self._h, np.ascontiguousarray(data, np.uint8),
                           offs, len(masked))
        from ..utils import log
        log.MemoryTracker.track(
            "kmer index (offsets+entries+targets)",
            kspace_bytes(self.kmer_size) + 9 * int(offs[-1]))

    def save_index(self, path):
        """Serialize the built index (the createindex artifact role)."""
        rc = self._lib.pf_save_index(self._h, str(path).encode())
        if rc != 0:
            raise RuntimeError(f"cannot write index {path}")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pf_destroy(self._h)
            self._h = None

    def match(self, query_enc, identity_id=None):
        """Hits for one query: (ids, scores, diagonals) in reference
        output order (score desc, id asc; identity hit first)."""
        q = np.ascontiguousarray(query_enc, np.uint8)
        if self.comp_bias_correction:
            bias = composition_bias(q, 1.0, VTML80_SCORES_8BIT, VTML80_PBACK)
        else:
            bias = np.zeros(len(q), np.float32)
        cap = max(self.max_hits + 1, 1)
        out_id = np.empty(cap, np.uint32)
        out_sc = np.empty(cap, np.int32)
        out_dg = np.empty(cap, np.int16)
        match_fn = self._lib.pf_match if self.diagonal_scoring \
            else self._lib.pf_match_count
        n = match_fn(
            self._h, q, len(q), np.ascontiguousarray(bias, np.float32),
            self.max_hits, self.min_diag_score,
            0xFFFFFFFF if identity_id is None else int(identity_id),
            out_id, out_sc, out_dg)
        if n < 0:
            raise RuntimeError("prefilter match overflow (db too large for "
                               "the non-overflow path)")
        return out_id[:n].copy(), out_sc[:n].copy(), out_dg[:n].copy()

    def match_batch(self, query_encs, identity_ids=None):
        """Batched match: one native call for all queries (composition
        bias computed in C++), eliminating the per-query Python/ctypes
        round trip. Returns [(ids, scores, diags)] per query in the same
        order/content as per-query match()."""
        counts, ids, scs, dgs = self.match_batch_flat(query_encs,
                                                      identity_ids)
        offs = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        return [(ids[offs[i]:offs[i + 1]], scs[offs[i]:offs[i + 1]],
                 dgs[offs[i]:offs[i + 1]]) for i in range(len(counts))]

    def match_batch_flat(self, query_encs, identity_ids=None):
        """Batched match with dense outputs: (counts, ids, scores, diags)
        where ids/scores/diags concatenate the per-query hit lists in
        query order. Compact per-thread result buffers
        (pf_match_batch_compact) instead of (nq, cap) row-major blocks —
        the sparse first-touch page faults of those blocks dominated
        batch runtime and their footprint forbids million-query runs.
        Queries are independent, so the set is processed in fixed-size
        native chunks with progress ticks between them (Debug::Progress
        role) — per-query outputs are unchanged."""
        from ..utils import log
        nq = len(query_encs)
        chunk = BATCH_CHUNK
        if nq <= chunk:
            return self._match_chunk(query_encs, identity_ids)
        prog = log.progress(nq, "prefilter queries")
        outs = []
        stats = np.zeros(5, np.int64)
        for s in range(0, nq, chunk):
            ids_c = identity_ids[s:s + chunk] \
                if identity_ids is not None else None
            outs.append(self._match_chunk(query_encs[s:s + chunk], ids_c))
            stats += self.stats
            prog.update(len(outs[-1][0]))
        prog.finish()
        self.stats = stats
        return tuple(np.concatenate([o[k] for o in outs])
                     for k in range(4))

    def _match_chunk(self, query_encs, identity_ids=None):
        lib = self._lib
        if not getattr(lib, "_batch_bound", False):
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            lib.pf_match_batch_compact.restype = ctypes.c_int64
            lib.pf_match_batch_compact.argtypes = [
                ctypes.c_void_p, u8p, i64p, ctypes.c_int64,
                ctypes.c_void_p, f64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, i64p, i64p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int16))]
            lib.pf_free_results.restype = None
            lib.pf_free_results.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int16)]
            lib._batch_bound = True
        nq = len(query_encs)
        offs = np.zeros(nq + 1, np.int64)
        for i, q in enumerate(query_encs):
            offs[i + 1] = offs[i] + len(q)
        qdata = (np.concatenate([np.asarray(q, np.uint8)
                                 for q in query_encs])
                 if nq else np.zeros(0, np.uint8))
        qdata = np.ascontiguousarray(qdata, np.uint8)
        counts = np.empty(nq, np.int64)
        scores_arr = (np.ascontiguousarray(VTML80_SCORES_8BIT, np.int32)
                      if self.comp_bias_correction else None)
        ids_arr = (np.ascontiguousarray(identity_ids, np.uint32)
                   if identity_ids is not None else None)
        run_stats = np.zeros(5, np.int64)
        p_ids = ctypes.POINTER(ctypes.c_uint32)()
        p_scs = ctypes.POINTER(ctypes.c_int32)()
        p_dgs = ctypes.POINTER(ctypes.c_int16)()
        total = lib.pf_match_batch_compact(
            self._h, qdata, offs, nq,
            scores_arr.ctypes.data_as(ctypes.c_void_p)
            if scores_arr is not None else None,
            np.ascontiguousarray(VTML80_PBACK, np.float64),
            self.max_hits, self.min_diag_score,
            ids_arr.ctypes.data_as(ctypes.c_void_p)
            if ids_arr is not None else None,
            counts, run_stats,
            ctypes.byref(p_ids), ctypes.byref(p_scs), ctypes.byref(p_dgs))
        if np.any(counts < 0):
            lib.pf_free_results(p_ids, p_scs, p_dgs)
            raise RuntimeError("prefilter match overflow (db too large "
                               "for the non-overflow path)")
        total = int(total)
        ids = np.ctypeslib.as_array(p_ids, (total,)).copy() if total \
            else np.zeros(0, np.uint32)
        scs = np.ctypeslib.as_array(p_scs, (total,)).copy() if total \
            else np.zeros(0, np.int32)
        dgs = np.ctypeslib.as_array(p_dgs, (total,)).copy() if total \
            else np.zeros(0, np.int16)
        lib.pf_free_results(p_ids, p_scs, p_dgs)
        # the reference's per-run prefilter statistics
        # (Prefiltering::printStatistics, Prefiltering.cpp:953-975):
        # [kmer list len, query positions, db matches, overflows, hits].
        # Snapshot of THIS call only — log_prefilter_stats normalizes by
        # the latest call's query counts, so accumulating across calls
        # would inflate per-sequence statistics.
        self.stats = run_stats
        return counts, ids, scs, dgs

    def new_scratch(self):
        """An opaque per-thread native scratch: concurrent
        match_profile(..., scratch=) calls against this shared index
        are safe when each thread owns one (the index is read-only
        during matching)."""
        import ctypes

        class _Scratch:
            def __init__(self, lib, handle):
                self._lib, self._h = lib, handle

            def __del__(self):
                try:
                    self._lib.pf_scratch_free(self._h)
                except Exception:
                    pass

        return _Scratch(self._lib, self._lib.pf_scratch_new(self._h))

    def match_profile(self, raw_scores, query_seq, kmer_thr=None,
                      identity_id=None, scratch=None):
        """Hits for one HMM-profile query (the blastpgp/profile-query
        prefilter role). The index must have been built with
        kmer_score=0 (Prefiltering.cpp:525-527: localKmerThr=0 for
        profile queries).

        raw_scores: (L, 20) int16 stored PSSM scores (4x-scaled);
        query_seq: (L,) uint8 query letters (profile record byte 20).
        kmer_thr defaults to the sens-4 profile threshold."""
        rs = np.ascontiguousarray(raw_scores, np.int16)
        qn = np.ascontiguousarray(query_seq, np.uint8)
        L = len(qn)
        if rs.shape != (L, 20):
            raise ValueError("raw_scores must be (L, 20)")
        if kmer_thr is None:
            kmer_thr = profile_kmer_threshold()
        # alignment profile: stored/4 truncated toward zero, X column 0
        # (Sequence::mapProfile, Sequence.cpp:272-280)
        qprof = np.zeros((L, 21), np.int8)
        qprof[:, :20] = (rs.astype(np.int32) // 4 +
                         (rs.astype(np.int32) % 4 != 0) * (rs < 0)).astype(np.int8)
        cap = max(self.max_hits + 1, 1)
        out_id = np.empty(cap, np.uint32)
        out_sc = np.empty(cap, np.int32)
        out_dg = np.empty(cap, np.int16)
        ident = 0xFFFFFFFF if identity_id is None else int(identity_id)
        if scratch is not None:
            n = self._lib.pf_match_profile_sc(
                self._h, scratch._h, qn, L, rs.reshape(-1),
                qprof.reshape(-1), int(kmer_thr), self.max_hits,
                self.min_diag_score, ident, out_id, out_sc, out_dg)
        else:
            n = self._lib.pf_match_profile(
                self._h, qn, L, rs.reshape(-1), qprof.reshape(-1),
                int(kmer_thr), self.max_hits, self.min_diag_score,
                ident, out_id, out_sc, out_dg)
        if n < 0:
            raise RuntimeError("prefilter match overflow (db too large for "
                               "the non-overflow path)")
        return out_id[:n].copy(), out_sc[:n].copy(), out_dg[:n].copy()


def decompose_by_residues(seq_lens, n_splits):
    """DBReader::decomposeDomainByAminoAcid (DBReader.cpp:463-505) over
    sequence entry lengths (data lengths include the trailing newline and
    NUL, i.e. len+2). Returns [(start, count)] per split; counts can be 0
    (the reference skips empty splits, Prefiltering.cpp:736-738)."""
    lens = np.asarray(seq_lens, np.int64) + 2
    n = len(lens)
    if n_splits == 1:
        return [(0, n)]
    if n <= n_splits:
        return [(i, 1) if i < n else (0, 0) for i in range(n_splits)]
    chunk = int(np.ceil(lens.sum() / n_splits))
    counts = [0] * n_splits
    cur, acc = 0, 0
    for l in lens.tolist():
        if acc >= chunk:
            acc = 0
            cur += 1
        acc += l
        counts[cur] += 1
    out, s = [], 0
    for c in counts:
        out.append((s, c))
        s += c
    return out


def split_max_res_list_len(max_res_list_len, n_splits):
    """Per-split hit budget so the merged lists stay near the requested
    size (Prefiltering.cpp:357-360): L/split + 4*sqrt(L/split)."""
    if n_splits <= 1:
        return max_res_list_len
    four_std = int(4.0 * np.sqrt(float(max_res_list_len) / n_splits))
    return max(1, max_res_list_len // n_splits + four_std)


def kspace_bytes(kmer_size=6):
    """Fixed k-mer offset table per index (+ presence bitmap)."""
    return 4 * (20 ** kmer_size + 1) + 20 ** kmer_size // 8


KSPACE_BYTES = kspace_bytes(6)


def estimate_split_memory(total_residues, n_seqs, n_splits, threads=1,
                          kmer_size=6):
    """Peak host bytes for one split of OUR index + per-thread match
    scratch (the role of Prefiltering::estimateMemoryConsumption,
    Prefiltering.cpp:1067-1100, with this framework's own structures:
    8-byte IndexEntry per residue position, byte-encoded targets, and
    the chunked-overflow found/hits buffers sized by max(1e6, nseq))."""
    res_split = total_residues // max(n_splits, 1) + 1
    nseq_split = n_seqs // max(n_splits, 1) + 1
    per_entry = 8 + 1  # IndexEntry + tdata byte
    scratch_n = 2 * max(1_000_000, nseq_split)
    # found (8B Counter) + hits (8B IndexEntry) + hitDiag (2B) per thread
    scratch = threads * scratch_n * (8 + 8 + 2)
    return kspace_bytes(kmer_size) + res_split * per_entry \
        + 8 * nseq_split + scratch


def optimize_split(total_residues, n_seqs, memory_limit=0, threads=None,
                   kmer_size=6):
    """Smallest split count whose per-split peak fits the budget
    (Prefiltering::optimizeSplit role). memory_limit 0 = all free RAM,
    like --split-memory-limit 0."""
    import os
    if threads is None:
        threads = os.cpu_count() or 1
    if memory_limit <= 0:
        try:
            memory_limit = (os.sysconf("SC_AVPHYS_PAGES")
                            * os.sysconf("SC_PAGE_SIZE"))
        except (ValueError, OSError):
            memory_limit = 8 << 30
    for n in range(1, max(n_seqs, 1) + 1):
        if estimate_split_memory(total_residues, n_seqs, n, threads,
                                 kmer_size) <= memory_limit:
            return n
    return max(n_seqs, 1)


class SplitKmerPrefilter:
    """Memory-budgeted target-split prefilter: the contract of
    Prefiltering::runSplits + mergeTargetSplits (Prefiltering.cpp:662,
    379). The target set is decomposed into residue-balanced contiguous
    splits (decomposeDomainByAminoAcid boundaries), each split's index is
    built sequentially (bounding peak memory to one split), every query
    is matched per split with the reduced per-split hit budget, and the
    per-query lists are merged by (|score| desc, id asc) without
    re-truncation — byte-identical to a reference --split N run."""

    def __init__(self, target_encs, n_splits=None, split_memory_limit=0,
                 **kw):
        self.target_encs = target_encs
        self.kw = kw
        lens = [len(t) for t in target_encs]
        if n_splits is None:
            n_splits = optimize_split(sum(lens), len(lens),
                                      split_memory_limit)
        self.n_splits = n_splits
        self.ranges = decompose_by_residues(lens, n_splits)
        mrl = kw.get("max_res_list_len", 300)
        # the global clamp happens before the split adjustment
        # (Prefiltering.cpp:169, then :357-360)
        mrl = min(len(target_encs), mrl)
        self.split_mrl = split_max_res_list_len(mrl, n_splits)
        self.n_targets = len(target_encs)

    def match_batch(self, query_encs, identity_ids=None):
        """Same contract as KmerPrefilter.match_batch, over all splits."""
        from ..utils import log
        nq = len(query_encs)
        parts = [[] for _ in range(nq)]
        kw = dict(self.kw)
        kw["max_res_list_len"] = self.split_mrl
        # per-call statistics (accumulated over this call's splits only)
        self.stats = np.zeros(5, np.int64)
        for si, (start, count) in enumerate(self.ranges):
            if count == 0:
                continue
            if self.n_splits > 1:
                log.info(f"prefilter split {si + 1}/{self.n_splits}: "
                         f"targets {start}..{start + count}")
            pf = KmerPrefilter(self.target_encs[start:start + count], **kw)
            ids_local = None
            if identity_ids is not None:
                gid = np.asarray(identity_ids, np.int64)
                in_range = (gid >= start) & (gid < start + count)
                ids_local = np.where(in_range, gid - start,
                                     0xFFFFFFFF).astype(np.uint32)
            res = pf.match_batch(query_encs, identity_ids=ids_local)
            self.stats = getattr(self, "stats", np.zeros(5, np.int64)) \
                + pf.stats
            for qi, (ids, sc, dg) in enumerate(res):
                if len(ids):
                    parts[qi].append((ids.astype(np.int64) + start, sc, dg))
            del pf
        out = []
        for qi in range(nq):
            if not parts[qi]:
                out.append((np.zeros(0, np.uint32), np.zeros(0, np.int32),
                            np.zeros(0, np.int16)))
                continue
            ids = np.concatenate([p[0] for p in parts[qi]])
            sc = np.concatenate([p[1] for p in parts[qi]])
            dg = np.concatenate([p[2] for p in parts[qi]])
            # hit_t::compareHitsByScoreAndId over the concatenated lists
            # (mergeTargetSplits, Prefiltering.cpp:464-466)
            order = np.lexsort((ids, -np.abs(sc.astype(np.int64))))
            out.append((ids[order].astype(np.uint32), sc[order], dg[order]))
        return out


class ReferenceKmerPrefilter:
    """candidate_pairs() adapter for SearchDriver: the reference-default
    prefilter (sens 4, spaced 6-mers) producing the exact candidate set
    the reference alignment stage would see."""

    def __init__(self, params, target_db, min_diag_score=15):
        import os
        from ..data.submat import encode_aa
        from ..utils import log
        self.params = params
        # -k 0 = auto k-mer size from target DB residues
        # (IndexTable::computeKmerSize via Prefiltering.cpp:277-278)
        ksize = int(getattr(params, "kmer_size", 0)) \
            or compute_kmer_size(target_db.total_residues())
        kw = dict(sensitivity=getattr(params, "sensitivity", 4.0),
                  max_res_list_len=getattr(params, "max_res_list_len", 300),
                  min_diag_score=min_diag_score,
                  comp_bias_correction=bool(
                      getattr(params, "comp_bias_correction", 1)),
                  kmer_size=ksize)
        # reuse a persisted createindex artifact when the target DB came
        # from a path that has one (the reference's prefilter likewise
        # auto-loads targetDB.idx); threshold mismatches fall back to a
        # fresh build
        src = getattr(target_db, "source_path", None)
        if src and os.path.exists(f"{src}.kidx"):
            try:
                self.pf = KmerPrefilter(None, index_path=f"{src}.kidx", **kw)
                log.info(f"loaded k-mer index {src}.kidx")
                return
            except RuntimeError:
                log.info(f"k-mer index {src}.kidx incompatible; rebuilding")
        tencs = [encode_aa(target_db.seq_bytes(i))
                 for i in range(len(target_db))]
        # split-mode decision (Prefiltering.cpp:662-770): query split
        # when the whole target index fits the memory budget, target
        # split otherwise. Query-split processing here is the streaming
        # BATCH_CHUNK match loop over one resident index (per-query
        # results are independent, so block order is output-invariant —
        # the reference's SPLIT_QUERY result files concatenate the same
        # way); --split-mode 1 forces it, 0 forces target splits.
        split_mode = int(getattr(params, "split_mode", 2))
        n_splits = int(getattr(params, "split", 0)) or None
        mem_limit = int(getattr(params, "split_memory_limit", 0))
        if split_mode == 1:
            if n_splits is not None and n_splits > 1:
                # the reference interprets --split under SPLIT_QUERY as
                # query splits; our query-split path streams fixed
                # BATCH_CHUNK blocks instead, so an explicit count is
                # advisory only — say so rather than silently dropping it
                log.warning(f"--split {n_splits} ignored in query-split "
                         f"mode (--split-mode 1): queries stream in "
                         f"fixed-size blocks over one resident index")
            n_splits = 1
        elif n_splits is None:
            n_splits = optimize_split(
                sum(len(t) for t in tencs), len(tencs), mem_limit,
                kmer_size=ksize)
            if split_mode == 0 and n_splits < 2:
                n_splits = 2
        if n_splits > 1:
            log.info(f"prefilter target split: {n_splits} splits")
            # in a jax.distributed run with a shared tmp dir, fan the
            # splits over processes (runMpiSplits role,
            # Prefiltering.cpp:575-660) — merged lists byte-identical
            dist_tmp = os.environ.get("METAEUK_DIST_TMP")
            n_proc = 1
            if dist_tmp:
                from ..parallel.multihost import process_count
                n_proc = process_count()
            if dist_tmp and n_proc > 1:
                from ..parallel.dist_prefilter import \
                    DistributedSplitKmerPrefilter
                self.pf = DistributedSplitKmerPrefilter(
                    tencs, dist_tmp, n_splits, **kw)
            else:
                self.pf = SplitKmerPrefilter(tencs, n_splits=n_splits,
                                             **kw)
        else:
            self.pf = KmerPrefilter(tencs, **kw)

    def candidate_pairs(self, orf_aa_seqs, base_index=0, quiet=False):
        """(n_pairs, 2) int64 (orf_idx, target_idx), per fragment in
        prefilter output order (score desc, target asc). base_index
        offsets the fragment indices (batched pipeline slices)."""
        from ..data.submat import encode_aa
        results = self.pf.match_batch([encode_aa(s) for s in orf_aa_seqs])
        counts = np.array([len(ids) for ids, _, _ in results], np.int64)
        if not quiet:
            log_prefilter_stats(getattr(self.pf, "stats", None), counts)
        if counts.sum() == 0:
            return np.zeros((0, 2), np.int64)
        qi = base_index + np.repeat(
            np.arange(len(results), dtype=np.int64), counts)
        ti = np.concatenate([ids for ids, _, _ in results]).astype(np.int64)
        return np.stack([qi, ti], axis=1)


def log_prefilter_stats(stats, counts):
    """The reference's per-run prefilter statistics
    (Prefiltering::printStatistics, Prefiltering.cpp:953-975): k-mers
    per position, DB matches per position, overflow count, and the
    result-list size distribution, at -v 3 (info)."""
    from ..utils import log
    if stats is None or len(counts) == 0:
        return
    klen, qpos, dbm, ovf, hits = (int(x) for x in stats)
    qpos = max(qpos, 1)
    nq = len(counts)
    srt = np.sort(counts)
    log.info(f"{klen / qpos:.6g} k-mers per position")
    log.info(f"{dbm // nq} DB matches per sequence")
    log.info(f"{ovf} overflows")
    log.info(f"{int(srt[nq // 2])} sequences passed prefiltering per query "
             f"sequence (median)")
    log.info(f"{hits // nq} hits per query sequence")


def prefilter_db(query_encs, target_encs, identity_pairs=False, **kw):
    """All queries -> list of (ids, scores, diags); identity_pairs=True
    passes the query index as identityId (same-database search)."""
    pf = KmerPrefilter(target_encs, **kw)
    if pf.diagonal_scoring:
        ids = (np.arange(len(query_encs), dtype=np.uint32)
               if identity_pairs else None)
        res = pf.match_batch(list(query_encs), identity_ids=ids)
        log_prefilter_stats(
            getattr(pf, "stats", None),
            np.array([len(r[0]) for r in res], np.int64))
        return res
    out = []
    for qi, q in enumerate(query_encs):
        out.append(pf.match(q, qi if identity_pairs else None))
    return out


def hits_to_pref_lines(ids, scores, diags):
    """prefilterHitToBuffer lines (QueryMatcher.h:118-130)."""
    return "".join(f"{int(i)}\t{int(s)}\t{int(d)}\n"
                   for i, s, d in zip(ids, scores, diags))
