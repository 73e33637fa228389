# Copy of metaeuk_tpu/search/nucl_align.py; it differs from its original only in this note.
"""Banded nucleotide alignment (the BandedNucleotideAligner + nucl
Alignment::run role).

Drives the exact ksw2-extension replica in native/nucl_align.cpp through
the reference's wrapper logic (alignment/BandedNucleotideAligner.cpp:
ungapped seed on the prefilter diagonal -> reverse score-only extension
for the start -> forward extension with CIGAR -> optional reversed-CIGAR
redo), then Matcher::getSWResult bookkeeping (Matcher.cpp:60-143) and the
Alignment::run accept/reject loop (Alignment.cpp:312-410).

E-values: NucleotideMatrix scale 1.0 + gap 5/2 seed-42 ALP constants
(search/evalue.py _NUCL_SCALE1_GAPPED_5_2).
"""

import ctypes

import numpy as np

from .. import native
from ..io import mmseqsdb
from ..data.nucl import encode_nucl
from .evalue import EvalueComputation, _NUCL_SCALE1_GAPPED_5_2

GAPO, GAPE, ZDROP, BAND = 5, 2, 40, 64

# NucleotideMatrix at scale 1.0: 5x5 row-major, match +2 / mismatch -3,
# X row/col -3 (nucleotide.out); the ksw fast path zeroes wildcard pairs
_MAT = np.full((5, 5), -3, np.int8)
np.fill_diagonal(_MAT, 2)
_MAT[4, 4] = -3
_MAT_FLAT = np.ascontiguousarray(_MAT.reshape(-1))


def _bind(lib):
    if getattr(lib, "_ksw_bound", False):
        return
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.mtpu_ksw_extz.restype = ctypes.c_int64
    lib.mtpu_ksw_extz.argtypes = [
        ctypes.c_int64, u8p, ctypes.c_int64, u8p, ctypes.c_int64, i8p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, i32p, u32p, ctypes.c_int64]
    lib._ksw_bound = True


def _ksw(q, t, score_only):
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("native library required for nucleotide alignment")
    _bind(lib)
    out = np.zeros(8, np.int32)
    cap = 0 if score_only else (len(q) + len(t) + 4)
    cig = np.zeros(max(cap, 1), np.uint32)
    n = lib.mtpu_ksw_extz(len(q), np.ascontiguousarray(q, np.uint8),
                          len(t), np.ascontiguousarray(t, np.uint8),
                          5, _MAT_FLAT, GAPO, GAPE, BAND, ZDROP,
                          1 if score_only else 0, out, cig, cap)
    return dict(max=int(out[0]), max_q=int(out[1]), max_t=int(out[2]),
                zdropped=int(out[3]), cigar=cig[:n].copy())


def _ungapped_by_diagonal(q, t, diagonal):
    """DistanceCalculator::ungappedAlignmentByDiagonal, mode ALIGNMENT
    (DistanceCalculator.h:116-175) on encoded sequences."""
    res = dict(start=-1, end=-1, score=0, dist=abs(diagonal),
               diagonal=diagonal)
    if diagonal >= 0 and abs(diagonal) < len(q):
        d = abs(diagonal)
        n = min(len(t), len(q) - d)
        sc = _MAT[q[d:d + n], t[:n]]
    elif diagonal < 0 and abs(diagonal) < len(t):
        d = abs(diagonal)
        n = min(len(t) - d, len(q))
        sc = _MAT[q[:n], t[d:d + n]]
    else:
        return res
    # computeSubstitutionStartEndDistance running local max
    score = 0
    max_score = 0
    min_pos = -1
    max_start = max_end = 0
    for pos in range(n):
        score += int(sc[pos])
        if score <= 0:
            score = 0
            min_pos = pos
        if score > max_score:
            max_end = pos
            max_start = min_pos + 1
            max_score = score
    res.update(start=max_start, end=max_end, score=max_score)
    return res


def _compute_ungapped(q, t, diagonal_u16):
    """computeUngappedAlignment: best across 65536 diagonal wraps."""
    best = dict(start=-1, end=-1, score=0, dist=0, diagonal=0)
    for div in range(1, 2 + len(t) // 32768):
        tmp = _ungapped_by_diagonal(q, t, -div * 65536 + diagonal_u16)
        if tmp["score"] > best["score"]:
            best = tmp
    for div in range(0, 1 + len(q) // 65536):
        tmp = _ungapped_by_diagonal(q, t, div * 65536 + diagonal_u16)
        if tmp["score"] > best["score"]:
            best = tmp
    return best


_CIG_OP = "MID"


def banded_nucl_align(q, t, diagonal_u16, evaluer):
    """BandedNucleotideAligner::align (isReverse=False, no wrapped
    scoring): returns dict(score, q_start, q_end, t_start, t_end, qcov,
    tcov, evalue, aa_ids, backtrace)."""
    q = np.asarray(q, np.uint8)
    t = np.asarray(t, np.uint8)
    qlen, tlen = len(q), len(t)
    aln = _compute_ungapped(q, t, diagonal_u16)
    dist = aln["dist"]
    if aln["diagonal"] >= 0:
        q_u_s, q_u_e = aln["start"] + dist, aln["end"] + dist
        t_u_s, t_u_e = aln["start"], aln["end"]
    else:
        q_u_s, q_u_e = aln["start"], aln["end"]
        t_u_s, t_u_e = aln["start"] + dist, aln["end"] + dist

    if q_u_e - q_u_s == qlen - 1 and t_u_s == 0 and t_u_e == tlen - 1:
        aa_ids = int((q[q_u_s:q_u_e + 1] == t[:q_u_e - q_u_s + 1]).sum())
        return dict(score=aln["score"], q_start=q_u_s, q_end=q_u_e,
                    t_start=t_u_s, t_end=t_u_e,
                    qcov=_cov(q_u_s, q_u_e, qlen),
                    tcov=_cov(t_u_s, t_u_e, tlen),
                    evalue=float(evaluer.compute_evalue(aln["score"], qlen)),
                    aa_ids=aa_ids, backtrace="M" * qlen)

    q_rev = q[::-1]
    t_rev = t[::-1]
    q_start_rev = qlen - q_u_e - 1
    t_start_rev = tlen - t_u_e - 1
    ez = _ksw(q_rev[q_start_rev:], t_rev[t_start_rev:], score_only=True)
    q_start = qlen - (q_start_rev + ez["max_q"]) - 1
    t_start = tlen - (t_start_rev + ez["max_t"]) - 1
    ez_aln = _ksw(q[q_start:], t[t_start:], score_only=False)
    if ez["max_q"] > ez_aln["max_q"] and ez["max_t"] > ez_aln["max_t"]:
        ez_aln = _ksw(q_rev[q_start_rev:], t_rev[t_start_rev:],
                      score_only=False)
        cigar = ez_aln["cigar"][::-1]
    else:
        cigar = ez_aln["cigar"]

    q_end = q_start + ez_aln["max_q"]
    t_end = t_start + ez_aln["max_t"]
    bt = []
    aa_ids = 0
    qp, tp = q_start, t_start
    for c in cigar:
        op = _CIG_OP[c & 0xF]
        length = int(c) >> 4
        if op == "M":
            aa_ids += int((q[qp:qp + length] == t[tp:tp + length]).sum())
            qp += length
            tp += length
        elif op == "I":
            qp += length
        else:
            tp += length
        bt.append(op * length)
    return dict(score=int(ez_aln["max"]), q_start=q_start, q_end=q_end,
                t_start=t_start, t_end=t_end,
                qcov=_cov(q_start, q_end, qlen),
                tcov=_cov(t_start, t_end, tlen),
                evalue=float(evaluer.compute_evalue(ez_aln["max"], qlen)),
                aa_ids=aa_ids, backtrace="".join(bt))


def _cov(start, end, length):
    return np.float32(min(length, max(start, end)) - min(start, end) + 1) \
        / np.float32(length)


def _seq_id(aa_ids, aln_len):
    return np.float32(aa_ids) / np.float32(aln_len)


def align_module_nucl(query_db, target_db, pref_db, out_db, evalue=0.001,
                      cov_thr=0.0, cov_mode=0, seq_id_thr=0.0,
                      aln_len_thr=0, max_accept=2 ** 31 - 1,
                      max_reject=2 ** 31 - 1, add_backtrace=False,
                      include_identity=False):
    """align module for nucleotide query+target DBs (Alignment::run with
    the BandedNucleotideAligner, Alignment.cpp:312-410)."""
    from ..pipeline.dbtools2 import aln_record_to_line, _compare_hits_key, \
        _entries_by_offset, _lines

    q_enc = {k: encode_nucl(p)
             for k, p in mmseqsdb.read_seq_entries(query_db)}
    t_enc = {k: encode_nucl(p)
             for k, p in mmseqsdb.read_seq_entries(target_db)}
    total_t = sum(len(e) for e in t_enc.values())
    evaluer = EvalueComputation(total_t, params=_NUCL_SCALE1_GAPPED_5_2)
    same_db = query_db == target_db

    out = []
    for key, payload in mmseqsdb.read_db(pref_db):
        q = q_enc.get(key)
        results = []
        passed = rejected = 0
        for ln in _lines(payload):
            if passed >= max_accept or rejected >= max_reject:
                break
            cols = ln.split("\t")
            t_key = int(cols[0])
            diagonal = np.uint16(np.int16(int(cols[2]))) \
                if len(cols) == 3 else np.uint16(0)
            t = t_enc[t_key]
            is_identity = (key == t_key) and (include_identity or same_db)
            a = banded_nucl_align(q, t, int(diagonal), evaluer)
            bt = a["backtrace"]
            aln_len = len(bt) if bt else \
                max(abs(a["q_end"] - a["q_start"]),
                    abs(a["t_end"] - a["t_start"])) + 1
            seq_id = _seq_id(a["aa_ids"], aln_len)
            bit = int(evaluer.compute_bit_score(a["score"]) + 0.5)
            qcov, tcov = a["qcov"], a["tcov"]
            if is_identity:
                qcov = tcov = np.float32(1.0)
                seq_id = np.float32(1.0)
            rec = dict(dbKey=t_key, score=bit, seqId=seq_id,
                       eval=a["evalue"], qStart=a["q_start"],
                       qEnd=a["q_end"], qLen=len(q), dbStart=a["t_start"],
                       dbEnd=a["t_end"], dbLen=len(t),
                       backtrace=_compress_bt(bt), qcov=qcov, tcov=tcov)
            if _check_criteria(rec, is_identity, evalue, seq_id_thr,
                               aln_len_thr, cov_mode, cov_thr, aln_len):
                results.append(rec)
                passed += 1
                rejected = 0
            else:
                rejected += 1
        results.sort(key=_compare_hits_key)
        body = "".join(aln_record_to_line(r, add_backtrace)
                       for r in results)
        out.append((key, body.encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES)
    return out_db


def _compress_bt(bt):
    from ..pipeline.alnformat import compress_backtrace
    return compress_backtrace(bt) if bt else None


def _check_criteria(rec, is_identity, eval_thr, seq_id_thr, aln_len_thr,
                    cov_mode, cov_thr, aln_len):
    """Alignment::checkCriteria (Alignment.cpp:548-567)."""
    if is_identity:
        return True
    if rec["eval"] > eval_thr:
        return False
    if rec["seqId"] < seq_id_thr:
        return False
    if aln_len < aln_len_thr:
        return False
    if cov_thr > 0.0:
        q, t = rec["qcov"], rec["tcov"]
        if cov_mode == 0 and (q < cov_thr or t < cov_thr):
            return False
        if cov_mode == 1 and t < cov_thr:
            return False
        if cov_mode == 2 and q < cov_thr:
            return False
    return True
