# Copy of metaeuk_tpu/search/fwbw.py; it differs from its original only in
# this note, its imports and its loader (_get_lib), which builds
# native/fwbw.cpp into metaeuk_tpu_torch/build/ (native.build_library).
"""fwbw: forward-backward posterior-probability realignment.

Driver for the native kernel in native/fwbw.cpp, a bit-exact scalar
re-implementation of the reference fwbw command
(lib/mmseqs/src/alignment/Fwbw.cpp): rescaled forward/backward over the
pair HMM in 16-column blocks, posterior matrix, MAC (maximum accuracy)
decoding with --mact, local backtrace. Results are filtered with
Alignment::checkCriteria (evalue is always 0), sorted by
Matcher::compareHits and written with compressed backtraces
(Fwbw.cpp:1124-1172).

The TPU batch path for this recurrence lives in ops/; this module is
the byte-parity host implementation for the CLI command.
"""

import ctypes
import threading

import numpy as np

from .. import native
from ..data.submat import AA2NUM, BLOSUM62_SCORES
from ..io import mmseqsdb
from ..pipeline.alnformat import compress_backtrace, matcher_seq_id_text
from .lcaalign import has_coverage

# g++ flags of native/fwbw.cpp: -ffp-contract=off is required for bit
# parity (the reference's SSE build has no FMA)
_FLAGS = ("-O2", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")
_LIB = None
_LOCK = threading.Lock()


def _get_lib():
    """Build/load the fwbw kernel. Compiled separately from the other
    native sources: it REQUIRES -ffp-contract=off (the reference's SSE
    build has no FMA, so contraction would change float rounding).
    native.build_library builds native/fwbw.cpp into
    metaeuk_tpu_torch/build/libmetaeuk_fwbw-<digest>.so under a lock;
    native/libmetaeuk_fwbw.so is never loaded. Raises when the build or
    the load fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(native.build_library(
            "libmetaeuk_fwbw", ["fwbw.cpp"], _FLAGS)))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lp = ctypes.POINTER(ctypes.c_long)
        fp = ctypes.POINTER(ctypes.c_float)
        lib.fwbw_align.restype = ctypes.c_long
        lib.fwbw_align.argtypes = [
            u8p, ctypes.c_long, u8p, ctypes.c_long, f32p,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_long, lp, lp, lp, lp, fp, lp, ctypes.c_char_p]
        _LIB = lib
    return lib


def fwbw_pair(qenc, tenc, blosum32, gap_open=10.0, gap_extend=2.0,
              temperature=1.0, mact=0.035, blocklen=16):
    """One query/target forward-backward alignment; gap penalties are
    the positive CLI values (negated internally like Fwbw.cpp:1087)."""
    lib = _get_lib()
    qs = ctypes.c_long()
    qe = ctypes.c_long()
    ts = ctypes.c_long()
    te = ctypes.c_long()
    score = ctypes.c_float()
    aa_ids = ctypes.c_long()
    cigar = ctypes.create_string_buffer(len(qenc) + len(tenc) + 2)
    n = lib.fwbw_align(
        np.ascontiguousarray(qenc, np.uint8), len(qenc),
        np.ascontiguousarray(tenc, np.uint8), len(tenc), blosum32,
        -gap_open, -gap_extend, temperature, mact, blocklen,
        ctypes.byref(qs), ctypes.byref(qe), ctypes.byref(ts),
        ctypes.byref(te), ctypes.byref(score), ctypes.byref(aa_ids),
        cigar)
    return dict(qStart=qs.value, qEnd=qe.value, tStart=ts.value,
                tEnd=te.value, score_mac=score.value,
                aa_ids=aa_ids.value, cigar=cigar.raw[:n].decode())


def _compute_cov(start, end, length):
    return (min(length, max(start, end)) - min(start, end) + 1) \
        / np.float32(length)


def fwbw_db(query_db, target_db, aln_db, out_db, gap_open=10.0,
            gap_extend=2.0, temperature=1.0, mact=0.035, blocklen=16,
            evalue=0.001, cov=0.0, cov_mode=0, min_seq_id=0.0,
            aln_len_thr=0, compressed=False):
    """fwbw.cpp main loop (Fwbw.cpp:1069-1188)."""
    blosum32 = np.ascontiguousarray(BLOSUM62_SCORES, np.float32)
    qseqs = {k: p.rstrip(b"\x00").rstrip(b"\n")
             for k, p in mmseqsdb.read_db(query_db)}
    tseqs = {k: p.rstrip(b"\x00").rstrip(b"\n")
             for k, p in mmseqsdb.read_db(target_db)}

    out = []
    for qkey, payload in mmseqsdb.read_db(aln_db):
        qenc = AA2NUM[np.frombuffer(qseqs[qkey], dtype=np.uint8)]
        q_len = len(qenc)
        results = []
        for ln in payload.decode().split("\n"):
            if not ln:
                continue
            tkey = int(ln.split("\t", 1)[0].split(" ", 1)[0])
            tenc = AA2NUM[np.frombuffer(tseqs[tkey], dtype=np.uint8)]
            t_len = len(tenc)
            r = fwbw_pair(qenc, tenc, blosum32, gap_open, gap_extend,
                          temperature, mact, blocklen)
            aln_len = len(r["cigar"])
            seq_id = float(np.float32(r["aa_ids"]) / np.float32(aln_len)) \
                if aln_len else 0.0
            q_cov = _compute_cov(r["qStart"], r["qEnd"], q_len)
            t_cov = _compute_cov(r["tStart"], r["tEnd"], t_len)
            ok = (0.0 <= evalue and seq_id >= min_seq_id and
                  has_coverage(cov, cov_mode, q_cov, t_cov) and
                  aln_len >= aln_len_thr)
            if not ok:
                continue
            results.append(dict(
                dbKey=tkey, score=int(r["score_mac"]), seqId=seq_id,
                eval=0.0, qStart=r["qStart"], qEnd=r["qEnd"], qLen=q_len,
                dbStart=r["tStart"], dbEnd=r["tEnd"], dbLen=t_len,
                backtrace=r["cigar"]))
        results.sort(key=lambda r: (r["eval"], -r["score"], r["dbLen"],
                                    r["dbKey"]))
        rows = []
        for r in results:
            rows.append(
                f"{r['dbKey']}\t{r['score']}\t"
                f"{matcher_seq_id_text(r['seqId'])}\t{'%.3E' % r['eval']}"
                f"\t{r['qStart']}\t{r['qEnd']}\t{r['qLen']}\t"
                f"{r['dbStart']}\t{r['dbEnd']}\t{r['dbLen']}\t"
                f"{compress_backtrace(r['backtrace'])}\n")
        out.append((qkey, "".join(rows).encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES,
                      compressed=compressed)
    return out_db
