# Copy of metaeuk_tpu/pipeline/rescorediagonal.py; it differs from its original only in this note.
"""rescorediagonal: ungapped re-scoring of prefilter hits on their diagonal.

Port of lib/mmseqs/src/alignment/rescorediagonal.cpp +
DistanceCalculator.h for rescore modes 0 (Hamming), 1 (substitution sum,
clamped local max) and 2 (alignment with start/end), the configurations
linclust and the rescore workflows use.  --filter-hits precision
libraries, wrapped scoring and reverse prefilter results are not ported.

Scores use the unbiased BLOSUM62 2-bit matrix (rescorediagonal.cpp:88)
and the UNGAPPED Gumbel parameters (EvalueComputation.h:70-77).
"""

import numpy as np

from ..data.submat import AA2NUM, BLOSUM62_SCORES
from ..io import mmseqsdb
from ..search.evalue import EvalueComputation
from .alnformat import compress_backtrace  # noqa: F401  (parity helpers)


def _ascii_scores():
    """fastMatrix: ASCII x ASCII scores via aa2num."""
    m = BLOSUM62_SCORES[AA2NUM][:, AA2NUM]
    return m.astype(np.int64)


_ASCII = None


def _aln_by_diagonal(q, t, diagonal, mode, sm):
    """ungappedAlignmentByDiagonal (DistanceCalculator.h:116-176)."""
    min_dist = abs(diagonal)
    res = dict(start=-1, end=-1, score=0, dlen=0, dist=min_dist,
               diagonal=diagonal)
    if diagonal >= 0 and min_dist < len(q):
        a, b = q[min_dist:], t
    elif diagonal < 0 and min_dist < len(t):
        a, b = q, t[min_dist:]
    else:
        return res
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]
    res["dlen"] = n
    if mode == 0:      # inverse Hamming: raw byte matches
        res["score"] = int(np.count_nonzero(a[:n] == b[:n]))
    elif mode == 1:    # clamped local max of substitution sums
        s = sm[a, b]
        run = 0
        best = 0
        for v in s:
            run = max(0, run + int(v))
            best = max(best, run)
        res["score"] = best
    else:              # mode 2: local max with start/end
        s = sm[a, b]
        best = 0
        run = 0
        min_pos = -1
        best_end = 0
        best_start = 0
        for pos, v in enumerate(s):
            run += int(v)
            if run <= 0:
                run = 0
                min_pos = pos
            if run > best:
                best = run
                best_end = pos
                best_start = min_pos + 1
        res["score"] = best
        res["start"] = best_start if best > 0 or True else -1
        res["end"] = best_end
        if best == 0:
            res["start"], res["end"] = 0, 0
    return res


def _compute_ungapped(q, t, diagonal_u16, mode, sm):
    """computeUngappedAlignment: resolve the u16 diagonal into real
    diagonals across 65536 wraps, keep the best (DistanceCalculator.h:
    94-113)."""
    best = dict(start=-1, end=-1, score=0, dlen=0, dist=0, diagonal=0)
    for div in range(1, 2 + len(t) // 32768):
        tmp = _aln_by_diagonal(q, t, -div * 65536 + diagonal_u16, mode, sm)
        if tmp["score"] > best["score"]:
            best = tmp
    for div in range(0, 1 + len(q) // 65536):
        tmp = _aln_by_diagonal(q, t, div * 65536 + diagonal_u16, mode, sm)
        if tmp["score"] > best["score"]:
            best = tmp
    return best


def _parse_precision_lib(target_seqid, target_cov, target_precision=0.99,
                         cov_mode=0):
    """parsePrecisionLib (rescorediagonal.cpp:20-43): first row matching
    the grid-rounded (cov, seqid) with precision >= target."""
    import pathlib
    name = "CovSeqidQscPercMinDiag.lib" if cov_mode == 0 \
        else "CovSeqidQscPercMinDiagTargetCov.lib"
    path = pathlib.Path(__file__).parent.parent / "data" / "resources" / name
    int_seqid = int((target_seqid + 0.0001) * 100)
    tgt_seqid = float(int_seqid - (int_seqid % 5)) / 100
    tgt_cov = float(int((target_cov + 0.0001) * 10)) / 10
    for line in path.read_text().splitlines():
        vals = line.split(" ")
        if len(vals) < 4:
            continue
        cov, seqid, spc, prec = (float(v) for v in vals[:4])
        if abs(cov - tgt_cov) < 1e-6 and abs(seqid - tgt_seqid) < 1e-6 \
                and prec >= target_precision:
            return spc
    return 0.0


def rescorediagonal(query_db, target_db, result_db, out_db, rescore_mode=0,
                    eval_thr=1e-3, cov_thr=0.0, cov_mode=0, seq_id_thr=0.0,
                    aln_len_thr=0, include_identity=False,
                    add_backtrace=False, sort_results=0, filter_hits=False):
    global _ASCII
    if _ASCII is None:
        _ASCII = _ascii_scores()
    score_per_col_thr = 0.0
    if filter_hits:
        if rescore_mode == 0:
            # HAMMING cannot filter; reference switches to SUBSTITUTION
            rescore_mode = 1
        score_per_col_thr = _parse_precision_lib(seq_id_thr, cov_thr,
                                                 0.99, cov_mode)
    sm21 = BLOSUM62_SCORES.astype(np.int64)
    qdb = mmseqsdb.read_seqdb(query_db)
    same = query_db == target_db
    tdb = qdb if same else mmseqsdb.read_seqdb(target_db)
    q_by_key = {int(k): i for i, k in enumerate(qdb.keys)}
    t_by_key = {int(k): i for i, k in enumerate(tdb.keys)}
    evaluer = EvalueComputation(int(tdb.lengths.sum()), gapped=False)

    def enc(i, db):
        return AA2NUM[np.asarray(db.seq(i), np.uint8)].astype(np.int64)

    out = []
    for qkey, payload in mmseqsdb.read_db(result_db):
        lines_out = []
        qi = q_by_key.get(qkey)
        q = enc(qi, qdb) if qi is not None else None
        for line in payload.decode().split("\n"):
            if not line:
                continue
            cols = line.split("\t")
            tkey, diag = int(cols[0]), int(cols[2])
            ti = t_by_key[tkey]
            t = enc(ti, tdb)
            is_identity = (qi == ti and (include_identity or same))
            aln = _compute_ungapped(q, t, diag & 0xFFFF, rescore_mode, sm21)
            dlen = aln["dlen"]
            score = aln["score"]
            diagonal = aln["diagonal"]
            dist = aln["dist"]
            seq_id = 0.0
            evalue = 0.0
            bit_score = 0
            aln_len = 0
            tcov = dlen / len(t) if len(t) else 0.0
            qcov = dlen / len(q) if len(q) else 0.0
            rec = None
            if rescore_mode == 0:
                seq_id = score / dlen if dlen else 0.0
                aln_len = dlen
            else:
                evalue = evaluer.compute_evalue(score, len(q))
                bit_score = int(evaluer.compute_bit_score(score) + 0.5)
                if rescore_mode == 2:
                    aln_len = aln["end"] - aln["start"] + 1
                    if diagonal >= 0:
                        qs, qe = aln["start"] + dist, aln["end"] + dist
                        ts_, te = aln["start"], aln["end"]
                    else:
                        qs, qe = aln["start"], aln["end"]
                        ts_, te = aln["start"] + dist, aln["end"] + dist
                    if evalue <= eval_thr or is_identity:
                        ids = int(np.count_nonzero(
                            q[qs:qe + 1] == t[ts_:ts_ + (qe - qs) + 1]))
                        seq_id = ids / aln_len
                    qcov = (min(qs, qe) * -1 + max(qs, qe) + 1) / len(q)
                    tcov = (min(ts_, te) * -1 + max(ts_, te) + 1) / len(t)
                    bt = f"{aln_len}M" if add_backtrace else None
                    rec = (tkey, bit_score, seq_id, evalue, qs, qe, len(q),
                           ts_, te, len(t), bt)
            has_cov = ((qcov >= cov_thr and tcov >= cov_thr)
                       if cov_mode == 0 else
                       (tcov >= cov_thr) if cov_mode == 1 else
                       (qcov >= cov_thr) if cov_mode == 2 else True)
            eps = np.finfo(np.float32).eps
            ok = (aln_len >= aln_len_thr and has_cov
                  and seq_id >= seq_id_thr - eps and evalue <= eval_thr)
            curr_spc = (float(score) / dlen) if dlen else 0.0
            has_to_filter = filter_hits and curr_spc >= score_per_col_thr
            if not (is_identity or has_to_filter or ok):
                continue
            if rescore_mode == 2:
                from .alnformat import format_seq_id, matcher_seq_id_text
                (tkey_, bits, sid, ev, qs, qe, ql, ts_, te, tl, bt) = rec
                cols_out = [str(tkey_), str(bits), matcher_seq_id_text(sid),
                            "%.3E" % ev, str(qs), str(qe), str(ql),
                            str(ts_), str(te), str(tl)]
                if bt is not None:
                    cols_out.append(bt)
                lines_out.append("\t".join(cols_out))
            elif rescore_mode == 1:
                lines_out.append(f"{tkey}\t{bit_score}\t{diagonal}")
            else:
                lines_out.append(f"{tkey}\t{int(100 * seq_id)}\t{diagonal}")
        out.append((qkey, "".join(l + "\n" for l in lines_out).encode()))
    dbtype = mmseqsdb.DBTYPE_ALIGNMENT_RES if rescore_mode == 2 \
        else mmseqsdb.DBTYPE_PREFILTER_RES
    mmseqsdb.write_db(out_db, out, dbtype)
    return out_db
