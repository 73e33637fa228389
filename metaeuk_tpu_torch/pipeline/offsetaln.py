# Copy of metaeuk_tpu/pipeline/offsetaln.py; it differs from its original
# only in this note and in proteinaln2nucl's device keyword (default
# cuda), which it passes on to for_scoring.
"""offsetalignment + proteinaln2nucl: ORF/contig coordinate re-mapping.

Behavior ports of lib/mmseqs/src/util/offsetalignment.cpp (updateOffset
:95-160, contig grouping :283-335, merge+sort :425-447) and
proteinaln2nucl.cpp (coordinate x3 rescale + nucleotide rescoring
:130-186) for the search types the framework drives (translated and
nucleotide searches; --search-type 4 backtrace re-expansion included).
"""

import numpy as np

from ..io import mmseqsdb
from .alnformat import matcher_seq_id_text
from .dbtools2 import parse_orf_location, _compare_hits_key, _lines, \
    parse_aln_record, aln_record_to_line


def _aln_line_orfpos(r, add_backtrace):
    cols = [str(r["dbKey"]), str(r["score"]), matcher_seq_id_text(r["seqId"]),
            "%.3E" % r["eval"], str(r["qStart"]), str(r["qEnd"]),
            str(r["qLen"]), str(r["dbStart"]), str(r["dbEnd"]),
            str(r["dbLen"]), str(r["qOrfStart"]), str(r["qOrfEnd"]),
            str(r["dbOrfStart"]), str(r["dbOrfEnd"])]
    if add_backtrace:
        cols.append(r["backtrace"] or "")
    return "\t".join(cols) + "\n"


def _protein2nucl_bt(bt):
    """Matcher::result_t::protein2nucl: each CIGAR count x3."""
    out = []
    num = ""
    for ch in bt:
        if ch.isdigit():
            num += ch
        else:
            out.append(f"{int(num or 1) * 3}{ch}")
            num = ""
    return "".join(out)


def _seq_lens(db):
    lens = {}
    with open(f"{db}.index") as f:
        for ln in f:
            c = ln.split("\t")
            lens[int(c[0])] = int(c[2]) - 2
    return lens


def offsetalignment(q_db, q_orf_db, t_db, t_orf_db, aln_db, out_db,
                    search_type=0, merge_query=True):
    """ORF-relative alignment coords -> source (contig) coords.

    Handles: nucl query vs protein target (translated search: query side
    x3 offsetting), protein query vs nucl target (target side), and
    nucl vs nucl (--search-type 3: both sides, no x3; --search-type 2:
    both translated; --search-type 4 re-expands backtraces)."""
    q_nucl = mmseqsdb.read_dbtype(q_db) == mmseqsdb.DBTYPE_NUCL
    t_nucl = mmseqsdb.read_dbtype(t_db) == mmseqsdb.DBTYPE_NUCL

    seqtarget_nuc = True
    trans_trans = False
    trans_nucl_aln = False
    if t_nucl:
        if search_type == 2:
            seqtarget_nuc = False
            trans_trans = True
        elif search_type == 3:
            seqtarget_nuc = True
        elif search_type == 4:
            trans_nucl_aln = True
            seqtarget_nuc = False
            trans_trans = True
    is_nucl_nucl = q_nucl and t_nucl and seqtarget_nuc
    target_update = is_nucl_nucl or trans_trans

    t_orf_hdr = dict(mmseqsdb.read_db(f"{t_orf_db}_h")) if target_update \
        else None
    t_lens = _seq_lens(t_db) if t_nucl else None

    def update_records(payload, qloc, q_orf_from_len=None):
        recs = []
        for ln in _lines(payload):
            r = parse_aln_record(ln)
            r.update(qOrfStart=-1, qOrfEnd=-1, dbOrfStart=-1, dbOrfEnd=-1)
            if target_update or qloc is None:
                hdr = t_orf_hdr[r["dbKey"]].decode().split()
                try:
                    tfrom, tto = parse_orf_location(hdr[1])
                    tkey = int(hdr[0])
                except (ValueError, IndexError):
                    # unparseable header (tloc.id == UINT_MAX,
                    # updateOffset:105-110): key unchanged, plus strand
                    # assumed. The reference reads UNINITIALIZED
                    # SequenceLocation fields here and emits stack
                    # garbage in dbOrfStart/End — we write 0/0.
                    tfrom, tto, tkey = 0, 0, r["dbKey"]
                r["dbKey"] = tkey
                minus = tfrom > tto
                db_s = r["dbStart"] if is_nucl_nucl else r["dbStart"] * 3
                db_e = r["dbEnd"] if is_nucl_nucl else r["dbEnd"] * 3
                r["dbOrfStart"], r["dbOrfEnd"] = tfrom, tto
                if minus:
                    r["dbStart"] = tfrom - db_s
                    r["dbEnd"] = tfrom - db_e - (0 if is_nucl_nucl else 2)
                else:
                    r["dbStart"] = tfrom + db_s
                    r["dbEnd"] = tfrom + db_e + (0 if is_nucl_nucl else 2)
            if qloc is not None:
                qfrom, qto = qloc
                minus = qfrom > qto
                q_s = r["qStart"] if is_nucl_nucl else r["qStart"] * 3
                q_e = r["qEnd"] if is_nucl_nucl else r["qEnd"] * 3
                r["qOrfStart"], r["qOrfEnd"] = qfrom, qto
                if minus:
                    r["qStart"] = qfrom - q_s
                    r["qEnd"] = qfrom - q_e - (0 if is_nucl_nucl else 2)
                else:
                    r["qStart"] = qfrom + q_s
                    r["qEnd"] = qfrom + q_e + (0 if is_nucl_nucl else 2)
            recs.append(r)
        return recs

    def serialize(recs):
        parts = []
        for r in recs:
            has_bt = bool(r.get("backtrace"))
            if trans_nucl_aln and not is_nucl_nucl and trans_trans \
                    and has_bt:
                r["backtrace"] = _protein2nucl_bt(r["backtrace"])
            parts.append(_aln_line_orfpos(r, has_bt))
        return "".join(parts)

    aln = dict(mmseqsdb.read_db(aln_db))
    out = []
    if q_nucl:
        q_lens = _seq_lens(q_db)
        q_orf_hdr = dict(mmseqsdb.read_db(f"{q_orf_db}_h"))
        # contig -> orf grouping, orf keys ascending (offsetalignment.cpp
        # :283-335)
        per_contig = {}
        for orf_key in sorted(aln):
            hdr = q_orf_hdr[orf_key].decode().split()
            per_contig.setdefault(int(hdr[0]), []).append(orf_key)
        max_contig = max(q_lens) if q_lens else 0
        for contig in range(max_contig + 1):
            if contig not in q_lens:
                continue
            recs = []
            for orf_key in per_contig.get(contig, ()):
                hdr = q_orf_hdr[orf_key].decode().split()
                qloc = parse_orf_location(hdr[1])
                got = update_records(aln[orf_key], qloc)
                if not merge_query:
                    out.append((orf_key, serialize(got).encode()))
                else:
                    recs.extend(got)
            if merge_query:
                for r in recs:
                    r["qLen"] = q_lens[contig]
                    if t_lens is not None:
                        r["dbLen"] = t_lens[r["dbKey"]]
                recs.sort(key=_compare_hits_key)
                out.append((contig, serialize(recs).encode()))
    else:
        for key in aln:
            recs = update_records(aln[key], None)
            if t_lens is not None:
                for r in recs:
                    r["dbLen"] = t_lens[r["dbKey"]]
            recs.sort(key=_compare_hits_key)
            out.append((key, serialize(recs).encode()))
        out.sort(key=lambda e: e[0])
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES)
    return out_db


def proteinaln2nucl(q_nucl_db, t_nucl_db, q_aa_db, t_aa_db, aln_db, out_db,
                    gap_open=5, gap_extend=2, device="cuda"):
    """proteinaln2nucl.cpp: x3 coordinate rescale + nucleotide-level
    rescoring along the backtrace (match +2/-3, nucleotide.out at scale
    1.0); bit score TRUNCATED to int (direct assignment, :179).

    E-values use the seed-42 ALP fit for the scale-1.0 nucleotide matrix
    at the default gap costs 5/2 (constants extracted from the vendored
    ALP; search/evalue.py); other gap costs get the deterministic
    runtime Gumbel fit (search/gumbel.py — the reference reruns the
    wall-clock-sized ALP simulation, EvalueComputation.h:91-110, whose
    output is machine-dependent; ours agrees within ALP's own
    lambda 1% / K 5% tolerance band and is reproducible)."""
    from ..search.evalue import EvalueComputation, _NUCL_SCALE1_GAPPED_5_2

    q_nucl = dict(mmseqsdb.read_db(q_nucl_db))
    t_nucl = q_nucl if t_nucl_db == q_nucl_db else \
        dict(mmseqsdb.read_db(t_nucl_db))
    q_aa = dict(mmseqsdb.read_db(q_aa_db))
    t_aa = q_aa if t_aa_db == q_aa_db else dict(mmseqsdb.read_db(t_aa_db))
    total_t = sum(len(p) - 1 for p in t_nucl.values())
    if (gap_open, gap_extend) == (5, 2):
        evaluer = EvalueComputation(total_t, params=_NUCL_SCALE1_GAPPED_5_2)
    else:
        nuc_scores = np.full((5, 5), -3, np.int64)
        np.fill_diagonal(nuc_scores, 2)
        nuc_scores[4, :] = nuc_scores[:, 4] = -3
        nuc_pback = np.array([0.25, 0.25, 0.25, 0.25, 0.0], np.float64)
        evaluer = EvalueComputation.for_scoring(
            total_t, nuc_scores, nuc_pback, gap_open, gap_extend,
            device=device)

    # NucleotideMatrix at scale 1.0: +2 match / -3 mismatch over ACTG,
    # X (all ambiguity codes) scores -3 everywhere
    idx = np.full(256, 4, np.int8)
    for i, ch in enumerate(b"ACTG"):
        idx[ch] = i
        idx[ch + 32] = i
    score_mat = np.full((5, 5), -3, np.int32)
    np.fill_diagonal(score_mat, 2)
    score_mat[4, 4] = -3

    out = []
    for key, payload in mmseqsdb.read_db(aln_db):
        nq = np.frombuffer(q_nucl[key].rstrip(b"\n"), np.uint8)
        q_start_codon = q_aa[key][:1] == b"*"
        rows = []
        for ln in _lines(payload):
            r = parse_aln_record(ln)
            if not r["backtrace"]:
                raise ValueError("proteinaln2nucl needs backtraces (-a)")
            nt = np.frombuffer(t_nucl[r["dbKey"]].rstrip(b"\n"), np.uint8)
            t_start_codon = t_aa[r["dbKey"]][:1] == b"*"
            r["dbStart"] = r["dbStart"] * 3 + (-3 if t_start_codon else 0)
            r["dbEnd"] = r["dbEnd"] * 3 + 2 + (-3 if t_start_codon else 0)
            r["dbLen"] = len(nt)
            r["qStart"] = r["qStart"] * 3 + (-3 if q_start_codon else 0)
            r["qEnd"] = r["qEnd"] * 3 + 2 + (-3 if q_start_codon else 0)
            r["qLen"] = len(nq)

            id_cnt = aln_len = 0
            qp, tp = r["qStart"], r["dbStart"]
            score = 0
            new_bt = []
            num = ""
            for ch in r["backtrace"]:
                if ch.isdigit():
                    num += ch
                    continue
                cnt = int(num or 0)
                num = ""
                if ch == "M":
                    qs = idx[nq[qp:qp + cnt * 3]].astype(np.int64)
                    ts = idx[nt[tp:tp + cnt * 3]].astype(np.int64)
                    id_cnt += int((nq[qp:qp + cnt * 3]
                                   == nt[tp:tp + cnt * 3]).sum())
                    score += int(score_mat[qs, ts].sum())
                    qp += cnt * 3
                    tp += cnt * 3
                elif ch == "D":
                    tp += cnt * 3
                    score -= gap_open + ((cnt - 1) * 3) * gap_extend
                elif ch == "I":
                    qp += cnt * 3
                    score -= gap_open + ((cnt - 1) * 3) * gap_extend
                else:
                    continue
                aln_len += cnt * 3
                new_bt.append(f"{cnt * 3}{ch}")
            r["score"] = int(evaluer.compute_bit_score(score))  # truncation
            r["eval"] = float(evaluer.compute_evalue(score, len(nq)))
            r["backtrace"] = "".join(new_bt)
            r["seqId"] = np.float32(id_cnt) / np.float32(aln_len)
            rows.append(aln_record_to_line(r, add_backtrace=True))
        out.append((key, "".join(rows).encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES)
    return out_db
