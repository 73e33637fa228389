# Copy of metaeuk_tpu/pipeline/dbtools7.py; it differs from its original only in this note.
"""Util batch 9: tsv2exprofiledb, createclusearchdb, transitivealign,
msa2result.

Ports of lib/mmseqs/src/util/{createclusterdb,transitivealign,
msa2result}.cpp and data/workflow/tsv2exprofiledb.sh. Byte parity on
tests/golden/util9 fixtures.
"""

import os
import shutil

import numpy as np

from ..io import mmseqsdb
from .dbtools2 import _lines, parse_aln_record


def update_result_by_rescoring_backtrace(q_text, t_text, res, evaluer,
                                         scores, gap_open=11, gap_extend=1):
    """Matcher::updateResultByRescoringBacktrace (Matcher.cpp:345-414):
    local-max rescan of the backtrace, replacing coords/score/eval/seqId
    and trimming the backtrace to the maximal window. q_text/t_text are
    ASCII sequences; scores an ASCII-indexed matrix."""
    max_score = 0
    max_bt_end = max_bt_start = 0
    max_q_end = max_q_start = 0
    max_t_start = max_t_end = 0
    min_pos = -1
    min_q = res["qStart"] - 1
    min_t = res["dbStart"] - 1
    score = 0
    identical = 0
    max_ident = 0
    qpos = res["qStart"]
    tpos = res["dbStart"]
    gap_opened = False
    bt = res["backtrace"]
    for pos, letter in enumerate(bt):
        if letter == "M":
            curr = int(scores[ord(q_text[qpos]), ord(t_text[tpos])])
            identical += int(q_text[qpos] == t_text[tpos])
            gap_opened = False
        else:
            curr = -(gap_extend if gap_opened else gap_open)
            gap_opened = True
        score += curr
        if score <= 0:
            score = 0
            identical = 0
            min_pos = pos
            min_q = qpos - 1 if letter == "D" else qpos
            min_t = tpos - 1 if letter == "I" else tpos
        if score > max_score:
            max_bt_end = pos
            max_q_end = qpos
            max_t_end = tpos
            max_bt_start = min_pos + 1
            max_q_start = min_q + 1
            max_t_start = min_t + 1
            max_score = score
            max_ident = identical
        if letter in "MI":
            qpos += 1
        if letter in "MD":
            tpos += 1
    aln_len = (max_bt_end - max_bt_start) + 1
    res = dict(res)
    res["qStart"], res["qEnd"] = max_q_start, max_q_end
    res["dbStart"], res["dbEnd"] = max_t_start, max_t_end
    res["score"] = int(evaluer.compute_bit_score(max_score))
    res["eval"] = evaluer.compute_evalue(max_score, res["qLen"])
    res["seqId"] = np.float32(max_ident) / np.float32(aln_len)
    res["backtrace"] = bt[max_bt_start:max_bt_start + aln_len]
    return res


def _aln_line(r):
    from .alnformat import compress_backtrace, matcher_seq_id_text
    return (f"{r['dbKey']}\t{r['score']}\t"
            f"{matcher_seq_id_text(r['seqId'])}\t{'%.3E' % r['eval']}\t"
            f"{r['qStart']}\t{r['qEnd']}\t{r['qLen']}\t{r['dbStart']}\t"
            f"{r['dbEnd']}\t{r['dbLen']}\t"
            f"{compress_backtrace(r['backtrace'])}\n")


def tsv2exprofiledb(in_base, out_db, compressed=True):
    """tsv2exprofiledb.sh: <base>{,_h,_seq,_aln}.tsv -> expandable
    profile DB set via tsv2db (dbtypes 0/12/0/5), main+seq compressed by
    default."""
    from .dbtools import tsv2db

    tsv2db(f"{in_base}_seq.tsv", f"{out_db}_seq", output_dbtype=0)
    tsv2db(f"{in_base}_h.tsv", f"{out_db}_seq_h", output_dbtype=12)
    tsv2db(f"{in_base}.tsv", out_db, output_dbtype=0)
    tsv2db(f"{in_base}_aln.tsv", f"{out_db}_aln", output_dbtype=5)
    if compressed:
        for db in (f"{out_db}_seq", out_db, f"{out_db}_aln"):
            entries = mmseqsdb.read_db(db)
            dbtype = mmseqsdb.read_dbtype(db) & 0x7FFFFFFF
            mmseqsdb.write_db(db, entries, dbtype, compressed=True)
    return out_db


def createclusearchdb(seq_db, clu_db, out_db):
    """createclusterdb.cpp (createclusearchdb): split the sequence DB
    into representative (out) and member (out_seq, reps first via a .0
    alias + .1 members file with a merged index) DBs; copies the cluster
    DB and ancillary files."""
    clu = mmseqsdb.read_db(clu_db)
    rep_keys = [int(k) for k, _p in clu]

    for suffix in ("", "_h"):
        src = f"{seq_db}{suffix}"
        entries = dict(mmseqsdb.read_db(src))
        dbtype = mmseqsdb.read_dbtype(src)
        rep_out = [(k, entries[k]) for k in rep_keys]
        mmseqsdb.write_db(f"{out_db}{suffix}", rep_out, dbtype)
        member_out = []
        for rkey, payload in clu:
            for ln in payload.decode().splitlines():
                if not ln:
                    continue
                mkey = int(ln.split()[0])
                if mkey == int(rkey):
                    continue
                member_out.append((mkey, entries[mkey]))
        # members land in <out>_seq.1; <out>_seq.0 aliases the rep DB;
        # the merged index covers reps (offsets in .0) then members
        # (offsets shifted past .0)
        mmseqsdb.write_db(f"{out_db}_seq{suffix}.1x", member_out, dbtype)
        os.replace(f"{out_db}_seq{suffix}.1x", f"{out_db}_seq{suffix}.1")
        rep_size = os.path.getsize(f"{out_db}{suffix}")
        if os.path.lexists(f"{out_db}_seq{suffix}.0"):
            os.remove(f"{out_db}_seq{suffix}.0")
        os.symlink(os.path.basename(f"{out_db}{suffix}"),
                   f"{out_db}_seq{suffix}.0")
        rows = []
        for ln in open(f"{out_db}{suffix}.index"):
            k, o, l = ln.split("\t")
            rows.append((int(k), int(o), int(l)))
        for ln in open(f"{out_db}_seq{suffix}.1x.index") \
                if os.path.exists(f"{out_db}_seq{suffix}.1x.index") else []:
            pass
        member_rows = []
        off = 0
        for k, p in member_out:
            member_rows.append((k, rep_size + off, len(p) + 1))
            off += len(p) + 1
        rows.extend(member_rows)
        rows.sort(key=lambda r: r[0])
        with open(f"{out_db}_seq{suffix}.index", "w") as f:
            for k, o, l in rows:
                f.write(f"{k}\t{o}\t{l}\n")
        shutil.copyfile(f"{out_db}{suffix}.dbtype",
                        f"{out_db}_seq{suffix}.dbtype")
        for stray in (f"{out_db}_seq{suffix}.1x.index",):
            if os.path.exists(stray):
                os.remove(stray)
        if os.path.exists(f"{out_db}_seq{suffix}.1.index"):
            os.remove(f"{out_db}_seq{suffix}.1.index")
        if os.path.exists(f"{out_db}_seq{suffix}.1.dbtype"):
            os.remove(f"{out_db}_seq{suffix}.1.dbtype")

    for s in ("", ".index", ".dbtype"):
        shutil.copyfile(f"{clu_db}{s}", f"{out_db}_clu{s}")
    for suffix in (".lookup", ".source", "_mapping", "_taxonomy"):
        if os.path.exists(f"{seq_db}{suffix}"):
            shutil.copyfile(f"{seq_db}{suffix}", f"{out_db}{suffix}")
    return out_db


def transitivealign(seq_db, aln_db, out_db, evalue=1e-3, cov=0.0,
                    cov_mode=0, min_seq_id=0.0, min_aln_len=0,
                    compressed=False):
    """transitivealign.cpp: for every alignment entry B (the center),
    infer A->C for all member pairs by translating (B->A swapped,
    B->C) backtraces and rescoring; identical A==C pairs score the full
    substitution distance with seqId 1.0; results regrouped per query A
    across all centers (the reference's offset-merge phase)."""
    from ..data.submat import AA2NUM, BLOSUM62_SCORES
    from ..search.evalue import EvalueComputation
    from ..search.lcaalign import can_be_covered
    from .expand import translate_result
    from .rescorediagonal import _ascii_scores

    sdb = mmseqsdb.read_seqdb(seq_db)
    s_by_key = {int(k): i for i, k in enumerate(sdb.keys)}
    evaluer = EvalueComputation(int(sdb.lengths.sum()), gapped=True)
    scores = _ascii_scores()
    texts = {int(k): bytes(sdb.seq_bytes(i)).decode()
             for i, k in enumerate(sdb.keys)}

    per_query = {}
    for bkey, payload in mmseqsdb.read_db(aln_db):
        results = [parse_aln_record(ln) for ln in _lines(payload)]
        for r in results:
            r["backtrace"] = r.get("backtrace") or ""
        for ri in results:
            akey = ri["dbKey"]
            if akey == bkey:
                # center itself: forward its alignment lines verbatim
                from .dbtools2 import aln_record_to_line
                for r in results:
                    per_query.setdefault(akey, []).append(
                        (None, aln_record_to_line(r, True)))
                continue
            swapped = dict(ri)
            swapped["qStart"], swapped["dbStart"] = \
                ri["dbStart"], ri["qStart"]
            swapped["qEnd"], swapped["dbEnd"] = ri["dbEnd"], ri["qEnd"]
            swapped["qLen"], swapped["dbLen"] = ri["dbLen"], ri["qLen"]
            swapped["backtrace"] = "".join(
                "D" if c == "I" else ("I" if c == "D" else c)
                for c in ri["backtrace"])
            rows = []
            for rj in results:
                if not can_be_covered(cov, cov_mode, swapped["qLen"],
                                      rj["dbLen"]):
                    continue
                if ri["dbKey"] == rj["dbKey"]:
                    q = texts[akey]
                    L = rj["dbLen"]
                    raw = sum(int(scores[ord(a), ord(b)])
                              for a, b in zip(q[:L], q[:L]))
                    r = dict(dbKey=rj["dbKey"], dbLen=L, qLen=L,
                             score=int(evaluer.compute_bit_score(raw)),
                             eval=evaluer.compute_evalue(raw, L),
                             seqId=1.0, qStart=0, qEnd=L - 1,
                             dbStart=0, dbEnd=L - 1,
                             backtrace="M" * L)
                else:
                    ac = translate_result(swapped, rj)
                    if ac is None:
                        continue
                    r = dict(dbKey=rj["dbKey"], qLen=swapped["qLen"],
                             dbLen=rj["dbLen"], score=rj["score"],
                             seqId=rj["seqId"], eval=rj["eval"],
                             qStart=ac["qStart"], qEnd=ac["qEnd"],
                             dbStart=ac["dbStart"], dbEnd=ac["dbEnd"],
                             backtrace="".join(ac["backtrace"]))
                    r = update_result_by_rescoring_backtrace(
                        texts[akey], texts[rj["dbKey"]], r, evaluer,
                        scores)
                # checkCriteria
                eps = np.finfo(np.float32).eps
                q_cov = (r["qEnd"] - r["qStart"] + 1) / r["qLen"]
                t_cov = (r["dbEnd"] - r["dbStart"] + 1) / r["dbLen"]
                from ..search.lcaalign import has_coverage
                if not (has_coverage(cov, cov_mode, q_cov, t_cov)
                        and r["seqId"] >= min_seq_id - eps
                        and r["eval"] <= evalue
                        and len(r["backtrace"]) >= min_aln_len):
                    continue
                rows.append(r)
            rows.sort(key=lambda r: (r["eval"], -r["score"],
                                     r["dbLen"], r["dbKey"]))
            for r in rows:
                per_query.setdefault(akey, []).append((None, _aln_line(r)))

    out = [(int(k), "".join(ln for _x, ln in
                            per_query.get(int(k), [])).encode())
           for k in sdb.keys]
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES,
                      compressed=compressed)
    return out_db


def msa2result(msa_db, out_seq_db, out_aln_db, match_ratio=0.5,
               filter_msa=1, qid="0.0", qsc=-20.0, filter_max_seq_id=0.9,
               ndiff=1000, filter_min_enable=0, compressed=False):
    """msa2result.cpp: per MSA entry, write the member sequences
    (sequential keys across entries) and each member's alignment to the
    column-masked consensus, rescored along the backtrace with the
    -0.2-biased ASCII matrix."""
    from ..data.submat import AA2NUM, scores_with_bias
    from ..ops.msafilter import msa_filter
    from ..search.evalue import EvalueComputation
    from .msa2profile import (GAP, compute_pssm_from_msa,
                              compute_sequence_weights)

    sub = scores_with_bias(2.0, -0.2)
    ascii_scores = sub[AA2NUM][:, AA2NUM].astype(np.int64)
    entries = mmseqsdb.read_db(msa_db)
    evaluer = EvalueComputation(len(entries), gapped=True)
    qid_vec = sorted(int(float(s) * 100) for s in str(qid).split(","))

    seq_out = []
    hdr_out = []
    aln_out = []
    next_key = 0
    for msa_key, payload in entries:
        text = payload.decode().rstrip("\x00")
        if text.startswith("#"):
            text = text.split("\n", 1)[1] if "\n" in text else ""
        headers = []
        rows_text = []
        hdr = None
        seq = []
        for line in text.split("\n"):
            if line.startswith(">"):
                if hdr is not None:
                    headers.append(hdr)
                    rows_text.append("".join(seq))
                hdr = line[1:]
                seq = []
            elif line:
                seq.append(line)
        if hdr is not None:
            headers.append(hdr)
            rows_text.append("".join(seq))
        if not rows_text:
            continue
        start_key = next_key
        for h, s in zip(headers, rows_text):
            hdr_out.append((next_key, (h + "\n").encode()))
            seq_out.append((next_key,
                            s.replace("-", "").encode() + b"\n"))
            next_key += 1
        # the reference's set-size scan counts one extra per entry (the
        # trailing "last entry" bump fires on the NUL terminator,
        # msa2result.cpp:109-115), shifting subsequent key offsets
        next_key = start_key + len(rows_text) + 1

        L_gaps = len(rows_text[0])
        K = len(rows_text)
        msa = np.zeros((K, L_gaps), np.uint8)
        for k, s in enumerate(rows_text):
            arr = np.frombuffer(s[:L_gaps].encode(), np.uint8)
            enc = AA2NUM[arr]
            msa[k] = np.where(arr == ord("-"), np.uint8(GAP), enc)

        # match-mode-1 masked columns (identical to msa2profile)
        w = compute_sequence_weights(msa)
        X = msa.copy()
        ENDGAP = 22
        for k in range(K):
            i = 0
            while i < L_gaps and X[k, i] == GAP:
                X[k, i] = ENDGAP
                i += 1
            i = L_gaps - 1
            while i >= 0 and X[k, i] == GAP:
                X[k, i] = ENDGAP
                i -= 1
        masked = np.zeros(L_gaps, bool)
        for col in range(L_gaps):
            res = np.float32(0.0)
            gap = np.float32(0.0)
            for k in range(K):
                v = X[k, col]
                if v < GAP:
                    res = np.float32(res + w[k])
                elif v != ENDGAP:
                    gap = np.float32(gap + w[k])
            masked[col] = bool(gap / (res + gap) >
                               np.float32(match_ratio)) \
                if (res + gap) != 0 else False
        kept = ~masked
        msa_m = np.ascontiguousarray(msa[:, kept])
        filt = msa_m
        if filter_msa:
            _, order, size = msa_filter(
                msa_m, coverage=0, qid_vec=qid_vec, qsc=qsc,
                max_seqid=int(filter_max_seq_id * 100), ndiff=ndiff,
                filter_min_enable=filter_min_enable)
            filt = np.ascontiguousarray(msa_m[order[:size]])
        res = compute_pssm_from_msa(filt)
        from ..data.submat import ALPHABET as _ALPHA
        consensus_txt = "".join(_ALPHA[c] for c in res["consensus"])

        lines = []
        for i in range(K):
            bt = []
            cons_ng = []
            seq_ng = []
            ident = 0
            ccol = 0
            from ..data.submat import ALPHABET
            for j in range(L_gaps):
                if masked[j]:
                    seq_res = "-" if msa[i, j] == GAP \
                        else ALPHABET[msa[i, j]]
                    con_res = "-"
                else:
                    con_res = consensus_txt[ccol]
                    seq_res = "-" if msa[i, j] == GAP \
                        else ALPHABET[msa[i, j]]
                    ccol += 1
                if con_res == "-" and seq_res == "-":
                    continue
                if con_res != "-" and seq_res == "-":
                    bt.append("I")
                    cons_ng.append(con_res)
                elif con_res == "-" and seq_res != "-":
                    bt.append("D")
                    seq_ng.append(seq_res)
                else:
                    bt.append("M")
                    seq_ng.append(seq_res)
                    cons_ng.append(con_res)
                if con_res == seq_res:
                    ident += 1
            cons_s = "".join(cons_ng)
            seq_s = "".join(seq_ng)
            r = dict(dbKey=start_key + i, score=0,
                     seqId=np.float32(ident) / np.float32(len(bt)),
                     eval=0.0, qStart=0, qEnd=len(cons_s) - 1,
                     qLen=len(cons_s), dbStart=0, dbEnd=len(seq_s) - 1,
                     dbLen=len(seq_s), backtrace="".join(bt))
            r = update_result_by_rescoring_backtrace(
                cons_s, seq_s, r, evaluer, ascii_scores)
            lines.append(_aln_line(r))
        aln_out.append((msa_key, "".join(lines).encode()))

    mmseqsdb.write_db(out_seq_db, seq_out, 0, compressed=compressed)
    mmseqsdb.write_db(f"{out_seq_db}_h", hdr_out, 12,
                      compressed=compressed)
    mmseqsdb.write_db(out_aln_db, aln_out, 5, compressed=compressed)
    return out_aln_db
