# Copy of metaeuk_tpu/pipeline/expand.py; it differs from its original only in this note.
"""expandaln / expand2profile: transitive alignment expansion.

Port of lib/mmseqs/src/util/expandaln.cpp and
commons/BacktraceTranslator.h: given A->B alignments and B->C
alignments (both with backtraces), infer A->C alignments by walking the
two backtraces in lockstep from the aligned B offset (the reference
advances BOTH backtrace cursors every step and trims the result to the
last match). The default EXPAND_RESCORE_BACKTRACE mode rescores each
inferred alignment along its backtrace (BLOSUM62 + int8 query
composition bias, affine gaps), drops raw scores < -6
(expandaln.cpp:344-351), and keeps one alignment per target sequence.
expand2profile feeds the accepted alignments into the PSSM pipeline.
"""

import numpy as np

from ..io import mmseqsdb
from .dbtools2 import _lines, parse_aln_record

# Martin/Clovis/Eli's transition rules (BacktraceTranslator.h:24-33)
_TRANS = {
    ("M", "M"): "M", ("I", "M"): "I", ("D", "M"): "D",
    ("M", "D"): "D", ("I", "D"): "",  ("D", "D"): "D",
    ("M", "I"): "I", ("I", "I"): "I", ("D", "I"): "",
}


def _expand_bt(cigar):
    import re
    out = []
    for cnt, op in re.findall(r"(\d+)([MID])", cigar or ""):
        out.extend(op * int(cnt))
    return out


def translate_result(ab, bc):
    """BacktraceTranslator::translateResult -> dict(qStart, qEnd,
    dbStart, dbEnd, backtrace) or None when empty."""
    bt_ab = _expand_bt(ab["backtrace"])
    bt_bc = _expand_bt(bc["backtrace"])
    start_b_ab = ab["dbStart"]
    start_b_bc = bc["qStart"]
    dist = abs(start_b_ab - start_b_bc)
    if start_b_ab < start_b_bc:
        a_off = b_off = bt_off = 0
        while b_off < dist and bt_off < len(bt_ab):
            b_off += bt_ab[bt_off] in "MD"
            a_off += bt_ab[bt_off] in "MI"
            bt_off += 1
        off_ab, off_bc = bt_off, 0
        start_a, start_c = ab["qStart"] + a_off, bc["dbStart"]
    elif start_b_ab > start_b_bc:
        b_off = c_off = bt_off = 0
        while b_off < dist and bt_off < len(bt_bc):
            b_off += bt_bc[bt_off] in "MI"
            c_off += bt_bc[bt_off] in "MD"
            bt_off += 1
        off_ab, off_bc = 0, bt_off
        start_a, start_c = ab["qStart"], bc["dbStart"] + c_off
    else:
        off_ab = off_bc = 0
        start_a, start_c = ab["qStart"], bc["dbStart"]

    bt = []
    last_m = 0
    q_len = db_len = 0
    i = 0
    while off_ab < len(bt_ab) and off_bc < len(bt_bc):
        i += 1
        t = _TRANS[(bt_ab[off_ab], bt_bc[off_bc])]
        if t == "":
            i -= 1
        else:
            if t == "M":
                last_m = i
                q_len += 1
                db_len += 1
            elif t == "D":
                q_len += 1
            else:
                db_len += 1
            bt.append(t)
        off_ab += 1
        off_bc += 1
    bt = bt[:last_m]
    if not bt:
        return None
    return dict(qStart=start_a, qEnd=start_a + q_len - 1,
                dbStart=start_c, dbEnd=start_c + db_len - 1,
                backtrace=bt)


def _rescore_by_backtrace(ac, a_enc, c_enc, bias8, gap_open=11,
                          gap_extend=1, q_pssm=None):
    """rescoreResultByBacktrace (expandaln.cpp:27-76): raw score +
    identity count along the translated backtrace. With a profile
    query, match scores come from the query PSSM at the target residue
    (isQueryProf branch, expandaln.cpp:48-49) and a_enc is the profile
    consensus."""
    from ..data.submat import BLOSUM62_SCORES

    q = ac["qStart"]
    t = ac["dbStart"]
    score = 0
    identities = 0
    last = ""
    for state in ac["backtrace"]:
        if state == "M":
            if q_pssm is not None:
                score += int(q_pssm[q, c_enc[t]])
            else:
                score += int(BLOSUM62_SCORES[a_enc[q], c_enc[t]]) + \
                    int(bias8[q])
            identities += int(a_enc[q] == c_enc[t])
            q += 1
            t += 1
        elif state == "I":
            score -= gap_extend if last == "I" else gap_open
            q += 1
        else:  # D
            score -= gap_extend if last == "D" else gap_open
            t += 1
        last = state
    return score, identities


def expandaln_db(a_db, c_db, result_ab, result_bc, out_db,
                 return_aln=True, evalue=1e-3, eval_profile=0.1, cov=0.0,
                 pcmode=0, context_lib=None,
                 cov_mode=0, min_seq_id=0.0, min_aln_len=0,
                 expansion_mode=0, comp_bias_correction=True,
                 filter_msa=1, compressed=False, **profile_kw):
    """expandaln (return_aln=True) / expand2profile (False)."""
    from ..data.submat import AA2NUM, composition_bias_rounded

    if isinstance(context_lib, str):
        from ..ops.csprofile import ContextLibrary
        context_lib = ContextLibrary.from_file(context_lib)
    from ..search.evalue import EvalueComputation
    from ..search.lcaalign import can_be_covered, has_coverage
    from .alnformat import compress_backtrace, matcher_seq_id_text

    a_is_profile = mmseqsdb.read_dbtype(a_db) == 2  # DBTYPE_HMM_PROFILE
    aprof = None
    if a_is_profile:
        from ..io.profiledb import ProfileDB
        aprof = ProfileDB.from_db(str(a_db))
        a_by_key = {int(k): i for i, k in enumerate(aprof.keys)}
    else:
        adb = mmseqsdb.read_seqdb(a_db)
        a_by_key = {int(k): i for i, k in enumerate(adb.keys)}
    same = (not a_is_profile) and str(a_db) == str(c_db)
    cdb = adb if same else mmseqsdb.read_seqdb(c_db)
    c_by_key = {int(k): i for i, k in enumerate(cdb.keys)}
    bc_entries = {k: p for k, p in mmseqsdb.read_db(result_bc)}
    evaluer = EvalueComputation(int(cdb.lengths.sum()), gapped=True)

    out = []
    prof_out = []
    for akey, payload in mmseqsdb.read_db(result_ab):
        q_pssm = None
        if a_is_profile:
            # profile query: numSequence = the profile's stored QUERY
            # residues (Sequence::mapProfile) for identity counting +
            # per-position PSSM (expandaln.cpp:48-49); no composition
            # bias (expandaln.cpp:246-248 requires DBTYPE_AMINO_ACIDS)
            a_enc = aprof.query_seqs[a_by_key[akey]]
            q_pssm = aprof.pssms[a_by_key[akey]]
            bias8 = np.zeros(len(a_enc), np.int64)
        else:
            a_enc = AA2NUM[np.asarray(adb.seq(a_by_key[akey]), np.uint8)]
            if comp_bias_correction:
                bias8 = composition_bias_rounded(a_enc)
            else:
                bias8 = np.zeros(len(a_enc), np.int64)
        accepted = []
        members = []
        seen_targets = set()
        for ln in _lines(payload):
            ab = parse_aln_record(ln)
            if not return_aln and ab["eval"] > eval_profile:
                continue
            bres = bc_entries.get(ab["dbKey"])
            if bres is None:
                continue
            for bln in _lines(bres):
                bc = parse_aln_record(bln)
                ac = translate_result(ab, bc)
                if ac is None:
                    continue
                ckey = bc["dbKey"]
                c_len = int(cdb.lengths[c_by_key[ckey]])
                if not can_be_covered(cov, cov_mode, ab["qLen"], c_len):
                    continue
                if ckey in seen_targets:
                    continue
                c_enc = AA2NUM[np.asarray(cdb.seq(c_by_key[ckey]),
                                          np.uint8)]
                if expansion_mode == 1:  # EXPAND_RESCORE_BACKTRACE
                    raw, idents = _rescore_by_backtrace(ac, a_enc, c_enc,
                                                        bias8,
                                                        q_pssm=q_pssm)
                    if raw < -6:
                        continue
                    ev = evaluer.compute_evalue(raw, len(a_enc))
                    bits = int(evaluer.compute_bit_score(raw) + 0.5)
                    seq_id = idents / float(len(ac["backtrace"]))
                else:
                    ev, bits, seq_id = ab["eval"], ab["score"], ab["seqId"]
                q_cov = (ac["qEnd"] - ac["qStart"] + 1) / float(ab["qLen"])
                t_cov = (ac["dbEnd"] - ac["dbStart"] + 1) / float(c_len)
                eps = np.finfo(np.float32).eps
                if not (has_coverage(cov, cov_mode, q_cov, t_cov)
                        and seq_id >= min_seq_id - eps
                        and ev <= evalue
                        and len(ac["backtrace"]) >= min_aln_len):
                    continue
                seen_targets.add(ckey)
                line = (f"{ckey}\t{bits}\t{matcher_seq_id_text(seq_id)}\t"
                        f"{'%.3E' % ev}\t{ac['qStart']}\t{ac['qEnd']}\t"
                        f"{ab['qLen']}\t{ac['dbStart']}\t{ac['dbEnd']}\t"
                        f"{c_len}\t"
                        f"{compress_backtrace(ac['backtrace'])}\n")
                accepted.append(line)
                if not return_aln:
                    members.append((c_enc, ac["qStart"], ac["dbStart"],
                                    compress_backtrace(ac["backtrace"])))
        if return_aln:
            out.append((akey, "".join(accepted).encode()))
        else:
            from .result2profile import profile_from_alignments
            qid_vec = sorted(int(float(s) * 100) for s in
                             str(profile_kw.get("qid", "0.0")).split(","))
            # expandaln.cpp:400-415 skips calcGlobalAaBiasCorrection
            # (unlike result2profile)
            prof_out.append((akey, profile_from_alignments(
                a_enc, members, comp_bias_correction=False,
                mask_profile=True, filter_msa=bool(filter_msa),
                pcmode=pcmode, context_lib=context_lib,
                qid=qid_vec,
                qsc=profile_kw.get("qsc", -20.0),
                filter_max_seq_id=profile_kw.get("filter_max_seq_id", 0.9),
                ndiff=profile_kw.get("ndiff", 1000),
                cov_msa_thr=profile_kw.get("cov_msa_thr", 0.0))))
    if return_aln:
        # dbtype: alignment | NEED_SRC extended bit (expandaln.cpp:156)
        mmseqsdb.write_db(out_db, out, 5 | (2 << 16),
                          compressed=compressed)
    else:
        dbtype = mmseqsdb.DBTYPE_HMM_PROFILE
        if pcmode == 1:  # expandaln.cpp:150-153
            dbtype |= (4 & 0x7FFE) << 16
        mmseqsdb.write_db(out_db, prof_out, dbtype,
                          compressed=compressed)
    return out_db
