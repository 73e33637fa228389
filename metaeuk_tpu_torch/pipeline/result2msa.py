# Copy of metaeuk_tpu/pipeline/result2msa.py; it differs from its original only in this note.
"""result2msa: alignment result DB -> MSA DB.

Port of lib/mmseqs/src/util/result2msa.cpp for the FASTA-DB (mode 2),
Stockholm-flat (mode 4), and A3M (mode 5) output formats, with the
optional MsaFilter (--filter-msa 1). MSA rows come from the same
MultipleAlignment::computeMSA(noDeletionMSA=true) construction as
result2profile (pipeline/result2profile.py).
"""

import numpy as np

from ..data.submat import ALPHABET
from ..io import mmseqsdb
from ..ops.pssm import GAP
from .result2profile import msa_row_from_backtrace, parse_aln_record

DBTYPE_MSA_DB = 11

_NUM2AA = ALPHABET


def _build_msa(center_enc, members):
    L = len(center_enc)
    msa = np.empty((1 + len(members), L), np.uint8)
    msa[0] = center_enc
    for i, (t_enc, qs, ts, cigar) in enumerate(members):
        msa[1 + i] = msa_row_from_backtrace(L, t_enc, qs, ts, cigar)
    return msa


def _expand_cigar(cigar):
    import re
    out = []
    for cnt, op in re.findall(r"(\d+)([MID])", cigar or ""):
        out.extend(op * int(cnt))
    return out


def _build_msa_with_deletions(center_enc, members):
    """--allow-deletion MSA (MultipleAlignment.cpp:44-218): member
    deletion runs become columns (center shows gaps), rows padded with
    gaps, and the writer truncates at res.centerLength = L columns."""
    L = len(center_enc)
    # queryGaps: per center position, the max deletion-run length ending
    # at that (post-run) position over all members
    query_gaps = np.zeros(L + 1, np.int64)
    expanded = []
    for (_t, qs, _ts, cigar) in members:
        bt = _expand_cigar(cigar)
        expanded.append(bt)
        qpos = qs
        run = 0
        for op in bt:
            if op == "M":
                qpos += 1
                run = 0
            elif op == "I":
                qpos += 1
                run = 0
            else:
                run += 1
                query_gaps[qpos] = max(query_gaps[qpos], run)
    # center row
    crow = []
    for qp in range(L):
        crow.extend([GAP] * int(query_gaps[qp]))
        crow.append(int(center_enc[qp]))
    size = len(crow)
    rows = [crow]
    for (t_enc, qs, ts, cigar), bt in zip(members, expanded):
        row = [GAP] * qs
        qpos, tpos = qs, ts
        i = 0
        while i < len(bt):
            op = bt[i]
            if op == "I":
                row.append(GAP)
                qpos += 1
                i += 1
            elif op == "D":
                while i < len(bt) and bt[i] == "D":
                    row.append(int(t_enc[tpos]))
                    tpos += 1
                    i += 1
                if i >= len(bt):
                    break
                if bt[i] == "I":
                    row.append(GAP)
                    qpos += 1
                else:  # M directly after a deletion run: no gap padding
                    row.append(int(t_enc[tpos]))
                    qpos += 1
                    tpos += 1
                i += 1
            else:  # M
                row.extend([GAP] * int(query_gaps[qpos]))
                row.append(int(t_enc[tpos]))
                qpos += 1
                tpos += 1
                i += 1
        row.extend([GAP] * (size - len(row)))
        rows.append(row[:size])
    msa = np.array([r[:L] + [GAP] * max(0, L - len(r)) for r in rows],
                   np.uint8)
    return msa


def _row_text(row):
    return "".join(_NUM2AA[c] if c < GAP else "-" for c in row)


def result2msa_db(query_db, target_db, aln_db, out_db, msa_format_mode=2,
                  filter_msa=False, skip_query=False, cov_msa_thr=0.0,
                  qid=(0,), qsc=-20.0, filter_max_seq_id=0.9, n_diff=1000,
                  filter_min_enable=0, allow_deletion=False):
    from ..data.submat import encode_aa
    from ..io.fasta import parse_fasta_header

    q_seqs = {k: encode_aa(p) for k, p in mmseqsdb.read_seq_entries(query_db)}
    q_hdrs = dict(mmseqsdb.read_db(f"{query_db}_h"))
    same_db = query_db == target_db
    if same_db:
        t_seqs, t_hdrs = q_seqs, q_hdrs
    else:
        t_seqs = {k: encode_aa(p)
                  for k, p in mmseqsdb.read_seq_entries(target_db)}
        t_hdrs = dict(mmseqsdb.read_db(f"{target_db}_h"))

    stockholm = msa_format_mode == 4
    out = []
    for key, payload in mmseqsdb.read_db(aln_db):
        center = q_seqs[key]
        members = []
        seq_keys = []
        for ln in payload.decode().split("\n"):
            if not ln:
                continue
            t_key, _, q_start, t_start, bt = parse_aln_record(ln)
            if same_db and t_key == key:
                continue
            members.append((t_seqs[t_key], q_start, t_start, bt))
            seq_keys.append(t_key)
        msa = _build_msa_with_deletions(center, members) \
            if allow_deletion else _build_msa(center, members)
        kept = np.ones(len(msa), bool)
        if filter_msa:
            from ..ops.msafilter import msa_filter
            flags, _, _ = msa_filter(
                msa, coverage=int(cov_msa_thr * 100), qid_vec=qid, qsc=qsc,
                max_seqid=int(filter_max_seq_id * 100), ndiff=n_diff,
                filter_min_enable=filter_min_enable)
            kept = np.asarray(flags) > 0

        def header_of(i):
            if i == 0:
                return q_hdrs[key].decode().rstrip("\n")
            return t_hdrs[seq_keys[i - 1]].decode().rstrip("\n")

        rows = []
        start = 1 if skip_query else 0
        if stockholm:
            rows.append("# STOCKHOLM 1.0\n")
            if skip_query:
                rows.append("#=GF ID "
                            + parse_fasta_header(header_of(0)) + "\n")
        for i in range(start, len(msa)):
            if not kept[i]:
                continue
            only_gap = bool((msa[i] >= GAP).all())
            if stockholm:
                acc = "DUMMY" if only_gap \
                    else parse_fasta_header(header_of(i))
                rows.append(f"{acc} {_row_text(msa[i])}\n")
            elif msa_format_mode == 5:  # A3M
                acc = "DUMMY" if only_gap \
                    else parse_fasta_header(header_of(i))
                rows.append(f">{acc}\n{_row_text(msa[i])}\n")
            else:  # FASTADB
                hdr = "DUMMY" if only_gap else header_of(i)
                rows.append(f">{hdr}\n{_row_text(msa[i])}\n")
        if stockholm:
            rows.append("//\n")
        out.append((key, "".join(rows).encode()))
    if stockholm:
        # FORMAT_MSA_STOCKHOLM_FLAT: flat file, no index/NUL bytes
        with open(out_db, "wb") as f:
            for _, body in out:
                f.write(body)
    else:
        mmseqsdb.write_db(out_db, out, DBTYPE_MSA_DB)
    return out_db
