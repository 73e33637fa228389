# Copy of metaeuk_tpu/pipeline/alnformat.py; it differs from its original only in this note.
"""Alignment-result serialization: Matcher 10-column format and BLAST m8.

resultToBuffer port (lib/mmseqs/src/alignment/Matcher.cpp:280-327) for the
alignment DB payloads, and the convertalignments BLAST-tab export
(lib/mmseqs/src/util/convertalignments.cpp) — without backtraces the
mismatch/gapopen columns are estimates (identities from the estimated
sequence identity), which is a documented approximation.
"""

import numpy as np


def format_seq_id(seq_id):
    from .predict import format_seq_id as f
    return f(seq_id)


def compress_backtrace(bt):
    """Matcher::compressAlignment run-length CIGAR (Matcher.cpp:171-186)."""
    out = []
    prev, cnt = None, 0
    for op in bt:
        if op == prev:
            cnt += 1
        else:
            if prev:
                out.append(f"{cnt}{prev}")
            prev, cnt = op, 1
    if prev:
        out.append(f"{cnt}{prev}")
    return "".join(out)


def matcher_seq_id_text(s):
    """resultToBuffer's seqId text: for seqId == 1.0 the trailing separator
    write clobbers the last digit (fastSeqIdToBuffer returns the NUL slot,
    Util.cpp:222-235 + Matcher.cpp:286-287) -> "1.00", not "1.000"."""
    import numpy as np
    if np.float32(s) == np.float32(1.0):
        return "1.00"
    return format_seq_id(s)


def hit_to_matcher_line(hit, backtrace=None, seq_id=None):
    """10/11-column alignment record for one HIT_DTYPE row
    (resultToBuffer, Matcher.cpp:280-327)."""
    cols = [
        str(int(hit["target_idx"])),
        str(int(hit["bit_score"])),
        matcher_seq_id_text(hit["seq_id"] if seq_id is None else seq_id),
        "%.3E" % hit["evalue"],
        str(int(hit["q_start"])),
        str(int(hit["q_end"])),
        str(int(hit["q_len"])),
        str(int(hit["t_start"])),
        str(int(hit["t_end"])),
        str(int(hit["t_len"])),
    ]
    if backtrace is not None:
        cols.append(compress_backtrace(backtrace))
    return "\t".join(cols) + "\n"


def hits_to_aln_db_entries(hits, n_queries, backtraces=None, seq_ids=None):
    """Group hits (already in compareHits order per query) into per-query
    alignment-DB payloads."""
    payloads = {qi: [] for qi in range(n_queries)}
    for idx, hit in enumerate(hits):
        bt = backtraces[idx] if backtraces is not None else None
        sid = seq_ids[idx] if seq_ids is not None else None
        payloads[int(hit["orf_idx"])].append(hit_to_matcher_line(hit, bt, sid))
    return [(qi, "".join(payloads[qi]).encode()) for qi in range(n_queries)]


def hit_to_m8_line(hit, q_acc, t_acc):
    """BLAST tab (m8): q, t, pident, alnLen, mismatch, gapopen,
    qstart, qend, tstart, tend, evalue, bits (1-based coords)."""
    aln_len = int(max(abs(hit["q_end"] - hit["q_start"]),
                      abs(hit["t_end"] - hit["t_start"])) + 1)
    pident_text = format_seq_id(hit["seq_id"])
    mismatch = int(round(aln_len * (1.0 - float(pident_text))))
    return (f"{q_acc}\t{t_acc}\t{pident_text}\t{aln_len}\t{mismatch}\t0\t"
            f"{int(hit['q_start']) + 1}\t{int(hit['q_end']) + 1}\t"
            f"{int(hit['t_start']) + 1}\t{int(hit['t_end']) + 1}\t"
            f"{'%.3E' % hit['evalue']}\t{int(hit['bit_score'])}\n")


def blast_tab_line(r, q_acc, t_acc):
    """One default-format convertalis row (convertalignments.cpp:405-460)
    from a parsed alignment record: exact alnlen/mismatch/gapopen from the
    backtrace when present, the documented estimate otherwise (adjusted
    -1 starts, Matcher.cpp:231-234)."""
    import re as _re
    if r.get("backtrace"):
        aln_len = match_count = gap_open = 0
        for cnt, op in _re.findall(r"(\d+)([MID])", r["backtrace"]):
            n = int(cnt)
            aln_len += n
            if op == "M":
                match_count += n
            else:
                gap_open += 1
        identical = int(np.float32(r["seqId"]) * np.float32(aln_len) +
                        np.float32(0.5))
        mismatch = match_count - identical
    else:
        adj_q = 0 if r["qStart"] == -1 else r["qStart"]
        adj_d = 0 if r["dbStart"] == -1 else r["dbStart"]
        aln_len = max(abs(r["qEnd"] - adj_q), abs(r["dbEnd"] - adj_d)) + 1
        best = np.float32(min(abs(r["qEnd"] - adj_q),
                              abs(r["dbEnd"] - adj_d)))
        mismatch = int(best * (np.float32(1.0) - np.float32(r["seqId"])) +
                       np.float32(0.5))
        gap_open = 0
    return (f"{q_acc}\t{t_acc}\t{r['seqId']:.3f}\t{aln_len}\t{mismatch}\t"
            f"{gap_open}\t{r['qStart'] + 1}\t{r['qEnd'] + 1}\t"
            f"{r['dbStart'] + 1}\t{r['dbEnd'] + 1}\t"
            f"{'%.3E' % r['eval']}\t{r['score']}\n")


def write_blast_tab(query_db, target_db, aln_db, out_path):
    """convertalis default format over a whole alignment DB."""
    from ..io import mmseqsdb

    qdb = mmseqsdb.read_seqdb(query_db)
    tdb = mmseqsdb.read_seqdb(target_db)
    q_acc = {int(k): qdb.accession(i) for i, k in enumerate(qdb.keys)}
    t_acc = {int(k): tdb.accession(i) for i, k in enumerate(tdb.keys)}
    from .dbtools2 import _lines, parse_aln_record
    with open(out_path, "w") as f:
        for key, payload in mmseqsdb.read_db(aln_db):
            for ln in _lines(payload):
                r = parse_aln_record(ln)
                f.write(blast_tab_line(r, q_acc.get(key, str(key)),
                                       t_acc.get(r["dbKey"],
                                                 str(r["dbKey"]))))
    return out_path
