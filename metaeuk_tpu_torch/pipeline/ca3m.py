# Copy of metaeuk_tpu/pipeline/ca3m.py; it differs from its original only in this note.
"""Compressed A3M (ca3m) databases: convertca3m + generation.

convertca3m ports lib/mmseqs/src/util/convertca3m.cpp +
commons/CompressedA3M.cpp extractMatcherResults: the HH-suite
compressed-A3M block format (u32 sequence line index, u16 1-based
start, u16 block count, then [match-count u8, indel i8] pairs; leading
query gaps as negative indel blocks) is expanded back to Matcher
result lines (score/seqId/eval zero).

Generation (result2msa --msa-format-mode 0/1 in the reference CLI) is
DISABLED upstream (result2msa.cpp:41-44 returns an error
unconditionally); `result2msa_ca3m` implements it from the remaining
dead code (result2msa.cpp:75-96,473-516 + CompressedA3M::hitToBuffer):
a concatenated query+target _sequence/_header pair with renumbered
keys, and per-query ca3m entries of the (consensus) header + query
sequence + ';' + block-encoded hits. Round-trip verified through the
reference convertca3m binary (tests/golden/ca3m).
"""

import re
import struct

from ..io import mmseqsdb

DBTYPE_CA3M = 10


def expand_cigar(cigar):
    return "".join(int(n) * c for n, c in re.findall(r"(\d+)([MID])",
                                                     cigar))


def hit_to_ca3m_block(target_id, q_start, db_start, backtrace):
    """CompressedA3M::hitToBuffer (CompressedA3M.cpp:270-358)."""
    out = bytearray(struct.pack("<IH", target_id, db_start + 1))
    blocks = bytearray()
    nb = 0
    gap = q_start
    while gap:
        g = min(127, gap)
        blocks += bytes([0, (-g) & 0xFF])
        gap -= g
        nb += 1
    i = 0
    bt = backtrace
    while i < len(bt):
        ml = 0
        while i < len(bt) and bt[i] == "M" and ml < 255:
            i += 1
            ml += 1
        ch = bt[i] if i < len(bt) and bt[i] != "M" else None
        il = 0
        while ch and i < len(bt) and bt[i] == ch and il < 127:
            i += 1
            il += 1
        val = il if ch == "D" else ((-il) & 0xFF if ch == "I" else 0)
        blocks += bytes([ml, val & 0xFF])
        nb += 1
    out += struct.pack("<H", nb)
    out += blocks
    return bytes(out)


def _read_ffindex(base):
    """(key_string, payload_with_terminator) in ffindex line order."""
    idx = [ln.rstrip("\n").split("\t") for ln in open(base + ".ffindex")]
    data = open(base + ".ffdata", "rb").read()
    return [(k, data[int(o):int(o) + int(l)]) for k, o, l in idx]


def extract_matcher_results(data, seq_keys, seq_lens, skip_first=True):
    """CompressedA3M::extractMatcherResults (CompressedA3M.cpp:148-268).
    `data` includes the trailing NUL; seq_keys/seq_lens are the
    _sequence DB in ffindex LINE order (SORT_BY_LINE ids)."""
    size = len(data)
    pos = 0
    last = 0
    if data[pos:pos + 1] == b"#":
        while data[pos] != 0x0A:
            pos += 1
        last = 0x0A
        pos += 1
    while not (last == 0x0A and data[pos:pos + 1] == b";") and pos < size:
        last = data[pos]
        pos += 1
    pos += 1  # past ';'

    results = []
    key = None
    q_len = 0
    first = True
    while pos < size - 1:
        entry_index = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        db_key = seq_keys[entry_index]
        if first:
            key = db_key
            q_len = seq_lens[entry_index]
            db_len = q_len
        else:
            db_len = seq_lens[entry_index]
        start_pos = struct.unpack_from("<H", data, pos)[0]
        pos += 2
        db_start = start_pos - 1
        nr_blocks = struct.unpack_from("<H", data, pos)[0]
        pos += 2
        if skip_first and first:
            pos += 2 * nr_blocks
            first = False
            continue
        q_start = 0
        q_aln = 0
        db_aln = 0
        first_block_m = False
        bt = []
        for _ in range(nr_blocks):
            match_count = data[pos]
            pos += 1
            q_aln += match_count
            db_aln += match_count
            bt.append("M" * match_count)
            if match_count != 0:
                first_block_m = True
            indel = data[pos]
            pos += 1
            if indel >= 128:
                indel -= 256  # signed char
            if not first_block_m:
                q_start -= indel
            elif indel > 0:
                bt.append("D" * indel)
                q_aln += indel
            elif indel < 0:
                bt.append("I" * (-indel))
                db_aln -= indel
        results.append(dict(
            dbKey=db_key, score=0, seqId=0.0, eval=0.0, qStart=q_start,
            qEnd=q_start + db_aln - 1, qLen=q_len, dbStart=db_start,
            dbEnd=db_start + q_aln - 1, dbLen=db_len,
            backtrace="".join(bt)))
    return key, results


def convertca3m(in_base, out_db, compressed=False):
    """convertca3m.cpp: expand a ca3m DB to an alignment result DB
    (keyed by each entry's first/master sequence, resultToBuffer with
    compressed backtraces)."""
    from .alnformat import compress_backtrace, matcher_seq_id_text

    seq_keys = []
    seq_lens = []
    for ln in open(f"{in_base}_sequence.ffindex"):
        k, o, l = ln.split("\t")
        seq_keys.append(int(k))
        seq_lens.append(int(l) - 2)

    out = []
    for _, payload in _read_ffindex(f"{in_base}_ca3m"):
        key, results = extract_matcher_results(payload, seq_keys,
                                               seq_lens)
        rows = []
        for r in results:
            rows.append(
                f"{r['dbKey']}\t{r['score']}\t"
                f"{matcher_seq_id_text(r['seqId'])}\t"
                f"{'%.3E' % r['eval']}\t{r['qStart']}\t{r['qEnd']}\t"
                f"{r['qLen']}\t{r['dbStart']}\t{r['dbEnd']}\t"
                f"{r['dbLen']}\t"
                f"{compress_backtrace(r['backtrace'])}\n")
        out.append((key, "".join(rows).encode()))
    mmseqsdb.write_db(out_db, out, DBTYPE_CA3M, sort_index=True,
                      compressed=compressed)
    return out_db


def result2msa_ca3m(query_db, target_db, aln_db, out_base,
                    consensus=False, filter_msa=0):
    """result2msa --msa-format-mode 0/1 (ca3m output): concatenated
    _sequence/_header DBs (query keys 0..nq-1, target keys nq..,
    DBConcat.cpp:97,136) and block-compressed per-query MSAs. The
    reference CLI refuses this mode; format verified by round-trip
    through the reference convertca3m."""
    qseqs = mmseqsdb.read_db(query_db)
    tseqs = mmseqsdb.read_db(target_db)
    qhdrs = dict(mmseqsdb.read_db(f"{query_db}_h"))
    thdrs = dict(mmseqsdb.read_db(f"{target_db}_h"))
    nq = len(qseqs)
    same_db = query_db == target_db

    def write_ff(name, entries):
        with open(f"{out_base}_{name}.ffdata", "wb") as f, \
                open(f"{out_base}_{name}.ffindex", "w") as fi:
            off = 0
            for k, p in entries:
                blob = p + b"\x00"
                f.write(blob)
                fi.write(f"{k}\t{off}\t{len(blob)}\n")
                off += len(blob)

    if same_db:
        seq_entries = [(i, p) for i, (k, p) in enumerate(qseqs)]
        hdr_entries = [(i, qhdrs[k].rstrip(b"\n"))
                       for i, (k, _) in enumerate(qseqs)]
        q_new = {k: i for i, (k, _) in enumerate(qseqs)}
        t_new = q_new
    else:
        seq_entries = [(i, p) for i, (k, p) in enumerate(qseqs)] + \
                      [(nq + i, p) for i, (k, p) in enumerate(tseqs)]
        hdr_entries = [(i, qhdrs[k].rstrip(b"\n"))
                       for i, (k, _) in enumerate(qseqs)] + \
                      [(nq + i, thdrs[k].rstrip(b"\n"))
                       for i, (k, _) in enumerate(tseqs)]
        q_new = {k: i for i, (k, _) in enumerate(qseqs)}
        t_new = {k: nq + i for i, (k, _) in enumerate(tseqs)}
    write_ff("sequence", seq_entries)
    write_ff("header", hdr_entries)
    open(f"{out_base}_sequence.ffdata.dbtype", "wb").write(
        struct.pack("<I", mmseqsdb.read_dbtype(query_db)))

    qseq_map = dict(qseqs)
    tseq_map = dict(tseqs)
    entries = []
    for qkey, payload in mmseqsdb.read_db(aln_db):
        hdr = qhdrs[qkey].decode().rstrip("\x00\n")
        seq = qseq_map[qkey].decode().rstrip("\x00\n")
        if consensus:
            # FORMAT_MSA_CA3M_CONSENSUS: PSSM consensus as the master
            # line (result2msa.cpp:479-499)
            from ..data.submat import AA2NUM, ALPHABET
            import numpy as np
            from .result2profile import (compute_pssm_from_msa,
                                         msa_row_from_backtrace)
            center = AA2NUM[np.frombuffer(seq.encode(), np.uint8)]
            members = []
            for ln in payload.decode().split("\n"):
                if not ln:
                    continue
                c = ln.split("\t")
                t_enc = AA2NUM[np.frombuffer(
                    tseq_map[int(c[0])].rstrip(b"\x00\n"), np.uint8)]
                members.append(msa_row_from_backtrace(
                    len(center), t_enc, int(c[4]), int(c[7]), c[10]))
            msa = np.vstack([center] + members) if members else \
                center[None, :]
            cons = compute_pssm_from_msa(
                np.ascontiguousarray(msa, np.uint8))["consensus"]
            cons_seq = "".join(ALPHABET[i] for i in cons)
            body = bytearray(
                f">consensus_{hdr}\n{cons_seq}\n;".encode())
        else:
            body = bytearray(f">{hdr}\n{seq}\n;".encode())
        body += hit_to_ca3m_block(q_new[qkey], 0, 0, "M" * len(seq))
        for ln in payload.decode().split("\n"):
            if not ln:
                continue
            c = ln.split("\t")
            if len(c) < 11:
                raise ValueError(
                    "result2msa ca3m needs backtraces (-a alignments)")
            body += hit_to_ca3m_block(t_new[int(c[0])], int(c[4]),
                                      int(c[7]), expand_cigar(c[10]))
        entries.append((qkey, bytes(body)))
    # ca3m ffdata entries are NUL-terminated, lexicographically indexed
    with open(f"{out_base}_ca3m.ffdata", "wb") as f, \
            open(f"{out_base}_ca3m.ffindex", "w") as fi:
        off = 0
        rows = []
        for k, p in entries:
            blob = p + b"\x00"
            f.write(blob)
            rows.append((str(k), off, len(blob)))
            off += len(blob)
        for k, o, l in sorted(rows, key=lambda r: r[0]):
            fi.write(f"{k}\t{o}\t{l}\n")
    open(f"{out_base}_ca3m.ffdata.dbtype", "wb").write(
        struct.pack("<I", DBTYPE_CA3M))
    # base triple for tool-level validation
    open(out_base, "wb").close()
    open(f"{out_base}.index", "w").write("0\t0\t0\n")
    open(f"{out_base}.dbtype", "wb").write(struct.pack("<I", DBTYPE_CA3M))
    return out_base
