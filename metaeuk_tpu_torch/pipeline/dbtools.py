# Copy of metaeuk_tpu/pipeline/dbtools.py; it differs from its original only in this note.
"""DB-toolkit commands: the relational-algebra utilities over DB triples.

Ports of lib/mmseqs/src/util/{reverseseq,tsv2db,mergedbs,createsubdb,
sortresult}.cpp for the flag configurations MetaEuk's workflows use.
"""

import numpy as np

from ..io import mmseqsdb


def reverseseq(in_db, out_db):
    """reverseseq.cpp: reverse residues (25-byte records for profiles)."""
    dbtype = mmseqsdb.read_dbtype(in_db)
    is_profile = dbtype == mmseqsdb.DBTYPE_HMM_PROFILE
    out = []
    for key, payload in mmseqsdb.read_db(in_db):
        if is_profile:
            rec = np.frombuffer(payload, np.uint8).reshape(-1, 25)
            out.append((key, rec[::-1].tobytes()))
        else:
            # getSeqLen excludes the trailing newline
            seq = payload[:-1] if payload.endswith(b"\n") else payload
            out.append((key, seq[::-1] + b"\n"))
    mmseqsdb.write_db(out_db, out, dbtype)
    return out_db


def tsv2db(tsv_path, out_db, output_dbtype=mmseqsdb.DBTYPE_GENERIC,
           include_identity=False):
    """tsv2db.cpp: group a 'key<TAB>rest' TSV by key; one entry per key
    holding the rest-of-line payloads."""
    groups = []
    last_key = None
    buf = []
    with open(tsv_path) as f:
        for line in f:
            line = line.rstrip("\n")
            key, _, rest = line.partition("\t")
            if key != last_key and last_key is not None:
                groups.append((last_key, buf))
                buf = []
            buf.append(rest)
            last_key = key
    if last_key is not None:
        groups.append((last_key, buf))
    out = []
    for key, rows in groups:
        payload = "".join(r + "\n" for r in rows)
        if include_identity:
            payload = f"{key}\n" + payload
        out.append((int(key), payload.encode()))
    mmseqsdb.write_db(out_db, out, output_dbtype)
    return out_db


def mergedbs(query_db, out_db, in_dbs, prefixes=()):
    """mergedbs.cpp: concatenate per-key payloads of in_dbs in the query
    DB's key order, with optional per-db prefixes."""
    with open(f"{query_db}.index") as f:
        qkeys = [int(line.split("\t")[0]) for line in f]
    maps = [dict(mmseqsdb.read_db(db)) for db in in_dbs]
    # keep extended dbtype bits (e.g. expandaln's NEED_SRC flag)
    dbtype = mmseqsdb.read_dbtype_raw(in_dbs[0]) & 0x7FFFFFFF
    out = []
    for key in qkeys:
        parts = []
        for i, m in enumerate(maps):
            if key not in m:
                continue
            if i < len(prefixes):
                parts.append(prefixes[i].encode())
            parts.append(m[key])
        out.append((key, b"".join(parts)))
    mmseqsdb.write_db(out_db, out, dbtype)
    return out_db


def createsubdb(keys, in_db, out_db):
    """createsubdb.cpp (hard mode, id key mode): subset by key list,
    preserving list order; missing keys skipped with a warning."""
    src = dict(mmseqsdb.read_db(in_db))
    dbtype = mmseqsdb.read_dbtype(in_db)
    out = []
    for key in keys:
        key = int(key)
        if key not in src:
            continue
        out.append((key, src[key]))
    mmseqsdb.write_db(out_db, out, dbtype)
    # data stays in list order, but DBWriter::close sorts the index by key
    # when the key list was unordered (createsubdb.cpp:85-88)
    with open(f"{out_db}.index") as f:
        lines = [ln.split("\t") for ln in f]
    lines.sort(key=lambda c: int(c[0]))
    with open(f"{out_db}.index", "w") as f:
        for c in lines:
            f.write("\t".join(c))
    return out_db


def sortresult(in_db, out_db):
    """sortresult.cpp: per-entry re-sort; alignment records by
    Matcher::compareHits (score desc, seqId asc... Matcher.h), prefilter
    records by hit_t::compareHitsByScoreAndId."""
    dbtype = mmseqsdb.read_dbtype(in_db)
    out = []
    for key, payload in mmseqsdb.read_db(in_db):
        lines = [ln for ln in payload.decode().split("\n") if ln]
        if not lines:
            out.append((key, b""))
            continue
        ncols = len(lines[0].split("\t"))
        if ncols == 3:
            # prefilter: |score| desc, id asc
            def pkey(ln):
                c = ln.split("\t")
                return (-abs(int(c[1])), int(c[0]))
            lines.sort(key=pkey)
        else:
            # Matcher::compareHits (Matcher.h:157-168): eval asc,
            # score desc, dbLen asc, dbKey asc
            def akey(ln):
                c = ln.split("\t")
                return (float(c[3]), -int(c[1]), int(c[9]), int(c[0]))
            lines.sort(key=akey)
        out.append((key, "".join(ln + "\n" for ln in lines).encode()))
    mmseqsdb.write_db(out_db, out, dbtype)
    return out_db


def _orf_header(key, from_pos, to_pos, complete=0):
    """Orf::writeOrfHeader text (Orf.cpp:440-457):
    'key<TAB>from{+|-}len[<TAB>complete]\\n'."""
    sign = "+" if from_pos < to_pos else "-"
    length = abs(int(from_pos) - int(to_pos))
    s = f"{key}\t{from_pos}{sign}{length}"
    if complete:
        s += f"\t{complete}"
    return s + "\n"


def extractframes(in_db, out_db, forward_frames=(1, 2, 3),
                  reverse_frames=(1, 2, 3), translate=False,
                  translation_table=1):
    """extractframes.cpp: per nucleotide sequence, emit the 3 forward and
    3 reverse-complement frame subsequences (optionally translated), with
    Orf-style headers and renumbered keys."""
    from ..data.gencode import GeneticCode, REVCOMP_TABLE
    import numpy as np
    gc = GeneticCode(translation_table) if translate else None
    seqs, headers = [], []
    for key, payload in mmseqsdb.read_db(in_db):
        seq = payload[:-1] if payload.endswith(b"\n") else payload
        L = len(seq)
        arr = np.frombuffer(seq, np.uint8)
        rc = REVCOMP_TABLE[arr[::-1]].tobytes()

        def emit(data, frame, reverse):
            sub = data[frame:]
            slen = L - frame
            if translate:
                if slen < 3:
                    return
                codon_len = (slen // 3) * 3
                aa = gc.translate_ascii(sub[:codon_len])
                seqs.append(aa + b"\n")
                if reverse:
                    headers.append(_orf_header(key, frame + codon_len, frame))
                else:
                    headers.append(_orf_header(key, frame, frame + codon_len))
            else:
                seqs.append(sub + b"\n")
                if reverse:
                    headers.append(_orf_header(key, slen - 1, frame))
                else:
                    headers.append(_orf_header(key, frame, slen - 1))

        for f in (1, 2, 3):
            if f in forward_frames:
                emit(seq, f - 1, False)
        for f in (1, 2, 3):
            if f in reverse_frames:
                emit(rc, f - 1, True)
    dbtype = mmseqsdb.DBTYPE_AA if translate else mmseqsdb.read_dbtype(in_db)
    mmseqsdb.write_db(out_db, list(enumerate(seqs)), dbtype)
    mmseqsdb.write_db(f"{out_db}_h",
                      [(i, h.encode()) for i, h in enumerate(headers)],
                      mmseqsdb.DBTYPE_GENERIC)
    return out_db


def splitsequence(in_db, out_db, max_seq_len=10000, overlap=300):
    """splitsequence.cpp (hard mode): overlapping chunks (defaults
    --max-seq-len 10000 --sequence-overlap 300, splitsequence.cpp:20-22)
    with Orf-style coordinate headers and renumbered keys. If no sequence
    exceeds max_seq_len the whole DB is passed through unchanged
    (softlinkDb, splitsequence.cpp:36-41). ORF-format input headers are
    re-expressed in source coordinates (dbKey = contig id, offsets
    shifted; splitsequence.cpp:83-122)."""
    import math

    entries = mmseqsdb.read_seq_entries(in_db)
    if all(len(p) <= max_seq_len for _, p in entries):
        from .dbtools2 import cpdb
        cpdb(in_db, out_db)
        return out_db

    hdrs = dict(mmseqsdb.read_db(f"{in_db}_h"))
    seqs, headers = [], []
    for key, seq in entries:
        L = len(seq)
        loc_id = None
        hdr_fields = hdrs.get(key, b"").decode().split()
        if len(hdr_fields) >= 2:
            try:
                from .dbtools2 import parse_orf_location
                frm, to = parse_orf_location(hdr_fields[1])
                loc_id = int(hdr_fields[0])
                minus = frm > to
            except (ValueError, IndexError):
                loc_id = None
        if loc_id is not None:
            from0 = to if minus else frm
            db_key = loc_id
        else:
            from0 = 0
            db_key = key
            minus = False
        n_split = max(1, math.ceil(np.float32(L)
                                   / np.float32(max_seq_len - overlap)))
        for sp in range(n_split):
            start = sp * max_seq_len - sp * overlap
            ln = min(max_seq_len, L - start)
            seqs.append(seq[start:start + ln] + b"\n")
            from_pos = from0 + start
            to_pos = from_pos + ln - 1
            if loc_id is not None and minus:
                from_pos = (L - 1) - (from0 + start)
                to_pos = from_pos - min(from_pos, ln)
            headers.append(_orf_header(db_key, from_pos, to_pos))
    dbtype = mmseqsdb.read_dbtype(in_db)
    mmseqsdb.write_db(out_db, list(enumerate(seqs)), dbtype)
    mmseqsdb.write_db(f"{out_db}_h",
                      [(i, h.encode()) for i, h in enumerate(headers)],
                      mmseqsdb.DBTYPE_GENERIC)
    return out_db


def convert2fasta(in_db, out_fasta):
    """convert2fasta.cpp: DB + headers -> FASTA."""
    headers = dict(mmseqsdb.read_db(f"{in_db}_h"))
    with open(out_fasta, "wb") as f:
        for key, payload in mmseqsdb.read_db(in_db):
            h = headers[key]
            h = h[:-1] if h.endswith(b"\n") else h
            b = payload[:-1] if payload.endswith(b"\n") else payload
            f.write(b">" + h + b"\n" + b + b"\n")
    return out_fasta


def filterdb_by_file(in_db, out_db, keep_keys):
    """filterdb --filter-file: keep only lines whose first column is in
    the given key set (util/filterdb.cpp FILE_FILTER mode)."""
    keep = {str(int(k)) for k in keep_keys}
    out = []
    for key, payload in mmseqsdb.read_db(in_db):
        lines = [ln for ln in payload.decode().split("\n") if ln]
        kept = [ln for ln in lines if ln.split("\t")[0] in keep]
        out.append((key, "".join(ln + "\n" for ln in kept).encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.read_dbtype(in_db))
    return out_db
