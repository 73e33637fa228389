# Copy of metaeuk_tpu/pipeline/dbtools3.py; it differs from its original only in this note.
"""DB-toolkit commands, third batch: sequence-level and GFF utilities.

Ports of lib/mmseqs/src/util/{result2repseq,masksequence,gff2db,
maskbygff,result2stats,apply,diffseqdbs}.cpp behavior.
"""

import os
import subprocess

import numpy as np

from ..io import mmseqsdb

# Orf::iupacReverseComplementTable (Orf.cpp): N->N, S->S, W->W, U->A
_COMPLEMENT = bytes.maketrans(
    b"ACGTUNRYSWKMBDHVacgtunryswkmbdhv",
    b"TGCAANYRSWMKVHDBtgcaanyrswmkvhdb")


def result2repseq(seq_db, result_db, out_db):
    """result2repseq.cpp: per result entry, the sequence of the first
    line's key, written under the result key; empty entries skipped."""
    seqs = dict(mmseqsdb.read_db(seq_db))
    out = []
    for key, payload in mmseqsdb.read_db(result_db):
        if not payload:
            continue
        first = int(payload.split(b"\n", 1)[0].split(b"\t", 1)[0]
                    .split(b" ", 1)[0])
        out.append((key, seqs[first]))
    mmseqsdb.write_db(out_db, out, mmseqsdb.read_dbtype(seq_db))
    if os.path.exists(f"{seq_db}_h.dbtype"):
        hdrs = dict(mmseqsdb.read_db(f"{seq_db}_h"))
        # softlinkDb(SEQUENCE_ANCILLARY) keeps the source headers: the
        # out keys are result keys, header lookup by the same keys
        mmseqsdb.write_db(f"{out_db}_h",
                          [(k, hdrs[k]) for k, _ in out if k in hdrs],
                          mmseqsdb.DBTYPE_GENERIC)
    return out_db


def masksequence(in_db, out_db, mask_prob=0.9):
    """masksequence.cpp: tantan soft-masking — masked residues lowered
    in the original character sequence."""
    from ..ops.masker import repeat_probs, LIKELIHOOD_RATIO
    from ..data.submat import encode_aa
    from ..data.nucl import NUCL_LR, encode_nucl

    dbtype = mmseqsdb.read_dbtype(in_db)
    is_nucl = dbtype == mmseqsdb.DBTYPE_NUCL
    out = []
    for key, payload in mmseqsdb.read_seq_entries(in_db):
        if is_nucl:
            enc = encode_nucl(payload)
            probs = repeat_probs(enc, lr=NUCL_LR)
        else:
            enc = encode_aa(payload)
            probs = repeat_probs(enc)
        chars = bytearray(payload)
        for i in np.flatnonzero(probs >= mask_prob):
            chars[i] = ord(chr(chars[i]).lower())
        out.append((key, bytes(chars) + b"\n"))
    mmseqsdb.write_db(out_db, out, dbtype)
    return out_db


def gff2db(gff_files, seq_db, out_db, gff_type=""):
    """gff2db.cpp: extract GFF features from the sequence DB into a new
    nucleotide DB with Orf-format headers (strand-aware, 1-based GFF
    coords kept as-is in the header)."""
    # accession -> key via .lookup
    acc2key = {}
    with open(f"{seq_db}.lookup") as f:
        for ln in f:
            c = ln.rstrip("\n").split("\t")
            acc2key[c[1]] = int(c[0])
    seqs = dict(mmseqsdb.read_seq_entries(seq_db))
    features = [t for t in gff_type.split(",") if t] if gff_type else []

    out_seq, out_hdr, lookup = [], [], []
    key_counter = 0
    for fi, path in enumerate(gff_files):
        idx = 0
        with open(path) as f:
            for line in f:
                if line.startswith("#") or line == "\n":
                    continue
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 9:
                    continue
                if features and cols[2] not in features:
                    continue
                start, end = int(cols[3]), int(cols[4])
                if start == end:
                    continue
                strand = cols[6]
                name = cols[0]
                lookup_key = acc2key[name]
                seq = seqs[lookup_key]
                key = key_counter
                key_counter += 1
                length = end - start + 1
                if strand == "+":
                    sub = seq[start - 1:start - 1 + length]
                    hdr = _orf_hdr(lookup_key, start, end)
                    lookup.append(f"{key}\t{name}_{idx}_{start}_{end}\t{fi}")
                else:
                    frag = seq[end - length:end]
                    sub = frag[::-1].translate(_COMPLEMENT)
                    hdr = _orf_hdr(lookup_key, end, start)
                    lookup.append(f"{key}\t{name}_{idx}_{end}_{start}\t{fi}")
                out_seq.append((key, sub + b"\n"))
                out_hdr.append((key, hdr.encode()))
                idx += 1
    mmseqsdb.write_db(out_db, out_seq, mmseqsdb.DBTYPE_NUCL)
    mmseqsdb.write_db(f"{out_db}_h", out_hdr, mmseqsdb.DBTYPE_GENERIC)
    with open(f"{out_db}.lookup", "w") as f:
        f.write("".join(ln + "\n" for ln in lookup))
    with open(f"{out_db}.source", "w") as f:
        for fi, path in enumerate(gff_files):
            f.write(f"{fi}\t{os.path.basename(path)}\n")
    return out_db


def _orf_hdr(key, frm, to):
    sign = "+" if frm < to else "-"
    return f"{key}\t{frm}{sign}{abs(frm - to)}\n"


def maskbygff(gff_file, in_db, out_db, gff_type=""):
    """maskbygff.cpp: X out GFF feature regions (0-indexed from the
    1-based GFF coords) in a STRING-keyed sequence DB
    (DBReader<std::string>, maskbygff.cpp:14-16: the GFF seqname column
    is looked up against the index's string keys). Output keys are
    renumbered 0..n-1 in index order (identifierOffset + i,
    maskbygff.cpp:96-101); the paired header DB is renumbered
    alongside. Unknown seqnames are an error, like the reference."""
    entries = mmseqsdb.read_db_str(in_db)
    by_key = {name: bytearray(p) for name, p in entries}
    with open(gff_file) as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) != 9:
                continue
            if gff_type and cols[2] != gff_type:
                continue
            start, end = int(cols[3]), int(cols[4])
            if end <= start or start == 0 or end == 0:
                continue
            if cols[0] not in by_key:
                raise KeyError(f"GFF entry not found in input database: "
                               f"{cols[0]}")
            body = by_key[cols[0]]
            body[start - 1:end] = b"X" * (end - start + 1)
    out = [(i, bytes(by_key[name])) for i, (name, _) in enumerate(entries)]
    mmseqsdb.write_db(out_db, out, mmseqsdb.read_dbtype(in_db))
    if os.path.exists(f"{in_db}_h.dbtype"):
        hdrs = mmseqsdb.read_db_str(f"{in_db}_h")
        mmseqsdb.write_db(f"{out_db}_h",
                          [(i, p) for i, (_, p) in enumerate(hdrs)],
                          mmseqsdb.DBTYPE_GENERIC)
    return out_db


def result2stats(in_db, out_path, stat, tsv=False):
    """result2stats.cpp: per-entry statistic. Supported --stat values:
    linecount, mean, min, max, sum, seqlen, strlen, firstline."""
    out = []
    for key, payload in mmseqsdb.read_db(in_db):
        text = payload.decode()
        if stat == "linecount":
            val = str(text.count("\n"))
        elif stat in ("mean", "min", "max"):
            # SSTR(double) = "%.3E" (Util.cpp:658-660); min/max start from
            # DBL_MAX / DBL_MIN (the smallest POSITIVE normal!)
            vals = [float(ln.split()[0]) for ln in text.split("\n") if ln]
            if stat == "mean":
                val = "%.3E" % (sum(vals) / max(1, len(vals)))
            elif stat == "min":
                val = "%.3E" % min(vals + [1.7976931348623157e+308])
            else:
                val = "%.3E" % max(vals + [2.2250738585072014e-308])
        elif stat == "sum":
            # integer strtoull sum (result2stats.cpp:281-315)
            val = str(sum(int(ln.split()[0].partition(".")[0])
                          for ln in text.split("\n") if ln))
        elif stat == "seqlen":
            n = 0
            for ch in text:
                if ("A" <= ch < "Z") or ("a" <= ch < "z") or ch == "*":
                    n += 1
                else:
                    break
            val = str(n)
        elif stat == "strlen":
            val = str(len(text))
        elif stat == "firstline":
            val = text.split("\n", 1)[0]
        else:
            raise ValueError(f"unsupported stat {stat}")
        out.append((key, (val + "\n").encode()))
    if tsv:
        with open(out_path, "wb") as f:
            for _, body in out:
                f.write(body)
    else:
        mmseqsdb.write_db(out_path, out, mmseqsdb.DBTYPE_GENERIC)
    return out_path


def apply_cmd(in_db, out_db, program_args):
    """apply.cpp: run a program per entry; entry data on stdin, stdout
    becomes the new entry. Env MMSEQS_ENTRY_NAME carries the key.
    Entries processed in SORT_BY_LENGTH order (length desc, id asc;
    apply.cpp:274 + DBReader.h:398-408); index sorted by key."""
    entries = mmseqsdb.read_db(in_db)
    order = sorted(range(len(entries)),
                   key=lambda i: (-(len(entries[i][1]) + 1), i))
    out = []
    for i in order:
        key, payload = entries[i]
        env = dict(os.environ, MMSEQS_ENTRY_NAME=str(key))
        proc = subprocess.run(program_args, input=payload,
                              capture_output=True, env=env)
        out.append((key, proc.stdout))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_GENERIC,
                      sort_index=True)
    return out_db


def diffseqdbs(old_db, new_db, removed_path, kept_path, new_path,
               use_seq_id=False):
    """diffseqdbs.cpp: compare two sequence DBs by whitespace-stripped
    header (accession with --use-seq-id); kept/new lines in the new DB's
    header-sorted order, removed in old key order; duplicate headers in
    either DB treated as removed/skipped (:112-182)."""
    from ..io.fasta import parse_fasta_header

    def keyfn(p):
        h = p.decode()
        return parse_fasta_header(h) if use_seq_id \
            else "".join(h.split())  # Util::removeWhiteSpace

    old = [(keyfn(p), k) for k, p in mmseqsdb.read_db(f"{old_db}_h")]
    new = sorted(((keyfn(p), k)
                  for k, p in mmseqsdb.read_db(f"{new_db}_h")),
                 key=lambda e: e[0])
    new_dup = [i > 0 and new[i][0] == new[i - 1][0] for i in range(len(new))]
    deleted = [False] * len(old)
    for i, j in zip(sorted(range(len(old)), key=lambda i: old[i][0])[:-1],
                    sorted(range(len(old)), key=lambda i: old[i][0])[1:]):
        if old[i][0] == old[j][0]:
            deleted[j] = True
    import bisect
    headers = [h for h, _ in new]
    mapped = {}
    for i, (h, k) in enumerate(old):
        if deleted[i]:
            continue
        pos = bisect.bisect_left(headers, h)
        if pos < len(new) and headers[pos] == h:
            mapped[pos] = i
        else:
            deleted[i] = True
    with open(kept_path, "w") as fk, open(new_path, "w") as fn:
        for pos, (h, k) in enumerate(new):
            if new_dup[pos]:
                continue
            if pos in mapped:
                fk.write(f"{old[mapped[pos]][1]}\t{k}\n")
            else:
                fn.write(f"{k}\n")
    with open(removed_path, "w") as f:
        for i, (h, k) in enumerate(old):
            if deleted[i]:
                f.write(f"{k}\n")
