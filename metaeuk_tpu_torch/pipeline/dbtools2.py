# Copy of metaeuk_tpu/pipeline/dbtools2.py; it differs from its original only in this note.
"""DB-toolkit commands, second batch: result-DB transposition and
relational utilities.

Ports (behavior, not code) of lib/mmseqs/src/util/{swapresults,prefixid,
subtractdbs,summarizeresult,result2flat,createseqfiledb,splitdb,
orftocontig,renamedbkeys,cpmvrmlndb}.cpp and commons/DBConcat.cpp, at the
--threads 1 determinism level the byte-parity tests pin down.
"""

import os
import shutil

import numpy as np

from ..io import mmseqsdb
from .alnformat import matcher_seq_id_text


# ---------------------------------------------------------------------------
# shared record helpers

def parse_aln_record(line):
    """Matcher::parseAlignmentRecord (Matcher.cpp:204-229) for the 10/11
    column text record; backtrace kept as the compressed CIGAR text."""
    c = line.split("\t")
    return dict(dbKey=int(c[0]), score=int(c[1]), seqId=float(c[2]),
                eval=float(c[3]), qStart=int(c[4]), qEnd=int(c[5]),
                qLen=int(c[6]), dbStart=int(c[7]), dbEnd=int(c[8]),
                dbLen=int(c[9]), backtrace=(c[10] if len(c) > 10 else None))


def aln_record_to_line(r, add_backtrace=False):
    """Matcher::resultToBuffer (Matcher.cpp:281-327) text."""
    cols = [str(r["dbKey"]), str(r["score"]), matcher_seq_id_text(r["seqId"]),
            "%.3E" % r["eval"], str(r["qStart"]), str(r["qEnd"]),
            str(r["qLen"]), str(r["dbStart"]), str(r["dbEnd"]),
            str(r["dbLen"])]
    if add_backtrace:
        cols.append(r["backtrace"] or "")
    return "\t".join(cols) + "\n"


def _lines(payload):
    return [ln for ln in payload.decode().split("\n") if ln]


def _entries_by_offset(db):
    """read_db in SORT_BY_OFFSET order (DBReader.h:273), the scan order of
    the swap/transpose tools."""
    with open(f"{db}.index") as f:
        idx = [tuple(int(x) for x in ln.split("\t")) for ln in f]
    order = sorted(range(len(idx)), key=lambda i: idx[i][1])
    with open(db, "rb") as f:
        data = f.read()
    out = []
    for i in order:
        key, offset, length = idx[i]
        payload = data[offset:offset + length]
        if payload.endswith(b"\x00"):
            payload = payload[:-1]
        out.append((key, payload))
    return out


def read_lookup(db):
    """.lookup lines: id<TAB>accession<TAB>fileNumber."""
    entries = []
    with open(f"{db}.lookup") as f:
        for ln in f:
            c = ln.rstrip("\n").split("\t")
            entries.append((int(c[0]), c[1], int(c[2])))
    return entries


# ---------------------------------------------------------------------------
# swapdb / swapresults

def swapdb(result_db, out_db):
    """swapresults.cpp doswap(isGeneralMode=true): transpose a result DB.
    Each line's first column becomes the out key; the rest of the line is
    kept verbatim with the entry key as the new first column. Out entries
    are written for ascending target key, only when non-empty."""
    per_target = {}
    for key, payload in _entries_by_offset(result_db):
        qk = str(key)
        for ln in _lines(payload):
            tk, _, rest = ln.partition("\t")
            line = qk + ("\t" + rest if rest else "")
            per_target.setdefault(int(tk), []).append(line)
    out = [(tk, "".join(ln + "\n" for ln in per_target[tk]).encode())
           for tk in sorted(per_target)]
    mmseqsdb.write_db(out_db, out, mmseqsdb.read_dbtype(result_db))
    return out_db


def _compare_hits_key(r):
    """Matcher::compareHits (Matcher.h:157-168)."""
    return (r["eval"], -r["score"], r["dbLen"], r["dbKey"])


def swapresults(query_db, target_db, result_db, out_db, eval_thr=0.001):
    """swapresults.cpp doswap(isGeneralMode=false): transpose alignment or
    prefilter results, recomputing alignment E-values for the swapped
    search direction (Matcher::result_t::swapResult, Matcher.h:93-115)
    against the query DB's residue count, filtering by eval_thr, sorting
    by compareHits; every target key present in the target DB gets an
    entry (empty when no hits survive)."""
    from ..search.evalue import EvalueComputation

    q_res = _total_residues(query_db)
    evaluer = EvalueComputation(q_res, gapped=True)
    log_k = np.log(evaluer.p["K"])
    lam = evaluer.p["lam"]

    with open(f"{target_db}.index") as f:
        target_keys = [int(ln.split("\t")[0]) for ln in f]
    target_exists = set(target_keys)
    max_target = max(target_keys) if target_keys else 0

    dbtype = mmseqsdb.read_dbtype(result_db)
    is_aln = None
    has_bt = False
    per_target = {}
    eval_break = set()
    for key, payload in _entries_by_offset(result_db):
        for ln in _lines(payload):
            cols = ln.split("\t")
            if is_aln is None:
                is_aln = len(cols) >= 10
                has_bt = len(cols) >= 11
            tk = int(cols[0])
            if is_aln:
                rec = parse_aln_record(ln)
                rec["dbKey"] = key
                # swapResult: eval from bit score at the pre-swap dbLen
                raw = (log_k + rec["score"] * np.log(2.0)) / lam
                rec["eval"] = float(evaluer.compute_evalue(raw, rec["dbLen"]))
                rec["qStart"], rec["dbStart"] = rec["dbStart"], rec["qStart"]
                rec["qEnd"], rec["dbEnd"] = rec["dbEnd"], rec["qEnd"]
                rec["qLen"], rec["dbLen"] = rec["dbLen"], rec["qLen"]
                if has_bt and rec["backtrace"]:
                    rec["backtrace"] = rec["backtrace"].translate(
                        str.maketrans("ID", "DI"))
                if rec["eval"] > eval_thr:
                    eval_break.add(tk)
                else:
                    per_target.setdefault(tk, []).append(rec)
            else:
                score = int(cols[1])
                diag = np.int16(-np.int16(int(cols[2])))
                per_target.setdefault(tk, []).append(dict(
                    dbKey=key, score=score, eval=-float(score),
                    dbLen=0, diagonal=int(diag)))

    out = []
    for tk in range(max_target + 1):
        recs = per_target.get(tk)
        if recs:
            recs.sort(key=_compare_hits_key)
            if is_aln:
                body = "".join(aln_record_to_line(r, has_bt) for r in recs)
            else:
                body = "".join(f"{r['dbKey']}\t{r['score']}\t{r['diagonal']}\n"
                               for r in recs)
            out.append((tk, body.encode()))
        elif tk in eval_break or tk in target_exists:
            out.append((tk, b""))
    mmseqsdb.write_db(out_db, out, dbtype)
    return out_db


def _total_residues(seq_db):
    """DBReader::getAminoAcidDBSize: data size minus the per-entry
    newline+NUL bookkeeping."""
    total = 0
    with open(f"{seq_db}.index") as f:
        for ln in f:
            total += int(ln.split("\t")[2]) - 2
    return total


# ---------------------------------------------------------------------------
# id decoration / key renaming / subsetting

def prefixid(in_db, out_path, prefix=None, mapping_db=None, tsv=False,
             is_prefix=True):
    """prefixid/suffixid (prefixid.cpp addid): add a per-entry string to
    every line of every entry; string = explicit prefix, the .lookup
    accession of the key, or the key itself."""
    names = None
    if mapping_db:
        names = {k: name for k, name, _ in read_lookup(mapping_db)}
    out = []
    for key, payload in mmseqsdb.read_db(in_db):
        add = prefix if prefix else (
            names[key] if names is not None else str(key))
        rows = []
        for ln in payload.decode().split("\n"):
            if ln == "":
                continue
            rows.append(f"{add}\t{ln}\n" if is_prefix else f"{ln}\t{add}\n")
        out.append((key, "".join(rows).encode()))
    if tsv:
        with open(out_path, "wb") as f:
            for _, body in out:
                f.write(body)
    else:
        mmseqsdb.write_db(out_path, out, mmseqsdb.read_dbtype(in_db))
    return out_path


def renamedbkeys(mapping_path, in_db, out_db):
    """renamedbkeys.cpp: rewrite keys by an old->new TSV; data copied in
    mapping-file order, index sorted by new key; headers and .lookup
    follow when present."""
    pairs = []
    with open(mapping_path) as f:
        for ln in f:
            c = ln.split()
            if len(c) >= 2:
                pairs.append((int(c[0]), int(c[1])))
    remap = dict(pairs)

    def rename_one(src, dst):
        src_map = dict(mmseqsdb.read_db(src))
        out = [(new, src_map[old]) for old, new in pairs]
        mmseqsdb.write_db(dst, out, mmseqsdb.read_dbtype(src),
                          sort_index=True)

    rename_one(in_db, out_db)
    if os.path.exists(f"{in_db}_h.dbtype"):
        rename_one(f"{in_db}_h", f"{out_db}_h")
    if os.path.exists(f"{in_db}.lookup"):
        entries = [(remap[k], name, fn) for k, name, fn in read_lookup(in_db)
                   if k in remap]
        entries.sort(key=lambda e: e[0])
        with open(f"{out_db}.lookup", "w") as f:
            for k, name, fn in entries:
                f.write(f"{k}\t{name}\t{fn}\n")
    if os.path.exists(f"{in_db}.source"):
        shutil.copyfile(f"{in_db}.source", f"{out_db}.source")
    return out_db


def splitdb(in_db, out_db, n_split, split_aa=False):
    """splitdb.cpp: split into N chunks named <out>_<i>_<N>; entry ranges
    by count (Util::decomposeDomain) or by residue mass (--split-aa,
    DBReader::decomposeDomainByAminoAcid)."""
    entries = mmseqsdb.read_db(in_db)
    dbtype = mmseqsdb.read_dbtype(in_db)
    n = len(entries)
    outs = []
    if split_aa:
        sizes = [len(p) + 1 for _, p in entries]
        ranges = _decompose_by_weight(sizes, n_split)
    else:
        ranges = []
        for sp in range(n_split):
            chunk = n // n_split
            rest = n % n_split
            start = sp * chunk + min(sp, rest)
            size = chunk + (1 if sp < rest else 0)
            ranges.append((start, size))
    for sp, (start, size) in enumerate(ranges):
        out = f"{out_db}_{sp}_{n_split}"
        mmseqsdb.write_db(out, entries[start:start + size], dbtype)
        outs.append(out)
    return outs


def _decompose_by_weight(sizes, n_split):
    """DBReader::decomposeDomainByAminoAcid (DBReader.cpp:1219-1260):
    greedy proportional chunking by cumulative entry weight."""
    total = sum(sizes)
    n = len(sizes)
    ranges = []
    start = 0
    cum = 0
    per = total / n_split
    for sp in range(n_split):
        limit = (sp + 1) * per
        end = start
        while end < n and (cum < limit or sp == n_split - 1):
            cum += sizes[end]
            end += 1
        ranges.append((start, end - start))
        start = end
    return ranges


# ---------------------------------------------------------------------------
# result-set relational ops

def subtractdbs(left_db, right_db, out_db, eval_thr=0.001):
    """subtractdbs.cpp: per key, keep left lines whose first-column id is
    not present (under the E-value threshold) in the right entry."""
    right = dict(mmseqsdb.read_db(right_db))
    out = []
    for key, payload in mmseqsdb.read_db(left_db):
        keep = {}
        lines = _lines(payload)
        for ln in lines:
            cols = ln.split("\t")
            ev = float(cols[3]) if len(cols) >= 10 else 0.0
            if ev <= eval_thr:
                keep[int(cols[0])] = True
        for ln in _lines(right.get(key, b"")):
            cols = ln.split("\t")
            ev = float(cols[3]) if len(cols) >= 10 else 0.0
            if ev <= eval_thr:
                keep[int(cols[0])] = False
        kept = [ln for ln in lines if keep.get(int(ln.split("\t", 1)[0]))]
        out.append((key, "".join(ln + "\n" for ln in kept).encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.read_dbtype(left_db))
    return out_db


def summarizeresult(in_db, out_db, cov_thr=0.0, overlap=0.0,
                    add_backtrace=False):
    """summarizeresult.cpp: greedy non-overlapping domain selection over
    the query axis in entry order; domains failing --cov (target cov) or
    overlapping more than --overlap of already-covered query are dropped."""
    out = []
    for key, payload in mmseqsdb.read_db(in_db):
        covered = None
        rows = []
        for ln in _lines(payload):
            r = parse_aln_record(ln)
            if covered is None:
                covered = np.zeros(r["qLen"], bool)
            if r["qStart"] > r["qLen"] or r["qEnd"] > r["qLen"]:
                continue
            dbcov = (abs(r["dbEnd"] - max(r["dbStart"], 0)) + 1) / r["dbLen"]
            if dbcov < cov_thr:
                continue
            lo, hi = min(r["qStart"], r["qEnd"]), max(r["qStart"], r["qEnd"])
            counter = int(covered[lo:hi].sum())
            if counter / float(hi - lo + 1) <= overlap:
                covered[lo:hi] = True
                rows.append(aln_record_to_line(r, add_backtrace))
        out.append((key, "".join(rows).encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES)
    return out_db


def result2flat(query_db, target_db, result_db, out_path, use_header=False):
    """result2flat.cpp: FASTA-like flat file; query header then one line
    per result line (first column resolved to the target accession when
    --use-fasta-header is unset... the reference resolves the *key* and
    keeps the line only in use_header mode; default emits lines as-is)."""
    from ..io.fasta import parse_fasta_header
    q_hdr = {k: p.decode().rstrip("\n")
             for k, p in mmseqsdb.read_db(f"{query_db}_h")}
    t_hdr = {k: p.decode().rstrip("\n")
             for k, p in mmseqsdb.read_db(f"{target_db}_h")}
    dbtype = mmseqsdb.read_dbtype(result_db)
    is_result = dbtype in (mmseqsdb.DBTYPE_ALIGNMENT_RES,
                           mmseqsdb.DBTYPE_PREFILTER_RES, 16,
                           mmseqsdb.DBTYPE_GENERIC, 8)
    with open(out_path, "w") as f:
        for key, payload in mmseqsdb.read_db(result_db):
            if use_header:
                hdr = q_hdr[key].split("\n")[0] + " "
            else:
                hdr = parse_fasta_header(q_hdr[key])
            f.write(f">{hdr}\n")
            for ln in _lines(payload):
                if use_header and is_result:
                    # the reference skips key+tab together (keyLen spans the
                    # separator, result2flat.cpp:66-80) -> no tab after acc
                    tk, _, rest = ln.partition("\t")
                    acc = parse_fasta_header(t_hdr[int(tk)])
                    f.write(acc + rest + "\n")
                else:
                    f.write(ln + "\n")
    return out_path


def createseqfiledb(seq_db, result_db, out_db, min_sequences=1,
                    max_sequences=2 ** 31 - 1, hh_format=False):
    """createseqfiledb.cpp: per result entry, concatenated FASTA of the
    member sequences."""
    seqs = dict(mmseqsdb.read_db(seq_db))
    hdrs = dict(mmseqsdb.read_db(f"{seq_db}_h"))
    out = []
    for key, payload in mmseqsdb.read_db(result_db):
        lines = _lines(payload)
        if len(lines) < min_sequences or len(lines) > max_sequences:
            continue
        parts = []
        for i, ln in enumerate(lines):
            mk = int(ln.split("\t")[0].split(" ")[0])
            hdr, seq = hdrs[mk], seqs[mk]  # payloads keep their newline
            if i == 0 and hh_format:
                acc = hdr.split()[0]
                parts += [b"#", hdr, b">", acc, b"_consensus\n", seq,
                          b">", hdr, seq]
            else:
                parts += [b">", hdr, seq]
        out.append((key, b"".join(parts)))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_GENERIC)
    return out_db


def parse_orf_location(loc):
    """Orf::parseOrfHeader position field 'FROM{+|-}LEN'
    (Orf.cpp:351-438) -> (from, to)."""
    sign = "+" if "+" in loc else "-"
    frm_s, len_s = loc.split(sign)
    frm, length = int(frm_s), int(len_s)
    return frm, (frm + length if sign == "+" else frm - length)


def orftocontig(contigs_db, orf_db, out_db):
    """orftocontig.cpp: per ORF, its location on the contig as an
    alignment record (Orf::getFromDatabase, Orf.cpp:106-125)."""
    contig_len = {}
    with open(f"{contigs_db}.index") as f:
        for ln in f:
            c = ln.split("\t")
            contig_len[int(c[0])] = int(c[2]) - 2
    out = []
    for orf_key, payload in mmseqsdb.read_db(f"{orf_db}_h"):
        c = payload.decode().split()
        contig_key = int(c[0])
        frm, to = parse_orf_location(c[1])
        orf_len = max(frm, to) - min(frm, to) + 1
        # compressAlignment("") emits "0M" (Matcher.cpp:166-184)
        line = (f"{contig_key}\t1\t1.00\t0.000E+00\t0\t{orf_len - 1}\t"
                f"{orf_len}\t{frm}\t{to}\t{contig_len[contig_key]}\t0M\n")
        out.append((orf_key, line.encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES)
    return out_db


# ---------------------------------------------------------------------------
# whole-DB file ops

def concatdbs(db_a, db_b, out_db, preserve_keys_b=False):
    """DBConcat.cpp: A entries keep their keys; B entries are renumbered
    id + maxKeyA + 1 unless --preserve-keys."""
    a = mmseqsdb.read_db(db_a)
    b = mmseqsdb.read_db(db_b)
    max_key_a = max((k for k, _ in a), default=0) + 1
    out = list(a)
    for i, (k, p) in enumerate(b):
        out.append((k if preserve_keys_b else i + max_key_a, p))
    mmseqsdb.write_db(out_db, out, mmseqsdb.read_dbtype(db_a),
                      sort_index=True)
    return out_db


DB_SUFFIXES = ["", ".index", ".dbtype", "_h", "_h.index", "_h.dbtype",
               ".lookup", ".source", "_mapping", "_names.dmp", "_nodes.dmp",
               "_merged.dmp", "_taxonomy"]


def _db_files(db):
    return [db + s for s in DB_SUFFIXES if os.path.exists(db + s)]


def rmdb(db):
    """rmdb (cpmvrmlndb.cpp + DBReader::removeDb)."""
    for f in _db_files(db):
        os.remove(f)


def mvdb(src, dst):
    for f in _db_files(src):
        shutil.move(f, dst + f[len(src):])


def cpdb(src, dst):
    for f in _db_files(src):
        shutil.copyfile(f, dst + f[len(src):])


def lndb(src, dst):
    for f in _db_files(src):
        target = dst + f[len(src):]
        if os.path.lexists(target):
            os.remove(target)
        os.symlink(os.path.abspath(f), target)


def touchdb(db):
    """touchdb.cpp: page the data file into cache — here a plain read."""
    with open(db, "rb") as f:
        while f.read(1 << 24):
            pass
