# Copy of metaeuk_tpu/pipeline/dbtools5.py; it differs from its original only in this note.
"""Util batch 5: extractalignedregion, summarizeheaders, clusthash,
mergeresultsbyset, makepaddedseqdb, unpackdb, countkmer,
recoverlongestorf, tar2db, db2tar.

Ports of the same-named tools in lib/mmseqs/src/util/ (file:line cited
per function). Byte parity on tests/golden/util5 fixtures.
"""

import os
import re

import numpy as np

from ..io import mmseqsdb
from .dbtools2 import _lines, parse_aln_record


def extractalignedregion(query_db, target_db, aln_db, out_db,
                         extract_mode=2, compressed=False):
    """extractalignedregion.cpp: per alignment line, the aligned query
    (mode 1) or target (mode 2) subsequence as its own entry keyed by
    the query."""
    qdb = dict(mmseqsdb.read_db(query_db))
    same = str(query_db) == str(target_db)
    tdb = qdb if same else dict(mmseqsdb.read_db(target_db))
    dbtype = mmseqsdb.read_dbtype(target_db)
    out = []
    for key, payload in mmseqsdb.read_db(aln_db):
        for ln in _lines(payload):
            r = parse_aln_record(ln)
            if extract_mode == 1:
                seq = qdb[key][r["qStart"]:r["qEnd"] + 1]
            else:
                seq = tdb[r["dbKey"]][r["dbStart"]:r["dbEnd"] + 1]
            out.append((key, bytes(seq) + b"\n"))
    mmseqsdb.write_db(out_db, out, dbtype, compressed=compressed)
    return out_db


# --- libstdc++ heap layout (bits/stl_heap.h) --------------------------
# summarizeheaders iterates std::make_heap's array order, so the exact
# sift pattern decides the output order.

def _push_heap(a, hole, top, value, less):
    parent = (hole - 1) // 2
    while hole > top and less(a[parent], value):
        a[hole] = a[parent]
        hole = parent
        parent = (hole - 1) // 2
    a[hole] = value


def _adjust_heap(a, hole, length, value, less):
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if less(a[second], a[second - 1]):
            second -= 1
        a[hole] = a[second]
        hole = second
    if (length & 1) == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[hole] = a[second - 1]
        hole = second - 1
    _push_heap(a, hole, top, value, less)


def make_heap(a, less):
    """std::make_heap (libstdc++ __make_heap): the resulting ARRAY
    layout, not a sorted order."""
    n = len(a)
    if n < 2:
        return a
    for parent in range((n - 2) // 2, -1, -1):
        _adjust_heap(a, parent, n, a[parent], less)
    return a


_UNINFORMATIVE = re.compile(
    "hypothetical|unknown|putative|predicted|unnamed|probable|partial|"
    "possible|uncharacterized|fragment")


def _uniprot_summarize(headers):
    """UniprotHeaderSummarizer::summarize (HeaderSummarizer.cpp:86-194).
    priority is an UNSIGNED int: PE-based subtraction underflows for
    informative low-PE entries, which dominates the heap order."""
    queue = []
    representative = ""
    for idx, header in enumerate(headers):
        parts = header.split("|")
        if len(parts) < 3:
            continue
        db_type, identifier = parts[0], parts[1]
        if idx == 0:
            representative = identifier
        rest = header[len(db_type) + len(identifier) + 2:]
        sp = rest.find(" ")
        if sp < 0:
            continue
        rest = rest[sp + 1:]
        os_pos = rest.find(" OS=")
        if os_pos < 0:
            continue
        protein_name = rest[:os_pos]
        after = rest[os_pos:]
        eq = after.find("=")
        after = after[eq + 1:]
        end = after.find(" GN=")
        if end < 0:
            end = after.find(" PE=")
            if end < 0:
                continue
        pe = after.find("PE=")
        if pe < 0:
            continue
        tail = after[pe + 3:]
        sv = tail.find(" SV=")
        if sv < 0:
            continue
        existence = int(tail[:sv] or 0)
        priority = 0
        if not _UNINFORMATIVE.search(identifier):
            priority = 4 if db_type == "sp" else \
                (1 if db_type == "tr" else 0)
            priority = (priority + min(existence, 5) - 5) % (1 << 32)
        queue.append(dict(identifier=identifier, name=protein_name,
                          priority=priority))
    make_heap(queue, lambda x, y: x["priority"] < y["priority"])
    out = [f"Representative={representative}", f" n={len(headers)}"]
    used = set()
    out.append(" Descriptions=[")
    cnt = 0
    for i, h in enumerate(queue):
        if cnt > 5:
            break
        if h["name"] in used:
            continue
        out.append(h["name"])
        used.add(h["name"])
        cnt += 1
        if i != len(queue) - 1 and cnt <= 5:
            out.append("|")
    out.append("]")
    out.append(" Members=")
    for i, h in enumerate(queue):
        out.append(h["identifier"])
        if i != len(queue) - 1:
            out.append(",")
    return "".join(out) + "\n"


def _metaclust_summarize(headers):
    """MetaclustHeaderSummarizer::summarize (HeaderSummarizer.cpp:
    197-260)."""
    queue = []
    representative = ""
    for idx, header in enumerate(headers):
        db_type = "UPI" if "UPI" in header else "lessImportant"
        sp = header.find(" ")
        if sp < 0:
            continue
        identifier = header[:sp]
        if idx == 0:
            representative = identifier
        priority = 4 if db_type == "UPI" else 1
        queue.append(dict(identifier=identifier, priority=priority))
    make_heap(queue, lambda x, y: x["priority"] < y["priority"])
    out = [f"Representative={representative}", f" n={len(headers)}",
           " Members="]
    for i, h in enumerate(queue):
        if h["identifier"] == representative:  # skip representative
            continue
        out.append(h["identifier"])
        if i != len(queue) - 1:
            out.append(",")
    s = "".join(out)
    # trailing-comma quirk (HeaderSummarizer.cpp:243-249)
    if s.endswith(","):
        return s[:-1] + "\n"
    return s + "\n"


def summarizeheaders(query_db, target_db, result_db, out_db,
                     header_type=1, summary_prefix="cl", compressed=False):
    """summarizeheaders.cpp: per result entry, summarize the member
    headers (first line resolved in query_db, rest in target_db)."""
    q = dict(mmseqsdb.read_db(query_db))
    t = q if str(query_db) == str(target_db) \
        else dict(mmseqsdb.read_db(target_db))
    summarize = _uniprot_summarize if header_type == 1 \
        else _metaclust_summarize
    out = []
    for key, payload in mmseqsdb.read_db(result_db):
        headers = []
        rep = ""
        for i, ln in enumerate(payload.decode().splitlines()):
            mkey = int(ln.split("\t")[0].split()[0])
            headers.append((q if i == 0 else t)[mkey]
                           .decode().rstrip("\x00"))
            if i == 0:
                rep = ln
        summary = f"{summary_prefix}-{rep}|{summarize(headers)}"
        out.append((key, summary.encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_GENERIC,
                      compressed=compressed)
    return out_db


def clusthash(seq_db, out_db, min_seq_id=0.99, alph_size=3,
              compressed=False):
    """clusthash.cpp: reduced-alphabet sequence hash grouping + Hamming
    identity check within hash groups; alignment-format output."""
    from ..pipeline.alnformat import format_seq_id
    from ..search.kmermatcher import _reduced, _util_hash

    db = mmseqsdb.read_seqdb(seq_db)
    aa2red, _alpha = _reduced(alph_size)
    pairs = []
    for i in range(len(db)):
        enc = aa2red[np.asarray(db.seq(i), np.uint8)]
        pairs.append((int(_util_hash(enc)), i))
    pairs.sort()
    out = []
    i = 0
    while i < len(pairs):
        j = i
        while j < len(pairs) and pairs[j][0] == pairs[i][0]:
            j += 1
        ids = [p[1] for p in pairs[i:j]]
        found = [False] * len(ids)
        for a, ia in enumerate(ids):
            qkey = int(db.keys[ia])
            ql = int(db.lengths[ia])
            qseq = db.seq_bytes(ia)
            lines = [f"{qkey}\t255\t1.00\t0\t0\t{ql - 1}\t{ql}\t0\t"
                     f"{ql - 1}\t{ql}\n"]
            if not found[a]:
                for b, ib in enumerate(ids):
                    if found[b] or a == b:
                        continue
                    tl = int(db.lengths[ib])
                    if ql != tl:
                        continue
                    tseq = db.seq_bytes(ib)
                    ident = int(np.count_nonzero(
                        np.frombuffer(bytes(qseq), np.uint8) ==
                        np.frombuffer(bytes(tseq), np.uint8)))
                    seq_id = ident / ql
                    if seq_id >= min_seq_id:
                        lines.append(
                            f"{int(db.keys[ib])}\t255\t"
                            f"{format_seq_id(seq_id)}\t0\t0\t{ql - 1}\t"
                            f"{ql}\t0\t{ql - 1}\t{ql}\n")
                        found[b] = True
            out.append((qkey, "".join(lines).encode()))
        i = j
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES,
                      sort_index=True, compressed=compressed)
    return out_db


def mergeresultsbyset(set_db, result_db, out_db, compressed=False):
    """mergeresultsbyset.cpp: per set entry, concatenate the referenced
    result entries; output dbtype gains the NEED_SRC extended bit."""
    res = dict(mmseqsdb.read_db(result_db))
    dbtype = mmseqsdb.read_dbtype(result_db) | (2 << 16)
    out = []
    for key, payload in mmseqsdb.read_db(set_db):
        buf = b"".join(res[int(ln.split("\t")[0])]
                       for ln in payload.decode().splitlines() if ln)
        out.append((key, buf))
    mmseqsdb.write_db(out_db, out, dbtype, compressed=compressed)
    return out_db


def makepaddedseqdb(in_db, out_db):
    """makepaddedseqdb.cpp: sequences re-keyed 0..N-1 by ascending
    length, stored as numeric residue indices (lowercase preserved via
    +32), padded with residue 20 to 4-byte alignment; index length keeps
    the reference's L+2 convention; dbtype gains the GPU extended bit."""
    from ..data.submat import AA2NUM

    db = mmseqsdb.read_seqdb(in_db)
    hdrs = dict(mmseqsdb.read_db(f"{in_db}_h"))
    order = sorted(range(len(db)), key=lambda i: int(db.lengths[i]))
    data = bytearray()
    index = []
    hout = []
    for new_key, i in enumerate(order):
        raw = bytes(db.seq_bytes(i))
        enc = AA2NUM[np.frombuffer(raw, np.uint8)]
        low = np.frombuffer(raw, np.uint8) >= ord("a")
        enc = np.where(low, enc + 32, enc).astype(np.uint8)
        start = len(data)
        data += enc.tobytes()
        pad = (4 - len(enc) % 4) % 4
        data += bytes([20]) * pad
        index.append((new_key, start, len(enc) + 2))
        hout.append((new_key, hdrs[int(db.keys[i])]))
    with open(out_db, "wb") as f:
        f.write(bytes(data))
    with open(f"{out_db}.index", "w") as f:
        for k, o, l in index:
            f.write(f"{k}\t{o}\t{l}\n")
    with open(f"{out_db}.dbtype", "wb") as f:
        f.write(bytes([0, 0, 8, 0]))  # aa | DBTYPE_EXTENDED_GPU
    mmseqsdb.write_db(f"{out_db}_h", hout, mmseqsdb.DBTYPE_GENERIC)
    return out_db


def unpackdb(in_db, out_dir, name_mode=0, suffix=""):
    """unpackdb.cpp: one file per entry (trailing NUL stripped);
    name_mode 0 = key, 1 = lookup accession."""
    os.makedirs(out_dir, exist_ok=True)
    names = {}
    if name_mode == 1 and os.path.exists(f"{in_db}.lookup"):
        for ln in open(f"{in_db}.lookup"):
            c = ln.rstrip("\n").split("\t")
            names[int(c[0])] = c[1]
    for key, payload in mmseqsdb.read_db(in_db):
        name = names.get(key, str(key))
        with open(os.path.join(out_dir, f"{name}{suffix}"), "wb") as f:
            f.write(payload)
    return out_dir


def countkmer(seq_db, k=5, out=None):
    """countkmer.cpp: global k-mer count table (contiguous k-mers,
    X-free), little-endian k-mer indexing (Indexer::int2index)."""
    from ..data.submat import AA2NUM, ALPHABET

    db = mmseqsdb.read_seqdb(seq_db)
    alph = 20
    table = np.zeros(alph ** k, np.int64)
    powers = alph ** np.arange(k)
    for i in range(len(db)):
        enc = AA2NUM[np.asarray(db.seq(i), np.uint8)].astype(np.int64)
        if len(enc) < k:
            continue
        win = np.lib.stride_tricks.sliding_window_view(enc, k)
        valid = (win != 20).all(axis=1)
        idxs = (win[valid] * powers).sum(axis=1)
        np.add.at(table, idxs, 1)
    lines = []
    for idx in range(alph ** k):
        letters = "".join(ALPHABET[(idx // int(powers[p])) % alph]
                          for p in range(k))
        lines.append(f"{idx}\t{letters}\t{int(table[idx])}\n")
    text = "".join(lines)
    if out is not None:
        with open(out, "w") as f:
            f.write(text)
    return text


def _parse_orf_header(text):
    """Orf::parseOrfHeader '<contigKey> <FROM{+|-}LEN> ...'
    (shared with orftocontig, dbtools2.parse_orf_location)."""
    from .dbtools2 import parse_orf_location
    c = text.split()
    frm, to = parse_orf_location(c[1])
    return dict(contig_key=int(c[0]), frm=frm, to=to)


def recoverlongestorf(orf_db, result_db, out_file):
    """recoverlongestorf.cpp: for contigs whose every ORF result is
    empty, emit the longest ORF's key. The reference iterates a
    std::unordered_set (libstdc++: reverse first-insertion order for
    distinct buckets), replicated here."""
    hdrs = mmseqsdb.read_db(f"{orf_db}_h")
    longest = {}
    orf_contig = {}
    for key, payload in hdrs:
        loc = _parse_orf_header(payload.decode())
        contig = loc["contig_key"]
        orf_len = abs(loc["to"] - loc["frm"]) + 1
        orf_contig[key] = contig
        cur = longest.get(contig)
        if cur is None or orf_len > cur[1]:
            longest[contig] = (key, orf_len)
    accepted = set()
    eliminated = []  # insertion order
    seen = set()
    for key, payload in mmseqsdb.read_db(result_db):
        contig = orf_contig[key]
        if len(payload) > 0:
            accepted.add(contig)
        if contig not in seen:
            seen.add(contig)
            eliminated.append(contig)
    # the reference drains a thread-local unordered_set into a global one
    # (both libstdc++, both reverse first-insertion order for distinct
    # buckets) -> the double reversal restores first-insertion order
    with open(out_file, "w") as f:
        for contig in eliminated:
            if contig in accepted:
                continue
            f.write(f"{longest[contig][0]}\n")
    return out_file


def tar2db(tar_files, out_db, tar_include=".*", tar_exclude="^$",
           compressed=False, output_dbtype=None):
    """tar2db.cpp: every regular tar member matching the filters becomes
    an entry (keys sequential), with .lookup (key -> member name) and
    .source (file number -> tar name)."""
    import tarfile

    inc = re.compile(tar_include)
    exc = re.compile(tar_exclude)
    entries = []
    lookup = []
    sources = []
    key = 0
    for fileno, tar_path in enumerate(
            [tar_files] if isinstance(tar_files, str) else tar_files):
        sources.append(f"{fileno}\t{os.path.basename(tar_path)}\n")
        with tarfile.open(tar_path) as tf:
            for member in tf:
                if not member.isfile():
                    continue
                name = member.name
                if not inc.search(name) or exc.search(name):
                    continue
                entries.append((key, tf.extractfile(member).read()))
                lookup.append(f"{key}\t{name}\t{fileno}\n")
                key += 1
    mmseqsdb.write_db(out_db, entries,
                      mmseqsdb.DBTYPE_GENERIC if output_dbtype is None
                      else int(output_dbtype),
                      compressed=compressed)
    with open(f"{out_db}.lookup", "w") as f:
        f.writelines(lookup)
    with open(f"{out_db}.source", "w") as f:
        f.writelines(sources)
    return out_db


def db2tar(in_db, out_tar):
    """db2tar.cpp role: pack DB entries (named via .lookup when present)
    into a tar archive."""
    import io
    import tarfile

    names = {}
    if os.path.exists(f"{in_db}.lookup"):
        for ln in open(f"{in_db}.lookup"):
            c = ln.rstrip("\n").split("\t")
            names[int(c[0])] = c[1]
    with tarfile.open(out_tar, "w", format=tarfile.GNU_FORMAT) as tf:
        for key, payload in mmseqsdb.read_db(in_db):
            info = tarfile.TarInfo(names.get(key, str(key)))
            info.size = len(payload)
            info.mtime = 0
            tf.addfile(info, io.BytesIO(payload))
    return out_tar
