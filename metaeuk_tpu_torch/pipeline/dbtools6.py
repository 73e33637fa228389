"""Util batch 6: profile2consensus/profile2repseq/profile2neff,
convertmsa, filtera3m, alignall, summarizetabs, result2dnamsa.

Ports of the same-named tools in lib/mmseqs/src/util/ (file:line cited
per function). Byte parity on tests/golden/util6 fixtures.

Counterpart of metaeuk_tpu/pipeline/dbtools6.py: alignall takes a
`device` keyword (default cuda; cpu runs the kernels' plain versions) for
its exhaustive score-only search on the port's SearchDriver; the other
tools run on the host only, as there.
"""

import numpy as np

from ..io import mmseqsdb


def profile2seq(profile_db, out_db, consensus=True, compressed=False):
    """profile2seq.cpp: profile DB -> consensus (profile2consensus) or
    query/representative (profile2repseq) sequence DB."""
    from ..data.submat import ALPHABET
    from ..io.profiledb import ProfileDB

    pdb = ProfileDB.from_db(profile_db)
    out = []
    for i, key in enumerate(pdb.keys):
        arr = pdb.consensus[i] if consensus else pdb.query_seqs[i]
        text = "".join(ALPHABET[c] for c in arr) + "\n"
        out.append((int(key), text.encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_AA
                      if hasattr(mmseqsdb, "DBTYPE_AA") else 0,
                      compressed=compressed)
    return out_db


def profile2neff(profile_db, out_path, db_output=False, compressed=False):
    """profile2neff.cpp: per profile position, Neff_M decoded from the
    profile's Neff byte (MathUtil::convertNeffToFloat = fpow2((c-1)/64)),
    printed %0.4f tab-separated."""
    from ..io.profiledb import PROFILE_AA_SIZE, PROFILE_READIN_SIZE
    from ..ops.pssm import fpow2

    out = []
    for key, payload in mmseqsdb.read_db(profile_db):
        rec = np.frombuffer(payload, np.uint8)
        rec = rec[:len(rec) - len(rec) % PROFILE_READIN_SIZE].reshape(
            -1, PROFILE_READIN_SIZE)
        neff_bytes = rec[:, PROFILE_AA_SIZE + 2].astype(np.float32)
        neff = fpow2((neff_bytes - np.float32(1.0)) / np.float32(64.0))
        text = ""
        if not db_output:
            text += f"Neff_Ms of sequence {key}\n"
        text += "\t".join("%0.4f" % v for v in np.asarray(neff)) + "\n"
        out.append((key, text.encode()))
    if db_output:
        mmseqsdb.write_db(out_path, out, mmseqsdb.DBTYPE_GENERIC,
                          compressed=compressed)
    else:
        with open(out_path, "w") as f:
            for _k, payload in out:
                f.write(payload.decode())
    return out_path


def convertmsa(sto_path, out_db, identifier_field=1, compressed=False):
    """convertmsa.cpp: Stockholm (possibly multi-block) -> MSA FASTA DB;
    '.' -> '-', the first member's header gains the #=GF ID (field 0) or
    AC (field 1) identifier; keys sequential."""
    import gzip

    opener = gzip.open if str(sto_path).endswith(".gz") else open
    entries = []
    seq_order = []
    sequences = {}
    identifier = ""
    in_entry = False
    key = 0
    with opener(sto_path, "rt") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if not in_entry and line == "# STOCKHOLM 1.0":
                in_entry = True
                continue
            if in_entry and line == "//":
                in_entry = False
                parts = []
                for j, acc in enumerate(seq_order):
                    hdr = acc
                    if j == 0 and identifier:
                        hdr = f"{identifier} {acc}"
                    parts.append(f">{hdr}\n{sequences[acc]}\n")
                entries.append((key, "".join(parts).encode()))
                key += 1
                seq_order = []
                sequences = {}
                identifier = ""
                continue
            if not in_entry:
                continue
            cols = line.split()
            if line[0] == "#":
                if line.startswith("#=GF") and len(cols) >= 3:
                    if identifier_field == 1 and cols[1] == "AC":
                        identifier = cols[2]
                    elif identifier_field == 0 and cols[1] == "ID":
                        identifier = cols[2]
            elif len(cols) >= 2:
                acc, seq = cols[0], cols[1].replace(".", "-")
                if acc in sequences:
                    sequences[acc] += seq
                else:
                    sequences[acc] = seq
                    seq_order.append(acc)
    mmseqsdb.write_db(out_db, entries, mmseqsdb.DBTYPE_MSA
                      if hasattr(mmseqsdb, "DBTYPE_MSA") else 11,
                      compressed=compressed)
    return out_db


def filtera3m(a3m_path, out_path, cov=0.0, qid="0.0", qsc=-20.0,
              max_seq_id=0.9, ndiff=1000, filter_min_enable=0):
    """filtera3m.cpp: MsaFilter over an A3M file (lowercase insertion
    columns stripped for filtering, original entries written for the
    kept rows)."""
    from ..data.submat import AA2NUM
    from ..ops.msafilter import msa_filter

    headers = []
    raw_seqs = []
    with open(a3m_path) as f:
        hdr = None
        seq = []
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if hdr is not None:
                    headers.append(hdr)
                    raw_seqs.append("".join(seq))
                hdr = line
                seq = []
            else:
                seq.append(line)
        if hdr is not None:
            headers.append(hdr)
            raw_seqs.append("".join(seq))

    match_seqs = ["".join(c for c in s if not c.islower())
                  for s in raw_seqs]
    L = len(match_seqs[0]) if match_seqs else 0
    GAP = 21
    msa = np.full((len(match_seqs), L), GAP, np.uint8)
    for k, s in enumerate(match_seqs):
        arr = np.frombuffer(s[:L].ljust(L, "-").encode(), np.uint8)
        row = AA2NUM[arr]
        row = np.where(arr == ord("-"), GAP, row)
        msa[k] = row
    if L:
        # readMSA quirk (filtera3m.cpp:41-45): the GAP padding loop
        # starts at centerLength-1, clobbering the LAST match column
        msa[:, L - 1] = GAP
    qid_vec = sorted(int(float(s) * 100) for s in str(qid).split(","))
    keep, _order, _size = msa_filter(
        msa, coverage=int(cov * 100), qid_vec=qid_vec, qsc=qsc,
        max_seqid=int(max_seq_id * 100), ndiff=ndiff,
        filter_min_enable=filter_min_enable)
    with open(out_path, "w") as f:
        for k in range(len(raw_seqs)):
            if keep[k]:
                f.write(f"{headers[k]}\n{raw_seqs[k]}\n")
    return out_path


def alignall(seq_db, set_db, out_db, evalue=1e-3, cov=0.0, cov_mode=0,
             min_seq_id=0.0, compressed=False, device="cuda"):
    """alignall.cpp: per set entry, all-vs-all gapped alignment among the
    member sequences (SCORE_ONLY at the defaults), each line prefixed
    with the member query key; the alignment on `device`."""
    import dataclasses

    from ..params import Params
    from ..pipeline.alnformat import hit_to_matcher_line
    from ..search.driver import SearchDriver
    from ..search.lcaalign import (_raw_results, _score_only_row,
                                   can_be_covered, has_coverage)

    db = mmseqsdb.read_seqdb(seq_db)
    by_key = {int(k): i for i, k in enumerate(db.keys)}
    seqs = [db.seq_bytes(i) for i in range(len(db))]
    lens = [len(s) for s in seqs]

    sets = mmseqsdb.read_db(set_db)
    pairs = []
    for _key, payload in sets:
        members = [int(ln.split("\t")[0]) for ln in
                   payload.decode().splitlines() if ln]
        for a in members:
            for b in members:
                if can_be_covered(cov, cov_mode, lens[by_key[a]],
                                  lens[by_key[b]]):
                    pairs.append((by_key[a], by_key[b]))
    p = Params(search_evalue_thr=float("inf"), seq_id_thr=0.0, cov_thr=0.0,
               aln_len_thr=0, prefilter_mode="exhaustive")
    driver = SearchDriver(p, db, device=device)
    raw = _raw_results(driver, seqs, np.asarray(sorted(set(pairs)),
                                                np.int64))

    out = []
    for key, payload in sets:
        members = [int(ln.split("\t")[0]) for ln in
                   payload.decode().splitlines() if ln]
        lines = []
        for a in members:
            for b in members:
                qi, ti = by_key[a], by_key[b]
                if not can_be_covered(cov, cov_mode, lens[qi], lens[ti]):
                    continue
                h = raw.get((qi, ti))
                if h is None:
                    continue
                if float(h["evalue"]) > evalue:
                    continue
                row = _score_only_row(h, b)
                lines.append(f"{a}\t" + hit_to_matcher_line(row))
        out.append((key, "".join(lines).encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_GENERIC,
                      compressed=compressed)
    return out_db


def summarizetabs(m8_db, lengths_tsv, out_db, overlap=0.0, cov=0.0,
                  evalue=0.001, compressed=False):
    """summarizetabs.cpp: greedy non-overlapping domain selection over
    BLAST-tab entries; lengths looked up via map::lower_bound (first key
    NOT LESS than the accession — the reference quirk for missing
    keys)."""
    import bisect

    items = []
    for ln in open(lengths_tsv):
        c = ln.rstrip("\n").split("\t")
        items.append((c[0], int(c[1])))
    items.sort()
    keys = [k for k, _v in items]

    def lower_bound(acc):
        i = bisect.bisect_left(keys, acc)
        if i >= len(items):
            return None
        return items[i][1]

    out = []
    for key, payload in mmseqsdb.read_db(m8_db):
        domains = []
        for ln in payload.decode().splitlines():
            f = ln.split("\t")
            q_len = lower_bound(str(key))
            t_len = lower_bound(f[1])
            if q_len is None or t_len is None:
                continue
            domains.append(dict(
                query=str(key), target=f[1],
                qs=int(f[6]) - 1, qe=int(f[7]) - 1, ql=q_len,
                ts=int(f[8]) - 1, te=int(f[9]) - 1, tl=t_len,
                ev=float(f[10])))
        if not domains:
            continue
        domains.sort(key=lambda d: d["ev"])  # stable by e-value
        covered = np.zeros(domains[0]["ql"], bool)
        result = []
        for d in domains:
            if d["qs"] > d["ql"] or d["qe"] > d["ql"] or \
                    d["qs"] > d["qe"] or d["ts"] > d["te"] or \
                    d["ts"] > d["tl"] or d["te"] > d["tl"]:
                continue
            ov = float(covered[d["qs"]:d["qe"]].sum()) / \
                float(d["qe"] - d["qs"] + 1)
            tcov = (d["te"] - d["ts"] + 1) / float(d["tl"])
            if ov <= overlap and tcov > cov and d["ev"] < evalue:
                covered[d["qs"]:d["qe"]] = True
                result.append(d)
        if not result:
            continue
        lines = []
        for d in result:
            ev = np.format_float_scientific if False else None
            lines.append(f"{d['query']}\t{d['target']}\t{d['qs']}\t"
                         f"{d['qe']}\t{d['ql']}\t{d['ts']}\t{d['te']}\t"
                         f"{d['tl']}\t{_ostream_double(d['ev'])}\n")
        out.append((key, "".join(lines).encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES,
                      compressed=compressed)
    return out_db


def _ostream_double(v):
    """std::ostream << double at precision 6 (digits10<float>)."""
    s = f"{v:.6g}"
    if "e" in s:
        mant, ex = s.split("e")
        ex_i = int(ex)
        s = f"{mant}e{'-' if ex_i < 0 else '+'}{abs(ex_i):02d}"
    return s


def result2dnamsa(query_db, target_db, aln_db, out_db, skip_query=False,
                  compressed=False):
    """result2dnamsa.cpp: gap-padded nucleotide MSA FASTA per query from
    backtraced alignments (incl. reverse-strand complementing)."""
    from ..data.gencode import REVCOMP_TABLE
    from .dbtools2 import _lines, parse_aln_record

    qdb = mmseqsdb.read_seqdb(query_db)
    same = str(query_db) == str(target_db)
    tdb = qdb if same else mmseqsdb.read_seqdb(target_db)
    q_by_key = {int(k): i for i, k in enumerate(qdb.keys)}
    t_by_key = {int(k): i for i, k in enumerate(tdb.keys)}
    q_hdr = dict(mmseqsdb.read_db(f"{query_db}_h"))
    t_hdr = q_hdr if same else dict(mmseqsdb.read_db(f"{target_db}_h"))

    def expand(cigar):
        import re as _re
        ops = []
        for cnt, op in _re.findall(r"(\d+)([MID])", cigar):
            ops.extend(op * int(cnt))
        return ops

    out = []
    for key, payload in mmseqsdb.read_db(aln_db):
        parts = []
        if not skip_query:
            parts.append(b">" + q_hdr[key])
            parts.append(bytes(qdb.seq_bytes(q_by_key[key])) + b"\n")
        for ln in _lines(payload):
            r = parse_aln_record(ln)
            c = ln.split("\t")
            if len(c) >= 15:
                # ORF-extended record: backtrace is the 15th column
                r["backtrace"] = c[14]
            t_seq = bytes(tdb.seq_bytes(t_by_key[r["dbKey"]]))
            q_rev = r["qStart"] > r["qEnd"]
            t_rev = r["dbStart"] > r["dbEnd"]
            bt = r["backtrace"] or ""
            ts_, te = r["dbStart"], r["dbEnd"]
            reverse_strand = False
            if q_rev and t_rev:
                ts_, te = te, ts_
                bt = bt  # backtrace reversed op-wise below
                ops = expand(bt)[::-1]
            elif q_rev and not t_rev:
                reverse_strand = True
                ts_, te = te, ts_
                ops = expand(bt)[::-1]
            elif not q_rev and t_rev:
                reverse_strand = True
                ops = expand(bt)
            else:
                ops = expand(bt)
            row = ["-"] * min(r["qStart"], r["qEnd"])
            seq_pos = 0
            for op in ops:
                ch = chr(REVCOMP_TABLE[t_seq[ts_ - seq_pos]]
                         if reverse_strand else t_seq[ts_ + seq_pos])
                if op == "M":
                    row.append(ch)
                    seq_pos += 1
                elif op == "I":
                    row.append("-")
                else:  # D: consumed on target, not printed
                    seq_pos += 1
            parts.append(b">" + t_hdr[r["dbKey"]])
            parts.append("".join(row).encode() + b"\n")
        out.append((key, b"".join(parts)))
    mmseqsdb.write_db(out_db, out, 11, compressed=compressed)
    return out_db
