# Copy of metaeuk_tpu/pipeline/dbtools8.py; it differs from its original only in this note.
"""Util batch 10: convertkb, extractdomains, appenddbtoindex.

Ports of lib/mmseqs/src/util/{convertkb,extractdomains,
appenddbtoindex}.cpp + commons/UniprotKB.cpp. Byte parity on
tests/golden/util10 fixtures.
"""

import numpy as np

from ..io import mmseqsdb

# UniprotKB prefix table (UniprotKB.cpp:77-104): prefix, column index
# (-1 = skipped), line mode (S single / M multiple / F fold / C concat),
# transform
_KB_COLS = ["ID", "AC", "DT", "DE", "GN", "OS", "OG", "OC", "OX", "OH",
            "REF", "CC", "DR", "PE", "KW", "FT", "SEQ"]
_KB_PREFIX = [
    ("ID", 0, "S", "first_word"),
    ("AC", 1, "C", "no_ws"),
    ("DT", 2, "M", None),
    ("DE", 3, "M", None),
    ("GN", 4, "F", None),
    ("OS", 5, "M", None),
    ("OG", 6, "M", None),
    ("OC", 7, "F", None),
    ("OX", 8, "S", None),
    ("OH", 9, "M", None),
    ("RN", 10, "M", None),
    ("RP", 10, "M", None),
    ("RC", 10, "M", None),
    ("RX", 10, "M", None),
    ("RG", 10, "M", None),
    ("RA", 10, "M", None),
    ("RT", 10, "M", None),
    ("RL", 10, "M", None),
    ("CC", 11, "M", None),
    ("DR", 12, "M", None),
    ("PE", 13, "S", "before_colon"),
    ("KW", 14, "F", None),
    ("FT", 15, "M", None),
    ("SQ", -1, "S", None),
    ("  ", 16, "C", "no_ws"),
]


def _kb_transform(kind, text):
    if kind == "first_word":
        return text.split(" ", 1)[0] if " " in text else text
    if kind == "no_ws":
        return "".join(text.split())
    if kind == "before_colon":
        return text.split(":", 1)[0]
    return text


def convertkb(dat_files, out_base, kb_columns=None, mapping_lookup=None):
    """convertkb.cpp + UniprotKB::readLine: one DB per selected column,
    keys sequential per parsed entry (or mapped through an existing
    .lookup when mapping_lookup is given); <out>.lookup maps keys to the
    primary accession."""
    cols = kb_columns.split(",") if isinstance(kb_columns, str) \
        else (kb_columns or _KB_COLS)
    enabled = sorted(_KB_COLS.index(c) for c in cols)

    acc_to_key = None
    if mapping_lookup:
        acc_to_key = {}
        for ln in open(mapping_lookup):
            c = ln.rstrip("\n").split("\t")
            acc_to_key[c[1]] = int(c[0])

    outputs = {i: [] for i in enabled}
    lookup = []
    key = 0
    for path in ([dat_files] if isinstance(dat_files, str) else dat_files):
        streams = ["" for _ in _KB_COLS]
        in_entry = False
        for line in open(path):
            line = line.rstrip("\n")
            if len(line) < 2:
                continue
            if line.startswith("ID"):
                streams = ["" for _ in _KB_COLS]
                in_entry = True
            if in_entry:
                for prefix, col, mode, transform in _KB_PREFIX:
                    if not line.startswith(prefix):
                        continue
                    if col == -1:
                        continue
                    start = line[5:]
                    text = _kb_transform(transform, start)
                    streams[col] += text
                    if mode == "M":
                        streams[col] += "\n"
                    elif mode == "F":
                        streams[col] += " "
            if line.startswith("//"):
                in_entry = False
                accession = streams[1].split(";", 1)[0]
                k = key
                if acc_to_key is not None:
                    k = acc_to_key.get(accession)
                    if k is None:
                        key += 1
                        continue
                for i in enabled:
                    outputs[i].append((k, streams[i].encode()))
                if acc_to_key is None:
                    lookup.append(f"{key}\t{accession}\n")
                key += 1
    for i in enabled:
        mmseqsdb.write_db(f"{out_base}_{_KB_COLS[i]}", outputs[i],
                          mmseqsdb.DBTYPE_GENERIC)
    if acc_to_key is None:
        with open(f"{out_base}.lookup", "w") as f:
            f.writelines(lookup)
    return out_base


def _score_sub_alignment(query, target, q_start, q_end, t_start, t_end,
                         scores):
    """extractdomains.cpp scoreSubAlignment: gap-open 10 / extend 1 with
    zero floor over the aligned MSA rows (lowercase = insertions)."""
    raw = 0
    max_score = 0
    tpos = t_start
    qpos = q_start
    i = 0
    while i < (q_end - q_start):
        if tpos >= t_end:
            break
        if qpos < len(query) and query[qpos] == "-":
            raw = max(0, raw - 10)
            while qpos < q_end and query[qpos] == "-":
                raw = max(0, raw - 1)
                qpos += 1
                tpos += 1
        elif tpos < len(target) and (target[tpos] == "-"
                                     or target[tpos].islower()):
            raw = max(0, raw - 10)
            while tpos < t_end and target[tpos] == "-":
                raw = max(0, raw - 1)
                tpos += 1
                qpos += 1
            while tpos < t_end and target[tpos].islower():
                raw = max(0, raw - 1)
                tpos += 1
        else:
            qc = query[qpos] if qpos < len(query) else "X"
            tc = target[tpos] if tpos < len(target) else "X"
            raw = max(0, raw + int(scores[ord(qc), ord(tc)]))
            qpos += 1
            tpos += 1
        max_score = max(max_score, raw)
        i += 1
    return max_score


def extractdomains(domain_db, msa_db, out_db, cov=0.0, evalue=0.001,
                   compressed=False):
    """extractdomains.cpp: map each (summarizetabs-format) domain onto
    every MSA member row; accept when target coverage > --cov and the
    combined e-value (domain + K*len*exp(-lambda*score) with the fixed
    K=0.041/lambda=0.267 linear constants) < -e."""
    from ..io.fasta import parse_fasta_header
    from .dbtools6 import _ostream_double
    from .rescorediagonal import _ascii_scores

    scores = _ascii_scores()
    msa = dict(mmseqsdb.read_db(msa_db))
    out = []
    for key, payload in mmseqsdb.read_db(domain_db):
        if key not in msa:
            continue
        domains = []
        for ln in payload.decode().splitlines():
            f = ln.split("\t")
            if len(f) < 9:
                continue
            domains.append(dict(query=f[0], target=f[1], qs=int(f[2]),
                                qe=int(f[3]), ql=int(f[4]), ts=int(f[5]),
                                te=int(f[6]), tl=int(f[7]),
                                ev=float(f[8])))
        if not domains:
            continue
        rows = []
        text = msa[key].decode().rstrip("\x00")
        entries = []
        hdr = None
        seq = []
        for line in text.split("\n"):
            if line.startswith(">"):
                if hdr is not None:
                    entries.append((hdr, "".join(seq)))
                hdr = line[1:]
                seq = []
            elif line:
                seq.append(line)
        if hdr is not None:
            entries.append((hdr, "".join(seq)))

        query_sequence = None
        for full_hdr, sequence in entries:
            full_name = full_hdr.split(" ", 1)[0]
            if full_name.startswith("consensus_") or \
                    full_name.endswith("_consensus"):
                continue
            name = parse_fasta_header(full_hdr)
            if " " in full_hdr and "Split=" in full_hdr:
                tail = full_hdr.split("Split=", 1)[1]
                split = tail.split(" ")[0].split("\n")[0]
                if split != "0":
                    name = f"{name}_{split}"
            if query_sequence is None:
                query_sequence = sequence
            length = sum(1 for c in sequence if c.isalpha())
            for d in domains:
                found_start = False
                domain_start = 0
                pos_no_ins = 0
                q_dom_off = 0
                for aa_pos, c in enumerate(sequence):
                    if c not in "-." and not found_start and \
                            d["qs"] <= pos_no_ins <= d["qe"]:
                        found_start = True
                        domain_start = aa_pos
                        q_dom_off = pos_no_ins - d["qs"]
                    if not c.islower():
                        pos_no_ins += 1
                    if pos_no_ins == d["qe"] and found_start:
                        domain_end = min(aa_pos, length - 1)
                        dom_cov = (domain_end - domain_start + 1) / \
                            float(d["tl"])
                        score = _score_sub_alignment(
                            query_sequence, sequence,
                            d["qs"] + q_dom_off, d["qe"],
                            domain_start, domain_end, scores)
                        dom_ev = d["ev"] + 0.041 * length * \
                            np.exp(-0.267 * score)
                        if dom_cov > cov and dom_ev < evalue:
                            rows.append(
                                f"{name}\t{d['target']}\t{domain_start}"
                                f"\t{domain_end}\t{length}\t{d['ts']}\t"
                                f"{d['te']}\t{d['tl']}\t"
                                f"{_ostream_double(dom_ev)}\n")
                        break
        if rows:
            out.append((key, "".join(rows).encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES,
                      compressed=compressed)
    return out_db


def _estimate_lambda_background(scores):
    """SubstitutionMatrix::estimateLambdaAndBackground →
    LambdaCalculation.cpp calculate_lambda, reimplemented directly
    from the defining equations: find lambda>0 with
    sum_i sum_j p_i p_j exp(lambda*s_ij) consistent, i.e. solve
    M(lambda) q = 1 (M_ij = exp(lambda*s_ij)) and root
    f(lambda) = sum(q) - 1 = 0; the solution q is the background."""
    n = scores.shape[0]
    ones = np.ones(n)

    def f(lam):
        try:
            q = np.linalg.solve(np.exp(lam * scores), ones)
        except np.linalg.LinAlgError:
            return None, None
        return q.sum() - 1.0, q

    prev = None
    for lam in np.linspace(0.01, 4.0, 800):
        v, _ = f(lam)
        if v is None or not np.isfinite(v):
            prev = None
            continue
        if prev is not None and prev[1] * v < 0:
            a, b = prev[0], lam
            va = prev[1]
            for _ in range(200):
                m = 0.5 * (a + b)
                vm, _ = f(m)
                if vm is None:
                    break
                if va * vm < 0:
                    b = m
                else:
                    a, va = m, vm
            lam = 0.5 * (a + b)
            _, q = f(lam)
            if q is not None and np.all(q > 0):
                return lam, q
        prev = (lam, v)
    return -1.0, None


def calculatelambda(matrix_file):
    """calculatelambda.cpp: strip '#' comments, compute the matrix'
    implied lambda + background frequencies
    (SubstitutionMatrix::readProbMatrix, SubstitutionMatrix.cpp:388-404)
    and return the two '# ...' comment lines followed by the filtered
    matrix text. X background is the fixed ANY_BACK=0.00001; the
    estimation drops the trailing X row/col unless any X score is
    positive (xIsPositive, SubstitutionMatrix.cpp:370-380)."""
    filtered = []
    for line in open(matrix_file):
        if line.startswith("#"):
            continue
        filtered.append(line.rstrip("\n") + "\n")
    rows = [l.split() for l in filtered if l.split()]
    letters = rows[0]
    alph = len(letters)
    mat = np.zeros((alph, alph))
    for r in rows[1:]:
        i = letters.index(r[0].upper())
        mat[i, :] = [float(x) for x in r[1:alph + 1]]
    x_idx = letters.index("X") if "X" in letters else -1
    x_positive = x_idx >= 0 and (np.any(mat[x_idx, :] > 0)
                                 or np.any(mat[:, x_idx] > 0))
    n = alph if x_positive else alph - 1
    lam, back = _estimate_lambda_background(mat[:n, :n])
    out = []
    if back is not None:
        pback = np.zeros(alph)
        pback[:n] = back
        if x_idx >= 0:
            pback[x_idx] = 0.00001
        out.append("# Background (precomputed optional):" +
                   "".join(" " + "%.5f" % np.float32(p) for p in pback) +
                   "\n")
        out.append("# Lambda     (precomputed optional): " +
                   "%.5f" % np.float32(lam) + "\n")
    out.extend(filtered)
    return "".join(out)


def appenddbtoindex(in_dbs, index_db, keys=None):
    """appenddbtoindex role for this framework's .kidx artifacts: the
    reference appends raw DB files into a packed INDEX_DB; our persisted
    index is a single .kidx blob, so appended DBs are stored alongside
    it with a manifest (the consuming side resolves them by key)."""
    import json
    import os
    import shutil

    manifest_path = f"{index_db}.appended.json"
    manifest = {}
    if os.path.exists(manifest_path):
        import json as _json
        manifest = _json.load(open(manifest_path))
    for i, db in enumerate([in_dbs] if isinstance(in_dbs, str)
                           else in_dbs):
        key = str(keys[i]) if keys else os.path.basename(db)
        dst = f"{index_db}.appended.{key}"
        for s in ("", ".index", ".dbtype"):
            if os.path.exists(f"{db}{s}"):
                shutil.copyfile(f"{db}{s}", f"{dst}{s}")
        manifest[key] = dst
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=1)
    return index_db
