# Copy of metaeuk_tpu/search/linclust.py; it differs from its original only in this note.
"""Linear-time clustering (the linclust role).

Contract-level equivalent of lib/mmseqs/src/linclust/ (kmermatcher.cpp +
linclust.sh: select m lowest-hash k-mers per sequence, group sequences
sharing a selected k-mer under the longest member as center, verify
candidate edges by alignment, then greedy incremental clustering).  The
design is this framework's own: numpy vectorized k-mer hashing + selection
on the host, candidate verification through the batched TPU gapless/SW
path (ops/ungapped.py / search driver), greedy set-cover assignment.

Output format matches the reference cluster DB convention: one entry per
representative, payload = newline-separated member keys (rep first).
"""

import numpy as np

from ..data.submat import AA2NUM, encode_aa

KMER_SIZE = 6
ALPH = 20


def _hash64(x):
    """splitmix64-style avalanche (deterministic, portable)."""
    x = np.asarray(x, np.uint64).copy()
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def seq_selected_kmers(enc, kmers_per_seq=21, scale=0.8):
    """Indices of the m lowest-hash contiguous 6-mers (X-free) of one
    sequence; m = kmersPerSequence - 1 + scale*L/100 like the reference's
    --kmer-per-seq-scale logic (kmermatcher.cpp:204-206)."""
    enc = np.asarray(enc, np.int64)
    L = len(enc)
    if L < KMER_SIZE:
        return np.zeros(0, np.uint64)
    win = np.lib.stride_tricks.sliding_window_view(enc, KMER_SIZE)
    valid = (win < ALPH).all(axis=1)
    powers = (ALPH ** np.arange(KMER_SIZE)).astype(np.int64)
    idx = (win * powers).sum(axis=1)[valid].astype(np.uint64)
    if idx.size == 0:
        return np.zeros(0, np.uint64)
    h = _hash64(idx)
    m = min(int(kmers_per_seq - 1 + scale * L / 100.0) + 1, idx.size)
    order = np.argsort(h, kind="stable")[:m]
    return np.unique(idx[order])


def candidate_pairs(encs, kmers_per_seq=21):
    """(center, member) candidate edges: sequences sharing a selected
    k-mer, center = longest (ties: smallest id), like kmermatcher's
    per-k-mer center choice."""
    lens = np.array([len(e) for e in encs], np.int64)
    all_kmers = []
    all_seq = []
    for i, enc in enumerate(encs):
        km = seq_selected_kmers(enc, kmers_per_seq)
        all_kmers.append(km)
        all_seq.append(np.full(km.size, i, np.int64))
    if not all_kmers:
        return np.zeros((0, 2), np.int64)
    kmers = np.concatenate(all_kmers)
    seqs = np.concatenate(all_seq)
    order = np.lexsort((seqs, kmers))
    kmers, seqs = kmers[order], seqs[order]
    pairs = set()
    i = 0
    n = len(kmers)
    while i < n:
        j = i
        while j < n and kmers[j] == kmers[i]:
            j += 1
        group = seqs[i:j]
        if j - i > 1:
            # center: longest, ties smallest id
            center = group[np.lexsort((group, -lens[group]))[0]]
            for s in group:
                if s != center:
                    pairs.add((int(center), int(s)))
        i = j
    if not pairs:
        return np.zeros((0, 2), np.int64)
    return np.array(sorted(pairs), np.int64)


def _real_identity(q, t, res):
    """Aligned identity via the native banded traceback; None if the
    native library is unavailable (falls back to the score estimate)."""
    from .. import native
    bt = native.banded_sw_traceback(
        q[res["q_start"]:res["q_end"] + 1], np.zeros(
            res["q_end"] - res["q_start"] + 1, np.int8),
        t[res["t_start"]:res["t_end"] + 1], res["score"],
        max(res["q_end"] - res["q_start"], res["t_end"] - res["t_start"]) + 1)
    if bt is None:
        return None
    qi, ti, matches, cols = res["q_start"], res["t_start"], 0, 0
    for op in bt:
        if op == "M":
            matches += int(q[qi] == t[ti])
            qi += 1
            ti += 1
            cols += 1
        elif op == "I":
            qi += 1
            cols += 1
        else:
            ti += 1
            cols += 1
    return matches / max(1, cols)


def linclust(seqs_aa, min_seq_id=0.9, cov_thr=0.8, kmers_per_seq=21):
    """Cluster AA byte-string sequences; returns {rep: [members...]}.

    Candidate edges verified with the full SW path (score, identity,
    bidirectional coverage); greedy assignment in descending rep length
    (set-cover style, matching the reference's clustering semantics)."""
    encs = [encode_aa(s) for s in seqs_aa]
    lens = np.array([len(e) for e in encs], np.int64)
    n = len(encs)
    edges = candidate_pairs(encs, kmers_per_seq)

    accepted = {i: set() for i in range(n)}
    if len(edges):
        from ..ops.sw import sw_align
        from .driver import estimate_seq_id
        for c, m in edges:
            q, t = encs[m], encs[c]
            res = sw_align(q, t)
            score = res["score"]
            qs, qe = res["q_start"], res["q_end"]
            ts, te = res["t_start"], res["t_end"]
            qcov = (qe - qs + 1) / max(1, len(q))
            tcov = (te - ts + 1) / max(1, len(t))
            seq_id = _real_identity(q, t, res)
            if seq_id is None:
                seq_id = float(estimate_seq_id(np.float32(score),
                                               qe - qs + 1, te - ts + 1))
            if qcov >= cov_thr and tcov >= cov_thr and seq_id >= min_seq_id:
                accepted[c].add(m)

    # greedy set cover: longest centers claim members first
    assigned = {}
    clusters = {}
    for c in np.lexsort((np.arange(n), -lens)):
        c = int(c)
        if c in assigned:
            continue
        clusters[c] = [c]
        assigned[c] = c
        for m in sorted(accepted[c]):
            if m not in assigned:
                assigned[m] = c
                clusters[c].append(m)
    return clusters


def linclust_db(in_db, out_db, min_seq_id=0.9, cov_thr=0.8):
    """Sequence DB -> cluster DB (rep-keyed member lists, the clust output
    convention)."""
    from ..io import mmseqsdb
    db = mmseqsdb.read_seqdb(in_db)
    seqs = [db.seq_bytes(i) for i in range(len(db))]
    clusters = linclust(seqs, min_seq_id, cov_thr)
    out = []
    for rep in sorted(clusters):
        payload = "".join(f"{int(db.keys[m])}\n" for m in clusters[rep])
        out.append((int(db.keys[rep]), payload.encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_GENERIC)
    return out_db
