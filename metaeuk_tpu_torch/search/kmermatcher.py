"""kmermatcher: linclust's hash-selected k-mer grouping, byte-exact.

Port of lib/mmseqs/src/linclust/kmermatcher.cpp for amino-acid inputs
(single hash split, no weight file):

  - reduced 13-letter alphabet by iterative mutual-information-preserving
    letter merging (prefiltering/ReducedMatrix.cpp)
  - k = max(10, log(totalResidues)/log(8.7)); contiguous k-mers, X-free
    (setKmerLengthAndAlphabet, kmermatcher.cpp:1277-1293; setLinear-
    FilterDefault: covThr 0.8, no masking, kmersPerSequence 20)
  - per sequence: select ~20 k-mers with the smallest 16-bit XXH64
    hashes via the 65536-bin histogram + 128-bin hierarchical shortcut,
    including the last-bin excess quirk (kmermatcher.cpp:205-240), plus
    one whole-sequence identity hash entry (Util::hash * 31 chain
    -> XXH64)
  - global sort by (kmer, seqLen desc, id, pos); per-k-mer group keeps
    the longest sequence as center, drops singletons, applies the
    bidirectional 0.8 length-ratio filter (assignGroup)
  - re-sort by (center, id, diagonal) and emit prefilter-format lines:
    center self-hit, then per target the most frequent diagonal with the
    k-mer match count as score (writeKmerMatcherResult); unmatched
    sequences appended as singleton self-hits

Counterpart of metaeuk_tpu/search/kmermatcher.py on the port's
SearchDriver: linclust_exact takes a `device` keyword (default cuda; cpu
runs the kernels' plain versions) for its gapped alignment and backtraces;
kmermatcher_db and the hashing helpers run on the host only, as there.
"""

import math

import numpy as np

from ..data.submat import BLOSUM62_PROB
from ..io import mmseqsdb

_P1 = np.uint64(11400714785074694791)
_P2 = np.uint64(14029467366897019727)
_P3 = np.uint64(1609587929392839161)
_P4 = np.uint64(9650029242287828579)
_P5 = np.uint64(2870177450012600261)


def _rotl(x, r):
    r = np.uint64(r)
    return (x << r) | (x >> (np.uint64(64) - r))


def xxh64_u64(x, seed=67):
    """XXH64 of one little-endian uint64 (kmermatcher.cpp:35-40)."""
    with np.errstate(over="ignore"):
        x = np.asarray(x, np.uint64)
        h = np.uint64(seed) + _P5 + np.uint64(8)
        k1 = _rotl(x * _P2, 31) * _P1
        h = _rotl(h ^ k1, 27) * _P1 + _P4
        h ^= h >> np.uint64(33)
        h *= _P2
        h ^= h >> np.uint64(29)
        h *= _P3
        h ^= h >> np.uint64(32)
        return h


def _generate_sub_matrix(p):
    """BaseMatrix::generateSubMatrix double variant (BaseMatrix.cpp:
    110-139) without X handling: log2 odds over row-sum background."""
    bg = p.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log2(p / (bg[:, None] * bg[None, :]))


def _mutual_information(p, s):
    return float((p * s).sum())


def reduced_aa_mapping(n_target=13):
    """ReducedMatrix letter merging -> (aa2num 256-table, alphabet string).

    Greedy: at each step couple the letter pair whose merged probability
    matrix keeps the highest sum p*log2odds (ReducedMatrix.cpp:49-85,
    coupleWithBestInfo:198-238)."""
    from ..data.submat import ALPHABET, AA2NUM
    p = BLOSUM62_PROB[:20, :20].astype(np.float64).copy()
    alphabet = list(ALPHABET[:20])           # representative letters
    # class of each original letter index (0..19)
    cls = list(range(20))

    size = 20
    while size > n_target - 1:               # target includes X
        best_info, bi, bj = 0.0, 0, 0
        for i in range(size):
            for j in range(i + 1, size):
                merged = np.delete(np.delete(p, j, 0), j, 1).copy()
                merged[i, :] = np.delete(p[i, :] + p[j, :], j)
                merged[:, i] = np.delete(p[:, i] + p[:, j], j)
                merged[i, i] = p[i, i] + p[i, j] + p[j, i] + p[j, j]
                s = _generate_sub_matrix(merged)
                info = _mutual_information(merged, s)
                if info > best_info:
                    best_info, bi, bj = info, i, j
        # merge bj into bi
        lost = alphabet[bj]
        kept = alphabet[bi]
        merged = np.delete(np.delete(p, bj, 0), bj, 1).copy()
        merged[bi, :] = np.delete(p[bi, :] + p[bj, :], bj)
        merged[:, bi] = np.delete(p[:, bi] + p[:, bj], bj)
        merged[bi, bi] = p[bi, bi] + p[bi, bj] + p[bj, bi] + p[bj, bj]
        p = merged
        alphabet.pop(bj)
        for k in range(20):
            if cls[k] == ALPHABET.index(lost):
                cls[k] = ALPHABET.index(kept)
        # remap classes of letters previously merged into `lost`
        for k in range(20):
            if ALPHABET[cls[k]] == lost:
                cls[k] = ALPHABET.index(kept)
        size -= 1

    # build the 256-entry mapping: representative order = remaining list,
    # X last (ReducedMatrix.cpp:88-108)
    rep_index = {ALPHABET.index(a): i for i, a in enumerate(alphabet)}
    out = np.full(256, n_target - 1, np.uint8)   # default X
    for k in range(20):
        ri = rep_index[cls[k]]
        ch = ALPHABET[k]
        out[ord(ch)] = ri
        out[ord(ch.lower())] = ri
    # letter-mapping quirks follow setupLetterMapping (J->L etc.)
    for src, dst in (("J", "L"), ("Z", "E"), ("B", "D")):
        di = rep_index[cls[ALPHABET.index(dst)]]
        out[ord(src)] = di
        out[ord(src.lower())] = di
    return out, "".join(alphabet) + "X"


_REDUCED_CACHE = {}


def _reduced(n_target=13):
    if n_target not in _REDUCED_CACHE:
        _REDUCED_CACHE[n_target] = reduced_aa_mapping(n_target)
    return _REDUCED_CACHE[n_target]


def _util_hash(arr):
    """Util::hash (Util.h:344-352): h = h*31 + x over size_t."""
    h = np.uint64(0)
    with np.errstate(over="ignore"):
        for v in np.asarray(arr, np.uint64):
            h = h * np.uint64(31) + v
    return h


# Spaced seed patterns (data tables from lib/mmseqs/src/commons/
# Sequence.h:31-71; 1 = informative position).
SPACED_SEEDS = {
    10: "110101101011011",
    11: "11010110011011011",
    12: "1101011001101101011",
    13: "11010111001101101011",
    14: "110101110011011011011",
    15: "11101011110110001011011",
    16: "1110111001010010110011111",
    17: "11101110010100101100111111",
    18: "1110100111011001010011101111",
    19: "11101001110110010100111011111",
    20: "111010110101100110011101011111",
    21: "11110110101011011101010011001111",
    22: "111101101010110111010100110011111",
    23: "1111011010101101110101100110011111",
    24: "111101101010110111010100011100111111",
}


def _select_kmers(enc_red, k, kmers_per_seq, alph, spaced=False):
    """Per-sequence k-mer selection (kmermatcher.cpp:127-208, 240-333):
    returns list of (kmer_idx, pos) in extraction order. spaced: extract
    over the Sequence.h spaced seed pattern for this k."""
    L = len(enc_red)
    x_idx = alph - 1
    sel = []
    span = k
    if spaced:
        pattern = SPACED_SEEDS[k]
        span = len(pattern)
        cols = np.flatnonzero(np.frombuffer(pattern.encode(), np.uint8)
                              == ord("1"))
    if L < span:
        return sel, 0
    win = np.lib.stride_tricks.sliding_window_view(
        np.asarray(enc_red, np.int64), span)
    if spaced:
        win = win[:, cols]
    valid = (win != x_idx).all(axis=1)
    powers = ((alph - 1) ** np.arange(k)).astype(object)
    # indices can exceed 2^63 for large k: compute in python ints exactly
    # like size_t (mod 2^64)
    kidx = np.zeros(len(win), dtype=np.uint64)
    with np.errstate(over="ignore"):
        pw = np.array([(alph - 1) ** i % (1 << 64) for i in range(k)],
                      dtype=np.uint64)
        acc = np.zeros(len(win), np.uint64)
        for i in range(k):
            acc += win[:, i].astype(np.uint64) * pw[i]
        kidx = acc
    pos = np.flatnonzero(valid)
    kidx = kidx[valid]
    scores = (xxh64_u64(kidx) & np.uint64(0xFFFF)).astype(np.int64)
    n = len(kidx)
    if n == 0:
        return [], 0
    considered = min(kmers_per_seq - 1 + 0, n)   # aa scale = 0.0
    hist = np.bincount(scores, minlength=65536)
    hier = hist.reshape(128, 512).sum(axis=1)
    in_bins = 0
    ht = 0
    while ht < 128 and in_bins < considered:
        in_bins += int(hier[ht])
        ht += 1
    ht -= 1 if ht > 0 else 0
    in_bins -= int(hier[ht])
    thr = ht * 512
    while thr <= 0xFFFF and in_bins < considered:
        in_bins += int(hist[thr])
        thr += 1
    too_much = in_bins - considered
    out = []
    selected = 0
    for i in range(n):
        if selected >= considered:
            break
        sc = int(scores[i])
        if sc < thr:
            if sc == thr - 1 and too_much:
                too_much -= 1
                if too_much == 0:
                    thr -= 1
            selected += 1
            out.append((int(kidx[i]), int(pos[i])))
    return out, n


def kmermatcher_db(seq_db, out_db, kmers_per_seq=20, cov_thr=0.8,
                   cov_mode=0, n_alphabet=None, kmer_size=None,
                   seq_id_thr=0.0, spaced=False):
    """k/alphabet auto-selection follows setKmerLengthAndAlphabet
    (kmermatcher.cpp:1277-1293): seqIdThr>=0.99 -> k=14/alph 21;
    >=0.9 -> k=14/alph 13; else k=max(10, ln(res)/ln(8.7))/alph 13."""
    db = mmseqsdb.read_seqdb(seq_db)
    total_res = int(db.lengths.sum())
    if kmer_size is None and n_alphabet is None:
        if seq_id_thr + 0.001 >= 0.99:
            kmer_size, n_alphabet = 14, 21
        elif seq_id_thr + 0.001 >= 0.9:
            kmer_size, n_alphabet = 14, 13
        else:
            n_alphabet = 13
    n_alphabet = 13 if n_alphabet is None else n_alphabet
    if n_alphabet == 21:
        from ..data.submat import AA2NUM
        aa2red = AA2NUM
    else:
        aa2red, _alpha = _reduced(n_alphabet)
    k = kmer_size if kmer_size else max(
        10, int(math.log(float(total_res)) / math.log(8.7)))

    # --- fillKmerPositionArray ---
    entries = []   # (kmer, id, pos, seqLen)
    for i in range(len(db)):
        key = int(db.keys[i])
        enc = aa2red[np.asarray(db.seq(i), np.uint8)]
        L = len(enc)
        sel, _n = _select_kmers(enc, k, kmers_per_seq, n_alphabet,
                                spaced=spaced)
        seq_hash = int(xxh64_u64(_util_hash(enc)))
        entries.append((seq_hash, key, 0, L))
        for kidx, pos in sel:
            entries.append((kidx, key, pos, L))

    # --- sort by (kmer, seqLen desc, id, pos) ---
    entries.sort(key=lambda e: (e[0], -e[3], e[1], e[2]))

    # --- assignGroup ---
    groups = []
    out_rows = []
    i = 0
    n = len(entries)
    while i < n:
        j = i
        while j < n and entries[j][0] == entries[i][0]:
            j += 1
        if j - i > 1:
            rep_id = entries[i][1]
            rep_len = entries[i][3]
            rep_pos = entries[i][2]
            for kmer, sid, pos, slen in entries[i:j]:
                diagonal = rep_pos - pos
                from .lcaalign import can_be_covered
                if can_be_covered(cov_thr, cov_mode, rep_len, slen):
                    out_rows.append((rep_id, sid, diagonal, slen))
        i = j

    # --- sort by (rep, id, diag) + write (writeKmerMatcherResult) ---
    out_rows.sort(key=lambda r: (r[0], r[1], r[2]))
    rep_payloads = []
    write_sets = 0   # NEVER reset per group (kmermatcher.cpp:908-915):
    # after the first member write, later self-only rep groups are
    # emitted as header-only entries instead of singleton-pass lines
    i = 0
    n = len(out_rows)
    while i < n:
        rep = out_rows[i][0]
        j = i
        lines = [f"{rep}\t0\t0\n"]
        while j < n and out_rows[j][0] == rep:
            tid = out_rows[j][1]
            e = j
            best_diag = out_rows[j][2]
            prev_diag = best_diag
            diag_cnt = 0
            max_diag = 0
            top = 0
            while e < n and out_rows[e][0] == rep and out_rows[e][1] == tid:
                d = out_rows[e][2]
                diag_cnt = diag_cnt + 1 if d == prev_diag else 1
                if diag_cnt >= max_diag:
                    best_diag = d
                    max_diag = diag_cnt
                prev_diag = d
                e += 1
                top += 1
            if tid != rep:
                lines.append(f"{tid}\t{top}\t{best_diag}\n")
                write_sets += 1
            j = e
        if write_sets > 0:
            rep_payloads.append((rep, "".join(lines).encode()))
        i = j
    # the reference marks repSequence[rep]=true only for written reps;
    # everything else (members included) gets a singleton self-line
    covered = {p[0] for p in rep_payloads}
    singles = [(int(kk), f"{int(kk)}\t0\t0\n".encode())
               for kk in db.keys if int(kk) not in covered]
    mmseqsdb.write_db(out_db, rep_payloads + singles,
                      mmseqsdb.DBTYPE_PREFILTER_RES)
    return out_db


def linclust_exact(seq_db, out_db, tmp_dir, min_seq_id=0.9, cov=0.8,
                   cov_mode=0, alignment_mode=2, spaced=False,
                   comp_bias=True, device="cuda"):
    """The full linclust workflow (data/workflow/linclust.sh), chaining
    the byte-parity components: kmermatcher -> Hamming rescore ->
    set-cover pre-clustering -> representative subsetting -> filtered
    ungapped rescore (--filter-hits precision table) -> gapped alignment
    (the search driver, on `device`) -> set-cover -> mergeclusters."""
    import dataclasses
    import os
    import pathlib
    from ..io import mmseqsdb
    from ..params import Params
    from ..pipeline.clust import clust_db, mergeclusters
    from ..pipeline.dbtools import createsubdb, filterdb_by_file
    from ..pipeline.rescorediagonal import rescorediagonal
    from ..pipeline.alnformat import hit_to_matcher_line

    os.makedirs(tmp_dir, exist_ok=True)
    t = pathlib.Path(tmp_dir)
    pref = str(t / "pref")
    # linclust does NOT apply kmermatcher's setLinearFilterDefault: the
    # global --kmer-per-seq default 21 applies (Parameters.cpp:2627)
    kmermatcher_db(seq_db, pref, kmers_per_seq=21, cov_thr=cov,
                   cov_mode=cov_mode, seq_id_thr=min_seq_id, spaced=spaced)
    rescorediagonal(seq_db, seq_db, pref, str(t / "pref_rescore1"),
                    rescore_mode=0, seq_id_thr=max(0.5, min_seq_id),
                    cov_thr=max(0.5, cov), cov_mode=cov_mode)
    clust_db(seq_db, str(t / "pref_rescore1"), str(t / "pre_clust"))
    with open(str(t / "pre_clust.index")) as f:
        order = [int(line.split("\t")[0]) for line in f]
    red = str(t / "input_step_redundancy")
    createsubdb(order, seq_db, red)
    # subset DBs need their headers for read_seqdb
    import shutil
    for suf in ("_h", "_h.index", "_h.dbtype"):
        src = f"{seq_db}{suf}"
        if pathlib.Path(src).exists():
            shutil.copy(src, f"{red}{suf}")
    createsubdb(order, pref, str(t / "pref_filter1"))
    filterdb_by_file(str(t / "pref_filter1"), str(t / "pref_filter2"),
                     order)
    rescorediagonal(red, red, str(t / "pref_filter2"),
                    str(t / "pref_rescore2"), rescore_mode=1,
                    filter_hits=True, seq_id_thr=min_seq_id, cov_thr=cov,
                    cov_mode=cov_mode)

    # gapped alignment of the filtered candidates (the 'align' module
    # role; SearchDriver is byte-parity with it via the search suite)
    from .driver import SearchDriver
    db = mmseqsdb.read_seqdb(red)
    key_of_idx = [int(k) for k in db.keys]
    idx_of_key = {k: i for i, k in enumerate(key_of_idx)}
    seqs = [db.seq_bytes(i) for i in range(len(db))]
    pairs = []
    cand = mmseqsdb.read_db(str(t / "pref_rescore2"))
    for qkey, payload in cand:
        qi = idx_of_key[qkey]
        for ln in payload.decode().split("\n"):
            if ln:
                pairs.append((qi, idx_of_key[int(ln.split("\t")[0])]))
    import numpy as np
    p = Params(search_evalue_thr=1e-3, cov_thr=cov, cov_mode=cov_mode,
               seq_id_thr=0.0 if alignment_mode >= 3 else min_seq_id,
               aln_len_thr=0, comp_bias_correction=comp_bias,
               prefilter_mode="exhaustive")
    driver = SearchDriver(p, db, device=device)
    hits = driver.search(seqs, pair_generator=np.asarray(
        pairs, np.int64) if pairs else np.zeros((0, 2), np.int64))
    sids = None
    if alignment_mode >= 3 and len(hits):
        # SCORE_COV_SEQID: true identities from the traceback (the
        # backtrace column itself is not written); --min-seq-id applies
        # to these, not the estimate (Alignment.cpp:167-180,548-560)
        _bts, sids = driver.backtraces(hits, seqs)
        if min_seq_id > 0.0:
            keep = np.asarray(sids, np.float32) >= np.float32(min_seq_id)
            hits = hits[keep]
            sids = [s for s, k in zip(sids, keep) if k]
    payloads = {}
    for i, h in enumerate(hits):
        qkey = key_of_idx[int(h["orf_idx"])]
        hh = h.copy()
        hh["target_idx"] = key_of_idx[int(h["target_idx"])]
        payloads.setdefault(qkey, []).append(
            hit_to_matcher_line(hh, None,
                                sids[i] if sids is not None else None))
    aln_entries = [(qkey, "".join(payloads.get(qkey, [])).encode())
                   for qkey, _ in cand]
    mmseqsdb.write_db(str(t / "aln"), aln_entries,
                      mmseqsdb.DBTYPE_ALIGNMENT_RES)
    clust_db(red, str(t / "aln"), str(t / "clust"))
    mergeclusters(seq_db, out_db, [str(t / "pre_clust"),
                                   str(t / "clust")])
    return out_db
