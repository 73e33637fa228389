# Copy of metaeuk_tpu/search/alignbykmer.py; it differs from its original only in this note.
"""alignbykmer: fast k-mer-chain alignment of prefilter candidates.

Port of lib/mmseqs/src/util/alignbykmer.cpp (protein path): shared
spaced 4-mers (seed {1,1,1,0,1}, Sequence.h spaced_seed_4) anchor
same-diagonal "stretches"; a chaining DP picks a consistent stretch
path; a 1-D transition DP refines the boundary between consecutive
stretches; ungapped extension fixes the outer start/end; the backtrace
is M over stretches plus I/D runs between them.

Parity quirks replicated from the reference:
- the k-mer index is truncated to 16 bits (``unsigned short kmerIdx``,
  alignbykmer.cpp:226; 21^4 > 65535, so distinct k-mers alias),
- the chain DP "no containment" check compares the current stretch's
  j_start against the previous stretch's *i_end* (alignbykmer.cpp:311),
- the gap transition cost ADDS gapOpen + (prev.i_end -
  curr.i_start)*gapExtend, a negative span (alignbykmer.cpp:313),
- the outer start/end extension shares one maxScore accumulator
  between the start and end loops (alignbykmer.cpp:395-416),
- per-thread scratch (stretch vector, chain DP rows, transition score
  array) is reused across pairs without reinitialisation; when a pair
  yields no stretch (``kmerPosSize <= 1`` or isolated diagonals) the
  traceback walks the PREVIOUS pair's DP state (alignbykmer.cpp:300-340
  reads uninitialised rows when stretcheSize == 0) — emulated with
  persistent scratch state so the byte output matches.
"""

import numpy as np

from ..data.submat import AA2NUM, BLOSUM62_SCORES
from ..io import mmseqsdb
from ..pipeline.alnformat import compress_backtrace, matcher_seq_id_text
from .evalue import EvalueComputation
from .lcaalign import has_coverage

_SPACED_OFFS_4 = (0, 1, 2, 4)   # spaced_seed_4 {1,1,1,0,1}, Sequence.h:19
_PATTERN_SIZE_4 = 5


def _kmer_hits(qlookup, tenc):
    """Target k-mer scan: positions whose (16-bit-truncated) spaced
    4-mer index appears in the query lookup (alignbykmer.cpp:225-240)."""
    L = len(tenc)
    n = L - _PATTERN_SIZE_4 + 1
    if n <= 0:
        return []
    e = tenc.astype(np.int64)
    idx = (e[0:n] + e[1:n + 1] * 21 + e[2:n + 2] * 441 +
           e[4:n + 4] * 9261) & 0xFFFF
    pos_i = qlookup[idx]
    js = np.nonzero(pos_i != 0xFFFF)[0]
    out = []
    for j in js:
        i = int(pos_i[j])
        out.append(((i - j) & 0xFFFF, i, int(j)))
    return out


def _build_stretches(kmer_pos, scratch):
    """Same-diagonal stretch grouping (alignbykmer.cpp:241-299):
    isolated diagonals are skipped; monotonic (i,j) growth extends the
    bounding region; a region closes when the diagonal changes."""
    stretches = scratch["stretches"]
    n_str = 0
    if len(kmer_pos) > 1:
        kmer_pos.sort()
        prev_diag = 0xFFFFFFFF
        prev_i = prev_j = 0
        rmin_i, rmax_i, rmin_j, rmax_j, rcnt = 0xFFFF, 0, 0xFFFF, 0, 0
        n = len(kmer_pos)
        for k in range(n):
            _, i, j = kmer_pos[k]
            curr_diag = (i - j) & 0xFFFFFFFF
            next_diag = ((kmer_pos[k + 1][1] - kmer_pos[k + 1][2])
                         & 0xFFFFFFFF) if k < n - 1 else 0xFFFFFFFF
            if curr_diag != next_diag and curr_diag != prev_diag:
                continue
            if (next_diag == curr_diag or prev_diag == curr_diag) \
                    and prev_i <= i and prev_j <= j:
                rmin_i = min(rmin_i, i)
                rmax_i = max(rmax_i, i)
                rmin_j = min(rmin_j, j)
                rmax_j = max(rmax_j, j)
                rcnt += 1
            prev_diag, prev_i, prev_j = curr_diag, i, j
            if next_diag != curr_diag or k == n - 1:
                if n_str < len(stretches):
                    stretches[n_str] = [rmin_i, rmax_i, rmin_j, rmax_j,
                                        rcnt]
                else:
                    stretches.append([rmin_i, rmax_i, rmin_j, rmax_j,
                                      rcnt])
                n_str += 1
                rmin_i, rmax_i, rmin_j, rmax_j, rcnt = \
                    0xFFFF, 0, 0xFFFF, 0, 0
                prev_i = prev_j = 0
    return n_str


def _chain_and_trace(n_str, scratch, gap_open, gap_extend, kmer_size=4):
    """Stretch chaining DP + traceback (alignbykmer.cpp:300-340).
    Operates on the persistent scratch so n_str == 0 replays the
    previous pair's rows exactly like the reference's stale reads."""
    stretches = scratch["stretches"]
    dp = scratch["dp"]
    stretches[:n_str] = sorted(stretches[:n_str],
                               key=lambda s: (s[0], -s[1]))
    for sid in range(n_str):
        if sid < len(dp):
            dp[sid] = [sid, stretches[sid][4]]
        else:
            dp.append([sid, stretches[sid][4]])
    best_score = 0
    best_last = 0
    for cur in range(n_str):
        for prev in range(cur):
            if stretches[cur][0] > stretches[prev][1] and \
                    stretches[cur][2] > stretches[prev][1]:
                dist = gap_open + \
                    (stretches[prev][1] - stretches[cur][0]) * gap_extend
                cand = dp[prev][1] + dist + \
                    stretches[cur][4] * kmer_size * 2
                if cand > dp[cur][1]:
                    dp[cur][0] = prev
                    dp[cur][1] = cand
        if dp[cur][1] > best_score:
            best_last = cur
            best_score = dp[cur][1]
    path = []
    cur = best_last
    guard = 0
    while cur < len(dp) and dp[cur][0] != cur and guard <= len(dp):
        path.append(list(stretches[cur]) if cur < len(stretches)
                    else [0xFFFF, 0, 0xFFFF, 0, 0])
        cur = dp[cur][0]
        guard += 1
    path.append(list(stretches[cur]) if cur < len(stretches)
                else [0xFFFF, 0, 0xFFFF, 0, 0])
    return path


def _refine_transitions(path, qbuf, tbuf, scratch):
    """1-D DP for the optimal hand-over point between consecutive
    stretches (alignbykmer.cpp:341-392)."""
    scores = scratch["scores"]
    sub = BLOSUM62_SCORES
    for st in range(len(path) - 1, 0, -1):
        pos = 0
        score = 0
        i, j = path[st][1], path[st][3]
        while i < path[st - 1][0] and j < path[st - 1][2]:
            score += int(sub[qbuf[i], tbuf[j]])
            if pos < len(scores):
                scores[pos] = score
            else:
                scores.append(score)
            pos += 1
            i += 1
            j += 1
        max_score = 0
        max_pos = 0
        max_rev = 0
        rev = 0
        if pos < len(scores):
            scores[pos] = 0
        else:
            scores.append(0)
        score = 0
        i, j = path[st - 1][0], path[st - 1][2]
        while i > path[st][1] and j > path[st][3]:
            score += int(sub[qbuf[i], tbuf[j]])
            if scores[pos] + score > max_score:
                max_score = scores[pos] + score
                max_pos = pos
                max_rev = rev
            rev += 1
            pos -= 1
            i -= 1
            j -= 1
        path[st - 1][0] -= max_rev
        path[st - 1][2] -= max_rev
        path[st][1] += max_pos
        path[st][3] += max_pos


def _extend_ends(path, qbuf, tbuf, q_len, t_len):
    """Ungapped outer extension; maxScore is shared between start and
    end loops (alignbykmer.cpp:394-417)."""
    sub = BLOSUM62_SCORES
    max_score = 0
    score = 0
    i, j = path[-1][0], path[-1][2]
    while i > -1 and j > -1:
        score += int(sub[qbuf[i], tbuf[j]])
        if score > max_score:
            path[-1][0] = i
            path[-1][2] = j
        i -= 1
        j -= 1
    score = 0
    i, j = path[0][1], path[0][3]
    while i < q_len and j < t_len:
        score += int(sub[qbuf[i], tbuf[j]])
        if score > max_score:
            path[0][1] = i
            path[0][3] = j
        i += 1
        j += 1


def _emit(path, qbuf, tbuf, gap_open, gap_extend):
    """Backtrace + raw score + identities (alignbykmer.cpp:423-466).
    'M' covers [i_start, i_end) per stretch; the inter-stretch gap is I
    (query gap) when the next stretch starts where this one ends on the
    query, D otherwise."""
    sub = BLOSUM62_SCORES
    bt = []
    ids = 0
    score = 0
    for st in range(len(path) - 1, -1, -1):
        i, j = path[st][0], path[st][2]
        while i < path[st][1]:
            bt.append("M")
            ids += int(qbuf[i] == tbuf[j])
            score += int(sub[qbuf[i], tbuf[j]])
            i += 1
            j += 1
        if st > 0:
            score -= gap_open
            if path[st - 1][0] == path[st][1]:
                for _ in range(path[st][3], path[st - 1][2]):
                    bt.append("I")
                    score -= gap_extend
            else:
                for _ in range(path[st][1], path[st - 1][0]):
                    bt.append("D")
                    score -= gap_extend
    return "".join(bt), ids, score


def _compute_cov(start, end, length):
    """SmithWaterman::computeCov (StripedSmithWaterman.cpp:1671-1673)."""
    return (min(length, max(start, end)) - min(start, end) + 1) \
        / float(length)


def alignbykmer_db(query_db, target_db, result_db, out_db, evalue=1e-3,
                   cov=0.0, cov_mode=0, min_seq_id=0.0, gap_open=11,
                   gap_extend=1, max_seq_len=65536, compressed=False):
    """alignbykmer.cpp main loop (protein DBs)."""
    qseqs = {k: p.rstrip(b"\x00").rstrip(b"\n")
             for k, p in mmseqsdb.read_db(query_db)}
    tseqs = {k: p.rstrip(b"\x00").rstrip(b"\n")
             for k, p in mmseqsdb.read_db(target_db)}
    same_db = query_db == target_db
    t_res_count = sum(len(s) for s in tseqs.values())
    evaluer = EvalueComputation(t_res_count)

    qlookup = np.full(65536, 0xFFFF, dtype=np.uint16)
    # persistent per-"thread" scratch, reused across pairs like the
    # reference's heap arrays (stale state is part of the contract)
    scratch = {"stretches": [], "dp": [], "scores": []}
    qbuf = np.zeros(max_seq_len, dtype=np.uint8)
    tbuf = np.zeros(max_seq_len, dtype=np.uint8)

    out = []
    for qkey, payload in mmseqsdb.read_db(result_db):
        qseq = qseqs[qkey]
        qenc = AA2NUM[np.frombuffer(qseq, dtype=np.uint8)]
        q_len = len(qenc)
        qbuf[:q_len] = qenc
        n = q_len - _PATTERN_SIZE_4 + 1
        used = None
        if n > 0:
            e = qbuf[:q_len].astype(np.int64)
            idx = (e[0:n] + e[1:n + 1] * 21 + e[2:n + 2] * 441 +
                   e[4:n + 4] * 9261) & 0xFFFF
            # first occurrence wins (queryPosLookup, alignbykmer.cpp:200)
            rev = idx[::-1]
            qlookup[rev] = np.arange(n - 1, -1, -1, dtype=np.uint16)
            used = np.unique(idx)
        rows = []
        for ln in payload.decode().split("\n"):
            if not ln:
                continue
            tkey = int(ln.split("\t", 1)[0].split(" ", 1)[0])
            tseq = tseqs[tkey]
            tenc = AA2NUM[np.frombuffer(tseq, dtype=np.uint8)]
            t_len = len(tenc)
            tbuf[:t_len] = tenc
            is_identity = same_db and qkey == tkey

            kmer_pos = _kmer_hits(qlookup, tenc)
            n_str = _build_stretches(kmer_pos, scratch)
            path = _chain_and_trace(n_str, scratch, gap_open, gap_extend)
            _refine_transitions(path, qbuf, tbuf, scratch)
            _extend_ends(path, qbuf, tbuf, q_len, t_len)
            bt, ids, score = _emit(path, qbuf, tbuf, gap_open, gap_extend)

            q_cov = _compute_cov(path[-1][0], path[0][1], q_len)
            t_cov = _compute_cov(path[-1][2], path[0][3], t_len)
            aln_len = len(bt)
            seq_id = ids / aln_len if aln_len else 0.0
            bit = int(float(evaluer.compute_bit_score(score)) + 0.5)
            ev = float(evaluer.compute_evalue(score, q_len))
            ok = has_coverage(cov, cov_mode, q_cov, t_cov) and \
                np.float32(seq_id) >= np.float32(min_seq_id) - \
                np.finfo(np.float32).eps and ev <= evalue
            if is_identity or ok:
                rows.append(f"{tkey}\t{bit}\t"
                            f"{matcher_seq_id_text(seq_id)}\t"
                            f"{'%.3E' % ev}\t{path[-1][0]}\t{path[0][1]}"
                            f"\t{q_len}\t{path[-1][2]}\t{path[0][3]}\t"
                            f"{t_len}\t{compress_backtrace(bt)}\n")
        out.append((qkey, "".join(rows).encode()))
        if used is not None:
            qlookup[used] = 0xFFFF
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES,
                      compressed=compressed)
    return out_db
