# Copy of metaeuk_tpu/pipeline/clust.py; it differs from its original only in this note.
"""clust: greedy set-cover clustering over result DBs, byte-exact.

Port of lib/mmseqs/src/clustering/ (Clustering.cpp, ClusteringAlgorithms
setCover mode, AlignmentSymmetry) for the default --cluster-mode 0
(set cover), needSET=false:

  - internal ids = sequences sorted by (entry length desc, id asc)
    (DBReader SORT_BY_LENGTH, DBReader.h:398-408)
  - per id: neighbor list from its result-DB lines in file order (empty
    entry -> self with score USHRT_MAX); prefilter scores = |column 1|,
    alignment scores = seqId*1000 (AlignmentSymmetry::readInData)
  - symmetrization appends missing back-links in (source id asc,
    within-source file order) with the forward score
    (findMissingLinks/addMissingLinks)
  - setCover greedy: bucket array over cluster sizes, largest set first
    (ties: largest internal id first), members reassigned when the new
    rep's edge score beats their best (ClusteringAlgorithms.cpp:213-277)
  - output: cluster DB keyed by representative, payload = rep key line +
    member key lines sorted (Clustering::writeData)
"""

import numpy as np

from ..io import mmseqsdb

USHRT_MAX = 0xFFFF
SHRT_MIN = -32768


def _read_edges(seq_db, result_db, score_mode):
    """Returns (keys_by_internal_id, elements, scores) with internal ids
    ordered by (entry_len desc, orig asc)."""
    with open(f"{seq_db}.index") as f:
        rows = [line.split("\t") for line in f]
    keys = [int(r[0]) for r in rows]
    lens = [int(r[2]) for r in rows]
    order = sorted(range(len(keys)), key=lambda i: (-lens[i], i))
    id_of_key = {}
    for internal, orig in enumerate(order):
        id_of_key[keys[orig]] = internal
    keys_sorted = [keys[orig] for orig in order]

    aln = dict(mmseqsdb.read_db(result_db))
    n = len(keys_sorted)
    elements = [[] for _ in range(n)]
    scores = [[] for _ in range(n)]
    for i, key in enumerate(keys_sorted):
        payload = aln.get(key, b"")
        lines = [ln for ln in payload.decode().split("\n") if ln]
        if not lines:
            elements[i].append(i)
            scores[i].append(USHRT_MAX)
            continue
        for ln in lines:
            cols = ln.split("\t")
            tid = id_of_key[int(cols[0])]
            elements[i].append(tid)
            if score_mode == "prefilter":
                sim = int(float(cols[1])) if "." in cols[1] else int(cols[1])
                # C short cast (wraparound) then abs
                # (AlignmentSymmetry.cpp:95-97)
                sim = ((sim & 0xFFFF) ^ 0x8000) - 0x8000
                scores[i].append(int(sim if sim > 0 else -sim) & 0xFFFF)
            else:
                scores[i].append(int(float(cols[2]) * 1000.0) & 0xFFFF)
    return keys_sorted, elements, scores


def _symmetrize(elements, scores):
    """findMissingLinks + addMissingLinks: append back-links with the
    forward score, in (source id asc, source-list order).  Membership is
    checked against the ORIGINAL lists only (the reference scans
    oldElementSize entries), so duplicate forward edges append duplicate
    back-links, matching addMissingLinks exactly."""
    n = len(elements)
    orig_sets = [set(e) for e in elements]
    orig_len = [len(e) for e in elements]
    for i in range(n):
        for pos in range(orig_len[i]):
            j = elements[i][pos]
            if i not in orig_sets[j]:
                elements[j].append(i)
                scores[j].append(scores[i][pos])
    return elements, scores


def _set_cover(elements, scores):
    """ClusteringAlgorithms::setCover with the exact bucket structure."""
    n = len(elements)
    clustersizes = [len(e) for e in elements]
    max_size = max(clustersizes) if clustersizes else 0

    # initClustersizes (ClusteringAlgorithms.cpp:157-189)
    abundance = [0] * (max_size + 1)
    for s in clustersizes:
        abundance[s] += 1
    borders = [0] * (max_size + 1)
    for s in range(1, max_size + 1):
        borders[s] = borders[s - 1] + abundance[s - 1]
    sorted_cs = [0] * (n + 1)
    pos_of = [0] * (n + 1)
    fill = [0] * (max_size + 1)
    for i in range(n):
        p = borders[clustersizes[i]] + fill[clustersizes[i]]
        sorted_cs[p] = i
        pos_of[i] = p
        fill[clustersizes[i]] += 1

    UINT_MAX = 0xFFFFFFFF
    assigned = [UINT_MAX] * n
    best = [SHRT_MIN] * n

    def remove_clustersize(cid):
        clustersizes[cid] = 0
        sorted_cs[pos_of[cid]] = UINT_MAX
        pos_of[cid] = UINT_MAX

    def decrease_clustersize(cid):
        oldp = pos_of[cid]
        newp = borders[clustersizes[cid]]
        swapid = sorted_cs[newp]
        if swapid != UINT_MAX:
            pos_of[swapid] = oldp
        sorted_cs[oldp] = swapid
        sorted_cs[newp] = cid
        pos_of[cid] = newp
        borders[clustersizes[cid]] += 1
        clustersizes[cid] -= 1

    for cl in range(n - 1, -1, -1):
        rep = sorted_cs[cl]
        if rep == UINT_MAX:
            continue
        remove_clustersize(rep)
        assigned[rep] = rep
        elems = elements[rep]
        for pos, e in enumerate(elems):
            sid = scores[rep][pos]
            # score compared as signed short vs best (short)
            sid_s = sid if sid < 32768 else sid - 65536
            if sid_s > best[e]:
                assigned[e] = rep
                best[e] = sid_s
            if e == rep:
                continue
            if clustersizes[e] < 1:
                continue
            remove_clustersize(e)
        for e in list(elems):
            if e == rep:
                clustersizes[e] = -1
                continue
            if clustersizes[e] < 0:
                continue
            clustersizes[e] = -1
            for e2 in elements[e]:
                if clustersizes[e2] == 1:
                    pass
                elif clustersizes[e2] > 0:
                    decrease_clustersize(e2)
    return assigned


def clust_db(seq_db, result_db, out_db):
    res_type = mmseqsdb.read_dbtype(result_db)
    score_mode = "prefilter" if res_type in (
        mmseqsdb.DBTYPE_PREFILTER_RES, 16) else "alignment"
    keys_sorted, elements, scores = _read_edges(seq_db, result_db,
                                                score_mode)
    elements, scores = _symmetrize(elements, scores)
    assigned = _set_cover(elements, scores)
    pairs = sorted((keys_sorted[assigned[i]], keys_sorted[i])
                   for i in range(len(keys_sorted)))
    out = []
    i = 0
    while i < len(pairs):
        rep = pairs[i][0]
        lines = [f"{rep}\n"]
        j = i
        while j < len(pairs) and pairs[j][0] == rep:
            if pairs[j][1] != rep:
                lines.append(f"{pairs[j][1]}\n")
            j += 1
        out.append((rep, "".join(lines).encode()))
        i = j
    # DBTYPE_CLUSTER_RES = 6
    mmseqsdb.write_db(out_db, out, 6)
    return out_db


def mergeclusters(seq_db, out_db, clusterings):
    """mergeclusters.cpp: splice cascaded clustering steps; output per
    non-empty representative the member key lines (the first step's
    payloads already lead with the rep key)."""
    with open(f"{seq_db}.index") as f:
        keys = [int(line.split("\t")[0]) for line in f]
    id_of_key = {k: i for i, k in enumerate(keys)}
    merged = [[] for _ in keys]
    first = dict(mmseqsdb.read_db(clusterings[0]))
    for key, payload in first.items():
        cid = id_of_key[key]
        for ln in payload.decode().split("\n"):
            if ln:
                merged[cid].append(id_of_key[int(ln)])
    for step_db in clusterings[1:]:
        for key, payload in mmseqsdb.read_db(step_db):
            cid = id_of_key[key]
            for ln in payload.decode().split("\n"):
                if not ln:
                    continue
                sid = id_of_key[int(ln)]
                if sid != cid:
                    merged[cid].extend(merged[sid])
                    merged[sid] = []
    out = []
    for i, key in enumerate(keys):
        if not merged[i]:
            continue
        out.append((key, "".join(f"{keys[m]}\n" for m in merged[i]).encode()))
    mmseqsdb.write_db(out_db, out, 6)
    return out_db
