"""Greedy set-cover clustering over search results.

The role of the reference's clustering engine (clustering/
ClusteringAlgorithms.cpp setCover, :213-278): symmetrize the hit graph,
then repeatedly pick the sequence with the largest remaining neighborhood
as a representative and assign its uncovered neighbors to it (members keep
the best-scoring representative). Functionally equivalent; the reference's
internal tie ordering (cluster-size buckets) is matched by (size desc,
key asc).

Counterpart of metaeuk_tpu/pipeline/cluster.py on the port's
SearchDriver: cluster_db takes a `device` keyword (default cuda; cpu runs
the kernels' plain versions); set_cover_cluster runs on the host only.
"""

import numpy as np


def set_cover_cluster(n, edges):
    """edges: (m, 2) int array of directed hits (query, target).

    Returns assignment array: cluster representative per node.
    """
    adj = [set() for _ in range(n)]
    for q, t in edges:
        if q != t:
            adj[q].add(t)
            adj[t].add(q)  # AlignmentSymmetry: symmetrized graph
    sizes = np.array([len(a) + 1 for a in adj], np.int64)
    alive = np.ones(n, bool)
    assigned = np.full(n, -1, np.int64)
    # (size desc, key asc) processing order, recomputed lazily via heap
    import heapq
    heap = [(-sizes[i], i) for i in range(n)]
    heapq.heapify(heap)
    while heap:
        negsize, rep = heapq.heappop(heap)
        if not alive[rep]:
            continue
        cur = len([x for x in adj[rep] if alive[x]]) + 1
        if cur != -negsize:
            heapq.heappush(heap, (-cur, rep))
            continue
        alive[rep] = False
        assigned[rep] = rep
        for m in adj[rep]:
            if alive[m]:
                alive[m] = False
                assigned[m] = rep
    assigned[assigned < 0] = np.flatnonzero(assigned < 0)
    return assigned


def cluster_db(params, seq_db, min_seq_id=0.0, cov_thr=0.8, evalue=1e-3,
               device="cuda"):
    """All-vs-all search + set-cover; returns {rep_idx: [member_idx...]};
    the search on `device`."""
    import dataclasses
    from ..search.driver import SearchDriver

    p = dataclasses.replace(params, search_evalue_thr=evalue,
                            seq_id_thr=min_seq_id, aln_len_thr=0)
    driver = SearchDriver(p, seq_db, device=device)
    seqs = [seq_db.seq_bytes(i) for i in range(len(seq_db))]
    hits = driver.search(seqs)
    # coverage filter (bidirectional, cov mode 0)
    q_cov = (hits["q_end"] - hits["q_start"] + 1) / hits["q_len"]
    t_cov = (hits["t_end"] - hits["t_start"] + 1) / hits["t_len"]
    ok = (q_cov >= cov_thr) & (t_cov >= cov_thr)
    hits = hits[ok]
    edges = np.stack([hits["orf_idx"], hits["target_idx"]], axis=1)
    assigned = set_cover_cluster(len(seq_db), edges)
    clusters = {}
    for i, rep in enumerate(assigned):
        clusters.setdefault(int(rep), []).append(i)
    return clusters
