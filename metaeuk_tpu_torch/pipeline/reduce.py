# Copy of metaeuk_tpu/pipeline/reduce.py; only the imports differ.
"""Redundancy reduction over per-contig predictions.

Exact port of src/exonpredictor/reduceredundancy.cpp:

- clusterPredictions (:24-109): greedy single scan over predictions sorted
  by contig start; overlapping same-strand predictions sharing >=1 exon key
  join a cluster; representative = member with highest bitscore.
- excludeSameStrandOverlaps (:111-147): representatives sorted by E-value;
  any representative overlapping a better one is suppressed.
"""

from ..ops.chain import PLUS, Prediction


def _cmp_by_contig_start(pred):
    """comparePredictionsByContigStart (PredictionParser.h:314-336)."""
    return (pred.low_contig_coord, -pred.high_contig_coord,
            -pred.total_bitscore, pred.target_key)


def _cmp_by_evalue(pred):
    """comparePredictionsByEvalue (PredictionParser.h:339-351)."""
    return (pred.combined_evalue, pred.low_contig_coord)


def _cmp_by_target(pred):
    """comparePredictionsByTarget (PredictionParser.h:354-366): MINUS<PLUS."""
    return (pred.target_key, pred.strand)


def cluster_predictions(preds):
    """Greedy exon-sharing clustering; returns (reps, cluster_rows).

    cluster_rows: (rep_target_key, strand, rep_low_coord,
                   member_target_key, strand, member_low_coord) per member,
    in the reference's write order (writePredsClusters, :162-167).
    """
    preds = sorted(preds, key=_cmp_by_contig_start)
    clustered = [False] * len(preds)
    reps = []
    for i in range(len(preds)):
        if clustered[i]:
            continue
        final_id = preds[i].target_key
        final_low = preds[i].low_contig_coord
        max_score = preds[i].total_bitscore
        clustered[i] = True
        members = [i]
        exon_keys_i = {e.exon_key for e in preds[i].exons}
        for j in range(i + 1, len(preds)):
            if preds[j].low_contig_coord >= preds[i].high_contig_coord:
                break
            share = any(e.exon_key in exon_keys_i for e in preds[j].exons)
            if share and not clustered[j]:
                clustered[j] = True
                if preds[j].total_bitscore > max_score:
                    max_score = preds[j].total_bitscore
                    final_id = preds[j].target_key
                    final_low = preds[j].low_contig_coord
                members.append(j)
        n_put = 0
        for k in members:
            preds[k].cluster_id = final_id
            preds[k].cluster_low_coord = final_low
            if (preds[k].cluster_id == preds[k].target_key
                    and preds[k].cluster_low_coord == preds[k].low_contig_coord):
                reps.append(preds[k])
                n_put += 1
        if n_put != 1:
            raise AssertionError(f"expected exactly one representative, got {n_put}")
    rows = [(p.cluster_id, p.strand, p.cluster_low_coord,
             p.target_key, p.strand, p.low_contig_coord) for p in preds]
    return reps, rows


def exclude_same_strand_overlaps(reps):
    """Marks suppressed representatives (reduceredundancy.cpp:111-147)."""
    reps.sort(key=_cmp_by_evalue)
    assigned = [False] * len(reps)
    for i in range(len(reps)):
        if assigned[i]:
            continue
        assigned[i] = True
        reps[i].no_overlap_cluster_id = reps[i].target_key
        reps[i].no_overlap_cluster_low_coord = reps[i].low_contig_coord
        hi_i, lo_i = reps[i].high_contig_coord, reps[i].low_contig_coord
        for j in range(i + 1, len(reps)):
            hi_j, lo_j = reps[j].high_contig_coord, reps[j].low_contig_coord
            if ((hi_j < hi_i and hi_j > lo_i) or
                    (lo_j < hi_i and lo_j > lo_i) or
                    (hi_j < hi_i and lo_j > lo_i) or
                    (hi_j > hi_i and lo_j < lo_i)):
                assigned[j] = True
                reps[j].no_overlap_cluster_id = reps[i].target_key
                reps[j].no_overlap_cluster_low_coord = reps[i].no_overlap_cluster_low_coord


def reduce_redundancy(contig_preds, overlap_allowed=0):
    """Full per-contig reduction; returns (kept_predictions, cluster_rows).

    kept_predictions are representatives (overlap-suppressed unless
    overlap_allowed), sorted by (target_key, strand) as downstream
    unitesetstofasta expects (reduceredundancy.cpp:296-299).
    """
    plus = [p for p in contig_preds if p.strand == PLUS]
    minus = [p for p in contig_preds if p.strand != PLUS]
    reps_p, rows_p = cluster_predictions(plus)
    exclude_same_strand_overlaps(reps_p)
    reps_m, rows_m = cluster_predictions(minus)
    exclude_same_strand_overlaps(reps_m)
    reps = reps_p + reps_m
    reps.sort(key=_cmp_by_target)
    if not overlap_allowed:
        reps = [r for r in reps if r.no_overlap_cluster_id == r.target_key]
    return reps, rows_p + rows_m
