"""Cascaded clustering workflow + easy-cluster/easy-linclust.

Port of lib/mmseqs/src/workflow/Cluster.cpp (protein cascaded branch of
data/workflow/cascaded_clustering.sh) and EasyCluster.cpp /
easycluster.sh. The cascade: linclust redundancy pre-step, then
clusterSteps rounds of prefilter -> align -> set-cover clust over the
shrinking representative set, merged by mergeclusters.

Automagic parameters (Cluster.cpp:22-105): sensitivity from --min-seq-id
(<=0.3 -> 6, >0.8 -> 1, else 1+(0.7-seqId)*10), steps from sensitivity
(<=2 -> 1 else 3), comp-bias off + min-ungapped-score 60 at
seqId >= 0.7. Step 0 runs the count-mode prefilter (-s 1 for multi-step,
--diag-score 0, no comp-bias, min-ungapped 0, Cluster.cpp:195-199);
later steps ramp sensitivity 1 + (target-1)/(steps-1)*step with the
diagonal-scoring prefilter.

Counterpart of metaeuk_tpu/pipeline/clusterwf.py on the port's drivers:
cluster_workflow, easy_cluster, pickconsensusrep and clusterupdate take a
`device` keyword (default cuda; cpu runs the kernels' plain versions).
Every gapped alignment goes through SearchDriver (linclust's, each cascade
step's align_db, pickconsensusrep's recomputed cluster alignments and
clusterupdate's search), pickconsensusrep's profile-vs-member step through
ProfileQueryAligner.
"""

import os
import shutil

from ..io import mmseqsdb


def _auto_sensitivity(seq_id):
    if seq_id <= 0.3:
        return 6.0
    if seq_id > 0.8:
        return 1.0
    return 1.0 + (1.0 * (0.7 - seq_id) * 10)


def _copy_headers(src_db, dst_db):
    for suf in ("_h", "_h.index", "_h.dbtype"):
        if os.path.exists(f"{src_db}{suf}"):
            shutil.copy(f"{src_db}{suf}", f"{dst_db}{suf}")


def cluster_workflow(seq_db, out_db, tmp_dir, min_seq_id=0.0, cov=0.8,
                     cov_mode=0, evalue=0.001, sensitivity=None,
                     steps=None, max_seqs=20, device="cuda"):
    """mmseqs cluster (cascaded; Cluster.cpp + cascaded_clustering.sh); the
    alignment on `device`."""
    from ..search.align_module import align_db
    from ..search.kmermatcher import linclust_exact
    from ..search.searchdb import prefilter_db
    from .clust import clust_db, mergeclusters
    from .dbtools import createsubdb

    os.makedirs(tmp_dir, exist_ok=True)
    t = lambda *p: os.path.join(tmp_dir, *p)  # noqa: E731

    # setClusterAutomagicParameters
    comp_bias = True
    min_diag = 15
    if min_seq_id >= 0.7:
        comp_bias = False
        min_diag = 60
    if sensitivity is None:
        sensitivity = _auto_sensitivity(min_seq_id)
    if steps is None:
        steps = 1 if sensitivity <= 2.0 else 3

    # linclust redundancy pre-step (LINCLUST_PAR: the cluster-level
    # seqId/cov thresholds, alignment mode 3)
    clu_red = t("clu_redundancy")
    if not os.path.exists(f"{clu_red}.dbtype"):
        # setWorkflowDefaults sets spacedKmer=true, which reaches
        # kmermatcher through LINCLUST_PAR (Cluster.cpp:15, 185-192)
        linclust_exact(seq_db, clu_red, t("linclust"),
                       min_seq_id=min_seq_id, cov=cov, cov_mode=cov_mode,
                       alignment_mode=3, spaced=True, comp_bias=comp_bias,
                       device=device)
    red = t("input_step_redundancy")
    if not os.path.exists(f"{red}.dbtype"):
        with open(f"{clu_red}.index") as f:
            order = [int(ln.split("\t")[0]) for ln in f]
        createsubdb(order, seq_db, red)
        _copy_headers(seq_db, red)

    inp = red
    clusterings = [clu_red]
    for step in range(steps):
        pref = t(f"pref_step{step}")
        if step == 0:
            # count-mode prefilter (Cluster.cpp:195-199)
            s0 = sensitivity if steps == 1 else 1.0
            if not os.path.exists(f"{pref}.dbtype"):
                prefilter_db(inp, inp, pref, sensitivity=s0,
                             max_seqs=max_seqs, min_ungapped_score=0,
                             comp_bias_correction=False,
                             diagonal_scoring=False,
                             cov=cov, cov_mode=cov_mode)
            step_comp_bias = False
        else:
            s = 1.0 + (sensitivity - 1.0) / (steps - 1) * step
            if not os.path.exists(f"{pref}.dbtype"):
                prefilter_db(inp, inp, pref, sensitivity=s,
                             max_seqs=max_seqs,
                             min_ungapped_score=min_diag,
                             comp_bias_correction=True,
                             cov=cov, cov_mode=cov_mode)
            step_comp_bias = True
        aln = t(f"aln_step{step}")
        if not os.path.exists(f"{aln}.dbtype"):
            align_db(inp, inp, pref, aln, evalue=evalue,
                     min_seq_id=min_seq_id, cov=cov, cov_mode=cov_mode,
                     comp_bias_corr=step_comp_bias, alignment_mode=3,
                     device=device)
        clu = t(f"clu_step{step}")
        if not os.path.exists(f"{clu}.dbtype"):
            clust_db(inp, aln, clu)
        clusterings.append(clu)

        if step < steps - 1:
            nxt = t(f"input_step{step + 1}")
            if not os.path.exists(f"{nxt}.dbtype"):
                with open(f"{clu}.index") as f:
                    order = [int(ln.split("\t")[0]) for ln in f]
                createsubdb(order, inp, nxt)
                _copy_headers(inp, nxt)
            inp = nxt

    mergeclusters(seq_db, out_db, clusterings)
    return out_db


def easy_cluster(query, out_prefix, tmp_dir, min_seq_id=0.0, cov=0.8,
                 cov_mode=0, evalue=0.001, use_linclust=False,
                 linclust_min_seq_id=0.9, device="cuda"):
    """easy-cluster / easy-linclust (easycluster.sh): createdb ->
    cluster module -> cluster.tsv + rep_seq.fasta + all_seqs.fasta; the
    alignment on `device`."""
    from ..search.kmermatcher import linclust_exact
    from ..search.searchdb import _ensure_seqdb
    from .dbtools2 import createseqfiledb, result2flat
    from .dbtools3 import result2repseq

    os.makedirs(tmp_dir, exist_ok=True)
    inp = _ensure_seqdb(query, os.path.join(tmp_dir, "input"))
    clu = os.path.join(tmp_dir, "clu")
    if not os.path.exists(f"{clu}.dbtype"):
        if use_linclust:
            # setLinclustWorkflowDefaults: seqId 0.9, alignment mode 2
            linclust_exact(inp, clu, os.path.join(tmp_dir, "clu_tmp"),
                           min_seq_id=linclust_min_seq_id, cov=cov,
                           cov_mode=cov_mode, device=device)
        else:
            cluster_workflow(inp, clu, os.path.join(tmp_dir, "clu_tmp"),
                             min_seq_id=min_seq_id, cov=cov,
                             cov_mode=cov_mode, evalue=evalue,
                             device=device)

    # cluster.tsv (createtsv input input clu)
    db = mmseqsdb.read_seqdb(inp)
    acc = {int(k): db.accession(i) for i, k in enumerate(db.keys)}
    with open(f"{out_prefix}_cluster.tsv", "w") as f:
        for key, payload in mmseqsdb.read_db(clu):
            for ln in payload.decode().splitlines():
                f.write(f"{acc[key]}\t{acc[int(ln)]}\n")

    # rep_seq.fasta (result2repseq + result2flat --use-fasta-header)
    clu_rep = os.path.join(tmp_dir, "clu_rep")
    result2repseq(inp, clu, clu_rep)
    result2flat(inp, inp, clu_rep, f"{out_prefix}_rep_seq.fasta",
                use_header=True)

    # all_seqs.fasta (createseqfiledb + result2flat)
    clu_seqs = os.path.join(tmp_dir, "clu_seqs")
    createseqfiledb(inp, clu, clu_seqs)
    result2flat(inp, inp, clu_seqs, f"{out_prefix}_all_seqs.fasta")
    return out_prefix


def pickconsensusrep(seq_db, clu_db, out_db, tmp_dir, device="cuda"):
    """pickconsensusrep.sh: result2msa (allow-deletion) -> msa2profile
    (--match-mode 1) -> profile-vs-member align -> per cluster pick the
    highest-scoring member as the new representative (clusters without
    alignments keep themselves; PickConsensusRep.cpp + the awk joins); the
    alignments on `device`."""
    from ..io.profiledb import ProfileDB
    from ..params import Params
    from ..search.profile_align import ProfileQueryAligner
    from .msa2profile import msa_db_to_profile_db
    from .result2msa import result2msa_db

    os.makedirs(tmp_dir, exist_ok=True)
    t = lambda *p: os.path.join(tmp_dir, *p)  # noqa: E731
    # result2msa over a cluster DB recomputes the alignments with full
    # backtraces (result2msa.cpp recompute path, no thresholds); build
    # that alignment DB explicitly in cluster-line order
    import numpy as np

    from ..pipeline.alnformat import hit_to_matcher_line
    from ..search.driver import SearchDriver
    from ..search.lcaalign import _raw_results

    sdb = mmseqsdb.read_seqdb(seq_db)
    s_by_key = {int(k): i for i, k in enumerate(sdb.keys)}
    clu = mmseqsdb.read_db(clu_db)
    from ..params import Params
    p_perm = Params(search_evalue_thr=float("inf"), seq_id_thr=0.0,
                    cov_thr=0.0, aln_len_thr=0,
                    prefilter_mode="exhaustive")
    driver = SearchDriver(p_perm, sdb, device=device)
    sseqs = [sdb.seq_bytes(i) for i in range(len(sdb))]
    pairs = []
    members_per_clu = []
    for ckey, payload in clu:
        members = [int(ln) for ln in payload.decode().splitlines() if ln]
        members_per_clu.append((int(ckey), members))
        for m in members:
            pairs.append((s_by_key[int(ckey)], s_by_key[m]))
    raw = _raw_results(driver, sseqs,
                       np.asarray(sorted(set(pairs)), np.int64))
    order_hits = []
    for ckey, members in members_per_clu:
        for m in members:
            order_hits.append(raw[(s_by_key[ckey], s_by_key[m])])
    hits_arr = np.array(order_hits) if order_hits else         np.zeros(0, dtype=list(raw.values())[0].dtype if raw else None)
    bts, sids = driver.backtraces(hits_arr, sseqs)
    aln_entries = []
    i = 0
    for ckey, members in members_per_clu:
        lines = []
        for m in members:
            h = hits_arr[i].copy()
            h["target_idx"] = m
            lines.append(hit_to_matcher_line(h, bts[i], sids[i]))
            i += 1
        aln_entries.append((ckey, "".join(lines).encode()))
    aln_db = t("clu_aln")
    mmseqsdb.write_db(aln_db, aln_entries, 5)
    msa = t("msa")
    result2msa_db(seq_db, seq_db, aln_db, msa, allow_deletion=True)
    prof = t("profile")
    # msa2profile: --match-mode 1 (PickConsensusRep.cpp:18) and the
    # reference-wide --filter-msa 1 default
    msa_db_to_profile_db(
        [(k, p.decode()) for k, p in mmseqsdb.read_db(msa)], prof,
        match_mode=1, filter_msa=True)

    profiles = ProfileDB.from_db(prof)
    sdb = mmseqsdb.read_seqdb(seq_db)
    s_by_key = {int(k): i for i, k in enumerate(sdb.keys)}
    p_by_key = {int(k): i for i, k in enumerate(profiles.keys)}
    clu = mmseqsdb.read_db(clu_db)
    pairs = []
    for ckey, payload in clu:
        if ckey not in p_by_key:
            continue
        for ln in payload.decode().splitlines():
            if ln:
                pairs.append((p_by_key[ckey], s_by_key[int(ln)]))
    aligner = ProfileQueryAligner(Params(aln_len_thr=0), profiles, sdb,
                                  device=device)
    hits = aligner.search(pairs, eval_thr=1e-3)

    # rep_mapping.txt: best[cluster] seeded to 1, rep seeded to itself
    best = {int(k): 1.0 for k, _p in clu}
    rep = {int(k): int(k) for k, _p in clu}
    for h in hits:
        ckey = int(profiles.keys[int(h["orf_idx"])])
        score = float(h["bit_score"])
        if score > best.get(ckey, 1.0):
            best[ckey] = score
            rep[ckey] = int(sdb.keys[int(h["target_idx"])])
    # the reference's updated_clu awk compares the cluster key against an
    # UNINITIALIZED prev: awk coerces that first comparison to numeric, so
    # a leading cluster key 0 never triggers the new-cluster rule and a
    # singleton cluster 0 is dropped entirely (pickconsensusrep.sh:50-53)
    out = []
    prev_numeric_zero = True
    for ckey, payload in clu:
        new_rep = rep[int(ckey)]
        is_first_zero = prev_numeric_zero and int(ckey) == 0
        prev_numeric_zero = False
        lines = [] if is_first_zero else [f"{new_rep}\n"]
        for ln in payload.decode().splitlines():
            if ln and int(ln) != new_rep:
                lines.append(f"{int(ln)}\n")
        if lines:
            out.append((new_rep, "".join(lines).encode()))
    mmseqsdb.write_db(out_db, out, 6, sort_index=True)
    return out_db


def clusterupdate(old_db, new_db, old_clu, new_map_db, new_clu, tmp_dir,
                  recover_deleted=False, device="cuda"):
    """clusterupdate (ClusterUpdate.cpp + update_clustering.sh): diff the
    sequence DBs, re-key the new DB to keep old keys stable (new
    sequences get ids above max(old,new)), drop or recover clusters of
    removed sequences, map new sequences onto old representatives by
    search (alignment mode 3), and cluster the remainder separately; the
    alignment on `device`."""
    from ..search.searchdb import search_db
    from .dbtools import createsubdb, mergedbs
    from .dbtools2 import concatdbs, renamedbkeys, swapdb
    from .dbtools3 import diffseqdbs, result2repseq
    from .filterdb import filterdb

    os.makedirs(tmp_dir, exist_ok=True)
    t = lambda *p: os.path.join(tmp_dir, *p)  # noqa: E731

    removed, mapping, newseqs = t("removedSeqs"), t("mappingSeqs"), \
        t("newSeqs")
    diffseqdbs(old_db, new_db, removed, mapping, newseqs)
    if os.path.getsize(mapping) == 0:
        raise RuntimeError("no common sequences between the DBs "
                           "(update_clustering.sh warns and exits here)")

    old_clu_eff = old_clu
    removed_members = []
    has_removed = os.path.getsize(removed) > 0
    if has_removed and not recover_deleted:
        removed_keys = [int(ln.split()[0]) for ln in open(removed)]
        # members of clusters whose representative was removed, minus the
        # removed sequences themselves
        createsubdb(removed_keys, old_clu, t("REMOVEDMEMBERS"))
        filterdb(t("REMOVEDMEMBERS"), t("REMOVEDMEMBERS.withoutDeleted"),
                 filter_file=removed, positive_filter=True)
        for _k, payload in mmseqsdb.read_db(
                t("REMOVEDMEMBERS.withoutDeleted")):
            for ln in payload.decode().splitlines():
                if ln:
                    removed_members.append(int(ln.split()[0]))
        kept_keys = [int(ln.split()[0]) for ln in open(mapping)]
        createsubdb(kept_keys, old_clu, t("OLCLUST.withoutDeletedKeys"))
        filterdb(t("OLCLUST.withoutDeletedKeys"),
                 t("OLCLUST.withoutDeleted"), filter_file=removed,
                 positive_filter=True)
        old_clu_eff = t("OLCLUST.withoutDeleted")

    # re-key the new DB: kept sequences take their OLD keys, novel ones
    # get ids above max(old,new)
    max_id = 0
    for idx in (f"{old_db}.index", f"{new_db}.index"):
        for ln in open(idx):
            max_id = max(max_id, int(ln.split("\t")[0]))
    new_mapping_rows = []
    for ln in open(mapping):
        o, n = ln.split()
        new_mapping_rows.append((int(n), int(o)))
    new_ids = []
    nxt = max_id + 1
    for ln in open(newseqs):
        new_mapping_rows.append((int(ln.split()[0]), nxt))
        new_ids.append(nxt)
        nxt += 1
    with open(t("newMappingSeqs"), "w") as f:
        for a, b in new_mapping_rows:
            f.write(f"{a}\t{b}\n")
    renamedbkeys(t("newMappingSeqs"), new_db, new_map_db)

    new_seq_keys = removed_members + new_ids
    createsubdb(new_seq_keys, new_map_db, t("NEWDB.newSeqs"))
    _copy_headers(new_map_db, t("NEWDB.newSeqs"))
    result2repseq(old_db, old_clu_eff, t("OLDDB.repSeq"))
    _copy_headers(old_db, t("OLDDB.repSeq"))
    hits = t("newSeqsHits")
    if not os.path.exists(f"{hits}.dbtype"):
        # SEARCH_PAR forces --max-accept 1 (ClusterUpdate.cpp:70-74)
        search_db(t("NEWDB.newSeqs"), t("OLDDB.repSeq"), hits,
                  t("search"), alignment_mode=3, max_accept=1,
                  device=device)
    swapdb(hits, t("newSeqsHits.swapped.all"))
    has_hits = any(int(ln.split("\t")[2]) > 1
                   for ln in open(t("newSeqsHits.swapped.all.index")))
    updated_clust = old_clu_eff
    if has_hits:
        filterdb(t("newSeqsHits.swapped.all"), t("newSeqsHits.swapped"),
                 trim_to_one_column=True, filter_regex="^.*$")
        mergedbs(old_clu_eff, t("updatedClust"),
                 [old_clu_eff, t("newSeqsHits.swapped")])
        updated_clust = t("updatedClust")

    no_hit = [int(ln.split("\t")[0]) for ln in open(f"{hits}.index")
              if int(ln.split("\t")[2]) == 1]
    if no_hit:
        createsubdb(no_hit, new_map_db, t("toBeClusteredSeparately"))
        _copy_headers(new_map_db, t("toBeClusteredSeparately"))
        cluster_workflow(t("toBeClusteredSeparately"), t("newClusters"),
                         t("cluster"), device=device)
        concatdbs(updated_clust, t("newClusters"), new_clu,
                  preserve_keys_b=True)
    else:
        from .dbtools2 import cpdb
        cpdb(updated_clust, new_clu)
    return new_clu
