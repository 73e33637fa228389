"""taxonomy + easy-taxonomy workflows (mmseqs-level).

Counterpart of metaeuk_tpu/tax/taxworkflow.py: the same module with a
`device` keyword (default cuda; cpu runs the kernels' plain versions) on
taxonomy_workflow and easy_taxonomy, passed on to the port's lcaalign_db
and score_only_align_db.

Port of src/workflow/Taxonomy.cpp + data/workflow/taxonomy.sh (protein
query branch) and workflow/EasyTaxonomy.cpp + easytaxonomy.sh:

taxonomy: search (prefilter at the taxonomy defaults -s 2 -e 1
--max-accept 30 --max-rejected 5 --alignment-mode 1; Taxonomy.cpp:13-24)
with the align module replaced by lcaalign for the default approx-2bLCA
mode (Search.cpp:316-318) or plain score-only align + filterdb
--beats-first for --lca-mode 4 (top-hit, taxonomy.sh:34-41), then lca
(taxonomy.sh:43-58); --tax-output-mode 0 lca only / 1 alignment only /
2 both (result + result_aln).

easy-taxonomy: createdb -> taxonomy (output mode BOTH) -> createtsv
(_lca.tsv) -> taxonomyreport (_report) -> swapresults -> summarizealis ->
addtaxonomy -> createtsv (_tophit_report) -> convertalis (_tophit_aln)
(easytaxonomy.sh:11-66).

The contig-query branch (taxpercontig.sh: 6-frame ORF extraction + ORF
filter + per-contig aggregatetaxweights) is covered by the MetaEuk-level
taxtocontig workflow (tax/workflow.py).
"""

import dataclasses
import os

import numpy as np

from ..io import mmseqsdb
from ..params import Params


def taxonomy_workflow(query_db, target_db, out_db, tmp_dir,
                      lca_mode=3, tax_output_mode=0, sensitivity=2.0,
                      evalue=1.0, max_accept=30, max_rejected=5,
                      max_seqs=300, lca_ranks="", tax_lineage=0,
                      blacklist=None, vote_mode=1, majority_thr=0.5,
                      params=None, device="cuda"):
    """mmseqs taxonomy (protein query). lca_mode: 3 approx-2bLCA
    (default), 4 top-hit."""
    from ..search.lcaalign import lcaalign_db, score_only_align_db
    from ..search.searchdb import prefilter_db as _prefilter_db
    from . import mmtax

    os.makedirs(tmp_dir, exist_ok=True)
    p = params or Params()
    p = dataclasses.replace(p, sensitivity=sensitivity)

    pref = os.path.join(tmp_dir, "pref")
    if not os.path.exists(f"{pref}.dbtype"):
        _prefilter_db(query_db, target_db, pref, sensitivity=sensitivity,
                      max_seqs=max_seqs,
                      comp_bias_correction=p.comp_bias_correction)

    first = os.path.join(tmp_dir, "first")
    if not os.path.exists(f"{first}.dbtype"):
        if lca_mode == 4:  # top-hit: plain score-only align
            score_only_align_db(query_db, target_db, pref, first,
                                evalue=evalue, max_accept=max_accept,
                                max_rejected=max_rejected, params=p,
                                device=device)
        else:  # approx-2bLCA: ALIGN_MODULE=lcaalign (Search.cpp:316-318)
            lcaalign_db(query_db, target_db, pref, first, evalue=evalue,
                        max_accept=max_accept, max_rejected=max_rejected,
                        params=p, device=device)

    lca_in = first
    if lca_mode == 4:
        # filterdb --beats-first --filter-column 4 --comparison-operator le
        # (taxonomy.sh:34-41)
        from ..pipeline.filterdb import filterdb
        top1 = os.path.join(tmp_dir, "top1")
        if not os.path.exists(f"{top1}.dbtype"):
            filterdb(first, top1, filter_column=4, beats_first=True,
                     comp_operator="le")
        lca_in = top1

    kwargs = dict(lca_ranks=lca_ranks, tax_lineage=tax_lineage,
                  vote_mode=vote_mode, majority_thr=majority_thr)
    if blacklist is not None:
        kwargs["blacklist"] = blacklist
    if tax_output_mode == 0:
        mmtax.lca_db(target_db, lca_in, out_db, **kwargs)
    elif tax_output_mode == 2:
        mmtax.lca_db(target_db, lca_in, out_db, **kwargs)
        from ..pipeline.dbtools2 import mvdb
        mvdb(lca_in, f"{out_db}_aln")
    else:  # alignment only
        from ..pipeline.dbtools2 import mvdb
        mvdb(lca_in, out_db)
    return out_db


def summarizealis_db(in_db, out_db, compressed=False):
    """summarizealis (util/summarizealis.cpp): per query, hit count,
    unique coverage, total coverage, average seq-id over the alignments
    sorted by query start (compareHitByPos)."""
    entries = mmseqsdb.read_db(in_db)
    out = []
    for key, payload in entries:
        recs = []
        for ln in payload.decode().splitlines():
            if not ln:
                continue
            cols = ln.split("\t")
            recs.append((int(cols[4]), int(cols[5]), int(cols[6]),
                         float(cols[2])))  # qStart, qEnd, qLen, seqId
        if not recs:
            out.append((key, b""))
            continue
        recs.sort(key=lambda r: min(r[0], r[1]))  # stable by qStart
        res_cov = np.float32(0)
        avg_id = np.float32(0)
        seq_len = 1
        uniq = np.float32(0)
        prev_qend = -1
        for qs, qe, ql, sid in recs:
            seq_len = ql
            q0, q1 = min(qs, qe), max(qs, qe)
            uniq += np.float32(max(prev_qend, q1) - max(prev_qend, q0))
            res_cov += np.float32(q1 - q0)
            avg_id += np.float32(sid)
            prev_qend = max(prev_qend, qe)
        avg_id = np.float32(avg_id / np.float32(len(recs)))
        res_cov = np.float32(res_cov / np.float32(seq_len))
        uniq = np.float32(uniq / np.float32(seq_len))
        line = "%d\t%.3f\t%.3f\t%.3f\n" % (len(recs), uniq, res_cov, avg_id)
        out.append((key, line.encode()))
    mmseqsdb.write_db(out_db, out, 12, compressed=compressed)
    return out_db


def easy_taxonomy(query_fasta, target_db, out_prefix, tmp_dir,
                  sensitivity=2.0, evalue=1.0, lca_mode=3, lca_ranks="",
                  tax_lineage=0, majority_thr=0.5, vote_mode=1,
                  params=None, device="cuda"):
    """mmseqs easy-taxonomy (easytaxonomy.sh)."""
    from ..io.seqdb import SeqDB, DBTYPE_AA
    from ..pipeline.dbtools2 import swapresults
    from . import mmtax

    os.makedirs(tmp_dir, exist_ok=True)
    query_db = os.path.join(tmp_dir, "query")
    if not os.path.exists(f"{query_db}.dbtype"):
        if os.path.exists(f"{query_fasta}.dbtype"):
            query_db = query_fasta
        else:
            mmseqsdb.write_seqdb(query_db,
                                 SeqDB.from_fasta(query_fasta, DBTYPE_AA))

    result = os.path.join(tmp_dir, "result")
    if not os.path.exists(f"{result}.dbtype"):
        taxonomy_workflow(query_db, target_db, result,
                          os.path.join(tmp_dir, "taxonomy_tmp"),
                          lca_mode=lca_mode, tax_output_mode=2,
                          sensitivity=sensitivity, evalue=evalue,
                          lca_ranks=lca_ranks, tax_lineage=tax_lineage,
                          majority_thr=majority_thr, vote_mode=vote_mode,
                          params=params, device=device)

    # _lca.tsv (createtsv query result)
    qdb = mmseqsdb.read_seqdb(query_db)
    acc = {int(k): qdb.accession(i) for i, k in enumerate(qdb.keys)}
    with open(f"{out_prefix}_lca.tsv", "w") as f:
        for key, payload in mmseqsdb.read_db(result):
            for ln in payload.decode().splitlines():
                f.write(f"{acc.get(key, str(key))}\t{ln}\n")

    # _report
    mmtax.taxonomyreport_db(target_db, result, f"{out_prefix}_report")

    # top-hit chain: swapresults -> summarizealis -> addtaxonomy ->
    # createtsv + convertalis
    aln = f"{result}_aln"
    swapped = os.path.join(tmp_dir, "result_aln_swapped")
    swapresults(query_db, target_db, aln, swapped)
    summed = os.path.join(tmp_dir, "result_aln_swapped_sum")
    summarizealis_db(swapped, summed)
    summed_tax = os.path.join(tmp_dir, "result_aln_swapped_sum_tax")
    mmtax.addtaxonomy_db(target_db, summed, summed_tax, pick_id_from=1,
                         lca_ranks=lca_ranks, tax_lineage=tax_lineage)
    tdb = mmseqsdb.read_seqdb(target_db)
    tacc = {int(k): tdb.accession(i) for i, k in enumerate(tdb.keys)}
    with open(f"{out_prefix}_tophit_report", "w") as f:
        for key, payload in mmseqsdb.read_db(summed_tax):
            for ln in payload.decode().splitlines():
                f.write(f"{tacc.get(key, str(key))}\t{ln}\n")

    from ..pipeline.dbtools2 import parse_aln_record, _lines
    with open(f"{out_prefix}_tophit_aln", "w") as f:
        for key, payload in mmseqsdb.read_db(aln):
            for ln in _lines(payload):
                r = parse_aln_record(ln)
                # convertalignments.cpp:445-449: -1 starts (SCORE_ONLY)
                # clamp to 0 for alnLen/mismatch but print raw+1
                adj_q = 0 if r["qStart"] == -1 else r["qStart"]
                adj_d = 0 if r["dbStart"] == -1 else r["dbStart"]
                aln_len = max(abs(r["qEnd"] - adj_q),
                              abs(r["dbEnd"] - adj_d)) + 1
                best = np.float32(min(abs(r["qEnd"] - adj_q),
                                      abs(r["dbEnd"] - adj_d)))
                mismatch = int(best * (np.float32(1.0) -
                                       np.float32(r["seqId"])) +
                               np.float32(0.5))
                f.write(f"{acc.get(key, str(key))}\t"
                        f"{tacc.get(r['dbKey'], str(r['dbKey']))}\t"
                        f"{r['seqId']:.3f}\t{aln_len}\t{mismatch}\t0\t"
                        f"{r['qStart'] + 1}\t{r['qEnd'] + 1}\t"
                        f"{r['dbStart'] + 1}\t{r['dbEnd'] + 1}\t"
                        f"{'%.3E' % r['eval']}\t{r['score']}\n")
    return out_prefix
