"""taxtocontig: taxonomy assignment for predictions and contigs.

Counterpart of metaeuk_tpu/tax/workflow.py: the same module on the port's
SearchDriver, with a `device` keyword (default cuda; cpu runs the kernels'
plain versions) on TaxonomyAssigner and TaxToContig.

Replaces the reference's taxtocontig workflow (data/taxtocontig.sh +
src/workflow/TaxToContig.cpp): search the predicted proteins against a
taxonomy-annotated target DB, assign a taxon per prediction (top-hit or
LCA over ties of the best E-value — the approx-2bLCA family of
lib/mmseqs/src/taxonomy/lca.cpp with default blacklist), then aggregate
per contig by weighted-majority voting (aggregatetaxweights,
lib/mmseqs/src/taxonomy/aggregatetax.cpp) with -log(E-value) weights.

Outputs mirror taxtocontig.sh: <base>_tax_per_pred.tsv and
<base>_tax_per_contig.tsv.
"""

import numpy as np

from ..search.driver import SearchDriver
from .ncbi import (AGG_TAX_MINUS_LOG_EVAL, DEFAULT_BLACKLIST, WeightedTaxHit)


def _round2(x):
    """SSTR(roundf(x*100)/100): round half away from zero at 2 decimals,
    printed %.3f (Util.cpp:668-670)."""
    import math
    v = math.floor(x * 100 + 0.5) if x >= 0 else -math.floor(-x * 100 + 0.5)
    return "%.3f" % (v / 100.0)


class TaxonomyAssigner:
    """Per-query taxon assignment against an annotated target DB."""

    def __init__(self, params, target_db, target_taxids, taxonomy,
                 blacklist=DEFAULT_BLACKLIST, device="cuda"):
        self.params = params
        self.driver = SearchDriver(params, target_db, device=device)
        self.target_taxids = np.asarray(target_taxids, dtype=np.int64)
        self.tax = taxonomy
        self.blacklist = [b for b in blacklist if taxonomy.node_exists(b)]

    def assign(self, query_seqs, mode="approx-2blca"):
        """Returns per query: (taxid, best_evalue) — taxid 0 if unassigned."""
        hits = self.driver.search(query_seqs)
        n = len(query_seqs)
        results = [(0, None)] * n
        if len(hits) == 0:
            return results
        for qi in np.unique(hits["orf_idx"]):
            sel = hits[hits["orf_idx"] == qi]  # compareHits order
            taxa = []
            best_eval = None
            for h in sel:
                taxon = int(self.target_taxids[h["target_idx"]])
                taxon = self.tax.resolve(taxon)
                if taxon == 0:
                    continue
                if any(self.tax.is_ancestor(b, taxon) for b in self.blacklist):
                    continue
                if best_eval is None:
                    # the reference reads the weight from the %.3E-serialized
                    # alignment record (aggregatetax.cpp:100)
                    best_eval = float("%.3E" % h["evalue"])
                if mode == "top-hit":
                    taxa.append(taxon)
                    break
                elif mode == "approx-2blca":
                    # hits whose E-value ties the best (filterdb --beats-first
                    # on the evalue column, workflow/taxonomy.sh:35-40);
                    # both sides are parsed from %.3E text like filterdb
                    if float("%.3E" % h["evalue"]) <= best_eval:
                        taxa.append(taxon)
                else:  # "lca": LCA over all accepted hits
                    taxa.append(taxon)
            if taxa:
                results[int(qi)] = (self.tax.lca(taxa), best_eval)
        return results


def tax_result_line(tax, taxid):
    """lca.cpp output columns: taxid, rank, name (lca.cpp:174-183)."""
    if taxid == 0:
        return "0\tno rank\tunclassified"
    return f"{taxid}\t{tax.rank.get(taxid, 'no rank')}\t{tax.name.get(taxid, '')}"


def aggregate_contig(tax, pred_results, majority_thr=0.5,
                     vote_mode=AGG_TAX_MINUS_LOG_EVAL):
    """aggregatetaxweights for one contig; returns the result line columns
    (aggregatetax.cpp:118-172)."""
    set_taxa = []
    for taxid, evalue in pred_results:
        if taxid == 0 or evalue is None:
            set_taxa.append(WeightedTaxHit(0, 1.0, 0))
        else:
            set_taxa.append(WeightedTaxHit(taxid, evalue, vote_mode))
    res = tax.weighted_majority_lca(set_taxa, majority_thr)
    total = res.assigned_seqs + res.unassigned_seqs
    if res.taxon == 0:
        head = "0\tno rank\tunclassified"
        return (f"{head}\t{total}\t{res.assigned_seqs}\t"
                f"{res.seqs_agree}\t{_round2(res.selected_percent)}")
    head = tax_result_line(tax, res.taxon)
    return (f"{head}\t{total}\t{res.assigned_seqs}\t"
            f"{res.seqs_agree}\t{_round2(res.selected_percent)}")


class TaxToContig:
    """Full taxtocontig: predictions FASTA + headersMap -> two TSVs."""

    def __init__(self, params, target_db, target_taxids, taxonomy,
                 device="cuda"):
        self.params = params
        self.assigner = TaxonomyAssigner(params, target_db, target_taxids,
                                         taxonomy, device=device)
        self.tax = taxonomy

    def run(self, preds_fasta, headers_map_tsv, out_base, mode="approx-2blca",
            contig_accessions=None):
        """contig_accessions: contig key -> accession (for the per-contig
        TSV keys, like createtsv over the contigs DB); keys used if None."""
        from ..io.fasta import read_fasta
        headers, seqs = [], []
        for h, s in read_fasta(preds_fasta):
            headers.append(h)
            seqs.append(s)
        # contig key per prediction from the headersMap (col 0)
        contig_keys = []
        with open(headers_map_tsv) as f:
            for line in f:
                contig_keys.append(int(line.split("\t", 1)[0]))
        assert len(contig_keys) == len(headers), "headersMap/pred mismatch"

        results = self.assigner.assign(seqs, mode=mode)
        with open(f"{out_base}_tax_per_pred.tsv", "w") as f:
            for header, (taxid, _ev) in zip(headers, results):
                f.write(f"{header}\t{tax_result_line(self.tax, taxid)}\n")

        per_contig = {}
        for ck, res in zip(contig_keys, results):
            per_contig.setdefault(ck, []).append(res)
        with open(f"{out_base}_tax_per_contig.tsv", "w") as f:
            for ck in sorted(per_contig):
                line = aggregate_contig(self.tax, per_contig[ck],
                                        self.params.majority_thr,
                                        self.params.vote_mode)
                acc = (contig_accessions.get(ck, str(ck))
                       if contig_accessions else str(ck))
                f.write(f"{acc}\t{line}\n")
        return out_base
