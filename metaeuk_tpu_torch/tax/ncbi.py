# Copy of metaeuk_tpu/tax/ncbi.py; it differs from its original only in this note.
"""NCBI taxonomy: taxdump loading, LCA, weighted-majority voting.

Port of the reference's NcbiTaxonomy
(lib/mmseqs/src/taxonomy/NcbiTaxonomy.{h,cpp}): nodes/names/merged dmp
parsing, parent-pointer LCA (replacing the Euler-tour RMQ with level-walk
jumping — candidate sets are tiny), rank indexing (NcbiRanks,
NcbiTaxonomy.h:52-79), lineage strings, and the exact weightedMajorityLCA
voting algorithm (NcbiTaxonomy.cpp:639-760).
"""

import math

NCBI_RANKS = {
    "forma": 1, "varietas": 2, "subspecies": 3, "species": 4,
    "species subgroup": 5, "species group": 6, "subgenus": 7, "genus": 8,
    "subtribe": 9, "tribe": 10, "subfamily": 11, "family": 12,
    "superfamily": 13, "parvorder": 14, "infraorder": 15, "suborder": 16,
    "order": 17, "superorder": 18, "infraclass": 19, "subclass": 20,
    "class": 21, "superclass": 22, "subphylum": 23, "phylum": 24,
    "superphylum": 25, "subkingdom": 26, "kingdom": 27, "superkingdom": 28,
}
ROOT_RANK = 10000  # NcbiTaxonomy ROOT_RANK sentinel
ROOT_TAXID = 1
MAX_TAX_WEIGHT = 1000  # NcbiTaxonomy.cpp MAX_TAX_WEIGHT

# default blacklist (Parameters.cpp:2681)
DEFAULT_BLACKLIST = (12908, 28384)

AGG_TAX_UNIFORM = 0
AGG_TAX_MINUS_LOG_EVAL = 1
AGG_TAX_SCORE = 2


class WeightedTaxHit:
    """WeightedTaxHit (NcbiTaxonomy.cpp:615-637)."""

    def __init__(self, taxon, value, vote_mode):
        self.taxon = taxon
        if vote_mode == AGG_TAX_UNIFORM:
            self.weight = 1.0
        elif vote_mode == AGG_TAX_MINUS_LOG_EVAL:
            # the reference carries the E-value as a 32-bit float
            # (WeightedTaxHit(…, const float evalue, …)), so values below
            # ~1e-38 underflow to 0 and become MAX_TAX_WEIGHT
            import numpy as np
            v = float(np.float32(value))
            if v == float("inf") or (v != v):
                self.weight = v
            elif v > 0:
                self.weight = -math.log(v)
            else:
                self.weight = MAX_TAX_WEIGHT
        elif vote_mode == AGG_TAX_SCORE:
            self.weight = value
        else:
            raise ValueError(f"bad vote mode {vote_mode}")


class WeightedTaxResult:
    def __init__(self, taxon, assigned, unassigned, agree, percent):
        self.taxon = taxon
        self.assigned_seqs = assigned
        self.unassigned_seqs = unassigned
        self.seqs_agree = agree
        self.selected_percent = percent


class NcbiTaxonomy:
    def __init__(self, parent, rank, name, merged=None):
        """parent/rank/name: dicts taxid -> parent taxid / rank str / name."""
        self.parent = parent
        self.rank = rank
        self.name = name
        self.merged = merged or {}

    @classmethod
    def from_dumps(cls, names_dmp, nodes_dmp, merged_dmp=None):
        parent, rank, name, merged = {}, {}, {}, {}
        with open(nodes_dmp) as f:
            for line in f:
                cols = [c.strip() for c in line.split("|")]
                taxid, par, rnk = int(cols[0]), int(cols[1]), cols[2]
                parent[taxid] = par
                rank[taxid] = rnk
        with open(names_dmp) as f:
            for line in f:
                cols = [c.strip() for c in line.split("|")]
                if len(cols) > 3 and cols[3] == "scientific name":
                    name[int(cols[0])] = cols[1]
        if merged_dmp:
            with open(merged_dmp) as f:
                for line in f:
                    cols = [c.strip() for c in line.split("|")]
                    merged[int(cols[0])] = int(cols[1])
        return cls(parent, rank, name, merged)

    def resolve(self, taxid):
        if taxid in self.parent:
            return taxid
        return self.merged.get(taxid, 0)

    def node_exists(self, taxid):
        return self.resolve(taxid) != 0

    def lineage_ids(self, taxid):
        """taxid and all ancestors up to and including root."""
        out = []
        t = self.resolve(taxid)
        if t == 0:
            return out
        while True:
            out.append(t)
            p = self.parent[t]
            if p == t:
                break
            t = p
        return out

    def is_ancestor(self, ancestor, taxid):
        return ancestor in self.lineage_ids(taxid)

    def lca_pair(self, a, b):
        la = self.lineage_ids(a)
        lb = set(self.lineage_ids(b))
        for t in la:
            if t in lb:
                return t
        return 0

    def lca(self, taxa):
        """LCA of a list (NcbiTaxonomy::LCA semantics: ignores unknown)."""
        cur = 0
        for t in taxa:
            t = self.resolve(t)
            if t == 0:
                continue
            cur = t if cur == 0 else self.lca_pair(cur, t)
        return cur

    def find_rank_index(self, rank_str):
        return NCBI_RANKS.get(rank_str, -1)

    def at_ranks(self, taxid, ranks):
        """Names of ancestors at the requested ranks (AtRanks)."""
        lineage = self.lineage_ids(taxid)
        by_rank = {self.rank.get(t): t for t in lineage}
        out = []
        for r in ranks:
            t = by_rank.get(r)
            out.append(self.name.get(t, "") if t else "-")
        return out

    def tax_lineage(self, taxid, names=True):
        """Full lineage string root->taxid (taxLineage); skips "no rank"
        internal nodes except the node itself, like the reference with
        default settings simplified."""
        lineage = list(reversed(self.lineage_ids(taxid)))
        parts = []
        for t in lineage:
            rank = self.rank.get(t, "no rank")
            prefix = {"superkingdom": "d_", "kingdom": "k_", "phylum": "p_",
                      "class": "c_", "order": "o_", "family": "f_",
                      "genus": "g_", "species": "s_"}.get(rank, "-_")
            parts.append((prefix + self.name.get(t, "")) if names else str(t))
        return ";".join(parts)

    def weighted_majority_lca(self, set_taxa, majority_cutoff):
        """Exact port of weightedMajorityLCA (NcbiTaxonomy.cpp:639-760)."""
        counts = {}  # taxid -> [weight, is_candidate, child_taxon]
        assigned = 0
        unassigned = 0
        total_weight = 0.0
        for hit in set_taxa:
            tax = self.resolve(hit.taxon)
            if tax == 0:
                unassigned += 1
                continue
            w = hit.weight
            total_weight += w
            assigned += 1
            node = counts.get(tax)
            if node is not None:
                if node[2] != 0:
                    node[1] = True
                    node[2] = 0
                node[0] += w
            else:
                counts[tax] = [w, True, 0]
            curr = tax
            parent = self.parent[curr]
            while parent != curr:
                node = counts.get(parent)
                if node is not None:
                    if node[2] != curr:
                        node[1] = True
                        node[2] = curr
                    node[0] += w
                else:
                    counts[parent] = [w, False, curr]
                curr = parent
                parent = self.parent[curr]

        if total_weight == 0:
            return WeightedTaxResult(0, assigned, unassigned, 0, 0.0)

        selected = 0
        min_rank = 2 ** 31 - 1
        selected_percent = 0.0
        for taxid in sorted(counts):
            weight, is_cand, _child = counts[taxid]
            if not is_cand:
                continue
            percent = weight / total_weight
            if percent >= majority_cutoff:
                # min informative rank on the path to root
                curr = taxid
                curr_min_rank = ROOT_RANK
                parent = self.parent[curr]
                while parent != curr:
                    ri = self.find_rank_index(self.rank.get(curr, ""))
                    if ri > 0 and ri < curr_min_rank:
                        curr_min_rank = ri
                        break
                    curr = parent
                    parent = self.parent[curr]
                if curr_min_rank < min_rank or \
                        (curr_min_rank == min_rank and percent > selected_percent):
                    selected = taxid
                    min_rank = curr_min_rank
                    selected_percent = percent

        if selected == ROOT_TAXID:
            return WeightedTaxResult(selected, assigned, unassigned,
                                     assigned, selected_percent)
        if selected == 0:
            return WeightedTaxResult(0, assigned, unassigned, 0, selected_percent)
        agree = 0
        for hit in set_taxa:
            tax = self.resolve(hit.taxon)
            if tax != 0 and selected in self.lineage_ids(tax):
                agree += 1
        return WeightedTaxResult(selected, assigned, unassigned, agree,
                                 selected_percent)
