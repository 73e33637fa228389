"""The tax slice: the k-mer slice's 3,000 targets under a synthetic NCBI
taxonomy, and tests/golden/tax_slice.json.

The contigs and targets are make_metagenome(1.6, 3000, 20260820)
(tools/make_metagenome.py), the k-mer slice. The taxonomy comes from
numpy.random.default_rng(TAX_SLICE["tax_seed"]):

- a tree under root (1) with the NCBI ranks superkingdom (2 Bacteria,
  2759 Eukaryota), phylum, class, order and family, two children a node,
  then 2-4 genera a family and 2-4 species a genus (about 300 species);
  12908 "unclassified sequences" (with three species-rank children) and
  28384 "other sequences" hang under root, so the default blacklist has
  both nodes;
- each implanted target (0-899) gets a species drawn uniformly; each
  homolog-family target (900-1499) a species of the same genus as its
  source protein's, other than the source's own (the source is the
  implanted target of the same length with the most identical residues);
  each decoy a species drawn uniformly;
- then, over a permutation of all targets: 2% are unmapped (no mapping
  line), 1% sit under 12908 (blacklisted), 1% map to an old id that
  merged.dmp redirects to the species they had.

tax_slice() writes the contigs (all, and the first `cut_contigs` of them),
the targets, nodes.dmp, names.dmp, merged.dmp and the target-to-taxid
mapping TSV. It uses numpy and the repository's tools/make_metagenome.py
only, so chip_smoke.py can build the slice on the card.

Run as a script, it runs metaeuk_tpu on the CPU, through its CLI, on the
cut: easy-predict against all 3,000 targets, then taxtocontig (approx-2bLCA,
-e 1.0, the CLI's defaults) on those predictions; it prints the counts, the
seconds, the sha256 of easy-predict's four outputs and of the two TSVs:

    python3 tests/golden/make_tax_slice.py > tests/golden/tax_slice.json

metaeuk_tpu_torch must give the same digests (chip_smoke.py phase 5f holds
the port to them on the card).
"""

import hashlib
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

COMMAND = "python3 tests/golden/make_tax_slice.py"
SUFFIXES = ("fas", "codon.fas", "headersMap.tsv", "gff")
TAX_SLICE = dict(mbp=1.6, targets=3000, seed=20260820, tax_seed=20261017,
                 unmapped=0.02, blacklisted=0.01, merged=0.01,
                 cut_contigs=10, evalue=1.0, lca_mode="approx-2blca")
# (rank, children a node: a fixed count, or the inclusive range drawn)
TREE = [("phylum", 2), ("class", 2), ("order", 2), ("family", 2),
        ("genus", (2, 4)), ("species", (2, 4))]
SUPERKINGDOMS = [(2, "Bacteria"), (2759, "Eukaryota")]
UNCLASSIFIED, OTHER = 12908, 28384
FIRST_ID, UNCLASSIFIED_IDS, MERGED_FROM = 100_000, 9_000_000, 8_000_000


def taxonomy_tree(rng):
    """{taxid: (parent, rank, name)} and the species ids under the two
    superkingdoms, in order."""
    nodes = {1: (1, "no rank", "root")}
    level = []
    for taxid, name in SUPERKINGDOMS:
        nodes[taxid] = (1, "superkingdom", name)
        level.append(taxid)
    next_id = FIRST_ID
    for rank, kids in TREE:
        below = []
        for parent in level:
            n = kids if isinstance(kids, int) else \
                int(rng.integers(kids[0], kids[1] + 1))
            for _ in range(n):
                nodes[next_id] = (parent, rank, f"{rank} {next_id}")
                below.append(next_id)
                next_id += 1
        level = below
    nodes[UNCLASSIFIED] = (1, "no rank", "unclassified sequences")
    nodes[OTHER] = (1, "no rank", "other sequences")
    for k in range(3):
        nodes[UNCLASSIFIED_IDS + k] = (UNCLASSIFIED, "species",
                                       f"unclassified species {k}")
    return nodes, level


def family_sources(proteins, n_implant, n_family):
    """The implanted source of each homolog-family target: of the
    implanted targets with its length, the one with the most identical
    residues."""
    by_len = {}
    for i in range(n_implant):
        by_len.setdefault(len(proteins[i][1]), []).append(i)
    src = []
    for i in range(n_implant, n_implant + n_family):
        seq = np.frombuffer(proteins[i][1], np.uint8)
        cands = by_len[len(seq)]
        same = [int((np.frombuffer(proteins[c][1], np.uint8) == seq).sum())
                for c in cands]
        src.append(cands[int(np.argmax(same))])
    return src


def target_taxa(cfg, proteins):
    """(nodes, {target index: taxid written to the mapping}, {old id: new
    id} of merged.dmp), as the module docstring says."""
    rng = np.random.default_rng(cfg["tax_seed"])
    nodes, species = taxonomy_tree(rng)
    n = len(proteins)
    n_implant, n_family = max(1, int(n * 0.3)), int(n * 0.2)
    genus_species = {}
    for s in species:
        genus_species.setdefault(nodes[s][0], []).append(s)
    taxa = np.zeros(n, np.int64)
    taxa[:n_implant] = rng.choice(species, n_implant)
    for i, src in enumerate(family_sources(proteins, n_implant, n_family)):
        sibs = [s for s in genus_species[nodes[int(taxa[src])][0]]
                if s != taxa[src]]
        taxa[n_implant + i] = sibs[int(rng.integers(0, len(sibs)))]
    taxa[n_implant + n_family:] = rng.choice(species,
                                             n - n_implant - n_family)
    perm = rng.permutation(n)
    n_un, n_bl, n_mg = (int(round(n * cfg[k])) for k in
                        ("unmapped", "blacklisted", "merged"))
    mapping = {int(i): int(taxa[i]) for i in range(n)}
    for i in perm[:n_un]:
        del mapping[int(i)]
    for i in perm[n_un:n_un + n_bl]:
        mapping[int(i)] = UNCLASSIFIED_IDS + int(rng.integers(0, 3))
    merged = {}
    for k, i in enumerate(perm[n_un + n_bl:n_un + n_bl + n_mg]):
        merged[MERGED_FROM + k] = mapping[int(i)]
        mapping[int(i)] = MERGED_FROM + k
    return nodes, mapping, merged


def write_taxonomy(td, nodes, mapping, merged, proteins):
    """nodes.dmp, names.dmp, merged.dmp and mapping.tsv under td."""
    with open(td / "nodes.dmp", "w") as f:
        for taxid, (parent, rank, _) in nodes.items():
            f.write(f"{taxid}\t|\t{parent}\t|\t{rank}\t|\t\t|\n")
    with open(td / "names.dmp", "w") as f:
        for taxid, (_, _, name) in nodes.items():
            f.write(f"{taxid}\t|\t{name}\t|\t\t|\tscientific name\t|\n")
    with open(td / "merged.dmp", "w") as f:
        for old, new in merged.items():
            f.write(f"{old}\t|\t{new}\t|\n")
    with open(td / "mapping.tsv", "w") as f:
        for i, taxid in sorted(mapping.items()):
            f.write(f"{proteins[i][0]}\t{taxid}\n")


def tax_slice(cfg, td):
    """Writes the slice under td: c.fna (all contigs), cut.fna (the first
    cfg["cut_contigs"]), t.faa, nodes.dmp, names.dmp, merged.dmp and
    mapping.tsv; returns {name: path} of them."""
    from tools.make_metagenome import make_metagenome, write_fasta

    td = pathlib.Path(td)
    contigs, proteins = make_metagenome(cfg["mbp"], cfg["targets"],
                                        cfg["seed"])
    write_fasta(td / "c.fna", contigs)
    write_fasta(td / "cut.fna", contigs[:cfg["cut_contigs"]])
    write_fasta(td / "t.faa", proteins)
    write_taxonomy(td, *target_taxa(cfg, proteins), proteins)
    return {k: td / f for k, f in (
        ("contigs", "c.fna"), ("cut", "cut.fna"), ("targets", "t.faa"),
        ("nodes", "nodes.dmp"), ("names", "names.dmp"),
        ("merged", "merged.dmp"), ("mapping", "mapping.tsv"))}


def taxtocontig_args(cfg, paths, preds, out_base, contigs):
    """The taxtocontig command line on easy-predict's outputs `preds`
    against the slice's targets and taxonomy (both packages' CLI)."""
    return ["taxtocontig", f"{preds}.fas", f"{preds}.headersMap.tsv",
            str(paths["targets"]), str(paths["mapping"]),
            str(paths["names"]), str(paths["nodes"]), str(out_base),
            "--merged-dmp", str(paths["merged"]), "--contigs", str(contigs),
            "--lca-mode", cfg["lca_mode"], "-e", str(cfg["evalue"])]


def sha256(path):
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


def tsv_digests(out_base):
    return {s: sha256(f"{out_base}_{s}.tsv")
            for s in ("tax_per_pred", "tax_per_contig")}


def main():
    import contextlib
    import jax
    jax.config.update("jax_platforms", "cpu")
    from metaeuk_tpu import cli
    from metaeuk_tpu.tax import workflow

    out = {"command": COMMAND, "input": TAX_SLICE}
    # the CLI's own lines go to stderr: stdout holds the JSON only
    with tempfile.TemporaryDirectory() as td, \
            contextlib.redirect_stdout(sys.stderr):
        td = pathlib.Path(td)
        paths = tax_slice(TAX_SLICE, td)
        cut = [ln for ln in paths["cut"].read_bytes().splitlines()
               if not ln.startswith(b">")]
        t0 = time.perf_counter()
        cli.main(["easy-predict", str(paths["cut"]), str(paths["targets"]),
                  str(td / "pred")])
        t1 = time.perf_counter()
        n_hits = []
        search = workflow.SearchDriver.search

        def counted(self, *a, **kw):
            hits = search(self, *a, **kw)
            n_hits.append(len(hits))
            return hits
        workflow.SearchDriver.search = counted
        cli.main(taxtocontig_args(TAX_SLICE, paths, td / "pred",
                                  td / "tax", paths["cut"]))
        t2 = time.perf_counter()
        n_pred = sum(1 for _ in open(f"{td / 'pred'}.headersMap.tsv"))
        taxa = [ln.split("\t")[-3] for ln in
                open(f"{td / 'tax'}_tax_per_pred.tsv")]
        out["cut"] = {"contigs": TAX_SLICE["cut_contigs"],
                      "nt": sum(len(s) for s in cut)}
        out["jax_cpu_seconds"] = {"easy_predict": round(t1 - t0, 1),
                                  "taxtocontig": round(t2 - t1, 1)}
        out["counts"] = {
            "predictions": n_pred, "pairs": n_pred * TAX_SLICE["targets"],
            "assigned": sum(t != "0" for t in taxa),
            "mapped_targets": sum(1 for _ in open(paths["mapping"])),
            "merged_ids": sum(1 for _ in open(paths["merged"])),
            "hits": sum(n_hits)}
        out["easy_predict"] = {s: sha256(f"{td / 'pred'}.{s}")
                               for s in SUFFIXES}
        out["taxtocontig"] = tsv_digests(td / "tax")
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
