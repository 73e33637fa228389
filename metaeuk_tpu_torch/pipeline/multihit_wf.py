"""multihitdb / multihitsearch workflows.

Ports of lib/mmseqs/src/multihit/{MultiHitDb,MultiHitSearch}.cpp +
data/workflow/{multihitdb,multihitsearch}.sh (nucleotide branch):

multihitdb: createdb over N FASTA set files -> contig<->set TSV DBs from
the .lookup file numbers -> extractorfs -> translatenucs (the AA member
DB) -> orftocontig -> filterdb --trim-to-one-column -> filterdb
--mapping-file (member -> set) -> swapdb (set -> member) ->
result2stats --stat linecount (set sizes).

multihitsearch: search -> besthitperset -> mergeresultsbyset over the
query's _set_to_member DB.

Counterpart of metaeuk_tpu/pipeline/multihit_wf.py on the port's driver:
multihitsearch takes a `device` keyword (default cuda; cpu runs the
kernels' plain versions), and its search aligns through SearchDriver;
multihitdb is host-only and calls the port's CLI.
"""

import os
import subprocess


def multihitdb(fasta_files, out_db, tmp_dir, orf_min_length=30):
    from ..cli import main
    from ..pipeline.dbtools2 import swapdb
    from ..pipeline.dbtools3 import result2stats
    from ..pipeline.filterdb import filterdb  # noqa: F401

    os.makedirs(tmp_dir, exist_ok=True)
    nucl = f"{out_db}_nucl"
    if not os.path.exists(f"{nucl}.dbtype"):
        assert main(["createdb", *[str(f) for f in fasta_files],
                     nucl]) == 0

    # contig<->set TSVs from the lookup (awk '{print $1"\t"$3}' | sort)
    rows = []
    for ln in open(f"{nucl}.lookup"):
        c = ln.rstrip("\n").split("\t")
        rows.append((int(c[0]), int(c[2])))
    rows.sort()
    c2s_tsv = f"{out_db}_nucl_contig_to_set.tsv"
    with open(c2s_tsv, "w") as f:
        for contig, fileno in rows:
            f.write(f"{contig}\t{fileno}\n")
    s2c = sorted((fileno, contig) for contig, fileno in rows)
    with open(f"{out_db}_nucl_set_to_contig.tsv", "w") as f:
        for fileno, contig in s2c:
            f.write(f"{fileno}\t{contig}\n")
    assert main(["tsv2db", c2s_tsv, f"{out_db}_nucl_contig_to_set"]) == 0
    assert main(["tsv2db", f"{out_db}_nucl_set_to_contig.tsv",
                 f"{out_db}_nucl_set_to_contig"]) == 0

    orf = f"{out_db}_nucl_orf"
    if not os.path.exists(f"{orf}.dbtype"):
        assert main(["extractorfs", nucl, orf]) == 0
    if not os.path.exists(f"{out_db}.dbtype"):
        assert main(["translatenucs", orf, out_db]) == 0
    aligned = f"{out_db}_nucl_orf_aligned_to_contig"
    assert main(["orftocontig", nucl, orf, aligned]) == 0
    filterdb(aligned, f"{out_db}_nucl_orf_to_contig",
             trim_to_one_column=True, filter_regex="^.*$")
    filterdb(f"{out_db}_nucl_orf_to_contig", f"{out_db}_member_to_set",
             mapping_file=c2s_tsv)
    swapdb(f"{out_db}_member_to_set", f"{out_db}_set_to_member")
    result2stats(f"{out_db}_set_to_member", f"{out_db}_set_size",
                 stat="linecount")
    return out_db


def multihitsearch(query_db, target_db, out_db, tmp_dir,
                   sensitivity=5.7, evalue=1e-3, max_seqs=300,
                   simple_best_hit=True, device="cuda"):
    """search (aligned on `device`) -> besthitperset -> mergeresultsbyset."""
    from ..pipeline.dbtools5 import mergeresultsbyset
    from ..pipeline.multihit import besthitperset
    from ..search.searchdb import search_db

    os.makedirs(tmp_dir, exist_ok=True)
    result = os.path.join(tmp_dir, "result")
    if not os.path.exists(f"{result}.dbtype"):
        search_db(query_db, target_db, result,
                  os.path.join(tmp_dir, "search"),
                  sensitivity=sensitivity, evalue=evalue,
                  max_seqs=max_seqs, device=device)
    aggregate = os.path.join(tmp_dir, "aggregate")
    besthitperset(result, f"{target_db}_member_to_set",
                  f"{target_db}_set_size", aggregate,
                  simple_best_hit=simple_best_hit)
    mergeresultsbyset(f"{query_db}_set_to_member", aggregate, out_db)
    return out_db
