# Copy of metaeuk_tpu/pipeline/groups.py; it differs from its original only in this note.
"""groupstoacc: rewrite the rep->member cluster map with accessions.

Port of src/exonpredictor/groupstoacc.cpp:16-108 — each cluster row
becomes "repT|contig|strand|repLow<TAB>memT|contig|strand|memLow".
"""


def groups_to_acc_lines(cluster_rows, contig_acc, target_accs):
    out = []
    for rep_t, rep_s, rep_low, mem_t, mem_s, mem_low in cluster_rows:
        if rep_s != mem_s:
            raise AssertionError("representative/member strand mismatch")
        strand = "+" if rep_s == 1 else "-"
        out.append(f"{target_accs[rep_t]}|{contig_acc}|{strand}|{rep_low}\t"
                   f"{target_accs[mem_t]}|{contig_acc}|{strand}|{mem_low}\n")
    return "".join(out)
