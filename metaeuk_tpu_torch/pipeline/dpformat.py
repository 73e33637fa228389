# Copy of metaeuk_tpu/pipeline/dpformat.py; only the imports differ.
"""DP-format (19-column) serialization of predictions.

Byte-exact port of Prediction::predictionToBuffer + PotentialExon::
exonToBuffer (src/commons/PredictionParser.h:97-163, 368-396): one line
per exon — 7 prediction columns then 12 exon columns — the stage-boundary
format between collectoptimalset, reduceredundancy and unitesetstofasta.
"""


def exon_columns(exon):
    """The 12 exon columns (exonToBuffer)."""
    return "\t".join([
        str(exon.exon_key),
        str(exon.bit_score),
        exon.seq_id_text,
        exon.evalue_text,
        str(exon.target_match_start),
        str(exon.target_match_end),
        str(exon.target_len),
        str(exon.contig_start),
        str(exon.contig_end),
        str(exon.nucleotide_len),
        str(exon.contig_start_before_trim),
        str(exon.contig_end_before_trim),
    ])


def prediction_lines(pred):
    """One 19-column line per exon (predictionToBuffer)."""
    head = "\t".join([
        str(pred.target_key),
        str(pred.strand),
        str(pred.total_bitscore),
        pred.combined_evalue_text,
        str(pred.num_exons),
        str(pred.low_contig_coord),
        str(pred.high_contig_coord),
    ])
    return "".join(f"{head}\t{exon_columns(e)}\n" for e in pred.exons)


def predictions_payload(preds):
    """The per-contig DB entry payload for a list of predictions."""
    return "".join(prediction_lines(p) for p in preds).encode()


def cluster_rows_payload(rows):
    """predictionClusterToBuffer lines (PredictionParser.h:398-423)."""
    return "".join(
        f"{rep_id}\t{strand}\t{rep_low}\t{t}\t{s2}\t{low}\n"
        for rep_id, strand, rep_low, t, s2, low in rows).encode()
