# Copy of metaeuk_tpu/pipeline/percontig.py; it differs from its original only in this note.
"""Standalone resultspercontig / collectoptimalset commands.

The easy-predict pipeline fuses these stages in memory
(pipeline/predict.py); these DB-level entry points replicate the
reference's expert commands byte-for-byte so the stage artifacts can be
produced, inspected, and resumed independently:

- resultspercontig (src/exonpredictor/resultspercontig.cpp): swap the
  fragment-vs-target search results to contig keys, joining each hit
  with the fragment's location on its contig (from the ORF header), as
  20-column lines "<orfToTarget 10 cols>\\t<orfToContig 10 cols>".
- collectoptimalset (src/exonpredictor/collectoptimalset.cpp): per
  contig, group the 20-column lines by target (assumed ascending), run
  the exon-chaining DP per strand, and serialize predictions in the
  19-column DP format (PredictionParser.h predictionToBuffer).
"""

import numpy as np

from ..io import mmseqsdb
from ..ops.chain import make_potential_exon, collect_optimal_sets, PLUS
from ..params import Params
from .dbtools2 import parse_aln_record, aln_record_to_line
from .dbtools2 import parse_orf_location
from .dpformat import predictions_payload
from .predict import format_seq_id


def resultspercontig(contigs_db, fragments_db, aln_db, out_db):
    """resultspercontig.cpp:34-220. fragments_db: the ORF DB whose _h
    headers carry the contig locations (Orf::parseOrfHeader)."""
    aln = dict(mmseqsdb.read_db(aln_db))
    if not aln:
        max_orf_key = -1
    else:
        max_orf_key = max(aln)  # DBReader::getLastKey
    contig_len = {}
    with open(f"{contigs_db}.index") as f:
        for ln in f:
            c = ln.split("\t")
            contig_len[int(c[0])] = int(c[2]) - 2

    # contig -> orf keys ascending; ORFs with keys past the alignment
    # DB's last key are never scanned (the reference's orfLookup loop
    # runs to alnDbr.getLastKey(), resultspercontig.cpp:72-91)
    contig_orfs = {}
    for orf_key, payload in sorted(mmseqsdb.read_db(f"{fragments_db}_h")):
        if orf_key > max_orf_key:
            continue
        c = payload.decode().split()
        contig_orfs.setdefault(int(c[0]), []).append(
            (orf_key, parse_orf_location(c[1])))

    out = []
    for contig_key in sorted(contig_len):
        results = []
        for orf_key, (frm, to) in contig_orfs.get(contig_key, []):
            if orf_key not in aln:
                continue
            orf_len = max(frm, to) - min(frm, to) + 1
            # Orf::getFromDatabase re-serialized without backtrace
            orf_to_contig = dict(
                dbKey=orf_key, score=1, seqId=1.0, eval=0.0,
                qStart=0, qEnd=orf_len - 1, qLen=orf_len,
                dbStart=frm, dbEnd=to, dbLen=contig_len[contig_key])
            for line in aln[orf_key].decode().split("\n"):
                if line:
                    results.append((parse_aln_record(line), orf_to_contig))
        # stable sort by (target key, orf key), resultspercontig.cpp:17-32
        results.sort(key=lambda r: (r[0]["dbKey"], r[1]["dbKey"]))
        ss = "".join(
            aln_record_to_line(o2t)[:-1] + "\t" + aln_record_to_line(o2c)
            for o2t, o2c in results)
        out.append((contig_key, ss.encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES)
    return out_db


def _exon_from_20cols(cols):
    """PotentialExon::setByAln (PredictionParser.h:15-65) from the
    20-column text; seqId/evalue re-serialized the way exonToBuffer
    will emit them (float truncation / %.3E)."""
    return make_potential_exon(
        orf_key=int(cols[10]),
        target_key=int(cols[0]),
        bit_score=int(cols[1]),
        seq_id_text=format_seq_id(np.float32(float(cols[2]))),
        evalue_text="%.3E" % float(cols[3]),
        orf_prot_start=int(cols[4]),
        orf_prot_end=int(cols[5]),
        target_match_start=int(cols[7]),
        target_match_end=int(cols[8]),
        target_len=int(cols[9]),
        contig_start_before_trim=int(cols[17]),
        contig_end_before_trim=int(cols[18]))


def collectoptimalset(contig_res_db, targets_db, out_db, params=None):
    """collectoptimalset.cpp:223-424."""
    p = params or Params()
    # getAminoAcidDBSize from the target index (DBReader.cpp:589-597)
    with open(f"{targets_db}.index") as f:
        lens = [int(ln.split("\t")[2]) for ln in f]
    if mmseqsdb.read_dbtype(targets_db) == mmseqsdb.DBTYPE_HMM_PROFILE:
        tot_aas = sum(lens) // 25 - len(lens)
    else:
        tot_aas = sum(lens) - 2 * len(lens)

    out = []
    for contig_key, payload in mmseqsdb.read_db(contig_res_db):
        groups = []
        cur_target = None
        plus_exons, minus_exons = [], []
        for line in payload.decode().split("\n"):
            if not line:
                continue
            cols = line.split("\t")
            if len(cols) != 20:
                raise ValueError("expected 20 columns in contig result DB")
            exon = _exon_from_20cols(cols)
            if cur_target is None:
                cur_target = exon.target_key
            if exon.target_key != cur_target:
                if exon.target_key < cur_target:
                    raise ValueError("targets must be sorted ascending")
                groups.append((cur_target, plus_exons, minus_exons))
                cur_target = exon.target_key
                plus_exons, minus_exons = [], []
            (plus_exons if exon.strand == PLUS else minus_exons).append(exon)
        if cur_target is not None:
            groups.append((cur_target, plus_exons, minus_exons))
        preds = collect_optimal_sets(groups, tot_aas, p)
        out.append((contig_key, predictions_payload(preds)))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_GENERIC)
    return out_db
