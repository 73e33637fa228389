# Copy of metaeuk_tpu/pipeline/output.py; only the imports differ.
"""Prediction materialization: FASTA / codon FASTA / headersMap / GFF.

Byte-parity port of src/exonpredictor/unitesetstofasta.cpp:

- exon joining with target-overlap trimming (:169-176) and minus-strand
  reverse complement (:17-23, :199-205)
- optional upstream ATG scan (scanForStartBeforeFirstExon, :37-113)
- MetaEuk header grammar (:130-206) incl. the C++ ostream double
  formatting of the combined E-value
- headersMap mimicking ORF headers (preparePredHeaderToInfo, :239-261)
- GFF gene/mRNA/exon/CDS hierarchy, 1-based (preparePredHeaderToGFF, :263-339)
"""

from ..data.gencode import GeneticCode, reverse_complement_ascii
from ..ops.chain import PLUS


def cpp_double(x):
    """C++ `ostream << double` default formatting (6 significant digits)."""
    s = "%g" % x
    return s


def _find_start_in_string(seq):
    """findStartInString (unitesetstofasta.cpp:25-35): last in-frame ATG."""
    last = 0
    for i in range(0, len(seq) - 2, 3):
        if seq[i:i + 3] in (b"ATG", b"atg"):
            last = i + 2
    return last


def scan_for_start_before_first_exon(pred, contig, scan_len):
    """Port of scanForStartBeforeFirstExon (:37-113).

    Returns (num_nucs_added, prefix_bytes); mutates pred.low/high coords.
    """
    if pred.strand == PLUS:
        first_codon = bytes(contig[pred.low_contig_coord:pred.low_contig_coord + 3])
        if _find_start_in_string(first_codon) > 0:
            return 0, b""
    else:
        first_codon = bytes(contig[pred.high_contig_coord - 2:pred.high_contig_coord + 1])
        if _find_start_in_string(reverse_complement_ascii(first_codon)) > 0:
            return 0, b""

    scan_len_legal = scan_len - (scan_len % 3)
    if pred.strand == PLUS:
        coord_begin = pred.low_contig_coord - scan_len_legal
        pos_after_stop = pred.exons[0].contig_start_before_trim
        if coord_begin < pos_after_stop:
            coord_begin = pos_after_stop
            scan_len_legal = pred.low_contig_coord - coord_begin
    else:
        coord_begin = pred.high_contig_coord + 1
        pos_after_stop = pred.exons[0].contig_end_before_trim
        # bug-compatible: the reference compares (int - unsigned) which wraps
        # for the (always) negative difference, so the clamp never fires
        # (unitesetstofasta.cpp:74: (posAfterStopCodon - pred.highContigCoord)
        # promotes to size_t); keep the dead branch for exotic inputs only
        diff = pos_after_stop - pred.high_contig_coord
        if 0 <= diff < scan_len_legal:
            scan_len_legal = diff
            if scan_len_legal % 3 != 0:
                raise AssertionError("scanLenLegal mod 3 != 0")
    segment = bytes(contig[coord_begin:coord_begin + scan_len_legal])
    if pred.strand != PLUS:
        segment = reverse_complement_ascii(segment)
    pos_last = _find_start_in_string(segment)
    if pos_last > 0:
        to_add = segment[pos_last - 2:]
        if pred.strand == PLUS:
            pred.low_contig_coord -= len(to_add)
        else:
            pred.high_contig_coord += len(to_add)
        return len(to_add), to_add
    return 0, b""


def prepare_pred(pred, target_acc, contig_acc, contig, params, contig_len):
    """preparePredDataAndHeader (:115-237).

    Returns (header_line_str_without_gt, joined_nucl_bytes); also sets
    adjusted_contig_start on each exon.
    """
    parts = [target_acc, "|", contig_acc, "|",
             "+|" if pred.strand == PLUS else "-|",
             str(pred.total_bitscore), "|",
             cpp_double(pred.combined_evalue), "|",
             str(pred.num_exons), "|"]
    seq_chunks = []
    if params.len_scan_for_start == 0:
        parts.append(f"{pred.low_contig_coord}|{pred.high_contig_coord}")
    else:
        added, prefix = scan_for_start_before_first_exon(
            pred, contig, params.len_scan_for_start)
        seq_chunks.append(prefix)
        if pred.strand == PLUS:
            parts.append(f"{pred.low_contig_coord}[{added}]|{pred.high_contig_coord}")
        else:
            parts.append(f"{pred.low_contig_coord}|{pred.high_contig_coord}[{added}]")

    last_target_pos = -1
    for exon in pred.exons:
        t_start, t_end = exon.target_match_start, exon.target_match_end
        c_start, c_end = exon.contig_start, exon.contig_end
        nuc_len = exon.nucleotide_len
        adj_start, adj_len = c_start, nuc_len
        if last_target_pos >= t_start:
            diff = last_target_pos - t_start + 1
            adj_start += 3 * diff
            adj_len -= 3 * diff
        exon_low = adj_start if pred.strand == PLUS else -c_end
        exon.adjusted_contig_start = adj_start
        seg = bytes(contig[exon_low:exon_low + adj_len])
        last_target_pos = t_end
        parts.append("|")
        if params.write_frag_coords:
            parts.append(f"[{exon.contig_start_before_trim}]")
        parts.append(f"{abs(c_start)}[{abs(adj_start)}]:")
        if params.write_frag_coords:
            parts.append(f"[{exon.contig_end_before_trim}]")
        parts.append(f"{abs(c_end)}[{abs(c_end)}]:")
        parts.append(f"{nuc_len}[{adj_len}]")
        if pred.strand == PLUS:
            seq_chunks.append(seg)
        else:
            seq_chunks.append(reverse_complement_ascii(seg))

    if params.write_frag_coords and \
            pred.exons[-1].contig_end_before_trim == abs(pred.exons[-1].contig_end):
        last_coding = pred.exons[-1].contig_end_before_trim
        if pred.exons[-1].strand == PLUS:
            stop_pos = last_coding + 1
        else:
            stop_pos = last_coding - 3
        if 0 <= stop_pos <= contig_len - 2:
            stop_seq = bytes(contig[stop_pos:stop_pos + 3])
            if pred.exons[-1].strand == PLUS:
                seq_chunks.append(stop_seq)
            else:
                seq_chunks.append(reverse_complement_ascii(stop_seq))

    return "".join(parts), b"".join(seq_chunks)


def headers_map_line(contig_key, pred, header_line):
    """preparePredHeaderToInfo (:239-261)."""
    span = pred.high_contig_coord - pred.low_contig_coord + 1
    if pred.strand == PLUS:
        coord = f"{pred.low_contig_coord}+{span}"
    else:
        coord = f"{pred.high_contig_coord}-{span}"
    # header_line already ends with \n (unitesetstofasta.cpp:259)
    return f"{contig_key}\t{coord}\t0\t{pred.target_key}\t{pred.strand}\t{header_line}"


def gff_lines(contig_acc, pred, target_acc):
    """preparePredHeaderToGFF (:263-339)."""
    strand = "+" if pred.strand == PLUS else "-"
    tcs = f"{target_acc}|{contig_acc}|{strand}|{pred.low_contig_coord}"
    out = []
    for level in ("gene", "mRNA"):
        attr = (f"TCS_ID={tcs}" if level == "gene"
                else f"TCS_ID={tcs}_mRNA;Parent={tcs}")
        out.append(f"{contig_acc}\tMetaEuk\t{level}\t{pred.low_contig_coord + 1}\t"
                   f"{pred.high_contig_coord + 1}\t{pred.total_bitscore}\t{strand}\t.\t"
                   f"Target_ID={target_acc};{attr}\n")
    for j, exon in enumerate(pred.exons):
        e_start = abs(exon.contig_start) + 1
        e_adj_start = abs(exon.adjusted_contig_start) + 1
        e_end = abs(exon.contig_end) + 1
        for level in ("exon", "CDS"):
            if level == "exon":
                a, b = (e_start, e_end) if pred.strand == PLUS else (e_end, e_start)
                attr = f"TCS_ID={tcs}_exon_{j};Parent={tcs}_mRNA"
            else:
                a, b = (e_adj_start, e_end) if pred.strand == PLUS else (e_end, e_adj_start)
                attr = f"TCS_ID={tcs}_CDS_{j};Parent={tcs}_exon_{j}"
            out.append(f"{contig_acc}\tMetaEuk\t{level}\t{a}\t{b}\t{exon.bit_score}\t"
                       f"{strand}\t.\tTarget_ID={target_acc};{attr}\n")
    return "".join(out)


class PredictionWriter:
    """Streams predictions of one run into the four output files."""

    def __init__(self, out_prefix, params):
        self.params = params
        self.gencode = GeneticCode(params.translation_table)
        self.fas = open(f"{out_prefix}.fas", "wb")
        self.codon = open(f"{out_prefix}.codon.fas", "wb")
        self.hmap = open(f"{out_prefix}.headersMap.tsv", "wb")
        self.gff = open(f"{out_prefix}.gff", "wb")

    def write_prediction(self, pred, contig_key, contig_acc, target_acc,
                         contig, contig_len):
        header, nucl = prepare_pred(pred, target_acc, contig_acc, contig,
                                    self.params, contig_len)
        hdr_bytes = (">" + header + "\n").encode()
        self.fas.write(hdr_bytes)
        self.codon.write(hdr_bytes)
        self.hmap.write(headers_map_line(contig_key, pred, header + "\n").encode())
        self.gff.write(gff_lines(contig_acc, pred, target_acc).encode())
        if len(nucl) % 3 != 0:
            raise AssertionError("coding sequence does not divide by 3")
        aa = self.gencode.translate_ascii(nucl)
        self.fas.write(aa + b"\n")
        self.codon.write(nucl + b"\n")

    def close(self):
        for f in (self.fas, self.codon, self.hmap, self.gff):
            f.close()
