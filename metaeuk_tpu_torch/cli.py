"""metaeuk-tpu-torch command-line interface.

    metaeuk-tpu-torch easy-predict contigs.fna targets.faa out_prefix [tmp]
        [--device cuda] [the easy-predict flags of metaeuk-tpu]

The flags and their mapping to Params are those of metaeuk-tpu: _byte_size,
_add_predict_flags, _params_from_args and _parse_dp_payload are copied from
metaeuk_tpu/cli.py (:16, :25, :69, :214). The other commands of metaeuk-tpu
are not ported yet.
"""

import argparse
import sys

from .params import Params


def _byte_size(s):
    """Byte sizes with the reference's suffixes (ByteParser): 4G, 512M."""
    s = str(s).strip()
    mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}
    if s and s[-1].upper() in mult:
        return int(float(s[:-1]) * mult[s[-1].upper()])
    return int(s)


def _add_predict_flags(p):
    p.add_argument("--metaeuk-eval", type=float, default=0.001,
                   help="max combined E-value of an optimal exon set")
    p.add_argument("--metaeuk-tcov", type=float, default=0.5,
                   help="min target coverage of an optimal exon set")
    p.add_argument("--min-intron", type=int, default=15)
    p.add_argument("--max-intron", type=int, default=10000)
    p.add_argument("--min-exon-aa", type=int, default=11)
    p.add_argument("--max-overlap", type=int, default=10)
    p.add_argument("--max-exon-sets", type=int, default=1)
    p.add_argument("--set-gap-open", type=int, default=-1)
    p.add_argument("--set-gap-extend", type=int, default=-1)
    p.add_argument("--reverse-fragments", action="store_true")
    p.add_argument("--overlap", type=int, default=0,
                   help="allow same-strand overlaps (1) or not (0)")
    p.add_argument("--target-key", action="store_true",
                   help="write target keys instead of accessions")
    p.add_argument("--write-frag-coords", action="store_true")
    p.add_argument("--len-scan-for-start", type=int, default=0)
    p.add_argument("--translation-table", type=int, default=1)
    p.add_argument("-e", "--evalue", type=float, default=100.0,
                   help="search E-value threshold")
    p.add_argument("--max-seqs", type=int, default=300)
    p.add_argument("--split", type=int, default=0,
                   help="target DB splits (0 = set by --split-memory-limit)")
    p.add_argument("--split-memory-limit", type=_byte_size, default=0,
                   help="max RAM per prefilter split, e.g. 4G (0 = free RAM)")
    p.add_argument("--split-mode", type=int, default=2, choices=[0, 1, 2],
                   help="0 target split, 1 query split (streamed query "
                        "blocks over one resident index), 2 auto")
    p.add_argument("--prefilter-mode", choices=["exhaustive", "ungapped", "kmer"],
                   default="kmer",
                   help="kmer = the reference default (sens-calibrated)")
    p.add_argument("--min-ungapped-score", type=int, default=15)
    p.add_argument("--comp-bias-corr", type=int, default=1)
    p.add_argument("--search-type", type=int, default=0,
                   choices=[0, 1, 2, 3],
                   help="0 auto, 1 amino acid, 2 translated, 3 nucleotide "
                        "(the reference flag; nucl/nucl inputs are also "
                        "auto-detected)")
    p.add_argument("--max-seq-len", type=int, default=10000,
                   help="split window for nucleotide search")


def _params_from_args(args):
    return Params(
        metaeuk_evalue_thr=args.metaeuk_eval,
        metaeuk_tcov_thr=args.metaeuk_tcov,
        min_intron_length=args.min_intron,
        max_intron_length=args.max_intron,
        min_exon_aa_length=args.min_exon_aa,
        max_aa_overlap=args.max_overlap,
        max_exon_sets=args.max_exon_sets,
        set_gap_open_penalty=args.set_gap_open,
        set_gap_extend_penalty=args.set_gap_extend,
        reverse_fragments=args.reverse_fragments,
        overlap_allowed=args.overlap,
        write_target_key=args.target_key,
        write_frag_coords=args.write_frag_coords,
        len_scan_for_start=args.len_scan_for_start,
        translation_table=args.translation_table,
        search_evalue_thr=args.evalue,
        max_res_list_len=args.max_seqs,
        prefilter_mode=args.prefilter_mode,
        min_diag_score=args.min_ungapped_score,
        comp_bias_correction=bool(args.comp_bias_corr),
        aln_len_thr=args.min_exon_aa,
        split=args.split,
        split_mode=args.split_mode,
        split_memory_limit=args.split_memory_limit,
    )


def _parse_dp_payload(payload):
    """Parse 19-col DP-format lines back into Prediction objects
    (Prediction::setByDPRes + addExon, PredictionParser.h:250-297)."""
    from .ops.chain import PotentialExon, Prediction
    preds = []
    curr = None
    curr_sig = None
    for line in payload.decode().splitlines():
        c = line.split("\t")
        sig = (int(c[0]), int(c[1]), int(c[5]))  # target, strand, lowCoord
        exon = PotentialExon(
            exon_key=int(c[7]), target_key=int(c[0]), strand=int(c[1]),
            bit_score=int(c[8]), seq_id_text=c[9], evalue_text=c[10],
            target_match_start=int(c[11]), target_match_end=int(c[12]),
            target_len=int(c[13]), contig_start=int(c[14]),
            contig_end=int(c[15]), nucleotide_len=int(c[16]),
            contig_start_before_trim=int(c[17]),
            contig_end_before_trim=int(c[18]))
        if sig != curr_sig:
            curr = Prediction(
                target_key=int(c[0]), strand=int(c[1]),
                total_bitscore=int(c[2]), combined_evalue=float(c[3]),
                combined_evalue_text=c[3], exons=[exon])
            # setByDPRes takes the coords from the columns directly
            curr.low_contig_coord = int(c[5])
            curr.high_contig_coord = int(c[6])
            preds.append(curr)
            curr_sig = sig
        else:
            curr.exons.append(exon)
    return preds


def _device(name):
    """The torch device to align on; a CUDA device must be present."""
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return dev


def cmd_easy_predict(args):
    from .pipeline.predict import EasyPredict
    EasyPredict(_params_from_args(args), device=_device(args.device)).run(
        args.contigs, args.targets, args.out_prefix, tmp_dir=args.tmp)
    print(f"wrote {args.out_prefix}.fas / .codon.fas / .headersMap.tsv / .gff")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="metaeuk-tpu-torch",
        description="Gene discovery with MetaEuk's capabilities, aligned "
                    "on an NVIDIA GPU")
    sub = ap.add_subparsers(dest="command", required=True)
    ep = sub.add_parser("easy-predict",
                        help="contigs + protein targets -> gene predictions")
    ep.add_argument("contigs")
    ep.add_argument("targets")
    ep.add_argument("out_prefix")
    ep.add_argument("tmp", nargs="?", default=None,
                    help="checkpoint dir (stage artifacts, resumable)")
    ep.add_argument("--device", default="cuda",
                    help="torch device for the alignment (default cuda; "
                         "cpu runs the kernels' plain versions)")
    _add_predict_flags(ep)
    ep.set_defaults(fn=cmd_easy_predict)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
