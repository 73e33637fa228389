"""metaeuk-tpu-torch command-line interface.

    metaeuk-tpu-torch easy-predict contigs.fna targets.faa out_prefix [tmp]
        [--device cuda] [--contig-split I:N] [the easy-predict flags of
        metaeuk-tpu]
    metaeuk-tpu-torch mergepredictions out_prefix part_prefix ...
    metaeuk-tpu-torch predictexons | reduceredundancy | unitesetstofasta
        | groupstoacc | extractorfs | translatenucs | resultspercontig
        | collectoptimalset | createtsv | taxtocontig ...
    metaeuk-tpu-torch createdb | search | align | convertalis | easy-search
        | rbh | map | easy-rbh | result2rbh | lcaalign ...
    metaeuk-tpu-torch taxonomy | easy-taxonomy | summarizealis | lca
        | majoritylca | aggregatetax | aggregatetaxweights | addtaxonomy
        | filtertaxdb | filtertaxseqdb | taxonomyreport | createbintaxonomy
        | createbintaxmapping | createdmptaxonomy | createtaxdb ...
    metaeuk-tpu-torch search --num-iterations N | result2profile
        | msa2profile | sequence2profile | profile2pssm | convertprofiledb
        | expandaln | expand2profile | profile2consensus | profile2repseq
        | profile2neff | convertmsa | filtera3m | alignall | summarizetabs
        | result2dnamsa | enrich ...
    metaeuk-tpu-torch cluster | easy-cluster | easy-linclust | linclust
        | kmermatcher | clust | mergeclusters | createlinindex | kmersearch
        | linsearch | easy-linsearch | pickconsensusrep | clusterupdate
        | convertca3m | result2repseq | masksequence | gff2db | maskbygff
        | result2stats | apply | diffseqdbs | result2msa ...
    metaeuk-tpu-torch multihitdb | multihitsearch | besthitperset
        | combinepvalperset | mergeresultsbyset | gpuserver | serverclient
        | filterdb | rescorediagonal | createindex | prefilter | indexdb
        | kmerindexdb | nrtotaxmapping | filterresult | version
        | reverseseq .. convert2fasta | swapdb .. touchdb
        | extractalignedregion .. db2tar ...
    metaeuk-tpu-torch bench [--selftest] [--no-ref] [--no-selftest]
        [--device cuda]
    metaeuk-tpu-torch aliasdb .. view | createclusearchdb .. tsv2exprofiledb
        | appenddbtoindex .. extractdomains | pairaln | alignbykmer | fwbw
        | ungappedprefilter | gappedprefilter | databases | offsetalignment
        | proteinaln2nucl ...

The flags and their mapping to Params are those of metaeuk-tpu: _byte_size,
_add_predict_flags, _params_from_args and _parse_dp_payload are copied from
metaeuk_tpu/cli.py (:16, :25, :69, :214), MetaEuk's modular commands from
its cmd_predictexons .. cmd_groupstoacc (:172-370), cmd_resultspercontig,
cmd_collectoptimalset (:694-720), cmd_createtsv and cmd_taxtocontig
(:907-960), the MMseqs2 search family's commands from its cmd_createdb
(:582), cmd_search (:734), cmd_convertalis (:881), cmd_align (:957) and
cmd_rbh .. cmd_lcaalign (:1436-1490), and the taxonomy commands from its
cmd_taxcmd, cmd_taxonomy, cmd_easy_taxonomy (:1046-1135) and
cmd_summarizealis (:1492), search's iterative branch from its cmd_search
(:773-795), and the profile tools from its cmd_msa2profile,
cmd_result2profile (:395-433), cmd_profile2pssm (:686),
cmd_sequence2profile, cmd_convertprofiledb (:718-732), cmd_dbtool6
(:1171), cmd_enrich (:1287) and cmd_expandaln (:1376), and the clustering
and linear-search family from its cmd_kmermatcher, cmd_linclust (:135-162),
cmd_easy_cluster, cmd_cluster (:366-393), cmd_dbtool3 (:515-546),
cmd_clust .. cmd_linsearch (:970-1033), cmd_convertca3m (:1298),
cmd_pickconsensusrep, cmd_clusterupdate (:1353-1368) and
cmd_easy_linsearch (:1426), with their parsers. Every command that aligns
(easy-predict, predictexons, unitesetstofasta, taxtocontig, search, align,
easy-search, rbh, easy-rbh, lcaalign, taxonomy, easy-taxonomy, alignall,
enrich, cluster, easy-cluster, easy-linclust, linclust, linsearch,
easy-linsearch, pickconsensusrep, clusterupdate, multihitsearch, gpuserver)
takes --device (default cuda; cpu runs the kernels' plain versions); the
others run on the host only. The multihit family, the resident server and
the DB utilities over modules the port carries come from its cmd_dbtool,
cmd_dbtool2 (:436-512), cmd_besthitperset, cmd_combinepvalperset,
cmd_rescorediagonal (:116-150), cmd_filterdb (:562), cmd_createindex,
cmd_prefilter (:626-683), cmd_dbtool5 (:1136), cmd_gpuserver,
cmd_serverclient (:1235-1262), cmd_index_alias (:1338),
cmd_nrtotaxmapping (:1369), cmd_multihitdb, cmd_multihitsearch,
cmd_filterresult (:1387-1411), with their parsers; `version` prints the
port's own line. Search's nucleotide branch (:799-840), _cmd_offsetaln,
_cmd_p2n (:548-559), cmd_dbtool4 (:984), cmd_dbtool7, cmd_dbtool8
(:1197-1232), cmd_databases (:1265), cmd_fwbw .. cmd_alignbykmer
(:1306-1335) and cmd_exhaustiveprefilter (:1414) are copied with their
parsers too, all host-only, and easy-predict's --contig-split and
cmd_mergepredictions (:98-113, :164). `bench` (cmd_bench, :1040) runs
tools/bench.py, the port of the root bench.py; it takes --device and ends
non-zero on a kernel failure or a selftest mismatch.
"""

import argparse
import sys

from .params import Params

# `version`'s line: the JAX CLI's (cli.py:1035) with the port's name and
# back end
VERSION = ("metaeuk-tpu-torch 1.0 (MetaEuk 7.bba0d80 capabilities, "
           "PyTorch/CUDA)")


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
    contig_range = None
    if args.contig_split:
        i, n = (int(x) for x in args.contig_split.split(":"))
        from .io.seqdb import SeqDB, DBTYPE_NUCL
        from .parallel.multihost import contig_partition
        total = len(SeqDB.from_fasta(args.contigs, DBTYPE_NUCL)) \
            if not pathlib_exists(f"{args.contigs}.dbtype") else \
            sum(1 for _ in open(f"{args.contigs}.index"))
        contig_range = contig_partition(total, i, n)
    EasyPredict(_params_from_args(args), device=_device(args.device)).run(
        args.contigs, args.targets, args.out_prefix, tmp_dir=args.tmp,
        contig_range=contig_range)
    print(f"wrote {args.out_prefix}.fas / .codon.fas / .headersMap.tsv / .gff")
    return 0


def cmd_mergepredictions(args):
    """Concatenate contig-partitioned easy-predict outputs (cli.py:164)."""
    from .parallel.multihost import merge_predictions
    merge_predictions(args.out_prefix, args.parts)
    print(f"merged {len(args.parts)} partitions -> {args.out_prefix}.*")
    return 0


def cmd_predictexons(args):
    """contigs + targets -> DP-format predictions DB (MMseqs-compatible)."""
    from .io.seqdb import SeqDB, DBTYPE_AA, DBTYPE_NUCL
    from .io import mmseqsdb
    from .pipeline.dpformat import predictions_payload
    from .pipeline.predict import EasyPredict

    p = _params_from_args(args)
    contigs = (mmseqsdb.read_seqdb(args.contigs)
               if pathlib_exists(f"{args.contigs}.dbtype")
               else SeqDB.from_fasta(args.contigs, DBTYPE_NUCL))
    targets = (mmseqsdb.read_seqdb(args.targets)
               if pathlib_exists(f"{args.targets}.dbtype")
               else SeqDB.from_fasta(args.targets, DBTYPE_AA))
    preds = EasyPredict(p, device=_device(args.device)).predict_exons(
        contigs, targets)
    mmseqsdb.write_db(args.out_db,
                      ((ci, predictions_payload(preds.get(ci, [])))
                       for ci in range(len(contigs))))
    print(f"wrote {args.out_db} (DP-format predictions DB)")
    return 0


def cmd_reduceredundancy(args):
    """DP-format predictions DB -> representative DB + cluster-map DB."""
    from .io import mmseqsdb
    from .pipeline.dpformat import cluster_rows_payload, predictions_payload
    from .pipeline.reduce import reduce_redundancy

    params_overlap = args.overlap
    red, clust = [], []
    for key, payload in mmseqsdb.read_db(args.in_db):
        preds = _parse_dp_payload(payload)
        reps, rows = reduce_redundancy(preds, params_overlap)
        red.append((key, predictions_payload(reps)))
        clust.append((key, cluster_rows_payload(rows)))
    mmseqsdb.write_db(args.out_db, red)
    mmseqsdb.write_db(args.clust_db, clust)
    print(f"wrote {args.out_db} + {args.clust_db}")
    return 0


def cmd_extractorfs(args):
    """Six-frame fragment extraction -> nucleotide fragment DB + headers."""
    import dataclasses
    from .io.seqdb import DBTYPE_NUCL
    from .io import mmseqsdb
    from .ops.orf import OrfExtractor, orf_header_fields
    from .pipeline.predict import load_sequence_input

    p = _params_from_args(args) if hasattr(args, "metaeuk_eval") else Params()
    p = dataclasses.replace(p, orf_min_length=args.min_length,
                            orf_max_length=args.max_length)
    contigs = load_sequence_input(args.contigs, DBTYPE_NUCL)
    ex = OrfExtractor(p)
    seqs, hdrs = [], []
    key = 0
    for ci in range(len(contigs)):
        locs, frags = ex.extract_contig(contigs.seq_bytes(ci), ci)
        for loc, frag in zip(locs, frags):
            from_pos, signed_len = orf_header_fields(loc)
            complete = int(loc.has_incomplete_start) | \
                (int(loc.has_incomplete_end) << 1)
            hdr = (f"{int(contigs.keys[ci])}\t{from_pos}"
                   f"{'+' if signed_len >= 0 else '-'}{abs(signed_len)}")
            if complete:
                hdr += f"\t{complete}"
            if args.translate:
                seqs.append((key, ex.translate_fragment(frag) + b"\n"))
            else:
                seqs.append((key, frag + b"\n"))
            hdrs.append((key, hdr.encode() + b"\n"))
            key += 1
    mmseqsdb.write_db(args.out_db, seqs,
                      mmseqsdb.DBTYPE_AA if args.translate
                      else mmseqsdb.DBTYPE_NUCL)
    mmseqsdb.write_db(f"{args.out_db}_h", hdrs, mmseqsdb.DBTYPE_GENERIC)
    print(f"wrote {args.out_db} ({key} fragments)")
    return 0


def cmd_translatenucs(args):
    """Nucleotide DB -> translated AA DB."""
    import os
    import shutil
    from .data.gencode import GeneticCode
    from .io import mmseqsdb

    gc = GeneticCode(args.translation_table)
    out = []
    for key, payload in mmseqsdb.read_db(args.in_db):
        nucl = payload.rstrip(b"\n")
        out.append((key, gc.translate_ascii(nucl) + b"\n"))
    mmseqsdb.write_db(args.out_db, out, mmseqsdb.DBTYPE_AA)
    for suffix in ("_h", "_h.index", "_h.dbtype"):
        if os.path.exists(f"{args.in_db}{suffix}"):
            shutil.copy(f"{args.in_db}{suffix}", f"{args.out_db}{suffix}")
    print(f"wrote {args.out_db}")
    return 0


def cmd_unitesetstofasta(args):
    """Representative predictions DB -> FASTA/GFF outputs."""
    import numpy as np
    from .io.seqdb import DBTYPE_NUCL
    from .io import mmseqsdb
    from .pipeline.output import PredictionWriter
    from .pipeline.predict import (EasyPredict, load_sequence_input,
                                   load_target_input)

    p = _params_from_args(args)
    contigs = load_sequence_input(args.contigs, DBTYPE_NUCL)
    targets = load_target_input(args.targets)
    preds_per_contig = {}
    for key, payload in mmseqsdb.read_db(args.preds_db):
        if payload:
            preds_per_contig[int(key)] = _parse_dp_payload(payload)
    ep = EasyPredict(p, device=_device(args.device))
    writer = PredictionWriter(args.out_prefix, p)
    target_accs = [targets.accession(i) for i in range(len(targets))]
    chunks, starts, pos = [], [], 0
    for ci in range(len(contigs)):
        starts.append(pos)
        s = contigs.seq_bytes(ci)
        chunks.append(s + b"\n\x00")
        pos += len(s) + 2
    db_buffer = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    for ci in range(len(contigs)):
        preds = preds_per_contig.get(int(contigs.keys[ci]), [])
        if not preds:
            continue
        ep._write_contig(writer, preds, int(contigs.keys[ci]),
                         contigs.accession(ci), target_accs,
                         db_buffer[starts[ci]:], int(contigs.lengths[ci]), p)
    writer.close()
    print(f"wrote {args.out_prefix}.fas / .codon.fas / .headersMap.tsv / .gff")
    return 0


def cmd_groupstoacc(args):
    """Cluster-map DB -> accession TSV (groupstoacc equivalent)."""
    from .io.seqdb import DBTYPE_NUCL
    from .io import mmseqsdb
    from .pipeline.groups import groups_to_acc_lines
    from .pipeline.predict import load_sequence_input, load_target_input

    contigs = load_sequence_input(args.contigs, DBTYPE_NUCL)
    targets = load_target_input(args.targets)
    target_accs = [targets.accession(i) for i in range(len(targets))]
    key_to_acc = {int(k): contigs.accession(i)
                  for i, k in enumerate(contigs.keys)}
    with open(args.out_tsv, "w") as f:
        for key, payload in mmseqsdb.read_db(args.clust_db):
            rows = []
            for line in payload.decode().splitlines():
                c = [int(x) for x in line.split("\t")]
                rows.append(tuple(c))
            f.write(groups_to_acc_lines(rows, key_to_acc[int(key)],
                                        target_accs))
    print(f"wrote {args.out_tsv}")
    return 0


def cmd_resultspercontig(args):
    from .pipeline.percontig import resultspercontig
    resultspercontig(args.contigs_db, args.fragments_db, args.aln_db,
                     args.out_db)
    print("resultspercontig done")
    return 0


def cmd_collectoptimalset(args):
    from .pipeline.percontig import collectoptimalset
    p = Params(metaeuk_evalue_thr=args.metaeuk_eval,
               metaeuk_tcov_thr=args.metaeuk_tcov,
               min_intron_length=args.min_intron,
               max_intron_length=args.max_intron,
               max_aa_overlap=args.max_overlap,
               set_gap_open_penalty=args.set_gap_open,
               set_gap_extend_penalty=args.set_gap_extend)
    collectoptimalset(args.contig_res_db, args.targets_db, args.out_db,
                      params=p)
    print("collectoptimalset done")
    return 0


def cmd_createtsv(args):
    """DB entries + headers -> TSV (createtsv equivalent)."""
    from .io.seqdb import DBTYPE_AA
    from .io import mmseqsdb
    from .pipeline.predict import load_sequence_input

    db = load_sequence_input(args.seq_db, DBTYPE_AA) \
        if pathlib_exists(f"{args.seq_db}_h.dbtype") or \
        pathlib_exists(f"{args.seq_db}_h") else None
    with open(args.out_tsv, "w") as f:
        for key, payload in mmseqsdb.read_db(args.data_db):
            acc = (db.accession(db.id_of_key(key)) if db is not None
                   else str(key))
            text = payload.decode()
            for line in text.splitlines():
                f.write(f"{acc}\t{line}\n")
    print(f"wrote {args.out_tsv}")
    return 0


def cmd_taxtocontig(args):
    from .io.seqdb import SeqDB, DBTYPE_AA
    from .tax.ncbi import NcbiTaxonomy
    from .tax.workflow import TaxToContig

    device = _device(args.device)
    params = Params(majority_thr=args.majority, vote_mode=args.vote_mode,
                    search_evalue_thr=args.evalue)
    targets = SeqDB.from_fasta(args.targets, DBTYPE_AA)
    tax = NcbiTaxonomy.from_dumps(args.names_dmp, args.nodes_dmp,
                                  args.merged_dmp)
    taxids = [0] * len(targets)
    acc_to_idx = {targets.accession(i): i for i in range(len(targets))}
    with open(args.mapping) as f:
        for line in f:
            acc, taxid = line.split()[:2]
            if acc in acc_to_idx:
                taxids[acc_to_idx[acc]] = int(taxid)
    contig_accs = None
    if args.contigs:
        from .pipeline.predict import load_sequence_input
        from .io.seqdb import DBTYPE_NUCL
        cdb = load_sequence_input(args.contigs, DBTYPE_NUCL)
        contig_accs = {int(k): cdb.accession(i)
                       for i, k in enumerate(cdb.keys)}
    TaxToContig(params, targets, taxids, tax, device=device).run(
        args.preds_fasta, args.headers_map, args.out_base, mode=args.lca_mode,
        contig_accessions=contig_accs)
    print(f"wrote {args.out_base}_tax_per_pred.tsv / _tax_per_contig.tsv")
    return 0


def pathlib_exists(p):
    import os
    return os.path.exists(p)


def cmd_createdb(args):
    """FASTA -> sequence DB triple + headers + .lookup + .source.

    Port of util/createdb.cpp for --shuffle 0 --createdb-mode 1 (the
    configuration every parity fixture uses): seq type auto-detected by
    the TAGCUN>0.9 sampling heuristic (createdb.cpp:552-576); entries
    stored as 'SEQ\\n\\0'; lookup rows 'key<TAB>accession<TAB>0'."""
    import pathlib
    from .io import mmseqsdb
    from .io.fasta import parse_fasta_header, read_fasta

    entries = []
    is_nucl_votes, samples = 0, 0
    for fi, path in enumerate(args.fasta):
        for name, seq in read_fasta(path):
            seq = seq.decode() if isinstance(seq, bytes) else seq
            if samples < 10 or (samples % 100) == 0:
                if samples < 100:
                    s = seq.upper()
                    cnt = sum(s.count(c) for c in "TAGCUN")
                    if len(seq) and cnt / len(seq) > 0.9:
                        is_nucl_votes += 1
                samples += 1
            entries.append((name, seq, fi))
    dbtype = mmseqsdb.DBTYPE_NUCL if is_nucl_votes == samples \
        else mmseqsdb.DBTYPE_AA
    mmseqsdb.write_db(args.out_db,
                      ((i, s.encode() + b"\n")
                       for i, (_, s, _) in enumerate(entries)), dbtype)
    mmseqsdb.write_db(f"{args.out_db}_h",
                      ((i, n.encode() + b"\n")
                       for i, (n, _, _) in enumerate(entries)),
                      mmseqsdb.DBTYPE_GENERIC)
    with open(f"{args.out_db}.lookup", "w") as f:
        for i, (n, _, fi) in enumerate(entries):
            f.write(f"{i}\t{parse_fasta_header(n)}\t{fi}\n")
    with open(f"{args.out_db}.source", "w") as f:
        for fi, path in enumerate(args.fasta):
            f.write(f"{fi}\t{pathlib.Path(path).name}\n")
    print(f"wrote {args.out_db} ({len(entries)} seqs, "
          f"type {'nucl' if dbtype == mmseqsdb.DBTYPE_NUCL else 'aa'})")
    return 0


def _fasta_or_db(path, td, name):
    """path if it is an MMseqs DB, else a sequence DB of its AA FASTA
    written to td/name (cmd_search's multi-step branch)."""
    from .io import mmseqsdb
    from .io.seqdb import DBTYPE_AA, SeqDB
    if pathlib_exists(f"{path}.dbtype"):
        return path
    db = f"{td}/{name}"
    mmseqsdb.write_seqdb(db, SeqDB.from_fasta(path, DBTYPE_AA))
    return db


def cmd_search(args):
    """Protein vs protein/profile search -> alignment DB (+ optional m8)."""
    import dataclasses
    from .io.seqdb import DBTYPE_AA
    from .io import mmseqsdb
    from .pipeline.alnformat import hit_to_m8_line, hits_to_aln_db_entries
    from .pipeline.predict import load_sequence_input, load_target_input
    from .search.driver import SearchDriver

    device = _device(args.device)
    p = _params_from_args(args)
    # mmseqs search defaults: no minimum alignment length
    p = dataclasses.replace(p, aln_len_thr=0)
    if getattr(args, "s", None) is not None:
        p = dataclasses.replace(p, sensitivity=args.s)
    if getattr(args, "sens_steps", 1) > 1:
        import tempfile
        import os
        from .search.searchdb import search_db
        td = args.tmp or tempfile.mkdtemp(prefix="senssearch")
        os.makedirs(td, exist_ok=True)
        q_db = _fasta_or_db(args.queries, td, "queryDB")
        t_db = _fasta_or_db(args.targets, td, "targetDB")
        search_db(q_db, t_db, args.out_db, td,
                  sensitivity=args.s if args.s is not None else 5.7,
                  evalue=p.search_evalue_thr,
                  max_seqs=p.max_res_list_len,
                  start_sens=args.start_sens, sens_steps=args.sens_steps,
                  add_backtrace=bool(args.backtrace),
                  alignment_mode=3 if args.backtrace else 2, device=device)
        print(f"wrote {args.out_db} ({args.sens_steps} sensitivity steps)")
        return 0
    if getattr(args, "num_iterations", 1) > 1:
        import tempfile
        import os
        from .search.iterative import iterative_search
        td = args.tmp or tempfile.mkdtemp(prefix="itersearch")
        os.makedirs(td, exist_ok=True)
        q_db = _fasta_or_db(args.queries, td, "queryDB")
        t_db = _fasta_or_db(args.targets, td, "targetDB")
        iterative_search(q_db, t_db, args.out_db, td,
                         num_iterations=args.num_iterations,
                         evalue=p.search_evalue_thr,
                         e_profile=args.e_profile, params=p, device=device)
        print(f"wrote {args.out_db} ({args.num_iterations} iterations)")
        return 0
    queries = load_sequence_input(args.queries, DBTYPE_AA)
    targets = load_target_input(args.targets)
    query_seqs = [queries.seq_bytes(i) for i in range(len(queries))]

    def _looks_nucl(seqs):
        votes = samples = 0
        for s_ in seqs[:10]:
            if not len(s_):
                continue
            u = bytes(s_).upper()
            cnt = sum(u.count(c) for c in b"TAGCUN")
            votes += (cnt / len(u)) > 0.9
            samples += 1
        return samples > 0 and votes == samples

    from .io.seqdb import SeqDB
    want_nucl = getattr(args, "search_type", 0) == 3
    if isinstance(targets, SeqDB) and (want_nucl or (
            _looks_nucl(query_seqs) and
            _looks_nucl([targets.seq_bytes(i)
                         for i in range(len(targets))]))):
        # nucleotide/nucleotide: the blastn.sh path at byte parity
        # (search/nucl_search.py)
        import tempfile
        from .search.nucl_search import nucl_search_workflow
        td = tempfile.mkdtemp(prefix="nuclsearch")
        q_db, t_db = f"{td}/queryDB", f"{td}/targetDB"
        mmseqsdb.write_seqdb(q_db, queries, dbtype=mmseqsdb.DBTYPE_NUCL)
        mmseqsdb.write_seqdb(t_db, targets, dbtype=mmseqsdb.DBTYPE_NUCL)
        nucl_search_workflow(q_db, t_db, args.out_db, f"{td}/tmp",
                             evalue=p.search_evalue_thr,
                             max_seqs=p.max_res_list_len,
                             max_seq_len=args.max_seq_len,
                             add_backtrace=bool(args.backtrace)
                             or bool(args.m8))
        if args.m8:
            from .pipeline.dbtools2 import parse_aln_record, _lines
            with open(args.m8, "w") as f:
                for key, payload in mmseqsdb.read_db(args.out_db):
                    for ln in _lines(payload):
                        r = parse_aln_record(ln)
                        f.write(f"{queries.accession(key)}\t"
                                f"{targets.accession(r['dbKey'])}\t"
                                f"{r['seqId']:.3f}\t"
                                f"{max(abs(r['qEnd'] - r['qStart']), abs(r['dbEnd'] - r['dbStart'])) + 1}\t0\t0\t"
                                f"{r['qStart'] + 1}\t{r['qEnd'] + 1}\t"
                                f"{r['dbStart'] + 1}\t{r['dbEnd'] + 1}\t"
                                f"{'%.3E' % r['eval']}\t{r['score']}\n")
        print(f"wrote {args.out_db} (nucleotide search)")
        return 0
    from .io.profiledb import ProfileDB
    if isinstance(targets, ProfileDB):
        from .search.profile_search import ProfileSearchDriver
        hits = ProfileSearchDriver(p, targets, device=device).search(
            query_seqs)
    else:
        driver = SearchDriver(p, targets, device=device)
        if p.prefilter_mode == "ungapped":
            from .search.prefilter import UngappedPrefilter
            pairs = UngappedPrefilter(p, targets, p.min_diag_score,
                                      device=device) \
                .candidate_pairs(query_seqs)
            hits = driver.search(query_seqs, pair_generator=pairs)
        elif p.prefilter_mode == "kmer":
            from .search.prefilter_kmer import ReferenceKmerPrefilter
            pairs = ReferenceKmerPrefilter(p, targets, p.min_diag_score) \
                .candidate_pairs(query_seqs)
            hits = driver.search(query_seqs, pair_generator=pairs)
        else:
            hits = driver.search(query_seqs)
    backtraces = seq_ids = None
    if args.backtrace and not isinstance(targets, ProfileDB):
        backtraces, seq_ids = driver.backtraces(hits, query_seqs)
    mmseqsdb.write_db(args.out_db,
                      hits_to_aln_db_entries(hits, len(queries),
                                             backtraces, seq_ids),
                      mmseqsdb.DBTYPE_ALIGNMENT_RES)
    if args.m8:
        with open(args.m8, "w") as f:
            for hit in hits:
                f.write(hit_to_m8_line(
                    hit, queries.accession(int(hit["orf_idx"])),
                    targets.accession(int(hit["target_idx"]))))
    print(f"wrote {args.out_db}" + (f" + {args.m8}" if args.m8 else ""))
    return 0


def cmd_convertalis(args):
    """Alignment DB -> BLAST-m8 TSV (convertalignments equivalent)."""
    from .io.seqdb import DBTYPE_AA
    from .io import mmseqsdb
    from .pipeline.predict import load_sequence_input, load_target_input

    queries = load_sequence_input(args.queries, DBTYPE_AA)
    targets = load_target_input(args.targets)
    t_acc = {int(k): targets.accession(i)
             for i, k in enumerate(getattr(targets, "keys",
                                           range(len(targets))))}
    with open(args.out_tsv, "w") as f:
        for key, payload in mmseqsdb.read_db(args.aln_db):
            q_acc = queries.accession(queries.id_of_key(key)
                                      if hasattr(queries, "id_of_key")
                                      else key)
            for line in payload.decode().splitlines():
                c = line.split("\t")
                aln_len = max(abs(int(c[5]) - int(c[4])),
                              abs(int(c[8]) - int(c[7]))) + 1
                mismatch = int(round(aln_len * (1.0 - float(c[2]))))
                f.write(f"{q_acc}\t{t_acc[int(c[0])]}\t{c[2]}\t{aln_len}\t"
                        f"{mismatch}\t0\t{int(c[4])+1}\t{int(c[5])+1}\t"
                        f"{int(c[7])+1}\t{int(c[8])+1}\t{c[3]}\t{c[1]}\n")
    print(f"wrote {args.out_tsv}")
    return 0


def cmd_align(args):
    """Standalone alignment module over an existing result DB."""
    from .search.align_module import align_db
    align_db(args.query_db, args.target_db, args.result_db, args.out_db,
             evalue=args.e, add_backtrace=bool(args.a),
             min_seq_id=args.min_seq_id, cov=args.c, cov_mode=args.cov_mode,
             min_aln_len=args.min_aln_len,
             comp_bias_corr=bool(args.comp_bias_corr),
             realign=bool(args.realign), device=_device(args.device))
    print(f"wrote {args.out_db}")
    return 0


def cmd_rbh(args):
    from .search.searchdb import rbh_db
    rbh_db(args.query_db, args.target_db, args.out_db, args.tmp,
           sensitivity=args.s, evalue=args.e, cov=args.c,
           cov_mode=args.cov_mode, min_seq_id=args.min_seq_id,
           max_seqs=args.max_seqs, device=_device(args.device))
    print(f"wrote {args.out_db}")
    return 0


def cmd_map(args):
    from .search.searchdb import map_db
    map_db(args.query_db, args.target_db, args.out_db, args.tmp,
           evalue=args.e, min_seq_id=args.min_seq_id, cov=args.c,
           cov_mode=args.cov_mode, max_seqs=args.max_seqs)
    print(f"wrote {args.out_db}")
    return 0


def cmd_easy_search(args):
    from .search.searchdb import easy_search
    easy_search(args.query, args.target, args.out_m8, args.tmp,
                sensitivity=args.s, evalue=args.e, max_seqs=args.max_seqs,
                min_seq_id=args.min_seq_id, cov=args.c,
                cov_mode=args.cov_mode,
                greedy_best_hits=args.greedy_best_hits,
                device=_device(args.device))
    print(f"wrote {args.out_m8}")
    return 0


def cmd_easy_rbh(args):
    from .search.searchdb import easy_rbh
    easy_rbh(args.query, args.target, args.out_m8, args.tmp,
             sensitivity=args.s, evalue=args.e, cov=args.c,
             cov_mode=args.cov_mode, min_seq_id=args.min_seq_id,
             device=_device(args.device))
    print(f"wrote {args.out_m8}")
    return 0


def cmd_result2rbh(args):
    from .search.searchdb import result2rbh_db
    result2rbh_db(args.in_db, args.out_db)
    print(f"wrote {args.out_db}")
    return 0


def cmd_lcaalign(args):
    from .search.lcaalign import lcaalign_db
    lcaalign_db(args.query_db, args.target_db, args.result_db, args.out_db,
                evalue=args.e, max_accept=args.max_accept,
                max_rejected=args.max_rejected, cov=args.c,
                cov_mode=args.cov_mode, seq_id_thr=args.min_seq_id,
                device=_device(args.device))
    print(f"wrote {args.out_db}")
    return 0


def cmd_summarizealis(args):
    from .tax.taxworkflow import summarizealis_db
    summarizealis_db(args.in_db, args.out_db)
    print(f"wrote {args.out_db}")
    return 0


def cmd_taxcmd(args):
    """Taxonomy module commands (lib/mmseqs/src/taxonomy/)."""
    from .tax import mmtax
    t = args.tool
    if t in ("lca", "majoritylca"):
        mmtax.lca_db(args.args[0], args.args[1], args.args[2],
                     majority=(t == "majoritylca"),
                     lca_ranks=args.lca_ranks, tax_lineage=args.tax_lineage,
                     blacklist=args.blacklist, vote_mode=args.vote_mode,
                     majority_thr=args.majority,
                     compressed=bool(args.compressed))
    elif t == "aggregatetax":
        mmtax.aggregatetax_db(args.args[0], args.args[1], args.args[2],
                              args.args[3], lca_ranks=args.lca_ranks,
                              tax_lineage=args.tax_lineage,
                              vote_mode=args.vote_mode,
                              majority_thr=args.majority,
                              compressed=bool(args.compressed))
    elif t == "aggregatetaxweights":
        mmtax.aggregatetax_db(args.args[0], args.args[1], args.args[2],
                              args.args[4], aln_seq_db=args.args[3],
                              lca_ranks=args.lca_ranks,
                              tax_lineage=args.tax_lineage,
                              vote_mode=args.vote_mode,
                              majority_thr=args.majority,
                              compressed=bool(args.compressed))
    elif t == "addtaxonomy":
        mmtax.addtaxonomy_db(args.args[0], args.args[1], args.args[2],
                             pick_id_from=args.pick_id_from,
                             lca_ranks=args.lca_ranks,
                             tax_lineage=args.tax_lineage,
                             compressed=bool(args.compressed))
    elif t == "filtertaxdb":
        mmtax.filtertaxdb_db(args.args[0], args.args[1], args.args[2],
                             args.taxon_list,
                             compressed=bool(args.compressed))
    elif t == "filtertaxseqdb":
        mmtax.filtertaxseqdb_db(args.args[0], args.args[1], args.taxon_list,
                                subdb_mode=args.subdb_mode)
    elif t == "taxonomyreport":
        mmtax.taxonomyreport_db(args.args[0], args.args[1], args.args[2],
                                report_mode=args.report_mode)
    elif t == "createbintaxonomy":
        mmtax.createbintaxonomy(args.args[0], args.args[1], args.args[2],
                                args.args[3])
    elif t == "createbintaxmapping":
        mmtax.createbintaxmapping(args.args[0], args.args[1])
    elif t == "createdmptaxonomy":
        mmtax.createdmptaxonomy(args.args[0], args.args[1])
    elif t == "createtaxdb":
        mmtax.createtaxdb(args.args[0], args.args[1],
                          ncbi_tax_dump=args.ncbi_tax_dump or None,
                          tax_mapping_file=args.tax_mapping_file or None,
                          tax_mapping_mode=args.tax_mapping_mode,
                          tax_db_mode=args.tax_db_mode)
    else:
        raise SystemExit(f"unknown tax command {t}")
    print(f"{t}: done")
    return 0


def cmd_taxonomy(args):
    """mmseqs taxonomy workflow (protein query branch)."""
    from .tax.taxworkflow import taxonomy_workflow
    taxonomy_workflow(args.query_db, args.target_db, args.out_db, args.tmp,
                      lca_mode=args.lca_mode,
                      tax_output_mode=args.tax_output_mode,
                      sensitivity=args.s, evalue=args.e,
                      max_accept=args.max_accept,
                      max_rejected=args.max_rejected,
                      max_seqs=args.max_seqs, lca_ranks=args.lca_ranks,
                      tax_lineage=args.tax_lineage,
                      blacklist=args.blacklist, vote_mode=args.vote_mode,
                      majority_thr=args.majority,
                      device=_device(args.device))
    print(f"wrote {args.out_db}")
    return 0


def cmd_easy_taxonomy(args):
    from .tax.taxworkflow import easy_taxonomy
    easy_taxonomy(args.query_fasta, args.target_db, args.out_prefix,
                  args.tmp, sensitivity=args.s, evalue=args.e,
                  lca_mode=args.lca_mode, lca_ranks=args.lca_ranks,
                  tax_lineage=args.tax_lineage, majority_thr=args.majority,
                  vote_mode=args.vote_mode, device=_device(args.device))
    print(f"wrote {args.out_prefix}_lca.tsv/_report/_tophit_report/"
          "_tophit_aln")
    return 0


def cmd_msa2profile(args):
    """MSA DB (or one FASTA MSA) -> HMM-profile DB."""
    from .io import mmseqsdb
    from .pipeline.msa2profile import msa_db_to_profile_db

    if pathlib_exists(f"{args.msa_db}.dbtype"):
        entries = [(k, v.decode()) for k, v in mmseqsdb.read_db(args.msa_db)]
    else:
        entries = [(0, open(args.msa_db).read())]
    msa_db_to_profile_db(entries, args.out_db, match_mode=args.match_mode,
                         match_ratio=args.match_ratio,
                         comp_bias_correction=bool(args.comp_bias_corr),
                         filter_msa=bool(args.filter_msa),
                         pcmode=args.pseudo_cnt_mode,
                         context_lib=args.context_lib,
                         msa_type=args.msa_type,
                         skip_query=bool(args.skip_query))
    print(f"wrote {args.out_db} ({len(entries)} profiles)")
    return 0


def cmd_result2profile(args):
    """Alignment-result DB (with backtraces) -> HMM-profile DB."""
    from .pipeline.result2profile import result2profile_db

    eval_profile = min(args.e, args.e_profile)  # reference clamps to evalThr
    result2profile_db(args.query_db, args.target_db, args.aln_db, args.out_db,
                      eval_profile=eval_profile,
                      filter_msa=args.filter_msa,
                      comp_bias_correction=bool(args.comp_bias_corr),
                      mask_profile=bool(args.mask_profile),
                      mask_prob=args.mask_prob,
                      cov_msa_thr=args.cov, qid=args.qid, qsc=args.qsc,
                      filter_max_seq_id=args.max_seq_id, ndiff=args.diff,
                      filter_min_enable=args.filter_min_enable,
                      pcmode=args.pseudo_cnt_mode,
                      context_lib=args.context_lib, wg=bool(args.wg))
    print(f"wrote {args.out_db}")
    return 0


def cmd_profile2pssm(args):
    """HMM-profile DB -> human-readable PSSM table."""
    from .pipeline.profile2pssm import profile2pssm_db
    profile2pssm_db(args.profile_db, args.out, db_out=bool(args.db_output))
    print(f"wrote {args.out}")
    return 0


def cmd_sequence2profile(args):
    from .pipeline.sequence2profile import sequence2profile
    sequence2profile(args.seq_db, args.out_db, args.context_lib,
                     tau=args.tau)
    print("sequence2profile done")
    return 0


def cmd_convertprofiledb(args):
    """HH-suite .hhm text DB -> HMM-profile DB."""
    from .pipeline.convertprofiledb import convertprofiledb
    convertprofiledb(args.hhm_db, args.out_db)
    print(f"wrote {args.out_db}")
    return 0


def cmd_dbtool6(args):
    from .pipeline import dbtools6 as d6
    t, a = args.tool, args.args
    if t in ("profile2consensus", "profile2repseq"):
        d6.profile2seq(a[0], a[1], consensus=(t == "profile2consensus"))
    elif t == "profile2neff":
        d6.profile2neff(a[0], a[1], db_output=bool(args.db_output))
    elif t == "convertmsa":
        d6.convertmsa(a[0], a[1], identifier_field=args.identifier_field)
    elif t == "filtera3m":
        d6.filtera3m(a[0], a[1], cov=args.cov, qid=args.qid, qsc=args.qsc,
                     max_seq_id=args.max_seq_id, ndiff=args.diff,
                     filter_min_enable=args.filter_min_enable)
    elif t == "alignall":
        d6.alignall(a[0], a[1], a[2], evalue=args.e, cov=args.c,
                    cov_mode=args.cov_mode, min_seq_id=args.min_seq_id,
                    device=_device(args.device))
    elif t == "summarizetabs":
        d6.summarizetabs(a[0], a[1], a[2], overlap=args.overlap,
                         cov=args.c, evalue=args.e)
    elif t == "result2dnamsa":
        d6.result2dnamsa(a[0], a[1], a[2], a[3],
                         skip_query=args.skip_query)
    print(f"{t}: done")
    return 0


def cmd_enrich(args):
    from .pipeline.enrich import enrich_workflow
    enrich_workflow(args.query_db, args.target_seq_db,
                    args.target_prof_db, args.target_res_db, args.out_db,
                    args.tmp, num_iterations=args.num_iterations,
                    evalue=args.e, eval_profile=args.e_profile,
                    sensitivity=args.s, device=_device(args.device))
    print(f"wrote {args.out_db}")
    return 0


def cmd_expandaln(args):
    from .pipeline.expand import expandaln_db
    expandaln_db(args.a_db, args.c_db, args.result_ab, args.result_bc,
                 args.out_db, return_aln=not args.profile, evalue=args.e,
                 cov=args.c, cov_mode=args.cov_mode,
                 min_seq_id=args.min_seq_id,
                 expansion_mode=args.expansion_mode)
    print(f"wrote {args.out_db}")
    return 0


def cmd_cluster(args):
    """Cascaded clustering (Cluster.cpp / cascaded_clustering.sh)."""
    import os
    import tempfile
    from .pipeline.clusterwf import cluster_workflow
    from .search.searchdb import _ensure_seqdb

    device = _device(args.device)
    tmp = args.tmp or tempfile.mkdtemp(prefix="cluster")
    os.makedirs(tmp, exist_ok=True)
    seq_db = _ensure_seqdb(args.seqs, f"{tmp}/input")
    cluster_workflow(seq_db, args.out_db, tmp,
                     min_seq_id=args.min_seq_id, cov=args.cov,
                     cov_mode=args.cov_mode, evalue=args.cluster_eval,
                     sensitivity=args.s, steps=args.cluster_steps,
                     device=device)
    print(f"wrote {args.out_db}")
    return 0


def cmd_easy_cluster(args):
    from .pipeline.clusterwf import easy_cluster
    easy_cluster(args.query, args.out_prefix, args.tmp,
                 min_seq_id=args.min_seq_id, cov=args.c,
                 cov_mode=args.cov_mode, evalue=args.e,
                 use_linclust=args.use_linclust,
                 linclust_min_seq_id=args.min_seq_id
                 if args.min_seq_id else 0.9, device=_device(args.device))
    print(f"wrote {args.out_prefix}_cluster.tsv/_rep_seq.fasta/"
          "_all_seqs.fasta")
    return 0


def cmd_kmermatcher(args):
    from .search.kmermatcher import kmermatcher_db
    kmermatcher_db(args.seq_db, args.out_db,
                   kmers_per_seq=args.kmer_per_seq or 20,
                   kmer_size=args.k or None)
    print(f"wrote {args.out_db}")
    return 0


def cmd_linclust(args):
    """Sequence DB -> cluster DB (full byte-parity linclust workflow)."""
    import tempfile
    from .search.kmermatcher import linclust_exact
    device = _device(args.device)
    tmp = args.tmp if args.tmp else tempfile.mkdtemp(prefix="linclust")
    linclust_exact(args.seq_db, args.out_db, tmp,
                   min_seq_id=args.min_seq_id, cov=args.c, device=device)
    print(f"wrote {args.out_db}")
    return 0


def cmd_clust(args):
    from .pipeline.clust import clust_db
    clust_db(args.seq_db, args.result_db, args.out_db)
    print(f"wrote {args.out_db}")
    return 0


def cmd_mergeclusters(args):
    from .pipeline.clust import mergeclusters
    mergeclusters(args.seq_db, args.out_db, args.clusterings)
    print(f"wrote {args.out_db}")
    return 0


def cmd_createlinindex(args):
    from .search.linsearch_lin import build_linindex
    out = build_linindex(args.seq_db, kmer_size=args.k or None)
    print(f"wrote {out}")
    return 0


def cmd_kmersearch(args):
    from .search.linsearch_lin import kmersearch_db
    kmersearch_db(args.query_db, args.index_db, args.out_db,
                  result_direction=args.result_direction)
    print(f"wrote {args.out_db}")
    return 0


def cmd_linsearch(args):
    import tempfile
    from .search.linsearch_lin import linsearch_workflow
    device = _device(args.device)
    tmp = args.tmp or tempfile.mkdtemp(prefix="linsearch")
    linsearch_workflow(args.query_db, args.target_db, args.out_db, tmp,
                       evalue=args.e, cov=args.c,
                       cov_mode=args.cov_mode, min_seq_id=args.min_seq_id,
                       device=device)
    print(f"wrote {args.out_db}")
    return 0


def cmd_easy_linsearch(args):
    from .search.searchdb import easy_linsearch
    easy_linsearch(args.query, args.target, args.out_m8, args.tmp,
                   evalue=args.e, cov=args.c, cov_mode=args.cov_mode,
                   min_seq_id=args.min_seq_id,
                   kmers_per_seq=args.kmer_per_seq,
                   device=_device(args.device))
    print(f"wrote {args.out_m8}")
    return 0


def cmd_pickconsensusrep(args):
    from .pipeline.clusterwf import pickconsensusrep
    pickconsensusrep(args.seq_db, args.clu_db, args.out_db, args.tmp,
                     device=_device(args.device))
    print(f"wrote {args.out_db}")
    return 0


def cmd_clusterupdate(args):
    from .pipeline.clusterwf import clusterupdate
    clusterupdate(args.old_db, args.new_db, args.old_clu,
                  args.new_map_db, args.new_clu, args.tmp,
                  recover_deleted=args.recover_deleted,
                  device=_device(args.device))
    print(f"wrote {args.new_clu}")
    return 0


def cmd_convertca3m(args):
    from .pipeline.ca3m import convertca3m
    convertca3m(args.in_base, args.out_db,
                compressed=bool(args.compressed))
    print(f"wrote {args.out_db}")
    return 0


def cmd_dbtool3(args):
    from .pipeline import dbtools3 as d3
    a = args.args
    t = args.tool
    if t == "result2repseq":
        d3.result2repseq(a[0], a[1], a[2])
    elif t == "masksequence":
        d3.masksequence(a[0], a[1], mask_prob=args.mask_prob)
    elif t == "gff2db":
        d3.gff2db(a[:-2], a[-2], a[-1], gff_type=args.gff_type)
    elif t == "maskbygff":
        d3.maskbygff(a[0], a[1], a[2], gff_type=args.gff_type)
    elif t == "result2stats":
        d3.result2stats(a[0], a[1], args.stat, tsv=args.tsv)
    elif t == "apply":
        d3.apply_cmd(a[0], a[1], a[2:])
    elif t == "diffseqdbs":
        d3.diffseqdbs(a[0], a[1], a[2], a[3], a[4],
                      use_seq_id=args.use_seq_id)
    elif t == "result2msa" and args.msa_format_mode in (0, 1):
        from .pipeline.ca3m import result2msa_ca3m
        result2msa_ca3m(a[0], a[1], a[2], a[3],
                        consensus=args.msa_format_mode == 1)
    elif t == "result2msa":
        from .pipeline.result2msa import result2msa_db
        result2msa_db(a[0], a[1], a[2], a[3],
                      msa_format_mode=args.msa_format_mode,
                      filter_msa=bool(args.filter_msa),
                      skip_query=args.skip_query)
    print(f"{t} done")
    return 0


def cmd_dbtool(args):
    """reverseseq / sortresult / tsv2db / mergedbs / createsubdb."""
    from .pipeline import dbtools
    if args.tool == "reverseseq":
        dbtools.reverseseq(args.args[0], args.args[1])
    elif args.tool == "sortresult":
        dbtools.sortresult(args.args[0], args.args[1])
    elif args.tool == "tsv2db":
        dbtools.tsv2db(args.args[0], args.args[1],
                       output_dbtype=args.output_dbtype)
    elif args.tool == "mergedbs":
        dbtools.mergedbs(args.args[0], args.args[1], args.args[2:],
                         prefixes=args.prefixes.split(",")
                         if args.prefixes else ())
    elif args.tool == "createsubdb":
        keys = [int(x) for x in open(args.args[0]).read().split()]
        dbtools.createsubdb(keys, args.args[1], args.args[2])
    elif args.tool == "extractframes":
        dbtools.extractframes(args.args[0], args.args[1],
                              translate=bool(args.translate))
    elif args.tool == "splitsequence":
        dbtools.splitsequence(args.args[0], args.args[1],
                              max_seq_len=args.max_seq_len,
                              overlap=args.sequence_overlap)
    elif args.tool == "convert2fasta":
        dbtools.convert2fasta(args.args[0], args.args[1])
    print(f"{args.tool} done")
    return 0


def cmd_dbtool2(args):
    """Second util batch (pipeline/dbtools2.py)."""
    from .pipeline import dbtools2 as d2
    a = args.args
    t = args.tool
    if t == "swapdb":
        d2.swapdb(a[0], a[1])
    elif t == "swapresults":
        d2.swapresults(a[0], a[1], a[2], a[3], eval_thr=args.evalue)
    elif t == "prefixid":
        d2.prefixid(a[0], a[1], prefix=args.prefix or None,
                    mapping_db=args.mapping_file or None, tsv=args.tsv)
    elif t == "suffixid":
        d2.prefixid(a[0], a[1], prefix=args.prefix or None,
                    mapping_db=args.mapping_file or None, tsv=args.tsv,
                    is_prefix=False)
    elif t == "subtractdbs":
        d2.subtractdbs(a[0], a[1], a[2],
                       eval_thr=min(args.evalue, args.e_profile))
    elif t == "summarizeresult":
        d2.summarizeresult(a[0], a[1], cov_thr=args.cov,
                           overlap=args.overlap)
    elif t == "result2flat":
        d2.result2flat(a[0], a[1], a[2], a[3],
                       use_header=args.use_fasta_header)
    elif t == "createseqfiledb":
        d2.createseqfiledb(a[0], a[1], a[2], hh_format=args.hh_format)
    elif t == "splitdb":
        d2.splitdb(a[0], a[1], args.split, split_aa=args.split_aa)
    elif t == "orftocontig":
        d2.orftocontig(a[0], a[1], a[2])
    elif t == "renamedbkeys":
        d2.renamedbkeys(a[0], a[1], a[2])
    elif t == "concatdbs":
        d2.concatdbs(a[0], a[1], a[2], preserve_keys_b=args.preserve_keys)
    elif t == "rmdb":
        d2.rmdb(a[0])
    elif t == "mvdb":
        d2.mvdb(a[0], a[1])
    elif t == "cpdb":
        d2.cpdb(a[0], a[1])
    elif t == "lndb":
        d2.lndb(a[0], a[1])
    elif t == "touchdb":
        d2.touchdb(a[0])
    print(f"{t} done")
    return 0


def cmd_dbtool5(args):
    from .pipeline import dbtools5 as d5
    t, a = args.tool, args.args
    if t == "extractalignedregion":
        d5.extractalignedregion(a[0], a[1], a[2], a[3],
                                extract_mode=args.extract_mode)
    elif t == "summarizeheaders":
        d5.summarizeheaders(a[0], a[1], a[2], a[3],
                            header_type=args.header_type,
                            summary_prefix=args.summary_prefix)
    elif t == "clusthash":
        d5.clusthash(a[0], a[1], min_seq_id=args.min_seq_id)
    elif t == "mergeresultsbyset":
        d5.mergeresultsbyset(a[0], a[1], a[2])
    elif t == "makepaddedseqdb":
        d5.makepaddedseqdb(a[0], a[1])
    elif t == "unpackdb":
        d5.unpackdb(a[0], a[1], name_mode=args.unpack_name_mode,
                    suffix=args.unpack_suffix)
    elif t == "countkmer":
        sys.stdout.write(d5.countkmer(a[0], k=args.k))
    elif t == "recoverlongestorf":
        d5.recoverlongestorf(a[0], a[1], a[2])
    elif t == "tar2db":
        d5.tar2db(a[:-1], a[-1], tar_include=args.tar_include,
                  tar_exclude=args.tar_exclude,
                  output_dbtype=args.output_dbtype)
    elif t == "db2tar":
        d5.db2tar(a[0], a[1])
    if t != "countkmer":
        print(f"{t}: done")
    return 0


def cmd_besthitperset(args):
    from .pipeline.multihit import besthitperset
    besthitperset(args.result_db, f"{args.target_db}_member_to_set",
                  f"{args.target_db}_set_size", args.out_db,
                  simple_best_hit=bool(args.simple_best_hit))
    print(f"wrote {args.out_db}")
    return 0


def cmd_combinepvalperset(args):
    from .pipeline.multihit import combinepvalperset
    combinepvalperset(args.result_db, f"{args.query_db}_set_size",
                      f"{args.target_db}_member_to_set",
                      f"{args.target_db}_set_size", args.out_db,
                      alpha=args.alpha, aggregation_mode=args.aggregation_mode)
    print(f"wrote {args.out_db}")
    return 0


def cmd_multihitdb(args):
    from .pipeline.multihit_wf import multihitdb
    multihitdb(args.fasta, args.out_db, args.tmp)
    print(f"wrote {args.out_db}")
    return 0


def cmd_multihitsearch(args):
    from .pipeline.multihit_wf import multihitsearch
    multihitsearch(args.query_db, args.target_db, args.out_db, args.tmp,
                   sensitivity=args.s, evalue=args.e,
                   max_seqs=args.max_seqs, device=_device(args.device))
    print(f"wrote {args.out_db}")
    return 0


def cmd_filterdb(args):
    from .pipeline.filterdb import filterdb
    filterdb(args.in_db, args.out_db, filter_column=args.filter_column,
             filter_regex=args.filter_regex or None,
             filter_file=args.filter_file or None,
             positive_filter=bool(args.positive_filter),
             mapping_file=args.mapping_file or None,
             extract_lines=args.extract_lines,
             comp_operator=args.comparison_operator,
             comp_value=args.comparison_value,
             sort_entries=args.sort_entries, beats_first=args.beats_first,
             join_db=args.join_db or None,
             column_to_take=args.column_to_take,
             filter_expression=args.filter_expression or None,
             trim_to_one_column=args.trim_to_one_column,
             include_identity=bool(args.include_identity))
    print("filterdb done")
    return 0


def cmd_rescorediagonal(args):
    from .pipeline.rescorediagonal import rescorediagonal
    rescorediagonal(args.query_db, args.target_db, args.result_db,
                    args.out_db, rescore_mode=args.rescore_mode,
                    eval_thr=args.e, add_backtrace=bool(args.a))
    print(f"wrote {args.out_db}")
    return 0


def cmd_createindex(args):
    """Build and persist the k-mer target index (createindex artifact)."""
    import numpy as np
    from .data.submat import AA2NUM
    from .io import mmseqsdb
    from .search.prefilter_kmer import KmerPrefilter

    db = mmseqsdb.read_seqdb(args.target_db)
    encs = [AA2NUM[np.asarray(db.seq(i), np.uint8)] for i in range(len(db))]
    pf = KmerPrefilter(encs, sensitivity=args.s,
                       mask_targets=bool(args.mask))
    out = args.out if args.out else f"{args.target_db}.kidx"
    pf.save_index(out)
    print(f"wrote {out} ({len(encs)} targets)")
    return 0


def cmd_prefilter(args):
    """k-mer prefilter: query DB vs target DB -> prefilter result DB."""
    import numpy as np
    import pathlib
    from .data.submat import AA2NUM
    from .io import mmseqsdb
    from .search.prefilter_kmer import KmerPrefilter, hits_to_pref_lines

    def encs(path):
        db = mmseqsdb.read_seqdb(path)
        return [AA2NUM[np.asarray(db.seq(i), np.uint8)]
                for i in range(len(db))], db

    same = args.query_db == args.target_db
    idx = pathlib.Path(f"{args.target_db}.kidx")
    if idx.exists() and args.mask:
        pf = KmerPrefilter(None, sensitivity=args.s,
                           max_res_list_len=args.max_seqs,
                           min_diag_score=args.min_ungapped_score,
                           comp_bias_correction=bool(args.comp_bias_corr),
                           index_path=idx)
        tdb = mmseqsdb.read_seqdb(args.target_db)
        qencs, qdb = encs(args.query_db) if not same else (
            [AA2NUM[np.asarray(tdb.seq(i), np.uint8)]
             for i in range(len(tdb))], tdb)
    else:
        tencs, tdb = encs(args.target_db)
        qencs, qdb = (tencs, tdb) if same else encs(args.query_db)
        pf = KmerPrefilter(tencs, sensitivity=args.s,
                           mask_targets=bool(args.mask),
                           max_res_list_len=args.max_seqs,
                           min_diag_score=args.min_ungapped_score,
                           comp_bias_correction=bool(args.comp_bias_corr))
    entries = []
    for qi, q in enumerate(qencs):
        ids, sc, dg = pf.match(q, identity_id=qi if same else None)
        entries.append((int(qdb.keys[qi]),
                        hits_to_pref_lines(ids, sc, dg).encode()))
    mmseqsdb.write_db(args.out_db, entries, mmseqsdb.DBTYPE_PREFILTER_RES)
    print(f"wrote {args.out_db} ({len(entries)} queries)")
    return 0


def cmd_index_alias(args):
    """indexdb/kmerindexdb: persist the search indexes under the
    reference command names (createindex / createlinindex artifacts)."""
    if args.tool == "indexdb":
        args.target_db = args.args[0]
        args.out = args.args[1]
        args.s = 7.5
        args.mask = 1
        return cmd_createindex(args)
    from .search.linsearch_lin import build_linindex
    build_linindex(args.args[0], f"{args.args[1]}.linidx.npz")
    print(f"wrote {args.args[1]}.linidx.npz")
    return 0


def cmd_nrtotaxmapping(args):
    from .tax.mmtax import nrtotaxmapping
    nrtotaxmapping(args.acc2taxid, args.seq_db, args.out_file)
    print(f"wrote {args.out_file}")
    return 0


def cmd_filterresult(args):
    from .pipeline.result2profile import filterresult_db
    filterresult_db(args.query_db, args.target_db, args.aln_db,
                    args.out_db, include_identity=args.include_identity,
                    cov_msa_thr=args.cov, qid=args.qid, qsc=args.qsc,
                    filter_max_seq_id=args.max_seq_id, ndiff=args.diff,
                    filter_min_enable=args.filter_min_enable)
    print(f"wrote {args.out_db}")
    return 0


def cmd_gpuserver(args):
    """Resident search server (the reference gpuserver role)."""
    from .server import run_server
    sock = args.socket or f"{args.target_db}.tpuserver.sock"
    print(f"serving {args.target_db} on {sock}", flush=True)
    run_server(args.target_db, sock, sensitivity=args.s,
               max_seqs=args.max_seqs,
               mask_targets=bool(args.mask),
               comp_bias_correction=bool(args.comp_bias_corr),
               warmup=bool(args.warmup), device=_device(args.device))
    return 0


def cmd_serverclient(args):
    from .server import client_request
    req = dict(op=args.op, query_db=args.query_db, out_db=args.out_db)
    if args.tmp:
        req["tmp"] = args.tmp
    if args.op == "search":
        req.update(evalue=args.e, add_backtrace=bool(args.a),
                   min_seq_id=args.min_seq_id, cov=args.c,
                   cov_mode=args.cov_mode)
    resp = client_request(args.socket, req)
    if not resp.get("ok"):
        print(f"server error: {resp.get('error')}")
        return 1
    print(f"wrote {args.out_db}" if args.op != "shutdown" else "stopped")
    return 0


def cmd_version(args):
    print(VERSION)
    return 0


def cmd_bench(args):
    from .tools import bench
    return bench.run(args)


def _cmd_offsetaln(args):
    from .pipeline.offsetaln import offsetalignment
    offsetalignment(*args.args, search_type=args.search_type)
    print("offsetalignment done")
    return 0


def _cmd_p2n(args):
    from .pipeline.offsetaln import proteinaln2nucl
    proteinaln2nucl(*args.args)
    print("proteinaln2nucl done")
    return 0


def cmd_dbtool4(args):
    from .pipeline import dbtools4 as d4
    a = args.args
    t = args.tool
    if t == "translateaa":
        d4.translateaa_db(a[0], a[1], translation_table=args.translation_table)
    elif t == "dbtype":
        print(d4.dbtype_name(a[0]))
    elif t == "setextendeddbtype":
        d4.setextendeddbtype(a[0], args.extended_dbtype)
    elif t == "view":
        d4.view(a[0], args.id_list.split(","))
        return 0
    elif t == "aliasdb":
        d4.aliasdb(a[0], a[1])
    elif t == "compress":
        d4.compress_db(a[0], a[1])
    elif t == "decompress":
        d4.decompress_db(a[0], a[1])
    elif t == "diskspaceavail":
        print(d4.diskspaceavail(a[0]) if a else d4.diskspaceavail("."))
        return 0
    return 0


def cmd_dbtool7(args):
    from .pipeline import dbtools7 as d7
    t, a = args.tool, args.args
    if t == "tsv2exprofiledb":
        d7.tsv2exprofiledb(a[0], a[1], compressed=bool(args.compressed))
    elif t == "createclusearchdb":
        d7.createclusearchdb(a[0], a[1], a[2])
    elif t == "transitivealign":
        d7.transitivealign(a[0], a[1], a[2], evalue=args.e, cov=args.c,
                           cov_mode=args.cov_mode,
                           min_seq_id=args.min_seq_id)
    elif t == "msa2result":
        d7.msa2result(a[0], a[1], a[2], match_ratio=args.match_ratio,
                      filter_msa=args.filter_msa)
    print(f"{t}: done")
    return 0


def cmd_dbtool8(args):
    from .pipeline import dbtools8 as d8
    t, a = args.tool, args.args
    if t == "convertkb":
        d8.convertkb(a[:-1], a[-1], kb_columns=args.kb_columns or None,
                     mapping_lookup=args.mapping_file or None)
    elif t == "extractdomains":
        d8.extractdomains(a[0], a[1], a[2], cov=args.c, evalue=args.e)
    elif t == "appenddbtoindex":
        d8.appenddbtoindex(a[:-1], a[-1],
                           keys=args.id_list.split(",")
                           if args.id_list else None)
    elif t == "calculatelambda":
        sys.stdout.write(d8.calculatelambda(a[0]))
        return 0
    print(f"{t}: done")
    return 0


def cmd_databases(args):
    from .pipeline.databases import download, list_table, list_tsv
    if not args.name:
        if args.tsv:
            sys.stdout.write(list_tsv())
        else:
            sys.stdout.write(
                "usage: metaeuk-tpu databases <name> <o:sequenceDB> "
                "<tmpDir> [options]\n\n" + list_table())
        return 0
    if not args.sequence_db or not args.tmp:
        print("databases needs <name> <o:sequenceDB> <tmpDir>")
        return 1
    download(args.name, args.sequence_db, args.tmp,
             local_file=args.local_file or None,
             taxdump_dir=args.ncbi_tax_dump or None,
             tax_mapping=args.tax_mapping_file or None)
    print(f"wrote {args.sequence_db}")
    return 0


def cmd_fwbw(args):
    from .search.fwbw import fwbw_db
    fwbw_db(args.query_db, args.target_db, args.aln_db, args.out_db,
            gap_open=args.fwbw_gapopen, gap_extend=args.fwbw_gapextend,
            temperature=args.temperature, mact=args.mact,
            blocklen=args.blocklen, evalue=args.e, cov=args.c,
            cov_mode=args.cov_mode, min_seq_id=args.min_seq_id)
    print(f"wrote {args.out_db}")
    return 0


def cmd_pairaln(args):
    from .pipeline.pairaln import pairaln_db
    pairaln_db(args.query_db, args.target_db, args.aln_db, args.out_db,
               pairing_mode=args.pairing_mode,
               pairing_filter=args.pairing_filter,
               pairing_dummy_mode=args.pairing_dummy_mode,
               prox_dist=args.pairing_prox_dist)
    print(f"wrote {args.out_db}")
    return 0


def cmd_alignbykmer(args):
    from .search.alignbykmer import alignbykmer_db
    alignbykmer_db(args.query_db, args.target_db, args.result_db,
                   args.out_db, evalue=args.e, cov=args.c,
                   cov_mode=args.cov_mode, min_seq_id=args.min_seq_id,
                   gap_open=args.gap_open, gap_extend=args.gap_extend)
    print(f"wrote {args.out_db}")
    return 0


def cmd_exhaustiveprefilter(args):
    from .search.exhaustive import exhaustive_prefilter
    exhaustive_prefilter(args.query_db, args.target_db, args.out_db,
                         gapped=args.gapped, evalue=args.e,
                         min_ungapped_score=args.min_ungapped_score,
                         max_seqs=args.max_seqs, cov=args.c,
                         cov_mode=args.cov_mode,
                         comp_bias_correction=bool(args.comp_bias_corr))
    print(f"wrote {args.out_db}")
    return 0


def _add_device_flag(p):
    p.add_argument("--device", default="cuda",
                   help="torch device for the alignment (default cuda; "
                        "cpu runs the kernels' plain versions)")


def _add_search_commands(sub):
    """The parsers of the MMseqs2 search family (metaeuk_tpu/cli.py:1771,
    :1839, :1864, :1896, :2354-2410), each that aligns with --device."""
    cd = sub.add_parser("createdb", help="FASTA -> sequence DB")
    cd.add_argument("fasta", nargs="+")
    cd.add_argument("out_db")
    cd.set_defaults(fn=cmd_createdb)

    se = sub.add_parser("search", help="protein search -> alignment DB / m8")
    se.add_argument("queries", help="FASTA or MMseqs DB")
    se.add_argument("targets", help="FASTA, MMseqs DB, or profile DB")
    se.add_argument("out_db")
    se.add_argument("tmp", nargs="?")
    se.add_argument("--m8", default=None, help="also write BLAST-m8 TSV")
    se.add_argument("-a", "--backtrace", action="store_true",
                    help="compute backtraces (alignment mode 3)")
    se.add_argument("--num-iterations", type=int, default=1,
                    help=">1 = iterative profile search (blastpgp role)")
    se.add_argument("--e-profile", type=float, default=0.1)
    se.add_argument("-s", type=float, default=None, dest="s",
                    help="sensitivity (default: Params default; the "
                         "multi-step loop defaults to the mmseqs search "
                         "workflow's 5.7)")
    se.add_argument("--start-sens", type=float, default=4.0,
                    help="start sensitivity of the multi-step search")
    se.add_argument("--sens-steps", type=int, default=1,
                    help=">1 = increasing-sensitivity multi-pass search "
                         "(blastp.sh STEPS loop)")
    _add_device_flag(se)
    _add_predict_flags(se)
    # mmseqs search default -e is 0.001 (metaeuk's predictexons search
    # raises it to 100, PredictExons.cpp:15 — that path sets it itself)
    se.set_defaults(fn=cmd_search, evalue=0.001)

    ca = sub.add_parser("convertalis", help="alignment DB -> BLAST-m8 TSV")
    ca.add_argument("queries")
    ca.add_argument("targets")
    ca.add_argument("aln_db")
    ca.add_argument("out_tsv")
    ca.set_defaults(fn=cmd_convertalis)

    al = sub.add_parser("align", help="alignment module over a result DB")
    al.add_argument("query_db")
    al.add_argument("target_db")
    al.add_argument("result_db")
    al.add_argument("out_db")
    al.add_argument("-e", type=float, default=1e-3)
    al.add_argument("-a", type=int, nargs="?", const=1, default=0)
    al.add_argument("--min-seq-id", type=float, default=0.0)
    al.add_argument("-c", type=float, default=0.0)
    al.add_argument("--cov-mode", type=int, default=0)
    al.add_argument("--min-aln-len", type=int, default=0)
    al.add_argument("--comp-bias-corr", type=int, default=1)
    al.add_argument("--realign", type=int, nargs="?", const=1, default=0)
    _add_device_flag(al)
    al.set_defaults(fn=cmd_align)

    for tool, fn in (("rbh", cmd_rbh), ("map", cmd_map)):
        rp = sub.add_parser(tool, help=f"{tool} workflow")
        rp.add_argument("query_db")
        rp.add_argument("target_db")
        rp.add_argument("out_db")
        rp.add_argument("tmp")
        rp.add_argument("-s", type=float, default=5.7 if tool == "rbh"
                        else 2.0)
        rp.add_argument("-e", type=float, default=1e-3)
        rp.add_argument("-c", type=float,
                        default=0.0 if tool == "rbh" else 0.95)
        rp.add_argument("--cov-mode", type=int,
                        default=0 if tool == "rbh" else 2)
        rp.add_argument("--min-seq-id", type=float,
                        default=0.0 if tool == "rbh" else 0.9)
        rp.add_argument("--max-seqs", type=int, default=300)
        rp.add_argument("--threads", type=int, default=1)
        rp.add_argument("-v", type=int, default=3)
        if tool == "rbh":
            _add_device_flag(rp)
        rp.set_defaults(fn=fn)

    for tool, fn in (("easy-search", cmd_easy_search),
                     ("easy-rbh", cmd_easy_rbh)):
        ep = sub.add_parser(tool, help=f"{tool} workflow (FASTA in, m8 out)")
        ep.add_argument("query", help="FASTA or MMseqs DB")
        ep.add_argument("target", help="FASTA or MMseqs DB")
        ep.add_argument("out_m8")
        ep.add_argument("tmp")
        ep.add_argument("-s", type=float, default=5.7)
        ep.add_argument("-e", type=float, default=1e-3)
        ep.add_argument("-c", type=float, default=0.0)
        ep.add_argument("--cov-mode", type=int, default=0)
        ep.add_argument("--min-seq-id", type=float, default=0.0)
        if tool == "easy-search":
            ep.add_argument("--max-seqs", type=int, default=300)
            ep.add_argument("--greedy-best-hits", action="store_true")
        ep.add_argument("--threads", type=int, default=1)
        ep.add_argument("-v", type=int, default=3)
        _add_device_flag(ep)
        ep.set_defaults(fn=fn)

    r2r = sub.add_parser("result2rbh", help="RBH pairs from a merged "
                         "sorted best-hit DB")
    r2r.add_argument("in_db")
    r2r.add_argument("out_db")
    r2r.set_defaults(fn=cmd_result2rbh)

    la = sub.add_parser("lcaalign", help="accelerated 2bLCA alignment")
    la.add_argument("query_db")
    la.add_argument("target_db")
    la.add_argument("result_db")
    la.add_argument("out_db")
    la.add_argument("-e", type=float, default=1e-3)
    la.add_argument("--max-accept", type=int, default=2 ** 31 - 1)
    la.add_argument("--max-rejected", type=int, default=2 ** 31 - 1)
    la.add_argument("-c", type=float, default=0.0)
    la.add_argument("--cov-mode", type=int, default=0)
    la.add_argument("--min-seq-id", type=float, default=0.0)
    _add_device_flag(la)
    la.set_defaults(fn=cmd_lcaalign)


def _add_modular_commands(sub):
    """The parsers of MetaEuk's modular commands and taxtocontig
    (metaeuk_tpu/cli.py:1519-1565, :1806-1827, :1871-1895), each that
    aligns with --device."""
    pe = sub.add_parser("predictexons",
                        help="contigs + targets -> DP-format predictions DB")
    pe.add_argument("contigs", help="FASTA or MMseqs DB")
    pe.add_argument("targets", help="FASTA or MMseqs DB")
    pe.add_argument("out_db")
    pe.add_argument("tmp", nargs="?")
    _add_device_flag(pe)
    _add_predict_flags(pe)
    pe.set_defaults(fn=cmd_predictexons)

    rr = sub.add_parser("reduceredundancy",
                        help="DP predictions DB -> representatives + clusters")
    rr.add_argument("in_db")
    rr.add_argument("out_db")
    rr.add_argument("clust_db")
    rr.add_argument("--overlap", type=int, default=0)
    rr.set_defaults(fn=cmd_reduceredundancy)

    eo = sub.add_parser("extractorfs",
                        help="six-frame fragments -> nucleotide/AA DB")
    eo.add_argument("contigs")
    eo.add_argument("out_db")
    eo.add_argument("--min-length", type=int, default=30)
    eo.add_argument("--max-length", type=int, default=32734)
    eo.add_argument("--translate", action="store_true")
    eo.set_defaults(fn=cmd_extractorfs)

    tn = sub.add_parser("translatenucs", help="nucleotide DB -> AA DB")
    tn.add_argument("in_db")
    tn.add_argument("out_db")
    tn.add_argument("--translation-table", type=int, default=1)
    tn.set_defaults(fn=cmd_translatenucs)

    uf = sub.add_parser("unitesetstofasta",
                        help="representative predictions DB -> FASTA/GFF")
    uf.add_argument("contigs")
    uf.add_argument("targets")
    uf.add_argument("preds_db")
    uf.add_argument("out_prefix")
    _add_device_flag(uf)
    _add_predict_flags(uf)
    uf.set_defaults(fn=cmd_unitesetstofasta)

    ga = sub.add_parser("groupstoacc", help="cluster map DB -> accession TSV")
    ga.add_argument("contigs")
    ga.add_argument("targets")
    ga.add_argument("clust_db")
    ga.add_argument("out_tsv")
    ga.set_defaults(fn=cmd_groupstoacc)

    rc = sub.add_parser("resultspercontig",
                        help="swap fragment-vs-target results to contig keys")
    rc.add_argument("contigs_db")
    rc.add_argument("fragments_db")
    rc.add_argument("aln_db")
    rc.add_argument("out_db")
    rc.set_defaults(fn=cmd_resultspercontig)

    co = sub.add_parser("collectoptimalset",
                        help="exon-chaining DP per contig/target/strand")
    co.add_argument("contig_res_db")
    co.add_argument("targets_db")
    co.add_argument("out_db")
    co.add_argument("--metaeuk-eval", type=float, default=0.001)
    co.add_argument("--metaeuk-tcov", type=float, default=0.5)
    co.add_argument("--min-intron", type=int, default=15)
    co.add_argument("--max-intron", type=int, default=10000)
    co.add_argument("--max-overlap", type=int, default=10)
    co.add_argument("--set-gap-open", type=int, default=-1)
    co.add_argument("--set-gap-extend", type=int, default=-1)
    co.set_defaults(fn=cmd_collectoptimalset)

    ct = sub.add_parser("createtsv", help="DB + headers -> TSV")
    ct.add_argument("seq_db")
    ct.add_argument("data_db")
    ct.add_argument("out_tsv")
    ct.set_defaults(fn=cmd_createtsv)

    tc = sub.add_parser("taxtocontig",
                        help="assign taxonomy to predictions and contigs")
    tc.add_argument("preds_fasta")
    tc.add_argument("headers_map")
    tc.add_argument("targets", help="taxonomy-annotated target FASTA")
    tc.add_argument("mapping", help="TSV: target accession -> taxid")
    tc.add_argument("names_dmp")
    tc.add_argument("nodes_dmp")
    tc.add_argument("out_base")
    tc.add_argument("--merged-dmp", default=None)
    tc.add_argument("--contigs", default=None,
                    help="contigs FASTA/DB for per-contig TSV accessions")
    tc.add_argument("--majority", type=float, default=0.5)
    tc.add_argument("--vote-mode", type=int, default=1)
    tc.add_argument("--lca-mode", choices=["top-hit", "approx-2blca", "lca"],
                    default="approx-2blca")
    tc.add_argument("-e", "--evalue", type=float, default=1.0)
    _add_device_flag(tc)
    tc.set_defaults(fn=cmd_taxtocontig)


def _add_tax_commands(sub):
    """The parsers of the taxonomy module's commands, taxonomy,
    easy-taxonomy and summarizealis (metaeuk_tpu/cli.py:1960-2012,
    :2412-2416); taxonomy and easy-taxonomy with --device."""
    for tool, nargs_ in (("lca", 3), ("majoritylca", 3),
                         ("aggregatetax", 4), ("aggregatetaxweights", 5),
                         ("addtaxonomy", 3), ("filtertaxdb", 3),
                         ("filtertaxseqdb", 2), ("taxonomyreport", 3),
                         ("createbintaxonomy", 4),
                         ("createbintaxmapping", 2),
                         ("createdmptaxonomy", 2), ("createtaxdb", 2)):
        tp = sub.add_parser(tool, help=f"{tool} taxonomy command")
        tp.add_argument("args", nargs=nargs_)
        tp.add_argument("--lca-ranks", type=str, default="")
        tp.add_argument("--tax-lineage", type=int, default=0)
        tp.add_argument("--blacklist", type=str,
                        default="12908:unclassified sequences,"
                                "28384:other sequences")
        tp.add_argument("--vote-mode", type=int, default=1)
        tp.add_argument("--majority", type=float, default=0.5)
        tp.add_argument("--pick-id-from", type=int, default=2)
        tp.add_argument("--taxon-list", type=str, default="")
        tp.add_argument("--subdb-mode", type=int, default=0)
        tp.add_argument("--report-mode", type=int, default=0)
        tp.add_argument("--ncbi-tax-dump", type=str, default="")
        tp.add_argument("--tax-mapping-file", type=str, default="")
        tp.add_argument("--tax-mapping-mode", type=int, default=0)
        tp.add_argument("--tax-db-mode", type=int, default=1)
        tp.add_argument("--compressed", type=int, default=0)
        tp.add_argument("--threads", type=int, default=1)
        tp.add_argument("-v", type=int, default=3)
        tp.set_defaults(fn=cmd_taxcmd, tool=tool)

    for tool, fn in (("taxonomy", cmd_taxonomy),
                     ("easy-taxonomy", cmd_easy_taxonomy)):
        tx = sub.add_parser(tool, help=f"{tool} workflow")
        if tool == "taxonomy":
            tx.add_argument("query_db")
            tx.add_argument("target_db")
            tx.add_argument("out_db")
        else:
            tx.add_argument("query_fasta")
            tx.add_argument("target_db")
            tx.add_argument("out_prefix")
        tx.add_argument("tmp")
        tx.add_argument("-s", type=float, default=2.0)
        tx.add_argument("-e", type=float, default=1.0)
        tx.add_argument("--max-accept", type=int, default=30)
        tx.add_argument("--max-rejected", type=int, default=5)
        tx.add_argument("--max-seqs", type=int, default=300)
        tx.add_argument("--lca-mode", type=int, default=3,
                        help="3 approx-2bLCA, 4 top-hit")
        tx.add_argument("--tax-output-mode", type=int, default=0)
        tx.add_argument("--lca-ranks", type=str, default="")
        tx.add_argument("--tax-lineage", type=int, default=0)
        tx.add_argument("--blacklist", type=str, default=None)
        tx.add_argument("--vote-mode", type=int, default=1)
        tx.add_argument("--majority", type=float, default=0.5)
        tx.add_argument("--threads", type=int, default=1)
        tx.add_argument("-v", type=int, default=3)
        _add_device_flag(tx)
        tx.set_defaults(fn=fn)

    sa = sub.add_parser("summarizealis",
                        help="per-query alignment summary stats")
    sa.add_argument("in_db")
    sa.add_argument("out_db")
    sa.set_defaults(fn=cmd_summarizealis)


def _add_profile_commands(sub):
    """The parsers of the profile tools (metaeuk_tpu/cli.py:1598-1642,
    :1794-1804, :1828-1837, :2046-2077, :2159, :2274-2288); alignall and
    enrich with --device, the rest host-only."""
    mp = sub.add_parser("msa2profile", help="MSA DB/FASTA -> HMM-profile DB")
    mp.add_argument("msa_db")
    mp.add_argument("out_db")
    mp.add_argument("--match-mode", type=int, default=0, choices=[0, 1])
    mp.add_argument("--match-ratio", type=float, default=0.5)
    mp.add_argument("--filter-msa", type=int, default=1,
                    help="reference default: filter the MSA before "
                         "profile computation")
    mp.add_argument("--comp-bias-corr", type=int, default=1)
    mp.add_argument("--pseudo-cnt-mode", type=int, default=0, choices=[0, 1])
    mp.add_argument("--context-lib", default=None,
                    help="CRF context library file (required for "
                         "--pseudo-cnt-mode 1)")
    mp.add_argument("--msa-type", type=int, default=2, choices=[1, 2],
                    help="1 = A3M (lowercase insert states skipped, "
                         "ss_ entries dropped — the PDB70 chain)")
    mp.add_argument("--skip-query", action="store_true",
                    help="drop the first MSA record (the CDD chain)")
    mp.set_defaults(fn=cmd_msa2profile)

    rp = sub.add_parser("result2profile",
                        help="alignment DB (-a) -> HMM-profile DB")
    rp.add_argument("query_db")
    rp.add_argument("target_db")
    rp.add_argument("aln_db")
    rp.add_argument("out_db")
    rp.add_argument("-e", type=float, default=1e-3)
    rp.add_argument("--e-profile", type=float, default=1e-3)
    rp.add_argument("--filter-msa", type=int, default=1)
    rp.add_argument("--comp-bias-corr", type=int, default=1)
    rp.add_argument("--mask-profile", type=int, default=1)
    rp.add_argument("--mask-prob", type=float, default=0.9)
    rp.add_argument("--cov", type=float, default=0.0)
    rp.add_argument("--qid", type=str, default="0.0")
    rp.add_argument("--qsc", type=float, default=-20.0)
    rp.add_argument("--max-seq-id", type=float, default=0.9)
    rp.add_argument("--diff", type=int, default=1000)
    rp.add_argument("--filter-min-enable", type=int, default=0)
    rp.add_argument("--pseudo-cnt-mode", type=int, default=0, choices=[0, 1])
    rp.add_argument("--wg", type=int, default=0,
                    help="global sequence weighting for profiles")
    rp.add_argument("--context-lib", default=None,
                    help="CRF context library file (required for "
                         "--pseudo-cnt-mode 1)")
    rp.set_defaults(fn=cmd_result2profile)

    pp = sub.add_parser("profile2pssm", help="profile DB -> PSSM table")
    pp.add_argument("profile_db")
    pp.add_argument("out")
    pp.add_argument("--db-output", type=int, default=0)
    pp.set_defaults(fn=cmd_profile2pssm)

    cv = sub.add_parser("convertprofiledb",
                        help="HH-suite .hhm DB -> profile DB")
    cv.add_argument("hhm_db")
    cv.add_argument("out_db")
    cv.set_defaults(fn=cmd_convertprofiledb)

    s2 = sub.add_parser("sequence2profile",
                        help="sequence DB -> context-specific profile DB")
    s2.add_argument("seq_db")
    s2.add_argument("out_db")
    s2.add_argument("--context-lib", required=True,
                    help="CRF context library file (the reference bakes "
                         "K4000.crf into the binary; that blob is a "
                         "missing LFS object upstream)")
    s2.add_argument("--tau", type=float, default=0.9)
    s2.set_defaults(fn=cmd_sequence2profile)

    d6_tools = {
        "profile2consensus": 2, "profile2repseq": 2, "profile2neff": 2,
        "convertmsa": 2, "filtera3m": 2, "alignall": 3,
        "summarizetabs": 3, "result2dnamsa": 4,
    }
    for tool, nargs in d6_tools.items():
        dp6 = sub.add_parser(tool, help=f"{tool} utility")
        dp6.add_argument("args", nargs=nargs)
        if tool == "profile2neff":
            dp6.add_argument("--db-output", type=int, default=0)
        elif tool == "convertmsa":
            dp6.add_argument("--identifier-field", type=int, default=1)
        elif tool == "filtera3m":
            dp6.add_argument("--cov", type=float, default=0.0)
            dp6.add_argument("--qid", type=str, default="0.0")
            dp6.add_argument("--qsc", type=float, default=-20.0)
            dp6.add_argument("--max-seq-id", type=float, default=0.9)
            dp6.add_argument("--diff", type=int, default=1000)
            dp6.add_argument("--filter-min-enable", type=int, default=0)
        elif tool == "alignall":
            dp6.add_argument("-e", type=float, default=1e-3)
            dp6.add_argument("-c", type=float, default=0.0)
            dp6.add_argument("--cov-mode", type=int, default=0)
            dp6.add_argument("--min-seq-id", type=float, default=0.0)
            _add_device_flag(dp6)
        elif tool == "summarizetabs":
            dp6.add_argument("--overlap", type=float, default=0.0)
            dp6.add_argument("-c", type=float, default=0.0)
            dp6.add_argument("-e", type=float, default=0.001)
        elif tool == "result2dnamsa":
            dp6.add_argument("--skip-query", action="store_true")
        dp6.add_argument("--threads", type=int, default=1)
        dp6.add_argument("-v", type=int, default=3)
        dp6.set_defaults(fn=cmd_dbtool6, tool=tool)

    en = sub.add_parser("enrich", help="boost search-result diversity "
                        "through target profiles (the reference's "
                        "6-path enrich.sh contract)")
    en.add_argument("query_db")
    en.add_argument("target_seq_db")
    en.add_argument("target_prof_db")
    en.add_argument("target_res_db")
    en.add_argument("out_db")
    en.add_argument("tmp")
    en.add_argument("--num-iterations", type=int, default=3)
    en.add_argument("-e", type=float, default=0.001)
    en.add_argument("--e-profile", type=float, default=0.1)
    en.add_argument("-s", type=float, default=4.0)
    en.add_argument("--threads", type=int, default=1)
    en.add_argument("-v", type=int, default=3)
    _add_device_flag(en)
    en.set_defaults(fn=cmd_enrich)

    for tool in ("expandaln", "expand2profile"):
        ex = sub.add_parser(tool, help=f"{tool}: A->B + B->C -> A->C")
        ex.add_argument("a_db")
        ex.add_argument("c_db")
        ex.add_argument("result_ab")
        ex.add_argument("result_bc")
        ex.add_argument("out_db")
        ex.add_argument("-e", type=float, default=1e-3)
        ex.add_argument("-c", type=float, default=0.0)
        ex.add_argument("--cov-mode", type=int, default=0)
        ex.add_argument("--min-seq-id", type=float, default=0.0)
        ex.add_argument("--expansion-mode", type=int, default=0)
        ex.add_argument("--threads", type=int, default=1)
        ex.add_argument("-v", type=int, default=3)
        ex.set_defaults(fn=cmd_expandaln, profile=(tool == "expand2profile"))


def _add_cluster_commands(sub):
    """The parsers of the clustering and linear-search family and the
    dbtools3 commands (metaeuk_tpu/cli.py:1567-1596, :1677-1689,
    :1740-1760, :1910-1955, :2176-2184, :2242-2265, :2341-2349); cluster,
    easy-cluster, easy-linclust, linclust, linsearch, easy-linsearch,
    pickconsensusrep and clusterupdate with --device, the rest host-only."""
    cl = sub.add_parser("cluster", help="cascaded clustering workflow")
    cl.add_argument("seqs", help="FASTA or MMseqs DB")
    cl.add_argument("out_db")
    cl.add_argument("tmp", nargs="?")
    cl.add_argument("--min-seq-id", type=float, default=0.0)
    cl.add_argument("-c", "--cov", type=float, default=0.8)
    cl.add_argument("--cov-mode", type=int, default=0)
    cl.add_argument("-e", "--cluster-eval", type=float, default=1e-3)
    cl.add_argument("-s", type=float, default=None,
                    help="sensitivity (default: from --min-seq-id)")
    cl.add_argument("--cluster-steps", type=int, default=None)
    cl.add_argument("--threads", type=int, default=1)
    cl.add_argument("-v", type=int, default=3)
    _add_device_flag(cl)
    cl.set_defaults(fn=cmd_cluster)

    for tool in ("easy-cluster", "easy-linclust"):
        ec = sub.add_parser(tool, help=f"{tool}: FASTA -> cluster.tsv + "
                            "rep/all FASTAs")
        ec.add_argument("query", help="FASTA or MMseqs DB")
        ec.add_argument("out_prefix")
        ec.add_argument("tmp")
        ec.add_argument("--min-seq-id", type=float,
                        default=0.0 if tool == "easy-cluster" else 0.9)
        ec.add_argument("-c", type=float, default=0.8)
        ec.add_argument("--cov-mode", type=int, default=0)
        ec.add_argument("-e", type=float, default=1e-3)
        ec.add_argument("--threads", type=int, default=1)
        ec.add_argument("-v", type=int, default=3)
        _add_device_flag(ec)
        ec.set_defaults(fn=cmd_easy_cluster,
                        use_linclust=(tool == "easy-linclust"))

    for tool in ("result2repseq", "masksequence", "gff2db", "maskbygff",
                 "result2stats", "apply", "diffseqdbs", "result2msa"):
        dt = sub.add_parser(tool, help=f"{tool} DB utility")
        dt.add_argument("args", nargs="+")
        dt.add_argument("--mask-prob", type=float, default=0.9)
        dt.add_argument("--gff-type", type=str, default="")
        dt.add_argument("--stat", type=str, default="linecount")
        dt.add_argument("--tsv", action="store_true")
        dt.add_argument("--use-seq-id", action="store_true")
        dt.add_argument("--msa-format-mode", type=int, default=2)
        dt.add_argument("--filter-msa", type=int, default=0)
        dt.add_argument("--skip-query", action="store_true")
        dt.set_defaults(fn=cmd_dbtool3, tool=tool)

    km = sub.add_parser("kmermatcher", help="hash-selected k-mer grouping")
    km.add_argument("seq_db")
    km.add_argument("out_db")
    km.add_argument("--kmer-per-seq", type=int, default=0)
    km.add_argument("-k", type=int, default=0)
    km.set_defaults(fn=cmd_kmermatcher)

    lc = sub.add_parser("linclust", help="linear-time clustering")
    lc.add_argument("seq_db")
    lc.add_argument("out_db")
    lc.add_argument("tmp", nargs="?", default=None)
    lc.add_argument("--min-seq-id", type=float, default=0.9)
    lc.add_argument("-c", type=float, default=0.8)
    _add_device_flag(lc)
    lc.set_defaults(fn=cmd_linclust)

    cu = sub.add_parser("clust", help="set-cover clustering of a result DB")
    cu.add_argument("seq_db")
    cu.add_argument("result_db")
    cu.add_argument("out_db")
    cu.set_defaults(fn=cmd_clust)

    mc = sub.add_parser("mergeclusters",
                        help="splice cascaded clustering steps")
    mc.add_argument("seq_db")
    mc.add_argument("out_db")
    mc.add_argument("clusterings", nargs="+")
    mc.set_defaults(fn=cmd_mergeclusters)

    li = sub.add_parser("createlinindex", help="build the linear k-mer index")
    li.add_argument("seq_db")
    li.add_argument("tmp", nargs="?")
    li.add_argument("-k", type=int, default=0)
    li.set_defaults(fn=cmd_createlinindex)

    ks = sub.add_parser("kmersearch",
                        help="query DB x lin-index -> prefilter DB")
    ks.add_argument("query_db")
    ks.add_argument("index_db")
    ks.add_argument("out_db")
    ks.add_argument("--result-direction", type=int, default=1)
    ks.set_defaults(fn=cmd_kmersearch)

    ls = sub.add_parser("linsearch", help="linear-time search workflow")
    ls.add_argument("query_db")
    ls.add_argument("target_db")
    ls.add_argument("out_db")
    ls.add_argument("tmp", nargs="?")
    ls.add_argument("-e", type=float, default=0.001)
    ls.add_argument("-c", type=float, default=0.0)
    ls.add_argument("--cov-mode", type=int, default=None)
    ls.add_argument("--min-seq-id", type=float, default=0.0)
    _add_device_flag(ls)
    ls.set_defaults(fn=cmd_linsearch)

    cc = sub.add_parser("convertca3m", help="expand a compressed-A3M "
                        "DB to alignment results")
    cc.add_argument("in_base")
    cc.add_argument("out_db")
    cc.add_argument("--compressed", type=int, default=0)
    cc.add_argument("--threads", type=int, default=1)
    cc.add_argument("-v", type=int, default=3)
    cc.set_defaults(fn=cmd_convertca3m)

    pcr = sub.add_parser("pickconsensusrep",
                         help="re-pick cluster representatives by "
                         "profile consensus score")
    pcr.add_argument("seq_db")
    pcr.add_argument("clu_db")
    pcr.add_argument("out_db")
    pcr.add_argument("tmp")
    pcr.add_argument("-v", type=int, default=3)
    _add_device_flag(pcr)
    pcr.set_defaults(fn=cmd_pickconsensusrep)

    cu = sub.add_parser("clusterupdate", help="update a clustering with "
                        "a new sequence DB")
    cu.add_argument("old_db")
    cu.add_argument("new_db")
    cu.add_argument("old_clu")
    cu.add_argument("new_map_db")
    cu.add_argument("new_clu")
    cu.add_argument("tmp")
    cu.add_argument("--recover-deleted", action="store_true")
    cu.add_argument("--threads", type=int, default=1)
    cu.add_argument("-v", type=int, default=3)
    _add_device_flag(cu)
    cu.set_defaults(fn=cmd_clusterupdate)

    el2 = sub.add_parser("easy-linsearch",
                         help="FASTA in, linear search, m8 out")
    el2.add_argument("query")
    el2.add_argument("target")
    el2.add_argument("out_m8")
    el2.add_argument("tmp")
    el2.add_argument("-e", type=float, default=1e-3)
    el2.add_argument("-c", type=float, default=0.0)
    el2.add_argument("--cov-mode", type=int, default=0)
    el2.add_argument("--min-seq-id", type=float, default=0.0)
    el2.add_argument("--kmer-per-seq", type=int, default=21)
    _add_device_flag(el2)
    el2.set_defaults(fn=cmd_easy_linsearch)


def _add_db_commands(sub):
    """The parsers of the host-only DB utilities over modules the port
    carries, and of the multihit family (metaeuk_tpu/cli.py:1644-1675,
    :1691-1709, :1722-1738, :1747-1755, :1776-1792, :2018-2044, :2235-2240,
    :2265-2273, :2290-2324, :2418); multihitsearch with --device."""
    for tool in ("reverseseq", "sortresult", "tsv2db", "mergedbs",
                 "createsubdb", "extractframes", "splitsequence",
                 "convert2fasta"):
        dt = sub.add_parser(tool, help=f"{tool} DB utility")
        dt.add_argument("args", nargs="+")
        dt.add_argument("--output-dbtype", type=int, default=12)
        dt.add_argument("--prefixes", type=str, default="")
        dt.add_argument("--translate", type=int, default=0)
        dt.add_argument("--max-seq-len", type=int, default=10000)
        dt.add_argument("--sequence-overlap", type=int, default=300)
        dt.set_defaults(fn=cmd_dbtool, tool=tool)

    for tool in ("swapdb", "swapresults", "prefixid", "suffixid",
                 "subtractdbs", "summarizeresult", "result2flat",
                 "createseqfiledb", "splitdb", "orftocontig",
                 "renamedbkeys", "concatdbs", "rmdb", "mvdb", "cpdb",
                 "lndb", "touchdb"):
        dt = sub.add_parser(tool, help=f"{tool} DB utility")
        dt.add_argument("args", nargs="+")
        dt.add_argument("-e", "--evalue", type=float, default=0.001)
        dt.add_argument("--e-profile", type=float, default=0.1)
        dt.add_argument("--prefix", type=str, default="")
        dt.add_argument("--mapping-file", type=str, default="")
        dt.add_argument("--tsv", action="store_true")
        dt.add_argument("-c", "--cov", type=float, default=0.0)
        dt.add_argument("--overlap", type=float, default=0.0)
        dt.add_argument("--use-fasta-header", action="store_true")
        dt.add_argument("--hh-format", action="store_true")
        dt.add_argument("--split", type=int, default=2)
        dt.add_argument("--split-aa", action="store_true")
        dt.add_argument("--preserve-keys", action="store_true")
        dt.set_defaults(fn=cmd_dbtool2, tool=tool)

    fd = sub.add_parser("filterdb", help="filter result-DB lines")
    fd.add_argument("in_db")
    fd.add_argument("out_db")
    fd.add_argument("--filter-column", type=int, default=1)
    fd.add_argument("--filter-regex", type=str, default="")
    fd.add_argument("--filter-file", type=str, default="")
    fd.add_argument("--positive-filter", type=int, default=1)
    fd.add_argument("--mapping-file", type=str, default="")
    fd.add_argument("--extract-lines", type=int, default=0)
    fd.add_argument("--comparison-operator", type=str, default="")
    fd.add_argument("--comparison-value", type=float, default=0.0)
    fd.add_argument("--sort-entries", type=int, default=0)
    fd.add_argument("--beats-first", action="store_true")
    fd.add_argument("--join-db", type=str, default="")
    fd.add_argument("--column-to-take", type=int, default=-1)
    fd.add_argument("--filter-expression", type=str, default="")
    fd.add_argument("--trim-to-one-column", action="store_true")
    fd.add_argument("--include-identity", type=int, default=0)
    fd.set_defaults(fn=cmd_filterdb)

    bh = sub.add_parser("besthitperset", help="best hit per target set")
    bh.add_argument("query_db")
    bh.add_argument("target_db")
    bh.add_argument("result_db")
    bh.add_argument("out_db")
    bh.add_argument("--simple-best-hit", type=int, default=1)
    bh.set_defaults(fn=cmd_besthitperset)

    cp = sub.add_parser("combinepvalperset",
                        help="combined p-value per target set")
    cp.add_argument("query_db")
    cp.add_argument("target_db")
    cp.add_argument("result_db")
    cp.add_argument("out_db")
    cp.add_argument("--alpha", type=float, default=1.0)
    cp.add_argument("--aggregation-mode", type=int, default=0)
    cp.set_defaults(fn=cmd_combinepvalperset)

    rd = sub.add_parser("rescorediagonal", help="ungapped diagonal rescore")
    rd.add_argument("query_db")
    rd.add_argument("target_db")
    rd.add_argument("result_db")
    rd.add_argument("out_db")
    rd.add_argument("--rescore-mode", type=int, default=0)
    rd.add_argument("-e", type=float, default=1e-3)
    rd.add_argument("-a", type=int, default=0)
    rd.set_defaults(fn=cmd_rescorediagonal)

    ci = sub.add_parser("createindex", help="persist the k-mer target index")
    ci.add_argument("target_db")
    ci.add_argument("--out", default="")
    ci.add_argument("-s", type=float, default=4.0)
    ci.add_argument("--mask", type=int, default=1)
    ci.set_defaults(fn=cmd_createindex)

    pr = sub.add_parser("prefilter", help="k-mer prefilter -> result DB")
    pr.add_argument("query_db")
    pr.add_argument("target_db")
    pr.add_argument("out_db")
    pr.add_argument("-s", type=float, default=4.0)
    pr.add_argument("--mask", type=int, default=1)
    pr.add_argument("--max-seqs", type=int, default=300)
    pr.add_argument("--min-ungapped-score", type=int, default=15)
    pr.add_argument("--comp-bias-corr", type=int, default=1)
    pr.set_defaults(fn=cmd_prefilter)

    d5_tools = {
        "extractalignedregion": 4, "summarizeheaders": 4, "clusthash": 2,
        "mergeresultsbyset": 3, "makepaddedseqdb": 2, "unpackdb": 2,
        "countkmer": 1, "recoverlongestorf": 3, "tar2db": 2, "db2tar": 2,
    }
    for tool, nargs in d5_tools.items():
        dp5 = sub.add_parser(tool, help=f"{tool} DB utility")
        dp5.add_argument("args", nargs="+" if tool == "tar2db" else nargs)
        if tool == "extractalignedregion":
            dp5.add_argument("--extract-mode", type=int, default=2)
        elif tool == "summarizeheaders":
            dp5.add_argument("--header-type", type=int, default=1)
            dp5.add_argument("--summary-prefix", type=str, default="cl")
        elif tool == "clusthash":
            dp5.add_argument("--min-seq-id", type=float, default=0.99)
        elif tool == "unpackdb":
            dp5.add_argument("--unpack-name-mode", type=int, default=1)
            dp5.add_argument("--unpack-suffix", type=str, default="")
        elif tool == "countkmer":
            dp5.add_argument("-k", type=int, default=5)
        elif tool == "tar2db":
            dp5.add_argument("--tar-include", type=str, default=".*")
            dp5.add_argument("--tar-exclude", type=str, default="^$")
            dp5.add_argument("--output-dbtype", type=int, default=12)
        dp5.add_argument("--threads", type=int, default=1)
        dp5.add_argument("-v", type=int, default=3)
        dp5.set_defaults(fn=cmd_dbtool5, tool=tool)

    for tool in ("indexdb", "kmerindexdb"):
        ia = sub.add_parser(tool, help=f"{tool}: persist the search index")
        ia.add_argument("args", nargs=2)
        ia.add_argument("--threads", type=int, default=1)
        ia.add_argument("-v", type=int, default=3)
        ia.set_defaults(fn=cmd_index_alias, tool=tool)

    ntm = sub.add_parser("nrtotaxmapping", help="taxid mapping from NR "
                         "headers + accession2taxid files")
    ntm.add_argument("acc2taxid", nargs="+")
    ntm.add_argument("seq_db")
    ntm.add_argument("out_file")
    ntm.add_argument("--threads", type=int, default=1)
    ntm.add_argument("-v", type=int, default=3)
    ntm.set_defaults(fn=cmd_nrtotaxmapping)

    mhd = sub.add_parser("multihitdb", help="set FASTAs -> multihit DB")
    mhd.add_argument("fasta", nargs="+")
    mhd.add_argument("out_db")
    mhd.add_argument("tmp")
    mhd.add_argument("--threads", type=int, default=1)
    mhd.add_argument("-v", type=int, default=3)
    mhd.set_defaults(fn=cmd_multihitdb)

    mhs = sub.add_parser("multihitsearch",
                         help="multihit query vs multihit target")
    mhs.add_argument("query_db")
    mhs.add_argument("target_db")
    mhs.add_argument("out_db")
    mhs.add_argument("tmp")
    mhs.add_argument("-s", type=float, default=5.7)
    mhs.add_argument("-e", type=float, default=1e-3)
    mhs.add_argument("--max-seqs", type=int, default=300)
    mhs.add_argument("--threads", type=int, default=1)
    mhs.add_argument("-v", type=int, default=3)
    _add_device_flag(mhs)
    mhs.set_defaults(fn=cmd_multihitsearch)

    fr = sub.add_parser("filterresult", help="MsaFilter over a result DB")
    fr.add_argument("query_db")
    fr.add_argument("target_db")
    fr.add_argument("aln_db")
    fr.add_argument("out_db")
    fr.add_argument("--include-identity", action="store_true")
    fr.add_argument("--cov", type=float, default=0.0)
    fr.add_argument("--qid", type=str, default="0.0")
    fr.add_argument("--qsc", type=float, default=-20.0)
    fr.add_argument("--max-seq-id", type=float, default=0.9)
    fr.add_argument("--diff", type=int, default=1000)
    fr.add_argument("--filter-min-enable", type=int, default=0)
    fr.set_defaults(fn=cmd_filterresult)

    vs = sub.add_parser("version", help="print version")
    vs.set_defaults(fn=cmd_version)

    bn = sub.add_parser("bench", help="easy-predict contigs/s, the SW "
                        "kernels' selftest and their device cells/s")
    bn.add_argument("--selftest", action="store_true",
                    help="only the full selftest of K1-K6; exit 1 on any "
                         "mismatch")
    bn.add_argument("--no-ref", action="store_true",
                    help="skip the reference binary's runs and parity")
    bn.add_argument("--no-selftest", action="store_true",
                    help="skip the light selftest of the main run")
    _add_device_flag(bn)
    bn.set_defaults(fn=cmd_bench)


def _add_util_commands(sub):
    """The parsers of the host-only DB utilities of dbtools4, dbtools7 and
    dbtools8, databases, offsetalignment, proteinaln2nucl, fwbw, pairaln,
    alignbykmer and the exhaustive prefilters (metaeuk_tpu/cli.py:1711-1720,
    :1924-1931, :2079-2112, :2145-2156, :2185-2233, :2325-2339)."""
    oa = sub.add_parser("offsetalignment",
                        help="ORF coords -> source coords")
    oa.add_argument("args", nargs=6)
    oa.add_argument("--search-type", type=int, default=0)
    oa.set_defaults(fn=_cmd_offsetaln)

    pn = sub.add_parser("proteinaln2nucl",
                        help="rescore protein alignment at nucl level")
    pn.add_argument("args", nargs=6)
    pn.set_defaults(fn=_cmd_p2n)

    for tool in ("translateaa", "dbtype", "setextendeddbtype", "view",
                 "aliasdb", "compress", "decompress", "diskspaceavail"):
        dt = sub.add_parser(tool, help=f"{tool} DB utility")
        dt.add_argument("args", nargs="*")
        dt.add_argument("--translation-table", type=int, default=1)
        dt.add_argument("--extended-dbtype", type=int, default=0)
        dt.add_argument("--id-list", type=str, default="")
        dt.set_defaults(fn=cmd_dbtool4, tool=tool)

    d7_tools = {"tsv2exprofiledb": 2, "createclusearchdb": 3,
                "transitivealign": 3, "msa2result": 3}
    for tool, nargs in d7_tools.items():
        dp7 = sub.add_parser(tool, help=f"{tool} utility")
        dp7.add_argument("args", nargs=nargs)
        if tool == "tsv2exprofiledb":
            dp7.add_argument("--compressed", type=int, default=1)
        elif tool == "transitivealign":
            dp7.add_argument("-e", type=float, default=1e-3)
            dp7.add_argument("-c", type=float, default=0.0)
            dp7.add_argument("--cov-mode", type=int, default=0)
            dp7.add_argument("--min-seq-id", type=float, default=0.0)
        elif tool == "msa2result":
            dp7.add_argument("--match-ratio", type=float, default=0.5)
            dp7.add_argument("--filter-msa", type=int, default=1)
        dp7.add_argument("--threads", type=int, default=1)
        dp7.add_argument("-v", type=int, default=3)
        dp7.set_defaults(fn=cmd_dbtool7, tool=tool)

    d8_tools = {"convertkb": "+", "extractdomains": 3,
                "appenddbtoindex": "+", "calculatelambda": 1}
    for tool, nargs in d8_tools.items():
        dp8 = sub.add_parser(tool, help=f"{tool} utility")
        dp8.add_argument("args", nargs=nargs)
        if tool == "convertkb":
            dp8.add_argument("--kb-columns", type=str, default="")
            dp8.add_argument("--mapping-file", type=str, default="")
        elif tool == "extractdomains":
            dp8.add_argument("-c", type=float, default=0.0)
            dp8.add_argument("-e", type=float, default=0.001)
        elif tool == "appenddbtoindex":
            dp8.add_argument("--id-list", type=str, default="")
        dp8.add_argument("--threads", type=int, default=1)
        dp8.add_argument("-v", type=int, default=3)
        dp8.set_defaults(fn=cmd_dbtool8, tool=tool)

    dbp = sub.add_parser("databases",
                         help="list/build curated reference databases")
    dbp.add_argument("name", nargs="?", default="")
    dbp.add_argument("sequence_db", nargs="?", default="")
    dbp.add_argument("tmp", nargs="?", default="")
    dbp.add_argument("--tsv", type=int, default=0)
    dbp.add_argument("--local-file", type=str, default="",
                     help="already-fetched FASTA (zero-egress hosts)")
    dbp.add_argument("--ncbi-tax-dump", type=str, default="")
    dbp.add_argument("--tax-mapping-file", type=str, default="")
    dbp.add_argument("--threads", type=int, default=1)
    dbp.add_argument("-v", type=int, default=3)
    dbp.set_defaults(fn=cmd_databases)

    fw = sub.add_parser("fwbw", help="forward-backward posterior "
                        "realignment of an alignment DB")
    fw.add_argument("query_db")
    fw.add_argument("target_db")
    fw.add_argument("aln_db")
    fw.add_argument("out_db")
    fw.add_argument("--fwbw-gapopen", type=float, default=10.0)
    fw.add_argument("--fwbw-gapextend", type=float, default=2.0)
    fw.add_argument("--temperature", type=float, default=1.0)
    fw.add_argument("--mact", type=float, default=0.035)
    fw.add_argument("--blocklen", type=int, default=16)
    fw.add_argument("-e", type=float, default=0.001)
    fw.add_argument("-c", type=float, default=0.0)
    fw.add_argument("--cov-mode", type=int, default=0)
    fw.add_argument("--min-seq-id", type=float, default=0.0)
    fw.add_argument("--threads", type=int, default=1)
    fw.add_argument("-v", type=int, default=3)
    fw.set_defaults(fn=cmd_fwbw)

    pa = sub.add_parser("pairaln",
                        help="pair alignments across complex chains "
                        "by species")
    pa.add_argument("query_db")
    pa.add_argument("target_db")
    pa.add_argument("aln_db")
    pa.add_argument("out_db")
    pa.add_argument("--pairing-mode", type=int, default=0)
    pa.add_argument("--pairing-filter", type=int, default=0)
    pa.add_argument("--pairing-dummy-mode", type=int, default=0)
    pa.add_argument("--pairing-prox-dist", type=int, default=20)
    pa.add_argument("--threads", type=int, default=1)
    pa.add_argument("-v", type=int, default=3)
    pa.set_defaults(fn=cmd_pairaln)

    abk = sub.add_parser("alignbykmer",
                         help="fast k-mer-chain alignment")
    abk.add_argument("query_db")
    abk.add_argument("target_db")
    abk.add_argument("result_db")
    abk.add_argument("out_db")
    abk.add_argument("-e", type=float, default=0.001)
    abk.add_argument("-c", type=float, default=0.0)
    abk.add_argument("--cov-mode", type=int, default=0)
    abk.add_argument("--min-seq-id", type=float, default=0.0)
    abk.add_argument("--gap-open", type=int, default=11)
    abk.add_argument("--gap-extend", type=int, default=1)
    abk.add_argument("--threads", type=int, default=1)
    abk.add_argument("-v", type=int, default=3)
    abk.set_defaults(fn=cmd_alignbykmer)

    for tool in ("ungappedprefilter", "gappedprefilter"):
        up = sub.add_parser(tool, help=f"{tool}: exhaustive prefilter")
        up.add_argument("query_db")
        up.add_argument("target_db")
        up.add_argument("out_db")
        up.add_argument("-e", type=float, default=1e-3)
        up.add_argument("--min-ungapped-score", type=int, default=15)
        up.add_argument("--max-seqs", type=int, default=300)
        up.add_argument("-c", type=float, default=0.0)
        up.add_argument("--cov-mode", type=int, default=0)
        up.add_argument("--comp-bias-corr", type=int, default=1)
        up.add_argument("--threads", type=int, default=1)
        up.add_argument("-v", type=int, default=3)
        up.set_defaults(fn=cmd_exhaustiveprefilter,
                        gapped=(tool == "gappedprefilter"))


def _add_server_commands(sub):
    """The parsers of gpuserver (with --device) and serverclient
    (metaeuk_tpu/cli.py:2115-2143)."""
    gs = sub.add_parser("gpuserver", help="resident search server "
                        "(keeps the target index and the built kernels "
                        "warm across searches)")
    gs.add_argument("target_db")
    gs.add_argument("--socket", type=str, default="")
    gs.add_argument("-s", type=float, default=5.7)
    gs.add_argument("--max-seqs", type=int, default=300)
    gs.add_argument("--mask", type=int, default=1)
    gs.add_argument("--comp-bias-corr", type=int, default=1)
    gs.add_argument("--warmup", type=int, default=1)
    gs.add_argument("--threads", type=int, default=1)
    gs.add_argument("-v", type=int, default=3)
    _add_device_flag(gs)
    gs.set_defaults(fn=cmd_gpuserver)

    sc = sub.add_parser("serverclient", help="send a request to a "
                        "running gpuserver")
    sc.add_argument("socket")
    sc.add_argument("op", choices=["search", "prefilter", "shutdown",
                                   "ping"])
    sc.add_argument("query_db", nargs="?", default="")
    sc.add_argument("out_db", nargs="?", default="")
    sc.add_argument("tmp", nargs="?", default="")
    sc.add_argument("-e", type=float, default=0.001)
    sc.add_argument("-a", type=int, default=0)
    sc.add_argument("--min-seq-id", type=float, default=0.0)
    sc.add_argument("-c", type=float, default=0.0)
    sc.add_argument("--cov-mode", type=int, default=0)
    sc.add_argument("-v", type=int, default=3)
    sc.set_defaults(fn=cmd_serverclient)


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
    ep.add_argument("--contig-split", default="",
                    help="I:N — process contiguous contig partition I of N "
                         "(multi-process data parallelism; merge with "
                         "mergepredictions)")
    ep.add_argument("tmp", nargs="?", default=None,
                    help="checkpoint dir (stage artifacts, resumable)")
    _add_device_flag(ep)
    _add_predict_flags(ep)
    ep.set_defaults(fn=cmd_easy_predict)

    mg = sub.add_parser("mergepredictions",
                        help="merge contig-partitioned easy-predict outputs")
    mg.add_argument("out_prefix")
    mg.add_argument("parts", nargs="+")
    mg.set_defaults(fn=cmd_mergepredictions)
    _add_modular_commands(sub)
    _add_search_commands(sub)
    _add_tax_commands(sub)
    _add_profile_commands(sub)
    _add_cluster_commands(sub)
    _add_db_commands(sub)
    _add_server_commands(sub)
    _add_util_commands(sub)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
