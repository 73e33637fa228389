"""metaeuk-tpu-torch command-line interface.

    metaeuk-tpu-torch easy-predict contigs.fna targets.faa out_prefix [tmp]
        [--device cuda] [the easy-predict flags of metaeuk-tpu]
    metaeuk-tpu-torch createdb | search | align | convertalis | easy-search
        | rbh | map | easy-rbh | result2rbh | lcaalign ...

The flags and their mapping to Params are those of metaeuk-tpu: _byte_size,
_add_predict_flags, _params_from_args and _parse_dp_payload are copied from
metaeuk_tpu/cli.py (:16, :25, :69, :214), and the MMseqs2 search family's
commands from its cmd_createdb (:582), cmd_search (:734), cmd_convertalis
(:881), cmd_align (:957) and cmd_rbh .. cmd_lcaalign (:1436-1490), with
their parsers. Every command that aligns takes --device (default cuda; cpu
runs the kernels' plain versions); map and result2rbh run on the host only.
search's --num-iterations > 1 and its nucleotide branch, and the other
commands of metaeuk-tpu, are not ported yet.
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
        raise NotImplementedError(
            "search --num-iterations > 1 waits for search/iterative.py, "
            "which the port does not have yet (ROADMAP section 1, item 4, "
            "M6)")
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
        raise NotImplementedError(
            "nucleotide search waits for search/nucl_search.py, which the "
            "port does not have yet (ROADMAP section 1, item 8, M11)")
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
                    help=">1 = iterative profile search (blastpgp role; "
                         "not ported yet)")
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
    _add_device_flag(ep)
    _add_predict_flags(ep)
    ep.set_defaults(fn=cmd_easy_predict)
    _add_search_commands(sub)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
