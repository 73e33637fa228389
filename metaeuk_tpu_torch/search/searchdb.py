"""DB->DB search workflows: plain search, rbh, map, easy-search/easy-rbh.

Ports of lib/mmseqs/src/workflow/{Search,Rbh,Map,EasySearch,EasyRbh}.cpp
and data/workflow/{blastp,rbh,map,easysearch}.sh at their workflow
defaults (single sensitivity step). The compute path is the host k-mer
prefilter + the SW align engines of SearchDriver; this module is the
orchestration plus the text/DB plumbing around them.

Counterpart of metaeuk_tpu/search/searchdb.py on the port's SearchDriver:
search_db, rbh_db, easy_search and easy_rbh take a `device` keyword
(default cuda; cpu runs the kernels' plain versions). prefilter_db, map_db
(rescorediagonal) and result2rbh_db run on the host only, as there;
easy_linsearch runs linsearch_lin's workflow on `device`.

result2rbh: lib/mmseqs/src/util/result2rbh.cpp — over the merged,
bitscore-sorted A->B + swapped B->A best-hit DB, keep the B->A lines
whose bitscore equals the first (A->B) line's bitscore.
"""

import os

import numpy as np

from ..io import mmseqsdb


def _load_encoded(path):
    from ..data.submat import AA2NUM
    db = mmseqsdb.read_seqdb(path)
    return [AA2NUM[np.asarray(db.seq(i), np.uint8)]
            for i in range(len(db))], db


def build_prefilter_state(target_db, sensitivity=5.7, max_seqs=300,
                          min_ungapped_score=15, comp_bias_correction=True,
                          mask_targets=True, diagonal_scoring=True):
    """Preloadable prefilter state (target encodings + k-mer index) —
    the expensive part a resident server keeps across requests."""
    from ..search.prefilter_kmer import KmerPrefilter

    tencs, tdb = _load_encoded(target_db)
    pf = KmerPrefilter(tencs, sensitivity=sensitivity,
                       max_res_list_len=max_seqs,
                       min_diag_score=min_ungapped_score,
                       mask_targets=mask_targets,
                       comp_bias_correction=comp_bias_correction,
                       diagonal_scoring=diagonal_scoring)
    return tencs, tdb, pf


def prefilter_db(query_db, target_db, out_db, sensitivity=5.7,
                 max_seqs=300, min_ungapped_score=15,
                 comp_bias_correction=True, mask_targets=True,
                 diagonal_scoring=True, cov=0.0, cov_mode=0,
                 _state=None):
    """The k-mer prefilter stage between two sequence-DB paths (the
    byte-parity engine from search/prefilter_kmer.py). `_state` reuses
    a prebuilt build_prefilter_state tuple (server mode)."""
    from ..search.prefilter_kmer import hits_to_pref_lines

    same = str(query_db) == str(target_db)
    if _state is not None:
        tencs, tdb, pf = _state
    else:
        tencs, tdb, pf = build_prefilter_state(
            target_db, sensitivity=sensitivity, max_seqs=max_seqs,
            min_ungapped_score=min_ungapped_score,
            comp_bias_correction=comp_bias_correction,
            mask_targets=mask_targets, diagonal_scoring=diagonal_scoring)
    qencs, qdb = (tencs, tdb) if same else _load_encoded(query_db)
    tkeys = np.asarray([int(k) for k in tdb.keys], np.int64)
    tlens = np.asarray([len(e) for e in tencs], np.int64)
    entries = []
    for qi, q in enumerate(qencs):
        ids, sc, dg = pf.match(q, identity_id=qi if same else None)
        if cov > 0.0 and cov_mode in (0, 2, 5):
            # length-ratio filter on the hit list (Prefiltering.cpp:856-863)
            from .lcaalign import can_be_covered
            keep = np.asarray([can_be_covered(cov, cov_mode, len(q),
                                              int(tlens[t])) for t in ids],
                              bool) if len(ids) else np.zeros(0, bool)
            ids, sc, dg = ids[keep], sc[keep], dg[keep]
        entries.append((int(qdb.keys[qi]),
                        hits_to_pref_lines(tkeys[ids], sc, dg).encode()))
    mmseqsdb.write_db(out_db, entries, mmseqsdb.DBTYPE_PREFILTER_RES)
    return out_db


def step_sensitivities(start_sens, sensitivity, sens_steps):
    """The blastp.sh SENSE_k schedule (Search.cpp:520-546): step 0 is
    the UNROUNDED start-sens (the reference passes SSTR(par.startSens)
    verbatim, Search.cpp:529), steps 1..k-1 are formatted to one decimal
    (the script passes the formatted string to prefilter -s, so the
    ROUNDED value is the effective sensitivity for those steps)."""
    if sens_steps <= 1:
        return [float(f"{sensitivity:.1f}")]
    if start_sens > sensitivity:
        raise ValueError("--start-sens can not be greater than -s")
    step = (sensitivity - start_sens) / (sens_steps - 1)
    return [float(start_sens)] + [float(f"{start_sens + step * k:.1f}")
                                  for k in range(1, sens_steps)]


def search_db(query_db, target_db, out_db, tmp_dir, sensitivity=5.7,
              evalue=1e-3, max_seqs=300, max_accept=None, min_seq_id=0.0,
              cov=0.0, cov_mode=0, comp_bias_correction=True,
              mask_targets=True, add_backtrace=False, alignment_mode=2,
              start_sens=4.0, sens_steps=1, params=None, device="cuda"):
    """blastp.sh: prefilter -> align (Search.cpp defaults -s 5.7 -e 1e-3
    --max-seqs 300, checkpoint/resume via tmp_dir). With sens_steps > 1,
    the multi-pass increasing-sensitivity loop (blastp.sh STEP loop,
    Search.cpp:520-546): each pass prefilters+aligns only the queries
    that found NOTHING in earlier passes (aln index entry length < 2),
    and per-query results are merged over the full query key set."""
    from .align_module import align_db
    from ..pipeline.dbtools import createsubdb, mergedbs
    from ..pipeline.dbtools2 import mvdb

    os.makedirs(tmp_dir, exist_ok=True)
    align_kw = dict(evalue=evalue, min_seq_id=min_seq_id, cov=cov,
                    cov_mode=cov_mode, max_accept=max_accept,
                    add_backtrace=add_backtrace,
                    alignment_mode=alignment_mode,
                    comp_bias_corr=comp_bias_correction, params=params,
                    device=device)
    senses = step_sensitivities(start_sens, sensitivity, sens_steps)
    if sens_steps <= 1:
        pref = os.path.join(tmp_dir, "pref_0")
        if not os.path.exists(f"{pref}.dbtype"):
            prefilter_db(query_db, target_db, pref, sensitivity=senses[0],
                         max_seqs=max_seqs, mask_targets=mask_targets,
                         comp_bias_correction=comp_bias_correction,
                         cov=cov, cov_mode=cov_mode)
        if not os.path.exists(f"{out_db}.dbtype"):
            align_db(query_db, target_db, pref, out_db, **align_kw)
        return out_db

    input_db = query_db
    aln_merge = None
    for step, sens in enumerate(senses):
        pref = os.path.join(tmp_dir, f"pref_{step}")
        if not os.path.exists(f"{pref}.dbtype"):
            prefilter_db(input_db, target_db, pref, sensitivity=sens,
                         max_seqs=max_seqs, mask_targets=mask_targets,
                         comp_bias_correction=comp_bias_correction,
                         cov=cov, cov_mode=cov_mode)
        aln = os.path.join(tmp_dir, f"aln_{step}")
        if not os.path.exists(f"{aln}.dbtype"):
            align_db(input_db, target_db, pref, aln, **align_kw)
        last = step == sens_steps - 1
        if step == 0:
            aln_merge = aln
        else:
            # merge over the FULL query key set ($1 in blastp.sh); a
            # query has results in at most one step, so per-key
            # concatenation keeps whichever pass found hits
            merged = out_db if last else \
                os.path.join(tmp_dir, f"aln_merge_{step}")
            mergedbs(query_db, merged, [aln_merge, aln])
            aln_merge = merged
        if last:
            break
        # queries whose entry is empty (index length < 2: only the
        # terminating NUL) continue into the next, more sensitive pass
        empty = [key for key, payload in mmseqsdb.read_db(aln)
                 if len(payload) == 0]
        if not empty:
            mvdb(aln_merge, out_db)
            break
        next_input = os.path.join(tmp_dir, f"input_{step}")
        if not os.path.exists(f"{next_input}.dbtype"):
            createsubdb(empty, input_db, next_input)
        input_db = next_input
    return out_db


def map_db(query_db, target_db, out_db, tmp_dir, evalue=1e-3,
           min_seq_id=0.9, cov=0.95, cov_mode=2, max_seqs=300):
    """mmseqs map (Map.cpp setMapWorkflowDefaults: -s 2, no masking, no
    comp-bias, ungapped align module = rescorediagonal --rescore-mode 2
    with cov 0.95/cov-mode 2/seq-id 0.9, sorted results)."""
    from ..pipeline.rescorediagonal import rescorediagonal

    os.makedirs(tmp_dir, exist_ok=True)
    pref = os.path.join(tmp_dir, "pref_0")
    if not os.path.exists(f"{pref}.dbtype"):
        prefilter_db(query_db, target_db, pref, sensitivity=2.0,
                     max_seqs=max_seqs, mask_targets=False,
                     comp_bias_correction=False)
    if not os.path.exists(f"{out_db}.dbtype"):
        rescorediagonal(query_db, target_db, pref, out_db, rescore_mode=2,
                        eval_thr=evalue, cov_thr=cov, cov_mode=cov_mode,
                        seq_id_thr=min_seq_id, sort_results=1)
    return out_db


def result2rbh_db(in_db, out_db, compressed=False):
    """result2rbh.cpp: first line per entry is the best A->B hit; retain
    the following (B->A) lines while their bitscore equals it."""
    out = []
    for key, payload in mmseqsdb.read_db(in_db):
        lines = payload.decode().splitlines(keepends=True)
        best = 0
        kept = []
        for ln in lines:
            if not ln.strip():
                continue
            score = int(ln.split("\t")[1])
            if best == 0:  # the A->B line sets the bar
                best = score
            elif score == best:
                kept.append(ln)
            else:  # sorted by decreasing bitscore: done
                break
        out.append((key, "".join(kept).encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.read_dbtype(in_db),
                      compressed=compressed)
    return out_db


def rbh_db(a_db, b_db, out_db, tmp_dir, sensitivity=5.7, evalue=1e-3,
           cov=0.0, cov_mode=0, min_seq_id=0.0, max_seqs=300,
           device="cuda"):
    """rbh.sh: search A->B and B->A (coverage mode swapped, Rbh.cpp:53),
    best-hit extraction both ways, swap, merge, sort by bitscore,
    result2rbh. setRbhDefaults: no comp-bias, no masking."""
    from ..pipeline.dbtools import mergedbs
    from ..pipeline.dbtools2 import swapresults
    from ..pipeline.filterdb import filterdb

    swap_cov = {0: 0, 1: 2, 2: 1, 3: 4, 4: 3, 5: 5}[cov_mode]
    os.makedirs(tmp_dir, exist_ok=True)
    # setRbhDefaults (Rbh.cpp:10-17): no comp-bias, no masking, true
    # sequence identities (alignment mode 3)
    kw = dict(sensitivity=sensitivity, evalue=evalue, max_seqs=max_seqs,
              min_seq_id=min_seq_id, comp_bias_correction=False,
              mask_targets=False, alignment_mode=3, device=device)
    res_ab = os.path.join(tmp_dir, "resAB")
    if not os.path.exists(f"{res_ab}.dbtype"):
        search_db(a_db, b_db, res_ab, os.path.join(tmp_dir, "tempAB"),
                  cov=cov, cov_mode=cov_mode, **kw)
    res_ba = os.path.join(tmp_dir, "resBA")
    if not os.path.exists(f"{res_ba}.dbtype"):
        search_db(b_db, a_db, res_ba, os.path.join(tmp_dir, "tempBA"),
                  cov=cov, cov_mode=swap_cov, **kw)

    a_best_b = os.path.join(tmp_dir, "resA_best_B")
    filterdb(res_ab, a_best_b, extract_lines=1)
    b_best_a = os.path.join(tmp_dir, "resB_best_A")
    filterdb(res_ba, b_best_a, beats_first=True, filter_column=2,
             comp_operator="e")
    b_best_a_swap = os.path.join(tmp_dir, "resB_best_A_swap")
    swapresults(b_db, a_db, b_best_a, b_best_a_swap, eval_thr=1e8)
    merged = os.path.join(tmp_dir, "res_best_merged")
    mergedbs(a_best_b, merged, [a_best_b, b_best_a_swap])
    merged_sorted = os.path.join(tmp_dir, "res_best_merged_sorted")
    filterdb(merged, merged_sorted, sort_entries=2, filter_column=2)
    result2rbh_db(merged_sorted, out_db)
    return out_db


def _ensure_seqdb(path_or_fasta, tmp_db_path):
    """createdb the input unless it already is an MMseqs DB."""
    if os.path.exists(f"{path_or_fasta}.dbtype"):
        return path_or_fasta
    if not os.path.exists(f"{tmp_db_path}.dbtype"):
        from ..io.seqdb import DBTYPE_AA, SeqDB
        mmseqsdb.write_seqdb(tmp_db_path,
                             SeqDB.from_fasta(path_or_fasta, DBTYPE_AA))
    return tmp_db_path


def easy_search(query, target, out_m8, tmp_dir, sensitivity=5.7,
                evalue=1e-3, max_seqs=300, min_seq_id=0.0, cov=0.0,
                cov_mode=0, greedy_best_hits=False, search_fn=None,
                device="cuda"):
    """easysearch.sh: createdb -> search -> [summarizeresult] ->
    convertalis (default BLAST-tab). --greedy-best-hits forces
    backtraces (EasySearch.cpp:73-81)."""
    from ..pipeline.alnformat import write_blast_tab
    from ..pipeline.dbtools2 import summarizeresult

    os.makedirs(tmp_dir, exist_ok=True)
    q_db = _ensure_seqdb(query, os.path.join(tmp_dir, "query"))
    t_db = _ensure_seqdb(target, os.path.join(tmp_dir, "target"))
    result = os.path.join(tmp_dir, "result")
    if search_fn is not None:
        search_fn(q_db, t_db, result, os.path.join(tmp_dir, "search_tmp"))
    elif not os.path.exists(f"{result}.dbtype"):
        # setEasySearchDefaults: alignment mode 3 (true seq ids)
        search_db(q_db, t_db, result, os.path.join(tmp_dir, "search_tmp"),
                  sensitivity=sensitivity, evalue=evalue, max_seqs=max_seqs,
                  min_seq_id=min_seq_id, cov=cov, cov_mode=cov_mode,
                  add_backtrace=greedy_best_hits, alignment_mode=3,
                  device=device)
    intermediate = result
    if greedy_best_hits:
        # EasySearch.cpp:73-81 forces addBacktrace, which flows into
        # SUMMARIZE_PAR -> summarizeresult keeps the backtrace column
        best = os.path.join(tmp_dir, "result_best")
        summarizeresult(result, best, add_backtrace=True)
        intermediate = best
    write_blast_tab(q_db, t_db, intermediate, out_m8)
    return out_m8


def easy_rbh(query, target, out_m8, tmp_dir, sensitivity=5.7, evalue=1e-3,
             cov=0.0, cov_mode=0, min_seq_id=0.0, device="cuda"):
    """EasyRbh.cpp: createdb -> rbh -> convertalis."""
    return easy_search(
        query, target, out_m8, tmp_dir,
        search_fn=lambda q, t, o, wt: rbh_db(
            q, t, o, wt, sensitivity=sensitivity, evalue=evalue,
            cov=cov, cov_mode=cov_mode, min_seq_id=min_seq_id,
            device=device))


def easy_linsearch(query, target, out_m8, tmp_dir, evalue=1e-3, cov=0.0,
                   cov_mode=0, min_seq_id=0.0, kmers_per_seq=21,
                   device="cuda"):
    """easy-linsearch (easysearch.sh with SEARCH_MODULE=linsearch +
    createlinindex; EasySearch.cpp linsearch branch); the alignment on
    `device`."""
    from .linsearch_lin import linsearch_workflow

    return easy_search(
        query, target, out_m8, tmp_dir,
        search_fn=lambda q, t, o, wt: linsearch_workflow(
            q, t, o, wt, evalue=evalue, cov=cov, cov_mode=cov_mode or None,
            min_seq_id=min_seq_id, kmers_per_seq=kmers_per_seq,
            alignment_mode=3, device=device))
