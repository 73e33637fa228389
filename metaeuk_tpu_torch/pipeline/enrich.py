"""enrich: boost search-result diversity through target profiles.

Port of lib/mmseqs/src/workflow/Enrich.cpp + data/workflow/enrich.sh.
NOTE: the reference's `enrich` CLI entry is broken upstream in this
version (MMseqsBase.cpp:1191 declares 4 input paths while enrich.sh
requires 6 and Enrich.cpp reads par.db6), so parity is established by
replaying the script's exact command chain through the reference
binary's individual commands (tools/make_enrich_goldens.sh); our
workflow reproduces that chain byte-for-byte.

Chain (Enrich.cpp defaults: numIterations=3, expansionMode=1,
addBacktrace, step e-values evalProfile,...,evalue):
  1. sliced profile-target search of the query fragments (-a),
  2. result2profile against the profile targets -> query profiles,
  3. per iteration: profile-query k-mer prefilter vs the target
     profiles' consensus DB (minus already-accepted pairs), PROFILE_SEQ
     alignment, expandaln (profile query, rescore-backtrace mode)
     through the profile->member result DB, merge.

Counterpart of metaeuk_tpu/pipeline/enrich.py: enrich_workflow takes a
`device` keyword (default cuda; cpu runs the kernels' plain versions) and
passes it to slice_search_db (K1/K2's PSSM entries) and to
ProfileQueryAligner (their uncapped instances).
"""

import dataclasses
import os

from ..io import mmseqsdb


def enrich_workflow(query_db, target_seq_db, target_prof_db,
                    target_res_db, out_db, tmp, num_iterations=3,
                    evalue=0.001, eval_profile=0.1, sensitivity=4.0,
                    max_res_list_len=300, params=None, device="cuda"):
    from ..data.submat import encode_aa
    from ..io.profiledb import ProfileDB
    from ..params import Params
    from ..search.iterative import _pref_pairs, _write_aln, _write_pref
    from ..search.prefilter_kmer import (KmerPrefilter,
                                         profile_kmer_threshold)
    from ..search.profile_align import ProfileQueryAligner
    from ..search.profile_search import slice_search_db
    from .dbtools import mergedbs
    from .dbtools2 import cpdb, subtractdbs
    from .expand import expandaln_db
    from .result2profile import result2profile_db

    os.makedirs(tmp, exist_ok=True)
    p = params or Params()

    consensus_db = f"{target_prof_db}_consensus"
    if not os.path.exists(f"{consensus_db}.dbtype"):
        from .dbtools6 import profile2seq
        profile2seq(target_prof_db, f"{tmp}/target_consensus",
                    consensus=True)
        consensus_db = f"{tmp}/target_consensus"

    search_slice = os.path.join(tmp, "search_slice")
    slice_search_db(query_db, target_prof_db, search_slice,
                    evalue=evalue, add_backtrace=True, params=params,
                    device=device)
    prof_slice = os.path.join(tmp, "prof_slice")
    result2profile_db(query_db, target_prof_db, search_slice, prof_slice,
                      eval_profile=eval_profile, filter_msa=1)

    cdb = mmseqsdb.read_seqdb(consensus_db)
    ckeys = [int(k) for k in cdb.keys]
    c_by_key = {k: i for i, k in enumerate(ckeys)}
    cencs = [encode_aa(cdb.seq_bytes(i)) for i in range(len(cdb))]
    pf_prof = KmerPrefilter(cencs, kmer_score=0,
                            max_res_list_len=max_res_list_len)
    prof_thr = profile_kmer_threshold(sensitivity)

    current = prof_slice
    aln0 = None
    for step in range(num_iterations):
        last = step == num_iterations - 1
        step_eval = evalue if last else eval_profile
        profiles = ProfileDB.from_db(current)
        per_query = [pf_prof.match_profile(profiles.raw_scores[i],
                                           profiles.query_seqs[i],
                                           kmer_thr=prof_thr)
                     for i in range(len(profiles))]
        pref_db = os.path.join(tmp, f"pref_{step}")
        if step >= 1:
            pref_tmp = os.path.join(tmp, f"pref_tmp_{step}")
            _write_pref(pref_tmp, per_query, profiles.keys, ckeys)
            # SUBSTRACT_PAR keeps the user's original -e (Enrich.cpp:46)
            subtractdbs(pref_tmp, aln0, pref_db, eval_thr=evalue)
        else:
            _write_pref(pref_db, per_query, profiles.keys, ckeys)
        pairs = _pref_pairs(pref_db, profiles.keys, c_by_key)
        p_i = dataclasses.replace(p, aln_len_thr=0)
        aligner = ProfileQueryAligner(p_i, profiles, cdb, device=device)
        hits = aligner.search(pairs, eval_thr=step_eval)
        bts, sids = aligner.backtraces(hits)
        aln_step = os.path.join(tmp, f"aln_{step}")
        _write_aln(aln_step, hits, len(profiles), profiles.keys, ckeys,
                   bts, sids)
        aln_exp = os.path.join(tmp, f"aln_exp_{step}")
        expandaln_db(current, target_seq_db, aln_step, target_res_db,
                     aln_exp, expansion_mode=1, evalue=step_eval)
        if step > 0:
            aln_new = os.path.join(tmp, "aln_new")
            mergedbs(current, aln_new, [aln0, aln_exp])
            cpdb(aln_new, aln0)
        else:
            aln0 = os.path.join(tmp, "aln_0")
            cpdb(aln_exp, aln0)
        profile_step = os.path.join(tmp, f"profile_{step}")
        result2profile_db(query_db, target_seq_db, aln0, profile_step,
                          eval_profile=eval_profile, filter_msa=1)
        current = profile_step
    cpdb(aln0, out_db)
    return out_db
