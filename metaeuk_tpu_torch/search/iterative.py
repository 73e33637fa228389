"""Iterative profile search (the blastpgp.sh role; PSI-BLAST-like).

Byte-parity implementation of workflow/blastpgp.sh as parameterized by
Search.cpp:477-520: per iteration, prefilter the current query DB
(sequences at step 0, result2profile profiles after) against the target
DB, subtract previously accepted targets from the new prefilter space
(subtractdbs with the user's -e), align (with --realign at step 0 only,
Search.cpp:485-489), merge with the accumulated alignments, and rebuild
profiles. The intermediate E-value gate is min(-e, --e-profile) until
the last iteration (Search.cpp:483-486, 493-495). The final iteration's
merged alignment DB is the output.

All stages run on the byte-parity engines: the k-mer prefilter
(sequence and profile query modes), the batched SW driver with realign,
the PROFILE_SEQ aligner, subtractdbs/mergedbs, result2profile.

Counterpart of metaeuk_tpu/search/iterative.py on the port's drivers:
iterative_search takes a `device` keyword (default cuda; cpu runs the
kernels' plain versions). Step 0 aligns on SearchDriver (K1/K2, K3/K4 by
the driver's routing) and realigns on K1/K2's uncapped instances; steps >=
1 align on ProfileQueryAligner (K1/K2's uncapped PSSM instances).
"""

import os

import numpy as np

from ..io import mmseqsdb
from ..pipeline.dbtools import mergedbs
from ..pipeline.dbtools2 import subtractdbs
from ..pipeline.result2profile import result2profile_db
from ..pipeline.alnformat import hits_to_aln_db_entries


def _write_aln(out_db, hits, n_queries, qkeys, tkeys, bts, sids):
    """Alignment DB (with backtraces) keyed by query keys, target ids
    re-expressed as target keys."""
    mapped = hits.copy()
    mapped["target_idx"] = np.asarray(tkeys, np.int64)[hits["target_idx"]] \
        if len(hits) else mapped["target_idx"]
    entries = hits_to_aln_db_entries(mapped, n_queries, backtraces=bts,
                                     seq_ids=sids)
    out = [(int(qkeys[qi]), payload) for qi, payload in entries]
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES)
    return out_db


def _write_pref(out_db, per_query, qkeys, tkeys):
    """Prefilter result DB from per-query (ids, scores, diags)."""
    from .prefilter_kmer import hits_to_pref_lines

    out = []
    for qi, (ids, sc, dg) in enumerate(per_query):
        lines = "".join(f"{int(tkeys[t])}\t{int(s)}\t{int(d)}\n"
                        for t, s, d in zip(ids, sc, dg))
        out.append((int(qkeys[qi]), lines.encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_PREFILTER_RES)
    return out_db


def _pref_pairs(pref_db, qkeys, t_by_key):
    """(query_idx, target_idx) pairs in prefilter entry order."""
    pref = dict(mmseqsdb.read_db(pref_db))
    q_by_key = {int(k): i for i, k in enumerate(qkeys)}
    pairs = []
    for qk, payload in pref.items():
        qi = q_by_key[int(qk)]
        for ln in payload.decode().splitlines():
            if ln:
                pairs.append((qi, t_by_key[int(ln.split("\t", 1)[0])]))
    # stable by query, preserving per-query prefilter order
    pairs.sort(key=lambda x: x[0])
    return pairs


def iterative_search(query_db, target_db, out_db, tmp_dir,
                     num_iterations=3, evalue=0.001, e_profile=0.1,
                     sensitivity=4.0, max_res_list_len=300, params=None,
                     device="cuda"):
    """blastpgp.sh with byte parity vs `search --num-iterations N -a`;
    the alignment on `device`."""
    import dataclasses

    from ..data.submat import encode_aa
    from ..io.profiledb import ProfileDB
    from ..params import Params
    from .driver import SearchDriver
    from .prefilter_kmer import (KmerPrefilter, profile_kmer_threshold)
    from .profile_align import ProfileQueryAligner

    os.makedirs(tmp_dir, exist_ok=True)
    p = params or Params()
    inter_eval = min(evalue, e_profile)

    qdb = mmseqsdb.read_seqdb(query_db)
    tdb = mmseqsdb.read_seqdb(target_db)
    tkeys = [int(k) for k in tdb.keys]
    t_by_key = {k: i for i, k in enumerate(tkeys)}
    tencs = [encode_aa(tdb.seq_bytes(i)) for i in range(len(tdb))]
    same_qt = os.path.abspath(query_db) == os.path.abspath(target_db)

    # two index thresholds: sequence queries use the sensitivity-derived
    # threshold; profile queries force localKmerThr=0
    # (Prefiltering.cpp:525-527)
    pf_seq = KmerPrefilter(tencs, sensitivity=sensitivity,
                           max_res_list_len=max_res_list_len)
    pf_prof = None
    prof_thr = profile_kmer_threshold(sensitivity)

    current_query = query_db
    prev_aln = None
    for step in range(num_iterations):
        last = step == num_iterations - 1
        step_eval = evalue if last else inter_eval
        pref_db = os.path.join(tmp_dir, f"pref_{step}")
        aln_out = out_db if (last and step > 0) else \
            os.path.join(tmp_dir, f"aln_{step}")

        if step == 0:
            qseqs = [qdb.seq_bytes(i) for i in range(len(qdb))]
            per_query = []
            for qi in range(len(qdb)):
                ident = t_by_key.get(int(qdb.keys[qi])) if same_qt else None
                per_query.append(pf_seq.match(encode_aa(qseqs[qi]),
                                              identity_id=ident))
            _write_pref(pref_db, per_query, qdb.keys, tkeys)
            pairs = _pref_pairs(pref_db, qdb.keys, t_by_key)
            p0 = dataclasses.replace(p, search_evalue_thr=step_eval,
                                     aln_len_thr=0)
            driver = SearchDriver(p0, tdb, device=device)
            hits = driver.search(qseqs, pair_generator=pairs)
            # step 0 aligns with --realign (Search.cpp:485-489)
            hits, bts, sids = driver.realign(hits, qseqs)
            _write_aln(aln_out, hits, len(qdb), qdb.keys, tkeys, bts, sids)
        else:
            profiles = ProfileDB.from_db(current_query)
            if pf_prof is None:
                pf_prof = KmerPrefilter(tencs, kmer_score=0,
                                        max_res_list_len=max_res_list_len)
            per_query = [pf_prof.match_profile(profiles.raw_scores[i],
                                               profiles.query_seqs[i],
                                               kmer_thr=prof_thr)
                         for i in range(len(profiles))]
            pref_tmp = os.path.join(tmp_dir, f"pref_tmp_{step}")
            _write_pref(pref_tmp, per_query, profiles.keys, tkeys)
            # subtract previously accepted targets (SUBSTRACT_PAR carries
            # the user's original -e, Search.cpp:478)
            subtractdbs(pref_tmp, prev_aln, pref_db, eval_thr=evalue)
            pairs = _pref_pairs(pref_db, profiles.keys, t_by_key)
            p_i = dataclasses.replace(p, aln_len_thr=0)
            aligner = ProfileQueryAligner(p_i, profiles, tdb,
                                          device=device)
            hits = aligner.search(pairs, eval_thr=step_eval)
            bts, sids = aligner.backtraces(hits)
            aln_tmp = os.path.join(tmp_dir, f"aln_tmp_{step}")
            _write_aln(aln_tmp, hits, len(profiles), profiles.keys, tkeys,
                       bts, sids)
            mergedbs(current_query, aln_out, [prev_aln, aln_tmp])

        if not last:
            profile_db = os.path.join(tmp_dir, f"profile_{step}")
            result2profile_db(current_query, target_db, aln_out, profile_db,
                              eval_profile=e_profile)
            current_query = profile_db
        prev_aln = aln_out
    if num_iterations == 1 and prev_aln != out_db:
        from ..pipeline.dbtools2 import cpdb
        cpdb(prev_aln, out_db)
    return out_db
