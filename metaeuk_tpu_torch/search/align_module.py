"""Standalone `align` module: query DB x target DB x result DB -> alignment DB.

The reference's alignment module (lib/mmseqs/src/alignment/Alignment.cpp,
invoked as `mmseqs align qDB tDB resultDB alnDB`): for every (query,
target) pair listed in the result DB (prefilter or alignment format —
only column 0, the target key, is consumed here), run the vectorized
Smith-Waterman, apply Alignment::checkCriteria (E-value, seq-id,
coverage, min alignment length), sort per query by Matcher::compareHits,
and write matcher-format lines (optionally with backtraces, -a).

Device path: candidate pairs are bucketed by padded lengths and aligned in
dense device batches by SearchDriver (search/driver.py); the per-pair
scalar loop of the reference becomes a handful of batched kernel launches.

Counterpart of metaeuk_tpu/search/align_module.py on the port's
SearchDriver, with a `device` keyword on align_db (default cuda; cpu runs
the kernels' plain versions).
"""

import dataclasses

import numpy as np

from ..io import mmseqsdb
from ..params import Params
from ..pipeline.alnformat import hits_to_aln_db_entries
from .driver import SearchDriver


def _pairs_from_result_db(result_db, qkeys, t_by_key):
    """(query_idx, target_idx) pairs in result-DB entry order, grouped by
    query (the reference processes result entries per query in index
    order)."""
    q_by_key = {int(k): i for i, k in enumerate(qkeys)}
    pairs = []
    order = []
    for qk, payload in mmseqsdb.read_db(result_db):
        if int(qk) not in q_by_key:
            continue
        qi = q_by_key[int(qk)]
        order.append(qi)
        for ln in payload.decode().splitlines():
            if ln:
                pairs.append((qi, t_by_key[int(ln.split("\t", 1)[0])]))
    pairs.sort(key=lambda x: x[0])
    return pairs, order


def align_db(query_db, target_db, result_db, out_db, evalue=1e-3,
             add_backtrace=False, min_seq_id=0.0, cov=0.0, cov_mode=0,
             min_aln_len=0, max_accept=None, comp_bias_corr=True,
             realign=False, alignment_mode=2, params=None, device="cuda"):
    qdb = mmseqsdb.read_seqdb(query_db)
    tdb = mmseqsdb.read_seqdb(target_db)
    tkeys = [int(k) for k in tdb.keys]
    t_by_key = {k: i for i, k in enumerate(tkeys)}
    pairs, _ = _pairs_from_result_db(result_db, qdb.keys, t_by_key)

    # with a backtrace or alignment mode >= 3 the --min-seq-id criterion
    # applies to the traceback identity, not the estimate (initSWMode
    # COV_SEQID + checkCriteria, Alignment.cpp:167-180,548-560)
    need_true = (add_backtrace or alignment_mode >= 3) and not realign
    p = params or Params()
    p = dataclasses.replace(p, search_evalue_thr=evalue,
                            seq_id_thr=0.0 if need_true else min_seq_id,
                            cov_thr=cov,
                            cov_mode=cov_mode, aln_len_thr=min_aln_len,
                            comp_bias_correction=comp_bias_corr)
    driver = SearchDriver(p, tdb, device=device)
    qseqs = [qdb.seq_bytes(i) for i in range(len(qdb))]
    hits = driver.search(qseqs, pair_generator=pairs)
    if str(query_db) == str(target_db) and len(hits):
        # same-DB identity hits use scoreIdentical: seqId forced to 1.0
        # (Alignment.cpp getSWResult isIdentity path)
        ident = hits["orf_idx"] == hits["target_idx"]
        hits["seq_id"] = np.where(ident, np.float32(1.0), hits["seq_id"])
    bts = sids = None
    if need_true and len(hits):
        bts, sids = driver.backtraces(hits, qseqs)
        if min_seq_id > 0.0:
            keep = np.asarray(sids, np.float32) >= np.float32(min_seq_id)
            hits = hits[keep]
            bts = [b for b, k in zip(bts, keep) if k]
            sids = [s for s, k in zip(sids, keep) if k]
    if max_accept is not None and len(hits):
        # acceptance follows the PREFILTER candidate order (the
        # sequential accept walk of Alignment::run), not the sorted
        # output order
        by_pair = {}
        for i, h in enumerate(hits):
            by_pair.setdefault((int(h["orf_idx"]), int(h["target_idx"])),
                               []).append(i)
        keep = np.zeros(len(hits), bool)
        counts = {}
        for qi, ti in np.asarray(pairs).tolist():
            if counts.get(qi, 0) >= max_accept:
                continue
            for i in by_pair.get((qi, ti), ()):
                if counts.get(qi, 0) >= max_accept:
                    break
                counts[qi] = counts.get(qi, 0) + 1
                keep[i] = True
        hits = hits[keep]
        if bts is not None:
            bts = [b for b, k in zip(bts, keep) if k]
            sids = [s for s, k in zip(sids, keep) if k]
    if realign:
        hits, bts, sids = driver.realign(hits, qseqs)
    elif need_true and not add_backtrace:
        # SCORE_COV_SEQID: true identities from the traceback, but the
        # backtrace column itself is not written (Alignment.cpp mode 3)
        bts = None
    mapped = hits.copy()
    if len(hits):
        mapped["target_idx"] = np.asarray(tkeys, np.int64)[hits["target_idx"]]
    entries = hits_to_aln_db_entries(mapped, len(qdb), backtraces=bts,
                                     seq_ids=sids)
    out = [(int(qdb.keys[qi]), payload) for qi, payload in entries]
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES)
    return out_db
