"""lcaalign + score-only align: the taxonomy workflow's alignment stages.

Counterpart of metaeuk_tpu/search/lcaalign.py: the same module on the
port's SearchDriver, with a `device` keyword (default cuda; cpu runs the
kernels' plain versions) on score_only_align_db and lcaalign_db.

Ports of lib/mmseqs/src/alignment/Alignment.cpp driven with
``lcaAlign=true`` (alignment/Main.cpp:34-52) and with the taxonomy
defaults (``--alignment-mode 1`` => Matcher::SCORE_ONLY output):

- pass 1 (score-only): candidates are aligned in prefilter order with the
  sequential accept/reject bookkeeping of Alignment::run
  (Alignment.cpp:344-397): ``canBeCovered`` pre-gate, ``checkCriteria``,
  consecutive-reject counter vs --max-rejected, accept cap --max-accept.
- lcaalign realigns the top hit (realignScoreBias 0, realignMaxSeqs 1,
  Alignment.cpp:39-45,408-442), then aligns the top hit's matched target
  region against every prefilter candidate with the top hit's E-value as
  threshold (Alignment.cpp:444-498) — the accelerated 2bLCA.

Device mapping: all per-pair Smith-Watermans of a stage are batched
through SearchDriver (dense, length-bucketed device launches); the cheap
sequential accept/reject bookkeeping replays on host over the computed
results, which is exact because each pair's alignment is independent.
"""

import dataclasses

import numpy as np

from ..io import mmseqsdb
from ..params import Params
from ..pipeline.alnformat import hit_to_matcher_line
from .driver import HIT_DTYPE, SearchDriver, estimate_seq_id

INT_MAX = 2 ** 31 - 1


def can_be_covered(cov_thr, cov_mode, q_len, t_len):
    """Util::canBeCovered (Util.cpp:477-494)."""
    q, t = float(q_len), float(t_len)
    if cov_mode == 0:
        return q / t >= cov_thr and t / q >= cov_thr
    if cov_mode == 1:  # COV_MODE_TARGET
        return q / t >= cov_thr
    if cov_mode == 2:  # COV_MODE_QUERY
        return t / q >= cov_thr
    if cov_mode == 3:
        return cov_thr <= t / q <= 1.0
    if cov_mode == 4:
        return cov_thr <= q / t <= 1.0
    if cov_mode == 5:
        return min(q, t) / max(q, t) >= cov_thr
    return True


def has_coverage(cov_thr, cov_mode, q_cov, t_cov):
    """Util::hasCoverage (Util.cpp:496-511)."""
    if cov_mode == 0:
        return q_cov >= cov_thr and t_cov >= cov_thr
    if cov_mode == 1:  # COV_MODE_TARGET
        return t_cov >= cov_thr
    if cov_mode == 2:  # COV_MODE_QUERY
        return q_cov >= cov_thr
    return True


def _permissive(params):
    return dataclasses.replace(params, search_evalue_thr=float("inf"),
                               seq_id_thr=0.0, cov_thr=0.0, aln_len_thr=0)


def _candidates_per_query(result_db):
    """[(query_key, [target_key, ...])] in result-DB entry order."""
    out = []
    for qk, payload in mmseqsdb.read_db(result_db):
        keys = []
        for ln in payload.decode().splitlines():
            if ln:
                keys.append(int(ln.split("\t", 1)[0].split(" ", 1)[0]))
        out.append((int(qk), keys))
    return out


def _raw_results(driver, qseqs, pairs):
    """All-pair alignments keyed (query_idx, target_idx); thresholds off."""
    hits = driver.search(qseqs, pair_generator=pairs)
    return {(int(h["orf_idx"]), int(h["target_idx"])): h for h in hits}


def _score_only_row(h, tkey, is_identity=False):
    """A SCORE_ONLY Matcher::result_t: zero starts, per-column seq-id
    estimate over the end positions (Matcher.cpp getSWResult SCORE_ONLY)."""
    row = np.zeros(1, dtype=HIT_DTYPE)[0]
    row["orf_idx"] = h["orf_idx"]
    row["target_idx"] = tkey
    row["score_raw"] = h["score_raw"]
    row["bit_score"] = h["bit_score"]
    row["evalue"] = h["evalue"]
    # SCORE_ONLY s_align leaves start positions at -1; resultToBuffer
    # writes them verbatim (parsers later clamp -1 to 0)
    row["q_start"] = -1
    row["q_end"] = h["q_end"]
    row["q_len"] = h["q_len"]
    row["t_start"] = -1
    row["t_end"] = h["t_end"]
    row["t_len"] = h["t_len"]
    row["seq_id"] = 1.0 if is_identity else estimate_seq_id(
        np.int32(h["score_raw"]), np.int64(max(int(h["q_end"]), 1)),
        np.int64(max(int(h["t_end"]), 1)))
    return row


def _pass1(per_query, q_by_key, t_by_key, raw, tdb, qlens, evalue,
           seq_id_thr, min_aln_len, cov, cov_mode, max_accept, max_rejected,
           same_qtdb):
    """The sequential accept/reject walk of Alignment::run per query.
    Returns {query_key: [(tkey, hit_row, is_identity), ...]} accepted,
    in candidate order."""
    accepted = {}
    for qk, cand in per_query:
        qi = q_by_key.get(qk)
        acc = []
        rejected = 0
        for tkey in cand:
            if len(acc) >= max_accept or rejected >= max_rejected:
                break
            ti = t_by_key[tkey]
            t_len = int(tdb.lengths[ti])
            if not can_be_covered(cov, cov_mode, max(int(qlens[qi]), 1),
                                  max(t_len, 1)):
                rejected += 1
                continue
            is_identity = same_qtdb and qk == tkey
            h = raw.get((qi, ti))
            if h is None:
                rejected += 1
                continue
            # checkCriteria with SCORE_ONLY estimates (covThr=0 in the
            # scoring pass: realign/score-only keeps cov trivially true)
            seq_id = 1.0 if is_identity else float(estimate_seq_id(
                np.int32(h["score_raw"]), np.int64(max(int(h["q_end"]), 1)),
                np.int64(max(int(h["t_end"]), 1))))
            # in-memory alnLength treats the -1 starts as coordinates:
            # max(|qEnd-(-1)|, |dbEnd-(-1)|) + 1 (Matcher.cpp:156-158)
            aln_len = max(int(h["q_end"]), int(h["t_end"])) + 2
            ok = is_identity or (float(h["evalue"]) <= evalue and
                                 seq_id >= seq_id_thr and
                                 aln_len >= min_aln_len)
            if ok:
                acc.append((tkey, h, is_identity))
                rejected = 0
            else:
                rejected += 1
        accepted[qk] = acc
    return accepted


def _compare_hits_key(row):
    """Matcher::compareHits (Matcher.h:150-168)."""
    return (float(row["evalue"]), -int(row["bit_score"]),
            int(row["t_len"]), int(row["target_idx"]))


def score_only_align_db(query_db, target_db, result_db, out_db,
                        evalue=1e-3, max_accept=INT_MAX,
                        max_rejected=INT_MAX, cov=0.0, cov_mode=0,
                        seq_id_thr=0.0, min_aln_len=0, params=None,
                        compressed=False, device="cuda"):
    """The align module at --alignment-mode 1 (taxonomy search defaults):
    score-only result lines with accept/reject sequencing."""
    qdb = mmseqsdb.read_seqdb(query_db)
    tdb = mmseqsdb.read_seqdb(target_db)
    q_by_key = {int(k): i for i, k in enumerate(qdb.keys)}
    t_by_key = {int(k): i for i, k in enumerate(tdb.keys)}
    per_query = _candidates_per_query(result_db)
    same_qtdb = str(query_db) == str(target_db)

    p = _permissive(params or Params())
    driver = SearchDriver(p, tdb, device=device)
    qseqs = [qdb.seq_bytes(i) for i in range(len(qdb))]
    qlens = np.array([len(s) for s in qseqs], np.int64)
    pairs = [(q_by_key[qk], t_by_key[tk]) for qk, cand in per_query
             for tk in cand if qk in q_by_key]
    raw = _raw_results(driver, qseqs, pairs)
    accepted = _pass1(per_query, q_by_key, t_by_key, raw, tdb, qlens,
                      evalue, seq_id_thr, min_aln_len, cov, cov_mode,
                      max_accept, max_rejected, same_qtdb)

    out = []
    for qk, _cand in per_query:
        rows = [_score_only_row(h, tk, is_id)
                for tk, h, is_id in accepted.get(qk, [])]
        rows.sort(key=_compare_hits_key)
        payload = "".join(hit_to_matcher_line(r) for r in rows).encode()
        out.append((qk, payload))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES,
                      compressed=compressed)
    return out_db


def lcaalign_db(query_db, target_db, result_db, out_db, evalue=1e-3,
                max_accept=INT_MAX, max_rejected=INT_MAX, cov=0.0,
                cov_mode=0, seq_id_thr=0.0, min_aln_len=0, params=None,
                compressed=False, device="cuda"):
    """lcaalign (accelerated 2bLCA alignment, Alignment.cpp:39-45,444-498)."""
    qdb = mmseqsdb.read_seqdb(query_db)
    tdb = mmseqsdb.read_seqdb(target_db)
    q_by_key = {int(k): i for i, k in enumerate(qdb.keys)}
    t_by_key = {int(k): i for i, k in enumerate(tdb.keys)}
    per_query = _candidates_per_query(result_db)
    same_qtdb = str(query_db) == str(target_db)

    p = _permissive(params or Params())
    driver = SearchDriver(p, tdb, device=device)
    qseqs = [qdb.seq_bytes(i) for i in range(len(qdb))]
    qlens = np.array([len(s) for s in qseqs], np.int64)
    pairs = [(q_by_key[qk], t_by_key[tk]) for qk, cand in per_query
             for tk in cand if qk in q_by_key]
    raw = _raw_results(driver, qseqs, pairs)
    accepted = _pass1(per_query, q_by_key, t_by_key, raw, tdb, qlens,
                      evalue, seq_id_thr, min_aln_len, cov, cov_mode,
                      max_accept, max_rejected, same_qtdb)

    # realign the top hit of each query (realignMaxSeqs=1, bias 0) to get
    # its matched target region
    top_rows = []
    top_query_keys = []
    for qk, _cand in per_query:
        acc = accepted.get(qk, [])
        if not acc:
            continue
        rows = sorted(
            ({"tkey": tk, "h": h, "id": is_id} for tk, h, is_id in acc),
            key=lambda r: (float(r["h"]["evalue"]), -int(r["h"]["bit_score"]),
                           int(r["h"]["t_len"]), r["tkey"]))
        top_rows.append(rows[0]["h"])
        top_query_keys.append(qk)
    if top_rows:
        top_hits = np.array(top_rows, dtype=HIT_DTYPE)
        re_hits, _bts, _sids = driver.realign(
            top_hits, qseqs, realign_score_bias=0.0, realign_max_seqs=1,
            realign_cov=cov, cov_mode=cov_mode)
        re_by_q = {int(h["orf_idx"]): h for h in re_hits}
        surviving = {qk: re_by_q[q_by_key[qk]] for qk in top_query_keys
                     if q_by_key[qk] in re_by_q}
    else:
        surviving = {}

    # the LCA pass: the top hit's matched target region vs every
    # prefilter candidate, threshold = the top hit's E-value
    slice_seqs = []
    slice_meta = []  # (query_key, top_eval)
    slice_pairs = []
    for si, (qk, cand) in enumerate(
            (qk, cand) for qk, cand in per_query if qk in surviving):
        top = surviving[qk]
        # raw hits carry target INDEXES; output rows carry keys
        t_seq = tdb.seq_bytes(int(top["target_idx"]))
        s = bytes(t_seq[int(top["t_start"]):int(top["t_end"]) + 1])
        slice_seqs.append(s)
        slice_meta.append((qk, float(top["evalue"]), cand))
        for tk in cand:
            slice_pairs.append((si, t_by_key[tk]))
    raw2 = _raw_results(driver, slice_seqs, slice_pairs) \
        if slice_pairs else {}

    out = []
    for qk, _cand in per_query:
        if qk not in surviving:
            out.append((qk, b""))
            continue
        si = next(i for i, (k, _e, _c) in enumerate(slice_meta) if k == qk)
        _k, top_eval, cand = slice_meta[si]
        rows = []
        rejected = 0
        for tk in cand:
            if rejected >= max_rejected:
                break
            h = raw2.get((si, t_by_key[tk]))
            ok = False
            if h is not None:
                seq_id = float(estimate_seq_id(
                    np.int32(h["score_raw"]),
                    np.int64(max(int(h["q_end"]), 1)),
                    np.int64(max(int(h["t_end"]), 1))))
                aln_len = max(int(h["q_end"]), int(h["t_end"])) + 2
                ok = (float(h["evalue"]) <= top_eval and
                      seq_id >= seq_id_thr and aln_len >= min_aln_len and
                      has_coverage(cov, cov_mode, 0.0, 0.0))
            if ok:
                rows.append(_score_only_row(h, tk))
                rejected = 0
            else:
                rejected += 1
        rows.sort(key=_compare_hits_key)
        payload = "".join(hit_to_matcher_line(r) for r in rows).encode()
        out.append((qk, payload))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES,
                      compressed=compressed)
    return out_db
