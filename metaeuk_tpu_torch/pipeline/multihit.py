# Copy of metaeuk_tpu/pipeline/multihit.py; it differs from its original only in this note.
"""Multi-hit aggregation (the multihit module).

Ports of lib/mmseqs/src/multihit/{Aggregation,besthitperset,
combinepvalperset}.cpp: group per-query result lines by target SET (via
an element->set map DB), then

  besthitperset:      keep the best line per set, column 1 replaced by a
                      calibrated log P-value (simple mode: log of the
                      corrected best E-value; else second-best minus best
                      -log p score, besthitperset.cpp:29-113)
  combinepvalperset:  per-set aggregate P-value with four modes
                      (combinepvalperset.cpp:86-212): 0 multihit
                      (truncated Fisher with precomputed log B_i),
                      1 min P-value, 2 product, 3 truncated product

Output lines use the reference's text formats ('%.3E' via SSTR(double)).
"""

import math

from ..io import mmseqsdb

DBL_MIN = 2.2250738585072014e-308
DBL_MAX = 1.7976931348623157e308


def _fmt(x):
    """SSTR(double) = fmt '{:.3E}' (Util.cpp:658-660)."""
    return "%.3E" % x


def _group_by_set(payload, elem_to_set):
    """Aggregation::buildMap (Aggregation.cpp:24-45): std::map ->
    ascending set key order."""
    groups = {}
    for line in payload.decode().split("\n"):
        if not line:
            continue
        cols = line.split("\t")
        set_key = elem_to_set[int(cols[0])]
        groups.setdefault(set_key, []).append(cols)
    return dict(sorted(groups.items()))


def besthitperset(result_db, target_map_db, target_set_size_db, out_db,
                  simple_best_hit=True):  # par.simpleBestHit default true
    elem_to_set = {k: int(v.decode().split()[0])
                   for k, v in mmseqsdb.read_db(target_map_db)}
    set_size = {k: int(v.decode().split()[0])
                for k, v in mmseqsdb.read_db(target_set_size_db)}
    out = []
    for qkey, payload in mmseqsdb.read_db(result_db):
        buf = []
        for set_key, rows in _group_by_set(payload, elem_to_set).items():
            n_genes = set_size[set_key]
            best_score = -DBL_MAX
            second_best = -DBL_MAX
            best_eval = DBL_MAX
            best = None
            simple = simple_best_hit or len(rows) < 2
            for cols in rows:
                ev = float(cols[3])
                pval = ev / n_genes
                if pval == 0:
                    pval = DBL_MIN
                score = -math.log(pval)
                if simple:
                    if best_eval > ev:
                        best_eval = ev
                        best = cols
                else:
                    if score >= best_score:
                        second_best = best_score
                        best_score = score
                        best = cols
                    elif score > second_best:
                        second_best = score
            if simple:
                if best_eval == 0:
                    log_pval = math.log(DBL_MIN)
                elif 0 < best_eval < 10e-4:
                    log_pval = math.log(best_eval)
                else:
                    log_pval = math.log(1 - math.exp(-best_eval))
            else:
                log_pval = second_best - best_score
            if best is None:
                continue
            cols = list(best)
            cols[1] = _fmt(log_pval)
            buf.append("\t".join(cols))
        out.append((qkey, ("".join(r + "\n" for r in buf)).encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES)
    return out_db


def _precompute_log_b(orf_count, pval_thr, lgamma):
    log_thr = math.log(pval_thr)
    log_1m = math.log(1 - pval_thr)
    logb = [0.0] * orf_count
    logb[orf_count - 1] = orf_count * log_thr
    for i in range(orf_count - 2, -1, -1):
        k = i + 1
        lbin = lgamma(orf_count + 1) - lgamma(orf_count - k + 1) \
            - lgamma(k + 1)
        new_term = lbin + k * log_thr + (orf_count - k) * log_1m
        logb[i] = logb[i + 1] + math.log(1 + math.exp(new_term - logb[i + 1]))
    return logb


def combinepvalperset(result_db, query_set_size_db, target_map_db,
                      target_set_size_db, out_db, alpha=1.0,
                      aggregation_mode=0):
    elem_to_set = {k: int(v.decode().split()[0])
                   for k, v in mmseqsdb.read_db(target_map_db)}
    q_size = {k: int(v.decode().split()[0])
              for k, v in mmseqsdb.read_db(query_set_size_db)}
    n_target_sets = sum(1 for _ in mmseqsdb.read_db(target_set_size_db))
    out = []
    for qkey, payload in mmseqsdb.read_db(result_db):
        orf_count = q_size[qkey]
        buf = []
        for set_key, rows in _group_by_set(payload, elem_to_set).items():
            log_pvals = [float(c[1]) for c in rows]
            line = f"{set_key}\t"
            if aggregation_mode == 0:           # multihit truncated Fisher
                thr = alpha / (orf_count + 1)
                # SSTR(size_t) renders the edge cases as plain integers
                if thr == 0.0:
                    buf.append(line + str(n_target_sets))
                    continue
                log_thr = math.log(thr)
                r = 0.0
                for lp in log_pvals:
                    if lp < log_thr:
                        r -= lp - log_thr
                if r == 0:
                    buf.append(line + str(n_target_sets))
                    continue
                if math.isinf(r):
                    buf.append(line + "0")
                    continue
                exp_minus_r = math.exp(-r)
                if thr == 1.0:
                    buf.append(line + _fmt(exp_minus_r * n_target_sets))
                    continue
                logb = _precompute_log_b(orf_count, thr, math.lgamma)
                log_r = math.log(r)
                fisher = 0.0
                for i in range(orf_count):
                    fisher += math.exp(i * log_r - math.lgamma(i + 1)
                                       + logb[i])
                updated = exp_minus_r * fisher
            elif aggregation_mode == 1:         # min p-value
                min_lp = min([lp for lp in log_pvals if lp < 0], default=0.0)
                updated = 1 - math.exp(-math.exp(min_lp) * orf_count)
            elif aggregation_mode == 2:         # product
                updated = math.exp(sum(log_pvals))
            elif aggregation_mode == 3:         # truncated product score
                log_thr = math.log(alpha / (orf_count + 1))
                min_lp = 0.0
                sum_lp = 0.0
                k = 0
                for lp in log_pvals:
                    if lp < min_lp:
                        min_lp = lp if lp == 0 else -lp
                    if lp < log_thr:
                        sum_lp -= lp - log_thr
                        k += 1
                if k == 0:
                    buf.append(line + _fmt(min_lp))
                else:
                    buf.append(line + _fmt(sum_lp - log_thr))
                continue
            else:
                raise ValueError("invalid aggregation mode")
            buf.append(line + _fmt(updated * n_target_sets))
        out.append((qkey, ("".join(r + "\n" for r in buf)).encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES)
    return out_db
