"""E-values, bit scores and the hit list of the plain reference, as
MMseqs2's alignment module writes them.

- E-value: Karlin-Altschul with ALP's finite-size correction
  (EvalueComputation.h computeEvalue over sls_pvalues.cpp:366-545), the
  tabulated BLOSUM62 gap 11/1 parameters (EvalueComputation.h:57-77),
  float64 step for step; the DB size is its residue count.
- bit score int(bits + 0.5); sequence identity estimated from the score
  per column in float32 (Matcher::estimateSeqIdByScorePerCol).
- Alignment::checkCriteria (E-value, alignment length) and
  Matcher::compareHits order (E-value asc, bits desc, target length asc,
  target asc); Matcher::resultToBuffer's 10 columns.
"""

import math

import numpy as np
from scipy.special import erfc

_P = dict(lam=0.27359865037097330642, K=0.044620920658722244834,
          a_J=1.5938724404943873658, b_J=-19.959867650284412122,
          a_I=1.5938724404943873658, b_I=-19.959867650284412122,
          alpha_J=30.455610143099914211, beta_J=-622.28684628915891608,
          alpha_I=30.455610143099914211, beta_I=-622.28684628915891608,
          sigma=29.602444874818868215, tau=-601.81087985041381216)
_CONST = 1.0 / math.sqrt(2.0 * math.pi)


def _phi(x):
    return 0.5 * erfc(-math.sqrt(0.5) * np.asarray(x, np.float64))


def evalue(score, q_len, db_res):
    """E-values of raw scores for queries of q_len against db_res
    residues."""
    p = _P
    y = np.asarray(score, np.float64)
    n = np.asarray(q_len, np.float64)
    m = float(db_res)
    lam = p["lam"]

    def side(length, a, b, alpha, beta):
        li = length - (a * y + b)
        v = np.maximum(max(2.0 * alpha / lam, 0.0), alpha * y + beta)
        sv = np.sqrt(v)
        with np.errstate(divide="ignore"):
            f = np.where(sv == 0.0, 1e100, li / np.where(sv == 0.0, 1.0, sv))
        pf = _phi(f)
        return li * pf - sv * (-_CONST * np.exp(-0.5 * f * f)), pf

    p1, pm = side(m, p["a_I"], p["b_I"], p["alpha_I"], p["beta_I"])
    p2, pn = side(n, p["a_J"], p["b_J"], p["alpha_J"], p["beta_J"])
    c = np.maximum(max(2.0 * p["sigma"] / lam, 0.0), p["sigma"] * y + p["tau"])
    area = p1 * p2 + c * pm * pn
    return p["K"] * np.exp(-lam * y) * area


def bits(score):
    y = np.asarray(score, np.float64)
    b = (_P["lam"] * y - math.log(_P["K"])) / math.log(2.0)
    return (b + 0.5).astype(np.int32)


def seq_id(score, q_aln, t_aln):
    m = np.maximum(np.maximum(q_aln, t_aln), 1).astype(np.float32)
    est = ((np.asarray(score).astype(np.float32) / m).astype(np.float64)
           * 0.1656 + 0.1141).astype(np.float32)
    return np.clip(est, np.float32(0.0), np.float32(1.0))


def hit_table(q_idx, t_idx, aln, q_len, t_len, db_res, evalue_thr,
              aln_len_thr):
    """The hits of one query set: a dict of columns, filtered and in
    compareHits order per query. aln is sw.align's dict; q_idx/t_idx,
    q_len/t_len its pairs' indices and lengths."""
    sc = aln["score"]
    ev = evalue(sc, q_len, db_res)
    ok = (aln["t_end"] >= 0) & (sc > 0) & (aln["t_start"] >= 0) \
        & (ev <= evalue_thr)
    qs, qe, ts, te = aln["q_start"], aln["q_end"], aln["t_start"], aln["t_end"]
    alen = np.maximum(np.abs(qe - qs), np.abs(te - ts)) + 1
    ok &= alen >= aln_len_thr
    h = dict(q=q_idx, t=t_idx, score=sc, bits=bits(sc), evalue=ev,
             seq_id=seq_id(sc, np.maximum(qe - qs, 1), np.maximum(te - ts, 1)),
             q_start=qs, q_end=qe, q_len=q_len, t_start=ts, t_end=te,
             t_len=t_len)
    h = {k: np.asarray(v)[ok] for k, v in h.items()}
    order = np.lexsort((h["t"], h["t_len"], -h["bits"], h["evalue"], h["q"]))
    return {k: v[order] for k, v in h.items()}


def seq_id_text(s):
    """Util::fastSeqIdToBuffer, with resultToBuffer's "1.00" for 1."""
    s = np.float32(s)
    if s == np.float32(1.0):
        return "1.00"
    out = "0."
    if s < np.float32(0.10):
        out += "0"
    if s < np.float32(0.01):
        out += "0"
    return out + str(int(s * np.float32(1000)))


def lines(h):
    """resultToBuffer's 10-column line of each hit row."""
    return [f"{h['t'][r]}\t{h['bits'][r]}\t{seq_id_text(h['seq_id'][r])}\t"
            f"{'%.3E' % h['evalue'][r]}\t{h['q_start'][r]}\t{h['q_end'][r]}\t"
            f"{h['q_len'][r]}\t{h['t_start'][r]}\t{h['t_end'][r]}\t"
            f"{h['t_len'][r]}\n" for r in range(len(h["q"]))]
