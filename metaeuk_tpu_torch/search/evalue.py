# Copy of metaeuk_tpu/search/evalue.py; it differs from its original only
# in this note and in for_scoring's device keyword (default cuda), which
# it passes on to gumbel.fitted_params.
"""Karlin-Altschul / ALP Gumbel E-value computation.

Port of the reference's EvalueComputation
(lib/mmseqs/src/alignment/EvalueComputation.h) on top of the ALP library's
finite-size-correction area formula
(lib/mmseqs/lib/alp/sls_pvalues.cpp:366-545, sls_alignment_evaluer.cpp:989).

The Gumbel parameters for BLOSUM62 gap 11/1 (and ungapped) are the
precomputed defaults hardcoded in the reference (EvalueComputation.h:57-77);
they are reproduced here as plain numeric data. All arithmetic is float64,
matching the C++ double computation step for step.
"""

import math

import numpy as np

# AlignmentEvaluerParameters order: lambda, K, a1, b1, a2, b2,
# alpha1, beta1, alpha2, beta2, sigma, tau  (sls_basic.hpp:70-84)
# initParameters maps: a_J=a1, a_I=a2, alpha_J=alpha1, alpha_I=alpha2
# (sls_alignment_evaluer.cpp:679-692)
_BLOSUM62_GAPPED_11_1 = dict(
    lam=0.27359865037097330642,
    K=0.044620920658722244834,
    a_J=1.5938724404943873658, b_J=-19.959867650284412122,
    a_I=1.5938724404943873658, b_I=-19.959867650284412122,
    alpha_J=30.455610143099914211, beta_J=-622.28684628915891608,
    alpha_I=30.455610143099914211, beta_I=-622.28684628915891608,
    sigma=29.602444874818868215, tau=-601.81087985041381216,
)

_BLOSUM62_UNGAPPED = dict(
    lam=0.3207378152604042354,
    K=0.13904657125294345166,
    a_J=0.76221128839920349041, b_J=0.0,
    a_I=0.76221128839920349041, b_I=0.0,
    alpha_J=4.5269915477182944841, beta_J=0.0,
    alpha_I=4.5269915477182944841, beta_I=0.0,
    sigma=4.5269915477182944841, tau=0.0,
)

_NUCL_GAPPED_7_1 = dict(
    lam=1.0960171987681839,
    K=0.33538787507026158,
    a_J=2.0290734315292083, b_J=-0.46514786408422282,
    a_I=2.0290734315292083, b_I=-0.46514786408422282,
    alpha_J=5.0543294182155085, beta_J=15.130999712620039,
    alpha_I=5.0543294182155085, beta_I=15.130999712620039,
    sigma=5.0543962679167036, tau=15.129930117400917,
)

# ALP initGapped output (seed 42) for NucleotideMatrix at scale 1.0 with
# the default nucleotide gap costs 5/2 (Parameters.cpp:2423-2424) — the
# configuration proteinaln2nucl builds (proteinaln2nucl.cpp:55-59).
# Extracted once from the vendored ALP library; deterministic.
_NUCL_SCALE1_GAPPED_5_2 = dict(
    lam=0.62092274139392822363,
    K=0.35177597988201619872,
    a_J=0.74528059208662511548, b_J=-0.71027220445456995535,
    a_I=0.74528059208662511548, b_I=-0.71027220445456995535,
    alpha_J=1.0135243407674570104, beta_J=-2.5226486486783059604,
    alpha_I=1.0135243407674570104, beta_I=-2.5226486486783059604,
    sigma=1.0031949332622873694, tau=-2.3780369436059309862,
)

_NAT_CUT_OFF_IN_MAX = 2.0  # sls_pvalues.cpp:46
_CONST_VAL = 1.0 / math.sqrt(2.0 * math.pi)


try:
    # bit-identical to math.erfc (same libm/cephes tail) and vectorized —
    # np.vectorize(math.erfc) was a per-element Python loop that cost
    # minutes at 88M candidate pairs
    from scipy.special import erfc as _erfc
except ImportError:  # pragma: no cover
    _erfc = np.vectorize(math.erfc)


def _normal_probability(x):
    """Phi(x) = 0.5*erfc(-x/sqrt(2)) (sls_basic.hpp:195-198)."""
    return 0.5 * _erfc(-math.sqrt(0.5) * np.asarray(x, dtype=np.float64))


class EvalueComputation:
    """E-values and bit scores for raw Smith-Waterman scores.

    Args:
      db_res_count: total residue count of the target DB (the "m" area term).
      gapped: True for the default gap-11/1 parameters.
    """

    def __init__(self, db_res_count, gapped=True, nucl=False,
                 params=None):
        if params is not None:
            p = params
        elif nucl:
            p = _NUCL_GAPPED_7_1   # EvalueComputation.h:57-63 (gaps 7/1)
        else:
            p = _BLOSUM62_GAPPED_11_1 if gapped else _BLOSUM62_UNGAPPED
        self.p = p
        self.db_res_count = float(db_res_count)
        self.log_k = math.log(p["K"])
        # thresholds from pvalues::compute_tmp_values (sls_pvalues.cpp:343-365)
        lam = p["lam"]
        self.vi_y_thr = max(_NAT_CUT_OFF_IN_MAX * p["alpha_I"] / lam, 0.0)
        self.vj_y_thr = max(_NAT_CUT_OFF_IN_MAX * p["alpha_J"] / lam, 0.0)
        self.c_y_thr = max(_NAT_CUT_OFF_IN_MAX * p["sigma"] / lam, 0.0)

    @classmethod
    def for_scoring(cls, db_res_count, scores, pback, gap_open,
                    gap_extend, gapped=True, device="cuda"):
        """EvalueComputation for an ARBITRARY scoring system: the
        reference's precomputed-table-then-ALP-simulation path
        (EvalueComputation.h:80-110).  The tabulated defaults are used
        when they apply; anything else gets the deterministic seed-42
        Monte-Carlo fit from search/gumbel.py (cached on disk — the
        reference instead re-runs the wall-clock-sized ALP simulation in
        every process).

        scores: (A, A) int matrix (last letter = X/N); pback: (A,)
        background frequencies (the SubstitutionMatrix pBack member)."""
        import numpy as _np
        from ..data.submat import BLOSUM62_SCORES
        scores = _np.asarray(scores)
        if gapped and (gap_open, gap_extend) == (11, 1) \
                and scores.shape == (21, 21) \
                and _np.array_equal(scores, BLOSUM62_SCORES):
            return cls(db_res_count, gapped=True)
        if not gapped and scores.shape == (21, 21) \
                and _np.array_equal(scores, BLOSUM62_SCORES):
            return cls(db_res_count, gapped=False)
        if not gapped:
            # ungapped fit: the simulation with unreachable gap costs
            from .gumbel import fitted_params
            p = fitted_params(scores, pback, 32000, 0, device=device)
            return cls(db_res_count, params=p)
        from .gumbel import fitted_params
        p = fitted_params(scores, pback, int(gap_open), int(gap_extend),
                          device=device)
        return cls(db_res_count, params=p)

    def area(self, score, seq_len):
        """Finite-size-corrected search area
        (get_appr_tail_prob_with_cov_without_errors, sls_pvalues.cpp:366-530).

        m_ = db_res_count (seqlen2), n_ = seq_len (seqlen1); vectorized over
        `score`/`seq_len` arrays.
        """
        p = self.p
        y = np.asarray(score, dtype=np.float64)
        n = np.asarray(seq_len, dtype=np.float64)
        m = self.db_res_count

        m_li_y = m - (p["a_I"] * y + p["b_I"])
        vi_y = np.maximum(self.vi_y_thr, p["alpha_I"] * y + p["beta_I"])
        sqrt_vi_y = np.sqrt(vi_y)
        with np.errstate(divide="ignore"):
            m_F = np.where(sqrt_vi_y == 0.0, 1e100, m_li_y / np.where(sqrt_vi_y == 0.0, 1.0, sqrt_vi_y))
        P_m_F = _normal_probability(m_F)
        E_m_F = -_CONST_VAL * np.exp(-0.5 * m_F * m_F)
        p1 = m_li_y * P_m_F - sqrt_vi_y * E_m_F

        n_lj_y = n - (p["a_J"] * y + p["b_J"])
        vj_y = np.maximum(self.vj_y_thr, p["alpha_J"] * y + p["beta_J"])
        sqrt_vj_y = np.sqrt(vj_y)
        n_F = np.where(sqrt_vj_y == 0.0, 1e100, n_lj_y / np.where(sqrt_vj_y == 0.0, 1.0, sqrt_vj_y))
        P_n_F = _normal_probability(n_F)
        E_n_F = -_CONST_VAL * np.exp(-0.5 * n_F * n_F)
        p2 = n_lj_y * P_n_F - sqrt_vj_y * E_n_F

        c_y = np.maximum(self.c_y_thr, p["sigma"] * y + p["tau"])
        return p1 * p2 + c_y * P_m_F * P_n_F

    def evalue_per_area(self, score):
        """K*exp(-lambda*score) (sls_alignment_evaluer.hpp:154-157)."""
        y = np.asarray(score, dtype=np.float64)
        return self.p["K"] * np.exp(-self.p["lam"] * y)

    def compute_evalue(self, score, seq_len):
        """EvalueComputation::computeEvalue (EvalueComputation.h:36-40)."""
        return self.evalue_per_area(score) * self.area(score, seq_len)

    def compute_bit_score(self, score):
        """(lambda*score - logK)/log2 (sls_alignment_evaluer.hpp:164-167)."""
        y = np.asarray(score, dtype=np.float64)
        return (self.p["lam"] * y - self.log_k) / math.log(2.0)

    def compute_bit_score_int(self, score):
        """int(bitScore + 0.5) as stored in results (Matcher.cpp:130)."""
        return (self.compute_bit_score(score) + 0.5).astype(np.int32)
