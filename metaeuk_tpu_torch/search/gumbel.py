# Copy of metaeuk_tpu/search/gumbel.py; it differs from its original only
# in this note, in the device keyword (default cuda) of _simulate, fit_gapped
# and fitted_params, which _simulate hands to ops/sw_cuda.sw_align_batch
# (K1/K2's uncapped instances on a CUDA device, where the docstring's XLA
# kernel ran; their plain versions on the CPU), and in the default cache
# file's name, so that neither package reads the other's fits.
"""Runtime Gumbel-parameter fitting for arbitrary scoring systems.

The reference computes E-value parameters for non-default
(matrix, gap-open, gap-extend) combinations at runtime with the ALP
library's Monte-Carlo simulation (EvalueComputation.h:91-110 ->
lib/alp/sls_alignment_evaluer.cpp:989 initGapped, seed 42, lambda
tolerance 1%, K tolerance 5%, 60 s budget).  ALP sizes its realization
counts from WALL-CLOCK measurements of its own first iterations
(sls_alp_sim.cpp:223,336,351,439), so its output is a function of
machine speed and load: the reference's E-values for these combinations
are not reproducible across hosts by design.  Byte parity with the
reference is therefore impossible on this path; the contract is ALP's
own tolerance band.

This module fits the same 12-parameter set with a DETERMINISTIC
Monte-Carlo simulation that runs on the accelerator: a fixed-seed batch
of random sequence pairs is aligned with the batched XLA
Smith-Waterman kernel (integer scores are backend-exact), alignment
extents are regressed against score for the finite-size-correction
parameters (a_*, b_*, alpha_*, beta_*, sigma, tau), and (lambda, K) are
fitted by lattice maximum likelihood of the observed score maxima under
the SAME ALP tail-area formula used downstream
(search/evalue.py::EvalueComputation.area), so the fit is
self-consistent with E-value evaluation.  Same seed -> bit-identical
parameters, on any backend.

Validated against the vendored ALP's values (seed 42) for seven
(matrix, gap) combos — VTML80 10/1, blosum80 9/1, blosum62 8/2,
blosum45 13/2, PAM30 9/1, VTML40 13/2, blosum50 10/2 (tools/alpfit,
goldens in tests/test_gumbel.py + tools/gumbel_validate.py): lambda
within 0.8% and K within 6% on six of seven; VTML40-class ultra-strong
matrices carry a bounded residual bias (PARITY_DEVIATIONS.md #6).
"""

import hashlib
import json
import math
import os

import numpy as np

from .evalue import EvalueComputation


def lambda_ungapped(scores, pback):
    """Exact ungapped lattice lambda: solve sum p_i p_j e^{lambda s_ij}=1
    over the real-letter alphabet (Karlin-Altschul; the reference's
    LambdaCalculation role). Deterministic Newton iteration."""
    a = scores.shape[0] - 1  # exclude X/N
    s = np.asarray(scores[:a, :a], np.float64)
    p = np.asarray(pback[:a], np.float64)
    p = p / p.sum()
    pp = p[:, None] * p[None, :]
    lam = 0.5
    for _ in range(200):
        e = np.exp(lam * s)
        f = float((pp * e).sum()) - 1.0
        df = float((pp * s * e).sum())
        step = f / df
        lam -= step
        if abs(step) < 1e-14:
            break
    return lam


def _sample_codes(rng, pback, n, length):
    """(n, length) int32 letters 0..a-2 iid from the background."""
    a = len(pback) - 1
    p = np.asarray(pback[:a], np.float64)
    cum = np.cumsum(p / p.sum())
    u = rng.random((n, length))
    return np.searchsorted(cum, u).astype(np.int32)


def _simulate(scores, pback, gap_open, gap_extend, seed, n_pairs, length,
              chunk, device="cuda"):
    """Align n_pairs random pairs; returns (S, len_I, len_J) int arrays.
    Integer SW on any backend is bit-deterministic for a fixed seed."""
    from ..ops.sw_cuda import sw_align_batch

    rng = np.random.default_rng(seed)
    S = np.zeros(n_pairs, np.int64)
    len_i = np.zeros(n_pairs, np.int64)
    len_j = np.zeros(n_pairs, np.int64)
    lens = np.full(chunk, length, np.int32)
    for s0 in range(0, n_pairs, chunk):
        b = min(chunk, n_pairs - s0)
        q = _sample_codes(rng, pback, chunk, length)
        t = _sample_codes(rng, pback, chunk, length)
        bias = np.zeros((chunk, length), np.int32)
        # ALP's model charges a length-L gap open + L*extend
        # (sls_alp_data.cpp:274 d_open1=open1_+epen1_; header comment at
        # sls_alignment_evaluer.cpp:351); our kernel's open covers the
        # first gapped position, so shift one extend into the open
        sc, qs, qe, ts, te = sw_align_batch(
            q, bias, lens, t, lens, submat=scores,
            go=int(gap_open) + int(gap_extend), ge=int(gap_extend),
            device=device)
        S[s0:s0 + b] = sc[:b]
        len_j[s0:s0 + b] = (qe - qs + 1)[:b]   # J = sequence 1 (query)
        len_i[s0:s0 + b] = (te - ts + 1)[:b]   # I = sequence 2 (target)
    return S, len_i, len_j


def _simulate_islands(scores, pback, gap_open, gap_extend, seed,
                      n_pairs, length, margin, c_min):
    """Island peak scores (int64 array) from n_pairs random (length,
    length) comparisons via the native affine-gap island scan
    (host_ops.cpp sw_islands).  Deterministic in all inputs; islands
    with anchors within margin of the right/bottom edges are excluded
    by the native side so truncation cannot bias the tail."""
    import ctypes
    from .. import native

    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("island simulation requires the native library")
    if not getattr(lib, "_isl_bound", False):
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.sw_islands.restype = ctypes.c_int64
        lib.sw_islands.argtypes = [u8p, u8p, ctypes.c_int64,
                                   ctypes.c_int64, i32p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int64,
                                   i32p, ctypes.c_int64]
        lib._isl_bound = True
    a = len(pback) - 1
    sub = np.ascontiguousarray(np.asarray(scores)[:a, :a], np.int32)
    rng = np.random.default_rng(seed)
    q = np.ascontiguousarray(
        _sample_codes(rng, pback, n_pairs, length).astype(np.uint8))
    t = np.ascontiguousarray(
        _sample_codes(rng, pback, n_pairs, length).astype(np.uint8))
    cap = max(1 << 22, 4 * n_pairs * length)
    out = np.empty(cap, np.int32)
    # ALP charges a length-L gap open + L*extend (see _simulate)
    n = lib.sw_islands(q.reshape(-1), t.reshape(-1), n_pairs, length,
                       sub.reshape(-1), a,
                       int(gap_open) + int(gap_extend), int(gap_extend),
                       int(margin), int(c_min), out, cap)
    if n > cap:
        out2 = np.empty(int(n), np.int32)
        n = lib.sw_islands(q.reshape(-1), t.reshape(-1), n_pairs, length,
                           sub.reshape(-1), a,
                           int(gap_open) + int(gap_extend),
                           int(gap_extend), int(margin), int(c_min),
                           out2, int(n))
        out = out2
    return np.sort(out[:n].astype(np.int64))


def _ols(x, y):
    """(slope, intercept) float64 least squares."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xm, ym = x.mean(), y.mean()
    vx = ((x - xm) ** 2).sum()
    slope = (((x - xm) * (y - ym)).sum() / vx) if vx > 0 else 0.0
    return slope, ym - slope * xm


def fit_gapped(scores, pback, gap_open, gap_extend, seed=42,
               n_pairs=262144, length=384, chunk=4096,
               isl_pairs=4096, isl_length=1024, isl_margin=192,
               isl_cmin=14, isl_tail=12000, device="cuda"):
    """Fit the 12 ALP parameters for an integer substitution matrix
    (alph x alph, last letter = X/N wildcard), background frequencies
    and affine gap costs (gap of length L costs open + (L-1)*extend —
    the ALP model, sls_alp.cpp:1147).  Deterministic in all inputs.

    The finite-size parameters (a/b/alpha/beta/sigma/tau) come from
    extent-vs-score regressions over n_pairs maxima aligned on the
    accelerator; (lambda, K) come from the island method (Altschul et
    al. 2001, "The estimation of statistical parameters for local
    alignment score distributions"): every maximal positive excursion
    of the SW matrix contributes a peak score, lambda is the lattice
    maximum-likelihood fit of the island tail above an adaptive
    threshold c (the largest keeping >= isl_tail islands), and K
    follows from the island count n(>=c) = K * area * e^{-lambda c}
    — thousands of islands per pair give far tighter estimates than
    one maximum per pair."""
    scores = np.asarray(scores, np.int64)
    S, len_i, len_j = _simulate(scores, pback, gap_open, gap_extend,
                                seed, n_pairs, length, chunk, device=device)

    # --- finite-size regressions (ALP's linear models: E[len|s], ---
    # --- Var[len|s], Cov[len_I,len_J|s] all linear in s) ---
    a_I, b_I = _ols(S, len_i)
    a_J, b_J = _ols(S, len_j)
    ri = len_i - (a_I * S + b_I)
    rj = len_j - (a_J * S + b_J)
    alpha_I, beta_I = _ols(S, ri * ri)
    alpha_J, beta_J = _ols(S, rj * rj)
    sigma, tau = _ols(S, ri * rj)
    # variances/covariance are nonnegative quantities; clamp the
    # intercepts so the thresholds in the area formula stay sane
    alpha_I = max(alpha_I, 0.0)
    alpha_J = max(alpha_J, 0.0)
    sigma = max(min(sigma, math.sqrt(alpha_I * alpha_J)
                    if alpha_I * alpha_J > 0 else sigma), 0.0)

    # --- (lambda, K) by the island method ---
    isl_margin = min(int(isl_margin), int(isl_length) // 4)
    isl = _simulate_islands(scores, pback, gap_open, gap_extend, seed + 1,
                            isl_pairs, isl_length, isl_margin, isl_cmin)
    area = float(isl_length - isl_margin) ** 2
    # Band placement: the island tail is only asymptotically geometric,
    # and for strong matrices its conditional distribution carries a
    # reproducible period-~8 score modulation (measured across seeds),
    # so single-threshold estimates are phase-biased.  Take the deepest
    # c keeping >= isl_tail islands, estimate lambda from the count
    # RATIO across one full period, lambda = ln(n(>=c-8)/n(>=c))/8
    # (phase-insensitive, large counts), and K phase-AVERAGED over the
    # band via n(>=c) = K * pairs * area * e^{-lambda c} (the same
    # convention the downstream tail-area formula uses).  Validated vs
    # the vendored ALP on seven (matrix, gap) combos: lambda within
    # 0.8% and K within 6%, except ultra-strong matrices (VTML40-class)
    # whose pre-asymptotic region extends past the simulated score
    # range (PARITY_DEVIATIONS.md #6).
    c = int(isl_cmin) + 2
    while len(isl[isl >= c + 1]) >= int(isl_tail):
        c += 1
    c_lo = max(int(isl_cmin), c - 8)
    n_hi = int((isl >= c).sum())
    n_lo = int((isl >= c_lo).sum())
    if c > c_lo and n_hi >= 200 and n_lo > n_hi:
        lam = math.log(n_lo / n_hi) / (c - c_lo)
        k = float(np.mean([
            int((isl >= cc).sum()) * math.exp(lam * cc)
            / (isl_pairs * area) for cc in range(c_lo, c)]))
    else:
        # smoke-scale fallback: geometric ML on the span-g lattice
        # (lambda = ln(1 + g*n/sum)/g) at the single threshold c
        tail = isl[isl >= c]
        exc = tail - c
        pos = np.unique(exc[exc > 0])
        g = int(np.gcd.reduce(pos)) if len(pos) else 1
        lam = math.log1p(g * len(exc) / float(exc.sum())) / g \
            if len(exc) and exc.sum() > 0 \
            else lambda_ungapped(scores, pback)
        k = len(tail) * math.exp(lam * c) / (isl_pairs * area) \
            if len(tail) else 0.041

    return dict(lam=float(lam), K=float(k),
                a_J=float(a_J), b_J=float(b_J),
                a_I=float(a_I), b_I=float(b_I),
                alpha_J=float(alpha_J), beta_J=float(beta_J),
                alpha_I=float(alpha_I), beta_I=float(beta_I),
                sigma=float(sigma), tau=float(tau))


_FIT_CACHE_PATH = os.environ.get(
    "METAEUK_GUMBEL_CACHE",
    os.path.join(os.path.expanduser("~"), ".cache",
                 "metaeuk_tpu_torch_gumbel.json"))
_mem_cache = {}


def fitted_params(scores, pback, gap_open, gap_extend, device="cuda", **kw):
    """fit_gapped with an in-process + on-disk cache keyed by the exact
    scoring system (a fit costs seconds of device time)."""
    h = hashlib.blake2b(digest_size=12)
    h.update(np.ascontiguousarray(scores, np.int64).tobytes())
    h.update(np.ascontiguousarray(pback, np.float64).tobytes())
    key = f"{h.hexdigest()}_{int(gap_open)}_{int(gap_extend)}"
    if key in _mem_cache:
        return dict(_mem_cache[key])
    disk = {}
    try:
        with open(_FIT_CACHE_PATH) as f:
            disk = json.load(f)
    except (OSError, ValueError):
        pass
    if key in disk:
        _mem_cache[key] = disk[key]
        return dict(disk[key])
    p = fit_gapped(scores, pback, gap_open, gap_extend, device=device, **kw)
    _mem_cache[key] = p
    disk[key] = p
    try:
        os.makedirs(os.path.dirname(_FIT_CACHE_PATH), exist_ok=True)
        with open(_FIT_CACHE_PATH, "w") as f:
            json.dump(disk, f)
    except OSError:
        pass
    return p
