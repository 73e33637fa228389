"""ctypes bindings for the native C++ host layer (native/host_ops.cpp,
native/prefilter.cpp, native/nucl_align.cpp and native/prefilter_nucl.cpp
at the root of the repository).

Counterpart of metaeuk_tpu/native.py, with three differences. The library
is built with g++ into metaeuk_tpu_torch/build/ (listed in .gitignore), under
a name that carries a digest of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded; the JAX package's
native/libmetaeuk_host.so is never loaded. Build and load hold a lock, so a
thread that asks while another thread builds waits for the library instead
of getting None. Only the entry points that the port's host stages call are
bound here (comp_bias, orf_scan_strand, chain_dp, chain_dp_groups,
banded_sw_traceback, banded_sw_traceback_prof, rcp_nr; the prefilters,
the nucleotide aligner and the island scan of search/gumbel.py bind their
own). build_library builds search/fwbw.py's library (native/fwbw.cpp,
with its own flags) the same way. Each entry point but rcp_nr returns None
when the library is unavailable, and its callers then fall back to Python;
rcp_nr raises, since its callers' fallback (an exact division) gives other
bytes.
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_LIB = None
_TRIED = False
_LOCK = threading.Lock()

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
_SRCS = [_NATIVE_DIR / "host_ops.cpp", _NATIVE_DIR / "prefilter.cpp",
         _NATIVE_DIR / "nucl_align.cpp", _NATIVE_DIR / "prefilter_nucl.cpp"]
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
          "-fopenmp")


def _digest_path(stem, srcs, flags):
    """build/<stem>-<digest>.so for these sources and flags."""
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        h.update(s.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def library_path():
    """build/libmetaeuk_host-<digest>.so for the current sources and flags."""
    return _digest_path("libmetaeuk_host", _SRCS, _FLAGS)


def _build(so, srcs=_SRCS, flags=_FLAGS):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *flags, *[str(s) for s in srcs], "-o",
                    str(tmp)], check=True, capture_output=True)
    os.replace(tmp, so)


def build_library(stem, names, flags):
    """Builds native/<names> with g++ and these flags into
    build/<stem>-<digest>.so, under the loader's lock, unless that file
    exists; returns its path. Raises when g++ fails."""
    srcs = [_NATIVE_DIR / n for n in names]
    so = _digest_path(stem, srcs, flags)
    with _LOCK:
        if not so.exists():
            _build(so, srcs, flags)
    return so


def get_lib():
    """The loaded native library, or None if it cannot be built or loaded.
    Thread-safe: the first caller builds and loads under the lock, and every
    concurrent caller waits for that attempt's result."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if _TRIED:
            return _LIB
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.orf_scan_strand.restype = ctypes.c_int64
            lib.orf_scan_strand.argtypes = [
                u8p, ctypes.c_int64, u8p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                i64p, i64p, u8p, i64p]
            lib.chain_dp.restype = None
            lib.chain_dp.argtypes = [
                ctypes.c_int64, i64p, i64p, i64p, i64p, i64p, i64p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_double, i64p, i64p, i64p, i64p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64)]
            _LIB = lib
        except Exception:
            _LIB = None
        _TRIED = True
    return _LIB


def bind_comp_bias(lib):
    """Bind the calcLocalAaBiasCorrection port (host_ops.cpp comp_bias);
    copied from metaeuk_tpu/native.py:66."""
    if getattr(lib, "_cb_bound", False):
        return
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.comp_bias.restype = None
    lib.comp_bias.argtypes = [u8p, ctypes.c_int64, i32p, ctypes.c_int64,
                              f64p, ctypes.c_double, f32p]
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    lib.comp_bias_batch_i8.restype = None
    lib.comp_bias_batch_i8.argtypes = [u8p, i64p, ctypes.c_int64, i32p,
                                       ctypes.c_int64, f64p,
                                       ctypes.c_double, i8p]
    lib._cb_bound = True


def orf_scan_strand(seq_upper, stop_codons, min_len, max_len, max_gaps):
    """Native strand scan; returns (from, to, inc_start, inc_end, close)
    or None when the library is unavailable (copied from
    metaeuk_tpu/native.py:167)."""
    lib = get_lib()
    if lib is None:
        return None
    seq = np.ascontiguousarray(seq_upper, dtype=np.uint8)
    n = len(seq)
    cap = n // 3 + 8
    out_from = np.empty(cap, np.int64)
    out_to = np.empty(cap, np.int64)
    out_flags = np.empty(cap, np.uint8)
    out_close = np.empty(cap, np.int64)
    stops = np.frombuffer("".join(stop_codons).encode(), dtype=np.uint8).copy()
    cnt = lib.orf_scan_strand(seq, n, stops, len(stop_codons),
                              min_len, max_len, max_gaps,
                              out_from, out_to, out_flags, out_close)
    return (out_from[:cnt], out_to[:cnt],
            (out_flags[:cnt] & 1).astype(bool),
            (out_flags[:cnt] & 2).astype(bool), out_close[:cnt])


def chain_dp_groups(starts, contig_start, contig_end, t_start, t_end,
                    bit_score, aa_len, target_len, params):
    """Batched single-round chaining over group-contiguous candidate
    columns (native OpenMP; sorting + DP + traceback per group).
    Returns (best_score (G,), path_len (G,), path (N,) global indices)
    or None when the library is unavailable (copied from
    metaeuk_tpu/native.py:189)."""
    lib = get_lib()
    if lib is None:
        return None
    if not getattr(lib, "_cdg_bound", False):
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.chain_dp_groups.restype = None
        lib.chain_dp_groups.argtypes = [ctypes.c_int64] + [i64p] * 8 + \
            [ctypes.c_int64] * 5 + [ctypes.c_double] + [i64p] * 3
        lib._cdg_bound = True
    starts = np.ascontiguousarray(starts, np.int64)
    n_groups = len(starts) - 1
    arrs = [np.ascontiguousarray(a, np.int64)
            for a in (contig_start, contig_end, t_start, t_end,
                      bit_score, aa_len, target_len)]
    best = np.empty(n_groups, np.int64)
    plen = np.empty(n_groups, np.int64)
    path = np.empty(int(starts[-1]), np.int64)
    lib.chain_dp_groups(n_groups, starts, *arrs,
                        params.min_intron_length, params.max_intron_length,
                        params.max_aa_overlap, params.set_gap_open_penalty,
                        params.set_gap_extend_penalty,
                        params.metaeuk_tcov_thr, best, plen, path)
    return best, plen, path


def chain_dp(contig_start, contig_end, t_start, t_end, bit_score, aa_len,
             target_len, params):
    """Native chaining DP; returns (prev_id, path_score, best_last,
    best_score) or None when the library is unavailable (copied from
    metaeuk_tpu/native.py:220)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(contig_start)
    arrs = [np.ascontiguousarray(a, dtype=np.int64)
            for a in (contig_start, contig_end, t_start, t_end,
                      bit_score, aa_len)]
    prev_id = np.empty(n, np.int64)
    path_score = np.empty(n, np.int64)
    num_exons = np.empty(n, np.int64)
    path_aa_len = np.empty(n, np.int64)
    best_last = ctypes.c_int64()
    best_score = ctypes.c_int64()
    lib.chain_dp(n, *arrs, int(target_len),
                 params.min_intron_length, params.max_intron_length,
                 params.max_aa_overlap, params.set_gap_open_penalty,
                 params.set_gap_extend_penalty, params.metaeuk_tcov_thr,
                 prev_id, path_score, num_exons, path_aa_len,
                 ctypes.byref(best_last), ctypes.byref(best_score))
    return prev_id, path_score, int(best_last.value), int(best_score.value)


def banded_sw_traceback(q_enc, bias, t_enc, score, band_width,
                        go=11, ge=1, submat=None):
    """CIGAR op string (M/I/D bytes) for an accepted alignment window
    (native banded_sw port); None when the library is unavailable.
    submat: 21x21 int32 override (the --realign -0.2-biased matrix).
    Copied from metaeuk_tpu/native.py:86; bound under the loader's lock."""
    lib = get_lib()
    if lib is None:
        return None
    with _LOCK:
        if not getattr(lib, "_bt_bound", False):
            i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.banded_sw_traceback.restype = ctypes.c_int64
            lib.banded_sw_traceback.argtypes = [
                u8p, i8p, u8p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, i32p, ctypes.c_int64, u8p, ctypes.c_int64]
            lib._bt_bound = True
    from .data.submat import BLOSUM62_SCORES
    if submat is None:
        submat = BLOSUM62_SCORES
    q = np.ascontiguousarray(q_enc, np.uint8)
    b = np.ascontiguousarray(bias, np.int8)
    t = np.ascontiguousarray(t_enc, np.uint8)
    cap = len(q) + len(t) + 4
    out = np.zeros(cap, np.uint8)
    n = lib.banded_sw_traceback(
        q, b, t, len(q), len(t), int(score), go, ge, int(band_width),
        np.ascontiguousarray(submat, np.int32), 21, out, cap)
    if n < 0:
        return None
    return out[:n].tobytes().decode()


def banded_sw_traceback_prof(prof, t_enc, score, band_width, go=11, ge=1):
    """Profile-query CIGAR ops (the PROFILE_SEQ banded_sw path,
    StripedSmithWaterman.cpp:1474): prof = (L, 21) int32 PSSM window
    rows. None when the library is unavailable (copied from
    metaeuk_tpu/native.py:120; bound under the loader's lock)."""
    lib = get_lib()
    if lib is None:
        return None
    with _LOCK:
        if not getattr(lib, "_btp_bound", False):
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.banded_sw_traceback_prof.restype = ctypes.c_int64
            lib.banded_sw_traceback_prof.argtypes = [
                i32p, u8p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, u8p, ctypes.c_int64]
            lib._btp_bound = True
    prof = np.ascontiguousarray(prof, np.int32)
    t = np.ascontiguousarray(t_enc, np.uint8)
    q_len = prof.shape[0]
    cap = q_len + len(t) + 4
    out = np.zeros(cap, np.uint8)
    n = lib.banded_sw_traceback_prof(
        prof.reshape(-1), t, q_len, len(t), int(score), go, ge,
        int(band_width), prof.shape[1], out, cap)
    if n < 0:
        return None
    return out[:n].tobytes().decode()


def rcp_nr(x):
    """Hardware rcpps + one Newton-Raphson iteration per element (the
    reference's simdf32_rcp recipe, PSSMCalculator.cpp:506-520), float32 in
    and out (copied from metaeuk_tpu/native.py:149; bound under the
    loader's lock). Raises when the library is unavailable, and never
    returns None: ops/pssm.py's exact-division fallback would give other
    bytes than the reference's."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("rcp_nr needs the native host library, which "
                           "could not be built or loaded")
    with _LOCK:
        if not getattr(lib, "_rcp_bound", False):
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            lib.rcp_nr.restype = None
            lib.rcp_nr.argtypes = [f32p, f32p, ctypes.c_int64]
            lib._rcp_bound = True
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty_like(x)
    lib.rcp_nr(x.ravel(), out.ravel(), x.size)
    return out.reshape(x.shape)
