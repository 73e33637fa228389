"""Smith-Waterman alignment: wrappers over the CUDA kernels in
csrc/sw_pair.cu (pair-batched), csrc/sw_qm.cu (query-major) and
csrc/sw_qm_rt.cu (query-major for long queries, a warp per pair),
dispatched by the device of the tensors given.

- A CPU tensor goes to the plain PyTorch version (ops/sw_torch.py).
- A CUDA tensor launches the kernel, or raises. There is no fallback.

Counterparts in the JAX package (metaeuk_tpu/ops/sw_pallas.py): sw_ends is
sw_pallas_ends / _sw_pallas_ends_from_S over _build_S_gapped (K1), sw_starts
is _sw_pallas_starts_from_S (K2), align_full is _align_full /
_align_from_S; with cap=None (sw_pair_ends_nocap / sw_pair_starts_nocap,
K1/K2's uncapped instances, H not capped at 32767 and handed on in 32 bits)
the three are metaeuk_tpu/ops/sw_jax.py's sw_batch_ends, sw_batch_starts and
sw_align_batch, the XLA code of the realign pass, which has no Pallas
kernel; sw_ends_prof, sw_starts_prof and align_full_prof are the
same kernels on PSSM queries (_align_full_prof over _build_S_prof), read
from staged profile and fragment matrices by pair indices, with no gathered
(B, Lq, 21) copy on the card; with cap=None (sw_pair_ends_prof_nocap /
sw_pair_starts_prof_nocap) they are sw_jax.py's sw_batch_ends_prof and
sw_align_batch_prof, the XLA code of the profile-query aligner
(search/profile_align.py), which has no Pallas kernel either. Batches
need no padding to a tile multiple: a group of G lanes aligns one pair,
with the fragment's rows in registers (csrc/sw_pair.cu; pair_classes bins
a launch's pairs by fragment length, one G a class, and the kernels write
each output at its pair's place).
qm_ends and qm_starts are _align_ends_qm and _align_starts_qm over
build_prof_tiles / build_tcodes_T (K3, K4): one query row per tile of TB =
128 target lanes, read from the staged matrices. Their CUDA kernels
(csrc/sw_qm.cu) are K1/K2's lane groups (csrc/sw_group.cuh) on the tiles'
lanes, each lane in the length class of the rows it sweeps and each block
ranking its tile's lanes by the columns they sweep: K3 stages each tile's
query profile once for all its groups; K4, whose lanes end at cells of
their own, stages one a group as K2 does. Neither takes a work list from
the host or holds an H/E scratch.
qm_ends_rt and qm_starts_rt are the same calls for Lq > 4096, which the JAX
package runs on the row-tiled _qm_call_rt (K5, K6). Their CUDA kernels
(csrc/sw_qm_rt.cu) take no row tile: a warp aligns one lane's pair with the
target's columns in registers and no H/E scratch.

LAUNCHES counts kernel launches and PLAIN_CALLS calls that went to the plain
version, per kernel; reset_counts() sets both to zero.
"""

import ctypes
import functools

import numpy as np
import torch

from . import _build, sw_torch
from .. import state
from ..data.submat import BLOSUM62_SCORES
from ..state import default_scoring

KERNELS = ("sw_pair_ends", "sw_pair_starts", "sw_pair_ends_nocap",
           "sw_pair_starts_nocap", "sw_pair_ends_prof",
           "sw_pair_starts_prof", "sw_pair_ends_prof_nocap",
           "sw_pair_starts_prof_nocap", "sw_qm_ends", "sw_qm_starts",
           "sw_qm_rt_ends", "sw_qm_rt_starts")
# the .cu source (csrc/<name>.cu) of each kernel
SOURCES = {"sw_pair_ends": "sw_pair", "sw_pair_starts": "sw_pair",
           "sw_pair_ends_nocap": "sw_pair", "sw_pair_starts_nocap": "sw_pair",
           "sw_pair_ends_prof": "sw_pair", "sw_pair_starts_prof": "sw_pair",
           "sw_pair_ends_prof_nocap": "sw_pair",
           "sw_pair_starts_prof_nocap": "sw_pair",
           "sw_qm_ends": "sw_qm", "sw_qm_starts": "sw_qm",
           "sw_qm_rt_ends": "sw_qm_rt", "sw_qm_rt_starts": "sw_qm_rt"}
# K1-K4's length classes, by the rows a pair sweeps (the fragment, or the
# rows up to the end cell in the reverse pass): (G lanes a pair, R rows a
# lane); class c takes rows up to G * R of its entry and above the previous
# entry's, the last class every longer pair, a warp per pair in row
# stripes of PAIR_STRIPE (csrc/sw_pair.cu and csrc/sw_qm.cu instantiate
# the same table)
PAIR_CLASSES = ((4, 8), (8, 8), (16, 8), (16, 16), (32, 16))
PAIR_STRIPE = 32 * 16
# target columns the long-query kernels (K5/K6) sweep at once: a staged
# target tier wider than this needs their stripe hand-off, one word per
# (lane, query row)
RT_STRIPE = 512
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # submat, alph, q, qb, q_len, t, t_len, B, Lq, Lt, go, ge, order,
    # bounds, carry, out x3, stream
    "sw_pair_ends": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                     _P, _P, _P, _P, _P, _P],
    # as above with q_end, t_end after t_len
    "sw_pair_starts": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _I, _P, _P, _P, _P, _P, _P, _P],
    # prof, alph, p_lens, nP, Lq, t_mat, t_lens, nT, Lt, li, lj, B, go, ge,
    # order, bounds, carry, out x3, stream
    "sw_pair_ends_prof": [_P, _I, _P, _I, _I, _P, _P, _I, _I, _P, _P, _I,
                          _I, _I, _P, _P, _P, _P, _P, _P, _P],
    # as above with q_end, t_end after lj
    "sw_pair_starts_prof": [_P, _I, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P,
                            _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    # submat, alph, q_mat, qb_mat, q_lens, nq, Lq, t_mat, t_lens, nt, Lt,
    # qidx, lj, n_tiles, go, ge, stripe hand-off (or NULL), out x3, stream
    "sw_qm_ends": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _I,
                   _I, _I, _P, _P, _P, _P, _P],
    # as above with q_end, t_end after lj
    "sw_qm_starts": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P,
                     _P, _I, _I, _I, _P, _P, _P, _P, _P],
}
_ARGTYPES["sw_pair_ends_nocap"] = _ARGTYPES["sw_pair_ends"]
_ARGTYPES["sw_pair_starts_nocap"] = _ARGTYPES["sw_pair_starts"]
_ARGTYPES["sw_pair_ends_prof_nocap"] = _ARGTYPES["sw_pair_ends_prof"]
_ARGTYPES["sw_pair_starts_prof_nocap"] = _ARGTYPES["sw_pair_starts_prof"]
_ARGTYPES["sw_qm_rt_ends"] = _ARGTYPES["sw_qm_ends"]
_ARGTYPES["sw_qm_rt_starts"] = _ARGTYPES["sw_qm_starts"]


def reset_counts():
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


@functools.lru_cache(maxsize=None)
def _kernel(name):
    fn = getattr(_build.load(SOURCES[name]), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _cuda_inputs(scoring, q_enc, q_bias, q_len, t_enc, t_len, *extra):
    """Checks one CUDA device and the shapes; returns the kernel's operands:
    row-major (B, Lq) codes and biases, (B, Lt) target codes, int32
    vectors."""
    dev = q_enc.device
    tensors = (q_enc, q_bias, q_len, t_enc, t_len, *extra, scoring.submat)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("sw kernels take tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    B, Lq = q_enc.shape
    if (q_bias.shape != (B, Lq) or t_enc.dim() != 2 or t_enc.shape[0] != B
            or any(v.shape != (B,) for v in (q_len, t_len, *extra))):
        raise ValueError("sw kernels: shapes do not match a (B, Lq) x "
                         "(B, Lt) batch")
    alph = scoring.submat.shape[0]
    if scoring.submat.shape != (alph, alph) or alph > 32:
        raise ValueError("sw kernels take a square substitution matrix of "
                         "at most 32 classes")
    return (q_enc.to(torch.uint8).contiguous(),
            q_bias.to(torch.int8).contiguous(),
            q_len.to(torch.int32).contiguous(),
            t_enc.to(torch.uint8).contiguous(),
            t_len.to(torch.int32).contiguous(),
            *(v.to(torch.int32).contiguous() for v in extra),
            scoring.submat.to(torch.int32).contiguous())


def pair_classes(q_len, t_len, Lq, Lt, q_end=None, t_end=None):
    """K1/K2's work list: (order, bounds), int32 on the tensors' device.
    A pair sweeps rows 0..n-1 and columns 0..m-1: its true lengths cut to
    (Lq, Lt), or, for the reverse pass (q_end, t_end given), the rows and
    columns up to its end cell. Its class is the first of PAIR_CLASSES
    whose G * R rows cover n (the last for longer pairs); order lists the
    pairs by class, then by m, so that the pairs of a warp end together;
    bounds[c] is the end of class c in order. No host synchronisation."""
    n = q_len.to(torch.int32).clamp(0, Lq)
    m = t_len.to(torch.int32).clamp(0, Lt)
    if q_end is not None:
        n = (torch.minimum(q_end.to(torch.int32), n - 1) + 1).clamp_min(0)
        m = (torch.minimum(t_end.to(torch.int32), m - 1) + 1).clamp_min(0)
    caps, edges = _class_edges(n.device, Lt)
    cls = torch.bucketize(n, caps, out_int32=True)
    keys, order = torch.sort(torch.add(m, cls, alpha=Lt + 1), stable=True)
    return (order.to(torch.int32),
            torch.searchsorted(keys, edges, out_int32=True))


# (device, Lt) -> pair_classes' class caps (G * R rows) and the first key
# of each class after the first, on the device
_CLASS_EDGES = {}


def _class_edges(device, Lt):
    key = (device, Lt)
    if key not in _CLASS_EDGES:
        _CLASS_EDGES[key] = (
            torch.tensor([g * r for g, r in PAIR_CLASSES[:-1]],
                         dtype=torch.int32, device=device),
            torch.tensor([(c + 1) * (Lt + 1)
                          for c in range(len(PAIR_CLASSES))],
                         dtype=torch.int32, device=device))
    return _CLASS_EDGES[key]


def _launch(name, args):
    rc = _kernel(name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _pair_kernel(name, cap):
    """K1/K2's entry `name` for a cap of 32767, or its uncapped instance
    for cap None."""
    if cap is None:
        return name + "_nocap"
    if cap != state.SCORE_CAP:
        raise ValueError(f"sw_pair kernels cap H at {state.SCORE_CAP} or not "
                         f"at all, not at {cap}")
    return name


def _pair_launch(name, scoring, q_enc, q_bias, q_len, t_enc, t_len, *ends):
    """Launches K1 (no ends) or K2 (ends = q_end, t_end), capped or not
    (name), on its work list, with the row-stripe hand-off of (B, Lt) words
    (8-byte in the uncapped instances) only when the batch is wider than
    PAIR_STRIPE rows."""
    q, qb, ql, t, tl, *ends, sub = _cuda_inputs(
        scoring, q_enc, q_bias, q_len, t_enc, t_len, *ends)
    # the kernels keep the query profile as int8 and add the bias after
    check_scores_fit(scoring.submat, -128, 127, "sw_pair kernels")
    (B, Lq), Lt = q.shape, t.shape[1]
    order, bounds = pair_classes(ql, tl, Lq, Lt, *ends)
    dev = q_enc.device
    wide = torch.int64 if name.endswith("_nocap") else torch.int32
    carry = torch.empty((B, Lt), dtype=wide, device=dev) \
        if Lq > PAIR_STRIPE else None
    outs = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)]
    _launch(name, [
        sub.data_ptr(), sub.shape[0], q.data_ptr(), qb.data_ptr(),
        ql.data_ptr(), t.data_ptr(), tl.data_ptr(),
        *(e.data_ptr() for e in ends), B, Lq, Lt, scoring.go, scoring.ge,
        order.data_ptr(), bounds.data_ptr(),
        None if carry is None else carry.data_ptr(),
        *(o.data_ptr() for o in outs)])
    return tuple(outs)


def sw_ends(q_enc, q_bias, q_len, t_enc, t_len, scoring=None,
            cap=state.SCORE_CAP):
    """Forward SW ends (K1; cap=None: its uncapped instance):
    (score, q_end, t_end), each (B,) int32."""
    scoring = scoring or default_scoring(q_enc.device)
    name = _pair_kernel("sw_pair_ends", cap)
    if q_enc.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return sw_torch.sw_ends(q_enc, q_bias, q_len, t_enc, t_len,
                                scoring=scoring, cap=cap)
    return _pair_launch(name, scoring, q_enc, q_bias, q_len, t_enc, t_len)


def sw_starts(q_enc, q_bias, q_len, t_enc, t_len, q_end, t_end,
              scoring=None, cap=state.SCORE_CAP):
    """Reverse-prefix SW starts (K2; cap=None: its uncapped instance) from
    known ends: (score, q_start, t_start), each (B,) int32."""
    scoring = scoring or default_scoring(q_enc.device)
    name = _pair_kernel("sw_pair_starts", cap)
    if q_enc.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return sw_torch.sw_starts(q_enc, q_bias, q_len, t_enc, t_len,
                                  q_end, t_end, scoring=scoring, cap=cap)
    return _pair_launch(name, scoring, q_enc, q_bias, q_len, t_enc, t_len,
                        q_end, t_end)


def align_full(q_enc, q_bias, q_len, t_enc, t_len, scoring=None,
               cap=state.SCORE_CAP):
    """Ends then starts (K1 + K2, or with cap=None their uncapped
    instances) through the dispatching wrappers: (score, q_start, q_end,
    t_start, t_end)."""
    return sw_torch.align_full(q_enc, q_bias, q_len, t_enc, t_len,
                               scoring=scoring, ends=sw_ends,
                               starts=sw_starts, cap=cap)


@functools.lru_cache(maxsize=None)
def _batch_scoring(submat_bytes, alph, go, ge, device):
    """One Scoring per (matrix, gap costs, device), kept so that the
    kernels' score check reads each matrix back once."""
    sub = np.frombuffer(submat_bytes, np.int32).reshape(alph, alph).copy()
    return state.scoring_from_numpy(sub, go, ge, device)


def sw_align_batch(q_enc, q_bias, q_len, t_enc, t_len, submat=None,
                   go=state.GO, ge=state.GE, device="cuda"):
    """Counterpart of metaeuk_tpu/ops/sw_jax.py:176 sw_align_batch, the
    realign pass's alignment: padded (B, Lq) / (B, Lt) numpy codes and
    biases and (B,) lengths in, numpy (score, q_start, q_end, t_start,
    t_end) int32 out, with sw_jax's conventions (H not capped; no hit gives
    (0, -1, Lq - 1, -1, -1)). submat: the substitution matrix (default
    BLOSUM62), go/ge: the gap costs. On a CUDA device it runs K1/K2's
    uncapped instances, on the CPU their plain versions; a CUDA device with
    no card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"sw_align_batch on {device}: no CUDA device is "
                           "available")
    sub = np.ascontiguousarray(
        BLOSUM62_SCORES if submat is None else submat, np.int32)
    scoring = _batch_scoring(sub.tobytes(), sub.shape[0], int(go), int(ge),
                             device)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)
    outs = align_full(put(q_enc, torch.uint8), put(q_bias, torch.int8),
                      put(q_len, torch.int32), put(t_enc, torch.uint8),
                      put(t_len, torch.int32), scoring=scoring, cap=None)
    return tuple(o.cpu().numpy() for o in outs)


# the last staged PSSM matrix the PSSM kernels were given, and its int8
# copy: [source tensor, int8 tensor]; the source is checked once, at its
# first launch
_PSSM8 = [None, None]


def _pssm_int8(prof_mat):
    """prof_mat as int8, checked (once per staged matrix) to lie in [-128,
    127]: the PSSM kernels keep each lane's scores as int8."""
    if _PSSM8[0] is not prof_mat:
        if prof_mat.dtype != torch.int8:
            lo, hi = torch.aminmax(prof_mat)
            if int(lo) < -128 or int(hi) > 127:
                raise ValueError("sw_pair PSSM kernels take PSSM scores in "
                                 f"[-128, 127], got [{int(lo)}, {int(hi)}]")
        _PSSM8[:] = [prof_mat, prof_mat.to(torch.int8).contiguous()]
    return _PSSM8[1]


def _prof_launch(name, prof_mat, p_lens, t_mat, t_lens, li, lj, *ends):
    """Launches a PSSM entry of K1 (no ends) or K2 (ends = q_end, t_end),
    capped or not (name), on staged (nP, Lq, 21) PSSM rows and (nT, Lt)
    fragment codes, pair b being profile li[b] against fragment lj[b]; the
    row-stripe hand-off of (B, Lt) words (8-byte in the uncapped instances)
    only when the profiles are wider than PAIR_STRIPE rows."""
    dev = prof_mat.device
    tensors = (prof_mat, p_lens, t_mat, t_lens, li, lj, *ends)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("sw kernels take tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    (nP, Lq, alph), (nT, Lt), B = prof_mat.shape, t_mat.shape, li.shape[0]
    if (alph > 32 or p_lens.shape != (nP,) or t_lens.shape != (nT,)
            or any(v.shape != (B,) for v in (lj, *ends))):
        raise ValueError("sw_pair PSSM kernels: shapes do not match staged "
                         "(nP, Lq, <= 32) x (nT, Lt) matrices and (B,) pairs")
    pm = _pssm_int8(prof_mat)
    pl, t, tl = (p_lens.to(torch.int32).contiguous(),
                 t_mat.to(torch.uint8).contiguous(),
                 t_lens.to(torch.int32).contiguous())
    li, lj, *ends = (v.to(torch.int32).contiguous() for v in (li, lj, *ends))
    order, bounds = pair_classes(pl[li.long()], tl[lj.long()], Lq, Lt, *ends)
    wide = torch.int64 if name.endswith("_nocap") else torch.int32
    carry = torch.empty((B, Lt), dtype=wide, device=dev) \
        if Lq > PAIR_STRIPE else None
    outs = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)]
    go, ge = state.GO, state.GE
    _launch(name, [
        pm.data_ptr(), alph, pl.data_ptr(), nP, Lq, t.data_ptr(),
        tl.data_ptr(), nT, Lt, li.data_ptr(), lj.data_ptr(),
        *(e.data_ptr() for e in ends), B, go, ge, order.data_ptr(),
        bounds.data_ptr(), None if carry is None else carry.data_ptr(),
        *(o.data_ptr() for o in outs)])
    return tuple(outs)


def _gathered(prof_mat, p_lens, t_mat, t_lens, li, lj):
    """The plain versions' operands: each pair's (Lq, 21) profile rows and
    fragment row, gathered from the staged matrices."""
    li, lj = li.long(), lj.long()
    return prof_mat[li], p_lens[li], t_mat[lj], t_lens[lj]


def sw_ends_prof(prof_mat, p_lens, t_mat, t_lens, li, lj,
                 cap=state.SCORE_CAP):
    """Forward SW ends (K1's PSSM entry; cap=None: its uncapped instance)
    of profile li[b] (staged (nP, Lq, 21) PSSM rows, (nP,) lengths) against
    fragment lj[b] (staged (nT, Lt) codes, (nT,) lengths): (score, q_end,
    t_end), each (B,) int32."""
    name = _pair_kernel("sw_pair_ends_prof", cap)
    if prof_mat.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return sw_torch.sw_ends_prof(*_gathered(prof_mat, p_lens, t_mat,
                                                t_lens, li, lj), cap=cap)
    return _prof_launch(name, prof_mat, p_lens, t_mat, t_lens, li, lj)


def sw_starts_prof(prof_mat, p_lens, t_mat, t_lens, li, lj, q_end, t_end,
                   cap=state.SCORE_CAP):
    """Reverse-prefix starts (K2's PSSM entry; cap=None: its uncapped
    instance) from known ends: (score, q_start, t_start), each (B,)
    int32."""
    name = _pair_kernel("sw_pair_starts_prof", cap)
    if prof_mat.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return sw_torch.sw_starts_prof(
            *_gathered(prof_mat, p_lens, t_mat, t_lens, li, lj), q_end,
            t_end, cap=cap)
    return _prof_launch(name, prof_mat, p_lens, t_mat, t_lens, li, lj,
                        q_end, t_end)


def align_full_prof(prof_mat, p_lens, t_mat, t_lens, li, lj,
                    cap=state.SCORE_CAP):
    """Ends then starts of the PSSM pairs through the dispatching wrappers
    (sw_pallas.py _align_full_prof; with cap=None, sw_jax.py
    sw_align_batch_prof): (score, q_start, q_end, t_start, t_end)."""
    score, q_end, t_end = sw_ends_prof(prof_mat, p_lens, t_mat, t_lens, li,
                                       lj, cap=cap)
    _, q_start, t_start = sw_starts_prof(
        prof_mat, p_lens, t_mat, t_lens, li, lj, torch.clamp_min(q_end, 0),
        torch.clamp_min(t_end, 0), cap=cap)
    aligned = (t_end >= 0) & (score > 0)
    return (score, torch.where(aligned, q_start, -1), q_end,
            torch.where(aligned, t_start, -1), t_end)


def _qm_inputs(scoring, q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj,
               *extra):
    """Checks one CUDA device and the shapes; returns the kernel's
    contiguous operands."""
    dev = q_mat.device
    tensors = (q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj, *extra,
               scoring.submat)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("sw kernels take tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    (nq, Lq), nt, nT = q_mat.shape, t_mat.shape[0], qidx.shape[0]
    if (qb_mat.shape != (nq, Lq) or q_lens.shape != (nq,) or t_mat.dim() != 2
            or t_lens.shape != (nt,) or qidx.dim() != 1
            or any(v.shape != (nT * sw_torch.TB,) for v in (lj, *extra))):
        raise ValueError("sw_qm kernels: shapes do not match staged (nq, Lq)"
                         " x (nt, Lt) matrices and n_tiles x 128 lanes")
    alph = scoring.submat.shape[0]
    if scoring.submat.shape != (alph, alph) or alph > 32:
        raise ValueError("sw kernels take a square substitution matrix of "
                         "at most 32 classes")
    return (scoring.submat.to(torch.int32).contiguous(),
            q_mat.to(torch.uint8).contiguous(),
            qb_mat.to(torch.int8).contiguous(),
            q_lens.to(torch.int32).contiguous(),
            t_mat.to(torch.uint8).contiguous(),
            t_lens.to(torch.int32).contiguous(),
            qidx.to(torch.int32).contiguous(),
            *(v.to(torch.int32).contiguous() for v in (lj, *extra)))


# (id(submat), lo, hi) -> (submat, whether its scores lie in [lo, hi]):
# each matrix is read back to the host once per range, and kept so that its
# id stays its own
_FITS = {}


def check_scores_fit(submat, lo, hi, kernels):
    """Raises unless every score of submat lies in [lo, hi], the range that
    `kernels` keep their profiles in."""
    key = (id(submat), lo, hi)
    seen = _FITS.get(key)
    if seen is None:
        a, b = torch.aminmax(submat)
        seen = _FITS[key] = (submat, lo <= int(a) and int(b) <= hi)
    if not seen[1]:
        raise ValueError(f"{kernels} take substitution scores in "
                         f"[{lo}, {hi}]")


def _qm_launch(name, scoring, q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj,
               *extra):
    """Launches a query-major kernel: K3/K4, with the row-stripe hand-off of
    (tiles * 128, Lt) words only when the query tier is wider than
    PAIR_STRIPE, or K5/K6 (sw_qm_rt_*), with the stripe hand-off of (tiles *
    128, Lq) words only when the target tier is wider than RT_STRIPE."""
    Lq, Lt = q_mat.shape[1], t_mat.shape[1]
    sub, q, qb, ql, t, tl, qi, *lanes = _qm_inputs(
        scoring, q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj, *extra)
    # K3-K6 keep their profiles as int8 and add the bias after
    check_scores_fit(scoring.submat, -128, 127, "sw_qm kernels")
    nq, nt, nT = q.shape[0], t.shape[0], qi.shape[0]
    dev = q_mat.device
    if name.startswith("sw_qm_rt"):   # a word per (lane, query row)
        shape, wide = (nT * sw_torch.TB, Lq), Lt > RT_STRIPE
    else:                             # a word per (lane, target column)
        shape, wide = (nT * sw_torch.TB, Lt), Lq > PAIR_STRIPE
    carry = torch.empty(shape, dtype=torch.int32, device=dev) if wide \
        else None
    outs = [torch.empty(nT * sw_torch.TB, dtype=torch.int32, device=dev)
            for _ in range(3)]
    _launch(name, [
        sub.data_ptr(), sub.shape[0], q.data_ptr(), qb.data_ptr(),
        ql.data_ptr(), nq, Lq, t.data_ptr(), tl.data_ptr(), nt, Lt,
        qi.data_ptr(), *(v.data_ptr() for v in lanes), nT, scoring.go,
        scoring.ge, None if carry is None else carry.data_ptr(),
        *(o.data_ptr() for o in outs)])
    return tuple(outs)


def qm_ends(q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj, scoring=None):
    """Query-major forward ends (K3) of tile k's query row qidx[k] against
    the target rows lj[k * 128:(k + 1) * 128] of the staged matrices:
    (score, q_end, t_end), each (n_tiles * 128,) int32."""
    scoring = scoring or default_scoring(q_mat.device)
    if q_mat.device.type == "cpu":
        PLAIN_CALLS["sw_qm_ends"] += 1
        return sw_torch.qm_ends(q_mat, qb_mat, q_lens, t_mat, t_lens, qidx,
                                lj, scoring=scoring)
    return _qm_launch("sw_qm_ends", scoring, q_mat, qb_mat, q_lens,
                      t_mat, t_lens, qidx, lj)


def qm_starts(q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj, q_end, t_end,
              scoring=None):
    """Query-major reverse-prefix starts (K4) from known per-lane ends:
    (score, q_start, t_start), each (n_tiles * 128,) int32."""
    scoring = scoring or default_scoring(q_mat.device)
    if q_mat.device.type == "cpu":
        PLAIN_CALLS["sw_qm_starts"] += 1
        return sw_torch.qm_starts(q_mat, qb_mat, q_lens, t_mat, t_lens,
                                  qidx, lj, q_end, t_end, scoring=scoring)
    return _qm_launch("sw_qm_starts", scoring, q_mat, qb_mat, q_lens,
                      t_mat, t_lens, qidx, lj, q_end, t_end)


def qm_ends_rt(q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj, scoring=None,
               tq=sw_torch.TQ_RT):
    """Query-major forward ends for long query rows (K5), qm_ends'
    function: (score, q_end, t_end), each (n_tiles * 128,) int32. tq, the
    row tile of the JAX package's kernel, is taken by the plain version
    only (it gives the same result for any tq); the CUDA kernel has no row
    tile."""
    scoring = scoring or default_scoring(q_mat.device)
    if q_mat.device.type == "cpu":
        PLAIN_CALLS["sw_qm_rt_ends"] += 1
        return sw_torch.qm_ends_rt(q_mat, qb_mat, q_lens, t_mat, t_lens,
                                   qidx, lj, scoring=scoring, tq=tq)
    return _qm_launch("sw_qm_rt_ends", scoring, q_mat, qb_mat, q_lens, t_mat,
                      t_lens, qidx, lj)


def qm_starts_rt(q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj, q_end,
                 t_end, scoring=None, tq=sw_torch.TQ_RT):
    """Query-major reverse-prefix starts for long query rows (K6) from known
    per-lane ends: (score, q_start, t_start), each (n_tiles * 128,) int32.
    tq as for qm_ends_rt."""
    scoring = scoring or default_scoring(q_mat.device)
    if q_mat.device.type == "cpu":
        PLAIN_CALLS["sw_qm_rt_starts"] += 1
        return sw_torch.qm_starts_rt(q_mat, qb_mat, q_lens, t_mat, t_lens,
                                     qidx, lj, q_end, t_end, scoring=scoring,
                                     tq=tq)
    return _qm_launch("sw_qm_rt_starts", scoring, q_mat, qb_mat, q_lens,
                      t_mat, t_lens, qidx, lj, q_end, t_end)
