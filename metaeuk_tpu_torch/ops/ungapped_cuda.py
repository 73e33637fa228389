"""Gapless diagonal scores: the wrapper over the CUDA kernels in
csrc/gapless.cu, dispatched by the device of the tensors given.

- A CPU tensor goes to the plain PyTorch version (ops/ungapped_torch.py).
- A CUDA tensor launches a kernel, or raises. There is no fallback.
- The staged query width Lq picks the kernel (kernel_for): gapless_pair, a
  thread per pair, below LONG_ROWS; gapless_long, a block per (pair, chunk
  of 256 diagonals), from LONG_ROWS up. Both compute the same function.

Counterparts in the JAX package (metaeuk_tpu/ops/ungapped.py):
gapless_scores_gathered is gapless_scores_gathered / gapless_gathered_jit
over gapless_scores_pallas (K7, _gapless_kernel, with _build_S), and
gapless_scores is gapless_scores on a per-pair batch. Per pair, the best of
D(i,j) = max(0, D(i-1,j-1) + S(i,j)) over rows < q_len and columns < t_len,
floored at 0, with S = blosum62[q_i, t_j] + bias_i. Batches need no padding.

LAUNCHES counts kernel launches and PLAIN_CALLS calls that went to the plain
version, each under the kernel the route picked; reset_counts() sets both to
zero.
"""

import ctypes
import functools

import torch

from . import _build, ungapped_torch
from .sw_cuda import check_scores_fit
from ..state import default_scoring

KERNELS = ("gapless_pair", "gapless_long")
# staged query widths from which a launch goes to gapless_long (fragments
# over 512 aa): on the card it beats gapless_pair at every prefilter bucket
# from 1024 up (tools/torch_gapless_rows.py, PERF.md)
LONG_ROWS = 1024
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
# submat, alph, q, qb, q_lens, nq, Lq, t, t_lens, nt, Lt, li, lj, B, out,
# stream (q, qb, t transposed for gapless_pair, row-major for gapless_long)
_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P,
             ctypes.c_longlong, _P, _P]


def reset_counts():
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


@functools.lru_cache(maxsize=None)
def _kernel(name):
    fn = getattr(_build.load("gapless"), name)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def kernel_for(Lq):
    """The kernel that scores a launch of staged query width Lq."""
    return "gapless_long" if Lq >= LONG_ROWS else "gapless_pair"


def gapless_scores_gathered(q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj,
                            scoring=None):
    """(B,) int32 best gapless diagonal score of each pair of staged rows
    (q_mat[li[b]], t_mat[lj[b]]); a pair with an index out of range scores
    0. q_mat, qb_mat: (nq, Lq) codes and biases; t_mat: (nt, Lt) codes."""
    scoring = scoring or default_scoring(q_mat.device)
    name = kernel_for(q_mat.shape[1])
    if q_mat.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return ungapped_torch.gapless_gathered(
            q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj, scoring=scoring)
    return launch(name, q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj,
                  scoring=scoring)


def launch(name, q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj,
           scoring=None):
    """gapless_scores_gathered on kernel `name` (one of KERNELS), whatever
    kernel_for would pick: CUDA tensors only."""
    scoring = scoring or default_scoring(q_mat.device)
    dev = q_mat.device
    tensors = (q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj, scoring.submat)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("gapless kernel takes tensors on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    (nq, Lq), (nt, Lt), B = q_mat.shape, t_mat.shape, li.shape[0]
    if (qb_mat.shape != (nq, Lq) or q_lens.shape != (nq,)
            or t_lens.shape != (nt,) or li.shape != (B,)
            or lj.shape != (B,)):
        raise ValueError("gapless kernel: shapes do not match staged "
                         "(nq, Lq) x (nt, Lt) matrices and (B,) indices")
    alph = scoring.submat.shape[0]
    if scoring.submat.shape != (alph, alph) or alph > 32:
        raise ValueError("gapless kernel takes a square substitution matrix "
                         "of at most 32 classes")
    sub = scoring.submat.to(torch.int32).contiguous()
    if name == "gapless_long":
        # the query profile holds submat + bias (an int8) as int16
        check_scores_fit(scoring.submat, -32640, 32639, "gapless_long")
        q = q_mat.to(torch.uint8).contiguous()
        qb = qb_mat.to(torch.int8).contiguous()
        t = t_mat.to(torch.uint8).contiguous()
    else:
        q = q_mat.to(torch.uint8).t().contiguous()
        qb = qb_mat.to(torch.int8).t().contiguous()
        t = t_mat.to(torch.uint8).t().contiguous()
    ql = q_lens.to(torch.int32).contiguous()
    tl = t_lens.to(torch.int32).contiguous()
    li32 = li.to(torch.int32).contiguous()
    lj32 = lj.to(torch.int32).contiguous()
    best = torch.empty(B, dtype=torch.int32, device=dev)
    rc = _kernel(name)(sub.data_ptr(), alph, q.data_ptr(), qb.data_ptr(),
                       ql.data_ptr(), nq, Lq, t.data_ptr(), tl.data_ptr(), nt,
                       Lt, li32.data_ptr(), lj32.data_ptr(), B,
                       best.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return best


def gapless_scores(q_enc, q_bias, q_len, t_enc, t_len, scoring=None):
    """(B,) int32 best gapless diagonal score of each pair of a per-pair
    batch: (B, Lq) query codes and biases against (B, Lt) target codes."""
    pairs = torch.arange(q_enc.shape[0], device=q_enc.device)
    return gapless_scores_gathered(q_enc, q_bias, q_len, t_enc, t_len, pairs,
                                   pairs, scoring=scoring)
