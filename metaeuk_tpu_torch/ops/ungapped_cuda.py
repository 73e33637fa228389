"""Gapless diagonal scores: the wrapper over the CUDA kernel in
csrc/gapless.cu, dispatched by the device of the tensors given.

- A CPU tensor goes to the plain PyTorch version (ops/ungapped_torch.py).
- A CUDA tensor launches the kernel, or raises. There is no fallback.

Counterparts in the JAX package (metaeuk_tpu/ops/ungapped.py):
gapless_scores_gathered is gapless_scores_gathered / gapless_gathered_jit
over gapless_scores_pallas (K7, _gapless_kernel, with _build_S), and
gapless_scores is gapless_scores on a per-pair batch. Per pair, the best of
D(i,j) = max(0, D(i-1,j-1) + S(i,j)) over rows < q_len and columns < t_len,
floored at 0, with S = blosum62[q_i, t_j] + bias_i. Batches need no padding:
the kernel runs one thread per pair.

LAUNCHES counts kernel launches and PLAIN_CALLS calls that went to the plain
version; reset_counts() sets both to zero.
"""

import ctypes
import functools

import torch

from . import _build, ungapped_torch
from ..state import default_scoring

KERNELS = ("gapless_pair",)
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
# submat, alph, qT, qbT, q_lens, nq, Lq, tT, t_lens, nt, Lt, li, lj, B, out,
# stream
_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P,
             ctypes.c_longlong, _P, _P]


def reset_counts():
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("gapless").gapless_pair
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def gapless_scores_gathered(q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj,
                            scoring=None):
    """(B,) int32 best gapless diagonal score of each pair of staged rows
    (q_mat[li[b]], t_mat[lj[b]]); a pair with an index out of range scores
    0. q_mat, qb_mat: (nq, Lq) codes and biases; t_mat: (nt, Lt) codes."""
    scoring = scoring or default_scoring(q_mat.device)
    if q_mat.device.type == "cpu":
        PLAIN_CALLS["gapless_pair"] += 1
        return ungapped_torch.gapless_gathered(
            q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj, scoring=scoring)
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
    qT = q_mat.to(torch.uint8).t().contiguous()
    qbT = qb_mat.to(torch.int8).t().contiguous()
    ql = q_lens.to(torch.int32).contiguous()
    tT = t_mat.to(torch.uint8).t().contiguous()
    tl = t_lens.to(torch.int32).contiguous()
    li32 = li.to(torch.int32).contiguous()
    lj32 = lj.to(torch.int32).contiguous()
    best = torch.empty(B, dtype=torch.int32, device=dev)
    rc = _kernel()(sub.data_ptr(), alph, qT.data_ptr(), qbT.data_ptr(),
                   ql.data_ptr(), nq, Lq, tT.data_ptr(), tl.data_ptr(), nt, Lt,
                   li32.data_ptr(), lj32.data_ptr(), B, best.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gapless_pair launch failed: CUDA error {rc}")
    LAUNCHES["gapless_pair"] += 1
    return best


def gapless_scores(q_enc, q_bias, q_len, t_enc, t_len, scoring=None):
    """(B,) int32 best gapless diagonal score of each pair of a per-pair
    batch: (B, Lq) query codes and biases against (B, Lt) target codes."""
    pairs = torch.arange(q_enc.shape[0], device=q_enc.device)
    return gapless_scores_gathered(q_enc, q_bias, q_len, t_enc, t_len, pairs,
                                   pairs, scoring=scoring)
