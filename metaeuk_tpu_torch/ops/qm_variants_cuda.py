"""Query-major recurrence variants (csrc/qm_variants.cu, T4), dispatched by
the device of the tensors given.

- CPU tensors go to the plain PyTorch version (ops/qm_variants_torch.py).
- CUDA tensors launch the kernel, or raise. There is no fallback.

Counterpart: tools/kernel_variants.py::make_kernel (repository root), K3's
forward ends in the variants base, fold, nocap, fold_nocap and nof. `tj` is
the Pallas grid's column chunk: on the card, the columns of target codes a
lane stages in shared memory per load (TJ = min(tj, Lt); only the first
(TJ // unroll) * unroll columns of each of the Lt // TJ chunks are visited,
as on the TPU). `unroll` is the columns the Pallas kernel carries between
two writes of its H/E scratch: on the card, the columns a lane carries in
registers through one sweep down the rows (1, 2, 4, 8 or 16).

LAUNCHES counts kernel launches and PLAIN_CALLS calls that went to the plain
version; reset_counts() sets both to zero.
"""

import ctypes
import functools

import torch

from . import _build, qm_variants_torch
from .qm_variants_torch import GE, GO, PCOLS, TB, VARIANTS, packing

KERNELS = ("qm_variant_ends",)
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)

UNROLLS = (1, 2, 4, 8, 16)
SMEM_LIMIT = 232448          # dynamic shared memory a block may take (H100)

_P = ctypes.c_void_p
_I = ctypes.c_int
# variant, unroll, prof, tc, n_tiles, Lq, Lt, TJ, go, ge, scratch, best,
# q_end, t_end, stream
_ARGTYPES = [_I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]


def reset_counts():
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("qm_variants")
    lib.qm_variant_ends.argtypes = _ARGTYPES
    lib.qm_variant_ends.restype = ctypes.c_int
    lib.qm_variant_smem.argtypes = [_I, _I]
    lib.qm_variant_smem.restype = ctypes.c_longlong
    return lib


def qm_variant_ends(prof, tc, variant="base", tj=256, unroll=8):
    """prof: (tiles, Lq, 32) bfloat16 holding integer scores (shifted by +GE
    for fold and fold_nocap); tc: (Lt, tiles * 128) int32 target codes.
    (best, q_end, t_end), each (tiles * 128,) int32."""
    if prof.device.type == "cpu":
        PLAIN_CALLS["qm_variant_ends"] += 1
        return qm_variants_torch.qm_variant_ends(prof, tc, variant, tj,
                                                 unroll)
    dev = prof.device
    if dev.type != "cuda" or tc.device != dev:
        raise ValueError("qm_variant_ends takes tensors on one CUDA device, "
                         f"got {prof.device} and {tc.device}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if unroll not in UNROLLS:
        raise ValueError(f"qm_variant_ends is built for unroll {UNROLLS}, "
                         f"got {unroll}")
    if prof.dtype != torch.bfloat16 or tc.dtype != torch.int32 \
            or not prof.is_contiguous() or not tc.is_contiguous():
        raise ValueError("qm_variant_ends takes a contiguous bfloat16 "
                         "profile and contiguous int32 codes")
    if prof.dim() != 3 or prof.shape[2] != PCOLS or tc.dim() != 2:
        raise ValueError("qm_variant_ends takes a (tiles, Lq, 32) profile "
                         "and (Lt, tiles * 128) codes")
    n_tiles, Lq, _ = prof.shape
    Lt, B = tc.shape
    if B != n_tiles * TB or n_tiles < 1 or Lq < 1 or Lt < 1 or tj < 1:
        raise ValueError(f"qm_variant_ends: codes {tuple(tc.shape)} do not "
                         f"match {n_tiles} tiles of {TB} lanes")
    if Lt > packing(variant):
        raise ValueError(f"{variant}'s packed tie-break holds columns below "
                         f"{packing(variant)}, got Lt {Lt}")
    TJ = min(tj, Lt)
    smem = _lib().qm_variant_smem(Lq, TJ)
    if smem > SMEM_LIMIT:
        raise ValueError(f"Lq {Lq} with {TJ} staged columns needs {smem} B "
                         f"of shared memory, above {SMEM_LIMIT}")
    scratch = torch.empty((n_tiles, Lq, TB, 2), dtype=torch.int32,
                          device=dev)
    out = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)]
    rc = _lib().qm_variant_ends(
        VARIANTS.index(variant), unroll, prof.data_ptr(), tc.data_ptr(),
        n_tiles, Lq, Lt, TJ, GO, GE, scratch.data_ptr(),
        *(o.data_ptr() for o in out), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qm_variant_ends launch failed: CUDA error {rc}")
    LAUNCHES["qm_variant_ends"] += 1
    return tuple(out)
