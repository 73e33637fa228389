"""Query-major recurrence variants (csrc/qm_variants.cu, T4), dispatched by
the device of the tensors given.

- CPU tensors go to the plain PyTorch version (ops/qm_variants_torch.py).
- CUDA tensors launch the kernel, or raise. There is no fallback.

Counterpart: tools/kernel_variants.py::make_kernel (repository root), K3's
forward ends in the variants base, fold, nocap, fold_nocap and nof. The
kernel runs K3's design (csrc/sw_qm.cu): a group of G threads a lane, R
rows a thread in registers, the class (G, R) the first of
sw_cuda.PAIR_CLASSES whose G * R rows cover Lq (a warp a lane in stripes of
sw_cuda.PAIR_STRIPE rows above 256), one launch, no H/E scratch. launch_plan gives
the class and the steps the kernel walks.

The knobs keep their effect on the output, the set of visited columns:
with TJ = min(tj, Lt) and per = (TJ // unroll) * unroll, the first per
columns of each of the Lt // TJ Pallas column chunks, walked one after the
other (step_column). On the card `tj` sets the codes a lane's group stages
per load of its ring in shared memory (the per visited columns of one
chunk, or of as many chunks as make MIN_CHUNK steps), and `unroll` (1, 2,
4, 8 or 16) the compile-time unroll of the kernel's loop over steps; on
the TPU they were the grid's column chunk and the columns carried between
two writes of the H/E scratch.

LAUNCHES counts kernel launches and PLAIN_CALLS calls that went to the plain
version; reset_counts() sets both to zero.
"""

import collections
import ctypes
import functools

import torch

from . import _build, qm_variants_torch
from .qm_variants_torch import GE, GO, PCOLS, TB, VARIANTS, packing
from .sw_cuda import PAIR_CLASSES

KERNELS = ("qm_variant_ends",)
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)

UNROLLS = (1, 2, 4, 8, 16)
SMEM_LIMIT = 232448          # dynamic shared memory a block may take (H100)
MIN_CHUNK = 64               # visited steps a ring load, at least

_P = ctypes.c_void_p
_I = ctypes.c_int
# variant, unroll, cls, prof, tc, n_tiles, Lq, Lt, TJ, per, nvis, chunk,
# ring, go, ge, carry, best, q_end, t_end, stream
_ARGTYPES = [_I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
             _P, _P, _P, _P]

# cls: index into PAIR_CLASSES, (G, R) its entry; stripes: passes of G * R
# rows; TJ, per: the Pallas chunk and its visited columns; nvis: the steps
# (visited columns); chunk: steps a ring load; ring: bytes of a lane's
# ring, a power of two holding two loads
Plan = collections.namedtuple(
    "Plan", "cls G R stripes TJ per nvis chunk ring")


def launch_plan(Lq, Lt, tj, unroll):
    """The kernel's launch for Lq query rows, Lt target columns and the
    knobs tj, unroll (Plan)."""
    cls = next((c for c, (g, r) in enumerate(PAIR_CLASSES[:-1])
                if g * r >= Lq), len(PAIR_CLASSES) - 1)
    G, R = PAIR_CLASSES[cls]
    TJ = min(tj, Lt)
    per = (TJ // unroll) * unroll
    chunk = per * -(-MIN_CHUNK // per) if per else MIN_CHUNK
    return Plan(cls, G, R, -(-Lq // (G * R)), TJ, per, (Lt // TJ) * per,
                chunk, 1 << (2 * chunk - 1).bit_length())


def step_column(s, plan):
    """The global column of visited step s (the kernel's formula)."""
    c = s // plan.per
    return c * plan.TJ + s - c * plan.per


def reset_counts():
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("qm_variants")
    lib.qm_variant_ends.argtypes = _ARGTYPES
    lib.qm_variant_ends.restype = ctypes.c_int
    lib.qm_variant_smem.argtypes = [_I, _I]   # cls, ring
    lib.qm_variant_smem.restype = ctypes.c_longlong
    return lib


def qm_variant_ends(prof, tc, variant="base", tj=256, unroll=8):
    """prof: (tiles, Lq, 32) bfloat16 holding integer scores that fit int16
    (shifted by +GE for fold and fold_nocap); tc: (Lt, tiles * 128) int32
    target codes. (best, q_end, t_end), each (tiles * 128,) int32."""
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
    plan = launch_plan(Lq, Lt, tj, unroll)
    smem = _lib().qm_variant_smem(plan.cls, plan.ring)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{plan.chunk} staged columns a load at Lq {Lq} "
                         f"need {smem} B of shared memory, above "
                         f"{SMEM_LIMIT}")
    # the stripe hand-off: a (lane, step) word of up to 8 bytes
    carry = torch.empty((B, Lt, 2), dtype=torch.int32, device=dev) \
        if plan.stripes > 1 else None
    out = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)]
    rc = _lib().qm_variant_ends(
        VARIANTS.index(variant), unroll, plan.cls, prof.data_ptr(),
        tc.data_ptr(), n_tiles, Lq, Lt, plan.TJ, plan.per, plan.nvis,
        plan.chunk, plan.ring, GO, GE,
        None if carry is None else carry.data_ptr(),
        *(o.data_ptr() for o in out), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qm_variant_ends launch failed: CUDA error {rc}")
    LAUNCHES["qm_variant_ends"] += 1
    return tuple(out)
