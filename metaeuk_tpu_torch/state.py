"""State the alignment slice carries across from the JAX package.

The path holds no learned parameters. What it needs on the device is the
scoring scheme — the substitution matrix (BLOSUM62_SCORES of the port's copy
of metaeuk_tpu/data/submat.py) and the gap costs and score cap of the Pallas kernels
(metaeuk_tpu/ops/sw_pallas.py GO, GE, SCORE_CAP) — and the per-length-tier
matrices that SearchDriver stages once per fragment list and target set
(metaeuk_tpu/search/driver.py _query_stage, _target_tier).
"""

import dataclasses
import functools

import numpy as np
import torch

from .data.submat import BLOSUM62_SCORES

GO = 11            # gap open (sw_pallas.py GO)
GE = 1             # gap extend (sw_pallas.py GE)
SCORE_CAP = 32767  # H saturates here (sw_pallas.py SCORE_CAP)
NEG = -(10 ** 6)   # masked-cell score of the reverse pass (sw_pallas.py NEG)
PAD_SCORE = -128   # score of a padded cell (sw_pallas.py _build_S_gapped)


@dataclasses.dataclass(frozen=True)
class Scoring:
    """Substitution matrix (alph, alph) int32 on one device, gap costs."""
    submat: torch.Tensor
    go: int
    ge: int


def scoring_from_numpy(submat, go, ge, device):
    sub = torch.from_numpy(np.ascontiguousarray(submat, np.int32))
    return Scoring(sub.to(device), int(go), int(ge))


@functools.lru_cache(maxsize=None)
def default_scoring(device):
    """BLOSUM62 with gap open 11 / extend 1 on `device` (a torch.device)."""
    return scoring_from_numpy(BLOSUM62_SCORES, GO, GE, device)


# staged tier fields that live on the device, with their dtypes; every
# other field (remaps, counts) stays on the host
TIER_DTYPES = {"q_mat": torch.uint8, "qb_mat": torch.int8,
               "q_lens": torch.int32, "t_mat": torch.uint8,
               "t_lens": torch.int32}


def stage_from_numpy(tier, device):
    """One staged numpy tier (a dict as SearchDriver builds it: q_mat,
    qb_mat, q_lens, q_remap, nq for a query tier; t_mat, t_lens, t_remap
    for a target tier) -> the same dict with its matrices on `device`."""
    out = dict(tier)
    for k, dt in TIER_DTYPES.items():
        if k in out:
            out[k] = torch.from_numpy(np.ascontiguousarray(out[k])).to(
                device=device, dtype=dt)
    return out
