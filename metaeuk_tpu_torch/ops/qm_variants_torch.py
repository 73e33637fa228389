"""Plain PyTorch version of the query-major recurrence variants of
csrc/qm_variants.cu (T4, tools/kernel_variants.py::make_kernel in the
repository root).

Column after column, vectorised over the Lq rows and the B = tiles * 128
lanes, with the in-column affine-gap max as the Pallas kernel's log-step
cummax and its packed tie-break kept per row. It returns what the Pallas
variant returns, the inexact variants included:

  base        H in [0, 32767], F from the in-column cummax of G + i*ge;
              BP packs Hn * 65536 + (65535 - j)
  fold        H' = H + i*ge and E' = E + i*ge carried, the profile given
              already shifted by +GE (as run_variant builds it), the cap a
              per-row 32767 + i*ge; BP packs Hn' * 32768 + (32767 - j) and
              loses i*ge*32768 at the end
  nocap       base without the cap, packing 32768
  fold_nocap  fold without the cap
  nof         base without the F recurrence (no vertical gaps)

The grid's column chunks are kept: with TJ = min(tj, Lt), columns
c * TJ + jj for c < Lt // TJ and jj < (TJ // unroll) * unroll are the ones
the Pallas kernel visits; the others are never read. A code outside
0..PCOLS-1 scores 0 (its one-hot column is empty).

Returns (best, q_end, t_end), each (B,) int32; a lane with no positive cell
gives (0, Lq - 1, -1).
"""

import torch

NEG = -(10 ** 6)
GO, GE = 11, 1
TB = 128         # lanes of a tile
PCOLS = 32       # profile columns (alphabet classes)
VARIANTS = ("base", "fold", "nocap", "fold_nocap", "nof")
FOLDED = ("fold", "fold_nocap")


def packing(variant):
    """The divisor of the variant's packed tie-break word."""
    return 65536 if variant in ("base", "nof") else 32768


def visited_columns(Lt, tj, unroll):
    """The global columns the Pallas grid visits, in order."""
    TJ = min(tj, Lt)
    per = (TJ // unroll) * unroll
    return [c * TJ + jj for c in range(Lt // TJ) for jj in range(per)]


def _shift_down(x, k, fill):
    pad = torch.full((k, x.shape[1]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[:-k]], dim=0)


def _cummax_down(a):
    k = 1
    while k < a.shape[0]:
        a = torch.maximum(a, _shift_down(a, k, NEG))
        k *= 2
    return a


def qm_variant_ends(prof, tc, variant="base", tj=256, unroll=8):
    """prof: (tiles, Lq, PCOLS) scores (bf16 holding integers); tc: (Lt,
    tiles * 128) int32 target codes. (best, q_end, t_end) per lane."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    n_tiles, Lq, pcols = prof.shape
    Lt, B = tc.shape
    dev = prof.device
    i32 = torch.int32
    # the one-hot product of a bf16 profile, in f32, cast to int32
    P = prof.to(torch.float32).to(i32)
    Pz = torch.cat([P, torch.zeros(n_tiles, Lq, 1, dtype=i32, device=dev)],
                   dim=2).permute(1, 0, 2)                  # (Lq, tiles, 33)
    lane_tile = torch.arange(B, device=dev) // TB
    iq = torch.arange(Lq, dtype=i32, device=dev)[:, None].expand(Lq, B)
    igge = iq * GE
    f_base = -GO - (iq - 1) * GE
    capv = 32767 + igge
    folded = variant in FOLDED
    div = packing(variant)
    if folded:
        H, E = igge.clone(), igge - GO
    else:
        H = torch.zeros(Lq, B, dtype=i32, device=dev)
        E = torch.full((Lq, B), -GO, dtype=i32, device=dev)
    BP = torch.zeros(Lq, B, dtype=i32, device=dev)
    for j in visited_columns(Lt, tj, unroll):
        code = tc[j].long()
        code = torch.where((code >= 0) & (code < pcols), code, pcols)
        s = Pz[:, lane_tile, code]
        if folded:
            Hd = _shift_down(H, 1, -GE)
            G = torch.maximum(torch.maximum(Hd + s, E), igge)
            A = _cummax_down(G)
            Hn = torch.maximum(G, _shift_down(A, 1, NEG) + (GE - GO))
            if variant == "fold":
                Hn = torch.minimum(Hn, capv)
        elif variant == "nof":
            Hd = _shift_down(H, 1, 0)
            Hn = torch.clamp(torch.maximum(Hd + s, E), 0, 32767)
        else:
            Hd = _shift_down(H, 1, 0)
            G = torch.clamp_min(torch.maximum(Hd + s, E), 0)
            A = _cummax_down(G + igge)
            Hn = torch.maximum(G, _shift_down(A, 1, NEG) + f_base)
            if variant == "base":
                Hn = torch.clamp_max(Hn, 32767)
        BP = torch.maximum(BP, Hn * div + (div - 1 - j))
        E = torch.maximum(E - GE, Hn - GO)
        H = Hn
    bp = BP - igge * 32768 if folded else BP
    Mp = bp.max(dim=0).values
    qe = torch.where(bp == Mp, iq, Lq).min(dim=0).values
    M = torch.div(Mp, div, rounding_mode="floor")
    has = M > 0
    best = torch.where(has, M, 0).to(i32)
    t_end = torch.where(has, (div - 1) - torch.remainder(Mp, div), -1)
    q_end = torch.where(has, qe, Lq - 1)
    return best, q_end.to(i32), t_end.to(i32)
