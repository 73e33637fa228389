"""Query-major forward-kernel variants on one NVIDIA GPU (the port of
tools/kernel_variants.py in the repository root): how much of K3's time the
cap and the F recurrence cost.

  base        the production formulation
  fold        H' = H + i*ge carried (the profile shifted by +GE); exact
  nocap       no 32767 cap (not exact near 32767)
  fold_nocap  both
  nof         no F recurrence at all (not exact: the ceiling a perfect
              lazy-F scheme could reach)
  uN / tjN    base with N columns carried in registers per sweep down the
              rows (1, 2, 4, 8, 16) / N columns of target codes staged per
              shared-memory load (the Pallas grid's column chunk)

    python -m metaeuk_tpu_torch.tools.kernel_variants [--device cuda|cpu]
        [--lq 256] [--lt 2048] [--tiles 32] [variant ...]

Each prints `variant Gcells/s score=... qe=... te=...` with the first six
lanes: Lq * Lt * lanes cells over the device time by CUDA events over 10
calls after one warm-up. `--device cpu` runs the plain version once,
untimed.
"""

import argparse

import numpy as np
import torch

from ..ops import qm_variants_cuda
from ..ops.qm_variants_torch import FOLDED, GE, PCOLS, TB, VARIANTS
from .kbench import card, time_ms


def variant_inputs(variant, Lq, Lt, n_tiles, device):
    """run_variant's inputs (tools/kernel_variants.py :133-141), seed 0."""
    B = n_tiles * TB
    rng = np.random.default_rng(0)
    prof = rng.integers(-4, 12, (n_tiles, Lq, PCOLS)).astype(np.float32)
    prof[:, :, 21:] = -128
    if variant in FOLDED:
        prof[:, :, :21] += GE
    tc = rng.integers(0, 20, (Lt, B)).astype(np.int32)
    return (torch.from_numpy(prof).to(torch.bfloat16).to(device),
            torch.from_numpy(tc).to(device))


def run_variant(variant, Lq=256, Lt=2048, n_tiles=32, UNROLL=8, TJ=256,
                device="cuda"):
    """(Gcells/s or None on the CPU, best, q_end, t_end) of every lane."""
    prof, tc = variant_inputs(variant, Lq, Lt, n_tiles, device)
    run = lambda: qm_variants_cuda.qm_variant_ends(prof, tc, variant, TJ,
                                                   UNROLL)
    out = run()
    rate = None
    if device != "cpu":
        ms = time_ms(run)
        rate = n_tiles * TB * Lq * Lt / (ms / 1e3) / 1e9
    return (rate, *(o.cpu().numpy() for o in out))


def parse(v):
    """(variant, UNROLL, TJ) of a command-line word."""
    if v in VARIANTS:
        return v, 8, 256
    if v.startswith("tj") and v[2:].isdigit():
        return "base", 8, int(v[2:])
    if v.startswith("u") and v[1:].isdigit():
        return "base", int(v[1:]), 256
    raise ValueError(f"unknown variant {v!r}: one of {', '.join(VARIANTS)}, "
                     "uN or tjN")


def main(argv=None):
    """Runs the variants; {word: (Gcells/s or None, best, q_end, t_end)}."""
    ap = argparse.ArgumentParser(
        prog="python -m metaeuk_tpu_torch.tools.kernel_variants",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--lq", type=int, default=256)
    ap.add_argument("--lt", type=int, default=2048)
    ap.add_argument("--tiles", type=int, default=32)
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help="base, fold, nocap, fold_nocap, nof, uN or tjN "
                         "(default: the five variants)")
    args = ap.parse_args(argv)
    try:
        words = [(v, *parse(v)) for v in args.variants or VARIANTS]
    except ValueError as e:
        ap.error(str(e))
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: use --device cpu for the "
                             "plain version")
        print(f"device: {card()} platform=gpu", flush=True)
    else:
        print("device: cpu (plain PyTorch version, not timed)", flush=True)
    results = {}
    for word, variant, unroll, tj in words:
        r = run_variant(variant, args.lq, args.lt, args.tiles, unroll, tj,
                        device=args.device)
        results[word] = r
        rate = "not timed" if r[0] is None else f"{r[0]:8.1f} Gcells/s"
        print(f"{word:12s} {rate}  score={r[1][:6]} qe={r[2][:6]} "
              f"te={r[3][:6]}", flush=True)
    return results


if __name__ == "__main__":
    main()
