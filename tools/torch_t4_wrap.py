#!/usr/bin/env python3
"""T4's nocap and fold_nocap (csrc/qm_variants.cu) where their packed words
wrap, for one or more checkouts of the repository on one CUDA device.

    python3 tools/torch_t4_wrap.py [CHECKOUT ...]

The input is tests/test_torch_kernel_variants.py's WRAP_SHAPE: one tile,
Lq = Lt = 272, every cell scoring 250 (+1 GE for fold_nocap), tj 272,
unroll 8, so that H passes 65,536 from row 262 and H' = H + i ge from row
261. Each CHECKOUT (default: this one) runs in a process of its own with
its own package (its qm_variants.cu is built at first use, about 100 s of
nvcc) and prints lane 0's (best, q_end, t_end) from the kernel and from
this repository's plain version, and whether every lane is equal.
"""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
VARIANTS = ("nocap", "fold_nocap")
LQ = LT = 272


def inputs(torch, variant):
    """(prof bfloat16, tc int32) on the CPU: the tests' cap input."""
    prof = torch.full((1, LQ, 32), 250.0)
    tc = torch.zeros((LT, 128), dtype=torch.int32)
    prof[:, :, 21:] = -128
    tc[:, 1], tc[:, 2], tc[:, 3] = 25, 40, -1
    if variant == "fold_nocap":
        prof[:, :, :21] += 1
    return prof.bfloat16(), tc


def one(checkout):
    sys.path.insert(0, str(pathlib.Path(checkout).resolve()))
    import torch
    from metaeuk_tpu_torch.ops import qm_variants_cuda
    res = {}
    for v in VARIANTS:
        prof, tc = inputs(torch, v)
        got = qm_variants_cuda.qm_variant_ends(prof.cuda(), tc.cuda(), v, LT,
                                               8)
        res[v] = [o.cpu().tolist() for o in got]
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the run needs one GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from metaeuk_tpu_torch.ops import qm_variants_torch
    plain = {v: [o.tolist() for o in qm_variants_torch.qm_variant_ends(
        *inputs(torch, v), v, LT, 8)] for v in VARIANTS}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for checkout in argv or [str(ROOT)]:
        res = subprocess.run([sys.executable, __file__, "--one", checkout],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        got = json.loads(res.stdout.strip().splitlines()[-1])
        for v in VARIANTS:
            print(f"{checkout} {v}: kernel lane 0 "
                  f"{[o[0] for o in got[v]]}, plain "
                  f"{[o[0] for o in plain[v]]}, every lane equal "
                  f"{got[v] == plain[v]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
