"""The k-mer-index prefilter slice: the k-mer slice's fragments (the 1.6 Mbp /
3,000-target synthetic metagenome of multichip_slice.json) against its
targets through the exact-6-mer index, the double-hit screen and the gapless
rescoring of search/kmer_prefilter.py, and tests/golden/kmerpf_slice.json.

kmerpf_slice() builds the slice's fragments (OrfExtractor at the default
Params, contig by contig, as predict.py's serial path translates them) and
target DB with either package's classes, and summary() gives the counts and
sha256 digests of a run's candidate pairs, their gapless scores and the kept
pairs. Both use numpy and tools/make_metagenome.py only, so chip_smoke.py
can build the slice and check the port on the card.

Run as a script, it runs metaeuk_tpu's KmerPrefilter on the CPU (its XLA
path), capturing the candidate pairs and scores that candidate_pairs sends
to ops/ungapped.py's gapless_scores_gathered, and prints the slice's
parameters, the counts and the digests:

    python3 tests/golden/make_kmerpf_slice.py > tests/golden/kmerpf_slice.json

metaeuk_tpu_torch's KmerPrefilter must give the same digests (chip_smoke.py
phase 5n holds the port to them on the card).
"""

import hashlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

COMMAND = "python3 tests/golden/make_kmerpf_slice.py"
KMERPF_SLICE = dict(mbp=1.6, targets=3000, seed=20260820, min_diag_score=15,
                    min_diag_matches=2, k=6, mask_mode=1)
# a small cut whose candidates reach the long-row buckets (none of the
# slice's seven fragments over 512 aa has a candidate): make_ungapped_slice
# .py's metagenome with, at fragment `at`, a fragment of `length` aa that
# holds targets 0 and 1 whole in random residues (seeded by `filler`)
PLANTED_CUT = dict(mbp=0.01, targets=500, seed=20260820, at=5, length=1024,
                   filler=20261018)
AA = b"ACDEFGHIKLMNPQRSTVWY"


def kmerpf_slice(cfg, OrfExtractor, Params, SeqDB, dbtype_aa):
    """(fragments, target DB): the translated fragments of cfg's contigs, in
    contig order, and its proteins as a SeqDB; the classes from either
    package."""
    from tools.make_metagenome import make_metagenome

    contigs, proteins = make_metagenome(cfg["mbp"], cfg["targets"],
                                        cfg["seed"])
    extractor = OrfExtractor(Params())
    frags = []
    for ci, (_, seq) in enumerate(contigs):
        _, fr = extractor.extract_contig(seq, ci)
        frags.extend(extractor.translate_fragments(fr))
    targets = SeqDB.from_sequences([s for _, s in proteins],
                                   [h for h, _ in proteins], dbtype_aa)
    return frags, targets


def planted_cut(cfg, OrfExtractor, Params, SeqDB, dbtype_aa):
    """kmerpf_slice's (fragments, target DB) of PLANTED_CUT, with its
    planted fragment inserted among the fragments."""
    import numpy as np

    frags, targets = kmerpf_slice(cfg, OrfExtractor, Params, SeqDB, dbtype_aa)
    rng = np.random.default_rng(cfg["filler"])
    fill = lambda n: bytes(AA[k] for k in rng.integers(0, 20, n))
    core = targets.seq_bytes(0) + fill(40) + targets.seq_bytes(1)
    pad = cfg["length"] - len(core)
    if pad <= 0:
        raise ValueError("targets 0 and 1 do not fit the planted fragment")
    frags.insert(cfg["at"], fill(pad // 2) + core + fill(pad - pad // 2))
    return frags, targets


def prefilter_kwargs(cfg):
    """KmerPrefilter's keyword arguments of the slice (either package)."""
    return {k: cfg[k] for k in ("min_diag_score", "min_diag_matches", "k",
                                "mask_mode")}


def summary(frags, targets, candidates, scores, kept):
    """(counts, digests) of a run: candidates (n, 2) int64 (fragment,
    target) pairs in scoring order, scores (n,) int32, kept (m, 2) int64;
    counts of the fragments, candidates, kept pairs and gapless cells."""
    import numpy as np

    arrays = {"candidates": np.ascontiguousarray(candidates, np.int64),
              "scores": np.ascontiguousarray(scores, np.int32),
              "kept": np.ascontiguousarray(kept, np.int64)}
    f_lens = np.array([len(f) for f in frags], np.int64)
    t_lens = np.asarray(targets.lengths, np.int64)
    cand = arrays["candidates"]
    counts = {"fragments": len(frags), "longest": int(f_lens.max()),
              "over_512": int((f_lens > 512).sum()),
              "candidates": len(cand), "kept": len(arrays["kept"]),
              "cells": int((f_lens[cand[:, 0]] * t_lens[cand[:, 1]]).sum())}
    return counts, {k: hashlib.sha256(v.tobytes()).hexdigest()
                    for k, v in arrays.items()}


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from metaeuk_tpu.io.seqdb import DBTYPE_AA, SeqDB
    from metaeuk_tpu.ops import ungapped
    from metaeuk_tpu.ops.orf import OrfExtractor
    from metaeuk_tpu.params import Params
    from metaeuk_tpu.search.kmer_prefilter import KmerPrefilter

    t0 = time.perf_counter()
    frags, targets = kmerpf_slice(KMERPF_SLICE, OrfExtractor, Params, SeqDB,
                                  DBTYPE_AA)
    t_slice = time.perf_counter() - t0
    calls = []
    scored = ungapped.gapless_scores_gathered

    def capture(q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj):
        out = scored(q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj)
        calls.append((np.asarray(li), np.asarray(lj),
                      np.asarray(out)[:len(li)]))
        return out

    ungapped.gapless_scores_gathered = capture
    t0 = time.perf_counter()
    pf = KmerPrefilter(Params(), targets, **prefilter_kwargs(KMERPF_SLICE))
    t_index = time.perf_counter() - t0
    t0 = time.perf_counter()
    kept = pf.candidate_pairs(frags)
    t_pairs = time.perf_counter() - t0
    li, lj, sc = (np.concatenate(a) for a in zip(*calls))
    real = li >= 0
    candidates = np.stack([li[real], lj[real]], axis=1).astype(np.int64)
    counts, digests = summary(frags, targets, candidates, sc[real], kept)
    print(json.dumps({
        "command": COMMAND, "input": KMERPF_SLICE,
        "params": {"max_seqs": Params().max_res_list_len},
        "seconds": {"slice": round(t_slice, 2), "index": round(t_index, 2),
                    "candidate_pairs": round(t_pairs, 2)},
        "counts": counts, "sha256": digests}, indent=1))


if __name__ == "__main__":
    main()
