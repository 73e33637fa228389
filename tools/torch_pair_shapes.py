#!/usr/bin/env python3
"""Candidate pairs of the pair SW kernels (K1/K2) by (Lq, Lt) bucket, for
the k-mer slices that chip_smoke.py phases 5 and 5c run, and of their
PSSM entries for the profile slice of phase 5d.

    python3 tools/torch_pair_shapes.py [kmer|long|profile ...]

Runs on the CPU (no card, no kernel): ORF extraction of the 1.6 Mbp /
3000-target k-mer slice (tools/make_metagenome.py, tests/golden/
multichip_slice.json) and of the long-frame contigs alone
(tests/golden/make_long_slice.py CHIP_SLICE, against the slice's
targets), the k-mer prefilter (ReferenceKmerPrefilter, the native C++),
then the align driver's length tiers and routing (search/driver.py: the
tier policy, the gate of search(), QM_MIN_CANDS and QM_MAX_LQ). Prints one
JSON line per slice: for each bucket the candidate pairs, the fragment and
target length percentiles (PERCENTILES), the forward cells (true lengths),
their bound at chip_smoke.py SW_OPS operations a cell and an H100's int32
rate (INT32_OPS_PER_S), the route of the pairs under the default routing
(pair, query-major or long-query kernels) and, of the pairs that take the
pair kernels forward, the count in each length class of
ops/sw_cuda.py PAIR_CLASSES; then the slice's totals, under the default
routing and under METAEUK_QM=off (every pair on K1/K2). For the profile
slice (tests/golden/make_profile_slice.py PROFILE_SLICE, the profile
prefilter of search/profile_search.py) the buckets are the profile search's
(Lq the profile tier, Lt the fragment tier), the rows are the profiles'
and every pair takes the PSSM entries; also the candidates a profile.
"""

import json
import pathlib
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the length percentiles printed per bucket (chip_smoke.py draws its second
# pair timing shape from the k-mer slice's)
PERCENTILES = (0, 10, 25, 50, 75, 90, 100)


def routes(driver, oi, lq_b, lt_b, n_orfs):
    """Per pair: "pair", "qm" or "qm_rt" under the default routing
    (driver.py _qm_mode's auto, the gate of search() and _split_qm)."""
    cand = np.bincount(oi, minlength=n_orfs)
    share = int(cand[cand >= driver.QM_MIN_CANDS].sum())
    qm_on = not (share < max(100_000, len(oi) // 20)
                 and int(lq_b.max()) <= driver.QM_MAX_LQ)
    out = np.full(len(oi), "pair", dtype=object)
    if not qm_on:
        return out
    for Lq, Lt in set(zip(lq_b.tolist(), lt_b.tolist())):
        sel = np.flatnonzero((lq_b == Lq) & (lt_b == Lt))
        if Lq > driver.QM_MAX_LQ:
            if Lt <= driver.QM_MAX_LQ:
                out[sel] = "qm_rt"
            continue
        counts = np.bincount(oi[sel], minlength=n_orfs)
        out[sel[counts[oi[sel]] >= driver.QM_MIN_CANDS]] = "qm"
    return out


def pcts(a):
    return [int(x) for x in np.percentile(a, PERCENTILES)] if len(a) \
        else []


def count(smoke, driver, sw_cuda, frags, targets, pairs):
    orf_lens = np.array([len(f) for f in frags], np.int64)
    t_lens = np.array([len(targets.seq_bytes(i))
                       for i in range(len(targets))], np.int64)
    oi, ti = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
    keep = (orf_lens[oi] > 0) & (t_lens[ti] > 0)
    oi, ti = oi[keep], ti[keep]
    fine = len(frags) >= driver.FINE_TIER_MIN_FRAGS
    lq_b = driver._bucket_arr(orf_lens, fine)[oi]
    lt_b = driver._bucket_arr(t_lens, fine)[ti]
    route = routes(driver, oi, lq_b, lt_b, len(frags))
    caps = np.array([g * r for g, r in sw_cuda.PAIR_CLASSES[:-1]])
    buckets, tot = [], {"auto": [0, 0], "off": [0, 0]}
    for Lq, Lt in sorted(set(zip(lq_b.tolist(), lt_b.tolist()))):
        sel = (lq_b == Lq) & (lt_b == Lt)
        ql, tl = orf_lens[oi[sel]], t_lens[ti[sel]]
        cells = ql * tl
        on_pair = route[sel] == "pair"
        cls = np.searchsorted(caps, ql[on_pair])
        buckets.append(dict(
            Lq=int(Lq), Lt=int(Lt), pairs=int(sel.sum()),
            frag_aa=pcts(ql), target_aa=pcts(tl), cells=int(cells.sum()),
            bound_ms=float(cells.sum()) * smoke.SW_OPS
            / smoke.INT32_OPS_PER_S * 1e3,
            routes={k: int((route[sel] == k).sum())
                    for k in ("pair", "qm", "qm_rt")},
            pair_classes=np.bincount(
                cls, minlength=len(sw_cuda.PAIR_CLASSES)).tolist()))
        tot["auto"][0] += int(on_pair.sum())
        tot["auto"][1] += int(cells[on_pair].sum())
        tot["off"][0] += int(sel.sum())
        tot["off"][1] += int(cells.sum())
    totals = {m: dict(pairs=p, cells=c, bound_ms=c * smoke.SW_OPS
                      / smoke.INT32_OPS_PER_S * 1e3)
              for m, (p, c) in tot.items()}
    return dict(fragments=len(frags), targets=len(t_lens), fine=fine,
                most_candidates=int(np.bincount(oi).max()),
                buckets=buckets, pair_kernels_forward=totals)


def count_profile(smoke, profile_search, sw_cuda, frags, profiles, params):
    """count()'s buckets for the PSSM entries on the profile slice."""
    from metaeuk_tpu_torch.data.submat import encode_aa
    enc = [encode_aa(f) for f in frags]
    orf_lens = np.array([len(e) for e in enc], np.int64)
    d = profile_search.ProfileSearchDriver(params, profiles, "cpu")
    pi, oi = d._candidate_pairs(enc, orf_lens, len(enc), len(profiles))
    keep = (orf_lens[oi] > 0) & (d.profile_lens[pi] > 0)
    pi, oi = pi[keep], oi[keep]
    lq_b = np.array([profile_search._bucket(n) for n in d.profile_lens])[pi]
    lt_b = np.array([profile_search._bucket(max(n, 1))
                     for n in orf_lens])[oi]
    caps = np.array([g * r for g, r in sw_cuda.PAIR_CLASSES[:-1]])
    buckets = []
    for Lq, Lt in sorted(set(zip(lq_b.tolist(), lt_b.tolist()))):
        sel = (lq_b == Lq) & (lt_b == Lt)
        pl, fl = d.profile_lens[pi[sel]], orf_lens[oi[sel]]
        cells = pl * fl
        buckets.append(dict(
            Lq=int(Lq), Lt=int(Lt), pairs=int(sel.sum()),
            profile_rows=pcts(pl), frag_aa=pcts(fl), cells=int(cells.sum()),
            bound_ms=float(cells.sum()) * smoke.SW_OPS
            / smoke.INT32_OPS_PER_S * 1e3,
            pair_classes=np.bincount(
                np.searchsorted(caps, pl),
                minlength=len(sw_cuda.PAIR_CLASSES)).tolist()))
    cells = int((d.profile_lens[pi] * orf_lens[oi]).sum())
    return dict(fragments=len(frags), profiles=len(profiles),
                pairs=len(pi), cells=cells,
                bound_ms=cells * smoke.SW_OPS / smoke.INT32_OPS_PER_S * 1e3,
                pairs_a_profile=pcts(np.bincount(pi,
                                                 minlength=len(profiles))),
                frag_aa=pcts(orf_lens), profile_rows=pcts(d.profile_lens),
                buckets=buckets)


def main(argv=None):
    argv = (sys.argv[1:] if argv is None else argv) or ["kmer", "long"]
    sys.path.insert(0, str(ROOT))
    sys.path.insert(1, str(ROOT / "tests" / "golden"))
    import chip_smoke as smoke
    import make_long_slice as mls
    import make_profile_slice as mps
    from metaeuk_tpu_torch.io.profiledb import ProfileDB
    from metaeuk_tpu_torch.io.seqdb import DBTYPE_AA, DBTYPE_NUCL, SeqDB
    from metaeuk_tpu_torch.ops import sw_cuda
    from metaeuk_tpu_torch.ops.orf import OrfExtractor
    from metaeuk_tpu_torch.params import Params
    from metaeuk_tpu_torch.search import driver, profile_search
    from metaeuk_tpu_torch.search.prefilter_kmer import \
        ReferenceKmerPrefilter
    from tools.make_metagenome import make_metagenome, write_fasta

    golden = json.loads((ROOT / "tests" / "golden" /
                         "multichip_slice.json").read_text())

    def long_contigs():
        contigs, proteins = mls.long_slice(mls.CHIP_SLICE)
        return [c for c in contigs if c[0].startswith("long")], proteins

    slices = {"kmer": lambda: make_metagenome(golden["mbp"],
                                              golden["targets"]),
              "long": long_contigs}
    p = Params()
    for name in argv:
        if name == "profile":
            with tempfile.TemporaryDirectory(prefix="meuk_pairs") as td:
                c, profdb = mps.profile_slice(mps.PROFILE_SLICE, td)
                frags = smoke.fragments(OrfExtractor(p), SeqDB.from_fasta(
                    str(c), DBTYPE_NUCL))
                out = count_profile(smoke, profile_search, sw_cuda, frags,
                                    ProfileDB.from_db(str(profdb)), p)
            print(json.dumps({"slice": name, **out}), flush=True)
            continue
        contigs, proteins = slices[name]()
        with tempfile.TemporaryDirectory(prefix="meuk_pairs") as td:
            write_fasta(f"{td}/c.fna", contigs)
            write_fasta(f"{td}/p.faa", proteins)
            frags = smoke.fragments(OrfExtractor(p), SeqDB.from_fasta(
                f"{td}/c.fna", DBTYPE_NUCL))
            targets = SeqDB.from_fasta(f"{td}/p.faa", DBTYPE_AA)
            pairs = ReferenceKmerPrefilter(
                p, targets, p.min_diag_score).candidate_pairs(frags)
            out = count(smoke, driver, sw_cuda, frags, targets,
                        np.asarray(pairs))
        print(json.dumps({"slice": name, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
