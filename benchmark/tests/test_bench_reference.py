"""The plain reference against the port's CPU path and the ungapped
slice's goldens, at sizes the CPU holds."""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark import gen
from benchmark.entries import common
from benchmark.reference import gapless, hits, scoring, sw
from benchmark.reference import predict as rp

ROOT = pathlib.Path(__file__).resolve().parents[2]
SMALL_DB = dict(json.loads((ROOT / "benchmark" / "configs" /
                           "predict_gpu.json").read_text()), n_targets=300)


@pytest.fixture(scope="module")
def slice_():
    tdb = gen.targets(20261018, SMALL_DB)
    cs = gen.contigs(20261018, 0, tdb, dict(
        contigs=2, contig_len=[3000, 9000], gene_density=0.55,
        dna_mut=[0.02, 0.12]))
    frags = [f for _, s in cs for f in rp.fragments(s)]
    qc = [scoring.encode(a) for _, _, a in frags]
    return tdb, cs, frags, qc, scoring.comp_bias(qc)


def test_fragments_equal_the_ports(slice_):
    from metaeuk_tpu_torch.ops.orf import OrfExtractor
    from metaeuk_tpu_torch.params import Params
    _, cs, _, _, _ = slice_
    ex = OrfExtractor(Params())
    for ci, (_, s) in enumerate(cs):
        locs, nucl = ex.extract_contig(s, ci)
        want = [(l.from_pos, l.to_pos, bytes(a)) for l, a in
                zip(locs, ex.translate_fragments(nucl))]
        assert rp.fragments(s) == want


def test_comp_bias_equals_the_ports(slice_):
    from metaeuk_tpu_torch.data.submat import (
        composition_bias_rounded_batch, encode_aa)
    _, _, frags, qc, qb = slice_
    port = composition_bias_rounded_batch([encode_aa(a) for _, _, a in
                                           frags], 1.0)
    assert all(np.array_equal(a, b) for a, b in zip(port, qb))
    assert any(np.any(b) for b in qb)


@pytest.mark.parametrize("sat", [None, 127])
def test_gapless_equals_the_ports_plain_version(slice_, sat):
    from metaeuk_tpu_torch.ops import ungapped_torch
    from metaeuk_tpu_torch.search.driver import pad_rows
    tdb, _, _, qc, qb = slice_
    qc, qb = qc[:24], qb[:24]
    gdb = gapless.GaplessDB(tdb.codes.astype(np.int64), tdb.offsets, "cpu")
    got = gapless.scores(gdb, qc, qb, sat=sat)
    tc = common.tcodes(tdb)
    L = max(len(c) for c in qc)
    nq, nt = len(qc), len(tc)
    port = ungapped_torch.gapless_gathered(
        torch.from_numpy(pad_rows(qc, L, np.uint8)),
        torch.from_numpy(pad_rows(qb, L, np.int8)),
        torch.tensor([len(c) for c in qc], dtype=torch.int32),
        torch.from_numpy(pad_rows(tc, int(tdb.lengths.max()), np.uint8)),
        torch.from_numpy(tdb.lengths.astype(np.int32)),
        torch.arange(nq).repeat_interleave(nt), torch.arange(nt).repeat(nq)
    ).view(nq, nt)
    if sat is None:
        assert torch.equal(got, port)
    else:
        # the control: equal below the saturation, capped above it
        assert torch.equal(got, port.clamp_max(sat))


def test_candidates_order_and_cut():
    s = torch.tensor([[20, 16, 16, 15, 40], [1, 2, 3, 4, 5]],
                     dtype=torch.int32)
    got = gapless.candidates(s, 15, 3)
    assert got[0].tolist() == [4, 0, 1]
    assert got[1].tolist() == []


def test_sw_equals_the_ports_oracle(slice_):
    from metaeuk_tpu_torch.ops import sw as oracle
    tdb, _, _, qc, qb = slice_
    tc = common.tcodes(tdb)
    rng = np.random.default_rng(7)
    pairs = np.stack([rng.integers(0, len(qc), 150),
                      rng.integers(0, len(tc), 150)], 1)
    got = sw.align(qc, qb, tc, pairs, "cpu", width=1 << 12)
    for k, (q, t) in enumerate(pairs):
        o = oracle.sw_align(qc[q], tc[t], qb[q])
        assert got["score"][k] == o["score"]
        if o["score"]:
            assert (got["q_start"][k], got["q_end"][k], got["t_start"][k],
                    got["t_end"][k]) == (o["q_start"], o["q_end"],
                                         o["t_start"], o["t_end"])


def test_evalue_equals_the_ports():
    from metaeuk_tpu_torch.search.evalue import EvalueComputation
    sc = np.arange(0, 400, 7)
    ql = np.arange(10, 10 + len(sc)) * 13
    ev = EvalueComputation(32_500_000, gapped=True)
    assert np.array_equal(hits.evalue(sc, ql, 32_500_000),
                          ev.compute_evalue(sc.astype(np.float64),
                                            ql.astype(np.float64)))
    assert np.array_equal(hits.bits(sc), ev.compute_bit_score_int(
        sc.astype(np.float64)))


def _predict_outputs(contigs, proteins):
    """The reference's four output files of easy-predict in the ungapped
    mode at MetaEuk's defaults."""
    tcodes = [scoring.encode(s) for _, s in proteins]
    lens = np.array([len(c) for c in tcodes])
    offsets = np.concatenate([[0], np.cumsum(lens)])
    gdb = gapless.GaplessDB(np.concatenate(tcodes), offsets, "cpu")
    db_res = int(lens.sum())
    t_acc = [n for n, _ in proteins]
    files = ["", "", "", ""]
    for ci, (name, seq) in enumerate(contigs):
        frags = rp.fragments(seq)
        qc = [scoring.encode(a) for _, _, a in frags]
        qb = scoring.comp_bias(qc)
        cands = gapless.candidates(gapless.scores(gdb, qc, qb), 15, 300)
        pairs = np.array([(k, t) for k, c in enumerate(cands) for t in c],
                         np.int64).reshape(-1, 2)
        aln = sw.align(qc, qb, tcodes, pairs, "cpu")
        h = hits.hit_table(pairs[:, 0], pairs[:, 1], aln,
                           np.array([len(qc[k]) for k in pairs[:, 0]]),
                           lens[pairs[:, 1]], db_res, 100, 11)
        reps = rp.reduce(rp.exon_sets(frags, h, db_res))
        for k, recs in enumerate(rp.records(reps, ci, name, seq, t_acc)):
            files[k] += "".join(recs)
    return files


def test_reference_gives_the_ungapped_slices_digests():
    golden = json.loads((ROOT / "tests" / "golden" /
                         "ungapped_slice.json").read_text())["metagenome"]
    contigs, proteins = gen.make_metagenome(golden["mbp"], golden["targets"],
                                            golden["seed"])
    files = _predict_outputs(contigs, proteins)
    got = {ext: hashlib.sha256(t.encode()).hexdigest() for ext, t in
           zip(("fas", "codon.fas", "headersMap.tsv", "gff"), files)}
    assert files[0].count(">") > 3
    assert got == golden["sha256"]
