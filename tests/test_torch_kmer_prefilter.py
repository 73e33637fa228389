"""The port's k-mer-index prefilter
(metaeuk_tpu_torch/search/kmer_prefilter.py) against the JAX package's
(metaeuk_tpu/search/kmer_prefilter.py).

The same seeded inputs go through both: the k-mer codes and the index's
posting ranges, the double-hit screen at one and two hits a diagonal, and
candidate_pairs on tests/data and on a 0.01 Mbp / 500-target metagenome with
a planted fragment of 1,024 aa (tests/golden/make_kmerpf_slice.py
PLANTED_CUT; the JAX module's XLA path on the CPU; the
port's plain gapless version, which its wrapper runs on CPU tensors). Every
output is an integer: the tolerance is exact equality. The port stages the
candidates' fragments by length bucket: fragments up to 512 aa go to
gapless_pair, longer ones to gapless_long, counted under that kernel's name
as plain calls on the CPU.
"""

import pathlib
import sys

import numpy as np
import pytest

from metaeuk_tpu.io.seqdb import DBTYPE_AA, DBTYPE_NUCL, SeqDB
from metaeuk_tpu.ops.orf import OrfExtractor
from metaeuk_tpu.params import Params
from metaeuk_tpu.search import kmer_prefilter as jax_kpf
from metaeuk_tpu_torch.io.seqdb import SeqDB as TorchSeqDB
from metaeuk_tpu_torch.ops import ungapped_cuda
from metaeuk_tpu_torch.search import kmer_prefilter as kpf
from metaeuk_tpu_torch.search.prefilter import CELL_BUDGET, _bucket

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).parent.parent
DATA = ROOT / "tests" / "data"
sys.path.insert(0, str(ROOT / "tests" / "golden"))
import make_kmerpf_slice as mks  # noqa: E402


def _fragments(contigs):
    ex = OrfExtractor(Params())
    frags = []
    for ci in range(len(contigs)):
        _, f = ex.extract_contig(contigs.seq_bytes(ci), ci)
        frags.extend(ex.translate_fragments(f))
    return frags


def _fixture():
    targets = SeqDB.from_fasta(DATA / "proteins.faa", DBTYPE_AA)
    frags = _fragments(SeqDB.from_fasta(DATA / "contigs.fna", DBTYPE_NUCL))
    return frags, targets


@pytest.fixture(scope="module")
def metagenome():
    """(fragments, targets): make_kmerpf_slice.PLANTED_CUT, the 0.01 Mbp /
    500-target cut with a fragment of 1,024 aa holding targets 0 and 1."""
    return mks.planted_cut(mks.PLANTED_CUT, OrfExtractor, Params, SeqDB,
                           DBTYPE_AA)


def _torch_db(db):
    return TorchSeqDB.from_sequences([db.seq_bytes(i) for i in range(len(db))],
                                     dbtype=DBTYPE_AA)


@pytest.mark.parametrize("k", [6, 3])
def test_seq_kmers_match_jax(k):
    """Seeded encodings with X (20) planted, shorter than k and empty."""
    rng = np.random.default_rng(k)
    for n in (0, k - 1, k, 50, 300):
        enc = rng.integers(0, 21, n)
        enc[::17] = 20
        want = jax_kpf.seq_kmers(enc, k)
        got = kpf.seq_kmers(enc, k)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)
    # a k-mer holding an X is skipped
    codes, pos = kpf.seq_kmers(np.array([0, 1, 20, 3, 4, 5, 6, 7, 8, 9]), 6)
    assert pos.tolist() == [3, 4]


def test_kmer_index_lookup_matches_jax():
    rng = np.random.default_rng(7)
    targets = [rng.integers(0, 4 if i % 3 else 21, rng.integers(0, 90))
               for i in range(40)]
    jidx, tidx = jax_kpf.KmerIndex(targets, 4), kpf.KmerIndex(targets, 4)
    for a in ("codes", "tids", "pos"):
        np.testing.assert_array_equal(getattr(jidx, a), getattr(tidx, a))
    query = np.concatenate([tidx.codes[::7], rng.integers(0, 21 ** 4, 50)])
    for a, b in zip(jidx.lookup(query), tidx.lookup(query)):
        np.testing.assert_array_equal(a, b)
    lo, hi = tidx.lookup(query)
    assert (hi - lo).max() > 1 and (hi == lo).any()


@pytest.mark.parametrize("matches", [1, 2])
def test_candidate_targets_match_jax(metagenome, matches):
    frags, targets = metagenome
    mine = kpf.KmerPrefilter(Params(), _torch_db(targets),
                             min_diag_matches=matches, device="cpu")
    ref = jax_kpf.KmerPrefilter(Params(), targets, min_diag_matches=matches)
    n_hit = 0
    for f in frags:
        enc = kpf.encode_aa(f)
        want, got = ref.candidate_targets(enc), mine.candidate_targets(enc)
        np.testing.assert_array_equal(want, got)
        n_hit += len(got)
    assert n_hit > 20


def _assert_same_pairs(frags, targets, p, **kw):
    ref = jax_kpf.KmerPrefilter(p, targets, **kw).candidate_pairs(frags)
    ungapped_cuda.reset_counts()
    pf = kpf.KmerPrefilter(p, _torch_db(targets), device="cpu", **kw)
    got = pf.candidate_pairs(frags)
    assert got.dtype == np.int64 and got.shape == ref.shape
    np.testing.assert_array_equal(ref, got)
    assert ungapped_cuda.PLAIN_CALLS["gapless_rows"] == 0
    assert ungapped_cuda.LAUNCHES == dict.fromkeys(ungapped_cuda.KERNELS, 0)
    assert set(pf.stage_seconds) == {"index", "screen", "rescore", "select"}
    return pf, got


def test_candidate_pairs_match_jax_on_fixture():
    frags, targets = _fixture()
    _, got = _assert_same_pairs(frags, targets, Params())
    assert len(got) >= 8
    assert ungapped_cuda.PLAIN_CALLS["gapless_pair"] > 0


def test_candidate_pairs_match_jax_truncated_and_thresholded(metagenome):
    """One hit a diagonal, a tight --max-seqs and a higher score gate cut
    the metagenome's lists."""
    frags, targets = metagenome
    p = Params(max_res_list_len=2)
    pf, got = _assert_same_pairs(frags, targets, p, min_diag_score=40,
                                 min_diag_matches=1)
    assert np.bincount(got[:, 0]).max() == 2
    orfs_enc, orf_bias, pairs = pf.candidates(frags)
    scores = pf.score_pairs(orfs_enc, orf_bias, pairs)
    assert 0 < (scores <= 40).sum() < len(pairs)


def test_candidate_pairs_match_jax_on_metagenome(metagenome):
    """The cut with its planted 1,024-aa fragment: the pair array equals the
    JAX module's (which stages every fragment at 1,024 rows), the planted
    fragment keeps targets 0 and 1, and the port launched gapless_pair once
    a short bucket and gapless_long once for the planted fragment's."""
    frags, targets = metagenome
    pf, got = _assert_same_pairs(frags, targets, Params())
    assert {0, 1} <= set(got[got[:, 0] == mks.PLANTED_CUT["at"], 1].tolist())
    orfs_enc, _, pairs = pf.candidates(frags)
    widths = np.array([_bucket(max(1, len(orfs_enc[i]))) for i in pairs[:, 0]])
    t_width = _bucket(int(pf.target_lens.max()))
    want = dict.fromkeys(ungapped_cuda.KERNELS, 0)
    for w, n in zip(*np.unique(widths, return_counts=True)):
        step = max(128, CELL_BUDGET["cpu"] // (int(w) * t_width))
        want[ungapped_cuda.kernel_for(int(w))] += -(-int(n) // step)
    assert want["gapless_long"] == 1 and want["gapless_pair"] >= 2
    assert ungapped_cuda.PLAIN_CALLS == want


def test_scores_are_scattered_back_to_the_candidates_order(metagenome):
    """score_pairs on the candidates, shuffled: each pair's score follows it
    (the buckets' launches write back by candidate position)."""
    frags, targets = metagenome
    pf = kpf.KmerPrefilter(Params(), _torch_db(targets), device="cpu")
    orfs_enc, orf_bias, pairs = pf.candidates(frags)
    scores = pf.score_pairs(orfs_enc, orf_bias, pairs)
    perm = np.random.default_rng(3).permutation(len(pairs))
    np.testing.assert_array_equal(
        pf.score_pairs(orfs_enc, orf_bias, pairs[perm]), scores[perm])
    assert scores.dtype == np.int32 and (scores > 15).mean() > 0.5


def test_empty_inputs():
    frags, targets = _fixture()
    pf = kpf.KmerPrefilter(Params(), _torch_db(targets), device="cpu")
    assert pf.candidate_pairs([]).shape == (0, 2)
    assert pf.candidate_pairs([b"MKV", b""]).shape == (0, 2)
