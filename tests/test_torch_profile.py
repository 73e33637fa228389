"""The port's profile-target search (M5) against the JAX package.

The PSSM plain versions (ops/sw_torch.py sw_ends_prof / sw_starts_prof,
what ops/sw_cuda.py runs on a CPU tensor) are held to the JAX package's CPU
route (ops/sw_jax.py sw_align_batch_prof) and to its TPU route
(sw_pallas._align_full_prof in interpret mode, as tests/test_sw_pallas.py
runs Pallas); ProfileSearchDriver, slice_search_db, ProfileQueryAligner and
easy-predict against an HMM-profile DB to metaeuk_tpu's, all on the CPU.
Every output is an integer or bytes: the tolerance is exact equality. The
PSSM entries of the CUDA kernels are held to their plain versions on the
card (marker gpu).
"""

import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from metaeuk_tpu.io.profiledb import ProfileDB as JaxProfileDB
from metaeuk_tpu.io.seqdb import DBTYPE_AA, DBTYPE_NUCL
from metaeuk_tpu.io.seqdb import SeqDB as JaxSeqDB
from metaeuk_tpu.ops.orf import OrfExtractor
from metaeuk_tpu.ops.sw_jax import sw_align_batch_prof
from metaeuk_tpu.ops.sw_pallas import (TB, _align_full_prof, _build_S_prof,
                                       _sw_pallas_starts_from_S, _tj_for)
from metaeuk_tpu.params import Params as JaxParams
from metaeuk_tpu.search import profile_align as jax_align
from metaeuk_tpu.search import profile_search as jax_search
from metaeuk_tpu_torch.io.profiledb import ProfileDB
from metaeuk_tpu_torch.io.seqdb import SeqDB
from metaeuk_tpu_torch.ops import sw_cuda, sw_torch
from metaeuk_tpu_torch.params import Params
from metaeuk_tpu_torch.pipeline.predict import EasyPredict
from metaeuk_tpu_torch.search import profile_align, profile_search

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
GOLDEN = ROOT / "tests" / "golden"
PROF = GOLDEN / "profile"
ENRICH = GOLDEN / "enrich"
SUFFIXES = ("fas", "codon.fas", "headersMap.tsv", "gff")
FIELDS = ("score", "q_start", "q_end", "t_start", "t_end")
sys.path.insert(0, str(GOLDEN))
import make_profile_slice as mps  # noqa: E402


def _random_batch(seed, B=64, Lq=300, Lt=300):
    """Random PSSMs in [-32, 31] (X column 0) with lengths 1..Lq against
    fragments of lengths 1..Lt, some sharing a stretch of the profile's best
    residues (real hits). numpy int32."""
    rng = np.random.default_rng(seed)
    prof = rng.integers(-32, 32, (B, Lq, 21)).astype(np.int32)
    prof[:, :, 20] = 0
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    tl = rng.integers(1, Lt + 1, B).astype(np.int32)
    t = rng.integers(0, 21, (B, Lt)).astype(np.int32)
    for b in range(2, B, 3):
        n = int(min(ql[b], tl[b], 50))
        t[b, :n] = prof[b, :n, :20].argmax(1)
    return prof, ql, t, tl


# (fragment rows n, columns m, edge rows e): ties in rows e - 1 and e, in
# one column, in two columns (the later row first) and in the first and
# last columns; the first rows (1: rows 0/1), a lane's and a group's
# 31/32, the last rows, and the row stripe's 511/512
TIE_EDGES = ((40, 50, (1, 31, 32, 39)), (64, 60, (1, 32, 63)),
             (600, 60, (1, 511, 512, 599)))


def _tie_batch(Lq, Lt, seed=5):
    """PSSM pairs whose only positive cells are two planted 9s (every other
    cell scores -4..-1): the planted cells' fragment columns hold codes 18
    and 19, found nowhere else in the fragment, and only the planted rows
    score 9 on them. Also one cell of the two a row past q_len or a column
    past t_len. Returns (prof, ql, t, tl) and, per pair, the expected
    forward end and reverse start over the whole matrix as (score, row,
    column)."""
    rng = np.random.default_rng(seed)
    ties = []
    for n, m, edges in TIE_EDGES:
        if n > Lq or m > Lt:
            continue
        c = m // 2
        for e in edges:
            ties += [(n, m, (e - 1, c), (e, c)),
                     (n, m, (e - 1, c + 3), (e, c)),
                     (n, m, (e - 1, 0), (e, m - 1)),
                     (n, m, (e, 0), (e - 1, m - 1))]
        ties += [(n, m, (n - 1, c + 2), (n, c)),
                 (n, m, (edges[1], m - 1), (edges[1] - 1, m))]
    B = len(ties)
    prof = rng.integers(-4, 0, (B, Lq, 21)).astype(np.int32)
    t = rng.integers(0, 18, (B, Lt)).astype(np.int32)
    ql = np.array([n for n, _, _, _ in ties], np.int32)
    tl = np.array([m for _, m, _, _ in ties], np.int32)
    expect = []
    for b, (n, m, x, y) in enumerate(ties):
        t[b, x[1]], t[b, y[1]] = 18, 18 if x[1] == y[1] else 19
        prof[b, x[0], t[b, x[1]]] = prof[b, y[0], t[b, y[1]]] = 9
        real = [(r, col) for r, col in (x, y) if r < n and col < m]
        fwd = min(real, key=lambda rc: (rc[1], rc[0]))
        rev = max(real, key=lambda rc: (rc[1], rc[0]))
        expect.append(((9, *fwd), (9, *rev)))
    return (prof, ql, t, tl), expect


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _plain(prof, ql, t, tl):
    return [a.numpy() for a in sw_torch.align_full_prof(
        *_torch(prof, ql, t, tl))]


def _plain_whole_starts(prof, ql, t, tl):
    """The plain reverse pass over each pair's whole matrix."""
    return [a.numpy() for a in sw_torch.sw_starts_prof(
        *_torch(prof, ql, t, tl, ql - 1, tl - 1))]


def _padded(B, *arrays):
    """arrays padded to a multiple of TB pairs with zero-length pairs."""
    pad = -B % TB
    return [np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)) for a in arrays]


def _pallas(prof, ql, t, tl):
    """sw_pallas._align_full_prof in interpret mode."""
    B = len(ql)
    out = _align_full_prof(*_padded(B, prof, ql, t, tl), prof.shape[1],
                           t.shape[1], True)
    return [np.asarray(o)[:B] for o in out]


def _pallas_whole_starts(prof, ql, t, tl):
    """The Pallas reverse kernel in interpret mode over each pair's whole
    matrix, on _build_S_prof's score tensor."""
    B, Lq, Lt = len(ql), prof.shape[1], t.shape[1]
    prof, ql, t, tl = _padded(B, prof, ql, t, tl)
    TJ = _tj_for(Lq)
    Lt_pad = (Lt + TJ - 1) // TJ * TJ
    S = _build_S_prof(prof, ql, t, Lq, Lt, Lt_pad, t_len=tl)
    out = _sw_pallas_starts_from_S(S, ql - 1, tl - 1, Lq, Lt_pad, len(ql),
                                   True)
    return [np.asarray(o)[:B] for o in out]


def _assert_equal(ref, got):
    for name, a, b in zip(FIELDS, ref, got):
        np.testing.assert_array_equal(np.asarray(a), b, name)


def _check_ties(expect, out, whole):
    """Forward ends of align_full's output `out` and the starts `whole` of
    the reverse pass over the whole matrix against the planted cells."""
    for b, ex in enumerate(expect):
        fwd = (int(out[0][b]), int(out[2][b]), int(out[4][b]))
        rev = tuple(int(a[b]) for a in whole)
        assert (fwd, rev) == ex, (b, fwd, rev, ex)


CASES = {"random": lambda: (_random_batch(11), None),
         "ties_64": lambda: _tie_batch(72, 64),
         "ties_512": lambda: _tie_batch(608, 64)}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_prof_matches_sw_jax(case):
    arrays, expect = CASES[case]()
    got = _plain(*arrays)
    _assert_equal(sw_align_batch_prof(*arrays), got)
    if expect is not None:
        _check_ties(expect, got, _plain_whole_starts(*arrays))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_prof_matches_pallas_interpret(case):
    arrays, expect = CASES[case]()
    _assert_equal(_pallas(*arrays), _plain(*arrays))
    if expect is not None:
        for name, a, b in zip(("score", "q_start", "t_start"),
                              _pallas_whole_starts(*arrays),
                              _plain_whole_starts(*arrays)):
            np.testing.assert_array_equal(a, b, name)


def test_plain_prof_over_4096_rows_matches_sw_jax():
    """One 4,200-row profile (the JAX package ran these on XLA; the port on
    K1/K2's warp class) against fragments that match stretches of it."""
    rng = np.random.default_rng(4200)
    B, Lq, Lt = 4, 4200, 160
    prof = rng.integers(-6, 3, (1, Lq, 21)).repeat(B, 0).astype(np.int32)
    prof[:, :, 20] = 0
    best = prof[0, :, :20].argmax(1)
    t = rng.integers(0, 20, (B, Lt)).astype(np.int32)
    for b, at in enumerate((0, 1500, 3990, 4200 - 150)):
        t[b, 5:155] = best[at:at + 150]
    ql = np.full(B, Lq, np.int32)
    tl = np.array([160, 150, 155, 160], np.int32)
    got = _plain(prof, ql, t, tl)
    _assert_equal(sw_align_batch_prof(prof, ql, t, tl), got)
    assert (got[0] > 0).all() and got[2][2] >= 4096


def test_cap_follows_the_pallas_route():
    """H is capped at 32767 by the Pallas kernels, the port's K1/K2 and its
    plain versions, and not by sw_jax (the JAX package's CPU route). A
    1,100-row profile that scores 31 on its own residue and -32 on every
    other against the fragment of those residues: the run reaches 31 *
    1057 = 32767 at row and column 1056. The port (and Pallas) end there,
    sw_jax runs on to 34,100 at 1099; both start at (0, 0)."""
    rng = np.random.default_rng(1100)
    n = 1100
    t = rng.integers(0, 20, (1, n)).astype(np.int32)
    prof = np.full((1, n, 21), -32, np.int32)
    prof[0, np.arange(n), t[0]] = 31
    prof[:, :, 20] = 0
    ql = tl = np.array([n], np.int32)
    got = _plain(prof, ql, t, tl)
    assert [int(a[0]) for a in got] == [32767, 0, 1056, 0, 1056]
    ref = sw_align_batch_prof(prof, ql, t, tl)
    assert [int(a[0]) for a in ref] == [34100, 0, 1099, 0, 1099]


def _fixture_fragments(contigs_fna=DATA / "contigs.fna"):
    contigs = JaxSeqDB.from_fasta(contigs_fna, DBTYPE_NUCL)
    ex = OrfExtractor(JaxParams())
    frags = []
    for ci in range(len(contigs)):
        _, f = ex.extract_contig(contigs.seq_bytes(ci), ci)
        frags.extend(ex.translate_fragments(f))
    return frags


def _same_hits(ref, got):
    assert len(ref) > 0 and ref.dtype == got.dtype
    for name in ref.dtype.names:
        np.testing.assert_array_equal(ref[name], got[name], name)


def test_profile_search_matches_jax_on_fixture():
    frags = _fixture_fragments()
    ref = jax_search.ProfileSearchDriver(
        JaxParams(), JaxProfileDB.from_db(PROF / "profileDB")).search(frags)
    got = profile_search.ProfileSearchDriver(
        Params(), ProfileDB.from_db(PROF / "profileDB"), "cpu").search(frags)
    _same_hits(ref, got)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """About 200 profiles (make_profile_slice.write_profile_db on a small
    metagenome's targets, cut to 40-120 aa) and the metagenome's
    fragments."""
    from tools.make_metagenome import make_metagenome, write_fasta
    td = tmp_path_factory.mktemp("profslice")
    contigs, proteins = make_metagenome(0.02, 200, 20260827)
    rng = np.random.default_rng(3)
    proteins = [(name, seq[:int(rng.integers(40, 121))])
                for name, seq in proteins]
    write_fasta(td / "c.fna", contigs)
    mps.write_profile_db(proteins, td / "profdb", 20260828)
    return td, _fixture_fragments(td / "c.fna")


@pytest.mark.parametrize("mode", ["kmer", "exhaustive"])
def test_profile_search_matches_jax_on_synthetic_profiles(
        synthetic, mode, monkeypatch):
    td, frags = synthetic
    if mode == "exhaustive":
        monkeypatch.setenv("METAEUK_PROFILE_PREF", "exhaustive")
        frags = frags[:30]
    ref = jax_search.ProfileSearchDriver(
        JaxParams(), JaxProfileDB.from_db(td / "profdb")).search(frags)
    got = profile_search.ProfileSearchDriver(
        Params(), ProfileDB.from_db(td / "profdb"), "cpu").search(frags)
    assert len(ProfileDB.from_db(td / "profdb")) == 200
    _same_hits(ref, got)


def test_generated_profile_db_round_trips(synthetic):
    """write_profile_db's records read back through ProfileDB.from_db (the
    port's and the JAX package's) as PSSM trunc(raw / 4), query letters,
    keys and headers."""
    from tools.make_metagenome import make_metagenome
    td, _ = synthetic
    db = ProfileDB.from_db(td / "profdb")
    jdb = JaxProfileDB.from_db(td / "profdb")
    _, proteins = make_metagenome(0.02, 200, 20260827)
    assert db.keys == list(range(200)) == jdb.keys
    for k in (0, 57, 199):
        name, seq = proteins[k]
        n = len(db.pssms[k])
        assert seq.startswith(bytes(
            b"ACDEFGHIKLMNPQRSTVWYX"[c] for c in db.query_seqs[k]))
        raw = db.raw_scores[k].astype(np.int32)
        assert raw.shape == (n, 20) and db.pssms[k].shape == (n, 21)
        np.testing.assert_array_equal(db.pssms[k][:, :20],
                                      np.trunc(raw / 4.0))
        np.testing.assert_array_equal(db.pssms[k][:, 20], 0)
        np.testing.assert_array_equal(db.pssms[k], jdb.pssms[k])
        own = raw[np.arange(n), db.query_seqs[k]]
        assert (own >= 4 * 4 - 6).all()   # BLOSUM62's diagonal is >= 4
        assert db.accession(k) == jdb.accession(k) == name.split()[0]


def test_sliced_profile_search_budget_invariance(monkeypatch):
    """Slice budgeting (searchslicedtargetprofile.sh:46-120 role): 2,000
    synthetic profiles searched under a tiny staging budget give the hit
    array of one unbudgeted pass, which equals the JAX driver's (the port
    of tests/test_profile.py's test at a fifth of its profiles)."""

    class _PDB:
        def __init__(self, pssms):
            self.pssms = pssms

        def __len__(self):
            return len(self.pssms)

        def total_residues(self):
            return sum(len(p) for p in self.pssms)

    rng = np.random.default_rng(9)
    pssms = [rng.integers(-8, 12, (int(rng.integers(12, 40)), 21))
             .astype(np.int32) for _ in range(2000)]
    aas = b"ACDEFGHIKLMNPQRSTVWY"
    frags = [bytes(aas[c] for c in rng.integers(0, 20, int(n)))
             for n in rng.integers(20, 60, 2)]
    p = Params(search_evalue_thr=1e9)
    calls = []
    for budget in (1 << 20, 1 << 34):   # about 48 profiles a slice; one
        monkeypatch.setenv("METAEUK_SLICE_BUDGET", str(budget))
        sw_cuda.reset_counts()
        calls.append(profile_search.ProfileSearchDriver(
            p, _PDB(pssms), "cpu").search(frags))
        calls[-1] = (calls[-1], sw_cuda.PLAIN_CALLS["sw_pair_ends_prof"])
    (sliced, n_sliced), (whole, n_whole) = calls
    assert n_sliced >= 2000 // 48 > n_whole
    ref = jax_search.ProfileSearchDriver(
        JaxParams(search_evalue_thr=1e9), _PDB(pssms)).search(frags)
    _same_hits(whole, sliced)
    _same_hits(ref, whole)


def _query_db(tmp_path):
    mps.write_query_db(mps.SEARCH_QUERIES, tmp_path / "qdb")
    return tmp_path / "qdb"


def test_slice_search_db_matches_jax_and_the_golden(tmp_path):
    """slice_search_db with backtraces on the enrich fixture: the result
    DB's bytes equal the JAX package's and tests/golden/enrich/search_slice
    (the reference binary's), whose digests chip_smoke.py reads from
    profile_slice.json."""
    qdb = _query_db(tmp_path)
    jax_search.slice_search_db(str(qdb), str(mps.SEARCH_PROFILES),
                               str(tmp_path / "ref"))
    profile_search.slice_search_db(str(qdb), str(mps.SEARCH_PROFILES),
                                   str(tmp_path / "got"), device="cpu")
    for s in mps.DB_SUFFIXES:
        got = pathlib.Path(f"{tmp_path / 'got'}{s}").read_bytes()
        assert got == pathlib.Path(f"{tmp_path / 'ref'}{s}").read_bytes(), s
        assert got == pathlib.Path(f"{ENRICH / 'search_slice'}{s}") \
            .read_bytes(), s
        assert mps.sha256(f"{tmp_path / 'got'}{s}") == json.loads(
            (GOLDEN / "profile_slice.json").read_text())["slice_search"][
                "sha256"][s], s


def test_profile_query_aligner_matches_jax():
    """ProfileQueryAligner.search (all 24 x 6 pairs of the enrich profiles
    against the fixture proteins, with a loose E-value) and .backtraces."""
    pairs = [(p, t) for p in range(24) for t in range(6)]
    jp = dataclasses.replace(JaxParams(), search_evalue_thr=100.0)
    ref_al = jax_align.ProfileQueryAligner(
        jp, JaxProfileDB.from_db(ENRICH / "profdb"),
        JaxSeqDB.from_fasta(DATA / "proteins.faa", DBTYPE_AA))
    got_al = profile_align.ProfileQueryAligner(
        Params(search_evalue_thr=100.0), ProfileDB.from_db(ENRICH / "profdb"),
        SeqDB.from_fasta(DATA / "proteins.faa", DBTYPE_AA), "cpu")
    ref, got = ref_al.search(pairs), got_al.search(pairs)
    _same_hits(ref, got)
    ref_bt, ref_id = ref_al.backtraces(ref)
    got_bt, got_id = got_al.backtraces(got)
    assert ref_bt == got_bt and any(ref_bt)
    np.testing.assert_array_equal(ref_id, got_id)


@pytest.fixture(scope="module")
def fixture_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("pp") / "preds"
    sw_cuda.reset_counts()
    EasyPredict(Params(), device="cpu").run(
        DATA / "contigs.fna", str(PROF / "profileDB"), str(out))
    return out, dict(sw_cuda.PLAIN_CALLS)


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_profile_easypredict_byte_parity(fixture_run, suffix):
    out, plain = fixture_run
    assert pathlib.Path(f"{out}.{suffix}").read_bytes() == \
        (PROF / f"pp.{suffix}").read_bytes()
    assert plain["sw_pair_ends_prof"] > 0 and plain["sw_pair_ends"] == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_prof_kernels_match_plain_on_card(cuda_device, case):
    """The PSSM entries of K1/K2 against their plain versions, the pairs
    read from staged matrices in a shuffled order."""
    (prof, ql, t, tl), _ = CASES[case]()
    B = len(ql)
    perm = np.random.default_rng(B).permutation(B)
    staged = [torch.from_numpy(a).to(cuda_device) for a in (prof, ql, t, tl)]
    li = torch.from_numpy(perm.astype(np.int32)).to(cuda_device)
    lj = li.flip(0)
    sw_cuda.reset_counts()
    got = sw_cuda.align_full_prof(*staged, li, lj)
    torch.cuda.synchronize()
    assert sw_cuda.LAUNCHES["sw_pair_ends_prof"] == 1
    assert sw_cuda.LAUNCHES["sw_pair_starts_prof"] == 1
    cpu = [a.cpu() for a in staged]
    ref = sw_cuda.align_full_prof(*cpu, li.cpu(), lj.cpu())
    for name, a, b in zip(FIELDS, ref, got):
        assert torch.equal(a, b.cpu()), name
