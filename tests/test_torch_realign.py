"""The port's realign pass and backtraces against the JAX package, on the CPU.

ops/sw_cuda.py sw_align_batch (what SearchDriver.realign runs a bucket at a
time; on the CPU, K1/K2's plain versions with cap=None) is held to
metaeuk_tpu/ops/sw_jax.py sw_align_batch with the realign matrix
scores_with_bias(2.0, -0.2), on pairs with planted ties and on self-matches
whose score passes the kernels' cap 32767 (sw_jax does not cap H).
SearchDriver.realign and .backtraces are held to the JAX driver's field by
field (hits, backtrace strings, seq ids) on the fixture, on a seeded set with
planted ties and on a hit past the cap; chip_smoke.py's phase 5e, on a cut
of its search slice, to the JAX package's digests. Every output is an
integer, bytes or a float32 computed from integers: the tolerance is exact
equality. K1/K2's uncapped instances are held to their plain versions on the
card (marker gpu).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from metaeuk_tpu.io.seqdb import SeqDB as JaxSeqDB
from metaeuk_tpu.ops.sw_jax import sw_align_batch as jax_sw_align_batch
from metaeuk_tpu.params import Params as JaxParams
from metaeuk_tpu.search.driver import SearchDriver as JaxDriver
from metaeuk_tpu_torch import native, state
from metaeuk_tpu_torch.data.submat import encode_aa, scores_with_bias
from metaeuk_tpu_torch.io.seqdb import DBTYPE_AA, SeqDB
from metaeuk_tpu_torch.ops import sw_cuda
from metaeuk_tpu_torch.params import Params
from metaeuk_tpu_torch.search.driver import HIT_DTYPE, SearchDriver

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests" / "golden"))
import chip_smoke  # noqa: E402
import make_search_slice as mss  # noqa: E402
REALIGN = scores_with_bias(2.0, -0.2)
AA = b"ACDEFGHIKLMNPQRSTVWY"


def _tie_batch(seed, B=48, Lq=96, Lt=160):
    """Padded numpy codes, biases and lengths: random pairs, and pairs whose
    target holds the query's motif twice or three times (equal forward ends
    in two columns) or whose query repeats a motif that the target holds
    once (equal reverse starts in two rows)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, (B, Lq))
    t = rng.integers(0, 20, (B, Lt))
    ql = rng.integers(1, Lq + 1, B)
    tl = rng.integers(1, Lt + 1, B)
    for b in range(0, B, 3):
        m = int(rng.integers(8, 30))
        motif = rng.integers(0, 20, m)
        if b % 2 == 0:   # the motif twice or three times in the target
            q[b, :m], ql[b] = motif, m
            copies = 2 + b % 4 // 2
            gap = int(rng.integers(0, 12))
            pos = 0
            for _ in range(copies):
                t[b, pos:pos + m] = motif
                pos += m + gap
            tl[b] = max(tl[b], pos)
        else:            # the motif twice in the query, once in the target
            q[b, :m], q[b, m:2 * m], ql[b] = motif, motif, 2 * m
            t[b, 5:5 + m] = motif
            tl[b] = max(tl[b], 5 + m)
    qb = rng.integers(-4, 5, (B, Lq))
    return q, qb, ql.astype(np.int32), t, tl.astype(np.int32)


def _self_match(residues, L):
    """One pair: a run of L residues cycling through `residues` against
    itself, no bias."""
    s = np.resize(encode_aa(residues), L)[None, :]
    return s, np.zeros((1, L), np.int32), np.array([L], np.int32), s, \
        np.array([L], np.int32)


CASES = {
    "ties": lambda: _tie_batch(12),
    "ties_wide": lambda: _tie_batch(13, B=24, Lq=600, Lt=700),
    # realign scores W:W 10: the run passes 32767 after 3,277 rows
    "self_3400_w": lambda: _self_match(b"W", 3400),
    "self_3600_wc": lambda: _self_match(b"WWC", 3600),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sw_align_batch_matches_sw_jax(case):
    args = CASES[case]()
    ref = jax_sw_align_batch(*args, submat=REALIGN)
    sw_cuda.reset_counts()
    got = sw_cuda.sw_align_batch(*args, submat=REALIGN, device="cpu")
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, np.asarray(r))
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends_nocap"] == 1
    assert sw_cuda.PLAIN_CALLS["sw_pair_starts_nocap"] == 1
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] == 0
    if case.startswith("self"):
        assert int(got[0][0]) > state.SCORE_CAP


def test_cap_selects_the_instance():
    """cap=None is the uncapped instance; the capped entry stops at 32767;
    any other cap is refused."""
    q, qb, ql, t, tl = (torch.from_numpy(a) for a in _self_match(b"W", 3400))
    scoring = state.scoring_from_numpy(REALIGN, 11, 1, "cpu")
    capped = sw_cuda.sw_ends(q, qb, ql, t, tl, scoring=scoring)
    free = sw_cuda.sw_ends(q, qb, ql, t, tl, scoring=scoring, cap=None)
    assert int(capped[0][0]) == state.SCORE_CAP
    assert int(free[0][0]) == 34000 and int(free[1][0]) == 3399
    with pytest.raises(ValueError, match="32767"):
        sw_cuda.sw_ends(q, qb, ql, t, tl, scoring=scoring, cap=1000)


def _fasta(path, seqs):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">s%d\n%s\n" % (i, s))
    return path


def _tie_set(tmp_path):
    """Queries and targets (FASTA) with planted ties: each target holds its
    query's motif two or three times, or the query repeats a motif."""
    rng = np.random.default_rng(20260827)
    aa = np.frombuffer(AA, np.uint8)
    queries, targets = [], []
    for k in range(10):
        motif = aa[rng.integers(0, 20, int(rng.integers(25, 70)))].tobytes()
        bg = [aa[rng.integers(0, 20, int(rng.integers(5, 40)))].tobytes()
              for _ in range(4)]
        if k % 2 == 0:
            queries.append(motif)
            targets.append(bg[0] + motif + bg[1] + motif
                           + (motif if k % 4 == 0 else b"") + bg[2])
        else:
            queries.append(bg[0] + motif + motif + bg[1])
            targets.append(bg[2] + motif + bg[3])
    return (_fasta(tmp_path / "q.faa", queries),
            _fasta(tmp_path / "t.faa", targets))


def _drivers(targets_fasta, **kw):
    port = SearchDriver(Params(aln_len_thr=0, **kw),
                        SeqDB.from_fasta(targets_fasta, DBTYPE_AA),
                        device="cpu")
    jax = JaxDriver(JaxParams(aln_len_thr=0, **kw),
                    JaxSeqDB.from_fasta(targets_fasta, DBTYPE_AA))
    return port, jax


def _seqs(fasta):
    db = SeqDB.from_fasta(fasta, DBTYPE_AA)
    return [db.seq_bytes(i) for i in range(len(db))]


def _assert_same(got, ref):
    """(hits, backtraces, seq ids) equal field by field."""
    assert got[0].dtype == ref[0].dtype
    for f in HIT_DTYPE.names:
        np.testing.assert_array_equal(got[0][f], ref[0][f], err_msg=f)
    assert list(got[1]) == list(ref[1])
    np.testing.assert_array_equal(np.asarray(got[2], np.float32),
                                  np.asarray(ref[2], np.float32))


@pytest.mark.parametrize("inputs", ["fixture", "ties"])
def test_realign_and_backtraces_match_jax_driver(tmp_path, inputs):
    """The port's driver gives the JAX driver's hits; then its backtraces
    and its realign pass (default bias -0.2, and lcaalign's bias 0 with one
    row a query) give the JAX driver's, field by field."""
    assert native.get_lib() is not None
    if inputs == "fixture":
        q, t = DATA / "queries_lin.faa", DATA / "proteins.faa"
    else:
        q, t = _tie_set(tmp_path)
    port, jax = _drivers(t)
    seqs = _seqs(q)
    hits = port.search(seqs)
    ref_hits = jax.search(seqs)
    assert len(hits) > 5
    for f in HIT_DTYPE.names:
        np.testing.assert_array_equal(hits[f], ref_hits[f], err_msg=f)
    bts, sids = port.backtraces(hits, seqs)
    rbts, rsids = jax.backtraces(ref_hits, seqs)
    assert all(bts) and bts == rbts
    np.testing.assert_array_equal(sids, rsids)
    sw_cuda.reset_counts()
    _assert_same(port.realign(hits, seqs), jax.realign(ref_hits, seqs))
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends_nocap"] > 0
    kw = dict(realign_score_bias=0.0, realign_max_seqs=1, realign_cov=0.3)
    _assert_same(port.realign(hits, seqs, **kw),
                 jax.realign(ref_hits, seqs, **kw))


def test_realign_past_the_cap_matches_jax_driver(tmp_path):
    """A hit whose realign score passes 32767 (a 3,400-aa W run against
    itself, no composition bias): the port's realign gives the JAX
    driver's uncapped score ends, starts and backtrace."""
    run = b"W" * 3400
    t = _fasta(tmp_path / "t.faa", [b"MKV" + run + b"GGA", b"ACDEFGHIK"])
    port, jax = _drivers(t, comp_bias_correction=False)
    seqs = [run]
    hits = np.zeros(1, HIT_DTYPE)
    hits["orf_idx"], hits["target_idx"] = 0, 0
    hits["score_raw"], hits["q_len"], hits["t_len"] = 35000, 3400, 3406
    got, ref = port.realign(hits, seqs), jax.realign(hits, seqs)
    _assert_same(got, ref)
    assert (got[0]["q_start"][0], got[0]["q_end"][0]) == (0, 3399)
    assert (got[0]["t_start"][0], got[0]["t_end"][0]) == (3, 3402)
    assert got[1] == ["M" * 3400]


@pytest.mark.parametrize("method", ["backtraces", "realign"])
def test_backtrace_paths_raise_without_the_host_library(monkeypatch,
                                                        tmp_path, method):
    """With no native library, backtraces and realign raise instead of
    writing empty backtraces."""
    q, t = _tie_set(tmp_path)
    port, _ = _drivers(t)
    seqs = _seqs(q)
    hits = port.search(seqs)
    assert len(hits) > 0
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="banded_sw_traceback"):
        getattr(port, method)(hits, seqs)


def test_realign_runs_in_launches_of_the_pair_budget(monkeypatch, tmp_path):
    """realign cuts a bucket into launches of _pairs_per_launch pairs; the
    result does not depend on the cut."""
    q, t = _tie_set(tmp_path)
    port, jax = _drivers(t)
    seqs = _seqs(q)
    hits = port.search(seqs)
    ref = jax.realign(hits, seqs)
    monkeypatch.setattr(SearchDriver, "_pairs_per_launch",
                        lambda self, Lq, Lt: 2)
    sw_cuda.reset_counts()
    _assert_same(port.realign(hits, seqs), ref)
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends_nocap"] >= len(hits) // 2


def test_chip_smoke_search_slice_on_cpu_matches_jax(tmp_path):
    """chip_smoke.py's phase 5e on a cut of the search slice (4 homolog
    targets, 2 decoys; the 3,000 targets whole), on the CPU: the port's
    easy_search and align_db --realign -a give the JAX package's digests,
    as tests/golden/make_search_slice.py takes them, and the routes count
    the realign batches."""
    from metaeuk_tpu.search.align_module import align_db as jax_align_db
    from metaeuk_tpu.search.searchdb import easy_search as jax_easy_search
    cfg = dict(mss.SEARCH_SLICE, homolog_targets=4, decoys=2)
    (tmp_path / "port").mkdir()
    runs, got = chip_smoke.run_search_slice(cfg, tmp_path / "port", "cpu")
    td = tmp_path / "jax"
    td.mkdir()
    q, t = mss.search_slice(cfg, td)
    jax_easy_search(str(q), str(t), str(td / "es.m8"), str(td / "es"))
    jax_align_db(str(td / "es" / "query"), str(td / "es" / "target"),
                 str(td / "es" / "search_tmp" / "pref_0"),
                 str(td / "realign"), add_backtrace=True, realign=True)
    assert got == {"easy_search": {"m8": mss.sha256(td / "es.m8"),
                                   "result": mss.db_sha256(
                                       td / "es" / "result")},
                   "align_realign": mss.db_sha256(td / "realign")}
    realign = runs["align_realign"]["routes"]["realign"]
    assert realign["fwd"][0] == realign["rev"][0] > 5
    assert runs["easy_search"]["routes"]["pair"]["fwd"][0] > 0
    assert set(runs["easy_search"]["stages"]) == {"prefilter", "align",
                                                  "write_blast_tab"}
    assert runs["align_realign"]["phases"]["realign_sw"] > 0
    # the report of phase 5e, on events and counts made up for its input
    ms = {"sw_pair_ends": 2.0, "sw_pair_starts": 1.0,
          "sw_pair_ends_nocap": 0.5, "sw_pair_starts_nocap": 0.25}
    launched = dict.fromkeys(sw_cuda.KERNELS, 0)
    launched.update(dict.fromkeys(ms, 1))
    runs["align_realign"]["probe"] = {
        "events": {k: [(_Event(0.0), _Event(v))] for k, v in ms.items()},
        "launches": launched,
        "plain": dict.fromkeys(sw_cuda.KERNELS, 0)}
    chip_smoke.report_search_run("align_realign", runs["align_realign"])
    launched["sw_pair_ends_nocap"] = 0
    with pytest.raises(AssertionError, match="did not go through"):
        chip_smoke.report_search_run("align_realign", runs["align_realign"])


class _Event:
    """A stand-in for a recorded CUDA event at `at` ms."""

    def __init__(self, at):
        self.at = at

    def elapsed_time(self, other):
        return other.at - self.at


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_uncapped_kernels_match_plain_on_card(cuda_device, case):
    """K1/K2's uncapped instances against their plain versions, on ties
    and across the 512-row stripe hand-off past the cap."""
    args = CASES[case]()
    ref = sw_cuda.sw_align_batch(*args, submat=REALIGN, device="cpu")
    sw_cuda.reset_counts()
    got = sw_cuda.sw_align_batch(*args, submat=REALIGN, device=cuda_device)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    assert sw_cuda.LAUNCHES["sw_pair_ends_nocap"] == 1
    assert sw_cuda.LAUNCHES["sw_pair_starts_nocap"] == 1
    assert sum(sw_cuda.PLAIN_CALLS.values()) == 0
