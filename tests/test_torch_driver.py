"""The port's SearchDriver (device "cpu") against metaeuk_tpu's on the same
fragments, targets and candidate pairs: hit arrays identical field by
field (integers and the float fields computed from them on the host, so
the tolerance is exact equality)."""

import pathlib

import numpy as np
import pytest

import metaeuk_tpu.search.driver as jax_driver
import metaeuk_tpu_torch.search.driver as torch_driver
from metaeuk_tpu.data.submat import composition_bias_rounded_batch, encode_aa
from metaeuk_tpu.io.seqdb import DBTYPE_AA, DBTYPE_NUCL, SeqDB
from metaeuk_tpu.ops.orf import OrfExtractor
from metaeuk_tpu.params import Params
from metaeuk_tpu_torch import state

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DATA = pathlib.Path(__file__).parent / "data"


class _TargetDB:
    def __init__(self, seqs):
        self.seqs = seqs

    def __len__(self):
        return len(self.seqs)

    def seq_bytes(self, i):
        return self.seqs[i]

    def total_residues(self):
        return sum(len(s) for s in self.seqs)


def _fixture_fragments():
    contigs = SeqDB.from_fasta(DATA / "contigs.fna", DBTYPE_NUCL)
    ex = OrfExtractor(Params())
    frags = []
    for ci in range(len(contigs)):
        _, f = ex.extract_contig(contigs.seq_bytes(ci), ci)
        frags.extend(ex.translate_fragments(f))
    return frags


def _synthetic(seed=5):
    """Fragments and targets across several length tiers (up to 4096),
    some sharing segments so real hits exist."""
    aas = b"ACDEFGHIKLMNPQRSTVWY"
    r = np.random.default_rng(seed)
    seq = lambda n: bytes(aas[c] for c in r.integers(0, 20, int(n)))
    targets = [seq(n) for n in r.integers(20, 700, 20)] + [seq(1000)]
    orfs = [seq(n) for n in r.integers(20, 400, 8)] + [seq(1100)]
    orfs[0] = targets[3][:40] + orfs[0][:20]
    orfs[4] = targets[10][5:60]
    orfs[-1] = orfs[-1][:500] + targets[-1][200:600]
    orfs.append(b"")
    return orfs, targets


def _assert_same_hits(ref, got):
    assert len(ref) > 0
    assert ref.dtype == got.dtype
    assert len(ref) == len(got)
    for name in ref.dtype.names:
        np.testing.assert_array_equal(ref[name], got[name], name)


@pytest.fixture(scope="module")
def fixture_inputs():
    targets = SeqDB.from_fasta(DATA / "proteins.faa", DBTYPE_AA)
    return _fixture_fragments(), targets


@pytest.mark.parametrize("pairs", ["exhaustive", "subset"])
def test_driver_hits_match_jax_on_fixture(fixture_inputs, pairs):
    frags, targets = fixture_inputs
    p = Params()
    p.search_evalue_thr = 1e5      # keep many hits through the gate
    gen = None
    if pairs == "subset":
        rng = np.random.default_rng(1)
        n = len(frags) * len(targets)
        sel = rng.choice(n, n // 3, replace=False)
        gen = np.stack([sel // len(targets), sel % len(targets)], 1)
    ref = jax_driver.SearchDriver(p, targets).search(frags, gen)
    got = torch_driver.SearchDriver(p, targets, "cpu").search(frags, gen)
    _assert_same_hits(ref, got)


@pytest.fixture(scope="module")
def synthetic_ref():
    """_synthetic()'s fragments and targets, and the JAX driver's hits on
    every pair (E-value threshold 1e5)."""
    orfs, targets = _synthetic()
    p = Params()
    p.search_evalue_thr = 1e5
    return orfs, targets, jax_driver.SearchDriver(
        p, _TargetDB(targets)).search(orfs)


def test_driver_hits_match_jax_across_tiers(synthetic_ref):
    orfs, targets, ref = synthetic_ref
    p = Params()
    p.search_evalue_thr = 1e5
    drv = torch_driver.SearchDriver(p, _TargetDB(targets), "cpu")
    got = drv.search(orfs)
    _assert_same_hits(ref, got)
    assert {"fwd_submit", "gate", "rev_submit"} <= set(drv.phase_seconds)


def test_driver_fine_tiers_match_jax(fixture_inputs, monkeypatch):
    frags, targets = fixture_inputs
    p = Params()
    p.search_evalue_thr = 1e5
    ref = jax_driver.SearchDriver(p, targets).search(frags)
    monkeypatch.setattr(torch_driver, "FINE_TIER_MIN_FRAGS", 1)
    drv = torch_driver.SearchDriver(p, targets, "cpu")
    got = drv.search(frags)
    assert drv._fine
    _assert_same_hits(ref, got)


def test_drivers_share_staged_tiers(fixture_inputs):
    """Both drivers fed the same numpy staging (the port through
    state.stage_from_numpy, the JAX driver through its own caches) give the
    same hits."""
    import jax.numpy as jnp
    orfs, target_db = fixture_inputs
    targets = [target_db.seq_bytes(i) for i in range(len(target_db))]
    p = Params()
    p.search_evalue_thr = 1e5
    enc = [encode_aa(s) for s in orfs]
    lens = np.array([len(e) for e in enc], np.int64)
    biases = composition_bias_rounded_batch(enc)
    fine = False
    q_np = torch_driver.query_tiers_np(enc, lens, biases, fine)
    t_enc = [encode_aa(s) for s in targets]
    t_lens = np.array([len(e) for e in t_enc], np.int64)
    lts = np.unique(torch_driver._bucket_arr(t_lens, fine))
    t_np = {int(Lt): torch_driver.target_tier_np(t_enc, t_lens, Lt, fine)
            for Lt in lts}

    jd = jax_driver.SearchDriver(p, _TargetDB(targets))
    jd._fine = fine
    jd._q_cache = (orfs, enc, lens, {
        Lq: dict(q_mat=jnp.asarray(t["q_mat"]),
                 qb_mat=jnp.asarray(t["qb_mat"]),
                 q_lens_dev=jnp.asarray(t["q_lens"]),
                 q_remap=t["q_remap"], nq=t["nq"])
        for Lq, t in q_np.items()})
    for Lt, t in t_np.items():
        jd._t_stage[(Lt, fine)] = dict(t_mat=jnp.asarray(t["t_mat"]),
                                       t_lens_dev=jnp.asarray(t["t_lens"]),
                                       t_remap=t["t_remap"])
    td = torch_driver.SearchDriver(p, _TargetDB(targets), "cpu")
    td._fine = fine
    td._q_cache = (orfs, enc, lens,
                   {Lq: state.stage_from_numpy(t, "cpu")
                    for Lq, t in q_np.items()})
    for Lt, t in t_np.items():
        td._t_stage[(Lt, fine)] = state.stage_from_numpy(t, "cpu")
    staged = td._q_cache[3][min(q_np)]
    assert staged["q_mat"].dtype == state.TIER_DTYPES["q_mat"]
    _assert_same_hits(jd.search(orfs), td.search(orfs))


def test_cells_count_true_lengths(fixture_inputs):
    orfs, target_db = fixture_inputs
    p = Params()
    before = dict(torch_driver.CELLS)
    torch_driver.SearchDriver(p, target_db, "cpu").search(orfs)
    q = np.array([len(o) for o in orfs])
    t = np.array([len(target_db.seq_bytes(i))
                  for i in range(len(target_db))])
    assert torch_driver.CELLS["fwd"] - before["fwd"] == int(
        (q[:, None] * t[None, :]).sum())
    assert torch_driver.CELLS["rev"] > before["rev"]


def test_driver_hits_do_not_depend_on_launch_size(synthetic_ref,
                                                  monkeypatch):
    """Pair launches cut to 8-16 pairs (CELL_BUDGET and MAX_PAIRS_PER_LAUNCH
    monkeypatched: 16 on the short tiers, the driver's floor of 8 from Lq
    256 x Lt 1024), so every bucket of more than 16 pairs takes several
    launches of each pair kernel: the hits equal the JAX driver's."""
    from metaeuk_tpu_torch.ops import sw_cuda
    orfs, targets, ref = synthetic_ref
    p = Params()
    p.search_evalue_thr = 1e5
    monkeypatch.setitem(torch_driver.CELL_BUDGET, "cpu", 1 << 20)
    monkeypatch.setattr(torch_driver, "MAX_PAIRS_PER_LAUNCH", 16)
    drv = torch_driver.SearchDriver(p, _TargetDB(targets), "cpu")
    assert drv._pairs_per_launch(64, 256) == 16
    assert drv._pairs_per_launch(256, 1024) == 8
    sw_cuda.reset_counts()
    got = drv.search(orfs)
    n_pairs = sum(len(o) > 0 for o in orfs) * len(targets)
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] >= n_pairs // 16
    assert sw_cuda.PLAIN_CALLS["sw_pair_starts"] > 1
    _assert_same_hits(ref, got)
