"""The port's multi-process and multi-GPU layers on the CPU, held to the JAX
package (metaeuk_tpu/parallel, its driver and CLI) and to the goldens:

- contig_partition's bounds (tests/test_dist.py's cases) and the fixture's
  2-partition run merged, byte-equal to tests/golden/easypredict.*;
- the port's worker (metaeuk_tpu_torch/tools/dist_worker.py) in two and
  three processes under gloo: byte-equal to the goldens, and with --split 2
  to the port's and the JAX package's single-process split-2 runs, each
  process building its round-robin split (an empty contig partition in
  the three-process run);
- DistributedSplitKmerPrefilter at one process, list for list equal to the
  JAX package's and to SplitKmerPrefilter;
- a 4-process gloo 2 x 2 mesh (tools/dryrun.py --mesh-rank): the dense and
  top-k sharded steps equal metaeuk_tpu.parallel.dist's on a 2 x 2 mesh of
  the conftest's CPU devices, on inputs with planted ties across and within
  target shards and a fragment with no hit; collective_report() equal;
- K1's uncapped plain version against sw_jax.sw_batch_ends on no-hit and
  padded pairs;
- SearchDriver fanned over ["cpu", "cpu"]: the hit array equal to the one-
  device array and to the JAX driver's, field for field; easy-predict
  fanned, equal to the goldens;
- --contig-split and mergepredictions through the port's CLI, equal to the
  JAX CLI's bytes.

Every subprocess runs under communicate(timeout=...) and is killed on
expiry; every process group waits at most 120 s for a peer; every port
comes from binding port 0. The tolerance is exact equality.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from metaeuk_tpu import cli as jax_cli
from metaeuk_tpu.ops import sw_jax
from metaeuk_tpu.parallel import dist as jax_dist
from metaeuk_tpu.parallel import multihost as jax_multihost
from metaeuk_tpu.parallel.dist_prefilter import \
    DistributedSplitKmerPrefilter as JaxDistributedSplit
from metaeuk_tpu.params import Params as JaxParams
from metaeuk_tpu.pipeline.predict import EasyPredict as JaxEasyPredict
from metaeuk_tpu.search import driver as jax_driver
from metaeuk_tpu_torch import cli
from metaeuk_tpu_torch.ops import sw_cuda
from metaeuk_tpu_torch.parallel import dist, multihost
from metaeuk_tpu_torch.parallel.dist_prefilter import \
    DistributedSplitKmerPrefilter
from metaeuk_tpu_torch.params import Params
from metaeuk_tpu_torch.pipeline.predict import EasyPredict
from metaeuk_tpu_torch.search import driver as torch_driver
from metaeuk_tpu_torch.search.prefilter_kmer import SplitKmerPrefilter
from metaeuk_tpu_torch.tools import dist_worker, dryrun

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
GOLDEN = ROOT / "tests" / "golden"
SUFFIXES = ("fas", "codon.fas", "headersMap.tsv", "gff")
# seconds a test waits for its subprocesses
PROC_TIMEOUT = 300


def _outputs(prefix):
    return {s: pathlib.Path(f"{prefix}.{s}").read_bytes() for s in SUFFIXES}


def _goldens():
    return _outputs(GOLDEN / "easypredict")


def _run_all(argvs, env=None):
    """Starts every argv at once; (exit code, stdout, stderr) of each, all
    killed if any outlives PROC_TIMEOUT."""
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    procs = [subprocess.Popen(a, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for a in argvs]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=PROC_TIMEOUT)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _workers(n, out, split=None):
    port = dryrun.free_port()
    return _run_all([[sys.executable, dist_worker.__file__, str(i), str(n),
                      f"127.0.0.1:{port}", str(DATA / "contigs.fna"),
                      str(DATA / "proteins.faa"), str(out),
                      *([str(split)] if split else []), "--device", "cpu"]
                     for i in range(n)])


@pytest.mark.parametrize("n, parts", [
    (10, [(0, 4), (4, 7), (7, 10)]), (2, [(0, 1), (1, 2), (2, 2), (2, 2)]),
    (2, [(0, 1), (1, 2)]), (0, [(0, 0), (0, 0)])])
def test_contig_partition_bounds(n, parts):
    got = [multihost.contig_partition(n, i, len(parts))
           for i in range(len(parts))]
    assert got == parts == [jax_multihost.contig_partition(n, i, len(parts))
                            for i in range(len(parts))]


def test_no_process_group_is_one_process():
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    multihost.barrier("nothing to wait for")


def test_two_partitions_merged_equal_the_goldens(tmp_path):
    for i in range(2):
        EasyPredict(Params(), device="cpu").run(
            DATA / "contigs.fna", DATA / "proteins.faa",
            str(tmp_path / f"part{i}"),
            contig_range=multihost.contig_partition(2, i, 2))
    multihost.merge_predictions(str(tmp_path / "merged"),
                                [str(tmp_path / f"part{i}")
                                 for i in range(2)])
    assert _outputs(tmp_path / "merged") == _goldens()


def test_distributed_easy_predict_in_one_process(tmp_path):
    """No process group: the whole contig range, no partition files."""
    out = tmp_path / "preds"
    multihost.distributed_easy_predict(Params(), DATA / "contigs.fna",
                                       DATA / "proteins.faa", str(out),
                                       device="cpu")
    assert _outputs(out) == _goldens()
    assert not list(tmp_path.glob("*.part*"))


def test_contig_range_checkpoints_are_partition_qualified(tmp_path):
    ep = EasyPredict(Params(), device="cpu")
    ep.run(DATA / "contigs.fna", DATA / "proteins.faa",
           str(tmp_path / "p1"), tmp_dir=str(tmp_path / "tmp"),
           contig_range=(1, 2))
    assert (tmp_path / "tmp" / "dp_predictions_1_2.dbtype").exists()
    assert not (tmp_path / "tmp" / "dp_predictions.dbtype").exists()
    # a re-run resumes from the partition's checkpoint, same bytes
    ep.run(DATA / "contigs.fna", DATA / "proteins.faa",
           str(tmp_path / "p1b"), tmp_dir=str(tmp_path / "tmp"),
           contig_range=(1, 2))
    assert _outputs(tmp_path / "p1b") == _outputs(tmp_path / "p1")
    whole = _goldens()
    part = _outputs(tmp_path / "p1")
    assert all(whole[s].endswith(part[s]) for s in SUFFIXES)


def test_two_process_workers_equal_the_goldens(tmp_path):
    out = tmp_path / "preds"
    res = _workers(2, out)
    for rc, o, e in res:
        assert rc == 0, e[-3000:]
    assert _outputs(out) == _goldens()
    lines = [json.loads(o.strip().splitlines()[-1]) for _, o, _ in res]
    assert [ln["rank"] for ln in lines] == [0, 1]
    for ln in lines:
        assert ln["plain_calls"]["sw_pair_ends"] > 0
        assert "predictexons" in ln["stage_seconds"]


@pytest.fixture(scope="module")
def split2_single(tmp_path_factory):
    """The port's and the JAX package's single-process split-2 outputs."""
    d = tmp_path_factory.mktemp("split2")
    EasyPredict(Params(split=2), device="cpu").run(
        DATA / "contigs.fna", DATA / "proteins.faa", str(d / "port"))
    JaxEasyPredict(JaxParams(split=2)).run(
        DATA / "contigs.fna", DATA / "proteins.faa", str(d / "jax"))
    return _outputs(d / "port"), _outputs(d / "jax")


@pytest.mark.parametrize("n", [2, 3])
def test_split2_workers_equal_single_process_runs(tmp_path, split2_single,
                                                  n):
    """--split 2 over n processes: the splits fanned round-robin (process
    si % n builds split si), the shared scratch holding each (split, query
    block) hit file; with 3 processes the last contig partition is empty
    and its process takes part in every phase."""
    out = tmp_path / "preds"
    res = _workers(n, out, split=2)
    for rc, o, e in res:
        assert rc == 0, e[-3000:]
    logs = [e for _, _, e in res]
    assert "split 1/2 on process 0" in logs[0]
    assert "split 2/2 on process 1" in logs[1]
    assert "split 2/2 on process 0" not in logs[0]
    assert all("prefilter split" not in lg for lg in logs[2:])
    dist_dir = pathlib.Path(f"{out}.dist_pref")
    for si in range(2):
        for qp in range(n):
            assert (dist_dir / f"hits_{si}_{qp}.npz").exists()
    port, jax = split2_single
    assert _outputs(out) == port == jax
    if n == 3:
        assert all(not pathlib.Path(f"{out}.part2.{s}").read_bytes()
                   for s in SUFFIXES)


def test_dist_prefilter_one_process_equals_jax_and_sequential(tmp_path):
    r = np.random.default_rng(11)
    targets = [r.integers(0, 20, int(r.integers(40, 120))).astype(np.uint8)
               for _ in range(40)]
    queries = [t.copy() for t in targets[:12]]
    ident = np.arange(12, dtype=np.int64)
    seq = SplitKmerPrefilter(targets, n_splits=3)
    base = seq.match_batch(queries, identity_ids=ident)
    port = DistributedSplitKmerPrefilter(targets, str(tmp_path / "p"), 3)
    got = port.match_batch(queries, identity_ids=ident)
    ref = JaxDistributedSplit(targets, str(tmp_path / "j"), 3).match_batch(
        queries, identity_ids=ident)
    assert len(base) == len(got) == len(ref) == 12
    for qi, (b, g, j) in enumerate(zip(base, got, ref)):
        for k in range(3):
            np.testing.assert_array_equal(b[k], g[k], err_msg=f"q{qi}")
            np.testing.assert_array_equal(j[k], g[k], err_msg=f"q{qi}")
            assert g[k].dtype == j[k].dtype
    assert [list(g[0]) for g in got] == [[qi] for qi in range(12)]
    np.testing.assert_array_equal(seq.stats, port.stats)
    # an empty query block merges to no lists
    assert DistributedSplitKmerPrefilter(
        targets, str(tmp_path / "e"), 3).match_batch([]) == []


# the mesh runs' inputs: 4 fragments x 16 targets of up to 32 aa, targets
# 8-11 (the second shard) copies of 0-3 and target 5 of 4 (ties across and
# within shards), fragment 3 empty (no hit), ragged target lengths
MESH = dict(Bq=4, Nt=16, Lq=32, Lt=32, k=5, seed=3)


def _mesh_inputs():
    x = dryrun.mesh_inputs(MESH["Bq"], MESH["Nt"], MESH["Lq"], MESH["Lt"],
                           MESH["seed"])
    x["t_len"][::3] = 20
    x["t_enc"][8:12], x["t_len"][8:12] = x["t_enc"][0:4], x["t_len"][0:4]
    x["t_enc"][5], x["t_len"][5] = x["t_enc"][4], x["t_len"][4]
    x["q_enc"][2, 10:20] = x["t_enc"][4, 3:13]
    x["q_len"][3] = 0
    return x


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """(inputs, {rank: its npz}) of a 4-process gloo 2 x 2 mesh run, and
    the JAX package's dense and top-k outputs with its collective report
    on a 2 x 2 mesh of 4 CPU devices."""
    import jax
    d = tmp_path_factory.mktemp("mesh")
    x = _mesh_inputs()
    np.savez(d / "in.npz", **x)
    port = dryrun.free_port()
    res = _run_all([[sys.executable, "-m", "metaeuk_tpu_torch.tools.dryrun",
                     "--mesh-rank", str(r), "--world", "4", "--coord",
                     f"127.0.0.1:{port}", "--frags", "2", "--targets", "2",
                     "--inputs", str(d / "in.npz"), "--out", str(d),
                     "--k", str(MESH["k"])] for r in range(4)])
    for rc, _, e in res:
        assert rc == 0, e[-3000:]
    ranks = {r: np.load(d / f"rank{r}.npz") for r in range(4)}
    mesh = jax_dist.make_mesh(devices=jax.devices()[:4], frags=2, targets=2)
    args = [x[n] for n in ("q_enc", "q_bias", "q_len", "t_enc", "t_len")]
    jax_dist.collective_report(reset=True)
    dense = jax_dist.sharded_search_step(mesh, MESH["Lq"], MESH["Lt"])(*args)
    topk = jax_dist.sharded_search_topk_step(mesh, MESH["Lq"], MESH["Lt"],
                                             MESH["k"])(*args)
    names = ("score", "q_end", "t_end", "tk_score", "tk_q_end", "tk_t_end",
             "tk_gid")
    ref = {n: np.asarray(a) for n, a in zip(names, (*dense, *topk))}
    return x, ranks, ref, jax_dist.collective_report(reset=True)


@pytest.mark.parametrize("name", ["score", "q_end", "t_end", "tk_score",
                                  "tk_q_end", "tk_t_end", "tk_gid"])
def test_mesh_steps_equal_jax(mesh_runs, name):
    """Each rank's rows of the 2 x 2 gloo mesh's dense and top-k steps equal
    the JAX steps' rows of its fragment block; the two ranks of a fragment
    block (the two target shards) agree."""
    x, ranks, ref, _ = mesh_runs
    for r, z in ranks.items():
        lo = int(z["rows"][0])
        assert lo == (r // 2) * 2
        np.testing.assert_array_equal(z[name], ref[name][lo:lo + 2],
                                      err_msg=f"rank {r}")


def test_mesh_topk_pins_the_tie_order(mesh_runs):
    """The planted ties: a fragment's equal scores come in global target
    order, across the shards (target 0 before its copy 8) and within one
    (4 before 5), as jax.lax.top_k orders them; the no-hit fragment keeps
    score 0, q_end Lq - 1, t_end -1 on every target."""
    x, ranks, ref, _ = mesh_runs
    sc = np.concatenate([ranks[0]["score"], ranks[2]["score"]])
    gid = np.concatenate([ranks[0]["tk_gid"], ranks[2]["tk_gid"]])
    tsc = np.concatenate([ranks[0]["tk_score"], ranks[2]["tk_score"]])
    ties = 0
    for i in range(MESH["Bq"]):
        for a in range(MESH["k"]):
            for b in range(a + 1, MESH["k"]):
                if tsc[i, a] == tsc[i, b]:
                    assert gid[i, a] < gid[i, b]
                    ties += 1
    assert ties > 0
    assert (sc[:, 0] == sc[:, 8]).all() and (sc[:, 4] == sc[:, 5]).all()
    assert (sc[2, 4] > 20) and list(gid[2, :2]) == [4, 5]
    q_end = np.concatenate([ranks[0]["q_end"], ranks[2]["q_end"]])
    t_end = np.concatenate([ranks[0]["t_end"], ranks[2]["t_end"]])
    assert (sc[3] == 0).all() and (q_end[3] == MESH["Lq"] - 1).all() \
        and (t_end[3] == -1).all()


def test_mesh_collective_report_equals_jax(mesh_runs):
    _, ranks, _, jax_report = mesh_runs
    assert set(jax_report) == {"targets"}
    for z in ranks.values():
        assert int(z["collective"][0]) == jax_report["targets"] > 0


def test_mesh_needs_a_group_and_a_matching_shape():
    with pytest.raises(RuntimeError, match="process group"):
        dist.make_mesh("cpu")


def test_one_rank_mesh_steps_equal_the_plain_cross_product():
    """The dry run's kernel steps on a one-rank gloo group (1 x 1 mesh)."""
    with dryrun.one_rank_group("cpu"):
        dryrun.check_kernel_steps("cpu")
        dist.collective_report(reset=True)
        mesh = dist.make_mesh("cpu")
        x = _mesh_inputs()
        got = dryrun.run_steps(mesh, x, 300)
        # 300 > 16 targets: the top-k keeps every target
        want = dryrun.expected_rows(x, 300, slice(0, MESH["Bq"]),
                                    dryrun.plain_cross(x, "cpu"))
        for n, a in want.items():
            np.testing.assert_array_equal(got[n], a, err_msg=n)
        assert got["tk_gid"].shape == (MESH["Bq"], MESH["Nt"])
        assert dist.collective_report() == {"targets": 0}


def test_uncapped_ends_keep_sw_batch_ends_no_hit_conventions():
    """sw_ends(cap=None) (K1's uncapped plain version) against
    sw_jax.sw_batch_ends on pairs with no positive cell, empty fragments or
    targets, and codes past the lengths in padded rows and columns."""
    rng = np.random.default_rng(7)
    B, Lq, Lt = 12, 24, 40
    q = rng.integers(0, 20, (B, Lq)).astype(np.int32)
    t = rng.integers(0, 20, (B, Lt)).astype(np.int32)
    qb = rng.integers(-2, 3, (B, Lq)).astype(np.int32)
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    tl = rng.integers(1, Lt + 1, B).astype(np.int32)
    W, P = b"ACDEFGHIKLMNPQRSTVWY".index(b"W"), \
        b"ACDEFGHIKLMNPQRSTVWY".index(b"P")
    q[0], t[0], qb[0] = W, P, 0      # W x P scores -4: no positive cell
    ql[1] = 0                        # an empty fragment
    tl[2] = 0                        # an empty target
    ql[3], tl[3] = 0, 0
    q[4, 5:] = t[4, :Lq - 5]         # a shared run past q_len: padding
    ql[4] = 5
    import torch
    got = sw_cuda.sw_ends(*(torch.from_numpy(a) for a in (q, qb, ql, t, tl)),
                          cap=None)
    ref = sw_jax.sw_batch_ends(q, qb, ql, t, Lq, Lt, t_len=tl)
    for g, r, name in zip(got, ref, ("score", "q_end", "t_end")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), name)
    assert [int(a[0]) for a in got] == [0, Lq - 1, -1]
    for i in (1, 2, 3):
        assert (int(got[0][i]), int(got[1][i]), int(got[2][i])) == \
            (0, Lq - 1, -1)


class _TargetDB:
    def __init__(self, seqs):
        self.seqs = seqs

    def __len__(self):
        return len(self.seqs)

    def seq_bytes(self, i):
        return self.seqs[i]

    def total_residues(self):
        return sum(len(s) for s in self.seqs)


def _synthetic():
    """Fragments and targets over several length tiers, some sharing
    segments so real hits exist (tests/test_torch_qm.py's, widened)."""
    aas = b"ACDEFGHIKLMNPQRSTVWY"
    r = np.random.default_rng(5)
    seq = lambda n: bytes(aas[c] for c in r.integers(0, 20, int(n)))  # noqa
    targets = [seq(n) for n in r.integers(20, 300, 37)]
    orfs = [seq(n) for n in r.integers(20, 200, 9)]
    orfs[0] = targets[3][:40] + orfs[0][:20]
    orfs[4] = targets[10][5:60]
    orfs[7] = targets[20][:150]
    return orfs, targets


def _assert_same_hits(ref, got):
    assert len(ref) > 0 and len(ref) == len(got)
    for name in ref.dtype.names:
        np.testing.assert_array_equal(ref[name], got[name], name)


@pytest.mark.parametrize("qm", ["off", "mixed"])
def test_driver_fanned_over_two_devices(monkeypatch, qm):
    """SearchDriver over ["cpu", "cpu"] with launches cut to a few pairs
    (qm "mixed": METAEUK_QM=force with QM_MIN_CANDS 10, so the dense queries
    take the query-major tiles and the others the pair kernels, both split
    over the two entries): each chunk is launched as two sub-chunks, and the
    hit array equals the one-device driver's and the JAX driver's, field
    for field."""
    orfs, targets = _synthetic()
    p = Params()
    p.search_evalue_thr = 1e5
    old = os.environ.pop("METAEUK_QM", None)
    os.environ["METAEUK_QM"] = "off"
    try:
        ref = jax_driver.SearchDriver(p, _TargetDB(targets)).search(orfs)
    finally:
        os.environ.pop("METAEUK_QM")
        if old is not None:
            os.environ["METAEUK_QM"] = old
    if qm == "mixed":
        monkeypatch.setenv("METAEUK_QM", "force")
        monkeypatch.setattr(torch_driver, "QM_MIN_CANDS", 10)
        monkeypatch.setitem(torch_driver.QM_CELL_BUDGET, "cpu", 1)
    else:
        monkeypatch.setenv("METAEUK_QM", "off")
    monkeypatch.setitem(torch_driver.CELL_BUDGET, "cpu", 1 << 16)
    one = torch_driver.SearchDriver(p, _TargetDB(targets), "cpu")
    sw_cuda.reset_counts()
    hits_one = one.search(orfs)
    calls_one = dict(sw_cuda.PLAIN_CALLS)
    two = torch_driver.SearchDriver(p, _TargetDB(targets), "cpu",
                                    devices=["cpu", "cpu"])
    assert two.devices == [torch_driver.torch.device("cpu")] * 2
    sw_cuda.reset_counts()
    hits_two = two.search(orfs)
    calls_two = dict(sw_cuda.PLAIN_CALLS)
    _assert_same_hits(ref, hits_one)
    _assert_same_hits(hits_one, hits_two)
    kernels = ["sw_pair_ends", "sw_pair_starts"] + (
        ["sw_qm_ends", "sw_qm_starts"] if qm == "mixed" else [])
    for k in kernels:
        assert calls_one[k] > 1 and calls_two[k] > calls_one[k], k


def test_device_list_defaults(monkeypatch):
    dl = torch_driver.device_list
    assert dl("cpu") == [torch_driver.torch.device("cpu")]
    assert dl("cuda", ["cuda:0", "cuda:0"]) == \
        [torch_driver.torch.device("cuda", 0)] * 2
    monkeypatch.setattr(torch_driver.torch.cuda, "device_count", lambda: 4)
    assert torch_driver.n_devices() == 4
    assert dl("cuda") == [torch_driver.torch.device("cuda", i)
                          for i in range(4)]
    assert dl("cuda:2") == [torch_driver.torch.device("cuda", 2)]
    monkeypatch.setenv("METAEUK_DEVICES", "2")
    assert torch_driver.n_devices() == 2 and len(dl("cuda")) == 2
    with pytest.raises(ValueError):
        dl("cpu", [])


def test_fanned_easy_predict_equals_the_goldens(tmp_path):
    """easy-predict with the driver over ["cpu", "cpu"] (the dry run's
    fixture check), and on a contig partition."""
    dryrun.check_fixture("cpu", ["cpu", "cpu"])
    ep = EasyPredict(Params(), device="cpu", devices=["cpu", "cpu"])
    ep.run(DATA / "contigs.fna", DATA / "proteins.faa", str(tmp_path / "a"),
           contig_range=(0, 1))
    EasyPredict(Params(), device="cpu").run(
        DATA / "contigs.fna", DATA / "proteins.faa", str(tmp_path / "b"),
        contig_range=(0, 1))
    assert _outputs(tmp_path / "a") == _outputs(tmp_path / "b")


def test_contig_split_and_mergepredictions_equal_the_jax_cli(tmp_path):
    """easy-predict --contig-split I:2 then mergepredictions through both
    CLIs: the partitions and the merged files byte-equal, and the merge
    equal to the goldens; a contig DB input counts its contigs from
    .index."""
    c, t = str(DATA / "contigs.fna"), str(DATA / "proteins.faa")
    for tag, main, dev in (("jax", jax_cli.main, []),
                           ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        for i in range(2):
            assert main(["easy-predict", c, t, str(d / f"part{i}"),
                         "--contig-split", f"{i}:2", *dev]) == 0
        assert main(["mergepredictions", str(d / "merged"),
                     str(d / "part0"), str(d / "part1")]) == 0
    for name in ("part0", "part1", "merged"):
        assert _outputs(tmp_path / "port" / name) == \
            _outputs(tmp_path / "jax" / name), name
    assert _outputs(tmp_path / "port" / "merged") == _goldens()
    db = tmp_path / "cdb"
    assert cli.main(["createdb", c, str(db)]) == 0
    assert cli.main(["easy-predict", str(db), t, str(tmp_path / "dbp1"),
                     "--contig-split", "1:2", "--device", "cpu"]) == 0
    assert _outputs(tmp_path / "dbp1") == _outputs(tmp_path / "port" /
                                                   "part1")


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_dist_slice_on_cpu(tmp_path, split2_single):
    """chip_smoke.py's phase 5l (check_dist_slice, report_dist_slice) on the
    fixture at --split 2 on the CPU: the one- and two-process runs' digests
    equal each other and the JAX package's single-process split-2 run,
    each process built its split, every hit file is in the scratch."""
    import hashlib
    cs = _chip_smoke()
    want = {s: hashlib.sha256(b).hexdigest()
            for s, b in split2_single[1].items()}
    runs = cs.check_dist_slice(DATA / "contigs.fna", DATA / "proteins.faa",
                               tmp_path, 2, "cpu", want)
    cs.report_dist_slice(runs)
    assert [len(r["procs"]) for r in runs.values()] == [1, 2]
    assert runs["two"]["logs"][0] and runs["two"]["logs"][1]
    for run in runs.values():
        for rec in run["procs"]:
            assert rec["cells"]["fwd"] > 0 and not rec["kernels"]


def test_chip_smoke_mesh_steps_on_cpu():
    """chip_smoke.py's phase 5m (b) (check_mesh_steps) on a one-rank gloo
    mesh at a small shape: every output equal to the plain cross product,
    the plain version of K1's uncapped instance called once a step."""
    import torch
    cs = _chip_smoke()
    launches, plain, _, report = cs.check_mesh_steps(
        np, torch, sw_cuda, "cpu",
        dict(Bq=8, Nt=16, Lq=16, Lt=24, k=5, seed=4))
    assert plain["sw_pair_ends_nocap"] == 2 and not any(launches.values())
    assert report == {"targets": 0}


def test_dry_run_entry_point_on_cpu(capsys):
    """python -m metaeuk_tpu_torch.tools.dryrun --device cpu --skip-slice:
    the one-rank mesh steps, the fanned prefilter and the fixture over
    ["cpu", "cpu"] (the slice is the card's)."""
    assert dryrun.main(["--device", "cpu", "--skip-slice"]) == 0
    out = capsys.readouterr().out
    assert "1 x 1 cpu mesh" in out and out.rstrip().endswith("[dryrun] ok")
