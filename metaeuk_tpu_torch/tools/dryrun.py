"""Multi-process and multi-GPU dry run of the port (the twin of the JAX
package's dryrun_multichip in __graft_entry__.py):

  1. the sharded search steps on a mesh of the process group's ranks
     (parallel/dist.py), dense and top-k, held to the plain dense cross
     product (K1's uncapped plain version) on the same device;
  2. the fanned target-split prefilter at one process
     (parallel/dist_prefilter.py) against SplitKmerPrefilter;
  3. the 1.6 Mbp / 3000-target slice of tests/golden/multichip_slice.json
     through easy-predict with the driver's launches fanned over a device
     list, its digests against the file's; then the sharded steps at slice
     scale (512 x 1024 pairs at 64 x 64, top-k 300) and the collective
     bytes per mesh axis;
  4. easy-predict on tests/data with the same fan-out against
     tests/golden/easypredict.*.

    python -m metaeuk_tpu_torch.tools.dryrun [--device cuda|cpu]
        [--devices cuda:0,cuda:0] [--skip-slice]

Run from a checkout (it reads tests/ and runs tools/make_metagenome.py).
Without a process group it makes a one-rank group (NCCL on the card, gloo
on the CPU) on a free localhost port. --device cpu runs the plain versions.

One rank of a mesh run, as the tests start four of them on the CPU:

    python -m metaeuk_tpu_torch.tools.dryrun --mesh-rank R --world N
        --coord 127.0.0.1:PORT --frags F --targets T --inputs in.npz
        --out DIR [--k K]

writes its rows of both steps and collective_report() to DIR/rankR.npz.
"""

import argparse
import contextlib
import datetime
import hashlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
SUFFIXES = ("fas", "codon.fas", "headersMap.tsv", "gff")
# seconds a process-group rendezvous or collective may wait for its peers
GROUP_TIMEOUT = 120
# the slice-scale sharded steps (__graft_entry__.py _dryrun_bench_slice)
SLICE_STEP = dict(Bq=512, Nt=1024, Lq=64, Lt=64, k=300, seed=11)


def free_port():
    """A localhost port that was free a moment ago (bound to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_group(backend, coord, world, rank):
    """init_process_group over tcp://coord, with GROUP_TIMEOUT."""
    import torch.distributed as tdist
    tdist.init_process_group(
        backend=backend, init_method=f"tcp://{coord}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))


@contextlib.contextmanager
def one_rank_group(device):
    """A one-rank process group (NCCL for a CUDA device, else gloo) unless
    one exists; destroyed at exit if made here."""
    import torch.distributed as tdist
    made = not tdist.is_initialized()
    if made:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        if backend == "nccl":
            # one rank needs no network: NCCL's bootstrap on the loopback
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        init_group(backend, f"127.0.0.1:{free_port()}", 1, 0)
    try:
        yield
    finally:
        if made:
            tdist.destroy_process_group()


def mesh_inputs(Bq, Nt, Lq, Lt, seed):
    """Seeded step inputs as __graft_entry__.py makes them: int32 codes
    0..19 at full length, zero biases."""
    rng = np.random.default_rng(seed)
    return dict(q_enc=rng.integers(0, 20, (Bq, Lq)).astype(np.int32),
                q_bias=np.zeros((Bq, Lq), np.int32),
                q_len=np.full(Bq, Lq, np.int32),
                t_enc=rng.integers(0, 20, (Nt, Lt)).astype(np.int32),
                t_len=np.full(Nt, Lt, np.int32))


def run_steps(mesh, x, k):
    """Both sharded steps of parallel/dist.py on inputs x (mesh_inputs'
    keys): {name: this rank's rows as numpy}."""
    from ..parallel import dist
    args = [x[n] for n in ("q_enc", "q_bias", "q_len", "t_enc", "t_len")]
    Lq, Lt = x["q_enc"].shape[1], x["t_enc"].shape[1]
    dense = dist.sharded_search_step(mesh, Lq, Lt)(*args)
    topk = dist.sharded_search_topk_step(mesh, Lq, Lt, k)(*args)
    names = ("score", "q_end", "t_end", "tk_score", "tk_q_end", "tk_t_end",
             "tk_gid")
    return {n: a.cpu().numpy() for n, a in zip(names, (*dense, *topk))}


def plain_cross(x, device):
    """The dense cross product of x through K1's uncapped plain version on
    `device`: (score, q_end, t_end), each (Bq, Nt) numpy int32."""
    from ..ops import sw_torch
    Bq, Nt = len(x["q_enc"]), len(x["t_enc"])
    qi = np.repeat(np.arange(Bq), Nt)
    ti = np.tile(np.arange(Nt), Bq)
    q, qb, ql, t, tl = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                        for a in (x["q_enc"][qi], x["q_bias"][qi],
                                  x["q_len"][qi], x["t_enc"][ti],
                                  x["t_len"][ti]))
    return tuple(o.reshape(Bq, Nt).cpu().numpy()
                 for o in sw_torch.sw_ends(q, qb, ql, t, tl, cap=None))


def expected_rows(x, k, rows, plain):
    """The dense and top-k rows `rows` of the plain cross product, top-k
    with jax.lax.top_k's tie order (stable descending): the same keys as
    run_steps."""
    sc, qe, te = (a[rows] for a in plain)
    order = np.argsort(-sc.astype(np.int64), axis=1, kind="stable")[:, :k]
    pick = lambda a: np.take_along_axis(a, order, axis=1)  # noqa: E731
    return dict(score=sc, q_end=qe, t_end=te, tk_score=pick(sc),
                tk_q_end=pick(qe), tk_t_end=pick(te),
                tk_gid=order.astype(np.int32))


def rows_of(mesh, n_frags):
    """The fragment rows this rank's steps return."""
    f = mesh.get_local_rank("frags")
    nq = n_frags // mesh.shape[0]
    return slice(f * nq, (f + 1) * nq)


def check_kernel_steps(device):
    """The twin of _dryrun_kernel_steps: both steps on the group's mesh
    (make_mesh's default shape) at (2 frags) x (2 targets) pairs of 32 x
    32, equal to the plain cross product on the same device (the top-k's
    ties included)."""
    import torch.distributed as tdist
    from ..parallel import dist
    kind = torch.device(device).type
    mesh = dist.make_mesh(kind)
    nf, ns = mesh.shape
    x = mesh_inputs(2 * nf, 2 * ns, 32, 32, 1)
    k = min(3, 2 * ns)
    got = run_steps(mesh, x, k)
    want = expected_rows(x, k, rows_of(mesh, 2 * nf),
                         plain_cross(x, dist.mesh_device(mesh)))
    for n, a in want.items():
        if not np.array_equal(got[n], a):
            raise AssertionError(f"sharded step output {n} differs from the "
                                 "plain cross product")
    print(f"[dryrun] sharded steps on a {nf} x {ns} {kind} mesh (rank "
          f"{tdist.get_rank()}): dense and top-{k} rows equal the plain "
          "cross product", flush=True)


def check_dist_prefilter():
    """The fanned prefilter's phased path at one process against the
    sequential split engine (__graft_entry__.py _dryrun_dist_prefilter)."""
    from ..parallel.dist_prefilter import DistributedSplitKmerPrefilter
    from ..search.prefilter_kmer import SplitKmerPrefilter
    rng = np.random.default_rng(5)
    targets = [rng.integers(0, 20, 60).astype(np.uint8) for _ in range(24)]
    queries = [t.copy() for t in targets[:6]]
    base = SplitKmerPrefilter(targets, n_splits=2).match_batch(queries)
    with tempfile.TemporaryDirectory(prefix="meuk_dp") as td:
        got = DistributedSplitKmerPrefilter(targets, td, 2).match_batch(
            queries)
    for (bi, bs, bd), (gi, gs, gd) in zip(base, got):
        if not (np.array_equal(bi, gi) and np.array_equal(bs, gs)
                and np.array_equal(bd, gd)):
            raise AssertionError("distributed prefilter mismatch")
    print("[dryrun] fanned prefilter at one process: lists equal "
          "SplitKmerPrefilter's", flush=True)


def digests(prefix):
    return {s: hashlib.sha256(pathlib.Path(f"{prefix}.{s}").read_bytes())
            .hexdigest() for s in SUFFIXES}


def write_slice(mbp, n_targets, td):
    """tools/make_metagenome.py's slice (its default seed) as td/c.fna and
    td/p.faa, made by the script in a process of its own."""
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_metagenome.py"),
         "--mbp", str(mbp), "--targets", str(n_targets), "--out-contigs",
         str(td / "c.fna"), "--out-proteins", str(td / "p.faa")],
        check=True, capture_output=True)
    return td / "c.fna", td / "p.faa"


def check_bench_slice(device, devices):
    """The twin of _dryrun_bench_slice without its TPU projection: the
    multichip slice through easy-predict with the launches fanned over
    `devices`, digests equal to multichip_slice.json; then the sharded
    steps at slice scale and the collective bytes per mesh axis."""
    from ..params import Params
    from ..parallel import dist
    from ..pipeline.predict import EasyPredict
    golden = json.loads(
        (ROOT / "tests" / "golden" / "multichip_slice.json").read_text())
    with tempfile.TemporaryDirectory(prefix="meuk_mslice") as td:
        td = pathlib.Path(td)
        c, p = write_slice(golden["mbp"], golden["targets"], td)
        EasyPredict(Params(), device=device, devices=devices).run(
            str(c), str(p), str(td / "out"))
        if digests(td / "out") != golden["sha256"]:
            raise AssertionError("the fanned slice's digests differ from "
                                 "multichip_slice.json")
    dist.collective_report(reset=True)
    mesh = dist.make_mesh(torch.device(device).type)
    st = SLICE_STEP
    run_steps(mesh, mesh_inputs(st["Bq"], st["Nt"], st["Lq"], st["Lt"],
                                st["seed"]), st["k"])
    rep = dist.collective_report()
    print(f"[dryrun] slice: {golden['mbp']} Mbp / {golden['targets']} "
          f"targets over devices {[str(d) for d in devices]}: digests equal "
          f"multichip_slice.json; mesh {tuple(mesh.shape)}, collective bytes "
          "per rank: " + ", ".join(f"{ax}={b}" for ax, b in rep.items()),
          flush=True)


def check_fixture(device, devices):
    """easy-predict on tests/data fanned over `devices` against the
    goldens."""
    from ..params import Params
    from ..pipeline.predict import EasyPredict
    data, golden = ROOT / "tests" / "data", ROOT / "tests" / "golden"
    with tempfile.TemporaryDirectory(prefix="meuk_dryrun") as td:
        out = pathlib.Path(td) / "preds"
        EasyPredict(Params(), device=device, devices=devices).run(
            data / "contigs.fna", data / "proteins.faa", str(out))
        for s in SUFFIXES:
            if pathlib.Path(f"{out}.{s}").read_bytes() != \
                    (golden / f"easypredict.{s}").read_bytes():
                raise AssertionError(f"fanned easy-predict differs: {s}")
    print(f"[dryrun] fixture over devices {[str(d) for d in devices]}: "
          "outputs equal the goldens", flush=True)


def mesh_rank(args):
    """One rank of a mesh run: both steps on args.inputs, its rows and the
    collective report to args.out/rank{R}.npz."""
    import torch.distributed as tdist
    from ..parallel import dist
    init_group("gloo", args.coord, args.world, args.mesh_rank)
    try:
        mesh = dist.make_mesh("cpu", args.frags, args.targets)
        z = np.load(args.inputs)
        got = run_steps(mesh, {n: z[n] for n in z.files}, args.k)
        rep = dist.collective_report()
        np.savez(pathlib.Path(args.out) / f"rank{args.mesh_rank}.npz",
                 rows=np.array([rows_of(mesh, len(z["q_enc"])).start]),
                 collective=np.array([rep.get("targets", 0)]), **got)
    finally:
        tdist.destroy_process_group()
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m metaeuk_tpu_torch.tools."
                                 "dryrun", description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", default=None,
                    help="comma-separated device list of the driver's "
                         "fan-out (default: --device twice)")
    ap.add_argument("--skip-slice", action="store_true",
                    help="leave out the 1.6 Mbp slice (phase 3)")
    ap.add_argument("--mesh-rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--coord", default=None)
    ap.add_argument("--frags", type=int, default=None)
    ap.add_argument("--targets", type=int, default=None)
    ap.add_argument("--inputs", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--k", type=int, default=3)
    args = ap.parse_args(argv)
    if args.mesh_rank is not None:
        return mesh_rank(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available")
    devices = [torch.device(d) for d in args.devices.split(",")] \
        if args.devices else [device, device]
    with one_rank_group(device):
        check_kernel_steps(device)
        check_dist_prefilter()
        if not args.skip_slice:
            check_bench_slice(device, devices)
    check_fixture(device, devices)
    print("[dryrun] ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
