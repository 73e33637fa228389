"""What the entries share: the target DB of set-up, the port's CLI, and a
plain reader of MMseqs2 DB files for the comparison."""

import contextlib
import sys
import time

import numpy as np

from .. import gen


def targets(ctx):
    """The configuration's target DB from the seed, and what the
    reference reads of it."""
    ctx.tdb = gen.targets(ctx.seed, ctx.cfg)
    ctx.tlens = ctx.tdb.lengths
    ctx.db_res = int(ctx.tlens.sum())
    ctx.t_acc = [f"prot{i}" for i in range(len(ctx.tdb))]


def setup_db(ctx):
    """The target DB: FASTA, then createdb through the port's CLI, as
    users build a DB once."""
    t0 = time.perf_counter()
    targets(ctx)
    fasta = ctx.workdir / "targets.faa"
    gen.write_targets(fasta, ctx.tdb)
    ctx.db = ctx.workdir / "targetDB"
    t1 = time.perf_counter()
    cli(["createdb", str(fasta), str(ctx.db)])
    print(f"set-up: DB made in {t1 - t0:.3f} s, createdb "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)


def cli(argv):
    """One call of the port's CLI, its standard output sent to standard
    error (the run's last standard output line is the result)."""
    from metaeuk_tpu_torch import cli as port_cli
    with contextlib.redirect_stdout(sys.stderr):
        rc = port_cli.main(argv)
    if rc:
        raise RuntimeError(f"{argv[0]} returned {rc}")


def read_db(path):
    """{key: payload text} of an MMseqs2 DB (data + .index)."""
    data = open(path, "rb").read()
    out = {}
    for line in open(f"{path}.index"):
        k, off, n = line.split("\t")
        out[int(k)] = data[int(off):int(off) + int(n) - 1].decode()
    return out


def rows_differ(got, want):
    """Rows of two ordered lists that differ, the longer's extra rows
    counted too."""
    n = sum(a != b for a, b in zip(got, want))
    return n + abs(len(got) - len(want))


def tcodes(tdb):
    """Each target's residue codes (int64) for the reference."""
    c = tdb.codes.astype(np.int64)
    return [c[tdb.offsets[i]:tdb.offsets[i + 1]] for i in range(len(tdb))]


def flags(cfg):
    """The CLI flags of a configuration's parameters."""
    return ["--prefilter-mode", cfg["prefilter_mode"],
            "--min-ungapped-score", str(cfg["min_ungapped_score"]),
            "-e", str(cfg["evalue"]), "--max-seqs", str(cfg["max_seqs"])]


@contextlib.contextmanager
def timed(label):
    """Prints the seconds a stage of the comparison took to stderr."""
    t0 = time.perf_counter()
    yield
    print(f"compare: {label} {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
