"""The port's span recorder (metaeuk_tpu_torch/utils/trace.py) and the spans
its workflows, prefilter and aligner record: parents, the root of a CLI
call, pool threads, the bound on what is kept, the torch profiler's ranges,
and the span tree of a search and an easy-predict CLI call on a small
generated DB (device "cpu", the kernels' plain versions). The timers that
read the spans keep their keys: the driver's PHASE_SECONDS and the
StageTimer stages that the benchmark reads."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from benchmark.entries.easy_predict import HOST_STAGES
from metaeuk_tpu_torch import cli
from metaeuk_tpu_torch.io.seqdb import DBTYPE_AA, SeqDB
from metaeuk_tpu_torch.params import Params
from metaeuk_tpu_torch.pipeline.predict import EasyPredict
from metaeuk_tpu_torch.search import driver
from metaeuk_tpu_torch.utils import session, trace

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

AA = "ACDEFGHIKLMNPQRSTVWY"
CODON = dict(zip(AA, ("GCT TGT GAT GAA TTT GGT CAT ATT AAA CTT ATG AAT CCT "
                      "CAA CGT TCT ACT GTT TGG TAT").split()))
PHASES = {"prep", "fwd_submit", "fwd_fetch", "fwd_assemble", "gate",
          "rev_submit", "rev_fetch", "filter_sort", "backtraces",
          "realign_sw", "realign_traceback"}
# (span, its parent) in each call
PREFILTER_TREE = [("prefilter.encode", "prefilter"),
                  ("prefilter.stage", "prefilter"),
                  ("prefilter.score", "prefilter"),
                  ("prefilter.select", "prefilter")]
ALIGN_TREE = [("align.query_stage", "align"), ("prep", "align"),
              ("fwd_submit", "align"), ("align.target_stage", "fwd_submit"),
              ("fwd_fetch", "align"), ("fwd_assemble", "align"),
              ("gate", "align"), ("rev_submit", "align"),
              ("rev_fetch", "align"), ("filter_sort", "align")]
TREES = {
    "search": [("load_queries", "search"), ("load_targets", "search"),
               ("driver_init", "search"), ("prefilter_init", "search"),
               ("prefilter", "search"), ("align", "search"),
               ("backtraces", "search"), ("write", "search"),
               *PREFILTER_TREE, *ALIGN_TREE],
    "easy-predict": [
        ("load contigs+targets", "easy-predict"),
        ("load_targets", "load contigs+targets"),
        ("predictexons", "easy-predict"),
        ("extractorfs+translate", "predictexons"),
        ("driver_lookup", "predictexons"), ("driver_init", "driver_lookup"),
        ("prefilter_init", "predictexons"),
        ("ungapped prefilter", "predictexons"),
        ("prefilter", "ungapped prefilter"), ("align", "predictexons"),
        ("align", "align"), ("collectoptimalset", "predictexons"),
        ("reduceredundancy+write", "easy-predict"),
        *PREFILTER_TREE, *ALIGN_TREE],
}


def _fasta(path, seqs, prefix):
    path.write_text("".join(f">{prefix}{i}\n{s}\n" for i, s in
                            enumerate(seqs)))
    return str(path)


def _inputs(d):
    """30 random proteins as targets, 8 of them mutated at 5% as queries,
    and 3 contigs that each carry one of them as a single-exon gene."""
    rng = np.random.default_rng(25)
    letters = np.array(list(AA))
    prots = ["M" + "".join(rng.choice(letters, int(n)))
             for n in rng.integers(120, 260, 30)]
    queries = []
    for p in prots[:8]:
        q = np.array(list(p))
        hit = rng.random(len(q)) < 0.05
        q[hit] = rng.choice(letters, int(hit.sum()))
        queries.append("".join(q))

    def dna(n):
        return "".join(rng.choice(list("ACGT"), n))
    contigs = [dna(400) + "".join(CODON[a] for a in prots[i]) + "TAA"
               + dna(400) for i in (3, 11, 20)]
    return dict(targets=_fasta(d / "targets.faa", prots, "prot"),
                queries=_fasta(d / "queries.faa", queries, "q"),
                contigs=_fasta(d / "contigs.fna", contigs, "contig"))


def _under(root):
    """The kept spans that descend from `root`, and root, by span id."""
    by_id = {s.span_id: s for s in trace.spans()}
    out = {}
    for s in by_id.values():
        anc = s
        while anc is not None and anc.span_id != root.span_id:
            anc = by_id.get(anc.parent_id)
        if anc is not None:
            out[s.span_id] = s
    return out


def _call_spans(command):
    """The spans of the newest CLI call of `command`, by span id, and its
    root."""
    root = [s for s in trace.spans() if s.name == command
            and s.parent_id == 0][-1]
    return _under(root), root


def test_parents_and_the_root_of_a_call():
    with trace.span("cmd") as root:
        with trace.span("a") as a:
            with trace.span("b") as b:
                pass
        with trace.span("c") as c:
            pass
    with trace.span("cmd") as other:
        pass
    assert root.parent_id == 0 and a.parent_id == root.span_id
    assert b.parent_id == a.span_id and c.parent_id == root.span_id
    assert other.parent_id == 0
    assert len({s.span_id for s in (root, a, b, c, other)}) == 5
    got = [s.name for s in _under(root).values()]
    assert got == ["b", "a", "c", "cmd"]
    assert root.t0 <= a.t0 <= b.t0 <= b.t1 <= a.t1 <= c.t0 <= root.t1
    assert trace.current() is None


def test_span_in_a_pool_thread_takes_the_passed_parent():
    def work(parent):
        with trace.span("pooled", parent=parent) as sp:
            with trace.span("inner") as inner:
                pass
        with trace.span("orphan") as orphan:
            pass
        return sp, inner, orphan

    with trace.span("cmd") as root:
        with ThreadPoolExecutor(1) as pool:
            sp, inner, orphan = pool.submit(work, root).result(timeout=60)
    assert sp.parent_id == root.span_id
    assert inner.parent_id == sp.span_id
    assert orphan.parent_id == 0
    assert trace.current() is None


def test_an_exception_closes_the_spans_it_left_open():
    with pytest.raises(ValueError):
        with trace.span("outer") as outer:
            trace.span("left open").__enter__()
            raise ValueError
    assert trace.current() is None and outer.t1 is not None


def test_kept_spans_are_bounded():
    first = trace.span("first")
    with first:
        pass
    for i in range(trace.MAX_SPANS + 10):
        with trace.span(f"many{i}"):
            pass
    kept = trace.spans()
    assert len(kept) == trace.MAX_SPANS and first not in kept
    assert kept[0].name == "many10"
    assert kept[-1].name == f"many{trace.MAX_SPANS + 9}"
    trace.clear()
    assert trace.spans() == []


@pytest.mark.parametrize("profiling", [False, True])
def test_profiler_range_only_while_a_profiler_records(monkeypatch,
                                                      profiling):
    entered = []

    class Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    def no_record_function(*args, **kwargs):
        raise AssertionError("record_function adds a device-side range")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Range)
    monkeypatch.setattr(torch.profiler, "record_function",
                        no_record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        no_record_function)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled",
                        lambda: profiling)
    with trace.span("x"):
        with trace.span("y"):
            pass
    assert entered == (["metaeuk.x", "metaeuk.y"] if profiling else [])


def test_ranges_land_in_a_torch_profile():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(8).sum()
    ev = {e.name: e for e in prof.events() if e.name.startswith("metaeuk.")}
    assert set(ev) == {"metaeuk.outer", "metaeuk.inner"}
    outer, inner = ev["metaeuk.outer"].time_range, ev["metaeuk.inner"]\
        .time_range
    assert outer.start <= inner.start <= inner.end <= outer.end


@pytest.mark.parametrize("command", sorted(TREES))
def test_cli_call_span_tree(tmp_path, command):
    f = _inputs(tmp_path)
    flags = ["--prefilter-mode", "ungapped", "--device", "cpu"]
    session.clear()
    if command == "search":
        argv = ["search", f["queries"], f["targets"],
                str(tmp_path / "aln"), "-a", "1", *flags]
    else:
        argv = ["easy-predict", f["contigs"], f["targets"],
                str(tmp_path / "pred"), *flags]
    assert cli.main(argv) == 0
    by_id, root = _call_spans(command)
    pairs = {(s.name, by_id[s.parent_id].name) for s in by_id.values()
             if s.parent_id}
    for want in TREES[command]:
        assert want in pairs, want
    assert root.t0 <= min(s.t0 for s in by_id.values())
    assert max(s.t1 for s in by_id.values()) == root.t1
    # the driver's align span, once, apart from easy-predict's stage
    aligned = {by_id[s.parent_id].span_id for s in by_id.values()
               if s.name == "align.query_stage"}
    assert len(aligned) == 1


def test_phase_seconds_keep_their_keys(tmp_path, monkeypatch):
    """search(), backtraces() and realign() feed PHASE_SECONDS from their
    spans under today's keys; query staging stays out of it."""
    f = _inputs(tmp_path)
    monkeypatch.setattr(driver, "PHASE_SECONDS", {})
    db = SeqDB.from_fasta(f["targets"], DBTYPE_AA)
    queries = SeqDB.from_fasta(f["queries"], DBTYPE_AA)
    seqs = [queries.seq_bytes(i) for i in range(len(queries))]
    with trace.span("phases") as root:
        drv = driver.SearchDriver(Params(), db, "cpu")
        hits = drv.search(seqs)
        drv.backtraces(hits, seqs)
        drv.realign(hits, seqs)
    assert set(driver.PHASE_SECONDS) == PHASES
    assert set(drv.phase_seconds) == PHASES - {
        "backtraces", "realign_sw", "realign_traceback"}
    spans = {s.name: s for s in _under(root).values()}
    for name in ("backtraces", "realign_sw", "realign_traceback"):
        assert spans[name].parent_id == root.span_id
        assert driver.PHASE_SECONDS[name] == \
            spans[name].t1 - spans[name].t0


def test_stage_timer_keeps_the_stages_the_benchmark_reads(tmp_path):
    f = _inputs(tmp_path)
    ep = EasyPredict(Params(prefilter_mode="ungapped"), device="cpu")
    ep.run(f["contigs"], f["targets"], str(tmp_path / "pred"))
    stages = {**ep.predict_stage_seconds, **ep.stage_seconds}
    assert set(HOST_STAGES) <= set(stages)
    assert HOST_STAGES == ("load contigs+targets", "extractorfs+translate",
                           "collectoptimalset", "reduceredundancy+write")
    assert set(ep.predict_stage_seconds) == {
        "extractorfs+translate", "ungapped prefilter", "align",
        "collectoptimalset"}
