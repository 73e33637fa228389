"""The port's resident search server on the CPU, against the direct commands
and the JAX package's server.

As tests/test_server.py runs metaeuk_tpu's server: the port's
TpuSearchServer in a thread (device="cpu", the kernels' plain versions)
answers ping, prefilter and search with the bytes of the direct
prefilter_db and search_db, and refuses an unknown op; three searches and
three prefilters sent at once give the bytes of a single one. A search
with easy_search's settings (alignment mode 3, -e 1e-3) gives
easy_search's result DB, in either package's server. The two packages' serverclient and client_request speak
one protocol. The warmup runs K1/K2 (their plain versions here) on at most
WARMUP_TARGETS targets, and a kernel entry that raises, or K1/K2 not
running, stops the server before it listens. chip_smoke.py's phase 4i
server check (the CLI's gpuserver in a process of its own) and phase 5j
(its --serve mode, two servers, concurrent requests) rehearsed on the
fixture. The tolerance is exact equality.
"""

import inspect
import os
import pathlib
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from metaeuk_tpu_torch import cli, server
from metaeuk_tpu_torch.ops import sw_cuda, sw_torch
from metaeuk_tpu_torch.search import searchdb
from metaeuk_tpu_torch.server import TpuSearchServer, client_request

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

DATA = ROOT / "tests" / "data"
DB_SUFFIXES = ("", ".index", ".dbtype")


def assert_db_equal(a, b):
    for s in DB_SUFFIXES:
        assert pathlib.Path(f"{a}{s}").read_bytes() == \
            pathlib.Path(f"{b}{s}").read_bytes(), f"{a}{s}"


def serve(srv):
    """Runs srv.serve_forever in a daemon thread; returns the thread once
    the socket exists."""
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    for _ in range(200):
        if os.path.exists(srv.socket_path):
            break
        time.sleep(0.05)
    return t


def stop(sock, thread):
    client_request(sock, {"op": "shutdown"}, timeout=30)
    thread.join(timeout=30)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The fixture proteins' DB served by the port (on the CPU, no warmup),
    the fixture queries' DB beside it."""
    td = tmp_path_factory.mktemp("torch_server")
    assert cli.main(["createdb", str(DATA / "proteins.faa"),
                     str(td / "tdb")]) == 0
    assert cli.main(["createdb", str(DATA / "queries_lin.faa"),
                     str(td / "qdb")]) == 0
    sock = str(td / "srv.sock")
    t = serve(TpuSearchServer(str(td / "tdb"), sock, warmup=False,
                              device="cpu"))
    yield td, sock
    stop(sock, t)
    assert not os.path.exists(sock)


@pytest.fixture(scope="module")
def easy(tmp_path_factory):
    """The JAX package's easy_search on the fixture: its query and target
    DBs and result DB under the returned directory."""
    from metaeuk_tpu.search.searchdb import easy_search
    td = tmp_path_factory.mktemp("easy_search")
    easy_search(str(DATA / "queries_lin.faa"), str(DATA / "proteins.faa"),
                str(td / "es.m8"), str(td / "es"))
    return td / "es"


def test_ping(served):
    td, sock = served
    resp = client_request(sock, {"op": "ping"})
    assert resp["ok"] and resp["target_db"].endswith("tdb")
    assert resp["sensitivity"] == 5.7 and resp["max_seqs"] == 300


def test_server_search_matches_direct(served):
    td, sock = served
    resp = client_request(sock, {
        "op": "search", "query_db": str(td / "qdb"),
        "out_db": str(td / "srv_aln"), "tmp": str(td / "srv_tmp"),
        "evalue": 1e-3, "add_backtrace": True})
    assert resp == {"ok": True, "out_db": str(td / "srv_aln")}
    searchdb.search_db(str(td / "qdb"), str(td / "tdb"), str(td / "dir_aln"),
                       str(td / "dir_tmp"), evalue=1e-3, add_backtrace=True,
                       device="cpu")
    assert_db_equal(td / "srv_aln", td / "dir_aln")


def test_server_prefilter_matches_direct(served):
    td, sock = served
    resp = client_request(sock, {
        "op": "prefilter", "query_db": str(td / "qdb"),
        "out_db": str(td / "srv_pref")})
    assert resp["ok"], resp
    searchdb.prefilter_db(str(td / "qdb"), str(td / "tdb"),
                          str(td / "dir_pref"))
    assert_db_equal(td / "srv_pref", td / "dir_pref")


def test_unknown_op(served):
    td, sock = served
    resp = client_request(sock, {"op": "nope"})
    assert not resp["ok"] and "nope" in resp["error"]


def test_concurrent_requests_equal_a_single_one(served):
    """Three search requests and three prefilter requests at once (to
    different DBs) give a single search's bytes. The server runs them one
    at a time: the k-mer index's single-query match reuses one native
    scratch, and concurrent matches corrupt the heap (ROADMAP section 3)."""
    td, sock = served

    def search(name):
        return client_request(sock, {
            "op": "search", "query_db": str(td / "qdb"),
            "out_db": str(td / name), "tmp": str(td / f"{name}_tmp"),
            "alignment_mode": 3})

    def prefilter(name):
        return client_request(sock, {
            "op": "prefilter", "query_db": str(td / "qdb"),
            "out_db": str(td / name)})
    assert search("one")["ok"]
    with ThreadPoolExecutor(6) as ex:
        futs = [ex.submit(fn, n) for n in ("c1", "c2", "c3")
                for fn in (search, lambda n: prefilter(f"{n}_pref"))]
        assert all(f.result()["ok"] for f in futs)
    for n in ("c1", "c2", "c3"):
        assert_db_equal(td / n, td / "one")
        assert_db_equal(td / f"{n}_tmp" / "pref_0", td / "one_tmp" / "pref_0")
        assert_db_equal(td / f"{n}_pref", td / "one_tmp" / "pref_0")


@pytest.mark.parametrize("package", ["jax", "port"])
def test_server_search_mode3_is_easy_searchs_result(easy, tmp_path,
                                                    package):
    """A search request at easy_search's settings over easy_search's own
    query and target DBs writes the JAX easy_search's result DB, in the JAX
    package's server and in the port's: phase 5j holds the port's server to
    search_slice.json's easy_search result on that ground."""
    if package == "jax":
        from metaeuk_tpu.server import TpuSearchServer as Server
        from metaeuk_tpu.server import client_request as request
        srv = Server(str(easy / "target"), str(tmp_path / "s.sock"),
                     warmup=False)
    else:
        request = client_request
        srv = TpuSearchServer(str(easy / "target"), str(tmp_path / "s.sock"),
                              warmup=False, device="cpu")
    t = serve(srv)
    try:
        resp = request(srv.socket_path, dict(
            op="search", query_db=str(easy / "query"),
            out_db=str(tmp_path / "res"), tmp=str(tmp_path / "tmp"),
            **chip_smoke.SERVER_SEARCH))
        assert resp["ok"], resp
    finally:
        stop(srv.socket_path, t)
    assert_db_equal(tmp_path / "res", easy / "result")


def test_serverclients_speak_one_protocol(served, tmp_path):
    """The JAX CLI's serverclient against the port's server, and the port's
    against the JAX package's server, write the same bytes."""
    from metaeuk_tpu import cli as jax_cli
    from metaeuk_tpu.server import TpuSearchServer as JaxServer
    td, sock = served
    jsock = str(tmp_path / "jax.sock")
    t = serve(JaxServer(str(td / "tdb"), jsock, warmup=False))
    try:
        for main, s, out in ((jax_cli.main, sock, "j2p"),
                             (cli.main, jsock, "p2j")):
            assert main(["serverclient", s, "ping"]) == 0
            assert main(["serverclient", s, "search", str(td / "qdb"),
                         str(tmp_path / out), str(tmp_path / f"{out}_tmp"),
                         "-a", "1"]) == 0
            assert main(["serverclient", s, "prefilter", str(td / "qdb"),
                         str(tmp_path / f"{out}_pref")]) == 0
        assert_db_equal(tmp_path / "j2p", tmp_path / "p2j")
        assert_db_equal(tmp_path / "j2p_pref", tmp_path / "p2j_pref")
    finally:
        assert cli.main(["serverclient", jsock, "shutdown"]) == 0
        t.join(timeout=30)
    assert not os.path.exists(jsock)


def test_serverclient_reports_a_refused_request(served, capsys):
    td, sock = served
    assert cli.main(["serverclient", sock, "search", str(td / "missing"),
                     str(td / "never")]) == 1
    assert "server error" in capsys.readouterr().out


def test_warmup_runs_k1_k2_on_few_targets(served, monkeypatch):
    """warmup=True loads nothing on the CPU and runs K1/K2's plain versions
    once, over at most WARMUP_TARGETS targets aligned against themselves."""
    td, _ = served
    seen = []
    align = sw_cuda.sw_ends

    def counted(q_enc, *a, **kw):
        seen.append(q_enc.shape[0])
        return align(q_enc, *a, **kw)
    monkeypatch.setattr(sw_cuda, "sw_ends", counted)
    monkeypatch.setattr(server, "WARMUP_TARGETS", 4)
    sw_cuda.reset_counts()
    TpuSearchServer(str(td / "tdb"), str(td / "w.sock"), device="cpu")
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] > 0
    assert sw_cuda.PLAIN_CALLS["sw_pair_starts"] > 0
    assert not any(sw_cuda.LAUNCHES.values())
    assert 0 < sum(seen) <= 4 * 4


def test_a_failing_kernel_entry_stops_the_server(served, monkeypatch,
                                                 tmp_path):
    """A kernel entry that raises during the warmup propagates: the server
    object is not made, gpuserver raises and no socket is left."""
    td, _ = served

    def broken(*a, **kw):
        raise RuntimeError("sw_pair_ends launch failed: CUDA error 209")
    monkeypatch.setattr(sw_cuda, "sw_ends", broken)
    with pytest.raises(RuntimeError, match="CUDA error 209"):
        TpuSearchServer(str(td / "tdb"), str(tmp_path / "a.sock"),
                        device="cpu")
    with pytest.raises(RuntimeError, match="CUDA error 209"):
        cli.main(["gpuserver", str(td / "tdb"), "--socket",
                  str(tmp_path / "b.sock"), "--device", "cpu"])
    assert not list(tmp_path.iterdir())
    # --warmup 0 starts without touching the kernels
    srv = TpuSearchServer(str(td / "tdb"), str(tmp_path / "c.sock"),
                          warmup=False, device="cpu")
    assert srv.device == "cpu"


def test_warmup_fails_when_k1_k2_did_not_run(served, monkeypatch, tmp_path):
    """A path that computes the alignment without K1/K2's entries (their
    counts unchanged) fails the warmup too."""
    td, _ = served
    monkeypatch.setattr(sw_cuda, "sw_ends",
                        lambda *a, **kw: sw_torch.sw_ends(*a, **kw))
    with pytest.raises(RuntimeError, match="sw_pair_ends.*did not run"):
        TpuSearchServer(str(td / "tdb"), str(tmp_path / "d.sock"),
                        device="cpu")


def test_server_defaults_to_cuda():
    assert inspect.signature(TpuSearchServer).parameters["device"].default \
        == "cuda"
    from metaeuk_tpu_torch.pipeline.multihit_wf import multihitsearch
    assert inspect.signature(multihitsearch).parameters["device"].default \
        == "cuda"


def test_chip_smoke_server_fixture_on_cpu(tmp_path):
    """chip_smoke.py's phase 4i server check: `python -m
    metaeuk_tpu_torch.cli gpuserver --warmup 1` in a process of its own,
    serverclient and client_request, shutdown with exit 0."""
    assert chip_smoke.check_server_fixture(cli, "cpu", tmp_path) > 0


def test_chip_smoke_server_slice_on_cpu(easy, tmp_path):
    """chip_smoke.py's phase 5j on the fixture, on the CPU: two servers
    (--warmup 0, then 1), prefilter, two searches and two at once, each
    request recorded in the server's process, the search equal to the JAX
    easy_search's result DB."""
    want = {s: chip_smoke.sha256(f"{easy / 'result'}{s}")
            for s in DB_SUFFIXES}
    got = chip_smoke.check_server_slice(
        tmp_path, DATA / "queries_lin.faa", DATA / "proteins.faa", "cpu",
        want=want)
    assert set(got["startup"]) == {"0", "1"}
    assert [r["op"] for r in got["requests"]] == [
        "prefilter", "search", "search", "search", "search"]
    first = got["requests"][1]
    assert first["launches"]["sw_pair_ends"] > 0
    assert first["routes"]["pair"]["fwd"][0] > 0
