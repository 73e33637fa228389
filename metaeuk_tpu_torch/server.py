"""Resident search server (the reference gpuserver's role) on the port.

Counterpart of metaeuk_tpu/server.py. The reference's `gpuserver`
(lib/mmseqs/src/util/gpuserver.cpp) keeps a padded target database
resident in GPU memory so repeated `search --gpu-server` invocations skip
the load; this server keeps the expensive per-process state resident
instead:

- the target DB's k-mer prefilter index (seconds to build; the port's
  searchdb.build_prefilter_state),
- the built and loaded CUDA libraries of the alignment kernels (nvcc
  builds them at first use in a process).

Protocol: one JSON object per line over a unix domain socket.
  {"op": "ping"}                          -> {"ok": true, "pid": ...}
  {"op": "prefilter", "query_db": q, "out_db": o, ...}
  {"op": "search", "query_db": q, "out_db": o, "tmp": t, ...}
  {"op": "shutdown"}
Results are written to the requested paths on the shared filesystem;
responses carry only status. Output bytes are identical to the
non-server `search`/`prefilter` commands (same code path, preloaded
state). Searches align on the server's `device` (default cuda; cpu runs
the kernels' plain versions).

Two differences from metaeuk_tpu/server.py, neither in the output bytes:

- The warmup (warmup=True) loads the alignment kernels' CUDA libraries and
  runs K1/K2 once through align_db on at most WARMUP_TARGETS of the
  targets aligned against themselves; any failure propagates, so a kernel
  that does not build or launch stops the server before it listens.
- Requests are served by threads, but prefilter and search run one at a
  time under one lock: the k-mer index's single-query match reuses one
  native scratch (native/prefilter.cpp, pf_match), and the driver's
  counters are module globals.
"""

import json
import os
import socket
import socketserver
import threading

from .search import searchdb

# the targets the warmup aligns against themselves
WARMUP_TARGETS = 16


class TpuSearchServer:
    def __init__(self, target_db, socket_path, sensitivity=5.7,
                 max_seqs=300, min_ungapped_score=15,
                 comp_bias_correction=True, mask_targets=True,
                 warmup=True, device="cuda"):
        self.target_db = str(target_db)
        self.socket_path = str(socket_path)
        self.device = device
        self.settings = dict(sensitivity=sensitivity, max_seqs=max_seqs,
                             min_ungapped_score=min_ungapped_score,
                             comp_bias_correction=comp_bias_correction,
                             mask_targets=mask_targets)
        self._lock = threading.Lock()
        self.state = searchdb.build_prefilter_state(
            self.target_db, sensitivity=sensitivity, max_seqs=max_seqs,
            min_ungapped_score=min_ungapped_score,
            comp_bias_correction=comp_bias_correction,
            mask_targets=mask_targets)
        if warmup:
            self._warmup()

    def _warmup(self):
        """Loads the kernels' CUDA libraries (on a CUDA device) and runs
        K1/K2 once: the first WARMUP_TARGETS targets prefiltered and aligned
        against themselves on the server's device. Raises on any failure,
        and when K1 or K2 did not run."""
        import tempfile

        import torch

        from .ops import _build, sw_cuda
        from .pipeline.dbtools import createsubdb
        from .search.align_module import align_db

        on_card = torch.device(self.device).type == "cuda"
        if on_card:
            for src in sorted(set(sw_cuda.SOURCES.values())):
                _build.load(src)
        counts = sw_cuda.LAUNCHES if on_card else sw_cuda.PLAIN_CALLS
        before = {k: counts[k] for k in ("sw_pair_ends", "sw_pair_starts")}
        _, tdb, _ = self.state
        keys = [int(k) for k in tdb.keys[:WARMUP_TARGETS]]
        with tempfile.TemporaryDirectory() as td:
            few = os.path.join(td, "few")
            createsubdb(keys, self.target_db, few)
            pref = os.path.join(td, "pref")
            searchdb.prefilter_db(few, few, pref, **self.settings)
            align_db(few, few, pref, os.path.join(td, "aln"),
                     device=self.device)
        ran = [k for k, n in before.items() if counts[k] > n]
        if len(ran) != len(before):
            raise RuntimeError(f"warmup: {sorted(set(before) - set(ran))} "
                               "did not run")

    def handle(self, req):
        op = req.get("op")
        if op == "ping":
            return dict(ok=True, pid=os.getpid(),
                        target_db=self.target_db, **self.settings)
        if op == "prefilter":
            with self._lock:
                searchdb.prefilter_db(
                    req["query_db"], self.target_db, req["out_db"],
                    cov=req.get("cov", 0.0), cov_mode=req.get("cov_mode", 0),
                    _state=self.state)
            return dict(ok=True, out_db=req["out_db"])
        if op == "search":
            from .search.align_module import align_db
            tmp = req.get("tmp") or (req["out_db"] + ".tmp")
            os.makedirs(tmp, exist_ok=True)
            pref = os.path.join(tmp, "pref_0")
            with self._lock:
                searchdb.prefilter_db(
                    req["query_db"], self.target_db, pref,
                    cov=req.get("cov", 0.0), cov_mode=req.get("cov_mode", 0),
                    _state=self.state)
                align_db(req["query_db"], self.target_db, pref,
                         req["out_db"], evalue=req.get("evalue", 1e-3),
                         min_seq_id=req.get("min_seq_id", 0.0),
                         cov=req.get("cov", 0.0),
                         cov_mode=req.get("cov_mode", 0),
                         max_accept=req.get("max_accept"),
                         add_backtrace=req.get("add_backtrace", False),
                         alignment_mode=req.get("alignment_mode", 2),
                         device=self.device)
            return dict(ok=True, out_db=req["out_db"])
        if op == "shutdown":
            return dict(ok=True, shutdown=True)
        return dict(ok=False, error=f"unknown op {op!r}")

    def serve_forever(self):
        server_self = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                        resp = server_self.handle(req)
                    except Exception as e:  # report, keep serving
                        resp = dict(ok=False, error=str(e))
                    self.wfile.write(json.dumps(resp).encode() + b"\n")
                    self.wfile.flush()
                    if resp.get("shutdown"):
                        threading.Thread(
                            target=self.server.shutdown).start()
                        return

        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)

        class Server(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True

        with Server(self.socket_path, Handler) as srv:
            self._ready = True
            srv.serve_forever()
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)


def client_request(socket_path, req, timeout=3600.0):
    """Send one request to a running server; returns the response."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(str(socket_path))
        s.sendall(json.dumps(req).encode() + b"\n")
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf)


def run_server(target_db, socket_path, **kw):
    TpuSearchServer(target_db, socket_path, **kw).serve_forever()
