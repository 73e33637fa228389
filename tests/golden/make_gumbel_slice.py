"""The Gumbel slice: the runtime E-value fit (search/gumbel.py) of four
non-default scoring systems at the JAX package's defaults, and
tests/golden/gumbel_slice.json.

The systems (GUMBEL_SYSTEMS), built only from matrices the repository
carries:

- "blosum62_8_2": BLOSUM62 (data/submat.py) at gap costs 8/2;
- "vtml80_10_1": VTML80 at bit factor 2 (data/vtml80.py::_build(2.0), the
  scale of MMseqs2's VTML80.out) at 10/1;
- "nucl_4_2": proteinaln2nucl's +2/-3 nucleotide matrix and background
  (pipeline/offsetaln.py) at 4/2, fitted through proteinaln2nucl itself
  on tests/golden/utils/orfs against orfself_aln (the inputs of
  tests/test_offsetaln.py), whose output DB is recorded too;
- "vtml80_ungapped": the ungapped fit of EvalueComputation.for_scoring(...,
  gapped=False) on the same VTML80, fitted_params(scores, pback, 32000, 0).

Each fit runs fit_gapped at its defaults (262,144 pairs of 384 letters in
chunks of 4,096; islands over 4,096 pairs of 1,024), with the fit cache
pointed at a temporary file. For each system the JSON holds the 12
parameters as exact floats (repr), the sha256 of _simulate's (S, len_i,
len_j) (int64, in that order), the island count and the CPU seconds.

    python3 tests/golden/make_gumbel_slice.py > tests/golden/gumbel_slice.json

It runs metaeuk_tpu on the CPU, two processes at once (about 15 minutes a
full-size fit). metaeuk_tpu_torch must give the same parameters bit for
bit (chip_smoke.py phase 5k holds the port to them on the card).
"""

import contextlib
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

COMMAND = "python3 tests/golden/make_gumbel_slice.py"
FIT_DEFAULTS = dict(n_pairs=262144, length=384, chunk=4096, isl_pairs=4096,
                    isl_length=1024)
GUMBEL_SYSTEMS = ("blosum62_8_2", "vtml80_10_1", "nucl_4_2",
                  "vtml80_ungapped")
PARAM_KEYS = ("lam", "K", "a_J", "b_J", "a_I", "b_I", "alpha_J", "beta_J",
              "alpha_I", "beta_I", "sigma", "tau")
P2N_GAPS = (4, 2)
DB_SUFFIXES = ("", ".index", ".dbtype")


def scoring_system(name, submat_mod, vtml80_mod):
    """(scores, pback, gap_open, gap_extend) of a system (the ungapped one
    at for_scoring's gap costs 32000/0), from either package's data
    modules."""
    import numpy as np
    if name == "blosum62_8_2":
        return (submat_mod.BLOSUM62_SCORES, submat_mod.BLOSUM62_PBACK, 8, 2)
    if name == "nucl_4_2":
        # pipeline/offsetaln.py::proteinaln2nucl's matrix and background
        sc = np.full((5, 5), -3, np.int64)
        np.fill_diagonal(sc, 2)
        sc[4, :] = sc[:, 4] = -3
        return sc, np.array([0.25, 0.25, 0.25, 0.25, 0.0], np.float64), 4, 2
    scores, pback, _ = vtml80_mod._build(2.0)
    if name == "vtml80_10_1":
        return scores, pback, 10, 1
    if name == "vtml80_ungapped":
        return scores, pback, 32000, 0
    raise KeyError(name)


def simulate_sha256(S, len_i, len_j):
    """sha256 of _simulate's three arrays as int64, S, len_i, len_j."""
    import numpy as np
    h = hashlib.sha256()
    for a in (S, len_i, len_j):
        h.update(np.ascontiguousarray(a, np.int64).tobytes())
    return h.hexdigest()


def db_sha256(path):
    return {s: hashlib.sha256(pathlib.Path(f"{path}{s}").read_bytes())
            .hexdigest() for s in DB_SUFFIXES}


def recorder(gumbel):
    """Wraps gumbel._simulate and _simulate_islands to record what a fit
    gave them; returns the dict they fill and a function undoing it."""
    seen = {}
    sim, isl = gumbel._simulate, gumbel._simulate_islands

    def _simulate(*a, **k):
        out = sim(*a, **k)
        seen["simulate_sha256"] = simulate_sha256(*out)
        return out

    def _simulate_islands(*a, **k):
        out = isl(*a, **k)
        seen["islands"] = int(len(out))
        return out

    gumbel._simulate, gumbel._simulate_islands = _simulate, _simulate_islands

    def undo():
        gumbel._simulate, gumbel._simulate_islands = sim, isl
    return seen, undo


def _run(system, kw):
    """One fit of metaeuk_tpu on the CPU at fit_gapped's keywords kw;
    returns its entry."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from metaeuk_tpu.data import submat, vtml80
    from metaeuk_tpu.search import evalue, gumbel
    scores, pback, go, ge = scoring_system(system, submat, vtml80)
    entry = {"gaps": [go, ge], "fit": kw}
    saved = gumbel._FIT_CACHE_PATH, gumbel._mem_cache, gumbel.fit_gapped
    with tempfile.TemporaryDirectory() as td, \
            contextlib.redirect_stdout(sys.stderr):
        td = pathlib.Path(td)
        gumbel._FIT_CACHE_PATH = str(td / "gumbel_cache.json")
        gumbel._mem_cache = {}
        fit = gumbel.fit_gapped
        gumbel.fit_gapped = lambda *a, **k: fit(*a, **dict(k, **kw))
        seen, undo = recorder(gumbel)
        t0 = time.perf_counter()
        try:
            if system == "nucl_4_2":
                p2n = run_proteinaln2nucl(td, *P2N_GAPS)
                params = next(iter(gumbel._mem_cache.values()))
                entry["proteinaln2nucl"] = p2n
            elif system == "vtml80_ungapped":
                params = evalue.EvalueComputation.for_scoring(
                    1, scores, pback, 10, 1, gapped=False).p
            else:
                params = gumbel.fitted_params(scores, pback, go, ge)
        finally:
            undo()
            gumbel._FIT_CACHE_PATH, gumbel._mem_cache, gumbel.fit_gapped = \
                saved
        entry["cpu_seconds"] = round(time.perf_counter() - t0, 1)
    entry["params"] = {k: repr(params[k]) for k in PARAM_KEYS}
    entry.update(seen)
    return entry


def run_proteinaln2nucl(td, gap_open, gap_extend):
    """metaeuk_tpu's proteinaln2nucl at the gap costs on the fixture of
    tests/test_offsetaln.py; returns the sha256 of its output DB."""
    from metaeuk_tpu.pipeline.offsetaln import proteinaln2nucl
    u = ROOT / "tests" / "golden" / "utils"
    subprocess.run([sys.executable, "-m", "metaeuk_tpu.cli", "translatenucs",
                    str(u / "orfs"), str(td / "orfsaa")], check=True,
                   capture_output=True, cwd=ROOT,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    proteinaln2nucl(str(u / "orfs"), str(u / "orfs"), str(td / "orfsaa"),
                    str(td / "orfsaa"), str(u / "orfself_aln"),
                    str(td / "p2n"), gap_open=gap_open,
                    gap_extend=gap_extend)
    return db_sha256(td / "p2n")


def main():
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    out = {"command": COMMAND, "fit_defaults": FIT_DEFAULTS,
           "proteinaln2nucl_gaps": list(P2N_GAPS)}
    with ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = {s: ex.submit(_run, s, FIT_DEFAULTS) for s in GUMBEL_SYSTEMS}
        out["systems"] = {s: f.result() for s, f in futs.items()}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
