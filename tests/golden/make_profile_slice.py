"""The profile slice: an HMM-profile DB made from a synthetic metagenome's
target proteins, and tests/golden/profile_slice.json.

write_profile_db() writes an MMseqs HMM-profile DB (DBTYPE_HMM_PROFILE,
headers in <db>_h) with one profile per protein. For residue s_i of a
protein, its 25-byte record (metaeuk_tpu_torch/io/profiledb.py) holds the
20 raw scores clip(4 * BLOSUM62[s_i][a] + u, -128, 127), u drawn per cell
from integers(-6, 7) of a generator seeded with PROFILE_SLICE's
noise_seed, then s_i as the query and the consensus residue (encoded
indices, as tests/golden/profile/profileDB stores them), a Neff byte of 1
and gap-del and gap-ins bytes of 0. It uses numpy and the port's io and
data modules only, so chip_smoke.py can build the slice on the card.

Run as a script, it writes the sha256 of the four outputs of metaeuk_tpu's
EasyPredict on the CPU against that profile DB, for PROFILE_SLICE's
contigs (make_metagenome(1.6, 3000, 20260820), the k-mer slice's), and the
sha256 of the result DB of metaeuk_tpu's slice_search_db with backtraces
on the enrich fixture (tests/data/queries_lin.faa as a sequence DB
against tests/golden/enrich/profdb):

    python3 tests/golden/make_profile_slice.py > tests/golden/profile_slice.json

metaeuk_tpu_torch must give the same digests (chip_smoke.py phases 4d and
5d hold the port to them on the card).
"""

import hashlib
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SUFFIXES = ("fas", "codon.fas", "headersMap.tsv", "gff")
DB_SUFFIXES = ("", ".index", ".dbtype")
COMMAND = "python3 tests/golden/make_profile_slice.py"
PROFILE_SLICE = dict(mbp=1.6, targets=3000, seed=20260820,
                     noise_seed=20260826)
# the slice_search_db fixture: queries and profile DB of tests/test_enrich.py
SEARCH_QUERIES = ROOT / "tests" / "data" / "queries_lin.faa"
SEARCH_PROFILES = ROOT / "tests" / "golden" / "enrich" / "profdb"


def write_profile_db(proteins, path, noise_seed):
    """An HMM-profile DB at `path` (+ `path`_h) of one profile per (name,
    AA bytes) protein, keys 0..n-1, records as the module docstring says."""
    from metaeuk_tpu_torch.data.submat import BLOSUM62_SCORES, encode_aa
    from metaeuk_tpu_torch.io import mmseqsdb

    rng = np.random.default_rng(noise_seed)
    blosum = np.asarray(BLOSUM62_SCORES, np.int64)[:, :20]
    entries, headers = [], []
    for k, (name, seq) in enumerate(proteins):
        s = np.asarray(encode_aa(seq), np.int64)
        rec = np.zeros((len(s), 25), np.int8)
        rec[:, :20] = np.clip(4 * blosum[s]
                              + rng.integers(-6, 7, (len(s), 20)), -128, 127)
        rec[:, 20] = rec[:, 21] = s
        rec[:, 22] = 1
        entries.append((k, rec.tobytes()))
        headers.append((k, name.encode() + b"\n"))
    mmseqsdb.write_db(str(path), entries, mmseqsdb.DBTYPE_HMM_PROFILE)
    mmseqsdb.write_db(f"{path}_h", headers, mmseqsdb.DBTYPE_GENERIC)


def write_query_db(fasta, path):
    """A sequence DB of the AA FASTA `fasta` at `path`, keys 0..n-1."""
    from metaeuk_tpu_torch.io import mmseqsdb
    from metaeuk_tpu_torch.io.seqdb import DBTYPE_AA, SeqDB

    mmseqsdb.write_seqdb(str(path), SeqDB.from_fasta(str(fasta), DBTYPE_AA))


def profile_slice(cfg, td):
    """Writes cfg's contigs to td/c.fna and their targets' profile DB to
    td/profdb; returns (contigs path, profile DB path)."""
    from tools.make_metagenome import make_metagenome, write_fasta

    contigs, proteins = make_metagenome(cfg["mbp"], cfg["targets"],
                                        cfg["seed"])
    td = pathlib.Path(td)
    write_fasta(td / "c.fna", contigs)
    write_profile_db(proteins, td / "profdb", cfg["noise_seed"])
    return td / "c.fna", td / "profdb"


def sha256(path):
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from metaeuk_tpu.params import Params
    from metaeuk_tpu.pipeline.predict import EasyPredict
    from metaeuk_tpu.search.profile_search import slice_search_db

    out = {"command": COMMAND, "input": PROFILE_SLICE}
    with tempfile.TemporaryDirectory() as td:
        td = pathlib.Path(td)
        contigs, profdb = profile_slice(PROFILE_SLICE, td)
        t0 = time.perf_counter()
        EasyPredict(Params()).run(str(contigs), str(profdb), str(td / "pp"))
        out["jax_cpu_seconds"] = round(time.perf_counter() - t0, 1)
        out["sha256"] = {s: sha256(f"{td / 'pp'}.{s}") for s in SUFFIXES}
        write_query_db(SEARCH_QUERIES, td / "qdb")
        slice_search_db(str(td / "qdb"), str(SEARCH_PROFILES),
                        str(td / "slice"))
        out["slice_search"] = {"sha256": {
            s: sha256(f"{td / 'slice'}{s}") for s in DB_SUFFIXES}}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
