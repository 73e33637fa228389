"""Writes tests/golden/ungapped_slice.json: the sha256 of the four outputs of
metaeuk_tpu's EasyPredict(Params(prefilter_mode="ungapped")) on tests/data
and on the synthetic metagenome make_metagenome(0.01, 500), on the CPU.

    python3 tests/golden/make_ungapped_slice.py > tests/golden/ungapped_slice.json

metaeuk_tpu_torch's ungapped easy-predict must give the same digests
(chip_smoke.py holds the port to them on the card).
"""

import hashlib
import json
import pathlib
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from metaeuk_tpu.params import Params  # noqa: E402
from metaeuk_tpu.pipeline.predict import EasyPredict  # noqa: E402
from tools.make_metagenome import make_metagenome, write_fasta  # noqa: E402

SUFFIXES = ("fas", "codon.fas", "headersMap.tsv", "gff")
COMMAND = "python3 tests/golden/make_ungapped_slice.py"
METAGENOME = dict(mbp=0.01, targets=500, seed=20260820)


def digests(contigs, targets, out):
    EasyPredict(Params(prefilter_mode="ungapped")).run(str(contigs),
                                                       str(targets), str(out))
    return {s: hashlib.sha256(pathlib.Path(f"{out}.{s}").read_bytes())
            .hexdigest() for s in SUFFIXES}


def main():
    with tempfile.TemporaryDirectory() as td:
        td = pathlib.Path(td)
        fixture = digests(ROOT / "tests" / "data" / "contigs.fna",
                          ROOT / "tests" / "data" / "proteins.faa",
                          td / "fixture")
        contigs, proteins = make_metagenome(METAGENOME["mbp"],
                                            METAGENOME["targets"],
                                            METAGENOME["seed"])
        write_fasta(td / "c.fna", contigs)
        write_fasta(td / "p.faa", proteins)
        meta = digests(td / "c.fna", td / "p.faa", td / "meta")
    print(json.dumps({
        "command": COMMAND,
        "params": {"prefilter_mode": "ungapped"},
        "fixture": {"contigs": "tests/data/contigs.fna",
                    "targets": "tests/data/proteins.faa", "sha256": fixture},
        "metagenome": {**METAGENOME, "sha256": meta},
    }, indent=1))


if __name__ == "__main__":
    main()
