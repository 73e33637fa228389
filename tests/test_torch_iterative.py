"""The port's iterative profile search (search --num-iterations) and its
profile-query aligner against metaeuk_tpu.

ProfileQueryAligner runs K1/K2's uncapped PSSM instances (ops/sw_cuda.py
align_full_prof with cap=None), as the JAX aligner runs sw_jax's
sw_align_batch_prof, which does not cap H at 32767: their plain versions
are held to sw_align_batch_prof past the cap, and the port's aligner to the
JAX one on a profile DB that reaches it. search --num-iterations through
the port's CLI gives the reference's goldens (tests/golden/pref/iter*), and
iterative_search equals the JAX package's, intermediates included, on
tests/test_iterative.py's family. All on the CPU (device cpu: the kernels'
plain versions); the tolerance everywhere is exact equality. The CUDA
instances and the iterative search on the card are marked gpu.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from metaeuk_tpu.io.profiledb import ProfileDB as JaxProfileDB
from metaeuk_tpu.io.seqdb import DBTYPE_AA
from metaeuk_tpu.io.seqdb import SeqDB as JaxSeqDB
from metaeuk_tpu.ops.sw_jax import sw_align_batch_prof
from metaeuk_tpu.params import Params as JaxParams
from metaeuk_tpu.search import profile_align as jax_align
from metaeuk_tpu.search.iterative import iterative_search as jax_iterative
from metaeuk_tpu_torch.cli import main
from metaeuk_tpu_torch.data.submat import ALPHABET
from metaeuk_tpu_torch.io.mmseqsdb import read_db
from metaeuk_tpu_torch.io.profiledb import ProfileDB
from metaeuk_tpu_torch.io.seqdb import SeqDB
from metaeuk_tpu_torch.ops import sw_cuda, sw_torch
from metaeuk_tpu_torch.params import Params
from metaeuk_tpu_torch.search import profile_align
from metaeuk_tpu_torch.search.iterative import iterative_search

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests" / "golden"))
import chip_smoke  # noqa: E402
import make_iter_slice as mis  # noqa: E402

DATA = ROOT / "tests" / "data"
PREF = ROOT / "tests" / "golden" / "pref"
DB_SUFFIXES = ("", ".index", ".dbtype")
FIELDS = ("score", "q_start", "q_end", "t_start", "t_end")
NOCAP = ("sw_pair_ends_prof_nocap", "sw_pair_starts_prof_nocap")
CPU = ["--device", "cpu"]
CAP_RUN = 1100     # rows of the profile that passes the cap
CAP_WIDTH = 1152   # its (Lq, Lt) bucket in the aligner


def _cap_case():
    """numpy (prof, q_len, t, t_len) at the bucket width: pair 0 is the
    1,100-row profile of tests/test_torch_profile.py's cap test (31 on its
    own residue, -32 on every other) against the fragment of those
    residues, whose run passes 32767 at row and column 1056 and ends at
    34,100; pair 1 never aligns (-5 on every residue)."""
    rng = np.random.default_rng(CAP_RUN)
    n, L = CAP_RUN, CAP_WIDTH
    t = np.zeros((2, L), np.int32)
    t[:, :n] = rng.integers(0, 20, n)
    prof = np.full((2, L, 21), -32, np.int32)
    prof[0, np.arange(n), t[0, :n]] = 31
    prof[1] = -5
    prof[:, :, 20] = 0
    ql = tl = np.array([n, n], np.int32)
    return prof, ql, t, tl


# sw_align_batch_prof's answer on _cap_case: the hit past the cap, and the
# pair that never aligns (score 0, starts -1, q_end Lq - 1, t_end -1)
CAP_EXPECT = [[34100, 0], [0, -1], [1099, CAP_WIDTH - 1], [0, -1],
              [1099, -1]]


def _as_lists(outs):
    return [[int(v) for v in np.asarray(o)] for o in outs]


def test_uncapped_plain_prof_matches_sw_align_batch_prof():
    prof, ql, t, tl = _cap_case()
    assert _as_lists(sw_align_batch_prof(prof, ql, t, tl)) == CAP_EXPECT
    args = [torch.from_numpy(a) for a in (prof, ql, t, tl)]
    assert _as_lists(sw_torch.align_full_prof(*args, cap=None)) == \
        CAP_EXPECT
    # the wrapper on staged matrices, pairs read by index: on a CPU tensor
    # the uncapped plain versions, counted under the new instances' names;
    # the capped entries (ProfileSearchDriver's) still stop at 32767
    li = lj = torch.tensor([1, 0], dtype=torch.int32)
    sw_cuda.reset_counts()
    got = sw_cuda.align_full_prof(*args, li, lj, cap=None)
    assert _as_lists(got) == [v[::-1] for v in CAP_EXPECT]
    assert [sw_cuda.PLAIN_CALLS[k] for k in NOCAP] == [1, 1]
    capped = sw_cuda.align_full_prof(*args, li, lj)
    assert _as_lists(capped)[0] == [0, 32767]
    assert _as_lists(capped)[2] == [CAP_WIDTH - 1, 1056]
    with pytest.raises(ValueError, match="32767 or not at all"):
        sw_cuda.sw_ends_prof(*args, li, lj, cap=1000)


def _decode(codes):
    return "".join(ALPHABET[c] for c in codes)


@pytest.fixture(scope="module")
def cap_dbs(tmp_path_factory):
    """A profile DB whose first profile is _cap_case's 1,100-row profile
    and whose others are random PSSMs of 40-300 rows, in memory for both
    packages; the targets (the cap profile's residues, then stretches of
    the other profiles' best residues and random proteins) as FASTA."""
    rng = np.random.default_rng(34100)
    prof, _, t, _ = _cap_case()
    pssms = [prof[0, :CAP_RUN]]
    for n in rng.integers(40, 300, 5):
        p = rng.integers(-12, 8, (n, 21)).astype(np.int32)
        p[:, 20] = 0
        pssms.append(p)
    seqs = [p[:, :20].argmax(1).astype(np.uint8) for p in pssms]
    seqs[0] = t[0, :CAP_RUN].astype(np.uint8)
    targets = [_decode(seqs[0])]
    for s in seqs[1:]:
        a = int(rng.integers(0, len(s) // 2))
        targets.append(_decode(rng.integers(0, 20, 30)) +
                       _decode(s[a:a + 80]) + _decode(rng.integers(0, 20, 40)))
    targets += [_decode(rng.integers(0, 20, n))
                for n in rng.integers(50, 400, 4)]
    fasta = tmp_path_factory.mktemp("cap") / "targets.faa"
    fasta.write_text("".join(f">t{i}\n{s}\n" for i, s in enumerate(targets)))

    def profiles(cls):
        return cls([p.copy() for p in pssms], [s.copy() for s in seqs],
                   [s.copy() for s in seqs],
                   [f"p{i}\n".encode() for i in range(len(pssms))],
                   list(range(len(pssms))))
    return profiles, fasta, len(targets)


def test_profile_query_aligner_past_the_cap_matches_jax(cap_dbs):
    """The port's ProfileQueryAligner (uncapped PSSM instances) equals the
    JAX one, every field, backtraces and sequence identities, on every pair
    of cap_dbs; the cap profile's self-hit scores 34,100 with its end at
    (1099, 1099) in both."""
    profiles, fasta, n_targets = cap_dbs
    pairs = [(0, 0), (0, 3)] + [(p, t) for p in range(1, 6)
                                for t in range(n_targets)]
    ref_al = jax_align.ProfileQueryAligner(
        JaxParams(aln_len_thr=0), profiles(JaxProfileDB),
        JaxSeqDB.from_fasta(fasta, DBTYPE_AA))
    sw_cuda.reset_counts()
    got_al = profile_align.ProfileQueryAligner(
        Params(aln_len_thr=0), profiles(ProfileDB),
        SeqDB.from_fasta(fasta, DBTYPE_AA), "cpu")
    ref, got = ref_al.search(pairs), got_al.search(pairs)
    assert min(sw_cuda.PLAIN_CALLS[k] for k in NOCAP) > 0
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends_prof"] == 0
    assert len(ref) > 1 and ref.dtype == got.dtype
    for name in ref.dtype.names:
        np.testing.assert_array_equal(ref[name], got[name], name)
    top = got[(got["orf_idx"] == 0) & (got["target_idx"] == 0)]
    assert [int(top[0][k]) for k in ("score_raw", "q_start", "q_end",
                                     "t_start", "t_end")] == \
        [34100, 0, 1099, 0, 1099]
    ref_bt, ref_id = ref_al.backtraces(ref)
    got_bt, got_id = got_al.backtraces(got)
    assert ref_bt == got_bt and all(got_bt)
    np.testing.assert_array_equal(ref_id, got_id)


@pytest.fixture(scope="module")
def fixture_db(tmp_path_factory):
    td = tmp_path_factory.mktemp("iterdb")
    assert main(["createdb", str(DATA / "proteins.faa"), str(td / "pdb")]) \
        == 0
    return td / "pdb"


@pytest.mark.parametrize("tag,its", [("iter2", 2), ("iter3", 3),
                                     ("iterfam2", 2), ("iterfam3", 3)])
def test_iterative_search_cli_matches_the_golden(fixture_db, tmp_path, tag,
                                                 its):
    """search --num-iterations N -a through the port's CLI against the
    reference's blastpgp.sh chain (tests/test_iterative.py's goldens): the
    fixture proteins against themselves, or the pfQ / pfT family DBs."""
    q, t = (fixture_db, fixture_db) if tag in ("iter2", "iter3") else \
        (PREF / "pfQ", PREF / "pfT")
    sw_cuda.reset_counts()
    assert main(["search", str(q), str(t), str(tmp_path / "res"),
                 str(tmp_path / "tmp"), "--num-iterations", str(its), "-a",
                 "--device", "cpu"]) == 0
    for s in DB_SUFFIXES:
        assert pathlib.Path(f"{tmp_path / 'res'}{s}").read_bytes() == \
            pathlib.Path(f"{PREF / tag}{s}").read_bytes(), s
    # step 0 realigns on K1/K2's uncapped instances; a profile step aligns
    # (on their PSSM twins) where subtractdbs leaves it pairs
    plain = sw_cuda.PLAIN_CALLS
    profile_pairs = sum(len(p.splitlines()) for step in range(1, its)
                        for _, p in read_db(str(tmp_path / "tmp" /
                                                f"pref_{step}")))
    assert plain["sw_pair_ends_nocap"] > 0
    assert (plain[NOCAP[0]] > 0) == (profile_pairs > 0)
    assert plain["sw_pair_ends_prof"] == 0


AA = "ACDEFGHIKLMNPQRSTVWY"


def _mutate(rng, s, rate):
    out = list(s)
    for i in rng.choice(len(out), int(len(out) * rate), replace=False):
        out[i] = AA[rng.integers(20)]
    return "".join(out)


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    """tests/test_iterative.py's family: a query, six near members, one
    remote member and four decoys, as sequence DBs (the port's createdb,
    a copy of the JAX package's)."""
    td = tmp_path_factory.mktemp("family")
    rng = np.random.default_rng(77)
    base = "".join(rng.choice(list(AA), 120))
    near = [_mutate(rng, base, 0.15) for _ in range(6)]
    remote = _mutate(rng, base, 0.45)
    decoys = ["".join(rng.choice(list(AA), 120)) for _ in range(4)]
    (td / "query.faa").write_text(f">Q\n{base}\n")
    with open(td / "targets.faa", "w") as f:
        for i, s in enumerate(near):
            f.write(f">N{i}\n{s}\n")
        f.write(f">REMOTE\n{remote}\n")
        for i, s in enumerate(decoys):
            f.write(f">D{i}\n{s}\n")
    for fasta, db in (("query.faa", "qdb"), ("targets.faa", "tdb")):
        assert main(["createdb", str(td / fasta), str(td / db)]) == 0
    return td


@pytest.mark.parametrize("its", [1, 3])
def test_iterative_search_matches_jax_on_the_family(family, tmp_path, its):
    """iterative_search of the port (on the CPU) and of metaeuk_tpu on the
    same DBs: the result DB and every intermediate DB byte-identical."""
    q, t = str(family / "qdb"), str(family / "tdb")
    runs = {}
    for name, fn, kw in (("jax", jax_iterative, {}),
                         ("port", iterative_search, {"device": "cpu"})):
        d = tmp_path / name
        fn(q, t, str(d / "res"), str(d / "tmp"), num_iterations=its,
           evalue=1e-4, **kw)
        runs[name] = {p.relative_to(d): p.read_bytes()
                      for p in sorted(d.rglob("*")) if p.is_file()}
    assert len(runs["jax"]) >= 3 * (1 + 3 * (its - 1))
    assert runs["port"] == runs["jax"]
    assert read_db(str(tmp_path / "port" / "res"))


def test_chip_smoke_iter_run_on_cpu(tmp_path):
    """chip_smoke.py's phase 5g on the pfQ / pfT family, on the CPU: the
    slice's arguments (make_iter_slice.ITER_SLICE, three iterations) give
    the reference's golden through run_iter_slice, whose stage seconds
    split by step and whose profile-step pairs match the prefilter DBs;
    then (b)'s check_iter_sample on the last profile step."""
    from metaeuk_tpu_torch import cli
    argv = mis.search_args(mis.ITER_SLICE, PREF / "pfQ", PREF / "pfT",
                           tmp_path / "res", tmp_path / "tmp")
    run, last = chip_smoke.run_iter_slice(torch, cli, argv + CPU)
    for s in DB_SUFFIXES:
        assert pathlib.Path(f"{tmp_path / 'res'}{s}").read_bytes() == \
            pathlib.Path(f"{PREF / 'iterfam3'}{s}").read_bytes(), s
    counts, digests = mis.summary(mis.ITER_SLICE, tmp_path / "res",
                                  tmp_path / "tmp", read_db)
    assert sorted(digests) == sorted(counts) == sorted(
        mis.step_dbs(mis.ITER_SLICE, "res", "tmp"))
    st = run["stages"]
    assert sorted(st) == ["step 0", "step 1", "step 2"]
    assert {"k-mer prefilter", "align", "realign", "result2profile"} <= \
        set(st["step 0"])
    assert {"profile prefilter", "subtractdbs", "ProfileQueryAligner.search",
            "backtraces", "mergedbs", "result2profile"} <= set(st["step 1"])
    assert "result2profile" not in st["step 2"]
    for step in (1, 2):
        pairs = run["prof_cells"].get(f"step {step}", [0, 0, 0])
        assert pairs[0] == counts[f"pref_{step}"]
        assert pairs[1] >= pairs[2] >= pairs[0]
    assert run["routes"]["realign"]["fwd"][0] == counts["aln_0"]
    n = len(last["pairs"])
    assert n == counts["pref_2"] > 0
    sample = chip_smoke.check_iter_sample(np, torch, sw_cuda, sw_torch,
                                          last, n, 1)
    assert sample[0] == n and sample[2] == counts["aln_2"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_uncapped_prof_instances_match_plain_on_card(cuda_device):
    """K1/K2's uncapped PSSM instances against their plain versions on the
    card: _cap_case (34,100 at (1099, 1099); the capped entries stop at
    32767) and random staged PSSMs read in a shuffled order."""
    prof, ql, t, tl = _cap_case()
    rng = np.random.default_rng(7)
    B, Lq, Lt = 96, 700, 600
    rp = rng.integers(-32, 32, (B, Lq, 21)).astype(np.int32)
    rp[:, :, 20] = 0
    cases = [((prof, ql, t, tl), np.array([0, 1])),
             ((rp, rng.integers(0, Lq + 1, B).astype(np.int32),
               rng.integers(0, 20, (B, Lt)).astype(np.int32),
               rng.integers(0, Lt + 1, B).astype(np.int32)),
              rng.permutation(B))]
    for arrays, perm in cases:
        staged = [torch.from_numpy(a).to(cuda_device) for a in arrays]
        li = torch.from_numpy(perm.astype(np.int32)).to(cuda_device)
        lj = li.flip(0)
        sw_cuda.reset_counts()
        got = sw_cuda.align_full_prof(*staged, li, lj, cap=None)
        torch.cuda.synchronize()
        assert [sw_cuda.LAUNCHES[k] for k in NOCAP] == [1, 1]
        ref = sw_cuda.align_full_prof(*(a.cpu() for a in staged), li.cpu(),
                                      lj.cpu(), cap=None)
        for name, a, b in zip(FIELDS, ref, got):
            assert torch.equal(a, b.cpu()), name
    got = sw_cuda.align_full_prof(*(torch.from_numpy(a).to(cuda_device)
                                    for a in (prof, ql, t, tl)),
                                  *[torch.tensor([0, 1], dtype=torch.int32,
                                                 device=cuda_device)] * 2)
    assert int(got[0][0]) == 32767


@pytest.mark.gpu
@pytest.mark.parametrize("tag,its", [("iter3", 3), ("iterfam2", 2)])
def test_iterative_search_on_card_matches_the_golden(cuda_device,
                                                     fixture_db, tmp_path,
                                                     tag, its):
    """Phase 4g's iterative search: the CLI with --device cuda gives the
    goldens, through K1 and the uncapped PSSM instances, with no plain
    version called."""
    q, t = (fixture_db, fixture_db) if tag == "iter3" else \
        (PREF / "pfQ", PREF / "pfT")
    sw_cuda.reset_counts()
    assert main(["search", str(q), str(t), str(tmp_path / "res"),
                 str(tmp_path / "tmp"), "--num-iterations", str(its), "-a",
                 "--device", "cuda"]) == 0
    torch.cuda.synchronize()
    for s in DB_SUFFIXES:
        assert pathlib.Path(f"{tmp_path / 'res'}{s}").read_bytes() == \
            pathlib.Path(f"{PREF / tag}{s}").read_bytes(), s
    assert min(sw_cuda.LAUNCHES[k] for k in ("sw_pair_ends", *NOCAP)) > 0
    assert not any(sw_cuda.PLAIN_CALLS.values())
