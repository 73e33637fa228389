# Copy of metaeuk_tpu/pipeline/databases.py; it differs from its original only in this note.
"""databases: the curated reference-database catalog.

Port of lib/mmseqs/src/workflow/Databases.cpp. The catalog entries
(name, description, citation, URL, taxonomy flag, dbtype) match the
reference's table; `list_tsv()` is byte-identical to
`databases --tsv 1` (tests/golden/databases.tsv).

Downloading needs network egress, which deployment hosts often lack
(and the reference's wget would equally fail there); `download()`
therefore supports `local_file=` to build the database from an
already-fetched FASTA (+ optional NCBI taxdump directory for taxonomy
databases) through the same createdb/createtaxdb path the reference's
databases.sh uses, and raises a clear error otherwise.
"""

import os

_AA = "Aminoacid"
_NUCL = "Nucleotide"
_PROF = "Profile"

# name, dbtype, taxonomy, url, description
CATALOG = [
    ("UniRef100", _AA, True, "https://www.uniprot.org/help/uniref",
     "The UniProt Reference Clusters provide clustered sets of sequences "
     "from the UniProt Knowledgebase."),
    ("UniRef90", _AA, True, "https://www.uniprot.org/help/uniref",
     "The UniProt Reference Clusters provide clustered sets of sequences "
     "from the UniProt Knowledgebase."),
    ("UniRef50", _AA, True, "https://www.uniprot.org/help/uniref",
     "The UniProt Reference Clusters provide clustered sets of sequences "
     "from the UniProt Knowledgebase."),
    ("UniProtKB", _AA, True, "https://www.uniprot.org/help/uniprotkb",
     "The UniProt Knowledgebase is the central hub for the collection of "
     "functional information on proteins."),
    ("UniProtKB/TrEMBL", _AA, True,
     "https://www.uniprot.org/help/uniprotkb",
     "UniProtKB/TrEMBL (unreviewed) contains protein sequences associated "
     "with computationally generated annotation."),
    ("UniProtKB/Swiss-Prot", _AA, True, "https://uniprot.org",
     "UniProtKB/Swiss-Prot (reviewed) is a high quality manually "
     "annotated and non-redundant protein sequence database."),
    ("NR", _AA, True, "https://ftp.ncbi.nlm.nih.gov/blast/db/FASTA",
     "Non-redundant protein sequences from GenPept, Swissprot, PIR, PDF, "
     "PDB, and NCBI RefSeq."),
    ("NT", _NUCL, False, "https://ftp.ncbi.nlm.nih.gov/blast/db/FASTA",
     "Partially non-redundant nucleotide sequences from all traditional "
     "divisions of GenBank, EMBL, and DDBJ."),
    ("GTDB", _AA, True, "https://gtdb.ecogenomic.org",
     "Genome Taxonomy Database is a phylogenetically consistent, "
     "genome-based taxonomy."),
    ("PDB", _AA, False, "https://www.rcsb.org",
     "The Protein Data Bank is the single worldwide archive of "
     "structural data of biological macromolecules."),
    ("PDB70", _PROF, False, "https://github.com/soedinglab/hh-suite",
     "PDB clustered to 70% sequence identity and enriched using HHblits "
     "with Uniclust sequences."),
    ("Pfam-A.full", _PROF, False, "https://pfam.xfam.org",
     "The Pfam database is a large collection of protein families, each "
     "represented by multiple sequence alignments and HMMs."),
    ("Pfam-A.seed", _PROF, False, "https://pfam.xfam.org",
     "The Pfam database is a large collection of protein families, each "
     "represented by multiple sequence alignments and HMMs."),
    ("Pfam-B", _PROF, False,
     "https://xfam.wordpress.com/2020/06/30/a-new-pfam-b-is-released",
     "Pfam-B families from the MMseqs2-based Pfam-B build."),
    ("CDD", _PROF, False,
     "https://www.ncbi.nlm.nih.gov/Structure/cdd/cdd.shtml",
     "Conserved Domain Database is a protein annotation resource of "
     "well-annotated MSA models."),
    ("eggNOG", _PROF, False, "http://eggnog5.embl.de",
     "eggNOG is a hierarchical, functionally and phylogenetically "
     "annotated orthology resource."),
    ("VOGDB", _PROF, False, "https://vogdb.org",
     "VOGDB is a continuously updated resource of Virus Orthologous "
     "Groups."),
    ("dbCAN2", _PROF, False, "http://bcb.unl.edu/dbCAN2",
     "dbCAN2 is a database of automated carbohydrate-active enzyme "
     "annotation."),
    ("SILVA", _NUCL, True, "https://www.arb-silva.de",
     "SILVA provides comprehensive, quality checked and regularly "
     "updated datasets of aligned small and large subunit rRNA."),
    ("Resfinder", _NUCL, False,
     "https://cge.cbs.dtu.dk/services/ResFinder",
     "ResFinder identifies acquired antimicrobial resistance genes."),
    ("Kalamari", _NUCL, True, "https://github.com/lskatz/Kalamari",
     "Kalamari is a curated database of completed assemblies of "
     "pathogens and their hosts."),
]


def list_tsv():
    """listDatabasesTsv (Databases.cpp:237-252), byte-identical."""
    return "".join(f"{n}\t{t}\t{'true' if tax else 'false'}\t{u}\n"
                   for n, t, tax, u, _ in CATALOG)


def list_table():
    """The human-readable table part of the usage listing
    (Databases.cpp:180-235)."""
    name_w = max(len("Name"), max(len(d[0]) for d in CATALOG))
    type_w = max(len("Type"), max(len(d[1]) for d in CATALOG))
    lines = [f"  {'Name'.ljust(name_w)}\t{'Type'.ljust(type_w)}\t"
             f"Taxonomy\tUrl"]
    for n, t, tax, u, _ in CATALOG:
        lines.append(f"- {n.ljust(name_w)}\t{t.ljust(type_w)}\t"
                     f"{'yes' if tax else '-':>8}\t{u}")
    return "\n".join(lines) + "\n"


def _sed_lookup(lookup_path, suffix):
    """databases.sh:344-346 SED_FIX_LOOKUP: strip a member-name suffix
    from every lookup entry (sed 's|<suffix>||g')."""
    if not os.path.exists(lookup_path):
        return
    with open(lookup_path) as f:
        text = f.read()
    with open(lookup_path, "w") as f:
        f.write(text.replace(suffix, ""))


def _pdb70_tar_to_msadb(tar_path, msa_db):
    """The PDB70 awk repack (databases.sh:167): extract
    pdb70_a3m.ffdata from the tar, strip NULs, split a3m entries at
    their >ss_* records (the ss_ header and its ONE sequence line are
    dropped; msa2profile re-drops any remaining ss_ members), keep only
    the first whitespace token of each entry's first header, and write
    an MSA DB whose keys start at 2 (the awk increments before the
    first write)."""
    import tarfile
    from ..io import mmseqsdb

    with tarfile.open(tar_path) as tf:
        member = next(m for m in tf.getmembers()
                      if m.name.endswith("pdb70_a3m.ffdata"))
        data = tf.extractfile(member).read().replace(b"\x00", b"")
    entries = []
    cur = None
    inss = False
    entry_open = False
    for line in data.splitlines():
        if line.startswith(b">ss_"):
            inss = True
            entry_open = False
            continue
        if inss:
            inss = False
            continue
        if line.startswith(b">") and not entry_open:
            if cur is not None:
                entries.append(bytes(cur))
            cur = bytearray(b">" + line[1:].split()[0] + b"\n")
            entry_open = True
            continue
        if entry_open and cur is not None:
            cur.extend(line + b"\n")
    if cur is not None:
        entries.append(bytes(cur))
    payloads = [(k + 2, e) for k, e in enumerate(entries)]
    mmseqsdb.write_db(msa_db, payloads, 11)  # DBTYPE_MSA_DB
    return msa_db


def download(name, out_db, tmp, local_file=None, taxdump_dir=None,
             tax_mapping=None):
    """Build a catalog database. With `local_file` (an already-fetched
    FASTA), runs the same createdb (+ createtaxdb for taxonomy DBs)
    pipeline as the reference's databases.sh post-download steps; plain
    downloading is refused on hosts without network egress."""
    entry = next((d for d in CATALOG if d[0] == name), None)
    if entry is None:
        names = ", ".join(d[0] for d in CATALOG)
        raise ValueError(f"unknown database {name!r}; available: {names}")
    if local_file is None:
        raise RuntimeError(
            f"downloading {name} needs network egress; fetch "
            f"{entry[3]} elsewhere and pass local_file=<fasta>")
    from ..cli import main
    os.makedirs(tmp, exist_ok=True)
    if entry[1] == _PROF:
        # profile entries: the databases.sh MSA post-processing chains
        # (databases.sh:321-357) on the pre-fetched archive.
        # STOCKHOLM_MSA (Pfam-A.*): convertmsa -> msa2profile;
        # FASTA_MSA (Pfam-B/CDD/dbCAN2): tar2db -> msa2profile
        # (--skip-query for CDD); A3M (PDB70): msa2profile --msa-type 1
        msa_db = os.path.join(tmp, "msa")
        stockholm = {"Pfam-A.full", "Pfam-A.seed", "VOGDB"}
        a3m = {"PDB70"}
        if name in stockholm:
            if main(["convertmsa", str(local_file), msa_db]) != 0:
                raise RuntimeError("convertmsa failed")
            args = ["msa2profile", msa_db, str(out_db),
                    "--match-mode", "1", "--match-ratio", "0.5"]
        elif name in a3m:
            # PDB70: the tar's pdb70_a3m.ffdata is repacked into an MSA
            # DB (databases.sh:167's awk: NULs stripped, each a3m entry
            # begins at its >ss_ record, ss_ records dropped by
            # msa2profile later, keys start at 2), then
            # msa2profile --msa-type 1
            src = str(local_file)
            if src.endswith((".tar.gz", ".tgz", ".tar")):
                _pdb70_tar_to_msadb(src, msa_db)
                src = msa_db
            args = ["msa2profile", src, str(out_db),
                    "--match-mode", "1", "--match-ratio", "0.5",
                    "--msa-type", "1"]
        else:  # FASTA_MSA tarballs
            if main(["tar2db", str(local_file), msa_db,
                     "--output-dbtype", "11"]) != 0:
                raise RuntimeError("tar2db failed")
            # databases.sh SED_FIX_LOOKUP per catalog entry: strip the
            # tar member suffix from the lookup names
            suffix = {"CDD": ".FASTA", "dbCAN2": ".aln",
                      "VOGDB": ".msa"}.get(name)
            if suffix:
                _sed_lookup(msa_db + ".lookup", suffix)
            args = ["msa2profile", msa_db, str(out_db),
                    "--match-mode", "1", "--match-ratio", "0.5"]
            if name == "CDD":
                args.append("--skip-query")
        if main(args) != 0:
            raise RuntimeError("msa2profile failed")
        return out_db
    rc = main(["createdb", str(local_file), str(out_db)])
    if rc != 0:
        raise RuntimeError("createdb failed")
    if entry[2] and taxdump_dir and tax_mapping:
        from ..tax.mmtax import createtaxdb
        createtaxdb(str(out_db), str(tmp), ncbi_tax_dump=str(taxdump_dir),
                    tax_mapping_file=str(tax_mapping))
    return out_db
