# Copy of metaeuk_tpu/tax/mmtax.py; it differs from its original only in this note.
"""Full-parity NCBI taxonomy stack: the mmseqs-level taxonomy commands.

Host-side (string/tree-heavy, no TPU work): exact behavioural port of the
reference's taxonomy module (lib/mmseqs/src/taxonomy/):

- ``Taxonomy``: NcbiTaxonomy.{h,cpp} — taxdump trio loading
  (splitByDelimiter "\\t|\\t", NcbiTaxonomy.cpp:91-181), merged-node
  aliasing (loadMerged, :452-502), LCA over candidate lists (:313-331),
  AllRanks/AtRanks/taxLineage (:335-413, :434-450), weightedMajorityLCA
  (:639-767), clade counts for reports (:504-545), and the binary
  ``_taxonomy`` serialization (serialize/unserialize :769-844) including
  the Euler tour + sparse-RMQ table and compacted StringBlock
  (commons/StringBlock.h) so our createbintaxonomy output is loadable by
  the reference binary and byte-identical where its padding is defined.
- ``MappingReader``: taxonomy/MappingReader.h — text and binary
  ``_mapping`` (magic {19,0,23,12,0}), first-match lookup semantics.
- ``TaxonomyExpression``: taxonomy/TaxonomyExpression.h — numeric
  shortcut or tinyexpr-style boolean expression over ancestor tests
  (numbers become a(n) calls; ``,`` means OR; ``!``/``&&``/``||``).
- Command bodies: lca/majoritylca (lca.cpp:14-210), aggregatetax /
  aggregatetaxweights (aggregatetax.cpp:15-200), addtaxonomy
  (addtaxonomy.cpp:13-119), filtertaxdb (filtertaxdb.cpp),
  filtertaxseqdb (filtertaxseqdb.cpp), taxonomyreport
  (taxonomyreport.cpp, Kraken-style and Krona modes),
  createbintaxonomy / createdmptaxonomy (createbintaxonomy.cpp),
  createbintaxmapping (createbintaxmapping.cpp), createtaxdb
  (data/workflow/createtaxdb.sh offline paths).
"""

import math
import os
import struct

import numpy as np

from .ncbi import NCBI_RANKS, WeightedTaxHit, WeightedTaxResult

ROOT_TAXID = 1
ROOT_RANK = 2 ** 31 - 1  # INT_MAX sentinel (NcbiTaxonomy.cpp:592)

# NcbiShortRanks (NcbiTaxonomy.h:81-88)
SHORT_RANKS = {"species": "s", "genus": "g", "family": "f", "order": "o",
               "class": "c", "phylum": "p", "kingdom": "k",
               "superkingdom": "d"}

MAPPING_MAGIC = bytes([19, 0, 23, 12, 0])  # MappingReader.h:101
SERIALIZATION_VERSION = 2

# default blocked taxa with their required node names
# (Parameters.cpp:2681, verified against node names in dolca, lca.cpp:54-66)
DEFAULT_BLACKLIST = "12908:unclassified sequences,28384:other sequences"

DBTYPE_TAXONOMICAL_RESULT = 8


def _atoi(s):
    """strtol semantics: leading whitespace + digits, stop at first
    non-digit (the last dmp column keeps its '\\t|' tail)."""
    s = s.lstrip()
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    return int(s[:j]) if j > i or (j > 0 and s[:j].isdigit()) else 0


def _split_dmp(line, max_col):
    """splitByDelimiter(line, "\\t|\\t", maxCol) (NcbiTaxonomy.cpp:91-104)."""
    out = []
    prev = 0
    i = 0
    while True:
        pos = line.find("\t|\t", prev)
        if pos == -1:
            pos = len(line)
        out.append(line[prev:pos])
        prev = pos + 3
        i += 1
        if not (pos < len(line) and prev < len(line) and i < max_col):
            break
    return out


class Taxonomy:
    """NcbiTaxonomy with the reference's internal array layout.

    Nodes are stored in nodes.dmp file order (internal ids), ``D`` maps
    taxid -> internal id (-1 absent; merged old ids alias the new node).
    """

    def __init__(self, tax_ids, parent_ids, ranks, names, D, max_taxid):
        self.tax_ids = tax_ids          # list[int], file order
        self.parent_ids = parent_ids    # list[int]
        self.ranks = ranks              # list[str]
        self.names = names              # list[str], "" when unnamed
        self.D = D                      # dict taxid -> internal id
        self.max_taxid = max_taxid
        self._id = {t: i for i, t in enumerate(tax_ids)}

    # -- construction -----------------------------------------------------
    @classmethod
    def from_dumps(cls, names_file, nodes_file, merged_file):
        """NcbiTaxonomy(names, nodes, merged) ctor (NcbiTaxonomy.cpp:31-72).

        Keeps the reference's load order: nodes, merged, names — and its
        append order for rank/name strings (matters for serialization).
        """
        tax_ids, parent_ids, ranks = [], [], []
        max_taxid = 0
        with open(nodes_file) as f:
            for line in f:
                cols = _split_dmp(line.rstrip("\n"), 3)
                tax_id, parent_id = int(cols[0]), int(cols[1])
                tax_ids.append(tax_id)
                parent_ids.append(parent_id)
                ranks.append(cols[2])
                max_taxid = max(max_taxid, tax_id)
        D = {t: i for i, t in enumerate(tax_ids)}
        for p in parent_ids:
            if p not in D:
                raise ValueError(f"inconsistent nodes.dmp: no parent {p}")

        # loadMerged (NcbiTaxonomy.cpp:452-502): only old ids that do not
        # exist, pointing at ids that do
        with open(merged_file) as f:
            for line in f:
                cols = _split_dmp(line.rstrip("\n"), 2)
                if len(cols) != 2:
                    raise ValueError("invalid merged entry")
                old, new = _atoi(cols[0]), _atoi(cols[1])
                if old not in D and new in D:
                    D[old] = D[new]
                    max_taxid = max(max_taxid, old, new)

        names = [""] * len(tax_ids)
        name_order = []  # (internal id, name) in file order, for serialize
        with open(names_file) as f:
            for line in f:
                if "scientific name" not in line:
                    continue
                cols = _split_dmp(line.rstrip("\n"), 2)
                if len(cols) != 2:
                    raise ValueError("invalid name entry")
                tid = _atoi(cols[0])
                if tid not in D:
                    raise ValueError(f"loadNames: taxon {tid} not in nodes")
                names[D[tid]] = cols[1]
                name_order.append((D[tid], cols[1]))

        t = cls(tax_ids, parent_ids, ranks, names, D, max_taxid)
        t._name_order = name_order
        return t

    @classmethod
    def open(cls, db_prefix):
        """openTaxonomy (NcbiTaxonomy.cpp:547-589): binary ``_taxonomy``
        preferred, else the ``_names.dmp/_nodes.dmp/_merged.dmp`` trio."""
        bin_file = f"{db_prefix}_taxonomy"
        if os.path.exists(bin_file):
            with open(bin_file, "rb") as f:
                return cls.from_binary(f.read())
        trio = [f"{db_prefix}_names.dmp", f"{db_prefix}_nodes.dmp",
                f"{db_prefix}_merged.dmp"]
        if not all(os.path.exists(p) for p in trio):
            trio = ["names.dmp", "nodes.dmp", "merged.dmp"]
            if not all(os.path.exists(p) for p in trio):
                raise FileNotFoundError(
                    f"no _taxonomy / taxdump files for {db_prefix}")
        return cls.from_dumps(trio[0], trio[1], trio[2])

    @classmethod
    def from_binary(cls, mem):
        """unserialize (NcbiTaxonomy.cpp:812-844)."""
        p = 0
        version = struct.unpack_from("<i", mem, p)[0]
        p += 4
        if version != SERIALIZATION_VERSION:
            raise ValueError(f"unsupported _taxonomy version {version}")
        max_nodes = struct.unpack_from("<Q", mem, p)[0]
        p += 8
        max_taxid = struct.unpack_from("<i", mem, p)[0]
        p += 4
        nodes = np.frombuffer(mem, dtype=np.int32,
                              count=max_nodes * 8, offset=p)
        nodes = nodes.reshape(max_nodes, 8)
        p += max_nodes * 32
        D_arr = np.frombuffer(mem, dtype=np.int32, count=max_taxid + 1,
                              offset=p)
        p += (max_taxid + 1) * 4
        p += 2 * (max_nodes * 2) * 4        # E, L (recomputable)
        p += max_nodes * 4                  # H
        dim = max_nodes * 2
        k = int(math.floor(math.log2(dim))) + 1
        p += dim * k * 4                    # sparse table M
        # StringBlock<unsigned int> (StringBlock.h:serialize)
        byte_cap = struct.unpack_from("<Q", mem, p)[0]
        p += 8
        entry_cap = struct.unpack_from("<I", mem, p)[0]
        p += 4
        entry_count = struct.unpack_from("<I", mem, p)[0]
        p += 4
        data = mem[p:p + byte_cap]
        p += byte_cap
        offsets = np.frombuffer(mem, dtype=np.uint32, count=entry_cap,
                                offset=p)

        def get_str(idx):
            if idx >= entry_count:
                return ""
            off = int(offsets[idx])
            end = data.find(b"\x00", off)
            return data[off:end].decode()

        tax_ids = [int(nodes[i, 1]) for i in range(max_nodes)]
        parent_ids = [int(nodes[i, 2]) for i in range(max_nodes)]
        # rankIdx at dwords 4-5, nameIdx at 6-7 (size_t each)
        ranks, names = [], []
        for i in range(max_nodes):
            rank_idx = int(nodes[i, 4]) & 0xFFFFFFFF
            name_idx = int(nodes[i, 6]) & 0xFFFFFFFF
            name_hi = int(nodes[i, 7])
            ranks.append(get_str(rank_idx))
            names.append("" if name_hi == -1 else get_str(name_idx))
        D = {t: int(i) for t, i in enumerate(D_arr) if i != -1}
        return cls(tax_ids, parent_ids, ranks, names, D, max_taxid)

    # -- core queries -------------------------------------------------------
    def node_exists(self, taxid):
        return 0 <= taxid <= self.max_taxid and taxid in self.D

    def node_id(self, taxid):
        return self.D[taxid]

    def node_taxid(self, taxid):
        """taxonNode(taxid)->taxId: resolves merged ids; None if absent."""
        if taxid == 0 or not self.node_exists(taxid):
            return None
        return self.tax_ids[self.D[taxid]]

    def rank_of(self, taxid):
        return self.ranks[self.D[taxid]]

    def name_of(self, taxid):
        return self.names[self.D[taxid]]

    def parent_of(self, taxid):
        return self.parent_ids[self.D[taxid]]

    def lineage_internal(self, taxid):
        """Internal ids from taxid up to root (inclusive)."""
        out = []
        i = self.D[taxid]
        while True:
            out.append(i)
            p = self.parent_ids[i]
            if p == self.tax_ids[i]:
                break
            i = self.D[p]
        return out

    def is_ancestor(self, ancestor, child):
        """IsAncestor (NcbiTaxonomy.cpp:282-300)."""
        if ancestor == child:
            return True
        if ancestor == 0 or child == 0:
            return False
        if not (self.node_exists(child) and self.node_exists(ancestor)):
            return False
        anc_int = self.D[ancestor]
        return anc_int in self.lineage_internal(child)

    def lca_pair_internal(self, a, b):
        la = self.lineage_internal(self.tax_ids[a])
        lb = set(self.lineage_internal(self.tax_ids[b]))
        for i in la:
            if i in lb:
                return i
        return self.D[ROOT_TAXID]

    def lca_list(self, taxa):
        """LCA(vector<TaxID>) (NcbiTaxonomy.cpp:313-331): skips ids with
        no node; returns the LCA node's taxid, or None if none valid."""
        it = [t for t in taxa if self.node_exists(t)]
        if not it:
            return None
        red = self.D[it[0]]
        for t in it[1:]:
            red = self.lca_pair_internal(red, self.D[t])
        return self.tax_ids[red]

    # -- lineage formatting ------------------------------------------------
    @staticmethod
    def find_rank_index(rank):
        return NCBI_RANKS.get(rank, -1)

    @staticmethod
    def parse_ranks(ranks_str):
        """parseRanks (NcbiTaxonomy.cpp:363-372)."""
        if not ranks_str:
            return []
        ranks = ranks_str.split(",")
        for r in ranks:
            if r not in NCBI_RANKS:
                raise ValueError(f"invalid taxonomic rank {r}")
        return ranks

    def all_ranks(self, taxid):
        """AllRanks (NcbiTaxonomy.cpp:434-450): rank->name walking up;
        'no rank'/'no_rank' skipped except at the root node itself."""
        result = {}
        i = self.D[taxid]
        while True:
            rank, name = self.ranks[i], self.names[i]
            if self.tax_ids[i] == 1:
                result.setdefault(rank, name)
                return result
            if rank not in ("no_rank", "no rank"):
                result.setdefault(rank, name)
            i = self.D[self.parent_ids[i]]

    def at_ranks(self, taxid, levels):
        """AtRanks (NcbiTaxonomy.cpp:335-361)."""
        all_r = self.all_ranks(taxid)
        base_idx = self.find_rank_index(self.rank_of(taxid))
        base = "uc_" + self.name_of(taxid)
        out = []
        for lvl in levels:
            if lvl in all_r:
                out.append(all_r[lvl])
            elif NCBI_RANKS[lvl] < base_idx:
                out.append(base)
            else:
                out.append("unknown")
        return out

    def tax_lineage(self, taxid, info_as_name=True):
        """taxLineage (NcbiTaxonomy.cpp:390-413): root excluded unless the
        node is the root itself; top-down; ';'-joined."""
        chain = []
        i = self.D[taxid]
        while True:
            chain.append(i)
            p = self.D[self.parent_ids[i]]
            if self.parent_ids[p] == self.tax_ids[p]:
                break
            i = p
        parts = []
        for i in reversed(chain):
            if info_as_name:
                parts.append(SHORT_RANKS.get(self.ranks[i], "-") + "_" +
                             self.names[i])
            else:
                parts.append(str(self.tax_ids[i]))
        return ";".join(parts)

    # -- weighted majority vote (NcbiTaxonomy.cpp:639-767) -------------------
    def weighted_majority_lca(self, set_taxa, majority_cutoff):
        # keyed by the RAW hit taxid (merged ids keep their own entry and
        # flip their parent to candidate via differing child ids —
        # NcbiTaxonomy.cpp:649-686 uses currTaxId, not node->taxId)
        counts = {}  # raw taxid -> [weight, is_candidate, child_taxid]
        assigned = 0
        unassigned = 0
        total = 0.0
        for hit in set_taxa:
            curr = hit.taxon
            if curr == 0 or not self.node_exists(curr):
                unassigned += 1
                continue
            w = hit.weight
            total += w
            assigned += 1
            node = counts.get(curr)
            if node is not None:
                if node[2] != 0:
                    node[1] = True
                    node[2] = 0
                node[0] += w
            else:
                counts[curr] = [w, True, 0]
            parent = self.parent_of(curr)
            while parent != curr:
                node = counts.get(parent)
                if node is not None:
                    if node[2] != curr:
                        node[1] = True
                        node[2] = curr
                    node[0] += w
                else:
                    counts[parent] = [w, False, curr]
                curr = parent
                parent = self.parent_of(curr)

        if total == 0:
            return WeightedTaxResult(0, assigned, unassigned, 0, 0.0)

        selected = 0
        min_rank = ROOT_RANK
        sel_percent = 0.0
        for taxid in sorted(counts):
            weight, is_cand, _child = counts[taxid]
            if not is_cand:
                continue
            percent = weight / total
            if percent >= majority_cutoff:
                curr = taxid
                curr_min = ROOT_RANK
                parent = self.parent_of(curr)
                while parent != curr:
                    ri = self.find_rank_index(self.rank_of(curr))
                    if 0 < ri < curr_min:
                        curr_min = ri
                        break
                    curr = parent
                    parent = self.parent_of(curr)
                if curr_min < min_rank or \
                        (curr_min == min_rank and percent > sel_percent):
                    selected = taxid
                    min_rank = curr_min
                    sel_percent = percent

        if selected == ROOT_TAXID:
            return WeightedTaxResult(selected, assigned, unassigned,
                                     assigned, sel_percent)
        if selected == 0:
            return WeightedTaxResult(0, assigned, unassigned, 0, sel_percent)
        agree = 0
        for hit in set_taxa:
            curr = hit.taxon
            if curr == 0 or not self.node_exists(curr):
                continue
            parent = self.parent_of(curr)
            while parent != curr:
                if curr == selected:
                    agree += 1
                    break
                curr = parent
                parent = self.parent_of(curr)
        return WeightedTaxResult(selected, assigned, unassigned, agree,
                                 sel_percent)

    # -- clade counts for reports (NcbiTaxonomy.cpp:504-545) -----------------
    def parent_to_children(self):
        out = {}
        for i in range(len(self.tax_ids)):
            if self.parent_ids[i] == self.tax_ids[i]:
                continue
            out.setdefault(self.parent_ids[i], []).append(self.tax_ids[i])
        return out

    def clade_counts(self, tax_counts, p2c):
        clade = {}

        def ent(t):
            return clade.setdefault(t, [0, 0, []])  # taxCount, cladeCount

        for taxid, n in tax_counts.items():
            e = ent(taxid)
            e[0] = n
            e[1] += n
            if self.node_exists(taxid):
                curr = self.node_taxid(taxid)
                while self.parent_of(curr) != curr and \
                        self.node_exists(self.parent_of(curr)):
                    curr = self.parent_of(curr)
                    ent(curr)[1] += n
        for taxid, e in clade.items():
            e[2] = p2c.get(taxid, [])
        return clade

    # -- binary serialization (NcbiTaxonomy.cpp:769-810) ---------------------
    def serialize(self):
        """Byte-exact NcbiTaxonomy::serialize for dmp-loaded taxonomies
        (struct padding written as zero — the reference leaves those 4
        bytes per node uninitialized)."""
        n = len(self.tax_ids)

        # Euler tour E/L and first-visit H (elh, NcbiTaxonomy.cpp:184-200)
        children = [[] for _ in range(n)]
        for i in range(n):
            if self.parent_ids[i] != self.tax_ids[i]:
                children[self.D[self.parent_ids[i]]].append(self.tax_ids[i])
        E, L = [], []
        H = [0] * n
        stack = [(ROOT_TAXID, 0, False)]
        while stack:
            taxid, level, exit_visit = stack.pop()
            i = self.D[taxid]
            if exit_visit:
                E.append(self.D[self.parent_ids[i]])
                L.append(level - 1)
                continue
            if H[i] == 0:
                H[i] = len(E)
            E.append(i)
            L.append(level)
            stack.append((taxid, level, True))
            for c in reversed(children[i]):
                stack.append((c, level + 1, False))
        E += [0] * (2 * n - len(E))
        L += [0] * (2 * n - len(L))

        # sparse RMQ table (computeSparseTable, NcbiTaxonomy.cpp:202-248)
        dim = 2 * n
        k = int(math.floor(math.log2(dim))) + 1
        Lk = np.asarray(L, dtype=np.int32)
        M = np.zeros((dim, k), dtype=np.int32)
        M[:, 0] = np.arange(dim, dtype=np.int32)
        col = 1
        while (1 << col) <= dim:
            span = 1 << (col - 1)
            rows = dim - (1 << col) + 1
            a = M[:rows, col - 1]
            b = M[span:span + rows, col - 1]
            M[:rows, col] = np.where(Lk[a] < Lk[b], a, b)
            col += 1

        # StringBlock: appends in load order (ranks then names), compact()'d
        strings = list(self.ranks)
        name_order = getattr(self, "_name_order", None)
        if name_order is None:
            name_order = [(i, self.names[i]) for i in range(n)
                          if self.names[i]]
        strings += [s for _, s in name_order]
        order = sorted(range(len(strings)), key=lambda i: strings[i].encode())
        offsets = [0] * len(strings)
        blob = bytearray()
        prev = None
        prev_off = 0
        for idx in order:
            s = strings[idx]
            if s == prev:
                offsets[idx] = prev_off
            else:
                prev = s
                prev_off = len(blob)
                offsets[idx] = prev_off
                blob += s.encode() + b"\x00"

        rank_idx = offsets[:n]
        name_idx_map = {}
        for (node_i, _s), off in zip(name_order, offsets[n:]):
            name_idx_map[node_i] = off

        out = bytearray()
        out += struct.pack("<i", SERIALIZATION_VERSION)
        out += struct.pack("<Q", n)
        out += struct.pack("<i", self.max_taxid)
        nodes = np.zeros((n, 8), dtype=np.int32)
        for i in range(n):
            nodes[i, 0] = i
            nodes[i, 1] = self.tax_ids[i]
            nodes[i, 2] = self.parent_ids[i]
            # rankIdx/nameIdx are entry indices into the StringBlock in the
            # reference; after compact() getString resolves via offsets —
            # we store entry indices identically
        # entry indices (not offsets) are what TaxonNode carries
        entry_index = {}
        # rank entries are 0..n-1 in append order; name entries follow
        for i in range(n):
            nodes[i, 4] = i
        name_entry = n
        unnamed = np.ones(n, dtype=bool)
        for node_i, _s in name_order:
            nodes[node_i, 6] = name_entry
            unnamed[node_i] = False
            name_entry += 1
        for i in range(n):
            if unnamed[i]:
                nodes[i, 6] = -1
                nodes[i, 7] = -1
        out += nodes.tobytes()
        D_arr = np.full(self.max_taxid + 1, -1, dtype=np.int32)
        for t, i in self.D.items():
            D_arr[t] = i
        out += D_arr.tobytes()
        out += np.asarray(E, dtype=np.int32).tobytes()
        out += np.asarray(L, dtype=np.int32).tobytes()
        out += np.asarray(H, dtype=np.int32).tobytes()
        out += M.tobytes()
        # StringBlock serialize (StringBlock.h): after compact(),
        # byteCapacity = total bytes, entryCapacity = entryCount
        out += struct.pack("<Q", len(blob))
        out += struct.pack("<II", len(strings), len(strings))
        out += bytes(blob)
        out += np.asarray(offsets, dtype=np.uint32).tobytes()
        return bytes(out)


class MappingReader:
    """_mapping lookup (taxonomy/MappingReader.h): text "key\\ttaxid" lines
    or the binary magic format; first entry with dbkey >= key wins."""

    def __init__(self, db, db_input=True):
        path = f"{db}_mapping" if db_input else db
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{db}_mapping does not exist. Please create the taxonomy "
                "mapping!")
        with open(path, "rb") as f:
            data = f.read()
        if len(data) > 5 and data[:5] == MAPPING_MAGIC:
            pairs = np.frombuffer(data, dtype=np.uint32, offset=5)
            self.keys = pairs[0::2].copy()
            self.taxa = pairs[1::2].copy()
        else:
            if not data.strip():
                raise ValueError(f"{db}_mapping is empty")
            keys, taxa = [], []
            for line in data.decode().splitlines():
                cols = line.split()
                keys.append(int(cols[0]))
                taxa.append(int(cols[1]))
            keys = np.asarray(keys, dtype=np.uint32)
            taxa = np.asarray(taxa, dtype=np.uint32)
            order = np.argsort(keys, kind="stable")
            self.keys, self.taxa = keys[order], taxa[order]

    def lookup(self, key):
        i = np.searchsorted(self.keys, key, side="left")
        if i < len(self.keys) and self.keys[i] == key:
            return int(self.taxa[i])
        return 0

    def serialize(self):
        """MappingReader::serialize (MappingReader.h:10-16)."""
        pairs = np.empty(len(self.keys) * 2, dtype=np.uint32)
        pairs[0::2] = self.keys
        pairs[1::2] = self.taxa
        return MAPPING_MAGIC + pairs.tobytes()


class TaxonomyExpression:
    """taxonomy/TaxonomyExpression.h: number = ancestor shortcut; else a
    boolean expression over a(taxid) ancestor tests with !, &&, ||, parens;
    ',' parsed as OR (COMMA_IS_OR default)."""

    def __init__(self, expression, taxonomy):
        self.tax = taxonomy
        expression = expression.strip()
        if expression.lstrip("-").isdigit() and not expression.startswith("-"):
            self.shortcut = int(expression)
            self.tokens = None
            return
        self.shortcut = None
        self.tokens = self._tokenize(expression)

    @staticmethod
    def _tokenize(expr):
        tokens = []
        i = 0
        while i < len(expr):
            c = expr[i]
            if c.isdigit():
                j = i
                while j < len(expr) and expr[j].isdigit():
                    j += 1
                tokens.append(("num", int(expr[i:j])))
                i = j
            elif c == ",":
                tokens.append(("op", "||"))
                i += 1
            elif expr.startswith("||", i) or expr.startswith("&&", i):
                tokens.append(("op", expr[i:i + 2]))
                i += 2
            elif c == "!":
                tokens.append(("op", "!"))
                i += 1
            elif c in "()":
                tokens.append(("op", c))
                i += 1
            elif c.isspace():
                i += 1
            else:
                raise ValueError(f"unsupported taxon expression char {c!r}")
        return tokens

    def is_ancestor(self, taxid):
        if self.shortcut is not None:
            return self.tax.is_ancestor(self.shortcut, taxid)
        self._pos = 0
        self._taxid = taxid
        val = self._or()
        return bool(val)

    def _peek(self):
        return self.tokens[self._pos] if self._pos < len(self.tokens) else None

    def _or(self):
        v = self._and()
        while self._peek() == ("op", "||"):
            self._pos += 1
            rhs = self._and()
            v = v or rhs
        return v

    def _and(self):
        v = self._not()
        while self._peek() == ("op", "&&"):
            self._pos += 1
            rhs = self._not()
            v = v and rhs
        return v

    def _not(self):
        if self._peek() == ("op", "!"):
            self._pos += 1
            return not self._not()
        return self._primary()

    def _primary(self):
        tok = self._peek()
        if tok is None:
            raise ValueError("truncated taxon expression")
        self._pos += 1
        if tok == ("op", "("):
            v = self._or()
            if self._peek() != ("op", ")"):
                raise ValueError("unbalanced parens in taxon expression")
            self._pos += 1
            return v
        if tok[0] == "num":
            return self.tax.is_ancestor(tok[1], self._taxid)
        raise ValueError(f"unexpected token {tok} in taxon expression")


# ---------------------------------------------------------------------------
# command bodies
# ---------------------------------------------------------------------------

def _parse_blacklist(tax, blacklist_str):
    """dolca blacklist parsing (lca.cpp:40-68): "taxid[:name]" entries; a
    name, when given, must match the node's name for the block to apply."""
    out = []
    if not blacklist_str:
        return out
    for item in blacklist_str.split(","):
        head = item.split(":", 1)[0]
        try:
            taxon = int(head)
        except ValueError:
            taxon = 0
        if taxon == 0:
            continue
        if not tax.node_exists(taxon):
            continue
        if ":" in item:
            name = item.split(":", 1)[1]
            if tax.name_of(tax.node_taxid(taxon)) != name:
                continue
        out.append(taxon)
    return out


def _tax_result_suffix(tax, taxid, ranks, show_lineage):
    """The shared taxid/rank/name[+ranks][+lineage] columns."""
    node_tid = tax.node_taxid(taxid)
    parts = [str(node_tid), tax.rank_of(node_tid), tax.name_of(node_tid)]
    if ranks:
        parts.append(";".join(tax.at_ranks(node_tid, ranks)))
    if show_lineage == 1:
        parts.append(tax.tax_lineage(node_tid, True))
    elif show_lineage == 2:
        parts.append(tax.tax_lineage(node_tid, False))
    return "\t".join(parts)


def _no_tax_result(ranks, show_lineage):
    s = "0\tno rank\tunclassified"
    if ranks:
        s += "\t"
    if show_lineage > 0:
        s += "\t"
    return s + "\n"


def lca_db(tax_db, input_db, out_db, majority=False, lca_ranks="",
           tax_lineage=0, blacklist=DEFAULT_BLACKLIST, vote_mode=1,
           majority_thr=0.5, compressed=False):
    """lca / majoritylca (lca.cpp:14-210)."""
    from ..io import mmseqsdb
    from .ncbi import AGG_TAX_UNIFORM, AGG_TAX_MINUS_LOG_EVAL

    tax = Taxonomy.open(tax_db)
    mapping = MappingReader(tax_db)
    entries = mmseqsdb.read_db(input_db)
    dbtype = mmseqsdb.read_dbtype(input_db)
    if majority:
        # DBTYPE_CLUSTER_RES=6, PREFILTER_RES=7, PREFILTER_REV_RES=15
        if vote_mode != AGG_TAX_UNIFORM and dbtype == 6:
            vote_mode = AGG_TAX_UNIFORM
        elif vote_mode == AGG_TAX_MINUS_LOG_EVAL and dbtype in (7, 15):
            vote_mode = AGG_TAX_UNIFORM

    ranks = Taxonomy.parse_ranks(lca_ranks)
    blocked = _parse_blacklist(tax, blacklist)
    no_tax = _no_tax_result(ranks, tax_lineage)

    out = []
    for key, payload in entries:
        text = payload.decode()
        taxa = []
        weighted = []
        for line in text.splitlines():
            cols = line.split()
            if not cols:
                continue
            tid = mapping.lookup(int(cols[0]))
            if tid == 0:
                continue
            if any(tax.is_ancestor(b, tid) for b in blocked):
                continue
            if majority:
                weight = float("inf")  # FLT_MAX stand-in for vote mode 0
                if vote_mode == AGG_TAX_MINUS_LOG_EVAL:
                    if len(cols) <= 3:
                        raise ValueError(
                            f"no alignment result for taxon {tid}")
                    weight = float(cols[3])
                elif vote_mode == 2:  # AGG_TAX_SCORE
                    if len(cols) <= 1:
                        raise ValueError(
                            f"no alignment result for taxon {tid}")
                    weight = float(cols[1])
                weighted.append(WeightedTaxHit(tid, weight, vote_mode))
            else:
                taxa.append(tid)

        if len(payload) == 0:  # entry of length 1 in reference = empty
            out.append((key, no_tax.encode()))
            continue

        if majority:
            res = tax.weighted_majority_lca(weighted, majority_thr)
            node = tax.node_taxid(res.taxon) if res.taxon != 0 else None
        else:
            node = tax.lca_list(taxa)
        if node is None:
            out.append((key, no_tax.encode()))
            continue
        line = _tax_result_suffix(tax, node, ranks, tax_lineage) + "\n"
        out.append((key, line.encode()))
    mmseqsdb.write_db(out_db, out, DBTYPE_TAXONOMICAL_RESULT,
                      compressed=compressed)


def aggregatetax_db(tax_db, set_to_seq_db, tax_seq_db, out_db,
                    aln_seq_db=None, lca_ranks="", tax_lineage=0,
                    vote_mode=1, majority_thr=0.5, compressed=False):
    """aggregatetax / aggregatetaxweights (aggregatetax.cpp:15-200).
    aln_seq_db set = aggregatetaxweights."""
    from ..io import mmseqsdb
    from .ncbi import AGG_TAX_UNIFORM, AGG_TAX_MINUS_LOG_EVAL

    tax = Taxonomy.open(tax_db)
    sets = mmseqsdb.read_db(set_to_seq_db)
    tax_seq = dict(mmseqsdb.read_db(tax_seq_db))
    aln_seq = dict(mmseqsdb.read_db(aln_seq_db)) if aln_seq_db else None
    ranks = Taxonomy.parse_ranks(lca_ranks)

    out = []
    for set_key, payload in sets:
        set_taxa = []
        for line in payload.decode().splitlines():
            cols = line.split()
            if not cols:
                continue
            seq_key = int(cols[0])
            if seq_key not in tax_seq:
                raise KeyError(f"missing key {seq_key} in tax result")
            taxon = int(tax_seq[seq_key].split(b"\t", 1)[0].split(b"\n")[0])
            if aln_seq is not None and taxon != 0:
                if seq_key not in aln_seq:
                    raise KeyError(f"missing key {seq_key} in aln result")
                acols = aln_seq[seq_key].split(b"\n", 1)[0].split()
                weight = float("inf")
                if vote_mode == AGG_TAX_MINUS_LOG_EVAL:
                    if len(acols) <= 3:
                        raise ValueError("no alignment evalue")
                    weight = float(acols[3])
                elif vote_mode == 2:
                    if len(acols) <= 1:
                        raise ValueError("no alignment score")
                    weight = float(acols[1])
                set_taxa.append(WeightedTaxHit(taxon, weight, vote_mode))
            else:
                set_taxa.append(WeightedTaxHit(taxon, 1.0, AGG_TAX_UNIFORM))

        res = tax.weighted_majority_lca(set_taxa, majority_thr)
        node_tid = tax.node_taxid(res.taxon) if res.taxon != 0 else None
        total = res.assigned_seqs + res.unassigned_seqs
        # SSTR(roundf(p*100)/100) = half-away-from-zero at 2dp, %.3f
        p = res.selected_percent
        pr = math.floor(p * 100 + 0.5) if p >= 0 else -math.floor(-p * 100 + 0.5)
        percent_str = "%.3f" % (pr / 100.0)
        if node_tid is None:
            parts = ["0", "no rank", "unclassified", str(total),
                     str(res.assigned_seqs), str(res.seqs_agree), percent_str]
            line = "\t".join(parts)
            if ranks:
                line += "\t"
            if tax_lineage > 0:
                line += "\t"
        else:
            parts = [str(node_tid), tax.rank_of(node_tid),
                     tax.name_of(node_tid), str(total),
                     str(res.assigned_seqs), str(res.seqs_agree), percent_str]
            if ranks:
                parts.append(";".join(tax.at_ranks(node_tid, ranks)))
            if tax_lineage == 1:
                parts.append(tax.tax_lineage(node_tid, True))
            elif tax_lineage == 2:
                parts.append(tax.tax_lineage(node_tid, False))
            line = "\t".join(parts)
        out.append((set_key, (line + "\n").encode()))
    from ..io import mmseqsdb as m
    m.write_db(out_db, out, DBTYPE_TAXONOMICAL_RESULT, compressed=compressed)


def addtaxonomy_db(tax_db, input_db, out_db, pick_id_from=2, lca_ranks="",
                   tax_lineage=0, compressed=False):
    """addtaxonomy (addtaxonomy.cpp:13-119). pick_id_from: 2=target col,
    1=query key (Parameters::EXTRACT_{TARGET,QUERY})."""
    from ..io import mmseqsdb

    tax = Taxonomy.open(tax_db)
    mapping = MappingReader(tax_db)
    entries = mmseqsdb.read_db(input_db)
    dbtype = mmseqsdb.read_dbtype(input_db)
    is_taxresult = dbtype == DBTYPE_TAXONOMICAL_RESULT
    ranks = Taxonomy.parse_ranks(lca_ranks)

    out = []
    for key, payload in entries:
        if len(payload) == 0:
            continue  # reference skips (no write) for length-1 entries
        taxon = 0
        if pick_id_from == 1:  # EXTRACT_QUERY
            taxon = mapping.lookup(key)
            if taxon == 0:
                continue
        result = []
        for line in payload.decode().splitlines():
            cols = line.split()
            if not cols:
                continue
            if pick_id_from == 2:  # EXTRACT_TARGET
                tid = int(cols[0])
                taxon = tid if is_taxresult else mapping.lookup(tid)
                if taxon == 0:
                    continue
            if not tax.node_exists(taxon):
                continue
            result.append(line + "\t" +
                          _tax_result_suffix(tax, taxon, ranks, tax_lineage))
        out.append((key, ("\n".join(result) + "\n" if result else "")
                    .encode()))
    mmseqsdb.write_db(out_db, out, dbtype, compressed=compressed)


def filtertaxdb_db(tax_db, input_db, out_db, taxon_list,
                   compressed=False):
    """filtertaxdb (filtertaxdb.cpp): keep lines whose first-column taxid
    satisfies the taxonomy expression."""
    from ..io import mmseqsdb

    tax = Taxonomy.open(tax_db)
    expr = TaxonomyExpression(taxon_list, tax)
    entries = mmseqsdb.read_db(input_db)
    dbtype = mmseqsdb.read_dbtype(input_db)
    out = []
    for key, payload in entries:
        kept = []
        for line in payload.decode().splitlines():
            first = line.split("\t", 1)[0].split(" ", 1)[0]
            try:
                taxon = int(first)
            except ValueError:
                taxon = 0
            if expr.is_ancestor(taxon):
                kept.append(line)
        out.append((key, ("\n".join(kept) + "\n" if kept else "").encode()))
    mmseqsdb.write_db(out_db, out, dbtype, compressed=compressed)


def filtertaxseqdb_db(tax_db, out_db, taxon_list, subdb_mode=0):
    """filtertaxseqdb (filtertaxseqdb.cpp): filter the sequence DB at
    tax_db by taxonomy expression. subdb_mode 0=hard copy, 1=soft (index
    into the original data file + symlinks)."""
    from ..io import mmseqsdb

    tax = Taxonomy.open(tax_db)
    mapping = MappingReader(tax_db)
    expr = TaxonomyExpression(taxon_list, tax)

    with open(f"{tax_db}.index") as f:
        index = [tuple(int(x) for x in ln.split("\t")) for ln in f]
    keep = [(k, o, l) for (k, o, l) in index
            if expr.is_ancestor(mapping.lookup(k))]

    def symlink(suffix):
        src = f"{tax_db}{suffix}"
        dst = f"{out_db}{suffix}"
        if os.path.exists(src):
            if os.path.lexists(dst):
                os.remove(dst)
            os.symlink(os.path.abspath(src), dst)

    if subdb_mode == 1:  # SUBDB_MODE_SOFT
        with open(f"{out_db}.index", "w") as f:
            for k, o, l in keep:
                f.write(f"{k}\t{o}\t{l}\n")
        # SEQUENCE_NO_DATA_INDEX: everything but the .index
        symlink("")
        symlink(".dbtype")
        for s in ("_h", "_h.index", "_h.dbtype", ".lookup", ".source",
                  "_mapping", "_names.dmp", "_nodes.dmp", "_merged.dmp",
                  "_taxonomy"):
            symlink(s)
        return

    with open(tax_db, "rb") as f:
        data = f.read()
    out_index = []
    with open(out_db, "wb") as f:
        pos = 0
        for k, o, l in keep:
            f.write(data[o:o + l])
            out_index.append((k, pos, l))
            pos += l
    with open(f"{out_db}.index", "w") as f:
        for k, o, l in out_index:
            f.write(f"{k}\t{o}\t{l}\n")
    with open(f"{tax_db}.dbtype", "rb") as src, \
            open(f"{out_db}.dbtype", "wb") as dst:
        dst.write(src.read())
    # SEQUENCE_ANCILLARY symlinks
    for s in ("_h", "_h.index", "_h.dbtype", ".lookup", ".source",
              "_mapping", "_names.dmp", "_nodes.dmp", "_merged.dmp",
              "_taxonomy"):
        symlink(s)


def _report_lines(tax, clade, total_reads):
    """taxReport (taxonomyreport.cpp:27-74), Kraken-style."""
    lines = []

    def clade_count(t):
        return clade[t][1] if t in clade else 0

    def rec(taxid, depth):
        if taxid == 0:
            cc = clade_count(0)
            tc = clade[0][0] if 0 in clade else 0
            if cc > 0:
                lines.append("%.4f\t%d\t%d\tno rank\t0\tunclassified" %
                             (100 * cc / float(total_reads), cc, tc))
            rec(1, 0)
            return
        if clade_count(taxid) == 0:
            return
        cc, tc, children = clade[taxid][1], clade[taxid][0], clade[taxid][2]
        lines.append("%.4f\t%d\t%d\t%s\t%d\t%s%s" %
                     (100 * cc / float(total_reads), cc, tc,
                      tax.rank_of(tax.node_taxid(taxid)), taxid, "  " * depth,
                      tax.name_of(tax.node_taxid(taxid))))
        kids = sorted(children, key=lambda t: -clade_count(t))
        for child in kids:
            if child in clade:
                rec(child, depth + 1)
            else:
                break

    rec(0, 0)
    return "\n".join(lines) + ("\n" if lines else "")


def _escape_attr(s):
    return (s.replace("&", "&amp;").replace('"', "&quot;")
            .replace("'", "&apos;").replace("<", "&lt;").replace(">", "&gt;"))


def _krona_xml(tax, clade, total_reads):
    """kronaReport (taxonomyreport.cpp:104-144): the <node> XML body."""
    parts = []

    def clade_count(t):
        return clade[t][1] if t in clade else 0

    def rec(taxid):
        if taxid == 0:
            cc = clade_count(0)
            if cc > 0:
                parts.append('<node name="unclassified"><magnitude><val>%d'
                             "</val></magnitude></node>" % cc)
            rec(1)
            return
        cc = clade_count(taxid)
        if cc == 0:
            return
        name = _escape_attr(tax.name_of(tax.node_taxid(taxid)))
        parts.append('<node name="%s"><magnitude><val>%d</val></magnitude>'
                     % (name, cc))
        kids = sorted(clade[taxid][2], key=lambda t: -clade_count(t))
        for child in kids:
            if child in clade:
                rec(child)
            else:
                break
        parts.append("</node>")

    rec(0)
    return "".join(parts)


# our own minimal standalone Krona-like prelude (the reference embeds the
# upstream Krona resource; ours is an original, self-contained shell that
# renders nothing fancy but keeps the XML payload identical)
KRONA_PRELUDE = ("<!DOCTYPE html><html><head><meta charset=\"utf-8\">"
                 "<title>taxonomy report</title></head><body>"
                 "<div style=\"display:none\"><krona>")


def taxonomyreport_db(tax_db, input_db, out_path, report_mode=0):
    """taxonomyreport (taxonomyreport.cpp:157-295). Modes: 0 Kraken-style
    flat file, 1 Krona HTML, 3 per-entry Kraken DB."""
    from ..io import mmseqsdb

    tax = Taxonomy.open(tax_db)
    seq_dbtype = None
    if os.path.exists(f"{input_db}.dbtype"):
        seq_dbtype = mmseqsdb.read_dbtype(input_db)
    is_seq_db = seq_dbtype in (0, 1, 2)
    is_tax_input = seq_dbtype == DBTYPE_TAXONOMICAL_RESULT
    mapping = None if is_tax_input else MappingReader(tax_db)
    p2c = tax.parent_to_children()

    if is_seq_db:
        with open(f"{input_db}.index") as f:
            keys = [int(ln.split("\t")[0]) for ln in f]
        tax_counts = {}
        for k in keys:
            t = mapping.lookup(k)
            if t != 0:
                tax_counts[t] = tax_counts.get(t, 0) + 1
        total = len(keys)
        entries = None
    else:
        entries = mmseqsdb.read_db(input_db)
        total = len(entries)

    if report_mode == 3:  # REPORT_MODE_KRAKENDB: per-entry reports
        out = []
        for key, payload in entries:
            local = {}
            n_lines = 0
            for line in payload.decode().splitlines():
                if not line:
                    continue
                if is_tax_input:
                    t = int(line.split("\t", 1)[0].split(" ", 1)[0])
                    local[t] = local.get(t, 0) + 1
                else:
                    t = mapping.lookup(int(line.split()[0]))
                    if t != 0:
                        local[t] = local.get(t, 0) + 1
                n_lines += 1
            clade = tax.clade_counts(local, p2c)
            out.append((key, _report_lines(tax, clade, n_lines).encode()))
        mmseqsdb.write_db(out_path, out, 12)
        return

    if not is_seq_db:
        tax_counts = {}
        for _key, payload in entries:
            for line in payload.decode().splitlines():
                if not line:
                    continue
                if is_tax_input:
                    t = int(line.split("\t", 1)[0].split(" ", 1)[0])
                    tax_counts[t] = tax_counts.get(t, 0) + 1
                else:
                    t = mapping.lookup(int(line.split()[0]))
                    if t != 0:
                        tax_counts[t] = tax_counts.get(t, 0) + 1

    clade = tax.clade_counts(tax_counts, p2c)
    if report_mode == 0:
        with open(out_path, "w") as f:
            f.write(_report_lines(tax, clade, total))
    elif report_mode == 1:
        with open(out_path, "w") as f:
            f.write(KRONA_PRELUDE)
            f.write('<node name="all"><magnitude><val>%d</val></magnitude>'
                    % total)
            f.write(_krona_xml(tax, clade, total))
            f.write("</node></krona></div></body></html>")
    else:
        raise ValueError(f"invalid report mode {report_mode}")


def createbintaxonomy(names_file, nodes_file, merged_file, out_file):
    """createbintaxonomy (createbintaxonomy.cpp:6-20)."""
    tax = Taxonomy.from_dumps(names_file, nodes_file, merged_file)
    with open(out_file, "wb") as f:
        f.write(tax.serialize())


def createbintaxmapping(in_file, out_file):
    """createbintaxmapping (createbintaxmapping.cpp)."""
    reader = MappingReader(in_file, db_input=False)
    with open(out_file, "wb") as f:
        f.write(reader.serialize())


def createdmptaxonomy(tax_db, out_prefix):
    """createdmptaxonomy (createbintaxonomy.cpp:22-110): binary -> dmp."""
    tax = Taxonomy.open(tax_db)
    with open(f"{out_prefix}_nodes.dmp", "w") as nodes_f, \
            open(f"{out_prefix}_names.dmp", "w") as names_f, \
            open(f"{out_prefix}_merged.dmp", "w") as merged_f:
        for i in range(tax.max_taxid + 1):
            if not tax.node_exists(i):
                continue
            node_tid = tax.node_taxid(i)
            if i != node_tid:
                merged_f.write(f"{i}\t|\t{node_tid}\t|\n")
                continue
            nodes_f.write(f"{node_tid}\t|\t{tax.parent_of(node_tid)}\t|\t"
                          f"{tax.rank_of(node_tid)}\t|\t\n")
            names_f.write(f"{node_tid}\t|\t{tax.name_of(node_tid)}\t|\t\t|\t"
                          "scientific name\t|\n")


def createtaxdb(seq_db, tmp_dir, ncbi_tax_dump=None, tax_mapping_file=None,
                tax_mapping_mode=0, tax_db_mode=1):
    """createtaxdb offline path (data/workflow/createtaxdb.sh:66-111):
    attaches _taxonomy (or dmp copies) and _mapping to a sequence DB.
    Download-on-missing is not supported (no egress); pass
    --ncbi-tax-dump and --tax-mapping-file."""
    import shutil

    if ncbi_tax_dump is None or tax_mapping_file is None:
        raise ValueError("createtaxdb requires --ncbi-tax-dump and "
                         "--tax-mapping-file (downloads are disabled)")
    os.makedirs(tmp_dir, exist_ok=True)
    if tax_db_mode == 1:
        createbintaxonomy(os.path.join(ncbi_tax_dump, "names.dmp"),
                          os.path.join(ncbi_tax_dump, "nodes.dmp"),
                          os.path.join(ncbi_tax_dump, "merged.dmp"),
                          f"{seq_db}_taxonomy")
    else:
        for n in ("names.dmp", "nodes.dmp", "merged.dmp", "delnodes.dmp"):
            shutil.copyfile(os.path.join(ncbi_tax_dump, n), f"{seq_db}_{n}")

    # accession->taxid mapping joined against .lookup (createtaxdb.sh:104-110)
    acc2tax = {}
    with open(tax_mapping_file) as f:
        for line in f:
            cols = line.split()
            if len(cols) >= 2:
                acc2tax[cols[0]] = cols[1]
    lines = []
    if tax_mapping_mode == 0:
        with open(f"{seq_db}.lookup") as f:
            for line in f:
                cols = line.rstrip("\n").split("\t")
                if cols[1] in acc2tax:
                    lines.append(f"{cols[0]}\t{acc2tax[cols[1]]}\n")
    else:
        src2tax = {}
        with open(f"{seq_db}.source") as f:
            for line in f:
                cols = line.rstrip("\n").split("\t")
                src2tax[cols[0]] = acc2tax.get(cols[1], "")
        with open(f"{seq_db}.lookup") as f:
            for line in f:
                cols = line.rstrip("\n").split("\t")
                lines.append(f"{cols[0]}\t{src2tax.get(cols[2], '')}\n")
    with open(f"{seq_db}_mapping", "w") as f:
        f.writelines(lines)


def nrtotaxmapping(acc2taxid_files, seq_db, out_file):
    """nrtotaxmapping.cpp: per header entry (NR-style, \\x01-joined
    multi-headers), resolve each accession (version/space-stripped)
    through the accession2taxid files; accessions without a mapping fall
    back to the LAST space-preceded [bracketed species name] looked up
    among UNIQUE taxonomy node names; the entry's taxon is the LCA of
    all resolved taxa. Output: sorted 'key<TAB>taxid' mapping file."""
    from ..io import mmseqsdb

    t = Taxonomy.open(seq_db)

    acc_map = {}
    for path in ([acc2taxid_files] if isinstance(acc2taxid_files, str)
                 else acc2taxid_files):
        with open(path) as f:
            for ln in f:
                c = ln.rstrip("\n").split("\t")
                if len(c) < 4 or c[2] == "taxid":
                    continue
                acc_map[c[0]] = int(c[2])

    from collections import Counter
    name_counts = Counter(n for n in t.names if n)
    unique_names = {n: t.tax_ids[i] for i, n in enumerate(t.names)
                    if n and name_counts[n] == 1}

    rows = []
    for key, payload in mmseqsdb.read_db(f"{seq_db}_h"):
        taxa = []
        data = payload.rstrip(b"\x00")
        for part in data.replace(b"\n", b"\x01").split(b"\x01"):
            if not part:
                continue
            text = part.decode(errors="replace")
            # accession = text up to the first '.' or ' '
            acc_end = len(text)
            for i, ch in enumerate(text):
                if ch in ". ":
                    acc_end = i
                    break
            tax = acc_map.get(text[:acc_end], 0)
            if tax:
                taxa.append(tax)
                continue
            # species fallback: last '[' preceded by a space
            start = None
            end = None
            for i, ch in enumerate(text):
                if ch == "[" and i > 0 and text[i - 1] == " ":
                    start = i + 1
                    end = i + 1
                elif ch == "]":
                    end = i
            if start is not None and end is not None and end >= start:
                tax = unique_names.get(text[start:end], 0)
                if tax:
                    taxa.append(tax)
        node = t.lca_list(taxa) if taxa else None
        if node:
            rows.append((key, node))
    rows.sort()
    with open(out_file, "w") as f:
        for key, tax in rows:
            f.write(f"{key}\t{tax}\n")
    return out_file
