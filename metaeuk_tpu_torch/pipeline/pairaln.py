# Copy of metaeuk_tpu/pipeline/pairaln.py; it differs from its original only in this note.
"""pairaln: pair alignments across chains of a complex by species.

Port of lib/mmseqs/src/util/pairaln.cpp. Query entries are grouped by
their .lookup fileNumber (one group per input FASTA, iterated in the
accession-sorted order of DBReader USE_LOOKUP_REV); within each group a
target taxon is "pairable" when enough of the group's queries hit it
(--pairing-mode 0: >1 query; 1: all queries). --pairing-filter 0 keeps
the best hit per pairable taxon per query; --pairing-filter 1 pairs by
proximity of UniProt accession numbers (UniProtConverter structured
numbers, nearest-partner search, --pairing-prox-dist threshold).

Parity quirks replicated:
- minResultDbKey (the dummy row's key) is a running minimum that is
  never reset between file groups (pairaln.cpp:255,297),
- the proximity sort ignores the taxon entirely (the taxon comparison
  is commented out, pairaln.cpp:184-190),
- incompatible partners write the dummy row even with
  --pairing-dummy-mode 0 (pairaln.cpp:374-387; only never-set rows with
  dbKey UINT_MAX are gated on dummy mode),
- backtraces are re-emitted verbatim (read compressed, written with
  compress=false, pairaln.cpp:389).
"""

import numpy as np

from ..io import mmseqsdb
from .alnformat import matcher_seq_id_text
from .dbtools2 import parse_aln_record

UINT_MAX = 0xFFFFFFFF
SIZE_MAX = (1 << 64) - 1


def _to_structured_number(acc):
    """UniProtConverter::toStructuredNumber (pairaln.cpp:28-59)."""
    if acc.startswith("UniRef"):
        parts = acc.split("_")
        if len(parts) > 1:
            acc = parts[1]
    if "-" in acc:
        acc = acc[:acc.index("-")]
    if not acc:
        return 0
    first = acc[0].upper()
    if len(acc) == 6 and first in "OPQ":
        return _convert_opq(acc)
    if len(acc) in (6, 10):
        return _convert_anrz(acc)
    if acc.startswith("UPI"):
        try:
            return 10 ** 15 + int(acc[3:], 16)
        except ValueError:
            return 0
    return 0


def _digit(c):
    return ord(c) - 48 if c.isdigit() else -1


def _alpha(c):
    return ord(c) - 65 if "A" <= c <= "Z" else -1


def _alnum(c):
    if c.isdigit():
        return ord(c) - 48
    if "A" <= c <= "Z":
        return ord(c) - 65 + 10
    return -1


def _convert_opq(acc):
    number = 0
    mult = 1
    for i in range(5, -1, -1):
        c = acc[i].upper()
        if i == 0:
            val = {"O": 0, "P": 1, "Q": 2}.get(c, -1)
            radix = 3
        elif i in (1, 5):
            val, radix = _digit(c), 10
        else:
            val, radix = _alnum(c), 36
        if val == -1:
            return 0
        number += val * mult
        mult *= radix
    return number


def _convert_anrz(acc):
    number = 0
    mult = 1
    for i in range(len(acc) - 1, -1, -1):
        c = acc[i].upper()
        if i == 0:
            if "A" <= c <= "N":
                val = ord(c) - 65
            elif "R" <= c <= "Z":
                val = ord(c) - 65 - 3
            else:
                val = -1
            radix = 23
        elif i in (1, 5, 9):
            val, radix = _digit(c), 10
        elif i in (2, 6):
            val, radix = _alpha(c), 26
        elif i in (3, 4, 7, 8):
            val, radix = _alnum(c), 36
        else:
            return 0
        if val == -1:
            return 0
        number += val * mult
        mult *= radix
    return number


def _pack_uniprot(num):
    """Store as int32 hi/lo then reconstruct with the reference's
    sign-extending uint64 cast (pairaln.cpp:135-138,321-323)."""
    hi = (num >> 32) & UINT_MAX
    lo = num & UINT_MAX
    if hi >= 1 << 31:
        hi -= 1 << 32
    return hi, lo


def _uniprot_number(hi, lo):
    se = hi & SIZE_MAX  # static_cast<uint64_t>(int32) sign-extends
    return ((se << 32) & SIZE_MAX) | (lo & UINT_MAX)


def _record_line(r, has_backtrace):
    cols = [str(r["dbKey"]), str(r["score"]),
            matcher_seq_id_text(r["seqId"]), "%.3E" % r["eval"],
            str(r["qStart"]), str(r["qEnd"]), str(r["qLen"]),
            str(r["dbStart"]), str(r["dbEnd"]), str(r["dbLen"])]
    if has_backtrace:
        cols.append(r["backtrace"] or "")
    return "\t".join(cols) + "\n"


def _empty_result(db_key):
    return dict(dbKey=db_key, score=0, seqId=0.0, eval=0.0, qStart=-1,
                qEnd=0, qLen=0, dbStart=-1, dbEnd=0, dbLen=0,
                backtrace="1M")


def _find_nearest_partner(query, results2):
    """findNearestPartner (pairaln.cpp:140-178): lower_bound on the
    structured number plus its predecessor."""
    import bisect
    if not results2:
        return None
    qnum = _uniprot_number(query["upHi"], query["upLo"])
    nums = [_uniprot_number(r["upHi"], r["upLo"]) for r in results2]
    it2 = bisect.bisect_left(nums, qnum)
    best = None
    min_dist = SIZE_MAX
    if it2 < len(results2):
        dist = abs(nums[it2] - qnum)
        if dist < min_dist:
            min_dist = dist
            best = it2
    if it2 > 0:
        dist = abs(qnum - nums[it2 - 1])
        if dist < min_dist:
            best = it2 - 1
    return best


def pairaln_db(query_db, target_db, aln_db, out_db, pairing_mode=0,
               pairing_filter=0, pairing_dummy_mode=0, prox_dist=20,
               compressed=False):
    """pairaln.cpp main loop."""
    from ..io.fasta import parse_fasta_header

    lookup = []
    for ln in open(f"{query_db}.lookup"):
        c = ln.rstrip("\n").split("\t")
        lookup.append((int(c[0]), c[1], int(c[2])))
    # USE_LOOKUP_REV sorts the lookup by accession (DBReader.cpp)
    lookup.sort(key=lambda e: e[1])
    max_file = max((e[2] for e in lookup), default=0)
    file_to_ids = [[] for _ in range(max_file + 1)]
    for key, _, fno in lookup:
        file_to_ids[fno].append(key)

    mapping = {}
    for ln in open(f"{target_db}_mapping"):
        c = ln.split("\t")
        mapping[int(c[0])] = int(c[1])

    theaders = None
    if pairing_filter == 1:
        theaders = {k: parse_fasta_header(p.decode().rstrip("\x00\n"))
                    for k, p in mmseqsdb.read_db(f"{target_db}_h")}

    aln = dict(mmseqsdb.read_db(aln_db))
    aln_dbtype = mmseqsdb.read_dbtype(aln_db)

    has_backtrace = False
    min_result_db_key = UINT_MAX
    out = []
    for group in file_to_ids:
        find_pair = {}
        results_cache = {}
        for key in group:
            recs = [parse_aln_record(ln)
                    for ln in aln.get(key, b"").decode().split("\n") if ln]
            for r in recs:
                has_backtrace = bool(r["backtrace"])
                r["taxon"] = mapping.get(r["dbKey"], 0)
                min_result_db_key = min(min_result_db_key, r["dbKey"])
            recs.sort(key=lambda r: r["taxon"])  # stable
            results_cache[key] = recs
            prev_taxon = UINT_MAX
            for r in recs:
                if r["taxon"] == prev_taxon:
                    continue
                find_pair[r["taxon"]] = find_pair.get(r["taxon"], 0) + 1
                prev_taxon = r["taxon"]
        threshold = 1 if pairing_mode == 0 else len(group) - 1
        taxon_to_pair = sorted(t for t, n in find_pair.items()
                               if n > threshold)

        if pairing_filter == 1:
            result_per_id = []
            for key in group:
                recs = [parse_aln_record(ln)
                        for ln in aln.get(key, b"").decode().split("\n")
                        if ln]
                for r in recs:
                    r["taxon"] = mapping.get(r["dbKey"], 0)
                    num = _to_structured_number(
                        theaders.get(r["dbKey"], ""))
                    r["upHi"], r["upLo"] = _pack_uniprot(num)
                recs.sort(key=lambda r: (r["upHi"],
                                         r["upLo"] & UINT_MAX))
                result_per_id.append(recs)
            outputs = ["" for _ in group]
            first = result_per_id[0] if result_per_id else []
            for rec0 in first:
                compatible = [None] * len(result_per_id)
                compatible[0] = rec0
                compatible_size = 1
                for i in range(1, len(result_per_id)):
                    partner = _find_nearest_partner(rec0,
                                                    result_per_id[i])
                    if partner is None:
                        if pairing_dummy_mode == 1:
                            compatible[i] = _empty_result(
                                min_result_db_key)
                        continue
                    cand = result_per_id[i][partner]
                    curr_num = _uniprot_number(cand["upHi"],
                                               cand["upLo"])
                    is_compat = False
                    for c in compatible:
                        if c is None or c["dbKey"] == UINT_MAX or \
                                "upHi" not in c:
                            continue
                        prev_num = _uniprot_number(c["upHi"], c["upLo"])
                        if abs(curr_num - prev_num) <= prox_dist:
                            is_compat = True
                            break
                    if is_compat:
                        compatible[i] = cand
                        compatible_size += 1
                    else:
                        compatible[i] = _empty_result(min_result_db_key)
                if (pairing_mode == 1 and
                        compatible_size != len(result_per_id)) or \
                        compatible_size == 1:
                    continue
                for i, c in enumerate(compatible):
                    if c is None:
                        if pairing_dummy_mode == 1:
                            outputs[i] += _record_line(
                                _empty_result(min_result_db_key),
                                has_backtrace)
                        continue
                    outputs[i] += _record_line(c, has_backtrace)
            for i, key in enumerate(group):
                out.append((key, outputs[i].encode()))
        else:
            for key in group:
                recs = results_cache[key]
                output = []
                prev_taxon = UINT_MAX
                res_idx_start = 0
                for taxon_in_list in taxon_to_pair:
                    found = False
                    for idx in range(res_idx_start, len(recs)):
                        taxon = recs[idx]["taxon"]
                        if taxon_in_list != taxon:
                            continue
                        best = taxon != prev_taxon
                        found = True
                        if best:
                            output.append(_record_line(recs[idx],
                                                       has_backtrace))
                            res_idx_start = idx + 1
                            break
                        prev_taxon = taxon
                    if not found and pairing_dummy_mode == 1:
                        output.append(_record_line(
                            _empty_result(min_result_db_key),
                            has_backtrace))
                out.append((key, "".join(output).encode()))
    mmseqsdb.write_db(out_db, out, aln_dbtype, sort_index=True,
                      compressed=compressed)
    return out_db
