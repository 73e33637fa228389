# Copy of metaeuk_tpu/pipeline/filterdb.py; it differs from its original only in this note.
"""filterdb: the per-line relational filter over result DBs.

Behavior port of lib/mmseqs/src/util/filterdb.cpp (mode selection
:118-248, per-line dispatch :339-505): regex / file-filter / mapping /
first-N-lines / numeric comparison / beats-first / sort-entries /
join-db / arithmetic expression, with --trim-to-one-column and
--include-identity, on 1-based --filter-column.
"""

import math
import re

from ..io import mmseqsdb

_OPS = {"ge": lambda a, b: a >= b,
        "le": lambda a, b: a <= b,
        "e": lambda a, b: a == b}

_BEATS_OPS = dict(_OPS)
_BEATS_OPS.update({
    "ip": lambda a, b: a >= b,   # vs reference*compValue, handled by caller
    "op": lambda a, b: a <= b,
    "ep": lambda a, b: a == b,
})


def _strtod(s):
    """C strtod: parse the leading float, 0.0 on failure."""
    m = re.match(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?"
                 r"|inf(inity)?|nan)", s, re.IGNORECASE)
    return float(m.group(0)) if m else 0.0


def _column_value(line, column):
    """The --filter-column token (1-based), whitespace-trimmed
    (filterdb.cpp:316-336)."""
    words = line.split()
    if len(words) < column:
        raise ValueError(f"Column={column} does not exist in line {line}")
    return words[column - 1]


class _Expression:
    """--filter-expression: tinyexpr-style arithmetic over $N column
    references (ExpressionParser + lib/tinyexpr)."""

    _NS = {k: getattr(math, k) for k in
           ("ceil", "floor", "exp", "log", "log10", "sqrt", "fabs", "pow",
            "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "fmod")}
    _NS.update(abs=abs, min=min, max=max, e=math.e, pi=math.pi, ln=math.log)

    def __init__(self, expr):
        self.cols = sorted({int(m) for m in re.findall(r"\$(\d+)", expr)})
        py = re.sub(r"\$(\d+)", r"_c[\1]", expr).replace("^", "**")
        self.code = compile(py, "<filter-expression>", "eval")

    def evaluate(self, words):
        # $N is 1-based: ExpressionParser maps it to getWordsOfLine
        # index N-1 (verified against the reference binary)
        _c = {i: _strtod(words[i - 1]) if i - 1 < len(words) else 0.0
              for i in self.cols}
        return eval(self.code, {"__builtins__": {}, "_c": _c}, dict(self._NS))


def filterdb(in_db, out_db, filter_column=1, filter_regex=None,
             filter_file=None, positive_filter=True, mapping_file=None,
             extract_lines=0, comp_operator="", comp_value=0.0,
             sort_entries=0, beats_first=False, join_db=None,
             column_to_take=-1, filter_expression=None,
             trim_to_one_column=False, include_identity=False):
    """One call = one reference invocation; mode priority matches
    filterdb.cpp:118-248."""
    col = filter_column

    filt = None
    mapping = None
    expr = None
    join = None
    if sort_entries:
        mode = "sort"
    elif filter_file:
        mode = "file"
        filt = set()
        with open(filter_file, "rb") as f:
            for ln in f.read().split(b"\n"):
                ln = ln.replace(b"\x00", b"")
                if ln.strip():
                    filt.add(ln.split()[0].decode())
    elif mapping_file:
        mode = "mapping"
        mapping = {}
        with open(mapping_file) as f:
            for ln in f:
                c = ln.rstrip("\n").split("\t")
                if len(c) >= 2:
                    mapping.setdefault(c[0], []).append(c[1])
    elif extract_lines > 0:
        mode = "lines"
    elif join_db:
        mode = "join"
        join = dict(mmseqsdb.read_db(join_db))
    elif beats_first:
        mode = "beats"
    elif comp_operator:
        mode = "numeric"
    elif filter_expression:
        mode = "expr"
        expr = _Expression(filter_expression)
    else:
        mode = "regex"
        rx = re.compile(filter_regex if filter_regex is not None else "^.*$")

    out = []
    for key, payload in mmseqsdb.read_db(in_db):
        rows = []
        to_sort = []
        reference_value = 0.0
        counter = 0
        for line in payload.decode().split("\n"):
            if line == "":
                continue
            counter += 1
            self_match = include_identity and \
                int(line.split("\t", 1)[0]) == key
            cval = None
            if mode != "lines" or trim_to_one_column:
                cval = _column_value(line, col)

            nomatch = False
            out_line = line
            if mode == "lines":
                nomatch = counter > extract_lines
            elif mode == "numeric":
                nomatch = not _OPS[comp_operator](_strtod(cval), comp_value)
            elif mode == "expr":
                nomatch = expr.evaluate(line.split()) == 0
            elif mode == "regex":
                nomatch = rx.search(cval) is None
            elif mode == "join":
                jkey = int(_strtod(cval))
                if jkey in join:
                    extra = join[jkey].decode()
                    if column_to_take == -1:
                        out_line = line + "\t" + extra.rstrip("\n")
                    else:
                        val = extra.split("\t")[column_to_take].rstrip("\n")
                        out_line = line + "\t" + val
                else:
                    nomatch = True
            elif mode == "beats":
                if counter == 1:
                    reference_value = _strtod(cval)
                else:
                    ref = reference_value
                    if comp_operator in ("ip", "op", "ep"):
                        ref = ref * comp_value
                    op = _BEATS_OPS.get(comp_operator)
                    nomatch = not op(_strtod(cval), ref) if op else False
            elif mode == "file":
                found = cval in filt
                nomatch = (not found) if positive_filter else found
            elif mode == "mapping":
                # equal keys iterate in reversed file order (the reference
                # stable_sorts with a non-strict <= comparator); multiple
                # replacement lines are concatenated WITHOUT newlines when
                # the line has more columns than --filter-column
                # (filterdb.cpp:443-486)
                vals = mapping.get(cval, [])
                nomatch = not vals
                if vals:
                    words = line.split("\t")
                    reps = []
                    for v in reversed(vals):
                        w = list(words)
                        w[col - 1] = v
                        rep = "\t".join(w)
                        if len(words) <= col:
                            rep += "\n"
                        reps.append(rep)
                    out_line = "".join(reps).rstrip("\n")
            elif mode == "sort":
                to_sort.append((_strtod(cval), line))
                nomatch = True

            if self_match:
                nomatch = False
            if not nomatch:
                rows.append(cval if trim_to_one_column else out_line)

        if mode == "sort":
            if sort_entries == 1:
                to_sort.sort(key=lambda p: p[0])
            elif sort_entries == 2:
                to_sort.sort(key=lambda p: -p[0])
            rows.extend(ln for _, ln in to_sort)
        out.append((key, "".join(r + "\n" for r in rows).encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.read_dbtype(in_db))
    return out_db


def _is_db(path):
    import os
    return os.path.exists(f"{path}.dbtype")
