"""Carry table state across engines as plain numpy.

`tables_from_numpy` builds this package's TableStorage objects from columns
handed over as plain numpy arrays plus the string form of each logical type,
so that another implementation of the engine (the JAX reference, in the
tests) and this one run over the very same bytes. The extraction on the
other side is the caller's: this package imports nothing of it.

Input, per table name:

    {"columns": [(name, type_string, data, valid_or_None, dictionary_or_None),
                 ...],
     "sorted_cols": ("l_orderkey",)}

`type_string` is `str(Type)`: "int", "decimal(15,2)", "char(1)?",
"interval<month>", with a trailing "?" for nullable types.
"""

from __future__ import annotations

import re

import numpy as np

from ..sql.types import IntervalUnit, K, Type
from ..storage.column import Column
from ..storage.table import TableStorage


def parse_type(text: str) -> Type:
    """Inverse of `str(Type)`."""
    s = text.strip()
    nullable = s.endswith("?")
    if nullable:
        s = s[:-1]
    m = re.fullmatch(r"decimal\((\d+),(\d+)\)", s)
    if m:
        return Type.decimal(int(m.group(1)), int(m.group(2)), nullable)
    m = re.fullmatch(r"char\((\d+)\)", s)
    if m:
        return Type.char(int(m.group(1)), nullable)
    m = re.fullmatch(r"interval<(\w+)>", s)
    if m:
        return Type.interval(IntervalUnit(m.group(1)), nullable)
    return Type(K(s), nullable)


def tables_from_numpy(tables: dict) -> dict[str, TableStorage]:
    out = {}
    for name, spec in tables.items():
        names, types, cols = [], [], []
        rows = 0
        for cname, tstr, data, valid, dictionary in spec["columns"]:
            t = parse_type(tstr)
            data = np.asarray(data)
            names.append(cname)
            types.append(t)
            cols.append(Column(
                t, data,
                None if valid is None else np.asarray(valid, dtype=np.bool_),
                None if dictionary is None else np.asarray(dictionary, dtype=object)))
            rows = len(data)
        st = TableStorage(name, names, types, cols, rows)
        st.sorted_cols = tuple(spec.get("sorted_cols", ()))
        out[name] = st
    return out
