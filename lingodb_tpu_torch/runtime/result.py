"""Result materialization and formatting.

Equivalent of the reference's ResultProcessor / ArrowTable result
path (reference: src/execution/ResultProcessor.cpp, src/runtime/ArrowTable.cpp).
Holds the final result as host numpy columns; formatting follows the
reference sqlite-tester's value normalization (src/tools/sqlite-tester.cpp:
35-190 — null->NULL, true->t/false->f, doubles truncated to 3 digits after
the decimal point when hashing)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..sql.types import K, Type
from ..storage.column import EPOCH


@dataclass
class ResultTable:
    names: list[str]
    types: list[Type]
    columns: list[np.ndarray]  # physical host arrays
    valids: list[np.ndarray | None]
    dictionaries: list[np.ndarray | None]
    num_rows: int

    def to_pylist(self) -> list[list]:
        """Rows of Python values (None = NULL, decimals as Decimal-free
        scaled representation converted to exact value strings on format)."""
        out = []
        for i in range(self.num_rows):
            row = []
            for c, v, d, t in zip(self.columns, self.valids, self.dictionaries, self.types):
                if v is not None and not v[i]:
                    row.append(None)
                elif d is not None:
                    row.append(str(d[c[i]]))
                else:
                    x = c[i]
                    row.append(x.item() if hasattr(x, "item") else x)
            out.append(row)
        return out

    def format_rows(self) -> list[list[str]]:
        """Rows formatted like the reference tester normalizes them. Large
        results batch-format decimal/date/timestamp/int columns through the
        native kernels (native/runtime.cpp)."""
        if self.num_rows >= 4096:
            cols = [self._format_column(i) for i in range(len(self.types))]
            if all(c is not None for c in cols):
                return [list(row) for row in zip(*cols)]
        return [
            [format_value(v, t) for v, t in zip(row, self.types)]
            for row in self.to_pylist()
        ]

    def _format_column(self, i: int) -> list | None:
        """Whole-column normalized strings via native kernels; None if the
        type needs the per-value Python path."""
        from ..runtime.vtable import dec_is_float
        from .. import native

        t, data, valid, d = (self.types[i], self.columns[i], self.valids[i],
                             self.dictionaries[i])
        out = None
        if d is not None:
            vals = d[np.asarray(data)]
            out = [str(v) for v in vals]
        elif t.kind == K.DECIMAL and np.asarray(data).dtype != np.object_:
            out = native.format_decimal(
                np.asarray(data).astype(np.int64), valid, t.s)
        elif t.kind == K.DATE:
            out = native.format_date32(np.asarray(data), valid)
        elif t.kind == K.TIMESTAMP:
            out = native.format_ts_us(np.asarray(data), valid)
        elif t.kind in (K.INT, K.BIGINT):
            out = native.format_int64(np.asarray(data, np.int64), valid)
        elif t.kind == K.BOOL:
            out = np.where(np.asarray(data), "t", "f").tolist()
        if out is None:
            return None
        if valid is not None:
            out = ["NULL" if not ok else v for v, ok in zip(out, valid)]
        return out

    def to_arrow(self):
        """Export as a pyarrow.Table (reference: Python bindings return query
        results via the Arrow C data interface, tools/python/bridgelib/
        bridge.cpp:96-122)."""
        import pyarrow as pa

        from ..storage.table import _to_arrow
        from ..storage.column import Column

        arrays = []
        for name, t, data, valid, d in zip(
            self.names, self.types, self.columns, self.valids, self.dictionaries
        ):
            col = Column(t, data, valid, d)
            arr, _f = _to_arrow(name, t, col, decimal_as_int=False)
            arrays.append(arr)
        return pa.Table.from_arrays(arrays, names=list(self.names))

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def pretty(self, max_rows: int = 50) -> str:
        rows = self.format_rows()[:max_rows]
        widths = [len(n) for n in self.names]
        for r in rows:
            for i, v in enumerate(r):
                widths[i] = max(widths[i], len(v))
        sep = "-+-".join("-" * w for w in widths)
        lines = [" | ".join(n.ljust(w) for n, w in zip(self.names, widths)), sep]
        for r in rows:
            lines.append(" | ".join(v.ljust(w) for v, w in zip(r, widths)))
        if self.num_rows > max_rows:
            lines.append(f"... ({self.num_rows} rows)")
        else:
            lines.append(f"({self.num_rows} rows)")
        return "\n".join(lines)


def format_value(v, t: Type) -> str:
    """One value -> the reference tester's normalized string form."""
    if v is None:
        return "NULL"
    if t.kind == K.BOOL:
        return "t" if v else "f"
    if t.kind == K.DECIMAL:
        from ..runtime.vtable import dec_is_float

        if dec_is_float(t):
            # float-backed decimal: fixed formatting at declared scale
            s = f"{v:.{min(t.s, 18)}f}"
            return s
        sign = "-" if v < 0 else ""
        a = abs(int(v))
        if t.s == 0:
            return f"{sign}{a}"
        ip, fp = divmod(a, 10**t.s)
        return f"{sign}{ip}.{fp:0{t.s}d}"
    if t.kind == K.DATE:
        return str(EPOCH + np.timedelta64(int(v), "D"))
    if t.kind == K.TIMESTAMP:
        s = str(np.datetime64(int(v), "us"))
        s = s.replace("T", " ")
        # trim trailing zero fraction like Arrow does
        if "." in s:
            s = s.rstrip("0").rstrip(".")
        return s
    if t.kind == K.FLOAT:
        # shortest repr at float32 precision (Arrow prints the float, not its
        # double promotion: 1.2f + 1.33f -> "2.53", not "2.5299999713...")
        f = np.float32(v)
        if f != f:
            return "nan"
        return np.format_float_positional(f, unique=True, trim="0")
    if t.kind == K.DOUBLE:
        f = float(v)
        if f != f:
            return "nan"
        return repr(f)
    if t.kind == K.INTERVAL:
        return str(v)
    return str(v)


def truncate_double_digits(s: str, digits: int = 3) -> str:
    """Replicate the reference tester's double normalization: keep at most
    `digits` digits after the decimal point (truncating, not rounding)
    (reference: sqlite-tester.cpp:94-110)."""
    if "." not in s:
        return s
    ip, _, fp = s.partition(".")
    # scientific notation passes through
    for marker in ("e", "E"):
        if marker in fp:
            return s
    return ip + "." + fp[:digits]
