"""Host-side columnar data representation.

Replacement for the reference's Arrow-array runtime layer
(reference: src/runtime/ArrowView.h, src/runtime/storage/LingoDBTable.cpp).
Columns live on the host as dense numpy arrays plus a validity bitmap; strings
are dictionary-encoded at load time with a *sorted* dictionary so that integer
code order equals lexicographic order. Device kernels then only ever see flat
integer/float tensors — the idiomatic accelerator layout (no pointers, no varlen).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..sql.types import K, IntervalUnit, Type

EPOCH = np.datetime64("1970-01-01", "D")


def physical_dtype(t: Type):
    if t.kind == K.BOOL:
        return np.bool_
    if t.kind == K.INT:
        return np.int32
    if t.kind == K.BIGINT:
        return np.int64
    if t.kind == K.FLOAT:
        return np.float32
    if t.kind == K.DOUBLE:
        return np.float64
    if t.kind == K.DECIMAL:
        return np.int64
    if t.kind in (K.STRING, K.CHAR):
        return np.int32  # dictionary codes
    if t.kind == K.DATE:
        return np.int32  # days since epoch
    if t.kind == K.TIMESTAMP:
        return np.int64  # microseconds since epoch
    if t.kind == K.INTERVAL:
        return np.int32 if t.unit == IntervalUnit.MONTH else np.int64
    if t.kind == K.NULL:
        return np.int32
    raise NotImplementedError(str(t))


@dataclass
class Column:
    """One host column: typed data + validity + optional string dictionary.

    data:  numpy array with `physical_dtype(type)`
    valid: numpy bool array (True = present) or None when non-nullable
    dictionary: for string/char columns, numpy object array of Python str,
                sorted ascending; data holds int32 indices into it. NULL rows
                hold code 0 (masked by `valid`).
    """

    type: Type
    data: np.ndarray
    valid: np.ndarray | None = None
    dictionary: np.ndarray | None = None

    def __len__(self):
        return len(self.data)

    # ---- construction ---------------------------------------------------
    @staticmethod
    def from_values(t: Type, values) -> "Column":
        """Build a column from an iterable of Python values (None = NULL)."""
        n = len(values)
        valid = np.array([v is not None for v in values], dtype=np.bool_)
        all_valid = bool(valid.all())
        if t.is_string:
            strs = ["" if v is None else str(v) for v in values]
            if t.kind == K.CHAR and t.p > 0:
                # char(N) semantics: values stored; trailing-space trim on compare
                pass
            dictionary, codes = encode_strings(strs)
            col = Column(t, codes, None if all_valid else valid, dictionary)
            return col
        dtype = physical_dtype(t)
        out = np.zeros(n, dtype=dtype)
        try:
            for i, v in enumerate(values):
                if v is None:
                    continue
                out[i] = _to_physical(t, v)
        except OverflowError:
            # wide decimal beyond int64: exact Python-int object column
            out = np.array(
                [0 if v is None else int(_to_physical(t, v)) for v in values],
                dtype=np.object_)
        return Column(t, out, None if all_valid else valid)

    def is_valid_mask(self) -> np.ndarray:
        if self.valid is None:
            return np.ones(len(self.data), dtype=np.bool_)
        return self.valid

    # ---- conversion -----------------------------------------------------
    def to_pylist(self):
        out = []
        mask = self.is_valid_mask()
        dec = 10 ** self.type.s if self.type.kind == K.DECIMAL else None
        for i in range(len(self.data)):
            if not mask[i]:
                out.append(None)
            elif self.dictionary is not None:
                out.append(self.dictionary[self.data[i]])
            elif dec is not None:
                out.append(int(self.data[i]))  # scaled representation
            else:
                out.append(self.data[i].item())
        return out

    def take(self, indices: np.ndarray) -> "Column":
        valid = None if self.valid is None else self.valid[indices]
        return Column(self.type, self.data[indices], valid, self.dictionary)

    def concat(self, other: "Column") -> "Column":
        assert self.type.base_eq(other.type)
        if self.dictionary is not None:
            merged, map_a, map_b = merge_dictionaries(self.dictionary, other.dictionary)
            data = np.concatenate([map_a[self.data], map_b[other.data]])
            dictionary = merged
        else:
            data = np.concatenate([self.data, other.data])
            dictionary = None
        if self.valid is None and other.valid is None:
            valid = None
        else:
            valid = np.concatenate([self.is_valid_mask(), other.is_valid_mask()])
        return Column(self.type, data, valid, dictionary)


def _to_physical(t: Type, v):
    if t.kind == K.DECIMAL:
        if isinstance(v, str):
            return decimal_str_to_int(v, t.s)
        if isinstance(v, float):
            return round(v * 10**t.s)
        if isinstance(v, int):
            return v * 10**t.s
        raise TypeError(f"bad decimal literal {v!r}")
    if t.kind == K.DATE:
        if isinstance(v, str):
            return (np.datetime64(v, "D") - EPOCH).astype(np.int64)
        return v
    if t.kind == K.TIMESTAMP:
        if isinstance(v, str):
            return np.datetime64(v, "us").astype(np.int64)
        return v
    if t.kind == K.BOOL and isinstance(v, str):
        return v.lower() in ("t", "true", "1")
    return v


def decimal_str_to_int(s: str, scale: int) -> int:
    s = s.strip()
    neg = s.startswith("-")
    if neg or s.startswith("+"):
        s = s[1:]
    if "e" in s.lower():
        # scientific notation: go through exact integer math via Fraction-free path
        mant, _, exp = s.lower().partition("e")
        exp = int(exp)
        ip, _, fp = mant.partition(".")
        digits = (ip + fp) or "0"
        pointpos = len(ip) + exp
        # value = digits * 10**(pointpos - len(digits)); scale it
        shift = scale + pointpos - len(digits)
        v = int(digits)
        if shift >= 0:
            v *= 10**shift
        else:
            v = _round_div(v, 10**-shift)
        return -v if neg else v
    ip, _, fp = s.partition(".")
    fp = (fp + "0" * scale)[:scale] if scale else ""
    extra = s.partition(".")[2][scale:] if scale < len(s.partition(".")[2]) else ""
    v = int(ip or "0") * 10**scale + (int(fp) if fp else 0)
    if extra and int(extra[0]) >= 5:
        v += 1
    return -v if neg else v


def _round_div(a: int, b: int) -> int:
    q, r = divmod(a, b)
    if 2 * r >= b:
        q += 1
    return q


def encode_strings(strs: list[str]):
    """Dictionary-encode a list of strings with a sorted dictionary."""
    arr = np.asarray(strs, dtype=object)
    dictionary, codes = np.unique(arr, return_inverse=True)
    return dictionary.astype(object), codes.astype(np.int32)


def merge_dictionaries(a: np.ndarray, b: np.ndarray):
    """Merge two sorted dictionaries; return (merged, remap_a, remap_b) where
    remap_x[old_code] = new_code."""
    merged = np.unique(np.concatenate([a, b]))
    remap_a = np.searchsorted(merged, a).astype(np.int32)
    remap_b = np.searchsorted(merged, b).astype(np.int32)
    return merged.astype(object), remap_a, remap_b
