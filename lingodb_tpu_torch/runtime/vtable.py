"""Device-resident columnar data.

Replacement for the reference's ExecutionContext-managed runtime buffers
(reference: include/lingodb/runtime/ExecutionContext.h, Buffer.h).
Intermediate query state is a VTable: a set of flat tensors (one per column)
plus host-side string dictionaries. All tensors in one VTable share the same
leading length. Small tables hold numpy arrays instead of tensors (the host
tier, runtime/device.py); wide-decimal columns are always host object arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..sql.types import K, IntervalUnit, Type


def _gather_tree(idx, arrays: dict, monotone: bool = False):
    """One gather over a dict of equal-length columns. Routes through the
    batched gather kernels (ops/pgather.py) on the card: the whole column
    group shares one index decode; monotone=True selects the sorted-gather
    kernel (a wrong hint costs time, not correctness). Negative indices
    clamp to 0 and indices past the end to the last row."""
    from ..ops import pgather as pg

    keys = list(arrays)
    outs = pg.take_fast_multi([arrays[k] for k in keys], idx,
                              monotone=monotone)
    return dict(zip(keys, outs))


def np_dtype(t: Type):
    """Physical dtype (as a numpy scalar type) for a logical type (see
    sql/types.py docstring); ops/backend.tdtype maps it to torch."""
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
        # wide decimals (dec_is_wide) default to scaled int64 physically;
        # values that genuinely need more than 63 bits live in host object
        # arrays of Python ints (see storage/column.py + ops/scalar.py)
        return np.int64
    if t.kind in (K.STRING, K.CHAR):
        return np.int32
    if t.kind == K.DATE:
        return np.int32
    if t.kind == K.TIMESTAMP:
        return np.int64
    if t.kind == K.INTERVAL:
        return np.int32 if t.unit == IntervalUnit.MONTH else np.int64
    if t.kind == K.NULL:
        return np.int32
    raise NotImplementedError(str(t))


def dec_is_wide(t: Type) -> bool:
    """Decimals that may not fit a scaled int64 (precision or scale > 18).
    Wide columns are stored as host numpy object arrays of Python ints
    (exact arbitrary precision — a superset of the reference's i128,
    DBToStd/LowerToStd.cpp:128-330) and never upload to the device; device
    code that produces wide SUM results accumulates in 32-bit-split int64
    lanes and recombines exactly on the host."""
    return t.kind == K.DECIMAL and (t.p > 18 or t.s > 18)


def dec_is_float(t: Type) -> bool:
    """Legacy predicate from the float64 fallback era: wide decimals are now
    exact (see dec_is_wide), so no decimal is ever float-backed."""
    return False


def is_obj(a) -> bool:
    """True for host object-dtype arrays (Python-int decimal limbs)."""
    return isinstance(a, np.ndarray) and a.dtype == np.object_


def _host_idx(idx) -> np.ndarray:
    """Fetch an index/mask array to the host for object-column gathers."""
    if isinstance(idx, np.ndarray):
        return idx
    if isinstance(idx, torch.Tensor):
        from ..ops.backend import to_host

        return to_host(idx)
    return np.asarray(idx)


@dataclass
class SCol:
    """One column: data tensor (or host array) + optional validity + host
    dictionary. An expression's value also carries `err`, the error each
    row raises (ops/scalar.py, "data errors"): None where nothing can fail;
    the operator that consumes the value raises it on its live rows and
    drops it, so no table's column holds one."""

    type: Type
    data: object
    valid: Optional[object] = None  # bool tensor/array, True = present
    dictionary: Optional[np.ndarray] = None  # host np object array (strings)
    err: Optional[object] = None  # int32 tensor/array of error codes, 0 = none

    def __len__(self):
        return int(self.data.shape[0])

    def valid_mask(self):
        if self.valid is None:
            if isinstance(self.data, torch.Tensor):
                return torch.ones(tuple(self.data.shape[:1]), dtype=torch.bool,
                                  device=self.data.device)
            return np.ones(self.data.shape[0], dtype=np.bool_)
        return self.valid

    def take(self, idx, monotone: bool = False) -> "SCol":
        from ..ops import pgather as pg

        data = self.data
        if is_obj(data):  # host-only wide-decimal column: numpy gather
            idx = _host_idx(idx)
            return SCol(
                self.type, data[idx],
                None if self.valid is None else _host_idx(self.valid)[idx],
                self.dictionary)
        if not self._one_gather():
            return SCol(
                self.type,
                pg.take_fast(data, idx, monotone=monotone),
                None if self.valid is None
                else pg.take_fast(self.valid, idx, monotone=monotone),
                self.dictionary,
            )
        data, valid = pg.take_fast_multi([data, self.valid], idx,
                                         monotone=monotone)
        return SCol(self.type, data, valid, self.dictionary)

    def _one_gather(self) -> bool:
        """Whether take gathers data and validity in one call (one launch,
        one read of the index): both 1-D on the same tier."""
        from ..ops import backend as be

        return (self.valid is not None and not is_obj(self.data)
                and self.data.ndim == 1
                and be.is_torch(self.data) == be.is_torch(self.valid))

    def take_with_invalid(self, idx, oob_invalid, monotone: bool = False) -> "SCol":
        """Gather, then mark rows where oob_invalid is True as NULL (used for
        outer joins: unmatched rows gather slot 0 but become NULL)."""
        from ..ops import backend as be
        from ..ops.backend import xnp
        from ..ops import pgather as pg

        if is_obj(self.data):
            idx = _host_idx(idx)
            oob_invalid = _host_idx(oob_invalid).astype(np.bool_)
        bidx = xnp.maximum(idx, 0)
        if self._one_gather():
            data, base = pg.take_fast_multi([self.data, self.valid], bidx,
                                            monotone=monotone)
        else:
            data = pg.take_fast(self.data, bidx, monotone=monotone)
            if self.valid is not None:
                base = pg.take_fast(self.valid, bidx, monotone=monotone)
            elif be.is_torch(data):
                base = torch.ones((idx.shape[0],), dtype=torch.bool,
                                  device=data.device)
            else:
                base = np.ones(idx.shape[0], np.bool_)
        oob_invalid = be.like(oob_invalid, base)
        return SCol(self.type.as_nullable(), data, base & ~oob_invalid, self.dictionary)


@dataclass
class VTable:
    """Intermediate relational result: cid -> SCol, all of equal length.

    row_valid is an optional selection vector (True = live row): on a
    device mesh (runtime/device.get_mesh) scans, Select, Map and the
    sharded join and aggregate defer their compaction with it
    (Executor._lazy_ok), and the next keyed exchange drops the dead rows
    for free. Every operator that needs a dense table calls .dense().

    A table held on the mesh has parallel.mesh.Sharded columns (and
    selection vector): the scan, Select and Map make one, the sharded
    join, aggregate and sort and the fused aggregate take one, and
    Executor.run gathers it whole for every other operator; the methods
    below take whole columns only."""

    cols: dict[int, SCol] = field(default_factory=dict)
    num_rows: int = 0
    row_valid: Optional[object] = None

    def col(self, cid: int) -> SCol:
        return self.cols[cid]

    def dense(self) -> "VTable":
        """Materialize the selection vector (global compaction)."""
        if self.row_valid is None:
            return self
        inner = VTable(self.cols, self.num_rows)
        return inner.select_mask(self.row_valid)

    def take(self, idx, n: int, monotone: bool = False) -> "VTable":
        """Gather all columns with ONE batched call on the device; plain
        numpy fancy-indexing on host tables."""
        from ..ops.backend import any_torch

        if self.row_valid is not None:
            raise ValueError(
                "take() on a selection-vector VTable: call .dense() first "
                "(indices would address the padded layout)")
        arrays = {}
        obj_arrays = {}
        for cid, c in self.cols.items():
            # wide-decimal object columns are host-only: gather with numpy,
            # their validity too (a device validity beside host data would
            # mix numpy and tensors in the next expression)
            if is_obj(c.data):
                obj_arrays[("d", cid)] = c.data
                if c.valid is not None:
                    obj_arrays[("v", cid)] = _host_idx(c.valid)
                continue
            arrays[("d", cid)] = c.data
            if c.valid is not None:
                arrays[("v", cid)] = c.valid
        if arrays and any_torch(idx, arrays):
            out = _gather_tree(idx, arrays, monotone)
        else:
            bidx = np.maximum(np.asarray(idx), 0)
            out = {k: np.take(a, bidx, axis=0) for k, a in arrays.items()}
        if obj_arrays:
            hidx = np.maximum(_host_idx(idx), 0)
            out.update({k: a[hidx] for k, a in obj_arrays.items()})
        cols = {}
        for cid, c in self.cols.items():
            cols[cid] = SCol(c.type, out[("d", cid)], out.get(("v", cid)), c.dictionary)
        return VTable(cols, n)

    def select_mask(self, mask, count: Optional[int] = None) -> "VTable":
        """Compact rows where mask is True (one host sync for the count,
        none when the caller knows it: `count`)."""
        from ..ops.backend import xnp

        if mask.ndim == 0:
            mask = xnp.broadcast_to(mask, (self.num_rows,))
        if self.row_valid is not None:
            mask = mask & self.row_valid
            return VTable(self.cols, self.num_rows).select_mask(mask)
        n = int(xnp.sum(mask)) if count is None else count
        if n == self.num_rows:
            return self
        from ..ops import pgather as pg

        if isinstance(mask, torch.Tensor) and pg.use_kernels(mask) and n:
            _, idx = pg.nonzero_positions(mask, n)
        else:
            (idx,) = xnp.nonzero(mask, size=n)
        return self.take(idx, n, monotone=True)

    def merge(self, other: "VTable") -> "VTable":
        """Columns of both, under self's selection vector. other's must be
        the same selection: the same object, or equal values (the sharded
        join hands its sides selection vectors of equal values that are
        not one object). The reference asserts identity alone."""
        if not (self.num_rows == other.num_rows or not self.cols
                or not other.cols):
            raise ValueError("merge of VTables with different row counts")
        if not _same_selection(self.row_valid, other.row_valid):
            raise ValueError("merge of VTables with different selection vectors")
        cols = dict(self.cols)
        cols.update(other.cols)
        return VTable(cols, max(self.num_rows, other.num_rows),
                      row_valid=self.row_valid)


def _same_selection(mine, theirs) -> bool:
    """Whether `theirs` selects the rows `mine` does: no selection vector
    of its own, the same object, or equal values (one comparison, a device
    sync when they are tensors)."""
    if theirs is None or mine is theirs:
        return True
    if mine is None or tuple(mine.shape) != tuple(theirs.shape):
        return False
    if isinstance(mine, torch.Tensor) or isinstance(theirs, torch.Tensor):
        from ..ops.backend import like

        ref = mine if isinstance(mine, torch.Tensor) else theirs
        a, b = like(mine, ref).to(ref.device), like(theirs, ref).to(ref.device)
        return bool(torch.equal(a, b))
    return bool(np.array_equal(mine, theirs))
