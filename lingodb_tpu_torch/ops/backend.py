"""Dual numpy/torch array backend.

Small host-resident tables execute with plain numpy (microsecond dispatch —
the equivalent of the reference running short queries through its fast
Baseline backend instead of the optimizing JIT, src/execution/baseline/);
large device-resident tables execute as torch tensors on the session's
device. Dispatch is automatic per call: if any argument is a torch tensor,
the torch implementation runs and numpy arguments are moved beside it.

`xnp` is a numpy-named facade: the operator modules (ops/scalar.py,
groupby.py, keys.py, join.py, dates.py, runtime/executor.py) are written
against numpy's function names and numpy dtypes, and this module maps both
onto torch. Tensors have no `.astype` and their `.dtype` is a torch dtype, so
the operator modules call `astype(x, dtype)` and `dt(x)` from here instead.
Multi-key sort, segment reductions and scatter updates have explicit twins
below.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

_NP2T = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_T2NP = {v: k for k, v in _NP2T.items()}


def is_torch(x) -> bool:
    return isinstance(x, torch.Tensor)


def any_torch(*values) -> bool:
    for v in values:
        if isinstance(v, torch.Tensor):
            return True
        if isinstance(v, (list, tuple)):
            if any_torch(*v):
                return True
        elif isinstance(v, dict):
            if any_torch(*v.values()):
                return True
    return False


def tdtype(dtype):
    """numpy dtype / scalar type / torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP2T[np.dtype(dtype)]


def dt(x) -> np.dtype:
    """numpy dtype of a numpy array or torch tensor."""
    d = x.dtype
    return _T2NP[d] if isinstance(d, torch.dtype) else np.dtype(d)


def astype(x, dtype):
    """x.astype(dtype) for numpy arrays and torch tensors alike."""
    if isinstance(x, torch.Tensor):
        return x.to(tdtype(dtype))
    return np.asarray(x).astype(dtype)


def view_as(x, dtype):
    """Bit reinterpretation to a same-width dtype (numpy `.view`)."""
    if isinstance(x, torch.Tensor):
        return x.view(tdtype(dtype))
    return np.asarray(x).view(dtype)


class HostRead(Exception):
    """A tensor was read back to the host where no_host_reads() forbids it."""


_no_host_reads = 0


@contextlib.contextmanager
def no_host_reads():
    """Within the block, to_host() of a tensor raises HostRead. The fused
    program runs inside one: an expression that can only be computed on the
    host (exact wide-decimal arithmetic, string formatting) makes it decline
    instead of stalling the card with a read."""
    global _no_host_reads
    _no_host_reads += 1
    try:
        yield
    finally:
        _no_host_reads -= 1


def to_host(x) -> np.ndarray:
    """Tensor or array -> numpy array on the host (a device sync)."""
    if isinstance(x, torch.Tensor):
        if _no_host_reads:
            raise HostRead("tensor read to the host inside a fused program")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def const(value, device, dtype=None) -> torch.Tensor:
    """A 0-dim tensor holding a host scalar, made on `device` by a fill
    kernel: no host-to-device copy, so a CUDA graph can capture it. The
    dtype is torch.tensor's for the value unless given."""
    dtype = None if dtype is None else tdtype(dtype)
    return torch.full((), value, dtype=dtype, device=device)


# The uploads a capture in progress on this thread made (a list that the
# capturing code keeps beside its graph), or None outside a capture.
_capture_uploads = threading.local()


@contextlib.contextmanager
def capture_uploads(keep: list):
    """Within the block, to_device of a host array under capture uploads it
    beside the capture and appends the tensor to `keep`: the graph reads it
    at every replay, so the graph's owner keeps it alive."""
    prev = getattr(_capture_uploads, "keep", None)
    _capture_uploads.keep = keep
    try:
        yield keep
    finally:
        _capture_uploads.keep = prev


def capturing(device) -> bool:
    """Whether this thread's current stream on `device` is being captured
    into a CUDA graph."""
    return (torch.device(device).type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def to_device(x, device) -> torch.Tensor:
    """numpy array (or tensor) -> tensor on `device`. A 0-dim array becomes
    a fill (const). Under a CUDA graph's capture a host array cannot be
    copied on the captured stream (the copy would wait for the host): it is
    copied on a side stream beside the capture, once, and kept with the
    graph (capture_uploads); every replay reads that copy."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    if a.ndim == 0 and a.dtype in _NP2T:
        return const(a.item(), device, a.dtype)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, copy=True)
    if capturing(device):
        keep = getattr(_capture_uploads, "keep", None)
        if keep is None:
            raise RuntimeError("host array uploaded under a capture that "
                               "keeps no uploads (capture_uploads)")
        # the default stream is never the captured one (a capture runs on
        # a side stream) and its copy waits for the host, as it must
        with torch.cuda.stream(torch.cuda.default_stream(device)):
            t = torch.from_numpy(a).to(device)
        keep.append(t)
        return t
    return torch.from_numpy(a).to(device)


def device_of(*values):
    """Device of the first tensor among the arguments (None if none)."""
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
        if isinstance(v, (list, tuple)):
            d = device_of(*v)
            if d is not None:
                return d
    return None


def _co(x, device):
    """Coerce one operand for a torch call: numpy arrays and numpy scalars
    become tensors / Python scalars; tensors and Python scalars pass."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, np.ndarray):
        return to_device(x, device)
    if isinstance(x, np.generic):
        return x.item()
    return x


def _tensor(x, device):
    """Like _co, but Python scalars become 0-dim tensors too."""
    x = _co(x, device)
    if isinstance(x, torch.Tensor):
        return x
    return const(x, device)


# ------------------------------------------------------------ torch twins
def _t_where(c, x, y):
    dev = device_of(c, x, y)
    c = _tensor(c, dev)
    x, y = _co(x, dev), _co(y, dev)
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        # two Python scalars: numpy semantics give int64 / float64 / bool
        both = np.result_type(np.asarray(x), np.asarray(y))
        x, y = const(x, dev, both), const(y, dev, both)
    elif isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
        if x.dtype != y.dtype:
            # numpy promotion, not torch's 0-dim "scalar" rule: an int64
            # constant beside an int32 column widens the column
            both = tdtype(np.promote_types(_T2NP[x.dtype], _T2NP[y.dtype]))
            x, y = x.to(both), y.to(both)
    return torch.where(c.to(torch.bool) if c.dtype != torch.bool else c, x, y)


def _t_zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=None if dtype is None else tdtype(dtype))


def _t_ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=None if dtype is None else tdtype(dtype))


def _t_asarray(x, dtype=None):
    if dtype is None:
        return x
    return x.to(tdtype(dtype))


def _t_broadcast_to(x, shape):
    return torch.broadcast_to(x, tuple(shape))


def _t_take(a, idx, axis=0, mode=None):
    dev = device_of(a, idx)
    a, idx = _tensor(a, dev), _tensor(idx, dev)
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.to(torch.int64)
    if mode == "clip":
        idx = idx.clamp(0, max(a.shape[0] - 1, 0))
    if a.ndim == 1 and idx.ndim == 0:
        # a 0-dim index would be read to the host as an integer
        return a[idx.reshape(1)].reshape(())
    if a.ndim == 1 and idx.ndim <= 1:
        return a[idx]
    return torch.index_select(a, axis, idx.reshape(-1).to(torch.int64))


def _t_clip(x, lo, hi):
    return torch.clamp(x, min=_scalar(lo), max=_scalar(hi))


def _scalar(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim == 0:
        return v.item()
    return v


def _t_cumsum(x, dtype=None, axis=0):
    # torch widens int32 sums to int64; numpy keeps the input dtype
    out = torch.cumsum(x, dim=axis)
    want = x.dtype if dtype is None else tdtype(dtype)
    if x.dtype == torch.bool and dtype is None:
        want = torch.int64
    return out if out.dtype == want else out.to(want)


def _t_concatenate(parts, axis=0):
    dev = device_of(*parts)
    ts = [_tensor(p, dev) for p in parts]
    dts = {t.dtype for t in ts}
    if len(dts) > 1:
        both = tdtype(np.result_type(*[_T2NP[d] for d in dts]))
        ts = [t.to(both) for t in ts]
    return torch.cat(ts, dim=axis)


def _t_searchsorted(a, v, side="left"):
    dev = device_of(a, v)
    a, v = _tensor(a, dev), _tensor(v, dev)
    if a.dtype != v.dtype:
        both = tdtype(np.promote_types(_T2NP[a.dtype], _T2NP[v.dtype]))
        a, v = a.to(both), v.to(both)
    return torch.searchsorted(a.contiguous(), v.contiguous(),
                              right=(side == "right"))


def _t_nonzero(mask, size=None, fill_value=0):
    (pos,) = torch.nonzero(mask, as_tuple=True)
    if size is not None and pos.shape[0] != size:
        if pos.shape[0] > size:
            pos = pos[:size]
        else:
            pad = torch.full((size - pos.shape[0],), fill_value,
                             dtype=pos.dtype, device=pos.device)
            pos = torch.cat([pos, pad])
    return (pos,)


def _binary(fn):
    def call(x, y):
        dev = device_of(x, y)
        x, y = _co(x, dev), _co(y, dev)
        if not isinstance(x, torch.Tensor):
            x = const(x, dev)
        return fn(x, y)

    return call


def _t_floor_divide(x, y):
    dev = device_of(x, y)
    x, y = _co(x, dev), _co(y, dev)
    if not isinstance(x, torch.Tensor):
        x = const(x, dev)
    return torch.div(x, y, rounding_mode="floor")


def _reduce(fn):
    def call(x, axis=None):
        return fn(x) if axis is None else fn(x, dim=axis)

    return call


def _t_sum(x, axis=None, dtype=None):
    if x.dtype == torch.bool:
        x = x.to(torch.int64)
    out = torch.sum(x) if axis is None else torch.sum(x, dim=axis)
    want = tdtype(dtype) if dtype is not None else (
        x.dtype if x.dtype.is_floating_point else torch.int64)
    return out if out.dtype == want else out.to(want)


def _t_min(x, axis=None):
    return torch.min(x) if axis is None else torch.min(x, dim=axis).values


def _t_max(x, axis=None):
    return torch.max(x) if axis is None else torch.max(x, dim=axis).values


def _t_repeat(x, n):
    return torch.repeat_interleave(x, n)


def _t_tile(x, n):
    return x.repeat(n)


def _t_power(x, y):
    dev = device_of(x, y)
    return torch.pow(_tensor(x, dev), _co(y, dev))


def _f64(fn):
    def call(x):
        return fn(x if x.dtype.is_floating_point else x.to(torch.float64))

    return call


_TORCH = {
    "where": _t_where,
    "zeros_like": _t_zeros_like,
    "ones_like": _t_ones_like,
    "asarray": _t_asarray,
    "array": _t_asarray,
    "broadcast_to": _t_broadcast_to,
    "take": _t_take,
    "clip": _t_clip,
    "cumsum": _t_cumsum,
    "concatenate": _t_concatenate,
    "searchsorted": _t_searchsorted,
    "nonzero": _t_nonzero,
    "floor_divide": _t_floor_divide,
    "trunc": torch.trunc,
    "sign": torch.sign,
    "abs": torch.abs,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "sqrt": _f64(torch.sqrt),
    "exp": _f64(torch.exp),
    "log": _f64(torch.log),
    "log10": _f64(torch.log10),
    "log2": _f64(torch.log2),
    "sin": _f64(torch.sin),
    "cos": _f64(torch.cos),
    "power": _t_power,
    "maximum": _binary(lambda x, y: torch.maximum(x, y) if isinstance(
        y, torch.Tensor) else torch.clamp(x, min=y)),
    "minimum": _binary(lambda x, y: torch.minimum(x, y) if isinstance(
        y, torch.Tensor) else torch.clamp(x, max=y)),
    "equal": _binary(torch.eq),
    "not_equal": _binary(torch.ne),
    "less": _binary(torch.lt),
    "less_equal": _binary(torch.le),
    "greater": _binary(torch.gt),
    "greater_equal": _binary(torch.ge),
    "add": _binary(torch.add),
    "subtract": _binary(torch.sub),
    "sum": _t_sum,
    "min": _t_min,
    "max": _t_max,
    "any": _reduce(torch.any),
    "all": _reduce(torch.all),
    "repeat": _t_repeat,
    "tile": _t_tile,
}


class _XNP:
    """Attribute proxy: xnp.foo(...) -> np.foo, or its torch twin when an
    argument is a tensor. Array-free calls (zeros, ones, arange, asarray of
    host data, dtype queries) are numpy's: constants are built on the host
    and moved to the device by the first operation that meets a tensor."""

    def __getattr__(self, name):
        nf = getattr(np, name)
        if isinstance(nf, type) or not callable(nf):
            return nf  # dtypes like int64/bool_, constants like inf/newaxis
        tf = _TORCH.get(name)

        def call(*args, **kwargs):
            if any_torch(args, kwargs):
                if tf is None:
                    raise NotImplementedError(
                        f"xnp.{name} has no torch twin")
                return tf(*args, **kwargs)
            if name == "nonzero" and "size" in kwargs:
                kwargs = {k: v for k, v in kwargs.items()
                          if k not in ("size", "fill_value")}
            if name == "take" and kwargs.get("mode") == "clip":
                a = np.asarray(args[0])
                idx = np.clip(np.asarray(args[1]), 0, max(a.shape[0] - 1, 0))
                return np.take(a, idx, axis=kwargs.get("axis", 0))
            return nf(*args, **kwargs)

        call.__name__ = name
        return call


xnp = _XNP()


def fdiv(x, y):
    """True division in float64 (numpy's rule for integer operands; a torch
    integer tensor divided by a Python float would give float32)."""
    if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
        dev = device_of(x, y)
        x, y = _co(x, dev), _co(y, dev)
        if isinstance(x, torch.Tensor) and x.dtype != torch.float32:
            x = x.to(torch.float64)
        if isinstance(y, torch.Tensor) and y.dtype != torch.float32:
            y = y.to(torch.float64)
        return x / y
    return x / y


def like(x, ref):
    """Place host array `x` beside `ref`: a tensor on ref's device when ref
    is a tensor, else unchanged."""
    if isinstance(ref, torch.Tensor) and not isinstance(x, torch.Tensor):
        return _tensor(x, ref.device)
    return x


# ------------------------------------------------------------------ sorting
def multi_sort(operands: list, num_keys: int) -> list:
    """Lexicographic, stable multi-key sort of parallel arrays; the non-key
    trailing operands are permuted along. Torch: successive stable sorts
    from the last key to the first, composed into one permutation."""
    if any_torch(operands):
        dev = device_of(operands)
        ops = [_tensor(o, dev) for o in operands]
        n = ops[0].shape[0]
        perm = None
        for k in reversed(ops[:num_keys]):
            kk = k if perm is None else k[perm]
            if kk.dtype == torch.bool:
                kk = kk.to(torch.uint8)
            order = torch.sort(kk, stable=True).indices
            perm = order if perm is None else perm[order]
        if perm is None:
            perm = torch.arange(n, device=dev)
        return [o[perm] for o in ops]
    keys = operands[:num_keys]
    perm = np.lexsort(tuple(reversed(keys)))
    return [np.asarray(o)[perm] for o in operands]


# ------------------------------------------------------- segment reductions
#
# Torch strategies: a scatter reduction (index_add_ / scatter_reduce_) for
# unsorted segment ids, and for sorted ids a cumulative sum read at the
# segment boundaries (its integer result does not depend on the order atomics
# happen to run in; float sums of the scatter form do).
#
# A scatter-add of millions of rows into a handful of segments serializes on
# the atomics of those few addresses (TPC-H q1 at SF1 on an H100: 20
# index_add_ calls into 4 groups took 47 of the query's 67 ms, PERF.md). For
# few segments and many rows the sum is therefore spread first: row i adds
# into copy (i mod SPREAD_LANES) of its segment, and the copies are summed.
SPREAD_LANES = 1024
SPREAD_MAX_SEGMENTS = 1024   # times SPREAD_LANES accumulators at most
SPREAD_MIN_ROWS = 1 << 16
def _extreme_t(dtype: torch.dtype, maximum: bool):
    if dtype.is_floating_point:
        return float("inf") if maximum else float("-inf")
    if dtype == torch.bool:
        return bool(maximum)
    info = torch.iinfo(dtype)
    return info.max if maximum else info.min


def _sorted_segment_sum_t(vals, seg, num_segments):
    cs = torch.cumsum(vals, dim=0)
    ids = torch.arange(num_segments, dtype=seg.dtype, device=seg.device)
    seg = seg.contiguous()
    ends = torch.searchsorted(seg, ids, right=True)
    starts = torch.searchsorted(seg, ids, right=False)
    zero = torch.zeros((), dtype=cs.dtype, device=cs.device)
    tot = torch.where(ends > 0, cs[(ends - 1).clamp(min=0)], zero)
    lo = torch.where(starts > 0, cs[(starts - 1).clamp(min=0)], zero)
    return (tot - lo).to(vals.dtype)


def _segment_torch(vals, seg, num_segments, indices_are_sorted, kind):
    dev = device_of(vals, seg)
    vals, seg = _tensor(vals, dev), _tensor(seg, dev)
    was_bool = vals.dtype == torch.bool
    if was_bool:
        vals = vals.to(torch.uint8 if kind != "sum" else torch.int64)
    if vals.shape[0] == 0:
        fill = 0 if kind == "sum" else _extreme_t(vals.dtype, kind == "min")
        out = torch.full((num_segments,) + tuple(vals.shape[1:]), fill,
                         dtype=vals.dtype, device=dev)
        return out.to(torch.bool) if was_bool and kind != "sum" else out
    if (kind == "sum" and indices_are_sorted and vals.ndim == 1
            and not vals.dtype.is_floating_point):
        return _sorted_segment_sum_t(vals, seg, num_segments)
    seg = seg.to(torch.int64)
    if kind == "sum":
        n = vals.shape[0]
        if (vals.ndim == 1 and n >= SPREAD_MIN_ROWS
                and 0 < num_segments <= SPREAD_MAX_SEGMENTS):
            lane = torch.arange(n, device=dev) & (SPREAD_LANES - 1)
            wide = torch.zeros((num_segments * SPREAD_LANES,),
                               dtype=vals.dtype, device=dev)
            wide.index_add_(0, seg * SPREAD_LANES + lane, vals)
            return wide.view(num_segments, SPREAD_LANES).sum(dim=1).to(vals.dtype)
        out = torch.zeros((num_segments,) + tuple(vals.shape[1:]),
                          dtype=vals.dtype, device=dev)
        out.index_add_(0, seg, vals)
        return out
    fill = _extreme_t(vals.dtype, kind == "min")
    out = torch.full((num_segments,), fill, dtype=vals.dtype, device=dev)
    out.scatter_reduce_(0, seg, vals, "amin" if kind == "min" else "amax",
                        include_self=True)
    return out.to(torch.bool) if was_bool else out


def segment_sum(vals, seg, num_segments: int, indices_are_sorted=False):
    if any_torch(vals, seg):
        return _segment_torch(vals, seg, num_segments, indices_are_sorted, "sum")
    out = np.zeros((num_segments,) + np.shape(vals)[1:], dtype=np.asarray(vals).dtype)
    np.add.at(out, np.asarray(seg), np.asarray(vals))
    return out


def segment_min(vals, seg, num_segments: int, indices_are_sorted=False):
    if any_torch(vals, seg):
        return _segment_torch(vals, seg, num_segments, indices_are_sorted, "min")
    vals = np.asarray(vals)
    out = np.full((num_segments,), _extreme_np(vals.dtype, True), dtype=vals.dtype)
    np.minimum.at(out, np.asarray(seg), vals)
    return out


def segment_max(vals, seg, num_segments: int, indices_are_sorted=False):
    if any_torch(vals, seg):
        return _segment_torch(vals, seg, num_segments, indices_are_sorted, "max")
    vals = np.asarray(vals)
    out = np.full((num_segments,), _extreme_np(vals.dtype, False), dtype=vals.dtype)
    np.maximum.at(out, np.asarray(seg), vals)
    return out


def _extreme_np(dtype, maximum: bool):
    if np.issubdtype(dtype, np.floating):
        return np.inf if maximum else -np.inf
    if dtype == np.bool_:
        return True if maximum else False
    if dtype == np.object_:
        # wide-decimal sentinel: beyond any decimal(38) scaled value
        return 10**40 if maximum else -(10**40)
    info = np.iinfo(dtype)
    return info.max if maximum else info.min


# ------------------------------------------------------------------ scatter
def set_at(arr, idx, vals):
    """Copy of arr with arr[idx] = vals (copy-on-write semantics). With
    duplicate indices which write wins is unspecified, as in the reference."""
    if any_torch(arr, idx, vals):
        dev = device_of(arr, idx, vals)
        out = _tensor(arr, dev).clone()
        idx = _tensor(idx, dev).to(torch.int64)
        vals = _tensor(vals, dev).to(out.dtype)
        out.index_put_((idx,), vals)
        return out
    out = np.array(arr, copy=True)
    out[idx] = vals
    return out


def first_true(n: int, like=None):
    """Length-n bool vector with only position 0 True."""
    if like is not None and is_torch(like):
        out = torch.zeros((n,), dtype=torch.bool, device=like.device)
        if n:
            out[0] = True
        return out
    out = np.zeros((n,), np.bool_)
    if n:
        out[0] = True
    return out


def cummax(v):
    """Cumulative maximum."""
    if is_torch(v):
        if v.shape[0] == 0:
            return v
        return torch.cummax(v, dim=0).values
    return np.maximum.accumulate(v)


def rev_cummin(v):
    """Reverse cumulative minimum: out[i] = min(v[i:])."""
    if is_torch(v):
        if v.shape[0] == 0:
            return v
        return torch.cummin(v.flip(0), dim=0).values.flip(0)
    return np.minimum.accumulate(v[::-1])[::-1]


def segmented_scan_minmax(vals, pb, is_min: bool):
    """Within-segment running min/max; pb flags segment starts (segmented
    scan by log2(n) Hillis-Steele doubling passes over (value, flag)
    pairs, the same combine for numpy arrays and tensors)."""
    if any_torch(vals, pb):
        dev = device_of(vals, pb)
        v = _tensor(vals, dev).clone()
        f = _tensor(pb, dev).to(torch.bool).clone()
        n = v.shape[0]
        d = 1
        while d < n:
            pv, pf = v[:-d], f[:-d]
            nv, nf = v[d:], f[d:]
            m = torch.minimum(pv, nv) if is_min else torch.maximum(pv, nv)
            v = torch.cat([v[:d], torch.where(nf, nv, m)])
            f = torch.cat([f[:d], pf | nf])
            d *= 2
        return v
    v = np.array(vals, copy=True)
    f = np.array(pb, copy=True)
    n = len(v)
    d = 1
    while d < n:
        pv, pf = v[:-d], f[:-d]
        nv, nf = v[d:], f[d:]
        m = np.minimum(pv, nv) if is_min else np.maximum(pv, nv)
        v = np.concatenate([v[:d], np.where(nf, nv, m)])
        f = np.concatenate([f[:d], pf | nf])
        d *= 2
    return v


def lut_take(lut, codes):
    """Gather a host-built lookup table by device codes. Routes through the
    kernel-aware dispatcher (ops/pgather.py): dictionary LUTs are small, so
    on the card this is the shared-memory small-table gather. Codes outside
    the table clamp to its ends on both tiers, as pgather.take_fast clamps
    them (a NULL row's code may be any value)."""
    if is_torch(codes):
        from . import pgather

        return pgather.take_fast(to_device(lut, codes.device), codes)
    return np.take(np.asarray(lut), np.asarray(codes), mode="clip")


def iota(n: int, dtype, ref=None):
    """arange(n) of `dtype`, built on ref's device when ref is a tensor (no
    host array is made and uploaded), else a numpy array."""
    if isinstance(ref, torch.Tensor):
        return torch.arange(n, dtype=tdtype(dtype), device=ref.device)
    return np.arange(n, dtype=dtype)


def full(n: int, value, dtype, ref=None):
    """Length-n constant vector of `dtype`, on ref's device when ref is a
    tensor, else a numpy array."""
    if isinstance(ref, torch.Tensor):
        return torch.full((n,), value, dtype=tdtype(dtype), device=ref.device)
    return np.full((n,), value, dtype=dtype)
