"""Hand-written CUDA kernels for the engine's hot data-movement primitives,
and the dispatcher that routes gathers and compactions to them.

The reference engine's JIT'd tuple loops (lingo-db: src/runtime/Hashtable.cpp,
LazyJoinHashtable.cpp:7-32, generated per-morsel loops) run these at memory
speed. Kernels (sources under csrc/; the two gathers take planes of 1, 2,
4 or 8 bytes, each gathered at its own width, up to 8 of any widths a
launch):

  gather_chunked_planes(tables, idx)  table <= CHUNK_TABLE_LIMIT entries:
                                      the tables in shared memory, indices
                                      streamed through them (tables of at
                                      most 64 KB, or few rows against the
                                      table: read through L1 instead).
  compact_positions(mask, k)          ascending positions of mask's set
                                      bits and their exact count: one pass
                                      with decoupled look-back.
  gather_sorted_planes(tables, idx)   idx monotone nondecreasing (post-filter
                                      positions, sorted-FK probes): one index
                                      decode shared by all planes, reads
                                      coalesce because neighbours are near
                                      (sparse: a block a plane, to keep
                                      the loads in flight).
  segscan_i32(gid, vals)              segmented inclusive sum of int32
                                      planes over a sorted key: one pass
                                      with decoupled look-back. No engine
                                      caller; run by tools/kbench.py.

Beside each kernel stands a plain PyTorch version (`*_plain`) of the same
signature. A wrapper takes it only for tensors that lie on the CPU; for CUDA
tensors it launches the kernel or raises. Each wrapper counts its launches in
LAUNCHES, and nowhere else. A call captured into a CUDA graph launches
nothing: it is counted in the capture's tally (capture_scratch), which the
graph's owner adds to LAUNCHES at every replay (runtime/exestore.py).
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np
import torch

from . import backend as be

SENTINEL = 2147483646
CHUNK_TABLE_LIMIT = 16384
_MAX_PLANES = 8  # per kernel call (the kernels' pointer tables hold 8)
# log2 of a plane element's bytes, by its dtype's itemsize: the two gathers
# copy elements of these widths as bits, so every dtype of them is exact
_LOG2_WIDTH = {1: 0, 2: 1, 4: 2, 8: 3}
# the two gathers' packed call (csrc/gather_planes.cuh): 6 header words,
# then 5 a plane
_DESC = [struct.Struct(f"<{6 + 5 * c}q") for c in range(_MAX_PLANES + 1)]
_KERNEL_FN: dict = {}  # kernel name -> its bound C entry point

# launches per kernel since the last reset_counters()
LAUNCHES = {"compact_positions": 0, "gather_sorted": 0, "gather_chunked": 0,
            "segscan": 0, "checked_arith": 0}


def reset_counters() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launched(name: str, capturing: bool | None = None) -> None:
    """One launch of kernel `name` by its wrapper: counted in LAUNCHES, or,
    where the call is being captured, in the capture's tally. `capturing`
    is what the launch saw (the gathers' entry points report it), else it is
    asked of the current stream."""
    if capturing is None:
        capturing = torch.cuda.is_current_stream_capturing()
    if capturing:
        tally = getattr(_compact_local, "tally", None)
        if tally is not None:
            tally[name] = tally.get(name, 0) + 1
    else:
        LAUNCHES[name] += 1


def count_replay(tally: dict) -> None:
    """The launches of one replay of a graph whose capture counted
    `tally`."""
    for name, v in tally.items():
        LAUNCHES[name] += v


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def _check_rc(rc: int, what: str) -> None:
    """Raise for a gather entry point's negative return (a CUDA error, or
    at or below -10000 arguments it does not take)."""
    if rc <= -10000:
        raise ValueError(f"{what}: arguments refused by the kernel ({rc})")
    if rc < 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {-rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_planes(tables, idx, what: str, meta=None) -> int:
    """The table length s of a gather's planes: 1..8 equal-length 1-D
    tensors of 1, 2, 4 or 8-byte elements on idx's device, idx int32.
    Reads cheap attributes only, each once; `meta`, where given, receives
    each plane's (dtype, data pointer, element stride)."""
    if not 1 <= len(tables) <= _MAX_PLANES:
        raise ValueError(f"{what}: 1..{_MAX_PLANES} planes, got {len(tables)}")
    if idx.dtype != torch.int32:
        raise ValueError(f"{what}: idx must be int32")
    dev = idx.get_device()
    s = -1
    for t in tables:
        shape, dt = t.shape, t.dtype
        if len(shape) != 1 or (s >= 0 and shape[0] != s):
            raise ValueError(f"{what}: planes must be equal-length 1-D")
        s = shape[0]
        if dt.itemsize not in _LOG2_WIDTH:
            raise ValueError(f"{what}: planes of 1, 2, 4 or 8-byte elements, "
                             f"got {dt}")
        if t.get_device() != dev:
            raise ValueError(f"{what}: planes and idx on different devices")
        if meta is not None:
            meta.append((dt, t.data_ptr(), t.stride()[0]))
    if s < 1:
        raise ValueError(f"{what}: empty table")
    if s > 2147483647:
        raise ValueError(f"{what}: table too long for int32 positions")
    return s


def _alloc_outs(dtypes, n: int, device):
    """Output planes of n rows of `dtypes` and their (data pointer, element
    stride): planes of one dtype share one allocation, each row 16-byte
    aligned (its pointer computed, not asked)."""
    dt = dtypes[0]
    if len(dtypes) == 1:
        o = torch.empty((n,), dtype=dt, device=device)
        return [o], [(o.data_ptr(), 1)]
    if all(d == dt for d in dtypes):
        w = dt.itemsize
        row = -(-n * w // 16) * 16 // w
        buf = torch.empty((len(dtypes) * row,), dtype=dt, device=device)
        base = buf.data_ptr()
        outs = list(buf.as_strided((len(dtypes), n), (row, 1)).unbind(0))
        return outs, [(base + p * row * w, 1) for p in range(len(dtypes))]
    outs = [torch.empty((n,), dtype=d, device=device) for d in dtypes]
    return outs, [(o.data_ptr(), 1) for o in outs]


def _given_outs(meta, n: int, outs, dev: int):
    """The caller's output planes, checked, and their (pointer, stride)."""
    if len(outs) != len(meta):
        raise ValueError("one output plane per plane")
    words = []
    for (dt, _ptr, _stride), o in zip(meta, outs):
        if o.dtype != dt or o.dim() != 1 or o.shape[0] != n:
            raise ValueError("output planes must be 1-D of idx's length and "
                             "their plane's dtype")
        if o.get_device() != dev:
            raise ValueError("output planes on another device")
        words.append((o.data_ptr(), o.stride()[0]))
    return list(outs), words


def _gather(name: str, tables, idx, outs, limit: int):
    """The CUDA path of gather kernel `name` (ldb_<name>) for 1-D contiguous
    idx: the planes checked (s <= limit), the outputs made (or `outs`
    checked), and one launch on idx's device and current stream, the call
    packed into one buffer of int64 words. Returns the output planes."""
    meta = []
    s = _check_planes(tables, idx, name, meta)
    if s > limit:
        raise ValueError(f"{name}: table of {s} entries exceeds {limit}")
    n = idx.shape[0]
    dev = idx.get_device()
    if outs is None:
        outs, out_words = _alloc_outs([m[0] for m in meta], n, idx.device)
    else:
        outs, out_words = _given_outs(meta, n, outs, dev)
    if n:
        fn = _KERNEL_FN.get(name)
        if fn is None:
            from . import cuda_build

            fn = _KERNEL_FN[name] = getattr(cuda_build.lib(name), f"ldb_{name}")
        words = [len(tables), n, s, idx.data_ptr(),
                 torch._C._cuda_getCurrentRawStream(dev), dev]
        for (dt, ptr, stride), (out, out_stride) in zip(meta, out_words):
            words += (ptr, out, stride, out_stride, _LOG2_WIDTH[dt.itemsize])
        rc = fn(_DESC[len(tables)].pack(*words))
        _check_rc(rc, name)
        _launched(name, rc == 1)
    return outs


# --------------------------------------------------------------------------
# K1: gather_chunked — whole small table in shared memory
# --------------------------------------------------------------------------

def gather_chunked_planes_plain(tables, idx):
    """Plain PyTorch version of gather_chunked_planes."""
    s = int(tables[0].shape[0])
    j = idx.to(torch.int64).clamp(0, s - 1)
    return [t[j] for t in tables]


def gather_chunked_planes(tables, idx, outs=None):
    """[t[clip(idx)] for t in tables] for 1..8 equal-length 1-D tables of
    <= CHUNK_TABLE_LIMIT entries, each of 1, 2, 4 or 8-byte elements and
    gathered at its own dtype; idx any shape int32. One kernel launch.
    `outs` may name preallocated 1-D outputs (idx must then be 1-D)."""
    if not idx.is_cuda:
        s = _check_planes(tables, idx, "gather_chunked")
        if s > CHUNK_TABLE_LIMIT:
            raise ValueError(f"gather_chunked: table of {s} entries exceeds "
                             f"{CHUNK_TABLE_LIMIT}")
        res = gather_chunked_planes_plain(tables, idx)
        if outs is not None:
            for o, r in zip(outs, res):
                o.copy_(r)
            return list(outs)
        return res
    flat = idx.reshape(-1)
    if not flat.is_contiguous():
        flat = flat.contiguous()
    outs = _gather("gather_chunked", tables, flat, outs, CHUNK_TABLE_LIMIT)
    if idx.dim() == 1:
        return outs
    return [o.view(idx.shape) for o in outs]


def gather_chunked_i32(table, idx):
    """table[clip(idx)] for a 1-D table with <= CHUNK_TABLE_LIMIT entries
    (the one-plane case); idx any shape int32. Out-of-range indices are
    clamped."""
    return gather_chunked_planes([table], idx)[0]


# --------------------------------------------------------------------------
# K3: compact_positions — stream compaction of set-bit positions
# --------------------------------------------------------------------------

_compact_tile = 0  # mask bytes per tile, asked of the built library once
# The look-back's scratch of compact_positions: the call number and tile
# counter in word 0, then a status word a tile. The kernel numbers its calls
# itself (a prologue launch bumps the number and zeroes the counter), so a
# scratch needs no host state, only one owner at a time: uncaptured calls
# take the scratch of their thread, device and stream (two threads on one
# stream each launch two kernels a call, so they must not share one), and a
# call captured in a CUDA graph takes the graph's (capture_scratch). A
# scratch made under capture would come out of the graph's private pool,
# which the graph's replays overwrite: a wrapper never makes one there.
_compact_local = threading.local()
# status words of a graph's scratch: enough for any mask (n < 2^31), 4 MiB
CAPTURE_SCRATCH_WORDS = 1 + -(-(2 ** 31 - 1) // 4096)


def new_compact_scratch(device, words: int = CAPTURE_SCRATCH_WORDS):
    """A zeroed compact_positions scratch of `words` int64 words (call
    number 0). Made outside any capture: a graph keeps one for its replays."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("compact_positions: a scratch made under capture "
                           "would live in the graph's pool")
    return torch.zeros((words,), dtype=torch.int64, device=device)


class capture_scratch:
    """Within the block, compact_positions calls on this thread that are
    being captured use `scratch` (made by new_compact_scratch before the
    capture began), and the kernel calls captured are counted by name in
    `tally`, if given."""

    def __init__(self, scratch, tally=None):
        self.scratch, self.tally = scratch, tally

    def __enter__(self):
        self.prev = (getattr(_compact_local, "captured", None),
                     getattr(_compact_local, "tally", None))
        _compact_local.captured, _compact_local.tally = self.scratch, self.tally
        return self.scratch

    def __exit__(self, *exc):
        _compact_local.captured, _compact_local.tally = self.prev


def _compact_scratch_for(device, stream: int, n: int, capturing: bool):
    """The scratch of a compact_positions call over n mask bytes: the
    graph's while a capture is on (it must hold n), else this thread's for
    (device, stream), made or grown (zeroed, twice the old size) here."""
    words = 1 + -(-n // _compact_tile)
    if capturing:
        buf = getattr(_compact_local, "captured", None)
        if buf is None:
            raise RuntimeError("compact_positions captured without a "
                               "scratch of the graph's (capture_scratch)")
        if buf.numel() < words:
            raise RuntimeError(f"compact_positions: the graph's scratch holds "
                               f"{buf.numel()} words, {words} needed")
        return buf
    mine = getattr(_compact_local, "scratch", None)
    if mine is None:
        mine = _compact_local.scratch = {}
    key = (str(device), stream)
    buf = mine.get(key)
    if buf is None or buf.numel() < words:
        old = 0 if buf is None else buf.numel()
        buf = mine[key] = new_compact_scratch(device, max(words, 2 * old))
    return buf


def compact_positions_plain(mask, k: int):
    """Plain PyTorch version of compact_positions."""
    (pos,) = torch.nonzero(mask.reshape(-1) != 0, as_tuple=True)
    cnt = pos.shape[0]
    out = torch.full((k,), SENTINEL, dtype=torch.int32, device=mask.device)
    out[: min(cnt, k)] = pos[:k].to(torch.int32)
    return be.const(cnt, mask.device, torch.int32), out


def compact_positions(mask, k: int):
    """Positions (int32, ascending) of the set bits of 1-D `mask`, in a
    k-slot output. Returns (count, positions): count is a 0-dim int32 tensor
    and is exact even when it exceeds k (the positions are then truncated —
    callers must check). Slots past the count hold SENTINEL, so positions are
    nondecreasing over their whole length."""
    if mask.ndim != 1:
        raise ValueError("compact_positions: mask must be 1-D")
    if not mask.is_cuda:
        return compact_positions_plain(mask, k)
    from . import cuda_build

    n = int(mask.shape[0])
    if n >= 2147483647:
        raise ValueError("compact_positions: mask too long for int32 positions")
    m = mask if mask.dtype in (torch.bool, torch.uint8, torch.int8) else mask != 0
    m = m.contiguous()
    if m.data_ptr() % 16:
        m = m.clone()  # the kernel loads 16 mask bytes at a time
    if n == 0:
        out = torch.full((k,), SENTINEL, dtype=torch.int32, device=mask.device)
        return torch.zeros((), dtype=torch.int32, device=mask.device), out
    lib = cuda_build.lib("compact_positions")
    global _compact_tile
    if not _compact_tile:
        _compact_tile = lib.ldb_compact_tile()
    # one allocation: the k slots (rounded up to 16 bytes), then the count
    kp = -(-k // 4) * 4
    work = torch.empty((kp + 1,), dtype=torch.int32, device=mask.device)
    stream = _stream(mask)
    scratch = _compact_scratch_for(mask.device, stream, n,
                                   torch.cuda.is_current_stream_capturing())
    with torch.cuda.device(mask.device):
        err = lib.ldb_compact_positions(
            m.data_ptr(), n, work.data_ptr(), k, work.data_ptr() + 4 * kp,
            scratch.data_ptr(), 8 * scratch.numel(), stream)
    _launched("compact_positions")
    _check(err, "compact_positions")
    return work[kp], work[:k]


# --------------------------------------------------------------------------
# K2: gather_sorted — monotone indices, one decode for all planes
# --------------------------------------------------------------------------

def gather_sorted_planes_plain(tables, idx):
    """Plain PyTorch version of gather_sorted_planes."""
    s = int(tables[0].shape[0])
    j = idx.to(torch.int64).clamp(0, max(s - 1, 0))
    return [t[j] for t in tables]


def gather_sorted_planes(tables, idx, outs=None):
    """[t[clip(idx)] for t in tables] for 1..8 equal-length 1-D tables,
    each of 1, 2, 4 or 8-byte elements and gathered at its own dtype, and
    monotone nondecreasing 1-D int32 idx, in ONE kernel launch.

    The CUDA kernel reads global memory directly and so serves every index,
    sorted or not: unsorted indices cost only coalescing. The reference's
    kernel serves indices from an on-chip window and reports those outside
    it in an overflow count (sized by `d_chunks`, `t_rows`, `conservative`);
    none of that has a counterpart here, so the port returns the values
    alone."""
    if idx.dim() != 1:
        raise ValueError("gather_sorted: idx must be 1-D")
    if not idx.is_cuda:
        _check_planes(tables, idx, "gather_sorted")
        res = gather_sorted_planes_plain(tables, idx)
        if outs is not None:
            for o, r in zip(outs, res):
                o.copy_(r)
            return list(outs)
        return res
    if not idx.is_contiguous():
        idx = idx.contiguous()
    return _gather("gather_sorted", tables, idx, outs, 2147483647)


def gather_sorted_i32(table, idx):
    """Single-plane gather_sorted_planes (the one-plane case, for tests and
    direct callers)."""
    return gather_sorted_planes([table], idx)[0]


# --------------------------------------------------------------------------
# K4: segscan — segmented inclusive sum over a sorted int32 key
# --------------------------------------------------------------------------

def _plane_args(tables, outs):
    """ctypes pointer/stride arrays for a group of (possibly strided) int32
    planes."""
    c = len(tables)
    ptr_t, i64_t = ctypes.c_void_p * c, ctypes.c_int64 * c
    return (ptr_t(*[t.data_ptr() for t in tables]),
            i64_t(*[t.stride(0) for t in tables]),
            ptr_t(*[o.data_ptr() for o in outs]),
            i64_t(*[o.stride(0) if o.numel() > 1 else 1 for o in outs]))


def _segscan_scratch(n: int, widths, tile_rows):
    """Where each launch's scratch lies in the one zeroed int64 buffer of a
    segscan_i32 call, and the buffer's length: a launch of W planes takes
    its tile counter and ceil(n / tile_rows(W)) x W status words."""
    offsets, total = [], 0
    for w in widths:
        offsets.append(total)
        total += 1 + -(-n // tile_rows(w)) * w
    return offsets, total


def segscan_i32_plain(gid, vals):
    """Plain PyTorch version of segscan_i32: an int64 cumulative sum read
    back at each row's run start, wrapped to int32. gid is sorted, so a
    row's run starts where a binary search for its own id lands."""
    gid = gid.contiguous()
    start = torch.searchsorted(gid, gid, side="left")
    out = []
    for v in vals:
        v64 = v.to(torch.int64)
        cs = torch.cumsum(v64, dim=0)
        s = (cs - (cs - v64)[start]) & 0xFFFFFFFF
        out.append(torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32))
    return out


def segscan_i32(gid, vals):
    """Segmented inclusive scan (sum) of each (n,) int32 plane in `vals` over
    sorted nondecreasing int32 `gid`: out[w][i] is the sum of vals[w] over
    the run of equal gid that ends at row i (run totals land on each run's
    last row). int32 adds wrap: callers limb-split to stay exact. The kernel
    masks its own ragged edge, so nothing is padded; up to _MAX_PLANES
    planes share one launch."""
    if gid.ndim != 1 or gid.dtype != torch.int32:
        raise ValueError("segscan: gid must be 1-D int32")
    n = int(gid.shape[0])
    for v in vals:
        if v.dtype != torch.int32 or v.ndim != 1 or int(v.shape[0]) != n:
            raise ValueError("segscan: planes must be 1-D int32 of gid's length")
        if v.device != gid.device:
            raise ValueError("segscan: planes and gid on different devices")
    if not gid.is_cuda:
        return segscan_i32_plain(gid, vals)
    from . import cuda_build

    if not vals or n == 0:
        return [torch.empty((0,), dtype=torch.int32, device=gid.device)
                for _ in vals]
    if n >= 2147483647:
        raise ValueError("segscan: gid too long")
    lib = cuda_build.lib("segscan")
    gid = gid.contiguous()
    outs, _ = _alloc_outs([v.dtype for v in vals], n, gid.device)
    starts = range(0, len(vals), _MAX_PLANES)
    offsets, total = _segscan_scratch(
        n, [len(vals[g0:g0 + _MAX_PLANES]) for g0 in starts], lib.ldb_segscan_tile)
    # the look-back's status words must read "not ready": one memset a call
    scratch = torch.zeros((total,), dtype=torch.int64, device=gid.device)
    for g0, off in zip(starts, offsets):
        grp, grp_out = vals[g0:g0 + _MAX_PLANES], outs[g0:g0 + _MAX_PLANES]
        pin, sin, pout, sout = _plane_args(grp, grp_out)
        with torch.cuda.device(gid.device):
            err = lib.ldb_segscan(gid.data_ptr(), n, pin, sin, pout, sout,
                                  len(grp), scratch.data_ptr() + 8 * off,
                                  _stream(gid))
        _launched("segscan")
        _check(err, "segscan")
    return outs


# --------------------------------------------------------------------------
# Engine-facing dispatcher
# --------------------------------------------------------------------------

FORCE_KERNELS = None  # tests set True (kernel route on CPU tensors) or False


def use_kernels(*tensors) -> bool:
    """Whether gathers/compactions take the kernel route: some tensor lies on
    a CUDA device. Tests force the route for CPU tensors with
    FORCE_KERNELS=True (the wrappers then run their plain versions, so
    routing, grouping and padding are exercised)."""
    if FORCE_KERNELS is not None:
        return FORCE_KERNELS
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors)


def _planes_gather(planes, idx32, monotone: bool, s: int):
    """Gather a group of <= _MAX_PLANES equal-length planes of any widths
    with shared idx through whichever kernel applies."""
    if s <= CHUNK_TABLE_LIMIT:
        return gather_chunked_planes(planes, idx32)
    if monotone:
        return gather_sorted_planes(planes, idx32)
    # random big-table gather: plain indexing, one plane at a time. The
    # reference sends such gathers of at least 4M indices through a sort,
    # its sorted gather and an unsort (lingodb_tpu/ops/pgather.py:801-816).
    # On the card that route (tools/threshold_bench.py --only route: one
    # stable sort, K2 at the sorted indices, a scatter back) took
    # 1.52-8.13x the card time of plain indexing at every shape timed: n
    # 1M-60M indices, tables of 1.5M and 15M rows, 1, 2 and 8 planes
    # (NVIDIA H100 80GB HBM3, 700.00 W), so it is not taken here.
    j = idx32.to(torch.int64).clamp(0, s - 1)
    return [t[j] for t in planes]


def take_fast_multi(tables, idx, *, monotone: bool = False):
    """[t[idx] for t in tables] with OOB clipped, for equal-length 1-D
    tables sharing one index array. Each column is one plane of its own
    dtype (bool, 1-, 2-, 4- or 8-byte), gathered as it is, with no cast,
    in batched kernel calls (<= _MAX_PLANES planes of any widths each): one
    index decode per group instead of per column. Set monotone=True ONLY
    for nondecreasing idx; a wrong hint costs time, not correctness."""
    if not tables:
        return []
    if not be.is_torch(idx) or any(not be.is_torch(t) for t in tables):
        if be.any_torch(idx, tables):
            dev = be.device_of(idx, tables)
            idx = be.to_device(idx, dev)
            tables = [be.to_device(t, dev) for t in tables]
        else:
            bidx = np.maximum(np.asarray(idx), 0)
            return [np.take(np.asarray(t), bidx, axis=0, mode="clip")
                    for t in tables]
    n = int(idx.shape[0]) if idx.ndim == 1 else idx.numel()
    s = int(tables[0].shape[0])
    if (not use_kernels(idx, *tables) or n == 0 or s == 0 or idx.ndim != 1
            or any(t.ndim != 1 for t in tables)):
        j = idx.to(torch.int64).clamp(0, max(s - 1, 0))
        return [t[j] for t in tables]
    if any(int(t.shape[0]) != s for t in tables):
        raise ValueError("take_fast_multi: equal-length tables required")
    idx32 = idx.to(torch.int32) if idx.dtype != torch.int32 else idx
    out = []
    for g0 in range(0, len(tables), _MAX_PLANES):
        out += _planes_gather(tables[g0:g0 + _MAX_PLANES], idx32, monotone, s)
    return out


def take_fast(table, idx, *, monotone: bool = False):
    """table[idx] with OOB clipped. See take_fast_multi; column groups should
    prefer the multi form so the index decode is shared."""
    return take_fast_multi([table], idx, monotone=monotone)[0]


def nonzero_positions(mask, k: int):
    """(count, positions[:k]) of mask's set bits — compact_positions on the
    kernel route, torch.nonzero / numpy elsewhere. count is exact even when
    it exceeds k; the padding tail holds SENTINEL on both tensor routes so
    positions stay nondecreasing (clipped to the table end by take_fast)."""
    if not be.is_torch(mask):  # numpy baseline backend
        pos = np.flatnonzero(mask)
        out = np.zeros(k, np.int32)
        out[: min(len(pos), k)] = pos[:k]
        return np.int64(len(pos)), out
    if use_kernels(mask):
        cnt, pos = compact_positions(mask, k)
        return cnt.to(torch.int64), pos
    cnt, pos = compact_positions_plain(mask, k)
    return cnt.to(torch.int64), pos
