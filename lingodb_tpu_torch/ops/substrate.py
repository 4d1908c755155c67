"""Hand-written CUDA kernels for the substrate kernel bench: table gathers
and the tile-level probes of the JAX package's substrate bench
(benchtools/tools_kbench.py, benchtools/tools_pallas_gather.py). None has an
engine caller; tools/substrate_bench.py runs them.

  gather_shift(table, idx)     T1  table[idx], any table size; the table,
                                   or its first part, held in each block's
                                   shared memory, or read from L2, by its
                                   size (csrc/table_gather.cu)
  gather_small(table, idx)     T2  table[idx], table <= SMALL_TABLE_LIMIT
                                   entries staged in shared memory (same file)
  lane_gather(d, l)            T3  out[r, j] = d[r, l[r, j]]  (csrc/tile_gather.cu)
  sublane_gather(tab, rows)    T4  out[i, j] = tab[rows[i, j], j], each
                                   block serving a band of columns from
                                   shared memory (same file)
  lane_rotsum(t)               T5, T6  the sum of the 128 lane rotations of
                                   t: every element its row's total, wrapping
                                   in int32 (csrc/lane_rotsum.cu)
  onehot_compact(x, m)         T7  per 256-row tile, the one-hot product
                                   out[a, j] = sum over rows p with c[p] = a
                                   of x[p, j] * m[p, j], c the running sum of
                                   lane 0 of m (csrc/onehot_compact.cu)

Every array is int32 and contiguous; the 2-D ones are (rows, 128). The
functions sit at module level (in the reference they are closures inside
the bench's main()), so the tests and the bench import them. Beside each
stands its plain PyTorch version (`*_plain`). A wrapper takes the plain
version for a tensor that lies on the CPU; on a CUDA tensor it launches its
kernel or raises. FORCE_KERNELS = True (tests only) sends CPU tensors down
the kernel route, checks and output allocation included, with the plain
version standing in for the launch. Each wrapper counts its launches in
LAUNCHES, and nowhere else.

The only state is the input arrays: the tests build them with numpy from a
seed and hand the same arrays to both sides (`torch.from_numpy`), so no
conversion function is needed.
"""

from __future__ import annotations

import contextlib

import torch

LANES = 128
TILE_ROWS = 256          # rows per onehot_compact tile (the reference's Tc)
SMALL_TABLE_LIMIT = 4096  # gather_small's shared-memory table, in entries
_BLOCKS_PER_SM = 8

# kernel name -> its source under csrc/
SOURCE = {"gather_shift": "table_gather", "gather_small": "table_gather",
          "lane_gather": "tile_gather", "sublane_gather": "tile_gather",
          "lane_rotsum": "lane_rotsum", "onehot_compact": "onehot_compact"}

# launches per kernel since the last reset_counters()
LAUNCHES = {k: 0 for k in SOURCE}

FORCE_KERNELS = None  # tests set True: CPU tensors take the kernel route


def reset_counters() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_i32(what: str, name: str, t, ndim: int) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise ValueError(f"{what}: {name} must be an int32 tensor")
    if t.ndim != ndim:
        raise ValueError(f"{what}: {name} must be {ndim}-D, got {tuple(t.shape)}")
    if ndim == 2 and int(t.shape[1]) != LANES:
        raise ValueError(f"{what}: {name} must have {LANES} columns, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")
    if ndim == 2 and t.is_cuda and t.data_ptr() % 16:  # the kernels' int4 rows
        raise ValueError(f"{what}: {name} must start on a 16-byte boundary")


def _same_device(what: str, *ts) -> None:
    if any(t.device != ts[0].device for t in ts[1:]):
        raise ValueError(f"{what}: tensors on different devices")


def _kernel_route(t) -> bool:
    return t.is_cuda or bool(FORCE_KERNELS)


def _launch(name: str, out, plain, call) -> None:
    """Launch kernel `name` into `out` through `call(lib, sms, stream)`, sms
    the card's multiprocessor count, or on the CPU (FORCE_KERNELS) copy the
    plain version into it."""
    if out.is_cuda:
        from . import cuda_build

        lib = cuda_build.lib(SOURCE[name])
        sms = torch.cuda.get_device_properties(out.device).multi_processor_count
        with torch.cuda.device(out.device):
            err = call(lib, sms,
                       torch.cuda.current_stream(out.device).cuda_stream)
        LAUNCHES[name] += 1
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    else:
        out.copy_(plain())
        LAUNCHES[name] += 1


# --------------------------------------------------------------------------
# T1, T2: table[idx]
# --------------------------------------------------------------------------

def table_gather_plain(table, idx):
    """Plain PyTorch version of gather_shift and gather_small."""
    s = int(table.shape[0])
    return table[idx.to(torch.int64).clamp(0, s - 1)]


def _table_gather(name: str, table, idx, limit: int):
    _check_i32(name, "table", table, 1)
    _check_i32(name, "idx", idx, 1)
    _same_device(name, table, idx)
    s, n = int(table.shape[0]), int(idx.shape[0])
    if not 1 <= s <= limit:
        raise ValueError(f"{name}: table of {s} entries, needs 1..{limit}")
    if not _kernel_route(idx):
        return table_gather_plain(table, idx)
    out = torch.empty((n,), dtype=torch.int32, device=idx.device)
    if n:
        fn = "ldb_" + name
        _launch(name, out, lambda: table_gather_plain(table, idx),
                lambda lib, sms, stream: getattr(lib, fn)(
                    table.data_ptr(), s, idx.data_ptr(), n, out.data_ptr(),
                    sms * _BLOCKS_PER_SM, stream))
    return out


def gather_shift(table, idx):
    """table[idx] for a 1-D int32 table of any length and 1-D int32 idx
    (T1; replaces benchtools/tools_pallas_gather.py::pallas_gather_shift).
    Contract 0 <= idx < len(table); an index outside it is clamped. The
    output has len(idx) entries (no padding)."""
    return _table_gather("gather_shift", table, idx, 2147483647)


GATHER_SHIFT_FORMS = {1: "staged", 2: "l2"}


def gather_shift_edges() -> list:
    """The edges of gather_shift's forms in its kernel on the card: the
    tallest table the staged form holds whole in each block's shared
    memory, then the tallest it takes (its first entries held, the rest
    from L2); taller tables take the L2 form (ldb_gather_shift_edges)."""
    import ctypes

    from . import cuda_build

    edges = (ctypes.c_int64 * 2)()
    count = cuda_build.lib("table_gather").ldb_gather_shift_edges(edges, 2)
    return [int(e) for e in edges[:count]]


def gather_shift_plan(s: int, n: int, device=None) -> dict:
    """The launch gather_shift's kernel makes on the card for a table of s
    entries and n aligned indices: its form, the entries a block stages,
    blocks, dynamic shared memory a block (bytes) and threads a block
    (ldb_gather_shift_plan). Launches nothing."""
    import ctypes

    from . import cuda_build

    device = torch.device("cuda") if device is None else torch.device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    info = (ctypes.c_int64 * 5)()
    with torch.cuda.device(device):
        err = cuda_build.lib("table_gather").ldb_gather_shift_plan(
            s, n, sms * _BLOCKS_PER_SM, info)
    if err != 0:
        raise RuntimeError(f"gather_shift_plan: error {err} for S={s} n={n}")
    return {"form": GATHER_SHIFT_FORMS[int(info[0])], "held": int(info[1]),
            "blocks": int(info[2]), "smem": int(info[3]),
            "threads": int(info[4])}


def gather_small(table, idx):
    """gather_shift for tables of at most SMALL_TABLE_LIMIT entries, served
    from shared memory (T2; replaces pallas_gather_small)."""
    return _table_gather("gather_small", table, idx, SMALL_TABLE_LIMIT)


# --------------------------------------------------------------------------
# T3, T4: gathers inside (rows, 128) arrays
# --------------------------------------------------------------------------

def lane_gather_plain(d, l):
    """Plain PyTorch version of lane_gather."""
    return torch.gather(d, 1, (l & (LANES - 1)).to(torch.int64))


def lane_gather(d, l):
    """out[r, j] = d[r, l[r, j]] for (rows, 128) int32 d and l (T3; replaces
    benchtools/tools_kbench.py k_lane). Contract 0 <= l < 128; l is taken
    modulo 128."""
    _check_i32("lane_gather", "d", d, 2)
    _check_i32("lane_gather", "l", l, 2)
    _same_device("lane_gather", d, l)
    if d.shape != l.shape:
        raise ValueError(f"lane_gather: d {tuple(d.shape)} and l "
                         f"{tuple(l.shape)} differ")
    if not _kernel_route(d):
        return lane_gather_plain(d, l)
    rows = int(d.shape[0])
    out = torch.empty_like(d)
    if rows:
        _launch("lane_gather", out, lambda: lane_gather_plain(d, l),
                lambda lib, sms, stream: lib.ldb_lane_gather(
                    d.data_ptr(), l.data_ptr(), rows, out.data_ptr(),
                    sms * _BLOCKS_PER_SM, stream))
    return out


def sublane_gather_plain(tab, rows):
    """Plain PyTorch version of sublane_gather."""
    r = int(tab.shape[0])
    return torch.gather(tab, 0, rows.to(torch.int64).clamp(0, r - 1))


def sublane_gather(tab, rows):
    """out[i, j] = tab[rows[i, j], j] for an (R, 128) int32 table and
    (M, 128) int32 row indices, M any (T4; replaces k_sub). The index is
    into the table, not into a tile of `rows`. Contract 0 <= rows < R; an
    index outside it is clamped."""
    _check_i32("sublane_gather", "tab", tab, 2)
    _check_i32("sublane_gather", "rows", rows, 2)
    _same_device("sublane_gather", tab, rows)
    r, m = int(tab.shape[0]), int(rows.shape[0])
    if not 1 <= r <= 2147483647 // LANES:
        raise ValueError(f"sublane_gather: table of {r} rows")
    if not _kernel_route(rows):
        return sublane_gather_plain(tab, rows)
    out = torch.empty_like(rows)
    if m:
        _launch("sublane_gather", out, lambda: sublane_gather_plain(tab, rows),
                lambda lib, sms, stream: lib.ldb_sublane_gather(
                    tab.data_ptr(), r, rows.data_ptr(), m, out.data_ptr(),
                    sms, stream))
    return out


# --------------------------------------------------------------------------
# T5, T6: the sum of the 128 lane rotations
# --------------------------------------------------------------------------

def lane_rotsum_plain(t):
    """Plain PyTorch version of lane_rotsum, in the reference's literal form:
    128 lane rotations of t summed in int32 (wrapping)."""
    acc = torch.zeros_like(t)
    for sh in range(1, LANES + 1):
        acc += torch.roll(t, shifts=-(sh % LANES), dims=1)
    return acc


def lane_rotsum(t):
    """Sum of the 128 lane rotations of a (R, 128) int32 array: every
    element becomes its row's total, wrapping in int32 (T5 and T6; replaces
    k_roll and k_roll2, which compute the same function)."""
    _check_i32("lane_rotsum", "t", t, 2)
    if not _kernel_route(t):
        return lane_rotsum_plain(t)
    rows = int(t.shape[0])
    out = torch.empty_like(t)
    if rows:
        _launch("lane_rotsum", out, lambda: lane_rotsum_plain(t),
                lambda lib, sms, stream: lib.ldb_lane_rotsum(
                    t.data_ptr(), rows, out.data_ptr(), sms * _BLOCKS_PER_SM,
                    stream))
    return out


# --------------------------------------------------------------------------
# T7: within-tile one-hot compaction
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _fp32_matmul():
    """Full-fp32 products on the card: TF32 (10 mantissa bits) would round
    x. False is PyTorch's default; it is set here, not assumed."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def onehot_operands(x, m):
    """The one-hot matrices P[t, a, p] = (c[t, p] = a) and the products
    x * m of the reference's k_mm, as fp32 (tiles, 256, 256) and
    (tiles, 256, 128): the operands of onehot_compact_plain's torch.bmm."""
    tiles = int(x.shape[0]) // TILE_ROWS
    c = torch.cumsum(m.view(tiles, TILE_ROWS, LANES)[:, :, 0].to(torch.float32),
                     dim=1)
    q = torch.arange(TILE_ROWS, dtype=torch.float32, device=x.device)
    onehot = (q[None, :, None] == c[:, None, :]).to(torch.float32)
    return onehot, (x * m).to(torch.float32).view(tiles, TILE_ROWS, LANES)


def onehot_compact_plain(x, m):
    """Plain PyTorch version of onehot_compact, in the reference's literal
    form: the one-hot fp32 product per tile, in full fp32."""
    onehot, xm = onehot_operands(x, m)
    with _fp32_matmul():
        out = torch.bmm(onehot, xm)
    return out.to(torch.int32).view(-1, LANES)


def onehot_compact(x, m):
    """Per 256-row tile of (tiles * 256, 128) int32 x and m:
    out[a, j] = sum of x[p, j] * m[p, j] over the tile's rows p with
    c[p] = a (a < 256), c the inclusive running sum of lane 0 of m; slots
    that no row reaches are 0, rows with c[p] = 256 are dropped (T7; replaces
    k_mm). Domain m in {0, 1}, 0 <= x < 2^15: there the reference's fp32
    product is exact and this int32 kernel equals it bit for bit."""
    _check_i32("onehot_compact", "x", x, 2)
    _check_i32("onehot_compact", "m", m, 2)
    _same_device("onehot_compact", x, m)
    if x.shape != m.shape:
        raise ValueError(f"onehot_compact: x {tuple(x.shape)} and m "
                         f"{tuple(m.shape)} differ")
    if int(x.shape[0]) % TILE_ROWS:
        raise ValueError(f"onehot_compact: rows {int(x.shape[0])} not a "
                         f"multiple of {TILE_ROWS}")
    if not _kernel_route(x):
        return onehot_compact_plain(x, m)
    tiles = int(x.shape[0]) // TILE_ROWS
    out = torch.empty_like(x)
    if tiles:
        _launch("onehot_compact", out, lambda: onehot_compact_plain(x, m),
                lambda lib, _sms, stream: lib.ldb_onehot_compact(
                    x.data_ptr(), m.data_ptr(), tiles, out.data_ptr(), stream))
    return out
