"""The two gathers (K1 gather_chunked, K2 gather_sorted) take planes of 1,
2, 4 and 8-byte elements, each gathered at its own width with no cast:
the port's kernel route (FORCE_KERNELS, the wrappers' plain versions on the
CPU) against the JAX package's take_fast_multi run in interpret mode, at
every width, mixed widths in one call, 1 to 17 columns (groups of 8), the
route edge s = 16,384 and the edges of the index (sorted and not, out of
range, SENTINEL, n = 0). Also the call as the kernel entry receives it (one
packed descriptor of the planes as they are), SCol's one call for data and
validity, and make_mesh without a card."""

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lingodb_tpu.ops import pgather as ref

from lingodb_tpu_torch.ops import pgather as pg
from lingodb_tpu_torch.parallel import mesh as msh
from lingodb_tpu_torch.runtime.vtable import SCol
from lingodb_tpu_torch.sql.types import Type

WIDTHS = [np.bool_, np.int8, np.uint8, np.int16, np.int32, np.float32,
          np.int64, np.float64]


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    monkeypatch.setattr(ref, "INTERPRET", True)
    monkeypatch.setattr(ref, "FORCE_PALLAS", True)
    monkeypatch.setattr(ref, "MIN_N", 1)
    monkeypatch.setattr(pg, "FORCE_KERNELS", True)


def _col(rng, dtype, s):
    if dtype == np.bool_:
        return rng.random(s) < 0.5
    if np.issubdtype(dtype, np.floating):
        return rng.standard_normal(s).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, s, dtype=np.int64).astype(dtype)


def _idx(rng, s, n, monotone):
    """n indices into s rows with out-of-range and SENTINEL entries."""
    idx = rng.integers(-3, s + 3, n).astype(np.int32)
    if n:
        idx[-1] = pg.SENTINEL
    return np.sort(idx) if monotone else idx


def _spy(monkeypatch):
    """Records each gather wrapper call: its name and its planes."""
    calls = []
    for name in ("gather_chunked_planes", "gather_sorted_planes"):
        orig = getattr(pg, name)

        def call(tables, idx, outs=None, _n=name, _o=orig):
            calls.append((_n, list(tables)))
            return _o(tables, idx, outs=outs)

        monkeypatch.setattr(pg, name, call)
    return calls


def _check(got, cols, idx, want=None):
    j = np.clip(idx, 0, len(cols[0]) - 1)
    assert len(got) == len(cols)
    for k, (g, c) in enumerate(zip(got, cols)):
        g = g.numpy()
        assert g.dtype == c.dtype and g.shape == idx.shape
        np.testing.assert_array_equal(g.view(np.uint8), c[j].view(np.uint8))
        if want is not None:
            np.testing.assert_array_equal(g, np.asarray(want[k]))


@pytest.mark.parametrize("monotone", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("s", [16_383, 16_384, 16_385])
@pytest.mark.parametrize("dtype", WIDTHS, ids=lambda d: np.dtype(d).name)
def test_every_width_at_the_route_edge(dtype, s, monotone):
    """One column of each width beside an int32 one, gathered bit for bit
    as the reference gathers it, on both sides of CHUNK_TABLE_LIMIT."""
    rng = np.random.default_rng(s + len(np.dtype(dtype).name))
    cols = [_col(rng, dtype, s), _col(rng, np.int32, s)]
    idx = _idx(rng, s, 300, monotone)
    want = ref.take_fast_multi([jnp.asarray(c) for c in cols],
                               jnp.asarray(idx), monotone=monotone)
    got = pg.take_fast_multi([torch.from_numpy(c) for c in cols],
                             torch.from_numpy(idx), monotone=monotone)
    _check(got, cols, idx, want)


@pytest.mark.parametrize("ncols", [1, 2, 7, 8, 9, 16, 17])
@pytest.mark.parametrize("s", [5_000, 16_385])
def test_mixed_widths_in_groups_of_eight(monkeypatch, ncols, s):
    """Columns of every width, cycled, in one call: the wrappers see groups
    of at most 8 planes, each column as it is (the same tensor, its own
    dtype: no cast reaches a wrapper), and the results equal the
    reference's."""
    rng = np.random.default_rng(ncols * 31 + s)
    cols = [_col(rng, WIDTHS[k % len(WIDTHS)], s) for k in range(ncols)]
    idx = _idx(rng, s, 257, True)
    tables = [torch.from_numpy(c) for c in cols]
    calls = _spy(monkeypatch)
    got = pg.take_fast_multi(tables, torch.from_numpy(idx), monotone=True)
    want = ref.take_fast_multi([jnp.asarray(c) for c in cols],
                               jnp.asarray(idx), monotone=True)
    _check(got, cols, idx, want)
    name = "gather_chunked_planes" if s <= pg.CHUNK_TABLE_LIMIT else \
        "gather_sorted_planes"
    assert [c[0] for c in calls] == [name] * -(-ncols // 8)
    seen = [t for _n, planes in calls for t in planes]
    assert len(seen) == ncols and all(a is b for a, b in zip(seen, tables))


@pytest.mark.parametrize("monotone", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("s", [100, 20_000])
def test_no_index_and_one_index(s, monotone):
    """n = 0 gives empty columns of each dtype; n = 1 one row, as the
    reference gives them."""
    rng = np.random.default_rng(s)
    cols = [_col(rng, d, s) for d in (np.bool_, np.int16, np.float64)]
    tables = [torch.from_numpy(c) for c in cols]
    for n in (0, 1):
        idx = _idx(rng, s, n, monotone)
        got = pg.take_fast_multi(tables, torch.from_numpy(idx),
                                 monotone=monotone)
        _check(got, cols, idx)
        if n:
            want = ref.take_fast_multi([jnp.asarray(c) for c in cols],
                                       jnp.asarray(idx), monotone=monotone)
            _check(got, cols, idx, want)


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "one_dtype"])
def test_no_cast_reaches_the_kernel_entry(monkeypatch, mixed):
    """What the C entry point receives (the CUDA path of a wrapper driven
    on CPU tensors with the entry replaced): one packed buffer of int64
    words (the header, then each plane's pointers, strides and log2 width),
    the planes' own storage and widths, outputs of the planes' dtypes (of
    one dtype: one allocation, rows 16-byte aligned, their pointers
    computed); a return of 1 (a launch into a capture) is counted in the
    capture's tally, 0 in LAUNCHES, a negative one raises."""
    seen = []

    def entry(buf):
        words = struct.unpack(f"<{len(buf) // 8}q", buf)
        seen.append(words)
        return len(seen) - 1  # 0 the first call, 1 (captured) the second

    monkeypatch.setitem(pg._KERNEL_FN, "gather_sorted", entry)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 77, raising=False)
    monkeypatch.setattr(pg, "LAUNCHES", dict.fromkeys(pg.LAUNCHES, 0))
    rng = np.random.default_rng(9)
    s, n = 64, 10
    dtypes = WIDTHS if mixed else [np.int16] * 3
    cols = [_col(rng, d, 2 * s) for d in dtypes]
    tables = [torch.from_numpy(c)[::2] for c in cols]  # element stride 2
    idx = torch.arange(n, dtype=torch.int32)
    tally = {}
    for _ in range(2):
        with pg.capture_scratch(torch.zeros(1, dtype=torch.int64), tally):
            outs = pg._gather("gather_sorted", tables, idx, None, s)
        assert [o.dtype for o in outs] == [t.dtype for t in tables]
        words = seen[-1]
        assert words[:6] == (len(tables), n, s, idx.data_ptr(), 77, -1)
        for p, (t, o) in enumerate(zip(tables, outs)):
            in_ptr, out_ptr, in_stride, out_stride, lw = words[6 + 5 * p:
                                                               11 + 5 * p]
            assert (in_ptr, in_stride) == (t.data_ptr(), 2)
            assert (out_ptr, out_stride) == (o.data_ptr(), 1)
            assert o.shape == (n,) and o.data_ptr() % 16 == 0
            assert 1 << lw == t.dtype.itemsize
    assert pg.LAUNCHES["gather_sorted"] == 1 and tally == {"gather_sorted": 1}
    monkeypatch.setitem(pg._KERNEL_FN, "gather_sorted", lambda buf: -10003)
    with pytest.raises(ValueError, match="refused"):
        pg._gather("gather_sorted", tables, idx, None, s)
    monkeypatch.setitem(pg._KERNEL_FN, "gather_sorted", lambda buf: -700)
    with pytest.raises(RuntimeError, match="error 700"):
        pg._gather("gather_sorted", tables, idx, None, s)
    with pytest.raises(ValueError, match="exceeds"):
        pg._gather("gather_sorted", tables, idx, None, s - 1)


@pytest.mark.parametrize("how", ["take", "take_with_invalid"])
@pytest.mark.parametrize("s", [1_000, 40_000])
def test_scol_take_is_one_call_for_data_and_validity(monkeypatch, how, s):
    """SCol.take and take_with_invalid gather a column's data and its
    validity in one wrapper call (one launch on the card), the validity a
    bool plane beside the data's int64 one."""
    rng = np.random.default_rng(s)
    data = rng.integers(-(1 << 40), 1 << 40, s)
    valid = rng.random(s) < 0.7
    col = SCol(Type.bigint(), torch.from_numpy(data), torch.from_numpy(valid))
    idx = np.sort(rng.integers(0, s, 500)).astype(np.int32)
    calls = _spy(monkeypatch)
    if how == "take":
        out = col.take(torch.from_numpy(idx), monotone=True)
        want_valid = valid[idx]
    else:
        oob = torch.from_numpy(idx % 5 == 0)
        out = col.take_with_invalid(torch.from_numpy(idx), oob, monotone=True)
        want_valid = valid[idx] & (idx % 5 != 0)
    assert len(calls) == 1
    assert [t.dtype for t in calls[0][1]] == [torch.int64, torch.bool]
    np.testing.assert_array_equal(out.data.numpy(), data[idx])
    assert out.valid.dtype == torch.bool
    np.testing.assert_array_equal(out.valid.numpy(), want_valid)


def test_make_mesh_raises_without_a_gpu(monkeypatch):
    """Without devices and without a card make_mesh raises, as a session
    does; given devices it builds the mesh over them."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        msh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        msh.make_mesh(2)
    assert msh.make_mesh(2, devices=["cpu"] * 3).size == 2
