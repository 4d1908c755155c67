"""The port's gather/compaction wrappers against the Pallas kernels of
lingodb_tpu.ops.pgather run in interpret mode, on the shapes of
tests/test_pgather.py (reduced where interpret mode is slow). Integer
results are compared exactly. On CPU tensors the port's wrappers run the
kernels' plain versions; the CUDA kernels themselves are compared with those
plain versions on the card by chip_smoke.py."""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lingodb_tpu.ops import pgather as ref

from lingodb_tpu_torch.ops import pgather as pg


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    monkeypatch.setattr(ref, "INTERPRET", True)
    monkeypatch.setattr(ref, "FORCE_PALLAS", True)
    monkeypatch.setattr(ref, "MIN_N", 1)
    monkeypatch.setattr(pg, "FORCE_KERNELS", True)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("s,n", [(1, 100), (100, 1000), (1024, 5000),
                                 (4096, 20000), (8192, 9000)])
def test_gather_chunked(s, n):
    rng = _rng(s + n)
    table = rng.integers(-(1 << 30), 1 << 30, s, np.int32)
    idx = rng.integers(0, s, n, np.int32)
    want = np.asarray(ref.gather_chunked_i32(jnp.asarray(table), jnp.asarray(idx)))
    got = pg.gather_chunked_i32(_t(table), _t(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, table[idx])


def test_gather_chunked_clamps_and_planes():
    table = np.arange(100, dtype=np.int32)
    idx = np.array([-5, 0, 99, 150, 2147483646], np.int32)
    want = np.asarray(ref.gather_chunked_i32(jnp.asarray(table), jnp.asarray(idx)))
    got = pg.gather_chunked_i32(_t(table), _t(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 0, 99, 99, 99])
    two = pg.gather_chunked_planes([_t(table), _t(table[::-1])], _t(idx).reshape(5, 1))
    assert two[0].shape == (5, 1)
    np.testing.assert_array_equal(two[1].reshape(-1).numpy(), [99, 99, 0, 0, 0])


# mask bytes per tile of csrc/compact_positions.cu (its ldb_compact_tile)
_COMPACT_TILE = 4096


@pytest.mark.parametrize("n,p", [(100, 0.5), (8192, 0.1), (40000, 0.01),
                                 (30000, 0.9), (8192 * 2, 0.0),
                                 (8192, 1.0),
                                 # n = 1 and the CUDA kernel's tile edges
                                 (1, 1.0), (1, 0.0),
                                 (_COMPACT_TILE - 1, 0.3), (_COMPACT_TILE, 0.3),
                                 (_COMPACT_TILE + 1, 0.3),
                                 (2 * _COMPACT_TILE + 1, 0.5)])
def test_compact_positions(n, p):
    mask = _rng(n).random(n) < p
    expect = np.flatnonzero(mask)
    k = max(int(len(expect) * 1.5) + 256, 512)
    rcnt, rpos = ref.compact_positions(jnp.asarray(mask), k)
    cnt, pos = pg.compact_positions(_t(mask), k)
    assert int(cnt) == int(rcnt) == len(expect)
    np.testing.assert_array_equal(pos.numpy()[: len(expect)],
                                  np.asarray(rpos)[: len(expect)])
    np.testing.assert_array_equal(pos.numpy()[: len(expect)], expect)
    assert (pos.numpy()[len(expect):] == pg.SENTINEL).all()
    assert pos.dtype == torch.int32


@pytest.mark.parametrize("n,p,k", [
    (9000, 0.5, None),        # count = k + 1
    (9000, 0.5, 64),          # count >> k
    (20000, 0.0125, 262_144),  # k >> count: q14's capacity over its count
    (_COMPACT_TILE + 1, 0.3, 100),
], ids=["count_k_plus_1", "count_far_above_k", "k_far_above_count",
        "tile_edge_count_above_k"])
def test_compact_positions_capacity(n, p, k):
    """The count is exact whatever k; the k slots hold the first k
    positions, then SENTINEL. The reference's slots past its count are
    undefined, so only its first min(count, k) are compared."""
    mask = _rng(n + 1).random(n) < p
    expect = np.flatnonzero(mask)
    k = len(expect) - 1 if k is None else k
    rcnt, rpos = ref.compact_positions(jnp.asarray(mask), k)
    cnt, pos = pg.compact_positions(_t(mask), k)
    assert int(cnt) == int(rcnt) == len(expect)
    assert pos.dtype == torch.int32 and pos.shape == (k,)
    c = min(len(expect), k)
    np.testing.assert_array_equal(pos.numpy()[:c], np.asarray(rpos)[:c])
    np.testing.assert_array_equal(pos.numpy()[:c], expect[:c])
    assert (pos.numpy()[c:] == pg.SENTINEL).all()


def _scratch(n, stream=7, capturing=False):
    return pg._compact_scratch_for("cpu", stream, n, capturing)


@pytest.fixture
def fresh_scratch(monkeypatch):
    """compact_positions' scratch bookkeeping with no buffers yet, for the
    kernel's tile size."""
    monkeypatch.setattr(pg, "_compact_tile", _COMPACT_TILE)
    monkeypatch.setattr(pg, "_compact_local", threading.local())


@pytest.mark.parametrize("case", ["new", "kept", "grows", "shorter",
                                  "per_stream", "per_thread"])
def test_compact_scratch_layout_and_owners(fresh_scratch, case):
    """An uncaptured call's scratch: one zeroed int64 buffer of one word
    (call number and tile counter) and a status word a tile, owned by one
    (thread, device, stream). The kernel numbers its calls itself, so the
    host keeps the buffer and nothing else: a call takes it as it is, a
    longer mask replaces it by a zeroed buffer twice as large, and another
    stream or another thread (two threads on one stream would interleave
    their prologue and main launches) has its own."""
    n = 3 * _COMPACT_TILE
    buf = _scratch(n)
    assert buf.dtype == torch.int64 and buf.numel() == 1 + 3
    assert not buf.any()
    if case == "kept":
        buf[0] = 5  # what the card's prologue would have left there
        again = _scratch(n)
        assert again is buf and int(again[0]) == 5
    elif case == "grows":
        bigger = _scratch(20 * _COMPACT_TILE)
        assert bigger is not buf and bigger.numel() == 21 and not bigger.any()
        assert _scratch(30 * _COMPACT_TILE).numel() == 2 * 21
    elif case == "shorter":
        bigger = _scratch(20 * _COMPACT_TILE)
        assert _scratch(1) is bigger and _scratch(n) is bigger
    elif case == "per_stream":
        other = _scratch(n, stream=8)
        assert other is not buf and _scratch(n) is buf
    elif case == "per_thread":
        got = []
        t = threading.Thread(target=lambda: got.append(_scratch(n)))
        t.start()
        t.join()
        assert got[0] is not buf and _scratch(n) is buf
    else:
        assert _scratch(n - 1) is buf


@pytest.mark.parametrize("case", ["graph_owned", "no_scratch", "too_small",
                                  "restored", "made_under_capture"])
def test_compact_scratch_under_capture(fresh_scratch, monkeypatch, case):
    """A call being captured in a CUDA graph takes the scratch the graph
    made before its capture (capture_scratch): none is made or kept for the
    thread, since one made under capture would come out of the graph's
    private pool, which its replays overwrite. Capturing without one, or
    with one too small for the mask, raises; so does making one under
    capture."""
    n = 3 * _COMPACT_TILE
    graph_buf = pg.new_compact_scratch("cpu", 1 + 3)
    assert graph_buf.dtype == torch.int64 and not graph_buf.any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    if case == "graph_owned":
        with pg.capture_scratch(graph_buf):
            assert _scratch(n, capturing=True) is graph_buf
            assert _scratch(1, capturing=True) is graph_buf
        assert getattr(pg._compact_local, "scratch", None) is None
    elif case == "no_scratch":
        with pytest.raises(RuntimeError, match="capture_scratch"):
            _scratch(n, capturing=True)
    elif case == "too_small":
        with pg.capture_scratch(graph_buf):
            with pytest.raises(RuntimeError, match="5 needed"):
                _scratch(4 * _COMPACT_TILE, capturing=True)
    elif case == "restored":
        inner = torch.zeros(9, dtype=torch.int64)
        with pg.capture_scratch(graph_buf):
            with pg.capture_scratch(inner):
                assert _scratch(n, capturing=True) is inner
            assert _scratch(n, capturing=True) is graph_buf
        with pytest.raises(RuntimeError):
            _scratch(n, capturing=True)
    else:
        with pytest.raises(RuntimeError, match="graph's pool"):
            pg.new_compact_scratch("cpu")
    # a graph's scratch covers any mask the wrapper takes
    assert pg.CAPTURE_SCRATCH_WORDS >= 1 + -(-(2 ** 31 - 2) // _COMPACT_TILE)


@pytest.mark.parametrize("case", ["uncaptured", "captured", "no_tally",
                                  "replayed"])
def test_launches_counted_where_the_card_runs_them(monkeypatch, case):
    """A wrapper counts its launch in LAUNCHES; a call being captured
    launches nothing and is counted in the capture's tally instead (none
    without a tally), which count_replay adds to LAUNCHES at each replay."""
    monkeypatch.setattr(pg, "LAUNCHES", dict.fromkeys(pg.LAUNCHES, 0))
    monkeypatch.setattr(pg, "_compact_local", threading.local())
    capturing = case in ("captured", "no_tally")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    tally: dict = {}
    buf = torch.zeros(4, dtype=torch.int64)
    with pg.capture_scratch(buf, None if case == "no_tally" else tally):
        for name in ("gather_sorted", "compact_positions", "gather_sorted"):
            pg._launched(name)
    if case == "uncaptured":
        assert pg.LAUNCHES["gather_sorted"] == 2 and not tally
    elif case == "captured":
        assert tally == {"gather_sorted": 2, "compact_positions": 1}
        assert not any(pg.LAUNCHES.values())
    elif case == "no_tally":
        assert not tally and not any(pg.LAUNCHES.values())
    else:
        pg.count_replay({"gather_sorted": 2, "compact_positions": 1})
        pg.count_replay({"gather_sorted": 2, "compact_positions": 1})
        assert pg.LAUNCHES["gather_sorted"] == 2 + 4
        assert pg.LAUNCHES["compact_positions"] == 1 + 2
    assert getattr(pg._compact_local, "tally", None) is None  # restored


def test_compact_positions_overflow_reports_count():
    n = 9000
    mask = np.ones(n, bool)
    rcnt, _ = ref.compact_positions(jnp.asarray(mask), 1024)
    cnt, pos = pg.compact_positions(_t(mask), 1024)
    assert int(cnt) == int(rcnt) == n  # count is honest even when k overflows
    np.testing.assert_array_equal(pos.numpy(), np.arange(1024))


@pytest.mark.parametrize("dtype", [np.bool_, np.int32, np.uint8])
def test_nonzero_positions(dtype):
    mask = (_rng(5).random(20000) < 0.3).astype(dtype)
    k = 8000
    rcnt, rpos = ref.nonzero_positions(jnp.asarray(mask), k)
    cnt, pos = pg.nonzero_positions(_t(mask), k)
    assert int(cnt) == int(rcnt)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))
    # the route without kernels keeps the same contract
    pg.FORCE_KERNELS = False
    cnt2, pos2 = pg.nonzero_positions(_t(mask), k)
    assert int(cnt2) == int(cnt)
    np.testing.assert_array_equal(pos2.numpy(), pos.numpy())
    # numpy masks (host tier)
    cnt3, pos3 = pg.nonzero_positions(mask != 0, k)
    assert int(cnt3) == int(cnt)
    np.testing.assert_array_equal(pos3[: int(cnt)], pos.numpy()[: int(cnt)])


@pytest.mark.parametrize("s,n,maxstep", [(300_000, 40_000, 4),
                                         (5_000, 30_000, 2)])
def test_gather_sorted(s, n, maxstep):
    rng = _rng(s)
    table = rng.integers(-(1 << 30), 1 << 30, s, np.int32)
    steps = rng.integers(0, maxstep, n)
    idx = np.minimum(np.cumsum(steps), s - 1).astype(np.int32)
    want, rovf = ref.gather_sorted_i32(jnp.asarray(table), jnp.asarray(idx))
    got = pg.gather_sorted_i32(_t(table), _t(idx))
    assert int(rovf) == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_sorted_planes_strided_and_sentinel():
    rng = _rng(11)
    s, n = 50_000, 9_000
    wide = rng.integers(-(1 << 62), 1 << 62, s)
    limbs = _t(wide).view(torch.int32)
    idx = np.sort(rng.integers(0, s, n)).astype(np.int32)
    idx[-3:] = pg.SENTINEL  # padding tail of a compaction: clamps to s - 1
    lo, hi = pg.gather_sorted_planes([limbs[0::2], limbs[1::2]], _t(idx))
    back = torch.stack([lo, hi], dim=1).contiguous().view(torch.int64).reshape(-1)
    np.testing.assert_array_equal(back.numpy(), wide[np.minimum(idx, s - 1)])


@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.int32, np.bool_])
@pytest.mark.parametrize("monotone", [True, False])
def test_take_fast_multi(dtype, monotone):
    """Every limb layout, sorted and random indices, against the reference
    dispatcher (whose random route is sort + windowed gather + unsort)."""
    rng = _rng(3)
    s, n = 100_000, 25_000  # gap 4: dense, table beyond the chunk limit
    if dtype == np.bool_:
        table = rng.integers(0, 2, s).astype(np.bool_)
    elif dtype == np.float64:
        table = rng.normal(size=s)
    elif dtype == np.int32:
        table = rng.integers(-(1 << 30), 1 << 30, s, np.int32)
    else:
        table = rng.integers(-(1 << 40), 1 << 40, s).astype(dtype)
    other = rng.integers(0, 1000, s, np.int32)
    idx = rng.integers(0, s, n).astype(np.int32)
    if monotone:
        idx = np.sort(idx)
    want = ref.take_fast_multi([jnp.asarray(table), jnp.asarray(other)],
                               jnp.asarray(idx), monotone=monotone)
    got = pg.take_fast_multi([_t(table), _t(other)], _t(idx), monotone=monotone)
    for g, w, src in zip(got, want, (table, other)):
        assert g.numpy().dtype == src.dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), src[idx])


def test_take_fast_wrong_monotone_hint_costs_no_correctness():
    rng = _rng(4)
    s, n = 80_000, 30_000
    table = rng.integers(-(1 << 40), 1 << 40, s)
    idx = rng.integers(0, s, n).astype(np.int32)  # NOT sorted
    want = np.asarray(ref.take_fast(jnp.asarray(table), jnp.asarray(idx),
                                    monotone=True))
    got = pg.take_fast(_t(table), _t(idx), monotone=True).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, table[idx])


def test_take_fast_oob_and_sentinel_indices():
    table = np.arange(70_000, dtype=np.int64) * 3
    idx = np.array([-7, 0, 5, 69_999, 70_000, pg.SENTINEL], np.int32)
    for monotone in (False, True):
        want = np.asarray(ref.take_fast(jnp.asarray(table), jnp.asarray(idx),
                                        monotone=monotone))
        got = pg.take_fast(_t(table), _t(idx), monotone=monotone).numpy()
        np.testing.assert_array_equal(got, want)
    small = np.arange(50, dtype=np.int32)
    got = pg.take_fast(_t(small), _t(idx)).numpy()
    np.testing.assert_array_equal(got, [0, 0, 5, 49, 49, 49])


def test_take_fast_small_table_uses_chunked_route(monkeypatch):
    seen = []
    orig = pg.gather_chunked_planes
    monkeypatch.setattr(pg, "gather_chunked_planes",
                        lambda *a, **k: seen.append(1) or orig(*a, **k))
    lut = np.arange(25, dtype=np.int64) * 7
    idx = _rng(8).integers(0, 25, 5000).astype(np.int32)
    got = pg.take_fast(_t(lut), _t(idx)).numpy()
    np.testing.assert_array_equal(got, lut[idx])
    assert seen


def test_wrappers_reject_what_the_kernels_do_not_take():
    """Planes of 16-byte elements, planes of unequal length or 2-D, an
    int64 index, more than 8 planes and a table past the chunk limit raise
    (planes of 1, 2, 4 and 8 bytes are taken: tests/test_torch_gather_widths
    .py)."""
    t = torch.zeros(10, dtype=torch.complex128)
    i = torch.zeros(4, dtype=torch.int32)
    ok = torch.zeros(10, dtype=torch.int64)
    for bad_tables, bad_idx in (([t], i), ([ok, ok[:9]], i),
                                ([ok.reshape(2, 5)], i), ([ok], i.long()),
                                ([ok] * 9, i)):
        with pytest.raises(ValueError):
            pg.gather_sorted_planes(bad_tables, bad_idx)
        with pytest.raises(ValueError):
            pg.gather_chunked_planes(bad_tables, bad_idx)
    with pytest.raises(ValueError):
        pg.gather_chunked_planes([torch.zeros(20000, dtype=torch.int32)], i)
    with pytest.raises(ValueError):
        pg.compact_positions(torch.zeros((2, 2), dtype=torch.bool), 4)


def test_kernel_route_at_every_size(monkeypatch):
    """The dispatcher has no size threshold: a gather of a few rows takes the
    same wrappers as one of millions, and each group of planes goes to the
    wrapper its table size and the monotone hint name."""
    seen = []
    for name in ("gather_chunked_planes", "gather_sorted_planes",
                 "compact_positions"):
        orig = getattr(pg, name)
        monkeypatch.setattr(
            pg, name, lambda *a, _n=name, _o=orig, **k: seen.append(_n) or _o(*a, **k))
    big = np.arange(20_000, dtype=np.int64) * 5
    small = np.arange(30, dtype=np.int32)
    idx = np.array([2, 2, 7], np.int32)
    np.testing.assert_array_equal(
        pg.take_fast(_t(big), _t(idx), monotone=True).numpy(), big[idx])
    np.testing.assert_array_equal(pg.take_fast(_t(small), _t(idx)).numpy(), small[idx])
    cnt, pos = pg.nonzero_positions(_t(np.array([0, 1, 1, 0], np.bool_)), 3)
    assert int(cnt) == 2 and pos.tolist() == [1, 2, pg.SENTINEL]
    assert seen == ["gather_sorted_planes", "gather_chunked_planes",
                    "compact_positions"]
    del seen[:]
    rnd = np.array([9, 3, 19_999], np.int32)  # unsorted, big table: indexing
    np.testing.assert_array_equal(pg.take_fast(_t(big), _t(rnd)).numpy(), big[rnd])
    assert seen == []


def _runs_gid(rng, n_runs, lo, hi, first=0):
    runs = rng.integers(lo, hi, n_runs)
    return (np.repeat(np.arange(n_runs), runs) + first).astype(np.int32)


# rows per tile of csrc/segscan.cu by the number of planes W: 256 threads of
# 16 rows for W <= 2, of 8 rows above (its ldb_segscan_tile)
_SEGSCAN_TILE = {2: 4096, 3: 2048}


def _segscan_cases():
    rng = _rng(21)
    gid = _runs_gid(rng, 6000, 1, 9)  # short random runs, W = 2
    yield "short_runs_w2", gid, [rng.integers(-1000, 1000, gid.size, np.int32),
                                 np.ones(gid.size, np.int32)]
    yield "one_run_20000", np.zeros(20_000, np.int32), [np.ones(20_000, np.int32)]
    # n = 10,001 is not a multiple of the reference's 8,192-row tile, and a
    # leading run of the reference's first-tile sentinel id picks up nothing
    gid = np.sort(rng.integers(-5, 400, 10_001)).astype(np.int32)
    gid[:37] = -2147483647
    yield "ragged_w1", gid, [rng.integers(-(1 << 20), 1 << 20, gid.size, np.int32)]
    # sums wrap int32: long runs of values near 2^30
    gid = _runs_gid(rng, 40, 100, 900)
    yield "wraps_w3", gid, [rng.integers(1 << 29, 1 << 30, gid.size, np.int32),
                            rng.integers(-(1 << 30), -(1 << 29), gid.size, np.int32),
                            np.full(gid.size, 2147483647, np.int32)]
    gid = _runs_gid(rng, 3000, 1, 6, first=-1500)
    yield "w8", gid, [rng.integers(-(1 << 31), (1 << 31) - 1, gid.size,
                                   dtype=np.int64).astype(np.int32)
                      for _ in range(8)]
    # the CUDA kernel's tile edges (_SEGSCAN_TILE rows), a run across each
    for w, tile in _SEGSCAN_TILE.items():
        for n in (tile - 1, tile, tile + 1):
            gid = np.sort(rng.integers(0, n // 3, n)).astype(np.int32)
            gid[tile - 40: tile + 40] = gid[tile - 40]
            yield f"tile{tile}{n - tile:+d}_w{w}", gid, [
                rng.integers(-(1 << 31), (1 << 31) - 1, n,
                             dtype=np.int64).astype(np.int32) for _ in range(w)]


@pytest.mark.parametrize("entry", ["wrapper", "plain"])
@pytest.mark.parametrize("case", list(_segscan_cases()), ids=lambda c: c[0])
def test_segscan(case, entry):
    """segscan_i32 against the reference's Pallas kernel in interpret mode,
    bit for bit: the wrapper (its input checks, then on CPU tensors its
    plain version), here given strided views, and the plain version."""
    _name, gid, vals = case
    want = ref.segscan_i32(jnp.asarray(gid), [jnp.asarray(v) for v in vals])
    if entry == "wrapper":
        # every input a view with stride 2 into a wider buffer
        strided = [_t(np.stack([a, a], axis=1))[:, 0] for a in (gid, *vals)]
        assert all(t.stride(0) == 2 for t in strided)
        got = pg.segscan_i32(strided[0], strided[1:])
    else:
        got = pg.segscan_i32_plain(_t(gid), [_t(v) for v in vals])
    assert len(got) == len(vals)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (gid.size,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_segscan_scratch_layout():
    """One zeroed buffer a call: per launch of W planes (groups of at most
    eight), a tile counter and ceil(n / tile) x W status words, the
    launches' regions back to back and disjoint."""
    def tile(w):
        return _SEGSCAN_TILE[2] if w <= 2 else _SEGSCAN_TILE[3]

    assert pg._segscan_scratch(4096, [2], tile) == ([0], 1 + 1 * 2)
    assert pg._segscan_scratch(4097, [2], tile) == ([0], 1 + 2 * 2)
    assert pg._segscan_scratch(10_000, [8, 1], tile) == (
        [0, 1 + 5 * 8], 1 + 5 * 8 + 1 + 3 * 1)
    assert pg._segscan_scratch(1, [8, 8, 3], tile) == ([0, 9, 18], 22)


def test_segscan_matches_a_loop_and_rejects_bad_input():
    gid = np.array([3, 3, 3, 7, 9, 9], np.int32)
    v = np.array([1, 2, 2147483647, 5, -1, -2], np.int32)
    (o,) = pg.segscan_i32(_t(gid), [_t(v)])
    assert o.tolist() == [1, 3, -2147483646, 5, -1, -3]
    with pytest.raises(ValueError):
        pg.segscan_i32(_t(gid.astype(np.int64)), [_t(v)])
    with pytest.raises(ValueError):
        pg.segscan_i32(_t(gid), [_t(v[:5])])


def test_profile_names_every_engine_kernel():
    """tools/gpu_profile.py picks the port's own kernels out of a profile by
    their __global__ names: the list names every kernel of the engine's
    sources, and nothing else."""
    import pathlib
    import re

    from lingodb_tpu_torch.tools import gpu_profile

    csrc = pathlib.Path(pg.__file__).parent.parent / "csrc"
    names = set()
    for src in ("gather_chunked.cu", "gather_sorted.cu", "gather_planes.cuh",
                "compact_positions.cu", "segscan.cu"):
        text = (csrc / src).read_text()
        found = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                           r"\s+)?(\w+)\s*\(", text)
        # gather_sorted.cu launches the header's direct form only
        assert found or src == "gather_sorted.cu", src
        names.update(found)
    assert names == set(gpu_profile.PORT_KERNELS)
    for name in names:
        assert gpu_profile._PORT_KERNEL_RE.search(
            f"void (anonymous namespace)::{name}<8>(Planes, int const*)")


def test_bench_sort_route_equals_clamped_take():
    """The reference's sort route as tools/threshold_bench.py --only route
    times it (one stable sort of the indices, the sorted gather at the
    sorted indices, one unsort) with the plain sorted gather: bit-equal to
    t[clamp(idx)] with duplicate and out-of-bounds indices, for 1, 2, 8 and
    11 int32 planes (more than _MAX_PLANES share the one sort) and for
    int64, float64 and bool columns, each one plane of its own dtype."""
    from lingodb_tpu_torch.tools import threshold_bench as tb

    for planes in (1, 2, 8, 11):
        rng = _rng(planes)
        s, n = 40_000, 70_000
        tables = [_t(rng.integers(-(1 << 31), (1 << 31) - 1, s)
                     .astype(np.int32)) for _ in range(planes)]
        idx = rng.integers(-50, s + 50, n).astype(np.int32)
        idx[::7] = idx[3]  # duplicates
        got = tb.sort_route(torch, pg, tables, _t(idx))
        j = np.clip(idx, 0, s - 1)
        for g, t in zip(got, tables):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), t.numpy()[j]), planes

    rng = _rng(7)
    s, n = 30_000, 50_000
    for cols in ([rng.random(s) < 0.4, rng.random(s) < 0.6],
                 [rng.standard_normal(s) for _ in range(3)],
                 [rng.integers(-(1 << 62), 1 << 62, s) for _ in range(5)]):
        idx = rng.integers(-3, s + 3, n)
        got = tb.sort_route(torch, pg, [_t(c) for c in cols],
                            _t(idx.astype(np.int32)))
        for g, c in zip(got, cols):
            assert g.numpy().dtype == c.dtype
            assert np.array_equal(g.numpy(), np.take(c, idx, mode="clip")), \
                c.dtype
