"""The port's substrate kernels (lingodb_tpu_torch/ops/substrate.py, T1-T7)
against the Pallas kernels of the JAX package's substrate bench, run in
interpret mode on the same numpy inputs from a seed. int32 results are
compared bit for bit.

T1/T2 are the functions of benchtools/tools_pallas_gather.py, imported by
path. T3-T7 are closures inside benchtools/tools_kbench.py::main(), so their
kernel bodies and pallas_call specs are copied here verbatim (each copy
names its lines) and run with interpret=True. On CPU tensors the port's
wrappers run their plain versions; the CUDA kernels themselves are held
against those plain versions on the card by chip_smoke.py (phase 8)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lingodb_tpu_torch.ops import substrate as sb

_spec = importlib.util.spec_from_file_location(
    "tools_pallas_gather",
    Path(__file__).resolve().parents[1] / "benchtools" / "tools_pallas_gather.py")
tpg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tpg)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _i32(rng, lo, hi, shape):
    return rng.integers(lo, hi, shape, dtype=np.int32)


# ---- verbatim copies of benchtools/tools_kbench.py's kernels -------------

def k_lane(d_ref, l_ref, o_ref):  # tools_kbench.py:76-77
    o_ref[:] = jnp.take_along_axis(d_ref[:], l_ref[:], axis=1)


def ref_lane(d, l, T, n_tiles):  # tools_kbench.py:79-86, interpret=True
    return pl.pallas_call(
        k_lane,
        grid=(n_tiles,),
        in_specs=[pl.BlockSpec((T, 128), lambda i: (i, 0)),
                  pl.BlockSpec((T, 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((T, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n_tiles * T, 128), jnp.int32),
        interpret=True,
    )(d, l)


def k_sub(r_ref, t_ref, o_ref):  # tools_kbench.py:97-98
    o_ref[:] = jnp.take_along_axis(t_ref[:], r_ref[:], axis=0)


def ref_sub(r, t, R, nt):  # tools_kbench.py:101-108, interpret=True
    return pl.pallas_call(
        k_sub,
        grid=(nt,),
        in_specs=[pl.BlockSpec((R, 128), lambda i: (i, 0)),
                  pl.BlockSpec((R, 128), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((R, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((nt * R, 128), jnp.int32),
        interpret=True,
    )(r, t)


def k_roll(t_ref, o_ref):  # tools_kbench.py:118-125
    t = t_ref[:]
    acc = jnp.zeros_like(t)
    for sh in range(1, 129):
        s = sh % 128
        tsh = jnp.concatenate([t[:, s:], t[:, :s]], axis=1) if s else t
        acc = acc + tsh
    o_ref[:] = acc


def k_roll2(t_ref, o_ref):  # tools_kbench.py:141-146
    t = t_ref[:]
    acc = jnp.zeros_like(t)
    for sh in range(1, 129):
        acc = acc + pltpu.roll(t, shift=sh % 128, axis=1)
    o_ref[:] = acc


def ref_roll(kernel, t, R):  # tools_kbench.py:127-133 / :148-154, interpret=True
    return pl.pallas_call(
        kernel,
        grid=(8,),
        in_specs=[pl.BlockSpec((R, 128), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((R, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((R, 128), jnp.int32),
        interpret=True,
    )(t)


def make_k_mm(Tc):
    def k_mm(x_ref, m_ref, o_ref):  # tools_kbench.py:209-218
        x = x_ref[:].astype(jnp.float32)
        m = m_ref[:].astype(jnp.float32)
        c = jnp.cumsum(m, axis=0)  # per-lane compaction (column-wise)
        q = jax.lax.broadcasted_iota(jnp.float32, (Tc, Tc), 0)
        # P[q,p] per lane would be 3-D; approximate the cost: one (Tc,Tc)
        # fp32 matmul per tile against the (Tc,128) values.
        P = (q == c[:, :1].T).astype(jnp.float32)
        o_ref[:] = jnp.dot(P, x * m,
                           preferred_element_type=jnp.float32).astype(jnp.int32)
    return k_mm


def ref_mm(x, m, Tc, ntc):  # tools_kbench.py:220-227, interpret=True
    return pl.pallas_call(
        make_k_mm(Tc),
        grid=(ntc,),
        in_specs=[pl.BlockSpec((Tc, 128), lambda i: (i, 0)),
                  pl.BlockSpec((Tc, 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((Tc, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((ntc * Tc, 128), jnp.int32),
        interpret=True,
    )(x, m)


@pytest.fixture(autouse=True)
def _counters():
    sb.reset_counters()
    yield
    sb.reset_counters()


# ---- T1, T2 ---------------------------------------------------------------

# S = 1, S = 4,097 and 5,000 (not a multiple of 1024: the reference pads
# the table; the port's staged form holds the whole table), 2^16 (the
# staged form holds its first part); n not a multiple of S (the reference
# pads the indices). On the CPU these hold the plain version; the kernel's
# forms are held on the card by chip_smoke.py's check_gather_shift_edges.
@pytest.mark.parametrize("s", [1, 4097, 5000, 1 << 16])
def test_gather_shift_against_pallas(s):
    rng = np.random.default_rng(1)
    n = 3000
    table, idx = _i32(rng, 0, 1 << 30, s), _i32(rng, 0, s, n)
    want = np.asarray(tpg.pallas_gather_shift(jnp.asarray(table),
                                              jnp.asarray(idx), interpret=True))
    got = sb.gather_shift(_t(table), _t(idx))
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[idx])


# S = 1 and both sides of the edges of the kernel's forms (the whole table
# held, the last table staged): the contract the card's kernel is held to
# against table_gather_plain, out-of-range indices clamped to [0, S - 1]
@pytest.mark.parametrize("s", [1, 58_108, 58_109, 232_432, 232_433])
def test_gather_shift_clamps_out_of_range_indices(s):
    rng = np.random.default_rng(s)
    table = _i32(rng, -(1 << 31), (1 << 31) - 1, s)
    idx = np.concatenate([
        np.array([-(1 << 31), (1 << 31) - 1, -1, 0, s - 1, s], np.int32),
        _i32(rng, -3, s + 3, 1001)])
    want = table[np.clip(idx, 0, s - 1)]
    for fn in (sb.gather_shift, sb.table_gather_plain):
        got = fn(_t(table), _t(idx))
        assert got.dtype == torch.int32 and got.shape == idx.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_gather_small_against_pallas():
    rng = np.random.default_rng(2)
    s, n = 1000, 3000  # S not a multiple of 128, n not of the 1024-index tile
    table, idx = _i32(rng, 0, 1 << 30, s), _i32(rng, 0, s, n)
    want = np.asarray(tpg.pallas_gather_small(jnp.asarray(table), jnp.asarray(idx),
                                              tile_rows=8, interpret=True))
    got = sb.gather_small(_t(table), _t(idx))
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[idx])


# ---- T3, T4 ---------------------------------------------------------------

def test_lane_gather_against_pallas():
    rng = np.random.default_rng(3)
    T, n_tiles = 8, 2
    d = _i32(rng, 0, 1 << 30, (n_tiles * T, 128))
    l = _i32(rng, 0, 128, (n_tiles * T, 128))
    want = np.asarray(ref_lane(jnp.asarray(d), jnp.asarray(l), T, n_tiles))
    got = sb.lane_gather(_t(d), _t(l))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.take_along_axis(d, l, axis=1))


# R = 1, then the last R of each form of csrc/tile_gather.cu's
# sublane_gather and the first R past it, as its ldb_sublane_band_edges
# gives them on the H100: the direct form up to 64 rows, bands of W = 128
# up to 454, 64 up to 908, ..., 8 up to 7,264, a partial band of 8 up to
# 18,160, then the direct form
_BAND_EDGES = [1, 64, 65, 454, 455, 908, 909, 3632, 3633, 7264, 7265, 16384,
               18160, 18161]


@pytest.mark.parametrize("R", [8, 64] + [r for r in _BAND_EDGES if r != 64])
def test_sublane_gather_against_pallas(R):
    rng = np.random.default_rng(4 + R)
    nt = 3 if R <= 1024 else 1
    tab = _i32(rng, 0, 1 << 30, (R, 128))
    rows = _i32(rng, 0, R, (nt * R, 128))
    want = np.asarray(ref_sub(jnp.asarray(rows), jnp.asarray(tab), R, nt))
    got = sb.sublane_gather(_t(tab), _t(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  tab[rows, np.arange(128)[None, :]])


# ---- T5, T6 ---------------------------------------------------------------

@pytest.mark.parametrize("kernel", [k_roll, k_roll2], ids=["k_roll", "k_roll2"])
@pytest.mark.parametrize("lo,hi", [(0, 1 << 30), ((1 << 30) - 64, 1 << 30),
                                   (-(1 << 31), (1 << 31) - 1)],
                         ids=["random", "near_2^30", "full_range"])
def test_lane_rotsum_against_pallas(kernel, lo, hi):
    # sums of 128 values near 2^30 wrap in int32 on both sides
    rng = np.random.default_rng(5)
    R = 16
    t = rng.integers(lo, hi, (R, 128), dtype=np.int64).astype(np.int32)
    want = np.asarray(ref_roll(kernel, jnp.asarray(t), R))
    got = sb.lane_rotsum(_t(t))
    np.testing.assert_array_equal(got.numpy(), want)
    wrapped = (t.astype(np.int64).sum(1) % (1 << 32)).astype(np.uint32)
    np.testing.assert_array_equal(got.numpy(),
                                  np.repeat(wrapped.view(np.int32)[:, None], 128, 1))


# ---- T7 -------------------------------------------------------------------

# lane 0 of the first tile set at these rows only: runs that cross every
# edge of the CUDA kernel's 32-row segments, and runs that end on them
_SEGMENT_HEADS = {"crossing_segment_edges": [0, 20, 50, 90, 120, 150, 170, 200, 230],
                  "ending_on_segment_edges": list(range(32, 256, 32))}


@pytest.mark.parametrize("lane0", ["random", "all_ones", "all_zeros",
                                   *_SEGMENT_HEADS])
def test_onehot_compact_against_pallas(lane0):
    # all_ones: c runs 1..256, so slot 0 is empty and the last row (c = 256)
    # is dropped; all_zeros: every row goes to slot 0
    rng = np.random.default_rng(7)
    Tc, ntc = 256, 2
    x = _i32(rng, 0, 1 << 15, (ntc * Tc, 128))
    m = (rng.random((ntc * Tc, 128)) < 0.2).astype(np.int32)
    if lane0 in _SEGMENT_HEADS:
        m[:Tc, 0] = 0
        m[_SEGMENT_HEADS[lane0], 0] = 1
    elif lane0 != "random":
        m[:Tc, 0] = 1 if lane0 == "all_ones" else 0
    want = np.asarray(ref_mm(jnp.asarray(x), jnp.asarray(m), Tc, ntc))
    got = sb.onehot_compact(_t(x), _t(m))
    assert got.dtype == torch.int32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if lane0 == "all_ones":
        assert not got.numpy()[0].any()
    if lane0 == "all_zeros":
        np.testing.assert_array_equal(got.numpy()[0], (x * m)[:Tc].sum(0))
        assert not got.numpy()[1:Tc].any()


# ---- the wrappers' checks and launch counts -------------------------------

def _calls():
    rng = np.random.default_rng(8)
    table, idx = _t(_i32(rng, 0, 100, 100)), _t(_i32(rng, 0, 100, 10))
    a = _t(_i32(rng, 0, 128, (256, 128)))
    m = _t((rng.random((256, 128)) < 0.5).astype(np.int32))
    return {
        "gather_shift": (sb.gather_shift, (table, idx), sb.table_gather_plain),
        "gather_small": (sb.gather_small, (table, idx), sb.table_gather_plain),
        "lane_gather": (sb.lane_gather, (a, a), sb.lane_gather_plain),
        "sublane_gather": (sb.sublane_gather, (a[:8].clone(), a),
                           sb.sublane_gather_plain),
        "lane_rotsum": (sb.lane_rotsum, (a,), sb.lane_rotsum_plain),
        "onehot_compact": (sb.onehot_compact, (a, m), sb.onehot_compact_plain),
    }


@pytest.mark.parametrize("name", list(sb.LAUNCHES))
def test_wrapper_counts_a_launch_only_on_the_kernel_route(name, monkeypatch):
    fn, args, plain = _calls()[name]
    want = plain(*args)
    assert torch.equal(fn(*args), want)  # CPU tensor: plain version, no launch
    assert sb.LAUNCHES[name] == 0
    monkeypatch.setattr(sb, "FORCE_KERNELS", True)
    assert torch.equal(fn(*args), want)
    assert sb.LAUNCHES == {k: int(k == name) for k in sb.LAUNCHES}


@pytest.mark.parametrize("name", list(sb.LAUNCHES))
def test_wrapper_rejects_wrong_dtype_and_shape(name):
    fn, args, _ = _calls()[name]
    with pytest.raises(ValueError, match="int32"):
        fn(*[a.to(torch.int64) for a in args])
    with pytest.raises(ValueError):
        fn(*[a.reshape(-1)[:64].reshape(2, 32) if a.ndim == 2 else a.reshape(2, -1)
             for a in args])
    with pytest.raises(ValueError, match="contiguous"):
        fn(*[a[::2] for a in args])


def test_wrapper_limits():
    table = torch.zeros(sb.SMALL_TABLE_LIMIT + 1, dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="table of"):
        sb.gather_small(table, idx)
    assert sb.gather_shift(table, idx).shape == (4,)
    with pytest.raises(ValueError, match="multiple of 256"):
        x = torch.zeros((300, 128), dtype=torch.int32)
        sb.onehot_compact(x, x)
    with pytest.raises(ValueError, match="differ"):
        sb.lane_gather(torch.zeros((8, 128), dtype=torch.int32),
                       torch.zeros((16, 128), dtype=torch.int32))
