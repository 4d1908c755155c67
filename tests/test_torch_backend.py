"""ops/backend.py, ops/hashing.py, ops/keys.py and ops/join.py of the port
against the same functions of lingodb_tpu on the same numpy inputs. Integer
results are exact; float64 sums are compared to rtol 1e-12 because a scatter
reduction and a sequential sum add in different orders."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lingodb_tpu.ops import backend as rbe
from lingodb_tpu.ops import hashing as rhash
from lingodb_tpu.ops import join as rjoin
from lingodb_tpu.ops import keys as rkeys
from lingodb_tpu.runtime.vtable import SCol as RSCol
from lingodb_tpu.sql.types import Type as RType

from lingodb_tpu_torch.ops import backend as be
from lingodb_tpu_torch.ops import hashing, join, keys
from lingodb_tpu_torch.runtime.vtable import SCol
from lingodb_tpu_torch.sql.types import Type


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n", [0, 1, 2, 1000])
def test_multi_sort(n):
    rng = np.random.default_rng(n)
    k1 = rng.integers(0, 5, n).astype(np.int32)
    k2 = rng.integers(-3, 3, n).astype(np.int64)
    pay = np.arange(n, dtype=np.int64)
    want = rbe.multi_sort([jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(pay)], 2)
    got = be.multi_sort([_t(k1), _t(k2), _t(pay)], 2)
    host = be.multi_sort([k1, k2, pay], 2)
    for g, w, h in zip(got, want, host):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
        np.testing.assert_array_equal(h, np.asarray(w))


def test_multi_sort_is_stable_and_takes_bool_keys():
    k = np.array([True, False, True, False, False])
    pay = np.arange(5, dtype=np.int64)
    got = be.multi_sort([_t(k), _t(pay)], 1)
    np.testing.assert_array_equal(_np(got[1]), [1, 3, 4, 0, 2])


@pytest.mark.parametrize("n,g", [(0, 3), (1, 1), (500, 7), (4000, 130)])
@pytest.mark.parametrize("sorted_", [False, True])
@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64])
def test_segment_reductions(n, g, sorted_, dtype):
    rng = np.random.default_rng(n + g)
    seg = rng.integers(0, g, n).astype(np.int32)
    if sorted_:
        seg = np.sort(seg)
    if dtype == np.float64:
        vals = rng.normal(size=n)
    else:
        vals = rng.integers(-1000, 1000, n).astype(dtype)
    for name in ("segment_sum", "segment_min", "segment_max"):
        want = np.asarray(getattr(rbe, name)(
            jnp.asarray(vals), jnp.asarray(seg), g, indices_are_sorted=sorted_))
        got = _np(getattr(be, name)(_t(vals), _t(seg), g,
                                    indices_are_sorted=sorted_))
        host = getattr(be, name)(vals, seg, g, indices_are_sorted=sorted_)
        assert got.dtype == want.dtype == host.dtype
        if dtype == np.float64 and name == "segment_sum":
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(host, want, rtol=1e-12, atol=1e-12)
        else:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(host, want)


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64])
def test_segment_sum_spread_over_lanes(dtype):
    """Few segments, many rows: the port spreads the scatter-add over
    SPREAD_LANES copies of each segment; the sums must not change."""
    rng = np.random.default_rng(9)
    n, g = be.SPREAD_MIN_ROWS + 1234, 5
    seg = rng.integers(0, g, n).astype(np.int32)
    vals = (rng.normal(size=n) if dtype == np.float64
            else rng.integers(-(1 << 20), 1 << 20, n).astype(dtype))
    want = np.asarray(rbe.segment_sum(jnp.asarray(vals), jnp.asarray(seg), g))
    got = _np(be.segment_sum(_t(vals), _t(seg), g))
    assert got.dtype == want.dtype
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 257])
def test_scans(n):
    rng = np.random.default_rng(n)
    v = rng.integers(-50, 50, n).astype(np.int64)
    pb = rng.random(n) < 0.2
    if n:
        pb[0] = True
    np.testing.assert_array_equal(
        _np(be.cummax(_t(v))), np.asarray(rbe.cummax(jnp.asarray(v))))
    np.testing.assert_array_equal(
        _np(be.rev_cummin(_t(v))), np.asarray(rbe.rev_cummin(jnp.asarray(v))))
    for is_min in (True, False):
        want = np.asarray(rbe.segmented_scan_minmax(
            jnp.asarray(v), jnp.asarray(pb), is_min))
        np.testing.assert_array_equal(
            _np(be.segmented_scan_minmax(_t(v), _t(pb), is_min)), want)
        np.testing.assert_array_equal(
            be.segmented_scan_minmax(v, pb, is_min), want)


def test_set_at_first_true_lut_take():
    arr = np.zeros(10, np.int32)
    idx = np.array([7, 2, 5])
    vals = np.array([1, 2, 3], np.int32)
    want = np.asarray(rbe.set_at(jnp.asarray(arr), jnp.asarray(idx), jnp.asarray(vals)))
    np.testing.assert_array_equal(_np(be.set_at(_t(arr), _t(idx), _t(vals))), want)
    np.testing.assert_array_equal(be.set_at(arr, idx, vals), want)
    assert arr.sum() == 0  # copy-on-write
    for n in (1, 4):
        np.testing.assert_array_equal(
            _np(be.first_true(n, like=torch.zeros(1))),
            np.asarray(rbe.first_true(n, like=jnp.zeros(1))))
    assert be.first_true(0, like=torch.zeros(1)).shape == (0,)
    lut = np.array([10, 20, 30, 40], np.int64)
    codes = np.array([3, 0, 0, 2, 1], np.int32)
    want = np.asarray(rbe.lut_take(lut, jnp.asarray(codes)))
    np.testing.assert_array_equal(_np(be.lut_take(lut, _t(codes))), want)
    np.testing.assert_array_equal(be.lut_take(lut, codes), want)


def test_facade_keeps_numpy_dtype_rules():
    x = _t(np.array([1, 2, 3], np.int32))
    assert be.xnp.cumsum(x).dtype == torch.int32
    assert be.xnp.sum(x > 1).dtype == torch.int64
    assert be.fdiv(x, 10.0).dtype == torch.float64
    wide = be.xnp.where(x > 1, x, np.asarray(2**40, np.int64))
    assert wide.dtype == torch.int64
    assert be.dt(x) == np.int32 and be.astype(x, np.int64).dtype == torch.int64
    (pos,) = be.xnp.nonzero(x > 1, size=4, fill_value=9)
    np.testing.assert_array_equal(_np(pos), [1, 2, 9, 9])
    np.testing.assert_array_equal(
        _np(be.xnp.take(x, _t(np.array([-4, 9])), mode="clip")), [1, 3])


@pytest.mark.parametrize("kind", ["int64", "int32", "bool", "float64", "null"])
def test_hashing_is_bit_equal(kind):
    rng = np.random.default_rng(1)
    n = 2000
    valid = None
    if kind == "int64":
        a = rng.integers(-(1 << 62), 1 << 62, n)
    elif kind == "int32":
        a = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    elif kind == "bool":
        a = rng.random(n) < 0.5
    elif kind == "float64":
        a = rng.normal(size=n)
        a[:4] = [0.0, -0.0, np.inf, -1.5]
    else:
        a = rng.integers(0, 100, n)
        valid = rng.random(n) < 0.7
    b = rng.integers(0, 9, n).astype(np.int32)
    rc = [RSCol(RType.bigint(), jnp.asarray(a), None if valid is None else jnp.asarray(valid)),
          RSCol(RType.int_(), jnp.asarray(b), None)]
    pc = [SCol(Type.bigint(), _t(a), None if valid is None else _t(valid)),
          SCol(Type.int_(), _t(b), None)]
    hc = [SCol(Type.bigint(), a, valid), SCol(Type.int_(), b, None)]
    want = np.asarray(rhash.hash_columns(rc)).astype(np.uint64)
    got = hashing.hash_columns(pc)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    np.testing.assert_array_equal(hashing.hash_columns(hc), want)


@pytest.mark.parametrize("nb,npr", [(0, 5), (1, 1), (300, 1000)])
def test_candidate_pairs_and_pair_reductions(nb, npr):
    rng = np.random.default_rng(nb)
    bk = rng.integers(0, 50, nb)
    pk = rng.integers(0, 60, npr)
    pv = rng.random(npr) < 0.9
    rp, rb, rt = rjoin.candidate_pairs(
        [RSCol(RType.bigint(), jnp.asarray(bk))],
        [RSCol(RType.bigint(True), jnp.asarray(pk), jnp.asarray(pv))], nb, npr)
    pp, pb, pt = join.candidate_pairs(
        [SCol(Type.bigint(), _t(bk))],
        [SCol(Type.bigint(True), _t(pk), _t(pv))], nb, npr)
    assert pt == rt
    np.testing.assert_array_equal(_np(pp), np.asarray(rp))
    np.testing.assert_array_equal(_np(pb), np.asarray(rb))
    if pt:
        mask = rng.random(pt) < 0.5
        for fn in ("matched_flags", "match_count"):
            want = np.asarray(getattr(rjoin, fn)(rp, jnp.asarray(mask), npr))
            np.testing.assert_array_equal(
                _np(getattr(join, fn)(pp, _t(mask), npr)), want)
        wf, wfound = rjoin.first_match(rp, jnp.asarray(mask), npr)
        gf, gfound = join.first_match(pp, _t(mask), npr)
        np.testing.assert_array_equal(_np(gf), np.asarray(wf))
        np.testing.assert_array_equal(_np(gfound), np.asarray(wfound))


def test_sort_permutation_with_nulls_and_floats():
    rng = np.random.default_rng(2)
    n = 500
    f = rng.normal(size=n)
    f[:3] = [0.0, -0.0, -7.25]
    v = rng.random(n) < 0.8
    i = rng.integers(0, 4, n).astype(np.int32)
    want = np.asarray(rkeys.sort_permutation(
        [(RSCol(RType.int_(), jnp.asarray(i)), False, None),
         (RSCol(RType.double(True), jnp.asarray(f), jnp.asarray(v)), True, None)], n))
    got = keys.sort_permutation(
        [(SCol(Type.int_(), _t(i)), False, None),
         (SCol(Type.double(True), _t(f), _t(v)), True, None)], n)
    np.testing.assert_array_equal(_np(got), want)
