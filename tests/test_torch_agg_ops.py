"""The aggregation kernels' plain versions (``ops/agg_kernel.py``)
against the reference's jitted functions of
``search/aggregations/device.py`` on the CPU, bit for bit, on seeded
numpy columns.

The traps: the float64 sum's association (XLA's windows of 32) at 7 to
200,001 rows; XLA:CPU's DAZ / FTZ on float64 (a subnormal value is a
zero of its sign, a negative one makes a min of -0); IEEE minimum and
maximum on ±0; ±inf and NaN (missing) values, int64 values past 2^53
and MISSING_I64; histogram ids on bucket edges, past int64's range and
from an infinite interval (XLA's convert: NaN to 0, saturated); calendar
boundaries of a power-of-two count (no padding: a value at or past the
last boundary, and +inf, count in the last bucket); the scatter-add's
doc order (300,001 docs over 5 ordinals, values over 16 decades); an
empty mask; n_terms one under and one over a power of two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.search.aggregations import device as ref_device

from elasticsearch_tpu_torch.ops import agg_kernel
from elasticsearch_tpu_torch.search.aggregations import device

torch.set_num_threads(1)

MISSING = agg_kernel.MISSING_I64


def _columns(n, seed):
    """(f64 column, i64 column, mask): every trap of the module doc."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, n)
    f[rng.random(n) < 0.05] = np.nan
    f[::11] = -0.0
    f[::13] = 0.0
    f[5::97] = np.inf
    f[7::101] = -np.inf
    f[3 % n] = -1e-310          # a negative subnormal: -0 under DAZ
    f[4 % n] = 3e-320
    i = rng.integers(-2 ** 60, 2 ** 60, n)
    i[::17] = MISSING
    i[1::19] = 2 ** 53 + 1      # rounds to 2^53 in float64
    m = rng.random(n) < 0.6
    return f, i, m


def _valid(col, mask):
    if col.dtype == np.float64:
        return mask & ~np.isnan(col)
    return mask & (col != MISSING)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    return np.asarray(a).tobytes()


@pytest.mark.parametrize("n", [7, 128, 1_000, 65_539, 200_001])
@pytest.mark.parametrize("kind", ["f64", "i64"])
def test_masked_stats_matches_reference(n, kind):
    f, i, m = _columns(n, n)
    col = f if kind == "f64" else i
    for mask in (m, np.zeros_like(m), np.ones_like(m)):
        want = ref_device._stats_fn(kind == "f64")(
            jnp.asarray(col), jnp.asarray(_valid(col, mask)))
        cnt, st = agg_kernel.masked_stats(_t(mask), _t(col))
        assert int(want[0]) == int(cnt[0])
        assert _bits([float(x) for x in want[1:]]) == \
            _bits(st.numpy()), (n, kind)


def test_masked_stats_signed_zeros_and_subnormals():
    """min of {0, -0} is -0 and max +0 in either order; a negative
    subnormal reads as -0; a sum whose exact value is subnormal is
    flushed."""
    for col in ([0.0, -0.0], [-0.0, 0.0], [-0.0, -0.0], [0.0, 0.0],
                [-1e-310, 5e-324], [2.2250738585072014e-308,
                                    -2.2250738585072009e-308],
                [1.5e-308, -1.0e-308], [4.0e-308, -3.0e-308, 2.5e-308]):
        col = np.asarray(col)
        mask = np.ones(len(col), dtype=bool)
        want = ref_device._stats_fn(True)(jnp.asarray(col),
                                          jnp.asarray(mask))
        _, st = agg_kernel.masked_stats(_t(mask), _t(col))
        assert _bits([float(x) for x in want[1:]]) == _bits(st.numpy()), col


@pytest.mark.parametrize("n_terms", [15, 16, 17, 31, 33])
def test_terms_counts_and_presence_match_reference(n_terms):
    n = 3_001
    rng = np.random.default_rng(n_terms)
    ords = rng.integers(-1, n_terms, n).astype(np.int32)
    _, _, m = _columns(n, n_terms)
    n_out = device._pow2(n_terms)
    assert n_out == ref_device._pow2(n_terms)
    for mask in (m, np.zeros_like(m)):
        want = ref_device._terms_counts_fn(n_out)(jnp.asarray(ords),
                                                  jnp.asarray(mask))
        got = agg_kernel.bucket_counts(_t(mask), _t(ords), "terms", n_out)
        assert _bits(want) == _bits(got.numpy())
        want = ref_device._ord_presence_fn(n_out)(jnp.asarray(ords),
                                                  jnp.asarray(mask))
        got = agg_kernel.bucket_counts(_t(mask), _t(ords), "presence",
                                       n_out)
        assert np.asarray(want).dtype == got.numpy().dtype
        assert _bits(want) == _bits(got.numpy())


@pytest.mark.parametrize("kind", ["f64", "i64"])
def test_histogram_counts_match_reference(kind):
    f, i, m = _columns(4_099, 3)
    col = f if kind == "f64" else i
    # values exactly on bucket edges, and past int64's range
    if kind == "f64":
        col[20:30] = np.arange(10) * 0.5 - 3.0
        col[30] = 1e300
        col[31] = -1e300
    else:
        col[20:30] = np.arange(10) * 2 ** 57
        col[30] = 2 ** 63 - 1
    for base, interval, n_out in ((0.0, 1.0, 64), (-3.0, 0.5, 16),
                                  (1e15, 1e14, 64), (0.0, 2.0 ** 57, 32),
                                  (0.0, float("inf"), 16),
                                  (-1e-300, 1e10, 16)):
        for mask in (m, np.zeros_like(m)):
            want = ref_device._histo_counts_fn(n_out)(
                jnp.asarray(col), jnp.asarray(_valid(col, mask)),
                jnp.float64(base), jnp.float64(interval))
            got = agg_kernel.bucket_counts(_t(mask), _t(col), "histogram",
                                           n_out, base=base,
                                           interval=interval)
            assert _bits(want) == _bits(got.numpy()), (base, interval)


@pytest.mark.parametrize("kind", ["f64", "i64"])
@pytest.mark.parametrize("n_bounds", [3, 15, 16, 17])
def test_bounded_counts_match_reference(kind, n_bounds):
    f, i, m = _columns(2_048, n_bounds)
    col = f if kind == "f64" else i
    rng = np.random.default_rng(n_bounds)
    scale = 1.0 if kind == "f64" else 1e17
    b = np.sort(rng.standard_normal(n_bounds) * scale)
    b[0] = 0.0
    b = np.unique(b)
    # values at and past the last boundary, on a boundary, at -0
    if kind == "f64":
        col[40:44] = [b[-1], b[-1] * 2 + 1, b[1], -0.0]
    else:
        col[40:44] = [int(b[-1]), int(b[-1]) * 2 + 1, int(b[1]), 0]
    n_out = device._pow2(len(b))
    bounds = np.full(n_out, np.iinfo(np.int64).max, dtype=np.float64)
    bounds[: len(b)] = b
    for mask in (m, np.zeros_like(m)):
        want = ref_device._bounded_bucket_fn(n_out)(
            jnp.asarray(col), jnp.asarray(_valid(col, mask)),
            jnp.asarray(bounds))
        got = agg_kernel.bucket_counts(_t(mask), _t(col), "bounded", n_out,
                                       bounds=_t(bounds))
        assert _bits(want) == _bits(got.numpy())


@pytest.mark.parametrize("n,n_terms", [(300_001, 5), (4_001, 15),
                                       (4_001, 17), (20_000, 200)])
@pytest.mark.parametrize("kind", ["f64", "i64"])
def test_ord_stats_match_reference(n, n_terms, kind):
    """Each ordinal's sum is a chain in doc order (the scatter-add's)."""
    f, i, m = _columns(n, n + n_terms)
    col = f if kind == "f64" else i
    rng = np.random.default_rng(n_terms)
    ords = rng.integers(-1, n_terms, n).astype(np.int32)
    n_out = device._pow2(n_terms)
    for mask in (m, np.zeros_like(m)):
        ok = _valid(col, mask) & (ords >= 0)
        want = ref_device._terms_metric_fn(n_out)(
            jnp.asarray(ords), jnp.asarray(col), jnp.asarray(ok))
        got = agg_kernel.ord_stats(_t(mask), _t(ords), _t(col), n_out)
        for w, g in zip(want, got):
            assert np.asarray(w).dtype == g.numpy().dtype
            assert _bits(w) == _bits(g.numpy())


def test_ord_stats_signed_zeros():
    """±0 groups, a negative subnormal (-0 under DAZ) and a chain whose
    partial sum turns subnormal by cancellation (flushed)."""
    ords = np.array([0, 0, 1, 1, 2, 3, 3, 4, 4, 4], dtype=np.int32)
    col = np.array([0.0, -0.0, -0.0, 0.0, -0.0, -1e-310, 0.0, 4.0e-308,
                    -3.0e-308, 2.5e-308])
    mask = np.ones(len(col), dtype=bool)
    want = ref_device._terms_metric_fn(16)(jnp.asarray(ords),
                                           jnp.asarray(col),
                                           jnp.asarray(mask))
    got = agg_kernel.ord_stats(_t(mask), _t(ords), _t(col), 16)
    for w, g in zip(want, got):
        assert _bits(w) == _bits(g.numpy())
