"""The kNN similarity kernel's plain version and its top-k against the
reference, bit for bit (CPU).

``ops/knn_kernel.similarity_scores_plain`` against the reference's
``search/knn.py::_similarity_scores`` (raw similarity and score as
uint32) for each similarity at dims 4, 13, 64, 100 and 768 over d_pad
128 and 1,024 rows, with NaN rows (missing vectors), a zero vector
(cosine's 1e-12 floor), denormal components (XLA:CPU flushes them) and
tied rows, and at 1,100 dims (a second level of window sums); the masked top-k (``knn_scores`` + ``knn_topk``) against the
reference's mask and ``lax.top_k``; ``xla_gemv``'s multiple-of-8 rule;
``knn_topk``'s stages against one top-k; the flush's band (products and
the gemv's fused multiply-adds whose exact result lies within a few
2^-150 of FLT_MIN) against XLA:CPU's own ops; and the CUDA
source itself, run by the host emulator (``tools/cuda_emu``), against
the plain version. The card's own runs are in ``test_torch_knn_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.search.knn import _similarity_scores

from elasticsearch_tpu_torch.ops import knn_kernel, merge_kernel, sparse
from elasticsearch_tpu_torch.ops.xla_math import xla_ftz, xla_gemv, xla_mulf
from elasticsearch_tpu_torch.tools import cuda_emu

torch.set_num_threads(1)

KINDS = knn_kernel.KINDS
SHAPES = [(dims, n) for dims in (4, 13, 64, 100, 768)
          for n in (128, 1024)] + [(1100, 128)]


def _u32(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _vectors(dims, n, seed):
    """Seeded rows with every 7th row NaN (a missing vector), a zero
    row, denormal components, and two pairs of equal rows (ties)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, dims)).astype(np.float32)
    v[::7] = np.nan
    v[3] = 0.0
    v[5, 0] = 1e-40
    v[6, -1] = -3e-39
    v[9] = v[8]
    v[11] = v[10]
    q = rng.standard_normal(dims).astype(np.float32)
    q[dims // 2] = 2e-39
    return v, q


def _same_bits(want, got):
    """Equal bits, any NaN equal to any NaN (a NaN row's bits are never
    read: the mask drops it)."""
    want = np.asarray(want, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    both_nan = np.isnan(want) & np.isnan(got)
    np.testing.assert_array_equal(np.where(both_nan, 0, _u32(want)),
                                  np.where(both_nan, 0, _u32(got)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dims,n", SHAPES)
def test_similarity_scores_bitwise(dims, n, kind):
    v, q = _vectors(dims, n, dims * 7 + n)
    want_raw, want = _similarity_scores(jnp.asarray(v), jnp.asarray(q), kind)
    got_raw, got = knn_kernel.similarity_scores_plain(
        torch.from_numpy(v), torch.from_numpy(q), kind)
    _same_bits(want_raw, got_raw.numpy())
    _same_bits(want, got.numpy())
    if kind == "cosine":
        assert float(got[3]) == 0.5  # the zero row: cos 0 by the floor


def _reference_candidates(v, q, kind, live, fmask, similarity, n_cand):
    """shard_candidates' mask and lax.top_k for one segment."""
    raw, score = _similarity_scores(jnp.asarray(v), jnp.asarray(q), kind)
    ok = ~jnp.isnan(raw) & jnp.asarray(live) & jnp.asarray(fmask)
    if similarity is not None:
        if kind == "l2_norm":
            ok = ok & (raw >= -similarity)
        else:
            ok = ok & (raw >= similarity)
    score = jnp.where(ok, score, -jnp.inf)
    vals, ords = jax.lax.top_k(score, min(n_cand, score.shape[0]))
    return np.asarray(vals), np.asarray(ords)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cut", [None, "cut"])
def test_masked_topk_matches_lax_top_k(kind, cut):
    v, q = _vectors(64, 1024, 3)
    v[40:60] = v[20]  # twenty tied rows
    rng = np.random.default_rng(4)
    live = rng.random(1024) < 0.95
    fmask = rng.random(1024) < 0.8
    similarity = None
    if cut:
        similarity = {"l2_norm": 11.0, "dot_product": 0.5,
                      "cosine": 0.02}[kind]
    for n_cand in (10, 100, 1024):
        want_v, want_o = _reference_candidates(v, q, kind, live, fmask,
                                               similarity, n_cand)
        ok = torch.from_numpy(live & fmask)
        score = knn_kernel.knn_scores(torch.from_numpy(v),
                                      torch.from_numpy(q)[None, :], kind,
                                      ok=ok, similarity=similarity)
        got_v, got_o = knn_kernel.knn_topk(score, n_cand)
        np.testing.assert_array_equal(_u32(want_v), _u32(got_v[0].numpy()))
        np.testing.assert_array_equal(want_o, got_o[0].numpy())


def test_gemv_takes_a_multiple_of_eight_rows():
    """XLA:CPU's gemv sums the rows past the last multiple of 8 in another
    association: xla_gemv refuses them, and so does the kernel's
    wrapper."""
    with pytest.raises(ValueError, match="multiple of 8"):
        xla_gemv(torch.ones(257, 4), torch.ones(4))
    with pytest.raises(ValueError, match="multiple of 8"):
        knn_kernel._launch(torch.ones(12, 4), torch.ones(1, 4), "cosine",
                           "segment", None, None, None, None)
    assert xla_gemv(torch.ones(256, 4), torch.ones(4)).shape == (256,)


@pytest.mark.parametrize("k", [5, 40, 300])
def test_staged_topk_matches_one_top_k(k, monkeypatch):
    """knn_topk in stages (slices of a row, or k in steps) gives one
    top-k's values and positions: ties (many equal values, -inf) keep
    position order."""
    rng = np.random.default_rng(k)
    vals = rng.integers(0, 50, (3, 1000)).astype(np.float32)
    vals[:, ::9] = -np.inf
    t = torch.from_numpy(vals)
    want_v, want_p = sparse.top_k_plain(t, k)
    k_limit, row_cap = merge_kernel.K_LIMIT, knn_kernel._row_cap
    for k_cap, narrow in ((None, True), (max(1, k // 3), False),
                          (max(1, k // 3), True)):
        monkeypatch.setattr(merge_kernel, "K_LIMIT", k_cap or k_limit)
        monkeypatch.setattr(knn_kernel, "_row_cap",
                            (lambda kk: 2 * k + 7) if narrow else row_cap)
        got_v, got_p = knn_kernel.knn_topk(t, k)
        np.testing.assert_array_equal(want_v.numpy(), got_v.numpy())
        np.testing.assert_array_equal(want_p.numpy(), got_p.numpy())


def _band_gemv(n, seed):
    """f32[n, 16] rows and a query whose gemv's lane 0 ends on a fused
    multiply-add with an exact result near +-FLT_MIN: column 8 a row's
    b_i (FLT_MIN / a, nudged by -n/2 .. n/2 ulps) against the query's a;
    column 0 zero or +-2 FLT_MIN against 1 (the addend)."""
    rng = np.random.default_rng(seed)
    a = np.float32(0.5 + rng.random() / 2)
    b0 = np.float32(np.float64(np.float32(2.0 ** -126)) / np.float64(a))
    col8 = (b0.view(np.uint32).astype(np.int64)
            + np.arange(-(n // 2), n - n // 2)).astype(np.uint32) \
        .view(np.float32)
    sign = np.where(np.arange(n) % 2, -1.0, 1.0).astype(np.float32)
    v = np.zeros((n, 16), dtype=np.float32)
    v[:, 8] = col8 * sign
    v[:, 0] = np.where(np.arange(n) % 4 >= 2, -sign * 2.0 ** -125, 0.0)
    q = np.zeros(16, dtype=np.float32)
    q[0] = 1.0
    q[8] = a
    return v, q


def _band_products(n, seed):
    """(a, b) f32[n] with a * b within a few 2^-150 of +-FLT_MIN: a in
    [0.5, 1), b = FLT_MIN / a nudged by -3 .. 3 ulps."""
    rng = np.random.default_rng(seed)
    a = (np.uint32(0x3F000000)
         + rng.integers(0, 2 ** 23, n).astype(np.uint32)).view(np.float32)
    b = (2.0 ** -126 / a.astype(np.float64)).astype(np.float32)
    b = (b.view(np.uint32).astype(np.int64)
         + rng.integers(-3, 4, n)).astype(np.uint32).view(np.float32)
    return a * np.where(np.arange(n) % 2, -1, 1).astype(np.float32), b


@pytest.mark.parametrize("op", ["mul", "gemv"])
def test_flush_band_matches_reference(op):
    """XLA:CPU flushes a result that is tiny after rounding to 24 bits
    with an unbounded exponent (x86's rule): a value just below FLT_MIN
    that rounds up to FLT_MIN on float32's subnormal grid is a zero
    there. xla_mulf and xla_gemv's fused steps (through the plain
    similarity) give its bits."""
    if op == "gemv":
        v, q = _band_gemv(512, 5)
        want, _ = _similarity_scores(jnp.asarray(v), jnp.asarray(q),
                                     "dot_product")
        got, _ = knn_kernel.similarity_scores_plain(
            torch.from_numpy(v), torch.from_numpy(q), "dot_product")
        # results near FLT_MIN: the band is reached
        assert (np.abs(np.asarray(want)) < 2.0 ** -125).sum() > 100
    else:
        a, b = _band_products(4096, 6)
        want = jax.jit(lambda x, y: x * y)(jnp.asarray(a), jnp.asarray(b))
        got = xla_mulf(torch.from_numpy(a), torch.from_numpy(b))
        # a float32 product flushed after rounding keeps some of the band
        after = xla_ftz(torch.from_numpy(a) * torch.from_numpy(b)).numpy()
        assert (_u32(after) != _u32(np.asarray(want))).sum() > 50
    np.testing.assert_array_equal(_u32(np.asarray(want)), _u32(got.numpy()))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    with cuda_emu.emulated(tmp_path_factory.mktemp("knn_emu"), "knn"):
        yield


@pytest.mark.parametrize("formula", knn_kernel.FORMULAS)
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_kernel_matches_plain(emulated, kind, formula):
    """The CUDA source, run on the host by the emulator (a CUDA thread a
    fiber), against the plain version bit for bit: one query (the row
    instance), nine (the tile instance, one query tile part filled; the
    segment formula's l2_norm: row chunks of eight and one) and, at 100
    dims, 65 (two query tiles); 264 rows (a last tile of 8); 4 to 1,100
    dims (the gemv's tail alone, lanes and tail, lanes alone; 16-byte and
    4-byte staging; one window, several, windows that straddle a stage,
    and window sums summed in windows again), NaN rows, denormals, ``ok``
    and the cutoff."""
    rng = np.random.default_rng(9)
    for dims in (4, 13, 64, 100, 1100):
        v, _ = _vectors(dims, 264, dims)
        qs = rng.standard_normal((65, dims)).astype(np.float32)
        qs[0, 1] = 1e-39
        ok = torch.from_numpy(rng.random(264) < 0.9)
        sim = {"l2_norm": 12.0, "dot_product": 0.1, "cosine": 0.05}[kind] \
            if formula == "segment" else None
        for b in (1, 9) + ((65,) if dims == 100 else ()):
            args = (torch.from_numpy(v), torch.from_numpy(qs[:b]), kind)
            want = knn_kernel.knn_scores_plain(*args, formula=formula,
                                               ok=ok, similarity=sim)
            got = knn_kernel._launch(*args, formula, ok, sim, {}, None)
            np.testing.assert_array_equal(_u32(want.numpy()),
                                          _u32(got.numpy()))


@pytest.mark.parametrize("formula", knn_kernel.FORMULAS)
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_kernel_in_the_flush_band(emulated, kind, formula):
    """The CUDA source's .ftz steps (the emulator's: x86's flush rule,
    the card's) against the plain version where the gemv's fused steps
    end near FLT_MIN: one query and nine."""
    v, q = _band_gemv(256, 5)
    for b in (1, 9):
        args = (torch.from_numpy(v), torch.from_numpy(np.tile(q, (b, 1))),
                kind)
        want = knn_kernel.knn_scores_plain(*args, formula=formula)
        got = knn_kernel._launch(*args, formula, None, None, {}, None)
        np.testing.assert_array_equal(_u32(want.numpy()), _u32(got.numpy()))
