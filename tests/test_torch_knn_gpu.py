"""The kNN similarity kernel (``csrc/knn.cu``) on the card against its
plain version, bit for bit (gpu-marked: skips without a CUDA device; it
imports no JAX, so it runs where JAX is missing).

``test_torch_knn_ops.py`` holds the plain version against the reference
on the CPU; these hold the kernel against the plain version on the card
at the main path's shapes: each similarity and formula, one query (the
REST path's) and 64 (the mesh step's), 13 to 1,100 dims, NaN rows,
denormal components (the flush), ``ok`` and the cutoff; at the edges of
the kernel's tiles (1 to 65 queries: the row instance's 8 and the tile
instance's 64 on each side; 8, 56 and 72 rows: a 64-row tile part
filled; 8 to 4,096 dims: the gemv's tail, a stage's 128 columns, windows
that straddle two stages, window sums summed in windows again), with
+-inf and NaN components; in the flush's band (fused multiply-adds whose
exact result lies within a few 2^-149 of FLT_MIN, where rounding before
or after the flush differ); and ``knn_topk`` in stages (k past K_LIMIT;
slices narrowed) against one top-k of the plain version.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import knn_kernel, merge_kernel, sparse

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def bits(t):
    return t.cpu().contiguous().view(torch.int32).numpy()


def _inputs(n, dims, b, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, dims)).astype(np.float32)
    v[::13] = np.nan
    v[1, 0] = 1e-40          # denormal components: flushed
    v[2, dims - 1] = -2e-39
    q = rng.standard_normal((b, dims)).astype(np.float32)
    q[0, 0] = 3e-39
    ok = rng.random(n) < 0.97
    return torch.from_numpy(v), torch.from_numpy(q), torch.from_numpy(ok)


@pytest.mark.parametrize("formula", knn_kernel.FORMULAS)
@pytest.mark.parametrize("kind", knn_kernel.KINDS)
def test_knn_scores_on_the_card_match_plain(cuda, kind, formula):
    for n, dims, b in ((12_544, 64, 1), (4_096, 13, 3), (8_192, 768, 64),
                       (2_048, 100, 9), (1_024, 1_100, 9)):
        v, q, ok = _inputs(n, dims, b, n + dims)
        sim = None
        if formula == "segment":
            sim = {"l2_norm": 11.0, "dot_product": 0.3, "cosine": 0.1}[kind]
        # the widest shapes' plain version runs on the card (the same
        # torch ops; the CPU's take minutes there)
        at = cuda if dims >= 768 else torch.device("cpu")
        want = knn_kernel.knn_scores_plain(v.to(at), q.to(at), kind,
                                           formula=formula, ok=ok.to(at),
                                           similarity=sim)
        before = knn_kernel.LAUNCHES["knn_scores"]
        got = knn_kernel.knn_scores(v.to(cuda), q.to(cuda), kind,
                                    formula=formula, ok=ok.to(cuda),
                                    similarity=sim)
        torch.cuda.synchronize()
        assert knn_kernel.LAUNCHES["knn_scores"] == before + 1
        np.testing.assert_array_equal(bits(got), bits(want),
                                      err_msg=(n, dims, b))


EDGE_QUERIES = (1, 7, 8, 9, 63, 64, 65)
EDGE_ROWS = (8, 56, 72)
EDGE_DIMS = (8, 13, 768, 1_100, 4_096)


def _edge_inputs(n, dims, b, seed):
    """_inputs with +-inf components and NaN components that are not a
    row's first (the mesh formula reads them as +-FLT_MAX and 0, and
    keeps the row)."""
    v, q, ok = _inputs(n, dims, b, seed)
    v[3, dims // 2] = float("inf")
    v[4, dims - 1] = float("-inf")
    v[5, 0] = float("inf")
    v[6, dims // 3] = float("nan")
    return v, q, ok


@pytest.mark.parametrize("dims", EDGE_DIMS)
@pytest.mark.parametrize("formula", knn_kernel.FORMULAS)
@pytest.mark.parametrize("kind", knn_kernel.KINDS)
def test_knn_scores_at_the_tiles_edges(cuda, kind, formula, dims):
    for b in EDGE_QUERIES:
        for n in EDGE_ROWS:
            v, q, ok = _edge_inputs(n, dims, b, 7 * n + b + dims)
            v, q, ok = v.to(cuda), q.to(cuda), ok.to(cuda)
            sim = None
            if formula == "segment":
                sim = {"l2_norm": 60.0, "dot_product": -5.0,
                       "cosine": -0.5}[kind]
            want = knn_kernel.knn_scores_plain(v, q, kind, formula=formula,
                                               ok=ok, similarity=sim)
            got = knn_kernel.knn_scores(v, q, kind, formula=formula, ok=ok,
                                        similarity=sim)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(bits(got), bits(want),
                                          err_msg=(b, n, dims))


def _band_inputs(n, b):
    """f32[n, 16] rows and b equal queries whose gemv's lane 0 ends on a
    fused multiply-add with an exact result near +-FLT_MIN: column 8 a
    row's b_i (FLT_MIN / a, nudged by -n/2 .. n/2 ulps) against the
    queries' a; column 0 zero or +-2 FLT_MIN against 1 (the addend)."""
    rng = np.random.default_rng(5)
    a = np.float32(0.5 + rng.random() / 2)
    b0 = np.float32(np.float64(np.float32(2.0 ** -126)) / np.float64(a))
    col8 = (b0.view(np.uint32).astype(np.int64)
            + np.arange(-(n // 2), n - n // 2)).astype(np.uint32) \
        .view(np.float32)
    sign = np.where(np.arange(n) % 2, -1.0, 1.0).astype(np.float32)
    v = np.zeros((n, 16), dtype=np.float32)
    v[:, 8] = col8 * sign
    v[:, 0] = np.where(np.arange(n) % 4 >= 2, -sign * 2.0 ** -125, 0.0)
    q = np.zeros((b, 16), dtype=np.float32)
    q[:, 0] = 1.0
    q[:, 8] = a
    return torch.from_numpy(v), torch.from_numpy(q)


@pytest.mark.parametrize("formula", knn_kernel.FORMULAS)
@pytest.mark.parametrize("kind", knn_kernel.KINDS)
def test_knn_scores_in_the_flush_band(cuda, kind, formula):
    for b in (1, 9):
        v, q = _band_inputs(256, b)
        want = knn_kernel.knn_scores_plain(v, q, kind, formula=formula)
        got = knn_kernel.knn_scores(v.to(cuda), q.to(cuda), kind,
                                    formula=formula)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=b)


def test_knn_topk_in_stages_on_the_card(cuda, monkeypatch):
    """k past K_LIMIT takes steps of K_LIMIT; a narrowed row cap takes
    slices: both give one top-k's values and positions."""
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 300, (2, 60_000)).astype(np.float32)
    vals[:, ::11] = -np.inf
    t = torch.from_numpy(vals)
    k = merge_kernel.K_LIMIT + 5_000
    want_v, want_p = sparse.top_k_plain(t, k)
    got_v, got_p = knn_kernel.knn_topk(t.to(cuda), k)
    np.testing.assert_array_equal(bits(got_v), bits(want_v))
    np.testing.assert_array_equal(got_p.cpu().numpy(), want_p.numpy())
    want_v, want_p = sparse.top_k_plain(t, 100)
    monkeypatch.setattr(knn_kernel, "_row_cap", lambda kk: 7_000)
    got_v, got_p = knn_kernel.knn_topk(t.to(cuda), 100)
    np.testing.assert_array_equal(bits(got_v), bits(want_v))
    np.testing.assert_array_equal(got_p.cpu().numpy(), want_p.numpy())
