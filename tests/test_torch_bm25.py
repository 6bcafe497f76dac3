"""The port's ops/bm25.py against the JAX package's, bit for bit.

The same seeded documents go through both packages' mapper, segment
writer and segment pack; every op of ``ops/bm25.py`` then runs on the
same operands in JAX (on the CPU) and in torch (on the CPU, the plain
path), and the outputs are compared exactly: scores as uint32, masks
and indices as integers. Also the port copies of ``test_bm25_kernels.py``
(tie-break, boolean masks, ranges, batches, merge and pack padding).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.common.settings import Settings as RefSettings
from elasticsearch_tpu.index.pack import build_segment_pack as ref_pack
from elasticsearch_tpu.index.segment import SegmentWriter as RefWriter
from elasticsearch_tpu.mapping import MapperService as RefMapper
from elasticsearch_tpu.ops import bm25 as ref_bm25

from elasticsearch_tpu_torch.index.pack import build_segment_pack
from elasticsearch_tpu_torch.index.segment import (MISSING_I64,
                                                   SegmentWriter,
                                                   merge_segments)
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops import bm25, smallfloat

VOCAB = [f"w{i}" for i in range(50)]
MAPPING = {"properties": {"body": {"type": "text"}}}


def make_sources(rng, n_docs, name="seg0"):
    out = []
    for i in range(n_docs):
        n_tokens = int(rng.integers(1, 30))
        words = [VOCAB[min(int(rng.zipf(1.3)) - 1, len(VOCAB) - 1)]
                 for _ in range(n_tokens)]
        out.append((f"{name}-d{i}", {"body": " ".join(words)}))
    return out


def make_segments(seed, n_docs, name="seg0"):
    """The same documents through both packages → (ref segment, port
    segment)."""
    srcs = make_sources(np.random.default_rng(seed), n_docs, name)
    ref_ms = RefMapper(RefSettings.EMPTY, MAPPING)
    ms = MapperService(MAPPING)
    rw, w = RefWriter(name), SegmentWriter(name)
    for doc_id, src in srcs:
        rw.add_document(ref_ms.parse_document(doc_id, src), {})
        w.add_document(ms.parse_document(doc_id, src), ms.dv_kinds())
    return rw.freeze(), w.freeze()


def operands(fp, seg, queries, t_pad):
    """starts/lengths/idf_boost [B, t_pad] and max_len for term lists."""
    k1 = 1.2
    b_n = len(queries)
    starts = np.zeros((b_n, t_pad), dtype=np.int32)
    lengths = np.zeros((b_n, t_pad), dtype=np.int32)
    idf_boost = np.zeros((b_n, t_pad), dtype=np.float32)
    max_len = 1
    n = seg.num_docs
    for qi, terms in enumerate(queries):
        for t, term in enumerate(terms):
            s, ln = fp.row_slice(fp.term_row(term))
            df = seg.doc_freq("body", term)
            starts[qi, t], lengths[qi, t] = s, ln
            if df:
                idf_boost[qi, t] = np.log(
                    1 + (n - df + 0.5) / (df + 0.5)) * (k1 + 1)
            max_len = max(max_len, ln)
    bucket = 128
    while bucket < max_len:
        bucket *= 2
    return starts, lengths, idf_boost, bucket


def run_both(ref_seg, seg, queries, t_pad):
    """score_and_mask in both packages → ((ref scores, ref mask), (port
    scores, port mask)) as numpy."""
    rp = ref_pack(ref_seg).fields["body"]
    fp = build_segment_pack(seg).fields["body"]
    starts, lengths, idf_boost, max_len = operands(fp, seg, queries, t_pad)
    st = seg.field_stats["body"]
    avgdl = st.sum_total_term_freq / st.doc_count
    cache = smallfloat.bm25_norm_cache(1.2, 0.75, avgdl)
    rs, rm = ref_bm25.score_and_mask(
        jnp.asarray(rp.flat_docs), jnp.asarray(rp.flat_tfs),
        jnp.asarray(rp.norms_u8), jnp.asarray(cache), jnp.asarray(starts),
        jnp.asarray(lengths), jnp.asarray(idf_boost), max_len=max_len,
        d_pad=rp.d_pad)
    ps, pm = bm25.score_and_mask(
        torch.as_tensor(fp.flat_docs), torch.as_tensor(fp.flat_tfs),
        torch.as_tensor(fp.norms_u8), torch.as_tensor(cache),
        torch.as_tensor(starts), torch.as_tensor(lengths),
        torch.as_tensor(idf_boost), max_len=max_len, d_pad=fp.d_pad)
    return (np.asarray(rs), np.asarray(rm)), (ps.numpy(), pm.numpy())


def assert_bits(got, want):
    assert got.shape == want.shape
    if got.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    else:
        np.testing.assert_array_equal(got, want)


QUERIES = {
    "one_term": [["w0"]],
    "three_terms": [["w0", "w1", "w5"]],
    "absent_term": [["w3", "nope", "w9"]],
    "batch": [["w0"], ["w3", "w7"]],
    "rare_terms": [["w40", "w41", "w42", "w43"]],
    "thirty_two_slots": [[f"w{i}" for i in range(32)]],
}


@pytest.mark.parametrize("n_docs", [17, 300])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_score_and_mask_matches_jax_bitwise(name, n_docs):
    ref_seg, seg = make_segments(7, n_docs)
    queries = QUERIES[name]
    t_pad = 1
    while t_pad < max(len(q) for q in queries):
        t_pad *= 2
    (rs, rm), (ps, pm) = run_both(ref_seg, seg, queries, t_pad)
    assert_bits(ps, rs)
    assert_bits(pm, rm)
    # the bitmask: bit t set exactly for the docs holding term t
    for qi, terms in enumerate(queries):
        m = pm[qi, : seg.num_docs]
        for t, term in enumerate(terms):
            expect = np.zeros(seg.num_docs, dtype=bool)
            entry = seg.postings["body"].get(term)
            if entry is not None:
                expect[entry[0]] = True
            np.testing.assert_array_equal(
                (m & bm25.slot_bit(t)) != 0, expect)


def test_score_and_mask_over_rebased_rows_is_the_same():
    """The planner copies only the rows a pass reads, starts rebased:
    lanes past a row's length are masked, so the result is the call's
    over the whole flat arrays, bit for bit."""
    _, seg = make_segments(11, 300)
    fp = build_segment_pack(seg).fields["body"]
    terms = ["w2", "w0", "w13"]
    starts, lengths, idf_boost, max_len = operands(fp, seg, [terms], 4)
    cache = torch.as_tensor(smallfloat.bm25_norm_cache(1.2, 0.75, 14.0))
    norms = torch.as_tensor(fp.norms_u8)
    full = bm25.score_and_mask(
        torch.as_tensor(fp.flat_docs), torch.as_tensor(fp.flat_tfs), norms,
        cache, torch.as_tensor(starts), torch.as_tensor(lengths),
        torch.as_tensor(idf_boost), max_len=max_len, d_pad=fp.d_pad)
    docs, tfs, rebased, base = [], [], np.zeros_like(starts), 0
    for t in range(len(terms)):
        s, ln = int(starts[0, t]), int(lengths[0, t])
        docs.append(fp.flat_docs[s:s + ln])
        tfs.append(fp.flat_tfs[s:s + ln])
        rebased[0, t] = base
        base += ln
    docs.append(np.full(1, fp.d_pad, dtype=np.int32))
    tfs.append(np.zeros(1, dtype=np.int32))
    part = bm25.score_and_mask(
        torch.as_tensor(np.concatenate(docs)),
        torch.as_tensor(np.concatenate(tfs)), norms, cache,
        torch.as_tensor(rebased), torch.as_tensor(lengths),
        torch.as_tensor(idf_boost), max_len=max_len, d_pad=fp.d_pad)
    assert_bits(part[0].numpy(), full[0].numpy())
    assert_bits(part[1].numpy(), full[1].numpy())


def test_slot_31_bit_is_the_int32_sign_bit():
    (rs, rm), (ps, pm) = run_both(*make_segments(3, 200),
                                  [[f"w{i}" for i in range(32)]], 32)
    assert (pm < 0).any()
    assert_bits(pm, rm)


@pytest.mark.parametrize("scores,k", [
    ([[1.0, 3.0, 3.0, 2.0]], 3),
    ([[2.0] * 300], 10),
    ([[float("-inf")] * 256], 5),
    ([[0.5, float("-inf"), 0.5, 7.0, 0.5]], 5),
])
def test_topk_ties_to_the_lower_doc_as_jax(scores, k):
    rv, ri = ref_bm25.topk(jnp.asarray(scores, dtype=jnp.float32), k=k)
    pv, pi = bm25.topk(torch.tensor(scores, dtype=torch.float32), k=k)
    assert_bits(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))


BOOL_CASES = {
    # term bits: t0=1, t1=2, t2=4
    "must_and_must_not": ([[1, 3, 6, 0, 7]], [[1, 2]], [4], [[0]], [0],
                          [False, True, False, False, False]),
    "min_should_match": ([[1, 2, 3]], [[0]], [0], [[1, 2]], [2],
                         [False, False, True]),
    "sign_bit": ([[-(2**31), 1, -(2**31) + 1]], [[-(2**31)]], [0], [[0]],
                 [0], [True, False, True]),
}


@pytest.mark.parametrize("name", sorted(BOOL_CASES))
def test_eval_bool_masks_matches_jax(name):
    tm, must, mnm, should, msm, expect = BOOL_CASES[name]
    args32 = [tm, must, mnm, should, msm]
    want = np.asarray(ref_bm25.eval_bool_masks(
        *[jnp.asarray(a, dtype=jnp.int32) for a in args32]))
    got = bm25.eval_bool_masks(
        *[torch.tensor(a, dtype=torch.int32) for a in args32]).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got[0]) == expect


def test_range_mask_i64_matches_jax():
    col = [5, 10, 15, MISSING_I64, -3, 2**40]
    lo, hi = [6, -(2**62)], [15, 2**62]
    want = np.asarray(ref_bm25.range_mask_i64(
        jnp.asarray(col, dtype=jnp.int64), jnp.asarray(lo, dtype=jnp.int64),
        jnp.asarray(hi, dtype=jnp.int64)))
    got = bm25.range_mask_i64(torch.tensor(col, dtype=torch.int64),
                              torch.tensor(lo), torch.tensor(hi)).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got[0]) == [False, True, True, False, False, False]


def test_range_mask_f64_matches_jax():
    col = [0.5, 1.25, np.nan, -7.0, 1e300, 3.0]
    lo, hi = [0.5, -np.inf], [3.0, np.inf]
    want = np.asarray(ref_bm25.range_mask_f64(
        jnp.asarray(col, dtype=jnp.float64),
        jnp.asarray(lo, dtype=jnp.float64),
        jnp.asarray(hi, dtype=jnp.float64)))
    got = bm25.range_mask_f64(torch.tensor(col, dtype=torch.float64),
                              torch.tensor(lo, dtype=torch.float64),
                              torch.tensor(hi, dtype=torch.float64)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[:, 2].any()


def test_mask_scores_matches_jax():
    rng = np.random.default_rng(5)
    scores = rng.random((2, 256)).astype(np.float32)
    match = rng.random((2, 256)) < 0.5
    live = rng.random(256) < 0.8
    want = np.asarray(ref_bm25.mask_scores(
        jnp.asarray(scores), jnp.asarray(match), jnp.asarray(live)))
    got = bm25.mask_scores(torch.as_tensor(scores), torch.as_tensor(match),
                           torch.as_tensor(live)).numpy()
    assert_bits(got, want)


def test_merge_with_tombstones():
    _, seg1 = make_segments(1, 30, "s1")
    _, seg2 = make_segments(2, 20, "s2")
    live1 = np.ones(30, dtype=bool)
    live1[[3, 7]] = False
    merged = merge_segments("m", [seg1, seg2], [live1, None])
    assert merged.num_docs == 48
    assert "s1-d3" not in merged.id_to_ord
    assert "s2-d3" in merged.id_to_ord
    assert merged.id_to_ord["s1-d0"] == 0
    assert merged.field_stats["body"].sum_total_term_freq > 0
    for term, (docs, _) in merged.postings["body"].items():
        assert (np.diff(docs) > 0).all(), term
    # positions survive the merge: a doc's term slots follow it
    assert merged.token_slots["body"][0] == seg1.token_slots["body"][0]
    assert merged.token_slots["body"][28] == seg2.token_slots["body"][0]


def test_pack_padding_matches_jax():
    ref_seg, seg = make_segments(9, 100, "s")
    pack, rpack = build_segment_pack(seg), ref_pack(ref_seg)
    fp, rfp = pack.fields["body"], rpack.fields["body"]
    assert fp.d_pad % 128 == 0 and fp.d_pad == rfp.d_pad
    for name in ("flat_docs", "flat_tfs", "row_start", "norms_u8"):
        np.testing.assert_array_equal(getattr(fp, name), getattr(rfp, name))
    assert fp.vocab == rfp.vocab
    total = int(fp.row_start[-1])
    assert (fp.flat_docs[total:] == fp.d_pad).all()
