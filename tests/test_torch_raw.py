"""The raw pack's exact variants ("ref", "packed") of the port against
the JAX package's, bit for bit.

Port copies of tests/test_sparse_kernel.py's TestSortedMergeTopk,
TestPackedParity and TestTotals for the two variants that read a raw
pack (int32 docs, f32 impacts): the same numpy operands go through the
reference's sorted_merge_topk and the port's (on the CPU the plain
versions, merge_kernel.raw_merge_topk_plain), and scores (as uint32),
doc ids and totals must be equal; the oracle cases also hold both
against a brute-force numpy score.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import sparse as jsp

from elasticsearch_tpu_torch.ops import sparse as tsp

import torch_parity_cases as cases

torch.set_num_threads(1)
RAW_VARIANTS = ("ref", "packed")


def plan_args(flat_docs, flat_imp, rows, mins, d_pad, chunk_cap=4096):
    plan = tsp.plan_slots(rows, mins, chunk_cap=chunk_cap, lane=8)
    pos = [flat_docs, flat_imp, plan.starts, plan.lengths, plan.weights,
           plan.min_count]
    static = dict(max_len=plan.max_len, d_pad=d_pad, t_window=plan.window,
                  with_counts=any(m > 1 for m in mins))
    return pos, static


def run_both(flat_docs, flat_imp, rows, mins, d_pad, k, variant,
             chunk_cap=4096):
    """(port, reference) outputs of one raw-variant launch."""
    pos, static = plan_args(flat_docs, flat_imp, rows, mins, d_pad,
                            chunk_cap)
    want = jsp.sorted_merge_topk(*[jnp.asarray(a) for a in pos], k=k,
                                 with_totals=True, variant=variant,
                                 **static)
    got = tsp.sorted_merge_topk(*cases.to_torch(pos), k=k,
                                with_totals=True, variant=variant, **static)
    cases.assert_bitwise(got, [np.asarray(w) for w in want], variant)
    return [g.numpy() for g in got]


def brute_force(rows, flat_docs, flat_impact, d_pad, min_count):
    out = []
    for row, mc in zip(rows, min_count):
        score = np.zeros(d_pad, dtype=np.float64)
        cnt = np.zeros(d_pad, dtype=np.int64)
        for (s, ln, w, _tid) in row:
            d = flat_docs[s:s + ln]
            score[d] += w * flat_impact[s:s + ln]
            cnt[d] += 1
        ok = (score > 0) & (cnt >= mc)
        out.append([(int(d), float(score[d])) for d in np.nonzero(ok)[0]])
    return out


@pytest.mark.parametrize("variant", RAW_VARIANTS)
class TestSortedMergeTopk:
    def test_or_query_matches_oracle(self, variant):
        rng = np.random.default_rng(41)
        d_pad = 512
        flat_docs, flat_imp, ext = cases.make_flat(rng, 6, d_pad, 200)
        weights = [1.7, 0.9, 2.3, 0.5, 1.1, 3.0]
        rows = [[(ext[t][0], ext[t][1], weights[t], t) for t in (0, 2, 4)],
                [(ext[t][0], ext[t][1], weights[t], t) for t in (1, 3)],
                [(ext[5][0], ext[5][1], weights[5], 5)]]
        vals, docs, _ = run_both(flat_docs, flat_imp, rows, [1, 1, 1],
                                 d_pad, 600, variant)
        expected = brute_force(rows, flat_docs, flat_imp, d_pad, [1, 1, 1])
        for qi, exp in enumerate(expected):
            exp_sorted = sorted(exp, key=lambda t: (-t[1], t[0]))
            got = [(int(d), float(v)) for v, d in zip(vals[qi], docs[qi])
                   if v != float("-inf")]
            assert [d for d, _ in got] == [d for d, _ in exp_sorted]
            np.testing.assert_allclose([v for _, v in got],
                                       [v for _, v in exp_sorted],
                                       rtol=1e-5)

    def test_chunking_preserves_scores(self, variant):
        rng = np.random.default_rng(42)
        d_pad = 256
        flat_docs, flat_imp, ext = cases.make_flat(rng, 4, d_pad, 180)
        rows = [[(ext[t][0], ext[t][1], 1.0 + t, t) for t in range(4)]]
        v1, d1, _ = run_both(flat_docs, flat_imp, rows, [1], d_pad, 300,
                             variant)
        v2, d2, _ = run_both(flat_docs, flat_imp, rows, [1], d_pad, 300,
                             variant, chunk_cap=16)
        m1, m2 = v1[0] != float("-inf"), v2[0] != float("-inf")
        assert m1.sum() == m2.sum()
        np.testing.assert_array_equal(d1[0][m1], d2[0][m2])

    @pytest.mark.parametrize("mins,cap", [([3], 4096), ([2], 16)],
                             ids=["and", "msm_chunked"])
    def test_min_count_semantics(self, variant, mins, cap):
        rng = np.random.default_rng(43)
        d_pad = 256
        flat_docs, flat_imp, ext = cases.make_flat(rng, 3, d_pad, 120)
        rows = [[(ext[t][0], ext[t][1], 1.0, t) for t in range(3)]]
        vals, docs, totals = run_both(flat_docs, flat_imp, rows, mins,
                                      d_pad, 256, variant, chunk_cap=cap)
        expected = brute_force(rows, flat_docs, flat_imp, d_pad, mins)[0]
        got = {int(d) for v, d in zip(vals[0], docs[0])
               if v != float("-inf")}
        assert got == {d for d, _ in expected}
        assert int(totals[0]) == len(expected)

    def test_absent_term_zero_length_slot(self, variant):
        rng = np.random.default_rng(44)
        d_pad = 128
        flat_docs, flat_imp, ext = cases.make_flat(rng, 2, d_pad, 60)
        rows = [[(ext[0][0], ext[0][1], 1.0, 0), (0, 0, 0.0, 1)]]
        vals, _, _ = run_both(flat_docs, flat_imp, rows, [2], d_pad, 128,
                              variant)
        assert (vals[0] == float("-inf")).all()
        run_both(flat_docs, flat_imp, rows, [1], d_pad, 128, variant)

    def test_tie_break_smaller_doc_first(self, variant):
        d_pad = 64
        flat_docs = np.array([5, 9] + [d_pad] * 32, dtype=np.int32)
        flat_imp = np.array([0.5, 0.5] + [0.0] * 32, dtype=np.float32)
        _, docs, _ = run_both(flat_docs, flat_imp, [[(0, 2, 1.0, 0)]], [1],
                              d_pad, 2, variant)
        assert docs[0].tolist() == [5, 9]


class TestPackedParity:
    @pytest.mark.parametrize("trial", range(6))
    def test_parity_random(self, trial):
        rng = np.random.default_rng(300 + trial)
        fd, fi, rows, mins, d_pad, k, _ = cases.make_case(
            rng, tie_heavy=trial % 2 == 1)
        cap = 64 if trial % 3 == 0 else 4096
        ref = run_both(fd, fi, rows, mins, d_pad, k, "ref", chunk_cap=cap)
        packed = run_both(fd, fi, rows, mins, d_pad, k, "packed",
                          chunk_cap=cap)
        cases.assert_bitwise(packed, ref, "packed vs ref")

    def test_tie_break_earliest_doc_id(self):
        d_pad = 512
        docs = np.arange(7, 450, 7, dtype=np.int32)
        flat_docs = np.concatenate([docs, np.full(4160, d_pad, np.int32)])
        flat_imp = np.concatenate([np.full(docs.size, 0.25, np.float32),
                                   np.zeros(4160, np.float32)])
        for variant in RAW_VARIANTS:
            _, got, _ = run_both(flat_docs, flat_imp,
                                 [[(0, docs.size, 2.0, 0)]], [1], d_pad, 10,
                                 variant)
            np.testing.assert_array_equal(got[0], docs[:10])

    def test_packed_rejects_doc_overflow_ref_serves_it(self):
        rng = np.random.default_rng(45)
        d_pad = tsp.PACKED_DOC_LIMIT
        flat_docs, flat_imp, ext = cases.make_flat(rng, 2, d_pad, 50)
        rows = [[(ext[t][0], ext[t][1], 1.0, t) for t in range(2)]]
        pos, static = plan_args(flat_docs, flat_imp, rows, [1], d_pad)
        with pytest.raises(ValueError, match="packed"):
            tsp.sorted_merge_topk(*cases.to_torch(pos), k=10,
                                  variant="packed", **static)
        # a raw pack past the 16-bit doc range: "ref" serves it
        run_both(flat_docs, flat_imp, rows, [1], d_pad, 10, "ref")

    def test_large_doc_ids_past_the_compressed_limit(self):
        """A raw pack of d_pad ≈ 500,000 (one segment of MS MARCO passage
        width at 16 shards): doc ids need 19 bits."""
        rng = np.random.default_rng(46)
        d_pad = 500_096
        flat_docs, flat_imp, ext = cases.make_flat(rng, 4, d_pad, 3000)
        rows = [[(ext[t][0], ext[t][1], 0.7 + t, t) for t in range(4)],
                [(ext[t][0], ext[t][1], 1.0, t) for t in (1, 3)]]
        run_both(flat_docs, flat_imp, rows, [1, 2], d_pad, 100, "ref")


def test_totals_exceed_k_both_variants():
    rng = np.random.default_rng(47)
    d_pad = 600
    sizes = [200, 200, 200]
    flat_docs = np.full(sum(sizes) + 64, d_pad, dtype=np.int32)
    flat_imp = np.zeros(sum(sizes) + 64, dtype=np.float32)
    ext, pos = [], 0
    for t, sz in enumerate(sizes):
        flat_docs[pos:pos + sz] = np.arange(3 * t, 3 * t + sz,
                                            dtype=np.int32)
        flat_imp[pos:pos + sz] = rng.uniform(0.1, 1.0, size=sz)
        ext.append((pos, sz))
        pos += sz
    rows = [[(ext[t][0], ext[t][1], 1.0 + 0.3 * t, t) for t in range(3)],
            [(ext[t][0], ext[t][1], 1.0, t) for t in range(3)]]
    mins = [1, 2]
    expected = brute_force(rows, flat_docs, flat_imp, d_pad, mins)
    for variant in RAW_VARIANTS:
        _, _, totals = run_both(flat_docs, flat_imp, rows, mins, d_pad, 5,
                                variant)
        assert totals.tolist() == [len(e) for e in expected]
