"""ops/sparse.py of the port against the JAX package, bit for bit.

Port of the compressed-variant cases of tests/test_sparse_kernel.py
(TestSortedMergeTopk, TestPackedParity, TestTotals, TestCompressedPack
with its pruning-safety sweep, TestDeltaDocStream, TestHierarchicalTopK,
TestPlanSlots): the same numpy operands go through the reference's
sorted_merge_topk (variant "compressed", "pallas" in interpret mode, and
"compressed_exact") and the port's, and scores (as uint32), doc ids and
totals must be equal. On the CPU the port's "compressed"/"pallas" run the
plain torch version of the Hopper kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import sparse as jsp

from elasticsearch_tpu_torch.ops import merge_kernel
from elasticsearch_tpu_torch.ops import sparse as tsp

import torch_parity_cases as cases

torch.set_num_threads(1)


def run_ref(pos, extra, static, k, variant, with_totals=True):
    out = jsp.sorted_merge_topk(
        *[jnp.asarray(a) for a in pos], k=k, with_totals=with_totals,
        variant=variant, **static,
        **{n: jnp.asarray(a) for n, a in extra.items()})
    return [np.asarray(o) for o in out]


def run_port(pos, extra, static, k, variant, with_totals=True):
    return tsp.sorted_merge_topk(
        *cases.to_torch(pos), k=k, with_totals=with_totals,
        variant=variant, **static, **cases.to_torch(extra))


def assert_parity(flat_docs, flat_imp, rows, mins, d_pad, k, ext,
                  chunk_cap=4096, ref_variants=("compressed",),
                  exact=False, with_totals=True, delta=None):
    """The port's compressed core equals each reference variant, and
    (exact=True) the port's compressed_exact equals the reference's."""
    pos, extra, static = cases.kernel_args(flat_docs, flat_imp, rows, mins,
                                           d_pad, ext, chunk_cap=chunk_cap,
                                           delta=delta)
    got = run_port(pos, extra, static, k, "compressed", with_totals)
    for variant in ref_variants:
        want = run_ref(pos, extra, static, k, variant, with_totals)
        cases.assert_bitwise(got, want, variant)
    if exact:
        got_x = run_port(pos, extra, static, k, "compressed_exact",
                         with_totals)
        want_x = run_ref(pos, extra, static, k, "compressed_exact",
                         with_totals)
        cases.assert_bitwise(got_x, want_x, "compressed_exact")
        # the exact pipeline and the quantized one agree on every bit
        cases.assert_bitwise(got, got_x, "compressed vs compressed_exact")
    return got


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


class TestSortedMergeTopk:
    def test_or_query_matches_reference_and_oracle(self):
        rng = np.random.default_rng(101)
        d_pad = 512
        flat_docs, flat_imp, ext = cases.make_flat(rng, 6, d_pad, 200)
        weights = [1.7, 0.9, 2.3, 0.5, 1.1, 3.0]
        rows = [[(ext[t][0], ext[t][1], weights[t], t) for t in (0, 2, 4)],
                [(ext[t][0], ext[t][1], weights[t], t) for t in (1, 3)],
                [(ext[5][0], ext[5][1], weights[5], 5)]]
        mins = [1, 1, 1]
        vals, docs, _ = assert_parity(flat_docs, flat_imp, rows, mins,
                                      d_pad, 600, ext, exact=True)
        expected = brute_force(rows, flat_docs, flat_imp, d_pad, mins)
        for qi, exp in enumerate(expected):
            exp_sorted = sorted(exp, key=lambda t: (-t[1], t[0]))
            got = [(int(d), float(v)) for v, d in zip(vals[qi], docs[qi])
                   if v != float("-inf")]
            assert [d for d, _ in got] == [d for d, _ in exp_sorted]
            np.testing.assert_allclose([v for _, v in got],
                                       [v for _, v in exp_sorted],
                                       rtol=1e-5)

    @pytest.mark.parametrize("mins,chunk_cap", [([3], 4096), ([2], 16)])
    def test_and_msm_with_chunking(self, mins, chunk_cap):
        rng = np.random.default_rng(102 + chunk_cap)
        d_pad = 256
        flat_docs, flat_imp, ext = cases.make_flat(rng, 3, d_pad, 120)
        rows = [[(ext[t][0], ext[t][1], 1.0, t) for t in range(3)]]
        vals, docs, _ = assert_parity(flat_docs, flat_imp, rows, mins,
                                      d_pad, 256, ext, chunk_cap=chunk_cap,
                                      exact=True)
        expected = brute_force(rows, flat_docs, flat_imp, d_pad, mins)[0]
        got = {int(d) for v, d in zip(vals[0], docs[0])
               if v != float("-inf")}
        assert got == {d for d, _ in expected}

    def test_absent_term_zero_length_slot(self):
        rng = np.random.default_rng(103)
        d_pad = 128
        flat_docs, flat_imp, ext = cases.make_flat(rng, 2, d_pad, 60)
        rows = [[(ext[0][0], ext[0][1], 1.0, 0), (0, 0, 0.0, 1)]]
        vals, _, _ = assert_parity(flat_docs, flat_imp, rows, [2], d_pad,
                                   128, ext)
        assert (vals[0] == float("-inf")).all()

    def test_tie_break_earliest_doc_id(self):
        d_pad = 512
        docs = np.arange(7, 450, 7, dtype=np.int32)
        flat_docs = np.concatenate(
            [docs, np.full(4160, d_pad, dtype=np.int32)])
        flat_imp = np.concatenate(
            [np.full(docs.size, 0.25, dtype=np.float32),
             np.zeros(4160, dtype=np.float32)])
        rows = [[(0, docs.size, 2.0, 0)]]
        _, rd, _ = assert_parity(flat_docs, flat_imp, rows, [1], d_pad, 10,
                                 [(0, docs.size)],
                                 ref_variants=("compressed", "pallas"))
        np.testing.assert_array_equal(rd[0].numpy(), docs[:10])


class TestCompressedParity:
    """The random-corpus parity sweep (OR → msm → AND, tie-heavy,
    chunked) for the compressed variants."""

    @pytest.mark.parametrize("trial", range(4))
    def test_parity_random(self, trial):
        rng = np.random.default_rng(200 + trial)
        case = cases.make_case(rng, tie_heavy=(trial % 2 == 1))
        cap = 64 if trial % 3 == 0 else 4096
        assert_parity(*case, chunk_cap=cap, exact=trial in (2, 3),
                      ref_variants=(("compressed", "pallas") if trial == 1
                                    else ("compressed",)))

    def test_unknown_variant_and_doc_overflow_rejected(self):
        rng = np.random.default_rng(210)
        fd, fi, rows, mins, d_pad, k, ext = cases.make_case(rng)
        pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad,
                                               ext)
        with pytest.raises(ValueError, match="variant"):
            run_port(pos, extra, static, k, "bogus")
        static = dict(static, d_pad=tsp.PACKED_DOC_LIMIT)
        with pytest.raises(ValueError, match="d_pad"):
            run_port(pos, extra, static, k, "compressed")

    def test_packable_gates_match_reference(self):
        for d_pad, w in [(tsp.PACKED_DOC_LIMIT - 1, None),
                         (tsp.PACKED_DOC_LIMIT, None),
                         (1000, np.array([0.5, 2.0], np.float32)),
                         (1000, np.array([-1.0, 2.0])),
                         (1000, np.array([np.inf, 1.0])),
                         (1000, np.array([np.nan, 1.0])),
                         (1000, np.array([1e31, 1.0])),
                         (1000, np.array([1e-13, 1.0])),
                         (1000, np.array([0.0, 1.0]))]:
            assert tsp.packable(d_pad, w) == jsp.packable(d_pad, w)

    def test_code16_matches_reference(self):
        x = np.geomspace(1e-12, 1e30, 400, dtype=np.float32)
        want = np.asarray(jsp.impact_code16(jnp.asarray(x)))
        got = tsp.impact_code16(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
        dec = tsp.decode_code16(torch.from_numpy(got)).numpy()
        np.testing.assert_array_equal(
            dec.view(np.uint32),
            np.asarray(jsp.decode_code16(jnp.asarray(want))).view(np.uint32))

    def test_unpackable_weights_exact_variant(self):
        """compressed_exact serves weights packable() rejects (here a
        negative one) bit-identical to the reference."""
        rng = np.random.default_rng(211)
        d_pad = 300
        flat_docs, flat_imp, ext = cases.make_flat(rng, 3, d_pad, 150)
        rows = [[(ext[0][0], ext[0][1], 1.5, 0),
                 (ext[1][0], ext[1][1], -0.5, 1),
                 (ext[2][0], ext[2][1], 2.0, 2)]]
        pos, extra, static = cases.kernel_args(flat_docs, flat_imp, rows,
                                               [1], d_pad, ext)
        assert not tsp.packable(d_pad, pos[4])
        got = run_port(pos, extra, static, 40, "compressed_exact")
        want = run_ref(pos, extra, static, 40, "compressed_exact")
        cases.assert_bitwise(got, want)


class TestLargeRows:
    """Rows at the shapes the Hopper kernels split on: full 4096-lane
    slots at T = 16 and 32 (more keys than the row sort's shared-memory
    class, more candidates than the select's), and a tie-heavy row with
    more candidates than kc = 3k at k = 4096 and k = 10,000 (kernel k up
    to the service's 16,384 bucket). The plain version must equal the
    reference's compressed core bit for bit: the card holds the kernels
    to it (tests/test_torch_merge_kernel.py)."""

    @pytest.mark.parametrize("n_terms,t_slots", [(2, 16), (4, 32)])
    def test_full_slots(self, n_terms, t_slots):
        rng = np.random.default_rng(300 + n_terms)
        fd, fi, rows, mins, d_pad, ext = cases.make_full_slot_case(
            rng, n_terms)
        pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad,
                                               ext)
        assert pos[2].shape == (2, t_slots)
        assert (pos[3][0] == 4096).all()
        got = run_port(pos, extra, static, 1000, "compressed")
        cases.assert_bitwise(got, run_ref(pos, extra, static, 1000,
                                          "compressed"))
        assert int(got[2][0]) > merge_kernel.K_LIMIT

    @pytest.mark.parametrize("k,beyond_kc", [(4096, True), (10000, True),
                                             (16384, False)])
    def test_tie_heavy_candidates_beyond_kc(self, k, beyond_kc):
        rng = np.random.default_rng(310)
        fd, fi, rows, mins, d_pad, ext = cases.make_tie_heavy_full_case(rng)
        pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad,
                                               ext)
        got = run_port(pos, extra, static, k, "compressed")
        cases.assert_bitwise(got, run_ref(pos, extra, static, k,
                                          "compressed"))
        n_match = int(got[2][0])  # the OR row's matching docs
        assert (n_match > k + max(2 * k, 256)) == beyond_kc
        assert int(torch.isfinite(got[0][0]).sum()) == min(k, n_match)


class TestTotals:
    def test_totals_exceed_k(self):
        rng = np.random.default_rng(301)
        d_pad = 600
        sizes = [200, 200, 200]
        flat_docs = np.full(sum(sizes) + cases.SLACK, d_pad, dtype=np.int32)
        flat_imp = np.zeros(sum(sizes) + cases.SLACK, dtype=np.float32)
        ext, pos = [], 0
        for t, sz in enumerate(sizes):
            flat_docs[pos:pos + sz] = np.arange(3 * t, 3 * t + sz)
            flat_imp[pos:pos + sz] = rng.uniform(0.1, 1.0, size=sz)
            ext.append((pos, sz))
            pos += sz
        rows = [[(ext[t][0], ext[t][1], 1.0 + 0.3 * t, t)
                 for t in range(3)],
                [(ext[t][0], ext[t][1], 1.0, t) for t in range(3)]]
        mins = [1, 2]
        expected = brute_force(rows, flat_docs, flat_imp, d_pad, mins)
        _, _, totals = assert_parity(flat_docs, flat_imp, rows, mins,
                                     d_pad, 5, ext)
        assert totals.tolist() == [len(e) for e in expected]


@pytest.mark.compressed_pack
class TestCompressedPack:
    def test_rank_stream_roundtrip_matches_reference(self):
        rng = np.random.default_rng(401)
        d_pad = 2000
        flat_docs, flat_imp, ext = cases.make_flat(rng, 5, d_pad, 600)
        flat_imp = (np.ceil(flat_imp * 8.0) / 8.0).astype(np.float32)
        flat_imp[ext[1][0]: ext[1][0] + ext[1][1]: 5] = 0.0
        rs = cases.row_starts_of(ext)
        got = tsp.compress_flat(flat_docs, flat_imp, rs, d_pad)
        want = jsp.compress_flat(flat_docs, flat_imp, rs, d_pad)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)

    def test_compress_gates_match_reference(self):
        rng = np.random.default_rng(402)
        flat_docs, flat_imp, ext = cases.make_flat(rng, 2, 500, 100)
        rs = cases.row_starts_of(ext)
        for d_pad, bad_at, bad in [(500, None, None),
                                   (tsp.PACKED_DOC_LIMIT, None, None),
                                   (500, 3, np.inf), (500, 3, -0.25),
                                   (500, 3, 1e-41)]:
            imp = flat_imp.copy()
            if bad_at is not None:
                imp[bad_at] = bad
            assert tsp.compress_reason(flat_docs, imp, rs, d_pad) == \
                jsp.compress_reason(flat_docs, imp, rs, d_pad)

    @pytest.mark.parametrize("tsel,ws,k", [([0], [1.0], 10),
                                           ([0, 1], [5.0, 0.2], 10),
                                           ([0, 1, 2], [8.0, 0.1, 0.1], 16)])
    def test_skip_engages_and_preserves_topk(self, tsel, ws, k):
        rng = np.random.default_rng(403)
        d_pad = 20000
        flat_docs, flat_imp, ext = cases.make_heavy_flat(
            rng, d_pad, [9000, 7000, 5000])
        rows = [[(ext[t][0], ext[t][1], w, t) for t, w in zip(tsel, ws)]]
        assert_parity(flat_docs, flat_imp, rows, [1], d_pad, k, ext,
                      exact=len(tsel) == 1,
                      ref_variants=(("compressed", "pallas") if len(tsel) == 1
                                    else ("compressed",)))

    @pytest.mark.parametrize("trial", range(4))
    def test_pruning_safety_sweep(self, trial):
        """Skewed / tie-heavy / chunked corpora × OR/msm/AND × k: the
        port equals the reference bit for bit in every trial."""
        rng = np.random.default_rng(500 + trial)
        d_pad = int(rng.integers(8000, 40000))
        n_terms = 1 if trial % 3 == 0 else int(rng.integers(1, 5))
        dfs = [int(rng.integers(2000, min(12000, d_pad - 1)))
               for _ in range(n_terms)]
        flat_docs, flat_imp, ext = cases.make_heavy_flat(
            rng, d_pad, dfs, skew=1.0 if trial % 3 == 1 else 3.0)
        if trial % 4 == 0:  # tie-heavy: quantized impacts
            flat_imp = np.maximum(np.round(flat_imp * 8) / 8,
                                  0.125).astype(np.float32)
            flat_imp[cases.row_starts_of(ext)[-1]:] = 0.0
        ws = [float(rng.uniform(0.1, 6.0)) for _ in range(n_terms)]
        rows = [[(ext[t][0], ext[t][1], ws[t], t) for t in range(n_terms)]]
        mc = int(rng.integers(1, n_terms + 1))
        k = (int(rng.integers(5, 32)) if n_terms == 1
             else int(rng.integers(1, 100)))
        cap = 1024 if trial % 5 == 0 else 4096
        assert_parity(flat_docs, flat_imp, rows, [mc], d_pad, k, ext,
                      chunk_cap=cap)

    def test_compressed_requires_operands(self):
        rng = np.random.default_rng(404)
        fd, fi, rows, mins, d_pad, k, ext = cases.make_case(rng)
        pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad,
                                               ext)
        extra.pop("res_vals")
        with pytest.raises(ValueError, match="compressed"):
            run_port(pos, extra, static, k, "compressed")

    def test_delta_requires_cursor_operands(self):
        rng = np.random.default_rng(405)
        flat_docs, flat_imp, ext = cases.make_flat(rng, 2, 250, 80)
        rows = [[(ext[t][0], ext[t][1], 1.0, t) for t in range(2)]]
        pos, extra, static = cases.kernel_args(flat_docs, flat_imp, rows,
                                               [1], 250, ext)
        assert "doc_bases" in extra
        extra.pop("dbs_starts")
        with pytest.raises(ValueError, match="dbs_starts"):
            run_port(pos, extra, static, 5, "compressed")

    def test_totals_served_through_skip_path(self):
        rng = np.random.default_rng(406)
        d_pad = 20000
        flat_docs, flat_imp, ext = cases.make_heavy_flat(rng, d_pad,
                                                         [9000, 7000])
        rows = [[(ext[0][0], ext[0][1], 1.0, 0)]]
        _, _, totals = assert_parity(flat_docs, flat_imp, rows, [1], d_pad,
                                     10, ext)
        exp = brute_force(rows, flat_docs, flat_imp, d_pad, [1])[0]
        assert totals.tolist() == [len(exp)]


class TestDeltaDocStream:
    def test_encode_matches_reference(self):
        rng = np.random.default_rng(601)
        flat_docs, _, ext = cases.make_flat(rng, 4, 256, 200)
        rs = cases.row_starts_of(ext)
        assert tsp.delta_doc_reason(flat_docs, rs) is None
        nbd = (flat_docs.size + 127) // 128 + 2
        for g, w in zip(tsp.delta_encode_docs(flat_docs, rs, nbd),
                        jsp.delta_encode_docs(flat_docs, rs, nbd)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)

    def test_gates_match_reference(self):
        d_pad = 4096
        wide = np.concatenate([np.arange(0, d_pad, 4, dtype=np.int32),
                               np.full(4352, d_pad, dtype=np.int32)])
        tight = np.concatenate([np.arange(100, 180, dtype=np.int32),
                                np.full(4352, d_pad, dtype=np.int32)])
        for docs, n in ((wide, d_pad // 4), (tight, 80)):
            rs = np.array([0, n], dtype=np.int64)
            assert tsp.delta_doc_reason(docs, rs) == \
                jsp.delta_doc_reason(docs, rs)
        with pytest.raises(ValueError, match="delta"):
            tsp.delta_encode_docs(wide, np.array([0, d_pad // 4]), 1024)

    @pytest.mark.compressed_pack
    @pytest.mark.parametrize("mc,cap", [(1, 4096), (3, 64)])
    def test_delta_parity(self, mc, cap):
        rng = np.random.default_rng(602)
        d_pad = 256
        flat_docs, flat_imp, ext = cases.make_flat(rng, 5, d_pad, 200)
        ws = [1.3, 0.7, 2.2, 0.4, 1.9]
        rows = [[(ext[t][0], ext[t][1], ws[t], t) for t in range(5)]]
        for delta in (True, False):
            assert_parity(flat_docs, flat_imp, rows, [mc], d_pad, 40, ext,
                          chunk_cap=cap, delta=delta, exact=delta and mc > 1)


class TestHierarchicalTopK:
    def test_matches_reference_with_ties(self):
        rng = np.random.default_rng(701)
        score = rng.integers(0, 50, size=(3, 8192)).astype(np.float32)
        for k in (1, 32, 100):
            fv, fp = jax.lax.top_k(jnp.asarray(score), k)
            hv, hp = tsp.hierarchical_top_k(torch.from_numpy(score), k)
            np.testing.assert_array_equal(hv.numpy(), np.asarray(fv))
            np.testing.assert_array_equal(hp.numpy(), np.asarray(fp))

    @pytest.mark.parametrize("width", [7, 4095, 4097])
    def test_widths(self, width):
        rng = np.random.default_rng(702 + width)
        score = rng.normal(size=(2, width)).astype(np.float32)
        hv, hp = tsp.hierarchical_top_k(torch.from_numpy(score), 5)
        fv, fp = jax.lax.top_k(jnp.asarray(score), 5)
        np.testing.assert_array_equal(hv.numpy(), np.asarray(fv))
        np.testing.assert_array_equal(hp.numpy(), np.asarray(fp))

    def test_segmented_run_sum_matches_reference(self):
        rng = np.random.default_rng(703)
        keys = np.sort(rng.integers(0, 40, size=(4, 300)), axis=1)
        vals = rng.uniform(0, 3, size=(4, 300)).astype(np.float32)
        for window in (1, 3, 8, 32):
            want = np.asarray(jsp.segmented_run_sum(
                jnp.asarray(keys.astype(np.int32)), jnp.asarray(vals),
                window))
            got = tsp.segmented_run_sum(torch.from_numpy(keys),
                                        torch.from_numpy(vals),
                                        window).numpy()
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))


class TestPlanSlots:
    @pytest.mark.parametrize("rows,mins,cap,lane", [
        ([[(0, 3000, 1.0, 0)]], [1], 3000, 128),
        ([[(0, 100, 1.0, 0), (100, 50, 1.0, 1)]], [1], 16, 8),
        ([[(5, 700, 0.5, 0), (0, 0, 0.0, 1)], [(900, 20, 2.0, 0)]],
         [2, 1], 256, 8),
    ])
    def test_plan_matches_reference(self, rows, mins, cap, lane):
        got = tsp.plan_slots(rows, mins, chunk_cap=cap, lane=lane)
        want = jsp.plan_slots(rows, mins, chunk_cap=cap, lane=lane)
        for name in ("starts", "lengths", "weights", "min_count"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        assert (got.max_len, got.t_slots, got.window) == \
            (want.max_len, want.t_slots, want.window)
        assert got.max_len <= cap


def test_cpu_wrapper_runs_plain_version_without_launching():
    rng = np.random.default_rng(801)
    fd, fi, rows, mins, d_pad, k, ext = cases.make_case(rng)
    pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad, ext)
    before = dict(merge_kernel.LAUNCHES)
    got = merge_kernel.fused_merge_topk(*cases.to_torch(pos), k=k,
                                        with_totals=True, **static,
                                        **cases.to_torch(extra))
    want = merge_kernel.fused_merge_topk_plain(
        *cases.to_torch(pos), k=k, with_totals=True, **static,
        **cases.to_torch(extra))
    cases.assert_bitwise(got, want)
    assert merge_kernel.LAUNCHES == before
