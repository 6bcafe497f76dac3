"""The CUDA merge kernels' source, run on the CPU through the host
emulator (elasticsearch_tpu_torch/tools/cuda_emu: g++, one thread per
CUDA thread), against the plain torch version: scores as uint32, doc ids
and totals exactly. This holds the kernels' logic (indexing, barriers'
placement, the order of the adds, every size class of the row sort and
the select kernel) where there is no card; races, launch limits and
speed show only on the card (tests/test_torch_merge_kernel.py)."""

import shutil

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import merge_kernel, sparse

import torch_parity_cases as cases

OPTIONAL = ("flat_rank", "res_starts", "res_lens", "res_vals", "block_max",
            "blk_starts", "slot_terms", "doc_bases", "dbs_starts",
            "dlo_starts")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    from elasticsearch_tpu_torch.tools import cuda_emu
    with cuda_emu.emulated(tmp_path_factory.mktemp("cuda_emu")):
        yield


def run_pair(pos, extra, static, k, with_totals=True):
    """(emulated kernels, plain version, the kernels' stats) on CPU
    operands."""
    tpos = cases.to_torch(pos)
    kw = dict(static, k=k, with_totals=with_totals,
              **cases.to_torch(extra))
    full = dict(kw)
    for name in OPTIONAL:
        full.setdefault(name, None)
    stats = {}
    got = merge_kernel._launch(*tpos, stats=stats, events=None, **full)
    want = merge_kernel.fused_merge_topk_plain(*tpos, **kw)
    return got, want, stats


@pytest.mark.parametrize("tie_heavy", [False, True])
def test_random_rows_match_plain(emulated, tie_heavy):
    rng = np.random.default_rng(41 + int(tie_heavy))
    for chunk_cap in (64, 4096):
        fd, fi, rows, mins, d_pad, k, ext = cases.make_case(
            rng, tie_heavy=tie_heavy)
        pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad,
                                               ext, chunk_cap=chunk_cap)
        for with_totals in (True, False):
            got, want, _ = run_pair(pos, extra, static, k, with_totals)
            cases.assert_bitwise(got, want, f"k={k} mins={mins}")


def test_delta_doc_stream_matches_plain(emulated):
    rng = np.random.default_rng(8)
    d_pad = 250
    fd, fi, ext = cases.make_flat(rng, 5, d_pad, 200)
    rows = [[(ext[t][0], ext[t][1], 1.0 + t, t) for t in range(5)],
            [(ext[t][0], ext[t][1], 0.5, t) for t in (1, 3)]]
    pos, extra, static = cases.kernel_args(fd, fi, rows, [1, 2], d_pad,
                                           ext, chunk_cap=64)
    assert "doc_bases" in extra
    for k in (5, 300):
        got, want, _ = run_pair(pos, extra, static, k)
        cases.assert_bitwise(got, want, f"k={k}")


def test_every_size_class_matches_plain(emulated):
    """One short row (shared-memory sort and selection, staged rescore,
    trimmed finalists) and one of 18,200 keys (device-memory sort and
    selection, rescore restaged by slot group; a 300-lane slot that a
    warp of the slot decode selects in, longer ones a block each), with
    the block-max skip on; at k = 4000 the short row needs no selection
    and keeps all."""
    rng = np.random.default_rng(7)
    d_pad = 20000
    fd, fi, ext = cases.make_heavy_flat(rng, d_pad, [900, 9000, 8000, 300],
                                        skew=1.0)
    rows = [[(ext[0][0], ext[0][1], 1.0, 0)],
            [(ext[t][0], ext[t][1], 1.0 + t, t) for t in range(4)]]
    pos, extra, static = cases.kernel_args(fd, fi, rows, [1, 1], d_pad,
                                           ext)
    got, want, stats = run_pair(pos, extra, static, 40)
    cases.assert_bitwise(got, want)
    classes = stats["classes"]
    assert all(classes[c] > 0 for c in merge_kernel.SIZE_CLASSES
               if c not in ("select.none", "final.all")), classes
    assert_run_sum_matches_reference(stats, static, [1, 1])
    assert_slot_decode_matches_plain(pos, extra, static, 40, stats)
    got, want, stats = run_pair(pos, extra, static, 4000)
    cases.assert_bitwise(got, want)
    classes = stats["classes"]
    assert classes["select.none"] == 1 and classes["final.all"] == 1


def shared_doc_flat(rng, n_terms, df, d_pad):
    """n_terms postings over one doc set: every doc's run holds n_terms
    lanes, so runs sit at multiples of n_terms in the sorted keys."""
    docs = np.sort(rng.choice(d_pad, size=df, replace=False))
    fd = np.concatenate([docs] * n_terms + [np.full(cases.SLACK, d_pad)])
    fi = np.concatenate(
        [rng.uniform(0.1, 1.0, size=df) for _ in range(n_terms)]
        + [np.zeros(cases.SLACK)])
    ext = [(t * df, df) for t in range(n_terms)]
    return fd.astype(np.int32), fi.astype(np.float32), ext


def sorted_row_keys(stats, name, row):
    """Row `row`'s row_pack output of key set `name`, sorted."""
    si = stats["sort_input"]
    keys, n = si[name], si["n_" + name]
    if keys is None:
        return None
    start = int(si["row_off"][row])
    got = keys[start:start + int(n[row])].numpy().view(np.uint32)
    return np.sort(got)


def straddles(sorted_keys, shift):
    """A run (equal key >> shift) crosses a run_sum tile boundary."""
    tile = merge_kernel.tile_lanes()
    return any(sorted_keys[b - 1] >> shift == sorted_keys[b] >> shift
               for b in range(tile, len(sorted_keys), tile))


def run_ends(sorted_keys, shift, values, t_window):
    """The plain segmented_run_sum of `values` over the runs of equal
    key >> shift, at each run's last lane → (run-end mask, sums, counts)."""
    sk = torch.from_numpy(sorted_keys.astype(np.int64) >> shift)[None]
    total = sparse.segmented_run_sum(sk, values[None], t_window)[0]
    cnt = sparse.segmented_run_sum(sk, torch.ones_like(values)[None],
                                   t_window)[0]
    doc = sorted_keys >> shift
    end = np.append(doc[:-1] != doc[1:], True) if len(doc) else \
        np.zeros(0, bool)
    return end, total.numpy(), cnt.numpy()


def assert_run_sum_matches_reference(stats, static, mins):
    """run_sum's output per row against the plain segmented_run_sum over
    the row's sorted keys: the candidates (quantized total as uint32,
    doc, clause count) in key order, and the totals from the count keys
    (from the candidates when there are none)."""
    out, with_counts = stats["run_sum_output"], static["with_counts"]
    t_window = static["t_window"]
    row_off = stats["sort_input"]["row_off"].numpy()
    for row, mc in enumerate(mins):
        keys = sorted_row_keys(stats, "keys", row).astype(np.int64)
        end, total, cnt = run_ends(
            keys, 16, sparse.decode_code16(torch.from_numpy(keys & 0xFFFF)),
            t_window)
        ok = end & (total > 0) & ((not with_counts) | (cnt >= mc))
        start, n = int(row_off[row]), int(out["n_cand"][row])
        assert n == int(ok.sum()), (row, n, int(ok.sum()))
        np.testing.assert_array_equal(
            out["score"][start:start + n].numpy().view(np.uint32),
            total[ok].view(np.uint32))
        np.testing.assert_array_equal(out["doc"][start:start + n].numpy(),
                                      (keys >> 16)[ok])
        np.testing.assert_array_equal(out["count"][start:start + n].numpy(),
                                      cnt[ok].astype(np.int32))
        ckeys = sorted_row_keys(stats, "count_keys", row)
        hits = n
        if ckeys is not None:
            ckeys = ckeys.astype(np.int64)
            cend, cpos, ccnt = run_ends(
                ckeys, 1, torch.from_numpy((ckeys & 1).astype(np.float32)),
                t_window)
            hits = int((cend & (cpos > 0)
                        & ((not with_counts) | (ccnt >= mc))).sum())
        assert int(out["totals"][row]) == hits, (row, hits)


def test_run_across_a_tile_boundary_matches_plain(emulated):
    """One row of 3 x 1000 lanes over one doc set: row_pack splits it over
    two blocks, run_sum loops over two tiles, and the run at keys 2046-
    2048 crosses the boundary (the halo holds its head). k = 1100 runs
    with the skip off (the keys straddle), k = 10 with it on (the count
    keys straddle)."""
    rng = np.random.default_rng(17)
    d_pad = 5000
    fd, fi, ext = shared_doc_flat(rng, 3, 1000, d_pad)
    rows = [[(ext[t][0], ext[t][1], 0.5 + t, t) for t in range(3)]]
    pos, extra, static = cases.kernel_args(fd, fi, rows, [1], d_pad, ext)
    for k, name, shift in ((1100, "keys", 16), (10, "count_keys", 1)):
        for with_totals in (True, False):
            got, want, stats = run_pair(pos, extra, static, k, with_totals)
            cases.assert_bitwise(got, want, f"k={k}")
            assert stats["classes"]["row_pack.split"] == 1, stats
            assert stats["classes"]["run_sum.tiled"] == 1, stats
            assert_run_sum_matches_reference(stats, static, [1])
            if with_totals:
                keys = sorted_row_keys(stats, name, 0)
                assert len(keys) == 3000 and straddles(keys, shift)


def test_look_back_over_more_than_32_tiles_matches_plain(emulated):
    """One row of 3 x 23,000 lanes: 34 tiles, so run_sum's last tiles look
    back over their row's earlier tiles in two rounds of 32."""
    rng = np.random.default_rng(71)
    d_pad = 30000
    fd, fi, ext = shared_doc_flat(rng, 3, 23000, d_pad)
    rows = [[(ext[t][0], ext[t][1], 0.5 + t, t) for t in range(3)]]
    pos, extra, static = cases.kernel_args(fd, fi, rows, [1], d_pad, ext)
    assert -(-69000 // merge_kernel.tile_lanes()) > 33
    for k, with_totals in ((10, True), (5000, False)):
        got, want, stats = run_pair(pos, extra, static, k, with_totals)
        cases.assert_bitwise(got, want, f"k={k}")
        assert_run_sum_matches_reference(stats, static, [1])
        assert stats["classes"]["run_sum.tiled"] == 1


def new_class_case(rng, kind):
    """Operands of one of the redesigned kernels' edge cases."""
    if kind == "empty_rows_and_slots":
        # a row of zero lanes, and empty slots between full ones
        d_pad = 3000
        fd, fi, ext = cases.make_flat(rng, 4, d_pad, 1500)
        end = ext[-1][0] + ext[-1][1]
        rows = [[(ext[0][0], ext[0][1], 1.2, 0), (end, 0, 0.7, 1),
                 (ext[2][0], ext[2][1], 2.0, 2), (end, 0, 0.3, 3),
                 (ext[3][0], ext[3][1], 0.9, 3)],
                [(end, 0, 1.0, 1)],
                [(ext[1][0], ext[1][1], 1.5, 1), (end, 0, 1.0, 2)]]
        return fd, fi, rows, [1, 1, 2], d_pad, ext, {}
    if kind == "msm":
        d_pad = 4000
        fd, fi, ext = cases.make_heavy_flat(rng, d_pad, [2500, 1800, 900],
                                            skew=1.5)
        rows = [[(ext[t][0], ext[t][1], 1.0 + t, t) for t in range(3)],
                [(ext[t][0], ext[t][1], 0.8, t) for t in range(3)],
                [(ext[t][0], ext[t][1], 2.0, t) for t in (0, 2)]]
        return fd, fi, rows, [2, 3, 1], d_pad, ext, {}
    if kind == "delta_split":
        # every 128-lane block spans < 256 ids: the u8 delta stream; 24
        # terms of ~125 docs make a row of two row_pack tiles
        d_pad = 250
        fd, fi, ext = cases.make_flat(rng, 24, d_pad, 249)
        rows = [[(ext[t][0], ext[t][1], 0.5 + 0.1 * t, t)
                 for t in range(24)],
                [(ext[t][0], ext[t][1], 1.0, t) for t in (2, 5)]]
        return fd, fi, rows, [1, 2], d_pad, ext, dict(chunk_cap=64)
    if kind == "wide_weights":
        # 5 terms over one doc set, one weighted 2**24 above the others:
        # a run's f32 sum rounds differently under another grouping
        d_pad = 2000
        fd, fi, ext = shared_doc_flat(rng, 5, 500, d_pad)
        rows = [[(ext[t][0], ext[t][1], 16777216.0 if t == 2 else 0.7, t)
                 for t in range(5)],
                [(ext[t][0], ext[t][1], 1.0 + 3e6 * t, t) for t in range(4)]]
        return fd, fi, rows, [1, 4], d_pad, ext, {}
    # many short slots: 40 terms of 1-20 docs in 8-lane chunks (T >= 64,
    # a term's chunks share its bound), a window of 40 terms
    d_pad = 600
    fd, fi, ext = cases.make_flat(rng, 40, d_pad, 21)
    rows = [[(ext[t][0], ext[t][1], 0.2 + 0.05 * t, t) for t in range(40)],
            [(ext[t][0], ext[t][1], 1.0, t) for t in range(0, 40, 3)]]
    return fd, fi, rows, [1, 3], d_pad, ext, dict(chunk_cap=8)


EDGE_CASES = ["empty_rows_and_slots", "msm", "delta_split",
              "many_short_slots", "wide_weights"]


@pytest.mark.parametrize("kind", EDGE_CASES)
def test_row_pack_and_run_sum_edges_match_plain(emulated, kind):
    """The redesigned row_pack and run_sum on their edge cases, with and
    without totals, the block-max skip on (small k) and off (k past the
    slot window): the result against the plain version, and run_sum's
    candidates and totals against the plain segmented_run_sum."""
    rng = np.random.default_rng(EDGE_CASES.index(kind) + 60)
    fd, fi, rows, mins, d_pad, ext, plan_kw = new_class_case(rng, kind)
    pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad, ext,
                                           **plan_kw)
    assert ("doc_bases" in extra) == (kind == "delta_split")
    if kind == "many_short_slots":
        assert pos[2].shape[1] >= 64 and static["max_len"] == 8
        terms = extra["slot_terms"][0][pos[3][0] > 0]
        assert len(np.unique(terms)) < len(terms)  # split terms
    seen = dict.fromkeys(merge_kernel.SIZE_CLASSES, 0)
    for k in (5, 2 * static["max_len"]):
        for with_totals in (True, False):
            got, want, stats = run_pair(pos, extra, static, k, with_totals)
            cases.assert_bitwise(got, want, f"{kind} k={k} "
                                 f"totals={with_totals}")
            assert_run_sum_matches_reference(stats, static, mins)
            for c, n in stats["classes"].items():
                seen[c] += n
    lanes = pos[3].clip(min=0).sum(axis=1)
    split = int((lanes > merge_kernel.tile_lanes()).sum())
    assert seen["row_pack.split"] == 4 * split, seen
    assert seen["row_pack.single"] == 4 * (len(rows) - split), seen
    if kind == "empty_rows_and_slots":
        assert lanes[1] == 0 and (pos[3][0] == 0).any()
    if kind == "delta_split":
        assert split == 1 and seen["run_sum.tiled"] > 0


def sized_flat(rng, sizes, d_pad, impacts=None):
    """Postings of exactly `sizes` random docs each; term t's impacts are
    impacts[t](n) when given, else uniform in [0.1, 1)."""
    fd, fi, ext, pos = [], [], [], 0
    for t, n in enumerate(sizes):
        fd.append(np.sort(rng.choice(d_pad, size=n, replace=False)))
        fi.append(impacts[t](n) if impacts else rng.uniform(0.1, 1.0, n))
        ext.append((pos, n))
        pos += n
    fd = np.concatenate(fd + [np.full(cases.SLACK, d_pad)]).astype(np.int32)
    fi = np.concatenate(fi + [np.zeros(cases.SLACK)]).astype(np.float32)
    return fd, fi, ext


def slot_case(rng, kind):
    """Operands of one of slot_decode's edge cases → (flats, rows, mins,
    d_pad, ext, plan keywords)."""
    if kind == "len_edges":
        # slots of kk - 1, kk and kk + 1 lanes for kk = 10, 128, 700; an
        # empty slot between full ones; weight 0 on two terms
        d_pad = 3000
        sizes = [9, 10, 11, 127, 128, 129, 699, 700, 701]
        fd, fi, ext = sized_flat(rng, sizes, d_pad)
        end = ext[-1][0] + ext[-1][1]
        ws = [float(w) for w in rng.uniform(0.3, 3.0, len(sizes))]
        row = [(ext[t][0], ext[t][1], ws[t], t) for t in range(9)]
        rows = [row[:4] + [(end, 0, 1.0, 9)] + row[4:],
                [(ext[t][0], ext[t][1], 0.0 if t in (4, 7) else ws[t], t)
                 for t in range(2, 9)],
                [row[8], row[5]]]
        return (fd, fi), rows, [1, 1, 2], d_pad, ext, {}
    if kind == "equal_codes":
        # one code throughout a term; codes whose top byte is one value
        # (impacts in [0.5, 1): one exponent); codes over six exponents;
        # one code but for a high outlier in lane 100 (the fourth warp of
        # a block select) and a low one
        def outliers(n):
            imp = np.full(n, 0.3)
            imp[100], imp[n - 200] = 0.9, 0.05
            return imp
        d_pad = 4000
        fd, fi, ext = sized_flat(rng, [300, 800, 1500, 900], d_pad, [
            lambda n: np.full(n, 0.625),
            lambda n: rng.uniform(0.5, 1.0, n),
            lambda n: rng.random(n) ** 3 * 0.9 + 0.01, outliers])
        rows = [[(ext[t][0], ext[t][1], 1.7, t)] for t in range(4)]
        rows.append([(ext[t][0], ext[t][1], 0.4 + t, t) for t in range(4)])
        return (fd, fi), rows, [1] * 5, d_pad, ext, {}
    if kind == "full_slot":
        # a term of exactly 4096 docs: one full slot; one of 4500: a full
        # slot and one of 404 lanes
        d_pad = 10000
        fd, fi, ext = sized_flat(rng, [4096, 4500], d_pad)
        rows = [[(ext[0][0], ext[0][1], 1.3, 0)],
                [(ext[t][0], ext[t][1], 0.9 + t, t) for t in range(2)]]
        return (fd, fi), rows, [1, 1], d_pad, ext, {}
    # the u8 delta doc stream: every 128-lane block spans < 256 ids, so a
    # slot holds < 256 lanes (at k = 700 the skip is off)
    d_pad = 250
    fd, fi, ext = sized_flat(rng, [249, 200, 130, 127, 60], d_pad)
    rows = [[(ext[t][0], ext[t][1], 1.0 + 0.3 * t, t) for t in range(5)],
            [(ext[t][0], ext[t][1], 0.7, t) for t in (1, 3)]]
    return (fd, fi), rows, [1, 2], d_pad, ext, {}


def assert_slot_decode_matches_plain(pos, extra, static, k, stats):
    """slot_decode's kth, grp_ub and slot_ub bit for bit against the
    plain stages (kth on the slots of ≥ kk lanes, -inf on the others),
    and its size classes: one per slot."""
    tpos = cases.to_torch(pos)
    want = merge_kernel.slot_decode_plain(*tpos, k=k, **static,
                                          **cases.to_torch(extra))
    assert merge_kernel.slot_decode_mismatches(
        stats["slot_decode_output"], want) == [], k
    lengths = tpos[3]
    kk = min(k, lengths.shape[1] * static["max_len"])
    n_sel = int((lengths >= kk).sum())
    n_warp = int(((lengths >= kk)
                  & (lengths <= merge_kernel.slot_warp_lanes())).sum())
    classes = stats["classes"]
    assert stats["select_slots"] == n_sel
    assert classes["slot_decode.select_warp"] == n_warp
    assert classes["slot_decode.select_block"] == n_sel - n_warp
    assert classes["slot_decode.bounds"] == lengths.numel() - n_sel


SLOT_CASES = [(kind, k) for kind in ("len_edges", "equal_codes",
                                     "full_slot", "delta")
              for k in (10, 128, 700) if (kind, k) != ("delta", 700)]


@pytest.mark.parametrize("kind,k", SLOT_CASES)
def test_slot_decode_outputs_match_plain(emulated, kind, k):
    """slot_decode's own outputs, which the final results cannot show (a
    kth too low or a bound too high only makes the skip drop fewer
    lanes), against the plain stages at kernel k 10, 128 and 700, with
    both of its classes taken; and the final results against the plain
    version."""
    rng = np.random.default_rng(SLOT_CASES.index((kind, k)) + 90)
    (fd, fi), rows, mins, d_pad, ext, plan_kw = slot_case(rng, kind)
    pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad, ext,
                                           **plan_kw)
    assert ("doc_bases" in extra) == (kind == "delta")
    got, want, stats = run_pair(pos, extra, static, k)
    cases.assert_bitwise(got, want, f"{kind} k={k}")
    assert stats["do_skip"] == 1
    assert_slot_decode_matches_plain(pos, extra, static, k, stats)
    lengths = pos[3]
    kk = min(k, lengths.shape[1] * static["max_len"])
    assert (lengths >= kk).any() and (lengths < kk).any()
    if kind == "len_edges":
        assert {kk - 1, kk, kk + 1} <= set(lengths.ravel().tolist())
    if kind == "full_slot":
        assert static["max_len"] == 4096 and (lengths == 4096).any()


def test_slot_decode_thousand_short_slots_match_plain(emulated):
    """T = 1024 slots of 64 lanes (64 chunks of each of 16 terms), many
    slots to one bounds block, every full slot selecting at k = 10, and
    the slots past a row's terms empty."""
    rng = np.random.default_rng(331)
    d_pad = 9000
    fd, fi, ext = cases.make_heavy_flat(rng, d_pad, [4096] * 16, skew=2.0)
    ws = [float(w) for w in rng.uniform(0.5, 3.0, size=16)]
    rows = [[(ext[t][0], ext[t][1], ws[t], t) for t in range(16)],
            [(ext[t][0], ext[t][1], ws[t], t) for t in range(0, 16, 3)]]
    pos, extra, static = cases.kernel_args(fd, fi, rows, [1, 1], d_pad, ext,
                                           chunk_cap=64)
    assert pos[2].shape[1] == 1024
    got, want, stats = run_pair(pos, extra, static, 10)
    cases.assert_bitwise(got, want)
    assert_slot_decode_matches_plain(pos, extra, static, 10, stats)


@pytest.mark.parametrize("weight", [-1.5, float("inf")])
def test_slot_decode_outside_the_code_domain_matches_plain(emulated,
                                                           weight):
    """A weight that packable() refuses (negative, or infinite) breaks the
    order of codes and products: those slots select on the products,
    the padding lanes (+0) counted, and still give the plain kth."""
    rng = np.random.default_rng(332)
    (fd, fi), rows, mins, d_pad, ext, _ = slot_case(rng, "len_edges")
    rows = [[(s, n, weight if t % 2 else w, t) for s, n, w, t in row]
            for row in rows]
    pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad, ext)
    for k in (10, 700):
        _, _, stats = run_pair(pos, extra, static, k)
        assert_slot_decode_matches_plain(pos, extra, static, k, stats)


@pytest.mark.parametrize("fault", ["k", "length", "t_window"])
def test_launch_refuses_what_the_kernels_do_not_take(emulated, fault):
    """k past K_LIMIT, a slot longer than max_len (the lane decode and
    the staged rescore window hold max_len lanes), or a window past the
    run trees' depth (WINDOW_LIMIT), raise before a launch."""
    rng = np.random.default_rng(5)
    fd, fi, rows, mins, d_pad, k, ext = cases.make_case(rng)
    pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad, ext,
                                           chunk_cap=64)
    if fault == "k":
        k, match = merge_kernel.K_LIMIT + 1, "k ≤"
    elif fault == "t_window":
        static = dict(static, t_window=merge_kernel.WINDOW_LIMIT + 1)
        match = "t_window"
    else:
        pos[3] = pos[3].copy()
        pos[3][0, 0] = static["max_len"] + 1
        match = "max_len"
    before = dict(merge_kernel.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        run_pair(pos, extra, static, k)
    assert merge_kernel.LAUNCHES == before


# ---------------------------------------------------------------------------
# shard_topk and the exact merge
# ---------------------------------------------------------------------------

def run_topk_pair(vals, k):
    """(emulated shard_topk, plain version, stats) on a CPU [B, N]."""
    t = torch.from_numpy(vals)
    stats = {}
    got = merge_kernel._launch_topk(t, k, stats=stats, events=None)
    return got, merge_kernel.shard_topk_plain(t, k), stats


def assert_topk_equal(got, want, msg=""):
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  want[0].numpy().view(np.uint32),
                                  err_msg=msg)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy(),
                                  err_msg=msg)


@pytest.mark.parametrize("case", ["ties_across_shards", "all_neg_inf",
                                  "k_above_sort_cap", "k_above_width",
                                  "signed_zeros"])
def test_shard_topk_matches_plain(emulated, case, monkeypatch):
    """The kernel's values (as uint32) and positions equal the stable
    descending sort's: equal scores of several shards in ascending
    position, rows of -inf only, finalists past the shared-memory sort
    (the device class), k past the row's width, and -0.0 beside +0.0."""
    rng = np.random.default_rng(90)
    if case == "ties_across_shards":
        vals, ks = cases.gathered_rows(rng, 3, 8, 40, 6), (1, 7, 40, 130)
    elif case == "all_neg_inf":
        vals = cases.gathered_rows(rng, 3, 4, 30, 5)
        vals[1] = -np.inf
        ks = (10, 120)
    elif case == "k_above_sort_cap":
        monkeypatch.setattr(merge_kernel, "TOPK_SORT_CAP", 64)
        vals, ks = cases.gathered_rows(rng, 2, 8, 64, 9), (65, 200, 512)
    elif case == "k_above_width":
        vals, ks = cases.gathered_rows(rng, 2, 3, 10, 4), (31, 100)
    else:
        vals = np.array([[0.0, -0.0, 1.5, -0.0, 0.0, -1.0, -np.inf, 1.5]],
                        dtype=np.float32)
        ks = (3, 8)
    for k in ks:
        got, want, stats = run_topk_pair(vals, k)
        assert_topk_equal(got, want, f"{case} k={k}")
    if case == "k_above_sort_cap":
        assert stats["topk_classes"]["shard_topk.device"] == 2
    elif case == "ties_across_shards":   # 320 values a row, k 130
        assert stats["topk_classes"]["shard_topk.staged"] == 3


def run_exact_pair(pos, extra, static, k, with_totals=True):
    """(emulated exact merge, its plain version, stats) on CPU
    operands."""
    tpos = cases.to_torch(pos)
    kw = dict(static, k=k, with_totals=with_totals,
              **cases.to_torch(extra))
    stats = {}
    got = merge_kernel._launch_exact(*tpos, stats=stats, events=None, **kw)
    return got, merge_kernel.exact_merge_topk_plain(*tpos, **kw), stats


def unpackable(rows, weight):
    """The rows with every slot weight replaced by `weight` (a value
    packable() refuses), or scaled by it when it is a tiny boost."""
    return [[(s, n, weight, t) for s, n, _, t in row] for row in rows]


@pytest.mark.parametrize("case", ["tiny_boost", "negative", "mixed_sign",
                                  "tie_heavy", "delta", "device_rows"])
def test_exact_merge_matches_plain(emulated, case):
    """compressed_exact's kernel path against merge_topk_core(variant=
    "compressed_exact"): scores as uint32, docs and totals exactly, with
    and without totals. Weights packable() refuses (1e-15, negative:
    every total ≤ 0, no candidate; mixed signs: lanes that cancel), tied
    exact scores (ordered by doc), the u8 delta doc stream, msm rows, and
    rows longer than the shared-memory sort (the device class)."""
    rng = np.random.default_rng(95)
    if case == "device_rows":
        d_pad = 12000
        fd, fi, ext = cases.make_heavy_flat(rng, d_pad, [5000, 4000, 300])
        rows = [[(ext[t][0], ext[t][1], 1e-15 * (t + 1), t)
                 for t in range(3)],
                [(ext[t][0], ext[t][1], 2e-15, t) for t in (0, 2)]]
        mins = [1, 2]
        chunk_cap = 4096
    else:
        fd, fi, rows, mins, d_pad, _, ext = cases.make_case(
            rng, tie_heavy=case == "tie_heavy")
        rows = rows + [rows[0][:2]]
        mins = mins + [2]
        chunk_cap = 64
        if case == "tiny_boost":
            rows = [[(s, n, w * 1e-15, t) for s, n, w, t in row]
                    for row in rows]
        elif case == "negative":
            rows = unpackable(rows, -1.5)
        elif case == "mixed_sign":
            rows = [[(s, n, (-1.0 if t % 2 else 1.0) * w, t)
                     for s, n, w, t in row] for row in rows]
        elif case == "tie_heavy":
            rows = unpackable(rows, 1e-15)
    delta = True if case == "delta" else (False if case != "device_rows"
                                          else None)
    if case == "delta":
        d_pad = 250
        fd, fi, ext = cases.make_flat(rng, 5, d_pad, 200)
        rows = [[(ext[t][0], ext[t][1], -0.5 + t, t) for t in range(5)],
                [(ext[t][0], ext[t][1], 1e-14, t) for t in (1, 3)]]
        mins = [1, 2]
    pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad, ext,
                                           chunk_cap=chunk_cap, delta=delta)
    if case == "delta":
        assert "doc_bases" in extra
    merge_kernel.reset_launches()
    n_valid = 0
    for k in (5, 300):
        for with_totals in (True, False):
            got, want, stats = run_exact_pair(pos, extra, static, k,
                                              with_totals)
            cases.assert_bitwise(got, want, f"{case} k={k}")
            n_valid += int((got[0] > float("-inf")).sum())
    assert merge_kernel.LAUNCHES["exact_merge"] == 4
    assert merge_kernel.LAUNCHES["shard_topk"] == 4
    classes = stats["exact_classes"]
    if case == "device_rows":   # rows past the 2048-lane window
        assert classes["exact.parts"] >= 1
    else:
        assert classes["exact.merge"] == len(rows)
    if case == "negative":
        assert n_valid == 0 and not got[0].isfinite().any()
    else:
        assert n_valid > 0



@pytest.mark.parametrize("case", cases.TOPK_DEVICE_CASES)
def test_shard_topk_device_class_matches_plain(emulated, case,
                                               monkeypatch):
    """The device class at a small scale (finalist sort cap 64, slices of
    64 values, so a row takes several blocks): the select passes with
    their last-arriving block, the sorted runs (a run of a whole slice,
    past the cap) and the rank merge, against the stable sort: values as
    uint32 (NaN, -0.0, +-inf kept), positions exactly."""
    monkeypatch.setattr(merge_kernel, "TOPK_SORT_CAP", 64)
    monkeypatch.setattr(merge_kernel, "TOPK_SLICE", 64)
    if case == "run_holds_its_slice":
        monkeypatch.setattr(merge_kernel, "TOPK_SLICE", 128)
    vals, ks = cases.topk_case(np.random.default_rng(97), case)
    for k in ks:
        got, want, stats = run_topk_pair(vals, k)
        assert_topk_equal(got, want, f"{case} k={k}")
        assert stats["topk_classes"] == {
            "shard_topk.staged": 0, "shard_topk.shared": 0,
            "shard_topk.device": vals.shape[0]}, k
        assert stats["topk_slices"] == -(-vals.shape[1]
                                         // merge_kernel.TOPK_SLICE) > 1


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "shared"])
def test_shard_topk_select_classes_match_plain(emulated, staged,
                                               monkeypatch):
    """Rows wider than k whose finalists sort in one block: the select
    over the row staged in shared memory, or (a row past the stage cap)
    over device memory; NaN, -0.0 and ties among the values."""
    if not staged:
        monkeypatch.setattr(merge_kernel, "TOPK_STAGE_CAP", 100)
    rng = np.random.default_rng(98)
    vals = cases.gathered_rows(rng, 3, 6, 50, 7)
    vals[0, ::7] = np.nan
    vals[1, ::5] = -0.0
    vals[1, 1::5] = 0.0
    for k in (1, 33, 130):
        got, want, stats = run_topk_pair(vals, k)
        assert_topk_equal(got, want, f"k={k}")
        cls = "shard_topk.staged" if staged else "shard_topk.shared"
        assert stats["topk_classes"][cls] == 3


@pytest.mark.parametrize("window_cap", [64, 2048],
                         ids=["windows", "one_window"])
@pytest.mark.parametrize("case", cases.EXACT_WINDOW_CASES)
def test_exact_merge_windows_match_plain(emulated, case, window_cap,
                                         monkeypatch):
    """The exact merge's merge of sorted slot runs: short rows in one
    window of right-sized shared memory (the longest row rounded up to
    1024 lanes), and (a 64-lane cap) rows cut by doc into parts of a
    block each, a part's window budget shared unevenly among slots of
    very different lengths (over several windows); equal docs in many
    slots (the run sums in slot order), msm rows, the u8 delta doc
    stream; and a slot whose docs descend, which sends its row to the
    radix passes. Scores as uint32, docs and totals exactly; every row's
    class asserted."""
    monkeypatch.setattr(merge_kernel, "EXACT_WINDOW_CAP", window_cap)
    fd, fi, rows, mins, d_pad, ext, delta = cases.exact_window_case(
        np.random.default_rng(99), case)
    pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad, ext,
                                           chunk_cap=256, delta=delta)
    assert ("doc_bases" in extra) == delta
    for k in (7, 400):
        got, want, stats = run_exact_pair(pos, extra, static, k)
        cases.assert_bitwise(got, want, f"{case} k={k}")
        assert int(got[2].sum()) > 0
    classes = stats["exact_classes"]
    lanes = np.asarray(pos[3]).clip(min=0).sum(axis=1)
    assert stats["window_lanes"] == min(window_cap,
                                        -(-int(lanes.max()) // 1024) * 1024)
    longer = int((lanes > stats["window_lanes"]).sum())
    assert (longer > 0) == (window_cap == 64)
    if case == "descending_slot":
        assert classes["exact.radix"] == 1
        assert sum(classes.values()) == len(rows)
    else:   # a row past the window is cut into parts
        assert classes == {"exact.merge": len(rows) - longer,
                           "exact.parts": longer, "exact.radix": 0}


# ---------------------------------------------------------------------------
# raw packs: raw_merge, pruned_candidates, pruned_rescore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window_cap", [64, 2048],
                         ids=["windows", "one_window"])
@pytest.mark.parametrize("case", [c for c in cases.EXACT_WINDOW_CASES
                                  if c != "delta"] + ["wide_docs"])
def test_raw_merge_matches_plain(emulated, case, window_cap, monkeypatch):
    """raw_merge (variant "ref" on a raw pack) against its plain version:
    the exact merge's window cases on int32 docs and f32 impacts, and
    docs past 2**16 (wide_docs: 19-bit docs, three radix passes when a
    row falls back). Scores as uint32, docs and totals exactly."""
    monkeypatch.setattr(merge_kernel, "EXACT_WINDOW_CAP", window_cap)
    rng = np.random.default_rng(101)
    if case == "wide_docs":
        d_pad = 300_032
        fd, fi, ext = cases.make_flat(rng, 5, d_pad, 900)
        rows = [[(ext[t][0], ext[t][1], 0.5 + t, t) for t in range(5)],
                [(ext[t][0], ext[t][1], 1.0, t) for t in (0, 2, 4)]]
        mins = [1, 2]
    else:
        fd, fi, rows, mins, d_pad, _, _ = cases.exact_window_case(rng, case)
    pos, static = cases.raw_args(fd, fi, rows, mins, d_pad)
    tpos = cases.to_torch(pos)
    for k in (7, 400):
        stats = {}
        got = merge_kernel._launch_exact(*tpos, k=k, with_totals=True,
                                         stats=stats, events=None, raw=True,
                                         **static)
        want = merge_kernel.raw_merge_topk_plain(*tpos, k=k,
                                                 with_totals=True, **static)
        cases.assert_bitwise(got, want, f"{case} k={k}")
        assert int(got[2].sum()) > 0
    if case == "descending_slot":
        assert stats["exact_classes"]["exact.radix"] == 1


@pytest.mark.parametrize("pack_keys", [False, True], ids=["gid", "u32_key"])
def test_pruned_candidates_match_plain(emulated, pack_keys):
    """Phase A of one group of 3 rows: every query's lanes keyed by gid
    (or, pack_keys, by the group-relative key with the impact code),
    sorted, run-summed, the candidates' top-k; values, gids and totals
    exactly, prefixes (lengths below a term's postings) included."""
    arrays, static = cases.candidates_case(np.random.default_rng(102))
    args = [torch.from_numpy(a) for a in arrays]
    for k in (9, 200):
        kw = dict(static, k=k, pack_keys=pack_keys)
        got = merge_kernel._launch_candidates(*args, events=None, **kw)
        want = merge_kernel.pruned_candidates_plain(*args, **kw)
        np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                      want[0].numpy().view(np.uint32))
        live = want[0] > float("-inf")
        np.testing.assert_array_equal(got[1][live].numpy(),
                                      want[1][live].numpy())
        np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
        assert int(got[2].sum()) > 0


@pytest.mark.parametrize("mode", ["score_and_order", "score", "order"])
def test_pruned_rescore_matches_plain(emulated, mode):
    """Phase B: each candidate's terms binary-searched in the doc-sorted
    rows, summed in the reference's association; and the final (-score,
    gid) order of the candidates (ties of score by gid, -inf last)."""
    ds, tg, tr, tv, kw = cases.rescore_case(np.random.default_rng(103))
    exact = merge_kernel.pruned_rescore_plain(*ds, tg, *tr, **kw)
    assert (exact > 0).any()
    if mode == "score":
        got = merge_kernel._launch_rescore(*ds, tg, *tr, None,
                                           cand_vals=None, k=None,
                                           events=None, **kw)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      exact.numpy().view(np.uint32))
        return
    # a tie of exact scores, broken by gid
    exact[:, 30] = exact[:, 31]
    want = merge_kernel.pruned_order_plain(exact, tv, tg, k=60)
    if mode == "order":
        got = merge_kernel._launch_rescore(None, None, tg, None, None, None,
                                           exact, cand_vals=tv, k=60,
                                           d_pad=0, p_pad=0, row_base=0,
                                           search_iters=0, events=None)
    else:
        want = merge_kernel.pruned_rescore_plain(*ds, tg, *tr, cand_vals=tv,
                                                 k=60, **kw)
        got = merge_kernel._launch_rescore(*ds, tg, *tr, None,
                                           cand_vals=tv, k=60, events=None,
                                           **kw)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  want[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


#: pruned_candidates' size settings (band cap, part lanes) per case, and
#: the queries each class takes in banded_candidates_case
CAND_SIZES = {
    "one_block": ((4096, 4096), (6, 0, 0)),
    "bands": ((64, 32), (3, 2, 1)),
    "one_part": ((64, 4096), (3, 2, 1)),
}


@pytest.mark.parametrize("t_window", [4, 5, 8])
@pytest.mark.parametrize("pack_keys", [False, True], ids=["gid", "u32_key"])
@pytest.mark.parametrize("sizes", list(CAND_SIZES))
def test_pruned_candidates_classes_match_plain(emulated, sizes, pack_keys,
                                               t_window, monkeypatch):
    """Phase A's size classes at shrunk settings: one block a query
    (shared), bands each sorted in shared memory after part blocks split
    the lanes (bands: many bands, bands of one item and none, keys at a
    band's edges, several parts a query; one_part: a part a query), and
    a band past its cap sorted in device memory (device); empty
    queries, a query of one lane, 8-lane runs (t_window's tree; a
    window of 5 sums as the doubling steps do, over 8), a padding row,
    both key modes with ties of the 16-bit codes. Values as uint32,
    gids (where finite) and totals exactly."""
    (cap, part), classes = CAND_SIZES[sizes]
    monkeypatch.setattr(merge_kernel, "CAND_BAND_CAP", cap)
    monkeypatch.setattr(merge_kernel, "CAND_PART_LANES", part)
    arrays, static = cases.banded_candidates_case(np.random.default_rng(108))
    static["t_window"] = t_window
    args = [torch.from_numpy(a) for a in arrays]
    lanes = args[3].sum(dim=1)
    assert lanes[0] == 0 and lanes[1] == 1 and lanes[5] <= 16
    parts = sum(-(-int(n) // part) for n in lanes if n > cap)
    for k in (9, 300):
        kw = dict(static, k=k, pack_keys=pack_keys)
        stats = {}
        got = merge_kernel._launch_candidates(*args, events=None,
                                              stats=stats, **kw)
        want = merge_kernel.pruned_candidates_plain(*args, **kw)
        np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                      want[0].numpy().view(np.uint32))
        live = want[0] > float("-inf")
        np.testing.assert_array_equal(got[1][live].numpy(),
                                      want[1][live].numpy())
        np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
        assert tuple(stats["cand_classes"].values()) == classes
        assert stats["cand_blocks"]["cand_part"] == parts
    assert int(want[2][2]) > 0 and int(want[2][0]) == 0


def test_pruned_candidates_bands_hold_edges(monkeypatch):
    """The "bands" case's plan reaches what its test means to: many bands
    a query, bands of no item and of one, keys on both sides of a band
    edge, several parts a query and a band past the cap."""
    monkeypatch.setattr(merge_kernel, "CAND_BAND_CAP", 64)
    monkeypatch.setattr(merge_kernel, "CAND_PART_LANES", 32)
    arrays, static = cases.banded_candidates_case(np.random.default_rng(108))
    fd, _, starts, lengths, _, rows = arrays
    d1 = static["d_pad"] + 1
    caps = lengths.sum(axis=1)
    key_top = 2 * d1
    plan = merge_kernel._candidates_plan(caps.tolist(), key_top, False)[0]
    qinfo = plan[len(caps) + 1:len(caps) + 1 + 4 * len(caps)].reshape(-1, 4)
    sizes = []
    for q in (2, 3, 4):
        shift, bands, parts = (int(x) for x in qinfo[q, :3])
        assert bands > 4 and parts > 1
        keys = np.concatenate([
            rows[q, j] * d1 + fd[starts[q, j]:starts[q, j] + lengths[q, j]]
            for j in range(starts.shape[1])])
        count = np.bincount(keys >> shift, minlength=bands)
        sizes.extend(count.tolist())
        if q == 2:   # whole postings: every edge doc is in
            edge = keys & ((1 << shift) - 1)
            assert (edge == 0).any() and (edge == (1 << shift) - 1).any()
    assert 0 in sizes and 1 in sizes and max(sizes) > 64


@pytest.mark.parametrize("c", [33, 300], ids=["c33", "c300"])
@pytest.mark.parametrize("t_terms", [1, 2, 4, 8, 32])
def test_pruned_rescore_spread_matches_plain(emulated, t_terms, c):
    """The scores spread over blocks of 256 / T_terms candidates (one
    block or several, the last one partial), every power-of-two term
    count the kernel takes, then the order launch: the scores and the
    (-score, gid) order equal the plain fixed-step loop's bit for bit."""
    ds, tg, tr, tv, kw = cases.rescore_case(
        np.random.default_rng(109), c=c, t_terms=t_terms,
        n_terms=max(10, t_terms))
    exact = merge_kernel.pruned_rescore_plain(*ds, tg, *tr, **kw)
    got = merge_kernel._launch_rescore(*ds, tg, *tr, None, cand_vals=None,
                                       k=None, events=None, **kw)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  exact.numpy().view(np.uint32))
    want_o = merge_kernel.pruned_rescore_plain(*ds, tg, *tr, cand_vals=tv,
                                               k=70, **kw)
    stats = {}
    got_o = merge_kernel._launch_rescore(*ds, tg, *tr, None, cand_vals=tv,
                                         k=70, events=None, stats=stats,
                                         **kw)
    assert stats["rescore_classes"]["rescore.spread"] == tg.shape[0]
    assert stats["rescore_blocks"]["rescore_score"] == \
        -(-c // (256 // t_terms)) * tg.shape[0]
    np.testing.assert_array_equal(got_o[0].numpy().view(np.uint32),
                                  want_o[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(got_o[1].numpy(), want_o[1].numpy())


@pytest.mark.parametrize("mode", ["order", "score_and_order"])
def test_pruned_rescore_full_width_matches_plain(emulated, mode):
    """C = PRUNED_CAND_LIMIT candidates a query, every one ordered (k =
    C): scores tied across warps (the many zeros and a tie placed at
    candidates 31 and 32) broken by gid, -0.0 after +0.0 (their gids in
    the other order), the -inf candidates last."""
    c = merge_kernel.PRUNED_CAND_LIMIT
    ds, tg, tr, tv, kw = cases.rescore_case(np.random.default_rng(110),
                                            c=c, b=2)
    if mode == "order":
        exact = merge_kernel.pruned_rescore_plain(*ds, tg, *tr, **kw)
        exact[:, 31] = exact[:, 32]
        tg[:, 31], tg[:, 32] = 9, 5
        exact[:, 5], exact[:, 6] = -0.0, 0.0
        tg[:, 5], tg[:, 6] = 3, 4
        want = merge_kernel.pruned_order_plain(exact, tv, tg, k=c)
        got = merge_kernel._launch_rescore(None, None, tg, None, None, None,
                                           exact, cand_vals=tv, k=c,
                                           d_pad=0, p_pad=0, row_base=0,
                                           search_iters=0, events=None)
        zeros = want[0] == 0
        assert zeros.sum() > 64
        assert (want[0][zeros].numpy().view(np.uint32) == 0x80000000).any()
    else:
        want = merge_kernel.pruned_rescore_plain(*ds, tg, *tr, cand_vals=tv,
                                                 k=c, **kw)
        got = merge_kernel._launch_rescore(*ds, tg, *tr, None, cand_vals=tv,
                                           k=c, events=None, **kw)
    assert torch.isinf(want[0][:, -7:]).all()
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  want[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


# ---------------------------------------------------------------------------
# rows past 1,024 slots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t_slots,k", [(2048, 10), (2048, 1000),
                                       (4096, 1000), (8192, 1000)])
def test_wide_rows_match_plain(emulated, t_slots, k):
    """The fused kernels on rows of 1,100 terms at chunk_cap 64 (T 2048,
    4096, 8192; the windows past 1,024 terms take the 14-level run
    trees, doc 0's run of 1,100 lanes the 11th doubling step): row_pack's
    slot table built once a row in device memory (pack_table_kernel),
    select_rescore's slot prefix in device memory past 1,024 slots, and
    at k 10 the skip's term bounds over the whole table. Scores as uint32, docs and totals exactly. Past T
    2048 chunks of 8 lanes keep the rows' lanes few."""
    rng = np.random.default_rng(t_slots)
    cap = 64 if t_slots == 2048 else 8
    fd, fi, rows, mins, d_pad, ext = cases.make_wide_case(rng, t_slots,
                                                          chunk_cap=cap)
    pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad, ext,
                                           chunk_cap=cap)
    assert pos[2].shape == (2, t_slots) and static["t_window"] == 1100
    got, want, stats = run_pair(pos, extra, static, k)
    cases.assert_bitwise(got, want, f"T={t_slots} k={k}")
    assert int(got[1][0][0]) == 0 and int(got[2][1]) == 1
    assert stats["do_skip"] == int(k <= static["max_len"])
    assert stats["slots"] == t_slots
    assert stats["run_sum_output"]["n_cand"].tolist()[1] == 1


@pytest.mark.parametrize("t_slots", [2048, 4096, 16384])
@pytest.mark.parametrize("raw", [False, True], ids=["exact", "raw"])
def test_wide_exact_and_raw_merge_match_plain(emulated, t_slots, raw):
    """exact_merge (boost 1e-15: unpackable weights) and raw_merge on
    rows of 1,100 terms: the slot table beside the windows in shared
    memory (T 2048), in device memory a block slice with the grid
    walking the rows (T 4096), and past the merge window's items (T
    16,384) the radix class for every row. Chunks of 8 lanes keep the
    rows' lanes (and the emulator's windows) few."""
    rng = np.random.default_rng(t_slots + 7)
    fd, fi, rows, mins, d_pad, ext = cases.make_wide_case(rng, t_slots,
                                                          chunk_cap=8)
    if raw:
        pos, static = cases.raw_args(fd, fi, rows, mins, d_pad, chunk_cap=8)
        extra = {}
    else:
        rows = unpackable(rows, 1e-15)
        pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad,
                                               ext, chunk_cap=8)
    assert pos[2].shape == (2, t_slots)
    tpos = cases.to_torch(pos)
    kw = dict(static, k=1000, with_totals=True, **cases.to_torch(extra))
    stats = {}
    got = merge_kernel._launch_exact(*tpos, stats=stats, events=None,
                                     raw=raw, **kw)
    plain = (merge_kernel.raw_merge_topk_plain if raw
             else merge_kernel.exact_merge_topk_plain)
    cases.assert_bitwise(got, plain(*tpos, **kw), f"T={t_slots}")
    assert int(got[1][0][0]) == 0 and int(got[2][1]) == 1
    classes = stats["exact_classes"]
    if t_slots == 16384:
        assert classes["exact.radix"] == 2
    else:
        assert classes["exact.radix"] == 0
    assert (stats["table_blocks"] > 0) == (t_slots >= 4096)
