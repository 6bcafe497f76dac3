"""The hand-written CUDA merge kernel against its plain torch version, on
the card: scores as uint32, doc ids and totals exactly.

Marked gpu: the kernel has no CPU mode, so these tests skip on a machine
without a CUDA device and nvcc. Run them on the card with
``python -m pytest tests/test_torch_merge_kernel.py -q``.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import merge_kernel, sparse

import torch_parity_cases as cases

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def run_pair(pos, extra, static, k, device, with_totals=True):
    """Kernel and plain version on the same CUDA operands."""
    tpos = cases.to_torch(pos, device)
    tex = cases.to_torch(extra, device)
    kw = dict(static, k=k, with_totals=with_totals, **tex)
    before = dict(merge_kernel.LAUNCHES)
    got = merge_kernel.fused_merge_topk(*tpos, **kw)
    torch.cuda.synchronize()
    assert merge_kernel.LAUNCHES["select_rescore"] == \
        before["select_rescore"] + 1
    want = merge_kernel.fused_merge_topk_plain(*tpos, **kw)
    return got, want


@pytest.mark.parametrize("tie_heavy", [False, True])
@pytest.mark.parametrize("chunk_cap", [64, 4096])
def test_random_rows_match_plain(cuda, tie_heavy, chunk_cap):
    rng = np.random.default_rng(11 + chunk_cap + int(tie_heavy))
    for _ in range(6):
        fd, fi, rows, mins, d_pad, k, ext = cases.make_case(
            rng, tie_heavy=tie_heavy)
        pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad,
                                               ext, chunk_cap=chunk_cap)
        for with_totals in (True, False):
            got, want = run_pair(pos, extra, static, k, cuda, with_totals)
            cases.assert_bitwise(got, want, f"k={k} mins={mins}")


def test_skip_active_batch_matches_plain(cuda):
    """Several rows over long skewed postings: the block-max skip, msm
    rows, the pre-skip count keys and (k=700) the radix candidate
    select all run; slot_decode's kth, group and slot bounds equal the
    plain stages' bit for bit, with slots that select in a block and
    slots that take the bounds only."""
    rng = np.random.default_rng(7)
    d_pad = 20000
    fd, fi, ext = cases.make_heavy_flat(rng, d_pad, [9000, 7000, 5000])
    shapes = [([0], [1.0], 1), ([0, 1], [5.0, 0.2], 1),
              ([0, 1, 2], [8.0, 0.1, 0.1], 1), ([0, 1, 2], [1.0] * 3, 2),
              ([1, 2], [0.7, 2.5], 2)]
    rows = [[(ext[t][0], ext[t][1], w, t) for t, w in zip(ts, ws)]
            for ts, ws, _ in shapes]
    mins = [m for _, _, m in shapes]
    pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad, ext)
    for k in (10, 128, 700):
        got, want = run_pair(pos, extra, static, k, cuda)
        cases.assert_bitwise(got, want, f"k={k}")
        classes = slot_decode_classes(pos, extra, static, k, cuda)
        assert classes["slot_decode.select_block"] > 0
        assert classes["slot_decode.bounds"] > 0
    # the skip really dropped lanes at k=10 (fewer keys than pre-skip)
    stats = {}
    merge_kernel.fused_merge_topk(
        *cases.to_torch(pos, cuda), k=10, with_totals=True, stats=stats,
        **static, **cases.to_torch(extra, cuda))
    assert stats["do_skip"] and stats["keys"] < stats["count_keys"]


@pytest.mark.parametrize("chunk_cap", [64, 4096])
def test_delta_doc_stream_matches_plain(cuda, chunk_cap):
    """A delta-eligible corpus (every 128-lane block spans ≤ 255 ids):
    lane docs and the rescore's binary search decode u8 deltas."""
    rng = np.random.default_rng(8)
    d_pad = 250
    fd, fi, ext = cases.make_flat(rng, 5, d_pad, 200)
    ws = [1.3, 0.7, 2.2, 0.4, 1.9]
    rows = [[(ext[t][0], ext[t][1], ws[t], t) for t in range(5)],
            [(ext[t][0], ext[t][1], ws[t], t) for t in (1, 3)],
            [(ext[t][0], ext[t][1], 1.0, t) for t in range(5)]]
    pos, extra, static = cases.kernel_args(fd, fi, rows, [1, 1, 3], d_pad,
                                           ext, chunk_cap=chunk_cap)
    assert "doc_bases" in extra
    for k in (5, 40, 300):
        got, want = run_pair(pos, extra, static, k, cuda)
        cases.assert_bitwise(got, want, f"k={k}")


def test_cuda_wrapper_rejects_wrong_dtype(cuda):
    rng = np.random.default_rng(3)
    fd, fi, rows, mins, d_pad, k, ext = cases.make_case(rng)
    pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad, ext)
    tpos = cases.to_torch(pos, cuda)
    tpos[1] = tpos[1].to(torch.int32)  # value codes must be u16
    with pytest.raises(ValueError, match="flat_impact"):
        merge_kernel.fused_merge_topk(*tpos, k=k, **static,
                                      **cases.to_torch(extra, cuda))


def test_sorted_merge_topk_routes_cuda_to_kernel(cuda):
    rng = np.random.default_rng(5)
    fd, fi, rows, mins, d_pad, k, ext = cases.make_case(rng)
    pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad, ext)
    before = merge_kernel.LAUNCHES["row_sort"]
    sparse.sorted_merge_topk(*cases.to_torch(pos, cuda), k=k,
                             variant="pallas", **static,
                             **cases.to_torch(extra, cuda))
    assert merge_kernel.LAUNCHES["row_sort"] > before


def slot_decode_classes(pos, extra, static, k, device):
    """slot_decode's kth, grp_ub and slot_ub (which the results cannot
    show) bit for bit against the plain stages → its size classes."""
    tpos = cases.to_torch(pos, device)
    tex = cases.to_torch(extra, device)
    stats = {}
    merge_kernel.fused_merge_topk(*tpos, k=k, with_totals=True, stats=stats,
                                  **static, **tex)
    plain = merge_kernel.slot_decode_plain(*tpos, k=k, **static, **tex)
    assert merge_kernel.slot_decode_mismatches(
        stats["slot_decode_output"], plain) == [], k
    classes = stats["classes"]
    assert (classes["slot_decode.select_warp"]
            + classes["slot_decode.select_block"]) == stats["select_slots"]
    return classes


def run_classes(pos, extra, static, k, device):
    """The kernel's size classes for these operands (rows per class)."""
    stats = {}
    merge_kernel.fused_merge_topk(
        *cases.to_torch(pos, device), k=k, with_totals=True, stats=stats,
        **static, **cases.to_torch(extra, device))
    return stats["classes"]


@pytest.mark.parametrize("n_terms", [2, 4])
def test_full_slot_rows_match_plain(cuda, n_terms):
    """T = 16 / 32 rows of full 4096-lane slots: the row sort's and the
    select's device-memory classes, the rescore restaged by slot group."""
    rng = np.random.default_rng(300 + n_terms)
    fd, fi, rows, mins, d_pad, ext = cases.make_full_slot_case(rng, n_terms)
    pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad, ext)
    for with_totals in (True, False):
        got, want = run_pair(pos, extra, static, 1000, cuda, with_totals)
        cases.assert_bitwise(got, want, f"T={pos[2].shape[1]}")
    classes = run_classes(pos, extra, static, 1000, cuda)
    assert classes["row_sort.device"] > 0
    assert classes["select.device"] > 0
    assert classes["rescore.restaged"] > 0
    assert classes["row_pack.split"] == 2   # 65,536 / 131,072 lanes
    assert classes["run_sum.tiled"] == 2


def test_thousand_short_slots_match_plain(cuda):
    """T = T_LIMIT = 1024 slots of 64 lanes (16 terms of 4096 docs in
    64-lane chunks, 64 chunks a term): row_pack's skip preamble over the
    whole slot table (each slot's term bound, first-slot flags, the
    serial sum) in every one of a row's 32 blocks, and an msm row."""
    rng = np.random.default_rng(330)
    d_pad = 60000
    fd, fi, ext = cases.make_heavy_flat(rng, d_pad, [4096] * 16, skew=2.0)
    ws = [float(w) for w in rng.uniform(0.5, 3.0, size=16)]
    rows = [[(ext[t][0], ext[t][1], ws[t], t) for t in range(16)],
            [(ext[t][0], ext[t][1], ws[t], t) for t in range(0, 16, 2)]]
    pos, extra, static = cases.kernel_args(fd, fi, rows, [1, 3], d_pad, ext,
                                           chunk_cap=64)
    assert pos[2].shape[1] == merge_kernel.T_LIMIT
    assert static["max_len"] == 64
    for k in (10, 64, 1000):
        for with_totals in (True, False):
            got, want = run_pair(pos, extra, static, k, cuda, with_totals)
            cases.assert_bitwise(got, want, f"k={k} totals={with_totals}")
    classes = run_classes(pos, extra, static, 10, cuda)
    assert classes["row_pack.split"] == 2 and classes["run_sum.tiled"] == 2
    # every 64-lane slot selects in a warp at k = 10
    classes = slot_decode_classes(pos, extra, static, 10, cuda)
    assert classes["slot_decode.select_warp"] > 0


@pytest.mark.parametrize("k", [4096, 10000, 16384])
def test_tie_heavy_beyond_kc_matches_plain(cuda, k):
    """More candidates than kc with ties at the cut, and the final top kk
    trimmed by the 64-bit radix select (k up to the service's 16,384)."""
    rng = np.random.default_rng(310)
    fd, fi, rows, mins, d_pad, ext = cases.make_tie_heavy_full_case(rng)
    pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad, ext)
    for with_totals in (True, False):
        got, want = run_pair(pos, extra, static, k, cuda, with_totals)
        cases.assert_bitwise(got, want, f"k={k}")
    assert run_classes(pos, extra, static, k, cuda)["final.trim"] > 0


def test_small_rows_take_shared_classes(cuda):
    """Rows of a few hundred keys sort and select in shared memory."""
    rng = np.random.default_rng(7)
    d_pad = 20000
    fd, fi, ext = cases.make_heavy_flat(rng, d_pad, [900, 700, 500])
    rows = [[(ext[t][0], ext[t][1], 1.0, t) for t in range(3)]]
    pos, extra, static = cases.kernel_args(fd, fi, rows, [1], d_pad, ext)
    got, want = run_pair(pos, extra, static, 100, cuda)
    cases.assert_bitwise(got, want)
    classes = run_classes(pos, extra, static, 100, cuda)
    assert classes["row_sort.shared"] == 2   # keys and count keys
    assert classes["select.shared"] == 1
    assert classes["rescore.staged"] == 1
    assert classes["final.trim"] == 1
    # 2,100 lanes: two row_pack blocks, two run_sum tiles of count keys
    assert classes["row_pack.split"] == 1 and classes["row_pack.single"] == 0
    assert classes["run_sum.tiled"] == 1 and classes["run_sum.one_tile"] == 0
    # one term's 900 lanes: one block, one tile
    one = [[(ext[0][0], ext[0][1], 1.0, 0)]]
    pos, extra, static = cases.kernel_args(fd, fi, one, [1], d_pad, ext)
    got, want = run_pair(pos, extra, static, 100, cuda)
    cases.assert_bitwise(got, want)
    classes = run_classes(pos, extra, static, 100, cuda)
    assert classes["row_pack.single"] == 1 and classes["run_sum.one_tile"] == 1


def test_service_on_card_matches_cpu_up_to_size_10000(cuda):
    """The service on the card answers as on the CPU, from + size up to
    10,000 beside a size-10 body, and refuses 10,001 alike."""
    from concurrent.futures import ThreadPoolExecutor

    from elasticsearch_tpu_torch.common.errors import NotLowerable
    from elasticsearch_tpu_torch.search.gpu_service import GpuSearchService
    rng = np.random.default_rng(20)
    words = [f"w{i}" for i in range(12)]
    docs = [(f"d{i}", {"body": " ".join(
        words[min(int(z) - 1, 11)] for z in rng.zipf(1.3, 8))})
        for i in range(3000)]
    mapping = {"properties": {"body": {"type": "text"}}}
    bodies = [{"query": {"match": {"body": "w0 w1"}}, "size": size}
              for size in (10, 5000, 10000)]
    out = {}
    for dev in ("cpu", "cuda"):
        svc = GpuSearchService(device=dev, window_s=0.2)
        try:
            svc.create_index("c", 3, mapping)
            svc.index("c", docs)
            svc.refresh("c")
            with ThreadPoolExecutor(max_workers=3) as pool:
                futs = [pool.submit(svc.search, "c", dict(b))
                        for b in bodies]
                out[dev] = [f.result()["hits"] for f in futs]
            with pytest.raises(NotLowerable):
                svc.search("c", {"query": {"match": {"body": "w0"}},
                                 "size": 10001})
        finally:
            svc.close()
    assert out["cuda"] == out["cpu"]


# ---------------------------------------------------------------------------
# shard_topk and the exact merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,shards,per_shard,k", [
    (128, 16, 128, 128), (128, 16, 1024, 1024), (16, 16, 16384, 16384),
    (4, 3, 50, 400)])
def test_shard_topk_matches_plain(cuda, b, shards, per_shard, k):
    """The chip_smoke train's gather ([128, 16 x 1024] at kernel k 1024),
    kernel k 128, kernel k 16,384 (finalists past the shared-memory
    sort: the device class) and k past the row's width: values as
    uint32, positions exactly; a row of -inf only among them."""
    rng = np.random.default_rng(b + per_shard)
    vals = cases.gathered_rows(rng, b, shards, per_shard, 40, step=0.125)
    vals[0] = -np.inf
    t = torch.from_numpy(vals).to(cuda)
    stats = {}
    got = merge_kernel.shard_topk(t, k, stats=stats)
    torch.cuda.synchronize()
    want = merge_kernel.shard_topk_plain(t, k)
    np.testing.assert_array_equal(got[0].cpu().numpy().view(np.uint32),
                                  want[0].cpu().numpy().view(np.uint32))
    np.testing.assert_array_equal(got[1].cpu().numpy(),
                                  want[1].cpu().numpy())
    n = vals.shape[1]
    big = 1 << max(0, (min(k, n) - 1).bit_length())
    cls = ("device" if big > merge_kernel.TOPK_SORT_CAP else
           "staged" if k < n <= merge_kernel.TOPK_STAGE_CAP else "shared")
    assert stats["topk_classes"][f"shard_topk.{cls}"] == b


@pytest.mark.parametrize("weight", [1e-15, -2.0, "mixed"])
@pytest.mark.parametrize("chunk_cap", [64, 4096])
def test_exact_merge_matches_plain(cuda, weight, chunk_cap):
    """sorted_merge_topk(variant="compressed_exact") on the card launches
    exact_merge and shard_topk and equals the plain pipeline bit for bit:
    random rows (OR, msm, AND) with weights packable() refuses, and long
    skewed postings whose rows pass the shared-memory sort."""
    rng = np.random.default_rng(61 + chunk_cap)
    cases_ = [cases.make_case(rng) for _ in range(4)]
    fd, fi, ext = cases.make_heavy_flat(rng, 60000, [30000, 20000, 900])
    heavy_rows = [[(ext[t][0], ext[t][1], 1.0, t) for t in range(3)],
                  [(ext[t][0], ext[t][1], 1.0, t) for t in (0, 2)]]
    cases_.append((fd, fi, heavy_rows, [1, 2], 60000, 1000, ext))
    for fd, fi, rows, mins, d_pad, k, ext in cases_:
        def w_of(w, t):
            if weight == "mixed":
                return w * (-1.0 if t % 2 else 1e-13)
            return w * weight if weight == 1e-15 else weight
        rows = [[(s, n, w_of(w, t), t) for s, n, w, t in row]
                for row in rows]
        pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad,
                                               ext, chunk_cap=chunk_cap)
        assert not sparse.packable(d_pad, pos[4])
        tpos = cases.to_torch(pos, cuda)
        tex = cases.to_torch(extra, cuda)
        for kk in (k, 16384):
            for with_totals in (True, False):
                kw = dict(static, k=kk, with_totals=with_totals, **tex)
                before = dict(merge_kernel.LAUNCHES)
                got = sparse.sorted_merge_topk(
                    *tpos, variant="compressed_exact", **kw)
                torch.cuda.synchronize()
                assert merge_kernel.LAUNCHES["exact_merge"] == \
                    before["exact_merge"] + 1
                assert merge_kernel.LAUNCHES["shard_topk"] == \
                    before["shard_topk"] + 1
                want = merge_kernel.exact_merge_topk_plain(*tpos, **kw)
                cases.assert_bitwise(got, want, f"w={weight} k={kk}")


def assert_topk_equal(got, want, msg=""):
    np.testing.assert_array_equal(got[0].cpu().numpy().view(np.uint32),
                                  want[0].cpu().numpy().view(np.uint32),
                                  err_msg=msg)
    np.testing.assert_array_equal(got[1].cpu().numpy(),
                                  want[1].cpu().numpy(), err_msg=msg)


@pytest.mark.parametrize("case", cases.TOPK_DEVICE_CASES)
def test_shard_topk_device_class_matches_plain(cuda, case, monkeypatch):
    """The device class with the caps of the emulated test (finalist
    sort cap 64, slices of 64 values), so its launches run several blocks
    a row on the card, concurrently: the select passes and their
    last-arriving block, the sorted runs, the rank merge."""
    monkeypatch.setattr(merge_kernel, "TOPK_SORT_CAP", 64)
    monkeypatch.setattr(merge_kernel, "TOPK_SLICE",
                        128 if case == "run_holds_its_slice" else 64)
    vals, ks = cases.topk_case(np.random.default_rng(97), case)
    t = torch.from_numpy(vals).to(cuda)
    for k in ks:
        stats = {}
        got = merge_kernel.shard_topk(t, k, stats=stats)
        torch.cuda.synchronize()
        assert_topk_equal(got, merge_kernel.shard_topk_plain(t, k),
                          f"{case} k={k}")
        assert stats["topk_classes"]["shard_topk.device"] == vals.shape[0]
        assert stats["topk_slices"] > 1


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "shared"])
def test_shard_topk_select_classes_match_plain(cuda, staged, monkeypatch):
    """The select over a row staged in shared memory, and over device
    memory (a row past the stage cap), at [128, 16 x 1024] and k 1024
    with NaN, -0.0 and ties among the values."""
    if not staged:
        monkeypatch.setattr(merge_kernel, "TOPK_STAGE_CAP", 1000)
    rng = np.random.default_rng(98)
    vals = cases.gathered_rows(rng, 128, 16, 1024, 40, step=0.125)
    vals[0, ::7] = np.nan
    vals[1, ::5] = -0.0
    vals[1, 1::5] = 0.0
    t = torch.from_numpy(vals).to(cuda)
    for k in (1, 1024, 5000):
        stats = {}
        got = merge_kernel.shard_topk(t, k, stats=stats)
        torch.cuda.synchronize()
        assert_topk_equal(got, merge_kernel.shard_topk_plain(t, k),
                          f"k={k}")
        cls = "shard_topk.staged" if staged else "shard_topk.shared"
        assert stats["topk_classes"][cls] == 128


@pytest.mark.parametrize("window_cap", [64, 2048],
                         ids=["windows", "one_window"])
@pytest.mark.parametrize("case", cases.EXACT_WINDOW_CASES)
def test_exact_merge_windows_match_plain(cuda, case, window_cap,
                                         monkeypatch):
    """The exact merge's windows on the card (the emulated test's cases:
    one window, rows cut into parts a block each, uneven slots, equal
    docs in many slots, msm, the u8 delta stream, and a descending slot
    that takes the radix class): scores as uint32, docs and totals
    exactly."""
    monkeypatch.setattr(merge_kernel, "EXACT_WINDOW_CAP", window_cap)
    fd, fi, rows, mins, d_pad, ext, delta = cases.exact_window_case(
        np.random.default_rng(99), case)
    pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad, ext,
                                           chunk_cap=256, delta=delta)
    tpos = cases.to_torch(pos, cuda)
    kw = dict(static, with_totals=True, **cases.to_torch(extra, cuda))
    for k in (7, 400):
        stats = {}
        got = merge_kernel.exact_merge_topk(*tpos, k=k, stats=stats, **kw)
        torch.cuda.synchronize()
        want = merge_kernel.exact_merge_topk_plain(*tpos, k=k, **kw)
        cases.assert_bitwise(got, want, f"{case} k={k}")
    classes = stats["exact_classes"]
    assert classes["exact.radix"] == (case == "descending_slot")
    assert (classes["exact.parts"] > 0) == (window_cap == 64)


def test_hierarchical_top_k_routes_cuda_to_shard_topk(cuda):
    t = torch.randn(4, 300, device=cuda)
    before = merge_kernel.LAUNCHES["shard_topk"]
    v, p = sparse.hierarchical_top_k(t, 17)
    torch.cuda.synchronize()
    assert merge_kernel.LAUNCHES["shard_topk"] == before + 1
    wv, wp = sparse.top_k_plain(t, 17)
    assert torch.equal(v, wv) and torch.equal(p, wp)


# ---------------------------------------------------------------------------
# raw packs: raw_merge, pruned_candidates, pruned_rescore
# ---------------------------------------------------------------------------

def raw_pair(pos, static, k, device):
    tpos = cases.to_torch(pos, device)
    before = merge_kernel.LAUNCHES["raw_merge"]
    got = sparse.sorted_merge_topk(*tpos, k=k, with_totals=True,
                                   variant="ref", **static)
    torch.cuda.synchronize()
    assert merge_kernel.LAUNCHES["raw_merge"] == before + 1
    want = merge_kernel.raw_merge_topk_plain(*tpos, k=k, with_totals=True,
                                             **static)
    return got, want


@pytest.mark.parametrize("window_cap", [64, 2048],
                         ids=["windows", "one_window"])
@pytest.mark.parametrize("case", [c for c in cases.EXACT_WINDOW_CASES
                                  if c != "delta"])
def test_raw_merge_windows_match_plain(cuda, case, window_cap, monkeypatch):
    """The raw merge's size classes (one window, parts by doc, the radix
    passes of a descending slot) on int32 docs and f32 impacts."""
    monkeypatch.setattr(merge_kernel, "EXACT_WINDOW_CAP", window_cap)
    fd, fi, rows, mins, d_pad, _, _ = cases.exact_window_case(
        np.random.default_rng(101), case)
    pos, static = cases.raw_args(fd, fi, rows, mins, d_pad)
    for k in (7, 400):
        got, want = raw_pair(pos, static, k, cuda)
        cases.assert_bitwise(got, want, f"{case} k={k}")


@pytest.mark.parametrize("k", [10, 1024, 16384])
def test_raw_merge_wide_segment_matches_plain(cuda, k):
    """Rows of a 500,000-doc segment (19-bit docs) at full slot width:
    CHUNK_CAP-lane slots, a stop-word row of ~100 slots cut into parts,
    msm rows, kernel k up to 16,384 (shard_topk's device class)."""
    rng = np.random.default_rng(104)
    d_pad = 500_096
    fd, fi, ext = cases.make_flat(rng, 6, d_pad, 150_000)
    rows = [[(ext[t][0], ext[t][1], 0.5 + t, t) for t in range(6)],
            [(ext[t][0], ext[t][1], 1.0, t) for t in (0, 2, 4)],
            [(ext[3][0], ext[3][1], 2.0, 3)]]
    pos, static = cases.raw_args(fd, fi, rows, [1, 2, 1], d_pad,
                                 chunk_cap=4096)
    got, want = raw_pair(pos, static, k, cuda)
    cases.assert_bitwise(got, want, f"k={k}")


def test_sorted_merge_topk_packed_takes_the_raw_merge(cuda):
    """On a card "packed" launches the raw merge: bit-identical to the
    plain "packed" (the reference's contract), one raw_merge launch."""
    rng = np.random.default_rng(105)
    fd, fi, rows, mins, d_pad, k, _ = cases.make_case(rng)
    pos, static = cases.raw_args(fd, fi, rows, mins, d_pad)
    tpos = cases.to_torch(pos, cuda)
    before = merge_kernel.LAUNCHES["raw_merge"]
    got = sparse.sorted_merge_topk(*tpos, k=k, with_totals=True,
                                   variant="packed", **static)
    assert merge_kernel.LAUNCHES["raw_merge"] == before + 1
    want = merge_kernel.raw_merge_topk_plain(*tpos, k=k, with_totals=True,
                                             packed=True, **static)
    cases.assert_bitwise(got, want, "packed")


@pytest.mark.parametrize("pack_keys", [False, True], ids=["gid", "u32_key"])
@pytest.mark.parametrize("size", ["small", "full_width", "prefix_wide"])
def test_pruned_candidates_match_plain(cuda, pack_keys, size):
    """Phase A of a group: a few hundred lanes a query (one block each),
    full_width (2 rows x 32 slots of CHUNK_CAP lanes, ~100,000 lanes a
    query: part blocks, then a band block per band) or prefix_wide (2
    rows x 128 slots of 4,096 lanes, up to ~1M lanes a query: hundreds
    of parts and bands), run sums, the candidates' top-k."""
    rng = np.random.default_rng(106)
    if size == "small":
        arrays, static = cases.candidates_case(rng)
        ks = (9, 200)
    elif size == "full_width":
        arrays, static = cases.candidates_case(
            rng, g=2, t_slots=32, d_pad=20_000, max_len=4096, b=8,
            n_terms=24, max_df=6000)
        ks = (128, 2048)
    else:
        arrays, static = cases.candidates_case(
            rng, g=2, t_slots=128, d_pad=500_096, max_len=4096, b=4,
            n_terms=128, max_df=8192)
        ks = (1024,)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    for k in ks:
        kw = dict(static, k=k, pack_keys=pack_keys and size != "prefix_wide")
        before = merge_kernel.LAUNCHES["pruned_candidates"]
        stats = {}
        got = merge_kernel.pruned_candidates(*args, stats=stats, **kw)
        torch.cuda.synchronize()
        assert merge_kernel.LAUNCHES["pruned_candidates"] == before + 1
        want = merge_kernel.pruned_candidates_plain(*args, **kw)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        live = want[0] > float("-inf")
        assert torch.equal(got[1][live], want[1][live])
        assert torch.equal(got[2], want[2])
        if size == "prefix_wide":
            assert stats["cand_blocks"]["cand_band"] > 500
            assert stats["cand_classes"]["cand.bands"] >= 1


@pytest.mark.parametrize("pack_keys", [False, True], ids=["gid", "u32_key"])
@pytest.mark.parametrize("sizes", [("bands", (64, 32), (3, 2, 1)),
                                   ("one_part", (64, 4096), (3, 2, 1))],
                         ids=lambda s: s[0])
def test_pruned_candidates_classes_match_plain(cuda, sizes, pack_keys,
                                               monkeypatch):
    """The classes at shrunk thresholds on the card, as the emulated
    test runs them: one block a query, bands in shared memory over
    several parts, a band past its cap in device memory (the look-back
    over a query's bands running truly in parallel here)."""
    _, (cap, part), classes = sizes
    monkeypatch.setattr(merge_kernel, "CAND_BAND_CAP", cap)
    monkeypatch.setattr(merge_kernel, "CAND_PART_LANES", part)
    arrays, static = cases.banded_candidates_case(np.random.default_rng(108))
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    for k in (9, 300):
        kw = dict(static, k=k, pack_keys=pack_keys)
        stats = {}
        got = merge_kernel.pruned_candidates(*args, stats=stats, **kw)
        want = merge_kernel.pruned_candidates_plain(*args, **kw)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        live = want[0] > float("-inf")
        assert torch.equal(got[1][live], want[1][live])
        assert torch.equal(got[2], want[2])
        assert tuple(stats["cand_classes"].values()) == classes


@pytest.mark.parametrize("c", [40, 128, 2048, 4096])
@pytest.mark.parametrize("mode", ["score_and_order", "score", "order"])
def test_pruned_rescore_matches_plain(cuda, mode, c):
    ds, tg, tr, tv, kw = cases.rescore_case(np.random.default_rng(107),
                                            c=c, b=16, device=cuda)
    exact = merge_kernel.pruned_rescore_plain(*ds, tg, *tr, **kw)
    before = merge_kernel.LAUNCHES["pruned_rescore"]
    if mode == "score":
        got = merge_kernel.pruned_rescore(*ds, tg, *tr, **kw)
        assert torch.equal(got.view(torch.int32), exact.view(torch.int32))
    elif mode == "order":
        exact[:, 30] = exact[:, 31]
        got = merge_kernel.pruned_order(exact, tv, tg, k=100)
        want = merge_kernel.pruned_order_plain(exact, tv, tg, k=100)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])
    else:
        got = merge_kernel.pruned_rescore(*ds, tg, *tr, cand_vals=tv, k=100,
                                          **kw)
        want = merge_kernel.pruned_rescore_plain(*ds, tg, *tr, cand_vals=tv,
                                                 k=100, **kw)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])
    torch.cuda.synchronize()
    assert merge_kernel.LAUNCHES["pruned_rescore"] == before + 1


@pytest.mark.parametrize("t_terms", [1, 8, 32])
def test_pruned_rescore_spread_matches_plain(cuda, t_terms):
    """The scores spread over blocks of 256 / T_terms candidates at one,
    the service's and the most terms the kernel takes, then the order
    launch: scores and the (-score, gid) order bit for bit."""
    ds, tg, tr, tv, kw = cases.rescore_case(
        np.random.default_rng(111), c=1000, b=8, t_terms=t_terms,
        n_terms=max(10, t_terms), device=cuda)
    exact = merge_kernel.pruned_rescore_plain(*ds, tg, *tr, **kw)
    got = merge_kernel.pruned_rescore(*ds, tg, *tr, **kw)
    assert torch.equal(got.view(torch.int32), exact.view(torch.int32))
    stats = {}
    got = merge_kernel.pruned_rescore(*ds, tg, *tr, cand_vals=tv, k=500,
                                      stats=stats, **kw)
    want = merge_kernel.pruned_rescore_plain(*ds, tg, *tr, cand_vals=tv,
                                             k=500, **kw)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert stats["rescore_classes"]["rescore.spread"] == 8
    assert all(n >= 1 for n in stats["rescore_blocks_per_sm"].values())
