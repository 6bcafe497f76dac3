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
