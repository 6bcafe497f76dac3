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
    select all run."""
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
