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

from elasticsearch_tpu_torch.ops import merge_kernel

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
    """(emulated kernels, plain version, size classes) on CPU operands."""
    tpos = cases.to_torch(pos)
    kw = dict(static, k=k, with_totals=with_totals,
              **cases.to_torch(extra))
    full = dict(kw)
    for name in OPTIONAL:
        full.setdefault(name, None)
    stats = {}
    got = merge_kernel._launch(*tpos, stats=stats, events=None, **full)
    want = merge_kernel.fused_merge_topk_plain(*tpos, **kw)
    return got, want, stats["classes"]


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
    trimmed finalists) and one of 17,900 keys (device-memory sort and
    selection, rescore restaged by slot group), with the block-max skip
    on; at k = 4000 the short row needs no selection and keeps all."""
    rng = np.random.default_rng(7)
    d_pad = 20000
    fd, fi, ext = cases.make_heavy_flat(rng, d_pad, [900, 9000, 8000],
                                        skew=1.0)
    rows = [[(ext[0][0], ext[0][1], 1.0, 0)],
            [(ext[t][0], ext[t][1], 1.0 + t, t) for t in range(3)]]
    pos, extra, static = cases.kernel_args(fd, fi, rows, [1, 1], d_pad,
                                           ext)
    got, want, classes = run_pair(pos, extra, static, 40)
    cases.assert_bitwise(got, want)
    assert all(classes[c] > 0 for c in merge_kernel.SIZE_CLASSES
               if c not in ("select.none", "final.all")), classes
    got, want, classes = run_pair(pos, extra, static, 4000)
    cases.assert_bitwise(got, want)
    assert classes["select.none"] == 1 and classes["final.all"] == 1


@pytest.mark.parametrize("fault", ["k", "length"])
def test_launch_refuses_what_the_kernels_do_not_take(emulated, fault):
    """k past K_LIMIT, or a slot longer than max_len (the lane decode and
    the staged rescore window hold max_len lanes), raise before a launch."""
    rng = np.random.default_rng(5)
    fd, fi, rows, mins, d_pad, k, ext = cases.make_case(rng)
    pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad, ext,
                                           chunk_cap=64)
    if fault == "k":
        k, match = merge_kernel.K_LIMIT + 1, "k ≤"
    else:
        pos[3] = pos[3].copy()
        pos[3][0, 0] = static["max_len"] + 1
        match = "max_len"
    before = dict(merge_kernel.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        run_pair(pos, extra, static, k)
    assert merge_kernel.LAUNCHES == before
