"""The aggregation kernels' CUDA source (``csrc/aggs.cu``), run on the
host by ``tools/cuda_emu`` (a CUDA thread a fiber), against their plain
versions, bit for bit, at a few thousand rows.

K1 (agg_bucket_counts) in each mode, with its counts in shared memory
and, past K1_SMEM_BINS buckets (and with the cap shrunk), in device
memory; K2 (agg_masked_stats) at one, two and three levels of window
sums; K3 (agg_ord_stats) with one chunk, many chunks and a table cut by
K3_TABLE_CELLS; each over ±0, ±inf, NaN, subnormal, MISSING_I64 and
past-2^53 values, and an empty mask. The plain versions are held
against the reference in ``test_torch_agg_ops.py``, the kernels on the
card in ``test_torch_aggs_gpu.py``.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import agg_kernel
from elasticsearch_tpu_torch.tools import cuda_emu

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    with cuda_emu.emulated(tmp_path_factory.mktemp("aggs_emu"), "aggs"):
        yield


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, n)
    f[rng.random(n) < 0.05] = np.nan
    f[::11] = -0.0
    f[::13] = 0.0
    f[5::97] = np.inf
    f[7::101] = -np.inf
    f[3] = -1e-310
    i = rng.integers(-2 ** 60, 2 ** 60, n)
    i[::17] = agg_kernel.MISSING_I64
    i[1::19] = 2 ** 53 + 1
    m = rng.random(n) < 0.6
    return (torch.from_numpy(f), torch.from_numpy(i), torch.from_numpy(m),
            rng)


def _same(want, got):
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        assert w.numpy().tobytes() == g.numpy().tobytes()


@pytest.mark.parametrize("n", [40, 3_001, 40_000])
def test_masked_stats_kernel_matches_plain(emulated, n):
    f, i, m, _ = _columns(n, n)
    for col in (f, i):
        for mask in (m, torch.zeros_like(m)):
            _same(agg_kernel.masked_stats_plain(mask, col),
                  agg_kernel._launch_stats(mask, col))


@pytest.mark.parametrize("n_out,smem_bins", [(16, 12288), (64, 12288),
                                             (16_384, 12288), (64, 32)])
def test_bucket_counts_kernel_matches_plain(emulated, monkeypatch, n_out,
                                            smem_bins):
    monkeypatch.setattr(agg_kernel, "K1_SMEM_BINS", smem_bins)
    n = 3_001
    f, i, m, rng = _columns(n, n_out)
    o = torch.from_numpy(rng.integers(-1, n_out, n).astype(np.int32))
    for mode in ("terms", "presence"):
        for mask in (m, torch.zeros_like(m)):
            _same([agg_kernel.bucket_counts_plain(mask, o, mode, n_out)],
                  [agg_kernel._launch_counts(mask, o, mode, n_out)])
    for col in (f, i):
        for base, interval in ((0.0, 1.0), (-3.0, 0.5), (1e15, 1e14),
                               (0.0, float("inf"))):
            _same([agg_kernel.bucket_counts_plain(m, col, "histogram", n_out,
                                                  base, interval)],
                  [agg_kernel._launch_counts(m, col, "histogram", n_out,
                                             base, interval)])
        for nb in (5, n_out):
            b = np.full(n_out, float(np.iinfo(np.int64).max))
            b[:nb] = np.sort(rng.standard_normal(nb) * 1e18)
            bounds = torch.from_numpy(b)
            _same([agg_kernel.bucket_counts_plain(m, col, "bounded", n_out,
                                                  bounds=bounds)],
                  [agg_kernel._launch_counts(m, col, "bounded", n_out,
                                             bounds=bounds)])


@pytest.mark.parametrize("n_out,chunk_min,cells", [
    (16, 256, 1 << 24),      # 12 chunks of 256 docs
    (16, 4_096, 1 << 24),    # one chunk
    (1_024, 64, 4_096),      # the table cuts the chunks to 4
])
def test_ord_stats_kernel_matches_plain(emulated, monkeypatch, n_out,
                                        chunk_min, cells):
    monkeypatch.setattr(agg_kernel, "K3_CHUNK_MIN", chunk_min)
    monkeypatch.setattr(agg_kernel, "K3_TABLE_CELLS", cells)
    n = 3_001
    f, i, m, rng = _columns(n, n_out + chunk_min)
    o = torch.from_numpy(rng.integers(-1, min(n_out, 600), n)
                         .astype(np.int32))
    for col in (f, i):
        for mask in (m, torch.zeros_like(m)):
            _same(agg_kernel.ord_stats_plain(mask, o, col, n_out),
                  agg_kernel._launch_ord_stats(mask, o, col, n_out))


def test_ord_stats_kernel_flushes_a_subnormal_partial_sum(emulated):
    """A chain whose partial sum turns subnormal by cancellation (the
    kernel then walks it again with every add flushed), ±0 groups and
    an empty one."""
    ords = torch.tensor([0, 0, 0, 1, 1, 2, 2, 0, 3, 3] * 20,
                        dtype=torch.int32)
    col = torch.tensor([4.0e-308, -3.0e-308, 2.5e-308, -0.0, 0.0, -0.0,
                        -0.0, -2.5e-308, 1e-300, -1e-300] * 20, dtype=torch.float64)
    mask = torch.ones(len(col), dtype=torch.bool)
    _same(agg_kernel.ord_stats_plain(mask, ords, col, 16),
          agg_kernel._launch_ord_stats(mask, ords, col, 16))
