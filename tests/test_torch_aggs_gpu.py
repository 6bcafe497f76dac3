"""The aggregation kernels (``csrc/aggs.cu``) on the card against their
plain versions, bit for bit, and a three-shard aggregation index on the
card against the same index on the CPU, response bytes (gpu-marked: skips
without a CUDA device; it imports no JAX, so it runs where JAX is
missing).

``test_torch_agg_ops.py`` holds the plain versions against the reference
on the CPU. These cover each kernel's traps on the card: ±0, ±inf, NaN
(missing) and subnormal values (DAZ / FTZ), int64 values past 2^53 and
MISSING_I64, bucket edges and out-of-range quotients, a power-of-two
boundary count, K1's shared and device-memory counts, the sum's levels
(7 to 1,000,003 values) and K3 at 5 and 65,536 ordinals with an empty
mask. The index's DELETE gives back the memory its cached columns held.
"""

import gc
import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import agg_kernel

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, n)
    f[rng.random(n) < 0.05] = np.nan
    f[::11] = -0.0
    f[::13] = 0.0
    f[5::97] = np.inf
    f[7::101] = -np.inf
    f[3 % n] = -1e-310
    i = rng.integers(-2 ** 60, 2 ** 60, n)
    i[::17] = agg_kernel.MISSING_I64
    i[1::19] = 2 ** 53 + 1
    m = rng.random(n) < 0.6
    return (torch.from_numpy(f), torch.from_numpy(i), torch.from_numpy(m),
            rng)


def _same(cpu_parts, card_parts):
    for a, b in zip(cpu_parts, card_parts):
        assert a.dtype == b.dtype
        assert a.numpy().tobytes() == b.cpu().numpy().tobytes()


@pytest.mark.parametrize("n", [7, 1_000, 65_539, 1_000_003])
def test_masked_stats_on_the_card_match_plain(cuda, n):
    f, i, m, _ = _columns(n, n)
    for col in (f, i):
        for mask in (m, torch.zeros_like(m)):
            _same(agg_kernel.masked_stats(mask, col),
                  agg_kernel.masked_stats(mask.to(cuda), col.to(cuda)))


@pytest.mark.parametrize("n_out", [8, 16_384, 65_536])
def test_ord_stats_on_the_card_match_plain(cuda, n_out):
    n = 200_001
    f, i, m, rng = _columns(n, n_out)
    hi = min(n_out, 5) if n_out == 8 else n_out
    o = torch.from_numpy(rng.integers(-1, hi, n).astype(np.int32))
    for col in (f, i):
        for mask in (m, torch.zeros_like(m)):
            _same(agg_kernel.ord_stats(mask, o, col, n_out),
                  agg_kernel.ord_stats(mask.to(cuda), o.to(cuda),
                                       col.to(cuda), n_out))


def test_ord_stats_on_the_card_flush_a_subnormal_partial_sum(cuda):
    ords = torch.tensor([0, 0, 0, 1, 1, 2, 2, 0, 3, 3] * 50,
                        dtype=torch.int32)
    col = torch.tensor([4.0e-308, -3.0e-308, 2.5e-308, -0.0, 0.0, -0.0,
                        -0.0, -2.5e-308, 1e-300, -1e-300] * 50, dtype=torch.float64)
    mask = torch.ones(len(col), dtype=torch.bool)
    _same(agg_kernel.ord_stats(mask, ords, col, 16),
          agg_kernel.ord_stats(mask.to(cuda), ords.to(cuda), col.to(cuda),
                               16))


@pytest.mark.parametrize("n_out", [16, 4_096, 65_536])
def test_bucket_counts_on_the_card_match_plain(cuda, n_out):
    n = 300_007
    f, i, m, rng = _columns(n, n_out)
    o = torch.from_numpy(rng.integers(-1, n_out, n).astype(np.int32))
    for mode in ("terms", "presence"):
        _same([agg_kernel.bucket_counts(m, o, mode, n_out)],
              [agg_kernel.bucket_counts(m.to(cuda), o.to(cuda), mode,
                                        n_out)])
    for col in (f, i):
        for base, interval in ((0.0, 1.0), (-3.0, 0.5), (1e15, 1e14),
                               (0.0, float("inf"))):
            _same([agg_kernel.bucket_counts(m, col, "histogram", n_out,
                                            base=base, interval=interval)],
                  [agg_kernel.bucket_counts(m.to(cuda), col.to(cuda),
                                            "histogram", n_out, base=base,
                                            interval=interval)])
        for nb in (5, n_out):
            b = np.full(n_out, float(np.iinfo(np.int64).max))
            b[:nb] = np.sort(rng.standard_normal(nb) * 1e18)
            bounds = torch.from_numpy(b)
            _same([agg_kernel.bucket_counts(m, col, "bounded", n_out,
                                            bounds=bounds)],
                  [agg_kernel.bucket_counts(m.to(cuda), col.to(cuda),
                                            "bounded", n_out,
                                            bounds=bounds.to(cuda))])


def test_three_shard_agg_index_card_bytes_match_cpu(cuda, tmp_path):
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.search.serializer import dumps_response

    nodes = {"cpu": Node(str(tmp_path / "cpu"), device="cpu"),
             "cuda": Node(str(tmp_path / "cuda"), device="cuda")}
    mem_before = torch.cuda.memory_allocated()
    rng = np.random.default_rng(7)
    lines = []
    for d in range(3_000):
        lines.append(json.dumps({"index": {"_id": str(d)}}))
        lines.append(json.dumps({
            "tag": f"t{int(rng.zipf(1.5)) % 40}",
            "views": int(rng.integers(0, 10 ** 6)),
            "price": float(rng.standard_normal() * 100),
            "published": int(1_600_000_000_000 + rng.integers(0, 3 * 10 ** 10)),
            "body": " ".join(rng.choice(["a", "b", "c", "d"], 5))}))
    bulk = ("\n".join(lines) + "\n").encode()
    mapping = {"settings": {"number_of_shards": 3}, "mappings": {
        "properties": {"tag": {"type": "keyword"}, "views": {"type": "long"},
                       "price": {"type": "double"},
                       "published": {"type": "date"},
                       "body": {"type": "text"}}}}
    for node in nodes.values():
        node.handle("PUT", "/aggs", {}, None, json.dumps(mapping).encode())
        node.handle("POST", "/aggs/_bulk", {}, None, bulk)
        node.handle("POST", "/aggs/_refresh", {}, None, b"")
    bodies = [
        {"size": 0, "aggs": {"t": {"terms": {"field": "tag"}, "aggs": {
            "a": {"avg": {"field": "views"}},
            "m": {"max": {"field": "price"}}}}}},
        {"size": 0, "aggs": {"s": {"stats": {"field": "price"}},
                             "v": {"sum": {"field": "views"}},
                             "c": {"cardinality": {"field": "tag"}}}},
        {"size": 0, "aggs": {"h": {"histogram": {"field": "price",
                                                 "interval": 25}}}},
        {"size": 0, "aggs": {"m": {"date_histogram": {
            "field": "published", "calendar_interval": "month"}}}},
        {"size": 3, "query": {"match": {"body": "a"}},
         "aggs": {"w": {"date_histogram": {"field": "published",
                                           "fixed_interval": "7d"}}}},
    ]
    try:
        agg_kernel.reset_launches()
        for body in bodies:
            raw = json.dumps(body).encode()
            out = {}
            for name, node in nodes.items():
                status, payload = node.handle("POST", "/aggs/_search", {},
                                              None, raw)
                payload["took"] = 0
                out[name] = (status, dumps_response(payload))
            assert out["cuda"] == out["cpu"], body
        assert all(agg_kernel.LAUNCHES[k] > 0 for k in agg_kernel.KERNELS)
        # DELETE gives back the columns the aggregations cached
        status, _ = nodes["cuda"].handle("DELETE", "/aggs", {}, None, b"")
        assert status == 200
        gc.collect()
        assert nodes["cuda"].breakers.get_breaker("hbm").used == 0
        assert torch.cuda.memory_allocated() == mem_before
    finally:
        for node in nodes.values():
            node.close()
