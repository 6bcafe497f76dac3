"""The rarer field types' device arithmetic on the card against the CPU
plain path, bit for bit (gpu-marked: skips without a CUDA device; it
imports no JAX, so it runs where JAX is missing).

``tests/test_torch_rare_fields_parity.py`` holds the CPU path against
the reference; these hold the card against the CPU: ``xla_powf`` over a
sweep (special values and the negative-base NaN among them),
``geo.distance_mask`` with points on the radius, ``top_k_plain`` on rows
with NaN of both signs and signed zeros (the card's ``shard_topk``
kernel against it is in ``test_torch_merge_kernel.py``), and
``SegmentQueryExecutor`` over a seeded segment of every rarer type.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.index.reader import ShardReader
from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops import geo, sparse
from elasticsearch_tpu_torch.ops.xla_math import xla_powf
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.planner import SegmentQueryExecutor

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def bits(t):
    return t.cpu().contiguous().view(torch.int32).numpy()


def test_powf_on_the_card_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    x = np.concatenate([10.0 ** rng.uniform(-38, 38, 200_000),
                        rng.uniform(0.5, 2.0, 100_000),
                        -rng.uniform(0, 8, 1000),
                        [0.0, -0.0, 1.0, np.inf, 1e-40, 2.0 ** -126]]
                       ).astype(np.float32)
    cpu = torch.from_numpy(x)
    for y in (0.6, 0.25, 1.7, 3.0, -0.5, 2.0):
        np.testing.assert_array_equal(bits(xla_powf(cpu.to(cuda), y)),
                                      bits(xla_powf(cpu, y)), err_msg=y)


def test_distance_mask_on_the_card_matches_cpu(cuda):
    rng = np.random.default_rng(6)
    lat = torch.from_numpy(rng.uniform(-90, 90, 100_000))
    lon = torch.from_numpy(rng.uniform(-180, 180, 100_000))
    lat[::97] = float("nan")
    for q in ((48.85, 2.35), (0.0, 179.9), (-89.0, 10.0)):
        for j in range(3):
            r = geo.reference_distance(float(lat[j + 1]), float(lon[j + 1]),
                                       *q)
            for radius in (r, np.nextafter(r, 0.0), 2.0e7):
                got = geo.distance_mask(lat.to(cuda), lon.to(cuda), *q,
                                        float(radius)).cpu()
                assert torch.equal(got, geo.distance_mask(lat, lon, *q,
                                                          float(radius)))


def test_top_k_plain_on_the_card_ranks_as_on_cpu(cuda):
    nn = np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0]
    rng = np.random.default_rng(7)
    x = rng.choice(np.array([0.0, -0.0, nn, np.nan, -np.inf, np.inf, 1.0,
                             -1.0, 2.5], dtype=np.float32), size=(8, 5000))
    cpu = torch.from_numpy(x)
    for k in (1, 10, 5000):
        gv, gp = sparse.top_k_plain(cpu.to(cuda), k)
        wv, wp = sparse.top_k_plain(cpu, k)
        assert torch.equal(gp.cpu(), wp)
        np.testing.assert_array_equal(bits(gv), bits(wv))


MAPPING = {"properties": {
    "pr": {"type": "rank_feature"},
    "cost": {"type": "rank_feature", "positive_score_impact": False},
    "views": {"type": "long"}, "loc": {"type": "geo_point"},
    "addr": {"type": "ip"}, "span": {"type": "integer_range"},
    "band": {"type": "double_range"}}}

BODIES = [
    {"rank_feature": {"field": "pr"}},
    {"rank_feature": {"field": "pr", "log": {"scaling_factor": 2.0}}},
    {"rank_feature": {"field": "pr", "sigmoid": {"pivot": 3.0,
                                                 "exponent": 0.6}}},
    {"rank_feature": {"field": "cost", "sigmoid": {"pivot": 0.5,
                                                   "exponent": 1.7}}},
    {"rank_feature": {"field": "views", "sigmoid": {"pivot": 9.0,
                                                    "exponent": 0.5}}},
    {"geo_distance": {"distance": "2500km", "loc": [10.0, 50.0]}},
    {"geo_bounding_box": {"loc": {"top": 40, "left": 160, "bottom": -40,
                                  "right": -160}}},
    {"term": {"addr": "10.0.0.0/8"}},
    {"range": {"addr": {"gte": "::", "lt": "::ffff:128.0.0.0"}}},
    {"range": {"span": {"gte": 5, "lte": 9, "relation": "within"}}},
    {"range": {"band": {"gte": 2.5, "lte": 3.0, "relation": "contains"}}},
]


@pytest.fixture(scope="module")
def reader():
    rng = np.random.default_rng(8)
    ms = MapperService(MAPPING)
    w = SegmentWriter("s0")
    for i in range(3000):
        lo = int(rng.integers(0, 20))
        doc = {"views": int(rng.integers(-50, 500)),
               "loc": {"lat": float(rng.uniform(-90, 90)),
                       "lon": float(rng.uniform(-180, 180))},
               "addr": (f"10.{i % 256}.0.{i % 7}" if i % 3
                        else f"2001:db8::{i:x}"),
               "span": {"gte": lo, "lte": lo + int(rng.integers(0, 6))},
               "band": {"gte": lo / 2, "lt": lo / 2 + 3.0}}
        if i % 7:
            doc["pr"] = float(10.0 ** rng.uniform(-20, 20))
            doc["cost"] = float(rng.uniform(0.01, 100))
        w.add_document(ms.parse_document(f"d{i}", doc), ms.dv_kinds())
    live = np.ones(3000, dtype=bool)
    live[::11] = False
    return ShardReader([(w.freeze(), live)], ms)


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_executor_on_the_card_matches_cpu(cuda, reader, i):
    q = dsl.parse_query(BODIES[i])
    gm, gs = SegmentQueryExecutor(reader, 0, cuda).execute(q)
    wm, ws = SegmentQueryExecutor(reader, 0, "cpu").execute(q)
    assert torch.equal(gm.cpu(), wm)
    np.testing.assert_array_equal(bits(gs), bits(ws))
