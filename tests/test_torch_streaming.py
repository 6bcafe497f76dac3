"""A small streaming drill of the port (tier-1 size): a writer thread
streaming unique docs, a refresher forming delta packs, readers on the
kernel path (the plain path on the CPU), a background compactor folding
the chain, and one disk-full window on the translog. It ends with:

- no acked write lost, and every acked write searchable;
- refused writes (the disk-full window) never acked, never readable;
- a bounded search-visible lag;
- the final fold bit-identical to a full-rebuild oracle (a delta-off
  service over the same readers);
- the ``hbm`` breaker at exactly 0 after the index is deleted.

The reference's drill (tests/test_chaos_streaming.py) also kills the
micro-batcher and checks the flight recorder's kill → recover → replay
→ checkpoint chain; those wait for the port's supervisor and flight
recorder.
"""

import threading
import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.common.breaker import CircuitBreaker
from elasticsearch_tpu_torch.common.errors import TranslogDurabilityException
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.indices.service import IndicesService
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.gpu_service import GpuSearchService

from test_torch_translog_visibility import disk_full

pytestmark = pytest.mark.streaming

torch.set_num_threads(1)

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]


def _wait(predicate, timeout=20.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def test_streaming_drill(tmp_path):
    svc = IndicesService(str(tmp_path))
    # one shard and a slow refresh cycle: every refresh adds a segment,
    # and the plain path's cost grows with the pack's rows
    idx = svc.create_index("stream", Settings.of(
        {"index": {"number_of_shards": 1}}),
        {"properties": {"body": {"type": "text"}}})
    rng = np.random.default_rng(11)
    for i in range(60):
        words = [WORDS[int(w)] for w in rng.integers(0, len(WORDS), 6)]
        idx.shard(idx.shard_for_id(f"d{i}")).apply_index_on_primary(
            f"d{i}", {"body": " ".join(words)})
    idx.refresh()
    breaker = CircuitBreaker("hbm", 1 << 30)
    tpu = GpuSearchService(device="cpu", window_s=0.0,
                           batch_timeout_s=120.0, breaker=breaker,
                           delta={"enabled": True, "max_packs": 2})
    oracle = None
    key = ("stream", "body")
    q_new = dsl.MatchQuery(field="body", query="omega")
    try:
        assert tpu.try_search(idx, dsl.MatchQuery(
            field="body", query="alpha beta"), k=10).total_hits > 0
        stop = threading.Event()
        acked, refused, errors = [], [], []

        def writer():
            i = 0
            while not stop.is_set():
                doc_id = f"w{i}"
                try:
                    idx.shard(idx.shard_for_id(doc_id)) \
                        .apply_index_on_primary(doc_id,
                                                {"body": "omega omega"})
                    acked.append(doc_id)
                except TranslogDurabilityException:
                    refused.append(doc_id)   # inside the disk-full window
                except Exception as e:  # noqa: BLE001 — surfaced below
                    errors.append(("write", e))
                i += 1
                time.sleep(0.005)

        def refresher():
            while not stop.is_set():
                try:
                    idx.refresh()
                except Exception as e:  # noqa: BLE001 — surfaced below
                    errors.append(("refresh", e))
                time.sleep(0.25)

        def reader():
            while not stop.is_set():
                try:
                    tpu.try_search(idx, q_new, k=10)
                except Exception as e:  # noqa: BLE001 — surfaced below
                    errors.append(("read", e))
                time.sleep(0.02)

        threads = [threading.Thread(target=writer),
                   threading.Thread(target=refresher)]
        threads.append(threading.Thread(target=reader))
        for t in threads:
            t.start()
        try:
            assert _wait(lambda: tpu.delta_stats.appends >= 2), \
                "traffic formed no delta chain"
            refused_before = len(refused)
            with disk_full(idx):
                time.sleep(0.3)
            assert len(refused) > refused_before, \
                "the disk-full window refused no write"
            acked_at_heal = len(acked)
            assert _wait(lambda: len(acked) > acked_at_heal), \
                "writes never resumed after the disk healed"
            assert _wait(lambda: tpu.delta_stats.compactions >= 1), \
                "the compactor never folded the chain"
            # a loaded host may fold the chain before 50 writes are in:
            # the traffic runs on until the last check's count is reached
            _wait(lambda: len(acked) > 50)
            time.sleep(0.3)   # the refresh cycle covers the healed writes
            lag_p99 = max(
                s.engine.stats()["search_visible_lag_seconds"]["p99"]
                for s in idx.shards.values())
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60.0)
        assert not [t for t in threads if t.is_alive()]
        assert not errors, f"traffic errors: {errors[:3]}"
        assert tpu.delta_stats.compaction_failures == 0
        lost = [d for d in acked
                if idx.shard(idx.shard_for_id(d)).get(d) is None]
        assert not lost, f"lost {len(lost)} acked writes"
        ghosts = [d for d in refused
                  if idx.shard(idx.shard_for_id(d)).get(d) is not None]
        assert not ghosts, f"refused writes became visible: {ghosts[:5]}"
        idx.refresh()
        for shard in idx.shards.values():
            eng = shard.engine
            # refused seqnos were closed as gaps: the watermark is whole
            assert eng.refresh_checkpoint == eng.tracker.max_seq_no
        assert lag_p99 < 5.0, f"p99 visible lag {lag_p99:.2f}s"

        # a quiescent point: the compactor idle, the last chain folded
        assert _wait(tpu.compaction_idle)
        tpu.try_search(idx, q_new, k=10)
        tpu.packs.compact(key)
        assert tpu.stats()["deltas"]["packs"] == 0
        oracle = GpuSearchService(device="cpu", window_s=0.0,
                                  batch_timeout_s=120.0)
        got = tpu.try_search(idx, q_new, k=64)
        want = oracle.try_search(idx, q_new, k=64)
        assert got.total_hits == want.total_hits == len(acked)
        assert got.resident.resolve_ids(got.rows, got.ords).tolist() == \
            want.resident.resolve_ids(want.rows, want.ords).tolist()
        np.testing.assert_array_equal(got.scores.view(np.uint32),
                                      want.scores.view(np.uint32))
        assert len(acked) > 50 and refused

        svc.delete_index("stream")
        tpu.invalidate_index("stream")
        assert breaker.used == 0
    finally:
        if oracle is not None:
            oracle.close()
        tpu.close()
        svc.close()
