"""Translog-gated visibility and ``index.translog.durability`` in the
port: port copies of tests/test_translog_visibility.py.

An op is searchable once a refresh checkpoint covers its seqno, and
searchable-durable once its translog record is fsync'd too: under
durability=async those are two moments, and the async path must say
so. Also: the knob's static and dynamic validation, a disk-full write
refusing the ack through the async path (the fault comes from a port-side
stand-in for the translog's file, whose writes fail with ENOSPC), the
replay-tail audit's counts, and ``refresh=wait_for`` riding the node's
refresh cycle (and refreshing itself when no cycle runs). The
reference's assertions on its flight recorder's ``translog.replay`` and
``refresh.checkpoint`` events wait for the port's flight recorder.
"""

import contextlib
import errno
import json
import os
import threading

import pytest

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException, TranslogDurabilityException)
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.indices.service import (IndexService,
                                                     IndicesService)
from elasticsearch_tpu_torch.node import Node

pytestmark = pytest.mark.streaming

_MAPPING = {"properties": {"body": {"type": "text"}}}


class _FullDisk:
    """Stands in for a translog's open file: every write fails ENOSPC."""

    def __init__(self, real):
        self.real = real

    def write(self, data):
        raise OSError(errno.ENOSPC, os.strerror(errno.ENOSPC))

    flush = write

    def __getattr__(self, name):
        return getattr(self.real, name)


@contextlib.contextmanager
def disk_full(*indices):
    """Every translog of `indices` refuses writes inside the body; the
    files come back on exit."""
    logs = [s.engine.translog for idx in indices
            for s in idx.shards.values()]
    for tl in logs:
        with tl._lock:
            tl._file = _FullDisk(tl._file)
    try:
        yield
    finally:
        for tl in logs:
            with tl._lock:
                tl._file = tl._file.real


@pytest.fixture
def svc(tmp_path):
    s = IndicesService(str(tmp_path))
    yield s
    s.close()


def _make(svc, name, durability="async", shards=1, **extra):
    tl = {"durability": durability}
    tl.update(extra)
    return svc.create_index(
        name, Settings.of({"index": {"number_of_shards": shards,
                                     "translog": tl}}), _MAPPING)


class TestDurabilityKnob:
    def test_async_accepted_and_plumbed(self, svc):
        idx = _make(svc, "a", durability="async", sync_interval_seconds=0.2)
        shard = idx.shard(0)
        assert shard.engine.translog.durability == "async"
        assert idx.sync_interval_s == pytest.approx(0.2)

    def test_invalid_value_rejected(self, svc):
        with pytest.raises(IllegalArgumentException,
                           match=r"index\.translog\.durability"):
            _make(svc, "bad", durability="sometimes")

    def test_dynamic_update_validated_and_applied(self, svc):
        idx = _make(svc, "d", durability="request")
        with pytest.raises(IllegalArgumentException):
            IndexService.validate_dynamic_settings(
                {"index.translog.durability": "never"})
        IndexService.validate_dynamic_settings(
            {"index.translog.durability": "async"})
        idx.apply_dynamic_settings({"index.translog.durability": "async"})
        assert idx.shard(0).engine.translog.durability == "async"
        assert idx.shard(0).engine.config.durability == "async"
        assert idx.settings.get("index.translog.durability") == "async"


class TestAsyncPathHonest:
    def test_visible_durable_lags_until_sync(self, svc):
        """Under async durability the op is searchable at the refresh but
        searchable-durable only after the translog fsync."""
        idx = _make(svc, "h")
        shard = idx.shard(0)
        res = shard.apply_index_on_primary("x1", {"body": "alpha"})
        assert res.seq_no == 0
        eng = shard.engine
        assert eng.refresh_checkpoint == -1
        assert eng.visible_durable_checkpoint == -1
        shard.refresh()
        assert eng.refresh_checkpoint == 0
        assert eng.tracker.persisted_checkpoint == -1
        assert eng.visible_durable_checkpoint == -1
        eng.sync_translog()
        assert eng.tracker.persisted_checkpoint == 0
        assert eng.visible_durable_checkpoint == 0
        assert eng.stats()["translog"]["uncommitted_operations"] == 0

    def test_request_path_durable_at_ack(self, svc):
        idx = _make(svc, "r", durability="request")
        shard = idx.shard(0)
        shard.apply_index_on_primary("x1", {"body": "alpha"})
        assert shard.engine.tracker.persisted_checkpoint == 0
        # searchability still waits for the refresh
        assert shard.engine.visible_durable_checkpoint == -1
        shard.refresh()
        assert shard.engine.visible_durable_checkpoint == 0

    def test_disk_full_refuses_ack_through_async_path(self, svc):
        """Async buffering does not swallow write faults: the append
        fails typed and the op is never acked."""
        idx = _make(svc, "f")
        shard = idx.shard(0)
        shard.apply_index_on_primary("ok", {"body": "alpha"})
        with disk_full(idx):
            with pytest.raises(TranslogDurabilityException,
                               match="not acknowledged"):
                shard.apply_index_on_primary("lost", {"body": "beta"})
        # healed: writes flow again, and the refused op never happened
        res = shard.apply_index_on_primary("ok2", {"body": "gamma"})
        shard.refresh()
        assert shard.get("lost") is None
        assert shard.get("ok2") is not None
        assert shard.engine.tracker.processed_checkpoint == res.seq_no
        assert shard.engine.refresh_checkpoint == res.seq_no


class TestWaitForVisible:
    def test_times_out_without_refresh(self, svc):
        idx = _make(svc, "w")
        shard = idx.shard(0)
        res = shard.apply_index_on_primary("x", {"body": "alpha"})
        assert shard.wait_for_visible(res.seq_no, timeout_s=0.2) is False

    def test_wakes_on_refresh(self, svc):
        idx = _make(svc, "w2")
        shard = idx.shard(0)
        res = shard.apply_index_on_primary("x", {"body": "alpha"})
        t = threading.Timer(0.25, shard.refresh)
        t.start()
        try:
            assert shard.wait_for_visible(res.seq_no, timeout_s=5.0) is True
        finally:
            t.cancel()

    def test_close_releases_waiters(self, svc):
        idx = _make(svc, "w3")
        shard = idx.shard(0)
        res = shard.apply_index_on_primary("x", {"body": "alpha"})
        t = threading.Timer(0.2, shard.close)
        t.start()
        try:
            assert shard.wait_for_visible(res.seq_no, timeout_s=5.0) is False
        finally:
            t.cancel()


class TestReplayTail:
    def test_replay_audit_counts(self, svc):
        """replay_tail scans the durable tail above the refresh
        checkpoint, applies what the engine lacks (nothing, in a live
        engine: a pure audit) and advances the checkpoint."""
        idx = _make(svc, "rp", durability="request")
        shard = idx.shard(0)
        for i in range(3):
            shard.apply_index_on_primary(f"a{i}", {"body": "alpha"})
        shard.refresh()
        for i in range(4):
            shard.apply_index_on_primary(f"b{i}", {"body": "beta"})
        out = shard.replay_visibility(reason="test recovery")
        assert out == {"scanned": 4, "applied": 0}
        assert shard.engine.refresh_checkpoint == 6
        assert shard.engine.replayed_ops == 4
        assert idx.replay_visibility() == {"scanned": 0, "applied": 0}

    def test_unsynced_async_ops_are_not_replayable(self, svc):
        """An op still in the process buffer is not durable, so the
        replay scan does not claim it."""
        idx = _make(svc, "rp2")
        shard = idx.shard(0)
        shard.apply_index_on_primary("u", {"body": "alpha"})
        out = shard.replay_visibility(reason="audit")
        assert out["scanned"] == 0
        # a synced op above the checkpoint is scanned by the next audit
        shard.apply_index_on_primary("v", {"body": "beta"})
        shard.engine.sync_translog()
        out = shard.replay_visibility(reason="audit")
        assert out["scanned"] == 1 and out["applied"] == 0


class TestRestWaitFor:
    def _do(self, node, method, path, body=None, **params):
        raw = json.dumps(body).encode() if body is not None else b""
        return node.handle(method, path,
                           {k: str(v) for k, v in params.items()},
                           None, raw)

    def test_forced_refresh_fallback_without_refresher(self, tmp_path):
        node = Node(str(tmp_path / "data"), device="cpu")
        try:
            assert not node.refresher_active
            st, _ = self._do(node, "PUT", "/wf", body={
                "settings": {"index": {"number_of_shards": 1}}})
            assert st == 200
            st, _ = self._do(node, "PUT", "/wf/_doc/1",
                             body={"body": "alpha"}, refresh="wait_for")
            assert st in (200, 201)
            # no refresh cycle to wait on: the handler refreshed
            st, out = self._do(node, "POST", "/wf/_search", body={
                "query": {"match": {"body": "alpha"}}})
            assert st == 200 and out["hits"]["total"]["value"] == 1
        finally:
            node.close()

    def test_rides_refresh_cycle_with_refresher(self, tmp_path):
        node = Node(str(tmp_path / "data"), device="cpu",
                    settings=Settings.of(
                        {"index.refresh_interval_seconds": 0.1}))
        try:
            st, _ = self._do(node, "PUT", "/wf2", body={
                "settings": {"index": {"number_of_shards": 1}}})
            assert st == 200
            node.start_refresher()
            assert node.refresher_active
            eng = node.indices.indices["wf2"].shard(0).engine
            st, _ = self._do(node, "PUT", "/wf2/_doc/1",
                             body={"body": "alpha"}, refresh="wait_for")
            assert st in (200, 201)
            # visible when the write returns: the checkpoint covers it
            assert eng.refresh_checkpoint >= 0
            st, out = self._do(node, "POST", "/wf2/_search", body={
                "query": {"match": {"body": "alpha"}}})
            assert st == 200 and out["hits"]["total"]["value"] == 1

            # _bulk with refresh=wait_for keeps the same contract
            lines = (json.dumps({"index": {"_index": "wf2", "_id": "2"}})
                     + "\n" + json.dumps({"body": "beta"}) + "\n")
            st, out = node.handle("POST", "/_bulk",
                                  {"refresh": "wait_for"}, None,
                                  lines.encode())
            assert st == 200 and not out["errors"]
            st, out = self._do(node, "POST", "/wf2/_search", body={
                "query": {"match": {"body": "beta"}}})
            assert st == 200 and out["hits"]["total"]["value"] == 1
        finally:
            node.close()
