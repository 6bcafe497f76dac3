"""``profile``, ``timeout`` and the search slow log: port copy of
tests/test_profile_slowlog.py, the ``timeout`` cases, and
tests/test_dynamic_settings.py's slow-log threshold and logger level.

Where a case sends a search, the reference node and the port node get
the same requests (tests/torch_rest_pair.py) and the answers must be the
same bytes but for the timing fields, masked by name in both answers:
``took``, ``time_in_nanos`` (a shard's or an index's query and fetch
time), ``breakdown`` (its ``score`` is the query's time again),
``stages_ms`` (the kernel section's host stage times, the
batch_wait split among them), the timing values inside
``device_stages`` (each stage's ``seconds`` and percentiles: its name
and ``count`` are compared) and ``batch_wait_split``. The reference runs its kernel
path compiled by XLA (no interpreted Pallas), so that both name the
variant "compressed"; its Pallas interpreter spells the same kernel
"pallas".
"""

from __future__ import annotations

import json
import logging
import threading
import time

import pytest
import torch

from elasticsearch_tpu.search import tpu_service as ref_tpu
from elasticsearch_tpu.search.serializer import dumps_response as ref_dumps

from elasticsearch_tpu_torch.common.logging import (SEARCH_SLOWLOG, SlowLog,
                                                    configure)
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import sparse
from elasticsearch_tpu_torch.search import gpu_service
from elasticsearch_tpu_torch.search.serializer import dumps_response

from torch_rest_pair import Pair, call

torch.set_num_threads(1)

#: the timing fields masked in both answers, by key, wherever they are
TIMING_KEYS = ("took", "time_in_nanos", "breakdown", "stages_ms",
               "batch_wait_split")
#: inside ``device_stages`` (a stage name → its distribution), the timing
#: values; the stages' names and counts are compared
STAGE_TIMING_KEYS = ("seconds", "p50_ms", "p95_ms", "p99_ms")


def mask_timing(obj):
    if isinstance(obj, dict):
        return {k: "<timing>" if k in TIMING_KEYS
                else mask_stages(v) if k == "device_stages"
                else mask_timing(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [mask_timing(v) for v in obj]
    return obj


def mask_stages(stages):
    return {name: {k: "<timing>" if k in STAGE_TIMING_KEYS else v
                   for k, v in st.items()}
            for name, st in stages.items()}


def same(pair, method, path, body=None, params=None, raw=None):
    """Send to both nodes; the answers' bytes with the timing fields
    masked must be equal → (status, parsed port answer)."""
    s_ref, want = call(pair.ref, ref_dumps, method, path, body, raw, params)
    s_port, got = call(pair.port, dumps_response, method, path, body, raw,
                       params)
    want_j, got_j = json.loads(want), json.loads(got)
    assert s_port == s_ref, (want, got)
    assert json.dumps(mask_timing(got_j)) == json.dumps(
        mask_timing(want_j)), (want, got)
    return s_port, got_j


@pytest.fixture
def pair(tmp_path):
    saved = dict(ref_tpu.KERNEL_CONFIG)
    p = Pair(tmp_path, settings={"search.tpu_serving.kernel.pallas": False,
                                 "search.tpu_serving.batch_window_seconds":
                                     0.0})
    try:
        yield p
    finally:
        p.close()
        ref_tpu.KERNEL_CONFIG.clear()
        ref_tpu.KERNEL_CONFIG.update(saved)


@pytest.fixture
def node(tmp_data_path):
    n = Node(str(tmp_data_path), device="cpu")
    yield n
    n.close()


def _handle(node, method, path, params=None, body=None):
    raw = json.dumps(body).encode("utf-8") if body is not None else b""
    return node.handle(method, path, params, None, raw)


def seed(pair, index="p", n=8):
    for i in range(n):
        pair.both("PUT", f"/{index}/_doc/{i}",
                  {"msg": "profiled query text", "n": i},
                  params={"refresh": "true"})


class TestProfile:
    def test_profile_shape(self, pair):
        """The planner path (a sorted body): one entry a shard with its
        query and fetch, the reference's bytes."""
        seed(pair)
        status, res = same(pair, "POST", "/p/_search", {
            "query": {"match": {"msg": "profiled"}}, "sort": ["_score"],
            "profile": True})
        assert status == 200, res
        shards = res["profile"]["shards"]
        assert len(shards) == len(pair.port.indices.index("p").shards)
        for entry in shards:
            assert entry["id"].startswith("[p][")
            search = entry["searches"][0]
            q = search["query"][0]
            assert q["type"] == "MatchQuery"
            assert q["time_in_nanos"] >= 0
            assert "breakdown" in q
            assert search["collector"][0]["reason"] == "search_top_hits"
            assert entry["fetch"]["time_in_nanos"] >= 0

    def test_profile_false_omits_section(self, pair):
        seed(pair)
        _, res = same(pair, "POST", "/p/_search",
                      {"query": {"match_all": {}}})
        assert "profile" not in res

    def test_profile_keeps_kernel_path(self, pair):
        """``profile: true`` stays on the kernel path: the kernel serves
        it and the profile carries a kernel section (the reference's
        "tpu" key) with the variant, the plan cache's outcome and the
        batch_wait split; the response is the same body's without
        ``profile`` but for the ``profile`` key."""
        seed(pair)
        gpu = pair.port.gpu_search
        served = gpu.served
        body = {"query": {"match": {"msg": "profiled"}}}
        status, res = same(pair, "POST", "/p/_search",
                           dict(body, profile=True))
        assert status == 200, res
        assert res["hits"]["total"]["value"] == 8
        assert gpu.served == served + 1  # the kernel served it
        shards = res["profile"]["shards"]
        assert len(shards) == 1 and shards[0]["id"] == "[p][kernel]"
        assert shards[0]["searches"][0]["collector"][0]["name"] == \
            "TpuKernelTopK"
        tpu = shards[0]["tpu"]
        assert tpu["variant"] in sparse.KERNEL_VARIANTS
        assert tpu["plan_cache"] == "miss"
        split = tpu["stages_ms"]["batch_wait_split"]
        assert set(split) == {"queue", "window", "dispatch", "completion"}
        assert sum(split.values()) == pytest.approx(
            tpu["stages_ms"]["batch_wait"], rel=0.05, abs=0.05)
        assert res["profile"]["tpu"] == [tpu]
        assert gpu.variant_launches.get(tpu["variant"], 0) >= 1
        _, plain = same(pair, "POST", "/p/_search", body)
        res.pop("profile")
        assert mask_timing(res) == mask_timing(plain)
        # the second equal body hits the plan cache
        _, again = same(pair, "POST", "/p/_search", dict(body, profile=True))
        assert again["profile"]["tpu"][0]["plan_cache"] == "hit"

    def test_device_stages_name_the_launches(self, pair):
        """The kernel section's ``device_stages`` lists the reference's
        stages with their counts (only the timing values masked): a
        one-shard index of three docs, a match gives
        ``exact_device_wait.compressed``, the same match at boost 1e-15
        (weights past what the compressed kernel packs) adds
        ``exact_device_wait.compressed_exact``."""
        pair.both("PUT", "/tri", {"settings": {"number_of_shards": 1},
                                  "mappings": {"properties": {
                                      "t": {"type": "text"}}}})
        for i, text in enumerate(("quick fox", "lazy dog", "quick dog")):
            pair.both("PUT", f"/tri/_doc/{i}", {"t": text},
                      params={"refresh": "true"})
        _, res = same(pair, "POST", "/tri/_search", {
            "query": {"match": {"t": "quick dog"}}, "profile": True})
        stages = res["profile"]["tpu"][0]["device_stages"]
        assert {k: v["count"] for k, v in stages.items()} == {
            "exact_device_wait.compressed": 1}
        _, res = same(pair, "POST", "/tri/_search", {
            "query": {"match": {"t": {"query": "quick dog",
                                      "boost": 1e-15}}},
            "profile": True})
        stages = res["profile"]["tpu"][0]["device_stages"]
        assert {k: v["count"] for k, v in stages.items()} == {
            "exact_device_wait.compressed": 1,
            "exact_device_wait.compressed_exact": 1}

    def test_msearch_items_take_profile_and_timeout(self, pair):
        seed(pair)
        lines = [{"index": "p"},
                 {"query": {"match": {"msg": "query"}}, "profile": True},
                 {"index": "p"},
                 {"query": {"match": {"msg": "text"}}, "timeout": "10s"}]
        raw = "".join(json.dumps(x) + "\n" for x in lines).encode()
        status, res = same(pair, "POST", "/_msearch", raw=raw)
        assert status == 200
        first, second = res["responses"]
        assert first["profile"]["tpu"][0]["plan_cache"] == "miss"
        assert second["timed_out"] is False


class TestTimeout:
    def test_planner_at_zero_ms_times_out(self, pair):
        """A planner body at ``timeout: 0ms``: no shard runs, the partial
        answer says ``timed_out`` and the total's relation ``gte``."""
        seed(pair)
        status, res = same(pair, "POST", "/p/_search", {
            "query": {"match": {"msg": "profiled"}}, "sort": ["_score"],
            "timeout": "0ms"})
        assert status == 200
        assert res["timed_out"] is True
        assert res["hits"]["total"]["relation"] == "gte"

    @pytest.mark.parametrize("where", ["body", "param"])
    def test_kernel_path_within_its_timeout(self, pair, where):
        seed(pair)
        gpu = pair.port.gpu_search
        served = gpu.served
        body = {"query": {"match": {"msg": "profiled"}}}
        params = None
        if where == "body":
            body["timeout"] = "10s"
        else:
            params = {"timeout": "10s"}
        _, res = same(pair, "POST", "/p/_search", body, params=params)
        assert res["timed_out"] is False
        assert res["hits"]["total"] == {"value": 8, "relation": "eq"}
        assert gpu.served == served + 1

    def test_held_batch_hands_the_request_to_the_planner(self, pair,
                                                         monkeypatch):
        """A train held past the request's deadline (its launch blocked
        here): the request leaves the batcher when its deadline passes,
        the planner runs under the expired deadline and answers
        ``timed_out`` with nothing collected, on both nodes; nothing
        trips, and the next request is served by the kernel."""
        seed(pair)
        release = threading.Event()

        def held(launch):
            def wait_then_launch(*args, **kwargs):
                release.wait(timeout=60)
                return launch(*args, **kwargs)
            return wait_then_launch

        monkeypatch.setattr(ref_tpu, "launch_flat_batch",
                            held(ref_tpu.launch_flat_batch))
        monkeypatch.setattr(gpu_service, "launch_flat_batch",
                            held(gpu_service.launch_flat_batch))
        gpu = pair.port.gpu_search
        body = {"query": {"match": {"msg": "profiled"}}, "timeout": "300ms"}
        t0 = time.perf_counter()
        try:
            status, res = same(pair, "POST", "/p/_search", body)
        finally:
            release.set()
        assert time.perf_counter() - t0 < 30
        assert status == 200 and res["timed_out"] is True
        assert res["hits"]["total"] == {"value": 0, "relation": "gte"}
        assert gpu.fallback == 1 and gpu.timeouts == 1 and gpu.served == 0
        monkeypatch.undo()
        _, res = same(pair, "POST", "/p/_search",
                      {"query": {"match": {"msg": "profiled"}}})
        assert res["timed_out"] is False and gpu.served >= 1

    @pytest.mark.parametrize("value", ["-1", "abc"])
    def test_no_timeout_and_a_malformed_one(self, pair, value):
        seed(pair, n=2)
        status, res = same(pair, "POST", "/p/_search", {
            "query": {"match": {"msg": "profiled"}}, "timeout": value})
        if value == "-1":
            assert status == 200 and res["timed_out"] is False
        else:
            assert status == 400


class TestSlowLog:
    def test_threshold_tiers(self):
        s = Settings.of({
            "index.search.slowlog.threshold.query.warn": "1s",
            "index.search.slowlog.threshold.query.info": "100ms",
            "index.search.slowlog.threshold.query.debug": "0ms"})
        sl = SlowLog("idx", s)
        assert sl.enabled
        assert sl.maybe_log(2.0, 0) == "warn"
        assert sl.maybe_log(0.5, 0) == "info"
        assert sl.maybe_log(0.01, 0) == "debug"

    def test_disabled_without_thresholds(self):
        sl = SlowLog("idx", Settings.EMPTY)
        assert not sl.enabled
        assert sl.maybe_log(100.0, 0) is None

    @pytest.mark.parametrize("path", ["planner", "kernel"])
    def test_slow_query_logged_through_search(self, node, caplog, path):
        """A shard's query phase on the planner path (a sorted body), or
        the index's train on the kernel path ("[slow][kernel]")."""
        _handle(node, "PUT", "/slow", body={"settings": {
            "index.search.slowlog.threshold.query.warn": "0ms"}})
        for i in range(3):
            _handle(node, "PUT", f"/slow/_doc/{i}",
                    params={"refresh": "true"}, body={"m": "hello"})
        body = {"query": {"match": {"m": "hello"}}}
        if path == "planner":
            body["sort"] = ["_score"]
        with caplog.at_level(logging.WARNING, logger=SEARCH_SLOWLOG):
            status, res = _handle(node, "POST", "/slow/_search", body=body)
        assert status == 200
        records = [r for r in caplog.records if r.name == SEARCH_SLOWLOG]
        assert records, "no slowlog record emitted"
        msg = records[0].getMessage()
        assert ("[slow][0]" if path == "planner" else "[slow][kernel]") \
            in msg
        assert "took_millis[" in msg and "source[" in msg
        assert ("hello" if path == "planner" else "match") in msg

    def test_fast_queries_not_logged(self, node, caplog):
        _handle(node, "PUT", "/quick", body={"settings": {
            "index.search.slowlog.threshold.query.warn": "10s"}})
        _handle(node, "PUT", "/quick/_doc/1", params={"refresh": "true"},
                body={"m": "hi"})
        with caplog.at_level(logging.DEBUG, logger=SEARCH_SLOWLOG):
            _handle(node, "POST", "/quick/_search",
                    body={"query": {"match": {"m": "hi"}}})
        assert not [r for r in caplog.records
                    if r.name == SEARCH_SLOWLOG]


class TestLoggingConfig:
    def test_logger_level_overrides(self):
        configure(Settings.of({
            "logger.elasticsearch_tpu_torch.test_channel": "DEBUG"}))
        assert logging.getLogger(
            "elasticsearch_tpu_torch.test_channel").level == logging.DEBUG
        configure(Settings.of({
            "logger.elasticsearch_tpu_torch.test_channel": "WARNING"}))
        assert logging.getLogger(
            "elasticsearch_tpu_torch.test_channel").level == logging.WARNING

    def test_es_level_names_accepted(self):
        # the ES names do not stop a node; TRACE is DEBUG
        configure(Settings.of({
            "logger.elasticsearch_tpu_torch.trace_channel": "trace"}))
        assert logging.getLogger(
            "elasticsearch_tpu_torch.trace_channel").level == logging.DEBUG
        from elasticsearch_tpu_torch.common.errors import \
            IllegalArgumentException
        with pytest.raises(IllegalArgumentException):
            configure(Settings.of({"logger.x": "LOUD"}))

    def test_debug_tier_actually_emits(self, caplog):
        """A debug threshold produces records though the package root
        sits at INFO (the channel opens itself up)."""
        configure()
        s = Settings.of({
            "index.search.slowlog.threshold.query.debug": "0ms"})
        sl = SlowLog("dbg", s)
        assert sl.logger.isEnabledFor(logging.DEBUG)
        with caplog.at_level(logging.DEBUG, logger=SEARCH_SLOWLOG):
            assert sl.maybe_log(0.5, 0) == "debug"
        assert any(r.levelno == logging.DEBUG for r in caplog.records
                   if r.name == SEARCH_SLOWLOG)

    def test_root_handler_installed_once(self):
        configure()
        configure()
        root = logging.getLogger("elasticsearch_tpu_torch")
        handlers = [h for h in root.handlers
                    if isinstance(h, logging.StreamHandler)]
        assert len(handlers) == 1


class TestDynamicSettings:
    """Port copies of tests/test_dynamic_settings.py's two cases of the
    slow log and the logging module."""

    def test_slowlog_threshold_applies_at_runtime(self, node, caplog):
        _handle(node, "PUT", "/d/_doc/1", params={"refresh": "true"},
                body={"m": "x"})
        status, _ = _handle(node, "PUT", "/d/_settings", body={
            "index": {"search": {"slowlog": {"threshold": {"query": {
                "warn": "0ms"}}}}}})
        assert status == 200
        with caplog.at_level(logging.WARNING, logger=SEARCH_SLOWLOG):
            _handle(node, "POST", "/d/_search",
                    body={"query": {"match": {"m": "x"}}})
        assert [r for r in caplog.records if r.name == SEARCH_SLOWLOG]
        # reset: no record after the threshold is cleared
        status, _ = _handle(node, "PUT", "/d/_settings", body={
            "index.search.slowlog.threshold.query.warn": None})
        assert status == 200
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=SEARCH_SLOWLOG):
            _handle(node, "POST", "/d/_search",
                    body={"query": {"match": {"m": "x"}}})
        assert not [r for r in caplog.records if r.name == SEARCH_SLOWLOG]

    def test_persistent_logger_level_applies_after_restart(
            self, tmp_data_path):
        n1 = Node(str(tmp_data_path), device="cpu")
        status, _ = _handle(n1, "PUT", "/_cluster/settings", body={
            "persistent": {"logger.elasticsearch_tpu_torch.restarted":
                           "debug"}})
        assert status == 200
        n1.close()
        logging.getLogger("elasticsearch_tpu_torch.restarted").setLevel(
            logging.NOTSET)
        n2 = Node(str(tmp_data_path), device="cpu")
        try:
            assert logging.getLogger(
                "elasticsearch_tpu_torch.restarted").level == logging.DEBUG
        finally:
            n2.close()

    def test_unknown_logger_level_is_a_400(self, node):
        status, _ = _handle(node, "PUT", "/_cluster/settings", body={
            "transient": {"logger.elasticsearch_tpu_torch.x": "LOUD"}})
        assert status == 400
        assert node.transient_settings == {}
