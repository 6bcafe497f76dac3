"""Port copy of ``test_scroll_pit.py``: scroll and point-in-time
round trips over pinned reader snapshots, and that a context freed by a
clear, an expiry or its index's deletion pins nothing.

Every request goes to the reference node and the port node
(``torch_rest_pair.Pair.handle``); status and response bytes must be
equal, with ``took`` at 0 and only ``torch_rest_pair.MASKED``'s fields
masked (a context id the reference drew stands for the port's own in
the next request); the reference's assertions then run on the shared
answer.
"""

from __future__ import annotations

import time

import pytest
import torch

from torch_rest_pair import Pair

torch.set_num_threads(1)


def _handle(pair, method, path, params=None, body=None):
    if isinstance(body, str):
        return pair.handle(method, path, params=params, raw=body.encode())
    return pair.handle(method, path, params=params, body=body)


@pytest.fixture
def node(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


@pytest.fixture
def corpus(node):
    for i in range(25):
        _handle(node, "PUT", f"/c/_doc/d{i}",
                params={"refresh": "true"},
                body={"msg": "common text", "n": i})
    return node


class TestScroll:
    def test_scroll_pages_cover_everything_once(self, corpus):
        status, page = _handle(corpus, "POST", "/c/_search",
                               params={"scroll": "1m"},
                               body={"query": {"match": {"msg": "common"}},
                                     "size": 10})
        assert status == 200, page
        sid = page["_scroll_id"]
        assert page["hits"]["total"]["value"] == 25
        seen = [h["_id"] for h in page["hits"]["hits"]]
        assert len(seen) == 10
        while True:
            status, page = _handle(corpus, "POST", "/_search/scroll",
                                   body={"scroll": "1m",
                                         "scroll_id": sid})
            assert status == 200, page
            hits = page["hits"]["hits"]
            if not hits:
                break
            seen.extend(h["_id"] for h in hits)
        assert sorted(seen) == sorted(f"d{i}" for i in range(25))
        assert len(seen) == len(set(seen))

    def test_scroll_snapshot_survives_deletes(self, corpus):
        status, page = _handle(corpus, "POST", "/c/_search",
                               params={"scroll": "1m"},
                               body={"query": {"match_all": {}},
                                     "size": 5,
                                     "sort": [{"n": "asc"}]})
        sid = page["_scroll_id"]
        first_ids = [h["_id"] for h in page["hits"]["hits"]]
        assert first_ids == [f"d{i}" for i in range(5)]
        # delete a doc that would appear on page 2, then refresh
        _handle(corpus, "DELETE", "/c/_doc/d7", params={"refresh": "true"})
        status, check = _handle(corpus, "POST", "/c/_search",
                                body={"query": {"match_all": {}}})
        assert check["hits"]["total"]["value"] == 24  # live view shrank
        status, page2 = _handle(corpus, "POST", "/_search/scroll",
                                body={"scroll": "1m", "scroll_id": sid})
        ids2 = [h["_id"] for h in page2["hits"]["hits"]]
        assert "d7" in ids2  # the pinned snapshot still holds it
        assert page2["hits"]["total"]["value"] == 25

    def test_scroll_with_sort_orders_pages(self, corpus):
        status, page = _handle(corpus, "POST", "/c/_search",
                               params={"scroll": "1m"},
                               body={"query": {"match_all": {}},
                                     "sort": [{"n": "desc"}], "size": 9})
        sid = page["_scroll_id"]
        values = [h["sort"][0] for h in page["hits"]["hits"]]
        while True:
            _s, page = _handle(corpus, "POST", "/_search/scroll",
                               body={"scroll_id": sid})
            if not page["hits"]["hits"]:
                break
            values.extend(h["sort"][0] for h in page["hits"]["hits"])
        assert values == sorted(values, reverse=True)
        assert len(values) == 25

    def test_sorted_scroll_with_tied_keys_covers_all_docs(self, node):
        """Boundary ties must not be skipped: the internal _doc
        tiebreaker makes the cursor strictly-after-able even when every
        doc shares the same sort value."""
        for i in range(25):
            _handle(node, "PUT", f"/ties/_doc/t{i}",
                    params={"refresh": "true"},
                    body={"g": 7, "msg": "x"})
        status, page = _handle(node, "POST", "/ties/_search",
                               params={"scroll": "1m"},
                               body={"query": {"match_all": {}},
                                     "sort": [{"g": "asc"}], "size": 10})
        assert status == 200, page
        sid = page["_scroll_id"]
        # the response sort array stays the user's shape (1 value)
        assert all(len(h["sort"]) == 1 for h in page["hits"]["hits"])
        seen = [h["_id"] for h in page["hits"]["hits"]]
        while True:
            _s, page = _handle(node, "POST", "/_search/scroll",
                               body={"scroll_id": sid})
            if not page["hits"]["hits"]:
                break
            seen.extend(h["_id"] for h in page["hits"]["hits"])
        assert sorted(seen) == sorted(f"t{i}" for i in range(25))
        assert len(seen) == len(set(seen))

    def test_search_after_string_cursor_on_fieldless_segment(self, node):
        """A segment without the keyword sort field yields an all-missing
        numeric column; a string cursor must compare by missing-rank,
        not crash with a float() 500."""
        _handle(node, "PUT", "/mix", body={"mappings": {"properties": {
            "k": {"type": "keyword"}}}})
        _handle(node, "PUT", "/mix/_doc/a", params={"refresh": "true"},
                body={"k": "t0"})
        _handle(node, "POST", "/mix/_flush")
        _handle(node, "PUT", "/mix/_doc/b", params={"refresh": "true"},
                body={"other": 1})   # second segment: no k at all
        status, res = _handle(node, "POST", "/mix/_search", body={
            "query": {"match_all": {}},
            "sort": [{"k": {"order": "asc", "missing": "_last"}}],
            "search_after": ["t0"]})
        assert status == 200, res
        # only the missing-k doc sorts after the "t0" cursor
        assert [h["_id"] for h in res["hits"]["hits"]] == ["b"]

    def test_clear_scroll_frees_context(self, corpus):
        _s, page = _handle(corpus, "POST", "/c/_search",
                           params={"scroll": "1m"},
                           body={"query": {"match_all": {}}, "size": 5})
        sid = page["_scroll_id"]
        status, res = _handle(corpus, "DELETE", "/_search/scroll",
                              body={"scroll_id": sid})
        assert status == 200 and res["num_freed"] == 1
        status, res = _handle(corpus, "POST", "/_search/scroll",
                              body={"scroll_id": sid})
        assert status == 404

    def test_keepalive_expiry(self, corpus):
        _s, page = _handle(corpus, "POST", "/c/_search",
                           params={"scroll": "50ms"},
                           body={"query": {"match_all": {}}, "size": 5})
        sid = page["_scroll_id"]
        time.sleep(0.2)
        status, res = _handle(corpus, "POST", "/_search/scroll",
                              body={"scroll_id": sid})
        assert status == 404

    def test_bad_keepalive_rejected(self, corpus):
        status, _ = _handle(corpus, "POST", "/c/_search",
                            params={"scroll": "48h"},
                            body={"query": {"match_all": {}}})
        assert status == 400


class TestPit:
    def test_pit_roundtrip_with_search_after(self, corpus):
        status, res = _handle(corpus, "POST", "/c/_pit",
                              params={"keep_alive": "1m"})
        assert status == 200, res
        pid = res["id"]
        seen = []
        after = None
        while True:
            body = {"query": {"match_all": {}}, "size": 10,
                    "sort": [{"n": "asc"}], "pit": {"id": pid}}
            if after is not None:
                body["search_after"] = after
            status, page = _handle(corpus, "POST", "/_search", body=body)
            assert status == 200, page
            assert page["pit_id"] == pid
            hits = page["hits"]["hits"]
            if not hits:
                break
            seen.extend(h["_id"] for h in hits)
            after = hits[-1]["sort"]
        assert sorted(seen) == sorted(f"d{i}" for i in range(25))
        status, res = _handle(corpus, "DELETE", "/_pit", body={"id": pid})
        assert status == 200 and res["num_freed"] == 1

    def test_pit_is_a_stable_snapshot(self, corpus):
        _s, res = _handle(corpus, "POST", "/c/_pit",
                          params={"keep_alive": "1m"})
        pid = res["id"]
        _handle(corpus, "PUT", "/c/_doc/new", params={"refresh": "true"},
                body={"msg": "common text", "n": 999})
        _handle(corpus, "DELETE", "/c/_doc/d0", params={"refresh": "true"})
        status, page = _handle(corpus, "POST", "/_search", body={
            "query": {"match_all": {}}, "size": 50, "pit": {"id": pid}})
        ids = {h["_id"] for h in page["hits"]["hits"]}
        assert "new" not in ids and "d0" in ids
        assert page["hits"]["total"]["value"] == 25

    def test_closed_pit_404(self, corpus):
        _s, res = _handle(corpus, "POST", "/c/_pit",
                          params={"keep_alive": "1m"})
        pid = res["id"]
        _handle(corpus, "DELETE", "/_pit", body={"id": pid})
        status, _ = _handle(corpus, "POST", "/_search", body={
            "query": {"match_all": {}}, "pit": {"id": pid}})
        assert status == 404

    def test_pit_requires_keep_alive(self, corpus):
        status, _ = _handle(corpus, "POST", "/c/_pit")
        assert status == 400

    def test_non_dict_pit_body_rejected(self, corpus):
        status, _ = _handle(corpus, "POST", "/_search", body={
            "query": {"match_all": {}}, "pit": "bare-string-id"})
        assert status == 400

    def test_clear_scroll_ignores_pit_ids_and_vice_versa(self, corpus):
        _s, res = _handle(corpus, "POST", "/c/_pit",
                          params={"keep_alive": "1m"})
        pid = res["id"]
        _s, page = _handle(corpus, "POST", "/c/_search",
                           params={"scroll": "1m"},
                           body={"query": {"match_all": {}}})
        sid = page["_scroll_id"]
        # clearing a PIT id via the scroll API must not free the PIT
        _s, res = _handle(corpus, "DELETE", "/_search/scroll",
                          body={"scroll_id": pid})
        assert res["num_freed"] == 0
        status, _ = _handle(corpus, "POST", "/_search", body={
            "query": {"match_all": {}}, "pit": {"id": pid}})
        assert status == 200  # still alive
        # closing a scroll id via the PIT API must not free the scroll
        _s, res = _handle(corpus, "DELETE", "/_pit", body={"id": sid})
        assert res["num_freed"] == 0
        status, _ = _handle(corpus, "POST", "/_search/scroll",
                            body={"scroll_id": sid})
        assert status == 200

    def test_scroll_id_rejected_as_pit(self, corpus):
        _s, page = _handle(corpus, "POST", "/c/_search",
                           params={"scroll": "1m"},
                           body={"query": {"match_all": {}}})
        status, _ = _handle(corpus, "POST", "/_search", body={
            "query": {"match_all": {}},
            "pit": {"id": page["_scroll_id"]}})
        assert status == 400


# ---- the contexts free what they pin ----

def test_contexts_free_their_readers_and_the_device(tmp_path):
    """A scroll and a PIT keep answering from their snapshots after
    deletes; then the scroll is cleared, the PIT expires (keep_alive 1ms
    and a sweep) and the index is deleted: no context holds a pinned
    reader (every one is garbage), and the hbm breaker's charge is 0."""
    import gc
    import weakref

    pair = Pair(tmp_path)
    port = pair.port
    try:
        for i in range(30):
            _handle(pair, "PUT", f"/c/_doc/d{i}",
                    body={"msg": "common text", "n": i})
        _handle(pair, "POST", "/c/_refresh")
        body = {"query": {"match": {"msg": "common"}}, "size": 10,
                "sort": [{"n": "asc"}]}
        # the kernel path packs the index on the device
        _handle(pair, "POST", "/c/_search",
                body={"query": {"match": {"msg": "common"}}})
        _s, page = _handle(pair, "POST", "/c/_search",
                           params={"scroll": "1m"}, body=body)
        sid = page["_scroll_id"]
        _s, res = _handle(pair, "POST", "/c/_pit",
                          params={"keep_alive": "1ms"})
        pid = res["id"]
        pinned = [weakref.ref(r) for ctx in
                  port.search_contexts._contexts.values()
                  for r in ctx.readers.values()]
        assert len(pinned) == 2   # one shard, two contexts
        for i in range(10, 20):
            _handle(pair, "DELETE", f"/c/_doc/d{i}",
                    params={"refresh": "true"})
        _s, page = _handle(pair, "POST", "/_search/scroll",
                           body={"scroll": "1m", "scroll_id": sid})
        assert [h["_id"] for h in page["hits"]["hits"]] == \
            [f"d{i}" for i in range(10, 20)]
        assert page["hits"]["total"]["value"] == 30
        _s, res = _handle(pair, "DELETE", "/_search/scroll",
                          body={"scroll_id": sid})
        assert res["num_freed"] == 1
        time.sleep(0.01)
        for node in (pair.ref, port):
            node.search_contexts.reap()
        assert port.search_contexts.active_count() == 0
        status, _ = _handle(pair, "POST", "/_search", body={
            "query": {"match_all": {}}, "pit": {"id": pid}})
        assert status == 404
        assert _handle(pair, "DELETE", "/c")[0] == 200
        del page, res
        # a fold the deletes started may hold the readers until it ends
        deadline = time.monotonic() + 30
        while True:
            gc.collect()
            alive = [r for r in pinned if r() is not None]
            if not alive or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert alive == []
        assert port.gpu_search.compaction_idle()
        assert port.breakers.breakers["hbm"].used == 0
    finally:
        pair.close()
