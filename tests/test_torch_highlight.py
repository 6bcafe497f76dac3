"""Port copy of ``test_highlight.py``: the plain highlighter over the
planner path's fetched ``_source``.

Every request goes to the reference node and the port node
(``torch_rest_pair.Pair.handle``); status and response bytes must be
equal, with ``took`` at 0 and only ``torch_rest_pair.MASKED``'s fields
masked (a context id the reference drew stands for the port's own in
the next request); the reference's assertions then run on the shared
answer.
"""

from __future__ import annotations

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
def articles(node):
    docs = [
        {"title": "Quick start guide",
         "body": "The quick brown fox jumps over the lazy dog. "
                 "A quick response matters."},
        {"title": "Slow cooking",
         "body": "Slow and steady wins the race, never quick."},
        {"title": "Unrelated",
         "body": "Nothing to see here at all."},
    ]
    for i, d in enumerate(docs):
        _handle(node, "PUT", f"/a/_doc/{i}", params={"refresh": "true"},
                body=d)
    return node


def _search(node, body):
    status, res = _handle(node, "POST", "/a/_search", body=body)
    assert status == 200, res
    return res


class TestHighlight:
    def test_basic_em_tags(self, articles):
        res = _search(articles, {
            "query": {"match": {"body": "quick"}},
            "highlight": {"fields": {"body": {}}}})
        hits = {h["_id"]: h for h in res["hits"]["hits"]}
        assert "<em>quick</em>" in hits["0"]["highlight"]["body"][0]
        assert any("<em>quick</em>" in f
                   for f in hits["1"]["highlight"]["body"])

    def test_custom_tags(self, articles):
        res = _search(articles, {
            "query": {"match": {"body": "fox"}},
            "highlight": {"pre_tags": ["<b>"], "post_tags": ["</b>"],
                          "fields": {"body": {}}}})
        h = res["hits"]["hits"][0]
        assert "<b>fox</b>" in h["highlight"]["body"][0]

    def test_require_field_match(self, articles):
        res = _search(articles, {
            "query": {"match": {"body": "quick"}},
            "highlight": {"fields": {"title": {}, "body": {}}}})
        h = next(x for x in res["hits"]["hits"] if x["_id"] == "0")
        # body query terms don't highlight the title by default
        assert "title" not in h["highlight"]
        res = _search(articles, {
            "query": {"match": {"body": "quick"}},
            "highlight": {"require_field_match": False,
                          "fields": {"title": {}}}})
        h = next(x for x in res["hits"]["hits"] if x["_id"] == "0")
        assert "<em>Quick</em>" in h["highlight"]["title"][0]

    def test_field_without_match_omitted(self, articles):
        res = _search(articles, {
            "query": {"bool": {"should": [
                {"match": {"body": "nothing"}},
                {"match": {"title": "unrelated"}}]}},
            "highlight": {"fields": {"body": {}, "title": {}}}})
        h = next(x for x in res["hits"]["hits"] if x["_id"] == "2")
        assert set(h["highlight"]) == {"body", "title"}

    def test_whole_value_with_zero_fragments(self, articles):
        res = _search(articles, {
            "query": {"match": {"body": "quick"}},
            "highlight": {"fields": {"body": {
                "number_of_fragments": 0}}}})
        h = next(x for x in res["hits"]["hits"] if x["_id"] == "0")
        frag = h["highlight"]["body"][0]
        assert frag.count("<em>quick</em>") == 2
        assert frag.startswith("The ") and frag.endswith("matters.")

    def test_fragment_size_windows(self, articles):
        res = _search(articles, {
            "query": {"match": {"body": "quick"}},
            "highlight": {"fields": {"body": {
                "fragment_size": 30, "number_of_fragments": 2}}}})
        h = next(x for x in res["hits"]["hits"] if x["_id"] == "0")
        frags = h["highlight"]["body"]
        assert 1 <= len(frags) <= 2
        assert all("<em>quick</em>" in f for f in frags)

    def test_phrase_and_multi_term_queries(self, articles):
        res = _search(articles, {
            "query": {"match_phrase": {"body": "brown fox"}},
            "highlight": {"fields": {"body": {}}}})
        h = res["hits"]["hits"][0]
        assert "<em>brown</em> <em>fox</em>" in h["highlight"]["body"][0]
        res = _search(articles, {
            "query": {"prefix": {"body": {"value": "qui"}}},
            "highlight": {"fields": {"body": {}}}})
        assert all("<em>quick</em>" in h["highlight"]["body"][0].lower()
                   for h in res["hits"]["hits"])

    def test_source_false_still_highlights(self, articles):
        res = _search(articles, {
            "query": {"match": {"body": "fox"}},
            "_source": False,
            "highlight": {"fields": {"body": {}}}})
        h = res["hits"]["hits"][0]
        assert "_source" not in h
        assert "<em>fox</em>" in h["highlight"]["body"][0]

    def test_wildcard_field_pattern(self, articles):
        res = _search(articles, {
            "query": {"match": {"body": "fox"}},
            "highlight": {"fields": {"bo*": {}}}})
        h = res["hits"]["hits"][0]
        assert "body" in h["highlight"]

    def test_bad_spec_400(self, articles):
        status, _ = _handle(articles, "POST", "/a/_search", body={
            "query": {"match_all": {}}, "highlight": {"no_fields": 1}})
        assert status == 400
