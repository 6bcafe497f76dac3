"""Port copies of ``test_suggest.py`` and
``test_suggest_phrase_completion.py``: the term suggester, alone, over
``_msearch`` and beside a query; the phrase suggester; the completion
suggester over a ``completion`` field, across a restart.

Every request goes to the reference node and the port node
(``torch_rest_pair.Pair.handle``); status and response bytes must be
equal, with ``took`` at 0 and only ``torch_rest_pair.MASKED``'s fields
masked (a context id the reference drew stands for the port's own in
the next request); the reference's assertions then run on the shared
answer.
"""

from __future__ import annotations

import json

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
    texts = ["the quick brown fox", "quick silver lining",
             "a quick response", "slow brown bear", "brown paper bag"]
    for i, t in enumerate(texts):
        _handle(node, "PUT", f"/s/_doc/{i}", params={"refresh": "true"},
                body={"body": t})
    return node


def _suggest(node, body, index="s"):
    status, res = _handle(node, "POST", f"/{index}/_search",
                          body={"size": 0, "suggest": body})
    assert status == 200, res
    return res["suggest"]


class TestTermSuggest:
    def test_misspelling_corrected(self, corpus):
        out = _suggest(corpus, {"fix": {
            "text": "quikc borwn", "term": {"field": "body"}}})
        entries = out["fix"]
        assert [e["text"] for e in entries] == ["quikc", "borwn"]
        assert entries[0]["options"][0]["text"] == "quick"
        assert entries[0]["options"][0]["freq"] == 3
        assert entries[1]["options"][0]["text"] == "brown"
        assert entries[1]["offset"] == 6

    def test_existing_word_skipped_in_missing_mode(self, corpus):
        out = _suggest(corpus, {"fix": {
            "text": "quick", "term": {"field": "body"}}})
        assert out["fix"][0]["options"] == []
        out = _suggest(corpus, {"fix": {
            "text": "quick", "term": {"field": "body",
                                      "suggest_mode": "always",
                                      "prefix_length": 0}}})
        # always mode offers alternatives even for known words
        assert isinstance(out["fix"][0]["options"], list)

    def test_size_and_ranking(self, corpus):
        out = _suggest(corpus, {"fix": {
            "text": "browm", "term": {"field": "body", "size": 1}}})
        opts = out["fix"][0]["options"]
        assert len(opts) == 1 and opts[0]["text"] == "brown"

    def test_short_tokens_skipped(self, corpus):
        out = _suggest(corpus, {"fix": {
            "text": "teh", "term": {"field": "body"}}})
        assert out["fix"][0]["options"] == []  # below min_word_length

    def test_global_text_and_validation(self, corpus):
        out = _suggest(corpus, {"text": "quikc",
                                "fix": {"term": {"field": "body"}}})
        assert out["fix"][0]["options"][0]["text"] == "quick"
        status, _ = _handle(corpus, "POST", "/s/_search", body={
            "suggest": {"fix": {"text": "x",
                                "phrase": {"field": "body"}}}})
        assert status == 200  # the phrase suggester is supported now
        status, _ = _handle(corpus, "POST", "/s/_search", body={
            "suggest": {"fix": {"text": "x",
                                "nope": {"field": "body"}}}})
        assert status == 400  # unknown suggester kind
        status, _ = _handle(corpus, "POST", "/s/_search", body={
            "suggest": {"fix": {"text": "x", "term": {
                "field": "body", "max_edits": 5}}}})
        assert status == 400

    def test_msearch(self, corpus):
        lines = [json.dumps({"index": "s"}),
                 json.dumps({"query": {"match": {"body": "quick"}},
                             "size": 1}),
                 json.dumps({}),
                 json.dumps({"query": {"match": {"body": "brown"}},
                             "size": 0}),
                 json.dumps({"index": "missing-idx"}),
                 json.dumps({"query": {"match_all": {}}})]
        status, res = _handle(corpus, "POST", "/s/_msearch",
                              body="\n".join(lines) + "\n")
        assert status == 200, res
        r0, r1, r2 = res["responses"]
        assert r0["status"] == 200 and r0["hits"]["total"]["value"] == 3
        assert len(r0["hits"]["hits"]) == 1
        assert r1["hits"]["total"]["value"] == 3  # {} header → url index
        assert r2["status"] == 404  # per-item failure, not whole-request

    def test_msearch_rejects_empty_and_honors_pit(self, corpus):
        status, _ = _handle(corpus, "POST", "/_msearch", body="\n")
        assert status == 400
        # an item naming a bogus pit must FAIL that item, never run a
        # silent live search
        lines = [json.dumps({}),
                 json.dumps({"query": {"match_all": {}},
                             "pit": {"id": "no-such-context"}})]
        status, res = _handle(corpus, "POST", "/s/_msearch",
                              body="\n".join(lines) + "\n")
        assert status == 200
        assert res["responses"][0]["status"] == 404

    def test_search_plus_suggest_combined(self, corpus):
        status, res = _handle(corpus, "POST", "/s/_search", body={
            "query": {"match": {"body": "brown"}},
            "suggest": {"fix": {"text": "qiuck",
                                "term": {"field": "body"}}}})
        assert status == 200
        assert res["hits"]["total"]["value"] == 3
        assert res["suggest"]["fix"][0]["options"][0]["text"] == "quick"


# ---- test_suggest_phrase_completion.py ----

@pytest.fixture()
def seeded(node):
    s, b = _handle(node, "PUT", "/s", body={
        "settings": {"number_of_shards": 2},
        "mappings": {"properties": {
            "body": {"type": "text"},
            "sugg": {"type": "completion"}}}})
    assert s == 200, b
    docs = [
        {"body": "the quick brown fox", "sugg": ["quick fox"]},
        {"body": "quick brown foxes run", "sugg": {"input":
            ["quick brown", "quiet night"], "weight": 5}},
        {"body": "brown bears sleep", "sugg": "brown bear"},
        {"body": "quick quick quick", "sugg": ["quorum call"]},
    ]
    for i, src in enumerate(docs):
        _handle(node, "PUT", f"/s/_doc/{i}", body=src)
    _handle(node, "POST", "/s/_refresh")
    return node


class TestPhrase:
    def test_phrase_corrects_typos(self, seeded):
        s, r = _handle(seeded, "POST", "/s/_search", body={
            "size": 0, "suggest": {"fix": {
                "text": "quick browm fox",
                "phrase": {"field": "body", "size": 3}}}})
        assert s == 200, r
        opts = r["suggest"]["fix"][0]["options"]
        assert opts, r["suggest"]
        assert opts[0]["text"] == "quick brown fox", opts

    def test_phrase_highlight_and_max_errors(self, seeded):
        s, r = _handle(seeded, "POST", "/s/_search", body={
            "size": 0, "suggest": {"fix": {
                "text": "quick browm foxs",
                "phrase": {"field": "body", "max_errors": 2,
                           "highlight": {"pre_tag": "<em>",
                                         "post_tag": "</em>"}}}}})
        assert s == 200, r
        opts = r["suggest"]["fix"][0]["options"]
        assert any(o["text"] == "quick brown fox" for o in opts), opts
        top = opts[0]
        assert "<em>" in top["highlighted"], top
        assert not top["highlighted"].startswith("<em>quick"), top

    def test_phrase_no_correction_needed(self, seeded):
        s, r = _handle(seeded, "POST", "/s/_search", body={
            "size": 0, "suggest": {"fix": {
                "text": "zzzzqqq",
                "phrase": {"field": "body"}}}})
        assert s == 200, r


class TestCompletion:
    def test_prefix_lookup_weight_ranked(self, seeded):
        s, r = _handle(seeded, "POST", "/s/_search", body={
            "size": 0, "suggest": {"c": {
                "prefix": "qui",
                "completion": {"field": "sugg"}}}})
        assert s == 200, r
        opts = r["suggest"]["c"][0]["options"]
        texts = [o["text"] for o in opts]
        # weight 5 inputs rank first; then weight-1, text asc
        assert texts[0] in ("quick brown", "quiet night"), opts
        assert set(texts) == {"quick brown", "quiet night", "quick fox"}, \
            opts

    def test_prefix_no_match(self, seeded):
        s, r = _handle(seeded, "POST", "/s/_search", body={
            "size": 0, "suggest": {"c": {
                "prefix": "zebra", "completion": {"field": "sugg"}}}})
        assert s == 200, r
        assert r["suggest"]["c"][0]["options"] == []

    def test_completion_survives_restart(self, seeded):
        _handle(seeded, "POST", "/s/_flush")
        seeded.restart()
        s, r = _handle(seeded, "POST", "/s/_search", body={
            "size": 0, "suggest": {"c": {
                "prefix": "bro", "completion": {"field": "sugg"}}}})
        assert s == 200, r
        assert [o["text"] for o in r["suggest"]["c"][0]["options"]] \
            == ["brown bear"], r["suggest"]

    def test_skip_duplicates_size_and_deleted_docs(self, seeded):
        _handle(seeded, "DELETE", "/s/_doc/0", params={"refresh": "true"})
        s, r = _handle(seeded, "POST", "/s/_search", body={
            "size": 0, "suggest": {"c": {
                "text": "q", "completion": {"field": "sugg", "size": 2,
                                            "skip_duplicates": True}}}})
        assert s == 200, r
        assert "quick fox" not in [o["text"] for o in
                                   r["suggest"]["c"][0]["options"]]
