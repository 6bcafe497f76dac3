"""Port copy of ``test_sort.py``: field sort, ``search_after``, the
refusal of a malformed ``collapse`` and ``rescore``, and the
``version`` / ``seq_no_primary_term`` flags.

Every request goes to the reference node and the port node
(``torch_rest_pair``); status and response bytes must be equal, with
``took`` at 0 and only ``torch_rest_pair.MASKED``'s fields masked. The
reference's assertions then run on the shared answer. The sorted query
phase takes each segment's mask and scores from the planner's torch
ops and orders the doc-value keys with the reference's numpy lexsort.
"""

from __future__ import annotations

import pytest
import torch

from torch_rest_pair import Pair

torch.set_num_threads(1)

BOOKS = [
    ("1", "alpha story", 2001, 4.5, "scifi"),
    ("2", "beta story", 1999, 3.2, "fantasy"),
    ("3", "gamma story", 2010, 4.9, "scifi"),
    ("4", "delta story", 2005, None, "horror"),
    ("5", "epsilon story", None, 2.1, "fantasy"),
    ("6", "zeta story", 1999, 4.5, None),
]


@pytest.fixture
def books(tmp_path):
    p = Pair(tmp_path)
    p.same("PUT", "/books", {
        "settings": {"index": {"number_of_shards": 2}},
        "mappings": {"properties": {"title": {"type": "text"},
                                    "year": {"type": "long"},
                                    "rating": {"type": "double"},
                                    "genre": {"type": "keyword"}}}})
    for doc_id, title, year, rating, genre in BOOKS:
        body = {"title": title}
        if year is not None:
            body["year"] = year
        if rating is not None:
            body["rating"] = rating
        if genre is not None:
            body["genre"] = genre
        p.same("PUT", f"/books/_doc/{doc_id}", body)
    p.same("POST", "/books/_refresh")
    yield p
    p.close()


def search(pair, body):
    status, out = pair.same("POST", "/books/_search", body)
    assert status == 200, out
    return out


def ids(out):
    return [h["_id"] for h in out["hits"]["hits"]]


STORY = {"match": {"title": "story"}}


class TestFieldSort:
    def test_numeric_asc_missing_last(self, books):
        out = search(books, {"query": STORY, "sort": [{"year": "asc"}]})
        assert ids(out) == ["2", "6", "1", "4", "3", "5"]
        assert out["hits"]["hits"][0]["sort"] == [1999]
        assert out["hits"]["max_score"] is None
        assert out["hits"]["hits"][0]["_score"] is None

    def test_numeric_desc_missing_last(self, books):
        out = search(books, {"query": STORY,
                             "sort": [{"year": {"order": "desc"}}]})
        assert ids(out) == ["3", "4", "1", "2", "6", "5"]

    def test_missing_first(self, books):
        out = search(books, {"query": STORY, "sort": [
            {"year": {"order": "asc", "missing": "_first"}}]})
        assert ids(out)[0] == "5"

    def test_missing_literal(self, books):
        out = search(books, {"query": STORY, "sort": [
            {"year": {"order": "asc", "missing": 2003}}]})
        # doc 5 slots between 2001 and 2005
        assert ids(out) == ["2", "6", "1", "5", "4", "3"]

    def test_double_field(self, books):
        out = search(books, {"query": STORY, "sort": [{"rating": "desc"}]})
        assert ids(out) == ["3", "1", "6", "2", "5", "4"]
        assert out["hits"]["hits"][0]["sort"] == [4.9]

    def test_keyword_sort(self, books):
        out = search(books, {"query": STORY, "sort": [{"genre": "asc"}]})
        # ties (fantasy: 2, 5 / scifi: 1, 3) break by shard order,
        # missing (6) last
        assert ids(out) == ["2", "5", "4", "3", "1", "6"]
        assert out["hits"]["hits"][0]["sort"] == ["fantasy"]

    def test_keyword_desc_with_missing_first(self, books):
        out = search(books, {"query": STORY, "sort": [
            {"genre": {"order": "desc", "missing": "_first"}}]})
        assert ids(out)[0] == "6"

    def test_multi_key_with_tiebreak(self, books):
        out = search(books, {"query": STORY,
                             "sort": [{"year": "asc"}, {"rating": "desc"}]})
        # year 1999 tie: rating 4.5 (6) before 3.2 (2)
        assert ids(out)[:2] == ["6", "2"]
        assert out["hits"]["hits"][0]["sort"] == [1999, 4.5]

    def test_score_sort_explicit(self, books):
        out = search(books, {"query": {"match": {"title": "alpha story"}},
                             "sort": ["_score"]})
        assert ids(out)[0] == "1"
        assert out["hits"]["max_score"] is not None
        assert out["hits"]["hits"][0]["_score"] is not None

    def test_sort_equals_unsorted_for_score(self, books):
        query = {"match": {"title": "alpha beta story"}}
        a = search(books, {"query": query, "sort": ["_score"]})
        b = search(books, {"query": query})
        assert ids(a) == ids(b)

    def test_doc_sort_and_from(self, books):
        out = search(books, {"query": {"match_all": {}},
                             "sort": ["_doc"], "from": 2, "size": 3})
        assert len(ids(out)) == 3

    def test_literal_missing_on_keyword_is_400(self, books):
        status, _ = books.same("POST", "/books/_search", {
            "query": STORY,
            "sort": [{"genre": {"order": "asc", "missing": "zzz"}}]})
        assert status == 400


class TestSearchAfter:
    def test_paging_covers_all_without_dups(self, books):
        body = {"query": STORY, "sort": [{"year": "asc"}, {"rating": "desc"}],
                "size": 2}
        seen = []
        cursor = None
        for _ in range(5):
            b = dict(body)
            if cursor is not None:
                b["search_after"] = cursor
            hits = search(books, b)["hits"]["hits"]
            if not hits:
                break
            seen.extend(h["_id"] for h in hits)
            cursor = hits[-1]["sort"]
        # year asc, rating desc on the 1999 tie → 6 (4.5) before 2 (3.2)
        assert seen == ["6", "2", "1", "4", "3", "5"]
        assert len(set(seen)) == 6

    def test_keyword_cursor_absent_from_a_segment(self, books):
        out = search(books, {"query": STORY, "sort": [{"genre": "asc"}],
                             "search_after": ["g"]})
        assert ids(out) == ["4", "3", "1", "6"]

    def test_search_after_requires_sort(self, books):
        status, _ = books.same("POST", "/books/_search", {
            "query": {"match_all": {}}, "search_after": [1999]})
        assert status == 400

    def test_cursor_length_mismatch_is_400(self, books):
        status, _ = books.same("POST", "/books/_search", {
            "query": STORY, "sort": [{"year": "asc"}],
            "search_after": [1999, 4.5]})
        assert status == 400


class TestUnsupportedKeysRejected:
    @pytest.mark.parametrize("key", ["collapse", "rescore"])
    def test_400_on_unsupported(self, books, key):
        status, _ = books.same("POST", "/books/_search", {
            "query": {"match_all": {}}, key: {}})
        assert status == 400


class TestVersionSeqNoFlags:
    def test_version_and_seqno_in_hits(self, books):
        out = search(books, {"query": {"match": {"title": "alpha"}},
                             "sort": [{"year": "asc"}],
                             "version": True, "seq_no_primary_term": True})
        hit = out["hits"]["hits"][0]
        assert hit["_version"] == 1
        assert hit["_seq_no"] >= 0
        assert hit["_primary_term"] == 1

    def test_flags_work_on_fast_path(self, books):
        served = books.port.gpu_search.served
        out = search(books, {"query": {"match": {"title": "alpha"}},
                             "version": True, "seq_no_primary_term": True})
        assert books.port.gpu_search.served > served
        hit = out["hits"]["hits"][0]
        assert hit["_version"] == 1 and hit["_primary_term"] == 1
