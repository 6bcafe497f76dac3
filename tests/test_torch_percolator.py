"""Port copy of ``test_percolator.py``: the percolator mapping's
validation, the ``percolate`` query over stored queries and multi-document
percolation, through REST (``test_torch_rare_fields_parity.py`` holds the
executor's percolate scores bit for bit; these are the REST cases no
port test had).

Every request goes to the reference node and the port node
(``torch_rest_pair.Pair.handle``); status and response bytes must be
equal, with ``took`` at 0 and only ``torch_rest_pair.MASKED``'s fields
masked; the reference's assertions then run on the shared answer.
"""

from __future__ import annotations

import pytest
import torch

from torch_rest_pair import Pair

torch.set_num_threads(1)


def _handle(pair, method, path, params=None, body=None):
    return pair.handle(method, path, params=params, body=body)


@pytest.fixture
def node(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


@pytest.fixture
def alerts(node):
    _handle(node, "PUT", "/alerts", body={"mappings": {"properties": {
        "query": {"type": "percolator"},
        "label": {"type": "keyword"},
        "body": {"type": "text"},       # schema of percolated docs
        "severity": {"type": "integer"}}}})
    rules = {
        "errors": {"match": {"body": "error"}},
        "disk": {"bool": {"must": [{"match": {"body": "disk"}},
                                   {"range": {"severity": {"gte": 3}}}]}},
        "anything": {"match_all": {}},
    }
    for name, q in rules.items():
        _handle(node, "PUT", f"/alerts/_doc/{name}",
                params={"refresh": "true"},
                body={"query": q, "label": name})
    return node


class TestPercolate:
    def test_matching_rules(self, alerts):
        status, res = _handle(alerts, "POST", "/alerts/_search", body={
            "query": {"percolate": {
                "field": "query",
                "document": {"body": "a disk error occurred",
                             "severity": 5}}},
            "size": 10})
        assert status == 200, res
        ids = {h["_id"] for h in res["hits"]["hits"]}
        assert ids == {"errors", "disk", "anything"}

    def test_range_condition_filters(self, alerts):
        _, res = _handle(alerts, "POST", "/alerts/_search", body={
            "query": {"percolate": {
                "field": "query",
                "document": {"body": "disk almost full",
                             "severity": 1}}},
            "size": 10})
        ids = {h["_id"] for h in res["hits"]["hits"]}
        assert ids == {"anything"}  # severity 1 < 3, no "error" term

    def test_combines_with_other_clauses(self, alerts):
        _, res = _handle(alerts, "POST", "/alerts/_search", body={
            "query": {"bool": {
                "must": [{"percolate": {
                    "field": "query",
                    "document": {"body": "error", "severity": 0}}}],
                "filter": [{"term": {"label": "errors"}}]}},
            "size": 10})
        assert [h["_id"] for h in res["hits"]["hits"]] == ["errors"]

    def test_documents_plural_any_match(self, alerts):
        _, res = _handle(alerts, "POST", "/alerts/_search", body={
            "query": {"percolate": {
                "field": "query",
                "documents": [{"body": "all fine", "severity": 0},
                              {"body": "error in module"}]}},
            "size": 10})
        ids = {h["_id"] for h in res["hits"]["hits"]}
        assert "errors" in ids and "anything" in ids
        assert "disk" not in ids

    def test_analyzed_like_indexing(self, alerts):
        # the percolated doc runs through the index's analyzers: case
        # folds, so "ERROR" matches the stored match query
        _, res = _handle(alerts, "POST", "/alerts/_search", body={
            "query": {"percolate": {
                "field": "query",
                "document": {"body": "ERROR!"}}},
            "size": 10})
        assert "errors" in {h["_id"] for h in res["hits"]["hits"]}

    def test_invalid_stored_query_400_at_write(self, alerts):
        status, _ = _handle(alerts, "PUT", "/alerts/_doc/bad",
                            body={"query": {"nosuch": {}}})
        assert status == 400
        status, _ = _handle(alerts, "PUT", "/alerts/_doc/bad",
                            body={"query": "not an object"})
        assert status == 400

    def test_percolate_validation_400(self, alerts):
        status, _ = _handle(alerts, "POST", "/alerts/_search", body={
            "query": {"percolate": {"field": "query"}}})
        assert status == 400
        status, _ = _handle(alerts, "POST", "/alerts/_search", body={
            "query": {"percolate": {
                "field": "query", "document": {},
                "documents": [{}]}}})
        assert status == 400

    def test_non_percolator_field_400(self, alerts):
        status, _ = _handle(alerts, "POST", "/alerts/_search", body={
            "query": {"percolate": {"field": "label",
                                    "document": {"body": "x"}}}})
        assert status == 400

    def test_updated_rule_applies_after_refresh(self, alerts):
        _handle(alerts, "PUT", "/alerts/_doc/errors",
                params={"refresh": "true"},
                body={"query": {"match": {"body": "failure"}},
                      "label": "errors"})
        _, res = _handle(alerts, "POST", "/alerts/_search", body={
            "query": {"percolate": {
                "field": "query",
                "document": {"body": "an error"}}},
            "size": 10})
        ids = {h["_id"] for h in res["hits"]["hits"]}
        assert "errors" not in ids  # now matches "failure", not "error"


class TestReviewRegressions:
    def test_unmapped_field_in_document_ok(self, alerts):
        # dynamic fields in the percolated doc must neither crash nor
        # mutate the live index mapping (review findings 1+2)
        status, res = _handle(alerts, "POST", "/alerts/_search", body={
            "query": {"percolate": {
                "field": "query",
                "document": {"body": "an error", "note": "hello",
                             "extra": {"deep": 42}}}},
            "size": 10})
        assert status == 200, res
        assert "errors" in {h["_id"] for h in res["hits"]["hits"]}
        _, mapping = _handle(alerts, "GET", "/alerts/_mapping")
        props = mapping["alerts"]["mappings"]["properties"]
        assert "note" not in props and "extra" not in props

    def test_multi_index_uses_each_indexs_mapper(self, node):
        # index A: body keyword (no analysis); index B: body text
        _handle(node, "PUT", "/pa", body={"mappings": {"properties": {
            "query": {"type": "percolator"},
            "body": {"type": "keyword"}}}})
        _handle(node, "PUT", "/pb", body={"mappings": {"properties": {
            "query": {"type": "percolator"},
            "body": {"type": "text"}}}})
        _handle(node, "PUT", "/pa/_doc/r", params={"refresh": "true"},
                body={"query": {"term": {"body": "Big Error"}}})
        _handle(node, "PUT", "/pb/_doc/r", params={"refresh": "true"},
                body={"query": {"match": {"body": "error"}}})
        status, res = _handle(node, "POST", "/pa,pb/_search", body={
            "query": {"percolate": {
                "field": "query", "document": {"body": "Big Error"}}},
            "size": 10})
        assert status == 200, res
        hits = {(h["_index"], h["_id"]) for h in res["hits"]["hits"]}
        # pa: exact keyword match; pb: analyzed text match — BOTH hit,
        # each through its own index's analysis
        assert hits == {("pa", "r"), ("pb", "r")}

    def test_deleted_rules_dont_match(self, alerts):
        _handle(alerts, "DELETE", "/alerts/_doc/anything",
                params={"refresh": "true"})
        _, res = _handle(alerts, "POST", "/alerts/_search", body={
            "query": {"percolate": {
                "field": "query", "document": {"body": "calm"}}},
            "size": 10})
        assert res["hits"]["total"]["value"] == 0

    def test_poisonous_stored_query_doesnt_break_search(self, alerts):
        # parses fine, fails at EVAL (range on text) — must no-match,
        # never 400 the whole percolate
        _handle(alerts, "PUT", "/alerts/_doc/poison",
                params={"refresh": "true"},
                body={"query": {"range": {"body": {"gte": 1}}}})
        status, res = _handle(alerts, "POST", "/alerts/_search", body={
            "query": {"percolate": {
                "field": "query", "document": {"body": "error"}}},
            "size": 10})
        assert status == 200, res
        ids = {h["_id"] for h in res["hits"]["hits"]}
        assert "errors" in ids and "poison" not in ids

    def test_array_of_queries_rejected(self, alerts):
        status, _ = _handle(alerts, "PUT", "/alerts/_doc/arr",
                            body={"query": [{"match": {"body": "a"}},
                                            {"match": {"body": "b"}}]})
        assert status == 400

    def test_object_nested_percolator_field(self, node):
        _handle(node, "PUT", "/np", body={"mappings": {"properties": {
            "meta": {"properties": {"query": {"type": "percolator"}}},
            "body": {"type": "text"}}}})
        _handle(node, "PUT", "/np/_doc/r", params={"refresh": "true"},
                body={"meta": {"query": {"match": {"body": "boom"}}}})
        _, res = _handle(node, "POST", "/np/_search", body={
            "query": {"percolate": {"field": "meta.query",
                                    "document": {"body": "boom"}}},
            "size": 10})
        assert [h["_id"] for h in res["hits"]["hits"]] == ["r"]

    def test_flat_dotted_source_form(self, node):
        _handle(node, "PUT", "/fd", body={"mappings": {"properties": {
            "meta": {"properties": {"query": {"type": "percolator"}}},
            "body": {"type": "text"}}}})
        _handle(node, "PUT", "/fd/_doc/r", params={"refresh": "true"},
                body={"meta.query": {"match": {"body": "boom"}}})
        _, res = _handle(node, "POST", "/fd/_search", body={
            "query": {"percolate": {"field": "meta.query",
                                    "document": {"body": "boom"}}},
            "size": 10})
        assert [h["_id"] for h in res["hits"]["hits"]] == ["r"]
