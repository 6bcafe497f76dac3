"""Port copy of ``test_rank_eval.py``: the ranking metrics, the
``_rank_eval`` route and the synthetic corpus's planted relevance.

The metric cases run the port's ``search/rank_eval.py`` and the
reference's on the same ratings: the same floats. The REST cases go to
the reference node and the port node (``torch_rest_pair``): status and
response bytes must be equal, with ``took`` at 0 and only
``torch_rest_pair.MASKED``'s fields masked. The corpus case ranks the
port's synthetic corpus (``benchmark/corpus.py``) through the port
node.
"""

import math

import numpy as np
import pytest
import torch

from elasticsearch_tpu.search import rank_eval as ref_rank_eval

from elasticsearch_tpu_torch.benchmark import corpus as corpus_gen
from elasticsearch_tpu_torch.search import rank_eval

from torch_rest_pair import Pair

torch.set_num_threads(1)


def both(name, *args, **kwargs):
    got = getattr(rank_eval, name)(*args, **kwargs)
    assert got == getattr(ref_rank_eval, name)(*args, **kwargs)
    return got


class TestMetricMath:
    def test_precision(self):
        assert both("precision_at_k", [1, 0, 1, None, 1], 5) == 3 / 5
        assert both("precision_at_k", [1, 0, 1, None, 1], 5,
                    ignore_unlabeled=True) == 3 / 4
        assert both("precision_at_k", [], 5) == 0.0

    def test_recall(self):
        assert both("recall_at_k", [1, 0, 1], 3, total_relevant=4) == 0.5

    def test_mrr(self):
        assert both("reciprocal_rank", [0, 0, 1, 1], 10) == 1 / 3
        assert both("reciprocal_rank", [None, 2], 10) == 1 / 2
        assert both("reciprocal_rank", [0, 0], 10) == 0.0

    def test_dcg_reference_formula(self):
        got = both("dcg_at_k", [3, 2, 3], 10)
        want = 7 / 1 + 3 / math.log2(3) + 7 / 2
        assert got == pytest.approx(want)

    def test_ndcg_perfect_is_one(self):
        assert both("ndcg_at_k", [3, 2, 1], 10) == pytest.approx(1.0)
        assert both("ndcg_at_k", [1, 2, 3], 10) < 1.0

    def test_ndcg_uses_full_rating_pool(self):
        assert both("ndcg_at_k", [2], 10, all_ratings=[2, 3]) < 1.0

    def test_err_monotone_in_rank(self):
        hi = both("err_at_k", [3, 0, 0], 10)
        lo = both("err_at_k", [0, 0, 3], 10)
        assert hi > lo > 0


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


class TestRestRankEval:
    def test_ndcg_through_rest(self, pair):
        docs = {"1": "quick brown fox", "2": "quick fox", "3": "lazy dog",
                "4": "brown dog", "5": "quick quick quick"}
        for i, text in docs.items():
            pair.same("PUT", f"/idx/_doc/{i}", {"body": text})
        pair.same("POST", "/idx/_refresh")
        status, out = pair.same("POST", "/idx/_rank_eval", {
            "requests": [{
                "id": "q1",
                "request": {"query": {"match": {"body": "quick"}}},
                "ratings": [{"_id": "1", "rating": 2},
                            {"_id": "2", "rating": 3},
                            {"_id": "5", "rating": 1}],
            }],
            "metric": {"dcg": {"k": 10, "normalize": True}},
        })
        assert status == 200
        assert 0.0 < out["metric_score"] <= 1.0
        assert out["details"]["q1"]["unrated_docs"] == 0

    def test_mrr_through_rest(self, pair):
        pair.same("PUT", "/idx/_doc/a", {"body": "x y"})
        pair.same("PUT", "/idx/_doc/b", {"body": "x x"})
        pair.same("POST", "/idx/_refresh")
        status, out = pair.same("POST", "/idx/_rank_eval", {
            "requests": [{"id": "q",
                          "request": {"query": {"match": {"body": "x"}}},
                          "ratings": [{"_id": "a", "rating": 1}]}],
            "metric": {"mean_reciprocal_rank": {"k": 5}},
        })
        assert status == 200
        # doc b (tf=2) outranks a → first relevant at rank 2
        assert out["metric_score"] == pytest.approx(0.5)

    @pytest.mark.parametrize("metric", [
        {"precision": {"k": 3, "ignore_unlabeled": True}},
        {"recall": {"k": 3}},
        {"dcg": {"k": 4}},
        {"expected_reciprocal_rank": {"k": 4, "maximum_relevance": 3}}],
        ids=["precision", "recall", "dcg", "err"])
    def test_other_metrics_through_rest(self, pair, metric):
        for i, text in enumerate(["red shoes", "red red hat", "blue shoes",
                                  "red shoes shoes"]):
            pair.same("PUT", f"/idx/_doc/{i}", {"body": text})
        pair.same("POST", "/idx/_refresh")
        status, _ = pair.same("POST", "/_rank_eval", {
            "requests": [
                {"id": "red", "request": {"query": {"match": {
                    "body": "red"}}, "sort": ["_doc"]},
                 "ratings": [{"_index": "idx", "_id": "1", "rating": 3},
                             {"_id": "3", "rating": 1}]},
                {"id": "shoes", "request": {"query": {"match": {
                    "body": "shoes"}}},
                 "ratings": [{"_id": "2", "rating": 2}]}],
            "metric": metric})
        assert status == 200

    def test_bad_metric_400(self, pair):
        pair.same("PUT", "/idx/_doc/1", {"body": "x"})
        status, _ = pair.same("POST", "/idx/_rank_eval", {
            "requests": [{"id": "q", "request": {}, "ratings": []}],
            "metric": {"nope": {}}})
        assert status == 400


class TestSyntheticCorpus:
    def test_shapes_and_zipf(self):
        c = corpus_gen.generate(2000, vocab_size=500, num_queries=8,
                                seed=7)
        assert c.num_docs == 2000
        assert len(c.queries) == 8 and len(c.qrels) == 8
        counts = np.bincount(np.concatenate(c.doc_tokens), minlength=500)
        assert counts[0] > counts[50] > counts[400]
        for qi, rel in enumerate(c.qrels):
            for doc_idx in rel:
                toks = set(int(t) for t in c.doc_tokens[doc_idx])
                assert all(t in toks for t in c.queries[qi])

    def test_planted_relevance_is_findable_by_bm25(self, pair):
        """BM25 over the synthetic corpus ranks the planted docs highly,
        through the port's `_rank_eval` (the reference's bytes)."""
        c = corpus_gen.generate(1500, vocab_size=800, num_queries=6,
                                relevant_per_query=3, seed=11)
        pair.same("PUT", "/q", {"mappings": {
            "properties": {"body": {"type": "text"}}}})
        raw = "".join('{"index": {"_id": "%d"}}\n{"body": "%s"}\n'
                      % (i, c.doc_text(i)) for i in range(c.num_docs))
        pair.same("POST", "/q/_bulk", raw=raw.encode())
        pair.same("POST", "/q/_refresh")
        _, out = pair.same("POST", "/q/_rank_eval", {
            "requests": [{"id": str(qi), "request": {"query": {"match": {
                "body": c.query_text(qi)}}, "size": 10},
                "ratings": [{"_id": str(d), "rating": r}
                            for d, r in c.qrels[qi].items()]}
                for qi in range(len(c.queries))],
            "metric": {"dcg": {"k": 10, "normalize": True}}})
        assert out["metric_score"] > 0.5
