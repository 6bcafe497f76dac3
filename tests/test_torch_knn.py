"""Port copy of ``test_knn.py``: dense_vector mapping validation, the
``knn`` search section (exact top-k against a numpy oracle, the
similarity maps, filters, boosts, the ``similarity`` cutoff, hybrid
BM25 + kNN union scoring, several segments with deletes, persistence)
and the vector score-script functions.

Every request goes to the reference node and to the port node
(``torch_rest_pair``) and must give the same status and bytes, scores
included (``took`` zeroed), as well as the reference file's
expectations. Beyond the reference file: each similarity alone and
hybrid on a seeded 150-doc index, two clauses with boosts, a filtered
alias, an ``_msearch`` item, and knn over several segments with deletes
through ``_bulk``.
"""

import json

import numpy as np
import pytest
import torch

from torch_rest_pair import Pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("knn"))
    yield p
    p.close()


VECS = {
    "0": [1.0, 0.0, 0.0, 0.0],
    "1": [0.9, 0.1, 0.0, 0.0],
    "2": [0.0, 1.0, 0.0, 0.0],
    "3": [0.0, 0.0, 1.0, 0.0],
    "4": [0.5, 0.5, 0.0, 0.0],
}


@pytest.fixture(scope="module")
def vecindex(pair):
    pair.same("PUT", "/v", {"mappings": {"properties": {
        "emb": {"type": "dense_vector", "dims": 4,
                "similarity": "cosine"},
        "color": {"type": "keyword"},
        "title": {"type": "text"}}}})
    for doc_id, v in VECS.items():
        pair.same("PUT", f"/v/_doc/{doc_id}", {
            "emb": v, "color": "red" if int(doc_id) % 2 == 0 else "blue",
            "title": f"doc {doc_id} fox"}, params={"refresh": "true"})
    return pair


def _cos(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _bulk(pair, index, docs, refresh="true"):
    lines = []
    for doc_id, src in docs:
        lines.append(json.dumps({"index": {"_id": doc_id}}))
        lines.append(json.dumps(src))
    raw = ("\n".join(lines) + "\n").encode()
    return pair.same("POST", f"/{index}/_bulk", raw=raw,
                     params={"refresh": refresh})


class TestMapping:
    def test_requires_dims(self, pair):
        status, _ = pair.same("PUT", "/bad", {"mappings": {
            "properties": {"e": {"type": "dense_vector"}}}})
        assert status == 400

    def test_rejects_wrong_length_vector(self, vecindex):
        status, _ = vecindex.same("PUT", "/v/_doc/x", {"emb": [1.0, 2.0]})
        assert status == 400

    def test_rejects_bad_similarity(self, pair):
        status, _ = pair.same("PUT", "/bad", {"mappings": {
            "properties": {"e": {"type": "dense_vector", "dims": 2,
                                 "similarity": "hamming"}}}})
        assert status == 400

    def test_mapping_roundtrip(self, vecindex):
        _, res = vecindex.same("GET", "/v/_mapping")
        emb = res["v"]["mappings"]["properties"]["emb"]
        assert emb == {"type": "dense_vector", "dims": 4,
                       "similarity": "cosine"}


class TestKnnSearch:
    def test_knn_only_exact_order(self, vecindex):
        q = [1.0, 0.05, 0.0, 0.0]
        status, res = vecindex.same("POST", "/v/_search", {
            "knn": {"field": "emb", "query_vector": q, "k": 3,
                    "num_candidates": 10}})
        assert status == 200, res
        hits = res["hits"]["hits"]
        oracle = sorted(VECS, key=lambda d: -_cos(q, VECS[d]))[:3]
        assert [h["_id"] for h in hits] == oracle
        for h in hits:
            expect = (1 + _cos(q, VECS[h["_id"]])) / 2
            assert h["_score"] == pytest.approx(expect, rel=1e-5)
        assert res["hits"]["total"]["value"] == 3

    def test_knn_filter(self, vecindex):
        status, res = vecindex.same("POST", "/v/_search", {
            "knn": {"field": "emb", "query_vector": [1.0, 0.0, 0.0, 0.0],
                    "k": 2, "num_candidates": 10,
                    "filter": {"term": {"color": "blue"}}}})
        assert status == 200, res
        ids = [h["_id"] for h in res["hits"]["hits"]]
        assert set(ids) <= {"1", "3"}  # blue docs only
        assert ids[0] == "1"

    def test_knn_k_and_candidates_validation(self, vecindex):
        status, _ = vecindex.same("POST", "/v/_search", {
            "knn": {"field": "emb", "query_vector": [1, 0, 0, 0],
                    "k": 10, "num_candidates": 3}})
        assert status == 400
        status, _ = vecindex.same("POST", "/v/_search", {
            "knn": {"field": "emb", "query_vector": [1, 0]}})
        assert status == 400  # dims mismatch
        status, _ = vecindex.same("POST", "/v/_search", {
            "knn": {"field": "title", "query_vector": [1, 0, 0, 0]}})
        assert status == 400  # not a dense_vector field

    def test_hybrid_query_plus_knn_sums_scores(self, vecindex):
        q = [1.0, 0.0, 0.0, 0.0]
        text = {"match": {"title": "fox"}}
        _, base = vecindex.same("POST", "/v/_search",
                                {"query": text, "size": 10})
        text_scores = {h["_id"]: h["_score"]
                       for h in base["hits"]["hits"]}
        status, res = vecindex.same("POST", "/v/_search", {
            "query": text,
            "knn": {"field": "emb", "query_vector": q, "k": 2,
                    "num_candidates": 10},
            "size": 10})
        assert status == 200, res
        knn_top2 = sorted(VECS, key=lambda d: -_cos(q, VECS[d]))[:2]
        for h in res["hits"]["hits"]:
            expect = text_scores.get(h["_id"], 0.0)
            if h["_id"] in knn_top2:
                expect += (1 + _cos(q, VECS[h["_id"]])) / 2
            assert h["_score"] == pytest.approx(expect, rel=1e-4), h
        assert res["hits"]["total"]["value"] == len(text_scores)

    def test_knn_boost(self, vecindex):
        status, res = vecindex.same("POST", "/v/_search", {
            "knn": {"field": "emb", "query_vector": [1.0, 0.0, 0.0, 0.0],
                    "k": 1, "num_candidates": 10, "boost": 7.0}})
        assert status == 200, res
        h = res["hits"]["hits"][0]
        assert h["_id"] == "0"
        assert h["_score"] == pytest.approx(7.0 * 1.0, rel=1e-5)

    def test_knn_across_segments_and_deletes(self, pair):
        pair.same("PUT", "/seg", {"mappings": {"properties": {
            "e": {"type": "dense_vector", "dims": 2}}}})
        rng = np.random.RandomState(7)
        vecs = {}
        for i in range(20):
            v = rng.randn(2).tolist()
            vecs[str(i)] = v
            pair.same("PUT", f"/seg/_doc/{i}", {"e": v},
                      params={"refresh": str(i % 3 == 0).lower()})
        pair.same("POST", "/seg/_refresh")
        for i in (3, 7):
            pair.same("DELETE", f"/seg/_doc/{i}", params={"refresh": "true"})
            del vecs[str(i)]
        q = rng.randn(2).tolist()
        status, res = pair.same("POST", "/seg/_search", {
            "knn": {"field": "e", "query_vector": q, "k": 5,
                    "num_candidates": 30}})
        assert status == 200, res
        oracle = sorted(vecs, key=lambda d: -_cos(q, vecs[d]))[:5]
        assert [h["_id"] for h in res["hits"]["hits"]] == oracle

    def test_exact_recall_vs_oracle(self, pair):
        """Brute force is exact: recall@10 == 1.0 against numpy."""
        pair.same("PUT", "/big", {"mappings": {"properties": {
            "e": {"type": "dense_vector", "dims": 8,
                  "similarity": "l2_norm"}}}})
        rng = np.random.RandomState(42)
        mat = rng.randn(150, 8).astype(np.float32)
        _bulk(pair, "big", [(str(i), {"e": mat[i].tolist()})
                            for i in range(150)])
        q = rng.randn(8).astype(np.float32)
        status, res = pair.same("POST", "/big/_search", {
            "knn": {"field": "e", "query_vector": q.tolist(), "k": 10,
                    "num_candidates": 50}, "size": 10})
        assert status == 200, res
        got = [h["_id"] for h in res["hits"]["hits"]]
        d2 = ((mat - q) ** 2).sum(axis=1)
        assert got == [str(i) for i in np.argsort(d2)[:10]]
        top = res["hits"]["hits"][0]
        assert top["_score"] == pytest.approx(
            1.0 / (1.0 + float(d2[int(top["_id"])])), rel=1e-4)

    def test_knn_survives_restart(self, tmp_path):
        p = Pair(tmp_path)
        try:
            p.same("PUT", "/p", {"mappings": {"properties": {
                "e": {"type": "dense_vector", "dims": 2}}}})
            p.same("PUT", "/p/_doc/a", {"e": [1.0, 0.0]},
                   params={"refresh": "true"})
            p.same("POST", "/p/_flush")
            p.restart()
            status, res = p.same("POST", "/p/_search", {
                "knn": {"field": "e", "query_vector": [1.0, 0.0],
                        "k": 1}})
            assert status == 200, res
            assert res["hits"]["hits"][0]["_id"] == "a"
            assert res["hits"]["hits"][0]["_score"] == pytest.approx(1.0)
        finally:
            p.close()

    def test_similarity_threshold(self, pair):
        pair.same("PUT", "/thr", {"mappings": {"properties": {
            "e": {"type": "dense_vector", "dims": 2,
                  "similarity": "l2_norm"}}}})
        for i, v in enumerate([[0.0, 0.0], [3.0, 0.0], [10.0, 0.0]]):
            pair.same("PUT", f"/thr/_doc/{i}", {"e": v},
                      params={"refresh": "true"})
        # l2_norm: `similarity` is the MAX distance
        status, res = pair.same("POST", "/thr/_search", {
            "knn": {"field": "e", "query_vector": [0.0, 0.0], "k": 3,
                    "num_candidates": 10, "similarity": 5.0}})
        assert status == 200, res
        assert {h["_id"] for h in res["hits"]["hits"]} == {"0", "1"}
        # cosine: `similarity` is the MIN raw cosine
        pair.same("PUT", "/thc", {"mappings": {"properties": {
            "e": {"type": "dense_vector", "dims": 2}}}})
        for i, v in enumerate([[1.0, 0.0], [0.0, 1.0]]):
            pair.same("PUT", f"/thc/_doc/{i}", {"e": v},
                      params={"refresh": "true"})
        status, res = pair.same("POST", "/thc/_search", {
            "knn": {"field": "e", "query_vector": [1.0, 0.0], "k": 2,
                    "num_candidates": 10, "similarity": 0.9}})
        assert status == 200, res
        assert [h["_id"] for h in res["hits"]["hits"]] == ["0"]

    def test_internal_knn_docs_key_rejected_from_rest(self, vecindex):
        status, _ = vecindex.same("POST", "/v/_search", {
            "_knn_docs": {"v#0": [{"boost": 1.0, "segments": {}}]}})
        assert status == 400

    def test_knn_rejects_sort_combo(self, vecindex):
        status, _ = vecindex.same("POST", "/v/_search", {
            "knn": {"field": "emb", "query_vector": [1, 0, 0, 0]},
            "sort": [{"color": "asc"}]})
        assert status == 400


class TestScriptVectorFunctions:
    def test_cosine_similarity_script(self, vecindex):
        q = [1.0, 0.0, 0.0, 0.0]
        status, res = vecindex.same("POST", "/v/_search", {
            "query": {"script_score": {
                "query": {"exists": {"field": "emb"}},
                "script": {
                    "source": "cosineSimilarity(params.qv, 'emb') + 1.0",
                    "params": {"qv": q}}}},
            "size": 10})
        assert status == 200, res
        for h in res["hits"]["hits"]:
            assert h["_score"] == pytest.approx(
                _cos(q, VECS[h["_id"]]) + 1.0, rel=1e-5)

    def test_dot_product_and_l2(self, vecindex):
        q = [0.5, 0.5, 0.0, 0.0]
        status, res = vecindex.same("POST", "/v/_search", {
            "query": {"script_score": {
                "query": {"term": {"color": "red"}},
                "script": {"source": "dotProduct(params.qv, 'emb')",
                           "params": {"qv": q}}}},
            "size": 10})
        assert status == 200, res
        for h in res["hits"]["hits"]:
            expect = float(np.asarray(q) @ np.asarray(VECS[h["_id"]]))
            assert h["_score"] == pytest.approx(expect, rel=1e-5, abs=1e-6)

    def test_bad_field_in_script_400(self, vecindex):
        status, _ = vecindex.same("POST", "/v/_search", {
            "query": {"script_score": {
                "query": {"match_all": {}},
                "script": {"source": "cosineSimilarity(params.qv, 'nope')",
                           "params": {"qv": [1, 0, 0, 0]}}}}})
        assert status == 400


# ---------------------------------------------------------------------------
# the port's byte comparisons beyond the reference file
# ---------------------------------------------------------------------------

DIMS = {"cosine": 13, "dot_product": 64, "l2_norm": 100}
WORDS = ("alpha", "beta", "gamma", "delta", "eps", "zeta")


@pytest.fixture(scope="module")
def simindex(pair):
    """One index a similarity: 150 seeded docs over 2 shards, three
    segments a shard (two bulks and a refresh between), a few docs
    without a vector, a few deleted; a text field and a keyword."""
    rng = np.random.RandomState(11)
    for sim, dims in DIMS.items():
        name = f"s_{sim}"
        pair.same("PUT", f"/{name}", {
            "settings": {"number_of_shards": 2},
            "mappings": {"properties": {
                "vec": {"type": "dense_vector", "dims": dims,
                        "similarity": sim},
                "tag": {"type": "keyword"},
                "body": {"type": "text"}}}})
        docs = []
        for i in range(150):
            v = rng.standard_normal(dims).astype(np.float32)
            if sim == "dot_product":
                v /= np.linalg.norm(v)
            src = {"tag": "even" if i % 2 == 0 else "odd",
                   "body": " ".join(rng.choice(WORDS, 4))}
            if i % 17 != 5:
                src["vec"] = v.tolist()
            docs.append((str(i), src))
        _bulk(pair, name, docs[:60])
        _bulk(pair, name, docs[60:120])
        _bulk(pair, name, docs[120:], refresh="false")
        pair.same("POST", f"/{name}/_refresh")
        for i in (4, 33, 130):
            pair.same("DELETE", f"/{name}/_doc/{i}",
                      params={"refresh": "true"})
    return pair


def _query_vector(sim, seed):
    v = np.random.RandomState(seed).standard_normal(DIMS[sim])
    if sim == "dot_product":
        v /= np.linalg.norm(v)
    return v.astype(np.float32).tolist()


def _bodies(sim):
    q = _query_vector(sim, 1)
    knn = {"field": "vec", "query_vector": q, "k": 8, "num_candidates": 40}
    cutoff = {"cosine": 0.1, "dot_product": 0.05, "l2_norm": 14.0}[sim]
    return {
        "alone": {"knn": knn},
        "hybrid": {"query": {"match": {"body": "alpha gamma"}},
                   "knn": knn, "size": 20},
        "filter": {"knn": dict(knn, filter={"term": {"tag": "odd"}})},
        "boost": {"knn": dict(knn, boost=2.5), "size": 5},
        "cutoff": {"knn": dict(knn, similarity=cutoff, k=30,
                               num_candidates=100), "size": 30},
        "two_clauses": {"knn": [dict(knn, boost=0.3),
                                dict(knn, query_vector=_query_vector(sim, 2),
                                     boost=0.7)],
                        "size": 12},
        "from": {"knn": dict(knn, k=12), "from": 3, "size": 5},
    }


@pytest.mark.parametrize("shape", sorted(_bodies("cosine")))
@pytest.mark.parametrize("sim", sorted(DIMS))
def test_knn_bodies_match_reference(simindex, sim, shape):
    """Each body shape on each similarity's index: the reference node's
    status and bytes."""
    status, res = simindex.same("POST", f"/s_{sim}/_search",
                                _bodies(sim)[shape])
    assert status == 200, res
    assert res["hits"]["hits"], res


def test_knn_through_a_filtered_alias(simindex):
    """A filtered alias folds its filter into the knn clause's filter and
    the text query's: the reference's bytes."""
    simindex.same("POST", "/_aliases", {"actions": [{"add": {
        "index": "s_cosine", "alias": "evens",
        "filter": {"term": {"tag": "even"}}}}]})
    for body in (_bodies("cosine")["alone"], _bodies("cosine")["hybrid"]):
        status, res = simindex.same("POST", "/evens/_search", body)
        assert status == 200, res
        assert all(int(h["_id"]) % 2 == 0 for h in res["hits"]["hits"])


def test_knn_msearch_item(simindex):
    """An _msearch item takes knn through the same search function."""
    lines = [{"index": "s_l2_norm"}, _bodies("l2_norm")["alone"],
             {"index": "s_cosine"}, _bodies("cosine")["hybrid"],
             {"index": "s_cosine"},
             {"knn": {"field": "vec", "query_vector": [1.0]}}]
    raw = "".join(json.dumps(x) + "\n" for x in lines).encode()
    status, res = simindex.same("POST", "/_msearch", raw=raw)
    assert status == 200
    first, second, third = res["responses"]
    assert first["hits"]["hits"] and second["hits"]["hits"]
    assert third["status"] == 400


def test_knn_with_sort_and_knn_docs_are_400s(simindex):
    for body in ({"knn": _bodies("cosine")["alone"]["knn"],
                  "sort": ["_score"]},
                 {"knn": _bodies("cosine")["alone"]["knn"],
                  "collapse": {"field": "tag"}},
                 {"query": {"match_all": {}},
                  "_knn_docs": {"s_cosine#0": []}}):
        status, res = simindex.same("POST", "/s_cosine/_search", body)
        assert status == 400, res
