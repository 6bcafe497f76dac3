"""Port copy of ``test_script.py``, and module tests of the script
module's vector interpreter.

- The engine cases run each script through the reference's
  ``compile_script`` and the port's: the same value, or the same
  ``ScriptException`` text.
- The REST cases (``script_score``, ``function_score`` with a script,
  the scripted ``_update`` and bulk ``update``) go to the reference node
  and the port node (``torch_rest_pair``): status and response bytes
  must be equal, with ``took`` at 0 and only ``torch_rest_pair.MASKED``'s
  fields masked; the reference's assertions run on the shared answer.
- The module cases hold ``CompiledScript.score_vector`` against the
  reference's on the same columns, made from a numpy seed, bit for bit:
  the transcendentals, the weak-typed scalars, the floored remainder and
  the three vector functions in XLA:CPU's summation order.

``bucket_script`` / ``bucket_selector`` (the aggregations' script
pipelines) go through the pair like the REST cases. Left out, each for
its queue: the ingest script processor, and ``_update_by_query`` /
``_reindex`` with a script (Queue A4b).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.script import FieldColumn as RefColumn
from elasticsearch_tpu.script import ScriptException as RefScriptException
from elasticsearch_tpu.script import compile_script as ref_compile

from elasticsearch_tpu_torch.script import (FieldColumn, ScriptException,
                                            compile_script)

from torch_rest_pair import Pair

torch.set_num_threads(1)


def outcome(compile_fn, exc_type, spec, variables):
    try:
        return ("value", compile_fn(spec).execute(variables))
    except exc_type as e:
        return ("error", str(e))


def same_outcome(spec, variables=None, make_vars=None):
    """The reference's and the port's result (or error text) for one
    script; `make_vars` builds fresh (mutable) variables for each."""
    want_vars = make_vars() if make_vars else dict(variables or {})
    got_vars = make_vars() if make_vars else dict(variables or {})
    want = outcome(ref_compile, RefScriptException, spec, want_vars)
    got = outcome(compile_script, ScriptException, spec, got_vars)
    assert got == want, (spec, want, got)
    assert got_vars == want_vars
    return got


# ----------------------------------------------------------------------
# engine semantics
# ----------------------------------------------------------------------

class TestEngine:
    def test_arithmetic_precedence(self):
        assert same_outcome("1 + 2 * 3 - 4 / 2") == ("value", 5)
        assert same_outcome("(1 + 2) * 3") == ("value", 9)
        assert same_outcome("7 % 4") == ("value", 3)
        assert same_outcome("-2 * 3") == ("value", -6)

    def test_math_functions_both_spellings(self):
        assert same_outcome("Math.log(Math.exp(2))")[1] == \
            pytest.approx(2.0)
        assert same_outcome("log(exp(2))")[1] == pytest.approx(2.0)
        assert same_outcome("Math.max(3, Math.min(7, 5))") == ("value", 5)
        assert same_outcome("pow(2, 10)") == ("value", 1024)

    def test_params(self):
        assert same_outcome({"source": "params.a * params.b",
                             "params": {"a": 6, "b": 7}}) == ("value", 42)

    def test_ternary_and_comparison(self):
        s = "params.x > 10 ? 'big' : 'small'"
        assert same_outcome(s, {"params": {"x": 11}}) == ("value", "big")
        assert same_outcome(s, {"params": {"x": 3}}) == ("value", "small")

    def test_boolean_ops_shortcircuit(self):
        assert same_outcome("false && nosuchvar") == ("value", False)

    def test_string_methods_and_concat(self):
        assert same_outcome("('ab' + 'cd').toUpperCase().contains('BC')") \
            == ("value", True)
        assert same_outcome("'hello'.substring(1, 3)") == ("value", "el")
        assert same_outcome("'a,b,c'.splitOnToken(',')") == \
            ("value", ["a", "b", "c"])

    def test_statements_mutate_ctx(self):
        s = ("ctx._source.count += 1;"
             "if (ctx._source.count >= 3) { ctx.op = 'delete' } "
             "else { ctx._source.tag = 'low' }")
        same_outcome(s, make_vars=lambda: {
            "ctx": {"_source": {"count": 1}, "op": "index"}})
        same_outcome(s, make_vars=lambda: {
            "ctx": {"_source": {"count": 2}, "op": "index"}})

    def test_for_in_and_def(self):
        s = ("def total = 0;"
             "for (x : ctx.values) { total += x }"
             "ctx.sum = total; return total;")
        assert same_outcome(s, make_vars=lambda: {
            "ctx": {"values": [1, 2, 3, 4, 5]}}) == ("value", 15)

    def test_list_and_map_methods(self):
        same_outcome("if (!ctx.tags.contains('new')) { ctx.tags.add('new') }",
                     make_vars=lambda: {"ctx": {"tags": ["old"]}})
        same_outcome("ctx.m.remove('a'); ctx.n = ctx.m.size()",
                     make_vars=lambda: {"ctx": {"m": {"a": 1, "b": 2}}})

    def test_op_budget_stops_runaway(self):
        kind, text = same_outcome("for (x : ctx.l) { ctx.l.add(x) }",
                                  make_vars=lambda: {"ctx": {"l": [1]}})
        assert kind == "error" and "budget" in text

    @pytest.mark.parametrize("bad", [
        "new HashMap()", "def x = ", "1 +", "if (true {", "x ===== 3",
        "__import__('os')", "'x'.__class__()", "open", "1 / 0"])
    def test_rejections(self, bad):
        assert same_outcome(bad)[0] == "error"

    def test_stored_scripts_and_bad_lang_rejected(self):
        assert "stored" in same_outcome({"id": "mylib"})[1]
        assert "lang" in same_outcome({"source": "1", "lang": "groovy"})[1]

    def test_string_number_coercion_in_concat(self):
        assert same_outcome("'v=' + 3") == ("value", "v=3")
        assert same_outcome("'b=' + true") == ("value", "b=true")

    def test_ctx_rebind_rejected(self):
        kind, text = same_outcome("ctx = 5", make_vars=lambda: {"ctx": {}})
        assert kind == "error" and "reassign" in text


# ----------------------------------------------------------------------
# script_score and function_score over REST
# ----------------------------------------------------------------------

RANKED = [
    {"title": "alpha fox", "rank": 10, "price": 2.5},
    {"title": "beta fox", "rank": 5, "price": 4.0},
    {"title": "gamma fox", "rank": 2},          # price missing
    {"title": "delta snail", "rank": 100, "price": 1.0},
]


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


@pytest.fixture
def ranked(pair):
    for i, d in enumerate(RANKED):
        pair.same("PUT", f"/books/_doc/{i}", d, params={"refresh": "true"})
    return pair


def script_search(pair, query, **extra):
    return pair.same("POST", "/books/_search",
                     {"query": query, "size": 10, **extra})


FOX = {"match": {"title": "fox"}}


class TestScriptScore:
    def test_script_score_query_replaces_score(self, ranked):
        status, res = script_search(ranked, {"script_score": {
            "query": FOX, "script": {"source": "doc['rank'].value * 2"}}})
        assert status == 200, res
        hits = res["hits"]["hits"]
        assert [h["_id"] for h in hits] == ["0", "1", "2"]
        assert [h["_score"] for h in hits] == [20.0, 10.0, 4.0]

    def test_script_score_sees_base_score(self, ranked):
        base = script_search(ranked, FOX)[1]
        scores = {h["_id"]: h["_score"] for h in base["hits"]["hits"]}
        status, res = script_search(ranked, {"script_score": {
            "query": FOX, "script": {"source": "_score * 10"}}})
        assert status == 200, res
        for h in res["hits"]["hits"]:
            assert h["_score"] == pytest.approx(scores[h["_id"]] * 10,
                                                rel=1e-5)

    def test_missing_value_and_ternary(self, ranked):
        status, res = script_search(ranked, {"script_score": {
            "query": FOX, "script": {
                "source": "doc['price'].empty ? 9.0 : doc['price'].value"}}})
        assert status == 200, res
        by_id = {h["_id"]: h["_score"] for h in res["hits"]["hits"]}
        assert by_id == {"0": 2.5, "1": 4.0, "2": 9.0}

    def test_min_score_filters(self, ranked):
        status, res = script_search(ranked, {"script_score": {
            "query": FOX, "script": {"source": "doc['rank'].value"},
            "min_score": 4}})
        assert status == 200, res
        assert {h["_id"] for h in res["hits"]["hits"]} == {"0", "1"}

    def test_function_score_script_function(self, ranked):
        status, res = script_search(ranked, {"function_score": {
            "query": FOX,
            "functions": [{"script_score": {
                "script": "Math.log(2 + doc['rank'].value)"}}],
            "boost_mode": "replace"}})
        assert status == 200, res
        by_id = {h["_id"]: h["_score"] for h in res["hits"]["hits"]}
        assert by_id["0"] == pytest.approx(math.log(12), rel=1e-5)
        assert by_id["2"] == pytest.approx(math.log(4), rel=1e-5)

    def test_function_score_script_with_weight_and_filter(self, ranked):
        status, res = script_search(ranked, {"function_score": {
            "query": FOX, "score_mode": "sum", "boost_mode": "multiply",
            "functions": [
                {"script_score": {"script": "sqrt(doc['rank'].value)"},
                 "weight": 2},
                {"filter": {"match": {"title": "alpha"}},
                 "script_score": {"script": {
                     "source": "params.k * _score", "params": {"k": 3}}}}]}})
        assert status == 200, res

    def test_saturation_helper(self, ranked):
        status, res = script_search(ranked, {"script_score": {
            "query": FOX,
            "script": {"source": "saturation(doc['rank'].value, 5)"}}})
        assert status == 200, res
        by_id = {h["_id"]: h["_score"] for h in res["hits"]["hits"]}
        assert by_id["0"] == pytest.approx(10 / 15, rel=1e-5)

    def test_bad_script_is_400(self, ranked):
        status, _ = script_search(ranked, {"script_score": {
            "query": {"match_all": {}},
            "script": {"source": "doc['rank'].value +"}}})
        assert status == 400
        status, _ = script_search(ranked, {"script_score": {
            "query": {"match_all": {}},
            "script": {"source": "ctx.x = 1; doc['rank'].value"}}})
        assert status == 400  # statements rejected in score context

    def test_runtime_errors_are_400(self, ranked):
        for source in ("log(1, 2) + _score", "1 / 0 + _score",
                       "cosineSimilarity([1.0], 'rank')",
                       "pow(2, -1) + _score",
                       "pow(doc['rank'].size(), -2) + _score",
                       "min(_score) + 1"):
            status, _ = script_search(ranked, {"script_score": {
                "query": FOX, "script": {"source": source}}})
            assert status == 400, source

    def test_min_score_applies_in_filter_context(self, ranked):
        status, res = script_search(ranked, {"bool": {"filter": [
            {"script_score": {"query": FOX,
                              "script": {"source": "doc['rank'].value"},
                              "min_score": 4}}]}})
        assert status == 200, res
        assert {h["_id"] for h in res["hits"]["hits"]} == {"0", "1"}

    def test_highlight_through_script_score(self, ranked):
        status, res = script_search(ranked, {"script_score": {
            "query": FOX, "script": {"source": "_score * 2"}}},
            highlight={"fields": {"title": {}}})
        assert status == 200, res
        h0 = [h for h in res["hits"]["hits"] if h["_id"] == "0"][0]
        assert "<em>fox</em>" in h0["highlight"]["title"][0]

    def test_float_suffix_and_not_operator(self, ranked):
        status, res = script_search(ranked, {"script_score": {
            "query": FOX, "script": {"source": "!params.flag ? 1.5f : 3.0d",
                                     "params": {"flag": False}}}})
        assert status == 200, res
        assert all(h["_score"] == 1.5 for h in res["hits"]["hits"])

    @pytest.mark.parametrize("source", [
        "Math.log(doc['price'].value - 3)", "sqrt(doc['rank'].value - 6)",
        "tan(doc['rank'].value) + sin(_score) * cos(doc['price'].value)"],
        ids=["log_nan", "sqrt_nan", "trig"])
    def test_nan_and_trig_scores(self, ranked, source):
        status, _ = script_search(ranked, {"script_score": {
            "query": {"match_all": {}}, "script": {"source": source}}})
        assert status == 200

    @pytest.mark.parametrize("score_mode,boost_mode", [
        ("multiply", "multiply"), ("sum", "sum"), ("avg", "avg"),
        ("max", "max"), ("min", "min"), ("max", "replace")])
    def test_function_score_modes_with_nan_functions(self, ranked,
                                                     score_mode,
                                                     boost_mode):
        status, _ = script_search(ranked, {"function_score": {
            "query": FOX, "score_mode": score_mode,
            "boost_mode": boost_mode, "max_boost": 50,
            "functions": [
                {"script_score": {"script": "Math.log(doc['price'].value"
                                            " - 3)"}},
                {"filter": {"match": {"title": "alpha"}},
                 "script_score": {"script": "doc['rank'].value * 3"},
                 "weight": 0.5}]}})
        assert status == 200

    def test_negative_scores_clamped(self, ranked):
        status, res = script_search(ranked, {"script_score": {
            "query": FOX, "script": {"source": "doc['rank'].value - 6"}}})
        assert status == 200, res
        for h in res["hits"]["hits"]:
            assert h["_score"] >= 0.0


@pytest.fixture
def sales(pair):
    rows = [("2021-01-01", 10, 1), ("2021-01-05", 30, 3),
            ("2021-02-02", 100, 2), ("2021-02-20", 50, 5),
            ("2021-03-03", 8, 2)]
    for i, (d, revenue, units) in enumerate(rows):
        pair.same("PUT", f"/sales/_doc/{i}",
                  {"date": d, "revenue": revenue, "units": units},
                  params={"refresh": "true"})
    return pair


class TestBucketScriptSelector:
    def _monthly(self, node, extra_aggs):
        body = {"size": 0, "aggs": {"by_month": {
            "date_histogram": {"field": "date",
                               "calendar_interval": "month"},
            "aggs": {
                "revenue": {"sum": {"field": "revenue"}},
                "units": {"sum": {"field": "units"}},
                **extra_aggs}}}}
        status, res = node.same("POST", "/sales/_search", body)
        assert status == 200, res
        return res["aggregations"]["by_month"]["buckets"]

    def test_bucket_script_per_unit_price(self, sales):
        buckets = self._monthly(sales, {
            "per_unit": {"bucket_script": {
                "buckets_path": {"r": "revenue", "u": "units"},
                "script": "params.r / params.u"}}})
        assert buckets[0]["per_unit"]["value"] == pytest.approx(10.0)
        assert buckets[1]["per_unit"]["value"] == pytest.approx(150 / 7)
        assert buckets[2]["per_unit"]["value"] == pytest.approx(4.0)

    def test_bucket_selector_drops_buckets(self, sales):
        buckets = self._monthly(sales, {
            "keep_big": {"bucket_selector": {
                "buckets_path": {"r": "revenue"},
                "script": "params.r >= 40"}}})
        # Jan=40, Feb=150, Mar=8 → Mar dropped
        assert len(buckets) == 2
        assert [b["revenue"]["value"] for b in buckets] == [40.0, 150.0]

    def test_count_path_and_compose(self, sales):
        buckets = self._monthly(sales, {
            "dense": {"bucket_selector": {
                "buckets_path": {"c": "_count"},
                "script": "params.c >= 2"}}})
        assert all(b["doc_count"] >= 2 for b in buckets)

    def test_bad_script_and_paths_400(self, sales):
        body = {"size": 0, "aggs": {"m": {
            "date_histogram": {"field": "date",
                               "calendar_interval": "month"},
            "aggs": {"x": {"bucket_script": {
                "buckets_path": {"r": "revenue"},
                "script": "params.r +"}}}}}}
        status, _ = sales.same("POST", "/sales/_search", body)
        assert status == 400
        body["aggs"]["m"]["aggs"]["x"]["bucket_script"] = {
            "buckets_path": "notamap", "script": "1"}
        status, _ = sales.same("POST", "/sales/_search", body)
        assert status == 400


# ----------------------------------------------------------------------
# scripted _update and bulk update
# ----------------------------------------------------------------------

class TestScriptedUpdate:
    def test_update_with_script(self, pair):
        pair.same("PUT", "/inv/_doc/1", {"stock": 5, "tags": ["a"]},
                  params={"refresh": "true"})
        status, res = pair.same("POST", "/inv/_update/1", {
            "script": {"source": "ctx._source.stock -= params.n",
                       "params": {"n": 2}}})
        assert status == 200, res
        assert res["result"] == "updated"
        _, doc = pair.same("GET", "/inv/_doc/1")
        assert doc["_source"]["stock"] == 3

    def test_update_script_noop_and_delete(self, pair):
        pair.same("PUT", "/inv/_doc/2", {"stock": 0},
                  params={"refresh": "true"})
        status, res = pair.same("POST", "/inv/_update/2", {
            "script": "if (ctx._source.stock > 0) "
                      "{ ctx._source.stock -= 1 } else { ctx.op = 'noop' }"})
        assert status == 200 and res["result"] == "noop"
        status, res = pair.same("POST", "/inv/_update/2",
                                {"script": "ctx.op = 'delete'"})
        assert status == 200 and res["result"] == "deleted"
        assert pair.same("GET", "/inv/_doc/2")[0] == 404

    def test_scripted_upsert(self, pair):
        pair.same("PUT", "/inv")  # _update never auto-creates
        status, res = pair.same("POST", "/inv/_update/9", {
            "scripted_upsert": True,
            "script": "ctx._source.visits = "
                      "(ctx._source.containsKey('visits') ? "
                      "ctx._source.visits : 0) + 1",
            "upsert": {}})
        assert status == 200, res
        _, doc = pair.same("GET", "/inv/_doc/9")
        assert doc["_source"]["visits"] == 1
        # a plain upsert with a script, and a script without an upsert
        assert pair.same("POST", "/inv/_update/10", {
            "script": "ctx._source.v = 1", "upsert": {"v": 0}})[0] == 200
        assert pair.same("POST", "/inv/_update/11", {
            "script": "ctx._source.v = 1"})[0] == 404

    def test_bulk_update_with_script(self, pair):
        pair.same("PUT", "/inv/_doc/7", {"n": 1}, params={"refresh": "true"})
        raw = (b'{"update": {"_id": "7", "_index": "inv"}}\n'
               b'{"script": {"source": "ctx._source.n += 10"}}\n'
               b'{"update": {"_id": "7", "_index": "inv"}}\n'
               b'{"script": "ctx.op = \'noop\'"}\n'
               b'{"update": {"_id": "7", "_index": "inv"}}\n'
               b'{"script": "ctx._source.n +"}\n')
        status, res = pair.same("POST", "/_bulk", raw=raw)
        assert status == 200, res
        item = res["items"][0]["update"]
        assert item["status"] == 200 and item["result"] == "updated"
        assert res["items"][1]["update"]["result"] == "noop"
        assert res["items"][2]["update"]["status"] == 400
        _, doc = pair.same("GET", "/inv/_doc/7")
        assert doc["_source"]["n"] == 11

    def test_bad_op_and_removed_source_are_400(self, pair):
        pair.same("PUT", "/inv/_doc/4", {"x": 1})
        for script in ("ctx.op = 'explode'", "ctx._source = 5",
                       "ctx._source.x = nosuch"):
            assert pair.same("POST", "/inv/_update/4",
                             {"script": script})[0] == 400, script

    def test_update_doc_and_script_conflict_400(self, pair):
        pair.same("PUT", "/inv/_doc/3", {"x": 1}, params={"refresh": "true"})
        status, _ = pair.same("POST", "/inv/_update/3", {
            "doc": {"x": 2}, "script": "ctx._source.x = 3"})
        assert status == 400


# ----------------------------------------------------------------------
# the vector interpreter against the reference's, bit for bit
# ----------------------------------------------------------------------

N_DOCS = 256


def make_columns(seed: int):
    rng = np.random.default_rng(seed)
    cols = {
        "views": rng.integers(0, 100_000, N_DOCS).astype(np.float64),
        "price": rng.uniform(-50, 50, N_DOCS),
        "rank": rng.integers(-5, 200, N_DOCS).astype(np.float64),
        "tiny": rng.uniform(0, 1e-3, N_DOCS),
    }
    present = {k: rng.random(N_DOCS) > 0.2 for k in cols}
    vec = rng.standard_normal((N_DOCS, 64)).astype(np.float32)
    vec[rng.random(N_DOCS) < 0.1] = np.nan      # docs without a vector
    vecs = {"vec": vec,
            "vec3": rng.standard_normal((N_DOCS, 3)).astype(np.float32)}
    score = rng.uniform(0, 20, N_DOCS).astype(np.float32)
    return cols, present, vecs, score


_Q = np.random.default_rng(9)
Q64 = _Q.standard_normal(64).astype(np.float32).tolist()
Q3 = _Q.standard_normal(3).astype(np.float32).tolist()

VECTOR_CASES = {
    "column_times_int": ("doc['rank'].value * 2", {}),
    "score_times_int": ("_score * 10", {}),
    "empty_ternary": ("doc['price'].empty ? 9.0 : doc['price'].value", {}),
    "log_of_column": ("Math.log(2 + doc['rank'].value)", {}),
    "saturation": ("saturation(doc['rank'].value, 5)", {}),
    "scalar_ternary": ("!params.flag ? 1.5f : 3.0d", {"flag": False}),
    "log_and_pow": ("Math.log(1 + doc['views'].value) "
                    "* Math.pow(_score, 0.5)", {}),
    "integer_pow": ("pow(doc['price'].value, 2) + pow(_score, 3)", {}),
    "negative_integer_pow": ("pow(_score + 1, -2)", {}),
    "float_pow": ("pow(doc['price'].value, 1.5)", {}),
    "column_pow": ("pow(doc['price'].value, doc['rank'].value)", {}),
    "exp": ("exp(doc['tiny'].value * 50) + exp(-_score)", {}),
    "sqrt": ("sqrt(doc['views'].value) / (1 + _score)", {}),
    "log10": ("log10(doc['views'].value + 1)", {}),
    "floored_remainder": ("doc['price'].value % 7 "
                          "+ doc['rank'].value % -3 + _score % 2.5", {}),
    "rounding": ("abs(doc['price'].value) + floor(_score) "
                 "- ceil(doc['tiny'].value) + round(_score * 3)", {}),
    "signum_max": ("signum(doc['price'].value) "
                   "* max(_score, doc['rank'].value, 3)", {}),
    "min": ("min(doc['price'].value, 0) + 100", {}),
    "size": ("doc['views'].size() * _score + doc['price'].size()", {}),
    "logic": ("doc['price'].value > 0 && doc['rank'].value < 100 "
              "? _score : 0", {}),
    "equality": ("doc['rank'].value == 10 ? 1 : 2", {}),
    "sigmoid": ("sigmoid(doc['views'].value, 100, 0.6)", {}),
    "sigmoid_int": ("sigmoid(doc['rank'].value + 1, 4, 2)", {}),
    "params": ("params.a * _score + params.b", {"a": 1.7, "b": 3}),
    "python_division": ("doc['views'].value / 3 + 2 / 7", {}),
    "underflow": ("-doc['price'].value * 1e-30 * 1e-10", {}),
    "weak_constant": ("log(2) * _score", {}),
    "weak_int_where": ("(doc['price'].empty ? 2 : 3) * _score", {}),
    "weak_float_where": ("(doc['price'].empty ? 0.1 : 0.2) + 0.3", {}),
    "weak_functions": ("log(0.1) * _score + pow(2, 0.5) + exp(0.7) "
                       "+ max(2, 3.5) + min(doc['rank'].size(), 0.5)", {}),
    "weak_int_pow": ("pow(3, 2) * _score + pow(doc['rank'].size(), 3)",
                     {}),
    "cosine_64": ("cosineSimilarity(params.q, 'vec') + 1.0", {"q": Q64}),
    "dot_64": ("dotProduct(params.q, 'vec')", {"q": Q64}),
    "l2norm_64": ("1 / (1 + l2norm(params.q, 'vec'))", {"q": Q64}),
    "vector_3": ("cosineSimilarity(params.q, 'vec3') "
                 "+ dotProduct(params.q, 'vec3') "
                 "+ l2norm(params.q, 'vec3')", {"q": Q3}),
}


def score_both(source, params, seed):
    cols, present, vecs, score = make_columns(seed)
    spec = {"source": source, "params": params}

    def ref_resolver(field):
        vals = jnp.asarray(cols[field], dtype=jnp.float32)
        pres = jnp.asarray(present[field])
        return RefColumn(jnp.where(pres, vals, 0.0), pres)

    def port_resolver(field):
        vals = torch.from_numpy(cols[field]).to(torch.float32)
        pres = torch.from_numpy(present[field])
        return FieldColumn(torch.where(pres, vals, torch.zeros_like(vals)),
                           pres)

    want = np.asarray(ref_compile(spec).score_vector(
        ref_resolver, jnp.asarray(score),
        vec_resolver=lambda f: jnp.asarray(vecs[f])))
    got = compile_script(spec).score_vector(
        port_resolver, torch.from_numpy(score),
        vec_resolver=lambda f: torch.from_numpy(vecs[f])).numpy()
    return np.broadcast_to(want, got.shape), got


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(VECTOR_CASES))
def test_score_vector_is_the_references_bit_for_bit(name, seed):
    source, params = VECTOR_CASES[name]
    want, got = score_both(source, params, seed)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("fn", ["sin", "cos", "tan"])
def test_trig_is_the_c_librarys_float_function(fn):
    """sin, cos and tan: XLA:CPU calls the C library's sinf / cosf /
    tanf, over small, medium and large arguments."""
    want, got = score_both(
        f"{fn}(doc['price'].value) + {fn}(doc['views'].value) "
        f"+ {fn}(doc['tiny'].value)", {}, 3)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
