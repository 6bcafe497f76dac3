"""Port copy of ``test_analysis_depth.py``: porter stemming,
ngram/edge_ngram, shingle and synonym filters, and custom analyzer
chains through mapping, search and phrase positions.

The filter functions are held against the reference's on the same
inputs (and the reference file's expectations); the end-to-end cases
send every request to the reference node and the port node
(``torch_rest_pair``) and compare status and bytes, the ``_analyze``
API cases and ``test_highlight_unaffected_for_plain_analyzer`` among
them.
"""

import pytest
import torch

from elasticsearch_tpu.analysis import filters as ref_flt

from elasticsearch_tpu_torch.analysis.filters import (
    flatten_slots, make_ngram_filter, make_ngram_tokenizer,
    make_shingle_filter, make_synonym_filter, parse_synonym_rules,
    porter_stem)
from elasticsearch_tpu_torch.common.errors import IllegalArgumentException

from torch_rest_pair import Pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("analysis_depth"))
    yield p
    p.close()


class TestPorterStemmer:
    # golden pairs from the Porter paper / Lucene PorterStemFilter
    GOLDEN = {
        "caresses": "caress", "ponies": "poni", "ties": "ti",
        "caress": "caress", "cats": "cat",
        "feed": "feed", "agreed": "agre", "plastered": "plaster",
        "bled": "bled", "motoring": "motor", "sing": "sing",
        "conflated": "conflat", "troubled": "troubl", "sized": "size",
        "hopping": "hop", "tanned": "tan", "falling": "fall",
        "hissing": "hiss", "fizzed": "fizz", "failing": "fail",
        "filing": "file", "happy": "happi", "sky": "sky",
        "relational": "relat", "conditional": "condit",
        "rational": "ration", "valenci": "valenc", "hesitanci": "hesit",
        "digitizer": "digit", "conformabli": "conform",
        "radicalli": "radic", "differentli": "differ", "vileli": "vile",
        "analogousli": "analog", "vietnamization": "vietnam",
        "predication": "predic", "operator": "oper",
        "feudalism": "feudal", "decisiveness": "decis",
        "hopefulness": "hope", "callousness": "callous",
        "formaliti": "formal", "sensitiviti": "sensit",
        "sensibiliti": "sensibl",
        "triplicate": "triplic", "formative": "form",
        "formalize": "formal", "electriciti": "electr",
        "electrical": "electr", "hopeful": "hope", "goodness": "good",
        "revival": "reviv", "allowance": "allow", "inference": "infer",
        "airliner": "airlin", "gyroscopic": "gyroscop",
        "adjustable": "adjust", "defensible": "defens",
        "irritant": "irrit", "replacement": "replac",
        "adjustment": "adjust", "dependent": "depend",
        "adoption": "adopt", "homologou": "homolog",
        "communism": "commun", "activate": "activ",
        "angulariti": "angular", "homologous": "homolog",
        "effective": "effect", "bowdlerize": "bowdler",
        "probate": "probat", "rate": "rate", "cease": "ceas",
        "controll": "control", "roll": "roll",
        "running": "run", "jumps": "jump", "easily": "easili",
    }

    def test_golden_pairs(self):
        bad = {w: (porter_stem(w), want)
               for w, want in self.GOLDEN.items()
               if porter_stem(w) != want}
        assert not bad, bad

    def test_matches_reference_on_a_word_list(self):
        words = list(self.GOLDEN) + [
            w + suf for w in ("nation", "relate", "hope", "sense", "agree",
                              "happy", "run", "control", "probe")
            for suf in ("", "s", "ed", "ing", "ly", "ness", "ment",
                        "ational", "ization", "fulness", "iveness")]
        assert [porter_stem(w) for w in words] == \
            [ref_flt.porter_stem(w) for w in words]

    def test_short_words_untouched(self):
        for w in ("a", "is", "be"):
            assert porter_stem(w) == w


def same(port_fn, ref_fn, slots):
    got = port_fn(list(slots))
    assert got == ref_fn(list(slots))
    return got


class TestNgramFilters:
    def test_ngram(self):
        assert same(make_ngram_filter(2, 3), ref_flt.make_ngram_filter(2, 3),
                    ["quick"]) == [
            ["qu", "ui", "ic", "ck", "qui", "uic", "ick"]]

    def test_edge_ngram(self):
        assert same(make_ngram_filter(1, 4, edge=True),
                    ref_flt.make_ngram_filter(1, 4, edge=True),
                    ["quick"]) == [["q", "qu", "qui", "quic"]]

    def test_holes_preserved(self):
        assert same(make_ngram_filter(1, 2, edge=True),
                    ref_flt.make_ngram_filter(1, 2, edge=True),
                    ["ab", None, "c"]) == [["a", "ab"], None, ["c"]]

    def test_short_tokens_dropped_without_preserve(self):
        assert same(make_ngram_filter(3, 4), ref_flt.make_ngram_filter(3, 4),
                    ["ab"]) == [None]
        assert same(make_ngram_filter(3, 4, preserve_original=True),
                    ref_flt.make_ngram_filter(3, 4, preserve_original=True),
                    ["ab"]) == [["ab"]]

    def test_bad_params_400(self):
        with pytest.raises(IllegalArgumentException):
            make_ngram_filter(3, 2)

    def test_ngram_tokenizer(self):
        for args, kw, text in (((2, 2), {}, "ab cd"),
                               ((1, 2), {"edge": True}, "ab-cd"),
                               ((1, 3), {}, "Straße 42_x")):
            assert make_ngram_tokenizer(*args, **kw)(text) == \
                ref_flt.make_ngram_tokenizer(*args, **kw)(text)
        assert make_ngram_tokenizer(2, 2)("ab cd") == ["ab", "cd"]
        assert make_ngram_tokenizer(1, 2, edge=True)("ab-cd") == \
            ["a", "ab", "c", "cd"]


class TestShingle:
    def test_basic_bigrams(self):
        assert same(make_shingle_filter(), ref_flt.make_shingle_filter(),
                    ["quick", "brown", "fox"]) == [
            ["quick", "quick brown"], ["brown", "brown fox"], ["fox"]]

    def test_no_unigrams(self):
        assert same(make_shingle_filter(output_unigrams=False),
                    ref_flt.make_shingle_filter(output_unigrams=False),
                    ["a1", "b1", "c1"]) == [["a1 b1"], ["b1 c1"], None]

    def test_trigram_range(self):
        assert same(make_shingle_filter(2, 3, output_unigrams=False),
                    ref_flt.make_shingle_filter(2, 3,
                                                output_unigrams=False),
                    ["x1", "y1", "z1"]) == [
            ["x1 y1", "x1 y1 z1"], ["y1 z1"], None]

    def test_filler_for_stop_holes(self):
        assert same(make_shingle_filter(output_unigrams=False),
                    ref_flt.make_shingle_filter(output_unigrams=False),
                    ["quick", None, "fox"]) == [None, None, None]
        # with a third token the hole is carried as the filler
        assert same(make_shingle_filter(2, 3, filler_token="_"),
                    ref_flt.make_shingle_filter(2, 3, filler_token="_"),
                    ["quick", None, "fox"])[0] == ["quick", "quick _ fox"]

    def test_bad_params(self):
        with pytest.raises(IllegalArgumentException):
            make_shingle_filter(1, 1)


class TestSynonyms:
    def test_equivalence_class(self):
        f = make_synonym_filter(["fast, quick, rapid"])
        r = ref_flt.make_synonym_filter(["fast, quick, rapid"])
        assert same(f, r, ["fast"]) == [["fast", "quick", "rapid"]]
        assert same(f, r, ["slow"]) == ["slow"]

    def test_explicit_mapping(self):
        f = make_synonym_filter(["car, auto => vehicle"])
        r = ref_flt.make_synonym_filter(["car, auto => vehicle"])
        for word in ("car", "auto", "vehicle"):
            assert same(f, r, [word]) == ["vehicle"]

    def test_rules_parse_as_reference(self):
        rules = ["a, b", "c => d, e", "b, f", "G => h"]
        assert parse_synonym_rules(rules) == \
            ref_flt.parse_synonym_rules(rules)

    def test_multi_word_rejected(self):
        with pytest.raises(IllegalArgumentException, match="multi-word"):
            parse_synonym_rules(["new york => ny"])

    def test_flatten(self):
        assert flatten_slots([["a", "b"], None, "c"]) == ["a", "b", "c"]


class TestReviewRegressions:
    def test_shingle_preserves_stacked_synonyms(self):
        out = make_shingle_filter()(make_synonym_filter(["tv, television"])(
            ["tv", "show"]))
        assert out == ref_flt.make_shingle_filter()(
            ref_flt.make_synonym_filter(["tv, television"])(["tv", "show"]))
        assert "tv" in out[0] and "television" in out[0]
        assert "tv show" in out[0]


SETTINGS = {
    "settings": {"analysis": {
        "filter": {
            "my_syn": {"type": "synonym",
                       "synonyms": ["fast, quick, rapid"]},
            "my_edge": {"type": "edge_ngram", "min_gram": 2,
                        "max_gram": 6},
            "my_shingle": {"type": "shingle",
                           "min_shingle_size": 2,
                           "max_shingle_size": 2}},
        "analyzer": {
            "english_stem": {"type": "custom", "tokenizer": "standard",
                             "filter": ["lowercase", "porter_stem"]},
            "syn": {"type": "custom", "tokenizer": "standard",
                    "filter": ["lowercase", "my_syn"]},
            "autocomplete": {"type": "custom", "tokenizer": "standard",
                             "filter": ["lowercase", "my_edge"]},
            "shingled": {"type": "custom", "tokenizer": "standard",
                         "filter": ["lowercase", "my_shingle"]}}}}}


def _index(pair, name, mappings, settings=SETTINGS):
    body = dict(settings)
    body["mappings"] = {"properties": mappings}
    s, b = pair.same("PUT", f"/{name}", body)
    assert s == 200, b


def _ids(res):
    return [h["_id"] for h in res["hits"]["hits"]]


class TestEndToEnd:
    def test_stemmed_search_matches(self, pair):
        _index(pair, "st", {"t": {"type": "text",
                                  "analyzer": "english_stem"}})
        pair.same("PUT", "/st/_doc/1",
                  {"t": "the runner was running quickly"},
                  params={"refresh": "true"})
        for q in ("run", "runs", "running"):
            s, res = pair.same("POST", "/st/_search",
                               {"query": {"match": {"t": q}}})
            assert res["hits"]["total"]["value"] == 1, q

    def test_synonym_search(self, pair):
        _index(pair, "sy", {"t": {"type": "text", "analyzer": "syn"}})
        pair.same("PUT", "/sy/_doc/1", {"t": "a rapid river"},
                  params={"refresh": "true"})
        pair.same("PUT", "/sy/_doc/2", {"t": "a slow river"},
                  params={"refresh": "true"})
        s, res = pair.same("POST", "/sy/_search",
                           {"query": {"match": {"t": "fast"}}})
        assert _ids(res) == ["1"]

    def test_edge_ngram_autocomplete(self, pair):
        _index(pair, "ac", {"t": {"type": "text", "analyzer": "autocomplete",
                                  "search_analyzer": "standard"}})
        pair.same("PUT", "/ac/_doc/1", {"t": "elasticsearch"},
                  params={"refresh": "true"})
        for prefix in ("el", "elas", "elasti"):
            s, res = pair.same("POST", "/ac/_search",
                               {"query": {"match": {"t": prefix}}})
            assert res["hits"]["total"]["value"] == 1, prefix
        s, res = pair.same("POST", "/ac/_search",
                           {"query": {"match": {"t": "xx"}}})
        assert res["hits"]["total"]["value"] == 0

    def test_phrase_positions_respected_with_stemming(self, pair):
        _index(pair, "ph", {"t": {"type": "text",
                                  "analyzer": "english_stem"}})
        pair.same("PUT", "/ph/_doc/1", {"t": "running shoes fit"},
                  params={"refresh": "true"})
        pair.same("PUT", "/ph/_doc/2", {"t": "shoes for running"},
                  params={"refresh": "true"})
        s, res = pair.same("POST", "/ph/_search", {
            "query": {"match_phrase": {"t": "running shoes"}}})
        assert _ids(res) == ["1"]

    def test_analyze_api_stacked_positions(self, pair):
        _index(pair, "an_syn", {})
        s, res = pair.same("GET", "/an_syn/_analyze",
                           {"analyzer": "syn", "text": "fast car"})
        toks = [(t["token"], t["position"]) for t in res["tokens"]]
        assert ("fast", 0) in toks and ("quick", 0) in toks \
            and ("rapid", 0) in toks and ("car", 1) in toks

    def test_analyze_api_porter(self, pair):
        _index(pair, "an_porter", {})
        s, res = pair.same("GET", "/an_porter/_analyze",
                           {"analyzer": "english_stem",
                            "text": "relational databases"})
        assert [t["token"] for t in res["tokens"]] == ["relat", "databas"]

    def test_highlight_unaffected_for_plain_analyzer(self, pair):
        pair.same("PUT", "/hl/_doc/1", {"t": "quick brown fox"},
                  params={"refresh": "true"})
        _, res = pair.same("POST", "/hl/_search", {
            "query": {"match": {"t": "fox"}},
            "highlight": {"fields": {"t": {}}}})
        assert "<em>fox</em>" in \
            res["hits"]["hits"][0]["highlight"]["t"][0]

    def test_shingle_end_to_end(self, pair):
        _index(pair, "sh", {"t": {"type": "text", "analyzer": "shingled"}})
        pair.same("PUT", "/sh/_doc/1", {"t": "quick brown fox"},
                  params={"refresh": "true"})
        pair.same("PUT", "/sh/_doc/2", {"t": "brown quick fox"},
                  params={"refresh": "true"})
        s, res = pair.same("POST", "/sh/_search",
                           {"query": {"term": {"t": "quick brown"}}})
        assert _ids(res) == ["1"]
        s, res = pair.same("POST", "/sh/_search",
                           {"query": {"match": {"t": "brown fox"}}})
        assert res["hits"]["total"]["value"] == 2

    def test_unknown_filter_400(self, pair):
        s, res = pair.same("PUT", "/bad", {
            "settings": {"analysis": {"analyzer": {
                "x": {"type": "custom", "tokenizer": "standard",
                      "filter": ["nosuch"]}}}}})
        assert s == 400, res

    @pytest.mark.parametrize("settings", [
        {"filter": {"f": {"synonyms": ["a, b"]}}},
        {"filter": {"f": {"type": "synonym"}}},
        {"filter": {"f": {"type": "synonym",
                          "synonyms": ["new york => ny"]}}},
        {"filter": {"f": {"type": "ngram", "min_gram": 3,
                          "max_gram": 2}}},
        {"filter": {"f": {"type": "stemmer", "language": "klingon"}}},
        {"filter": {"f": {"type": "nosuch"}}},
        {"tokenizer": {"t": {"type": "nosuch"}}},
        {"tokenizer": {"t": {"min_gram": 1}}},
        {"analyzer": {"a": {"type": "fancy"}}},
        {"analyzer": {"a": {"tokenizer": "nosuch"}}}],
        ids=["filter_no_type", "synonym_no_rules", "synonym_multi_word",
             "ngram_bad_range", "stemmer_language", "filter_type",
             "tokenizer_type", "tokenizer_no_type", "analyzer_type",
             "analyzer_tokenizer"])
    def test_bad_analysis_settings_match_reference(self, pair, settings):
        s, res = pair.same("PUT", "/bad_analysis",
                           {"settings": {"analysis": settings}})
        assert s == 400, res


class TestReviewRegressionsEndToEnd:
    def test_preserve_original_string_false(self, pair):
        _index(pair, "pr", {"t": {"type": "text", "analyzer": "a"}}, {
            "settings": {"analysis": {
                "filter": {"e": {"type": "edge_ngram", "min_gram": 2,
                                 "max_gram": 3,
                                 "preserve_original": "false"}},
                "analyzer": {"a": {"type": "custom",
                                   "tokenizer": "standard",
                                   "filter": ["lowercase", "e"]}}}}})
        # a 1-char token below min_gram with preserve_original "false"
        # is dropped: the doc has no term of its own
        pair.same("PUT", "/pr/_doc/1", {"t": "x yz"},
                  params={"refresh": "true"})
        s, res = pair.same("POST", "/pr/_search",
                           {"query": {"term": {"t": "x"}}})
        assert res["hits"]["total"]["value"] == 0
        s, res = pair.same("POST", "/pr/_search",
                           {"query": {"term": {"t": "yz"}}})
        assert res["hits"]["total"]["value"] == 1

    def test_basic_filters_after_multi_token_filters(self, pair):
        """lowercase/stop after ngram/synonym handle stacked slots."""
        _index(pair, "ord", {
            "a": {"type": "text", "analyzer": "ng_lower"},
            "b": {"type": "text", "analyzer": "syn_stop"}}, {
            "settings": {"analysis": {
                "filter": {"syn": {"type": "synonym",
                                   "synonyms": ["tv, television"]}},
                "analyzer": {
                    "ng_lower": {"type": "custom",
                                 "tokenizer": "standard",
                                 "filter": ["edge_ngram", "lowercase"]},
                    "syn_stop": {"type": "custom",
                                 "tokenizer": "standard",
                                 "filter": ["lowercase", "syn",
                                            "stop"]}}}}})
        pair.same("PUT", "/ord/_doc/1", {"a": "AB", "b": "the tv"},
                  params={"refresh": "true"})
        for field, term, hits in (("a", "a", 1), ("a", "ab", 1),
                                  ("a", "AB", 0), ("b", "television", 1),
                                  ("b", "the", 0)):
            s, res = pair.same("POST", "/ord/_search",
                               {"query": {"term": {field: term}}})
            assert res["hits"]["total"]["value"] == hits, (field, term)


REGISTRY_TEXTS = ["fast car", "relational databases", "quick brown fox",
                  "The Runner was RUNNING quickly, the end.", "x",
                  "tv show on the television", "Élan vital café", ""]


def test_registry_chains_match_reference(pair):
    """The chains of an index's settings analyze to the reference's
    slots, tokens and positions."""
    _index(pair, "an", {})
    port = pair.port.indices.index("an").mapper.analyzers
    ref = pair.ref.indices.index("an").mapper.analyzers
    assert sorted(port) == sorted(ref)
    for name in sorted(ref):
        for text in REGISTRY_TEXTS:
            assert port[name].analyze_slots(text) == \
                ref[name].analyze_slots(text), (name, text)
            assert [(t.term, t.position) for t in port[name].analyze(text)] \
                == [(t.term, t.position)
                    for t in ref[name].analyze(text)], (name, text)
    toks = [(t.term, t.position) for t in port["syn"].analyze("fast car")]
    assert {("fast", 0), ("quick", 0), ("rapid", 0), ("car", 1)} <= \
        set(toks)
    assert port["english_stem"].terms("relational databases") == \
        ["relat", "databas"]
