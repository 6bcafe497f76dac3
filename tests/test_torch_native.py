"""The host C helpers of the port against their Python paths and the
reference's: the response splicer gives the bytes ``_py_splice`` and the
reference's serializer give, and the ASCII tokenizer the tokens of the
regex path."""

import json

import numpy as np
import pytest

from elasticsearch_tpu.analysis.analyzers import \
    StandardAnalyzer as RefStandard
from elasticsearch_tpu.search import serializer as ref_ser

from elasticsearch_tpu_torch import native
from elasticsearch_tpu_torch.analysis import StandardAnalyzer
from elasticsearch_tpu_torch.analysis.analyzers import standard_tokenize
from elasticsearch_tpu_torch.search import serializer

TEXTS = ["The quick brown fox's tail, e.g. U.S.A. and 3.14",
         "snake_case __dunder__ _x_ a_b_c",
         "Ünïcode wörds stay on the regex path",
         "x" * 300 + " short",
         "", "   ", "don't stop-me now... ok'"]


@pytest.mark.parametrize("text", TEXTS, ids=[f"t{i}" for i in range(7)])
def test_tokenizer_matches_regex_path_and_reference(text):
    got = StandardAnalyzer().analyze_slots(text)
    assert got == [t.lower() for t in standard_tokenize(text)]
    assert got == RefStandard().analyze_slots(text)
    assert native.used().get("fast_tokenize") in ("c", "python")


def make_columns(rng, n, extras):
    ids = [f"id-{i}\"q" if i % 7 == 0 else f"d{i}" for i in range(n)]
    scores = [float(np.float32(x)) for x in rng.uniform(0, 20, n)]
    names = ["idx", "other"]
    name_idx = [int(x) for x in rng.integers(0, 2, n)]
    extra = ([{"_source": {"body": f"w{i}, {{x}}", "n": [i, "a]b"]}}
              if i % 3 else {} for i in range(n)] if extras else None)
    return ids, scores, names, name_idx, extra


@pytest.mark.parametrize("extras", [False, True], ids=["meta", "source"])
@pytest.mark.parametrize("n", [0, 1, 257])
def test_splicer_matches_python_path_and_reference(n, extras):
    rng = np.random.default_rng(n + 3)
    ids, scores, names, name_idx, extra = make_columns(rng, n, extras)
    args = (n, json.dumps(ids, separators=(",", ":")),
            json.dumps(scores, separators=(",", ":")),
            json.dumps(names, separators=(",", ":")), name_idx,
            None if extra is None else json.dumps(extra,
                                                  separators=(",", ":")))
    cols = serializer.SpliceColumns(*args)
    got = serializer.splice_hits_bytes(cols)
    want = ref_ser.splice_hits_bytes(ref_ser.SpliceColumns(*args))
    assert got == want
    if n:
        assert got == serializer._py_splice(cols)
        hits = [dict({"_index": names[name_idx[i]], "_id": ids[i],
                      "_score": scores[i]}, **(extra[i] if extra else {}))
                for i in range(n)]
        assert got == json.dumps(hits, separators=(",", ":"))
        assert native.used()["response_splice"] in ("c", "python")
