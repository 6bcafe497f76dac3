"""Analyzers and the per-index analysis registry.

Copy of the reference's ``analysis/analyzers.py``:

  - ``standard``: a Unicode word-character regex that keeps ASCII
    apostrophes and periods inside tokens, underscores stripped,
    overlong tokens split at max_token_length, lowercase; no stop words
    unless the index defines them;
  - ``simple``: split on non-letters + lowercase;
  - ``whitespace``: split on whitespace, no lowercasing;
  - ``keyword``: the whole input as a single token;
  - ``stop``: simple + English stop-word removal;
  - custom: a tokenizer and a filter chain from
    ``index.analysis.{analyzer,filter,tokenizer}.*`` (``AnalysisRegistry``).

A chain returns SLOTS (``analysis/filters.py``): a removed stop word
leaves a hole, a synonym or ngram filter stacks terms at one position.
The ASCII fast path of tokenize + lowercase runs in C
(``csrc/fast_tokenize.c``, through ``native``) for exactly the chains
where the reference takes it: a ``standard`` analyzer without stop
words (``StandardAnalyzer._has_stop`` false). Non-ASCII text, an
overlong token or a missing compiler take the regex path, which gives
the same tokens.
"""

from __future__ import annotations

import ctypes
import dataclasses
import re
import threading
from typing import Callable, Dict, List, Optional, Sequence

from elasticsearch_tpu_torch import native
from elasticsearch_tpu_torch.analysis import filters as flt
from elasticsearch_tpu_torch.common.errors import IllegalArgumentException

# the classic Lucene EnglishAnalyzer/StopAnalyzer default stop set
ENGLISH_STOP_WORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with".split()
)


@dataclasses.dataclass(frozen=True)
class Token:
    term: str
    position: int


# Unicode "word" runs; \w covers letters/digits/underscore across scripts.
_WORD_RE = re.compile(r"\w+(?:[.']\w+)*", re.UNICODE)
_LETTER_RE = re.compile(r"[^\W\d_]+", re.UNICODE)


class _NativeTokenizer:
    """ctypes wrapper for csrc/fast_tokenize.c. Returns None → the caller
    takes the regex path (non-ASCII, overlong tokens, or no compiler)."""

    def __init__(self):
        self._fn = None
        self._tried = False

    def _load(self) -> bool:
        if not self._tried:
            self._tried = True
            self._fn = native.bind(
                "fast_tokenize", "fast_tokenize_ascii", ctypes.c_long,
                [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                 ctypes.c_char_p, ctypes.c_long,
                 ctypes.POINTER(ctypes.c_long)])
            native.note("fast_tokenize",
                        "c" if self._fn is not None else "python")
        return self._fn is not None

    _tls = threading.local()

    def lowered_tokens(self, text: str, max_token_length: int):
        if not self._load():
            return None
        try:
            raw = text.encode("ascii")
        except UnicodeEncodeError:
            return None
        tls = self._tls
        cap = getattr(tls, "cap", 0)
        if cap < len(raw) + 16:
            cap = max(1 << 16, 2 * (len(raw) + 16))
            tls.cap = cap
            tls.buf = ctypes.create_string_buffer(cap)
            tls.out_len = ctypes.c_long(0)
            tls.out_ref = ctypes.byref(tls.out_len)
        n = self._fn(raw, len(raw), max_token_length, tls.buf, cap,
                     tls.out_ref)
        if n < 0:
            return None
        if n == 0:
            return []
        return ctypes.string_at(tls.buf,
                                tls.out_len.value).decode("ascii").split("\n")


_NATIVE = _NativeTokenizer()


def standard_tokenize(text: str, max_token_length: int = 255) -> List[str]:
    toks = _WORD_RE.findall(text)
    # fast path (the overwhelmingly common case for natural text): no
    # underscores to strip, no overlong tokens to split — findall's list
    # is the answer
    if "_" not in text and (not toks
                            or max(map(len, toks)) <= max_token_length):
        return toks
    out = []
    for t in toks:
        t = t.replace("_", "")
        if not t:
            continue
        # overlong tokens are split at max_token_length, as the reference does
        while len(t) > max_token_length:
            out.append(t[:max_token_length])
            t = t[max_token_length:]
        if t:
            out.append(t)
    return out


def letter_tokenize(text: str) -> List[str]:
    return _LETTER_RE.findall(text)


def whitespace_tokenize(text: str) -> List[str]:
    return text.split()


class Analyzer:
    """Base: subclasses provide tokenize() and a filter chain."""

    name = "base"

    def tokenize(self, text: str) -> List[str]:  # pragma: no cover - abstract
        raise NotImplementedError

    def filters(self) -> Sequence[Callable[[List[Optional[str]]], List[Optional[str]]]]:
        return ()

    def analyze_slots(self, text: str) -> List[Optional[str]]:
        """Tokenize + run the filter chain, returning the raw SLOTS (term
        or None per position). The bulk indexing path consumes slots
        directly — positions are slot indices, so per-token Token objects
        never exist on the write path."""
        slots: List[Optional[str]] = self.tokenize(text)
        for f in self.filters():
            slots = f(slots)
        return slots

    def analyze(self, text: str) -> List[Token]:
        """Run the chain. Filters see/emit per-slot terms; a filter marks
        a removed token as None (position hole); a list entry stacks
        several terms at one position (synonyms/ngrams)."""
        return [Token(term, pos)
                for pos, entry in enumerate(self.analyze_slots(text))
                for term in flt.slot_terms(entry)]

    def terms(self, text: str) -> List[str]:
        return flt.flatten_slots(self.analyze_slots(text))


def _map_terms(slots, fn):
    """1:1 term mapping over the slot structure, handling the stacked
    (list) entries multi-token filters produce — every basic filter must
    compose AFTER ngram/synonym/shingle, not just before."""
    return flt._map_each(slots, fn)


def lowercase_filter(slots: List[Optional[str]]) -> List[Optional[str]]:
    return _map_terms(slots, str.lower)


def make_stop_filter(stopwords) -> Callable:
    stopset = frozenset(stopwords)

    def stop_filter(slots: List[Optional[str]]) -> List[Optional[str]]:
        return _map_terms(slots,
                          lambda s: None if s in stopset else s)

    return stop_filter


def make_length_filter(min_len: int = 0, max_len: int = 2**31) -> Callable:
    def length_filter(slots):
        return _map_terms(
            slots, lambda s: s if min_len <= len(s) <= max_len else None)

    return length_filter


def asciifolding_filter(slots: List[Optional[str]]) -> List[Optional[str]]:
    import unicodedata

    def fold(s: str) -> str:
        return "".join(
            c for c in unicodedata.normalize("NFKD", s) if not unicodedata.combining(c)
        )

    return _map_terms(slots, fold)


class StandardAnalyzer(Analyzer):
    name = "standard"

    def __init__(self, max_token_length: int = 255, stopwords=()):
        self.max_token_length = max_token_length
        self._has_stop = bool(stopwords)
        self._filters = [lowercase_filter]
        if stopwords:
            self._filters.append(make_stop_filter(stopwords))

    def tokenize(self, text: str) -> List[str]:
        return standard_tokenize(text, self.max_token_length)

    def filters(self):
        return self._filters

    def analyze_slots(self, text: str) -> List[Optional[str]]:
        # no stop filter (the default) ⇒ tokenize emits no holes and the
        # chain is exactly one lowercase pass. The native tokenizer does
        # tokenize+lower in one C scan for ASCII text; None → regex path
        if not self._has_stop:
            toks = _NATIVE.lowered_tokens(text, self.max_token_length)
            if toks is not None:
                return toks
            return list(map(str.lower,
                            standard_tokenize(text, self.max_token_length)))
        return super().analyze_slots(text)

    def terms(self, text: str) -> List[str]:
        # no stop filter: the slots are the terms (no holes, no stacks)
        if not self._has_stop:
            return self.analyze_slots(text)
        return super().terms(text)


class SimpleAnalyzer(Analyzer):
    name = "simple"

    def tokenize(self, text: str) -> List[str]:
        return letter_tokenize(text)

    def filters(self):
        return (lowercase_filter,)


class WhitespaceAnalyzer(Analyzer):
    name = "whitespace"

    def tokenize(self, text: str) -> List[str]:
        return whitespace_tokenize(text)


class KeywordAnalyzer(Analyzer):
    name = "keyword"

    def tokenize(self, text: str) -> List[str]:
        return [text] if text else []


class StopAnalyzer(SimpleAnalyzer):
    name = "stop"

    def __init__(self, stopwords=ENGLISH_STOP_WORDS):
        self._stop = make_stop_filter(stopwords)

    def filters(self):
        return (lowercase_filter, self._stop)


class CustomAnalyzer(Analyzer):
    name = "custom"

    def __init__(self, tokenizer: Callable[[str], List[str]], filters: Sequence[Callable]):
        self._tokenizer = tokenizer
        self._filters = list(filters)

    def tokenize(self, text: str) -> List[str]:
        return self._tokenizer(text)

    def filters(self):
        return self._filters


_TOKENIZERS: Dict[str, Callable[[str], List[str]]] = {
    "standard": standard_tokenize,
    "letter": letter_tokenize,
    "lowercase": letter_tokenize,  # letter + lowercase filter added below
    "whitespace": whitespace_tokenize,
    "keyword": lambda text: [text] if text else [],
}


class AnalysisRegistry:
    """Builds per-index analyzers from index settings.

    Reference: index/analysis/AnalysisRegistry#build — resolves
    ``index.analysis.analyzer.<name>`` definitions (type custom/standard/...)
    into NamedAnalyzer instances; ``IndexAnalyzers`` then serves lookups for
    mappers and query parsing."""

    BUILTIN = {
        "standard": StandardAnalyzer,
        "simple": SimpleAnalyzer,
        "whitespace": WhitespaceAnalyzer,
        "keyword": KeywordAnalyzer,
        "stop": StopAnalyzer,
    }

    def build(self, index_settings) -> Dict[str, Analyzer]:
        """index_settings: a common.settings.Settings scoped to one index."""
        analyzers: Dict[str, Analyzer] = {name: cls() for name, cls in self.BUILTIN.items()}

        def collect(prefix: str) -> Dict[str, Dict]:
            out: Dict[str, Dict] = {}
            for key in index_settings.keys():
                if key.startswith(prefix):
                    rest = key[len(prefix):]
                    name, _, prop = rest.partition(".")
                    out.setdefault(name, {})[prop] = \
                        index_settings.raw_get(key)
            return out

        # custom filter/tokenizer definitions resolve by name from
        # analyzer chains (reference: AnalysisRegistry builds filters
        # first, then analyzers reference them)
        custom_filters = {
            name: self._build_filter(name, props)
            for name, props in collect("index.analysis.filter.").items()}
        custom_tokenizers = {
            name: self._build_tokenizer(name, props)
            for name, props in collect(
                "index.analysis.tokenizer.").items()}
        for name, props in collect("index.analysis.analyzer.").items():
            analyzers[name] = self._build_one(
                name, props, custom_filters, custom_tokenizers)
        return analyzers

    def _build_filter(self, name: str, props: Dict) -> Callable:
        """One `index.analysis.filter.<name>` definition → a slot
        filter (reference: TokenFilterFactory registry)."""
        ftype = props.get("type")
        if ftype is None:
            raise IllegalArgumentException(
                f"token filter [{name}] must specify [type]")
        if ftype in ("ngram", "nGram"):
            return flt.make_ngram_filter(
                int(props.get("min_gram", 1)),
                int(props.get("max_gram", 2)),
                preserve_original=_boolish(
                    props.get("preserve_original", False)))
        if ftype in ("edge_ngram", "edgeNGram"):
            return flt.make_ngram_filter(
                int(props.get("min_gram", 1)),
                int(props.get("max_gram", 2)), edge=True,
                preserve_original=_boolish(
                    props.get("preserve_original", False)))
        if ftype == "shingle":
            return flt.make_shingle_filter(
                int(props.get("min_shingle_size", 2)),
                int(props.get("max_shingle_size", 2)),
                output_unigrams=_boolish(
                    props.get("output_unigrams", True)),
                token_separator=str(props.get("token_separator", " ")),
                filler_token=str(props.get("filler_token", "_")))
        if ftype in ("synonym", "synonym_graph"):
            rules = props.get("synonyms")
            if isinstance(rules, str):
                rules = [rules]
            if not isinstance(rules, list) or not rules:
                raise IllegalArgumentException(
                    f"synonym filter [{name}] requires [synonyms] rules "
                    f"(synonyms_path files are not supported)")
            return flt.make_synonym_filter([str(r) for r in rules])
        if ftype == "stemmer":
            return flt.make_stemmer_filter(
                str(props.get("language", props.get("name", "english"))))
        if ftype == "porter_stem":
            return flt.porter_stem_filter
        if ftype == "stop":
            stop = props.get("stopwords", "_english_")
            if stop == "_english_":
                stop = ENGLISH_STOP_WORDS
            elif isinstance(stop, str):
                stop = [stop]
            return make_stop_filter([str(s) for s in stop])
        if ftype == "length":
            return make_length_filter(int(props.get("min", 0)),
                                      int(props.get("max", 2**31)))
        if ftype == "lowercase":
            return lowercase_filter
        if ftype == "asciifolding":
            return asciifolding_filter
        raise IllegalArgumentException(
            f"unknown token filter type [{ftype}] for [{name}]")

    def _build_tokenizer(self, name: str, props: Dict) -> Callable:
        ttype = props.get("type")
        if ttype is None:
            raise IllegalArgumentException(
                f"tokenizer [{name}] must specify [type]")
        if ttype in ("ngram", "nGram"):
            return flt.make_ngram_tokenizer(
                int(props.get("min_gram", 1)),
                int(props.get("max_gram", 2)))
        if ttype in ("edge_ngram", "edgeNGram"):
            return flt.make_ngram_tokenizer(
                int(props.get("min_gram", 1)),
                int(props.get("max_gram", 2)), edge=True)
        if ttype in _TOKENIZERS:
            return _TOKENIZERS[ttype]
        raise IllegalArgumentException(
            f"unknown tokenizer type [{ttype}] for [{name}]")

    def _build_one(self, name: str, props: Dict,
                   custom_filters: Optional[Dict[str, Callable]] = None,
                   custom_tokenizers: Optional[Dict[str, Callable]] = None
                   ) -> Analyzer:
        atype = props.get("type", "custom")
        if atype in self.BUILTIN and atype != "custom":
            if atype == "standard":
                stop = props.get("stopwords") or ()
                if stop == "_english_":
                    stop = ENGLISH_STOP_WORDS
                return StandardAnalyzer(
                    max_token_length=int(props.get("max_token_length", 255)),
                    stopwords=stop,
                )
            return self.BUILTIN[atype]()
        if atype != "custom":
            raise IllegalArgumentException(f"unknown analyzer type [{atype}] for [{name}]")
        custom_filters = custom_filters or {}
        custom_tokenizers = custom_tokenizers or {}
        tok_name = props.get("tokenizer", "standard")
        tokenizer = custom_tokenizers.get(tok_name) or \
            _TOKENIZERS.get(tok_name)
        if tokenizer is None:
            raise IllegalArgumentException(f"unknown tokenizer [{tok_name}] for analyzer [{name}]")
        filters = []
        if tok_name == "lowercase":
            filters.append(lowercase_filter)
        raw_filters = props.get("filter", [])
        if isinstance(raw_filters, str):
            raw_filters = [f.strip() for f in raw_filters.split(",") if f.strip()]
        builtin_filters: Dict[str, Callable] = {
            "lowercase": lowercase_filter,
            "asciifolding": asciifolding_filter,
            "porter_stem": flt.porter_stem_filter,
            "stemmer": flt.make_stemmer_filter("english"),
            "ngram": flt.make_ngram_filter(1, 2),
            "edge_ngram": flt.make_ngram_filter(1, 2, edge=True),
            "shingle": flt.make_shingle_filter(),
        }
        for f in raw_filters:
            if f in custom_filters:
                filters.append(custom_filters[f])
            elif f == "stop":
                filters.append(make_stop_filter(ENGLISH_STOP_WORDS))
            elif f in builtin_filters:
                filters.append(builtin_filters[f])
            else:
                raise IllegalArgumentException(f"unknown token filter [{f}] for analyzer [{name}]")
        return CustomAnalyzer(tokenizer, filters)


def _boolish(v) -> bool:
    if isinstance(v, str):
        return v.lower() not in ("false", "0", "no", "")
    return bool(v)
