"""Highlighting: the plain highlighter.

Copy of the reference's ``search/highlight.py`` (PlainHighlighter,
HighlightBuilder): the request grammar ({"fields": {name: {...}}},
pre_tags/post_tags, fragment_size, number_of_fragments,
require_field_match), per hit {"highlight": {field: [fragments]}},
fields without a match omitted, number_of_fragments 0 highlighting the
whole value. Host code over the fetched ``_source``: word tokens are
matched case-insensitively against the query's term predicates (exact
terms, prefix, wildcard, fuzzy), each match wrapped in the tags, and
fragments are windows over the raw text.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.search import dsl

DEFAULT_FRAGMENT_SIZE = 100
DEFAULT_NUM_FRAGMENTS = 5
_TOKEN = re.compile(r"\w+", re.UNICODE)

Matcher = Callable[[str], bool]


class HighlightSpec:
    def __init__(self, body: Dict[str, Any]):
        if not isinstance(body, dict) or not isinstance(
                body.get("fields"), dict):
            raise IllegalArgumentException(
                "[highlight] requires a [fields] object")
        self.pre = (body.get("pre_tags") or ["<em>"])[0]
        self.post = (body.get("post_tags") or ["</em>"])[0]
        self.require_field_match = bool(
            body.get("require_field_match", True))
        self.fields: Dict[str, Dict[str, Any]] = {}
        for name, opts in body["fields"].items():
            opts = opts or {}
            self.fields[name] = {
                "fragment_size": int(opts.get(
                    "fragment_size",
                    body.get("fragment_size", DEFAULT_FRAGMENT_SIZE))),
                "number_of_fragments": int(opts.get(
                    "number_of_fragments",
                    body.get("number_of_fragments",
                             DEFAULT_NUM_FRAGMENTS))),
                "pre": (opts.get("pre_tags") or [self.pre])[0],
                "post": (opts.get("post_tags") or [self.post])[0],
            }


# ----------------------------------------------------------------------
# query term extraction → token matchers per field
# ----------------------------------------------------------------------

def _split_terms(text: str) -> List[str]:
    return [t.lower() for t in _TOKEN.findall(str(text))]


def collect_matchers(query: dsl.QueryNode, field: str,
                     require_field_match: bool) -> List[Matcher]:
    """Token predicates this query implies for `field` (reference:
    the highlighter extracts terms from the rewritten query)."""
    out: List[Matcher] = []

    def field_ok(f: str) -> bool:
        return (not require_field_match) or f == field

    def exact(terms: List[str]) -> Matcher:
        tset = set(terms)
        return lambda tok: tok in tset

    def walk(node: dsl.QueryNode) -> None:
        if isinstance(node, dsl.MatchQuery) and field_ok(node.field):
            out.append(exact(_split_terms(node.query)))
        elif isinstance(node, dsl.MatchPhraseQuery) \
                and field_ok(node.field):
            out.append(exact(_split_terms(node.query)))
        elif isinstance(node, dsl.TermQuery) and field_ok(node.field):
            out.append(exact(_split_terms(node.value)))
        elif isinstance(node, dsl.TermsQuery) and field_ok(node.field):
            terms: List[str] = []
            for v in node.values:
                terms.extend(_split_terms(v))
            out.append(exact(terms))
        elif isinstance(node, dsl.MultiMatchQuery):
            if any(field_ok(f) for f, _ in node.fields):
                out.append(exact(_split_terms(node.query)))
        elif isinstance(node, dsl.PrefixQuery) and field_ok(node.field):
            prefix = node.value.lower()
            out.append(lambda tok: tok.startswith(prefix))
        elif isinstance(node, dsl.WildcardQuery) \
                and field_ok(node.field):
            import fnmatch
            pattern = node.value.lower().replace("[", "[[]")
            out.append(lambda tok: fnmatch.fnmatchcase(tok, pattern))
        elif isinstance(node, dsl.FuzzyQuery) and field_ok(node.field):
            from elasticsearch_tpu_torch.search.planner import \
                _edit_distance_lte
            value = node.value.lower()
            n = len(value)
            max_d = (0 if n < 3 else (1 if n < 6 else 2)) \
                if not isinstance(node.fuzziness, int) \
                else node.fuzziness
            out.append(
                lambda tok: _edit_distance_lte(value, tok, max_d))
        elif isinstance(node, dsl.BoolQuery):
            # must_not never highlights (excluded docs' terms)
            for child in node.must + node.should + node.filter:
                walk(child)
        elif isinstance(node, dsl.ConstantScoreQuery):
            walk(node.filter_query)
        elif isinstance(node, dsl.FunctionScoreQuery):
            walk(node.query)
        elif isinstance(node, dsl.ScriptScoreQuery):
            walk(node.query)

    walk(query)
    return out


# ----------------------------------------------------------------------
# fragment building
# ----------------------------------------------------------------------

def _match_spans(text: str, matchers: List[Matcher]
                 ) -> List[Tuple[int, int]]:
    spans = []
    for m in _TOKEN.finditer(text):
        tok = m.group(0).lower()
        if any(fn(tok) for fn in matchers):
            spans.append((m.start(), m.end()))
    return spans


def _wrap(text: str, spans: List[Tuple[int, int]], pre: str,
          post: str) -> str:
    out = []
    last = 0
    for s, e in spans:
        out.append(text[last:s])
        out.append(pre)
        out.append(text[s:e])
        out.append(post)
        last = e
    out.append(text[last:])
    return "".join(out)


def highlight_value(text: str, matchers: List[Matcher], *,
                    fragment_size: int, number_of_fragments: int,
                    pre: str, post: str) -> Optional[List[str]]:
    """→ highlighted fragments, or None when nothing matched."""
    spans = _match_spans(text, matchers)
    if not spans:
        return None
    if number_of_fragments == 0:
        # the whole field value as one fragment (reference semantics)
        return [_wrap(text, spans, pre, post)]
    # greedy windows: walk the matches in order, open a window at the
    # first uncovered match, extend to fragment_size on word boundaries
    fragments: List[Tuple[int, List[Tuple[int, int]], int, int]] = []
    i = 0
    while i < len(spans) and len(fragments) < number_of_fragments:
        start = max(0, spans[i][0] - fragment_size // 4)
        # snap to a word boundary leftward
        while start > 0 and text[start - 1].isalnum():
            start -= 1
        end = min(len(text), start + fragment_size)
        while end < len(text) and text[end - 1].isalnum() \
                and text[end:end + 1].isalnum():
            end += 1
        inside = []
        while i < len(spans) and spans[i][1] <= end:
            inside.append(spans[i])
            i += 1
        if not inside:  # the match itself is longer than the window
            inside = [spans[i]]
            end = spans[i][1]
            i += 1
        fragments.append((len(inside), inside, start, end))
    return [
        _wrap(text[start:end],
              [(s - start, e - start) for s, e in inside], pre, post)
        for _count, inside, start, end in fragments]


def build_highlights(query: dsl.QueryNode, source: Optional[dict],
                     spec: HighlightSpec,
                     available_fields: Optional[List[str]] = None
                     ) -> Dict[str, List[str]]:
    """Per-hit highlight map; fields without matches are omitted."""
    import fnmatch
    out: Dict[str, List[str]] = {}
    if not isinstance(source, dict):
        return out
    for pattern, opts in spec.fields.items():
        if "*" in pattern or "?" in pattern:
            names = [f for f in source
                     if fnmatch.fnmatchcase(f, pattern)]
        else:
            names = [pattern]
        for name in names:
            value = source.get(name)
            if not isinstance(value, str):
                continue
            matchers = collect_matchers(query, name,
                                        spec.require_field_match)
            if not matchers:
                continue
            frags = highlight_value(
                value, matchers,
                fragment_size=opts["fragment_size"],
                number_of_fragments=opts["number_of_fragments"],
                pre=opts["pre"], post=opts["post"])
            if frags:
                out[name] = frags
    return out
