"""Suggesters: term, phrase and completion.

Copy of the reference's ``search/suggest.py`` (TermSuggester with
DirectSpellChecker, PhraseSuggester, CompletionSuggester): the request
grammar ({"suggest": {name: {"text", "term" | "phrase" |
"completion": {"field", ...}}}}), per-token entries with offset and
length, candidates scored by edit distance then doc frequency,
`suggest_mode` (missing | popular | always), `max_edits`,
`prefix_length`, `min_word_length` and `size`; the phrase suggester's
beam over per-token candidates; the completion suggester's prefix
lookup over the field's sorted ordinal terms, ranked by weight; and
`merge_suggest`, the reduce of partial answers.

Candidates come from the target shards' term dictionaries (the packs'
vocabularies and doc frequencies) on the host, one banded
Damerau-Levenshtein pass per (token, shard); no per-doc work.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException

_TOKEN = re.compile(r"\w+", re.UNICODE)


def _bounded_distance(a: str, b: str, k: int):
    """Damerau-Levenshtein distance if ≤ k, else None — ONE banded DP
    pass (the candidate loop's hot function)."""
    if a == b:
        return 0
    if abs(len(a) - len(b)) > k:
        return None
    prev2 = None
    prev = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        cur = [i] + [0] * len(b)
        row_min = i
        for j in range(1, len(b) + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            d = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            if (prev2 is not None and i > 1 and j > 1
                    and a[i - 1] == b[j - 2] and a[i - 2] == b[j - 1]):
                d = min(d, prev2[j - 2] + 1)
            cur[j] = d
            row_min = min(row_min, d)
        if row_min > k:
            return None
        prev2, prev = prev, cur
    return prev[len(b)] if prev[len(b)] <= k else None


class TermSuggestSpec:
    kind = "term"

    def __init__(self, name: str, body: Dict[str, Any]):
        self.name = name
        self.text = body.get("text")
        term = body.get("term")
        if self.text is None or not isinstance(term, dict):
            raise IllegalArgumentException(
                f"suggester [{name}] requires [text] and [term]")
        self.field = term.get("field")
        if not self.field:
            raise IllegalArgumentException(
                f"suggester [{name}] requires [term.field]")
        self.size = int(term.get("size", 5))
        self.max_edits = int(term.get("max_edits", 2))
        if self.max_edits not in (1, 2):
            raise IllegalArgumentException(
                "[term] max_edits must be 1 or 2")
        self.prefix_length = int(term.get("prefix_length", 1))
        self.min_word_length = int(term.get("min_word_length", 4))
        self.suggest_mode = str(term.get("suggest_mode", "missing"))
        if self.suggest_mode not in ("missing", "popular", "always"):
            raise IllegalArgumentException(
                f"[term] unknown suggest_mode [{self.suggest_mode}]")


class PhraseSuggestSpec:
    """Reference: PhraseSuggester — whole-phrase corrections built from
    per-token candidates, scored by candidate confidence × doc
    frequency; `max_errors` bounds how many tokens may change;
    `highlight` wraps changed tokens."""

    kind = "phrase"

    def __init__(self, name: str, body: Dict[str, Any]):
        self.name = name
        self.text = body.get("text")
        spec = body.get("phrase")
        if self.text is None or not isinstance(spec, dict):
            raise IllegalArgumentException(
                f"suggester [{name}] requires [text] and [phrase]")
        self.field = spec.get("field")
        if not self.field:
            raise IllegalArgumentException(
                f"phrase suggester [{name}] requires [field]")
        self.size = int(spec.get("size", 5))
        self.max_errors = float(spec.get("max_errors", 1.0))
        self.max_edits = 2
        hl = spec.get("highlight") or {}
        self.pre_tag = hl.get("pre_tag", "")
        self.post_tag = hl.get("post_tag", "")


class CompletionSuggestSpec:
    """Reference: CompletionSuggester over a `completion` field —
    prefix lookup of stored inputs, weight-ranked."""

    kind = "completion"

    def __init__(self, name: str, body: Dict[str, Any]):
        self.name = name
        self.prefix = body.get("prefix", body.get("text"))
        spec = body.get("completion")
        if self.prefix is None or not isinstance(spec, dict):
            raise IllegalArgumentException(
                f"suggester [{name}] requires [prefix] and [completion]")
        self.field = spec.get("field")
        if not self.field:
            raise IllegalArgumentException(
                f"completion suggester [{name}] requires [field]")
        self.size = int(spec.get("size", 5))
        self.skip_duplicates = bool(spec.get("skip_duplicates", False))


def parse_suggest(body: Dict[str, Any]) -> List[Any]:
    if not isinstance(body, dict):
        raise IllegalArgumentException("[suggest] must be an object")
    specs: List[Any] = []
    global_text = body.get("text")
    for name, spec in body.items():
        if name == "text":
            continue
        if not isinstance(spec, dict):
            raise IllegalArgumentException(
                f"suggester [{name}] must be an object")
        if "text" not in spec and "prefix" not in spec \
                and global_text is not None:
            spec = dict(spec, text=global_text)
        if "term" in spec:
            specs.append(TermSuggestSpec(name, spec))
        elif "phrase" in spec:
            specs.append(PhraseSuggestSpec(name, spec))
        elif "completion" in spec:
            specs.append(CompletionSuggestSpec(name, spec))
        else:
            raise IllegalArgumentException(
                f"suggester [{name}]: one of [term], [phrase], "
                f"[completion] is required")
    return specs


def _field_frequencies(indices, names: List[str], field: str,
                       shard_filter=None) -> Dict[str, int]:
    """term → doc frequency across the TARGET shards' term dicts.
    shard_filter: {index: iterable of shard nums} — required in cluster
    groups so unassigned local copies aren't double-counted in the
    cross-node merge."""
    freqs: Dict[str, int] = {}
    for name in names:
        svc = indices.index(name)
        wanted = (None if shard_filter is None
                  else set(shard_filter.get(name, ())))
        for num, shard in sorted(svc.shards.items()):
            if wanted is not None and num not in wanted:
                continue
            reader = shard.acquire_searcher()
            for view in reader.views:
                fp = view.pack.fields.get(field)
                if fp is None:
                    continue
                for term, row in fp.vocab.items():
                    freqs[term] = freqs.get(term, 0) + int(
                        fp.doc_freq[row])
    return freqs


def run_suggest(indices, names: List[str],
                body: Dict[str, Any],
                shard_filter=None) -> Dict[str, Any]:
    specs = parse_suggest(body)
    out: Dict[str, Any] = {}
    freq_cache: Dict[str, Dict[str, int]] = {}

    def freqs_for(field: str) -> Dict[str, int]:
        f = freq_cache.get(field)
        if f is None:
            f = _field_frequencies(indices, names, field, shard_filter)
            freq_cache[field] = f
        return f

    for spec in specs:
        if spec.kind == "completion":
            out[spec.name] = _run_completion(indices, names, spec,
                                             shard_filter)
            continue
        if spec.kind == "phrase":
            out[spec.name] = _run_phrase(freqs_for(spec.field), spec)
            continue
        freqs = freqs_for(spec.field)
        entries = []
        for m in _TOKEN.finditer(str(spec.text)):
            token = m.group(0).lower()
            entry = {"text": token, "offset": m.start(),
                     "length": m.end() - m.start(), "options": []}
            exists = freqs.get(token, 0) > 0
            skip = (
                len(token) < spec.min_word_length
                or (spec.suggest_mode == "missing" and exists))
            if not skip:
                options = _candidates(token, freqs, spec)
                entry["options"] = options
            entries.append(entry)
        out[spec.name] = entries
    return out


def _run_phrase(freqs: Dict[str, int],
                spec: PhraseSuggestSpec) -> List[Dict[str, Any]]:
    """Beam over per-token candidates (the token itself + close terms),
    scored by Π token confidence·log-df; at most `max_errors` tokens
    change (fraction when < 1, absolute otherwise — reference rule)."""
    import math
    text = str(spec.text)
    matches = list(_TOKEN.finditer(text))
    tokens = [m.group(0).lower() for m in matches]
    if not tokens:
        return [{"text": text, "offset": 0, "length": len(text),
                 "options": []}]
    max_changes = (max(1, int(round(spec.max_errors * len(tokens))))
                   if spec.max_errors < 1.0 else int(spec.max_errors))

    shim = TermSuggestSpec("_", {"text": "", "term": {"field": spec.field,
                                                      "size": 3}})
    per_token: List[List[Tuple[str, float, bool]]] = []
    for tok in tokens:
        df = freqs.get(tok, 0)
        own_conf = 1.0 if df > 0 else 0.05
        opts = [(tok, own_conf * math.log1p(df + 1), False)]
        for cand in _candidates(tok, freqs, shim):
            opts.append((cand["text"],
                         cand["score"] * math.log1p(cand["freq"] + 1),
                         True))
        per_token.append(opts)

    beams: List[Tuple[List[str], int, float]] = [([], 0, 0.0)]
    for opts in per_token:
        nxt = []
        for terms, changes, score in beams:
            for term, s, changed in opts:
                c = changes + (1 if changed else 0)
                if c > max_changes:
                    continue
                nxt.append((terms + [term], c, score + s))
        nxt.sort(key=lambda b: -b[2])
        beams = nxt[:20]

    options = []
    seen = set()
    for terms, changes, score in beams:
        if changes == 0:
            continue  # the input itself is not a suggestion
        phrase = " ".join(terms)
        if phrase in seen:
            continue
        seen.add(phrase)
        opt = {"text": phrase,
               "score": round(score / max(1, len(terms)), 6)}
        if spec.pre_tag or spec.post_tag:
            opt["highlighted"] = " ".join(
                f"{spec.pre_tag}{t}{spec.post_tag}" if t != tokens[i]
                else t for i, t in enumerate(terms))
        options.append(opt)
    options.sort(key=lambda o: (-o["score"], o["text"]))
    return [{"text": text, "offset": 0, "length": len(text),
             "options": options[: spec.size]}]


def _run_completion(indices, names: List[str],
                    spec: CompletionSuggestSpec,
                    shard_filter=None) -> List[Dict[str, Any]]:
    """Prefix lookup over the completion field's ordinal tables (sorted
    unique inputs per segment → binary search), weight-ranked."""
    import bisect

    import numpy as np

    from elasticsearch_tpu_torch.mapping.types import CompletionFieldType
    prefix = str(spec.prefix)
    best: Dict[str, float] = {}
    for name in names:
        svc = indices.index(name)
        wanted = (None if shard_filter is None
                  else set(shard_filter.get(name, ())))
        for num, shard in sorted(svc.shards.items()):
            if wanted is not None and num not in wanted:
                continue
            reader = shard.acquire_searcher()
            for view in reader.views:
                pack = view.pack
                dv = view.segment.doc_values.get(spec.field)
                terms = (list(dv.ord_terms or [])
                         if dv is not None and spec.field in pack.dv_ord
                         else None)
                col = pack.dv_ord.get(spec.field)
                if not terms or col is None:
                    continue
                # ordinal range of prefix matches: scan from the left
                # bound while startswith (no string sentinel — a non-BMP
                # next char would sort past any BMP sentinel)
                lo = bisect.bisect_left(terms, prefix)
                hi = lo
                while hi < len(terms) and terms[hi].startswith(prefix):
                    hi += 1
                if lo >= hi:
                    continue
                wcol = pack.dv_i64.get(
                    spec.field + CompletionFieldType.WEIGHT_SUFFIX)
                live = view.live_mask
                seg_col = np.asarray(col)
                n = len(seg_col)
                warr = None if wcol is None else np.asarray(wcol)

                def record(ord_idx: int, doc: int) -> None:
                    w = 1.0 if warr is None else float(warr[doc])
                    t = terms[ord_idx]
                    if t not in best or w > best[t]:
                        best[t] = w

                # one pass over the column for all matching ordinals
                in_range = ((seg_col >= lo) & (seg_col < hi)
                            & live[:n])
                for doc in np.nonzero(in_range)[0].tolist():
                    record(int(seg_col[doc]), doc)
                # multi-input docs keep extras in the segment column
                if dv is not None and dv.extra:
                    for d, extra in dv.extra.items():
                        if d < len(live) and live[d]:
                            for eo in extra:
                                if lo <= eo < hi:
                                    record(int(eo), d)
    options = [{"text": t, "score": s} for t, s in best.items()]
    options.sort(key=lambda o: (-o["score"], o["text"]))
    return [{"text": prefix, "offset": 0, "length": len(prefix),
             "options": options[: spec.size]}]


def merge_suggest(specs: List[TermSuggestSpec],
                  partials: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Cross-node reduce: per token, merge candidate options by text
    (summing doc freqs, keeping the best score), re-sort, cut to size
    (reference: the suggest phase's reduce)."""
    out: Dict[str, Any] = {}
    by_name = {s.name: s for s in specs}
    for name in by_name:
        merged_entries: Dict[Tuple[str, int], Dict[str, Any]] = {}
        order: List[Tuple[str, int]] = []
        for part in partials:
            for entry in part.get(name, []):
                key = (entry["text"], entry["offset"])
                cur = merged_entries.get(key)
                if cur is None:
                    cur = {"text": entry["text"],
                           "offset": entry["offset"],
                           "length": entry["length"], "options": {}}
                    merged_entries[key] = cur
                    order.append(key)
                for opt in entry["options"]:
                    existing = cur["options"].get(opt["text"])
                    if existing is None:
                        cur["options"][opt["text"]] = dict(opt)
                    else:
                        if "freq" in opt:
                            existing["freq"] = existing.get("freq", 0) \
                                + opt["freq"]
                        existing["score"] = max(existing["score"],
                                                opt["score"])
        size = by_name[name].size
        out[name] = []
        for key in order:
            entry = merged_entries[key]
            options = sorted(entry["options"].values(),
                             key=lambda o: (-o["score"],
                                            -o.get("freq", 0),
                                            o["text"]))[: size]
            out[name].append({"text": entry["text"],
                              "offset": entry["offset"],
                              "length": entry["length"],
                              "options": options})
    return out


def _candidates(token: str, freqs: Dict[str, int],
                spec: TermSuggestSpec) -> List[Dict[str, Any]]:
    prefix = token[: spec.prefix_length]
    token_freq = freqs.get(token, 0)
    scored: List[Tuple[float, int, str]] = []
    for term, df in freqs.items():
        if term == token or df <= 0:
            continue
        if spec.prefix_length and not term.startswith(prefix):
            continue
        if abs(len(term) - len(token)) > spec.max_edits:
            continue
        if spec.suggest_mode == "popular" and df <= token_freq:
            continue
        dist = _bounded_distance(token, term, spec.max_edits)
        if dist is not None:
            # reference scoring shape: closer edits first, then
            # higher doc frequency
            scored.append((1.0 - dist / max(len(token), 1), df, term))
    scored.sort(key=lambda t: (-t[0], -t[1], t[2]))
    return [{"text": term, "score": round(score, 6), "freq": df}
            for score, df, term in scored[: spec.size]]
