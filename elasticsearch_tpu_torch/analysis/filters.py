"""Token filters beyond the basics: porter stemming, ngram/edge_ngram,
shingle, synonyms, the stemmer dispatch and the ngram tokenizers.

Copy of the reference's ``analysis/filters.py``. A filter chain works on
SLOTS, one entry per position: ``None`` (a hole, a removed token), a
``str``, or a ``List[str]`` (several terms stacked at the same position:
synonyms, ngrams, shingle start positions). Phrase positions and field
lengths derive from the flattened view (``mapping/mapper.slots_to_positions``).

The Porter stemmer is the classic 1980 algorithm (the contract of
Lucene's PorterStemFilter, the ``porter_stem`` and default-english
``stemmer`` filters).
"""

from __future__ import annotations

import functools
import re
from typing import Callable, Dict, List, Optional, Sequence, Union

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException

Slot = Union[None, str, List[str]]


def slot_terms(entry: Slot) -> List[str]:
    """One slot entry → its terms (empty for holes)."""
    if entry is None:
        return []
    if isinstance(entry, list):
        return [t for t in entry if t]
    return [entry]


def flatten_slots(slots: Sequence[Slot]) -> List[str]:
    out: List[str] = []
    for entry in slots:
        out.extend(slot_terms(entry))
    return out


def _map_each(slots: Sequence[Slot], fn: Callable[[str], Optional[str]]
              ) -> List[Slot]:
    """Apply a 1:1 term function across the slot structure."""
    if list not in map(type, slots):
        # no stacks: one call a slot, holes kept
        return [None if entry is None else fn(entry) for entry in slots]
    out: List[Slot] = []
    for entry in slots:
        if entry is None:
            out.append(None)
        elif isinstance(entry, list):
            mapped = [m for m in (fn(t) for t in entry) if m]
            out.append(mapped or None)
        else:
            out.append(fn(entry))
    return out


# ----------------------------------------------------------------------
# Porter stemmer (Porter 1980; Lucene PorterStemFilter contract)
# ----------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """m = number of VC sequences in the [C](VC)^m[V] form."""
    m = 0
    i = 0
    n = len(stem)
    while i < n and _is_cons(stem, i):
        i += 1
    while i < n:
        while i < n and not _is_cons(stem, i):
            i += 1
        if i >= n:
            break
        m += 1
        while i < n and _is_cons(stem, i):
            i += 1
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_cons(word, len(word) - 1))


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    if not (_is_cons(word, len(word) - 3)
            and not _is_cons(word, len(word) - 2)
            and _is_cons(word, len(word) - 1)):
        return False
    return word[-1] not in "wxy"


_STEP2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
          ("anci", "ance"), ("izer", "ize"), ("bli", "ble"),
          ("alli", "al"), ("entli", "ent"), ("eli", "e"),
          ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
          ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
          ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
          ("iviti", "ive"), ("biliti", "ble"), ("logi", "log")]

_STEP3 = [("icate", "ic"), ("ative", ""), ("alize", "al"),
          ("iciti", "ic"), ("ical", "ic"), ("ful", ""), ("ness", "")]

_STEP4 = ["al", "ance", "ence", "er", "ic", "able", "ible", "ant",
          "ement", "ment", "ent", "ion", "ou", "ism", "ate", "iti",
          "ous", "ive", "ize"]


@functools.lru_cache(maxsize=1 << 17)
def porter_stem(word: str) -> str:
    """The stem of `word`, memoized: a pure function of the word, and an
    index's vocabulary repeats its words many times over."""
    if len(word) <= 2:
        return word
    w = word

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w = w[:-2]
            flag = True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w = w[:-3]
            flag = True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
                w = w[:-1]
            elif _measure(w) == 1 and _cvc(w):
                w += "e"

    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2
    for suf, rep in _STEP2:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 0:
                w = stem + rep
            break

    # step 3
    for suf, rep in _STEP3:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 0:
                w = stem + rep
            break

    # step 4
    for suf in _STEP4:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if suf == "ion" and not stem.endswith(("s", "t")):
                continue
            if _measure(stem) > 1:
                w = stem
            break

    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem

    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


def porter_stem_filter(slots: Sequence[Slot]) -> List[Slot]:
    return _map_each(slots, porter_stem)


# ----------------------------------------------------------------------
# ngram / edge_ngram
# ----------------------------------------------------------------------

def make_ngram_filter(min_gram: int = 1, max_gram: int = 2,
                      *, edge: bool = False,
                      preserve_original: bool = False) -> Callable:
    """All [min_gram..max_gram] grams of each token, STACKED at the
    token's position (reference: NGramTokenFilter / EdgeNGramTokenFilter;
    tokens shorter than min_gram are dropped unless preserve_original)."""
    if min_gram < 1 or max_gram < min_gram:
        raise IllegalArgumentException(
            f"[ngram] requires 1 <= min_gram <= max_gram, got "
            f"[{min_gram}, {max_gram}]")

    def grams_of(t: str) -> List[str]:
        out = []
        if edge:
            for n in range(min_gram, min(max_gram, len(t)) + 1):
                out.append(t[:n])
        else:
            for n in range(min_gram, max_gram + 1):
                for i in range(0, len(t) - n + 1):
                    out.append(t[i:i + n])
        if preserve_original and (len(t) < min_gram or len(t) > max_gram):
            out.append(t)
        return out

    def ngram_filter(slots: Sequence[Slot]) -> List[Slot]:
        out: List[Slot] = []
        for entry in slots:
            terms = slot_terms(entry)
            if not terms:
                out.append(None)
                continue
            grams: List[str] = []
            for t in terms:
                grams.extend(grams_of(t))
            out.append(grams or None)
        return out

    return ngram_filter


# ----------------------------------------------------------------------
# shingle
# ----------------------------------------------------------------------

def make_shingle_filter(min_shingle_size: int = 2,
                        max_shingle_size: int = 2,
                        output_unigrams: bool = True,
                        token_separator: str = " ",
                        filler_token: str = "_") -> Callable:
    """Word n-grams over consecutive positions, emitted at the shingle's
    START position (reference: ShingleTokenFilter). Holes (removed stop
    words) contribute the filler token, as Lucene does."""
    if min_shingle_size < 2 or max_shingle_size < min_shingle_size:
        raise IllegalArgumentException(
            f"[shingle] requires 2 <= min_shingle_size <= "
            f"max_shingle_size, got [{min_shingle_size}, "
            f"{max_shingle_size}]")

    def shingle_filter(slots: Sequence[Slot]) -> List[Slot]:
        # first term per position for shingle BUILDING (stacked synonyms
        # beyond the first don't multiply shingles — Lucene's shingle
        # over a graph behaves similarly without graph flattening);
        # unigram output preserves the FULL stack, so stacked synonyms
        # stay searchable
        words: List[Optional[str]] = []
        for entry in slots:
            terms = slot_terms(entry)
            words.append(terms[0] if terms else None)
        out: List[Slot] = []
        n = len(words)
        for i in range(n):
            acc: List[str] = []
            if words[i] is not None and output_unigrams:
                acc.extend(slot_terms(slots[i]))
            if words[i] is not None:
                for size in range(min_shingle_size, max_shingle_size + 1):
                    if i + size > n:
                        break
                    parts = [words[i + j] if words[i + j] is not None
                             else filler_token for j in range(size)]
                    # a shingle must START at a real token and contain
                    # at least one real second token
                    if all(p == filler_token for p in parts[1:]):
                        continue
                    acc.append(token_separator.join(parts))
            out.append(acc or None)
        return out

    return shingle_filter


# ----------------------------------------------------------------------
# synonyms
# ----------------------------------------------------------------------

def parse_synonym_rules(rules: Sequence[str]):
    """Solr-format rules (reference: SynonymTokenFilterFactory):
      "a, b, c"        — equivalence class: each maps to all of a|b|c
      "a, b => c, d"   — explicit: a or b map to c and d
    Multi-word terms (spaces inside a term) need graph token streams —
    out of scope for the slot model; rejected with a clear 400."""
    mapping: Dict[str, List[str]] = {}

    def check_single(term: str) -> str:
        t = term.strip().lower()
        if not t:
            raise IllegalArgumentException("[synonym] empty term in rule")
        if " " in t:
            raise IllegalArgumentException(
                f"[synonym] multi-word synonym [{t}] is not supported "
                f"(single-token rules only in this build)")
        return t

    for rule in rules:
        if "=>" in rule:
            lhs, _, rhs = rule.partition("=>")
            inputs = [check_single(t) for t in lhs.split(",")]
            outputs = [check_single(t) for t in rhs.split(",")]
            for i in inputs:
                mapping.setdefault(i, [])
                for o in outputs:
                    if o not in mapping[i]:
                        mapping[i].append(o)
        else:
            cls = [check_single(t) for t in rule.split(",")]
            for i in cls:
                mapping.setdefault(i, [])
                for o in cls:
                    if o not in mapping[i]:
                        mapping[i].append(o)
    return mapping


def make_synonym_filter(rules: Sequence[str]) -> Callable:
    mapping = parse_synonym_rules(rules)

    def synonym_filter(slots: Sequence[Slot]) -> List[Slot]:
        out: List[Slot] = []
        for entry in slots:
            terms = slot_terms(entry)
            if not terms:
                out.append(None)
                continue
            expanded: List[str] = []
            for t in terms:
                subs = mapping.get(t)
                if subs is None:
                    expanded.append(t)
                else:
                    for s in subs:
                        if s not in expanded:
                            expanded.append(s)
            out.append(expanded if len(expanded) > 1 else expanded[0])
        return out

    return synonym_filter


# ----------------------------------------------------------------------
# stemmer dispatch ("stemmer" filter with a language param)
# ----------------------------------------------------------------------

_STEMMERS: Dict[str, Callable[[str], str]] = {
    "english": porter_stem,
    "porter": porter_stem,
    "porter2": porter_stem,   # close enough for the default chain; the
    # true porter2 differences (e.g. "generically") are out of scope
    "light_english": porter_stem,
}


def make_stemmer_filter(language: str = "english") -> Callable:
    fn = _STEMMERS.get(language)
    if fn is None:
        raise IllegalArgumentException(
            f"unknown stemmer language [{language}]; available: "
            f"{sorted(_STEMMERS)}")

    def stemmer_filter(slots: Sequence[Slot]) -> List[Slot]:
        return _map_each(slots, fn)

    return stemmer_filter


# ----------------------------------------------------------------------
# ngram / edge_ngram TOKENIZERS (character-level, over word runs)
# ----------------------------------------------------------------------

_TOKEN_CHARS_RE = re.compile(r"[^\W_]+", re.UNICODE)


def make_ngram_tokenizer(min_gram: int = 1, max_gram: int = 2,
                         *, edge: bool = False) -> Callable:
    """Reference: NGramTokenizer/EdgeNGramTokenizer. Splits on
    non-letter/digit (the common `token_chars: [letter, digit]`
    configuration), then emits character grams; each gram is its own
    position (tokenizer semantics, unlike the stacked filter)."""
    if min_gram < 1 or max_gram < min_gram:
        raise IllegalArgumentException(
            f"[ngram] requires 1 <= min_gram <= max_gram, got "
            f"[{min_gram}, {max_gram}]")

    def tokenize(text: str) -> List[str]:
        out: List[str] = []
        for run in _TOKEN_CHARS_RE.findall(text):
            if edge:
                for n in range(min_gram, min(max_gram, len(run)) + 1):
                    out.append(run[:n])
            else:
                for n in range(min_gram, max_gram + 1):
                    for i in range(0, len(run) - n + 1):
                        out.append(run[i:i + n])
        return out

    return tokenize
