"""Analyzers of the ``text`` and ``keyword`` field types.

Copy of the reference's ``analysis/analyzers.py`` for the ``standard``
analyzer (a Unicode word-character regex that keeps ASCII apostrophes and
periods inside tokens, underscores stripped, overlong tokens split at
max_token_length, lowercase, no stop words) and the ``keyword`` analyzer.
The ASCII fast path of tokenize + lowercase runs in C
(``csrc/fast_tokenize.c``, through ``native``); non-ASCII text, an
overlong token or a missing compiler take the regex path, which gives the
same tokens.
"""

from __future__ import annotations

import ctypes
import re
import threading
from typing import List

from elasticsearch_tpu_torch import native

# Unicode "word" runs; \w covers letters/digits/underscore across scripts.
_WORD_RE = re.compile(r"\w+(?:[.']\w+)*", re.UNICODE)


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
    if "_" not in text and (not toks
                            or max(map(len, toks)) <= max_token_length):
        return toks
    out = []
    for t in toks:
        t = t.replace("_", "")
        if not t:
            continue
        while len(t) > max_token_length:
            out.append(t[:max_token_length])
            t = t[max_token_length:]
        if t:
            out.append(t)
    return out


class StandardAnalyzer:
    """UAX#29-style word break + lowercase, no stop words."""

    name = "standard"
    _has_stop = False  # no stop filter: the mapper's flat fast path applies

    def __init__(self, max_token_length: int = 255):
        self.max_token_length = max_token_length

    def analyze_slots(self, text: str) -> List[str]:
        """The terms of `text`, one per position (the chain removes
        nothing, so there are no position holes)."""
        toks = _NATIVE.lowered_tokens(text, self.max_token_length)
        if toks is not None:
            return toks
        return list(map(str.lower,
                        standard_tokenize(text, self.max_token_length)))

    terms = analyze_slots


class KeywordAnalyzer:
    """The whole input as a single token."""

    name = "keyword"

    def analyze_slots(self, text: str) -> List[str]:
        return [text] if text else []

    terms = analyze_slots


#: analyzers a mapping can name (the reference's built-in registry holds
#: more; a mapping naming another is refused by the mapper)
ANALYZERS = {"standard": StandardAnalyzer(), "keyword": KeywordAnalyzer()}
