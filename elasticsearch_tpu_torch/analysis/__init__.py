"""The standard analyzer of a ``text`` field (Python path).

Copy of the reference's ``analysis/analyzers.py`` standard tokenizer +
lowercase filter: a Unicode word-character regex that keeps ASCII
apostrophes/periods inside tokens, underscores stripped, overlong tokens
split at max_token_length, no stop words. The reference's native ASCII
tokenizer (native/fast_tokenize.c) computes the same tokens and waits for
a later slice.
"""

from __future__ import annotations

import re
from typing import List

_WORD_RE = re.compile(r"\w+(?:[.']\w+)*", re.UNICODE)


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

    def __init__(self, max_token_length: int = 255):
        self.max_token_length = max_token_length

    def terms(self, text: str) -> List[str]:
        """The token terms of `text`, in order (one per position: the
        chain removes nothing, so there are no position holes)."""
        return list(map(str.lower,
                        standard_tokenize(text, self.max_token_length)))
