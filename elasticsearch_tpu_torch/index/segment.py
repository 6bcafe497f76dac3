"""Host-side immutable segments: text postings, norms, stored ``_source``.

Counterpart of the reference's ``index/segment.py`` for what the search
slice reads: ``SegmentWriter`` buffers parsed documents and ``freeze()``
emits a ``Segment`` whose per-field postings are (doc ids i32[], tfs
i32[]) sorted by doc, with SmallFloat-encoded norms and the exact field
statistics BM25 needs. ``_build_postings`` is the reference's sort-based
builder, verbatim.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.mapping import ParsedDocument
from elasticsearch_tpu_torch.ops.smallfloat import encode_norms


@dataclasses.dataclass
class FieldStats:
    doc_count: int = 0            # docs with this field
    sum_total_term_freq: int = 0  # total tokens (Σ field length)


class Segment:
    """Immutable after construction."""

    def __init__(self, name: str, num_docs: int, doc_ids: List[str],
                 postings: Dict[str, Dict[str, Tuple[np.ndarray,
                                                     np.ndarray]]],
                 norms: Dict[str, np.ndarray],
                 field_stats: Dict[str, FieldStats],
                 stored_source: List[Optional[dict]],
                 exact_lengths: Optional[Dict[str, np.ndarray]] = None):
        self.name = name
        self.num_docs = num_docs
        self.doc_ids = doc_ids                # local doc ord → external _id
        self.postings = postings
        self.norms = norms
        self.field_stats = field_stats
        self.stored_source = stored_source
        self.exact_lengths = exact_lengths or {}

    def doc_freq(self, field: str, term: str) -> int:
        entry = self.postings.get(field, {}).get(term)
        return 0 if entry is None else len(entry[0])


class SegmentWriter:
    """In-memory document buffer; freeze() emits an immutable Segment."""

    def __init__(self, name: str):
        self.name = name
        self._doc_ids: List[str] = []
        self._doc_terms: Dict[str, List[Tuple[int, List[str]]]] = {}
        self._field_lengths: Dict[str, Dict[int, int]] = {}
        self._field_stats: Dict[str, FieldStats] = {}
        self._stored: List[Optional[dict]] = []

    @property
    def num_docs(self) -> int:
        return len(self._doc_ids)

    def add_document(self, doc: ParsedDocument) -> int:
        """Returns the local doc ordinal."""
        ord_ = len(self._doc_ids)
        self._doc_ids.append(doc.doc_id)
        self._stored.append(doc.source)
        for field, terms in doc.postings_terms.items():
            if terms:
                self._doc_terms.setdefault(field, []).append((ord_, terms))
        for field, length in doc.field_lengths.items():
            self._field_lengths.setdefault(field, {})[ord_] = length
            stats = self._field_stats.setdefault(field, FieldStats())
            stats.doc_count += 1
            stats.sum_total_term_freq += length
        return ord_

    def freeze(self) -> Segment:
        n = len(self._doc_ids)
        postings = {field: _build_postings(entries, n)
                    for field, entries in self._doc_terms.items()}
        norms: Dict[str, np.ndarray] = {}
        exact_lengths: Dict[str, np.ndarray] = {}
        for field, lengths in self._field_lengths.items():
            col = np.zeros(n, dtype=np.uint8)
            exact = np.full(n, -1, dtype=np.int64)
            ords = np.fromiter(lengths.keys(), dtype=np.int64,
                               count=len(lengths))
            vals = np.fromiter(lengths.values(), dtype=np.int64,
                               count=len(lengths))
            col[ords] = encode_norms(vals)
            exact[ords] = vals
            norms[field] = col
            exact_lengths[field] = exact
        return Segment(self.name, n, list(self._doc_ids), postings, norms,
                       dict(self._field_stats), list(self._stored),
                       exact_lengths)


def _build_postings(entries: List[Tuple[int, List[str]]], n: int
                    ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """(doc ord, terms) pairs → {term: (docs i32[], tfs i32[])} sorted by
    doc: one (term_id · n + doc) key per token, one np.unique pass for
    (term, doc, tf) triples."""
    doc_ords = np.repeat(
        np.fromiter((e[0] for e in entries), dtype=np.int64,
                    count=len(entries)),
        np.fromiter((len(e[1]) for e in entries), dtype=np.int64,
                    count=len(entries)))
    flat: List[str] = []
    for _, terms in entries:
        flat.extend(terms)
    if not flat:
        return {}
    # fixed-width numpy strings sort in C; degenerate overlong terms would
    # blow the '<U' width up, so fall back to a python vocab dict there
    if max(map(len, flat)) <= 64:
        uniq_arr, inv = np.unique(np.asarray(flat, dtype=np.str_),
                                  return_inverse=True)
        uniq = uniq_arr.tolist()
        inv = inv.astype(np.int64)
    else:
        vocab: Dict[str, int] = {}
        inv = np.fromiter((vocab.setdefault(t, len(vocab)) for t in flat),
                          dtype=np.int64, count=len(flat))
        uniq = list(vocab.keys())
    key = inv * n + doc_ords
    uk, tfs = np.unique(key, return_counts=True)
    term_idx = uk // n
    doc_idx = (uk - term_idx * n).astype(np.int32)
    tfs = tfs.astype(np.int32)
    bounds = np.searchsorted(term_idx, np.arange(len(uniq) + 1))
    return {uniq[t]: (doc_idx[bounds[t]:bounds[t + 1]],
                      tfs[bounds[t]:bounds[t + 1]])
            for t in range(len(uniq))}


class TokenSources:
    """Stored ``_source`` of token-id documents, built on access:
    {field: the space-joined vocab words}."""

    def __init__(self, doc_tokens: List[np.ndarray], vocab: List[str],
                 field: str):
        self.doc_tokens = doc_tokens
        self.vocab = vocab
        self.field = field

    def __len__(self) -> int:
        return len(self.doc_tokens)

    def __getitem__(self, i: int) -> dict:
        return {self.field: " ".join(self.vocab[t]
                                     for t in self.doc_tokens[i])}


def segment_from_token_ids(name: str, doc_ids: List[str],
                           doc_tokens: List[np.ndarray], vocab: List[str],
                           field: str) -> Segment:
    """The Segment that SegmentWriter builds from documents whose only
    field `field` holds the space-joined vocab words of `doc_tokens`,
    computed with array ops on the token ids. Every vocab word must
    analyze to itself (one lowercase word), as the synthetic corpus's
    "w<i>" words do. Bulk builders use it where per-document analysis is
    too slow; a test holds it equal to SegmentWriter."""
    n = len(doc_ids)
    lengths = np.fromiter((len(t) for t in doc_tokens), dtype=np.int64,
                          count=n)
    toks = (np.concatenate(doc_tokens).astype(np.int64) if lengths.sum()
            else np.zeros(0, dtype=np.int64))
    ords = np.repeat(np.arange(n, dtype=np.int64), lengths)
    # terms order like np.unique over the words, as _build_postings does
    words = np.asarray(vocab, dtype=np.str_)
    by_word = np.argsort(words, kind="stable")
    word_rank = np.empty(len(vocab), dtype=np.int64)
    word_rank[by_word] = np.arange(len(vocab))
    span = max(n, 1)
    uk, tfs = np.unique(word_rank[toks] * span + ords, return_counts=True)
    term_rank = uk // span
    doc_idx = (uk - term_rank * span).astype(np.int32)
    tfs = tfs.astype(np.int32)
    present = np.unique(term_rank)
    lo = np.searchsorted(term_rank, present, side="left")
    hi = np.searchsorted(term_rank, present, side="right")
    postings = {str(words[by_word[t]]): (doc_idx[a:b], tfs[a:b])
                for t, a, b in zip(present.tolist(), lo.tolist(),
                                   hi.tolist())}
    return Segment(name, n, list(doc_ids),
                   {field: postings} if postings else {},
                   {field: encode_norms(lengths)},
                   {field: FieldStats(n, int(lengths.sum()))},
                   TokenSources(doc_tokens, vocab, field),
                   {field: lengths.copy()})
