"""Host-side immutable segments: postings, norms, doc values, stored
``_source`` and per-doc write metadata.

Counterpart of the reference's ``index/segment.py``: ``SegmentWriter``
buffers parsed documents and ``freeze()`` emits a ``Segment`` whose
per-field postings are (doc ids i32[], tfs i32[]) sorted by doc, with
SmallFloat-encoded norms, the exact field statistics BM25 needs,
doc-value columns (``DocValuesColumn``: keyword ordinals, i64 numbers,
dates and booleans, f64 floats, f32 dense vectors), the text fields'
term slots (positions for phrase queries, read per candidate doc), the
nested objects of each doc (``nested_store``, matched object by object)
and each doc's seq_no, primary term and version. ``merge_segments`` concatenates segments in order and
drops tombstoned docs, as the reference's force merge does. Live docs
are a mask owned by the shard's engine; segments stay immutable.
``_build_postings`` is the reference's sort-based builder, verbatim.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.mapping import ParsedDocument
from elasticsearch_tpu_torch.mapping.mapper import slots_to_positions
from elasticsearch_tpu_torch.ops.smallfloat import encode_norms

#: an i64 column's "no value in this doc"
MISSING_I64 = -(2**63)


@dataclasses.dataclass
class DocValuesColumn:
    kind: str  # "i64" | "f64" | "ord" | "vec"
    # i64 (MISSING_I64 = missing), f64 (NaN = missing), for "ord" i32
    # ordinals into ord_terms (-1 = missing), for "vec" f32[n, dims]
    # (NaN rows = missing)
    values: np.ndarray
    # multi-valued docs: values stores the FIRST value; extra values per doc here
    extra: Dict[int, List[Any]]
    ord_terms: Optional[List[str]] = None  # sorted unique terms for "ord"


@dataclasses.dataclass
class FieldStats:
    doc_count: int = 0            # docs with this field
    sum_total_term_freq: int = 0  # total tokens (Σ field length)


class Segment:
    """Immutable after construction (by SegmentWriter.freeze, merge or
    segment_from_token_ids)."""

    def __init__(self, name: str, num_docs: int, doc_ids: List[str],
                 postings: Dict[str, Dict[str, Tuple[np.ndarray,
                                                     np.ndarray]]],
                 norms: Dict[str, np.ndarray],
                 field_stats: Dict[str, FieldStats],
                 stored_source: List[Optional[dict]],
                 exact_lengths: Optional[Dict[str, np.ndarray]] = None,
                 *, doc_values: Optional[Dict[str, DocValuesColumn]] = None,
                 seq_nos: Optional[np.ndarray] = None,
                 primary_terms: Optional[np.ndarray] = None,
                 doc_versions: Optional[np.ndarray] = None,
                 token_slots: Optional[Dict[str, Dict[int, List[list]]]]
                 = None,
                 nested_store: Optional[Dict[str, Dict[int, List[Dict[
                     str, List[Any]]]]]] = None):
        self.name = name
        self.num_docs = num_docs
        self.doc_ids = doc_ids                # local doc ord → external _id
        self.postings = postings
        self.norms = norms
        self.field_stats = field_stats
        self.stored_source = stored_source
        self.exact_lengths = exact_lengths or {}
        self.doc_values = doc_values or {}
        # text field → {doc ord: per-value term slots}: the positions
        # phrase queries read
        self.token_slots = token_slots or {}
        # nested root → {doc ord: [per-object {subfield: [raw values]}]}
        self.nested_store = nested_store or {}
        self._pack = None   # index/pack.py's SegmentPack, built on first use
        # per-doc write metadata, persisted so versioning survives a restart
        self.seq_nos = seq_nos if seq_nos is not None else \
            np.full(num_docs, -1, dtype=np.int64)
        self.primary_terms = primary_terms if primary_terms is not None \
            else np.zeros(num_docs, dtype=np.int64)
        self.doc_versions = doc_versions if doc_versions is not None \
            else np.ones(num_docs, dtype=np.int64)
        self._id_to_ord: Optional[Dict[str, int]] = None

    @property
    def id_to_ord(self) -> Dict[str, int]:
        """external _id → local doc ord, built on first use."""
        if self._id_to_ord is None:
            self._id_to_ord = {d: i for i, d in enumerate(self.doc_ids)}
        return self._id_to_ord

    def doc_positions(self, field: str, terms: List[str], doc: int
                      ) -> List[Optional[np.ndarray]]:
        """Each term's positions i32[] in `doc` (None where the term is
        not there), read from that doc's term slots: the arrays of the
        reference's materialized per-term position maps, built for the
        candidate docs of a phrase only."""
        found: Dict[str, List[int]] = {t: [] for t in terms}
        for term, pos in slots_to_positions(
                self.token_slots.get(field, {}).get(doc, [])):
            hit = found.get(term)
            if hit is not None:
                hit.append(pos)
        return [np.asarray(found[t], dtype=np.int32) if found[t] else None
                for t in terms]

    def doc_freq(self, field: str, term: str) -> int:
        entry = self.postings.get(field, {}).get(term)
        return 0 if entry is None else len(entry[0])

    def ram_bytes_estimate(self) -> int:
        """Bytes of the postings, norms and doc-value columns (rollover's
        max_size)."""
        total = 0
        for field_postings in self.postings.values():
            for docs, tfs in field_postings.values():
                total += docs.nbytes + tfs.nbytes
        for n in self.norms.values():
            total += n.nbytes
        for col in self.doc_values.values():
            total += col.values.nbytes
        return total


class SegmentWriter:
    """In-memory document buffer; freeze() emits an immutable Segment."""

    def __init__(self, name: str):
        self.name = name
        self._doc_ids: List[str] = []
        self._doc_terms: Dict[str, List[Tuple[int, List[str]]]] = {}
        self._doc_slots: Dict[str, Dict[int, List[list]]] = {}
        self._nested: Dict[str, Dict[int, List[Dict[str, List[Any]]]]] = {}
        self._field_lengths: Dict[str, Dict[int, int]] = {}
        self._field_stats: Dict[str, FieldStats] = {}
        self._doc_values: Dict[str, Dict[int, Any]] = {}
        self._dv_kinds: Dict[str, str] = {}
        self._stored: List[Optional[dict]] = []
        self._seq_nos: List[int] = []
        self._primary_terms: List[int] = []
        self._versions: List[int] = []

    @property
    def num_docs(self) -> int:
        return len(self._doc_ids)

    def add_document(self, doc: ParsedDocument, dv_kinds: Dict[str, str],
                     seq_no: int = -1, primary_term: int = 0,
                     version: int = 1) -> int:
        """dv_kinds: field → "i64" | "f64" | "ord", from the mapper's
        field types (MapperService.dv_kinds). Returns the local doc
        ordinal."""
        ord_ = len(self._doc_ids)
        self._doc_ids.append(doc.doc_id)
        self._stored.append(doc.source)
        self._seq_nos.append(seq_no)
        self._primary_terms.append(primary_term)
        self._versions.append(version)
        for field, terms in doc.postings_terms.items():
            if terms:
                self._doc_terms.setdefault(field, []).append((ord_, terms))
        for field, slot_lists in doc.term_slots.items():
            self._doc_slots.setdefault(field, {})[ord_] = slot_lists
        for root, objs in doc.nested.items():
            if objs:
                self._nested.setdefault(root, {})[ord_] = objs
        for field, length in doc.field_lengths.items():
            self._field_lengths.setdefault(field, {})[ord_] = length
            stats = self._field_stats.setdefault(field, FieldStats())
            stats.doc_count += 1
            stats.sum_total_term_freq += length
        for field, dv in doc.doc_values.items():
            self._doc_values.setdefault(field, {})[ord_] = dv
            if field in dv_kinds:
                self._dv_kinds[field] = dv_kinds[field]
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
        doc_values = {field: _build_dv_column(
                          self._dv_kinds.get(field, "i64"), per_doc, n)
                      for field, per_doc in self._doc_values.items()}
        return Segment(self.name, n, list(self._doc_ids), postings, norms,
                       dict(self._field_stats), list(self._stored),
                       exact_lengths, doc_values=doc_values,
                       seq_nos=np.array(self._seq_nos, dtype=np.int64),
                       primary_terms=np.array(self._primary_terms,
                                              dtype=np.int64),
                       doc_versions=np.array(self._versions, dtype=np.int64),
                       token_slots={f: dict(d)
                                    for f, d in self._doc_slots.items()},
                       nested_store={r: dict(d)
                                     for r, d in self._nested.items()})


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


def _build_dv_column(kind: str, per_doc: Dict[int, Any], n: int
                     ) -> DocValuesColumn:
    """A doc-value column of `kind` over n docs: the first value of each
    doc in `values`, the rest in `extra`."""
    extra: Dict[int, List[Any]] = {}
    if kind == "vec":
        # one fixed-dim vector per doc: the value is the list
        dims = len(next(iter(per_doc.values()))) if per_doc else 0
        values = np.full((n, max(dims, 1)), np.nan, dtype=np.float32)
        for d, v in per_doc.items():
            values[d] = np.asarray(v, dtype=np.float32)
        return DocValuesColumn("vec", values, extra)
    if kind == "ord":
        uniq = set()
        for v in per_doc.values():
            for x in (v if isinstance(v, list) else [v]):
                uniq.add(x)
        ord_terms = sorted(uniq)
        ord_of = {t: i for i, t in enumerate(ord_terms)}
        values = np.full(n, -1, dtype=np.int32)
        for d, v in per_doc.items():
            vs = v if isinstance(v, list) else [v]
            values[d] = ord_of[vs[0]]
            if len(vs) > 1:
                extra[d] = [ord_of[x] for x in vs[1:]]
        return DocValuesColumn("ord", values, extra, ord_terms)
    if kind == "f64":
        values = np.full(n, np.nan, dtype=np.float64)
    else:
        values = np.full(n, MISSING_I64, dtype=np.int64)
    for d, v in per_doc.items():
        vs = v if isinstance(v, list) else [v]
        values[d] = vs[0]
        if len(vs) > 1:
            extra[d] = vs[1:]
    return DocValuesColumn(kind, values, extra)


def merge_segments(name: str, segments: List[Segment],
                   live_docs: Optional[List[np.ndarray]] = None) -> Segment:
    """Concatenate segments into one, in order, dropping tombstoned docs
    (live_docs[i]: bool mask over segments[i]'s docs, None = all live).
    Postings stay doc-sorted and statistics stay exact."""
    doc_ids: List[str] = []
    stored: List[Optional[dict]] = []
    remap: List[np.ndarray] = []  # per segment: old ord -> new ord (-1 dropped)
    keeps: List[np.ndarray] = []
    for i, seg in enumerate(segments):
        mask = live_docs[i] if live_docs is not None and live_docs[i] is not None \
            else np.ones(seg.num_docs, dtype=bool)
        m = np.full(seg.num_docs, -1, dtype=np.int64)
        keep = np.nonzero(mask)[0]
        m[keep] = np.arange(len(doc_ids), len(doc_ids) + len(keep))
        remap.append(m)
        keeps.append(keep)
        for ord_ in keep.tolist():
            doc_ids.append(seg.doc_ids[ord_])
            stored.append(seg.stored_source[ord_])
    n = len(doc_ids)
    seq_nos = np.concatenate([s.seq_nos[k] for s, k in zip(segments, keeps)]
                             + [np.zeros(0, dtype=np.int64)])
    primary_terms = np.concatenate(
        [s.primary_terms[k] for s, k in zip(segments, keeps)]
        + [np.zeros(0, dtype=np.int64)])
    doc_versions = np.concatenate(
        [s.doc_versions[k] for s, k in zip(segments, keeps)]
        + [np.zeros(0, dtype=np.int64)])

    postings: Dict[str, Dict[str, Tuple[np.ndarray, np.ndarray]]] = {}
    token_slots: Dict[str, Dict[int, List[list]]] = {}
    nested_store: Dict[str, Dict[int, List[Dict[str, List[Any]]]]] = {}
    for m, seg in zip(remap, segments):
        for field, per_doc in seg.token_slots.items():
            out = token_slots.setdefault(field, {})
            for d, slot_lists in per_doc.items():
                nd = int(m[d])
                if nd >= 0:
                    out[nd] = slot_lists
        for root, per_doc in seg.nested_store.items():
            for d, objs in per_doc.items():
                nd = int(m[d])
                if nd >= 0:
                    nested_store.setdefault(root, {})[nd] = objs
    norms: Dict[str, np.ndarray] = {}
    field_stats: Dict[str, FieldStats] = {}
    dv_parts: Dict[str, List[Tuple[int, DocValuesColumn, np.ndarray]]] = {}
    all_fields = set()
    for seg in segments:
        all_fields.update(seg.postings.keys())
        all_fields.update(seg.norms.keys())
        all_fields.update(seg.doc_values.keys())
    exact_lengths: Dict[str, np.ndarray] = {}
    for field in all_fields:
        acc: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
        norm_col = np.zeros(n, dtype=np.uint8)
        exact_col = np.full(n, -1, dtype=np.int64)
        has_norms = False
        stats = FieldStats()
        for i, seg in enumerate(segments):
            m = remap[i]
            for term, (docs, tfs) in seg.postings.get(field, {}).items():
                new = m[docs]
                keep = new >= 0
                if keep.any():
                    acc.setdefault(term, []).append(
                        (new[keep].astype(np.int32), tfs[keep]))
            if field in seg.norms:
                has_norms = True
                src = seg.norms[field]
                keep = m >= 0
                norm_col[m[keep]] = src[keep]
                # statistics stay exact across merges (recomputing them
                # from the lossy norm bytes would shift avgdl)
                src_exact = seg.exact_lengths.get(field)
                if src_exact is None:
                    raise ValueError(
                        f"segment [{seg.name}] lacks exact lengths for [{field}]")
                exact_col[m[keep]] = src_exact[keep]
                surviving = src_exact[keep]
                present = surviving >= 0
                stats.doc_count += int(present.sum())
                stats.sum_total_term_freq += int(surviving[present].sum())
            if field in seg.doc_values:
                dv_parts.setdefault(field, []).append((i, seg.doc_values[field], m))
        if acc:
            merged_terms = {}
            for term, parts in acc.items():
                docs = np.concatenate([p[0] for p in parts])
                tfs = np.concatenate([p[1] for p in parts])
                order = np.argsort(docs, kind="stable")
                merged_terms[term] = (docs[order], tfs[order])
            postings[field] = merged_terms
        if has_norms:
            norms[field] = norm_col
            exact_lengths[field] = exact_col
            field_stats[field] = stats

    doc_values: Dict[str, DocValuesColumn] = {}
    for field, parts in dv_parts.items():
        kind = parts[0][1].kind
        per_doc: Dict[int, Any] = {}
        for _, col, m in parts:
            for old in range(len(col.values)):
                new = int(m[old])
                if new < 0:
                    continue
                if col.kind == "vec":
                    row = col.values[old]
                    if np.isnan(row).any():
                        continue
                    per_doc[new] = row
                    continue
                if col.kind == "ord":
                    if col.values[old] < 0:
                        continue
                    vals = [col.ord_terms[col.values[old]]]
                    vals += [col.ord_terms[x]
                             for x in col.extra.get(old, [])]
                else:
                    v = col.values[old]
                    if col.kind == "i64" and v == MISSING_I64:
                        continue
                    if col.kind == "f64" and np.isnan(v):
                        continue
                    vals = [v] + list(col.extra.get(old, []))
                per_doc[new] = vals if len(vals) > 1 else vals[0]
        doc_values[field] = _build_dv_column(kind, per_doc, n)

    return Segment(name, n, doc_ids, postings, norms, field_stats, stored,
                   exact_lengths, doc_values=doc_values, seq_nos=seq_nos,
                   primary_terms=primary_terms, doc_versions=doc_versions,
                   token_slots=token_slots, nested_store=nested_store)


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
