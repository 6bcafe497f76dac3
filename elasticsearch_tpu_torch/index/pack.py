"""Padded postings layout of one (segment, field), and a segment's pack.

Counterpart of the reference's ``index/pack.py``: ``LANE``, ``_pad_to``
and ``build_field_pack`` (what the stacked pack of the kernel path
reads), and ``SegmentPack`` / ``build_segment_pack``, every packed field
of one segment with its doc-value columns padded to ``d_pad`` (what the
planner reads; live docs stay with the reader). flat_docs pads with
d_pad (one past the last real doc row); an i64 column pads with
MISSING_I64, an f64 one with NaN, an ordinal one with -1, a dense
vector's rows with NaN. The arrays
stay on the host; the planner copies to the card only what a query
touches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.index.segment import MISSING_I64, Segment

LANE = 128  # pad unit of every postings and doc axis


def _pad_to(n: int, unit: int = LANE) -> int:
    return ((n + unit - 1) // unit) * unit if n else unit


@dataclasses.dataclass
class FieldPack:
    """One field's postings + norms for one segment (host arrays)."""

    field: str
    num_docs: int
    d_pad: int
    flat_docs: np.ndarray   # int32[P_pad]
    flat_tfs: np.ndarray    # int32[P_pad]
    row_start: np.ndarray   # int64[V+1]
    norms_u8: np.ndarray    # uint8[D_pad]
    vocab: Dict[str, int]
    doc_freq: np.ndarray    # int64[V]

    def term_row(self, term: str) -> int:
        return self.vocab.get(term, -1)

    def row_slice(self, row: int) -> Tuple[int, int]:
        """(start, length) of a term row; (0, 0) for row -1."""
        if row < 0:
            return 0, 0
        s, e = int(self.row_start[row]), int(self.row_start[row + 1])
        return s, e - s


@dataclasses.dataclass
class SegmentPack:
    """All packed fields of one segment and its doc-value columns."""

    segment_name: str
    num_docs: int
    d_pad: int
    fields: Dict[str, FieldPack]
    dv_i64: Dict[str, np.ndarray]
    dv_f64: Dict[str, np.ndarray]
    dv_ord: Dict[str, np.ndarray]
    # dense_vector matrices f32[d_pad, dims] (NaN rows = missing/padding)
    dv_vec: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # an ordinal column's terms, by ordinal
    dv_ord_terms: Dict[str, List[str]] = dataclasses.field(
        default_factory=dict)


def build_field_pack(segment: Segment, field: str,
                     d_pad: int) -> Optional[FieldPack]:
    postings = segment.postings.get(field)
    if not postings:
        return None
    terms = sorted(postings.keys())
    vocab = {t: i for i, t in enumerate(terms)}
    sizes = [len(postings[t][0]) for t in terms]
    total = sum(sizes)
    p_pad = _pad_to(total)
    flat_docs = np.full(p_pad, d_pad, dtype=np.int32)
    flat_tfs = np.zeros(p_pad, dtype=np.int32)
    row_start = np.zeros(len(terms) + 1, dtype=np.int64)
    pos = 0
    for i, t in enumerate(terms):
        docs, tfs = postings[t]
        row_start[i] = pos
        flat_docs[pos:pos + len(docs)] = docs
        flat_tfs[pos:pos + len(docs)] = tfs
        pos += len(docs)
    row_start[len(terms)] = pos
    norms = np.zeros(d_pad, dtype=np.uint8)
    seg_norms = segment.norms.get(field)
    if seg_norms is not None:
        norms[: segment.num_docs] = seg_norms
    doc_freq = np.array(sizes, dtype=np.int64)
    return FieldPack(field, segment.num_docs, d_pad, flat_docs, flat_tfs,
                     row_start, norms, vocab, doc_freq)


def build_segment_pack(segment: Segment) -> SegmentPack:
    d_pad = _pad_to(segment.num_docs)
    fields: Dict[str, FieldPack] = {}
    for field in segment.postings:
        fp = build_field_pack(segment, field, d_pad)
        if fp is not None:
            fields[field] = fp
    dv_i64: Dict[str, np.ndarray] = {}
    dv_f64: Dict[str, np.ndarray] = {}
    dv_ord: Dict[str, np.ndarray] = {}
    dv_vec: Dict[str, np.ndarray] = {}
    dv_ord_terms: Dict[str, List[str]] = {}
    for field, col in segment.doc_values.items():
        if col.kind == "vec":
            a = np.full((d_pad, col.values.shape[1]), np.nan,
                        dtype=np.float32)
            a[: segment.num_docs] = col.values
            dv_vec[field] = a
        elif col.kind == "i64":
            a = np.full(d_pad, MISSING_I64, dtype=np.int64)
            a[: segment.num_docs] = col.values
            dv_i64[field] = a
        elif col.kind == "f64":
            a = np.full(d_pad, np.nan, dtype=np.float64)
            a[: segment.num_docs] = col.values
            dv_f64[field] = a
        else:
            a = np.full(d_pad, -1, dtype=np.int32)
            a[: segment.num_docs] = col.values
            dv_ord[field] = a
            dv_ord_terms[field] = list(col.ord_terms or [])
    return SegmentPack(segment.name, segment.num_docs, d_pad, fields,
                       dv_i64, dv_f64, dv_ord, dv_vec, dv_ord_terms)


def segment_pack(segment: Segment) -> SegmentPack:
    """The segment's pack, built on first use and kept on the segment
    (both are immutable; live docs stay with the reader)."""
    pack = segment._pack
    if pack is None:
        pack = segment._pack = build_segment_pack(segment)
    return pack
