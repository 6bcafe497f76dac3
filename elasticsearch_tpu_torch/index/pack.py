"""Padded postings layout of one (segment, field).

Counterpart of the reference's ``index/pack.py`` for what the stacked
pack reads: ``LANE``, ``_pad_to`` and ``build_field_pack``. flat_docs pads
with d_pad (one past the last real doc row).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from elasticsearch_tpu_torch.index.segment import Segment

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
