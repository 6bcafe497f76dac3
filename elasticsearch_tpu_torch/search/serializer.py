"""Columnar response assembly for the kernel serving path.

Copy of the reference's ``search/serializer.py`` without the serving
fronts' wire form. The hot response shape — metadata-only hits
(``"_source": false``), the shape high-QPS retrieval traffic uses — is
serialized columnar: external ids resolve via one fancy-index over the
pack's id table, ids and scores are JSON-encoded as whole arrays in
single C-level ``json.dumps`` calls, and the hits block is assembled from
the encoded fragments without a per-hit dict.

The fragment assembly itself is the response splicer
(``csrc/response_splice.c``, through ``native``): the columns ship as
whole encoded arrays and the C side splits them into elements and
concatenates the per-hit objects. ``_py_splice`` is the byte-identical
Python path when the library cannot be built (same element scanner, same
concatenation), so a missing compiler changes speed, never bytes.

`ColumnarHits` is a lazy Sequence: in-process consumers (tests, the
multi-index merge) that index or iterate it see ordinary hit dicts — built once,
on first touch, via assemble_hits_list — while
the REST layer serializes it straight from the columns via
`dumps_response` without materializing anything. `SplicedHits` wraps
already-materialized hit dicts (the multi-index merge path) so their
rendering goes through the splicer too.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
from collections.abc import Sequence
from typing import Any, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch import native
from elasticsearch_tpu_torch.search.query_phase import filter_source

__all__ = ["ColumnarHits", "SplicedHits", "SpliceColumns",
           "assemble_hits_list", "dumps_response", "hits_columns_from_dicts",
           "splice_hits_bytes"]

_COMPACT = (",", ":")


def assemble_hits_list(name: str, resident, scores, rows, ords, source,
                       version: bool, seq_no_primary_term: bool
                       ) -> List[Dict[str, Any]]:
    """Columnar window → response hit dicts (the materialized form).
    ids via one fancy-index; stored fields (when requested) read
    directly from the segments the pack was scored against (same
    snapshot contract as the fetch phase). `source` is the body's
    ``_source``: a list or tuple filters the stored source, False drops
    it, any other value returns it whole."""
    if resident is None or len(scores) == 0:
        return []
    ids = resident.resolve_ids(rows, ords).tolist()
    scores_l = scores.tolist()
    if source is False and not version and not seq_no_primary_term:
        return [{"_index": name, "_id": i, "_score": s}
                for i, s in zip(ids, scores_l)]
    segs = resident.row_segments
    rows_l = rows.tolist()
    ords_l = ords.tolist()
    out = []
    for i, s, row, o in zip(ids, scores_l, rows_l, ords_l):
        doc: Dict[str, Any] = {"_index": name, "_id": i, "_score": s}
        seg = segs[row]
        if source is not False:
            src = seg.stored_source[o]
            if isinstance(source, (list, tuple)):
                src = filter_source(src or {}, list(source))
            doc["_source"] = src
        if version:
            doc["_version"] = int(seg.doc_versions[o])
        if seq_no_primary_term:
            doc["_seq_no"] = int(seg.seq_nos[o])
            doc["_primary_term"] = int(seg.primary_terms[o])
        out.append(doc)
    return out


# ---------------------------------------------------------------------------
# the response splicer: pre-encoded columns → final hits-array bytes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpliceColumns:
    """Wire form of a hits block: whole-array json.dumps encodings.

    Every byte of the final output comes from one of these strings, so
    splicing (C or Python) is byte-identical to per-hit json.dumps with
    compact separators."""

    n: int
    ids_json: str                      # '["a","b"]'
    scores_json: str                   # '[1.5,null]'
    names_json: str                    # '["idx"]' (deduped _index names)
    name_idx: List[int]                # per-hit index into names_json
    extras_json: Optional[str] = None  # '[{...},{}]' residual fields


_SPLICE_FN = None
_SPLICE_TRIED = False


def _native_splice():
    global _SPLICE_FN, _SPLICE_TRIED
    if not _SPLICE_TRIED:
        _SPLICE_TRIED = True
        _SPLICE_FN = native.bind(
            "response_splice", "es_splice_hits", ctypes.c_long,
            [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
             ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
             ctypes.c_int32, ctypes.c_char_p, ctypes.c_long])
        native.note("response_splice",
                    "c" if _SPLICE_FN is not None else "python")
    return _SPLICE_FN


def splice_hits_bytes(cols: SpliceColumns) -> str:
    """Columns → the hits-array JSON text, via the C splicer when the
    native library is available, else the byte-identical Python path."""
    if cols.n == 0:
        return "[]"
    fn = _native_splice()
    if fn is not None:
        ids_b = cols.ids_json.encode("ascii", "replace")
        scores_b = cols.scores_json.encode("ascii", "replace")
        names_b = cols.names_json.encode("ascii", "replace")
        extras_b = (cols.extras_json.encode("ascii", "replace")
                    if cols.extras_json is not None else None)
        idx = (ctypes.c_int32 * cols.n)(*cols.name_idx)
        cap = (len(ids_b) + len(scores_b) + (len(extras_b or b""))
               + cols.n * (len(names_b) + 32) + 16)
        for _ in range(2):
            buf = ctypes.create_string_buffer(cap)
            rc = fn(ids_b, scores_b, names_b, idx, extras_b, cols.n,
                    buf, cap)
            if rc >= 0:
                return buf.raw[:rc].decode("ascii")
            if rc != -1:
                break  # malformed input — let Python decide
            cap *= 4
    return _py_splice(cols)


def _scan_elements(s: str) -> Optional[List[str]]:
    """Split a compact JSON array into its top-level element strings —
    the Python twin of the C scanner (string-escape + depth aware)."""
    if not s or s[0] != "[":
        return None
    if s.startswith("[]"):
        return []
    out: List[str] = []
    depth = 0
    in_str = esc = False
    start = 1
    for i in range(1, len(s)):
        c = s[i]
        if in_str:
            if esc:
                esc = False
            elif c == "\\":
                esc = True
            elif c == '"':
                in_str = False
            continue
        if c == '"':
            in_str = True
        elif c in "{[":
            depth += 1
        elif c == "}":
            depth -= 1
        elif c == "]":
            if depth == 0:
                out.append(s[start:i])
                return out
            depth -= 1
        elif c == "," and depth == 0:
            out.append(s[start:i])
            start = i + 1
    return None


def _py_splice(cols: SpliceColumns) -> str:
    """Pure-Python splice — same element spans, same concatenation, so
    bytes match the native path exactly."""
    ids = _scan_elements(cols.ids_json)
    scores = _scan_elements(cols.scores_json)
    names = _scan_elements(cols.names_json)
    extras = (_scan_elements(cols.extras_json)
              if cols.extras_json is not None else None)
    if (ids is None or scores is None or not names
            or len(ids) != cols.n or len(scores) != cols.n
            or (extras is not None and len(extras) != cols.n)):
        raise ValueError("malformed splice columns")
    frags = []
    for i in range(cols.n):
        hit = ('{"_index":' + names[cols.name_idx[i]]
               + ',"_id":' + ids[i] + ',"_score":' + scores[i])
        if extras is not None and len(extras[i]) > 2:
            hit += "," + extras[i][1:-1]
        frags.append(hit + "}")
    return "[" + ",".join(frags) + "]"


_META_KEYS = ["_index", "_id", "_score"]


def hits_columns_from_dicts(hits: List[Dict[str, Any]]
                            ) -> Optional[SpliceColumns]:
    """Materialized hit dicts → splice columns, or None when the hits
    don't lead with the canonical (_index, _id, _score) key order (the
    caller then falls back to plain json.dumps)."""
    if not hits:
        return SpliceColumns(0, "[]", "[]", "[]", [])
    names: List[str] = []
    name_pos: Dict[str, int] = {}
    name_idx: List[int] = []
    ids: List[Any] = []
    scores: List[Any] = []
    extras: List[Dict[str, Any]] = []
    any_extra = False
    for h in hits:
        if not isinstance(h, dict):
            return None
        keys = list(h)
        if keys[:3] != _META_KEYS:
            return None
        name = h["_index"]
        if not isinstance(name, str):
            return None
        pos = name_pos.get(name)
        if pos is None:
            pos = name_pos[name] = len(names)
            names.append(name)
        name_idx.append(pos)
        ids.append(h["_id"])
        scores.append(h["_score"])
        extra = {k: h[k] for k in keys[3:]}
        if extra:
            any_extra = True
        extras.append(extra)
    try:
        return SpliceColumns(
            len(hits),
            json.dumps(ids, separators=_COMPACT),
            json.dumps(scores, separators=_COMPACT),
            json.dumps(names, separators=_COMPACT),
            name_idx,
            json.dumps(extras, separators=_COMPACT) if any_extra else None)
    except (TypeError, ValueError):
        return None  # unserializable value — plain dumps raises the same


class ColumnarHits(Sequence):
    """Lazy hits block over kernel result columns.

    Reads like a list of hit dicts (len / index / slice / iterate);
    materializes that list at most once and caches it, so consumers that
    MUTATE hits keep their edits visible to a
    later serialization. `to_json()` renders the block via the response
    splicer; for the metadata-only shape it never touches per-hit Python
    at all."""

    __slots__ = ("name", "resident", "scores", "rows", "ords", "source",
                 "version", "seq_no_primary_term", "_hits")

    def __init__(self, name: str, resident, scores, rows, ords,
                 source=False, version: bool = False,
                 seq_no_primary_term: bool = False):
        self.name = name
        self.resident = resident
        self.scores = scores
        self.rows = rows
        self.ords = ords
        self.source = source
        self.version = version
        self.seq_no_primary_term = seq_no_primary_term
        self._hits: Optional[List[Dict[str, Any]]] = None

    # ---- list protocol --------------------------------------------------

    def _materialize(self) -> List[Dict[str, Any]]:
        if self._hits is None:
            self._hits = assemble_hits_list(
                self.name, self.resident, self.scores, self.rows,
                self.ords, self.source, self.version,
                self.seq_no_primary_term)
        return self._hits

    def __len__(self) -> int:
        return len(self.scores)

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())

    def __eq__(self, other):
        if isinstance(other, (ColumnarHits, SplicedHits)):
            other = list(other)
        if isinstance(other, list):
            return self._materialize() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"ColumnarHits(n={len(self.scores)}, index={self.name!r})"

    # ---- serialization --------------------------------------------------

    def splice_columns(self) -> Optional[SpliceColumns]:
        """This block as splice columns (None ⇒ caller must dumps)."""
        if self._hits is not None:
            # already materialized (possibly mutated) — honor the dicts
            return hits_columns_from_dicts(self._hits)
        cols = self._fast_columns()
        if cols is not None:
            return cols
        return hits_columns_from_dicts(self._materialize())

    def _fast_columns(self) -> Optional[SpliceColumns]:
        """Columns straight from the kernel result arrays — the
        metadata-only shape, no per-hit dict ever exists. None when this
        block needs the materialized path (_source / _version / seq_no,
        or non-string ids)."""
        if not (self.source is False and not self.version
                and not self.seq_no_primary_term):
            return None
        if self.resident is None or len(self.scores) == 0:
            return SpliceColumns(0, "[]", "[]", "[]", [])
        ids = self.resident.resolve_ids(self.rows, self.ords).tolist()
        if not all(type(i) is str for i in ids):
            return None
        n = len(ids)
        return SpliceColumns(
            n, json.dumps(ids, separators=_COMPACT),
            json.dumps(self.scores.tolist(), separators=_COMPACT),
            "[" + json.dumps(self.name) + "]", [0] * n)

    def _fast_json(self) -> Optional[str]:
        """Single-pass serialization of the metadata-only shape, or None
        when this block needs the materialized path."""
        cols = self._fast_columns()
        if cols is None:
            return None
        return splice_hits_bytes(cols)

    def to_json(self) -> str:
        cols = self.splice_columns()
        if cols is not None:
            return splice_hits_bytes(cols)
        return json.dumps(self._materialize(), separators=_COMPACT)


class SplicedHits(Sequence):
    """Materialized hit dicts whose JSON rendering goes through the
    response splicer (the multi-index merge path: hits already exist as
    dicts, but per-hit serialization is still worth batching)."""

    __slots__ = ("_hits",)

    def __init__(self, hits: List[Dict[str, Any]]):
        self._hits = hits

    def __len__(self) -> int:
        return len(self._hits)

    def __getitem__(self, i):
        return self._hits[i]

    def __iter__(self):
        return iter(self._hits)

    def __eq__(self, other):
        if isinstance(other, (ColumnarHits, SplicedHits)):
            other = list(other)
        if isinstance(other, list):
            return self._hits == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"SplicedHits(n={len(self._hits)})"

    def append(self, hit: Dict[str, Any]) -> None:
        self._hits.append(hit)

    def splice_columns(self) -> Optional[SpliceColumns]:
        return hits_columns_from_dicts(self._hits)

    def to_json(self) -> str:
        cols = self.splice_columns()
        if cols is not None:
            return splice_hits_bytes(cols)
        return json.dumps(self._hits, separators=_COMPACT)


_HITS_BLOCKS = (ColumnarHits, SplicedHits)


def _tokenize(payload: Any) -> Tuple[str, Dict[str, Any]]:
    """json.dumps with every hits block replaced by a unique placeholder
    token; blocks come back keyed by token in document order."""
    blocks: Dict[str, Any] = {}

    def default(obj):
        if isinstance(obj, _HITS_BLOCKS):
            token = f"\x00columnar:{id(obj)}\x00"
            blocks[token] = obj
            return token
        raise TypeError(
            f"Object of type {type(obj).__name__} is not JSON serializable")

    return json.dumps(payload, default=default), blocks


def dumps_response(payload: Any) -> str:
    """json.dumps that renders embedded hits blocks via the response
    splicer. Works at any nesting depth (plain search, msearch
    `responses`, ...): the encoder emits a unique placeholder token per
    block, then the tokens are spliced with the real JSON."""
    text, blocks = _tokenize(payload)
    for token, block in blocks.items():
        text = text.replace(json.dumps(token), block.to_json())
    return text
