"""Segment persistence: the on-disk commit format.

Copy of the reference's ``index/store.py`` (positions and nested stores
left out). A commit is:

  <dir>/segments/<name>.npz       postings/norms/doc-values arrays
  <dir>/segments/<name>.json      vocab, doc ids, stored sources
  <dir>/commit.json               atomic manifest: segment names, live-doc
                                  tombstones, local_checkpoint, max_seq_no,
                                  primary_term, translog generation, mapping

Commit replace is atomic (tmp+rename+fsync, translog.write_atomic); a
crash between segment writes and the manifest leaves orphan segment files
that the next commit ignores. Every file carries a CRC in the manifest,
which load verifies.
"""

from __future__ import annotations

import io
import json
import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import EsException
from elasticsearch_tpu_torch.index.segment import (DocValuesColumn,
                                                   FieldStats, Segment)
from elasticsearch_tpu_torch.index.translog import write_atomic


class CorruptIndexException(EsException):
    pass


def _segments_dir(path: str) -> str:
    return os.path.join(path, "segments")


def save_segment(path: str, seg: Segment) -> Dict[str, int]:
    """Write one segment; returns {filename: crc32} for the manifest."""
    os.makedirs(_segments_dir(path), exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, object] = {
        "name": seg.name, "num_docs": seg.num_docs, "doc_ids": seg.doc_ids,
        "stored": [seg.stored_source[i] for i in range(seg.num_docs)],
        "field_stats": {f: [st.doc_count, st.sum_total_term_freq]
                        for f, st in seg.field_stats.items()},
        "postings_fields": {}, "dv": {},
    }
    for field, terms in seg.postings.items():
        names = sorted(terms.keys())
        sizes = [len(terms[t][0]) for t in names]
        row_start = np.zeros(len(names) + 1, dtype=np.int64)
        np.cumsum(sizes, out=row_start[1:])
        total = int(row_start[-1])
        docs = np.empty(total, dtype=np.int32)
        tfs = np.empty(total, dtype=np.int32)
        for i, t in enumerate(names):
            d, f = terms[t]
            docs[row_start[i]:row_start[i + 1]] = d
            tfs[row_start[i]:row_start[i + 1]] = f
        key = f"post.{field}"
        arrays[key + ".docs"] = docs
        arrays[key + ".tfs"] = tfs
        arrays[key + ".rows"] = row_start
        meta["postings_fields"][field] = names
    for field, col in seg.norms.items():
        arrays[f"norm.{field}"] = col
        arrays[f"exact.{field}"] = seg.exact_lengths[field]
    for field, col in seg.doc_values.items():
        arrays[f"dv.{field}"] = col.values
        meta["dv"][field] = {
            "kind": col.kind, "ord_terms": col.ord_terms,
            "extra": {str(k): v for k, v in col.extra.items()}}
    arrays["meta.seq_nos"] = seg.seq_nos
    arrays["meta.primary_terms"] = seg.primary_terms
    arrays["meta.doc_versions"] = seg.doc_versions
    npz_path = os.path.join(_segments_dir(path), f"{seg.name}.npz")
    json_path = os.path.join(_segments_dir(path), f"{seg.name}.json")
    # fsync-before-manifest ordering: a durable commit.json can never
    # reference un-durable segment bytes
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    npz_bytes = buf.getvalue()
    write_atomic(npz_path, npz_bytes)
    json_bytes = json.dumps(meta).encode("utf-8")
    write_atomic(json_path, json_bytes)
    return {f"{seg.name}.npz": zlib.crc32(npz_bytes),
            f"{seg.name}.json": zlib.crc32(json_bytes)}


def load_segment(path: str, name: str,
                 expected_crcs: Optional[Dict[str, int]] = None) -> Segment:
    npz_path = os.path.join(_segments_dir(path), f"{name}.npz")
    json_path = os.path.join(_segments_dir(path), f"{name}.json")
    try:
        with open(json_path, "rb") as f:
            json_bytes = f.read()
        with open(npz_path, "rb") as f:
            npz_bytes = f.read()
    except FileNotFoundError as e:
        raise CorruptIndexException(f"missing segment file: {e}")
    if expected_crcs is not None:
        if zlib.crc32(npz_bytes) != expected_crcs.get(f"{name}.npz"):
            raise CorruptIndexException(f"segment [{name}] npz checksum mismatch")
        if zlib.crc32(json_bytes) != expected_crcs.get(f"{name}.json"):
            raise CorruptIndexException(f"segment [{name}] json checksum mismatch")
    meta = json.loads(json_bytes.decode("utf-8"))
    arrays = np.load(io.BytesIO(npz_bytes))
    postings: Dict[str, Dict[str, Tuple[np.ndarray, np.ndarray]]] = {}
    for field, names in meta["postings_fields"].items():
        docs = arrays[f"post.{field}.docs"]
        tfs = arrays[f"post.{field}.tfs"]
        rows = arrays[f"post.{field}.rows"]
        postings[field] = {
            t: (docs[rows[i]:rows[i + 1]], tfs[rows[i]:rows[i + 1]])
            for i, t in enumerate(names)}
    norms = {}
    exact = {}
    for key in arrays.files:
        if key.startswith("norm."):
            norms[key[5:]] = arrays[key]
        elif key.startswith("exact."):
            exact[key[6:]] = arrays[key]
    field_stats = {f: FieldStats(v[0], v[1])
                   for f, v in meta["field_stats"].items()}
    doc_values = {}
    for field, d in meta["dv"].items():
        doc_values[field] = DocValuesColumn(
            d["kind"], arrays[f"dv.{field}"],
            {int(k): v for k, v in d["extra"].items()}, d["ord_terms"])
    return Segment(meta["name"], meta["num_docs"], meta["doc_ids"], postings,
                   norms, field_stats, meta["stored"], exact,
                   doc_values=doc_values, seq_nos=arrays["meta.seq_nos"],
                   primary_terms=arrays["meta.primary_terms"],
                   doc_versions=arrays["meta.doc_versions"])


def write_commit(path: str, *, segments: List[str],
                 tombstones: Dict[str, List[int]],
                 local_checkpoint: int, max_seq_no: int, primary_term: int,
                 translog_generation: int, mapping: dict,
                 file_crcs: Dict[str, int],
                 history_uuid: str) -> None:
    manifest = {
        "segments": segments, "tombstones": tombstones,
        "local_checkpoint": local_checkpoint, "max_seq_no": max_seq_no,
        "primary_term": primary_term,
        "translog_generation": translog_generation,
        "mapping": mapping, "file_crcs": file_crcs,
        "history_uuid": history_uuid,
    }
    write_atomic(os.path.join(path, "commit.json"),
                 json.dumps(manifest).encode("utf-8"))


def read_commit(path: str) -> Optional[dict]:
    p = os.path.join(path, "commit.json")
    if not os.path.exists(p):
        return None
    with open(p, "rb") as f:
        return json.loads(f.read().decode("utf-8"))


def cleanup_unreferenced(path: str, referenced: List[str]) -> None:
    """Delete segment files not named by the live commit (orphans from
    crashes or merged-away segments)."""
    sdir = _segments_dir(path)
    if not os.path.isdir(sdir):
        return
    keep = set()
    for name in referenced:
        keep.add(f"{name}.npz")
        keep.add(f"{name}.json")
    for fn in os.listdir(sdir):
        if fn not in keep and not fn.endswith(".tmp"):
            os.remove(os.path.join(sdir, fn))
