"""Aggregations' device reductions: copy of the reference's
``search/aggregations/device.py``.

The terms, histogram / date_histogram, stats and cardinality collectors
are masked reductions over a segment pack's doc-value columns, run by
the kernels of ``ops/agg_kernel.py`` (``csrc/aggs.cu`` on a CUDA device,
their plain versions on the CPU):

    terms:      counts[ord] += mask            (agg_bucket_counts)
    histogram:  counts[floor((v - off) / w)] += mask
    calendar:   counts[last boundary <= v] += mask
    presence:   present[ord] = 1               (cardinality)
    stats:      (count, sum, min, max)         (agg_masked_stats)
    sub-stats:  per ordinal (count, sum, min, max)  (agg_ord_stats)

Bucket counts are sized to a power of two of at least 16 (``_pow2``), as
the reference's jit cache is. Each pack keeps its columns on the device
(``_dev_col``: the first aggregation over a segment copies them) under
one LRU budget over every pack, DEV_COL_BUDGET_BYTES; ``release`` drops a
segment's columns (an index's delete or close). The match mask stays on
the device it was computed on; a host mask (a sub-aggregation's bucket)
is copied there. Each function returns None when the column has no
device form, and the aggregator then takes its host path.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Any, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import agg_kernel


def _pow2(n: int, floor: int = 16) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


#: the device columns of every pack together: a derived cache, so the
#: least recently added goes first and is copied again at its next use;
#: the registry holds weak references to the packs, so a pack that is
#: dropped frees its columns with it
DEV_COL_BUDGET_BYTES = 1 << 30
_dev_registry: "OrderedDict[int, Tuple[Any, Any, int]]" = OrderedDict()
_dev_lock = threading.Lock()
_dev_total = 0
_dev_seq = 0


def _dev_col(pack, kind: str, field: str, device) -> torch.Tensor:
    """The pack's doc-value column (kind "ord", "i64" or "f64") on
    `device`, cached on the pack and counted against
    DEV_COL_BUDGET_BYTES."""
    global _dev_total, _dev_seq
    device = torch.device(device)
    cache = getattr(pack, "_dev_cols", None)
    if cache is None:
        cache = {}
        pack._dev_cols = cache
    key = (kind, field, str(device))
    arr = cache.get(key)
    if arr is not None:
        return arr
    host = {"ord": pack.dv_ord, "i64": pack.dv_i64,
            "f64": pack.dv_f64}[kind][field]
    arr = torch.as_tensor(host).to(device)
    nbytes = int(host.nbytes)
    with _dev_lock:
        if key in cache:  # a racing copy of the same column
            return cache[key]
        cache[key] = arr
        _dev_seq += 1
        _dev_registry[_dev_seq] = (weakref.ref(pack), key, nbytes)
        _dev_total += nbytes
        while _dev_total > DEV_COL_BUDGET_BYTES and _dev_registry:
            _, (pref, pkey, pbytes) = _dev_registry.popitem(last=False)
            _dev_total -= pbytes
            p = pref()
            if p is not None:
                getattr(p, "_dev_cols", {}).pop(pkey, None)
    return arr


def release(segment) -> None:
    """Drop the device columns of `segment`'s pack (when it has one)."""
    global _dev_total
    pack = getattr(segment, "_pack", None)
    cache = getattr(pack, "_dev_cols", None)
    if not cache:
        return
    with _dev_lock:
        for seq, (pref, pkey, pbytes) in list(_dev_registry.items()):
            if pref() is pack:
                del _dev_registry[seq]
                _dev_total -= pbytes
        cache.clear()


def cached_bytes() -> int:
    """The bytes of every pack's device columns."""
    with _dev_lock:
        return _dev_total


def _mask(mask, device) -> torch.Tensor:
    return torch.as_tensor(mask).to(device)


def _numeric(pack, field: str, device):
    """The field's numeric column on the device, or None."""
    if field in pack.dv_i64:
        return _dev_col(pack, "i64", field, device)
    if field in pack.dv_f64:
        return _dev_col(pack, "f64", field, device)
    return None


def terms_counts(pack, field: str, mask, device) -> Optional[np.ndarray]:
    """Per-ordinal doc counts of a keyword field under `mask` (int64
    [n_terms]), or None when the column has no device form."""
    col = pack.dv_ord.get(field)
    terms = pack.dv_ord_terms.get(field)
    if col is None or not terms:
        return None
    counts = agg_kernel.bucket_counts(
        _mask(mask, device), _dev_col(pack, "ord", field, device), "terms",
        _pow2(len(terms)))
    return counts.cpu().numpy()[: len(terms)]


def histogram_counts(pack, field: str, mask, offset, interval,
                     lo_bucket: int, n_buckets: int, device
                     ) -> Optional[np.ndarray]:
    """Fixed-interval histogram counts: bucket i counts the docs in
    [offset + (lo_bucket + i)·interval, ... + interval); int64
    [n_buckets], or None when the field has no numeric column."""
    col = _numeric(pack, field, device)
    if col is None:
        return None
    base = float(offset) + float(lo_bucket) * float(interval)
    counts = agg_kernel.bucket_counts(
        _mask(mask, device), col, "histogram", _pow2(n_buckets), base=base,
        interval=float(interval))
    return counts.cpu().numpy()[: n_buckets]


def numeric_stats(pack, field: str, mask, device
                  ) -> Optional[Tuple[int, float, float, float]]:
    """(count, sum, min, max) of a numeric column under `mask`, or None
    when the field has no numeric column."""
    col = _numeric(pack, field, device)
    if col is None:
        return None
    cnt, st = agg_kernel.masked_stats(_mask(mask, device), col)
    s, mn, mx = st.cpu().tolist()
    return int(cnt.cpu()[0]), s, mn, mx


def ord_presence(pack, field: str, mask, device) -> Optional[np.ndarray]:
    """bool[n_terms]: the ordinals present under `mask` (the device half
    of a keyword cardinality: the host hashes only the distinct terms
    into the HLL sketch)."""
    col = pack.dv_ord.get(field)
    terms = pack.dv_ord_terms.get(field)
    if col is None or not terms:
        return None
    present = agg_kernel.bucket_counts(
        _mask(mask, device), _dev_col(pack, "ord", field, device),
        "presence", _pow2(len(terms)))
    return present.cpu().numpy()[: len(terms)] > 0


def bounded_bucket_counts(pack, field: str, mask, boundaries: np.ndarray,
                          device) -> Optional[np.ndarray]:
    """Counts per variable-width bucket [boundaries[i], boundaries[i+1])
    (calendar intervals: the host computes the month starts), int64
    [len(boundaries)], or None when the field has no numeric column."""
    col = _numeric(pack, field, device)
    if col is None:
        return None
    n = _pow2(len(boundaries))
    bounds = np.full(n, np.iinfo(np.int64).max, dtype=np.float64)
    bounds[: len(boundaries)] = boundaries
    counts = agg_kernel.bucket_counts(
        _mask(mask, device), col, "bounded", n,
        bounds=torch.from_numpy(bounds).to(col.device))
    return counts.cpu().numpy()[: len(boundaries)]


def terms_numeric_stats(pack, key_field: str, val_field: str, mask, device
                        ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                            np.ndarray, np.ndarray]]:
    """Per ordinal of keyword `key_field`, the (count, sum, min, max) of
    numeric `val_field` under `mask` (a numeric metric under a terms
    aggregation), or None when either column has no device form."""
    ord_col = pack.dv_ord.get(key_field)
    terms = pack.dv_ord_terms.get(key_field)
    if ord_col is None or not terms:
        return None
    vals = _numeric(pack, val_field, device)
    if vals is None:
        return None
    ords = _dev_col(pack, "ord", key_field, device)
    cnt, s, mn, mx = agg_kernel.ord_stats(_mask(mask, device), ords, vals,
                                          _pow2(len(terms)))
    n = len(terms)
    return (cnt.cpu().numpy()[:n], s.cpu().numpy()[:n],
            mn.cpu().numpy()[:n], mx.cpu().numpy()[:n])
