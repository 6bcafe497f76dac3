"""The kNN similarity kernel (B9): counterpart of the reference's
``search/knn.py::_similarity_scores`` and of the scores of
``parallel/distributed.py::_knn_local_body``.

``knn_scores(vectors, queries, kind, ...)`` scores B query vectors
against N document vectors and masks them: f32 [B, N], -inf where a
document is masked. Two formulas:

* ``"segment"`` (the REST ``knn`` section, one segment at a time): the
  reference's three maps, ``l2_norm`` (``d2 = Σ(v − q)²``, raw
  ``−sqrt(d2)``, score ``1 / (1 + d2)``), ``dot_product``
  (``(1 + dot) / 2``) and ``cosine`` (``dot / max(‖v‖·‖q‖, 1e-12)``, then
  ``(1 + cos) / 2``); masked where the raw value is NaN (a missing
  vector), where ``ok`` is false (live docs and the filter), and below
  the ``similarity`` cutoff (raw ≥ s for cosine and dot_product, raw ≥
  −s for l2_norm: shard_candidates' mask);
* ``"mesh"`` (the mesh kNN step): over ``nan_to_num``'d vectors, l2 by
  the expansion ``‖d‖² − 2 d·q + ‖q‖²`` clamped at 0, cosine with
  ``max(‖q‖·‖d‖, 1e-12)``; masked where the first component is NaN or
  ``ok`` is false.

Both sum in XLA:CPU's association (``ops/xla_math.xla_gemv``,
``xla_row_sum``) with its flush of denormals, so the per-segment scores
are the reference's bits. On a CUDA tensor the wrapper launches
``csrc/knn.cu`` (its queries' norms, then the tile or row instance, by
B) or raises; on a CPU tensor it runs ``knn_scores_plain``, which the
tests and ``chip_smoke.py`` hold the kernel against.
``LAUNCHES["knn_scores"]`` counts the calls that launched it.

``knn_topk`` is the top-k after it: ``merge_kernel.shard_topk`` (the IEEE
total order, ties to the lower position), in stages where a row or k is
past what one launch takes: a top-k a slice of the row and then a top-k
of their union, or the top K_LIMIT and then the next from the rest, with
the same result and tie order.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from elasticsearch_tpu_torch.ops import merge_kernel
from elasticsearch_tpu_torch.ops.xla_math import (xla_ftz, xla_gemv,
                                                  xla_mulf, xla_row_sum)
from elasticsearch_tpu_torch.parallel.device import device_context

#: the similarities, in the kernel's order
KINDS = ("l2_norm", "dot_product", "cosine")
FORMULAS = ("segment", "mesh")
#: the widest vector the kernel takes (the mapping's dims limit)
MAX_DIMS = 4096
#: rows of the plain version's temporaries at a time
PLAIN_ROWS = 1 << 18

LAUNCHES: Dict[str, int] = {"knn_scores": 0}
_LAUNCHES_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "es_knn_scores": [_P, ctypes.c_longlong, _I, _P, _I, _P, _I, _I, _I,
                      ctypes.c_float, _P, _P, _P],
    "es_knn_plan": [ctypes.c_longlong, _I, _I, _I, _P],
    "es_knn_blocks_per_sm": [_I],
}
#: csrc/knn.cu's instances (es_knn_plan's first entry)
INSTANCES = ("tile", "row", "row_one_query")


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    from elasticsearch_tpu_torch.ops import _build
    lib = _build.load("knn")
    if not getattr(lib, "_es_typed", False):
        for fn, args in _SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.es_error_string.argtypes = [ctypes.c_int]
        lib.es_error_string.restype = ctypes.c_char_p
        lib._es_typed = True
    return lib


def build() -> None:
    """Build csrc/knn.cu (nvcc, at first use) and load it."""
    _lib()


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (torch's CPU float32 sqrt is not on
    every machine)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _max(x: torch.Tensor, lo: float) -> torch.Tensor:
    """jnp.maximum(x, lo) in float32: a NaN x stays NaN."""
    return torch.where(torch.isnan(x), x, torch.maximum(x, _f32(lo, x)))


def _half_of_one_plus(x: torch.Tensor) -> torch.Tensor:
    """(1 + x) / 2, each op flushed."""
    return xla_ftz(xla_ftz(1.0 + x) / 2.0)


def similarity_scores_plain(vectors: torch.Tensor, queries: torch.Tensor,
                            kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's _similarity_scores for f32 [N, dims] vectors and
    f32 [dims] (→ [N]) or [B, dims] (→ [B, N]) queries → (raw
    similarity, score), in XLA:CPU's bits. NaN rows give NaN."""
    if kind not in KINDS:
        raise ValueError(f"unknown similarity [{kind}]")
    one = queries.dim() == 1
    q = xla_ftz(queries.reshape(-1, queries.shape[-1]).to(torch.float32))
    raw = torch.empty((q.shape[0], vectors.shape[0]), dtype=torch.float32,
                      device=vectors.device)
    score = torch.empty_like(raw)
    qn = _sqrt(xla_row_sum(xla_mulf(q, q))) if kind == "cosine" else None
    for lo in range(0, vectors.shape[0], PLAIN_ROWS):
        v = xla_ftz(vectors[lo: lo + PLAIN_ROWS].to(torch.float32))
        sl = slice(lo, lo + v.shape[0])
        if kind == "l2_norm":
            for b in range(q.shape[0]):
                d = xla_ftz(v - q[b][None, :])
                d2 = xla_row_sum(xla_mulf(d, d))
                raw[b, sl] = -_sqrt(d2)
                score[b, sl] = xla_ftz(1.0 / xla_ftz(1.0 + d2))
            continue
        dot = xla_gemv(v, q)
        if kind == "dot_product":
            raw[:, sl] = dot
        else:
            norms = _sqrt(xla_row_sum(xla_mulf(v, v)))
            den = _max(xla_mulf(norms[None, :], qn[:, None]), 1e-12)
            raw[:, sl] = xla_ftz(dot / den)
        score[:, sl] = _half_of_one_plus(raw[:, sl])
    if one:
        return raw[0], score[0]
    return raw, score


def mesh_scores_plain(vectors: torch.Tensor, queries: torch.Tensor,
                      kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mesh step's scores (distributed.py::_knn_local_body's
    formulas) of f32 [N, dims] vectors against f32 [B, dims] queries →
    (scores [B, N], present bool [N]) in the kernel's bits."""
    if kind not in KINDS:
        raise ValueError(f"unknown similarity [{kind}]")
    q = xla_ftz(queries.to(torch.float32))
    qss = xla_row_sum(xla_mulf(q, q))
    out = torch.empty((q.shape[0], vectors.shape[0]), dtype=torch.float32,
                      device=vectors.device)
    for lo in range(0, vectors.shape[0], PLAIN_ROWS):
        flat = vectors[lo: lo + PLAIN_ROWS].to(torch.float32)
        safe = xla_ftz(torch.nan_to_num(flat))
        sl = slice(lo, lo + flat.shape[0])
        dot = xla_gemv(safe, q)
        if kind == "dot_product":
            out[:, sl] = _half_of_one_plus(dot)
            continue
        dss = xla_row_sum(xla_mulf(safe, safe))
        if kind == "l2_norm":
            d2 = xla_ftz(xla_ftz(dss[None, :] - xla_mulf(2.0, dot))
                         + qss[:, None])
            out[:, sl] = xla_ftz(1.0 / xla_ftz(1.0 + _max(d2, 0.0)))
        else:
            den = _max(xla_mulf(_sqrt(qss)[:, None], _sqrt(dss)[None, :]),
                       1e-12)
            out[:, sl] = _half_of_one_plus(xla_ftz(dot / den))
    return out, ~torch.isnan(vectors[:, 0])


def _threshold(kind: str, similarity: Optional[float]) -> Optional[float]:
    """The raw-value cutoff of `similarity`: the minimum similarity for
    cosine and dot_product, the maximum distance for l2_norm (raw is
    −distance there, so the sign flips)."""
    if similarity is None:
        return None
    return -float(similarity) if kind == "l2_norm" else float(similarity)


def knn_scores_plain(vectors: torch.Tensor, queries: torch.Tensor,
                     kind: str, *, formula: str = "segment",
                     ok: Optional[torch.Tensor] = None,
                     similarity: Optional[float] = None) -> torch.Tensor:
    """knn_scores' function on whatever device the tensors lie: the
    masked scores f32 [B, N], -inf where masked."""
    if formula == "segment":
        raw, score = similarity_scores_plain(vectors, queries, kind)
        keep = ~torch.isnan(raw)
        thr = _threshold(kind, similarity)
        if thr is not None:
            keep &= raw >= _f32(thr, raw)
    elif formula == "mesh":
        score, present = mesh_scores_plain(vectors, queries, kind)
        keep = present[None, :].expand_as(score)
    else:
        raise ValueError(f"unknown formula {formula!r}")
    if ok is not None:
        keep = keep & ok.to(torch.bool)[None, :]
    return torch.where(keep, score, _f32(float("-inf"), score))


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def knn_scores(vectors: torch.Tensor, queries: torch.Tensor, kind: str, *,
               formula: str = "segment", ok: Optional[torch.Tensor] = None,
               similarity: Optional[float] = None,
               stats: Optional[Dict[str, Any]] = None,
               events: Optional[list] = None) -> torch.Tensor:
    """Masked similarity scores f32 [B, N] of `queries` f32 [B, dims]
    against `vectors` f32 [N, dims] (N a multiple of 8): the plain
    version for CPU tensors; for CUDA tensors the kernel launches or the
    call raises. `ok` bool or uint8 [N]; `similarity` the cutoff (segment
    formula only). `stats` receives the launch's shape, instance, tile,
    blocks and blocks per SM; `events` a (kernel, start, end) pair of CUDA
    events."""
    if kind not in KINDS:
        raise ValueError(f"unknown similarity [{kind}]")
    if formula not in FORMULAS:
        raise ValueError(f"unknown formula {formula!r}")
    if formula == "mesh" and similarity is not None:
        raise ValueError("the mesh formula takes no similarity cutoff")
    if vectors.device.type == "cpu":
        return knn_scores_plain(vectors, queries, kind, formula=formula,
                                ok=ok, similarity=similarity)
    if vectors.device.type != "cuda":
        raise ValueError(f"knn_scores runs on cuda or cpu tensors, got "
                         f"{vectors.device}")
    with device_context(vectors.device):
        return _launch(vectors, queries, kind, formula, ok, similarity,
                       stats, events)


def _launch(vectors, queries, kind, formula, ok, similarity, stats,
            events) -> torch.Tensor:
    dev = vectors.device
    if vectors.dim() != 2 or queries.dim() != 2:
        raise ValueError(f"knn_scores takes [N, dims] vectors and [B, dims] "
                         f"queries, got {tuple(vectors.shape)} and "
                         f"{tuple(queries.shape)}")
    n, dims = vectors.shape
    b = queries.shape[0]
    merge_kernel._need(vectors, "vectors", torch.float32, dev)
    merge_kernel._need(queries, "queries", torch.float32, dev, (b, dims))
    if n % 8:
        raise ValueError(f"knn_scores takes a multiple of 8 vectors (the "
                         f"reference's gemv order holds for those), got {n}")
    if not 1 <= dims <= MAX_DIMS:
        raise ValueError(f"knn_scores takes 1 to {MAX_DIMS} dims, got {dims}")
    if ok is not None:
        if ok.dtype == torch.bool:
            ok = ok.view(torch.uint8)
        merge_kernel._need(ok, "ok", torch.uint8, dev, (n,))
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    mesh = formula == "mesh"
    # scratch for the queries' sums of squares, made once a launch
    qss = torch.empty(b, dtype=torch.float32, device=dev)
    thr = _threshold(kind, similarity)
    lib = _lib()
    if events is not None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    err = lib.es_knn_scores(
        vectors.data_ptr(), n, dims, queries.data_ptr(), b,
        None if ok is None else ok.data_ptr(), KINDS.index(kind), int(mesh),
        int(thr is not None), 0.0 if thr is None else thr,
        qss.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if events is not None:
        end.record()
        events.append(("knn_scores", start, end))
    if err != 0:
        msg = lib.es_error_string(err).decode(errors="replace")
        raise RuntimeError(f"knn_scores launch failed: cudaError {err} "
                           f"({msg})")
    with _LAUNCHES_LOCK:
        LAUNCHES["knn_scores"] += 1
    if stats is not None:
        plan = (ctypes.c_longlong * 6)()
        lib.es_knn_plan(n, b, KINDS.index(kind), int(mesh), plan)
        inst, tile_docs, tile_queries, smem, tiles, blocks = plan
        stats.update(rows=n, queries=b, dims=dims,
                     instance=INSTANCES[inst],
                     tile={"documents": tile_docs, "queries": tile_queries},
                     tiles=tiles, blocks=blocks, shared_memory_bytes=smem,
                     blocks_per_sm=lib.es_knn_blocks_per_sm(inst))
    return out


# ---------------------------------------------------------------------------
# the top-k after it
# ---------------------------------------------------------------------------

def _row_cap(kk: int) -> int:
    """The widest row one shard_topk launch takes at kernel k kk: below
    TOPK_ROW_LIMIT, or, past TOPK_SORT_CAP finalists (the device class),
    its 1,024 slices."""
    if kk <= merge_kernel.TOPK_SORT_CAP:
        return merge_kernel.TOPK_ROW_LIMIT - 1
    return merge_kernel.TOPK_SLICE * 1024


def knn_topk(vals: torch.Tensor, k: int, **kw
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """lax.top_k over [B, N] (the min(k, N) largest by the IEEE total
    order, ties to the lower position) through shard_topk, in stages
    where one launch cannot take k (past merge_kernel.K_LIMIT) or the row
    (past _row_cap). `kw` goes to each shard_topk call (stats, events)."""
    b, n = vals.shape
    kk = min(k, n)
    k_cap = merge_kernel.K_LIMIT
    if kk > k_cap:
        # the top k_cap, then the next k_cap of the rest, ...: each stage
        # keeps the rest's positions in order, so ties stay in position
        # order across stages
        pos_all = torch.arange(n, device=vals.device).expand(b, n)
        rest_v, rest_p = vals, pos_all
        out_v, out_p = [], []
        left = kk
        while left > 0:
            step = min(k_cap, left)
            v, p = knn_topk(rest_v, step, **kw)
            out_v.append(v)
            out_p.append(torch.gather(rest_p, 1, p))
            left -= step
            if left:
                keep = torch.ones_like(rest_v, dtype=torch.bool)
                keep.scatter_(1, p, False)
                width = rest_v.shape[1] - step
                rest_v = rest_v[keep].view(b, width)
                rest_p = rest_p[keep].view(b, width)
        return torch.cat(out_v, dim=1), torch.cat(out_p, dim=1)
    cap = _row_cap(kk)
    if n <= cap:
        return merge_kernel.shard_topk(vals.contiguous(), kk, **kw)
    if cap < 2 * kk:
        raise ValueError(f"knn_topk's slices of {cap} values cannot take "
                         f"k {kk}")
    # a top-k a slice of the row, then a top-k of their union: the union
    # holds the slices in order and each slice's list in rank order, so
    # equal values stay in position order
    parts_v, parts_p = [], []
    for lo in range(0, n, cap):
        v, p = knn_topk(vals[:, lo: lo + cap].contiguous(), kk, **kw)
        parts_v.append(v)
        parts_p.append(p + lo)
    union_v = torch.cat(parts_v, dim=1)
    union_p = torch.cat(parts_p, dim=1)
    v, p = knn_topk(union_v, kk, **kw)
    return v, torch.gather(union_p, 1, p)
