"""The Hopper merge kernel: counterpart of the reference's
``ops/pallas_merge.py::fused_merge_topk``.

``fused_merge_topk`` computes ``sorted_merge_topk(variant="compressed")``
on the compressed resident streams. On a CUDA tensor it launches the five
kernels of ``csrc/merge_topk.cu`` (slot decode, row pack, row sort, run
sum, select + rescore) on the current stream, or raises. On a CPU tensor
it runs ``fused_merge_topk_plain``, the plain torch pipeline of
``ops/sparse.py``, which is also what the tests and ``chip_smoke.py`` hold
the kernel against.

Two more kernels of the same source serve the main path around the
merge. ``shard_topk`` is the cross-shard top-k after the all-gather (the
reference's ``_merge_topk`` → ``hierarchical_top_k``); ``sparse.
hierarchical_top_k`` calls it on a CUDA tensor. ``exact_merge_topk`` is
``sorted_merge_topk(variant="compressed_exact")``, for weights that fail
``packable()``: the ``exact_merge`` kernel (decode, a stable merge of
the slots' sorted doc runs, run sums, msm filter, totals) and then
``shard_topk`` over its candidates. Each has its plain version beside
it (``shard_topk_plain``, ``exact_merge_topk_plain``), taken for a CPU
tensor only.

``LAUNCHES`` counts the launches of each kernel (a plain integer per
kernel name, bumped where the kernel is launched and nowhere else). The
row sort takes both key sets of a train in one launch; a call of
``shard_topk`` (its device class runs nine CUDA kernels in turn) or of
``exact_merge`` (two) is one launch of its C entry. Every launch runs
under ``torch.cuda.device`` of its tensors: the C entries launch on the
host thread's current device and set their shared-memory attribute
there.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import sparse
from elasticsearch_tpu_torch.parallel.device import device_context

NEG_INF = sparse.NEG_INF

#: kernel name → launches since the last reset (see reset_launches)
LAUNCHES: Dict[str, int] = {"slot_decode": 0, "row_pack": 0, "row_sort": 0,
                            "run_sum": 0, "select_rescore": 0,
                            "shard_topk": 0, "exact_merge": 0,
                            "raw_merge": 0, "pruned_candidates": 0,
                            "pruned_rescore": 0,
                            # of pruned_candidates' launches, those in
                            # its u32-key mode (pack_keys)
                            "pruned_candidates.pack_keys": 0}
_LAUNCHES_LOCK = threading.Lock()  # batcher threads of several packs launch

#: widest slot window the slot-decode kernel keeps in shared memory
MAX_LEN_LIMIT = 4096
#: largest kernel k (from + size 10,000 buckets to 16,384): the select
#: kernel sorts its kk finalists, 8 B each, in shared memory
K_LIMIT = 16384
#: slots per row the per-row kernels hold in shared memory
T_LIMIT = 1024
#: the select kernel's dynamic shared memory below the finalists' need
SELECT_BASE_SMEM = 32768
#: size classes the row pack, row sort, run sum and select kernels report
#: per row, and the slot decode per slot (the order of the kernels' class
#: counters): slot_decode.bounds for a slot shorter than kernel k (group
#: bounds only); one that also selects its k-th lane bound does so in a
#: warp (slot_decode.select_warp, up to es_slot_warp_lanes() lanes) or in
#: a block (slot_decode.select_block)
SIZE_CLASSES = ("row_sort.shared", "row_sort.device", "select.none",
                "select.shared", "select.device", "rescore.staged",
                "rescore.restaged", "final.all", "final.trim",
                "row_pack.single", "row_pack.split", "run_sum.one_tile",
                "run_sum.tiled", "slot_decode.bounds",
                "slot_decode.select_warp", "slot_decode.select_block")

#: finalists the shard top-k sorts in one block's shared memory (8 B
#: each); a row with more takes the device class
TOPK_SORT_CAP = 8192
#: values a shard top-k row may hold (the key keeps 24 position bits)
TOPK_ROW_LIMIT = 1 << 24
#: values of a row the shard top-k stages in shared memory (4 B each) to
#: run its select there
TOPK_STAGE_CAP = 16384
#: values of a device-class row each block of its select and of its
#: sorted runs takes
TOPK_SLICE = 4096
#: the size classes of shard_topk (rows per class): the select over the
#: row staged in shared memory, or none (no more values than k) or over
#: device memory, the finalists sorted in shared memory; or more
#: finalists than TOPK_SORT_CAP: a select over several blocks a row,
#: sorted runs, a rank merge
TOPK_CLASSES = ("shard_topk.staged", "shard_topk.shared",
                "shard_topk.device")
#: the most lanes an exact-merge window holds (16 B of shared memory
#: each); the launch's window is the longest row rounded up to 1024 lanes,
#: at most this
EXACT_WINDOW_CAP = 2048
#: slots per row the raw merge takes (its block's slot table, four
#: slots a thread): 1024 slots of CHUNK_CAP lanes, 4M postings a row
RAW_T_LIMIT = 1024
#: the size classes of exact_merge (rows per class): merged in one
#: window, in several parts by doc (a row of more lanes than the window:
#: a block a part), or (a slot whose docs descend) radix-sorted in
#: device memory
EXACT_CLASSES = ("exact.merge", "exact.parts", "exact.radix")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_STREAM_ARGS = [_P, _P, _P, _P, _L, _P, _L, _P, _L]
_SLOT_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I]
_SIGNATURES = {
    "es_slot_decode": _STREAM_ARGS + _SLOT_ARGS + [_P, _L, _P, _I, _P, _I,
                                                   _I, _P, _P, _P, _P, _P],
    "es_row_pack": _STREAM_ARGS + _SLOT_ARGS + [_I, _I, _I, _P, _P, _P, _P,
                                                _P, _P, _I, _P, _P, _P, _P,
                                                _P, _P],
    "es_row_sort": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P],
    "es_run_sum": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _P, _P, _P,
                   _P, _P, _P, _P, _P],
    "es_tile": [],
    "es_slot_warp_lanes": [],
    "es_select_rescore": _STREAM_ARGS + _SLOT_ARGS + [_P, _P, _P, _P, _P,
                                                      _I, _I, _I, _P, _P,
                                                      _P, _P, _P, _P],
    "es_shard_topk": [_P, _L, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                      _P, _P, _P, _P, _P, _I, _P, _P, _P],
    "es_topk_row_bytes": [],
    "es_topk_smem": [_I, _I, _I, _I, _I, _I, _I],
    "es_topk_max_runs": [],
    "es_exact_merge": _STREAM_ARGS + _SLOT_ARGS + [_P, _P, _P, _I, _I, _I,
                                                   _I, _P, _P, _P, _P, _P,
                                                   _P, _P, _P, _P, _P],
    "es_exact_smem_bytes": [_I, _I],
    "es_raw_merge": [_P, _P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                     _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P, _P],
    "es_pruned_candidates": [_P, _P, _L, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _L, _P, _I, _I, _I, _I, _I, _I, _P,
                             _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "es_cand_smem_bytes": [_I, _I, _I, _I, _I, _I],
    "es_rescore_order_smem_bytes": [_I],
    "es_pruned_rescore": [_P, _P, _L, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                          _L, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P],
    "es_blocks_per_sm": [_I, _I],
}


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    from elasticsearch_tpu_torch.ops import _build
    lib = _build.load("merge_topk")
    if not getattr(lib, "_es_typed", False):
        for fn, args in _SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.es_error_string.argtypes = [ctypes.c_int]
        lib.es_error_string.restype = ctypes.c_char_p
        lib._es_typed = True
    return lib


def tile_lanes() -> int:
    """Lanes of one row_pack or run_sum block (a row's keys are at most
    its lanes): a longer row spans several blocks."""
    return _lib().es_tile()


def slot_warp_lanes() -> int:
    """Longest slot in which one warp of the slot decode selects its k-th
    lane bound; a longer slot takes a block."""
    return _lib().es_slot_warp_lanes()


def _run(lib, kernel: str, events: Optional[list], fn, *args) -> None:
    """Launch one kernel through its C entry, raise on a non-zero
    cudaError_t, count the launch. With `events`, bracket the launch
    with CUDA events on the current stream: (kernel, start, end)."""
    if events is not None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    err = fn(*args)
    if events is not None:
        end.record()
        events.append((kernel, start, end))
    if err != 0:
        msg = lib.es_error_string(err).decode(errors="replace")
        raise RuntimeError(f"merge kernel {kernel} launch failed: "
                           f"cudaError {err} ({msg})")
    with _LAUNCHES_LOCK:
        LAUNCHES[kernel] += 1


#: the kernels es_blocks_per_sm knows, by its index
OCCUPANCY_KERNELS = ("exact_merge", "shard_topk", "topk_pass", "topk_runs",
                     "topk_merge", "exact_finish", "cand_part", "cand_band",
                     "rescore_score", "rescore_order")
#: the CUDA kernels a shard_topk launch runs (the last three: the device
#: class)
TOPK_KERNELS = OCCUPANCY_KERNELS[1:5]


def blocks_per_sm(kernel: str, smem: int) -> int:
    """Blocks of `kernel` (one of OCCUPANCY_KERNELS) resident on one SM
    of the current device at `smem` bytes of dynamic shared memory (the
    CUDA occupancy calculator)."""
    return _lib().es_blocks_per_sm(OCCUPANCY_KERNELS.index(kernel), smem)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _need(t: Optional[torch.Tensor], name: str, dtype: torch.dtype,
          device: torch.device, shape=None) -> None:
    if t is None:
        raise ValueError(f"merge kernel needs {name}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _check_operands(what, flat_docs, flat_impact, starts, lengths, weights,
                    min_count, *, max_len, d_pad, k, t_window, flat_rank,
                    res_starts, res_lens, res_vals, doc_bases, dbs_starts,
                    dlo_starts):
    """The checks every merge launch makes of the compressed streams and
    the slot operands (device, type, shape, contiguity, the kernels'
    limits) → (R, T, delta); raises ValueError naming `what`."""
    dev = flat_docs.device
    r, t = starts.shape
    if d_pad >= sparse.PACKED_DOC_LIMIT:
        raise ValueError(f"{what} needs d_pad < "
                         f"{sparse.PACKED_DOC_LIMIT}, got {d_pad}")
    if not 1 <= max_len <= MAX_LEN_LIMIT:
        raise ValueError(f"{what} takes max_len ≤ {MAX_LEN_LIMIT}, got "
                         f"{max_len}")
    if not 1 <= t <= T_LIMIT or not 1 <= r < 65536:
        raise ValueError(f"{what} takes 1 ≤ T ≤ {T_LIMIT} slots and "
                         f"R < 65536 rows, got R={r}, T={t}")
    if t_window > T_LIMIT:  # the run trees hold runs of ≤ 1024 lanes
        raise ValueError(f"{what} takes t_window ≤ {T_LIMIT}, got "
                         f"{t_window}")
    if k > K_LIMIT:
        raise ValueError(f"{what} takes k ≤ {K_LIMIT}, got {k}")
    delta = doc_bases is not None
    if delta and (dbs_starts is None or dlo_starts is None):
        raise ValueError("delta doc stream needs dbs_starts/dlo_starts")
    _need(flat_docs, "flat_docs", torch.uint8 if delta else torch.uint16,
          dev)
    n_post = flat_docs.shape[0]
    if n_post < max_len:
        raise ValueError(f"streams hold {n_post} postings, fewer than one "
                         f"{max_len}-lane window")
    _need(flat_impact, "flat_impact", torch.uint16, dev, (n_post,))
    _need(flat_rank, "flat_rank", torch.uint16, dev, (n_post,))
    _need(res_vals, "res_vals", torch.float32, dev)
    for name, ten in (("starts", starts), ("lengths", lengths),
                      ("res_starts", res_starts), ("res_lens", res_lens)):
        _need(ten, name, torch.int32, dev, (r, t))
    _need(weights, "weights", torch.float32, dev, (r, t))
    _need(min_count, "min_count", torch.int32, dev, (r,))
    if delta:
        _need(doc_bases, "doc_bases", torch.uint16, dev)
        if doc_bases.shape[0] < max_len // sparse.COMPRESSED_BLOCK + 2:
            raise ValueError("doc_bases is shorter than one slot's bases")
        _need(dbs_starts, "dbs_starts", torch.int32, dev, (r, t))
        _need(dlo_starts, "dlo_starts", torch.int32, dev, (r, t))
    return r, t, delta


def _check_raw_operands(flat_docs, flat_impact, starts, lengths, weights,
                        min_count, *, max_len, d_pad, k, t_window):
    """The raw merge's checks of a raw pack's streams and the slot
    operands → (R, T); raises ValueError. Its only slot limit is the
    rows' part count (a row is cut into parts of a window each, at most
    32,767): the reference's exact launch has no slot cap."""
    dev = flat_docs.device
    r, t = starts.shape
    n_post = _raw_streams(flat_docs, flat_impact, dev)
    if not 1 <= max_len <= MAX_LEN_LIMIT or n_post < max_len:
        raise ValueError(f"raw merge takes windows of 1...{MAX_LEN_LIMIT} "
                         f"lanes inside the streams, got {max_len} over "
                         f"{n_post} postings")
    if not 1 <= t <= RAW_T_LIMIT or not 1 <= r < 65536:
        raise ValueError(f"raw merge takes 1 ≤ T ≤ {RAW_T_LIMIT} slots "
                         f"and R < 65536 rows, got R={r}, T={t}")
    if t_window > T_LIMIT:
        raise ValueError(f"raw merge takes t_window ≤ {T_LIMIT}, got "
                         f"{t_window}")
    if k > K_LIMIT or d_pad >= 1 << 31:
        raise ValueError(f"raw merge takes k ≤ {K_LIMIT} and d_pad < 2**31")
    for name, ten in (("starts", starts), ("lengths", lengths)):
        _need(ten, name, torch.int32, dev, (r, t))
    _need(weights, "weights", torch.float32, dev, (r, t))
    _need(min_count, "min_count", torch.int32, dev, (r,))
    return r, t


def _stream_slot_args(flat_docs, flat_impact, starts, lengths, weights,
                      min_count, *, max_len, d_pad, flat_rank, res_starts,
                      res_lens, res_vals, doc_bases, dbs_starts, dlo_starts):
    """The C entries' Streams and Slots arguments, in order."""
    delta = doc_bases is not None
    r, t = starts.shape
    streams = (_ptr(flat_docs) if delta else None,
               None if delta else _ptr(flat_docs),
               _ptr(flat_impact), _ptr(flat_rank), flat_docs.shape[0],
               _ptr(doc_bases), doc_bases.shape[0] if delta else 0,
               _ptr(res_vals), res_vals.shape[0])
    slots = (_ptr(starts), _ptr(lengths), _ptr(weights), _ptr(min_count),
             _ptr(res_starts), _ptr(res_lens), _ptr(dbs_starts),
             _ptr(dlo_starts), r, t, max_len, d_pad)
    return streams, slots


def fused_merge_topk_plain(flat_docs, flat_impact, starts, lengths, weights,
                           min_count, **kw) -> Tuple[torch.Tensor, ...]:
    """The plain torch version of the kernel (ops/sparse.merge_topk_core
    with variant="compressed"), on whatever device the operands lie."""
    kw.pop("stats", None)
    kw.pop("events", None)
    return sparse.merge_topk_core(flat_docs, flat_impact, starts, lengths,
                                  weights, min_count, variant="compressed",
                                  **kw)


def slot_decode_plain(flat_docs, flat_impact, starts, lengths, weights,
                      min_count, *, max_len, d_pad, k, block_max, blk_starts,
                      doc_bases=None, dbs_starts=None, dlo_starts=None,
                      **_) -> Tuple[torch.Tensor, ...]:
    """The slot decode's outputs by the plain stages of ops/sparse.py, on
    whatever device the operands lie (fused_merge_topk's operands and
    keywords; the block-max skip on) → (kth f32[R, T]: each slot's kk-th
    largest lane lower bound, −inf where len < kk; grp_ub f32[R, T, G];
    slot_ub f32[R, T])."""
    kk = min(k, starts.shape[1] * max_len)
    _, imp = sparse._lane_decode(
        flat_docs, flat_impact, starts, lengths, weights, max_len=max_len,
        d_pad=d_pad, exact=False, doc_bases=doc_bases,
        dbs_starts=dbs_starts, dlo_starts=dlo_starts)
    grp_ub, slot_ub = sparse.group_bounds(lengths, weights, block_max,
                                          blk_starts, max_len=max_len)
    return sparse.slot_kth(imp, lengths, kk), grp_ub, slot_ub


def slot_decode_mismatches(got: Dict[str, torch.Tensor],
                           want: Tuple[torch.Tensor, ...]) -> list:
    """The names of the slot decode's outputs (``stats
    ["slot_decode_output"]``) that differ from slot_decode_plain's in
    any bit."""
    return [name for name, w in zip(("kth", "grp_ub", "slot_ub"), want)
            if not torch.equal(got[name].view(torch.int32),
                               w.to(got[name].device).view(torch.int32))]


def fused_merge_topk(
    flat_docs: torch.Tensor,
    flat_impact: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    weights: torch.Tensor,
    min_count: torch.Tensor,
    *,
    max_len: int,
    d_pad: int,
    k: int,
    t_window: int,
    with_counts: bool,
    with_totals: bool = False,
    flat_rank: Optional[torch.Tensor] = None,
    res_starts: Optional[torch.Tensor] = None,
    res_lens: Optional[torch.Tensor] = None,
    res_vals: Optional[torch.Tensor] = None,
    block_max: Optional[torch.Tensor] = None,
    blk_starts: Optional[torch.Tensor] = None,
    slot_terms: Optional[torch.Tensor] = None,
    doc_bases: Optional[torch.Tensor] = None,
    dbs_starts: Optional[torch.Tensor] = None,
    dlo_starts: Optional[torch.Tensor] = None,
    stats: Optional[Dict[str, int]] = None,
    events: Optional[list] = None,
) -> Tuple[torch.Tensor, ...]:
    """sorted_merge_topk(variant="compressed") → (scores f32[R, k'],
    docs int32[R, k'][, totals int32[R]]). CPU operands run the plain
    version; CUDA operands launch the kernels or raise. `stats`, when
    given, receives the launch's lane, key and candidate counts (a host
    sync), under "classes" the rows each size class of the row pack, row
    sort, run sum and select kernels took (the slots, for the slot
    decode's), under "slot_decode_output" copies of the slot decode's
    kth, grp_ub and slot_ub, under "sort_input" of the row sort's
    unsorted keys and under "run_sum_output" of the run sum's candidates
    and totals; `events` receives (kernel, start, end) CUDA events."""
    kw = dict(max_len=max_len, d_pad=d_pad, k=k, t_window=t_window,
              with_counts=with_counts, with_totals=with_totals,
              flat_rank=flat_rank, res_starts=res_starts, res_lens=res_lens,
              res_vals=res_vals, block_max=block_max, blk_starts=blk_starts,
              slot_terms=slot_terms, doc_bases=doc_bases,
              dbs_starts=dbs_starts, dlo_starts=dlo_starts)
    if flat_docs.device.type == "cpu":
        return fused_merge_topk_plain(flat_docs, flat_impact, starts,
                                      lengths, weights, min_count, **kw)
    if flat_docs.device.type != "cuda":
        raise ValueError(f"merge kernel runs on cuda or cpu tensors, got "
                         f"{flat_docs.device}")
    with device_context(flat_docs.device):
        return _launch(flat_docs, flat_impact, starts, lengths, weights,
                       min_count, stats=stats, events=events, **kw)


def _launch(flat_docs, flat_impact, starts, lengths, weights, min_count, *,
            max_len, d_pad, k, t_window, with_counts, with_totals,
            flat_rank, res_starts, res_lens, res_vals, block_max,
            blk_starts, slot_terms, doc_bases, dbs_starts, dlo_starts,
            stats, events) -> Tuple[torch.Tensor, ...]:
    dev = flat_docs.device
    r, t, delta = _check_operands(
        "merge kernel", flat_docs, flat_impact, starts, lengths, weights,
        min_count, max_len=max_len, d_pad=d_pad, k=k, t_window=t_window,
        flat_rank=flat_rank, res_starts=res_starts, res_lens=res_lens,
        res_vals=res_vals, doc_bases=doc_bases, dbs_starts=dbs_starts,
        dlo_starts=dlo_starts)
    kk = min(k, t * max_len)
    do_skip = block_max is not None and blk_starts is not None \
        and k <= max_len
    n_grp = (max_len + sparse.COMPRESSED_BLOCK - 1) // sparse.COMPRESSED_BLOCK
    if do_skip:
        _need(block_max, "block_max", torch.uint16, dev)
        _need(blk_starts, "blk_starts", torch.int32, dev, (r, t))
        if block_max.shape[0] < n_grp + 1:
            raise ValueError("block_max is shorter than one slot's groups")
        if slot_terms is not None:
            _need(slot_terms, "slot_terms", torch.int32, dev, (r, t))
    length = t * max_len
    kc = min(length, kk + max(2 * kk, 256))
    final_n = 1
    while final_n < kk:
        final_n *= 2
    select_smem = max(SELECT_BASE_SMEM, 8 * final_n)
    window = 1
    while window < t_window:
        window *= 2

    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    i32 = dict(dtype=torch.int32, device=dev)
    # compacted key storage: each row gets room for its valid lanes. The
    # blocks of the row pack and the run sum: each row's lanes in tiles of
    # es_tile(); block r < R takes row r's first tile, block R + e the
    # e-th further tile (offs[0] = rows' first keys, offs[1] = rows' first
    # further tiles, tile_rq = each further tile's row | tile << 16)
    row_cap = lengths.clamp(min=0).sum(dim=1, dtype=torch.int64)
    offs = torch.zeros((2, r + 1), dtype=torch.int64, device=dev)
    torch.cumsum(row_cap, dim=0, out=offs[0, 1:])
    torch.cumsum(((row_cap - 1).clamp(min=0) // lib.es_tile()), dim=0,
                 out=offs[1, 1:])
    row_off, extra_off = offs[0, :r], offs[1]
    # the slots the slot decode selects in (len ≥ kk), a block each past
    # es_slot_warp_lanes() lanes ("long"), else a warp ("short"): their
    # counts come with the same sync, their lists are built on the device
    counts = [offs[:, r], lengths.max().to(torch.int64).view(1)]
    if do_skip:
        flat_len = lengths.view(-1)
        long_slot = (flat_len >= kk) & (flat_len > slot_warp_lanes())
        selects = [torch.cumsum(long_slot, dim=0),
                   torch.cumsum((flat_len >= kk) & ~long_slot, dim=0)]
        counts += [c[-1:] for c in selects]
    total_cap, n_extra, longest, *n_sel = torch.cat(counts).tolist()
    n_long, n_short = n_sel if do_skip else (0, 0)
    if longest > max_len:
        raise ValueError(f"a slot holds {longest} lanes, more than "
                         f"max_len={max_len}")
    n_tiles = r + n_extra
    extra = torch.arange(max(n_extra, 1), device=dev)
    extra_row = torch.searchsorted(extra_off, extra, right=True) - 1
    tile_rq = (extra_row | ((extra - extra_off[extra_row] + 1) << 16)).to(
        torch.int32)
    total_cap = max(1, total_cap)
    keys = torch.empty(total_cap, **i32)
    alt = torch.empty(total_cap, **i32)
    # zeroed: the row pack's key counts (its blocks append with atomics)
    # and the run sum's look-back status, one u64 a tile
    zeroed = torch.zeros(2 * r + 2 * n_tiles, **i32)
    counts = zeroed[:2 * r].view(2, r)
    status = zeroed[2 * r:].view(torch.int64)
    n_keys = counts[0]
    need_count = do_skip and with_totals
    ckeys = torch.empty(total_cap, **i32) if need_count else None
    n_ckeys = counts[1] if need_count else None
    cand_score = torch.empty(total_cap, dtype=torch.float32, device=dev)
    cand_doc = torch.empty(total_cap, **i32)
    cand_cnt = torch.empty(total_cap, **i32)
    n_cand = torch.empty(r, **i32)
    totals = torch.empty(r, **i32)
    out_vals = torch.empty((r, kk), dtype=torch.float32, device=dev)
    out_docs = torch.empty((r, kk), **i32)
    class_rows = (torch.zeros(len(SIZE_CLASSES), **i32)
                  if stats is not None else None)

    streams, slots = _stream_slot_args(
        flat_docs, flat_impact, starts, lengths, weights, min_count,
        max_len=max_len, d_pad=d_pad, flat_rank=flat_rank,
        res_starts=res_starts, res_lens=res_lens, res_vals=res_vals,
        doc_bases=doc_bases, dbs_starts=dbs_starts, dlo_starts=dlo_starts)
    kth = grp_ub = slot_ub = None
    if do_skip:
        kth = torch.empty((r, t), dtype=torch.float32, device=dev)
        grp_ub = torch.empty((r, t, n_grp), dtype=torch.float32, device=dev)
        slot_ub = torch.empty((r, t), dtype=torch.float32, device=dev)
        # the long slots' list, then the short slots'
        sel = torch.cat([torch.searchsorted(
            c, torch.arange(1, n + 1, device=dev))
            for c, n in zip(selects, (n_long, n_short))]).to(torch.int32)
        _run(lib, "slot_decode", events, lib.es_slot_decode,
             *streams, *slots, _ptr(block_max), block_max.shape[0],
             _ptr(blk_starts), kk, _ptr(sel), n_long, n_short, _ptr(kth),
             _ptr(grp_ub), _ptr(slot_ub), _ptr(class_rows), stream)
        if stats is not None:
            stats["slot_decode_output"] = dict(
                kth=kth.clone(), grp_ub=grp_ub.clone(),
                slot_ub=slot_ub.clone())
    _run(lib, "row_pack", events, lib.es_row_pack,
         *streams, *slots, int(do_skip), int(with_counts), kk,
         _ptr(slot_terms) if do_skip else None, _ptr(kth), _ptr(grp_ub),
         _ptr(slot_ub), _ptr(row_off), _ptr(tile_rq), n_tiles, _ptr(keys),
         _ptr(n_keys), _ptr(ckeys), _ptr(n_ckeys), _ptr(class_rows), stream)
    if stats is not None:
        stats["sort_input"] = dict(
            keys=keys.clone(), n_keys=n_keys.clone(), row_off=row_off,
            count_keys=ckeys.clone() if need_count else None,
            n_count_keys=n_ckeys.clone() if need_count else None)
    # one launch for both key sets; the count keys' scratch is cand_score,
    # which run_sum writes only after the sort
    _run(lib, "row_sort", events, lib.es_row_sort, _ptr(keys), _ptr(alt),
         _ptr(n_keys), _ptr(ckeys), _ptr(cand_score) if need_count else None,
         _ptr(n_ckeys), _ptr(row_off), r, _ptr(class_rows), stream)
    _run(lib, "run_sum", events, lib.es_run_sum,
         _ptr(keys), _ptr(n_keys), _ptr(ckeys), _ptr(n_ckeys), _ptr(row_off),
         _ptr(tile_rq), r, n_tiles, _ptr(min_count), int(with_counts),
         window, _ptr(status), _ptr(cand_score),
         _ptr(cand_doc), _ptr(cand_cnt), _ptr(n_cand), _ptr(totals),
         _ptr(class_rows), stream)
    if stats is not None:
        stats["run_sum_output"] = dict(
            score=cand_score.clone(), doc=cand_doc.clone(),
            count=cand_cnt.clone(), n_cand=n_cand.clone(),
            totals=totals.clone())
    # the keys and their sort scratch are spent: the select kernel keeps
    # its candidate list and rescored keys in them
    _run(lib, "select_rescore", events, lib.es_select_rescore,
         *streams, *slots, _ptr(cand_score), _ptr(cand_doc), _ptr(cand_cnt),
         _ptr(n_cand), _ptr(row_off), kc, kk, select_smem, _ptr(keys),
         _ptr(alt), _ptr(out_vals), _ptr(out_docs), _ptr(class_rows),
         stream)
    if stats is not None:
        kth_lanes = (lengths * (lengths >= kk)).sum() if do_skip else 0
        stats.update(lanes=int(row_cap.sum()), kth_lanes=int(kth_lanes),
                     keys=int(n_keys.sum()),
                     count_keys=int(n_ckeys.sum()) if need_count else 0,
                     candidates=int(n_cand.sum()),
                     picked=int(n_cand.clamp(max=kc).sum()),
                     select_slots=n_long + n_short, rows=r, slots=t,
                     n_grp=n_grp,
                     kk=kk, kc=kc,
                     delta=int(delta), do_skip=int(do_skip),
                     classes=dict(zip(SIZE_CLASSES, class_rows.tolist())))
    if with_totals:
        return out_vals, out_docs, totals
    return out_vals, out_docs


# ---------------------------------------------------------------------------
# shard_topk: the cross-shard top-k
# ---------------------------------------------------------------------------

#: the plain version: lax.top_k over [B, N] f32 (the min(k, N) largest
#: values, equal values in ascending position) as a stable descending
#: sort, on whatever device the tensor lies → (values [B, k'], positions
#: int64 [B, k'])
shard_topk_plain = sparse.top_k_plain


def shard_topk(vals: torch.Tensor, k: int, *,
               stats: Optional[Dict[str, Any]] = None,
               events: Optional[list] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """shard_topk_plain's function: the plain version for a CPU tensor;
    for a CUDA tensor the kernel launches or the call raises. `stats`
    receives the rows each size class took; `events` (kernel, start,
    end) CUDA events."""
    if vals.device.type == "cpu":
        return shard_topk_plain(vals, k)
    if vals.device.type != "cuda":
        raise ValueError(f"shard_topk runs on cuda or cpu tensors, got "
                         f"{vals.device}")
    with device_context(vals.device):
        return _launch_topk(vals, k, stats=stats, events=events)


def _launch_topk(vals, k, *, stats, events):
    dev = vals.device
    if vals.dim() != 2:
        raise ValueError(f"shard_topk takes [B, N] values, got "
                         f"{tuple(vals.shape)}")
    _need(vals, "vals", torch.float32, dev)
    b, n = vals.shape
    if n >= TOPK_ROW_LIMIT:
        raise ValueError(f"shard_topk takes rows of < {TOPK_ROW_LIMIT} "
                         f"values, got {n}")
    kk = min(k, n)
    out_vals = torch.empty((b, max(kk, 0)), dtype=torch.float32,
                           device=dev)
    out_pos = torch.empty((b, max(kk, 0)), dtype=torch.int64, device=dev)
    if b and kk > 0:
        _topk_rows(_lib(), vals, b, kk, stride=n, row_off=None, row_n=None,
                   n_all=n, n_max=n, out_vals=out_vals, out_pos=out_pos,
                   ids=None, fill=0, out_ids=None, stats=stats,
                   events=events)
    return out_vals, out_pos


def _topk_rows(lib, vals, rows, kk, *, stride, row_off, row_n, n_all,
               n_max, out_vals, out_pos, ids, fill, out_ids, stats, events):
    """One shard_topk launch over `rows` rows of `vals` (row r at
    row_off[r], or r * stride; row_n[r] values, or n_all; n_max at most).
    When a row may hold more finalists than TOPK_SORT_CAP the launch also
    runs the device class's kernels, over the scratch made here."""
    dev = vals.device
    count = min(n_max, kk)
    sort_n = 1
    while sort_n < count:
        sort_n *= 2
    device = sort_n > TOPK_SORT_CAP
    slices = 1
    scratch = [None] * 4    # row states, histograms, finalists, runs
    if device:
        slices = -(-n_max // TOPK_SLICE)
        if slices > lib.es_topk_max_runs() or count > K_LIMIT:
            raise ValueError(f"shard_topk's device class takes rows of at "
                             f"most {lib.es_topk_max_runs()} slices of "
                             f"{TOPK_SLICE} values and k <= {K_LIMIT}, got "
                             f"{n_max} values and k {kk}")
        row_words = -(-lib.es_topk_row_bytes() // 8)
        scratch = [
            torch.empty((rows, row_words), dtype=torch.int64, device=dev),
            torch.empty((rows, slices, 256), dtype=torch.int32, device=dev),
            torch.empty((rows, kk), dtype=torch.int64, device=dev),
            torch.empty((rows, slices, 2), dtype=torch.int32, device=dev)]
    class_rows = (torch.zeros(len(TOPK_CLASSES), dtype=torch.int32,
                              device=dev) if stats is not None else None)
    _run(lib, "shard_topk", events, lib.es_shard_topk, _ptr(vals), stride,
         _ptr(row_off), _ptr(row_n), n_all, n_max, rows, kk, TOPK_SORT_CAP,
         TOPK_STAGE_CAP, TOPK_SLICE, *map(_ptr, scratch), _ptr(out_vals),
         _ptr(out_pos), _ptr(ids), fill, _ptr(out_ids), _ptr(class_rows),
         torch.cuda.current_stream(dev).cuda_stream)
    if stats is not None:
        stats.setdefault("topk_classes", dict.fromkeys(TOPK_CLASSES, 0))
        for name, c in zip(TOPK_CLASSES, class_rows.tolist()):
            stats["topk_classes"][name] += c
        stats["topk_slices"] = slices
        # the per-row kernel, then (the device class) the three others
        stats["topk_blocks_per_sm"] = {
            name: blocks_per_sm(name, lib.es_topk_smem(
                OCCUPANCY_KERNELS.index(name), n_max, kk, TOPK_SORT_CAP,
                TOPK_STAGE_CAP, TOPK_SLICE, int(row_n is not None)))
            for name in TOPK_KERNELS[:4 if device else 1]}


# ---------------------------------------------------------------------------
# exact_merge: sorted_merge_topk(variant="compressed_exact")
# ---------------------------------------------------------------------------

def exact_merge_topk_plain(flat_docs, flat_impact, starts, lengths, weights,
                           min_count, **kw) -> Tuple[torch.Tensor, ...]:
    """The plain version of the exact merge (ops/sparse.merge_topk_core
    with variant="compressed_exact"), on whatever device the operands
    lie."""
    kw.pop("stats", None)
    kw.pop("events", None)
    return sparse.merge_topk_core(flat_docs, flat_impact, starts, lengths,
                                  weights, min_count,
                                  variant="compressed_exact", **kw)


def exact_merge_topk(flat_docs, flat_impact, starts, lengths, weights,
                     min_count, *, stats: Optional[Dict[str, Any]] = None,
                     events: Optional[list] = None, **kw
                     ) -> Tuple[torch.Tensor, ...]:
    """sorted_merge_topk(variant="compressed_exact") → (scores f32
    [R, k'], docs int32 [R, k'][, totals int32 [R]]). CPU operands run
    the plain version; CUDA operands launch exact_merge and shard_topk
    or raise. `stats` receives the lane and candidate counts (a host
    sync) and the rows each size class took; `events` (kernel, start,
    end) CUDA events."""
    if flat_docs.device.type == "cpu":
        return exact_merge_topk_plain(flat_docs, flat_impact, starts,
                                      lengths, weights, min_count, **kw)
    if flat_docs.device.type != "cuda":
        raise ValueError(f"exact merge runs on cuda or cpu tensors, got "
                         f"{flat_docs.device}")
    with device_context(flat_docs.device):
        return _launch_exact(flat_docs, flat_impact, starts, lengths,
                             weights, min_count, stats=stats, events=events,
                             **kw)


def _launch_exact(flat_docs, flat_impact, starts, lengths, weights,
                  min_count, *, max_len, d_pad, k, t_window, with_counts,
                  with_totals=False, flat_rank=None, res_starts=None,
                  res_lens=None, res_vals=None, doc_bases=None,
                  dbs_starts=None, dlo_starts=None, stats=None, events=None,
                  raw=False, **_skip_operands):
    """The exact variant reads no block-max or slot-term operands (the
    reference's exact branch has no skip): they are taken and unused.
    raw=True: the raw merge over a raw pack's int32 docs and f32
    impacts (es_raw_merge), the same design and size classes."""
    dev = flat_docs.device
    if raw:
        r, t = _check_raw_operands(
            flat_docs, flat_impact, starts, lengths, weights, min_count,
            max_len=max_len, d_pad=d_pad, k=k, t_window=t_window)
        delta = False
    else:
        r, t, delta = _check_operands(
            "exact merge", flat_docs, flat_impact, starts, lengths, weights,
            min_count, max_len=max_len, d_pad=d_pad, k=k,
            t_window=t_window, flat_rank=flat_rank, res_starts=res_starts,
            res_lens=res_lens, res_vals=res_vals, doc_bases=doc_bases,
            dbs_starts=dbs_starts, dlo_starts=dlo_starts)
    kk = min(k, t * max_len)
    window = 1
    while window < t_window:
        window *= 2

    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    # each row's valid lanes, back to back: its candidates (and the radix
    # class's items and sort scratch, later parts' parked candidates) live
    # in the row's slice
    row_cap = lengths.clamp(min=0).sum(dim=1, dtype=torch.int64)
    offs = torch.zeros(r + 1, dtype=torch.int64, device=dev)
    torch.cumsum(row_cap, dim=0, out=offs[1:])
    *caps, longest = torch.cat(
        [row_cap, lengths.max().to(torch.int64).view(1)]).tolist()
    if longest > max_len:
        raise ValueError(f"a slot holds {longest} lanes, more than "
                         f"max_len={max_len}")
    row_off = offs[:r]
    total_cap = max(1, sum(caps))
    longest_row = max(caps)
    # the merge's window: the longest row in 1024-lane steps, capped; a
    # longer row is cut into parts of about a window, a block each
    window_lanes = min(EXACT_WINDOW_CAP, -(-max(longest_row, 1) // 1024)
                       * 1024)
    parts = [max(1, -(-c // window_lanes)) for c in caps]
    part_rq = [row | q << 16 for row, n_parts in enumerate(parts)
               for q in range(1, n_parts)]
    row_parts = torch.tensor(parts, dtype=torch.int32).to(dev)
    part_rq_t = torch.tensor(part_rq or [0], dtype=torch.int32).to(dev)
    items = torch.empty(total_cap, dtype=torch.int64, device=dev)
    alt = torch.empty(total_cap, dtype=torch.int64, device=dev)
    cand_score = torch.empty(total_cap, dtype=torch.float32, device=dev)
    cand_doc = torch.empty(total_cap, dtype=torch.int32, device=dev)
    n_cand = torch.empty(r, dtype=torch.int32, device=dev)
    part_found = torch.empty(r + len(part_rq), dtype=torch.int32,
                             device=dev)
    part_base = torch.empty_like(part_found)
    bad = torch.zeros(r, dtype=torch.int32, device=dev)
    class_rows = (torch.zeros(len(EXACT_CLASSES), dtype=torch.int32,
                              device=dev) if stats is not None else None)
    tail = (_ptr(row_off), _ptr(part_rq_t), _ptr(row_parts), len(part_rq),
            int(with_counts), window, window_lanes, _ptr(items), _ptr(alt),
            _ptr(cand_score), _ptr(cand_doc), _ptr(n_cand),
            _ptr(part_found), _ptr(part_base), _ptr(bad), _ptr(class_rows),
            stream)
    if raw:
        _run(lib, "raw_merge", events, lib.es_raw_merge, _ptr(flat_docs),
             _ptr(flat_impact), flat_docs.shape[0], _ptr(starts),
             _ptr(lengths), _ptr(weights), _ptr(min_count), r, t, max_len,
             d_pad, *tail)
    else:
        streams, slots = _stream_slot_args(
            flat_docs, flat_impact, starts, lengths, weights, min_count,
            max_len=max_len, d_pad=d_pad, flat_rank=flat_rank,
            res_starts=res_starts, res_lens=res_lens, res_vals=res_vals,
            doc_bases=doc_bases, dbs_starts=dbs_starts,
            dlo_starts=dlo_starts)
        _run(lib, "exact_merge", events, lib.es_exact_merge, *streams,
             *slots, *tail)
    out_vals = torch.empty((r, kk), dtype=torch.float32, device=dev)
    out_docs = torch.empty((r, kk), dtype=torch.int32, device=dev)
    _topk_rows(lib, cand_score, r, kk, stride=0, row_off=row_off,
               row_n=n_cand, n_all=0, n_max=max(longest_row, 1),
               out_vals=out_vals, out_pos=None,
               ids=cand_doc, fill=d_pad, out_ids=out_docs, stats=stats,
               events=events)
    if stats is not None:
        stats.update(lanes=sum(caps), parts=len(part_rq),
                     candidates=int(n_cand.sum()), rows=r, slots=t, kk=kk,
                     delta=int(delta),
                     exact_classes=dict(zip(EXACT_CLASSES,
                                            class_rows.tolist())),
                     window_lanes=window_lanes,
                     exact_smem=lib.es_exact_smem_bytes(window_lanes, t))
        stats["exact_blocks_per_sm"] = blocks_per_sm("exact_merge",
                                                     stats["exact_smem"])
    if with_totals:
        return out_vals, out_docs, n_cand
    return out_vals, out_docs


# ---------------------------------------------------------------------------
# raw_merge: sorted_merge_topk(variant="ref" / "packed") on a raw pack
# ---------------------------------------------------------------------------

def raw_merge_topk_plain(flat_docs, flat_impact, starts, lengths, weights,
                         min_count, *, packed: bool = False, **kw
                         ) -> Tuple[torch.Tensor, ...]:
    """The plain version of the raw merge (ops/sparse.merge_topk_core
    with variant="ref", or "packed"), on whatever device the operands
    lie."""
    kw.pop("stats", None)
    kw.pop("events", None)
    return sparse.merge_topk_core(flat_docs, flat_impact, starts, lengths,
                                  weights, min_count,
                                  variant="packed" if packed else "ref",
                                  **kw)


def raw_merge_topk(flat_docs, flat_impact, starts, lengths, weights,
                   min_count, *, packed: bool = False,
                   stats: Optional[Dict[str, Any]] = None,
                   events: Optional[list] = None, **kw
                   ) -> Tuple[torch.Tensor, ...]:
    """sorted_merge_topk(variant="ref" or "packed") on a raw pack (int32
    docs, f32 impacts) → (scores f32 [R, k'], docs int32 [R, k'][, totals
    int32 [R]]). CPU operands run the plain version of the variant; CUDA
    operands launch raw_merge and shard_topk or raise. On a card "packed"
    launches the same kernels as "ref": the reference's contract
    (sorted_merge_topk's doc) makes the two bit-identical, and packed's
    16-bit key is a device for a TPU's sort width, which a merge of
    sorted runs does not need. `stats` and `events` as exact_merge_topk's.
    """
    if flat_docs.device.type == "cpu":
        return raw_merge_topk_plain(flat_docs, flat_impact, starts, lengths,
                                    weights, min_count, packed=packed, **kw)
    if flat_docs.device.type != "cuda":
        raise ValueError(f"raw merge runs on cuda or cpu tensors, got "
                         f"{flat_docs.device}")
    with device_context(flat_docs.device):
        return _launch_exact(flat_docs, flat_impact, starts, lengths,
                             weights, min_count, stats=stats, events=events,
                             raw=True, **kw)


# ---------------------------------------------------------------------------
# the pruned tiers: pruned_candidates (phase A) and pruned_rescore (phase B)
# ---------------------------------------------------------------------------

#: candidates a pruned_rescore row orders in one block's shared memory
PRUNED_CAND_LIMIT = 4096
#: items a block of pruned_candidates sorts in shared memory (16 B each:
#: the items and a pass buffer): a query of at most this many lanes is
#: one block that reads them from the streams (the shared class); the
#: wrapper cuts a longer query into bands of about half as many, and a
#: band that still holds more is sorted in device memory
CAND_BAND_CAP = 2048
#: lanes of one part block of pruned_candidates (16 B each of shared
#: memory): a banded query's lanes are read and split by band this many
#: at a time
CAND_PART_LANES = 2048
#: the size classes of pruned_candidates (queries per class): one block
#: (shared), bands each sorted in shared memory (bands), or some band
#: sorted in device memory (device)
CAND_CLASSES = ("cand.shared", "cand.bands", "cand.device")
#: the paths of pruned_rescore (queries per path): scored over several
#: blocks (spread, then ordered when asked), or ordered alone (order)
RESCORE_CLASSES = ("rescore.spread", "rescore.order")


def pruned_candidates_plain(flat_docs, flat_impact, starts, lengths,
                            weights, rows, *, max_len: int, d_pad: int,
                            t_window: int, k: int, pack_keys: bool = False
                            ) -> Tuple[torch.Tensor, ...]:
    """Phase A of one group (the reference's make_pruned_search
    one_group), on whatever device the operands lie: each query's
    [G·T] slot windows of the impact-sorted docs (int32) and impacts
    (f32), lanes keyed by gid = row·(d_pad + 1) + doc (rows [B, G·T]: the
    slot's device-local row), a stable sort by gid (or, with pack_keys,
    one sort of u32 keys: group-relative gid << 16 | impact code), the
    run sums, ok = run end & total > 0, the count of ok runs and the
    top-k by (score desc, position asc) → (vals f32 [B, k], gids int64
    [B, k] (any gid where the value is -inf), totals int32 [B])."""
    b, gt = starts.shape
    width = gt * max_len
    chunk = max(1, sparse.PLAIN_CHUNK_LANES // max(1, width))
    outs = [_candidates_rows(flat_docs, flat_impact, starts[a:a + chunk],
                             lengths[a:a + chunk], weights[a:a + chunk],
                             rows[a:a + chunk], row0=rows[0, 0],
                             max_len=max_len, d_pad=d_pad,
                             t_window=t_window, k=k, pack_keys=pack_keys)
            for a in range(0, max(b, 1), chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _candidates_rows(flat_docs, flat_impact, starts, lengths, weights, rows,
                     *, row0, max_len, d_pad, t_window, k, pack_keys):
    b = starts.shape[0]
    dev = starts.device
    docs = sparse._window(flat_docs, starts, max_len)
    imps = sparse._window(flat_impact, starts, max_len)
    idx = torch.arange(max_len, dtype=torch.int64, device=dev)
    valid = idx[None, None, :] < lengths[:, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    imp = torch.where(valid, weights[:, :, None] * imps, zero)
    lane_doc = torch.where(valid, docs, torch.full_like(docs, d_pad))
    if pack_keys:
        grel = torch.clamp(rows.to(torch.int64) - row0, min=0)
        gid_p = grel[:, :, None] * (d_pad + 1) + lane_doc
        key = ((gid_p << 16) | sparse.impact_code16(imp)).reshape(b, -1)
        skp = torch.sort(key, dim=1).values
        sk = (skp >> 16) + int(row0) * (d_pad + 1)
        sv = sparse.decode_code16(skp & 0xFFFF)
    else:
        gid = rows.to(torch.int64)[:, :, None] * (d_pad + 1) + lane_doc
        order = torch.sort(gid.reshape(b, -1), dim=1, stable=True).indices
        sk = torch.gather(gid.reshape(b, -1), 1, order)
        sv = torch.gather(imp.reshape(b, -1), 1, order)
    total = sparse.segmented_run_sum(sk, sv, t_window)
    run_end = torch.cat([sk[:, :-1] != sk[:, 1:],
                         torch.ones((b, 1), dtype=torch.bool, device=dev)],
                        dim=1)
    ok = run_end & (total > 0.0)
    score = torch.where(ok, total, torch.full_like(total, NEG_INF))
    vals, pos = sparse.top_k_plain(score, k)
    return vals, torch.gather(sk, 1, pos), ok.sum(dim=1, dtype=torch.int32)


def pruned_candidates(flat_docs, flat_impact, starts, lengths, weights,
                      rows, *, max_len: int, d_pad: int, t_window: int,
                      k: int, pack_keys: bool = False,
                      stats: Optional[Dict[str, Any]] = None,
                      events: Optional[list] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """pruned_candidates_plain's function: the plain version for CPU
    operands; for CUDA operands the pruned_candidates kernels and
    shard_topk over their candidates, or the call raises. The kernels:
    each query's valid lanes read once and split by band of the key
    (part blocks), each band sorted in one block's shared memory with
    its run sums and its ok runs placed in gid order (band blocks); a
    query of at most CAND_BAND_CAP lanes takes one band block alone.
    `stats` receives the queries each class took (CAND_CLASSES), the
    blocks and their residency; `events` (kernel, start, end)."""
    kw = dict(max_len=max_len, d_pad=d_pad, t_window=t_window, k=k,
              pack_keys=pack_keys)
    if flat_docs.device.type == "cpu":
        return pruned_candidates_plain(flat_docs, flat_impact, starts,
                                       lengths, weights, rows, **kw)
    if flat_docs.device.type != "cuda":
        raise ValueError(f"pruned candidates run on cuda or cpu tensors, "
                         f"got {flat_docs.device}")
    with device_context(flat_docs.device):
        return _launch_candidates(flat_docs, flat_impact, starts, lengths,
                                  weights, rows, stats=stats, events=events,
                                  **kw)


def _raw_streams(flat_docs, flat_impact, dev):
    _need(flat_docs, "flat_docs", torch.int32, dev)
    n_post = flat_docs.shape[0]
    _need(flat_impact, "flat_impact", torch.float32, dev, (n_post,))
    return n_post


def _candidates_plan(caps, key_top, pack_keys):
    """The blocks of a pruned_candidates launch from each query's lanes
    (caps) and the launch's key range [0, key_top) → (plan int64 numpy:
    row_off [B + 1], qinfo [B, 4] = (shift, bands, parts, first band
    start), part tiles, band tiles (query | index << 32); parts, bands,
    the most parts of a query, whether a query takes the shared class,
    band starts). A query of at most CAND_BAND_CAP lanes is one block
    sorting all key bits (shift = the key's bits); a longer one splits
    at the key bit that gives bands of about CAND_BAND_CAP / 2 lanes if
    its lanes spread evenly over its keys (with pack_keys above the
    16-bit code: a gid's lanes share a band)."""
    cap = max(1, CAND_BAND_CAP)
    part_lanes = max(1, CAND_PART_LANES)
    caps = np.asarray(caps, dtype=np.int64)
    b = caps.shape[0]
    kb = int(key_top - 1).bit_length()
    banded = caps > cap
    want = np.maximum(-(-caps // max(1, cap // 2)), 1)
    lw = np.array([int(w - 1).bit_length() for w in want], dtype=np.int64)
    shift = np.where(banded, np.maximum(kb - lw, 16 if pack_keys else 0),
                     kb)
    bands = np.where(banded, ((key_top - 1) >> shift) + 1, 1)
    parts = np.where(banded, -(-caps // part_lanes), 0)
    starts = parts * (bands + 1)
    first = np.concatenate([[0], np.cumsum(starts)[:-1]]).astype(np.int64)
    q = np.arange(b, dtype=np.int64)
    part_tiles = np.repeat(q, parts) | (
        np.arange(int(parts.sum()), dtype=np.int64)
        - np.repeat(np.cumsum(parts) - parts, parts)) << 32
    band_tiles = np.repeat(q, bands) | (
        np.arange(int(bands.sum()), dtype=np.int64)
        - np.repeat(np.cumsum(bands) - bands, bands)) << 32
    row_off = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
    qinfo = np.stack([shift, bands, parts, first], axis=1).astype(np.int64)
    plan = np.concatenate([row_off, qinfo.reshape(-1), part_tiles,
                           band_tiles])
    return (plan, len(part_tiles), len(band_tiles),
            int(parts.max(initial=0)), bool((~banded).any()),
            int(starts.sum()))


def _launch_candidates(flat_docs, flat_impact, starts, lengths, weights,
                       rows, *, max_len, d_pad, t_window, k, pack_keys,
                       events, stats=None):
    dev = flat_docs.device
    n_post = _raw_streams(flat_docs, flat_impact, dev)
    b, gt = starts.shape
    for name, ten in (("starts", starts), ("lengths", lengths),
                      ("rows", rows)):
        _need(ten, name, torch.int32, dev, (b, gt))
    _need(weights, "weights", torch.float32, dev, (b, gt))
    if n_post < max_len or not 1 <= max_len <= MAX_LEN_LIMIT:
        raise ValueError(f"pruned candidates take windows of 1..."
                         f"{MAX_LEN_LIMIT} lanes inside the streams, got "
                         f"{max_len} over {n_post} postings")
    if t_window > T_LIMIT or b >= 65536:
        raise ValueError(f"pruned candidates take t_window <= {T_LIMIT} "
                         f"and fewer than 65536 queries")
    # the one host read: each query's lanes plan the blocks and size the
    # buffers; the rows bound the key range
    lanes = lengths.clamp(min=0, max=max_len).sum(dim=1, dtype=torch.int64)
    if rows.numel():
        bounds = torch.stack([rows.min(), rows.max(), rows[0, 0]]).to(
            torch.int64)
    else:
        bounds = torch.zeros(3, dtype=torch.int64, device=dev)
    *caps, row_min, row_max, row_first = torch.cat([lanes, bounds]).tolist()
    d1 = d_pad + 1
    if (row_max + 1) * d1 >= 1 << 31 or row_min < 0:
        raise ValueError("pruned candidates keep gids in 31 bits")
    if pack_keys:
        key_base = row_first * d1
        key_top = (max(0, row_max * d1 + d_pad - key_base) + 1) << 16
        if key_top > 1 << 32:
            raise ValueError("pruned candidates' packed keys hold a "
                             "group's gids in 16 bits")
    else:
        key_base = row_min * d1
        key_top = (row_max - row_min + 1) * d1
    kk = min(k, gt * max_len)
    lib = _lib()
    plan, n_parts, n_bands, p_max, has_shared, n_starts = _candidates_plan(
        caps, key_top, pack_keys)
    plan_t = torch.from_numpy(plan).to(dev)
    total_cap = max(1, sum(caps))
    lane_bufs = 3 if n_parts else 0     # items, alt, alt2
    bufs = torch.empty(lane_bufs * total_cap + 1, dtype=torch.int64,
                       device=dev)
    items, alt, alt2 = (bufs[j * total_cap:] for j in range(3))
    # the band blocks' look-back words, then the class counters
    zeros = torch.zeros(n_bands + 2, dtype=torch.int64, device=dev)
    class_rows = zeros[n_bands:].view(torch.int32)
    bstart = torch.empty(max(1, n_starts), dtype=torch.int32, device=dev)
    cand_score = torch.empty(total_cap, dtype=torch.float32, device=dev)
    cand_gid = torch.empty(total_cap, dtype=torch.int32, device=dev)
    n_cand = torch.empty(b, dtype=torch.int32, device=dev)
    window = 1   # segmented_run_sum's doubling steps reach a power of two
    while window < t_window:
        window *= 2
    stream = torch.cuda.current_stream(dev).cuda_stream
    cap = max(1, CAND_BAND_CAP)
    part_lanes = max(1, CAND_PART_LANES)
    _run(lib, "pruned_candidates", events, lib.es_pruned_candidates,
         _ptr(flat_docs), _ptr(flat_impact), n_post, _ptr(starts),
         _ptr(lengths), _ptr(weights), _ptr(rows), b, gt, max_len, d_pad,
         int(pack_keys), window, key_base, _ptr(plan_t), n_parts, n_bands,
         p_max, int(has_shared), cap, part_lanes, _ptr(items), _ptr(alt),
         _ptr(alt2), _ptr(bstart), _ptr(zeros), _ptr(cand_score),
         _ptr(cand_gid), _ptr(n_cand), _ptr(class_rows), stream)
    if pack_keys:
        with _LAUNCHES_LOCK:
            LAUNCHES["pruned_candidates.pack_keys"] += 1
    out_vals = torch.empty((b, kk), dtype=torch.float32, device=dev)
    out_gids = torch.empty((b, kk), dtype=torch.int32, device=dev)
    _topk_rows(lib, cand_score, b, kk, stride=0, row_off=plan_t[:b],
               row_n=n_cand, n_all=0, n_max=max(max(caps, default=1), 1),
               out_vals=out_vals, out_pos=None, ids=cand_gid, fill=0,
               out_ids=out_gids, stats=None, events=events)
    if stats is not None:
        smem = {name: lib.es_cand_smem_bytes(j, gt, cap, part_lanes, p_max,
                                             int(has_shared))
                for j, name in enumerate(("cand_part", "cand_band"))}
        stats.update(
            cand_classes=dict(zip(CAND_CLASSES,
                                  class_rows[:len(CAND_CLASSES)].tolist())),
            cand_blocks={"cand_part": n_parts, "cand_band": n_bands},
            cand_smem=smem, lanes=sum(caps), queries=b, slots=gt, kk=kk)
        stats["cand_blocks_per_sm"] = {
            name: blocks_per_sm(name, smem[name])
            for name, n in stats["cand_blocks"].items() if n}
    return out_vals, out_gids.to(torch.int64), n_cand


def pruned_rescore_plain(ds_docs, ds_impacts, cand_gids, t_starts,
                         t_lengths, t_weights, *, d_pad: int, p_pad: int,
                         row_base: int, search_iters: int, cand_vals=None,
                         k: Optional[int] = None):
    """Phase B on one device (the reference's make_pruned_search, its
    rescore), on whatever device the operands lie: each candidate gid
    (int64 [B, C]) whose row lies in this device's rows [row_base,
    row_base + S_l) of the doc-sorted docs (int32 [S_l, P_pad]) and
    impacts gets, for each term of its row's ranges (t_* [S_l, B,
    T_terms]), a lower-bound binary search of search_iters steps, and
    the sum of the found w · impact over the terms in the reference's
    association (_term_sum) → exact f32 [B, C] (0 off this device).
    With cand_vals (one device holds every row) the result goes on to
    pruned_order_plain: (vals [B, k], gids int64 [B, k])."""
    s_l, p_pad_ = ds_docs.shape[0], p_pad
    flat_ds = ds_docs.reshape(-1)
    flat_imp = ds_impacts.reshape(-1)
    b = cand_gids.shape[0]
    d1 = d_pad + 1
    gid32 = cand_gids.to(torch.int32).to(torch.int64)
    row = torch.div(gid32, d1, rounding_mode="floor")
    ord_ = gid32 - row * d1
    local_row = row - row_base
    in_local = (local_row >= 0) & (local_row < s_l)
    lr = torch.clamp(local_row, 0, s_l - 1)
    qsel = torch.arange(b, dtype=torch.int64, device=cand_gids.device)[:, None]
    st = t_starts[lr, qsel].to(torch.int64)           # [B, C, T]
    ln = t_lengths[lr, qsel].to(torch.int64)
    w = t_weights[lr, qsel]
    lo = (lr * p_pad_)[:, :, None] + st
    hi = lo + ln
    end = hi
    ord3 = ord_[:, :, None]
    for _ in range(search_iters):
        mid = (lo + hi) >> 1
        go = sparse._take(flat_ds, mid, d_pad) < ord3
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    v = sparse._take(flat_ds, lo, d_pad)
    found = (ln > 0) & (v == ord3) & (lo < end)
    imp_f = sparse._take(flat_imp, lo, 0.0)
    contrib = torch.where(found & in_local[:, :, None], w * imp_f,
                          torch.zeros((), dtype=torch.float32,
                                      device=w.device))
    return _term_sum(contrib) if cand_vals is None else pruned_order_plain(
        _term_sum(contrib), cand_vals, cand_gids, k=k)


def _term_sum(contrib: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis (a power of two) in the association XLA:CPU
    gives the reference's rescore sum inside its fused step: halving,
    x_i + x_(i + n/2), then again over the halves (for 8 terms ((x0 + x4)
    + (x2 + x6)) + ((x1 + x5) + (x3 + x7)))."""
    n = contrib.shape[-1]
    if n & (n - 1):
        raise ValueError(f"the term sum takes a power of two of terms, "
                         f"got {n}")
    while n > 1:
        n //= 2
        contrib = contrib[..., :n] + contrib[..., n:]
    return contrib[..., 0]



def pruned_order_plain(exact, cand_vals, cand_gids, *, k: int):
    """The pruned step's final order, on whatever device the operands
    lie: -inf where the candidate is (cand_vals), then (−exact, gid)
    ascending with the reference sort's float order (-0.0 before 0.0),
    the first k → (vals f32 [B, k], gids int64 [B, k])."""
    exact = torch.where(cand_vals > NEG_INF, exact,
                        torch.full_like(exact, NEG_INF))
    neg = torch.where(exact > NEG_INF, -exact,
                      torch.full_like(exact, float("inf")))
    bits = neg.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ob = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF,
                     bits | 0x80000000)
    o1 = torch.sort(cand_gids, dim=1, stable=True).indices
    o2 = torch.sort(torch.gather(ob, 1, o1), dim=1, stable=True).indices
    order = torch.gather(o1, 1, o2)[:, :k]
    neg_s = torch.gather(neg, 1, order)
    vals = torch.where(torch.isinf(neg_s), torch.full_like(neg_s, NEG_INF),
                       -neg_s)
    return vals, torch.gather(cand_gids, 1, order)


def pruned_rescore(ds_docs, ds_impacts, cand_gids, t_starts, t_lengths,
                   t_weights, *, d_pad: int, p_pad: int, row_base: int,
                   search_iters: int, cand_vals=None, k: Optional[int] = None,
                   stats: Optional[Dict[str, Any]] = None,
                   events: Optional[list] = None):
    """pruned_rescore_plain's function: the plain version for CPU
    operands; for CUDA operands the pruned_rescore kernels, or the call
    raises. rescore_score spreads each query's candidates over blocks of
    256 / T_terms, a thread a (candidate, term) walking the reference's
    fixed-step search in device memory, the terms summed by shuffles in
    the reference's order. With cand_vals, rescore_order then sorts
    each query's (-score, gid) keys in shared memory (a block a query)
    and the first k go out. `stats` receives the queries each path took
    (RESCORE_CLASSES), the blocks and their residency."""
    kw = dict(d_pad=d_pad, p_pad=p_pad, row_base=row_base,
              search_iters=search_iters, cand_vals=cand_vals, k=k)
    if ds_docs.device.type == "cpu":
        return pruned_rescore_plain(ds_docs, ds_impacts, cand_gids,
                                    t_starts, t_lengths, t_weights, **kw)
    if ds_docs.device.type != "cuda":
        raise ValueError(f"pruned rescore runs on cuda or cpu tensors, "
                         f"got {ds_docs.device}")
    with device_context(ds_docs.device):
        return _launch_rescore(ds_docs, ds_impacts, cand_gids, t_starts,
                               t_lengths, t_weights, None, stats=stats,
                               events=events, **kw)


def pruned_order(exact, cand_vals, cand_gids, *, k: int,
                 stats: Optional[Dict[str, Any]] = None,
                 events: Optional[list] = None):
    """pruned_order_plain's function: the plain version for CPU operands;
    for CUDA operands pruned_rescore's order kernel alone (a block a
    query), or the call raises. `stats` as pruned_rescore's."""
    if exact.device.type == "cpu":
        return pruned_order_plain(exact, cand_vals, cand_gids, k=k)
    if exact.device.type != "cuda":
        raise ValueError(f"pruned order runs on cuda or cpu tensors, got "
                         f"{exact.device}")
    with device_context(exact.device):
        return _launch_rescore(None, None, cand_gids, None, None, None,
                               exact, cand_vals=cand_vals, k=k, d_pad=0,
                               p_pad=0, row_base=0, search_iters=0,
                               stats=stats, events=events)


def _launch_rescore(ds_docs, ds_impacts, cand_gids, t_starts, t_lengths,
                    t_weights, exact_in, *, d_pad, p_pad, row_base,
                    search_iters, cand_vals, k, events, stats=None):
    """One pruned_rescore launch: mode 1 scores (ds_* given), 2 orders
    (cand_vals given), 3 both."""
    dev = cand_gids.device
    b, c = cand_gids.shape
    _need(cand_gids, "cand_gids", torch.int64, dev)
    if c > PRUNED_CAND_LIMIT or b >= 65536:
        raise ValueError(f"pruned rescore orders at most "
                         f"{PRUNED_CAND_LIMIT} candidates a query and "
                         f"fewer than 65536 queries, got {c} and {b}")
    score = ds_docs is not None
    order = cand_vals is not None
    s_l = n_post = t_terms = 0
    if score:
        n_post = _raw_streams(ds_docs.reshape(-1), ds_impacts.reshape(-1),
                              dev)
        s_l = ds_docs.shape[0]
        t_terms = t_starts.shape[2]
        for name, ten in (("t_starts", t_starts), ("t_lengths", t_lengths)):
            _need(ten, name, torch.int32, dev, (s_l, b, t_terms))
        _need(t_weights, "t_weights", torch.float32, dev, (s_l, b, t_terms))
    else:
        _need(exact_in, "exact", torch.float32, dev, (b, c))
    exact_out = None
    out_vals = out_gids = None
    kk = 0
    if order:
        _need(cand_vals, "cand_vals", torch.float32, dev, (b, c))
        kk = min(k, c)
        out_vals = torch.empty((b, kk), dtype=torch.float32, device=dev)
        out_gids = torch.empty((b, kk), dtype=torch.int64, device=dev)
    # the scores go out, or through exact_out to the order launch
    if score:
        exact_out = torch.empty((b, c), dtype=torch.float32, device=dev)
    mode = int(score) | int(order) << 1
    lib = _lib()
    if b and c:
        _run(lib, "pruned_rescore", events, lib.es_pruned_rescore,
             _ptr(ds_docs), _ptr(ds_impacts), n_post, _ptr(cand_gids), c,
             _ptr(t_starts), _ptr(t_lengths), _ptr(t_weights), s_l, b,
             t_terms, d_pad, p_pad, row_base, search_iters,
             _ptr(exact_in), _ptr(cand_vals), _ptr(exact_out), kk,
             _ptr(out_vals), _ptr(out_gids), mode,
             torch.cuda.current_stream(dev).cuda_stream)
    elif order:
        out_vals.fill_(NEG_INF)
        out_gids.zero_()
    else:
        exact_out.zero_()
    if stats is not None:
        path = "rescore.spread" if score else "rescore.order"
        kernels = {}
        if score:
            kernels["rescore_score"] = -(-c // (256 // t_terms)) * b
        if order:
            kernels["rescore_order"] = b
        smem = {name: lib.es_rescore_order_smem_bytes(c)
                if name == "rescore_order" else 0 for name in kernels}
        stats.update(
            rescore_classes={p: b if p == path else 0
                             for p in RESCORE_CLASSES},
            rescore_blocks=kernels, rescore_smem=smem,
            rescore_blocks_per_sm={name: blocks_per_sm(name, smem[name])
                                   for name in kernels})
    return (out_vals, out_gids) if order else exact_out
