"""The aggregation kernels (B10): counterparts of the six jitted functions
of the reference's ``search/aggregations/device.py``, as three kernels of
``csrc/aggs.cu``.

* ``bucket_counts`` (kernel agg_bucket_counts, K1): per-bucket doc counts
  int64[n_out] under a mask; ``mode`` "terms" (a keyword's ordinals,
  ``_terms_counts_fn``), "presence" (int32[n_out], 1 where an ordinal
  occurs, ``_ord_presence_fn``), "histogram" (``floor((v - base) /
  interval)``, ``_histo_counts_fn``) or "bounded" (the last boundary <= v,
  ``_bounded_bucket_fn``).
* ``masked_stats`` (agg_masked_stats, K2): count, sum, min and max of a
  column under a mask (``_stats_fn``).
* ``ord_stats`` (agg_ord_stats, K3): per ordinal of a keyword column, the
  count, sum, min and max of a value column under a mask
  (``_terms_metric_fn``).

A numeric column is int64 (``MISSING_I64`` missing) or float64 (NaN
missing); ordinals are int32 (-1 none); the mask is bool.

The bits are XLA:CPU's, found by running the reference's functions under
``JAX_PLATFORMS=cpu`` (``tests/test_torch_agg_ops.py`` holds them):

* a float64 sum to a scalar is XLA's tree reduction: the values (0 where
  masked) are cut into windows of 32, zero-padded with the pad split low =
  pad // 2 and high = the rest, each window summed left to right from 0;
  the window sums are reduced again the same way while more than 32 are
  left, and the last ones summed left to right from 0 (XLA's
  TreeReductionRewriter, window 32; the rule ``xla_math.xla_row_sum``
  follows for float32). It equals numpy's pairwise sum at some lengths
  (128, 62,592) by chance and neither that nor a sequential sum at others;
* a scatter-add adds in doc order: each ordinal's sum is one chain in doc
  order from 0;
* min and max are IEEE minimum and maximum: -0 is below +0, in any order;
* XLA:CPU runs with DAZ and FTZ, for float64 too: a subnormal operand is
  read as a zero of its sign (a negative one makes a min of -0) and a
  subnormal sum or quotient becomes a zero of its sign;
* the histogram's f64 -> s64 convert maps NaN to 0 and saturates; every
  id outside [0, n_out) is dropped, so only NaN's 0 matters;
* searchsorted sorts NaN last (id n_out - 1) and finds -0 and +0 equal.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version (``*_plain``, torch ops), which the
tests and ``chip_smoke.py`` hold the kernels against. ``LAUNCHES`` counts
the calls that launched a kernel: one a call, whatever number of launches
the call makes (K2 a launch a level of its sum, K3 five).
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional, Tuple

import torch

from elasticsearch_tpu_torch.parallel.device import device_context

MISSING_I64 = -(2 ** 63)
DBL_MIN = 2.2250738585072014e-308

MODES = ("terms", "presence", "histogram", "bounded")
KERNELS = ("agg_bucket_counts", "agg_masked_stats", "agg_ord_stats")
#: K1 counts in shared memory (4 bytes a bucket) up to this many buckets,
#: 48 KiB, the limit that needs no attribute; past it in device memory
K1_SMEM_BINS = 12288
#: K3: a thread counts and places at least this many docs ...
K3_CHUNK_MIN = 256
#: ... and its table of chunk × ordinal offsets holds at most this many
#: int32 cells
K3_TABLE_CELLS = 1 << 24

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_LAUNCHES_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.c_double
_SIGNATURES = {
    "es_agg_bucket_counts": [_I, _I, _P, _P, _LL, _D, _D, _P, _I, _I, _P,
                             _P, _P],
    "es_agg_stats_scratch": [_LL, _P],
    "es_agg_masked_stats": [_I, _P, _P, _LL, _P, _P, _P, _P, _P],
    "es_agg_ord_stats": [_I, _P, _P, _P, _LL, _I, _LL, _LL, _P, _P, _P, _P,
                         _P, _P, _P, _P],
}


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def _lib() -> ctypes.CDLL:
    from elasticsearch_tpu_torch.ops import _build
    lib = _build.load("aggs")
    if not getattr(lib, "_es_typed", False):
        for fn, args in _SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.es_error_string.argtypes = [ctypes.c_int]
        lib.es_error_string.restype = ctypes.c_char_p
        lib._es_typed = True
    return lib


def build() -> None:
    """Build csrc/aggs.cu (nvcc, at first use) and load it."""
    _lib()


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def flush64(x):
    """A float64 (tensor or number) under DAZ / FTZ: a subnormal becomes a
    zero of its sign."""
    if isinstance(x, torch.Tensor):
        return torch.where(x.abs() < DBL_MIN,
                           torch.copysign(torch.zeros_like(x), x), x)
    x = float(x)
    return math.copysign(0.0, x) if abs(x) < DBL_MIN else x


def _values(col: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A numeric column → (values f64 as XLA:CPU reads them, present)."""
    if col.dtype == torch.int64:
        return col.to(torch.float64), col != MISSING_I64
    if col.dtype == torch.float64:
        return flush64(col), ~torch.isnan(col)
    raise ValueError(f"a numeric column is int64 or float64, got {col.dtype}")


def _kind(col: torch.Tensor) -> int:
    return {torch.int32: 0, torch.int64: 1, torch.float64: 2}[col.dtype]


def bucket_counts_plain(mask: torch.Tensor, col: torch.Tensor, mode: str,
                        n_out: int, base: float = 0.0, interval: float = 1.0,
                        bounds: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """bucket_counts' function in torch ops on the tensors' device."""
    if mode in ("terms", "presence"):
        ok = mask & (col >= 0) & (col < n_out)
        idx = col.to(torch.int64)
    elif mode == "histogram":
        v, ok = _values(col)
        f = torch.floor(flush64(flush64(v - flush64(base))
                                / flush64(interval)))
        inside = (f >= 0) & (f < n_out)
        ok = mask & ok & (inside | torch.isnan(f))   # NaN converts to 0
        idx = torch.where(inside, f, torch.zeros_like(f)).to(torch.int64)
    elif mode == "bounded":
        v, ok = _values(col)
        pos = torch.searchsorted(bounds, v, right=True)
        pos = torch.where(torch.isnan(v), torch.full_like(pos, n_out), pos)
        idx = pos - 1
        ok = mask & ok & (idx >= 0)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    counts = torch.bincount(idx[ok], minlength=n_out)[:n_out]
    if mode == "presence":
        return (counts > 0).to(torch.int32)
    return counts


def _signed_zero_fix(m: torch.Tensor, has_neg0: torch.Tensor,
                     has_pos0: torch.Tensor, lowest: bool) -> torch.Tensor:
    """IEEE minimum (lowest) / maximum over values holding ±0: a zero
    result is -0 where the minimum saw a -0, +0 where the maximum saw a
    +0, the other zero else."""
    pos = torch.zeros_like(m)
    neg = -pos
    if lowest:
        pick = torch.where(has_neg0, neg, pos)
    else:
        pick = torch.where(has_pos0, pos, neg)
    return torch.where(m == 0, pick, m)


def tree_sum64(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float64 sum of a 1-D tensor: windows of 32 (zero-padded,
    pad // 2 low), each left to right from 0, while more than 32 values
    are left; then left to right from 0. Each add flushed."""
    while x.shape[0] > 32:
        k = x.shape[0]
        nw = -(-k // 32)
        pad = nw * 32 - k
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(nw, 32)
        acc = torch.zeros(nw, dtype=x.dtype, device=x.device)
        for j in range(32):
            acc = flush64(acc + x[:, j])
        x = acc
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    for j in range(x.shape[0]):
        acc = flush64(acc + x[j])
    return acc


def masked_stats_plain(mask: torch.Tensor, col: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """masked_stats' function in torch ops: (count int64[1], f64[3] sum,
    min, max)."""
    v, ok = _values(col)
    ok = ok & mask
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=v.device)
    zero = torch.zeros((), dtype=torch.float64, device=v.device)
    s = tree_sum64(torch.where(ok, v, zero))
    mn = torch.where(ok, v, inf).amin() if v.numel() else inf
    mx = torch.where(ok, v, -inf).amax() if v.numel() else -inf
    z = ok & (v == 0)
    neg0 = (z & torch.signbit(v)).any()
    pos0 = (z & ~torch.signbit(v)).any()
    mn = _signed_zero_fix(mn, neg0, pos0, True)
    mx = _signed_zero_fix(mx, neg0, pos0, False)
    return (ok.sum().reshape(1).to(torch.int64),
            torch.stack([s, mn, mx]))


def _chain_sum(g: torch.Tensor) -> float:
    """One ordinal's values summed in order from 0, each add flushed."""
    part = torch.cumsum(g, 0)
    tiny = (part != 0) & (part.abs() < DBL_MIN)
    if bool(tiny.any()):
        acc = 0.0
        for x in g.tolist():
            acc = flush64(acc + x)
        return acc
    s = float(part[-1])
    return 0.0 if s == 0 else s   # the chain starts at +0: never -0


def ord_stats_plain(mask: torch.Tensor, ords: torch.Tensor,
                    col: torch.Tensor, n_out: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """ord_stats' function in torch ops: (counts int64[n_out], sums,
    mins, maxs f64[n_out]); an ordinal's sum a chain in doc order."""
    v, ok = _values(col)
    ok = ok & mask & (ords >= 0) & (ords < n_out)
    o = ords[ok].to(torch.int64)
    vals = v[ok]
    counts = torch.bincount(o, minlength=n_out)[:n_out]
    order = torch.argsort(o, stable=True)
    grouped = vals[order].cpu()
    ends = torch.cumsum(counts, 0).cpu().tolist()
    sums = [0.0] * n_out
    start = 0
    for k, end in enumerate(ends):
        if end > start:
            sums[k] = _chain_sum(grouped[start:end])
        start = end
    sums_t = torch.tensor(sums, dtype=torch.float64).to(v.device)
    inf = float("inf")
    mins = torch.full((n_out,), inf, dtype=torch.float64, device=v.device)
    maxs = torch.full((n_out,), -inf, dtype=torch.float64, device=v.device)
    mins = mins.scatter_reduce(0, o, vals, "amin")
    maxs = maxs.scatter_reduce(0, o, vals, "amax")
    z = vals == 0
    neg0 = torch.zeros(n_out, dtype=torch.bool, device=v.device)
    pos0 = torch.zeros(n_out, dtype=torch.bool, device=v.device)
    neg0[o[z & torch.signbit(vals)]] = True
    pos0[o[z & ~torch.signbit(vals)]] = True
    return (counts, sums_t, _signed_zero_fix(mins, neg0, pos0, True),
            _signed_zero_fix(maxs, neg0, pos0, False))


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _check(mask: torch.Tensor, *cols: torch.Tensor) -> None:
    dev = mask.device
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise ValueError(f"the mask is bool[n], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    for c in cols:
        if c.device != dev:
            raise ValueError(f"a column is on {c.device}, the mask on {dev}")
        if c.shape != mask.shape:
            raise ValueError(f"a column has shape {tuple(c.shape)}, the "
                             f"mask {tuple(mask.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the aggregation kernels run on cuda or cpu "
                         f"tensors, got {dev}")


def _raise(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.es_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


class _Timer:
    """A (kernel, start, end) pair of CUDA events into `events`."""

    def __init__(self, events, name):
        self.events, self.name = events, name

    def __enter__(self):
        if self.events is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.end.record()
            self.events.append((self.name, self.start, self.end))
        return False


def bucket_counts(mask: torch.Tensor, col: torch.Tensor, mode: str,
                  n_out: int, *, base: float = 0.0, interval: float = 1.0,
                  bounds: Optional[torch.Tensor] = None,
                  events: Optional[list] = None) -> torch.Tensor:
    """Per-bucket counts int64[n_out] (presence: int32[n_out]) of the docs
    under `mask`: `col` int32 ordinals for "terms" and "presence", an
    int64 or float64 column for "histogram" (`base`, `interval`) and
    "bounded" (`bounds` f64[n_out], ascending)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _check(mask, col)
    if mode in ("terms", "presence") and col.dtype != torch.int32:
        raise ValueError(f"{mode} counts int32 ordinals, got {col.dtype}")
    if mode == "bounded" and (bounds is None or bounds.shape != (n_out,)
                              or bounds.dtype != torch.float64):
        raise ValueError("bounded counts take bounds f64[n_out]")
    if mask.device.type == "cpu":
        return bucket_counts_plain(mask, col, mode, n_out, base, interval,
                                   bounds)
    with device_context(mask.device):
        return _launch_counts(mask, col, mode, n_out, base, interval,
                              bounds, events)


def _launch_counts(mask, col, mode, n_out, base=0.0, interval=1.0,
                   bounds=None, events=None) -> torch.Tensor:
    dev = mask.device
    presence = mode == "presence"
    out = torch.zeros(n_out, dtype=torch.int32 if presence else torch.int64,
                      device=dev)
    if bounds is not None:
        bounds = bounds.to(dev).contiguous()
    lib = _lib()
    with _Timer(events, "agg_bucket_counts"):
        err = lib.es_agg_bucket_counts(
            MODES.index(mode), _kind(col), col.contiguous().data_ptr(),
            mask.contiguous().view(torch.uint8).data_ptr(), mask.numel(),
            flush64(base), flush64(interval),
            None if bounds is None else bounds.data_ptr(), n_out,
            int(n_out <= K1_SMEM_BINS), None if presence else out.data_ptr(),
            out.data_ptr() if presence else None, _stream(dev))
    _raise(lib, err, "agg_bucket_counts")
    _count("agg_bucket_counts")
    return out


def masked_stats(mask: torch.Tensor, col: torch.Tensor, *,
                 events: Optional[list] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(count int64[1], f64[3] sum, min, max) of an int64 or float64
    column under `mask` (+inf / -inf min / max when nothing counts)."""
    _check(mask, col)
    if col.dtype not in (torch.int64, torch.float64):
        raise ValueError(f"a numeric column is int64 or float64, got "
                         f"{col.dtype}")
    if mask.device.type == "cpu":
        return masked_stats_plain(mask, col)
    with device_context(mask.device):
        return _launch_stats(mask, col, events)


def _launch_stats(mask, col, events=None):
    dev = mask.device
    n = mask.numel()
    lib = _lib()
    doubles = ctypes.c_longlong(0)
    lib.es_agg_stats_scratch(n, ctypes.byref(doubles))
    scratch = torch.empty(max(1, doubles.value), dtype=torch.float64,
                          device=dev)
    keys = torch.empty(2, dtype=torch.int64, device=dev)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    out = torch.empty(3, dtype=torch.float64, device=dev)
    with _Timer(events, "agg_masked_stats"):
        err = lib.es_agg_masked_stats(
            _kind(col), col.contiguous().data_ptr(),
            mask.contiguous().view(torch.uint8).data_ptr(), n,
            scratch.data_ptr(), keys.data_ptr(), count.data_ptr(),
            out.data_ptr(), _stream(dev))
    _raise(lib, err, "agg_masked_stats")
    _count("agg_masked_stats")
    return count, out


def ord_stats(mask: torch.Tensor, ords: torch.Tensor, col: torch.Tensor,
              n_out: int, *, events: Optional[list] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """Per ordinal (int32 `ords`, -1 none) of the docs under `mask` with a
    value in `col` (int64 or float64): (counts int64[n_out], sums, mins,
    maxs f64[n_out]); an empty ordinal sums to 0 with min +inf and max
    -inf."""
    _check(mask, ords, col)
    if ords.dtype != torch.int32:
        raise ValueError(f"ordinals are int32, got {ords.dtype}")
    if col.dtype not in (torch.int64, torch.float64):
        raise ValueError(f"a numeric column is int64 or float64, got "
                         f"{col.dtype}")
    if mask.device.type == "cpu":
        return ord_stats_plain(mask, ords, col, n_out)
    with device_context(mask.device):
        return _launch_ord_stats(mask, ords, col, n_out, events)


def k3_chunks(n: int, n_out: int) -> Tuple[int, int]:
    """K3's (docs a chunk, chunks) for n docs and n_out ordinals."""
    if n <= 0:
        return 1, 0
    n_chunks = max(1, min(-(-n // K3_CHUNK_MIN),
                          max(1, K3_TABLE_CELLS // max(1, n_out))))
    chunk = -(-n // n_chunks)
    return chunk, -(-n // chunk)


def _launch_ord_stats(mask, ords, col, n_out, events=None):
    dev = mask.device
    n = mask.numel()
    chunk, n_chunks = k3_chunks(n, n_out)
    table = torch.zeros(max(1, n_chunks * n_out), dtype=torch.int32,
                        device=dev)
    starts = torch.empty(max(1, n_out), dtype=torch.int64, device=dev)
    grouped = torch.empty(max(1, n), dtype=torch.float64, device=dev)
    counts = torch.empty(n_out, dtype=torch.int64, device=dev)
    sums = torch.empty(n_out, dtype=torch.float64, device=dev)
    mins = torch.empty_like(sums)
    maxs = torch.empty_like(sums)
    lib = _lib()
    with _Timer(events, "agg_ord_stats"):
        err = lib.es_agg_ord_stats(
            _kind(col), ords.contiguous().data_ptr(),
            col.contiguous().data_ptr(),
            mask.contiguous().view(torch.uint8).data_ptr(), n, n_out, chunk,
            n_chunks, table.data_ptr(), starts.data_ptr(),
            grouped.data_ptr(), counts.data_ptr(), sums.data_ptr(),
            mins.data_ptr(), maxs.data_ptr(), _stream(dev))
    _raise(lib, err, "agg_ord_stats")
    _count("agg_ord_stats")
    return counts, sums, mins, maxs
