#!/usr/bin/env python3
"""Smoke run of elasticsearch_tpu_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from elasticsearch_tpu_torch/csrc
(nvcc, into elasticsearch_tpu_torch/_build/), indexes a 1M-document
synthetic MS MARCO-passage-shaped corpus into 16 compressed shards on the
card, answers 256 `_search` bodies (match OR / AND / minimum_should_match)
through GpuSearchService from many threads, and checks:

  device         nvidia-smi name and power limit, torch and CUDA versions
  build          kernel build seconds; corpus, shards, postings; resident
                 bytes of the compressed pack
  kernel_parity  every launch shape the main path used, plus a u8-delta
                 doc stream index, a match of the corpus's most frequent
                 terms (full 4096-lane slots, T >= 16: rows past the
                 shared-memory sort and select), from + size 10,000
                 (kernel k 16,384, more candidates than kk) and the
                 fixed train's bodies at size 10 (kernel k 128): the
                 kernels against their plain torch version on the card,
                 scores as uint32, docs and totals exactly, with and
                 without totals; slot_decode's own outputs (kth, group
                 and slot bounds, which the results cannot show) against
                 the plain stages bit for bit; the rows (slots, for
                 slot_decode) each size class took (every class must
                 take some)
  e2e            the counted run: queries, hits, batch sizes, launches per
                 kernel (all must be > 0), compressed_exact launches, and
                 16 sampled queries against the numpy oracle (top-10 ids,
                 scores within rel=1e-5, abs=1e-6)
  trace          the same traffic again with stage timers and
                 torch.profiler: each request's lowering, wait in the
                 batcher (window and queue), train execution and
                 response assembly; device time and idle share
  kernels_extra  the five kernels' ms (median of 5, CUDA events) and
                 device ms (mean of 5, torch.profiler) at the stop-word,
                 from + size 10,000 and size-10 launches, each one train
                 of its bodies, with the slots slot_decode selects in
  kernels        one JSON line: per kernel, median ms over >= 20 timed
                 launches (CUDA events around each launch: a launch the
                 device waits for counts its wait) and device_ms (mean
                 device time from torch.profiler) of one fixed train (the
                 first 128 bodies, 16 shards x 128 queries), launches per
                 train of the
                 counted run, the plain version's ms (the whole plain
                 pipeline), the bytes bound at 3.35 TB/s, torch.sort as
                 the sort's yardstick and torch.topk as slot_decode's
                 (of its kth alone; no single torch call computes what
                 the other three compute: library_ms null, and
                 library_of says why), the size classes the rows of the
                 timed launch took, and the slots slot_decode selected
                 in

The last line is {"ok": true, "device": {...}}; any failure exits
non-zero without it. Without a CUDA device the script exits 2 at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

N_DOCS = 1_000_000      # cut from MS MARCO passage's 8.8M to fit the run
VOCAB = 30_000
SEED = 42
SHARDS = 16
N_QUERIES = 256
K = 1000                # from + size: the kernel's k bucket is 1024
WAVES = (128, 64, 64)   # concurrent client waves → 128- and 64-query trains
ORACLE_SAMPLE = 16
MAX_K = 10_000          # the largest from + size the service takes
TIMED = 25              # timed kernel launches after warm-up
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FIELD = "body"
INDEX = "msmarco"
PALLAS_LINE = "elasticsearch_tpu/ops/pallas_merge.py:155"
KERNEL_SOURCE = "elasticsearch_tpu_torch/csrc/merge_topk.cu"
#: the size-class counters (merge_kernel.SIZE_CLASSES) of each kernel
CLASSES_OF = {"slot_decode": ("slot_decode",), "row_pack": ("row_pack",),
              "row_sort": ("row_sort",),
              "run_sum": ("run_sum",),
              "select_rescore": ("select", "rescore", "final")}
#: the one torch call that computes each kernel's function, or why none
LIBRARY_OF = {
    "slot_decode": "torch.topk(imp, kk, dim=2) on the decoded [R, T, "
                   "max_len] lane bounds of the same launch: the kth "
                   "output only; the decode of the code16 stream and the "
                   "group and slot upper bounds are not in it",
    "row_pack": "none: decode, block-max skip and compaction into packed "
                "keys; torch.masked_select compacts but does not decode "
                "or skip",
    "row_sort": "torch.sort of the same keys, the row id in the high bits",
    "run_sum": "none: segment_reduce sums runs in another order (the "
               "reference's doubling tree is not a torch call) and has no "
               "msm filter or count-key totals",
    "select_rescore": "none: torch.topk breaks ties in no fixed order and "
                      "does not rescore through the residual tables",
}


def log(phase: str, **fields) -> None:
    print(f"{phase}: " + json.dumps(fields, sort_keys=False), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_bodies(corpus):
    """128 OR, 64 AND and 64 minimum_should_match=2 match bodies."""
    bodies = []
    for qi in range(N_QUERIES):
        text = corpus.query_text(qi)
        if qi % 4 == 1:
            spec = {"query": text, "operator": "and"}
        elif qi % 4 == 2:
            spec = {"query": text, "minimum_should_match": 2}
        else:
            spec = {"query": text}
        bodies.append({"query": {"match": {FIELD: spec}}, "size": K})
    return bodies


def drive(svc, index, bodies):
    """Send `bodies` in concurrent waves; → responses in order."""
    out = [None] * len(bodies)
    pos = 0
    with ThreadPoolExecutor(max_workers=max(WAVES)) as pool:
        for wave in WAVES:
            idx = list(range(pos, min(pos + wave, len(bodies))))
            futs = [pool.submit(svc.search, index, bodies[i]) for i in idx]
            for i, f in zip(idx, futs):
                out[i] = f.result()
            pos += wave
        rest = list(range(pos, len(bodies)))
        futs = [pool.submit(svc.search, index, bodies[i]) for i in rest]
        for i, f in zip(rest, futs):
            out[i] = f.result()
    return out


def build_index(svc, name, corpus, n_docs, shards):
    """Route docs by the reference's murmur3 of the _id and build one
    segment per shard from the token ids (array ops; a CPU test holds
    this equal to SegmentWriter)."""
    import numpy as np

    from elasticsearch_tpu_torch.index.segment import segment_from_token_ids
    from elasticsearch_tpu_torch.indices.routing import shard_for

    ids = [f"d{i}" for i in range(n_docs)]
    shard_of = np.array([shard_for(i, shards) for i in ids])
    svc.create_index(name, shards, {"properties": {FIELD: {"type": "text"}}})
    segments = []
    for s in range(shards):
        members = np.nonzero(shard_of == s)[0]
        seg = segment_from_token_ids(
            f"{name}-s{s}", [ids[i] for i in members],
            [corpus.doc_tokens[i] for i in members], corpus.vocab, FIELD)
        svc.add_segment(name, s, seg)
        segments.append(seg)
    return segments


class LaunchRecorder:
    """Wraps merge_kernel.fused_merge_topk while the main path runs and
    keeps the operands of the first launch of every distinct shape."""

    def __init__(self, merge_kernel):
        self.mk = merge_kernel
        self.real = merge_kernel.fused_merge_topk
        self.shapes = {}

    def __enter__(self):
        def record(*args, **kw):
            r, t = args[2].shape
            key = (r, t, kw["max_len"], kw["k"], bool(kw["with_counts"]),
                   kw.get("doc_bases") is not None)
            self.shapes.setdefault(key, (args, dict(kw)))
            return self.real(*args, **kw)
        self.mk.fused_merge_topk = record
        return self

    def __exit__(self, *exc):
        self.mk.fused_merge_topk = self.real


def bitwise_equal(got, want):
    import torch
    if len(got) != len(want):
        return False, float("inf")
    a, b = got[0], want[0]
    same = (torch.equal(a.view(torch.int32), b.view(torch.int32))
            and all(torch.equal(x, y) for x, y in zip(got[1:], want[1:])))
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = float((a[fin].double() - b[fin].double()).abs().max()) \
        if bool(fin.any()) else 0.0
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        err = float("inf")
    return same, err


def kernel_parity(mk, launches):
    """The kernels against their plain version on each recorded launch
    [(label, args, kw)], with and without totals → (entries, worst
    error, rows per size class over all launches)."""
    import torch
    worst = 0.0
    checked = []
    skipping = 0
    classes = dict.fromkeys(mk.SIZE_CLASSES, 0)
    for label, args, kw in launches:
        stats = {}
        got = mk.fused_merge_topk(*args, **dict(kw, stats=stats))
        want = mk.fused_merge_topk_plain(*args, **kw)
        torch.cuda.synchronize()
        same, err = bitwise_equal(got, want)
        worst = max(worst, err)
        # slot_decode's kth, grp_ub and slot_ub: a kth too low would only
        # make the skip drop fewer lanes, which the results cannot show
        slot_diff = None
        if stats["do_skip"]:
            slot_diff = mk.slot_decode_mismatches(
                stats["slot_decode_output"], mk.slot_decode_plain(*args,
                                                                  **kw))
        r, t = args[2].shape
        took = {c: n for c, n in stats["classes"].items() if n}
        for c, n in took.items():
            classes[c] += n
        entry = dict(launch=label, rows=r, slots=t, max_len=kw["max_len"],
                     k=kw["k"], msm_rows=int((args[5] > 1).sum()),
                     delta=kw.get("doc_bases") is not None,
                     with_totals=bool(kw["with_totals"]),
                     skip=bool(stats["do_skip"]),
                     lanes=stats["lanes"], keys_after_skip=stats["keys"],
                     keys_before_skip=stats["count_keys"],
                     candidates=stats["candidates"],
                     select_slots=stats["select_slots"], size_classes=took,
                     bitwise=same,
                     slot_decode_bitwise=None if slot_diff is None
                     else not slot_diff)
        checked.append(entry)
        if stats["count_keys"] > stats["keys"]:
            skipping += 1
        if not same:
            raise AssertionError(f"kernel != plain at shape {entry}, "
                                 f"max_abs_err {err}")
        if slot_diff:
            raise AssertionError(f"slot_decode's {slot_diff} != the plain "
                                 f"stages' at shape {entry}")
        # the same operands without totals (no pre-skip count keys)
        kw2 = dict(kw, with_totals=False)
        same2, err2 = bitwise_equal(mk.fused_merge_topk(*args, **kw2),
                                    mk.fused_merge_topk_plain(*args, **kw2))
        worst = max(worst, err2)
        if not same2:
            raise AssertionError(f"kernel != plain without totals at "
                                 f"{entry}")
        if label == "stopwords" and not (took.get("row_sort.device")
                                         and took.get("select.device")
                                         and took.get("row_pack.split")
                                         and took.get("run_sum.tiled")):
            raise AssertionError(f"the stop-word launch stayed in shared "
                                 f"memory: {entry}")
        if label == "k10000" and not (kw["k"] == mk.K_LIMIT
                                      and took.get("final.trim")):
            raise AssertionError(f"the k = 10,000 launch did not trim "
                                 f"past kk: {entry}")
        if label == "size10 train" and not (kw["k"] == 128 and took.get(
                "slot_decode.select_warp")):
            raise AssertionError(f"the size-10 train did not select in "
                                 f"short slots at kernel k 128: {entry}")
    if not skipping:
        raise AssertionError("no parity shape dropped lanes through the "
                             "block-max skip")
    missing = [c for c, n in classes.items() if not n]
    if missing:
        raise AssertionError(f"size classes no parity launch took: "
                             f"{missing}")
    return checked, worst, classes


def oracle_check(responses, bodies, corpus, segments):
    """Top-10 of sampled queries vs the numpy oracle (per-shard stats,
    ties toward the lower shard, then the lower doc)."""
    import numpy as np

    from elasticsearch_tpu_torch.ops import reference_impl

    sample = list(range(0, N_QUERIES, N_QUERIES // ORACLE_SAMPLE))
    sample = sample[:ORACLE_SAMPLE]
    for qi in sample:
        spec = bodies[qi]["query"]["match"][FIELD]
        terms = spec["query"].split()
        need = (len(terms) if spec.get("operator") == "and"
                else int(spec.get("minimum_should_match", 1)))
        ranked, dense = [], []
        for si, seg in enumerate(segments):
            st = seg.field_stats[FIELD]
            avgdl = st.sum_total_term_freq / st.doc_count
            dfs = {t: seg.doc_freq(FIELD, t) for t in terms}
            scores = reference_impl.score_segment(
                seg, FIELD, terms, doc_count=st.doc_count, avgdl=avgdl,
                doc_freqs=dfs)
            cnt = np.zeros(seg.num_docs, dtype=np.int64)
            for t in terms:
                entry = seg.postings[FIELD].get(t)
                if entry is not None:
                    cnt[entry[0]] += 1
            scores = np.where(cnt >= need, scores, 0.0).astype(np.float32)
            dense.append({seg.doc_ids[d]: float(scores[d])
                          for d in np.nonzero(scores > 0)[0]})
            for d, sc in reference_impl.topk_from_scores(scores, 10):
                ranked.append((-sc, si, d, seg.doc_ids[d]))
        ranked.sort()
        expect = [(doc_id, -neg) for neg, _, _, doc_id in ranked[:10]]
        hits = responses[qi]["hits"]["hits"][:10]
        if len(hits) != len(expect):
            raise AssertionError(f"query {qi}: {len(hits)} hits, oracle "
                                 f"{len(expect)}")
        oracle_of = {}
        for d in dense:
            oracle_of.update(d)
        for pos, (hit, (eid, esc)) in enumerate(zip(hits, expect)):
            if abs(hit["_score"] - esc) > 1e-6 + 1e-5 * abs(esc):
                raise AssertionError(f"query {qi} rank {pos}: score "
                                     f"{hit['_score']} vs oracle {esc}")
            if hit["_id"] != eid:
                # equal ids up to ties: the doc taken must score the same
                # as the oracle's doc at this rank, within the tolerance
                alt = oracle_of.get(hit["_id"], 0.0)
                if abs(alt - esc) > 1e-6 + 1e-5 * abs(esc):
                    raise AssertionError(f"query {qi} rank {pos}: id "
                                         f"{hit['_id']} vs oracle {eid}")
    return sample


def traced_run(svc, bodies, mk):
    """The main path once more, with host-clock timers around the
    service's stages and torch.profiler recording CUDA activity: where a
    request's and a batch's time goes and how long the device sits idle.
    The timer around the kernel call synchronizes the device before and
    after."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from elasticsearch_tpu_torch.parallel import distributed as dist
    from elasticsearch_tpu_torch.search import gpu_service as gs

    spent = {"execute": 0.0, "prepare": 0.0, "kernel_call": 0.0,
             "finish": 0.0}
    lock = threading.Lock()

    def timed(name, fn, sync):
        def wrapper(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if sync:
                    torch.cuda.synchronize()
                with lock:
                    spent[name] += time.perf_counter() - t
        return wrapper

    # per request: search() entry, submit, its train's start and end,
    # search() return (the flat query object names the request; `alive`
    # keeps each one, so no two requests share an id())
    marks, alive = {}, []
    current = threading.local()
    real_search, real_submit = svc.search, svc.batcher.submit
    real_execute = svc.batcher.execute

    def search(name, body):
        t = time.perf_counter()
        resp = real_search(name, body)
        marks[current.flat]["enter"] = t
        marks[current.flat]["leave"] = time.perf_counter()
        return resp

    def submit(resident, flat, k):
        current.flat = id(flat)
        alive.append(flat)
        marks[id(flat)] = {"submit": time.perf_counter()}
        return real_submit(resident, flat, k)

    def execute(resident, flats, k):
        t = time.perf_counter()
        try:
            return real_execute(resident, flats, k)
        finally:
            t_end = time.perf_counter()
            with lock:
                spent["execute"] += t_end - t
            for f in flats:
                marks[id(f)].update(start=t, end=t_end)

    patches = [(dist, "prepare_query_batch", "prepare", False),
               (mk, "fused_merge_topk", "kernel_call", True),
               (gs, "_finish_exact", "finish", False)]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _, _ in patches]
    for obj, attr, name, sync in patches:
        setattr(obj, attr, timed(name, getattr(obj, attr), sync))
    saved += [(svc, "search", real_search),
              (svc.batcher, "submit", real_submit),
              (svc.batcher, "execute", real_execute)]
    svc.search, svc.batcher.submit = search, submit
    svc.batcher.execute = execute
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            drive(svc, INDEX, bodies)
            wall = time.perf_counter() - t0
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    per_name = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            per_name[ev.key] = per_name.get(ev.key, 0.0) + us / 1e3
    busy_ms = sum(per_name.values())
    top = dict(sorted(per_name.items(), key=lambda kv: -kv[1])[:8])
    stages = {"lower": ("enter", "submit"), "batcher_wait": ("submit",
                                                             "start"),
              "train": ("start", "end"), "assemble": ("end", "leave")}
    per_request = {}
    for stage, (a, b) in stages.items():
        ms = sorted((m[b] - m[a]) * 1e3 for m in marks.values())
        per_request[stage] = {"mean_ms": statistics.fmean(ms),
                              "p50_ms": ms[len(ms) // 2],
                              "max_ms": ms[-1]}
    return dict(
        queries=len(bodies), window_s=svc.batcher.window_s,
        per_request=per_request, wall_s=wall,
        batch_execute_s=spent["execute"],
        prepare_query_batch_s=spent["prepare"],
        kernel_call_s=spent["kernel_call"], finish_s=spent["finish"],
        outside_batches_s=wall - spent["execute"],
        device_busy_ms=busy_ms if busy_ms > 0 else "not measured",
        device_idle_share=(1.0 - busy_ms / 1e3 / wall) if busy_ms > 0
        else "not measured",
        top_device_ms=top)


def time_events(fn, n):
    """Median ms per kernel name over n calls of fn(events)."""
    import torch
    per = {}
    for _ in range(n):
        events = []
        fn(events)
        torch.cuda.synchronize()
        call = {}
        for name, start, end in events:
            call[name] = call.get(name, 0.0) + start.elapsed_time(end)
        for name, ms in call.items():
            per.setdefault(name, []).append(ms)
    return {name: statistics.median(v) for name, v in per.items()}


def time_cuda(fn, n):
    """Median ms of fn() over n calls (CUDA events, after one warm-up)."""
    import torch
    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_sort_input(sort_input):
    """The row sort's unsorted keys of every row as one int64 tensor,
    the row id in the high 32 bits: the input of the one library sort
    that computes the same function."""
    import torch
    row_off = sort_input["row_off"]
    out = []
    for keys, n in ((sort_input["keys"], sort_input["n_keys"]),
                    (sort_input["count_keys"], sort_input["n_count_keys"])):
        if keys is None:
            continue
        idx = torch.arange(keys.numel(), device=keys.device)
        row = torch.searchsorted(row_off, idx, right=True) - 1
        valid = idx - row_off[row] < n.to(torch.int64)[row]
        out.append((row[valid] << 32)
                   | (keys[valid].to(torch.int64) & 0xFFFFFFFF))
    return out


def kernel_bounds(stats, doc_bytes):
    """Least bytes each kernel must move for this launch's data: each
    input read once, each output written once."""
    r, t, g = stats["rows"], stats["slots"], stats["n_grp"]
    keys, ckeys = stats["keys"], stats["count_keys"]
    cand, picked, kk = stats["candidates"], stats["picked"], stats["kk"]
    return {
        # the selecting slots' codes and starts, every slot's length,
        # weight, block start and block-max window; kth, slot_ub, grp_ub
        "slot_decode": (stats["kth_lanes"] * 2 + stats["select_slots"] * 4
                        + r * t * 12 + r * t * (g + 1) * 2
                        + r * t * (g + 2) * 4),
        "row_pack": (stats["lanes"] * (doc_bytes + 2) + r * t * g * 4
                     + (keys + ckeys) * 4),
        "row_sort": (keys + ckeys) * 8,
        "run_sum": (keys + ckeys) * 4 + cand * 12 + r * 8,
        # candidates read once; each picked candidate's matched posting
        # at least once (doc, rank, residual value); outputs written once
        "select_rescore": cand * 12 + picked * 7 + r * kk * 8,
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from elasticsearch_tpu_torch.benchmark import corpus as corpus_mod
        from elasticsearch_tpu_torch.ops import _build
        from elasticsearch_tpu_torch.ops import merge_kernel as mk
        from elasticsearch_tpu_torch.search.gpu_service import \
            GpuSearchService
    except ImportError as exc:
        print(f"chip_smoke: the elasticsearch_tpu_torch package is not "
              f"beside this script ({exc})", file=sys.stderr)
        return 3

    smi = smi_line()
    log("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    corpus = corpus_mod.generate(N_DOCS, vocab_size=VOCAB,
                                 num_queries=N_QUERIES, seed=SEED)
    gen_s = time.perf_counter() - t1
    svc = GpuSearchService(max_batch=128)   # the service's own window
    try:
        t2 = time.perf_counter()
        segments = build_index(svc, INDEX, corpus, N_DOCS, SHARDS)
        seg_s = time.perf_counter() - t2
        t3 = time.perf_counter()
        resident = svc.resident(INDEX, FIELD)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t3
        pack = resident.pack
        postings = int(sum(int(rs[-1]) for rs in pack.row_starts))
        from elasticsearch_tpu_torch.parallel import distributed as dist
        log("build", kernel_build_s=round(build_s, 3),
            corpus_s=round(gen_s, 3), segments_s=round(seg_s, 3),
            pack_s=round(pack_s, 3), docs=N_DOCS, shards=SHARDS,
            shard_docs=[s.num_docs for s in segments], d_pad=pack.d_pad,
            postings=postings, vocab=VOCAB, seed=SEED,
            delta_doc_stream=resident.streams.delta,
            delta_reason=dist.delta_pack_reason(pack),
            resident_bytes=resident.nbytes_device(),
            bytes_per_posting=resident.nbytes_device() / postings,
            bytes_per_doc=resident.nbytes_device() / N_DOCS,
            note=("synthetic MS MARCO-passage-shaped corpus, cut from "
                  "8.8M passages to 1M docs to fit the smoke's time limit"))
        bodies = make_bodies(corpus)

        # -- a warm-up pass of the main path, then the counted run; every
        # launch shape of both is recorded for kernel_parity, as are those
        # of single-term top-10 bodies (kernel k 128, where the block-max
        # skip drops lanes of long postings) and of a small u8-delta index
        delta_svc_docs = 3200
        with LaunchRecorder(mk) as rec:
            drive(svc, INDEX, bodies)
            drive(svc, INDEX, [
                {"query": {"term": {FIELD: corpus.vocab[1 + i]}},
                 "size": 10} for i in range(8)])
            build_index(svc, "delta", corpus, delta_svc_docs, SHARDS)
            if not svc.resident("delta", FIELD).streams.delta:
                raise AssertionError("the small index did not take the "
                                     "u8 delta doc stream")
            for wave in (bodies[:64], bodies[64:72]):
                drive(svc, "delta", wave)

            # -- e2e: the counted run ---------------------------------------
            mk.reset_launches()
            svc.variant_launches.clear()
            svc.launch_shapes.clear()
            svc.batcher.batch_sizes.clear()
            t4 = time.perf_counter()
            responses = drive(svc, INDEX, bodies)
            e2e_s = time.perf_counter() - t4
            launches = dict(mk.LAUNCHES)
            trains = dict(sorted(svc.batcher.batch_sizes.items()))
        zero = [n for n, c in launches.items() if c <= 0]
        if zero:
            raise AssertionError(f"kernels not launched on the main path: "
                                 f"{zero}")
        n_trains = sum(trains.values())
        hits = sum(len(r["hits"]["hits"]) for r in responses)
        sample = oracle_check(responses, bodies, corpus, segments)
        log("e2e", queries=len(responses), hits=hits,
            seconds=round(e2e_s, 3), qps=round(len(responses) / e2e_s, 1),
            window_s=svc.batcher.window_s, trains=trains,
            launch_shapes={f"B{b}xT{t}xk{k}": n for (b, t, k), n
                           in sorted(svc.launch_shapes.items())},
            launches=launches,
            variant_launches=dict(svc.variant_launches),
            compressed_exact_launches=svc.variant_launches.get(
                "compressed_exact", 0),
            oracle_checked=len(sample),
            oracle_tolerance="top-10 ids, scores rel=1e-5 abs=1e-6")

        # -- launches past the main traffic: a match of the corpus's most
        # frequent terms (the Zipf head fills 4096-lane slots: T >= 16,
        # rows past the shared-memory sort and select) at k = 1000 and at
        # from + size = 10,000 (kernel k 16,384), and the first 128 bodies
        # at size 10 (kernel k 128): every shape the service gave them,
        # and each label's bodies as one train (timed in kernels_extra)
        from elasticsearch_tpu_torch.tools.kernel_ab import (extra_bodies,
                                                             fixed_train,
                                                             profiled)
        extra, extra_trains = [], []
        for label, size, queries in extra_bodies(corpus.vocab, FIELD,
                                                 K, MAX_K, bodies[:128]):
            with LaunchRecorder(mk) as special:
                answered = drive(svc, INDEX, queries)
            for resp in answered:
                hits = resp["hits"]
                if len(hits["hits"]) != min(size, hits["total"]["value"]):
                    raise AssertionError(f"{label}: {len(hits['hits'])} "
                                         f"hits of {hits['total']}")
            extra += [(label, a, k) for a, k in special.shapes.values()]
            extra_trains.append((label, *fixed_train(
                svc, mk, LaunchRecorder, INDEX, FIELD, size, queries)))
        # the launch the kernels line times: the first 128 bodies as one
        # 128-query train (no batching window decides its operands, so two
        # runs time the same launch)
        fixed = fixed_train(svc, mk, LaunchRecorder, INDEX, FIELD, K,
                            bodies[:128])
        launches_checked = [("main", a, k) for a, k in rec.shapes.values()]
        launches_checked.append(("fixed", *fixed))
        checked, worst, classes = kernel_parity(
            mk, launches_checked + extra
            + [(f"{label} train", a, k) for label, a, k in extra_trains])
        log("kernel_parity", shapes=checked, max_abs_err=worst,
            size_classes=classes,
            tolerance="bitwise: scores as uint32, docs and totals exact")

        # -- trace: a second run with stage timers and the profiler -------
        log("trace", **traced_run(svc, bodies, mk))

        # -- kernels: timings on the fixed train ----------------------------
        args, kw = fixed
        stats = {}
        mk.fused_merge_topk(*args, **dict(kw, stats=stats))
        for _ in range(3):
            mk.fused_merge_topk(*args, **kw)
        ms = time_events(
            lambda ev: mk.fused_merge_topk(*args, **dict(kw, events=ev)),
            TIMED)
        device_ms = profiled(lambda: mk.fused_merge_topk(*args, **kw),
                             TIMED)
        # the plain version is one pipeline: its time stands in each row
        plain_ms = time_cuda(
            lambda: mk.fused_merge_topk_plain(*args, **kw), 5)
        lib_input = library_sort_input(stats.pop("sort_input"))
        library = {"row_sort": time_cuda(
            lambda: [torch.sort(keys) for keys in lib_input], TIMED)}
        # slot_decode's yardstick: the k-th largest of the decoded lane
        # bounds, which is its kth output alone
        from elasticsearch_tpu_torch.ops import sparse
        _, imp = sparse._lane_decode(
            *args[:5], max_len=kw["max_len"], d_pad=kw["d_pad"],
            exact=False, doc_bases=kw.get("doc_bases"),
            dbs_starts=kw.get("dbs_starts"), dlo_starts=kw.get("dlo_starts"))
        library["slot_decode"] = time_cuda(
            lambda: torch.topk(imp, stats["kk"], dim=2), TIMED)
        del imp
        bounds = kernel_bounds(stats, 2 - stats["delta"])
        kernels = []
        for name in ("slot_decode", "row_pack", "row_sort", "run_sum",
                     "select_rescore"):
            kernels.append({
                "name": f"merge_topk.{name}", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": PALLAS_LINE,
                "launches": launches[name], "max_abs_err": worst,
                "ms": ms[name], "device_ms": device_ms.get(name),
                "plain_ms": plain_ms,
                "plain_of": "fused_merge_topk_plain, all five stages",
                "bound_ms": bounds[name] / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "library_ms": library.get(name),
                "library_of": LIBRARY_OF[name],
                "launches_per_batch": launches[name] / n_trains,
                "shape": {"rows": args[2].shape[0],
                          "slots": args[2].shape[1],
                          "max_len": kw["max_len"], "k": kw["k"]},
                "bytes": bounds[name],
                "size_classes": {
                    c: n for c, n in stats["classes"].items()
                    if c.split(".")[0] in CLASSES_OF.get(name, ())}})
            if name == "slot_decode":
                kernels[-1]["select_slots"] = stats["select_slots"]
        # the kernels at the launches past the main traffic, each one train
        log("kernels_extra", launches=[dict(
            launch=label, rows=a[2].shape[0], slots=a[2].shape[1],
            k=kw["k"], select_slots=int((a[3] >= min(
                kw["k"], a[3].shape[1] * kw["max_len"])).sum()),
            ms=time_events(
                lambda ev: mk.fused_merge_topk(*a, **dict(kw, events=ev)),
                5),
            device_ms=profiled(lambda: mk.fused_merge_topk(*a, **kw), 5))
            for label, a, kw in extra_trains])
        print(json.dumps({"kernels": kernels}), flush=True)
    finally:
        svc.close()

    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
