"""Time the merge kernels of one checkout on one fixed train, to compare
two checkouts on the same card.

    python3 elasticsearch_tpu_torch/tools/kernel_ab.py --root DIR

imports ``elasticsearch_tpu_torch`` and ``chip_smoke`` from DIR (a
checkout; the default is this one), builds chip_smoke's 1M-document
index, lowers its first 128 bodies into one train (16 shards x 128
queries, kernel k 1024: no batching window decides the operands), and
prints one JSON line: the card, the launch's lane and key counts, and
the median ms of each kernel over chip_smoke's TIMED launches (CUDA
events around each launch, so a launch the device waits for counts its
wait), under "device_ms" each kernel's mean device time over the same
number of launches from torch.profiler (no wait counted); under "exact"
the same for exact_merge on the train's bodies at boost 1e-15
(chip_smoke's exact_bodies: one exact launch, its top-k apart); under
"extra" the same for the launches past the main traffic (extra_bodies:
a match of the corpus's most frequent terms at from +
size 1000 and at from + size 10,000, and the fixed train's bodies at
size 10, kernel k 128), each lowered into one train, with its lanes and
the slots whose lanes reach kernel k (those slot_decode selects in).
Compare two checkouts within one call, in turns: A, B, B, A.

    python3 elasticsearch_tpu_torch/tools/kernel_ab.py --raw --root DIR

does the same for the pruned tiers' kernels on chip_smoke's raw
deployment (its corpus over RAW_SHARDS shards: a raw pack): the fixed
train (the first 128 bodies, kernel k 1024) and chip_smoke's prefix
probes are recorded through its RawRecorder, and each recorded call is
timed alone: pruned_candidates on the train's widest phase-A group,
pruned_order on its widest order-only call and pruned_rescore on the
probes' widest scoring call (score and order). "ms" is the median of
TIMED CUDA-event brackets around the wrapper call, "device_ms" the mean
device time of every kernel the call runs (torch.profiler), and "same"
says that the call gave the recorded outputs bit for bit. Under
"shard_topk.phase_a", shard_topk on the widest row phase A gave it (the
top-k over the shards' candidate lists, inside a pruned tier) in those
calls and in chip_smoke's from + size 10,000 stop-word bodies, timed as
chip_smoke's kernels line times shard_topk: its ms and device ms, the
plain stable sort's and torch.topk's ms on the same tensor, the bytes
bound; "widths" counts the drives' shard_topk calls by drive (the
fixed train, the probes, the stop-word bodies), tier ("outside a tier":
an exact launch's cross-shard top-k, not phase A's), shape and k.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

HERE_ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE_ROOT))
    ap.add_argument("--raw", action="store_true",
                    help="time the pruned tiers' kernels instead")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from elasticsearch_tpu_torch.benchmark import corpus as corpus_mod
    from elasticsearch_tpu_torch.ops import merge_kernel as mk
    from elasticsearch_tpu_torch.search.gpu_service import GpuSearchService

    corpus = corpus_mod.generate(cs.N_DOCS, vocab_size=cs.VOCAB,
                                 num_queries=cs.N_QUERIES, seed=cs.SEED)
    svc = GpuSearchService(device="cuda:0", max_batch=128)
    if args.raw:
        try:
            out = raw_calls(svc, mk, cs, corpus)
        finally:
            svc.close()
        print(json.dumps(dict(root=root, device=cs.smi_line(), **out)),
              flush=True)
        return 0
    try:
        cs.build_index(svc, cs.INDEX, corpus, cs.N_DOCS, cs.SHARDS)
        bodies = cs.make_bodies(corpus)[:128]
        launch, kw = fixed_train(svc, mk, cs.LaunchRecorder, cs.INDEX,
                                 cs.FIELD, cs.K, bodies)
        stats = {}
        mk.fused_merge_topk(*launch, **dict(kw, stats=stats))
        for _ in range(3):
            mk.fused_merge_topk(*launch, **kw)
        ms = cs.time_events(
            lambda ev: mk.fused_merge_topk(*launch, **dict(kw, events=ev)),
            cs.TIMED)
        device_ms = profiled(lambda: mk.fused_merge_topk(*launch, **kw),
                             cs.TIMED)
        ex_args, ex_kw = fixed_train(svc, mk, cs.exact_recorder, cs.INDEX,
                                     cs.FIELD, cs.K, cs.exact_bodies(bodies))
        for _ in range(3):
            mk.exact_merge_topk(*ex_args, **ex_kw)
        exact = dict(
            rows=ex_args[2].shape[0], slots=ex_args[2].shape[1],
            ms=cs.time_events(lambda ev: mk.exact_merge_topk(
                *ex_args, **dict(ex_kw, events=ev)), cs.TIMED)["exact_merge"],
            device_ms=profiled(lambda: mk.exact_merge_topk(*ex_args, **ex_kw),
                               cs.TIMED).get("exact_merge"))
        del ex_args, ex_kw
        extra = {}
        for label, size, queries in extra_bodies(corpus.vocab, cs.FIELD,
                                                 cs.K, cs.MAX_K, bodies):
            a, akw = fixed_train(svc, mk, cs.LaunchRecorder, cs.INDEX,
                                 cs.FIELD, size, queries)
            mk.fused_merge_topk(*a, **akw)
            lengths = a[3]
            kk = min(akw["k"], lengths.shape[1] * akw["max_len"])
            extra[label] = dict(
                rows=a[2].shape[0], slots=a[2].shape[1], k=akw["k"],
                lanes=int(lengths.clamp(min=0).sum()),
                select_slots=int((lengths >= kk).sum()),
                ms=cs.time_events(lambda ev: mk.fused_merge_topk(
                    *a, **dict(akw, events=ev)), 5),
                device_ms=profiled(lambda: mk.fused_merge_topk(*a, **akw),
                                   5))
    finally:
        svc.close()
    print(json.dumps({
        "root": root, "device": cs.smi_line(),
        "shape": {"rows": launch[2].shape[0], "slots": launch[2].shape[1],
                  "k": kw["k"]},
        "lanes": stats["lanes"], "kth_lanes": stats["kth_lanes"],
        "select_slots": int((launch[3] >= stats["kk"]).sum()),
        "keys": stats["keys"],
        "count_keys": stats["count_keys"],
        "candidates": stats["candidates"], "ms": ms,
        "device_ms": device_ms, "exact": exact, "extra": extra}),
          flush=True)
    return 0


KERNELS = ("slot_decode", "row_pack", "row_sort", "run_sum",
           "select_rescore", "shard_topk", "exact_merge")
#: the CUDA functions each kernel's launch runs (shard_topk's device
#: class adds its select passes, runs and rank merge; exact_merge its
#: finishing kernel)
FUNCTIONS = {name: (name,) for name in KERNELS}
FUNCTIONS["shard_topk"] = ("shard_topk", "topk_pass", "topk_runs",
                           "topk_merge")
FUNCTIONS["exact_merge"] = ("exact_merge", "exact_finish")


#: profiler sessions tried for one measurement: in a long process a
#: session sometimes ends with the launches listed but some or all of
#: the device's kernel records missing, and the next one has them
PROFILE_TRIES = 3


def profiled(fn, n, functions=None):
    """Mean device ms per call of each merge kernel (all its FUNCTIONS,
    or of `functions`: name -> CUDA function names, each matched as
    "<name>_kernel") over n calls of fn, from torch.profiler's CUDA
    activity ({} when no session of PROFILE_TRIES was whole: every
    matched kernel with at least n records, one a call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out, short = {}, False
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            name = next((k for k, fns in (functions or FUNCTIONS).items()
                         if any(f"{f}_kernel" in ev.key for f in fns)),
                        None)
            if name is not None and us > 0:
                out[name] = out.get(name, 0.0) + us / 1e3 / n
                short |= ev.count < n
        if out and not short:
            return out
    return {}


def raw_calls(svc, mk, cs, corpus):
    """The --raw measurement: chip_smoke's raw deployment built through
    `svc`, its fixed train and prefix probes recorded, and the widest
    recorded pruned_candidates, pruned_order and pruned_rescore calls
    timed alone → {entry: {shape, ms, device_ms, same}}."""
    import torch

    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.gpu_service import lower_query

    cs.build_index(svc, cs.RAW_INDEX, corpus, cs.N_DOCS, cs.RAW_SHARDS)
    mapper = svc._index(cs.RAW_INDEX).mapper
    flats = [lower_query(dsl.parse_query(b["query"]), mapper)
             for b in cs.make_bodies(corpus)[:128]]
    topk_calls = []   # (drive, tier or None, (vals, k, got_v, got_p))

    def phase_a(drive, raw):
        """shard_topk recorded while `raw` runs, tagged with the drive and
        the pruned tier it ran in (None: outside one, not phase A)."""
        return cs.TopkRecorder(mk, tag=lambda: (drive, getattr(
            raw.tier, "name", None)))

    def keep(top):
        topk_calls.extend((*tag, call) for tag, call
                          in zip(top.tags, top.calls))

    with cs.RawRecorder(mk) as fixed, phase_a("fixed", fixed) as top:
        svc._execute(svc.resident(cs.RAW_INDEX, cs.FIELD), flats, cs.K)
    keep(top)
    with cs.RawRecorder(mk) as probes, phase_a("probes", probes) as top:
        cs.drive(svc, cs.RAW_INDEX, cs.raw_probe_bodies(corpus.vocab))
    keep(top)
    (_, _, k10000), = [e for e in extra_bodies(
        corpus.vocab, cs.FIELD, cs.K, cs.MAX_K, []) if e[0] == "k10000"]
    with cs.RawRecorder(mk) as wide, phase_a("k10000", wide) as top:
        cs.drive(svc, cs.RAW_INDEX, k10000)
    keep(top)
    del top

    def widest(calls, name, size):
        own = [c for c in calls if c[0] == name]
        return max(own, key=size) if own else None

    picks = {
        "pruned_candidates": widest(
            fixed.calls, "pruned_candidates",
            lambda c: int(c[1][3].clamp(min=0, max=c[2]["max_len"]).sum())),
        "pruned_order": widest(fixed.calls, "pruned_order",
                               lambda c: c[1][0].numel()),
        "pruned_rescore": widest(probes.calls, "pruned_rescore",
                                 lambda c: c[1][2].numel())}
    out = {}
    for name, call in picks.items():
        if call is None:
            continue
        _, args, kw, want = call
        kw = {k: v for k, v in kw.items() if k not in ("stats", "events")}
        fn = getattr(mk, name)
        got = fn(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        same = all(torch.equal(g.view(torch.int32) if g.is_floating_point()
                               else g, w.view(torch.int32)
                               if w.is_floating_point() else w)
                   for g, w in zip(got, want))
        kernel = "pruned_rescore" if name == "pruned_order" else name
        out[name] = dict(
            shape=[list(a.shape) for a in args[:3] if a is not None],
            ms=cs.time_events(lambda ev: fn(*args, **dict(kw, events=ev)),
                              cs.TIMED)[kernel],
            device_ms=profiled(lambda: fn(*args, **kw), cs.TIMED,
                               {"all": ("",)}).get("all"),
            same=same)
    widths = {}
    for drive, tier, (vals, k, *_) in topk_calls:
        key = (f"{drive} {tier or 'outside a tier'} "
               f"[{vals.shape[0]}, {vals.shape[1]}] k {k}")
        widths[key] = widths.get(key, 0) + 1
    in_tier = [c for _, tier, c in topk_calls if tier is not None]
    vals, k, got_v, got_p = max(in_tier, key=lambda c: c[0].shape[1])
    want_v, want_p = mk.shard_topk_plain(vals, k)
    entry = cs.topk_entry(mk, "merge_topk.shard_topk.phase_a", vals, k,
                          {"shard_topk": len(in_tier)}, 1)
    entry.update(same=bool(torch.equal(got_v.view(torch.int32),
                                       want_v.view(torch.int32))
                           and torch.equal(got_p, want_p)),
                 widths=dict(sorted(widths.items())))
    out["shard_topk.phase_a"] = entry
    return out


def extra_bodies(vocab, field, k, max_k, bodies):
    """[(label, from + size, bodies)] of the launches past the main
    traffic: matches of the corpus's four most frequent terms (the Zipf
    head fills 4096-lane slots: T >= 16, rows past every shared-memory
    class) at k and at from + size max_k, and `bodies` (the fixed
    train's) at Elasticsearch's default size 10, kernel k 128, where
    every slot of 128 lanes or more selects its k-th lane bound."""
    head = vocab[:4]
    out = [(label, size, [{"query": {"match": {field: text}},
                           "size": size} for text in texts])
           for label, texts, size in (
               ("stopwords", (f"{head[0]} {head[1]}", f"{head[0]} "
                              f"{head[2]}", f"{head[1]} {head[3]}"), k),
               ("k10000", (head[0], f"{head[0]} {head[1]}"), max_k))]
    out.append(("size10", 10, [dict(b, size=10) for b in bodies]))
    return out


def fixed_train(svc, mk, recorder, index, field, k, bodies):
    """The operands (args, keywords) of the one launch that `bodies`,
    lowered and run as one train of from + size k through the service,
    give the merge kernel; `recorder` is chip_smoke's LaunchRecorder."""
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.gpu_service import lower_query
    mapper = svc._index(index).mapper
    flats = [lower_query(dsl.parse_query(b["query"]), mapper)
             for b in bodies]
    with recorder(mk) as rec:
        svc._execute(svc.resident(index, field), flats, k)
    (launch, kw), = rec.shapes.values()
    return launch, kw


if __name__ == "__main__":
    sys.exit(main())
