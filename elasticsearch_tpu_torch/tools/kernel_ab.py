"""Time the merge kernels of one checkout on one fixed train, to compare
two checkouts on the same card.

    python3 elasticsearch_tpu_torch/tools/kernel_ab.py --root DIR

imports ``elasticsearch_tpu_torch`` and ``chip_smoke`` from DIR (a
checkout; the default is this one), builds chip_smoke's 1M-document
index, lowers its first 128 bodies into one train (16 shards x 128
queries, kernel k 1024: no batching window decides the operands), and
prints one JSON line: the card, the launch's lane and key counts, and
the median ms of each kernel over chip_smoke's TIMED launches (CUDA
events).
Compare two checkouts within one call, in turns: A, B, B, A.
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
    svc = GpuSearchService(max_batch=128)
    try:
        cs.build_index(svc, cs.INDEX, corpus, cs.N_DOCS, cs.SHARDS)
        launch, kw = fixed_train(svc, mk, cs.LaunchRecorder, cs.INDEX,
                                 cs.FIELD, cs.K, cs.make_bodies(corpus)[:128])
        stats = {}
        mk.fused_merge_topk(*launch, **dict(kw, stats=stats))
        for _ in range(3):
            mk.fused_merge_topk(*launch, **kw)
        ms = cs.time_events(
            lambda ev: mk.fused_merge_topk(*launch, **dict(kw, events=ev)),
            cs.TIMED)
    finally:
        svc.close()
    print(json.dumps({
        "root": root, "device": cs.smi_line(),
        "shape": {"rows": launch[2].shape[0], "slots": launch[2].shape[1],
                  "k": kw["k"]},
        "lanes": stats["lanes"], "keys": stats["keys"],
        "count_keys": stats["count_keys"],
        "candidates": stats["candidates"], "ms": ms}), flush=True)
    return 0


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
