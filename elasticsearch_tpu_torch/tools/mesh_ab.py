"""Serve chip_smoke's traffic on one card and on every card of the
machine, to compare the (1, 1) mesh with the (1, n) mesh on one host.

    python3 elasticsearch_tpu_torch/tools/mesh_ab.py [--rounds 2]

builds chip_smoke's 1M-document, 16-shard index once, places it in two
services, one on ``make_mesh()`` pinned to cuda:0 (shape (1, 1)) and one
on ``make_mesh()`` (every visible card on the shards axis, (1, n)), and
runs in turns, `rounds` times over (1, 1), (1, n), (1, n) with its
device bodies run at once, one pool thread a device (``threads``, in
place of ``distributed._run_bodies``, which runs them one after
another), and back:

- one fixed train (chip_smoke's first 128 bodies lowered into one
  ``_execute``: host prep, the step, the decode), median ms of 15;
- chip_smoke's 256 bodies from 128 client threads in its waves: wall
  seconds and queries per second.

Every run's hits must equal the first run's bit for bit (same segments,
so the same ordinals and tie order). Prints one JSON line: the card's
``nvidia-smi`` name and power limit, the card count, and per run its
mesh, the train's ms, q/s and kernel launches. Needs at least two cards.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE_ROOT = Path(__file__).resolve().parents[2]
TRAIN_REPS = 15


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE_ROOT))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("mesh_ab: needs two CUDA devices or more", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from elasticsearch_tpu_torch.benchmark import corpus as corpus_mod
    from elasticsearch_tpu_torch.ops import _build
    from elasticsearch_tpu_torch.ops import merge_kernel as mk
    from elasticsearch_tpu_torch.parallel import distributed as dist
    from elasticsearch_tpu_torch.parallel.mesh import make_mesh
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.gpu_service import (GpuSearchService,
                                                             lower_query)

    _build.build_all()
    corpus = corpus_mod.generate(cs.N_DOCS, vocab_size=cs.VOCAB,
                                 num_queries=cs.N_QUERIES, seed=cs.SEED)
    bodies = cs.make_bodies(corpus)
    one = GpuSearchService(mesh=make_mesh([torch.device("cuda", 0)]),
                           max_batch=128)
    every = GpuSearchService(mesh=make_mesh(), max_batch=128)
    run_bodies = dist._run_bodies

    pool = ThreadPoolExecutor(max_workers=torch.cuda.device_count())

    def threads(jobs):
        return [f.result() for f in [pool.submit(job) for job in jobs]]

    try:
        segments = cs.build_index(one, cs.INDEX, corpus, cs.N_DOCS,
                                  cs.SHARDS)
        every.create_index(cs.INDEX, cs.SHARDS,
                           {"properties": {cs.FIELD: {"type": "text"}}})
        for s, seg in enumerate(segments):
            every.add_segment(cs.INDEX, s, seg)
        services = {"1x1": one, "1xn": every, "1xn_threads": every}
        for svc in (one, every):
            cs.drive(svc, cs.INDEX, bodies[:128])   # places the pack
        flats = [lower_query(dsl.parse_query(b["query"]),
                             one._index(cs.INDEX).mapper)
                 for b in bodies[:128]]
        order = ["1x1", "1xn", "1xn_threads"]
        runs, first_hits = [], None
        for _ in range(args.rounds):
            for label in order + order[::-1]:
                svc = services[label]
                dist._run_bodies = (threads if label.endswith("threads")
                                    else run_bodies)
                resident = svc.resident(cs.INDEX, cs.FIELD)
                svc._execute(resident, flats, cs.K)
                train_ms = []
                for _ in range(TRAIN_REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    svc._execute(resident, flats, cs.K)
                    train_ms.append((time.perf_counter() - t0) * 1e3)
                mk.reset_launches()
                t0 = time.perf_counter()
                responses = cs.drive(svc, cs.INDEX, bodies)
                wall = time.perf_counter() - t0
                hits = cs.hits_of(responses)
                if first_hits is None:
                    first_hits = hits
                elif hits != first_hits:
                    raise AssertionError(f"{label}: hits differ from the "
                                         f"first run's")
                runs.append(dict(
                    run=label, mesh=str(resident.image.mesh),
                    train_ms_median=statistics.median(train_ms),
                    train_ms_min=min(train_ms), seconds=wall,
                    qps=len(responses) / wall,
                    launches=dict(mk.LAUNCHES)))
                print(json.dumps(runs[-1]), file=sys.stderr, flush=True)
    finally:
        dist._run_bodies = run_bodies
        one.close()
        every.close()
        pool.shutdown()
    summary = {}
    for label in order:
        mine = [r for r in runs if r["run"] == label]
        summary[label] = dict(
            train_ms_median=statistics.median(r["train_ms_median"]
                                               for r in mine),
            qps_median=statistics.median(r["qps"] for r in mine))
    print(json.dumps(dict(nvidia_smi=cs.smi_line(),
                          cards=torch.cuda.device_count(),
                          docs=cs.N_DOCS, shards=cs.SHARDS,
                          queries=len(bodies), train_queries=len(flats),
                          hits_equal="every run's hits equal the first "
                                     "(1, 1) run's, bit for bit",
                          summary=summary, runs=runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
