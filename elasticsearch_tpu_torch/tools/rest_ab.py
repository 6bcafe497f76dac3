"""Time chip_smoke's REST waves on one checkout, to compare two
checkouts' batchers on the same card.

    python3 elasticsearch_tpu_torch/tools/rest_ab.py --root DIR [--docs N]

imports ``elasticsearch_tpu_torch`` and ``chip_smoke`` from DIR (a
checkout; the default is this one), starts a node over HTTP on one card
(its data under DIR/data/rest_ab) as chip_smoke's ``rest`` line does:
its 16-shard body index, the node's default batching window and cap;
loads the first N documents of
chip_smoke's corpus by ``_bulk`` (default 200,000 of its 1M: the
ingest is the run's cost), builds the pack, runs the 256 bodies once
untimed, then ROUNDS times the two waves of the ``rest`` line: the
bodies as they are (1000 hits with ``_source``) and with ``"_source":
false``, from chip_smoke's 128 keep-alive clients. Prints one JSON
line: the card, the index, and per wave and round its q/s, the
``batch_wait`` stage (mean, p50, p95, p99 ms), the means of its
``batch_wait.{queue,window,dispatch,completion}`` split where the
checkout records one, the most trains in flight at once where the
checkout counts them, the trains by size, and a digest of the hits'
ids and scores (two checkouts that answer alike print equal digests).
Compare two checkouts within one call, in turns: A, B, B, A.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
from pathlib import Path

HERE_ROOT = Path(__file__).resolve().parents[2]


def hits_digest(responses) -> str:
    h = hashlib.sha256()
    for r in responses:
        for hit in r["hits"]["hits"]:
            h.update(f"{hit['_id']}:{hit['_score']!r};".encode())
        h.update(b"|")
    return h.hexdigest()[:16]


def wave(cs, host, port, node, bodies):
    """One wave of `bodies` → its numbers."""
    svc = node.gpu_search
    batcher = svc.batcher
    svc.stages.reset()
    batcher.batch_sizes.clear()
    if hasattr(batcher, "max_inflight"):
        batcher.max_inflight = 0
    responses, wall = cs.rest_queries(host, port, bodies)
    stages = svc.stages.snapshot()
    bw = stages.get("batch_wait", {})
    out = {"queries": len(responses), "wall_s": wall,
           "qps": len(responses) / wall,
           "batch_wait_ms": {n: bw.get(f"{n}_ms")
                             for n in ("mean", "p50", "p95", "p99")},
           "trains": dict(sorted(batcher.batch_sizes.items())),
           "hits": hits_digest(responses)}
    split = {part: stages[f"batch_wait.{part}"]["mean_ms"]
             for part in ("queue", "window", "dispatch", "completion")
             if f"batch_wait.{part}" in stages}
    if split:
        out["batch_wait_split_mean_ms"] = split
    if hasattr(batcher, "max_inflight"):
        out["max_inflight"] = batcher.max_inflight
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE_ROOT))
    ap.add_argument("--docs", type=int, default=200_000)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("rest_ab: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from elasticsearch_tpu_torch.benchmark import corpus as corpus_mod
    from elasticsearch_tpu_torch.node import Node, serve
    from elasticsearch_tpu_torch.parallel.mesh import make_mesh

    corpus = corpus_mod.generate(args.docs, vocab_size=cs.VOCAB,
                                 num_queries=cs.N_QUERIES, seed=cs.SEED)
    bodies = cs.make_bodies(corpus)
    data = os.path.join(root, "data", "rest_ab")
    shutil.rmtree(data, ignore_errors=True)
    node = Node(data, mesh=make_mesh(devices=[torch.device("cuda", 0)]))
    server = serve(node, "127.0.0.1", 0)
    host, port = server.server_address
    try:
        status, resp = cs.rest_http(host, port, "PUT", f"/{cs.REST_INDEX}",
                                    {"settings": {
                                        "number_of_shards": cs.SHARDS,
                                        "translog": {"durability": "async"}},
                                     "mappings": {"properties": {
                                         cs.FIELD: {"type": "text"}}}})
        if status != 200:
            raise AssertionError(f"PUT index: {resp}")
        ingest_s = cs.rest_bulk_load(host, port, corpus, args.docs)
        for path in (f"/{cs.REST_INDEX}/_forcemerge",
                     f"/{cs.REST_INDEX}/_refresh"):
            status, resp = cs.rest_http(host, port, "POST", path)
            if status != 200:
                raise AssertionError(f"{path}: {resp}")
        cs.rest_queries(host, port, bodies[:8])      # builds the pack
        cs.rest_queries(host, port, bodies)          # warm, untimed
        runs = {"source": [], "nosource": []}
        for _ in range(args.rounds):
            for label, source in (("source", True), ("nosource", False)):
                runs[label].append(wave(
                    cs, host, port, node,
                    [dict(b, _source=source) for b in bodies]))
        out = {"root": root, "device": cs.smi_line(), "docs": args.docs,
               "shards": cs.SHARDS, "clients": cs.REST_CLIENTS,
               "window_s": node.gpu_search.batcher.window_s,
               "max_batch": node.gpu_search.batcher.max_batch,
               "ingest_s": ingest_s, "runs": runs}
    finally:
        server.shutdown()
        node.close()
        shutil.rmtree(data, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
