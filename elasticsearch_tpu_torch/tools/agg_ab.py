"""Time the aggregation kernels of one checkout on chip_smoke's aggs
line's in-process calls, to compare two checkouts on the same card.

    python3 elasticsearch_tpu_torch/tools/agg_ab.py [--root DIR]

imports ``elasticsearch_tpu_torch`` and ``chip_smoke`` from DIR (a
checkout; the default is this one), makes chip_smoke's seeded columns at
one Rally nyc_taxis shard's shape (``nyc_taxis_columns``, AGG_ROWS rows)
on the card and runs each of its calls (``agg_inprocess_calls``: terms,
presence, histogram, months, stats, a metric per ordinal) through DIR's
wrappers. One JSON line: the card, and per call "ms" (the median of
chip_smoke's TIMED CUDA-event brackets), "device_ms_by_function" (each
CUDA function's mean device ms over as many calls, torch.profiler) and
"digest" (a hash of the outputs' bytes: two checkouts that agree give
the same). Compare two checkouts within one call, in turns: A, B, B, A.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

HERE_ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE_ROOT))
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    import chip_smoke as cs
    from elasticsearch_tpu_torch.ops import agg_kernel as ak
    from elasticsearch_tpu_torch.tools.kernel_ab import profiled
    if not torch.cuda.is_available():
        print("agg_ab: no CUDA device available", file=sys.stderr)
        return 2
    calls = cs.agg_inprocess_calls(cs.nyc_taxis_columns(),
                                   torch.device("cuda", 0))
    out = {}
    for label, kernel, fn, operands, kw in calls:
        wrapper = getattr(ak, fn)
        got = cs.agg_outputs(wrapper(*operands, **kw))
        digest = hashlib.sha1(b"".join(
            t.cpu().numpy().tobytes() for t in got)).hexdigest()[:16]
        ms = cs.time_events(
            lambda ev: wrapper(*operands, **dict(kw, events=ev)),
            cs.TIMED)[kernel]
        by_function = profiled(lambda: wrapper(*operands, **kw), cs.TIMED,
                               {f: [f] for f in cs.AGG_FUNCTIONS[kernel]})
        out[label] = {"kernel": kernel, "ms": ms,
                      "device_ms_by_function": by_function,
                      "digest": digest}
    print(json.dumps({"root": args.root, "nvidia_smi": cs.smi_line(),
                      "rows": cs.AGG_ROWS, "calls": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
