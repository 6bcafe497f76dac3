"""Registers, shared memory and spills of each kernel, as ptxas reports
them for the package's build flags.

    python3 elasticsearch_tpu_torch/tools/ptxas_report.py [--root DIR]
        [--source merge_topk|knn|aggs]

compiles DIR's ``elasticsearch_tpu_torch/csrc/<source>.cu`` (the default
is this checkout's merge_topk.cu) with ``_build.NVCC_FLAGS`` plus
``-Xptxas -v`` into a temporary file and prints one JSON line: per
kernel, its registers per thread, spill stores and loads (bytes), stack
frame and static shared memory (bytes). Needs nvcc; run it on the
machine with the card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

HERE_ROOT = Path(__file__).resolve().parents[2]
KERNELS = ("slot_decode", "row_pack", "row_sort", "run_sum",
           "select_rescore", "shard_topk", "topk_pass", "topk_runs",
           "topk_merge", "exact_merge", "exact_finish", "knn_tile",
           "knn_row", "knn_qss", "knn_scores", "bucket_counts",
           "set_keys", "stats_first_level", "stats_level", "stats_finish",
           "ord_chunk_count", "ord_column_scan", "ord_starts", "ord_place",
           "ord_chain")


def parse(text: str) -> dict:
    """ptxas -v output → {kernel: {registers, spill_stores, ...}}."""
    def kernel_of(name):
        return next((k for k in KERNELS if f"{k}_kernel" in name), None)

    out = {}
    entry = props = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = kernel_of(m.group(1))
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = kernel_of(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props is not None:
            out.setdefault(props, {}).update(
                stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
            props = None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            s = re.search(r"(\d+) bytes smem", line)
            out.setdefault(entry, {}).update(
                registers=int(m.group(1)),
                static_smem=int(s.group(1)) if s else 0)
            entry = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE_ROOT))
    ap.add_argument("--source", default="merge_topk",
                    choices=("merge_topk", "knn", "aggs"))
    args = ap.parse_args()
    sys.path.insert(0, str(HERE_ROOT))
    from elasticsearch_tpu_torch.ops import _build
    src = (Path(args.root) / "elasticsearch_tpu_torch" / "csrc"
           / f"{args.source}.cu")
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(Path(tmp) / "lib.so"), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return proc.returncode
    print(json.dumps({"root": str(Path(args.root).resolve()),
                      "kernels": parse(proc.stdout + proc.stderr)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
