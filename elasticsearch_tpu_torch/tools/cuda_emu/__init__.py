"""Run the kernels' CUDA sources on the CPU, for rehearsing a kernel
edit where there is no nvcc and no card. ``csrc/merge_topk.cu`` holds
every merge kernel: the five of the fused merge, shard_topk, exact_merge
(also as raw_merge), pruned_candidates and pruned_rescore (reached
through ``merge_kernel._launch_topk``, ``_launch_exact``,
``_launch_candidates`` and ``_launch_rescore``); ``csrc/knn.cu`` the kNN
similarity kernel (``emulated(build_dir, "knn")``:
``knn_kernel._launch``); ``csrc/aggs.cu`` the three aggregation kernels,
agg_bucket_counts, agg_masked_stats and agg_ord_stats
(``emulated(build_dir, "aggs")``: ``agg_kernel._launch_counts``,
``_launch_stats`` and ``_launch_ord_stats``).

A source is rewritten into plain C++ against ``emu.h`` (a host shim of
the CUDA subset the kernels use: each CUDA thread a fiber of one OS
thread, switched at every block or warp barrier, blocks one after
another; cp.async a copy that lands at once; knn.cu's ``.ftz`` PTX
operations by x86's flush rule, the card's; atomics, aggs.cu's 64-bit
ones too, as plain read-modify-writes), compiled with g++ into a
shared library with the same C entry points, and put in place of the
nvcc-built library::

    from elasticsearch_tpu_torch.tools import cuda_emu
    with cuda_emu.emulated(build_dir):
        out = merge_kernel._launch(*cpu_tensors, stats={}, events=None,
                                   **keywords)   # hold against the plain

It runs the kernels' logic (indexing, barriers' placement, the order of
the adds) at small sizes; it shows no race, no launch limit and no
timing. Nothing here runs at import time or on the serving path.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import subprocess
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent.parent / "csrc"
SOURCE = CSRC / "merge_topk.cu"


def translate(src: str) -> str:
    """The CUDA source as C++ over emu.h (a source's ``// <ptx>`` ...
    ``// </ptx>`` block of inline-PTX helpers is emu.h's to give)."""
    src = src.replace("#include <cuda_runtime.h>", '#include "emu.h"')
    src = re.sub(r"// <ptx>\n.*?// </ptx>\n", "", src, flags=re.S)
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) "
                 r"(\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(g_smem);", src)
    src = re.sub(r"__launch_bounds__\([^)]*\)", "", src)
    src = src.replace("__shared__", "static").replace("__global__", "")
    src = src.replace("__device__", "").replace("__forceinline__", "inline")
    src = re.sub(r"__align__\(\d+\)", "", src)
    return re.sub(r"(\w+)<<<", r"emu_launch(\1, ", src).replace(">>>(", ", ")


def build(build_dir: Path, name: str = "merge_topk") -> Path:
    """g++ the translated csrc/<name>.cu into build_dir → the library's
    path."""
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    cpp = build_dir / f"{name}_emu.cpp"
    cpp.write_text(translate((CSRC / f"{name}.cu").read_text()))
    lib = build_dir / f"lib{name}_emu.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    "-fno-strict-aliasing",
                    "-fPIC", "-shared", f"-I{HERE}", "-o",
                    str(lib), str(cpp)], check=True)
    return lib


@contextlib.contextmanager
def emulated(build_dir: Path, name: str = "merge_topk"):
    """The wrapper module's launches (merge_kernel's for csrc/merge_topk.cu,
    knn_kernel's for csrc/knn.cu, agg_kernel's for csrc/aggs.cu) go to
    the emulated library for the block; CPU tensors then reach
    merge_kernel._launch, knn_kernel._launch or agg_kernel's _launch_*
    (not fused_merge_topk, knn_scores or agg_kernel's wrappers, which
    send them to the plain version)."""
    import torch

    from elasticsearch_tpu_torch.ops import (agg_kernel, knn_kernel,
                                             merge_kernel)
    module = {"merge_topk": merge_kernel, "knn": knn_kernel,
              "aggs": agg_kernel}[name]
    lib = ctypes.CDLL(str(build(build_dir, name)))
    for fn, args in module._SIGNATURES.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    lib.es_error_string.argtypes = [ctypes.c_int]
    lib.es_error_string.restype = ctypes.c_char_p
    saved = module._lib, torch.cuda.current_stream
    module._lib = lambda: lib
    torch.cuda.current_stream = lambda dev=None: types.SimpleNamespace(
        cuda_stream=0)
    try:
        yield lib
    finally:
        module._lib, torch.cuda.current_stream = saved
