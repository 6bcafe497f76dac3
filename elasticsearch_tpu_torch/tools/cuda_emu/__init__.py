"""Run the merge kernels' CUDA source on the CPU, for rehearsing a kernel
edit where there is no nvcc and no card. The source holds every merge
kernel: the five of the fused merge, shard_topk, exact_merge (also as
raw_merge), pruned_candidates and pruned_rescore (reached through
``merge_kernel._launch_topk``, ``_launch_exact``, ``_launch_candidates``
and ``_launch_rescore``).

``csrc/merge_topk.cu`` is rewritten into plain C++ against ``emu.h`` (a
host shim of the CUDA subset the kernels use: each CUDA thread a fiber
of one OS thread, switched at every block or warp barrier, blocks one
after another), compiled with g++ into a shared library with the same C
entry points, and put in place of the nvcc-built library::

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
SOURCE = HERE.parent.parent / "csrc" / "merge_topk.cu"


def translate(src: str) -> str:
    """The CUDA source as C++ over emu.h."""
    src = src.replace("#include <cuda_runtime.h>", '#include "emu.h"')
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) "
                 r"(\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(g_smem);", src)
    src = re.sub(r"__launch_bounds__\([^)]*\)", "", src)
    src = src.replace("__shared__", "static").replace("__global__", "")
    src = src.replace("__device__", "").replace("__forceinline__", "inline")
    src = re.sub(r"__align__\(\d+\)", "", src)
    return re.sub(r"(\w+)<<<", r"emu_launch(\1, ", src).replace(">>>(", ", ")


def build(build_dir: Path) -> Path:
    """g++ the translated source into build_dir → the library's path."""
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    cpp = build_dir / "merge_topk_emu.cpp"
    cpp.write_text(translate(SOURCE.read_text()))
    lib = build_dir / "libmerge_topk_emu.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    "-fPIC", "-shared", f"-I{HERE}", "-o",
                    str(lib), str(cpp)], check=True)
    return lib


@contextlib.contextmanager
def emulated(build_dir: Path):
    """merge_kernel's launches go to the emulated library for the block;
    CPU tensors then reach merge_kernel._launch (not fused_merge_topk,
    which sends them to the plain version)."""
    import torch

    from elasticsearch_tpu_torch.ops import merge_kernel as mk
    lib = ctypes.CDLL(str(build(build_dir)))
    for fn, args in mk._SIGNATURES.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    lib.es_error_string.argtypes = [ctypes.c_int]
    lib.es_error_string.restype = ctypes.c_char_p
    saved = mk._lib, torch.cuda.current_stream
    mk._lib = lambda: lib
    torch.cuda.current_stream = lambda dev=None: types.SimpleNamespace(
        cuda_stream=0)
    try:
        yield lib
    finally:
        mk._lib, torch.cuda.current_stream = saved
