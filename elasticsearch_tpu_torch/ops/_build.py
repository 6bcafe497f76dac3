"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` compiles on its own into a shared library with a plain
C interface under ``elasticsearch_tpu_torch/_build/`` at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -shared -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
source never loads a stale library. ``build_all()`` starts one nvcc per
source at once. A missing nvcc or a failed build raises BuildError with
the compiler's output. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: -fmad=false: the reference rounds every product before it adds
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise BuildError("nvcc not found (looked on PATH, $CUDA_HOME and "
                     "/usr/local/cuda): the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str, nvcc: str):
    """Start nvcc for csrc/<name>.cu → (target, process or None when the
    library is already built)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp, cmd)


def _finish(target: Path, job) -> None:
    if job is None:
        return
    proc, tmp, cmd = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed ({proc.returncode}): "
                         f"{' '.join(cmd)}\n{out}")
    os.replace(tmp, target)


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all() -> Dict[str, Path]:
    """Compile every csrc/*.cu that is not built yet, all nvcc processes
    running together → {name: library path}."""
    with _LOCK:
        names = sources()
        nvcc = nvcc_path() if any(not _target(n).exists()
                                  for n in names) else ""
        jobs = {n: _start(n, nvcc) for n in names}
        for name, (target, job) in jobs.items():
            _finish(target, job)
        return {n: jobs[n][0] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
    path = build_all()[name]
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib
