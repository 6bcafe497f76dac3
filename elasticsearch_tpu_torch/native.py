"""Host C helpers: the standard analyzer's ASCII tokenizer and the
response splicer.

Counterpart of the reference's ``native/__init__.py``. The sources are
``csrc/fast_tokenize.c`` and ``csrc/response_splice.c`` (copies of the
reference's); each builds with the system C compiler at first use:

    cc -O3 -shared -fPIC -o _build/<name>-<hash>.so csrc/<name>.c

The file name carries a hash of the source, so an edited source never
loads a stale library. These are host code, not device kernels: every
caller has a byte-identical Python path, taken when no compiler is
present, and ``used()`` reports which of the two ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Dict, Optional

from elasticsearch_tpu_torch.ops._build import BUILD_DIR, CSRC_DIR

logger = logging.getLogger("elasticsearch_tpu_torch.native")

_LOCK = threading.Lock()
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}
_USED: Dict[str, str] = {}


def _target(name: str):
    src = CSRC_DIR / f"{name}.c"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def load(name: str) -> Optional[ctypes.CDLL]:
    """dlopen the library of csrc/<name>.c, building it first when
    needed; None when the build fails (callers take their Python path)."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src, so = _target(name)
        lib = None
        try:
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["cc", "-O3", "-shared", "-fPIC", "-o",
                                str(tmp), str(src)],
                               check=True, capture_output=True, timeout=60)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except Exception as exc:  # noqa: BLE001 — the Python path serves
            logger.warning("native [%s] unavailable (%s); using the "
                           "Python path", name, exc)
            lib = None
        _LIBS[name] = lib
        return lib


def bind(lib_name: str, symbol: str, restype, argtypes):
    """load() + bind one symbol's ctypes signature; None when the
    library is unavailable."""
    lib = load(lib_name)
    if lib is None:
        return None
    fn = getattr(lib, symbol)
    fn.restype = restype
    fn.argtypes = argtypes
    return fn


def note(name: str, route: str) -> None:
    """Record which route (``"c"`` or ``"python"``) served `name`."""
    _USED[name] = route


def used() -> Dict[str, str]:
    """{helper: "c" | "python"} for the helpers that ran so far."""
    return dict(_USED)
