"""The port stands alone: importing it loads neither JAX nor any module
of the JAX package, and its entry points refuse to fall back to the CPU
when no GPU is present and the caller did not ask for the CPU."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

GUARD = textwrap.dedent("""
    import importlib, pkgutil, sys
    import elasticsearch_tpu_torch as port
    names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                   port.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.")
                 or m == "elasticsearch_tpu"
                 or m.startswith("elasticsearch_tpu."))
    print(len(names), bad)
""")


def run_fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


NO_GPU = textwrap.dedent("""
    import torch
    torch.cuda.is_available = lambda: False
    from elasticsearch_tpu_torch.parallel.device import (NoDeviceError,
                                                         resolve_device)
    from elasticsearch_tpu_torch.search.gpu_service import GpuSearchService
    for call in (lambda: GpuSearchService(), lambda: resolve_device(),
                 lambda: resolve_device("cuda")):
        try:
            call()
        except NoDeviceError:
            print("raised")
        else:
            print("ran")
    print(resolve_device("cpu"))
    GpuSearchService(device="cpu").close()
""")


@pytest.fixture(scope="module")
def fresh_process():
    """One fresh interpreter: import every module of the port, report
    what got loaded, then try the entry points with the GPU hidden."""
    return run_fresh(GUARD + NO_GPU).splitlines()


def test_every_module_of_the_port_imports(fresh_process):
    n, _ = fresh_process[0].split(" ", 1)
    assert int(n) >= 15


def test_port_imports_no_jax_and_nothing_of_the_reference(fresh_process):
    _, bad = fresh_process[0].split(" ", 1)
    assert bad == "[]"


def test_entry_points_raise_without_gpu_unless_cpu_is_asked(fresh_process):
    assert fresh_process[1:] == ["raised"] * 3 + ["cpu"]
