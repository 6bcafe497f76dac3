"""The port stands alone: importing it loads neither JAX nor any module
of the JAX package, and its entry points refuse to fall back to the CPU
when no GPU is present and the caller did not ask for the CPU."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

#: the node and the modules of its REST path, all of them imported below
NODE_MODULES = [
    "elasticsearch_tpu_torch.node",
    "elasticsearch_tpu_torch.native",
    "elasticsearch_tpu_torch.common.errors",
    "elasticsearch_tpu_torch.common.settings",
    "elasticsearch_tpu_torch.common.breaker",
    "elasticsearch_tpu_torch.common.logging",
    "elasticsearch_tpu_torch.analysis.analyzers",
    "elasticsearch_tpu_torch.analysis.filters",
    "elasticsearch_tpu_torch.mapping.types",
    "elasticsearch_tpu_torch.mapping.mapper",
    "elasticsearch_tpu_torch.index.segment",
    "elasticsearch_tpu_torch.index.seqno",
    "elasticsearch_tpu_torch.index.translog",
    "elasticsearch_tpu_torch.index.store",
    "elasticsearch_tpu_torch.index.reader",
    "elasticsearch_tpu_torch.index.engine",
    "elasticsearch_tpu_torch.index.shard",
    "elasticsearch_tpu_torch.indices.service",
    "elasticsearch_tpu_torch.index.pack",
    "elasticsearch_tpu_torch.ops.bm25",
    "elasticsearch_tpu_torch.ops.geo",
    "elasticsearch_tpu_torch.ops.xla_math",
    "elasticsearch_tpu_torch.ops.knn_kernel",
    "elasticsearch_tpu_torch.ops.agg_kernel",
    "elasticsearch_tpu_torch.search.aggregations",
    "elasticsearch_tpu_torch.search.aggregations.base",
    "elasticsearch_tpu_torch.search.aggregations.bucket",
    "elasticsearch_tpu_torch.search.aggregations.metrics",
    "elasticsearch_tpu_torch.search.aggregations.pipeline",
    "elasticsearch_tpu_torch.search.aggregations.device",
    "elasticsearch_tpu_torch.search.coordinator",
    "elasticsearch_tpu_torch.search.can_match",
    "elasticsearch_tpu_torch.search.planner",
    "elasticsearch_tpu_torch.search.percolator",
    "elasticsearch_tpu_torch.search.query_phase",
    "elasticsearch_tpu_torch.search.dsl",
    "elasticsearch_tpu_torch.script",
    "elasticsearch_tpu_torch.search.sort",
    "elasticsearch_tpu_torch.search.sort_keys",
    "elasticsearch_tpu_torch.search.collapse",
    "elasticsearch_tpu_torch.search.rescore",
    "elasticsearch_tpu_torch.search.highlight",
    "elasticsearch_tpu_torch.search.suggest",
    "elasticsearch_tpu_torch.search.scroll",
    "elasticsearch_tpu_torch.search.contexts",
    "elasticsearch_tpu_torch.search.rank_eval",
    "elasticsearch_tpu_torch.search.knn",
    "elasticsearch_tpu_torch.parallel.mesh",
    "elasticsearch_tpu_torch.parallel.distributed",
    "elasticsearch_tpu_torch.search.serializer",
    "elasticsearch_tpu_torch.rest.controller",
    "elasticsearch_tpu_torch.rest.actions.admin",
    "elasticsearch_tpu_torch.rest.actions.document",
    "elasticsearch_tpu_torch.rest.actions.root",
    "elasticsearch_tpu_torch.rest.actions.search",
]

GUARD = "NODE_MODULES = %r\n" % (NODE_MODULES,) + textwrap.dedent("""
    import importlib, pkgutil, sys
    import elasticsearch_tpu_torch as port
    import elasticsearch_tpu_torch.node
    names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                   port.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    # the node's own modules and those of the slice it serves
    for name in NODE_MODULES:
        assert name in names, name
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
    from elasticsearch_tpu_torch.node import Node
    import tempfile
    for call in (lambda: GpuSearchService(), lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: Node(tempfile.mkdtemp())):
        try:
            call()
        except NoDeviceError:
            print("raised")
        else:
            print("ran")
    print(resolve_device("cpu"))
    GpuSearchService(device="cpu").close()
    Node(tempfile.mkdtemp(), device="cpu").close()
""")


@pytest.fixture(scope="module")
def fresh_process():
    """One fresh interpreter: import every module of the port, report
    what got loaded, then try the entry points with the GPU hidden."""
    return run_fresh(GUARD + NO_GPU).splitlines()


def test_every_module_of_the_port_imports(fresh_process):
    n, _ = fresh_process[0].split(" ", 1)
    assert int(n) >= 15 + len(NODE_MODULES)


def test_port_imports_no_jax_and_nothing_of_the_reference(fresh_process):
    _, bad = fresh_process[0].split(" ", 1)
    assert bad == "[]"


def test_entry_points_raise_without_gpu_unless_cpu_is_asked(fresh_process):
    assert fresh_process[1:] == ["raised"] * 4 + ["cpu"]
