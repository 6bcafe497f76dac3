"""Pipelined trains: a pack's launch worker launches train N+1 while its
completion thread still holds train N, and the results equal those of
the same trains run one after another.

The CPU case runs the plain path; the card case (marked gpu, skipped
without one) runs the kernels, whose completion copies each train's
outputs on a stream of its own after the train's ready event. Run on
the card with ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_pipeline.py -q``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.search import dsl, gpu_service
from elasticsearch_tpu_torch.search.gpu_service import (GpuSearchService,
                                                         lower_query)

import torch_parity_cases as cases

TEXTS = ["alpha beta", "gamma delta", "epsilon", "zeta eta theta",
         "alpha", "beta gamma", "delta epsilon zeta", "eta theta alpha"]


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return request.param


def test_second_train_launches_before_the_first_completes(device):
    svc = GpuSearchService(device=device, window_s=0.5, max_batch=4)
    try:
        svc.create_index("p", 2, {"properties": {"body": {"type": "text"}}})
        svc.index("p", cases.make_docs(120))
        svc.refresh("p")
        resident = svc.resident("p", "body")
        mapper = svc._index("p").mapper
        flats = [lower_query(dsl.parse_query({"match": {"body": t}}),
                             mapper) for t in TEXTS]
        want = (svc._execute(resident, flats[:4], 10)
                + svc._execute(resident, flats[4:], 10))
        real_launch, real_finish = svc.batcher.launch, svc.batcher.finish
        launched = []
        second = threading.Event()

        def launch(res, batch, k):
            st = real_launch(res, batch, k)
            launched.append([f.terms for f in batch])
            if len(launched) == 2:
                second.set()
            return st

        def finish(st):
            # the first train completes only once the second launched
            assert second.wait(timeout=60)
            return real_finish(st)

        svc.batcher.launch, svc.batcher.finish = launch, finish
        futures = [svc.batcher.submit(resident, f, 10) for f in flats]
        got = [f.result(timeout=120) for f in futures]
        assert len(launched) == 2 and svc.batcher.max_inflight == 2
        assert svc.batcher.batch_sizes == {4: 2}
        order = [t for train in launched for t in train]
        by_terms = {tuple(f.terms): w for f, w in zip(flats, want)}
        for flat, res in zip(flats, got):
            w = by_terms[tuple(flat.terms)]
            assert tuple(flat.terms) in map(tuple, order)
            np.testing.assert_array_equal(res.scores.view(np.uint32),
                                          w.scores.view(np.uint32))
            np.testing.assert_array_equal(res.rows, w.rows)
            np.testing.assert_array_equal(res.ords, w.ords)
            assert res.total_hits == w.total_hits
    finally:
        svc.close()


def _service_and_flats(window_s, max_batch):
    svc = GpuSearchService(device="cpu", window_s=window_s,
                           max_batch=max_batch)
    svc.create_index("p", 2, {"properties": {"body": {"type": "text"}}})
    svc.index("p", cases.make_docs(120))
    svc.refresh("p")
    mapper = svc._index("p").mapper
    flats = [lower_query(dsl.parse_query({"match": {"body": t}}), mapper)
             for t in TEXTS]
    return svc, svc.resident("p", "body"), flats


def test_wide_queries_ride_trains_of_their_own(monkeypatch):
    # past WIDE_SLOTS a row's launch takes a wider T; shrunk here so
    # the three-term queries count as wide and the others as narrow
    monkeypatch.setattr(gpu_service, "WIDE_SLOTS", 2)
    svc, resident, flats = _service_and_flats(window_s=0.5, max_batch=8)
    try:
        wide = [gpu_service._slots_needed(resident, f) > 2 for f in flats]
        assert sum(wide) == 3
        want = [svc._execute(resident, [f], 10)[0] for f in flats]
        real_launch = svc.batcher.launch
        trains = []

        def launch(res, batch, k):
            trains.append([gpu_service._slots_needed(res, f) > 2
                           for f in batch])
            return real_launch(res, batch, k)

        svc.batcher.launch = launch
        futures = [svc.batcher.submit(resident, f, 10) for f in flats]
        got = [f.result(timeout=120) for f in futures]
        assert sorted(map(len, trains)) == [3, 5]
        assert all(len(set(t)) == 1 for t in trains)
        for res, w in zip(got, want):
            np.testing.assert_array_equal(res.scores.view(np.uint32),
                                          w.scores.view(np.uint32))
            np.testing.assert_array_equal(res.rows, w.rows)
            np.testing.assert_array_equal(res.ords, w.ords)
            assert res.total_hits == w.total_hits
    finally:
        svc.close()


def test_queries_queued_during_a_launch_take_no_second_window():
    # the window runs from the oldest waiting query's submit: those that
    # queued while the worker launched the last train leave at once
    svc, resident, flats = _service_and_flats(window_s=0.3, max_batch=4)
    try:
        real_launch = svc.batcher.launch
        n = []

        def launch(res, batch, k):
            n.append(len(batch))
            if len(n) == 1:
                time.sleep(0.6)   # past the second train's window
            return real_launch(res, batch, k)

        svc.batcher.launch = launch
        futures = [svc.batcher.submit(resident, f, 10) for f in flats]
        for f in futures:
            f.result(timeout=120)
        assert n == [4, 4]
        second = [f.pending for f in futures[4:]]
        assert all(p.t_take - p.t_cycle < 0.15 for p in second)
        assert all(p.t_take - p.t_submit >= 0.3 for p in second)
    finally:
        svc.close()
