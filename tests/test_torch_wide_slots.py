"""Rows past 1,024 posting slots, op by op: the port's merge core against
the JAX package's ``sorted_merge_topk``, bit for bit.

At chunk_cap 64 a query of 1,100 terms fills 1,100 slots a row (T 2048)
or, with longer postings, 3,300 (T 4096). Doc 0 is in every term, so its
run is 1,100 lanes long and the doubling run sum takes its 11th step
(``while step < t_window``): the kernels' run trees must group the adds
as that tree does. The same operands go through the reference's
"compressed", "compressed_exact" and (raw operands) "ref" variants and
the port's (on the CPU the plain versions: ``ops/sparse.py``); scores
are compared as uint32, docs and totals exactly. The emulated kernels
run the same cases (tests/test_torch_merge_kernel_emulated.py), the card
the kernels themselves (tests/test_torch_merge_kernel.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import sparse as jsp

from elasticsearch_tpu_torch.ops import sparse as tsp

import torch_parity_cases as cases

torch.set_num_threads(1)


def run_ref(pos, extra, static, k, variant):
    out = jsp.sorted_merge_topk(
        *[jnp.asarray(a) for a in pos], k=k, with_totals=True,
        variant=variant, **static,
        **{n: jnp.asarray(a) for n, a in extra.items()})
    return [np.asarray(o) for o in out]


def run_port(pos, extra, static, k, variant):
    return tsp.sorted_merge_topk(
        *cases.to_torch(pos), k=k, with_totals=True, variant=variant,
        **static, **cases.to_torch(extra))


@pytest.mark.parametrize("t_slots", [2048, 4096])
@pytest.mark.parametrize("variant", ["compressed", "compressed_exact"])
def test_wide_rows_match_reference(variant, t_slots):
    rng = np.random.default_rng(t_slots)
    fd, fi, rows, mins, d_pad, ext = cases.make_wide_case(rng, t_slots)
    pos, extra, static = cases.kernel_args(fd, fi, rows, mins, d_pad, ext,
                                           chunk_cap=64)
    assert pos[2].shape == (2, t_slots)
    assert static["t_window"] > 1024  # the 11th doubling step
    for k in (10, 1000):
        got = run_port(pos, extra, static, k, variant)
        cases.assert_bitwise(got, run_ref(pos, extra, static, k, variant),
                             f"{variant} k={k}")
    # doc 0 matches all 1,100 terms and leads; the msm row keeps only it
    assert int(got[1][0][0]) == 0 and int(got[2][1]) == 1


@pytest.mark.parametrize("t_slots", [2048, 4096])
def test_wide_raw_rows_match_reference(t_slots):
    rng = np.random.default_rng(t_slots + 1)
    fd, fi, rows, mins, d_pad, _ = cases.make_wide_case(rng, t_slots)
    pos, static = cases.raw_args(fd, fi, rows, mins, d_pad, chunk_cap=64)
    assert pos[2].shape == (2, t_slots)
    for k in (10, 1000):
        got = run_port(pos, {}, static, k, "ref")
        cases.assert_bitwise(got, run_ref(pos, {}, static, k, "ref"),
                             f"ref k={k}")
