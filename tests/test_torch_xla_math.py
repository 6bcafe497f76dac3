"""``ops/xla_math.py`` against XLA:CPU's own f32 ``log`` and ``log10``,
``exp``, ``pow`` with a tensor exponent, and ``sin``, ``cos`` and ``tan``
(the C library's, which XLA:CPU calls), bit for bit.

The reference's planner scores field_value_factor's log modifiers with
``jnp.log`` / ``jnp.log10``; XLA:CPU lowers them to its own polynomial
(``log10`` as ``log(x) * 0.434294492f``). ``xla_logf`` computes the same
polynomial in torch, every fused multiply-add as a float64 product and
sum rounded once. The sweep: the integers 1-2,000,000, 1,000,000 seeded
random bit patterns of normal floats, the special values, and the
planner's operands (``max(v, 1e-9)``, ``max(v, 0) + 1``, ``+ 2``) over
integer and fractional doc values. The gpu-marked case holds the same
function on the card against the CPU's result (it imports no JAX, so it
runs where JAX is missing).
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops.xla_math import (libm_cosf, libm_sinf,
                                                  libm_tanf, xla_expf,
                                                  xla_log10f, xla_logf,
                                                  xla_powf)


def _sweep():
    rng = np.random.default_rng(20261018)
    ints = np.arange(1, 2_000_001, dtype=np.float32)
    bits = rng.integers(0x00800000, 0x7F800000, size=1_000_000,
                        dtype=np.uint32).view(np.float32)
    special = np.array([0.0, -0.0, -1.0, np.inf, -np.inf, np.nan, 1e-45,
                        -1e-45, 1e-39, 1.17549435e-38, 3.4028235e38,
                        1.0, 2.0, 0.5], dtype=np.float32)
    values = np.concatenate([
        np.arange(-5, 100_000, dtype=np.float32),
        rng.uniform(0.0, 1e4, 200_000).astype(np.float32),
        rng.uniform(-1.0, 1.0, 50_000).astype(np.float32),
        rng.lognormal(3.0, 2.0, 100_000).astype(np.float32)])
    operands = [np.maximum(values, np.float32(1e-9)),
                np.maximum(values, np.float32(0.0)) + np.float32(1.0),
                np.maximum(values, np.float32(0.0)) + np.float32(2.0)]
    return {"integers": ints, "bit_patterns": bits, "special": special,
            "planner_operands": np.concatenate(operands)}


SWEEP = _sweep()


def _same_bits(got, want):
    """Equal as uint32, every NaN taken as one value."""
    nan = np.isnan(got) & np.isnan(want)
    diff = (got.view(np.uint32) != want.view(np.uint32)) & ~nan
    return int(diff.sum())


@pytest.mark.parametrize("name", sorted(SWEEP))
def test_logf_matches_xla_cpu_bitwise(name):
    import jax
    import jax.numpy as jnp
    x = SWEEP[name]
    t = torch.from_numpy(x)
    want = np.asarray(jax.jit(jnp.log)(x))
    assert _same_bits(xla_logf(t).numpy(), want) == 0
    want10 = np.asarray(jax.jit(jnp.log10)(x))
    assert _same_bits(xla_log10f(t).numpy(), want10) == 0


def test_eager_log10_is_the_same_function():
    """The reference's planner calls jnp.log10 eagerly, outside a jit of
    its own: the same bits."""
    import jax.numpy as jnp
    x = SWEEP["planner_operands"][:100_000]
    assert _same_bits(xla_log10f(torch.from_numpy(x)).numpy(),
                      np.asarray(jnp.log10(x))) == 0


def test_torch_log_differs():
    """Why the port carries its own log: torch's f32 log is an ulp off
    XLA:CPU's on some of these inputs (so this sweep can see a fault)."""
    x = torch.from_numpy(SWEEP["integers"])
    assert _same_bits(torch.log(x).numpy(), xla_logf(x).numpy()) > 0


@pytest.mark.parametrize("name", sorted(SWEEP))
def test_expf_matches_xla_cpu_bitwise(name):
    """XLA:CPU's own exp polynomial (the score scripts' `exp`)."""
    import jax
    import jax.numpy as jnp
    x = np.concatenate([SWEEP[name], -SWEEP[name][:200_000],
                        np.float32(1e-3) * SWEEP[name][:200_000]])
    want = np.asarray(jax.jit(jnp.exp)(x))
    assert _same_bits(xla_expf(torch.from_numpy(x)).numpy(), want) == 0


def _trig_sweep():
    rng = np.random.default_rng(20261019)
    return np.concatenate([
        rng.uniform(-1.0, 1.0, 100_000), rng.uniform(-150, 150, 300_000),
        rng.uniform(-1e7, 1e7, 50_000), rng.uniform(-1e-3, 1e-3, 5_000),
        SWEEP["bit_patterns"][:100_000], -SWEEP["bit_patterns"][:100_000],
        SWEEP["special"]]).astype(np.float32)


@pytest.mark.parametrize("fn,name", [(libm_sinf, "sin"), (libm_cosf, "cos"),
                                     (libm_tanf, "tan")],
                         ids=["sin", "cos", "tan"])
def test_trig_matches_xla_cpu_bitwise(fn, name):
    """The C library's sinf / cosf / tanf, which XLA:CPU calls: small,
    medium (the fused reduction) and large (4/pi's bits) arguments."""
    import jax
    import jax.numpy as jnp
    x = _trig_sweep()
    want = np.asarray(jax.jit(getattr(jnp, name))(x))
    assert _same_bits(fn(torch.from_numpy(x)).numpy(), want) == 0


def test_powf_with_a_tensor_exponent_matches_xla_cpu_bitwise():
    """`pow` of two columns: the C library's powf element by element,
    negative bases with integral and fractional exponents among them."""
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    x = rng.uniform(-5, 5, 200_000).astype(np.float32)
    y = rng.uniform(-4, 4, 200_000).astype(np.float32)
    y[:20_000] = np.round(y[:20_000])
    y[20_000:21_000] = 0.0
    x[21_000:22_000] = 1.0
    want = np.asarray(jnp.power(x, y))
    got = xla_powf(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert _same_bits(got, want) == 0


@pytest.mark.gpu
def test_transcendentals_on_the_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_trig_sweep())
    y = torch.from_numpy(np.random.default_rng(7).uniform(
        -4, 4, x.numel()).astype(np.float32))
    for fn in (xla_expf, libm_sinf, libm_cosf, libm_tanf,
               lambda t: xla_powf(t.abs(), 0.5),
               lambda t: xla_powf(t, y.to(t.device))):
        assert _same_bits(fn(x.to("cuda")).cpu().numpy(),
                          fn(x).numpy()) == 0


@pytest.mark.gpu
def test_logf_on_the_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name, x in SWEEP.items():
        cpu = torch.from_numpy(x)
        card = cpu.to("cuda")
        for fn in (xla_logf, xla_log10f):
            assert _same_bits(fn(card).cpu().numpy(),
                              fn(cpu).numpy()) == 0, (name, fn.__name__)
