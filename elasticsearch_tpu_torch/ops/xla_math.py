"""XLA:CPU's float32 ``log``, op for op, as torch ops.

The reference's planner scores ``field_value_factor``'s log modifiers
with ``jnp.log`` / ``jnp.log10``. On the CPU, XLA lowers f32 ``log`` to
its own Cephes polynomial (the one Eigen's ``plog_float`` also uses),
not to libm, and its machine code fuses every multiply-add of the
polynomial. ``torch.log`` differs from it by an ulp on about one input
in a hundred, so a port that calls it leaves the reference's scores.

``xla_logf`` computes the same polynomial:

* the input clamped to the smallest normal, split by bit masks into a
  mantissa m in [0.5, 1) and an exponent e;
* m below sqrt(1/2) is doubled (``x = (m - 1) + m``, ``e -= 1``), else
  ``x = m - 1``;
* three Estrin chains of the Cephes coefficients, then Horner in x³,
  each step a fused multiply-add;
* ``(x - x²/2) + y + e·ln2_hi``.

A fused step is a float64 product and sum rounded once to float32: the
product of two float32 values is exact in float64, and two torch ops
are never contracted, so the code gives the same bits on the CPU and
on a card. Every other step is float32. ``jnp.log10(x)`` lowers to
``log(x) * 0.434294492f``; ``xla_log10f`` is that product.

Special values follow the reference: 0 or a denormal (XLA:CPU flushes
them) → -inf, a negative normal or NaN input → NaN, +inf → +inf.
"""

from __future__ import annotations

import torch

_h = float.fromhex
_MIN_NORM = _h("0x1p-126")
_SQRTHF = _h("0x1.6a09e6p-1")
_LN2_HI = _h("0x1.63p-1")
_LN2_LO = _h("-0x1.bd0106p-13")
_LOG10_E = _h("0x1.bcb7b2p-2")      # 0.434294492f, jnp.log10's factor

# (a, b, c) of each Estrin chain, fma(fma(x, a, b), x, c): the Cephes
# coefficients as float32 values
_CHAINS = (
    (_h("0x1.204376p-4"), _h("-0x1.d7a37p-4"), _h("0x1.de4a34p-4")),
    (_h("-0x1.fcba9ep-4"), _h("0x1.23d37ep-3"), _h("-0x1.555ca0p-3")),
    (_h("0x1.999d58p-3"), _h("-0x1.fffff8p-3"), _h("0x1.555554p-2")),
)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a·b + c`` with one rounding of the sum (the product
    is exact in float64)."""
    def wide(v):
        return v.to(torch.float64) if isinstance(v, torch.Tensor) else v
    return (wide(a) * wide(b) + wide(c)).to(torch.float32)


def xla_logf(t: torch.Tensor) -> torch.Tensor:
    """Natural log of a float32 tensor, bit for bit as XLA:CPU's."""
    t = t.to(torch.float32)
    v = torch.clamp(t, min=_MIN_NORM)
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _SQRTHF
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.to(torch.float32)
    x2 = x * x
    x3 = x2 * x
    y, y1, y2 = (_fma(_fma(x, a, b), x, c) for a, b, c in _CHAINS)
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _LN2_LO)
    r = (x - x2 * 0.5) + y + e * _LN2_HI
    # XLA:CPU runs with denormals flushed: a denormal input is a zero
    r = torch.where(t.abs() < _MIN_NORM, torch.full_like(r, float("-inf")),
                    r)
    r = torch.where(t == float("inf"), torch.full_like(r, float("inf")), r)
    return torch.where((t <= -_MIN_NORM) | torch.isnan(t),
                       torch.full_like(r, float("nan")), r)


def xla_log10f(t: torch.Tensor) -> torch.Tensor:
    """Base-10 log of a float32 tensor, bit for bit as XLA:CPU's
    ``jnp.log10``: ``log(x) * 0.434294492f``."""
    return xla_logf(t) * _LOG10_E
