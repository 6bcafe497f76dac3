"""XLA:CPU's float32 ``log`` and ``pow``, op for op, as torch ops, and
its flush of denormals.

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

``xla_powf`` is the C library's ``powf``, which XLA:CPU calls for f32
``pow`` (see its section below), and ``xla_ftz`` the flush to zero that
XLA:CPU applies to an op's denormal result and operands.
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


def xla_ftz(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor with its denormals flushed to zeros of their
    sign: XLA:CPU's result of an op whose exact value is denormal (it
    runs with flush-to-zero and denormals-are-zero), where torch and a
    card keep the denormal."""
    return torch.where(t.abs() < _MIN_NORM, t * 0.0, t)


def x86_nan_like(t: torch.Tensor) -> torch.Tensor:
    """The x86 default NaN (bits 0xFFC00000, negative), which XLA:CPU's
    arithmetic and the C library make, in `t`'s shape and device, built
    from its bits: a card's own NaN constant is another one."""
    return torch.full(t.shape, -0x400000, dtype=torch.int32,
                      device=t.device).view(torch.float32)


def xla_log10f(t: torch.Tensor) -> torch.Tensor:
    """Base-10 log of a float32 tensor, bit for bit as XLA:CPU's
    ``jnp.log10``: ``log(x) * 0.434294492f``."""
    return xla_logf(t) * _LOG10_E


# ---------------------------------------------------------------------------
# float32 pow
# ---------------------------------------------------------------------------
#
# XLA:CPU lowers f32 ``pow`` to a call of the C library's ``powf``. The
# reference's host (glibc on x86-64 with FMA) runs the ARM
# optimized-routines algorithm: log2(x) in double from a 16-entry table
# and a degree-5 polynomial, y·log2(x), exp2 in double from a 32-entry
# table and a cubic, one rounding to float at the end; its x86-64 build
# for FMA hardware contracts every ``a·b + c`` of the polynomials into a
# fused multiply-add. ``xla_powf`` runs that algorithm in float64 torch
# ops, each fused multiply-add emulated exactly (``_fma64``), so the CPU
# and a card give the same bits, and those of the reference.

_POWF_OFF = 0x3F330000
#: (1/c, log2(c)) of the 16 subintervals of [OFF, 2·OFF]
_POWF_LOG2_TAB = (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1p+0", "0x0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"),
)
_POWF_LOG2_POLY = tuple(_h(c) for c in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
_EXP2F_POLY = tuple(_h(c) for c in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_EXP2F_SHIFT = _h("0x1.8p+47")   # 0x1.8p52 / 32: rounds to k/32
_POWF_OFLOW = _h("0x1.fffffffd1d571p+6")


def _exp2f_table() -> tuple:
    """2^(i/32) as double bits less i << 47 (the exponent increment the
    lookup adds back), i = 0..31."""
    import struct
    return tuple(struct.unpack("<q", struct.pack("<d", 2.0 ** (i / 32)))[0]
                 - (i << 47) for i in range(32))


_EXP2F_TAB = _exp2f_table()


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a: torch.Tensor):
    t = a * 134217729.0            # 2^27 + 1: Veltkamp's split
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma64(a, b, c) -> torch.Tensor:
    """float64 ``a·b + c`` rounded once (Boldo and Melquiond's emulation:
    the exact product, an exact sum with c, the low parts added with
    round-to-odd, then one round-to-nearest). Exact for the finite,
    non-underflowing operands pow's polynomials give it."""
    ref = next(v for v in (a, b, c) if isinstance(v, torch.Tensor))

    def t(v):
        return v if isinstance(v, torch.Tensor) else torch.full_like(ref, v)
    a, b, c = t(a), t(b), t(c)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    s, e = _two_sum(tl, ul)
    # round to odd: an inexact sum with an even last bit moves one ulp
    # toward the exact value
    bits = s.view(torch.int64)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    bits = torch.where((e != 0) & ((bits & 1) == 0), bits + step, bits)
    return th + bits.view(torch.float64)


def xla_powf(t: torch.Tensor, y: float) -> torch.Tensor:
    """``t ** y`` for a float32 tensor and a scalar exponent, bit for
    bit as XLA:CPU's f32 ``pow`` (the C library's ``powf``): y is
    rounded to float32 first, as ``jnp.power`` does with a Python
    float."""
    import numpy as np
    x = t.to(torch.float32)
    yf = float(np.float32(y))
    dev = x.device
    if yf == 0.0:
        return torch.ones_like(x)
    ix = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = ix >= 0x80000000
    ix = ix & 0x7FFFFFFF
    zero = ix == 0
    special = zero | (ix >= 0x7F800000)
    # a subnormal x: powf scales it by 2^23 and lowers the exponent by
    # 23, but XLA:CPU runs with denormals read as zero, so the scaled
    # value is 0 and the bits are those of -(23 << 23)
    ix = torch.where(ix < 0x00800000, (-(23 << 23)) & 0xFFFFFFFF, ix)
    tmp = (ix - _POWF_OFF) & 0xFFFFFFFF
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    iz = (ix - top) & 0xFFFFFFFF
    k = torch.where(top >= 2 ** 31, top - 2 ** 32, top) // (1 << 23)
    tab = torch.tensor([[_h(a), _h(b)] for a, b in _POWF_LOG2_TAB],
                       dtype=torch.float64, device=dev)
    invc, logc = tab[i, 0], tab[i, 1]
    z = torch.where(iz >= 2 ** 31, iz - 2 ** 32, iz).to(torch.int32) \
        .view(torch.float32).to(torch.float64)
    a0, a1, a2, a3, a4 = _POWF_LOG2_POLY
    r = _fma64(z, invc, -1.0)
    y0 = logc + k.to(torch.float64)
    r2 = r * r
    p_hi = _fma64(a0, r, a1)
    p = _fma64(a2, r, a3)
    r4 = r2 * r2
    q = _fma64(a4, r, y0)
    q = _fma64(p, r2, q)
    logx = _fma64(p_hi, r4, q)
    ylogx = yf * logx
    # exp2(ylogx) = 2^(k/32) · 2^r, |r| <= 1/64
    kd = ylogx + _EXP2F_SHIFT
    kint = kd.view(torch.int64) - torch.tensor(
        _EXP2F_SHIFT, dtype=torch.float64).view(torch.int64).item()
    rr = ylogx - (kd - _EXP2F_SHIFT)
    etab = torch.tensor(_EXP2F_TAB, dtype=torch.int64, device=dev)
    s = (etab[kint & 31] + kint * (1 << 47)).view(torch.float64)
    c0, c1, c2 = _EXP2F_POLY
    zz = _fma64(c0, rr, c1)
    ye = _fma64(c2, rr, 1.0)
    ye = _fma64(zz, rr * rr, ye)
    out = xla_ftz((ye * s).to(torch.float32))  # ... and flushes results
    out = torch.where(ylogx > _POWF_OFLOW, torch.full_like(out, float("inf")),
                      out)
    out = torch.where(ylogx <= -150.0, torch.zeros_like(out), out)
    # x = ±0, ±inf, NaN: x·x, or its reciprocal for a negative y
    sq = x * x
    out = torch.where(special, 1.0 / sq if yf < 0 else sq, out)
    # a negative x: NaN unless y is an integer, negated when y is odd
    if yf == int(yf):
        if int(yf) % 2:
            out = torch.where(neg, -out, out)
    else:
        # the C library's 0/0: the x86 default NaN
        out = torch.where(neg & ~special, x86_nan_like(out), out)
    return out
