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
them) → -inf, a negative normal or NaN input → the all-ones NaN
(0xFFFFFFFF), +inf → +inf.

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
    # a negative normal or NaN input: Eigen's all-ones NaN (the result
    # or-ed with the invalid mask)
    return torch.where((t <= -_MIN_NORM) | torch.isnan(t),
                       _bits_like(r, -1), r)


def _bits_like(t: torch.Tensor, bits: int) -> torch.Tensor:
    """A float32 tensor of `t`'s shape and device whose every element has
    the int32 bit pattern `bits`."""
    return torch.full(t.shape, bits, dtype=torch.int32,
                      device=t.device).view(torch.float32)


def x86_nan(res: torch.Tensor, *operands) -> torch.Tensor:
    """`res` with its NaNs given the bits x86 arithmetic gives them: the
    first NaN operand, quieted, else the default NaN (0xFFC00000). A
    card makes its own canonical NaN, so an op whose NaN bits matter
    passes its result through here on every device."""
    fill = x86_nan_like(res)
    for op in reversed(operands):
        if isinstance(op, torch.Tensor) and op.is_floating_point():
            op = op.to(torch.float32)
            quiet = (op.view(torch.int32) | 0x400000).view(torch.float32)
            fill = torch.where(torch.isnan(op), quiet, fill)
    return torch.where(torch.isnan(res), fill, res)


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
    r = xla_logf(t)
    return torch.where(torch.isnan(r), r, r * _LOG10_E)


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


def xla_powf(t: torch.Tensor, y) -> torch.Tensor:
    """``t ** y`` for a float32 tensor and a scalar or float32 tensor
    exponent, bit for bit as XLA:CPU's f32 ``pow`` (the C library's
    ``powf``): a scalar y is rounded to float32 first, as ``jnp.power``
    does with a Python float."""
    import numpy as np
    x = t.to(torch.float32)
    dev = x.device
    if isinstance(y, torch.Tensor):
        yt = y.to(torch.float32)
        x, yt = torch.broadcast_tensors(x, yt)
        yf = yt.to(torch.float64)
    else:
        yf = float(np.float32(y))
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
    if isinstance(yf, torch.Tensor):
        out = torch.where(special, torch.where(yf < 0, 1.0 / sq, sq), out)
        # a negative x: NaN unless y is an integer, negated when y is
        # odd (every float32 of magnitude 2^24 or more is even)
        integral = yf == torch.trunc(yf)
        odd = integral & (torch.fmod(yf, 2.0) != 0)
        out = torch.where(neg & odd, -out, out)
        out = torch.where(neg & ~special & ~integral, x86_nan_like(out),
                          out)
        # y = 0 and x = 1 give 1 whatever the other operand
        return torch.where((yf == 0) | (x == 1.0), torch.ones_like(out),
                           out)
    out = torch.where(special, 1.0 / sq if yf < 0 else sq, out)
    # a negative x: NaN unless y is an integer, negated when y is odd
    if yf == int(yf):
        if int(yf) % 2:
            out = torch.where(neg, -out, out)
    else:
        # the C library's 0/0: the x86 default NaN
        out = torch.where(neg & ~special, x86_nan_like(out), out)
    return out


# ---------------------------------------------------------------------------
# float32 exp
# ---------------------------------------------------------------------------
#
# XLA:CPU lowers f32 ``exp`` to its own Cephes-style polynomial (no
# library call): the input clamped to [-87.8, 88.8], n = floor(x·log2e
# + 1/2) clamped to [-127, 127], r = x - n·C1 - n·C2 (ln 2 in two
# parts), a degree-5 Horner chain in r, then (p·r² + r) + 1 scaled by
# 2^n built from the exponent bits. Its machine code fuses every
# multiply-add of the chain; the product r·r and the last +1 and ·2^n
# are single float32 ops.

_EXP_LO = _h("-0x1.5f3334p+6")
_EXP_HI = _h("0x1.633334p+6")
_EXP_LOG2E = _h("0x1.715476p+0")
_EXP_C1 = _h("0x1.63p-1")
_EXP_C2 = _h("-0x1.bd0106p-13")
_EXP_POLY = tuple(_h(c) for c in (
    "0x1.a0d2cep-13", "0x1.6e879cp-10", "0x1.111210p-7", "0x1.555382p-5",
    "0x1.555554p-3", "0x1p-1"))


def xla_expf(t: torch.Tensor) -> torch.Tensor:
    """Natural exponential of a float32 tensor, bit for bit as
    XLA:CPU's ``jnp.exp``."""
    x = torch.clamp(t.to(torch.float32), _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(_fma(x, _EXP_LOG2E, 0.5)), -127.0, 127.0)
    r = _fma(n, -_EXP_C1, x)
    r = _fma(n, -_EXP_C2, r)
    y = _fma(r, _EXP_POLY[0], _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return xla_ftz(y * scale)


# ---------------------------------------------------------------------------
# float32 sin, cos, tan
# ---------------------------------------------------------------------------
#
# XLA:CPU lowers f32 ``sin``, ``cos`` and ``tan`` to calls of the C
# library's ``sinf``, ``cosf`` and ``tanf``. The reference's host (glibc
# 2.36 on x86-64 with FMA) computes sinf and cosf with the ARM
# optimized-routines algorithm: the argument in float64, reduced by one
# fused n·(pi/2) step below 120 or by an integer product with 4/pi's
# bits above, then a polynomial in float64 (its multiply-adds fused),
# one rounding to float32. Its tanf reduces the same way and evaluates
# fdlibm's float32 kernel (``__kernel_tanf``, no fused ops) on the
# reduced pair. The functions below are those algorithms in torch ops,
# float64 products fused by ``_fma64``, so the CPU and a card give the
# same bits, and those of the reference.

_PI63 = _h("0x1.921fb54442d18p-62")        # 2pi · 2^-64
_HPI = _h("0x1.921fb54442d18p0")
_HPI_INV = _h("0x1.45f306dc9c883p+23")     # 2/pi · 2^24
#: (c0, c1, c2, c3, c4, s1, s2, s3): the cosine and sine polynomials, the
#: cosine's negated in the second table
_SINCOS_TABLES = tuple(tuple(_h(c) for c in t) for t in (
    ("0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
     "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16",
     "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
     "-0x1.994eb3774cf24p-13"),
    ("-0x1p0", "0x1.ffffffd0c621cp-2", "-0x1.55553e1068f19p-5",
     "0x1.6c087e89a359dp-10", "-0x1.99343027bf8c3p-16",
     "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
     "-0x1.994eb3774cf24p-13")))
#: 4/pi to 192 bits, 8 new bits an entry
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
    0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757,
    0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
    0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c,
    0x95993c43, 0x993c4390, 0x3c439041)
# the top 12 bits (exponent and 3 mantissa bits) of |pi/4|, 2^-12, 120
# and infinity as float32s: the C code's branch thresholds
_TOP12_PIO4, _TOP12_TINY, _TOP12_120, _TOP12_INF = 0x3f4, 0x39800000 >> 20, \
    0x42f00000 >> 20, 0x7f800000 >> 20


def _sincos_reduce(y: torch.Tensor):
    """(r f64, n int64, the float's bits as int64): y = r + n·pi/2, |r|
    <= pi/4, the C library's reduction (fast below 120, else the 4/pi
    bit product, its sign restored)."""
    bits = y.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    x = y.to(torch.float64)
    # fast: n = round(x · 2/pi) from the 2^24-scaled product's int32
    n_fast = (((x * _HPI_INV).to(torch.int32).to(torch.int64)
               + 0x800000) >> 24)
    r_fast = _fma64(-n_fast.to(torch.float64), _HPI, x)
    # large: a 32×96-bit product with 4/pi's bits, the quadrant in the
    # top two bits (int64 arithmetic wraps as the C code's uint64 does)
    arr = torch.tensor(_INV_PIO4, dtype=torch.int64, device=y.device)
    idx = (bits >> 26) & 15
    m = ((bits & 0xFFFFFF) | 0x800000) << ((bits >> 23) & 7)
    res0 = (m * arr[idx]) & 0xFFFFFFFF
    res0 = ((m * arr[idx + 8]) >> 32) | (res0 << 32)
    res0 = res0 + m * arr[idx + 4]
    n_large = ((res0 + (1 << 61)) >> 62) & 3
    r_large = (res0 - (n_large << 62)).to(torch.float64) * _PI63
    fast = ((bits >> 20) & 0x7FF) < _TOP12_120
    return (torch.where(fast, r_fast, r_large),
            torch.where(fast, n_fast, n_large), bits, fast)


def _sincos_poly(x, x2, odd, tab):
    """The C library's sinf_poly: the sine polynomial, or the cosine's
    where `odd`, every multiply-add fused."""
    c0, c1, c2, c3, c4, s1, s2, s3 = (tab[..., i] for i in range(8))
    x3 = x * x2
    sin = _fma64(x3 * x2, _fma64(x2, s3, s2), _fma64(x3, s1, x))
    x4 = x2 * x2
    cos = _fma64(x4 * x2, _fma64(x2, c4, c3),
                 _fma64(x4, c2, _fma64(x2, c1, c0)))
    return torch.where(odd, cos, sin)


def _sincosf(t: torch.Tensor, cos: bool) -> torch.Tensor:
    y = t.to(torch.float32)
    r, n, bits, fast = _sincos_reduce(y)
    x = y.to(torch.float64)
    tables = torch.tensor(_SINCOS_TABLES, dtype=torch.float64,
                          device=y.device)
    top12 = (bits >> 20) & 0x7FF
    # the quadrant's sign and table (the large path adds the sign bit)
    q = torch.where(fast, n, n + (bits >> 31)) & 3
    sign = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=torch.float64,
                        device=y.device)[q]
    odd = ((n ^ int(cos)) & 1) == 1
    out = _sincos_poly(r * sign, r * r, odd, tables[(q >> 1) & 1])
    small = top12 < _TOP12_PIO4
    out = torch.where(small, _sincos_poly(
        x, x * x, torch.full_like(small, cos), tables[0].expand(
            *x.shape, 8)), out)
    tiny = top12 < _TOP12_TINY
    out = torch.where(tiny, torch.ones_like(x) if cos else x, out)
    out = out.to(torch.float32)
    # inf or NaN: y - y (the C code's invalid result)
    return torch.where(top12 >= _TOP12_INF, y - y, out)


def libm_sinf(t: torch.Tensor) -> torch.Tensor:
    """sin of a float32 tensor, bit for bit as the C library's sinf."""
    return _sincosf(t, cos=False)


def libm_cosf(t: torch.Tensor) -> torch.Tensor:
    """cos of a float32 tensor, bit for bit as the C library's cosf."""
    return _sincosf(t, cos=True)


#: fdlibm's __kernel_tanf coefficients (float32)
_TANF_T = tuple(_h(c) for c in (
    "0x1.555556p-2", "0x1.111112p-3", "0x1.ba1ba2p-5", "0x1.664f48p-6",
    "0x1.226e3ep-7", "0x1.d6d22cp-9", "0x1.7dbc9p-10", "0x1.344d9p-11",
    "0x1.026f72p-12", "0x1.47e88ap-14", "0x1.2b80f4p-14",
    "-0x1.375cbep-16", "0x1.b2a708p-16"))
_TANF_PIO4 = _h("0x1.921fb4p-1")
_TANF_PIO4LO = _h("0x1.4442dp-25")


def _kernel_tanf(x, y, iy):
    """fdlibm's float32 __kernel_tanf: tan(x + y), or -1/tan(x + y)
    where iy is -1, for |x + y| <= pi/4."""
    f = torch.float32
    hx = x.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    big = ix >= 0x3F2CA140                 # |x| >= 0.6744
    neg = hx < 0
    xb = (_TANF_PIO4 - torch.where(neg, -x, x)) \
        + (_TANF_PIO4LO - torch.where(neg, -y, y))
    x2 = torch.where(big, xb, x)
    y2 = torch.where(big, torch.zeros_like(y), y)
    T = _TANF_T
    z = x2 * x2
    w = z * z
    r = T[1] + w * (T[3] + w * (T[5] + w * (T[7] + w * (T[9] + w * T[11]))))
    v = z * (T[2] + w * (T[4] + w * (T[6] + w * (T[8] + w * (
        T[10] + w * T[12])))))
    s = z * x2
    r = y2 + z * (s * (r + v) + y2)
    r = r + T[0] * s
    w = x2 + r
    ivf = iy.to(f)
    sgn = (1 - ((hx >> 30) & 2)).to(f)
    out_big = sgn * (ivf - 2.0 * (x2 - (w * w / (w + ivf) - r)))
    # -1/(x + r), to full accuracy by a split of w and of its reciprocal
    zh = (w.view(torch.int32) & -4096).view(f)
    vv = r - (zh - x2)
    a = -1.0 / w
    th = (a.view(torch.int32) & -4096).view(f)
    out_neg = th + a * ((1.0 + th * zh) + th * vv)
    out = torch.where(big, out_big, torch.where(iy == 1, w, out_neg))
    # |x| < 2^-13: x, or -1/x
    out = torch.where(ix < 0x39000000,
                      torch.where(iy == 1, x, -1.0 / x), out)
    # the big branch's reduced value under 2^-13
    near = big & (xb.abs() < 2.0 ** -13)
    return torch.where(near, sgn * ivf * (1.0 - 2 * ivf * xb), out)


def libm_tanf(t: torch.Tensor) -> torch.Tensor:
    """tan of a float32 tensor, bit for bit as the C library's tanf: the
    sinf reduction to a float32 pair (y0, y1) and fdlibm's kernel."""
    x = t.to(torch.float32)
    r, n, bits, fast = _sincos_reduce(x)
    # the large path's remainder carries no sign: the argument's
    r = torch.where(fast | ((bits >> 31) == 0), r, -r)
    y0 = r.to(torch.float32)
    y1 = (r - y0.to(torch.float64)).to(torch.float32)
    ix = x.view(torch.int32) & 0x7FFFFFFF
    nored = ix <= 0x3F490FDA               # |x| ~<= pi/4
    y0 = torch.where(nored, x, y0)
    y1 = torch.where(nored, torch.zeros_like(y1), y1)
    n = torch.where(nored, torch.zeros_like(n), n)
    out = _kernel_tanf(y0, y1, (1 - ((n & 1) << 1)).to(torch.int32))
    return torch.where(ix >= 0x7F800000, x - x, out)


# ---------------------------------------------------------------------------
# XLA:CPU's sums: the gemv tiling and the windowed row sum
# ---------------------------------------------------------------------------

def xla_round(x64: torch.Tensor) -> torch.Tensor:
    """A float64 result rounded to float32 as XLA:CPU rounds an op's
    result: to nearest, then flushed to a zero of its sign where it is
    tiny after rounding, x86's rule under FTZ: its value rounded to 24
    bits with an unbounded exponent below the smallest normal. That
    flushes results in [2^-126 - 2^-150, 2^-126 - 2^-151), which round
    to 2^-126 on float32's subnormal grid (where ``xla_ftz`` of a float32
    op's result keeps them); an H100's ``.ftz`` operations follow the same
    rule (``tools/ftz_probe.py``). Only a product or a fused
    multiply-add or a quotient reaches that band (``xla_mulf``,
    ``xla_fmaf``, ``xla_divf``): a sum of normal values that is below
    2^-126 is exact. `x64` is the exact result, a quotient rounded once
    in float64, or a fused sum rounded to odd (``xla_fmaf``)."""
    r = x64.to(torch.float32)
    tiny = (x64 * 2.0 ** 64).to(torch.float32).abs() < 2.0 ** -62
    return torch.where(tiny, r * 0.0, r)


def _wide(v):
    """A float32 tensor (its denormals read as zeros, XLA:CPU's DAZ) or a
    Python float, in float64."""
    return xla_ftz(v).to(torch.float64) if isinstance(v, torch.Tensor) \
        else float(v)


def xla_mulf(a, b) -> torch.Tensor:
    """float32 ``a * b`` as XLA:CPU computes it (``xla_round``)."""
    return xla_round(_wide(a) * _wide(b))


def xla_divf(a, b) -> torch.Tensor:
    """float32 ``a / b`` as XLA:CPU computes it (``xla_round`` of the
    float64 quotient: rounding that to 24 bits gives the exact quotient's
    rounding, 53 >= 2 * 24 + 2 bits, so the flush sees the exact value)."""
    return xla_round(_wide(a) / _wide(b))


def xla_fmaf(a64: torch.Tensor, b64: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once, as a hardware FMA rounds it, with
    XLA:CPU's flush (``xla_round``). `a64`, `b64` are float32 values held
    in float64 (their product is exact there), `c` float32. The float64
    sum is rounded to odd (an inexact sum with an even last bit moves one
    ulp toward the exact value), so its rounding to float32 is the single
    rounding of the exact sum."""
    p = a64 * b64
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    bits = s.view(torch.int64)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    fix = (e != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    bits = torch.where(fix, bits + step, bits)
    return xla_round(bits.view(torch.float64))


def xla_gemv(mat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """`mat @ q` for f32[n, dims] × f32[dims] (→ [n]) or × f32[b, dims]
    (→ [b, n], one gemv a query) in XLA:CPU's association, its row-major
    gemv tiling: eight lane accumulators, lane j a fused multiply-add
    chain over columns j, j+8, ...; the lanes summed
    ((l0+l1)+(l2+l3))+((l4+l5)+(l6+l7)); then the fused chain of the
    columns past the last multiple of eight, from 0, added to that.
    Every step flushes a denormal result.

    XLA:CPU's gemv keeps this association only for the rows up to the
    last multiple of 8; the rows past it are summed in another, so `n`
    must be a multiple of 8 (a segment's d_pad always is)."""
    n, dims = mat.shape
    if n % 8:
        raise ValueError(f"xla_gemv takes a multiple of 8 rows (XLA:CPU "
                         f"sums the rows past one in another order), got "
                         f"{n}")
    full = (dims // 8) * 8
    m64 = mat.to(torch.float64)
    q64 = q.to(torch.float64)
    zero = torch.zeros(q.shape[:-1] + (n,), dtype=torch.float32,
                       device=mat.device)

    def chain(cols):
        acc = zero
        for k in cols:
            acc = xla_fmaf(q64[..., k, None], m64[:, k], acc)
        return acc
    tail = chain(range(full, dims))
    if not full:
        return tail
    lanes = [chain(range(j, full, 8)) for j in range(8)]

    def add(x, y):
        return xla_ftz(x + y)
    tree = add(add(add(lanes[0], lanes[1]), add(lanes[2], lanes[3])),
               add(add(lanes[4], lanes[5]), add(lanes[6], lanes[7])))
    return add(tree, tail)


def xla_row_sum(x: torch.Tensor) -> torch.Tensor:
    """`jnp.sum(x, axis=-1)` of f32[..., K] in XLA:CPU's association: a
    row longer than 32 is cut into windows of 32 (zero-padded, the pad
    split low = total // 2, high = the rest), each summed left to right
    from 0; the window sums are reduced again the same way."""
    while x.shape[-1] > 32:
        k = x.shape[-1]
        nw = -(-k // 32)
        pad = nw * 32 - k
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = xla_seq_sum(x.reshape(*x.shape[:-1], nw, 32))
    return xla_seq_sum(x)


def xla_seq_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis left to right from 0, each step
    flushed."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        acc = xla_ftz(acc + x[..., k])
    return acc
