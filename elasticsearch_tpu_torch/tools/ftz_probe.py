"""Which flush-to-zero rule a card's ``.ftz`` arithmetic follows.

    python3 elasticsearch_tpu_torch/tools/ftz_probe.py

builds a small CUDA source (nvcc, the package's flags) into a temporary
directory, runs ``fma.rn.ftz.f32`` and ``mul.rn.ftz.f32`` on operands
whose exact results lie within a few units of 2^-150 of FLT_MIN (and on
exact ties there), beside ``ftz(__fmaf_rn(...))`` and
``ftz(__fmul_rn(...))`` (round first, then flush a result below
FLT_MIN: the rule of ``ops/knn_kernel.knn_scores_plain`` and of the old
``csrc/knn.cu``), and prints one JSON line: for each op, the cases and
how many of the card's results differ from each of three rules, worked
out here exactly with fractions:

* ``after_subnormal_rounding``: round to float32's grid (subnormals
  included), flush a result below FLT_MIN (the plain version's rule);
* ``before_rounding``: flush an exact result below FLT_MIN;
* ``after_rounding_unbounded``: flush where the result rounded to 24
  bits with an unbounded exponent is below FLT_MIN (IEEE 754's
  tininess after rounding, as x86 detects it).

A flush result is a zero of the exact result's sign. Needs nvcc and a
card; run it on the machine with the card.
"""

from __future__ import annotations

import ctypes
import json
import random
import struct
import subprocess
import sys
import tempfile
from fractions import Fraction
from pathlib import Path

HERE_ROOT = Path(__file__).resolve().parents[2]

SOURCE = r"""
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
namespace {
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x;
}
__global__ void probe_kernel(const float* a, const float* b, const float* c,
                             float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = a[i], y = b[i], z = c[i];
  float hf, hm;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(hf) : "f"(x), "f"(y), "f"(z));
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(hm) : "f"(x), "f"(y));
  out[4 * i + 0] = hf;
  out[4 * i + 1] = ftz(__fmaf_rn(x, y, z));
  out[4 * i + 2] = hm;
  out[4 * i + 3] = ftz(__fmul_rn(x, y));
}
}  // namespace
extern "C" int es_ftz_probe(const float* a, const float* b, const float* c,
                            float* out, int n) {
  float *da, *db, *dc, *dout;
  cudaMalloc(&da, n * 4); cudaMalloc(&db, n * 4); cudaMalloc(&dc, n * 4);
  cudaMalloc(&dout, n * 16);
  cudaMemcpy(da, a, n * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(db, b, n * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(dc, c, n * 4, cudaMemcpyHostToDevice);
  probe_kernel<<<(n + 127) / 128, 128>>>(da, db, dc, dout, n);
  cudaError_t err = cudaMemcpy(out, dout, n * 16, cudaMemcpyDeviceToHost);
  cudaFree(da); cudaFree(db); cudaFree(dc); cudaFree(dout);
  return (int)err;
}
"""

MIN_NORM = Fraction(1, 2 ** 126)
RULES = ("after_subnormal_rounding", "before_rounding",
         "after_rounding_unbounded")


def f32(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def bits_of(x: float) -> int:
    return struct.unpack("<I", struct.pack("<f", x))[0]


def _round(x: Fraction, ulp: Fraction) -> Fraction:
    """x rounded to a multiple of ulp, ties to even."""
    q, r = divmod(x / ulp, 1)
    if r > Fraction(1, 2) or (r == Fraction(1, 2) and q % 2):
        q += 1
    return q * ulp


def _ulp24(x: Fraction) -> Fraction:
    """The spacing of 24-bit significands at |x| (unbounded exponent)."""
    e = 0
    a = abs(x)
    while a >= 2:
        a /= 2
        e += 1
    while a < 1:
        a *= 2
        e -= 1
    return Fraction(2) ** (e - 23)


def expected(x: Fraction, rule: str) -> float:
    """float32 result of exact value x under `rule` (x near FLT_MIN, far
    from overflow); a flush gives a zero of x's sign."""
    neg = x < 0
    zero = -0.0 if neg else 0.0
    if x == 0:
        return 0.0
    sub = _round(x, Fraction(1, 2 ** 149))
    if rule == "after_subnormal_rounding":
        r = sub
        if abs(r) < MIN_NORM:
            return zero
    elif rule == "before_rounding":
        if abs(x) < MIN_NORM:
            return zero
        r = _round(x, _ulp24(x))
    else:
        r24 = _round(x, _ulp24(x))
        if abs(r24) < MIN_NORM:
            return zero
        r = r24
    return float(r)


def cases(n: int = 4096, seed: int = 17):
    """(a, b, c) float32 triples whose fma (and, for c = 0, product)
    lands within a few 2^-150 of ±FLT_MIN, plus exact ties."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        # a in [0.5, 1), b = FLT_MIN / a nudged (normal, below 2 FLT_MIN):
        # a * b ~ FLT_MIN (1 + d)
        a = f32(0x3F000000 | rng.getrandbits(23))
        b = float(Fraction(f32(0x00800000)) / Fraction(a))
        b = f32(bits_of(b) + rng.randint(-3, 3))
        sign = -1.0 if i % 2 else 1.0
        if i % 4 < 2:
            out.append((sign * a, b, 0.0))
        else:
            # c = 2 FLT_MIN, a * b ~ -FLT_MIN (1 + d): the sum ~ FLT_MIN
            out.append((-sign * a, b, sign * f32(0x01000000)))
    # the exact tie FLT_MIN - 2^-150: FLT_MIN after subnormal rounding,
    # a zero by the other two rules
    one_less = f32(0x3F7FFFFF)          # 1 - 2^-24
    out += [(one_less, f32(0x00800000), 0.0),
            (-one_less, f32(0x00800000), 0.0)]
    return out


def main() -> int:
    sys.path.insert(0, str(HERE_ROOT))
    from elasticsearch_tpu_torch.ops import _build
    trips = cases()
    n = len(trips)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "probe.cu"
        src.write_text(SOURCE)
        lib_path = Path(tmp) / "libprobe.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(lib_path), str(src)], check=True)
        lib = ctypes.CDLL(str(lib_path))
        arr = ctypes.c_float * n
        a, b, c = (arr(*[t[j] for t in trips]) for j in range(3))
        out = (ctypes.c_float * (4 * n))()
        err = lib.es_ftz_probe(a, b, c, out, n)
        if err:
            print(f"ftz_probe: cudaError {err}", file=sys.stderr)
            return 1
    report = {}
    for op, hw_col, sw_col in (("fma", 0, 1), ("mul", 2, 3)):
        diff = {rule: 0 for rule in RULES}
        sw_diff, examples = 0, []
        for i, (x, y, z) in enumerate(trips):
            exact = Fraction(x) * Fraction(y) + (Fraction(z) if op == "fma"
                                                 else 0)
            hw, sw = out[4 * i + hw_col], out[4 * i + sw_col]
            for rule in RULES:
                if bits_of(expected(exact, rule)) != bits_of(hw):
                    diff[rule] += 1
            if bits_of(expected(exact, RULES[0])) != bits_of(sw):
                sw_diff += 1
            if bits_of(hw) != bits_of(sw) and len(examples) < 4:
                examples.append({"a": x.hex(), "b": y.hex(), "c": z.hex(),
                                 "exact_minus_flt_min_in_2^-150":
                                 float((abs(exact) - MIN_NORM)
                                       * 2 ** 150),
                                 "ftz_op": hw.hex(), "flush_after": sw.hex()})
        report[op] = {"cases": n, "ftz_op_differs_from": diff,
                      "flush_after_differs_from_plain": sw_diff,
                      "ftz_op_differs_from_flush_after": sum(
                          bits_of(out[4 * i + hw_col])
                          != bits_of(out[4 * i + sw_col])
                          for i in range(n)),
                      "examples": examples}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": smi, **report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
