"""Where the tile kernel of ``csrc/knn.cu`` spends its time, on one card.

    python3 elasticsearch_tpu_torch/tools/knn_ablate.py

builds ``csrc/knn.cu`` and three variants of its tile kernel
(``knn_tile_kernel``), each with one part taken out, and times the
launch of 64 seeded queries against 1,001,472 seeded rows of 768 dims
(chip_smoke's timed knn shape; every 100th row NaN) for cosine under the
mesh formula and dot_product under the segment formula (no norms, no
nan_to_num): the median of 7 CUDA-event brackets. The variants:

* ``no_fma``: the loop of fused multiply-adds runs no step;
* ``no_staging``: no stage is copied to shared memory (the kernel
  computes on what is there);
* ``no_windows``: no row sums of squares (the norms) are taken.

Their scores are wrong; only their times are read. Beside them, two
loops on one block an SM for 2,000 passes over 128 staged columns: the
tile kernel's 128 accumulators a thread fed from shared memory (its
mapping and 8-byte loads), and the same accumulators fed from registers
alone (the card's FP32 rate). One JSON line: the card, ptxas registers of
each build, ms per variant, and TFLOP/s of the two loops. Needs nvcc and
a card.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE_ROOT = Path(__file__).resolve().parents[2]
SOURCE = HERE_ROOT / "elasticsearch_tpu_torch" / "csrc" / "knn.cu"

#: variant -> (text of the tile kernel, its replacement)
VARIANTS = {
    "no_fma": ("const int steps = (cols < kStageCols ? cols : kStageCols) "
               "/ 8;", "const int steps = 0;"),
    "no_staging": ("    if (g < ring.G) stage(g, false);",
                   "    if (false) stage(g, false);"),
    "no_windows": ("  const bool norms = kind == kCosine || (mesh && kind == "
                   "kL2);", "  const bool norms = false;"),
}

LOOPS = r'''
#include <cuda_runtime.h>
constexpr int kPitch = 136;
__device__ __forceinline__ float fz(float a, float b, float c) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return r;
}
// SMEM 1: the tile kernel's step, operands from shared memory; 0: the
// same 128 accumulators, operands from registers
template <int SMEM>
__global__ void __launch_bounds__(256, 1) loop(float* out, int reps) {
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, e = lane & 3;
  for (int i = t; i < 128 * kPitch; i += 256) sm[i] = 1e-3f * (i % 97);
  __syncthreads();
  const float* D = sm + (16 * (warp & 3) + ((lane >> 2) & 1)) * kPitch + 2 * e;
  const float* Q = sm + (64 + 32 * (warp >> 2) + (lane >> 3)) * kPitch + 2 * e;
  float acc[8][8][2];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int qi = 0; qi < 8; ++qi)
      acc[i][qi][0] = acc[i][qi][1] = t + 16 * i + 2 * qi;
  float2 dr = make_float2(1.0f + t, 2.0f), qr = make_float2(1e-9f, 2e-9f);
  for (int r = 0; r < reps; ++r)
    for (int ks = 0; ks < 16; ++ks) {
      float2 dv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dv[i] = SMEM ? *reinterpret_cast<const float2*>(D + 2 * i * kPitch + 8 * ks) : dr;
#pragma unroll
      for (int qi = 0; qi < 8; ++qi) {
        const float2 q = SMEM ? *reinterpret_cast<const float2*>(Q + 4 * qi * kPitch + 8 * ks) : qr;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][qi][0] = fz(dv[i].x, q.x, acc[i][qi][0]);
          acc[i][qi][1] = fz(dv[i].y, q.y, acc[i][qi][1]);
        }
      }
    }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int qi = 0; qi < 8; ++qi) s += acc[i][qi][0] + acc[i][qi][1];
  out[blockIdx.x * 256 + t] = s;
}
extern "C" float es_loop_ms(int smem_fed, int blocks, int reps, float* out) {
  const int smem = 128 * kPitch * 4;
  cudaFuncSetAttribute(loop<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(loop<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  auto go = [&]() {
    if (smem_fed) loop<1><<<blocks, 256, smem>>>(out, reps);
    else loop<0><<<blocks, 256, smem>>>(out, reps);
  };
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  go();
  cudaEventRecord(e0);
  go();
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = -1.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}
'''


def build(src: str, tmp: Path, name: str):
    """nvcc `src` with the package's flags → (library, ptxas registers of
    each kernel)."""
    from elasticsearch_tpu_torch.ops import _build
    cu = tmp / f"{name}.cu"
    cu.write_text(src)
    lib = tmp / f"lib{name}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    regs, entry = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[short_name(entry)] = int(m.group(1))
            entry = None
    return ctypes.CDLL(str(lib)), regs


def short_name(mangled: str) -> str:
    """knn_tile, knn_row_8, knn_row_1, knn_qss, loop_registers_fed,
    loop_shared_memory_fed."""
    for key in ("knn_tile", "knn_qss"):
        if key in mangled:
            return key
    if "knn_row" in mangled:
        return "knn_row_1" if "ILi1E" in mangled else "knn_row_8"
    return "loop_shared_memory_fed" if "ILi1E" in mangled \
        else "loop_registers_fed"


def main() -> int:
    sys.path.insert(0, str(HERE_ROOT))
    import torch
    if not torch.cuda.is_available():
        print("knn_ablate: no CUDA device available", file=sys.stderr)
        return 2
    from elasticsearch_tpu_torch.ops import knn_kernel

    base = SOURCE.read_text()
    tile = base.index("knn_tile_kernel(const float*")
    sources = {"base": base}
    for name, (old, new) in VARIANTS.items():
        at = base.index(old, tile)
        sources[name] = base[:at] + new + base[at + len(old):]
    gen = torch.Generator(device="cuda").manual_seed(17)
    n, dims, b = 1_001_472, 768, 64
    vectors = torch.randn(n, dims, device="cuda", generator=gen)
    vectors[::100] = float("nan")
    queries = torch.randn(b, dims, device="cuda", generator=gen)
    ok = torch.ones(n, dtype=torch.uint8, device="cuda")
    qss = torch.empty(b, device="cuda")
    out = torch.empty(b, n, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    result = {"shape": {"queries": b, "rows": n, "dims": dims}}
    with tempfile.TemporaryDirectory() as tmp:
        for name, src in sources.items():
            lib, regs = build(src, Path(tmp), name)
            fn = lib.es_knn_scores
            fn.argtypes = knn_kernel._SIGNATURES["es_knn_scores"]
            fn.restype = ctypes.c_int
            row = {"registers": regs}
            for label, kind, mesh in (("mesh_cosine", 2, 1),
                                      ("segment_dot_product", 1, 0)):
                def call():
                    err = fn(vectors.data_ptr(), n, dims, queries.data_ptr(),
                             b, ok.data_ptr(), kind, mesh, 0, 0.0,
                             qss.data_ptr(), out.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")
                call()
                torch.cuda.synchronize()
                times = []
                for _ in range(7):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    call()
                    end.record()
                    torch.cuda.synchronize()
                    times.append(start.elapsed_time(end))
                row[label + "_ms"] = statistics.median(times)
            result[name] = row
        lib, regs = build(LOOPS, Path(tmp), "loops")
        lib.es_loop_ms.restype = ctypes.c_float
        lib.es_loop_ms.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        buf = torch.empty(sms * 256, device="cuda")
        reps = 2000
        flops = 2 * 64 * 64 * 128 * reps * sms
        loops = {"registers": regs}
        for label, fed in (("registers_fed", 0), ("shared_memory_fed", 1)):
            ms = lib.es_loop_ms(fed, sms, reps, buf.data_ptr())
            loops[label] = {"ms": ms, "tflops": flops / ms / 1e9}
        result["loops"] = loops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": smi, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
