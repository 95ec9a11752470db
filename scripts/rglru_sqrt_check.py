#!/usr/bin/env python3
"""Every float in the range of the RG-LRU kernel's square root, on the card.

    python3 scripts/rglru_sqrt_check.py

Needs one CUDA card and nvcc. ``csrc/rglru.cu`` forms the gate's square
root with ``sqrt_normal``, the fast path of the compiler's IEEE ``sqrtf``
without its branch to the slow path; its bit-identity to the plain
version rests on that path giving sqrtf's bits wherever the gate calls
it (the clip keeps its input in [1e-9, 1]). This script compiles a small
source that includes ``csrc/rglru.cu`` itself (with ``_build.NVCC_FLAGS``,
into ``build/repro_torch/``) and compares ``sqrt_normal`` with ``sqrtf``
bit for bit over every float of [1e-9, 1] and of the whole fast-path range
[2^-101, FLT_MAX]. Exits non-zero on any difference.
"""

from __future__ import annotations

import ctypes
import struct
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

SOURCE = r'''
#include "%s"

__global__ void sqrt_cmp(uint32_t lo, uint64_t n, unsigned long long* bad,
                         unsigned* first) {
  for (uint64_t k = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; k < n;
       k += (uint64_t)gridDim.x * blockDim.x) {
    const uint32_t bits = lo + (uint32_t)k;
    const float x = __uint_as_float(bits);
    if (__float_as_uint(sqrt_normal(x)) != __float_as_uint(sqrtf(x))) {
      atomicAdd(bad, 1ull);
      atomicMin(first, bits);
    }
  }
}

// floats with bits in [lo, hi] where sqrt_normal differs from sqrtf (-1
// on a CUDA error); *first gets the smallest such bits, or ~0
extern "C" long long sqrt_check(unsigned lo, unsigned hi, unsigned* first) {
  unsigned long long* bad = nullptr;
  unsigned* f = nullptr;
  cudaMalloc(&bad, 8);
  cudaMalloc(&f, 4);
  cudaMemset(bad, 0, 8);
  cudaMemset(f, 0xff, 4);
  sqrt_cmp<<<132 * 16, 256>>>(lo, (uint64_t)hi - lo + 1, bad, f);
  unsigned long long n = 0;
  cudaMemcpy(&n, bad, 8, cudaMemcpyDeviceToHost);
  cudaMemcpy(first, f, 4, cudaMemcpyDeviceToHost);
  const cudaError_t err = cudaGetLastError();
  cudaFree(bad);
  cudaFree(f);
  return err != cudaSuccess ? -1 : (long long)n;
}
'''


def f32_bits(v: float) -> int:
    return struct.unpack("<I", struct.pack("<f", v))[0]


def main() -> None:
    card = cs.card_line()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "rglru_sqrt_check.cu"
    lib_path = _build.BUILD_DIR / "rglru_sqrt_check.so"
    src.write_text(SOURCE % (_build.CSRC / "rglru.cu"))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.sqrt_check.restype = ctypes.c_longlong
    lib.sqrt_check.argtypes = [ctypes.c_uint, ctypes.c_uint,
                               ctypes.POINTER(ctypes.c_uint)]
    for name, lo, hi in (("[1e-9, 1], the gate's clip", f32_bits(1e-9),
                          f32_bits(1.0)),
                         ("[2^-101, FLT_MAX], the fast path", 0x0D000000,
                          0x7F7FFFFF)):
        first = ctypes.c_uint(0)
        n = lib.sqrt_check(lo, hi, ctypes.byref(first))
        cs.log(f"sqrt_normal against sqrtf over {name}: {hi - lo + 1} "
               f"floats, {n} differ  [{card}]")
        cs.check(n == 0, f"sqrt_normal differs from sqrtf over {name} "
                 f"({n} floats, the first {first.value:#x})")


if __name__ == "__main__":
    main()
