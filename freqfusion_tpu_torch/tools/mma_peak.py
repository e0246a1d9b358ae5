"""Measures the card's rate of `mma.sync.m16n8k8` TF32 tensor-core products, the instruction
that `csrc/mma_f32x3.cuh` builds its f32-exact (3xTF32) products from.

    python -m freqfusion_tpu_torch.tools.mma_peak      # needs a CUDA card and nvcc

Every warp runs eight independent accumulator chains of MMAs on register operands (no
memory traffic), at 1, 2 and 4 blocks of 8 warps an SM; the best rate is the ceiling of any
kernel built on `mma.sync`, and a third of it the ceiling of its 3xTF32 products. Prints one
JSON line with the rates in TFLOP/s and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

import torch

from ..ops.kernels import _build

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) mma_loop(float* out, int iters) {
    float d[8][4] = {};
    uint32_t a[4], b[2];
    for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(threadIdx.x * 1e-3f + i) & 0xffffe000u;
    b[0] = a[1];
    b[1] = a[2];
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
            asm volatile(
                "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
    float s = 0.f;
    for (int j = 0; j < 8; ++j)
        for (int r = 0; r < 4; ++r) s += d[j][r];
    if (s == 1234.5f) out[0] = s;  // keeps the chains live
}
extern "C" int mma_loop_launch(float* out, int blocks, int iters, void* stream) {
    mma_loop<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
    return cudaGetLastError();
}
"""


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mma_peak: no CUDA card")
    build = _build.BUILD_DIR / "mma_peak"
    build.mkdir(parents=True, exist_ok=True)
    src, lib_path = build / "mma_peak.cu", build / "libmma_peak.so"
    src.write_text(SOURCE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_loop_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.mma_loop_launch.restype = ctypes.c_int
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, rates = 8192, {}
    for per_sm in (1, 2, 4):
        blocks = sms * per_sm
        _build.check(lib.mma_loop_launch(out.data_ptr(), blocks, 16, stream), "mma_loop")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _build.check(lib.mma_loop_launch(out.data_ptr(), blocks, iters, stream), "mma_loop")
        end.record()
        end.synchronize()
        flops = blocks * 8 * iters * 8 * 2 * 16 * 8 * 8   # warps x iters x chains x m16n8k8
        rates[f"{per_sm}_blocks_per_sm"] = flops / (start.elapsed_time(end) * 1e-3) / 1e12
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    best = max(rates.values())
    print(json.dumps({"mma_sync_tf32_tflops": rates, "best_tflops": best,
                      "f32x3_ceiling_tflops": best / 3, "card": smi}))


if __name__ == "__main__":
    main()
