// Shared device helpers for the hand-written f32 kernels (sm_90a).
#pragma once

#include <cuda_runtime.h>

constexpr int kThreads = 256;  // every block of these kernels: 16 x 16 thread groups

// Sum over the 32 lanes of a warp; every lane receives the result.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// The 16 bytes at p (16-byte aligned).
__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 16-byte asynchronous copy from device to shared memory (sm_80+), and its group fences.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// sums[b][c] = sum over blocks of part[b][blk][c], in a fixed order: the second pass of a
// reduction across blocks (each block writes its partial sums; no atomics, so the sums
// are the same from run to run).
static __global__ void sum_partials_kernel(const float* __restrict__ part,
                                           float* __restrict__ sums, int nblk, int C) {
    __shared__ float s[32][33];
    const int c = blockIdx.y * 32 + threadIdx.x, bi = blockIdx.x, ly = threadIdx.y;
    float acc = 0.f;
    if (c < C)
        for (int i = ly; i < nblk; i += 32) acc += part[((size_t)bi * nblk + i) * C + c];
    s[ly][threadIdx.x] = acc;
    __syncthreads();
    if (ly == 0 && c < C) {
        float t = 0.f;
        for (int k = 0; k < 32; ++k) t += s[k][threadIdx.x];
        sums[bi * C + c] = t;
    }
}

static inline cudaError_t sum_partials(const float* part, float* sums, int B, int nblk,
                                       int C, cudaStream_t st) {
    sum_partials_kernel<<<dim3(B, (C + 31) / 32), dim3(32, 32), 0, st>>>(part, sums, nblk, C);
    return cudaGetLastError();
}

// Exact (erf) GELU and the logistic function, as torch computes them in f32.
__device__ __forceinline__ float gelu_erf(float x) {
    return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
}
__device__ __forceinline__ float sigmoid_f32(float x) { return 1.f / (1.f + expf(-x)); }

// Mean and 1/std (biased variance, eps inside the root) of src[0..C), taken by one warp;
// every lane receives both. src may lie in shared or device memory.
__device__ __forceinline__ void warp_ln_stats(const float* src, int C, float eps, float& u,
                                              float& inv) {
    const int lane = threadIdx.x & 31;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += src[c];
    u = warp_sum(s) / C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
        const float d = src[c] - u;
        q = fmaf(d, d, q);
    }
    inv = 1.f / sqrtf(warp_sum(q) / C + eps);
}

// Writes LN(src) * w + b into dst[0..C) using one warp (src == dst is allowed). The warp's
// own earlier writes to src must be ordered before the call (__syncwarp or a barrier).
__device__ __forceinline__ void warp_layernorm(const float* src, float* dst,
                                               const float* __restrict__ w,
                                               const float* __restrict__ b, int C, float eps) {
    const int lane = threadIdx.x & 31;
    float u, inv;
    warp_ln_stats(src, C, eps, u, inv);
    for (int c = lane; c < C; c += 32) dst[c] = (src[c] - u) * inv * w[c] + b[c];
}
