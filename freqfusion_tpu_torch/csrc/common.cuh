// Shared device helpers for the hand-written kernels (sm_90a).
//
// Storage types. Every kernel on the serving path has two instantiations: T = float (the
// f32 path) and T = bf16 (FREQFUSION_DTYPE=bfloat16: activations read and written as bf16).
// Loads convert to f32 where they land (registers, or shared memory, which holds f32 in
// both), arithmetic runs in f32, and stores round to T once. The overloads below take the
// element type from the pointer, so one body serves both instantiations.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kBf16 = std::is_same<T, bf16>::value;

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

// ---- f32 <-> storage type. bf16 rounds to nearest even, once, at the store.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x) {
    if constexpr (kBf16<T>) return __float2bfloat16_rn(x);
    else return x;
}
// x rounded to T and back: where the TPU kernel casts an intermediate to the operand
// dtype (`.astype(dt)`) and the value stays in f32 registers here
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// Four elements at p (4-element aligned) as a float4; two as a float2.
__device__ __forceinline__ float4 ld4(const bf16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float2 ld2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(bf16* p, float4 v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&a);
    u.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void st2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ void st2(bf16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

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
// 4- and 8-byte asynchronous copies (one f32 and two f32), and their bf16 forms: a load and
// a conversion to f32 in place of the copy.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async8(float* smem, const float* gmem) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(float* smem, const bf16* gmem) { *smem = ld1(gmem); }
__device__ __forceinline__ void cp_async8(float* smem, const bf16* gmem) {
    *reinterpret_cast<float2*>(smem) = ld2(gmem);
}
// Four elements of device memory into f32 shared memory: an asynchronous 16-byte copy
// from f32, a load and a conversion from bf16 (visible after the caller's barrier, as the
// copy is after its wait). Staging bf16 in shared memory is later work.
__device__ __forceinline__ void stage4(float* smem, const float* gmem) { cp_async16(smem, gmem); }
__device__ __forceinline__ void stage4(float* smem, const bf16* gmem) {
    *reinterpret_cast<float4*>(smem) = ld4(gmem);
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
template <typename T>
__device__ __forceinline__ void warp_ln_stats(const T* src, int C, float eps, float& u,
                                              float& inv) {
    const int lane = threadIdx.x & 31;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += ld1(src + c);
    u = warp_sum(s) / C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
        const float d = ld1(src + c) - u;
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
