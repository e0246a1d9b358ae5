// Shared device helpers for the hand-written f32 kernels (sm_90a).
#pragma once

#include <cuda_runtime.h>

constexpr int kThreads = 256;  // every block of these kernels: 16 x 16 thread groups
constexpr int kKC = 16;        // rows of W staged per chunk by tile_matmul_interleaved

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

// Floats of shared memory that tile_matmul_interleaved needs for its weight stage.
__host__ __device__ constexpr int tile_matmul_ws() { return 2 * kKC * 64; }

// Row-tile product on CUDA cores in f32, for a block of kThreads threads (B12's
// products; the others run on the tensor cores, mma_f32x3.cuh):
//   a(p, n) = sum_k A[p*lda + k] * W[k*ldw + n]                 p < 16*TM, n < N
// and epi(p, n, a) is called once for every (p, n), by the thread that owns (p, n): the
// same thread for the same (TM, p, n) in every call.
//   A   shared memory, rows of K floats at a stride lda (lda % 4 == 0; lda % 32 == 4
//       keeps the two rows a warp reads on different banks). The caller may write A
//       right before the call: the call synchronises before it reads A.
//   W   device memory, streamed through `ws` (shared, tile_matmul_ws() floats) in kKC-row
//       chunks of a 64-column pass, double-buffered with cp.async so that the copy of chunk
//       c+1 overlaps the FMAs on chunk c; each weight is read from L2 once per block.
//   K % kKC == 0, N % 64 == 0, W 16-byte aligned.
// Thread t owns rows t/16, t/16 + 16, .. and columns 4*(t%16) .. +3 of each pass: per four k
// it reads TM + 4 float4s from shared memory for 16*TM FMAs. The two half-warps read
// neighbouring rows, lda floats apart, which at TM = 8 keeps their broadcasts on different
// banks where 8 * lda floats apart would not (lda % 32 == 4).
template <int TM, typename Epi>
__device__ __forceinline__ void tile_matmul_interleaved(const float* A, int lda, int K,
                                                        const float* __restrict__ W, int ldw,
                                                        int N, float* ws, Epi epi) {
    constexpr int KC = kKC, NT = 64, STAGE = KC * NT;
    const int tid = threadIdx.x, cg = tid & 15;
    auto row = [&](int i) { return (tid >> 4) + 16 * i; };
    const int nk = K / KC;
    auto stage = [&](int buf, int n0, int k0) {
        for (int e = tid; e < KC * NT / 4; e += kThreads) {
            const int kk = e / (NT / 4), col = (e % (NT / 4)) * 4;
            cp_async16(ws + buf * STAGE + kk * NT + col, W + (size_t)(k0 + kk) * ldw + n0 + col);
        }
        cp_async_commit();
    };
    for (int n0 = 0; n0 < N; n0 += NT) {
        float a[TM][4];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
        __syncthreads();  // nobody still reads ws (an earlier pass or call)
        stage(0, n0, 0);
        for (int c = 0; c < nk; ++c) {
            if (c + 1 < nk) {
                stage((c + 1) & 1, n0, (c + 1) * KC);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();  // chunk c (and the caller's A) visible to every thread
            const float* wc = ws + (c & 1) * STAGE;
            const float* ac = A + c * KC;
#pragma unroll 2
            for (int k = 0; k < KC; k += 4) {
                float4 av[TM];
#pragma unroll
                for (int i = 0; i < TM; ++i)
                    av[i] = *reinterpret_cast<const float4*>(ac + row(i) * lda + k);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    const float4 w = *reinterpret_cast<const float4*>(wc + (k + kk) * NT + cg * 4);
#pragma unroll
                    for (int i = 0; i < TM; ++i) {
                        const float s = lane4(av[i], kk);
                        a[i][0] = fmaf(s, w.x, a[i][0]);
                        a[i][1] = fmaf(s, w.y, a[i][1]);
                        a[i][2] = fmaf(s, w.z, a[i][2]);
                        a[i][3] = fmaf(s, w.w, a[i][3]);
                    }
                }
            }
            __syncthreads();  // the next chunk's copy refills buffer c & 1
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) epi(row(i), n0 + cg * 4 + j, a[i][j]);
    }
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
