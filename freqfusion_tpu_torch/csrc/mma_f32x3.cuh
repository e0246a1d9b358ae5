// f32-exact products on Hopper's tensor cores: 3xTF32 with mma.sync (sm_80+, built for
// sm_90a), the building block of the implicit-GEMM 3x3 conv (conv_gemm.cuh: B3, B7), the
// HAB attention (hab_attention.cu: B8) and the row products (tile_mma below: B8's tail,
// B9's projection, B10, B14's projections).
//
// Why 3xTF32. A TF32 product keeps 10 mantissa bits of each operand: alone it would change
// the precision class of every result (about 1e-3 relative). Splitting each f32 operand
// into a TF32 high part and a TF32 remainder,
//     hi = rna_tf32(x),  lo = rna_tf32(x - hi),   (split_tf32)
// and accumulating lo*hi + hi*lo + hi*hi in f32 (the two small terms first) drops only the
// lo*lo term, about 2^-22 of each product: f32-level error, far inside the port's 1e-4
// kernel bound (CUTLASS's "fast accurate f32" scheme). The tensor core's own adds round
// toward zero, so the users keep a chain of MMAs into one accumulator short (a chunk of K)
// and add the chunks' sums with f32 adds that round to nearest. Three TF32 products cost
// 3/495 of a second per PFLOP, so the ceiling is about 165 TFLOP/s of f32-exact products
// against the 67 TFLOP/s of f32 FMAs on CUDA cores.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, lane = 4 g + t:
//   A (16 x 8, row-major)  a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)   a3 (g + 8, t + 4)
//   B (8 x 8, k x n)       b0 (t, g)   b1 (t + 4, g)
//   C (16 x 8)             c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// Shared-memory strides that keep a fragment's 32 reads on 32 banks: an operand stored
// [row][k] (A, or B stored [n][k]) wants a row stride of 4 mod 8 floats (g * stride + t
// covers every bank); B stored [k][n] wants 8 or 24 mod 32 (t * stride + g).
//
// mma.sync first; wgmma (TF32 k = 8, 64-row warpgroups, operands by shared-memory
// descriptor) and TMA are the later step.
#pragma once

#include <cstdint>

#include "common.cuh"

// x = hi + lo, both rounded to TF32 to nearest, ties away from zero (cvt.rna's rounding),
// with integer adds and a mask: adding half a TF32 ulp to the bits rounds the magnitude,
// and the MMA ignores an operand's low 13 bits; hi is masked because x - hi must be exact,
// lo need not be. Two cvt.rna.tf32.f32 a value instead made B3's wide case a fifth slower
// on the H100 (PERF.md).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// An operand fragment of n registers, split once where it is loaded.
template <int NR>
struct Frag {
    uint32_t hi[NR], lo[NR];
    __device__ __forceinline__ void set(int i, float x) { split_tf32(x, hi[i], lo[i]); }
};
using FragA = Frag<4>;
using FragB = Frag<2>;

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in f32-exact 3xTF32: the two small terms first.
__device__ __forceinline__ void mma_f32x3(float (&d)[4], const FragA& a, const FragB& b) {
    mma_tf32(d, a.lo, b.hi);
    mma_tf32(d, a.hi, b.lo);
    mma_tf32(d, a.hi, b.hi);
}

// A fragment of rows r0 .. r0+15, k0 .. k0+7 of a [row][k] array at stride ld.
__device__ __forceinline__ void load_a(FragA& a, const float* s, int ld, int r0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = s + (size_t)(r0 + g) * ld + k0 + t;
    a.set(0, p[0]);
    a.set(1, p[8 * ld]);
    a.set(2, p[4]);
    a.set(3, p[8 * ld + 4]);
}

// B fragment of k0 .. k0+7, n0 .. n0+7 of a [k][n] array at stride ld.
__device__ __forceinline__ void load_b_kn(FragB& b, const float* s, int ld, int k0, int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = s + (size_t)(k0 + t) * ld + n0 + g;
    b.set(0, p[0]);
    b.set(1, p[4 * ld]);
}

// B fragment of k0 .. k0+7, n0 .. n0+7 of an [n][k] array at stride ld.
__device__ __forceinline__ void load_b_nk(FragB& b, const float* s, int ld, int k0, int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = s + (size_t)(n0 + g) * ld + k0 + t;
    b.set(0, p[0]);
    b.set(1, p[4]);
}

// Rows of A a tile_mma block owns, the weight-chunk rows it streams and their smem stride.
constexpr int kMmaRows = 128, kMmaKC = 16, kMmaNT = 64, kMmaLdw = kMmaNT + 8;

// Floats of shared memory that tile_mma needs for its weight stages (a ring of three).
__host__ __device__ constexpr int tile_mma_ws() { return 3 * kMmaKC * kMmaLdw; }

// Row-tile product on the tensor cores in f32-exact 3xTF32, for a block of kThreads threads:
//   acc(p, n) = sum_k A[p*lda + k] * W[k*ldw + n]          p < 128, n < N
// and epi(p, n, acc) is called once for every (p, n), by the thread that owns (p, n): the
// same thread for the same (p, n) in every call.
//   A   shared memory, 128 rows of K floats at a stride lda (lda % 8 == 4 keeps the A
//       fragments on 32 banks). The caller may write A right before the call, and again
//       right after it: the call synchronises before it reads A and after its last read.
//   W   device memory, streamed through `ws` (shared, tile_mma_ws() floats) in 16-row
//       chunks of a 64-column pass, a ring of three cp.async stages with one barrier a
//       chunk, so two chunks are in flight while the third is multiplied; stored at a row
//       stride of 72 floats (8 mod 32: the B fragments hit 32 banks).
//   K % 8 == 0 (a last chunk of 8 rows is one k-step), N % 8 == 0 (a last pass of fewer
//   than 64 columns skips its missing n-tiles), ldw % 4 == 0, W 16-byte aligned.
// Warp w owns rows 32 (w % 4) .. +31 (two m-tiles) and columns 32 (w / 4) .. +31 of a pass
// (four n-tiles): per k-step 8 + 8 floats read from shared memory, split, for 24 MMAs; each
// chunk's MMAs go into a fresh tile, added to the running sum in f32.
template <typename Epi>
__device__ __forceinline__ void tile_mma(const float* A, int lda, int K,
                                         const float* __restrict__ W, int ldw, int N, float* ws,
                                         Epi epi) {
    constexpr int STAGE = kMmaKC * kMmaLdw;
    const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
    const int wm = warp & 3, wn = warp >> 2;
    const int nk = (K + kMmaKC - 1) / kMmaKC;
    for (int n0 = 0; n0 < N; n0 += kMmaNT) {
        const int ncols = min(kMmaNT, N - n0);
        auto stage = [&](int c) {  // chunk c into stage c % 3; an empty group past the end
            if (c < nk) {
                const int k0 = c * kMmaKC, rows = min(kMmaKC, K - k0), c4 = ncols / 4;
                float* dst = ws + (c % 3) * STAGE;
                for (int e = tid; e < rows * c4; e += kThreads) {
                    const int kk = e / c4, col = (e % c4) * 4;
                    cp_async16(dst + kk * kMmaLdw + col, W + (size_t)(k0 + kk) * ldw + n0 + col);
                }
            }
            cp_async_commit();
        };
        float acc[2][4][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
        __syncthreads();  // nobody still reads ws (an earlier pass or call); A is written
        stage(0);
        stage(1);
        for (int c = 0; c < nk; ++c) {
            cp_async_wait<1>();  // this thread's copies of chunk c have landed
            // chunk c visible to every thread, and every thread is past chunk c - 1: its
            // stage, (c + 2) % 3, may be refilled
            __syncthreads();
            stage(c + 2);
            const float* wc = ws + (c % 3) * STAGE;
            const int ksteps = min(kMmaKC, K - c * kMmaKC) / 8;
            float part[2][4][4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;
            for (int ks = 0; ks < ksteps; ++ks) {
                FragA a[2];
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    load_a(a[i], A, lda, 32 * wm + 16 * i, c * kMmaKC + 8 * ks);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int nb = 32 * wn + 8 * j;
                    if (nb < ncols) {
                        FragB b;
                        load_b_kn(b, wc, kMmaLdw, 8 * ks, nb);
                        mma_f32x3(part[0][j], a[0], b);
                        mma_f32x3(part[1][j], a[1], b);
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
        }
        cp_async_wait<0>();
        __syncthreads();  // every thread is past its last read of A and of ws
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int nb = 32 * wn + 8 * j;
                if (nb < ncols) {
                    const int p = 32 * wm + 16 * i + g, n = n0 + nb + 2 * t;
                    epi(p, n, acc[i][j][0]);
                    epi(p, n + 1, acc[i][j][1]);
                    epi(p + 8, n, acc[i][j][2]);
                    epi(p + 8, n + 1, acc[i][j][3]);
                }
            }
    }
}
