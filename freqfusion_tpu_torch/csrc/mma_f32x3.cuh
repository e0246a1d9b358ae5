// f32-exact products on Hopper's tensor cores: 3xTF32 with mma.sync (sm_80+, built for
// sm_90a), the building block of the implicit-GEMM 3x3 conv (conv_gemm.cuh: B3, B7), the
// HAB and overlapping attentions (hab_attention.cu: B8; oca.cu: B9), the band attention's
// projections (bandmha.cu: B11) and the row products (tile_mma below: B6's two products,
// B8's tail, B9's projection, B10, B14's projections).
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
//
// bf16 (the kernels' bf16 instantiations, P = 1 below): operands rounded to bf16 where their
// fragments are set, one TF32 pass (exact for bf16 operands), f32 accumulation; the TF32
// fragments and layouts serve both, so no product loop is written twice. bf16 fragments
// (m16n8k16) and wgmma, at twice the TF32 rate, are later work (ROADMAP B-ii).
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

// The bf16 instantiations (T = bf16, csrc/common.cuh) take bf16 operands: x rounded to bf16
// (to nearest even), which a TF32 operand holds exactly (the same exponent, 7 of its 10
// mantissa bits), so ONE TF32 pass gives the exact bf16-operand product, accumulated in
// f32. The rounding happens where a fragment is set, which is where the TPU kernel casts
// each matmul operand to its bf16 operand dtype (`.astype(dt)`, wattn._mxu_dtype).
__device__ __forceinline__ uint32_t bf16_tf32(float x) {
    return __float_as_uint(__bfloat162float(__float2bfloat16_rn(x)));
}

// TF32 passes of a product: 3 (f32-exact, 3xTF32) for f32 storage, 1 for bf16.
template <typename T>
constexpr int kPasses = kBf16<T> ? 1 : 3;

// An operand fragment of n registers, split (P = 3) or rounded to bf16 (P = 1) once where
// it is loaded; lo is unused at P = 1.
template <int NR, int P = 3>
struct Frag {
    uint32_t hi[NR], lo[NR];
    __device__ __forceinline__ void set(int i, float x) {
        if constexpr (P == 3) split_tf32(x, hi[i], lo[i]);
        else hi[i] = bf16_tf32(x);
    }
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

// d += a * b in f32-exact 3xTF32 (the two small terms first), or in one pass of bf16
// operands.
template <int P>
__device__ __forceinline__ void mma_f32x3(float (&d)[4], const Frag<4, P>& a,
                                          const Frag<2, P>& b) {
    if constexpr (P == 3) {
        mma_tf32(d, a.lo, b.hi);
        mma_tf32(d, a.hi, b.lo);
    }
    mma_tf32(d, a.hi, b.hi);
}

// d += a * (bh + bl) for a B fragment that comes split from the host (_mma.mma_planes: hi
// and lo planes); a bf16 weight's lo plane is zero and is not read (P = 1).
template <int P>
__device__ __forceinline__ void mma_planes_step(float (&d)[4], const Frag<4, P>& a,
                                                const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
    if constexpr (P == 3) {
        mma_tf32(d, a.lo, bh);
        mma_tf32(d, a.hi, bl);
    }
    mma_tf32(d, a.hi, bh);
}

// A fragment of rows r0 .. r0+15, k0 .. k0+7 of a [row][k] array at stride ld.
template <int P>
__device__ __forceinline__ void load_a(Frag<4, P>& a, const float* s, int ld, int r0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = s + (size_t)(r0 + g) * ld + k0 + t;
    a.set(0, p[0]);
    a.set(1, p[8 * ld]);
    a.set(2, p[4]);
    a.set(3, p[8 * ld + 4]);
}

// B fragment of k0 .. k0+7, n0 .. n0+7 of a [k][n] array at stride ld.
template <int P>
__device__ __forceinline__ void load_b_kn(Frag<2, P>& b, const float* s, int ld, int k0, int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = s + (size_t)(k0 + t) * ld + n0 + g;
    b.set(0, p[0]);
    b.set(1, p[4 * ld]);
}

// B fragment of k0 .. k0+7, n0 .. n0+7 of an [n][k] array at stride ld.
template <int P>
__device__ __forceinline__ void load_b_nk(Frag<2, P>& b, const float* s, int ld, int k0, int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = s + (size_t)(n0 + g) * ld + k0 + t;
    b.set(0, p[0]);
    b.set(1, p[4]);
}


// ---- tile_mma: the row product of csrc/hat_rows.cu (B6's fc1, B8's tail, B9's projection,
// B10, B14's projections) and csrc/sgfn.cu (B6's gate + fc2).
//
// What bounds it: per block 128 rows x K x N of f32-exact products (3 TF32 MMAs a product)
// against the weights' 8 bytes an element (hi and lo) read from L2 once a block, so the
// products, at the tensor cores' 165 TFLOP/s (107 measured for mma.sync, tools/mma_peak.py).
// Design, and what timing variants of it on the H100 showed (PERF.md):
//   * the weights come split on the host (ops/kernels/_mma.py) in B-fragment order, hi and
//     lo of a lane's fragment in one 16-byte load: nothing of B is split here;
//   * a warp owns 1 m-tile x 8 n-tiles of a 128-column pass and splits its A fragment once
//     a k-step for all of them; A sits in fragment order (one 16-byte load a fragment, no
//     padded stride). Neither lever moved the product alone: the inner loop ran as fast as
//     a version that loaded and split every operand in every warp, and 2 m-tiles x 4
//     n-tiles a warp was no faster;
//   * what did: one barrier every kMmaKC = 64 weight rows (8 k-steps) instead of every 16,
//     and the passes following one another in one ring, so that it never drains between
//     them, and A's staging running while the first weight chunks are in flight. With one
//     block of 16 warps an SM (94 KB of A, 128 KB of ring), A's staging, each pass's
//     epilogue and each chunk's barrier still stop every MMA of the SM: that, not the
//     operand split, is what holds the product at a third of the mma.sync ceiling.
// The tensor core's adds round toward zero, so each chunk of kMmaKC rows goes into a fresh
// register tile that is added to the running sum in f32: a chain of 3 kMmaKC / 8 MMAs
// (24), short enough for the f32-exactness tests of B6, B8 and B10.

// Rows of A a block owns, its threads (16 warps), the weight rows of a ring stage (a chunk:
// 8 k-steps), the ring's two stages, and the n-tiles of a pass (128 columns).
constexpr int kMmaRows = 128, kMmaThreads = 512;
constexpr int kMmaKC = 64, kMmaStages = 2, kMmaKS = kMmaKC / 8, kMmaNT = 16;
constexpr int kMmaStage4 = kMmaKS * kMmaNT * 32;   // float4s of a stage

// Floats of shared memory that tile_mma needs for its weight ring.
__host__ __device__ constexpr int tile_mma_ws() { return kMmaStages * kMmaStage4 * 4; }

// Rows of K a block stages at a time when its product takes K in pieces: the fewest pieces
// of at most kMmaMaxK rows, as even as multiples of 8 fall (184 + 176 at 360, 4 x 184 at
// 720): kMmaMaxK is what 128 rows of A beside the ring and 2 KB of the caller's leave of a
// block's 227 KB of shared memory (192).
constexpr int kMmaMaxK = (232448 - 4 * tile_mma_ws() - 2048) / (4 * kMmaRows) / 8 * 8;
static_assert(kMmaMaxK >= 184, "a row of HAT's and DAT's 180 channels in one piece");
__host__ __device__ constexpr int tile_mma_piece(int K) {
    return ((K + (K + kMmaMaxK - 1) / kMmaMaxK - 1) / ((K + kMmaMaxK - 1) / kMmaMaxK) + 7) / 8 * 8;
}

// Where element (p, k) of A sits in the fragment-major layout that tile_mma reads, for A
// of `ksteps` k-steps: [m-tile][k-step][lane][4], the 4 being a0..a3 of the lane's A
// fragment (lane 4 g + t: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)).
__device__ __forceinline__ int a_frag_index(int p, int k, int ksteps) {
    const int r = p & 15, kk = k & 7;
    const int lane = 4 * (r & 7) + (kk & 3), slot = (r >> 3) + 2 * (kk >> 2);
    return ((((p >> 4) * ksteps + (k >> 3)) * 32 + lane) << 2) + slot;
}

// v into A at row p, columns c .. c + 3 (c % 4 == 0), A of `ksteps` k-steps in the layout of
// a_frag_index
__device__ __forceinline__ void put4(float* A, int p, int c, int ksteps, float4 v) {
    const int i = a_frag_index(p, c, ksteps);   // c + 1 .. c + 3 sit 4 floats apart
    A[i] = v.x;
    A[i + 4] = v.y;
    A[i + 8] = v.z;
    A[i + 12] = v.w;
}

// Row-tile product on the tensor cores in f32-exact 3xTF32, for a block of kMmaThreads:
//   acc(p, n) = sum_{k < K} A(p, k) * W(k, n)          p < 128, n < N
// and epi(p, n, acc(p, n), acc(p, n + 1)) is called once for every p and even n, by the
// thread that owns (p, n) and (p, n + 1): the same thread for the same (p, n) in every call.
//   A   shared memory, 128 rows x K in the fragment-major layout of a_frag_index (K / 8
//       k-steps), written by stage_a(), which the call runs once every thread is past the
//       previous call's reads of A and while the first weight chunks are in flight. The
//       caller may write A again right after the call: it synchronises after its last read.
//   W   device memory, ops/kernels/_mma.py's mma_planes: [kp/8][ntw][32][4] float4s with
//       hi and lo of each B fragment, where ntw = npad / 8 n-tiles a k-step; W points at
//       the first k-step of this product. It is streamed through `ws` (shared,
//       tile_mma_ws() floats) in chunks of kMmaKC rows of a 128-column pass, a ring of
//       kMmaStages cp.async stages with one barrier a chunk; the passes follow one another
//       in the same ring, so it does not drain between them and a pass's epilogue overlaps
//       the next pass's copies.
//   K % 8 == 0, N % 8 == 0, N <= 8 ntw.
// Warp w owns m-tile w % 8 (rows 16 (w % 8) ..) and up to 8 n-tiles of a pass: 8 register
// tiles, 24 MMAs a k-step. The n-tiles of a pass are shared between the two column groups
// of warps (w / 8) as evenly as they fall, so a ragged N costs little.
// P: the TF32 passes (kPasses of the caller's storage type): 3, or 1 for bf16 operands (A
// rounded to bf16 where its fragment is set; W's hi plane only).
template <int P = 3, typename StageA, typename Epi>
__device__ __forceinline__ void tile_mma(const float* A, int K, const float4* __restrict__ W,
                                         int ntw, int N, float* ws, StageA stage_a, Epi epi) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int mg = warp & 7, ng = warp >> 3;
    const int ksteps = K >> 3, nchunks = (ksteps + kMmaKS - 1) / kMmaKS, ntiles = N >> 3;
    const int total = (ntiles + kMmaNT - 1) / kMmaNT * nchunks;   // (pass, chunk) steps
    const float4* a4 = reinterpret_cast<const float4*>(A) + mg * ksteps * 32 + lane;
    float4* ring = reinterpret_cast<float4*>(ws);
    auto stage = [&](int i) {  // step i's chunk into stage i % kMmaStages; empty past the end
        if (i < total) {
            const int nt0 = i / nchunks * kMmaNT, ks0 = i % nchunks * kMmaKS;
            const int nks = min(kMmaKS, ksteps - ks0), per = min(kMmaNT, ntiles - nt0) * 32;
            float4* dst = ring + (i % kMmaStages) * kMmaStage4;
            for (int e = tid; e < nks * per; e += kMmaThreads) {
                const int s = e / per, r = e - s * per;
                cp_async16(reinterpret_cast<float*>(dst + s * kMmaNT * 32 + r),
                           reinterpret_cast<const float*>(
                               W + ((size_t)(ks0 + s) * ntw + nt0) * 32 + r));
            }
        }
        cp_async_commit();
    };
    __syncthreads();  // nobody still reads ws or A (an earlier call)
#pragma unroll
    for (int i = 0; i < kMmaStages - 1; ++i) stage(i);
    stage_a();
    float acc[8][4];
    for (int i = 0; i < total; ++i) {
        const int c = i % nchunks, nt0 = i / nchunks * kMmaNT;
        // the pass's n-tiles over the two column groups, as evenly as they fall
        const int nnt = min(kMmaNT, ntiles - nt0), base = nnt / 2, rem = nnt % 2;
        const int my0 = ng * base + min(ng, rem), mine = base + (ng < rem ? 1 : 0);
        cp_async_wait<kMmaStages - 2>();  // this thread's copies of step i have landed
        // step i's chunk (and A) visible to every thread, and every thread is past step
        // i - 1: its stage may be refilled
        __syncthreads();
        stage(i + kMmaStages - 1);
        const float4* wc = ring + (i % kMmaStages) * kMmaStage4 + my0 * 32 + lane;
        const int nks = min(kMmaKS, ksteps - c * kMmaKS);
        if (c == 0) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
        }
        float part[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) part[j][r] = 0.f;
#pragma unroll
        for (int s = 0; s < kMmaKS; ++s) {
            if (s >= nks) break;
            Frag<4, P> a;
            const float4 v = a4[(c * kMmaKS + s) * 32];
            a.set(0, v.x);
            a.set(1, v.y);
            a.set(2, v.z);
            a.set(3, v.w);
            // four n-tiles at a time: the three terms of every tile interleaved, the small
            // ones first
#pragma unroll
            for (int j0 = 0; j0 < 8; j0 += 4) {
                uint32_t bh[4][2], bl[4][2];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float4 b = j0 + j < mine ? wc[(s * kMmaNT + j0 + j) * 32]
                                                   : make_float4(0.f, 0.f, 0.f, 0.f);
                    bh[j][0] = __float_as_uint(b.x);
                    bh[j][1] = __float_as_uint(b.y);
                    bl[j][0] = __float_as_uint(b.z);
                    bl[j][1] = __float_as_uint(b.w);
                }
                if constexpr (P == 3) {
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if (j0 + j < mine) mma_tf32(part[j0 + j], a.lo, bh[j]);
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if (j0 + j < mine) mma_tf32(part[j0 + j], a.hi, bl[j]);
                }
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (j0 + j < mine) mma_tf32(part[j0 + j], a.hi, bh[j]);
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[j][r] += part[j][r];
        if (c + 1 < nchunks) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (j < mine) {
                const int p = 16 * mg + g, n = 8 * (nt0 + my0 + j) + 2 * t;
                epi(p, n, acc[j][0], acc[j][1]);
                epi(p + 8, n, acc[j][2], acc[j][3]);
            }
    }
    cp_async_wait<0>();
    __syncthreads();  // every thread is past its last read of A and of ws
}
