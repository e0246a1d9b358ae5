// Per-pixel row work, projection + residuals + LayerNorm + MLP, as one hand-written f32-exact
// product kernel for Hopper (sm_90a) in four modes, launched in sequence:
//   * hab_tail, the second half of the fused HAB block (B8), after csrc/hab_attention.cu's
//     attention:  y = x + att @ wproj + bproj + conv_scale * cab_scale * conv_x   (proj)
//                 hidden = GELU(LN2(y) @ w1 + b1)                                  (fc1)
//                 out = y + hidden @ w2 + b2                                       (fc2)
//   * residual_ln_mlp (B10):  y = a + shortcut, then fc1 and fc2 as above;
//   * rows_ln_fc1, fc1 alone with y = a + shortcut parked in out, and optionally LN_sg over
//     the second half of each hidden row: the first launch of the SGFN tail (B6; its second,
//     the gate and fc2, is csrc/sgfn.cu);
//   * rows_linear: out = a @ w + b on rows of any output width: the output projection of
//     the overlapping cross-attention (B9), after csrc/oca.cu's attention, the qkv and
//     output projections of the standalone window attention (B14) around csrc/wattn.cu's,
//     and the band attention's wide route (csrc/bandmha.cu).
//
// Replaces the TPU kernels freqfusion_tpu/ops/pallas/wattn.py:fused_hab_block (with
// hab_attention.cu), :fused_residual_ln_mlp, the projection inside
// :fused_overlap_attention and the fc1 half of freqfusion_tpu/ops/pallas/sgfn.py:
// fused_sgfn_tail. The plain PyTorch versions sit beside the wrappers in
// freqfusion_tpu_torch/ops/kernels/wattn.py and sgfn.py.
//
// What bounds it on the H100. B10: per pixel 4*C*hid FLOPs of products (259 k at C = 180,
// hid = 360) for 12*C bytes of a, shortcut and out plus the hidden's round trip (2.9 KB):
// about 90 FLOP per byte, above the 3xTF32 tensor-core ridge (49): the products bound it at
// 0.28 ms at [1,352,512,180] on the tensor cores' 165 TFLOP/s of f32-exact products (0.70
// ms on the CUDA cores' 67), the bytes at 0.16 ms. B6's fc1 (C -> 720) alone is 47 GFLOP
// at the same shape: 0.28 ms. mma.sync reaches 107 TFLOP/s of 3xTF32 on the card
// (tools/mma_peak.py): 0.44 ms for B10's products.
//
// Design. The TPU kernel keeps a window's rows, y and the hidden in VMEM through all three
// products. Here each product has its own launch of rows_pipelined_kernel, and what the TPU
// kernel keeps in VMEM between them goes through device memory: y is parked in the output
// buffer (written by proj or by fc1's LayerNorm, read and overwritten by fc2's epilogue), the
// hidden in a scratch buffer [pixels][K2p]. A launch is persistent: one block an SM (the grid
// comes from the wrapper, ops/kernels/_mma.py: row_grid), each walking the row tiles of 128
// pixels blockIdx.x, blockIdx.x + gridDim.x, ..., so that nothing drains between tiles and no
// last wave runs ragged. Its 16 warps are specialised (setmaxnreg gives the consumers 168
// registers a thread and the producers 88, which every instantiation fits without a spill):
//   * eight consumer warps (2 row groups x 4 column groups) run the products and nothing
//     else: a warp owns 64 rows x up to 3 n-tiles of a 96-column pass, 4 x 3 register
//     tiles, 36 MMAs a k-step; the warp's n-tile count is a template argument of the stage
//     body (chunk_mma), so that no branch sits among the MMAs (a branch around each
//     mma.sync made the compiler fence every one of them: BSSY, WARPSYNC, BSYNC). At the
//     end of a pass a warp leaves its sums in shared memory (S, [128][104] f32) and goes on
//     with the next pass. A pass of 128 columns (4 x 4 tiles) needed about 200 registers
//     here and left the helpers too few: every fc1 and proj instantiation spilled;
//   * one producer warp streams the weights, split into TF32 hi and lo on the host
//     (ops/kernels/_mma.py: mma_planes), in stages of 16 k-rows x a 96-column pass (12 KB)
//     by bulk copies (cp.async.bulk, the TMA's unit) into a ring of 4 stages;
//   * seven helper warps do the rest: they load each tile's rows of A, 32 columns at a time,
//     by cp.async into 6 slots (18 KB each: up to 192 columns, zero-filled past the row's
//     end and the last pixel), the next tile's during this one's last pass, as the slots
//     free; they prefetch fc1's shortcut rows into L2; they run every epilogue from
//     S (bias, residuals with proj's `shift` gather, GELU, the pieces' sums), in whole rows
//     of device memory, while the consumers multiply the next pass; and LN_sg.
// Each stage, slot and S has a pair of mbarriers, full and empty: a producer waits for
// empty, the loads (or the sums) complete full, and the consumers wait for full and arrive on
// empty; no block-wide barrier is left in the product loop. fc1's LayerNorm of a landed tile
// (a warp a row, in place in the slots) runs on the consumers, which would wait for it
// anyway, beside the helpers' last epilogue.
// Every product takes K in pieces of at most kMmaMaxK = 192 rows (tile_mma_piece: 184 + 176
// at 360), each piece's epilogue adding to the last's; at C <= 192, proj and fc1 are one
// piece. fc1 in pieces (C > 192, SPLIT) takes each row's mean and 1/std in a first pass over
// device memory (y = a + shortcut parked in out on the way), and its consumers stage and
// normalise each piece themselves; the hidden's partial sums over the pieces are added in
// f32 before bias and GELU. The projection at C > 192 is the linear mode, whose pieces sum in
// out, and residual_kernel adds the residuals after it. With in_shift the shortcut x is read
// at (y + s, x + s), wrapping, like the attention read it; conv_x and out are in rolled
// coordinates. Widths are padded to multiples of 8, the MMA's k and n (180 -> 184; 360 and
// 720 stay): the wrapper zero-pads the weights, the copies zero-fill A's padding.
// Numerics are tile_mma's (mma_f32x3.cuh): 3xTF32, the small terms first, each 64 k-rows
// summed in a fresh register tile that is added to the running sum in f32, the same MMAs in
// the same order for every output; a stage's k-steps past its piece multiply zeros. A launch
// gives what tile_mma gave, bit for bit, and repeats itself bit for bit (no atomics).
// What it measured (H100 80GB HBM3 at 700 W, [1,352,512,180] f32, against the block-per-tile
// kernel it replaced, PERF.md): B8's tail 1.67-1.68 ms (2.59-2.62), B6's fc1 1.62-1.63
// (1.73-1.74), B10 1.44-1.47 (1.92-1.93), B9's projection 0.27 (0.46); at bf16 1.52-1.53,
// 1.31 and 1.19-1.21 (2.19, 1.48, 1.63). The products still run at about a third of
// mma.sync's 3xTF32 rate; in a variant with timer stamps the consumers waited on the helpers'
// epilogues and on fc1's LayerNorm.
//
// Layout: NHWC, contiguous; C % 4 == 0. cab_scale [B][C] or null. Storage: a, x, conv_x and
// out are f32, or bf16 (T). P = 1 (bf16, and precision "default" on f32 storage): bf16
// products, every A operand rounded to bf16 where its fragment is set (a bf16 slot holds
// it rounded already). y, which the TPU kernel keeps in f32, is parked in f32 (out itself
// for f32 storage, an f32 scratch for bf16), and the hidden is f32 (its only reader is the
// next product, which rounds it to bf16 at P = 1 as the TPU kernel's cast does). hab_tail
// at C > 192 at bf16 sums the projection's K pieces in that f32 scratch and adds the
// residuals there: y is rounded nowhere before fc2's store.

#include <cstdint>

#include "mma_f32x3.cuh"

namespace {

constexpr float kEps = 1e-5f;
enum Mode { kLinear = 0, kProj = 1, kFc1 = 2, kFc2 = 3 };
__host__ __device__ constexpr bool pieces(int mode) { return mode == kFc2 || mode == kLinear; }

// The pipelined row product: rows of a tile, consumer warps (2 row groups x 4 column groups),
// helper warps (A's rows, epilogues, LN_sg), the block's threads (with one weight
// producer), the k-rows of a weight stage and the columns of an A slot, the n-tiles of a pass
// (96 columns), the weight ring's stages and the A slots (one piece of up to kMmaMaxK
// columns).
constexpr int kRowM = kMmaRows;
constexpr int kCWarps = 8, kCThreads = 32 * kCWarps;
constexpr int kHelpers = 7, kHThreads = 32 * kHelpers;
constexpr int kRowThreads = kCThreads + 32 + kHThreads;
static_assert(kRowThreads == 512, "two consumer and two producer warpgroups");
// registers a thread after setmaxnreg: the producers' warpgroups give what the consumers take
// (launched at 65536 / 512 = 128 a thread); ptxas fits every instantiation in these without
// a spill (chip_smoke.py checks it)
constexpr int kProducerRegs = 88, kConsumerRegs = 168;
static_assert(256 * kProducerRegs + kCThreads * kConsumerRegs <= 65536, "the SM's registers");
constexpr int kKC = 32, kSKS = 2, kPassNT = 12, kStages = 4;
constexpr int kWarpNT = kPassNT / 4;   // a consumer warp's n-tiles of a pass, at most
static_assert(kWarpNT * 4 == kPassNT, "a pass splits over four column groups");
// the rows a helper's epilogue, and its LN_sg, hold at once
constexpr int kEpiRows = 2, kSgRows = 2;
constexpr int kStage4 = kSKS * kPassNT * 32;   // float4s of a stage (12 KB: 16 k-rows)
constexpr int kSlotStages = kKC / (8 * kSKS);  // stages of an A slot's columns
constexpr int kSlots = kMmaMaxK / kKC;
static_assert(kSlots * kKC == kMmaMaxK, "a piece fills whole slots");
// A slot's row stride in elements: 4 mod 8 words (conflict-free A fragments), 16-byte rows
template <typename TA>
constexpr int kLd = kBf16<TA> ? 40 : 36;
// A pass's sums, [128][kSLd] f32, from the consumers to the helpers: a row stride of 8 mod 32
// words keeps each consumer's float2 stores conflict-free.
constexpr int kSLd = kPassNT * 8 + 8;
// The barriers: the ring's full and empty, the slots' full and empty, the sums' full and
// free.
constexpr int kBarriers = 2 * kStages + 2 * kSlots + 2;

// Bytes of shared memory: the ring, the slots, a pass's sums, [128][2] LN statistics (fc1 in
// pieces) and the barriers.
template <typename TA>
constexpr size_t rows_smem() {
    return (size_t)kStages * kStage4 * 16 + (size_t)kSlots * kRowM * kLd<TA> * sizeof(TA) +
           (size_t)(kRowM * kSLd + 2 * kRowM) * sizeof(float) + kBarriers * sizeof(uint64_t);
}
static_assert(rows_smem<float>() <= 232448, "one block an SM");

// T: the storage type of x, conv_x and out; TA: that of `a` (T, or f32 where `a` is y or the
// hidden).
template <typename T, typename TA>
struct RowArgs {
    const TA* a;         // att (kLinear, kProj), a or y (kFc1), the hidden (kFc2)
    const T* x;          // the block's input x (kProj); shortcut or null (kFc1)
    const T* cx;         // conv_x (kProj)
    const float* cabs;   // cab_scale [B][C] or null (kProj)
    const float4* w;     // the product's weights, mma_planes of [Kp][Np]
    const float* bias;   // its bias
    const float *lnw, *lnb;   // LayerNorm affine (kFc1)
    const float *sgw, *sgb;   // LN_sg affine over the hidden's second half, or null (kFc1)
    T* out;              // out
    float* y;            // y after kProj, or after kFc1 with a shortcut; the pieces' sums
                         // of kLinear and kFc2 (out itself for f32)
    float* hid;          // the hidden [pixels][Np] (kFc1)
    long long npix;      // B * H * W
    int H, W, C, Kp, Np, nreal, shift;   // nreal: real columns of the product
    float conv_scale;
    int Kt, ntiles;      // the K rows of a piece, the row tiles (set by launch_split)
};

// ---- mbarriers, bulk and asynchronous copies, prefetches, the consumers' named barrier (sm_90)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
                 : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
    asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}\n"
                 ::"r"(smem_u32(b)) : "memory");
}
// the producer's arrival, and the bytes the stage's bulk copies will complete
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
    asm volatile(
        "{\n\t.reg .b64 st;\n\tmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}\n"
        ::"r"(smem_u32(b)), "r"(bytes) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
    const uint32_t addr = smem_u32(b);
    uint32_t done;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    } while (!done);
}
// `bytes` at src into L2 (a bulk prefetch), ahead of the loads that will read them
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes)
                 : "memory");
}
// one arrival on b once every earlier cp.async of this thread has landed
__device__ __forceinline__ void mbar_cp_async_arrive(uint64_t* b) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(b))
                 : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* b) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(b)) : "memory");
}
// four elements of a row into an A slot, or four zeros where !ok
__device__ __forceinline__ void cp_async_quad(float* dst, const float* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_quad(bf16* dst, const bf16* src, bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(ok ? 8 : 0) : "memory");
}
__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kCThreads) : "memory");
}
// LayerNorm (eps 1e-5) of rows of n <= 384 floats in device memory, in place, by one warp:
// the `rows` (<= R) rows row, row + stride, ..., each held in registers, all loaded before
// any is stored.
template <int R>
__device__ __forceinline__ void ln_rows_inplace(float* row, size_t stride, int rows,
                                                const float* __restrict__ w,
                                                const float* __restrict__ b, int n) {
    const int lane = threadIdx.x & 31;
    float4 v[R][3];
#pragma unroll
    for (int k = 0; k < R; ++k) {
        const float* r = row + k * stride;
#pragma unroll
        for (int h = 0; h < 3; ++h) {
            const int c = 4 * lane + 128 * h;
            v[k][h] = k < rows && c < n ? *reinterpret_cast<const float4*>(r + c)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
        float* r = row + k * stride;
        if (k >= rows) continue;
        float sum = 0.f;
#pragma unroll
        for (int h = 0; h < 3; ++h) sum += (v[k][h].x + v[k][h].y) + (v[k][h].z + v[k][h].w);
        const float u = warp_sum(sum) / n;
        float q = 0.f;
#pragma unroll
        for (int h = 0; h < 3; ++h)
            if (4 * lane + 128 * h < n) {
                const float4 d = make_float4(v[k][h].x - u, v[k][h].y - u, v[k][h].z - u,
                                             v[k][h].w - u);
                q = fmaf(d.x, d.x, fmaf(d.y, d.y, fmaf(d.z, d.z, fmaf(d.w, d.w, q))));
            }
        const float inv = 1.f / sqrtf(warp_sum(q) / n + kEps);
#pragma unroll
        for (int h = 0; h < 3; ++h) {
            const int c = 4 * lane + 128 * h;
            if (c < n) {
                const float4 ww = *reinterpret_cast<const float4*>(w + c);
                const float4 bb = *reinterpret_cast<const float4*>(b + c);
                *reinterpret_cast<float4*>(r + c) = make_float4(
                    (v[k][h].x - u) * inv * ww.x + bb.x, (v[k][h].y - u) * inv * ww.y + bb.y,
                    (v[k][h].z - u) * inv * ww.z + bb.z, (v[k][h].w - u) * inv * ww.w + bb.w);
            }
        }
    }
}

// The weight producer (a warp): for every (tile, piece, pass, 16-row stage) of the block's
// walk, in the consumers' order, the stage's weights into the ring, by bulk copies.
template <int MODE, bool SPLIT, typename T, typename TA>
__device__ __forceinline__ void produce_weights(const RowArgs<T, TA>& g, float4* ring,
                                                uint64_t* wfull, uint64_t* wempty) {
    const int lane = threadIdx.x & 31, ntn = g.Np / 8;
    int stage = 0;
    uint32_t wph = 0;   // the ring's round parity
    for (int tile = blockIdx.x; tile < g.ntiles; tile += gridDim.x)
        for (int k0 = 0; k0 < g.Kp; k0 += g.Kt) {
            const int kh = min(g.Kt, g.Kp - k0), ks = kh / 8, nst = (ks + kSKS - 1) / kSKS;
            for (int nt0 = 0; nt0 < ntn; nt0 += kPassNT) {
                const int nnt = min(kPassNT, ntn - nt0);
                for (int c = 0; c < nst; ++c) {
                    mbar_wait(wempty + stage, wph ^ 1);
                    if (lane == 0) {
                        const int ks0 = k0 / 8 + c * kSKS, nks = min(kSKS, ks - c * kSKS);
                        mbar_expect_tx(wfull + stage, (uint32_t)(nks * nnt * 512));
                        for (int s = 0; s < nks; ++s)
                            bulk_copy(ring + stage * kStage4 + s * kPassNT * 32,
                                      g.w + ((size_t)(ks0 + s) * ntn + nt0) * 32,
                                      (uint32_t)(nnt * 512), wfull + stage);
                    }
                    if (++stage == kStages) {
                        stage = 0;
                        wph ^= 1;
                    }
                }
            }
        }
}

// `rows` rows of `width` elements from row p0 of t into L2, in whole 16-byte units
template <typename E>
__device__ __forceinline__ void prefetch_rows(const E* t, long long p0, long long rows,
                                              int width) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(t + p0 * width);
    const uintptr_t b = reinterpret_cast<uintptr_t>(t + (p0 + rows) * width);
    const uintptr_t a16 = a & ~(uintptr_t)15, b16 = b & ~(uintptr_t)15;
    if (b16 > a16) prefetch_l2(reinterpret_cast<const void*>(a16), (uint32_t)(b16 - a16));
}

// fc1's LayerNorm of a landed tile (C <= 192) in place in the slots, by the consumer warps, a
// warp a row, the row in registers (two float4 a lane), two rows at a time, both rows' loads
// before either's stores; y = a + shortcut is parked in out.
template <typename T, typename TA>
__device__ __forceinline__ void layernorm_rows(const RowArgs<T, TA>& g, TA* slots, long long p0) {
    constexpr int LD = kLd<TA>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, C = g.C;
    auto at = [&](int p, int c) { return slots + (c >> 5) * kRowM * LD + p * LD + (c & 31); };
    float4 lw[2], lb[2];   // the affine of this lane's columns, the same in every row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int c = 4 * lane + 128 * h;
        lw[h] = c < C ? *reinterpret_cast<const float4*>(g.lnw + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        lb[h] = c < C ? *reinterpret_cast<const float4*>(g.lnb + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int pp = warp; pp < kRowM; pp += 2 * kCWarps) {
        float4 v[2][2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int p = pp + k * kCWarps;
            const long long gp = p0 + p;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int c = 4 * lane + 128 * h;
                v[k][h] = make_float4(0.f, 0.f, 0.f, 0.f);
                if (c < C) {
                    v[k][h] = ld4(at(p, c));
                    if (g.x && gp < g.npix) {
                        const float4 u = ld4(g.x + gp * C + c);
                        v[k][h] = make_float4(v[k][h].x + u.x, v[k][h].y + u.y, v[k][h].z + u.z,
                                              v[k][h].w + u.w);
                    }
                }
            }
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int p = pp + k * kCWarps;
            const long long gp = p0 + p;
            float sum = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int c = 4 * lane + 128 * h;
                if (g.x && gp < g.npix && c < C)
                    *reinterpret_cast<float4*>(g.y + gp * C + c) = v[k][h];
                sum += (v[k][h].x + v[k][h].y) + (v[k][h].z + v[k][h].w);
            }
            const float u = warp_sum(sum) / C;
            float q = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h)
                if (4 * lane + 128 * h < C) {
                    const float4 d = make_float4(v[k][h].x - u, v[k][h].y - u, v[k][h].z - u,
                                                 v[k][h].w - u);
                    q = fmaf(d.x, d.x, fmaf(d.y, d.y, fmaf(d.z, d.z, fmaf(d.w, d.w, q))));
                }
            const float inv = 1.f / sqrtf(warp_sum(q) / C + kEps);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int c = 4 * lane + 128 * h;
                if (c >= C) continue;
                const float4 w = lw[h], b = lb[h], x = v[k][h];
                st4(at(p, c), make_float4((x.x - u) * inv * w.x + b.x, (x.y - u) * inv * w.y + b.y,
                                          (x.z - u) * inv * w.z + b.z, (x.w - u) * inv * w.w + b.w));
            }
        }
    }
}

// The helpers (warps `which` = 0 .. kHelpers - 1): all of a tile's work but its products, in
// the consumers' order of (tile, piece) units:
//   * A's columns of a unit, 32 at a time, into the slots as the consumers free them, by
//     cp.async, chunk c by helper c % kHelpers: the next unit's during this one's last pass,
//     so that they land while it ends; before a tile's rows, helper 0 prefetches fc1's
//     shortcut rows into L2 for the consumers' LayerNorm;
//   * each pass's epilogue, from the sums the consumers leave in S: bias, residuals, GELU,
//     the pieces' sums, in whole rows of device memory; row p is helper p % kHelpers's in
//     every pass and piece, so that whatever it parks it reads back itself;
//   * LN_sg over the second half of each hidden row of a tile, once its epilogues are done.
template <int MODE, bool SPLIT, typename T, typename TA>
__device__ __forceinline__ void rows_help(const RowArgs<T, TA>& g, TA* slots, const float* S,
                                          uint64_t* afull, uint64_t* aempty, uint64_t* efull,
                                          uint64_t* efree, int which) {
    constexpr int LD = kLd<TA>;
    constexpr bool kSelfA = MODE == kFc1 && SPLIT;
    const int lane = threadIdx.x & 31, C = g.C, ntn = g.Np / 8;
    const int width = MODE == kFc2 ? g.Kp : C;                              // of a row of `a`
    const int wdst = MODE == kFc1 ? g.Np : MODE == kLinear ? g.nreal : C;  // of a row of out
    uint32_t aph = 0, eph = 0;   // each slot's round parity, a bit a slot; the sums'
    // where row gp's shortcut pixel (y + s, x + s) lies, wrapping, and its image (kProj; the
    // entry keeps B * H * W within an int)
    auto shortcut = [&](int gp, int& bi) {
        const int hw = g.H * g.W;
        bi = gp / hw;
        const int rem = gp - bi * hw;
        int yy = rem / g.W + g.shift, xx = rem % g.W + g.shift;
        if (yy >= g.H) yy -= g.H;
        if (xx >= g.W) xx -= g.W;
        return bi * hw + yy * g.W + xx;
    };
    // fc1's shortcut rows of a tile, into L2 ahead of the LayerNorm that reads them
    auto prefetch = [&](int tile) {
        if (MODE != kFc1 || !g.x || which != 0 || lane != 0) return;
        const long long p0 = (long long)tile * kRowM;
        prefetch_rows(g.x, p0, min((long long)kRowM, g.npix - p0), C);
    };
    // the unit's chunks of this helper
    auto load_unit = [&](int tile, int k0) {
        if (kSelfA) return;   // its consumers stage A themselves
        const long long p0 = (long long)tile * kRowM;
        const int kh = min(g.Kt, g.Kp - k0), nch = (kh + kKC - 1) / kKC;
        for (int c = which; c < nch; c += kHelpers) {
            mbar_wait(aempty + c, ((aph >> c) & 1) ^ 1);
            TA* slot = slots + c * kRowM * LD + 4 * (lane & 7);
            const int col = kKC * c + 4 * (lane & 7);   // this lane's quad of every row
            const bool colok = col < kh && k0 + col < width;
            const TA* src = g.a + k0 + col;
#pragma unroll 4
            for (int p = lane >> 3; p < kRowM; p += 4) {
                const long long gp = p0 + p;
                const bool ok = colok && gp < g.npix;
                cp_async_quad(slot + p * LD, ok ? src + gp * width : g.a, ok);
            }
            mbar_cp_async_arrive(afull + c);
        }
        aph ^= (1u << nch) - 1;
    };
    // the epilogue of a pass: columns n, n + 1 (n even) of this helper's rows, kEpiRows rows
    // at a time, their loads before their stores; the same arithmetic as tile_mma's epilogue
    auto epilogue = [&](int tile, int k0, int nt0) {
        const long long p0 = (long long)tile * kRowM;
        const bool first = k0 == 0, last = k0 + g.Kt >= g.Kp;
        const int col0 = 8 * nt0, nq = min(8 * min(kPassNT, ntn - nt0), wdst - col0) / 2;
        float2 bias[2];   // of this lane's columns, the same in every row (zero past the real)
        const int nb = MODE == kFc1 ? g.nreal : wdst;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int n = col0 + 2 * (lane + 32 * i);
            bias[i] = make_float2(n < nb ? g.bias[n] : 0.f, n + 1 < nb ? g.bias[n + 1] : 0.f);
        }
        for (int pp = which; pp < kRowM; pp += kEpiRows * kHelpers) {
            float2 in0[kEpiRows][2], in1[kEpiRows][2];   // (row, column step): what it reads
            const T* xs[kEpiRows];
            const float* cb[kEpiRows];
            bool row[kEpiRows];
#pragma unroll
            for (int k = 0; k < kEpiRows; ++k) {
                const int p = pp + k * kHelpers;
                const long long gp = p0 + p;
                row[k] = p < kRowM && gp < g.npix;
                xs[k] = nullptr;
                cb[k] = nullptr;
                if (MODE == kProj && row[k]) {
                    int bi;
                    xs[k] = g.x + (size_t)shortcut((int)gp, bi) * C;
                    cb[k] = g.cabs ? g.cabs + (size_t)bi * C : nullptr;
                }
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int q = lane + 32 * i, n = col0 + 2 * q;
                    in0[k][i] = in1[k][i] = make_float2(0.f, 0.f);
                    if (!row[k] || q >= nq) continue;
                    if constexpr (MODE == kProj) {
                        in0[k][i] = ld2(xs[k] + n);
                        in1[k][i] = ld2(g.cx + gp * C + n);
                    } else if constexpr (MODE == kFc1) {
                        if (SPLIT && !first)   // the last pieces' sums
                            in0[k][i] = *reinterpret_cast<const float2*>(g.hid + gp * g.Np + n);
                    } else if (MODE == kFc2 || !first) {   // y, or the last pieces' sums
                        in0[k][i] = ld2(g.y + gp * wdst + n);
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < kEpiRows; ++k)
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int p = pp + k * kHelpers, q = lane + 32 * i, n = col0 + 2 * q;
                    if (!row[k] || q >= nq) continue;
                    const long long gp = p0 + p;
                    const float2 uu = *reinterpret_cast<const float2*>(S + p * kSLd + 2 * q);
                    const float u0 = uu.x, u1 = uu.y;
                    const float2 v = in0[k][i];
                    if constexpr (MODE == kFc1) {   // the hidden, zero in its padding
                        float2* hp = reinterpret_cast<float2*>(g.hid + gp * g.Np + n);
                        float v0 = u0, v1 = u1;
                        if constexpr (SPLIT) {   // the pieces' sums, in f32
                            if (!first) {
                                v0 += v.x;
                                v1 += v.y;
                            }
                            if (!last) {
                                *hp = make_float2(v0, v1);
                                continue;
                            }
                        }
                        *hp = make_float2(n < g.nreal ? gelu_erf(v0 + bias[i].x) : 0.f,
                                          n + 1 < g.nreal ? gelu_erf(v1 + bias[i].y) : 0.f);
                        continue;
                    }
                    const long long o = gp * wdst + n;
                    const float2 b = bias[i];
                    // the sum so far is kept in y (f32; out itself for f32) until the last piece
                    auto put = [&](float2 w) {
                        if (last) st2(g.out + o, w);
                        else *reinterpret_cast<float2*>(g.y + o) = w;
                    };
                    if constexpr (MODE == kLinear) {
                        const float2 y = first ? b : v;
                        put(make_float2(y.x + u0, y.y + u1));
                    } else if constexpr (MODE == kProj) {   // y, f32
                        const float2 cx = in1[k][i];
                        *reinterpret_cast<float2*>(g.y + o) = make_float2(
                            v.x + u0 + b.x + (cb[k] ? g.conv_scale * cb[k][n] : g.conv_scale) * cx.x,
                            v.y + u1 + b.y +
                                (cb[k] ? g.conv_scale * cb[k][n + 1] : g.conv_scale) * cx.y);
                    } else {   // kFc2: y holds y, then y + the earlier pieces' sums
                        put(first ? make_float2(v.x + (u0 + b.x), v.y + (u1 + b.y))
                                  : make_float2(v.x + u0, v.y + u1));
                    }
                }
        }
    };
    // LN_sg over the second half of each of this helper's hidden rows, in place
    auto ln_sg = [&](int tile) {
        const int half = g.nreal / 2;
        const long long p0 = (long long)tile * kRowM;
        const int rows = (int)min((long long)kRowM, g.npix - p0);   // the tile's
        for (int p = which; p < rows; p += (half <= 384 ? kSgRows : 1) * kHelpers) {
            float* row = g.hid + (p0 + p) * g.Np + half;
            if (half <= 384) {   // and the helper's next rows beside it, loads before stores
                ln_rows_inplace<kSgRows>(row, (size_t)kHelpers * g.Np,
                                         min(kSgRows, (rows - p + kHelpers - 1) / kHelpers),
                                         g.sgw, g.sgb, half);
            } else {   // wider than a warp's registers: statistics first, then in place
                float u, inv;
                warp_ln_stats(row, half, kEps, u, inv);
                for (int c = 4 * lane; c < half; c += 128) {
                    const float4 v = *reinterpret_cast<const float4*>(row + c);
                    const float4 w = *reinterpret_cast<const float4*>(g.sgw + c);
                    const float4 b = *reinterpret_cast<const float4*>(g.sgb + c);
                    *reinterpret_cast<float4*>(row + c) = make_float4(
                        (v.x - u) * inv * w.x + b.x, (v.y - u) * inv * w.y + b.y,
                        (v.z - u) * inv * w.z + b.z, (v.w - u) * inv * w.w + b.w);
                }
            }
        }
    };
    int tile = blockIdx.x, k0 = 0;
    if (tile >= g.ntiles) return;
    prefetch(tile);
    load_unit(tile, k0);
    while (tile < g.ntiles) {
        int nt = tile, nk = k0 + g.Kt;   // the next unit
        if (nk >= g.Kp) {
            nk = 0;
            nt += gridDim.x;
        }
        for (int nt0 = 0; nt0 < ntn; nt0 += kPassNT) {
            if (nt0 + kPassNT >= ntn && nt < g.ntiles) {
                // the last pass: the next unit's rows, landing as the consumers free the
                // slots, before this pass's epilogue
                if (nt != tile) prefetch(nt);
                load_unit(nt, nk);
            }
            mbar_wait(efull, eph);
            epilogue(tile, k0, nt0);
            mbar_arrive(efree);
            eph ^= 1;
        }
        if (MODE == kFc1 && g.sgw && nt != tile) {
            __syncwarp();   // the warp's epilogue stores of these rows before LN_sg reads them
            ln_sg(tile);
        }
        tile = nt;
        k0 = nk;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One stage (16 k-rows) of a warp's product: its 4 m-tiles x MINE n-tiles, A from the slot at
// sa (rows 16 m + gq (+ 8), columns t (+ 4) of each k-step) and the B fragments from the
// ring's stage at sw. Always kSKS k-steps: past a piece's columns A is zero and the ring holds
// finite weights (zeroed before the first stage), so they add exact zeros.
template <int MINE, int P, typename TA>
__device__ __forceinline__ void chunk_mma(float (&part)[4][kWarpNT][4], const TA* sa,
                                          const float4* sw) {
    constexpr int LD = kLd<TA>;
#pragma unroll
    for (int s = 0; s < kSKS; ++s) {
        // the B fragments, hi and lo split on the host (at P = 1 the planes of the weight's
        // bf16 rounding: lo is zero and not read)
        uint32_t bh[MINE][2], bl[MINE][2];
#pragma unroll
        for (int j = 0; j < MINE; ++j) {
            const float4 b = sw[(s * kPassNT + j) * 32];
            bh[j][0] = __float_as_uint(b.x);
            bh[j][1] = __float_as_uint(b.y);
            bl[j][0] = __float_as_uint(b.z);
            bl[j][1] = __float_as_uint(b.w);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            const TA* pa = sa + m * 16 * LD + 8 * s;
            Frag<4, P> a;
            a.set(0, to_f32(pa[0]));
            a.set(1, to_f32(pa[8 * LD]));
            a.set(2, to_f32(pa[4]));
            a.set(3, to_f32(pa[8 * LD + 4]));
            // the three terms of every tile, the small ones first
            if constexpr (P == 3) {
#pragma unroll
                for (int j = 0; j < MINE; ++j) mma_tf32(part[m][j], a.lo, bh[j]);
#pragma unroll
                for (int j = 0; j < MINE; ++j) mma_tf32(part[m][j], a.hi, bl[j]);
            }
#pragma unroll
            for (int j = 0; j < MINE; ++j) mma_tf32(part[m][j], a.hi, bh[j]);
        }
    }
}

template <int MODE, bool SPLIT, int P, typename T, typename TA>
__global__ void __launch_bounds__(kRowThreads, 1)
rows_pipelined_kernel(const RowArgs<T, TA> g) {
    extern __shared__ float4 smem4[];
    constexpr int LD = kLd<TA>;
    // fc1 at C <= 192: the LayerNorm of the landed rows; fc1 in pieces: the consumers stage A
    // themselves, normalised from a first pass's statistics
    constexpr bool kSelfA = MODE == kFc1 && SPLIT, kLnRows = MODE == kFc1 && !SPLIT;
    float4* ring = smem4;
    TA* slots = reinterpret_cast<TA*>(smem4 + kStages * kStage4);
    float* S = reinterpret_cast<float*>(slots + kSlots * kRowM * LD);   // [128][kSLd]
    float* lnst = S + kRowM * kSLd;                                      // [128][2]
    uint64_t* wfull = reinterpret_cast<uint64_t*>(lnst + 2 * kRowM);
    uint64_t* wempty = wfull + kStages;
    uint64_t* afull = wempty + kStages;
    uint64_t* aempty = afull + kSlots;
    uint64_t* efull = aempty + kSlots;
    uint64_t* efree = efull + 1;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // the ring zeroed: a chunk's k-steps past its piece read stages no copy has written
    for (int i = tid; i < kStages * kStage4; i += kRowThreads) ring[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid == 0) {
        for (int i = 0; i < kStages; ++i) {
            mbar_init(wfull + i, 1);
            mbar_init(wempty + i, kCThreads);
        }
        for (int i = 0; i < kSlots; ++i) {
            mbar_init(afull + i, 32);
            mbar_init(aempty + i, kCThreads);
        }
        mbar_init(efull, kCThreads);
        mbar_init(efree, kHThreads);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (warp >= kCWarps) {   // the producers' two warpgroups: the weights, and the helpers
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
        if (warp == kCWarps) produce_weights<MODE, SPLIT>(g, ring, wfull, wempty);
        else rows_help<MODE, SPLIT>(g, slots, S, afull, aempty, efull, efree, warp - kCWarps - 1);
        return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

    const int C = g.C, ntn = g.Np / 8;
    // warp: rows 64 rg .., n-tiles of column group cg in each pass; lane = 4 gq + t
    const int rg = warp >> 2, cg = warp & 3, gq = lane >> 2, t = lane & 3;
    int stage = 0;
    uint32_t wph = 0, aph = 0, eph = 0;
    for (int tile = blockIdx.x; tile < g.ntiles; tile += gridDim.x) {
        const long long p0 = (long long)tile * kRowM;
        if constexpr (kSelfA) {
            // a first pass over each whole row, a warp a row: y = a + shortcut parked in out,
            // then y's mean and 1/std (the staging reads them after a barrier)
            for (int p = warp; p < kRowM; p += kCWarps) {
                const long long gp = p0 + p;
                float u = 0.f, inv = 0.f;
                if (gp < g.npix) {
                    if (g.x) {
                        for (int c = 4 * lane; c < C; c += 128) {
                            const float4 v = ld4(g.a + gp * C + c);
                            const float4 s = ld4(g.x + gp * C + c);
                            *reinterpret_cast<float4*>(g.y + gp * C + c) =
                                make_float4(v.x + s.x, v.y + s.y, v.z + s.z, v.w + s.w);
                        }
                        __syncwarp();
                        warp_ln_stats(g.y + gp * C, C, kEps, u, inv);
                    } else {
                        warp_ln_stats(g.a + gp * C, C, kEps, u, inv);
                    }
                }
                if (lane == 0) {
                    lnst[2 * p] = u;
                    lnst[2 * p + 1] = inv;
                }
            }
        }
        for (int k0 = 0; k0 < g.Kp; k0 += g.Kt) {
            const int kh = min(g.Kt, g.Kp - k0), nch = (kh + kKC - 1) / kKC;
            if constexpr (kSelfA) {
                // LN(y) of the piece's columns from the first pass's mean and 1/std, zero past
                // them to the piece's whole slots, once every consumer is past the last
                // piece's reads of the slots
                consumers_sync();
                const int k4 = kKC * nch / 4;
#pragma unroll 4
                for (int e = tid; e < kRowM * k4; e += kCThreads) {
                    const int p = e / k4, c = (e % k4) * 4, ch = k0 + c;
                    const long long gp = p0 + p;
                    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
                    if (gp < g.npix && c < kh && ch < C) {
                        const float4 v = g.x ? ld4(g.y + gp * C + ch) : ld4(g.a + gp * C + ch);
                        const float4 w = *reinterpret_cast<const float4*>(g.lnw + ch);
                        const float4 b = *reinterpret_cast<const float4*>(g.lnb + ch);
                        const float u = lnst[2 * p], inv = lnst[2 * p + 1];
                        o = make_float4((v.x - u) * inv * w.x + b.x, (v.y - u) * inv * w.y + b.y,
                                        (v.z - u) * inv * w.z + b.z, (v.w - u) * inv * w.w + b.w);
                    }
                    st4(slots + (c >> 5) * kRowM * LD + p * LD + (c & 31), o);
                }
                consumers_sync();
            }
            if constexpr (kLnRows) {   // the tile's rows landed, normalised before any MMA
                for (int c = 0; c < nch; ++c) mbar_wait(afull + c, (aph >> c) & 1);
                layernorm_rows(g, slots, p0);
                consumers_sync();
            }
            for (int nt0 = 0; nt0 < ntn; nt0 += kPassNT) {
                // the pass's n-tiles over the four column groups, as evenly as they fall
                const int nnt = min(kPassNT, ntn - nt0), base = nnt >> 2, rem = nnt & 3;
                const int my0 = cg * base + min(cg, rem), mine = base + (cg < rem ? 1 : 0);
                const bool lastpass = nt0 + kPassNT >= ntn;
                float acc[4][kWarpNT][4], part[4][kWarpNT][4];
#pragma unroll
                for (int m = 0; m < 4; ++m)
#pragma unroll
                    for (int j = 0; j < kWarpNT; ++j)
#pragma unroll
                        for (int r = 0; r < 4; ++r) acc[m][j][r] = 0.f;
                const int nst = (kh / 8 + kSKS - 1) / kSKS;   // stages of the piece
                for (int st = 0; st < nst; ++st) {
                    const int c = st / kSlotStages;   // its A slot
                    if (!kSelfA && !kLnRows && nt0 == 0 && st % kSlotStages == 0)
                        mbar_wait(afull + c, (aph >> c) & 1);
                    mbar_wait(wfull + stage, wph);
                    // a fresh register tile every 64 k-rows, as tile_mma's chunks
                    if (st % (8 / kSKS) == 0) {
#pragma unroll
                        for (int m = 0; m < 4; ++m)
#pragma unroll
                            for (int j = 0; j < kWarpNT; ++j)
#pragma unroll
                                for (int r = 0; r < 4; ++r) part[m][j][r] = 0.f;
                    }
                    const TA* sa = slots + c * kRowM * LD + (64 * rg + gq) * LD + t +
                                   8 * kSKS * (st % kSlotStages);
                    const float4* sw = ring + stage * kStage4 + my0 * 32 + lane;
                    // the warp's n-tiles fixed at compile time: no branch among the MMAs
                    switch (mine) {
                        case 4: if constexpr (kWarpNT >= 4) chunk_mma<4, P>(part, sa, sw); break;
                        case 3: chunk_mma<3, P>(part, sa, sw); break;
                        case 2: chunk_mma<2, P>(part, sa, sw); break;
                        case 1: chunk_mma<1, P>(part, sa, sw); break;
                        default: break;
                    }
                    mbar_arrive(wempty + stage);
                    if (!kSelfA && lastpass && (st % kSlotStages == kSlotStages - 1 || st + 1 == nst))
                        mbar_arrive(aempty + c);
                    if (st % (8 / kSKS) == 8 / kSKS - 1 || st + 1 == nst) {
#pragma unroll
                        for (int m = 0; m < 4; ++m)
#pragma unroll
                            for (int j = 0; j < kWarpNT; ++j)
#pragma unroll
                                for (int r = 0; r < 4; ++r) acc[m][j][r] += part[m][j][r];
                    }
                    if (++stage == kStages) {
                        stage = 0;
                        wph ^= 1;
                    }
                }
                // the pass's sums to the helpers, once they are done with the last pass's
                mbar_wait(efree, eph ^ 1);
#pragma unroll
                for (int m = 0; m < 4; ++m)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
#pragma unroll
                        for (int j = 0; j < kWarpNT; ++j)
                            if (j < mine)
                                *reinterpret_cast<float2*>(
                                    S + (64 * rg + 16 * m + gq + 8 * h) * kSLd + 8 * (my0 + j) + 2 * t) =
                                    make_float2(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
                mbar_arrive(efull);
                eph ^= 1;
            }
            if (!kSelfA) aph ^= (1u << nch) - 1;
        }
    }
}

// y += x[(y + s) % H][(x + s) % W] + conv_scale * cab_scale * conv_x, pixel by pixel, in f32:
// the projection's residuals where C > kMmaMaxK (the linear mode wrote y = att @ wproj +
// bproj; y is out itself for f32 storage)
template <typename T>
__global__ void residual_kernel(const RowArgs<T, T> g) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;   // a float2
    const int c2 = g.C / 2;
    if (e >= g.npix * c2) return;
    const long long gp = e / c2, hw = (long long)g.H * g.W;
    const int n = 2 * (int)(e - gp * c2);
    const int bi = (int)(gp / hw), rem = (int)(gp - bi * hw);
    int y = rem / g.W + g.shift, xx = rem % g.W + g.shift;
    if (y >= g.H) y -= g.H;
    if (xx >= g.W) xx -= g.W;
    float2* o = reinterpret_cast<float2*>(g.y + gp * g.C + n);
    const float2 u = *o;
    const float2 xs = ld2(g.x + (bi * hw + (long long)y * g.W + xx) * g.C + n);
    const float2 cx = ld2(g.cx + gp * g.C + n);
    float2 s = make_float2(g.conv_scale, g.conv_scale);
    if (g.cabs) {
        const float2 cb = *reinterpret_cast<const float2*>(g.cabs + (size_t)bi * g.C + n);
        s = make_float2(g.conv_scale * cb.x, g.conv_scale * cb.y);
    }
    *o = make_float2(xs.x + u.x + s.x * cx.x, xs.y + u.y + s.y * cx.y);
}

// One launch on `grid` persistent blocks (a block past the row tiles has nothing to walk).
template <int MODE, bool SPLIT, int P, typename T, typename TA>
cudaError_t launch_split(RowArgs<T, TA> g, int grid, cudaStream_t st) {
    constexpr size_t smem = rows_smem<TA>();
    const auto kernel = rows_pipelined_kernel<MODE, SPLIT, P, T, TA>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    g.Kt = SPLIT || pieces(MODE) ? tile_mma_piece(g.Kp) : g.Kp;
    g.ntiles = (int)((g.npix + kRowM - 1) / kRowM);
    kernel<<<grid, kRowThreads, smem, st>>>(g);
    return cudaGetLastError();
}

template <int MODE, int P, typename T, typename TA>
cudaError_t launch(const RowArgs<T, TA>& g, int grid, cudaStream_t st) {
    if (g.C % 4 || g.Kp % 8 || g.Np % 8 || g.npix < 1 || (g.npix - 1) / kRowM >= 0x40000000LL ||
        grid < 1)
        return cudaErrorInvalidValue;
    const int Kt = tile_mma_piece(g.Kp);
    if constexpr (MODE == kFc1) {
        if (Kt != g.Kp) return launch_split<kFc1, true, P>(g, grid, st);
    }
    if (MODE == kProj && Kt != g.Kp) return cudaErrorInvalidValue;   // hab_tail splits it
    return launch_split<MODE, false, P>(g, grid, st);
}

// y: where y = a + shortcut goes (f32; out itself for f32 storage).
template <int P, typename T, typename TA>
cudaError_t fc1(const TA* a, const T* shortcut, const float* lnw, const float* lnb,
                const float* w1, const float* b1, const float* sgw, const float* sgb,
                float* hid, T* out, float* y, long long npix, int C, int nhid, int Kp, int K2p,
                int grid, cudaStream_t st) {
    if (Kp < C || K2p < nhid) return cudaErrorInvalidValue;
    RowArgs<T, TA> g = {};
    g.a = a; g.x = shortcut; g.lnw = lnw; g.lnb = lnb; g.sgw = sgw; g.sgb = sgb;
    g.w = reinterpret_cast<const float4*>(w1); g.bias = b1;
    g.out = out; g.y = y; g.hid = hid; g.npix = npix; g.C = C; g.Kp = Kp; g.Np = K2p;
    g.nreal = nhid;
    return launch<kFc1, P>(g, grid, st);
}

// fc1 and fc2 on y: from `a` (+ `shortcut`, then y is written to y) or from y in `a` (TA =
// f32). out = y + fc2.
template <int P, typename T, typename TA>
cudaError_t mlp(const TA* a, const T* shortcut, const float* lnw, const float* lnb,
                const float* w1, const float* b1, const float* w2, const float* b2, float* hid,
                T* out, float* y, long long npix, int C, int nhid, int Kp, int Np, int K2p,
                int grid, cudaStream_t st) {
    if (Np < C) return cudaErrorInvalidValue;
    cudaError_t err = fc1<P>(a, shortcut, lnw, lnb, w1, b1, nullptr, nullptr, hid, out, y, npix,
                             C, nhid, Kp, K2p, grid, st);
    if (err != cudaSuccess) return err;
    RowArgs<T, float> f = {};
    f.a = hid; f.w = reinterpret_cast<const float4*>(w2); f.bias = b2; f.out = out;
    f.y = shortcut ? y : const_cast<float*>(reinterpret_cast<const float*>(a));
    f.npix = npix; f.C = C; f.Kp = K2p; f.Np = Np; f.nreal = C;
    return launch<kFc2, P>(f, grid, st);
}

template <int P, typename T>
cudaError_t linear(const T* a, const float* wp, const float* bp, T* out, float* y,
                   long long npix, int C, int Cout, int Kp, int Np, int grid, cudaStream_t st) {
    RowArgs<T, T> g = {};
    g.a = a; g.w = reinterpret_cast<const float4*>(wp); g.bias = bp; g.out = out; g.y = y;
    g.npix = npix; g.C = C; g.Kp = Kp; g.Np = Np; g.nreal = Cout;
    return launch<kLinear, P>(g, grid, st);
}

// y: f32 [npix][C], out itself for f32 storage.
template <int P, typename T>
cudaError_t tail(const T* att, const T* x, const T* cx, const float* cabs, const float* wp,
                 const float* bp, const float* lnw, const float* lnb, const float* w1,
                 const float* b1, const float* w2, const float* b2, float* hid, T* out,
                 float* y, int B, int H, int W, int C, int nhid, int Kp, int Np, int K2p,
                 int shift, float conv_scale, int grid, cudaStream_t st) {
    RowArgs<T, T> g = {};
    g.a = att; g.x = x; g.cx = cx; g.cabs = cabs; g.w = reinterpret_cast<const float4*>(wp);
    g.bias = bp; g.out = out; g.y = y;
    g.npix = (long long)B * H * W; g.H = H; g.W = W; g.C = C; g.Kp = Kp; g.Np = Np;
    g.nreal = C; g.shift = shift; g.conv_scale = conv_scale;
    cudaError_t err;
    if (tile_mma_piece(Kp) == Kp) {
        err = launch<kProj, P>(g, grid, st);
    } else {   // K in pieces: the linear product into y, its pieces summed there in f32,
               // then the residuals added to y
        RowArgs<float, T> l = {};
        l.a = att; l.w = g.w; l.bias = bp; l.out = y; l.y = y;
        l.npix = g.npix; l.C = C; l.Kp = Kp; l.Np = Np; l.nreal = C;
        err = launch<kLinear, P>(l, grid, st);
        if (err != cudaSuccess) return err;
        const long long n2 = g.npix * (C / 2);
        if ((n2 + 255) / 256 > 0x7fffffffLL) return cudaErrorInvalidValue;
        residual_kernel<T><<<(unsigned)((n2 + 255) / 256), 256, 0, st>>>(g);
        err = cudaGetLastError();
    }
    if (err != cudaSuccess) return err;
    return mlp<P>(static_cast<const float*>(y), static_cast<const T*>(nullptr), lnw, lnb, w1, b1,
                  w2, b2, hid, out, y, g.npix, C, nhid, Kp, Np, K2p, grid, st);
}

}  // namespace

// Storage: a, shortcut, x, cx and out in the storage type of `mode` (common.cuh: IoMode). y
// is f32 scratch [npix][C] (or [npix][Cout] for rows_linear) for bf16, where y is parked (and
// where rows_linear's and hab_tail's pieces sum when Kp > 192); for f32 storage it may be
// null, and out holds y. grid: the persistent blocks of each launch (ops/kernels/_mma.py:
// row_grid, one an SM); a launch takes min(grid, row tiles of 128 pixels).

// out [npix][Cout] = a [npix][C] @ w + bp, Cout even; wp = mma_planes of w [Kp][Np].
extern "C" int rows_linear(const float* a, const float* wp, const float* bp, float* out,
                           float* y, long long npix, int C, int Cout, int Kp, int Np, int grid,
                           int mode, void* stream) {
    if (Kp < C || Np < Cout || Cout < 2 || Cout % 2) return cudaErrorInvalidValue;
    if (mode == 1 && !y && tile_mma_piece(Kp) != Kp) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return by_mode(mode, [&](auto m) {
        using T = typename decltype(m)::T;
        return linear<decltype(m)::P>(as<T>(a), wp, bp, as<T>(out), kBf16<T> ? y : out, npix, C,
                                      Cout, Kp, Np, grid, st);
    });
}

// y = a + shortcut into y (out for f32), hid [npix][K2p] = GELU(LN(y) @ w1 + b1), w1 =
// mma_planes of [Kp][K2p]; with sgw, LN_sg (sgw, sgb) over columns nhid/2 .. nhid - 1 of each
// hidden row.
extern "C" int rows_ln_fc1(const float* a, const float* shortcut, const float* lnw,
                           const float* lnb, const float* w1, const float* b1,
                           const float* sgw, const float* sgb, float* hid, float* out,
                           float* y, long long npix, int C, int nhid, int Kp, int K2p, int grid,
                           int mode, void* stream) {
    if (sgw && (nhid % 2 || nhid / 2 % 4)) return cudaErrorInvalidValue;
    if (mode == 1 && shortcut && !y) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return by_mode(mode, [&](auto m) {
        using T = typename decltype(m)::T;
        return fc1<decltype(m)::P>(as<T>(a), as<T>(shortcut), lnw, lnb, w1, b1, sgw, sgb, hid,
                                   as<T>(out), kBf16<T> ? y : out, npix, C, nhid, Kp, K2p, grid,
                                   st);
    });
}

extern "C" int hab_tail(const float* att, const float* x, const float* cx, const float* cabs,
                        const float* wp, const float* bp, const float* lnw, const float* lnb,
                        const float* w1, const float* b1, const float* w2, const float* b2,
                        float* hid, float* out, float* y, int B, int H, int W, int C, int nhid,
                        int Kp, int Np, int K2p, int shift, float conv_scale, int grid, int mode,
                        void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (shift < 0 || shift >= H || shift >= W || Kp < C || Np < C || (mode == 1 && !y) ||
        (long long)B * H * W > 0x7fffffffLL)   // the shortcut's pixel is an int
        return cudaErrorInvalidValue;
    return by_mode(mode, [&](auto m) {
        using T = typename decltype(m)::T;
        return tail<decltype(m)::P>(as<T>(att), as<T>(x), as<T>(cx), cabs, wp, bp, lnw, lnb, w1,
                                    b1, w2, b2, hid, as<T>(out), kBf16<T> ? y : out, B, H, W, C,
                                    nhid, Kp, Np, K2p, shift, conv_scale, grid, st);
    });
}

extern "C" int residual_ln_mlp(const float* a, const float* shortcut, const float* lnw,
                               const float* lnb, const float* w1, const float* b1,
                               const float* w2, const float* b2, float* hid, float* out,
                               float* y, long long npix, int C, int nhid, int Kp, int Np, int K2p,
                               int grid, int mode, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (mode == 1 && (!y || !shortcut)) return cudaErrorInvalidValue;
    return by_mode(mode, [&](auto m) {
        using T = typename decltype(m)::T;
        return mlp<decltype(m)::P>(as<T>(a), as<T>(shortcut), lnw, lnb, w1, b1, w2, b2, hid,
                                   as<T>(out), kBf16<T> ? y : out, npix, C, nhid, Kp, Np, K2p,
                                   grid, st);
    });
}
