// A dense 3x3 SAME convolution as an implicit GEMM on the tensor cores, f32-exact in 3xTF32
// (mma_f32x3.cuh; sm_90a), shared by the CAB chain (csrc/cab.cu: both of its convolutions)
// and the wide case of the dense conv (csrc/conv3x3.cu).
//
// The GEMM: M is a block's 4 x 32 output pixels, N its output channels in passes of 64,
// K the 9 taps x Cin. A fragments come from the staged halo tile (for tap (dy, dx) the 16
// pixels of an m-tile are 16 neighbouring pixels of a halo row), B fragments from the
// staged weights [tap][k][n].
//   * a warp owns one tile row (two m-tiles of 16 pixels) and 32 channels of a pass (four
//     n-tiles): per k-step it reads 8 + 8 floats of shared memory, splits them into TF32
//     high and low parts and issues 24 MMAs; 32 accumulators a thread;
//   * K runs in chunks of 8 input channels (one k-step a tap): the chunk's 6 x 34 halo
//     [halo pixel][8 + 4] (a stride of 4 mod 8: conflict-free A reads) and its weights
//     [9][8][64 + 8] (8 mod 32: conflict-free B reads) go through a 3-stage cp.async ring,
//     so two chunks are in flight while the third is multiplied; the passes over N run in
//     the same ring, one chunk after another. Halo pixels outside the image (the SAME
//     padding) and channels past Cin are plain zero stores;
//   * the tensor core's own adds round toward zero, so a long chain of MMAs into one
//     accumulator drifts: each chunk's 9 taps go into a fresh register tile, added to the
//     running sum with f32 adds that round to nearest;
//   * Cin and Cout are padded to multiples of 8, the MMA's k and n: 180 -> 184, 60 -> 64;
//   * 94 KB of shared memory a block: two blocks an SM, 16 warps.
// Weights come zero-padded as [9][Cinp][Np] (Cinp % 8 == 0, Np % 8 == 0) and the bias as
// [Np]; the input has Cin channels (Cin % 4 == 0), the output Cst (Cst % 4 == 0, the first
// Cst of the Np columns are stored).
#pragma once

#include "mma_f32x3.cuh"

namespace {

constexpr int kTH = 4, kTW = 32;                // output tile
constexpr int kHH = kTH + 2, kHW = kTW + 2;     // its halo
constexpr int kHP = kHH * kHW;                  // halo pixels
constexpr int kCC = 8;                          // input channels a chunk: one k-step
constexpr int kLdX = kCC + 4;                   // halo row stride, 4 mod 8
constexpr int kNT = 64;                         // output channels a pass
constexpr int kLdW = kNT + 8;                   // weight row stride, 8 mod 32
constexpr int kStages = 3;
constexpr int kWStage = 9 * kCC * kLdW, kXStage = kHP * kLdX;
constexpr float kLnEps = 1e-5f;

static_assert(kThreads == 256 && kTH == 4 && kTW == 32, "8 warps: 4 tile rows x 2 halves");

constexpr size_t conv_gemm_smem_bytes() {
    return (size_t)(kStages * (kWStage + kXStage) + 2 * kHP + 4 * kNT) * sizeof(float);
}

// FIRST, the CAB chain's first conv: LayerNorm (lnw, lnb, eps 1e-5) of each input pixel on
// load, the zeros outside the image being those of the normalised image, and GELU at the
// store. Otherwise a plain conv + bias, stored at (y - shift, x - shift) with wrap-around,
// and, where `part` is given, the per-channel sums of the block's outputs into
// part[image][block][channel], added in a fixed order. T: the storage type of x and out
// (f32, or bf16 with bf16 products: the halo is converted to f32 as it is staged and rounded
// back to bf16 where its fragments are set; the weights, the bias and the sums are f32).
template <bool FIRST, typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_gemm_kernel(const T* __restrict__ x, const float* __restrict__ lnw,
                    const float* __restrict__ lnb, const float* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ out,
                    float* __restrict__ part, int H, int W, int Cin, int Cinp, int Np, int Cst,
                    int shift) {
    constexpr int P = kPasses<T>;
    extern __shared__ float4 smem4[];
    float* wsm = reinterpret_cast<float*>(smem4);  // [kStages][9][kCC][kLdW]
    float* xs = wsm + kStages * kWStage;            // [kStages][kHP][kLdX]
    float* st = xs + kStages * kXStage;             // [kHP][2] mean, 1/std
    float* red = st + 2 * kHP;                      // [4][kNT]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3, wm = warp & 3, wn = warp >> 2;
    const int bi = blockIdx.z, ty0 = blockIdx.y * kTH, tx0 = blockIdx.x * kTW;
    const T* xb = x + (size_t)bi * H * W * Cin;

    if (FIRST) {
        for (int hp = warp; hp < kHP; hp += kThreads / 32) {
            const int yy = ty0 - 1 + hp / kHW, xx = tx0 - 1 + hp % kHW;
            float u = 0.f, inv = 0.f;
            if (yy >= 0 && yy < H && xx >= 0 && xx < W)
                warp_ln_stats(xb + ((size_t)yy * W + xx) * Cin, Cin, kLnEps, u, inv);
            if (lane == 0) {
                st[2 * hp] = u;
                st[2 * hp + 1] = inv;
            }
        }
        // st is read only by the thread that staged the element, after the ring's barrier
        __syncthreads();
    }

    const int nck = Cinp / kCC, npass = (Np + kNT - 1) / kNT, total = npass * nck;
    // the copies of chunk i (pass i / nck, input channels (i % nck) * 8 ..) into stage i % 3
    auto issue = [&](int i) {
        if (i < total) {
            const int s = i % kStages, n0 = (i / nck) * kNT, c0 = (i % nck) * kCC;
            const int c4 = min(kNT, Np - n0) / 4;
            float* ws = wsm + s * kWStage;
            for (int e = tid; e < 9 * kCC * c4; e += kThreads) {
                const int row = e / c4, col = (e % c4) * 4;
                const int tap = row / kCC, kk = row % kCC;
                cp_async16(ws + row * kLdW + col,
                           w + ((size_t)tap * Cinp + c0 + kk) * Np + n0 + col);
            }
            float* xc = xs + s * kXStage;
            for (int e = tid; e < kHP * (kCC / 4); e += kThreads) {
                const int hp = e / (kCC / 4), q = (e % (kCC / 4)) * 4, ch = c0 + q;
                const int yy = ty0 - 1 + hp / kHW, xx = tx0 - 1 + hp % kHW;
                if (yy >= 0 && yy < H && xx >= 0 && xx < W && ch < Cin)
                    stage4(xc + hp * kLdX + q, xb + ((size_t)yy * W + xx) * Cin + ch);
                else
                    *reinterpret_cast<float4*>(xc + hp * kLdX + q) =
                        make_float4(0.f, 0.f, 0.f, 0.f);
            }
        }
        cp_async_commit();  // an empty group past the end keeps the counts uniform
    };
    const int nblk = gridDim.x * gridDim.y, blk = blockIdx.y * gridDim.x + blockIdx.x;

    float acc[2][4][4];
    issue(0);
    issue(1);
    for (int i = 0; i < total; ++i) {
        const int s = i % kStages, n0 = (i / nck) * kNT, c = i % nck;
        const int ncols = min(kNT, Np - n0);
        if (c == 0) {
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int r = 0; r < 4; ++r) acc[a][j][r] = 0.f;
        }
        cp_async_wait<1>();  // this thread's copies of chunk i have landed
        float* xc = xs + s * kXStage;
        if (FIRST) {  // normalise the elements this thread copied, in place
            const int c0 = c * kCC;
            for (int e = tid; e < kHP * (kCC / 4); e += kThreads) {
                const int hp = e / (kCC / 4), q = (e % (kCC / 4)) * 4, ch = c0 + q;
                const int yy = ty0 - 1 + hp / kHW, xx = tx0 - 1 + hp % kHW;
                if (yy >= 0 && yy < H && xx >= 0 && xx < W && ch < Cin) {
                    float4* p = reinterpret_cast<float4*>(xc + hp * kLdX + q);
                    float4 v = *p;
                    const float u = st[2 * hp], inv = st[2 * hp + 1];
                    const float4 lw = *reinterpret_cast<const float4*>(lnw + ch);
                    const float4 lb = *reinterpret_cast<const float4*>(lnb + ch);
                    v.x = (v.x - u) * inv * lw.x + lb.x;
                    v.y = (v.y - u) * inv * lw.y + lb.y;
                    v.z = (v.z - u) * inv * lw.z + lb.z;
                    v.w = (v.w - u) * inv * lw.w + lb.w;
                    *p = v;
                }
            }
        }
        // chunk i visible to every thread, and every thread is past chunk i - 1: its
        // stage, (i + 2) % 3, may be refilled
        __syncthreads();
        issue(i + 2);
        const float* wc = wsm + s * kWStage;
        float part_acc[2][4][4];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) part_acc[a][j][r] = 0.f;
#pragma unroll 3
        for (int tap = 0; tap < 9; ++tap) {
            const int dy = tap / 3, dx = tap - 3 * dy;
            Frag<4, P> a[2];
#pragma unroll
            for (int m = 0; m < 2; ++m)
                load_a(a[m], xc, kLdX, (wm + dy) * kHW + 16 * m + dx, 0);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int nb = 32 * wn + 8 * j;
                if (nb < ncols) {
                    Frag<2, P> b;
                    load_b_kn(b, wc + tap * kCC * kLdW, kLdW, 0, nb);
                    mma_f32x3(part_acc[0][j], a[0], b);
                    mma_f32x3(part_acc[1][j], a[1], b);
                }
            }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[a][j][r] += part_acc[a][j][r];
        if (c + 1 < nck) continue;

        // the pass's epilogue: bias, GELU or the shifted store, the channel sums
        const int yy = ty0 + wm;
        float cs[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            cs[j][0] = cs[j][1] = 0.f;
            const int n = n0 + 32 * wn + 8 * j + 2 * t;
            if (32 * wn + 8 * j >= ncols || n >= Cst) continue;
            const float2 bv = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int xx = tx0 + 16 * m + g + 8 * h;
                    if (yy >= H || xx >= W) continue;
                    float2 v = make_float2(acc[m][j][2 * h] + bv.x, acc[m][j][2 * h + 1] + bv.y);
                    int oy = yy, ox = xx;
                    if (FIRST) {
                        v = make_float2(gelu_erf(v.x), gelu_erf(v.y));
                    } else {
                        cs[j][0] += v.x;
                        cs[j][1] += v.y;
                        if (shift) {
                            oy = yy >= shift ? yy - shift : yy - shift + H;
                            ox = xx >= shift ? xx - shift : xx - shift + W;
                        }
                    }
                    st2(out + (((size_t)bi * H + oy) * W + ox) * Cst + n, v);
                }
        }
        if (!FIRST && part) {
            // the warp's 32 pixels: the 8 lanes of a column add in a fixed order, then the
            // 4 tile rows in order
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float v = cs[j][h];
                    v += __shfl_xor_sync(0xffffffffu, v, 4);
                    v += __shfl_xor_sync(0xffffffffu, v, 8);
                    v += __shfl_xor_sync(0xffffffffu, v, 16);
                    if (g == 0) red[wm * kNT + 32 * wn + 8 * j + 2 * t + h] = v;
                }
            __syncthreads();
            if (tid < kNT && n0 + tid < Cst)
                part[((size_t)bi * nblk + blk) * Cst + n0 + tid] =
                    ((red[tid] + red[kNT + tid]) + red[2 * kNT + tid]) + red[3 * kNT + tid];
            __syncthreads();  // red is free for the next pass
        }
    }
}

}  // namespace
