// A dense 3x3 SAME convolution as an implicit GEMM on CUDA cores (f32, sm_90a), shared by
// the CAB chain (csrc/cab.cu: both of its convolutions) and the wide case of the dense
// conv (csrc/conv3x3.cu).
//
//   * a block owns a 4 x 32 tile of output pixels and 64 output channels a pass; a thread
//     owns 8 neighbouring pixels of a row and 4 channels (32 accumulators);
//   * the input's 6 x 34 halo tile goes through shared memory 16 channels at a time,
//     [halo pixel][16 + 4], zeros outside the image (the SAME padding); for tap (dy, dx) a
//     thread's 8 input rows are again 8 neighbouring rows of that tile, so the inner loop
//     is tile_matmul's: per four k it reads 8 + 4 float4s from shared memory for 128 FMAs.
//     The two half-warps sit on neighbouring tile rows, 34 * 20 floats apart, so their
//     broadcasts hit other banks;
//   * the matching weights [9 taps][16][64] (36 KB) are streamed with cp.async, double
//     buffered, so the copy of chunk c+1 overlaps the FMAs on chunk c; two blocks fit an SM
//     (94 KB each).
// Weights come zero-padded as [9][Cinp][Np] (Cinp % 16 == 0, Np % 64 == 0) and the bias as
// [Np]; the input has Cin channels (Cin % 4 == 0), the output Cst (Cst % 4 == 0, the first
// Cst of the Np columns are stored).
#pragma once

#include "common.cuh"

namespace {


constexpr int kTH = 4, kTW = 32, kTM = 8;       // output tile; pixels of a row a thread owns
constexpr int kHH = kTH + 2, kHW = kTW + 2;     // its halo
constexpr int kHP = kHH * kHW;                  // halo pixels
constexpr int kLdA = kKC + 4;                   // row stride of the staged input chunk
constexpr int kNT = 64;                         // output channels a pass
constexpr int kWStage = 9 * kKC * kNT;          // floats of one weight stage
constexpr float kLnEps = 1e-5f;

static_assert(kTH * (kTW / kTM) == kThreads / 16, "16 thread groups cover the tile");

constexpr size_t conv_gemm_smem_bytes() {
    return (size_t)(2 * kWStage + kHP * kLdA + 2 * kHP + 16 * kNT) * sizeof(float);
}

// FIRST, the CAB chain's first conv: LayerNorm (lnw, lnb, eps 1e-5) of each input pixel on
// load, the zeros outside the image being those of the normalised image, and GELU at the
// store. Otherwise a plain conv + bias, stored at (y - shift, x - shift) with wrap-around,
// and, where `part` is given, the per-channel sums of the block's outputs into
// part[image][block][channel], added in a fixed order.
template <bool FIRST>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_gemm_kernel(const float* __restrict__ x, const float* __restrict__ lnw,
                const float* __restrict__ lnb, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out,
                float* __restrict__ part, int H, int W, int Cin, int Cinp, int Np, int Cst,
                int shift) {
    extern __shared__ float4 smem4[];
    float* wsm = reinterpret_cast<float*>(smem4);  // [2][9][kKC][kNT]
    float* xs = wsm + 2 * kWStage;                  // [kHP][kLdA]
    float* st = xs + kHP * kLdA;                    // [kHP][2] mean, 1/std
    float* red = st + 2 * kHP;                      // [16][kNT]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cg = tid & 15, rg = tid >> 4, ty = rg & 3, xseg = rg >> 2;
    const int bi = blockIdx.z, ty0 = blockIdx.y * kTH, tx0 = blockIdx.x * kTW;
    const float* xb = x + (size_t)bi * H * W * Cin;

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
    }

    auto stage_w = [&](int buf, int n0, int c) {
        for (int e = tid; e < 9 * kKC * (kNT / 4); e += kThreads) {
            const int row = e / (kNT / 4), col = (e % (kNT / 4)) * 4;
            const int tap = row / kKC, kk = row % kKC;
            cp_async16(wsm + buf * kWStage + row * kNT + col,
                       w + ((size_t)tap * Cinp + c * kKC + kk) * Np + n0 + col);
        }
        cp_async_commit();
    };
    const int nck = Cinp / kKC;
    const int nblk = gridDim.x * gridDim.y, blk = blockIdx.y * gridDim.x + blockIdx.x;

    for (int n0 = 0; n0 < Np; n0 += kNT) {
        float acc[kTM][4];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        __syncthreads();  // nobody still reads the stages (an earlier pass); st is written
        stage_w(0, n0, 0);
        for (int c = 0; c < nck; ++c) {
            if (c + 1 < nck) stage_w((c + 1) & 1, n0, c + 1);
            // the input's chunk c: 4 float4s a halo pixel, normalised on the way in
            for (int e = tid; e < kHP * (kKC / 4); e += kThreads) {
                const int hp = e / (kKC / 4), q = (e % (kKC / 4)) * 4, ch = c * kKC + q;
                const int yy = ty0 - 1 + hp / kHW, xx = tx0 - 1 + hp % kHW;
                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                if (yy >= 0 && yy < H && xx >= 0 && xx < W && ch < Cin) {
                    v = *reinterpret_cast<const float4*>(xb + ((size_t)yy * W + xx) * Cin + ch);
                    if (FIRST) {
                        const float u = st[2 * hp], inv = st[2 * hp + 1];
                        const float4 lw = *reinterpret_cast<const float4*>(lnw + ch);
                        const float4 lb = *reinterpret_cast<const float4*>(lnb + ch);
                        v.x = (v.x - u) * inv * lw.x + lb.x;
                        v.y = (v.y - u) * inv * lw.y + lb.y;
                        v.z = (v.z - u) * inv * lw.z + lb.z;
                        v.w = (v.w - u) * inv * lw.w + lb.w;
                    }
                }
                *reinterpret_cast<float4*>(xs + hp * kLdA + q) = v;
            }
            if (c + 1 < nck) {
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();  // chunk c of the input and of the weights visible
            const float* wc = wsm + (c & 1) * kWStage + cg * 4;
#pragma unroll 1
            for (int tap = 0; tap < 9; ++tap) {
                const int dy = tap / 3, dx = tap - 3 * dy;
                const float* ab = xs + ((ty + dy) * kHW + xseg * kTM + dx) * kLdA;
                const float* wt = wc + tap * kKC * kNT;
#pragma unroll
                for (int k = 0; k < kKC; k += 4) {
                    float4 av[kTM];
#pragma unroll
                    for (int i = 0; i < kTM; ++i)
                        av[i] = *reinterpret_cast<const float4*>(ab + i * kLdA + k);
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk) {
                        const float4 wv = *reinterpret_cast<const float4*>(wt + (k + kk) * kNT);
#pragma unroll
                        for (int i = 0; i < kTM; ++i) {
                            const float s = lane4(av[i], kk);
                            acc[i][0] = fmaf(s, wv.x, acc[i][0]);
                            acc[i][1] = fmaf(s, wv.y, acc[i][1]);
                            acc[i][2] = fmaf(s, wv.z, acc[i][2]);
                            acc[i][3] = fmaf(s, wv.w, acc[i][3]);
                        }
                    }
                }
            }
            __syncthreads();  // the next chunk refills xs and stage c & 1
        }

        const int n = n0 + cg * 4, yy = ty0 + ty;
        const float4 bv = *reinterpret_cast<const float4*>(bias + n);
        float cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
            const int xx = tx0 + xseg * kTM + i;
            if (yy < H && xx < W && n < Cst) {
                float4 v = make_float4(acc[i][0] + bv.x, acc[i][1] + bv.y, acc[i][2] + bv.z,
                                       acc[i][3] + bv.w);
                int oy = yy, ox = xx;
                if (FIRST) {
                    v = make_float4(gelu_erf(v.x), gelu_erf(v.y), gelu_erf(v.z), gelu_erf(v.w));
                } else {
                    cs[0] += v.x;
                    cs[1] += v.y;
                    cs[2] += v.z;
                    cs[3] += v.w;
                    if (shift) {
                        oy = yy >= shift ? yy - shift : yy - shift + H;
                        ox = xx >= shift ? xx - shift : xx - shift + W;
                    }
                }
                *reinterpret_cast<float4*>(out + (((size_t)bi * H + oy) * W + ox) * Cst + n) = v;
            }
        }
        if (!FIRST && part) {
#pragma unroll
            for (int j = 0; j < 4; ++j) red[rg * kNT + cg * 4 + j] = cs[j];
            __syncthreads();
            if (tid < kNT && n0 + tid < Cst) {
                float t = 0.f;
                for (int r = 0; r < 16; ++r) t += red[r * kNT + tid];
                part[((size_t)bi * nblk + blk) * Cst + n0 + tid] = t;
            }
        }
    }
}


}  // namespace
