// NAFBlock as two hand-written f32 kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels freqfusion_tpu/ops/pallas/nafblock.py:naf_block_stage_a (B1) and
// :naf_block_stage_b (B2). The plain PyTorch versions sit beside the wrappers in
// freqfusion_tpu_torch/ops/kernels/nafblock.py.
//
// What bounds them on the H100. At the HR levels (C = 64 at 4x the LR size) the unfused
// block is memory-bound: it writes and re-reads some eight C- or 2C-wide tensors. Fused,
// stage A reads x once and writes g once, and stage B reads g and x once and writes the
// output once. What remains is the 1x1 convolutions: 2C^2 MACs per pixel in stage A and
// 4C^2 in stage B, here on CUDA cores in f32 (67 TFLOP/s peak), so both kernels are bound
// by FLOPs, not bytes. Tensor cores (bf16 operands, wgmma) are the lever for a later change.
//
// Stage A (B1): x -> LN -> 1x1 C->2C (+b1) -> 3x3 depthwise SAME (+bdw) -> SimpleGate -> g,
// plus per-image sums of g for the channel attention's global mean.
//   * A block owns a 4 x 16 output tile and normalises its 6 x 18 halo once into shared
//     memory (108 rows of C floats: 110 KB at C = 256, within the 227 KB a block may use).
//   * The 1x1 weights w1 (C x 2C, 512 KB at C = 256) do not fit in shared memory, as the TPU
//     kernel's VMEM design assumed. tile_matmul (common.cuh) streams them through a small
//     shared-memory stage, 64 gate channels (and their 64 partners) per pass.
//   * SAME padding zeroes the depthwise conv's input t (after the 1x1 conv), not x, because
//     LN(0) + bias != 0: a halo pixel outside the image stores t = 0.
//   * The TPU kernel carried the sum of g across its sequential grid. Hopper blocks run in
//     no order, so each block writes its partial sums [B, nblk, C] and a second small pass
//     adds them in a fixed order: the sums are the same from run to run (no atomics).
// Stage B (B2), pointwise: g*att -> 1x1 (+b3) -> y = x + beta*(.) -> LN2 -> 1x1 C->2C (+b4)
// -> SimpleGate -> 1x1 (+b5) -> y + gamma*(.). A block owns 64 pixels (32 at C = 256, so
// that two blocks fit an SM) and keeps two P x C intermediates in shared memory; y goes
// to the output buffer and is read back from L1/L2 by LN2 and the final residual. The
// weights (about 1 MB at C = 256) stream through tile_matmul's stage, so each is read
// from L2 once per block. att = mean(g) @ W_sca + b_sca is a [B,C]x[C,C] product computed
// by the caller between the two stages.
//
// Layout: NHWC, f32, contiguous. Weights: w1, w4 [C][2C]; w3, w5 [C][C]; wdw [9][2C].
// Requires C % 64 == 0 (the wrapper checks).

#include "common.cuh"

namespace {

constexpr int kTH = 4, kTW = 16;                  // stage A output tile
constexpr int kHH = kTH + 2, kHW = kTW + 2;       // its 3x3 halo
constexpr int kHP = kHH * kHW;                    // 108 halo pixels
constexpr int kHR = 112;                          // halo rows padded to 16 * 7
constexpr int kCJ = 64;                           // gate channels per pass
constexpr float kEps = 1e-6f;

// MINB blocks per SM: 2 where shared memory holds two (C = 64), which caps a thread at
// 128 registers; at C >= 128 one block fits and the cap would only add spills
template <int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
naf_stage_a_kernel(const float* __restrict__ x, const float* __restrict__ lnw,
                   const float* __restrict__ lnb, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ wdw,
                   const float* __restrict__ bdw, float* __restrict__ g,
                   float* __restrict__ part, int H, int W, int C) {
    extern __shared__ float4 smem4[];
    const int lda = C + 4;
    float* xn = reinterpret_cast<float*>(smem4);  // [kHR][lda]    LN(x) on the halo
    float* tb = xn + kHR * lda;                    // [kHR][2*kCJ]  t for one pass
    float* ws = tb + kHR * 2 * kCJ;                // tile_matmul's weight stage
    float* red = ws + tile_matmul_ws(true);        // [4][kCJ]      partial sums

    const int bi = blockIdx.z;
    const int ty0 = blockIdx.y * kTH, tx0 = blockIdx.x * kTW;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* xb = x + (size_t)bi * H * W * C;

    // the raw halo, one float4 per thread and step (zeros outside the image), then LN of
    // each live row in place: all loads are in flight together
    const int c4n = C / 4;
    for (int e = tid; e < kHR * c4n; e += kThreads) {
        const int p = e / c4n, c4 = (e % c4n) * 4;
        const int y = ty0 - 1 + p / kHW, xx = tx0 - 1 + p % kHW;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p < kHP && y >= 0 && y < H && xx >= 0 && xx < W)
            v = *reinterpret_cast<const float4*>(xb + ((size_t)y * W + xx) * C + c4);
        *reinterpret_cast<float4*>(xn + p * lda + c4) = v;
    }
    __syncthreads();
    for (int p = warp; p < kHP; p += kThreads / 32) {
        const int y = ty0 - 1 + p / kHW, xx = tx0 - 1 + p % kHW;
        if (y >= 0 && y < H && xx >= 0 && xx < W)
            warp_layernorm(xn + p * lda, xn + p * lda, lnw, lnb, C, kEps);
    }
    // tile_matmul synchronises before it reads xn

    const int nblk = gridDim.x * gridDim.y;
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    for (int cb = 0; cb < C; cb += kCJ) {
        // t = LN(x) @ w1 + b1 on the halo, for gate channels cb.. and C+cb..
        tile_matmul<kHR / 16, true>(
            xn, lda, C, w1 + cb, 2 * C, kCJ, C, ws, [&](int p, int n, float a, float b) {
                const int y = ty0 - 1 + p / kHW, xx = tx0 - 1 + p % kHW;
                const bool live = p < kHP && y >= 0 && y < H && xx >= 0 && xx < W;
                tb[p * 2 * kCJ + n] = live ? a + b1[cb + n] : 0.f;
                tb[p * 2 * kCJ + kCJ + n] = live ? b + b1[C + cb + n] : 0.f;
            });
        __syncthreads();

        const int j = tid & (kCJ - 1), q = tid / kCJ;  // gate channel cb + j; pixel group q
        float wa[9], wb[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
            wa[k] = wdw[k * 2 * C + cb + j];
            wb[k] = wdw[k * 2 * C + C + cb + j];
        }
        const float ba = bdw[cb + j], bb = bdw[C + cb + j];
        float psum = 0.f;
        for (int op = q; op < kTH * kTW; op += kThreads / kCJ) {
            const int oy = op / kTW, ox = op % kTW;
            float a = 0.f, b = 0.f;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                for (int dx = 0; dx < 3; ++dx) {
                    const float* tp = tb + ((oy + dy) * kHW + ox + dx) * 2 * kCJ;
                    a = fmaf(tp[j], wa[dy * 3 + dx], a);
                    b = fmaf(tp[kCJ + j], wb[dy * 3 + dx], b);
                }
            const float gv = (a + ba) * (b + bb);
            const int y = ty0 + oy, xx = tx0 + ox;
            if (y < H && xx < W) {
                g[(((size_t)bi * H + y) * W + xx) * C + cb + j] = gv;
                psum += gv;
            }
        }
        red[q * kCJ + j] = psum;
        __syncthreads();
        if (tid < kCJ) {
            float s = 0.f;
            for (int r = 0; r < kThreads / kCJ; ++r) s += red[r * kCJ + tid];
            part[((size_t)bi * nblk + blk) * C + cb + tid] = s;
        }
        // the next pass's tile_matmul synchronises before it writes tb or red
    }
}

// Stage B for blocks of 16 * TM pixels.
template <int TM>
__global__ void __launch_bounds__(kThreads)
naf_stage_b_kernel(const float* __restrict__ g, const float* __restrict__ x,
                   const float* __restrict__ att, const float* __restrict__ w3,
                   const float* __restrict__ b3, const float* __restrict__ beta,
                   const float* __restrict__ ln2w, const float* __restrict__ ln2b,
                   const float* __restrict__ w4, const float* __restrict__ b4,
                   const float* __restrict__ w5, const float* __restrict__ b5,
                   const float* __restrict__ gamma, float* __restrict__ out,
                   long long npix, int hw, int C) {
    constexpr int P = 16 * TM;
    extern __shared__ float4 smem4[];
    const int lda = C + 4;
    float* s0 = reinterpret_cast<float*>(smem4);  // [P][lda] g*att, then LN2(y)
    float* sh = s0 + P * lda;                      // [P][lda] gated FFN hidden
    float* ws = sh + P * lda;                      // tile_matmul's weight stage
    const long long p0 = (long long)blockIdx.x * P;

    const int c4n = C / 4;
    for (int e = threadIdx.x; e < P * c4n; e += kThreads) {
        const int p = e / c4n, c4 = (e % c4n) * 4;
        const long long gp = p0 + p;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gp < npix) {
            const float4 gv = *reinterpret_cast<const float4*>(g + gp * C + c4);
            const float4 av = *reinterpret_cast<const float4*>(att + (gp / hw) * C + c4);
            v = make_float4(gv.x * av.x, gv.y * av.y, gv.z * av.z, gv.w * av.w);
        }
        *reinterpret_cast<float4*>(s0 + p * lda + c4) = v;
    }
    // y goes to `out` (device memory, the block's own rows): it is read back by LN2 after
    // a barrier and by the last epilogue, whose thread for (p, n) is the one that wrote it
    tile_matmul<TM, false>(s0, lda, C, w3, C, C, 0, ws, [&](int p, int n, float a, float) {
        const long long gp = p0 + p;
        if (gp < npix) out[gp * C + n] = x[gp * C + n] + (a + b3[n]) * beta[n];
    });
    __syncthreads();
    for (int p = threadIdx.x >> 5; p < P; p += kThreads / 32)
        if (p0 + p < npix) warp_layernorm(out + (p0 + p) * C, s0 + p * lda, ln2w, ln2b, C, kEps);
    tile_matmul<TM, true>(s0, lda, C, w4, 2 * C, C, C, ws,
                          [&](int p, int n, float a, float b) {
                              sh[p * lda + n] = (a + b4[n]) * (b + b4[C + n]);
                          });
    tile_matmul<TM, false>(sh, lda, C, w5, C, C, 0, ws, [&](int p, int n, float a, float) {
        const long long gp = p0 + p;
        if (gp < npix) out[gp * C + n] += (a + b5[n]) * gamma[n];
    });
}

template <int TM>
cudaError_t launch_stage_b(const float* g, const float* x, const float* att, const float* w3,
                           const float* b3, const float* beta, const float* ln2w,
                           const float* ln2b, const float* w4, const float* b4,
                           const float* w5, const float* b5, const float* gamma, float* out,
                           int B, int H, int W, int C, cudaStream_t st) {
    constexpr int P = 16 * TM;
    const size_t smem = (size_t)(2 * P * (C + 4) + tile_matmul_ws(true)) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        naf_stage_b_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long npix = (long long)B * H * W;
    const unsigned nblocks = (unsigned)((npix + P - 1) / P);
    naf_stage_b_kernel<TM><<<nblocks, kThreads, smem, st>>>(
        g, x, att, w3, b3, beta, ln2w, ln2b, w4, b4, w5, b5, gamma, out, npix, H * W, C);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of stage-A blocks per image: the length of the partial-sum scratch's middle axis.
int naf_stage_a_blocks(int H, int W) {
    return ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
}

int naf_stage_a(const float* x, const float* lnw, const float* lnb, const float* w1,
                const float* b1, const float* wdw, const float* bdw, float* g, float* part,
                float* sums, int B, int H, int W, int C, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = (size_t)(kHR * (C + 4) + kHR * 2 * kCJ + tile_matmul_ws(true) +
                                 4 * kCJ) * sizeof(float);
    auto kernel = C <= 64 ? naf_stage_a_kernel<2> : naf_stage_a_kernel<1>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
    kernel<<<grid, kThreads, smem, st>>>(x, lnw, lnb, w1, b1, wdw, bdw, g, part, H, W, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return sum_partials(part, sums, B, naf_stage_a_blocks(H, W), C, st);
}

int naf_stage_b(const float* g, const float* x, const float* att, const float* w3,
                const float* b3, const float* beta, const float* ln2w, const float* ln2b,
                const float* w4, const float* b4, const float* w5, const float* b5,
                const float* gamma, float* out, int B, int H, int W, int C, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // 64-pixel blocks up to C = 128; 32 at C = 256 keeps two blocks in an SM's smem
    if (C <= 128)
        return launch_stage_b<4>(g, x, att, w3, b3, beta, ln2w, ln2b, w4, b4, w5, b5, gamma,
                                 out, B, H, W, C, st);
    return launch_stage_b<2>(g, x, att, w3, b3, beta, ln2w, ln2b, w4, b4, w5, b5, gamma, out,
                             B, H, W, C, st);
}

}  // extern "C"
