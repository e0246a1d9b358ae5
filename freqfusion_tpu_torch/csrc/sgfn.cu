// The fused DAT block tail (residual + LayerNorm + Spatial-Gate FFN) as two hand-written
// f32 kernels for Hopper (sm_90a).
//
// Replaces the TPU kernel freqfusion_tpu/ops/pallas/sgfn.py:fused_sgfn_tail (B6):
//     y = a + shortcut
//     [x1, x2] = split(GELU(LN(y) @ w1 + b1))
//     out = y + (x1 * (dwconv3x3(LN_sg(x2)) + bdw)) @ w2 + b2
// The plain PyTorch version sits beside the wrapper in
// freqfusion_tpu_torch/ops/kernels/sgfn.py.
//
// What bounds it on the H100. Per pixel 2*(C*hid + hid/2*C) FLOPs (389 k at C = 180,
// hid = 720) for 12*C bytes of a, shortcut and out (2.2 KB): 180 FLOP per byte, far above
// the f32 CUDA-core ridge (20), so it is bound by operations, the two products.
//
// Why two kernels. The TPU kernel keeps a whole row strip with its halo in VMEM. Here the
// sg LayerNorm needs all hid/2 channels of a halo pixel before the depthwise conv can
// start: a 4 x 16 tile with its 6 x 18 halo would hold 108 x 360 floats of x2 (155 KB) and
// 64 x 360 of x1 (92 KB), more than the 227 KB a block may use. This first version splits
// at the only spatial step instead:
//   1. sgfn_fc1_kernel, pointwise, 64 pixels a block: LN(a + shortcut) in shared memory,
//      fc1 through tile_matmul's paired pass (x1 and x2 columns of one channel land in
//      one thread), GELU, x1 to device memory; GELU(x2) to device memory, and after a
//      barrier each warp normalises its pixels' rows there in place (LN_sg).
//   2. sgfn_gate_fc2_kernel, a 4 x 16 tile a block: gate = x1 * (dw3x3(LN_sg(x2)) + bdw)
//      into shared memory, zeros outside the image as the conv's SAME padding (of
//      LN_sg(x2), not of x2 or y: LN(0) * w + b != 0), fc2 through tile_matmul, and the
//      residual y = a + shortcut recomputed in the epilogue.
// No halo of fc1 is recomputed; the price is device-memory traffic: x1 and LN_sg(x2) are
// written and read once each, 4 * hid/2 * 4 bytes a pixel (5.8 KB at hid = 720) on top of
// the 2.2 KB + 1.4 KB (a and shortcut read twice) the function itself needs.
//
// DAT's widths (180, 360) fit neither K % 16 nor N % 64 of tile_matmul: the wrapper
// zero-pads w1 to [Kp][2*Hp] (each half on its own) and w2 to [K2p][Np] once, the kernels
// zero-fill the padded columns of their tiles and store only real columns.
//
// Layout: NHWC, f32, contiguous; C % 4 == 0, hid/2 % 4 == 0. wdw [9][hid/2].

#include "common.cuh"

namespace {

constexpr int kP = 64, kTM = kP / 16;   // pixels per block in both kernels
constexpr int kTH = 4, kTW = 16;        // the second kernel's tile
constexpr float kEps = 1e-5f;

__global__ void __launch_bounds__(kThreads)
sgfn_fc1_kernel(const float* __restrict__ a, const float* __restrict__ sc,
                const float* __restrict__ lnw, const float* __restrict__ lnb,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ sgw, const float* __restrict__ sgb,
                float* __restrict__ x1, float* x2n, long long npix, int C, int half, int Kp,
                int Hp) {
    extern __shared__ float4 smem4[];
    const int lda = Kp + 4;
    float* A = reinterpret_cast<float*>(smem4);  // [kP][lda] LN(a + shortcut)
    float* ws = A + kP * lda;                     // tile_matmul's weight stage
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long p0 = (long long)blockIdx.x * kP;

    for (int p = warp; p < kP; p += kThreads / 32) {
        const long long gp = p0 + p;
        float* row = A + p * lda;
        if (gp < npix) {
            for (int c = lane; c < C; c += 32) row[c] = a[gp * C + c] + sc[gp * C + c];
            // each lane normalises the entries it wrote itself
            warp_layernorm(row, row, lnw, lnb, C, kEps);
            for (int c = C + lane; c < Kp; c += 32) row[c] = 0.f;
        } else {
            for (int c = lane; c < Kp; c += 32) row[c] = 0.f;
        }
    }
    // tile_matmul synchronises before it reads A
    tile_matmul<kTM, true>(A, lda, Kp, w1, 2 * Hp, Hp, Hp, ws,
                           [&](int p, int n, float u, float v) {
                               const long long gp = p0 + p;
                               if (gp < npix && n < half) {
                                   x1[gp * half + n] = gelu_erf(u + b1[n]);
                                   x2n[gp * half + n] = gelu_erf(v + b1[Hp + n]);
                               }
                           });
    __syncthreads();  // the block's GELU(x2) rows are in device memory
    for (int p = warp; p < kP; p += kThreads / 32)
        if (p0 + p < npix)
            warp_layernorm(x2n + (p0 + p) * half, x2n + (p0 + p) * half, sgw, sgb, half, kEps);
}

__global__ void __launch_bounds__(kThreads)
sgfn_gate_fc2_kernel(const float* __restrict__ a, const float* __restrict__ sc,
                     const float* __restrict__ x1, const float* __restrict__ x2n,
                     const float* __restrict__ wdw, const float* __restrict__ bdw,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     float* __restrict__ out, int H, int W, int C, int half, int K2p, int Np) {
    extern __shared__ float4 smem4[];
    const int lda = K2p + 4;
    float* G = reinterpret_cast<float*>(smem4);  // [kP][lda] the gated hidden
    float* ws = G + kP * lda;
    const int tid = threadIdx.x;
    const int bi = blockIdx.z, ty0 = blockIdx.y * kTH, tx0 = blockIdx.x * kTW;
    const size_t img = (size_t)bi * H * W;
    const int q4 = K2p / 4;
    for (int e = tid; e < kP * q4; e += kThreads) {
        const int p = e / q4, c = (e % q4) * 4;
        const int y = ty0 + p / kTW, x = tx0 + p % kTW;
        float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
        if (y < H && x < W && c < half) {
            float4 acc = *reinterpret_cast<const float4*>(bdw + c);
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
                const int yy = y + dy - 1;
                if (yy < 0 || yy >= H) continue;
#pragma unroll
                for (int dx = 0; dx < 3; ++dx) {
                    const int xx = x + dx - 1;
                    if (xx < 0 || xx >= W) continue;
                    const float4 t = *reinterpret_cast<const float4*>(
                        x2n + (img + (size_t)yy * W + xx) * half + c);
                    const float4 w =
                        *reinterpret_cast<const float4*>(wdw + (dy * 3 + dx) * half + c);
                    acc.x = fmaf(t.x, w.x, acc.x);
                    acc.y = fmaf(t.y, w.y, acc.y);
                    acc.z = fmaf(t.z, w.z, acc.z);
                    acc.w = fmaf(t.w, w.w, acc.w);
                }
            }
            const float4 u =
                *reinterpret_cast<const float4*>(x1 + (img + (size_t)y * W + x) * half + c);
            g = make_float4(u.x * acc.x, u.y * acc.y, u.z * acc.z, u.w * acc.w);
        }
        *reinterpret_cast<float4*>(G + p * lda + c) = g;
    }
    // tile_matmul synchronises before it reads G
    tile_matmul<kTM, false>(G, lda, K2p, w2, Np, Np, 0, ws, [&](int p, int n, float u, float) {
        const int y = ty0 + p / kTW, x = tx0 + p % kTW;
        if (y < H && x < W && n < C) {
            const size_t o = (img + (size_t)y * W + x) * C + n;
            out[o] = a[o] + sc[o] + u + b2[n];
        }
    });
}

}  // namespace

extern "C" int sgfn_tail(const float* a, const float* sc, const float* lnw, const float* lnb,
                         const float* w1, const float* b1, const float* sgw, const float* sgb,
                         const float* wdw, const float* bdw, const float* w2, const float* b2,
                         float* x1, float* x2n, float* out, int B, int H, int W, int C,
                         int half, int Kp, int Hp, int K2p, int Np, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (C % 4 || half % 4 || Kp % kKC || Hp % 64 || K2p % kKC || Np % 64 || Kp < C ||
        Hp < half || K2p < half || Np < C)
        return cudaErrorInvalidValue;
    const size_t smem1 = (size_t)(kP * (Kp + 4) + tile_matmul_ws(true)) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        sgfn_fc1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    if (err != cudaSuccess) return err;
    const long long npix = (long long)B * H * W;
    sgfn_fc1_kernel<<<(unsigned)((npix + kP - 1) / kP), kThreads, smem1, st>>>(
        a, sc, lnw, lnb, w1, b1, sgw, sgb, x1, x2n, npix, C, half, Kp, Hp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t smem2 = (size_t)(kP * (K2p + 4) + tile_matmul_ws(false)) * sizeof(float);
    err = cudaFuncSetAttribute(sgfn_gate_fc2_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
    if (err != cudaSuccess) return err;
    dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
    sgfn_gate_fc2_kernel<<<grid, kThreads, smem2, st>>>(a, sc, x1, x2n, wdw, bdw, w2, b2, out,
                                                        H, W, C, half, K2p, Np);
    return cudaGetLastError();
}
