// The fused DAT block tail (residual + LayerNorm + Spatial-Gate FFN), f32-exact on Hopper's
// tensor cores (3xTF32, mma_f32x3.cuh; sm_90a), in two launches.
//
// Replaces the TPU kernel freqfusion_tpu/ops/pallas/sgfn.py:fused_sgfn_tail (B6):
//     y = a + shortcut
//     [x1, x2] = split(GELU(LN(y) @ w1 + b1))
//     out = y + (x1 * (dwconv3x3(LN_sg(x2)) + bdw)) @ w2 + b2
// The plain PyTorch version sits beside the wrapper in
// freqfusion_tpu_torch/ops/kernels/sgfn.py.
//
// What bounds it on the H100. Per pixel 2*(C*hid + hid/2*C) FLOPs of products (389 k at
// C = 180, hid = 720: 70.1 GFLOP at [1,352,512,180]) and about 19 k of the rest (LNs, GELU,
// the depthwise conv and the gate) for 12*C bytes of a, shortcut and out: the products bound
// it, at 0.43 ms on the tensor cores' 165 TFLOP/s of f32-exact products (1.10 ms all on the
// CUDA cores' 67); the bytes take 0.12 ms, and the hidden's round trip through device memory
// (below) about 0.3 ms more.
//
// Design. The TPU kernel keeps a whole row strip with its halo in VMEM. Here the sg
// LayerNorm needs all hid/2 channels of a halo pixel before the depthwise conv can start,
// more than a block's shared memory holds for a tile with its halo, so the function is
// split at its only spatial step:
//   1. fc1 is the row product of csrc/hat_rows.cu (rows_ln_fc1, the fc1 mode that B8's tail
//      and B10 use): y = a + shortcut parked in out, LN(y) staged in shared memory,
//      GELU(LN(y) @ w1 + b1) on tile_mma into the hidden [pixels][hid], then each warp
//      normalises its rows' second half in place (LN_sg).
//   2. sgfn_gate_fc2_kernel (this file): a block of 16 warps owns an 8 x 16 tile of
//      pixels; it computes gate = x1 * (dw3x3(LN_sg(x2)) + bdw) into tile_mma's A rows in
//      shared memory, reading the 3x3 halo of LN_sg(x2) from device memory (L2: the
//      neighbouring tiles read the same rows), zeros outside the image as the conv's SAME
//      padding (of LN_sg(x2), not of x2 or y: LN(0) * w + b != 0); then fc2 on tile_mma
//      with K = hid/2 taken in pieces (tile_mma_piece: 184 + 176 at 360, 94 KB of A with
//      128 KB of weight ring, one block an SM), the epilogue adding b2 to the parked y.
// Both products run on tile_mma: the weights are split into TF32 hi and lo parts on the host
// (ops/kernels/_mma.py), so only the activations are split in the kernel. The price of the
// split at the conv is device-memory traffic: the hidden is written and read once (plus
// LN_sg's pass over its second half), about 5.8 KB a pixel at hid = 720.
//
// Widths are padded to multiples of 8, the MMA's k and n (C = 180 -> 184; hid/2 = 360
// stays): the wrapper zero-pads the weights, the kernel zero-fills the padded columns of its
// tile and stores only real columns.
//
// Layout: NHWC, contiguous; out f32 or bf16 (bf16 products), the hidden and y f32;
// C % 4 == 0, hid/2 % 4 == 0; hid [B,H,W,hid] = x1 | x2n; wdw [9][hid/2].

#include "mma_f32x3.cuh"

namespace {

constexpr int kTH = 8, kTW = 16;   // a block's tile: kMmaRows pixels
static_assert(kTH * kTW == kMmaRows, "one tile_mma row a pixel");

// T: the storage type of out (f32, or bf16 with bf16 products); y (f32) holds y = a +
// shortcut from the first launch, then the pieces' sums (out itself for f32); the hidden is
// f32, and the gate is rounded to bf16 where its fragments are set, as the TPU kernel casts it.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads, 1)
sgfn_gate_fc2_kernel(const float* __restrict__ hid, const float* __restrict__ wdw,
                     const float* __restrict__ bdw, const float4* __restrict__ w2,
                     const float* __restrict__ b2, T* __restrict__ out, float* __restrict__ yb,
                     int H, int W, int C, int half, int K2p, int Np) {
    extern __shared__ float4 smem4[];
    const int Kt = tile_mma_piece(K2p);
    float* G = reinterpret_cast<float*>(smem4);  // [kMmaRows x Kt] the gate, A-fragment order
    float* ws = G + kMmaRows * Kt;                // tile_mma's weight ring
    const int tid = threadIdx.x;
    const int bi = blockIdx.z, ty0 = blockIdx.y * kTH, tx0 = blockIdx.x * kTW;
    const size_t img = (size_t)bi * H * W;
    const int hw = 2 * half;   // floats of a hidden row
    const float* x2n = hid + half;
    for (int k0 = 0; k0 < K2p; k0 += Kt) {
        const int kh = min(Kt, K2p - k0), ks = kh / 8, q4 = kh / 4;
        // the gate, written once every thread is past the previous piece's reads of G
        auto stage_g = [&] {
#pragma unroll 2
            for (int e = tid; e < kMmaRows * q4; e += kMmaThreads) {
                const int p = e / q4, c = k0 + (e % q4) * 4;
                const int y = ty0 + p / kTW, x = tx0 + p % kTW;
                float4 gt = make_float4(0.f, 0.f, 0.f, 0.f);
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
                                x2n + (img + (size_t)yy * W + xx) * hw + c);
                            const float4 w = *reinterpret_cast<const float4*>(
                                wdw + (dy * 3 + dx) * half + c);
                            acc.x = fmaf(t.x, w.x, acc.x);
                            acc.y = fmaf(t.y, w.y, acc.y);
                            acc.z = fmaf(t.z, w.z, acc.z);
                            acc.w = fmaf(t.w, w.w, acc.w);
                        }
                    }
                    const float4 u = *reinterpret_cast<const float4*>(
                        hid + (img + (size_t)y * W + x) * hw + c);
                    gt = make_float4(u.x * acc.x, u.y * acc.y, u.z * acc.z, u.w * acc.w);
                }
                // c + 1 .. c + 3 sit 4 floats apart
                const int i = a_frag_index(p, c - k0, ks);
                G[i] = gt.x;
                G[i + 4] = gt.y;
                G[i + 8] = gt.z;
                G[i + 12] = gt.w;
            }
        };
        const bool first = k0 == 0, last = k0 + kh == K2p;
        tile_mma<kPasses<T>>(G, kh, w2 + (size_t)(k0 / 8) * (Np / 8) * 32, Np / 8, Np, ws, stage_g,
                 [&](int p, int n, float u0, float u1) {   // columns n, n + 1 (n even)
                     const int y = ty0 + p / kTW, x = tx0 + p % kTW;
                     // yb holds y, then y + the earlier pieces; out takes the last sum
                     if (y < H && x < W && n < C) {
                         const size_t o = (img + (size_t)y * W + x) * C + n;
                         const float2 v = ld2(yb + o);
                         const float2 r =
                             first ? make_float2(v.x + (u0 + b2[n]), v.y + (u1 + b2[n + 1]))
                                   : make_float2(v.x + u0, v.y + u1);
                         if (last) st2(out + o, r);
                         else *reinterpret_cast<float2*>(yb + o) = r;
                     }
                 });
    }
}

}  // namespace

// out = y + (x1 * (dw3x3(x2n) + bdw)) @ w2 + b2, with y in out (rows_ln_fc1 parked it
// there), x1 | x2n = hid [B,H,W,2*half] and w2 = mma_planes of [K2p][Np].
// out f32, or bf16 where `bf16_io` is set; y the f32 scratch that rows_ln_fc1 parked y in
// (null for f32: out holds y).
extern "C" int sgfn_gate_fc2(const float* hid, const float* wdw, const float* bdw,
                             const float* w2, const float* b2, float* out, float* y, int B,
                             int H, int W, int C, int half, int K2p, int Np, int bf16_io,
                             void* stream) {
    if (C % 4 || half % 4 || K2p % 8 || Np % 8 || K2p < half || Np < C || B < 1 || H < 1 ||
        W < 1 || (bf16_io && !y))
        return cudaErrorInvalidValue;
    const size_t smem =
        (size_t)(kMmaRows * tile_mma_piece(K2p) + tile_mma_ws()) * sizeof(float);
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    const auto kernel =
        bf16_io ? reinterpret_cast<const void*>(sgfn_gate_fc2_kernel<bf16>)
                : reinterpret_cast<const void*>(sgfn_gate_fc2_kernel<float>);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bf16_io)
        sgfn_gate_fc2_kernel<bf16><<<grid, kMmaThreads, smem, st>>>(
            hid, wdw, bdw, reinterpret_cast<const float4*>(w2), b2,
            reinterpret_cast<bf16*>(out), y, H, W, C, half, K2p, Np);
    else
        sgfn_gate_fc2_kernel<float><<<grid, kMmaThreads, smem, st>>>(
            hid, wdw, bdw, reinterpret_cast<const float4*>(w2), b2, out, out, H, W, C, half,
            K2p, Np);
    return cudaGetLastError();
}
