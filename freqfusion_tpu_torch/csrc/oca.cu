// HAT's overlapping cross-attention (OCAB), f32-exact on Hopper's tensor cores (3xTF32,
// mma_f32x3.cuh), hand-written for Hopper (sm_90a).
//
// Replaces the attention inside the TPU kernel
// freqfusion_tpu/ops/pallas/wattn.py:fused_overlap_attention (B9); its output projection
// is rows_linear in csrc/hat_rows.cu. Per ws x ws window of queries and per head (dim hd):
//     out = softmax(q k^T / sqrt(hd) + bias[head]) v
// over the (ws + overlap)^2 keys and values of the window grown by overlap/2 on each side.
// k and v are zero outside the image: such a key is not masked, it scores its bias alone
// and adds nothing to the sum, as zero-padding after the projection gives it. The plain
// PyTorch version sits beside the wrapper in freqfusion_tpu_torch/ops/kernels/wattn.py.
//
// What bounds it on the H100. Per window and head 4 * nq * nk * hd FLOPs of products
// (17.7 M at ws = 16, 576 keys, hd = 30; 74.7 GFLOP at [1,352,512,180], 4224 (window,
// head) pairs) and nq * nk exponentials, for about 2 * nq * hd + 2 * nk * hd floats and the
// bias row: bound by the products, 0.45 ms on the tensor cores' 165 TFLOP/s of f32-exact
// products (1.1 ms all on the CUDA cores' 67). The bias [heads][nq][nk] (3.5 MB at HAT-L)
// stays in L2; each block reads its head's 590 KB of it once.
//
// Design: hab_attention.cu's loop (B8) with all of a window's keys.
//   * One block of 16 warps owns one (window, head). The head's keys and values, zero-padded
//     to 32 dims (and to a multiple of 32 keys), are staged in shared memory at a row stride
//     of 36 floats (4 mod 8: the K fragments of QK^T and the V fragments of PV hit 32 banks):
//     166 KB at 576 keys, so one block an SM, and 16 warps to fill it. A warp stages a key
//     a step (lane d its dim d), so a head's odd start (head * 120 bytes) needs no alignment.
//   * A warp owns 16 query rows (an m-tile) at a time. Its q fragments (4 k-steps over the
//     32 padded dims), scaled by 1/sqrt(hd) as the plain version scales q, are read straight
//     from device memory and split into TF32 hi and lo once, then kept in registers.
//   * QK^T in 3xTF32 `mma.sync` over key chunks of 32 (four n-tiles, four k-steps), with an
//     online softmax across the chunks (FlashAttention-2's loop): the chunk's bias, read in
//     f32 from L2, is added before the max, keys past the last are -inf, exp is the exact
//     expf. A thread holds 16 scores.
//   * PV straight from the score registers, with no shuffle: the accumulator's c0/c1 hold
//     keys 2t and 2t+1 of an n-tile where the A operand's a0/a2 hold k-positions t and t+4,
//     so PV takes k-position t as key 2t and t+4 as key 2t+1, for P and for V's rows alike
//     (a sum over keys does not care about their order). Each chunk's PV goes into a fresh
//     register tile, added to the rescaled running sum in f32 (the tensor core's adds round
//     toward zero; a short chain keeps that at f32 level).
// The six heads of a window are neighbouring blocks, so their keys come from L2.
//
// Layout: q, k, v, out [B,H,W,C] NHWC f32 with C = heads * hd; bias [heads][nq][nk].
// nq % 4 == 0, 32 <= nk <= 576, hd <= 32, overlap even.

#include <cmath>

#include "mma_f32x3.cuh"

namespace {

constexpr int kOcaThreads = 512, kWarps = kOcaThreads / 32;
constexpr int kMaxNK = 576;
constexpr int kSlot = 32, kLd = kSlot + 4;   // a key's padded dims, its row stride: 4 mod 8
constexpr int kKeys = 32;                    // keys an online-softmax step

__global__ void __launch_bounds__(kOcaThreads, 1)
oca_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias,
                float* __restrict__ out, int H, int W, int C, int ws, int ows, int heads,
                int hd, float scale) {
    extern __shared__ float4 smem4[];
    const int nq = ws * ws, nk = ows * ows, nkp = (nk + kKeys - 1) / kKeys * kKeys;
    const int pad = (ows - ws) / 2;
    float* ks = reinterpret_cast<float*>(smem4);  // [nkp][kLd]
    float* vs = ks + nkp * kLd;                    // [nkp][kLd]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int head = blockIdx.x % heads;
    int win = blockIdx.x / heads;
    const int n_wc = W / ws, n_wr = H / ws;
    const int bi = win / (n_wr * n_wc);
    win -= bi * n_wr * n_wc;
    const int wy = win / n_wc, wx = win % n_wc;
    const size_t img = (size_t)bi * H * W;
    const int col = head * hd;

    for (int key = warp; key < nkp; key += kWarps) {
        const int yy = wy * ws - pad + key / ows, xx = wx * ws - pad + key % ows;
        float kv = 0.f, vv = 0.f;
        if (key < nk && lane < hd && yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const size_t o = (img + (size_t)yy * W + xx) * C + col + lane;
            kv = k[o];
            vv = v[o];
        }
        ks[key * kLd + lane] = kv;
        vs[key * kLd + lane] = vv;
    }
    __syncthreads();

    auto pixel = [&](int r) {  // query r of the window -> its pixel's offset in q and out
        return (img + (size_t)(wy * ws + r / ws) * W + wx * ws + r % ws) * C + col;
    };
    const float* bias_h = bias + (size_t)head * nq * nk;
    for (int i0 = 16 * warp; i0 < nq; i0 += 16 * kWarps) {
        const int ra = i0 + g, rb = ra + 8;
        const bool va = ra < nq, vb = rb < nq;
        const size_t pa = pixel(va ? ra : 0), pb = pixel(vb ? rb : 0);
        FragA qa[4];   // q of rows ra, rb over dims 8 kq + t, + 4; zero past hd and nq
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
            const int d0 = 8 * kq + t, d1 = d0 + 4;
            qa[kq].set(0, va && d0 < hd ? q[pa + d0] * scale : 0.f);
            qa[kq].set(1, vb && d0 < hd ? q[pb + d0] * scale : 0.f);
            qa[kq].set(2, va && d1 < hd ? q[pa + d1] * scale : 0.f);
            qa[kq].set(3, vb && d1 < hd ? q[pb + d1] * scale : 0.f);
        }
        // bias rows of ra and rb (a row past nq reads row 0's; its result is dropped)
        const float* ba_row = bias_h + (size_t)(va ? ra : 0) * nk;
        const float* bb_row = bias_h + (size_t)(vb ? rb : 0) * nk;
        float o[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
        float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
        for (int kc0 = 0; kc0 < nk; kc0 += kKeys) {
            float s[kKeys / 8][4];
#pragma unroll
            for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
            for (int kq = 0; kq < 4; ++kq)
#pragma unroll
                for (int j = 0; j < kKeys / 8; ++j) {
                    FragB b;
                    load_b_nk(b, ks, kLd, 8 * kq, kc0 + 8 * j);
                    mma_f32x3(s[j], qa[kq], b);
                }
            float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
            for (int j = 0; j < kKeys / 8; ++j) {
                const int key = kc0 + 8 * j + 2 * t;   // even, and nk is even
                if (key < nk) {
                    const float2 ba = *reinterpret_cast<const float2*>(ba_row + key);
                    const float2 bb = *reinterpret_cast<const float2*>(bb_row + key);
                    s[j][0] += ba.x;
                    s[j][1] += ba.y;
                    s[j][2] += bb.x;
                    s[j][3] += bb.y;
                } else {
                    s[j][0] = s[j][1] = s[j][2] = s[j][3] = -INFINITY;
                }
                c0 = fmaxf(c0, fmaxf(s[j][0], s[j][1]));
                c1 = fmaxf(c1, fmaxf(s[j][2], s[j][3]));
            }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
                c0 = fmaxf(c0, __shfl_xor_sync(0xffffffffu, c0, off));
                c1 = fmaxf(c1, __shfl_xor_sync(0xffffffffu, c1, off));
            }
            const float n0 = fmaxf(m0, c0), n1 = fmaxf(m1, c1);
            const float al0 = expf(m0 - n0), al1 = expf(m1 - n1);  // 0 at the first chunk
            m0 = n0;
            m1 = n1;
            l0 *= al0;
            l1 *= al1;
#pragma unroll
            for (int j = 0; j < kKeys / 8; ++j) {
                s[j][0] = expf(s[j][0] - n0);   // 0 past the last key
                s[j][1] = expf(s[j][1] - n0);
                s[j][2] = expf(s[j][2] - n1);
                s[j][3] = expf(s[j][3] - n1);
                l0 += s[j][0] + s[j][1];
                l1 += s[j][2] + s[j][3];
            }
            // P V, k-step j over keys kc0 + 8 j ..: k-position t is key 2t, t + 4 is 2t + 1;
            // the chunk's sum in a fresh tile, added to the rescaled running one in f32
            float pv[4][4];
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
            for (int j = 0; j < kKeys / 8; ++j) {
                FragA p;
                p.set(0, s[j][0]);
                p.set(1, s[j][2]);
                p.set(2, s[j][1]);
                p.set(3, s[j][3]);
                const float* v0 = vs + (size_t)(kc0 + 8 * j + 2 * t) * kLd + g;
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                    FragB b;
                    b.set(0, v0[8 * n]);
                    b.set(1, v0[kLd + 8 * n]);
                    mma_f32x3(pv[n], p, b);
                }
            }
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                o[n][0] = fmaf(o[n][0], al0, pv[n][0]);
                o[n][1] = fmaf(o[n][1], al0, pv[n][1]);
                o[n][2] = fmaf(o[n][2], al1, pv[n][2]);
                o[n][3] = fmaf(o[n][3], al1, pv[n][3]);
            }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            l0 += __shfl_xor_sync(0xffffffffu, l0, off);
            l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        }
        const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int d = 8 * n + 2 * t + e;
                if (d < hd) {
                    if (va) out[pa + d] = o[n][e] * inv0;
                    if (vb) out[pb + d] = o[n][2 + e] * inv1;
                }
            }
    }
}

}  // namespace

extern "C" int oca_attention(const float* q, const float* k, const float* v,
                             const float* bias, float* out, int B, int H, int W, int C, int ws,
                             int ows, int heads, int hd, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nq = ws * ws, nk = ows * ows;
    if (ws < 1 || ows < ws || (ows - ws) % 2 || nq % 4 || nk % 2 || nk > kMaxNK || nk < 32 ||
        hd < 1 || hd > kSlot || heads * hd != C || H % ws || W % ws)
        return cudaErrorInvalidValue;
    const int nkp = (nk + kKeys - 1) / kKeys * kKeys;
    const size_t smem = (size_t)(2 * nkp * kLd) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        oca_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long nblocks = (long long)B * (H / ws) * (W / ws) * heads;
    if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    oca_attn_kernel<<<(unsigned)nblocks, kOcaThreads, smem, st>>>(
        q, k, v, bias, out, H, W, C, ws, ows, heads, hd, 1.f / sqrtf((float)hd));
    return cudaGetLastError();
}
