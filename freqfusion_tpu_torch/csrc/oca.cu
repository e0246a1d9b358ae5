// HAT's overlapping cross-attention (OCAB), a hand-written f32 kernel for Hopper (sm_90a).
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
// What bounds it on the H100. Per window and head 4 * nq * nk * hd FLOPs (17.7 M at
// ws = 16, 576 keys, hd = 30) plus the softmax, for about 2 * nq * hd + 2 * nk * hd floats
// (200 KB): far above the f32 ridge, bound by operations.
//
// Design. The TPU kernel assembles each key window from nine half-window views in VMEM, for
// all heads at once. Here one block of 16 warps owns one (window, head): the head's keys
// [nk][33] and values [nk][32] are loaded into shared memory once (zeros outside the image;
// 76 + 74 KB at 576 keys, so one block an SM, and 16 warps to keep it busy). A warp owns 4
// query rows at a time, their scaled q in one register a row (lane d holds q[d]) broadcast
// by shuffles. A lane scores keys lane, lane + 32, .. (18 of them at 576 keys), adds the
// bias row from L2, and the warp takes the softmax over all keys at once. The probabilities
// of the 4 rows then go through shared memory 192 keys at a time as [key][4] (3 KB a warp)
// and lane d adds p * v[key][d] over them. 199 KB in all. The six heads of a window are
// neighbouring blocks, so their keys come from L2.
//
// Layout: q, k, v, out [B,H,W,C] NHWC f32 with C = heads * hd; bias [heads][nq][nk].
// nq % 4 == 0, nk <= 576, hd <= 32, overlap even.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kOcaThreads = 512, kWarps = kOcaThreads / 32;
constexpr int kMaxNK = 576, kKJ = kMaxNK / 32;  // keys per lane at most
constexpr int kR = 4;                           // query rows a warp handles at a time
constexpr int kLdK = 33, kLdV = 32;             // row strides of k and v in shared memory
constexpr int kCJ = 6, kChunk = 32 * kCJ;       // keys whose probabilities are staged at once

__global__ void __launch_bounds__(kOcaThreads, 1)
oca_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias,
                float* __restrict__ out, int H, int W, int C, int ws, int ows, int heads,
                int hd, float scale) {
    extern __shared__ float4 smem4[];
    const int nq = ws * ws, nk = ows * ows, pad = (ows - ws) / 2;
    float* ks = reinterpret_cast<float*>(smem4);  // [nk][kLdK]
    float* vs = ks + nk * kLdK;                    // [nk][kLdV]
    float* pws = vs + nk * kLdV;                   // [warps][kChunk][kR] probabilities
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int head = blockIdx.x % heads;
    int win = blockIdx.x / heads;
    const int n_wc = W / ws, n_wr = H / ws;
    const int bi = win / (n_wr * n_wc);
    win -= bi * n_wr * n_wc;
    const int wy = win / n_wc, wx = win % n_wc;
    const size_t img = (size_t)bi * H * W;
    const int col = head * hd + lane;

    for (int key = warp; key < nk; key += kWarps) {
        const int yy = wy * ws - pad + key / ows, xx = wx * ws - pad + key % ows;
        float kv = 0.f, vv = 0.f;
        if (lane < hd && yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const size_t o = (img + (size_t)yy * W + xx) * C + col;
            kv = k[o];
            vv = v[o];
        }
        ks[key * kLdK + lane] = kv;
        vs[key * kLdV + lane] = vv;
    }
    __syncthreads();

    auto pixel = [&](int t) {  // query t of the window -> its pixel's offset in q and out
        return (img + (size_t)(wy * ws + t / ws) * W + wx * ws + t % ws) * C;
    };
    const int nkj = (nk + 31) / 32;
    const float* bias_h = bias + (size_t)head * nq * nk;
    float* pw = pws + warp * (kChunk * kR);
    for (int i0 = warp * kR; i0 < nq; i0 += kWarps * kR) {
        float s[kR][kKJ];
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
            for (int j = 0; j < kKJ; ++j) s[r][j] = 0.f;
        float qreg[kR];  // lane d holds the scaled q[row][d]
#pragma unroll
        for (int r = 0; r < kR; ++r)
            qreg[r] = lane < hd ? q[pixel(i0 + r) + col] * scale : 0.f;
        for (int d = 0; d < hd; ++d) {
            float qv[kR];
#pragma unroll
            for (int r = 0; r < kR; ++r) qv[r] = __shfl_sync(0xffffffffu, qreg[r], d);
#pragma unroll
            for (int j = 0; j < kKJ; ++j)
                if (j < nkj) {
                    // past the last key: any key's value, dropped below
                    const float kv = ks[min(lane + 32 * j, nk - 1) * kLdK + d];
#pragma unroll
                    for (int r = 0; r < kR; ++r) s[r][j] = fmaf(qv[r], kv, s[r][j]);
                }
        }
        float inv[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
            const size_t row = (size_t)(i0 + r) * nk;
            float m = -INFINITY;
#pragma unroll
            for (int j = 0; j < kKJ; ++j)
                if (j < nkj) {
                    const int key = lane + 32 * j;
                    const float t = key < nk ? s[r][j] + bias_h[row + key] : -INFINITY;
                    s[r][j] = t;
                    m = fmaxf(m, t);
                }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < kKJ; ++j)
                if (j < nkj) {
                    const float e = expf(s[r][j] - m);  // exp(-inf) = 0 past the last key
                    s[r][j] = e;
                    sum += e;
                }
            inv[r] = 1.f / warp_sum(sum);
        }
        float o[kR] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < kKJ / kCJ; ++c) {
            const int key0 = c * kChunk;
            if (key0 < nk) {
                __syncwarp();  // the previous chunk's readers of pw are done
#pragma unroll
                for (int j = 0; j < kCJ; ++j)
                    *reinterpret_cast<float4*>(pw + (lane + 32 * j) * kR) = make_float4(
                        s[0][c * kCJ + j], s[1][c * kCJ + j], s[2][c * kCJ + j],
                        s[3][c * kCJ + j]);   // zeros past the last key
                __syncwarp();
                const int nkey = min(kChunk, nk - key0);
                const float* vc = vs + key0 * kLdV + lane;
                for (int key = 0; key < nkey; ++key) {
                    const float4 p = *reinterpret_cast<const float4*>(pw + key * kR);
                    const float vv = vc[key * kLdV];
                    o[0] = fmaf(p.x, vv, o[0]);
                    o[1] = fmaf(p.y, vv, o[1]);
                    o[2] = fmaf(p.z, vv, o[2]);
                    o[3] = fmaf(p.w, vv, o[3]);
                }
            }
        }
        if (lane < hd) {
#pragma unroll
            for (int r = 0; r < kR; ++r) out[pixel(i0 + r) + col] = o[r] * inv[r];
        }
    }
}

}  // namespace

extern "C" int oca_attention(const float* q, const float* k, const float* v,
                             const float* bias, float* out, int B, int H, int W, int C, int ws,
                             int ows, int heads, int hd, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nq = ws * ws, nk = ows * ows;
    if (ws < 1 || ows < ws || (ows - ws) % 2 || nq % kR || nk > kMaxNK || nk < 32 || hd < 1 ||
        hd > 32 || heads * hd != C || H % ws || W % ws)
        return cudaErrorInvalidValue;
    static_assert(kR == 4, "the probabilities are stored as one float4 per key");
    static_assert(kKJ % kCJ == 0, "whole chunks of probabilities");
    const size_t smem =
        (size_t)(nk * (kLdK + kLdV) + kWarps * kChunk * kR) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        oca_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long nblocks = (long long)B * (H / ws) * (W / ws) * heads;
    if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    oca_attn_kernel<<<(unsigned)nblocks, kOcaThreads, smem, st>>>(
        q, k, v, bias, out, H, W, C, ws, ows, heads, hd, 1.f / sqrtf((float)hd));
    return cudaGetLastError();
}
