// Window attention from pre-projected q, k, v, a hand-written f32 kernel for Hopper (sm_90a).
// (The attention with the qkv projection in front, DAT's B4 and the attention half of HAT's
// B8, is csrc/hab_attention.cu, on the tensor cores.)
//
// Replaces the TPU kernel freqfusion_tpu/ops/pallas/wattn.py:fused_window_attention_qkv
// (B13), and is the attention between the two row products of
// wattn.py:fused_window_attention (B14; csrc/hat_rows.cu's rows_linear projects before
// and after it). Per (hs, ws) window of N tokens and per head:
//     out = softmax(q k^T / sqrt(hd) + bias[head] (+ mask type of the window)) v
// on images that are whole windows. A zero-padded key is not masked: it scores its bias
// and takes part in the softmax, as in the TPU kernel.
//
// What bounds it on the H100. Per window and head 4*N*N*hd FLOPs plus the softmax for
// 4*N*hd floats: 7.9 MFLOP for 123 KB at N = 256, hd = 30, 64 FLOP per byte, above the f32
// ridge (20): bound by operations, though with no projection in front it is the closest of
// the attention kernels to the memory bound.
//
// Design, on CUDA cores in f32, for any N up to 576 (HAT's odd windows: 225 = 15 x 15,
// 81 = 9 x 9, neither a multiple of 32; DAT's padded tiles). One block owns one
// (window, head): its hd columns of k and v go to shared memory ([N][33] and [N][32]; a
// token's 30 of 90 channels are 120 contiguous bytes, read by one warp), q comes from
// device memory a row at a time. A warp owns 4 query rows, their q in one register a row
// (lane d holds q[d]) broadcast by shuffles; a lane scores keys lane, lane + 32, .. (rows of
// K at stride 33 fall on different banks) and adds the bias and mask rows straight from
// L2, the shift mask as its 4 window types [4][N][N]; a key past N scores -inf and a row
// past N is computed on a clamped index and not stored. The probabilities go through
// shared memory in chunks of 32*CJ keys.
// Two instantiations: up to 256 keys (8 score registers a row, two blocks an SM) and up to
// 576 (18 registers, one block an SM). q, k, v share a pixel stride `ld`, so that B14 can
// pass the three thirds of one [B,H,W,3C] projection.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kSlot = 32;                    // widest head
constexpr int kLd = kSlot + 1;               // row stride of k in shared memory
constexpr int kMaxN = 256, kKJ = kMaxN / 32; // keys per lane in the two-blocks-an-SM case
constexpr int kR = 4;                        // query rows a warp handles at a time

constexpr int kQkvMaxN = 576;
constexpr int kLdV = kSlot;  // row stride of v in shared memory

template <int KJ, int CJ>
__global__ void __launch_bounds__(kThreads, KJ <= 8 ? 2 : 1)
wattn_qkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ types, float* __restrict__ out, int H, int W,
                 int ld, int hs, int ws_, int heads, int hd, float scale) {
    extern __shared__ float4 smem4[];
    constexpr int kChunk = 32 * CJ, kWarps = kThreads / 32;
    const int N = hs * ws_;
    float* pws = reinterpret_cast<float*>(smem4);  // [warps][kChunk][kR] probabilities
    float* ks = pws + kWarps * kChunk * kR;         // [N][kLd]
    float* vs = ks + N * kLd;                       // [N][kLdV]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int head = blockIdx.x % heads;
    int win = blockIdx.x / heads;
    const int n_wc = W / ws_, n_wr = H / hs;
    const int bi = win / (n_wr * n_wc);
    win -= bi * n_wr * n_wc;
    const int wy = win / n_wc, wx = win % n_wc;
    const size_t img = (size_t)bi * H * W;
    const int col = head * hd + lane, co = heads * hd;
    auto pixel = [&](int t) {  // token t of the window -> its pixel's index in the batch
        return img + (size_t)(wy * hs + t / ws_) * W + wx * ws_ + t % ws_;
    };

    for (int key = warp; key < N; key += kWarps) {
        float kv = 0.f, vv = 0.f;
        if (lane < hd) {
            const size_t o = pixel(key) * ld + col;
            kv = k[o];
            vv = v[o];
        }
        ks[key * kLd + lane] = kv;
        vs[key * kLdV + lane] = vv;
    }
    __syncthreads();

    const int nkj = (N + 31) / 32;
    const int t_idx = types ? (wy == n_wr - 1 ? 2 : 0) + (wx == n_wc - 1 ? 1 : 0) : 0;
    const float* bias_h = bias + (size_t)head * N * N;
    const float* mask_t = types ? types + (size_t)t_idx * N * N : nullptr;
    float* pw = pws + warp * (kChunk * kR);
    for (int i0 = warp * kR; i0 < N; i0 += kWarps * kR) {
        float s[kR][KJ];
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
            for (int j = 0; j < KJ; ++j) s[r][j] = 0.f;
        float qreg[kR];  // lane d holds the scaled q[row][d]; a row past N repeats the last
#pragma unroll
        for (int r = 0; r < kR; ++r)
            qreg[r] = lane < hd ? q[pixel(min(i0 + r, N - 1)) * ld + col] * scale : 0.f;
        for (int d = 0; d < hd; ++d) {
            float qv[kR];
#pragma unroll
            for (int r = 0; r < kR; ++r) qv[r] = __shfl_sync(0xffffffffu, qreg[r], d);
#pragma unroll
            for (int j = 0; j < KJ; ++j)
                if (j < nkj) {
                    // past the last key: any key's value, dropped below
                    const float kv = ks[min(lane + 32 * j, N - 1) * kLd + d];
#pragma unroll
                    for (int r = 0; r < kR; ++r) s[r][j] = fmaf(qv[r], kv, s[r][j]);
                }
        }
        float inv[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
            const size_t row = (size_t)min(i0 + r, N - 1) * N;
            float m = -INFINITY;
#pragma unroll
            for (int j = 0; j < KJ; ++j)
                if (j < nkj) {
                    const int key = lane + 32 * j;
                    float t = -INFINITY;
                    if (key < N) {
                        t = s[r][j] + bias_h[row + key];
                        if (mask_t) t += mask_t[row + key];
                    }
                    s[r][j] = t;
                    m = fmaxf(m, t);
                }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < KJ; ++j)
                if (j < nkj) {
                    const float e = expf(s[r][j] - m);  // exp(-inf) = 0 past the last key
                    s[r][j] = e;
                    sum += e;
                }
            inv[r] = 1.f / warp_sum(sum);
        }
        float o[kR] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < KJ / CJ; ++c) {
            const int key0 = c * kChunk;
            if (key0 < N) {
                __syncwarp();  // the previous chunk's readers of pw are done
#pragma unroll
                for (int j = 0; j < CJ; ++j)
                    *reinterpret_cast<float4*>(pw + (lane + 32 * j) * kR) = make_float4(
                        s[0][c * CJ + j], s[1][c * CJ + j], s[2][c * CJ + j],
                        s[3][c * CJ + j]);
                __syncwarp();
                const int nkey = min(kChunk, N - key0);
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
            for (int r = 0; r < kR; ++r)
                if (i0 + r < N) out[pixel(i0 + r) * co + col] = o[r] * inv[r];
        }
    }
}

template <int KJ, int CJ>
cudaError_t launch_qkv(const float* q, const float* k, const float* v, const float* bias,
                       const float* types, float* out, int B, int H, int W, int ld, int hs,
                       int ws, int heads, int hd, cudaStream_t st) {
    static_assert(KJ % CJ == 0, "whole chunks of probabilities");
    const int N = hs * ws;
    const size_t smem =
        (size_t)((kThreads / 32) * 32 * CJ * kR + N * (kLd + kLdV)) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        wattn_qkv_kernel<KJ, CJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long nblocks = (long long)B * (H / hs) * (W / ws) * heads;
    if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    wattn_qkv_kernel<KJ, CJ><<<(unsigned)nblocks, kThreads, smem, st>>>(
        q, k, v, bias, types, out, H, W, ld, hs, ws, heads, hd, 1.f / sqrtf((float)hd));
    return cudaGetLastError();
}

}  // namespace

extern "C" int wattn_qkv(const float* q, const float* k, const float* v, const float* bias,
                         const float* types, float* out, int B, int H, int W, int ld, int hs,
                         int ws, int heads, int hd, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int N = hs * ws;
    if (hs < 1 || ws < 1 || N > kQkvMaxN || hd < 1 || hd > kSlot || heads < 1 ||
        ld < heads * hd || B < 1 || H % hs || W % ws)
        return cudaErrorInvalidValue;
    if (N <= kMaxN)
        return launch_qkv<kKJ, kKJ>(q, k, v, bias, types, out, B, H, W, ld, hs, ws, heads, hd,
                                    st);
    return launch_qkv<kQkvMaxN / 32, 6>(q, k, v, bias, types, out, B, H, W, ld, hs, ws, heads,
                                        hd, st);
}
