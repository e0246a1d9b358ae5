// Window attention with the qkv projection fused in, a hand-written f32 kernel for Hopper
// (sm_90a), in two instantiations: DAT's rectangular-window attention, and the attention
// half of HAT's fused HAB block (LayerNorm in front, the shifted window read in place).
//
// Replaces the TPU kernel freqfusion_tpu/ops/pallas/wattn.py:fused_window_attention_xqkv
// (B4), and computes the first half of wattn.py:fused_hab_block (B8; its second half, the
// projection, the residuals and the MLP, is csrc/hat_rows.cu). Per window of N = hs*ws
// tokens and per head (dim hd):
//     [q, k, v] = x_window @ W_head + b_head
//     out = softmax(q k^T / sqrt(hd) + bias[head] (+ mask type of the window)) v
// and `out` is the attended image [B,H,W,heads*hd] before any output projection. The plain
// PyTorch version sits beside the wrapper in freqfusion_tpu_torch/ops/kernels/wattn.py.
//
// What bounds it on the H100. Per window the function reads N*Cin floats of x and writes
// N*heads*hd, and does 2*N*Cin*3*heads*hd FLOPs of projection plus 4*N*N*hd per head of
// attention: at DAT's shapes (N = 256, Cin = 180, 3 heads of 30) 48 MFLOP for 276 KB, 175
// FLOP per byte, far above the f32 CUDA-core ridge (20). It is bound by operations. What
// must stay out of device memory is q, k, v and the N x N scores, as on the TPU.
//
// Design. The TPU kernel holds a stack of windows, all heads and the whole bias in VMEM
// (x tile 184 KB, qkv 276 KB, scores 262 KB a head, bias 786 KB): none of that fits the
// 227 KB of a block. Here one block owns one (window, head), and two blocks fit an SM
// (106 KB of shared memory each at N = 256, Cin = 180):
//   * projection: the window's x rows go through shared memory 64 at a time, in two
//     halves of K (the second half's epilogue adds to the first's), and through
//     tile_matmul (common.cuh) against the head's own weight slab [Kp][128] = q | k | v |
//     zeros in 32-column slots, which the wrapper builds once (zero rows Cin..Kp, zero
//     columns hd..32: padded zeros change nothing). k and v of the head stay in shared
//     memory, [N][33] each, 66 KB at N = 256. The scaled q rows are parked in the output
//     buffer, each token's own hd floats of this head: the warp that later overwrites
//     them with the result reads them back first;
//   * attention: a warp owns 4 query rows at a time, their q in one register per row
//     (lane d holds q[d]) broadcast by shuffles. A lane scores keys lane, lane+32, ..
//     (rows of K at stride 33 fall on different banks), adds the bias row and the mask row
//     straight from L2, and the warp takes the softmax over all N keys at once (no online
//     softmax is needed at N <= 256). The probabilities of the 4 rows go to shared memory
//     as [key][4], and lane d adds p * v[key][d] over the keys;
//   * the shift mask comes as its 4 window types (interior, last column, last row, corner)
//     [4][N][N]; the block picks its type from the window's position. The caller rolls
//     the image; nothing here shifts.
// The heads of a window are neighbouring blocks, so x is read from device memory once and
// again from L2.
//
// The HAB instantiation (template flag) differs in its loads only. The projection's input
// is LN1(x): a warp takes each row's mean and 1/std once per 64-row pass, the staging
// applies them with the affine, so every head repeats the LayerNorm (10 FLOPs an element
// against the projection's 256) instead of a normalised copy going through device memory.
// With in_shift = s the image is not rolled by the caller: token (r, c) of window (i, j)
// reads x[(i*hs + r + s) % H][(j*ws + c + s) % W], and the attended image is written at
// (i*hs + r, j*ws + c), in rolled coordinates. The six heads' outputs go to device memory
// (720 bytes a pixel written, then read by the row kernel that needs them together).
//
// Layout: x [B,H,W,Cin] NHWC f32; wh [heads][Kp][128]; bh [heads][128]; bias [heads][N][N];
// types [4][N][N] or null; out [B,H,W,heads*hd]. N % 64 == 0, N <= 256, hd <= 32,
// Cin % 4 == 0, Kp % 16 == 0.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kRows = 64, kTM = kRows / 16;  // x rows projected per pass
constexpr int kSlot = 32, kCols = 4 * kSlot; // q | k | v | zeros
constexpr int kLd = kSlot + 1;               // row stride of q, k, v in shared memory
constexpr int kMaxN = 256, kKJ = kMaxN / 32; // keys per lane at most
constexpr int kR = 4;                        // query rows a warp handles at a time

// HAB: x is normalised (lnw, lnb, eps 1e-5) on load and read at (+shift, +shift), wrapping.
template <bool HAB>
__global__ void __launch_bounds__(kThreads, 2)
wattn_xqkv_kernel(const float* __restrict__ x, const float* __restrict__ wh,
                  const float* __restrict__ bh, const float* __restrict__ bias,
                  const float* __restrict__ types, float* __restrict__ out,
                  const float* __restrict__ lnw, const float* __restrict__ lnb, int H, int W,
                  int Cin, int Kp, int hs, int ws_, int heads, int hd, float scale,
                  int shift) {
    extern __shared__ float4 smem4[];
    const int N = hs * ws_, K1 = first_half(Kp), lda = K1 + 4;
    float* ks = reinterpret_cast<float*>(smem4);  // [N][kLd]
    float* vs = ks + N * kLd;
    float* stage = vs + N * kLd;                   // tile_matmul's weight stage
    float* xa = stage + tile_matmul_ws(false);     // [kRows][lda] x rows; then probabilities
    // HAB: [kRows][2] mean and 1/std of the pass's rows, after the larger use of xa
    float* lnst = xa + max(kRows * lda, (kThreads / 32) * kMaxN * kR);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int head = blockIdx.x % heads;
    int win = blockIdx.x / heads;
    const int n_wc = W / ws_, n_wr = H / hs;
    const int bi = win / (n_wr * n_wc);
    win -= bi * n_wr * n_wc;
    const int wy = win / n_wc, wx = win % n_wc;
    const float* xb = x + (size_t)bi * H * W * Cin;
    const float* whh = wh + (size_t)head * Kp * kCols;
    const float* bhh = bh + head * kCols;

    const int co = heads * hd;
    float* oh = out + (size_t)bi * H * W * co + head * hd;  // this head's columns
    auto pixel = [&](int t) {  // token t of the window -> its pixel's offset in `out`
        return ((size_t)(wy * hs + t / ws_) * W + wx * ws_ + t % ws_) * co;
    };
    auto src_row = [&](int t) {  // token t of the window -> its pixel's row of x
        int y = wy * hs + t / ws_, xx = wx * ws_ + t % ws_;
        if (HAB) {
            y += shift;
            xx += shift;
            if (y >= H) y -= H;
            if (xx >= W) xx -= W;
        }
        return xb + ((size_t)y * W + xx) * Cin;
    };
    for (int r0 = 0; r0 < N; r0 += kRows) {
        if (HAB) {
            // the previous pass's readers of lnst are past tile_matmul's last barrier
            for (int r = warp; r < kRows; r += kThreads / 32) {
                float u, inv;
                warp_ln_stats(src_row(r0 + r), Cin, 1e-5f, u, inv);
                if (lane == 0) {
                    lnst[2 * r] = u;
                    lnst[2 * r + 1] = inv;
                }
            }
            __syncthreads();
        }
        for (int k0 = 0; k0 < Kp; k0 += K1) {
            const int kh = min(K1, Kp - k0), k4 = kh / 4;
            const bool first = k0 == 0, last = k0 + kh == Kp;
            // the previous pass's readers of xa are past tile_matmul's last barrier
            for (int e = tid; e < kRows * k4; e += kThreads) {
                const int r = e / k4, c = (e % k4) * 4;
                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                if (k0 + c < Cin) {
                    v = *reinterpret_cast<const float4*>(src_row(r0 + r) + k0 + c);
                    if (HAB) {
                        const float u = lnst[2 * r], inv = lnst[2 * r + 1];
                        const float4 lw = *reinterpret_cast<const float4*>(lnw + k0 + c);
                        const float4 lb = *reinterpret_cast<const float4*>(lnb + k0 + c);
                        v.x = (v.x - u) * inv * lw.x + lb.x;
                        v.y = (v.y - u) * inv * lw.y + lb.y;
                        v.z = (v.z - u) * inv * lw.z + lb.z;
                        v.w = (v.w - u) * inv * lw.w + lb.w;
                    }
                }
                *reinterpret_cast<float4*>(xa + r * lda + c) = v;
            }
            tile_matmul<kTM, false>(
                xa, lda, kh, whh + (size_t)k0 * kCols, kCols, kCols, 0, stage,
                [&](int p, int n, float a, float) {
                    const int slot = n / kSlot, d = n % kSlot;
                    if (slot == 0) {
                        if (d < hd) {
                            float* dst = oh + pixel(r0 + p) + d;
                            const float val = a + (first ? bhh[n] : dst[0]);
                            dst[0] = last ? val * scale : val;
                        }
                    } else if (slot < 3) {
                        float* dst = (slot == 1 ? ks : vs) + (r0 + p) * kLd + d;
                        dst[0] = a + (first ? bhh[n] : dst[0]);
                    }
                });
        }
    }
    __syncthreads();  // k, v and the parked q complete; xa is free for the probabilities

    const int nkj = N / 32;
    const int t_idx = types ? (wy == n_wr - 1 ? 2 : 0) + (wx == n_wc - 1 ? 1 : 0) : 0;
    const float* bias_h = bias + (size_t)head * N * N;
    const float* mask_t = types ? types + (size_t)t_idx * N * N : nullptr;
    float* pw = xa + warp * (kMaxN * kR);          // this warp's [N][kR] probabilities
    for (int i0 = warp * kR; i0 < N; i0 += (kThreads / 32) * kR) {
        float s[kR][kKJ];
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
            for (int j = 0; j < kKJ; ++j) s[r][j] = 0.f;
        float qreg[kR];  // lane d holds q[row][d]
#pragma unroll
        for (int r = 0; r < kR; ++r) qreg[r] = lane < hd ? oh[pixel(i0 + r) + lane] : 0.f;
        for (int d = 0; d < hd; ++d) {
            float qv[kR];
#pragma unroll
            for (int r = 0; r < kR; ++r) qv[r] = __shfl_sync(0xffffffffu, qreg[r], d);
#pragma unroll
            for (int j = 0; j < kKJ; ++j)
                if (j < nkj) {
                    const float kv = ks[(lane + 32 * j) * kLd + d];
#pragma unroll
                    for (int r = 0; r < kR; ++r) s[r][j] = fmaf(qv[r], kv, s[r][j]);
                }
        }
        float inv[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
            const size_t row = (size_t)(i0 + r) * N;
            float m = -INFINITY;
#pragma unroll
            for (int j = 0; j < kKJ; ++j)
                if (j < nkj) {
                    float t = s[r][j] + bias_h[row + lane + 32 * j];
                    if (mask_t) t += mask_t[row + lane + 32 * j];
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
                    const float e = expf(s[r][j] - m);
                    s[r][j] = e;
                    sum += e;
                }
            inv[r] = 1.f / warp_sum(sum);
        }
        __syncwarp();  // the previous rows' readers of pw are done
#pragma unroll
        for (int j = 0; j < kKJ; ++j)
            if (j < nkj)
                *reinterpret_cast<float4*>(pw + (lane + 32 * j) * kR) =
                    make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        __syncwarp();
        float o[kR] = {0.f, 0.f, 0.f, 0.f};
        for (int key = 0; key < N; ++key) {
            const float4 p = *reinterpret_cast<const float4*>(pw + key * kR);
            const float vv = vs[key * kLd + lane];
            o[0] = fmaf(p.x, vv, o[0]);
            o[1] = fmaf(p.y, vv, o[1]);
            o[2] = fmaf(p.z, vv, o[2]);
            o[3] = fmaf(p.w, vv, o[3]);
        }
        if (lane < hd) {
#pragma unroll
            for (int r = 0; r < kR; ++r) oh[pixel(i0 + r) + lane] = o[r] * inv[r];
        }
    }
}

template <bool HAB>
cudaError_t launch(const float* x, const float* wh, const float* bh, const float* bias,
                   const float* types, float* out, const float* lnw, const float* lnb, int B,
                   int H, int W, int Cin, int Kp, int hs, int ws, int heads, int hd, int shift,
                   cudaStream_t st) {
    const int N = hs * ws;
    if (N % 64 || N > kMaxN || hd > kSlot || hd < 1 || Cin % 4 || Kp % kKC || Kp < Cin ||
        H % hs || W % ws || shift < 0 || shift >= H || shift >= W)
        return cudaErrorInvalidValue;
    static_assert(kR == 4, "the probabilities are stored as one float4 per key");
    const int xa = kRows * (first_half(Kp) + 4), pw = (kThreads / 32) * kMaxN * kR;
    const size_t smem = (size_t)(2 * N * kLd + tile_matmul_ws(false) + (xa > pw ? xa : pw) +
                                 (HAB ? 2 * kRows : 0)) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        wattn_xqkv_kernel<HAB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long nblocks = (long long)B * (H / hs) * (W / ws) * heads;
    if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    wattn_xqkv_kernel<HAB><<<(unsigned)nblocks, kThreads, smem, st>>>(
        x, wh, bh, bias, types, out, lnw, lnb, H, W, Cin, Kp, hs, ws, heads, hd,
        1.f / sqrtf((float)hd), shift);
    return cudaGetLastError();
}

}  // namespace

extern "C" int wattn_xqkv(const float* x, const float* wh, const float* bh, const float* bias,
                          const float* types, float* out, int B, int H, int W, int Cin, int Kp,
                          int hs, int ws, int heads, int hd, void* stream) {
    return launch<false>(x, wh, bh, bias, types, out, nullptr, nullptr, B, H, W, Cin, Kp, hs,
                         ws, heads, hd, 0, static_cast<cudaStream_t>(stream));
}

// The attention half of the fused HAB block: att = W-MSA(LN1(x)) before the projection.
extern "C" int hab_attention(const float* x, const float* lnw, const float* lnb,
                             const float* wh, const float* bh, const float* bias,
                             const float* types, float* att, int B, int H, int W, int C,
                             int Kp, int ws, int heads, int hd, int shift, void* stream) {
    if (heads * hd != C) return cudaErrorInvalidValue;
    return launch<true>(x, wh, bh, bias, types, att, lnw, lnb, B, H, W, C, Kp, ws, ws, heads,
                        hd, shift, static_cast<cudaStream_t>(stream));
}
