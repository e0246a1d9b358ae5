// Window attention, hand-written f32 kernels for Hopper (sm_90a). First the kernel with the
// qkv projection fused in, DAT's rectangular-window attention. Then, further down with its
// own notes, the kernel that attends from pre-projected q, k, v images. (The attention half
// of HAT's fused HAB block, which began as a second instantiation of the first kernel, is
// csrc/hab_attention.cu, on the tensor cores.)
//
// Replaces the TPU kernel freqfusion_tpu/ops/pallas/wattn.py:fused_window_attention_xqkv
// (B4). Per window of N = hs*ws tokens and per head (dim hd):
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

__global__ void __launch_bounds__(kThreads, 2)
wattn_xqkv_kernel(const float* __restrict__ x, const float* __restrict__ wh,
                  const float* __restrict__ bh, const float* __restrict__ bias,
                  const float* __restrict__ types, float* __restrict__ out, int H, int W,
                  int Cin, int Kp, int hs, int ws_, int heads, int hd, float scale) {
    extern __shared__ float4 smem4[];
    const int N = hs * ws_, K1 = first_half(Kp), lda = K1 + 4;
    float* ks = reinterpret_cast<float*>(smem4);  // [N][kLd]
    float* vs = ks + N * kLd;
    float* stage = vs + N * kLd;                   // tile_matmul's weight stage
    float* xa = stage + tile_matmul_ws(false);     // [kRows][lda] x rows; then probabilities

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
        return xb + ((size_t)(wy * hs + t / ws_) * W + wx * ws_ + t % ws_) * Cin;
    };
    for (int r0 = 0; r0 < N; r0 += kRows) {
        for (int k0 = 0; k0 < Kp; k0 += K1) {
            const int kh = min(K1, Kp - k0), k4 = kh / 4;
            const bool first = k0 == 0, last = k0 + kh == Kp;
            // the previous pass's readers of xa are past tile_matmul's last barrier
            for (int e = tid; e < kRows * k4; e += kThreads) {
                const int r = e / k4, c = (e % k4) * 4;
                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                if (k0 + c < Cin)
                    v = *reinterpret_cast<const float4*>(src_row(r0 + r) + k0 + c);
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

cudaError_t launch(const float* x, const float* wh, const float* bh, const float* bias,
                   const float* types, float* out, int B, int H, int W, int Cin, int Kp, int hs,
                   int ws, int heads, int hd, cudaStream_t st) {
    const int N = hs * ws;
    if (N % 64 || N > kMaxN || hd > kSlot || hd < 1 || Cin % 4 || Kp % kKC || Kp < Cin ||
        H % hs || W % ws)
        return cudaErrorInvalidValue;
    static_assert(kR == 4, "the probabilities are stored as one float4 per key");
    const int xa = kRows * (first_half(Kp) + 4), pw = (kThreads / 32) * kMaxN * kR;
    const size_t smem =
        (size_t)(2 * N * kLd + tile_matmul_ws(false) + (xa > pw ? xa : pw)) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        wattn_xqkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long nblocks = (long long)B * (H / hs) * (W / ws) * heads;
    if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    wattn_xqkv_kernel<<<(unsigned)nblocks, kThreads, smem, st>>>(
        x, wh, bh, bias, types, out, H, W, Cin, Kp, hs, ws, heads, hd, 1.f / sqrtf((float)hd));
    return cudaGetLastError();
}


// ---- Attention from pre-projected q, k, v --------------------------------------------
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
// Design. The kernel above without its projection, generalised to any N up to 576 (HAT's
// odd windows: 225 = 15 x 15, 81 = 9 x 9, neither a multiple of 32). One block owns one
// (window, head): its hd columns of k and v go to shared memory ([N][33] and [N][32]; a
// token's 30 of 90 channels are 120 contiguous bytes, read by one warp), q comes from
// device memory a row at a time. A warp owns 4 query rows, a lane scores keys lane,
// lane + 32, ..; a key past N scores -inf and a row past N is computed on a clamped index
// and not stored. The probabilities go through shared memory in chunks of 32*CJ keys.
// Two instantiations: up to 256 keys (8 score registers a row, two blocks an SM) and up to
// 576 (18 registers, one block an SM). q, k, v share a pixel stride `ld`, so that B14 can
// pass the three thirds of one [B,H,W,3C] projection.

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

extern "C" int wattn_xqkv(const float* x, const float* wh, const float* bh, const float* bias,
                          const float* types, float* out, int B, int H, int W, int Cin, int Kp,
                          int hs, int ws, int heads, int hd, void* stream) {
    return launch(x, wh, bh, bias, types, out, B, H, W, Cin, Kp, hs, ws, heads, hd,
                  static_cast<cudaStream_t>(stream));
}

// Attention from pre-projected images: q, k, v at a pixel stride of `ld` floats (their
// heads*hd columns first), out [B,H,W,heads*hd].
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
