// Window attention with the qkv projection in front, f32-exact on the tensor cores (3xTF32,
// mma_f32x3.cuh), hand-written for Hopper (sm_90a): one kernel for two TPU kernels.
//
// Replaces freqfusion_tpu/ops/pallas/wattn.py:fused_window_attention_xqkv (B4, DAT's
// rectangular windows, no LayerNorm) and computes the first half of :fused_hab_block (B8,
// HAT's square windows after LN1; its second half, the projection, the residuals and the
// MLP, is csrc/hat_rows.cu). Per (hs x ws) window of N tokens and per head (dim hd):
//     [q, k, v] = LN1?(x_window) @ W_head + b_head
//     att = softmax(q k^T / sqrt(hd) + bias[head] (+ mask type of the window)) v
// and `att` is the attended image [B,H,W,heads*hd] before the output projection; co =
// heads*hd need not be Cin (B4: a DAT branch's 3 heads of 30 from 180 channels). With
// shift = s the image is not rolled by the caller: token (r, c) of window (i, j) reads
// x[(i*hs + r + s) % H][(j*ws + c + s) % W], and att is written at (i*hs + r, j*ws + c), in
// rolled coordinates (B8's in_shift; B4 passes 0, DAT rolls x itself). The plain PyTorch
// versions sit beside the wrappers in freqfusion_tpu_torch/ops/kernels/wattn.py.
//
// What bounds it on the H100. Per window and head 2*N*Cin*3*hd FLOPs of projection and
// 4*N*N*hd of attention, all products; the softmax's N*N exponentials and the bias (and
// mask) rows are the rest. B4 at DAT's [1,352,512,180] (704 windows x 3 heads of 30, N =
// 256): 8.8 + 7.9 MFLOP a (window, head), 35 GFLOP, 0.21 ms at 165 TFLOP/s of f32-exact
// products (3 x TF32 at 495; 0.53 ms at the CUDA cores' 67), x and att 0.2 GB (0.06 ms).
// B8 at HAT-L's (704 windows x 6 heads): 9.0 + 7.9 MFLOP a pair, 0.43 ms (1.06 on CUDA
// cores). The bias (and mask) rows come from L2, 1.1 GB a B8 launch. What must stay out of
// device memory is q, k, v and the N x N scores.
//
// Design. One block owns one (window, head), 8 warps, 104 KB of shared memory at N = 256:
// two blocks an SM.
//   * Projection: the window's x rows [N][Cin -> Kp] times the head's slab [Kp][96] =
//     q | k | v, each hd wide in a 32-column slot (no zero slot: 96 columns for 90 real
//     ones). 128 rows a pass, K in chunks of 32: the chunk of x is normalised on load where
//     there is a LayerNorm (a warp takes each row's mean and 1/std once a pass; the modular
//     shift gather is the row's address), the slab's chunk comes by cp.async, and a warp
//     owns 2 m-tiles x 6 n-tiles of the pass's 128 x 96 product. k and v of the head stay in
//     shared memory, [N][36] each (a row stride of 4 mod 8); the scaled q rows are parked in
//     the output buffer, each token's own hd floats of this head: the warp that later
//     overwrites them with the result reads them back first (at default q is parked
//     rounded, and scaled as it is read back, as the TPU kernel scales the rounded q).
//   * Scores and PV: a warp owns 16 query rows (an m-tile) at a time; their q rows go from
//     the parked copy into the warp's slice of the (then idle) staging area, read as A
//     fragments. QK^T runs over key chunks of 32 (four n-tiles, k = 32 in four k-steps)
//     with an online softmax across chunks (FlashAttention-2's loop), so a thread holds 16
//     scores; a chunk of 64 keys, with the PV sum of each chunk in its own register tile,
//     spilled at two blocks' 128 registers. The bias row, and the mask row in a shifted
//     window, is added in f32 from L2 before the max; exp is the exact expf.
//   * The accumulator's layout is not the A operand's: c0/c1 hold keys 2t and 2t+1 of an
//     n-tile where a0/a2 hold k-positions t and t+4. Instead of shuffles or a pass through
//     shared memory, PV takes the keys of each k-step in the order the scores already sit
//     in: k-position t is key 2t and t+4 is key 2t+1, for A and for the V rows of B alike
//     (a sum over keys does not care about their order). The score registers are the A
//     fragment as they stand, and the V reads (rows 2t, 2t+1 at a stride of 4 mod 32)
//     still hit 32 banks.
//   * The shift mask comes as its 4 window types (interior, last column, last row, corner)
//     [4][N][N]; the block picks its type from the window's position.
//   * Two instantiations, with and without the LayerNorm on load; nothing else differs.
// The heads of a window are neighbouring blocks, so x is read from device memory once and
// again from L2.
//
// Layout: x [B,H,W,Cin] NHWC; wh [heads][Kp][96]; bh [heads][96]; bias [heads][N][N];
// types [4][N][N] or null; att [B,H,W,heads*hd]; lnw, lnb [Cin] or both null. N % 32 == 0,
// N <= 256, hd <= 32, Cin % 4 == 0, Kp % 8 == 0. x and att are f32, or bf16 (T); the rest
// is f32. At P = 1 the products take bf16 operands. At precision "default" (<float, 1>) they
// are rounded where the TPU kernel casts them: q, k and v (qkv.astype(dt)), q times the
// bf16 scale again, and the normalised probabilities (softmax(.).astype(dt)): a first walk
// over the keys takes each row's max and sum, the second rounds exp(s - max) / sum; each
// head's output is rounded as it is stored (jnp.dot(a, v).astype(dt)). The bf16 instantiation keeps the single online walk (the unnormalised probabilities rounded,
// q scaled in f32 before its rounding), inside the bf16 bounds and at its times.

#include <cmath>

#include "mma_f32x3.cuh"

namespace {

constexpr int kSlot = 32, kCols = 3 * kSlot;  // q | k | v, a head in a 32-column slot
constexpr int kMaxN = 256;
constexpr int kPass = 128;                    // x rows projected per pass
constexpr int kKChunk = 32;                   // slab rows staged per step
constexpr int kLdKV = kSlot + 4;              // k and v rows in shared memory: 4 mod 8
constexpr int kLdX = kKChunk + 4;             // staged x rows: 4 mod 8
constexpr int kLdW = kCols + 8;               // staged slab rows: 104, 8 mod 32
constexpr int kKeys = 32;                     // keys an online-softmax step

size_t smem_bytes(int N) {
    return (size_t)(2 * N * kLdKV + kPass * kLdX + kKChunk * kLdW + 3 * kPass) * sizeof(float);
}

template <bool LN, typename T, int P>
__global__ void __launch_bounds__(kThreads, 2)
xqkv_attention_kernel(const T* __restrict__ x, const float* __restrict__ lnw,
                      const float* __restrict__ lnb, const float* __restrict__ wh,
                      const float* __restrict__ bh, const float* __restrict__ bias,
                      const float* __restrict__ types, T* __restrict__ out, int H, int W,
                      int Cin, int Kp, int hs, int ws_, int heads, int hd, float scale,
                      int shift) {
    // precision "default" (f32 storage, one pass) rounds where the TPU kernel does, below;
    // the bf16 instantiation keeps its single online-softmax walk
    constexpr bool kDef = P == 1 && !kBf16<T>;
    extern __shared__ float4 smem4[];
    const int N = hs * ws_;
    float* ks = reinterpret_cast<float*>(smem4);  // [N][kLdKV]
    float* vs = ks + N * kLdKV;                    // [N][kLdKV]
    float* xsm = vs + N * kLdKV;                   // [kPass][kLdX]
    float* wsm = xsm + kPass * kLdX;               // [kKChunk][kLdW]
    float* lnst = wsm + kKChunk * kLdW;            // [kPass][2] mean, 1/std
    int* rowoff = reinterpret_cast<int*>(lnst + 2 * kPass);  // [kPass] rows' offsets in x

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int head = blockIdx.x % heads;
    int win = blockIdx.x / heads;
    const int n_wc = W / ws_, n_wr = H / hs;
    const int bi = win / (n_wr * n_wc);
    win -= bi * n_wr * n_wc;
    const int wy = win / n_wc, wx = win % n_wc;
    const T* xb = x + (size_t)bi * H * W * Cin;
    const float* whh = wh + (size_t)head * Kp * kCols;
    const float* bhh = bh + head * kCols;

    const int co = heads * hd;
    T* oh = out + (size_t)bi * H * W * co + head * hd;  // this head's columns
    auto pixel = [&](int tok) {  // token of the window -> its pixel's offset in `out`
        return ((size_t)(wy * hs + tok / ws_) * W + wx * ws_ + tok % ws_) * co;
    };
    auto src_off = [&](int tok) {  // token of the window -> its pixel's row of x, from xb
        int y = wy * hs + tok / ws_ + shift, xx = wx * ws_ + tok % ws_ + shift;
        if (y >= H) y -= H;
        if (xx >= W) xx -= W;
        return (y * W + xx) * Cin;
    };

    // ---- projection: [N][Kp] x [Kp][96], 128 rows a pass; warp: rows 32 wm.., n-tiles 6 wn..
    const int wm = warp & 3, wn = warp >> 2;
    for (int r0 = 0; r0 < N; r0 += kPass) {
        // the previous pass's readers of lnst and rowoff are past its last barrier
        for (int r = warp; r < kPass; r += kThreads / 32) {
            float u = 0.f, inv = 0.f;
            const int off = r0 + r < N ? src_off(r0 + r) : 0;
            if (LN && r0 + r < N) warp_ln_stats(xb + off, Cin, 1e-5f, u, inv);
            if (lane == 0) {
                lnst[2 * r] = u;
                lnst[2 * r + 1] = inv;
                rowoff[r] = off;
            }
        }
        float acc[2][6][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int j = 0; j < 6; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
        for (int k0 = 0; k0 < Kp; k0 += kKChunk) {
            const int kc = min(kKChunk, Kp - k0), k4 = kc / 4;
            __syncthreads();  // lnst written; the previous chunk's readers are done
            for (int e = tid; e < kc * (kCols / 4); e += kThreads) {
                const int row = e / (kCols / 4), col = (e % (kCols / 4)) * 4;
                cp_async16(wsm + row * kLdW + col, whh + (size_t)(k0 + row) * kCols + col);
            }
            cp_async_commit();
            for (int e = tid; e < kPass * k4; e += kThreads) {
                const int r = e / k4, c = (e % k4) * 4, ch = k0 + c;
                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                if (r0 + r < N && ch < Cin) {
                    v = ld4(xb + rowoff[r] + ch);
                }
                if (LN && r0 + r < N && ch < Cin) {   // LN1 on load
                    const float u = lnst[2 * r], inv = lnst[2 * r + 1];
                    const float4 lw = *reinterpret_cast<const float4*>(lnw + ch);
                    const float4 lb = *reinterpret_cast<const float4*>(lnb + ch);
                    v.x = (v.x - u) * inv * lw.x + lb.x;
                    v.y = (v.y - u) * inv * lw.y + lb.y;
                    v.z = (v.z - u) * inv * lw.z + lb.z;
                    v.w = (v.w - u) * inv * lw.w + lb.w;
                }
                *reinterpret_cast<float4*>(xsm + r * kLdX + c) = v;
            }
            cp_async_wait<0>();
            __syncthreads();  // the chunk of x and of the slab visible
            for (int kk = 0; kk < kc; kk += 8) {
                Frag<4, P> a[2];
#pragma unroll
                for (int m = 0; m < 2; ++m) load_a(a[m], xsm, kLdX, 32 * wm + 16 * m, kk);
#pragma unroll
                for (int j = 0; j < 6; ++j) {
                    Frag<2, P> b;
                    load_b_kn(b, wsm, kLdW, kk, 48 * wn + 8 * j);
                    mma_f32x3(acc[0][j], a[0], b);
                    mma_f32x3(acc[1][j], a[1], b);
                }
            }
        }
        // q (scaled; at default rounded) parked in out, k and v into shared memory (their
        // padded columns are zeros: zero weights and bias)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = r0 + 32 * wm + 16 * m + g + 8 * h;
                if (row >= N) continue;
                T* qrow = oh + pixel(row);
#pragma unroll
                for (int j = 0; j < 6; ++j) {
                    const int n = 48 * wn + 8 * j + 2 * t, slot = n / kSlot, d = n % kSlot;
                    const float v0 = acc[m][j][2 * h] + bhh[n];
                    const float v1 = acc[m][j][2 * h + 1] + bhh[n + 1];
                    if (slot == 0) {   // q scaled; at P = 1 q rounded, scaled on its load
                        if (d < hd)
                            st1(qrow + d, kDef ? rop<P>(v0) : v0 * scale);
                        if (d + 1 < hd)
                            st1(qrow + d + 1, kDef ? rop<P>(v1) : v1 * scale);
                    } else {
                        float* kv = (slot == 1 ? ks : vs) + row * kLdKV + d;
                        kv[0] = v0;
                        kv[1] = v1;
                    }
                }
            }
    }
    __syncthreads();  // k, v and the parked q complete

    // ---- attention: a warp owns 16 query rows at a time
    const int t_idx = types ? (wy == n_wr - 1 ? 2 : 0) + (wx == n_wc - 1 ? 1 : 0) : 0;
    const float* bias_h = bias + (size_t)head * N * N;
    const float* mask_t = types ? types + (size_t)t_idx * N * N : nullptr;
    for (int i0 = 16 * warp; i0 < N; i0 += 16 * (kThreads / 32)) {
        const int ra = i0 + g, rb = ra + 8;
        const size_t pa = pixel(ra), pb = pixel(rb);
        // the warp's 16 scaled q rows (at default scaled here as the TPU kernel scales them:
        // bf16(q) * bf16(scale), rounded), d < hd, into its slice of the staging area (free
        // since the projection's last barrier): read once, then an A fragment a k-step
        float* qw = xsm + warp * 16 * kLdX;
        __syncwarp();  // the previous rows' readers of qw are done
        for (int e = lane; e < 16 * kSlot; e += 32) {
            const int r = e / kSlot, d = e % kSlot;
            const float q = d < hd ? ld1(oh + pixel(i0 + r) + d) : 0.f;
            qw[r * kLdX + d] = kDef ? rop<P>(q * rop<P>(scale)) : q;
        }
        __syncwarp();
        if constexpr (kDef) {
            // Precision "default": the TPU kernel rounds the normalised probabilities
            // (softmax(.).astype(dt)), so a first walk over the keys takes the rows' max and
            // sum, and the second rounds exp(s - max) / sum before PV. The scores of keys
            // kc0 .. kc0 + 31 for rows ra and rb, bias (and mask) added, and their maxima
            // over the chunk (the 4 lanes of a row reduced).
            auto scores = [&](int kc0, float (&s)[kKeys / 8][4], float& c0, float& c1) {
#pragma unroll
                for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
                for (int kq = 0; kq < 4; ++kq) {
                    Frag<4, P> a;
                    load_a(a, qw, kLdX, 0, 8 * kq);
#pragma unroll
                    for (int j = 0; j < kKeys / 8; ++j) {
                        Frag<2, P> b;
                        load_b_nk(b, ks, kLdKV, 8 * kq, kc0 + 8 * j);
                        mma_f32x3(s[j], a, b);
                    }
                }
                c0 = -INFINITY;
                c1 = -INFINITY;
#pragma unroll
                for (int j = 0; j < kKeys / 8; ++j) {
                    const int key = kc0 + 8 * j + 2 * t;
                    const float2 ba =
                        *reinterpret_cast<const float2*>(bias_h + (size_t)ra * N + key);
                    const float2 bb =
                        *reinterpret_cast<const float2*>(bias_h + (size_t)rb * N + key);
                    s[j][0] += ba.x;
                    s[j][1] += ba.y;
                    s[j][2] += bb.x;
                    s[j][3] += bb.y;
                    if (mask_t) {
                        const float2 ma =
                            *reinterpret_cast<const float2*>(mask_t + (size_t)ra * N + key);
                        const float2 mb =
                            *reinterpret_cast<const float2*>(mask_t + (size_t)rb * N + key);
                        s[j][0] += ma.x;
                        s[j][1] += ma.y;
                        s[j][2] += mb.x;
                        s[j][3] += mb.y;
                    }
                    c0 = fmaxf(c0, fmaxf(s[j][0], s[j][1]));
                    c1 = fmaxf(c1, fmaxf(s[j][2], s[j][3]));
                }
#pragma unroll
                for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
                    c0 = fmaxf(c0, __shfl_xor_sync(0xffffffffu, c0, off));
                    c1 = fmaxf(c1, __shfl_xor_sync(0xffffffffu, c1, off));
                }
            };
            float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
#pragma unroll 1
            for (int kc0 = 0; kc0 < N; kc0 += kKeys) {   // the rows' max and sum
                float s[kKeys / 8][4], c0, c1;
                scores(kc0, s, c0, c1);
                const float n0 = fmaxf(m0, c0), n1 = fmaxf(m1, c1);
                l0 *= expf(m0 - n0);  // 0 at the first chunk
                l1 *= expf(m1 - n1);
                m0 = n0;
                m1 = n1;
#pragma unroll
                for (int j = 0; j < kKeys / 8; ++j) {
                    l0 += expf(s[j][0] - n0) + expf(s[j][1] - n0);
                    l1 += expf(s[j][2] - n1) + expf(s[j][3] - n1);
                }
            }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                l0 += __shfl_xor_sync(0xffffffffu, l0, off);
                l1 += __shfl_xor_sync(0xffffffffu, l1, off);
            }
            float o[4][4];
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll 1
            for (int kc0 = 0; kc0 < N; kc0 += kKeys) {   // P V, p normalised and rounded
                float s[kKeys / 8][4], c0, c1;
                scores(kc0, s, c0, c1);
                float pv[4][4];
#pragma unroll
                for (int n = 0; n < 4; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
                // rolled without LN: with the loop unrolled, that instantiation spilled
                // under its 128 registers (and with it rolled, the LN one did)
#pragma unroll(LN ? kKeys / 8 : 1)
                for (int j = 0; j < kKeys / 8; ++j) {
                    Frag<4, P> p;   // k-positions t, t + 4 are keys 2t, 2t + 1, as below
                    p.set(0, expf(s[j][0] - m0) / l0);
                    p.set(1, expf(s[j][2] - m1) / l1);
                    p.set(2, expf(s[j][1] - m0) / l0);
                    p.set(3, expf(s[j][3] - m1) / l1);
                    const float* v0 = vs + (size_t)(kc0 + 8 * j + 2 * t) * kLdKV + g;
#pragma unroll
                    for (int n = 0; n < 4; ++n) {
                        Frag<2, P> b;
                        b.set(0, v0[8 * n]);
                        b.set(1, v0[kLdKV + 8 * n]);
                        mma_f32x3(pv[n], p, b);
                    }
                }
#pragma unroll
                for (int n = 0; n < 4; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) o[n][e] += pv[n][e];
            }
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int d = 8 * n + 2 * t + e;
                    if (d < hd) {   // p was normalised before PV; the output rounded
                        st1(oh + pa + d, rop<P>(o[n][e]));   // as the TPU kernel's head outputs
                        st1(oh + pb + d, rop<P>(o[n][2 + e]));
                    }
                }
        } else {
            float o[4][4];
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
            float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
            for (int kc0 = 0; kc0 < N; kc0 += kKeys) {
                float s[kKeys / 8][4];
#pragma unroll
                for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
                for (int kq = 0; kq < 4; ++kq) {
                    Frag<4, P> a;
                    load_a(a, qw, kLdX, 0, 8 * kq);
#pragma unroll
                    for (int j = 0; j < kKeys / 8; ++j) {
                        Frag<2, P> b;
                        load_b_nk(b, ks, kLdKV, 8 * kq, kc0 + 8 * j);
                        mma_f32x3(s[j], a, b);
                    }
                }
                float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
                for (int j = 0; j < kKeys / 8; ++j) {
                    const int key = kc0 + 8 * j + 2 * t;
                    const float2 ba =
                        *reinterpret_cast<const float2*>(bias_h + (size_t)ra * N + key);
                    const float2 bb =
                        *reinterpret_cast<const float2*>(bias_h + (size_t)rb * N + key);
                    s[j][0] += ba.x;
                    s[j][1] += ba.y;
                    s[j][2] += bb.x;
                    s[j][3] += bb.y;
                    if (mask_t) {
                        const float2 ma =
                            *reinterpret_cast<const float2*>(mask_t + (size_t)ra * N + key);
                        const float2 mb =
                            *reinterpret_cast<const float2*>(mask_t + (size_t)rb * N + key);
                        s[j][0] += ma.x;
                        s[j][1] += ma.y;
                        s[j][2] += mb.x;
                        s[j][3] += mb.y;
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
                    s[j][0] = expf(s[j][0] - n0);
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
                    Frag<4, P> p;
                    p.set(0, s[j][0]);
                    p.set(1, s[j][2]);
                    p.set(2, s[j][1]);
                    p.set(3, s[j][3]);
                    const float* v0 = vs + (size_t)(kc0 + 8 * j + 2 * t) * kLdKV + g;
#pragma unroll
                    for (int n = 0; n < 4; ++n) {
                        Frag<2, P> b;
                        b.set(0, v0[8 * n]);
                        b.set(1, v0[kLdKV + 8 * n]);
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
                        st1(oh + pa + d, o[n][e] * inv0);
                        st1(oh + pb + d, o[n][2 + e] * inv1);
                    }
                }
        }
    }
}

}  // namespace

namespace {

template <typename T, int P>
cudaError_t launch(const T* x, const float* lnw, const float* lnb, const float* wh,
                   const float* bh, const float* bias, const float* types, T* att, int B, int H,
                   int W, int Cin, int Kp, int hs, int ws, int heads, int hd, int shift,
                   cudaStream_t st) {
    const size_t smem = smem_bytes(hs * ws);
    auto kernel = lnw ? xqkv_attention_kernel<true, T, P> : xqkv_attention_kernel<false, T, P>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long nblocks = (long long)B * (H / hs) * (W / ws) * heads;
    if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    kernel<<<(unsigned)nblocks, kThreads, smem, st>>>(x, lnw, lnb, wh, bh, bias, types, att, H,
                                                      W, Cin, Kp, hs, ws, heads, hd,
                                                      1.f / sqrtf((float)hd), shift);
    return cudaGetLastError();
}

}  // namespace

// att = window attention of x's (hs x ws) windows after the qkv projection, before the output
// projection: B4 (lnw = lnb = null, shift 0) and the attention half of the fused HAB block
// (B8, LN1 = (lnw, lnb)); wh [heads][Kp][96] and bh [heads][96] are the per-head slabs
// q | k | v. x and att in the storage type of `mode` (common.cuh: Mode).
extern "C" int xqkv_attention(const float* x, const float* lnw, const float* lnb,
                              const float* wh, const float* bh, const float* bias,
                              const float* types, float* att, int B, int H, int W, int Cin,
                              int Kp, int hs, int ws, int heads, int hd, int shift, int mode,
                              void* stream) {
    const int N = hs * ws;
    if (N % kKeys || N > kMaxN || hd > kSlot || hd < 1 || heads < 1 || Cin % 4 || Kp % 8 ||
        Kp < Cin || H % hs || W % ws || shift < 0 || shift >= H || shift >= W ||
        (lnw == nullptr) != (lnb == nullptr))
        return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return by_mode(mode, [&](auto m) {
        using T = typename decltype(m)::T;
        return launch<T, decltype(m)::P>(as<T>(x), lnw, lnb, wh, bh, bias, types, as<T>(att), B,
                                         H, W, Cin, Kp, hs, ws, heads, hd, shift, st);
    });
}
