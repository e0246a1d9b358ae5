// The window attentions' shared loop: FlashAttention-2's online softmax over keys streamed
// through shared memory, its products f32-exact on Hopper's tensor cores (3xTF32 mma.sync,
// mma_f32x3.cuh). Its callers are csrc/wattn.cu (B13, and B14's attention: rect windows
// with the shift mask's window types) and csrc/oca.cu (B9: a window of queries against the
// overlapping window of keys around it); each supplies its own gather of queries, keys and
// bias rows (see Gather below). Per window, head and query row i:
//     out_i = softmax_j(q_i k_j^T * scale + bias[i][j] (+ mask[i][j])) v_j
// A key that the gather marks zero (outside the image) is not masked: it scores its bias and
// adds nothing to the sum, as zero-padding after the projection gives it. Keys past nk score
// -inf.
//
// What bounds it on the H100: per (window, head) 4 nq nk hd FLOPs of products and nq nk
// exponentials for about 2 (nq + nk) hd floats of q, k, v, out and the nq nk floats of the
// bias rows (read from L2): the products bound it (B13 at [1,352,512,90]: 16.6 GFLOP, 0.10
// ms on the tensor cores' 165 TFLOP/s of f32-exact products).
//
// Design.
//   * A block of NW warps owns 16 NW query rows of one (window, head); a warp owns an m-tile
//     of 16 rows. The block walks the keys in chunks of kFlashKeys (32) through a two-stage
//     cp.async ring, K at a row stride of hdp + 4 and V at 36 floats (both 4 mod 8: the B
//     fragments of QK^T, [key][dim], and of PV, taken at keys 2t and 2t + 1, fall on 32
//     banks), so shared memory does not grow with the window: any nk, several blocks an SM.
//     Each key's hd floats come in 8-byte copies where every offset is even (a head starts at
//     head * hd floats, which need not be 16-byte aligned), else in 4-byte ones; padded dims,
//     keys past nk and zero keys are stored 0.
//   * The head is padded to hdp, a multiple of 8 (the MMA's k). Up to 32 dims (QREG) a warp
//     keeps its q fragments, scaled and split into TF32 hi and lo, in registers; a wider
//     head stages the block's q rows in shared memory once and splits each fragment as it
//     loads it. The output goes in pieces of 32 dims (4 n-tiles), one walk over the keys a
//     piece, each walk taking the same scores: any head width.
//   * P = 1 (the gather's P: bf16, and precision "default" on f32 storage): q rounded to
//     bf16, times the scale rounded to bf16, rounded again, as the TPU kernels compute
//     `q.astype(dt) * scale` in the operand dtype; k, v and the probabilities rounded where
//     their fragments are set; one TF32 pass. The TPU kernels round the normalised
//     probabilities, so at precision "default" (<float, 1>) a first walk over the keys
//     takes each row's max and sum and the PV walks take exp(s - max) / sum, rounded: the
//     scores are taken twice. The bf16 instantiation keeps the single online walk (the
//     unnormalised probabilities rounded), inside the bf16 bounds and at its times. The
//     output is rounded at P = 1 as it is stored, as the TPU kernels round each head's.
//   * QK^T in 3xTF32 over 8 k-steps at a time, each group into a fresh register tile added
//     in f32; the bias (and mask) rows in f32 from L2, added before the max; exact expf.
//   * PV straight from the score registers (no shuffle): the accumulator's c0/c1 hold keys
//     2t and 2t + 1 of an n-tile where the A operand's a0/a2 hold k-positions t and t + 4,
//     so PV takes k-position t as key 2t and t + 4 as key 2t + 1, for P and for V's rows
//     alike. Each chunk's PV goes into a fresh tile, added to the rescaled running sum in
//     f32 (the tensor core's adds round toward zero; a short chain keeps that at f32 level).
#pragma once

#include <cmath>

#include "mma_f32x3.cuh"

constexpr int kFlashKeys = 32;    // keys a step of the online softmax
constexpr int kFlashPiece = 32;   // output dims a walk over the keys
constexpr int kFlashLdV = kFlashPiece + 4;

__host__ __device__ constexpr int flash_hdp(int hd) { return (hd + 7) / 8 * 8; }
// Floats of shared memory a block of NW warps needs at head width hd.
__host__ __device__ constexpr int flash_smem_floats(int nw, int hd) {
    return 2 * kFlashKeys * (flash_hdp(hd) + 4 + kFlashLdV) +
           (hd <= 32 ? 0 : 16 * nw * (flash_hdp(hd) + 4));
}

template <int NW, bool QREG, typename Gather>
__device__ __forceinline__ void flash_attention_f32x3(const Gather& G, int qgroup, float* smem) {
    using T = typename Gather::T;
    constexpr int P = Gather::P;
    // precision "default" (f32 storage, one pass) takes the normalised probabilities, below;
    // the bf16 instantiation keeps its single online-softmax walk
    constexpr bool kDef = P == 1 && !kBf16<T>;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
    const int hd = G.hd, hdp = flash_hdp(hd), ldk = hdp + 4, ksteps = hdp / 8;
    const int nq = G.nq, nk = G.nk, nchunks = (nk + kFlashKeys - 1) / kFlashKeys;
    float* Ks = smem;                              // [2][kFlashKeys][ldk]
    float* Vs = Ks + 2 * kFlashKeys * ldk;         // [2][kFlashKeys][kFlashLdV]
    float* Qs = Vs + 2 * kFlashKeys * kFlashLdV;   // !QREG: [16 NW][ldk] the scaled q rows
    const int q0 = 16 * NW * qgroup, ra = q0 + 16 * warp + g, rb = ra + 8;
    const bool va = ra < nq, vb = rb < nq;
    const float scale = rop<P>(G.scale);

    // the chunk of keys c0 .. c0 + 31: K's hdp dims and V's dims d0 .. d0 + 31, NW threads a
    // key (the block has 32 NW threads), a key's offset taken once
    auto stage = [&](int c, int d0) {
        if (c < nchunks) {
            const int key = tid / NW, sub = tid % NW, j = c * kFlashKeys + key;
            const long long off = j < nk ? G.key(j) : -1;
            float* kd = Ks + (c & 1) * kFlashKeys * ldk + key * ldk;
            float* vd = Vs + (c & 1) * kFlashKeys * kFlashLdV + key * kFlashLdV;
            if (G.even) {   // pairs of dims: hd even, so a pair is all real or all padding
                for (int d = 2 * sub; d < hdp; d += 2 * NW) {
                    if (off >= 0 && d < hd)
                        cp_async8(kd + d, G.k + off + d);
                    else
                        *reinterpret_cast<float2*>(kd + d) = make_float2(0.f, 0.f);
                }
                for (int d = 2 * sub; d < kFlashPiece; d += 2 * NW) {
                    if (off >= 0 && d0 + d < hd)
                        cp_async8(vd + d, G.v + off + d0 + d);
                    else
                        *reinterpret_cast<float2*>(vd + d) = make_float2(0.f, 0.f);
                }
            } else {
                for (int d = sub; d < hdp; d += NW) {
                    if (off >= 0 && d < hd)
                        cp_async4(kd + d, G.k + off + d);
                    else
                        kd[d] = 0.f;
                }
                for (int d = sub; d < kFlashPiece; d += NW) {
                    if (off >= 0 && d0 + d < hd)
                        cp_async4(vd + d, G.v + off + d0 + d);
                    else
                        vd[d] = 0.f;
                }
            }
        }
        cp_async_commit();
    };

    Frag<4, P> qa[QREG ? 4 : 1];   // QREG: q of rows ra, rb over dims 8 kq + t, + 4
    if constexpr (QREG) {
        const T* pa = G.q_row(va ? ra : 0);
        const T* pb = G.q_row(vb ? rb : 0);
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
            const int d0 = 8 * kq + t, d1 = d0 + 4;
            qa[kq].set(0, va && d0 < hd ? rop<P>(ld1(pa + d0)) * scale : 0.f);
            qa[kq].set(1, vb && d0 < hd ? rop<P>(ld1(pb + d0)) * scale : 0.f);
            qa[kq].set(2, va && d1 < hd ? rop<P>(ld1(pa + d1)) * scale : 0.f);
            qa[kq].set(3, vb && d1 < hd ? rop<P>(ld1(pb + d1)) * scale : 0.f);
        }
    } else {   // visible after the first chunk's barrier
        for (int e = tid; e < 16 * NW * hdp; e += 32 * NW) {
            const int r = e / hdp, d = e - r * hdp;
            Qs[r * ldk + d] =
                q0 + r < nq && d < hd ? rop<P>(ld1(G.q_row(q0 + r) + d)) * scale : 0.f;
        }
    }
    // bias (and mask) rows of ra and rb; a row past nq reads row 0's, its result dropped
    const float* ba_row = G.bias_row(va ? ra : 0);
    const float* bb_row = G.bias_row(vb ? rb : 0);
    const float* ma_row = G.mask_row(va ? ra : 0);
    const float* mb_row = G.mask_row(vb ? rb : 0);
    const bool even = (nk & 1) == 0;   // the bias rows are 8-byte aligned: float2 loads

    // the scores of chunk c (keys 32 c ..) for rows ra and rb, bias (and mask) added, keys
    // past nk at -inf, and their maxima over the chunk (the 4 lanes of a row reduced)
    auto scores = [&](int c, float (&s)[4][4], float& c0, float& c1) {
        const float* kc = Ks + (c & 1) * kFlashKeys * ldk;
        const int kc0 = c * kFlashKeys;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        if constexpr (QREG) {
#pragma unroll
            for (int kq = 0; kq < 4; ++kq) {
                if (kq >= ksteps) break;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    Frag<2, P> b;
                    load_b_nk(b, kc, ldk, 8 * kq, 8 * j);
                    mma_f32x3(s[j], qa[kq], b);
                }
            }
        } else {
            for (int k0 = 0; k0 < ksteps; k0 += 8) {   // a fresh tile every 8 k-steps
                float part[4][4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll 2
                for (int kq = k0; kq < min(ksteps, k0 + 8); ++kq) {
                    Frag<4, P> a;
                    load_a(a, Qs, ldk, 16 * warp, 8 * kq);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        Frag<2, P> b;
                        load_b_nk(b, kc, ldk, 8 * kq, 8 * j);
                        mma_f32x3(part[j], a, b);
                    }
                }
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
            }
        }
        c0 = -INFINITY;
        c1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int key = kc0 + 8 * j + 2 * t;
            float2 ba, bb;
            if (key + 1 < nk) {
                if (even) {
                    ba = *reinterpret_cast<const float2*>(ba_row + key);
                    bb = *reinterpret_cast<const float2*>(bb_row + key);
                } else {
                    ba = make_float2(ba_row[key], ba_row[key + 1]);
                    bb = make_float2(bb_row[key], bb_row[key + 1]);
                }
                if (ma_row) {
                    ba.x += ma_row[key];
                    ba.y += ma_row[key + 1];
                    bb.x += mb_row[key];
                    bb.y += mb_row[key + 1];
                }
            } else {   // key + 1 past the last key; key itself too, unless key = nk - 1
                const bool in = key < nk;
                ba = make_float2(in ? ba_row[key] + (ma_row ? ma_row[key] : 0.f) : 0.f, 0.f);
                bb = make_float2(in ? bb_row[key] + (mb_row ? mb_row[key] : 0.f) : 0.f, 0.f);
                if (!in) s[j][0] = s[j][2] = -INFINITY;
                s[j][1] = s[j][3] = -INFINITY;
            }
            s[j][0] += ba.x;
            s[j][1] += ba.y;
            s[j][2] += bb.x;
            s[j][3] += bb.y;
            c0 = fmaxf(c0, fmaxf(s[j][0], s[j][1]));
            c1 = fmaxf(c1, fmaxf(s[j][2], s[j][3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {   // the 4 lanes of a row
            c0 = fmaxf(c0, __shfl_xor_sync(0xffffffffu, c0, off));
            c1 = fmaxf(c1, __shfl_xor_sync(0xffffffffu, c1, off));
        }
    };
    // the rows' running max and sum over a chunk's scores; s becomes exp(s - max)
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    auto online = [&](float (&s)[4][4], float c0, float c1, float& al0, float& al1) {
        const float n0 = fmaxf(m0, c0), n1 = fmaxf(m1, c1);
        al0 = expf(m0 - n0);   // 0 at the first chunk
        al1 = expf(m1 - n1);
        m0 = n0;
        m1 = n1;
        l0 *= al0;
        l1 *= al1;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            s[j][0] = expf(s[j][0] - n0);   // 0 past the last key
            s[j][1] = expf(s[j][1] - n0);
            s[j][2] = expf(s[j][2] - n1);
            s[j][3] = expf(s[j][3] - n1);
            l0 += s[j][0] + s[j][1];
            l1 += s[j][2] + s[j][3];
        }
    };
    if constexpr (kDef) {
        // bf16 operands: the TPU kernels round the normalised probabilities
        // (softmax(.).astype(dt)), so a first walk over the keys takes the rows' max and
        // sum, and the walks below round exp(s - max) / sum
        stage(0, 0);
        for (int c = 0; c < nchunks; ++c) {
            cp_async_wait<0>();
            __syncthreads();   // chunk c visible, every thread past chunk c - 1
            stage(c + 1, 0);
            float s[4][4], c0, c1, al0, al1;
            scores(c, s, c0, c1);
            online(s, c0, c1, al0, al1);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            l0 += __shfl_xor_sync(0xffffffffu, l0, off);
            l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        }
        cp_async_wait<0>();   // the last stage was empty
        __syncthreads();      // every thread is past the last chunk: the walks restage
    }

    for (int d0 = 0; d0 < hd; d0 += kFlashPiece) {
        stage(0, d0);
        float o[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
        if constexpr (!kDef) {
            m0 = m1 = -INFINITY;
            l0 = l1 = 0.f;
        }
        for (int c = 0; c < nchunks; ++c) {
            cp_async_wait<0>();
            // chunk c visible to every thread, every thread past chunk c - 1: its stage
            // may be refilled
            __syncthreads();
            stage(c + 1, d0);
            const float* vc = Vs + (c & 1) * kFlashKeys * kFlashLdV;
            float s[4][4], c0, c1, al0 = 1.f, al1 = 1.f;
            scores(c, s, c0, c1);
            if constexpr (kDef) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s[j][0] = expf(s[j][0] - m0) / l0;   // 0 past the last key
                    s[j][1] = expf(s[j][1] - m0) / l0;
                    s[j][2] = expf(s[j][2] - m1) / l1;
                    s[j][3] = expf(s[j][3] - m1) / l1;
                }
            } else {
                online(s, c0, c1, al0, al1);
            }
            // P V, k-step j over keys 8 j ..: k-position t is key 2t, t + 4 is 2t + 1; the
            // chunk's sum in a fresh tile, added to the rescaled running one in f32
            float pv[4][4];
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                Frag<4, P> p;
                p.set(0, s[j][0]);
                p.set(1, s[j][2]);
                p.set(2, s[j][1]);
                p.set(3, s[j][3]);
                const float* v0 = vc + (8 * j + 2 * t) * kFlashLdV + g;
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                    Frag<2, P> b;
                    b.set(0, v0[8 * n]);
                    b.set(1, v0[kFlashLdV + 8 * n]);
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
        float inv0 = 1.f, inv1 = 1.f;   // default: p was normalised before PV
        if constexpr (!kDef) {
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                l0 += __shfl_xor_sync(0xffffffffu, l0, off);
                l1 += __shfl_xor_sync(0xffffffffu, l1, off);
            }
            inv0 = 1.f / l0;
            inv1 = 1.f / l1;
        }
        T* oa = G.out_row(va ? ra : 0);
        T* ob = G.out_row(vb ? rb : 0);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int d = d0 + 8 * n + 2 * t + e;
                if (d < hd) {   // at P = 1 rounded, as the TPU kernel's head outputs
                    if (va) st1(oa + d, rop<P>(o[n][e] * inv0));
                    if (vb) st1(ob + d, rop<P>(o[n][2 + e] * inv1));
                }
            }
        cp_async_wait<0>();   // the last stage was empty
        __syncthreads();      // every thread is past the last chunk: the next piece restages
    }
}
