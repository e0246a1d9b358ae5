// The fusion head's per-pixel band attention as one hand-written kernel for Hopper (sm_90a),
// its products f32-exact on the tensor cores (3xTF32 mma.sync, mma_f32x3.cuh): pre-LayerNorm,
// the shared qkv projection, multi-head attention over the T band tokens of each pixel, the
// output projection and the residual,
//     out = x + softmax_heads((LN(x) wq + bq) * hd^-1/2 (LN(x) wk + bk)^T) (LN(x) wv + bv) wproj + bproj
// on x [pixels][T][D].
//
// Replaces the TPU kernel freqfusion_tpu/ops/pallas/bandmha.py:fused_band_mha. The plain
// PyTorch version sits beside the wrapper in freqfusion_tpu_torch/ops/kernels/bandmha.py.
//
// What bounds it on the H100. Per pixel at T = 9, D = 64, 4 heads: 2*9*64*(192 + 64) FLOPs of
// projections (295 k) and 2*(4*81*16*2) of attention (41 k) for 2*9*64*4 = 4.6 KB moved. On
// the tensor cores' 165 TFLOP/s of f32-exact products the projections take 0.32 ms at
// [1,352,512,9,64], the attention on CUDA cores 0.06, the bytes 0.25: the products bound it.
//
// Design. Rows are (pixel, token) pairs; a block takes whole pixels, R / T of them (14 at
// T = 9: 126 of its 128 rows), so that a pixel's tokens never leave the block.
//   * Persistent blocks, one an SM, each looping over groups of pixels. Up to D = 64 the four
//     weight matrices sit in shared memory for the whole kernel: loaded once a block, no ring
//     and no barrier a chunk. They come as B fragments unsplit (ops/kernels/_mma.py:
//     fragments, made once for each weight), 4 D^2 floats: 64 KB at D = 64, where the hi/lo
//     planes would take 128 KB and leave no room for the rows beside them. So each lane splits
//     the two values of a B fragment as it loads it (split_tf32, as the activations are).
//   * Shared memory at D = 64, 128 rows: Xs, x of the group for the residual (34 KB, at a
//     padded stride), A (LN(x) in fragment order, then q and the heads' output row-major, 34
//     KB), KV (k | v, 82 KB, padded; between the attention and the next LN it holds the next
//     group's x, which cp.async brings while the projection runs), the weights (64 KB).
//   * A group: (1) LN in f32 in two steps: each row's mean and 1/std (8 lanes a row, the row
//     in registers, copied to Xs on the way), then A a lane's fragment at a time, one 16-byte
//     store (scattered stores into the fragment order were bank-bound); (2) k | v = A x
//     [wk | wv] + b into KV, 4 floats of padding after every 16 columns so that the heads'
//     lanes read distinct banks; (3) q = (A x wq + bq) hd^-1/2, written over A once every
//     warp is past its reads of A; (4) attention on CUDA cores: one thread per (pixel, query,
//     head) takes the T scores as dot products with a running max and sum (expf), adds
//     p * v, and writes the head's output over its own q (a head above 32 wide in two
//     threads, a part of the output each); then the next group's x is fetched into KV;
//     (5) out = heads x wproj + bproj + x, x from Xs (it came from L2 one load at a time,
//     which left a quarter of the kernel's time in this product).
//   * The products: a warp owns two m-tiles and a contiguous share of the n-tiles, in passes
//     (4 n-tiles for k | v, 2 for q and the projection: whole passes at the served shape,
//     which then take no predicated MMA), three TF32 MMAs a fragment pair (small terms
//     first); K in chunks of 8 k-steps, each chunk in fresh registers added to the sum in
//     f32, as every 3xTF32 user does.
//   * Above D = 64 a block reads the B fragments from device memory (L1 and L2 hold the
//     weights), since they do not fit beside the rows, and takes as many rows as fit: 64 up
//     to D = 128 (128 where a pixel has more than 64 tokens and they fit, to D = 96), 64 to
//     D = 192 where a pixel has more than 32 tokens, else 32 up to D = 384. K = D then takes
//     chunks of 8 k-steps, k | v passes of 2 n-tiles, q passes of 4 (one pass a warp: q is
//     written over A). A head of any width that is a multiple of 4 is taken: above 32 its
//     output columns go in parts of 32, each part a thread that takes the same scores.
// The wrapper zero-pads a width that is not a multiple of 16 and a head width that is not a
// multiple of 4 (weights laid out with zero rows and columns); LN's statistics are taken
// over the Dt real columns and the softmax scale is the real head width's.
//
// The wide route (band_mha_wide): a group holds whole pixels, so a pixel with more tokens
// than the rows that fit (band_mha_rows) or tokens wider than 384 take four steps through
// device memory instead: LN a warp a row into a scratch n; qkv = n x wqkv + bqkv by the row
// product rows_linear (csrc/hat_rows.cu, 3xTF32, K in pieces); the attention on CUDA cores,
// one thread per (row, head, 32 output columns) looping over all T keys of its pixel with a
// running max and sum (online softmax), the heads' output over n; out = n x wproj + bproj by
// rows_linear, then + x. Any T and any D (a multiple of 16, as the wrapper pads it).
//
// Layout: contiguous; x and out f32 or bf16 (bf16 products; q, k, v rounded to bf16 for the
// f32 attention), the rest f32. wqkv and wproj as fragments of [D][3D] and [D][D] ([in][out]).

#include <type_traits>

#include "mma_f32x3.cuh"

namespace {

constexpr int kBandThreads = 512;   // 16 warps, one block an SM
constexpr float kEps = 1e-5f;

template <typename TS>
struct BandArgs {
    const TS* x;                      // [npix][T][D]
    const float2 *wqkv, *wproj;       // B fragments of [D][3D], [D][D]
    const float *bqkv, *bproj, *lnw, *lnb;
    TS* out;
    long long npix;
    int T, D, Dt, heads, hd;   // Dt: LN's real columns of the D
    float scale;
};

// acc(p, n) = sum_k A(p, k) W(k, n) for the n-tiles [nt0, nt1) of W, f32-exact (3xTF32), and
// epi(p, n, acc(p, n), acc(p, n + 1)) for each even n, by the thread that holds them.
// frag_a(FragA&, m-tile, k-step) gives A's fragments; W holds B's, unsplit, [ks][ntw][32].
// Warp w owns m-tiles 2 (w % MG), +1 and the (w / MG)-th share of the n-tiles, in passes of
// NT. CHUNKED: K may pass 8 k-steps, and each chunk of 8 goes into fresh registers added to
// the sum in f32 (the tensor core's adds round toward zero). SYNC: a barrier between the
// products and the epilogue, for an epilogue that writes over A (the caller's shares are at
// most NT n-tiles: one pass).
template <int MG, int NT, bool CHUNKED, bool SYNC, int P, typename FragLoad, typename Epi>
__device__ __forceinline__ void band_product(FragLoad frag_a, int ksteps,
                                             const float2* __restrict__ W, int ntw, int nt0,
                                             int nt1, Epi epi) {
    constexpr int NG = 16 / MG;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int mi = warp % MG, ni = warp / MG;
    const int per = (nt1 - nt0 + NG - 1) / NG;
    const int my0 = nt0 + ni * per, my1 = min(nt1, my0 + per);
    const int npass = (per + NT - 1) / NT;   // the same in every warp
    for (int pass = 0; pass < npass; ++pass) {
        const int base = my0 + pass * NT, mine = my1 - base;   // mine may be <= 0
        float acc[2][NT][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
        // the k-steps of a chunk; FULL: all NT n-tiles are the warp's (the served shapes), so
        // that no MMA is predicated
        auto chunk = [&](auto full, int k0, float (&part)[2][NT][4]) {
            constexpr bool FULL = decltype(full)::value;
            const int k1 = min(ksteps, k0 + 8);
#pragma unroll
            for (int s = k0; s < k0 + 8; ++s) {
                if (s >= k1) break;
                Frag<4, P> a[2];
                frag_a(a[0], 2 * mi, s);
                frag_a(a[1], 2 * mi + 1, s);
                uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    const float2 b = FULL || j < mine
                                         ? W[((size_t)s * ntw + base + j) * 32 + lane]
                                         : make_float2(0.f, 0.f);
                    split_tf32(b.x, bh[j][0], bl[j][0]);
                    split_tf32(b.y, bh[j][1], bl[j][1]);
                }
                // the three terms of every tile interleaved, the small ones first
                if constexpr (P == 3) {
#pragma unroll
                    for (int j = 0; j < NT; ++j)
                        if (FULL || j < mine) {
                            mma_tf32(part[0][j], a[0].lo, bh[j]);
                            mma_tf32(part[1][j], a[1].lo, bh[j]);
                        }
#pragma unroll
                    for (int j = 0; j < NT; ++j)
                        if (FULL || j < mine) {
                            mma_tf32(part[0][j], a[0].hi, bl[j]);
                            mma_tf32(part[1][j], a[1].hi, bl[j]);
                        }
                }
#pragma unroll
                for (int j = 0; j < NT; ++j)
                    if (FULL || j < mine) {
                        mma_tf32(part[0][j], a[0].hi, bh[j]);
                        mma_tf32(part[1][j], a[1].hi, bh[j]);
                    }
            }
        };
        for (int k0 = 0; k0 < (CHUNKED ? ksteps : 1); k0 += 8) {
            float part[2][NT][4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;
            if (mine >= NT)
                chunk(std::true_type{}, k0, part);
            else
                chunk(std::false_type{}, k0, part);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
        }
        if (SYNC) __syncthreads();   // every warp is past its reads of A
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
                if (j < mine) {
                    const int p = 16 * (2 * mi + i) + g, n = 8 * (base + j) + 2 * t;
                    epi(p, n, acc[i][j][0], acc[i][j][1]);
                    epi(p + 8, n, acc[i][j][2], acc[i][j][3]);
                }
    }
}

// Where column c (< D) of k, or of v past D + D / 4, sits in a row of KV: 4 floats of padding
// after every 16 columns, so that the 16-wide heads of the attention's lanes read distinct
// banks.
__device__ __forceinline__ int kv_col(int c) { return c + 4 * (c >> 4); }

// The attention of a group on CUDA cores: one thread per (row, head, part) takes the head's
// q (row-major, stride ldo) against the T keys of its pixel in KV (k, then v, columns as
// kv_col lays them out), with a running max and sum, and writes its part of the output over
// q once every thread of the round has read its q. HACC is a part's width in registers: a
// head up to 16 wide is one part and keeps q in registers; a wider one reads q from shared
// memory and takes its output columns in parts of 32 (two threads above 32), each part
// taking the same scores.
template <int HACC>
__device__ __forceinline__ void band_attention(float* Q, const float* KV, int nrows, int T,
                                               int D, int nh, int hd, int ldo, int ldkv) {
    constexpr bool QREG = HACC == 16;
    const int vo = kv_col(D);   // v's first column
    // a round takes whole (row, head) items, so that no part of one writes over the q that
    // a part of the same head in a later round still reads
    const int parts = QREG ? 1 : (hd + HACC - 1) / HACC, items = nrows * nh * parts;
    const int round = QREG ? kBandThreads : kBandThreads / parts * parts;
    for (int it0 = 0; it0 < items; it0 += round) {   // the same rounds in every thread
        const int it = QREG || threadIdx.x < round ? it0 + threadIdx.x : items;
        const int part = it % parts, h = it / parts % nh;
        const int row = it / parts / nh, c0 = h * hd, d0 = part * HACC;
        float* qp = Q + row * ldo + c0;
        float acc[HACC];
#pragma unroll
        for (int d = 0; d < HACC; ++d) acc[d] = 0.f;
        float l = 1.f;
        if (it < items) {
            float q[QREG ? HACC : 1];
            if constexpr (QREG) {
#pragma unroll
                for (int d = 0; d < HACC; d += 4) {
                    if (d >= hd) break;
                    const float4 v = ld4(qp + d);
                    q[d] = v.x;
                    q[d + 1] = v.y;
                    q[d + 2] = v.z;
                    q[d + 3] = v.w;
                }
            }
            float m = -3.0e38f;   // the first key's corr is exp(-3e38 - s) = 0
            l = 0.f;
            const float* kv = KV + row / T * T * ldkv;
            for (int j = 0; j < T; ++j, kv += ldkv) {
                float s = 0.f;
                if constexpr (QREG) {
#pragma unroll
                    for (int d = 0; d < HACC; d += 4) {
                        if (d >= hd) break;
                        const float4 k = ld4(kv + kv_col(c0 + d));
                        s = fmaf(q[d], k.x, s);
                        s = fmaf(q[d + 1], k.y, s);
                        s = fmaf(q[d + 2], k.z, s);
                        s = fmaf(q[d + 3], k.w, s);
                    }
                } else {
#pragma unroll 4
                    for (int d = 0; d < hd; d += 4) {
                        const float4 k = ld4(kv + kv_col(c0 + d)), qq = ld4(qp + d);
                        s = fmaf(qq.x, k.x, s);
                        s = fmaf(qq.y, k.y, s);
                        s = fmaf(qq.z, k.z, s);
                        s = fmaf(qq.w, k.w, s);
                    }
                }
                const float mn = fmaxf(m, s);
                const float corr = expf(m - mn), p = expf(s - mn);
                l = fmaf(l, corr, p);
#pragma unroll
                for (int d = 0; d < HACC; d += 4) {
                    if (d0 + d >= hd) break;
                    const float4 v = ld4(kv + vo + kv_col(c0 + d0 + d));
                    acc[d] = fmaf(acc[d], corr, p * v.x);
                    acc[d + 1] = fmaf(acc[d + 1], corr, p * v.y);
                    acc[d + 2] = fmaf(acc[d + 2], corr, p * v.z);
                    acc[d + 3] = fmaf(acc[d + 3], corr, p * v.w);
                }
                m = mn;
            }
        }
        __syncthreads();   // every thread of the round has read its q
        if (it < items) {
            const float inv = 1.f / l;
#pragma unroll
            for (int d = 0; d < HACC; d += 4) {
                if (d0 + d >= hd) break;
                *reinterpret_cast<float4*>(qp + d0 + d) = make_float4(
                    acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
            }
        }
    }
}

// Floats of a row of KV: k and v, each with kv_col's padding, and 4 more, so that the next
// pixel's rows (T of them apart) start on other banks.
__host__ __device__ constexpr int band_ldkv(int D) { return 2 * (D + D / 4) + 4; }

// R rows a group, NQ float4s of a row a lane holds in LN (8 lanes a row: D <= 32 NQ).
template <int HACC, int R, bool RES, int NQ, typename TS>
__global__ void __launch_bounds__(kBandThreads, 1) band_mha_kernel(const BandArgs<TS> a) {
    constexpr int PS = kPasses<TS>;
    // resident weights: 128 rows, K = D <= 64 in one chunk, k | v in passes of 4 n-tiles, q
    // in passes of 2; else K in chunks, k | v in passes of 2 (fewer registers beside the
    // chunk's sums), q in passes of 4 (one a warp up to D = 128 at R = 128, 256 at 64, 512
    // at 32); the projection in passes of 2
    constexpr int MG = R / 32, NTKV = RES ? 4 : 2, NTQ = RES ? 2 : 4;
    extern __shared__ float4 smem4[];
    const int D = a.D, T = a.T, ks = D / 8, ldo = D + 4, ldkv = band_ldkv(D);
    float* Xs = reinterpret_cast<float*>(smem4);   // [R][ldo] the group's x, for the residual
    float* A = Xs + R * ldo;                        // LN(x) in A-fragment order; then q [R][ldo]
    float* KV = A + R * ldo;                        // [R][ldkv]: k | v
    float2* st = reinterpret_cast<float2*>(KV + R * ldkv);   // [R] each row's mean, 1/std
    float* lnp = reinterpret_cast<float*>(st + R);  // [2][D] LN's weight and bias
    float* Ws = lnp + 2 * D;                        // RES: wqkv's fragments, then wproj's
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int P = R / T;                            // whole pixels a group
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const long long ngroups = (a.npix + P - 1) / P;

    // the group's rows of x into KV's memory (free from the last group's attention on, read
    // by this group's LN) at Xs's stride: one commit group
    auto fetch_x = [&](long long grp) {
        if (grp < ngroups) {
            const int q4 = D / 4, n4 = (int)min((long long)P, a.npix - grp * P) * T * q4;
            const TS* src = a.x + grp * P * T * D;
            for (int e = tid; e < n4; e += kBandThreads) {
                const int r = e / q4;
                stage4(KV + r * ldo + 4 * (e - r * q4), src + 4 * e);
            }
        }
        cp_async_commit();
    };
    for (int e = tid; e < D; e += kBandThreads) {   // visible after the loop's first barrier
        lnp[e] = a.lnw[e];
        lnp[D + e] = a.lnb[e];
    }
    const float2* wqkv = a.wqkv;
    const float2* wproj = a.wproj;
    if (RES) {   // the weights, once a block, with the first group's x
        const int nq = 3 * D * D / 4, np = D * D / 4;   // float4s of each
        for (int e = tid; e < nq; e += kBandThreads)
            cp_async16(Ws + 4 * e, reinterpret_cast<const float*>(a.wqkv) + 4 * e);
        for (int e = tid; e < np; e += kBandThreads)
            cp_async16(Ws + 3 * D * D + 4 * e, reinterpret_cast<const float*>(a.wproj) + 4 * e);
        wqkv = reinterpret_cast<const float2*>(Ws);
        wproj = reinterpret_cast<const float2*>(Ws + 3 * D * D);
    }
    fetch_x(blockIdx.x);
    const float4* A4 = reinterpret_cast<const float4*>(A);
    auto frag_ln = [&](Frag<4, PS>& f, int mt, int s) {   // A in fragment order: one 16-byte load
        const float4 v = A4[(mt * ks + s) * 32 + lane];
        f.set(0, v.x);
        f.set(1, v.y);
        f.set(2, v.z);
        f.set(3, v.w);
    };
    auto frag_heads = [&](Frag<4, PS>& f, int mt, int s) { load_a(f, A, ldo, 16 * mt, 8 * s); };

    for (long long grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
        const long long row0 = grp * P * T;
        const int nrows = (int)min((long long)P, a.npix - grp * P) * T;
        cp_async_wait<0>();
        // x (and the weights) visible to every thread, and every thread is past the last
        // group's reads of A and KV
        __syncthreads();
        // (1) LN(x) into A, in two steps. Each row's mean and 1/std: 8 lanes a row, the row
        // in registers (a lane's quads cl, cl + 8, ..), NS rows of 4 a warp at once; the rows
        // are copied from KV's memory, where they came, to Xs, for the residual
        {
            constexpr int NS = R >= 64 ? R / 64 : 1;
            const int cl = lane & 7, nq = D / 4, Dt = a.Dt;
            float4 v[NS][NQ];
            float sum[NS], sq[NS];
#pragma unroll
            for (int k = 0; k < NS; ++k) {
                const int r = 64 * k + 4 * warp + (lane >> 3);
                sum[k] = sq[k] = 0.f;
#pragma unroll
                for (int i = 0; i < NQ; ++i) {
                    const int o = r * ldo + 4 * (8 * i + cl);
                    const bool in = (R >= 64 || r < R) && 8 * i + cl < nq;
                    v[k][i] = in ? ld4(KV + o) : zero;
                    if (in) *reinterpret_cast<float4*>(Xs + o) = v[k][i];
                    sum[k] += (v[k][i].x + v[k][i].y) + (v[k][i].z + v[k][i].w);
                }
            }
#pragma unroll
            for (int k = 0; k < NS; ++k) {
                sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], 1);
                sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], 2);
                sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], 4);
                sum[k] /= Dt;   // the mean over the real columns (the padded ones are 0)
#pragma unroll
                for (int i = 0; i < NQ; ++i)
                    if (8 * i + cl < nq) {
                        const float u = sum[k];
                        const float4 d = make_float4(v[k][i].x - u, v[k][i].y - u, v[k][i].z - u,
                                                     v[k][i].w - u);
                        sq[k] = fmaf(d.x, d.x, fmaf(d.y, d.y, fmaf(d.z, d.z, fmaf(d.w, d.w, sq[k]))));
                    }
            }
#pragma unroll
            for (int k = 0; k < NS; ++k) {
                sq[k] += __shfl_xor_sync(0xffffffffu, sq[k], 1);
                sq[k] += __shfl_xor_sync(0xffffffffu, sq[k], 2);
                sq[k] += __shfl_xor_sync(0xffffffffu, sq[k], 4);
                // each of the D - Dt padded columns (zeros) added u^2 to the squares
                sq[k] = fmaf(-(float)(D - Dt) * sum[k], sum[k], sq[k]);
                const int r = 64 * k + 4 * warp + (lane >> 3);
                if (cl == 0 && (R >= 64 || r < R))
                    st[r] = make_float2(sum[k], 1.f / sqrtf(sq[k] / Dt + kEps));
            }
        }
        __syncthreads();
        // then A, a thread a lane's fragment (rows g, g + 8, columns t, t + 4 of a 16 x 8
        // tile) at a time: one 16-byte store, x read at stride ldo from distinct banks; zero
        // past the group's rows
#pragma unroll 4
        for (int e = tid; e < R / 16 * ks * 32; e += kBandThreads) {
            const int fl = e & 31, tile = e >> 5, mt = tile / ks, kst = tile - mt * ks;
            const int r = 16 * mt + (fl >> 2), c = 8 * kst + (fl & 3);
            auto ln = [&](int rr, int cc) {
                const float2 m = st[rr];
                return rr < nrows ? (Xs[rr * ldo + cc] - m.x) * m.y * lnp[cc] + lnp[D + cc] : 0.f;
            };
            reinterpret_cast<float4*>(A)[e] =
                make_float4(ln(r, c), ln(r + 8, c), ln(r, c + 4), ln(r + 8, c + 4));
        }
        __syncthreads();   // A written; KV's memory read: k | v may come
        // (2) k | v: columns D .. 3D of wqkv into KV's 0 .. 2D
        // k, v and q rounded to the storage type where the TPU kernel casts them to its operand
        // dtype (a no-op for f32); the attention (4) runs on CUDA cores in f32
        band_product<MG, NTKV, !RES, false, PS>(
            frag_ln, ks, wqkv, 3 * D / 8, D / 8, 3 * D / 8, [&](int p, int n, float u0, float u1) {
                const int c = n < 2 * D ? kv_col(n - D) : kv_col(D) + kv_col(n - 2 * D);
                *reinterpret_cast<float2*>(KV + p * ldkv + c) =
                    make_float2(round_to<TS>(u0 + a.bqkv[n]), round_to<TS>(u1 + a.bqkv[n + 1]));
            });
        // (3) q, scaled, over A once every warp has read A
        band_product<MG, NTQ, !RES, true, PS>(frag_ln, ks, wqkv, 3 * D / 8, 0, D / 8,
                               [&](int p, int n, float u0, float u1) {
                                   *reinterpret_cast<float2*>(A + p * ldo + n) =
                                       make_float2(round_to<TS>(u0 + a.bqkv[n]) * a.scale,
                                                   round_to<TS>(u1 + a.bqkv[n + 1]) * a.scale);
                               });
        __syncthreads();
        band_attention<HACC>(A, KV, nrows, T, D, a.heads, a.hd, ldo, ldkv);   // (4)
        __syncthreads();   // the heads' output in A; KV read: the next group's x may come
        fetch_x(grp + gridDim.x);
        // (5) out = heads x wproj + bproj + x
        band_product<MG, 2, !RES, false, PS>(frag_heads, ks, wproj, D / 8, 0, D / 8,
                                [&](int p, int n, float u0, float u1) {
                                    if (p >= nrows) return;
                                    const long long i = (row0 + p) * D + n;
                                    const float2 xr =
                                        *reinterpret_cast<const float2*>(Xs + p * ldo + n);
                                    st2(a.out + i, make_float2(u0 + a.bproj[n] + xr.x,
                                                               u1 + a.bproj[n + 1] + xr.y));
                                });
    }
    cp_async_wait<0>();   // the last fetch was empty; nothing is left in flight
}

// Floats of shared memory a group of R rows takes at width D.
__host__ __device__ constexpr long long band_smem(int R, int D, bool res) {
    return 2LL * R * (D + 4) + (long long)R * band_ldkv(D) + 2 * R + 2 * D +
           (res ? 4LL * D * D : 0);
}

template <int HACC, int R, bool RES, int NQ, typename TS>
cudaError_t launch(const BandArgs<TS>& a, cudaStream_t st) {
    const int D = a.D;
    const size_t smem = (size_t)band_smem(R, D, RES) * sizeof(float);
    if (smem > 232448 || D > 32 * NQ || a.T > R) return cudaErrorInvalidValue;
    const auto kernel = band_mha_kernel<HACC, R, RES, NQ, TS>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const long long ngroups = (a.npix + R / a.T - 1) / (R / a.T);
    const int grid = (int)(ngroups < sms ? ngroups : sms);   // persistent: one block an SM
    kernel<<<grid, kBandThreads, smem, st>>>(a);
    return cudaGetLastError();
}

// Rows of a group for T tokens of width D (0: none fits): 128 with the weights resident up
// to D = 64; above, 64 up to D = 128, or 128 where T > 64 and they fit; then 64 where T > 32
// and they fit, else 32 up to D = 384.
int band_mha_rows(int T, int D) {
    if (D <= 64) return T <= 128 ? 128 : 0;
    if (D <= 128) {
        if (T <= 64) return 64;
        return T <= 128 && band_smem(128, D, false) * 4 <= 232448 ? 128 : 0;
    }
    if (T > 32) return T <= 64 && D <= 192 && band_smem(64, D, false) * 4 <= 232448 ? 64 : 0;
    return D <= 384 && band_smem(32, D, false) * 4 <= 232448 ? 32 : 0;
}

// ---- The wide route

// n[r] = LN(x[r]) over the first Dt of D columns (the rest are zero in x and in LN's affine):
// a warp a row, f32, eps 1e-5.
__global__ void band_ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ lnw,
                                    const float* __restrict__ lnb, float* __restrict__ n,
                                    long long rows, int D, int Dt) {
    const long long r = (long long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
    if (r >= rows) return;
    const int lane = threadIdx.x & 31;
    const float* src = x + r * D;
    float u, inv;
    warp_ln_stats(src, Dt, kEps, u, inv);
    for (int c = lane; c < D; c += 32) n[r * D + c] = (src[c] - u) * inv * lnw[c] + lnb[c];
}

// The attention of the wide route: one thread per (row, head, part of 32 output columns)
// takes its head's q (row r of qkv [rows][3D], columns h hd ..) against the T keys of its
// pixel (columns D + h hd .. and, for v, 2D + h hd ..) with a running max and sum, and writes
// its part of the head's output to o [rows][D]. q arrives scaled by `scale` here.
__global__ void band_attention_wide_kernel(const float* __restrict__ qkv, float* __restrict__ o,
                                           long long rows, int T, int D, int heads, int hd,
                                           float scale) {
    const int parts = (hd + 31) / 32;
    const long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (it >= rows * heads * parts) return;
    const int part = (int)(it % parts), h = (int)(it / parts % heads);
    const long long r = it / parts / heads;
    const int c0 = h * hd, d0 = 32 * part, nd = min(32, hd - d0);
    const float* q = qkv + r * 3 * D + c0;
    const float* kv = qkv + (r / T) * T * 3 * D;   // the pixel's first row
    float acc[32];
#pragma unroll
    for (int d = 0; d < 32; ++d) acc[d] = 0.f;
    float m = -3.0e38f, l = 0.f;   // the first key's corr is exp(-3e38 - s) = 0
    for (int j = 0; j < T; ++j, kv += 3 * D) {
        const float* k = kv + D + c0;
        float s = 0.f;
        for (int d = 0; d < hd; ++d) s = fmaf(q[d], k[d], s);
        s *= scale;
        const float mn = fmaxf(m, s);
        const float corr = expf(m - mn), p = expf(s - mn);
        l = fmaf(l, corr, p);
        const float* v = kv + 2 * D + c0 + d0;
#pragma unroll
        for (int d = 0; d < 32; ++d)
            if (d < nd) acc[d] = fmaf(acc[d], corr, p * v[d]);
        m = mn;
    }
    const float inv = 1.f / l;
    float* dst = o + r * D + c0 + d0;
#pragma unroll
    for (int d = 0; d < 32; ++d)
        if (d < nd) dst[d] = acc[d] * inv;
}

// out += x, float4s
__global__ void band_residual_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                                     long long n4) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n4) return;
    const float4 a = out[i], b = x[i];
    out[i] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <typename TS>
void fill_band(BandArgs<TS>& a, const TS* x, const float* wqkv, const float* bqkv,
               const float* wproj, const float* bproj, const float* lnw, const float* lnb,
               TS* out, long long npix, int T, int D, int Dt, int heads, int hd, float scale) {
    a.x = x; a.wqkv = reinterpret_cast<const float2*>(wqkv); a.bqkv = bqkv;
    a.wproj = reinterpret_cast<const float2*>(wproj); a.bproj = bproj; a.lnw = lnw; a.lnb = lnb;
    a.out = out; a.npix = npix; a.T = T; a.D = D; a.Dt = Dt; a.heads = heads; a.hd = hd;
    a.scale = scale;
}

template <typename TS>
cudaError_t band_launch(const BandArgs<TS>& a, int R, cudaStream_t st) {
    const int D = a.D;
    if (D <= 64)
        return a.hd <= 16 ? launch<16, 128, true, 4>(a, st) : launch<32, 128, true, 4>(a, st);
    if (R == 128) return launch<32, 128, false, 4>(a, st);
    if (D <= 128) return launch<32, 64, false, 4>(a, st);
    if (R == 64) return launch<32, 64, false, 6>(a, st);
    return launch<32, 32, false, 12>(a, st);
}

}  // namespace

extern "C" int rows_linear(const float* a, const float* wp, const float* bp, float* out,
                           float* y, long long npix, int C, int Cout, int Kp, int Np,
                           int bf16_io, void* stream);

// The wide route: out = x + MHA(LN(x)) on x [npix][T][D] for any T, D % 16 == 0; wqkv, wproj
// the mma_planes of [D][3D] and [D][D] (ops/kernels/_mma.py: planes); n [npix T][D] and qkv
// [npix T][3D] scratch. Heads, Dt and scale as band_mha's.
extern "C" int band_mha_wide(const float* x, const float* wqkv, const float* bqkv,
                             const float* wproj, const float* bproj, const float* lnw,
                             const float* lnb, float* n, float* qkv, float* out, long long npix,
                             int T, int D, int Dt, int heads, int hd, float scale,
                             void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (npix < 1 || T < 1 || D < 16 || D % 16 || Dt < 1 || Dt > D || heads < 1 || hd < 1 ||
        heads * hd > D)
        return cudaErrorInvalidValue;
    const long long rows = npix * T;
    band_ln_rows_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(x, lnw, lnb, n, rows, D, Dt);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = static_cast<cudaError_t>(
        rows_linear(n, wqkv, bqkv, qkv, nullptr, rows, D, 3 * D, D, 3 * D, 0, st));
    if (err != cudaSuccess) return err;
    const long long items = rows * heads * ((hd + 31) / 32);
    band_attention_wide_kernel<<<(unsigned)((items + 255) / 256), 256, 0, st>>>(
        qkv, n, rows, T, D, heads, hd, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = static_cast<cudaError_t>(
        rows_linear(n, wproj, bproj, out, nullptr, rows, D, D, D, D, 0, st));
    if (err != cudaSuccess) return err;
    const long long n4 = rows * D / 4;
    band_residual_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), n4);
    return cudaGetLastError();
}

// out = x + MHA(LN(x)) on x [npix][T][D]; wqkv, wproj the B fragments of [D][3D] and [D][D]
// (ops/kernels/_mma.py: fragments). D % 16 == 0 up to 384; heads of hd columns (hd % 4 == 0),
// head h at columns h hd .. of q, k and v, heads * hd <= D (the columns past them zero); T up
// to band_mha_rows; LN over the first Dt columns (the rest zero), scores scaled by `scale`.
// x and out f32, or bf16 where `bf16_io` is set; the weights' fragments, biases and LN f32.
extern "C" int band_mha(const float* x, const float* wqkv, const float* bqkv, const float* wproj,
                        const float* bproj, const float* lnw, const float* lnb, float* out,
                        long long npix, int T, int D, int Dt, int heads, int hd, float scale,
                        int bf16_io, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int R = band_mha_rows(T, D);
    if (npix < 1 || D < 16 || D % 16 || Dt < 1 || Dt > D || heads < 1 || hd < 4 || hd % 4 ||
        heads * hd > D || T < 1 || R == 0)
        return cudaErrorInvalidValue;
    if (bf16_io) {
        BandArgs<bf16> a = {};
        fill_band(a, reinterpret_cast<const bf16*>(x), wqkv, bqkv, wproj, bproj, lnw, lnb,
                  reinterpret_cast<bf16*>(out), npix, T, D, Dt, heads, hd, scale);
        return band_launch(a, R, st);
    }
    BandArgs<float> a = {};
    fill_band(a, x, wqkv, bqkv, wproj, bproj, lnw, lnb, out, npix, T, D, Dt, heads, hd, scale);
    return band_launch(a, R, st);
}
