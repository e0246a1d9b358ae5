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
//   * Above D = 64 (to 128) a block takes 64 rows and reads the B fragments from device
//     memory (L1 and L2 hold the 256 KB of weights), since they do not fit beside the rows.
//     K = D then takes two chunks, k | v passes of 2 n-tiles.
// Head widths: any multiple of 4 up to 64.
//
// Layout: f32, contiguous. wqkv and wproj as fragments of [D][3D] and [D][D] ([in][out]).

#include <type_traits>

#include "mma_f32x3.cuh"

namespace {

constexpr int kBandThreads = 512;   // 16 warps, one block an SM
constexpr float kEps = 1e-5f;

struct BandArgs {
    const float* x;                   // [npix][T][D]
    const float2 *wqkv, *wproj;       // B fragments of [D][3D], [D][D]
    const float *bqkv, *bproj, *lnw, *lnb;
    float* out;
    long long npix;
    int T, D, heads, hd;
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
template <int MG, int NT, bool CHUNKED, bool SYNC, typename FragLoad, typename Epi>
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
                FragA a[2];
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
    const int parts = (hd + HACC - 1) / HACC, items = nrows * nh * parts;
    for (int it0 = 0; it0 < items; it0 += kBandThreads) {   // the same rounds in every thread
        const int it = it0 + threadIdx.x, part = it % parts, h = it / parts % nh;
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

// Rows of a group: 128 with the weights resident (D <= 64), else 64.
__host__ __device__ constexpr int band_rows(bool res) { return res ? 128 : 64; }
// Floats of a row of KV: k and v, each with kv_col's padding, and 4 more, so that the next
// pixel's rows (T of them apart) start on other banks.
__host__ __device__ constexpr int band_ldkv(int D) { return 2 * (D + D / 4) + 4; }

template <int HACC, bool RES>
__global__ void __launch_bounds__(kBandThreads, 1) band_mha_kernel(const BandArgs a) {
    // resident weights: 128 rows, K = D <= 64 in one chunk, k | v in passes of 4 n-tiles;
    // else 64 rows, K in chunks, passes of 2 (fewer registers beside the chunk's sums); q
    // and the projection in passes of 2
    constexpr int R = band_rows(RES), MG = R / 32, NTKV = RES ? 4 : 2;
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
            const float* src = a.x + grp * P * T * D;
            for (int e = tid; e < n4; e += kBandThreads) {
                const int r = e / q4;
                cp_async16(KV + r * ldo + 4 * (e - r * q4), src + 4 * e);
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
    auto frag_ln = [&](FragA& f, int mt, int s) {   // A in fragment order: one 16-byte load
        const float4 v = A4[(mt * ks + s) * 32 + lane];
        f.set(0, v.x);
        f.set(1, v.y);
        f.set(2, v.z);
        f.set(3, v.w);
    };
    auto frag_heads = [&](FragA& f, int mt, int s) { load_a(f, A, ldo, 16 * mt, 8 * s); };

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
            constexpr int NS = R / 64;
            const int cl = lane & 7, nq = D / 4;
            float4 v[NS][4];   // D <= 128
            float sum[NS], sq[NS];
#pragma unroll
            for (int k = 0; k < NS; ++k) {
                const int r = 64 * k + 4 * warp + (lane >> 3);
                sum[k] = sq[k] = 0.f;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int o = r * ldo + 4 * (8 * i + cl);
                    v[k][i] = 8 * i + cl < nq ? ld4(KV + o) : zero;
                    if (8 * i + cl < nq) *reinterpret_cast<float4*>(Xs + o) = v[k][i];
                    sum[k] += (v[k][i].x + v[k][i].y) + (v[k][i].z + v[k][i].w);
                }
            }
#pragma unroll
            for (int k = 0; k < NS; ++k) {
                sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], 1);
                sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], 2);
                sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], 4);
                sum[k] /= D;   // the mean
#pragma unroll
                for (int i = 0; i < 4; ++i)
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
                if (cl == 0)
                    st[64 * k + 4 * warp + (lane >> 3)] =
                        make_float2(sum[k], 1.f / sqrtf(sq[k] / D + kEps));
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
        band_product<MG, NTKV, !RES, false>(
            frag_ln, ks, wqkv, 3 * D / 8, D / 8, 3 * D / 8, [&](int p, int n, float u0, float u1) {
                const int c = n < 2 * D ? kv_col(n - D) : kv_col(D) + kv_col(n - 2 * D);
                *reinterpret_cast<float2*>(KV + p * ldkv + c) =
                    make_float2(u0 + a.bqkv[n], u1 + a.bqkv[n + 1]);
            });
        // (3) q, scaled, over A once every warp has read A
        band_product<MG, 2, !RES, true>(frag_ln, ks, wqkv, 3 * D / 8, 0, D / 8,
                               [&](int p, int n, float u0, float u1) {
                                   *reinterpret_cast<float2*>(A + p * ldo + n) =
                                       make_float2((u0 + a.bqkv[n]) * a.scale,
                                                   (u1 + a.bqkv[n + 1]) * a.scale);
                               });
        __syncthreads();
        band_attention<HACC>(A, KV, nrows, T, D, a.heads, a.hd, ldo, ldkv);   // (4)
        __syncthreads();   // the heads' output in A; KV read: the next group's x may come
        fetch_x(grp + gridDim.x);
        // (5) out = heads x wproj + bproj + x
        band_product<MG, 2, !RES, false>(frag_heads, ks, wproj, D / 8, 0, D / 8,
                                [&](int p, int n, float u0, float u1) {
                                    if (p >= nrows) return;
                                    const long long i = (row0 + p) * D + n;
                                    const float2 xr =
                                        *reinterpret_cast<const float2*>(Xs + p * ldo + n);
                                    *reinterpret_cast<float2*>(a.out + i) =
                                        make_float2(u0 + a.bproj[n] + xr.x,
                                                    u1 + a.bproj[n + 1] + xr.y);
                                });
    }
    cp_async_wait<0>();   // the last fetch was empty; nothing is left in flight
}

template <int HACC, bool RES>
cudaError_t launch(const BandArgs& a, cudaStream_t st) {
    constexpr int R = band_rows(RES);
    const int D = a.D;
    const size_t smem =
        (size_t)(2 * R * (D + 4) + R * band_ldkv(D) + 2 * R + 2 * D + (RES ? 4 * D * D : 0)) *
        sizeof(float);
    if (smem > 232448) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(band_mha_kernel<HACC, RES>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const long long ngroups = (a.npix + R / a.T - 1) / (R / a.T);
    const int grid = (int)(ngroups < sms ? ngroups : sms);   // persistent: one block an SM
    band_mha_kernel<HACC, RES><<<grid, kBandThreads, smem, st>>>(a);
    return cudaGetLastError();
}

template <bool RES>
cudaError_t launch_hd(const BandArgs& a, cudaStream_t st) {
    return a.hd <= 16 ? launch<16, RES>(a, st) : launch<32, RES>(a, st);
}

}  // namespace

// out = x + MHA(LN(x)) on x [npix][T][D]; wqkv, wproj the B fragments of [D][3D] and [D][D]
// (ops/kernels/_mma.py: fragments). D % 16 == 0 up to 128, D / heads % 4 == 0 up to 64,
// T up to 128 (64 above D = 64).
extern "C" int band_mha(const float* x, const float* wqkv, const float* bqkv, const float* wproj,
                        const float* bproj, const float* lnw, const float* lnb, float* out,
                        long long npix, int T, int D, int heads, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool res = D <= 64;
    if (npix < 1 || D < 16 || D > 128 || D % 16 || heads < 1 || D % heads ||
        (D / heads) % 4 || D / heads > 64 || T < 1 || T > band_rows(res))
        return cudaErrorInvalidValue;
    BandArgs a = {};
    a.x = x; a.wqkv = reinterpret_cast<const float2*>(wqkv); a.bqkv = bqkv;
    a.wproj = reinterpret_cast<const float2*>(wproj); a.bproj = bproj; a.lnw = lnw; a.lnb = lnb;
    a.out = out; a.npix = npix; a.T = T; a.D = D; a.heads = heads; a.hd = D / heads;
    a.scale = 1.f / sqrtf((float)a.hd);
    return res ? launch_hd<true>(a, st) : launch_hd<false>(a, st);
}
