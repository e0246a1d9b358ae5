// NAFBlock as two hand-written kernels for Hopper (sm_90a), their 1x1 products f32-exact
// on the tensor cores (3xTF32 mma.sync, mma_f32x3.cuh) on weights split into TF32 hi and lo
// on the host and kept (ops/kernels/_mma.py).
//
// Replaces the TPU kernels freqfusion_tpu/ops/pallas/nafblock.py:naf_block_stage_a (B1) and
// :naf_block_stage_b (B2). The plain PyTorch versions sit beside the wrappers in
// freqfusion_tpu_torch/ops/kernels/nafblock.py.
//
// What bounds them on the H100. At the HR levels (C = 64 at 4x the LR size) the unfused
// block is memory-bound: it writes and re-reads some eight C- or 2C-wide tensors. Fused,
// stage A reads x once and writes g once, and stage B reads g and x once and writes the
// output once. What remains is the 1x1 convolutions: 2C^2 MACs per pixel in stage A and
// 4C^2 in stage B. Stage A's product is 47.2 GFLOP at every level of the 512x352 bucket
// (C^2 x pixels is the same at 1408x2048x64, 704x1024x128 and 352x512x256): 0.29 ms at 165
// TFLOP/s of f32-exact products, while x and g are 1.47 GB at C = 64 (0.44 ms): bytes bound
// it there, the products at C = 256. Stage B's products are 94.5 GFLOP at every level
// (0.573 ms); it reads g and x and writes out, 2.21, 1.11 and 0.55 GB (0.661, 0.330, 0.165
// ms): bytes bound it at C = 64 (0.661 ms), the products at 128 and 256 (0.573 ms).
//
// Stage A (B1): x -> LN -> 1x1 C->2C (+b1) -> 3x3 depthwise SAME (+bdw) -> SimpleGate -> g,
// plus per-image sums of g for the channel attention's global mean.
//   * A block of 16 warps owns a (HH - 2) x 14 output tile and its HH x 16 halo: one halo
//     row is one 16-row m-tile of the product. HH = 16 up to C = 128 (196 outputs for 256
//     product rows, 1.31x the product the outputs need), 8 at C = 256 (84 for 128, 1.52x),
//     where the halo's LN(x), staged whole, takes 128 KB, and on an image too small to give
//     the 16-row tile a block for every SM (stage_a_rows). Eight warps a block at an 8-row
//     tile, two blocks an SM at C = 64, ran slower (4.19 against 3.78 ms, PERF.md).
//   * The halo is normalised once, a warp a row with the rows in registers (all of a
//     warp's loads in flight at once), into shared memory in the A-fragment order of
//     tile_mma (no padded stride; one 16-byte load a fragment). A halo pixel outside the
//     image stores t = 0 after the product: SAME padding zeroes the depthwise conv's input
//     t, not x, because LN(0) + bias != 0.
//   * The product runs in passes of 32 gate channels and their 32 partners (64 columns,
//     8 n-tiles; the host lays w1's columns out pass by pass, ops/kernels/nafblock.py). The
//     weights come split into TF32 hi and lo on the host (_mma.mma_planes), streamed through
//     a 2-stage cp.async ring in chunks of KC rows (64 at C = 64: a pass's whole slab, one
//     barrier a pass; 32 above, where A leaves less room), the passes following one another
//     in the ring. Warp w owns m-tile w % HH and 8 / (16 / HH) n-tiles; each chunk goes into
//     a fresh register tile that is added in f32 (the tensor core's adds truncate) to the
//     pass's sum, which stays in shared memory where t goes (a second register tile
//     spilled).
//   * t of the pass goes to shared memory [256][64], its 8-column groups XOR-swizzled by the
//     row so that the epilogue's stores and the conv's reads hit 32 banks; then the depthwise
//     conv and the gate run on CUDA cores in f32, a thread owning one channel and one output
//     column and sliding its 3x3 window down the tile (3 new taps a row for each of a, b).
//   * The TPU kernel carried the sum of g across its sequential grid. Hopper blocks run in
//     no order, so each block writes its partial sums [B, nblk, C] and a second small pass
//     adds them in a fixed order: the sums are the same from run to run (no atomics).
// Stage B (B2), pointwise: g*att -> 1x1 (+b3) -> y = x + beta*(.) -> LN2 (eps 1e-6) -> 1x1
// C->2C (+b4) -> SimpleGate -> 1x1 (+b5) -> y + gamma*(.). att = mean(g) @ W_sca + b_sca is
// a [B,C]x[C,C] product computed by the caller between the two stages, multiplied into g
// where A is staged. A block of 16 warps owns 128 pixels and runs the three products through
// tile_mma (mma_f32x3.cuh), the weights streamed through its 128 KB ring. w4's columns come
// gate-interleaved from the host (gate channel j in column 2j, its partner C + j in 2j + 1),
// so that SimpleGate is one epilogue thread's pair of accumulators.
//   * C = 64 (4 of NAF's 14 launches, and every launch of a tile chunk): on chip. A (32 KB:
//     g * att, then LN2(y)), y (32 KB, in the first product's epilogue) and the gated hidden
//     (32 KB, in the second's, in A-fragment order: the third product's A) stay in shared
//     memory beside the ring: 224 KB. The block reads g and x once and writes out once: a
//     C-wide f32 pass over [1,1408,2048,64] costs 0.22 ms, and three more would take a third
//     of the budget. The three products' epilogues never write the A that their own product
//     reads (tile_mma runs an epilogue while other warps still read A).
//   * Every other C (128 and 256 in NAF-64; any multiple of 8): A is 128 rows x one K piece
//     (64 KB at C = 128 and 256) beside the ring, and y and the hidden do not fit too. y is
//     parked in out (written by the first epilogue, read by LN2's
//     statistics, the second product's staging and the last epilogue), the hidden goes
//     through hid, and at C = 256, whose K comes in two pieces (tile_mma_piece), each
//     product's partial sums go through part [pixels][2C], added in f32 in a fixed order.
//     Every product parks its sums at part's row stride of 2C, so a block touches only its
//     own 128 rows of it: blocks run in no order, and a narrower stride for one product
//     would lay a block's rows over another's. Per
//     pixel that is 2C floats of writes (y, the hidden) and 4C of reads beyond g, x and out,
//     6C of each more at 256 (the partial sums), mostly L2 hits: each block reads back what
//     it wrote. The products bound it there. Moving x's read out of the first epilogue and
//     the last epilogue's read of y into streaming passes (rows in registers) timed no
//     faster on the H100 and spilled: the product itself (tile_mma) is what holds it.
//   * LN2's statistics are in f32 and every sum has a fixed order: no atomics.
//
// Layout: NHWC, contiguous; x, g, att and out f32 or bf16 (bf16 products, the sums and y f32).
// Weights: w1p the mma_planes of w1 [C][2C] with its columns
// pass by pass; w3p, w4p, w5p the mma_planes of w3 [C][C], of w4 [C][2C] gate-interleaved and
// of w5 [C][C]; wdw [9][2C]. Stage A takes C % 4 == 0 with Cp = C rounded up to the pass's
// 32 channels at most 256: w1p is laid out at Cp (zero rows and columns past C), LN's
// statistics are taken over the C real channels and the padded ones are never stored. Stage
// B takes C % 8 == 0 (its products take K and N in steps of 8), on chip at C = 64 only.

#include "mma_f32x3.cuh"

namespace {

constexpr float kEps = 1e-6f;

// ---- Stage A
constexpr int kAWarps = 16;
constexpr int kHaloW = 16, kOutW = kHaloW - 2;   // a halo row is an m-tile; 14 outputs
constexpr int kPassC = 32, kPassN = 2 * kPassC;  // gate channels, product columns a pass

// Halo rows of a stage-A block: 16 (1.31x recompute) where C <= 128 and the image gives
// that tile a block for every SM, else 8 (1.52x), which takes C up to 256 and, with twice
// the blocks at half the latency each, serves a small image faster. 0 where the device
// cannot be queried.
int stage_a_rows(int B, int H, int W, int C) {
    if ((C + kPassC - 1) / kPassC * kPassC > 128) return 8;
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return 0;
    const long long blocks = (long long)B * ((H + 13) / 14) * ((W + kOutW - 1) / kOutW);
    return blocks >= sms ? 16 : 8;
}

// Where column n (< 64) of a pass's t sits in row p of the [rows][64] buffer: its 8-column
// group XOR-ed with p % 4, which keeps n in its half (gate, partner)
__device__ __forceinline__ int t_col(int p, int n) { return n ^ ((p & 3) << 3); }

template <int HH, int KC, typename TS>
__global__ void __launch_bounds__(32 * kAWarps, 1)
naf_stage_a_kernel(const TS* __restrict__ x, const float* __restrict__ lnw,
                   const float* __restrict__ lnb, const float4* __restrict__ w1p,
                   const float* __restrict__ b1, const float* __restrict__ wdw,
                   const float* __restrict__ bdw, TS* __restrict__ g,
                   float* __restrict__ part, int H, int W, int C, int Cp) {
    constexpr int P = kPasses<TS>;
    constexpr int M = kHaloW * HH, TH = HH - 2;    // product rows, output rows
    constexpr int NG = kAWarps / HH, NTW = 8 / NG;  // warps an m-tile, n-tiles a warp
    constexpr int KS = KC / 8, kStage4 = KS * 8 * 32;   // k-steps, float4s of a ring stage
    extern __shared__ float4 smem4[];
    float* A = reinterpret_cast<float*>(smem4);    // [M x Cp] LN(x), A-fragment order
    float* T = A + M * Cp;                          // [M][64] t of the pass, swizzled
    float4* ring = reinterpret_cast<float4*>(T + M * kPassN);   // 2 stages of w1p
    float* red = reinterpret_cast<float*>(ring + 2 * kStage4);  // [16][32] partial sums

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int bi = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * kOutW;
    const TS* xb = x + (size_t)bi * H * W * C;
    const int ksteps = Cp / 8, nchunks = (ksteps + KS - 1) / KS, ntw = Cp / 4;
    const int total = Cp / kPassC * nchunks;        // (pass, chunk) steps
    auto live = [&](int p) {   // halo row p inside the image
        const int y = ty0 - 1 + p / kHaloW, xx = tx0 - 1 + p % kHaloW;
        return y >= 0 && y < H && xx >= 0 && xx < W;
    };
    auto stage = [&](int i) {   // step i's chunk into stage i % 2; an empty group past the end
        if (i < total) {
            const int pass = i / nchunks, ks0 = i % nchunks * KS, nks = min(KS, ksteps - ks0);
            float4* dst = ring + (i & 1) * kStage4;
            for (int e = tid; e < nks * 256; e += 32 * kAWarps)   // [k-step][8 n-tiles][32]
                cp_async16(reinterpret_cast<float*>(dst + e),
                           reinterpret_cast<const float*>(
                               w1p + ((size_t)(ks0 + (e >> 8)) * ntw + 8 * pass) * 32 + (e & 255)));
        }
        cp_async_commit();
    };
    stage(0);

    // LN(x) of the halo, a warp a row, the rows in registers: every load of the warp's rows
    // is issued before the first row is normalised (one round trip to memory, not one a row)
    constexpr int RPW = M / kAWarps;        // halo rows a warp normalises
    constexpr int NH = HH == 16 ? 1 : 2;    // float4s a lane: HH = 16 takes Cp <= 128, 8 Cp <= 256
    float4 v[RPW][NH];
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
        const int p = warp + kAWarps * k;
        const int y = ty0 - 1 + p / kHaloW, xx = tx0 - 1 + p % kHaloW;
        const bool in = live(p);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
            const int c = 4 * lane + 128 * h;
            v[k][h] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (in && c < C)
                v[k][h] = ld4(xb + ((size_t)y * W + xx) * C + c);
        }
    }
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
        const int p = warp + kAWarps * k;
        float sum = 0.f;
#pragma unroll
        for (int h = 0; h < NH; ++h) sum += (v[k][h].x + v[k][h].y) + (v[k][h].z + v[k][h].w);
        const float u = warp_sum(sum) / C;
        float q = 0.f;
#pragma unroll
        for (int h = 0; h < NH; ++h)
            if (4 * lane + 128 * h < C) {
                const float4 d = make_float4(v[k][h].x - u, v[k][h].y - u, v[k][h].z - u,
                                             v[k][h].w - u);
                q = fmaf(d.x, d.x, fmaf(d.y, d.y, fmaf(d.z, d.z, fmaf(d.w, d.w, q))));
            }
        const float inv = 1.f / sqrtf(warp_sum(q) / C + kEps);
        const bool in = live(p);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
            const int c = 4 * lane + 128 * h;
            if (c >= Cp) continue;
            float4 o = make_float4(0.f, 0.f, 0.f, 0.f);   // and on Cp's padded channels
            if (in && c < C) {
                const float4 w = *reinterpret_cast<const float4*>(lnw + c);
                const float4 b = *reinterpret_cast<const float4*>(lnb + c);
                o = make_float4((v[k][h].x - u) * inv * w.x + b.x,
                                (v[k][h].y - u) * inv * w.y + b.y,
                                (v[k][h].z - u) * inv * w.z + b.z,
                                (v[k][h].w - u) * inv * w.w + b.w);
            }
            put4(A, p, c, ksteps, o);
        }
    }

    const int nblk = gridDim.x * gridDim.y, blk = blockIdx.y * gridDim.x + blockIdx.x;
    const int g8 = lane >> 2, t4 = lane & 3;
    const int mt = warp % HH, nt0 = warp / HH * NTW;
    const float4* a4 = reinterpret_cast<const float4*>(A) + mt * ksteps * 32 + lane;
    for (int pass = 0, i = 0; pass < Cp / kPassC; ++pass) {
        const int cb = pass * kPassC;
        for (int c = 0; c < nchunks; ++c, ++i) {
            cp_async_wait<0>();   // this thread's copies of step i have landed
            // step i's chunk (and A) visible to every thread, and every thread is past step
            // i - 1: its stage may be refilled, and the last pass's T and red are read
            __syncthreads();
            stage(i + 1);
            float pt[NTW][4];   // the chunk's product
#pragma unroll
            for (int j = 0; j < NTW; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) pt[j][r] = 0.f;
            const float4* wc = ring + (i & 1) * kStage4 + nt0 * 32 + lane;
            const int nks = min(KS, ksteps - c * KS);
#pragma unroll
            for (int s = 0; s < KS; ++s) {
                if (s >= nks) break;
                Frag<4, P> a;
                const float4 v = a4[(c * KS + s) * 32];
                a.set(0, v.x);
                a.set(1, v.y);
                a.set(2, v.z);
                a.set(3, v.w);
                // four n-tiles at a time: the three terms of every tile interleaved, the
                // small ones first
#pragma unroll
                for (int j0 = 0; j0 < NTW; j0 += 4) {
                    uint32_t bh[4][2], bl[4][2];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float4 b = wc[(s * 8 + j0 + j) * 32];
                        bh[j][0] = __float_as_uint(b.x);
                        bh[j][1] = __float_as_uint(b.y);
                        bl[j][0] = __float_as_uint(b.z);
                        bl[j][1] = __float_as_uint(b.w);
                    }
                    if constexpr (P == 3) {
#pragma unroll
                        for (int j = 0; j < 4; ++j) mma_tf32(pt[j0 + j], a.lo, bh[j]);
#pragma unroll
                        for (int j = 0; j < 4; ++j) mma_tf32(pt[j0 + j], a.hi, bl[j]);
                    }
#pragma unroll
                    for (int j = 0; j < 4; ++j) mma_tf32(pt[j0 + j], a.hi, bh[j]);
                }
            }
            // the chunks' sum in T, in f32 (each (p, n) by the thread that owns it in every
            // chunk), then t = sum + b1, 0 on a halo pixel outside the image
            const bool first = c == 0, last = c + 1 == nchunks;
#pragma unroll
            for (int j = 0; j < NTW; ++j) {
                const int n = 8 * (nt0 + j) + 2 * t4;
                // its channel of b1; a padded gate channel (>= C) reads a real one's bias:
                // its t feeds only its own conv and gate, which are never stored
                const int ch = min(n < kPassC ? cb + n : C + cb + n - kPassC, 2 * C - 2);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int p = 16 * mt + g8 + 8 * h;
                    float2* tp = reinterpret_cast<float2*>(T + p * kPassN + t_col(p, n));
                    float2 v = make_float2(pt[j][2 * h], pt[j][2 * h + 1]);
                    if (!first) {
                        const float2 s = *tp;
                        v = make_float2(s.x + v.x, s.y + v.y);
                    }
                    if (last) {
                        const float2 bb = *reinterpret_cast<const float2*>(b1 + ch);
                        v = live(p) ? make_float2(v.x + bb.x, v.y + bb.y) : make_float2(0.f, 0.f);
                    }
                    *tp = v;
                }
            }
        }
        __syncthreads();   // T complete

        // depthwise 3x3 + bias on both halves, then the gate: channel cb + lane, output
        // column `warp`, the window sliding down the tile
        const int ch = cb + lane, cw = min(ch, C - 1);   // a padded channel: not stored
        float psum = 0.f;
        float wa[9], wb[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
            wa[k] = wdw[k * 2 * C + cw];
            wb[k] = wdw[k * 2 * C + C + cw];
        }
        const float ba = bdw[cw], bb = bdw[C + cw];
        if (const int ox = warp; ox < kOutW) {
            float ra[3][3] = {}, rb[3][3] = {};   // the taps of rows r - 2, r - 1, r
            // rolled: unrolled, the loads of all HH rows would be hoisted, and spill
#pragma unroll 1
            for (int r = 0; r < HH; ++r) {
#pragma unroll
                for (int dx = 0; dx < 3; ++dx) {
                    ra[0][dx] = ra[1][dx];
                    ra[1][dx] = ra[2][dx];
                    rb[0][dx] = rb[1][dx];
                    rb[1][dx] = rb[2][dx];
                    const int p = r * kHaloW + ox + dx;
                    ra[2][dx] = T[p * kPassN + t_col(p, lane)];
                    rb[2][dx] = T[p * kPassN + t_col(p, kPassC + lane)];
                }
                if (r < 2) continue;
                float a = 0.f, b = 0.f;
#pragma unroll
                for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                    for (int dx = 0; dx < 3; ++dx) {
                        a = fmaf(ra[dy][dx], wa[dy * 3 + dx], a);
                        b = fmaf(rb[dy][dx], wb[dy * 3 + dx], b);
                    }
                const float gv = (a + ba) * (b + bb);
                const int y = ty0 + r - 2, xx = tx0 + ox;
                if (y < H && xx < W && ch < C) {
                    st1(g + (((size_t)bi * H + y) * W + xx) * C + ch, gv);
                    psum += gv;
                }
            }
        }
        red[warp * 32 + lane] = psum;
        __syncthreads();
        if (tid < 32 && cb + tid < C) {
            float s = 0.f;
            for (int w = 0; w < kOutW; ++w) s += red[w * 32 + tid];
            part[((size_t)bi * nblk + blk) * C + cb + tid] = s;
        }
        // the next step's barrier comes before anything writes T or red again
    }
    cp_async_wait<0>();
}

template <int HH, int KC, typename T>
cudaError_t launch_stage_a(const T* x, const float* lnw, const float* lnb,
                           const float* w1p, const float* b1, const float* wdw,
                           const float* bdw, T* g, float* part, int B, int H, int W, int C,
                           cudaStream_t st) {
    const int Cp = (C + kPassC - 1) / kPassC * kPassC;
    const size_t smem = (size_t)(kHaloW * HH * (Cp + kPassN) + 2 * KC * 128 + kAWarps * 32) *
                        sizeof(float);
    if (smem > 232448) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(naf_stage_a_kernel<HH, KC, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((W + kOutW - 1) / kOutW, (H + HH - 3) / (HH - 2), B);
    naf_stage_a_kernel<HH, KC, T><<<grid, 32 * kAWarps, smem, st>>>(
        x, lnw, lnb, reinterpret_cast<const float4*>(w1p), b1, wdw, bdw, g, part, H, W, C, Cp);
    return cudaGetLastError();
}

// ---- Stage B
template <typename T>
struct StageB {
    const T *g, *x, *att;         // [npix][C], [npix][C], [B][C]
    const float4 *w3, *w4, *w5;   // mma_planes: w3, w5 [C][C]; w4 [C][2C], gate-interleaved
    const float *b3, *beta, *ln2w, *ln2b, *b4, *b5, *gamma;
    T* out;        // [npix][C]
    float* y;      // [npix][C] y between the products in the device-memory design: out
                   // itself for f32, f32 scratch for bf16 (y stays f32, as in the TPU kernel)
    float* hid;    // [npix][C] the gated hidden (device-memory design)
    float* part;   // [npix][2C] sums over K pieces (device-memory design, C > kMmaMaxK)
    long long npix;
    int hw, C, Cp;   // C: the channels (stride of every array); Cp: C rounded up to 8
};

// Where column c of row p of y sits in the on-chip design's [128][64] buffer: its 8-column
// group XOR-ed with p % 4, so that the epilogue's float2 accesses (8 rows, 4 threads a row)
// fall on the 32 banks twice, the least for 8 bytes a thread; c's 4-aligned groups stay whole
__device__ __forceinline__ int y_col(int p, int c) { return c ^ ((p & 3) << 3); }

// C = 64: everything on chip. A (g * att, then LN2(y)), y and the gated hidden sit in
// shared memory beside the ring (3 x 32 KB + 128 KB): the block reads g and x once and
// writes out once.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads, 1)
naf_stage_b_onchip_kernel(const StageB<T> a) {
    constexpr int C = 64, KS = C / 8, C4 = C / 4, P = kPasses<T>;
    extern __shared__ float4 smem4[];
    float* A = reinterpret_cast<float*>(smem4);   // [128 x C] A-fragment order
    float* Hs = A + kMmaRows * C;                  // [128 x C] the hidden, A-fragment order
    float* Y = Hs + kMmaRows * C;                  // [128][C] y, swizzled (y_col)
    float* ws = Y + kMmaRows * C;                  // tile_mma's ring
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long p0 = (long long)blockIdx.x * kMmaRows;

    // y = x + ((g * att) @ w3 + b3) * beta: x staged in Y, g * att in A
    tile_mma<P>(
        A, C, a.w3, C / 8, C, ws,
        [&] {
            for (int e = tid; e < kMmaRows * C4; e += kMmaThreads) {
                const int p = e / C4, c = (e % C4) * 4;
                const long long gp = p0 + p;
                float4 u = make_float4(0.f, 0.f, 0.f, 0.f), v = u;
                if (gp < a.npix) {
                    const float4 gv = ld4(a.g + gp * C + c);
                    const float4 av = ld4(a.att + (gp / a.hw) * C + c);
                    u = make_float4(gv.x * av.x, gv.y * av.y, gv.z * av.z, gv.w * av.w);
                    v = ld4(a.x + gp * C + c);
                }
                put4(A, p, c, KS, u);
                *reinterpret_cast<float4*>(Y + p * C + y_col(p, c)) = v;
            }
        },
        [&](int p, int n, float u0, float u1) {
            float2* yp = reinterpret_cast<float2*>(Y + p * C + y_col(p, n));
            const float2 xv = *yp;
            *yp = make_float2(xv.x + (u0 + a.b3[n]) * a.beta[n],
                              xv.y + (u1 + a.b3[n + 1]) * a.beta[n + 1]);
        });
    // h = SimpleGate(LN2(y) @ w4 + b4): LN2 a warp a row (two floats a lane) into A; gate
    // channel j and its partner are columns 2j, 2j + 1, so the gate is one thread's pair
    tile_mma<P>(
        A, C, a.w4, 2 * C / 8, 2 * C, ws,
        [&] {
            for (int p = warp; p < kMmaRows; p += kMmaThreads / 32) {
                const int c = 2 * lane;
                const float2 v = *reinterpret_cast<const float2*>(Y + p * C + y_col(p, c));
                const float u = warp_sum(v.x + v.y) / C;
                const float dx = v.x - u, dy = v.y - u;
                const float inv = 1.f / sqrtf(warp_sum(fmaf(dx, dx, dy * dy)) / C + kEps);
                const int i = a_frag_index(p, c, KS);   // column c + 1 sits 4 floats on
                A[i] = dx * inv * a.ln2w[c] + a.ln2b[c];
                A[i + 4] = dy * inv * a.ln2w[c + 1] + a.ln2b[c + 1];
            }
        },
        [&](int p, int n, float u0, float u1) {
            const int j = n >> 1;
            Hs[a_frag_index(p, j, KS)] = (u0 + a.b4[j]) * (u1 + a.b4[C + j]);
        });
    // out = y + (h @ w5 + b5) * gamma
    tile_mma<P>(
        Hs, C, a.w5, C / 8, C, ws, [] {},
        [&](int p, int n, float u0, float u1) {
            const long long gp = p0 + p;
            if (gp >= a.npix) return;
            const float2 y = *reinterpret_cast<const float2*>(Y + p * C + y_col(p, n));
            st2(a.out + gp * C + n, make_float2(y.x + (u0 + a.b5[n]) * a.gamma[n],
                                                y.y + (u1 + a.b5[n + 1]) * a.gamma[n + 1]));
        });
}

// C != 64 (and C = 64 when the caller gives hid): A (128 rows of one K piece: 64 KB at
// C = 128 and 256) and the ring fill the block. y is parked in out, the gated hidden goes
// through hid and, where K comes in pieces (Cp > kMmaMaxK), the products' partial sums through
// part, whose rows are 2Cp floats for every product: each element is read back by the thread
// that wrote it, mostly from L2, and no block touches another's rows. The products take K and
// N in steps of 8: a C that is not a multiple of 8 runs them at Cp = C rounded up, on weights
// zero-padded to Cp (ops/kernels/nafblock.py), A's columns past C staged as zeros and no
// column past C stored; every array keeps its stride C and LN2 its statistics over C.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads, 1)
naf_stage_b_rows_kernel(const StageB<T> a) {
    extern __shared__ float4 smem4[];
    constexpr int P = kPasses<T>;
    const int C = a.C, Cp = a.Cp, Kt = tile_mma_piece(Cp);
    float* A = reinterpret_cast<float*>(smem4);   // [128 x Kt] A-fragment order
    float* ws = A + kMmaRows * Kt;                 // tile_mma's ring
    float* lnst = ws + tile_mma_ws();              // [128][2] LN2's mean and 1/std
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long p0 = (long long)blockIdx.x * kMmaRows;

    // A = columns k0 .. k0 + kh of f(p, gp, c) (float4s), zero past the last pixel and past
    // column C (C % 4 == 0: a float4 is all real or all padding)
    auto stage = [&](int k0, int kh, auto f) {
        const int k4 = kh / 4, ks = kh / 8;
#pragma unroll 4
        for (int e = tid; e < kMmaRows * k4; e += kMmaThreads) {
            const int p = e / k4, c = (e % k4) * 4;
            const long long gp = p0 + p;
            put4(A, p, c, ks, gp < a.npix && k0 + c < C ? f(p, gp, k0 + c)
                                                        : make_float4(0.f, 0.f, 0.f, 0.f));
        }
    };
    // (u0, u1) at (gp, n) plus the earlier K pieces' sums, added in f32 in a fixed order:
    // true at the last piece; before it the sum is parked in part (rows of 2Cp floats)
    auto summed = [&](long long gp, int n, int k0, int kh, float& u0, float& u1) {
        if (kh == Cp) return true;
        float2* pp = reinterpret_cast<float2*>(a.part + gp * 2 * Cp + n);
        if (k0 > 0) {
            const float2 s = *pp;
            u0 += s.x;
            u1 += s.y;
        }
        if (k0 + kh == Cp) return true;
        *pp = make_float2(u0, u1);
        return false;
    };

    // y = x + ((g * att) @ w3 + b3) * beta, into y (out, or its f32 scratch)
    for (int k0 = 0; k0 < Cp; k0 += Kt) {
        const int kh = min(Kt, Cp - k0);
        tile_mma<P>(
            A, kh, a.w3 + (size_t)(k0 / 8) * (Cp / 8) * 32, Cp / 8, Cp, ws,
            [&] {
                stage(k0, kh, [&](int, long long gp, int c) {
                    const float4 gv = ld4(a.g + gp * C + c);
                    const float4 av = ld4(a.att + (gp / a.hw) * C + c);
                    return make_float4(gv.x * av.x, gv.y * av.y, gv.z * av.z, gv.w * av.w);
                });
            },
            [&](int p, int n, float u0, float u1) {
                const long long gp = p0 + p;
                if (gp >= a.npix || n >= C || !summed(gp, n, k0, kh, u0, u1)) return;
                const float2 xv = ld2(a.x + gp * C + n);
                *reinterpret_cast<float2*>(a.y + gp * C + n) =
                    make_float2(xv.x + (u0 + a.b3[n]) * a.beta[n],
                                xv.y + (u1 + a.b3[n + 1]) * a.beta[n + 1]);
            });
    }
    // LN2's statistics, a warp a row (tile_mma synchronised: y holds the block's y)
    for (int p = warp; p < kMmaRows; p += kMmaThreads / 32) {
        const long long gp = p0 + p;
        float u = 0.f, inv = 0.f;
        if (gp < a.npix) warp_ln_stats(a.y + gp * C, C, kEps, u, inv);
        if (lane == 0) {
            lnst[2 * p] = u;
            lnst[2 * p + 1] = inv;
        }
    }
    // h = SimpleGate(LN2(y) @ w4 + b4), into hid: gate channel j and its partner are
    // columns 2j, 2j + 1 of the product, one thread's pair
    for (int k0 = 0; k0 < Cp; k0 += Kt) {
        const int kh = min(Kt, Cp - k0);
        tile_mma<P>(
            A, kh, a.w4 + (size_t)(k0 / 8) * (2 * Cp / 8) * 32, 2 * Cp / 8, 2 * Cp, ws,
            [&] {
                stage(k0, kh, [&](int p, long long gp, int c) {
                    const float4 v = ld4(a.y + gp * C + c);
                    const float4 w = ld4(a.ln2w + c), b = ld4(a.ln2b + c);
                    const float u = lnst[2 * p], inv = lnst[2 * p + 1];
                    return make_float4((v.x - u) * inv * w.x + b.x, (v.y - u) * inv * w.y + b.y,
                                       (v.z - u) * inv * w.z + b.z, (v.w - u) * inv * w.w + b.w);
                });
            },
            [&](int p, int n, float u0, float u1) {
                const long long gp = p0 + p;
                if (gp >= a.npix || n >= 2 * C || !summed(gp, n, k0, kh, u0, u1)) return;
                const int j = n >> 1;
                a.hid[gp * C + j] = (u0 + a.b4[j]) * (u1 + a.b4[C + j]);
            });
    }
    // out = y + (h @ w5 + b5) * gamma
    for (int k0 = 0; k0 < Cp; k0 += Kt) {
        const int kh = min(Kt, Cp - k0);
        tile_mma<P>(
            A, kh, a.w5 + (size_t)(k0 / 8) * (Cp / 8) * 32, Cp / 8, Cp, ws,
            [&] {
                stage(k0, kh, [&](int, long long gp, int c) { return ld4(a.hid + gp * C + c); });
            },
            [&](int p, int n, float u0, float u1) {
                const long long gp = p0 + p;
                if (gp >= a.npix || n >= C || !summed(gp, n, k0, kh, u0, u1)) return;
                const float2 y = ld2(a.y + gp * C + n);
                st2(a.out + gp * C + n, make_float2(y.x + (u0 + a.b5[n]) * a.gamma[n],
                                                    y.y + (u1 + a.b5[n + 1]) * a.gamma[n + 1]));
            });
    }
}

template <typename T>
cudaError_t launch_stage_b(const StageB<T>& a, cudaStream_t st) {
    const bool onchip = a.C == 64 && !a.hid;
    const size_t smem = (size_t)(onchip ? 3 * kMmaRows * 64 + tile_mma_ws()
                                        : kMmaRows * tile_mma_piece(a.Cp) + tile_mma_ws() +
                                              2 * kMmaRows) * sizeof(float);
    const auto kernel = onchip ? naf_stage_b_onchip_kernel<T> : naf_stage_b_rows_kernel<T>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long nblocks = (a.npix + kMmaRows - 1) / kMmaRows;
    if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    kernel<<<(unsigned)nblocks, kMmaThreads, smem, st>>>(a);
    return cudaGetLastError();
}

template <typename T>
cudaError_t stage_a(const T* x, const float* lnw, const float* lnb, const float* w1p,
                    const float* b1, const float* wdw, const float* bdw, T* g, float* part,
                    int B, int H, int W, int C, int hh, cudaStream_t st) {
    if (hh == 8)
        return launch_stage_a<8, 32>(x, lnw, lnb, w1p, b1, wdw, bdw, g, part, B, H, W, C, st);
    if (C <= 64)   // the pass's whole slab (Cp <= 64 rows) a ring stage: one barrier a pass
        return launch_stage_a<16, 64>(x, lnw, lnb, w1p, b1, wdw, bdw, g, part, B, H, W, C, st);
    return launch_stage_a<16, 32>(x, lnw, lnb, w1p, b1, wdw, bdw, g, part, B, H, W, C, st);
}

template <typename T>
cudaError_t stage_b(const float* g, const float* x, const float* att, const float* w3p,
                    const float* b3, const float* beta, const float* ln2w, const float* ln2b,
                    const float* w4p, const float* b4, const float* w5p, const float* b5,
                    const float* gamma, float* out, float* y, float* hid, float* part, int B,
                    int H, int W, int C, cudaStream_t st) {
    StageB<T> a = {};
    a.g = reinterpret_cast<const T*>(g);
    a.x = reinterpret_cast<const T*>(x);
    a.att = reinterpret_cast<const T*>(att);
    a.w3 = reinterpret_cast<const float4*>(w3p);
    a.w4 = reinterpret_cast<const float4*>(w4p);
    a.w5 = reinterpret_cast<const float4*>(w5p);
    a.b3 = b3; a.beta = beta; a.ln2w = ln2w; a.ln2b = ln2b; a.b4 = b4; a.b5 = b5;
    a.gamma = gamma; a.out = reinterpret_cast<T*>(out); a.hid = hid; a.part = part;
    a.y = y ? y : out;
    a.npix = (long long)B * H * W; a.hw = H * W; a.C = C; a.Cp = (C + 7) / 8 * 8;
    return launch_stage_b(a, st);
}

}  // namespace

extern "C" {

// Number of stage-A blocks per image on the current device: the length of the partial-sum
// scratch's middle axis; -1 where the device cannot be queried.
int naf_stage_a_blocks(int B, int H, int W, int C) {
    const int hh = stage_a_rows(B, H, W, C);
    if (hh == 0) return -1;
    return ((H + hh - 3) / (hh - 2)) * ((W + kOutW - 1) / kOutW);
}

// g and sums = Σ_{H,W} g; w1p = the mma_planes of w1 [C][2C] zero-padded to [Cp][2Cp] (Cp =
// C rounded up to 32) with its columns pass by pass (ops/kernels/nafblock.py), part
// [B][naf_stage_a_blocks][C] scratch. x and g are f32, or bf16 where `bf16` is set; the
// weights and the sums are f32 (the sums are taken of g before its rounding).
int naf_stage_a(const float* x, const float* lnw, const float* lnb, const float* w1p,
                const float* b1, const float* wdw, const float* bdw, float* g, float* part,
                float* sums, int B, int H, int W, int C, int bf16_io, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (C % 4 || C < 4 || C > 256 || B < 1 || B > 65535 || H < 1 || W < 1)
        return cudaErrorInvalidValue;
    const int hh = stage_a_rows(B, H, W, C);
    if (hh == 0) return cudaErrorInvalidDevice;
    const cudaError_t err =
        bf16_io ? stage_a(reinterpret_cast<const bf16*>(x), lnw, lnb, w1p, b1, wdw, bdw,
                          reinterpret_cast<bf16*>(g), part, B, H, W, C, hh, st)
                : stage_a(x, lnw, lnb, w1p, b1, wdw, bdw, g, part, B, H, W, C, hh, st);
    if (err != cudaSuccess) return err;
    return sum_partials(part, sums, B, naf_stage_a_blocks(B, H, W, C), C, st);
}

// out = stage B of g and x; w3p, w4p, w5p the mma_planes of w3, of w4 with gate channel j in
// column 2j and its partner C + j in 2j + 1, and of w5, each zero-padded to Cp = C rounded up
// to 8 (ops/kernels/nafblock.py: stage_b_planes); hid [B*H*W][C] scratch where C != 64, part
// [B*H*W][2Cp] where Cp > 192. C % 4 == 0. At C = 64 the block keeps y and the hidden on chip
// unless hid is given: then it takes the device-memory design of the other widths (so that
// the two can be timed and tested). g, x, att and out are f32, or bf16 where `bf16_io` is
// set: then y [B*H*W][C] is f32 scratch where hid is given (y stays f32 between the
// products, as in the TPU kernel), and hid is f32 in both.
int naf_stage_b(const float* g, const float* x, const float* att, const float* w3p,
                const float* b3, const float* beta, const float* ln2w, const float* ln2b,
                const float* w4p, const float* b4, const float* w5p, const float* b5,
                const float* gamma, float* out, float* y, float* hid, float* part, int B,
                int H, int W, int C, int bf16_io, void* stream) {
    const int Cp = (C + 7) / 8 * 8;
    if (C % 4 || C < 4 || B < 1 || H < 1 || W < 1 || (C != 64 && !hid) ||
        (Cp > kMmaMaxK && !part) || (bf16_io && hid && !y))
        return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bf16_io)
        return stage_b<bf16>(g, x, att, w3p, b3, beta, ln2w, ln2b, w4p, b4, w5p, b5, gamma,
                             out, y, hid, part, B, H, W, C, st);
    return stage_b<float>(g, x, att, w3p, b3, beta, ln2w, ln2b, w4p, b4, w5p, b5, gamma, out,
                          nullptr, hid, part, B, H, W, C, st);
}

}  // extern "C"
