// NAFBlock as two hand-written kernels for Hopper (sm_90a): stage A with its 1x1 product
// f32-exact on the tensor cores (3xTF32, mma_f32x3.cuh), stage B in f32 on CUDA cores.
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
// it there, the products at C = 256. Stage B's 4C^2 MACs run in f32 on CUDA cores (67
// TFLOP/s): FLOPs bound it.
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
// Stage B (B2), pointwise: g*att -> 1x1 (+b3) -> y = x + beta*(.) -> LN2 -> 1x1 C->2C (+b4)
// -> SimpleGate -> 1x1 (+b5) -> y + gamma*(.). A block owns 64 pixels (32 at C = 256, so
// that two blocks fit an SM) and keeps two P x C intermediates in shared memory; y goes
// to the output buffer and is read back from L1/L2 by LN2 and the final residual. The
// weights (about 1 MB at C = 256) stream through tile_matmul's stage (common.cuh), so each
// is read from L2 once per block. att = mean(g) @ W_sca + b_sca is a [B,C]x[C,C] product
// computed by the caller between the two stages.
//
// Layout: NHWC, f32, contiguous. Weights: w1p the mma_planes of w1 [C][2C] with its columns
// pass by pass; w4 [C][2C]; w3, w5 [C][C]; wdw [9][2C]. Stage A takes C % 32 == 0 up to 256,
// stage B C % 64 == 0 (the wrapper checks).

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
    if (C > 128) return 8;
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

template <int HH, int KC>
__global__ void __launch_bounds__(32 * kAWarps, 1)
naf_stage_a_kernel(const float* __restrict__ x, const float* __restrict__ lnw,
                   const float* __restrict__ lnb, const float4* __restrict__ w1p,
                   const float* __restrict__ b1, const float* __restrict__ wdw,
                   const float* __restrict__ bdw, float* __restrict__ g,
                   float* __restrict__ part, int H, int W, int C) {
    constexpr int M = kHaloW * HH, TH = HH - 2;    // product rows, output rows
    constexpr int NG = kAWarps / HH, NTW = 8 / NG;  // warps an m-tile, n-tiles a warp
    constexpr int KS = KC / 8, kStage4 = KS * 8 * 32;   // k-steps, float4s of a ring stage
    extern __shared__ float4 smem4[];
    float* A = reinterpret_cast<float*>(smem4);    // [M x C] LN(x), A-fragment order
    float* T = A + M * C;                           // [M][64] t of the pass, swizzled
    float4* ring = reinterpret_cast<float4*>(T + M * kPassN);   // 2 stages of w1p
    float* red = reinterpret_cast<float*>(ring + 2 * kStage4);  // [16][32] partial sums

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int bi = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * kOutW;
    const float* xb = x + (size_t)bi * H * W * C;
    const int ksteps = C / 8, nchunks = (ksteps + KS - 1) / KS, ntw = C / 4;
    const int total = C / kPassC * nchunks;         // (pass, chunk) steps
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
    constexpr int NH = HH == 16 ? 1 : 2;    // float4s a lane: HH = 16 takes C <= 128, 8 C <= 256
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
                v[k][h] = *reinterpret_cast<const float4*>(xb + ((size_t)y * W + xx) * C + c);
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
            if (c >= C) continue;
            float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
            if (in) {
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
    for (int pass = 0, i = 0; pass < C / kPassC; ++pass) {
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
                FragA a;
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
#pragma unroll
                    for (int j = 0; j < 4; ++j) mma_tf32(pt[j0 + j], a.lo, bh[j]);
#pragma unroll
                    for (int j = 0; j < 4; ++j) mma_tf32(pt[j0 + j], a.hi, bl[j]);
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
                const int ch = n < kPassC ? cb + n : C + cb + n - kPassC;
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
        const int ch = cb + lane;
        float psum = 0.f;
        float wa[9], wb[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
            wa[k] = wdw[k * 2 * C + ch];
            wb[k] = wdw[k * 2 * C + C + ch];
        }
        const float ba = bdw[ch], bb = bdw[C + ch];
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
                if (y < H && xx < W) {
                    g[(((size_t)bi * H + y) * W + xx) * C + ch] = gv;
                    psum += gv;
                }
            }
        }
        red[warp * 32 + lane] = psum;
        __syncthreads();
        if (tid < 32) {
            float s = 0.f;
            for (int w = 0; w < kOutW; ++w) s += red[w * 32 + tid];
            part[((size_t)bi * nblk + blk) * C + cb + tid] = s;
        }
        // the next step's barrier comes before anything writes T or red again
    }
    cp_async_wait<0>();
}

template <int HH, int KC>
cudaError_t launch_stage_a(const float* x, const float* lnw, const float* lnb,
                           const float* w1p, const float* b1, const float* wdw,
                           const float* bdw, float* g, float* part, int B, int H, int W, int C,
                           cudaStream_t st) {
    const size_t smem = (size_t)(kHaloW * HH * (C + kPassN) + 2 * KC * 128 + kAWarps * 32) *
                        sizeof(float);
    if (smem > 232448) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(naf_stage_a_kernel<HH, KC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((W + kOutW - 1) / kOutW, (H + HH - 3) / (HH - 2), B);
    naf_stage_a_kernel<HH, KC><<<grid, 32 * kAWarps, smem, st>>>(
        x, lnw, lnb, reinterpret_cast<const float4*>(w1p), b1, wdw, bdw, g, part, H, W, C);
    return cudaGetLastError();
}

// Stage B for blocks of 16 * TM pixels.
template <int TM>
__global__ void __launch_bounds__(kThreads)
naf_stage_b_kernel(const float* __restrict__ g, const float* __restrict__ x,
                   const float* __restrict__ att, const float* __restrict__ w3,
                   const float* __restrict__ b3, const float* __restrict__ beta,
                   const float* __restrict__ ln2w, const float* __restrict__ ln2b,
                   const float* __restrict__ w4, const float* __restrict__ b4,
                   const float* __restrict__ w5, const float* __restrict__ b5,
                   const float* __restrict__ gamma, float* __restrict__ out,
                   long long npix, int hw, int C) {
    constexpr int P = 16 * TM;
    extern __shared__ float4 smem4[];
    const int lda = C + 4;
    float* s0 = reinterpret_cast<float*>(smem4);  // [P][lda] g*att, then LN2(y)
    float* sh = s0 + P * lda;                      // [P][lda] gated FFN hidden
    float* ws = sh + P * lda;                      // tile_matmul's weight stage
    const long long p0 = (long long)blockIdx.x * P;

    const int c4n = C / 4;
    for (int e = threadIdx.x; e < P * c4n; e += kThreads) {
        const int p = e / c4n, c4 = (e % c4n) * 4;
        const long long gp = p0 + p;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gp < npix) {
            const float4 gv = *reinterpret_cast<const float4*>(g + gp * C + c4);
            const float4 av = *reinterpret_cast<const float4*>(att + (gp / hw) * C + c4);
            v = make_float4(gv.x * av.x, gv.y * av.y, gv.z * av.z, gv.w * av.w);
        }
        *reinterpret_cast<float4*>(s0 + p * lda + c4) = v;
    }
    // y goes to `out` (device memory, the block's own rows): it is read back by LN2 after
    // a barrier and by the last epilogue, whose thread for (p, n) is the one that wrote it
    tile_matmul<TM, false>(s0, lda, C, w3, C, C, 0, ws, [&](int p, int n, float a, float) {
        const long long gp = p0 + p;
        if (gp < npix) out[gp * C + n] = x[gp * C + n] + (a + b3[n]) * beta[n];
    });
    __syncthreads();
    for (int p = threadIdx.x >> 5; p < P; p += kThreads / 32)
        if (p0 + p < npix) warp_layernorm(out + (p0 + p) * C, s0 + p * lda, ln2w, ln2b, C, kEps);
    tile_matmul<TM, true>(s0, lda, C, w4, 2 * C, C, C, ws,
                          [&](int p, int n, float a, float b) {
                              sh[p * lda + n] = (a + b4[n]) * (b + b4[C + n]);
                          });
    tile_matmul<TM, false>(sh, lda, C, w5, C, C, 0, ws, [&](int p, int n, float a, float) {
        const long long gp = p0 + p;
        if (gp < npix) out[gp * C + n] += (a + b5[n]) * gamma[n];
    });
}

template <int TM>
cudaError_t launch_stage_b(const float* g, const float* x, const float* att, const float* w3,
                           const float* b3, const float* beta, const float* ln2w,
                           const float* ln2b, const float* w4, const float* b4,
                           const float* w5, const float* b5, const float* gamma, float* out,
                           int B, int H, int W, int C, cudaStream_t st) {
    constexpr int P = 16 * TM;
    const size_t smem = (size_t)(2 * P * (C + 4) + tile_matmul_ws(true)) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        naf_stage_b_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long npix = (long long)B * H * W;
    const unsigned nblocks = (unsigned)((npix + P - 1) / P);
    naf_stage_b_kernel<TM><<<nblocks, kThreads, smem, st>>>(
        g, x, att, w3, b3, beta, ln2w, ln2b, w4, b4, w5, b5, gamma, out, npix, H * W, C);
    return cudaGetLastError();
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

// g and sums = Σ_{H,W} g; w1p = the mma_planes of w1 [C][2C] with its columns pass by pass
// (ops/kernels/nafblock.py), part [B][naf_stage_a_blocks][C] scratch.
int naf_stage_a(const float* x, const float* lnw, const float* lnb, const float* w1p,
                const float* b1, const float* wdw, const float* bdw, float* g, float* part,
                float* sums, int B, int H, int W, int C, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (C % kPassC || C < kPassC || C > 256 || B < 1 || B > 65535 || H < 1 || W < 1)
        return cudaErrorInvalidValue;
    const int hh = stage_a_rows(B, H, W, C);
    if (hh == 0) return cudaErrorInvalidDevice;
    cudaError_t err;
    if (hh == 8)
        err = launch_stage_a<8, 32>(x, lnw, lnb, w1p, b1, wdw, bdw, g, part, B, H, W, C, st);
    else if (C <= 64)   // the pass's whole slab a ring stage: one barrier a pass
        err = launch_stage_a<16, 64>(x, lnw, lnb, w1p, b1, wdw, bdw, g, part, B, H, W, C, st);
    else
        err = launch_stage_a<16, 32>(x, lnw, lnb, w1p, b1, wdw, bdw, g, part, B, H, W, C, st);
    if (err != cudaSuccess) return err;
    return sum_partials(part, sums, B, naf_stage_a_blocks(B, H, W, C), C, st);
}

int naf_stage_b(const float* g, const float* x, const float* att, const float* w3,
                const float* b3, const float* beta, const float* ln2w, const float* ln2b,
                const float* w4, const float* b4, const float* w5, const float* b5,
                const float* gamma, float* out, int B, int H, int W, int C, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // 64-pixel blocks up to C = 128; 32 at C = 256 keeps two blocks in an SM's smem
    if (C <= 128)
        return launch_stage_b<4>(g, x, att, w3, b3, beta, ln2w, ln2b, w4, b4, w5, b5, gamma,
                                 out, B, H, W, C, st);
    return launch_stage_b<2>(g, x, att, w3, b3, beta, ln2w, ln2b, w4, b4, w5, b5, gamma, out,
                             B, H, W, C, st);
}

}  // extern "C"
