// The fusion head's per-pixel band attention as one hand-written f32 kernel for Hopper
// (sm_90a): pre-LayerNorm, the shared qkv projection, multi-head attention over the T band
// tokens of each pixel, the output projection and the residual,
//     out = x + softmax_heads((LN(x) wq + bq) * hd^-1/2 (LN(x) wk + bk)^T) (LN(x) wv + bv) wproj + bproj
// on x [pixels][T][D].
//
// Replaces the TPU kernel freqfusion_tpu/ops/pallas/bandmha.py:fused_band_mha. The plain
// PyTorch version sits beside the wrapper in freqfusion_tpu_torch/ops/kernels/bandmha.py.
//
// What bounds it on the H100. Per pixel at T = 9, D = 64, 4 heads: 2*9*64*(192 + 64) FLOPs of
// projections and 2*(4*81*16*2) of attention, 316 k, for 2*9*64*4 = 4.6 KB moved: 69 FLOP
// per byte, above the f32 CUDA-core ridge (20): bound by operations, the two products.
//
// Design. The TPU kernel keeps a 576-lane row per pixel and does the 9 x 9 attention with
// 0/1 mask matmuls and one max per row; that is the TPU's lane layout, not the function.
// Here the token rows are what the products tile: a block owns 128 / T whole pixels (14 at
// T = 9: 126 of its 128 rows), so that every token of a pixel lies in the block.
//   1. one warp per row: LN statistics in f32, the normalised row into A [128][68];
//   2. k and v: A x wkv through tile_matmul_interleaved (common.cuh, 8 interleaved rows a
//      thread) into KV [128][132], k in columns 0..D, v in columns 64..64+D;
//   3. q: A x wq, scaled, written over A in place: a one-pass product has read all of A
//      when its epilogue runs;
//   4. attention: one thread per (pixel, query, head) keeps its q in registers, takes the T
//      scores as dot products of length hd with a running max and sum (no score leaves the
//      registers), adds p * v, and writes the head's output over its own q;
//   5. out: A x wproj, + bproj + x, stored. x is read a second time here, out of L2.
// 108 KB of shared memory: two blocks an SM. D may be any multiple of 16 up to 64 and hd
// 8, 16 or 32: the wrapper zero-pads the weights' columns to the 64-column passes.
//
// Layout: f32, contiguous. wq [D][64], wkv [D][128], wproj [D][64] as [in][out], padded.

#include "common.cuh"

namespace {

constexpr int kRows = 128, kTM = kRows / 16;   // token rows per block, rows per thread
constexpr int kDP = 64;                        // widest D, and the padded width
constexpr int kLdA = kDP + 4, kLdKV = 2 * kDP + 4;
constexpr float kEps = 1e-5f;

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
band_mha_kernel(const float* __restrict__ x, const float* __restrict__ wq,
                const float* __restrict__ bq, const float* __restrict__ wkv,
                const float* __restrict__ bkv, const float* __restrict__ wproj,
                const float* __restrict__ bproj, const float* __restrict__ lnw,
                const float* __restrict__ lnb, float* __restrict__ out, long long npix, int T,
                int D, float scale) {
    extern __shared__ float4 smem4[];
    float* A = reinterpret_cast<float*>(smem4);   // [kRows][kLdA]: LN(x), then q, then heads
    float* KV = A + kRows * kLdA;                  // [kRows][kLdKV]
    float* ws = KV + kRows * kLdKV;                // tile_matmul_interleaved's weight stage
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int P = kRows / T;                       // whole pixels per block
    const long long pix0 = (long long)blockIdx.x * P;
    const int npx = (int)min((long long)P, npix - pix0);
    const int nrows = npx * T;
    const long long row0 = pix0 * T;

    for (int r = warp; r < kRows; r += kThreads / 32) {
        float* ar = A + r * kLdA;
        if (r < nrows) {
            warp_layernorm(x + (row0 + r) * D, ar, lnw, lnb, D, kEps);
        } else {
            for (int c = lane; c < kDP; c += 32) ar[c] = 0.f;
        }
    }
    // tile_matmul_interleaved synchronises before it reads A
    tile_matmul_interleaved<kTM>(A, kLdA, D, wkv, 2 * kDP, 2 * kDP, ws,
                                 [&](int p, int n, float u) {
                                     KV[p * kLdKV + n] = u + bkv[n];
                                 });
    tile_matmul_interleaved<kTM>(A, kLdA, D, wq, kDP, kDP, ws,
                                 [&](int p, int n, float u) {
                                     A[p * kLdA + n] = (u + bq[n]) * scale;
                                 });
    __syncthreads();

    const int nh = D / HD;
    for (int it = tid; it < nrows * nh; it += kThreads) {
        const int h = it % nh, row = it / nh, pix = row / T;
        float* qp = A + row * kLdA + h * HD;
        float q[HD], acc[HD];
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
            const float4 v = *reinterpret_cast<const float4*>(qp + d);
            q[d] = v.x; q[d + 1] = v.y; q[d + 2] = v.z; q[d + 3] = v.w;
            acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
        }
        float m = -3.0e38f, l = 0.f;   // the first key's corr is exp(-3e38 - s) = 0
        const float* kv = KV + pix * T * kLdKV + h * HD;
        for (int j = 0; j < T; ++j, kv += kLdKV) {
            float s = 0.f;
#pragma unroll
            for (int d = 0; d < HD; d += 4) {
                const float4 k = *reinterpret_cast<const float4*>(kv + d);
                s = fmaf(q[d], k.x, s);
                s = fmaf(q[d + 1], k.y, s);
                s = fmaf(q[d + 2], k.z, s);
                s = fmaf(q[d + 3], k.w, s);
            }
            const float mn = fmaxf(m, s);
            const float corr = expf(m - mn), p = expf(s - mn);
            l = fmaf(l, corr, p);
#pragma unroll
            for (int d = 0; d < HD; d += 4) {
                const float4 v = *reinterpret_cast<const float4*>(kv + kDP + d);
                acc[d] = fmaf(acc[d], corr, p * v.x);
                acc[d + 1] = fmaf(acc[d + 1], corr, p * v.y);
                acc[d + 2] = fmaf(acc[d + 2], corr, p * v.z);
                acc[d + 3] = fmaf(acc[d + 3], corr, p * v.w);
            }
            m = mn;
        }
        const float inv = 1.f / l;
#pragma unroll
        for (int d = 0; d < HD; d += 4)
            *reinterpret_cast<float4*>(qp + d) = make_float4(
                acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
    }
    // tile_matmul_interleaved synchronises before it reads A
    tile_matmul_interleaved<kTM>(A, kLdA, D, wproj, kDP, kDP, ws,
                                 [&](int p, int n, float u) {
                                     if (p >= nrows || n >= D) return;
                                     const long long i = (row0 + p) * D + n;
                                     out[i] = u + bproj[n] + x[i];
                                 });
}

template <int HD>
cudaError_t launch(const float* x, const float* wq, const float* bq, const float* wkv,
                   const float* bkv, const float* wproj, const float* bproj, const float* lnw,
                   const float* lnb, float* out, long long npix, int T, int D,
                   cudaStream_t st) {
    const size_t smem =
        (size_t)(kRows * kLdA + kRows * kLdKV + tile_matmul_ws()) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        band_mha_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int P = kRows / T;
    const long long nblocks = (npix + P - 1) / P;
    if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    band_mha_kernel<HD><<<(unsigned)nblocks, kThreads, smem, st>>>(
        x, wq, bq, wkv, bkv, wproj, bproj, lnw, lnb, out, npix, T, D, 1.f / sqrtf((float)HD));
    return cudaGetLastError();
}

}  // namespace

extern "C" int band_mha(const float* x, const float* wq, const float* bq, const float* wkv,
                        const float* bkv, const float* wproj, const float* bproj,
                        const float* lnw, const float* lnb, float* out, long long npix, int T,
                        int D, int heads, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (npix < 1 || T < 1 || T > kRows || D < kKC || D > kDP || D % kKC || heads < 1 ||
        D % heads)
        return cudaErrorInvalidValue;
    switch (D / heads) {
        case 8:
            return launch<8>(x, wq, bq, wkv, bkv, wproj, bproj, lnw, lnb, out, npix, T, D, st);
        case 16:
            return launch<16>(x, wq, bq, wkv, bkv, wproj, bproj, lnw, lnb, out, npix, T, D, st);
        case 32:
            return launch<32>(x, wq, bq, wkv, bkv, wproj, bproj, lnw, lnb, out, npix, T, D, st);
        default:
            return cudaErrorInvalidValue;
    }
}
