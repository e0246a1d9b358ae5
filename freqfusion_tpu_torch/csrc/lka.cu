// The Large-Kernel-Attention gate as three hand-written f32 kernels for Hopper (sm_90a),
// launched in sequence:
//     a   = dw21x1(dw1x21(dw5x5(x)))          each depthwise stage SAME, zero padding
//     out = x * sigmoid((a @ wp) * scale + shift)
//
// Replaces the TPU kernel freqfusion_tpu/ops/pallas/lka.py:lka_gate. The plain PyTorch
// version sits beside the wrapper in freqfusion_tpu_torch/ops/kernels/lka.py.
//
// What bounds it on the H100. Per element (25 + 21 + 21) * 2 + 2 * C FLOPs (262 at C = 64)
// for 8 bytes moved: 33 FLOP per byte, above the f32 CUDA-core ridge (20): bound by
// operations, about half of them the 1x1 product.
//
// Design. The TPU kernel holds a whole-width strip with a 12-row halo in VMEM through all
// four stages. A block here that did the same would recompute the 5x5 on 4.4 times its
// tile (a 16 x 32 tile has a 40 x 56 halo) and could not keep the tile's C-wide chain output
// beside it, so the chain is split where each stage needs another neighbourhood, and the
// intermediates go through device memory (4 extra passes over the tensor, 16 bytes an
// element, written down in the wrapper's note):
//   1. lka_dw5: t1 = dw5x5(x). A thread keeps one channel quad and its 25 weight quads in
//      registers and takes 4 neighbouring outputs along W at a time: 5 x 8 loads for 100 FMAs
//      on quads; the neighbours come back from L1 (tile 8 x 32 pixels). An item whose taps
//      all lie inside the image takes a path without bounds tests, so that its loads are in
//      flight together; only the border ring tests each tap.
//   2. lka_dwh: t2 = dw1x21(t1), the same with 24 loads for 84 FMAs.
//   3. lka_tail: the 21x1 down the columns of a 16 x 8 pixel tile (4 outputs along H at a
//      time, 24 loads for 84 FMAs) into shared memory [128][C + 4], then the 1x1 through
//      tile_matmul_interleaved (common.cuh), whose epilogue applies the folded BatchNorm
//      affine, the sigmoid and the product with x.
// The padding trap: every stage pads its own input with zeros, so the 5x5's output must be
// zero outside the image before the 1x21 runs (not the 5x5 of a zero-padded x continued
// outward), and the same for the 1x21's before the 21x1. Here t1 and t2 exist only inside
// the image and a tap that falls outside is skipped, which is that zero.
//
// Layout: NHWC, f32, contiguous; C % 4 == 0. w5 [25][C], wh [21][C] along W, wv [21][C]
// along H; wp [Kp][Np] as [in][out], zero-padded to the product's steps; out may be t1.

#include "common.cuh"

namespace {

constexpr int kTH = 8, kTW = 32;    // tile of the two first passes
constexpr int kNB = 4;              // outputs a thread takes at a time
constexpr int kK = 21, kR = kK / 2;
constexpr int kCH = 16, kCW = 8;    // tile of the tail: 128 pixels, 16 * kTM rows
constexpr int kTM = kCH * kCW / 16;

__device__ __forceinline__ void fma4(float4& a, const float4& v, const float4& w) {
    a.x = fmaf(v.x, w.x, a.x);
    a.y = fmaf(v.y, w.y, a.y);
    a.z = fmaf(v.z, w.z, a.z);
    a.w = fmaf(v.w, w.w, a.w);
}

// acc[o] += sum over the 5x5 taps of x around output (y, x0 + o), o < kNB, for one channel
// quad; `xq` points at that quad of the image's pixel (0, 0). With GUARD, taps outside the
// image are skipped (they are zeros); without, the caller has checked that none is.
template <bool GUARD>
__device__ __forceinline__ void dw5_item(const float* __restrict__ xq, const float4 (&wk)[25],
                                         float4 (&acc)[kNB], int y, int x0, int H, int W,
                                         int C) {
#pragma unroll
    for (int dy = 0; dy < 5; ++dy) {
        const int yy = y + dy - 2;
        if (GUARD && (yy < 0 || yy >= H)) continue;
        const float* row = xq + ((long long)yy * W + x0 - 2) * C;
#pragma unroll
        for (int i = 0; i < kNB + 4; ++i) {
            if (GUARD && (x0 + i - 2 < 0 || x0 + i - 2 >= W)) continue;
            const float4 v = *reinterpret_cast<const float4*>(row + (long long)i * C);
#pragma unroll
            for (int o = 0; o < kNB; ++o) {
                const int dx = i - o;
                if (dx >= 0 && dx < 5) fma4(acc[o], v, wk[dy * 5 + dx]);
            }
        }
    }
}

// acc[o] += sum over the 21 taps of a line through output o, o < kNB: `line` points at the
// channel quad of the first output's pixel, `step` floats lie between neighbours on the
// line, and the first output is element `p0` of a line of `n` elements.
template <bool GUARD>
__device__ __forceinline__ void dw21_item(const float* __restrict__ line, long long step,
                                          const float4 (&wk)[kK], float4 (&acc)[kNB], int p0,
                                          int n) {
#pragma unroll
    for (int i = 0; i < kNB + kK - 1; ++i) {
        if (GUARD && (p0 + i - kR < 0 || p0 + i - kR >= n)) continue;
        const float4 v = *reinterpret_cast<const float4*>(line + (i - kR) * step);
#pragma unroll
        for (int o = 0; o < kNB; ++o) {
            const int tap = i - o;
            if (tap >= 0 && tap < kK) fma4(acc[o], v, wk[tap]);
        }
    }
}

__global__ void __launch_bounds__(kThreads, 2)
lka_dw5_kernel(const float* __restrict__ x, const float* __restrict__ w5,
               float* __restrict__ t1, int H, int W, int C) {
    const int nq = C / 4, groups = kThreads / nq;
    const int tid = threadIdx.x, q = tid % nq, grp = tid / nq;
    if (grp >= groups) return;
    const int c = q * 4;
    float4 wk[25];
#pragma unroll
    for (int k = 0; k < 25; ++k) wk[k] = *reinterpret_cast<const float4*>(w5 + k * C + c);
    const int ty0 = blockIdx.y * kTH, tx0 = blockIdx.x * kTW;
    const size_t img = (size_t)blockIdx.z * H * W * C;
    const float* xq = x + img + c;
    float* ob = t1 + img + c;
    constexpr int XG = kTW / kNB;
    for (int it = grp; it < kTH * XG; it += groups) {
        const int y = ty0 + it / XG, x0 = tx0 + (it % XG) * kNB;
        if (y >= H || x0 >= W) continue;
        float4 acc[kNB];
#pragma unroll
        for (int o = 0; o < kNB; ++o) acc[o] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (y >= 2 && y + 2 < H && x0 >= 2 && x0 + kNB + 2 <= W)
            dw5_item<false>(xq, wk, acc, y, x0, H, W, C);
        else
            dw5_item<true>(xq, wk, acc, y, x0, H, W, C);
#pragma unroll
        for (int o = 0; o < kNB; ++o)
            if (x0 + o < W)
                *reinterpret_cast<float4*>(ob + ((size_t)y * W + x0 + o) * C) = acc[o];
    }
}

__global__ void __launch_bounds__(kThreads, 2)
lka_dwh_kernel(const float* __restrict__ t1, const float* __restrict__ wh,
               float* __restrict__ t2, int H, int W, int C) {
    const int nq = C / 4, groups = kThreads / nq;
    const int tid = threadIdx.x, q = tid % nq, grp = tid / nq;
    if (grp >= groups) return;
    const int c = q * 4;
    float4 wk[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) wk[k] = *reinterpret_cast<const float4*>(wh + k * C + c);
    const int ty0 = blockIdx.y * kTH, tx0 = blockIdx.x * kTW;
    const size_t img = (size_t)blockIdx.z * H * W * C;
    const float* iq = t1 + img + c;
    float* ob = t2 + img + c;
    constexpr int XG = kTW / kNB;
    for (int it = grp; it < kTH * XG; it += groups) {
        const int y = ty0 + it / XG, x0 = tx0 + (it % XG) * kNB;
        if (y >= H || x0 >= W) continue;
        float4 acc[kNB];
#pragma unroll
        for (int o = 0; o < kNB; ++o) acc[o] = make_float4(0.f, 0.f, 0.f, 0.f);
        const float* line = iq + ((size_t)y * W + x0) * C;
        if (x0 >= kR && x0 + kNB + kR <= W)
            dw21_item<false>(line, C, wk, acc, x0, W);
        else
            dw21_item<true>(line, C, wk, acc, x0, W);
#pragma unroll
        for (int o = 0; o < kNB; ++o)
            if (x0 + o < W)
                *reinterpret_cast<float4*>(ob + ((size_t)y * W + x0 + o) * C) = acc[o];
    }
}

__global__ void __launch_bounds__(kThreads, 2)
lka_tail_kernel(const float* __restrict__ t2, const float* __restrict__ x,
                const float* __restrict__ wv, const float* __restrict__ wp,
                const float* __restrict__ scale, const float* __restrict__ shift,
                float* __restrict__ out, int H, int W, int C, int Kp, int Np) {
    extern __shared__ float4 smem4[];
    const int lda = Kp + 4;
    float* A = reinterpret_cast<float*>(smem4);   // [kCH * kCW][lda]: the chain's output
    float* ws = A + kCH * kCW * lda;               // tile_matmul_interleaved's weight stage
    const int tid = threadIdx.x;
    const int ty0 = blockIdx.y * kCH, tx0 = blockIdx.x * kCW;
    const size_t img = (size_t)blockIdx.z * H * W * C;

    // zero the padded columns and the pixels outside the image
    for (int e = tid; e < kCH * kCW * lda / 4; e += kThreads)
        reinterpret_cast<float4*>(A)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();

    const int nq = C / 4, groups = kThreads / nq;
    const int q = tid % nq, grp = tid / nq;
    if (grp < groups) {
        const int c = q * 4;
        float4 wk[kK];
#pragma unroll
        for (int k = 0; k < kK; ++k) wk[k] = *reinterpret_cast<const float4*>(wv + k * C + c);
        const float* iq = t2 + img + c;
        for (int it = grp; it < kCW * (kCH / kNB); it += groups) {
            const int tx = it % kCW, yl = (it / kCW) * kNB;
            const int xx = tx0 + tx, y0 = ty0 + yl;
            if (xx >= W || y0 >= H) continue;
            float4 acc[kNB];
#pragma unroll
            for (int o = 0; o < kNB; ++o) acc[o] = make_float4(0.f, 0.f, 0.f, 0.f);
            const float* line = iq + ((size_t)y0 * W + xx) * C;
            if (y0 >= kR && y0 + kNB + kR <= H)
                dw21_item<false>(line, (long long)W * C, wk, acc, y0, H);
            else
                dw21_item<true>(line, (long long)W * C, wk, acc, y0, H);
#pragma unroll
            for (int o = 0; o < kNB; ++o)
                if (y0 + o < H)
                    *reinterpret_cast<float4*>(A + ((yl + o) * kCW + tx) * lda + c) = acc[o];
        }
    }
    // tile_matmul_interleaved synchronises before it reads A
    tile_matmul_interleaved<kTM>(A, lda, Kp, wp, Np, Np, ws, [&](int p, int n, float u) {
        const int y = ty0 + p / kCW, xx = tx0 + p % kCW;
        if (y >= H || xx >= W || n >= C) return;
        const size_t i = img + ((size_t)y * W + xx) * C + n;
        out[i] = x[i] * sigmoid_f32(fmaf(u, scale[n], shift[n]));
    });
}

}  // namespace

extern "C" int lka_gate(const float* x, const float* w5, const float* wh, const float* wv,
                        const float* wp, const float* scale, const float* shift, float* t2,
                        float* out, int B, int H, int W, int C, int Kp, int Np, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B < 1 || H < 1 || W < 1 || B > 65535 || C < 4 || C % 4 || C / 4 > kThreads ||
        Kp < C || Np < C || Kp % kKC || Np % 64)
        return cudaErrorInvalidValue;
    const size_t smem = (size_t)(kCH * kCW * (Kp + 4) + tile_matmul_ws()) * sizeof(float);
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    float* t1 = out;   // dead once the 1x21 has read it
    lka_dw5_kernel<<<grid, kThreads, 0, st>>>(x, w5, t1, H, W, C);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    lka_dwh_kernel<<<grid, kThreads, 0, st>>>(t1, wh, t2, H, W, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(lka_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dim3 tgrid((W + kCW - 1) / kCW, (H + kCH - 1) / kCH, B);
    lka_tail_kernel<<<tgrid, kThreads, smem, st>>>(t2, x, wv, wp, scale, shift, out, H, W, C, Kp,
                                                   Np);
    return cudaGetLastError();
}
