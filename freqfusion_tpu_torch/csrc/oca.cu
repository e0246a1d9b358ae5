// HAT's overlapping cross-attention (OCAB), f32-exact on Hopper's tensor cores (3xTF32, the
// key-streaming loop of flash_f32x3.cuh), hand-written for Hopper (sm_90a).
//
// Replaces the attention inside the TPU kernel
// freqfusion_tpu/ops/pallas/wattn.py:fused_overlap_attention (B9); its output projection
// is rows_linear in csrc/hat_rows.cu. Per ws x ws window of queries and per head (dim hd):
//     out = softmax(q k^T / sqrt(hd) + bias[head]) v
// over the (ws + overlap)^2 keys and values of the window grown by overlap/2 on each side.
// k and v are zero outside the image: such a key is not masked, it scores its bias alone
// and adds nothing to the sum, as zero-padding after the projection gives it. The plain
// PyTorch version sits beside the wrapper in freqfusion_tpu_torch/ops/kernels/wattn.py.
//
// What bounds it on the H100. Per window and head 4 * nq * nk * hd FLOPs of products
// (17.7 M at ws = 16, 576 keys, hd = 30; 74.7 GFLOP at [1,352,512,180], 4224 (window,
// head) pairs) and nq * nk exponentials, for about 2 * nq * hd + 2 * nk * hd floats and the
// bias row: bound by the products, 0.45 ms on the tensor cores' 165 TFLOP/s of f32-exact
// products (1.1 ms all on the CUDA cores' 67). The bias [heads][nq][nk] (3.5 MB at HAT-L)
// stays in L2.
//
// Design: flash_f32x3.cuh's loop (B13's) with a gather of the overlapping window. A block of
// 8 warps owns 128 query rows of one (window, head) and streams the window's keys through a
// two-stage ring of 32-key chunks: any number of keys (HAT's window 32 gives 2304) and any
// head width. The query groups and heads of a window are neighbouring blocks, so its keys
// come from L2.
//
// Layout: q, k, v, out [B,H,W,C] NHWC, f32 or bf16 (bf16 products at P = 1), C = heads * hd;
// bias [heads][nq][nk].
// overlap even.

#include "flash_f32x3.cuh"

namespace {

constexpr int kOcaWarps = 8;

template <typename TS, int PS>
struct OverlapWindow {
    using T = TS;   // storage of q, k, v and out
    static constexpr int P = PS;   // TF32 passes (common.cuh)
    const T *q, *k, *v;
    const float* bias;
    T* out;
    long long img;
    int nq, nk, hd, C, col, ws, ows, pad, H, W, wy, wx;
    float scale;
    bool even;   // q, k, v offsets and hd even: 8-byte copies
    __device__ long long qpixel(int i) const {
        return img + (long long)(wy * ws + i / ws) * W + wx * ws + i % ws;
    }
    __device__ const T* q_row(int i) const { return q + qpixel(i) * C + col; }
    __device__ T* out_row(int i) const { return out + qpixel(i) * C + col; }
    __device__ long long key(int j) const {
        const int yy = wy * ws - pad + j / ows, xx = wx * ws - pad + j % ows;
        if (yy < 0 || yy >= H || xx < 0 || xx >= W) return -1;
        return (img + (long long)yy * W + xx) * C + col;
    }
    __device__ const float* bias_row(int i) const { return bias + (long long)i * nk; }
    __device__ const float* mask_row(int) const { return nullptr; }
};

template <bool QREG, typename T, int P>
__global__ void __launch_bounds__(32 * kOcaWarps, 16 / kOcaWarps)
oca_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ bias, T* __restrict__ out, int H, int W, int C,
                int ws, int ows, int heads, int hd, int qgroups, float scale) {
    extern __shared__ float4 smem4[];
    const int qg = blockIdx.x % qgroups;
    const int rest = blockIdx.x / qgroups, head = rest % heads;
    int win = rest / heads;
    const int n_wc = W / ws, n_wr = H / ws;
    const int bi = win / (n_wr * n_wc);
    win -= bi * n_wr * n_wc;
    OverlapWindow<T, P> g;
    g.q = q; g.k = k; g.v = v; g.out = out;
    g.nq = ws * ws; g.nk = ows * ows; g.hd = hd; g.C = C; g.col = head * hd;
    g.ws = ws; g.ows = ows; g.pad = (ows - ws) / 2; g.H = H; g.W = W;
    g.wy = win / n_wc; g.wx = win % n_wc;
    g.img = (long long)bi * H * W;
    g.scale = scale;
    g.even = (C | hd) % 2 == 0;
    g.bias = bias + (long long)head * g.nq * g.nk;
    flash_attention_f32x3<kOcaWarps, QREG>(g, qg, reinterpret_cast<float*>(smem4));
}

template <bool QREG, int P, typename T>
cudaError_t launch_oca(const T* q, const T* k, const T* v, const float* bias, T* out, int B,
                       int H, int W, int C, int ws, int ows, int heads, int hd,
                       cudaStream_t st) {
    const size_t smem = (size_t)flash_smem_floats(kOcaWarps, hd) * sizeof(float);
    if (smem > 232448) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        oca_attn_kernel<QREG, T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int qgroups = (ws * ws + 16 * kOcaWarps - 1) / (16 * kOcaWarps);
    const long long nblocks = (long long)B * (H / ws) * (W / ws) * heads * qgroups;
    if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    oca_attn_kernel<QREG, T, P><<<(unsigned)nblocks, 32 * kOcaWarps, smem, st>>>(
        q, k, v, bias, out, H, W, C, ws, ows, heads, hd, qgroups, 1.f / sqrtf((float)hd));
    return cudaGetLastError();
}

template <int P, typename T>
cudaError_t oca(const T* q, const T* k, const T* v, const float* bias, T* out, int B, int H,
                int W, int C, int ws, int ows, int heads, int hd, cudaStream_t st) {
    if (hd <= 32)
        return launch_oca<true, P>(q, k, v, bias, out, B, H, W, C, ws, ows, heads, hd, st);
    return launch_oca<false, P>(q, k, v, bias, out, B, H, W, C, ws, ows, heads, hd, st);
}

}  // namespace

// q, k, v and out in the storage type of `mode` (common.cuh: IoMode); bias f32.
extern "C" int oca_attention(const float* q, const float* k, const float* v,
                             const float* bias, float* out, int B, int H, int W, int C, int ws,
                             int ows, int heads, int hd, int mode, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (ws < 1 || ows < ws || (ows - ws) % 2 || hd < 1 || heads * hd != C || H % ws || W % ws)
        return cudaErrorInvalidValue;
    return by_mode(mode, [&](auto m) {
        using T = typename decltype(m)::T;
        return oca<decltype(m)::P>(as<T>(q), as<T>(k), as<T>(v), bias, as<T>(out), B, H, W, C,
                                   ws, ows, heads, hd, st);
    });
}
