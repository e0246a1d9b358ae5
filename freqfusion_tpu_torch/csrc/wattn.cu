// Window attention from pre-projected q, k, v, f32-exact on Hopper's tensor cores (3xTF32,
// the key-streaming loop of flash_f32x3.cuh), hand-written for Hopper (sm_90a). (The
// attention with the qkv projection in front, DAT's B4 and the attention half of HAT's B8,
// is csrc/hab_attention.cu.)
//
// Replaces the TPU kernel freqfusion_tpu/ops/pallas/wattn.py:fused_window_attention_qkv
// (B13), and is the attention between the two row products of
// wattn.py:fused_window_attention (B14; csrc/hat_rows.cu's rows_linear projects before
// and after it). Per (hs, ws) window of N tokens and per head:
//     out = softmax(q k^T / sqrt(hd) + bias[head] (+ mask type of the window)) v
// on images that are whole windows. A zero-padded key is not masked: it scores its bias
// and takes part in the softmax, as in the TPU kernel.
//
// What bounds it on the H100. Per window and head 4*N*N*hd FLOPs of products plus the
// softmax's N*N exponentials for 4*N*hd floats and the N*N bias row floats (read from L2):
// 16.6 GFLOP at [1,352,512,90] (704 windows of 8x32, 3 heads of 30), 0.10 ms on the tensor
// cores' 165 TFLOP/s of f32-exact products, 0.26 ms all on the CUDA cores' 67.
//
// Design: flash_f32x3.cuh's loop with a gather of the rect window. A block of 4 warps owns
// 64 query rows of one (window, head); the key chunks stream through a two-stage cp.async
// ring, so any N is taken and several blocks share an SM; heads up to 32 wide keep their q
// fragments in registers, wider ones (any width) stage q in shared memory and take the
// output in 32-wide pieces. The query groups and heads of a window are neighbouring blocks,
// so its keys come from L2. The shift mask travels as its 4 window types [4][N][N]: a
// window's type is 2 (last row of windows) + 1 (last column). q, k, v share a pixel stride
// `ld`, so that B14 can pass the three thirds of one [B,H,W,3C] projection; out has
// heads * hd floats a pixel.

#include "flash_f32x3.cuh"

namespace {

constexpr int kQkvWarps = 4;

template <typename TS>
struct RectWindow {
    using T = TS;   // storage of q, k, v and out
    const T *q, *k, *v;
    const float *bias, *mask;
    T* out;
    long long img;   // first pixel of the window's image
    int nq, nk, hd, ld, co, col, hs, ws, W, wy, wx;
    float scale;
    bool even;   // q, k, v offsets and hd even: 8-byte copies
    __device__ long long pixel(int t) const {
        return img + (long long)(wy * hs + t / ws) * W + wx * ws + t % ws;
    }
    __device__ const T* q_row(int i) const { return q + pixel(i) * ld + col; }
    __device__ T* out_row(int i) const { return out + pixel(i) * co + col; }
    __device__ long long key(int j) const { return pixel(j) * ld + col; }
    __device__ const float* bias_row(int i) const { return bias + (long long)i * nk; }
    __device__ const float* mask_row(int i) const {
        return mask ? mask + (long long)i * nk : nullptr;
    }
};

template <bool QREG, typename T>
__global__ void __launch_bounds__(32 * kQkvWarps, 16 / kQkvWarps)
wattn_qkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, const float* __restrict__ types,
                 T* __restrict__ out, int H, int W, int ld, int hs, int ws, int heads, int hd,
                 int qgroups, float scale) {
    extern __shared__ float4 smem4[];
    const int qg = blockIdx.x % qgroups;
    int rest = blockIdx.x / qgroups;
    const int head = rest % heads;
    int win = rest / heads;
    const int n_wc = W / ws, n_wr = H / hs;
    const int bi = win / (n_wr * n_wc);
    win -= bi * n_wr * n_wc;
    RectWindow<T> g;
    g.q = q; g.k = k; g.v = v; g.out = out;
    g.nq = g.nk = hs * ws;
    g.hd = hd; g.ld = ld; g.co = heads * hd; g.col = head * hd;
    g.hs = hs; g.ws = ws; g.W = W; g.wy = win / n_wc; g.wx = win % n_wc;
    g.img = (long long)bi * H * W;
    g.scale = scale;
    g.even = (ld | hd) % 2 == 0;
    g.bias = bias + (long long)head * g.nk * g.nk;
    const int t_idx = (g.wy == n_wr - 1 ? 2 : 0) + (g.wx == n_wc - 1 ? 1 : 0);
    g.mask = types ? types + (long long)t_idx * g.nk * g.nk : nullptr;
    flash_attention_f32x3<kQkvWarps, QREG>(g, qg, reinterpret_cast<float*>(smem4));
}

template <bool QREG, typename T>
cudaError_t launch_qkv(const T* q, const T* k, const T* v, const float* bias,
                       const float* types, T* out, int B, int H, int W, int ld, int hs,
                       int ws, int heads, int hd, cudaStream_t st) {
    const size_t smem = (size_t)flash_smem_floats(kQkvWarps, hd) * sizeof(float);
    if (smem > 232448) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        wattn_qkv_kernel<QREG, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int qgroups = (hs * ws + 16 * kQkvWarps - 1) / (16 * kQkvWarps);
    const long long nblocks = (long long)B * (H / hs) * (W / ws) * heads * qgroups;
    if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    wattn_qkv_kernel<QREG, T><<<(unsigned)nblocks, 32 * kQkvWarps, smem, st>>>(
        q, k, v, bias, types, out, H, W, ld, hs, ws, heads, hd, qgroups,
        1.f / sqrtf((float)hd));
    return cudaGetLastError();
}

template <typename T>
cudaError_t qkv(const T* q, const T* k, const T* v, const float* bias, const float* types,
                T* out, int B, int H, int W, int ld, int hs, int ws, int heads, int hd,
                cudaStream_t st) {
    if (hd <= 32)
        return launch_qkv<true>(q, k, v, bias, types, out, B, H, W, ld, hs, ws, heads, hd, st);
    return launch_qkv<false>(q, k, v, bias, types, out, B, H, W, ld, hs, ws, heads, hd, st);
}

}  // namespace

// q, k, v and out f32, or bf16 where `bf16_io` is set; bias and types f32.
extern "C" int wattn_qkv(const float* q, const float* k, const float* v, const float* bias,
                         const float* types, float* out, int B, int H, int W, int ld, int hs,
                         int ws, int heads, int hd, int bf16_io, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (hs < 1 || ws < 1 || hd < 1 || heads < 1 || ld < heads * hd || B < 1 || H % hs ||
        W % ws)
        return cudaErrorInvalidValue;
    if (bf16_io)
        return qkv(reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),
                   reinterpret_cast<const bf16*>(v), bias, types, reinterpret_cast<bf16*>(out),
                   B, H, W, ld, hs, ws, heads, hd, st);
    return qkv(q, k, v, bias, types, out, B, H, W, ld, hs, ws, heads, hd, st);
}
