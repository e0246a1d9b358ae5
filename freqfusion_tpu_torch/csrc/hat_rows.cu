// HAT's per-pixel row work, projection + residuals + LayerNorm + MLP, as one hand-written
// f32 product kernel for Hopper (sm_90a) in four modes, launched in sequence:
//   * hab_tail, the second half of the fused HAB block (B8), after csrc/wattn.cu's
//     attention:  y = x + att @ wproj + bproj + conv_scale * cab_scale * conv_x   (proj)
//                 hidden = GELU(LN2(y) @ w1 + b1)                                  (fc1)
//                 out = y + hidden @ w2 + b2                                       (fc2)
//   * residual_ln_mlp (B10):  y = a + shortcut, then fc1 and fc2 as above;
//   * rows_linear: out = a @ w + b on rows of any output width: the output projection of
//     the overlapping cross-attention (B9), after csrc/oca.cu's attention, and the qkv and
//     output projections of the standalone window attention (B14) around csrc/wattn.cu's.
//
// Replaces the TPU kernels freqfusion_tpu/ops/pallas/wattn.py:fused_hab_block (with
// wattn.cu), :fused_residual_ln_mlp and the projection inside :fused_overlap_attention.
// The plain PyTorch versions sit beside the wrappers in
// freqfusion_tpu_torch/ops/kernels/wattn.py.
//
// What bounds it on the H100. Per pixel 2*C*C + 4*C*hid FLOPs (324 k at C = 180, hid = 360)
// for 16*C bytes of att, x, conv_x and out (2.9 KB): 112 FLOP per byte, above the f32
// CUDA-core ridge (20): bound by operations, the three products.
//
// Design. The TPU kernel keeps a window's rows, y and the hidden in VMEM through all three
// products. One block that does the same here needs 204 KB for 64 pixels (rows, y, hidden),
// so one block of 8 warps an SM with 4 rows a thread: it ran at 17 TFLOP/s. This version
// gives each product its own launch of one kernel: a block owns 128 pixels, stages their
// rows [128][K + 4] in shared memory (100 KB at K = 192, so two blocks an SM) and runs
// tile_matmul with 8 interleaved rows a thread (common.cuh): per four k it reads 8 + 4
// float4s for 128 FMAs. What the TPU kernel keeps in VMEM between the products goes
// through device memory instead: y is parked in the output buffer (written by proj, read by
// fc1, read and overwritten by fc2's epilogue, each element by the thread that wrote it),
// the hidden in a scratch buffer [pixels][K2p]; about 7 KB a pixel of extra traffic. fc2's
// K = 384 is taken in two halves of the same tile, the second half's epilogue adding to the
// first's. LN2 is one warp per row on the staged tile. With in_shift the shortcut x is read
// at (y + s, x + s), wrapping, like the attention read it; conv_x and out are in rolled
// coordinates. HAT's widths (180, 360) fit neither K % 16 nor N % 64: the wrapper zero-pads
// the weights, the kernel zero-fills the padded columns of its tile.
//
// Layout: NHWC, f32, contiguous; C % 4 == 0. cab_scale [B][C] or null.

#include "common.cuh"

namespace {

constexpr int kP = 128, kTM = kP / 16;   // pixels per block, rows per thread
constexpr float kEps = 1e-5f;
enum Mode { kLinear = 0, kProj = 1, kFc1 = 2, kFc2 = 3 };

struct RowArgs {
    const float* a;      // att (kLinear, kProj), a or y (kFc1), the hidden (kFc2)
    const float* x;      // the block's input x (kProj); shortcut or null (kFc1)
    const float* cx;     // conv_x (kProj)
    const float* cabs;   // cab_scale [B][C] or null (kProj)
    const float* w;      // the product's weights, zero-padded [Kp][Np]
    const float* bias;   // its bias
    const float *lnw, *lnb;   // LayerNorm affine (kFc1)
    float* out;          // out; it holds y after kProj, or after kFc1 with a shortcut
    float* hid;          // the hidden [pixels][Np] (kFc1)
    long long npix;      // B * H * W
    int H, W, C, Kp, Np, nreal, shift;   // nreal: real columns of the product
    float conv_scale;
};

template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
rows_kernel(const RowArgs g) {
    extern __shared__ float4 smem4[];
    const int C = g.C;
    const int Kt = MODE == kFc2 ? first_half(g.Kp) : g.Kp, lda = Kt + 4;
    float* A = reinterpret_cast<float*>(smem4);  // [kP][lda]
    float* ws = A + kP * lda;                     // tile_matmul's weight stage
    long long* src = reinterpret_cast<long long*>(ws + tile_matmul_ws(false));  // [kP]
    int* img = reinterpret_cast<int*>(src + kP);                                // [kP]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long p0 = (long long)blockIdx.x * kP;

    if (MODE == kProj) {   // where each row's shortcut pixel lies, and its image
        if (tid < kP) {
            const long long gp = min(p0 + tid, g.npix - 1), hw = (long long)g.H * g.W;
            const int bi = (int)(gp / hw), rem = (int)(gp - bi * hw);
            int y = rem / g.W + g.shift, xx = rem % g.W + g.shift;
            if (y >= g.H) y -= g.H;
            if (xx >= g.W) xx -= g.W;
            src[tid] = bi * hw + (long long)y * g.W + xx;
            img[tid] = bi;
        }
    }
    for (int k0 = 0; k0 < g.Kp; k0 += Kt) {
        const int kh = min(Kt, g.Kp - k0), k4 = kh / 4;
        const int width = MODE == kFc2 ? g.Kp : C;   // floats of a row of `a`
        // the tile's rows, zero in the padded columns and past the last pixel; the previous
        // half's readers are past tile_matmul's last barrier
        for (int e = tid; e < kP * k4; e += kThreads) {
            const int p = e / k4, c = (e % k4) * 4;
            const long long gp = p0 + p;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (gp < g.npix && k0 + c < width) {
                v = *reinterpret_cast<const float4*>(g.a + gp * width + k0 + c);
                if (MODE == kFc1 && g.x) {   // y = a + shortcut, parked in out
                    const float4 s = *reinterpret_cast<const float4*>(g.x + gp * C + c);
                    v = make_float4(v.x + s.x, v.y + s.y, v.z + s.z, v.w + s.w);
                    *reinterpret_cast<float4*>(g.out + gp * C + c) = v;
                }
            }
            *reinterpret_cast<float4*>(A + p * lda + c) = v;
        }
        if (MODE == kFc1) {
            __syncthreads();
            for (int p = warp; p < kP; p += kThreads / 32)
                if (p0 + p < g.npix)
                    warp_layernorm(A + p * lda, A + p * lda, g.lnw, g.lnb, C, kEps);
        }
        if (MODE == kProj) __syncthreads();  // src and img visible
        const bool first = k0 == 0;
        // tile_matmul synchronises before it reads A
        tile_matmul_interleaved<kTM>(
            A, lda, kh, g.w + (size_t)k0 * g.Np, g.Np, g.Np, ws,
            [&](int p, int n, float u, float) {
                const long long gp = p0 + p;
                if (gp >= g.npix) return;
                if (MODE == kFc1) {   // the hidden, zero in its padded columns
                    g.hid[gp * g.Np + n] = n < g.nreal ? gelu_erf(u + g.bias[n]) : 0.f;
                    return;
                }
                const int wout = MODE == kLinear ? g.nreal : C;   // floats of a row of out
                if (n >= wout) return;
                float* o = g.out + gp * wout + n;
                if (MODE == kLinear) {
                    o[0] = u + g.bias[n];
                } else if (MODE == kProj) {
                    const float cs =
                        g.cabs ? g.conv_scale * g.cabs[img[p] * C + n] : g.conv_scale;
                    o[0] = g.x[src[p] * C + n] + u + g.bias[n] + cs * g.cx[gp * C + n];
                } else {   // kFc2: out holds y, then y + the first half's sum
                    o[0] += first ? u + g.bias[n] : u;
                }
            });
    }
}

template <int MODE>
cudaError_t launch(const RowArgs& g, cudaStream_t st) {
    if (g.C % 4 || g.Kp % kKC || g.Np % 64 || g.npix < 1) return cudaErrorInvalidValue;
    const int Kt = MODE == kFc2 ? first_half(g.Kp) : g.Kp;
    const size_t smem =
        (size_t)(kP * (Kt + 4) + tile_matmul_ws(false) + 3 * kP) * sizeof(float);
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        rows_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long nblocks = (g.npix + kP - 1) / kP;
    if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    rows_kernel<MODE><<<(unsigned)nblocks, kThreads, smem, st>>>(g);
    return cudaGetLastError();
}

// fc1 and fc2 on y: from `a` (+ `shortcut`, then y is written to out) or from y in out.
cudaError_t mlp(const float* a, const float* shortcut, const float* lnw, const float* lnb,
                const float* w1, const float* b1, const float* w2, const float* b2, float* hid,
                float* out, long long npix, int C, int nhid, int Kp, int Np, int K2p,
                cudaStream_t st) {
    if (Kp < C || Np < C || K2p < nhid || K2p % 64) return cudaErrorInvalidValue;
    RowArgs g = {};
    g.a = a; g.x = shortcut; g.lnw = lnw; g.lnb = lnb; g.w = w1; g.bias = b1;
    g.out = out; g.hid = hid; g.npix = npix; g.C = C; g.Kp = Kp; g.Np = K2p; g.nreal = nhid;
    cudaError_t err = launch<kFc1>(g, st);
    if (err != cudaSuccess) return err;
    RowArgs f = {};
    f.a = hid; f.w = w2; f.bias = b2; f.out = out;
    f.npix = npix; f.C = C; f.Kp = K2p; f.Np = Np; f.nreal = C;
    return launch<kFc2>(f, st);
}

}  // namespace

// out [npix][Cout] = a [npix][C] @ wp + bp, wp zero-padded to [Kp][Np].
extern "C" int rows_linear(const float* a, const float* wp, const float* bp, float* out,
                           long long npix, int C, int Cout, int Kp, int Np, void* stream) {
    if (Kp < C || Np < Cout || Cout < 1) return cudaErrorInvalidValue;
    RowArgs g = {};
    g.a = a; g.w = wp; g.bias = bp; g.out = out;
    g.npix = npix; g.C = C; g.Kp = Kp; g.Np = Np; g.nreal = Cout;
    return launch<kLinear>(g, static_cast<cudaStream_t>(stream));
}

extern "C" int hab_tail(const float* att, const float* x, const float* cx, const float* cabs,
                        const float* wp, const float* bp, const float* lnw, const float* lnb,
                        const float* w1, const float* b1, const float* w2, const float* b2,
                        float* hid, float* out, int B, int H, int W, int C, int nhid, int Kp,
                        int Np, int K2p, int shift, float conv_scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (shift < 0 || shift >= H || shift >= W || Kp < C || Np < C)
        return cudaErrorInvalidValue;
    RowArgs g = {};
    g.a = att; g.x = x; g.cx = cx; g.cabs = cabs; g.w = wp; g.bias = bp; g.out = out;
    g.npix = (long long)B * H * W; g.H = H; g.W = W; g.C = C; g.Kp = Kp; g.Np = Np;
    g.nreal = C; g.shift = shift; g.conv_scale = conv_scale;
    cudaError_t err = launch<kProj>(g, st);
    if (err != cudaSuccess) return err;
    return mlp(out, nullptr, lnw, lnb, w1, b1, w2, b2, hid, out, g.npix, C, nhid, Kp, Np, K2p,
               st);
}

extern "C" int residual_ln_mlp(const float* a, const float* shortcut, const float* lnw,
                               const float* lnb, const float* w1, const float* b1,
                               const float* w2, const float* b2, float* hid, float* out,
                               long long npix, int C, int nhid, int Kp, int Np, int K2p,
                               void* stream) {
    return mlp(a, shortcut, lnw, lnb, w1, b1, w2, b2, hid, out, npix, C, nhid, Kp, Np, K2p,
               static_cast<cudaStream_t>(stream));
}
