// Dense 3x3 SAME convolution + bias, hand-written f32 kernels for Hopper (sm_90a).
//
// Replaces the TPU kernel freqfusion_tpu/ops/pallas/cab.py:conv3x3_dense (B3). On the TPU it
// existed to keep layout relayouts off the seams between kernels; on the H100 the question
// is only whether it beats cuDNN, which is the plain version's route.
//
// What bounds it on the H100. On NAFNet's path it runs at HR with few channels on one side
// (intro 3->64, ending 64->3). Per pixel it reads Cin and writes Cout floats (268 bytes)
// for 9*Cin*Cout = 1728 MACs, about 13 FLOP per byte: near the f32 CUDA-core ridge (67
// TFLOP/s against 3.35 TB/s, 20 FLOP per byte). So the design keeps both the traffic and
// the shared-memory reads per FMA low: a block owns a 16 x 64 output tile and stages its
// 18 x 66 halo, 4 input channels at a time and channel-planar, in shared memory (zeros
// outside the image give the SAME padding), beside the matching 3 x 3 x 4 x COT weights.
// Each thread computes a column of 4 output pixels x COT output channels in registers, so
// each staged weight feeds 4 pixels and each staged input up to 3 of them. COT follows Cout
// (4, 8 or 16), so the 64->3 ending does not compute 13 dead channels. It takes any Cin
// and Cout.
//
// The wide case. HAT and DAT use the conv at 180 -> 180 (583 k FLOPs a pixel for 1.4 KB:
// bound by operations), where the kernel above makes 12 passes of 16 output channels over
// the input and reads shared memory once per 1.3 FMAs. With both widths at 32 or more (and
// multiples of 4) the conv goes through the implicit-GEMM kernel of conv_gemm.cuh instead,
// which the CAB chain uses too: f32-exact 3xTF32 products on the tensor cores, whose bound
// at [1,352,512,180] -> 180 is 0.64 ms (105 GFLOP at 165 TFLOP/s) where the CUDA cores'
// was 1.57 ms. The wrapper then hands over the weights zero-padded to [9][Cinp][Np] and the
// bias [Np], both widths to multiples of 8 (180 -> 184).
//
// Layout: x [B,H,W,Cin], w [3][3][Cin][Cout] (HWIO), bias [Cout], out [B,H,W,Cout]. x and out
// are f32, or bf16 (T): the CUDA-core kernel multiplies the bf16 values in f32, which is the
// exact bf16-operand product; weights and bias are f32 (a bf16 weight's exact values).

#include "conv_gemm.cuh"

namespace {

constexpr int kTX = 16, kPY = 4, kTY = 16 * kPY;  // output tile 16 x 64; 4 rows a thread
constexpr int kHX = kTX + 2, kHY = kTY + 2;       // halo 18 x 66
constexpr int kCK = 4;                            // input channels per staged chunk

// two blocks per SM (<= 128 registers a thread) for the narrow tiles; at COT = 16 the
// 64 accumulators would spill under that cap
template <int COT, typename T>
__global__ void __launch_bounds__(kThreads, COT <= 8 ? 2 : 1)
conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out, int H, int W,
               int Cin, int Cout) {
    __shared__ float xs[kCK * kHY * kHX];            // [ci][row][col]
    __shared__ __align__(16) float ws[9 * kCK * COT];  // [tap][ci][co]
    const int bi = blockIdx.z, ty0 = blockIdx.y * kTY, tx0 = blockIdx.x * kTX;
    const int tid = threadIdx.x, ox = tid % kTX, oy0 = (tid / kTX) * kPY;
    const T* xb = x + (size_t)bi * H * W * Cin;

    for (int co0 = 0; co0 < Cout; co0 += COT) {
        float acc[kPY][COT];
#pragma unroll
        for (int i = 0; i < kPY; ++i)
#pragma unroll
            for (int c = 0; c < COT; ++c) acc[i][c] = 0.f;
        for (int ci0 = 0; ci0 < Cin; ci0 += kCK) {
            const int ck = min(kCK, Cin - ci0);
            __syncthreads();  // the previous chunk's readers are done
            if (ck == kCK && Cin % 4 == 0) {  // one float4 of 4 channels per pixel
                for (int hp = tid; hp < kHY * kHX; hp += kThreads) {
                    const int yy = ty0 - 1 + hp / kHX, xq = tx0 - 1 + hp % kHX;
                    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                    if (yy >= 0 && yy < H && xq >= 0 && xq < W)
                        v = ld4(xb + ((size_t)yy * W + xq) * Cin + ci0);
                    xs[hp] = v.x;
                    xs[kHY * kHX + hp] = v.y;
                    xs[2 * kHY * kHX + hp] = v.z;
                    xs[3 * kHY * kHX + hp] = v.w;
                }
            } else {  // channel-fastest, so neighbouring threads read neighbouring floats
                for (int e = tid; e < kCK * kHY * kHX; e += kThreads) {
                    const int ci = e % kCK, hp = e / kCK;
                    const int yy = ty0 - 1 + hp / kHX, xq = tx0 - 1 + hp % kHX;
                    const bool live = ci < ck && yy >= 0 && yy < H && xq >= 0 && xq < W;
                    xs[ci * kHY * kHX + hp] =
                        live ? ld1(xb + ((size_t)yy * W + xq) * Cin + ci0 + ci) : 0.f;
                }
            }
            for (int e = tid; e < 9 * kCK * COT; e += kThreads) {
                const int tap = e / (kCK * COT), r = e % (kCK * COT);
                const int ci = r / COT, co = r % COT;
                const bool live = ci < ck && co0 + co < Cout;
                ws[e] = live ? w[((size_t)tap * Cin + ci0 + ci) * Cout + co0 + co] : 0.f;
            }
            __syncthreads();
            for (int ci = 0; ci < ck; ++ci) {
#pragma unroll
                for (int dx = 0; dx < 3; ++dx) {
                    float v[kPY + 2];
#pragma unroll
                    for (int r = 0; r < kPY + 2; ++r)
                        v[r] = xs[(ci * kHY + oy0 + r) * kHX + ox + dx];
#pragma unroll
                    for (int dy = 0; dy < 3; ++dy) {
                        const float* wp = ws + ((dy * 3 + dx) * kCK + ci) * COT;
#pragma unroll
                        for (int c4 = 0; c4 < COT; c4 += 4) {
                            const float4 wv = *reinterpret_cast<const float4*>(wp + c4);
#pragma unroll
                            for (int i = 0; i < kPY; ++i) {
                                acc[i][c4 + 0] = fmaf(v[i + dy], wv.x, acc[i][c4 + 0]);
                                acc[i][c4 + 1] = fmaf(v[i + dy], wv.y, acc[i][c4 + 1]);
                                acc[i][c4 + 2] = fmaf(v[i + dy], wv.z, acc[i][c4 + 2]);
                                acc[i][c4 + 3] = fmaf(v[i + dy], wv.w, acc[i][c4 + 3]);
                            }
                        }
                    }
                }
            }
        }
        const int xx = tx0 + ox;
#pragma unroll
        for (int i = 0; i < kPY; ++i) {
            const int y = ty0 + oy0 + i;
            if (y < H && xx < W) {
                T* op = out + (((size_t)bi * H + y) * W + xx) * Cout + co0;
                if (Cout % 4 == 0 && co0 + COT <= Cout) {  // 16-byte stores
#pragma unroll
                    for (int c = 0; c < COT; c += 4)
                        st4(op + c, make_float4(
                            acc[i][c] + bias[co0 + c], acc[i][c + 1] + bias[co0 + c + 1],
                            acc[i][c + 2] + bias[co0 + c + 2], acc[i][c + 3] + bias[co0 + c + 3]));
                } else {
#pragma unroll
                    for (int c = 0; c < COT; ++c)
                        if (co0 + c < Cout) st1(op + c, acc[i][c] + bias[co0 + c]);
                }
            }
        }
    }
}

template <int COT, typename T>
cudaError_t launch(const T* x, const float* w, const float* bias, T* out, int B,
                   int H, int W, int Cin, int Cout, cudaStream_t st) {
    dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, B);
    conv3x3_kernel<COT, T><<<grid, kThreads, 0, st>>>(x, w, bias, out, H, W, Cin, Cout);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dense(const T* x, const float* w, const float* bias, T* out, int B, int H, int W,
                  int Cin, int Cout, const float* wpad, const float* bpad, int Cinp, int Np,
                  cudaStream_t st) {
    if (Cin % 4 == 0 && Cout % 4 == 0 && Cin >= 32 && Cout >= 32) {   // the wide case
        if (!wpad || !bpad || Cinp % kCC || Cinp < Cin || Np % 8 || Np < Cout)
            return cudaErrorInvalidValue;
        const int smem = (int)conv_gemm_smem_bytes();
        cudaError_t err = cudaFuncSetAttribute(
            conv3x3_gemm_kernel<false, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
        conv3x3_gemm_kernel<false, T><<<grid, kThreads, smem, st>>>(
            x, nullptr, nullptr, wpad, bpad, out, nullptr, H, W, Cin, Cinp, Np, Cout, 0);
        return cudaGetLastError();
    }
    if (Cout <= 4) return launch<4>(x, w, bias, out, B, H, W, Cin, Cout, st);
    if (Cout <= 8) return launch<8>(x, w, bias, out, B, H, W, Cin, Cout, st);
    return launch<16>(x, w, bias, out, B, H, W, Cin, Cout, st);
}

}  // namespace

// Whether the wide case applies: the wrapper then passes padded weights (wpad, bpad).
extern "C" int conv3x3_dense_is_wide(int Cin, int Cout) {
    return Cin % 4 == 0 && Cout % 4 == 0 && Cin >= 32 && Cout >= 32;
}

// x and out f32, or bf16 where `bf16_io` is set.
extern "C" int conv3x3_dense(const float* x, const float* w, const float* bias, float* out,
                             int B, int H, int W, int Cin, int Cout, const float* wpad,
                             const float* bpad, int Cinp, int Np, int bf16_io, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bf16_io)
        return dense(reinterpret_cast<const bf16*>(x), w, bias, reinterpret_cast<bf16*>(out), B,
                     H, W, Cin, Cout, wpad, bpad, Cinp, Np, st);
    return dense(x, w, bias, out, B, H, W, Cin, Cout, wpad, bpad, Cinp, Np, st);
}
