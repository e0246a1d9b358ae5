// HAT's CAB conv chain, LN1 + dense 3x3 (C -> mid) + GELU + dense 3x3 (mid -> C) with the
// channel-attention pool's sums, as hand-written f32 kernels for Hopper (sm_90a).
//
// Replaces the TPU kernel freqfusion_tpu/ops/pallas/cab.py:cab_chain (B7):
//     u = conv3x3(GELU(conv3x3(LN1(x)) + b1)) + b2        (both SAME)
//     sums[b][c] = sum over the image of u[b][.][.][c]
// and with out_shift = s the stored image is u rolled by (-s, -s); the sums are those of
// u itself. The plain PyTorch version sits beside the wrapper in
// freqfusion_tpu_torch/ops/kernels/cab.py.
//
// What bounds it on the H100. Per pixel 2 * 9 * (C*mid + mid*C) FLOPs (389 k at C = 180,
// mid = 60) for 8 * C bytes of x and u (1.4 KB): 270 FLOP per byte, far above the f32
// CUDA-core ridge (20). It is bound by operations, the two implicit GEMMs.
//
// Design. The TPU kernel keeps a row strip of LN1(x) with a 2-row halo and the whole
// intermediate in VMEM. Here a 12 x 36 halo tile of LN1(x) at 180 channels is 311 KB, more
// than a block may use, and a fused tile would compute its ring of the intermediate twice.
// This version splits at the intermediate instead: it is only mid (60 -> 64) channels
// wide, so writing and reading it once costs 2 * 256 bytes a pixel, a few % of the time
// the products take. Both convolutions are the implicit-GEMM kernel of conv_gemm.cuh (a
// 4 x 32 pixel tile and 64 output channels a pass, f32-exact 3xTF32 products on the tensor
// cores, the halo and the weights in 8-channel chunks through a 3-stage cp.async ring):
//   * conv1 normalises on load: each halo pixel's mean and 1/std are taken once per block
//     by a warp, and each thread applies them with the affine to the elements it copied,
//     in place, before the ring's barrier. Pixels outside the image are zeros of LN1(x),
//     not of x; conv2 reads zeros outside the image, not GELU(b1), because conv1 never
//     writes there and the staging zero-fills;
//   * conv2's epilogue adds each thread's pixels per channel, the warp's lanes and then the
//     block's 4 tile rows add in a fixed order and sum_partials adds the blocks in a fixed
//     order: no atomics, the same sums from run to run. out_shift is a modular index at
//     the store.
// The bound it now works against: 36 * C * mid FLOPs a pixel of products at 165 TFLOP/s
// (3 x TF32 at 495), 1.05 ms at [1,352,512,180] on the CUDA cores' 67, 0.43 ms on the
// tensor cores. Neither C = 180 nor mid = 60 is a multiple of 8, the MMA's k and n: the
// wrapper zero-pads the weights to [9][Cinp][Np] and the biases to [Np]; the intermediate
// is stored Mp = 64 wide, its padded channels GELU(0) = 0.
//
// Layout: NHWC, contiguous; C % 4 == 0. x, g and u are f32, or bf16; the products take
// bf16 operands at bf16 and at precision "default" (P = 1).

#include "conv_gemm.cuh"

// Blocks per image of the kernels' grid: the rows of `part` [B][blocks][C].
extern "C" int cab_chain_blocks(int H, int W) {
    return ((W + kTW - 1) / kTW) * ((H + kTH - 1) / kTH);
}

namespace {

// x, g and u of storage type T; g, the GELU output between the convolutions, is stored in
// T and rounded to bf16 as an operand at P = 1, as the TPU kernel casts it to its operand
// dtype.
template <typename T, int P>
cudaError_t chain(const T* x, const float* lnw, const float* lnb, const float* w1,
                  const float* b1, const float* w2, const float* b2, T* g, T* u, float* part,
                  float* sums, int B, int H, int W, int C, int Cinp, int Np1, int Mp, int Np2,
                  int shift, cudaStream_t st) {
    const int smem = (int)conv_gemm_smem_bytes();
    cudaError_t err = cudaFuncSetAttribute(conv3x3_gemm_kernel<true, T, P>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(conv3x3_gemm_kernel<false, T, P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
    conv3x3_gemm_kernel<true, T, P><<<grid, kThreads, smem, st>>>(
        x, lnw, lnb, w1, b1, g, nullptr, H, W, C, Cinp, Np1, Mp, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    conv3x3_gemm_kernel<false, T, P><<<grid, kThreads, smem, st>>>(
        g, nullptr, nullptr, w2, b2, u, part, H, W, Mp, Mp, Np2, C, shift);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return sum_partials(part, sums, B, grid.x * grid.y, C, st);
}

}  // namespace

// x, g [B,H,W,Mp] and u in the storage type of `mode` (common.cuh: Mode); weights, biases
// and sums f32.
extern "C" int cab_chain(const float* x, const float* lnw, const float* lnb, const float* w1,
                         const float* b1, const float* w2, const float* b2, float* g, float* u,
                         float* part, float* sums, int B, int H, int W, int C, int Cinp,
                         int Np1, int Mp, int Np2, int shift, int mode, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (C % 4 || Cinp % kCC || Cinp < C || Np1 % 8 || Mp % kCC || Mp > Np1 || Np2 % 8 ||
        Np2 < C || shift < 0 || shift >= H || shift >= W)
        return cudaErrorInvalidValue;
    return by_mode(mode, [&](auto m) {
        using T = typename decltype(m)::T;
        return chain<T, decltype(m)::P>(as<T>(x), lnw, lnb, w1, b1, w2, b2, as<T>(g), as<T>(u),
                                        part, sums, B, H, W, C, Cinp, Np1, Mp, Np2, shift, st);
    });
}
