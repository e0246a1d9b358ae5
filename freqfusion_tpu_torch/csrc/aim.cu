// DAT's Adaptive Interaction Module as two hand-written f32 kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels freqfusion_tpu/ops/pallas/aim.py:aim_conv_branch (B5a) and
// :aim_gates_proj (B5b). The plain PyTorch versions sit beside the wrappers in
// freqfusion_tpu_torch/ops/kernels/aim.py.
//
// B5a, the conv branch: conv_x = GELU(BN(dwconv3x3(v) + b)) and the per-image sums of conv_x
// (the C-Map's global mean). Per pixel and channel it does 9 FMAs, an affine and an erf for
// 8 bytes moved: bound by bytes. So the design is about traffic only: one read of v (the
// 3x3 neighbours come back from L1/L2, a block's tile is 8 x 32 pixels), one write of
// conv_x, float4 accesses with neighbouring threads on neighbouring channels.
//   * SAME padding zeroes v, the conv's input, outside the image.
//   * The TPU kernel carried the sum across its sequential grid. Blocks run in no order
//     here: a thread keeps one channel quad for the whole tile and sums it in registers,
//     the block adds its thread groups in a fixed order and writes part[B][nblk][C], and
//     sum_partials (common.cuh) adds the blocks in a fixed order. No atomics.
// B5b, pointwise: the S-Map chain C -> mid -> 1 (BN, GELU), both sigmoid gates, their sum,
// and the C x C projection. 2*C*(C + mid) FLOPs per pixel for 12*C bytes: at C = 180 that
// is 32 FLOP per byte, above the f32 CUDA-core ridge (20), so it is bound by operations,
// and nearly all of them are the projection.
//   * One warp per pixel computes the S-Map: the source row in registers (C <= 256), the
//     C x mid weights in shared memory, mid warp reductions. `swap` picks the wiring:
//     spatial blocks gate attened by s(C-Map) and conv_x by s(S-Map(attened)); channel
//     blocks gate attened by s(S-Map(conv_x)) and conv_x by s(C-Map).
//   * The gated sum of a 64-pixel block goes to shared memory and through tile_matmul
//     (common.cuh), which streams the projection weights. DAT's C = 180 fits neither
//     K % 16 nor N % 64, so the wrapper zero-pads the weights to [Kp][Np] once and the
//     kernel zero-fills columns C..Kp of its tile and stores only columns < C.
//
// Layout: NHWC, f32, contiguous; C % 4 == 0. wdw [9][C]; si_w1 [C][mid]; si_w2 [mid];
// proj [Kp][Np] zero-padded; chvec [B][C], the C-Map before its sigmoid.

#include "common.cuh"

namespace {

constexpr int kATH = 8, kATW = 32;   // B5a tile
constexpr int kBP = 64;              // B5b pixels per block (16 * TM)
constexpr int kBTM = kBP / 16;
constexpr int kMaxC = 256;           // B5b keeps a pixel's C floats in 8 registers per lane

__global__ void __launch_bounds__(kThreads)
aim_conv_branch_kernel(const float* __restrict__ v, const float* __restrict__ wdw,
                       const float* __restrict__ bdw, const float* __restrict__ bns,
                       const float* __restrict__ bnb, float* __restrict__ cx,
                       float* __restrict__ part, int H, int W, int C) {
    extern __shared__ float4 smem4[];
    float* red = reinterpret_cast<float*>(smem4);  // [groups][C]
    const int nq = C / 4;                          // channel quads
    const int groups = kThreads / nq;              // thread groups, each walks the tile
    const int tid = threadIdx.x, q = tid % nq, grp = tid / nq;
    const int bi = blockIdx.z, ty0 = blockIdx.y * kATH, tx0 = blockIdx.x * kATW;
    const float* vb = v + (size_t)bi * H * W * C;
    float4 psum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (grp < groups) {
        const int c = q * 4;
        float4 wk[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) wk[k] = *reinterpret_cast<const float4*>(wdw + k * C + c);
        const float4 b0 = *reinterpret_cast<const float4*>(bdw + c);
        const float4 s0 = *reinterpret_cast<const float4*>(bns + c);
        const float4 h0 = *reinterpret_cast<const float4*>(bnb + c);
        for (int p = grp; p < kATH * kATW; p += groups) {
            const int y = ty0 + p / kATW, x = tx0 + p % kATW;
            if (y >= H || x >= W) continue;
            float4 a = b0;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
                const int yy = y + dy - 1;
                if (yy < 0 || yy >= H) continue;
#pragma unroll
                for (int dx = 0; dx < 3; ++dx) {
                    const int xx = x + dx - 1;
                    if (xx < 0 || xx >= W) continue;
                    const float4 t =
                        *reinterpret_cast<const float4*>(vb + ((size_t)yy * W + xx) * C + c);
                    const float4 w = wk[dy * 3 + dx];
                    a.x = fmaf(t.x, w.x, a.x);
                    a.y = fmaf(t.y, w.y, a.y);
                    a.z = fmaf(t.z, w.z, a.z);
                    a.w = fmaf(t.w, w.w, a.w);
                }
            }
            const float4 o = make_float4(
                gelu_erf(fmaf(a.x, s0.x, h0.x)), gelu_erf(fmaf(a.y, s0.y, h0.y)),
                gelu_erf(fmaf(a.z, s0.z, h0.z)), gelu_erf(fmaf(a.w, s0.w, h0.w)));
            *reinterpret_cast<float4*>(cx + (((size_t)bi * H + y) * W + x) * C + c) = o;
            psum.x += o.x;
            psum.y += o.y;
            psum.z += o.z;
            psum.w += o.w;
        }
        *reinterpret_cast<float4*>(red + grp * C + c) = psum;
    }
    __syncthreads();
    const int nblk = gridDim.x * gridDim.y, blk = blockIdx.y * gridDim.x + blockIdx.x;
    for (int c = tid; c < C; c += kThreads) {
        float s = 0.f;
        for (int g = 0; g < groups; ++g) s += red[g * C + c];
        part[((size_t)bi * nblk + blk) * C + c] = s;
    }
}

__global__ void __launch_bounds__(kThreads)
aim_gates_proj_kernel(const float* __restrict__ att, const float* __restrict__ cx,
                      const float* __restrict__ chvec, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ bns,
                      const float* __restrict__ bnb, const float* __restrict__ w2,
                      const float* __restrict__ b2, const float* __restrict__ proj,
                      const float* __restrict__ pb, float* __restrict__ out, long long npix,
                      int hw, int C, int mid, int Kp, int Np, int swap) {
    extern __shared__ float4 smem4[];
    const int lda = Kp + 4;
    float* ya = reinterpret_cast<float*>(smem4);  // [kBP][lda] the gated sum
    float* ws = ya + kBP * lda;                    // tile_matmul's weight stage
    float* w1s = ws + tile_matmul_ws(false);       // [kMaxC][mid], rows >= C zero
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long p0 = (long long)blockIdx.x * kBP;

    for (int e = tid; e < kMaxC * mid; e += kThreads) w1s[e] = e < C * mid ? w1[e] : 0.f;
    __syncthreads();

    for (int p = warp; p < kBP; p += kThreads / 32) {
        const long long gp = p0 + p;
        float* yr = ya + p * lda;
        if (gp >= npix) {
            for (int c = lane; c < Kp; c += 32) yr[c] = 0.f;
            continue;
        }
        const float* ar = att + gp * C;
        const float* cr = cx + gp * C;
        const float* chr = chvec + (gp / hw) * C;
        float av[kMaxC / 32], cv[kMaxC / 32];
#pragma unroll
        for (int i = 0; i < kMaxC / 32; ++i) {
            const int c = lane + 32 * i;
            av[i] = c < C ? ar[c] : 0.f;
            cv[i] = c < C ? cr[c] : 0.f;
        }
        // S-Map: fc2(GELU(BN(fc1(src)))) on this pixel, every lane ends with the sum
        float s = 0.f;
        for (int m = 0; m < mid; ++m) {
            float d = 0.f;
#pragma unroll
            for (int i = 0; i < kMaxC / 32; ++i)
                d = fmaf(swap ? cv[i] : av[i], w1s[(lane + 32 * i) * mid + m], d);
            d = warp_sum(d) + b1[m];
            s = fmaf(gelu_erf(fmaf(d, bns[m], bnb[m])), w2[m], s);
        }
        const float smap = sigmoid_f32(s + b2[0]);
#pragma unroll
        for (int i = 0; i < kMaxC / 32; ++i) {
            const int c = lane + 32 * i;
            if (c < C) {
                const float cg = sigmoid_f32(chr[c]);
                yr[c] = swap ? av[i] * smap + cv[i] * cg : av[i] * cg + cv[i] * smap;
            } else if (c < Kp) {
                yr[c] = 0.f;
            }
        }
    }
    // tile_matmul synchronises before it reads ya
    tile_matmul<kBTM, false>(ya, lda, Kp, proj, Np, Np, 0, ws, [&](int p, int n, float a, float) {
        const long long gp = p0 + p;
        if (gp < npix && n < C) out[gp * C + n] = a + pb[n];
    });
}

}  // namespace

extern "C" {

// Number of B5a blocks per image: the length of the partial-sum scratch's middle axis.
int aim_conv_branch_blocks(int H, int W) {
    return ((H + kATH - 1) / kATH) * ((W + kATW - 1) / kATW);
}

int aim_conv_branch(const float* v, const float* wdw, const float* bdw, const float* bns,
                    const float* bnb, float* cx, float* part, float* sums, int B, int H, int W,
                    int C, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (C % 4 || C / 4 > kThreads) return cudaErrorInvalidValue;
    const size_t smem = (size_t)(kThreads / (C / 4)) * C * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        aim_conv_branch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((W + kATW - 1) / kATW, (H + kATH - 1) / kATH, B);
    aim_conv_branch_kernel<<<grid, kThreads, smem, st>>>(v, wdw, bdw, bns, bnb, cx, part, H, W,
                                                         C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return sum_partials(part, sums, B, aim_conv_branch_blocks(H, W), C, st);
}

int aim_gates_proj(const float* att, const float* cx, const float* chvec, const float* w1,
                   const float* b1, const float* bns, const float* bnb, const float* w2,
                   const float* b2, const float* proj, const float* pb, float* out, int B,
                   int H, int W, int C, int mid, int Kp, int Np, int swap, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (C > kMaxC || Kp % kKC || Np % 64 || Kp < C || Np < C) return cudaErrorInvalidValue;
    const size_t smem =
        (size_t)(kBP * (Kp + 4) + tile_matmul_ws(false) + kMaxC * mid) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        aim_gates_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long npix = (long long)B * H * W;
    const unsigned nblocks = (unsigned)((npix + kBP - 1) / kBP);
    aim_gates_proj_kernel<<<nblocks, kThreads, smem, st>>>(att, cx, chvec, w1, b1, bns, bnb, w2,
                                                           b2, proj, pb, out, npix, H * W, C,
                                                           mid, Kp, Np, swap);
    return cudaGetLastError();
}

}  // extern "C"
