// DAT's Adaptive Interaction Module as two hand-written kernels for Hopper (sm_90a): B5a in
// f32 on CUDA cores, B5b with its projection f32-exact on the tensor cores (3xTF32 mma.sync,
// mma_f32x3.cuh).
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
// and the C x C projection: 2*C*(C + mid) FLOPs of products per pixel. At C = 180, mid = 11
// and [1,352,512,180] that is 12.4 GFLOP (0.075 ms at 165 TFLOP/s of f32-exact products)
// against 389 MB of attened, conv_x and out (0.116 ms): bytes bound it, at 0.116 ms.
//   * A block of 16 warps owns 128 pixels. It stages the S-Map's source rows (attened, or
//     conv_x with swap) in A, in the A-fragment order of tile_mma, K padded to a multiple of
//     8 (180 -> 184) with zeros.
//   * The S-Map (fc1 C -> mid, 180 -> 11: 6% of the products) runs on CUDA cores while the
//     rows are staged, 4 lanes a pixel, each with its quarter of the channels and 12 sums in
//     registers, fc1's weights in the ring's memory before the projection starts; 2 shuffles
//     a sum add the lanes. As a 16-column 3xTF32 product (tile_mma, BN, GELU and fc2 in its
//     epilogue, shuffles over an n-tile's 4 threads) it ran 0.70 against 0.66 ms at
//     [1,352,512,180] on the H100 (PERF.md): a second product's barriers and weight chunks
//     cost more than the 12 FMAs a channel.
//   * Either wiring is y = src * s(C-Map) + oth * s(S-Map(src)): spatial blocks take src =
//     attened, channel blocks (swap) src = conv_x. The gated sum is made in place in A,
//     reading the other input once; so each input is read once from device memory. A thread
//     owns a column quad there and takes the C-Map's sigmoids once an image, not once a
//     pixel. The staging loops are unrolled by four, so that a thread has several loads in
//     flight.
//   * The projection runs through tile_mma on its weights split on the host and kept
//     (ops/kernels/_mma.py), made once for each weight: no per-call padding. The kernel
//     stores only the columns below C. The sigmoids are f32 with expf.
//
// Layout: NHWC, f32, contiguous; C % 4 == 0. wdw [9][C]; si_w2 [mid]; chvec [B][C], the
// C-Map before its sigmoid; B5b's fc1 and proj as GatesArgs says.

#include "mma_f32x3.cuh"

namespace {

constexpr int kATH = 8, kATW = 32;   // B5a tile
constexpr int kMid = 12;             // B5b: the S-Map's widest hidden layer (a lane's sums)

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

// B5b's arguments.
struct GatesArgs {
    const float *att, *cx, *chvec;   // attened, conv_x [npix][C]; the C-Map [B][C]
    const float* w1;      // the S-Map's fc1 [C][kMid], zero past mid
    const float *b1, *bns, *bnb, *w2, *b2;   // fc1's bias, BN's affine, fc2 [mid], its bias
    const float4* projp;  // mma_planes of proj [Kp][Kp]
    const float* pb;
    float* out;
    long long npix;
    int hw, C, mid, Kp, swap;
};

__global__ void __launch_bounds__(kMmaThreads, 1)
aim_gates_proj_kernel(const GatesArgs a) {
    extern __shared__ float4 smem4[];
    const int C = a.C, Kp = a.Kp, ks = Kp / 8, c4 = C / 4;
    float* A = reinterpret_cast<float*>(smem4);   // [128 x Kp] A-fragment order
    float* ws = A + kMmaRows * Kp;                 // tile_mma's ring
    float* smap = ws + tile_mma_ws();              // [128] the S-Map before its sigmoid
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long p0 = (long long)blockIdx.x * kMmaRows;
    // the S-Map's input, gated by the C-Map; the other input, gated by the S-Map: either
    // wiring is y = src * s(C-Map) + oth * s(S-Map(src))
    const float* src = a.swap ? a.cx : a.att;
    const float* oth = a.swap ? a.att : a.cx;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

    // the S-Map while src is staged: 4 lanes a pixel, 8 pixels a warp, each lane a quarter
    // of the channels and all kMid dot products in registers, fc1's weights in the ring's
    // memory (tile_mma has not started); then a butterfly over the 4 lanes
    float* w1s = ws;
    for (int e = tid; e < C * kMid; e += kMmaThreads) w1s[e] = a.w1[e];
    __syncthreads();
    {
        const int p = 8 * warp + (lane >> 2), q = lane & 3;
        const long long gp = p0 + p;
        float d[kMid];
#pragma unroll
        for (int m = 0; m < kMid; ++m) d[m] = 0.f;
#pragma unroll 4
        for (int c = 4 * q; c < Kp; c += 16) {
            const float4 v = gp < a.npix && c < C ? ld4(src + gp * C + c) : zero;
            put4(A, p, c, ks, v);
            if (c >= C) continue;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float x = lane4(v, i);
                const float4* wr = reinterpret_cast<const float4*>(w1s + (c + i) * kMid);
#pragma unroll
                for (int m4 = 0; m4 < kMid / 4; ++m4) {
                    const float4 w = wr[m4];
                    d[4 * m4] = fmaf(x, w.x, d[4 * m4]);
                    d[4 * m4 + 1] = fmaf(x, w.y, d[4 * m4 + 1]);
                    d[4 * m4 + 2] = fmaf(x, w.z, d[4 * m4 + 2]);
                    d[4 * m4 + 3] = fmaf(x, w.w, d[4 * m4 + 3]);
                }
            }
        }
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < kMid; ++m) {
            float t = d[m];
            t += __shfl_xor_sync(0xffffffffu, t, 1);
            t += __shfl_xor_sync(0xffffffffu, t, 2);
            if (m < a.mid) s = fmaf(gelu_erf(fmaf(t + a.b1[m], a.bns[m], a.bnb[m])), a.w2[m], s);
        }
        if (q == 0) smap[p] = s;
    }
    // the projection of the gated sum, made in place over src (tile_mma synchronises first)
    tile_mma(
        A, Kp, a.projp, Kp / 8, Kp, ws,
        [&] {
            if (tid < kMmaRows) smap[tid] = sigmoid_f32(smap[tid] + a.b2[0]);
            __syncthreads();
            // a thread owns a column quad and every R-th row, so that it takes the C-Map's
            // sigmoids once an image
            const int R = kMmaThreads / c4, rg = tid / c4, c = (tid % c4) * 4;
            if (rg >= R) return;
            long long img = -1;
            float4 cg = zero;
#pragma unroll 4
            for (int p = rg; p < kMmaRows; p += R) {
                const long long gp = p0 + p;
                if (gp >= a.npix) break;   // A holds zeros there
                const float4 o = ld4(oth + gp * C + c);
                if (gp / a.hw != img) {
                    img = gp / a.hw;
                    const float4 ch = ld4(a.chvec + img * C + c);
                    cg = make_float4(sigmoid_f32(ch.x), sigmoid_f32(ch.y), sigmoid_f32(ch.z),
                                     sigmoid_f32(ch.w));
                }
                const int i = a_frag_index(p, c, ks);   // c + 1 .. c + 3 sit 4 floats apart
                const float sm = smap[p];
                A[i] = A[i] * cg.x + o.x * sm;
                A[i + 4] = A[i + 4] * cg.y + o.y * sm;
                A[i + 8] = A[i + 8] * cg.z + o.z * sm;
                A[i + 12] = A[i + 12] * cg.w + o.w * sm;
            }
        },
        [&](int p, int n, float u0, float u1) {
            const long long gp = p0 + p;
            if (gp >= a.npix || n >= C) return;   // C is even: n + 1 < C too
            *reinterpret_cast<float2*>(a.out + gp * C + n) =
                make_float2(u0 + a.pb[n], u1 + a.pb[n + 1]);
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

// out = proj(gated sum) + pb; w1 the S-Map's fc1 [C][kMid] zero past mid, projp the
// mma_planes of proj [Kp][Kp] (ops/kernels/aim.py: gates_planes).
int aim_gates_proj(const float* att, const float* cx, const float* chvec, const float* w1,
                   const float* b1, const float* bns, const float* bnb, const float* w2,
                   const float* b2, const float* projp, const float* pb, float* out, int B,
                   int H, int W, int C, int mid, int Kp, int swap, void* stream) {
    if (C % 4 || Kp % 8 || Kp < C || Kp > kMmaMaxK || mid < 1 || mid > kMid || B < 1 ||
        H < 1 || W < 1)
        return cudaErrorInvalidValue;
    GatesArgs a = {};
    a.att = att; a.cx = cx; a.chvec = chvec; a.w1 = w1;
    a.b1 = b1; a.bns = bns; a.bnb = bnb; a.w2 = w2; a.b2 = b2;
    a.projp = reinterpret_cast<const float4*>(projp); a.pb = pb; a.out = out;
    a.npix = (long long)B * H * W; a.hw = H * W; a.C = C; a.mid = mid; a.Kp = Kp;
    a.swap = swap;
    const size_t smem = (size_t)(kMmaRows * Kp + tile_mma_ws() + kMmaRows) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(aim_gates_proj_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long nblocks = (a.npix + kMmaRows - 1) / kMmaRows;
    if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    aim_gates_proj_kernel<<<(unsigned)nblocks, kMmaThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
    return cudaGetLastError();
}

}  // extern "C"
