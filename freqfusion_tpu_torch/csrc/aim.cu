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
// 8 bytes moved: bound by bytes (0.0775 ms at [1,352,512,180]). So the design is about
// traffic and the loads in flight:
//   * v is staged once: a block owns a strip of 16 rows of tw columns and a slice of sq
//     channel quads (all 45 at C = 180, tw = 8: 360 threads, every one with work; above 48
//     quads the channels go in slices as even as they fall), and brings each input row of
//     the strip with its 1-pixel halo into a ring of 4 stages by cp.async, three rows in
//     flight ahead of the one read. SAME padding: zeros stored for rows and columns outside
//     the image.
//   * A thread owns a channel quad and a column, walks down the strip, and reads 3 quads of
//     each input row from shared memory (conflict-free: neighbouring threads on neighbouring
//     quads); the row's taps go into the three outputs it feeds, kept in registers, in the
//     order dy, dx of the plain conv (the weights sit in registers too: 80 registers, two
//     blocks an SM). Variants timed on the H100 (PERF.md): strips of 8 or 32 rows, a ring of
//     6 and one block an SM were all slower.
//   * The TPU kernel carried the sum across its sequential grid. Blocks run in no order
//     here: a thread sums its column in registers, the block adds its columns in a fixed
//     order and writes part[B][nblk][C], and sum_partials (common.cuh) adds the blocks in a
//     fixed order. No atomics: the sums are the same bits from run to run.
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
//   * Above C = 192 (WIDE) a row no longer fits beside the ring: the S-Map is a first pass
//     over src from device memory, then the gated sum is staged in K pieces of at most 192
//     (tile_mma_piece) and each piece's sums are added in f32 in the block's rows of y (out
//     itself for f32 storage, an f32 scratch for bf16), the last piece storing out once. An
//     S-Map wider than 12 takes its sums 12 at a time, a pass over the rows each. Neither
//     pass is taken at C <= 192 with mid <= 12.
//   * P = 1 (bf16, and precision "default" on f32 storage): the S-Map's source and fc1, its
//     GELU output and fc2, and the gated sum and proj are rounded to bf16 as operands, as the
//     TPU kernel casts them; B5a has no product and no operand mode (its f32 instantiation
//     serves precision "default").
//
// Layout: NHWC, contiguous, f32 or bf16 (B5a: v and conv_x; B5b: attened, conv_x and out);
// C % 4 == 0. wdw [9][C]; si_w2 [mid]; chvec [B][C], the
// C-Map before its sigmoid; B5b's fc1 and proj as GatesArgs says.

#include "mma_f32x3.cuh"

namespace {

// B5a: a block's threads (at most), output rows of its strip, staged input rows (a ring: the
// one read and three in flight), and the widest channel slice, in quads.
constexpr int kConvThreads = 384, kConvRows = 16, kConvRing = 4, kConvMaxSQ = 48;
constexpr int kMid = 12;             // B5b: the S-Map's sums a lane keeps (a group of mid)

// B5a's tiling for C channels: a slice of sq channel quads, ns slices, tw columns a block.
struct ConvTiles {
    int sq, ns, tw;
};
__host__ __device__ inline ConvTiles conv_tiles(int C) {
    const int nq = C / 4, ns = (nq + kConvMaxSQ - 1) / kConvMaxSQ, sq = (nq + ns - 1) / ns;
    return {sq, ns, kConvThreads / sq < 16 ? kConvThreads / sq : 16};
}

// T: the storage type of v and cx (f32, or bf16: the CUDA-core taps multiply the bf16 values
// in f32, and the sums are taken of cx before its rounding). At bf16 a staged quad is its 8
// raw bytes, copied by cp.async and converted where it is read: a load and a conversion in
// the staging loop kept registers live across it, and the kernel spilled under its cap.
template <typename T>
__global__ void __launch_bounds__(kConvThreads, 2)
aim_conv_branch_kernel(const T* __restrict__ v, const float* __restrict__ wdw,
                       const float* __restrict__ bdw, const float* __restrict__ bns,
                       const float* __restrict__ bnb, T* __restrict__ cx,
                       float* __restrict__ part, int H, int W, int C) {
    extern __shared__ float4 ring[];   // [kConvRing][tw + 2][sq]: input rows with their halo
    const ConvTiles tl = conv_tiles(C);
    const int sq = tl.sq, tw = tl.tw, nthreads = sq * tw;   // blockDim.x
    const int tid = threadIdx.x, q = tid % sq, xl = tid / sq;
    const int bi = blockIdx.z / tl.ns, q0 = (blockIdx.z % tl.ns) * sq;
    const int nqs = min(sq, C / 4 - q0);   // quads of this slice (the last may be short)
    const int x0 = blockIdx.x * tw, y0 = blockIdx.y * kConvRows, x = x0 + xl, c = 4 * (q0 + q);
    const bool mine = q < nqs && x < W;
    const int rowq = (tw + 2) * sq;   // float4s of a staged row
    const T* vb = v + (size_t)bi * H * W * C;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

    // input row y0 - 1 + i (with its columns x0 - 1 .. x0 + tw) into stage i % kConvRing, zero
    // outside the image (SAME padding); one commit group a row, empty past the strip. A
    // stage holds rowq float4s, or at bf16 rowq raw quads of 8 bytes in its first half.
    uint2* ring2 = reinterpret_cast<uint2*>(ring);
    auto stage = [&](int i) {
        if (i < kConvRows + 2) {
            const int y = y0 - 1 + i, s0 = (i % kConvRing) * rowq;
            for (int e = tid; e < rowq; e += nthreads) {
                const int px = e / sq, qq = e - px * sq, xx = x0 - 1 + px;
                const bool in = y >= 0 && y < H && xx >= 0 && xx < W && qq < nqs;
                const T* src = vb + ((size_t)y * W + xx) * C + 4 * (q0 + qq);
                if constexpr (kBf16<T>) {
                    if (in)
                        cp_async8(reinterpret_cast<float*>(ring2 + s0 + e),
                                  reinterpret_cast<const float*>(src));
                    else
                        ring2[s0 + e] = make_uint2(0u, 0u);
                } else {
                    if (in)
                        stage4(reinterpret_cast<float*>(ring + s0 + e), src);
                    else
                        ring[s0 + e] = zero;
                }
            }
        }
        cp_async_commit();
    };
    // the staged quad at index j of the ring, as f32
    auto quad = [&](int j) -> float4 {
        if constexpr (kBf16<T>) return ld4(reinterpret_cast<const bf16*>(ring2 + j));
        else return ring[j];
    };
#pragma unroll
    for (int i = 0; i < kConvRing - 1; ++i) stage(i);

    float4 wk[9], s0 = zero, h0 = zero;
#pragma unroll
    for (int k = 0; k < 9; ++k) wk[k] = mine ? ld4(wdw + k * C + c) : zero;
    if (mine) {
        s0 = ld4(bns + c);
        h0 = ld4(bnb + c);
    }
    // the outputs that input row i feeds: out[i - 2] (taps dy = 2, then done), out[i - 1]
    // (dy = 1), out[i] (dy = 0, started from the bias): the taps in the order dy, dx
    float4 a2 = zero, a1 = zero, psum = zero;
    auto taps = [&](float4& a, const float4& l, const float4& m, const float4& r, int dy) {
        const float4 w0 = wk[3 * dy], w1 = wk[3 * dy + 1], w2 = wk[3 * dy + 2];
        a.x = fmaf(r.x, w2.x, fmaf(m.x, w1.x, fmaf(l.x, w0.x, a.x)));
        a.y = fmaf(r.y, w2.y, fmaf(m.y, w1.y, fmaf(l.y, w0.y, a.y)));
        a.z = fmaf(r.z, w2.z, fmaf(m.z, w1.z, fmaf(l.z, w0.z, a.z)));
        a.w = fmaf(r.w, w2.w, fmaf(m.w, w1.w, fmaf(l.w, w0.w, a.w)));
    };
    for (int i = 0; i < kConvRows + 2; ++i) {
        cp_async_wait<kConvRing - 2>();   // this thread's copies of row i have landed
        // row i visible to every thread, and every thread is past row i - 1: its stage may
        // be refilled
        __syncthreads();
        stage(i + kConvRing - 1);
        const int row = (i % kConvRing) * rowq + xl * sq + q;
        const float4 l = quad(row), m = quad(row + sq), r = quad(row + 2 * sq);
        float4 a0 = mine ? ld4(bdw + c) : zero;
        taps(a2, l, m, r, 2);
        taps(a1, l, m, r, 1);
        taps(a0, l, m, r, 0);
        const int y = y0 + i - 2;   // a2 is out[y]
        if (i >= 2 && mine && y < H) {
            const float4 o = make_float4(
                gelu_erf(fmaf(a2.x, s0.x, h0.x)), gelu_erf(fmaf(a2.y, s0.y, h0.y)),
                gelu_erf(fmaf(a2.z, s0.z, h0.z)), gelu_erf(fmaf(a2.w, s0.w, h0.w)));
            st4(cx + (((size_t)bi * H + y) * W + x) * C + c, o);
            psum.x += o.x;
            psum.y += o.y;
            psum.z += o.z;
            psum.w += o.w;
        }
        a2 = a1;
        a1 = a0;
    }
    // the block's sums of each channel: its columns added in a fixed order (no atomics)
    cp_async_wait<0>();
    __syncthreads();   // every thread is past its reads of the ring
    ring[xl * sq + q] = psum;
    __syncthreads();
    if (tid < nqs) {
        float4 t = zero;
        for (int j = 0; j < tw; ++j) {
            const float4 u = ring[j * sq + tid];
            t.x += u.x;
            t.y += u.y;
            t.z += u.z;
            t.w += u.w;
        }
        const int nblk = gridDim.x * gridDim.y, blk = blockIdx.y * gridDim.x + blockIdx.x;
        *reinterpret_cast<float4*>(part + ((size_t)bi * nblk + blk) * C + 4 * (q0 + tid)) = t;
    }
}

// B5b's arguments.
template <typename T>
struct GatesArgs {
    const T *att, *cx;    // attened, conv_x [npix][C]
    const float* chvec;   // the C-Map [B][C]
    const float* w1;      // the S-Map's fc1 in groups of kMid: [ceil(mid / kMid)][C][kMid]
    const float *b1, *bns, *bnb, *w2, *b2;   // fc1's bias, BN's affine, fc2 [mid], its bias
    const float4* projp;  // mma_planes of proj [Kp][Kp]
    const float* pb;
    T* out;
    float* y;             // WIDE: the K pieces' sums, f32 [npix][C] (out itself for f32)
    long long npix;
    int hw, C, mid, Kp, swap;
};

// One group of kMid of the S-Map's hidden units for pixel p (4 lanes a pixel, lane q taking
// the channels 4q, 4q + 16, ..): the dot products of src's row with the group's fc1 columns
// (w1s, [C][kMid] in shared memory) in registers, a butterfly over the 4 lanes, then BN,
// GELU and fc2 added to s in the order of the hidden units. STAGE: the row also goes into
// A (zero in its padded columns), as the projection's operand (unrounded: the gated sum is
// taken of it in f32). At P = 1 the row, fc1 (rounded where it is staged), GELU's output
// and fc2 are bf16 operands.
template <bool STAGE, int P, typename T>
__device__ __forceinline__ float smap_group(const GatesArgs<T>& a, const T* src,
                                            const float* w1s, float* A, int ks, int p, int q,
                                            long long gp, int grp, float s) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float d[kMid];
#pragma unroll
    for (int m = 0; m < kMid; ++m) d[m] = 0.f;
#pragma unroll 4
    for (int c = 4 * q; c < (STAGE ? a.Kp : a.C); c += 16) {
        const float4 v = gp < a.npix && c < a.C ? ld4(src + gp * a.C + c) : zero;
        if (STAGE) put4(A, p, c, ks, v);
        if (c >= a.C) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float x = rop<P>(lane4(v, i));
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
#pragma unroll
    for (int m = 0; m < kMid; ++m) {
        float t = d[m];
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        const int j = grp * kMid + m;
        // GELU's output is an operand of the S-Map's second product: rounded at P = 1, as
        // the TPU kernel casts it
        if (j < a.mid)
            s = fmaf(rop<P>(gelu_erf(fmaf(t + a.b1[j], a.bns[j], a.bnb[j]))), rop<P>(a.w2[j]),
                     s);
    }
    return s;
}

// WIDE: C above kMmaMaxK (192), the projection's K in pieces (tile_mma_piece); else in one.
template <bool WIDE, int P, typename T>
__global__ void __launch_bounds__(kMmaThreads, 1)
aim_gates_proj_kernel(const GatesArgs<T> a) {
    extern __shared__ float4 smem4[];
    const int C = a.C, Kp = a.Kp, Kt = WIDE ? tile_mma_piece(Kp) : Kp, ks = Kp / 8;
    float* A = reinterpret_cast<float*>(smem4);   // [128 x Kt] A-fragment order
    float* ws = A + kMmaRows * Kt;                 // tile_mma's ring
    float* smap = ws + tile_mma_ws();              // [128] the S-Map before its sigmoid
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long p0 = (long long)blockIdx.x * kMmaRows;
    // the S-Map's input, gated by the C-Map; the other input, gated by the S-Map: either
    // wiring is y = src * s(C-Map) + oth * s(S-Map(src))
    const T* src = a.swap ? a.cx : a.att;
    const T* oth = a.swap ? a.att : a.cx;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

    // the S-Map: 4 lanes a pixel, 8 pixels a warp, fc1's weights a group of kMid at a time in
    // the ring's memory (tile_mma has not started). At C <= 192 the first group's pass
    // stages src into A; a further group (mid > kMid) passes over src's rows again, from
    // device memory, as every group does above 192 (A then takes the gated sum in pieces).
    float* w1s = ws;
    for (int e = tid; e < C * kMid; e += kMmaThreads) w1s[e] = rop<P>(a.w1[e]);
    __syncthreads();
    {
        const int p = 8 * warp + (lane >> 2), q = lane & 3;
        const long long gp = p0 + p;
        float s = smap_group<!WIDE, P>(a, src, w1s, A, ks, p, q, gp, 0, 0.f);
        for (int grp = 1; grp * kMid < a.mid; ++grp) {
            __syncthreads();   // every lane is past its reads of the last group's weights
            for (int e = tid; e < C * kMid; e += kMmaThreads)
                w1s[e] = rop<P>(a.w1[grp * C * kMid + e]);
            __syncthreads();
            s = smap_group<false, P>(a, src, w1s, A, ks, p, q, gp, grp, s);
        }
        if (q == 0) smap[p] = s;
    }
    // the gated sum of columns k0 .. k0 + kh into A at k-steps of kh / 8 (over src's staged
    // rows at C <= 192; from device memory above): a thread owns a column quad and every
    // R-th row, so that it takes the C-Map's sigmoids once an image. The first call takes
    // the S-Map's sigmoid.
    auto gated = [&](int k0, int kh) {
        if (k0 == 0) {
            if (tid < kMmaRows) smap[tid] = sigmoid_f32(smap[tid] + a.b2[0]);
            __syncthreads();
        }
        const int kq = (WIDE ? kh : C) / 4, R = kMmaThreads / kq, rg = tid / kq;
        const int c = k0 + (tid % kq) * 4;
        if (rg >= R) return;
        long long img = -1;
        float4 cg = zero;
#pragma unroll 4
        for (int p = rg; p < kMmaRows; p += R) {
            const long long gp = p0 + p;
            if (!WIDE && gp >= a.npix) break;   // A holds zeros there
            if (WIDE && (gp >= a.npix || c >= C)) {   // padded rows and columns: zeros
                put4(A, p, c - k0, kh / 8, zero);
                continue;
            }
            const float4 o = ld4(oth + gp * C + c);
            if (gp / a.hw != img) {
                img = gp / a.hw;
                const float4 ch = ld4(a.chvec + img * C + c);
                cg = make_float4(sigmoid_f32(ch.x), sigmoid_f32(ch.y), sigmoid_f32(ch.z),
                                 sigmoid_f32(ch.w));
            }
            const float sm = smap[p];
            if (WIDE) {
                const float4 v = ld4(src + gp * C + c);
                put4(A, p, c - k0, kh / 8,
                     make_float4(v.x * cg.x + o.x * sm, v.y * cg.y + o.y * sm,
                                 v.z * cg.z + o.z * sm, v.w * cg.w + o.w * sm));
            } else {
                const int i = a_frag_index(p, c, ks);   // c + 1 .. c + 3 sit 4 floats apart
                A[i] = A[i] * cg.x + o.x * sm;
                A[i + 4] = A[i + 4] * cg.y + o.y * sm;
                A[i + 8] = A[i + 8] * cg.z + o.z * sm;
                A[i + 12] = A[i + 12] * cg.w + o.w * sm;
            }
        }
    };
    // the projection (tile_mma synchronises first); in pieces, each piece's sums added to
    // the last's in f32 in y's rows of this block, the last piece storing out
    for (int k0 = 0; k0 < Kp; k0 += Kt) {
        const int kh = min(Kt, Kp - k0);
        const bool last = k0 + kh == Kp;
        tile_mma<P>(
            A, kh, a.projp + (size_t)(k0 / 8) * (Kp / 8) * 32, Kp / 8, Kp, ws,
            [&] { gated(k0, kh); },
            [&](int p, int n, float u0, float u1) {
                const long long gp = p0 + p;
                if (gp >= a.npix || n >= C) return;   // C is even: n + 1 < C too
                if (!WIDE) {
                    st2(a.out + gp * C + n, make_float2(u0 + a.pb[n], u1 + a.pb[n + 1]));
                    return;
                }
                float2* yp = reinterpret_cast<float2*>(a.y + gp * C + n);
                float2 s = make_float2(u0 + a.pb[n], u1 + a.pb[n + 1]);
                if (k0 > 0) {
                    const float2 y = *yp;
                    s = make_float2(y.x + u0, y.y + u1);
                }
                if (last) st2(a.out + gp * C + n, s);
                else *yp = s;
            });
    }
}

template <bool WIDE, int P, typename T>
cudaError_t gates(const T* att, const T* cx, const float* chvec, const float* w1,
                  const float* b1, const float* bns, const float* bnb, const float* w2,
                  const float* b2, const float* projp, const float* pb, T* out, float* y,
                  int B, int H, int W, int C, int mid, int Kp, int swap, cudaStream_t st) {
    GatesArgs<T> a = {};
    a.att = att; a.cx = cx; a.chvec = chvec; a.w1 = w1;
    a.b1 = b1; a.bns = bns; a.bnb = bnb; a.w2 = w2; a.b2 = b2;
    a.projp = reinterpret_cast<const float4*>(projp); a.pb = pb; a.out = out; a.y = y;
    a.npix = (long long)B * H * W; a.hw = H * W; a.C = C; a.mid = mid; a.Kp = Kp;
    a.swap = swap;
    const size_t smem =
        (size_t)(kMmaRows * tile_mma_piece(Kp) + tile_mma_ws() + kMmaRows) * sizeof(float);
    const auto kernel = aim_gates_proj_kernel<WIDE, P, T>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long nblocks = (a.npix + kMmaRows - 1) / kMmaRows;
    if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    kernel<<<(unsigned)nblocks, kMmaThreads, smem, st>>>(a);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of B5a blocks per image and channel slice: the length of the partial-sum scratch's
// middle axis.
int aim_conv_branch_blocks(int H, int W, int C) {
    return ((H + kConvRows - 1) / kConvRows) * ((W + conv_tiles(C).tw - 1) / conv_tiles(C).tw);
}

// v and cx in the storage type of `mode` (common.cuh: IoMode; B5a takes no product, so
// modes 0 and 2 are one instantiation); the rest f32.
int aim_conv_branch(const float* v, const float* wdw, const float* bdw, const float* bns,
                    const float* bnb, float* cx, float* part, float* sums, int B, int H, int W,
                    int C, int mode, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (C % 4 || C < 4 || B < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
    const ConvTiles tl = conv_tiles(C);
    const size_t smem = (size_t)kConvRing * (tl.tw + 2) * tl.sq * sizeof(float4);
    const dim3 grid((W + tl.tw - 1) / tl.tw, (H + kConvRows - 1) / kConvRows, B * tl.ns);
    if (grid.z > 65535) return cudaErrorInvalidValue;
    const cudaError_t err = by_mode(mode, [&](auto m) {
        using T = typename decltype(m)::T;
        const auto kernel = aim_conv_branch_kernel<T>;
        cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        kernel<<<grid, tl.sq * tl.tw, smem, st>>>(as<T>(v), wdw, bdw, bns, bnb, as<T>(cx), part,
                                                  H, W, C);
        return cudaGetLastError();
    });
    if (err != cudaSuccess) return err;
    return sum_partials(part, sums, B, aim_conv_branch_blocks(H, W, C), C, st);
}

// out = proj(gated sum) + pb; w1 the S-Map's fc1 in groups of kMid [ceil(mid / kMid)][C][kMid]
// zero past mid, projp the mma_planes of proj [Kp][Kp] (ops/kernels/aim.py: gates_planes).
// att, cx and out in the storage type of `mode` (common.cuh: IoMode); chvec and the weights
// f32. y: at bf16 above C = 192, f32 scratch [B*H*W][C] where the K pieces sum (null
// otherwise: f32 storage sums them in out).
int aim_gates_proj(const float* att, const float* cx, const float* chvec, const float* w1,
                   const float* b1, const float* bns, const float* bnb, const float* w2,
                   const float* b2, const float* projp, const float* pb, float* out, float* y,
                   int B, int H, int W, int C, int mid, int Kp, int swap, int mode,
                   void* stream) {
    if (C % 4 || Kp % 8 || Kp < C || Kp >= C + 8 || C * kMid > tile_mma_ws() || mid < 1 ||
        B < 1 || H < 1 || W < 1)
        return cudaErrorInvalidValue;
    const bool wide = tile_mma_piece(Kp) != Kp;
    if (mode == 1 && wide && !y) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return by_mode(mode, [&](auto m) {
        using T = typename decltype(m)::T;
        constexpr int P = decltype(m)::P;
        if (wide)
            return gates<true, P>(as<T>(att), as<T>(cx), chvec, w1, b1, bns, bnb, w2, b2, projp,
                                  pb, as<T>(out), kBf16<T> ? y : out, B, H, W, C, mid, Kp, swap,
                                  st);
        return gates<false, P>(as<T>(att), as<T>(cx), chvec, w1, b1, bns, bnb, w2, b2, projp, pb,
                               as<T>(out), nullptr, B, H, W, C, mid, Kp, swap, st);
    });
}

}  // extern "C"
