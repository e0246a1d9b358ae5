// The Large-Kernel-Attention gate as two hand-written kernels for Hopper (sm_90a):
//     a   = dw21x1(dw1x21(dw5x5(x)))          each depthwise stage SAME, zero padding
//     out = x * sigmoid((a @ wp) * scale + shift)
//
// Replaces the TPU kernel freqfusion_tpu/ops/pallas/lka.py:lka_gate. The plain PyTorch
// version sits beside the wrapper in freqfusion_tpu_torch/ops/kernels/lka.py.
//
// What bounds it on the H100. Per element 2 * (25 + 21 + 21) FLOPs of depthwise taps on CUDA
// cores and 2C of the 1x1 product (128 at C = 64), which runs f32-exact on the tensor cores
// here, for 8 bytes of one read of x and one write of out. Through `a` in device memory, as
// here, it moves 20 bytes an element: 2.08 GB at [9,352,512,64], 0.62 ms at 3.35 TB/s; the
// taps take 0.21 ms of the CUDA cores' 67 TFLOP/s.
//
// Design, in two launches:
//   1. lka_chain_kernel: the three depthwise convs in one pass, `a` written once. A block owns
//      a strip of kTW = 44 columns and kCH = 16 channels (a thread one channel, its taps in
//      registers) and walks down a segment of rows, 4 rows a step. Its two warp groups work
//      on neighbouring steps at once, so that each thread holds one stage's taps:
//        * warps 0-3, the 5x5 of step k: a thread owns 8 neighbouring columns of the 64
//          (44 + the 1x21's 20 halo) and keeps the partial sums of the 5 output rows that
//          the next x row touches in registers: each x row is 12 loads (from L2, the next
//          row's in flight while this one is summed) for 200 FMAs; the 4 finished rows go
//          to shared memory (two buffers: step k's and step k - 1's);
//        * warps 4-7, step k - 1's 1x21 (11 columns a thread, 31 loads for 231 FMAs) into
//          a ring of the last 24 rows in shared memory (69 KB), then its 21x1 (4 rows of two
//          columns a thread at once, 48 loads for 168 FMAs) to `a`; a barrier of the group's
//          128 threads between the two. Many independent sums a thread, since a group has
//          only two warps on each of the SM's schedulers to hide its latencies.
//      Column slots are XOR-swizzled (swz) and rows padded by 16 floats so that the two
//      half-warps of each stage use different banks. A segment starts 12 rows early (the
//      5x5's 2 and the 21x1's 10), which the first five steps spend filling the ring.
//      The padding trap: every stage pads its own input with zeros, so the 5x5's output is
//      stored 0 outside the image before the 1x21 reads it (not the 5x5 of a zero-padded x
//      continued outward), and the 1x21's output of such a row is 0 in turn.
//   2. lka_mix_kernel: the 1x1 product f32-exact on the tensor cores (3xTF32 mma.sync) with
//      the folded BatchNorm, the sigmoid and the product with x in its epilogue. Persistent
//      blocks of 8 warps take tiles of 64 rows of `a` and of x (fewer rows where C is wide),
//      staged by cp.async one tile ahead into two buffers; a warp owns 16 rows x 32 columns
//      at a time and reads wp's split B fragments (ops/kernels/_mma.py: planes, kept once a
//      weight) from L1; K goes in chunks of 8 k-steps, each into a fresh tile added in f32
//      (the tensor core's adds round toward zero). Timing variants on the H100 (PERF.md):
//      deeper rings, smaller tiles and more blocks an SM were each slower.
//
//      Above C = 1808 a tile of 16 rows of `a` no longer fits twice: lka_mix_wide_kernel then
//      reads A's fragments straight from device memory (L1 and L2 hold the rows a warp
//      walks) and takes K in chunks of 8 k-steps with the partial sums in registers across
//      the chunks, the same epilogue after the last.
//
// Layout: NHWC, contiguous; x and out f32 or bf16 (the 1x1 product on bf16 operands, `a` f32
// scratch; C up to 1808 at bf16), the weights f32; any C. w5 [25][C], wh [21][C] along W,
// wv [21][C] along H;
// wp the mma_planes of wp [C][C] ([in][out]) zero-padded to [Kp][Np], Kp % 8 == 0,
// Np % 32 == 0.

#include "mma_f32x3.cuh"

namespace {

constexpr int kTW = 44, kCH = 16;
constexpr int kACols = 8;                             // the 5x5's columns a thread
constexpr int kGroupA = (kTW + 20) / kACols * kCH;    // the 5x5's threads
constexpr int kGroup = 128;                           // the 1x21's and 21x1's threads
constexpr int kChainThreads = kGroupA + kGroup;
constexpr int kT1W = kTW + 20;      // the 5x5's columns: the 1x21's halo
constexpr int kRing = 24;           // rows of the 1x21's output a step of the 21x1 reads
constexpr int kSteps = 4;           // rows a step
constexpr int k1Cols = 11;          // the 1x21's outputs a thread takes at once
constexpr int kMixNT = 4;           // n-tiles of a warp's task in the 1x1 product
constexpr int kMixThreads = 256;
constexpr int kMixStages = 2;       // tiles of the 1x1 product in shared memory at once
constexpr int kMixRows = 64;        // rows of a tile of the 1x1 product (fewer if wide)
constexpr int kSegWaves = 6;        // chain blocks an SM that the row segments aim at

// Row strides of the 5x5's rows and of the ring: a row of columns and 16 floats more, so that
// the two half-warps of the 1x21, on neighbouring rows, use different banks.
constexpr int kT1R = kT1W * kCH + kCH, kRingR = kTW * kCH + kCH;

// Where column c of a row of kCH channels sits: groups of 4 columns swap their even and odd
// columns by the parity of bits 2 and 3, so that the 5x5's two half-warps, 4 or 8 columns
// apart, use different banks, and neighbouring columns (the 21x1's) still do.
__device__ __forceinline__ int swz(int c) { return (c ^ (((c >> 2) ^ (c >> 3)) & 1)) * kCH; }

// bar.sync on barrier `id` for the `n` threads of a warp group.
__device__ __forceinline__ void group_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n));
}

template <typename T>
__global__ void __launch_bounds__(kChainThreads, 2)
lka_chain_kernel(const T* __restrict__ x, const float* __restrict__ w5,
                 const float* __restrict__ wh, const float* __restrict__ wv,
                 float* __restrict__ a, int H, int W, int C, int seg, int nseg) {
    extern __shared__ float4 smem4[];
    float* t1 = reinterpret_cast<float*>(smem4);    // [2][kSteps] rows of kT1R floats
    float* ring = t1 + 2 * kSteps * kT1R;           // [kRing] rows of kRingR floats
    const int tid = threadIdx.x, ch = tid & 15;
    const bool taps5 = tid < kGroupA;               // the first warps: the 5x5
    const int x0 = blockIdx.x * kTW, piece = blockIdx.y / nseg;
    const int y0 = (blockIdx.y % nseg) * seg, y1 = min(H, y0 + seg);
    const int c = piece * kCH + ch;
    const bool live = c < C;
    const long long img = (long long)blockIdx.z * H * W;
    const int nsteps = (y1 - y0 + 20 + kSteps - 1) / kSteps;
    if (taps5) {
        float k5[25];
#pragma unroll
        for (int i = 0; i < 25; ++i) k5[i] = live ? w5[i * C + c] : 0.f;
        // t1 columns kACols slot .., image columns x0 - 10 + kACols slot + o
        const int slot = tid >> 4, tc0 = x0 - 10 + kACols * slot;
        float acc[5][kACols];
#pragma unroll
        for (int i = 0; i < 5; ++i)
#pragma unroll
            for (int o = 0; o < kACols; ++o) acc[i][o] = 0.f;
        float xv[kACols + 4];   // the next x row, in flight while this one is summed
        auto load = [&](int r) {   // x row r at columns tc0 - 2 .., 0 outside
            const bool rin = live && r >= 0 && r < H;
#pragma unroll
            for (int i = 0; i < kACols + 4; ++i) {
                const int xx = tc0 - 2 + i;
                xv[i] = rin && xx >= 0 && xx < W
                            ? ld1(x + (img + (long long)r * W + xx) * C + c) : 0.f;
            }
        };
        // x row r (in xv) into the partial sums; t1 row r - 2 is then whole: stored to
        // buffer row `dst`, 0 outside the image (null: a row of the warm-up)
        auto sum_row = [&](int r, float* dst) {
            float cur[kACols + 4];
#pragma unroll
            for (int i = 0; i < kACols + 4; ++i) cur[i] = xv[i];
            load(r + 1);
#pragma unroll
            for (int i = 0; i < 5; ++i)
#pragma unroll
                for (int dx = 0; dx < 5; ++dx)
#pragma unroll
                    for (int o = 0; o < kACols; ++o)
                        acc[i][o] = fmaf(k5[(4 - i) * 5 + dx], cur[o + dx], acc[i][o]);
            if (dst) {
                const bool jin = r - 2 >= 0 && r - 2 < H;
#pragma unroll
                for (int o = 0; o < kACols; ++o) {
                    const int xx = tc0 + o;
                    dst[swz(kACols * slot + o) + ch] = jin && xx >= 0 && xx < W ? acc[0][o] : 0.f;
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int o = 0; o < kACols; ++o) acc[i][o] = acc[i + 1][o];
#pragma unroll
            for (int o = 0; o < kACols; ++o) acc[4][o] = 0.f;
        };
        load(y0 - 12);
#pragma unroll 1
        for (int r = y0 - 12; r < y0 - 8; ++r) sum_row(r, nullptr);
#pragma unroll 1
        for (int k = 0; k <= nsteps; ++k) {
            if (k < nsteps) {   // t1 rows y0 - 10 + 4k + rr from x rows y0 - 8 + 4k + rr
                float* buf = t1 + (k & 1) * kSteps * kT1R;
#pragma unroll 1
                for (int rr = 0; rr < kSteps; ++rr)
                    sum_row(y0 - 8 + kSteps * k + rr, buf + rr * kT1R);
            }
            __syncthreads();   // step k's t1 stored; step k - 1's read by the other group
        }
        return;
    }
    float kh[21], kv[21];
#pragma unroll
    for (int i = 0; i < 21; ++i) {
        kh[i] = live ? wh[i * C + c] : 0.f;
        kv[i] = live ? wv[i * C + c] : 0.f;
    }
    const int gt = tid - kGroupA;
#pragma unroll 1
    for (int k = 0; k <= nsteps; ++k) {
        if (k > 0) {   // step k - 1 = kp
            const int kp = k - 1;
            const float* buf = t1 + (kp & 1) * kSteps * kT1R + ch;
            // the 1x21 of the step's rows: items (group of k1Cols columns, row, channel), 31
            // loads for 231 FMAs in 11 independent sums
#pragma unroll 1
            for (int it = gt; it < kSteps * (kTW / k1Cols) * kCH; it += kGroup) {
                const int grp = it >> 4, rr = grp % kSteps, s = grp / kSteps;
                const float* src = buf + rr * kT1R;
                float tv[k1Cols + 20];   // every load in flight before the sums
#pragma unroll
                for (int i = 0; i < k1Cols + 20; ++i) tv[i] = src[swz(k1Cols * s + i)];
                float o1[k1Cols];
#pragma unroll
                for (int o = 0; o < k1Cols; ++o) o1[o] = 0.f;
#pragma unroll
                for (int i = 0; i < k1Cols + 20; ++i)
#pragma unroll
                    for (int o = 0; o < k1Cols; ++o)
                        if (i - o >= 0 && i - o < 21) o1[o] = fmaf(kh[i - o], tv[i], o1[o]);
                float* dst = ring + ((kSteps * kp + rr) % kRing) * kRingR + ch;
#pragma unroll
                for (int o = 0; o < k1Cols; ++o) dst[swz(k1Cols * s + o)] = o1[o];
            }
            group_sync(1, kGroup);   // the ring holds t2 rows y0 - 30 + 4kp .. y0 - 7 + 4kp
            if (kp >= 5) {   // outputs start at y0 once the ring is full
                const int o0 = y0 - 20 + kSteps * kp;   // output rows o0 .. o0 + 3
                const int base = (kSteps * kp - 20) % kRing;
                // items (columns p and p + kTW / 2, channel): 48 loads for 168 FMAs in 8
                // independent sums
#pragma unroll 1
                for (int it = gt; it < kTW / 2 * kCH; it += kGroup) {
                    const int p = it >> 4;
                    float o4[2][4];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float* src = ring + swz(p + h * (kTW / 2)) + ch;
                        float tv[24];   // every load in flight before the sums
#pragma unroll
                        for (int i = 0; i < 24; ++i)
                            tv[i] = src[(base + i < kRing ? base + i : base + i - kRing) * kRingR];
#pragma unroll
                        for (int o = 0; o < 4; ++o) o4[h][o] = 0.f;
#pragma unroll
                        for (int i = 0; i < 24; ++i)
#pragma unroll
                            for (int o = 0; o < 4; ++o)
                                if (i - o >= 0 && i - o < 21)
                                    o4[h][o] = fmaf(kv[i - o], tv[i], o4[h][o]);
                    }
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int xx = x0 + p + h * (kTW / 2);
                        if (!live || xx >= W) continue;
#pragma unroll
                        for (int o = 0; o < 4; ++o)
                            if (o0 + o < y1)
                                a[(img + (long long)(o0 + o) * W + xx) * C + c] = o4[h][o];
                    }
                }
            }
        }
        __syncthreads();   // pairs the 5x5 group's barrier; the ring's rows read
    }
}

// out = x * sigmoid((a @ wp) * scale + shift) on P rows of C. Persistent blocks take tiles of
// TR rows of `a` and (xs) of x into shared memory (kMixStages buffers each, cp.async one tile
// ahead; columns C .. Kp and rows past P zero); without xs the epilogue reads x from device
// memory (rows too wide for both tiles). A warp task is 16 rows x kMixNT n-tiles of a tile.
template <bool VEC, typename T>
__global__ void __launch_bounds__(kMixThreads, 2)
lka_mix_kernel(const float* __restrict__ a, const T* __restrict__ x,
               const float4* __restrict__ wp, const float* __restrict__ scale,
               const float* __restrict__ shift, T* __restrict__ out, long long P, int C,
               int Kp, int Np, int TR, bool xs) {
    constexpr int PS = kPasses<T>;
    extern __shared__ float4 smem4[];
    const int lda = Kp + 4, tid = threadIdx.x, warp = tid >> 5;
    float* As = reinterpret_cast<float*>(smem4);   // [stages][TR][lda]
    float* Xs = As + kMixStages * TR * lda;     // [stages][TR][lda] x
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int ksteps = Kp / 8, ntw = Np / 8, ngroups = ntw / kMixNT, mts = TR / 16;
    const long long ntiles = (P + TR - 1) / TR;
    for (int e = tid; e < kMixStages * TR * (lda - C); e += kMixThreads) {   // A's columns C ..: 0
        const int r = e / (lda - C);
        As[r * lda + C + e - r * (lda - C)] = 0.f;
    }
    auto copy = [&](float* dst, const auto* src, long long r0) {   // TR rows of src
        if (VEC) {
            const int q = C / 4;
            for (int e = tid; e < TR * q; e += kMixThreads) {
                const int r = e / q, cc = 4 * (e - r * q);
                if (r0 + r < P)
                    stage4(dst + r * lda + cc, src + (r0 + r) * C + cc);
                else
                    *reinterpret_cast<float4*>(dst + r * lda + cc) =
                        make_float4(0.f, 0.f, 0.f, 0.f);
            }
        } else {
            for (int e = tid; e < TR * C; e += kMixThreads) {
                const int r = e / C, cc = e - r * C;
                if (r0 + r < P)
                    cp_async4(dst + r * lda + cc, src + (r0 + r) * C + cc);
                else
                    dst[r * lda + cc] = 0.f;
            }
        }
    };
    auto stage = [&](long long tile) {
        if (tile < ntiles) {
            const int buf = tile / gridDim.x % kMixStages;
            copy(As + buf * TR * lda, a, tile * TR);
            if (xs) copy(Xs + buf * TR * lda, x, tile * TR);
        }
        cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i + 1 < kMixStages; ++i) stage(blockIdx.x + (long long)i * gridDim.x);
    for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        cp_async_wait<kMixStages - 2>();
        // the tile visible to every thread, every thread past the last tile: its buffer may
        // be refilled
        __syncthreads();
        stage(tile + (long long)(kMixStages - 1) * gridDim.x);
        const float* At = As + (tile / gridDim.x % kMixStages) * TR * lda;
        const float* Xt = Xs + (tile / gridDim.x % kMixStages) * TR * lda;
        for (int task = warp; task < mts * ngroups; task += kMixThreads / 32) {
            const int mt = task / ngroups, nt0 = task % ngroups * kMixNT;
            const long long ra = tile * TR + 16 * mt + g, rb = ra + 8;
            const bool va = ra < P, vb = rb < P;
            float acc[kMixNT][4];
#pragma unroll
            for (int j = 0; j < kMixNT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
            for (int k0 = 0; k0 < ksteps; k0 += 8) {   // a fresh tile every 8 k-steps
                float part[kMixNT][4];
#pragma unroll
                for (int j = 0; j < kMixNT; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll 4
                for (int s = k0; s < min(ksteps, k0 + 8); ++s) {
                    Frag<4, PS> fa;
                    load_a(fa, At, lda, 16 * mt, 8 * s);
                    const float4* wk = wp + ((size_t)s * ntw + nt0) * 32 + lane;
                    uint32_t bh[kMixNT][2], bl[kMixNT][2];
#pragma unroll
                    for (int j = 0; j < kMixNT; ++j) {
                        const float4 b = __ldg(wk + j * 32);
                        bh[j][0] = __float_as_uint(b.x);
                        bh[j][1] = __float_as_uint(b.y);
                        bl[j][0] = __float_as_uint(b.z);
                        bl[j][1] = __float_as_uint(b.w);
                    }
                    // the three terms of every tile interleaved, the small ones first
#pragma unroll
                    for (int j = 0; j < kMixNT; ++j) mma_planes_step(part[j], fa, bh[j], bl[j]);
                }
#pragma unroll
                for (int j = 0; j < kMixNT; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
            }
            const int pa = 16 * mt + g;
#pragma unroll
            for (int j = 0; j < kMixNT; ++j) {
                const int n = 8 * (nt0 + j) + 2 * t;
                if (!VEC) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    if (n + e >= C) continue;
                    const float sc = scale[n + e], sh = shift[n + e];
                    if (va)
                        st1(out + ra * C + n + e,
                            (xs ? Xt[pa * lda + n + e] : ld1(x + ra * C + n + e)) *
                                sigmoid_f32(fmaf(acc[j][e], sc, sh)));
                    if (vb)
                        st1(out + rb * C + n + e,
                            (xs ? Xt[(pa + 8) * lda + n + e] : ld1(x + rb * C + n + e)) *
                                sigmoid_f32(fmaf(acc[j][2 + e], sc, sh)));
                }
                } else if (n < C) {   // C % 4 == 0: n and n + 1 are both real
                    const float2 sc = *reinterpret_cast<const float2*>(scale + n);
                    const float2 sh = *reinterpret_cast<const float2*>(shift + n);
                    if (va) {
                        const float2 xa = xs ? ld2(Xt + pa * lda + n) : ld2(x + ra * C + n);
                        st2(out + ra * C + n,
                            make_float2(xa.x * sigmoid_f32(fmaf(acc[j][0], sc.x, sh.x)),
                                        xa.y * sigmoid_f32(fmaf(acc[j][1], sc.y, sh.y))));
                    }
                    if (vb) {
                        const float2 xb =
                            xs ? ld2(Xt + (pa + 8) * lda + n) : ld2(x + rb * C + n);
                        st2(out + rb * C + n,
                            make_float2(xb.x * sigmoid_f32(fmaf(acc[j][2], sc.x, sh.x)),
                                        xb.y * sigmoid_f32(fmaf(acc[j][3], sc.y, sh.y))));
                    }
                }
            }
        }
    }
    cp_async_wait<0>();
}

// out = x * sigmoid((a @ wp) * scale + shift) for rows too wide to stage (C > 1808): a warp
// task is 16 rows x kMixNT n-tiles, A's fragments read from device memory (0 past row P and
// column C), K in chunks of 8 k-steps, each into a fresh tile added in f32.
__global__ void __launch_bounds__(kMixThreads)
lka_mix_wide_kernel(const float* __restrict__ a, const float* __restrict__ x,
                    const float4* __restrict__ wp, const float* __restrict__ scale,
                    const float* __restrict__ shift, float* __restrict__ out, long long P, int C,
                    int Kp, int Np) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int ksteps = Kp / 8, ntw = Np / 8, ngroups = ntw / kMixNT;
    const long long ntasks = (P + 15) / 16 * ngroups, nwarps = (long long)gridDim.x * kMixThreads / 32;
    for (long long task = (long long)blockIdx.x * kMixThreads / 32 + (threadIdx.x >> 5);
         task < ntasks; task += nwarps) {
        const long long ra = task / ngroups * 16 + g, rb = ra + 8;
        const int nt0 = (int)(task % ngroups) * kMixNT;
        const bool va = ra < P, vb = rb < P;
        auto at = [&](long long r, bool v, int k) { return v && k < C ? __ldg(a + r * C + k) : 0.f; };
        float acc[kMixNT][4];
#pragma unroll
        for (int j = 0; j < kMixNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        for (int k0 = 0; k0 < ksteps; k0 += 8) {
            float part[kMixNT][4];
#pragma unroll
            for (int j = 0; j < kMixNT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll 2
            for (int s = k0; s < min(ksteps, k0 + 8); ++s) {
                FragA fa;
                const int k = 8 * s + t;
                fa.set(0, at(ra, va, k));
                fa.set(1, at(rb, vb, k));
                fa.set(2, at(ra, va, k + 4));
                fa.set(3, at(rb, vb, k + 4));
                const float4* wk = wp + ((size_t)s * ntw + nt0) * 32 + lane;
                uint32_t bh[kMixNT][2], bl[kMixNT][2];
#pragma unroll
                for (int j = 0; j < kMixNT; ++j) {
                    const float4 b = __ldg(wk + j * 32);
                    bh[j][0] = __float_as_uint(b.x);
                    bh[j][1] = __float_as_uint(b.y);
                    bl[j][0] = __float_as_uint(b.z);
                    bl[j][1] = __float_as_uint(b.w);
                }
#pragma unroll
                for (int j = 0; j < kMixNT; ++j) mma_tf32(part[j], fa.lo, bh[j]);
#pragma unroll
                for (int j = 0; j < kMixNT; ++j) mma_tf32(part[j], fa.hi, bl[j]);
#pragma unroll
                for (int j = 0; j < kMixNT; ++j) mma_tf32(part[j], fa.hi, bh[j]);
            }
#pragma unroll
            for (int j = 0; j < kMixNT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
        }
#pragma unroll
        for (int j = 0; j < kMixNT; ++j) {
            const int n = 8 * (nt0 + j) + 2 * t;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                if (n + e >= C) continue;
                const float sc = scale[n + e], sh = shift[n + e];
                if (va) out[ra * C + n + e] = x[ra * C + n + e] * sigmoid_f32(fmaf(acc[j][e], sc, sh));
                if (vb)
                    out[rb * C + n + e] =
                        x[rb * C + n + e] * sigmoid_f32(fmaf(acc[j][2 + e], sc, sh));
            }
        }
    }
}

// Segments of rows a chain block walks: the fewest that give the card about kSegWaves chain
// blocks an SM (two run at once), each at least 32 rows.
int lka_segments(int B, int H, int W, int C) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return -1;
    const long long base = (long long)B * ((W + kTW - 1) / kTW) * ((C + kCH - 1) / kCH);
    long long nseg = ((long long)kSegWaves * sms + base - 1) / base;
    nseg = nseg < 1 ? 1 : nseg;
    const long long most = (H + 31) / 32;
    return (int)(nseg < most ? nseg : most);
}

}  // namespace

namespace {

template <typename T>
cudaError_t gate(const T* x, const float* w5, const float* wh, const float* wv,
                 const float* wp, const float* scale, const float* shift, float* a, T* out,
                 int B, int H, int W, int C, int Kp, int Np, cudaStream_t st) {
    const int nseg = lka_segments(B, H, W, C);
    if (nseg < 1) return cudaErrorInvalidDevice;
    const int seg = (H + nseg - 1) / nseg;
    const size_t smem = (size_t)(2 * kSteps * kT1R + kRing * kRingR) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        lka_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long gy = (long long)((C + kCH - 1) / kCH) * nseg;
    if (gy > 65535) return cudaErrorInvalidValue;
    dim3 grid((W + kTW - 1) / kTW, (unsigned)gy, B);
    lka_chain_kernel<T><<<grid, kChainThreads, smem, st>>>(x, w5, wh, wv, a, H, W, C, seg, nseg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    // tiles of kMixRows rows, fewer where a row is wide: the buffers of a and x in at most
    // 108 KB, two blocks an SM; rows too wide for that stage `a` alone, in up to 227 KB
    int TR = kMixRows;
    while (TR > 16 && 2LL * kMixStages * TR * (Kp + 4) * 4 > 110592) TR /= 2;
    const bool xs = 2LL * kMixStages * TR * (Kp + 4) * 4 <= 110592;
    const size_t msmem = (size_t)(xs ? 2 : 1) * kMixStages * TR * (Kp + 4) * sizeof(float);
    if (msmem > 232448) {   // too wide to stage: A from device memory (f32 only)
        if constexpr (kBf16<T>) return cudaErrorInvalidValue;
        const long long tasks = ((long long)B * H * W + 15) / 16 * (Np / (8 * kMixNT));
        const long long blocks = (tasks + kMixThreads / 32 - 1) / (kMixThreads / 32);
        const int grid3 = (int)(blocks < 4LL * sms ? blocks : 4LL * sms);
        if constexpr (!kBf16<T>) {
            lka_mix_wide_kernel<<<grid3, kMixThreads, 0, st>>>(
                a, x, reinterpret_cast<const float4*>(wp), scale, shift, out,
                (long long)B * H * W, C, Kp, Np);
        }
        return cudaGetLastError();
    }
    const auto mix = C % 4 ? lka_mix_kernel<false, T> : lka_mix_kernel<true, T>;
    err = cudaFuncSetAttribute(mix, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)msmem);
    if (err != cudaSuccess) return err;
    const long long P = (long long)B * H * W, ntiles = (P + TR - 1) / TR;
    const int grid2 = (int)(ntiles < 2LL * sms ? ntiles : 2LL * sms);
    mix<<<grid2, kMixThreads, msmem, st>>>(a, x, reinterpret_cast<const float4*>(wp), scale,
                                           shift, out, P, C, Kp, Np, TR, xs);
    return cudaGetLastError();
}

}  // namespace

// a [B][H][W][C] f32 scratch; wp the planes of wp [Kp][Np] (ops/kernels/_mma.py). x and out
// f32, or bf16 where `bf16_io` is set (then C <= 1808: the wide product is f32 only).
extern "C" int lka_gate(const float* x, const float* w5, const float* wh, const float* wv,
                        const float* wp, const float* scale, const float* shift, float* a,
                        float* out, int B, int H, int W, int C, int Kp, int Np, int bf16_io,
                        void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B < 1 || H < 1 || W < 1 || B > 65535 || C < 1 || Kp < C || Kp % 8 || Np < C ||
        Np % (8 * kMixNT))
        return cudaErrorInvalidValue;
    if (bf16_io)
        return gate(reinterpret_cast<const bf16*>(x), w5, wh, wv, wp, scale, shift, a,
                    reinterpret_cast<bf16*>(out), B, H, W, C, Kp, Np, st);
    return gate(x, w5, wh, wv, wp, scale, shift, a, out, B, H, W, C, Kp, Np, st);
}
