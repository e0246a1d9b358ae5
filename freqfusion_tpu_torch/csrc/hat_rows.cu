// Per-pixel row work, projection + residuals + LayerNorm + MLP, as one hand-written f32-exact
// product kernel for Hopper (sm_90a) in four modes, launched in sequence:
//   * hab_tail, the second half of the fused HAB block (B8), after csrc/hab_attention.cu's
//     attention:  y = x + att @ wproj + bproj + conv_scale * cab_scale * conv_x   (proj)
//                 hidden = GELU(LN2(y) @ w1 + b1)                                  (fc1)
//                 out = y + hidden @ w2 + b2                                       (fc2)
//   * residual_ln_mlp (B10):  y = a + shortcut, then fc1 and fc2 as above;
//   * rows_ln_fc1, fc1 alone with y = a + shortcut parked in out, and optionally LN_sg over
//     the second half of each hidden row: the first launch of the SGFN tail (B6; its second,
//     the gate and fc2, is csrc/sgfn.cu);
//   * rows_linear: out = a @ w + b on rows of any output width: the output projection of
//     the overlapping cross-attention (B9), after csrc/oca.cu's attention, and the qkv and
//     output projections of the standalone window attention (B14) around csrc/wattn.cu's.
//
// Replaces the TPU kernels freqfusion_tpu/ops/pallas/wattn.py:fused_hab_block (with
// hab_attention.cu), :fused_residual_ln_mlp, the projection inside
// :fused_overlap_attention and the fc1 half of freqfusion_tpu/ops/pallas/sgfn.py:
// fused_sgfn_tail. The plain PyTorch versions sit beside the wrappers in
// freqfusion_tpu_torch/ops/kernels/wattn.py and sgfn.py.
//
// What bounds it on the H100. B10: per pixel 4*C*hid FLOPs of products (259 k at C = 180,
// hid = 360) for 12*C bytes of a, shortcut and out plus the hidden's round trip (2.9 KB):
// about 90 FLOP per byte, above the 3xTF32 tensor-core ridge (49): the products bound it at
// 0.28 ms at [1,352,512,180] on the tensor cores' 165 TFLOP/s of f32-exact products (0.70
// ms on the CUDA cores' 67), the bytes at 0.16 ms. B6's fc1 (C -> 720) alone is 47 GFLOP
// at the same shape: 0.28 ms.
//
// Design. The TPU kernel keeps a window's rows, y and the hidden in VMEM through all three
// products. Here each product has its own launch of one kernel: a block of 16 warps owns
// 128 pixels, stages their rows (184 wide at C = 180) in shared memory in the A-fragment order
// of tile_mma (mma_f32x3.cuh; 94 KB) and runs tile_mma: 3xTF32 MMAs on weights split into
// hi and lo on the host, streamed in 64-row chunks through a 2-stage cp.async ring (128 KB):
// one block of 16 warps an SM. What the TPU kernel keeps in VMEM between the products goes
// through device memory instead: y is parked in the output buffer (written by proj or by
// fc1's staging, read and overwritten by fc2's epilogue, each element by the thread that
// wrote it), the hidden in a scratch buffer [pixels][K2p]. Every product takes K in pieces
// of at most 192 rows (tile_mma_piece: 184 + 176 at 360), each piece's epilogue adding to
// the last's; at C <= 192, proj and fc1 are one piece (see Mode below).
// LN2 (and LN_sg) is one warp per row. With in_shift the shortcut x is read at
// (y + s, x + s), wrapping, like the attention read it; conv_x and out are in rolled
// coordinates. Widths are padded to multiples of 8, the MMA's k and n (180 -> 184; 360 and
// 720 stay): the wrapper zero-pads the weights, the kernel zero-fills its tile's padding.
//
// Layout: NHWC, contiguous; C % 4 == 0. cab_scale [B][C] or null. Storage: a, x, conv_x and
// out are f32, or bf16 (T). P = 1 (bf16, and precision "default" on f32 storage): bf16
// products, every A operand rounded to bf16 where its fragment is set. y, which the TPU
// kernel keeps in f32, is parked in f32 (out itself for f32 storage, an f32 scratch for
// bf16), and the hidden is f32 (its only reader is the next product, which rounds it to
// bf16 at P = 1 as the TPU kernel's cast does). hab_tail at C > 192 at bf16 sums the
// projection's K pieces in that f32 scratch and adds the residuals there: y is rounded
// nowhere before fc2's store.

#include "mma_f32x3.cuh"

namespace {

constexpr int kP = kMmaRows;   // pixels per block
constexpr int kWarps = kMmaThreads / 32;
constexpr float kEps = 1e-5f;
enum Mode { kLinear = 0, kProj = 1, kFc1 = 2, kFc2 = 3 };
// Every product takes K in pieces of at most kMmaMaxK = 192 rows (tile_mma_piece), each
// piece's epilogue adding to the last's. At C <= 192 proj and fc1 are one piece, and do what
// they did before pieces: fc1 holds a row in registers for its LN, proj adds the residuals
// in its epilogue. Above 192, fc1 (SPLIT) takes each row's mean and 1/std in a first pass
// over device memory (y = a + shortcut parked in out on the way) and normalises each piece
// as it stages it, and the hidden's partial sums over the pieces are added in f32 before
// bias and GELU; the projection is the linear mode, whose pieces sum in out, and
// residual_kernel adds the residuals after it (a split proj epilogue spilled).
__host__ __device__ constexpr bool pieces(int mode) { return mode == kFc2 || mode == kLinear; }
// T: the storage type of x, conv_x and out; TA: that of `a` (T, or f32 where `a` is y or the
// hidden).
template <typename T, typename TA>
struct RowArgs {
    const TA* a;         // att (kLinear, kProj), a or y (kFc1), the hidden (kFc2)
    const T* x;          // the block's input x (kProj); shortcut or null (kFc1)
    const T* cx;         // conv_x (kProj)
    const float* cabs;   // cab_scale [B][C] or null (kProj)
    const float4* w;     // the product's weights, mma_planes of [Kp][Np]
    const float* bias;   // its bias
    const float *lnw, *lnb;   // LayerNorm affine (kFc1)
    const float *sgw, *sgb;   // LN_sg affine over the hidden's second half, or null (kFc1)
    T* out;              // out
    float* y;            // y after kProj, or after kFc1 with a shortcut; the pieces' sums
                         // of kLinear and kFc2 (out itself for f32)
    float* hid;          // the hidden [pixels][Np] (kFc1)
    long long npix;      // B * H * W
    int H, W, C, Kp, Np, nreal, shift;   // nreal: real columns of the product
    float conv_scale;
};

// LayerNorm (eps 1e-5) of a row of n <= 384 floats in device memory, in place, by one warp:
// the row is held in registers, so it costs one round of loads.
__device__ __forceinline__ void ln_row_inplace(float* row, const float* __restrict__ w,
                                               const float* __restrict__ b, int n) {
    const int lane = threadIdx.x & 31;
    float4 v[3];
    float sum = 0.f;
#pragma unroll
    for (int h = 0; h < 3; ++h) {
        const int c = 4 * lane + 128 * h;
        v[h] = c < n ? *reinterpret_cast<const float4*>(row + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        sum += (v[h].x + v[h].y) + (v[h].z + v[h].w);
    }
    const float u = warp_sum(sum) / n;
    float q = 0.f;
#pragma unroll
    for (int h = 0; h < 3; ++h)
        if (4 * lane + 128 * h < n) {
            const float4 d = make_float4(v[h].x - u, v[h].y - u, v[h].z - u, v[h].w - u);
            q = fmaf(d.x, d.x, fmaf(d.y, d.y, fmaf(d.z, d.z, fmaf(d.w, d.w, q))));
        }
    const float inv = 1.f / sqrtf(warp_sum(q) / n + kEps);
#pragma unroll
    for (int h = 0; h < 3; ++h) {
        const int c = 4 * lane + 128 * h;
        if (c < n) {
            const float4 ww = *reinterpret_cast<const float4*>(w + c);
            const float4 bb = *reinterpret_cast<const float4*>(b + c);
            *reinterpret_cast<float4*>(row + c) = make_float4(
                (v[h].x - u) * inv * ww.x + bb.x, (v[h].y - u) * inv * ww.y + bb.y,
                (v[h].z - u) * inv * ww.z + bb.z, (v[h].w - u) * inv * ww.w + bb.w);
        }
    }
}

template <int MODE, bool SPLIT, int P, typename T, typename TA>
__global__ void __launch_bounds__(kMmaThreads, 1)
rows_kernel(const RowArgs<T, TA> g) {
    extern __shared__ float4 smem4[];
    const int C = g.C;
    // SPLIT: fc1 with K in more than one piece (fc2 and linear always take pieces; proj
    // at C > 192 is hab_tail's linear product and residual_kernel)
    const int Kt = SPLIT || pieces(MODE) ? tile_mma_piece(g.Kp) : g.Kp;
    float* A = reinterpret_cast<float*>(smem4);  // [kP x Kt] in A-fragment order
    float* ws = A + kP * Kt;                      // tile_mma's weight ring
    long long* src = reinterpret_cast<long long*>(ws + tile_mma_ws());  // [kP] (proj)
    int* img = reinterpret_cast<int*>(src + kP);                         // [kP] (proj)
    float* lnst = reinterpret_cast<float*>(src);   // [kP][2] mean, 1/std (fc1 in pieces)
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
    if constexpr (MODE == kFc1 && SPLIT) {
        // a first pass over each whole row, a warp a row: y = a + shortcut parked in out,
        // then y's mean and 1/std (tile_mma synchronises before the first piece reads them)
        for (int p = warp; p < kP; p += kWarps) {
            const long long gp = p0 + p;
            float u = 0.f, inv = 0.f;
            if (gp < g.npix) {
                if (g.x) {
                    for (int c = 4 * lane; c < C; c += 128) {
                        const float4 v = ld4(g.a + gp * C + c);
                        const float4 s = ld4(g.x + gp * C + c);
                        *reinterpret_cast<float4*>(g.y + gp * C + c) =
                            make_float4(v.x + s.x, v.y + s.y, v.z + s.z, v.w + s.w);
                    }
                    __syncwarp();
                    warp_ln_stats(g.y + gp * C, C, kEps, u, inv);
                } else {
                    warp_ln_stats(g.a + gp * C, C, kEps, u, inv);
                }
            }
            if (lane == 0) {
                lnst[2 * p] = u;
                lnst[2 * p + 1] = inv;
            }
        }
    }
    for (int k0 = 0; k0 < g.Kp; k0 += Kt) {
        const int kh = min(Kt, g.Kp - k0), ks = kh / 8;
        // A's rows, written once every thread is past the previous piece's reads of A
        auto stage_a = [&] {
            if constexpr (MODE == kFc1 && SPLIT) {
                // LN(y) of the piece's columns from the first pass's mean and 1/std
                const int k4 = kh / 4;
#pragma unroll 4
                for (int e = tid; e < kP * k4; e += kMmaThreads) {
                    const int p = e / k4, c = (e % k4) * 4, ch = k0 + c;
                    const long long gp = p0 + p;
                    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
                    if (gp < g.npix && ch < C) {
                        const float4 v = g.x ? ld4(g.y + gp * C + ch) : ld4(g.a + gp * C + ch);
                        const float4 w = *reinterpret_cast<const float4*>(g.lnw + ch);
                        const float4 b = *reinterpret_cast<const float4*>(g.lnb + ch);
                        const float u = lnst[2 * p], inv = lnst[2 * p + 1];
                        o = make_float4((v.x - u) * inv * w.x + b.x, (v.y - u) * inv * w.y + b.y,
                                        (v.z - u) * inv * w.z + b.z, (v.w - u) * inv * w.w + b.w);
                    }
                    put4(A, p, c, ks, o);
                }
            } else if constexpr (MODE == kFc1) {
                // LN(y), a warp a row, the row in registers (C <= 192: two float4 a lane), so
                // that a row costs one round of loads; y = a + shortcut is parked in out
#pragma unroll 2
                for (int p = warp; p < kP; p += kWarps) {
                    const long long gp = p0 + p;
                    float4 v[2];
                    float sum = 0.f;
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int c = 4 * lane + 128 * h;
                        v[h] = make_float4(0.f, 0.f, 0.f, 0.f);
                        if (gp < g.npix && c < C) {
                            v[h] = ld4(g.a + gp * C + c);
                            if (g.x) {
                                const float4 u = ld4(g.x + gp * C + c);
                                v[h] = make_float4(v[h].x + u.x, v[h].y + u.y, v[h].z + u.z,
                                                   v[h].w + u.w);
                                *reinterpret_cast<float4*>(g.y + gp * C + c) = v[h];
                            }
                        }
                        sum += (v[h].x + v[h].y) + (v[h].z + v[h].w);
                    }
                    const float u = warp_sum(sum) / C;
                    float q = 0.f;
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        if (4 * lane + 128 * h < C) {
                            const float4 d = make_float4(v[h].x - u, v[h].y - u, v[h].z - u,
                                                         v[h].w - u);
                            q = fmaf(d.x, d.x, fmaf(d.y, d.y, fmaf(d.z, d.z, fmaf(d.w, d.w, q))));
                        }
                    const float inv = 1.f / sqrtf(warp_sum(q) / C + kEps);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int c = 4 * lane + 128 * h;
                        if (c >= kh) continue;
                        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
                        if (gp < g.npix && c < C) {
                            const float4 w = *reinterpret_cast<const float4*>(g.lnw + c);
                            const float4 b = *reinterpret_cast<const float4*>(g.lnb + c);
                            o = make_float4((v[h].x - u) * inv * w.x + b.x,
                                            (v[h].y - u) * inv * w.y + b.y,
                                            (v[h].z - u) * inv * w.z + b.z,
                                            (v[h].w - u) * inv * w.w + b.w);
                        }
                        put4(A, p, c, ks, o);
                    }
                }
            } else {   // the tile's rows, zero in the padded columns and past the last pixel
                const int k4 = kh / 4;
                const int width = MODE == kFc2 ? g.Kp : C;   // floats of a row of `a`
#pragma unroll 4
                for (int e = tid; e < kP * k4; e += kMmaThreads) {
                    const int p = e / k4, c = (e % k4) * 4;
                    const long long gp = p0 + p;
                    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                    if (gp < g.npix && k0 + c < width) v = ld4(g.a + gp * width + k0 + c);
                    put4(A, p, c, ks, v);
                }
            }
        };
        const bool first = k0 == 0, last = k0 + kh == g.Kp;   // `last`: fc1 in pieces
        // tile_mma synchronises before it reads A; src and img are written before the call
        tile_mma<P>(
            A, kh, g.w + (size_t)(k0 / 8) * (g.Np / 8) * 32, g.Np / 8, g.Np, ws, stage_a,
            [&](int p, int n, float u0, float u1) {   // columns n, n + 1 (n even)
                const long long gp = p0 + p;
                if (gp >= g.npix) return;
                if (MODE == kFc1) {   // the hidden, zero in its padded columns
                    float2* hp = reinterpret_cast<float2*>(g.hid + gp * g.Np + n);
                    if constexpr (SPLIT) {   // the pieces' sums, in f32, before bias and GELU
                        if (!first) {
                            const float2 s = *hp;
                            u0 += s.x;
                            u1 += s.y;
                        }
                        if (!last) {
                            *hp = make_float2(u0, u1);
                            return;
                        }
                    }
                    *hp = make_float2(n < g.nreal ? gelu_erf(u0 + g.bias[n]) : 0.f,
                                      n + 1 < g.nreal ? gelu_erf(u1 + g.bias[n + 1]) : 0.f);
                    return;
                }
                // floats of a row of out, even: n < wout holds n + 1 < wout too
                const int wout = MODE == kLinear ? g.nreal : C;
                if (n >= wout) return;
                const long long o = gp * wout + n;
                const float2 b = *reinterpret_cast<const float2*>(g.bias + n);
                // the sum so far is kept in y (f32; out itself for f32) until the last piece
                auto put = [&](float2 v) {
                    if (last) st2(g.out + o, v);
                    else *reinterpret_cast<float2*>(g.y + o) = v;
                };
                if (MODE == kLinear) {
                    const float2 y = first ? b : ld2(g.y + o);
                    put(make_float2(y.x + u0, y.y + u1));
                } else if (MODE == kProj) {
                    // element by element, src and img found again from the kernel's
                    // arguments: fewer registers live through tile_mma's loop
                    const long long* sp = reinterpret_cast<const long long*>(
                        reinterpret_cast<const float*>(smem4) + kP * g.Kp + tile_mma_ws());
                    const int* ip = reinterpret_cast<const int*>(sp + kP);
                    const T* xs = g.x + sp[p] * C + n;
                    const T* cx = g.cx + gp * C + n;
                    const float* cb = g.cabs ? g.cabs + ip[p] * C + n : nullptr;
                    float* oe = g.y + gp * C + n;   // y, f32
                    oe[0] = ld1(xs) + u0 + b.x +
                            (cb ? g.conv_scale * cb[0] : g.conv_scale) * ld1(cx);
                    oe[1] = ld1(xs + 1) + u1 + b.y +
                            (cb ? g.conv_scale * cb[1] : g.conv_scale) * ld1(cx + 1);
                } else {   // kFc2: y holds y, then y + the earlier pieces' sums
                    const float2 y = ld2(g.y + o);
                    put(first ? make_float2(y.x + (u0 + b.x), y.y + (u1 + b.y))
                              : make_float2(y.x + u0, y.y + u1));
                }
            });
    }
    if (MODE == kFc1 && g.sgw) {   // LN_sg over the second half of each hidden row, in place
        __syncthreads();   // the block's hidden rows are in device memory
        const int half = g.nreal / 2;
#pragma unroll 2
        for (int p = warp; p < kP; p += kWarps) {
            if (p0 + p >= g.npix) continue;
            float* row = g.hid + (p0 + p) * g.Np + half;
            if (half <= 384) {
                ln_row_inplace(row, g.sgw, g.sgb, half);
            } else {   // wider than a warp's registers: statistics first, then in place
                float u, inv;
                warp_ln_stats(row, half, kEps, u, inv);
                for (int c = 4 * lane; c < half; c += 128) {
                    const float4 v = *reinterpret_cast<const float4*>(row + c);
                    const float4 w = *reinterpret_cast<const float4*>(g.sgw + c);
                    const float4 b = *reinterpret_cast<const float4*>(g.sgb + c);
                    *reinterpret_cast<float4*>(row + c) = make_float4(
                        (v.x - u) * inv * w.x + b.x, (v.y - u) * inv * w.y + b.y,
                        (v.z - u) * inv * w.z + b.z, (v.w - u) * inv * w.w + b.w);
                }
            }
        }
    }
}

// y += x[(y + s) % H][(x + s) % W] + conv_scale * cab_scale * conv_x, pixel by pixel, in f32:
// the projection's residuals where C > kMmaMaxK (the linear mode wrote y = att @ wproj +
// bproj; y is out itself for f32 storage)
template <typename T>
__global__ void residual_kernel(const RowArgs<T, T> g) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;   // a float2
    const int c2 = g.C / 2;
    if (e >= g.npix * c2) return;
    const long long gp = e / c2, hw = (long long)g.H * g.W;
    const int n = 2 * (int)(e - gp * c2);
    const int bi = (int)(gp / hw), rem = (int)(gp - bi * hw);
    int y = rem / g.W + g.shift, xx = rem % g.W + g.shift;
    if (y >= g.H) y -= g.H;
    if (xx >= g.W) xx -= g.W;
    float2* o = reinterpret_cast<float2*>(g.y + gp * g.C + n);
    const float2 u = *o;
    const float2 xs = ld2(g.x + (bi * hw + (long long)y * g.W + xx) * g.C + n);
    const float2 cx = ld2(g.cx + gp * g.C + n);
    float2 s = make_float2(g.conv_scale, g.conv_scale);
    if (g.cabs) {
        const float2 cb = *reinterpret_cast<const float2*>(g.cabs + (size_t)bi * g.C + n);
        s = make_float2(g.conv_scale * cb.x, g.conv_scale * cb.y);
    }
    *o = make_float2(xs.x + u.x + s.x * cx.x, xs.y + u.y + s.y * cx.y);
}

template <int MODE, bool SPLIT, int P, typename T, typename TA>
cudaError_t launch_split(const RowArgs<T, TA>& g, int Kt, cudaStream_t st) {
    const size_t smem = (size_t)(kP * Kt + tile_mma_ws() + 3 * kP) * sizeof(float);
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    const auto kernel = rows_kernel<MODE, SPLIT, P, T, TA>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long nblocks = (g.npix + kP - 1) / kP;
    if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    kernel<<<(unsigned)nblocks, kMmaThreads, smem, st>>>(g);
    return cudaGetLastError();
}

template <int MODE, int P, typename T, typename TA>
cudaError_t launch(const RowArgs<T, TA>& g, cudaStream_t st) {
    if (g.C % 4 || g.Kp % 8 || g.Np % 8 || g.npix < 1) return cudaErrorInvalidValue;
    const int Kt = tile_mma_piece(g.Kp);
    if constexpr (MODE == kFc1) {
        if (Kt != g.Kp) return launch_split<kFc1, true, P>(g, Kt, st);
    }
    if (MODE == kProj && Kt != g.Kp) return cudaErrorInvalidValue;   // hab_tail splits it
    return launch_split<MODE, false, P>(g, Kt, st);
}

// y: where y = a + shortcut goes (f32; out itself for f32 storage).
template <int P, typename T, typename TA>
cudaError_t fc1(const TA* a, const T* shortcut, const float* lnw, const float* lnb,
                const float* w1, const float* b1, const float* sgw, const float* sgb,
                float* hid, T* out, float* y, long long npix, int C, int nhid, int Kp, int K2p,
                cudaStream_t st) {
    if (Kp < C || K2p < nhid) return cudaErrorInvalidValue;
    RowArgs<T, TA> g = {};
    g.a = a; g.x = shortcut; g.lnw = lnw; g.lnb = lnb; g.sgw = sgw; g.sgb = sgb;
    g.w = reinterpret_cast<const float4*>(w1); g.bias = b1;
    g.out = out; g.y = y; g.hid = hid; g.npix = npix; g.C = C; g.Kp = Kp; g.Np = K2p;
    g.nreal = nhid;
    return launch<kFc1, P>(g, st);
}

// fc1 and fc2 on y: from `a` (+ `shortcut`, then y is written to y) or from y in `a` (TA =
// f32). out = y + fc2.
template <int P, typename T, typename TA>
cudaError_t mlp(const TA* a, const T* shortcut, const float* lnw, const float* lnb,
                const float* w1, const float* b1, const float* w2, const float* b2, float* hid,
                T* out, float* y, long long npix, int C, int nhid, int Kp, int Np, int K2p,
                cudaStream_t st) {
    if (Np < C) return cudaErrorInvalidValue;
    cudaError_t err = fc1<P>(a, shortcut, lnw, lnb, w1, b1, nullptr, nullptr, hid, out, y, npix,
                          C, nhid, Kp, K2p, st);
    if (err != cudaSuccess) return err;
    RowArgs<T, float> f = {};
    f.a = hid; f.w = reinterpret_cast<const float4*>(w2); f.bias = b2; f.out = out;
    f.y = shortcut ? y : const_cast<float*>(reinterpret_cast<const float*>(a));
    f.npix = npix; f.C = C; f.Kp = K2p; f.Np = Np; f.nreal = C;
    return launch<kFc2, P>(f, st);
}

template <int P, typename T>
cudaError_t linear(const T* a, const float* wp, const float* bp, T* out, float* y,
                   long long npix, int C, int Cout, int Kp, int Np, cudaStream_t st) {
    RowArgs<T, T> g = {};
    g.a = a; g.w = reinterpret_cast<const float4*>(wp); g.bias = bp; g.out = out; g.y = y;
    g.npix = npix; g.C = C; g.Kp = Kp; g.Np = Np; g.nreal = Cout;
    return launch<kLinear, P>(g, st);
}

// y: f32 [npix][C], out itself for f32 storage.
template <int P, typename T>
cudaError_t tail(const T* att, const T* x, const T* cx, const float* cabs, const float* wp,
                 const float* bp, const float* lnw, const float* lnb, const float* w1,
                 const float* b1, const float* w2, const float* b2, float* hid, T* out,
                 float* y, int B, int H, int W, int C, int nhid, int Kp, int Np, int K2p,
                 int shift, float conv_scale, cudaStream_t st) {
    RowArgs<T, T> g = {};
    g.a = att; g.x = x; g.cx = cx; g.cabs = cabs; g.w = reinterpret_cast<const float4*>(wp);
    g.bias = bp; g.out = out; g.y = y;
    g.npix = (long long)B * H * W; g.H = H; g.W = W; g.C = C; g.Kp = Kp; g.Np = Np;
    g.nreal = C; g.shift = shift; g.conv_scale = conv_scale;
    cudaError_t err;
    if (tile_mma_piece(Kp) == Kp) {
        err = launch<kProj, P>(g, st);
    } else {   // K in pieces: the linear product into y, its pieces summed there in f32,
               // then the residuals added to y
        RowArgs<float, T> l = {};
        l.a = att; l.w = g.w; l.bias = bp; l.out = y; l.y = y;
        l.npix = g.npix; l.C = C; l.Kp = Kp; l.Np = Np; l.nreal = C;
        err = launch<kLinear, P>(l, st);
        if (err != cudaSuccess) return err;
        const long long n2 = g.npix * (C / 2);
        if ((n2 + 255) / 256 > 0x7fffffffLL) return cudaErrorInvalidValue;
        residual_kernel<T><<<(unsigned)((n2 + 255) / 256), 256, 0, st>>>(g);
        err = cudaGetLastError();
    }
    if (err != cudaSuccess) return err;
    return mlp<P>(static_cast<const float*>(y), static_cast<const T*>(nullptr), lnw, lnb, w1, b1,
               w2, b2, hid, out, y, g.npix, C, nhid, Kp, Np, K2p, st);
}

}  // namespace

// Storage: a, shortcut, x, cx and out in the storage type of `mode` (common.cuh: IoMode). y
// is f32 scratch [npix][C] (or [npix][Cout] for rows_linear) for bf16, where y is parked (and
// where rows_linear's and hab_tail's pieces sum when Kp > 192); for f32 storage it may be
// null, and out holds y.

// out [npix][Cout] = a [npix][C] @ w + bp, Cout even; wp = mma_planes of w [Kp][Np].
extern "C" int rows_linear(const float* a, const float* wp, const float* bp, float* out,
                           float* y, long long npix, int C, int Cout, int Kp, int Np,
                           int mode, void* stream) {
    if (Kp < C || Np < Cout || Cout < 2 || Cout % 2) return cudaErrorInvalidValue;
    if (mode == 1 && !y && tile_mma_piece(Kp) != Kp) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return by_mode(mode, [&](auto m) {
        using T = typename decltype(m)::T;
        return linear<decltype(m)::P>(as<T>(a), wp, bp, as<T>(out), kBf16<T> ? y : out, npix, C,
                                      Cout, Kp, Np, st);
    });
}

// y = a + shortcut into y (out for f32), hid [npix][K2p] = GELU(LN(y) @ w1 + b1), w1 =
// mma_planes of [Kp][K2p]; with sgw, LN_sg (sgw, sgb) over columns nhid/2 .. nhid - 1 of each
// hidden row.
extern "C" int rows_ln_fc1(const float* a, const float* shortcut, const float* lnw,
                           const float* lnb, const float* w1, const float* b1,
                           const float* sgw, const float* sgb, float* hid, float* out,
                           float* y, long long npix, int C, int nhid, int Kp, int K2p,
                           int mode, void* stream) {
    if (sgw && (nhid % 2 || nhid / 2 % 4)) return cudaErrorInvalidValue;
    if (mode == 1 && shortcut && !y) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return by_mode(mode, [&](auto m) {
        using T = typename decltype(m)::T;
        return fc1<decltype(m)::P>(as<T>(a), as<T>(shortcut), lnw, lnb, w1, b1, sgw, sgb, hid,
                                   as<T>(out), kBf16<T> ? y : out, npix, C, nhid, Kp, K2p, st);
    });
}

extern "C" int hab_tail(const float* att, const float* x, const float* cx, const float* cabs,
                        const float* wp, const float* bp, const float* lnw, const float* lnb,
                        const float* w1, const float* b1, const float* w2, const float* b2,
                        float* hid, float* out, float* y, int B, int H, int W, int C, int nhid,
                        int Kp, int Np, int K2p, int shift, float conv_scale, int mode,
                        void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (shift < 0 || shift >= H || shift >= W || Kp < C || Np < C || (mode == 1 && !y))
        return cudaErrorInvalidValue;
    return by_mode(mode, [&](auto m) {
        using T = typename decltype(m)::T;
        return tail<decltype(m)::P>(as<T>(att), as<T>(x), as<T>(cx), cabs, wp, bp, lnw, lnb, w1,
                                    b1, w2, b2, hid, as<T>(out), kBf16<T> ? y : out, B, H, W, C,
                                    nhid, Kp, Np, K2p, shift, conv_scale, st);
    });
}

extern "C" int residual_ln_mlp(const float* a, const float* shortcut, const float* lnw,
                               const float* lnb, const float* w1, const float* b1,
                               const float* w2, const float* b2, float* hid, float* out,
                               float* y, long long npix, int C, int nhid, int Kp, int Np, int K2p,
                               int mode, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (mode == 1 && (!y || !shortcut)) return cudaErrorInvalidValue;
    return by_mode(mode, [&](auto m) {
        using T = typename decltype(m)::T;
        return mlp<decltype(m)::P>(as<T>(a), as<T>(shortcut), lnw, lnb, w1, b1, w2, b2, hid,
                                   as<T>(out), kBf16<T> ? y : out, npix, C, nhid, Kp, Np, K2p,
                                   st);
    });
}
