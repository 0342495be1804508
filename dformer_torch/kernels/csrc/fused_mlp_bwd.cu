// Fused DFormer MLP block, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel dformer_tpu/kernels/fused_mlp.py::_bwd_kernel
// (pl.pallas_call in _backward_pallas). From x, the parameters and the
// cotangent g of the block's output it computes the full VJP of
//
//   y   = LayerNorm(x)                      fp32 statistics, eps
//   h1  = y @ fc1_w + fc1_b
//   hc  = dwconv3x3(h1, pos_w) + pos_b + h1   zero padding outside the image
//   out = gelu(hc) @ fc2_w + fc2_b
//
// that is dx and the gradients of the eight parameters. Nothing but x was
// saved by the forward: LayerNorm, fc1, the depthwise conv and the GELU are
// recomputed here, and no hidden-sized tensor reaches device memory.
//
// Rounding points follow _bwd_kernel: y, gelu(hc) and dh1 are rounded to the
// I/O type where they enter a product; h1, dg and dhc stay fp32; every sum is
// fp32; the GELU and its derivative use erff / expf.
//
// What bounds it on this card. Five products of 2*N*C*Ch operations each
// against x, g in and dx out: at DFormer-L stage 0 (bs8, 120x160, C 96 ->
// Ch 768) 113 GFLOP against 88 MB, so the work is bound by operations. This
// first version is written to be short and checkable, not fast: all five
// products are scalar FMAs in both dtypes (bf16 converts at the loads). Tensor
// cores, cp.async staging and a hidden-channel split for small maps are later
// work.
//
// Design. Every gradient is additive over hidden channels, and the hidden
// pipeline acts per hidden channel between the two products, so a block owns
// a tile of TH x 8 pixels of one image and loops over 32-channel hidden
// chunks (one hidden channel per lane):
//   0. LayerNorm every pixel of the tile plus a 2-px halo once into shared
//      memory (rounded to the I/O type; zeros outside the image), keeping
//      mean and rstd of the tile's own pixels; copy g for the tile plus a
//      1-px halo into shared memory, ZERO outside the image.
//   per chunk:
//   1. h1 = fc1 over the 2-halo tile, fp32 in shared memory, ZERO outside
//      the image (fc1(LN(0)) is not 0, and the conv pads h1 with zeros);
//   2. dg = g @ fc2_w^T over the 1-halo tile; g is zero outside the image,
//      so dhc is exactly 0 there;
//   3. on the 1-halo tile hc = dwconv(h1) + pos_b + h1 and
//      dhc = dg * gelu'(hc); on the tile's own pixels gact = gelu(hc);
//   4. on the tile's own pixels: dpos_w, dpos_b from dhc and the shifted h1;
//      dh1 = dhc + conv-transpose(dhc); dfc1_b; then the three products
//      dfc2_w[chunk] = gact^T g, dfc1_w[chunk] = dh1^T y and
//      dy += dh1 @ fc1_w[chunk]^T, dy in fp32 registers across chunks.
//   After the chunks: dln_w, dln_b, dfc2_b and the LayerNorm backward
//      dx = rstd * (dyn - mean(dyn) - y0 * mean(dyn * y0)), dyn = dy * ln_w,
//   one warp per pixel, written once. dx needs no sum across blocks and is
//   bit-for-bit reproducible.
// Weight gradients across blocks: each block sums over its own pixels first,
// then adds its partial sums to zero-initialised fp32 accumulators in device
// memory with atomicAdd (the caller zeroes them on the same stream and casts
// them afterwards). The order of those additions varies from run to run, so
// the eight weight gradients are reproducible to summation order only.
//
// Weights come in torch Linear layout: fc1_w [Ch, C] (and its transpose
// fc1_wt [C, Ch], so that both the recompute and dy read along lanes),
// fc2_w [C, Ch], pos_w [3, 3, Ch]. The accumulators of fc1_w and fc2_w are
// both [Ch, C], so a chunk's 32 rows are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCK = 32;        // hidden channels per chunk, one per lane
constexpr int kTW = 8;         // tile width = warps; the tile height is TH
constexpr int kMaxC = 576;     // DFormer-L stage 4
constexpr int kLDH = kCK + 1;  // row stride of the fp32 per-channel tiles
constexpr int kLDA = kCK + 4;  // row stride of gact / dh1c (float4 rows)
constexpr int kNK = 11;        // per-hidden-channel sums: 9 dpos_w, dpos_b,
                               // dfc1_b

template <int TH>
struct Tile {
  static constexpr int NO = TH * kTW;                  // own pixels
  static constexpr int W1 = kTW + 2, N1 = (TH + 2) * W1;  // 1-px halo
  static constexpr int W2 = kTW + 4, N2 = (TH + 4) * W2;  // 2-px halo
  static constexpr int P1 = (N1 + kWarps - 1) / kWarps;   // px per warp
  static constexpr int P2 = (N2 + kWarps - 1) / kWarps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a cast does
}
// v rounded to T, as fp32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// 16 bytes of T as floats
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> fp32 is a 16-bit shift
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// acc[i] = sum_c a[p][c] * wt[c * Ch] for the pixels p = warp + 8 i < np of
// a shared-memory tile a [np][C]; wt points at this lane's column of a
// [C, Ch] weight, so a warp reads 32 neighbouring hidden channels.
template <typename T, int PP>
__device__ __forceinline__ void tile_matmul(const T* a, int np, int C,
                                            const T* wt, int Ch,
                                            float (&acc)[PP]) {
  constexpr int V = Vec<T>::N;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < PP; ++i) acc[i] = 0.f;
  for (int c0 = 0; c0 < C; c0 += V) {
    float w[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      w[v] = to_f(wt[static_cast<size_t>(c0 + v) * Ch]);
#pragma unroll
    for (int i = 0; i < PP; ++i) {
      const int p = warp + i * kWarps;
      if (p < np) {
        float av[V];
        Vec<T>::load(a + static_cast<size_t>(p) * C + c0, av);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[i] = fmaf(av[v], w[v], acc[i]);
      }
    }
  }
}

// dst[k][c] += sum over the tile's own pixels q of a[q][k] * b[px(q)][c],
// for the chunk's 32 rows k of a [., C] accumulator in device memory. a is
// [NO][kLDA] fp32; b is a halo tile [.][C] whose own pixel q sits at
// ((q / 8 + OFF) * WP + q % 8 + OFF). Warp w owns rows 4w..4w+3, lane the
// columns lane + 32 j, so each atomicAdd of a warp covers 32 neighbouring
// addresses.
template <typename T, int TH, int NC, int WP, int OFF>
__device__ __forceinline__ void outer_accumulate(const float* a, const T* b,
                                                 int C, float* dst) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
#pragma unroll 2
  for (int q = 0; q < TH * kTW; ++q) {
    const float4 av =
        *reinterpret_cast<const float4*>(a + q * kLDA + warp * 4);
    const T* brow =
        b + static_cast<size_t>((q / kTW + OFF) * WP + q % kTW + OFF) * C;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      const float bv = c < C ? to_f(brow[c]) : 0.f;
      acc[0][j] = fmaf(av.x, bv, acc[0][j]);
      acc[1][j] = fmaf(av.y, bv, acc[1][j]);
      acc[2][j] = fmaf(av.z, bv, acc[2][j]);
      acc[3][j] = fmaf(av.w, bv, acc[3][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < C)
        atomicAdd(dst + static_cast<size_t>(warp * 4 + r) * C + c, acc[r][j]);
    }
}

template <typename T, int TH>
size_t smem_bytes(int C) {
  using S = Tile<TH>;
  return sizeof(T) * static_cast<size_t>(S::N2 + S::N1) * C +
         sizeof(float) * (2 * S::NO * kLDA + (S::N2 + S::N1) * kLDH +
                          kNK * kCK + 3 * C + 2 * S::NO);
}

// NC: columns lane + 32 j, j < NC, cover C.
template <typename T, int TH, int NC>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b,
                     const T* __restrict__ fc1_w,   // [Ch, C]
                     const T* __restrict__ fc1_wt,  // [C, Ch]
                     const float* __restrict__ fc1_b,
                     const T* __restrict__ pos_w,   // [9, Ch]
                     const float* __restrict__ pos_b,
                     const T* __restrict__ fc2_w,   // [C, Ch]
                     T* __restrict__ dx, float* __restrict__ dln_w,
                     float* __restrict__ dln_b,
                     float* __restrict__ dfc1_w,    // [Ch, C]
                     float* __restrict__ dfc1_b,
                     float* __restrict__ dpos_w,    // [9, Ch]
                     float* __restrict__ dpos_b,
                     float* __restrict__ dfc2_w,    // [Ch, C]
                     float* __restrict__ dfc2_b, int H, int W, int C, int Ch,
                     float eps) {
  using S = Tile<TH>;
  constexpr int NO = S::NO, N1 = S::N1, N2 = S::N2, W1 = S::W1, W2 = S::W2;
  constexpr int V = Vec<T>::N;
  extern __shared__ float4 smem_raw[];
  T* ys = reinterpret_cast<T*>(smem_raw);              // [N2][C]  LN(x)
  T* gs = ys + static_cast<size_t>(N2) * C;            // [N1][C]  g
  float* gact = reinterpret_cast<float*>(gs + static_cast<size_t>(N1) * C);
  float* dh1c = gact + NO * kLDA;                      // [NO][kLDA] each
  float* h1s = dh1c + NO * kLDA;                       // [N2][kLDH]
  float* dhc = h1s + N2 * kLDH;                        // [N1][kLDH]
  float* redk = dhc + N1 * kLDH;                       // [kNK][32]
  float* redc = redk + kNK * kCK;                      // [3][C]
  float* stat = redc + 3 * C;                          // mean, rstd: [2][NO]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * TH, col0 = blockIdx.x * kTW;
  const size_t img = static_cast<size_t>(b) * H * W;

  // 0a. LayerNorm of the 2-halo tile, one warp per pixel
  for (int p = warp; p < N2; p += kWarps) {
    const int pr = p / W2, pc = p % W2;
    const int r = row0 - 2 + pr, c = col0 - 2 + pc;
    T* yrow = ys + static_cast<size_t>(p) * C;
    if (r < 0 || r >= H || c < 0 || c >= W) {
      for (int i = lane; i < C; i += 32) yrow[i] = from_f<T>(0.f);
      continue;
    }
    const T* xrow = x + (img + static_cast<size_t>(r) * W + c) * C;
    float s = 0.f;
    for (int i = lane; i < C; i += 32) s += to_f(xrow[i]);
    const float mean = warp_sum(s) / C;
    float v = 0.f;
    for (int i = lane; i < C; i += 32) {
      const float d = to_f(xrow[i]) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + eps);
    for (int i = lane; i < C; i += 32)
      yrow[i] = from_f<T>((to_f(xrow[i]) - mean) * rstd * ln_w[i] + ln_b[i]);
    if (lane == 0 && pr >= 2 && pr < TH + 2 && pc >= 2 && pc < kTW + 2) {
      const int q = (pr - 2) * kTW + pc - 2;
      stat[q] = mean;
      stat[NO + q] = rstd;
    }
  }
  // 0b. g over the 1-halo tile, zero outside the image
  {
    const int per_row = C / V;
    for (int i = tid; i < N1 * per_row; i += kThreads) {
      const int p = i / per_row, v = (i % per_row) * V;
      const int r = row0 - 1 + p / W1, c = col0 - 1 + p % W1;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r >= 0 && r < H && c >= 0 && c < W)
        val = *reinterpret_cast<const uint4*>(
            g + (img + static_cast<size_t>(r) * W + c) * C + v);
      *reinterpret_cast<uint4*>(gs + static_cast<size_t>(p) * C + v) = val;
    }
  }

  // this thread's share of dy: pixels q = warp + 8 i (row i, column warp of
  // the tile), channels lane + 32 j
  float dy[TH][NC];
#pragma unroll
  for (int i = 0; i < TH; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dy[i][j] = 0.f;

  for (int ch0 = 0; ch0 < Ch; ch0 += kCK) {
    const int k = ch0 + lane;
    __syncthreads();  // ys, gs written; the last chunk's readers are done

    // 1. h1 over the 2-halo tile, zero outside the image
    {
      float h[S::P2];
      tile_matmul<T, S::P2>(ys, N2, C, fc1_wt + k, Ch, h);
      const float fb = fc1_b[k];
#pragma unroll
      for (int i = 0; i < S::P2; ++i) {
        const int p = warp + i * kWarps;
        if (p < N2) {
          const int r = row0 - 2 + p / W2, c = col0 - 2 + p % W2;
          h1s[p * kLDH + lane] =
              (r >= 0 && r < H && c >= 0 && c < W) ? h[i] + fb : 0.f;
        }
      }
    }
    // 2. dg over the 1-halo tile (0 outside the image, where g is 0)
    {
      float d[S::P1];
      tile_matmul<T, S::P1>(gs, N1, C, fc2_w + k, Ch, d);
#pragma unroll
      for (int i = 0; i < S::P1; ++i) {
        const int p = warp + i * kWarps;
        if (p < N1) dhc[p * kLDH + lane] = d[i];
      }
    }
    for (int i = tid; i < kNK * kCK; i += kThreads) redk[i] = 0.f;
    __syncthreads();

    // 3. hc, gelu and gelu' on the 1-halo tile
    float pw[9];
#pragma unroll
    for (int i = 0; i < 9; ++i)
      pw[i] = to_f(pos_w[static_cast<size_t>(i) * Ch + k]);
    const float pb = pos_b[k];
#pragma unroll
    for (int i = 0; i < S::P1; ++i) {
      const int p = warp + i * kWarps;
      if (p >= N1) continue;
      const int pr = p / W1, pc = p % W1;  // (pr, pc) + 1 in 2-halo coords
      float hc = pb + h1s[((pr + 1) * W2 + pc + 1) * kLDH + lane];
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int dc = 0; dc < 3; ++dc)
          hc = fmaf(h1s[((pr + dr) * W2 + pc + dc) * kLDH + lane],
                    pw[dr * 3 + dc], hc);
      const float cdf = 0.5f * (1.f + erff(hc * 0.7071067811865476f));
      const float pdf = expf(-0.5f * hc * hc) * 0.3989422804014327f;
      dhc[p * kLDH + lane] *= cdf + hc * pdf;
      if (pr >= 1 && pr <= TH && pc >= 1 && pc <= kTW)
        gact[((pr - 1) * kTW + pc - 1) * kLDA + lane] = round_to<T>(hc * cdf);
    }
    __syncthreads();

    // 4a. per hidden channel over the tile's own pixels: dpos_w, dpos_b,
    // dh1 (conv-transpose + residual), dfc1_b
    {
      float sw[9], sb = 0.f, s1 = 0.f;
#pragma unroll
      for (int i = 0; i < 9; ++i) sw[i] = 0.f;
#pragma unroll
      for (int i = 0; i < TH; ++i) {
        const int qr = i, qc = warp;
        const float d0 = dhc[((qr + 1) * W1 + qc + 1) * kLDH + lane];
        float dh1 = d0;
#pragma unroll
        for (int kk = 0; kk < 3; ++kk)
#pragma unroll
          for (int ll = 0; ll < 3; ++ll) {
            dh1 = fmaf(dhc[((qr + 2 - kk) * W1 + qc + 2 - ll) * kLDH + lane],
                       pw[kk * 3 + ll], dh1);
            sw[kk * 3 + ll] = fmaf(
                d0, h1s[((qr + 1 + kk) * W2 + qc + 1 + ll) * kLDH + lane],
                sw[kk * 3 + ll]);
          }
        sb += d0;
        // a ragged tile's pixels outside the image take no gradient
        if (row0 + qr >= H || col0 + qc >= W) dh1 = 0.f;
        s1 += dh1;
        dh1c[(qr * kTW + qc) * kLDA + lane] = round_to<T>(dh1);
      }
#pragma unroll
      for (int i = 0; i < 9; ++i) atomicAdd(redk + i * kCK + lane, sw[i]);
      atomicAdd(redk + 9 * kCK + lane, sb);
      atomicAdd(redk + 10 * kCK + lane, s1);
    }
    __syncthreads();
    for (int i = tid; i < kNK * kCK; i += kThreads) {
      const int j = i / kCK, kc = ch0 + i % kCK;
      float* dst = j < 9 ? dpos_w + static_cast<size_t>(j) * Ch + kc
                         : (j == 9 ? dpos_b + kc : dfc1_b + kc);
      atomicAdd(dst, redk[i]);
    }

    // 4b. the chunk's rows of dfc2_w and dfc1_w
    outer_accumulate<T, TH, NC, W1, 1>(
        gact, gs, C, dfc2_w + static_cast<size_t>(ch0) * C);
    outer_accumulate<T, TH, NC, W2, 2>(
        dh1c, ys, C, dfc1_w + static_cast<size_t>(ch0) * C);
    // 4c. dy += dh1c @ fc1_w[chunk]
    for (int kk = 0; kk < kCK; ++kk) {
      const T* wrow = fc1_w + static_cast<size_t>(ch0 + kk) * C;
      float wv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        wv[j] = c < C ? to_f(wrow[c]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TH; ++i) {
        const float dv = dh1c[(i * kTW + warp) * kLDA + kk];
#pragma unroll
        for (int j = 0; j < NC; ++j) dy[i][j] = fmaf(dv, wv[j], dy[i][j]);
      }
    }
  }

  // 5. dln_w, dln_b, dfc2_b and dx, one warp per pixel
  for (int i = tid; i < 3 * C; i += kThreads) redc[i] = 0.f;
  __syncthreads();
  float slw[NC], slb[NC], sgb[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) slw[j] = slb[j] = sgb[j] = 0.f;
#pragma unroll
  for (int i = 0; i < TH; ++i) {
    const int r = row0 + i, c = col0 + warp;
    if (r >= H || c >= W) continue;  // the same for the whole warp
    const int q = i * kTW + warp;
    const float mean = stat[q], rstd = stat[NO + q];
    const size_t pix = (img + static_cast<size_t>(r) * W + c) * C;
    const T* grow = gs + static_cast<size_t>((i + 1) * W1 + warp + 1) * C;
    float y0[NC], dyn[NC], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int ch = lane + 32 * j;
      y0[j] = dyn[j] = 0.f;
      if (ch < C) {
        y0[j] = (to_f(x[pix + ch]) - mean) * rstd;
        slw[j] = fmaf(dy[i][j], y0[j], slw[j]);
        slb[j] += dy[i][j];
        sgb[j] += to_f(grow[ch]);
        dyn[j] = dy[i][j] * ln_w[ch];
        s1 += dyn[j];
        s2 = fmaf(dyn[j], y0[j], s2);
      }
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int ch = lane + 32 * j;
      if (ch < C)
        dx[pix + ch] = from_f<T>(rstd * (dyn[j] - m1 - y0[j] * m2));
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int ch = lane + 32 * j;
    if (ch < C) {
      atomicAdd(redc + ch, slw[j]);
      atomicAdd(redc + C + ch, slb[j]);
      atomicAdd(redc + 2 * C + ch, sgb[j]);
    }
  }
  __syncthreads();
  for (int i = tid; i < 3 * C; i += kThreads) {
    const int j = i / C, ch = i % C;
    atomicAdd((j == 0 ? dln_w : (j == 1 ? dln_b : dfc2_b)) + ch, redc[i]);
  }
}

struct Args {
  const void *x, *g;
  const float *ln_w, *ln_b;
  const void *fc1_w, *fc1_wt;
  const float* fc1_b;
  const void* pos_w;
  const float* pos_b;
  const void* fc2_w;
  void* dx;
  float *dln_w, *dln_b, *dfc1_w, *dfc1_b, *dpos_w, *dpos_b, *dfc2_w, *dfc2_b;
  int B, H, W, C, Ch;
  float eps;
};

template <typename T, int TH, int NC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = fused_mlp_bwd_kernel<T, TH, NC>;
  const size_t smem = smem_bytes<T, TH>(a.C);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.W + kTW - 1) / kTW, (a.H + TH - 1) / TH, a.B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.ln_w, a.ln_b,
      static_cast<const T*>(a.fc1_w), static_cast<const T*>(a.fc1_wt),
      a.fc1_b, static_cast<const T*>(a.pos_w), a.pos_b,
      static_cast<const T*>(a.fc2_w), static_cast<T*>(a.dx), a.dln_w,
      a.dln_b, a.dfc1_w, a.dfc1_b, a.dpos_w, a.dpos_b, a.dfc2_w, a.dfc2_b,
      a.H, a.W, a.C, a.Ch, a.eps);
  return cudaGetLastError();
}

// Tile rows by the bytes of one pixel's channels (the halo tiles of LN(x)
// and g must fit in shared memory: 8 rows up to 576 bytes, 4 up to 1152,
// else 1), then the column count that covers C.
template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.C <= 96) return launch<T, 8, 3>(a, s);
  if (a.C <= 144) return launch<T, 8, 5>(a, s);
  if constexpr (sizeof(T) == 2) {
    if (a.C <= 288) return launch<T, 8, 9>(a, s);
    return launch<T, 4, 18>(a, s);
  } else {
    if (a.C <= 288) return launch<T, 4, 9>(a, s);
    return launch<T, 1, 18>(a, s);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// Device pointers to contiguous tensors: x, g, dx [B,H,W,C], fc1_w [Ch,C],
// fc1_wt [C,Ch], pos_w [3,3,Ch], fc2_w [C,Ch] in the I/O type (bf16 when
// is_bf16, else fp32); ln_w, ln_b [C], fc1_b, pos_b [Ch] in fp32. The eight
// fp32 accumulators must be zero on entry, on the same stream: dln_w, dln_b,
// dfc2_b [C], dfc1_b, dpos_b [Ch], dpos_w [3,3,Ch], dfc1_w and dfc2_w
// [Ch,C]. Requires Ch % 32 == 0, C <= 576, and C % 16 == 0 (bf16) or
// C % 4 == 0 (fp32).
int dformer_fused_mlp_bwd(const void* x, const void* g, const float* ln_w,
                          const float* ln_b, const void* fc1_w,
                          const void* fc1_wt, const float* fc1_b,
                          const void* pos_w, const float* pos_b,
                          const void* fc2_w, void* dx, float* dln_w,
                          float* dln_b, float* dfc1_w, float* dfc1_b,
                          float* dpos_w, float* dpos_b, float* dfc2_w,
                          float* dfc2_b, int B, int H, int W, int C, int Ch,
                          float eps, int is_bf16, void* stream) {
  if (C <= 0 || C > kMaxC || C % (is_bf16 ? 16 : 4) != 0 || Ch <= 0 ||
      Ch % kCK != 0 || B <= 0 || H <= 0 || W <= 0)
    return cudaErrorInvalidValue;
  const Args a{x,     g,      ln_w,   ln_b,   fc1_w,  fc1_wt, fc1_b,
               pos_w, pos_b,  fc2_w,  dx,     dln_w,  dln_b,  dfc1_w,
               dfc1_b, dpos_w, dpos_b, dfc2_w, dfc2_b, B,      H,
               W,     C,      Ch,     eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s);
}

const char* dformer_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
