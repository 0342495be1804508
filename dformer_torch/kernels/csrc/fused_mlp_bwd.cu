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
// that is dx and the gradients of the eight parameters. Only x was saved by
// the forward: LayerNorm, fc1, the depthwise conv and the GELU are
// recomputed here. Rounding points follow _bwd_kernel: y, gelu(hc) and dh1
// are rounded to the I/O type where they enter a product; h1, dg and dhc
// stay fp32; every sum is fp32; the GELU and its derivative use erff/expf.
//
// What bounds it on this card. Five products of 2*N*C*Ch operations each
// (N = B*H*W pixels) against x, g in and dx out: at DFormer-L stage 0 (bs8,
// 120x160, C 96 -> Ch 768) 113 GFLOP against 88 MB, 0.114 ms of bf16
// tensor-core time at 989 TFLOP/s, so the work is bound by operations. The
// design adds a floor of its own: gelu(hc) and dh1, rounded to the I/O
// type, are written once to device memory by K1 and read once by K3, 4 *
// N * Ch * 2 bytes (0.28 ms at stage 0, ~2.4 ms over the 39 calls of a
// DFormer-L train step at 3.35 TB/s). That is the price of computing the
// two weight gradients as one long-K product instead of adding per-block
// partial sums to device memory.
//
// Four launches on the caller's stream; every buffer they write is written
// in full, so nothing is zeroed first:
//   K1 fused_mlp_bwd_hidden: a block owns a TH x 8 pixel tile of one image
//      and a contiguous range of 32-channel hidden chunks (small maps split
//      a tile's chunks over nsplit blocks). It stages x over a 2-px halo and
//      g over a 1-px halo (cp.async), LayerNorms the former in place (and
//      writes y for its own pixels, split 0 only), then per chunk: h1 over
//      the 2-halo (zero outside the image) and dg = g @ fc2^T over the
//      1-halo; hc, gelu and gelu' (one hidden channel per lane); dh1 = dhc +
//      conv-transpose(dhc); gact and dh1c for its own pixels to device
//      memory; its sums of dpos_w, dpos_b and dfc1_b (fp32 dh1) to its own
//      row of hid_part; dy += dh1c @ fc1 in fp32 registers. At the end its
//      dy to dy_part[split].
//   K2 fused_mlp_bwd_ln: one warp per pixel: dy = the splits' partials in
//      split order; the LayerNorm backward dx = rstd * (dyn - mean(dyn) -
//      y0 * mean(dyn * y0)), written once; the block's sums of dln_w, dln_b
//      and dfc2_b = sum g to its row of ln_part.
//   K3 fused_mlp_bwd_wgrad: dfc2_w = gact^T g and dfc1_w = dh1c^T y, the
//      reduction over the N pixels cut into slices (split-K), one fp32
//      partial per slice.
//   K4 fused_mlp_bwd_reduce: every partial buffer summed over its leading
//      index in index order and cast to the output's type.
// In bf16 all five products run on the tensor cores (mma.sync m16n8k16,
// fp32 accumulation; operands staged with cp.async and loaded with
// ldmatrix); the fp32 kernels, for checks at a tight tolerance, keep scalar
// FMAs in the same four launches.
//
// No atomics. Each block writes its partial sums to its own slot; sums
// across warps inside a block and across slots in K4 run in a fixed order.
// So all nine outputs are bit-for-bit reproducible from run to run.
//
// Every product reads its weight operand along rows, so each K1 takes the
// layouts it needs: the tensor-core K1 fc1_w [Ch, C] and fc2_wt [Ch, C],
// the scalar K1 fc1_w, fc1_wt [C, Ch] and fc2_w [C, Ch].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCK = 32;        // hidden channels per chunk, one per lane
constexpr int kTW = 8;         // K1 tile width; the tile height is TH
constexpr int kMaxC = 576;     // DFormer-L stage 4
constexpr int kLDH = kCK + 1;  // row stride of the fp32 per-channel tiles
constexpr int kLDA = kCK + 4;  // row stride of the fp32 dh1c tile
constexpr int kNK = 11;        // per-hidden-channel sums: 9 dpos_w, dpos_b,
                               // dfc1_b
constexpr int kWM = 256;       // K3: output tile, hidden rows
constexpr int kWN = 96;        // K3: output tile, channels
constexpr int kWK = 32;        // K3: pixels per stage
constexpr int kMaxSmem = 232448;

// What the four launches read and write: the caller's tensors, the scratch
// and the plan.
struct Params {
  const void *x, *g;           // [N, C], T
  const float *ln_w, *ln_b;    // [C]
  const void *fc1_w, *fc1_wt;  // [Ch, C] and [C, Ch], T
  const float* fc1_b;          // [Ch]
  const void* pos_w;           // [9, Ch], T
  const float* pos_b;          // [Ch]
  const void *fc2_w, *fc2_wt;  // [C, Ch] and [Ch, C], T
  void* dx;                    // [N, C], T
  float *dln_w, *dln_b, *dfc2_b;  // [C]
  void *dfc1_w, *dfc2_w;          // [Ch, C], T
  float *dfc1_b, *dpos_b;         // [Ch]
  void* dpos_w;                   // [9, Ch], T
  void *y, *gact, *dh1c;          // scratch [N, C], [N, Ch], [N, Ch], T
  float* dy_part;                 // [nsplit][N][C]
  float* hid_part;                // [tiles][kNK][Ch]
  float* ln_part;                 // [ln_blocks][3][C]
  float* w_part;                  // [2][slices][Ch][C]
  int B, H, W, C, Ch;
  float eps;
  int th, cps, nsplit, ln_pixels, slice_len, slices;
  int nbuf;  // K1 buffers of fc1's chunk (tensor-core K1; set at launch)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a cast does
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that does not wait (cp.async), and its
// group commit / wait.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int TH>
struct Tile {
  static constexpr int NO = TH * kTW;                     // own pixels
  static constexpr int W1 = kTW + 2, N1 = (TH + 2) * W1;  // 1-px halo
  static constexpr int W2 = kTW + 4, N2 = (TH + 4) * W2;  // 2-px halo
  static constexpr int P1 = (N1 + kWarps - 1) / kWarps;   // px per warp
  static constexpr int P2 = (N2 + kWarps - 1) / kWarps;
};

// ------------------------------------------------------------------ K1 ---
// fused_mlp_bwd_hidden, per TH x 8 pixel tile and hidden split. Helpers
// shared by both variants first.

// Start copying x over the 2-halo tile into ys and g over the 1-halo tile
// into gs (row stride ld, cp.async, one commit group); rows of pixels
// outside the image are zeroed.
template <typename T, int TH>
__device__ __forceinline__ void stage_halos(const Params& p, T* ys, T* gs,
                                            int ld, int b, int row0,
                                            int col0) {
  using S = Tile<TH>;
  constexpr int V = 16 / sizeof(T);
  const int per_row = p.C / V;
  for (int i = threadIdx.x; i < (S::N2 + S::N1) * per_row; i += kThreads) {
    const bool is_g = i >= S::N2 * per_row;
    const int j = is_g ? i - S::N2 * per_row : i;
    const int q = j / per_row, v = (j % per_row) * V;
    const int wd = is_g ? S::W1 : S::W2, off = is_g ? 1 : 2;
    const int r = row0 - off + q / wd, c = col0 - off + q % wd;
    T* dst = (is_g ? gs : ys) + static_cast<size_t>(q) * ld + v;
    if (r >= 0 && r < p.H && c >= 0 && c < p.W)
      cp_async16(dst, static_cast<const T*>(is_g ? p.g : p.x) +
                          ((static_cast<size_t>(b) * p.H + r) * p.W + c) *
                              p.C +
                          v);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
}

// LayerNorm in place of the 2-halo tile staged in ys, one warp per pixel,
// the pixel's channels in registers (C <= 32 CV), rounded to T; pixels
// outside the image stay zero. With write_y the tile's own pixels also go
// to y. K2 sums in the same order, so its y0 agrees to the bit.
template <typename T, int TH, int CV>
__device__ __forceinline__ void layernorm_in_place(const Params& p, T* ys,
                                                   int ldy, int b, int row0,
                                                   int col0, bool write_y) {
  using S = Tile<TH>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int C = p.C;
  for (int q = warp; q < S::N2; q += kWarps) {
    const int pr = q / S::W2, pc = q % S::W2;
    const int r = row0 - 2 + pr, c = col0 - 2 + pc;
    if (r < 0 || r >= p.H || c < 0 || c >= p.W) continue;
    T* row = ys + static_cast<size_t>(q) * ldy;
    float v[CV];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < CV; ++j)
      if (lane + 32 * j < C) {
        v[j] = to_f(row[lane + 32 * j]);
        s += v[j];
      }
    const float mean = warp_sum(s) / C;
    float var = 0.f;
#pragma unroll
    for (int j = 0; j < CV; ++j)
      if (lane + 32 * j < C) {
        const float d = v[j] - mean;
        var += d * d;
      }
    const float rstd = rsqrtf(warp_sum(var) / C + p.eps);
    T* yout = (write_y && pr >= 2 && pr < TH + 2 && pc >= 2 && pc < kTW + 2)
                  ? static_cast<T*>(p.y) +
                        ((static_cast<size_t>(b) * p.H + r) * p.W + c) * C
                  : nullptr;
#pragma unroll
    for (int j = 0; j < CV; ++j) {
      const int i = lane + 32 * j;
      if (i < C) {
        const T val = from_f<T>((v[j] - mean) * rstd * p.ln_w[i] + p.ln_b[i]);
        row[i] = val;
        if (yout != nullptr) yout[i] = val;
      }
    }
  }
}

// Step 3 for hidden channel k = ch0 + lane: on the 1-halo tile hc =
// dwconv(h1) + pos_b + h1, dhc = dg * gelu'(hc) in place; gelu(hc) of the
// own pixels in the image to gact. h1s [N2][kLDH], dhc [N1][kLDH].
template <typename T, int TH>
__device__ __forceinline__ void gelu_step(const Params& p, const float* h1s,
                                          float* dhc, const float (&pw)[9],
                                          float pb, int k, int b, int row0,
                                          int col0) {
  using S = Tile<TH>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  T* gact = static_cast<T*>(p.gact);
#pragma unroll
  for (int i = 0; i < S::P1; ++i) {
    const int q = warp + i * kWarps;
    if (q >= S::N1) continue;
    const int pr = q / S::W1, pc = q % S::W1;  // (pr, pc) + 1 in 2-halo
    float hc = pb + h1s[((pr + 1) * S::W2 + pc + 1) * kLDH + lane];
#pragma unroll
    for (int dr = 0; dr < 3; ++dr)
#pragma unroll
      for (int dc = 0; dc < 3; ++dc)
        hc = fmaf(h1s[((pr + dr) * S::W2 + pc + dc) * kLDH + lane],
                  pw[dr * 3 + dc], hc);
    const float cdf = 0.5f * (1.f + erff(hc * 0.7071067811865476f));
    const float pdf = expf(-0.5f * hc * hc) * 0.3989422804014327f;
    dhc[q * kLDH + lane] *= cdf + hc * pdf;
    const int r = row0 - 1 + pr, c = col0 - 1 + pc;
    if (pr >= 1 && pr <= TH && pc >= 1 && pc <= kTW && r < p.H && c < p.W)
      gact[((static_cast<size_t>(b) * p.H + r) * p.W + c) * p.Ch + k] =
          from_f<T>(hc * cdf);
  }
}

// Step 4 for hidden channel k = ch0 + lane on the tile's own pixels (warp
// w owns column w): dh1 = dhc + conv-transpose(dhc), rounded to T into
// dh1o (row stride ldd) and to dh1c in device memory; this warp's
// sums of dpos_w (9 taps), dpos_b and dfc1_b (fp32 dh1) into sums.
template <typename T, int TH>
__device__ __forceinline__ void dh1_step(const Params& p, const float* h1s,
                                         const float* dhc,
                                         const float (&pw)[9], T* dh1o,
                                         int ldd, float (&sums)[kNK], int k,
                                         int b, int row0, int col0) {
  using S = Tile<TH>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  T* dh1c = static_cast<T*>(p.dh1c);
#pragma unroll
  for (int i = 0; i < kNK; ++i) sums[i] = 0.f;
  float dh1[TH];  // every load first, the stores after
#pragma unroll
  for (int i = 0; i < TH; ++i) {
    const int qr = i, qc = warp;
    const float d0 = dhc[((qr + 1) * S::W1 + qc + 1) * kLDH + lane];
    float v = d0;
#pragma unroll
    for (int kk = 0; kk < 3; ++kk)
#pragma unroll
      for (int ll = 0; ll < 3; ++ll) {
        v = fmaf(dhc[((qr + 2 - kk) * S::W1 + qc + 2 - ll) * kLDH + lane],
                 pw[kk * 3 + ll], v);
        sums[kk * 3 + ll] =
            fmaf(d0, h1s[((qr + 1 + kk) * S::W2 + qc + 1 + ll) * kLDH + lane],
                 sums[kk * 3 + ll]);
      }
    sums[9] += d0;
    // a ragged tile's pixels outside the image take no gradient
    if (row0 + qr >= p.H || col0 + qc >= p.W) v = 0.f;
    sums[10] += v;
    dh1[i] = v;
  }
#pragma unroll
  for (int i = 0; i < TH; ++i) {
    const int r = row0 + i, c = col0 + warp;
    const T dq = from_f<T>(dh1[i]);
    dh1o[(i * kTW + warp) * ldd + lane] = dq;
    if (r < p.H && c < p.W)
      dh1c[((static_cast<size_t>(b) * p.H + r) * p.W + c) * p.Ch + k] = dq;
  }
}

// The block's sums over its 8 warps, in a fixed order ((w0 + w4) + (w1 +
// w5) + ...), to hid_part for the chunk. red: [4][kNK][32] floats. Holds
// two __syncthreads.
__device__ __forceinline__ void write_hidden_sums(const Params& p,
                                                  const float (&sums)[kNK],
                                                  float* red, int tile,
                                                  int ch0) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  constexpr int kHalf = kWarps / 2;
  float* row = red + (warp % kHalf) * kNK * kCK + lane;
  if (warp < kHalf) {
#pragma unroll
    for (int j = 0; j < kNK; ++j) row[j * kCK] = sums[j];
  }
  __syncthreads();
  if (warp >= kHalf) {
#pragma unroll
    for (int j = 0; j < kNK; ++j) row[j * kCK] += sums[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kNK * kCK; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kHalf; ++w) s += red[w * kNK * kCK + i];
    p.hid_part[(static_cast<size_t>(tile) * kNK + i / kCK) * p.Ch + ch0 +
               i % kCK] = s;
  }
}

// acc[i] = sum_c a[q][c] * wt[c * Ch] for the pixels q = warp + 8 i < np of
// a shared-memory tile a [np][C]; wt points at this lane's column of a
// [C, Ch] weight, so a warp reads 32 neighbouring hidden channels.
template <int PP>
__device__ __forceinline__ void tile_matmul(const float* a, int np, int C,
                                            const float* wt, int Ch,
                                            float (&acc)[PP]) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < PP; ++i) acc[i] = 0.f;
  for (int c0 = 0; c0 < C; c0 += 4) {
    float w[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) w[v] = wt[static_cast<size_t>(c0 + v) * Ch];
#pragma unroll
    for (int i = 0; i < PP; ++i) {
      const int q = warp + i * kWarps;
      if (q < np) {
        const float4 av = *reinterpret_cast<const float4*>(
            a + static_cast<size_t>(q) * C + c0);
        acc[i] = fmaf(av.x, w[0], acc[i]);
        acc[i] = fmaf(av.y, w[1], acc[i]);
        acc[i] = fmaf(av.z, w[2], acc[i]);
        acc[i] = fmaf(av.w, w[3], acc[i]);
      }
    }
  }
}

template <int TH>
size_t hidden_scalar_smem(int C) {
  using S = Tile<TH>;
  return sizeof(float) * (static_cast<size_t>(S::N2 + S::N1) * C +
                          (S::N2 + S::N1) * kLDH + S::NO * kLDA +
                          kWarps / 2 * kNK * kCK);
}

// Scalar-FMA K1 (fp32, for checks at a tight tolerance). NC: dy columns
// lane + 32 j, j < NC, cover C.
template <int TH, int NC>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_bwd_hidden(const Params p) {
  using T = float;
  using S = Tile<TH>;
  constexpr int NO = S::NO, N1 = S::N1, N2 = S::N2;
  extern __shared__ float4 smem_raw[];
  const int C = p.C, Ch = p.Ch;
  T* ys = reinterpret_cast<T*>(smem_raw);                // [N2][C]  LN(x)
  T* gs = ys + static_cast<size_t>(N2) * C;              // [N1][C]  g
  float* h1s = reinterpret_cast<float*>(gs + static_cast<size_t>(N1) * C);
  float* dhc = h1s + N2 * kLDH;                          // [N1][kLDH]
  float* dh1s = dhc + N1 * kLDH;                         // [NO][kLDA]
  float* red = dh1s + NO * kLDA;                         // [4][kNK][32]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.z / p.nsplit, split = blockIdx.z % p.nsplit;
  const int tile = (b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const int ch_begin = split * p.cps * kCK;
  const int ch_end = min(Ch, ch_begin + p.cps * kCK);
  const int row0 = blockIdx.y * TH, col0 = blockIdx.x * kTW;
  const T* fc1_w = static_cast<const T*>(p.fc1_w);
  const T* fc1_wt = static_cast<const T*>(p.fc1_wt);
  const T* fc2_w = static_cast<const T*>(p.fc2_w);
  const T* pos_w = static_cast<const T*>(p.pos_w);

  stage_halos<T, TH>(p, ys, gs, C, b, row0, col0);
  cp_async_wait<0>();
  __syncthreads();
  layernorm_in_place<T, TH, NC>(p, ys, C, b, row0, col0, split == 0);

  // this thread's share of dy: pixels (row i, column warp), channels
  // lane + 32 j
  float dy[TH][NC];
#pragma unroll
  for (int i = 0; i < TH; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dy[i][j] = 0.f;

  for (int ch0 = ch_begin; ch0 < ch_end; ch0 += kCK) {
    const int k = ch0 + lane;
    __syncthreads();  // ys, gs written; the last chunk's readers are done

    // 1. h1 over the 2-halo tile, zero outside the image
    {
      float h[S::P2];
      tile_matmul<S::P2>(ys, N2, C, fc1_wt + k, Ch, h);
      const float fb = p.fc1_b[k];
#pragma unroll
      for (int i = 0; i < S::P2; ++i) {
        const int q = warp + i * kWarps;
        if (q < N2) {
          const int r = row0 - 2 + q / S::W2, c = col0 - 2 + q % S::W2;
          h1s[q * kLDH + lane] =
              (r >= 0 && r < p.H && c >= 0 && c < p.W) ? h[i] + fb : 0.f;
        }
      }
    }
    // 2. dg over the 1-halo tile (0 outside the image, where g is 0)
    {
      float d[S::P1];
      tile_matmul<S::P1>(gs, N1, C, fc2_w + k, Ch, d);
#pragma unroll
      for (int i = 0; i < S::P1; ++i) {
        const int q = warp + i * kWarps;
        if (q < N1) dhc[q * kLDH + lane] = d[i];
      }
    }
    __syncthreads();

    float pw[9];
#pragma unroll
    for (int i = 0; i < 9; ++i)
      pw[i] = pos_w[static_cast<size_t>(i) * Ch + k];
    gelu_step<T, TH>(p, h1s, dhc, pw, p.pos_b[k], k, b, row0, col0);
    __syncthreads();
    float sums[kNK];
    dh1_step<T, TH>(p, h1s, dhc, pw, dh1s, kLDA, sums, k, b, row0, col0);
    write_hidden_sums(p, sums, red, tile, ch0);

    // dy += dh1c @ fc1_w[chunk]
    for (int kk = 0; kk < kCK; ++kk) {
      const T* wrow = fc1_w + static_cast<size_t>(ch0 + kk) * C;
      float wv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        wv[j] = c < C ? wrow[c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TH; ++i) {
        const float dv = dh1s[(i * kTW + warp) * kLDA + kk];
#pragma unroll
        for (int j = 0; j < NC; ++j) dy[i][j] = fmaf(dv, wv[j], dy[i][j]);
      }
    }
  }

  // this split's dy for the own pixels in the image
  const size_t N = static_cast<size_t>(p.B) * p.H * p.W;
#pragma unroll
  for (int i = 0; i < TH; ++i) {
    const int r = row0 + i, c = col0 + warp;
    if (r >= p.H || c >= p.W) continue;
    const size_t pix = (static_cast<size_t>(b) * p.H + r) * p.W + c;
    float* out = p.dy_part + (split * N + pix) * C;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int ch = lane + 32 * j;
      if (ch < C) out[ch] = dy[i][j];
    }
  }
}

// ---------------------------------------------------------- tensor cores --
// bf16 products on mma.sync m16n8k16 with fp32 accumulation; operands
// staged in shared memory (cp.async) and loaded with ldmatrix, .trans for
// the operands stored with the reduction index along rows.

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The A fragment of the 16x16 tile at `a` of a row-major [m][k] tile (row
// stride ld).
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* a,
                                       int ld) {
  const int l = threadIdx.x % 32;
  ldsm_x4(r, a + (l % 16) * ld + (l / 16) * 8);
}
// The A fragment of the 16x16 tile A[m][k] = s[k][m] at `s` of a [k][m]
// tile (row stride ld).
__device__ __forceinline__ void load_a_trans(uint32_t (&r)[4], const bf16* s,
                                             int ld) {
  const int l = threadIdx.x % 32, i = l / 8;
  ldsm_x4_trans(r, s + (l % 8 + 8 * (i / 2)) * ld + 8 * (i % 2));
}
// B fragments {b0, b1} of two neighbouring n-tiles (r[0..1], r[2..3]) of a
// 16 (k) x 16 (n) tile B[k][n] = s[n][k] at `s` of an [n][k] tile.
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* s,
                                       int ld) {
  const int l = threadIdx.x % 32, i = l / 8;
  ldsm_x4(r, s + (l % 8 + 8 * (i / 2)) * ld + 8 * (i % 2));
}
// The same for B[k][n] = s[k][n] at `s` of a [k][n] tile.
__device__ __forceinline__ void load_b_trans(uint32_t (&r)[4], const bf16* s,
                                             int ld) {
  const int l = threadIdx.x % 32, i = l / 8;
  ldsm_x4_trans(r, s + (l % 8 + 8 * (i % 2)) * ld + 8 * (i / 2));
}

// Start copying the chunk's 32 rows of a [Ch, C] weight into dst [32][ld].
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* w, int ch0,
                                           int C, int ld) {
  const int per_row = C / 8;
  for (int i = threadIdx.x; i < kCK * per_row; i += kThreads) {
    const int n = i / per_row, k = (i % per_row) * 8;
    cp_async16(dst + n * ld + k, w + static_cast<size_t>(ch0 + n) * C + k);
  }
  cp_async_commit();
}

// d[j] += A [16 x K] @ B[:, n-tile j] over K = C for the m-tile at `a`
// (row-major, stride ld) and the chunk's 32 rows of w (an [n][k] tile).
__device__ __forceinline__ void mma_rows(float (&d)[4][4], const bf16* a,
                                         const bf16* w, int C, int ld) {
#pragma unroll 2
  for (int k0 = 0; k0 < C; k0 += 16) {
    uint32_t af[4], b0[4], b1[4];
    load_a(af, a + k0, ld);
    load_b(b0, w + k0, ld);
    load_b(b1, w + 16 * ld + k0, ld);
    mma_bf16(d[0], af, b0[0], b0[1]);
    mma_bf16(d[1], af, b0[2], b0[3]);
    mma_bf16(d[2], af, b1[0], b1[1]);
    mma_bf16(d[3], af, b1[2], b1[3]);
  }
}

template <int TH>
struct MmaTile : Tile<TH> {
  using S = Tile<TH>;
  static constexpr int M2 = (S::N2 + 15) / 16;  // m-tiles of the 2-halo
  static constexpr int M1 = (S::N1 + 15) / 16;  // m-tiles of the 1-halo
  static constexpr int MO = S::NO / 16;         // m-tiles of the own pixels
  static constexpr int WN = kWarps / MO;        // warps per own m-tile
};

constexpr int kLDK = kCK + 8;  // bf16 row stride of the dh1c tile

// Shared memory of the tensor-core K1 with nbuf buffers of fc1's chunk.
// The row-padded m-tiles of ys and gs read past their last row into the
// next buffer: those rows of the product are never stored.
template <int TH>
size_t hidden_mma_smem(int C, int nbuf) {
  using S = Tile<TH>;
  const size_t ldy = C + 8;
  return sizeof(bf16) * (ldy * (S::N2 + S::N1 + kCK * (nbuf + 1)) +
                         S::NO * kLDK) +
         sizeof(float) * ((S::N2 + S::N1) * kLDH + kWarps / 2 * kNK * kCK);
}

// Units [u0, u1) of the chunk's two halo products, warp-strided: units 0
// .. M1-1 are the m-tiles of dg = gs @ fc2 chunk (1-halo; 0 outside the
// image, where g is 0) into dhc, the next M2 those of h1 = ys @ fc1 chunk
// + fc1_b (2-halo; 0 outside the image) into h1s.
template <int TH>
__device__ __forceinline__ void halo_products(
    const Params& p, const bf16* ys, const bf16* gs, const bf16* w1c,
    const bf16* w2s, float* h1s, float* dhc, int u0, int u1, int ldy,
    int ch0, int row0, int col0) {
  using S = MmaTile<TH>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g8 = lane / 4, t4 = lane % 4;
  float fb[4][2];  // fc1_b of this thread's columns, loaded before the mma
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) fb[j][e] = p.fc1_b[ch0 + j * 8 + 2 * t4 + e];
  for (int u = u0 + warp; u < u1; u += kWarps) {
    const bool is_dg = u < S::M1;
    const int mt = is_dg ? u : u - S::M1;
    float d[4][4] = {};
    mma_rows(d, (is_dg ? gs : ys) + mt * 16 * ldy, is_dg ? w2s : w1c, p.C,
             ldy);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int q = mt * 16 + g8 + hf * 8;
      if (is_dg) {
        if (q >= S::N1) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            dhc[q * kLDH + j * 8 + 2 * t4 + e] = d[j][2 * hf + e];
      } else {
        if (q >= S::N2) continue;
        const int r = row0 - 2 + q / S::W2, c = col0 - 2 + q % S::W2;
        const bool inside = r >= 0 && r < p.H && c >= 0 && c < p.W;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            h1s[q * kLDH + j * 8 + 2 * t4 + e] =
                inside ? d[j][2 * hf + e] + fb[j][e] : 0.f;
      }
    }
  }
}

// Tensor-core K1 (bf16). Per chunk, with the weight copies in flight: the
// halo products dg and h1; the scalar gelu and conv-transpose steps; dy +=
// dh1c @ fc1 chunk^T in registers. fc1's chunk is read by the first and
// the last product of a chunk. With nbuf = 2 the next chunk's copy goes to
// the other buffer at the chunk's start and the two halo products run as
// one list of units; with nbuf = 1 it starts after the chunk's dy, and h1
// waits for it after dg. fc2's next chunk starts once dg is done. Warp w
// owns own m-tile w % MO and the pairs of n-tiles w / MO + WN j of dy.
// CV: C <= 32 CV; MINB: blocks per SM the registers must allow.
template <int TH, int CV, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
fused_mlp_bwd_hidden_mma(const Params p) {
  using S = MmaTile<TH>;
  constexpr int NO = S::NO, N1 = S::N1, N2 = S::N2;
  constexpr int NP = (2 * CV + S::WN - 1) / S::WN;  // n-tile pairs per warp
  extern __shared__ float4 smem_raw[];
  const int C = p.C, Ch = p.Ch, ldy = C + 8, nbuf = p.nbuf;
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);             // [N2][ldy]
  bf16* gs = ys + static_cast<size_t>(N2) * ldy;            // [N1][ldy]
  bf16* w1s = gs + static_cast<size_t>(N1) * ldy;           // [nbuf][32][ldy]
  bf16* w2s = w1s + static_cast<size_t>(nbuf) * kCK * ldy;  // [32][ldy]
  bf16* dh1b = w2s + static_cast<size_t>(kCK) * ldy;        // [NO][kLDK]
  float* h1s = reinterpret_cast<float*>(dh1b + NO * kLDK);  // [N2][kLDH]
  float* dhc = h1s + N2 * kLDH;                             // [N1][kLDH]
  float* red = dhc + N1 * kLDH;                             // [4][kNK][32]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int b = blockIdx.z / p.nsplit, split = blockIdx.z % p.nsplit;
  const int tile = (b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const int ch_begin = split * p.cps * kCK;
  const int ch_end = min(Ch, ch_begin + p.cps * kCK);
  const int row0 = blockIdx.y * TH, col0 = blockIdx.x * kTW;
  const bf16* fc1_w = static_cast<const bf16*>(p.fc1_w);    // [Ch, C]
  const bf16* fc2_wt = static_cast<const bf16*>(p.fc2_wt);  // [Ch, C]
  const bf16* pos_w = static_cast<const bf16*>(p.pos_w);

  // the first chunk's weights load while the LayerNorm runs
  stage_halos<bf16, TH>(p, ys, gs, ldy, b, row0, col0);
  stage_rows(w2s, fc2_wt, ch_begin, C, ldy);
  stage_rows(w1s, fc1_w, ch_begin, C, ldy);
  cp_async_wait<2>();  // the halos
  __syncthreads();
  layernorm_in_place<bf16, TH, CV>(p, ys, ldy, b, row0, col0, split == 0);

  const int mo = warp % S::MO, pair0 = warp / S::MO;
  const int npairs = C / 16;
  float acc[NP][2][4];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][h][e] = 0.f;

  // Copy groups in flight at a chunk's start, oldest first: nbuf = 2:
  // fc1(this), fc2(this), then fc1(next) issued here; nbuf = 1: fc2(this),
  // fc1(this).
  for (int ch0 = ch_begin, it = 0; ch0 < ch_end; ch0 += kCK, ++it) {
    const bool has_next = ch0 + kCK < ch_end;
    const bf16* w1c = w1s + (nbuf == 2 ? (it & 1) : 0) * kCK * ldy;
    __syncthreads();  // the last chunk's readers of every buffer are done
    if (nbuf == 2) {
      if (has_next) {
        stage_rows(w1s + ((it + 1) & 1) * kCK * ldy, fc1_w, ch0 + kCK, C,
                   ldy);
        cp_async_wait<1>();  // fc1 and fc2 of this chunk
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      halo_products<TH>(p, ys, gs, w1c, w2s, h1s, dhc, 0, S::M1 + S::M2, ldy,
                        ch0, row0, col0);
      __syncthreads();  // w2s free
      if (has_next) stage_rows(w2s, fc2_wt, ch0 + kCK, C, ldy);
    } else {
      cp_async_wait<1>();  // fc2 of this chunk
      __syncthreads();
      halo_products<TH>(p, ys, gs, w1c, w2s, h1s, dhc, 0, S::M1, ldy, ch0,
                        row0, col0);
      cp_async_wait<0>();  // fc1 of this chunk
      __syncthreads();     // w2s free; fc1 visible
      if (has_next) stage_rows(w2s, fc2_wt, ch0 + kCK, C, ldy);
      halo_products<TH>(p, ys, gs, w1c, w2s, h1s, dhc, S::M1, S::M1 + S::M2,
                        ldy, ch0, row0, col0);
      __syncthreads();
    }

    const int k = ch0 + lane;
    float pw[9];
#pragma unroll
    for (int i = 0; i < 9; ++i)
      pw[i] = __bfloat162float(pos_w[static_cast<size_t>(i) * Ch + k]);
    gelu_step<bf16, TH>(p, h1s, dhc, pw, p.pos_b[k], k, b, row0, col0);
    __syncthreads();
    float sums[kNK];
    dh1_step<bf16, TH>(p, h1s, dhc, pw, dh1b, kLDK, sums, k, b, row0, col0);
    write_hidden_sums(p, sums, red, tile, ch0);  // syncs: dh1b complete

    // dy += dh1c @ fc1[chunk]^T: B[kk][c] = w1c[kk][c]
#pragma unroll
    for (int k0 = 0; k0 < kCK; k0 += 16) {
      uint32_t af[4];
      load_a(af, dh1b + mo * 16 * kLDK + k0, kLDK);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int pr = pair0 + S::WN * j;
        if (pr < npairs) {
          uint32_t bfr[4];
          load_b_trans(bfr, w1c + k0 * ldy + pr * 16, ldy);
          mma_bf16(acc[j][0], af, bfr[0], bfr[1]);
          mma_bf16(acc[j][1], af, bfr[2], bfr[3]);
        }
      }
    }
    if (nbuf == 1 && has_next) {
      __syncthreads();  // w1s free
      stage_rows(w1s, fc1_w, ch0 + kCK, C, ldy);
    }
  }

  // this split's dy for the own pixels in the image
  const size_t N = static_cast<size_t>(p.B) * p.H * p.W;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int pr = pair0 + S::WN * j;
    if (pr >= npairs) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int q = mo * 16 + g8 + hf * 8;
      const int r = row0 + q / kTW, c = col0 + q % kTW;
      if (r >= p.H || c >= p.W) continue;
      float* out = p.dy_part +
                   (split * N + (static_cast<size_t>(b) * p.H + r) * p.W + c) *
                       C +
                   pr * 16 + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(out + h * 8) =
            make_float2(acc[j][h][2 * hf], acc[j][h][2 * hf + 1]);
    }
  }
}

// ------------------------------------------------------------------ K2 ---
// fused_mlp_bwd_ln: one warp per pixel, the pixel's channels lane + 32 j
// (j < CV) in registers, every load issued before the first sum. dy = the
// splits' partials summed in split order; mean and rstd as in K1's
// LayerNorm (the same order, so y0 agrees to the bit with the y that K1
// used); dx = rstd * (dyn - mean(dyn) - y0 * mean(dyn * y0)), dyn = dy *
// ln_w; the block's sums of dln_w, dln_b and dfc2_b to ln_part.
template <typename T, int CV>
__global__ void __launch_bounds__(kThreads)
fused_mlp_bwd_ln(const Params p) {
  extern __shared__ float4 smem_raw[];
  const int C = p.C;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* sums = reinterpret_cast<float*>(smem_raw);  // [8][3][C]
  float* red = sums + warp * 3 * C;                  // this warp's
  const size_t N = static_cast<size_t>(p.B) * p.H * p.W;
  const T* x = static_cast<const T*>(p.x);
  const T* g = static_cast<const T*>(p.g);
  T* dx = static_cast<T*>(p.dx);

  for (int i = lane; i < 3 * C; i += 32) red[i] = 0.f;
  for (int i = 0; i < p.ln_pixels / kWarps; ++i) {
    const size_t q =
        static_cast<size_t>(blockIdx.x) * p.ln_pixels + warp + kWarps * i;
    if (q >= N) break;
    float xv[CV], gv[CV], dv[CV];
#pragma unroll
    for (int j = 0; j < CV; ++j) {
      const int c = lane + 32 * j;
      if (c < C) {
        xv[j] = to_f(x[q * C + c]);
        gv[j] = to_f(g[q * C + c]);
        dv[j] = p.dy_part[q * C + c];
      }
    }
    for (int sp = 1; sp < p.nsplit; ++sp)
#pragma unroll
      for (int j = 0; j < CV; ++j)
        if (lane + 32 * j < C)
          dv[j] += p.dy_part[(sp * N + q) * C + lane + 32 * j];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < CV; ++j)
      if (lane + 32 * j < C) s += xv[j];
    const float mean = warp_sum(s) / C;
    float var = 0.f;
#pragma unroll
    for (int j = 0; j < CV; ++j)
      if (lane + 32 * j < C) {
        const float d = xv[j] - mean;
        var += d * d;
      }
    const float rstd = rsqrtf(warp_sum(var) / C + p.eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < CV; ++j) {
      const int c = lane + 32 * j;
      if (c < C) {
        const float y0 = (xv[j] - mean) * rstd;
        red[c] = fmaf(dv[j], y0, red[c]);
        red[C + c] += dv[j];
        red[2 * C + c] += gv[j];
        xv[j] = y0;
        dv[j] *= p.ln_w[c];  // dyn
        s1 += dv[j];
        s2 = fmaf(dv[j], y0, s2);
      }
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int j = 0; j < CV; ++j) {
      const int c = lane + 32 * j;
      if (c < C) dx[q * C + c] = from_f<T>(rstd * (dv[j] - m1 - xv[j] * m2));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * C; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sums[w * 3 * C + i];
    p.ln_part[static_cast<size_t>(blockIdx.x) * 3 * C + i] = s;
  }
}

// ------------------------------------------------------------------ K3 ---
// fused_mlp_bwd_wgrad: w_part[prod][slice] = A[slice]^T B[slice] over the
// slice's pixels, A [N, Ch] and B [N, C]: prod 0 is dfc2_w (gact, g), prod
// 1 is dfc1_w (dh1c, y). Grid (C / 96, Ch / 256, 2 * slices); each block
// one 256 x 96 output tile of one slice, 256 threads. The long reduction
// over pixels makes the product bound by the L2 traffic of its operands,
// which every tile of the other dimension reads again: wide tiles read
// them fewer times.

// Scalar-FMA version (fp32): 8 x 12 outputs per thread.
__global__ void __launch_bounds__(kThreads)
fused_mlp_bwd_wgrad(const Params p) {
  using T = float;
  constexpr int kK = kWK / 2;           // pixels per stage
  __shared__ float4 as4[kK][kWM / 4];   // [pixel][hidden]
  __shared__ float4 bs4[kK][kWN / 4];   // [pixel][channel]
  float* as = reinterpret_cast<float*>(as4);
  float* bs = reinterpret_cast<float*>(bs4);
  const int C = p.C, Ch = p.Ch;
  const int prod = blockIdx.z / p.slices, slice = blockIdx.z % p.slices;
  const T* A = static_cast<const T*>(prod == 0 ? p.gact : p.dh1c);
  const T* Bm = static_cast<const T*>(prod == 0 ? p.g : p.y);
  const int n0 = blockIdx.x * kWN, m0 = blockIdx.y * kWM;
  const int N = p.B * p.H * p.W;
  const int pbeg = slice * p.slice_len;
  const int pend = min(N, pbeg + p.slice_len);
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;  // 12 cols, 8 rows

  float acc[8][12];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[i][j] = 0.f;

  for (int k0 = pbeg; k0 < pend; k0 += kK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kK * kWM; i += kThreads) {
      const int kk = i / kWM, j = i % kWM, q = k0 + kk;
      as[i] = (q < pend && m0 + j < Ch)
                  ? A[static_cast<size_t>(q) * Ch + m0 + j]
                  : 0.f;
    }
    for (int i = threadIdx.x; i < kK * kWN; i += kThreads) {
      const int kk = i / kWN, j = i % kWN, q = k0 + kk;
      bs[i] = (q < pend && n0 + j < C)
                  ? Bm[static_cast<size_t>(q) * C + n0 + j]
                  : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kK; ++kk) {
      float av[8], bw[12];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 a = as4[kk][2 * ty + i];
        av[4 * i] = a.x, av[4 * i + 1] = a.y, av[4 * i + 2] = a.z,
        av[4 * i + 3] = a.w;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4 v = bs4[kk][3 * tx + j];
        bw[4 * j] = v.x, bw[4 * j + 1] = v.y, bw[4 * j + 2] = v.z,
        bw[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 12; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
  }

  float* out = p.w_part + (static_cast<size_t>(prod) * p.slices + slice) *
                              Ch * C;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= Ch) continue;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int n = n0 + tx * 12 + j;
      if (n < C) out[static_cast<size_t>(m) * C + n] = acc[i][j];
    }
  }
}

// Tensor-core version (bf16): warp w owns the 64 x 48 sub-tile (w % 4,
// w / 4); kWK-pixel stages in a kWStages-deep cp.async ring in dynamic
// shared memory.
constexpr int kWStages = 3;
constexpr int kWLDA = kWM + 8;  // bf16 row strides of a stage's tiles
constexpr int kWLDB = kWN + 8;
constexpr size_t kWSmem = sizeof(bf16) * kWStages * kWK * (kWLDA + kWLDB);

__global__ void __launch_bounds__(kThreads)
fused_mlp_bwd_wgrad_mma(const Params p) {
  extern __shared__ float4 smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // [stage][pixel][hidden]
  bf16* bs = as + kWStages * kWK * kWLDA;        // [stage][pixel][channel]
  const int C = p.C, Ch = p.Ch;
  const int prod = blockIdx.z / p.slices, slice = blockIdx.z % p.slices;
  const bf16* A = static_cast<const bf16*>(prod == 0 ? p.gact : p.dh1c);
  const bf16* Bm = static_cast<const bf16*>(prod == 0 ? p.g : p.y);
  const int n0 = blockIdx.x * kWN, m0 = blockIdx.y * kWM;
  const int N = p.B * p.H * p.W;
  const int pbeg = slice * p.slice_len;
  const int pend = min(N, pbeg + p.slice_len);
  const int nk = (pend - pbeg + kWK - 1) / kWK;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp % 4) * 64, wn = (warp / 4) * 48;

  // rows past the slice and columns past Ch or C are zero-filled
  auto stage = [&](int st, int k0) {
    constexpr int ca = kWM / 8, cb = kWN / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < kWK * ca; i += kThreads) {
      const int kk = i / ca, c8 = (i % ca) * 8, q = k0 + kk;
      bf16* dst = as + (st * kWK + kk) * kWLDA + c8;
      if (q < pend && m0 + c8 < Ch)
        cp_async16(dst, A + static_cast<size_t>(q) * Ch + m0 + c8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = threadIdx.x; i < kWK * cb; i += kThreads) {
      const int kk = i / cb, c8 = (i % cb) * 8, q = k0 + kk;
      bf16* dst = bs + (st * kWK + kk) * kWLDB + c8;
      if (q < pend && n0 + c8 < C)
        cp_async16(dst, Bm + static_cast<size_t>(q) * C + n0 + c8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  };

  float acc[4][6][4] = {};
#pragma unroll
  for (int s = 0; s < kWStages - 1; ++s) {
    if (s < nk) stage(s, pbeg + s * kWK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kWStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1's readers are done
    if (kt + kWStages - 1 < nk)
      stage((kt + kWStages - 1) % kWStages, pbeg + (kt + kWStages - 1) * kWK);
    cp_async_commit();
    const bf16* at = as + (kt % kWStages) * kWK * kWLDA;
    const bf16* bt = bs + (kt % kWStages) * kWK * kWLDB;
#pragma unroll
    for (int k0 = 0; k0 < kWK; k0 += 16) {
      uint32_t af[4][4], bfr[3][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        load_a_trans(af[i], at + k0 * kWLDA + wm + 16 * i, kWLDA);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        load_b_trans(bfr[j], bt + k0 * kWLDB + wn + 16 * j, kWLDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j / 2][2 * (j % 2)],
                   bfr[j / 2][2 * (j % 2) + 1]);
    }
  }

  float* out = p.w_part + (static_cast<size_t>(prod) * p.slices + slice) *
                              Ch * C;
  const int g8 = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + wm + 16 * i + g8 + 8 * hf;
      if (m >= Ch) continue;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t4;
        if (n < C)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * C + n) =
              make_float2(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
      }
    }
}

// ------------------------------------------------------------------ K4 ---
// fused_mlp_bwd_reduce: every output is the sum of its partial buffer over
// the leading index, in index order, cast to the output's type. A block
// takes 256 / G consecutive outputs of one segment, G threads per output:
// thread group r adds the partials r, r + G, ... (four running sums,
// combined in a fixed order), then the groups' sums are added in group
// order. G = 8 where there are many partials, else 1.

struct Segment {
  const float* src;  // [count][stride], the first len of each row used
  void* dst;         // [len], fp32 or bf16
  long long stride;
  int len, count, to_bf16, groups, first_block;
};
constexpr int kSegments = 8;
struct Segments {
  Segment s[kSegments];
};

__global__ void __launch_bounds__(kThreads)
fused_mlp_bwd_reduce(const Segments segs) {
  __shared__ float red[kThreads];
  int i = 0;
  while (i + 1 < kSegments &&
         static_cast<int>(blockIdx.x) >= segs.s[i + 1].first_block)
    ++i;
  const Segment& sg = segs.s[i];
  const int G = sg.groups, width = kThreads / G;
  const int grp = threadIdx.x / width, lane = threadIdx.x % width;
  const int col = (blockIdx.x - sg.first_block) * width + lane;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (col < sg.len) {
    const float* src = sg.src + col;
    int k = grp;
    for (; k + 3 * G < sg.count; k += 4 * G) {
      a0 += src[k * sg.stride];
      a1 += src[(k + G) * sg.stride];
      a2 += src[(k + 2 * G) * sg.stride];
      a3 += src[(k + 3 * G) * sg.stride];
    }
    for (; k < sg.count; k += G) a0 += src[k * sg.stride];
  }
  red[threadIdx.x] = (a0 + a1) + (a2 + a3);
  __syncthreads();
  if (grp == 0 && col < sg.len) {
    float s = 0.f;
    for (int r = 0; r < G; ++r) s += red[r * width + lane];
    if (sg.to_bf16)
      static_cast<bf16*>(sg.dst)[col] = __float2bfloat16(s);
    else
      static_cast<float*>(sg.dst)[col] = s;
  }
}

Segments reduce_segments(const Params& p, bool is_bf16) {
  const int C = p.C, Ch = p.Ch;
  const long long cc = static_cast<long long>(Ch) * C;
  const int tiles = p.B * ((p.H + p.th - 1) / p.th) * ((p.W + kTW - 1) / kTW);
  const int ln_blocks = (p.B * p.H * p.W + p.ln_pixels - 1) / p.ln_pixels;
  const int t = is_bf16;
  Segments s{{
      {p.ln_part, p.dln_w, 3 * C, C, ln_blocks, 0},
      {p.ln_part + C, p.dln_b, 3 * C, C, ln_blocks, 0},
      {p.ln_part + 2 * C, p.dfc2_b, 3 * C, C, ln_blocks, 0},
      {p.hid_part, p.dpos_w, kNK * Ch, 9 * Ch, tiles, t},
      {p.hid_part + 9 * Ch, p.dpos_b, kNK * Ch, Ch, tiles, 0},
      {p.hid_part + 10 * Ch, p.dfc1_b, kNK * Ch, Ch, tiles, 0},
      {p.w_part, p.dfc2_w, cc, static_cast<int>(cc), p.slices, t},
      {p.w_part + p.slices * cc, p.dfc1_w, cc, static_cast<int>(cc),
       p.slices, t},
  }};
  int blocks = 0;
  for (Segment& sg : s.s) {
    sg.groups = sg.count >= 64 ? 8 : 1;
    sg.first_block = blocks;
    blocks += (sg.len + kThreads / sg.groups - 1) / (kThreads / sg.groups);
  }
  return s;
}

int reduce_blocks(const Segments& s) {
  const Segment& last = s.s[kSegments - 1];
  const int width = kThreads / last.groups;
  return last.first_block + (last.len + width - 1) / width;
}

// ---------------------------------------------------------------- host ---

using Kernel = void (*)(Params);

struct Launch {
  Kernel fn;
  size_t smem;
  int threads;
  int nbuf;
};

constexpr int kSmemPerSM = 233472;  // 228 KB, of which 1 KB per block
constexpr int kSmemPerBlock = 1024;  // is reserved

// The tensor-core K1, with two buffers of fc1's chunk where they cost no
// block per SM.
template <int TH, int CV, int MINB>
Launch hidden_mma(int C) {
  const size_t s1 = hidden_mma_smem<TH>(C, 1), s2 = hidden_mma_smem<TH>(C, 2);
  auto fit = [](size_t s) {
    const int n = static_cast<int>(kSmemPerSM / (s + kSmemPerBlock));
    return n < MINB ? n : MINB;
  };
  const bool two = s2 <= kMaxSmem && fit(s2) >= fit(s1);
  return {fused_mlp_bwd_hidden_mma<TH, CV, MINB>, two ? s2 : s1, kThreads,
          two ? 2 : 1};
}

// K1's tile height at this width: the halo tiles of LN(x) and g must fit in
// shared memory, so it falls as the bytes of one pixel's channels grow.
template <typename T>
int tile_rows(int C) {
  if constexpr (sizeof(T) == 2) return C <= 288 ? 8 : 2;
  return C <= 144 ? 8 : (C <= 288 ? 4 : 1);
}

// K1 for this dtype and tile height, or fn = nullptr if there is none.
template <typename T>
Launch hidden_kernel(int th, int C) {
  if constexpr (sizeof(T) == 2) {
    if (th == 8 && C <= 96) return hidden_mma<8, 3, 2>(C);
    if (th == 8 && C <= 192) return hidden_mma<8, 6, 1>(C);
    if (th == 8 && C <= 288) return hidden_mma<8, 9, 1>(C);
    if (th == 2 && C <= 576) return hidden_mma<2, 18, 1>(C);
  } else {
    const int nc = (C + 31) / 32;
#define DFORMER_K1(TH, NC)                                                  \
  if (th == TH && nc <= NC)                                                 \
    return {fused_mlp_bwd_hidden<TH, NC>, hidden_scalar_smem<TH>(C),      \
            kThreads, 1};
    DFORMER_K1(8, 3) DFORMER_K1(8, 5) DFORMER_K1(4, 9) DFORMER_K1(1, 18)
#undef DFORMER_K1
  }
  return {nullptr, 0, 0, 0};
}

template <typename T>
Launch ln_kernel(int C) {
  const size_t smem = sizeof(float) * kWarps * 3 * C;
  if (C <= 96) return {fused_mlp_bwd_ln<T, 3>, smem, kThreads, 0};
  if (C <= 192) return {fused_mlp_bwd_ln<T, 6>, smem, kThreads, 0};
  if (C <= 288) return {fused_mlp_bwd_ln<T, 9>, smem, kThreads, 0};
  return {fused_mlp_bwd_ln<T, 18>, smem, kThreads, 0};
}

template <typename T>
Launch wgrad_kernel() {
  if constexpr (sizeof(T) == 2)
    return {fused_mlp_bwd_wgrad_mma, kWSmem, kThreads, 0};
  else
    return {fused_mlp_bwd_wgrad, 0, kThreads, 0};
}

// The four launches on `stream`; with ev (5 events), recorded before each
// launch and after the last.
cudaError_t launch_all(const Params& p, const Launch& k1, const Launch& k2,
                       const Launch& k3, const Segments& segs,
                       cudaStream_t stream, cudaEvent_t* ev) {
  auto mark = [&](int i) {
    if (ev != nullptr) cudaEventRecord(ev[i], stream);
  };
  const int N = p.B * p.H * p.W;
  cudaError_t e;
  mark(0);
  k1.fn<<<dim3((p.W + kTW - 1) / kTW, (p.H + p.th - 1) / p.th,
               p.B * p.nsplit),
          k1.threads, k1.smem, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  mark(1);
  k2.fn<<<(N + p.ln_pixels - 1) / p.ln_pixels, k2.threads, k2.smem,
          stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  mark(2);
  k3.fn<<<dim3((p.C + kWN - 1) / kWN, (p.Ch + kWM - 1) / kWM,
               2 * p.slices),
          k3.threads, k3.smem, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  mark(3);
  fused_mlp_bwd_reduce<<<reduce_blocks(segs), kThreads, 0, stream>>>(segs);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  mark(4);
  return cudaSuccess;
}

template <typename T>
cudaError_t run(Params p, cudaStream_t stream, float* stage_ms) {
  const Launch k1 = hidden_kernel<T>(p.th, p.C);
  const Launch k2 = ln_kernel<T>(p.C);
  const Launch k3 = wgrad_kernel<T>();
  if (k1.fn == nullptr || k1.smem > kMaxSmem) return cudaErrorInvalidValue;
  p.nbuf = k1.nbuf;
  cudaError_t e = cudaSuccess;
  for (const Launch* k : {&k1, &k2, &k3})
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k->fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(k->smem));
  if (e != cudaSuccess) return e;
  const Segments segs = reduce_segments(p, sizeof(T) == 2);
  if (stage_ms == nullptr) return launch_all(p, k1, k2, k3, segs, stream,
                                             nullptr);
  cudaEvent_t ev[5] = {};
  for (cudaEvent_t& v : ev)
    if (e == cudaSuccess) e = cudaEventCreate(&v);
  if (e == cudaSuccess) e = launch_all(p, k1, k2, k3, segs, stream, ev);
  if (e == cudaSuccess) e = cudaEventSynchronize(ev[4]);
  for (int i = 0; i < 4 && e == cudaSuccess; ++i)
    e = cudaEventElapsedTime(stage_ms + i, ev[i], ev[i + 1]);
  for (cudaEvent_t v : ev)
    if (v != nullptr) cudaEventDestroy(v);
  return e;
}

}  // namespace

extern "C" {

// Launches the backward on `stream` as four kernels (K1 bwd_hidden, K2
// bwd_ln, K3 bwd_wgrad, K4 bwd_reduce) and returns the first
// cudaGetLastError() that is not 0. Device pointers to contiguous tensors:
// x, g, dx [B,H,W,C]; fc1_w [Ch,C], fc1_wt [C,Ch], pos_w [3,3,Ch], fc2_w
// [C,Ch], fc2_wt [Ch,C] (in bf16 fc1_wt and fc2_w are not read and may be
// null; in fp32 fc2_wt), dfc1_w, dfc2_w [Ch,C], dpos_w [3,3,Ch] and the
// scratch y [N,C], gact and dh1c [N,Ch] in the I/O type (bf16 when is_bf16,
// else fp32); ln_w, ln_b, dln_w, dln_b, dfc2_b [C], fc1_b, pos_b, dfc1_b,
// dpos_b [Ch] and the fp32 scratch dy_part [nsplit,N,C], hid_part
// [tiles,11,Ch], ln_part [ceil(N/ln_pixels),3,C], w_part [2,slices,Ch,C].
// The plan (tile rows th, chunks_per_split, nsplit, ln_pixels, slice_len,
// slices) comes from the caller (kernels/fused_mlp.py::backward_plan): it
// must cover every pixel and hidden channel exactly once, and name a tile
// height this file has a kernel for (dformer_fused_mlp_bwd_occupancy
// reports the one to use); cudaErrorInvalidValue if it does not.
// With stage_ms (host, 4 floats) the call also times each launch with CUDA
// events and waits for the last.
int dformer_fused_mlp_bwd(
    const void* x, const void* g, const float* ln_w, const float* ln_b,
    const void* fc1_w, const void* fc1_wt, const float* fc1_b,
    const void* pos_w, const float* pos_b, const void* fc2_w,
    const void* fc2_wt, void* dx, float* dln_w, float* dln_b, void* dfc1_w,
    float* dfc1_b, void* dpos_w, float* dpos_b, void* dfc2_w, float* dfc2_b,
    void* y, void* gact, void* dh1c, float* dy_part, float* hid_part,
    float* ln_part, float* w_part, int B, int H, int W, int C, int Ch,
    float eps, int th, int cps, int nsplit, int ln_pixels, int slice_len,
    int slices, int is_bf16, void* stream, float* stage_ms) {
  const long long N = static_cast<long long>(B) * H * W;
  const int nchunks = Ch / kCK;
  if (C <= 0 || C > kMaxC || C % (is_bf16 ? 16 : 4) != 0 || Ch <= 0 ||
      Ch % kCK != 0 || B <= 0 || H <= 0 || W <= 0 || N * Ch > INT32_MAX ||
      th <= 0 || cps <= 0 || nsplit != (nchunks + cps - 1) / cps ||
      ln_pixels < kWarps || ln_pixels > 64 || ln_pixels % kWarps != 0 ||
      slice_len <= 0 || slice_len % kWK != 0 ||
      slices != (N + slice_len - 1) / slice_len || B * nsplit > 65535 ||
      2 * slices > 65535)
    return cudaErrorInvalidValue;
  const Params p{x,      g,      ln_w,     ln_b,     fc1_w,   fc1_wt,
                 fc1_b,  pos_w,  pos_b,    fc2_w,    fc2_wt,  dx,
                 dln_w,  dln_b,  dfc2_b,   dfc1_w,   dfc2_w,  dfc1_b,
                 dpos_b, dpos_w, y,        gact,     dh1c,    dy_part,
                 hid_part, ln_part, w_part, B,       H,       W,
                 C,      Ch,     eps,      th,       cps,     nsplit,
                 ln_pixels, slice_len, slices, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<bf16>(p, s, stage_ms) : run<float>(p, s, stage_ms);
}

// K1's tile height at this width into out[0]; the blocks per SM that the
// card can hold of K1 at that height and of K3
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into out[1], out[2]; K1's
// dynamic shared memory in bytes and its buffers of fc1's chunk into out[3],
// out[4]. The caller's plan takes the tile height and K1's blocks per SM
// from here.
int dformer_fused_mlp_bwd_occupancy(int C, int is_bf16, int* out) {
  if (C <= 0 || C > kMaxC) return cudaErrorInvalidValue;
  const int th = is_bf16 ? tile_rows<bf16>(C) : tile_rows<float>(C);
  const Launch k1 =
      is_bf16 ? hidden_kernel<bf16>(th, C) : hidden_kernel<float>(th, C);
  const Launch k3 = is_bf16 ? wgrad_kernel<bf16>() : wgrad_kernel<float>();
  if (k1.fn == nullptr || k1.smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      k1.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(k1.smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k3.fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(k3.smem));
  out[0] = th;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, k1.fn,
                                                      k1.threads, k1.smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, k3.fn,
                                                      k3.threads, k3.smem);
  out[3] = static_cast<int>(k1.smem);
  out[4] = k1.nbuf;
  return e;
}

const char* dformer_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
