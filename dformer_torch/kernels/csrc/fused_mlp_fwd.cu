// Fused DFormer MLP block, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel dformer_tpu/kernels/fused_mlp.py::_kernel
// (pl.pallas_call in _forward_pallas). Computes, per NHWC pixel:
//
//   y   = LayerNorm(x)                      fp32 statistics, eps
//   h   = y @ fc1_w + fc1_b                 [., C] -> [., Ch], fp32 accumulate
//   h   = dwconv3x3(h, pos_w) + pos_b + h   zero padding OUTSIDE THE IMAGE in h
//   g   = gelu(h)                           bf16: the TPU kernel's clamped
//                                           polynomial erf; fp32: erff
//   out = g @ fc2_w + fc2_b                 [., Ch] -> [., C], fp32 accumulate
//
// Rounding points follow _kernel: y and g are rounded to the I/O type
// before their matmul; h stays fp32 throughout; the output is rounded once.
//
// What bounds it on this card. At DFormer-L stage 0 (bs8, 120x160, C 96 ->
// Ch 768) the block is ~47 GFLOP against ~59 MB of x in + out: ~48 us of
// bf16 tensor-core time at 989 TFLOP/s against ~18 us of HBM time at
// 3.35 TB/s, so the work is compute-bound once the ratio-8 hidden tensor is
// kept out of device memory, which is what the fusion is for. The bf16
// kernel runs both products on the tensor cores with mma.sync (m16n8k16,
// fp32 accumulate); wgmma, TMA and warp specialisation are later work. The
// fp32 kernel (for checking against the plain version at a tight
// tolerance) uses scalar FMAs.
//
// Design (bf16). The Pallas grid walks (B, H/Th) in order on one core with a
// double-buffered halo DMA; here every block is independent. A block of 512
// threads (16 warps: one block per SM holds 16 warps at every width) owns
// an output tile of TH x TW pixels of one image plus a 1-px halo (8 x 16
// up to C 192 where the map's width suits it, 8 x 8 up to C 288, 4 x 8
// above; the caller's plan picks the width):
//   0. LayerNorm: a launch of its own before the kernel (layernorm_rows)
//      writes y = LayerNorm(x) of every pixel in bf16 (fp32 statistics),
//      once per pixel rather than once per halo tile and hidden split; the
//      block copies y's halo tile into shared memory (cp.async, with the
//      first chunk's weights).
//   The hidden pipeline separates by hidden channel (dwconv and GELU act per
//   channel; fc2 sums over them), so the block then loops over CK-channel
//   hidden chunks (CK 64 up to C 288, 32 above):
//   1. fc1 for the chunk over the halo tile into shared memory (fp32, float2
//      stores); halo pixels outside the image are set to ZERO in h
//      (fc1(LN(0)) is not 0); each warp takes UM m-tiles x UN n-tiles;
//   2. the 3x3 depthwise taps + pos_b + residual h, then GELU, rounded to
//      bf16: a thread slides a 3-row window of fp32 h down a strip of R
//      output rows for two channels, so an output loads ~3 values of h per
//      channel, not 10;
//   3. the chunk's share of fc2 into fp32 register accumulators (warp w
//      owns m-tile w % MT2 and every WN-th n-tile of the output).
//   Three barriers per chunk; the next chunk's weights load by cp.async
//   behind the work of this one, and fc1 loads the fragments of its next
//   k-step while the products of this one run.
//   The output is written once. Shared memory is bounded by the halo tile's
//   LayerNorm output whatever Ch is, and the hidden tensor never reaches
//   device memory.
// Small maps (stages 3-4) would leave the card idle while few blocks walk
// all of Ch. There the caller's plan (kernels/fused_mlp.py::forward_plan)
// splits the hidden chunks over `nsplit` blocks per tile (grid z =
// B * nsplit): each writes its fp32 partial sum of fc2 to a scratch buffer,
// and a second pass adds the splits in a fixed order plus fc2_b, so the
// result is deterministic. Only step 0 is repeated per split.
//
// Weights come in torch Linear layout: fc1 [Ch, C], fc2 [C, Ch], so a
// chunk of either is contiguous rows; pos_w is [3, 3, Ch].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// Phase clocks, compiled in only with -DDFORMER_FWD_PHASES
// (kernels/fwd_phases.py): each warp adds the clock64 cycles it spends in
// each phase of the bf16 kernel, summed over all warps of a launch.
enum Phase { kPhStage, kPhFc1, kPhDw, kPhFc2, kPhWait, kPhOut, kPhases };
#ifdef DFORMER_FWD_PHASES
__device__ unsigned long long g_phase_clk[kPhases];
#define PHASE_BEGIN                            \
  long long ph_t = clock64();                  \
  long long ph_acc[kPhases] = {};
#define PHASE(k)                               \
  {                                            \
    const long long ph_now = clock64();        \
    ph_acc[k] += ph_now - ph_t;                \
    ph_t = ph_now;                             \
  }
#define PHASE_END                                                     \
  if (threadIdx.x % 32 == 0)                                          \
    for (int i = 0; i < kPhases; ++i)                                 \
      atomicAdd(&g_phase_clk[i], static_cast<unsigned long long>(ph_acc[i]));
#else
#define PHASE_BEGIN
#define PHASE(k)
#define PHASE_END
#endif

constexpr int kThreads = 256;  // fp32 kernel and the split reduction
constexpr int kWarps = kThreads / 32;
constexpr int kCK = 32;      // hidden channels per chunk, fp32 kernel
constexpr int kTW = 8;       // output tile width; the tile height is TH
constexpr int kMaxC = 576;   // DFormer-L stage 4
constexpr int kLDH = kCK + 1;  // fp32 hidden tile row stride (floats)
constexpr int kMmaThreads = 512;  // bf16 kernel
constexpr int kMmaWarps = kMmaThreads / 32;

// Fewer tile rows for wide C, to bound the fc2 accumulators per thread.
constexpr int tile_rows(int C) { return C <= 288 ? 8 : 4; }
// Hidden channels per chunk of the bf16 kernel: 64 while fc1's chunk of
// rows and fc2's of columns fit shared memory beside the tile.
constexpr int mma_chunk(int C) { return C <= 288 ? 64 : 32; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
}

// The TPU kernel's GELU, for the bf16 kernel (the fp32 kernel keeps erff):
// erf(x) ~= xc * P(xc^2) with xc = clamp(x, -kErfClamp, kErfClamp) and P the
// degree-6 polynomial of kErfCoef (lowest order first), as
// dformer_tpu/ops/activations.py::poly_erf. Its GELU is within 7.7e-4 of
// the exact one for every h, under bf16 rounding of g; a clamp, seven FMAs
// and a multiply in place of erff.
constexpr float kErfClamp = 2.5f;
__constant__ float kErfCoef[7] = {
    1.128327841545965f,     -0.3752161375254132f,   0.11017227865151494f,
    -0.02386296372461015f,  0.0035287012695947024f, -0.000310355563933048f,
    1.198749466543182e-05f};

__device__ __forceinline__ float gelu_poly(float h) {
  const float x = fminf(fmaxf(h * 0.7071067811865476f, -kErfClamp),
                        kErfClamp);
  const float t = x * x;
  float p = kErfCoef[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) p = fmaf(p, t, kErfCoef[i]);
  return 0.5f * h * (1.f + x * p);
}

// Whether halo pixel p of the tile at (row0, col0), TW output columns wide,
// lies in the image.
template <int TW>
__device__ __forceinline__ bool in_image(int p, int row0, int col0, int H,
                                         int W) {
  const int r = row0 - 1 + p / (TW + 2);
  const int c = col0 - 1 + p % (TW + 2);
  return r >= 0 && r < H && c >= 0 && c < W;
}

// ---------------------------------------------------------------- bf16 ---

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
__device__ __forceinline__ void zero16(void* smem) {
  *reinterpret_cast<uint4*>(smem) = uint4{0u, 0u, 0u, 0u};
}

// Fragments by 32-bit shared-memory loads (measured faster here than
// ldmatrix, PERF.md). Row strides of 4 (mod 8) words keep the eight rows g of
// a fragment on distinct banks.
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of the 16x16 tile at `p` of a row-major [m][k] tile (row
// stride ld).
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* p, int ld) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const __nv_bfloat16* r0 = p + g * ld + 2 * t;
  const __nv_bfloat16* r1 = r0 + 8 * ld;
  a[0] = ld32(r0);
  a[1] = ld32(r1);
  a[2] = ld32(r0 + 8);
  a[3] = ld32(r1 + 8);
}
// The B fragment (b0, b1) of one n-tile, k 0..15 from `p`, of an [n][k]
// tile (row stride ld): rows n0..n0+7.
__device__ __forceinline__ void load_b(uint32_t (&b)[2],
                                       const __nv_bfloat16* p, int n0,
                                       int ld) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const __nv_bfloat16* r = p + (n0 + g) * ld + 2 * t;
  b[0] = ld32(r);
  b[1] = ld32(r + 8);
}

// The tile of the bf16 kernel: TH x TW outputs, (TH+2) x (TW+2) halo
// pixels, CK-channel hidden chunks, 16 warps.
template <int TH, int TW, int CK>
struct Tile {
  static constexpr int NO = TH * TW;               // output pixels
  static constexpr int NP = (TH + 2) * (TW + 2);   // halo pixels
  static constexpr int NPP = (NP + 15) / 16 * 16;  // padded to m-tiles
  static constexpr int MT1 = NPP / 16;             // fc1 m-tiles
  static constexpr int CHUNK = CK;
  static constexpr int NT1 = CK / 8;               // fc1 n-tiles
  // fc1 unit: UM m-tiles x UN n-tiles, one per warp: 3 x 2 where that
  // makes 16 units, else 1 x 4 where that makes at least 14, else 1 x 1
  static constexpr bool k32 = MT1 % 3 == 0 && MT1 / 3 * (NT1 / 2) == 16;
  static constexpr int UM = k32 ? 3 : 1;
  static constexpr int UN = k32 ? 2 : MT1 * NT1 / 4 >= 14 ? 4 : 1;
  static constexpr int U1 = MT1 / UM * (NT1 / UN);  // fc1 units
  static constexpr int MT2 = NO / 16;              // fc2 m-tiles
  static constexpr int WN = kMmaWarps / MT2;       // warps per fc2 m-tile
  static constexpr int LDH = CK + 8;   // hs row stride (floats): float2
                                       // stores of fc1 conflict-free
  static constexpr int LDK = CK + 8;   // gs, w2s row stride (bf16)
  static constexpr int PAIRS = CK / 2;
  // step 2: a thread takes a channel pair and R rows of one column
  static constexpr int R = PAIRS * TW * TH / kMmaThreads;
  static_assert(U1 <= kMmaWarps && U1 * UM * UN == MT1 * NT1, "fc1 units");
  static_assert(R >= 1 && R * kMmaThreads == PAIRS * TW * TH, "strips");
};

// The chunk's vectors, staged beside its fc1 rows (two buffers, by chunk
// parity): fc1_b and pos_b in fp32, the nine taps of pos_w in bf16.
template <int CK>
struct ChunkVecs {
  float fc1_b[CK];
  float pos_b[CK];
  __nv_bfloat16 pos_w[9][CK];
};

template <int TH, int TW, int CK>
size_t mma_smem_bytes(int C) {
  using S = Tile<TH, TW, CK>;
  const size_t ldy = C + 8;
  return sizeof(float) * S::NP * S::LDH +             // hs
         2 * sizeof(ChunkVecs<CK>) +                  // vs
         (S::NPP + 15) / 16 * 16 +                    // valid
         2 * (static_cast<size_t>(S::NO) * S::LDK +   // gs
              static_cast<size_t>(C) * S::LDK +       // w2s
              CK * ldy +                              // w1s
              S::NPP * ldy);                          // ys
}

// Start copying chunk ch0's fc1 rows ([Ch, C] layout) into w1s [CK][ldy],
// its fc1_b, pos_b and pos_w into v; rows past Ch are zeroed (fc1 then
// gives 0 there, and fc2's zeroed columns drop them). One commit group.
template <int CK>
__device__ __forceinline__ void stage_fc1(
    __nv_bfloat16* w1s, ChunkVecs<CK>* v, const __nv_bfloat16* fc1_w,
    const float* fc1_b, const float* pos_b, const __nv_bfloat16* pos_w,
    int ch0, int C, int Ch, int ldy) {
  const int nvalid = min(CK, Ch - ch0);
  const int per_row = C / 8;
  for (int i = threadIdx.x; i < CK * per_row; i += kMmaThreads) {
    const int n = i / per_row, k = (i % per_row) * 8;
    if (n < nvalid)
      cp_async16(w1s + n * ldy + k,
                 fc1_w + static_cast<size_t>(ch0 + n) * C + k);
    else
      zero16(w1s + n * ldy + k);
  }
  // vectors: fc1_b, pos_b (CK / 4 pieces each), pos_w (9 * CK / 8)
  for (int i = threadIdx.x; i < CK / 2 + 9 * CK / 8; i += kMmaThreads) {
    float* dst;
    const void* src;
    int k;
    if (i < CK / 2) {
      const bool bias1 = i < CK / 4;
      k = (bias1 ? i : i - CK / 4) * 4;
      dst = (bias1 ? v->fc1_b : v->pos_b) + k;
      src = (bias1 ? fc1_b : pos_b) + ch0 + k;
    } else {
      const int j = i - CK / 2, tap = j / (CK / 8);
      k = (j % (CK / 8)) * 8;
      dst = reinterpret_cast<float*>(&v->pos_w[tap][k]);
      src = pos_w + static_cast<size_t>(tap) * Ch + ch0 + k;
    }
    if (k < nvalid)
      cp_async16(dst, src);
    else
      zero16(dst);
  }
  cp_async_commit();
}

// Start copying chunk ch0's columns of fc2 ([C, Ch] layout) into
// w2s [C][CK + 8]; columns past Ch are zeroed. One commit group.
template <int CK>
__device__ __forceinline__ void stage_fc2(__nv_bfloat16* w2s,
                                          const __nv_bfloat16* fc2_w, int ch0,
                                          int C, int Ch) {
  const int nvalid = min(CK, Ch - ch0);
  for (int i = threadIdx.x; i < C * (CK / 8); i += kMmaThreads) {
    const int n = i / (CK / 8), k = (i % (CK / 8)) * 8;
    if (k < nvalid)
      cp_async16(w2s + n * (CK + 8) + k,
                 fc2_w + static_cast<size_t>(n) * Ch + ch0 + k);
    else
      zero16(w2s + n * (CK + 8) + k);
  }
  cp_async_commit();
}

// Step 0, a launch of its own before the main kernel: y = LayerNorm(x) of
// every pixel (fp32 statistics, rounded to bf16), once per pixel rather
// than once per halo tile and hidden split. One warp per pixel, the pixel's
// x in registers (C <= 576: at most 9 pairs per lane).
__global__ void __launch_bounds__(kThreads)
layernorm_rows(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ ln_w, const float* __restrict__ ln_b,
               __nv_bfloat16* __restrict__ y, long long N, int C, float eps) {
  constexpr int kMaxPairs = (kMaxC / 2 + 31) / 32;
  const int lane = threadIdx.x % 32;
  const long long p = static_cast<long long>(blockIdx.x) * kWarps +
                      threadIdx.x / 32;
  if (p >= N) return;
  const int pairs = C / 2, npl = (pairs + 31) / 32;  // pairs per lane
  const __nv_bfloat162* xrow =
      reinterpret_cast<const __nv_bfloat162*>(x + p * C);
  __nv_bfloat162* yrow = reinterpret_cast<__nv_bfloat162*>(y + p * C);
  float2 xv[kMaxPairs];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    if (j == npl) break;
    const int i = lane + 32 * j;
    xv[j] = i < pairs ? __bfloat1622float2(xrow[i]) : make_float2(0.f, 0.f);
    s += xv[j].x + xv[j].y;
  }
  const float mean = warp_sum(s) / C;
  float var = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    if (j == npl) break;
    if (lane + 32 * j < pairs) {
      const float d0 = xv[j].x - mean, d1 = xv[j].y - mean;
      var += d0 * d0 + d1 * d1;
    }
  }
  const float rstd = rsqrtf(warp_sum(var) / C + eps);
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    if (j == npl) break;
    const int i = lane + 32 * j;
    if (i < pairs) {
      const float2 w = reinterpret_cast<const float2*>(ln_w)[i];
      const float2 bb = reinterpret_cast<const float2*>(ln_b)[i];
      yrow[i] = __floats2bfloat162_rn((xv[j].x - mean) * rstd * w.x + bb.x,
                                      (xv[j].y - mean) * rstd * w.y + bb.y);
    }
  }
}

// Start copying the halo tile of y into ys (rows 0..NP-1, stride ldy,
// bf16); rows of pixels outside the image, and rows NP..NPP-1, are zeroed.
// One commit group.
template <int NP, int NPP, int TW>
__device__ __forceinline__ void stage_y(const __nv_bfloat16* __restrict__ y,
                                        __nv_bfloat16* ys, int ldy, int b,
                                        int row0, int col0, int H, int W,
                                        int C) {
  const int per_row = C / 8;
  for (int i = threadIdx.x; i < NPP * per_row; i += kMmaThreads) {
    const int p = i / per_row, k = (i - p * per_row) * 8;
    const int r = row0 - 1 + p / (TW + 2), c = col0 - 1 + p % (TW + 2);
    if (p < NP && r >= 0 && r < H && c >= 0 && c < W)
      cp_async16(ys + p * ldy + k,
                 y + ((static_cast<size_t>(b) * H + r) * W + c) * C + k);
    else
      zero16(ys + p * ldy + k);
  }
  cp_async_commit();
}

// Step 2 for a strip: channels 2p, 2p + 1 of the chunk for R consecutive
// output rows from r0 in column c of the tile. A 3-row window of fp32 h
// (float2 per pixel) slides down the strip, so each output row loads 3
// values per channel from hs instead of 10; g goes to gs in bf16.
template <int TH, int TW, int CK>
__device__ __forceinline__ void dwconv_gelu_strip(const float* hs,
                                                  __nv_bfloat16* gs,
                                                  const ChunkVecs<CK>& v,
                                                  int p, int r0, int c) {
  using S = Tile<TH, TW, CK>;
  float2 pw[9];
#pragma unroll
  for (int i = 0; i < 9; ++i)
    pw[i] = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.pos_w[i][2 * p]));
  const float2 pb = *reinterpret_cast<const float2*>(&v.pos_b[2 * p]);
  const float* col = hs + (r0 * (TW + 2) + c) * S::LDH + 2 * p;
  float2 win[3][3];
#pragma unroll
  for (int dr = 0; dr < 2; ++dr)
#pragma unroll
    for (int dc = 0; dc < 3; ++dc)
      win[dr][dc] = *reinterpret_cast<const float2*>(
          col + (dr * (TW + 2) + dc) * S::LDH);
#pragma unroll
  for (int i = 0; i < S::R; ++i) {
#pragma unroll
    for (int dc = 0; dc < 3; ++dc)
      win[(i + 2) % 3][dc] = *reinterpret_cast<const float2*>(
          col + ((i + 2) * (TW + 2) + dc) * S::LDH);
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr)
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) {
        a0 = fmaf(win[(i + dr) % 3][dc].x, pw[dr * 3 + dc].x, a0);
        a1 = fmaf(win[(i + dr) % 3][dc].y, pw[dr * 3 + dc].y, a1);
      }
    const float2 ctr = win[(i + 1) % 3][1];
    *reinterpret_cast<__nv_bfloat162*>(gs + ((r0 + i) * TW + c) * S::LDK +
                                       2 * p) =
        __floats2bfloat162_rn(gelu_poly(a0 + pb.x + ctr.x),
                              gelu_poly(a1 + pb.y + ctr.y));
  }
}

// Step 1 for a chunk: fc1 over the halo tile into hs (fp32, stride LDH,
// float2 stores), + the chunk's fc1_b, ZERO at halo pixels outside the
// image. Warp u < U1 takes UM m-tiles x UN n-tiles.
template <class S>
__device__ __forceinline__ void fc1_chunk(const __nv_bfloat16* ys,
                                          const __nv_bfloat16* w1s, float* hs,
                                          const unsigned char* valid,
                                          const float* bias1, int ldy,
                                          int C) {
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4,
            t = threadIdx.x % 4;
  if (warp >= S::U1) return;
  const int mb = warp / (S::NT1 / S::UN) * S::UM;
  const int nb = (warp % (S::NT1 / S::UN)) * S::UN * 8;
  float d[S::UM][S::UN][4];
#pragma unroll
  for (int i = 0; i < S::UM; ++i)
#pragma unroll
    for (int j = 0; j < S::UN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][j][e] = 0.f;
  const __nv_bfloat16* arow = ys + mb * 16 * ldy;
  // fragments of step k0 + 16 load while the products of k0 run
  uint32_t a[2][S::UM][4], bb[2][S::UN][2];
  auto load = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < S::UM; ++i)
      load_a(a[buf][i], arow + i * 16 * ldy + k0, ldy);
#pragma unroll
    for (int j = 0; j < S::UN; ++j)
      load_b(bb[buf][j], w1s + k0, nb + j * 8, ldy);
  };
  auto mma = [&](int buf) {
#pragma unroll
    for (int j = 0; j < S::UN; ++j)
#pragma unroll
      for (int i = 0; i < S::UM; ++i)
        mma_bf16(d[i][j], a[buf][i], bb[buf][j][0], bb[buf][j][1]);
  };
  load(0, 0);
  for (int k0 = 0; k0 < C; k0 += 32) {
    const bool odd = k0 + 16 < C;
    if (odd) load(1, k0 + 16);
    mma(0);
    if (k0 + 32 < C) load(0, k0 + 32);
    if (odd) mma(1);
  }
#pragma unroll
  for (int i = 0; i < S::UM; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = (mb + i) * 16 + g + hf * 8;
      if (p >= S::NP) continue;
      const bool in = valid[p];
#pragma unroll
      for (int j = 0; j < S::UN; ++j) {
        const int n = nb + j * 8 + 2 * t;
        const float2 bias = *reinterpret_cast<const float2*>(bias1 + n);
        *reinterpret_cast<float2*>(hs + p * S::LDH + n) =
            in ? make_float2(d[i][j][2 * hf] + bias.x,
                             d[i][j][2 * hf + 1] + bias.y)
               : make_float2(0.f, 0.f);
      }
    }
}

// Step 3 for a chunk: its share of fc2, g (gs, stride LDK) x the chunk's
// columns of fc2 (w2s), into the warp's accumulators: m-tile mt2, n-tiles
// nt0 + WN * j.
template <class S, int NTW>
__device__ __forceinline__ void fc2_chunk(float (&acc)[NTW][4],
                                          const __nv_bfloat16* gs,
                                          const __nv_bfloat16* w2s, int mt2,
                                          int nt0, int nt_total) {
  // straight-line code the compiler can schedule: n-tiles past C read the
  // last one again, into accumulators the output never reads
#pragma unroll
  for (int k0 = 0; k0 < S::CHUNK; k0 += 16) {
    uint32_t a[4];
    load_a(a, gs + mt2 * 16 * S::LDK + k0, S::LDK);
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int nt = min(nt0 + S::WN * j, nt_total - 1);
      uint32_t bb[2];
      load_b(bb, w2s + k0, nt * 8, S::LDK);
      mma_bf16(acc[j], a, bb[0], bb[1]);
    }
  }
}

template <int TH, int TW, int CK, int NTW>
__global__ void __launch_bounds__(kMmaThreads, 1)
fused_mlp_fwd_mma(const __nv_bfloat16* __restrict__ y,  // LayerNorm(x)
                  const __nv_bfloat16* __restrict__ fc1_w,  // [Ch, C]
                  const float* __restrict__ fc1_b,
                  const __nv_bfloat16* __restrict__ pos_w,  // [9, Ch]
                  const float* __restrict__ pos_b,
                  const __nv_bfloat16* __restrict__ fc2_w,  // [C, Ch]
                  const float* __restrict__ fc2_b,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
                  int B, int H, int W, int C, int Ch, int nsplit, int cps) {
  using S = Tile<TH, TW, CK>;
  const int ldy = C + 8;  // +8: conflict-free ldmatrix rows
  extern __shared__ float4 smem_raw[];
  float* hs = reinterpret_cast<float*>(smem_raw);               // [NP][LDH]
  ChunkVecs<CK>* vs =
      reinterpret_cast<ChunkVecs<CK>*>(hs + S::NP * S::LDH);     // [2]
  unsigned char* valid = reinterpret_cast<unsigned char*>(vs + 2);  // [NPP]
  __nv_bfloat16* gs =                                       // [NO][LDK]
      reinterpret_cast<__nv_bfloat16*>(valid + (S::NPP + 15) / 16 * 16);
  __nv_bfloat16* w2s = gs + S::NO * S::LDK;                      // [C][LDK]
  __nv_bfloat16* w1s = w2s + static_cast<size_t>(C) * S::LDK;   // [CK][ldy]
  __nv_bfloat16* ys = w1s + static_cast<size_t>(CK) * ldy;      // [NPP][ldy]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
  const int ch_begin = split * cps * CK;
  const int ch_end = min(Ch, ch_begin + cps * CK);
  const int row0 = blockIdx.y * TH, col0 = blockIdx.x * TW;
  const int nt_total = C / 8;

  PHASE_BEGIN
  // y's halo tile and the first chunk's weights, all in flight at once
  stage_y<S::NP, S::NPP, TW>(y, ys, ldy, b, row0, col0, H, W, C);
  stage_fc1<CK>(w1s, vs, fc1_w, fc1_b, pos_b, pos_w, ch_begin, C, Ch, ldy);
  for (int p = tid; p < S::NP; p += kMmaThreads)
    valid[p] = in_image<TW>(p, row0, col0, H, W);
  PHASE(kPhStage)

  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int mt2 = warp % S::MT2;
  const int nt0 = warp / S::MT2;
  // step 2's strip
  const int dw_pair = tid % S::PAIRS, dw_pos = tid / S::PAIRS;
  const int dw_r0 = (dw_pos / TW) * S::R, dw_c = dw_pos % TW;

  // Three barriers per chunk. Copy groups in flight, oldest first: fc1
  // rows + vectors (chunk), fc2 columns (chunk). The next chunk's fc1 rows
  // and vectors go out after barrier 2 (w1s free) and land by its barrier
  // 1; its fc2 columns after its barrier 1 (w2s free) and land by its
  // barrier 3.
  const int nchunks = (ch_end - ch_begin + CK - 1) / CK;
  stage_fc2<CK>(w2s, fc2_w, ch_begin, C, Ch);
  for (int it = 0; it < nchunks; ++it) {
    const int ch0 = ch_begin + it * CK;
    const bool has_next = it + 1 < nchunks;
    if (it == 0)
      cp_async_wait<1>();  // ys, fc1 rows and vectors; fc2 may fly on
    else
      cp_async_wait<0>();  // fc1 rows and vectors, the only group in flight
    __syncthreads();  // barrier 1: w1s, vectors and ys visible; w2s, gs free
    PHASE(kPhWait)
    if (it > 0) stage_fc2<CK>(w2s, fc2_w, ch0, C, Ch);
    fc1_chunk<S>(ys, w1s, hs, valid, vs[it % 2].fc1_b, ldy, C);
    PHASE(kPhFc1)
    __syncthreads();  // barrier 2: hs complete, w1s free
    PHASE(kPhWait)
    if (has_next)
      stage_fc1<CK>(w1s, &vs[(it + 1) % 2], fc1_w, fc1_b, pos_b, pos_w,
                    ch0 + CK, C, Ch, ldy);
    dwconv_gelu_strip<TH, TW, CK>(hs, gs, vs[it % 2], dw_pair, dw_r0, dw_c);
    PHASE(kPhDw)
    if (has_next)
      cp_async_wait<1>();  // fc2 columns; the next fc1 rows may fly on
    else
      cp_async_wait<0>();
    __syncthreads();  // barrier 3: gs complete, w2s landed
    PHASE(kPhWait)
    fc2_chunk<S, NTW>(acc, gs, w2s, mt2, nt0, nt_total);
    PHASE(kPhFc2)
  }

#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int nt = nt0 + S::WN * j;
    if (nt >= nt_total) continue;
    const int n = nt * 8 + 2 * t;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int q = mt2 * 16 + g + hf * 8;
      const int r = row0 + q / TW, c = col0 + q % TW;
      if (r >= H || c >= W) continue;
      const size_t pix = (static_cast<size_t>(b) * H + r) * W + c;
      const float v0 = acc[j][2 * hf], v1 = acc[j][2 * hf + 1];
      if (partial != nullptr) {
        *reinterpret_cast<float2*>(
            partial + (static_cast<size_t>(split) * B * H * W + pix) * C + n) =
            make_float2(v0, v1);
      } else {
        const float2 bias = *reinterpret_cast<const float2*>(fc2_b + n);
        *reinterpret_cast<__nv_bfloat162*>(out + pix * C + n) =
            __floats2bfloat162_rn(v0 + bias.x, v1 + bias.y);
      }
    }
  }
  PHASE(kPhOut)
  PHASE_END
}

// ---------------------------------------------------------------- fp32 ---
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

// Step 0 of the fp32 kernel: LayerNorm of every halo pixel (rows 0..NP-1 of
// ys, stride ldy); pixels outside the image get zeros (their h is masked in
// step 1 anyway).
__device__ __forceinline__ void layernorm_tile(
    const float* __restrict__ x, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, float* ys, int ldy, int np, int b,
    int row0, int col0, int H, int W, int C, float eps) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int p = warp; p < np; p += kWarps) {
    const int r = row0 - 1 + p / (kTW + 2);
    const int c = col0 - 1 + p % (kTW + 2);
    float* yrow = ys + static_cast<size_t>(p) * ldy;
    if (r < 0 || r >= H || c < 0 || c >= W) {
      for (int i = lane; i < C; i += 32) yrow[i] = 0.f;
      continue;
    }
    const float* xrow = x + ((static_cast<size_t>(b) * H + r) * W + c) * C;
    float s = 0.f;
    for (int i = lane; i < C; i += 32) s += xrow[i];
    const float mean = warp_sum(s) / C;
    float v = 0.f;
    for (int i = lane; i < C; i += 32) {
      const float d = xrow[i] - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + eps);
    for (int i = lane; i < C; i += 32)
      yrow[i] = (xrow[i] - mean) * rstd * ln_w[i] + ln_b[i];
  }
}

// Step 2 of the fp32 kernel for one output pixel q of the tile and hidden
// channel ch0 + lane: depthwise 3x3 over the fp32 hidden tile hs, + pos_b +
// residual, exact GELU.
__device__ __forceinline__ float dwconv_gelu(const float* hs, int q,
                                             const float (&pw)[9], float pb) {
  const int lane = threadIdx.x % 32;
  const int qr = q / kTW, qc = q % kTW;
  float a = 0.f;
#pragma unroll
  for (int dr = 0; dr < 3; ++dr)
#pragma unroll
    for (int dc = 0; dc < 3; ++dc)
      a = fmaf(hs[((qr + dr) * (kTW + 2) + qc + dc) * kLDH + lane],
               pw[dr * 3 + dc], a);
  return gelu_erf(a + pb + hs[((qr + 1) * (kTW + 2) + qc + 1) * kLDH + lane]);
}

// Scalar-FMA path, for checking against the plain version at a tight
// tolerance: 256 threads, 32-channel chunks, one hidden channel per lane in
// steps 1-2 (erff GELU); in step 3 warp w owns output column w of every
// tile row and lane the output channels lane + 32 * j.

template <int TH>
struct ScalarShape {
  static constexpr int NO = TH * kTW;
  static constexpr int NP = (TH + 2) * (kTW + 2);
  static constexpr int PP = (NP + kWarps - 1) / kWarps;  // halo px per warp
};

template <int TH>
size_t scalar_smem_bytes(int C) {
  using S = ScalarShape<TH>;
  return sizeof(float) * (S::NP * kLDH + S::NO * kLDH +
                          static_cast<size_t>(S::NP) * C);
}

template <int TH, int NC>
__global__ void __launch_bounds__(kThreads)
fused_mlp_fwd_fp32(const float* __restrict__ x, const float* __restrict__ ln_w,
                   const float* __restrict__ ln_b,
                   const float* __restrict__ fc1_w,  // [Ch, C]
                   const float* __restrict__ fc1_b,
                   const float* __restrict__ pos_w,  // [9, Ch]
                   const float* __restrict__ pos_b,
                   const float* __restrict__ fc2_w,  // [C, Ch]
                   const float* __restrict__ fc2_b, float* __restrict__ out,
                   float* __restrict__ partial, int B, int H, int W, int C,
                   int Ch, float eps, int nsplit, int cps) {
  using S = ScalarShape<TH>;
  constexpr int NP = S::NP, NO = S::NO, PP = S::PP;
  extern __shared__ float4 smem_raw[];
  float* hs = reinterpret_cast<float*>(smem_raw);  // [NP][kLDH]
  float* gs = hs + NP * kLDH;                      // [NO][kLDH]
  float* ys = gs + NO * kLDH;                      // [NP][C]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
  const int ch_begin = split * cps * kCK;
  const int ch_end = min(Ch, ch_begin + cps * kCK);
  const int row0 = blockIdx.y * TH, col0 = blockIdx.x * kTW;

  layernorm_tile(x, ln_w, ln_b, ys, C, NP, b, row0, col0, H, W, C, eps);

  float acc[TH][NC];
#pragma unroll
  for (int i = 0; i < TH; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  for (int ch0 = ch_begin; ch0 < ch_end; ch0 += kCK) {
    __syncthreads();  // ys written / last chunk's gs readers done
    const int k = ch0 + lane;
    // 1. fc1 for hidden channel k over the halo tile
    float h[PP];
#pragma unroll
    for (int i = 0; i < PP; ++i) h[i] = 0.f;
    const float* wrow = fc1_w + static_cast<size_t>(k) * C;
    for (int c = 0; c < C; c += 4) {
      const float4 w = *reinterpret_cast<const float4*>(wrow + c);
#pragma unroll
      for (int i = 0; i < PP; ++i) {
        const int p = warp + i * kWarps;
        if (p < NP) {
          const float4 y = *reinterpret_cast<const float4*>(ys + p * C + c);
          h[i] = fmaf(y.w, w.w, fmaf(y.z, w.z,
                 fmaf(y.y, w.y, fmaf(y.x, w.x, h[i]))));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PP; ++i) {
      const int p = warp + i * kWarps;
      if (p < NP)
        hs[p * kLDH + lane] =
            in_image<kTW>(p, row0, col0, H, W) ? h[i] + fc1_b[k] : 0.f;
    }
    __syncthreads();

    // 2. depthwise 3x3 + pos_b + residual, GELU
    float pw[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) pw[i] = pos_w[static_cast<size_t>(i) * Ch + k];
#pragma unroll
    for (int j = 0; j < NO / kWarps; ++j) {
      const int q = warp + j * kWarps;
      gs[q * kLDH + lane] = dwconv_gelu(hs, q, pw, pos_b[k]);
    }
    __syncthreads();

    // 3. fc2 share of this chunk
    for (int kk = 0; kk < kCK; ++kk) {
      float wv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        wv[j] = c < C ? fc2_w[static_cast<size_t>(c) * Ch + ch0 + kk] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TH; ++i) {
        const float gv = gs[(i * kTW + warp) * kLDH + kk];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(gv, wv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TH; ++i) {
    const int r = row0 + i, c = col0 + warp;
    if (r >= H || c >= W) continue;
    const size_t pix = (static_cast<size_t>(b) * H + r) * W + c;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int oc = lane + 32 * j;
      if (oc >= C) continue;
      if (partial != nullptr)
        partial[(static_cast<size_t>(split) * B * H * W + pix) * C + oc] =
            acc[i][j];
      else
        out[pix * C + oc] = acc[i][j] + fc2_b[oc];
    }
  }
}

// ------------------------------------------------------------- splits ---

// out = sum over splits (in order) of partial + fc2_b, rounded to T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_splits_kernel(const float* __restrict__ partial,
                     const float* __restrict__ fc2_b, T* __restrict__ out,
                     size_t n, int C, int nsplit) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * kThreads) {
    float s = 0.f;
    for (int k = 0; k < nsplit; ++k) s += partial[k * n + i];
    out[i] = from_f<T>(s + fc2_b[i % C]);
  }
}

// One kernel instantiation and how it launches.
struct Launch {
  const void* fn;
  size_t smem;
  int th;
  int tw;
  int chunk;
  int threads;
};

// The widest output tile this file has at width C in the I/O type: 16
// columns for the bf16 kernel up to C 192 (its shared memory allows it), 8
// otherwise.
int max_tile_cols(int C, int is_bf16) { return is_bf16 && C <= 192 ? 16 : 8; }

// The kernel this file runs at width C in the I/O type with tiles tw
// columns wide (fn null if none).
Launch pick(int C, int is_bf16, int tw) {
  const int th = tile_rows(C);
  if (tw != 8 && tw != max_tile_cols(C, is_bf16))
    return {nullptr, 0, th, tw, 0, 0};
  if (is_bf16) {
    // n-tiles (8 channels) of fc2 per warp: C/8 over the warps per m-tile
    const int wn = kMmaWarps / (th * tw / 16);
    const int ntw = (C / 8 + wn - 1) / wn;
#define DFORMER_MMA_CASE(TH, TW, CK, N)                                      \
  if (th == TH && tw == TW && mma_chunk(C) == CK && ntw == N)                \
    return {reinterpret_cast<const void*>(fused_mlp_fwd_mma<TH, TW, CK, N>), \
            mma_smem_bytes<TH, TW, CK>(C), TH, TW, CK, kMmaThreads};
    DFORMER_MMA_CASE(8, 16, 64, 1) DFORMER_MMA_CASE(8, 16, 64, 2)
    DFORMER_MMA_CASE(8, 16, 64, 3) DFORMER_MMA_CASE(8, 16, 64, 4)
    DFORMER_MMA_CASE(8, 16, 64, 5) DFORMER_MMA_CASE(8, 16, 64, 6)
    DFORMER_MMA_CASE(8, 16, 64, 7) DFORMER_MMA_CASE(8, 16, 64, 8)
    DFORMER_MMA_CASE(8, 16, 64, 9) DFORMER_MMA_CASE(8, 16, 64, 10)
    DFORMER_MMA_CASE(8, 16, 64, 11) DFORMER_MMA_CASE(8, 16, 64, 12)
    DFORMER_MMA_CASE(8, 8, 64, 1) DFORMER_MMA_CASE(8, 8, 64, 2)
    DFORMER_MMA_CASE(8, 8, 64, 3) DFORMER_MMA_CASE(8, 8, 64, 4)
    DFORMER_MMA_CASE(8, 8, 64, 5) DFORMER_MMA_CASE(8, 8, 64, 6)
    DFORMER_MMA_CASE(8, 8, 64, 7) DFORMER_MMA_CASE(8, 8, 64, 8)
    DFORMER_MMA_CASE(8, 8, 64, 9) DFORMER_MMA_CASE(4, 8, 32, 5)
    DFORMER_MMA_CASE(4, 8, 32, 6) DFORMER_MMA_CASE(4, 8, 32, 7)
    DFORMER_MMA_CASE(4, 8, 32, 8) DFORMER_MMA_CASE(4, 8, 32, 9)
#undef DFORMER_MMA_CASE
    return {nullptr, 0, th, tw, mma_chunk(C), kMmaThreads};
  }
  const int nc = (C + 31) / 32;  // output channels per lane
#define DFORMER_FP32_CASE(TH, N)                                         \
  if (th == TH && nc == N)                                               \
    return {reinterpret_cast<const void*>(fused_mlp_fwd_fp32<TH, N>),    \
            scalar_smem_bytes<TH>(C), TH, kTW, kCK, kThreads};
  DFORMER_FP32_CASE(8, 1) DFORMER_FP32_CASE(8, 2) DFORMER_FP32_CASE(8, 3)
  DFORMER_FP32_CASE(8, 4) DFORMER_FP32_CASE(8, 5) DFORMER_FP32_CASE(8, 6)
  DFORMER_FP32_CASE(8, 7) DFORMER_FP32_CASE(8, 8) DFORMER_FP32_CASE(8, 9)
  DFORMER_FP32_CASE(4, 10) DFORMER_FP32_CASE(4, 11) DFORMER_FP32_CASE(4, 12)
  DFORMER_FP32_CASE(4, 13) DFORMER_FP32_CASE(4, 14) DFORMER_FP32_CASE(4, 15)
  DFORMER_FP32_CASE(4, 16) DFORMER_FP32_CASE(4, 17) DFORMER_FP32_CASE(4, 18)
#undef DFORMER_FP32_CASE
  return {nullptr, 0, th, kTW, kCK, kThreads};
}

}  // namespace

extern "C" {

// Launches the forward on `stream` and returns cudaGetLastError() (0 = ok).
// Device pointers to contiguous tensors: x/out [B,H,W,C], fc1_w [Ch,C],
// pos_w [3,3,Ch], fc2_w [C,Ch] in the I/O type (bf16 when is_bf16, else
// fp32); ln_w/ln_b/fc2_b [C], fc1_b/pos_b [Ch] in fp32. The plan (tile rows
// th and columns tw, chunks per split cps, nsplit) comes from the caller
// (kernels/fused_mlp.py::forward_plan): th must be the one
// dformer_fused_mlp_fwd_occupancy reports for tw, tw 8 or the widest it
// reports, and the splits must cover the ceil(Ch / chunk) hidden chunks
// exactly. With nsplit above 1, partial is an fp32 scratch of
// nsplit * B * H * W * C floats (else it may be null); for bf16, y is a
// bf16 scratch of B * H * W * C for LayerNorm(x) (layernorm_rows, launched
// first; fp32 ignores it). Requires Ch % 32 == 0, C <= 576, and
// C % 16 == 0 (bf16) or C % 4 == 0 (fp32); cudaErrorInvalidValue
// otherwise.
int dformer_fused_mlp_fwd(const void* x, const float* ln_w, const float* ln_b,
                          const void* fc1_w, const float* fc1_b,
                          const void* pos_w, const float* pos_b,
                          const void* fc2_w, const float* fc2_b, void* out,
                          float* partial, void* y, int B, int H, int W, int C,
                          int Ch, float eps, int th, int tw, int cps,
                          int nsplit, int is_bf16, void* stream) {
  if (C <= 0 || C > kMaxC || C % (is_bf16 ? 16 : 4) != 0 || Ch <= 0 ||
      Ch % 32 != 0 || B <= 0 || H <= 0 || W <= 0)
    return cudaErrorInvalidValue;
  const Launch k = pick(C, is_bf16, tw);
  const int nchunks = (Ch + k.chunk - 1) / k.chunk;
  if (k.fn == nullptr || th != k.th || cps <= 0 ||
      nsplit != (nchunks + cps - 1) / cps || B * nsplit > 65535 ||
      (nsplit > 1 && partial == nullptr) || (is_bf16 && y == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(k.smem));
  if (e != cudaSuccess) return e;
  float* part = nsplit > 1 ? partial : nullptr;
  const dim3 grid((W + k.tw - 1) / k.tw, (H + k.th - 1) / k.th, B * nsplit);
  if (is_bf16) {
    const long long N = static_cast<long long>(B) * H * W;
    const unsigned ln_blocks = static_cast<unsigned>((N + kWarps - 1) / kWarps);
    layernorm_rows<<<ln_blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), ln_w, ln_b,
        static_cast<__nv_bfloat16*>(y), N, C, eps);
    const void* yc = y;
    void* args[] = {&yc,    &fc1_w, &fc1_b, &pos_w, &pos_b, &fc2_w, &fc2_b,
                    &out,   &part,  &B,     &H,     &W,     &C,     &Ch,
                    &nsplit, &cps};
    e = cudaLaunchKernel(k.fn, grid, dim3(k.threads), args, k.smem, s);
  } else {
    void* args[] = {&x,     &ln_w,  &ln_b, &fc1_w, &fc1_b, &pos_w, &pos_b,
                    &fc2_w, &fc2_b, &out,  &part,  &B,     &H,     &W,
                    &C,     &Ch,    &eps,  &nsplit, &cps};
    e = cudaLaunchKernel(k.fn, grid, dim3(k.threads), args, k.smem, s);
  }
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  const size_t n = static_cast<size_t>(B) * H * W * C;
  const size_t blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid2 = blocks < 4096 ? blocks : 4096;
  if (is_bf16)
    reduce_splits_kernel<<<grid2, kThreads, 0, s>>>(
        partial, fc2_b, static_cast<__nv_bfloat16*>(out), n, C, nsplit);
  else
    reduce_splits_kernel<<<grid2, kThreads, 0, s>>>(
        partial, fc2_b, static_cast<float*>(out), n, C, nsplit);
  return cudaGetLastError();
}

// What the card reports for the kernel this file runs at width C in the
// I/O type with tiles tw columns wide (0: the widest it has at C), into
// out[0..7]: tile rows and columns, hidden channels per chunk, threads per
// block, dynamic shared memory in bytes, resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers per thread
// and local (spill) bytes per thread (cudaFuncGetAttributes; the same
// numbers as the ptxas -v report beside the built library). The caller's
// plan takes the tile, the chunk and the blocks per SM from here.
int dformer_fused_mlp_fwd_occupancy(int C, int is_bf16, int tw, int* out) {
  if (C <= 0 || C > kMaxC) return cudaErrorInvalidValue;
  const Launch k = pick(C, is_bf16, tw == 0 ? max_tile_cols(C, is_bf16) : tw);
  if (k.fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(k.smem));
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, k.fn);
  out[0] = k.th;
  out[1] = k.tw;
  out[2] = k.chunk;
  out[3] = k.threads;
  out[4] = static_cast<int>(k.smem);
  out[5] = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 5, k.fn,
                                                      k.threads, k.smem);
  out[6] = attr.numRegs;
  out[7] = static_cast<int>(attr.localSizeBytes);
  return e;
}

#ifdef DFORMER_FWD_PHASES
// The phase clocks summed since the last call (Phase order), then zeroed.
int dformer_fused_mlp_fwd_phases(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, g_phase_clk, sizeof(g_phase_clk));
  unsigned long long zero[kPhases] = {};
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_phase_clk, zero, sizeof(zero));
  return e;
}
#endif

const char* dformer_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
