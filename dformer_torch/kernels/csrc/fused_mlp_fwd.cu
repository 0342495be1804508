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
// fp32 accumulate); wgmma, TMA and warp specialisation are later work.
//
// The fp32 kernel (fp32 evaluation, and the check against the plain version
// at a tight tolerance) runs in full fp32 on the FMA units: no TF32, no
// tensor cores, erff. At DFormer-L stage 0 (bs8) its ~47 GFLOP take ~0.70 ms
// at 67 TFLOP/s against ~35 us for ~118 MB of x in + out, so it is bound by
// the FMA rate: what it has to keep out of its product loops is every other
// instruction, above all loads from device memory (a warp load of fc2
// weights from device memory at a stride of Ch touches 32 sectors, and a
// loop of such loads runs at a few percent of the FMA rate) and
// shared-memory loads that feed few FMAs. So:
//   0. a launch of its own (layernorm_rows_fp32) writes y = LayerNorm(x) in
//      fp32, so that no halo tile of y has to sit in shared memory whole and
//      the tile size is free of C;
//   1. one block per SM walks its hidden chunks as one sequence of steps,
//      each a slice of y's halo tile with the chunk's fc1 rows (KS1 = 32
//      channels of C), or a slice of the chunk's fc2 columns, copied by
//      cp.async two steps ahead into a ring of three shared buffers; one
//      barrier a step;
//   2. both products are register-blocked outer products from shared
//      memory: fc1 a thread tile of MP halo pixels x NH hidden channels,
//      fc2 one of P2 output pixels x Q2 output channels (accumulated in
//      registers over all chunks); per float4 of k, MP + NH (P2 + Q2) float4
//      loads feed 4 MP NH (4 P2 Q2) FMAs, and a warp's loads are broadcasts
//      over 8 x 4 (4 x 8) thread groups from rows on distinct banks;
//   3. between them the depthwise taps, pos_b, the residual and erff on the
//      fp32 h in shared memory, as the plain version orders them.
//   Tiles: 8 x 16 with 64-channel chunks up to C 144, 16 warps, 6 x 4 and
//   4 x Q2 thread tiles; 8 x 8 (also below C 144 where the map's width
//   suits it) with 64-channel chunks up to C 288, and 4 x 8 with
//   128-channel chunks above, 8 warps, 4 x 8 and 8 x Q2 thread tiles, up to
//   72 accumulators a thread. So fc1 fills its warps, fc2's accumulators
//   fit the registers, and shared memory holds 127-189 KB: one block per
//   SM. What bounds it then (PERF.md): the product loops run FMAs at
//   ~45-60% of the rate, starting the copies takes 11-16% of the warps'
//   cycles and the taps with erff 4-12%; small maps split the hidden
//   chunks over blocks (below) and lose to the card's wave of 132 blocks.
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

constexpr int kThreads = 256;  // LayerNorm rows and the split reduction
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 576;   // DFormer-L stage 4
constexpr int kMmaThreads = 512;  // bf16 kernel
constexpr int kMmaWarps = kMmaThreads / 32;

// Fewer tile rows for wide C, to bound the fc2 accumulators per thread
// (bf16 kernel).
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

// Step 0 of the fp32 kernel, a launch of its own: y = LayerNorm(x) of every
// pixel in fp32, once per pixel. One warp per pixel, the pixel's x in
// registers as float4 (C <= 576: at most 5 per lane).
__global__ void __launch_bounds__(kThreads)
layernorm_rows_fp32(const float* __restrict__ x,
                    const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b, float* __restrict__ y,
                    long long N, int C, float eps) {
  constexpr int kMaxQuads = (kMaxC / 4 + 31) / 32;
  const int lane = threadIdx.x % 32;
  const long long p = static_cast<long long>(blockIdx.x) * kWarps +
                      threadIdx.x / 32;
  if (p >= N) return;
  const int quads = C / 4;
  const float4* xrow = reinterpret_cast<const float4*>(x + p * C);
  float4* yrow = reinterpret_cast<float4*>(y + p * C);
  float4 xv[kMaxQuads];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxQuads; ++j) {
    const int i = lane + 32 * j;
    xv[j] = i < quads ? xrow[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    s += (xv[j].x + xv[j].y) + (xv[j].z + xv[j].w);
  }
  const float mean = warp_sum(s) / C;
  float var = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxQuads; ++j) {
    if (lane + 32 * j < quads) {
      const float d0 = xv[j].x - mean, d1 = xv[j].y - mean;
      const float d2 = xv[j].z - mean, d3 = xv[j].w - mean;
      var += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    }
  }
  const float rstd = rsqrtf(warp_sum(var) / C + eps);
#pragma unroll
  for (int j = 0; j < kMaxQuads; ++j) {
    const int i = lane + 32 * j;
    if (i < quads) {
      const int c = 4 * i;
      yrow[i] = make_float4((xv[j].x - mean) * rstd * ln_w[c] + ln_b[c],
                            (xv[j].y - mean) * rstd * ln_w[c + 1] + ln_b[c + 1],
                            (xv[j].z - mean) * rstd * ln_w[c + 2] + ln_b[c + 2],
                            (xv[j].w - mean) * rstd * ln_w[c + 3] + ln_b[c + 3]);
    }
  }
}

constexpr int kF32Stages = 3;     // copy stages in flight

// The tile of the fp32 kernel: TH x TW outputs, (TH+2) x (TW+2) halo
// pixels, CK-channel hidden chunks. fc1 thread tiles are MP halo pixels x NH
// hidden channels, a warp 8 pixel groups x 4 channel groups; fc2 thread
// tiles P2 output pixels x Q2 output channels, a warp 4 x 8 groups. A
// thread's pixels and channels are strided by the group counts, so the
// eight (four) rows a warp reads with one float4 load sit on distinct banks
// (row strides of 4 mod 32 floats).
template <int TH, int TW, int CK_, int MP_, int Q2_>
struct F32Tile {
  static constexpr int CK = CK_, MP = MP_, Q2 = Q2_;
  // one block per SM: 16 warps with MP x 4 (fc1) and 4 x Q2 (fc2) thread
  // tiles at the 16-wide tile, else 8 warps with MP x 8 and 8 x Q2 (on the
  // card 8 warps ran C 192-576 faster than 16, and C 48-144 slower)
  static constexpr int THREADS = TW == 16 ? 512 : 256, WARPS = THREADS / 32;
  static constexpr int NO = TH * TW;               // output pixels
  static constexpr int NP = (TH + 2) * (TW + 2);   // halo pixels
  static constexpr int KS1 = 32;                   // C per fc1 step
  static constexpr int LDA = KS1 + 4;              // fc1 stage row stride
  static constexpr int NPG1 = (NP + MP - 1) / MP;  // fc1 pixel groups
  static constexpr int NPP = NPG1 * MP;            // y rows of an fc1 stage
  static constexpr int NH = THREADS == 512 ? 4 : 8;  // fc1 channels/thread
  static constexpr int NCG1 = CK / NH;             // fc1 channel groups
  static constexpr int WC1 = NCG1 / 4;             // fc1 warps across CK
  static constexpr int P2 = THREADS == 512 ? 4 : 8;  // fc2 pixels/thread
  static constexpr int NPG2 = NO / P2;             // fc2 pixel groups
  static constexpr int NCG2 = THREADS / NPG2;      // fc2 channel groups
  static constexpr int WC2 = NCG2 / 8;             // fc2 warps across C
  static constexpr int CP = NCG2 * Q2;             // output channels covered
  // hidden channels per fc2 step: its fc2_w slice, [CP][KS2 + 4], near the
  // size of an fc1 stage
  static constexpr int KS2 = CP <= 96 ? 64 : CP <= 288 ? 32 : 16;
  static constexpr int LDB = KS2 + 4;
  static constexpr int FC1_FLOATS = (NPP + CK) * LDA;
  static constexpr int STAGE =
      FC1_FLOATS > CP * LDB ? FC1_FLOATS : CP * LDB;  // floats
  static constexpr int LDH = CK + 4;               // hs, gs row stride
  static constexpr int CPT = TW * CK / THREADS;    // dwconv columns/thread
  static_assert((NPG1 + 7) / 8 * WC1 == WARPS, "fc1 warps");
  static_assert(NPG2 / 4 * WC2 == WARPS && NPG2 % 4 == 0, "fc2 warps");
  static_assert(CPT >= 1 && CPT * THREADS == TW * CK, "dwconv strips");
  static_assert(CK % KS2 == 0 && STAGE % 4 == 0, "steps");
};

// Copy steps of one hidden chunk at width C: its fc1 steps, then its fc2
// steps.
template <class S>
int f32_chunk_steps(int C) {
  return (C + S::KS1 - 1) / S::KS1 + S::CK / S::KS2;
}

template <class S>
size_t f32_smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kF32Stages) * S::STAGE + (S::NP + S::NO) * S::LDH);
}

// An fc1 step's copies are rows of KS1 floats: y's halo tile (rows
// 0..NP-1) and the chunk's fc1 rows (rows NPP..NPP+CK-1 of the stage), stride
// LDA, 16 bytes a copy. Thread tid always copies float4 group tid % G of rows
// tid / G + (THREADS / G) * m; F32Copies holds those rows' pixels of y.
template <class S>
struct F32Copies {
  static constexpr int G = S::KS1 / 4;
  static constexpr int RSTEP = S::THREADS / G;
  static constexpr int M = ((S::NP + S::CK) * G + S::THREADS - 1) / S::THREADS;
  int pix[M];  // the row's pixel of y, -1 outside the image or past NP

  template <int TW>
  static __device__ __forceinline__ F32Copies make(int b, int row0, int col0,
                                                   int H, int W) {
    F32Copies out;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int row = threadIdx.x / G + RSTEP * m;
      const int r = row0 - 1 + row / (TW + 2), c = col0 - 1 + row % (TW + 2);
      out.pix[m] = row < S::NP && r >= 0 && r < H && c >= 0 && c < W
                       ? (b * H + r) * W + c
                       : -1;
    }
    return out;
  }

  // Start copying columns k0..k0+KS1 of chunk ch0's fc1 step. Rows of halo
  // pixels outside the image and of hidden channels past Ch are left as
  // they are: their h is set to zero after the product.
  __device__ __forceinline__ void stage(float* buf,
                                        const float* __restrict__ y,
                                        const float* __restrict__ fc1_w,
                                        int ch0, int k0, int C, int Ch) const {
    const int g = threadIdx.x % G;
    if (4 * g >= C - k0) return;  // past C in the last step
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int row = threadIdx.x / G + RSTEP * m;
      if (row < S::NP) {
        if (pix[m] >= 0)
          cp_async16(buf + row * S::LDA + 4 * g,
                     y + static_cast<size_t>(pix[m]) * C + k0 + 4 * g);
      } else if (row < S::NP + S::CK && ch0 + row - S::NP < Ch) {
        const int n = row - S::NP;
        cp_async16(buf + (S::NPP + n) * S::LDA + 4 * g,
                   fc1_w + static_cast<size_t>(ch0 + n) * C + k0 + 4 * g);
      }
    }
  }
};

// Start copying hidden channels k0..k0+KS2 of fc2 ([C, Ch] layout) into
// [C][LDB]; channels past Ch are zeroed (their g is zero too).
template <class S>
__device__ __forceinline__ void stage_fc2_fp32(float* buf,
                                               const float* __restrict__ fc2_w,
                                               int k0, int C, int Ch) {
  constexpr int G = S::KS2 / 4;
  for (int i = threadIdx.x; i < C * G; i += S::THREADS) {
    const int c = i / G, g = i % G;
    float* dst = buf + c * S::LDB + 4 * g;
    if (k0 + 4 * g < Ch)
      cp_async16(dst, fc2_w + static_cast<size_t>(c) * Ch + k0 + 4 * g);
    else
      zero16(dst);
  }
}

// One fc1 step: the thread's MP pixels (pg + NPG1 * i) x NH hidden channels
// (cg + NCG1 * j) over the KS1 columns of the stage (TAIL: the first kn):
// per float4 of k, MP + NH float4 loads for 4 * MP * NH FMAs.
template <class S, bool TAIL>
__device__ __forceinline__ void fc1_step_fp32(float (&acc)[S::MP][S::NH],
                                              const float* buf, int pg, int cg,
                                              int kn) {
  const float* a = buf + pg * S::LDA;
  const float* w = buf + (S::NPP + cg) * S::LDA;
#pragma unroll
  for (int k = 0; k < S::KS1; k += 4) {
    if (TAIL && k >= kn) break;
    float4 av[S::MP];
#pragma unroll
    for (int i = 0; i < S::MP; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * S::NPG1 * S::LDA + k);
#pragma unroll
    for (int j = 0; j < S::NH; ++j) {
      const float4 bw =
          *reinterpret_cast<const float4*>(w + j * S::NCG1 * S::LDA + k);
#pragma unroll
      for (int i = 0; i < S::MP; ++i) {
        acc[i][j] = fmaf(av[i].x, bw.x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bw.y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bw.z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bw.w, acc[i][j]);
      }
    }
  }
}

// The 3x3 depthwise taps + pos_b + residual h, then the exact GELU, for
// hidden channel n = tid % CK of the chunk and CPT columns of the tile: a
// 3-row window of h slides down each column, so an output loads 3 values of
// h, not 10. Arithmetic as the plain version's order of taps.
template <class S, int TH, int TW>
__device__ __forceinline__ void dwconv_gelu_fp32(
    const float* hs, float* gs, const float* __restrict__ pos_w,
    const float* __restrict__ pos_b, int ch0, int Ch) {
  constexpr int kCols = S::THREADS / S::CK;  // column stride
  const int n = threadIdx.x % S::CK, cb = threadIdx.x / S::CK;
  const bool ok = ch0 + n < Ch;
  float pw[9];
#pragma unroll
  for (int i = 0; i < 9; ++i)
    pw[i] = ok ? pos_w[static_cast<size_t>(i) * Ch + ch0 + n] : 0.f;
  const float pb = ok ? pos_b[ch0 + n] : 0.f;
#pragma unroll
  for (int m = 0; m < S::CPT; ++m) {
    const int c = cb + kCols * m;
    const float* col = hs + c * S::LDH + n;
    float win[3][3];
#pragma unroll
    for (int dr = 0; dr < 2; ++dr)
#pragma unroll
      for (int dc = 0; dc < 3; ++dc)
        win[dr][dc] = col[(dr * (TW + 2) + dc) * S::LDH];
#pragma unroll
    for (int r = 0; r < TH; ++r) {
#pragma unroll
      for (int dc = 0; dc < 3; ++dc)
        win[(r + 2) % 3][dc] = col[((r + 2) * (TW + 2) + dc) * S::LDH];
      float a = 0.f;
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int dc = 0; dc < 3; ++dc)
          a = fmaf(win[(r + dr) % 3][dc], pw[dr * 3 + dc], a);
      gs[(r * TW + c) * S::LDH + n] = gelu_erf(a + pb + win[(r + 1) % 3][1]);
    }
  }
}

// One fc2 step: the thread's P2 output pixels (pg2 + NPG2 * i) x Q2 output
// channels (cg2 + NCG2 * j; rows past C read row C - 1 into accumulators the
// output never reads) over KS2 hidden channels: per float4 of k, P2 + Q2
// float4 loads for 4 * P2 * Q2 FMAs.
template <class S>
__device__ __forceinline__ void fc2_step_fp32(float (&acc)[S::P2][S::Q2],
                                              const float* g,
                                              const float* buf, int pg2,
                                              int cg2, int C) {
  const float* a = g + pg2 * S::LDH;
#pragma unroll
  for (int k = 0; k < S::KS2; k += 4) {
    float4 av[S::P2];
#pragma unroll
    for (int i = 0; i < S::P2; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * S::NPG2 * S::LDH + k);
#pragma unroll
    for (int j = 0; j < S::Q2; ++j) {
      const int c = min(cg2 + S::NCG2 * j, C - 1);
      const float4 bw = *reinterpret_cast<const float4*>(buf + c * S::LDB + k);
#pragma unroll
      for (int i = 0; i < S::P2; ++i) {
        acc[i][j] = fmaf(av[i].x, bw.x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bw.y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bw.z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bw.w, acc[i][j]);
      }
    }
  }
}

// Register-blocked fp32 path: y = LayerNorm(x) comes from layernorm_rows_fp32.
// A block walks its hidden chunks as one sequence of steps, each staged by
// cp.async kF32Stages - 1 steps ahead into a ring of shared buffers, one
// barrier per step: per chunk, ceil(C / KS1) fc1 steps (a KS1-column slice of
// y's halo tile and of the chunk's fc1 rows; fc1's sums stay in registers),
// after the last of them h (+ fc1_b, zero outside the image) into hs, a
// barrier, the depthwise taps and GELU into gs; then CK / KS2 fc2 steps (a
// slice of the chunk's fc2 columns) into the output's register
// accumulators. No weight is read from device memory inside a product.
template <int TH, int TW, int CK, int MP, int Q2>
__global__ void __launch_bounds__(F32Tile<TH, TW, CK, MP, Q2>::THREADS, 1)
fused_mlp_fwd_fp32(const float* __restrict__ y,      // LayerNorm(x)
                   const float* __restrict__ fc1_w,  // [Ch, C]
                   const float* __restrict__ fc1_b,
                   const float* __restrict__ pos_w,  // [9, Ch]
                   const float* __restrict__ pos_b,
                   const float* __restrict__ fc2_w,  // [C, Ch]
                   const float* __restrict__ fc2_b, float* __restrict__ out,
                   float* __restrict__ partial, int B, int H, int W, int C,
                   int Ch, int nsplit, int cps) {
  using S = F32Tile<TH, TW, CK, MP, Q2>;
  extern __shared__ float4 smem_raw[];
  float* stages = reinterpret_cast<float*>(smem_raw);  // [kF32Stages][STAGE]
  float* hs = stages + kF32Stages * S::STAGE;          // [NP][LDH]
  float* gs = hs + S::NP * S::LDH;                     // [NO][LDH]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
  const int ch_begin = split * cps * CK;
  const int ch_end = min(Ch, ch_begin + cps * CK);
  const int row0 = blockIdx.y * TH, col0 = blockIdx.x * TW;
  const int n1 = (C + S::KS1 - 1) / S::KS1;  // fc1 steps a chunk
  const int per_chunk = n1 + CK / S::KS2;
  const int nsteps = (ch_end - ch_begin + CK - 1) / CK * per_chunk;
  // fc1 and fc2 thread tiles
  const int cg = warp % S::WC1 * 4 + lane % 4, pg = warp / S::WC1 * 8 + lane / 4;
  const int cg2 = warp % S::WC2 * 8 + lane % 8;
  const int pg2 = warp / S::WC2 * 4 + lane / 8;

  const F32Copies<S> copies = F32Copies<S>::template make<TW>(b, row0, col0,
                                                              H, W);
  // the next step to copy: its index, its place in its chunk, the chunk
  int next = 0, next_s = 0, next_ch0 = ch_begin;
  // one commit group a call, empty past the last step
  auto start_copies = [&]() {
    if (next < nsteps) {
      float* buf = stages + next % kF32Stages * S::STAGE;
      if (next_s < n1)
        copies.stage(buf, y, fc1_w, next_ch0, next_s * S::KS1, C, Ch);
      else
        stage_fc2_fp32<S>(buf, fc2_w, next_ch0 + (next_s - n1) * S::KS2, C,
                          Ch);
    }
    cp_async_commit();
    ++next;
    if (++next_s == per_chunk) next_s = 0, next_ch0 += CK;
  };

  PHASE_BEGIN
#pragma unroll
  for (int t = 0; t < kF32Stages - 1; ++t) start_copies();
  PHASE(kPhStage)
  // step t's buffer, once it has landed for every thread; step t - 1's
  // buffer is then free for step t + kF32Stages - 1
  auto begin_step = [&](int t) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();
    PHASE(kPhWait)
    start_copies();  // step t + kF32Stages - 1
    PHASE(kPhStage)
    return static_cast<const float*>(stages + t % kF32Stages * S::STAGE);
  };

  float acc[S::P2][Q2];
#pragma unroll
  for (int i = 0; i < S::P2; ++i)
#pragma unroll
    for (int j = 0; j < Q2; ++j) acc[i][j] = 0.f;

  int t = 0;
  for (int ch0 = ch_begin; ch0 < ch_end; ch0 += CK) {
    float h[MP][S::NH];
#pragma unroll
    for (int i = 0; i < MP; ++i)
#pragma unroll
      for (int j = 0; j < S::NH; ++j) h[i][j] = 0.f;
    for (int s = 0; s < n1; ++s, ++t) {
      const float* buf = begin_step(t);
      // the last step of a C that is no multiple of KS1 is a shorter one
      const int kn = C - s * S::KS1;
      if (pg < S::NPG1) {
        if (kn >= S::KS1)
          fc1_step_fp32<S, false>(h, buf, pg, cg, kn);
        else
          fc1_step_fp32<S, true>(h, buf, pg, cg, kn);
      }
      PHASE(kPhFc1)
    }
    if (pg < S::NPG1) {
#pragma unroll
      for (int i = 0; i < MP; ++i) {
        const int p = pg + S::NPG1 * i;
        if (p >= S::NP) continue;
        const bool in = in_image<TW>(p, row0, col0, H, W);
#pragma unroll
        for (int j = 0; j < S::NH; ++j) {
          const int n = cg + S::NCG1 * j;
          hs[p * S::LDH + n] =
              in && ch0 + n < Ch ? h[i][j] + fc1_b[ch0 + n] : 0.f;
        }
      }
    }
    PHASE(kPhFc1)
    __syncthreads();  // hs complete; gs free since the last chunk's fc2
    PHASE(kPhWait)
    dwconv_gelu_fp32<S, TH, TW>(hs, gs, pos_w, pos_b, ch0, Ch);
    PHASE(kPhDw)
    for (int s = 0; s < CK / S::KS2; ++s, ++t) {
      const float* buf = begin_step(t);
      fc2_step_fp32<S>(acc, gs + s * S::KS2, buf, pg2, cg2, C);
      PHASE(kPhFc2)
    }
  }

#pragma unroll
  for (int i = 0; i < S::P2; ++i) {
    const int q = pg2 + S::NPG2 * i;
    const int r = row0 + q / TW, c = col0 + q % TW;
    if (r >= H || c >= W) continue;
    const size_t pix = (static_cast<size_t>(b) * H + r) * W + c;
#pragma unroll
    for (int j = 0; j < Q2; ++j) {
      const int oc = cg2 + S::NCG2 * j;
      if (oc >= C) continue;
      if (partial != nullptr)
        partial[(static_cast<size_t>(split) * B * H * W + pix) * C + oc] =
            acc[i][j];
      else
        out[pix * C + oc] = acc[i][j] + fc2_b[oc];
    }
  }
  PHASE(kPhOut)
  PHASE_END
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

// One kernel instantiation and how it launches, and the cost of a block's
// prologue for the caller's split model: prologue_steps of the kernel's
// pipeline steps, of which a hidden chunk takes chunk_steps (the bf16
// kernel's prologue, its halo tile and first weights, is taken as one
// chunk; the fp32 kernel's is its first kF32Stages - 1 copy steps).
struct Launch {
  const void* fn;
  size_t smem;
  int th;
  int tw;
  int chunk;
  int threads;
  int prologue_steps = 1;
  int chunk_steps = 1;
};

// The widest output tile this file has at width C in the I/O type: 16
// columns for the bf16 kernel up to C 192 (its shared memory allows it) and
// for the fp32 kernel up to C 144 (its fc2 accumulators), 8 otherwise.
int max_tile_cols(int C, int is_bf16) {
  return C <= (is_bf16 ? 192 : 144) ? 16 : 8;
}

// The fp32 kernel at width C with tiles tw columns wide (8 or the widest):
// 8 x 16 or 8 x 8 tiles with 64-channel chunks up to C 144, 8 x 8 up to
// C 288, 4 x 8 with 128-channel chunks above (fc1 fills its 8 warps; fc2's
// accumulators stay at most 72 a thread); Q2 output channels per fc2 thread
// tile, enough to cover C (fn null if none).
Launch pick_fp32(int C, int tw) {
  const int th = C <= 288 ? 8 : 4, ck = C <= 288 ? 64 : 128;
  const int q2 = (C * th * tw + 2047) / 2048;  // C / NCG2, NCG2 = 2048 / NO
#define DFORMER_F32_CASE(TH, TW, CK, MP, Q)                                  \
  if (th == TH && tw == TW && q2 == Q)                                       \
    return {reinterpret_cast<const void*>(                                   \
                fused_mlp_fwd_fp32<TH, TW, CK, MP, Q>),                      \
            f32_smem_bytes<F32Tile<TH, TW, CK, MP, Q>>(), TH, TW, CK,        \
            F32Tile<TH, TW, CK, MP, Q>::THREADS, kF32Stages - 1,             \
            f32_chunk_steps<F32Tile<TH, TW, CK, MP, Q>>(C)};
  DFORMER_F32_CASE(8, 16, 64, 6, 1) DFORMER_F32_CASE(8, 16, 64, 6, 2)
  DFORMER_F32_CASE(8, 16, 64, 6, 3) DFORMER_F32_CASE(8, 16, 64, 6, 4)
  DFORMER_F32_CASE(8, 16, 64, 6, 5) DFORMER_F32_CASE(8, 16, 64, 6, 6)
  DFORMER_F32_CASE(8, 16, 64, 6, 7) DFORMER_F32_CASE(8, 16, 64, 6, 8)
  DFORMER_F32_CASE(8, 16, 64, 6, 9) DFORMER_F32_CASE(8, 8, 64, 4, 1)
  DFORMER_F32_CASE(8, 8, 64, 4, 2) DFORMER_F32_CASE(8, 8, 64, 4, 3)
  DFORMER_F32_CASE(8, 8, 64, 4, 4) DFORMER_F32_CASE(8, 8, 64, 4, 5)
  DFORMER_F32_CASE(8, 8, 64, 4, 6) DFORMER_F32_CASE(8, 8, 64, 4, 7)
  DFORMER_F32_CASE(8, 8, 64, 4, 8) DFORMER_F32_CASE(8, 8, 64, 4, 9)
  DFORMER_F32_CASE(4, 8, 128, 4, 5) DFORMER_F32_CASE(4, 8, 128, 4, 6)
  DFORMER_F32_CASE(4, 8, 128, 4, 7) DFORMER_F32_CASE(4, 8, 128, 4, 8)
  DFORMER_F32_CASE(4, 8, 128, 4, 9)
#undef DFORMER_F32_CASE
  return {nullptr, 0, th, tw, ck, 0};
}

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
  return pick_fp32(C, tw);
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
// nsplit * B * H * W * C floats (else it may be null); y is a scratch of
// B * H * W * C in the I/O type for LayerNorm(x) (layernorm_rows or
// layernorm_rows_fp32, launched first). Requires Ch % 32 == 0, C <= 576, and
// C % 16 == 0 (bf16) or C % 4 == 0 with x and y 16-byte aligned (fp32);
// cudaErrorInvalidValue otherwise.
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
      (nsplit > 1 && partial == nullptr) || y == nullptr ||
      (!is_bf16 && (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(y)) % 16 != 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(k.smem));
  if (e != cudaSuccess) return e;
  float* part = nsplit > 1 ? partial : nullptr;
  const dim3 grid((W + k.tw - 1) / k.tw, (H + k.th - 1) / k.th, B * nsplit);
  const long long N = static_cast<long long>(B) * H * W;
  const unsigned ln_blocks = static_cast<unsigned>((N + kWarps - 1) / kWarps);
  if (is_bf16)
    layernorm_rows<<<ln_blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), ln_w, ln_b,
        static_cast<__nv_bfloat16*>(y), N, C, eps);
  else
    layernorm_rows_fp32<<<ln_blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), ln_w, ln_b, static_cast<float*>(y), N,
        C, eps);
  const void* yc = y;
  void* args[] = {&yc,    &fc1_w, &fc1_b, &pos_w, &pos_b, &fc2_w, &fc2_b,
                  &out,   &part,  &B,     &H,     &W,     &C,     &Ch,
                  &nsplit, &cps};
  e = cudaLaunchKernel(k.fn, grid, dim3(k.threads), args, k.smem, s);
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
// numbers as the ptxas -v report beside the built library), then into
// out[8..9] a block's prologue in pipeline steps and the steps of a hidden
// chunk. The caller's plan takes the tile, the chunk, the blocks per SM and
// the prologue's cost in chunks from here.
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
  out[8] = k.prologue_steps;
  out[9] = k.chunk_steps;
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
