// The MST++ kernels, hand-written for Hopper (sm_90a).
//
// Replace the Pallas kernels of animal_vision_tpu/ops/fused_msab.py:
// - conv_kernel<K, S, Cin, Cout>: _conv3_io_kernel (conv_in, 3 -> 31), _conv3_kernel,
//   _conv3_res_kernel and _conv3_stats_kernel (3x3 C -> C, optional
//   residual), _down4_kernel and _down4_stats_kernel (4x4 stride 2, C -> 2C);
// - attn_stats_kernel + stats_reduce_kernel: _stats_kernel (MSAB pass A) and
//   the stats the TPU producers accumulate in _accum_stats;
// - msab_apply_kernel<C>: _apply_kernel (MSAB pass B);
// - up_fuse_kernel<C>: _up_fuse_kernel and _up_fuse_stats_kernel.
//
// All frames are NHWC float32, (N, H, W, C), one grid z (or y) index per
// frame. The TPU pixel packing (H, W/P, P*C), its kron and neighbour-pack
// matrices, the GELU polynomial, bf16 products, lagged-ref halos and the
// sharding bounds are not carried over: every product is float32 and GELU
// is the exact 0.5 x (1 + erf(x / sqrt 2)) with erff.
//
// Bound on this card: operations. The matrix products dominate (an MSAB
// block at C channels does about 12 C^2 multiply-adds per pixel against
// 8 C bytes of traffic: 90 flops per byte at C = 31, above the card's 20 for
// float32 outside the tensor cores).
//
// conv_kernel<K, S, Cin, Cout> is an implicit GEMM on the tensor cores.
// Bound: the 3x3 and 4x4 convolutions do 2 K^2 Cin multiply-adds per
// output value (558 flops per output byte at 31 -> 31), so in float32
// outside the tensor cores they are bound by operations (0.54 ms for
// 31 -> 31 at 1080p) and cuDNN's float32 path took 1.7 ms; conv_in
// (3 -> 31) is bound by its 257 MB of output (0.08 ms). Design:
// - M = a TH x TW tile of output pixels, N = Cout padded to 32/64/128, the
//   inner dimension (tap, Cin) walked in steps of one tap and 32 input
//   channels. conv_in flattens its 27 (tap, channel) pairs into one step
//   of 32 (an im2col tile), instead of padding 3 channels to 8 per tap.
// - The input halo tile is staged once (per 32 channels) in shared memory,
//   pixel-major with the channels contiguous at a pitch of 36 floats, by
//   cp.async with zero fill for the pad ring and the padded channels; at
//   stride 2 its even and odd columns are kept apart, so the 8 pixels of a
//   fragment are 8 consecutive slots and the fragment loads hit 32 banks.
// - Each step's (32 x Cout) weight slab comes through a cp.async ring of
//   two or three slabs (the next loads while this one is multiplied; at
//   31 -> 31 all nine stay), padded in shared memory, so the host packs
//   nothing.
// - 8 warps in a 2D grid over (M, N), each a 32 x 32 warp tile: no warp
//   re-reads the input tile per output group. Products are 3xTF32
//   mma.sync.m16n8k8 (mma_tf32.cuh), each step's sum added into the
//   float32 accumulator apart.
// - Epilogue: the accumulators go to a (pixel, Cout) tile in shared
//   memory, then each tile row, which is one contiguous run of NHWC
//   output, is stored (and the residual read) by consecutive threads at
//   consecutive addresses.
// - Tiles per shape (ConvCfg): 8x32 at K = 3, 8x16 at 31 -> 62, 4x16 at
//   62 -> 124; two blocks fit an SM in each (95 / 107 / 101 KB), so the
//   68x120 level of the 4 x 272 x 480 point keeps two blocks per SM.
//
// The other three kernels run their products as "warp GEMMs" (warp_gemm
// below): an input tile sits in shared memory planar, [channel][pixel], the
// 32 lanes of a warp take 32 pixels each step and the warp takes groups of
// 4 consecutive outputs, so a lane reads conflict-free shared memory and
// every lane of a warp reads the same weight (one broadcast load, from L1).
// Their weights stay in device memory (L1/L2-resident).
// - attn_stats_kernel: a fixed number of blocks per frame (a function of
//   the pixel count only) walk 32-pixel tiles: q and k of the tile into
//   shared memory, then each thread accumulates its entries of the
//   head-diagonal 31x31 blocks of k^T q and the squared norms in registers.
//   The partial sums go to a buffer and stats_reduce_kernel adds them in
//   block order: no atomics, so repeated runs are bit-equal.
// - msab_apply_kernel: one block per TH x TW output tile keeps the whole
//   MSAB in shared memory, with the halos that the three depthwise 3x3s
//   need: x and v = x Wv over a 3-pixel halo, t = gelu(dw3(v)) over 2
//   (zero outside the image: the outer conv's zero pad), res1 = x M + b +
//   dw3(t) + x and y = LN(res1) over 1, then the FFN one chunk of C hidden
//   channels at a time: h = gelu(y W0[:, chunk]) over 1 (zero outside the
//   image: the FFN's depthwise zero pad), gelu(dw3(h)) over the tile, and
//   the chunk's W4 rows added into the output tile. The 4C hidden never
//   reaches device memory. Tiles are 8x8 for C = 31, 62 and 4x8 for
//   C = 124, so that the (2 (TH+6)(TW+6) + (TH+4)(TW+4)) C floats of
//   shared memory fit a block (186 KB at C = 124); at C = 62 and 124 only
//   one block fits an SM, and it takes 16 warps instead of 8.
// - up_fuse_kernel: a 4x8 input tile's 2x2 transposed convolution (with
//   its bias per (dy, dx, out)) is written depth-to-space into the first
//   half of an [up | skip] tile in shared memory, the skip tile into the
//   second half, and one more warp GEMM applies the 1x1 fuse.
//
// C interface (loaded with ctypes): each entry point takes raw device
// pointers and the stream, launches on that stream without synchronising,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;     // consecutive outputs a warp takes per step
constexpr int kHeadDim = 31;  // MST++ attention heads are 31 channels
constexpr int kStatsTile = 32;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float gelu(float x) { return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f)); }

// out(o, p) = sum_k in[k * in_pitch + src(p)] * w[k * ldw + o] for o < no,
// p < np. Lane l takes pixels l, l + 32, ... (NS of them); warp w of the
// block's NW takes the output groups w, w + NW, ... of kGroup outputs.
// `epi(o, p, value)` receives each result once.
template <int NS, int NW, typename Src, typename Epi>
__device__ __forceinline__ void warp_gemm(const float* in, int in_pitch, int nk, const float* __restrict__ w,
                                          int ldw, int no, int np, Src src, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int off[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int p = lane + 32 * s;
    off[s] = p < np ? src(p) : 0;
  }
  for (int o0 = warp * kGroup; o0 < no; o0 += NW * kGroup) {
    const int nq = min(kGroup, no - o0);
    float acc[NS][kGroup];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int q = 0; q < kGroup; ++q) acc[s][q] = 0.f;
    const float* wk = w + o0;
    const float* row = in;
    for (int k = 0; k < nk; ++k, wk += ldw, row += in_pitch) {
      float b[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) b[q] = q < nq ? __ldg(wk + q) : 0.f;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float a = row[off[s]];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) acc[s][q] = fmaf(a, b[q], acc[s][q]);
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int p = lane + 32 * s;
      if (p >= np) continue;
#pragma unroll
      for (int q = 0; q < kGroup; ++q)
        if (q < nq) epi(o0 + q, p, acc[s][q]);
    }
  }
}

// ---------------------------------------------------------------------------
// conv_kernel: out = conv(x, w) (+ residual), zero pad 1, no bias.
// ---------------------------------------------------------------------------

// The inner dimension is walked in steps of kConvK: one tap's 32 input
// channels, or conv_in's 27 flattened (tap, channel) pairs.
constexpr int kConvK = 32;

// Output tile (kH x kW pixels), the warps along M (the rest along N) and
// the weight slabs in flight (kStages) per shape; every warp takes a
// 32 x 32 tile of (pixels, output channels). At 31 -> 31 all nine slabs
// are requested up front and stay resident; 62 -> 124 keeps two ahead.
template <int K, int S, int CIN, int COUT>
struct ConvCfg;
template <>
struct ConvCfg<3, 1, 3, 31> {
  static constexpr int kH = 8, kW = 32, kWarpsM = 8, kStages = 2;
};
template <>
struct ConvCfg<3, 1, 31, 31> {
  static constexpr int kH = 8, kW = 32, kWarpsM = 8, kStages = 9;
};
template <>
struct ConvCfg<4, 2, 31, 62> {
  static constexpr int kH = 8, kW = 16, kWarpsM = 4, kStages = 2;
};
template <>
struct ConvCfg<4, 2, 62, 124> {
  static constexpr int kH = 4, kW = 16, kWarpsM = 2, kStages = 3;
};

template <int K, int S, int CIN, int COUT>
struct ConvShape {
  using Cfg = ConvCfg<K, S, CIN, COUT>;
  static constexpr int TH = Cfg::kH, TW = Cfg::kW, WM = Cfg::kWarpsM, WN = kWarps / WM;
  static constexpr int NP = WN * 32;                   // Cout padded
  static constexpr bool FLAT = K * K * CIN <= kConvK;  // conv_in: one im2col step
  static constexpr int NSTEP = FLAT ? 1 : cdiv(CIN, kConvK) * K * K;
  static constexpr int NSTAGE = Cfg::kStages, NBUF = NSTAGE < NSTEP ? NSTAGE : NSTEP;
  static constexpr int IH = (TH - 1) * S + K, IW = (TW - 1) * S + K;  // input halo tile
  static constexpr int PA = kConvK + 4;  // floats per A row: 4 (mod 32), conflict-free fragments
  static constexpr int PB = NP + 8;      // floats per weight row: 8 (mod 32)
  static constexpr int PO = NP + 8;      // floats per output-tile row: float2 stores conflict-free
  static constexpr int A_ROWS = FLAT ? TH * TW : IH * IW;
  static constexpr int A_FLOATS = A_ROWS * PA > TH * TW * PO ? A_ROWS * PA : TH * TW * PO;
  static constexpr int B_FLOATS = kConvK * PB;
  static constexpr int SMEM_FLOATS = A_FLOATS + NBUF * B_FLOATS;
  static_assert(TH * TW == WM * 32 && NP >= COUT && NP - COUT < 8, "warp tiles must cover the block tile");
  static_assert(IW % S == 0 && TW % 16 == 0, "column parity planes and 16-pixel fragments within a row");
  static_assert(NSTAGE >= 2, "a ring of at least two slabs");
};

// out = conv(x, w) (+ residual), zero pad 1, no bias; one block per TH x TW
// output tile of one frame.
template <int K, int S, int CIN, int COUT>
__global__ void __launch_bounds__(kThreads, 2)
conv_kernel(const float* __restrict__ x, const float* __restrict__ wt, const float* __restrict__ res,
            float* __restrict__ out, int h, int w, int ho, int wo) {
  using P = ConvShape<K, S, CIN, COUT>;
  constexpr int TH = P::TH, TW = P::TW, IW = P::IW, PA = P::PA, PB = P::PB, PO = P::PO;
  extern __shared__ __align__(16) float conv_smem[];
  float* s_a = conv_smem;               // A: input halo tile (pixel slot, 32 channels) or im2col rows
  float* s_b = conv_smem + P::A_FLOATS;  // ring of NBUF weight slabs (32 x NP)
  const int n = blockIdx.z;
  const int ox0 = blockIdx.x * TW, oy0 = blockIdx.y * TH;
  const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;  // pad 1
  const float* src = x + static_cast<size_t>(n) * h * w * CIN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % P::WM, wn = warp / P::WM;
  auto inside = [&](int gy, int gx) { return gy >= 0 && gy < h && gx >= 0 && gx < w; };

  // A for input channels [32 ch, 32 ch + 32): slot iy * IW + (ix % S) * (IW / S)
  // + ix / S holds input pixel (iy, ix) of the halo tile; zero outside the
  // image and beyond Cin.
  auto load_a = [&](int ch) {
    if constexpr (P::FLAT) {
      for (int i = tid; i < P::A_ROWS * kConvK; i += kThreads) {
        const int r = i / kConvK, k = i % kConvK;
        const int tap = k / CIN, c = k % CIN;
        const int gy = iy0 + (r / TW) * S + tap / K, gx = ix0 + (r % TW) * S + tap % K;
        const bool ok = k < K * K * CIN && inside(gy, gx);
        tc::cp_async<4>(s_a + r * PA + k, ok ? src + (static_cast<size_t>(gy) * w + gx) * CIN + c : src, ok);
      }
    } else {
      constexpr int V = tc::copy_vec(CIN), UPS = kConvK / V;  // copies per slot
      for (int i = tid; i < P::A_ROWS * UPS; i += kThreads) {
        const int slot = i / UPS, u = i % UPS, c = ch * kConvK + u * V;
        const int iy = slot / IW, rem = slot % IW;
        const int gy = iy0 + iy, gx = ix0 + (rem % (IW / S)) * S + rem / (IW / S);
        const bool ok = c < CIN && inside(gy, gx);
        tc::cp_async<4 * V>(s_a + slot * PA + u * V,
                            ok ? src + (static_cast<size_t>(gy) * w + gx) * CIN + c : src, ok);
      }
    }
  };
  // The weight slab of step s: rows (tap, 32 channels) or the flattened
  // (tap, channel) pairs, Cout columns; zero beyond both.
  auto load_b = [&](int s, float* dst) {
    constexpr int V = tc::copy_vec(COUT), UPR = P::NP / V;
    const int tap = P::FLAT ? 0 : s % (K * K), c0 = P::FLAT ? 0 : (s / (K * K)) * kConvK;
    for (int i = tid; i < kConvK * UPR; i += kThreads) {
      const int kk = i / UPR, col = (i % UPR) * V;
      const int row = P::FLAT ? kk : tap * CIN + c0 + kk;
      const bool ok = col < COUT && (P::FLAT ? kk < K * K * CIN : c0 + kk < CIN);
      tc::cp_async<4 * V>(dst + kk * PB + col, ok ? wt + static_cast<size_t>(row) * COUT + col : wt, ok);
    }
  };

  // The A rows of this lane: m-tile i, row g (h = 0) or g + 8 (h = 1).
  int base[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * 32 + i * 16 + hf * 8 + g;
      base[i][hf] = P::FLAT ? r * PA : ((r / TW) * S * IW + r % TW) * PA;
    }

  // Group 0: A and slab 0; then one group per slab, NSTAGE - 1 ahead.
  float acc[2][4][4] = {};
  load_a(0);
#pragma unroll
  for (int s = 0; s < P::NSTAGE - 1; ++s) {
    if (s < P::NSTEP) load_b(s, s_b + s * P::B_FLOATS);
    tc::cp_async_commit();
  }
  for (int s = 0; s < P::NSTEP; ++s) {
    tc::cp_async_wait<P::NSTAGE - 2>();
    __syncthreads();  // step s's slab (and A) landed; every warp is done with step s - 1
    const bool next = s + 1 < P::NSTEP;
    if (s + P::NSTAGE - 1 < P::NSTEP) load_b(s + P::NSTAGE - 1, s_b + ((s + P::NSTAGE - 1) % P::NBUF) * P::B_FLOATS);
    tc::cp_async_commit();
    const float* sb = s_b + (s % P::NBUF) * P::B_FLOATS + wn * 32;
    const int tap = P::FLAT ? 0 : s % (K * K), dy = tap / K, dx = tap % K;
    const int off = P::FLAT ? 0 : (dy * IW + (dx % S) * (IW / S) + dx / S) * PA;
    float part[2][4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kConvK; kk += 8) {
      tc::FragA a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i] = tc::load_a(s_a + base[i][0] + off + kk, s_a + base[i][1] + off + kk, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const tc::FragB b = tc::load_b(sb + kk * PB + j * 8, PB, g, t);
#pragma unroll
        for (int i = 0; i < 2; ++i) tc::mma3(part[i][j], a[i], b);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
    if (!P::FLAT && next && (s + 1) % (K * K) == 0) {  // the next 32 input channels
      __syncthreads();
      load_a((s + 1) / (K * K));
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
    }
  }

  // Epilogue: accumulators -> (pixel, Cout) tile in shared memory -> each
  // output row's contiguous NHWC run, with the residual.
  __syncthreads();
  float* s_o = s_a;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm * 32 + i * 16 + g, col = wn * 32 + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(s_o + r * PO + col) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(s_o + (r + 8) * PO + col) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  const int run = min(TW, wo - ox0) * COUT;
  for (int ly = 0; ly < TH && oy0 + ly < ho; ++ly) {
    const size_t row = ((static_cast<size_t>(n) * ho + oy0 + ly) * wo + ox0) * COUT;
    for (int e = tid; e < run; e += kThreads) {
      const int p = e / COUT, c = e - p * COUT;
      const float v = s_o[(ly * TW + p) * PO + c];
      out[row + e] = res == nullptr ? v : v + __ldg(res + row + e);
    }
  }
}

template <int K, int S, int CIN, int COUT>
int launch_conv(const float* x, const float* wt, const float* res, float* out, int n, int h, int w,
                cudaStream_t stream) {
  using P = ConvShape<K, S, CIN, COUT>;
  const int ho = (h + 2 - K) / S + 1, wo = (w + 2 - K) / S + 1;
  if (ho < 1 || wo < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * P::SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(conv_kernel<K, S, CIN, COUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(wo, P::TW), cdiv(ho, P::TH), n);
  conv_kernel<K, S, CIN, COUT><<<grid, kThreads, smem, stream>>>(x, wt, res, out, h, w, ho, wo);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// attn_stats_kernel + stats_reduce_kernel: per frame, the head-diagonal
// blocks of G = k^T q (heads x 31 x 31, G[o][e] = sum k_o q_e), then
// sum q^2 and sum k^2 (C each), with q = x Wq, k = x Wk.
// ---------------------------------------------------------------------------

template <int C>
__host__ __device__ constexpr int stats_size() { return C * kHeadDim + 2 * C; }

template <int C>
__host__ __device__ constexpr size_t stats_smem_floats() { return static_cast<size_t>(C) * kStatsTile + 2 * C * (kStatsTile + 1); }

template <int C>
__global__ void __launch_bounds__(kThreads)
attn_stats_kernel(const float* __restrict__ x, const float* __restrict__ wq, const float* __restrict__ wk,
                  float* __restrict__ part, int npix, int nblk) {
  constexpr int TP = kStatsTile, PQ = TP + 1;  // odd pitch: rows in distinct banks
  constexpr int NE = C * kHeadDim;             // head-diagonal entries
  constexpr int NG = cdiv(NE, kThreads);
  extern __shared__ float smem[];
  float* s_x = smem;            // (C, TP)
  float* s_q = s_x + C * TP;    // (C, PQ)
  float* s_k = s_q + C * PQ;    // (C, PQ)
  const int n = blockIdx.y, blk = blockIdx.x;
  const float* src = x + static_cast<size_t>(n) * npix * C;

  int row_k[NG], row_q[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int hd = e / (kHeadDim * kHeadDim), r = e % (kHeadDim * kHeadDim);
    row_k[j] = (hd * kHeadDim + r / kHeadDim) * PQ;
    row_q[j] = (hd * kHeadDim + r % kHeadDim) * PQ;
  }
  float g[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) g[j] = 0.f;
  float ss = 0.f;

  const int ntiles = cdiv(npix, TP);
  for (int t = blk; t < ntiles; t += nblk) {
    const int p0 = t * TP;
    for (int i = threadIdx.x; i < TP * C; i += kThreads) {
      const int p = i / C, c = i - p * C;
      s_x[c * TP + p] = p0 + p < npix ? src[static_cast<size_t>(p0) * C + i] : 0.f;
    }
    __syncthreads();
    warp_gemm<1, kWarps>(s_x, TP, C, wq, C, C, TP, [](int p) { return p; },
                 [&](int o, int p, float v) { s_q[o * PQ + p] = v; });
    warp_gemm<1, kWarps>(s_x, TP, C, wk, C, C, TP, [](int p) { return p; },
                 [&](int o, int p, float v) { s_k[o * PQ + p] = v; });
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      if (threadIdx.x + j * kThreads >= NE) continue;
      const float* kr = s_k + row_k[j];
      const float* qr = s_q + row_q[j];
      float acc = 0.f;
#pragma unroll 8
      for (int p = 0; p < TP; ++p) acc = fmaf(kr[p], qr[p], acc);
      g[j] += acc;
    }
    if (threadIdx.x < 2 * C) {
      const float* r = threadIdx.x < C ? s_q + threadIdx.x * PQ : s_k + (threadIdx.x - C) * PQ;
      float acc = 0.f;
#pragma unroll 8
      for (int p = 0; p < TP; ++p) acc = fmaf(r[p], r[p], acc);
      ss += acc;
    }
    __syncthreads();
  }
  float* dst = part + (static_cast<size_t>(n) * nblk + blk) * stats_size<C>();
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (e < NE) dst[e] = g[j];
  }
  if (threadIdx.x < 2 * C) dst[NE + threadIdx.x] = ss;
}

// out[n][e] = sum over blocks b, in order, of part[n][b][e].
__global__ void __launch_bounds__(kThreads)
stats_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int nblk, int size) {
  const int n = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= size) return;
  const float* p = part + static_cast<size_t>(n) * nblk * size + e;
  float acc = 0.f;
  for (int b = 0; b < nblk; ++b) acc += p[static_cast<size_t>(b) * size];
  out[static_cast<size_t>(n) * size + e] = acc;
}

template <int C>
int launch_stats(const float* x, const float* wq, const float* wk, float* part, float* out, int n, int npix,
                 int nblk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * stats_smem_floats<C>();
  cudaError_t err = cudaFuncSetAttribute(attn_stats_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_stats_kernel<C><<<dim3(nblk, n), kThreads, smem, stream>>>(x, wq, wk, part, npix, nblk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = stats_size<C>();
  stats_reduce_kernel<<<dim3(cdiv(size, kThreads), n), kThreads, 0, stream>>>(part, out, nblk, size);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// msab_apply_kernel: MSAB pass B over one TH x TW output tile.
// Regions R3 (3-pixel halo), R2, R1 and R0 (the tile), planar in shared
// memory; (ly, lx) of R_k is (ly - k + j, lx - k + j) of R_j's origin.
// ---------------------------------------------------------------------------

// Shared memory allows one block per SM at C = 62 and 124, so those blocks
// take 16 warps (each warp then has one or two output groups of a GEMM);
// at C = 31 three 8-warp blocks share an SM and 8 output groups keep 8
// warps busy.
template <int C>
struct ApplyTile {
  static constexpr int kH = C > 62 ? 4 : 8, kW = 8;
  static constexpr int kThreads = C > 31 ? 512 : 256;
};

template <int C>
__host__ __device__ constexpr size_t apply_smem_floats() {
  constexpr int TH = ApplyTile<C>::kH, TW = ApplyTile<C>::kW;
  return static_cast<size_t>(C) * (2 * (TH + 6) * (TW + 6) + (TH + 4) * (TW + 4));
}

template <int C>
__global__ void __launch_bounds__(ApplyTile<C>::kThreads)
msab_apply_kernel(const float* __restrict__ x, float* __restrict__ out, const float* __restrict__ m,
                  const float* __restrict__ wv, const float* __restrict__ bproj, const float* __restrict__ pos0,
                  const float* __restrict__ pos2, const float* __restrict__ lnw, const float* __restrict__ lnb,
                  const float* __restrict__ w0, const float* __restrict__ dwk, const float* __restrict__ w4, int h,
                  int w) {
  constexpr int TH = ApplyTile<C>::kH, TW = ApplyTile<C>::kW;
  constexpr int W3 = TW + 6, N3 = (TH + 6) * W3;
  constexpr int W2 = TW + 4, N2 = (TH + 4) * W2;
  constexpr int W1 = TW + 2, N1 = (TH + 2) * W1;
  constexpr int N0 = TH * TW;
  constexpr int C4 = 4 * C;
  constexpr int NT = ApplyTile<C>::kThreads, NW = NT / 32;
  extern __shared__ float smem[];
  float* s_a = smem;          // X over R3; later the hidden chunk H over R1, then H2 over R0
  float* s_b = s_a + C * N3;  // V over R3; later R (res1) over R1, then O (output) over R0
  float* s_c = s_b + C * N3;  // T over R2; later Y (LayerNorm) over R1
  float* s_h2 = s_a + C * N1;
  float* s_o = s_b + C * N1;
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  auto inside = [&](int gy, int gx) { return gy >= 0 && gy < h && gx >= 0 && gx < w; };
  const float* src = x + static_cast<size_t>(n) * h * w * C;

  // 1. X = x over R3, zero outside the image.
  for (int i = threadIdx.x; i < N3 * C; i += NT) {
    const int p = i / C, c = i - p * C;
    const int gy = y0 - 3 + p / W3, gx = x0 - 3 + p % W3;
    s_a[c * N3 + p] = inside(gy, gx) ? src[(static_cast<size_t>(gy) * w + gx) * C + c] : 0.f;
  }
  __syncthreads();

  // 2. V = X Wv over R3 (zero outside the image, as X is).
  warp_gemm<cdiv(N3, 32), NW>(s_a, N3, C, wv, C, C, N3, [](int p) { return p; },
                          [&](int o, int p, float v) { s_b[o * N3 + p] = v; });
  __syncthreads();

  // 3. T = gelu(dw3(V, pos0)) over R2, zero outside the image.
  for (int i = threadIdx.x; i < N2 * C; i += NT) {
    const int c = i / N2, p = i - c * N2;
    const int ly = p / W2, lx = p - ly * W2;
    float t = 0.f;
    if (inside(y0 - 2 + ly, x0 - 2 + lx)) {
      const float* v = s_b + c * N3 + ly * W3 + lx;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < 9; ++d) acc = fmaf(v[(d / 3) * W3 + d % 3], __ldg(pos0 + d * C + c), acc);
      t = gelu(acc);
    }
    s_c[c * N2 + p] = t;
  }
  __syncthreads();

  // 4. R = X M + bproj + dw3(T, pos2) + X over R1, into s_b (V is dead).
  warp_gemm<cdiv(N1, 32), NW>(
      s_a, N3, C, m + static_cast<size_t>(n) * C * C, C, C, N1,
      [](int p) { return (p / W1 + 2) * W3 + p % W1 + 2; },
      [&](int o, int p, float v) {
        const int ly = p / W1, lx = p - ly * W1;
        const float* t = s_c + o * N2 + ly * W2 + lx;
        float pos = 0.f;
#pragma unroll
        for (int d = 0; d < 9; ++d) pos = fmaf(t[(d / 3) * W2 + d % 3], __ldg(pos2 + d * C + o), pos);
        s_b[o * N1 + p] = v + __ldg(bproj + o) + pos + s_a[o * N3 + (ly + 2) * W3 + lx + 2];
      });
  __syncthreads();

  // 5. Y = LayerNorm(R) over R1 (biased variance, eps 1e-5), into s_c (T is
  //    dead); O = R over R0, the FFN's residual.
  for (int p = threadIdx.x; p < N1; p += NT) {
    float mu = 0.f;
    for (int c = 0; c < C; ++c) mu += s_b[c * N1 + p];
    mu /= C;
    float var = 0.f;
    for (int c = 0; c < C; ++c) {
      const float d = s_b[c * N1 + p] - mu;
      var = fmaf(d, d, var);
    }
    var /= C;
    const float inv = 1.0f / sqrtf(var + 1e-5f);
    for (int c = 0; c < C; ++c) s_c[c * N1 + p] = (s_b[c * N1 + p] - mu) * inv * __ldg(lnw + c) + __ldg(lnb + c);
  }
  for (int i = threadIdx.x; i < C * N0; i += NT) {
    const int c = i / N0, p = i - c * N0;
    s_o[i] = s_b[c * N1 + (p / TW + 1) * W1 + p % TW + 1];
  }
  __syncthreads();

  // 6. The FFN, C hidden channels at a time.
  for (int k0 = 0; k0 < C4; k0 += C) {
    // H = gelu(Y W0[:, k0:k0+C]) over R1, zero outside the image.
    warp_gemm<cdiv(N1, 32), NW>(s_c, N1, C, w0 + k0, C4, C, N1, [](int p) { return p; },
                            [&](int o, int p, float v) {
                              const int ly = p / W1, lx = p - ly * W1;
                              s_a[o * N1 + p] = inside(y0 - 1 + ly, x0 - 1 + lx) ? gelu(v) : 0.f;
                            });
    __syncthreads();
    // H2 = gelu(dw3(H)) over R0.
    for (int i = threadIdx.x; i < C * N0; i += NT) {
      const int c = i / N0, p = i - c * N0;
      const float* hh = s_a + c * N1 + (p / TW) * W1 + p % TW;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < 9; ++d) acc = fmaf(hh[(d / 3) * W1 + d % 3], __ldg(dwk + d * C4 + k0 + c), acc);
      s_h2[i] = gelu(acc);
    }
    __syncthreads();
    // O += H2 W4[k0:k0+C, :]
    warp_gemm<cdiv(N0, 32), NW>(s_h2, N0, C, w4 + static_cast<size_t>(k0) * C, C, C, N0,
                                [](int p) { return p; },
                            [&](int o, int p, float v) { s_o[o * N0 + p] += v; });
    __syncthreads();
  }

  // 7. Store O over the tile's pixels inside the image.
  float* dst = out + static_cast<size_t>(n) * h * w * C;
  for (int i = threadIdx.x; i < N0 * C; i += NT) {
    const int p = i / C, c = i - p * C;
    const int gy = y0 + p / TW, gx = x0 + p % TW;
    if (gy < h && gx < w) dst[(static_cast<size_t>(gy) * w + gx) * C + c] = s_o[c * N0 + p];
  }
}

template <int C>
int launch_apply(const float* x, float* out, const float* m, const float* wv, const float* bproj,
                 const float* pos0, const float* pos2, const float* lnw, const float* lnb, const float* w0,
                 const float* dwk, const float* w4, int n, int h, int w, cudaStream_t stream) {
  const size_t smem = sizeof(float) * apply_smem_floats<C>();
  cudaError_t err = cudaFuncSetAttribute(msab_apply_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(w, ApplyTile<C>::kW), cdiv(h, ApplyTile<C>::kH), n);
  msab_apply_kernel<C><<<grid, ApplyTile<C>::kThreads, smem, stream>>>(x, out, m, wv, bproj, pos0, pos2, lnw,
                                                                        lnb, w0, dwk, w4, h, w);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// up_fuse_kernel: a 4x8 tile of the (h, w, C) input -> an 8x16 tile of the
// (2h, 2w, C/2) output.
// ---------------------------------------------------------------------------

constexpr int kUpH = 4, kUpW = 8, kUpIn = kUpH * kUpW, kUpOutW = 2 * kUpW, kUpOut = 4 * kUpIn;

template <int C>
__host__ __device__ constexpr size_t up_smem_floats() { return static_cast<size_t>(C) * (kUpIn + kUpOut); }

template <int C>
__global__ void __launch_bounds__(kThreads)
up_fuse_kernel(const float* __restrict__ fea, const float* __restrict__ skip, float* __restrict__ out,
               const float* __restrict__ wup, const float* __restrict__ bup, const float* __restrict__ fuse,
               int h, int w) {
  constexpr int HF = C / 2;
  extern __shared__ float smem[];
  float* s_f = smem;             // (C, kUpIn): the input tile
  float* s_x = s_f + C * kUpIn;  // (C, kUpOut): [up | skip] over the output tile
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * kUpW, y0 = blockIdx.y * kUpH;
  const int h2 = 2 * h, w2 = 2 * w;
  const float* fsrc = fea + static_cast<size_t>(n) * h * w * C;
  const float* ssrc = skip + static_cast<size_t>(n) * h2 * w2 * HF;
  for (int i = threadIdx.x; i < kUpIn * C; i += kThreads) {
    const int p = i / C, c = i - p * C;
    const int gy = y0 + p / kUpW, gx = x0 + p % kUpW;
    s_f[c * kUpIn + p] = (gy < h && gx < w) ? fsrc[(static_cast<size_t>(gy) * w + gx) * C + c] : 0.f;
  }
  for (int i = threadIdx.x; i < kUpOut * HF; i += kThreads) {
    const int p = i / HF, c = i - p * HF;
    const int gy = 2 * y0 + p / kUpOutW, gx = 2 * x0 + p % kUpOutW;
    s_x[(HF + c) * kUpOut + p] = (gy < h2 && gx < w2) ? ssrc[(static_cast<size_t>(gy) * w2 + gx) * HF + c] : 0.f;
  }
  __syncthreads();
  // up(o = (dy, dx, j), p) = fea(p) wup[:, o] + bup[o], written to output
  // pixel (2y + dy, 2x + dx), channel j.
  warp_gemm<cdiv(kUpIn, 32), kWarps>(s_f, kUpIn, C, wup, 4 * HF, 4 * HF, kUpIn, [](int p) { return p; },
                             [&](int o, int p, float v) {
                               const int dd = o / HF, j = o - dd * HF;
                               const int py = 2 * (p / kUpW) + dd / 2, px = 2 * (p % kUpW) + dd % 2;
                               s_x[j * kUpOut + py * kUpOutW + px] = v + __ldg(bup + o);
                             });
  __syncthreads();
  float* dst = out + static_cast<size_t>(n) * h2 * w2 * HF;
  warp_gemm<cdiv(kUpOut, 32), kWarps>(s_x, kUpOut, C, fuse, HF, HF, kUpOut, [](int p) { return p; },
                              [&](int o, int p, float v) {
                                const int gy = 2 * y0 + p / kUpOutW, gx = 2 * x0 + p % kUpOutW;
                                if (gy < h2 && gx < w2) dst[(static_cast<size_t>(gy) * w2 + gx) * HF + o] = v;
                              });
}

template <int C>
int launch_up_fuse(const float* fea, const float* skip, float* out, const float* wup, const float* bup,
                   const float* fuse, int n, int h, int w, cudaStream_t stream) {
  const size_t smem = sizeof(float) * up_smem_floats<C>();
  cudaError_t err =
      cudaFuncSetAttribute(up_fuse_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(w, kUpW), cdiv(h, kUpH), n);
  up_fuse_kernel<C><<<grid, kThreads, smem, stream>>>(fea, skip, out, wup, bup, fuse, h, w);
  return static_cast<int>(cudaGetLastError());
}

bool frames_ok(int n, int h, int w) { return n >= 1 && n <= 65535 && h >= 1 && w >= 1; }

}  // namespace

extern "C" {

// conv: x (n, h, w, cin), wt (k, k, cin, cout), res (n, ho, wo, cout) or
// null, out (n, ho, wo, cout); k = 3 (stride 1) or 4 (stride 2), pad 1;
// (k, cin, cout) one of (3, 3, 31), (3, 31, 31), (4, 31, 62), (4, 62, 124).
int av_msab_conv(const void* x, const void* wt, const void* res, void* out, int n, int h, int w, int cin,
                 int cout, int k, void* stream) {
  if (!frames_ok(n, h, w) || cin < 1 || cout < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(wt);
  const auto* rf = static_cast<const float*>(res);
  auto* of = static_cast<float*>(out);
  if (k == 3 && cin == 3 && cout == 31) return launch_conv<3, 1, 3, 31>(xf, wf, rf, of, n, h, w, s);
  if (k == 3 && cin == 31 && cout == 31) return launch_conv<3, 1, 31, 31>(xf, wf, rf, of, n, h, w, s);
  if (k == 4 && cin == 31 && cout == 62) return launch_conv<4, 2, 31, 62>(xf, wf, rf, of, n, h, w, s);
  if (k == 4 && cin == 62 && cout == 124) return launch_conv<4, 2, 62, 124>(xf, wf, rf, of, n, h, w, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one conv block for (k, cin, cout), in bytes; 0
// for a shape the kernel is not built for.
int av_msab_conv_smem(int k, int cin, int cout) {
  if (k == 3 && cin == 3 && cout == 31) return sizeof(float) * ConvShape<3, 1, 3, 31>::SMEM_FLOATS;
  if (k == 3 && cin == 31 && cout == 31) return sizeof(float) * ConvShape<3, 1, 31, 31>::SMEM_FLOATS;
  if (k == 4 && cin == 31 && cout == 62) return sizeof(float) * ConvShape<4, 2, 31, 62>::SMEM_FLOATS;
  if (k == 4 && cin == 62 && cout == 124) return sizeof(float) * ConvShape<4, 2, 62, 124>::SMEM_FLOATS;
  return 0;
}

// stats: x (n, npix, c), wq/wk (c, c), part (n, nblk, c*31 + 2c) scratch,
// out (n, c*31 + 2c) = [G blocks (heads, 31, 31) | sum q^2 | sum k^2].
int av_msab_stats(const void* x, const void* wq, const void* wk, void* part, void* out, int n, int npix, int c,
                  int nblk, void* stream) {
  if (n < 1 || n > 65535 || npix < 1 || nblk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* qf = static_cast<const float*>(wq);
  const auto* kf = static_cast<const float*>(wk);
  auto* pf = static_cast<float*>(part);
  auto* of = static_cast<float*>(out);
  if (c == 31) return launch_stats<31>(xf, qf, kf, pf, of, n, npix, nblk, s);
  if (c == 62) return launch_stats<62>(xf, qf, kf, pf, of, n, npix, nblk, s);
  if (c == 124) return launch_stats<124>(xf, qf, kf, pf, of, n, npix, nblk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// apply: x/out (n, h, w, c), m (n, c, c), wv (c, c), bproj (c), pos0/pos2
// (3, 3, c), lnw/lnb (c), w0 (c, 4c), dwk (3, 3, 4c), w4 (4c, c).
int av_msab_apply(const void* x, void* out, const void* m, const void* wv, const void* bproj, const void* pos0,
                  const void* pos2, const void* lnw, const void* lnb, const void* w0, const void* dwk,
                  const void* w4, int n, int h, int w, int c, void* stream) {
  if (!frames_ok(n, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define AV_APPLY(CC)                                                                                               \
  launch_apply<CC>(static_cast<const float*>(x), static_cast<float*>(out), static_cast<const float*>(m),          \
                   static_cast<const float*>(wv), static_cast<const float*>(bproj),                               \
                   static_cast<const float*>(pos0), static_cast<const float*>(pos2),                              \
                   static_cast<const float*>(lnw), static_cast<const float*>(lnb), static_cast<const float*>(w0), \
                   static_cast<const float*>(dwk), static_cast<const float*>(w4), n, h, w, s)
  if (c == 31) return AV_APPLY(31);
  if (c == 62) return AV_APPLY(62);
  if (c == 124) return AV_APPLY(124);
#undef AV_APPLY
  return static_cast<int>(cudaErrorInvalidValue);
}

// up_fuse: fea (n, h, w, c), skip (n, 2h, 2w, c/2), out (n, 2h, 2w, c/2),
// wup (c, 2, 2, c/2), bup (2, 2, c/2), fuse (c, c/2).
int av_msab_up_fuse(const void* fea, const void* skip, void* out, const void* wup, const void* bup,
                    const void* fuse, int n, int h, int w, int c, void* stream) {
  if (!frames_ok(n, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ff = static_cast<const float*>(fea);
  const auto* sf = static_cast<const float*>(skip);
  auto* of = static_cast<float*>(out);
  const auto* uf = static_cast<const float*>(wup);
  const auto* bf = static_cast<const float*>(bup);
  const auto* zf = static_cast<const float*>(fuse);
  if (c == 62) return launch_up_fuse<62>(ff, sf, of, uf, bf, zf, n, h, w, s);
  if (c == 124) return launch_up_fuse<124>(ff, sf, of, uf, bf, zf, n, h, w, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
