// The MST++ kernels, hand-written for Hopper (sm_90a).
//
// Replace the Pallas kernels of animal_vision_tpu/ops/fused_msab.py:
// - conv_kernel<K, S, Cin, Cout>: _conv3_io_kernel (conv_in, 3 -> 31), _conv3_kernel,
//   _conv3_res_kernel and _conv3_stats_kernel (3x3 C -> C, optional
//   residual), _down4_kernel and _down4_stats_kernel (4x4 stride 2, C -> 2C);
// - attn_stats_kernel<C> + stats_reduce_kernel: _stats_kernel (MSAB pass A)
//   and the stats the TPU producers accumulate in _accum_stats;
// - msab_pos_kernel<C>: the first half of _apply_kernel (MSAB pass B),
//   res1 = x M + b + dw3(gelu(dw3(x Wv))) + x; the second half, the FFN of
//   res1, is ffn_kernel of fused_mst.cu (ops/fused_msab.py:msab_apply calls
//   both); msab_pos_masked_kernel<C>, its masked form for MST-L,
//   res1 = ((x Wv) * gate) M' + b + dw3(gelu(dw3(x Wv))) + x;
// - up_fuse_kernel<C>: _up_fuse_kernel and _up_fuse_stats_kernel.
//
// All frames are NHWC float32, (N, H, W, C), one grid z (or y) index per
// frame. The TPU pixel packing (H, W/P, P*C), its kron and neighbour-pack
// matrices, the GELU polynomial, bf16 products, lagged-ref halos and the
// sharding bounds are not carried over: every product is float32 (3xTF32
// on the tensor cores) and GELU is the exact 0.5 x (1 + erf(x / sqrt 2))
// with erff.
//
// Bound on this card, for float32 outside the tensor cores: operations.
// The matrix products dominate (an MSAB block at C channels does about
// 12 C^2 multiply-adds per pixel against 8 C bytes of traffic: 90 flops per
// byte at C = 31, above the card's 20). So every kernel here runs its
// products on the tensor cores in 3xTF32 (mma_tf32.cuh).
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
// attn_stats_kernel<C> (pass A) on the tensor cores. Bound: per pixel
// 4 C^2 multiply-adds for q and k, 2 * 31 C for the head-diagonal Gram
// blocks and 2 C for the norms, against 4 C bytes read: in 3xTF32 about
// 0.06-0.08 ms per 1080p level, set by the bytes at C = 31 and 62 and by
// the products at C = 124 (0.18 ms in float32 outside the tensor cores).
// Design:
// - one block per (run of pixel tiles, head, frame); the head's 31 columns
//   of Wq and of Wk stay in shared memory, x comes in tiles of P = 64
//   pixels (32 at C = 124) by cp.async, pixel-major, two tiles in flight;
// - [q | k] = x [Wq | Wk] for the head as 3xTF32 mma.sync into a (P, 64)
//   tile; then G += k^T q with the pixels as the inner dimension, each warp
//   one 16 x 8 block of the padded 32 x 32 G in fragments across all its
//   tiles, each 32-pixel slice summed apart; sum q^2 and sum k^2 in float32
//   from the staged tile, each thread over a quarter of the pixels;
// - the number of blocks per frame and head is a function of the pixel
//   count only (ops/fused_msab.py:stats_blocks, up to 1024: a 1080p frame
//   fills the card), each block writes its partial sums to a buffer, and
//   stats_reduce_kernel adds them in a fixed order: no atomics, so repeated
//   runs are bit-equal and a frame gives the same bits alone and in a batch.
//
// msab_pos_kernel<C> (the first half of pass B) on the tensor cores. Bound:
// per pixel 2 C^2 multiply-adds (x Wv, x M) and 2 depthwise 3x3s, against
// 8 C bytes: in 3xTF32 the bytes set it at C = 31 and 62 (0.153 / 0.077 ms
// at 1080p), the products at C = 124 (0.048 ms). The FFN that follows is
// ffn_kernel: splitting there costs one round trip of res1 (2% of the old
// single kernel's time at C = 31) and takes the halo from 3 pixels to 2.
// Design, one block of 8 warps per TH x TW output tile (PosTile):
// - x over R2 (the tile and a 2-pixel halo) by cp.async with zero fill,
//   pixel-major at a pitch of CP + 4 (CP: C padded to 8);
// - the output channels in chunks of 32: the chunk's columns of Wv and M_n
//   (M of frame n) arrive by cp.async (the next chunk's during this one's
//   depthwise work); V = x Wv[:, chunk] over R2 and A = x M[:, chunk] over
//   R0 in 3xTF32 mma.sync, each 32-deep slice summed apart;
// - T = gelu(dw3(V, pos0)) over R1 (zero outside the image: the outer
//   depthwise's zero pad) and dw3(T, pos2) over R0 on the float32 units, a
//   thread per (channel, run of pixels along a row), as ffn_kernel's
//   depthwise; V outside the image is 0 because x is;
// - ((A + bproj) + dw3(T)) + x into a (pixel, 32) tile, stored by
//   consecutive threads at consecutive addresses of each pixel's run.
// The masked form (MST-L's mask-guided attention; the same body, a
// compile-time switch) cannot fold Wv into M: the product is over
// G = (x Wv) * gate, the gate a (1, H, W, C) map of the level's mask read at
// stride 0 across the batch, with M' = A Wproj. So V is computed once per
// chunk as above and feeds both branches: after T, V's R0 rows are scaled
// by the gate in place, and G[:, chunk] M'[chunk, :] (M' rows as the slab)
// is added into accumulators that span every output channel (the same 16
// floats per thread at C = 31, 62 and 124). Each chunk stores
// (bproj + dw3(T)) + x; after the last chunk the accumulators pass through
// x's dead space and are added to the tile's output in place. Same tiles
// and shared memory; one more read of the gate and a second pass over the
// output tile (4 C bytes in, 8 C through L2).
//
// up_fuse_kernel<C> (the decoder level) as one 3xTF32 GEMM per output
// parity. The transposed convolution is folded into the fuse once per
// model (ops/fused_msab.py:up_fuse_weights, as the JAX packed_up_fuse
// folds it): with W'[dy,dx] = Wup[dy,dx] Wf_up and b'[dy,dx] = bup[dy,dx]
// Wf_up, out(2y+dy, 2x+dx) = [fea(y,x) | skip(2y+dy,2x+dx)] [W'[dy,dx] ;
// Wf_skip] + b'[dy,dx]: an inner dimension of C + C/2 (93 or 186, padded
// to 96 or 192), C/2 outputs (padded to 32 or 64), 25% fewer operations
// than the transposed convolution and the fuse apart, and no [up | skip]
// intermediate. Bound: bytes at both levels in 3xTF32 (0.19 ms at 62 -> 31
// and 0.10 ms at 124 -> 62 for a 1080p frame). Design, one block of 8
// warps per TH x TW input tile (UpTile):
// - the fea tile (pixel-major) and the skip rows of the 2TH x 2TW output
//   tile, each row as it lies in memory, are staged once by cp.async with
//   zero fill;
// - the composed weights, packed by the wrapper in the order they are
//   used, stream through a ring of three slabs (16-byte copies): a slice of
//   W' for all four parities (32 rows at C = 62, 16 at 124), then 32-row
//   slices of Wf_skip; each slice is summed apart, in 3xTF32 mma.sync;
// - each warp owns one parity and a 32 x 32 tile of (pixels, outputs), so
//   each split A fragment feeds four products and each B fragment two;
// - the results (plus b') overwrite the skip values of their own pixels,
//   so the staged rows become the output tile, and each row, one
//   contiguous NHWC run, is stored by consecutive threads at consecutive
//   addresses.
//
// C interface (loaded with ctypes): each entry point takes raw device
// pointers and the stream, launches on that stream without synchronising,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 31;  // MST++ attention heads are 31 channels

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float gelu(float x) { return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f)); }

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

// One block per (run of pixel tiles, head, frame). Its head's 31 q and 31 k
// columns of [Wq | Wk] stay in shared memory; x comes in P-pixel tiles, two
// in flight. The [q | k] tile is (P, 64): q in columns 0..30, k in 32..62.
template <int C>
struct Stats {
  static constexpr int CP = cdiv(C, 8) * 8;
  static constexpr int P = C > 62 ? 32 : 64;  // pixels per tile
  static constexpr int PX = CP + 4;           // x rows: 4 (mod 32), conflict-free A fragments
  static constexpr int PQ = 72;               // [q | k] and weight rows: 8 (mod 32)
  // [q | k] product: each warp one 16-pixel m-tile and NPW of the 8 n-tiles
  static constexpr int MT = P / 16, NGRP = kWarps / MT, NPW = 8 / NGRP;
  static constexpr int X = P * PX, QK = P * PQ, W = CP * PQ;
  static constexpr int SMEM_FLOATS = 2 * X + QK + W;
  static_assert(CP % 32 == 0 && kWarps % MT == 0 && NPW * NGRP == 8, "tile does not fit the warps");
  static_assert(P % 32 == 0 && 4 * 64 <= QK, "32-pixel Gram slices; the norm partials reuse the [q | k] tile");
};

template <int C>
__global__ void __launch_bounds__(kThreads)
attn_stats_kernel(const float* __restrict__ x, const float* __restrict__ wq, const float* __restrict__ wk,
                  float* __restrict__ part, int npix, int nblk) {
  using S = Stats<C>;
  constexpr int CP = S::CP, P = S::P, PX = S::PX, PQ = S::PQ;
  extern __shared__ __align__(16) float stats_smem[];
  float* s_x = stats_smem;         // two (P, PX) x tiles
  float* s_qk = s_x + 2 * S::X;    // (P, PQ): [q | k] of the head over the tile
  float* s_w = s_qk + S::QK;       // (CP, PQ): the head's [Wq | Wk] columns
  const int blk = blockIdx.x, hd = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* src = x + static_cast<size_t>(n) * npix * C;

  // The head's weights, zero beyond C rows and 31 columns (rows of C floats
  // start anywhere: 4-byte copies, once per block).
  for (int i = tid; i < CP * 64; i += kThreads) {
    const int r = i / 64, col = i % 64, e = col & 31;
    const float* wsrc = col < 32 ? wq : wk;
    const bool ok = r < C && e < kHeadDim;
    tc::cp_async<4>(s_w + r * PQ + col, ok ? wsrc + static_cast<size_t>(r) * C + hd * kHeadDim + e : wsrc, ok);
  }
  auto load_x = [&](int tile, float* dst) {
    constexpr int V = tc::copy_vec(C), UPP = CP / V;  // copies per pixel
    const int p0 = tile * P;
    for (int i = tid; i < P * UPP; i += kThreads) {
      const int p = i / UPP, c = (i % UPP) * V;
      const bool ok = c < C && p0 + p < npix;
      tc::cp_async<4 * V>(dst + p * PX + c, ok ? src + static_cast<size_t>(p0 + p) * C + c : src, ok);
    }
  };
  const int ntiles = cdiv(npix, P);
  if (blk < ntiles) load_x(blk, s_x);
  tc::cp_async_commit();

  const int wm = warp % S::MT, wg = warp / S::MT;  // [q | k] product: m-tile, n-group
  const int gm = warp & 1, gn = warp >> 1;          // Gram: k rows gm*16.., q columns gn*8..
  const int cq = tid & 63, quarter = tid >> 6;      // norms: [q | k] column, pixel residue mod 4
  float gacc[4] = {0.f, 0.f, 0.f, 0.f};
  float ss = 0.f;
  int buf = 0;
  for (int tile = blk; tile < ntiles; tile += nblk, buf ^= 1) {
    // The other buffer was last read by the previous tile's [q | k] product,
    // which every warp finished before that tile's second barrier.
    if (tile + nblk < ntiles) load_x(tile + nblk, s_x + (buf ^ 1) * S::X);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();  // this tile landed; every warp is done with the last tile's [q | k]

    // 1. [q | k] = x [Wq | Wk] over the tile, 32-deep slices summed apart.
    {
      const float* xs = s_x + buf * S::X;
      const float* r0 = xs + (wm * 16 + g) * PX;
      const float* r1 = r0 + 8 * PX;
      float d[S::NPW][4] = {};
#pragma unroll
      for (int s0 = 0; s0 < CP; s0 += 32) {
        float sl[S::NPW][4] = {};
#pragma unroll
        for (int kk = s0; kk < s0 + 32; kk += 8) {
          const tc::FragA a = tc::load_a(r0 + kk, r1 + kk, t);
#pragma unroll
          for (int j = 0; j < S::NPW; ++j)
            tc::mma3(sl[j], a, tc::load_b(s_w + kk * PQ + (wg * S::NPW + j) * 8, PQ, g, t));
        }
#pragma unroll
        for (int j = 0; j < S::NPW; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) d[j][q] += sl[j][q];
      }
#pragma unroll
      for (int j = 0; j < S::NPW; ++j) {
        const int r = wm * 16 + g, col = (wg * S::NPW + j) * 8 + 2 * t;
        *reinterpret_cast<float2*>(s_qk + r * PQ + col) = make_float2(d[j][0], d[j][1]);
        *reinterpret_cast<float2*>(s_qk + (r + 8) * PQ + col) = make_float2(d[j][2], d[j][3]);
      }
    }
    __syncthreads();

    // 2. G += k^T q over the tile's pixels (the inner dimension), each
    //    32-pixel slice summed apart: A[o][p] = k[p][o], B[p][e] = q[p][e].
#pragma unroll
    for (int p0 = 0; p0 < P; p0 += 32) {
      float sl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 32; kk += 8) {
        const float* corner = s_qk + (p0 + kk) * PQ;
        tc::mma3(sl, tc::load_a_t(corner + 32 + gm * 16, PQ, g, t), tc::load_b(corner + gn * 8, PQ, g, t));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) gacc[q] += sl[q];
    }
    // 3. The squared norms in float32, each thread over a quarter of the pixels.
#pragma unroll 4
    for (int p = quarter; p < P; p += 4) {
      const float v = s_qk[p * PQ + cq];
      ss = fmaf(v, v, ss);
    }
  }

  tc::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the [q | k] tile
  float* s_n = s_qk;
  s_n[quarter * 64 + cq] = ss;
  __syncthreads();
  float* dst = part + (static_cast<size_t>(n) * nblk + blk) * stats_size<C>();
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int o = gm * 16 + g + 8 * hf, e = gn * 8 + 2 * t + q;
      if (o < kHeadDim && e < kHeadDim) dst[(hd * kHeadDim + o) * kHeadDim + e] = gacc[2 * hf + q];
    }
  if (tid < 64 && (tid & 31) < kHeadDim) {
    const float v = ((s_n[tid] + s_n[64 + tid]) + s_n[128 + tid]) + s_n[192 + tid];
    dst[C * kHeadDim + (tid < 32 ? 0 : C) + hd * kHeadDim + (tid & 31)] = v;
  }
}

// out[n][e] = the sum over blocks b of part[n][b][e] in a fixed order: warp
// w adds blocks w, w + 8, ... (lanes on 32 consecutive entries), then the
// eight warp sums are added in warp order.
__global__ void __launch_bounds__(kThreads)
stats_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int nblk, int size) {
  __shared__ float s_sum[kWarps][32];
  const int n = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (e < size) {
    const float* p = part + static_cast<size_t>(n) * nblk * size + e;
#pragma unroll 4
    for (int b = warp; b < nblk; b += kWarps) acc += p[static_cast<size_t>(b) * size];
  }
  s_sum[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && e < size) {
    float v = s_sum[0][lane];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) v += s_sum[k][lane];
    out[static_cast<size_t>(n) * size + e] = v;
  }
}

template <int C>
int launch_stats(const float* x, const float* wq, const float* wk, float* part, float* out, int n, int npix,
                 int nblk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Stats<C>::SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(attn_stats_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_stats_kernel<C><<<dim3(nblk, C / kHeadDim, n), kThreads, smem, stream>>>(x, wq, wk, part, npix, nblk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = stats_size<C>();
  stats_reduce_kernel<<<dim3(cdiv(size, 32), n), kThreads, 0, stream>>>(part, out, nblk, size);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// msab_pos_kernel: res1 = x M + bproj + dw3(gelu(dw3(x Wv, pos0)), pos2) + x
// over one TH x TW output tile. R2 is the tile with a 2-pixel halo, R1 with
// 1, R0 the tile; pixel-major in shared memory.
// ---------------------------------------------------------------------------

// The output tile built for each C (POS_TILES in ops/fused_msab.py): the
// largest of which two blocks fit an H100 SM (106 / 95 / 115 KB; two blocks
// may take 115,712 bytes). At C = 62 an 8x16 tile would take 150 KB and at
// C = 124 an 8x8 one 154 KB: x over R2 alone is N2 (CP + 4) floats.
template <int C>
struct PosTile;
template <>
struct PosTile<31> {
  static constexpr int kH = 8, kW = 16;
};
template <>
struct PosTile<62> {
  static constexpr int kH = 8, kW = 8;
};
template <>
struct PosTile<124> {
  static constexpr int kH = 4, kW = 8;
};

template <int C>
struct Pos {
  static constexpr int TH = PosTile<C>::kH, TW = PosTile<C>::kW;
  static constexpr int CP = cdiv(C, 8) * 8, NCHUNK = CP / 32;  // 32-channel output chunks
  static constexpr int W2 = TW + 4, N2 = (TH + 4) * W2, W1 = TW + 2, N1 = (TH + 2) * W1, N0 = TH * TW;
  // pitches (floats): A rows 4 (mod 32), B rows and float2-stored rows 8
  static constexpr int PX = CP + 4, PV = 40, PT = 32, PW = 40;
  static constexpr int MT2 = cdiv(N2, 16), MT0 = N0 / 16;
  // the R0 product: each warp one m-tile and NA of the chunk's 4 n-tiles
  static constexpr int NA = MT0 * 4 / kWarps, AG = 4 / NA;
  static constexpr int RL = W1 % 6 == 0 ? 6 : 5;  // T's run of pixels per thread along a row
  static constexpr int XS = N2 * PX, VS = N2 * PV, TS = N1 * PT, WS = CP * PW;
  static constexpr int SMEM_FLOATS = XS + VS + TS + 2 * WS;
  // the masked product over every output channel: a chunk's (32, CP) slab of
  // M' rows at pitch PM (8 mod 32); each warp one m-tile and 4 of the CP / 8
  // n-tiles, MG warps per m-tile
  static constexpr int PM = CP + 8, MG = CP / 32;
  static_assert(CP % 32 == 0 && N0 % 16 == 0 && NA * AG == 4 && MT0 * AG == kWarps, "tile does not fit the warps");
  static_assert(W1 % RL == 0 && TW % 4 == 0 && N0 * PV <= VS, "runs within rows; the output chunk reuses V's space");
  static_assert(MT0 * MG == kWarps && 32 * PM <= WS && N0 * PX <= XS, "the masked product's slab and sums fit");
};

// The pos kernels' body: kMasked selects the masked form (m is then M' and
// gate the (1, h, w, C) gate; unmasked, gate is not read).
template <int C, bool kMasked>
__device__ __forceinline__ void msab_pos_body(const float* __restrict__ x, float* __restrict__ out,
                                              const float* __restrict__ m, const float* __restrict__ wv,
                                              const float* __restrict__ bproj, const float* __restrict__ pos0,
                                              const float* __restrict__ pos2, const float* __restrict__ gate, int h,
                                              int w) {
  using P = Pos<C>;
  constexpr int TH = P::TH, TW = P::TW, CP = P::CP, W2 = P::W2, N2 = P::N2, W1 = P::W1, N1 = P::N1, N0 = P::N0;
  constexpr int PX = P::PX, PV = P::PV, PT = P::PT, PW = P::PW, RL = P::RL;
  extern __shared__ __align__(16) float pos_smem[];
  float* s_x = pos_smem;     // (N2, PX): x over R2
  float* s_v = s_x + P::XS;  // (N2, PV): V's chunk over R2; later the output chunk over R0
  float* s_t = s_v + P::VS;  // (N1, PT): T's chunk over R1
  float* s_w = s_t + P::TS;  // [Wv chunk (CP, PW) | M chunk (CP, PW)]
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  auto inside = [&](int gy, int gx) { return gy >= 0 && gy < h && gx >= 0 && gx < w; };
  const float* src = x + static_cast<size_t>(n) * h * w * C;
  const float* mn = m + static_cast<size_t>(n) * C * C;

  // Chunk j's slabs: columns [32 j, 32 j + 32) of Wv and of M, zero beyond
  // C (masked: of Wv alone; the M' rows come by load_mrows).
  auto load_w = [&](int j) {
    constexpr int V = tc::copy_vec(C), UPR = 32 / V;
    for (int i = tid; i < (kMasked ? 1 : 2) * CP * UPR; i += kThreads) {
      const int which = i / (CP * UPR), rem = i % (CP * UPR);
      const int r = rem / UPR, col = (rem % UPR) * V, c = j * 32 + col;
      const float* wsrc = which ? mn : wv;
      const bool ok = r < C && c < C;
      tc::cp_async<4 * V>(s_w + which * P::WS + r * PW + col, ok ? wsrc + static_cast<size_t>(r) * C + c : wsrc, ok);
    }
  };
  // Masked: chunk j's slab of M' rows [32 j, 32 j + 32), every column, zero beyond C.
  auto load_mrows = [&](int j) {
    constexpr int V = tc::copy_vec(C), UPR = CP / V;
    for (int i = tid; i < 32 * UPR; i += kThreads) {
      const int r = i / UPR, col = (i % UPR) * V, row = j * 32 + r;
      const bool ok = row < C && col < C;
      tc::cp_async<4 * V>(s_w + P::WS + r * P::PM + col, ok ? mn + static_cast<size_t>(row) * C + col : mn, ok);
    }
  };
  // x over R2 (zero outside the image and beyond C), with chunk 0's slabs.
  {
    constexpr int V = tc::copy_vec(C), UPP = CP / V;
    for (int i = tid; i < N2 * UPP; i += kThreads) {
      const int p = i / UPP, c = (i % UPP) * V;
      const int gy = y0 - 2 + p / W2, gx = x0 - 2 + p % W2;
      const bool ok = c < C && inside(gy, gx);
      tc::cp_async<4 * V>(s_x + p * PX + c, ok ? src + (static_cast<size_t>(gy) * w + gx) * C + c : src, ok);
    }
  }
  load_w(0);
  if constexpr (kMasked) load_mrows(0);
  tc::cp_async_commit();

  // The R0 product's rows of this lane: R0 pixel r is R2 pixel (r / TW + 2, r % TW + 2).
  const int am = warp / P::AG, an = (warp % P::AG) * P::NA;
  const int ra = am * 16 + g, rb = ra + 8;
  const float* xa = s_x + ((ra / TW + 2) * W2 + ra % TW + 2) * PX;
  const float* xb = s_x + ((rb / TW + 2) * W2 + rb % TW + 2) * PX;
  // Masked: this lane's sums of the product over every output channel, its
  // rows R0 pixels rma and rma + 8 and its n-tiles mn0..mn0 + 3.
  float macc[kMasked ? 4 : 1][4] = {};
  const int rma = (warp / P::MG) * 16 + g, mn0 = (warp % P::MG) * 4;

  for (int j = 0; j < P::NCHUNK; ++j) {
    tc::cp_async_wait<0>();
    __syncthreads();  // chunk j's slabs (and x) landed; chunk j - 1's stores are done with s_v
    const float* swv = s_w;
    const float* smc = s_w + P::WS;

    // 1. V = x Wv[:, chunk] over R2 (zero outside the image, as x is), one
    //    16-row m-tile and the chunk's 4 n-tiles per unit; rows past N2
    //    read row N2 - 1 and are not stored.
    for (int u = warp; u < P::MT2; u += kWarps) {
      const int r0 = u * 16 + g, r1 = r0 + 8;
      const float* p0 = s_x + min(r0, N2 - 1) * PX;
      const float* p1 = s_x + min(r1, N2 - 1) * PX;
      float d[4][4] = {};
#pragma unroll
      for (int s0 = 0; s0 < CP; s0 += 32) {
        float sl[4][4] = {};
#pragma unroll
        for (int kk = s0; kk < s0 + 32; kk += 8) {
          const tc::FragA a = tc::load_a(p0 + kk, p1 + kk, t);
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) tc::mma3(sl[jn], a, tc::load_b(swv + kk * PW + jn * 8, PW, g, t));
        }
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int q = 0; q < 4; ++q) d[jn][q] += sl[jn][q];
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int col = jn * 8 + 2 * t;
        if (r0 < N2) *reinterpret_cast<float2*>(s_v + r0 * PV + col) = make_float2(d[jn][0], d[jn][1]);
        if (r1 < N2) *reinterpret_cast<float2*>(s_v + r1 * PV + col) = make_float2(d[jn][2], d[jn][3]);
      }
    }
    // 2. A = x M[:, chunk] over R0, held in fragments until step 4 (not in
    //    the masked form: its product waits for the gate, steps 3b-3c).
    float acc[P::NA][4] = {};
    if constexpr (!kMasked) {
#pragma unroll
      for (int s0 = 0; s0 < CP; s0 += 32) {
        float sl[P::NA][4] = {};
#pragma unroll
        for (int kk = s0; kk < s0 + 32; kk += 8) {
          const tc::FragA a = tc::load_a(xa + kk, xb + kk, t);
#pragma unroll
          for (int jn = 0; jn < P::NA; ++jn) tc::mma3(sl[jn], a, tc::load_b(smc + kk * PW + (an + jn) * 8, PW, g, t));
        }
#pragma unroll
        for (int jn = 0; jn < P::NA; ++jn)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[jn][q] += sl[jn][q];
      }
    }
    __syncthreads();  // V is complete; every warp is done with the slabs
    if (j + 1 < P::NCHUNK) {  // the next chunk's slabs load during steps 3-5
      load_w(j + 1);  // masked: Wv alone, M' rows after step 3c
      tc::cp_async_commit();
    }

    // 3. T = gelu(dw3(V, pos0)) over R1, zero outside the image (the outer
    //    depthwise's zero pad): a thread per (channel, run of RL pixels).
    {
      constexpr int RUNS = N1 / RL, PER = cdiv(RUNS * 32, kThreads);
      const int c = lane, ch = j * 32 + c;
      float kw[9];
#pragma unroll
      for (int d = 0; d < 9; ++d) kw[d] = ch < C ? __ldg(pos0 + d * C + ch) : 0.f;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int run = warp + q * kWarps;
        if (run >= RUNS) break;
        const int ly = run / (W1 / RL), lx = (run % (W1 / RL)) * RL;
        const float* vv = s_v + (ly * W2 + lx) * PV + c;  // R2 (ly, lx): the window corner of R1 (ly, lx)
        float v[RL];
#pragma unroll
        for (int jj = 0; jj < RL; ++jj) v[jj] = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int ix = 0; ix < RL + 2; ++ix) {
            const float hv = vv[(dy * W2 + ix) * PV];
#pragma unroll
            for (int jj = 0; jj < RL; ++jj)
              if (ix - jj >= 0 && ix - jj < 3) v[jj] = fmaf(hv, kw[dy * 3 + ix - jj], v[jj]);
          }
#pragma unroll
        for (int jj = 0; jj < RL; ++jj)
          s_t[(ly * W1 + lx + jj) * PT + c] = inside(y0 - 1 + ly, x0 - 1 + lx + jj) ? gelu(v[jj]) : 0.f;
      }
    }
    __syncthreads();  // T is complete; V is dead (but for the masked form's R0 rows)

    if constexpr (kMasked) {
      // 3b. G = V * gate over R0, in V's R0 rows (zero outside the image),
      //     a warp per pixel and a lane per channel.
      {
        const int c = lane, ch = j * 32 + c;
        for (int p = warp; p < N0; p += kWarps) {
          const int gy = y0 + p / TW, gx = x0 + p % TW;
          float* vv = s_v + ((p / TW + 2) * W2 + p % TW + 2) * PV + c;
          *vv = ch < C && gy < h && gx < w ? *vv * __ldg(gate + (static_cast<size_t>(gy) * w + gx) * C + ch) : 0.f;
        }
      }
      __syncthreads();
      // 3c. Sums += G[:, chunk] M'[chunk, :], one 32-deep slice.
      {
        const float* smr = s_w + P::WS;
        const int rmb = rma + 8;
        const float* ga = s_v + ((rma / TW + 2) * W2 + rma % TW + 2) * PV;
        const float* gb = s_v + ((rmb / TW + 2) * W2 + rmb % TW + 2) * PV;
        float sl[4][4] = {};
#pragma unroll
        for (int kk = 0; kk < 32; kk += 8) {
          const tc::FragA a = tc::load_a(ga + kk, gb + kk, t);
#pragma unroll
          for (int jn = 0; jn < 4; ++jn)
            tc::mma3(sl[jn], a, tc::load_b(smr + kk * P::PM + (mn0 + jn) * 8, P::PM, g, t));
        }
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int q = 0; q < 4; ++q) macc[jn][q] += sl[jn][q];
      }
      __syncthreads();  // every warp is done with G and the M' slab
      if (j + 1 < P::NCHUNK) {
        load_mrows(j + 1);
        tc::cp_async_commit();
      }
    }

    // 4. The output chunk over R0 into V's space: A, then
    //    ((A + bproj) + dw3(T, pos2)) + x, a thread per (channel, run of 4);
    //    masked, (bproj + dw3(T, pos2)) + x.
    float* s_o = s_v;
    if constexpr (!kMasked) {
#pragma unroll
      for (int jn = 0; jn < P::NA; ++jn) {
        const int col = (an + jn) * 8 + 2 * t;
        *reinterpret_cast<float2*>(s_o + ra * PV + col) = make_float2(acc[jn][0], acc[jn][1]);
        *reinterpret_cast<float2*>(s_o + rb * PV + col) = make_float2(acc[jn][2], acc[jn][3]);
      }
    }
    __syncthreads();
    {
      constexpr int RUNS = N0 / 4, PER = cdiv(RUNS * 32, kThreads);
      const int c = lane, ch = j * 32 + c;
      float kw[9];
#pragma unroll
      for (int d = 0; d < 9; ++d) kw[d] = ch < C ? __ldg(pos2 + d * C + ch) : 0.f;
      const float bias = ch < C ? __ldg(bproj + ch) : 0.f;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int run = warp + q * kWarps;
        if (run >= RUNS) break;
        const int ly = run / (TW / 4), lx = (run % (TW / 4)) * 4;
        const float* tt = s_t + (ly * W1 + lx) * PT + c;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int ix = 0; ix < 6; ++ix) {
            const float tv = tt[(dy * W1 + ix) * PT];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              if (ix - jj >= 0 && ix - jj < 3) v[jj] = fmaf(tv, kw[dy * 3 + ix - jj], v[jj]);
          }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float* o = s_o + (ly * TW + lx + jj) * PV + c;
          if constexpr (kMasked) {
            *o = (bias + v[jj]) + s_x[((ly + 2) * W2 + lx + jj + 2) * PX + ch];
          } else {
            *o = ((*o + bias) + v[jj]) + s_x[((ly + 2) * W2 + lx + jj + 2) * PX + ch];
          }
        }
      }
    }
    __syncthreads();

    // 5. Store the chunk's channels of each tile row inside the image.
    const int nch = min(32, C - j * 32), cols = min(TW, w - x0);
    for (int ly = 0; ly < TH && y0 + ly < h; ++ly) {
      float* row = out + ((static_cast<size_t>(n) * h + y0 + ly) * w + x0) * C + j * 32;
      for (int e = tid; e < cols * nch; e += kThreads) {
        const int p = e / nch, c = e - p * nch;
        row[static_cast<size_t>(p) * C + c] = s_o[(ly * TW + p) * PV + c];
      }
    }
  }

  if constexpr (kMasked) {
    // 6. out += G M' over the tile: the sums through x's space (dead since
    //    the last chunk's step 4), each tile row read, added and stored by
    //    consecutive threads.
    float* s_a = s_x;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int col = (mn0 + jn) * 8 + 2 * t;
      *reinterpret_cast<float2*>(s_a + rma * PX + col) = make_float2(macc[jn][0], macc[jn][1]);
      *reinterpret_cast<float2*>(s_a + (rma + 8) * PX + col) = make_float2(macc[jn][2], macc[jn][3]);
    }
    __syncthreads();  // the sums, and every chunk's stores to out, are done
    const int cols = min(TW, w - x0);
    for (int ly = 0; ly < TH && y0 + ly < h; ++ly) {
      float* row = out + ((static_cast<size_t>(n) * h + y0 + ly) * w + x0) * C;
      for (int e = tid; e < cols * C; e += kThreads) {
        const int p = e / C, c = e - p * C;
        row[e] += s_a[(ly * TW + p) * PX + c];
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
msab_pos_kernel(const float* __restrict__ x, float* __restrict__ out, const float* __restrict__ m,
                const float* __restrict__ wv, const float* __restrict__ bproj, const float* __restrict__ pos0,
                const float* __restrict__ pos2, int h, int w) {
  msab_pos_body<C, false>(x, out, m, wv, bproj, pos0, pos2, nullptr, h, w);
}

// The masked form: m is M' (n, C, C), gate (1, h, w, C).
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
msab_pos_masked_kernel(const float* __restrict__ x, float* __restrict__ out, const float* __restrict__ m,
                       const float* __restrict__ wv, const float* __restrict__ bproj, const float* __restrict__ pos0,
                       const float* __restrict__ pos2, const float* __restrict__ gate, int h, int w) {
  msab_pos_body<C, true>(x, out, m, wv, bproj, pos0, pos2, gate, h, w);
}

template <int C>
int launch_pos(const float* x, float* out, const float* m, const float* wv, const float* bproj, const float* pos0,
               const float* pos2, const float* gate, int n, int h, int w, int th, int tw, cudaStream_t stream) {
  using P = Pos<C>;
  if (th != P::TH || tw != P::TW) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * P::SMEM_FLOATS;
  const dim3 grid(cdiv(w, P::TW), cdiv(h, P::TH), n);
  if (gate != nullptr) {
    cudaError_t err = cudaFuncSetAttribute(msab_pos_masked_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    msab_pos_masked_kernel<C><<<grid, kThreads, smem, stream>>>(x, out, m, wv, bproj, pos0, pos2, gate, h, w);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaFuncSetAttribute(msab_pos_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  msab_pos_kernel<C><<<grid, kThreads, smem, stream>>>(x, out, m, wv, bproj, pos0, pos2, h, w);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// up_fuse_kernel: out(2y+dy, 2x+dx) = [fea(y,x) | skip(2y+dy,2x+dx)]
// [W'[dy,dx] ; Wf_skip] + b'[dy,dx] over one TH x TW tile of fea, i.e. a
// 2TH x 2TW tile of the output.
// ---------------------------------------------------------------------------

// The input tile built for each C (UP_TILES in ops/fused_msab.py) and the
// depth of its fea slices (UP_FEA_SLICE): the largest tile of which two
// blocks fit an H100 SM (108 / 102 KB; 8x16 at C = 62 and 4x16 at C = 124
// take more than the 115,712 bytes two blocks may take).
template <int C>
struct UpTile;
template <>
struct UpTile<62> {
  static constexpr int kH = 8, kW = 8, kFeaSlice = 32;
};
template <>
struct UpTile<124> {
  static constexpr int kH = 4, kW = 8, kFeaSlice = 16;
};

template <int C>
struct Up {
  static constexpr int TH = UpTile<C>::kH, TW = UpTile<C>::kW, M = TH * TW;  // input pixels
  static constexpr int HF = C / 2;
  static constexpr int CF = cdiv(C, 32) * 32, HP = cdiv(HF, 32) * 32;  // fea and skip depths, padded
  static constexpr int NP = cdiv(HF, 32) * 32;                        // output columns, padded
  static constexpr int KF = UpTile<C>::kFeaSlice, KS = 32;            // slice depths: fea (4 parities), skip
  static constexpr int NF = CF / KF, NSTEP = NF + HP / KS, NSTAGE = 3;
  // pitches (floats): fea rows 4 (mod 32), weight rows 8 (mod 32); a skip
  // row is the 2TW pixels of one output row, contiguous, plus a zero pad
  static constexpr int PF = CF + 4, PB = NP + 8, RP = 2 * TW * HF + 4;
  static constexpr int MT = M / 32, NT = NP / 32;  // warp tiles of 32 x 32 per parity
  static constexpr int FEA = M * PF, RAW = 2 * TH * RP;
  static constexpr int SLAB = (4 * KF > KS ? 4 * KF : KS) * PB;
  static constexpr int SMEM_FLOATS = FEA + RAW + NSTAGE * SLAB;
  static_assert(MT * NT * 4 == kWarps && CF % KF == 0 && HP % KS == 0, "one 32 x 32 tile per warp and parity");
  static_assert(RP % tc::copy_vec(HF) == 0 && FEA % 4 == 0, "aligned skip rows");
};

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
up_fuse_kernel(const float* __restrict__ fea, const float* __restrict__ skip, float* __restrict__ out,
               const float* __restrict__ wpk, const float* __restrict__ bc, int h, int w) {
  using U = Up<C>;
  constexpr int TH = U::TH, TW = U::TW, HF = U::HF, CF = U::CF, NP = U::NP;
  constexpr int KF = U::KF, KS = U::KS, NF = U::NF, PF = U::PF, PB = U::PB, RP = U::RP;
  extern __shared__ __align__(16) float up_smem[];
  float* s_f = up_smem;          // (M, PF): fea over the tile, pixel-major
  float* s_r = s_f + U::FEA;     // (2TH, RP): skip over the output tile; later the output
  float* s_b = s_r + U::RAW;     // ring of NSTAGE weight slabs
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int h2 = 2 * h, w2 = 2 * w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // warp -> parity d = 2 dy + dx and a 32 x 32 tile of (pixels, outputs)
  const int d = warp & 3, dy = d >> 1, dx = d & 1, sub = warp >> 2;
  const int m0 = (sub % U::MT) * 32, n0 = (sub / U::MT) * 32;
  const int run = min(2 * TW, w2 - 2 * x0) * HF;  // floats of an output row inside the frame

  // fea (zero outside the frame and beyond C) and the skip rows of the
  // output tile as they lie in memory (zero outside the frame).
  {
    const float* fsrc = fea + static_cast<size_t>(n) * h * w * C;
    constexpr int V = tc::copy_vec(C), UPP = CF / V;
    for (int i = tid; i < U::M * UPP; i += kThreads) {
      const int p = i / UPP, c = (i % UPP) * V;
      const int gy = y0 + p / TW, gx = x0 + p % TW;
      const bool ok = c < C && gy < h && gx < w;
      tc::cp_async<4 * V>(s_f + p * PF + c, ok ? fsrc + (static_cast<size_t>(gy) * w + gx) * C + c : fsrc, ok);
    }
    const float* ssrc = skip + (static_cast<size_t>(n) * h2 * w2 + 2 * x0) * HF;
    constexpr int VS = tc::copy_vec(HF), UPR = RP / VS;
    for (int i = tid; i < 2 * TH * UPR; i += kThreads) {
      const int ly = i / UPR, e = (i % UPR) * VS;
      const int gy = 2 * y0 + ly;
      const bool ok = gy < h2 && e < run;
      tc::cp_async<4 * VS>(s_r + ly * RP + e, ok ? ssrc + static_cast<size_t>(gy) * w2 * HF + e : ssrc, ok);
    }
  }
  // Slab s: for s < NF, rows [KF s, KF s + KF) of W'[d] for the four
  // parities; then 32-row slices of Wf_skip. The wrapper packs them in this
  // order, zero-padded to CF / HP rows and NP columns (16-byte copies).
  auto load_b = [&](int s, float* dst) {
    const int rows = s < NF ? 4 * KF : KS;
    const float* src = wpk + static_cast<size_t>(s < NF ? s * 4 * KF : 4 * CF + (s - NF) * KS) * NP;
    for (int i = tid; i < rows * (NP / 4); i += kThreads) {
      const int r = i / (NP / 4), col = (i % (NP / 4)) * 4;
      tc::cp_async<16>(dst + r * PB + col, src + r * NP + col, true);
    }
  };
#pragma unroll
  for (int s = 0; s < U::NSTAGE - 1; ++s) {
    load_b(s, s_b + s * U::SLAB);
    tc::cp_async_commit();
  }

  // This lane's A rows: m-tile i, row g (h = 0) or g + 8 (h = 1), in the
  // fea tile and in its parity's skip pixels.
  const float* af[2][2];
  float* as[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = m0 + 16 * i + 8 * hf + g, iy = r / TW, ix = r % TW;
      af[i][hf] = s_f + r * PF;
      as[i][hf] = s_r + (2 * iy + dy) * RP + (2 * ix + dx) * HF;
    }

  float acc[2][4][4] = {};
  for (int s = 0; s < U::NSTEP; ++s) {
    tc::cp_async_wait<U::NSTAGE - 2>();
    __syncthreads();  // slab s (and the tiles) landed; every warp is done with step s - 1
    if (s + U::NSTAGE - 1 < U::NSTEP) load_b(s + U::NSTAGE - 1, s_b + ((s + U::NSTAGE - 1) % U::NSTAGE) * U::SLAB);
    tc::cp_async_commit();
    const float* sb = s_b + (s % U::NSTAGE) * U::SLAB + n0;
    float part[2][4][4] = {};
    // one slice: A columns [k0, k0 + depth) of the rows in `a`, B rows from `b`
    auto slice = [&](const auto& a, int k0, const float* b, auto depth) {
#pragma unroll
      for (int kk = 0; kk < decltype(depth)::value; kk += 8) {
        tc::FragA fa[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) fa[i] = tc::load_a(a[i][0] + k0 + kk, a[i][1] + k0 + kk, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const tc::FragB fb = tc::load_b(b + kk * PB + 8 * j, PB, g, t);
#pragma unroll
          for (int i = 0; i < 2; ++i) tc::mma3(part[i][j], fa[i], fb);
        }
      }
    };
    if (s < NF) {
      slice(af, s * KF, sb + d * KF * PB, std::integral_constant<int, KF>());
    } else {
      slice(as, (s - NF) * KS, sb, std::integral_constant<int, KS>());
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
  }

  // Once every warp is done reading the skip pixels, each pixel's result
  // plus b'[d] takes the place of its skip values (its first C/2 floats).
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    const float b0 = col < HF ? __ldg(bc + d * HF + col) : 0.f;
    const float b1 = col + 1 < HF ? __ldg(bc + d * HF + col + 1) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (col < HF) as[i][hf][col] = acc[i][j][2 * hf] + b0;
        if (col + 1 < HF) as[i][hf][col + 1] = acc[i][j][2 * hf + 1] + b1;
      }
  }
  __syncthreads();

  // Each output row of the tile inside the frame: one contiguous NHWC run.
  for (int ly = 0; ly < 2 * TH && 2 * y0 + ly < h2; ++ly) {
    float* row = out + ((static_cast<size_t>(n) * h2 + 2 * y0 + ly) * w2 + 2 * x0) * HF;
    for (int e = tid; e < run; e += kThreads) row[e] = s_r[ly * RP + e];
  }
}

template <int C>
int launch_up_fuse(const float* fea, const float* skip, float* out, const float* wpk, const float* bc, int n,
                   int h, int w, int th, int tw, cudaStream_t stream) {
  using U = Up<C>;
  if (th != U::TH || tw != U::TW) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * U::SMEM_FLOATS;
  cudaError_t err =
      cudaFuncSetAttribute(up_fuse_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(w, U::TW), cdiv(h, U::TH), n);
  up_fuse_kernel<C><<<grid, kThreads, smem, stream>>>(fea, skip, out, wpk, bc, h, w);
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

// stats: x (n, npix, c) starting on 16 bytes, wq/wk (c, c), part
// (n, nblk, c*31 + 2c) scratch, out (n, c*31 + 2c) = [G blocks
// (heads, 31, 31) | sum q^2 | sum k^2].
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

// pos: x/out (n, h, w, c), m (n, c, c), wv (c, c), bproj (c), pos0/pos2
// (3, 3, c); x, m and wv start on 4 * copy_vec(c) bytes (16 at c = 124, 8
// at 62); th x tw must be the tile built for c (PosTile). With a gate
// (1, h, w, c) the masked form runs (m is then M'); null, the unmasked one.
int av_msab_pos(const void* x, void* out, const void* m, const void* wv, const void* bproj, const void* pos0,
                const void* pos2, const void* gate, int n, int h, int w, int c, int th, int tw, void* stream) {
  if (!frames_ok(n, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(out);
  const auto* mf = static_cast<const float*>(m);
  const auto* vf = static_cast<const float*>(wv);
  const auto* bf = static_cast<const float*>(bproj);
  const auto* p0 = static_cast<const float*>(pos0);
  const auto* p2 = static_cast<const float*>(pos2);
  const auto* gf = static_cast<const float*>(gate);
  if (c == 31) return launch_pos<31>(xf, of, mf, vf, bf, p0, p2, gf, n, h, w, th, tw, s);
  if (c == 62) return launch_pos<62>(xf, of, mf, vf, bf, p0, p2, gf, n, h, w, th, tw, s);
  if (c == 124) return launch_pos<124>(xf, of, mf, vf, bf, p0, p2, gf, n, h, w, th, tw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block, in bytes, of the pos kernel
// (kind 0), the stats kernel (kind 1) or the up-fuse kernel (kind 2) at c;
// 0 for a c not built.
int av_msab_smem(int kind, int c) {
  if (kind == 0 && c == 31) return sizeof(float) * Pos<31>::SMEM_FLOATS;
  if (kind == 0 && c == 62) return sizeof(float) * Pos<62>::SMEM_FLOATS;
  if (kind == 0 && c == 124) return sizeof(float) * Pos<124>::SMEM_FLOATS;
  if (kind == 1 && c == 31) return sizeof(float) * Stats<31>::SMEM_FLOATS;
  if (kind == 1 && c == 62) return sizeof(float) * Stats<62>::SMEM_FLOATS;
  if (kind == 1 && c == 124) return sizeof(float) * Stats<124>::SMEM_FLOATS;
  if (kind == 2 && c == 62) return sizeof(float) * Up<62>::SMEM_FLOATS;
  if (kind == 2 && c == 124) return sizeof(float) * Up<124>::SMEM_FLOATS;
  return 0;
}

// up_fuse: fea (n, h, w, c), skip (n, 2h, 2w, c/2), out (n, 2h, 2w, c/2),
// the composed weights packed as the kernel reads them, wpk
// (4 CF + HP, NP) (ops/fused_msab.py:up_fuse_weights), and bc (2, 2, c/2);
// fea starts on 4 * copy_vec(c) bytes, skip on 4 * copy_vec(c/2), wpk on
// 16; th x tw must be the tile built for c (UpTile).
int av_msab_up_fuse(const void* fea, const void* skip, void* out, const void* wpk, const void* bc, int n, int h,
                    int w, int c, int th, int tw, void* stream) {
  if (!frames_ok(n, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ff = static_cast<const float*>(fea);
  const auto* sf = static_cast<const float*>(skip);
  auto* of = static_cast<float*>(out);
  const auto* wf = static_cast<const float*>(wpk);
  const auto* bf = static_cast<const float*>(bc);
  if (c == 62) return launch_up_fuse<62>(ff, sf, of, wf, bf, n, h, w, th, tw, s);
  if (c == 124) return launch_up_fuse<124>(ff, sf, of, wf, bf, n, h, w, th, tw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
