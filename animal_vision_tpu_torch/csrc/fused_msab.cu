// The MST++ kernels, hand-written for Hopper (sm_90a).
//
// Replace the Pallas kernels of animal_vision_tpu/ops/fused_msab.py:
// - conv_kernel<K, S>: _conv3_io_kernel (conv_in, 3 -> 31), _conv3_kernel,
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
// Design. Every product runs as a "warp GEMM" (warp_gemm below): an input
// tile sits in shared memory planar, [channel][pixel], the 32 lanes of a
// warp take 32 pixels each step and the warp takes groups of 4 consecutive
// outputs, so a lane reads conflict-free shared memory and every lane of a
// warp reads the same weight (one broadcast load, from L1). Weights stay in
// device memory (L1/L2-resident; 1.62 M parameters in all).
// - conv_kernel: a block stages its input tile with the zero pad (all Cin
//   channels) and sums over (Cin, ky, kx) for an 8x16 (K = 3) or 8x8 (K = 4)
//   output tile; the residual is added in the epilogue.
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

template <int K, int S>
struct ConvTile;
template <>
struct ConvTile<3, 1> {
  static constexpr int kH = 8, kW = 16;
};
template <>
struct ConvTile<4, 2> {
  static constexpr int kH = 8, kW = 8;
};

template <int K, int S>
__host__ __device__ constexpr int conv_in_h() { return (ConvTile<K, S>::kH - 1) * S + K; }
template <int K, int S>
__host__ __device__ constexpr int conv_in_w() { return (ConvTile<K, S>::kW - 1) * S + K; }

template <int K, int S>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const float* __restrict__ x, const float* __restrict__ wt, const float* __restrict__ res,
            float* __restrict__ out, int h, int w, int cin, int cout, int ho, int wo) {
  constexpr int TH = ConvTile<K, S>::kH, TW = ConvTile<K, S>::kW;
  constexpr int IH = conv_in_h<K, S>(), IW = conv_in_w<K, S>(), NI = IH * IW;
  constexpr int NP = TH * TW;
  extern __shared__ float s_in[];  // (cin, IH, IW)
  const int n = blockIdx.z;
  const int ox0 = blockIdx.x * TW, oy0 = blockIdx.y * TH;
  const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;  // pad 1
  const float* src = x + static_cast<size_t>(n) * h * w * cin;
  for (int i = threadIdx.x; i < NI * cin; i += kThreads) {
    const int p = i / cin, c = i - p * cin;
    const int gy = iy0 + p / IW, gx = ix0 + p % IW;
    s_in[c * NI + p] =
        (gy >= 0 && gy < h && gx >= 0 && gx < w) ? src[(static_cast<size_t>(gy) * w + gx) * cin + c] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int NS = NP / 32;
  int off[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int p = lane + 32 * s;
    off[s] = (p / TW) * S * IW + (p % TW) * S;
  }
  float* dst = out + static_cast<size_t>(n) * ho * wo * cout;
  const float* rsrc = res == nullptr ? nullptr : res + static_cast<size_t>(n) * ho * wo * cout;
  for (int o0 = warp * kGroup; o0 < cout; o0 += kWarps * kGroup) {
    const int nq = min(kGroup, cout - o0);
    float acc[NS][kGroup];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int q = 0; q < kGroup; ++q) acc[s][q] = 0.f;
    for (int c = 0; c < cin; ++c) {
      const float* plane = s_in + c * NI;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const float* wk = wt + (static_cast<size_t>((dy * K + dx) * cin + c)) * cout + o0;
          float b[kGroup];
#pragma unroll
          for (int q = 0; q < kGroup; ++q) b[q] = q < nq ? __ldg(wk + q) : 0.f;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float a = plane[off[s] + dy * IW + dx];
#pragma unroll
            for (int q = 0; q < kGroup; ++q) acc[s][q] = fmaf(a, b[q], acc[s][q]);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int p = lane + 32 * s;
      const int oy = oy0 + p / TW, ox = ox0 + p % TW;
      if (oy >= ho || ox >= wo) continue;
      const size_t base = (static_cast<size_t>(oy) * wo + ox) * cout + o0;
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        if (q >= nq) continue;
        dst[base + q] = rsrc == nullptr ? acc[s][q] : acc[s][q] + rsrc[base + q];
      }
    }
  }
}

template <int K, int S>
size_t conv_smem_bytes(int cin) {
  return sizeof(float) * static_cast<size_t>(conv_in_h<K, S>()) * conv_in_w<K, S>() * cin;
}

template <int K, int S>
int launch_conv(const float* x, const float* wt, const float* res, float* out, int n, int h, int w, int cin,
                int cout, cudaStream_t stream) {
  const int ho = (h + 2 - K) / S + 1, wo = (w + 2 - K) / S + 1;
  if (ho < 1 || wo < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = conv_smem_bytes<K, S>(cin);
  cudaError_t err =
      cudaFuncSetAttribute(conv_kernel<K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(wo, ConvTile<K, S>::kW), cdiv(ho, ConvTile<K, S>::kH), n);
  conv_kernel<K, S><<<grid, kThreads, smem, stream>>>(x, wt, res, out, h, w, cin, cout, ho, wo);
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
// null, out (n, ho, wo, cout); k = 3 (stride 1) or 4 (stride 2), pad 1.
int av_msab_conv(const void* x, const void* wt, const void* res, void* out, int n, int h, int w, int cin,
                 int cout, int k, void* stream) {
  if (!frames_ok(n, h, w) || cin < 1 || cout < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(wt);
  const auto* rf = static_cast<const float*>(res);
  auto* of = static_cast<float*>(out);
  if (k == 3) return launch_conv<3, 1>(xf, wf, rf, of, n, h, w, cin, cout, s);
  if (k == 4) return launch_conv<4, 2>(xf, wf, rf, of, n, h, w, cin, cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
