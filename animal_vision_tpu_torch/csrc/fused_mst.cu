// The prenorm FFN of the mask-guided MST (MST-L), hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas _ffn_kernel of animal_vision_tpu/ops/fused_mst.py:
// out = x + W4 gelu(dw3(gelu(W0 LN(x)))) on NHWC float32 frames with
// C in {31, 62, 124} and a hidden width of 4C. LN takes the biased variance
// with eps 1e-5 inside the square root; GELU is the exact
// 0.5 x (1 + erf(x / sqrt 2)) with erff; the depthwise 3x3 zero-pads the
// hidden map at all four image edges.
//
// The TPU kernel's layout is not carried over: no token flattening, no
// w + 8 row halo, no sublane padding, no erf polynomial.
//
// Bound on this card. Per pixel the two 1x1 maps take 8 C^2 multiply-adds
// (16 C^2 flops) against 8 C bytes of traffic: 62 flops per byte at C = 31,
// so in float32 outside the tensor cores the kernel is bound by operations
// (0.56 ms at 1080p, C = 31). On the tensor cores in 3xTF32 the products
// take 3 x 16 C^2 flops at 495 TFLOP/s and the depthwise, the two GELUs
// and the LayerNorm (about 90 C flops per pixel) stay on the float32
// units; the bound is then about 0.2 ms at 1080p, C = 31.
//
// Design. One block of 8 warps per TH x TW output tile; R1 is the tile and
// its 1-pixel halo (the depthwise's reach), R0 the tile.
// 1. x over R1 comes into shared memory by cp.async (zero fill outside
//    the image and beyond C), pixel-major at a pitch of CP + 4 floats (CP:
//    C padded to a multiple of 8); then LayerNorm in place, one warp per
//    pixel (the lanes take the channels; two shuffle reductions for the
//    mean and the biased variance).
// 2. The 4C hidden in chunks of HC = 32 (C = 31) or 16 (C = 62, 124)
//    channels, so shared memory does not grow with C per chunk. For each
//    chunk, W0[:, chunk] and W4[chunk, :] arrive through a double-buffered
//    cp.async ring (the next chunk's slabs load during this chunk) and:
//    a. up product LN(x) W0[:, chunk] over R1 (rows padded to 16; the
//       warps share the (16-row, 8- or 16-column) units), GELU, zero
//       outside the image, into a (pixel, HC) tile;
//    b. gelu(dw3(.)) over R0, one thread per (channel, run of 4 pixels),
//       into a second (pixel, HC) tile (the A operand of c);
//    c. down product of that tile and W4[chunk, :]: each warp keeps a
//       (16 or 32) x (16 or 32) block of the (R0, CP) output in mma
//       fragments across all chunks, each chunk's sum added apart.
//    Both products are 3xTF32 mma.sync.m16n8k8 (mma_tf32.cuh): one TF32
//    pass would be about 1e-3 off at these depths.
// 3. The accumulators go to a (pixel, CP) tile in shared memory; each tile
//    row (one contiguous NHWC run) is stored, with x added, by consecutive
//    threads at consecutive addresses.
// The 4C hidden never reaches device memory. One tile per C (FfnTile):
// 8x16 at C = 31 and 62 (94 and 98 KB), 8x8 at C = 124 (110 KB), the
// largest of which two blocks fit an H100 SM; the wrapper raises where two
// do not fit.
//
// C interface (loaded with ctypes): the entry point takes raw device
// pointers and the stream, launches on that stream without synchronising,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float gelu(float x) { return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int C, int TH, int TW>
struct Ffn {
  static constexpr int CP = cdiv(C, 8) * 8;    // channels padded for the MMA
  static constexpr int HC = C > 31 ? 16 : 32;  // hidden channels per chunk
  static constexpr int C4 = 4 * C, NCHUNK = cdiv(C4, HC);
  static constexpr int W1 = TW + 2, N1 = (TH + 2) * W1, N0 = TH * TW;
  static constexpr int MT1 = cdiv(N1, 16), MT0 = N0 / 16, NT = CP / 8, NH = HC / 8;
  // up product: units of one 16-row m-tile and UN 8-column n-tiles
  static constexpr int UN = (MT1 * (NH / 2)) % kWarps == 0 ? 2 : 1, UNITS = MT1 * (NH / UN);
  // down product: each warp a WM0 x WN0 block of (m-tile, n-tile)s
  static constexpr int TPW = MT0 * NT / kWarps, WM0 = TPW >= 4 ? 2 : 1, WN0 = TPW / WM0, WARPS_N = NT / WN0;
  // pitches (floats): A rows 4 (mod 32), B rows and float2-stored rows 8
  static constexpr int PY = CP + 4, PH = HC + 8, PH2 = HC + 4, PW0 = HC + 8, PW4 = CP + 8, PO = CP + 8;
  static constexpr int Y = N1 * PY, H = N1 * PH, H2 = N0 * PH2, STAGE = CP * PW0 + HC * PW4;
  static constexpr int SMEM_FLOATS = Y + H + H2 + 2 * STAGE;
  static_assert(N0 % 16 == 0 && CP % 32 == 0 && (MT0 / WM0) * WARPS_N == kWarps, "tile does not fit the warps");
  static_assert(N0 * PO <= Y, "the output tile reuses the LayerNorm tile");
};

// Two blocks per SM: the wrapper checks that the tile's shared memory allows it.
template <int C, int TH, int TW>
__global__ void __launch_bounds__(kThreads, 2)
ffn_kernel(const float* __restrict__ x, float* __restrict__ out, const float* __restrict__ lnw,
           const float* __restrict__ lnb, const float* __restrict__ w0, const float* __restrict__ dwk,
           const float* __restrict__ w4, int h, int w) {
  using P = Ffn<C, TH, TW>;
  constexpr int CP = P::CP, HC = P::HC, C4 = P::C4, W1 = P::W1, N1 = P::N1, N0 = P::N0;
  constexpr int PY = P::PY, PH = P::PH, PH2 = P::PH2, PW0 = P::PW0, PW4 = P::PW4, PO = P::PO;
  extern __shared__ __align__(16) float ffn_smem[];
  float* s_y = ffn_smem;      // (N1, PY): LN(x) over R1; at the end the output tile (N0, PO)
  float* s_h = s_y + P::Y;    // (N1, PH): a hidden chunk over R1
  float* s_h2 = s_h + P::H;   // (N0, PH2): gelu(dw3(hidden chunk)) over R0
  float* s_w = s_h2 + P::H2;  // two stages of [W0 chunk (CP, PW0) | W4 chunk (HC, PW4)]
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  auto inside = [&](int gy, int gx) { return gy >= 0 && gy < h && gx >= 0 && gx < w; };
  const float* src = x + static_cast<size_t>(n) * h * w * C;

  // Chunk k's slabs, zero beyond C and 4C. W0 rows (4C floats) start on
  // 16 bytes; W4 rows (C floats) on 16, 8 or 4.
  auto load_w = [&](int k, float* dst) {
    const int k0 = k * HC;
    for (int i = tid; i < CP * (HC / 4); i += kThreads) {
      const int c = i / (HC / 4), j = (i % (HC / 4)) * 4;
      const bool ok = c < C && k0 + j < C4;
      tc::cp_async<16>(dst + c * PW0 + j, ok ? w0 + static_cast<size_t>(c) * C4 + k0 + j : w0, ok);
    }
    constexpr int V = tc::copy_vec(C), UPR = CP / V;
    float* d4 = dst + CP * PW0;
    for (int i = tid; i < HC * UPR; i += kThreads) {
      const int j = i / UPR, c = (i % UPR) * V;
      const bool ok = k0 + j < C4 && c < C;
      tc::cp_async<4 * V>(d4 + j * PW4 + c, ok ? w4 + static_cast<size_t>(k0 + j) * C + c : w4, ok);
    }
  };
  // x over R1 into Y's space (zero outside the image and beyond C), in
  // the same cp.async group as chunk 0's slabs.
  {
    constexpr int V = tc::copy_vec(C), UPP = CP / V;  // copies per pixel
    for (int i = tid; i < N1 * UPP; i += kThreads) {
      const int p = i / UPP, c = (i % UPP) * V;
      const int gy = y0 - 1 + p / W1, gx = x0 - 1 + p % W1;
      const bool ok = c < C && inside(gy, gx);
      tc::cp_async<4 * V>(s_y + p * PY + c, ok ? src + (static_cast<size_t>(gy) * w + gx) * C + c : src, ok);
    }
  }
  load_w(0, s_w);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  // 1. Y = LayerNorm(x) over R1, a warp per pixel: each lane reads its
  //    channels into registers and writes back only those. Pixels outside
  //    the image stay 0 (their hidden values are zeroed in 2a anyway).
  constexpr int NQ = CP / 32;
#pragma unroll 2
  for (int p = warp; p < N1; p += kWarps) {
    if (!inside(y0 - 1 + p / W1, x0 - 1 + p % W1)) continue;
    float* row = s_y + p * PY;
    float v[NQ];
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      v[q] = row[lane + 32 * q];  // 0 beyond C
      sum += v[q];
    }
    const float mu = warp_sum(sum) / C;
    float sq = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float d = lane + 32 * q < C ? v[q] - mu : 0.f;
      sq = fmaf(d, d, sq);
    }
    const float inv = 1.0f / sqrtf(warp_sum(sq) / C + 1e-5f);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = lane + 32 * q;
      if (c < C) row[c] = (v[q] - mu) * inv * __ldg(lnw + c) + __ldg(lnb + c);
    }
  }

  const int wm = warp / P::WARPS_N, wn = warp % P::WARPS_N;
  float acc[P::WM0][P::WN0][4] = {};
  for (int k = 0; k < P::NCHUNK; ++k) {
    tc::cp_async_wait<0>();
    __syncthreads();  // chunk k's slabs landed; Y is written (k = 0); chunk k - 1's 2c is done
    if (k + 1 < P::NCHUNK) {
      load_w(k + 1, s_w + ((k + 1) & 1) * P::STAGE);
      tc::cp_async_commit();
    }
    const float* sw0 = s_w + (k & 1) * P::STAGE;
    const float* sw4 = sw0 + CP * PW0;

    // 2a. H = gelu(Y W0[:, chunk]) over R1, zero outside the image. Rows
    //     past N1 read row N1 - 1 and are not stored.
#pragma unroll
    for (int q = 0; q < cdiv(P::UNITS, kWarps); ++q) {
      const int u = warp + q * kWarps;
      if (u >= P::UNITS) break;
      const int mi = u / (P::NH / P::UN), nj = (u % (P::NH / P::UN)) * P::UN;
      const int r0 = mi * 16 + g, r1 = r0 + 8;
      const float* y0p = s_y + min(r0, N1 - 1) * PY;
      const float* y1p = s_y + min(r1, N1 - 1) * PY;
      float d[P::UN][4] = {};
#pragma unroll
      for (int kk = 0; kk < CP; kk += 8) {
        const tc::FragA a = tc::load_a(y0p + kk, y1p + kk, t);
#pragma unroll
        for (int j = 0; j < P::UN; ++j) tc::mma3(d[j], a, tc::load_b(sw0 + kk * PW0 + (nj + j) * 8, PW0, g, t));
      }
#pragma unroll
      for (int j = 0; j < P::UN; ++j) {
        const int col = (nj + j) * 8 + 2 * t;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = hf ? r1 : r0;
          if (r >= N1) continue;
          const bool in = inside(y0 - 1 + r / W1, x0 - 1 + r % W1);
          *reinterpret_cast<float2*>(s_h + r * PH + col) =
              in ? make_float2(gelu(d[j][2 * hf]), gelu(d[j][2 * hf + 1])) : make_float2(0.f, 0.f);
        }
      }
    }
    __syncthreads();

    // 2b. H2 = gelu(dw3(H)) over R0: a thread takes one channel of a run
    //     of 4 pixels in a tile row (18 reads of H for 4 outputs).
    {
      constexpr int RUNS = N0 / 4, PER = cdiv(RUNS * HC, kThreads);
      const int c = tid % HC, hid = k * HC + c;
      float kw[9];
#pragma unroll
      for (int d = 0; d < 9; ++d) kw[d] = hid < C4 ? __ldg(dwk + d * C4 + hid) : 0.f;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int run = tid / HC + q * (kThreads / HC);
        if (run >= RUNS) break;
        const int ly = run / (TW / 4), lx = (run % (TW / 4)) * 4;
        const float* hh = s_h + (ly * W1 + lx) * PH + c;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int ix = 0; ix < 6; ++ix) {
            const float hv = hh[(dy * W1 + ix) * PH];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (ix - j >= 0 && ix - j < 3) v[j] = fmaf(hv, kw[dy * 3 + ix - j], v[j]);
          }
#pragma unroll
        for (int j = 0; j < 4; ++j) s_h2[(ly * TW + lx + j) * PH2 + c] = gelu(v[j]);
      }
    }
    __syncthreads();

    // 2c. acc += H2 W4[chunk, :], this chunk's sum apart.
    float part[P::WM0][P::WN0][4] = {};
#pragma unroll
    for (int kk = 0; kk < HC; kk += 8) {
      tc::FragA a[P::WM0];
#pragma unroll
      for (int i = 0; i < P::WM0; ++i) {
        const int r = (wm * P::WM0 + i) * 16 + g;
        a[i] = tc::load_a(s_h2 + r * PH2 + kk, s_h2 + (r + 8) * PH2 + kk, t);
      }
#pragma unroll
      for (int j = 0; j < P::WN0; ++j) {
        const tc::FragB b = tc::load_b(sw4 + kk * PW4 + (wn * P::WN0 + j) * 8, PW4, g, t);
#pragma unroll
        for (int i = 0; i < P::WM0; ++i) tc::mma3(part[i][j], a[i], b);
      }
    }
#pragma unroll
    for (int i = 0; i < P::WM0; ++i)
#pragma unroll
      for (int j = 0; j < P::WN0; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
  }

  // 3. The output tile into Y's space (no warp reads Y after the last
  //    chunk's 2a), then out = acc + x over each tile row's NHWC run.
  float* s_o = s_y;
#pragma unroll
  for (int i = 0; i < P::WM0; ++i)
#pragma unroll
    for (int j = 0; j < P::WN0; ++j) {
      const int r = (wm * P::WM0 + i) * 16 + g, col = (wn * P::WN0 + j) * 8 + 2 * t;
      *reinterpret_cast<float2*>(s_o + r * PO + col) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(s_o + (r + 8) * PO + col) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  const int run = min(TW, w - x0) * C;
  for (int ly = 0; ly < TH && y0 + ly < h; ++ly) {
    const size_t row = ((static_cast<size_t>(n) * h + y0 + ly) * w + x0) * C;
    for (int e = tid; e < run; e += kThreads) {
      const int p = e / C, c = e - p * C;
      out[row + e] = s_o[(ly * TW + p) * PO + c] + __ldg(x + row + e);
    }
  }
}

// The output tile built for each C (TILES in ops/fused_mst.py).
template <int C>
struct FfnTile {
  static constexpr int TH = 8, TW = C < 124 ? 16 : 8;
};

template <int C>
int launch_ffn(const float* x, float* out, const float* lnw, const float* lnb, const float* w0, const float* dwk,
               const float* w4, int n, int h, int w, int th, int tw, cudaStream_t stream) {
  constexpr int TH = FfnTile<C>::TH, TW = FfnTile<C>::TW;
  if (th != TH || tw != TW) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * Ffn<C, TH, TW>::SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(ffn_kernel<C, TH, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(w, TW), cdiv(h, TH), n);
  ffn_kernel<C, TH, TW><<<grid, kThreads, smem, stream>>>(x, out, lnw, lnb, w0, dwk, w4, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ffn: x/out (n, h, w, c), lnw/lnb (c), w0 (c, 4c) 16-byte aligned,
// dwk (3, 3, 4c), w4 (4c, c); th x tw must be the tile built for c
// (FfnTile).
int av_mst_ffn(const void* x, void* out, const void* lnw, const void* lnb, const void* w0, const void* dwk,
               const void* w4, int n, int h, int w, int c, int th, int tw, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(out);
  const auto* gf = static_cast<const float*>(lnw);
  const auto* bf = static_cast<const float*>(lnb);
  const auto* uf = static_cast<const float*>(w0);
  const auto* df = static_cast<const float*>(dwk);
  const auto* vf = static_cast<const float*>(w4);
  if (c == 31) return launch_ffn<31>(xf, of, gf, bf, uf, df, vf, n, h, w, th, tw, s);
  if (c == 62) return launch_ffn<62>(xf, of, gf, bf, uf, df, vf, n, h, w, th, tw, s);
  if (c == 124) return launch_ffn<124>(xf, of, gf, bf, uf, df, vf, n, h, w, th, tw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The shared memory of one SM, in bytes, and what the card reserves of it
// per block, on the current device.
int av_mst_smem_limit(int* sm_bytes, int* reserved_per_block) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceGetAttribute(reserved_per_block, cudaDevAttrReservedSharedMemoryPerBlock, dev));
}

}  // extern "C"
