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
//    channels, so shared memory does not grow with C per chunk. Each
//    chunk's W0[:, chunk] and W4[chunk, :] are fetched into registers one
//    phase ahead and split once per block into B fragments (hi and lo side
//    by side), which every warp then reads ready: W0 for the next chunk and
//    W4 for this one, while 2b runs. Then:
//    a. up product LN(x) W0[:, chunk] over R1 (rows padded to 16): warp w
//       takes m-tile w whole and, where there are more than 8 m-tiles, half
//       the n-tiles of one more, so each A fragment it loads serves several
//       n-tiles and its independent accumulations interleave; GELU, zero
//       outside the image, into a (pixel, HC) tile;
//    b. gelu(dw3(.)) over R0, one thread per (channel, run of 4 pixels),
//       into a second (pixel, HC) tile (the A operand of c);
//    c. down product of that tile and W4[chunk, :]: each warp keeps one
//       m-tile's 16 rows by 32 or 64 output columns in mma fragments across
//       all chunks, splitting each A fragment once for all of them; each
//       chunk's sum added apart.
//    Both products are 3xTF32 mma.sync.m16n8k8 (mma_tf32.cuh): one TF32
//    pass would be about 1e-3 off at these depths. Splitting at every
//    fragment load took most of the kernel's instructions at C = 62 and
//    124; split once, the same fragments meet in the same order, so the
//    result is the same to the bit.
// 3. The accumulators go to a (pixel, CP) tile in shared memory; each tile
//    row (one contiguous NHWC run) is stored, with x added, by consecutive
//    threads at consecutive addresses, in loops of fixed count, so that the
//    reads of x are all in flight together.
// The 4C hidden never reaches device memory. One tile per C (FfnTile):
// 8x16 at C = 31 and 62 (90 and 93 KB), 8x8 at C = 124 (100 KB), the
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
  static constexpr int MT1 = cdiv(N1, 16), MT0 = N0 / 16, KS = CP / 8, NT = CP / 8, NH = HC / 8;
  // up product: warp w takes m-tile w whole (w < MA) and, where MT1 > kWarps,
  // NB of the NH n-tiles of m-tile MA + w / R (R warps share each of the MB
  // m-tiles past the first kWarps)
  static constexpr int MA = MT1 < kWarps ? MT1 : kWarps, MB = MT1 - MA, R = MB ? kWarps / MB : 1, NB = NH / R;
  // down product: WPM warps per m-tile, each WN0 n-tiles
  static constexpr int WPM = kWarps / MT0, WN0 = NT / WPM;
  // split B fragment items (one lane of one fragment) per thread, per matrix
  static constexpr int IT = CP * HC / 2 / kThreads;
  // pitches (floats): A rows 4 (mod 32), float2-stored rows 8
  static constexpr int PY = CP + 4, PH = HC + 8, PH2 = HC + 4, PO = CP + 8;
  static constexpr int Y = N1 * PY, H = N1 * PH, H2 = N0 * PH2, WS = CP * HC * 2;
  static constexpr int SMEM_FLOATS = Y + H + H2 + 2 * WS;
  static_assert(N0 % 16 == 0 && CP % 32 == 0 && kWarps % MT0 == 0 && NT % WPM == 0, "tile does not fit the warps");
  static_assert(CP * HC / 2 % kThreads == 0 && (Y + H + H2) % 4 == 0, "split weights do not fit the threads");
  static_assert(N0 * PO <= Y, "the output tile reuses the LayerNorm tile");
  static_assert(MB == 0 || (MB * R == kWarps && NB * R == NH), "the up product's m-tiles do not fit the warps");
};

// Two blocks per SM: the wrapper checks that the tile's shared memory allows it.
template <int C, int TH, int TW>
__global__ void __launch_bounds__(kThreads, 2)
ffn_kernel(const float* __restrict__ x, float* __restrict__ out, const float* __restrict__ lnw,
           const float* __restrict__ lnb, const float* __restrict__ w0, const float* __restrict__ dwk,
           const float* __restrict__ w4, int h, int w) {
  using P = Ffn<C, TH, TW>;
  constexpr int CP = P::CP, HC = P::HC, C4 = P::C4, W1 = P::W1, N1 = P::N1, N0 = P::N0, IT = P::IT;
  constexpr int PY = P::PY, PH = P::PH, PH2 = P::PH2, PO = P::PO;
  extern __shared__ __align__(16) float ffn_smem[];
  float* s_y = ffn_smem;      // (N1, PY): LN(x) over R1; at the end the output tile (N0, PO)
  float* s_h = s_y + P::Y;    // (N1, PH): a hidden chunk over R1
  float* s_h2 = s_h + P::H;   // (N0, PH2): gelu(dw3(hidden chunk)) over R0
  uint4* s_w0 = reinterpret_cast<uint4*>(s_h2 + P::H2);  // W0[:, chunk] as split B fragments
  uint4* s_w4 = s_w0 + P::WS / 4;                        // W4[chunk, :] as split B fragments
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  auto inside = [&](int gy, int gx) { return gy >= 0 && gy < h && gx >= 0 && gx < w; };
  const float* src = x + static_cast<size_t>(n) * h * w * C;

  // Chunk k's slabs as B fragments, zero beyond C and 4C. Item i is lane
  // i % 32 of fragment i / 32 (k-step major); a thread fetches its items'
  // two values (b0, b1) one phase before it splits and stores them.
  auto fetch_w0 = [&](int k, float (&v)[IT][2]) {
#pragma unroll
    for (int q = 0; q < IT; ++q) {
      const int i = tid + q * kThreads, f = i >> 5, gg = (i & 31) >> 2, tt = i & 3;
      const int c = (f / P::NH) * 8 + tt, hid = k * HC + (f % P::NH) * 8 + gg;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = c + 4 * e < C && hid < C4;
        v[q][e] = ok ? __ldg(w0 + static_cast<size_t>(c + 4 * e) * C4 + hid) : 0.f;
      }
    }
  };
  auto fetch_w4 = [&](int k, float (&v)[IT][2]) {
#pragma unroll
    for (int q = 0; q < IT; ++q) {
      const int i = tid + q * kThreads, f = i >> 5, gg = (i & 31) >> 2, tt = i & 3;
      const int j = k * HC + (f / P::NT) * 8 + tt, c = (f % P::NT) * 8 + gg;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = j + 4 * e < C4 && c < C;
        v[q][e] = ok ? __ldg(w4 + static_cast<size_t>(j + 4 * e) * C + c) : 0.f;
      }
    }
  };
  auto store_w = [&](uint4* dst, const float (&v)[IT][2]) {
#pragma unroll
    for (int q = 0; q < IT; ++q) dst[tid + q * kThreads] = tc::split_b(v[q][0], v[q][1]);
  };

  // x over R1 (zero outside the image and beyond C); chunk 0's W0 is
  // fetched first and split after the LayerNorm.
  float wv0[IT][2], wv4[IT][2];
  fetch_w0(0, wv0);
  {
    constexpr int V = tc::copy_vec(C), UPP = CP / V;  // copies per pixel
    for (int i = tid; i < N1 * UPP; i += kThreads) {
      const int p = i / UPP, c = (i % UPP) * V;
      const int gy = y0 - 1 + p / W1, gx = x0 - 1 + p % W1;
      const bool ok = c < C && inside(gy, gx);
      tc::cp_async<4 * V>(s_y + p * PY + c, ok ? src + (static_cast<size_t>(gy) * w + gx) * C + c : src, ok);
    }
  }
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

  store_w(s_w0, wv0);

  // LN(x)'s A fragment of m-tile mi at k-step ks, split. Rows past N1 read
  // row N1 - 1 and are not stored.
  auto load_y = [&](int mi, int ks) {
    const int r0 = mi * 16 + g;
    return tc::load_a(s_y + min(r0, N1 - 1) * PY + ks * 8, s_y + min(r0 + 8, N1 - 1) * PY + ks * 8, t);
  };
  // An up-product tile into H, its gelu taken already: zero outside the image.
  auto store_h = [&](int mi, int nt, const float (&d)[4]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = mi * 16 + g + 8 * hf;
      if (r >= N1) continue;
      const bool in = inside(y0 - 1 + r / W1, x0 - 1 + r % W1);
      *reinterpret_cast<float2*>(s_h + r * PH + nt * 8 + 2 * t) =
          in ? make_float2(d[2 * hf], d[2 * hf + 1]) : make_float2(0.f, 0.f);
    }
  };

  const int wm = warp / P::WPM, wn = warp % P::WPM;
  const int mb = P::MA + warp / P::R, nb0 = (warp % P::R) * P::NB;
  float acc[P::WN0][4] = {};
  for (int k = 0; k < P::NCHUNK; ++k) {
    fetch_w4(k, wv4);
    if (k + 1 < P::NCHUNK) fetch_w0(k + 1, wv0);
    __syncthreads();  // chunk k's W0 is stored; Y is written (k = 0); chunk k - 1's 2c is done

    // 2a. H = gelu(Y W0[:, chunk]) over R1: each split A fragment serves
    //     all the n-tiles the warp takes of its m-tile.
    if (warp < P::MA) {
      float da[P::NH][4] = {}, db[P::NB][4] = {};
#pragma unroll 4
      for (int ks = 0; ks < P::KS; ++ks) {
        const tc::FragA a = load_y(warp, ks);
#pragma unroll
        for (int j = 0; j < P::NH; ++j) tc::mma3(da[j], a, tc::load_b_split(s_w0 + (ks * P::NH + j) * 32, lane));
        if constexpr (P::MB > 0) {
          const tc::FragA ab = load_y(mb, ks);
#pragma unroll
          for (int j = 0; j < P::NB; ++j)
            tc::mma3(db[j], ab, tc::load_b_split(s_w0 + (ks * P::NH + nb0 + j) * 32, lane));
        }
      }
      // every gelu first, so that their chains interleave
#pragma unroll
      for (int j = 0; j < P::NH; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) da[j][q] = gelu(da[j][q]);
#pragma unroll
      for (int j = 0; j < P::NB; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) db[j][q] = gelu(db[j][q]);
#pragma unroll
      for (int j = 0; j < P::NH; ++j) store_h(warp, j, da[j]);
      if constexpr (P::MB > 0) {
#pragma unroll
        for (int j = 0; j < P::NB; ++j) store_h(mb, nb0 + j, db[j]);
      }
    }
    __syncthreads();

    // 2b. H2 = gelu(dw3(H)) over R0: a thread takes one channel of a run
    //     of 4 pixels in a tile row (18 reads of H for 4 outputs). Then this
    //     chunk's W4 and the next chunk's W0 are split into place (no warp
    //     reads W0 until the next chunk, nor W4 until 2c).
    {
      constexpr int RUNS = N0 / 4, PER = RUNS * HC / kThreads;
      static_assert(RUNS * HC % kThreads == 0, "the depthwise's runs do not fit the threads");
      const int c = tid % HC, hid = k * HC + c;
      float kw[9];
#pragma unroll
      for (int d = 0; d < 9; ++d) kw[d] = hid < C4 ? __ldg(dwk + d * C4 + hid) : 0.f;
      float v[PER][4] = {};
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int run = tid / HC + q * (kThreads / HC);
        const int ly = run / (TW / 4), lx = (run % (TW / 4)) * 4;
        const float* hh = s_h + (ly * W1 + lx) * PH + c;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int ix = 0; ix < 6; ++ix) {
            const float hv = hh[(dy * W1 + ix) * PH];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (ix - j >= 0 && ix - j < 3) v[q][j] = fmaf(hv, kw[dy * 3 + ix - j], v[q][j]);
          }
      }
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int run = tid / HC + q * (kThreads / HC);
        const int ly = run / (TW / 4), lx = (run % (TW / 4)) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) s_h2[(ly * TW + lx + j) * PH2 + c] = gelu(v[q][j]);
      }
    }
    store_w(s_w4, wv4);
    if (k + 1 < P::NCHUNK) store_w(s_w0, wv0);
    __syncthreads();

    // 2c. acc += H2 W4[chunk, :], this chunk's sum apart.
    float part[P::WN0][4] = {};
    const int r = wm * 16 + g;
#pragma unroll
    for (int ks = 0; ks < P::NH; ++ks) {
      const tc::FragA a = tc::load_a(s_h2 + r * PH2 + ks * 8, s_h2 + (r + 8) * PH2 + ks * 8, t);
#pragma unroll
      for (int j = 0; j < P::WN0; ++j)
        tc::mma3(part[j], a, tc::load_b_split(s_w4 + (ks * P::NT + wn * P::WN0 + j) * 32, lane));
    }
#pragma unroll
    for (int j = 0; j < P::WN0; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] += part[j][q];
  }

  // 3. The output tile into Y's space (no warp reads Y after the last
  //    chunk's 2a), then out = acc + x over each tile row's NHWC run.
  float* s_o = s_y;
#pragma unroll
  for (int j = 0; j < P::WN0; ++j) {
    const int r = wm * 16 + g, col = (wn * P::WN0 + j) * 8 + 2 * t;
    *reinterpret_cast<float2*>(s_o + r * PO + col) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(s_o + (r + 8) * PO + col) = make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  const int run = min(TW, w - x0) * C;
#pragma unroll
  for (int ly = 0; ly < TH; ++ly) {
    const size_t row = ((static_cast<size_t>(n) * h + y0 + ly) * w + x0) * C;
#pragma unroll
    for (int i = 0; i < cdiv(TW * C, kThreads); ++i) {
      const int e = tid + i * kThreads;
      if (y0 + ly < h && e < run) {
        const int p = e / C, c = e - p * C;
        out[row + e] = s_o[(ly * TW + p) * PO + c] + __ldg(x + row + e);
      }
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

// Blocks of ffn_kernel at C that one SM holds at once, with its shared memory.
template <int C>
int ffn_blocks_per_sm(int* blocks) {
  constexpr int TH = FfnTile<C>::TH, TW = FfnTile<C>::TW;
  const size_t smem = sizeof(float) * Ffn<C, TH, TW>::SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(ffn_kernel<C, TH, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ffn_kernel<C, TH, TW>, kThreads, smem));
}

}  // namespace

extern "C" {

// ffn: x/out (n, h, w, c), lnw/lnb (c), w0 (c, 4c), dwk (3, 3, 4c),
// w4 (4c, c); th x tw must be the tile built for c (FfnTile).
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

// The blocks of the kernel built for c that one SM of the current device
// holds at once.
int av_mst_ffn_blocks_per_sm(int c, int* blocks) {
  if (c == 31) return ffn_blocks_per_sm<31>(blocks);
  if (c == 62) return ffn_blocks_per_sm<62>(blocks);
  if (c == 124) return ffn_blocks_per_sm<124>(blocks);
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
