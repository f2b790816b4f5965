// The three fused non-UV species kernels, hand-written for Hopper (sm_90a).
//
// Each kernel runs a whole species chain in one pass over device memory:
// uint8 RGB frame -> per-frame 1/255 scale -> sRGB->linear -> colour / blur
// -> linear->sRGB -> uint8 frame. Frames are (N, H, W, 3) interleaved and
// read in that layout (the frame is blockIdx.z in iso_kernel, blockIdx.y
// in pointwise_kernel; streak_kernel's blocks share the batch's rows); the
// per-frame scale is an (N,) float32 array on the device. Tables (colour
// matrix, blur taps, per-row streak and gain tables) are shared by all
// frames of a batch.
//
// Numerics: accurate powf and IEEE division (built without
// --use_fast_math), float32 accumulation. The plain PyTorch versions in
// ops/fused_nonuv.py compute the same function; kernels agree with them to
// <= 1 uint8 LSB. All three take the sRGB curves of uint8 frames as
// tables (srgb.cuh): a 256-entry decode table per block, bit for bit the
// powf curve, and the encode by exact thresholds, equal to the powf encode
// at every float. Its device table is made once per device by
// av_encode_table (ops/fused_nonuv.py:encode_table) and passed to each.
//
// C interface (loaded with ctypes): every entry point takes raw device
// pointers and the stream, launches on that stream without synchronising,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_tf32.cuh"
#include "srgb.cuh"

namespace {

using srgb::clamp01;
using srgb::linearize;
using srgb::load_scaled;

__host__ __device__ constexpr size_t align16(size_t bytes) { return (bytes + 15) & ~static_cast<size_t>(15); }

// Copy chunk c (16 bytes) of a staged output row to device memory: the row
// holds the output's bytes at [shift, shift + len), where base (16-byte
// aligned) + shift is their destination. A chunk inside that range goes as
// one 16-byte store, the partial first and last chunks byte by byte, so no
// byte outside the range is written.
__device__ __forceinline__ void store_chunk(const uint8_t* __restrict__ s_row, uint8_t* __restrict__ base,
                                            int shift, int len, int c) {
  const int lo = 16 * c, hi = lo + 16;
  if (lo >= shift && hi <= shift + len) {
    *reinterpret_cast<uint4*>(base + lo) = *reinterpret_cast<const uint4*>(s_row + lo);
  } else {
    for (int b = max(lo, shift); b < min(hi, shift + len); ++b) base[b] = s_row[b];
  }
}

// The 16-byte-aligned start of a span and the span's offset from it.
__device__ __forceinline__ const unsigned char* aligned_start(const void* p, int* shift) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  *shift = static_cast<int>(a & 15);
  return reinterpret_cast<const unsigned char*>(a & ~static_cast<uintptr_t>(15));
}

// ---------------------------------------------------------------------------
// Kernel 1: isotropic blur species (dog, wolf, lion, ... and the cat).
//
// Replaces animal_vision_tpu/ops/fused_nonuv.py:_iso_kernel (reached through
// fused_matrix_blur / fused_iso_u8). The TPU kernel folds the W blur, the
// mix and the borders into banded MXU matrices; on Hopper that band is
// mostly zeros (29 taps in a 92-pixel band at k = 29) and would need
// 3xTF32 to keep 1 LSB, so the taps stay float32 FMAs on the SIMT units.
//
// Bound on this card: float32 operations. A 1080p frame moves 12 MB (3.7 us
// at 3.35 TB/s), but the separable blur costs 2 x 3 x ksize multiply-adds
// per pixel (k = 29 for the dog: 174) against 6 bytes; three powf per
// staged pixel and per output element, per-pixel divisions and reflections,
// 1-byte loads and one output per thread would cost more than that. This
// design feeds the FMA units instead:
// - One block per (frame, strip of 64 output columns, run of `rows` output
//   rows; ops/fused_nonuv.py:iso_run_rows, 128 on a 1080p batch). It walks
//   down its run 8 rows per step with one barrier per step. Input row spans
//   come in by 16-byte cp.async into a ring of kIsoStages groups: the
//   16-byte-aligned superset of each span's bytes, read from its offset.
// - Each staged pixel is decoded (uint8: the block's 256-entry table;
//   float32 frames, the cat: linearize by powf) and mixed once, into a
//   float span of 64 + kp pixels (kp: ksize rounded up to 4; the extra
//   taps are zero). Column sources come from a per-block table (reflect101
//   of each span column, clamped into the staged range); rows take
//   reflect101 only outside the frame. No inner loop divides.
// - The W pass runs into a ring of W-pass rows and the H pass from that
//   ring, as in csrc/fused_blur.cu: each thread computes 8 neighbouring
//   outputs (8 pixels of one channel, then 8 rows of one element) from a
//   register window, taps 4 per 16-byte shared load, in tap order t =
//   0..k-1. The H pass of a group runs a step after the W pass of its last
//   rows, so one barrier per step covers both rings.
// - Encode by thresholds into a shared output row, placed at the
//   destination's offset within 16 bytes, then 16-byte stores.
// 192 threads (64 pixels x 3 channels: one W-pass and one H-pass unit
// each per step), about 71 KB of shared memory at k = 29 (uint8). For
// float32 frames the powf decode of each staged pixel takes about half of
// the time (PERF.md, section 6).
// ---------------------------------------------------------------------------

constexpr int kIsoTileW = 64;     // output strip width, pixels
constexpr int kIsoGroup = 8;      // rows per step, and outputs per thread in each pass
constexpr int kIsoStages = 4;     // staged input groups in the ring
constexpr int kIsoThreads = 192;  // 64 pixels x 3 channels
constexpr int kIsoRow = kIsoTileW * 3;     // floats per W-pass row, bytes per output row
constexpr int kIsoOutPitch = kIsoRow + 16;  // a staged output row and its 16-byte offset
constexpr int kIsoMaxTaps = 55;

__host__ __device__ constexpr int iso_taps_padded(int ksize) { return (ksize + 3) & ~3; }
__host__ __device__ constexpr int iso_span(int ksize) { return kIsoTileW + iso_taps_padded(ksize); }
// Groups an output group reaches below itself: its rows 8g .. 8g + 7 + kp - 1.
__host__ __device__ constexpr int iso_lag(int ksize) { return (iso_taps_padded(ksize) + 6) / kIsoGroup; }
// W-pass ring: the lag + 1 groups an H pass reads and the group the W pass writes.
__host__ __device__ constexpr int iso_ring_rows(int ksize) { return kIsoGroup * (iso_lag(ksize) + 2); }

// Byte offsets of a block's shared memory; `elem` is 1 (uint8 frames) or 4.
struct IsoLayout {
  int kp, span, ring, pitch;  // pitch: bytes per staged input row
  size_t taps, lut, enc, fspan, wring, col, shift, raw, out, total;
};

__host__ __device__ inline IsoLayout iso_layout(int ksize, int elem) {
  IsoLayout l{};
  l.kp = iso_taps_padded(ksize);
  l.span = iso_span(ksize);
  l.ring = iso_ring_rows(ksize);
  l.pitch = 16 * ((l.span * 3 * elem + 15) / 16 + 1);
  size_t o = 0;
  l.taps = o;  o += align16(4 * l.kp);
  l.lut = o;   o += align16(4 * srgb::kLevels);
  l.enc = o;   o += align16(srgb::kBlockEncBytes);
  l.fspan = o; o += align16(4 * 2 * kIsoGroup * l.span * 3);
  l.wring = o; o += align16(4 * static_cast<size_t>(l.ring) * kIsoRow);
  l.col = o;   o += align16(4 * l.span);
  l.shift = o; o += align16(4 * kIsoStages * kIsoGroup);
  l.raw = o;   o += align16(static_cast<size_t>(kIsoStages) * kIsoGroup * l.pitch);
  l.out = o;   o += align16(2 * kIsoGroup * kIsoOutPitch);
  l.total = o;
  return l;
}

// acc[j] = sum_t in[t + j] taps[t] for j < kIsoGroup, t = 0..kp-1 in order
// (kp a multiple of 4), the taps read 4 at a time; load(q) returns in[4q ..
// 4q + 3], so the window of inputs stays in registers.
template <typename Load>
__device__ __forceinline__ void conv_run(const float4* __restrict__ taps4, int kp, Load load,
                                         float (&acc)[kIsoGroup]) {
  float win[kIsoGroup + 4];
  auto put = [&](int m, float4 v) {
    win[m] = v.x;
    win[m + 1] = v.y;
    win[m + 2] = v.z;
    win[m + 3] = v.w;
  };
#pragma unroll
  for (int m = 0; m < kIsoGroup; m += 4) put(m, load(m / 4));
#pragma unroll
  for (int j = 0; j < kIsoGroup; ++j) acc[j] = 0.f;
  for (int q = 0; q < kp / 4; ++q) {
    const float4 t4 = taps4[q];
    const float tp[4] = {t4.x, t4.y, t4.z, t4.w};
    put(kIsoGroup, load(q + kIsoGroup / 4));
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < kIsoGroup; ++j) acc[j] = fmaf(win[m + j], tp[m], acc[j]);
#pragma unroll
    for (int m = 0; m < kIsoGroup; ++m) win[m] = win[m + 4];
  }
}

template <typename T>
__device__ __forceinline__ float iso_decode(T v, float sc, const float* __restrict__ s_lut) {
  if constexpr (sizeof(T) == 1) {
    return s_lut[v];
  } else {
    return linearize(load_scaled(v, sc));
  }
}

template <typename T>
__global__ void __launch_bounds__(kIsoThreads)
iso_kernel(const T* __restrict__ img, uint8_t* __restrict__ out, const float* __restrict__ scale,
           const float* __restrict__ params, const float* __restrict__ enc, int ksize, int rows, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const IsoLayout L = iso_layout(ksize, sizeof(T));
  float* s_taps = reinterpret_cast<float*>(smem + L.taps);   // kp, zero past ksize
  float* s_lut = reinterpret_cast<float*>(smem + L.lut);     // 256 (uint8 frames)
  const srgb::EncTable et = srgb::enc_table_at(smem + L.enc);
  float* s_fspan = reinterpret_cast<float*>(smem + L.fspan);  // (2, kIsoGroup, span, 3) decoded, mixed
  float* s_ring = reinterpret_cast<float*>(smem + L.wring);   // (ring, 64 x 3) W-pass rows
  int* s_col = reinterpret_cast<int*>(smem + L.col);          // span: element offset of each column's source
  int* s_shift = reinterpret_cast<int*>(smem + L.shift);      // (kIsoStages, kIsoGroup): staged row offsets, bytes
  unsigned char* s_raw = smem + L.raw;                        // (kIsoStages, kIsoGroup, pitch) input bytes
  uint8_t* s_out = smem + L.out;                              // (2, kIsoGroup, kIsoOutPitch) encoded rows

  const int tid = threadIdx.x, n = blockIdx.z;
  const int r = ksize / 2, kp = L.kp, span = L.span, ring = L.ring, pitch = L.pitch;
  const int lag = ring / kIsoGroup - 2;
  const int x0 = blockIdx.x * kIsoTileW, y0 = blockIdx.y * rows;
  const int out_rows = min(rows, h - y0);
  const int groups = (out_rows + kIsoGroup - 1) / kIsoGroup;
  const int in_groups = groups + lag;
  const int cols = min(kIsoTileW, w - x0) * 3;  // output bytes per row
  const float sc = scale[n];
  // The staged columns: every source an output of this strip reads.
  const int lo = max(0, x0 - r), hi = min(w, x0 - r + span);

  for (int i = tid; i < kp; i += kIsoThreads) s_taps[i] = i < ksize ? params[9 + i] : 0.f;
  srgb::fill_tables(sizeof(T) == 1 ? s_lut : nullptr, et, enc, sc);
  for (int lx = tid; lx < span; lx += kIsoThreads) {
    s_col[lx] = (min(max(reflect101(x0 - r + lx, w), lo), hi - 1) - lo) * 3;
  }
  float m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = params[i];

  const T* src = img + static_cast<size_t>(n) * h * w * 3;
  // Input rows 8q .. 8q + 7 of the run (global y0 - r + 8q + i) into stage q % kIsoStages.
  const int chunks = pitch / 16;
  auto stage = [&](int q) {
    unsigned char* dst = s_raw + (q % kIsoStages) * kIsoGroup * pitch;
    for (int idx = tid; idx < kIsoGroup * chunks; idx += kIsoThreads) {
      const int i = idx / chunks, c = idx - i * chunks;
      int gy = y0 - r + kIsoGroup * q + i;
      if (static_cast<unsigned>(gy) >= static_cast<unsigned>(h)) gy = reflect101(gy, h);
      const T* row = src + static_cast<size_t>(gy) * w * 3;
      int shift;
      const unsigned char* base = aligned_start(row + lo * 3, &shift);
      if (c == 0) s_shift[(q % kIsoStages) * kIsoGroup + i] = shift;
      if (base + 16 * c < reinterpret_cast<const unsigned char*>(row + hi * 3)) {
        tc::cp_async<16>(dst + i * pitch + 16 * c, base + 16 * c, true);
      }
    }
  };

  // Decode and mix group q into s_fspan[q % 2]: this thread's pixels
  // (row i, column lx) are units tid, tid + 192, ... of 8 x span.
  constexpr int kMaxDec = (kIsoGroup * (kIsoTileW + ((kIsoMaxTaps + 3) & ~3)) + kIsoThreads - 1) / kIsoThreads;
  int dec_i[kMaxDec], dec_lx[kMaxDec];
#pragma unroll
  for (int j = 0; j < kMaxDec; ++j) {
    const int u = tid + j * kIsoThreads;
    dec_i[j] = u / span;
    dec_lx[j] = u - dec_i[j] * span;
  }
  auto decode = [&](int q) {
    const unsigned char* raw = s_raw + (q % kIsoStages) * kIsoGroup * pitch;
    const int* shifts = s_shift + (q % kIsoStages) * kIsoGroup;
    float* f = s_fspan + (q % 2) * kIsoGroup * span * 3;
#pragma unroll
    for (int j = 0; j < kMaxDec; ++j) {
      const int i = dec_i[j], lx = dec_lx[j];
      if (i >= kIsoGroup) break;
      const T* p = reinterpret_cast<const T*>(raw + i * pitch + shifts[i]) + s_col[lx];
      const float l0 = iso_decode<T>(p[0], sc, s_lut);
      const float l1 = iso_decode<T>(p[1], sc, s_lut);
      const float l2 = iso_decode<T>(p[2], sc, s_lut);
      float* d = f + (i * span + lx) * 3;
      d[0] = m[0] * l0 + m[1] * l1 + m[2] * l2;
      d[1] = m[3] * l0 + m[4] * l1 + m[5] * l2;
      d[2] = m[6] * l0 + m[7] * l1 + m[8] * l2;
    }
  };

  // This thread's W-pass unit (row i of the group, run of 8 pixels,
  // channel) and H-pass element.
  const int wi = tid / 24, wrun = (tid % 24) / 3, wch = tid % 3;
  const int w_in = wi * span * 3 + kIsoGroup * wrun * 3 + wch;
  const int w_out = wi * kIsoRow + kIsoGroup * wrun * 3 + wch;
  const float4* taps4 = reinterpret_cast<const float4*>(s_taps);
  uint8_t* dst = out + ((static_cast<size_t>(n) * h + y0) * w + x0) * 3;

  // Output group g's encoded rows, each at its destination's offset within 16 bytes.
  auto store = [&](int g) {
    const uint8_t* so = s_out + (g % 2) * kIsoGroup * kIsoOutPitch;
    constexpr int kChunks = kIsoOutPitch / 16;
    const int left = min(kIsoGroup, out_rows - kIsoGroup * g);
    if (tid < kIsoGroup * kChunks) {
      const int j = tid / kChunks, c = tid % kChunks;
      if (j < left) {
        int shift;
        uint8_t* base = const_cast<uint8_t*>(aligned_start(dst + static_cast<size_t>(kIsoGroup * g + j) * w * 3,
                                                           &shift));
        if (16 * c < shift + cols) store_chunk(so + j * kIsoOutPitch, base, shift, cols, c);
      }
    }
  };

#pragma unroll
  for (int q = 0; q < kIsoStages - 1; ++q) {
    if (q < in_groups) stage(q);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<kIsoStages - 2>();
  __syncthreads();  // tables, column sources and group 0 are in place
  decode(0);

  // Step s: decode group s + 1, W pass of group s, H pass of group s - lag
  // - 1 (its rows were W-passed in earlier steps), store group s - lag - 2.
  for (int s = 0; s <= in_groups; ++s) {
    tc::cp_async_wait<kIsoStages - 3>();
    __syncthreads();  // group s + 1 landed; every thread is done with step s - 1
    if (s + kIsoStages - 1 < in_groups) stage(s + kIsoStages - 1);
    tc::cp_async_commit();
    if (s + 1 < in_groups) decode(s + 1);

    if (s < in_groups) {
      const float* p = s_fspan + (s % 2) * kIsoGroup * span * 3 + w_in;
      float acc[kIsoGroup];
      conv_run(taps4, kp, [&](int g4) {
        const float* x = p + 12 * g4;
        return make_float4(x[0], x[3], x[6], x[9]);
      }, acc);
      float* wr = s_ring + ((kIsoGroup * s) % ring) * kIsoRow + w_out;
#pragma unroll
      for (int j = 0; j < kIsoGroup; ++j) wr[j * 3] = acc[j];
    }

    const int g = s - lag - 1;
    if (g >= 0) {
      // Output row y0 + 8g + j is the sum over W-pass rows 8g + j + t. Ring
      // rows come in aligned groups of 4, so a group never wraps.
      const int base = (kIsoGroup * g) % ring;
      float acc[kIsoGroup];
      conv_run(taps4, kp, [&](int g4) {
        int row = base + 4 * g4;
        if (row >= ring) row -= ring;
        const float* x = s_ring + row * kIsoRow + tid;
        return make_float4(x[0], x[kIsoRow], x[2 * kIsoRow], x[3 * kIsoRow]);
      }, acc);
      uint8_t* so = s_out + (g % 2) * kIsoGroup * kIsoOutPitch + tid;
#pragma unroll
      for (int j = 0; j < kIsoGroup; ++j) {
        const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(
                              dst + static_cast<size_t>(kIsoGroup * g + j) * w * 3) & 15);
        so[j * kIsoOutPitch + shift] = srgb::encode_u8_thr(acc[j], et);
      }
    }
    if (g >= 1) store(g - 1);
  }
  __syncthreads();
  store(groups - 1);
}

template <typename T>
int launch_iso(const void* img, void* out, const void* scale, const void* params, const void* enc, int ksize,
               int rows, int n, int h, int w, void* stream) {
  if (ksize < 1 || ksize > kIsoMaxTaps || (ksize & 1) == 0 || rows < kIsoGroup || rows % kIsoGroup != 0 ||
      n < 1 || n > 65535 || h < 1 || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = iso_layout(ksize, sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(iso_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kIsoTileW - 1) / kIsoTileW, (h + rows - 1) / rows, n);
  iso_kernel<T><<<grid, kIsoThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(img), static_cast<uint8_t*>(out), static_cast<const float*>(scale),
      static_cast<const float*>(params), static_cast<const float*>(enc), ksize, rows, h, w);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Kernel 2: streak species (horse, cow, deer, ... rabbit and panda with
// chroma compression).
//
// Replaces animal_vision_tpu/ops/fused_nonuv.py:_streak_kernel (with its
// tail _apply_mix_chroma_encode), reached through _streak_pallas /
// fused_streak_u8 / fused_streak_tab_u8.
//
// Bound on this card: bytes by the yardstick (per pixel 3 channels x (1 +
// 3 r_y) operations of the row's combined kernel, r_y <= 15 on the path, a
// 3x3 mix and the curves, against 6 bytes), but in practice instruction
// issue: removing the taps, the encode or the decode each saves a part of
// the time (PERF.md, section 6). One block per image row, six powf per pixel, a /3
// and a reflect101 per staged element, three shared loads per tap pair and
// 1-byte stores at a stride of 3 would each cost more. This design:
// - As many blocks as the card holds at once (ops/fused_nonuv.py:
//   streak_blocks; registers capped at 64 so that four share an SM), block
//   b taking rows n h b / B .. n h (b + 1) / B - 1 of the batch, so all
//   finish together; a block builds its decode table once and again where
//   its rows open a frame. Rows come in by 16-byte cp.async one row ahead
//   (the 16-byte-aligned superset of the row's bytes, so rows that start
//   off 16 bytes, as at W = 1283, take the same path from their offset),
//   with their rows of `tab` and `mix`.
// - Decode by table, 4 bytes per thread from one 32-bit shared load into
//   one 16-byte store (the float row is placed so that they align);
//   reflect101 only for the 2r halo pixels.
// - Each thread computes kStreakPix = 9 neighbouring pixels: per channel a
//   register window grows by one pixel on each side per tap distance d, so
//   each pair (x[j-d] + x[j+d]) tab[d] costs two shared loads per 9
//   outputs; the loop stops at the row's own radius (the zero taps past it
//   add nothing). Lanes 27 floats apart hit distinct banks. Sum order as
//   before: tab[0] x[j], then d = 1..r_y. Radii above kStreakWindow take
//   the same sums pixel by pixel.
// - Mix, chroma, encode by thresholds into a shared output row at the
//   destination's offset within 16 bytes, then 16-byte stores.
// 256 threads, two barriers per row, about 49 KB of shared memory at W =
// 1920.
// ---------------------------------------------------------------------------

constexpr int kStreakThreads = 256;
constexpr int kStreakPix = 9;      // neighbouring pixels per thread (odd: bank-conflict free)
constexpr int kStreakStages = 2;   // staged input rows
constexpr int kStreakBlocksPerSM = 4;  // registers capped at 64 so that four blocks share an SM
constexpr int kStreakWindow = 16;  // the largest radius of the register-window path

struct StreakLayout {
  int pitch, fcount, tcount;  // staged row bytes, float row floats, staged tab + mix floats
  size_t lut, enc, rad, shift, tabs, fbuf, raw, out, total;
};

__host__ __device__ inline StreakLayout streak_layout(int r, int w) {
  StreakLayout l{};
  l.pitch = 16 * ((3 * w + 15) / 16 + 1);
  l.fcount = 3 * (w + 2 * r + kStreakPix - 1) + 4;  // the last thread's window overhangs by up to 8 pixels
  l.tcount = r + 1 + 9;
  size_t o = 0;
  l.lut = o;   o += align16(4 * srgb::kLevels);
  l.enc = o;   o += align16(srgb::kBlockEncBytes);
  l.rad = o;   o += align16(4 * kStreakStages);
  l.shift = o; o += align16(4 * kStreakStages);
  l.tabs = o;  o += align16(4 * static_cast<size_t>(kStreakStages) * l.tcount);
  l.fbuf = o;  o += align16(4 * static_cast<size_t>(l.fcount));
  l.raw = o;   o += align16(static_cast<size_t>(kStreakStages) * l.pitch);
  l.out = o;   o += align16(2 * static_cast<size_t>(l.pitch));
  l.total = o;
  return l;
}

// acc[m] = x[j0 + m] tab[0] + sum_{d = 1..ry} (x[j0 + m - d] + x[j0 + m + d]) tab[d]
// for one channel; x[3 i] is pixel j0 + i. The roundings are spelled out
// (the product, then one fma per pair, d = 1..ry), so that no contraction
// the compiler picks for the unrolled window changes a bit.
template <int RMAX>
__device__ __forceinline__ void streak_taps(const float* __restrict__ x, const float* __restrict__ tab, int ry,
                                            float (&acc)[kStreakPix]) {
  if constexpr (RMAX > 0) {
    float win[kStreakPix + 2 * RMAX];  // win[RMAX + i] = pixel j0 + i
#pragma unroll
    for (int i = 0; i < kStreakPix; ++i) win[RMAX + i] = x[3 * i];
    const float t0 = tab[0];
#pragma unroll
    for (int i = 0; i < kStreakPix; ++i) acc[i] = __fmul_rn(win[RMAX + i], t0);
#pragma unroll
    for (int d = 1; d <= RMAX; ++d) {
      if (d > ry) break;
      win[RMAX - d] = x[-3 * d];
      win[RMAX + kStreakPix - 1 + d] = x[3 * (kStreakPix - 1 + d)];
      const float td = tab[d];
#pragma unroll
      for (int i = 0; i < kStreakPix; ++i) acc[i] = fmaf(win[RMAX + i - d] + win[RMAX + i + d], td, acc[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kStreakPix; ++i) {
      const float* p = x + 3 * i;
      float a = __fmul_rn(p[0], tab[0]);
      for (int d = 1; d <= ry; ++d) a = fmaf(p[-3 * d] + p[3 * d], tab[d], a);
      acc[i] = a;
    }
  }
}

template <int RMAX>
__global__ void __launch_bounds__(kStreakThreads, kStreakBlocksPerSM)
streak_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out, const float* __restrict__ scale,
              const float* __restrict__ tab, const float* __restrict__ mix, const float* __restrict__ enc, int r,
              float keep, int use_chroma, int n, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const StreakLayout L = streak_layout(r, w);
  float* s_lut = reinterpret_cast<float*>(smem + L.lut);
  const srgb::EncTable et = srgb::enc_table_at(smem + L.enc);
  int* s_rad = reinterpret_cast<int*>(smem + L.rad);      // per stage: the row's own radius
  int* s_shift = reinterpret_cast<int*>(smem + L.shift);  // per stage: the staged row's offset, bytes
  float* s_tabs = reinterpret_cast<float*>(smem + L.tabs);  // per stage: tab row (r + 1), mix row (9)
  float* s_fbuf = reinterpret_cast<float*>(smem + L.fbuf);  // the decoded row with its halo
  unsigned char* s_raw = smem + L.raw;                      // (kStreakStages, pitch) input bytes
  uint8_t* s_out = smem + L.out;                            // (2, pitch) encoded rows

  // This block's rows g0 .. g1 - 1 of the batch's n h rows (frame g / h,
  // row g % h; frames are contiguous, so row g starts at g 3w).
  const int tid = threadIdx.x;
  const long long total = static_cast<long long>(n) * h;
  const long long g0 = total * blockIdx.x / gridDim.x;
  const int nrows = static_cast<int>(total * (blockIdx.x + 1) / gridDim.x - g0);
  const int row_bytes = 3 * w;
  int frame = static_cast<int>(g0 / h);
  srgb::fill_tables(s_lut, et, enc, scale[frame]);

  const uint8_t* src = img + g0 * row_bytes;
  uint8_t* dst = out + g0 * row_bytes;
  // Row s of the run, with its tables, into stage s % kStreakStages.
  auto stage = [&](int s) {
    const int st = s % kStreakStages;
    int shift;
    const unsigned char* base = aligned_start(src + static_cast<size_t>(s) * row_bytes, &shift);
    if (tid == 0) s_shift[st] = shift;
    const int chunks = (shift + row_bytes + 15) / 16;
    for (int c = tid; c < chunks; c += kStreakThreads) {
      tc::cp_async<16>(s_raw + st * L.pitch + 16 * c, base + 16 * c, true);
    }
    const int y = static_cast<int>((g0 + s) % h);
    for (int i = tid; i < L.tcount; i += kStreakThreads) {
      const float* from = i <= r ? tab + static_cast<size_t>(y) * (r + 1) + i : mix + static_cast<size_t>(y) * 9 + (i - r - 1);
      tc::cp_async<4>(s_tabs + st * L.tcount + i, from, true);
    }
  };
  auto store = [&](int s) {
    int shift;
    uint8_t* base = const_cast<uint8_t*>(aligned_start(dst + static_cast<size_t>(s) * row_bytes, &shift));
    const int chunks = (shift + row_bytes + 15) / 16;
    const uint8_t* so = s_out + (s % 2) * L.pitch;
    for (int c = tid; c < chunks; c += kStreakThreads) store_chunk(so, base, shift, row_bytes, c);
  };

#pragma unroll
  for (int s = 0; s < kStreakStages - 1; ++s) {
    if (s < nrows) stage(s);
    tc::cp_async_commit();
  }
  for (int s = 0; s < nrows; ++s) {
    const int st = s % kStreakStages;
    tc::cp_async_wait<kStreakStages - 2>();
    __syncthreads();  // row s landed; every thread is done with row s - 1
    if (s + kStreakStages - 1 < nrows) stage(s + kStreakStages - 1);
    tc::cp_async_commit();
    if (s > 0) store(s - 1);

    // Decode: f[j] = byte j of the row, j in [-3r, 3w + 3r), reflect-101 on
    // the halo; f is placed so that f + 4q - shift is 16-byte aligned.
    const unsigned char* raw = s_raw + st * L.pitch;
    const int shift = s_shift[st];
    float* f = s_fbuf + ((shift - 3 * r) & 3) + 3 * r;
    const int words = (shift + row_bytes + 3) / 4;
    for (int q = tid; q < words; q += kStreakThreads) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(raw + 4 * q);
      const int j0 = 4 * q - shift;
      if (j0 >= 0 && j0 + 4 <= row_bytes) {
        *reinterpret_cast<float4*>(f + j0) =
            make_float4(s_lut[v & 255u], s_lut[(v >> 8) & 255u], s_lut[(v >> 16) & 255u], s_lut[v >> 24]);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = j0 + b;
          if (j >= 0 && j < row_bytes) f[j] = s_lut[(v >> (8 * b)) & 255u];
        }
      }
    }
    for (int i = tid; i < 6 * r; i += kStreakThreads) {
      const int e = i < 3 * r ? i : row_bytes + i;  // halo element of the padded row
      const int px = e / 3 - r, c = e - 3 * (e / 3);
      f[e - 3 * r] = s_lut[raw[shift + reflect101(px, w) * 3 + c]];
    }
    const float* st_tab = s_tabs + st * L.tcount;
    if (tid < 32) {  // the row's own radius: its last nonzero tap
      int rad = 0;
      for (int base = 0; base <= r; base += 32) {
        const int d = base + tid;
        const unsigned nz = __ballot_sync(0xffffffffu, d >= 1 && d <= r && st_tab[d] != 0.0f);
        if (nz != 0u) rad = base + 31 - __clz(static_cast<int>(nz));
      }
      if (tid == 0) s_rad[st] = rad;
    }
    __syncthreads();  // the decoded row and its radius

    if (s + 1 < nrows && (g0 + s + 1) / h != frame) {  // the next row opens a frame: its decode table
      frame = static_cast<int>((g0 + s + 1) / h);
      for (int v = tid; v < srgb::kLevels; v += kStreakThreads) {
        s_lut[v] = linearize(load_scaled(static_cast<uint8_t>(v), scale[frame]));
      }
    }
    const int ry = s_rad[st];
    float mx[9];  // the row's mix
#pragma unroll
    for (int i = 0; i < 9; ++i) mx[i] = st_tab[r + 1 + i];
    uint8_t* so = s_out + (s % 2) * L.pitch + static_cast<int>(reinterpret_cast<uintptr_t>(
                                                  dst + static_cast<size_t>(s) * row_bytes) & 15);
    for (int u = tid; u * kStreakPix < w; u += kStreakThreads) {
      const int j0 = u * kStreakPix;
      float a[3][kStreakPix];
#pragma unroll
      for (int c = 0; c < 3; ++c) streak_taps<RMAX>(f + 3 * j0 + c, st_tab, ry, a[c]);
#pragma unroll
      for (int i = 0; i < kStreakPix; ++i) {
        if (j0 + i >= w) break;
        float o[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          o[c] = mx[3 * c] * a[0][i] + mx[3 * c + 1] * a[1][i] + mx[3 * c + 2] * a[2][i];
        }
        if (use_chroma) {
          const float gray = (o[0] + o[1] + o[2]) * (1.0f / 3.0f);
#pragma unroll
          for (int c = 0; c < 3; ++c) o[c] = gray + (o[c] - gray) * keep;
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) so[3 * (j0 + i) + c] = srgb::encode_u8_thr(o[c], et);
      }
    }
  }
  __syncthreads();
  if (nrows > 0) store(nrows - 1);
}

template <int RMAX>
int launch_streak(const void* img, void* out, const void* scale, const void* tab, const void* mix, const void* enc,
                  int r, float keep, int use_chroma, int blocks, int n, int h, int w, cudaStream_t stream) {
  const size_t smem = streak_layout(r, w).total;
  cudaError_t err = cudaFuncSetAttribute(streak_kernel<RMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  streak_kernel<RMAX><<<blocks, kStreakThreads, smem, stream>>>(
      static_cast<const uint8_t*>(img), static_cast<uint8_t*>(out), static_cast<const float*>(scale),
      static_cast<const float*>(tab), static_cast<const float*>(mix), static_cast<const float*>(enc), r, keep,
      use_chroma, n, h, w);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Kernel 3: pointwise species (pig: matrix only; rat: matrix + per-row
// S-cone gain on blue).
//
// Replaces animal_vision_tpu/ops/fused_nonuv.py:_pointwise_kernel, reached
// through _pointwise_pallas / fused_pointwise_u8 / fused_scone_tab_u8.
//
// Bound on this card: bytes. A pixel moves 6 bytes against 9 multiply-adds
// (and a gain); six powf curves per pixel, 1-byte accesses at a 3-byte
// stride and a 64-bit division per pixel would cost several times that.
// The arithmetic left per element is the threshold encode (a __powf
// estimate and a test). The design:
// - One frame per block: the grid is (blocks per frame, N). Each block
//   fills its frame's decode table and its copy of the encode table once
//   (srgb::fill_tables, as iso_kernel and streak_kernel do) and strides
//   over that frame's pixels. Blocks per frame come from the blocks the
//   card holds at once (ops/fused_nonuv.py:pointwise_blocks), so a table
//   fill is paid a few hundred times per frame.
// - 16-byte vector traffic: a thread's unit is 16 pixels, 48 bytes: three
//   uint4 loads issued before any arithmetic, three uint4 stores. Units
//   start at the frame's first byte offset that is a multiple of 3 and lies
//   on 16 bytes (within 48 bytes of the frame's start, as frame n starts at
//   n H W 3 and a slice can start anywhere). The head before it and the
//   tail after the last whole unit (at most 15 pixels each) go byte by
//   byte, in the frame's block 0. Where the output's offset within 16 bytes
//   differs from the input's (a frame passed as an unaligned slice), units
//   store byte by byte.
// - The matrix sits in registers, read once per thread; products and sums
//   are spelled out (mix_row) so that the compiler's contractions do not
//   decide a byte. The rat's gain row takes one 32-bit division per unit:
//   at W >= 16 a unit crosses at most one row boundary (two gains, read
//   through the read-only path), narrower frames count rows pixel by pixel.
// ---------------------------------------------------------------------------

constexpr int kPointwiseThreads = 256;
constexpr int kPointwisePix = 16;  // pixels per unit: 48 bytes, three 16-byte vectors
// Resident blocks per SM: the rat's instance fits 32 registers (a full SM
// of threads); the pig's spills below 64, so it takes 64 and four blocks.
__host__ __device__ constexpr int pointwise_blocks_per_sm(bool gain) { return gain ? 8 : 4; }

// m[3c] l0 + m[3c + 1] l1 + m[3c + 2] l2, in this order.
__device__ __forceinline__ float mix_row(const float* m, float l0, float l1, float l2) {
  return __fmaf_rn(m[2], l2, __fmaf_rn(m[1], l1, __fmul_rn(m[0], l0)));
}

// One pixel's three codes from its three input bytes; g is its row's gain
// (kGain only).
template <bool kGain>
__device__ __forceinline__ void pointwise_pixel(uint32_t b0, uint32_t b1, uint32_t b2, const float (&m)[9], float g,
                                                const float* __restrict__ s_lut, const srgb::EncTable& et,
                                                uint32_t (&code)[3]) {
  const float l0 = s_lut[b0], l1 = s_lut[b1], l2 = s_lut[b2];
  const float o0 = mix_row(m, l0, l1, l2);
  const float o1 = mix_row(m + 3, l0, l1, l2);
  float o2 = mix_row(m + 6, l0, l1, l2);
  if constexpr (kGain) o2 = clamp01(__fmul_rn(o2, g));
  code[0] = srgb::encode_u8_thr(o0, et);
  code[1] = srgb::encode_u8_thr(o1, et);
  code[2] = srgb::encode_u8_thr(o2, et);
}

// A unit: 48 input bytes in `word` to 48 output bytes in `ow`; gain_of(i)
// is pixel i's gain, called for i = 0..15 in order.
template <bool kGain, typename GainOf>
__device__ __forceinline__ void pointwise_unit(const uint32_t (&word)[12], uint32_t (&ow)[12], const float (&m)[9],
                                               const float* __restrict__ s_lut, const srgb::EncTable& et,
                                               GainOf gain_of) {
#pragma unroll
  for (int k = 0; k < 12; ++k) ow[k] = 0u;
#pragma unroll
  for (int i = 0; i < kPointwisePix; ++i) {
    uint32_t b[3], code[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) b[c] = (word[(3 * i + c) >> 2] >> (8 * ((3 * i + c) & 3))) & 255u;
    pointwise_pixel<kGain>(b[0], b[1], b[2], m, gain_of(i), s_lut, et, code);
#pragma unroll
    for (int c = 0; c < 3; ++c) ow[(3 * i + c) >> 2] |= code[c] << (8 * ((3 * i + c) & 3));
  }
}

template <bool kGain>
__global__ void __launch_bounds__(kPointwiseThreads, pointwise_blocks_per_sm(kGain))
pointwise_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out, const float* __restrict__ scale,
                 const float* __restrict__ mat9, const float* __restrict__ gain, const float* __restrict__ enc,
                 int h, int w) {
  __shared__ float s_lut[srgb::kLevels];
  __shared__ __align__(16) unsigned char s_enc[srgb::kBlockEncBytes];
  const srgb::EncTable et = srgb::enc_table_at(s_enc);
  const int n = blockIdx.y;
  srgb::fill_tables(s_lut, et, enc, scale[n]);
  float m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = __ldg(mat9 + i);

  const unsigned npx = static_cast<unsigned>(h) * static_cast<unsigned>(w);
  const size_t frame_bytes = static_cast<size_t>(npx) * 3;
  const uint8_t* src = img + static_cast<size_t>(n) * frame_bytes;
  uint8_t* dst = out + static_cast<size_t>(n) * frame_bytes;
  // head: the least p with src + 3p on 16 bytes (3 * 11 = 1 mod 16), or the whole frame
  const unsigned shift = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src) & 15);
  const unsigned head = min(((16u - shift) * 11u) & 15u, npx);
  const unsigned units = (npx - head) / kPointwisePix;
  const unsigned tail = npx - head - units * kPointwisePix;
  const bool vec_out = ((reinterpret_cast<uintptr_t>(src) ^ reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  __syncthreads();  // the tables

  if (blockIdx.x == 0 && threadIdx.x < head + tail) {  // the head's and the tail's pixels, one per thread
    const unsigned p = threadIdx.x < head ? threadIdx.x : npx - tail + (threadIdx.x - head);
    const size_t o = static_cast<size_t>(p) * 3;
    uint32_t code[3];
    pointwise_pixel<kGain>(src[o], src[o + 1], src[o + 2], m, kGain ? __ldg(gain + p / w) : 1.0f, s_lut, et, code);
#pragma unroll
    for (int c = 0; c < 3; ++c) dst[o + c] = static_cast<uint8_t>(code[c]);
  }

  const uint8_t* body = src + static_cast<size_t>(head) * 3;
  uint8_t* obody = dst + static_cast<size_t>(head) * 3;
  for (unsigned u = blockIdx.x * kPointwiseThreads + threadIdx.x; u < units; u += gridDim.x * kPointwiseThreads) {
    const uint4* in4 = reinterpret_cast<const uint4*>(body + static_cast<size_t>(u) * 48);
    const uint4 v0 = __ldg(in4), v1 = __ldg(in4 + 1), v2 = __ldg(in4 + 2);
    const uint32_t word[12] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w, v2.x, v2.y, v2.z, v2.w};
    uint32_t ow[12];
    if constexpr (!kGain) {
      pointwise_unit<false>(word, ow, m, s_lut, et, [](int) { return 1.0f; });
    } else {
      const unsigned q0 = head + u * kPointwisePix;  // the unit's first pixel
      const unsigned r0 = q0 / static_cast<unsigned>(w);
      if (w >= kPointwisePix) {
        const int split = static_cast<int>((r0 + 1) * w - q0);  // pixels i >= split lie in row r0 + 1
        const float g0 = __ldg(gain + r0);
        const float g1 = split < kPointwisePix ? __ldg(gain + r0 + 1) : g0;
        pointwise_unit<true>(word, ow, m, s_lut, et, [&](int i) { return i < split ? g0 : g1; });
      } else {
        unsigned row = r0, col = q0 - r0 * w;
        pointwise_unit<true>(word, ow, m, s_lut, et, [&](int) {
          if (col == static_cast<unsigned>(w)) {
            col = 0;
            ++row;
          }
          ++col;
          return __ldg(gain + row);
        });
      }
    }
    uint8_t* o = obody + static_cast<size_t>(u) * 48;
    if (vec_out) {
      uint4* o4 = reinterpret_cast<uint4*>(o);
      o4[0] = make_uint4(ow[0], ow[1], ow[2], ow[3]);
      o4[1] = make_uint4(ow[4], ow[5], ow[6], ow[7]);
      o4[2] = make_uint4(ow[8], ow[9], ow[10], ow[11]);
    } else {
#pragma unroll
      for (int j = 0; j < 48; ++j) o[j] = static_cast<uint8_t>(ow[j >> 2] >> (8 * (j & 3)));
    }
  }
}

template <bool kGain>
int launch_pointwise(const void* img, void* out, const void* scale, const void* mat9, const void* gain,
                     const void* enc, int blocks, int n, int h, int w, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
  pointwise_kernel<kGain><<<grid, kPointwiseThreads, 0, stream>>>(
      static_cast<const uint8_t*>(img), static_cast<uint8_t*>(out), static_cast<const float*>(scale),
      static_cast<const float*>(mat9), static_cast<const float*>(gain), static_cast<const float*>(enc), h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The device encode table (srgb::kEncTable floats) of this library's
// encode_u8; status: 2 ints on the device, zero on entry (exceptions, and
// counts that got two of them).
int av_encode_table(void* enc, void* status, void* stream) {
  return static_cast<int>(srgb::launch_encode_table(static_cast<float*>(enc), static_cast<int*>(status),
                                                    static_cast<cudaStream_t>(stream)));
}

// result: 2 uint64 on the device, {0, 2^64 - 1} on entry: the count of
// float bit patterns in start .. start + count - 1 where encode_u8_thr
// differs from encode_u8, and the first such pattern.
int av_encode_check(const void* enc, unsigned long long start, unsigned long long count, void* result,
                    void* stream) {
  return static_cast<int>(srgb::launch_encode_check(static_cast<const float*>(enc), start, count,
                                                    static_cast<unsigned long long*>(result),
                                                    static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of one iso block, in bytes (elem: 1 for uint8
// frames, 4 for float32).
int av_iso_smem(int ksize, int elem) { return static_cast<int>(iso_layout(ksize, elem).total); }

int av_iso_u8(const void* img, void* out, const void* scale, const void* params, const void* enc, int ksize,
              int rows, int n, int h, int w, void* stream) {
  return launch_iso<uint8_t>(img, out, scale, params, enc, ksize, rows, n, h, w, stream);
}

int av_iso_f32(const void* img, void* out, const void* scale, const void* params, const void* enc, int ksize,
               int rows, int n, int h, int w, void* stream) {
  return launch_iso<float>(img, out, scale, params, enc, ksize, rows, n, h, w, stream);
}

// Blocks of streak_kernel the current device holds at once for radius r and
// width w (SMs x resident blocks per SM); 0 if a block does not fit.
int av_streak_slots(int r, int w, int* slots) {
  const size_t smem = streak_layout(r, w).total;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const void* fn = r <= kStreakWindow ? reinterpret_cast<const void*>(streak_kernel<kStreakWindow>)
                                      : reinterpret_cast<const void*>(streak_kernel<0>);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kStreakThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *slots = sms * per_sm;
  return 0;
}

// `blocks` blocks share the n h rows (at most one block per row).
int av_streak_u8(const void* img, void* out, const void* scale, const void* tab, const void* mix, const void* enc,
                 int r, float keep, int use_chroma, int blocks, int n, int h, int w, void* stream) {
  if (r < 0 || blocks < 1 || n < 1 || h < 1 || w < 1 || static_cast<long long>(blocks) > static_cast<long long>(n) * h) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (r <= kStreakWindow) {
    return launch_streak<kStreakWindow>(img, out, scale, tab, mix, enc, r, keep, use_chroma, blocks, n, h, w, s);
  }
  return launch_streak<0>(img, out, scale, tab, mix, enc, r, keep, use_chroma, blocks, n, h, w, s);
}

// Blocks of pointwise_kernel (with the gain or without) the current device
// holds at once (SMs x resident blocks per SM).
int av_pointwise_slots(int use_gain, int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const void* fn = use_gain ? reinterpret_cast<const void*>(pointwise_kernel<true>)
                            : reinterpret_cast<const void*>(pointwise_kernel<false>);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kPointwiseThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *slots = sms * per_sm;
  return 0;
}

// `blocks` blocks per frame; gain null for the pig. A frame holds at most
// 2^31 - 1 pixels (a batch at most 65535 frames: gridDim.y).
int av_pointwise_u8(const void* img, void* out, const void* scale, const void* mat9, const void* gain,
                    const void* enc, int blocks, int n, int h, int w, void* stream) {
  if (blocks < 1 || n < 1 || h < 1 || w < 1 || static_cast<long long>(h) * w > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (gain != nullptr) return launch_pointwise<true>(img, out, scale, mat9, gain, enc, blocks, n, h, w, s);
  return launch_pointwise<false>(img, out, scale, mat9, gain, enc, blocks, n, h, w, s);
}

}  // extern "C"
