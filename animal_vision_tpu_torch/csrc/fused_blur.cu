// The UV blur kernel, hand-written for Hopper (sm_90a).
//
// Replaces animal_vision_tpu/ops/fused_blur.py:_blur_kernel (reached through
// fused_gaussian_blur from core/blur.py:gaussian_blur_uv): a float32
// separable Gaussian with an explicit kernel size k = 2*ceil(3*sigma)+1 and
// BORDER_REFLECT_101 on both axes, i.e. cv2.GaussianBlur(..., (k, k), sigma,
// borderType=BORDER_REFLECT_101) with getGaussianKernel taps.
//
// Frames are (N, H, W, C) float32, channels interleaved, C <= 8; N is
// gridDim.z. The taps are a run-time device table and H, W, C, N, the
// kernel size and the run length are run-time arguments, so nothing is
// rebuilt per shape or sigma.
//
// Bound on this card: bytes for the kernel sizes of the UV path. Each
// output element costs 2k multiply-adds (k <= 19 on the path: 76 flops)
// against 8 bytes of traffic, below the card's 20 flops per byte. So the
// design streams rows through shared memory and keeps the SMs full:
// - One block per (frame, strip of kTileW = 64 output columns, run of
//   `rows` output rows). The block walks down its run in steps of kGroup =
//   8 rows: each step brings in 8 input row spans of 64 + kp pixels (kp: k
//   rounded up to 4; the extra columns meet zero taps) through a ring of
//   kStages groups filled by cp.async, issued two steps ahead; runs the W
//   pass of those 8 rows into a ring of the last kp + 8 W-pass rows
//   (rounded up to whole groups); and, once the ring holds the rows an
//   output group needs, writes 8 output rows from it with coalesced
//   stores. Only the rows above a run (2R, rounded up) are W-passed twice,
//   by this run and the one above.
// - Reflection only where a source is chosen: a block's column sources
//   (reflect101 of every staged column) are computed once into a table of
//   element offsets, and a staged row outside the frame takes one
//   reflect101. The inner loops hold no integer division.
// - Each thread computes 8 neighbouring outputs (8 pixels of one channel in
//   the W pass, 8 rows of one element in the H pass) from a sliding window
//   of inputs in registers, read in aligned groups of 4 with 4 taps per
//   16-byte shared load: 32 multiply-adds per 5 shared loads.
// - Both passes accumulate in tap order t = 0..k-1 (the zero taps past k
//   come last and add nothing), the order of the plain version's
//   shifted-slice sum (ops/fused_blur.py:blur_uv_plain).
// - One instance per C (strides are constants), 64 * min(C, 4) threads per
//   block, one W-pass and one H-pass unit of work per thread per step at
//   C <= 4, and about 49 KB of shared memory at C = 3, k = 19, so several
//   blocks share an SM. Runs of 128 rows (fewer for small frames, so that
//   the grid still fills the card; ops/fused_blur.py:run_rows) W-pass 1.19x
//   the rows at k = 19.
//
// C interface (loaded with ctypes): the entry point takes raw device
// pointers and the stream, launches on that stream without synchronising,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kTileW = 64;  // output strip width, pixels
constexpr int kGroup = 8;   // rows per step, and outputs per thread in each pass
constexpr int kStages = 3;  // staged input groups in the ring

__host__ __device__ constexpr int taps_padded(int ksize) { return (ksize + 3) & ~3; }
__host__ __device__ constexpr int span_pixels(int ksize) { return kTileW + taps_padded(ksize); }
// W-pass rows kept: the kp + kGroup rows an output group reads, rounded up
// to whole groups
__host__ __device__ constexpr int ring_rows(int ksize) {
  return kGroup * ((taps_padded(ksize) + kGroup - 1) / kGroup + 1);
}
__host__ __device__ constexpr int block_threads(int c) { return 64 * (c < 4 ? c : 4); }

// Must equal ops/fused_blur.py:smem_bytes. Floats: the padded taps, the ring
// of W-pass rows (64 C each), kStages groups of kGroup staged input spans of
// 64 + kp pixels, and one int per staged element (its source offset within
// a row).
size_t blur_smem_bytes(int ksize, int c) {
  const size_t kp = taps_padded(ksize), span = static_cast<size_t>(span_pixels(ksize)) * c;
  return sizeof(float) * (kp + ring_rows(ksize) * kTileW * c + kStages * kGroup * span + span);
}

// acc[j] = sum_t in[t + j] taps[t] for j < kGroup, t = 0..kp-1 in order (kp
// a multiple of 4), the taps read 4 at a time; load(q) returns in[4q ..
// 4q + 3], so the window of inputs stays in registers.
template <typename Load>
__device__ __forceinline__ void conv_run(const float4* __restrict__ taps4, int kp, Load load,
                                         float (&acc)[kGroup]) {
  float win[kGroup + 4];
  auto put = [&](int m, float4 v) {
    win[m] = v.x;
    win[m + 1] = v.y;
    win[m + 2] = v.z;
    win[m + 3] = v.w;
  };
#pragma unroll
  for (int m = 0; m < kGroup; m += 4) put(m, load(m / 4));
#pragma unroll
  for (int j = 0; j < kGroup; ++j) acc[j] = 0.f;
  for (int q = 0; q < kp / 4; ++q) {
    const float4 t4 = taps4[q];
    const float tp[4] = {t4.x, t4.y, t4.z, t4.w};
    put(kGroup, load(q + kGroup / 4));
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < kGroup; ++j) acc[j] = fmaf(win[m + j], tp[m], acc[j]);
#pragma unroll
    for (int m = 0; m < kGroup; ++m) win[m] = win[m + 4];
  }
}

// One instance per channel count, so that strides and the threads' units
// are constants.
template <int C>
__global__ void __launch_bounds__(block_threads(C))
blur_kernel(const float* __restrict__ img, float* __restrict__ out, const float* __restrict__ taps, int ksize,
            int rows, int h, int w) {
  constexpr int kThreads = block_threads(C);
  constexpr int kRow = kTileW * C;     // floats per W-pass row
  constexpr int kRuns = kTileW / kGroup;  // runs of kGroup pixels per row
  constexpr int kUnits = 64 * C;       // units of work per pass and step (kGroup kRuns C, and kRow)
  constexpr int kPer = (kUnits + kThreads - 1) / kThreads;
  static_assert(kGroup * kRuns * C == kUnits && kRow == kUnits && kGroup % 4 == 0, "one unit per output run");
  extern __shared__ __align__(16) float smem[];
  const int r = ksize / 2, kp = taps_padded(ksize);
  const int span = span_pixels(ksize) * C;  // floats per staged input row
  const int ring = ring_rows(ksize);
  const int dlag = ring / kGroup - 1;       // steps between a group's W pass and its H pass
  float* s_taps = smem;                                   // kp, zero past ksize
  float* s_ring = s_taps + kp;                            // (ring, 64 C)
  float* s_in = s_ring + ring * kRow;                     // (kStages, kGroup, span)
  int* s_off = reinterpret_cast<int*>(s_in + kStages * kGroup * span);  // (span,)

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * rows;
  const int tid = threadIdx.x;
  const int out_rows = min(rows, h - y0);
  const int steps = (out_rows + kGroup - 1) / kGroup + dlag;

  for (int i = tid; i < kp; i += kThreads) s_taps[i] = i < ksize ? taps[i] : 0.f;
  for (int e = tid; e < span; e += kThreads) {
    const int lx = e / C;
    s_off[e] = reflect101(x0 - r + lx, w) * C + (e - lx * C);
  }
  __syncthreads();

  const float* src = img + static_cast<size_t>(n) * h * w * C;
  // Input rows G s .. G s + G - 1 of the run (global y0 - r + q; G = kGroup)
  // into stage s % kStages.
  auto stage = [&](int s) {
    float* dst = s_in + (s % kStages) * kGroup * span;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      int gy = y0 - r + kGroup * s + i;
      if (static_cast<unsigned>(gy) >= static_cast<unsigned>(h)) gy = reflect101(gy, h);
      const float* row = src + static_cast<size_t>(gy) * w * C;
      for (int e = tid; e < span; e += kThreads) tc::cp_async<4>(dst + i * span + e, row + s_off[e], true);
    }
  };

  // This thread's W-pass units: (row i of the group, run of kGroup pixels, channel).
  int w_in[kPer], w_out[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int u = tid + q * kThreads;
    const int i = u / (kRuns * C), rem = u % (kRuns * C);
    const int run = rem / C, ch = rem % C;
    w_in[q] = i * span + kGroup * run * C + ch;
    w_out[q] = i * kRow + kGroup * run * C + ch;
  }
  const float4* taps4 = reinterpret_cast<const float4*>(s_taps);
  const int cols = min(kTileW, w - x0) * C;
  float* dst = out + ((static_cast<size_t>(n) * h + y0) * w + x0) * C;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) stage(s);
    tc::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // group s landed; every thread is done with step s - 1
    if (s + kStages - 1 < steps) stage(s + kStages - 1);
    tc::cp_async_commit();

    // W pass of input rows G s .. G s + G - 1 into ring rows (G s + i) % ring.
    const float* in = s_in + (s % kStages) * kGroup * span;
    float* wr = s_ring + ((kGroup * s) % ring) * kRow;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (kUnits % kThreads != 0 && tid + q * kThreads >= kUnits) break;
      const float* p = in + w_in[q];
      float acc[kGroup];
      conv_run(taps4, kp, [&](int g4) {
        const float* x = p + 4 * g4 * C;
        return make_float4(x[0], x[C], x[2 * C], x[3 * C]);
      }, acc);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) wr[w_out[q] + j * C] = acc[j];
    }
    __syncthreads();

    // H pass of output group g = s - dlag: output row y0 + G g + j is the
    // sum over W-pass rows G g + j + t. Ring rows come in aligned groups of
    // 4, so a group never wraps.
    const int g = s - dlag;
    if (g < 0) continue;
    const int base = (kGroup * g) % ring;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = tid + q * kThreads;
      if (kUnits % kThreads != 0 && e >= kUnits) break;
      float acc[kGroup];
      conv_run(taps4, kp, [&](int g4) {
        int row = base + 4 * g4;
        if (row >= ring) row -= ring;
        const float* x = s_ring + row * kRow + e;
        return make_float4(x[0], x[kRow], x[2 * kRow], x[3 * kRow]);
      }, acc);
      if (e >= cols) continue;
      float* o = dst + static_cast<size_t>(kGroup * g) * w * C + e;
      const int left = out_rows - kGroup * g;
#pragma unroll
      for (int j = 0; j < kGroup; ++j, o += static_cast<size_t>(w) * C)
        if (j < left) *o = acc[j];
    }
  }
}

template <int C>
int launch_blur(const float* img, float* out, const float* taps, int ksize, int rows, int n, int h, int w,
                cudaStream_t stream) {
  const size_t smem = blur_smem_bytes(ksize, C);
  cudaError_t err = cudaFuncSetAttribute(blur_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + rows - 1) / rows, n);
  blur_kernel<C><<<grid, block_threads(C), smem, stream>>>(img, out, taps, ksize, rows, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The most dynamic shared memory one block of the current device may use.
int av_blur_uv_smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
}

// Dynamic shared memory of one block, in bytes.
int av_blur_uv_smem(int ksize, int c) { return static_cast<int>(blur_smem_bytes(ksize, c)); }

// img/out (n, h, w, c) float32, taps (ksize,); `rows` output rows per
// block, a multiple of 4.
int av_blur_uv(const void* img, void* out, const void* taps, int ksize, int rows, int n, int h, int w, int c,
               void* stream) {
  if (ksize < 1 || (ksize & 1) == 0 || n < 1 || n > 65535 || h < 1 || w < 1 || rows < kGroup ||
      rows % kGroup != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* x = static_cast<const float*>(img);
  auto* y = static_cast<float*>(out);
  const auto* t = static_cast<const float*>(taps);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return launch_blur<1>(x, y, t, ksize, rows, n, h, w, s);
    case 2: return launch_blur<2>(x, y, t, ksize, rows, n, h, w, s);
    case 3: return launch_blur<3>(x, y, t, ksize, rows, n, h, w, s);
    case 4: return launch_blur<4>(x, y, t, ksize, rows, n, h, w, s);
    case 5: return launch_blur<5>(x, y, t, ksize, rows, n, h, w, s);
    case 6: return launch_blur<6>(x, y, t, ksize, rows, n, h, w, s);
    case 7: return launch_blur<7>(x, y, t, ksize, rows, n, h, w, s);
    case 8: return launch_blur<8>(x, y, t, ksize, rows, n, h, w, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
