// The UV blur kernel, hand-written for Hopper (sm_90a).
//
// Replaces animal_vision_tpu/ops/fused_blur.py:_blur_kernel (reached through
// fused_gaussian_blur from core/blur.py:gaussian_blur_uv): a float32
// separable Gaussian with an explicit kernel size k = 2*ceil(3*sigma)+1 and
// BORDER_REFLECT_101 on both axes, i.e. cv2.GaussianBlur(..., (k, k), sigma,
// borderType=BORDER_REFLECT_101) with getGaussianKernel taps.
//
// Frames are (N, H, W, C) float32, channels interleaved, C <= 8; N is
// gridDim.z. The taps are a run-time device table and H, W, C, N and the
// kernel size are run-time arguments, so nothing is rebuilt per shape or
// sigma.
//
// Bound on this card: bytes for the kernel sizes of the UV path. Each
// output element costs 2k multiply-adds (k <= 19 on the path: 76 flops)
// against 8 bytes of traffic, below the card's 20 flops per byte.
//
// Design: one block per (frame, 64-pixel x `rows`-row output tile). The
// tile and an R = k/2 halo on every side are staged once in dynamic shared
// memory (border pixels through reflect101, so frames down to 1x1 and
// narrower than the kernel are exact). The W pass runs shared->shared over
// every halo row, the H pass shared->registers, and the ragged right and
// bottom edges are masked at the store. Both passes accumulate in tap order
// t = 0..k-1, the order of the plain version's shifted-slice sum
// (ops/fused_blur.py:blur_uv_plain). `rows` is 32, 16 or 8, the largest
// whose tile fits the card's shared memory (chosen by the wrapper); the
// input is read about (1 + 2R/64)(1 + 2R/rows) times, the repeats from L2.
//
// C interface (loaded with ctypes): the entry point takes raw device
// pointers and the stream, launches on that stream without synchronising,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "common.cuh"

namespace {

constexpr int kTileW = 64;  // output tile width, pixels
constexpr int kThreads = 256;
constexpr int kMaxChannels = 8;

// Must equal ops/fused_blur.py:smem_bytes.
size_t blur_smem_bytes(int ksize, int c, int rows) {
  const size_t r = ksize / 2;
  const size_t in_w = kTileW + 2 * r, in_h = rows + 2 * r;
  const size_t taps = (ksize + 3) & ~3;
  return sizeof(float) * (taps + in_h * in_w * c + in_h * kTileW * c);
}

__global__ void __launch_bounds__(kThreads)
blur_kernel(const float* __restrict__ img, float* __restrict__ out, const float* __restrict__ taps,
            int ksize, int rows, int h, int w, int c) {
  extern __shared__ float smem[];
  const int r = ksize / 2;
  const int in_w = kTileW + 2 * r;
  const int in_h = rows + 2 * r;
  const int in_row = in_w * c;       // floats per staged input row
  const int row_elems = kTileW * c;  // floats per W-pass row
  float* s_taps = smem;                          // ksize, rounded up to 4
  float* s_in = smem + ((ksize + 3) & ~3);       // (in_h, in_w, c)
  float* s_hz = s_in + in_h * in_row;            // (in_h, kTileW, c) after the W pass

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * rows;
  for (int i = threadIdx.x; i < ksize; i += blockDim.x) s_taps[i] = taps[i];

  const float* src = img + static_cast<size_t>(n) * h * w * c;
  for (int i = threadIdx.x; i < in_h * in_row; i += blockDim.x) {
    const int ly = i / in_row;
    const int e = i - ly * in_row;
    const int lx = e / c;
    const int ch = e - lx * c;
    const int gy = reflect101(y0 - r + ly, h);
    const int gx = reflect101(x0 - r + lx, w);
    s_in[i] = src[(static_cast<size_t>(gy) * w + gx) * c + ch];
  }
  __syncthreads();

  // W pass: element e = c*j + ch of halo row ly reads s_in[ly][e + c*t].
  for (int i = threadIdx.x; i < in_h * row_elems; i += blockDim.x) {
    const int ly = i / row_elems;
    const int e = i - ly * row_elems;
    const float* s = s_in + ly * in_row + e;
    float acc = s[0] * s_taps[0];
    for (int t = 1; t < ksize; ++t) acc += s[c * t] * s_taps[t];
    s_hz[i] = acc;
  }
  __syncthreads();

  // H pass and store.
  float* dst = out + static_cast<size_t>(n) * h * w * c;
  for (int i = threadIdx.x; i < rows * row_elems; i += blockDim.x) {
    const int ly = i / row_elems;
    const int e = i - ly * row_elems;
    const int gy = y0 + ly;
    const int gx = x0 + e / c;
    if (gy >= h || gx >= w) continue;
    const float* s = s_hz + ly * row_elems + e;
    float acc = s[0] * s_taps[0];
    for (int t = 1; t < ksize; ++t) acc += s[t * row_elems] * s_taps[t];
    dst[(static_cast<size_t>(gy) * w + x0) * c + e] = acc;
  }
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

int av_blur_uv(const void* img, void* out, const void* taps, int ksize, int rows, int n, int h, int w,
               int c, void* stream) {
  if (ksize < 1 || (ksize & 1) == 0 || c < 1 || c > kMaxChannels || n < 1 || n > 65535 || h < 1 ||
      w < 1 || (rows != 8 && rows != 16 && rows != 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = blur_smem_bytes(ksize, c, rows);
  cudaError_t err = cudaFuncSetAttribute(blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + rows - 1) / rows, n);
  blur_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(out), static_cast<const float*>(taps), ksize,
      rows, h, w, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
