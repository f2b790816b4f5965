// The three fused non-UV species kernels, hand-written for Hopper (sm_90a).
//
// Each kernel runs a whole species chain in one pass over device memory:
// uint8 RGB frame -> per-frame 1/255 scale -> sRGB->linear -> colour / blur
// -> linear->sRGB -> uint8 frame. Frames are (N, H, W, 3) interleaved and
// read in that layout; N is gridDim.z, and the per-frame scale is an (N,)
// float32 array on the device. Tables (colour matrix, blur taps, per-row
// streak and gain tables) are shared by all frames of a batch.
//
// Numerics: accurate powf and IEEE division (built without
// --use_fast_math), float32 accumulation. The plain PyTorch versions in
// ops/fused_nonuv.py compute the same function; kernels agree with them to
// <= 1 uint8 LSB.
//
// C interface (loaded with ctypes): every entry point takes raw device
// pointers and the stream, launches on that stream without synchronising,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Shared helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// IEC 61966-2-1 EOCF, sRGB [0,1] -> linear.
__device__ __forceinline__ float linearize(float f) {
  return f <= 0.04045f ? f / 12.92f : powf((f + 0.055f) / 1.055f, 2.4f);
}

// clip -> linear->sRGB -> clip -> (s*255 + 0.5) truncated to uint8.
__device__ __forceinline__ uint8_t encode_u8(float x) {
  x = clamp01(x);
  const float s = x <= 0.0031308f ? 12.92f * x : 1.055f * powf(x, 0.4166666666666667f) - 0.055f;
  return static_cast<uint8_t>(clamp01(s) * 255.0f + 0.5f);
}

__device__ __forceinline__ float load_scaled(uint8_t v, float scale) {
  return clamp01(static_cast<float>(v) * scale);
}
__device__ __forceinline__ float load_scaled(float v, float scale) { return clamp01(v * scale); }

// ---------------------------------------------------------------------------
// Kernel 1: isotropic blur species (dog, wolf, lion, ... and the cat).
//
// Replaces animal_vision_tpu/ops/fused_nonuv.py:_iso_kernel (reached through
// fused_matrix_blur / fused_iso_u8).
//
// Bound on this card: float32 operations. A 1080p frame moves 12 MB
// (3.7 us at 3.35 TB/s) but the separable blur costs 12*ksize multiply-adds
// per pixel (ksize 29 for the dog: ~350 per pixel), plus six powf.
//
// Design: one block per 64 x 32 output tile. The tile and an R-pixel halo
// on every side are loaded once into shared memory, already scaled,
// clipped, linearized and colour-mixed (border pixels through general
// reflect-101). The horizontal pass runs shared->shared over all halo rows,
// the vertical pass shared->registers, then encode and store. Each input
// byte is read about (1 + 2R/64)(1 + 2R/32) times (L2 serves the repeats);
// the halo rows' linearize is recomputed per tile.
// ---------------------------------------------------------------------------

constexpr int kIsoTx = 64;   // output tile width, pixels
constexpr int kIsoTy = 32;   // output tile height, rows
constexpr int kIsoThreads = 256;
constexpr int kIsoMaxTaps = 55;  // params hold 9 matrix + ksize tap floats
constexpr int kIsoParams = 64;

size_t iso_smem_bytes(int r) {
  const size_t in_w = kIsoTx + 2 * r, in_h = kIsoTy + 2 * r;
  return sizeof(float) * (kIsoParams + in_h * in_w * 3 + in_h * kIsoTx * 3);
}

template <typename T>
__global__ void __launch_bounds__(kIsoThreads)
iso_kernel(const T* __restrict__ img, uint8_t* __restrict__ out, const float* __restrict__ scale,
           const float* __restrict__ params, int ksize, int h, int w) {
  extern __shared__ float smem[];
  const int r = ksize / 2;
  const int in_w = kIsoTx + 2 * r;
  const int in_h = kIsoTy + 2 * r;
  float* s_par = smem;                          // mat[9] then taps[ksize]
  float* s_in = smem + kIsoParams;              // (in_h, in_w, 3) linear, mixed
  float* s_hz = s_in + in_h * in_w * 3;         // (in_h, kIsoTx, 3) after the W pass

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * kIsoTx;
  const int y0 = blockIdx.y * kIsoTy;
  for (int i = threadIdx.x; i < 9 + ksize; i += blockDim.x) s_par[i] = params[i];
  __syncthreads();

  const float sc = scale[n];
  const float m00 = s_par[0], m01 = s_par[1], m02 = s_par[2];
  const float m10 = s_par[3], m11 = s_par[4], m12 = s_par[5];
  const float m20 = s_par[6], m21 = s_par[7], m22 = s_par[8];
  const float* taps = s_par + 9;
  const T* src = img + static_cast<size_t>(n) * h * w * 3;

  for (int i = threadIdx.x; i < in_h * in_w; i += blockDim.x) {
    const int ly = i / in_w;
    const int lx = i - ly * in_w;
    const int gy = reflect101(y0 - r + ly, h);
    const int gx = reflect101(x0 - r + lx, w);
    const T* p = src + (static_cast<size_t>(gy) * w + gx) * 3;
    const float l0 = linearize(load_scaled(p[0], sc));
    const float l1 = linearize(load_scaled(p[1], sc));
    const float l2 = linearize(load_scaled(p[2], sc));
    float* d = s_in + i * 3;
    d[0] = m00 * l0 + m01 * l1 + m02 * l2;
    d[1] = m10 * l0 + m11 * l1 + m12 * l2;
    d[2] = m20 * l0 + m21 * l1 + m22 * l2;
  }
  __syncthreads();

  // W pass: element e = 3*j + c of halo row ly.
  const int row_elems = kIsoTx * 3;
  for (int i = threadIdx.x; i < in_h * row_elems; i += blockDim.x) {
    const int ly = i / row_elems;
    const int e = i - ly * row_elems;
    const float* s = s_in + ly * in_w * 3 + e;
    float acc = 0.0f;
    for (int t = 0; t < ksize; ++t) acc += s[3 * t] * taps[t];
    s_hz[i] = acc;
  }
  __syncthreads();

  // H pass, encode, store (the ragged right and bottom edges are masked).
  uint8_t* dst = out + static_cast<size_t>(n) * h * w * 3;
  for (int i = threadIdx.x; i < kIsoTy * row_elems; i += blockDim.x) {
    const int ly = i / row_elems;
    const int e = i - ly * row_elems;
    const int gy = y0 + ly;
    const int gx = x0 + e / 3;
    if (gy >= h || gx >= w) continue;
    const float* s = s_hz + ly * row_elems + e;
    float acc = 0.0f;
    for (int t = 0; t < ksize; ++t) acc += s[t * row_elems] * taps[t];
    dst[(static_cast<size_t>(gy) * w + x0) * 3 + e] = encode_u8(acc);
  }
}

template <typename T>
int launch_iso(const void* img, void* out, const void* scale, const void* params, int ksize,
               int n, int h, int w, void* stream) {
  if (ksize < 1 || ksize > kIsoMaxTaps || (ksize & 1) == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = iso_smem_bytes(ksize / 2);
  cudaError_t err = cudaFuncSetAttribute(iso_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kIsoTx - 1) / kIsoTx, (h + kIsoTy - 1) / kIsoTy, n);
  iso_kernel<T><<<grid, kIsoThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(img), static_cast<uint8_t*>(out), static_cast<const float*>(scale),
      static_cast<const float*>(params), ksize, h, w);
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
// Bound on this card: float32 operations, close to the byte bound. Per
// pixel 3 channels x (1 + 2r) multiply-adds of the combined per-row kernel
// (r <= 16), a 3x3 mix, six powf; 6 bytes per pixel of traffic.
//
// Design: one block per image row. The row plus an r-pixel reflect-101
// halo is staged once in shared memory, linearized (a 1920-px row is 23 KB
// of float32), with its row of the half-table `tab` and its 3x3 `mix`.
// Each thread then produces whole pixels: paired symmetric taps
// tab[0]*x[j] + sum_d tab[d]*(x[j-d] + x[j+d]) per channel, the per-row
// mix, chroma toward the pixel mean if asked, encode. Every input byte is
// read from device memory once.
// ---------------------------------------------------------------------------

constexpr int kStreakThreads = 256;

size_t streak_smem_bytes(int r, int w) {
  return sizeof(float) * ((static_cast<size_t>(w) + 2 * r) * 3 + (r + 1) + 9);
}

__global__ void __launch_bounds__(kStreakThreads)
streak_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out, const float* __restrict__ scale,
              const float* __restrict__ tab, const float* __restrict__ mix, int r, float keep,
              int use_chroma, int h, int w) {
  extern __shared__ float smem[];
  const int y = blockIdx.x;
  const int n = blockIdx.z;
  float* s_lin = smem;                            // (w + 2r, 3)
  float* s_tab = s_lin + (w + 2 * r) * 3;         // r + 1
  float* s_mix = s_tab + (r + 1);                 // 9

  const float sc = scale[n];
  const size_t row_off = (static_cast<size_t>(n) * h + y) * w * 3;
  const uint8_t* src = img + row_off;
  for (int i = threadIdx.x; i < (w + 2 * r) * 3; i += blockDim.x) {
    const int px = i / 3;
    const int c = i - px * 3;
    s_lin[i] = linearize(load_scaled(src[reflect101(px - r, w) * 3 + c], sc));
  }
  for (int i = threadIdx.x; i <= r; i += blockDim.x) s_tab[i] = tab[static_cast<size_t>(y) * (r + 1) + i];
  if (threadIdx.x < 9) s_mix[threadIdx.x] = mix[static_cast<size_t>(y) * 9 + threadIdx.x];
  __syncthreads();

  uint8_t* dst = out + row_off;
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    float a[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* p = s_lin + (j + r) * 3 + c;
      float acc = p[0] * s_tab[0];
      for (int d = 1; d <= r; ++d) acc += (p[-3 * d] + p[3 * d]) * s_tab[d];
      a[c] = acc;
    }
    float o[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = s_mix[3 * c] * a[0] + s_mix[3 * c + 1] * a[1] + s_mix[3 * c + 2] * a[2];
    if (use_chroma) {
      const float gray = (o[0] + o[1] + o[2]) * (1.0f / 3.0f);
#pragma unroll
      for (int c = 0; c < 3; ++c) o[c] = gray + (o[c] - gray) * keep;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) dst[j * 3 + c] = encode_u8(o[c]);
  }
}

// ---------------------------------------------------------------------------
// Kernel 3: pointwise species (pig: matrix only; rat: matrix + per-row
// S-cone gain on blue).
//
// Replaces animal_vision_tpu/ops/fused_nonuv.py:_pointwise_kernel, reached
// through _pointwise_pallas / fused_pointwise_u8 / fused_scone_tab_u8.
//
// Bound on this card: bytes (6 per pixel against ~24 multiply-adds and six
// powf). Design: one thread per pixel, the 3x3 matrix in registers; a
// later version would move 16-byte vectors per thread.
// ---------------------------------------------------------------------------

constexpr int kPointwiseThreads = 256;

__global__ void __launch_bounds__(kPointwiseThreads)
pointwise_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out, const float* __restrict__ scale,
                 const float* __restrict__ mat9, const float* __restrict__ gain, int h, int w) {
  const size_t px = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t npx = static_cast<size_t>(h) * w;
  if (px >= npx) return;
  const int n = blockIdx.z;
  const float sc = scale[n];
  const size_t off = (static_cast<size_t>(n) * npx + px) * 3;
  const float l0 = linearize(load_scaled(img[off], sc));
  const float l1 = linearize(load_scaled(img[off + 1], sc));
  const float l2 = linearize(load_scaled(img[off + 2], sc));
  const float o0 = mat9[0] * l0 + mat9[1] * l1 + mat9[2] * l2;
  const float o1 = mat9[3] * l0 + mat9[4] * l1 + mat9[5] * l2;
  float o2 = mat9[6] * l0 + mat9[7] * l1 + mat9[8] * l2;
  if (gain != nullptr) o2 = clamp01(o2 * gain[px / w]);
  out[off] = encode_u8(o0);
  out[off + 1] = encode_u8(o1);
  out[off + 2] = encode_u8(o2);
}

}  // namespace

extern "C" {

int av_iso_u8(const void* img, void* out, const void* scale, const void* params, int ksize, int n,
              int h, int w, void* stream) {
  return launch_iso<uint8_t>(img, out, scale, params, ksize, n, h, w, stream);
}

int av_iso_f32(const void* img, void* out, const void* scale, const void* params, int ksize, int n,
               int h, int w, void* stream) {
  return launch_iso<float>(img, out, scale, params, ksize, n, h, w, stream);
}

int av_streak_u8(const void* img, void* out, const void* scale, const void* tab, const void* mix,
                 int r, float keep, int use_chroma, int n, int h, int w, void* stream) {
  const size_t smem = streak_smem_bytes(r, w);
  cudaError_t err = cudaFuncSetAttribute(streak_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, 1, n);
  streak_kernel<<<grid, kStreakThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<uint8_t*>(out), static_cast<const float*>(scale),
      static_cast<const float*>(tab), static_cast<const float*>(mix), r, keep, use_chroma, h, w);
  return static_cast<int>(cudaGetLastError());
}

int av_pointwise_u8(const void* img, void* out, const void* scale, const void* mat9, const void* gain,
                    int n, int h, int w, void* stream) {
  const size_t npx = static_cast<size_t>(h) * w;
  const dim3 grid(static_cast<unsigned>((npx + kPointwiseThreads - 1) / kPointwiseThreads), 1, n);
  pointwise_kernel<<<grid, kPointwiseThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<uint8_t*>(out), static_cast<const float*>(scale),
      static_cast<const float*>(mat9), static_cast<const float*>(gain), h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
