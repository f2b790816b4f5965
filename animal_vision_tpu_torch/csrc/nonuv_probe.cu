// An ablation of the non-UV kernels' cost per element, for chip_smoke.py.
//
// Counterpart of the TPU probe tools/exp_micro.py:28 (make, k_pass,
// k_gamma, k_mix, k_taps): the same uint8 frames, (N, H, W, 3)
// interleaved, pass through kernels that each add one part of a species
// chain, so that the differences of their times say what each part costs
// on this card:
// - curve 0, copy: scale, clip, *255 + 0.5, truncate;
// - curve 1, the accurate sRGB curves: linearize and encode_u8 by powf;
// - curve 2, the table forms: decode by a 256-entry table, encode by the
//   exact thresholds (srgb.cuh);
// - mix: a 3x3 colour matrix between the curves;
// - K taps: a K-tap uniform filter along W over the decoded, mixed row
//   (rows staged in shared memory, borders clamped), K = 12 or 28.
// Each block takes rows y = blockIdx.x, blockIdx.x + gridDim.x, ... of
// frame blockIdx.z and fills its tables once. The table variants give the
// accurate variants' bytes exactly, which chip_smoke.py checks.
//
// C interface (loaded with ctypes): raw device pointers and the stream,
// launches without synchronising, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "srgb.cuh"

namespace {

constexpr int kProbeThreads = 256;
constexpr int kProbeRowBlocks = 264;  // blocks per frame: 2 per SM of an H100 with 4 frames
constexpr int kEncFloats = (srgb::kBlockEncBytes + 15) / 16 * 4;  // the block's encode table, in floats

template <int CURVE>
__device__ __forceinline__ float decode(uint8_t v, float sc, const float* s_lut) {
  if constexpr (CURVE == 2) return s_lut[v];
  else if constexpr (CURVE == 1) return srgb::linearize(srgb::load_scaled(v, sc));
  else return srgb::load_scaled(v, sc);
}

template <int CURVE>
__device__ __forceinline__ uint8_t encode(float x, const srgb::EncTable& t) {
  if constexpr (CURVE == 2) return srgb::encode_u8_thr(x, t);
  else if constexpr (CURVE == 1) return srgb::encode_u8(x);
  else return static_cast<uint8_t>(x * 255.0f + 0.5f);
}

template <int CURVE, bool MIX, int K>
__global__ void __launch_bounds__(kProbeThreads)
probe_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out, const float* __restrict__ scale,
             const float* __restrict__ enc, const float* __restrict__ mat9, int h, int w) {
  extern __shared__ __align__(16) float smem[];
  float* s_lut = smem;                                              // 256
  const srgb::EncTable t = srgb::enc_table_at(s_lut + srgb::kLevels);  // kBlockEncBytes
  float* s_row = s_lut + srgb::kLevels + kEncFloats;                // (w + K - 1) * 3 when K > 0
  const int n = blockIdx.z;
  const float sc = scale[n];
  if (CURVE == 2) srgb::fill_tables(s_lut, t, enc, sc);
  __syncthreads();
  float m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = MIX ? mat9[i] : 0.0f;
  const float tap = 1.0f / static_cast<float>(K > 0 ? K : 1);

  for (int y = blockIdx.x; y < h; y += gridDim.x) {
    const size_t row = (static_cast<size_t>(n) * h + y) * w * 3;
    const uint8_t* src = img + row;
    uint8_t* dst = out + row;
    if constexpr (K == 0) {
      for (int px = threadIdx.x; px < w; px += blockDim.x) {
        float l[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) l[c] = decode<CURVE>(src[px * 3 + c], sc, s_lut);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float o = MIX ? m[3 * c] * l[0] + m[3 * c + 1] * l[1] + m[3 * c + 2] * l[2] : l[c];
          dst[px * 3 + c] = encode<CURVE>(o, t);
        }
      }
    } else {
      for (int i = threadIdx.x; i < w + K - 1; i += blockDim.x) {
        const int px = min(max(i - K / 2, 0), w - 1);
        float l[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) l[c] = decode<CURVE>(src[px * 3 + c], sc, s_lut);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          s_row[i * 3 + c] = MIX ? m[3 * c] * l[0] + m[3 * c + 1] * l[1] + m[3 * c + 2] * l[2] : l[c];
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < w * 3; e += blockDim.x) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < K; ++t) acc = fmaf(s_row[e + 3 * t], tap, acc);
        dst[e] = encode<CURVE>(acc, t);
      }
      __syncthreads();
    }
  }
}

template <int CURVE, bool MIX, int K>
int launch_probe(const void* img, void* out, const void* scale, const void* enc, const void* mat9, int n, int h,
                 int w, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (srgb::kLevels + kEncFloats + (K > 0 ? (w + K - 1) * 3 : 0));
  cudaError_t err = cudaFuncSetAttribute(probe_kernel<CURVE, MIX, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(min(h, kProbeRowBlocks), 1, n);
  probe_kernel<CURVE, MIX, K><<<grid, kProbeThreads, smem, stream>>>(
      static_cast<const uint8_t*>(img), static_cast<uint8_t*>(out), static_cast<const float*>(scale),
      static_cast<const float*>(enc), static_cast<const float*>(mat9), h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One probe variant over img/out (n, h, w, 3) uint8: curve 0 (copy), 1
// (powf) or 2 (tables; enc: the device encode table of
// ops/fused_nonuv.py:encode_table); mix 0 or 1; k 0, 12 or 28 (with mix).
// Other combinations return cudaErrorInvalidValue.
int av_nonuv_probe(const void* img, void* out, const void* scale, const void* enc, const void* mat9, int curve,
                   int mix, int k, int n, int h, int w, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int key = curve * 1000 + mix * 100 + k;
  switch (key) {
    case 0: return launch_probe<0, false, 0>(img, out, scale, enc, mat9, n, h, w, s);
    case 1000: return launch_probe<1, false, 0>(img, out, scale, enc, mat9, n, h, w, s);
    case 2000: return launch_probe<2, false, 0>(img, out, scale, enc, mat9, n, h, w, s);
    case 2100: return launch_probe<2, true, 0>(img, out, scale, enc, mat9, n, h, w, s);
    case 2112: return launch_probe<2, true, 12>(img, out, scale, enc, mat9, n, h, w, s);
    case 2128: return launch_probe<2, true, 28>(img, out, scale, enc, mat9, n, h, w, s);
    case 1100: return launch_probe<1, true, 0>(img, out, scale, enc, mat9, n, h, w, s);
    case 1128: return launch_probe<1, true, 28>(img, out, scale, enc, mat9, n, h, w, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
