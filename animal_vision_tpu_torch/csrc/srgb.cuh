// The sRGB curves of the non-UV kernels, and their table forms.
//
// linearize and encode_u8 are the accurate curves (powf, IEEE division; the
// libraries are built without --use_fast_math). The kernels take them
// apart into tables:
// - Decode by table. A uint8 input v scaled by a frame's scale takes one of
//   256 values, so a block fills s_lut[v] = linearize(load_scaled(v, scale))
//   once with these very functions and a staged byte costs one shared load,
//   bit for bit the value it had.
// - Encode by exact thresholds. encode_u8 is a step function of x with 256
//   steps: with T[k] (k = 1..255) the least float32 x for which
//   encode_u8(x) >= k, encode_u8(x) is the count of k with x >= T[k] where
//   encode_u8 does not decrease. The card's powf is not monotone at every
//   ulp: a few floats just past a T[k] give the step below it (one on the
//   H100 with CUDA 12.8, 0x3ef0f95c at step 183). Those are the
//   exceptions: at most one per count k, kept as E[k] = that float and
//   V[k] = encode_u8 there.
//   The device table (kEncTable floats: T[1..255], E[0..255], V[0..255]) is
//   made once per device by launch_encode_table from the card's own
//   encode_u8: T by bisection over float bit patterns in [0, 1] (ordered
//   like their values), then a scan of all 1,065,353,217 floats in [0, 1]
//   for the exceptions. encode_u8_thr estimates the step with __powf; away
//   from a step that is the code, and near one it corrects the estimate by
//   one against T (the estimate is within one step) and replaces an
//   exception. Tests hold encode_u8_thr equal to encode_u8 at
//   all 2^32 float bit patterns (negatives, values above 1 and NaN clamp
//   the same way).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace srgb {

constexpr int kLevels = 256;      // uint8 codes
constexpr int kThresholds = 255;  // T[1..255]
// The device encode table: T[1..255], then E[0..255] (NaN: no exception)
// and V[0..255] (as floats).
constexpr int kEncTable = kThresholds + 2 * kLevels;
// A block's copy: -inf, T[1..255], +inf; E[0..255] (floats); V (bytes).
constexpr int kThrTable = kThresholds + 2;
constexpr int kBlockEncFloats = kThrTable + kLevels;
constexpr int kBlockEncBytes = 4 * kBlockEncFloats + kLevels;
constexpr uint32_t kOneBits = 0x3f800000u;  // 1.0f

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

// A block's encode table in shared memory (kBlockEncBytes, 4-byte aligned).
struct EncTable {
  float* thr;    // kThrTable: -inf, T[1..255], +inf
  float* exc;    // kLevels: E[k]
  uint8_t* val;  // kLevels: V[k]
};

__device__ __forceinline__ EncTable enc_table_at(void* smem) {
  float* f = static_cast<float*>(smem);
  return EncTable{f, f + kThrTable, reinterpret_cast<uint8_t*>(f + kBlockEncFloats)};
}

// encode_u8's s 255 + 0.5 for x in [0, 1] with __powf: within about
// 1.3e-4 of the powf value, so its floor is within one step of the code.
__device__ __forceinline__ float code_estimate(float x) {
  const float s = x <= 0.0031308f ? 12.92f * x : 1.055f * __powf(x, 0.4166666666666667f) - 0.055f;
  return clamp01(s) * 255.0f + 0.5f;
}

// The count of k with x >= T[k] for x in [0, 1], from an estimate k.
__device__ __forceinline__ int threshold_count(float x, int k, const float* __restrict__ thr) {
  k += x >= thr[k + 1];
  k -= x < thr[k];
  return k;
}

// Equal to encode_u8(x) for every float32 x. Where the estimate lies more
// than kSure from an integer its floor is the code and no table is read;
// near a step the thresholds and the exceptions decide.
constexpr float kSure = 1.0f / 1024.0f;

__device__ __forceinline__ uint8_t encode_u8_thr(float x, const EncTable& t) {
  x = clamp01(x);  // NaN -> 0, as in encode_u8
  const float v = code_estimate(x);
  int k = static_cast<int>(v);
  const float frac = v - static_cast<float>(k);
  if (frac > kSure && frac < 1.0f - kSure) return static_cast<uint8_t>(k);
  k = threshold_count(x, k, t.thr);
  return x == t.exc[k] ? t.val[k] : static_cast<uint8_t>(k);
}

// Fill a block's tables from the device encode table `enc`, and s_lut[v] =
// linearize(load_scaled(v, scale)) when s_lut is not null.
__device__ __forceinline__ void fill_tables(float* s_lut, const EncTable& t, const float* __restrict__ enc,
                                            float scale) {
  for (int i = threadIdx.x; i < kThrTable; i += blockDim.x) {
    t.thr[i] = i == 0 ? -INFINITY : (i == kThrTable - 1 ? INFINITY : enc[i - 1]);
  }
  for (int i = threadIdx.x; i < kLevels; i += blockDim.x) {
    t.exc[i] = enc[kThresholds + i];
    t.val[i] = static_cast<uint8_t>(enc[kThresholds + kLevels + i]);
  }
  if (s_lut != nullptr) {
    for (int v = threadIdx.x; v < kLevels; v += blockDim.x) {
      s_lut[v] = linearize(load_scaled(static_cast<uint8_t>(v), scale));
    }
  }
}

// enc[k - 1] = T[k] = the least float32 x with encode_u8(x) >= k, k =
// 1..255, by bisection from encode_u8(0) = 0 and encode_u8(1) = 255 (the
// bisection finds the least such x where encode_u8 steps up once there);
// E[k] = NaN.
__global__ void encode_thresholds_kernel(float* __restrict__ enc) {
  const int k = threadIdx.x;
  enc[kThresholds + k] = __uint_as_float(0x7fc00000u);
  enc[kThresholds + kLevels + k] = 0.0f;
  if (k == 0) return;
  uint32_t lo = 0u, hi = kOneBits;  // encode_u8(lo) < k <= encode_u8(hi)
  while (hi - lo > 1u) {
    const uint32_t mid = lo + (hi - lo) / 2u;
    if (encode_u8(__uint_as_float(mid)) >= k) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  enc[k - 1] = __uint_as_float(hi);
}

// Every float x in [0, 1] where the threshold count differs from
// encode_u8(x) becomes the exception of its count: E = x, V = encode_u8(x).
// status[0] counts the exceptions, status[1] the counts that got two.
__global__ void encode_exceptions_kernel(float* __restrict__ enc, int* __restrict__ status) {
  __shared__ float s_thr[kThrTable];
  for (int i = threadIdx.x; i < kThrTable; i += blockDim.x) {
    s_thr[i] = i == 0 ? -INFINITY : (i == kThrTable - 1 ? INFINITY : enc[i - 1]);
  }
  __syncthreads();
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t bits = blockIdx.x * blockDim.x + threadIdx.x; bits <= kOneBits; bits += stride) {
    const float x = __uint_as_float(bits);
    const int k = threshold_count(x, static_cast<int>(code_estimate(x)), s_thr);
    const uint8_t v = encode_u8(x);
    if (v != k) {
      atomicAdd(status, 1);
      const int was = atomicCAS(reinterpret_cast<int*>(enc + kThresholds + k), 0x7fc00000, static_cast<int>(bits));
      if (was != 0x7fc00000) atomicAdd(status + 1, 1);
      enc[kThresholds + kLevels + k] = static_cast<float>(v);
    }
  }
}

// Make the device encode table (kEncTable floats); status: 2 ints on the
// device, zero on entry.
inline cudaError_t launch_encode_table(float* enc, int* status, cudaStream_t stream) {
  encode_thresholds_kernel<<<1, kLevels, 0, stream>>>(enc);
  encode_exceptions_kernel<<<132 * 16, 256, 0, stream>>>(enc, status);
  return cudaGetLastError();
}

// Compare encode_u8_thr with encode_u8 at the float bit patterns start ..
// start + count - 1: result[0] += the mismatches, result[1] = min(result[1],
// the first mismatching pattern).
__global__ void encode_check_kernel(const float* __restrict__ enc, unsigned long long start,
                                    unsigned long long count, unsigned long long* __restrict__ result) {
  __shared__ __align__(16) unsigned char s_enc[kBlockEncBytes];
  const EncTable t = enc_table_at(s_enc);
  fill_tables(nullptr, t, enc, 0.0f);
  __syncthreads();
  unsigned long long bad = 0, first = ~0ull;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i = static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    const unsigned long long bits = start + i;
    const float x = __uint_as_float(static_cast<uint32_t>(bits));
    if (encode_u8_thr(x, t) != encode_u8(x)) {
      ++bad;
      first = bits < first ? bits : first;
    }
  }
  if (bad != 0) {
    atomicAdd(result, bad);
    atomicMin(result + 1, first);
  }
}

inline cudaError_t launch_encode_check(const float* enc, unsigned long long start, unsigned long long count,
                                       unsigned long long* result, cudaStream_t stream) {
  encode_check_kernel<<<132 * 16, 256, 0, stream>>>(enc, start, count, result);
  return cudaGetLastError();
}

}  // namespace srgb
