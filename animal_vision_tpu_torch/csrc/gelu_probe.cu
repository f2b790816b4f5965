// The cost of an activation's arithmetic on the card's float units, for
// chip_smoke.py.
//
// Counterpart of the TPU probe tools/exp_vpu_bf16.py:55 (make_kernel and
// the pallas_call of bench), which asked whether the TPU's vector unit runs
// packed bf16 at twice its f32 rate. The same (rows, cols) arrays, f32 or
// bf16, pass through kernels that each apply one function `reps` times in a
// row to every element, in registers:
// - case 0, gelu_deg11: the fused-MSAB GELU polynomial (ops/fused_msab.py:98
//   of the JAX package): clip to +-5, v = x^2/12.5 - 1, two Horner chains
//   of depth 5 over w = v^2, x (0.5 + xc (ge + v go));
// - case 1, gelu_deg7: the same form at degree 7, clip +-4, v = x^2/8 - 1,
//   placeholder coefficients (the first six of the degree-11 set);
// - case 2, madd3x3: nine multiply-adds of each element and its two row
//   neighbours, the rows wrapping around inside each 512-row slab;
// - case 3, single_madd: v * 1.0001 + 0.0001;
// - case 4, gelu_erf: 0.5 x (1 + erff(x / sqrt 2)), the port's GELU
//   (csrc/fused_mst.cu, csrc/fused_msab.cu), which the TPU probe lacked.
// f32 runs on float (FFMA, FMUL, FMNMX); bf16 on __nv_bfloat162 pairs
// (HFMA2.BF16, HMUL2, HMNMX2), so that one instruction does two elements;
// gelu_erf's bf16 case computes in float per pair (there is no bf16 erf).
//
// What bounds it: operations. Each element is read and written once and
// takes 64 to 256 applications of 2 to 20 operations, so the time over
// the element count says what one application costs. Elementwise cases: a
// thread takes 16 bytes (4 floats or 4 bf16 pairs) and runs their 4
// independent chains, so that the pipes see 4 chains per warp. madd3x3: a
// block of 512 threads holds one slab's 512 rows of a 16-column strip in
// shared memory (32 KB f32, 16 KB bf16); each thread keeps its W rows of one
// column unit in registers, reads its row neighbours from shared memory,
// and the block syncs before and after writing the new rows back, once per
// rep; f32 and bf16 launch the same grid, so bf16 runs half the
// instructions per element pair.
//
// C interface (loaded with ctypes): raw device pointers and the stream,
// launches without synchronising, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlab = 512;        // madd3x3: rows that wrap around
constexpr int kSlabThreads = 512;  // madd3x3: threads per block
constexpr int kStripCols = 16;    // madd3x3: columns per block

// _GELU_COEF of the JAX package's ops/fused_msab.py:91
__constant__ float kGeluCoef[12] = {
    1.413638139e-01f, -7.029590887e-02f, 5.154378282e-02f, -4.045128240e-02f,
    3.117513943e-02f, -2.321312828e-02f, 1.752299849e-02f, -1.130712491e-02f,
    4.284632193e-03f, -2.526916729e-03f, 3.580725317e-03f, -1.676730979e-03f,
};

struct F32 {
  using T = float;
  static constexpr int kPerUnit = 1;
  __device__ __forceinline__ static T c(float v) { return v; }
  __device__ __forceinline__ static T fma(T a, T b, T d) { return fmaf(a, b, d); }
  __device__ __forceinline__ static T mul(T a, T b) { return __fmul_rn(a, b); }
  __device__ __forceinline__ static T clamp(T x, T lo, T hi) { return fminf(fmaxf(x, lo), hi); }
  __device__ __forceinline__ static T gelu_erf(T x) { return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f)); }
};

struct BF16 {
  using T = __nv_bfloat162;
  static constexpr int kPerUnit = 2;
  __device__ __forceinline__ static T c(float v) { return __float2bfloat162_rn(v); }
  __device__ __forceinline__ static T fma(T a, T b, T d) { return __hfma2(a, b, d); }
  __device__ __forceinline__ static T mul(T a, T b) { return __hmul2(a, b); }
  __device__ __forceinline__ static T clamp(T x, T lo, T hi) { return __hmin2(__hmax2(x, lo), hi); }
  __device__ __forceinline__ static T gelu_erf(T x) {
    const float2 f = __bfloat1622float2(x);
    return __floats2bfloat162_rn(F32::gelu_erf(f.x), F32::gelu_erf(f.y));
  }
};

// The constants of every case, in the unit's type, made once per thread.
template <class O>
struct Consts {
  typename O::T coef[12], lo5, hi5, lo4, hi4, inv125, inv8, m1, half, m[9], k1, k2;
  __device__ __forceinline__ Consts() {
#pragma unroll
    for (int i = 0; i < 12; ++i) coef[i] = O::c(kGeluCoef[i]);
    lo5 = O::c(-5.0f), hi5 = O::c(5.0f), lo4 = O::c(-4.0f), hi4 = O::c(4.0f);
    inv125 = O::c(1.0f / 12.5f), inv8 = O::c(1.0f / 8.0f), m1 = O::c(-1.0f), half = O::c(0.5f);
    const float mv[9] = {1.1f, 0.9f, 0.8f, 0.7f, 0.6f, 0.5f, 0.4f, 0.3f, 0.2f};
#pragma unroll
    for (int i = 0; i < 9; ++i) m[i] = O::c(mv[i]);
    k1 = O::c(1.0001f), k2 = O::c(0.0001f);
  }
};

template <class O>
__device__ __forceinline__ typename O::T gelu_deg11(typename O::T x, const Consts<O>& k) {
  using T = typename O::T;
  const T xc = O::clamp(x, k.lo5, k.hi5);
  const T v = O::fma(O::mul(xc, xc), k.inv125, k.m1);
  const T w = O::mul(v, v);
  T ge = k.coef[10], go = k.coef[11];
#pragma unroll
  for (int i = 8; i >= 0; i -= 2) {
    ge = O::fma(ge, w, k.coef[i]);
    go = O::fma(go, w, k.coef[i + 1]);
  }
  return O::mul(x, O::fma(xc, O::fma(v, go, ge), k.half));
}

template <class O>
__device__ __forceinline__ typename O::T gelu_deg7(typename O::T x, const Consts<O>& k) {
  using T = typename O::T;
  const T xc = O::clamp(x, k.lo4, k.hi4);
  const T v = O::fma(O::mul(xc, xc), k.inv8, k.m1);
  const T w = O::mul(v, v);
  const T ge = O::fma(O::fma(k.coef[4], w, k.coef[2]), w, k.coef[0]);
  const T go = O::fma(O::fma(k.coef[5], w, k.coef[3]), w, k.coef[1]);
  return O::mul(x, O::fma(xc, O::fma(v, go, ge), k.half));
}

// y*1.1 + a*0.9 + b*0.8 + y*0.7 + a*0.6 + b*0.5 + y*0.4 + a*0.3 + b*0.2,
// left to right: one multiply, then eight multiply-adds
template <class O>
__device__ __forceinline__ typename O::T madd3(typename O::T y, typename O::T a, typename O::T b,
                                               const Consts<O>& k) {
  typename O::T acc = O::mul(y, k.m[0]);
  acc = O::fma(a, k.m[1], acc);
  acc = O::fma(b, k.m[2], acc);
  acc = O::fma(y, k.m[3], acc);
  acc = O::fma(a, k.m[4], acc);
  acc = O::fma(b, k.m[5], acc);
  acc = O::fma(y, k.m[6], acc);
  acc = O::fma(a, k.m[7], acc);
  return O::fma(b, k.m[8], acc);
}

template <int CASE, class O>
__device__ __forceinline__ typename O::T apply(typename O::T x, const Consts<O>& k) {
  if constexpr (CASE == 0) return gelu_deg11<O>(x, k);
  else if constexpr (CASE == 1) return gelu_deg7<O>(x, k);
  else if constexpr (CASE == 3) return O::fma(x, k.k1, k.k2);
  else return O::gelu_erf(x);
}

// 16 bytes per thread: 4 units (4 floats, 4 bf16 pairs), 4 chains.
template <int CASE, class O>
__global__ void __launch_bounds__(kThreads) pointwise_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                                                             int64_t n16, int reps) {
  using T = typename O::T;
  static_assert(sizeof(T) == 4, "a unit is 4 bytes");
  const Consts<O> k;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < n16;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    uint4 raw = x[i];
    T u[4];
    memcpy(u, &raw, sizeof(raw));
    for (int r = 0; r < reps; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) u[j] = apply<CASE, O>(u[j], k);
    }
    memcpy(&raw, u, sizeof(raw));
    y[i] = raw;
  }
}

// madd3x3: one block per (512-row slab, 16-column strip). W units per row
// (16 floats or 8 bf16 pairs); G = 512 / W row groups; thread (g, c) holds
// rows g, g + G, ... (W of them) of unit column c.
template <class O>
__global__ void __launch_bounds__(kSlabThreads) madd3x3_kernel(const typename O::T* __restrict__ x,
                                                              typename O::T* __restrict__ y, int units, int reps) {
  using T = typename O::T;
  constexpr int W = kStripCols / O::kPerUnit;
  constexpr int G = kSlabThreads / W;
  constexpr int R = kSlab / G;  // rows per thread (= W)
  __shared__ __align__(16) uint32_t s_raw[kSlab][W];  // raw words: T has constructors
  T(*s)[W] = reinterpret_cast<T(*)[W]>(s_raw);
  const Consts<O> k;
  const int c = threadIdx.x % W, g = threadIdx.x / W;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * W + c;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kSlab;
  T v[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    v[j] = x[(row0 + g + G * j) * units + col];
    s[g + G * j][c] = v[j];
  }
  __syncthreads();
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int row = g + G * j;
      v[j] = madd3<O>(v[j], s[(row + 1) & (kSlab - 1)][c], s[(row + kSlab - 1) & (kSlab - 1)][c], k);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < R; ++j) s[g + G * j][c] = v[j];
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < R; ++j) y[(row0 + g + G * j) * units + col] = v[j];
}

template <int CASE, class O>
int launch_pointwise(const void* x, void* y, int64_t n_bytes, int reps, cudaStream_t stream) {
  const int64_t n16 = n_bytes / 16;
  const int64_t blocks = (n16 + kThreads - 1) / kThreads;
  pointwise_kernel<CASE, O><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), n16, reps);
  return static_cast<int>(cudaGetLastError());
}

template <class O>
int launch_madd(const void* x, void* y, int rows, int cols, int reps, cudaStream_t stream) {
  const int units = cols / O::kPerUnit;
  const dim3 grid(cols / kStripCols, rows / kSlab);
  madd3x3_kernel<O><<<grid, kSlabThreads, 0, stream>>>(static_cast<const typename O::T*>(x),
                                                       static_cast<typename O::T*>(y), units, reps);
  return static_cast<int>(cudaGetLastError());
}

template <class O>
int launch_case(int which, const void* x, void* y, int rows, int cols, int reps, cudaStream_t s) {
  const int64_t n_bytes = static_cast<int64_t>(rows) * cols * (sizeof(typename O::T) / O::kPerUnit);
  switch (which) {
    case 0: return launch_pointwise<0, O>(x, y, n_bytes, reps, s);
    case 1: return launch_pointwise<1, O>(x, y, n_bytes, reps, s);
    case 2: return launch_madd<O>(x, y, rows, cols, reps, s);
    case 3: return launch_pointwise<3, O>(x, y, n_bytes, reps, s);
    case 4: return launch_pointwise<4, O>(x, y, n_bytes, reps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Case `which` (0 gelu_deg11, 1 gelu_deg7, 2 madd3x3, 3 single_madd,
// 4 gelu_erf) `reps` times over x -> y, (rows, cols) contiguous, bf16 when
// `bf16` else float32. The pointwise cases need rows * cols * element size a
// multiple of 16 bytes; madd3x3 needs rows a multiple of 512 and cols of 16.
// Other shapes return cudaErrorInvalidValue.
int av_gelu_probe(const void* x, void* y, int which, int bf16, int rows, int cols, int reps, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t bytes = static_cast<int64_t>(rows) * cols * (bf16 ? 2 : 4);
  if (rows <= 0 || cols <= 0 || reps < 0 || bytes % 16 != 0 ||
      (which == 2 && (rows % kSlab != 0 || cols % kStripCols != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? launch_case<BF16>(which, x, y, rows, cols, reps, s) : launch_case<F32>(which, x, y, rows, cols, reps, s);
}

}  // extern "C"
