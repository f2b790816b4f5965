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
// Bound on this card: operations. Per pixel the two 1x1 maps take
// 2 x 4 C^2 multiply-adds and the depthwise 36 C, against 8 C bytes of
// traffic (x in, out out): 62 flops per byte at C = 31, above the card's
// 20 for float32 outside the tensor cores.
//
// Design (the FFN phase of fused_msab.cu's msab_apply_kernel, on its own).
// One block per TH x TW output tile:
// 1. x over the tile and a 1-pixel halo R1 into shared memory (planar,
//    [channel][pixel]), then its LayerNorm into a second buffer, one thread
//    per pixel;
// 2. the 4C hidden in chunks of C channels: h = gelu(Y W0[:, chunk]) over
//    R1 (zero outside the image: the depthwise conv's zero pad), then
//    gelu(dw3(h)) over the tile, then that chunk's rows of W4 multiplied in
//    and accumulated in registers, each thread keeping its own (output
//    channel, pixel) pairs across the chunks;
// 3. the residual x added from device memory and the tile stored.
// The 4C hidden never reaches device memory. Products are "warp GEMMs": the
// 32 lanes of a warp take 32 pixels, every lane reads the same weight (one
// broadcast load), and the shared-memory reads are conflict-free.
// Shared memory is (2 (TH+2)(TW+2) + TH TW) C floats; the wrapper picks the
// largest tile that fits (8x16, 8x8, 4x8) and raises when none does.
//
// C interface (loaded with ctypes): the entry point takes raw device
// pointers and the stream, launches on that stream without synchronising,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "common.cuh"

namespace {

constexpr int kGroup = 4;  // consecutive output channels a warp takes per step

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float gelu(float x) { return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f)); }

// At C = 62 and 124 one block fills an SM's shared memory, so those blocks
// take 16 warps; at C = 31 several 8-warp blocks share an SM.
template <int C>
struct FfnThreads {
  static constexpr int kThreads = C > 31 ? 512 : 256;
};

template <int C, int TH, int TW>
__host__ __device__ constexpr size_t ffn_smem_floats() {
  return static_cast<size_t>(C) * (2 * (TH + 2) * (TW + 2) + TH * TW);
}

template <int C, int TH, int TW>
__global__ void __launch_bounds__(FfnThreads<C>::kThreads)
ffn_kernel(const float* __restrict__ x, float* __restrict__ out, const float* __restrict__ lnw,
           const float* __restrict__ lnb, const float* __restrict__ w0, const float* __restrict__ dwk,
           const float* __restrict__ w4, int h, int w) {
  constexpr int W1 = TW + 2, N1 = (TH + 2) * W1;  // R1: the tile and its 1-pixel halo
  constexpr int N0 = TH * TW;                     // R0: the tile
  constexpr int C4 = 4 * C;
  constexpr int NT = FfnThreads<C>::kThreads, NW = NT / 32;
  constexpr int NS1 = cdiv(N1, 32), NS0 = cdiv(N0, 32);
  constexpr int G = cdiv(cdiv(C, kGroup), NW);  // output groups per warp in the down product
  extern __shared__ float smem[];
  float* s_y = smem;            // (C, N1): LN(x)
  float* s_h = s_y + C * N1;    // (C, N1): x, then a hidden chunk
  float* s_h2 = s_h + C * N1;   // (C, N0): gelu(dw3(hidden chunk))
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto inside = [&](int gy, int gx) { return gy >= 0 && gy < h && gx >= 0 && gx < w; };
  const float* src = x + static_cast<size_t>(n) * h * w * C;

  // 1. x over R1 (zero outside the image) into s_h, which holds no hidden
  //    chunk yet, then Y = LayerNorm(x) into s_y.
  for (int i = threadIdx.x; i < N1 * C; i += NT) {
    const int p = i / C, c = i - p * C;
    const int gy = y0 - 1 + p / W1, gx = x0 - 1 + p % W1;
    s_h[c * N1 + p] = inside(gy, gx) ? src[(static_cast<size_t>(gy) * w + gx) * C + c] : 0.f;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < N1; p += NT) {
    float mu = 0.f;
    for (int c = 0; c < C; ++c) mu += s_h[c * N1 + p];
    mu /= C;
    float var = 0.f;
    for (int c = 0; c < C; ++c) {
      const float d = s_h[c * N1 + p] - mu;
      var = fmaf(d, d, var);
    }
    var /= C;
    const float inv = 1.0f / sqrtf(var + 1e-5f);
    for (int c = 0; c < C; ++c) s_y[c * N1 + p] = (s_h[c * N1 + p] - mu) * inv * __ldg(lnw + c) + __ldg(lnb + c);
  }
  __syncthreads();

  // The down product's accumulators: output group warp + NW g (channels
  // 4 (warp + NW g) ...), pixels lane + 32 s of the tile.
  float acc[G][NS0][kGroup];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int s = 0; s < NS0; ++s)
#pragma unroll
      for (int q = 0; q < kGroup; ++q) acc[g][s][q] = 0.f;

  for (int k0 = 0; k0 < C4; k0 += C) {
    // 2a. H = gelu(Y W0[:, k0:k0+C]) over R1, zero outside the image.
    for (int o0 = warp * kGroup; o0 < C; o0 += NW * kGroup) {
      const int nq = min(kGroup, C - o0);
      float a[NS1][kGroup];
#pragma unroll
      for (int s = 0; s < NS1; ++s)
#pragma unroll
        for (int q = 0; q < kGroup; ++q) a[s][q] = 0.f;
      const float* wk = w0 + k0 + o0;
      for (int c = 0; c < C; ++c, wk += C4) {
        float b[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) b[q] = q < nq ? __ldg(wk + q) : 0.f;
        const float* row = s_y + c * N1;
#pragma unroll
        for (int s = 0; s < NS1; ++s) {
          const int p = lane + 32 * s;
          const float v = p < N1 ? row[p] : 0.f;
#pragma unroll
          for (int q = 0; q < kGroup; ++q) a[s][q] = fmaf(v, b[q], a[s][q]);
        }
      }
#pragma unroll
      for (int s = 0; s < NS1; ++s) {
        const int p = lane + 32 * s;
        if (p >= N1) continue;
        const bool in = inside(y0 - 1 + p / W1, x0 - 1 + p % W1);
#pragma unroll
        for (int q = 0; q < kGroup; ++q)
          if (q < nq) s_h[(o0 + q) * N1 + p] = in ? gelu(a[s][q]) : 0.f;
      }
    }
    __syncthreads();
    // 2b. H2 = gelu(dw3(H)) over the tile.
    for (int i = threadIdx.x; i < C * N0; i += NT) {
      const int c = i / N0, p = i - c * N0;
      const float* hh = s_h + c * N1 + (p / TW) * W1 + p % TW;
      float v = 0.f;
#pragma unroll
      for (int d = 0; d < 9; ++d) v = fmaf(hh[(d / 3) * W1 + d % 3], __ldg(dwk + d * C4 + k0 + c), v);
      s_h2[i] = gelu(v);
    }
    __syncthreads();
    // 2c. acc += H2 W4[k0:k0+C, :]. The next chunk's 2a writes s_h only,
    //     and its 2b waits at the barrier after 2a, so no barrier here.
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int o0 = (warp + NW * g) * kGroup;
      if (o0 >= C) continue;
      const int nq = min(kGroup, C - o0);
      const float* wk = w4 + static_cast<size_t>(k0) * C + o0;
      for (int c = 0; c < C; ++c, wk += C) {
        float b[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) b[q] = q < nq ? __ldg(wk + q) : 0.f;
        const float* row = s_h2 + c * N0;
#pragma unroll
        for (int s = 0; s < NS0; ++s) {
          const int p = lane + 32 * s;
          const float v = p < N0 ? row[p] : 0.f;
#pragma unroll
          for (int q = 0; q < kGroup; ++q) acc[g][s][q] = fmaf(v, b[q], acc[g][s][q]);
        }
      }
    }
  }

  // 3. out = acc + x over the tile's pixels inside the image.
  float* dst = out + static_cast<size_t>(n) * h * w * C;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int o0 = (warp + NW * g) * kGroup;
    if (o0 >= C) continue;
    const int nq = min(kGroup, C - o0);
#pragma unroll
    for (int s = 0; s < NS0; ++s) {
      const int p = lane + 32 * s;
      const int gy = y0 + p / TW, gx = x0 + p % TW;
      if (p >= N0 || gy >= h || gx >= w) continue;
      const size_t base = (static_cast<size_t>(gy) * w + gx) * C + o0;
#pragma unroll
      for (int q = 0; q < kGroup; ++q)
        if (q < nq) dst[base + q] = acc[g][s][q] + src[base + q];
    }
  }
}

template <int C, int TH, int TW>
int launch_ffn(const float* x, float* out, const float* lnw, const float* lnb, const float* w0, const float* dwk,
               const float* w4, int n, int h, int w, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ffn_smem_floats<C, TH, TW>();
  cudaError_t err = cudaFuncSetAttribute(ffn_kernel<C, TH, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(w, TW), cdiv(h, TH), n);
  ffn_kernel<C, TH, TW><<<grid, FfnThreads<C>::kThreads, smem, stream>>>(x, out, lnw, lnb, w0, dwk, w4, h, w);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_ffn_tile(const float* x, float* out, const float* lnw, const float* lnb, const float* w0,
                    const float* dwk, const float* w4, int n, int h, int w, int th, int tw, cudaStream_t stream) {
  if (th == 8 && tw == 16) return launch_ffn<C, 8, 16>(x, out, lnw, lnb, w0, dwk, w4, n, h, w, stream);
  if (th == 8 && tw == 8) return launch_ffn<C, 8, 8>(x, out, lnw, lnb, w0, dwk, w4, n, h, w, stream);
  if (th == 4 && tw == 8) return launch_ffn<C, 4, 8>(x, out, lnw, lnb, w0, dwk, w4, n, h, w, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// ffn: x/out (n, h, w, c), lnw/lnb (c), w0 (c, 4c), dwk (3, 3, 4c),
// w4 (4c, c); the output tile th x tw is one of 8x16, 8x8, 4x8.
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
  if (c == 31) return launch_ffn_tile<31>(xf, of, gf, bf, uf, df, vf, n, h, w, th, tw, s);
  if (c == 62) return launch_ffn_tile<62>(xf, of, gf, bf, uf, df, vf, n, h, w, th, tw, s);
  if (c == 124) return launch_ffn_tile<124>(xf, of, gf, bf, uf, df, vf, n, h, w, th, tw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The most dynamic shared memory, in bytes, one block may use on the
// current device.
int av_mst_smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
}

}  // extern "C"
