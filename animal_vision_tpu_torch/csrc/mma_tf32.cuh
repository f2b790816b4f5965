// Tensor-core building blocks shared by the redesigned kernels: a warp-level
// float32 product in 3xTF32 on mma.sync.m16n8k8, and cp.async copies into
// shared memory with zero fill.
//
// 3xTF32. A TF32 operand keeps 10 of float32's 23 mantissa bits, so one
// TF32 pass over an inner dimension of 992 is about 1e-3 off a float32
// product. Each operand is split as hi = rna(x), lo = rna(x - hi) (rna:
// round to nearest, ties away from zero, to TF32) and the product is
// accumulated as lo*hi' + hi*lo' first, then hi*hi', in float32; the lo*lo'
// term (about 2^-22 of the product) is dropped. The callers add each
// 16..32-long slice of the inner dimension into a fresh accumulator and
// then into the running sum with an ordinary float32 add, so no float32
// sum passes through more than a dozen tensor-core accumulations.
//
// Fragments of mma.sync.m16n8k8 (row.col, TF32, float32 accumulate), lane
// l with g = l / 4, t = l % 4:
//   A (16 x 8, row major): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//                          a3 = A[g+8][t+4];
//   B (8 x 8, K x N):      b0 = B[t][g], b1 = B[t+4][g];
//   D (16 x 8):            d0 = D[g][2t], d1 = D[g][2t+1], d2 = D[g+8][2t],
//                          d3 = D[g+8][2t+1].
// With A rows at a pitch of 4 (mod 32) floats and B rows at 8 (mod 32),
// the 32 lanes of a fragment load hit 32 distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// cvt.rna.tf32.f32 for finite x: half an ulp of the 10-bit mantissa added
// to the magnitude, then the 13 low bits cleared (two integer operations;
// nvcc expands the cvt into five, with an Inf/NaN test).
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// hi + lo ~= x to about 21 bits. lo is left unmasked: the tensor cores
// ignore a TF32 operand's 13 low bits, so it enters the product as
// rna(x - hi).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment split into hi and lo parts.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// A fragment whose rows g and g + 8 start at row0 and row1 (k offset
// already applied); t = lane % 4.
__device__ __forceinline__ FragA load_a(const float* row0, const float* row1, int t) {
  FragA f;
  split(row0[t], f.hi[0], f.lo[0]);
  split(row1[t], f.hi[1], f.lo[1]);
  split(row0[t + 4], f.hi[2], f.lo[2]);
  split(row1[t + 4], f.hi[3], f.lo[3]);
  return f;
}

// An A fragment of the transpose of a (K, M) row-major tile at pitch
// `pitch`, from the tile's (k0, m0) corner: A[m][k] = T[k][m], so
// a0 = T[k0 + t][m0 + g], a1 = T[k0 + t][m0 + g + 8], a2 = T[k0 + t + 4][m0 + g],
// a3 = T[k0 + t + 4][m0 + g + 8].
__device__ __forceinline__ FragA load_a_t(const float* corner, int pitch, int g, int t) {
  FragA f;
  split(corner[t * pitch + g], f.hi[0], f.lo[0]);
  split(corner[t * pitch + g + 8], f.hi[1], f.lo[1]);
  split(corner[(t + 4) * pitch + g], f.hi[2], f.lo[2]);
  split(corner[(t + 4) * pitch + g + 8], f.hi[3], f.lo[3]);
  return f;
}

// A B fragment of a (K, N) row-major tile at pitch `pitch`, from the
// tile's (k0, n0) corner: b0 = B[k0 + t][n0 + g], b1 = B[k0 + t + 4][n0 + g].
__device__ __forceinline__ FragB load_b(const float* corner, int pitch, int g, int t) {
  FragB f;
  split(corner[t * pitch + g], f.hi[0], f.lo[0]);
  split(corner[(t + 4) * pitch + g], f.hi[1], f.lo[1]);
  return f;
}

// B fragments split once and kept split (ffn_kernel): a lane's
// {hi(b0), hi(b1), lo(b0), lo(b1)} in one uint4. A fragment's 32 lanes are
// 32 consecutive uint4, so each 16-byte load is free of bank conflicts.
__device__ __forceinline__ uint4 split_b(float b0, float b1) {
  uint4 v;
  split(b0, v.x, v.z);
  split(b1, v.y, v.w);
  return v;
}

__device__ __forceinline__ FragB load_b_split(const uint4* frag, int lane) {
  const uint4 v = frag[lane];
  FragB f;
  f.hi[0] = v.x;
  f.hi[1] = v.y;
  f.lo[0] = v.z;
  f.lo[1] = v.w;
  return f;
}

// d += a * b in 3xTF32: the two cross terms, then the large one.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// cp.async of BYTES (4, 8 or 16) from global src to shared dst; when
// `valid` is false nothing is read and dst is zero-filled (src must still
// be a valid address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async copies 4, 8 or 16 bytes");
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Floats per cp.async for rows of `n` floats whose starts are 16-byte
// aligned for n % 4 == 0, 8-byte for n % 2 == 0.
__host__ __device__ constexpr int copy_vec(int n) { return n % 4 == 0 ? 4 : (n % 2 == 0 ? 2 : 1); }

}  // namespace tc
