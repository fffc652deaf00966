// Error-compensated TF32 ("3xTF32") products on Hopper's tensor cores with
// mma.sync.m16n8k8, and cp.async copies into shared memory.
//
// An f32 value x is split into big = tf32(x) and small = tf32(x - big),
// both rounded to nearest with ties away, as cvt.rna.tf32.f32 rounds.  A
// product a.b is then a_small.b_big + a_big.b_small + a_big.b_big,
// accumulated in f32, small terms first: what is dropped (a_small.b_small and the rounding of the
// small terms) is ~2^-22 of |a.b|, so the result holds to f32 accuracy,
// where one TF32 product keeps ~2^-11.
//
// Fragments follow the PTX ISA's m16n8k8 .tf32 layout.  In a warp, lane
// l has g = l / 4 and t = l % 4:
//   A (16 x 8, row)  a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)   a3 (g + 8, t + 4)
//   B (8 x 8, col)   b0 (t, g)   b1 (t + 4, g)
//   C (16 x 8)       c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// A C fragment is an A fragment if the 8 columns it covers are taken as
// the k slots in the order 0, 2, 4, 6, 1, 3, 5, 7 (slot t holds column 2t,
// slot t + 4 column 2t + 1).  The k order of a product is free as long as
// both operands use the same one, so a product whose A operand is a
// result in registers (p^T.do, ds^T.q, ds.k) reads its B operand with
// that order (load_b_kperm) and the result never goes through shared
// memory.
//
// Shared-memory tiles are f32, row-major with a pitch of (width + 4)
// floats: with pitch / 4 odd, every fragment load below touches 32
// distinct banks.
//
// All inline PTX of the attention kernels is in the section marked "PTX"
// below; the rest is index arithmetic on top of it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tf32 {

// ---- PTX ------------------------------------------------------------------

// d += a . b on one m16n8k8 tile, the warp's 32 lanes together.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes from global to shared memory, asynchronously; zero when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

// Close the group of copies this thread has issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ---- end PTX --------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits), nearest with ties away from zero:
// what cvt.rna.tf32.f32 gives for a finite x, in two integer instructions
// on the bits (half of the dropped unit added to the magnitude, then the
// 13 low bits cleared), where ptxas expands cvt.rna into a longer sequence
// (chip_ablate_attention.py times both).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a . b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4], const uint32_t (&b_big)[2],
                                     const uint32_t (&b_small)[2]) {
  mma(d, a_small, b_big);
  mma(d, a_big, b_small);
  mma(d, a_big, b_big);
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A(r, k) = mult * s[(row0 + r) * pitch + k0 + k]: rows of a tile, k along them.
__device__ __forceinline__ void load_a(const float* s, int pitch, int row0, int k0, float mult,
                                       uint32_t (&big)[4], uint32_t (&small)[4]) {
  const float* p = s + (row0 + lane_g()) * pitch + k0 + lane_t();
  split(mult * p[0], big[0], small[0]);
  split(mult * p[8 * pitch], big[1], small[1]);
  split(mult * p[4], big[2], small[2]);
  split(mult * p[8 * pitch + 4], big[3], small[3]);
}

// A fragment of a tile split in place by split_tile: big parts in `big`,
// small parts at the same places in `small`.
__device__ __forceinline__ void load_a_split(const float* big, const float* small, int pitch,
                                             int row0, int k0, uint32_t (&b)[4],
                                             uint32_t (&s)[4]) {
  const int at = (row0 + lane_g()) * pitch + k0 + lane_t();
  const int off[4] = {0, 8 * pitch, 4, 8 * pitch + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b[i] = __float_as_uint(big[at + off[i]]);
    s[i] = __float_as_uint(small[at + off[i]]);
  }
}

// Split the n floats of `tile` (times mult) once for many fragment loads:
// big parts in place, small parts to `small`; the block's threads share it.
__device__ __forceinline__ void split_tile(float* tile, float* small, int n, float mult) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t b, s;
    split(mult * tile[i], b, s);
    tile[i] = __uint_as_float(b);
    small[i] = __uint_as_float(s);
  }
}

// B(k, n) = mult * s[(n0 + n) * pitch + k0 + k]: the transpose of a tile's
// rows n0..n0+7 (q.k^T, do.v^T and their transposes).
__device__ __forceinline__ void load_b(const float* s, int pitch, int n0, int k0, float mult,
                                       uint32_t (&big)[2], uint32_t (&small)[2]) {
  const float* p = s + (n0 + lane_g()) * pitch + k0 + lane_t();
  split(mult * p[0], big[0], small[0]);
  split(mult * p[4], big[1], small[1]);
}

// B(k, n) = mult * s[(k0 + k) * pitch + n0 + n], its k slots in the order
// of an A fragment taken from a C fragment (slot t: row 2t, t + 4: 2t + 1).
__device__ __forceinline__ void load_b_kperm(const float* s, int pitch, int k0, int n0,
                                             float mult, uint32_t (&big)[2],
                                             uint32_t (&small)[2]) {
  const float* p = s + (k0 + 2 * lane_t()) * pitch + n0 + lane_g();
  split(mult * p[0], big[0], small[0]);
  split(mult * p[pitch], big[1], small[1]);
}

// The A fragment (k slots permuted as load_b_kperm's) of a C fragment.
__device__ __forceinline__ void a_from_c(const float (&c)[4], uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
  split(c[0], big[0], small[0]);
  split(c[2], big[1], small[1]);
  split(c[1], big[2], small[2]);
  split(c[3], big[3], small[3]);
}

}  // namespace tf32
