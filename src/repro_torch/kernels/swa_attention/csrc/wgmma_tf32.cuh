// Hopper's warpgroup products (wgmma) in TF32, the tensor memory
// accelerator (TMA) and mbarriers, for the attention kernels at head dim
// <= 64 (B4, the forward, and B5's two backward passes), B5 at head dim 128
// (the "half" kernels) and B4 at head dim 256 (swa_fwd_wg_wide_kernel), in
// swa_attention.cu.
//
// Tiles in shared memory.  Every operand tile is f32, K-major (its product's
// reduction dimension contiguous), cut into chunks of 16 floats: a tile of
// `rows` rows is [width / 16][rows][16], each 64-byte row of a chunk
// swizzled as TMA's CU_TENSOR_MAP_SWIZZLE_64B writes it (the 16-byte unit u
// of row r stored at u ^ ((r >> 1) & 3)).  A chunk's base is 512-byte
// aligned, so the swizzle depends on the row alone.  wgmma reads such a
// tile through a descriptor of layout 64B: 8-row groups 512 bytes apart
// (SBO), and a k-step of 8 floats at the chunk's base plus 32 bytes for the
// odd steps.
//
// TF32 parts.  The tensor cores read an f32 word as TF32 by dropping its 13
// low mantissa bits, so an f32 tile serves as its own big part, trunc(x),
// and small = x - trunc(x) (exact in f32; read truncated in turn) is the
// only part that is computed and stored.  A product a.b in 3xTF32 is then
// a_small.b_big + a_big.b_small + a_big.b_big, three wgmma a k-step in that
// order, into one f32 accumulator.
//
// Fragments of one warpgroup (4 warps, 64 rows; warp w owns rows
// 16w..16w+15, lane l has g = l / 4, t = l % 4):
//   A (m64 x k8, registers)   a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   D (m64 x nN)              d[4i + e] at (g + 8 (e / 2), 8i + 2t + e % 2)
// An accumulator is an A operand if its 8 columns 8i.. are taken as the k
// slots in the order 0, 2, 4, 6, 1, 3, 5, 7 (slot t holds column 2t, slot
// t + 4 column 2t + 1): a = {d[4i], d[4i + 2], d[4i + 1], d[4i + 3]}.  The
// B tile of such a product is written with that order in every 8 of its k
// positions (kperm), so p, dp and ds never leave registers.
//
// All inline PTX of these kernels is in the section marked "PTX" below.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wg {

// The float offset of element (r, c) in a [width / 16][rows][16] tile.
__host__ __device__ __forceinline__ int swz(int r, int c, int rows) {
  const int i = c & 15;
  return (c >> 4) * rows * 16 + r * 16 + ((((i >> 2) ^ (r >> 1)) & 3) << 2) + (i & 3);
}

__device__ __forceinline__ float trunc_tf32(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
__device__ __forceinline__ float small_part(float x) { return x - trunc_tf32(x); }

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma descriptor of a K-major tile at `p` (64B swizzle, 8-row groups
// 512 bytes apart).
__device__ __forceinline__ uint64_t desc(const float* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

// The same descriptor as two words: the low one, which holds the address
// (a tile a k-step further is lo + its offset in 16-byte units), and the
// high one, constant.
__device__ __forceinline__ uint32_t desc_lo(const float* p) {
  return ((smem_addr(p) & 0x3FFFF) >> 4) | (1u << 16);
}
__device__ __forceinline__ uint64_t desc_of(uint32_t lo) {
  return (static_cast<uint64_t>(32u | (2u << 30)) << 32) | lo;
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of a register across the
// asynchronous products (after wait, before the next issue).
__device__ __forceinline__ void reg_fence(float& x) { asm volatile("" : "+f"(x) :: "memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& x) { asm volatile("" : "+r"(x) :: "memory"); }

#define WG_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_D32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_O16(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define WG_O32(d)                                                                            \
  WG_O16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),   \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),          \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= a . b on m64nNk8, a and b in shared memory (SS); acc 0 overwrites d.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  static_assert(N == 32 || N == 64, "m64n32k8 and m64n64k8 only");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WG_D16 ", %16, %17, p, 1, 1;\n}\n"
        : WG_O16(d)
        : "l"(a), "l"(b), "r"(acc));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_D32 ", %32, %33, p, 1, 1;\n}\n"
        : WG_O32(d)
        : "l"(a), "l"(b), "r"(acc));
  }
}

// d (+)= a . b on m64nNk8, a a register fragment (RS).
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                       int acc) {
  static_assert(N == 32 || N == 64, "m64n32k8 and m64n64k8 only");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WG_D16
        ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : WG_O16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : WG_O32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
}

#undef WG_D16
#undef WG_D32
#undef WG_O16
#undef WG_O32

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}
// Expect `bytes` more from TMA in the barrier's current phase.
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Wait until the phase of parity `parity` has completed.  A phase that has
// not completed after 2^26 polls (seconds, where a kernel takes
// milliseconds) traps: the launch fails instead of hanging the card.  The
// polling loop is one PTX block, so that no divergent C++ path precedes a
// warpgroup's next wgmma (with the loop in C++, ptxas serialised the wide
// forward's wgmma, C7520).
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\nsetp.eq.u32 p, n, 67108864;\n@p trap;\n"
      "bra.uni WAIT;\n"
      "DONE:\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// A box of the 3-D tensor map `map` at (c0, c1, c2) into shared memory at
// dst; completion counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const void* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Order this thread's shared-memory writes before later reads by the async
// proxy (wgmma) of any thread that synchronises with it.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The registers a thread of this warpgroup may use from here on (the
// producer gives up what the consumers take; setmaxnreg).
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// A barrier of the first `threads` threads of the block (id >= 1; id 0 is
// __syncthreads').
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- end PTX --------------------------------------------------------------

}  // namespace wg
