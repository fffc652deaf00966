// B4d: decode attention, one query token against a KV cache, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces no Pallas kernel.  The JAX package runs decode attention as jnp
// (src/repro/models/layers.py:280-289, the cache branch of `attention`):
//   _sdpa(q, ck, cv, _mask_bias(positions, cache_pos, causal, window, 0, k_valid))
// at one query position.  The port's attention launches a hand-written
// kernel on the card or raises, so this is B4's decode variant, as B1m is
// B1's masked one.
//
// What it computes.  q [B, 1, H, hd]; k and v [B, C, K, hd] (the cache, H =
// G*K, head h reads kv head h / G), row-major, f32 or bf16; cache_pos [C]
// int32, the position held in each slot (-1: never written; any order once
// the ring wraps); q_pos [1] int32 on the device, the query's position.  A
// slot is visible when 0 <= p <= q_pos and, under a window W > 0,
// p > q_pos - W.  o = softmax((scale*q).k^T over the visible slots).v,
// written in the input dtype; a row with no visible slot is NaN, which is
// what the reference's softmax over an all -inf row gives.
//
// What bounds it: bytes.  Every slot of k and v is read once for the G
// query heads that share it, 2*C*hd*4 bytes of f32 per (b, kv head) against
// 4*G*C*hd operations: G <= 16 operations a byte, far under the ~20 at
// which the CUDA cores (67 TFLOP/s f32) overtake HBM (3.35 TB/s).
//
// Design (simple first).  A block of 128 threads (4 warps) per (b, kv
// head), so the G query heads of a kv head share each k/v tile in shared
// memory.  q is staged once, scaled by 1/sqrt(hd).  The block walks the
// cache in tiles of 32 slots: the tile's k (row pitch hd + 1, so lane t
// reads row t conflict-free), v (pitch hd) and positions are staged as f32,
// then warp w takes query heads w, w + 4, ...: lane t scores slot t, the
// warp's max and sum go through shuffles, the online softmax rescales the
// f32 accumulator (lane l holds dims l, l + 32, ...) and adds p.v with p
// broadcast from shared memory.  Nothing is padded: slots past C are
// masked.  No atomics: a result repeats bit for bit.
// With one block per (b, kv head) the grid is B*K blocks (24 at the
// smollm-135m serve shape, 16 at qwen2-1.5b's), far fewer than the 132
// SMs, so a long cache runs at a fraction of the bytes bound: splitting
// the slots over blocks (flash-decoding) is the redesign (ROADMAP B).

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;             // cache slots a tile: one a lane
constexpr int kMaxGroup = 16;         // query heads a kv head (G = H / K)
constexpr int kHeadsPerWarp = kMaxGroup / kWarps;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct DecodeShape {
  int B, C, H, K, G;
  int window;  // 0: every filled slot up to the query; else (q_pos - window, q_pos]
  float scale;
};

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
swa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ cache_pos, const int* __restrict__ q_pos,
                  T* __restrict__ o, DecodeShape sh) {
  constexpr int NPL = (HD + 31) / 32;  // accumulator dims a lane
  extern __shared__ float smem[];
  float* qs = smem;                            // [G][HD], scaled
  float* ks = qs + sh.G * HD;                  // [kTile][HD + 1]
  float* vs = ks + kTile * (HD + 1);           // [kTile][HD]
  float* ps = vs + kTile * HD;                 // [kWarps][kTile]
  int* tpos = reinterpret_cast<int*>(ps + kWarps * kTile);  // [kTile]

  const int b = blockIdx.x / sh.K, kvh = blockIdx.x - b * sh.K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qp = *q_pos;
  const float neg_inf = __int_as_float(0xff800000u);
  const long long q_row = static_cast<long long>(b) * sh.H + static_cast<long long>(kvh) * sh.G;
  for (int i = threadIdx.x; i < sh.G * HD; i += kThreads) {
    qs[i] = sh.scale * to_f32(q[q_row * HD + i]);
  }

  float m[kHeadsPerWarp], l[kHeadsPerWarp], acc[kHeadsPerWarp][NPL];
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    m[j] = neg_inf;
    l[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) acc[j][i] = 0.0f;
  }

  for (int c0 = 0; c0 < sh.C; c0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
#pragma unroll 8
    for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
      const int t = i / HD, d = i - t * HD;
      const int c = c0 + t;
      float kv = 0.0f, vv = 0.0f;
      if (c < sh.C) {
        const long long off = ((static_cast<long long>(b) * sh.C + c) * sh.K + kvh) * HD + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[t * (HD + 1) + d] = kv;
      vs[t * HD + d] = vv;
    }
    if (threadIdx.x < kTile) {
      const int c = c0 + threadIdx.x;
      tpos[threadIdx.x] = c < sh.C ? cache_pos[c] : -1;
    }
    __syncthreads();

    const int p = tpos[lane];
    const bool ok = p >= 0 && p <= qp && (sh.window <= 0 || p > qp - sh.window);
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      const int g = warp + kWarps * j;
      if (g >= sh.G) break;  // warp-uniform
      float s = neg_inf;
      if (ok) {
        const float* qr = qs + g * HD;
        const float* kr = ks + lane * (HD + 1);
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot;
      }
      const float m_new = fmaxf(m[j], warp_max(s));
      if (m_new == neg_inf) continue;  // warp-uniform: nothing visible yet
      const float pr = ok ? expf(s - m_new) : 0.0f;
      const float corr = expf(m[j] - m_new);  // 0 while m was -inf
      l[j] = l[j] * corr + warp_sum(pr);
      m[j] = m_new;
      ps[warp * kTile + lane] = pr;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int d = lane + 32 * i;
        if (d < HD) {
          float a = acc[j][i] * corr;
#pragma unroll 8
          for (int t = 0; t < kTile; ++t) a = fmaf(ps[warp * kTile + t], vs[t * HD + d], a);
          acc[j][i] = a;
        }
      }
      __syncwarp();  // ps is rewritten by the next head
    }
  }

  const float nan = __int_as_float(0x7fc00000u);
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    const int g = warp + kWarps * j;
    if (g >= sh.G) break;
    const float inv = l[j] > 0.0f ? 1.0f / l[j] : nan;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) o[(q_row + g) * HD + d] = from_f32<T>(l[j] > 0.0f ? acc[j][i] * inv : nan);
    }
  }
}

template <int HD, typename T>
int decode(const void* q, const void* k, const void* v, const int* cache_pos, const int* q_pos,
           void* o, const DecodeShape& sh, cudaStream_t stream) {
  const size_t smem =
      (sh.G * HD + kTile * (HD + 1) + kTile * HD + kWarps * kTile + kTile) * sizeof(float);
  swa_decode_kernel<HD, T><<<sh.B * sh.K, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), cache_pos,
      q_pos, static_cast<T*>(o), sh);
  return static_cast<int>(cudaGetLastError());
}

#define DECODE_CASE(HD)                                                              \
  case HD:                                                                           \
    return dtype == 0                                                                \
               ? decode<HD, float>(q, k, v, cache_pos, q_pos, o, sh, st)             \
               : decode<HD, __nv_bfloat16>(q, k, v, cache_pos, q_pos, o, sh, st);

}  // namespace

extern "C" {

// Launches on `stream` and returns a cudaError_t (0 = launched).  Tensors
// are contiguous: q and o [B, 1, H, hd], k and v [B, C, K, hd]; cache_pos
// [C] and q_pos [1] int32 on the device.  dtype 0 is f32, 1 is bf16;
// H / K <= 16 (at most 41.7 KB of shared memory, under the 48 KB default).
int swa_decode(const void* q, const void* k, const void* v, const int* cache_pos,
               const int* q_pos, void* o, int dtype, int B, int C, int H, int K, int hd,
               int window, float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 0 || H % K != 0 || H / K > kMaxGroup || C <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const DecodeShape sh{B, C, H, K, H / K, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(80)
    DECODE_CASE(96)
    DECODE_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
