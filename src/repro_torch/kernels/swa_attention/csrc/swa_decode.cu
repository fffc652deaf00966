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
// query heads that share it: 2*C*hd*4 bytes of f32 per (b, kv head) against
// 4*G*C*hd operations, G/2 <= 8 operations a byte (G <= 16 for bf16), under
// the ~20 at which the CUDA cores (67 TFLOP/s f32) overtake HBM (3.35 TB/s).
// So the design keeps enough loads in flight on every SM, and the tensor
// cores are not needed: a product of one query row is no matrix product.
//
// Design (split-KV, "flash-decoding").
// - The grid is S splits x (B*K): split s of (b, kv head) takes the whole
//   32-slot tiles s, s + S, s + 2S, ...  S comes from the host
//   (`decode_splits` in ops.py, a function of the shapes, the SM count and
//   the blocks an SM holds): B*K*S blocks fill the SMs once, since a second,
//   partial wave ran on an idle card (chip_ablate_decode.py: 0.064 ms at
//   S = 24 against 0.083 at S = 32 for qwen2-1.5b's heads over 8192
//   slots).  Interleaved tiles spread a partly filled cache's visible tiles
//   over every split: 1.4x faster there than contiguous ranges, the same on
//   a full cache (the same script).
// - A block has NW = ceil(G / HPW) warps: one query head a warp up to G =
//   4, two above (NW <= 8), one at every G at hd 256 (NW <= 16); all of
//   them read the same k/v tiles from shared memory.  (Four heads a warp made ptxas spill; one head a warp
//   at G = 6 ran bf16 slower, chip_ablate_decode.py.)
// - Tiles go through a ring of kStages = 2 stages with 16-byte cp.async, so
//   tile t + 1 loads while tile t is computed (a third stage gained
//   nothing: fewer blocks fit an SM).  A tile's cache_pos is read
//   (into registers, two tiles ahead) before its k and v: a tile without a
//   visible slot is neither loaded nor computed, which is what makes a
//   partly filled cache (prefill by decode) cheap.
// - What bounds it on the card: the ring's loads.  With the arithmetic
//   taken out, the same ring takes 94% of the kernel's time at the long
//   cache (chip_ablate_decode.py), and torch.sum reads the same k and v
//   no faster.
// - q.k: lane t scores slot t, q (scaled by log2(e)/sqrt(hd)) read from
//   shared memory as a broadcast, k as 16-byte chunks (rows padded by 16
//   bytes, so the 8 lanes of a quarter warp hit distinct banks), with four
//   partial sums a head: no chain of hd dependent FMAs.  Then an f32 online
//   softmax in log2 units per head (the warp's max and sum by shuffles).
// - p.v: lane l keeps output dims l, l + 32, ...; each head's tile product
//   goes into at least 4 independent accumulators a lane (U over the slots
//   times the lane's dims times HPW), summed at the end of the tile and
//   added to the running o after its rescale.
// - Head dim 256 (paligemma-3b): 8 output dims a lane, and one query head
//   a warp at every G (up to 16 warps): two heads a warp held 2 x 8
//   accumulators and 2 x 8 partial products a lane, and ptxas spilled in
//   bf16.  An f32 stage is 32 x (260 + 256) x 4 B = 66 KB, so the 2-stage
//   ring takes 132 KB and one block fits an SM (the occupancy query says
//   so, and decode_splits reads it); bf16 half that.
// - S == 1: the split kernel writes o.  S > 1: each split writes its f32
//   partials (m, l and the unnormalised acc [hd]) to a workspace, and
//   swa_decode_merge_kernel merges them in split order by log-sum-exp.  A
//   split with no visible slot has m = -inf, l = 0 and weight 0 (no
//   (-inf) - (-inf)); a row whose every split is empty is NaN.  No atomics:
//   a result repeats bit for bit.  One call makes one launch (S == 1) or two.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTile = 32;          // cache slots a tile: one a lane
constexpr int kStages = 2;         // tiles in the cp.async ring
constexpr int kMaxWarps = 8;
constexpr int kOneHeadWarps = 4;   // G up to this: one query head a warp; above, two
constexpr int kMaxGroup = 16;      // query heads a kv head (G = H / K)
constexpr int kMergeThreads = 256;  // one a dim, >= the largest head dim (256)
constexpr float kLog2e = 1.4426950408889634f;

// Head dim 256: one query head a warp at every G (up to kMaxGroup warps),
// since two heads a warp spilled in bf16; below, as kOneHeadWarps says.
template <int HD> __host__ __device__ constexpr bool one_head_a_warp_always() {
  return HD > 128;
}
template <int HD> __host__ __device__ constexpr int max_warps() {
  return one_head_a_warp_always<HD>() ? kMaxGroup : kMaxWarps;
}

// ---- PTX ------------------------------------------------------------------

// 16 bytes from global to shared memory, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// One 16-byte chunk of a row in shared memory as f32: 4 floats or 8 bf16.
__device__ __forceinline__ void load_chunk(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 t = __bfloat1622float2(h);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
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
  int window;        // 0: every filled slot up to the query; else (q_pos - window, q_pos]
  float scale_log2;  // log2(e) / sqrt(hd), folded into q
  int splits;        // S
};

// Elements of T in 16 bytes, and the padded row pitch of a k tile.
template <typename T> __host__ __device__ constexpr int chunk_elems() {
  return 16 / static_cast<int>(sizeof(T));
}
template <int HD, typename T> __host__ __device__ constexpr int k_pitch() {
  return HD + chunk_elems<T>();
}

// A stage of the ring: one tile's k (rows padded) and v rows, in elements of T.
template <int HD, typename T> __host__ __device__ constexpr int stage_elems() {
  return kTile * (k_pitch<HD, T>() + HD);
}

template <int HD, typename T> __host__ __device__ constexpr size_t stage_bytes() {
  return static_cast<size_t>(stage_elems<HD, T>()) * sizeof(T);
}

// The ring, then q [G][HD] f32, then p [NW][HPW][kTile] f32.
template <int HD, typename T>
size_t smem_bytes(int G, int nw, int hpw) {
  return kStages * stage_bytes<HD, T>() + static_cast<size_t>(G) * HD * sizeof(float) +
         static_cast<size_t>(nw) * hpw * kTile * sizeof(float);
}

__device__ __forceinline__ bool visible(int p, int qp, int window) {
  return p >= 0 && p <= qp && (window <= 0 || p > qp - window);
}

// The position held by this lane's slot of tile t, -1 past the cache.
__device__ __forceinline__ int tile_pos(const int* __restrict__ cache_pos, int t, int C) {
  const int c = t * kTile + static_cast<int>(threadIdx.x % 32);
  return c < C ? cache_pos[c] : -1;
}

// Issue the cp.async copies of tile t's k and v rows into a stage.
template <int HD, typename T>
__device__ __forceinline__ void issue_tile(T* __restrict__ ks, const T* __restrict__ k,
                                           const T* __restrict__ v, int b, int kvh, int t,
                                           const DecodeShape& sh) {
  constexpr int E = chunk_elems<T>();
  constexpr int CH = HD / E;  // 16-byte chunks a row
  constexpr int KP = k_pitch<HD, T>();
  T* vs = ks + kTile * KP;
  for (int idx = threadIdx.x; idx < kTile * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx - r * CH;
    const int slot = t * kTile + r;
    const bool ok = slot < sh.C;
    const long long off =
        ((static_cast<long long>(b) * sh.C + (ok ? slot : 0)) * sh.K + kvh) * HD + c * E;
    cp_async16(ks + r * KP + c * E, k + off, ok);
    cp_async16(vs + r * HD + c * E, v + off, ok);
  }
}

// One tile for this warp's HPW heads: s = q.k for slot `lane`, the online
// softmax step, o += p.v.  `ok`: this lane's slot is visible (some lane's
// is); `ps` is the warp's p [HPW][kTile].
template <int HD, int HPW, typename T>
__device__ __forceinline__ void attend_tile(const T* __restrict__ ks, const float* __restrict__ qs,
                                            float* __restrict__ ps, const int (&gq)[HPW],
                                            bool ok, float (&m)[HPW], float (&l)[HPW],
                                            float (&acc)[HPW][(HD + 31) / 32]) {
  constexpr int E = chunk_elems<T>();
  constexpr int CH = HD / E;
  constexpr int KP = k_pitch<HD, T>();
  constexpr int NPL = (HD + 31) / 32;  // output dims a lane
  // slot accumulators a head in p.v: at least 4 independent sums a lane
  constexpr int U = HPW * NPL >= 4 ? 1 : (HPW * NPL == 1 ? 4 : 2);
  const int lane = threadIdx.x % 32;
  const float neg_inf = __int_as_float(0xff800000u);
  const T* vs = ks + kTile * KP;

  // s = q.k for slot `lane`: four partial sums a head
  float part[HPW][4];
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
#pragma unroll
    for (int j = 0; j < 4; ++j) part[h][j] = 0.0f;
  }
  const T* krow = ks + lane * KP;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    float kf[E];
    load_chunk(krow + c * E, kf);
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        float qf[4];
        load_chunk(qs + gq[h] * HD + c * E + e, qf);
#pragma unroll
        for (int j = 0; j < 4; ++j) part[h][j] = fmaf(qf[j], kf[e + j], part[h][j]);
      }
    }
  }

  // the online softmax in log2 units, one head at a time
  float corr[HPW];
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    const float s = ok ? (part[h][0] + part[h][1]) + (part[h][2] + part[h][3]) : neg_inf;
    const float m_new = fmaxf(m[h], warp_max(s));  // finite: the tile has a visible slot
    const float p = ok ? exp2f(s - m_new) : 0.0f;
    corr[h] = exp2f(m[h] - m_new);  // 0 while m was -inf
    l[h] = l[h] * corr[h] + warp_sum(p);
    m[h] = m_new;
    ps[h * kTile + lane] = p;
  }
  __syncwarp();

  // o += p.v: lane dims d = lane + 32 i, U accumulators over the slots
  float a[HPW][U][NPL];
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < NPL; ++i) a[h][u][i] = 0.0f;
    }
  }
#pragma unroll 2
  for (int t4 = 0; t4 < kTile; t4 += 4) {
    float p4[HPW][4];
#pragma unroll
    for (int h = 0; h < HPW; ++h) load_chunk(ps + h * kTile + t4, p4[h]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float vv[NPL];
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int d = lane + 32 * i;
        vv[i] = (HD % 32 == 0 || d < HD) ? to_f32(vs[(t4 + j) * HD + d]) : 0.0f;
      }
#pragma unroll
      for (int h = 0; h < HPW; ++h) {
#pragma unroll
        for (int i = 0; i < NPL; ++i) a[h][j % U][i] = fmaf(p4[h][j], vv[i], a[h][j % U][i]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      float sum = a[h][0][i];
#pragma unroll
      for (int u = 1; u < U; ++u) sum += a[h][u][i];
      acc[h][i] = fmaf(acc[h][i], corr[h], sum);
    }
  }
  __syncwarp();  // ps is rewritten by the next tile
}

template <int HD, int HPW, typename T>
__global__ void __launch_bounds__(max_warps<HD>() * 32)
swa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ cache_pos, const int* __restrict__ q_pos,
                  T* __restrict__ o, float* __restrict__ ws, DecodeShape sh) {
  constexpr int NPL = (HD + 31) / 32;
  constexpr int SE = stage_elems<HD, T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* qs = reinterpret_cast<float*>(smem_raw + kStages * stage_bytes<HD, T>());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ps = qs + sh.G * HD + warp * HPW * kTile;  // this warp's p [HPW][kTile]

  const int split = blockIdx.x;
  const int b = blockIdx.y / sh.K, kvh = blockIdx.y - b * sh.K;
  const int tiles = (sh.C + kTile - 1) / kTile;
  // this split's n tiles: t0, t0 + step, ...
  const int t0 = split, step = sh.splits;
  const int n = (tiles - split + sh.splits - 1) / sh.splits;
  const int qp = *q_pos;
  const float neg_inf = __int_as_float(0xff800000u);
  const long long q_row = static_cast<long long>(b) * sh.H + static_cast<long long>(kvh) * sh.G;
  for (int i = threadIdx.x; i < sh.G * HD; i += blockDim.x) {
    qs[i] = sh.scale_log2 * to_f32(q[q_row * HD + i]);
  }
  // this warp's heads g0 .. g0 + HPW - 1; one past G repeats head G - 1
  // (computed, never written)
  const int g0 = warp * HPW;
  int gq[HPW];
#pragma unroll
  for (int h = 0; h < HPW; ++h) gq[h] = min(g0 + h, sh.G - 1);

  float m[HPW], l[HPW], acc[HPW][NPL];
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    m[h] = neg_inf;
    l[h] = 0.0f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) acc[h][i] = 0.0f;
  }

  // Positions two tiles ahead of the compute, k/v one tile ahead; a tile
  // past this split holds positions -1.  Whether a tile has a visible slot
  // is block-uniform: every warp reads the same positions.
  int pos_cur = 0 < n ? tile_pos(cache_pos, t0, sh.C) : -1;
  int pos_nxt = 1 < n ? tile_pos(cache_pos, t0 + step, sh.C) : -1;
  bool vis_cur = __any_sync(0xffffffffu, visible(pos_cur, qp, sh.window));
  if (vis_cur) issue_tile<HD, T>(ring, k, v, b, kvh, t0, sh);
  cp_async_commit();

  for (int i = 0; i < n; ++i) {
    const bool vis_nxt = __any_sync(0xffffffffu, visible(pos_nxt, qp, sh.window));
    if (vis_nxt) {
      issue_tile<HD, T>(ring + ((i + 1) % kStages) * SE, k, v, b, kvh, t0 + (i + 1) * step, sh);
    }
    cp_async_commit();
    const int pos_nn = i + 2 < n ? tile_pos(cache_pos, t0 + (i + 2) * step, sh.C) : -1;
    if (vis_cur) {
      cp_async_wait<1>();
      __syncthreads();  // the tile (and q) is in shared memory for every warp
      attend_tile<HD, HPW, T>(ring + (i % kStages) * SE, qs, ps, gq,
                              visible(pos_cur, qp, sh.window), m, l, acc);
      __syncthreads();  // every warp is done with this stage
    }
    pos_cur = pos_nxt;
    pos_nxt = pos_nn;
    vis_cur = vis_nxt;
  }
  cp_async_wait<0>();

  const float nan = __int_as_float(0x7fc00000u);
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    if (g0 + h >= sh.G) break;  // warp-uniform
    const long long bh = q_row + g0 + h;
    if (sh.splits == 1) {
      // l >= 1 when a slot is visible; __fdividef has no slow path to call
      const float inv = l[h] > 0.0f ? __fdividef(1.0f, l[h]) : nan;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int d = lane + 32 * i;
        if (d < HD) o[bh * HD + d] = from_f32<T>(acc[h][i] * inv);
      }
    } else {
      const long long row = bh * sh.splits + split;
      float* wacc = ws + row * HD;
      float* wml = ws + static_cast<long long>(sh.B) * sh.H * sh.splits * HD + 2 * row;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int d = lane + 32 * i;
        if (d < HD) wacc[d] = acc[h][i];
      }
      if (lane == 0) {
        wml[0] = m[h];
        wml[1] = l[h];
      }
    }
  }
}

// o of (b, h) from the S splits' partials, one thread a dim, in split order:
// M = max m_s, L = sum l_s 2^(m_s - M), o = sum acc_s 2^(m_s - M) / L; a
// split with m_s = -inf has weight 0, and a row whose every split is empty
// is NaN.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
swa_decode_merge_kernel(const float* __restrict__ ws, T* __restrict__ o, int BH, int S,
                        int HD) {
  const int bh = blockIdx.x, d = threadIdx.x;
  if (d >= HD) return;
  const float* wacc = ws + static_cast<long long>(bh) * S * HD;
  const float* wml = ws + static_cast<long long>(BH) * S * HD + 2LL * bh * S;
  const float neg_inf = __int_as_float(0xff800000u);
  float M = neg_inf;
  for (int s = 0; s < S; ++s) M = fmaxf(M, wml[2 * s]);
  if (M == neg_inf) {
    o[static_cast<long long>(bh) * HD + d] = from_f32<T>(__int_as_float(0x7fc00000u));
    return;
  }
  float L = 0.0f, a = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float ms = wml[2 * s];
    if (ms == neg_inf) continue;
    const float w = exp2f(ms - M);
    L = fmaf(wml[2 * s + 1], w, L);
    a = fmaf(wacc[static_cast<long long>(s) * HD + d], w, a);
  }
  o[static_cast<long long>(bh) * HD + d] = from_f32<T>(a / L);
}

// The shared memory an instantiation may ask for (G = max_warps * HPW), set
// once an instantiation.
template <int HD, int HPW, typename T>
cudaError_t prepare() {
  constexpr int NW = max_warps<HD>();
  static const cudaError_t e = cudaFuncSetAttribute(
      swa_decode_kernel<HD, HPW, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<HD, T>(NW * HPW, NW, HPW)));
  return e;
}

template <int HD, int HPW, typename T>
int blocks_per_sm(int G) {
  const cudaError_t e = prepare<HD, HPW, T>();
  if (e != cudaSuccess) return -static_cast<int>(e);
  const int nw = (G + HPW - 1) / HPW;
  int n = 0;
  const cudaError_t r = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, swa_decode_kernel<HD, HPW, T>, 32 * nw, smem_bytes<HD, T>(G, nw, HPW));
  return r == cudaSuccess ? n : -static_cast<int>(r);
}

template <int HD, int HPW, typename T>
int decode(const void* q, const void* k, const void* v, const int* cache_pos, const int* q_pos,
           void* o, float* ws, const DecodeShape& sh, cudaStream_t stream) {
  const int nw = (sh.G + HPW - 1) / HPW;
  const cudaError_t attr = prepare<HD, HPW, T>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(sh.splits, sh.B * sh.K);
  swa_decode_kernel<HD, HPW, T><<<grid, 32 * nw, smem_bytes<HD, T>(sh.G, nw, HPW), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), cache_pos,
      q_pos, static_cast<T*>(o), ws, sh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || sh.splits == 1) return static_cast<int>(e);
  swa_decode_merge_kernel<T><<<sh.B * sh.H, kMergeThreads, 0, stream>>>(
      ws, static_cast<T*>(o), sh.B * sh.H, sh.splits, HD);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, typename T>
int decode_hd(const void* q, const void* k, const void* v, const int* cache_pos,
              const int* q_pos, void* o, float* ws, const DecodeShape& sh, cudaStream_t st) {
  if constexpr (one_head_a_warp_always<HD>()) {
    return decode<HD, 1, T>(q, k, v, cache_pos, q_pos, o, ws, sh, st);
  } else {
    if (sh.G <= kOneHeadWarps) return decode<HD, 1, T>(q, k, v, cache_pos, q_pos, o, ws, sh, st);
    return decode<HD, 2, T>(q, k, v, cache_pos, q_pos, o, ws, sh, st);
  }
}

template <int HD, typename T>
int blocks_per_sm_hd(int G) {
  if constexpr (one_head_a_warp_always<HD>()) {
    return blocks_per_sm<HD, 1, T>(G);
  } else {
    return G <= kOneHeadWarps ? blocks_per_sm<HD, 1, T>(G) : blocks_per_sm<HD, 2, T>(G);
  }
}

#define DECODE_CASE(HD)                                                              \
  case HD:                                                                           \
    return dtype == 0                                                                \
               ? decode_hd<HD, float>(q, k, v, cache_pos, q_pos, o, ws, sh, st)      \
               : decode_hd<HD, __nv_bfloat16>(q, k, v, cache_pos, q_pos, o, ws, sh, st);

#define OCCUPANCY_CASE(HD) \
  case HD:                 \
    return dtype == 0 ? blocks_per_sm_hd<HD, float>(G) : blocks_per_sm_hd<HD, __nv_bfloat16>(G);

}  // namespace

extern "C" {

// Launches on `stream` and returns a cudaError_t (0 = launched).  Tensors
// are contiguous: q and o [B, 1, H, hd], k and v [B, C, K, hd] (16-byte
// aligned); cache_pos [C] and q_pos [1] int32 on the device.  dtype 0 is
// f32, 1 is bf16; H / K <= 16.  `splits`: 1 <= S <= the 32-slot tiles of
// the cache; for S > 1, `workspace` holds B*H*S*(hd + 2) floats (the
// splits' partials).
int swa_decode(const void* q, const void* k, const void* v, const int* cache_pos,
               const int* q_pos, void* o, void* workspace, int dtype, int B, int C, int H,
               int K, int hd, int window, float scale, int splits,
               void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 0 || H % K != 0 || H / K > kMaxGroup || C <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (C + kTile - 1) / kTile;
  if (splits < 1 || splits > tiles || (splits > 1 && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<std::uintptr_t>(k) % 16 || reinterpret_cast<std::uintptr_t>(v) % 16) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (B == 0) return 0;
  if (static_cast<long long>(B) * K > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeShape sh{B, C, H, K, H / K, window, scale * kLog2e, splits};
  float* ws = static_cast<float*>(workspace);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(80)
    DECODE_CASE(96)
    DECODE_CASE(128)
    DECODE_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The split kernel's blocks resident on one SM for head dim hd and G query
// heads a kv head (the occupancy calculator; no launch), or minus a
// cudaError_t.
int swa_decode_blocks_per_sm(int dtype, int hd, int G) {
  if ((dtype != 0 && dtype != 1) || G < 1 || G > kMaxGroup) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  switch (hd) {
    OCCUPANCY_CASE(32)
    OCCUPANCY_CASE(64)
    OCCUPANCY_CASE(80)
    OCCUPANCY_CASE(96)
    OCCUPANCY_CASE(128)
    OCCUPANCY_CASE(256)
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
