// Causal / sliding-window GQA flash attention, forward and backward, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernels in
//   src/repro/kernels/swa_attention/swa_attention.py
//     B4  _fwd:122 (bodies _fwd_kernel:49 windowed, _full_fwd_wrapper:151)
//                                          -> swa_fwd_kernel
//     B5  _bwd:289, dq pass :312 (body _dq_kernel:198)
//                                          -> swa_bwd_dq_kernel (also delta)
//         _bwd, dk/dv pass :346 (body _dkv_kernel:240)
//                                          -> swa_bwd_dkv_kernel
//
// What it computes.  q [B, S, H, hd], k and v [B, S, K, hd] (H = G*K, head
// h reads kv head h / G), row-major, f32 or bf16.  A query at position p
// attends keys in (p - W, p], or [0, p] for W = 0 (full causal).  The
// scores are (scale*q) . k in f32; masked scores are -1e30, not -inf, so a
// fully masked tile yields no NaN, as on the TPU.  The forward writes
// o [B, S, H, hd] in the input dtype and the row logsumexp lse [B, H, S] in
// f32.  The backward recomputes p = exp(s - lse), takes
// delta = rowsum(o * do), ds = p * (do.v - delta), and writes
// dq = scale * ds.k, dk = sum over the G query heads of ds^T.(scale*q) and
// dv = sum over the G heads of p^T.do, in the input dtype.
//
// What bounds it: operations.  At the main path's shape (B=16, H=9, K=3,
// S=1024, hd=64) the causal forward is ~19 GFLOP against ~100 MB of
// inputs and outputs, ~190 flops a byte, far above the ~20 flops/byte at
// which the f32 CUDA cores (67 TFLOP/s) overtake HBM (3.35 TB/s).  The
// products run in plain f32 on the CUDA cores, not TF32 on the tensor
// cores, so the results hold to the f32 tolerance of the JAX reference.
//
// Design.  One block of 256 threads per (batch*head, 64-row q tile) in the
// forward and the dq pass, one per (batch*kv head, 64-row kv tile) in the
// dk/dv pass.  The TPU's sequential ("arbitrary") grid axes become loops
// inside the block, so no block carries anything to another: the forward
// and dq pass loop over the kv tiles that the causal mask and the window
// reach (whole tiles above the diagonal or below the window are never
// visited); the dk/dv pass loops over the G query heads of its kv head and
// the q tiles that see its keys, and sums them in registers, so it needs no
// atomics.  Tiles are staged in shared memory as f32 with an odd row pitch
// (hd + 1, 65), which keeps every access pattern below free of bank
// conflicts.  Each thread owns a 4 x n register micro-tile of every product
// (rows ty + 16i, columns tx + 16j), which gives each shared-memory load
// 4 (a column) or n (a row) multiply-adds, and keeps the online softmax
// statistics (running max and sum of its four rows) in registers; a row's
// 16 owners reduce with warp shuffles.  The forward's blocks start with the
// last q tiles, the ones with the most kv tiles to visit, and the dk/dv
// pass with the first kv tiles, for the same reason.  The ragged sequence
// tail is masked in the kernels (rows >= S load as 0 and are not written),
// so neither S nor hd is padded.  Making it fast (wgmma on the tensor
// cores in bf16, TMA loads, a pipelined ring of tiles) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTile = 64;      // rows of a q tile and of a kv tile
constexpr int kPitch = 65;     // row pitch of a [64][64] score tile in shared memory
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x n micro-tile each
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

struct Shape {
  int B, S, H, K, G;
  int window;  // 0: full causal; else keys in (p - window, p]
  float scale;
};

__device__ __forceinline__ bool allowed(int row, int col, const Shape& sh) {
  bool ok = col <= row && row < sh.S;  // col <= row < S also keeps col < S
  if (sh.window > 0) ok = ok && col > row - sh.window;
  return ok;
}

// Sum (or max) over the 16 lanes that own one row: lanes 0-15 and 16-31
// of a warp hold two different rows, and xor offsets below 16 stay inside
// each half.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Rows [row0, row0 + 64) of head `head` of a [B, S, heads, HD] tensor into
// shared memory [64][HD + 1] as f32, times `mult`; rows >= S load as 0.
// Neighbouring threads read neighbouring elements of a row.
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          int b, int row0, int heads, int head, float mult,
                                          const Shape& sh) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += kThreads) {
    const int r = idx / HD, d = idx - r * HD;
    const int s = row0 + r;
    float val = 0.0f;
    if (s < sh.S) {
      const long long off = ((static_cast<long long>(b) * sh.S + s) * heads + head) * HD + d;
      val = to_f32(src[off]) * mult;
    }
    dst[r * (HD + 1) + d] = val;
  }
}

// acc[i][j] += sum_k A(ty + 16i, k) * Bm(k, tx + 16j), with the operands in
// shared memory at A(r, k) = A[r*AR + k*AK] and Bm(k, c) = Bm[k*BK + c*BC].
// The strides make the transposes: every product of the kernels is one
// instance.
template <int NJ, int KD, int AR, int AK, int BK, int BC>
__device__ __forceinline__ void mma_tile(float (&acc)[4][NJ], const float* __restrict__ A,
                                         const float* __restrict__ Bm, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < KD; ++k) {
    float a[4], b[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * AR + k * AK];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = Bm[k * BK + (tx + 16 * j) * BC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int NI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[NI][NJ]) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
}

// First kv tile that any row of q tile `i` attends to.
__device__ __forceinline__ int first_kv_tile(int i, const Shape& sh) {
  if (sh.window <= 0) return 0;
  const int first_key = i * kTile - sh.window + 1;
  return first_key > 0 ? first_key / kTile : 0;
}

// --------------------------------------------------------------------------
// B4: forward.  grid (B*H, nq); q tile i = nq - 1 - blockIdx.y.
// --------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
swa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, float* __restrict__ lse, Shape sh) {
  constexpr int LD = HD + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;  // [64][kPitch]

  const int i = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / sh.H, h = blockIdx.x % sh.H, kh = h / sh.G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = i * kTile;

  load_tile<HD>(Qs, q, b, q0, sh.H, h, sh.scale, sh);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int r = 0; r < 4; ++r) { m[r] = kNeg; l[r] = 0.0f; }
  zero(acc);

  for (int j = first_kv_tile(i, sh); j <= i; ++j) {
    __syncthreads();  // the previous tile's reads of Ks, Vs and Ps are done
    load_tile<HD>(Ks, k, b, j * kTile, sh.K, kh, 1.0f, sh);
    load_tile<HD>(Vs, v, b, j * kTile, sh.K, kh, 1.0f, sh);
    __syncthreads();
    float s[4][4];
    zero(s);
    mma_tile<4, HD, LD, 1, 1, LD>(s, Qs, Ks, ty, tx);  // (scale q) k^T
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty + 16 * r;
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!allowed(row, j * kTile + tx + 16 * c, sh)) s[r][c] = kNeg;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = allowed(row, j * kTile + tx + 16 * c, sh) ? expf(s[r][c] - m_new) : 0.0f;
        Ps[(ty + 16 * r) * kPitch + tx + 16 * c] = p;
        sum += p;
      }
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + row_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NJ; ++c) acc[r][c] *= corr;
    }
    __syncthreads();
    mma_tile<NJ, kTile, kPitch, 1, LD, 1>(acc, Ps, Vs, ty, tx);  // += p v
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= sh.S) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    const long long off = ((static_cast<long long>(b) * sh.S + row) * sh.H + h) * HD;
#pragma unroll
    for (int c = 0; c < NJ; ++c) o[off + tx + 16 * c] = from_f32<T>(acc[r][c] / lr);
    if (tx == 0) lse[(static_cast<long long>(b) * sh.H + h) * sh.S + row] = m[r] + logf(lr);
  }
}

// --------------------------------------------------------------------------
// B5, q-parallel pass: dq, and delta = rowsum(o * do) for the dk/dv pass.
// grid (B*H, nq); q tile i = nq - 1 - blockIdx.y.
// --------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
swa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ o, const T* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  T* __restrict__ dq, Shape sh) {
  constexpr int LD = HD + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ss = Vs + kTile * LD;  // [64][kPitch]

  const int i = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / sh.H, h = blockIdx.x % sh.H, kh = h / sh.G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = i * kTile;
  const long long row_base = (static_cast<long long>(b) * sh.H + h) * sh.S;

  load_tile<HD>(Qs, q, b, q0, sh.H, h, sh.scale, sh);
  load_tile<HD>(dOs, dout, b, q0, sh.H, h, 1.0f, sh);
  load_tile<HD>(Ks, o, b, q0, sh.H, h, 1.0f, sh);  // o, staged where k goes next
  __syncthreads();
  float dl[4], lr[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    float part = 0.0f;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      const int e = (ty + 16 * r) * LD + tx + 16 * c;
      part += Ks[e] * dOs[e];
    }
    dl[r] = row_sum(part);
    lr[r] = row < sh.S ? lse[row_base + row] : 0.0f;
    if (tx == 0 && row < sh.S) delta[row_base + row] = dl[r];
  }

  float acc[4][NJ];
  zero(acc);
  for (int j = first_kv_tile(i, sh); j <= i; ++j) {
    __syncthreads();  // the previous tile's (or delta's) reads are done
    load_tile<HD>(Ks, k, b, j * kTile, sh.K, kh, 1.0f, sh);
    load_tile<HD>(Vs, v, b, j * kTile, sh.K, kh, 1.0f, sh);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mma_tile<4, HD, LD, 1, 1, LD>(s, Qs, Ks, ty, tx);    // (scale q) k^T
    mma_tile<4, HD, LD, 1, 1, LD>(dp, dOs, Vs, ty, tx);  // do v^T
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = allowed(row, j * kTile + tx + 16 * c, sh) ? expf(s[r][c] - lr[r]) : 0.0f;
        Ss[(ty + 16 * r) * kPitch + tx + 16 * c] = p * (dp[r][c] - dl[r]);
      }
    }
    __syncthreads();
    mma_tile<NJ, kTile, kPitch, 1, LD, 1>(acc, Ss, Ks, ty, tx);  // += ds k
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= sh.S) continue;
    const long long off = ((static_cast<long long>(b) * sh.S + row) * sh.H + h) * HD;
#pragma unroll
    for (int c = 0; c < NJ; ++c) dq[off + tx + 16 * c] = from_f32<T>(acc[r][c] * sh.scale);
  }
}

// --------------------------------------------------------------------------
// B5, kv-parallel pass: dk and dv, summed over the G query heads of each kv
// head in the block.  grid (B*K, nk); kv tile j = blockIdx.y.
// --------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
swa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   Shape sh) {
  constexpr int LD = HD + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;   // [64][kPitch]
  float* Ss = Ps + kTile * kPitch;
  float* lse_s = Ss + kTile * kPitch;  // [64]
  float* dl_s = lse_s + kTile;         // [64]

  const int j = blockIdx.y;
  const int nq = gridDim.y;
  const int b = blockIdx.x / sh.K, kh = blockIdx.x % sh.K;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = j * kTile;
  // the last q tile whose rows see a key of this tile
  int i_hi = nq - 1;
  if (sh.window > 0) {
    const int last_row = k0 + kTile - 1 + sh.window - 1;
    i_hi = min(i_hi, last_row / kTile);
  }

  load_tile<HD>(Ks, k, b, k0, sh.K, kh, 1.0f, sh);
  load_tile<HD>(Vs, v, b, k0, sh.K, kh, 1.0f, sh);
  float dka[4][NJ], dva[4][NJ];
  zero(dka);
  zero(dva);

  for (int g = 0; g < sh.G; ++g) {
    const int h = kh * sh.G + g;
    const long long row_base = (static_cast<long long>(b) * sh.H + h) * sh.S;
    for (int i = j; i <= i_hi; ++i) {
      const int q0 = i * kTile;
      __syncthreads();  // the previous tile's reads of Qs, dOs, Ps, Ss are done
      load_tile<HD>(Qs, q, b, q0, sh.H, h, sh.scale, sh);
      load_tile<HD>(dOs, dout, b, q0, sh.H, h, 1.0f, sh);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < sh.S ? lse[row_base + row] : 0.0f;
        dl_s[threadIdx.x] = row < sh.S ? delta[row_base + row] : 0.0f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
      mma_tile<4, HD, LD, 1, 1, LD>(s, Qs, Ks, ty, tx);    // rows: queries, cols: keys
      mma_tile<4, HD, LD, 1, 1, LD>(dp, dOs, Vs, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rr = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cc = tx + 16 * c;
          const float p = allowed(q0 + rr, k0 + cc, sh) ? expf(s[r][c] - lse_s[rr]) : 0.0f;
          Ps[rr * kPitch + cc] = p;
          Ss[rr * kPitch + cc] = p * (dp[r][c] - dl_s[rr]);
        }
      }
      __syncthreads();
      mma_tile<NJ, kTile, 1, kPitch, LD, 1>(dva, Ps, dOs, ty, tx);  // += p^T do
      mma_tile<NJ, kTile, 1, kPitch, LD, 1>(dka, Ss, Qs, ty, tx);   // += ds^T (scale q)
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty + 16 * r;
    if (key >= sh.S) continue;
    const long long off = ((static_cast<long long>(b) * sh.S + key) * sh.K + kh) * HD;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      dk[off + tx + 16 * c] = from_f32<T>(dka[r][c]);
      dv[off + tx + 16 * c] = from_f32<T>(dva[r][c]);
    }
  }
}

// --------------------------------------------------------------------------
// launches
// --------------------------------------------------------------------------

Shape make_shape(int B, int S, int H, int K, int window, float scale) {
  return Shape{B, S, H, K, H / K, window, scale};
}

int tiles(int S) { return (S + kTile - 1) / kTile; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int HD, typename T>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, const Shape& sh,
        cudaStream_t stream) {
  const size_t smem = (3 * kTile * (HD + 1) + kTile * kPitch) * sizeof(float);
  cudaError_t e = allow_smem(swa_fwd_kernel<HD, T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(sh.B * sh.H, tiles(sh.S));
  swa_fwd_kernel<HD, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sh);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, const Shape& sh, cudaStream_t stream) {
  const size_t smem = (4 * kTile * (HD + 1) + kTile * kPitch) * sizeof(float);
  cudaError_t e = allow_smem(swa_bwd_dq_kernel<HD, T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(sh.B * sh.H, tiles(sh.S));
  swa_bwd_dq_kernel<HD, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), sh);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, void* dk, void* dv, const Shape& sh, cudaStream_t stream) {
  const size_t smem =
      (4 * kTile * (HD + 1) + 2 * kTile * kPitch + 2 * kTile) * sizeof(float);
  cudaError_t e = allow_smem(swa_bwd_dkv_kernel<HD, T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(sh.B * sh.K, tiles(sh.S));
  swa_bwd_dkv_kernel<HD, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sh);
  return static_cast<int>(cudaGetLastError());
}

// Returns FN<HD, T>(args...) for the runtime head dim and dtype (0: f32,
// 1: bf16); an unsupported pair is cudaErrorInvalidValue.
#define SWA_CASE(FN, HD, ...)                                               \
  case HD:                                                                  \
    return dtype == 0 ? FN<HD, float>(__VA_ARGS__)                          \
                      : FN<HD, __nv_bfloat16>(__VA_ARGS__);
#define SWA_DISPATCH(FN, ...)                                               \
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue); \
  switch (hd) {                                                             \
    SWA_CASE(FN, 32, __VA_ARGS__)                                           \
    SWA_CASE(FN, 64, __VA_ARGS__)                                           \
    SWA_CASE(FN, 80, __VA_ARGS__)                                           \
    SWA_CASE(FN, 96, __VA_ARGS__)                                           \
    SWA_CASE(FN, 128, __VA_ARGS__)                                          \
    default:                                                                \
      return static_cast<int>(cudaErrorInvalidValue);                       \
  }

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns a cudaError_t (0 = launched).
// Tensors are contiguous: q, o, do, dq [B, S, H, hd]; k, v, dk, dv
// [B, S, K, hd]; lse, delta [B, H, S] f32.  dtype 0 is f32, 1 is bf16.

int swa_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                      int dtype, int B, int S, int H, int K, int hd, int window, float scale,
                      void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const Shape sh = make_shape(B, S, H, K, window, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SWA_DISPATCH(fwd, q, k, v, o, lse, sh, st)
}

int swa_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* delta, void* dq,
                         int dtype, int B, int S, int H, int K, int hd, int window,
                         float scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const Shape sh = make_shape(B, S, H, K, window, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SWA_DISPATCH(bwd_dq, q, k, v, o, dout, lse, delta, dq, sh, st)
}

int swa_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dk, void* dv,
                          int dtype, int B, int S, int H, int K, int hd, int window,
                          float scale, void* stream) {
  if (B == 0 || S == 0 || K == 0) return 0;
  const Shape sh = make_shape(B, S, H, K, window, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SWA_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, sh, st)
}

}  // extern "C"
