// Fused client -> entity -> global parameter aggregation (HSFL Eqs. 3-4)
// for Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernels in
//   src/repro/kernels/tiered_aggregate/tiered_aggregate.py
//     B1  _kernel     (launcher tiered_aggregate_pallas)           -> tiered_aggregate_{f32,bf16}
//     B2  _q8_kernel  (launcher quantized_tiered_aggregate_pallas) -> tiered_aggregate_q8
//     B3  _ragged_q8_kernel (launcher ragged_quantized_tiered_aggregate_pallas)
//                                                               -> ragged_tiered_aggregate_q8
// and, with no TPU kernel of its own, B3's dense twin (the port's counterpart
// of the jnp ``tiers._ragged_units_mean``)       -> ragged_tiered_aggregate_{f32,bf16}
// and B1m, the participation-masked two-level mean (the port's counterpart of
// the jnp ``tiers._group_mean_masked``)           -> masked_tiered_aggregate_{f32,bf16,q8}
//
// What it computes, on one client-stacked shard x [N, P] (row-major):
//   y1 = do_entity ? mean over each of the J contiguous client groups : x
//   y2 = do_global ? sum_n w[n] * y1[n], broadcast to all N rows     : y1
// B2 reads the int8 wire payload q [N, Pp] instead and dequantizes each
// element against its tile's scale, scales[n, p / tile], before the same
// reduction; it writes f32.
//
// What bounds it: bytes.  Each element is read once and written once, and
// a column needs about three flops per element, far below the card's
// ~20 flops/byte balance point for f32 on the CUDA cores.  B1 moves
// 2*N*P*sizeof(T) bytes; B2 moves N*P + 4*N*P/tile + 4*N*P.
//
// Design: one thread per column p.  Neighbouring threads read neighbouring
// addresses of each row, so every load and store of a warp is one
// coalesced 128-byte (f32) transaction per row.  A thread walks the J
// groups in order, sums each group in f32 and keeps the running weighted
// global sum in one register, so it needs no register array sized by N and
// no shared memory, and no block depends on another.  With do_entity and
// without do_global it writes each group's mean as soon as the group is
// summed; with do_global it writes the global sum to all N rows at the end.
// The TPU kernel's 2048-column tile and its scalar-prefetched flags become
// the block's column range and plain kernel arguments.
//
// B3 and its twin (per-class cuts) add a 0/1 member matrix m [N, U]: column
// p belongs to unit p / E (E columns per unit; U = 1 is the TPU kernel's
// [N] member vector), and only members feed and receive either level:
//   em_g = sum_{i in g} m_i x_i / max(sum_{i in g} m_i, 1)
//   y1_i = (do_entity && m_i && sum_g > 0) ? em_g : x_i
//   sw   = sum_i w_i m_i,  gm = sum_i y1_i w_i m_i / (sw > 0 ? sw : 1)
//   y2_i = (do_global && m_i && sw > 0) ? gm : y1_i
// Same column-per-thread single pass.  The O(N) side data -- the weights,
// the member columns of the units the block's 256 columns touch, their
// per-group member counts and sw -- is staged once per block in shared
// memory, so the column loop reads only x (or q and its scales) from
// device memory.  Bytes moved are B1's (twin) and B2's (B3).
//
// B1m (partial participation) weights each client by its 0/1 mask w [N] and
// broadcasts to every row, participant or not; a group with no participant
// keeps its rows of `keep` [N, P]:
//   s_g = sum_{i in g} w_i,   t_g = sum_{i in g} w_i x_i
//   entity only: y_i = s_g > 0 ? t_g / s_g : keep_i
//   with the fed level: S = sum_g s_g, T = sum_g t_g, y_i = S > 0 ? T / S : keep_i
// (the JAX package applies the two levels one after the other; the fused
// T / S equals its sum of participant-weighted entity means to f32 rounding).
// The mask, the s_g and S are staged in shared memory once a block; the
// column loop reads x (or q and its scales) once, and keep only in the rows
// it is written to.  Over the int8 wire the payload's row pitch is Pp while
// keep and out have the unpadded width P.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// Reads element (n, p) as f32: a plain load for B1, a dequantizing load for B2.
template <typename T>
struct DenseLoad {
  const T* __restrict__ x;
  long long P;
  __device__ __forceinline__ float operator()(int n, long long p) const {
    return to_f32(x[n * P + p]);
  }
};

struct Q8Load {
  const int8_t* __restrict__ q;
  const float* __restrict__ scales;
  long long P;      // padded payload width Pp
  long long tiles;  // Pp / tile
  int tile;
  __device__ __forceinline__ float operator()(int n, long long p) const {
    return static_cast<float>(q[n * P + p]) * scales[n * tiles + p / tile];
  }
};

template <typename Load, typename Out>
__global__ void __launch_bounds__(kThreads)
tiered_aggregate_kernel(Load load, const float* __restrict__ w, Out* __restrict__ out,
                        int N, long long P, int J, int do_entity, int do_global) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= P) return;
  const int per = N / J;
  float global = 0.0f;
  for (int j = 0; j < J; ++j) {
    const int n0 = j * per;
    if (do_entity) {
      float s = 0.0f;
      for (int i = 0; i < per; ++i) s += load(n0 + i, p);
      const float mean = s / static_cast<float>(per);
      if (do_global) {
        for (int i = 0; i < per; ++i) global += w[n0 + i] * mean;
      } else {
        const Out v = from_f32<Out>(mean);
        for (int i = 0; i < per; ++i) out[(n0 + i) * P + p] = v;
      }
    } else if (do_global) {
      for (int i = 0; i < per; ++i) global += w[n0 + i] * load(n0 + i, p);
    } else {
      for (int i = 0; i < per; ++i) out[(n0 + i) * P + p] = from_f32<Out>(load(n0 + i, p));
    }
  }
  if (do_global) {
    const Out v = from_f32<Out>(global);
    for (int n = 0; n < N; ++n) out[n * P + p] = v;
  }
}

template <typename Load, typename Out>
int launch(Load load, const float* w, Out* out, int N, long long P, int J,
           int do_entity, int do_global, void* stream) {
  if (P <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (P + kThreads - 1) / kThreads;
  tiered_aggregate_kernel<Load, Out><<<static_cast<unsigned>(blocks), kThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      load, w, out, N, P, J, do_entity, do_global);
  return static_cast<int>(cudaGetLastError());
}

// Units spanned by one block: its columns [p0, p0 + kThreads) cover at most
// floor((kThreads - 1) / E) + 2 units of width E.
__host__ __device__ __forceinline__ long long units_per_block(long long U, long long E) {
  const long long nu = (kThreads - 1) / E + 2;
  return nu < U ? nu : U;
}

template <typename Load, typename Out>
__global__ void __launch_bounds__(kThreads)
ragged_tiered_aggregate_kernel(Load load, const float* __restrict__ w,
                               const float* __restrict__ member, Out* __restrict__ out,
                               int N, long long P, int J, long long U, long long E,
                               int do_entity, int do_global) {
  extern __shared__ float smem[];
  const int per = N / J;
  const long long p0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long p_last = (p0 + kThreads < P ? p0 + kThreads : P) - 1;
  const long long u0 = p0 / E < U - 1 ? p0 / E : U - 1;
  const long long u_last = p_last / E < U - 1 ? p_last / E : U - 1;
  const int nu = static_cast<int>(u_last - u0 + 1);
  float* s_w = smem;              // [N]      fed weights
  float* s_m = s_w + N;           // [nu][N]  member column of each unit
  float* s_cnt = s_m + nu * N;    // [nu][J]  members per entity group
  float* s_sw = s_cnt + nu * J;   // [nu]     sum_i w_i m_i
  for (int k = threadIdx.x; k < N; k += kThreads) s_w[k] = w[k];
  for (int k = threadIdx.x; k < nu * N; k += kThreads) {
    const int uu = k / N, n = k - uu * N;
    s_m[k] = member[n * U + u0 + uu];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nu * J; k += kThreads) {
    const int uu = k / J, j = k - uu * J;
    float c = 0.0f;
    for (int i = 0; i < per; ++i) c += s_m[uu * N + j * per + i];
    s_cnt[k] = c;
  }
  for (int uu = threadIdx.x; uu < nu; uu += kThreads) {
    float sw = 0.0f;
    for (int n = 0; n < N; ++n) sw += s_w[n] * s_m[uu * N + n];
    s_sw[uu] = sw;
  }
  __syncthreads();

  const long long p = p0 + threadIdx.x;
  if (p >= P) return;
  const int uu = static_cast<int>((p / E < U - 1 ? p / E : U - 1) - u0);
  const float* m = s_m + uu * N;
  const float* cnt = s_cnt + uu * J;
  const float sw = s_sw[uu];
  const bool receive = do_global && sw > 0.0f;  // members take gm
  float gsum = 0.0f;
  for (int j = 0; j < J; ++j) {
    const int n0 = j * per;
    const bool entity = do_entity && cnt[j] > 0.0f;
    float mean = 0.0f;
    if (entity) {
      float s = 0.0f;
      for (int i = 0; i < per; ++i) s += load(n0 + i, p) * m[n0 + i];
      mean = s / fmaxf(cnt[j], 1.0f);
    }
    for (int i = 0; i < per; ++i) {
      const int n = n0 + i;
      const bool is_member = m[n] > 0.0f;
      const float y = (entity && is_member) ? mean : load(n, p);
      if (do_global) gsum += y * (s_w[n] * m[n]);
      if (!(receive && is_member)) out[n * P + p] = from_f32<Out>(y);
    }
  }
  if (receive) {
    const Out v = from_f32<Out>(gsum / sw);
    for (int n = 0; n < N; ++n)
      if (m[n] > 0.0f) out[n * P + p] = v;
  }
}

template <typename Load, typename Out>
int launch_ragged(Load load, const float* w, const float* member, Out* out, int N,
                  long long P, int J, long long U, long long E, int do_entity,
                  int do_global, void* stream) {
  if (P <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (P + kThreads - 1) / kThreads;
  const long long nu = units_per_block(U, E);
  const size_t shmem = sizeof(float) * static_cast<size_t>(N + nu * (N + J + 1));
  ragged_tiered_aggregate_kernel<Load, Out><<<static_cast<unsigned>(blocks), kThreads,
                                              shmem, static_cast<cudaStream_t>(stream)>>>(
      load, w, member, out, N, P, J, U, E, do_entity, do_global);
  return static_cast<int>(cudaGetLastError());
}

template <typename Load, typename Out>
__global__ void __launch_bounds__(kThreads)
masked_tiered_aggregate_kernel(Load load, const float* __restrict__ mask,
                               const Out* __restrict__ keep, Out* __restrict__ out, int N,
                               long long P, int J, int do_entity, int do_global) {
  extern __shared__ float smem[];
  const int per = N / J;
  float* s_w = smem;         // [N]  participation mask
  float* s_cnt = s_w + N;    // [J]  participants per entity group
  float* s_all = s_cnt + J;  // [1]  participants in all
  for (int k = threadIdx.x; k < N; k += kThreads) s_w[k] = mask[k];
  __syncthreads();
  for (int j = threadIdx.x; j < J; j += kThreads) {
    float c = 0.0f;
    for (int i = 0; i < per; ++i) c += s_w[j * per + i];
    s_cnt[j] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float c = 0.0f;
    for (int j = 0; j < J; ++j) c += s_cnt[j];
    s_all[0] = c;
  }
  __syncthreads();

  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= P) return;
  if (do_global) {
    const float total = s_all[0];
    if (total > 0.0f) {
      float t = 0.0f;
      for (int j = 0; j < J; ++j) {
        const int n0 = j * per;
        float tg = 0.0f;
        for (int i = 0; i < per; ++i) tg += s_w[n0 + i] * load(n0 + i, p);
        t += tg;
      }
      const Out v = from_f32<Out>(t / total);
      for (int n = 0; n < N; ++n) out[n * P + p] = v;
    } else {
      for (int n = 0; n < N; ++n) out[n * P + p] = keep[n * P + p];
    }
  } else if (do_entity) {
    for (int j = 0; j < J; ++j) {
      const int n0 = j * per;
      const float c = s_cnt[j];
      if (c > 0.0f) {
        float tg = 0.0f;
        for (int i = 0; i < per; ++i) tg += s_w[n0 + i] * load(n0 + i, p);
        const Out v = from_f32<Out>(tg / c);
        for (int i = 0; i < per; ++i) out[(n0 + i) * P + p] = v;
      } else {
        for (int i = 0; i < per; ++i) out[(n0 + i) * P + p] = keep[(n0 + i) * P + p];
      }
    }
  } else {
    for (int n = 0; n < N; ++n) out[n * P + p] = from_f32<Out>(load(n, p));
  }
}

template <typename Load, typename Out>
int launch_masked(Load load, const float* mask, const Out* keep, Out* out, int N,
                  long long P, int J, int do_entity, int do_global, void* stream) {
  if (P <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (P + kThreads - 1) / kThreads;
  const size_t shmem = sizeof(float) * static_cast<size_t>(N + J + 1);
  masked_tiered_aggregate_kernel<Load, Out><<<static_cast<unsigned>(blocks), kThreads,
                                              shmem, static_cast<cudaStream_t>(stream)>>>(
      load, mask, keep, out, N, P, J, do_entity, do_global);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = launched).
int tiered_aggregate_f32(const float* x, const float* w, float* out, int N, long long P,
                         int J, int do_entity, int do_global, void* stream) {
  return launch(DenseLoad<float>{x, P}, w, out, N, P, J, do_entity, do_global, stream);
}

int tiered_aggregate_bf16(const void* x, const float* w, void* out, int N, long long P,
                          int J, int do_entity, int do_global, void* stream) {
  return launch(DenseLoad<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(x), P}, w,
                static_cast<__nv_bfloat16*>(out), N, P, J, do_entity, do_global, stream);
}

int tiered_aggregate_q8(const int8_t* q, const float* scales, const float* w, float* out,
                        int N, long long Pp, int tile, int J, int do_entity, int do_global,
                        void* stream) {
  return launch(Q8Load{q, scales, Pp, Pp / tile, tile}, w, out, N, Pp, J, do_entity,
                do_global, stream);
}

// B3's twin over a dense [N, P] shard, P = U * E; member is [N, U].
int ragged_tiered_aggregate_f32(const float* x, const float* w, const float* member,
                                float* out, int N, long long P, int J, long long U,
                                long long E, int do_entity, int do_global, void* stream) {
  return launch_ragged(DenseLoad<float>{x, P}, w, member, out, N, P, J, U, E, do_entity,
                       do_global, stream);
}

int ragged_tiered_aggregate_bf16(const void* x, const float* w, const float* member,
                                 void* out, int N, long long P, int J, long long U,
                                 long long E, int do_entity, int do_global, void* stream) {
  return launch_ragged(DenseLoad<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(x), P}, w,
                       member, static_cast<__nv_bfloat16*>(out), N, P, J, U, E, do_entity,
                       do_global, stream);
}

// B3 over the int8 wire [N, Pp]; the unpadded width is U * E <= Pp, and the
// padded tail columns take the last unit's member column.
int ragged_tiered_aggregate_q8(const int8_t* q, const float* scales, const float* w,
                               const float* member, float* out, int N, long long Pp,
                               int tile, int J, long long U, long long E, int do_entity,
                               int do_global, void* stream) {
  return launch_ragged(Q8Load{q, scales, Pp, Pp / tile, tile}, w, member, out, N, Pp, J, U,
                       E, do_entity, do_global, stream);
}

// B1m over a dense [N, P] shard; keep is [N, P] of x's type (x itself
// where the input is the clients' current state).
int masked_tiered_aggregate_f32(const float* x, const float* mask, const float* keep,
                                float* out, int N, long long P, int J, int do_entity,
                                int do_global, void* stream) {
  return launch_masked(DenseLoad<float>{x, P}, mask, keep, out, N, P, J, do_entity,
                       do_global, stream);
}

int masked_tiered_aggregate_bf16(const void* x, const float* mask, const void* keep,
                                 void* out, int N, long long P, int J, int do_entity,
                                 int do_global, void* stream) {
  return launch_masked(DenseLoad<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(x), P},
                       mask, static_cast<const __nv_bfloat16*>(keep),
                       static_cast<__nv_bfloat16*>(out), N, P, J, do_entity, do_global,
                       stream);
}

// B1m over the int8 wire [N, Pp] (row pitch Pp); keep and out are f32 [N, P],
// P <= Pp the unpadded width.
int masked_tiered_aggregate_q8(const int8_t* q, const float* scales, const float* mask,
                               const float* keep, float* out, int N, long long Pp, int tile,
                               long long P, int J, int do_entity, int do_global,
                               void* stream) {
  return launch_masked(Q8Load{q, scales, Pp, Pp / tile, tile}, mask, keep, out, N, P, J,
                       do_entity, do_global, stream);
}

}  // extern "C"
