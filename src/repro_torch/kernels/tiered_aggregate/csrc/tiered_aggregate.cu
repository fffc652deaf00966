// Fused client -> entity -> global parameter aggregation (HSFL Eqs. 3-4)
// for Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernels in
//   src/repro/kernels/tiered_aggregate/tiered_aggregate.py
//     B1  _kernel     (launcher tiered_aggregate_pallas)           -> tiered_aggregate_{f32,bf16}
//     B2  _q8_kernel  (launcher quantized_tiered_aggregate_pallas) -> tiered_aggregate_q8
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

}  // extern "C"
