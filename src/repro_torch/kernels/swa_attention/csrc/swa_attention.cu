// Causal / sliding-window / prefix-LM GQA flash attention, forward and
// backward, for Hopper (sm_90a), with a plain C interface loaded through
// ctypes.
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
// What it computes.  q [B, Sq, H, hd], k and v [B, Sk, K, hd] (H = G*K, head
// h reads kv head h / G), row-major, f32 or bf16, hd in {32, 64, 80, 96,
// 128, 256}.  A query at position p attends key c when (c <= p or c < P)
// and, for W > 0, c > p - W: the JAX package's _mask_bias
// (src/repro/models/layers.py:93) in that order, where the prefix P > 0 is
// the VLM's prefix-LM mask (every query sees the image prefix, itself
// windowed) and P = 0 is causal attention, the kernels of P = 0 unchanged
// bit for bit.  P = Sk with W = 0 lets every query see every key: the
// audio encoder's bidirectional self-attention (Sq = Sk) and the decoder's
// cross-attention to the encoder's output (Sq != Sk, query and key
// positions both from 0), which the JAX package runs as _sdpa under a zero
// bias.  Sq = Sk runs the self-attention kernels' arithmetic bit for bit.
// JAX computes the prefix mask and the cross-attention in jnp, never in
// Pallas, so they are port-only variants of B4/B5, as B1m is of B1.  The
// scores are (scale*q) . k in f32; masked scores are -1e30, not -inf, so a
// fully masked tile yields no NaN, as on the TPU.  The forward writes
// o [B, S, H, hd] in the input dtype and the row logsumexp lse [B, H, S] in
// f32.  The backward recomputes p = exp(s - lse), takes
// delta = rowsum(o * do), ds = p * (do.v - delta), and writes
// dq = scale * ds.k, dk = sum over the G query heads of ds^T.(scale*q) and
// dv = sum over the G heads of p^T.do, in the input dtype.
//
// What bounds it: operations.  At the main path's shape (B=8, H=9, K=3,
// S=1024, hd=64) the causal forward is 9.7 GFLOP and the backward's two
// passes 14.5 and 19.4, against 50-90 MB of inputs and outputs a pass,
// far above the ~50 flops/byte at which 3xTF32 on the tensor cores
// (495 / 3 = 165 TFLOP/s of f32 work) overtakes HBM (3.35 TB/s).
//
// Every product of the three kernels runs in 3xTF32 on the tensor cores
// (mma.sync m16n8k8, mma_tf32.cuh): each f32 operand is split into a TF32
// big and small part and a.b = a_small.b_big + a_big.b_small + a_big.b_big,
// which holds the f32 tolerance where one TF32 product misses it 8-63x
// (tests/test_torch_swa_tf32.py).  The scale is folded into q as its
// fragments are loaded.  Blocks of 128 threads (4 warps); tiles staged as
// f32 with a row pitch of hd + 4 (hd + 8 for the forward's q and k),
// conflict-free for every fragment load.
// The scores and p (dp and ds) never leave registers: each warp computes
// its strip of s (or s^T) as mma accumulators and feeds them straight back
// as the A operand of the next product, with that product's B operand read
// in the matching k order.  The tensor cores add with truncation, so the
// long sums (o and dq over the kv tiles, dk and dv over G query heads times
// S rows) add each tile's partial product, summed from 0 on the tensor
// cores, in f32.  No atomics: every result repeats bit for bit.
//   forward: a block per (batch*head, 64-row q tile), the heaviest (last)
//   first, 3 blocks an SM at hd <= 64; warp w owns rows 16w..16w+15 and
//   walks the kv tiles (32 keys) that the mask reaches, the next k/v tile
//   in flight (cp.async, double-buffered) while the current one is
//   multiplied.
//   The online softmax runs on the C fragments of s, in log2 units (log2(e)
//   folded into the scale, exp2f): a row's keys in a tile lie in the 4
//   lanes of a quad, whose max and sum take two shuffles each, and the o
//   accumulator is rescaled by 2^(m_old - m_new) in registers.  q is split
//   as its fragments are loaded, once per kv tile, as in the dq pass; q and
//   k are staged at a pitch of hd + 8, so the fragments of s, their k slots
//   permuted, load 8 bytes a lane; s sums its small terms in a second
//   accumulator.
//   dq pass: the same blocks and kv ring; delta is read from o and do in
//   device memory while the first copies fly.
//   dk/dv pass: a block per (batch*kv head, 32-key kv tile), first kv tiles
//   (the most q tiles) first.  32-key tiles make twice the blocks of
//   64-key ones, so the blocks of unequal length (G * (S - k0) / 32 q tiles) even
//   out over the card; the block walks every (query head, 32-row q tile)
//   that sees its keys with the next q/do/lse/delta tile in flight.  Warp w
//   takes keys 16(w % 2).. against rows 16(w / 2).. of each tile and keeps
//   its dk and dv in registers across the G heads; warps w and w + 2 add
//   their sums through shared memory in a fixed order at the end.  k and v,
//   the A operands of every q tile, are split into big and small parts once
//   per block; the other operands are split as their fragments are loaded.
//   Splitting q and do once per block in the dq pass, or each q/do tile
//   once in the dk/dv pass, measured slower: the shared memory or the
//   registers it takes cost a block per SM.
// What bounds them on the card: the issue of the splits (an integer add
// and mask per part and a subtraction) and of the three mma per product,
// with 3 blocks of 4 warps per SM at hd 64 to hide their latency;
// chip_ablate_attention.py prices each and times the forward's
// alternatives (tile size, blocks an SM, q split once), PERF.md has the
// times.
//
// Masking: a masked score never enters a sum (p = 0).  The ragged sequence
// tails are masked in the kernels (q rows >= Sq and k rows >= Sk load as 0
// and are not written), so neither Sq, Sk nor hd is padded.  The prefix widens the kv tiles a q tile
// walks (B4 and dq: up to the tile of key min(P, S) - 1) and the q tiles a
// kv tile walks (dk/dv: from q tile 0 for a key tile that starts below P);
// the window's bounds still apply on the other side.
//
// Head dim 256 (paligemma-3b).  A warp that owns 16 rows of o (or dq) over
// all 256 dims holds 16 x 256 / 32 = 128 f32 accumulators a lane, and a
// warp pair's dk and dv 256: past what a lane can hold beside its
// fragments.  So at hd 256 the output's columns are split in two:
//   forward and dq pass: a block is 2 row strips x 2 column halves (32 q
//   rows, 4 warps).  Warps w and w + 2 own the same 16 rows; each computes
//   s (and dp) over the full hd, the same values in the same order, and
//   the online softmax of its rows, and keeps o (dq) for its 128 columns:
//   64 accumulators a lane.  s is computed twice, 1.5x the forward's
//   products (1.33x dq's); the sums and their order are those of hd <= 128.
//   Shared memory: forward (32 + 2*32)*264 + 2*32*260 floats = 164 KB,
//   dq (2*32 + 4*32)*260 = 195 KB (hd <= 128 tiles of 64 rows would take
//   197 and 260 KB at hd 256), one block an SM.
//   dk/dv pass: a third grid dimension of 2 column halves; each block
//   recomputes s^T and dp^T over the full hd for its 32 keys and keeps its
//   128 columns of dk and dv, 2 x 64 accumulators a lane, as at hd 128.
//   k and v are split into TF32 parts as their fragments load instead of
//   once a block: the split tiles would take (4*32 + 4*32)*260 floats =
//   260 KB with the q/do ring; without them (2*32 + 4*32)*260 + 128 =
//   196 KB.  The split values are the same either way.

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps a block, every kernel
constexpr int kFwdKeys = 32;   // forward: the kv tiles a q tile walks
constexpr int kDqKeys = 32;    // dq pass: the kv tiles a q tile walks
constexpr int kDkvKeys = 32;   // dk/dv pass: kv tile (16 keys a warp pair) ...
constexpr int kDkvRows = 32;   // ... and the q tiles it walks (16 rows a warp)
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.44269504f, kLn2 = 0.693147181f;

// The output's column parts (1, or 2 at hd 256: see the note above), and
// the q tile of the forward and the dq pass: 16 rows a warp over the
// block's 4 / parts row strips.
template <int HD> __host__ __device__ constexpr int col_parts() { return HD > 128 ? 2 : 1; }
template <int HD> __host__ __device__ constexpr int q_rows() {
  return 16 * (kThreads / 32) / col_parts<HD>();
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

struct Shape {
  int B, Sq, Sk, H, K, G;  // Sq query rows, Sk key rows (Sq == Sk: self-attention)
  int window;  // 0: full causal; else keys in (p - window, p]
  int prefix;  // 0; else keys < prefix are seen by every query (in the window)
  float scale;
  int vec;     // every f32 tensor is 16-byte aligned: tiles stage with cp.async
};

__device__ __forceinline__ bool allowed(int row, int col, const Shape& sh) {
  bool ok = (col <= row || col < sh.prefix) && row < sh.Sq && col < sh.Sk;
  if (sh.window > 0) ok = ok && col > row - sh.window;
  return ok;
}

// The last kv tile (of bk keys) that a query tile ending at row r_last sees.
__device__ __forceinline__ int last_kv_tile(int r_last, int bk, const Shape& sh) {
  int last = r_last / bk;
  if (sh.prefix > 0) last = max(last, (min(sh.prefix, sh.Sk) - 1) / bk);
  return min((sh.Sk - 1) / bk, last);
}

// Rows [row0, row0 + ROWS) of head `head` of a [B, rows, heads, HD] tensor
// (rows: Sq for q, o, do; Sk for k, v) into shared memory [ROWS][LD] as f32;
// rows past `rows` are 0.  f32 with 16-byte
// aligned tensors (sh.vec) goes through cp.async, which the caller commits
// and waits for; otherwise each element is loaded, converted and stored.
template <int ROWS, int HD, int LD = HD + 4, typename T>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, const T* __restrict__ src,
                                           int b, int row0, int rows, int heads,
                                           int head, const Shape& sh) {
  if constexpr (std::is_same<T, float>::value) {
    if (sh.vec) {
      constexpr int CH = HD / 4;  // 16-byte chunks a row
      for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
        const int r = idx / CH, c = idx - r * CH;
        const int s = row0 + r;
        const bool ok = s < rows;
        const long long off =
            ((static_cast<long long>(b) * rows + (ok ? s : 0)) * heads + head) * HD + 4 * c;
        tf32::cp_async16(dst + r * LD + 4 * c, src + off, ok);
      }
      return;
    }
  }
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += kThreads) {
    const int r = idx / HD, d = idx - r * HD;
    const int s = row0 + r;
    float val = 0.0f;
    if (s < rows) {
      val = to_f32(src[((static_cast<long long>(b) * rows + s) * heads + head) * HD + d]);
    }
    dst[r * LD + d] = val;
  }
}

// n values of a [B, H, Sq] f32 row statistic from position s0, 0 past Sq.
__device__ __forceinline__ void stage_stat(float* __restrict__ dst, const float* __restrict__ src,
                                           int s0, int n, const Shape& sh) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const bool ok = s0 + r < sh.Sq;
    tf32::cp_async4(dst + r, src + (ok ? s0 + r : 0), ok);
  }
}

// Whether some (row, col) of rows [r0, r0 + nr) x cols [c0, c0 + nc) is
// masked: a column past a row and at or past the prefix, a row past Sq or a
// column past Sk, or a column at or before a row's window.
__device__ __forceinline__ bool tile_masked(int r0, int nr, int c0, int nc, const Shape& sh) {
  const int c_last = c0 + nc - 1;
  if ((c_last > r0 && c_last >= sh.prefix) || r0 + nr > sh.Sq || c0 + nc > sh.Sk) return true;
  return sh.window > 0 && c0 <= r0 + nr - 1 - sh.window;
}

// Fragments of s = (scale q).k^T, the k slots permuted as a C fragment's
// (slot t: column 2t, slot t + 4: 2t + 1) in both operands, so a lane reads
// its two values of a row in one 8-byte load: conflict-free at a row pitch
// of 8 mod 32 floats (hd + 8).  load_a's and load_b's fragments otherwise.
__device__ __forceinline__ void load_a_pairs(const float* s, int pitch, int row0, int k0,
                                             float mult, uint32_t (&big)[4],
                                             uint32_t (&small)[4]) {
  const float* p = s + (row0 + tf32::lane_g()) * pitch + k0 + 2 * tf32::lane_t();
  const float2 lo = *reinterpret_cast<const float2*>(p);
  const float2 hi = *reinterpret_cast<const float2*>(p + 8 * pitch);
  tf32::split(mult * lo.x, big[0], small[0]);
  tf32::split(mult * hi.x, big[1], small[1]);
  tf32::split(mult * lo.y, big[2], small[2]);
  tf32::split(mult * hi.y, big[3], small[3]);
}

__device__ __forceinline__ void load_b_pairs(const float* s, int pitch, int n0, int k0,
                                             uint32_t (&big)[2], uint32_t (&small)[2]) {
  const float2 x =
      *reinterpret_cast<const float2*>(s + (n0 + tf32::lane_g()) * pitch + k0 + 2 * tf32::lane_t());
  tf32::split(x.x, big[0], small[0]);
  tf32::split(x.y, big[1], small[1]);
}

// --------------------------------------------------------------------------
// B4: forward.  grid (B*H, nq) over q tiles of q_rows<HD>() rows, i = nq -
// 1 - blockIdx.y; warp w owns rows 16(w % RW)..+15 of the tile and columns
// (w / RW) * HD / CS.. of o (RW = 4 / CS row strips; CS = 1 below hd 256)
// and walks its 32-key kv tiles.
// --------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 3 : 1)
swa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, float* __restrict__ lse, Shape sh) {
  // q and k rows at a pitch of hd + 8 (paired loads), v rows at hd + 4
  constexpr int CS = col_parts<HD>(), RW = kThreads / 32 / CS;
  constexpr int LDQ = HD + 8, LD = HD + 4, NT = HD / 8 / CS, BQ = q_rows<HD>(),
                BK = kFwdKeys, NS = BK / 8;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][LDQ]
  float* KVs = Qs + BQ * LDQ;    // 2 stages x (k [BK][LDQ], v [BK][LD])

  const int i = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / sh.H, h = blockIdx.x % sh.H, kh = h / sh.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the tile's first row, the warp's, and the warp's first column of o
  const int q0 = i * BQ, wr = 16 * (CS == 1 ? warp : warp % RW);
  const int col0 = CS == 1 ? 0 : (warp / RW) * (HD / CS);
  int j_lo = 0;  // the kv tiles that the tile's rows see
  if (sh.window > 0) j_lo = max(0, q0 - sh.window + 1) / BK;
  const int j_hi = last_kv_tile(q0 + BQ - 1, BK, sh);

  auto stage_kv = [&](int j, int stage) {
    float* Ks = KVs + stage * BK * (LDQ + LD);
    stage_rows<BK, HD, LDQ>(Ks, k, b, j * BK, sh.Sk, sh.K, kh, sh);
    stage_rows<BK, HD>(Ks + BK * LDQ, v, b, j * BK, sh.Sk, sh.K, kh, sh);
  };
  stage_rows<BQ, HD, LDQ>(Qs, q, b, q0, sh.Sq, sh.H, h, sh);
  stage_kv(j_lo, 0);
  tf32::cp_async_commit();

  // the scores in log2 units: p = 2^(s - m), lse = ln 2 * m + ln l.  Lane
  // (g, t) keeps the running max m and sum l of rows g and g + 8 of the
  // warp's strip, and o's C fragments (acc[c]: columns 8c..8c+7)
  const float qscale = sh.scale * kLog2e;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f}, acc[NT][4];
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int stage = (j - j_lo) & 1;
    if (j < j_hi) {
      stage_kv(j + 1, stage ^ 1);
      tf32::cp_async_commit();
      tf32::cp_async_wait<1>();
    } else {
      tf32::cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ks = KVs + stage * BK * (LDQ + LD);
    const float* Vs = Ks + BK * LDQ;

    // s = (scale log2(e) q) k^T on the warp's 16 rows x BK keys, in
    // 3xTF32 with the two small terms summed apart from the big one (two
    // shorter mma chains), then added in f32
    float s[NS][4], sl[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = sl[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      uint32_t qb[4], qs[4];
      load_a_pairs(Qs, LDQ, wr, kk, qscale, qb, qs);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t kb[2], ks[2];
        load_b_pairs(Ks, LDQ, 8 * n, kk, kb, ks);
        tf32::mma(sl[n], qs, kb);
        tf32::mma(sl[n], qb, ks);
        tf32::mma(s[n], qb, kb);
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += sl[n][e];

    // s[n][e] is (row g + 8(e / 2), key 8n + 2t + e % 2) of the strip; a
    // masked score becomes -1e30 and its bit of `keep` 0 (p = 0)
    uint32_t keep = 0xffffffffu;
    if (tile_masked(q0 + wr, 16, j * BK, BK, sh)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!allowed(q0 + wr + g + 8 * (e >> 1), j * BK + 8 * n + 2 * t + (e & 1), sh)) {
            keep &= ~(1u << (4 * n + e));
            s[n][e] = kNeg;
          }
    }

    // online softmax of row g (e = 0, 1) and row g + 8 (e = 2, 3): a
    // row's keys of the tile lie in the 4 lanes of a quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = (keep >> (4 * n + e)) & 1u ? exp2f(s[n][e] - m_new) : 0.0f;
          s[n][e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = exp2f(m[r] - m_new);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        acc[c][2 * r] *= corr;
        acc[c][2 * r + 1] *= corr;
      }
    }

    // o += p v, the keys as k: the tile's keys are summed on the tensor
    // cores from 0 and added to o in f32 (each mma rounds toward zero, so
    // a long chain of them into one sum drifts)
    uint32_t pb[NS][4], ps[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) tf32::a_from_c(s[n], pb[n], ps[n]);
#pragma unroll
    for (int c = 0; c < NT; c += 2) {  // hd / 8 is even
      float p0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, p1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t b0[2], s0[2], b1[2], s1[2];
        tf32::load_b_kperm(Vs, LD, 8 * n, col0 + 8 * c, 1.0f, b0, s0);
        tf32::load_b_kperm(Vs, LD, 8 * n, col0 + 8 * c + 8, 1.0f, b1, s1);
        tf32::mma3(p0, pb[n], ps[n], b0, s0);
        tf32::mma3(p1, pb[n], ps[n], b1, s1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[c][e] += p0[e];
        acc[c + 1][e] += p1[e];
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }

#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = q0 + wr + g + 8 * e2;
    if (row >= sh.Sq) continue;
    const float lr = fmaxf(l[e2], 1e-30f);
    T* out = o + ((static_cast<long long>(b) * sh.Sq + row) * sh.H + h) * HD + col0 + 2 * t;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      out[8 * c] = from_f32<T>(acc[c][2 * e2] / lr);
      out[8 * c + 1] = from_f32<T>(acc[c][2 * e2 + 1] / lr);
    }
    if (t == 0 && col0 == 0) {
      lse[(static_cast<long long>(b) * sh.H + h) * sh.Sq + row] = kLn2 * m[e2] + logf(lr);
    }
  }
}

// --------------------------------------------------------------------------
// B5, q-parallel pass: dq, and delta = rowsum(o * do) for the dk/dv pass.
// grid (B*H, nq) over q tiles of q_rows<HD>() rows, i = nq - 1 -
// blockIdx.y; warp w owns rows 16(w % RW)..+15 of the tile and columns
// (w / RW) * HD / CS.. of dq, as the forward's, and walks its 32-key kv
// tiles.
// --------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 3 : 1)
swa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ o, const T* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  T* __restrict__ dq, Shape sh) {
  constexpr int CS = col_parts<HD>(), RW = kThreads / 32 / CS;
  constexpr int LD = HD + 4, NT = HD / 8 / CS, BQ = q_rows<HD>(), BK = kDqKeys, NS = BK / 8;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][LD]
  float* dOs = Qs + BQ * LD;     // [BQ][LD]
  float* KVs = dOs + BQ * LD;    // 2 stages x (k [BK][LD], v [BK][LD])

  const int i = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / sh.H, h = blockIdx.x % sh.H, kh = h / sh.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the tile's first row, the warp's, and the warp's first column of dq
  const int q0 = i * BQ, wr = 16 * (CS == 1 ? warp : warp % RW);
  const int col0 = CS == 1 ? 0 : (warp / RW) * (HD / CS);
  const long long row_base = (static_cast<long long>(b) * sh.H + h) * sh.Sq;
  int j_lo = 0;
  if (sh.window > 0) j_lo = max(0, q0 - sh.window + 1) / BK;
  const int j_hi = last_kv_tile(q0 + BQ - 1, BK, sh);

  auto stage_kv = [&](int j, int stage) {
    float* Ks = KVs + stage * 2 * BK * LD;
    stage_rows<BK, HD>(Ks, k, b, j * BK, sh.Sk, sh.K, kh, sh);
    stage_rows<BK, HD>(Ks + BK * LD, v, b, j * BK, sh.Sk, sh.K, kh, sh);
  };
  stage_rows<BQ, HD>(Qs, q, b, q0, sh.Sq, sh.H, h, sh);
  stage_rows<BQ, HD>(dOs, dout, b, q0, sh.Sq, sh.H, h, sh);
  stage_kv(j_lo, 0);
  tf32::cp_async_commit();

  // delta of the warp's 16 rows, read from o and do in device memory while
  // the copies fly (the warps of a row strip compute the same values, the
  // first column part writes them); lane (g, t) keeps rows g and g + 8
  float dl[2] = {0.0f, 0.0f}, lr[2] = {0.0f, 0.0f};
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + wr + r;
    float part = 0.0f;
    if (row < sh.Sq) {
      const long long off = ((static_cast<long long>(b) * sh.Sq + row) * sh.H + h) * HD;
      for (int d = lane; d < HD; d += 32) part += to_f32(o[off + d]) * to_f32(dout[off + d]);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) part += __shfl_xor_sync(0xffffffffu, part, m);
    if (lane == 0 && row < sh.Sq && col0 == 0) delta[row_base + row] = part;
    if (r == g) dl[0] = part;
    if (r == g + 8) dl[1] = part;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + wr + g + 8 * e;
    if (row < sh.Sq) lr[e] = lse[row_base + row];
  }

  float acc[NT][4];
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int stage = (j - j_lo) & 1;
    if (j < j_hi) {
      stage_kv(j + 1, stage ^ 1);
      tf32::cp_async_commit();
      tf32::cp_async_wait<1>();
    } else {
      tf32::cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ks = KVs + stage * 2 * BK * LD;
    const float* Vs = Ks + BK * LD;

    // s = (scale q) k^T and dp = do v^T on the warp's 16 rows x BK keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      uint32_t qb[4], qs[4], ob[4], os[4];
      tf32::load_a(Qs, LD, wr, kk, sh.scale, qb, qs);
      tf32::load_a(dOs, LD, wr, kk, 1.0f, ob, os);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t kb[2], ks[2], vb[2], vs[2];
        tf32::load_b(Ks, LD, 8 * n, kk, 1.0f, kb, ks);
        tf32::load_b(Vs, LD, 8 * n, kk, 1.0f, vb, vs);
        tf32::mma3(s[n], qb, qs, kb, ks);
        tf32::mma3(dp[n], ob, os, vb, vs);
      }
    }

    // ds = p * (dp - delta), p = exp(s - lse) where the mask allows
    const bool masked = tile_masked(q0 + wr, 16, j * BK, BK, sh);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = expf(s[n][e] - lr[r]);
        if (masked && !allowed(q0 + wr + g + 8 * r, j * BK + 8 * n + 2 * t + (e & 1), sh))
          p = 0.0f;
        s[n][e] = p * (dp[n][e] - dl[r]);
      }

    // dq += ds k, the keys as k: the tile's keys are summed on the tensor
    // cores from 0 and added to dq in f32 (each mma rounds toward zero, so
    // a long chain of them into one sum drifts)
    uint32_t db[NS][4], dsm[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) tf32::a_from_c(s[n], db[n], dsm[n]);
#pragma unroll
    for (int c = 0; c < NT; c += 2) {  // hd / 8 is even
      float p0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, p1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t b0[2], s0[2], b1[2], s1[2];
        tf32::load_b_kperm(Ks, LD, 8 * n, col0 + 8 * c, 1.0f, b0, s0);
        tf32::load_b_kperm(Ks, LD, 8 * n, col0 + 8 * c + 8, 1.0f, b1, s1);
        tf32::mma3(p0, db[n], dsm[n], b0, s0);
        tf32::mma3(p1, db[n], dsm[n], b1, s1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[c][e] += p0[e];
        acc[c + 1][e] += p1[e];
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }

#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = q0 + wr + g + 8 * e2;
    if (row >= sh.Sq) continue;
    T* out = dq + ((static_cast<long long>(b) * sh.Sq + row) * sh.H + h) * HD + col0 + 2 * t;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      out[8 * c] = from_f32<T>(acc[c][2 * e2] * sh.scale);
      out[8 * c + 1] = from_f32<T>(acc[c][2 * e2 + 1] * sh.scale);
    }
  }
}

// --------------------------------------------------------------------------
// B5, kv-parallel pass: dk and dv, summed over the G query heads of each kv
// head in the block.  grid (B*K, nk, CS) over 32-key kv tiles, j =
// blockIdx.y, and the output's column parts (CS = 1 below hd 256), part
// blockIdx.z; the block walks every (query head, 32-row q tile) that sees
// its keys.  Warp w computes keys 16(w % 2).. against rows 16(w / 2).. of
// each q tile; warps w and w + 2 add their sums in a fixed order at the end.
// --------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 3 : 1)
swa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   Shape sh) {
  constexpr int CS = col_parts<HD>(), LD = HD + 4, NT = HD / 8 / CS, BK = kDkvKeys,
                BQ = kDkvRows;
  // k and v split into TF32 parts once a block, where shared memory holds
  // the parts (not at hd 256: see the note above)
  constexpr bool kSplitOnce = CS == 1;
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][LD] k, then its tf32 big parts
  float* Vs = Ks + BK * LD;      // [BK][LD] v, then its big parts
  float* Kl = Vs + BK * LD;      // [BK][LD] small parts of k (kSplitOnce)
  float* Vl = Kl + BK * LD;      // [BK][LD] small parts of v (kSplitOnce)
  float* QDs = kSplitOnce ? Vl + BK * LD : Kl;  // 2 stages x (q [BQ][LD], do [BQ][LD])
  float* Stat = QDs + 4 * BQ * LD;  // 2 stages x (lse [BQ], delta [BQ])

  const int j = blockIdx.y;
  const int b = blockIdx.x / sh.K, kh = blockIdx.x % sh.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wk = 16 * (warp & 1), wq = 16 * (warp >> 1);  // the warp's keys, rows
  const int col0 = CS == 1 ? 0 : blockIdx.z * (HD / CS);  // the block's first column
  const int k0 = j * BK;
  const int nq = (sh.Sq + BQ - 1) / BQ;
  const int i_lo = k0 < sh.prefix ? 0 : k0 / BQ;  // the prefix is seen from row 0
  int i_hi = nq - 1;  // the last q tile whose rows see a key of this tile
  if (sh.window > 0) i_hi = min(i_hi, (k0 + BK - 1 + sh.window - 1) / BQ);
  // none when Sq < Sk leaves the tile's keys past every causal row
  const int n_i = max(i_hi - i_lo + 1, 0), n_it = sh.G * n_i;

  auto stage_q = [&](int it, int stage) {
    const int h = kh * sh.G + it / n_i, q0 = (i_lo + it % n_i) * BQ;
    float* Qs = QDs + stage * 2 * BQ * LD;
    stage_rows<BQ, HD>(Qs, q, b, q0, sh.Sq, sh.H, h, sh);
    stage_rows<BQ, HD>(Qs + BQ * LD, dout, b, q0, sh.Sq, sh.H, h, sh);
    const long long row_base = (static_cast<long long>(b) * sh.H + h) * sh.Sq;
    stage_stat(Stat + stage * 2 * BQ, lse + row_base, q0, BQ, sh);
    stage_stat(Stat + stage * 2 * BQ + BQ, delta + row_base, q0, BQ, sh);
  };
  stage_rows<BK, HD>(Ks, k, b, k0, sh.Sk, sh.K, kh, sh);
  stage_rows<BK, HD>(Vs, v, b, k0, sh.Sk, sh.K, kh, sh);
  if (n_it > 0) stage_q(0, 0);
  tf32::cp_async_commit();
  // k and v are the A operands of every q tile: split them once
  tf32::cp_async_wait<0>();
  __syncthreads();
  if constexpr (kSplitOnce) {
    tf32::split_tile(Ks, Kl, BK * LD, 1.0f);
    tf32::split_tile(Vs, Vl, BK * LD, 1.0f);
  }

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[c][e] = dva[c][e] = 0.0f;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) {
      stage_q(it + 1, stage ^ 1);
      tf32::cp_async_commit();
      tf32::cp_async_wait<1>();
    } else {
      tf32::cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (i_lo + it % n_i) * BQ;
    const float* Qs = QDs + stage * 2 * BQ * LD;
    const float* dOs = Qs + BQ * LD;
    const float* Ls = Stat + stage * 2 * BQ;
    const float* Ds = Ls + BQ;

    // s^T = k (scale q)^T and dp^T = v do^T on the warp's 16 keys x 16 rows
    float st[2][4], dpt[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      uint32_t kb[4], ks[4], vb[4], vs[4];
      if constexpr (kSplitOnce) {
        tf32::load_a_split(Ks, Kl, LD, wk, kk, kb, ks);
        tf32::load_a_split(Vs, Vl, LD, wk, kk, vb, vs);
      } else {
        tf32::load_a(Ks, LD, wk, kk, 1.0f, kb, ks);
        tf32::load_a(Vs, LD, wk, kk, 1.0f, vb, vs);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t qb[2], qs[2], ob[2], os[2];
        tf32::load_b(Qs, LD, wq + 8 * n, kk, sh.scale, qb, qs);
        tf32::load_b(dOs, LD, wq + 8 * n, kk, 1.0f, ob, os);
        tf32::mma3(st[n], kb, ks, qb, qs);
        tf32::mma3(dpt[n], vb, vs, ob, os);
      }
    }

    // p^T = exp(s^T - lse) where the mask allows, ds^T = p^T * (dp^T - delta)
    const bool masked = tile_masked(q0 + wq, 16, k0 + wk, 16, sh);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wq + 8 * n + 2 * t + (e & 1);  // query, in the tile
        float p = expf(st[n][e] - Ls[row]);
        if (masked && !allowed(q0 + row, k0 + wk + g + 8 * (e >> 1), sh)) p = 0.0f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - Ds[row]);
      }

    // dv += p^T do, dk += ds^T (scale q), the rows as k: the warp's 16
    // rows are summed on the tensor cores from 0 and added to dk and dv in
    // f32 (each mma rounds toward zero, so a long chain of them drifts)
    uint32_t pb[2][4], ps[2][4], db[2][4], dsm[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      tf32::a_from_c(st[n], pb[n], ps[n]);
      tf32::a_from_c(dpt[n], db[n], dsm[n]);
    }
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      float pv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, pk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t ob[2], os[2], qb[2], qs[2];
        tf32::load_b_kperm(dOs, LD, wq + 8 * n, col0 + 8 * c, 1.0f, ob, os);
        tf32::load_b_kperm(Qs, LD, wq + 8 * n, col0 + 8 * c, sh.scale, qb, qs);
        tf32::mma3(pv, pb[n], ps[n], ob, os);
        tf32::mma3(pk, db[n], dsm[n], qb, qs);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dva[c][e] += pv[e];
        dka[c][e] += pk[e];
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }

  // warps 2 and 3 hand their sums to warps 0 and 1 through shared memory
  // (the q/do ring is free now), which add them and write dk and dv (the
  // block's columns, at their place in the part)
  float* dKs = QDs;              // [BK][LD]
  float* dVs = QDs + BK * LD;    // [BK][LD]
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = (wk + g + 8 * (e >> 1)) * LD + 8 * c + 2 * t + (e & 1);
      if (warp >= 2) {
        dKs[at] = dka[c][e];
        dVs[at] = dva[c][e];
      }
    }
  __syncthreads();
  if (warp >= 2) return;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int key = k0 + wk + g + 8 * e2;
    if (key >= sh.Sk) continue;
    const long long off =
        ((static_cast<long long>(b) * sh.Sk + key) * sh.K + kh) * HD + col0 + 2 * t;
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int e = 2 * e2 + e1;
        const int at = (wk + g + 8 * e2) * LD + 8 * c + 2 * t + e1;
        dk[off + 8 * c + e1] = from_f32<T>(dka[c][e] + dKs[at]);
        dv[off + 8 * c + e1] = from_f32<T>(dva[c][e] + dVs[at]);
      }
  }
}

// --------------------------------------------------------------------------
// launches
// --------------------------------------------------------------------------

Shape make_shape(int B, int Sq, int Sk, int H, int K, int window, int prefix, float scale) {
  return Shape{B, Sq, Sk, H, K, H / K, window, prefix, scale, 0};
}

// Whether every pointer is 16-byte aligned.
bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<std::uintptr_t>(p) % 16) return false;
  return true;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int HD, typename T>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, const Shape& sh,
        cudaStream_t stream) {
  constexpr int BQ = q_rows<HD>();
  const size_t smem =
      ((BQ + 2 * kFwdKeys) * (HD + 8) + 2 * kFwdKeys * (HD + 4)) * sizeof(float);
  cudaError_t e = allow_smem(swa_fwd_kernel<HD, T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(sh.B * sh.H, (sh.Sq + BQ - 1) / BQ);
  swa_fwd_kernel<HD, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sh);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, const Shape& sh, cudaStream_t stream) {
  constexpr int BQ = q_rows<HD>();
  const size_t smem = (2 * BQ + 4 * kDqKeys) * (HD + 4) * sizeof(float);
  cudaError_t e = allow_smem(swa_bwd_dq_kernel<HD, T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(sh.B * sh.H, (sh.Sq + BQ - 1) / BQ);
  swa_bwd_dq_kernel<HD, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), sh);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, void* dk, void* dv, const Shape& sh, cudaStream_t stream) {
  constexpr int CS = col_parts<HD>();
  // k and v with their split parts (below hd 256) or alone, and the q/do ring
  const int kv_tiles = CS == 1 ? 4 : 2;
  const size_t smem =
      ((kv_tiles * kDkvKeys + 4 * kDkvRows) * (HD + 4) + 4 * kDkvRows) * sizeof(float);
  cudaError_t e = allow_smem(swa_bwd_dkv_kernel<HD, T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(sh.B * sh.K, (sh.Sk + kDkvKeys - 1) / kDkvKeys, CS);
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
    SWA_CASE(FN, 256, __VA_ARGS__)                                          \
    default:                                                                \
      return static_cast<int>(cudaErrorInvalidValue);                       \
  }

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns a cudaError_t (0 = launched).
// Tensors are contiguous: q, o, do, dq [B, Sq, H, hd]; k, v, dk, dv
// [B, Sk, K, hd]; lse, delta [B, H, Sq] f32.  dtype 0 is f32, 1 is bf16.
// window 0 is causal; prefix 0 has no prefix (0 <= prefix <= Sk).

int swa_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                      int dtype, int B, int Sq, int Sk, int H, int K, int hd, int window,
                      int prefix, float scale, void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0 || H == 0) return 0;
  Shape sh = make_shape(B, Sq, Sk, H, K, window, prefix, scale);
  sh.vec = aligned16({q, k, v});
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SWA_DISPATCH(fwd, q, k, v, o, lse, sh, st)
}

int swa_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* delta, void* dq,
                         int dtype, int B, int Sq, int Sk, int H, int K, int hd,
                         int window, int prefix, float scale, void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0 || H == 0) return 0;
  Shape sh = make_shape(B, Sq, Sk, H, K, window, prefix, scale);
  sh.vec = aligned16({q, k, v, dout});
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SWA_DISPATCH(bwd_dq, q, k, v, o, dout, lse, delta, dq, sh, st)
}

int swa_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dk, void* dv,
                          int dtype, int B, int Sq, int Sk, int H, int K, int hd,
                          int window, int prefix, float scale, void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0 || K == 0) return 0;
  Shape sh = make_shape(B, Sq, Sk, H, K, window, prefix, scale);
  sh.vec = aligned16({q, k, v, dout});
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SWA_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, sh, st)
}

}  // extern "C"
