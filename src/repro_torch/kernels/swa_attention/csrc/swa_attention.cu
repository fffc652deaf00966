// Causal / sliding-window / prefix-LM GQA flash attention, forward and
// backward, for Hopper (sm_90a), with a plain C interface loaded through
// ctypes.
//
// Replaces the Pallas TPU kernels in
//   src/repro/kernels/swa_attention/swa_attention.py
//     B4  _fwd:122 (bodies _fwd_kernel:49 windowed, _full_fwd_wrapper:151)
//                         -> swa_fwd_wg_kernel (hd <= 64), swa_fwd_kernel (80-128),
//                            swa_fwd_wg_wide_kernel (256)
//     B5  _bwd:289, dq pass :312 (body _dq_kernel:198)
//                         -> swa_bwd_dq_wg_kernel (hd <= 64), swa_bwd_dq_kernel
//                            (80, 96), swa_bwd_dq_wg_half_kernel (128),
//                            swa_bwd_dq_wide_kernel (256); also delta
//         _bwd, dk/dv pass :346 (body _dkv_kernel:240)
//                         -> swa_bwd_dkv_wg_kernel, swa_bwd_dkv_kernel,
//                            swa_bwd_dkv_wg_half_kernel, swa_bwd_dkv_wide_kernel
//                            (the last two + their merge)
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
// Every product runs in 3xTF32 on the tensor cores: each f32 operand is
// split into a TF32 big and small part and a.b = a_small.b_big +
// a_big.b_small + a_big.b_big, which holds the f32 tolerance where one TF32
// product misses it 8-63x (tests/test_torch_swa_tf32.py).  B4 and B5 at
// hd <= 64, B5 at hd 128 and B4 at hd 256 run on wgmma (below, "On wgmma",
// the note before swa_bwd_dq_wg_half_kernel, and "Head dim 256"); B4 at hd
// 80-128 and B5 at 80, 96 and 256 run on mma.sync m16n8k8 (mma_tf32.cuh),
// as follows.  The scale is folded into q as its fragments
// are loaded.  Blocks of 128 threads (4 warps; 8 for the backward at hd
// 256, see below); tiles staged as f32 with a row pitch of hd + 4 (hd + 8
// for the forward's q and k), conflict-free for every fragment load.
// The scores and p (dp and ds) never leave registers: each warp computes
// its strip of s (or s^T) as mma accumulators and feeds them straight back
// as the A operand of the next product, with that product's B operand read
// in the matching k order.  The tensor cores add with truncation, so the
// long sums (o and dq over the kv tiles, dk and dv over G query heads times
// S rows) add each tile's partial product, summed from 0 on the tensor
// cores, in f32.  No atomics: every result repeats bit for bit.
//   forward (hd 80-128): a block per (batch*head, 64-row q tile), the
//   heaviest (last) first; warp w owns rows 16w..16w+15 and
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
//   dq pass (hd 80, 96): the same blocks and kv ring; delta is read from o
//   and do in device memory while the first copies fly.
//   dk/dv pass (hd 80, 96): a block per (batch*kv head, 32-key kv tile), first kv tiles
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
// What bounds the mma.sync kernels on the card: the issue of the splits (an
// integer add and mask per part and a subtraction) and of the three mma per
// product; at hd 64, where they ran until the wgmma kernels took over, they
// sat at 22-27% of their bound with 3 blocks of 4 warps an SM (PERF.md §6).
//
// On wgmma (hd 32 and 64; wgmma_tf32.cuh): B4 and both B5 passes.  Each
// product is a warpgroup's wgmma m64nNk8 .tf32, three a k-step (small.big,
// big.small, big.big) into one accumulator in registers: a quarter of
// mma.sync's instructions a product, where those kernels sat at 22-27% of
// their bound whatever the order or chains of their mma (PERF.md §6).
//   Operands.  A tf32 wgmma reads only K-major tiles (the reduction dim
//   contiguous); there is no transpose for tf32.  s = q k^T (forward, dq
//   pass) and dp = do v^T, s^T = k q^T and dp^T = v do^T (dk/dv pass)
//   reduce over hd, which every input holds contiguous: their tiles are
//   read as TMA writes them.  o += p v, dq += ds k, dv += p^T do and dk +=
//   ds^T q reduce over keys or rows: their A operand (p, ds, p^T, ds^T) is
//   the accumulator of the product before, taken from registers, and their
//   B operand is staged transposed (v^T, k^T, do^T, q^T: [hd][32]) by the
//   producer, with its 32 k positions
//   in the order in which an accumulator's columns sit in an A fragment
//   (kperm), so p, dp and ds never leave registers.  Turning these products
//   around (dv^T = do^T p) would need p in shared memory and hd as the
//   64-row M (hd 32 wastes half); the transposed B tile costs one
//   shared-memory pass over a 32-row tile.
//   TF32 parts.  The tensor cores drop an f32 word's 13 low bits, so a tile
//   serves as its own big part and only small = x - trunc(x) is stored
//   beside it (same layout, so elementwise); the scale multiplies s and
//   dq, dk after the products, not q.  Truncation instead of round to
//   nearest holds the forward's and the backward's tolerances
//   (tests/test_torch_swa_tf32.py's wgmma cases).
//   Blocks: two consumer warpgroups and a producer warpgroup (384 threads,
//   one block an SM).  The producer's first warp loads every tile into a
//   ring of stages, each with mbarriers: TMA (cp.async.bulk.tensor, 64B
//   swizzle, rows past S read as 0) for 16-byte aligned f32 tensors, else
//   the warp's plain loads converted to f32 in the same layout (bf16; f32
//   views off alignment), fenced for the async proxy.  The whole producer
//   warpgroup then derives the tile's small parts and transposes and
//   signals the consumers, who only multiply: the derivation runs beside
//   their products, and the two consumer warpgroups never wait for each
//   other.  Deriving in the consumers, between two barriers of both
//   warpgroups a tile, cost 17-25% of each pass (PERF.md §6).  In the
//   dq pass at hd 64 the producer drops to 56 registers (setmaxnreg) so
//   that the consumers rise from ptxas's 168 to 224.
//   dq pass: a block per (batch*head, 128-row q tile), the heaviest first;
//   warpgroup w owns rows 64w..; q and do stay resident, their small parts
//   held as A fragments in registers (the small.big term reads A from
//   registers, the others from shared memory).  A 2-stage ring of 32-key
//   kv tiles, each stage k, v, their small parts and k^T (48 KB at hd 64;
//   mbarriers loaded, full = derived, empty = read).  Per tile: s and dp
//   (m64n32), p and ds in registers, dq's partial product (m64n(hd)),
//   summed from 0 and added to dq in f32.  delta is computed as the
//   mma.sync pass computes it (bit for bit).
//   dk/dv pass: a block per (batch*kv head, 128-key kv tile), first kv
//   tiles first; warpgroup w owns keys 64w..; k, v and their small parts
//   stay resident (128 KB at hd 64).  Per (query head, 32-row q tile): a
//   2-stage ring of q, do, their small parts, lse and delta (read by s^T
//   and dp^T, m64n32), and one buffer of q^T and do^T (read by dv and dk,
//   m64n(hd)), which the producer derives while the consumers run the
//   tile's s^T and dp^T; p^T and ds^T in registers; dv's and then dk's
//   partial products, each added in f32.  226 KB at hd 64: two stages of
//   every derived tile would not fit.
//   forward: a block per (batch*head, 128-row q tile), the heaviest first;
//   warpgroup w owns rows 64w..; q and its small parts stay resident (each
//   warpgroup derives its rows' once; held as register A fragments beside
//   p's, as the dq pass holds q's, they made the consumers spill, and every
//   term of s reads A from shared memory instead).  A 4-stage ring of
//   32-key kv tiles, each stage k, v, k's small parts and v^T's two parts
//   (40 KB at hd 64; 225 KB in all), which the producer's three other
//   warps derive while its first warp only loads, so that a freed stage is
//   refilled at once (3 stages measured 11% slower, 2 stages 45%).  Per
//   tile: s (m64n32), then the online softmax on its accumulator in log2
//   units (the scale with log2 e folded in multiplies s), o rescaled in
//   registers, p as an A fragment straight from the accumulator, and the
//   tile's p v (m64n(hd)) summed from 0 and added to o in f32.  Tile t's s
//   is issued beside tile t - 1's p v and the softmax of t runs under the
//   latter (o's rescale and the add follow the serial order, one tile
//   late: the same values bit for bit, 3% faster than serial); the two
//   warpgroups taking turns at their products on mbarriers measured
//   0.5-6% slower.  lse = ln 2 m + ln l.  Dropping two of the three
//   products would save 27-32%.
//   A warpgroup whose 64 rows or keys see none of a tile skips its
//   products.  No split and no workspace at these head dims; no atomics:
//   results repeat bit for bit.  hd 80 and 96 do not fit (q's and do's
//   small fragments in registers, k and v resident for 128 keys) and stay
//   on mma.sync (no configuration of the repo has them); hd 128 runs the
//   "half" kernels.
// What bounds them: not the tensor cores (dropping two of the three
// products saves 21-29% in B5), but each tile's serial chain of products,
// waits and softmax in a consumer warpgroup, and in the forward the depth
// of the kv ring; PERF.md §6 prices the parts (chip_ablate_attention.py's
// "wg" and "fwd" variants).
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
// fragments.
//   forward (swa_fwd_wg_wide_kernel, on wgmma): a block per (batch*head,
//   64-row q tile), two consumer warpgroups on the same rows, each owning
//   half of hd: s's k-steps over its 128 columns (the two partial sums
//   added in f32 through shared memory, so both hold the same p) and o's
//   128 columns (64 accumulators a lane, and 32 for a piece's p v).  q and
//   its small parts take 128 KB, so the kv tiles stream through a 4-piece
//   ring along hd (a piece: 32 keys x 64 columns of k or of v^T, beside its
//   small parts: 16 KB); the note at the kernel has the rest.
//   backward ("wide" kernels, blocks of 8 warps): every score product is
//   computed once per (q tile, kv tile), its work spread over the 8 warps
//   (each takes a part of the keys and of hd, the parts added through
//   shared memory in a fixed order), and each warp owns 32 columns of the
//   output.  p, dp and ds are then staged in shared memory as TF32 big and
//   small parts, the A operands of the output's products for every warp.
//   dq pass: a block per (batch*head, 32-row q tile), the heaviest first,
//   walking 32-key kv tiles (2-stage ring); warp w computes s (w < 4) or dp
//   for keys 16((w / 2) % 2).. over dims 128(w % 2).. of all 32 rows, and
//   owns dq's columns 32w..32w+31 (32 accumulators a lane).  Shared memory
//   (2*32 + 4*32)*260 + 8*32*16 + 2*32*40 + 64 floats = 226.6 KB.
//   dk/dv pass: a block per (split, batch*kv head, 32-key kv tile) walking
//   16-row q tiles (2-stage ring); k and v are split into TF32 parts once a
//   block; warp w computes s^T (w < 4) or dp^T for all 32 keys x 16 rows
//   over dims 64(w % 4).. and owns dk's and dv's columns 32w..32w+31 (64
//   accumulators a lane).  Shared memory 4*32*260 + 4*16*260 + 64 + 8*32*16
//   + 4*32*24 floats = 228.6 KB.  The (query head, q tile) iterations of a
//   kv tile are cut into `splits` equal ranges over the grid's first
//   dimension (dkv_splits in ops.py: the count whose blocks finish first
//   under a model of the card's block schedule; at one kv head 64 kv tiles
//   leave half the SMs idle); each split writes its f32 partial dk and dv
//   to a workspace, and swa_bwd_dkv_merge_kernel adds the splits in split
//   order and writes dk and dv in the input dtype.  A split with no
//   iteration writes zeros.
// Both wide kernels take one block an SM (8 warps, two a scheduler) and
// issue about 0.2 mma.sync an SM a clock, near the 0.23-0.25 of the 4-warp
// kernels at 3 blocks an SM: what bounds them is that rate and the seven
// products of the two passes (PERF.md).

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_tf32.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps a block, every kernel
constexpr int kFwdKeys = 32;   // forward: the kv tiles a q tile walks
constexpr int kDqKeys = 32;    // dq pass: the kv tiles a q tile walks
constexpr int kDkvKeys = 32;   // dk/dv pass: kv tile (16 keys a warp pair) ...
constexpr int kDkvRows = 32;   // ... and the q tiles it walks (16 rows a warp)
// the backward at hd 256 (the "wide" kernels): 8 warps a block
constexpr int kWideThreads = 256;
constexpr int kWideDqRows = 32, kWideDqKeys = 32;    // dq: q tile, the kv tiles it walks
constexpr int kWideDkvKeys = 32, kWideDkvRows = 16;  // dk/dv: kv tile, the q tiles it walks
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.44269504f, kLn2 = 0.693147181f;

// The q tile of the mma.sync forward and dq pass: 16 rows a warp.
template <int HD> __host__ __device__ constexpr int q_rows() { return 16 * (kThreads / 32); }

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
template <int ROWS, int HD, int LD = HD + 4, int NTH = kThreads, typename T>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, const T* __restrict__ src,
                                           int b, int row0, int rows, int heads,
                                           int head, const Shape& sh) {
  if constexpr (std::is_same<T, float>::value) {
    if (sh.vec) {
      constexpr int CH = HD / 4;  // 16-byte chunks a row
      for (int idx = threadIdx.x; idx < ROWS * CH; idx += NTH) {
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
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += NTH) {
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
template <int NTH = kThreads>
__device__ __forceinline__ void stage_stat(float* __restrict__ dst, const float* __restrict__ src,
                                           int s0, int n, const Shape& sh) {
  for (int r = threadIdx.x; r < n; r += NTH) {
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

// The A fragment, k slots permuted as load_b_kperm's, of a tile of TF32
// parts staged in shared memory (rows as m, columns as k): `at` points at
// row g, column 2t of the fragment's 16 x 8 block, so lane (g, t) reads
// columns 2t and 2t + 1 of rows g and g + 8 in two 8-byte loads, conflict-free
// at a pitch of 8 or 24 mod 32 floats.
__device__ __forceinline__ void load_a_staged(const float* at, int pitch, uint32_t (&a)[4]) {
  const float2 lo = *reinterpret_cast<const float2*>(at);
  const float2 hi = *reinterpret_cast<const float2*>(at + 8 * pitch);
  a[0] = __float_as_uint(lo.x);
  a[1] = __float_as_uint(hi.x);
  a[2] = __float_as_uint(lo.y);
  a[3] = __float_as_uint(hi.y);
}

// d[m][n] += a[m] . b[n] in 3xTF32 for every m < M and n < N, one term at a
// time across the M x N sums (every a_small.b_big, then every a_big.b_small,
// then every a_big.b_big): each sum takes mma3's order, and no mma waits on
// the one just before it.
template <int M, int N>
__device__ __forceinline__ void mma3_terms(float (&d)[M][N][4], const uint32_t (&a_big)[M][4],
                                           const uint32_t (&a_small)[M][4],
                                           const uint32_t (&b_big)[N][2],
                                           const uint32_t (&b_small)[N][2]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) tf32::mma(d[m][n], a_small[m], b_big[n]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) tf32::mma(d[m][n], a_big[m], b_small[n]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) tf32::mma(d[m][n], a_big[m], b_big[n]);
}

// --------------------------------------------------------------------------
// B4: forward, hd 80-128.  grid (B*H, nq) over q tiles of q_rows<HD>()
// rows, i = nq - 1 - blockIdx.y; warp w owns rows 16w..16w+15 of the tile
// and walks its 32-key kv tiles.
// --------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 1)
swa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, float* __restrict__ lse, Shape sh) {
  static_assert(HD <= 128, "hd 256 runs swa_fwd_wg_wide_kernel");
  // q and k rows at a pitch of hd + 8 (paired loads), v rows at hd + 4
  constexpr int LDQ = HD + 8, LD = HD + 4, NT = HD / 8, BQ = q_rows<HD>(), BK = kFwdKeys,
                NS = BK / 8;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][LDQ]
  float* KVs = Qs + BQ * LDQ;    // 2 stages x (k [BK][LDQ], v [BK][LD])

  const int i = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / sh.H, h = blockIdx.x % sh.H, kh = h / sh.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = i * BQ, wr = 16 * warp;  // the tile's first row, the warp's
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
        tf32::load_b_kperm(Vs, LD, 8 * n, 8 * c, 1.0f, b0, s0);
        tf32::load_b_kperm(Vs, LD, 8 * n, 8 * c + 8, 1.0f, b1, s1);
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
    T* out = o + ((static_cast<long long>(b) * sh.Sq + row) * sh.H + h) * HD + 2 * t;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      out[8 * c] = from_f32<T>(acc[c][2 * e2] / lr);
      out[8 * c + 1] = from_f32<T>(acc[c][2 * e2 + 1] / lr);
    }
    if (t == 0) {
      lse[(static_cast<long long>(b) * sh.H + h) * sh.Sq + row] = kLn2 * m[e2] + logf(lr);
    }
  }
}

// --------------------------------------------------------------------------
// B5, q-parallel pass, hd 80 and 96: dq, and delta = rowsum(o * do) for the
// dk/dv pass.  grid (B*H, nq) over 64-row q tiles, i = nq - 1 -
// blockIdx.y; warp w owns rows 16w..16w+15 of the tile and walks its
// 32-key kv tiles.
// --------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 1)
swa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ o, const T* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  T* __restrict__ dq, Shape sh) {
  static_assert(HD < 128, "hd 128 runs swa_bwd_dq_wg_half_kernel, 256 swa_bwd_dq_wide_kernel");
  constexpr int LD = HD + 4, NT = HD / 8, BQ = q_rows<HD>(), BK = kDqKeys, NS = BK / 8;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][LD]
  float* dOs = Qs + BQ * LD;     // [BQ][LD]
  float* KVs = dOs + BQ * LD;    // 2 stages x (k [BK][LD], v [BK][LD])

  const int i = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / sh.H, h = blockIdx.x % sh.H, kh = h / sh.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = i * BQ, wr = 16 * warp;  // the tile's first row, the warp's
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
  // the copies fly; lane (g, t) keeps rows g and g + 8
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
    if (lane == 0 && row < sh.Sq) delta[row_base + row] = part;
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
        tf32::load_b_kperm(Ks, LD, 8 * n, 8 * c, 1.0f, b0, s0);
        tf32::load_b_kperm(Ks, LD, 8 * n, 8 * c + 8, 1.0f, b1, s1);
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
    T* out = dq + ((static_cast<long long>(b) * sh.Sq + row) * sh.H + h) * HD + 2 * t;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      out[8 * c] = from_f32<T>(acc[c][2 * e2] * sh.scale);
      out[8 * c + 1] = from_f32<T>(acc[c][2 * e2 + 1] * sh.scale);
    }
  }
}

// --------------------------------------------------------------------------
// B5, kv-parallel pass, hd 80 and 96: dk and dv, summed over the G query heads
// of each kv head in the block.  grid (B*K, nk) over 32-key kv tiles, j =
// blockIdx.y; the block walks every (query head, 32-row q tile) that sees
// its keys.  Warp w computes keys 16(w % 2).. against rows 16(w / 2).. of
// each q tile; warps w and w + 2 add their sums in a fixed order at the end.
// --------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 1)
swa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   Shape sh) {
  static_assert(HD < 128, "hd 128 runs swa_bwd_dkv_wg_half_kernel, 256 swa_bwd_dkv_wide_kernel");
  constexpr int LD = HD + 4, NT = HD / 8, BK = kDkvKeys, BQ = kDkvRows;
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][LD] k, then its tf32 big parts
  float* Vs = Ks + BK * LD;      // [BK][LD] v, then its big parts
  float* Kl = Vs + BK * LD;      // [BK][LD] small parts of k
  float* Vl = Kl + BK * LD;      // [BK][LD] small parts of v
  float* QDs = Vl + BK * LD;     // 2 stages x (q [BQ][LD], do [BQ][LD])
  float* Stat = QDs + 4 * BQ * LD;  // 2 stages x (lse [BQ], delta [BQ])

  const int j = blockIdx.y;
  const int b = blockIdx.x / sh.K, kh = blockIdx.x % sh.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wk = 16 * (warp & 1), wq = 16 * (warp >> 1);  // the warp's keys, rows
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
  tf32::split_tile(Ks, Kl, BK * LD, 1.0f);
  tf32::split_tile(Vs, Vl, BK * LD, 1.0f);

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
      tf32::load_a_split(Ks, Kl, LD, wk, kk, kb, ks);
      tf32::load_a_split(Vs, Vl, LD, wk, kk, vb, vs);
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
        tf32::load_b_kperm(dOs, LD, wq + 8 * n, 8 * c, 1.0f, ob, os);
        tf32::load_b_kperm(Qs, LD, wq + 8 * n, 8 * c, sh.scale, qb, qs);
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
  // (the q/do ring is free now), which add them and write dk and dv
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
    const long long off = ((static_cast<long long>(b) * sh.Sk + key) * sh.K + kh) * HD + 2 * t;
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
// B5 on wgmma, head dim <= kWgMaxHd (the note at the top): blocks of
// kWgGroups consumer warpgroups and a producer warpgroup.  The producer's
// first warp loads every tile (TMA for 16-byte aligned f32 tensors, else
// plain loads of any dtype converted to f32, in the same swizzled layout)
// into a ring of stages; the producer warpgroup derives each tile's small
// parts and transposes; the consumers multiply on wgmma and release it.
// --------------------------------------------------------------------------
constexpr int kWgMaxHd = 64;                   // the head dims these kernels take: 32, 64
constexpr int kWgGroups = 2;                   // consumer warpgroups a block
constexpr int kWgConsumers = 128 * kWgGroups;
constexpr int kWgThreads = kWgConsumers + 128;  // and a producer warpgroup, the last
constexpr int kWgRows = 64 * kWgGroups;        // dq: q rows a block; dk/dv: keys a block
constexpr int kWgTile = 32;                    // dq: keys a kv tile; dk/dv: rows a q tile
constexpr int kWgStages = 2;  // 3 in the dq pass measured slower (PERF.md §6)
constexpr int kWgSync = 1;                     // the consumers' named barrier
// Registers a thread: ptxas allots 168 to each of the 12 warps at launch
// (65536 / 384, rounded down to 8).  In the dq pass at hd 64 the producer
// warpgroup, which loads and derives, drops to kWgProducerRegs, and what it
// frees (128 x 112) lets the consumers rise to kWgConsumerRegs (256 x 56
// more; setmaxnreg only moves registers within the block): at 168 they
// spill 152 bytes.  The dk/dv pass, the forward (156) and hd 32 fit in
// 168, and the hand-over measured slower there, or no faster (PERF.md §6).
constexpr int kWgProducerRegs = 56, kWgConsumerRegs = 224;
constexpr int kWgProducerSync = 2;  // the producer warpgroup's named barrier

// Whether no (row, key) of rows [r0, r0 + nr) x keys [c0, c0 + nc) is
// visible: rows past Sq, keys past Sk, every key past every row and at or
// past the prefix, or every key at or before every row's window.
__device__ __forceinline__ bool tile_empty(int r0, int nr, int c0, int nc, const Shape& sh) {
  if (r0 >= sh.Sq || c0 >= sh.Sk) return true;
  const int r_last = min(r0 + nr, sh.Sq) - 1, c_last = min(c0 + nc, sh.Sk) - 1;
  if (c0 > r_last && c0 >= sh.prefix) return true;
  return sh.window > 0 && c_last <= r0 - sh.window;
}

// The producer warp's load of rows [row0, row0 + ROWS) and columns [col0,
// col0 + COLS) of head `head` of a [B, rows, heads, HD] tensor into a
// [COLS / 16][ROWS][16] tile (rows past `rows` are 0): by TMA (lane 0
// issues; the caller's `expect` counts the bytes), or by the warp's plain
// loads.
template <int ROWS, int HD, int COLS = HD, typename T>
__device__ __forceinline__ void produce_rows(float* dst, const CUtensorMap* map, const T* src,
                                             int b, int row0, int rows, int heads, int head,
                                             uint64_t* bar, bool tma, int col0 = 0) {
  const int lane = threadIdx.x & 31;
  if (tma) {
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < COLS / 16; ++c)
        wg::tma_load(dst + c * ROWS * 16, map, bar, head * HD + col0 + 16 * c, row0, b);
    }
    return;
  }
#pragma unroll 2  // the wide forward's loader holds 40 registers
  for (int idx = lane; idx < ROWS * COLS / 4; idx += 32) {
    const int r = idx / (COLS / 4), c = 4 * (idx % (COLS / 4));
    const int s = row0 + r;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (s < rows) {
      const T* p = src + ((static_cast<long long>(b) * rows + s) * heads + head) * HD + col0 + c;
      val = make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
    }
    *reinterpret_cast<float4*>(dst + wg::swz(r, c, ROWS)) = val;
  }
}

// The producer's stage, in order: `expect` the bytes that its TMA loads
// will count on `bar` (before they are issued), the loads, then `produced`:
// the warp's plain stores fenced for the async proxy (wgmma), the warp
// synchronised, and lane 0's arrival, the phase's one.
__device__ __forceinline__ void expect(uint64_t* bar, uint32_t bytes, bool tma) {
  if (tma && (threadIdx.x & 31) == 0) wg::bar_expect_tx(bar, bytes);
}
__device__ __forceinline__ void produced(uint64_t* bar) {
  wg::proxy_fence();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) wg::bar_arrive(bar);
}

// The small parts of the `n` floats of `src` into `dst` (the same layout),
// 4 at a time, by `nth` threads (this one `tid` of them).
__device__ __forceinline__ void small_tile(float* dst, const float* src, int n, int tid,
                                           int nth) {
  for (int i = 4 * tid; i < n; i += 4 * nth) {
    const float4 x = *reinterpret_cast<const float4*>(src + i);
    *reinterpret_cast<float4*>(dst + i) = make_float4(
        wg::small_part(x.x), wg::small_part(x.y), wg::small_part(x.z), wg::small_part(x.w));
  }
}

// The transpose of a [HD / 16][ROWS][16] tile (rows r, dims d) into
// [ROWS / 16][HD][16] tiles of its big parts (the f32 values) and small
// parts: the dims as rows, the tile's rows as k in kperm order within each
// 8; by `nth` threads (this one `tid` of them).
template <int HD, int ROWS = kWgTile>
__device__ __forceinline__ void transpose_tile(float* big, float* small, const float* src,
                                               int tid, int nth) {
  for (int u = tid; u < HD / 4 * (ROWS / 4); u += nth) {
    const int d4 = u % (HD / 4), rest = u / (HD / 4), kg = rest >> 1, h = rest & 1;
    float x[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float4 v =
          *reinterpret_cast<const float4*>(src + wg::swz(8 * kg + 2 * s + h, 4 * d4, ROWS));
      x[s][0] = v.x;
      x[s][1] = v.y;
      x[s][2] = v.z;
      x[s][3] = v.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int at = wg::swz(4 * d4 + jj, 8 * kg + 4 * h, HD);
      *reinterpret_cast<float4*>(big + at) = make_float4(x[0][jj], x[1][jj], x[2][jj], x[3][jj]);
      *reinterpret_cast<float4*>(small + at) =
          make_float4(wg::small_part(x[0][jj]), wg::small_part(x[1][jj]),
                      wg::small_part(x[2][jj]), wg::small_part(x[3][jj]));
    }
  }
}

// One warp's transpose_tile of a [HD / 16][ROWS][16] tile at `src` into the
// big parts at `big` only: lane (d4 & 7, key group, even or odd keys), so
// that its loads take the 4 wavefronts of 512 bytes and its stores 8.
template <int HD, int ROWS>
__device__ __forceinline__ void transpose_warp(float* big, const float* src, int lane) {
  constexpr int KGH = ROWS / 4;  // (8-key group, even / odd keys) pairs
#pragma unroll 1  // one unit's 16 values live at a time (the producer's 40 registers)
  for (int u = lane; u < HD / 4 * KGH; u += 32) {
    const int kgh = (u >> 3) % KGH, d4 = (u & 7) + 8 * (u / (8 * KGH));
    const int kg = kgh >> 1, h = kgh & 1;
    float x[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float4 v =
          *reinterpret_cast<const float4*>(src + wg::swz(8 * kg + 2 * s + h, 4 * d4, ROWS));
      x[s][0] = v.x;
      x[s][1] = v.y;
      x[s][2] = v.z;
      x[s][3] = v.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<float4*>(big + wg::swz(4 * d4 + jj, 8 * kg + 4 * h, HD)) =
          make_float4(x[0][jj], x[1][jj], x[2][jj], x[3][jj]);
  }
}

// The float offset of k-step kk (8 floats) of a [width / 16][rows][16] tile.
__device__ __forceinline__ int kstep(int kk, int rows) {
  return (kk >> 1) * rows * 16 + (kk & 1) * 8;
}

// The A fragment (k slots in kperm order) of columns 8n.. of an
// accumulator: big = its f32 bits, and their small parts, made here so that
// they take registers only while their product runs.
template <int N>
__device__ __forceinline__ void a_of(const float (&d)[N], int n, uint32_t (&big)[4],
                                     uint32_t (&small)[4]) {
  constexpr int e[4] = {0, 2, 1, 3};
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    big[x] = __float_as_uint(d[4 * n + e[x]]);
    small[x] = __float_as_uint(wg::small_part(d[4 * n + e[x]]));
  }
}

template <int N>
__device__ __forceinline__ void reg_fence_all(float (&d)[N]) {
#pragma unroll
  for (int x = 0; x < N; ++x) wg::reg_fence(d[x]);
}
template <int N>
__device__ __forceinline__ void reg_fence_all(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) wg::reg_fence(a[n][x]);
}

// Dynamic shared memory of the two kernels (the tiles, the barriers, and 1
// KB to align the tiles: the swizzle's pattern follows the address).
template <int HD> constexpr size_t dq_wg_smem() {
  return (2 * kWgRows * HD + kWgStages * 6 * kWgTile * HD) * sizeof(float) +
         (3 * kWgStages + 1) * sizeof(uint64_t) + 1024;
}
template <int HD> constexpr size_t dkv_wg_smem() {
  return (4 * kWgRows * HD + kWgStages * (4 * kWgTile * HD + 2 * kWgTile) +
          4 * kWgTile * HD) * sizeof(float) +
         (3 * kWgStages + 3) * sizeof(uint64_t) + 1024;
}

__device__ __forceinline__ float* aligned_smem(float* smem) {
  const uint32_t pad = (1024u - (wg::smem_addr(smem) & 1023u)) & 1023u;
  return smem + pad / 4;
}

// --------------------------------------------------------------------------
// B4 on wgmma: the forward at head dim <= kWgMaxHd.  grid (B*H, nq) over
// kWgRows-row q tiles, i = nq - 1 - blockIdx.y; warpgroup w owns rows
// 64w..64w+63 of the tile, and the block walks its kWgFwdKeys-key kv tiles.
// q and its small parts stay resident (each consumer warpgroup derives its
// own rows' once).  The producer's first warp only loads (q once, then the
// kv ring, each stage as soon as the consumers release it); its other three
// warps derive each stage's k small parts and v^T (big and small parts,
// keys in kperm order), so neither waits for the other.  A stage is k, v,
// k's small parts, v^T's big and small parts, with the loaded / full /
// empty mbarriers.  Each consumer warpgroup overlaps a tile's softmax with
// its products: s of tile t is issued with p.v of tile t - 1 (two commit
// groups), the softmax of t runs once s has landed, while p.v still runs.
// --------------------------------------------------------------------------
constexpr int kWgFwdKeys = 32;    // keys a kv tile (64: p's fragments spill)
constexpr int kWgFwdStages = 4;   // the kv ring (3 measured 11% slower; 5 do not fit)
constexpr int kWgFwdGroupSync = 3;  // and 4: each consumer warpgroup's named barrier

template <int HD> constexpr size_t fwd_wg_smem() {
  return (2 * kWgRows * HD + kWgFwdStages * 5 * kWgFwdKeys * HD) * sizeof(float) +
         (3 * kWgFwdStages + 1) * sizeof(uint64_t) + 1024;
}

// The online softmax of one kv tile on a warp's strip, in log2 units: sc
// (the accumulator of q k^T, sc[4n + e] at row g + 8 (e / 2), key 8n + 2 t4
// + e % 2) becomes p = 2^(qscale sc - m); m and l (rows g and g + 8) are
// updated, and corr is what o is to be multiplied by.  A masked score is
// -1e30 and its p 0.
template <int BK>
__device__ __forceinline__ void fwd_softmax(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                            float (&corr)[2], float qscale, bool masked,
                                            int row0, int col0, const Shape& sh) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  uint32_t keep = 0xffffffffu;
#pragma unroll
  for (int x = 0; x < BK / 2; ++x) sc[x] *= qscale;
  if (masked) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!allowed(row0 + g + 8 * (e >> 1), col0 + 8 * n + 2 * t4 + (e & 1), sh)) {
          keep &= ~(1u << (4 * n + e));
          sc[4 * n + e] = kNeg;
        }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNeg;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float p = (keep >> (4 * n + e)) & 1u ? exp2f(sc[4 * n + e] - m_new) : 0.0f;
        sc[4 * n + e] = p;
        sum += p;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    corr[r] = exp2f(m[r] - m_new);
    l[r] = l[r] * corr[r] + sum;
    m[r] = m_new;
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
swa_fwd_wg_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const T* __restrict__ q,
                  const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, Shape sh) {
  static_assert(HD <= kWgMaxHd && HD % 16 == 0, "hd 32 or 64");
  constexpr int NS = kWgFwdStages, BK = kWgFwdKeys, KS = HD / 8, TILE = BK * HD;
  extern __shared__ float smem_raw[];
  float* Qs = aligned_smem(smem_raw);  // [HD / 16][kWgRows][16]: q, then its small parts
  float* Qsm = Qs + kWgRows * HD;
  // NS stages x (k, v [HD / 16][BK][16], k's small parts, v^T [BK / 16][HD][16]
  // with the keys in kperm order: big, then small parts)
  float* Ring = Qsm + kWgRows * HD;
  uint64_t* loaded = reinterpret_cast<uint64_t*>(Ring + NS * 5 * TILE);
  uint64_t* full = loaded + NS;
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  const int i = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / sh.H, h = blockIdx.x % sh.H, kh = h / sh.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = i * kWgRows;
  int j_lo = 0;
  if (sh.window > 0) j_lo = max(0, q0 - sh.window + 1) / BK;
  const int n_t = last_kv_tile(q0 + kWgRows - 1, BK, sh) - j_lo + 1;  // may be <= 0
  const bool tma = std::is_same<T, float>::value && sh.vec;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      wg::bar_init(&loaded[s], 1);
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], kWgConsumers / 32);
    }
    wg::bar_init(qbar, 1);
    wg::bar_init_fence();
  }
  __syncthreads();

  if (warp >= kWgConsumers / 32) {
    constexpr int kDerivers = 96;  // the producer's warps but its first
    const int pt = threadIdx.x - kWgConsumers - 32;
    if (pt < 0) {
      // the loader: q, then each kv tile once the consumers free its stage
      expect(qbar, kWgRows * HD * sizeof(float), tma);
      produce_rows<kWgRows, HD>(Qs, &tq, q, b, q0, sh.Sq, sh.H, h, qbar, tma);
      produced(qbar);
      for (int t = 0; t < n_t; ++t) {
        const int s = t % NS;
        if (t >= NS) wg::bar_wait(&empty[s], ((t / NS) & 1) ^ 1);
        float* Ks = Ring + s * 5 * TILE;
        const int k0 = (j_lo + t) * BK;
        expect(&loaded[s], 2 * TILE * sizeof(float), tma);
        produce_rows<BK, HD>(Ks, &tk, k, b, k0, sh.Sk, sh.K, kh, &loaded[s], tma);
        produce_rows<BK, HD>(Ks + TILE, &tv, v, b, k0, sh.Sk, sh.K, kh, &loaded[s], tma);
        produced(&loaded[s]);
      }
      return;
    }
    // the derivers: k's small parts and v^T of each loaded tile
    for (int t = 0; t < n_t; ++t) {
      const int s = t % NS;
      float* Ks = Ring + s * 5 * TILE;
      wg::bar_wait(&loaded[s], (t / NS) & 1);
      small_tile(Ks + 2 * TILE, Ks, TILE, pt, kDerivers);
      transpose_tile<HD, BK>(Ks + 3 * TILE, Ks + 4 * TILE, Ks + TILE, pt, kDerivers);
      wg::proxy_fence();
      wg::named_sync(kWgProducerSync, kDerivers);
      if (pt == 0) wg::bar_arrive(&full[s]);
    }
    return;
  }

  // the consumers: warpgroup wgi, its warp w, lane (g, t4)
  const int wgi = warp >> 2, w = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int r0 = 64 * wgi, wr = r0 + 16 * w;  // the warpgroup's first row, the warp's

  // the small parts of the warpgroup's 64 rows of q, beside q: every term of
  // s reads its A operand from shared memory (held as register fragments,
  // as the dq pass holds them, they and p's fragments of the tile before
  // made the consumers spill)
  wg::bar_wait(qbar, 0);
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
    const int at = c * kWgRows * 16 + r0 * 16;
    small_tile(Qsm + at, Qs + at, 64 * 16, threadIdx.x & 127, 128);
  }
  wg::proxy_fence();
  wg::named_sync(kWgFwdGroupSync + wgi, 128);

  // the scores in log2 units (log2(e) in the scale, which multiplies s after
  // the product): p = 2^(s - m), lse = ln 2 * m + ln l; lane (g, t4) keeps m
  // and l of rows g and g + 8 of the warp's strip, and o's accumulator
  const float qscale = sh.scale * kLog2e;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f}, corr[2], acc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) acc[x] = 0.0f;
  float sc[BK / 2], part[HD / 2];
  uint32_t pb[BK / 8][4], ps[BK / 8][4];  // p of the tile before, A fragments

  auto stage = [&](int t) -> const float* { return Ring + (t % NS) * 5 * TILE; };
  auto live = [&](int t) { return !tile_empty(q0 + r0, 64, (j_lo + t) * BK, BK, sh); };
  auto release = [&](int t) {  // the warp has read tile t's stage
    __syncwarp();
    if (lane == 0) wg::bar_arrive(&empty[t % NS]);
  };
  auto skip = [&](int t) {  // a tile that none of the warpgroup's rows sees
    wg::bar_wait(&full[t % NS], (t / NS) & 1);
    release(t);
  };
  // The descriptors of a product's k-steps are its tiles' first (the low
  // word, opaque to the compiler, so it is not hoisted out of the kv loop
  // once a k-step) plus a constant.
  const uint32_t q_lo = wg::desc_lo(Qs + r0 * 16);
  auto at = [](uint32_t lo, int floats) { return wg::desc_of(lo + floats / 4); };
  // s = q k^T on the warpgroup's 64 rows x BK keys, 3xTF32 a k-step
  auto issue_s = [&](const float* Ks) {
    uint32_t q = q_lo, k_lo = wg::desc_lo(Ks);
    wg::reg_fence(q);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t qb = at(q, kstep(kk, kWgRows)), qs = at(q, kWgRows * HD + kstep(kk, kWgRows));
      const uint64_t kb = at(k_lo, kstep(kk, BK)), ks = at(k_lo, 2 * TILE + kstep(kk, BK));
      wg::mma_ss<BK>(sc, qs, kb, kk > 0);
      wg::mma_ss<BK>(sc, qb, ks, 1);
      wg::mma_ss<BK>(sc, qb, kb, 1);
    }
    wg::commit();
  };
  // the tile's p v, the keys as k, summed from 0 (added to o in f32 after)
  auto issue_pv = [&](const float* Ks) {
    const uint32_t v_lo = wg::desc_lo(Ks + 3 * TILE);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const uint64_t tb = at(v_lo, kstep(n, HD)), ts = at(v_lo, TILE + kstep(n, HD));
      wg::mma_rs<HD>(part, ps[n], tb, n > 0);
      wg::mma_rs<HD>(part, pb[n], ts, 1);
      wg::mma_rs<HD>(part, pb[n], tb, 1);
    }
    wg::commit();
  };
  auto softmax = [&](int t) {
    const int c0 = (j_lo + t) * BK;
    fwd_softmax<BK>(sc, m, l, corr, qscale, tile_masked(q0 + wr, 16, c0, BK, sh), q0 + wr, c0,
                    sh);
  };
  auto p_fragments = [&]() {  // p as the A operand of the tile's p v
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) a_of(sc, n, pb[n], ps[n]);
  };

  int t = 0;
  for (; t < n_t && !live(t); ++t) skip(t);
  if (t < n_t) {
    // the first tile the warpgroup's rows see: o is 0, nothing to rescale
    wg::bar_wait(&full[t % NS], (t / NS) & 1);
    wg::fence();
    issue_s(stage(t));
    wg::wait<0>();
    reg_fence_all(sc);
    softmax(t);
    p_fragments();
    int prev = t;
    for (++t; t < n_t && live(t); ++t) {
      // s of tile t beside p v of tile prev; the softmax of t under the latter
      wg::bar_wait(&full[t % NS], (t / NS) & 1);
      wg::fence();
      issue_s(stage(t));
      issue_pv(stage(prev));
      wg::wait<1>();
      reg_fence_all(sc);
      softmax(t);
      wg::wait<0>();
      reg_fence_all(part);
      reg_fence_all(pb);
      reg_fence_all(ps);
      release(prev);
      // o = (o + p v of tile prev) * 2^(m_prev - m_t): the serial order
      // (rescale, then add the tile's product) one tile later
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) acc[x] = (acc[x] + part[x]) * corr[(x >> 1) & 1];
      p_fragments();
      prev = t;
    }
    wg::fence();
    issue_pv(stage(prev));
    wg::wait<0>();
    reg_fence_all(part);
    reg_fence_all(pb);
    reg_fence_all(ps);
    release(prev);
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) acc[x] += part[x];
  }
  for (; t < n_t; ++t) skip(t);

#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = q0 + wr + g + 8 * e2;
    if (row >= sh.Sq) continue;
    const float lr = fmaxf(l[e2], 1e-30f);
    T* out = o + ((static_cast<long long>(b) * sh.Sq + row) * sh.H + h) * HD + 2 * t4;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      out[8 * c] = from_f32<T>(acc[4 * c + 2 * e2] / lr);
      out[8 * c + 1] = from_f32<T>(acc[4 * c + 2 * e2 + 1] / lr);
    }
    if (t4 == 0) lse[(static_cast<long long>(b) * sh.H + h) * sh.Sq + row] = kLn2 * m[e2] + logf(lr);
  }
}

// --------------------------------------------------------------------------
// B4 on wgmma at head dim 256: swa_fwd_wg_wide_kernel.  grid (B*H, nq) over
// kWideFwdRows-row q tiles, i = nq - 1 - blockIdx.y, the heaviest first.
// Both consumer warpgroups own the tile's 64 rows (warp w rows 16w..), and
// warpgroup w owns hd's columns HALF w.. (HALF = hd / 2): the k-steps of s
// over them and o's columns there.  q and its small parts stay resident
// (128 KB: each warpgroup derives its own columns' once), so a kv tile (k,
// its small parts, v^T's two parts: 128 KB at 32 keys) streams through a
// ring of pieces along hd: a piece is the tile's keys x kWideFwdPiece
// columns of k, or of v^T, beside its small parts (16 KB at 32 keys x 64
// columns); a tile is 2 KP k pieces, then 2 KP v pieces, the two
// warpgroups' alternating.  The loader warp only loads (v into a piece's
// second part); each of the producer's three other warps derives whole
// pieces (the slots s = its index mod 3): k's small parts, or v^T (keys in
// kperm order) into the first part and then its small parts.  Per tile a
// warpgroup issues s over its columns (m64nBKk8, 3xTF32 a k-step, a commit
// group a piece), writes the partial sum into its last k piece and, once
// both have, adds the other's: s0 + s1 in f32 (commutative, so both
// warpgroups hold the same s bit for bit), releasing the other's piece.
// Then the online softmax (log2 units, the scale after the product), p as
// register A fragments, o rescaled, and for each v piece its columns' p v
// (m64n64k8) summed from 0 and added to o in f32.  Every piece is released
// as soon as its products have landed.  Every score is computed once.  The
// knobs below are chip_ablate_attention.py's "wide" variants.
// --------------------------------------------------------------------------
constexpr int kWideFwdRows = 64;     // q rows a block: one wgmma M, both warpgroups'
constexpr int kWideFwdKeys = 32;     // keys a kv tile
constexpr int kWideFwdPiece = 64;    // columns a piece of k or v
constexpr int kWideFwdStages = 4;    // pieces in the ring (6 no faster: PERF.md §6)
constexpr bool kWideFwdQsmRegs = false;  // q's small parts as register A fragments
constexpr int kWideFwdXSync = 5;     // the consumers' named barrier of the s exchange
// Registers a thread (setmaxnreg moves them within the 168 x 384 that the
// block holds from its launch): the consumers hold o, one v piece's p v
// (64 + 32), p's fragments and s; the producer keeps the rest, 56 (232 and
// 40 measured 4% slower).
constexpr int kWideFwdConsumerRegs = 224;
constexpr int kWideFwdProducerRegs =
    ((65536 / kWgThreads / 8 * 8) * kWgThreads - kWgConsumers * kWideFwdConsumerRegs) / 128 / 8 * 8;
static_assert(kWideFwdProducerRegs >= 24, "setmaxnreg's least");

template <int HD> constexpr size_t fwd_wide_smem() {
  return ((kWideFwdQsmRegs ? 1 : 2) * kWideFwdRows * HD +
          kWideFwdStages * 2 * kWideFwdKeys * kWideFwdPiece) * sizeof(float) +
         (3 * kWideFwdStages + 1) * sizeof(uint64_t) + 1024;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
swa_fwd_wg_wide_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const T* __restrict__ q,
                       const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, Shape sh) {
  constexpr int BQ = kWideFwdRows, BK = kWideFwdKeys, PW = kWideFwdPiece, NS = kWideFwdStages;
  constexpr int HALF = HD / 2;          // a consumer warpgroup's columns
  constexpr int KP = HALF / PW;         // k pieces (and v pieces) of a warpgroup a tile
  constexpr int PIECES = 4 * KP;        // pieces a tile
  constexpr int PART = BK * PW;         // floats of one part of a piece
  constexpr bool QR = kWideFwdQsmRegs;
  static_assert(HD == 256 && HALF % PW == 0 && PW % 16 == 0, "hd 256, whole pieces");
  static_assert(NS >= 2 * KP, "a tile's k pieces (and its v pieces) fit in the ring at once");
  // A slot's pieces alternate neither between the warpgroups nor between
  // the deriver warps, so that no one waits on a barrier's phase while the
  // phase before it is still open (its parity would read as complete).
  static_assert(NS % 2 == 0, "an even ring: a slot's pieces are one warpgroup's");
  static_assert(BQ * BK <= 2 * PART, "a partial s fits in its k piece");
  extern __shared__ float smem_raw[];
  float* Qs = aligned_smem(smem_raw);  // [HD / 16][BQ][16]: q, then (QR: not) its small parts
  float* Ring = Qs + (QR ? 1 : 2) * BQ * HD;  // NS pieces x (a part, its small parts)
  uint64_t* loaded = reinterpret_cast<uint64_t*>(Ring + NS * 2 * PART);
  uint64_t* full = loaded + NS;
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool tma = std::is_same<T, float>::value && sh.vec;
  // The block's head, q tile and kv tiles [j_lo, j_lo + n_t) (n_t may be
  // <= 0), derived by each role after its setmaxnreg (the block index
  // opaque to the compiler), so that none is held across it: one was, and
  // spilled.
  struct Where { int b, h, kh, q0, j_lo, n_t; };
  auto where = [&]() {
    uint32_t bx = blockIdx.x, by = gridDim.y - 1 - blockIdx.y;
    wg::reg_fence(bx);
    wg::reg_fence(by);
    Where r;
    r.b = bx / sh.H, r.h = bx % sh.H, r.kh = r.h / sh.G, r.q0 = by * BQ, r.j_lo = 0;
    if (sh.window > 0) r.j_lo = max(0, r.q0 - sh.window + 1) / BK;
    r.n_t = last_kv_tile(r.q0 + BQ - 1, BK, sh) - r.j_lo + 1;
    return r;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      wg::bar_init(&loaded[s], 1);
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], 4);  // one warpgroup's warps read a piece
    }
    wg::bar_init(qbar, 1);
    wg::bar_init_fence();
  }
  __syncthreads();

  // the roles by a warpgroup index that ptxas knows to be warp-uniform
  // (__shfl_sync), else it serialised the wgmma (C7520)
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == kWgConsumers / 128) {
    wg::reg_dealloc<kWideFwdProducerRegs>();
    const Where wp = where();
    const int b = wp.b, h = wp.h, kh = wp.kh, q0 = wp.q0, j_lo = wp.j_lo, n_t = wp.n_t;
    constexpr int kDerivers = 96;  // the producer's warps but its first
    const int pt = threadIdx.x - kWgConsumers - 32;
    if (pt < 0) {
      // the loader: q, then every piece once the consumers free its slot
      expect(qbar, BQ * HD * sizeof(float), tma);
      produce_rows<BQ, HD>(Qs, &tq, q, b, q0, sh.Sq, sh.H, h, qbar, tma);
      produced(qbar);
      for (int P = 0; P < n_t * PIECES; ++P) {
        const int s = P % NS, p = P % PIECES, k0 = (j_lo + P / PIECES) * BK;
        const int col = HALF * (p & 1) + PW * ((p % (2 * KP)) >> 1);  // the piece's columns
        if (P >= NS) wg::bar_wait(&empty[s], ((P / NS) & 1) ^ 1);
        float* dst = Ring + s * 2 * PART;
        expect(&loaded[s], PART * sizeof(float), tma);
        if (p < 2 * KP)  // k into the first part, v into the second
          produce_rows<BK, HD, PW>(dst, &tk, k, b, k0, sh.Sk, sh.K, kh, &loaded[s], tma, col);
        else
          produce_rows<BK, HD, PW>(dst + PART, &tv, v, b, k0, sh.Sk, sh.K, kh, &loaded[s], tma,
                                   col);
        produced(&loaded[s]);
      }
      return;
    }
    // the derivers, a piece a warp (warp d takes the slots s = d mod 3):
    // k's small parts; v^T's big parts, then its small parts
    for (int P = 0; P < n_t * PIECES; ++P) {
      const int s = P % NS;
      if (s % (kDerivers / 32) != pt / 32) continue;
      float* dst = Ring + s * 2 * PART;
      wg::bar_wait(&loaded[s], (P / NS) & 1);
      if (P % PIECES >= 2 * KP) {
        transpose_warp<PW, BK>(dst, dst + PART, lane);
        __syncwarp();
      }
      small_tile(dst + PART, dst, PART, lane, 32);
      produced(&full[s]);
    }
    return;
  }

  // the consumers: warpgroup wgi (columns HALF wgi..), its warp w (rows
  // 16w..), lane (g, t4)
  wg::reg_alloc<kWideFwdConsumerRegs>();
  const Where wh = where();
  const int q0 = wh.q0, j_lo = wh.j_lo, n_t = wh.n_t;
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0), w = warp & 3, g = lane >> 2,
            t4 = lane & 3, tid = threadIdx.x & 127;
  const int wr = 16 * w;
  constexpr int QK = HALF / 8;  // the warpgroup's k-steps of s
  const int qk0 = QK * wgi;     // its first, in q's columns

  wg::bar_wait(qbar, 0);
  uint32_t qsm[QR ? QK : 1][4];
  if constexpr (QR) {
#pragma unroll
    for (int kk = 0; kk < QK; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qsm[kk][e] = __float_as_uint(wg::small_part(
            Qs[wg::swz(wr + g + 8 * (e & 1), 8 * (qk0 + kk) + t4 + 4 * (e >> 1), BQ)]));
  } else {
    const int at = qk0 * 8 * BQ;  // the warpgroup's columns: HALF / 16 chunks
    small_tile(Qs + BQ * HD + at, Qs + at, HALF * BQ, tid, 128);
    wg::proxy_fence();
    wg::named_sync(kWgFwdGroupSync + wgi, 128);
  }

  // the scores in log2 units (log2(e) in the scale, which multiplies s after
  // the product): p = 2^(s - m), lse = ln 2 * m + ln l; lane (g, t4) keeps m
  // and l of rows g and g + 8 of the warp's strip, and o's accumulator over
  // the warpgroup's columns
  const float qscale = sh.scale * kLog2e;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f}, corr[2], acc[HALF / 2];
#pragma unroll
  for (int x = 0; x < HALF / 2; ++x) acc[x] = 0.0f;
  float sc[BK / 2], part[PW / 2];
  uint32_t pb[BK / 8][4], ps[BK / 8][4];  // p, A fragments

  auto slot = [&](int t, int p) { return (t * PIECES + p) % NS; };
  auto piece = [&](int t, int p) -> float* {  // once derived
    wg::bar_wait(&full[slot(t, p)], ((t * PIECES + p) / NS) & 1);
    return Ring + slot(t, p) * 2 * PART;
  };
  auto release = [&](int t, int p) {  // the warp has read it
    __syncwarp();
    if (lane == 0) wg::bar_arrive(&empty[slot(t, p)]);
  };
  const uint32_t q_lo = wg::desc_lo(Qs);
  auto at = [](uint32_t lo, int floats) { return wg::desc_of(lo + floats / 4); };

  auto skip = [&](int t) {  // a tile that no row sees: release the warpgroup's pieces
#pragma unroll
    for (int x = 0; x < KP; ++x) {
      piece(t, 2 * x + wgi);
      release(t, 2 * x + wgi);
      piece(t, 2 * KP + 2 * x + wgi);
      release(t, 2 * KP + 2 * x + wgi);
    }
  };
  // s of tile t over k piece x of the warpgroup's columns, 3xTF32 a k-step,
  // a commit group
  auto issue_s = [&](int t, int x) {
    uint32_t ql = q_lo;
    wg::reg_fence(ql);
    const uint32_t k_lo = wg::desc_lo(piece(t, 2 * x + wgi));
#pragma unroll
    for (int kk = 0; kk < PW / 8; ++kk) {
      const int qk = qk0 + PW / 8 * x + kk;
      const uint64_t qb = at(ql, kstep(qk, BQ)), kb = at(k_lo, kstep(kk, BK)),
                     ks = at(k_lo, PART + kstep(kk, BK));
      const int more = x > 0 || kk > 0;
      if constexpr (QR) wg::mma_rs<BK>(sc, qsm[PW / 8 * x + kk], kb, more);
      else wg::mma_ss<BK>(sc, at(ql, BQ * HD + kstep(qk, BQ)), kb, more);
      wg::mma_ss<BK>(sc, qb, ks, 1);
      wg::mma_ss<BK>(sc, qb, kb, 1);
    }
    wg::commit();
  };
  // Each piece is released as soon as its products have landed (one commit
  // group a piece), so that the loader refills its slot while the
  // warpgroup's later pieces are multiplied: once piece x's products are
  // issued (of a tile's k or v pieces from `first`), piece x - 1's are
  // waited for and it is released.  The last k piece holds the exchange,
  // the last v piece its tile's sum.
  auto landed = [&](int t, int x, int first) {
    if (x == 0) return;
    wg::wait<1>();
    release(t, first + 2 * (x - 1) + wgi);
  };
  int t = 0;
  for (; t < n_t && tile_empty(q0, BQ, (j_lo + t) * BK, BK, sh); ++t) skip(t);
  for (; t < n_t && !tile_empty(q0, BQ, (j_lo + t) * BK, BK, sh); ++t) {
    wg::fence();
#pragma unroll
    for (int x = 0; x < KP; ++x) {
      issue_s(t, x);
      landed(t, x, 0);
    }
    wg::wait<0>();
    reg_fence_all(sc);
    // the exchange: the partial s into the warpgroup's last k piece; once
    // both are there, s = s0 + s1 from the other's, whose piece is released
    float* mine = Ring + slot(t, 2 * (KP - 1) + wgi) * 2 * PART;
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) mine[x * 128 + tid] = sc[x];
    wg::proxy_fence();
    wg::named_sync(kWideFwdXSync, kWgConsumers);
    const float* theirs = Ring + slot(t, 2 * (KP - 1) + (wgi ^ 1)) * 2 * PART;
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) sc[x] += theirs[x * 128 + tid];
    release(t, 2 * (KP - 1) + (wgi ^ 1));

    const int c0 = (j_lo + t) * BK;
    fwd_softmax<BK>(sc, m, l, corr, qscale, tile_masked(q0 + wr, 16, c0, BK, sh), q0 + wr, c0,
                    sh);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) a_of(sc, n, pb[n], ps[n]);
    // o = o 2^(m_prev - m) + the tile's p v: the rescale now, then o's
    // columns PW x.. of the warpgroup's from v piece x, summed from 0, added
    // once its products have landed, the piece then released
#pragma unroll
    for (int x = 0; x < HALF / 2; ++x) acc[x] *= corr[(x >> 1) & 1];
#pragma unroll
    for (int x = 0; x < KP; ++x) {
      const uint32_t v_lo = wg::desc_lo(piece(t, 2 * KP + 2 * x + wgi));
      wg::fence();
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const uint64_t tb = at(v_lo, kstep(n, PW)), ts = at(v_lo, PART + kstep(n, PW));
        wg::mma_rs<PW>(part, ps[n], tb, n > 0);
        wg::mma_rs<PW>(part, pb[n], ts, 1);
        wg::mma_rs<PW>(part, pb[n], tb, 1);
      }
      wg::commit();
      wg::wait<0>();
      reg_fence_all(part);
      release(t, 2 * KP + 2 * x + wgi);
#pragma unroll
      for (int y = 0; y < PW / 2; ++y) acc[PW / 2 * x + y] += part[y];
    }
    reg_fence_all(pb);
    reg_fence_all(ps);
  }
  for (; t < n_t; ++t) skip(t);

  // b and h read again (held through the tile loop at 232 registers, b
  // spilled; from where() after its fence, the kernel ran 30% slower)
  const int b = blockIdx.x / sh.H, h = blockIdx.x % sh.H;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = q0 + wr + g + 8 * e2;
    if (row >= sh.Sq) continue;
    const float lr = fmaxf(l[e2], 1e-30f);
    T* out = o + ((static_cast<long long>(b) * sh.Sq + row) * sh.H + h) * HD + HALF * wgi + 2 * t4;
#pragma unroll
    for (int c = 0; c < HALF / 8; ++c) {
      out[8 * c] = from_f32<T>(acc[4 * c + 2 * e2] / lr);
      out[8 * c + 1] = from_f32<T>(acc[4 * c + 2 * e2 + 1] / lr);
    }
    if (wgi == 0 && t4 == 0)
      lse[(static_cast<long long>(b) * sh.H + h) * sh.Sq + row] = kLn2 * m[e2] + logf(lr);
  }
}

// --------------------------------------------------------------------------
// B5, q-parallel pass on wgmma: dq and delta.  grid (B*H, nq) over
// kWgRows-row q tiles, i = nq - 1 - blockIdx.y; warpgroup w owns rows
// 64w..64w+63 of the tile, and the block walks its kWgTile-key kv tiles.
// The producer warpgroup derives each stage's small parts and k^T (its
// first warp loading the next tile meanwhile), so the consumers only
// multiply: a stage is k, v, their small parts, k^T's big and small parts,
// with three mbarriers: loaded (the copies), full (derived), empty (read).
// --------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
swa_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const T* __restrict__ q,
                     const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ o,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     float* __restrict__ delta, T* __restrict__ dq, Shape sh) {
  static_assert(HD <= kWgMaxHd && HD % 16 == 0, "hd 32 or 64");
  constexpr int NS = kWgStages, BK = kWgTile, KS = HD / 8, TILE = BK * HD;
  extern __shared__ float smem_raw[];
  float* Qs = aligned_smem(smem_raw);  // [HD / 16][kWgRows][16]
  float* dOs = Qs + kWgRows * HD;
  // NS stages x (k, v [HD / 16][BK][16], their small parts, k^T [2][HD][16]
  // with the keys in kperm order: big, then small parts)
  float* Ring = dOs + kWgRows * HD;
  uint64_t* loaded = reinterpret_cast<uint64_t*>(Ring + NS * 6 * TILE);
  uint64_t* full = loaded + NS;
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  const int i = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / sh.H, h = blockIdx.x % sh.H, kh = h / sh.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = i * kWgRows;
  int j_lo = 0;
  if (sh.window > 0) j_lo = max(0, q0 - sh.window + 1) / BK;
  const int n_t = last_kv_tile(q0 + kWgRows - 1, BK, sh) - j_lo + 1;  // may be <= 0
  const bool tma = std::is_same<T, float>::value && sh.vec;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      wg::bar_init(&loaded[s], 1);
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], kWgConsumers / 32);
    }
    wg::bar_init(qbar, 1);
    wg::bar_init_fence();
  }
  __syncthreads();

  if (warp >= kWgConsumers / 32) {
    // the producer: its first warp loads q and do of the block's rows, then
    // keeps the kv ring NS - 1 tiles ahead of the warpgroup's derivation
    if constexpr (HD > 32) wg::reg_dealloc<kWgProducerRegs>();
    const int pt = threadIdx.x - kWgConsumers;
    const bool loader = warp == kWgConsumers / 32;
    auto load = [&](int t) {
      const int s = t % NS;
      if (t >= NS) wg::bar_wait(&empty[s], ((t / NS) & 1) ^ 1);
      float* Ks = Ring + s * 6 * TILE;
      const int k0 = (j_lo + t) * BK;
      expect(&loaded[s], 2 * TILE * sizeof(float), tma);
      produce_rows<BK, HD>(Ks, &tk, k, b, k0, sh.Sk, sh.K, kh, &loaded[s], tma);
      produce_rows<BK, HD>(Ks + TILE, &tv, v, b, k0, sh.Sk, sh.K, kh, &loaded[s], tma);
      produced(&loaded[s]);
    };
    if (loader) {
      expect(qbar, 2 * kWgRows * HD * sizeof(float), tma);
      produce_rows<kWgRows, HD>(Qs, &tq, q, b, q0, sh.Sq, sh.H, h, qbar, tma);
      produce_rows<kWgRows, HD>(dOs, &tdo, dout, b, q0, sh.Sq, sh.H, h, qbar, tma);
      produced(qbar);
      for (int t = 0; t < min(NS - 1, n_t); ++t) load(t);
    }
    for (int t = 0; t < n_t; ++t) {
      const int s = t % NS;
      float* Ks = Ring + s * 6 * TILE;
      wg::bar_wait(&loaded[s], (t / NS) & 1);
      small_tile(Ks + 2 * TILE, Ks, 2 * TILE, pt, 128);  // k's and v's small parts
      transpose_tile<HD>(Ks + 4 * TILE, Ks + 5 * TILE, Ks, pt, 128);
      wg::proxy_fence();
      wg::named_sync(kWgProducerSync, 128);
      if (pt == 0) wg::bar_arrive(&full[s]);
      // then the tile NS - 1 ahead, into the stage that tile t - 1 frees
      if (loader && t + NS - 1 < n_t) load(t + NS - 1);
    }
    return;
  }

  // the consumers: warpgroup wgi, its warp w, lane (g, t4)
  if constexpr (HD > 32) wg::reg_alloc<kWgConsumerRegs>();
  const int wgi = warp >> 2, w = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int r0 = 64 * wgi, wr = r0 + 16 * w;  // the warpgroup's first row, the warp's
  const long long row_base = (static_cast<long long>(b) * sh.H + h) * sh.Sq;

  // delta of the warp's 16 rows, as swa_bwd_dq_kernel takes it, read from o
  // and do in device memory while q and do fly
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
    if (lane == 0 && row < sh.Sq) delta[row_base + row] = part;
    if (r == g) dl[0] = part;
    if (r == g + 8) dl[1] = part;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + wr + g + 8 * e;
    if (row < sh.Sq) lr[e] = lse[row_base + row];
  }

  // the small parts of the warpgroup's q and do, A fragments of every kv tile
  wg::bar_wait(qbar, 0);
  uint32_t qsm[KS][4], osm[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = wg::swz(wr + g + 8 * (e & 1), 8 * kk + t4 + 4 * (e >> 1), kWgRows);
      qsm[kk][e] = __float_as_uint(wg::small_part(Qs[at]));
      osm[kk][e] = __float_as_uint(wg::small_part(dOs[at]));
    }

  float acc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) acc[x] = 0.0f;

  for (int t = 0; t < n_t; ++t) {
    const int s = t % NS, j = j_lo + t;
    const float* Ks = Ring + s * 6 * TILE;
    const float* Vs = Ks + TILE;
    const float* Ksm = Ks + 2 * TILE;
    const float* Vsm = Ks + 3 * TILE;
    const float* KTb = Ks + 4 * TILE;
    const float* KTs = Ks + 5 * TILE;
    wg::bar_wait(&full[s], (t / NS) & 1);

    const bool live = !tile_empty(q0 + r0, 64, j * BK, BK, sh);
    float sc[BK / 2], dp[BK / 2];
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) sc[x] = dp[x] = 0.0f;
    if (live) {
      // s = q k^T and dp = do v^T on the warpgroup's 64 rows x BK keys
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint64_t qb = wg::desc(Qs + kstep(kk, kWgRows) + r0 * 16);
        const uint64_t kb = wg::desc(Ks + kstep(kk, BK)), ks = wg::desc(Ksm + kstep(kk, BK));
        wg::mma_rs<BK>(sc, qsm[kk], kb, kk > 0);
        wg::mma_ss<BK>(sc, qb, ks, 1);
        wg::mma_ss<BK>(sc, qb, kb, 1);
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint64_t ob = wg::desc(dOs + kstep(kk, kWgRows) + r0 * 16);
        const uint64_t vb = wg::desc(Vs + kstep(kk, BK)), vs = wg::desc(Vsm + kstep(kk, BK));
        wg::mma_rs<BK>(dp, osm[kk], vb, kk > 0);
        wg::mma_ss<BK>(dp, ob, vs, 1);
        wg::mma_ss<BK>(dp, ob, vb, 1);
      }
      wg::commit();
      wg::wait<0>();
      reg_fence_all(sc);
      reg_fence_all(dp);
      reg_fence_all(qsm);
      reg_fence_all(osm);
    }
    if (!live) {
      __syncwarp();
      if (lane == 0) wg::bar_arrive(&empty[s]);
      continue;
    }

    // ds = p (dp - delta), p = exp(scale s - lse) where the mask allows;
    // sc[4n + e] is (row g + 8 (e / 2), key 8n + 2 t4 + e % 2) of the warp's strip
    const bool masked = tile_masked(q0 + wr, 16, j * BK, BK, sh);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, x = 4 * n + e;
        float p = expf(sh.scale * sc[x] - lr[r]);
        if (masked && !allowed(q0 + wr + g + 8 * r, j * BK + 8 * n + 2 * t4 + (e & 1), sh))
          p = 0.0f;
        sc[x] = p * (dp[x] - dl[r]);
      }

    // dq += ds k, the keys as k: the tile's keys summed on the tensor cores
    // from 0 and added to dq in f32 (each product rounds toward zero, so a
    // long chain of them into one sum drifts)
    float part[HD / 2];
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) part[x] = 0.0f;
    uint32_t ab[BK / 8][4], as[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) a_of(sc, n, ab[n], as[n]);
    wg::fence();
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const uint64_t tb = wg::desc(KTb + kstep(n, HD)), ts = wg::desc(KTs + kstep(n, HD));
      wg::mma_rs<HD>(part, as[n], tb, n > 0);
      wg::mma_rs<HD>(part, ab[n], ts, 1);
      wg::mma_rs<HD>(part, ab[n], tb, 1);
    }
    wg::commit();
    wg::wait<0>();
    reg_fence_all(part);
    reg_fence_all(ab);
    reg_fence_all(as);
    __syncwarp();
    if (lane == 0) wg::bar_arrive(&empty[s]);  // the stage is read
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) acc[x] += part[x];
  }

#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = q0 + wr + g + 8 * e2;
    if (row >= sh.Sq) continue;
    T* out = dq + ((static_cast<long long>(b) * sh.Sq + row) * sh.H + h) * HD + 2 * t4;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      out[8 * c] = from_f32<T>(acc[4 * c + 2 * e2] * sh.scale);
      out[8 * c + 1] = from_f32<T>(acc[4 * c + 2 * e2 + 1] * sh.scale);
    }
  }
}

// --------------------------------------------------------------------------
// B5, kv-parallel pass on wgmma: dk and dv, summed over the G query heads of
// each kv head.  grid (B*K, nk) over kWgRows-key kv tiles, j = blockIdx.y;
// warpgroup w owns keys 64w..64w+63 of the tile, and the block walks every
// (query head, kWgTile-row q tile) that sees its keys.  The producer
// warpgroup derives each q tile's small parts of q and do into the tile's
// stage (read by s^T and dp^T), and q^T, do^T into one buffer (read by dv
// and dk) while the consumers run the tile's first products: a stage has
// loaded, derived ("full") and read ("empty") mbarriers, the transposes
// their own full and empty pair.
// --------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
swa_bwd_dkv_wg_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const T* __restrict__ q,
                      const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      Shape sh) {
  static_assert(HD <= kWgMaxHd && HD % 16 == 0, "hd 32 or 64");
  constexpr int NS = kWgStages, BQ = kWgTile, KS = HD / 8, TILE = BQ * HD, KV = kWgRows * HD;
  extern __shared__ float smem_raw[];
  float* Ks = aligned_smem(smem_raw);  // [HD / 16][kWgRows][16]: k, its small parts, v, v's
  float* Ksm = Ks + KV;
  float* Vs = Ksm + KV;
  float* Vsm = Vs + KV;
  float* Ring = Vsm + KV;              // NS stages x (q, do, their small parts) [HD / 16][BQ][16]
  float* QTb = Ring + NS * 4 * TILE;   // q^T and do^T [2][HD][16], rows in kperm order
  float* QTs = QTb + TILE;
  float* dOTb = QTs + TILE;
  float* dOTs = dOTb + TILE;
  float* Stat = dOTs + TILE;           // NS stages x (lse [BQ], delta [BQ])
  uint64_t* loaded = reinterpret_cast<uint64_t*>(Stat + NS * 2 * BQ);
  uint64_t* full = loaded + NS;
  uint64_t* empty = full + NS;
  uint64_t* tfull = empty + NS;        // the transposes' pair
  uint64_t* tempty = tfull + 1;
  uint64_t* kbar = tempty + 1;

  const int j = blockIdx.y;
  const int b = blockIdx.x / sh.K, kh = blockIdx.x % sh.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = j * kWgRows;
  const int nq = (sh.Sq + BQ - 1) / BQ;
  const int i_lo = k0 < sh.prefix ? 0 : k0 / BQ;  // the prefix is seen from row 0
  int i_hi = nq - 1;  // the last q tile whose rows see a key of this tile
  if (sh.window > 0) i_hi = min(i_hi, (k0 + kWgRows - 1 + sh.window - 1) / BQ);
  // none when Sq < Sk leaves the tile's keys past every causal row
  const int n_i = max(i_hi - i_lo + 1, 0), n_it = sh.G * n_i;
  const bool tma = std::is_same<T, float>::value && sh.vec;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      wg::bar_init(&loaded[s], 1);
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], kWgConsumers / 32);
    }
    wg::bar_init(tfull, 1);
    wg::bar_init(tempty, kWgConsumers / 32);
    wg::bar_init(kbar, 1);
    wg::bar_init_fence();
  }
  __syncthreads();

  if (warp >= kWgConsumers / 32) {
    // the producer: its first warp loads k and v of the block's keys, then
    // keeps the q/do ring one tile ahead of the warpgroup's derivation
    const int pt = threadIdx.x - kWgConsumers;
    const bool loader = warp == kWgConsumers / 32;
    auto load = [&](int it) {
      const int s = it % NS;
      if (it >= NS) wg::bar_wait(&empty[s], ((it / NS) & 1) ^ 1);
      const int h = kh * sh.G + it / n_i, q0 = (i_lo + it % n_i) * BQ;
      const long long row_base = (static_cast<long long>(b) * sh.H + h) * sh.Sq;
      float* Qs = Ring + s * 4 * TILE;
      float* St = Stat + s * 2 * BQ;
      const bool ok = q0 + lane < sh.Sq;
      St[lane] = ok ? lse[row_base + q0 + lane] : 0.0f;
      St[BQ + lane] = ok ? delta[row_base + q0 + lane] : 0.0f;
      expect(&loaded[s], 2 * TILE * sizeof(float), tma);
      produce_rows<BQ, HD>(Qs, &tq, q, b, q0, sh.Sq, sh.H, h, &loaded[s], tma);
      produce_rows<BQ, HD>(Qs + TILE, &tdo, dout, b, q0, sh.Sq, sh.H, h, &loaded[s], tma);
      produced(&loaded[s]);
    };
    if (loader) {
      expect(kbar, 2 * KV * sizeof(float), tma);
      produce_rows<kWgRows, HD>(Ks, &tk, k, b, k0, sh.Sk, sh.K, kh, kbar, tma);
      produce_rows<kWgRows, HD>(Vs, &tv, v, b, k0, sh.Sk, sh.K, kh, kbar, tma);
      produced(kbar);
      if (n_it > 0) load(0);
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % NS;
      float* Qs = Ring + s * 4 * TILE;
      wg::bar_wait(&loaded[s], (it / NS) & 1);
      small_tile(Qs + 2 * TILE, Qs, 2 * TILE, pt, 128);  // q's and do's small parts
      wg::proxy_fence();
      wg::named_sync(kWgProducerSync, 128);
      if (pt == 0) wg::bar_arrive(&full[s]);
      // the next tile, into the stage whose first products (it - 1) are done
      if (loader && it + 1 < n_it) load(it + 1);
      if (it > 0) wg::bar_wait(tempty, (it - 1) & 1);  // dv and dk of it - 1 are done
      transpose_tile<HD>(QTb, QTs, Qs, pt, 128);
      transpose_tile<HD>(dOTb, dOTs, Qs + TILE, pt, 128);
      wg::proxy_fence();
      wg::named_sync(kWgProducerSync, 128);
      if (pt == 0) wg::bar_arrive(tfull);
    }
    return;
  }

  // the consumers: warpgroup wgi, its warp w, lane (g, t4)
  const int wgi = warp >> 2, w = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int r0 = 64 * wgi, wk = r0 + 16 * w;  // the warpgroup's first key, the warp's
  // k and v are the A operands of every q tile: their small parts, once
  wg::bar_wait(kbar, 0);
  small_tile(Ksm, Ks, KV, threadIdx.x, kWgConsumers);
  small_tile(Vsm, Vs, KV, threadIdx.x, kWgConsumers);
  wg::proxy_fence();
  wg::named_sync(kWgSync, kWgConsumers);

  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) dka[x] = dva[x] = 0.0f;

  for (int it = 0; it < n_it; ++it) {
    const int s = it % NS, q0 = (i_lo + it % n_i) * BQ;
    const float* Qs = Ring + s * 4 * TILE;
    const float* dOs = Qs + TILE;
    const float* Qsm = Qs + 2 * TILE;
    const float* dOsm = Qs + 3 * TILE;
    const float* Ls = Stat + s * 2 * BQ;
    const float* Ds = Ls + BQ;
    wg::bar_wait(&full[s], (it / NS) & 1);

    const bool live = !tile_empty(q0, BQ, k0 + r0, 64, sh);
    float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int x = 0; x < BQ / 2; ++x) st[x] = dpt[x] = 0.0f;
    if (live) {
      // s^T = k q^T and dp^T = v do^T on the warpgroup's 64 keys x BQ rows
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint64_t kb = wg::desc(Ks + kstep(kk, kWgRows) + r0 * 16);
        const uint64_t ks = wg::desc(Ksm + kstep(kk, kWgRows) + r0 * 16);
        const uint64_t qb = wg::desc(Qs + kstep(kk, BQ)), qs = wg::desc(Qsm + kstep(kk, BQ));
        wg::mma_ss<BQ>(st, ks, qb, kk > 0);
        wg::mma_ss<BQ>(st, kb, qs, 1);
        wg::mma_ss<BQ>(st, kb, qb, 1);
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint64_t vb = wg::desc(Vs + kstep(kk, kWgRows) + r0 * 16);
        const uint64_t vs = wg::desc(Vsm + kstep(kk, kWgRows) + r0 * 16);
        const uint64_t ob = wg::desc(dOs + kstep(kk, BQ)), os = wg::desc(dOsm + kstep(kk, BQ));
        wg::mma_ss<BQ>(dpt, vs, ob, kk > 0);
        wg::mma_ss<BQ>(dpt, vb, os, 1);
        wg::mma_ss<BQ>(dpt, vb, ob, 1);
      }
      wg::commit();
      wg::wait<0>();
      reg_fence_all(st);
      reg_fence_all(dpt);

      // p^T = exp(scale s^T - lse) where the mask allows, ds^T = p^T (dp^T
      // - delta); st[4n + e] is (key g + 8 (e / 2), row 8n + 2 t4 + e % 2)
      // of the warp's strip
      const bool masked = tile_masked(q0, BQ, k0 + wk, 16, sh);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * n + e, row = 8 * n + 2 * t4 + (e & 1);
          float p = expf(sh.scale * st[x] - Ls[row]);
          if (masked && !allowed(q0 + row, k0 + wk + g + 8 * (e >> 1), sh)) p = 0.0f;
          st[x] = p;
          dpt[x] = p * (dpt[x] - Ds[row]);
        }
    }
    __syncwarp();
    if (lane == 0) wg::bar_arrive(&empty[s]);  // the stage's q, do, lse and delta are read
    wg::bar_wait(tfull, it & 1);
    if (!live) {
      __syncwarp();
      if (lane == 0) wg::bar_arrive(tempty);
      continue;
    }

    // dv += p^T do, then dk += ds^T q, the rows as k: each q tile's rows
    // summed on the tensor cores from 0 and added to dk and dv in f32
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const float* Bb = pass == 0 ? dOTb : QTb;
      const float* Bs = pass == 0 ? dOTs : QTs;
      uint32_t ab[BQ / 8][4], as[BQ / 8][4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        if (pass == 0) a_of(st, n, ab[n], as[n]);
        else a_of(dpt, n, ab[n], as[n]);
      }
      float part[HD / 2];
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) part[x] = 0.0f;
      wg::fence();
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const uint64_t tb = wg::desc(Bb + kstep(n, HD)), ts = wg::desc(Bs + kstep(n, HD));
        wg::mma_rs<HD>(part, as[n], tb, n > 0);
        wg::mma_rs<HD>(part, ab[n], ts, 1);
        wg::mma_rs<HD>(part, ab[n], tb, 1);
      }
      wg::commit();
      wg::wait<0>();
      reg_fence_all(part);
      reg_fence_all(ab);
      reg_fence_all(as);
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) {
        if (pass == 0) dva[x] += part[x];
        else dka[x] += part[x];
      }
    }
    __syncwarp();
    if (lane == 0) wg::bar_arrive(tempty);  // q^T and do^T are read
  }

#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int key = k0 + wk + g + 8 * e2;
    if (key >= sh.Sk) continue;
    const long long off = ((static_cast<long long>(b) * sh.Sk + key) * sh.K + kh) * HD + 2 * t4;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        dk[off + 8 * c + e1] = from_f32<T>(dka[4 * c + 2 * e2 + e1] * sh.scale);
        dv[off + 8 * c + e1] = from_f32<T>(dva[4 * c + 2 * e2 + e1]);
      }
  }
}

// --------------------------------------------------------------------------
// B5 on wgmma at head dim 128 (the "half" kernels).  The hd-64 passes'
// layout (each consumer warpgroup over its own 64 rows or keys and all of
// hd) does not fit at hd 128: the dq pass's resident q and do and its kv
// ring would take 320 KB, the dk/dv pass's 449 KB.  So, as the forward at hd
// 256 does (swa_fwd_wg_wide_kernel), both consumer warpgroups work on the
// same 64 rows (dq pass) or 64 keys (dk/dv pass), and warpgroup w owns hd's
// columns HALF w.. (HALF = 64): the k-steps of the score products over them
// (s and dp, or s^T and dp^T: m64n32k8, 8 k-steps of three terms) and its
// half of the output (dq: 32 accumulators a lane; dk and dv: 32 + 32).  The
// two warpgroups' partial score products are added in f32 through shared
// memory (s0 + s1 is s1 + s0: both hold the same p and ds bit for bit), and
// each multiplies p or ds by its own columns (m64n64k8, A from the
// accumulator in registers).  The operands of the whole block stay resident
// in shared memory (dq: q, do and their small parts; dk/dv: k, v and
// theirs; 128 KB: every term of the score products reads A there);
// the rest streams through an even ring of pieces, each kHalfTile rows x
// HALF columns beside its small parts (16 KB): a kv tile of the dq pass is
// k (read by s), v (dp) and k^T (dq) of each warpgroup's columns, a (query
// head, q tile) of the dk/dv pass q (s^T), do (dp^T), do^T (dv) and q^T (dk).
// The producer's first warp only loads (TMA for 16-byte aligned f32, else
// plain loads converted to f32; a piece to transpose into its second part);
// each of its three other warps derives whole pieces (the slots s = its
// index mod 3; a slot's pieces are one warpgroup's and one warp's, the ring
// being even): the transpose first (keys or rows in kperm order), then the
// small parts.  A warpgroup writes its partial score products into its own
// consumed k (dq) or do (dk/dv) piece, and the other warpgroup releases
// that piece once it has read them; every other piece is released once its
// products have landed.  A tile's score products wait for both of their
// pieces first, and nothing runs while they fly: a wait or a release there
// made ptxas serialise the wgmma (its C7511 note, "too few registers for the
// wgmma pipeline"; PERF.md §6).  Both warpgroups compute delta (the dq pass,
// as swa_bwd_dq_kernel does, bit for bit; the first writes it).  The dk/dv
// pass cuts a kv tile's (query head, q tile) iterations into `splits`
// ranges over the grid's first dimension, as the hd-256 pass does, their
// f32 sums merged by swa_bwd_dkv_merge_kernel: its 64-key tiles give
// B*K*Sk/64 blocks of unequal length (128 at qwen2-1.5b's Engine-B shape,
// which 2 splits run 1.8x faster than 1).  No atomics: results repeat bit
// for bit.  What bounds them: not the tensor cores (one product a k-step
// saves about a third), but each tile's serial chain in a consumer
// warpgroup (its products, the exchange's barrier, the softmax), and the
// serialised wgmma wherever ptxas notes C7511.  The knobs below are
// chip_ablate_attention.py's "half" variants.
// --------------------------------------------------------------------------
constexpr int kHalfHd = 128;               // the head dim of these kernels
constexpr int kHalfRows = 64;              // dq: q rows a block; dk/dv: keys a block
constexpr int kHalfTile = 32;              // dq: keys a kv tile; dk/dv: rows a q tile
constexpr int kHalfPiece = kHalfTile * kHalfHd / 2;  // floats of one part of a piece
constexpr int kHalfDqStages = 6;           // pieces in the dq ring
constexpr int kHalfDkvStages = 4;          // pieces in the dk/dv ring
constexpr int kHalfStats = 4;              // dk/dv: the q tiles' (lse, delta) ring
constexpr int kHalfGroupSync = 3;          // and 4: each consumer warpgroup's named barrier
constexpr int kHalfXSync = 5;              // the consumers' named barrier of the exchange
// Registers a thread (setmaxnreg moves them within the 168 x 384 that the
// block holds from its launch): the consumers hold the output's 32 or 64
// accumulators, a product's 32, s and dp, their A fragments and (dq) q's
// and do's small parts; the producer keeps the rest.
constexpr int kHalfConsumerRegs = 224;
constexpr int kHalfProducerRegs =
    ((65536 / kWgThreads / 8 * 8) * kWgThreads - kWgConsumers * kHalfConsumerRegs) / 128 / 8 * 8;
static_assert(kHalfProducerRegs >= 24, "setmaxnreg's least");

template <int HD> constexpr size_t dq_half_smem() {
  return (4 * kHalfRows * HD + kHalfDqStages * 2 * kHalfPiece) * sizeof(float) +
         (3 * kHalfDqStages + 1) * sizeof(uint64_t) + 1024;
}
template <int HD> constexpr size_t dkv_half_smem() {
  return (4 * kHalfRows * HD + kHalfDkvStages * 2 * kHalfPiece + kHalfStats * 2 * kHalfTile) *
             sizeof(float) +
         (3 * kHalfDkvStages + 1) * sizeof(uint64_t) + 1024;
}

// The derivers of a half kernel's ring of NS slots, PIECES pieces a tile
// (the producer's warps but its first; this one's thread pt of 96): piece
// P < n once loaded, the pieces from the tile's fourth on transposed first
// (their rows loaded into the second part), then every piece's small parts.
template <int NS, int PIECES>
__device__ __forceinline__ void half_derive(float* Ring, uint64_t* loaded, uint64_t* full, int n,
                                            int pt) {
  const int lane = threadIdx.x & 31;
  for (int P = 0; P < n; ++P) {
    const int s = P % NS;
    if (s % 3 != pt / 32) continue;
    float* dst = Ring + s * 2 * kHalfPiece;
    wg::bar_wait(&loaded[s], (P / NS) & 1);
    if (P % PIECES >= 4) {
      transpose_warp<kHalfHd / 2, kHalfTile>(dst, dst + kHalfPiece, lane);
      __syncwarp();
    }
    small_tile(dst + kHalfPiece, dst, kHalfPiece, lane, 32);
    produced(&full[s]);
  }
}

// --------------------------------------------------------------------------
// B5, q-parallel pass at hd 128 on wgmma: dq and delta.  grid (B*H, nq) over
// kHalfRows-row q tiles, i = nq - 1 - blockIdx.y, the heaviest first; both
// consumer warpgroups own the tile's rows (warp w rows 16w..), warpgroup w
// hd's columns HALF w..  A kv tile is six pieces: k of each warpgroup's
// columns, v's, then k's again, transposed.
// --------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
swa_bwd_dq_wg_half_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, const T* __restrict__ q,
                          const T* __restrict__ k, const T* __restrict__ v,
                          const T* __restrict__ o, const T* __restrict__ dout,
                          const float* __restrict__ lse, float* __restrict__ delta,
                          T* __restrict__ dq, Shape sh) {
  constexpr int BQ = kHalfRows, BK = kHalfTile, HALF = HD / 2, PART = kHalfPiece;
  constexpr int NS = kHalfDqStages, PIECES = 6;
  constexpr int KS = HALF / 8;  // a warpgroup's k-steps of s and dp
  static_assert(HD == kHalfHd && PART == BK * HALF, "hd 128");
  static_assert(NS % 2 == 0 && NS >= 4, "an even ring that holds a tile's k and v pieces");
  static_assert(2 * BQ * BK <= 2 * PART, "the partial s and dp fit in a k piece");
  extern __shared__ float smem_raw[];
  float* Qs = aligned_smem(smem_raw);  // [HD / 16][BQ][16]: q, do, their small parts
  float* dOs = Qs + BQ * HD;
  float* Ring = Qs + 4 * BQ * HD;      // NS pieces x (a part, its small parts)
  uint64_t* loaded = reinterpret_cast<uint64_t*>(Ring + NS * 2 * PART);
  uint64_t* full = loaded + NS;
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool tma = std::is_same<T, float>::value && sh.vec;
  // The block's head, q tile and kv tiles [j_lo, j_lo + n_t), derived by
  // each role after its setmaxnreg, so that none is held across it
  struct Where { int b, h, kh, q0, j_lo, n_t; };
  auto where = [&]() {
    uint32_t bx = blockIdx.x, by = gridDim.y - 1 - blockIdx.y;
    wg::reg_fence(bx);
    wg::reg_fence(by);
    Where r;
    r.b = bx / sh.H, r.h = bx % sh.H, r.kh = r.h / sh.G, r.q0 = by * BQ, r.j_lo = 0;
    if (sh.window > 0) r.j_lo = max(0, r.q0 - sh.window + 1) / BK;
    r.n_t = max(last_kv_tile(r.q0 + BQ - 1, BK, sh) - r.j_lo + 1, 0);
    return r;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      wg::bar_init(&loaded[s], 1);
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], 4);  // one warpgroup's warps read a piece
    }
    wg::bar_init(qbar, 1);
    wg::bar_init_fence();
  }
  __syncthreads();

  // the roles by a warpgroup index that ptxas knows to be warp-uniform
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == kWgConsumers / 128) {
    wg::reg_dealloc<kHalfProducerRegs>();
    const Where wp = where();
    const int n = wp.n_t * PIECES, pt = threadIdx.x - kWgConsumers - 32;
    if (pt < 0) {
      // the loader: q and do, then every piece once the consumers free its slot
      expect(qbar, 2 * BQ * HD * sizeof(float), tma);
      produce_rows<BQ, HD>(Qs, &tq, q, wp.b, wp.q0, sh.Sq, sh.H, wp.h, qbar, tma);
      produce_rows<BQ, HD>(dOs, &tdo, dout, wp.b, wp.q0, sh.Sq, sh.H, wp.h, qbar, tma);
      produced(qbar);
      for (int P = 0; P < n; ++P) {
        const int s = P % NS, p = P % PIECES, k0 = (wp.j_lo + P / PIECES) * BK;
        if (P >= NS) wg::bar_wait(&empty[s], ((P / NS) & 1) ^ 1);
        float* dst = Ring + s * 2 * PART;
        const bool is_v = p == 2 || p == 3;
        expect(&loaded[s], PART * sizeof(float), tma);
        // k (pieces 0, 1) and v (2, 3) into the first part, k to transpose
        // (4, 5) into the second
        produce_rows<BK, HD, HALF>(dst + (p >= 4 ? PART : 0), is_v ? &tv : &tk, is_v ? v : k,
                                   wp.b, k0, sh.Sk, sh.K, wp.kh, &loaded[s], tma, HALF * (p & 1));
        produced(&loaded[s]);
      }
      return;
    }
    half_derive<NS, PIECES>(Ring, loaded, full, n, pt);
    return;
  }

  // the consumers: warpgroup wgi (columns HALF wgi..), its warp w (rows
  // 16w..), lane (g, t4)
  wg::reg_alloc<kHalfConsumerRegs>();
  const Where wh = where();
  const int n_t = wh.n_t, j_lo = wh.j_lo, q0 = wh.q0;
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // uniform to ptxas
  const int w = warp & 3, g = lane >> 2, t4 = lane & 3, tid = threadIdx.x & 127;
  const int wr = 16 * w;
  const int qk0 = KS * wgi;  // the warpgroup's first k-step of s and dp, in q's columns

  // delta of the warp's 16 rows, as swa_bwd_dq_kernel takes it (each
  // warpgroup computes it; the first writes it), read from o and do in
  // device memory while q and do fly; lane (g, t4) keeps rows g and g + 8
  float dl[2] = {0.0f, 0.0f}, lr[2] = {0.0f, 0.0f};
  {
    const int b = wh.b, h = wh.h;
    const long long row_base = (static_cast<long long>(b) * sh.H + h) * sh.Sq;
    for (int r = 0; r < 16; ++r) {
      const int row = q0 + wr + r;
      float part = 0.0f;
      if (row < sh.Sq) {
        const long long off = ((static_cast<long long>(b) * sh.Sq + row) * sh.H + h) * HD;
        for (int d = lane; d < HD; d += 32) part += to_f32(o[off + d]) * to_f32(dout[off + d]);
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) part += __shfl_xor_sync(0xffffffffu, part, m);
      if (wgi == 0 && lane == 0 && row < sh.Sq) delta[row_base + row] = part;
      if (r == g) dl[0] = part;
      if (r == g + 8) dl[1] = part;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = q0 + wr + g + 8 * e;
      if (row < sh.Sq) lr[e] = lse[row_base + row];
    }
  }

  // the small parts of the warpgroup's columns of q and do, beside them (as
  // register A fragments, 64 registers a thread, ptxas serialised the
  // wgmma: PERF.md §6)
  wg::bar_wait(qbar, 0);
  {
    const int at = qk0 * 8 * BQ;  // the warpgroup's columns: HALF / 16 chunks
    small_tile(Qs + 2 * BQ * HD + at, Qs + at, HALF * BQ, tid, 128);
    small_tile(Qs + 3 * BQ * HD + at, dOs + at, HALF * BQ, tid, 128);
    wg::proxy_fence();
    wg::named_sync(kHalfGroupSync + wgi, 128);
  }

  float acc[HALF / 2];
#pragma unroll
  for (int x = 0; x < HALF / 2; ++x) acc[x] = 0.0f;
  float sc[BK / 2], dp[BK / 2], part[HALF / 2];
  uint32_t ab[BK / 8][4], as[BK / 8][4];  // ds, A fragments

  auto slot = [&](int t, int p) { return (t * PIECES + p) % NS; };
  auto piece = [&](int t, int p) -> float* {  // once derived
    wg::bar_wait(&full[slot(t, p)], ((t * PIECES + p) / NS) & 1);
    return Ring + slot(t, p) * 2 * PART;
  };
  auto release = [&](int t, int p) {  // the warp has read it
    __syncwarp();
    if (lane == 0) wg::bar_arrive(&empty[slot(t, p)]);
  };
  const uint32_t q_lo = wg::desc_lo(Qs);
  auto at = [](uint32_t lo, int floats) { return wg::desc_of(lo + floats / 4); };

  for (int t = 0; t < n_t; ++t) {
    const int c0 = (j_lo + t) * BK;
    // s = q k^T and dp = do v^T over the warpgroup's columns, 3xTF32 a
    // k-step, a commit group each
    uint32_t ql = q_lo;  // opaque, so the k-steps' descriptors are not hoisted
    wg::reg_fence(ql);
    // both pieces before the products: a wait between them, inside the
    // products' flight, made ptxas serialise the wgmma (C7511: PERF.md §6)
    float* kp = piece(t, wgi);
    float* vp = piece(t, 2 + wgi);
    wg::fence();
    {
      const uint32_t b_lo = wg::desc_lo(kp);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int qk = qk0 + kk;
        const uint64_t ab_ = at(ql, kstep(qk, BQ)), bb = at(b_lo, kstep(kk, BK)),
                       bs = at(b_lo, PART + kstep(kk, BK));
        wg::mma_ss<BK>(sc, at(ql, 2 * BQ * HD + kstep(qk, BQ)), bb, kk > 0);
        wg::mma_ss<BK>(sc, ab_, bs, 1);
        wg::mma_ss<BK>(sc, ab_, bb, 1);
      }
      wg::commit();
    }
    {
      const uint32_t b_lo = wg::desc_lo(vp);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int qk = qk0 + kk;
        const uint64_t ab_ = at(ql, BQ * HD + kstep(qk, BQ)), bb = at(b_lo, kstep(kk, BK)),
                       bs = at(b_lo, PART + kstep(kk, BK));
        wg::mma_ss<BK>(dp, at(ql, 3 * BQ * HD + kstep(qk, BQ)), bb, kk > 0);
        wg::mma_ss<BK>(dp, ab_, bs, 1);
        wg::mma_ss<BK>(dp, ab_, bb, 1);
      }
      wg::commit();
    }
    wg::wait<0>();
    reg_fence_all(sc);
    reg_fence_all(dp);
    // the exchange: the partial s and dp into the warpgroup's k piece; once
    // both are there, s = s0 + s1 and dp = dp0 + dp1 from the other's, whose
    // piece is then released
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
      kp[x * 128 + tid] = sc[x];
      kp[BQ * BK + x * 128 + tid] = dp[x];
    }
    release(t, 2 + wgi);
    wg::proxy_fence();
    wg::named_sync(kHalfXSync, kWgConsumers);
    const float* theirs = Ring + slot(t, wgi ^ 1) * 2 * PART;
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
      sc[x] += theirs[x * 128 + tid];
      dp[x] += theirs[BQ * BK + x * 128 + tid];
    }
    release(t, wgi ^ 1);

    // ds = p (dp - delta), p = exp(scale s - lse) where the mask allows;
    // sc[4n + e] is (row g + 8 (e / 2), key 8n + 2 t4 + e % 2) of the warp's strip
    const bool masked = tile_masked(q0 + wr, 16, c0, BK, sh);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, x = 4 * n + e;
        float p = expf(sh.scale * sc[x] - lr[r]);
        if (masked && !allowed(q0 + wr + g + 8 * r, c0 + 8 * n + 2 * t4 + (e & 1), sh)) p = 0.0f;
        sc[x] = p * (dp[x] - dl[r]);
      }

    // dq += ds k over the warpgroup's columns (the k^T piece), the keys as
    // k: the tile's keys summed from 0, added to dq in f32
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) a_of(sc, n, ab[n], as[n]);
    const uint32_t t_lo = wg::desc_lo(piece(t, 4 + wgi));
    wg::fence();
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const uint64_t tb = at(t_lo, kstep(n, HALF)), ts = at(t_lo, PART + kstep(n, HALF));
      wg::mma_rs<HALF>(part, as[n], tb, n > 0);
      wg::mma_rs<HALF>(part, ab[n], ts, 1);
      wg::mma_rs<HALF>(part, ab[n], tb, 1);
    }
    wg::commit();
    wg::wait<0>();
    reg_fence_all(part);
    reg_fence_all(ab);
    reg_fence_all(as);
    release(t, 4 + wgi);
#pragma unroll
    for (int x = 0; x < HALF / 2; ++x) acc[x] += part[x];
  }

  // b and h read again, not held through the tile loop
  const int h = blockIdx.x % sh.H, b = blockIdx.x / sh.H;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = q0 + wr + g + 8 * e2;
    if (row >= sh.Sq) continue;
    T* out = dq + ((static_cast<long long>(b) * sh.Sq + row) * sh.H + h) * HD + HALF * wgi + 2 * t4;
#pragma unroll
    for (int c = 0; c < HALF / 8; ++c) {
      out[8 * c] = from_f32<T>(acc[4 * c + 2 * e2] * sh.scale);
      out[8 * c + 1] = from_f32<T>(acc[4 * c + 2 * e2 + 1] * sh.scale);
    }
  }
}

// --------------------------------------------------------------------------
// B5, kv-parallel pass at hd 128 on wgmma: dk and dv, summed over the G
// query heads of each kv head.  grid (splits*B*K, nk): blockIdx.x = split +
// splits * (batch*kv head), j = blockIdx.y over kHalfRows-key kv tiles, the
// first (the most q tiles) first; both consumer warpgroups own the tile's
// keys (warp w keys 16w..), warpgroup w hd's columns HALF w..  A split walks
// its range of the kv tile's (query head, kHalfTile-row q tile)
// iterations, heads outer; an iteration is eight pieces: q of each
// warpgroup's columns, do's, then do's and q's again, transposed.  With one
// split the block writes dk and dv; with more, its f32 sums (dk scaled) go
// to ws [splits][2][B, Sk, K, hd] for swa_bwd_dkv_merge_kernel.
// --------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
swa_bwd_dkv_wg_half_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo, const T* __restrict__ q,
                           const T* __restrict__ k, const T* __restrict__ v,
                           const T* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ delta, T* __restrict__ dk,
                           T* __restrict__ dv, float* __restrict__ ws, int splits, Shape sh) {
  constexpr int BK = kHalfRows, BQ = kHalfTile, HALF = HD / 2, PART = kHalfPiece;
  constexpr int NS = kHalfDkvStages, PIECES = 8, KV = BK * HD;
  constexpr int KS = HALF / 8;  // a warpgroup's k-steps of s^T and dp^T
  static_assert(HD == kHalfHd && PART == BQ * HALF, "hd 128");
  static_assert(NS % 2 == 0 && NS >= 4 && NS <= 8,
                "an even ring that holds an iteration's q and do pieces; the stats' ring "
                "outlasts it");
  static_assert(2 * BK * BQ <= 2 * PART, "the partial s^T and dp^T fit in a do piece");
  extern __shared__ float smem_raw[];
  float* Ks = aligned_smem(smem_raw);  // [HD / 16][BK][16]: k, its small parts, v, v's
  float* Vs = Ks + 2 * KV;
  float* Ring = Ks + 4 * KV;           // NS pieces x (a part, its small parts)
  float* Stat = Ring + NS * 2 * PART;  // kHalfStats iterations x (lse [BQ], delta [BQ])
  uint64_t* loaded = reinterpret_cast<uint64_t*>(Stat + kHalfStats * 2 * BQ);
  uint64_t* full = loaded + NS;
  uint64_t* empty = full + NS;
  uint64_t* kbar = empty + NS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool tma = std::is_same<T, float>::value && sh.vec;
  // The block's kv head and keys, its q tiles i_lo.. (n_i a head) and its
  // split's iterations [it_lo, it_lo + n_t), derived by each role after its
  // setmaxnreg
  struct Where { int b, kh, k0, i_lo, n_i, it_lo, n_t; };
  auto where = [&]() {
    uint32_t bx = blockIdx.x, j = blockIdx.y;
    wg::reg_fence(bx);
    wg::reg_fence(j);
    Where r;
    const int z = bx % splits, bk = bx / splits;
    r.b = bk / sh.K, r.kh = bk % sh.K, r.k0 = j * BK;
    const int nq = (sh.Sq + BQ - 1) / BQ;
    r.i_lo = r.k0 < sh.prefix ? 0 : r.k0 / BQ;  // the prefix is seen from row 0
    int i_hi = nq - 1;  // the last q tile whose rows see a key of this tile
    if (sh.window > 0) i_hi = min(i_hi, (r.k0 + BK - 1 + sh.window - 1) / BQ);
    // none when Sq < Sk leaves the tile's keys past every causal row
    r.n_i = max(i_hi - r.i_lo + 1, 0);
    const int n_it = sh.G * r.n_i;
    r.it_lo = z * n_it / splits;
    r.n_t = (z + 1) * n_it / splits - r.it_lo;
    return r;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      wg::bar_init(&loaded[s], 1);
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], 4);  // one warpgroup's warps read a piece
    }
    wg::bar_init(kbar, 1);
    wg::bar_init_fence();
  }
  __syncthreads();

  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == kWgConsumers / 128) {
    wg::reg_dealloc<kHalfProducerRegs>();
    const Where wp = where();
    const int n = wp.n_t * PIECES, pt = threadIdx.x - kWgConsumers - 32;
    if (pt < 0) {
      // the loader: k and v, then every piece once the consumers free its
      // slot, each iteration's lse and delta with its first
      if (wp.n_t > 0) {
        expect(kbar, 2 * KV * sizeof(float), tma);
        produce_rows<BK, HD>(Ks, &tk, k, wp.b, wp.k0, sh.Sk, sh.K, wp.kh, kbar, tma);
        produce_rows<BK, HD>(Vs, &tv, v, wp.b, wp.k0, sh.Sk, sh.K, wp.kh, kbar, tma);
        produced(kbar);
      }
      for (int P = 0; P < n; ++P) {
        const int s = P % NS, p = P % PIECES, t = P / PIECES, it = wp.it_lo + t;
        const int h = wp.kh * sh.G + it / wp.n_i, q0 = (wp.i_lo + it % wp.n_i) * BQ;
        if (P >= NS) wg::bar_wait(&empty[s], ((P / NS) & 1) ^ 1);
        if (p == 0) {  // 0 past Sq
          const long long row_base = (static_cast<long long>(wp.b) * sh.H + h) * sh.Sq;
          float* St = Stat + (t % kHalfStats) * 2 * BQ;
          const bool ok = q0 + lane < sh.Sq;
          St[lane] = ok ? lse[row_base + q0 + lane] : 0.0f;
          St[BQ + lane] = ok ? delta[row_base + q0 + lane] : 0.0f;
        }
        float* dst = Ring + s * 2 * PART;
        const bool is_do = p >= 2 && p < 6;
        expect(&loaded[s], PART * sizeof(float), tma);
        // q (pieces 0, 1) and do (2, 3) into the first part, do (4, 5) and
        // q (6, 7) to transpose into the second
        produce_rows<BQ, HD, HALF>(dst + (p >= 4 ? PART : 0), is_do ? &tdo : &tq,
                                   is_do ? dout : q, wp.b, q0, sh.Sq, sh.H, h, &loaded[s], tma,
                                   HALF * (p & 1));
        produced(&loaded[s]);
      }
      return;
    }
    half_derive<NS, PIECES>(Ring, loaded, full, n, pt);
    return;
  }

  // the consumers: warpgroup wgi (columns HALF wgi..), its warp w (keys
  // 16w..), lane (g, t4)
  wg::reg_alloc<kHalfConsumerRegs>();
  const Where wh = where();
  const int k0 = wh.k0, i_lo = wh.i_lo, n_i = wh.n_i, it_lo = wh.it_lo, n_t = wh.n_t;
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // uniform to ptxas
  const int w = warp & 3, g = lane >> 2, t4 = lane & 3, tid = threadIdx.x & 127;
  const int wk = 16 * w;
  const int kc0 = KS * wgi;  // the warpgroup's first k-step of s^T and dp^T, in k's columns
  if (n_t > 0) {
    // k and v are the A operands of every iteration: the small parts of the
    // warpgroup's columns, once
    wg::bar_wait(kbar, 0);
    const int at = kc0 * 8 * BK;
    small_tile(Ks + KV + at, Ks + at, HALF * BK, tid, 128);
    small_tile(Vs + KV + at, Vs + at, HALF * BK, tid, 128);
    wg::proxy_fence();
    wg::named_sync(kHalfGroupSync + wgi, 128);
  }

  float dka[HALF / 2], dva[HALF / 2];
#pragma unroll
  for (int x = 0; x < HALF / 2; ++x) dka[x] = dva[x] = 0.0f;
  float st[BQ / 2], dpt[BQ / 2], part[HALF / 2];
  uint32_t ab[BQ / 8][4], as[BQ / 8][4];  // p^T or ds^T, A fragments

  auto slot = [&](int t, int p) { return (t * PIECES + p) % NS; };
  auto piece = [&](int t, int p) -> float* {  // once derived
    wg::bar_wait(&full[slot(t, p)], ((t * PIECES + p) / NS) & 1);
    return Ring + slot(t, p) * 2 * PART;
  };
  auto release = [&](int t, int p) {  // the warp has read it
    __syncwarp();
    if (lane == 0) wg::bar_arrive(&empty[slot(t, p)]);
  };
  const uint32_t k_lo = wg::desc_lo(Ks);
  auto at = [](uint32_t lo, int floats) { return wg::desc_of(lo + floats / 4); };

  for (int t = 0; t < n_t; ++t) {
    const int q0 = (i_lo + (it_lo + t) % n_i) * BQ;
    // s^T = k q^T and dp^T = v do^T over the warpgroup's columns, 3xTF32 a
    // k-step, a commit group each
    uint32_t kl = k_lo;  // opaque, so the k-steps' descriptors are not hoisted
    wg::reg_fence(kl);
    // both pieces before the products, and nothing between them and their
    // wait: a wait or a release inside the products' flight made ptxas
    // serialise the wgmma (C7511: PERF.md §6)
    float* qp = piece(t, wgi);
    float* op = piece(t, 2 + wgi);
    wg::fence();
    {
      const uint32_t b_lo = wg::desc_lo(qp);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int kc = kc0 + kk;
        const uint64_t kb = at(kl, kstep(kc, BK)), ks = at(kl, KV + kstep(kc, BK)),
                       bb = at(b_lo, kstep(kk, BQ)), bs = at(b_lo, PART + kstep(kk, BQ));
        wg::mma_ss<BQ>(st, ks, bb, kk > 0);
        wg::mma_ss<BQ>(st, kb, bs, 1);
        wg::mma_ss<BQ>(st, kb, bb, 1);
      }
      wg::commit();
    }
    {
      const uint32_t b_lo = wg::desc_lo(op);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int kc = kc0 + kk;
        const uint64_t vb = at(kl, 2 * KV + kstep(kc, BK)), vs = at(kl, 3 * KV + kstep(kc, BK)),
                       bb = at(b_lo, kstep(kk, BQ)), bs = at(b_lo, PART + kstep(kk, BQ));
        wg::mma_ss<BQ>(dpt, vs, bb, kk > 0);
        wg::mma_ss<BQ>(dpt, vb, bs, 1);
        wg::mma_ss<BQ>(dpt, vb, bb, 1);
      }
      wg::commit();
    }
    wg::wait<0>();
    reg_fence_all(st);
    reg_fence_all(dpt);
    release(t, wgi);  // the q piece
    // the exchange: the partial s^T and dp^T into the warpgroup's do piece;
    // once both are there, the sums from the other's, whose piece is then
    // released
#pragma unroll
    for (int x = 0; x < BQ / 2; ++x) {
      op[x * 128 + tid] = st[x];
      op[BK * BQ + x * 128 + tid] = dpt[x];
    }
    wg::proxy_fence();
    wg::named_sync(kHalfXSync, kWgConsumers);
    const float* theirs = Ring + slot(t, 2 + (wgi ^ 1)) * 2 * PART;
#pragma unroll
    for (int x = 0; x < BQ / 2; ++x) {
      st[x] += theirs[x * 128 + tid];
      dpt[x] += theirs[BK * BQ + x * 128 + tid];
    }
    release(t, 2 + (wgi ^ 1));

    // p^T = exp(scale s^T - lse) where the mask allows, ds^T = p^T (dp^T -
    // delta); st[4n + e] is (key g + 8 (e / 2), row 8n + 2 t4 + e % 2) of
    // the warp's strip
    const float* Ls = Stat + (t % kHalfStats) * 2 * BQ;
    const float* Ds = Ls + BQ;
    const bool masked = tile_masked(q0, BQ, k0 + wk, 16, sh);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * n + e, row = 8 * n + 2 * t4 + (e & 1);
        float p = expf(sh.scale * st[x] - Ls[row]);
        if (masked && !allowed(q0 + row, k0 + wk + g + 8 * (e >> 1), sh)) p = 0.0f;
        st[x] = p;
        dpt[x] = p * (dpt[x] - Ds[row]);
      }

    // dv += p^T do (the do^T piece), then dk += ds^T q (the q^T piece), the
    // rows as k: each iteration's rows summed from 0, added in f32
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        if (pass == 0) a_of(st, n, ab[n], as[n]);
        else a_of(dpt, n, ab[n], as[n]);
      }
      const uint32_t t_lo = wg::desc_lo(piece(t, 4 + 2 * pass + wgi));
      wg::fence();
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const uint64_t tb = at(t_lo, kstep(n, HALF)), ts = at(t_lo, PART + kstep(n, HALF));
        wg::mma_rs<HALF>(part, as[n], tb, n > 0);
        wg::mma_rs<HALF>(part, ab[n], ts, 1);
        wg::mma_rs<HALF>(part, ab[n], tb, 1);
      }
      wg::commit();
      wg::wait<0>();
      reg_fence_all(part);
      reg_fence_all(ab);
      reg_fence_all(as);
      release(t, 4 + 2 * pass + wgi);
#pragma unroll
      for (int x = 0; x < HALF / 2; ++x) {
        if (pass == 0) dva[x] += part[x];
        else dka[x] += part[x];
      }
    }
  }

  // the block's keys: dk and dv in T, or this split's f32 sums into ws (b
  // and kh read again, not held through the loop)
  const int bk = blockIdx.x / splits, z = blockIdx.x % splits;
  const int b = bk / sh.K, kh = bk % sh.K;
  const long long n_out = static_cast<long long>(sh.B) * sh.Sk * sh.K * HD;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int key = k0 + wk + g + 8 * e2;
    if (key >= sh.Sk) continue;
    const long long off =
        ((static_cast<long long>(b) * sh.Sk + key) * sh.K + kh) * HD + HALF * wgi + 2 * t4;
    if (ws != nullptr) {
      float* wp = ws + 2 * n_out * z + off;
#pragma unroll
      for (int c = 0; c < HALF / 8; ++c) {
        *reinterpret_cast<float2*>(wp + 8 * c) = make_float2(
            dka[4 * c + 2 * e2] * sh.scale, dka[4 * c + 2 * e2 + 1] * sh.scale);
        *reinterpret_cast<float2*>(wp + n_out + 8 * c) =
            make_float2(dva[4 * c + 2 * e2], dva[4 * c + 2 * e2 + 1]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < HALF / 8; ++c)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          dk[off + 8 * c + e1] = from_f32<T>(dka[4 * c + 2 * e2 + e1] * sh.scale);
          dv[off + 8 * c + e1] = from_f32<T>(dva[4 * c + 2 * e2 + e1]);
        }
    }
  }
}

// --------------------------------------------------------------------------
// B5 at hd 256, q-parallel pass: dq and delta, as swa_bwd_dq_kernel
// computes them, in blocks of 8 warps (the note at the top).  grid (B*H,
// nq) over 32-row q tiles, i = nq - 1 - blockIdx.y, walking 32-key kv
// tiles.  Per kv tile: warp w computes its part of s = (scale q) k^T (w <
// 4) or dp = do v^T (w >= 4), all 32 rows x keys 16((w / 2) % 2).. over
// dims 128(w % 2)..; the two halves of hd are added through shared memory,
// ds = p (dp - delta) is staged as TF32 parts, and warp w adds ds k to dq's
// columns 32w..32w+31.
// --------------------------------------------------------------------------
template <int HD> constexpr int wide_dq_floats() {
  return (2 * kWideDqRows + 4 * kWideDqKeys) * (HD + 4) + 8 * kWideDqRows * (kWideDqKeys / 2) +
         2 * kWideDqRows * (kWideDqKeys + 8) + 2 * kWideDqRows;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
swa_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ o,
                       const T* __restrict__ dout, const float* __restrict__ lse,
                       float* __restrict__ delta, T* __restrict__ dq, Shape sh) {
  constexpr int NTH = kWideThreads, LD = HD + 4, BQ = kWideDqRows, BK = kWideDqKeys;
  constexpr int LDP = BK / 2, LDS = BK + 8, WC = HD / 8;  // WC: a warp's columns of dq
  static_assert(BQ == 32 && BK == 32 && WC == 32 && NTH == 8 * BQ,
                "the partition below: 2 row strips, 4 column tiles a warp, 4 values a thread");
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][LD]
  float* dOs = Qs + BQ * LD;         // [BQ][LD]
  float* KVs = dOs + BQ * LD;        // 2 stages x (k [BK][LD], v [BK][LD])
  float* Part = KVs + 4 * BK * LD;   // 8 warps x [BQ][LDP]: their parts of s and dp
  float* DSb = Part + 8 * BQ * LDP;  // [BQ][LDS] ds, its TF32 big parts ...
  float* DSs = DSb + BQ * LDS;       // ... and small parts
  float* Rs = DSs + BQ * LDS;        // lse [BQ], delta [BQ]

  const int i = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / sh.H, h = blockIdx.x % sh.H, kh = h / sh.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = i * BQ;
  const long long row_base = (static_cast<long long>(b) * sh.H + h) * sh.Sq;
  int j_lo = 0;
  if (sh.window > 0) j_lo = max(0, q0 - sh.window + 1) / BK;
  const int j_hi = last_kv_tile(q0 + BQ - 1, BK, sh);

  auto stage_kv = [&](int j, int stage) {
    float* Ks = KVs + stage * 2 * BK * LD;
    stage_rows<BK, HD, LD, NTH>(Ks, k, b, j * BK, sh.Sk, sh.K, kh, sh);
    stage_rows<BK, HD, LD, NTH>(Ks + BK * LD, v, b, j * BK, sh.Sk, sh.K, kh, sh);
  };
  stage_rows<BQ, HD, LD, NTH>(Qs, q, b, q0, sh.Sq, sh.H, h, sh);
  stage_rows<BQ, HD, LD, NTH>(dOs, dout, b, q0, sh.Sq, sh.H, h, sh);
  if (j_lo <= j_hi) stage_kv(j_lo, 0);
  tf32::cp_async_commit();

  // delta of rows 4w..4w+3, read from o and do in device memory while the
  // copies fly, in the 4-warp kernel's order; lse beside it
  for (int r = 4 * warp; r < 4 * warp + 4; ++r) {
    const int row = q0 + r;
    float part = 0.0f;
    if (row < sh.Sq) {
      const long long off = ((static_cast<long long>(b) * sh.Sq + row) * sh.H + h) * HD;
      for (int d = lane; d < HD; d += 32) part += to_f32(o[off + d]) * to_f32(dout[off + d]);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) part += __shfl_xor_sync(0xffffffffu, part, m);
    if (lane == 0) {
      if (row < sh.Sq) delta[row_base + row] = part;
      Rs[r] = row < sh.Sq ? lse[row_base + row] : 0.0f;
      Rs[BQ + r] = part;
    }
  }

  // the warp's part of s (prod 0) or dp (prod 1): keys 16kc.., dims 128kd..
  const int prod = warp >> 2, kc = (warp >> 1) & 1, kd = warp & 1;
  const float* As = prod == 0 ? Qs : dOs;
  const float amult = prod == 0 ? sh.scale : 1.0f;
  const int col0 = WC * warp;  // the warp's columns of dq

  float acc[2][4][4];  // dq: row strip, column tile, C fragment
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int stage = (j - j_lo) & 1;
    tf32::cp_async_wait<0>();
    __syncthreads();  // the tile has landed; every warp is done with the last one
    if (j < j_hi) {
      stage_kv(j + 1, stage ^ 1);
      tf32::cp_async_commit();
    }
    const float* Ks = KVs + stage * 2 * BK * LD;
    const float* Bs = prod == 0 ? Ks : Ks + BK * LD;

    float c[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[m][n][e] = 0.0f;
#pragma unroll
    for (int st = 0; st < HD / 16; ++st) {
      const int kk = kd * (HD / 2) + 8 * st;
      uint32_t ab[2][4], as[2][4], bb[2][2], bs[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) tf32::load_a(As, LD, 16 * m, kk, amult, ab[m], as[m]);
#pragma unroll
      for (int n = 0; n < 2; ++n) tf32::load_b(Bs, LD, 16 * kc + 8 * n, kk, 1.0f, bb[n], bs[n]);
      mma3_terms(c, ab, as, bb, bs);
    }
    float* P = Part + warp * BQ * LDP;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float* at = P + (16 * m + g) * LDP + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(at) = make_float2(c[m][n][0], c[m][n][1]);
        *reinterpret_cast<float2*>(at + 8 * LDP) = make_float2(c[m][n][2], c[m][n][3]);
      }
    __syncthreads();

    // ds = p (dp - delta), p = exp(s - lse) where the mask allows: thread
    // (r, c4) takes row r = tid / 8 and keys c4 = 4 (tid % 8)..+3, adding
    // the halves of hd (warps (prod, kc, 0) and (prod, kc, 1)) in order
    {
      const int r = threadIdx.x >> 3, c4 = 4 * (threadIdx.x & 7);
      const float* S0 = Part + 2 * (c4 >> 4) * BQ * LDP + r * LDP + (c4 & 15);
      const float4 s0 = *reinterpret_cast<const float4*>(S0);
      const float4 s1 = *reinterpret_cast<const float4*>(S0 + BQ * LDP);
      const float4 d0 = *reinterpret_cast<const float4*>(S0 + 4 * BQ * LDP);
      const float4 d1 = *reinterpret_cast<const float4*>(S0 + 5 * BQ * LDP);
      const float sv[4] = {s0.x + s1.x, s0.y + s1.y, s0.z + s1.z, s0.w + s1.w};
      const float dpv[4] = {d0.x + d1.x, d0.y + d1.y, d0.z + d1.z, d0.w + d1.w};
      const bool masked = tile_masked(q0, BQ, j * BK, BK, sh);
      const float lr = Rs[r], dl = Rs[BQ + r];
      float big[4], small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(sv[e] - lr);
        if (masked && !allowed(q0 + r, j * BK + c4 + e, sh)) p = 0.0f;
        uint32_t bg, sm;
        tf32::split(p * (dpv[e] - dl), bg, sm);
        big[e] = __uint_as_float(bg);
        small[e] = __uint_as_float(sm);
      }
      *reinterpret_cast<float4*>(DSb + r * LDS + c4) = make_float4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<float4*>(DSs + r * LDS + c4) =
          make_float4(small[0], small[1], small[2], small[3]);
    }
    __syncthreads();

    // dq += ds k on the warp's columns, the keys as k in load_b_kperm's
    // order (slot t: key 2t, t + 4: key 2t + 1): the tile's keys are summed
    // on the tensor cores from 0 and added to dq in f32
    uint32_t db[4][2][4], dsm[4][2][4];  // 8-key step, row strip, A fragment
#pragma unroll
    for (int st = 0; st < 4; ++st)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int at = (16 * m + g) * LDS + 8 * st + 2 * t;
        load_a_staged(DSb + at, LDS, db[st][m]);
        load_a_staged(DSs + at, LDS, dsm[st][m]);
      }
#pragma unroll
    for (int n0 = 0; n0 < 4; n0 += 2) {  // two column tiles at a time: four sums
      uint32_t kb[4][2][2], ksm[4][2][2];  // 8-key step, column tile n0 + nn
#pragma unroll
      for (int st = 0; st < 4; ++st)
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
          tf32::load_b_kperm(Ks, LD, 8 * st, col0 + 8 * (n0 + nn), 1.0f, kb[st][nn], ksm[st][nn]);
      float pd[2][2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) pd[m][nn][e] = 0.0f;
#pragma unroll
      for (int st = 0; st < 4; ++st) mma3_terms(pd, db[st], dsm[st], kb[st], ksm[st]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n0 + nn][e] += pd[m][nn][e];
    }
  }
  tf32::cp_async_wait<0>();  // nothing in flight at exit (no kv tile: q and do only)

#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = q0 + 16 * m + g + 8 * e2;
      if (row >= sh.Sq) continue;
      T* out = dq + ((static_cast<long long>(b) * sh.Sq + row) * sh.H + h) * HD + col0 + 2 * t;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        out[8 * n] = from_f32<T>(acc[m][n][2 * e2] * sh.scale);
        out[8 * n + 1] = from_f32<T>(acc[m][n][2 * e2 + 1] * sh.scale);
      }
    }
}

// --------------------------------------------------------------------------
// B5 at hd 256, kv-parallel pass: dk and dv, as swa_bwd_dkv_kernel computes
// them, in blocks of 8 warps (the note at the top).  grid (splits*B*K, nk):
// blockIdx.x = split + splits * (batch*kv head), j = blockIdx.y over 32-key
// kv tiles, the first (the most q tiles) first.  A split walks its range of
// the kv tile's (query head, 16-row q tile) iterations.  Per q tile: warp w
// computes its part of s^T = k (scale q)^T (w < 4) or dp^T = v do^T (w >=
// 4), all 32 keys x 16 rows over dims 64(w % 4)..; the four parts are added
// through shared memory in order, p^T and ds^T are staged as TF32 parts,
// and warp w adds p^T do to dv and ds^T (scale q) to dk on columns
// 32w..32w+31.  With one split the block writes dk and dv; with more, its
// f32 sums go to ws [splits][2][B, Sk, K, hd] for swa_bwd_dkv_merge_kernel.
// --------------------------------------------------------------------------
template <int HD> constexpr int wide_dkv_floats() {
  return (4 * kWideDkvKeys + 4 * kWideDkvRows) * (HD + 4) + 4 * kWideDkvRows +
         8 * kWideDkvKeys * kWideDkvRows + 4 * kWideDkvKeys * (kWideDkvRows + 8);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
swa_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ ws,
                        int splits, Shape sh) {
  constexpr int NTH = kWideThreads, LD = HD + 4, BK = kWideDkvKeys, BQ = kWideDkvRows;
  constexpr int LDP = BQ, LDS = BQ + 8, WC = HD / 8;  // WC: a warp's columns of dk and dv
  static_assert(BK == 32 && BQ == 16 && WC == 32 && NTH == 8 * BK,
                "the partition below: 2 key strips, 4 column tiles a warp, 2 values a thread");
  extern __shared__ float smem[];
  float* Kb = smem;                  // [BK][LD] k, then its TF32 big parts
  float* Vb = Kb + BK * LD;          // [BK][LD] v, then its big parts
  float* Kl = Vb + BK * LD;          // [BK][LD] small parts of k
  float* Vl = Kl + BK * LD;          // [BK][LD] small parts of v
  float* QDs = Vl + BK * LD;         // 2 stages x (q [BQ][LD], do [BQ][LD])
  float* Stat = QDs + 4 * BQ * LD;   // 2 stages x (lse [BQ], delta [BQ])
  float* Part = Stat + 4 * BQ;       // 8 warps x [BK][LDP]: their parts of s^T and dp^T
  float* Pb = Part + 8 * BK * LDP;   // [BK][LDS] p^T's TF32 big parts,
  float* Ps = Pb + BK * LDS;         //   its small parts,
  float* Db = Ps + BK * LDS;         //   ds^T's big parts,
  float* Dl = Db + BK * LDS;         //   its small parts

  const int z = blockIdx.x % splits, bk = blockIdx.x / splits;
  const int b = bk / sh.K, kh = bk % sh.K, j = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = j * BK;
  const int nq = (sh.Sq + BQ - 1) / BQ;
  const int i_lo = k0 < sh.prefix ? 0 : k0 / BQ;  // the prefix is seen from row 0
  int i_hi = nq - 1;  // the last q tile whose rows see a key of this tile
  if (sh.window > 0) i_hi = min(i_hi, (k0 + BK - 1 + sh.window - 1) / BQ);
  // none when Sq < Sk leaves the tile's keys past every causal row
  const int n_i = max(i_hi - i_lo + 1, 0), n_it = sh.G * n_i;
  const int it_lo = z * n_it / splits, it_hi = (z + 1) * n_it / splits;  // this split's

  auto stage_q = [&](int it, int stage) {
    const int h = kh * sh.G + it / n_i, q0 = (i_lo + it % n_i) * BQ;
    float* Qs = QDs + stage * 2 * BQ * LD;
    stage_rows<BQ, HD, LD, NTH>(Qs, q, b, q0, sh.Sq, sh.H, h, sh);
    stage_rows<BQ, HD, LD, NTH>(Qs + BQ * LD, dout, b, q0, sh.Sq, sh.H, h, sh);
    const long long row_base = (static_cast<long long>(b) * sh.H + h) * sh.Sq;
    stage_stat<NTH>(Stat + stage * 2 * BQ, lse + row_base, q0, BQ, sh);
    stage_stat<NTH>(Stat + stage * 2 * BQ + BQ, delta + row_base, q0, BQ, sh);
  };
  if (it_lo < it_hi) {
    stage_rows<BK, HD, LD, NTH>(Kb, k, b, k0, sh.Sk, sh.K, kh, sh);
    stage_rows<BK, HD, LD, NTH>(Vb, v, b, k0, sh.Sk, sh.K, kh, sh);
    stage_q(it_lo, 0);
    tf32::cp_async_commit();
    // k and v are the A operands of every q tile: split them once
    tf32::cp_async_wait<0>();
    __syncthreads();
    tf32::split_tile(Kb, Kl, BK * LD, 1.0f);
    tf32::split_tile(Vb, Vl, BK * LD, 1.0f);
  }

  // the warp's part of s^T (prod 0) or dp^T (prod 1): dims 64kq..
  const int prod = warp >> 2, kq = warp & 3;
  const float* Ab = prod == 0 ? Kb : Vb;
  const float* Al = prod == 0 ? Kl : Vl;
  const float bmult = prod == 0 ? sh.scale : 1.0f;
  const int col0 = WC * warp;  // the warp's columns of dk and dv

  float dka[2][4][4], dva[2][4][4];  // key strip, column tile, C fragment
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[m][n][e] = dva[m][n][e] = 0.0f;

  for (int it = it_lo; it < it_hi; ++it) {
    const int stage = (it - it_lo) & 1;
    tf32::cp_async_wait<0>();
    __syncthreads();  // the tile has landed; every warp is done with the last one
    if (it + 1 < it_hi) {
      stage_q(it + 1, stage ^ 1);
      tf32::cp_async_commit();
    }
    const int q0 = (i_lo + it % n_i) * BQ;
    const float* Qs = QDs + stage * 2 * BQ * LD;
    const float* dOs = Qs + BQ * LD;
    const float* Ls = Stat + stage * 2 * BQ;
    const float* Ds = Ls + BQ;
    const float* Bt = prod == 0 ? Qs : dOs;

    float c[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[m][n][e] = 0.0f;
#pragma unroll
    for (int st = 0; st < HD / 32; ++st) {
      const int kk = kq * (HD / 4) + 8 * st;
      uint32_t ab[2][4], as[2][4], bb[2][2], bs[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) tf32::load_a_split(Ab, Al, LD, 16 * m, kk, ab[m], as[m]);
#pragma unroll
      for (int n = 0; n < 2; ++n) tf32::load_b(Bt, LD, 8 * n, kk, bmult, bb[n], bs[n]);
      mma3_terms(c, ab, as, bb, bs);
    }
    float* P = Part + warp * BK * LDP;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float* at = P + (16 * m + g) * LDP + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(at) = make_float2(c[m][n][0], c[m][n][1]);
        *reinterpret_cast<float2*>(at + 8 * LDP) = make_float2(c[m][n][2], c[m][n][3]);
      }
    __syncthreads();

    // p^T = exp(s^T - lse) where the mask allows, ds^T = p^T (dp^T - delta):
    // thread (key, r2) takes key tid / 8 and rows r2 = 2 (tid % 8), +1,
    // adding the quarters of hd (warps (prod, 0..3)) in order
    {
      const int key = threadIdx.x >> 3, r2 = 2 * (threadIdx.x & 7);
      const float* S0 = Part + key * LDP + r2;
      float2 s = *reinterpret_cast<const float2*>(S0);
      float2 dp = *reinterpret_cast<const float2*>(S0 + 4 * BK * LDP);
#pragma unroll
      for (int w = 1; w < 4; ++w) {
        const float2 a = *reinterpret_cast<const float2*>(S0 + w * BK * LDP);
        const float2 d = *reinterpret_cast<const float2*>(S0 + (4 + w) * BK * LDP);
        s.x += a.x;
        s.y += a.y;
        dp.x += d.x;
        dp.y += d.y;
      }
      const bool masked = tile_masked(q0, BQ, k0, BK, sh);
      const float sv[2] = {s.x, s.y}, dpv[2] = {dp.x, dp.y};
      float pbig[2], psmall[2], dbig[2], dsmall[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r2 + e;  // query, in the tile
        float p = expf(sv[e] - Ls[row]);
        if (masked && !allowed(q0 + row, k0 + key, sh)) p = 0.0f;
        uint32_t bg, sm;
        tf32::split(p, bg, sm);
        pbig[e] = __uint_as_float(bg);
        psmall[e] = __uint_as_float(sm);
        tf32::split(p * (dpv[e] - Ds[row]), bg, sm);
        dbig[e] = __uint_as_float(bg);
        dsmall[e] = __uint_as_float(sm);
      }
      const int at = key * LDS + r2;
      *reinterpret_cast<float2*>(Pb + at) = make_float2(pbig[0], pbig[1]);
      *reinterpret_cast<float2*>(Ps + at) = make_float2(psmall[0], psmall[1]);
      *reinterpret_cast<float2*>(Db + at) = make_float2(dbig[0], dbig[1]);
      *reinterpret_cast<float2*>(Dl + at) = make_float2(dsmall[0], dsmall[1]);
    }
    __syncthreads();

    // dv += p^T do, dk += ds^T (scale q) on the warp's columns, the rows as
    // k in load_b_kperm's order: the tile's 16 rows are summed on the tensor
    // cores from 0 and added to dk and dv in f32
    uint32_t pa[2][2][4], pas[2][2][4], da[2][2][4], das[2][2][4];  // 8-row step, key strip
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int at = (16 * m + g) * LDS + 8 * st + 2 * t;
        load_a_staged(Pb + at, LDS, pa[st][m]);
        load_a_staged(Ps + at, LDS, pas[st][m]);
        load_a_staged(Db + at, LDS, da[st][m]);
        load_a_staged(Dl + at, LDS, das[st][m]);
      }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      uint32_t ob[2][1][2], os[2][1][2], qb[2][1][2], qs[2][1][2];  // 8-row step
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        tf32::load_b_kperm(dOs, LD, 8 * st, col0 + 8 * n, 1.0f, ob[st][0], os[st][0]);
        tf32::load_b_kperm(Qs, LD, 8 * st, col0 + 8 * n, sh.scale, qb[st][0], qs[st][0]);
      }
      float pv[2][1][4], pk[2][1][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[m][0][e] = pk[m][0][e] = 0.0f;
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        mma3_terms(pv, pa[st], pas[st], ob[st], os[st]);
        mma3_terms(pk, da[st], das[st], qb[st], qs[st]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dva[m][n][e] += pv[m][0][e];
          dka[m][n][e] += pk[m][0][e];
        }
    }
  }

  // the block's keys: dk and dv in T, or this split's f32 sums into ws
  const long long n_out = static_cast<long long>(sh.B) * sh.Sk * sh.K * HD;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int key = k0 + 16 * m + g + 8 * e2;
      if (key >= sh.Sk) continue;
      const long long off =
          ((static_cast<long long>(b) * sh.Sk + key) * sh.K + kh) * HD + col0 + 2 * t;
      if (ws != nullptr) {
        float* wk = ws + 2 * n_out * z + off;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          *reinterpret_cast<float2*>(wk + 8 * n) =
              make_float2(dka[m][n][2 * e2], dka[m][n][2 * e2 + 1]);
          *reinterpret_cast<float2*>(wk + n_out + 8 * n) =
              make_float2(dva[m][n][2 * e2], dva[m][n][2 * e2 + 1]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            dk[off + 8 * n + e1] = from_f32<T>(dka[m][n][2 * e2 + e1]);
            dv[off + 8 * n + e1] = from_f32<T>(dva[m][n][2 * e2 + e1]);
          }
      }
    }
}

// dk and dv (n values each) from the splits' f32 sums in ws [splits][2][n],
// added in split order.
template <typename T>
__global__ void __launch_bounds__(256)
swa_bwd_dkv_merge_kernel(const float* __restrict__ ws, T* __restrict__ dk, T* __restrict__ dv,
                         long long n, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = ws[i], c = ws[n + i];
  for (int z = 1; z < splits; ++z) {
    a += ws[2 * n * z + i];
    c += ws[2 * n * z + n + i];
  }
  dk[i] = from_f32<T>(a);
  dv[i] = from_f32<T>(c);
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

// Dynamic shared memory of each pass's kernel at HD.
template <int HD> constexpr size_t fwd_smem() {
  if constexpr (HD <= kWgMaxHd) return fwd_wg_smem<HD>();
  if constexpr (HD > 128) return fwd_wide_smem<HD>();
  return ((q_rows<HD>() + 2 * kFwdKeys) * (HD + 8) + 2 * kFwdKeys * (HD + 4)) * sizeof(float);
}
template <int HD> constexpr size_t dq_smem() {
  if constexpr (HD <= kWgMaxHd) return dq_wg_smem<HD>();
  if constexpr (HD == kHalfHd) return dq_half_smem<HD>();
  if constexpr (HD > 128) return wide_dq_floats<HD>() * sizeof(float);
  return (2 * q_rows<HD>() + 4 * kDqKeys) * (HD + 4) * sizeof(float);
}
template <int HD> constexpr size_t dkv_smem() {
  if constexpr (HD <= kWgMaxHd) return dkv_wg_smem<HD>();
  if constexpr (HD == kHalfHd) return dkv_half_smem<HD>();
  if constexpr (HD > 128) return wide_dkv_floats<HD>() * sizeof(float);
  // k and v with their split parts, and the q/do ring
  return ((4 * kDkvKeys + 4 * kDkvRows) * (HD + 4) + 4 * kDkvRows) * sizeof(float);
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (no link against libcuda); null where it is missing.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The TMA map of a [B, S, heads, HD] f32 tensor as 3-D (heads * HD, S, B):
// boxes of 16 floats x `rows` rows, 64B-swizzled, rows past S read as 0.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int HD, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(heads) * HD, static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(heads) * HD * sizeof(float),
                                 static_cast<cuuint64_t>(S) * heads * HD * sizeof(float)};
  const cuuint32_t box[3] = {16, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The maps of q, k, v and do for the wgmma kernels: q and do in boxes of
// q_rows rows, k and v of kv_rows; all zero (unused) unless sh.vec and f32.
template <int HD, typename T>
bool wg_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v, const void* dout,
             const Shape& sh, int q_rows, int kv_rows) {
  for (CUtensorMap& x : m) x = CUtensorMap{};
  if (!(std::is_same<T, float>::value && sh.vec)) return true;
  return tensor_map(&m[0], q, sh.B, sh.Sq, sh.H, HD, q_rows) &&
         tensor_map(&m[1], k, sh.B, sh.Sk, sh.K, HD, kv_rows) &&
         tensor_map(&m[2], v, sh.B, sh.Sk, sh.K, HD, kv_rows) &&
         tensor_map(&m[3], dout, sh.B, sh.Sq, sh.H, HD, q_rows);
}

template <int HD, typename T>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, const Shape& sh,
        cudaStream_t stream) {
  const size_t smem = fwd_smem<HD>();
  if constexpr (HD <= kWgMaxHd) {
    CUtensorMap m[4];  // q, k, v (the fourth, do's, is unused)
    if (!wg_maps<HD, T>(m, q, k, v, q, sh, kWgRows, kWgFwdKeys))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = allow_smem(swa_fwd_wg_kernel<HD, T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(sh.B * sh.H, (sh.Sq + kWgRows - 1) / kWgRows);
    swa_fwd_wg_kernel<HD, T><<<grid, kWgThreads, smem, stream>>>(
        m[0], m[1], m[2], static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, sh);
  } else if constexpr (HD > 128) {
    CUtensorMap m[3] = {};  // q, k, v: zero (unused) unless sh.vec and f32
    if (std::is_same<T, float>::value && sh.vec &&
        !(tensor_map(&m[0], q, sh.B, sh.Sq, sh.H, HD, kWideFwdRows) &&
          tensor_map(&m[1], k, sh.B, sh.Sk, sh.K, HD, kWideFwdKeys) &&
          tensor_map(&m[2], v, sh.B, sh.Sk, sh.K, HD, kWideFwdKeys)))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = allow_smem(swa_fwd_wg_wide_kernel<HD, T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(sh.B * sh.H, (sh.Sq + kWideFwdRows - 1) / kWideFwdRows);
    swa_fwd_wg_wide_kernel<HD, T><<<grid, kWgThreads, smem, stream>>>(
        m[0], m[1], m[2], static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, sh);
  } else {
    constexpr int BQ = q_rows<HD>();
    cudaError_t e = allow_smem(swa_fwd_kernel<HD, T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(sh.B * sh.H, (sh.Sq + BQ - 1) / BQ);
    swa_fwd_kernel<HD, T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, sh);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int HD, typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, const Shape& sh, cudaStream_t stream) {
  const size_t smem = dq_smem<HD>();
  if constexpr (HD <= kWgMaxHd) {
    CUtensorMap m[4];
    if (!wg_maps<HD, T>(m, q, k, v, dout, sh, kWgRows, kWgTile))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = allow_smem(swa_bwd_dq_wg_kernel<HD, T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(sh.B * sh.H, (sh.Sq + kWgRows - 1) / kWgRows);
    swa_bwd_dq_wg_kernel<HD, T><<<grid, kWgThreads, smem, stream>>>(
        m[0], m[1], m[2], m[3], static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(o), static_cast<const T*>(dout), lse,
        delta, static_cast<T*>(dq), sh);
  } else if constexpr (HD == kHalfHd) {
    CUtensorMap m[4];
    if (!wg_maps<HD, T>(m, q, k, v, dout, sh, kHalfRows, kHalfTile))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = allow_smem(swa_bwd_dq_wg_half_kernel<HD, T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(sh.B * sh.H, (sh.Sq + kHalfRows - 1) / kHalfRows);
    swa_bwd_dq_wg_half_kernel<HD, T><<<grid, kWgThreads, smem, stream>>>(
        m[0], m[1], m[2], m[3], static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(o), static_cast<const T*>(dout), lse,
        delta, static_cast<T*>(dq), sh);
  } else if constexpr (HD > 128) {
    cudaError_t e = allow_smem(swa_bwd_dq_wide_kernel<HD, T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(sh.B * sh.H, (sh.Sq + kWideDqRows - 1) / kWideDqRows);
    swa_bwd_dq_wide_kernel<HD, T><<<grid, kWideThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), sh);
  } else {
    constexpr int BQ = q_rows<HD>();
    cudaError_t e = allow_smem(swa_bwd_dq_kernel<HD, T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(sh.B * sh.H, (sh.Sq + BQ - 1) / BQ);
    swa_bwd_dq_kernel<HD, T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), sh);
  }
  return static_cast<int>(cudaGetLastError());
}

// hd 128 and 256: the kernel over `splits` ranges of each kv tile's q
// tiles, then (splits > 1) the merge of their sums from ws; below, one
// launch and splits must be 1.
template <int HD, typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, void* dk, void* dv, float* ws, int splits, const Shape& sh,
            cudaStream_t stream) {
  const size_t smem = dkv_smem<HD>();
  if constexpr (HD >= kHalfHd) {
    if (splits < 1 || (splits > 1 && ws == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    float* part = splits > 1 ? ws : nullptr;
    cudaError_t e;
    if constexpr (HD == kHalfHd) {
      CUtensorMap m[4];
      if (!wg_maps<HD, T>(m, q, k, v, dout, sh, kHalfTile, kHalfRows))
        return static_cast<int>(cudaErrorInvalidValue);
      e = allow_smem(swa_bwd_dkv_wg_half_kernel<HD, T>, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      const dim3 grid(splits * sh.B * sh.K, (sh.Sk + kHalfRows - 1) / kHalfRows);
      swa_bwd_dkv_wg_half_kernel<HD, T><<<grid, kWgThreads, smem, stream>>>(
          m[0], m[1], m[2], m[3], static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
          static_cast<T*>(dk), static_cast<T*>(dv), part, splits, sh);
    } else {
      e = allow_smem(swa_bwd_dkv_wide_kernel<HD, T>, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      const dim3 grid(splits * sh.B * sh.K, (sh.Sk + kWideDkvKeys - 1) / kWideDkvKeys);
      swa_bwd_dkv_wide_kernel<HD, T><<<grid, kWideThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
          part, splits, sh);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
    const long long n = static_cast<long long>(sh.B) * sh.Sk * sh.K * HD;
    swa_bwd_dkv_merge_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
        ws, static_cast<T*>(dk), static_cast<T*>(dv), n, splits);
  } else if constexpr (HD <= kWgMaxHd) {
    if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap m[4];
    if (!wg_maps<HD, T>(m, q, k, v, dout, sh, kWgTile, kWgRows))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = allow_smem(swa_bwd_dkv_wg_kernel<HD, T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(sh.B * sh.K, (sh.Sk + kWgRows - 1) / kWgRows);
    swa_bwd_dkv_wg_kernel<HD, T><<<grid, kWgThreads, smem, stream>>>(
        m[0], m[1], m[2], m[3], static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), sh);
  } else {
    if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = allow_smem(swa_bwd_dkv_kernel<HD, T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(sh.B * sh.K, (sh.Sk + kDkvKeys - 1) / kDkvKeys);
    swa_bwd_dkv_kernel<HD, T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sh);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of `kernel` an SM at `smem` bytes of dynamic shared memory (the
// occupancy calculator, no launch), or a negated cudaError_t.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  cudaError_t e = allow_smem(kernel, smem);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// Resident blocks an SM of pass (0 forward, 1 dq, 2 dk/dv) at HD; its
// dynamic shared memory into *smem.
template <int HD, typename T>
int occupancy(int pass, int* smem) {
  constexpr bool wide = HD > 128;
  switch (pass) {
    case 0:
      *smem = static_cast<int>(fwd_smem<HD>());
      if constexpr (HD <= kWgMaxHd) return blocks_per_sm(swa_fwd_wg_kernel<HD, T>, kWgThreads, fwd_smem<HD>());
      else if constexpr (wide) return blocks_per_sm(swa_fwd_wg_wide_kernel<HD, T>, kWgThreads, fwd_smem<HD>());
      else return blocks_per_sm(swa_fwd_kernel<HD, T>, kThreads, fwd_smem<HD>());
    case 1:
      *smem = static_cast<int>(dq_smem<HD>());
      if constexpr (HD <= kWgMaxHd) return blocks_per_sm(swa_bwd_dq_wg_kernel<HD, T>, kWgThreads, dq_smem<HD>());
      else if constexpr (HD == kHalfHd) return blocks_per_sm(swa_bwd_dq_wg_half_kernel<HD, T>, kWgThreads, dq_smem<HD>());
      else if constexpr (wide) return blocks_per_sm(swa_bwd_dq_wide_kernel<HD, T>, kWideThreads, dq_smem<HD>());
      else return blocks_per_sm(swa_bwd_dq_kernel<HD, T>, kThreads, dq_smem<HD>());
    case 2:
      *smem = static_cast<int>(dkv_smem<HD>());
      if constexpr (HD <= kWgMaxHd) return blocks_per_sm(swa_bwd_dkv_wg_kernel<HD, T>, kWgThreads, dkv_smem<HD>());
      else if constexpr (HD == kHalfHd) return blocks_per_sm(swa_bwd_dkv_wg_half_kernel<HD, T>, kWgThreads, dkv_smem<HD>());
      else if constexpr (wide) return blocks_per_sm(swa_bwd_dkv_wide_kernel<HD, T>, kWideThreads, dkv_smem<HD>());
      else return blocks_per_sm(swa_bwd_dkv_kernel<HD, T>, kThreads, dkv_smem<HD>());
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
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

// ws: f32 [splits][2][B, Sk, K, hd], the splits' partial dk and dv; hd 128
// and 256 only (splits >= 1, ws unread at 1); elsewhere splits is 1 and ws
// null.
int swa_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dk, void* dv,
                          float* ws, int splits, int dtype, int B, int Sq, int Sk, int H,
                          int K, int hd, int window, int prefix, float scale, void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0 || K == 0) return 0;
  Shape sh = make_shape(B, Sq, Sk, H, K, window, prefix, scale);
  sh.vec = aligned16({q, k, v, dout});
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SWA_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, ws, splits, sh, st)
}

// The resident blocks an SM of a pass's kernel (0 forward, 1 dq, 2 dk/dv;
// the half kernels at hd 128, the wide kernels at hd 256), and its dynamic shared memory in bytes into
// *smem; a negated cudaError_t on failure.
int swa_attention_occupancy(int pass, int dtype, int hd, int* smem) {
  if ((dtype != 0 && dtype != 1) ||
      (hd != 32 && hd != 64 && hd != 80 && hd != 96 && hd != 128 && hd != 256))
    return -static_cast<int>(cudaErrorInvalidValue);  // not SWA_DISPATCH's positive one
  SWA_DISPATCH(occupancy, pass, smem)
}

}  // extern "C"
