// Softmax attention backward from q, k, v and dO alone, in fp32 at head
// dims up to 256, on the CUDA cores of Hopper, in three launches: each
// row's softmax stats, dk and dv with each key block's part of dq, and dq.
// To D 128 hp_bwd_stats_simt_kernel<kD, ...>, hp_bwd_dkdv_simt_kernel<kD,
// kRows, kBufs> and hp_bwd_dq_sum_kernel, kD 64 or 128 at compile time;
// past it the wide tiles, hp_bwd_stats_wide_simt_kernel<kD> and
// hp_bwd_dkdv_wide_simt_kernel<kD>, kD 192 or 256, with the same sum (a
// head dim in between takes the next with its columns zero-filled). Linked
// into csrc/hp_bwd.cu's library, whose vtx_hp_bwd launches them for float
// at D <= 256 (bf16 and fp16 past 256 stay on that file's loops; bf16 and
// fp16 to 256 are csrc/hp_bwd_tc.cu's).
//
// Replaces three TPU kernels of vision_transformers_torch_xla_tpu/ops/
// flash_attention.py in fp32 (the JAX kernels round nothing there), which
// compute one function over three layouts: _bwd_kernel (K8, :61, call
// :137) on separate (B, H, S, D) q, k, v and dO, _hp_bwd_kernel (K10, :212,
// call :363) on a fused (B, S, 3 H D) qkv buffer and _qkv_bwd_kernel (K12,
// :764, call :825) on a (B, S, 3, H, D) one. Per (b, h):
//   s = (q k^T) scale over the S real keys; m = rowmax s;
//   p = exp(s - m) / sum exp(s - m); dv = p^T dO; dp = dO v^T;
//   delta = rowsum(dp p); ds = p (dp - delta);
//   dq = (ds k) scale; dk = (ds^T q) scale.
// Each of the seven tensors is a base pointer and (batch, head, token)
// element strides with the head dim contiguous, so K10 and K12 read q, k, v
// in place in the qkv buffer and write dq, dk, dv into one such buffer.
//
// What bounds it on an H100: the five products, 10 B H S^2 D FLOPs (38.2
// GFLOP at (B, S, H, D) = (128, 197, 12, 64)): 0.57 ms at the 67 TFLOP/s
// fp32 peak of the CUDA cores, against ~0.27 GB of operands (0.08 ms at
// 3.35 TB/s). With no row stats from a forward, two more products (s and
// dp once more) are the least a blocked design does: 7.
//
// Design: the register tiles of csrc/flash_bwd_simt.cu (K5, K6; shared
// through csrc/simt_tiles.cuh), in three launches, so that no sum crosses
// blocks and nothing needs float atomics (the result is deterministic):
//   1. stats, a block per (b, h, 128-query tile): one sweep over the 64-key
//      tiles of K and V, streamed through cp.async buffers, scoring s and
//      dp together (8 x 4 a thread) and keeping, for each of the thread's
//      rows over its keys, an online max m, sum l = sum exp(s - m) and u =
//      sum exp(s - m) dp (l and u rescaled as the max grows). The 8 lanes
//      of a row, then the row group's two column halves, merge their
//      partials in a fixed order, giving the row's lse = m + log l and
//      delta = u / l (the JAX order's rowsum(dp p), since p = exp(s - m) /
//      l), into a scratch (B, H, S, 2).
//   2. dk, dv and dq's parts, a block per (b, h, kRows-key tile): K5's loop
//      over the query tiles with lse and delta from launch 1 (s and dp, p =
//      exp(s scale - lse) and ds = p (dp - delta) into shared memory, dv +=
//      p^T dO and dk += ds^T q on 8 x 8 tiles), and after them each tile's
//      ds^T k over the block's keys (4 x 4 a thread, 4 x 8 at kD = 128),
//      the part of dq that those keys give, stored into the scratch
//      [key block][B H][S][kD].
//   3. dq = (the parts summed in key-block order) scale, a thread per 4
//      columns of a row.
// At S = 197 a 64-row tile holds 5 real rows: row groups (32 rows) whose
// rows all lie past S skip their work, and warps whose 32 keys (launch 1)
// or queries (launch 2) of a streamed tile all lie past S skip scoring
// them; launch 2 sums 32 queries of such a tile. At kD = 64 the dk/dv
// blocks hold 128 keys and two streamed buffers (8 warps, 213 KB, one block
// an SM), at kD = 128 64 keys and one; the stats blocks 128 queries. The
// scratch holds ceil(S / kRows) parts of dq: 155 MB at the shape above.
// Before this design, launch 1 also formed dq, sweeping the key tiles a
// second time for s and dp: 9 products, 3.11-3.12 ms. Measured on an H100
// 80GB HBM3 at 700 W, device ms of one call at the shape above: 2.46-2.47
// (stats 0.79, dk/dv 1.58-1.60, dq 0.08), 23% of the bound; SDPA's fp32
// backward 2.12, csrc/hp_bwd.cu's loops before this file 5.50 (PERF.md
// §6, tools/time_fp32_hp_bwd_variants.py). ptxas: 212-254 registers, no
// spills.
//
// Head dims 129-256 (the wide tiles): the same seven products and three
// launches. Two 64 x 256 fp32 accumulators are 128 registers a thread at
// 256 threads, and 128 staged rows of q and dO 266 KB, so:
//   1w. stats, a block per (b, h, 64-query tile) of 8 warps, each owning 8
//      whole rows (csrc/attn_fwd_simt.cuh's wide tiles): q and dO staged
//      at pitch kD + 4 (4 mod 32: a quarter-warp's float4 rows hit distinct
//      banks), K and V streamed in tiles of kWideKeys = 32 keys, lane l
//      scoring key l of its warp's 8 rows (rows_dot: 8 broadcast float4 of
//      q or dO against the lane's K or V row), s then dp, the next tile's
//      K landing by cp.async under dp and its V under the next s. Each lane
//      keeps an online (m, l, u) per row over its keys, and the 32 lanes
//      merge them (butterflies) at the end. 200 KB at kD 256.
//   2w. dk, dv and dq's parts, a block per (b, h, 32-key tile) of 8
//      warps, each owning 8 of the keys, warps 0-3 summing dv and 4-7 dk
//      (the dV/dK split of csrc/hp_bwd_tc.cu's wide tiles: 8 x kD / 32 a
//      lane, 64 registers at 256). For each 64-query tile (lane l holding
//      queries l and l + 32): warps 0-3 score s^T against q and store p,
//      warps 4-7 dp^T against dO and, after one barrier, ds = p (dp -
//      delta) (keys_dot: 8 broadcast float4 of K or V against the lane's 2
//      rows); then each warp sums its own keys' dv += p^T dO or dk += ds^T
//      q (keys_sum: p or ds broadcast along the queries, dO or q as float4
//      along the head dim, float2 past 128 at kD 192); the next query tile
//      loads while all 256 threads form dq's part over the block's keys
//      (dq_part_tile, not unrolled: unrolled, it spills at kD 256). One
//      q/dO buffer: 218 KB at kD 256. The dq parts scratch has ceil(S /
//      32) parts (542 MB at (32, 197, 12, 256)).
//
// The wide tiles' helpers (keys_dot, keys_sum, wide_col) and dq's part
// (dq_part_tile) live in csrc/simt_wide.cuh, which csrc/attn_bwd_simt.cu
// (the fp32 K2 past 128) shares.
//
// Plain C++ interface (namespace hp_bwd_simt), called by csrc/hp_bwd.cu's
// vtx_hp_bwd on the caller's stream; returns cudaGetLastError(). The
// kernels allocate nothing: the caller sizes the scratch by
// scratch_floats.

#include "simt_tiles.cuh"
#include "simt_wide.cuh"

namespace {

enum { kQ, kK, kV, kDO, kDQ, kDK, kDV, kTensors };

// (batch, head, token) element strides of q, k, v, dO, dq, dk and dv
struct Views {
  Strides t[kTensors];
};

constexpr float kNegInf = -1e30f;

// Tensor t's rows of head (b, h).
template <typename P>
__device__ __forceinline__ P* head(P* p, const Views& a, int t, int b,
                                   int h) {
  return p + b * a.t[t].sb + h * a.t[t].sh;
}

// (m, l, u) <- the merge of two online partials over disjoint keys: the
// larger max, and l and u rescaled to it. The products are not fused into
// the sums, so merge(x, y) and merge(y, x) are bitwise equal: every lane of
// a butterfly ends with the same partials.
__device__ __forceinline__ void merge(float& m, float& l, float& u, float m2,
                                      float l2, float u2) {
  const float mm = fmaxf(m, m2);
  const float a = exp_p(m - mm), a2 = exp_p(m2 - mm);
  l = __fadd_rn(__fmul_rn(l, a), __fmul_rn(l2, a2));
  u = __fadd_rn(__fmul_rn(u, a), __fmul_rn(u2, a2));
  m = mm;
}

// The widths of the stats launch at compile-time head dim kD: kRows query
// rows, 2 kRows / 32 warps that all score (32 rows and 32 keys of a tile
// each), kBufs streamed buffers of K and V.
template <int kD, int kRows, int kBufs>
struct Stats {
  static constexpr int kGroups = kRows / 32;
  static constexpr int kThr = 64 * kGroups;
  static constexpr int kP = kD + 4;
  // q, dO of the block's rows, the streamed tiles, the second column
  // half's partials
  static constexpr size_t kSmem = (size_t)(2 * kRows * kP +
                                           2 * kBufs * kTile * kP +
                                           3 * kRows) * sizeof(float);
  // two blocks an SM where two fit
  static constexpr int kBlocks = 2 * kSmem <= 227 * 1024 ? 2 : 1;
};

// 1. grid (B * H * n_tiles) over kRows-query tiles: each row's lse and
// delta, into stats (B, H, S, 2). Shared memory: q, dO of the block's
// queries [kRows][kP]; kBufs buffers of a key tile's K, V [64][kP]; the
// second column half's (m, l, u) partials of the block's rows
// [3][kRows].
template <int kD, int kRows, int kBufs>
__global__ void __launch_bounds__(Stats<kD, kRows, kBufs>::kThr,
                                  Stats<kD, kRows, kBufs>::kBlocks)
hp_bwd_stats_simt_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         float* __restrict__ stats, int H, int S, int D,
                         int n_tiles, float scale, Views a, int vec) {
  typedef Stats<kD, kRows, kBufs> G;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kRows * G::kP;
  float* ks = dos + kRows * G::kP;        // buffer u: ks + 2 u kTile kP
  float* part = ks + 2 * kBufs * kTile * G::kP;  // [m, l, u][kRows]
  const int bh = blockIdx.x / n_tiles, b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % n_tiles) * kRows;
  const Place<G::kGroups> at;
  const bool rows_live = q0 + 32 * at.g < S;  // the row group has a real row
  const int lx = threadIdx.x & 7;
  const float* kg = head(k, a, kK, b, h);
  const float* vg = head(v, a, kV, b, h);
  // K and V of the key tile at k0 into buffer u
  auto stream = [&](int u, int k0) {
    float* bk = ks + 2 * u * kTile * G::kP;
    copy_tile<kD, kTile, G::kThr>(bk, kg, a.t[kK].sr, k0, S, D, vec);
    copy_tile<kD, kTile, G::kThr>(bk + kTile * G::kP, vg, a.t[kV].sr, k0, S,
                                  D, vec);
    cp_async_commit();
  };

  copy_tile<kD, kRows, G::kThr>(qs, head(q, a, kQ, b, h), a.t[kQ].sr, q0, S,
                                D, vec);
  copy_tile<kD, kRows, G::kThr>(dos, head(dout, a, kDO, b, h), a.t[kDO].sr,
                                q0, S, D, vec);
  stream(0, 0);
  // for each of the thread's rows, over its keys: the online max m, l =
  // sum exp(s - m) and u = sum exp(s - m) dp (0 for keys >= S), l and u
  // rescaled as m grows
  float mt[8], lt[8], ut[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mt[i] = kNegInf;
    lt[i] = ut[i] = 0.f;
  }
  for (int t = 0, k0 = 0; k0 < S; ++t, k0 += kTile) {
    const int u = kBufs == 2 ? t & 1 : 0;
    const float* bk = ks + 2 * u * kTile * G::kP;  // K, then V
    cp_async_wait<0>();
    __syncthreads();  // the key tile (and q, dO with the first) landed
    // two buffers: the next tile lands in the one every warp has read
    if (kBufs == 2 && k0 + kTile < S) stream(u ^ 1, k0 + kTile);
    // the warp's 32 keys of the tile hold a real one
    if (rows_live && k0 + 32 * at.half < S) {
      float s[8][4], dp[8][4];
      zero(s);
      zero(dp);
      score_tiles<kD>(s, dp, qs, bk, dos, bk + kTile * G::kP, at.r0, at.c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float x[4], mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[j] = k0 + at.c + 8 * j < S ? s[i][j] * scale : kNegInf;
          mx = fmaxf(mx, x[j]);
        }
        const float m_new = fmaxf(mt[i], mx);
        const float alpha = exp_p(mt[i] - m_new);
        float le = 0.f, ue = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = k0 + at.c + 8 * j < S ? exp_p(x[j] - m_new) : 0.f;
          le += e;
          ue = fmaf(e, dp[i][j], ue);
        }
        lt[i] = lt[i] * alpha + le;
        ut[i] = ut[i] * alpha + ue;
        mt[i] = m_new;
      }
    }
    if (kBufs == 1) {
      __syncthreads();  // the tile is read: its buffer takes the next one
      if (k0 + kTile < S) stream(0, k0 + kTile);
    }
  }
  if (!rows_live) return;
  // merged over the row's 8 lanes, then half 0 merges in the row group's
  // second column half: lse = m + log l, delta = u / l
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      merge(mt[i], lt[i], ut[i], __shfl_xor_sync(0xffffffffu, mt[i], off),
            __shfl_xor_sync(0xffffffffu, lt[i], off),
            __shfl_xor_sync(0xffffffffu, ut[i], off));
    if (lx == 0 && at.half) {
      const int r = at.r0 + 4 * i;
      part[r] = mt[i];
      part[kRows + r] = lt[i];
      part[2 * kRows + r] = ut[i];
    }
  }
  pair_sync(at.g);
  if (at.half || lx) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = at.r0 + 4 * i;
    if (q0 + r >= S) continue;
    merge(mt[i], lt[i], ut[i], part[r], part[kRows + r], part[2 * kRows + r]);
    float* st = stats + ((long long)bh * S + q0 + r) * 2;
    st[0] = mt[i] + logf(lt[i]);
    st[1] = ut[i] / lt[i];
  }
}

// 2. grid (B * H * n_tiles) over kRows-key tiles: dk, dv, and each query's
// part of dq from the block's keys (ds^T k, into dq_part [n_tiles][B H][S]
// [kD]). Shared memory: K, V of the block's keys [kRows][kP]; kBufs
// buffers of a query tile's q, dO [64][kP]; p, ds [key][query] [kRows][72];
// lse, delta of each buffered query tile [64].
template <int kD, int kRows, int kBufs>
__global__ void __launch_bounds__(Bwd<kD, kRows, kBufs>::kThr,
                                  Bwd<kD, kRows, kBufs>::kThr == 128 ? 2 : 1)
hp_bwd_dkdv_simt_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ stats,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float* __restrict__ dq_part, int H, int S, int D,
                        int n_tiles, float scale, Views a, int vec) {
  typedef Bwd<kD, kRows, kBufs> G;
  static_assert(G::kThr == 256, "dq_part_tile spreads 64 queries over 256");
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kRows * G::kP;
  float* qs = vs + kRows * G::kP;         // buffer u: qs + 2 u kTile kP
  float* ps = qs + 2 * kBufs * kTile * G::kP;
  float* dss = ps + kRows * kPS;
  float* lse_s = dss + kRows * kPS;       // buffer u: lse_s + 2 u kTile
  const int bh = blockIdx.x / n_tiles, b = bh / H, h = bh % H;
  const int kb = blockIdx.x % n_tiles, k0 = kb * kRows;
  const Place<G::kGroups> at;
  const bool scorer = at.w < 2 * G::kGroups;
  const bool rows_live = k0 + 32 * at.g < S;  // the row group has a real key
  // the block's keys in the row groups that hold a real one
  const int n_live = min(kRows, (S - k0 + 31) / 32 * 32);
  const float* qg = head(q, a, kQ, b, h);
  const float* dog = head(dout, a, kDO, b, h);
  const float* st_g = stats + (long long)bh * S * 2;
  float* part = dq_part +
                ((long long)kb * (gridDim.x / n_tiles) + bh) * S * kD +
                4 * (threadIdx.x & 15);
  // the query tile at q0 into buffer u: q, dO, lse and delta, by cp.async
  auto stream = [&](int u, int q0) {
    float* bq = qs + 2 * u * kTile * G::kP;
    copy_tile<kD, kTile, G::kThr>(bq, qg, a.t[kQ].sr, q0, S, D, vec);
    copy_tile<kD, kTile, G::kThr>(bq + kTile * G::kP, dog, a.t[kDO].sr, q0,
                                  S, D, vec);
    if (threadIdx.x < 2 * kTile) {
      const int t = threadIdx.x % kTile;
      const bool ok = q0 + t < S;
      cp_async<4>(lse_s + 2 * u * kTile + threadIdx.x,
                  ok ? st_g + 2 * (q0 + t) + threadIdx.x / kTile : st_g, ok);
    }
    cp_async_commit();
  };

  copy_tile<kD, kRows, G::kThr>(ks, head(k, a, kK, b, h), a.t[kK].sr, k0, S,
                                D, vec);
  copy_tile<kD, kRows, G::kThr>(vs, head(v, a, kV, b, h), a.t[kV].sr, k0, S,
                                D, vec);
  stream(0, 0);
  float acc[8][8];  // dv (half 0) or dk (half 1) of the block's keys
  zero(acc);

  for (int t = 0, q0 = 0; q0 < S; ++t, q0 += kTile) {
    const int u = kBufs == 2 ? t & 1 : 0;
    const float* bq = qs + 2 * u * kTile * G::kP;  // q, then dO
    const float* bdo = bq + kTile * G::kP;
    const float* ls_s = lse_s + 2 * u * kTile;     // lse, then delta
    cp_async_wait<0>();
    __syncthreads();  // the query tile (and K, V with the first) landed
    // two buffers: the next tile lands in the one every warp has read
    if (kBufs == 2 && q0 + kTile < S) stream(u ^ 1, q0 + kTile);
    // the tile's queries 32 .. 63 all lie past S: they are neither scored
    // nor summed
    const bool short_tile = q0 + kTile / 2 >= S;
    if (scorer && rows_live && !(short_tile && at.half)) {
      // s^T and dp^T of the warp's 32 keys and 32 queries; then p = exp(s
      // scale - lse) (0 for keys or queries >= S) and ds = p (dp - delta)
      float s[8][4], dp[8][4];
      zero(s);
      zero(dp);
      score_tiles<kD>(s, dp, ks, bq, vs, bdo, at.r0, at.c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = at.c + 8 * j;
        const bool q_ok = q0 + qi < S;
        const float ls = ls_s[qi], dl = ls_s[kTile + qi];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool ok = q_ok && k0 + at.r0 + 4 * i < S;
          const float p = ok ? exp_p(s[i][j] * scale - ls) : 0.f;
          const int x = (at.r0 + 4 * i) * kPS + qi;
          ps[x] = p;
          dss[x] = p * (dp[i][j] - dl);
        }
      }
    }
    __syncthreads();  // p and ds of every key of the block are stored
    // dv += p^T dO (half 0), dk += ds^T q (half 1) over the tile's queries
    if (rows_live) {
      const float* x = at.half ? dss : ps;
      const float* y = at.half ? bq : bdo;
      if (short_tile)
        sum_tile<kD, kTile / 2>(acc, x, y, at.r0, at.c0);
      else
        sum_tile<kD, kTile>(acc, x, y, at.r0, at.c0);
    }
    // dq's part of the tile's queries over the block's keys, by the
    // threads that hold a real query
    if (q0 + 4 * (threadIdx.x >> 4) < S) {
      float dqp[4][kD / 16];
      dq_part_tile<kD>(dqp, dss, ks, n_live);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + 4 * (threadIdx.x >> 4) + i;
        if (qi >= S) continue;
#pragma unroll
        for (int g = 0; g < kD / 64; ++g)
          *reinterpret_cast<float4*>(part + (long long)qi * kD + 64 * g) =
              make_float4(dqp[i][4 * g], dqp[i][4 * g + 1],
                          dqp[i][4 * g + 2], dqp[i][4 * g + 3]);
      }
    }
    if (kBufs == 1) {
      __syncthreads();  // the tile is read: its buffer takes the next one
      if (q0 + kTile < S) stream(0, q0 + kTile);
    }
  }

  store_tile(at.half ? head(dk, a, kDK, b, h) : head(dv, a, kDV, b, h),
             a.t[at.half ? kDK : kDV].sr, acc, k0, at, S, D,
             at.half ? scale : 1.f);
}

// 3. dq = (sum of the key blocks' parts, in their order) scale: a thread
// per 4 columns of a row of a head, over rows = B H S rows of `pitch`
// (kD) floats in each of the n_parts parts.
__global__ void __launch_bounds__(256)
hp_bwd_dq_sum_kernel(const float* __restrict__ dq_part,
                     float* __restrict__ dq, int H, int S, int D, int pitch,
                     int n_parts, long long rows, float scale, Strides g) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const int quarters = pitch / 4;
  if (i >= rows * quarters) return;
  const long long row = i / quarters;
  const int c = 4 * (int)(i % quarters);
  if (c >= D) return;
  float4 x = *reinterpret_cast<const float4*>(dq_part + row * pitch + c);
  for (int n = 1; n < n_parts; ++n) {
    const float4 y = *reinterpret_cast<const float4*>(
        dq_part + (n * rows + row) * pitch + c);
    x.x += y.x;
    x.y += y.y;
    x.z += y.z;
    x.w += y.w;
  }
  const long long bh = row / S;
  const int r = (int)(row % S), b = (int)(bh / H), h = (int)(bh % H);
  float* dst = dq + b * g.sb + h * g.sh + (long long)r * g.sr + c;
  const float y[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c + e < D) dst[e] = y[e] * scale;
}

// ---- head dims 129-256 (kD 192 and 256): the wide tiles
//
// Two 64 x 256 fp32 accumulators (dk and dv of 64 keys) are 128 registers a
// thread at 256 threads, and 128 staged rows are 266 KB: so a dk/dv block
// holds kWideKeys keys, each warp 8 of them, warps 0-3 summing dv and 4-7
// dk (8 x kD / 32 a thread), and a stats block holds 64 queries, each warp
// 8 whole rows, as csrc/attn_fwd_simt.cuh's wide tiles.
template <int kD>
struct Wide {
  static constexpr int kP = kD + 4;    // pitch of a staged row: 4 mod 32
  static constexpr int kC = kD / 32;   // a lane's columns of a summed row
  // stats: q, dO of 64 queries; K and V of kWideKeys keys
  static constexpr size_t kStatsSmem =
      (size_t)(2 * kTile * kP + 2 * kWideKeys * kP) * sizeof(float);
  // dk/dv: K, V of the block's keys; q, dO of 64 queries; p and ds
  // [key][query]; the queries' lse and delta
  static constexpr size_t kDkdvSmem =
      (size_t)(2 * kWideKeys * kP + 2 * kTile * kP + 2 * kWideKeys * kPS +
               2 * kTile) * sizeof(float);
  static_assert(kDkdvSmem <= 227 * 1024 && kStatsSmem <= 227 * 1024,
                "the wide tiles fit a block's 227 KB");
};

// x[i] += sum_{d < kD} a[i kP + d] b[d] (i < 8): 8 rows of a (the same for
// every lane) against the lane's row b, both read as float4.
template <int kD>
__device__ __forceinline__ void rows_dot(float (&x)[8],
                                         const float* __restrict__ a,
                                         const float* __restrict__ b) {
  constexpr int kP = kD + 4;
#pragma unroll 4
  for (int d = 0; d < kD; d += 4) {
    const float4 y = *reinterpret_cast<const float4*>(b + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 r = *reinterpret_cast<const float4*>(a + i * kP + d);
      x[i] = fmaf(r.x, y.x, x[i]);
      x[i] = fmaf(r.y, y.y, x[i]);
      x[i] = fmaf(r.z, y.z, x[i]);
      x[i] = fmaf(r.w, y.w, x[i]);
    }
  }
}

// 1w. grid (B * H * n_tiles) over 64-query tiles: each row's lse and
// delta into stats (B, H, S, 2), as launch 1. Warp w owns rows 8 w .. 8 w +
// 7 of the tile; K and V stream in kWideKeys-key tiles, lane l scoring key
// l: s (from K) and dp (from V) in two steps, the next tile's K landing
// under dp and its V under the next s. Each lane keeps an online (m, l, u)
// of each row over its keys; the row's 32 lanes merge them at the end.
template <int kD>
__global__ void __launch_bounds__(256, 1)
hp_bwd_stats_wide_simt_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              float* __restrict__ stats, int H, int S, int D,
                              int n_tiles, float scale, Views a, int vec) {
  constexpr int kP = Wide<kD>::kP;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kTile * kP;
  float* ks = dos + kTile * kP;
  float* vs = ks + kWideKeys * kP;
  const int bh = blockIdx.x / n_tiles, b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % n_tiles) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 8 * warp;                 // the warp's first row
  const bool rows_live = q0 + r0 < S;      // the warp has a real row
  const float* kg = head(k, a, kK, b, h);
  const float* vg = head(v, a, kV, b, h);

  copy_tile<kD, kTile, 256>(qs, head(q, a, kQ, b, h), a.t[kQ].sr, q0, S, D,
                            vec);
  copy_tile<kD, kTile, 256>(dos, head(dout, a, kDO, b, h), a.t[kDO].sr, q0,
                            S, D, vec);
  copy_tile<kD, kWideKeys, 256>(ks, kg, a.t[kK].sr, 0, S, D, vec);
  cp_async_commit();
  copy_tile<kD, kWideKeys, 256>(vs, vg, a.t[kV].sr, 0, S, D, vec);
  cp_async_commit();
  float mt[8], lt[8], ut[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mt[i] = kNegInf;
    lt[i] = ut[i] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += kWideKeys) {
    const bool more = k0 + kWideKeys < S;
    float s[8], dp[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = dp[i] = 0.f;
    cp_async_wait<1>();
    __syncthreads();  // K (and q, dO with the first) landed
    if (rows_live) rows_dot<kD>(s, qs + r0 * kP, ks + lane * kP);
    __syncthreads();  // K read: the next tile's K lands under dp
    if (more) copy_tile<kD, kWideKeys, 256>(ks, kg, a.t[kK].sr,
                                            k0 + kWideKeys, S, D, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // V landed
    if (rows_live) rows_dot<kD>(dp, dos + r0 * kP, vs + lane * kP);
    __syncthreads();  // V read
    if (more) copy_tile<kD, kWideKeys, 256>(vs, vg, a.t[kV].sr,
                                            k0 + kWideKeys, S, D, vec);
    cp_async_commit();
    if (rows_live && k0 + lane < S) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = __fmul_rn(s[i], scale);
        const float m_new = fmaxf(mt[i], x);
        const float alpha = exp_p(mt[i] - m_new);
        const float e = exp_p(x - m_new);
        lt[i] = fmaf(lt[i], alpha, e);
        ut[i] = fmaf(ut[i], alpha, e * dp[i]);
        mt[i] = m_new;
      }
    }
  }
  if (!rows_live) return;
  // merged over the row's 32 lanes: lse = m + log l, delta = u / l
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      merge(mt[i], lt[i], ut[i], __shfl_xor_sync(0xffffffffu, mt[i], off),
            __shfl_xor_sync(0xffffffffu, lt[i], off),
            __shfl_xor_sync(0xffffffffu, ut[i], off));
    if (lane == 0 && q0 + r0 + i < S) {
      float* st = stats + ((long long)bh * S + q0 + r0 + i) * 2;
      st[0] = mt[i] + logf(lt[i]);
      st[1] = ut[i] / lt[i];
    }
  }
}

// 2w. grid (B * H * n_tiles) over kWideKeys-key tiles: dk, dv and each
// query's part of dq from the block's keys, as launch 2. Warp w owns keys 8
// (w % 4) .. 8 (w % 4) + 7 of the block; for each 64-query tile, lane l
// holding queries l and l + 32, warps 0-3 score s^T (K against q) and
// store p = exp(s scale - lse), warps 4-7 score dp^T (V against dO) and,
// once p is stored, ds = p (dp - delta); then warps 0-3 sum dv += p^T dO
// and warps 4-7 dk += ds^T q over the tile, every warp from its own rows of
// p or ds. The next tile's q and dO load while all 256 threads form dq's
// part (ds^T k over the block's keys, dq_part_tile). Shared memory: K, V
// [kWideKeys][kP]; q, dO [64][kP]; p, ds [kWideKeys][kPS]; lse and delta
// [2][64].
template <int kD>
__global__ void __launch_bounds__(256, 1)
hp_bwd_dkdv_wide_simt_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ stats,
                             float* __restrict__ dk, float* __restrict__ dv,
                             float* __restrict__ dq_part, int H, int S, int D,
                             int n_tiles, float scale, Views a, int vec) {
  constexpr int kP = Wide<kD>::kP, kC = Wide<kD>::kC;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kWideKeys * kP;
  float* qs = vs + kWideKeys * kP;
  float* dos = qs + kTile * kP;
  float* ps = dos + kTile * kP;
  float* dss = ps + kWideKeys * kPS;
  float* ls = dss + kWideKeys * kPS;  // lse [64], then delta [64]
  const int bh = blockIdx.x / n_tiles, b = bh / H, h = bh % H;
  const int kb = blockIdx.x % n_tiles, k0 = kb * kWideKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool dk_warp = warp >= 4;
  const int kr = 8 * (warp & 3);           // the warp's first key
  const bool keys_live = k0 + kr < S;      // the warp has a real key
  const int n_live = min(kWideKeys, S - k0);
  const float* qg = head(q, a, kQ, b, h);
  const float* dog = head(dout, a, kDO, b, h);
  const float* st_g = stats + (long long)bh * S * 2;
  float* part = dq_part +
                ((long long)kb * (gridDim.x / n_tiles) + bh) * S * kD +
                4 * (threadIdx.x & 15);
  // the query tile at q0: q, dO, lse and delta, by cp.async
  auto stream = [&](int q0) {
    copy_tile<kD, kTile, 256>(qs, qg, a.t[kQ].sr, q0, S, D, vec);
    copy_tile<kD, kTile, 256>(dos, dog, a.t[kDO].sr, q0, S, D, vec);
    if (threadIdx.x < 2 * kTile) {
      const int t = threadIdx.x % kTile;
      const bool ok = q0 + t < S;
      cp_async<4>(ls + threadIdx.x,
                  ok ? st_g + 2 * (q0 + t) + threadIdx.x / kTile : st_g, ok);
    }
    cp_async_commit();
  };

  copy_tile<kD, kWideKeys, 256>(ks, head(k, a, kK, b, h), a.t[kK].sr, k0, S,
                                D, vec);
  copy_tile<kD, kWideKeys, 256>(vs, head(v, a, kV, b, h), a.t[kV].sr, k0, S,
                                D, vec);
  stream(0);
  float acc[8][kC];  // dv (warps 0-3) or dk (4-7) of the warp's 8 keys
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kTile) {
    cp_async_wait<0>();
    __syncthreads();  // the query tile (and K, V with the first) landed
    // the tile's queries 32 .. 63 all lie past S: neither scored nor summed
    const bool short_tile = q0 + kTile / 2 >= S;
    float x[8][2];  // s^T (warps 0-3) or dp^T (4-7)
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i][0] = x[i][1] = 0.f;
    if (keys_live) {
      const float* kv = (dk_warp ? vs : ks) + kr * kP;
      const float* qd = (dk_warp ? dos : qs) + lane * kP;
      if (short_tile)
        keys_dot<kD, 1>(x, kv, qd);
      else
        keys_dot<kD, 2>(x, kv, qd);
      if (!dk_warp) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qi = lane + 32 * j;
          const bool q_ok = q0 + qi < S;
          const float lse = ls[qi];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            ps[(kr + i) * kPS + qi] =
                q_ok && k0 + kr + i < S
                    ? exp_p(__fmul_rn(x[i][j], scale) - lse)
                    : 0.f;
        }
      }
    }
    __syncthreads();  // p of every key stored
    if (keys_live) {
      if (dk_warp) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qi = lane + 32 * j;
          const float dl = ls[kTile + qi];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int at = (kr + i) * kPS + qi;
            dss[at] = ps[at] * (x[i][j] - dl);
          }
        }
        __syncwarp();  // the warp's rows of ds are stored
      }
      const float* pd = (dk_warp ? dss : ps) + kr * kPS;
      const float* y = dk_warp ? qs : dos;
      if (short_tile)
        keys_sum<kD, kTile / 2>(acc, pd, y, lane);
      else
        keys_sum<kD, kTile>(acc, pd, y, lane);
    }
    __syncthreads();  // ds of every key stored; q and dO read
    if (q0 + kTile < S) stream(q0 + kTile);
    // dq's part of the tile's queries over the block's keys, by the threads
    // that hold a real query
    if (q0 + 4 * (threadIdx.x >> 4) < S) {
      float dqp[4][kD / 16];
      dq_part_tile<kD, kWideDqUnroll>(dqp, dss, ks, n_live);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + 4 * (threadIdx.x >> 4) + i;
        if (qi >= S) continue;
#pragma unroll
        for (int g = 0; g < kD / 64; ++g)
          *reinterpret_cast<float4*>(part + (long long)qi * kD + 64 * g) =
              make_float4(dqp[i][4 * g], dqp[i][4 * g + 1],
                          dqp[i][4 * g + 2], dqp[i][4 * g + 3]);
      }
    }
  }

  float* dst = dk_warp ? head(dk, a, kDK, b, h) : head(dv, a, kDV, b, h);
  const long long sr = a.t[dk_warp ? kDK : kDV].sr;
  const float mul = dk_warp ? scale : 1.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + kr + i;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = wide_col<kD>(lane, c);
      if (col < D) dst[(long long)key * sr + col] = __fmul_rn(acc[i][c], mul);
    }
  }
}

// The scratch of launch, in floats: lse and delta of every row (rounded to
// 16 bytes), then kRows-key blocks' parts of dq at pitch kD.
template <int kD, int kRows>
long long scratch_size(int B, int H, int S) {
  const long long rows = (long long)B * H * S;
  return (2 * rows + 3) / 4 * 4 + (long long)((S + kRows - 1) / kRows) *
                                      rows * kD;
}

template <int kD, int kRows, int kBufs, int kStatRows, int kStatBufs>
int launch(const float* const* t, float* scratch, int B, int H, int S, int D,
           float scale, const Views& a, cudaStream_t stream) {
  typedef Bwd<kD, kRows, kBufs> G;
  typedef Stats<kD, kStatRows, kStatBufs> St;
  const long long rows = (long long)B * H * S;
  float* stats = scratch;
  float* dq_part = scratch + (2 * rows + 3) / 4 * 4;
  int n_tiles;
  unsigned blocks;
  // 16-byte copies when every row of q, k, v and dO is 16-byte aligned
  const int vec = rows16({t[kQ], t[kK]}, a.t[kQ], a.t[kK]) &&
                  rows16({t[kV], t[kDO]}, a.t[kV], a.t[kDO]);
  int rc = prepare(hp_bwd_stats_simt_kernel<kD, kStatRows, kStatBufs>,
                   St::kSmem, kStatRows, B, H, S, &n_tiles, &blocks);
  if (rc) return rc;
  hp_bwd_stats_simt_kernel<kD, kStatRows, kStatBufs>
      <<<blocks, St::kThr, St::kSmem, stream>>>(t[kQ], t[kK], t[kV], t[kDO],
                                                stats, H, S, D, n_tiles,
                                                scale, a, vec);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = prepare(hp_bwd_dkdv_simt_kernel<kD, kRows, kBufs>, G::kSmem, kRows, B,
               H, S, &n_tiles, &blocks);
  if (rc) return rc;
  hp_bwd_dkdv_simt_kernel<kD, kRows, kBufs>
      <<<blocks, G::kThr, G::kSmem, stream>>>(
          t[kQ], t[kK], t[kV], t[kDO], stats, const_cast<float*>(t[kDK]),
          const_cast<float*>(t[kDV]), dq_part, H, S, D, n_tiles, scale, a,
          vec);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const long long threads = rows * (kD / 4);
  hp_bwd_dq_sum_kernel<<<(unsigned)((threads + 255) / 256), 256, 0,
                         stream>>>(dq_part, const_cast<float*>(t[kDQ]), H, S,
                                   D, kD, n_tiles, rows, scale, a.t[kDQ]);
  return (int)cudaGetLastError();
}

}  // namespace

// The wide tiles' three launches (kD 192, 256).
template <int kD>
int launch_wide(const float* const* t, float* scratch, int B, int H, int S,
                int D, float scale, const Views& a, cudaStream_t stream) {
  typedef Wide<kD> G;
  const long long rows = (long long)B * H * S;
  float* stats = scratch;
  float* dq_part = scratch + (2 * rows + 3) / 4 * 4;
  int n_tiles;
  unsigned blocks;
  const int vec = rows16({t[kQ], t[kK]}, a.t[kQ], a.t[kK]) &&
                  rows16({t[kV], t[kDO]}, a.t[kV], a.t[kDO]);
  int rc = prepare(hp_bwd_stats_wide_simt_kernel<kD>, G::kStatsSmem, kTile,
                   B, H, S, &n_tiles, &blocks);
  if (rc) return rc;
  hp_bwd_stats_wide_simt_kernel<kD><<<blocks, 256, G::kStatsSmem, stream>>>(
      t[kQ], t[kK], t[kV], t[kDO], stats, H, S, D, n_tiles, scale, a, vec);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = prepare(hp_bwd_dkdv_wide_simt_kernel<kD>, G::kDkdvSmem, kWideKeys, B,
               H, S, &n_tiles, &blocks);
  if (rc) return rc;
  hp_bwd_dkdv_wide_simt_kernel<kD><<<blocks, 256, G::kDkdvSmem, stream>>>(
      t[kQ], t[kK], t[kV], t[kDO], stats, const_cast<float*>(t[kDK]),
      const_cast<float*>(t[kDV]), dq_part, H, S, D, n_tiles, scale, a, vec);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const long long threads = rows * (kD / 4);
  hp_bwd_dq_sum_kernel<<<(unsigned)((threads + 255) / 256), 256, 0,
                         stream>>>(dq_part, const_cast<float*>(t[kDQ]), H, S,
                                   D, kD, n_tiles, rows, scale, a.t[kDQ]);
  return (int)cudaGetLastError();
}

// The instantiations: <head dim, dk/dv block rows, its streamed buffers,
// stats block rows, their buffers>. At D <= 64 the dk/dv blocks take 128
// keys and both streamed buffers (one block an SM), as K5's; at D <= 128 64
// keys and one. The stats blocks take 128 queries.
#define VTX_HP_BWD_SIMT_64 64, 128, 2, 128, 2
#define VTX_HP_BWD_SIMT_128 128, 64, 1, 128, 1

namespace hp_bwd_simt {

// The scratch `run` takes, in floats.
long long scratch_floats(int B, int H, int S, int D) {
  if (D <= 64) return scratch_size<64, 128>(B, H, S);
  if (D <= 128) return scratch_size<128, 64>(B, H, S);
  return D <= 192 ? scratch_size<192, kWideKeys>(B, H, S)
                  : scratch_size<256, kWideKeys>(B, H, S);
}

// q, k, v, dout in and dq, dk, dv out at `ptrs`, fp32 (B, H, S, D) with
// the head dim contiguous; strides holds 21 element strides, (batch, head,
// token) of each in that order; scratch fp32 of scratch_floats(B, H, S, D);
// 1 <= D <= 256, S <= 1024.
int run(const void* const* ptrs, const long long* strides, float* scratch,
        int B, int S, int H, int D, float scale, cudaStream_t stream) {
  if (D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  Views a;
  const float* t[kTensors];
  for (int i = 0; i < kTensors; ++i) {
    a.t[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    t[i] = static_cast<const float*>(ptrs[i]);
  }
  if (D <= 64)
    return launch<VTX_HP_BWD_SIMT_64>(t, scratch, B, H, S, D, scale, a,
                                      stream);
  if (D <= 128)
    return launch<VTX_HP_BWD_SIMT_128>(t, scratch, B, H, S, D, scale, a,
                                       stream);
  return D <= 192 ? launch_wide<192>(t, scratch, B, H, S, D, scale, a, stream)
                  : launch_wide<256>(t, scratch, B, H, S, D, scale, a, stream);
}

}  // namespace hp_bwd_simt
