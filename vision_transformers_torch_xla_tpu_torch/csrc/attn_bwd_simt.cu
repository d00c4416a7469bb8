// K2's backward in fp32 at head dims 129-256 on the CUDA cores of Hopper,
// on csrc/simt_wide.cuh's wide register tiles (compile-time kD 192 or 256;
// a head dim in between takes the next with its columns zero-filled).
// Linked into csrc/attn_bwd.cu's library, whose vtx_attn_bwd launches it
// for float at 128 < D <= 256 (fp32 to 128 is that file's attn_bwd_kernel,
// every dtype past 256 its attn_bwd_wide_kernel<T>; bf16 and fp16 to 256
// are csrc/attn_bwd_tc.cu's).
//
// Replaces vision_transformers_torch_xla_tpu/ops/flash_attention.py
// ::_hp_bwd_pi_kernel (:495, ROADMAP K2) in fp32, where every rounding of
// its cast order is the identity. Per (b, h), from the forward's row stats
// [m, rinv] (K1):
//   q^ = q scale; s = q^ k^T; pu = exp(s - m), unnormalised;
//   do_n = dO rinv; dv = pu^T do_n;
//   delta = rowsum(dO O); dp = dO v^T; t = (dp - delta) pu;
//   dq = (t k) (rinv scale); qn = q^ rinv; dk = t^T qn;
// and the column sums of dq, dk and dv over the sequence, the (B, 3 H D)
// qkv-bias partials. With p = pu rinv (the normalised probability) and ds =
// t rinv = p (dp - delta) this is dv = p^T dO, dk = (ds^T q) scale and dq =
// (ds k) scale: csrc/hp_bwd_simt.cu's wide dk/dv launch (K8, K10, K12) with
// p from the forward's stats in place of its own stats launch, and delta
// from O. The products run in other orders than JAX's (s scaled after the
// sum, rinv and scale folded into p and ds), fp32 rounding apart.
//
// What bounds it on an H100: the five products, 10 B H S^2 D FLOPs, at the
// 67 TFLOP/s fp32 peak of the CUDA cores (0.569 ms at (B, S, H, D) = (32,
// 197, 12, 256)), against ~0.39 GB of operands and results (0.12 ms).
// Measured there (H100 80GB HBM3 at 700 W, PERF.md §6): 2.045 ms of device
// time, rows 0.055, dk/dv 1.765, dq sum 0.218, bias 0.007; SDPA's fp32
// backward 2.04-2.05, the run-time head-dim loop it replaced 10.30-10.35.
//
// Design, four launches, so that no sum crosses blocks and nothing takes a
// float atomic (two calls on the same inputs are bitwise equal):
//   1. rows: a warp per (b, h, query row): delta = rowsum(dO O), stored
//      beside the row's m and rinv as one 16-byte record [m, rinv, delta,
//      0] in a (B, H, S, 4) scratch.
//   2. dk, dv and dq's parts, a block per (b, h, 32-key tile) of 8 warps
//      (csrc/hp_bwd_simt.cu's hp_bwd_dkdv_wide_simt_kernel), each owning 8
//      keys, warps 0-3 summing dv and 4-7 dk; for each 64-query tile (q, dO
//      and the records by cp.async), warps 0-3 score s^T and store p = exp(s
//      scale - m) rinv, warps 4-7 score dp^T and, once p is stored, ds = p
//      (dp - delta); each warp sums its keys' dv += p^T dO or dk += ds^T q;
//      then the block's part of dq, ds k over its keys, for the tile's 64
//      queries into a [key tile][B H][S][kD] scratch while the next query
//      tile loads. dk (times scale) and dv go to dqkv, and their column sums
//      over the block's real keys (each warp's 8 keys in order, then the 4
//      warps in order) to a (B, key tiles, 3 H D) partials scratch.
//   3. dq: a block per (b, h, 32-row tile) of kD threads, each 4 columns of
//      8 rows: the parts summed in key-tile order, times scale, into dqkv,
//      and their column sums over the tile's real rows into the partials.
//   4. bias: a thread per (b, column) adds the column's tiles in order.
// The dq parts take ceil(S / 32) B H S kD floats: 542 MB at the shape
// above, 12.9 GB at (32, 1024, 12, 256).
//
// Plain C++ interface (namespace attn_bwd_simt), called by csrc/attn_bwd.cu
// on the caller's stream; returns cudaGetLastError(). The kernels allocate
// nothing: the caller sizes the scratch by scratch_floats.

#include "simt_tiles.cuh"
#include "simt_wide.cuh"

namespace {

constexpr int kRec = 4;          // a query's record: m, rinv, delta, 0
constexpr int kRowWarps = 8;     // launch 1's warps a block
constexpr int kBiasThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 1. grid (ceil(rows / kRowWarps)), a warp per row r of (B H S): rec[r] =
// [st[r][0], st[r][1], rowsum(dO O), 0]; dO and O are (B, S, H D).
__global__ void __launch_bounds__(kRowWarps * 32)
attn_bwd_rows_simt_kernel(const float* __restrict__ dout,
                          const float* __restrict__ out,
                          const float* __restrict__ st,
                          float* __restrict__ rec, int H, int S, int D,
                          long long rows) {
  const long long r = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bh = r / S;
  const int s = (int)(r % S), b = (int)(bh / H), h = (int)(bh % H);
  const long long off = ((long long)b * S + s) * H * D + (long long)h * D;
  float dl = 0.f;
  for (int d = lane; d < D; d += 32) dl = fmaf(dout[off + d], out[off + d], dl);
  dl = warp_sum(dl);
  if (lane == 0)
    *reinterpret_cast<float4*>(rec + r * kRec) =
        make_float4(st[2 * r], st[2 * r + 1], dl, 0.f);
}

// Launch 2 at kD 256 takes keys_dot unrolled once and dq's part in two
// passes of half the columns: as hp_bwd_dkdv_wide_simt_kernel's loop it
// needs 255 registers and spills 24 bytes, this way none, and its device
// time falls 1.83-1.84 -> 1.76-1.77 ms at (32, 197, 12, 256); at kD 192
// keys_dot unrolled once costs 4% (246 registers with the loop as it is,
// no spills; tools/time_fp32_hp_bwd_variants.py --kernel attn_bwd,
// PERF.md §6).
template <int kD>
struct K2Wide {
  static constexpr int kDotUnroll = kD == 256 ? 1 : 2;
  static constexpr int kDqPasses = kD == 256 ? 2 : 1;
};

// dq's part of the tile's queries over the block's n_live keys in the
// column groups [kG0, kG0 + kGn) of 64, stored at dqp_g (the thread's 4
// queries from q0, those < S).
template <int kD, int kG0, int kGn>
__device__ __forceinline__ void dq_part_store(float* __restrict__ dqp_g,
                                              const float* __restrict__ dss,
                                              const float* __restrict__ ks,
                                              int n_live, int q0, int S) {
  float dqp[4][4 * kGn];
  dq_part_tile<kD, kWideDqUnroll, kG0, kGn>(dqp, dss, ks, n_live);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * (threadIdx.x >> 4) + i;
    if (qi >= S) continue;
#pragma unroll
    for (int g = 0; g < kGn; ++g)
      *reinterpret_cast<float4*>(dqp_g + (long long)qi * kD +
                                 64 * (kG0 + g)) =
          make_float4(dqp[i][4 * g], dqp[i][4 * g + 1], dqp[i][4 * g + 2],
                      dqp[i][4 * g + 3]);
  }
}

// Launch 2's shared memory: K, V [kWideKeys][kP]; q, dO [64][kP]; p, ds
// [kWideKeys][kPS]; the query tile's records [64][kRec].
template <int kD>
constexpr size_t dkdv_smem() {
  return (size_t)(2 * kWideKeys * (kD + 4) + 2 * kTile * (kD + 4) +
                  2 * kWideKeys * kPS + kRec * kTile) * sizeof(float);
}

static_assert(dkdv_smem<256>() <= 227 * 1024,
              "the widest tiles fit a block's 227 KB");

// 2. grid (B H n_kb) over kWideKeys-key tiles: block x is key tile x % n_kb
// of (b, h) = x / n_kb. qkv, dqkv (B, S, C), C = 3 H D, dO (B, S, HD);
// dq_part [n_kb][B H][S][kD]; part (B, n_kb, C).
template <int kD>
__global__ void __launch_bounds__(256, 1)
attn_bwd_dkdv_wide_simt_kernel(const float* __restrict__ qkv,
                               const float* __restrict__ dout,
                               const float* __restrict__ rec,
                               float* __restrict__ dqkv,
                               float* __restrict__ dq_part,
                               float* __restrict__ part, int H, int S, int D,
                               long long C, long long HD, int n_kb,
                               float scale, int vec) {
  constexpr int kP = kD + 4, kC = kD / 32;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kWideKeys * kP;
  float* qs = vs + kWideKeys * kP;
  float* dos = qs + kTile * kP;
  float* ps = dos + kTile * kP;
  float* dss = ps + kWideKeys * kPS;
  float* rs = dss + kWideKeys * kPS;  // [query][m, rinv, delta, 0]
  const int bh = blockIdx.x / n_kb, b = bh / H, h = bh % H;
  const int kb = blockIdx.x % n_kb, k0 = kb * kWideKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool dk_warp = warp >= 4;
  const int kr = 8 * (warp & 3);           // the warp's first key
  const bool keys_live = k0 + kr < S;      // the warp has a real key
  const int n_live = min(kWideKeys, S - k0);
  const float* qg = qkv + (long long)b * S * C + (long long)h * D;
  const float* dog = dout + (long long)b * S * HD + (long long)h * D;
  const float* rec_g = rec + (long long)bh * S * kRec;
  float* dqp_g = dq_part +
                 ((long long)kb * (gridDim.x / n_kb) + bh) * S * kD +
                 4 * (threadIdx.x & 15);
  // the query tile at q0: q, dO and the records, by cp.async
  auto stream = [&](int q0) {
    copy_tile<kD, kTile, 256>(qs, qg, C, q0, S, D, vec);
    copy_tile<kD, kTile, 256>(dos, dog, HD, q0, S, D, vec);
    if (threadIdx.x < kTile) {
      const bool ok = q0 + threadIdx.x < S;
      cp_async<16>(rs + kRec * threadIdx.x,
                   ok ? rec_g + kRec * (q0 + threadIdx.x) : rec_g, ok);
    }
    cp_async_commit();
  };

  copy_tile<kD, kWideKeys, 256>(ks, qg + HD, C, k0, S, D, vec);
  copy_tile<kD, kWideKeys, 256>(vs, qg + 2 * HD, C, k0, S, D, vec);
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
        keys_dot<kD, 1, K2Wide<kD>::kDotUnroll>(x, kv, qd);
      else
        keys_dot<kD, 2, K2Wide<kD>::kDotUnroll>(x, kv, qd);
      if (!dk_warp) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qi = lane + 32 * j;
          const bool q_ok = q0 + qi < S;
          const float m = rs[kRec * qi], rinv = rs[kRec * qi + 1];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            ps[(kr + i) * kPS + qi] =
                q_ok && k0 + kr + i < S
                    ? exp_p(__fmul_rn(x[i][j], scale) - m) * rinv
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
          const float dl = rs[kRec * qi + 2];
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
      constexpr int kG = kD / 64, kGa = kG / K2Wide<kD>::kDqPasses;
      dq_part_store<kD, 0, kGa>(dqp_g, dss, ks, n_live, q0, S);
      if constexpr (kGa < kG)
        dq_part_store<kD, kGa, kG - kGa>(dqp_g, dss, ks, n_live, q0, S);
    }
  }

  // dk (times scale) or dv of the warp's real keys into dqkv, and their
  // column sums in key order
  float* dst = dqkv + (long long)b * S * C + (dk_warp ? HD : 2 * HD) +
               (long long)h * D;
  const float mul = dk_warp ? scale : 1.f;
  float cs[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) cs[c] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + kr + i;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = wide_col<kD>(lane, c);
      const float y = __fmul_rn(acc[i][c], mul);
      if (col < D) dst[(long long)key * C + col] = y;
      cs[c] += y;
    }
  }
  // the block's bias partials: the 4 warps' column sums of dv (warps 0-3)
  // and dk (4-7) in warp order, through qs (no longer read: the loop's
  // last barrier is behind every read of it, and nothing streams into it)
  float* red = qs + warp * kD;
#pragma unroll
  for (int c = 0; c < kC; ++c) red[wide_col<kD>(lane, c)] = cs[c];
  __syncthreads();
  float* pp = part + ((long long)b * n_kb + kb) * C + (long long)h * D;
  for (int c = threadIdx.x; c < D; c += 256) {
    float sv = 0.f, sk = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      sv += qs[w * kD + c];
      sk += qs[(4 + w) * kD + c];
    }
    pp[HD + c] = sk;
    pp[2 * HD + c] = sv;
  }
}

// 3. grid (B H n_kb) over kWideKeys-row tiles, kD threads: thread (rl, cg)
// = (tid / (kD / 4), tid % (kD / 4)) sums columns 4 cg .. 4 cg + 3 of rows
// rl, rl + 4, .. of the tile over the n_kb parts in order, stores them
// times scale into dqkv, and the tile's column sums (the 4 row lanes' in
// order) go to part.
template <int kD>
__global__ void __launch_bounds__(kD)
attn_bwd_dq_sum_simt_kernel(const float* __restrict__ dq_part,
                            float* __restrict__ dqkv,
                            float* __restrict__ part, int H, int S, int D,
                            int n_kb, long long rows, float scale) {
  constexpr int kQ = kD / 4;  // 16-byte column groups of a row
  __shared__ float red[4][kD];
  const int bh = blockIdx.x / n_kb, b = bh / H, h = bh % H;
  const int kb = blockIdx.x % n_kb, r0 = kb * kWideKeys;
  const int rl = threadIdx.x / kQ, c = 4 * (threadIdx.x % kQ);
  const long long C = 3LL * H * D;
  float* dst = dqkv + (long long)b * S * C + (long long)h * D + c;
  float cs[4] = {0.f, 0.f, 0.f, 0.f};
  const int r_end = min(S, r0 + kWideKeys);
  for (int r = r0 + rl; r < r_end; r += 4) {
    const long long row = (long long)bh * S + r;
    float4 x = *reinterpret_cast<const float4*>(dq_part + row * kD + c);
    for (int n = 1; n < n_kb; ++n) {
      const float4 y = *reinterpret_cast<const float4*>(
          dq_part + (n * rows + row) * kD + c);
      x.x += y.x;
      x.y += y.y;
      x.z += y.z;
      x.w += y.w;
    }
    const float y[4] = {x.x * scale, x.y * scale, x.z * scale, x.w * scale};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e < D) dst[(long long)r * C + e] = y[e];
      cs[e] += y[e];
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) red[rl][c + e] = cs[e];
  __syncthreads();
  if (threadIdx.x < D)
    part[((long long)b * n_kb + kb) * C + (long long)h * D + threadIdx.x] =
        ((red[0][threadIdx.x] + red[1][threadIdx.x]) + red[2][threadIdx.x]) +
        red[3][threadIdx.x];
}

// 4. dbias[b][c] = the sum over the n_kb tiles, in order, of part[b][t][c].
__global__ void __launch_bounds__(kBiasThreads)
attn_bwd_bias_simt_kernel(const float* __restrict__ part,
                          float* __restrict__ dbias, int n_kb, int C,
                          long long total) {
  const long long x = (long long)blockIdx.x * kBiasThreads + threadIdx.x;
  if (x >= total) return;
  const long long b = x / C;
  const int c = (int)(x % C);
  float sum = 0.f;
  for (int t = 0; t < n_kb; ++t) sum += part[(b * n_kb + t) * C + c];
  dbias[x] = sum;
}

// The scratch's three parts, in floats: the records (B H S kRec), the dq
// parts (n_kb B H S kD), the bias partials (B n_kb 3 H D).
struct Scratch {
  long long rec, dq_part, part;
};

template <int kD>
Scratch scratch_of(int B, int H, int S, int D) {
  const long long rows = (long long)B * H * S;
  const long long n_kb = (S + kWideKeys - 1) / kWideKeys;
  return Scratch{rows * kRec, n_kb * rows * kD, B * n_kb * 3LL * H * D};
}

unsigned blocks_of(long long n, int per, int* rc) {
  const long long blocks = (n + per - 1) / per;
  if (blocks > INT_MAX) *rc = (int)cudaErrorInvalidValue;
  return (unsigned)blocks;
}

template <int kD>
int launch(const float* qkv, const float* dout, const float* out,
           const float* st, float* dqkv, float* dbias, float* scratch, int B,
           int S, int H, int D, float scale, cudaStream_t stream) {
  const Scratch n = scratch_of<kD>(B, H, S, D);
  float* rec = scratch;
  float* dq_part = rec + n.rec;
  float* part = dq_part + n.dq_part;
  const long long rows = (long long)B * H * S;
  const int n_kb = (S + kWideKeys - 1) / kWideKeys;
  const int C = 3 * H * D;
  int rc = 0;
  const unsigned row_blocks = blocks_of(rows, kRowWarps, &rc);
  const unsigned tile_blocks = blocks_of((long long)n_kb * B * H, 1, &rc);
  const unsigned bias_blocks = blocks_of((long long)B * C, kBiasThreads, &rc);
  if (rc) return rc;
  attn_bwd_rows_simt_kernel<<<row_blocks, kRowWarps * 32, 0, stream>>>(
      dout, out, st, rec, H, S, D, rows);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  // 16-byte copies when every row of qkv and dO is 16-byte aligned
  const Strides sq{(long long)S * C, D, C};
  const Strides so{(long long)S * H * D, D, (long long)H * D};
  const int vec = rows16({qkv, dout}, sq, so);
  constexpr size_t smem = dkdv_smem<kD>();
  rc = (int)cudaFuncSetAttribute(attn_bwd_dkdv_wide_simt_kernel<kD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
  if (rc) return rc;
  attn_bwd_dkdv_wide_simt_kernel<kD><<<tile_blocks, 256, smem, stream>>>(
      qkv, dout, rec, dqkv, dq_part, part, H, S, D, C, (long long)H * D,
      n_kb, scale, vec);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  attn_bwd_dq_sum_simt_kernel<kD><<<tile_blocks, kD, 0, stream>>>(
      dq_part, dqkv, part, H, S, D, n_kb, rows, scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  attn_bwd_bias_simt_kernel<<<bias_blocks, kBiasThreads, 0, stream>>>(
      part, dbias, n_kb, C, (long long)B * C);
  return (int)cudaGetLastError();
}

}  // namespace

namespace attn_bwd_simt {

// The scratch `run` takes at these sizes, in floats (128 < D <= 256).
long long scratch_floats(int B, int H, int S, int D) {
  const Scratch n = D <= 192 ? scratch_of<192>(B, H, S, D)
                             : scratch_of<256>(B, H, S, D);
  return n.rec + n.dq_part + n.part;
}

// dqkv (B, S, 3 H D) and dbias (B, 3 H D) out, from qkv (B, S, 3 H D), dout
// and out (B, S, H D), contiguous fp32, and the forward's (B, H, S, 2)
// stats; scratch of scratch_floats(B, H, S, D), 16-byte aligned. 128 < D <=
// 256, 1 <= S <= 1024.
int run(const float* qkv, const float* dout, const float* out,
        const float* st, float* dqkv, float* dbias, float* scratch, int B,
        int S, int H, int D, float scale, cudaStream_t stream) {
  if (D <= 128 || D > 256) return (int)cudaErrorInvalidValue;
  return D <= 192 ? launch<192>(qkv, dout, out, st, dqkv, dbias, scratch, B,
                                S, H, D, scale, stream)
                  : launch<256>(qkv, dout, out, st, dqkv, dbias, scratch, B,
                                S, H, D, scale, stream);
}

}  // namespace attn_bwd_simt
