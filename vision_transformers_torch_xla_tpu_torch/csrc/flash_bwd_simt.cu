// The blocked attention backward in fp32 on the CUDA cores of Hopper:
// flash_bwd_dkdv_simt_kernel<kD> (K5) and flash_bwd_dq_simt_kernel<kD>
// (K6), kD 64 or 128 at compile time, and past 128
// flash_bwd_dkdv_wide_simt_kernel<kD> and flash_bwd_dq_wide_simt_kernel<kD>,
// kD 192 or 256 (a smaller head dim takes the next with its columns
// zero-filled). Linked into csrc/flash_blocked.cu's library, whose dkdv()
// and dq() launch them for float at D <= 256 (every dtype past 256 stays
// there; bf16 and fp16 to 256 are csrc/flash_bwd.cu's).
//
// Replaces the TPU kernels of vision_transformers_torch_xla_tpu/ops/
// flash_blocked.py in fp32 (the JAX kernels round nothing there):
//   K5 <- _bwd_dkdv_kernel (:109, call :208): per key row, over the query
//      tiles, p = exp((q k^T) scale - lse), keys or queries >= S giving 0;
//      dv += p^T dO; ds = p (dO v^T - delta); dk += ds^T q; dk *= scale.
//   K6 <- _bwd_dq_kernel (:157, call :231): per query row, over the key
//      tiles, the same p and ds; dq += ds k; dq *= scale.
// lse and delta are (B, H, S) fp32 from the caller (ops/flash_blocked.py::
// flash_delta). q, k, v, dO and the gradients are (B, H, S, D) of any
// element strides with a contiguous head dim, so they are read straight
// from a fused (B, S, 3 H D) projection and written into views of one
// dqkv buffer.
//
// What bounds them on an H100: the products. At (B, S, H, D) = (32, 1370,
// 12, 64) K5 does 4 products of B H S^2 D FMAs (369 GFLOP) and K6 3 (277
// GFLOP): 5.51 and 4.13 ms at the 67 TFLOP/s fp32 peak of the CUDA cores,
// against 0.2 GB of operands (0.06 ms at 3.35 TB/s). The tensor cores have
// no fp32 product that keeps the inputs (TF32 rounds them). On the CUDA
// cores an SM does 128 FMAs and moves 128 bytes from shared memory into
// registers a clock, so a product nears the FMA rate only if each thread
// reads about one byte of shared memory an FMA: register tiles of 8 x 8
// (or 2 x 8 x 4), every operand read as float4.
//
// Design. A block per (b, h, kRows-row tile) on a one-dimensional grid (B
// H bounded only by 2^31 / ceil(S / kRows)): at D <= 64 kRows = 128 and 8
// warps (kD = 64), at D <= 128 kRows = 64 and 8 warps (kD = 128).
//   * Staging. The block's own rows (K5: K and V of its keys; K6: q and dO
//     of its queries) are staged once; the other side's 64-row tiles stream
//     through cp.async buffers, two at kD = 64 (the next tile lands while
//     the block works on this one; one barrier a tile in K6, two in K5),
//     one at kD = 128 (two would take 235 KB). All of them lie row-major at
//     pitch kD + 4: 16-byte copies with the columns past D zero-filled when
//     every row is 16-byte aligned (the model's qkv views: 9,216-byte rows,
//     256-byte head offsets), else one 4-byte copy an element (any fp32
//     view with a contiguous head dim: nothing is copied in Python).
//   * Scores. A warp's lanes are 4 x 8 (ly, lx). Each scoring warp (32
//     rows of the block by 32 columns of the tile) computes s = q k^T and
//     dp = dO v^T together, a thread 8 rows by 4 columns of each, every
//     operand read as float4 along the head dim (24 loads feed 256 FMAs),
//     then forms p = exp(s scale - lse) (ex2.approx) and ds = p (dp -
//     delta) in its own registers. K5 stores p and ds [key][query], K6 ds
//     [query][key], at pitch 72 (free of bank conflicts).
//   * Sums. K5's warps sum dv += p^T dO or dk += ds^T q over the tile's 64
//     queries, each for 32 keys in 8 x 8 accumulators (p or ds read as
//     float4 along the sum, dO or q as two float4 of the thread's columns
//     c0 + e, c0 + 32 + e: 16 loads feed 256 FMAs). Their p and ds come
//     from the row group's two scoring warps, which meet at a named
//     barrier of 64 threads. K6's warps sum dq += ds k over the 32 keys
//     they scored: no barrier at all; the two key halves of dq are added
//     once at the end, in a fixed order.
//   * Why: the first design (64 rows, two blocks an SM, one buffer, warps
//     split into s and dp roles with 8 x 8 tiles and two block barriers a
//     tile for p and ds) took 12.49 and 9.90 ms: the exponentials of one
//     role held the other at the barrier (1.9 and 1.7 ms) and the
//     unbuffered stream waited for L2 (1.7 and 1.1). PERF.md §6 has the
//     variants (tools/time_fp32_bwd_variants.py).
//   * Deterministic: every sum runs in a fixed order, no float atomics;
//     K5 and K6 stay two launches (dq is summed in its own block).
// Measured on an H100 80GB HBM3 at 700 W (PERF.md §6), device ms of one
// call at the 518-px model's shape: K5 9.46-9.53 (58% of its bound), K6
// 7.73-7.77 (53%); with delta (0.28) the pair is 1.24x SDPA's whole fp32
// backward (14.06-14.18). The kD = 128 instantiations spill 48-56 bytes.
//
// K5 at head dims 129-256 (flash_bwd_dkdv_wide_simt_kernel). Two 64 x 256
// fp32 accumulators (dk and dv of 64 keys) are 128 registers a thread at
// 256 threads, and 128 staged rows 266 KB: so a block holds kWideKeys = 32
// keys, 8 warps each owning 8 of them, warps 0-3 summing dv and 4-7 dk
// (8 x kD / 32 a lane), K and V staged once, 64-query tiles of q, dO, lse
// and delta by cp.async (lane l holding queries l and l + 32): warps 0-3
// score s^T and store p, warps 4-7 dp^T and, after one barrier, ds; then
// each warp sums its own keys' dv += p^T dO or dk += ds^T q. This is
// csrc/hp_bwd_simt.cu's wide dk/dv launch (K8, K10, K12) with lse and
// delta from the caller and no dq part, on csrc/simt_wide.cuh's keys_dot
// and keys_sum. 218 KB at kD 256: one block an SM, one tile buffer, so
// each tile's load waits behind the last sums; the grid at (1, 1370, 4,
// 256) is 172 blocks on 132 SMs (two waves). What bounds it: the four
// products, 8 B H S^2 D FLOPs (1476 GFLOP at (32, 1370, 12, 256): 22.0
// ms). Measured on an H100 80GB HBM3 at 700 W, device ms of one call
// (tools/time_torch_attention.py, PERF.md §6): 48.15-48.20 there, 46% of
// the bound (csrc/flash_blocked.cu's flash_bwd_dkdv_wide_kernel<float>
// before it: 249.7-250.0; SDPA's whole fp32 backward 55.2-55.3);
// 36.37-36.62 at D 192; 0.778-0.784 at (1, 1370, 4, 256) (3.39-3.41; SDPA
// 0.84). Left out in turn (tools/time_fp32_bwd_variants.py --head_dim
// 256): without the scores 27.4 ms, without the sums 32.4, without the
// stream's copies 40.4 of 48.2; q and dO loaded in column halves under
// the other half's work took 50.7. ptxas: 236 registers at kD 192; 255
// and a 60-byte spill at 256 (keys_dot unrolled once: none, 49.2 ms).
//
// K6 at head dims 129-256 (flash_bwd_dq_wide_simt_kernel). The design
// above would stage 128 rows of q and dO and whole 64-key K and V tiles
// (more than 227 KB at kD 256), and a thread would hold 8 x 8 of a kD-wide
// dq. So, after the wide K4 (csrc/flash_fwd_simt.cu):
//   * A block per (b, h, 64-row query tile), 8 warps, each owning 8 whole
//     rows: lane l holds keys l + 32 j (j < 4) of a 128-key tile on one 8
//     x 4 register tile, first for s, then for dp, and columns
//     wide_col(l, c) (c < kD / 32) of dq, an 8 x kD / 32 accumulator. p
//     goes into the warp's own rows of shared memory, is turned into ds
//     there once dp is scored, and the warp sums dq += ds k from its own
//     rows (__syncwarp): no block barrier but the stream's, no parts
//     scratch, no float atomics, every sum in a fixed order.
//   * q and dO staged once [64][kD + 4] (133 KB at kD 256); K and V stream
//     for the scores in pieces of 128 keys x 32 columns (pitch 36), then K
//     again in pieces of 16 keys x kD for ds k, through one ring of 3
//     slots: each step waits for its piece and starts the copy two steps
//     ahead at one block barrier. 217 KB at kD 256: one block an SM.
//   * The scores read 4 broadcast float4 of q or dO and 4 of K or V a
//     step for 128 FMAs; ds k is keys_sum (csrc/simt_wide.cuh). The last
//     key tile scores only its 32-key groups and sums only its 16-key
//     pieces that hold real keys.
//   * Why 128-key tiles: 64-key ones (8 x 2 tiles, 212 registers) read 10
//     loads for 64 FMAs in the scores and took 38.7 against 35.1 ms at
//     (32, 1370, 12, 256); p kept in registers beside dp (254 registers)
//     timed the same as p through shared memory (244); a fourth slot does
//     not fit beside 128-key pieces (at 64-key tiles it timed the same).
// What bounds it: the three products, 6 B H S^2 D FLOPs (1107 GFLOP at
// (32, 1370, 12, 256): 16.52 ms at 67 TFLOP/s). Measured on an H100 80GB
// HBM3 at 700 W, device ms of one call (tools/time_torch_attention.py,
// PERF.md §6): 35.39-35.40 there, 47% of the bound (csrc/flash_blocked.cu's
// flash_bwd_dq_wide_kernel<float> before it: 155.00-155.01; SDPA's whole
// fp32 backward 55.3-55.6); 27.18-27.35 at D 192 (92.87-93.00); 0.546 at
// (1, 1370, 4, 256), one wave of 88 blocks on 132 SMs (2.03; SDPA 0.84).
// Left out in turn (tools/time_fp32_bwd_variants.py --head_dim 256, event
// ms): without the scores 17.4 of 35.1, without ds k 26.6, without the
// stream's waits 28.9 (without the second read of K 33.7); every piece
// copied twice 40.4. ptxas: 232 (kD 192) and 244 (256) registers, no
// spill.
//
// Plain C++ interface (namespace flash_bwd_simt), called by
// csrc/flash_blocked.cu's host functions on the caller's stream; each
// returns cudaGetLastError(). The kernels allocate nothing.

#include "simt_tiles.cuh"
#include "simt_wide.cuh"

namespace {

// K5. grid (B * H * n_tiles) over kRows-key tiles. Shared memory: K, V of
// the block's keys [kRows][kP]; kBufs buffers of a query tile's q, dO
// [64][kP]; p, ds [key][query] [kRows][72]; lse, delta of each buffered
// query tile [64].
template <int kD, int kRows, int kBufs>
__global__ void __launch_bounds__(Bwd<kD, kRows, kBufs>::kThr,
                                  Bwd<kD, kRows, kBufs>::kThr == 128 ? 2 : 1)
flash_bwd_dkdv_simt_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int H, int S, int D, int n_tiles, float scale,
                           Strides in, Strides og, Strides gr, int vec) {
  typedef Bwd<kD, kRows, kBufs> G;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kRows * G::kP;
  float* qs = vs + kRows * G::kP;         // buffer u: qs + 2 u kTile kP
  float* ps = qs + 2 * kBufs * kTile * G::kP;
  float* dss = ps + kRows * kPS;
  float* lse_s = dss + kRows * kPS;       // buffer u: lse_s + 2 u kTile
  const int bh = blockIdx.x / n_tiles, b = bh / H, h = bh % H;
  const int k0 = (blockIdx.x % n_tiles) * kRows;
  const Place<G::kGroups> at;
  const bool scorer = at.w < 2 * G::kGroups;
  const long long in_off = b * in.sb + h * in.sh;
  const float* qg = q + in_off;
  const float* dog = dout + b * og.sb + h * og.sh;
  const float* lse_g = lse + (long long)bh * S;
  const float* dl_g = delta + (long long)bh * S;
  // the query tile at q0 into buffer u: q, dO, lse and delta, by cp.async
  auto stream = [&](int u, int q0) {
    float* bq = qs + 2 * u * kTile * G::kP;
    copy_tile<kD, kTile, G::kThr>(bq, qg, in.sr, q0, S, D, vec);
    copy_tile<kD, kTile, G::kThr>(bq + kTile * G::kP, dog, og.sr, q0, S, D,
                                  vec);
    if (threadIdx.x < 2 * kTile) {
      const int t = threadIdx.x % kTile;
      const bool ok = q0 + t < S;
      const float* g = threadIdx.x < kTile ? lse_g : dl_g;
      cp_async<4>(lse_s + 2 * u * kTile + threadIdx.x, ok ? g + q0 + t : g,
                  ok);
    }
    cp_async_commit();
  };

  copy_tile<kD, kRows, G::kThr>(ks, k + in_off, in.sr, k0, S, D, vec);
  copy_tile<kD, kRows, G::kThr>(vs, v + in_off, in.sr, k0, S, D, vec);
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
    if (scorer) {
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
    // p and ds of the row group's keys are stored, by its two scoring warps
    if (G::kOwn)
      pair_sync(at.g);
    else
      __syncthreads();
    // dv += p^T dO (half 0), dk += ds^T q (half 1) over the tile's queries
    sum_tile<kD, kTile>(acc, at.half ? dss : ps, at.half ? bq : bdo, at.r0,
                        at.c0);
    if (kBufs == 1) {
      __syncthreads();  // the tile is read: its buffer takes the next one
      if (q0 + kTile < S) stream(0, q0 + kTile);
    }
  }

  const long long g_off = b * gr.sb + h * gr.sh;
  store_tile(at.half ? dk + g_off : dv + g_off, gr.sr, acc, k0, at, S, D,
             at.half ? scale : 1.f);
}

// K6. grid (B * H * n_tiles) over kRows-query tiles. Shared memory: q, dO of
// the block's queries [kRows][kP]; kBufs buffers of a key tile's K, V
// [64][kP]; ds [query][key] [kRows][72] (then the second key half's dq,
// [kRows][kP], over it and the unused p buffer).
template <int kD, int kRows, int kBufs>
__global__ void __launch_bounds__(Bwd<kD, kRows, kBufs>::kThr,
                                  Bwd<kD, kRows, kBufs>::kThr == 128 ? 2 : 1)
flash_bwd_dq_simt_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int H, int S, int D,
                         int n_tiles, float scale, Strides in, Strides og,
                         Strides gr, int vec) {
  typedef Bwd<kD, kRows, kBufs> G;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kRows * G::kP;
  float* ks = dos + kRows * G::kP;        // buffer u: ks + 2 u kTile kP
  float* dss = ks + 2 * kBufs * kTile * G::kP;
  const int bh = blockIdx.x / n_tiles, b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % n_tiles) * kRows;
  const Place<G::kGroups> at;
  const bool scorer = at.w < 2 * G::kGroups;
  const long long in_off = b * in.sb + h * in.sh;
  const float* kg = k + in_off;
  const float* vg = v + in_off;
  // K and V of the key tile at k0 into buffer u
  auto stream = [&](int u, int k0) {
    float* bk = ks + 2 * u * kTile * G::kP;
    copy_tile<kD, kTile, G::kThr>(bk, kg, in.sr, k0, S, D, vec);
    copy_tile<kD, kTile, G::kThr>(bk + kTile * G::kP, vg, in.sr, k0, S, D,
                                  vec);
    cp_async_commit();
  };

  copy_tile<kD, kRows, G::kThr>(qs, q + in_off, in.sr, q0, S, D, vec);
  copy_tile<kD, kRows, G::kThr>(dos, dout + b * og.sb + h * og.sh, og.sr, q0,
                                S, D, vec);
  stream(0, 0);
  // lse and delta of the thread's rows
  float ls[8], dl[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + at.r0 + 4 * i;
    ls[i] = r < S ? lse[(long long)bh * S + r] : 0.f;
    dl[i] = r < S ? delta[(long long)bh * S + r] : 0.f;
  }
  float acc[8][8];  // dq over the tile's keys 32 half .. 32 half + 31
  zero(acc);

  for (int t = 0, k0 = 0; k0 < S; ++t, k0 += kTile) {
    const int u = kBufs == 2 ? t & 1 : 0;
    const float* bk = ks + 2 * u * kTile * G::kP;  // K, then V
    const float* bv = bk + kTile * G::kP;
    cp_async_wait<0>();
    __syncthreads();  // the key tile landed
    // two buffers: the next tile lands in the one every warp has read
    if (kBufs == 2 && k0 + kTile < S) stream(u ^ 1, k0 + kTile);
    if (scorer) {
      // s and dp of the warp's 32 queries and 32 keys; then ds = p (dp -
      // delta), p = exp(s scale - lse) (0 for keys >= S)
      float s[8][4], dp[8][4];
      zero(s);
      zero(dp);
      score_tiles<kD>(s, dp, qs, bk, dos, bv, at.r0, at.c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = at.c + 8 * j;
        const bool ok = k0 + kj < S;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = ok ? exp_p(s[i][j] * scale - ls[i]) : 0.f;
          dss[(at.r0 + 4 * i) * kPS + kj] = p * (dp[i][j] - dl[i]);
        }
      }
    }
    // ds is stored: by this warp when every warp scores (it sums the keys
    // it scored), else by the block's scoring warps
    if (G::kOwn)
      __syncwarp();
    else
      __syncthreads();
    // dq += ds k over the keys 32 half .. 32 half + 31 of the tile
    sum_tile<kD, kTile / 2>(acc, dss + 32 * at.half,
                            bk + 32 * at.half * G::kP, at.r0, at.c0);
    if (kBufs == 1) {
      __syncthreads();  // the tile is read: its buffer takes the next one
      if (k0 + kTile < S) stream(0, k0 + kTile);
    }
  }

  // dq = (first half + second half) scale: the second half's through the
  // ds buffer, once every warp is past its last sum
  float* red = dss;
  if (kBufs == 2) __syncthreads();
  if (at.half) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int g = 0; g < 2; ++g)
        *reinterpret_cast<float4*>(red + (at.r0 + 4 * i) * G::kP + at.c0 +
                                   32 * g) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
  }
  __syncthreads();
  if (at.half) return;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const float4 y = *reinterpret_cast<const float4*>(
          red + (at.r0 + 4 * i) * G::kP + at.c0 + 32 * g);
      acc[i][4 * g] += y.x;
      acc[i][4 * g + 1] += y.y;
      acc[i][4 * g + 2] += y.z;
      acc[i][4 * g + 3] += y.w;
    }
  store_tile(dq + b * gr.sb + h * gr.sh, gr.sr, acc, q0, at, S, D, scale);
}

template <int kD, int kRows, int kBufs>
int launch_dkdv(const float* q, const float* k, const float* v,
                const float* dout, const float* lse, const float* delta,
                float* dk, float* dv, int B, int H, int S, int D, float scale,
                Strides in, Strides og, Strides gr, cudaStream_t stream) {
  typedef Bwd<kD, kRows, kBufs> G;
  int n_tiles;
  unsigned blocks;
  const int rc =
      prepare(flash_bwd_dkdv_simt_kernel<kD, kRows, kBufs>, G::kSmem, kRows,
              B, H, S, &n_tiles, &blocks);
  if (rc) return rc;
  const int vec = rows16({q, k, v, dout}, in, og) ? 1 : 0;
  flash_bwd_dkdv_simt_kernel<kD, kRows, kBufs>
      <<<blocks, G::kThr, G::kSmem, stream>>>(q, k, v, dout, lse, delta, dk,
                                              dv, H, S, D, n_tiles, scale,
                                              in, og, gr, vec);
  return (int)cudaGetLastError();
}

template <int kD, int kRows, int kBufs>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, int B, int H, int S, int D, float scale, Strides in,
              Strides og, Strides gr, cudaStream_t stream) {
  typedef Bwd<kD, kRows, kBufs> G;
  int n_tiles;
  unsigned blocks;
  const int rc =
      prepare(flash_bwd_dq_simt_kernel<kD, kRows, kBufs>, G::kSmem, kRows, B,
              H, S, &n_tiles, &blocks);
  if (rc) return rc;
  const int vec = rows16({q, k, v, dout}, in, og) ? 1 : 0;
  flash_bwd_dq_simt_kernel<kD, kRows, kBufs>
      <<<blocks, G::kThr, G::kSmem, stream>>>(q, k, v, dout, lse, delta, dq,
                                              H, S, D, n_tiles, scale, in, og,
                                              gr, vec);
  return (int)cudaGetLastError();
}

// ---- head dims 129-256: flash_bwd_dkdv_wide_simt_kernel<kD>, kD 192 or 256

// Shared memory: K, V of the block's keys [kWideKeys][kD + 4]; q, dO of a
// query tile [64][kD + 4]; p, ds [key][query] [kWideKeys][kPS]; lse and
// delta of the query tile [2][64].
template <int kD>
constexpr size_t dkdv_wide_smem() {
  return (size_t)(2 * kWideKeys * (kD + 4) + 2 * kTile * (kD + 4) +
                  2 * kWideKeys * kPS + 2 * kTile) * sizeof(float);
}

static_assert(dkdv_wide_smem<256>() <= 227 * 1024,
              "the wide tiles fit a block's 227 KB");

// K5 at head dims 129-256. grid (B * H * n_tiles) over kWideKeys-key tiles.
// Warp w owns keys 8 (w % 4) .. 8 (w % 4) + 7 of the block; for each
// 64-query tile (lane l holding queries l and l + 32) warps 0-3 score s^T
// (K against q) and store p = exp(s scale - lse), warps 4-7 score dp^T (V
// against dO) and, once p is stored, ds = p (dp - delta); then warps 0-3
// sum dv += p^T dO and warps 4-7 dk += ds^T q over the tile, every warp
// from its own rows of p or ds (csrc/simt_wide.cuh's keys_dot and
// keys_sum, as csrc/hp_bwd_simt.cu's wide dk/dv launch without dq's part).
template <int kD>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkdv_wide_simt_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dk,
                                float* __restrict__ dv, int H, int S, int D,
                                int n_tiles, float scale, Strides in,
                                Strides og, Strides gr, int vec) {
  constexpr int kP = kD + 4, kC = kD / 32;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kWideKeys * kP;
  float* qs = vs + kWideKeys * kP;
  float* dos = qs + kTile * kP;
  float* ps = dos + kTile * kP;
  float* dss = ps + kWideKeys * kPS;
  float* ls = dss + kWideKeys * kPS;  // lse [64], then delta [64]
  const int bh = blockIdx.x / n_tiles, b = bh / H, h = bh % H;
  const int k0 = (blockIdx.x % n_tiles) * kWideKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool dk_warp = warp >= 4;
  const int kr = 8 * (warp & 3);       // the warp's first key
  const bool keys_live = k0 + kr < S;  // the warp has a real key
  const long long in_off = b * in.sb + h * in.sh;
  const float* qg = q + in_off;
  const float* dog = dout + b * og.sb + h * og.sh;
  const float* lse_g = lse + (long long)bh * S;
  const float* dl_g = delta + (long long)bh * S;
  // the query tile at q0: q, dO, lse and delta, by cp.async
  auto stream = [&](int q0) {
    copy_tile<kD, kTile, 256>(qs, qg, in.sr, q0, S, D, vec);
    copy_tile<kD, kTile, 256>(dos, dog, og.sr, q0, S, D, vec);
    if (threadIdx.x < 2 * kTile) {
      const int t = threadIdx.x % kTile;
      const bool ok = q0 + t < S;
      const float* g = threadIdx.x < kTile ? lse_g : dl_g;
      cp_async<4>(ls + threadIdx.x, ok ? g + q0 + t : g, ok);
    }
    cp_async_commit();
  };

  copy_tile<kD, kWideKeys, 256>(ks, k + in_off, in.sr, k0, S, D, vec);
  copy_tile<kD, kWideKeys, 256>(vs, v + in_off, in.sr, k0, S, D, vec);
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
          const float l_q = ls[qi];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            ps[(kr + i) * kPS + qi] =
                q_ok && k0 + kr + i < S
                    ? exp_p(__fmul_rn(x[i][j], scale) - l_q)
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
    __syncthreads();  // q, dO, p and ds are read: the next tile may land
    if (q0 + kTile < S) stream(q0 + kTile);
  }

  // dk (times scale) or dv of the warp's real keys
  float* dst = (dk_warp ? dk : dv) + b * gr.sb + h * gr.sh;
  const float mul = dk_warp ? scale : 1.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + kr + i;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = wide_col<kD>(lane, c);
      if (col < D)
        dst[(long long)key * gr.sr + col] = __fmul_rn(acc[i][c], mul);
    }
  }
}

template <int kD>
int launch_dkdv_wide(const float* q, const float* k, const float* v,
                     const float* dout, const float* lse, const float* delta,
                     float* dk, float* dv, int B, int H, int S, int D,
                     float scale, Strides in, Strides og, Strides gr,
                     cudaStream_t stream) {
  constexpr size_t smem = dkdv_wide_smem<kD>();
  int n_tiles;
  unsigned blocks;
  const int rc = prepare(flash_bwd_dkdv_wide_simt_kernel<kD>, smem,
                         kWideKeys, B, H, S, &n_tiles, &blocks);
  if (rc) return rc;
  const int vec = rows16({q, k, v, dout}, in, og) ? 1 : 0;
  flash_bwd_dkdv_wide_simt_kernel<kD><<<blocks, 256, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, S, D, n_tiles, scale, in, og, gr,
      vec);
  return (int)cudaGetLastError();
}

// ---- head dims 129-256: flash_bwd_dq_wide_simt_kernel<kD>, kD 192 or 256

// The wide dq kernel's shape: a lane's keys of a key tile (kDqNJ: 4,
// 128-key tiles, s and then dp on one 8 x 4 register tile beside the 8 x
// kD / 32 accumulator), the floats of a streamed piece and the slots of the
// ring
constexpr int kDqNJ = 4;
constexpr int kDqPiece = 4096;
constexpr int kDqSlots = 3;

// The wide dq kernel's widths at compile-time head dim kD. A warp owns 8
// whole query rows of the block's kRows; lane l holds keys l + 32 j (j <
// kNJ) of a key tile in s and dp, and columns wide_col<kD>(l, c) (c < kNO)
// of dq. K and V stream in pieces of kKeys keys x kKC head-dim columns
// (pitch kKC + 4: the 8 lanes of a quarter-warp read 8 float4 on 32
// distinct banks) for the scores, then K again in pieces of kVR keys x kD
// columns (pitch kD + 4) for ds k, all through one ring of kSlots slots.
// Shared memory: q and dO [kRows][kD + 4], the ring, lse and delta [2]
// [kRows], p and then ds [kRows][kKeys] (each warp's own 8 rows).
template <int kD>
struct DqWide {
  static constexpr int kRows = 64;
  static constexpr int kThr = kRows / 8 * 32;
  static constexpr int kP = kD + 4;
  static constexpr int kNJ = kDqNJ;
  static constexpr int kKeys = 32 * kNJ;
  static constexpr int kKC = kDqPiece / kKeys;
  static constexpr int kKP = kKC + 4;
  static constexpr int kKPieces = kD / kKC;  // of K, and of V, a key tile
  static constexpr int kVR = kDqPiece / 256;
  static constexpr int kRPieces = kKeys / kVR;
  static constexpr int kSteps = 2 * kKPieces + kRPieces;  // of a whole tile
  static constexpr int kSlot =
      kKeys * kKP > kVR * kP ? kKeys * kKP : kVR * kP;
  static constexpr int kSlots = kDqSlots;
  static constexpr int kNO = kD / 32;
  static constexpr size_t kSmem =
      (size_t)(2 * kRows * kP + kSlots * kSlot + 2 * kRows + kRows * kKeys) *
      sizeof(float);
  static_assert((kD == 192 || kD == 256) && kD % kKC == 0, "the wide tiles");
  static_assert(kSmem <= 227 * 1024, "the wide tiles fit a block's 227 KB");
};

// K6 at head dims 129-256. grid (B * H * n_tiles) over 64-row query
// tiles. Per key tile, warp w scores s = q k^T for its 8 rows over the K
// pieces and stores p = exp(s scale - lse) (0 for keys >= S) into its own
// rows of shared memory, scores dp = dO v^T over the V pieces in the same
// registers, turns p into ds = p (dp - delta) in place, and sums dq += ds
// k over the K row pieces that hold real keys (csrc/simt_wide.cuh's
// keys_sum): no barrier but the ring's, and every sum of a row in one warp,
// in a fixed order. Step t waits for its piece, and starts step t + kSlots
// - 1's copy, at one block barrier.
template <int kD>
__global__ void __launch_bounds__(DqWide<kD>::kThr, 1)
flash_bwd_dq_wide_simt_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dq, int H, int S, int D,
                              int n_tiles, float scale, Strides in,
                              Strides og, Strides gr, int vec, int vec_out) {
  typedef DqWide<kD> W;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + W::kRows * W::kP;
  float* ring = dos + W::kRows * W::kP;
  float* ls = ring + W::kSlots * W::kSlot;  // lse [kRows], then delta
  const int bh = blockIdx.x / n_tiles, b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % n_tiles) * W::kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* dsw = ls + 2 * W::kRows + 8 * warp * W::kKeys;  // its p, then ds
  const float* qw = qs + 8 * warp * W::kP;
  const float* dow = dos + 8 * warp * W::kP;
  const float* lw = ls + 8 * warp;
  const bool live = q0 + 8 * warp < S;  // the warp holds a real row
  const long long off = b * in.sb + h * in.sh;
  const float* kg = k + off;
  const float* vg = v + off;
  const int n_kt = (S + W::kKeys - 1) / W::kKeys;
  const int n_steps = (n_kt - 1) * W::kSteps + 2 * W::kKPieces +
                      (S - (n_kt - 1) * W::kKeys + W::kVR - 1) / W::kVR;
  // start step t's copy into its slot (an empty group past the stream):
  // the key tile's K pieces, its V pieces, then its K row pieces
  auto issue = [&](int t) {
    if (t < n_steps) {
      float* dst = ring + t % W::kSlots * W::kSlot;
      const int k0 = t / W::kSteps * W::kKeys, u = t % W::kSteps;
      if (u < 2 * W::kKPieces) {
        const int c = u % W::kKPieces * W::kKC;
        copy_tile<W::kKC, W::kKeys, W::kThr>(
            dst, (u < W::kKPieces ? kg : vg) + c, in.sr, k0, S, D - c, vec);
      } else {
        copy_tile<kD, W::kVR, W::kThr>(
            dst, kg, in.sr, k0 + (u - 2 * W::kKPieces) * W::kVR, S, D, vec);
      }
    }
    cp_async_commit();
  };
  // wait for step t's piece, start step t + kSlots - 1's, return t's; every
  // thread is past step t - 1, so its slot is free
  auto piece = [&](int t) {
    cp_async_wait<W::kSlots - 2>();
    __syncthreads();
    issue(t + W::kSlots - 1);
    return static_cast<const float*>(ring + t % W::kSlots * W::kSlot);
  };

  copy_tile<kD, W::kRows, W::kThr>(qs, q + off, in.sr, q0, S, D, vec);
  copy_tile<kD, W::kRows, W::kThr>(dos, dout + b * og.sb + h * og.sh, og.sr,
                                   q0, S, D, vec);
  cp_async_commit();
  if (threadIdx.x < 2 * W::kRows) {  // lse and delta, 0 past S
    const int r = q0 + threadIdx.x % W::kRows;
    const float* g = threadIdx.x < W::kRows ? lse : delta;
    ls[threadIdx.x] = r < S ? g[(long long)bh * S + r] : 0.f;
  }
#pragma unroll
  for (int t = 0; t < W::kSlots - 1; ++t) issue(t);
  float acc[8][W::kNO];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < W::kNO; ++c) acc[i][c] = 0.f;

  int t = 0;
  for (int k0 = 0; k0 < S; k0 += W::kKeys) {
    const int nk = min(W::kKeys, S - k0);  // the tile's real keys
    const int nj = (nk + 31) >> 5;         // and 32-key groups
    float x[8][W::kNJ];  // s, then dp, of the warp's rows and lane's keys
    zero(x);
    for (int c = 0; c < W::kKPieces; ++c) {
      const float* kc = piece(t++);
      if (live)
        wide_scores_n<W::kKC, W::kP, W::kKP, W::kNJ>(
            nj, x, qw + c * W::kKC, kc + lane * W::kKP);
    }
    // p into the warp's rows: each lane writes, and reads back for ds, its
    // own keys' entries alone
    if (live) {
#pragma unroll
      for (int j = 0; j < W::kNJ; ++j) {
        const bool ok = lane + 32 * j < nk;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dsw[i * W::kKeys + lane + 32 * j] =
              ok ? exp_p(__fmul_rn(x[i][j], scale) - lw[i]) : 0.f;
      }
    }
    zero(x);
    for (int c = 0; c < W::kKPieces; ++c) {
      const float* vc = piece(t++);
      if (live)
        wide_scores_n<W::kKC, W::kP, W::kKP, W::kNJ>(
            nj, x, dow + c * W::kKC, vc + lane * W::kKP);
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < W::kNJ; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float* at = dsw + i * W::kKeys + lane + 32 * j;
          *at *= x[i][j] - lw[W::kRows + i];  // ds = p (dp - delta)
        }
      __syncwarp();  // the warp's rows of ds are stored
    }
    // dq += ds k over the K row pieces that hold real keys (ds and K are 0
    // past S in the last one)
    for (int g = 0; g < (nk + W::kVR - 1) / W::kVR; ++g) {
      const float* kr = piece(t++);
      if (live)
        keys_sum<kD, W::kVR, W::kKeys>(acc, dsw + g * W::kVR, kr, lane);
    }
  }

  if (!live) return;
  float* dst = dq + b * gr.sb + h * gr.sh;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + 8 * warp + i;
    if (r >= S) break;  // the same r in every lane
    float y[W::kNO];
#pragma unroll
    for (int c = 0; c < W::kNO; ++c) y[c] = __fmul_rn(acc[i][c], scale);
    float* row = dst + (long long)r * gr.sr;
    store_o(row, wide_col<kD>(lane, 0), y, 4, D, vec_out);
    store_o(row, wide_col<kD>(lane, 4), y + 4, W::kNO - 4, D, vec_out);
  }
}

template <int kD>
int launch_dq_wide(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   float* dq, int B, int H, int S, int D, float scale,
                   Strides in, Strides og, Strides gr, cudaStream_t stream) {
  typedef DqWide<kD> W;
  int n_tiles;
  unsigned blocks;
  const int rc = prepare(flash_bwd_dq_wide_simt_kernel<kD>, W::kSmem,
                         W::kRows, B, H, S, &n_tiles, &blocks);
  if (rc) return rc;
  const int vec = rows16({q, k, v, dout}, in, og) ? 1 : 0;
  const int vec_out = rows16({dq}, gr, gr) ? 1 : 0;
  flash_bwd_dq_wide_simt_kernel<kD><<<blocks, W::kThr, W::kSmem, stream>>>(
      q, k, v, dout, lse, delta, dq, H, S, D, n_tiles, scale, in, og, gr, vec,
      vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

// The instantiations: at D <= 64 128 rows a block with both streamed
// buffers (one block an SM); at D <= 128 64 rows with one (two buffers
// would take 235 KB).
#define VTX_BWD_SIMT_64 64, 128, 2
#define VTX_BWD_SIMT_128 128, 64, 1

namespace flash_bwd_simt {

// dk, dv (strides gr) from q, k, v (strides in), dout (og), lse and delta
// (B, H, S) fp32; 1 <= D <= 256.
int dkdv(const float* q, const float* k, const float* v, const float* dout,
         const float* lse, const float* delta, float* dk, float* dv, int B,
         int H, int S, int D, float scale, const long long* in,
         const long long* og, const long long* gr, cudaStream_t stream) {
  const Strides i{in[0], in[1], in[2]}, o{og[0], og[1], og[2]},
      g{gr[0], gr[1], gr[2]};
  if (D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  if (D <= 64)
    return launch_dkdv<VTX_BWD_SIMT_64>(q, k, v, dout, lse, delta, dk, dv, B,
                                        H, S, D, scale, i, o, g, stream);
  if (D <= 128)
    return launch_dkdv<VTX_BWD_SIMT_128>(q, k, v, dout, lse, delta, dk, dv,
                                         B, H, S, D, scale, i, o, g, stream);
  if (D <= 192)
    return launch_dkdv_wide<192>(q, k, v, dout, lse, delta, dk, dv, B, H, S,
                                 D, scale, i, o, g, stream);
  return launch_dkdv_wide<256>(q, k, v, dout, lse, delta, dk, dv, B, H, S, D,
                               scale, i, o, g, stream);
}

// dq (strides gr) from the same inputs.
int dq(const float* q, const float* k, const float* v, const float* dout,
       const float* lse, const float* delta, float* dq, int B, int H, int S,
       int D, float scale, const long long* in, const long long* og,
       const long long* gr, cudaStream_t stream) {
  const Strides i{in[0], in[1], in[2]}, o{og[0], og[1], og[2]},
      g{gr[0], gr[1], gr[2]};
  if (D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  if (D <= 64)
    return launch_dq<VTX_BWD_SIMT_64>(q, k, v, dout, lse, delta, dq, B, H, S,
                                      D, scale, i, o, g, stream);
  if (D <= 128)
    return launch_dq<VTX_BWD_SIMT_128>(q, k, v, dout, lse, delta, dq, B, H,
                                       S, D, scale, i, o, g, stream);
  if (D <= 192)
    return launch_dq_wide<192>(q, k, v, dout, lse, delta, dq, B, H, S, D,
                               scale, i, o, g, stream);
  return launch_dq_wide<256>(q, k, v, dout, lse, delta, dq, B, H, S, D, scale,
                             i, o, g, stream);
}

}  // namespace flash_bwd_simt
