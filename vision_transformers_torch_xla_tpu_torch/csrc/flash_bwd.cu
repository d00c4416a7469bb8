// Blocked flash attention backward on Hopper's tensor cores: K5 and K6 in
// bf16 and fp16 at head dims up to 256.
//
// Replaces the TPU kernels of vision_transformers_torch_xla_tpu/ops/
// flash_blocked.py, the backward of the long-sequence path (S > 1024); the
// forward (K4) is csrc/flash_fwd.cu. T is the element type:
//   K5 flash_bwd_dkdv_kernel <- _bwd_dkdv_kernel (:109): per key row, over
//      query tiles, p = exp((q k^T) scale - lse), dv += T(p)^T dO,
//      ds = p (dO v^T - delta), dk += T(ds)^T q; dk *= scale.
//   K6 flash_bwd_dq_kernel   <- _bwd_dq_kernel (:157): per query row, over
//      key tiles, the same p and ds, dq += T(ds) k; dq *= scale
//      (flash_bwd_dq_tc_wide_kernel at head dims 129-256).
// delta = rowsum(fp32 dO * fp32 O) comes from the caller (a torch op, as in
// JAX it is computed outside Pallas). Every product is T x T into fp32,
// what wgmma computes, so the cast order is the TPU kernels'. The
// exponentials run as exp2f: p = exp2(s (scale log2 e) - lse log2 e), which
// moves p by a relative ~1e-6 against expf (csrc/flash_fwd.cu says why),
// far below the 2^-9 (bf16) and 2^-12 (fp16) of its rounding to T. The
// fp32 versions are csrc/flash_bwd_simt.cu's (to 128) and the CUDA-core
// loops of csrc/flash_blocked.cu (past 128), which also take K5 and K6
// past 256 in every dtype.
//
// What bounds them on an H100: at S = 1370, D = 64 one (b, h) is 8 S^2 D
// (K5: s, dp, dv, dk) and 6 S^2 D (K6: s, dp, dq) over < 1 MB of operands,
// hundreds of FLOP per byte: the products bound them. At B = 32, 12 heads
// the least time at the H100 SXM's 989 TFLOP/s bf16 peak is 0.373 ms (K5)
// and 0.280 ms (K6); the S^2 exponentials of each (7.2e8 a call) on the
// special-function units are a second floor of about K4's size.
//
// Design (warp-specialised, one block per 128 stationary rows of one (b, h):
// two consumer warpgroups and a producer, a warp for K6 (288 threads), a
// warpgroup that lends the consumers its registers for K5 (384); two
// kernels, so that no sum crosses blocks: no float atomics, a
// deterministic result):
// * K5 holds 128 keys still. One warp of the producer warpgroup loads K and
//   V once through TMA, then streams tiles of 64 queries (Q and dO through a
//   2-stage ring, with the tiles' lse and delta rows, which its lanes store
//   beside them). Each
//   of two consumer warpgroups owns 64 keys: S^T = K Q^T and dP^T = V dO^T
//   are wgmma m64n64k16 with both operands K-major in shared memory, as
//   stored; P^T = exp2(...) and dS^T = P^T (dP^T - delta) in fp32 registers,
//   keys >= S masked to p = 0; then dV += T(P^T) dO and dK += T(dS^T) Q are
//   wgmma with the accumulator fragments packed as the register A operand
//   (as K4 feeds P) and dO and Q read as MN-major B operands (the transpose
//   bit, as K4 reads V). dK is scaled once at the end.
// * K5 at head dims 192 and 256 (the wide tiles, csrc/hp_bwd_tc.cu's
//   split): each warpgroup cannot own 64 keys, since two accumulators of 64
//   x 256 fp32 are 256 registers a thread, and 128 keys of K and V with a
//   2-stage ring of q and dO are 256 KB. So a block holds 64 keys (K and V
//   64 KB at 256, q and dO in a 2-stage ring, 128 KB: 192 KB), and both
//   consumer warpgroups share them and split the outputs: warpgroup 0
//   computes S^T, P^T and dV += T(P^T) dO; warpgroup 1 S^T, dP^T, dS^T and
//   dK += T(dS^T) Q. Each holds one 64 x D accumulator (128 registers at
//   256) with 32 (S^T) or 64 (S^T, dP^T) more; the producer warpgroup keeps
//   24 registers, so a consumer thread has 240. S^T is computed by both, so
//   a (key tile, query tile) runs 5 products of 64 x 64 x D where 4 would
//   do, 3 of them on warpgroup 1's critical path, as at D = 128. m64n128
//   products over pairs of 64-column panels (and m64n64 for the odd panel
//   at 192) accumulate dV and dK.
// * K6 holds 128 queries still: Q, dO, lse and delta once, K and V tiles of
//   64 keys through the ring. S = Q K^T and dP = dO V^T as SS wgmma, keys
//   >= S masked to p = 0, dS = P (dP - delta), dQ += T(dS) K as RS wgmma
//   with K MN-major; dQ is scaled once at the end.
// * K6 at head dims 192 and 256 (flash_bwd_dq_tc_wide_kernel, the shape
//   of csrc/attn_bwd_tc.cu's wide dq): 128 stationary queries of Q and dO
//   are 128 KB at 256, and a 2-stage ring of 64-key K and V tiles another
//   128 KB, more than a block's 227 KB; a 64 x 256 fp32 dQ is 128
//   registers a thread beside S and dP. So a block holds 64 queries on one
//   consumer warpgroup (Q and dO 64 KB, the ring 128 KB: 192 KB) with a
//   producer warp, and dQ += T(dS) K runs m64n128 over pairs of 64-column
//   panels (m64n64 for the odd panel at 192). At (B, S, H) = (1, 1370, 4)
//   that is 88 blocks for the 132 SMs, one block an SM. Device ms of one
//   call on an H100 80GB HBM3 at 700 W (PERF.md §6): 0.042 there (the
//   CUDA-core loop it replaced 1.99-2.01), 2.51-2.54 at (32, 1370, 12,
//   256) (44-45% of the bound; the loop 153-156); fp16 K6 at (32, 1370,
//   12, 64) 1.055 (the loop 11.47-11.56).
// * Rows >= S: TMA fills q, dO, k and v rows past the end with zeros; lse
//   and delta of such rows read as 0, never past the end, so p stays finite
//   and the zero dO rows make those rows' dv and dk terms vanish (the TPU
//   kernel's argument, :113-115). No row >= S is stored.
// * Tiles are csrc/hopper.cuh's panels of 64 columns, 128-byte swizzled,
//   read through 4-D (D, S, H, B) tensor maps in [64 rows][64 columns]
//   boxes with the caller's strides, so views of a fused (B, S, 3 H D)
//   projection need no copy. dq, dk and dv are written by the consumers as
//   pairs of T in the caller's grad layout.
// * Grids are one-dimensional over (b h, stationary tile), so B H is bounded
//   only by 2^31 / ceil(S / 128).
//
// Plain C interface, loaded with ctypes. The kernels allocate nothing and
// launch on the caller's stream; each host function returns
// cudaGetLastError(), or a code >= kErrEncodeBase when a tensor map could
// not be encoded (vtx_cuda_error_string says which). The caller
// (ops/flash_blocked.py) checks the shapes: 1 <= D <= 256, D a multiple of
// 8, 16-byte-aligned data and strides of q, k, v and dO. A head dim between
// the compiled ones (64, 128, 192, 256) takes the next, its columns
// zero-filled by TMA.

#include <limits.h>

#include "elem.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 64;          // rows of a streamed tile, and of a warpgroup
constexpr int kBlockRows = 128;    // stationary rows of a block
constexpr int kStages = 2;         // ring depth of the streamed tiles
constexpr int kConsumerWarps = 8;  // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
// K5 keeps four accumulators per consumer thread (S^T, dP^T, dK, dV: 192
// floats at D = 128), more than the 168 registers a thread may have in a
// block of 288 or 384. So its producer is a whole warpgroup, which gives
// its registers to the consumers: launched at 168 a thread (the launch
// bound's cap, which setmaxnreg requires), the producer warpgroup drops to
// kProducerRegs and the consumers rise to kConsumerRegs, 128 x 40 + 256 x
// 232 = 384 x 168.
constexpr int kDkdvThreads = 32 * kConsumerWarps + 128;
constexpr int kStreamPanel = kRows * kPanel;        // 8 KB
constexpr int kFixedPanel = kBlockRows * kPanel;    // 16 KB
constexpr uint32_t kStreamBytes = kStreamPanel * 2;  // LBO of an MN-major tile
constexpr int kMaxHeadDim = 256;  // K5's and K6's

// K5 at head dim kD: the stationary keys of a block and the producer's and
// consumers' registers. Up to 128 each warpgroup owns 64 of 128 keys,
// 128 x 40 + 256 x 232 = 384 x 168; at 192 and 256 (kSplit) both share 64
// keys, dV on warpgroup 0 and dK on warpgroup 1, 128 x 24 + 256 x 240 =
// 384 x 168 (setmaxnreg's least, so that a consumer gets 240).
template <int kD>
struct DkdvShape {
  static constexpr bool kSplit = kD > 128;
  static constexpr int kKeys = kSplit ? kRows : kBlockRows;
  static constexpr int kProducerRegs = kSplit ? 24 : 40;
  static constexpr int kConsumerRegs = kSplit ? 240 : 232;
};

// Shared tiles of K5; every panel is a multiple of 1024 bytes, so each stays
// aligned to the swizzle atom when the struct is. lse is kept times log2 e.
template <typename T, int kD>
struct DkdvTiles {
  T k[kD / kPanel][DkdvShape<kD>::kKeys * kPanel];
  T v[kD / kPanel][DkdvShape<kD>::kKeys * kPanel];
  T q[kStages][kD / kPanel][kStreamPanel];
  T dout[kStages][kD / kPanel][kStreamPanel];
  float lse[kStages][kRows];
  float delta[kStages][kRows];
};

static_assert(sizeof(DkdvTiles<bf16, 256>) + 1024 <= 227 * 1024,
              "the widest tiles fit a block's 227 KB");

// Shared tiles of K6 to D 128.
template <typename T, int kD>
struct DqTiles {
  T q[kD / kPanel][kFixedPanel];
  T dout[kD / kPanel][kFixedPanel];
  T k[kStages][kD / kPanel][kStreamPanel];
  T v[kStages][kD / kPanel][kStreamPanel];
};

// K6 at head dims 192 and 256 (the wide tiles): 64 stationary queries on
// one consumer warpgroup and a producer warp; q and dO 64 KB at 256, the
// 2-stage ring of K and V 128 KB.
constexpr int kWideDqThreads = 128 + 32;

template <typename T, int kD>
struct WideDqTiles {
  T q[kD / kPanel][kStreamPanel];
  T dout[kD / kPanel][kStreamPanel];
  T k[kStages][kD / kPanel][kStreamPanel];
  T v[kStages][kD / kPanel][kStreamPanel];
};

static_assert(sizeof(WideDqTiles<bf16, 256>) + 1024 <= 227 * 1024,
              "the wide K6 tiles fit a block's 227 KB");

template <typename T>
__device__ __forceinline__ T& aligned_tiles(uint8_t* raw) {
  // the swizzle atom is 1024 bytes: align the tiles to it
  return *reinterpret_cast<T*>(raw +
                               ((1024 - (smem_addr(raw) & 1023)) & 1023));
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Write the accumulator of a m64 x kD product, times mul, as T rows r0 and
// r0 + 8 (those < S) and columns 8 n + col (< D) of one head.
template <typename T, int N>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, long long sr,
                                           const float (&acc)[N], int r0,
                                           int col, int S, int D, float mul) {
  typedef typename Elem<T>::Pair Pair;
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    const int c = 8 * n + col;
    if (c >= D) continue;
    if (r0 < S)
      *reinterpret_cast<Pair*>(dst + r0 * sr + c) =
          Elem<T>::store2(acc[4 * n] * mul, acc[4 * n + 1] * mul);
    if (r1 < S)
      *reinterpret_cast<Pair*>(dst + r1 * sr + c) =
          Elem<T>::store2(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
  }
}

// acc += A B over 4 steps of 16 rows of a streamed [64][kD] tile B read
// MN-major, A the packed register fragments of those rows (K5's dV and dK
// products): up to D = 128 one m64nD product a step; the wide head dims
// m64n128 over pairs of 64-column panels (and m64n64 for an odd one).
template <typename T, int N>
__device__ __forceinline__ void issue_rs(float (&acc)[N],
                                         const uint32_t (&a)[4][4],
                                         T (*b)[kStreamPanel]) {
#pragma unroll
  for (int c = 0; c < kRows / 16; ++c) {
    if constexpr (N <= 64) {
      wgmma_rs<T>(acc, a[c],
                  desc(&b[0][c * 16 * kPanel], kStreamBytes, 1024));
    } else {
#pragma unroll
      for (int p = 0; p + 2 <= N / 32; p += 2)
        wgmma_rs<T>(*reinterpret_cast<float(*)[64]>(&acc[32 * p]), a[c],
                    desc(&b[p][c * 16 * kPanel], kStreamBytes, 1024));
      if constexpr ((N / 32) % 2) {
        constexpr int p = N / 32 - 1;
        wgmma_rs<T>(*reinterpret_cast<float(*)[32]>(&acc[32 * p]), a[c],
                    desc(&b[p][c * 16 * kPanel], kStreamBytes, 1024));
      }
    }
  }
}

// K5. grid (ceil(S / kKeys) * B * H): block x is key tile x % n_kt of
// (b, h) = x / n_kt. Accumulator fragments (wgmma m64nN, f32): thread t of
// a warpgroup, warp w = t / 32, lane l, holds d[4n + j] at row 16 w + l / 4
// + 8 (j / 2), column 8 n + 2 (l % 4) + (j % 2). Rows are keys, columns of
// S^T and dP^T are the tile's queries, columns of dK and dV the head dim.
template <typename T, int kD>
__global__ void __launch_bounds__(kDkdvThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int S, int D, int n_kt,
                      float scale, float scale_log2, Layout gr) {
  constexpr int kPanels = kD / kPanel;
  constexpr int kKeys = DkdvShape<kD>::kKeys;  // stationary keys of a block
  constexpr bool kSplit = DkdvShape<kD>::kSplit;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  DkdvTiles<T, kD>& t = aligned_tiles<DkdvTiles<T, kD>>(smem_raw);

  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * kKeys;
  const int b = bh / H, h = bh % H;
  const int n_qt = (S + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(&kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 32);  // the producer warp's lanes
      bar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer warpgroup: its registers go to the consumers; one warp
    // loads K and V once, then Q and dO tiles through the ring, and every
    // lane of it stores two of the tile's lse and delta rows, then arrives
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        DkdvShape<kD>::kProducerRegs));
    if (warp != kConsumerWarps) return;
    if (lane == 0) {
      bar_expect_tx(&kv_full, 2 * kKeys * kD * 2);
      for (int p = 0; p < kPanels; ++p)
        for (int r = 0; r < kKeys; r += kRows) {
          tma_load(&t.k[p][r * kPanel], &tk, &kv_full, p * kPanel, k0 + r, h,
                   b);
          tma_load(&t.v[p][r * kPanel], &tv, &kv_full, p * kPanel, k0 + r, h,
                   b);
        }
    }
    const float* lse_g = lse + (long long)bh * S;
    const float* dl_g = delta + (long long)bh * S;
    for (int j = 0; j < n_qt; ++j) {
      const int s = j % kStages;
      const int q0 = j * kRows;
      if (j >= kStages) bar_wait(&empty[s], ((j / kStages) - 1) & 1);
      for (int i = lane; i < kRows; i += 32) {
        const bool ok = q0 + i < S;
        t.lse[s][i] = ok ? lse_g[q0 + i] * kLog2e : 0.f;
        t.delta[s][i] = ok ? dl_g[q0 + i] : 0.f;
      }
      if (lane == 0) {
        bar_expect_tx(&full[s], 2 * kRows * kD * 2);
        for (int p = 0; p < kPanels; ++p) {
          tma_load(t.q[s][p], &tq, &full[s], p * kPanel, q0, h, b);
          tma_load(t.dout[s][p], &tdo, &full[s], p * kPanel, q0, h, b);
        }
      } else {
        bar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64), or
  // with kSplit the block's 64 keys and one of dV (wg 0) and dK (wg 1)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      DkdvShape<kD>::kConsumerRegs));
  const int wg = warp / 4;
  const int row = 16 * (warp % 4) + lane / 4;  // and row + 8, in the group
  const int col = 2 * (lane % 4);
  const int key0 = k0 + (kSplit ? 0 : wg * kRows) + row;
  const bool ok0 = key0 < S, ok1 = key0 + 8 < S;
  if constexpr (kSplit) {
    const bool dk_group = wg == 1;
    float acc[kD / 2];  // dV for group 0, dK for group 1
    float s[32], dp[32];
    zero(acc);
    zero(s);
    zero(dp);

    bar_wait(&kv_full, 0);
    for (int j = 0; j < n_qt; ++j) {
      const int st = j % kStages;
      bar_wait(&full[st], (j / kStages) & 1);

      // S^T = K Q^T, and for group 1 dP^T = V dO^T
      pin(s);
      pin(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const int p = kk / 4, c = (kk % 4) * 16;
        wgmma_ss_n64<T>(s, desc(&t.k[p][c], 16, 1024),
                        desc(&t.q[st][p][c], 16, 1024), kk > 0);
      }
      if (dk_group) {
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          const int p = kk / 4, c = (kk % 4) * 16;
          wgmma_ss_n64<T>(dp, desc(&t.v[p][c], 16, 1024),
                          desc(&t.dout[st][p][c], 16, 1024), kk > 0);
        }
      }
      wg_commit();
      wg_wait();
      pin(s);
      pin(dp);

      // group 0: T(P^T); group 1: T(dS^T) = T(P^T (dP^T - delta)), packed
      // as A fragments in the order of the D <= 128 kernel's registers
      uint32_t fa[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int qc = 8 * n + col;
        const float l0 = t.lse[st][qc], l1 = t.lse[st][qc + 1];
        float p0 = ok0 ? exp2f(fmaf(s[4 * n], scale_log2, -l0)) : 0.f;
        float p1 = ok0 ? exp2f(fmaf(s[4 * n + 1], scale_log2, -l1)) : 0.f;
        float p2 = ok1 ? exp2f(fmaf(s[4 * n + 2], scale_log2, -l0)) : 0.f;
        float p3 = ok1 ? exp2f(fmaf(s[4 * n + 3], scale_log2, -l1)) : 0.f;
        if (dk_group) {
          const float d0 = t.delta[st][qc], d1 = t.delta[st][qc + 1];
          p0 *= dp[4 * n] - d0;
          p1 *= dp[4 * n + 1] - d1;
          p2 *= dp[4 * n + 2] - d0;
          p3 *= dp[4 * n + 3] - d1;
        }
        fa[n / 2][(n % 2) * 2] = pack2<T>(p0, p1);
        fa[n / 2][(n % 2) * 2 + 1] = pack2<T>(p2, p3);
      }

      // group 0: dV += T(P^T) dO; group 1: dK += T(dS^T) Q
      pin(acc);
      wg_fence();
      issue_rs<T>(acc, fa, dk_group ? t.q[st] : t.dout[st]);
      wg_commit();
      wg_wait();
      pin(acc);

      // this warp is done with the stage
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[st]);
    }

    const long long g_off = b * gr.sb + h * gr.sh;
    store_rows((dk_group ? dk : dv) + g_off, gr.sr, acc, key0, col, S, D,
               dk_group ? scale : 1.f);
  } else {
  float dk_acc[kD / 2], dv_acc[kD / 2];
  float s[32], dp[32];
  zero(dk_acc);
  zero(dv_acc);
  zero(s);
  zero(dp);

  bar_wait(&kv_full, 0);
  for (int j = 0; j < n_qt; ++j) {
    const int st = j % kStages;
    bar_wait(&full[st], (j / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T over kD / 16 steps of 16 columns
    pin(s);
    pin(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      wgmma_ss_n64<T>(s, desc(&t.k[p][wg * kRows * kPanel + c], 16, 1024),
                      desc(&t.q[st][p][c], 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      wgmma_ss_n64<T>(dp, desc(&t.v[p][wg * kRows * kPanel + c], 16, 1024),
                      desc(&t.dout[st][p][c], 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

    // P^T and dS^T in fp32, packed to T A fragments: queries 16 c ..
    // 16 c + 15 are registers (row, lo 8), (row + 8, lo 8), (row, hi 8),
    // (row + 8, hi 8)
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int qc = 8 * n + col;
      const float l0 = t.lse[st][qc], l1 = t.lse[st][qc + 1];
      const float d0 = t.delta[st][qc], d1 = t.delta[st][qc + 1];
      const float p0 = ok0 ? exp2f(fmaf(s[4 * n], scale_log2, -l0)) : 0.f;
      const float p1 = ok0 ? exp2f(fmaf(s[4 * n + 1], scale_log2, -l1)) : 0.f;
      const float p2 = ok1 ? exp2f(fmaf(s[4 * n + 2], scale_log2, -l0)) : 0.f;
      const float p3 = ok1 ? exp2f(fmaf(s[4 * n + 3], scale_log2, -l1)) : 0.f;
      pa[n / 2][(n % 2) * 2] = pack2<T>(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack2<T>(p2, p3);
      dsa[n / 2][(n % 2) * 2] =
          pack2<T>(p0 * (dp[4 * n] - d0), p1 * (dp[4 * n + 1] - d1));
      dsa[n / 2][(n % 2) * 2 + 1] =
          pack2<T>(p2 * (dp[4 * n + 2] - d0), p3 * (dp[4 * n + 3] - d1));
    }

    // dV += T(P^T) dO, dK += T(dS^T) Q over 4 steps of 16 queries
    pin(dv_acc);
    pin(dk_acc);
    wg_fence();
#pragma unroll
    for (int c = 0; c < kRows / 16; ++c)
      wgmma_rs<T>(dv_acc, pa[c],
                  desc(&t.dout[st][0][c * 16 * kPanel], kStreamBytes, 1024));
#pragma unroll
    for (int c = 0; c < kRows / 16; ++c)
      wgmma_rs<T>(dk_acc, dsa[c],
                  desc(&t.q[st][0][c * 16 * kPanel], kStreamBytes, 1024));
    wg_commit();
    wg_wait();
    pin(dv_acc);
    pin(dk_acc);

    // this warp is done with the stage
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);
  }

  const long long g_off = b * gr.sb + h * gr.sh;
  store_rows(dv + g_off, gr.sr, dv_acc, key0, col, S, D, 1.f);
  store_rows(dk + g_off, gr.sr, dk_acc, key0, col, S, D, scale);
  }
}

// K6. grid (ceil(S / 128) * B * H): block x is query tile x % n_qt of
// (b, h) = x / n_qt. Rows of every fragment are queries; columns of S and
// dP are the tile's keys, columns of dQ the head dim.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int S, int D, int n_qt, float scale,
                    float scale_log2, Layout gr) {
  constexpr int kPanels = kD / kPanel;
  constexpr int kTileBytes = kRows * kD * 2;  // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages], v_full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  DqTiles<T, kD>& t = aligned_tiles<DqTiles<T, kD>>(smem_raw);

  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kBlockRows;
  const int b = bh / H, h = bh % H;
  const int n_kt = (S + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&k_full[s], 1);
      bar_init(&v_full[s], 1);
      bar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: Q and dO once, then K and V tiles through the ring
    if (lane == 0) {
      bar_expect_tx(&q_full, 2 * kBlockRows * kD * 2);
      for (int p = 0; p < kPanels; ++p)
        for (int r = 0; r < kBlockRows; r += kRows) {
          tma_load(&t.q[p][r * kPanel], &tq, &q_full, p * kPanel, q0 + r, h,
                   b);
          tma_load(&t.dout[p][r * kPanel], &tdo, &q_full, p * kPanel, q0 + r,
                   h, b);
        }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        if (j >= kStages) bar_wait(&empty[s], ((j / kStages) - 1) & 1);
        bar_expect_tx(&k_full[s], kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(t.k[s][p], &tk, &k_full[s], p * kPanel, j * kRows, h, b);
        bar_expect_tx(&v_full[s], kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(t.v[s][p], &tv, &v_full[s], p * kPanel, j * kRows, h, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns queries [q0 + 64 wg, q0 + 64 wg + 64)
  const int wg = warp / 4;
  const int row = 16 * (warp % 4) + lane / 4;  // and row + 8, in the group
  const int col = 2 * (lane % 4);
  const int r0 = q0 + wg * kRows + row, r1 = r0 + 8;
  const long long rows = (long long)bh * S;
  const float lse0 = r0 < S ? lse[rows + r0] * kLog2e : 0.f;
  const float lse1 = r1 < S ? lse[rows + r1] * kLog2e : 0.f;
  const float dl0 = r0 < S ? delta[rows + r0] : 0.f;
  const float dl1 = r1 < S ? delta[rows + r1] : 0.f;
  float dq_acc[kD / 2];
  float s[32], dp[32];
  zero(dq_acc);
  zero(s);
  zero(dp);

  bar_wait(&q_full, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kStages;
    const uint32_t phase = (j / kStages) & 1;
    const int kb = j * kRows;
    bar_wait(&k_full[st], phase);
    bar_wait(&v_full[st], phase);

    // S = Q K^T and dP = dO V^T over kD / 16 steps of 16 columns
    pin(s);
    pin(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      wgmma_ss_n64<T>(s, desc(&t.q[p][wg * kRows * kPanel + c], 16, 1024),
                      desc(&t.k[st][p][c], 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      wgmma_ss_n64<T>(dp,
                      desc(&t.dout[p][wg * kRows * kPanel + c], 16, 1024),
                      desc(&t.v[st][p][c], 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

    // dS = P (dP - delta) in fp32, keys >= S masked, packed to T A
    // fragments
    uint32_t dsa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int kc = kb + 8 * n + col;
      const bool okc0 = kc < S, okc1 = kc + 1 < S;
      const float p0 = okc0 ? exp2f(fmaf(s[4 * n], scale_log2, -lse0)) : 0.f;
      const float p1 =
          okc1 ? exp2f(fmaf(s[4 * n + 1], scale_log2, -lse0)) : 0.f;
      const float p2 =
          okc0 ? exp2f(fmaf(s[4 * n + 2], scale_log2, -lse1)) : 0.f;
      const float p3 =
          okc1 ? exp2f(fmaf(s[4 * n + 3], scale_log2, -lse1)) : 0.f;
      dsa[n / 2][(n % 2) * 2] =
          pack2<T>(p0 * (dp[4 * n] - dl0), p1 * (dp[4 * n + 1] - dl0));
      dsa[n / 2][(n % 2) * 2 + 1] =
          pack2<T>(p2 * (dp[4 * n + 2] - dl1), p3 * (dp[4 * n + 3] - dl1));
    }

    // dQ += T(dS) K over 4 steps of 16 keys
    pin(dq_acc);
    wg_fence();
#pragma unroll
    for (int c = 0; c < kRows / 16; ++c)
      wgmma_rs<T>(dq_acc, dsa[c],
                  desc(&t.k[st][0][c * 16 * kPanel], kStreamBytes, 1024));
    wg_commit();
    wg_wait();
    pin(dq_acc);

    // this warp is done with the stage's K and V
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);
  }

  store_rows(dq + b * gr.sb + h * gr.sh, gr.sr, dq_acc, r0, col, S, D,
             scale);
}

// K6 at head dims 192 and 256 (the wide tiles; the header says why). grid
// (ceil(S / 64) * B * H): block x is query tile x % n_qt (64 queries) of
// (b, h) = x / n_qt, on one consumer warpgroup; fragments as K6's, dQ +=
// T(dS) K m64n128 over pairs of 64-column panels (and m64n64 for the odd
// panel at 192).
template <typename T, int kD>
__global__ void __launch_bounds__(kWideDqThreads, 1)
flash_bwd_dq_tc_wide_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dq, int H, int S, int D,
                            int n_qt, float scale, float scale_log2,
                            Layout gr) {
  constexpr int kPanels = kD / kPanel;
  constexpr uint32_t kTileBytes = 2 * kRows * kD * 2;  // one K and V tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  WideDqTiles<T, kD>& t = aligned_tiles<WideDqTiles<T, kD>>(smem_raw);

  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kRows;
  const int b = bh / H, h = bh % H;
  const int n_kt = (S + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    // producer: Q and dO once, then K and V tiles through the ring
    if (lane == 0) {
      bar_expect_tx(&q_full, 2 * kRows * kD * 2);
      for (int p = 0; p < kPanels; ++p) {
        tma_load(t.q[p], &tq, &q_full, p * kPanel, q0, h, b);
        tma_load(t.dout[p], &tdo, &q_full, p * kPanel, q0, h, b);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        if (j >= kStages) bar_wait(&empty[s], ((j / kStages) - 1) & 1);
        bar_expect_tx(&full[s], kTileBytes);
        for (int p = 0; p < kPanels; ++p) {
          tma_load(t.k[s][p], &tk, &full[s], p * kPanel, j * kRows, h, b);
          tma_load(t.v[s][p], &tv, &full[s], p * kPanel, j * kRows, h, b);
        }
      }
    }
    return;
  }

  // consumers: the block's 64 queries; rows >= S take lse = delta = 0
  const int row = 16 * warp + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);
  const int r0 = q0 + row, r1 = r0 + 8;
  const long long rows = (long long)bh * S;
  const float lse0 = r0 < S ? lse[rows + r0] * kLog2e : 0.f;
  const float lse1 = r1 < S ? lse[rows + r1] * kLog2e : 0.f;
  const float dl0 = r0 < S ? delta[rows + r0] : 0.f;
  const float dl1 = r1 < S ? delta[rows + r1] : 0.f;
  float dq_acc[kD / 2];
  float s[32], dp[32];
  zero(dq_acc);
  zero(s);
  zero(dp);

  bar_wait(&q_full, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kStages;
    const int kb = j * kRows;
    bar_wait(&full[st], (j / kStages) & 1);

    // S = Q K^T and dP = dO V^T over kD / 16 steps of 16 columns
    pin(s);
    pin(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      wgmma_ss_n64<T>(s, desc(&t.q[p][c], 16, 1024),
                      desc(&t.k[st][p][c], 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      wgmma_ss_n64<T>(dp, desc(&t.dout[p][c], 16, 1024),
                      desc(&t.v[st][p][c], 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

    // dS = P (dP - delta) in fp32, keys >= S masked, packed to T A
    // fragments
    uint32_t dsa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int kc = kb + 8 * n + col;
      const bool okc0 = kc < S, okc1 = kc + 1 < S;
      const float p0 = okc0 ? exp2f(fmaf(s[4 * n], scale_log2, -lse0)) : 0.f;
      const float p1 =
          okc1 ? exp2f(fmaf(s[4 * n + 1], scale_log2, -lse0)) : 0.f;
      const float p2 =
          okc0 ? exp2f(fmaf(s[4 * n + 2], scale_log2, -lse1)) : 0.f;
      const float p3 =
          okc1 ? exp2f(fmaf(s[4 * n + 3], scale_log2, -lse1)) : 0.f;
      dsa[n / 2][(n % 2) * 2] =
          pack2<T>(p0 * (dp[4 * n] - dl0), p1 * (dp[4 * n + 1] - dl0));
      dsa[n / 2][(n % 2) * 2 + 1] =
          pack2<T>(p2 * (dp[4 * n + 2] - dl1), p3 * (dp[4 * n + 3] - dl1));
    }

    // dQ += T(dS) K over 4 steps of 16 keys, m64n128 over panel pairs
    pin(dq_acc);
    wg_fence();
    issue_rs<T>(dq_acc, dsa, t.k[st]);
    wg_commit();
    wg_wait();
    pin(dq_acc);

    // this warp is done with the stage's K and V
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);
  }

  store_rows(dq + b * gr.sb + h * gr.sh, gr.sr, dq_acc, r0, col, S, D,
             scale);
}

// The four tensor maps of q, k, v (layout in) and dO (layout og), of the
// element type `type`.
int encode_all(CUtensorMap (&maps)[4], const void* q, const void* k,
               const void* v, const void* dout, int B, int H, int S, int D,
               Layout in, Layout og,
               CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiled enc = encode_fn();
  if (!enc) return kErrNoEntryPoint;
  int rc = encode(enc, &maps[0], q, B, H, S, D, in, kRows, type);
  if (!rc) rc = encode(enc, &maps[1], k, B, H, S, D, in, kRows, type);
  if (!rc) rc = encode(enc, &maps[2], v, B, H, S, D, in, kRows, type);
  if (!rc) rc = encode(enc, &maps[3], dout, B, H, S, D, og, kRows, type);
  return rc;
}

// The grid of a kernel whose block holds `rows` stationary rows of a
// (b, h), and its dynamic shared memory.
template <typename Kernel>
int prepare(Kernel kernel, size_t smem, int B, int H, int S, dim3* grid,
            int rows = kBlockRows) {
  const long long blocks = (long long)((S + rows - 1) / rows) * B * H;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  *grid = dim3((unsigned)blocks);
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int kD>
int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, void* dk, void* dv, int B,
         int H, int S, int D, float scale, Layout in, Layout og, Layout gr,
         cudaStream_t stream) {
  constexpr int kKeys = DkdvShape<kD>::kKeys;
  CUtensorMap m[4];
  int rc = encode_all(m, q, k, v, dout, B, H, S, D, in, og, map_type<T>());
  if (rc) return rc;
  // + the alignment slack
  const size_t smem = sizeof(DkdvTiles<T, kD>) + 1024;
  dim3 grid;
  rc = prepare(flash_bwd_dkdv_kernel<T, kD>, smem, B, H, S, &grid, kKeys);
  if (rc) return rc;
  flash_bwd_dkdv_kernel<T, kD><<<grid, kDkdvThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), H, S, D, (S + kKeys - 1) / kKeys, scale,
      scale * kLog2e, gr);
  return (int)cudaGetLastError();
}

template <typename T>
int dkdv_d(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int B,
           int H, int S, int D, float scale, Layout in, Layout og, Layout gr,
           cudaStream_t s) {
  if (D <= 64)
    return dkdv<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, S, D, scale,
                       in, og, gr, s);
  if (D <= 128)
    return dkdv<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, S, D,
                        scale, in, og, gr, s);
  if (D <= 192)
    return dkdv<T, 192>(q, k, v, dout, lse, delta, dk, dv, B, H, S, D,
                        scale, in, og, gr, s);
  return dkdv<T, 256>(q, k, v, dout, lse, delta, dk, dv, B, H, S, D, scale,
                      in, og, gr, s);
}

template <typename T, int kD>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dqp, int B, int H, int S,
       int D, float scale, Layout in, Layout og, Layout gr,
       cudaStream_t stream) {
  CUtensorMap m[4];
  int rc = encode_all(m, q, k, v, dout, B, H, S, D, in, og, map_type<T>());
  if (rc) return rc;
  dim3 grid;
  if constexpr (kD <= 128) {
    const size_t smem = sizeof(DqTiles<T, kD>) + 1024;  // + the alignment
    rc = prepare(flash_bwd_dq_kernel<T, kD>, smem, B, H, S, &grid);
    if (rc) return rc;
    flash_bwd_dq_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
        m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dqp), H, S, D,
        (S + kBlockRows - 1) / kBlockRows, scale, scale * kLog2e, gr);
  } else {
    const size_t smem = sizeof(WideDqTiles<T, kD>) + 1024;
    rc = prepare(flash_bwd_dq_tc_wide_kernel<T, kD>, smem, B, H, S, &grid,
                 kRows);
    if (rc) return rc;
    flash_bwd_dq_tc_wide_kernel<T, kD><<<grid, kWideDqThreads, smem,
                                         stream>>>(
        m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dqp), H, S, D,
        (S + kRows - 1) / kRows, scale, scale * kLog2e, gr);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dq_d(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, void* dqp, int B, int H, int S,
         int D, float scale, Layout in, Layout og, Layout gr,
         cudaStream_t s) {
  if (D <= 64)
    return dq<T, 64>(q, k, v, dout, lse, delta, dqp, B, H, S, D, scale, in,
                     og, gr, s);
  if (D <= 128)
    return dq<T, 128>(q, k, v, dout, lse, delta, dqp, B, H, S, D, scale, in,
                      og, gr, s);
  if (D <= 192)
    return dq<T, 192>(q, k, v, dout, lse, delta, dqp, B, H, S, D, scale, in,
                      og, gr, s);
  return dq<T, 256>(q, k, v, dout, lse, delta, dqp, B, H, S, D, scale, in,
                    og, gr, s);
}

}  // namespace

extern "C" {

// dk, dv (grad layout) from q, k, v (in layout), dout (its own layout), all
// of the element type `dtype`, and lse and delta (B, H, S) fp32. dtype is
// elem.cuh's code, as csrc/flash_blocked.cu takes it: bf16 or fp16 (fp32
// is csrc/flash_bwd_simt.cu's). 1 <= D <= 256. Returns a cudaError_t as int
// (0 on a launch that was accepted), or a code of vtx_cuda_error_string's
// own when a tensor map could not be made.
int vtx_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int S, int D,
                       float scale, long long in_sb, long long in_sh,
                       long long in_sr, long long og_sb, long long og_sh,
                       long long og_sr, long long gr_sb, long long gr_sh,
                       long long gr_sr, int dtype, void* stream) {
  if (D < 1 || D > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  const Layout in{in_sb, in_sh, in_sr}, og{og_sb, og_sh, og_sr},
      gr{gr_sb, gr_sh, gr_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBf16:
      return dkdv_d<bf16>(q, k, v, dout, lse, delta, dk, dv, B, H, S, D,
                          scale, in, og, gr, s);
    case kF16:
      return dkdv_d<f16>(q, k, v, dout, lse, delta, dk, dv, B, H, S, D,
                         scale, in, og, gr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dq (grad layout) of the element type `dtype` (bf16 or fp16), from the
// same inputs, 1 <= D <= 256.
int vtx_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dqp, int B, int H, int S, int D, float scale,
                     long long in_sb, long long in_sh, long long in_sr,
                     long long og_sb, long long og_sh, long long og_sr,
                     long long gr_sb, long long gr_sh, long long gr_sr,
                     int dtype, void* stream) {
  if (D < 1 || D > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  const Layout in{in_sb, in_sh, in_sr}, og{og_sb, og_sh, og_sr},
      gr{gr_sb, gr_sh, gr_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBf16:
      return dq_d<bf16>(q, k, v, dout, lse, delta, dqp, B, H, S, D, scale,
                        in, og, gr, s);
    case kF16:
      return dq_d<f16>(q, k, v, dout, lse, delta, dqp, B, H, S, D, scale,
                       in, og, gr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* vtx_cuda_error_string(int err) { return error_string(err); }

}  // extern "C"
