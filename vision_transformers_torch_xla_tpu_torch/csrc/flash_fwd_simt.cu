// The blocked attention forward in fp32 at head dims up to 256, on the CUDA
// cores of Hopper: flash_fwd_simt_kernel<kD> (K4), kD 64 or 128, and past
// 128 flash_fwd_wide_simt_kernel<kD>, kD 192 or 256, at compile time (a
// smaller head dim takes the next with its columns zero-filled). Linked
// into csrc/flash_blocked.cu's library, whose fwd() launches them for
// float at D <= 256 (every dtype past 256 stays there; bf16 and fp16 to
// 256 are csrc/flash_fwd.cu's).
//
// Replaces the TPU kernel _fwd_kernel of vision_transformers_torch_xla_tpu/
// ops/flash_blocked.py (:33, call :89) in fp32 (the JAX kernel rounds
// nothing there): per query row, over the key tiles, with a running max m,
// sum l and accumulator acc,
//   s = (q scale) k^T, q scaled before the product (:47); keys >= S -1e30;
//   m' = max(m, rowmax s); alpha = exp(m - m'); p = exp(s - m');
//   l = l alpha + sum p; acc = acc alpha + p v;
// then o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)). q, k and v
// are (B, H, S, D) views of one layout with a contiguous head dim, read
// straight from a fused (B, S, 3 H D) projection; o is written by its own
// strides and lse is (B, H, S) fp32.
//
// What bounds it on an H100: the two products, 4 B H S^2 D FLOPs (184.5
// GFLOP at (B, S, H, D) = (32, 1370, 12, 64)): 2.75 ms at the 67 TFLOP/s
// fp32 peak of the CUDA cores, against 0.27 GB of operands (0.08 ms at 3.35
// TB/s). The tensor cores have no fp32 product that keeps the inputs (TF32
// rounds them), so the products run as FMAs fed from shared memory on
// register tiles (csrc/simt_tiles.cuh).
//
// Design. A block per (b, h, 128-row query tile) on a one-dimensional grid
// (B H bounded only by 2^31 / ceil(S / 128)).
//   * Staging. The block's q is staged once, scaled in place, row-major at
//     pitch kD + 4; K and V stream in 64-key tiles through one cp.async
//     buffer each: the next tile's K lands while the block forms p and
//     sums p v, its V while the block scores the next tile (four block
//     barriers a tile). At kD = 64 two blocks share an SM (104 KB each),
//     at kD = 128 one (176 KB). 16-byte copies with the columns past D
//     zero-filled when every row is 16-byte aligned (the model's qkv
//     views), else one 4-byte copy an element (any fp32 view with a
//     contiguous head dim: nothing is copied in Python).
//   * Rows. A warp owns whole rows of the block (32 at kD = 64: 4 warps,
//     lanes 4 x 8; 16 at kD = 128: 8 warps, lanes 2 x 16): a thread holds
//     8 of them, a row's lanes hold all 64 keys of the tile in the score
//     product and all kD columns in p v. So the row max is a butterfly over
//     the row's lanes, alpha lives in the registers of every thread that
//     scales the row's acc, and p goes into the warp's own rows of shared
//     memory (at a pitch that spreads a store over the banks) with a
//     __syncwarp, not a block barrier. l is summed per thread over its keys
//     and over the lanes once, at the end.
//   * Products. s on 8 x 8 register tiles at kD = 64 (16 loads feed 256
//     FMAs), 8 x 4 at kD = 128 (12 feed 128), q and K read as float4 along
//     the head dim; p v on 8 x 8 tiles, p read as float4 along the keys and
//     V as float4 along the head dim. The last key tile sums only its real
//     keys (to a multiple of 4), and warps whose rows all lie past S skip
//     the tile; only the last tile masks keys >= S.
//   * exp is ex2.approx (exp_p); the division by l and log are IEEE.
//   * Deterministic: every sum runs in a fixed order, no float atomics.
// Measured on an H100 80GB HBM3 at 700 W, device ms of one call at (32,
// 1370, 12, 64): 5.204-5.207, 53% of its bound (the first CUDA-core
// design, csrc/flash_blocked.cu's flash_fwd_kernel<float, 64>: 7.19-7.20;
// SDPA's fp32 forward 5.62-5.65). ptxas: 255 registers and a 64-byte
// spill at kD = 64, 254 and none at kD = 128. PERF.md §6 has the variants
// (tools/time_fp32_fwd_variants.py).
//
// Head dims 129-256 (flash_fwd_wide_simt_kernel). The design above would
// stage 128 rows of q and whole 64-key K and V tiles (266 KB at kD 256),
// and a row's lanes would hold 256 columns of o. So, after
// csrc/attn_fwd_simt.cuh's wide tiles (PR 18), with K4's online softmax:
//   * A block per (b, h, 64-row query tile), 8 warps, each owning 8 whole
//     rows: lane l holds keys l + 32 j (j < 4) of a 128-key score tile, s
//     on 8 x 4 register tiles, and columns wide_col(l, c) (c < kD / 32) of
//     o, an 8 x kD / 32 accumulator; a row's max and sum are butterflies
//     over its warp, alpha rescales the lane's own accumulator, and p goes
//     into the warp's own rows of shared memory (__syncwarp).
//   * q * scale staged once [64][kD + 4]; K streams in pieces of 128 keys
//     x 32 columns (pitch 36), V in pieces of 16 keys x kD, through one
//     ring of 3 slots: each step waits for its piece and starts the copy
//     two steps ahead at one block barrier. 16-byte copies where every
//     row is 16-byte aligned, else 4-byte ones, columns past D
//     zero-filled. 154 KB at kD 256: one block an SM.
//   * s: 4 broadcast float4 of q^ and 4 of K a step feed 128 FMAs; p v:
//     csrc/simt_wide.cuh's keys_sum (the sums of the wide dk/dv blocks),
//     p broadcast along the keys, V as float4 along the head dim. The
//     last score tile computes only its 32-key groups and 16-key V pieces
//     that hold real keys.
//   * Why 128-key tiles: 256-key ones (8 x 8 s) spill 172 bytes at kD 256
//     and took 23.2 against 21.9 ms at (32, 1370, 12, 256); 8192-float
//     pieces (half the barriers) and a fourth slot timed slower or the
//     same (tools/time_fp32_fwd_variants.py --head_dim 256, PERF.md §6).
//   * At (1, 1370, 4, 256) the grid is 88 blocks on 132 SMs, one wave: a
//     third of the card idles. 32-row blocks (two an SM) fill it but copy
//     K and V twice as often: 0.42 against 0.35 ms there, 27.1 against
//     21.9 at B 32.
// What bounds it: the two products, 4 B H S^2 D FLOPs (738 GFLOP at (32,
// 1370, 12, 256): 11.0 ms at 67 TFLOP/s). Measured on an H100 80GB HBM3
// at 700 W, device ms of one call (tools/time_torch_attention.py, PERF.md
// §6): 21.94 there, 50% of the bound (csrc/flash_blocked.cu's
// flash_fwd_wide_kernel<float> before it: 86.08-86.17; SDPA's fp32
// forward 18.06-18.18); 17.25-17.37 at D 192; 0.345-0.351 at (1, 1370, 4,
// 256) (1.09-1.10; SDPA 0.291). Left out in turn (variants tool): without
// the scores 13.1 ms, without p v 14.1, without the stream's copies 18.6;
// every piece copied twice 25.3: the copies' own work costs ~3.3 ms.
// ptxas: 238 (kD 192) and 254 (256) registers, no spill.
//
// Plain C++ interface (namespace flash_fwd_simt), called by
// csrc/flash_blocked.cu's fwd() on the caller's stream; returns
// cudaGetLastError(). The kernels allocate nothing.

#include "simt_tiles.cuh"
#include "simt_wide.cuh"

namespace {

constexpr int kFwdRows = 128;  // query rows of a block
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

// The kernel's widths at compile-time head dim kD. A warp owns kWR whole
// rows of the block, its lanes kNY x kLX (ly, lx): a thread holds rows ly +
// kNY i (i < 8) of the warp's, keys lx + kLX j (j < kNJ) of a tile in the
// score product and head-dim columns 4 lx + 4 kLX g + e (g < 2, e < 4) in
// p v. kD = 64: 32 rows, 4 x 8 lanes, 8 x 8 score tiles, 4 warps; kD =
// 128: 16 rows, 2 x 16 lanes, 8 x 4 score tiles (an 8 x 8 p v tile there
// holds the rows' 128 columns), 8 warps. Shared memory: q * scale
// [128][kD + 4], a buffer each of K and V [64][kD + 4], p [128][kPP] (kPP =
// 72 or 80: a store of p spreads the warp's kNY rows over the banks).
template <int kD>
struct Fwd {
  static constexpr int kLX = kD == 64 ? 8 : 16;
  static constexpr int kNY = 32 / kLX;
  static constexpr int kWR = 8 * kNY;
  static constexpr int kNJ = kTile / kLX;
  static constexpr int kWarps = kFwdRows / kWR;
  static constexpr int kThr = 32 * kWarps;
  static constexpr int kP = kD + 4;
  static constexpr int kPP = kTile + kLX;
  static constexpr size_t kSmem =
      (size_t)(kFwdRows * kP + 2 * kTile * kP + kFwdRows * kPP) *
      sizeof(float);
};

// x *= scale over the 16-byte pieces that this thread copied with
// copy_tile<kD, kN, kThr> (its own cp.async writes, which cp_async_wait
// made visible to it).
template <int kD, int kN, int kThr>
__device__ __forceinline__ void scale_tile(float* __restrict__ x,
                                           float scale) {
  constexpr int kQ = kD / 4, kP = kD + 4;
#pragma unroll
  for (int u = 0; u < kN * kQ / kThr; ++u) {
    const int i = threadIdx.x + u * kThr;
    float4* y = reinterpret_cast<float4*>(x + (i / kQ) * kP + 4 * (i % kQ));
    float4 z = *y;
    z.x *= scale;
    z.y *= scale;
    z.z *= scale;
    z.w *= scale;
    *y = z;
  }
}

// s[i][j] += sum_{d < kD} q[(r0 + kNY i) kP + d] k[(lx + kLX j) kP + d] (i
// < 8, j < kNJ), both read as float4 along the head dim.
template <int kD>
__device__ __forceinline__ void q_kt(float (&s)[8][Fwd<kD>::kNJ],
                                     const float* __restrict__ q,
                                     const float* __restrict__ k, int r0,
                                     int lx) {
  typedef Fwd<kD> F;
  constexpr int kP = kD + 4;
#pragma unroll 2
  for (int d = 0; d < kD; d += 4) {
    float4 y[F::kNJ];
#pragma unroll
    for (int j = 0; j < F::kNJ; ++j)
      y[j] = *reinterpret_cast<const float4*>(k + (lx + F::kLX * j) * kP +
                                              d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(q + (r0 + F::kNY * i) * kP + d);
#pragma unroll
      for (int j = 0; j < F::kNJ; ++j) {
        s[i][j] = fmaf(x.x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x.y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x.z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x.w, y[j].w, s[i][j]);
      }
    }
  }
}

// acc[i][4 g + e] += sum_{t < n} p[(r0 + kNY i) kPP + t] v[t kP + 4 lx + 4
// kLX g + e] (i < 8, g < 2, e < 4; n a multiple of 4), p read as float4
// along the keys, v as float4 along the head dim.
template <int kD>
__device__ __forceinline__ void p_v(float (&acc)[8][8],
                                    const float* __restrict__ p,
                                    const float* __restrict__ v, int r0,
                                    int lx, int n) {
  typedef Fwd<kD> F;
  constexpr int kP = kD + 4;
#pragma unroll 2
  for (int t = 0; t < n; t += 4) {
    float4 x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = *reinterpret_cast<const float4*>(p + (r0 + F::kNY * i) * F::kPP +
                                              t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 y[2];
#pragma unroll
      for (int g = 0; g < 2; ++g)
        y[g] = *reinterpret_cast<const float4*>(v + (t + e) * kP + 4 * lx +
                                                4 * F::kLX * g);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x_e = e == 0 ? x[i].x : e == 1 ? x[i].y
                        : e == 2 ? x[i].z : x[i].w;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          acc[i][4 * g] = fmaf(x_e, y[g].x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(x_e, y[g].y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(x_e, y[g].z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(x_e, y[g].w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// Max and sum over the kLX lanes that share a row: the xor butterfly
// leaves the same value, summed in the same order, in each of them.
template <int kLX>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 1; off < kLX; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int kLX>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < kLX; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// K4. grid (B * H * n_tiles) over 128-row query tiles.
template <int kD>
__global__ void __launch_bounds__(Fwd<kD>::kThr,
                                  2 * Fwd<kD>::kSmem <= 227 * 1024 ? 2 : 1)
flash_fwd_simt_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int H, int S, int D,
                      int n_tiles, float scale, Strides in, Strides out,
                      int vec, int vec_out) {
  typedef Fwd<kD> F;
  constexpr int kP = kD + 4, kLX = F::kLX, kNY = F::kNY, kNJ = F::kNJ;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kFwdRows * kP;   // K, then V, of the key tile
  float* vs = ks + kTile * kP;
  float* ps = vs + kTile * kP;
  const int bh = blockIdx.x / n_tiles, b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % n_tiles) * kFwdRows;
  const int w = threadIdx.x >> 5, lx = threadIdx.x & (kLX - 1);
  const int r0 = F::kWR * w + (threadIdx.x & 31) / kLX;  // rows r0 + kNY i
  const bool live = q0 + F::kWR * w < S;  // the warp holds a real row
  const long long off = b * in.sb + h * in.sh;
  const float* kg = k + off;
  const float* vg = v + off;
  // K (or V) of the key tile at k0 into its buffer, by cp.async, as a
  // group of its own
  auto stream = [&](float* dst, const float* src, int k0) {
    copy_tile<kD, kTile, F::kThr>(dst, src, in.sr, k0, S, D, vec);
    cp_async_commit();
  };

  copy_tile<kD, kFwdRows, F::kThr>(qs, q + off, in.sr, q0, S, D, vec);
  cp_async_commit();
  stream(ks, kg, 0);
  stream(vs, vg, 0);
  cp_async_wait<2>();  // this thread's pieces of q landed
  scale_tile<kD, kFwdRows, F::kThr>(qs, scale);  // q * scale, as JAX
  float acc[8][8], m[8], l[8];
  zero(acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  // K of the next tile lands while the block forms p and sums p v, V of
  // the next tile while it scores the next tile
  for (int k0 = 0; k0 < S; k0 += kTile) {
    const bool next = k0 + kTile < S;
    cp_async_wait<1>();  // K of the tile landed (its V may be in flight)
    __syncthreads();     // for every thread (and q, scaled, with the first)
    float s[8][kNJ];
    if (live) {
      zero(s);
      q_kt<kD>(s, qs, ks, r0, lx);
    }
    __syncthreads();  // K is read: its buffer takes the next tile's
    if (next) stream(ks, kg, k0 + kTile);
    if (live) {
      // the online softmax of the thread's rows over the tile's keys
      if (k0 + kTile > S) {  // the last tile: keys >= S are masked
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
          if (k0 + lx + kLX * j >= S)
#pragma unroll
            for (int i = 0; i < 8; ++i) s[i][j] = kNegInf;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) mx = fmaxf(mx, s[i][j]);
        const float m_new = fmaxf(m[i], row_max<kLX>(mx));
        const float alpha = exp_p(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const float p = exp_p(s[i][j] - m_new);
          sum += p;
          ps[(r0 + kNY * i) * F::kPP + lx + kLX * j] = p;
        }
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
      }
    }
    if (next)
      cp_async_wait<1>();  // V of the tile landed (the next K may not)
    else
      cp_async_wait<0>();
    __syncthreads();  // for every thread; the warps' p rows are stored
    // acc += p v over the tile's real keys (p is 0 past them)
    if (live)
      p_v<kD>(acc, ps, vs, r0, lx, min(kTile, (S - k0 + 3) & ~3));
    __syncthreads();  // V is read: its buffer takes the next tile's
    if (next) stream(vs, vg, k0 + kTile);
  }

  float* og = o + b * out.sb + h * out.sh;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float lf = fmaxf(row_sum<kLX>(l[i]), 1e-30f);
    const int r = q0 + r0 + kNY * i;
    if (r >= S) continue;
    if (lx == 0) lse[(long long)bh * S + r] = m[i] + logf(lf);
    float* orow = og + (long long)r * out.sr;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int c = 4 * lx + 4 * kLX * g;
      const float4 y = make_float4(acc[i][4 * g] / lf, acc[i][4 * g + 1] / lf,
                                   acc[i][4 * g + 2] / lf,
                                   acc[i][4 * g + 3] / lf);  // o = acc / l
      if (vec_out && c + 4 <= D) {
        *reinterpret_cast<float4*>(orow + c) = y;
      } else {
        if (c < D) orow[c] = y.x;
        if (c + 1 < D) orow[c + 1] = y.y;
        if (c + 2 < D) orow[c + 2] = y.z;
        if (c + 3 < D) orow[c + 3] = y.w;
      }
    }
  }
}

template <int kD>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, int B, int H, int S, int D, float scale,
               Strides in, Strides out, cudaStream_t stream) {
  typedef Fwd<kD> F;
  int n_tiles;
  unsigned blocks;
  const int rc = prepare(flash_fwd_simt_kernel<kD>, F::kSmem, kFwdRows, B,
                         H, S, &n_tiles, &blocks);
  if (rc) return rc;
  const int vec = rows16({q, k, v}, in, in) ? 1 : 0;
  const int vec_out = rows16({o}, out, out) ? 1 : 0;
  flash_fwd_simt_kernel<kD><<<blocks, F::kThr, F::kSmem, stream>>>(
      q, k, v, o, lse, H, S, D, n_tiles, scale, in, out, vec, vec_out);
  return (int)cudaGetLastError();
}

// ---- head dims 129-256: flash_fwd_wide_simt_kernel<kD>, kD 192 or 256

// The wide kernel's shape: a lane's keys of a score tile (kWideNJ: 4,
// 128-key tiles, s on 8 x 4 register tiles beside the 8 x kD / 32
// accumulator), the floats of a streamed piece (kWidePiece), the query
// rows of a block (kWideRows) and the slots of the ring (kWideSlots)
constexpr int kWideNJ = 4;
constexpr int kWidePiece = 4096;
constexpr int kWideRows = 64;
constexpr int kWideSlots = 3;

// The wide kernel's widths at compile-time head dim kD. A warp owns 8
// whole rows of the block's kRows; lane l holds keys l + 32 j (j < kNJ) of
// a score tile and columns wide_col<kD>(l, c) (c < kNO) of o. K streams in
// pieces of kKeys keys x kKC head-dim columns (kWidePiece floats, pitch
// kKC + 4, so that the 8 lanes of a quarter-warp read 8 float4 on 32
// distinct banks), V in pieces of kVR keys x kD columns (pitch kD + 4),
// both through one ring of kSlots slots. Shared memory: q * scale [kRows]
// [kD + 4], the ring, p [kRows][kKeys] (each warp's own 8 rows).
template <int kD>
struct FwdWide {
  static constexpr int kRows = kWideRows;
  static constexpr int kThr = kRows / 8 * 32;
  static constexpr int kMinBlocks = kRows < 64 ? 2 : 1;
  static constexpr int kP = kD + 4;
  static constexpr int kNJ = kWideNJ;
  static constexpr int kKeys = 32 * kNJ;
  static constexpr int kKC = kWidePiece / kKeys;
  static constexpr int kKP = kKC + 4;
  static constexpr int kKPieces = kD / kKC;
  static constexpr int kVR = kWidePiece / 256;
  static constexpr int kVPieces = kKeys / kVR;
  static constexpr int kSteps = kKPieces + kVPieces;  // of a whole tile
  static constexpr int kSlot =
      kKeys * kKP > kVR * kP ? kKeys * kKP : kVR * kP;
  static constexpr int kSlots = kWideSlots;
  static constexpr int kNO = kD / 32;
  static constexpr size_t kSmem =
      (size_t)(kRows * kP + kSlots * kSlot + kRows * kKeys) * sizeof(float);
  static_assert((kD == 192 || kD == 256) && kD % kKC == 0, "the wide tiles");
  static_assert(kSmem <= 227 * 1024, "the wide tiles fit a block's 227 KB");
};

// K4 at head dims 129-256. grid (B * H * n_tiles) over 64-row query tiles.
// The stream: for each score tile its kKPieces K pieces, then its V pieces
// holding real keys; step t waits for its piece, and starts step t +
// kSlots - 1's copy, at one block barrier.
template <int kD>
__global__ void __launch_bounds__(FwdWide<kD>::kThr,
                                  FwdWide<kD>::kMinBlocks)
flash_fwd_wide_simt_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int H, int S, int D,
                           int n_tiles, float scale, Strides in, Strides out,
                           int vec, int vec_out) {
  typedef FwdWide<kD> W;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ring = qs + W::kRows * W::kP;
  const int bh = blockIdx.x / n_tiles, b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % n_tiles) * W::kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pw = ring + W::kSlots * W::kSlot + 8 * warp * W::kKeys;  // its p
  const float* qw = qs + 8 * warp * W::kP;
  const bool live = q0 + 8 * warp < S;  // the warp holds a real row
  const long long off = b * in.sb + h * in.sh;
  const float* kg = k + off;
  const float* vg = v + off;
  const int n_st = (S + W::kKeys - 1) / W::kKeys;
  const int n_steps = (n_st - 1) * W::kSteps + W::kKPieces +
                      (S - (n_st - 1) * W::kKeys + W::kVR - 1) / W::kVR;
  // start step t's copy into its slot (an empty group past the stream)
  auto issue = [&](int t) {
    if (t < n_steps) {
      float* dst = ring + t % W::kSlots * W::kSlot;
      const int k0 = t / W::kSteps * W::kKeys, u = t % W::kSteps;
      if (u < W::kKPieces)
        copy_tile<W::kKC, W::kKeys, W::kThr>(dst, kg + u * W::kKC, in.sr, k0,
                                             S, D - u * W::kKC, vec);
      else
        copy_tile<kD, W::kVR, W::kThr>(
            dst, vg, in.sr, k0 + (u - W::kKPieces) * W::kVR, S, D, vec);
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
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < W::kSlots - 1; ++t) issue(t);
  cp_async_wait<W::kSlots - 1>();  // this thread's pieces of q landed
  scale_tile<kD, W::kRows, W::kThr>(qs, scale);  // q * scale, as JAX
  float acc[8][W::kNO], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;  // the lane's part of the row sum
#pragma unroll
    for (int c = 0; c < W::kNO; ++c) acc[i][c] = 0.f;
  }

  int t = 0;
  for (int k0 = 0; k0 < S; k0 += W::kKeys) {
    const int nk = min(W::kKeys, S - k0);  // the tile's real keys
    float s[8][kWideNJ];
    zero(s);
    for (int c = 0; c < W::kKPieces; ++c) {
      const float* ks = piece(t++);
      if (live)
        wide_scores_n<W::kKC, W::kP, W::kKP, W::kNJ>(
            (nk + 31) >> 5, s, qw + c * W::kKC, ks + lane * W::kKP);
    }
    if (live) {
      // the online softmax of the warp's rows over the tile's keys, keys
      // >= S masked; p into the warp's own rows
#pragma unroll
      for (int j = 0; j < W::kNJ; ++j)
        if (lane + 32 * j >= nk)
#pragma unroll
          for (int i = 0; i < 8; ++i) s[i][j] = kNegInf;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float mx = s[i][0];
#pragma unroll
        for (int j = 1; j < W::kNJ; ++j) mx = fmaxf(mx, s[i][j]);
        const float m_new = fmaxf(m[i], row_max<32>(mx));
        const float alpha = exp_p(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < W::kNJ; ++j) {
          const float p = exp_p(s[i][j] - m_new);
          sum += p;
          pw[i * W::kKeys + lane + 32 * j] = p;
        }
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < W::kNO; ++c) acc[i][c] *= alpha;
      }
      __syncwarp();  // the warp's p rows are stored
    }
    // acc += p v over the V pieces that hold real keys (p and V are 0 past
    // S in the last one)
    for (int g = 0; g < (nk + W::kVR - 1) / W::kVR; ++g) {
      const float* vs = piece(t++);
      if (live)
        keys_sum<kD, W::kVR, W::kKeys>(acc, pw + g * W::kVR, vs, lane);
    }
  }

  if (!live) return;
  float* og = o + b * out.sb + h * out.sh;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + 8 * warp + i;
    if (r >= S) break;  // the same r in every lane
    const float lf = fmaxf(row_sum<32>(l[i]), 1e-30f);
    if (lane == 0) lse[(long long)bh * S + r] = m[i] + logf(lf);
    float y[W::kNO];
#pragma unroll
    for (int c = 0; c < W::kNO; ++c) y[c] = acc[i][c] / lf;  // o = acc / l
    float* orow = og + (long long)r * out.sr;
    store_o(orow, wide_col<kD>(lane, 0), y, 4, D, vec_out);
    store_o(orow, wide_col<kD>(lane, 4), y + 4, W::kNO - 4, D, vec_out);
  }
}

template <int kD>
int launch_fwd_wide(const float* q, const float* k, const float* v, float* o,
                    float* lse, int B, int H, int S, int D, float scale,
                    Strides in, Strides out, cudaStream_t stream) {
  typedef FwdWide<kD> W;
  int n_tiles;
  unsigned blocks;
  const int rc = prepare(flash_fwd_wide_simt_kernel<kD>, W::kSmem, W::kRows,
                         B, H, S, &n_tiles, &blocks);
  if (rc) return rc;
  const int vec = rows16({q, k, v}, in, in) ? 1 : 0;
  const int vec_out = rows16({o}, out, out) ? 1 : 0;
  flash_fwd_wide_simt_kernel<kD><<<blocks, W::kThr, W::kSmem, stream>>>(
      q, k, v, o, lse, H, S, D, n_tiles, scale, in, out, vec, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace


namespace flash_fwd_simt {

// o (strides out) and lse (B, H, S) fp32 from q, k, v (strides in);
// 1 <= D <= 256.
int fwd(const float* q, const float* k, const float* v, float* o,
        float* lse, int B, int H, int S, int D, float scale,
        const long long* in, const long long* out, cudaStream_t stream) {
  const Strides i{in[0], in[1], in[2]}, u{out[0], out[1], out[2]};
  if (D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  if (D <= 64)
    return launch_fwd<64>(q, k, v, o, lse, B, H, S, D, scale, i, u, stream);
  if (D <= 128)
    return launch_fwd<128>(q, k, v, o, lse, B, H, S, D, scale, i, u, stream);
  if (D <= 192)
    return launch_fwd_wide<192>(q, k, v, o, lse, B, H, S, D, scale, i, u,
                                stream);
  return launch_fwd_wide<256>(q, k, v, o, lse, B, H, S, D, scale, i, u,
                              stream);
}

}  // namespace flash_fwd_simt
