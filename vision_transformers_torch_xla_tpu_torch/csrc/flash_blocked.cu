// Blocked flash attention (online softmax) backward, for Hopper.
//
// Replaces the TPU kernels of vision_transformers_torch_xla_tpu/ops/
// flash_blocked.py, the long-sequence path (S > 1024); the forward (K4,
// _fwd_kernel) is csrc/flash_fwd.cu:
//   K5 flash_bwd_dkdv_kernel <- _bwd_dkdv_kernel (:109): per key row, over
//      query tiles, p = exp((q k^T) scale - lse), dv += bf16(p)^T dO,
//      ds = p (dO v^T - delta), dk += bf16(ds)^T q; dk *= scale.
//   K6 flash_bwd_dq_kernel   <- _bwd_dq_kernel (:157): per query row, over
//      key tiles, the same p and ds, dq += bf16(ds) k; dq *= scale.
// delta = rowsum(fp32 dO * fp32 O) comes from the caller (a torch op, as in
// JAX it is computed outside Pallas). Every product accumulates in fp32.
// bf16(x) is round-to-nearest-even to bfloat16, kept as a float.
//
// Tensors are (B, H, S, D) of any element strides with a contiguous head
// dim: a Layout gives the batch, head and row strides, so q, k and v are
// read straight from a fused (B, S, 3*H*D) projection and o, do, dq, dk, dv
// may live in (B, S, H*D)-style buffers. lse and delta are (B, H, S) fp32.
//
// What bounds them on an H100: at S = 1370, D = 64 one (b, h) is 8 S^2 D
// for K5 and 6 S^2 D for K6, over < 1 MB of
// operands: hundreds of FLOP per byte, above the ~295 FLOP/byte ridge, so
// the products bound them. At B = 32, 12 heads the least time at the H100
// SXM's 989 TFLOP/s bf16 peak is 0.373 ms (K5) and 0.280 ms
// (K6), and the S^2 exps (7.2e8 per kernel call) cost the special-function
// units about as much. This version runs the products on the CUDA cores in
// fp32 (67 TFLOP/s peak), so FMA and shared-memory issue hold it back:
// 12.67 and 10.55 ms per call at that shape, 25-29 TFLOP/s (H100
// 80GB HBM3, 700.00 W; chip_smoke.py). Every product is bf16 x bf16 into
// fp32, what mma.sync and wgmma compute; they, then TMA, are the next steps.
//
// Design: 64-row query tiles and 64-row key tiles, 256 threads as 16 x 16.
// A thread owns 4 contiguous rows (ty * 4 + i) and the columns tx + 16 j of
// each tile product, so that A operands are read as float4 (broadcast in a
// half-warp) and B operands as scalars on 16 consecutive banks. Operands
// are staged in shared memory as fp32: an A operand transposed with pitch
// 68 (16-byte rows), a B operand transposed with pitch 65 (an odd pitch:
// row and column reads are both free of bank conflicts). One block works
// on one (b, h) and one tile and loops over the other side's tiles, so
// every sum stays in one block: no float atomics, a deterministic result.
//   K5: block (key tile, b*H + h); K and V staged once, q, dO, lse and
//       delta per query tile; dk and dv accumulate in registers.
//   K6: block (query tile, b*H + h); q, dO, lse and delta once, K and V per
//       key tile; dq accumulates in registers.
// The head dim is 64 or 128 at compile time; a smaller head dim takes the
// next one with its columns zero-filled.
//
// Plain C interface, loaded with ctypes. The kernels allocate nothing and
// launch on the caller's stream; each host function returns
// cudaGetLastError(). The caller (ops/flash_blocked.py) checks the shapes:
// B * H <= 65535 (the grid's y dimension) and 1 <= D <= 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;           // query rows and key rows of one tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kPA = kTile + 4;      // pitch of a transposed A operand
constexpr int kPB = kTile + 1;      // pitch of a transposed B operand
constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value

struct Layout {
  long long sb, sh, sr;  // element strides of batch, head and row
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Stage rows [r0, r0 + kTile) of one head, scaled by `mul`, into shared
// memory as fp32, transposed: dst[d * pitch + r]. Rows >= S and columns
// >= D read as 0.
template <int kD>
__device__ __forceinline__ void stage_t(float* __restrict__ dst, int pitch,
                                        const bf16* __restrict__ src,
                                        long long sr, int r0, int S, int D,
                                        float mul) {
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    float x = 0.f;
    if (r0 + r < S && d < D)
      x = __bfloat162float(src[(long long)(r0 + r) * sr + d]) * mul;
    dst[d * pitch + r] = x;
  }
}

// acc[i][j] += sum_{k < K} a[k * kPA + row0 + i] * b[k * BK + (col0 + 16 j) * BC]
// for i < 4, j < NJ: a is a transposed A operand (float4 reads), b a B
// operand read with strides BK along k and BC along the columns.
template <int NJ, int K, int BK, int BC>
__device__ __forceinline__ void tile_product(float (&acc)[4][NJ],
                                             const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             int row0, int col0) {
#pragma unroll 16
  for (int k = 0; k < K; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(a + k * kPA + row0);
    float y[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) y[j] = b[k * BK + (col0 + 16 * j) * BC];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[0][j] = fmaf(x.x, y[j], acc[0][j]);
      acc[1][j] = fmaf(x.y, y[j], acc[1][j]);
      acc[2][j] = fmaf(x.z, y[j], acc[2][j]);
      acc[3][j] = fmaf(x.w, y[j], acc[3][j]);
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[4][NJ]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

// Store a thread's 4 x 4 values x[i][j] at dst[(col0 + 16 j) * kPA + row0 + i]
// (transposed, float4 per column: an A operand for the next product).
__device__ __forceinline__ void store_t(float* __restrict__ dst,
                                        const float (&x)[4][4], int row0,
                                        int col0) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(dst + (col0 + 16 * j) * kPA + row0) =
        make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
}

// Write rows row0 + i (< S) and columns col0 + 16 j (< D) of acc * mul as
// bf16 to one head of a tensor with row stride sr.
template <int NJ>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           long long sr,
                                           const float (&acc)[4][NJ], int r0,
                                           int row0, int col0, int S, int D,
                                           float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + row0 + i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = col0 + 16 * j;
      if (c < D) dst[(long long)r * sr + c] = __float2bfloat16_rn(acc[i][j] * mul);
    }
  }
}

// K5. grid (ceil(S / kTile), B * H) over key tiles. Shared memory: kT, vT
// [kD x kPA] (A operands, the block's keys), qT, doT [kD x kPB] (the query
// tile), pq, dsq [kTile x kPA] (bf16(p), bf16(ds) as [query][key]), then
// lse and delta of the query tile [kTile] each.
template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int S, int D, float scale,
                      Layout in, Layout og, Layout gr) {
  extern __shared__ __align__(16) float smem[];
  float* kT = smem;
  float* vT = kT + kD * kPA;
  float* qT = vT + kD * kPA;
  float* doT = qT + kD * kPB;
  float* pq = doT + kD * kPB;
  float* dsq = pq + kTile * kPA;
  float* lse_s = dsq + kTile * kPA;
  float* dl_s = lse_s + kTile;
  constexpr int NO = kD / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, row0 = (threadIdx.x >> 4) * 4;
  const long long in_off = b * in.sb + h * in.sh;
  const bf16* qg = q + in_off;
  const bf16* dog = dout + b * og.sb + h * og.sh;
  const float* lse_g = lse + (long long)bh * S;
  const float* dl_g = delta + (long long)bh * S;

  stage_t<kD>(kT, kPA, k + in_off, in.sr, k0, S, D, 1.f);
  stage_t<kD>(vT, kPA, v + in_off, in.sr, k0, S, D, 1.f);
  float dk_acc[4][NO], dv_acc[4][NO];
  zero(dk_acc);
  zero(dv_acc);
  bool key_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) key_ok[i] = k0 + row0 + i < S;

  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();  // the last tile's qT, doT, pq, dsq are read
    stage_t<kD>(qT, kPB, qg, in.sr, q0, S, D, 1.f);
    stage_t<kD>(doT, kPB, dog, og.sr, q0, S, D, 1.f);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool ok = q0 + i < S;
      lse_s[i] = ok ? lse_g[q0 + i] : 0.f;
      dl_s[i] = ok ? dl_g[q0 + i] : 0.f;
    }
    __syncthreads();
    // s^T [key][query] = K q^T, dp^T = V dO^T
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    tile_product<4, kD, kPB, 1>(s, kT, qT, row0, tx);
    tile_product<4, kD, kPB, 1>(dp, vT, doT, row0, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = tx + 16 * j;
      const bool q_ok = q0 + qi < S;
      const float ls = lse_s[qi], dl = dl_s[qi];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p =
            (q_ok && key_ok[i]) ? expf(s[i][j] * scale - ls) : 0.f;
        s[i][j] = bf16_round(p);
        dp[i][j] = bf16_round(p * (dp[i][j] - dl));
      }
    }
    store_t(pq, s, row0, tx);
    store_t(dsq, dp, row0, tx);
    __syncthreads();
    // dv += bf16(p)^T dO, dk += bf16(ds)^T q: dO and q read from doT, qT
    // [d][query] along the query
    tile_product<NO, kTile, 1, kPB>(dv_acc, pq, doT, row0, tx);
    tile_product<NO, kTile, 1, kPB>(dk_acc, dsq, qT, row0, tx);
  }

  const long long g_off = b * gr.sb + h * gr.sh;
  store_rows<NO>(dv + g_off, gr.sr, dv_acc, k0, row0, tx, S, D, 1.f);
  store_rows<NO>(dk + g_off, gr.sr, dk_acc, k0, row0, tx, S, D, scale);
}

// K6. grid (ceil(S / kTile), B * H) over query tiles. Shared memory: qT,
// doT [kD x kPA] (A operands, the block's queries), kT, vT [kD x kPB] (the
// key tile), dsT [kTile x kPA] (bf16(ds) as [key][query]).
template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int S, int D, float scale, Layout in, Layout og,
                    Layout gr) {
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;
  float* doT = qT + kD * kPA;
  float* kT = doT + kD * kPA;
  float* vT = kT + kD * kPB;
  float* dsT = vT + kD * kPB;
  constexpr int NO = kD / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, row0 = (threadIdx.x >> 4) * 4;
  const long long in_off = b * in.sb + h * in.sh;

  stage_t<kD>(qT, kPA, q + in_off, in.sr, q0, S, D, 1.f);
  stage_t<kD>(doT, kPA, dout + b * og.sb + h * og.sh, og.sr, q0, S, D, 1.f);
  float ls[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + row0 + i;
    ls[i] = r < S ? lse[(long long)bh * S + r] : 0.f;
    dl[i] = r < S ? delta[(long long)bh * S + r] : 0.f;
  }
  float acc[4][NO];
  zero(acc);

  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // the last tile's kT, vT and dsT are read
    stage_t<kD>(kT, kPB, k + in_off, in.sr, k0, S, D, 1.f);
    stage_t<kD>(vT, kPB, v + in_off, in.sr, k0, S, D, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    tile_product<4, kD, kPB, 1>(s, qT, kT, row0, tx);
    tile_product<4, kD, kPB, 1>(dp, doT, vT, row0, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool key_ok = k0 + tx + 16 * j < S;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = key_ok ? expf(s[i][j] * scale - ls[i]) : 0.f;
        dp[i][j] = bf16_round(p * (dp[i][j] - dl[i]));
      }
    }
    store_t(dsT, dp, row0, tx);
    __syncthreads();
    // dq += bf16(ds) k: k read from kT [d][key] along the key
    tile_product<NO, kTile, 1, kPB>(acc, dsT, kT, row0, tx);
  }
  store_rows<NO>(dq + b * gr.sb + h * gr.sh, gr.sr, acc, q0, row0, tx, S, D,
                 scale);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

dim3 grid_of(int B, int H, int S) {
  return dim3((S + kTile - 1) / kTile, B * H);
}

template <int kD>
int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, void* dk, void* dv, int B,
         int H, int S, int D, float scale, Layout in, Layout og, Layout gr,
         cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * kD * kPA + 2 * kD * kPB + 2 * kTile * kPA + 2 * kTile) *
      sizeof(float);
  int rc = set_smem(flash_bwd_dkdv_kernel<kD>, smem);
  if (rc) return rc;
  flash_bwd_dkdv_kernel<kD><<<grid_of(B, H, S), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, S, D, scale, in, og,
      gr);
  return (int)cudaGetLastError();
}

template <int kD>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dqp, int B, int H, int S,
       int D, float scale, Layout in, Layout og, Layout gr,
       cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * kD * kPA + 2 * kD * kPB + kTile * kPA) * sizeof(float);
  int rc = set_smem(flash_bwd_dq_kernel<kD>, smem);
  if (rc) return rc;
  flash_bwd_dq_kernel<kD><<<grid_of(B, H, S), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dqp), H, S, D, scale, in, og, gr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dk, dv (grad layout) bf16 from q, k, v (in layout), dout (its own
// layout), lse and delta (B, H, S) fp32.
int vtx_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int S, int D,
                       float scale, long long in_sb, long long in_sh,
                       long long in_sr, long long og_sb, long long og_sh,
                       long long og_sr, long long gr_sb, long long gr_sh,
                       long long gr_sr, void* stream) {
  const Layout in{in_sb, in_sh, in_sr}, og{og_sb, og_sh, og_sr},
      gr{gr_sb, gr_sh, gr_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return dkdv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, S, D, scale, in,
                    og, gr, s);
  return dkdv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, S, D, scale, in,
                   og, gr, s);
}

// dq (grad layout) bf16, from the same inputs.
int vtx_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dqp, int B, int H, int S, int D, float scale,
                     long long in_sb, long long in_sh, long long in_sr,
                     long long og_sb, long long og_sh, long long og_sr,
                     long long gr_sb, long long gr_sh, long long gr_sr,
                     void* stream) {
  const Layout in{in_sb, in_sh, in_sr}, og{og_sb, og_sh, og_sr},
      gr{gr_sb, gr_sh, gr_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return dq<64>(q, k, v, dout, lse, delta, dqp, B, H, S, D, scale, in, og,
                  gr, s);
  return dq<128>(q, k, v, dout, lse, delta, dqp, B, H, S, D, scale, in, og,
                 gr, s);
}

const char* vtx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
