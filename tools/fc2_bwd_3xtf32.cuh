// A variant of csrc/mlp_fused.cu's fp32 K3 for tools/time_fp32_simt_variants.py
// (k3_3xtf32): da = dy w2 on the tensor cores as three TF32 products, a_lo
// b_hi + a_hi b_lo + a_hi b_hi with x_hi = tf32(x) and x_lo = tf32(x -
// x_hi) (mma.sync m16n8k8, fp32 accumulators), then the fp32 kernel's
// epilogue. The variant's edit includes this file into a copy of
// csrc/mlp_fused.cu, after its helpers, and launches launch_3xtf32 for fp32.
//
// A block of 256 threads (8 warps as 2 x 4, a warp 64 x 32) owns a 128 x
// 128 tile of (M, K); steps of 32 over O through a 3-stage cp.async ring:
// dy [128 rows][32] with pitch 36 and w2 [32][128 columns] with pitch 136,
// so the fragments' scalar reads hit 32 different banks.

constexpr int kXK = 32;             // depth of one step over O
constexpr int kXStages = 3;
constexpr int kXPA = kXK + 4;       // pitch of a dy step [row][o]
constexpr int kXPB = kBN + 8;       // pitch of a w2 step [o][col]

struct XRing {
  float dy[kXStages][kBM][kXPA];
  float w2[kXStages][kXK][kXPB];
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments (m16n8k8, lane l, g = l / 4, t = l % 4): a0 A[g][t], a1
// A[g + 8][t], a2 A[g][t + 4], a3 A[g + 8][t + 4]; b0 B[t][g], b1 B[t +
// 4][g]; d0 D[g][2 t], d1 D[g][2 t + 1], d2 D[g + 8][2 t], d3 D[g + 8][2 t
// + 1].
__global__ void __launch_bounds__(256, 2)
fc2_bwd_3xtf32_kernel(const float* __restrict__ dy,
                      const float* __restrict__ w2,
                      const float* __restrict__ h, float* __restrict__ dh,
                      float* __restrict__ a_out, float* __restrict__ part,
                      int M, int O, int K, int n_tn) {
  extern __shared__ __align__(16) float x_raw[];
  XRing& sm = *reinterpret_cast<XRing*>(x_raw);
  const int tm = blockIdx.x / n_tn;
  const int m0 = tm * kBM, n0 = (blockIdx.x % n_tn) * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;

  auto load = [&](int stage, int o0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // dy: 128 rows x 8 float4
      const int i = tid + 256 * u, r = i >> 3, c = 4 * (i & 7);
      const bool ok = m0 + r < M;
      cp_async<16>(&sm.dy[stage][r][c],
             ok ? dy + (long long)(m0 + r) * O + o0 + c : dy, ok);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // w2: 32 rows x 32 float4
      const int i = tid + 256 * u, r = i >> 5, c = 4 * (i & 31);
      cp_async<16>(&sm.w2[stage][r][c], w2 + (long long)(o0 + r) * K + n0 + c,
             true);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_k = O / kXK;
#pragma unroll
  for (int s = 0; s < kXStages - 1; ++s)
    if (s < n_k) load(s, s * kXK);
    else cp_async_commit();
  for (int j = 0; j < n_k; ++j) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kXStages - 2) : "memory");
    __syncthreads();
    if (j + kXStages - 1 < n_k)
      load((j + kXStages - 1) % kXStages, (j + kXStages - 1) * kXK);
    else
      cp_async_commit();
    const int st = j % kXStages;
#pragma unroll
    for (int kk = 0; kk < kXK; kk += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = 32 * wn + 8 * nt + g;
        split(sm.w2[st][kk + t][c], bh[nt][0], bl[nt][0]);
        split(sm.w2[st][kk + t + 4][c], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = 64 * wm + 16 * mt + g;
        uint32_t ah[4], al[4];
        split(sm.dy[st][r][kk + t], ah[0], al[0]);
        split(sm.dy[st][r + 8][kk + t], ah[1], al[1]);
        split(sm.dy[st][r][kk + t + 4], ah[2], al[2]);
        split(sm.dy[st][r + 8][kk + t + 4], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(acc[mt][nt], al, bh[nt]);
          mma_tf32(acc[mt][nt], ah, bl[nt]);
          mma_tf32(acc[mt][nt], ah, bh[nt]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: dh = da gelu'(h), a = gelu(h); column sums over the tile's
  // real rows, then over the warp's 8 row lanes, then the two row warps
  float csum[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) csum[nt][0] = csum[nt][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + 64 * wm + 16 * mt + g + 8 * half;
      if (gm >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const long long at =
            (long long)gm * K + n0 + 32 * wn + 8 * nt + 2 * t;
        const float2 hv = *reinterpret_cast<const float2*>(h + at);
        const float2 g0 = gelu_tanh_val_grad<false>(hv.x);
        const float2 g1 = gelu_tanh_val_grad<false>(hv.y);
        const float d0 = acc[mt][nt][2 * half] * g0.y;
        const float d1 = acc[mt][nt][2 * half + 1] * g1.y;
        *reinterpret_cast<float2*>(dh + at) = make_float2(d0, d1);
        *reinterpret_cast<float2*>(a_out + at) = make_float2(g0.x, g1.x);
        csum[nt][0] += d0;
        csum[nt][1] += d1;
      }
    }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        csum[nt][e] += __shfl_xor_sync(0xffffffffu, csum[nt][e], off);
  __syncthreads();  // the ring is read
  float* red = &sm.dy[0][0][0];  // [2][kBN]
  if (g == 0)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        red[wm * kBN + 32 * wn + 8 * nt + 2 * t + e] = csum[nt][e];
  __syncthreads();
  if (tid < kBN)
    part[(long long)tm * K + n0 + tid] = red[tid] + red[kBN + tid];
}

int launch_3xtf32(const void* dy, const void* w2, const void* h, void* dh,
                  void* a, void* part, int M, int O, int K, long long blocks,
                  cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      fc2_bwd_3xtf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(XRing));
  if (e != cudaSuccess) return (int)e;
  fc2_bwd_3xtf32_kernel<<<(unsigned)blocks, 256, sizeof(XRing), s>>>(
      static_cast<const float*>(dy), static_cast<const float*>(w2),
      static_cast<const float*>(h), static_cast<float*>(dh),
      static_cast<float*>(a), static_cast<float*>(part), M, O, K, K / kBN);
  return (int)cudaGetLastError();
}
