// RWKV6 WKV recurrence (the time-mix of an rwkv6 block), float32, from a
// zero state:
//
//   y_t[m] = sum_n r_t[n] (S[n,m] + u[n] k_t[n] v_t[m])
//          = sum_n r_t[n] S[n,m] + v_t[m] ruk_t,
//   ruk_t  = sum_n r_t[n] u[n] k_t[n]
//   S[n,m] <- S[n,m] max(w_t[n], 1e-12) + k_t[n] v_t[m]
//
// Replaces the Pallas kernel `wkv6` of the JAX package
// (src/repro/kernels/rwkv6_wkv.py, `_kernel`), which splits y the same way
// (its `diag` term). That kernel walked chunks of Q = 64 steps along a
// sequential grid axis and formed, per chunk, the (Q, Q, N) tensor of
// pairwise decays exp(cum_{i-1} - cum_j) (1 MB, resident in VMEM) so that
// the MXU could do the chunk as matrix products. That tensor does not fit a
// block's shared memory, and its cumulative decay products overflow float32
// within a chunk at the clamp, so the kernel runs the sequential form: no
// exp of a cumulative log-decay, and no padding of S to a chunk multiple.
//
// Bound on the card: bytes. Per (batch, head) the function reads r, k, v
// and w (4 S N floats) and writes y (S N floats) for about 5 S N^2 flops,
// N / 4 = 16 flops a byte, below the float32 ridge (20 flops a byte). At
// the training shape (B 8, S 128, H 40, N 64) that is 52 MB, 0.016 ms at
// 3.35 TB/s. Being a recurrence over S, what holds it back in practice is
// each step's work on the SM, times S. The first design gave a (batch,
// head) 64 threads, each owning a state column of 64 registers: every
// FMA needed one float of r, k or w from shared memory, so a step was
// bound by the shared-memory load pipe (64 LDS.128 a warp), with five
// warps an SM to hide it.
//
// Design: a (batch, head) is one block of 128 threads, 16 groups of 8
// lanes; group m0 / 4 owns columns m0..m0+3, and lane g of it owns rows
// 4g..4g+3 and 32+4g..32+4g+3 (two float4s of shared memory a vector),
// an 8 x 4 tile of S in 32 registers. Each r, k, w value loaded serves 4
// columns and each v value 8 rows: 7 LDS.128 a lane a step for 96 FMAs
// and multiplies. y_t: each lane sums its rows for its 4 columns (two
// chains of 4 FMAs a column, then their sum); the group halves the columns
// at xor 4 and xor 2 (each lane keeps half and adds its partner's sums of
// them) and adds the pair at xor 1, so lane g ends with column m0 + 2
// (g >> 2 & 1) + (g >> 1 & 1), and y = v ruk + that sum. r, k, w and v of
// TC steps are staged in shared memory with cp.async, double-buffered so
// the next chunk loads while this one runs; once a chunk has landed, w is
// clamped in place and ruk_t is formed by four lanes a step (16 channels
// each, FMAs in order, added at xor 1 and 2). The step loop is unrolled
// by two so one step's shuffles overlap the next step's FMAs. A lane with
// 8 rows x 8 columns (195 registers, 2 warps a head) and one with 4 x 4
// (8 warps a head, 16 lanes a group) both ran slower. Inputs and output
// are (B, S, H, N) contiguous, read in place; u is (H, N).
#include <cuda_runtime.h>
#include <stdint.h>

#define N 64                 // head size (WKV channels)
#define RPL 8                // rows a lane: two float4 groups
#define CPL 4                // columns a lane
#define LPG (N / RPL)        // lanes a column group: 8
#define NTH (N / CPL * LPG)  // threads a block: 16 column groups, 128
#define TC 32                // steps staged per chunk
#define FULL_MASK 0xffffffffu

struct Chunk {               // one buffer of TC staged steps
  float r[TC][N], k[TC][N], w[TC][N], v[TC][N];
  float ruk[TC];
};

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// Stage steps [t0, t0 + tc) of r, k, w, v into `c`; `vec`: every operand is
// 16-byte aligned (each step of a head is N consecutive floats).
__device__ __forceinline__ void stage(Chunk& c, const float* r,
                                      const float* k, const float* w,
                                      const float* v, size_t base,
                                      size_t step, int t0, int tc, bool vec) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float* src = (a == 0 ? r : a == 1 ? k : a == 2 ? w : v) + base +
                       (size_t)t0 * step;
    float* dst = a == 0 ? &c.r[0][0] : a == 1 ? &c.k[0][0]
                 : a == 2 ? &c.w[0][0] : &c.v[0][0];
    if (vec) {
      for (int e = threadIdx.x; e < tc * (N / 4); e += NTH) {
        const int i = e / (N / 4), n = 4 * (e % (N / 4));
        cp16(dst + i * N + n, src + (size_t)i * step + n);
      }
    } else {
      for (int e = threadIdx.x; e < tc * N; e += NTH) {
        const int i = e / N, n = e % N;
        cp4(dst + i * N + n, src + (size_t)i * step + n);
      }
    }
  }
}

__global__ void __launch_bounds__(NTH)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ y, int s_len,
            int h_num, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  Chunk* buf = reinterpret_cast<Chunk*>(smem);
  __shared__ float us[N];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane & (LPG - 1);          // row group
  const int m0 = CPL * (tid / LPG);        // first column of the group
  // after the reduction this lane holds y of column m0 + jy
  const int jy = 2 * ((g >> 2) & 1) + ((g >> 1) & 1);
  const int b = blockIdx.x / h_num;
  const int h = blockIdx.x - b * h_num;
  const size_t step = (size_t)h_num * N;
  const size_t base = ((size_t)b * s_len * h_num + h) * N;
  if (tid < N) us[tid] = u[h * N + tid];

  // S[n, m0 + j] of rows n = 4 (g + LPG q) + c: st[q][c][j]
  float st[2][4][CPL];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < CPL; ++j) st[q][c][j] = 0.f;

  const int nch = (s_len + TC - 1) / TC;
  stage(buf[0], r, k, w, v, base, step, 0, min(TC, s_len), vec);
  cp_commit();
  for (int ch = 0; ch < nch; ++ch) {
    const int t0 = ch * TC, tc = min(TC, s_len - t0);
    Chunk& c = buf[ch & 1];
    if (ch + 1 < nch) {
      stage(buf[(ch + 1) & 1], r, k, w, v, base, step, t0 + TC,
            min(TC, s_len - t0 - TC), vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    // clamp the decays; ruk_t: four lanes a step, 16 channels each in
    // order, then added at xor 1 and 2
    for (int e = tid; e < tc * N; e += NTH)
      (&c.w[0][0])[e] = fmaxf((&c.w[0][0])[e], 1e-12f);
    for (int i0 = 0; i0 < tc; i0 += NTH / 4) {
      const int i = i0 + tid / 4, n0 = 16 * (tid & 3);
      float p = 0.f;
      if (i < tc)
#pragma unroll
        for (int n = n0; n < n0 + 16; ++n)
          p = fmaf(c.r[i][n] * us[n], c.k[i][n], p);
      p += __shfl_xor_sync(FULL_MASK, p, 1);
      p += __shfl_xor_sync(FULL_MASK, p, 2);
      if (i < tc && (tid & 3) == 0) c.ruk[i] = p;
    }
    __syncthreads();
    float* yp = y + base + (size_t)t0 * step + m0 + jy;
#pragma unroll 2
    for (int i = 0; i < tc; ++i, yp += step) {
      const float4 v4 = *reinterpret_cast<const float4*>(&c.v[i][m0]);
      const float vj[CPL] = {v4.x, v4.y, v4.z, v4.w};
      const float vy = jy & 2 ? (jy & 1 ? v4.w : v4.z)
                              : (jy & 1 ? v4.y : v4.x);
      float acc[CPL];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n0 = 4 * (g + LPG * q);
        const float4 r4 = *reinterpret_cast<const float4*>(&c.r[i][n0]);
        const float4 k4 = *reinterpret_cast<const float4*>(&c.k[i][n0]);
        const float4 w4 = *reinterpret_cast<const float4*>(&c.w[i][n0]);
        const float rn[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kn[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wn[4] = {w4.x, w4.y, w4.z, w4.w};
        float part[CPL];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            part[j] = cc == 0 ? rn[0] * st[q][0][j]
                              : fmaf(rn[cc], st[q][cc][j], part[j]);
            st[q][cc][j] = fmaf(st[q][cc][j], wn[cc], kn[cc] * vj[j]);
          }
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          acc[j] = q == 0 ? part[j] : acc[j] + part[j];
      }
      // the 8 lanes of the group: halve the columns at xor 4 and xor 2,
      // then add the pair at xor 1
      const bool up = g & 4, mid = g & 2;
      float k0 = up ? acc[2] : acc[0], k1 = up ? acc[3] : acc[1];
      k0 += __shfl_xor_sync(FULL_MASK, up ? acc[0] : acc[2], 4);
      k1 += __shfl_xor_sync(FULL_MASK, up ? acc[1] : acc[3], 4);
      float a = mid ? k1 : k0;
      a += __shfl_xor_sync(FULL_MASK, mid ? k0 : k1, 2);
      a += __shfl_xor_sync(FULL_MASK, a, 1);
      if (!(g & 1)) *yp = fmaf(vy, c.ruk[i], a);
    }
    __syncthreads();   // buffer ch & 1 is staged into again at ch + 2
  }
}

extern "C" int wkv6_f32(const float* r, const float* k, const float* v,
                        const float* w, const float* u, float* y, int b,
                        int s_len, int h_num, void* stream) {
  const int smem = 2 * (int)sizeof(Chunk);
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = (((uintptr_t)r | (uintptr_t)k | (uintptr_t)v |
                    (uintptr_t)w) & 15) == 0;
  wkv6_kernel<<<b * h_num, NTH, smem, (cudaStream_t)stream>>>(
      r, k, v, w, u, y, s_len, h_num, vec);
  return (int)cudaGetLastError();
}
