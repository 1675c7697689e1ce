// RWKV6 WKV recurrence (the time-mix of an rwkv6 block), float32, from a
// zero state:
//
//   y_t[m] = sum_n r_t[n] (S[n,m] + u[n] k_t[n] v_t[m])
//   S[n,m] <- S[n,m] max(w_t[n], 1e-12) + k_t[n] v_t[m]
//
// Replaces the Pallas kernel `wkv6` of the JAX package
// (src/repro/kernels/rwkv6_wkv.py, `_kernel`). That kernel walked chunks of
// Q = 64 steps along a sequential grid axis and formed, per chunk, the
// (Q, Q, N) tensor of pairwise decays exp(cum_{i-1} - cum_j) (1 MB, resident
// in VMEM) so that the MXU could do the chunk as matrix products. Here that
// tensor does not fit a block's shared memory, and the state fits in
// registers, so the kernel runs the sequential form: it never forms exp of a
// cumulative log-decay, and needs no padding of S to a chunk multiple. The
// decay clamp is the one of the reference's `wkv_chunked` (log(max(w,
// 1e-12))).
//
// Bound on the card: bytes. Per (batch, head) the function reads r, k, v
// and w (4 S N floats) and writes y (S N floats) for about 5 S N^2 flops
// (r^T S, and the decay and rank-1 update of S), N / 4 = 16 flops a byte,
// below the float32 ridge (20 flops a byte). At the training shapes (B 8,
// S 128, H 40, N 64) that is 52 MB, 0.016 ms at 3.35 TB/s. Being a
// recurrence over S, the kernel is bound in practice by the latency of one
// step times S.
//
// Design: one block per (batch, head), N = 64 threads, thread m owning the
// state column S[:, m] in 64 registers. TC steps of r, k, w, u*k and v are
// staged into shared memory with coalesced loads (a step of one head is
// N consecutive floats of the (B, S, H, N) layout, read in place); then each
// step reads r, w and u*k as broadcast float4s and updates the column.
// Inputs and output are (B, S, H, N) contiguous; u is (H, N).
#include <cuda_runtime.h>

#define N 64                 // head size (WKV channels), one thread each
#define TC 32                // steps staged per round

__global__ void __launch_bounds__(N)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ y, int s_len,
            int h_num) {
  __shared__ __align__(16) float rs[TC][N];
  __shared__ __align__(16) float ws[TC][N];
  __shared__ __align__(16) float uks[TC][N];
  __shared__ __align__(16) float ks[TC][N];
  __shared__ float vs[TC][N];

  const int m = threadIdx.x;
  const int b = blockIdx.x / h_num;
  const int h = blockIdx.x - b * h_num;
  const size_t step = (size_t)h_num * N;
  const size_t base = ((size_t)b * s_len * h_num + h) * N;
  const float u_m = u[h * N + m];

  float st[N];
#pragma unroll
  for (int n = 0; n < N; ++n) st[n] = 0.f;

  for (int t0 = 0; t0 < s_len; t0 += TC) {
    const int tc = min(TC, s_len - t0);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < tc; ++i) {
      const size_t off = base + (size_t)(t0 + i) * step + m;
      const float kk = k[off];
      rs[i][m] = r[off];
      ks[i][m] = kk;
      uks[i][m] = u_m * kk;
      ws[i][m] = fmaxf(w[off], 1e-12f);
      vs[i][m] = v[off];
    }
    __syncthreads();
    for (int i = 0; i < tc; ++i) {
      const float vm = vs[i][m];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < N; n += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[i][n]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[i][n]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[i][n]);
        const float4 uk4 = *reinterpret_cast<const float4*>(&uks[i][n]);
        acc[0] = fmaf(r4.x, fmaf(uk4.x, vm, st[n + 0]), acc[0]);
        acc[1] = fmaf(r4.y, fmaf(uk4.y, vm, st[n + 1]), acc[1]);
        acc[2] = fmaf(r4.z, fmaf(uk4.z, vm, st[n + 2]), acc[2]);
        acc[3] = fmaf(r4.w, fmaf(uk4.w, vm, st[n + 3]), acc[3]);
        st[n + 0] = fmaf(st[n + 0], w4.x, k4.x * vm);
        st[n + 1] = fmaf(st[n + 1], w4.y, k4.y * vm);
        st[n + 2] = fmaf(st[n + 2], w4.z, k4.z * vm);
        st[n + 3] = fmaf(st[n + 3], w4.w, k4.w * vm);
      }
      y[base + (size_t)(t0 + i) * step + m] = (acc[0] + acc[1]) +
                                              (acc[2] + acc[3]);
    }
  }
}

extern "C" int wkv6_f32(const float* r, const float* k, const float* v,
                        const float* w, const float* u, float* y, int b,
                        int s_len, int h_num, void* stream) {
  wkv6_kernel<<<b * h_num, N, 0, (cudaStream_t)stream>>>(r, k, v, w, u, y,
                                                         s_len, h_num);
  return (int)cudaGetLastError();
}
