// Mamba2 SSD scan (the selective state-space recurrence of a mamba2 block),
// float32, from a zero state:
//
//   S[n,p] <- S[n,p] exp(dt_t a_h) + b_t[n] (x_t[p] dt_t)
//   y_t[p]  = sum_n c_t[n] S[n,p]
//
// Replaces the Pallas kernel `ssd` of the JAX package
// (src/repro/kernels/mamba2_ssd.py, `_kernel`). That kernel walked chunks of
// Q = 128 steps along a sequential grid axis and did each chunk as matrix
// products on the MXU through a (Q, Q) matrix of pairwise decays
// exp(cum_i - cum_j). Here the (N, P) state of one head fits in the
// registers of one block, so the kernel runs the sequential form: no
// cumulative log-decay, no chunk padding. B and C stay grouped (B, S, G, N):
// head h reads group h / (H / G), where the reference's wrapper repeated
// them over the heads. The skip term d * x stays with the caller, as in the
// reference.
//
// Bound on the card: operations. Per (batch, head) the function reads x
// (S P floats) and dt (S) and writes y (S P), and per (batch, group) reads
// b and c (2 S N), for about 5 S N P flops (the decay and rank-1 update of
// S, and c^T S): 5 N / 8 = 40 flops a byte, above the float32 ridge (20).
// At zamba2's training shapes (B 8, S 128, H 112, G 1, P = N = 64) that is
// 2.35 GFLOP, 0.035 ms at 67 TFLOP/s, against 59 MB, 0.018 ms at 3.35
// TB/s. Being a recurrence over S, the kernel is bound in practice by the
// latency of one step times S.
//
// Design: one block per (batch, head), P = 64 threads, thread p owning the
// state column S[:, p] (N = 64 floats) in registers. TC steps of the
// group's b and c, the head's x and dt are staged into shared memory with
// coalesced loads (in place in the (B, S, H, P), (B, S, H) and (B, S, G, N)
// layouts); then each step reads b and c as broadcast float4s.
#include <cuda_runtime.h>

#define P 64                 // head size, one thread per channel
#define NS 64                // state size (loaded one value per thread)
#define TC 32                // steps staged per round

__global__ void __launch_bounds__(P)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ c, float* __restrict__ y, int s_len,
           int h_num, int g_num) {
  __shared__ __align__(16) float bs[TC][NS];
  __shared__ __align__(16) float cs[TC][NS];
  __shared__ float xs[TC][P];
  __shared__ float dts[TC];

  const int p = threadIdx.x;
  const int bi = blockIdx.x / h_num;
  const int h = blockIdx.x - bi * h_num;
  const int g = h / (h_num / g_num);
  const float a_h = a[h];

  float st[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) st[n] = 0.f;

  for (int t0 = 0; t0 < s_len; t0 += TC) {
    const int tc = min(TC, s_len - t0);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < tc; ++i) {
      const size_t t = (size_t)bi * s_len + t0 + i;
      const size_t bc = (t * g_num + g) * NS + p;
      bs[i][p] = b[bc];
      cs[i][p] = c[bc];
      xs[i][p] = x[(t * h_num + h) * P + p];
    }
    if (p < tc) dts[p] = dt[((size_t)bi * s_len + t0 + p) * h_num + h];
    __syncthreads();
    for (int i = 0; i < tc; ++i) {
      const float dtt = dts[i];
      const float decay = expf(dtt * a_h);
      const float xdt = xs[i][p] * dtt;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NS; n += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&bs[i][n]);
        const float4 c4 = *reinterpret_cast<const float4*>(&cs[i][n]);
        st[n + 0] = fmaf(st[n + 0], decay, b4.x * xdt);
        st[n + 1] = fmaf(st[n + 1], decay, b4.y * xdt);
        st[n + 2] = fmaf(st[n + 2], decay, b4.z * xdt);
        st[n + 3] = fmaf(st[n + 3], decay, b4.w * xdt);
        acc[0] = fmaf(c4.x, st[n + 0], acc[0]);
        acc[1] = fmaf(c4.y, st[n + 1], acc[1]);
        acc[2] = fmaf(c4.z, st[n + 2], acc[2]);
        acc[3] = fmaf(c4.w, st[n + 3], acc[3]);
      }
      y[(((size_t)bi * s_len + t0 + i) * h_num + h) * P + p] =
          (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }
}

extern "C" int ssd_f32(const float* x, const float* dt, const float* a,
                       const float* b, const float* c, float* y, int batch,
                       int s_len, int h_num, int g_num, void* stream) {
  ssd_kernel<<<batch * h_num, P, 0, (cudaStream_t)stream>>>(
      x, dt, a, b, c, y, s_len, h_num, g_num);
  return (int)cudaGetLastError();
}
