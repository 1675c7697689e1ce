// Fused temperature/top-k warp and inverse-CDF draw, one token per row.
//
// Replaces the Pallas kernel `topk_mask_sample` of the JAX package
// (src/repro/kernels/sampling.py, `_sample_kernel`). On the TPU a grid of
// (S, 2, NBV) carried its running state across vocab blocks in scratch.
// Here one thread block owns one row and makes both passes over V itself:
//
//   pass 0: each thread streams a strided slice of the row, keeping the raw
//           argmax (first occurrence) and an online (max, denom) of the
//           warped logits z = x / max(t, 1e-30), entries with z < threshold
//           left out; the block then merges the per-thread states.
//   pass 1: the row is re-read in chunks of NT entries; e = exp(z - max) is
//           scanned across the block, the carried chunk total is added,
//           and entries whose running CDF is <= u * denom are counted. The
//           count, clamped to V - 1, is the sampled token (the
//           searchsorted(side="right") rule of the reference). With a
//           probs pointer the warped distribution is written as well,
//           one-hot for greedy rows (temperature <= 0).
//
// Greedy rows return the raw argmax and ignore u. V need not be a multiple
// of anything: the last chunk is masked.
//
// Bound on the card: bytes. The row is read twice (8 * V bytes per row,
// about 10 flops per entry); the design reads the logits straight from
// device memory with neighbouring threads on neighbouring entries, and
// never materialises the warped row unless probs are asked for. With few
// rows only a few SMs work; spreading one row over several blocks is work
// for a later change.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NEG_INF_F (-1e30f)
#define NT 1024
#define NWARPS (NT / 32)
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ void merge_ml(float& m, float& l, float m2,
                                         float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void merge_arg(float& v, int& i, float v2,
                                          int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__global__ void __launch_bounds__(NT)
topk_mask_sample_kernel(const float* __restrict__ logits,
                        const float* __restrict__ temperature,
                        const float* __restrict__ threshold,
                        const float* __restrict__ uniforms, int v,
                        int32_t* __restrict__ tokens,
                        float* __restrict__ probs) {
  __shared__ float sh_m[NWARPS], sh_l[NWARPS], sh_best[NWARPS];
  __shared__ int sh_idx[NWARPS];
  __shared__ float sh_scan[NWARPS];
  __shared__ int sh_cnt[NWARPS];
  __shared__ float fin_m, fin_l;
  __shared__ int fin_idx;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* x = logits + (size_t)row * v;
  const float temp = temperature[row];
  const float t = fmaxf(temp, 1e-30f);
  const float thr = threshold[row];

  // pass 0: greedy argmax + online (max, denom) of the kept warped logits
  float best = -INFINITY;
  int bidx = 0x7fffffff;
  float m = NEG_INF_F, l = 0.f;
  for (int i = tid; i < v; i += NT) {
    const float xi = x[i];
    if (xi > best) {
      best = xi;
      bidx = i;
    }
    const float z = xi / t;
    if (z >= thr) {
      if (z > m) {
        l = l * expf(m - z) + 1.f;
        m = z;
      } else {
        l += expf(z - m);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(FULL_MASK, m, o);
    const float l2 = __shfl_xor_sync(FULL_MASK, l, o);
    merge_ml(m, l, m2, l2);
    const float b2 = __shfl_xor_sync(FULL_MASK, best, o);
    const int i2 = __shfl_xor_sync(FULL_MASK, bidx, o);
    merge_arg(best, bidx, b2, i2);
  }
  if (lane == 0) {
    sh_m[warp] = m;
    sh_l[warp] = l;
    sh_best[warp] = best;
    sh_idx[warp] = bidx;
  }
  __syncthreads();
  if (warp == 0) {
    m = sh_m[lane];
    l = sh_l[lane];
    best = sh_best[lane];
    bidx = sh_idx[lane];
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(FULL_MASK, m, o);
      const float l2 = __shfl_xor_sync(FULL_MASK, l, o);
      merge_ml(m, l, m2, l2);
      const float b2 = __shfl_xor_sync(FULL_MASK, best, o);
      const int i2 = __shfl_xor_sync(FULL_MASK, bidx, o);
      merge_arg(best, bidx, b2, i2);
    }
    if (lane == 0) {
      fin_m = m;
      fin_l = l;
      fin_idx = bidx;
    }
  }
  __syncthreads();
  const float row_max = fin_m, denom = fin_l;
  const int argmax = fin_idx;
  const bool greedy = !(temp > 0.f);

  if (greedy && probs == nullptr) {
    if (tid == 0) tokens[row] = argmax;
    return;
  }

  // pass 1: chunked inclusive scan of e = exp(z - max), count CDF <= target
  const float target = uniforms[row] * denom;
  float carry = 0.f;
  int cnt = 0;
  for (int base = 0; base < v; base += NT) {
    const int i = base + tid;
    float e = 0.f;
    if (i < v) {
      const float z = x[i] / t;
      if (z >= thr) e = expf(z - row_max);
      if (probs != nullptr)
        probs[(size_t)row * v + i] =
            greedy ? (i == argmax ? 1.f : 0.f) : e / denom;
    }
    float incl = e;
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += n;
    }
    if (lane == 31) sh_scan[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      float w = sh_scan[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const float n = __shfl_up_sync(FULL_MASK, w, o);
        if (lane >= o) w += n;
      }
      sh_scan[lane] = w;
    }
    __syncthreads();
    const float cs = carry + incl + (warp > 0 ? sh_scan[warp - 1] : 0.f);
    if (i < v && cs <= target) ++cnt;
    carry += sh_scan[NWARPS - 1];
    __syncthreads();
  }
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(FULL_MASK, cnt, o);
  if (lane == 0) sh_cnt[warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < NWARPS; ++w) total += sh_cnt[w];
    if (total > v - 1) total = v - 1;
    tokens[row] = greedy ? argmax : total;
  }
}

extern "C" int topk_mask_sample_f32(const float* logits,
                                    const float* temperature,
                                    const float* threshold,
                                    const float* uniforms, int s, int v,
                                    int32_t* tokens, float* probs,
                                    void* stream) {
  topk_mask_sample_kernel<<<s, NT, 0, (cudaStream_t)stream>>>(
      logits, temperature, threshold, uniforms, v, tokens, probs);
  return (int)cudaGetLastError();
}
