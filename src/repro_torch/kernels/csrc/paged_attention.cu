// Flat-token paged attention over a block-paged KV cache (float32).
//
// Replaces the Pallas kernel `paged_prefill_attention` of the JAX package
// (src/repro/kernels/paged_attention.py, `_prefill_kernel` + `_flash_body`).
// Token t reads row slot_ids[t] of the block table and attends over its
// first context_lens[t] keys with a streaming softmax.
//
// On the TPU the block-table axis was a sequential grid dimension carrying
// (max, denom, acc) in scratch. Here one thread block owns one (token,
// kv-head) pair and walks the token's table row in a loop; the running
// (max, denom, acc) of its G = Hq/Hkv query heads stay in shared memory.
// Blocks past the context are never loaded; keys >= ctx inside the last
// block are masked with -1e30 (after the optional softcap), as the
// reference does. q is pre-scaled by 1/sqrt(D) before the dot.
//
// Bound on the card: bytes. Each token reads its ctx keys and values once
// (ctx * Hkv * D * 8 bytes) for about 4 * ctx * Hq * D flops, far below the
// ~20 flop/byte where float32 CUDA cores would limit. The design keeps each
// K/V block in shared memory for the G query heads that share it; the
// stride of the K tile is padded by one float so the per-key dot products
// of neighbouring threads fall in different banks.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NEG_INF_F (-1e30f)
#define NT 128

__global__ void __launch_bounds__(NT)
paged_prefill_attention_kernel(const float* __restrict__ q,
                               const float* __restrict__ k_pool,
                               const float* __restrict__ v_pool,
                               const int32_t* __restrict__ block_tables,
                               const int32_t* __restrict__ slot_ids,
                               const int32_t* __restrict__ context_lens,
                               float* __restrict__ out,
                               int hq, int hkv, int d, int bs, int mb,
                               float scale, float softcap) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int g = hq / hkv;
  const int kstride = d + 1;
  float* qs = smem;                   // (g, d) pre-scaled queries
  float* ks = qs + g * d;             // (bs, d + 1)
  float* vs = ks + bs * kstride;      // (bs, d)
  float* sc = vs + bs * d;            // (g, bs) scores, then probabilities
  float* acc = sc + g * bs;           // (g, d)
  float* m_s = acc + g * d;           // (g,) running max
  float* l_s = m_s + g;               // (g,) running denominator
  float* a_s = l_s + g;               // (g,) rescale of this step

  const int tid = threadIdx.x;
  const int ctx = context_lens[t];
  const int32_t* table = block_tables + (size_t)slot_ids[t] * mb;
  const size_t tok_base = ((size_t)t * hq + (size_t)h * g) * d;

  for (int i = tid; i < g * d; i += NT) {
    qs[i] = q[tok_base + i] * scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += NT) {
    m_s[i] = NEG_INF_F;
    l_s[i] = 0.f;
  }
  __syncthreads();

  int nblk = (ctx + bs - 1) / bs;
  if (nblk > mb) nblk = mb;
  for (int j = 0; j < nblk; ++j) {
    const size_t blk_base = (size_t)table[j] * bs * hkv * d;
    for (int i = tid; i < bs * d; i += NT) {
      const int s = i / d, di = i - s * d;
      const size_t off = blk_base + ((size_t)s * hkv + h) * d + di;
      ks[s * kstride + di] = k_pool[off];
      vs[i] = v_pool[off];
    }
    __syncthreads();
    for (int i = tid; i < g * bs; i += NT) {
      const int gi = i / bs, s = i - gi * bs;
      const float* qrow = qs + gi * d;
      const float* krow = ks + s * kstride;
      float dot = 0.f;
      for (int di = 0; di < d; ++di) dot += qrow[di] * krow[di];
      if (softcap > 0.f) dot = softcap * tanhf(dot / softcap);
      if (j * bs + s >= ctx) dot = NEG_INF_F;
      sc[i] = dot;
    }
    __syncthreads();
    for (int gi = tid; gi < g; gi += NT) {
      float* row = sc + gi * bs;
      float mc = NEG_INF_F;
      for (int s = 0; s < bs; ++s) mc = fmaxf(mc, row[s]);
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, mc);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int s = 0; s < bs; ++s) {
        const float p = expf(row[s] - m_new);
        row[s] = p;
        sum += p;
      }
      l_s[gi] = l_s[gi] * alpha + sum;
      m_s[gi] = m_new;
      a_s[gi] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < g * d; i += NT) {
      const int gi = i / d, di = i - gi * d;
      const float* prow = sc + gi * bs;
      float pv = 0.f;
      for (int s = 0; s < bs; ++s) pv += prow[s] * vs[s * d + di];
      acc[i] = acc[i] * a_s[gi] + pv;
    }
    __syncthreads();
  }
  for (int i = tid; i < g * d; i += NT) {
    out[tok_base + i] = acc[i] / l_s[i / d];
  }
}

extern "C" int paged_prefill_attention_f32(
    const float* q, const float* k_pool, const float* v_pool,
    const int32_t* block_tables, const int32_t* slot_ids,
    const int32_t* context_lens, float* out, int t, int hq, int hkv, int d,
    int bs, int mb, float scale, float softcap, void* stream) {
  const int g = hq / hkv;
  const size_t smem = sizeof(float) *
      ((size_t)g * d + (size_t)bs * (d + 1) + (size_t)bs * d +
       (size_t)g * bs + (size_t)g * d + 3 * (size_t)g);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_attention_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(t, hkv);
  paged_prefill_attention_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      q, k_pool, v_pool, block_tables, slot_ids, context_lens, out, hq, hkv,
      d, bs, mb, scale, softcap);
  return (int)cudaGetLastError();
}
