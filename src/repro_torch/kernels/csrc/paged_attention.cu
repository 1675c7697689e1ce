// Paged attention over a block-paged KV cache (float32): the decode kernel
// (one query token a batch slot) and the flat-token kernel (mixed
// chunked-prefill/decode iterations), sharing one streaming-softmax body.
//
// Replaces the Pallas kernels `paged_attention` (decode, `_kernel`) and
// `paged_prefill_attention` (`_prefill_kernel`) of the JAX package
// (src/repro/kernels/paged_attention.py), whose shared block step is
// `_flash_body`; here it is `attend`. The decode kernel's grid is (B, Hkv):
// block (b, h) reads row b of the block table directly. The flat-token
// kernel's grid is (T, Hkv): token t reads row slot_ids[t].
//
// On the TPU the block-table axis was a sequential grid dimension carrying
// (max, denom, acc) in scratch. Here one thread block owns one (row,
// kv-head) pair and walks its table row in a loop; the running (max, denom,
// acc) of its G = Hq/Hkv query heads stay in shared memory. Keys are valid
// on [ctx - window, ctx), as `ref.paged_attention_ref` masks them: the loop
// starts at the block holding ctx - window and stops at the block holding
// ctx - 1, so blocks outside the window or past the context are never
// loaded. Keys outside the range inside the first and last blocks get -1e30
// after the optional softcap, as the reference masks them. A global layer
// passes a window of 1 << 30; ctx - window stays a signed int. q is
// pre-scaled by 1/sqrt(D) before the dot.
//
// Bound on the card: bytes. Each row reads its min(ctx, window) keys and
// values once (* Hkv * D * 8 bytes) for about 4 * keys * Hq * D flops, far
// below the ~20 flop/byte where float32 CUDA cores would limit. The design
// keeps each K/V block in shared memory for the G query heads that share it;
// the stride of the K tile is padded by one float so the per-key dot
// products of neighbouring threads fall in different banks. One block walks
// a whole table row one key block after another, so at decode (B * Hkv
// blocks, each over 1000+ keys) the kernel is bound by the latency of that
// walk, not by the bytes: splitting the row over several blocks with a
// second-pass combine is the later redesign.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NEG_INF_F (-1e30f)
#define NT 128

// One (row, kv-head) pair: q_row (Hq, D) of this row, its block-table row,
// its ctx and window; writes out_row (Hq, D) for the G heads of kv-head h.
__device__ __forceinline__ void attend(
    const float* __restrict__ q_row, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int32_t* __restrict__ table,
    int ctx, int window, float* __restrict__ out_row, int h, int hq, int hkv,
    int d, int bs, int mb, float scale, float softcap, float* smem) {
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
  const int head_base = h * g * d;
  const int lo = ctx - window;        // first valid key; < 0 for no limit

  for (int i = tid; i < g * d; i += NT) {
    qs[i] = q_row[head_base + i] * scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += NT) {
    m_s[i] = NEG_INF_F;
    l_s[i] = 0.f;
  }
  __syncthreads();

  int nblk = (ctx + bs - 1) / bs;
  if (nblk > mb) nblk = mb;
  const int j0 = lo > 0 ? lo / bs : 0;
  for (int j = j0; j < nblk; ++j) {
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
      const int kpos = j * bs + s;
      if (kpos >= ctx || kpos < lo) dot = NEG_INF_F;
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
    out_row[head_base + i] = acc[i] / l_s[i / d];
  }
}

// decode: block (b, h), row b of the table, one query token a slot
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k_pool,
                       const float* __restrict__ v_pool,
                       const int32_t* __restrict__ block_tables,
                       const int32_t* __restrict__ context_lens,
                       float* __restrict__ out, int hq, int hkv, int d,
                       int bs, int mb, float scale, float softcap,
                       int window) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const size_t row = (size_t)b * hq * d;
  attend(q + row, k_pool, v_pool, block_tables + (size_t)b * mb,
         context_lens[b], window, out + row, blockIdx.y, hq, hkv, d, bs, mb,
         scale, softcap, smem);
}

// flat tokens: block (t, h), row slot_ids[t] of the table
__global__ void __launch_bounds__(NT)
paged_prefill_attention_kernel(const float* __restrict__ q,
                               const float* __restrict__ k_pool,
                               const float* __restrict__ v_pool,
                               const int32_t* __restrict__ block_tables,
                               const int32_t* __restrict__ slot_ids,
                               const int32_t* __restrict__ context_lens,
                               float* __restrict__ out,
                               int hq, int hkv, int d, int bs, int mb,
                               float scale, float softcap, int window) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const size_t row = (size_t)t * hq * d;
  attend(q + row, k_pool, v_pool, block_tables + (size_t)slot_ids[t] * mb,
         context_lens[t], window, out + row, blockIdx.y, hq, hkv, d, bs, mb,
         scale, softcap, smem);
}

static size_t smem_bytes(int hq, int hkv, int d, int bs) {
  const int g = hq / hkv;
  return sizeof(float) *
         ((size_t)g * d + (size_t)bs * (d + 1) + (size_t)bs * d +
          (size_t)g * bs + (size_t)g * d + 3 * (size_t)g);
}

template <typename K>
static int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

extern "C" int paged_attention_f32(
    const float* q, const float* k_pool, const float* v_pool,
    const int32_t* block_tables, const int32_t* context_lens, float* out,
    int b, int hq, int hkv, int d, int bs, int mb, float scale, float softcap,
    int window, void* stream) {
  const size_t smem = smem_bytes(hq, hkv, d, bs);
  const int e = allow_smem(paged_attention_kernel, smem);
  if (e) return e;
  dim3 grid(b, hkv);
  paged_attention_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      q, k_pool, v_pool, block_tables, context_lens, out, hq, hkv, d, bs, mb,
      scale, softcap, window);
  return (int)cudaGetLastError();
}

extern "C" int paged_prefill_attention_f32(
    const float* q, const float* k_pool, const float* v_pool,
    const int32_t* block_tables, const int32_t* slot_ids,
    const int32_t* context_lens, float* out, int t, int hq, int hkv, int d,
    int bs, int mb, float scale, float softcap, int window, void* stream) {
  const size_t smem = smem_bytes(hq, hkv, d, bs);
  const int e = allow_smem(paged_prefill_attention_kernel, smem);
  if (e) return e;
  dim3 grid(t, hkv);
  paged_prefill_attention_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      q, k_pool, v_pool, block_tables, slot_ids, context_lens, out, hq, hkv,
      d, bs, mb, scale, softcap, window);
  return (int)cudaGetLastError();
}
