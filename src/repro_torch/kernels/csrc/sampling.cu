// Fused temperature/top-k warp and inverse-CDF draw, one token per row.
//
// Replaces the Pallas kernel `topk_mask_sample` of the JAX package
// (src/repro/kernels/sampling.py, `_sample_kernel`). On the TPU a grid of
// (S, 2, NBV) carried its running state across vocab blocks in scratch,
// one row at a time. Here each row is cut into splits that run on
// separate blocks, and a call is three launches over scratch that the
// wrapper allocates (`split_layout` in kernels/sampling.py sizes both from
// S and V alone):
//
//   max_kernel   (splits x S blocks): each split, a whole number of
//                bv-blocks, writes its raw argmax (value, first index) and
//                the max of its kept warped logits z = x / max(t, 1e-30),
//                z >= threshold.
//   sums_kernel  (splits x S): each block merges its row's split maxima,
//                forms e = exp(z - max) (0 where z < threshold) and writes
//                one sum per bv-block in a fixed tree order: thread j adds
//                entries 4j..4j+3 in order, a warp adds its lanes by an xor
//                butterfly, thread 0 adds the warps in order.
//   draw_kernel  (S blocks, or splits x S with probs): the two-level rule
//                of the reference (`sample_cdf_ref`, block 1024): a
//                prefix sum over the row's block sums (a thread's run of
//                consecutive sums on top of a block-wide exclusive scan of
//                the runs' totals), target = u * total with total the last
//                prefix; the count of prefixes <= target, clamped to nb - 1,
//                is the crossing block b; one block-wide scan of b's e on
//                top of prefix b - 1 counts the entries <= target, and the
//                token is b * bv + count, clamped to V - 1 (searchsorted
//                side="right"). With a probs pointer every block writes
//                e / total over its split (one-hot for greedy rows).
//
// Greedy rows (temperature <= 0) take the merged argmax, first occurrence,
// and skip the sums and the draw. The maxima and the argmax merge are exact
// whatever the order, and every sum runs in the fixed order above, so two
// calls give the same bits; the tokens do not depend on the split layout.
// No atomics, no host synchronisation. The three launches are programmatic
// dependent launches (as csrc/paged_attention.cu's): each waits
// (griddepcontrol.wait) before it reads what the launch before wrote.
//
// Bound on the card: bytes, one read of the (S, V) float32 logits (the
// second read, by sums_kernel, mostly hits L2 at the serving shapes: 8 MB at
// S 8, V 262144). The old design ran one block a row, so at S 8 only 8 of
// 132 SMs streamed; splits of up to MAXB bv-blocks give about TARGET_BLOCKS
// blocks a launch (512 at S 8, V 262144), and each thread keeps its
// float4 loads of all its blocks in flight at once.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NT 256                // threads a block
#define NW (NT / 32)
#define BV 1024               // the reference's block of the two-level CDF
#define MAXB 64               // bv-blocks a split at most (split_layout)
#define U 4                   // bv-blocks whose loads a thread has in flight
#define FULL_MASK 0xffffffffu

struct Part {                 // a split's partial state
  float best;                 // raw max
  int idx;                    // its first index
  float zmax;                 // max of the kept warped logits
  float pad;
};

// Programmatic dependent launch (see csrc/lowrank_core.cuh).
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void merge_arg(float& v, int& i, float v2,
                                          int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// The four entries 4j..4j+3 of bv-block `blk` that thread j owns; `ok[c]`
// false past the block or the row.
__device__ __forceinline__ void load4(const float* x, int v, int bv, int blk,
                                      float (&xs)[4], bool (&ok)[4]) {
  const int off = 4 * threadIdx.x;
  const int i0 = blk * bv + off;
  const float* p = x + i0;
  if (off + 3 < bv && i0 + 3 < v && ((uintptr_t)p & 15) == 0) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    xs[0] = q.x, xs[1] = q.y, xs[2] = q.z, xs[3] = q.w;
    ok[0] = ok[1] = ok[2] = ok[3] = true;
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    ok[c] = off + c < bv && i0 + c < v;
    xs[c] = ok[c] ? p[c] : 0.f;
  }
}

// e = exp(z - m) of a kept entry, 0 otherwise
__device__ __forceinline__ float weight(float xi, float t, float thr,
                                        float m) {
  const float z = xi / t;
  return z >= thr ? expf(z - m) : 0.f;
}

// ------------------------------------------------------ block reductions

__device__ __forceinline__ void block_argmax(float& v, int& i) {
  __shared__ float sv[NW];
  __shared__ int si[NW];
  for (int o = 16; o > 0; o >>= 1)
    merge_arg(v, i, __shfl_xor_sync(FULL_MASK, v, o),
              __shfl_xor_sync(FULL_MASK, i, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sv[warp] = v, si[warp] = i;
  __syncthreads();
  v = sv[0], i = si[0];
  for (int w = 1; w < NW; ++w) merge_arg(v, i, sv[w], si[w]);
}

__device__ __forceinline__ float block_max(float v) {
  __shared__ float sv[NW];
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sv[warp] = v;
  __syncthreads();
  v = sv[0];
  for (int w = 1; w < NW; ++w) v = fmaxf(v, sv[w]);
  return v;
}

__device__ __forceinline__ int block_count(int c) {
  __shared__ int sc[NW];
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(FULL_MASK, c, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sc[warp] = c;
  __syncthreads();
  c = 0;
  for (int w = 0; w < NW; ++w) c += sc[w];
  return c;
}

// Exclusive prefix of x over the block's threads: Hillis-Steele within each
// warp, the same over the warps' totals, then warp offset + lane offset.
__device__ __forceinline__ float block_excl_scan(float x) {
  __shared__ float sw[NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += n;
  }
  __syncthreads();
  if (lane == 31) sw[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float w = lane < NW ? sw[lane] : 0.f;
    for (int o = 1; o < NW; o <<= 1) {
      const float n = __shfl_up_sync(FULL_MASK, w, o);
      if (lane >= o) w += n;
    }
    if (lane < NW) sw[lane] = w;
  }
  __syncthreads();
  const float lane_excl = __shfl_up_sync(FULL_MASK, incl, 1);
  return (warp > 0 ? sw[warp - 1] : 0.f) + (lane > 0 ? lane_excl : 0.f);
}

// The row's merged argmax and max of the kept warped logits over its splits.
__device__ __forceinline__ void merge_parts(const Part* parts, int splits,
                                            float& best, int& idx,
                                            float& zmax) {
  best = -INFINITY, idx = 0x7fffffff, zmax = -INFINITY;
  for (int s = threadIdx.x; s < splits; s += NT) {
    const Part q = parts[s];
    merge_arg(best, idx, q.best, q.idx);
    zmax = fmaxf(zmax, q.zmax);
  }
  block_argmax(best, idx);
  zmax = block_max(zmax);
}

struct Params {
  const float* logits;
  const float* temperature;
  const float* threshold;
  const float* uniforms;
  int32_t* tokens;
  float* probs;               // (S, V) or null
  Part* parts;                // (S, splits)
  float* bsum;                // (S, nb)
  int v, bv, nb, per, splits;
};

// ------------------------------------------------------------- kernels

__global__ void __launch_bounds__(NT) max_kernel(Params p) {
  griddep_wait();
  griddep_launch();
  const int sp = blockIdx.x, row = blockIdx.y;
  const float* x = p.logits + (size_t)row * p.v;
  const float t = fmaxf(p.temperature[row], 1e-30f);
  const float thr = p.threshold[row];
  const int b0 = sp * p.per, b1 = min(p.nb, b0 + p.per);
  float best = -INFINITY, zmax = -INFINITY;
  int idx = 0x7fffffff;
  for (int b = b0; b < b1; b += U) {
    float xs[U][4];
    bool ok[U][4];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (b + q < b1) {
        load4(x, p.v, p.bv, b + q, xs[q], ok[q]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) ok[q][c] = false, xs[q][c] = 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!ok[q][c]) continue;
        const float xi = xs[q][c];
        merge_arg(best, idx, xi, (b + q) * p.bv + 4 * threadIdx.x + c);
        const float z = xi / t;
        if (z >= thr) zmax = fmaxf(zmax, z);
      }
    }
  }
  block_argmax(best, idx);
  zmax = block_max(zmax);
  if (threadIdx.x == 0) p.parts[(size_t)row * p.splits + sp] =
      Part{best, idx, zmax, 0.f};
}

__global__ void __launch_bounds__(NT) sums_kernel(Params p) {
  __shared__ float sw[MAXB][NW];
  griddep_wait();
  griddep_launch();
  const int sp = blockIdx.x, row = blockIdx.y;
  const float temp = p.temperature[row];
  if (!(temp > 0.f)) return;              // greedy: no draw
  float best, zmax;
  int idx;
  merge_parts(p.parts + (size_t)row * p.splits, p.splits, best, idx, zmax);
  const float* x = p.logits + (size_t)row * p.v;
  const float t = fmaxf(temp, 1e-30f);
  const float thr = p.threshold[row];
  const int b0 = sp * p.per, b1 = min(p.nb, b0 + p.per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = b0; b < b1; b += U) {
    float xs[U][4];
    bool ok[U][4];
#pragma unroll
    for (int q = 0; q < U; ++q)
      if (b + q < b1) load4(x, p.v, p.bv, b + q, xs[q], ok[q]);
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (b + q >= b1) break;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s += ok[q][c] ? weight(xs[q][c], t, thr, zmax) : 0.f;
      for (int o = 16; o > 0; o >>= 1)
        s += __shfl_xor_sync(FULL_MASK, s, o);
      if (lane == 0) sw[b + q - b0][warp] = s;
    }
  }
  __syncthreads();
  const int b = b0 + threadIdx.x;
  if (b < b1) {
    float s = sw[threadIdx.x][0];
    for (int w = 1; w < NW; ++w) s += sw[threadIdx.x][w];
    p.bsum[(size_t)row * p.nb + b] = s;
  }
}

// dynamic shared memory: the row's nb prefixes
__global__ void __launch_bounds__(NT) draw_kernel(Params p) {
  extern __shared__ float cum[];
  griddep_wait();
  griddep_launch();
  const int sp = blockIdx.x, row = blockIdx.y;
  const float temp = p.temperature[row];
  const bool greedy = !(temp > 0.f);
  float best, zmax;
  int idx;
  merge_parts(p.parts + (size_t)row * p.splits, p.splits, best, idx, zmax);
  const int lo = sp * p.per * p.bv;
  const int hi = min(p.v, lo + p.per * p.bv);
  float* prow = p.probs ? p.probs + (size_t)row * p.v : nullptr;
  if (greedy) {
    if (sp == 0 && threadIdx.x == 0) p.tokens[row] = idx;
    if (prow)
      for (int i = lo + threadIdx.x; i < hi; i += NT)
        prow[i] = i == idx ? 1.f : 0.f;
    return;
  }
  // prefixes of the block sums: thread j owns a run of c consecutive sums
  const float* bs = p.bsum + (size_t)row * p.nb;
  const int c = (p.nb + NT - 1) / NT;
  const int j0 = threadIdx.x * c, j1 = min(p.nb, j0 + c);
  float run = 0.f;
  for (int j = j0; j < j1; ++j) run += bs[j];
  run = block_excl_scan(run);
  for (int j = j0; j < j1; ++j) {
    run += bs[j];
    cum[j] = run;
  }
  __syncthreads();
  const float total = cum[p.nb - 1];
  if (prow) {
    const float* x = p.logits + (size_t)row * p.v;
    const float t = fmaxf(temp, 1e-30f);
    const float thr = p.threshold[row];
    for (int i = lo + threadIdx.x; i < hi; i += NT)
      prow[i] = weight(x[i], t, thr, zmax) / total;
  }
  if (sp != 0) return;
  const float target = p.uniforms[row] * total;
  int n = 0;
  for (int j = j0; j < j1; ++j) n += cum[j] <= target;
  const int blk = min(block_count(n), p.nb - 1);
  const float carry = blk > 0 ? cum[blk - 1] : 0.f;
  // the crossing block: thread j's four entries on top of the scan
  float xs[4], e[4];
  bool ok[4];
  load4(p.logits + (size_t)row * p.v, p.v, p.bv, blk, xs, ok);
  const float t = fmaxf(temp, 1e-30f);
  const float thr = p.threshold[row];
  float a = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    a += ok[q] ? weight(xs[q], t, thr, zmax) : 0.f;
    e[q] = a;
  }
  const float base = carry + block_excl_scan(a);
  n = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) n += ok[q] && base + e[q] <= target;
  n = block_count(n);
  if (threadIdx.x == 0) p.tokens[row] = min(blk * p.bv + n, p.v - 1);
}

// ----------------------------------------------------------------- host

template <class... KP>
static int launch(void (*kernel)(KP...), dim3 grid, int smem,
                  cudaStream_t stream, const Params& p) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int topk_mask_sample_f32(const float* logits,
                                    const float* temperature,
                                    const float* threshold,
                                    const float* uniforms, int s, int v,
                                    int bv, int nb, int per, int splits,
                                    int32_t* tokens, float* probs,
                                    float* scratch, void* stream) {
  if (s < 1 || v < 1 || bv < 1 || bv > BV || (bv < BV && nb != 1) ||
      nb != (v + bv - 1) / bv || per < 1 || per > MAXB ||
      splits != (nb + per - 1) / per || s > 65535 || splits > 65535 ||
      (size_t)nb * sizeof(float) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  Params p = {logits, temperature, threshold, uniforms, tokens, probs,
              reinterpret_cast<Part*>(scratch),
              scratch + (size_t)s * splits * 4, v, bv, nb, per, splits};
  const cudaStream_t st = (cudaStream_t)stream;
  int e = launch(max_kernel, dim3(splits, s), 0, st, p);
  if (e) return e;
  e = launch(sums_kernel, dim3(splits, s), 0, st, p);
  if (e) return e;
  return launch(draw_kernel, dim3(probs ? splits : 1, s),
                nb * (int)sizeof(float), st, p);
}
