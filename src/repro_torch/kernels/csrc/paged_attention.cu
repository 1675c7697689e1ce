// Paged attention over a block-paged KV cache (float32): the decode kernel
// (one query token a batch slot) and the flat-token kernel (mixed
// chunked-prefill/decode iterations).
//
// Replaces the Pallas kernels `paged_attention` (decode, `_kernel`) and
// `paged_prefill_attention` (`_prefill_kernel`) of the JAX package
// (src/repro/kernels/paged_attention.py), whose shared block step is
// `_flash_body`. On the TPU the block-table axis was a sequential grid
// dimension carrying (max, denom, acc) in scratch; here the key axis is cut
// into splits that run on separate blocks and are combined in a second
// pass (flash-decoding).
//
// Splits. A split holds `split` keys (a whole number of cache blocks, about
// 256 keys; `split_layout` in kernels/paged_attention.py) and is aligned to
// key position 0, so which keys a split holds depends only on their
// positions: never on T, the grid or the caller. The keys of row t are
// [lo, hi) = [max(0, ctx - window), min(ctx, MB * BS)); a unit of work (a
// token or a tile of tokens, one kv-head, one split) that meets none of its
// rows' keys loads nothing and writes nothing. Each unit writes, for each of
// its query rows, the partial (m, l) and the unnormalised accumulator of its
// split to scratch that the wrapper allocates. A third kernel merges the
// partials of each (token, query head) in ascending split order, over
// exactly the splits that meet its keys: m = max m_s, l = sum l_s e^(m_s -
// m), o = sum acc_s e^(m_s - m) / l. No float atomics, so the same inputs
// give the same bits.
//
// Why a separate merge launch and not a last-block-done counter: the
// counter needs zeroed memory that outlives a call (or one more launch to
// zero it) and a fence per block. A call is two launches, attend_kernel
// then merge_kernel, both programmatic dependent launches (as
// csrc/lowrank_core.cuh's): each is scheduled while the kernel before it
// finishes and waits (griddepcontrol.wait) for it before it reads or
// writes anything, because the kernels around them (GAR's) start early
// too.
//
// Two kinds of unit, both in attend_kernel (a flat call's grid holds the
// blocks of both, so they run side by side):
//   token unit: a block of four warps attends one token's G = Hq / Hkv
//     query heads over one split. Warp w takes key batches w, w + 4, ...;
//     lanes run across D (16-byte loads, neighbouring lanes on neighbouring
//     addresses; 32 / LPK keys side by side when D / 4 < 32), K and V come
//     straight from global memory into registers, eight loads a lane in
//     flight, each dot product is a shuffle reduction, and the softmax runs
//     on every lane. The four warps' states are combined in warp order.
//     The decode call runs it for slot b over table row b; the flat call
//     for every token that shares its slot with no neighbour of its tile
//     window (decode tokens, a lone pad), in 16 blocks (more past 2048
//     tokens) that each scan every 16th token. So a slot's single query
//     token goes through the same instructions in both, and
//     paged_decode_step and paged_mixed_step with one token a slot give the
//     same bits.
//   tile unit: the flat tokens are cut into windows of TQ = 32 / G
//     consecutive tokens; a run of two or more consecutive tokens of one
//     slot inside a window (a piece of a prefill chunk, found on the device
//     from slot_ids) is one tile of up to 32 query rows. Its block stages
//     chunks of 16 keys of K and V (aligned to absolute key multiples of
//     16) in shared memory through a two-stage cp.async ring, so each K/V
//     byte read serves the whole tile. S = Q K^T: warp w sums a quarter of
//     D for all 32 x 16 scores, each lane a 4 x 4 register tile, and the
//     quarters are added in warp order. O = O * alpha + P V: each lane up
//     to 8 rows x 4 columns in registers, keys in order, each V vector read
//     once. Float32 FMA throughout; the online softmax runs a half-warp a
//     row. Causality inside the chunk is each token's own context: keys at
//     or past it get -1e30.
//   Both stage the split's block-table entries in shared memory first.
//   Scores follow the reference: q pre-scaled by 1/sqrt(D), the optional
//   softcap c * tanh(s / c), then -1e30 outside [lo, hi). expf and tanhf.
//
// Bounds on the H100. Decode (gemma3: 8 slots, 16 kv-heads, D 128, up to
// 2048 keys) reads ~200 MB of K/V for ~0.4 GFLOP: bound by bytes; 1024
// blocks of four warps (256 keys a block) spread over every SM keep loads
// in flight. gpt2 decode (96 blocks of at most 256 keys, 64 a warp) is
// bound by the latency of its four load rounds and the launches. Flat
// tokens at gemma3's T 264 (a 256-token chunk) do ~8 GFLOP over 34 MB:
// bound by float32 operations; the tiles cut K/V reads 16-fold against a
// block per token, and the register tiles feed the FMA units from shared
// memory.
//
// D up to 128 that is a multiple of 4, with 16-byte-aligned operands,
// runs on float4 (W = 4, one vector a lane); any other D up to 256 runs on
// scalars (W = 1, up to 8 a lane). Both are template arguments, not
// run-time flags.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pa {

constexpr float NEG = -1e30f;
constexpr int NT = 128;     // threads a block: four warps
constexpr int KC = 16;      // keys of a staged chunk (tile unit)
constexpr int RMAX = 32;    // query rows of a tile: tokens x G
constexpr int GMAX = 8;     // query heads a kv-head (token unit registers)
constexpr int NSTAGE = 2;   // chunks in the cp.async ring
// blocks of a flat call that take single tokens, each every 16th token
constexpr int SINGLE_BLOCKS = 16;
constexpr int TAB_MAX = 256;  // cache blocks a split (split_layout: <= 256)
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* q;            // (T, Hq, D)
  const float* k_pool;       // (NB, BS, Hkv, D)
  const float* v_pool;
  const int32_t* tables;     // (rows, MB)
  const int32_t* slot_ids;   // (T,); null for decode (token b reads row b)
  const int32_t* ctx;        // (T,)
  float* out;                // (T, Hq, D)
  float* part_acc;           // (T, Hq, NS, D)
  float2* part_ml;           // (T, Hq, NS)
  int t, hq, hkv, d, bs, mb, window, split, ns, tq;
  float scale, softcap;
};

template <int W> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };
// vectors of a row a lane holds: D <= 128 on float4, D <= 256 on scalars
template <int W>
__host__ __device__ constexpr int vpl() {
  return W == 4 ? 1 : 8;
}

__device__ __forceinline__ float dot_acc(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float dot_acc(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
// y + a * x
__device__ __forceinline__ float4 axpy(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y),
                     fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}
__device__ __forceinline__ float axpy(float a, float x, float y) {
  return fmaf(a, x, y);
}
__device__ __forceinline__ float4 mul(float4 x, float a) {
  return make_float4(x.x * a, x.y * a, x.z * a, x.w * a);
}
__device__ __forceinline__ float mul(float x, float a) { return x * a; }
__device__ __forceinline__ float4 vdiv(float4 x, float a) {
  return make_float4(x.x / a, x.y / a, x.z / a, x.w / a);
}
__device__ __forceinline__ float vdiv(float x, float a) { return x / a; }
__device__ __forceinline__ float4 shfl_add(float4 x, int o) {
  x.x += __shfl_xor_sync(FULL, x.x, o);
  x.y += __shfl_xor_sync(FULL, x.y, o);
  x.z += __shfl_xor_sync(FULL, x.z, o);
  x.w += __shfl_xor_sync(FULL, x.w, o);
  return x;
}
__device__ __forceinline__ float shfl_add(float x, int o) {
  return x + __shfl_xor_sync(FULL, x, o);
}
template <class T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <class T> __device__ __forceinline__ T ldg(const float* p);
// K/V are read once a unit: cached in L2 only
template <> __device__ __forceinline__ float4 ldg<float4>(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
template <> __device__ __forceinline__ float ldg<float>(const float* p) {
  return __ldcg(p);
}

// cp.async of one vector, zero-filled (nothing read) when !ok
__device__ __forceinline__ void cp_vec(float4* dst, const float* src,
                                       bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_vec(float* dst, const float* src,
                                       bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch (see csrc/lowrank_core.cuh): wait until the
// previous kernel in the stream has completed and its writes are visible;
// let the next kernel be scheduled.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__host__ __device__ __forceinline__ int pow2_at_least(int n, int cap) {
  int p = 1;
  while (p < n && p < cap) p <<= 1;
  return p;
}

// float offset of key position pos of split s, kv-head h; tab: the split's
// table entries (load_split_table)
__device__ __forceinline__ size_t key_row(const int* tab, int pos, int s,
                                          const Params& p, int h) {
  const int j = pos / p.bs;
  return (((size_t)tab[j - s * (p.split / p.bs)] * p.bs + (pos - j * p.bs)) *
              p.hkv + h) * p.d;
}

// the table entries of split s (a whole number of blocks) into shared
// memory; the caller synchronises before reading them
__device__ __forceinline__ void load_split_table(const Params& p,
                                                 const int32_t* table, int s,
                                                 int* tab) {
  const int nb = p.split / p.bs, j0 = s * nb;
  for (int i = threadIdx.x; i < nb && j0 + i < p.mb; i += NT)
    tab[i] = table[j0 + i];
}

// the keys [lo, hi) of token tok
__device__ __forceinline__ void row_range(const Params& p, int tok, int& lo,
                                          int& hi) {
  const int c = p.ctx[tok];
  lo = max(0, c - p.window);
  hi = min(c, p.mb * p.bs);
}

// ----------------------------------------------------------- token unit

__host__ __device__ __forceinline__ int token_smem_floats(int g, int d) {
  return 5 * g * d + 8 * g;
}

// One block: token tok's G query heads of kv-head h over split s. Warp w
// takes key batches w, w + 4, ... with its own running (m, l, acc); the
// four states are combined in warp order and written as the split's
// partial. smem: token_smem_floats(G, D).
template <int W>
__device__ void token_unit(const Params& p, int tok, const int32_t* table,
                           int h, int s, float* smem, int* tab) {
  using T = typename Vec<W>::T;
  // key loads a lane keeps in flight per operand
  constexpr int NB = W == 4 ? 8 : 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = p.hq / p.hkv;
  const int nv = p.d / W;
  const int lpk = pow2_at_least(nv, 32);   // lanes a key
  const int kpw = 32 / lpk;                // keys side by side in a warp
  const int kl = lane / lpk, e = lane - kl * lpk;
  int lo, hi;
  row_range(p, tok, lo, hi);
  const int k0 = max(lo, s * p.split), k1 = min(hi, (s + 1) * p.split);
  if (k0 >= k1) return;   // uniform over the block

  float2* cml = reinterpret_cast<float2*>(smem);   // (4, G) warp (m, l)
  float* qs = smem + 8 * g;                  // (G, D) pre-scaled q
  float* cw = qs + g * p.d;                  // (4, G, D) warp accumulators
  const float* qsrc = p.q + ((size_t)tok * p.hq + h * g) * p.d;
  for (int i = tid; i < g * p.d; i += NT) qs[i] = qsrc[i] * p.scale;
  load_split_table(p, table, s, tab);
  __syncthreads();
  const T* qv = reinterpret_cast<const T*>(qs);

  float m_run[GMAX], l_run[GMAX];
  T acc[GMAX][vpl<W>()];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    m_run[gi] = NEG;
    l_run[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < vpl<W>(); ++j) acc[gi][j] = zero<T>();
  }

  for (int kb = k0 + warp * NB * kpw; kb < k1; kb += 4 * NB * kpw) {
    size_t base[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int pos = kb + i * kpw + kl;
      base[i] = pos < k1 ? key_row(tab, pos, s, p, h) : (size_t)0;
    }
    T kr[NB][vpl<W>()], vr[NB][vpl<W>()];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const bool ok = kb + i * kpw + kl < k1;
#pragma unroll
      for (int j = 0; j < vpl<W>(); ++j) {
        const int v = e + j * lpk;
        if (ok && v < nv) {
          kr[i][j] = ldg<T>(p.k_pool + base[i] + v * W);
          vr[i][j] = ldg<T>(p.v_pool + base[i] + v * W);
        } else {
          kr[i][j] = zero<T>();
          vr[i][j] = zero<T>();
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      if (gi >= g) break;
      float sc[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        float dd = 0.f;
#pragma unroll
        for (int j = 0; j < vpl<W>(); ++j) {
          const int v = e + j * lpk;
          if (v < nv) dd = dot_acc(qv[gi * nv + v], kr[i][j], dd);
        }
        for (int o = lpk >> 1; o > 0; o >>= 1)
          dd += __shfl_xor_sync(FULL, dd, o);
        if (p.softcap > 0.f) dd = p.softcap * tanhf(dd / p.softcap);
        sc[i] = kb + i * kpw + kl < k1 ? dd : NEG;
      }
      float mb = sc[0];
#pragma unroll
      for (int i = 1; i < NB; ++i) mb = fmaxf(mb, sc[i]);
      for (int o = lpk; o < 32; o <<= 1)
        mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, o));
      const float m_new = fmaxf(m_run[gi], mb);
      const float alpha = expf(m_run[gi] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        sc[i] = expf(sc[i] - m_new);
        sum += sc[i];
      }
      for (int o = lpk; o < 32; o <<= 1)
        sum += __shfl_xor_sync(FULL, sum, o);
      l_run[gi] = fmaf(l_run[gi], alpha, sum);
      m_run[gi] = m_new;
#pragma unroll
      for (int j = 0; j < vpl<W>(); ++j) {
        T a = mul(acc[gi][j], alpha);
#pragma unroll
        for (int i = 0; i < NB; ++i) a = axpy(sc[i], vr[i][j], a);
        acc[gi][j] = a;
      }
    }
  }

  // each warp's state to shared memory (a warp without keys: m -1e30,
  // l 0, acc 0, which the combine weighs by 0)
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi >= g) break;
#pragma unroll
    for (int j = 0; j < vpl<W>(); ++j) {
      T a = acc[gi][j];
      for (int o = lpk; o < 32; o <<= 1) a = shfl_add(a, o);
      const int v = e + j * lpk;
      if (kl == 0 && v < nv)
        reinterpret_cast<T*>(cw + (warp * g + gi) * p.d)[v] = a;
    }
    if (lane == 0) cml[warp * g + gi] = make_float2(m_run[gi], l_run[gi]);
  }
  __syncthreads();
  for (int i = tid; i < g * nv; i += NT) {
    const int gi = i / nv, v = i - gi * nv;
    float m = NEG;
#pragma unroll
    for (int w = 0; w < 4; ++w) m = fmaxf(m, cml[w * g + gi].x);
    float l = 0.f;
    T o = zero<T>();
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 ml = cml[w * g + gi];
      const float c = expf(ml.x - m);
      l = fmaf(ml.y, c, l);
      o = axpy(c, reinterpret_cast<const T*>(cw + (w * g + gi) * p.d)[v], o);
    }
    const size_t idx = ((size_t)tok * p.hq + h * g + gi) * p.ns + s;
    reinterpret_cast<T*>(p.part_acc + idx * p.d)[v] = o;
    if (v == 0) p.part_ml[idx] = make_float2(m, l);
  }
  __syncthreads();   // the next token of the block reuses shared memory
}

// Whether flat token tok shares its slot with no neighbour of its tile
// window (the tile unit takes the others).
__device__ __forceinline__ bool single_token(const Params& p, int tok) {
  const int sl = p.slot_ids[tok];
  const bool first = tok % p.tq == 0 || p.slot_ids[tok - 1] != sl;
  const bool last = tok + 1 == p.t || (tok + 1) % p.tq == 0 ||
                    p.slot_ids[tok + 1] != sl;
  return first && last;
}

// ------------------------------------------------------------ tile unit

__host__ __device__ __forceinline__ int row_stride(int d, int w) {
  // 16-byte rows whose starts step 4 banks (d % 32 == 0) or fall on other
  // 16-byte bank groups; scalar rows one float apart
  return w == 4 ? d + 4 : d + 1;
}

// row strides of the tile's score partials and probabilities
constexpr int SS = KC + 1;
constexpr int PS = KC + 4;

__host__ __device__ __forceinline__ int tile_smem_floats(int d, int w) {
  const int dp = row_stride(d, w);
  return RMAX * dp + NSTAGE * 2 * KC * dp + 4 * RMAX * SS + RMAX * PS +
         3 * RMAX;
}

// The block: tokens t0 .. t0 + n - 1 (n >= 2) of one slot, kv-head h, split
// s. lo_t / hi_t: those tokens' key ranges.
template <int W>
__device__ void tile_unit(const Params& p, int t0, int n, const int* lo_t,
                          const int* hi_t, const int32_t* table, int h, int s,
                          float* smem, int* tab) {
  using T = typename Vec<W>::T;
  const int g = p.hq / p.hkv;
  const int R = n * g;
  const int nv = p.d / W;
  const int dp = row_stride(p.d, W);
  float* qs = smem;                          // (RMAX, dp) pre-scaled q
  float* ring = qs + RMAX * dp;              // NSTAGE x (K, V) x (KC, dp)
  float* ss = ring + NSTAGE * 2 * KC * dp;   // (4, RMAX, SS) score partials
  float* sp = ss + 4 * RMAX * SS;            // (RMAX, PS) probabilities
  float* m_s = sp + RMAX * PS;
  float* l_s = m_s + RMAX;
  float* a_s = l_s + RMAX;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int lo = 1 << 30, hi = 0;
  for (int i = 0; i < n; ++i) {
    lo = min(lo, lo_t[i]);
    hi = max(hi, hi_t[i]);
  }
  const int k0 = max(lo, s * p.split), k1 = min(hi, (s + 1) * p.split);
  if (k0 >= k1) return;   // uniform over the block

  for (int i = tid; i < R * p.d; i += NT) {
    const int r = i / p.d, di = i - r * p.d;
    qs[r * dp + di] =
        p.q[((size_t)(t0 + r / g) * p.hq + h * g + r % g) * p.d + di] *
        p.scale;
  }
  for (int r = tid; r < R; r += NT) {
    m_s[r] = NEG;
    l_s[r] = 0.f;
  }
  load_split_table(p, table, s, tab);
  __syncthreads();

  // chunks of KC keys aligned to absolute multiples of KC
  const int c0 = k0 / KC * KC;
  const int nch = (k1 - c0 + KC - 1) / KC;
  auto fetch = [&](int c) {
    if (c < nch) {
      float* ks = ring + (c % NSTAGE) * 2 * KC * dp;
      for (int kr = warp; kr < KC; kr += NT / 32) {
        const int pos = c0 + c * KC + kr;
        const bool ok = pos >= k0 && pos < k1;
        const size_t off = ok ? key_row(tab, pos, s, p, h) : (size_t)0;
        for (int v = lane; v < nv; v += 32) {
          cp_vec(reinterpret_cast<T*>(ks + kr * dp) + v,
                 p.k_pool + off + v * W, ok);
          cp_vec(reinterpret_cast<T*>(ks + (KC + kr) * dp) + v,
                 p.v_pool + off + v * W, ok);
        }
      }
    }
    cp_commit();
  };

  // P V layout: LPR lanes a row, RPW rows a warp step, rows
  // warp * RPW + lane / LPR + 4 * RPW * i
  const int lpr = pow2_at_least(nv, 32);
  const int rpw = 32 / lpr;
  const int e = lane % lpr;
  const int rbase = warp * rpw + lane / lpr;
  T acc[8][vpl<W>()];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < vpl<W>(); ++j) acc[i][j] = zero<T>();

#pragma unroll
  for (int c = 0; c < NSTAGE - 1; ++c) fetch(c);
  for (int c = 0; c < nch; ++c) {
    cp_wait<NSTAGE - 2>();
    __syncthreads();   // chunk c landed; every thread is past chunk c - 1
    fetch(c + NSTAGE - 1);
    const float* ks = ring + (c % NSTAGE) * 2 * KC * dp;
    const float* vs = ks + KC * dp;
    const int cpos = c0 + c * KC;

    // S = Q K^T: warp w sums its quarter of D (vectors [v0, v1)) for all
    // 32 x 16 scores, each lane rows rg + 8i x keys kg + 4j
    {
      const int rg = lane >> 2, kg = lane & 3;
      const int nvw = (nv + 3) / 4;
      const int v0 = warp * nvw, v1 = min(nv, v0 + nvw);
      float acc_s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_s[i][j] = 0.f;
      for (int v = v0; v < v1; ++v) {
        T qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = reinterpret_cast<const T*>(qs + (rg + 8 * i) * dp)[v];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = reinterpret_cast<const T*>(ks + (kg + 4 * j) * dp)[v];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc_s[i][j] = dot_acc(qv[i], kv[j], acc_s[i][j]);
      }
      float* sw = ss + warp * RMAX * SS;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sw[(rg + 8 * i) * SS + kg + 4 * j] = acc_s[i][j];
    }
    __syncthreads();

    // the four quarters summed in order, softcap, mask; online softmax: a
    // half-warp a row, a lane a key
    {
      const int hw = tid >> 4, k = tid & 15;
      const int pos = cpos + k;
#pragma unroll
      for (int i = 0; i < RMAX / 8; ++i) {
        const int r = hw + 8 * i;
        const bool ok = r < R;
        float sv = NEG;
        if (ok) {
          float x = ss[r * SS + k];
#pragma unroll
          for (int w = 1; w < 4; ++w) x += ss[(w * RMAX + r) * SS + k];
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
          const int ti = r / g;
          if (pos >= max(k0, lo_t[ti]) && pos < min(k1, hi_t[ti])) sv = x;
        }
        const float m_old = ok ? m_s[r] : NEG;
        float mc = sv;
        for (int o = 8; o > 0; o >>= 1)
          mc = fmaxf(mc, __shfl_xor_sync(FULL, mc, o));
        const float m_new = fmaxf(m_old, mc);
        const float pr = expf(sv - m_new);
        float sum = pr;
        for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
        __syncwarp();   // every lane has read m_s[r] before lane 0 writes it
        if (ok) {
          sp[r * PS + k] = pr;
          if (k == 0) {
            const float alpha = expf(m_old - m_new);
            a_s[r] = alpha;
            l_s[r] = fmaf(l_s[r], alpha, sum);
            m_s[r] = m_new;
          }
        }
      }
    }
    __syncthreads();

    // O = O * alpha + P V, keys in order; each V vector read once a lane
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rbase + 4 * rpw * i;
      if (r < R) {
        const float alpha = a_s[r];
#pragma unroll
        for (int j = 0; j < vpl<W>(); ++j) acc[i][j] = mul(acc[i][j], alpha);
      }
    }
#pragma unroll
    for (int k4 = 0; k4 < KC; k4 += 4) {
      float4 pk[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = rbase + 4 * rpw * i;
        pk[i] = r < R ? *reinterpret_cast<const float4*>(sp + r * PS + k4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        T vv[vpl<W>()];
#pragma unroll
        for (int j = 0; j < vpl<W>(); ++j) {
          const int v = e + j * lpr;
          vv[j] = v < nv ? reinterpret_cast<const T*>(vs + (k4 + kk) * dp)[v]
                         : zero<T>();
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float pv = kk == 0   ? pk[i].x
                           : kk == 1 ? pk[i].y
                           : kk == 2 ? pk[i].z
                                     : pk[i].w;
#pragma unroll
          for (int j = 0; j < vpl<W>(); ++j)
            acc[i][j] = axpy(pv, vv[j], acc[i][j]);
        }
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rbase + 4 * rpw * i;
    if (r < R) {
      const size_t idx =
          ((size_t)(t0 + r / g) * p.hq + h * g + r % g) * p.ns + s;
#pragma unroll
      for (int j = 0; j < vpl<W>(); ++j) {
        const int v = e + j * lpr;
        if (v < nv)
          *reinterpret_cast<T*>(p.part_acc + idx * p.d + v * W) = acc[i][j];
      }
    }
  }
  for (int r = tid; r < R; r += NT) {
    const size_t idx =
        ((size_t)(t0 + r / g) * p.hq + h * g + r % g) * p.ns + s;
    p.part_ml[idx] = make_float2(m_s[r], l_s[r]);
  }
  __syncthreads();   // the next tile of the block reuses shared memory
}

// blocks in x that take single flat tokens: block x takes tokens x, x + X,
// x + 2X, ... (at most NT of them)
__host__ __device__ __forceinline__ int single_blocks(int t) {
  const int x = t < SINGLE_BLOCKS ? t : SINGLE_BLOCKS;
  const int need = (t + NT - 1) / NT;
  return x > need ? x : need;
}

// The first launch of a call. DECODE: grid (B, Hkv, NS), block b takes slot
// b over table row b. Flat tokens: grid (X + ceil(T / TQ), Hkv, NS); block
// x < X takes the single tokens among x, x + X, ... over row slot_ids[t],
// block X + w the runs of two or more same-slot tokens in tile window
// [w * TQ, (w + 1) * TQ).
template <int W, bool DECODE>
__global__ void __launch_bounds__(NT) attend_kernel(Params p) {
  extern __shared__ float4 smem4[];
  __shared__ int tab[TAB_MAX], flag[NT], sid_t[RMAX], lo_t[RMAX],
      hi_t[RMAX];
  float* smem = reinterpret_cast<float*>(smem4);
  griddep_wait();
  griddep_launch();
  const int h = blockIdx.y, s = blockIdx.z;
  if (DECODE) {
    token_unit<W>(p, blockIdx.x, p.tables + (size_t)blockIdx.x * p.mb,
                       h, s, smem, tab);
    return;
  }
  const int nx = single_blocks(p.t);
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < nx) {
    const int x = blockIdx.x;
    const int n = (p.t - x + nx - 1) / nx;
    if (tid < n) flag[tid] = single_token(p, x + tid * nx);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (!flag[j]) continue;
      const int tok = x + j * nx;
      token_unit<W>(p, tok, p.tables + (size_t)p.slot_ids[tok] * p.mb,
                         h, s, smem, tab);
    }
    return;
  }
  const int w0 = (blockIdx.x - nx) * p.tq;
  const int nw = min(p.tq, p.t - w0);
  if (tid < nw) {
    sid_t[tid] = p.slot_ids[w0 + tid];
    row_range(p, w0 + tid, lo_t[tid], hi_t[tid]);
  }
  __syncthreads();
  for (int i = 0; i < nw;) {
    int j = i + 1;
    while (j < nw && sid_t[j] == sid_t[i]) ++j;
    if (j - i >= 2)
      tile_unit<W>(p, w0 + i, j - i, lo_t + i, hi_t + i,
                        p.tables + (size_t)sid_t[i] * p.mb, h, s, smem, tab);
    i = j;
  }
}

// ---------------------------------------------------------------- merge

// A warp a (token, query head): the partials of the splits that meet its
// keys, combined in ascending split order.
template <int W>
__global__ void __launch_bounds__(NT) merge_kernel(Params p) {
  using T = typename Vec<W>::T;
  griddep_wait();
  griddep_launch();
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= p.t * p.hq) return;
  const int lane = threadIdx.x & 31;
  const int nv = p.d / W;
  T* out = reinterpret_cast<T*>(p.out + (size_t)row * p.d);
  int lo, hi;
  row_range(p, row / p.hq, lo, hi);
  if (lo >= hi) {   // no visible key (ctx < 1): callers never pass one
    for (int v = lane; v < nv; v += 32) out[v] = zero<T>();
    return;
  }
  const int s0 = lo / p.split, s1 = (hi - 1) / p.split;
  const float2* ml = p.part_ml + (size_t)row * p.ns;
  float m = NEG;
  for (int s = s0; s <= s1; ++s) m = fmaxf(m, ml[s].x);
  float l = 0.f;
  for (int s = s0; s <= s1; ++s) l = fmaf(ml[s].y, expf(ml[s].x - m), l);
  const float* acc = p.part_acc + (size_t)row * p.ns * p.d;
  for (int v = lane; v < nv; v += 32) {
    T o = zero<T>();
    for (int s = s0; s <= s1; ++s)
      o = axpy(expf(ml[s].x - m),
               reinterpret_cast<const T*>(acc + (size_t)s * p.d)[v], o);
    out[v] = vdiv(o, l);
  }
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

template <int W>
static int run(const Params& p, bool decode, cudaStream_t stream) {
  const int tok = token_smem_floats(p.hq / p.hkv, p.d);
  const int tile = tile_smem_floats(p.d, W);
  int e = decode
              ? launch(attend_kernel<W, true>, dim3(p.t, p.hkv, p.ns),
                       tok * (int)sizeof(float), stream, p)
              : launch(attend_kernel<W, false>,
                       dim3(single_blocks(p.t) + (p.t + p.tq - 1) / p.tq,
                            p.hkv, p.ns),
                       (tok > tile ? tok : tile) * (int)sizeof(float), stream,
                       p);
  if (e) return e;
  return launch(merge_kernel<W>, dim3((p.t * p.hq + 3) / 4), 0, stream, p);
}

static int dispatch(const Params& p, bool decode, cudaStream_t stream) {
  const int g = p.hkv > 0 ? p.hq / p.hkv : 0;
  if (p.t < 1 || g < 1 || g > GMAX || p.hq % p.hkv || p.d < 1 ||
      p.d > 256 || p.split < 1 || p.ns < 1 || p.split % p.bs ||
      p.split / p.bs > TAB_MAX ||
      (long long)p.ns * p.split < (long long)p.mb * p.bs ||
      (!decode && (p.tq < 1 || p.tq * g > RMAX)))
    return (int)cudaErrorInvalidValue;
  const uintptr_t bits = (uintptr_t)p.q | (uintptr_t)p.k_pool |
                         (uintptr_t)p.v_pool | (uintptr_t)p.out |
                         (uintptr_t)p.part_acc;
  if (p.d % 4 == 0 && p.d <= 128 && bits % 16 == 0)
    return run<4>(p, decode, stream);
  return run<1>(p, decode, stream);
}

}  // namespace pa

extern "C" int paged_attention_f32(
    const float* q, const float* k_pool, const float* v_pool,
    const int32_t* block_tables, const int32_t* context_lens, float* out,
    float* part_acc, float* part_ml, int b, int hq, int hkv, int d, int bs,
    int mb, int split, int ns, float scale, float softcap, int window,
    void* stream) {
  pa::Params p = {q, k_pool, v_pool, block_tables, nullptr, context_lens,
                  out, part_acc, reinterpret_cast<float2*>(part_ml),
                  b, hq, hkv, d, bs, mb, window, split, ns, 1, scale,
                  softcap};
  return pa::dispatch(p, true, (cudaStream_t)stream);
}

extern "C" int paged_prefill_attention_f32(
    const float* q, const float* k_pool, const float* v_pool,
    const int32_t* block_tables, const int32_t* slot_ids,
    const int32_t* context_lens, float* out, float* part_acc, float* part_ml,
    int t, int hq, int hkv, int d, int bs, int mb, int split, int ns, int tq,
    float scale, float softcap, int window, void* stream) {
  pa::Params p = {q, k_pool, v_pool, block_tables, slot_ids, context_lens,
                  out, part_acc, reinterpret_cast<float2*>(part_ml),
                  t, hq, hkv, d, bs, mb, window, split, ns, tq, scale,
                  softcap};
  return pa::dispatch(p, false, (cudaStream_t)stream);
}
