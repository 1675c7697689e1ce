// Mamba2 SSD scan (the selective state-space recurrence of a mamba2 block),
// float32, from a zero state:
//
//   S[n,p] <- S[n,p] exp(dt_t a_h) + b_t[n] (x_t[p] dt_t)
//   y_t[p]  = sum_n c_t[n] S[n,p]
//
// Replaces the Pallas kernel `ssd` of the JAX package
// (src/repro/kernels/mamba2_ssd.py, `ssd` and its `_kernel`), and computes
// it as that kernel does: chunks of Q steps, each done as matrix products
// through the (Q, Q) matrix of pairwise decays L[i,j] = exp(cum_i - cum_j)
// (i >= j; cum the inclusive sum of dt a over the chunk), with the (N, P)
// state carried from chunk to chunk. Per head h and chunk:
//
//   Y      = (G o L) (X dt) + diag(exp(cum)) (C S),   G = C B^T
//   S_next = exp(cum_Q) S + (B o to_end)^T (X dt),    to_end_j = L[Q-1, j]
//
// B and C stay grouped (B, S, G, N); the skip term d * x stays with the
// caller, as in the reference.
//
// Bound on the card: bytes. x and y (2 B S H P floats) dominate the bytes:
// with dt, a and one read of b and c, 59.7 MB at zamba2's training shape
// (B 8, S 128, H 112, G 1, P = N = 64), 0.0178 ms at 3.35 TB/s. The
// chunked products at Q = 128 and S = 128 are G (once per batch and group)
// and (G o L)(X dt) per head, the triangles only: 0.96 GFLOP, 2.9 GFLOP of
// TF32 products in 3xTF32, 0.0058 ms at 495 TFLOP/s.
//
// What held the first design back (PR 13's kernel: one block of 64 threads
// a (batch, head), a thread a state column of 64 registers, the sequential
// form): every step took 32 broadcast LDS.128 of b and c for about 192
// floating-point operations, so the shared-memory load pipe bound it, as it
// bound the first wkv6; each round of 32 steps was staged by scalar loads
// between two barriers, with nothing overlapped; and b and c were read
// again by each of the H / G heads of a group (58.7 MB of L2 reads beside
// 29 MB of x). 0.1225 ms, 3.5x its float32-operations bound.
//
// Design. The decay is one scalar a head and a step, so L lies in (0, 1]
// where i >= j and the chunked form is well conditioned (unlike wkv6's
// per-channel decays, csrc/wkv6.cu). Two launches:
//   1. scores_kernel: G = C B^T, lower triangle, once per (batch, group,
//      chunk) into a scratch that every head of the group reads: 72 tiles
//      of 16 x 8 (row tile r, step block kk <= 2r + 1), each lane's four
//      values of a tile as one float4 laid out as an A fragment of the
//      second product (see "K order" below). A block of 8 warps per
//      (unit, pair of row tiles 7 - r and r), so the blocks carry equal
//      work, each warp two or three tiles side by side.
//   2. ssd_kernel, a programmatic dependent launch: a block (one warpgroup)
//      takes HB = 2 heads of one group of one batch and walks its (chunk,
//      head) pairs in order. A pair's x and dt land by cp.async in a raw
//      slot; the block forms x dt split into big and small copies in
//      K-major core matrices (warps 1-3) while warp 0 sums cum; then the
//      next pair's x and dt load into the freed slot while this pair's
//      products run. It waits for launch 1 (griddepcontrol.wait) only
//      before it first reads the scores, so its first load and split run
//      beside launch 1. Y = (G o L)(X dt) runs on wgmma m64n64k8 (TF32, A
//      from registers, B the split x): warp w owns rows of tiles 7 - w and
//      w, so the high m64 tile (tiles 7..4) runs step blocks 0..15 and the
//      low one (tiles 0..3) 0..7: 24 blocks of 64 rows where the triangle
//      needs the work of 18, the others' rows zero. Each A fragment is G
//      (a float4 from the scratch, loaded three blocks ahead) times
//      2^(cum_i - cum_j), formed only where i >= j (on
//      the diagonal the exponent is -inf elsewhere, so no exponent above it
//      is ever taken); the next block's fragments are formed while the
//      tensor cores run this block's. With more than one chunk, C S (the
//      state in shared memory, N x P per head) opens the accumulators, in
//      mma.sync, scaled by 2^cum_i row by row, and after the chunk warp w
//      updates state rows 16w..16w+15 from the split x, b read from global
//      memory; those paths run only past S = 128 and are not tuned.
// Arithmetic. Every product is 3xTF32 on the tensor cores (big*small +
// small*big + big*big, as csrc/lowrank_core.cuh): plain TF32 misses
// TOL_RECUR_SEQ (2e-5 of the output's max) by some 30x
// (tests/test_torch_ssd_chunks.py). The split cuts the mantissa instead of
// rounding it (big = the 13 low bits cleared, small = v - big, whose low
// bits the tensor cores ignore): two instructions where cvt.rna takes four
// twice, and still within TOL_RECUR_SEQ on the CPU emulation. The
// reductions are short (K = 64 or 128), so the tensor cores' adds, which
// round toward zero, cost little. cum is summed in double by a warp scan,
// in log2 units, and kept as a float pair (hi, lo): an exponent is (hi_i -
// hi_j) + (lo_i - lo_j), exact to a float's rounding of itself (hi_i -
// hi_j is exact where the two are close, by Sterbenz), where one float
// cumsum loses |cum| x 6e-8 (cum reaches -400 at dt 4). The exponentials
// are ex2.approx.
// K order. The accumulator of an m16n8 tile holds columns 2t and 2t + 1
// of rows g and g + 8 in lane (g, t); read as an A fragment with the
// reduction's slots t and t + 4 taken as steps 2t and 2t + 1, it needs no
// shuffle, and the split x places its steps in the same order.
// Masking. A ragged last chunk is zero-filled by the copies (src-size 0):
// masked steps have dt = 0, x = 0 and b = c = 0, so they decay nothing and
// add nothing; nothing is read or written past S.
// Deterministic: no atomics, every sum in a fixed order; grid, scratch and
// shared memory follow from the shapes alone; no host synchronisation.
// Occupancy: 101 KB of shared memory (137 KB past one chunk, with the two
// states): two blocks an SM (one past one chunk); at zamba2's shape 448
// blocks for 264 slots.
// Measured (chip_smoke.py, tools/ssd_phases.py; PERF.md, PR 18): about
// 0.056 ms at zamba2's shape, 3.2x the bytes bound. What holds it: per
// pair the products take some 6-7 us of a block's 10, two blocks an SM,
// and within them the loads of the scores from L2, the decays and the
// wgmmas follow one another more than they overlap; the first pair of a
// block waits for its x and for launch 1, and the two rounds of blocks
// (448 for 264 slots) each pay that start. Designs tried that ran no
// faster: the products on mma.sync (B fragments split in registers, G
// staged in shared memory); cvt.rna splits and exp of natural-log cum; the
// three wgmmas of a block in another order, the block loop unrolled, the
// scores three or four blocks ahead, the off-diagonal decays factored as
// 2^(c_i - c_i0) 2^(c_i0 - c_j); four heads a block; persistent blocks
// (two an SM) walking every head with x loaded by bulk copies on an
// mbarrier; y staged in shared memory and stored by bulk copies. Launch 1
// on 256 threads a block rather than 128, and the wait for it moved after
// the first pair's split, took it from about 0.060 ms.
#include "lowrank_core.cuh"

// -DSSD_PROFILE=1 (tools/ssd_phases.py): thread 0 of each block stamps the
// global timer (ns) at its phases into ssd_stamps, read by ssd_stamps_read:
// scan block k at [16 k + slot] (slot 0 start; for pairs q < 3 at 2 + 4 q:
// x landed, split and cum done, products done, y stored; 1 the first
// griddepcontrol.wait done, between pair 0's split and its products; 14
// end), scores block k at [STAMP_SCORES + 4 k + slot]
// (0 start, 1 b and c landed, 2 end). Blocks past the array are not
// stamped.
#ifndef SSD_PROFILE
#define SSD_PROFILE 0
#endif
#if SSD_PROFILE
constexpr int STAMP_SCAN_BLOCKS = 2048, STAMP_SCORES = 16 * STAMP_SCAN_BLOCKS;
__device__ unsigned long long ssd_stamps[STAMP_SCORES + 4 * 1024];
#define STAMP(slot)                                                   \
  if (threadIdx.x == 0 && blockIdx.x < STAMP_SCAN_BLOCKS) {           \
    unsigned long long t;                                             \
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));              \
    ssd_stamps[blockIdx.x * 16 + (slot)] = t;                         \
  }
#define STAMP_S(slot)                                                 \
  if (threadIdx.x == 0 && blockIdx.x < 1024) {                        \
    unsigned long long t;                                             \
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));              \
    ssd_stamps[STAMP_SCORES + blockIdx.x * 4 + (slot)] = t;           \
  }
extern "C" int ssd_stamps_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, ssd_stamps, sizeof(ssd_stamps));
}
#else
#define STAMP(slot)
#define STAMP_S(slot)
#endif

namespace {
using lrc::commit;
using lrc::cp16;
using lrc::cp4;
using lrc::fence_async_shared;
using lrc::fence_regs;
using lrc::griddep_launch;
using lrc::griddep_wait;
using lrc::smem_desc;
using lrc::wait_groups;
using lrc::wgmma_commit;
using lrc::wgmma_fence;
using lrc::wgmma_n64;
using lrc::wgmma_wait0;

constexpr int Q = 128;              // steps a chunk
constexpr int P = 64;               // head size
constexpr int NS = 64;              // state size
constexpr int RT = Q / 16;          // row tiles of a chunk
constexpr int TILES = RT * (RT + 1);  // (row tile, step block) of the triangle
constexpr int NT = 128;             // threads a block of ssd_kernel
constexpr int NTS = 256;            // of scores_kernel
constexpr int HB = 2;               // heads a block of ssd_kernel
constexpr int XS = P + 4;           // row stride of x, b and c in shared memory
constexpr int SS = P + 8;           // row stride of the state
constexpr int LBO = P / 8 * 128;    // bytes between core matrices along K
constexpr int SBO = 128;            // along N
constexpr unsigned FULL = 0xffffffffu;
constexpr double LOG2E = 1.4426950408889634;

// shared memory of ssd_kernel, in floats
constexpr int RAW_OFF = 0;                    // x as it lies, Q x XS
constexpr int BIG_OFF = RAW_OFF + Q * XS;     // x split, K-major core matrices
constexpr int SMALL_OFF = BIG_OFF + Q * P;
constexpr int DT_OFF = SMALL_OFF + Q * P;     // two slots of Q
constexpr int CUM_OFF = DT_OFF + 2 * Q;       // (hi, lo) of each step
constexpr int W_OFF = CUM_OFF + 2 * Q;        // to_end_j
constexpr int E_OFF = W_OFF + Q;              // 2^cum_Q
constexpr int ST_OFF = E_OFF + 4;             // HB states of NS x SS
constexpr int BASE_FLOATS = ST_OFF;
constexpr int STATE_FLOATS = NS * SS;
static_assert(NT == Q, "a thread stages one step's dt");
static_assert(BIG_OFF % 4 == 0 && ST_OFF % 4 == 0, "16-byte alignment");

// a lane's float4 of tile (r, kk) in the scores scratch
__device__ __forceinline__ int tile_index(int r, int kk) {
  return r * (r + 1) + kk;
}

// The float offset in a split tile of x at step j (of the chunk) and
// column p: K-major core matrices of 8 columns x 4 steps (128 bytes), the
// steps of a block of 8 in K order (j = 2t at slot t, j = 2t + 1 at slot
// t + 4).
__device__ __forceinline__ int split_at(int j, int p) {
  const int slot = ((j & 7) >> 1) + 4 * (j & 1);
  const int k4 = 2 * (j >> 3) + (slot >> 2);
  return ((k4 * (P / 8) + (p >> 3)) * 8 + (p & 7)) * 4 + (slot & 3);
}

// Copy `rows` rows of 64 floats, row r from src + (t0 + r) * step, into dst
// (row stride ds), by the block's NTH threads; rows at t0 + r >= s_len read
// as zero. vec: 16-byte copies (src and step 16-byte aligned), else 4-byte
// copies.
template <int NTH>
__device__ __forceinline__ void stage_rows(float* dst, int ds,
                                           const float* src, size_t step,
                                           int t0, int rows, int s_len,
                                           bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * 16; e += NTH) {
      const int r = e >> 4, col = (e & 15) * 4;
      const bool ok = t0 + r < s_len;
      cp16(dst + r * ds + col, ok ? src + (size_t)(t0 + r) * step + col : src,
           ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * 64; e += NTH) {
      const int r = e >> 6, col = e & 63;
      const bool ok = t0 + r < s_len;
      cp4(dst + r * ds + col, ok ? src + (size_t)(t0 + r) * step + col : src,
          ok ? 4 : 0);
    }
  }
}

// The 3xTF32 split with the mantissa cut rather than rounded: big keeps
// the 10 high mantissa bits, small = v - big (exact) goes to the tensor
// cores as it is, which read the 10 high bits of its mantissa too. Two
// instructions where cvt.rna takes four and is needed twice; the error
// stays within 2^-20 of each product (emulated in
// tests/test_torch_ssd_chunks.py).
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

__device__ __forceinline__ void split4(const float (&v)[4],
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) split(v[q], big[q], small[q]);
}

// 2^v, flushing results below float's normal range to zero; 2^-inf = 0
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// d = A B + d for one m16n8k8 tile, d as four floats
__device__ __forceinline__ void mma_r(float& d0, float& d1, float& d2,
                                      float& d3, const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B over one k8 step in 3xTF32 (big*small, small*big, big*big)
// for NTL n8 tiles; tile nt at d[4 nt .. 4 nt + 3]
template <int NTL>
__device__ __forceinline__ void mma3(float (&d)[4 * NTL],
                                     const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[NTL][2],
                                     const uint32_t (&bs)[NTL][2]) {
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) {
    float &d0 = d[4 * nt], &d1 = d[4 * nt + 1], &d2 = d[4 * nt + 2],
          &d3 = d[4 * nt + 3];
    mma_r(d0, d1, d2, d3, ab, bs[nt][0], bs[nt][1]);
    mma_r(d0, d1, d2, d3, as, bb[nt][0], bb[nt][1]);
    mma_r(d0, d1, d2, d3, ab, bb[nt][0], bb[nt][1]);
  }
}

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// ------------------------------------------------------------ launch 1

// G = C B^T of one (batch, group, chunk) unit, the row tiles 7 - pr and pr.
__global__ void __launch_bounds__(NTS)
scores_kernel(const float* __restrict__ b, const float* __restrict__ c,
              float* __restrict__ gsc, int s_len, int g_num, int nc,
              int vec) {
  extern __shared__ __align__(128) float sm[];
  float* cs = sm;                 // 32 rows: tile rhi, then tile rlo
  float* bs = sm + 32 * XS;       // rows 0 .. 16 (rhi + 1) - 1
  STAMP_S(0);
  griddep_launch();
  const int pr = blockIdx.x & 3, u = blockIdx.x >> 2;
  const int ch = u % nc, bg = u / nc;
  const int gi = bg % g_num, bi = bg / g_num;
  const int rhi = RT - 1 - pr, rlo = pr;
  const int s0 = ch * Q;
  const size_t step = (size_t)g_num * NS;
  const size_t off = ((size_t)bi * s_len * g_num + gi) * NS;
  stage_rows<NTS>(cs, XS, c + off, step, s0 + 16 * rhi, 16, s_len, vec);
  stage_rows<NTS>(cs + 16 * XS, XS, c + off, step, s0 + 16 * rlo, 16, s_len,
                  vec);
  stage_rows<NTS>(bs, XS, b + off, step, s0, 16 * (rhi + 1), s_len, vec);
  commit();
  wait_groups<0>();
  __syncthreads();
  STAMP_S(1);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  // warp w: tiles w, w + 8, w + 16 of the pair's 18 (row tile rhi's step
  // blocks 0 .. 2 rhi + 1, then rlo's), their sums side by side
  constexpr int WS = NTS / 32;
  constexpr int MT = (2 * (RT + 1) + WS - 1) / WS;   // most tiles a warp
  const int nhi = 2 * (rhi + 1), ntl = nhi + 2 * (rlo + 1);
  float d[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[m][e] = 0.f;
#pragma unroll
  for (int k = 0; k < NS; k += 8) {
    uint32_t ahb[4], ahs[4], alb[4], als[4];
    const float* ah = cs + g8 * XS + k + t4;
    const float* al = ah + 16 * XS;
    split4({ah[0], ah[8 * XS], ah[4], ah[8 * XS + 4]}, ahb, ahs);
    split4({al[0], al[8 * XS], al[4], al[8 * XS + 4]}, alb, als);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int q = warp + WS * m;
      if (q < ntl) {
        const bool hi = q < nhi;
        const int kk = hi ? q : q - nhi;
        const float* br = bs + (8 * kk + g8) * XS + k + t4;
        uint32_t bb[1][2], bsm[1][2];
        split(br[0], bb[0][0], bsm[0][0]);
        split(br[4], bb[0][1], bsm[0][1]);
        mma3<1>(d[m], hi ? ahb : alb, hi ? ahs : als, bb, bsm);
      }
    }
  }
  // accumulator (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) -> the A
  // fragment in K order: (g, 2t), (g+8, 2t), (g, 2t+1), (g+8, 2t+1)
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int q = warp + WS * m;
    if (q < ntl) {
      const bool hi = q < nhi;
      const int r = hi ? rhi : rlo, kk = hi ? q : q - nhi;
      reinterpret_cast<float4*>(gsc)[((size_t)u * TILES + tile_index(r, kk)) *
                                         32 + lane] =
          make_float4(d[m][0], d[m][2], d[m][1], d[m][3]);
    }
  }
  STAMP_S(2);
}

// ------------------------------------------------------------ launch 2

// The A fragment of row tile r at step block kk: G o L, split; zero
// past the tile's last block (the rows of a warpgroup's m64 tile run the
// longest row tile's blocks).
__device__ __forceinline__ void a_frag(const float4& gv, int r, int kk,
                                       int g8, int t4, const float2 (&ci)[2],
                                       const float* cum, uint32_t (&ab)[4],
                                       uint32_t (&as)[4]) {
  float av[4] = {0.f, 0.f, 0.f, 0.f};
  if (kk <= 2 * r + 1) {
    const int j0 = 8 * kk + 2 * t4;
    const float4 cj = reinterpret_cast<const float4*>(cum)[j0 >> 1];
    // exponents of (g, j0), (g+8, j0), (g, j0+1), (g+8, j0+1)
    float ex[4] = {(ci[0].x - cj.x) + (ci[0].y - cj.y),
                   (ci[1].x - cj.x) + (ci[1].y - cj.y),
                   (ci[0].x - cj.z) + (ci[0].y - cj.w),
                   (ci[1].x - cj.z) + (ci[1].y - cj.w)};
    if (kk >= 2 * r) {             // the diagonal tile: i >= j only
      const int i = 16 * r + g8;
      const float ninf = __int_as_float(0xff800000);
      if (j0 > i) ex[0] = ninf;
      if (j0 > i + 8) ex[1] = ninf;
      if (j0 + 1 > i) ex[2] = ninf;
      if (j0 + 1 > i + 8) ex[3] = ninf;
    }
    av[0] = gv.x * ex2(ex[0]);
    av[1] = gv.y * ex2(ex[1]);
    av[2] = gv.z * ex2(ex[2]);
    av[3] = gv.w * ex2(ex[3]);
  }
  split4(av, ab, as);
}

// This lane's float4 of the scores tile (r, kk), loaded ahead of its use
__device__ __forceinline__ float4 g_load(const float4* gq, int r, int kk,
                                         int lane) {
  return kk <= 2 * r + 1 ? __ldg(gq + tile_index(r, kk) * 32 + lane)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
}

// d += A B for one step block kk of a warpgroup's m64 x n64 tile, B the
// split x: 3xTF32 as three wgmma m64n64k8.
__device__ __forceinline__ void wg_step(float (&d)[32], const uint32_t (&ab)[4],
                                        const uint32_t (&as)[4],
                                        const float* big, const float* small,
                                        int kk) {
  const uint64_t db = smem_desc(big + kk * 2 * LBO / 4, LBO, SBO);
  const uint64_t ds = smem_desc(small + kk * 2 * LBO / 4, LBO, SBO);
  wgmma_n64(d, ab, ds, 1);
  wgmma_n64(d, as, db, 1);
  wgmma_n64(d, ab, db, 1);
}

__global__ void __launch_bounds__(NT, 2)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ c, const float* __restrict__ gsc,
           float* __restrict__ y, int s_len, int h_num, int g_num, int nc,
           int vec) {
  extern __shared__ __align__(128) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int rep = h_num / g_num, npair = (rep + HB - 1) / HB;
  const int hp = blockIdx.x % npair, bg = blockIdx.x / npair;
  const int gi = bg % g_num, bi = bg / g_num;
  const int h0 = gi * rep + hp * HB, nh = min(HB, rep - hp * HB);
  const int nq = nc * nh;
  const size_t xstep = (size_t)h_num * P;    // floats between steps of x, y
  const size_t bstep = (size_t)g_num * NS;   // of b, c
  const float* bg_b = b + ((size_t)bi * s_len * g_num + gi) * NS;
  const float* bg_c = c + ((size_t)bi * s_len * g_num + gi) * NS;
  // row tiles of this warp: rows 16 warp .. of the two m64 tiles
  const int rh = RT - 1 - warp, rl = warp;
  float* cum = sm + CUM_OFF;
  float* wj = sm + W_OFF;
  const float* big = sm + BIG_OFF;
  const float* small = sm + SMALL_OFF;

  auto stage_x = [&](int q) {
    const int ch = q / nh, h = h0 + q % nh, s0 = ch * Q;
    const size_t base = ((size_t)bi * s_len * h_num + h) * P;
    stage_rows<NT>(sm + RAW_OFF, XS, x + base, xstep, s0, Q, s_len, vec);
    const int t = s0 + threadIdx.x;          // NT == Q: one step a thread
    const bool ok = t < s_len;
    cp4(sm + DT_OFF + (q & 1) * Q + threadIdx.x,
        ok ? dt + ((size_t)bi * s_len + t) * h_num + h : dt, ok ? 4 : 0);
  };

  STAMP(0);
  stage_x(0);
  commit();
  for (int q = 0; q < nq; ++q) {
    const int ch = q / nh, hh = q - ch * nh, h = h0 + hh, s0 = ch * Q;
    const float* dts = sm + DT_OFF + (q & 1) * Q;
    float* st = sm + ST_OFF + hh * STATE_FLOATS;
    wait_groups<0>();
    __syncthreads();               // x_q landed; pair q - 1 is done
    if (q < 3) STAMP(2 + 4 * q);
    if (warp > 0) {
      // x dt split into big and small, K-major: item (kk, parity, p)
      // takes steps 8 kk + parity + {0, 2, 4, 6} of column p, one row of
      // a core matrix
      for (int e = threadIdx.x - 32; e < Q * P / 4; e += NT - 32) {
        const int p = e & (P - 1), par = (e >> 6) & 1, kk = e >> 7;
        const int j = 8 * kk + par;
        const float* src = sm + RAW_OFF + j * XS + p;
        uint4 hi4, lo4;
        split(src[0] * dts[j], hi4.x, lo4.x);
        split(src[2 * XS] * dts[j + 2], hi4.y, lo4.y);
        split(src[4 * XS] * dts[j + 4], hi4.z, lo4.z);
        split(src[6 * XS] * dts[j + 6], hi4.w, lo4.w);
        const int off = split_at(j, p);
        *reinterpret_cast<uint4*>(sm + BIG_OFF + off) = hi4;
        *reinterpret_cast<uint4*>(sm + SMALL_OFF + off) = lo4;
      }
    } else {
      // cum: inclusive sums of dt_j a_h in double, in log2 units, four
      // steps a lane
      const float ah = a[h];
      double s[4], run = 0.0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        run += (double)(dts[4 * lane + e] * ah);
        s[e] = run;
      }
      double incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
      }
      const double excl = incl - run;
      const double last = __shfl_sync(FULL, incl, 31) * LOG2E;
      const float lhi = (float)last, llo = (float)(last - (double)lhi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const double v = (excl + s[e]) * LOG2E;
        const float vh = (float)v, vl = (float)(v - (double)vh);
        const int j = 4 * lane + e;
        reinterpret_cast<float2*>(cum)[j] = make_float2(vh, vl);
        wj[j] = ex2((lhi - vh) + (llo - vl));
      }
      if (lane == 0) sm[E_OFF] = ex2(lhi + llo);
    }
    fence_async_shared();          // the split tile, for the tensor cores
    __syncthreads();
    if (q < 3) STAMP(3 + 4 * q);
    if (q + 1 < nq) {              // the raw slot is free: prefetch
      stage_x(q + 1);
      commit();
    }

    // ---- Y of the row tiles rh and rl (two m64 x n64 tiles)
    float dh[32], dl[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dh[e] = dl[e] = 0.f;
    float2 ch_[2], cl_[2];         // (hi, lo) of rows g and g + 8
    ch_[0] = reinterpret_cast<const float2*>(cum)[16 * rh + g8];
    ch_[1] = reinterpret_cast<const float2*>(cum)[16 * rh + g8 + 8];
    cl_[0] = reinterpret_cast<const float2*>(cum)[16 * rl + g8];
    cl_[1] = reinterpret_cast<const float2*>(cum)[16 * rl + g8 + 8];
    if (ch > 0) {
      // C S over n (plain K order), then exp(cum_i) row by row
      auto inter = [&](float (&d)[32], int r, const float2 (&ci)[2]) {
#pragma unroll 2
        for (int k = 0; k < NS; k += 8) {
          uint32_t bb[8][2], bsm[8][2];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            split(st[(k + t4) * SS + 8 * nt + g8], bb[nt][0], bsm[nt][0]);
            split(st[(k + t4 + 4) * SS + 8 * nt + g8], bb[nt][1],
                  bsm[nt][1]);
          }
          const int i = s0 + 16 * r + g8;
          const float* cr = bg_c + (size_t)i * bstep + k + t4;
          const bool ok0 = i < s_len, ok1 = i + 8 < s_len;
          const float av[4] = {ok0 ? __ldg(cr) : 0.f,
                               ok1 ? __ldg(cr + 8 * bstep) : 0.f,
                               ok0 ? __ldg(cr + 4) : 0.f,
                               ok1 ? __ldg(cr + 8 * bstep + 4) : 0.f};
          uint32_t ab[4], as[4];
          split4(av, ab, as);
          mma3<8>(d, ab, as, bb, bsm);
        }
        const float e0 = ex2(ci[0].x + ci[0].y);
        const float e1 = ex2(ci[1].x + ci[1].y);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          d[4 * nt] *= e0;
          d[4 * nt + 1] *= e0;
          d[4 * nt + 2] *= e1;
          d[4 * nt + 3] *= e1;
        }
      };
      inter(dh, rh, ch_);
      inter(dl, rl, cl_);
    }
    // (G o L)(X dt) on the tensor cores: the high tile (rows of tiles 7..4)
    // over step blocks 0..15, the low tile (tiles 0..3) over 0..7. A
    // fragments in two register sets: the next block's set is formed while
    // the tensor cores run this block's wgmmas.
    // launch 1's scores are complete (a no-op after the first pair; the
    // first pair's split and cum ran beside launch 1)
    griddep_wait();
    if (q == 0) STAMP(1);
    const float4* gq = reinterpret_cast<const float4*>(gsc) +
                       ((size_t)(bi * g_num + gi) * nc + ch) * TILES * 32;
    // scores loaded GD blocks ahead (from L2), A in two register sets
    constexpr int GD = 3;
    float4 gh[GD], gl[GD];
#pragma unroll
    for (int k = 0; k < GD; ++k) {
      gh[k] = g_load(gq, rh, k, lane);
      gl[k] = g_load(gq, rl, k, lane);
    }
    uint32_t ahb[2][4], ahs[2][4], alb[2][4], als[2][4];
    auto make_a = [&](int kk) {
      const int u = kk & 1, k = kk % GD;
      a_frag(gh[k], rh, kk, g8, t4, ch_, cum, ahb[u], ahs[u]);
      if (kk + GD < 2 * RT) gh[k] = g_load(gq, rh, kk + GD, lane);
      if (kk < RT) {
        a_frag(gl[k], rl, kk, g8, t4, cl_, cum, alb[u], als[u]);
        if (kk + GD < RT) gl[k] = g_load(gq, rl, kk + GD, lane);
      }
    };
    make_a(0);
    fence_regs(dh);
    fence_regs(dl);
#pragma unroll
    for (int kk = 0; kk < 2 * RT; ++kk) {
      const int u = kk & 1;
      wgmma_fence();
      wg_step(dh, ahb[u], ahs[u], big, small, kk);
      if (kk < RT) wg_step(dl, alb[u], als[u], big, small, kk);
      wgmma_commit();
      if (kk + 1 < 2 * RT) {
        wgmma_wait1();             // block kk - 1 is done with set u ^ 1
        make_a(kk + 1);
      }
    }
    wgmma_wait0();
    fence_regs(dh);
    fence_regs(dl);
    if (q < 3) STAMP(4 + 4 * q);
    // y rows s0 + i < s_len
    auto store_y = [&](const float (&d)[32], int r) {
      const int i = s0 + 16 * r + g8;
      float* yr = y + ((size_t)bi * s_len * h_num + h) * P + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ii = i + 8 * half;
        if (ii < s_len) {
          float* yp = yr + (size_t)ii * xstep;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            *reinterpret_cast<float2*>(yp + 8 * nt) =
                make_float2(d[4 * nt + 2 * half], d[4 * nt + 2 * half + 1]);
        }
      }
    };
    store_y(dh, rh);
    store_y(dl, rl);
    if (q < 3) STAMP(5 + 4 * q);
    // ---- the state after the chunk: rows 16 warp .. + 15, every p
    if (ch + 1 < nc) {
      __syncthreads();             // every warp has read the state (C S)
      const int n0 = 16 * warp + g8;
      float sacc[32];
      const float el = sm[E_OFF];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float2 r0 = make_float2(0.f, 0.f), r1 = make_float2(0.f, 0.f);
        if (ch > 0) {
          r0 = *reinterpret_cast<const float2*>(st + n0 * SS + 8 * nt +
                                                2 * t4);
          r1 = *reinterpret_cast<const float2*>(st + (n0 + 8) * SS +
                                                8 * nt + 2 * t4);
        }
        sacc[4 * nt] = el * r0.x;
        sacc[4 * nt + 1] = el * r0.y;
        sacc[4 * nt + 2] = el * r1.x;
        sacc[4 * nt + 3] = el * r1.y;
      }
#pragma unroll 2
      for (int kk = 0; kk < Q / 8; ++kk) {
        const int j0 = 8 * kk + 2 * t4;
        // B fragments from the split tile (rows j0, j0 + 1: slots t, t + 4)
        uint32_t bb[8][2], bsm[8][2];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int o0 = split_at(j0, 8 * nt + g8);
          const int o1 = split_at(j0 + 1, 8 * nt + g8);
          bb[nt][0] = __float_as_uint(big[o0]);
          bb[nt][1] = __float_as_uint(big[o1]);
          bsm[nt][0] = __float_as_uint(small[o0]);
          bsm[nt][1] = __float_as_uint(small[o1]);
        }
        // A[n][j] = b_j[n] to_end_j at (n0, j0), (n0+8, j0), (n0, j0+1),
        // (n0+8, j0+1); B = x dt
        const float2 w2 = reinterpret_cast<const float2*>(wj)[j0 >> 1];
        const int t = s0 + j0;
        const float* br = bg_b + (size_t)t * bstep + n0;
        const bool ok0 = t < s_len, ok1 = t + 1 < s_len;
        const float av[4] = {ok0 ? __ldg(br) * w2.x : 0.f,
                             ok0 ? __ldg(br + 8) * w2.x : 0.f,
                             ok1 ? __ldg(br + bstep) * w2.y : 0.f,
                             ok1 ? __ldg(br + bstep + 8) * w2.y : 0.f};
        uint32_t ab[4], as[4];
        split4(av, ab, as);
        mma3<8>(sacc, ab, as, bb, bsm);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        *reinterpret_cast<float2*>(st + n0 * SS + 8 * nt + 2 * t4) =
            make_float2(sacc[4 * nt], sacc[4 * nt + 1]);
        *reinterpret_cast<float2*>(st + (n0 + 8) * SS + 8 * nt + 2 * t4) =
            make_float2(sacc[4 * nt + 2], sacc[4 * nt + 3]);
      }
    }
  }
  STAMP(14);
}

inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}
}  // namespace

// scratch: the scores of launch 1, batch x g_num x ceil(s_len / Q) units of
// TILES x 32 x 4 floats (kernels/ssd.py:layout)
extern "C" int ssd_f32(const float* x, const float* dt, const float* a,
                       const float* b, const float* c, float* y,
                       float* scratch, int batch, int s_len, int h_num,
                       int g_num, void* stream) {
  if (batch < 1 || s_len < 1 || g_num < 1 || h_num % g_num)
    return (int)cudaErrorInvalidValue;
  const int nc = (s_len + Q - 1) / Q;
  const int rep = h_num / g_num, npair = (rep + HB - 1) / HB;
  const long long units = (long long)batch * g_num * nc;
  const long long blocks = (long long)batch * g_num * npair;
  if (4 * units > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int s_smem = (32 + Q) * XS * (int)sizeof(float);
  const int m_smem =
      (BASE_FLOATS + (nc > 1 ? min(HB, rep) * STATE_FLOATS : 0)) *
      (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, m_smem);
  if (e != cudaSuccess) return (int)e;
  scores_kernel<<<(unsigned)(4 * units), NTS, s_smem, st>>>(
      b, c, scratch, s_len, g_num, nc,
      aligned16(b) && aligned16(c) ? 1 : 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = m_smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ssd_kernel, x, dt, a, b, c,
                         (const float*)scratch, y, s_len, h_num, g_num, nc,
                         aligned16(x) ? 1 : 0);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
