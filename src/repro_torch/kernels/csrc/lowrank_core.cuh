// The tile product shared by the two low-rank kernels (gar_matmul.cu,
// lowrank_matmul.cu): C[m0:m0+BM, n0:n0+BN] = sum over k of A[i, k] B[t, k]
// in float32, on the tensor cores in 3xTF32, over one split of the
// reduction, and the split-K sum of a thread block cluster.
//
// Operands. The weights' output columns are the M side and the tokens the
// N side, so a decode batch of 8 fills an mma's 8 columns. A is either
// MN-major (A[i, k] at a[k * lda + i]: the (n, r) factors v_tilde and v of
// a first product x @ v, read as they lie) or K-major (A[i, k] at
// a[i * lda + k]: u_hat and u). B is always K-major (B[t, k] at
// b[t * ldb + k]: x, or the scratch z). No operand is copied or transposed
// in device memory.
//
// Arithmetic. Each operand is split as big = tf32_rna(a) (cvt.rna.tf32.f32)
// and small = tf32_rna(a - big), and big * small + small * big + big * big
// are accumulated in that order. Plain TF32 (a 10-bit mantissa) misses the
// kernels' tolerance of 2e-4 of the output's max at K in the thousands;
// the split keeps float32-level error (tests/test_torch_tf32x3.py
// emulates both). The tensor cores' own adds round toward zero, which
// over thousands of steps costs some 1e-4 of the result on the H100 (at K
// 21504), so each stage's products go into a partial that starts at zero
// and the partial is added to the float32 sum with rounding to nearest.
//
// Two instruction paths, by the token tile BN (Cfg). Warp w owns weight
// rows 16w .. 16w + 15 of the block's 128 and every token of the tile.
//   BN 8 (decode; bound by the weights' bytes):
//     mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, fragments read
//     from the staged tiles and split in registers.
//   BN >= 32 (larger decode batches, prefill chunks, training): two
//     warpgroups of 64 rows, each wgmma.mma_async m64nBNk8 in TF32 with A
//     (the weights) in registers, as the mma.sync A fragment, and B (the
//     tokens) split once into big and small copies in shared memory, in
//     core matrices without swizzle. TF32 wgmma reads shared-memory operands
//     K-major only, which the first product's A is not; taking A from
//     registers lets one loader serve both majors. The stages are
//     software-pipelined: stage kt + 1 is split while stage kt's wgmmas run.
//   The split was timed on an H100 SXM (tools/core_variants.py) at
//   gemma3-27b's and gpt2-small's GAR shapes: at BN 8 wgmma takes 1.01-1.14x
//   the time of mma.sync; at BN 32 and 64 mma.sync takes 1.03-1.36x the
//   time of wgmma.
//
// Pipeline. A ring of STAGES tiles of BK = 32 reduction steps in shared
// memory, filled by `cp.async` (16-byte copies where the rows and the
// pointer allow, 4-byte copies otherwise; out-of-range elements are
// zero-filled through the copy's source size), `commit_group` /
// `wait_group`: the next tiles are in flight while the tensor cores work.
// Row strides are padded so that fragment loads hit 32 distinct banks
// (K-major stride = 4 mod 32, MN-major stride = 8 mod 32).
//
// Split-K. The blocks of a cluster (1, 1, S) share a tile and take S
// consecutive ranges of the reduction. Each writes its partial tile to its
// own shared memory; after a cluster barrier, block q sums slice q of the
// tile over the blocks in rank order 0..S-1 through distributed shared
// memory and hands each sum to the caller's store. No atomics: the same
// inputs give the same bits.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lrc {
namespace cg = cooperative_groups;

// The token tile from which the products run on wgmma; set with -D only
// to time the other splits (src/repro_torch/tools/core_variants.py).
#ifndef LRC_WGMMA_MIN
#define LRC_WGMMA_MIN 32
#endif

constexpr int BM = 128;        // weight output columns of a block tile
constexpr int BK = 32;         // reduction steps of a pipeline stage
constexpr int STAGES = 4;
constexpr int KS = BK + 4;     // row stride of a K-major tile
constexpr int MS = BM + 8;     // row stride of an MN-major tile
constexpr int RS = BM + 4;     // row stride of the split-K tile, token-major
constexpr int MAX_SPLIT = 16;  // a cluster (above 8 a non-portable size)

// Whether a token tile of bn tokens runs on wgmma (else on mma.sync).
__host__ __device__ constexpr bool wgmma_tile(int bn) {
  return bn >= LRC_WGMMA_MIN;
}

template <int BN, bool AK>
__host__ __device__ constexpr int a_floats() { return AK ? BM * KS : BK * MS; }

// the ring of raw tiles, then (wgmma) two buffers of the big and small
// copies of a stage's B tile; the split-K tile reuses the ring
template <int BN, bool AK>
__host__ __device__ constexpr int smem_floats() {
  constexpr int pipe = STAGES * (a_floats<BN, AK>() + BN * KS) +
                       (wgmma_tile(BN) ? 4 * BK * BN : 0);
  constexpr int red = BN * RS;
  return pipe > red ? pipe : red;
}

// An SM's 228 KB of shared memory hold two blocks of up to 113 KB each (the
// runtime reserves 1 KB a block).
constexpr int TWO_BLOCK_SMEM = 113 * 1024;

// A token tile of BN tokens: warp w of the block's 8 owns weight rows
// 16w .. 16w + 15 and every token, as BN / 8 accumulator tiles of 16 x 8
// (on wgmma, two warpgroups of 64 rows). Two blocks an SM where their
// shared memory fits (which caps a thread at 128 registers), else one.
template <int BN_>
struct Cfg {
  static constexpr int BN = BN_;
  static constexpr int NT = 256;
  static constexpr bool WGMMA = wgmma_tile(BN_);
  static constexpr int NTL = BN_ / 8;    // accumulator tiles of a warp
  static constexpr int MIN_BLOCKS =
      4 * smem_floats<BN_, true>() <= TWO_BLOCK_SMEM ? 2 : 1;
};

__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [row0, row0 + R) x columns [col0, col0 + C) of a row-major
// global array (leading dimension ld) into shared memory (row stride SS);
// elements past row_lim or col_lim read as zero. vec: 16-byte copies (ld,
// col0 and the pointer are multiples of 4 floats), else 4-byte copies.
template <int R, int C, int SS, int NT>
__device__ __forceinline__ void load_tile(float* s, const float* g, int ld,
                                          int row0, int row_lim, int col0,
                                          int col_lim, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int CV = C / 4, N = R * CV;
#pragma unroll
    for (int q = 0; q < (N + NT - 1) / NT; ++q) {
      const int e = tid + q * NT;
      if (N % NT == 0 || e < N) {
        const int rr = e / CV, cc = (e % CV) * 4;
        const int gr = row0 + rr, gc = col0 + cc;
        const int valid = gr < row_lim ? max(0, min(4, col_lim - gc)) : 0;
        cp16(s + rr * SS + cc, valid ? g + (size_t)gr * ld + gc : g,
             4 * valid);
      }
    }
  } else {
    constexpr int N = R * C;
#pragma unroll 4
    for (int q = 0; q < (N + NT - 1) / NT; ++q) {
      const int e = tid + q * NT;
      if (N % NT == 0 || e < N) {
        const int rr = e / C, cc = e % C;
        const int gr = row0 + rr, gc = col0 + cc;
        const bool valid = gr < row_lim && gc < col_lim;
        cp4(s + rr * SS + cc, valid ? g + (size_t)gr * ld + gc : g,
            valid ? 4 : 0);
      }
    }
  }
}

// The weights' tile, in 16-byte copies whatever their rows' alignment.
// SHIFT (ld or the pointer is not a multiple of 4 floats): row gr starts
// sh(gr) = (off + gr * ld) mod 4 floats past the 16-byte grid (off: the
// pointer's offset in floats from it; col0 is a multiple of 4), so it is
// copied from sh(gr) floats before col0 with one vector more, and element c
// of the row lies at c + sh(gr) (SS >= C + 4). The floats before col0 are
// never read; those past col_lim read as zero.
template <int R, int C, int SS, int NT, bool SHIFT>
__device__ __forceinline__ void load_a_tile(float* s, const float* g, int ld,
                                            int row0, int row_lim, int col0,
                                            int col_lim, unsigned off) {
  constexpr int CV = C / 4 + (SHIFT ? 1 : 0), N = R * CV;
#pragma unroll
  for (int q = 0; q < (N + NT - 1) / NT; ++q) {
    const int e = threadIdx.x + q * NT;
    if (N % NT == 0 || e < N) {
      const int rr = e / CV, cc = (e % CV) * 4;
      const int gr = row0 + rr;
      const int gc =
          col0 + cc -
          (SHIFT ? (int)((off + (unsigned)gr * (unsigned)ld) & 3u) : 0);
      const int valid = gr < row_lim ? max(0, min(4, col_lim - gc)) : 0;
      cp16(s + rr * SS + cc, valid ? g + (ptrdiff_t)gr * ld + gc : g,
           4 * valid);
    }
  }
}

// Programmatic dependent launch: a kernel launched with
// programmaticStreamSerializationAllowed starts while the previous kernel
// in the stream finishes; griddep_wait() blocks until that kernel has
// completed and its writes are visible, and griddep_launch() lets the next
// kernel start (its blocks then wait in griddep_wait). Both are no-ops for
// a kernel launched without the attribute.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The float offset of a pointer from the 16-byte grid.
__host__ __device__ inline unsigned grid_offset(const void* p) {
  return (unsigned)(((uintptr_t)p >> 2) & 3);
}

// Whether a row-major array's rows start off the 16-byte grid (load_a_tile
// with SHIFT).
inline bool shifted_rows(const float* p, int ld) {
  return grid_offset(p) != 0 || ld % 4 != 0;
}

__device__ __forceinline__ uint32_t tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void split(float a, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(a);
  small = tf32_rna(a - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <class C>
using Acc = float[C::NTL][4];

// A staged element of the A tile: row i (of BM) and reduction step k (of
// BK) of the stage whose first step is kb (with load_a_tile's row shift
// where SHIFT; off is the pointer's grid offset).
template <bool AK, bool SHIFT>
__device__ __forceinline__ float a_at(const float* as, int i, int k, int m0,
                                      int kb, int lda, unsigned off) {
  if constexpr (AK)
    return as[i * KS + k +
              (SHIFT ? (int)((off + (unsigned)(m0 + i) * lda) & 3u) : 0)];
  else
    return as[k * MS + i +
              (SHIFT ? (int)((off + (unsigned)(kb + k) * lda) & 3u) : 0)];
}

// The A fragment of a 16-row mma tile at rows row, row + 8 and steps
// kk + tq, kk + tq + 4, split into big and small.
template <bool AK, bool SHIFT>
__device__ __forceinline__ void a_frag(const float* as, int row, int kk,
                                       int tq, int m0, int kb, int lda,
                                       unsigned off, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  split(a_at<AK, SHIFT>(as, row, kk + tq, m0, kb, lda, off), big[0],
        small[0]);
  split(a_at<AK, SHIFT>(as, row + 8, kk + tq, m0, kb, lda, off), big[1],
        small[1]);
  split(a_at<AK, SHIFT>(as, row, kk + tq + 4, m0, kb, lda, off), big[2],
        small[2]);
  split(a_at<AK, SHIFT>(as, row + 8, kk + tq + 4, m0, kb, lda, off), big[3],
        small[3]);
}

// wgmma, as used from 32 tokens: fences, and m64nNk8 in TF32 with A in
// registers (the mma.sync A fragment of each warp's 16 rows) and B a
// K-major tile in shared memory without swizzle: 8-token x 4-step core
// matrices of 128 contiguous bytes, LBO the stride of the next 4 steps,
// SBO of the next 8 tokens.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) asm volatile("" : "+f"(d[k])::"memory");
}
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  const uint64_t addr = (uint64_t)__cvta_generic_to_shared(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_n8(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_n96(float (&d)[48],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2],
                                        const uint32_t (&a)[4], uint64_t desc,
                                        int scale_d) {
  if constexpr (N == 8)
    wgmma_n8(d, a, desc, scale_d);
  else if constexpr (N == 32)
    wgmma_n32(d, a, desc, scale_d);
  else if constexpr (N == 64)
    wgmma_n64(d, a, desc, scale_d);
  else if constexpr (N == 96)
    wgmma_n96(d, a, desc, scale_d);
  else
    wgmma_n128(d, a, desc, scale_d);
}

// acc = A[m0:m0+BM, k0:k1] B[n0:n0+BN, k0:k1]^T, for the rows i < M and
// tokens t < T (others come out as zeros). Each stage's 3xTF32 products
// accumulate in the tensor cores into a partial that starts at zero (their
// adds round toward zero, which over thousands of steps would cost some
// 1e-4 of the result), and the partial is added into acc in float32 with
// rounding to nearest. Leaves the shared memory free for the caller.
template <class C, bool AK, bool SHIFT>
__device__ __forceinline__ void tile_product(
    float* smem, const float* __restrict__ a, int lda, int M,
    const float* __restrict__ b, int ldb, bool b_vec, int T, int m0, int n0,
    int k0, int k1, Acc<C>& acc) {
  constexpr int A_FL = a_floats<C::BN, AK>();
  constexpr int B_FL = C::BN * KS;
  float* As = smem;
  float* Bs = smem + STAGES * A_FL;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int row = warp * 16 + g;         // of the warp's A fragments
#pragma unroll
  for (int j = 0; j < C::NTL; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  const int nk = k1 > k0 ? (k1 - k0 + BK - 1) / BK : 0;
  const unsigned sh = grid_offset(a);
  auto load_a = [&](int kt) {
    const int kb = k0 + kt * BK, slot = kt % STAGES;
    if constexpr (AK)
      load_a_tile<BM, BK, KS, C::NT, SHIFT>(As + slot * A_FL, a, lda, m0, M,
                                            kb, k1, sh);
    else
      load_a_tile<BK, BM, MS, C::NT, SHIFT>(As + slot * A_FL, a, lda, kb, k1,
                                            m0, M, sh);
  };
  auto load_b = [&](int kt) {
    const int kb = k0 + kt * BK, slot = kt % STAGES;
    load_tile<C::BN, BK, KS, C::NT>(Bs + slot * B_FL, b, ldb, n0, T, kb, k1,
                                    b_vec);
  };
  auto load = [&](int kt) {
    load_a(kt);
    load_b(kt);
  };
  // The first stages' A tiles (weights) are requested before waiting on
  // the previous launch (griddep_wait): in a second stage that launch is
  // the first stage, which writes B (z) and never A. A first stage waits
  // at its start, before this. Each stage's group then holds its B tile.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < nk) load_a(s);
  griddep_wait();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_b(s);
    commit();
  }

  if constexpr (C::WGMMA) {
    // Software-pipelined: while the tensor cores run stage kt's wgmmas,
    // the block splits stage kt + 1 (B into the other of two buffers of
    // core matrices, A into the other set of fragment registers).
    constexpr int LBO = C::BN / 8 * 128, SBO = 128;
    constexpr int SPLIT_FL = 2 * BK * C::BN;        // big, then small
    float* bsplit = Bs + STAGES * B_FL;
    // every warpgroup runs every stage (rows past M are zeros): a wgmma
    // issued under a condition makes the compiler wait on it early
    using Frag = uint32_t[BK / 8][4];
    Frag ab0, as0, ab1, as1;
    float d[C::BN / 2];
    auto prepare = [&](int kt, Frag& ab, Frag& asl) {
      const float* as = As + (kt % STAGES) * A_FL;
      const float* bs = Bs + (kt % STAGES) * B_FL;
      const int kb = k0 + kt * BK;
      float* bbig = bsplit + (kt & 1) * SPLIT_FL;
      float* bsmall = bbig + BK * C::BN;
      constexpr int E4 = C::BN * BK / 4;            // float4 of the tile
#pragma unroll
      for (int q = 0; q < (E4 + C::NT - 1) / C::NT; ++q) {
        const int e = threadIdx.x + q * C::NT;
        if (E4 % C::NT != 0 && e >= E4) break;
        const int n = e % C::BN, k4 = e / C::BN;
        const float4 v = *reinterpret_cast<const float4*>(bs + n * KS + 4 * k4);
        uint4 hi, lo;
        split(v.x, hi.x, lo.x);
        split(v.y, hi.y, lo.y);
        split(v.z, hi.z, lo.z);
        split(v.w, hi.w, lo.w);
        const int off = ((k4 * (C::BN / 8) + (n >> 3)) * 8 + (n & 7)) * 4;
        *reinterpret_cast<uint4*>(bbig + off) = hi;
        *reinterpret_cast<uint4*>(bsmall + off) = lo;
      }
#pragma unroll
      for (int s8 = 0; s8 < BK / 8; ++s8)
        a_frag<AK, SHIFT>(as, row, s8 * 8, tq, m0, kb, lda, sh, ab[s8],
                          asl[s8]);
    };
    auto step = [&](int kt, Frag& ab, Frag& asl, Frag& ab_next,
                    Frag& as_next) {
      const float* bbig = bsplit + (kt & 1) * SPLIT_FL;
      const float* bsmall = bbig + BK * C::BN;
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int s8 = 0; s8 < BK / 8; ++s8) {
        const uint64_t big = smem_desc(bbig + s8 * 2 * LBO / 4, LBO, SBO);
        const uint64_t small = smem_desc(bsmall + s8 * 2 * LBO / 4, LBO, SBO);
        wgmma_n<C::BN>(d, ab[s8], small, s8 > 0);
        wgmma_n<C::BN>(d, asl[s8], big, 1);
        wgmma_n<C::BN>(d, ab[s8], big, 1);
      }
      wgmma_commit();
      if (kt + 1 < nk) {
        wait_groups<STAGES - 2>();
        __syncthreads();    // tile kt + 1 landed; tile kt's raw readers done
        if (kt + STAGES < nk) load(kt + STAGES);
        commit();
        prepare(kt + 1, ab_next, as_next);
      }
      wgmma_wait0();
      fence_regs(d);
#pragma unroll
      for (int j = 0; j < C::NTL; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] += d[4 * j + q];
      fence_async_shared();
      __syncthreads();      // stage kt + 1's split copy is visible
    };
    if (nk > 0) {
      wait_groups<STAGES - 2>();
      __syncthreads();
      if (STAGES - 1 < nk) load(STAGES - 1);
      commit();
      prepare(0, ab0, as0);
      fence_async_shared();
      __syncthreads();
    }
    for (int kt = 0; kt < nk; kt += 2) {
      step(kt, ab0, as0, ab1, as1);
      if (kt + 1 < nk) step(kt + 1, ab1, as1, ab0, as0);
    }
  } else {
    // a warp whose rows all lie past M skips the products
    const bool live = m0 + warp * 16 < M;
    for (int kt = 0; kt < nk; ++kt) {
      wait_groups<STAGES - 2>();
      __syncthreads();      // tile kt landed; tile kt - 1's readers are done
      if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
      commit();
      if (!live) continue;
      const float* as = As + (kt % STAGES) * A_FL;
      const float* bs = Bs + (kt % STAGES) * B_FL;
      const int kb = k0 + kt * BK;
      float d[C::NTL][4];
#pragma unroll
      for (int j = 0; j < C::NTL; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[j][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t bb[C::NTL][2], bsl[C::NTL][2];
#pragma unroll
        for (int j = 0; j < C::NTL; ++j) {
          const int col = j * 8 + g;
          split(bs[col * KS + kk + tq], bb[j][0], bsl[j][0]);
          split(bs[col * KS + kk + tq + 4], bb[j][1], bsl[j][1]);
        }
        uint32_t ab[4], asl[4];
        a_frag<AK, SHIFT>(as, row, kk, tq, m0, kb, lda, sh, ab, asl);
#pragma unroll
        for (int j = 0; j < C::NTL; ++j) {
          mma(d[j], ab, bsl[j][0], bsl[j][1]);
          mma(d[j], asl, bb[j][0], bb[j][1]);
          mma(d[j], ab, bb[j][0], bb[j][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < C::NTL; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] += d[j][q];
    }
  }
  wait_groups<0>();
  __syncthreads();
}

// The split-K sum over the cluster, in block-rank order, handed to
// store(i, t, value) for the rows i < m_valid and tokens t < n_valid of the
// tile. Every block of the cluster must call it.
template <class C, class Store>
__device__ __forceinline__ void reduce_store(float* smem, const Acc<C>& acc,
                                             int m_valid, int n_valid,
                                             Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < C::NTL; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
    smem[col * RS + row] = acc[j][0];
    smem[(col + 1) * RS + row] = acc[j][1];
    smem[col * RS + row + 8] = acc[j][2];
    smem[(col + 1) * RS + row + 8] = acc[j][3];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int S = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const float* part[MAX_SPLIT];
#pragma unroll
  for (int p = 0; p < MAX_SPLIT; ++p)
    part[p] = p < S ? cluster.map_shared_rank(smem, p) : smem;
  constexpr int E = C::BN * BM;
  const int per = (E / BM + S - 1) / S * BM;   // whole token rows a block
  const int lo = q * per, hi = min(E, lo + per);
  for (int e = lo + (int)threadIdx.x; e < hi; e += C::NT) {
    const int t = e / BM, i = e % BM;
    if (t < n_valid && i < m_valid) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < MAX_SPLIT; ++p)
        if (p < S) s += part[p][t * RS + i];
      store(i, t, s);
    }
  }
  cluster.sync();           // no block leaves while another reads its tile
}

// Launch `kernel` on grid (gx, gy, split) in clusters of (1, 1, split),
// as a programmatic dependent launch (the kernel calls griddep_wait before
// it reads what an earlier launch wrote, or writes anything).
template <class... Params, class... Args>
inline int launch(void (*kernel)(Params...), int threads, int smem_bytes,
                  int gx, int gy, int split, cudaStream_t stream,
                  Args... args) {
  if (split < 1 || split > MAX_SPLIT || gx < 1 || gy < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, split);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace lrc
