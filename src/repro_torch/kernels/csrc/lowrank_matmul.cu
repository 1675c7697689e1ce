// Rank-masked low-rank linear (paper Sec. 3.3, the nested-mask training
// path), float32:
//
//   z = x @ v                 (T, r)
//   y = (z * [col < rank]) @ u^T   (T, m)
//
// Replaces the Pallas kernel `lowrank_matmul` of the JAX package
// (src/repro/kernels/lowrank_matmul.py, `_kernel`). What it keeps from that
// kernel: z never goes to device memory, and the mask costs no extra
// traffic. What differs: the TPU walked the r axis as a sequential grid
// dimension, accumulating y block by block; here blocks run in no order, so
// the whole z tile of a token tile has to be on chip before the second
// product starts. The kernel also skips the masked z columns: they add
// exact zeros, so only kr = min(rank, r) columns are computed and read.
//
// Bound on the card: operations. At the training shapes (T = 1024 tokens,
// n, m in {768, 3072}, kr up to 768) the kernel does 2 T (n + m) kr flops
// for (T (n + m) + (n + m) kr) * 4 bytes, some 100 flops per byte, far above
// the card's float32 ridge; the least time is the flops at the float32 rate
// (67 TFLOP/s; no tensor cores, as the reference runs in float32).
//
// Design: a cluster of CL = 8 blocks (a portable size) per tile of TT = 32
// token rows, as in csrc/gar_matmul.cu:
//
//   phase 1: block b computes the z columns [b*rc, (b+1)*rc), rc =
//            ceil(kr / CL), for its TT tokens, by a register-tiled product:
//            each thread holds 4 tokens x 2 columns (32 apart), chunks of
//            KC = 32 of the n reduction are staged in shared memory, the next
//            chunk's loads issued before this chunk's products;
//   gather:  after a cluster barrier every block copies the other blocks' z
//            rows out of their shared memory (distributed shared memory), so
//            every block holds the whole (kr, TT) z tile;
//   phase 2: block b produces the output columns [b*mc, (b+1)*mc), mc =
//            ceil(m / CL), by the same register-tiled product over the kr
//            reduction, u rows streamed through shared memory in chunks of
//            KC, and writes them straight to y (coalesced along m).
//
// Each weight byte is read once per token tile (from L2 after the first),
// spread over CL SMs. The tiles were chosen by their time over the
// training table's rows (repro_torch.tools.lowrank_variants): 2 columns a
// thread waste less of a phase-1 tile at small kr than 4, and unpadded z
// rows keep the shared memory at kr = 768 to 111 KB, so two blocks fit on
// an SM.
// rank = 0 writes zeros. T, n, r, m and kr need not be multiples of
// anything: every load and store is masked. The z tile takes 128 bytes a
// kept column, so a block holds at most some 1700 of them; the wrapper
// runs a larger kr (rwkv6-3b's 2560, zamba2-7b's 3584) in passes over
// column ranges of v and u (pointers offset, row stride r), each a launch
// that adds its product into y (`accumulate`).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// The tile sizes may be set with -D (repro_torch.tools.lowrank_variants
// builds variants that way); the defaults are the shipped kernel.
#ifndef CL
#define CL 8                 // blocks per cluster (at most 8: portable)
#endif
#ifndef NT
#define NT 256               // threads per block (8 warps)
#endif
#ifndef TPT
#define TPT 4                // token rows per thread (a multiple of 4)
#endif
#ifndef KC
#define KC 32                // reduction depth staged per step
#endif
#ifndef NJ
#define NJ 2                 // columns per thread, 32 apart
#endif
#ifndef ZPAD
#define ZPAD 0               // padding of a z tile row (a multiple of 4)
#endif
#define TT (NT / 32 * TPT)   // token rows per cluster: 32
#define CT (32 * NJ)         // columns per tile
#define ZS (TT + ZPAD)       // row stride of the z tile (float4 rows)
#define XS (TT + 4)          // row stride of the x tile (float4 rows)
#define WS (CT + 1)          // row stride of the weight tile
#define XPT (TT * KC / NT)   // x values each thread stages per step
#define WPT (KC * CT / NT)   // weight values each thread stages per step

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline int smem_floats(int kr) {
  return ceil_div(kr, CL) * CL * ZS + KC * XS + KC * WS;
}

// acc[i][j] += a[i] * w[32 j] for the thread's TPT token rows (a, read as
// float4 broadcasts) and NJ columns (w, one per lane)
__device__ __forceinline__ void fma_step(float (&acc)[TPT][NJ],
                                         const float* a, const float* w) {
  float av[TPT];
#pragma unroll
  for (int p = 0; p < TPT / 4; ++p) {
    const float4 f = *reinterpret_cast<const float4*>(a + 4 * p);
    av[4 * p] = f.x;
    av[4 * p + 1] = f.y;
    av[4 * p + 2] = f.z;
    av[4 * p + 3] = f.w;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float wj = w[32 * j];
#pragma unroll
    for (int i = 0; i < TPT; ++i) acc[i][j] += av[i] * wj;
  }
}

// ACC: add the product into y (a rank pass after the first) instead of
// writing it; a template argument, so that the writing kernel stays free
// of the read of y
template <bool ACC>
__global__ void __launch_bounds__(NT)
lowrank_matmul_kernel(const float* __restrict__ x, const float* __restrict__ v,
                      const float* __restrict__ u, float* __restrict__ y,
                      int t_total, int n, int r, int m, int kr) {
  extern __shared__ __align__(16) float smem[];
  const int rc = ceil_div(kr, CL);
  const int mc = ceil_div(m, CL);
  float* zs = smem;                      // (rc * CL, ZS) z, row = z column
  float* xs = zs + rc * CL * ZS;         // (KC, XS) x chunk, token-minor
  float* ws = xs + KC * XS;              // (KC, WS) v or u chunk

  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank();
  const int t0 = blockIdx.y * TT;
  const int rows = min(TT, t_total - t0);
  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;

  // phase 1: z[:, c_lo:c_hi] for this token tile
  const int c_lo = b * rc, c_hi = min(kr, c_lo + rc);
  for (int c0 = c_lo; c0 < c_hi; c0 += CT) {
    float acc[TPT][NJ];
#pragma unroll
    for (int i = 0; i < TPT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    float xr[XPT], wr[WPT];
    auto load = [&](int i0) {
#pragma unroll
      for (int q = 0; q < XPT; ++q) {
        const int e = tid + q * NT, tt = e / KC, k = e - tt * KC;
        xr[q] = (tt < rows && i0 + k < n) ? x[(size_t)(t0 + tt) * n + i0 + k]
                                          : 0.f;
      }
#pragma unroll
      for (int q = 0; q < WPT; ++q) {
        const int e = tid + q * NT, k = e / CT, c = e - k * CT;
        wr[q] = (i0 + k < n && c0 + c < c_hi) ? v[(size_t)(i0 + k) * r + c0 + c]
                                              : 0.f;
      }
    };
    load(0);
    for (int i0 = 0; i0 < n; i0 += KC) {
      __syncthreads();                 // the last chunk's readers are done
#pragma unroll
      for (int q = 0; q < XPT; ++q) {
        const int e = tid + q * NT, tt = e / KC;
        xs[(e - tt * KC) * XS + tt] = xr[q];
      }
#pragma unroll
      for (int q = 0; q < WPT; ++q) {
        const int e = tid + q * NT, k = e / CT;
        ws[k * WS + e - k * CT] = wr[q];
      }
      __syncthreads();
      if (i0 + KC < n) load(i0 + KC);
#pragma unroll 8
      for (int k = 0; k < KC; ++k)
        fma_step(acc, xs + k * XS + ty * TPT, ws + k * WS + tx);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + tx + 32 * j;
      if (c < c_hi) {
#pragma unroll
        for (int p = 0; p < TPT / 4; ++p)
          *reinterpret_cast<float4*>(zs + c * ZS + ty * TPT + 4 * p) =
              make_float4(acc[4 * p][j], acc[4 * p + 1][j], acc[4 * p + 2][j],
                          acc[4 * p + 3][j]);
      }
    }
  }

  // gather: every block copies the other blocks' z rows (TT floats each,
  // as TT / 4 float4 values)
  cluster.sync();
  const int row4 = TT / 4;
  const int slice = rc * row4;
  const int total = (CL - 1) * slice;
  for (int f = tid; f < total; f += NT) {
    const int q = f / slice, off = f - q * slice;
    const int src = (b + 1 + q) % CL;
    const int row = src * rc + off / row4;
    if (row < kr) {
      const int e = row * ZS + (off % row4) * 4;
      const float4* remote =
          reinterpret_cast<const float4*>(cluster.map_shared_rank(zs, src) + e);
      *reinterpret_cast<float4*>(zs + e) = *remote;
    }
  }
  cluster.sync();   // no block leaves while another still reads its z

  // phase 2: y[:, j_lo:j_hi] = z[:, :kr] @ u[j_lo:j_hi, :kr]^T
  const int j_lo = b * mc, j_hi = min(m, j_lo + mc);
  for (int c0 = j_lo; c0 < j_hi; c0 += CT) {
    float acc[TPT][NJ];
#pragma unroll
    for (int i = 0; i < TPT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    float wr[WPT];
    auto load = [&](int k0) {
#pragma unroll
      for (int q = 0; q < WPT; ++q) {
        const int e = tid + q * NT, c = e / KC, k = e - c * KC;
        wr[q] = (c0 + c < j_hi && k0 + k < kr) ? u[(size_t)(c0 + c) * r + k0 + k]
                                               : 0.f;
      }
    };
    if (kr > 0) load(0);
    for (int k0 = 0; k0 < kr; k0 += KC) {
      __syncthreads();
#pragma unroll
      for (int q = 0; q < WPT; ++q) {
        const int e = tid + q * NT, c = e / KC;
        ws[(e - c * KC) * WS + c] = wr[q];
      }
      __syncthreads();
      if (k0 + KC < kr) load(k0 + KC);
      const int kw = min(KC, kr - k0);
#pragma unroll 4
      for (int k = 0; k < kw; ++k)
        fma_step(acc, zs + (k0 + k) * ZS + ty * TPT, ws + k * WS + tx);
    }
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int tt = ty * TPT + i;
      if (tt >= rows) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = c0 + tx + 32 * j;
        if (c < j_hi) {
          float* out = y + (size_t)(t0 + tt) * m + c;
          *out = ACC ? *out + acc[i][j] : acc[i][j];
        }
      }
    }
  }
}

extern "C" int lowrank_matmul_smem_bytes(int kr) {
  return (int)(sizeof(float) * (size_t)smem_floats(kr));
}

extern "C" int lowrank_matmul_f32(const float* x, const float* v,
                                  const float* u, float* y, int t, int n,
                                  int r, int m, int kr, int accumulate,
                                  void* stream) {
  const int smem = lowrank_matmul_smem_bytes(kr);
  auto kernel = accumulate ? lowrank_matmul_kernel<true>
                           : lowrank_matmul_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, ceil_div(t, TT));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, v, u, y, t, n, r, m,
                                     kr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
