// Rank-masked low-rank linear (paper Sec. 3.3, the nested-mask training
// path), float32:
//
//   z = x @ v                 (T, r)
//   y = (z * [col < rank]) @ u^T   (T, m)
//
// Replaces the Pallas kernel `lowrank_matmul` of the JAX package
// (src/repro/kernels/lowrank_matmul.py:46, `_kernel`). What it keeps from
// that kernel: the mask costs no extra traffic. The masked columns add
// exact zeros, so only the kr = min(rank, r) kept columns of v and u are
// read and multiplied.
//
// What bounds it on the card: operations. At the training shapes (T 1024;
// gpt2-small n, m in {768, 3072} and kr up to 768; rwkv6-3b and zamba2-7b
// kr up to 2560 and 3584) the kernel does 2 T (n + m) kr flops, some 100
// or more a byte, far above the card's ridge; the least time is those
// flops in 3xTF32 (three TF32 products a float32 product) at 495 TFLOP/s.
//
// Design (the tile product, its 3xTF32 arithmetic on mma.sync or wgmma,
// the cp.async ring and split-K are csrc/lowrank_core.cuh):
//
//   stage 1 (lowrank_stage1): z[:, :kr] = x @ v[:, :kr] into a scratch
//            (T, ldz) that the wrapper allocates, ldz = kr rounded up to 4;
//   stage 2 (lowrank_stage2): y = z @ u[:, :kr]^T, written straight to y.
//
// Each stage tiles its output as 128 weight columns x a token tile of BN
// tokens (96 or 128 at training T, on wgmma; the token tiles of one weight
// tile are neighbouring blocks, so they share its L2 lines), split along
// the reduction in clusters of up to 16 where the tiles alone leave a
// partial wave (kernels/tiles.py picks both). Two launches, not one
// cooperative launch: z (at most 14.7 MB, zamba2 at kr 3584) stays in the
// 50 MB L2 between them; the second is a programmatic dependent launch
// that loads its first u tiles while the first finishes.
// Any kept rank runs in one call (z lives in the scratch). Sums run in a
// fixed order (no atomics). rank 0 writes zeros (the second product has no
// reduction steps). T, n, r, m and kr need not be multiples of anything:
// the tile loads are masked.
#include "lowrank_core.cuh"

using namespace lrc;

// SHIFT: v's rows are off the 16-byte grid (csrc/lowrank_core.cuh)
template <int BN, bool SHIFT>
__global__ void __launch_bounds__(Cfg<BN>::NT, Cfg<BN>::MIN_BLOCKS)
lowrank_stage1(const float* __restrict__ x, const float* __restrict__ v,
               float* __restrict__ z, int t, int n, int r, int kr, int ldz,
               int kchunk, int b_vec) {
  using C = Cfg<BN>;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  griddep_launch();
  griddep_wait();                        // x, and z's last readers
  if (m0 >= kr) return;                  // the whole cluster shares m0
  const int k0 = blockIdx.z * kchunk, k1 = min(n, k0 + kchunk);
  Acc<C> acc;
  tile_product<C, false, SHIFT>(smem, v, r, kr, x, n, b_vec, t, m0, n0, k0,
                         k1, acc);
  float* zo = z + (size_t)n0 * ldz + m0;
  reduce_store<C>(smem, acc, min(BM, kr - m0), min(BN, t - n0),
                  [&](int i, int tt, float s) {
                    zo[(size_t)tt * ldz + i] = s;
                  });
}

// SHIFT: u's rows are off the 16-byte grid
template <int BN, bool SHIFT>
__global__ void __launch_bounds__(Cfg<BN>::NT, Cfg<BN>::MIN_BLOCKS)
lowrank_stage2(const float* __restrict__ z, const float* __restrict__ u,
               float* __restrict__ y, int t, int r, int m, int kr, int ldz,
               int kchunk) {
  using C = Cfg<BN>;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  griddep_launch();
  if (m0 >= m) {
    griddep_wait();
    return;
  }
  const int k0 = blockIdx.z * kchunk, k1 = min(kr, k0 + kchunk);
  Acc<C> acc;
  tile_product<C, true, SHIFT>(smem, u, r, m, z, ldz, true, t, m0, n0, k0,
                        k1, acc);
  float* yo = y + (size_t)n0 * m + m0;
  reduce_store<C>(smem, acc, min(BM, m - m0), min(BN, t - n0),
                  [&](int i, int tt, float s) { yo[(size_t)tt * m + i] = s; });
}

template <int BN>
static int run(const float* x, const float* v, const float* u, float* y,
               float* scratch, int t, int n, int r, int m, int kr, int gy1,
               int split1, int kc1, int gy2, int split2, int kc2,
               cudaStream_t stream) {
  using C = Cfg<BN>;
  const int ldz = (kr + 3) & ~3;
  const int gx = (t + BN - 1) / BN;
  const int b_vec = n % 4 == 0 && grid_offset(x) == 0;
  const int smem1 = 4 * smem_floats<BN, false>();
  const int smem2 = 4 * smem_floats<BN, true>();
  int rc = launch(
      shifted_rows(v, r) ? lowrank_stage1<BN, true> : lowrank_stage1<BN, false>,
      C::NT, smem1, gx, gy1, split1, stream, x, v, scratch, t, n, r, kr, ldz,
      kc1, b_vec);
  if (rc != 0) return rc;
  return launch(
      shifted_rows(u, r) ? lowrank_stage2<BN, true> : lowrank_stage2<BN, false>,
      C::NT, smem2, gx, gy2, split2, stream, (const float*)scratch, u, y, t,
      r, m, kr, ldz, kc2);
}

// scratch: t * ldz floats (z). The tiling (bn, the grid rows, splits and
// reduction chunks of both stages) comes from the wrapper
// (kernels/lowrank_matmul.py: tiling).
extern "C" int lowrank_matmul_f32(const float* x, const float* v,
                                  const float* u, float* y, float* scratch,
                                  int t, int n, int r, int m, int kr, int bn,
                                  int gy1, int split1, int kc1, int gy2,
                                  int split2, int kc2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 8:
      return run<8>(x, v, u, y, scratch, t, n, r, m, kr, gy1, split1, kc1,
                    gy2, split2, kc2, s);
    case 32:
      return run<32>(x, v, u, y, scratch, t, n, r, m, kr, gy1, split1, kc1,
                     gy2, split2, kc2, s);
    case 64:
      return run<64>(x, v, u, y, scratch, t, n, r, m, kr, gy1, split1, kc1,
                     gy2, split2, kc2, s);
    case 96:
      return run<96>(x, v, u, y, scratch, t, n, r, m, kr, gy1, split1, kc1,
                     gy2, split2, kc2, s);
    case 128:
      return run<128>(x, v, u, y, scratch, t, n, r, m, kr, gy1, split1, kc1,
                      gy2, split2, kc2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of clusters of `split` blocks that the card holds at once, for the
// kernel of token tile bn (cudaOccupancyMaxActiveClusters x split). The
// wrappers split with the card's answer (lowrank_matmul.py: card_slots); the
// CPU tests' table of an H100 SXM (kernels/tiles.py: CLUSTER_SLOTS) is held
// against it.
extern "C" int lowrank_cluster_slots(int bn, int split) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, split * 64);
  cfg.blockDim = dim3(256);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  auto query = [&](auto kernel, int smem) {
    cfg.dynamicSmemBytes = smem;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess ||
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
      return -1;
    return n * split;
  };
  switch (bn) {
    case 8:
      return query(lowrank_stage2<8, false>, 4 * smem_floats<8, true>());
    case 32:
      return query(lowrank_stage2<32, false>, 4 * smem_floats<32, true>());
    case 64:
      return query(lowrank_stage2<64, false>, 4 * smem_floats<64, true>());
    case 96:
      return query(lowrank_stage2<96, false>, 4 * smem_floats<96, true>());
    case 128:
      return query(lowrank_stage2<128, false>, 4 * smem_floats<128, true>());
    default: return -1;
  }
}
