// Fused GAR low-rank linear (paper Sec. 3.5, App. D.4), float32.
//
// Replaces the Pallas kernel `gar_matmul` of the JAX package
// (src/repro/kernels/gar_matmul.py:52, `_kernel`) together with the output
// permutation its caller applied (src/repro/kernels/ops.py, `gar_forward`):
//
//   z    = x @ v_tilde          (T, r)     the first r outputs
//   tail = z @ u_hat^T          (T, m - r)
//   y[:, j] = [z ; tail][:, perm_inv[j]]
//
// What bounds it on the card. Serving T is at most max_batch +
// prefill_chunk. At a decode batch (T 8) the kernel does 2T flops a
// factor element: it is bound by the bytes of v_tilde and u_hat (gemma3-27b
// mlp/gate at full rank: 462 MB, 0.138 ms at 3.35 TB/s); to reach that
// every SM has to stream factors. At a mixed iteration (gemma3 T 264) the
// products are 61 GFLOP and the bound is the tensor cores' rate (3 x 61
// GFLOP of TF32 at 495 TFLOP/s, 0.37 ms). gpt2-small's projections (a few
// MB, T 8-72) are bound by the latency of the launches.
//
// Design (the tile product, its 3xTF32 arithmetic on mma.sync or wgmma,
// the cp.async ring and split-K are csrc/lowrank_core.cuh):
//
//   stage 1 (gar_stage1): z = x @ v_tilde into a scratch (T, ldz) that the
//            wrapper allocates, ldz = r rounded up to 4. Block tiles of 128
//            z columns x a token tile of BN tokens (8, 32 or 64 for up to
//            that many tokens; 96 or 128 above), split along n in clusters
//            of up to 16 so that the tiles and splits fill the 132 SMs
//            (kernels/tiles.py picks both from a model of waves x steps).
//            The stage's blocks also invert the permutation's tail:
//            tail_col[perm_inv[j] - r] = j.
//   stage 2 (gar_stage2): tail = z @ u_hat^T over u_hat's rows in order, the
//            same tiling, each sum written straight to y[:, tail_col[i]].
//            Then every block copies a share of the identity outputs,
//            y[:, j] = z[:, perm_inv[j]] for perm_inv[j] < r, 8 tokens of a
//            column a work item: no operations.
//
// At gemma3's decode shapes (T 8) the first product has 17-42 tiles and is
// split 5-16 ways, the second 126-152 tiles split 1-3 ways: 170-672
// blocks, all SMs streaming factors. Two launches, not one cooperative
// launch with a grid barrier: z is at most 5.7 MB (gemma3 T 264) and stays
// in the 50 MB L2 between them, and nothing is held across a barrier. The
// second is a programmatic dependent launch: its blocks start as the
// first's finish and load their u_hat tiles before waiting for z, which
// hides the launch gap that bounds gpt2's small projections. The token
// tiles of one weight tile are neighbouring blocks, so they share its L2
// lines: at T 264 the factors stream from device memory about once. z
// lives in the scratch, so any rank runs in one call. Sums run in a fixed
// order (no atomics), so two calls on the same inputs give the same bits.
// m - r = 0 runs the first product and the copy; ragged T, n, r and m are
// masked in the tile loads.
//
// The stage-2 entry (gar_tail_f32) launches the second stage alone on a z
// it is given, (T, r) at row stride r, and writes tail = z @ u_hat^T (T,
// m - r) in u_hat's row order: no permutation and no identity copy. A
// tensor-parallel rank (models/tp.py) runs it where its stage 2 takes a z
// that other ranks made whole (gathered columns or summed partials), or
// its own columns of z against its columns of u_hat. z's rows take
// 16-byte loads where r is a multiple of 4 and z lies on the 16-byte grid.
#include "lowrank_core.cuh"

using namespace lrc;

// SHIFT: v_tilde's rows are off the 16-byte grid (csrc/lowrank_core.cuh)
template <int BN, bool SHIFT>
__global__ void __launch_bounds__(Cfg<BN>::NT, Cfg<BN>::MIN_BLOCKS)
gar_stage1(const float* __restrict__ x, const float* __restrict__ v,
           const int64_t* __restrict__ perm_inv, float* __restrict__ z,
           int* __restrict__ tail_col, int t, int n, int r, int m, int ldz,
           int kchunk, int b_vec) {
  using C = Cfg<BN>;
  extern __shared__ __align__(16) float smem[];
  griddep_launch();
  griddep_wait();                        // x, and the scratch's last readers
  const int blocks = gridDim.x * gridDim.y * gridDim.z;
  const int bid =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  for (int j = bid * C::NT + threadIdx.x; j < m; j += blocks * C::NT) {
    const int c = (int)perm_inv[j];
    if (c >= r) tail_col[c - r] = j;
  }
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= r) return;                   // the whole cluster shares m0
  const int k0 = blockIdx.z * kchunk, k1 = min(n, k0 + kchunk);
  Acc<C> acc;
  tile_product<C, false, SHIFT>(smem, v, r, r, x, n, b_vec, t, m0, n0, k0,
                         k1, acc);
  float* zo = z + (size_t)n0 * ldz + m0;
  reduce_store<C>(smem, acc, min(BM, r - m0), min(BN, t - n0),
                  [&](int i, int tt, float s) {
                    zo[(size_t)tt * ldz + i] = s;
                  });
}

// SHIFT: u_hat's rows are off the 16-byte grid. TAIL: the stage-2 entry
// on a given z (gar_tail_f32): the tail alone, written to y (T, mt) in
// u_hat's row order, without the permutation and the identity copy; z's
// row stride is ldz and b_vec says whether its rows allow 16-byte loads.
template <int BN, bool SHIFT, bool TAIL>
__global__ void __launch_bounds__(Cfg<BN>::NT, Cfg<BN>::MIN_BLOCKS)
gar_stage2(const float* __restrict__ z, const float* __restrict__ u,
           const int* __restrict__ tail_col,
           const int64_t* __restrict__ perm_inv, float* __restrict__ y, int t,
           int r, int mt, int ldz, int kchunk, int b_vec) {
  using C = Cfg<BN>;
  extern __shared__ __align__(16) float smem[];
  const int m = r + mt;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  griddep_launch();
  if (m0 < mt) {                         // rows past mt: the copy only
    const int k0 = blockIdx.z * kchunk, k1 = min(r, k0 + kchunk);
    Acc<C> acc;
    tile_product<C, true, SHIFT>(smem, u, r, mt, z, ldz, b_vec, t, m0, n0,
                                 k0, k1, acc);
    if constexpr (TAIL) {
      float* yo = y + (size_t)n0 * mt + m0;
      reduce_store<C>(smem, acc, min(BM, mt - m0), min(BN, t - n0),
                      [&](int i, int tt, float s) {
                        yo[(size_t)tt * mt + i] = s;
                      });
    } else {
      float* yo = y + (size_t)n0 * m;
      reduce_store<C>(smem, acc, min(BM, mt - m0), min(BN, t - n0),
                      [&](int i, int tt, float s) {
                        yo[(size_t)tt * m + tail_col[m0 + i]] = s;
                      });
    }
  }
  if constexpr (TAIL) return;
  griddep_wait();         // z complete (a no-op after tile_product's wait)
  // identity outputs: work item w = (token group of 8, column j)
  const int blocks = gridDim.x * gridDim.y * gridDim.z;
  const int bid =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const long items = (long)((t + 7) / 8) * m;
  for (long w = (long)bid * Cfg<BN>::NT + threadIdx.x; w < items;
       w += (long)blocks * Cfg<BN>::NT) {
    const int j = (int)(w % m), t0 = (int)(w / m) * 8;
    const int c = (int)perm_inv[j];
    if (c < r) {
      float val[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        val[q] = t0 + q < t ? z[(size_t)(t0 + q) * ldz + c] : 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (t0 + q < t) y[(size_t)(t0 + q) * m + j] = val[q];
    }
  }
}

template <int BN>
static int run(const float* x, const float* v, const float* u,
               const int64_t* perm_inv, float* y, float* scratch, int t,
               int n, int r, int mt, int gy1, int split1, int kc1, int gy2,
               int split2, int kc2, cudaStream_t stream) {
  using C = Cfg<BN>;
  const int ldz = (r + 3) & ~3;
  int* tail_col = reinterpret_cast<int*>(scratch + (size_t)t * ldz);
  const int gx = (t + BN - 1) / BN;
  const int b_vec = n % 4 == 0 && grid_offset(x) == 0;
  const int smem1 = 4 * smem_floats<BN, false>();
  const int smem2 = 4 * smem_floats<BN, true>();
  int rc = launch(shifted_rows(v, r) ? gar_stage1<BN, true>
                                     : gar_stage1<BN, false>,
                  C::NT, smem1, gx, gy1, split1, stream, x, v, perm_inv,
                  scratch, tail_col, t, n, r, r + mt, ldz, kc1, b_vec);
  if (rc != 0) return rc;
  return launch(shifted_rows(u, r) ? gar_stage2<BN, true, false>
                                   : gar_stage2<BN, false, false>,
                C::NT, smem2, gx, gy2, split2, stream, (const float*)scratch,
                u, (const int*)tail_col, perm_inv, y, t, r, mt, ldz, kc2, 1);
}

// The stage-2 entry: tail (t, mt) = z (t, r) @ u_hat^T, z given (a rank's
// columns of z, or the whole z gathered or summed over the ranks).
template <int BN>
static int run_tail(const float* z, const float* u, float* tail, int t,
                    int r, int mt, int gy, int split, int kc,
                    cudaStream_t stream) {
  using C = Cfg<BN>;
  const int b_vec = r % 4 == 0 && grid_offset(z) == 0;
  return launch(shifted_rows(u, r) ? gar_stage2<BN, true, true>
                                   : gar_stage2<BN, false, true>,
                C::NT, 4 * smem_floats<BN, true>(), (t + BN - 1) / BN, gy,
                split, stream, z, u, (const int*)nullptr,
                (const int64_t*)nullptr, tail, t, r, mt, r, kc, b_vec);
}

// scratch: t * ldz + mt floats (z, then tail_col as int32). The tiling
// (bn, the grid rows, splits and reduction chunks of both stages) comes
// from the wrapper (kernels/gar_matmul.py: tiling).
extern "C" int gar_matmul_f32(const float* x, const float* v_tilde,
                              const float* u_hat, const int64_t* perm_inv,
                              float* y, float* scratch, int t, int n, int r,
                              int mt, int bn, int gy1, int split1, int kc1,
                              int gy2, int split2, int kc2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 8:
      return run<8>(x, v_tilde, u_hat, perm_inv, y, scratch, t, n, r, mt,
                    gy1, split1, kc1, gy2, split2, kc2, s);
    case 32:
      return run<32>(x, v_tilde, u_hat, perm_inv, y, scratch, t, n, r, mt,
                     gy1, split1, kc1, gy2, split2, kc2, s);
    case 64:
      return run<64>(x, v_tilde, u_hat, perm_inv, y, scratch, t, n, r, mt,
                     gy1, split1, kc1, gy2, split2, kc2, s);
    case 96:
      return run<96>(x, v_tilde, u_hat, perm_inv, y, scratch, t, n, r, mt,
                     gy1, split1, kc1, gy2, split2, kc2, s);
    case 128:
      return run<128>(x, v_tilde, u_hat, perm_inv, y, scratch, t, n, r, mt,
                      gy1, split1, kc1, gy2, split2, kc2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// tail = z @ u_hat^T for z (t, r) and u_hat (mt, r), both contiguous; the
// tiling of the one launch from the wrapper (kernels/gar_matmul.py:
// tail_tiling).
extern "C" int gar_tail_f32(const float* z, const float* u_hat, float* tail,
                            int t, int r, int mt, int bn, int gy, int split,
                            int kc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 8:
      return run_tail<8>(z, u_hat, tail, t, r, mt, gy, split, kc, s);
    case 32:
      return run_tail<32>(z, u_hat, tail, t, r, mt, gy, split, kc, s);
    case 64:
      return run_tail<64>(z, u_hat, tail, t, r, mt, gy, split, kc, s);
    case 96:
      return run_tail<96>(z, u_hat, tail, t, r, mt, gy, split, kc, s);
    case 128:
      return run_tail<128>(z, u_hat, tail, t, r, mt, gy, split, kc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
