// Fused GAR low-rank linear (paper Sec. 3.5, App. D.4), float32.
//
// Replaces the Pallas kernel `gar_matmul` of the JAX package
// (src/repro/kernels/gar_matmul.py, `_kernel`) together with the output
// permutation its caller applied (src/repro/kernels/ops.py, `gar_forward`):
//
//   z    = x @ v_tilde          (T, r)     the first r outputs
//   tail = z @ u_hat^T          (T, m - r) accumulated in float32
//   y[:, j] = [z ; tail][:, perm_inv[j]]
//
// Bound on the card: bytes. At serving T is at most max_batch +
// prefill_chunk, so the kernel does about 2T flops per byte of v_tilde and
// u_hat; the least time is those bytes at the memory rate. The Pallas kernel
// ran the token tiles in order on one core; here the weights must be read by
// many SMs at once, yet z (which every output column needs whole) must stay
// on chip. The design uses a thread block cluster of C = 16 blocks on 16
// SMs (a non-portable cluster size, allowed on the H100) per tile of TT
// token rows:
//
//   phase 1: block b of the cluster computes the z columns
//            [b*rc, (b+1)*rc), rc = ceil(r / C), for its TT tokens: lanes
//            own 64 neighbouring columns (coalesced reads of v_tilde rows,
//            the next chunk's loads issued before this chunk's products),
//            the 16 warps split the n reduction and meet in shared memory;
//   gather:  after a cluster barrier each block copies the other blocks' z
//            columns out of their shared memory (distributed shared memory),
//            so every block holds the whole z tile; z never touches device
//            memory;
//   phase 2: block b produces the output columns [b*mc, (b+1)*mc),
//            mc = ceil(m / C): column j takes source c = perm_inv[j]; c < r
//            copies z[:, c] (the identity block costs no flops), c >= r is
//            the dot product of z with row c - r of u_hat. A warp takes 32
//            columns, one per lane, and streams their u_hat rows through a
//            shared tile 32 values at a time (coalesced, 32 loads in flight
//            per lane, the next chunk's issued before this one's
//            products). Each lane writes its column for the tile's tokens
//            (a warp writes 32 neighbouring floats of a row at a time).
//
// Rank passes: the z tile takes 64 bytes a column of shared memory, so a
// rank above some 2480 does not fit a block. The wrapper then launches one
// pass per range [j0, j0 + rp) of z's columns, as few and as even as fit:
// a pass computes z[:, j0:j0+rp] = x @ v_tilde[:, j0:j0+rp], writes the
// identity outputs whose source lies in its range (and leaves the other
// identity outputs untouched), and adds z_pass @ u_hat[:, j0:j0+rp]^T into
// the tail outputs: the first pass writes them, later passes add
// (`ACC`, a template argument, so the one-pass kernel has no run-time
// branch on it). v_tilde and u_hat keep their leading dimension r.
//
// Each weight byte is read once per token tile (from L2 after the first
// tile), spread over C SMs. m - r = 0 and r, n, m that are multiples of
// nothing are handled by the same code.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define CL 16                // blocks per cluster (a non-portable size)
#define NT 512
#define NWARPS (NT / 32)
#define TT 16                // token rows per cluster
#define KC 128               // x columns staged per step of phase 1
#define RPW (KC / NWARPS)    // x columns per warp per step
#define XPT (TT * KC / NT)   // x values each thread stages per step
#define GATHER 4             // remote z loads in flight per thread
#define TS 33                // padded row stride of a warp's u_hat tile
#define FULL_MASK 0xffffffffu

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline int scratch_floats() {
  const int p1 = KC * TT + NWARPS * TT * 64;    // x chunk + partial sums
  const int p2 = NWARPS * 32 * TS;              // one u_hat tile per warp
  return p1 > p2 ? p1 : p2;
}

// v and u point at column j0 of v_tilde and u_hat (leading dimension r);
// this pass owns z's columns [j0, j0 + rp).
template <bool ACC>
__global__ void __launch_bounds__(NT)
gar_matmul_kernel(const float* __restrict__ x, const float* __restrict__ v,
                  const float* __restrict__ u,
                  const int64_t* __restrict__ perm_inv,
                  float* __restrict__ y, int t_total, int n, int r, int mt,
                  int j0, int rp) {
  extern __shared__ __align__(16) float smem[];
  const int m = r + mt;
  const int rc = ceil_div(rp, CL);
  const int mc = ceil_div(m, CL);
  float* zt = smem;                      // (rp, TT) the pass's z tile, token-minor
  float* scratch = zt + rp * TT;         // phase 1 or phase 2 working space
  float* xs = scratch;                   // (KC, TT) x chunk, token-minor
  float* red = xs + KC * TT;             // (NWARPS, TT, 64) partial sums

  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank();
  const int t0 = blockIdx.y * TT;
  const int rows = min(TT, t_total - t0);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int k_lo = b * rc, k_hi = min(rp, k_lo + rc);

  // phase 1: z[:, k_lo:k_hi] for this token tile. A lane owns two columns
  // (64 per pass, coalesced reads of v_tilde rows); each warp takes RPW
  // rows of the current x chunk. The next chunk's x and v_tilde values are
  // loaded into registers while this chunk is multiplied, x read from
  // shared memory as float4 broadcasts over the 16 tokens.
  for (int kc0 = k_lo; kc0 < k_hi; kc0 += 64) {
    const int ka = kc0 + lane, kb = kc0 + 32 + lane;
    const bool has_a = ka < k_hi, has_b = kb < k_hi;
    float acc_a[TT], acc_b[TT];
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) acc_a[tt] = acc_b[tt] = 0.f;
    float xr[XPT], va[RPW], vb[RPW];
    auto load = [&](int i0) {
#pragma unroll
      for (int q = 0; q < XPT; ++q) {
        const int e = tid + q * NT, tt = e / KC, ii = i0 + e - tt * KC;
        xr[q] = (tt < rows && ii < n) ? x[(size_t)(t0 + tt) * n + ii] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        const int ii = i0 + warp * RPW + q;
        va[q] = (has_a && ii < n) ? v[(size_t)ii * r + ka] : 0.f;
        vb[q] = (has_b && ii < n) ? v[(size_t)ii * r + kb] : 0.f;
      }
    };
    load(0);
    for (int i0 = 0; i0 < n; i0 += KC) {
      __syncthreads();                 // the last chunk's readers are done
#pragma unroll
      for (int q = 0; q < XPT; ++q) {
        const int e = tid + q * NT, tt = e / KC;
        xs[(e - tt * KC) * TT + tt] = xr[q];
      }
      __syncthreads();
      float wa[RPW], wb[RPW];
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        wa[q] = va[q];
        wb[q] = vb[q];
      }
      if (i0 + KC < n) load(i0 + KC);
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        const float4* xq =
            reinterpret_cast<const float4*>(xs + (warp * RPW + q) * TT);
#pragma unroll
        for (int p = 0; p < TT / 4; ++p) {
          const float4 xv = xq[p];
          acc_a[4 * p + 0] += xv.x * wa[q];
          acc_a[4 * p + 1] += xv.y * wa[q];
          acc_a[4 * p + 2] += xv.z * wa[q];
          acc_a[4 * p + 3] += xv.w * wa[q];
          acc_b[4 * p + 0] += xv.x * wb[q];
          acc_b[4 * p + 1] += xv.y * wb[q];
          acc_b[4 * p + 2] += xv.z * wb[q];
          acc_b[4 * p + 3] += xv.w * wb[q];
        }
      }
    }
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      red[(warp * TT + tt) * 64 + lane] = acc_a[tt];
      red[(warp * TT + tt) * 64 + 32 + lane] = acc_b[tt];
    }
    __syncthreads();
    for (int e = tid; e < TT * 64; e += NT) {
      const int tt = e >> 6, l = e & 63;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) s += red[(w * TT + tt) * 64 + l];
      if (kc0 + l < k_hi) zt[(kc0 + l) * TT + tt] = s;
    }
  }

  // gather: every block copies the other blocks' z rows, GATHER loads in
  // flight per thread before their stores
  cluster.sync();
  const int slice = rc * TT;
  const int total = (CL - 1) * slice;
  for (int f0 = tid; f0 < total; f0 += GATHER * NT) {
    float val[GATHER];
    int dst[GATHER];
#pragma unroll
    for (int g = 0; g < GATHER; ++g) {
      const int f = f0 + g * NT;
      const int q = f / slice, off = f - q * slice;
      const int src = (b + 1 + q) % CL;
      const int e = src * slice + off;
      dst[g] = (f < total && e < rp * TT) ? e : -1;
      val[g] = dst[g] >= 0 ? cluster.map_shared_rank(zt, src)[e] : 0.f;
    }
#pragma unroll
    for (int g = 0; g < GATHER; ++g)
      if (dst[g] >= 0) zt[dst[g]] = val[g];
  }
  cluster.sync();   // no block leaves while another still reads its z

  // phase 2: output columns [j_lo, j_lo + jn), 32 per warp at a time, one
  // per lane. A tail column's u_hat row is streamed through a shared tile
  // in chunks of 32: the warp loads 32 rows x 32 values coalesced (32 loads
  // in flight per lane), then each lane takes the dot of its row with z.
  const int j_lo = b * mc;
  const int jn = max(0, min(mc, m - j_lo));
  float* tile = scratch + warp * 32 * TS;
  for (int jt = warp * 32; jt < jn; jt += NWARPS * 32) {
    const int j = jt + lane;
    const bool has = j < jn;
    const int c = has ? (int)perm_inv[j_lo + j] : 0;
    const bool tail = has && c >= r;
    const bool mine = has && c >= j0 && c < j0 + rp;   // identity, this pass
    const int row = tail ? c - r : -1;
    float part[TT];
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) part[tt] = 0.f;
    if (__any_sync(FULL_MASK, tail)) {
      // the next chunk's 32 loads are issued before this chunk's products
      float uv[32], un[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int ri = __shfl_sync(FULL_MASK, row, i);
        uv[i] = (ri >= 0 && lane < rp) ? u[(size_t)ri * r + lane] : 0.f;
      }
      for (int k0 = 0; k0 < rp; k0 += 32) {
        const int kw = min(32, rp - k0);
#pragma unroll
        for (int i = 0; i < 32; ++i) tile[i * TS + lane] = uv[i];
        __syncwarp();
        const int kn = k0 + 32 + lane;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int ri = __shfl_sync(FULL_MASK, row, i);
          un[i] = (ri >= 0 && kn < rp) ? u[(size_t)ri * r + kn] : 0.f;
        }
        for (int kk = 0; kk < kw; ++kk) {
          const float uk = tile[lane * TS + kk];
          const float4* z4 = reinterpret_cast<const float4*>(zt + (k0 + kk) * TT);
#pragma unroll
          for (int p = 0; p < TT / 4; ++p) {
            const float4 zv = z4[p];
            part[4 * p + 0] += zv.x * uk;
            part[4 * p + 1] += zv.y * uk;
            part[4 * p + 2] += zv.z * uk;
            part[4 * p + 3] += zv.w * uk;
          }
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 32; ++i) uv[i] = un[i];
      }
    }
    if (tail || mine) {
      float* yo = y + (size_t)t0 * m + j_lo + j;
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) {
        if (tt < rows) {
          const float val = tail ? part[tt] : zt[(c - j0) * TT + tt];
          yo[(size_t)tt * m] = (ACC && tail) ? yo[(size_t)tt * m] + val : val;
        }
      }
    }
  }
}

extern "C" int gar_matmul_smem_bytes(int rp) {
  return (int)(sizeof(float) * ((size_t)rp * TT + (size_t)scratch_floats()));
}

// one rank pass over z's columns [j0, j0 + rp); accumulate: add into the
// tail outputs (a pass after the first) instead of writing them
extern "C" int gar_matmul_f32(const float* x, const float* v_tilde,
                              const float* u_hat, const int64_t* perm_inv,
                              float* y, int t, int n, int r, int mt, int j0,
                              int rp, int accumulate, void* stream) {
  const int smem = gar_matmul_smem_bytes(rp);
  auto kernel = accumulate ? gar_matmul_kernel<true> : gar_matmul_kernel<false>;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
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
  e = cudaLaunchKernelEx(&cfg, kernel, x, v_tilde + j0, u_hat + j0, perm_inv,
                         y, t, n, r, mt, j0, rp);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
