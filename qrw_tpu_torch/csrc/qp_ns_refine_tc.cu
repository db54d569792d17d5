// Newton-Schulz refinement of a batch of KKT inverses at n = 192 on the
// tensor cores (3xTF32), each problem resident in a cluster of two blocks.
//
// Replaces the TPU kernel qrw_tpu/ops/qp_pallas.py::_ns_refine_kernel
// (Pallas, launched by qrw_tpu.ops.qp_pallas._ns_refine) for n = 192, the
// only n the full-size MPC path gives it; csrc/qp_ns_refine.cu stays the
// variant for any other n. Per problem, with K and a seed X0 (n x n,
// row-major), `ns_iters` steps of
//
//   T = K X;  X = 2 X - X T
//
// then resid = max |K X - I| over the n^2 entries (NaN propagates, as
// jnp.max lets it); ns_iters = 0 computes only the residual of the seed.
// The final store writes the re-centred 0.5 (X + X') that the wrapper
// computed outside the kernel before: 0.5f * (a + b) with a + b = b + a,
// the same bits as the wrapper's two passes.
//
// What bounds it on the H100: tensor-core operations. Each float32
// product is taken as three TF32 products (3xTF32, below): 2 ns_iters + 1
// products of 2 n^3 flop a problem, 405.9 Gflop at B = 4096 and
// ns_iters = 3, so 3 x 405.9 G / 495 TFLOP/s (dense TF32) = 2.46 ms;
// device memory sees K and X0 read once and X written once, 1.81 GB,
// 0.54 ms at 3.35 TB/s, which bounds the ns_iters = 0 call.
//
// The design:
// * 3xTF32 on mma.sync.m16n8k8 (TF32 operands, float32 accumulators).
//   Each operand a is split as a_big = cvt.rna.tf32(a), a_small =
//   cvt.rna.tf32(a - a_big), and a b is taken as a_small b_big + a_big
//   b_small + a_big b_big, the two small terms first (as CUTLASS's
//   3xTF32 does). Each k8 step's three products go into zeroed
//   registers, which are then added into the running sums in float32:
//   the tensor cores' own accumulation into a large running sum rounded
//   K X - I (a sum that cancels to ~1e-6) up to 3x worse than cuBLAS and
//   X 2x worse (chip_smoke.py on an H100); added this way, X and the
//   residual agree with the CPU emulation of the operand rounding
//   (tests/test_torch_qp_full.py), whose errors set the tolerances
//   chip_smoke.py holds the kernel to, for ~12% more time. The products
//   are float32 accurate but not the bits of a float32 FMA chain (the
//   plain version, torch.matmul, is cuBLAS in float32).
// * Non-finite values: for a = +-inf, a - a_big is NaN, and a finite a
//   whose rounding to TF32 overflows gives a_small = -+inf; so a product
//   that float32 makes inf can come out NaN here. Both are non-finite:
//   _factor maps any non-finite resid to inf, so the bad flag is the same,
//   and the finite pattern of X is the same.
// * Residency: a cluster of two blocks per problem (the grid is 2B
//   blocks). Block r keeps rows [96 r, 96 r + 96) of K, of X and of T in
//   shared memory, row stride 196 floats: 3 x 96 x 196 x 4 B = 225,792 B
//   (+ 64 B for the reductions) of the 232,448 B a block may use, so one
//   block an SM and 66 problems on the card at once. Block r computes
//   its own rows of every product; the right factor's other 96 rows are
//   read from the other block's shared memory (distributed shared
//   memory). K and X0 are read from device memory once (cp.async), X
//   written once; nothing else leaves the chip.
// * Warp tiling: 8 warps, each an output strip of all 96 rows x 24
//   columns (6 x 3 tiles of 16 x 8, 72 accumulators a thread), so each
//   remote element is read once, by one warp (4, 6 and 12 warps were
//   slower on the card). The left factor's fragments come by
//   ldmatrix.x4 (the 16 x 8 fp32 tile as four 8 x 4 matrices), the right
//   factor's by 32-bit loads. The stride 196 = 4 (mod 32) makes both
//   conflict-free: the 8 rows of an ldmatrix phase fall on 8 different
//   4-bank groups, and an n8 tile stands for columns 4j..4j+3 and
//   4j+16..4j+19 of a 32-column group (`tile_col`), so that rows t and
//   t + 4 of a k8 step hit 32 different banks.
// * Products and barriers: a product holds its whole 96-row slice in
//   registers; T = K X is stored at once (no block reads T in that
//   phase); X' = 2X - X T is stored after a block barrier, since X'
//   overwrites the X rows that other warps of the block still read; a
//   cluster barrier follows every store, so each product reads the other
//   block's finished slice, and one more after the last remote read
//   keeps a block's shared memory alive until the other is done with it.
// * What holds it near 30% of its bound (PERF.md): the three mma passes
//   and the split's conversions, with two warps a scheduler; variants
//   timed on the card without them ran much faster, while reading the
//   other block's slice locally saved little.
// * The residual product stores nothing: its epilogue takes |KX - I| and
//   a NaN-propagating max over the block, then over the cluster.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int N = 192;               // the only n this variant takes
constexpr int ROWS = N / 2;          // rows of each matrix a block keeps
constexpr int LD = N + 4;            // row stride in floats, 4 (mod 32)
constexpr int NW = 8;                // warps a block
constexpr int NT = 32 * NW;          // threads a block
constexpr int MT = ROWS / 16;        // m16 tiles of a warp's strip: 6
constexpr int NQ = N / 8 / NW;       // n8 tiles of a warp's strip: 3
constexpr int KH = ROWS / 8;         // k8 steps in each half of the depth
constexpr int MAT = ROWS * LD;       // floats of one resident slice
constexpr int RED = 16;              // floats for the reductions
constexpr size_t SMEM_BYTES = sizeof(float) * (3 * MAT + RED);

enum Epilogue { kStore, kNewton, kResid };

// max that propagates NaN from either side (as jnp.max / torch.amax)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 (the low 13 bits zero)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a b on a 16 x 8 x 8 tile, TF32 operands, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of a 16 x 8 fp32 tile: four 8 x 4 matrices (rows 0-7 /
// 8-15 x columns 0-3 / 4-7), each row 16 bytes; `addr` is this lane's row.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

// Matrix column of column c (0..7) of n8 tile q (0..23): tile q covers
// columns 4j..4j+3 and 4j+16..4j+19 of the 32-column group q / 4, j = q % 4.
__device__ __forceinline__ int tile_col(int q, int c) {
  return 32 * (q >> 2) + 4 * (q & 3) + (c < 4 ? c : c + 12);
}

// acc += A[:, k0 .. k0 + 96) Bh for the warp's strip: A is this block's
// slice of the left factor (all n columns, at shared address a_lane for
// this lane's ldmatrix row), Bh the 96 rows k0 .. k0 + 96 of the right
// factor (this block's slice or, through distributed shared memory, the
// other block's).
__device__ __forceinline__ void k_half(float (&acc)[MT][NQ][4],
                                       uint32_t a_lane, int k0,
                                       const float* Bh, const int (&col)[NQ],
                                       int t) {
#pragma unroll 2
  for (int ks = 0; ks < KH; ++ks) {
    uint32_t bb[NQ][2], bs[NQ][2];
    const float* b0 = Bh + (8 * ks + t) * LD;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      split(b0[col[j]], bb[j][0], bs[j][0]);
      split(b0[4 * LD + col[j]], bb[j][1], bs[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t a[4], ab[4], as[4];
      ldsm_x4(a, a_lane + 4u * (16 * i * LD + k0 + 8 * ks));
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__uint_as_float(a[e]), ab[e], as[e]);
      // this k-step's three products into zeroed registers, then one
      // IEEE add each into the running sums (see the note at the top)
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma(d, as, bb[j]);
        mma(d, ab, bs[j]);
        mma(d, ab, bb[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
      }
    }
  }
}

// This block's 96 rows of L R, where L is a resident slice (As) and R is
// split over the two blocks (Rloc this block's rows, Rrem the other's).
//   kStore:  C = L R
//   kNewton: C = 2 L - L R   (C = L = X, R = T)
//   kResid:  returns this thread's max |L R - I|; C is not touched.
template <int EPI>
__device__ float product(const float* As, const float* Rloc,
                         const float* Rrem, int rank, float* C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  int col[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) col[j] = tile_col(NQ * warp + j, g);
  const uint32_t a_lane =
      smem_u32(As) +
      4u * (((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 4 * (lane >> 4));
  float acc[MT][NQ][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  k_half(acc, a_lane, rank * ROWS, Rloc, col, t);
  k_half(acc, a_lane, (rank ^ 1) * ROWS, Rrem, col, t);

  if (EPI == kNewton) __syncthreads();  // every warp is done reading X
  float res = 0.f;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int c = tile_col(NQ * warp + j, 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * i + g + 8 * h;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (EPI == kResid) {
          const int gr = rank * ROWS + r;
          res = nan_max(res, fabsf(v0 - (gr == c ? 1.0f : 0.0f)));
          res = nan_max(res, fabsf(v1 - (gr == c + 1 ? 1.0f : 0.0f)));
        } else {
          float2* p = reinterpret_cast<float2*>(C + r * LD + c);
          if (EPI == kStore) {
            *p = make_float2(v0, v1);
          } else {
            const float2 x = *p;
            *p = make_float2(2.0f * x.x - v0, 2.0f * x.y - v1);
          }
        }
      }
    }
  }
  return res;
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NT, 1)
ns_refine_tc_kernel(const float* __restrict__ K_g,
                    const float* __restrict__ X0_g, float* __restrict__ X_g,
                    float* __restrict__ resid, int ns_iters) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Xs = Ks + MAT;
  float* Ts = Xs + MAT;
  float* red = Ts + MAT;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const size_t b = blockIdx.x / 2;
  const size_t off = b * N * N + (size_t)rank * ROWS * N;

  for (int e = threadIdx.x; e < ROWS * (N / 4); e += NT) {
    const int r = e / (N / 4), c = 4 * (e % (N / 4));
    cp_async16(Ks + r * LD + c, K_g + off + r * N + c);
    cp_async16(Xs + r * LD + c, X0_g + off + r * N + c);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  cluster.sync();  // both slices loaded, both blocks running

  const float* Xrem = cluster.map_shared_rank(Xs, rank ^ 1);
  const float* Trem = cluster.map_shared_rank(Ts, rank ^ 1);
  for (int it = 0; it < ns_iters; ++it) {
    product<kStore>(Ks, Xs, Xrem, rank, Ts);
    cluster.sync();  // T complete in both blocks
    product<kNewton>(Xs, Ts, Trem, rank, Xs);
    cluster.sync();  // X complete in both blocks, T no longer read
  }
  float r = product<kResid>(Ks, Xs, Xrem, rank, nullptr);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    r = nan_max(r, __shfl_xor_sync(0xffffffffu, r, o));
  if (lane == 0) red[warp] = r;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[0];
    for (int w = 1; w < NW; ++w) m = nan_max(m, red[w]);
    red[NW] = m;
  }
  cluster.sync();  // both blocks' maxima written
  if (rank == 0 && threadIdx.x == 0)
    resid[b] = nan_max(red[NW], *cluster.map_shared_rank(red + NW, 1));

  // X re-centred: 0.5 (X[i][j] + X[j][i]), row j in either block. Ts
  // (free after the last step) first takes this block's rows of X': lanes
  // walk i, so the column reads X[j][96 r + i] and the float4 stores
  // Ts[i][j..j+3] are conflict-free (reading X's columns directly, lanes
  // 4 rows apart, hit 2 banks: 16-way conflicts)
  float* out = X_g + off;
  for (int e = threadIdx.x; e < ROWS * (N / 4); e += NT) {
    const int i = e % ROWS, j = 4 * (e / ROWS);
    const int owner = j / ROWS;
    const float* src = (owner == rank ? Xs : Xrem) + (j - owner * ROWS) * LD +
                       rank * ROWS + i;
    *reinterpret_cast<float4*>(Ts + i * LD + j) =
        make_float4(src[0], src[LD], src[2 * LD], src[3 * LD]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ROWS * (N / 4); e += NT) {
    const int i = e / (N / 4), c = 4 * (e % (N / 4));
    const float4 x = *reinterpret_cast<const float4*>(Xs + i * LD + c);
    const float4 xt = *reinterpret_cast<const float4*>(Ts + i * LD + c);
    *reinterpret_cast<float4*>(out + i * N + c) =
        make_float4(0.5f * (x.x + xt.x), 0.5f * (x.y + xt.y),
                    0.5f * (x.z + xt.z), 0.5f * (x.w + xt.w));
  }
  cluster.sync();  // the other block is done reading this block's X
}

}  // namespace

extern "C" {

// Sets the kernel's shared-memory attribute and stores into *clusters how
// many of its clusters the card holds at once. Returns a CUDA error code.
int qrw_ns_refine_tc_max_active_clusters(int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(
      ns_refine_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(2 * 132, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters,
                                             ns_refine_tc_kernel, &cfg);
}

// All pointers are device pointers: K, X0, X (B, n, n), 16-byte aligned;
// resid (B,). Launches 2B blocks on `stream` and returns the error of the
// shared-memory attribute or cudaGetLastError(); cudaErrorInvalidValue
// where n is not 192 or B or ns_iters is out of range.
int qrw_ns_refine_tc(const float* K, const float* X0, float* X,
                     float* resid, int B, int n, int ns_iters,
                     void* stream) {
  if (n != N || B < 1 || B > (1 << 30) || ns_iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ns_refine_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  ns_refine_tc_kernel<<<2 * B, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      K, X0, X, resid, ns_iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
