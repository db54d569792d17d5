// K^-1 of a batch of symmetric positive definite matrices in float32, one
// launch: a Cholesky factor, then two triangular solves against the
// identity.
//
// Replaces no Pallas kernel. It stands for what qrw_tpu leaves to XLA in
// qrw_tpu/ops/qp_pallas.py::_chol_inv (:254-258): jnp.linalg.cholesky,
// then jax.scipy.linalg.cho_solve against the identity. The port took them
// through torch.linalg.cholesky and torch.cholesky_solve (magma): the
// status check of the first blocked the host until the card had drained
// and raised for the whole batch on one matrix that was not positive
// definite, and the batched triangular solves built their pointer arrays
// on the host on every call. Per problem, here:
//
//   K = L L'    right-looking, one column of L a step
//   L Y = I     forward substitution, one row of Y a step
//   L' X = Y    backward substitution, one row of X a step
//
// of (K + K') / 2, as jnp.linalg.cholesky symmetrizes its input: cho_solve's
// mathematics, with the second solve kept (K^-1 taken as W'W, W = L^-1,
// stalls float32 solves at n = 192), in float32 FMAs (no TF32). A problem
// with a pivot that is not positive or not finite (a NaN or an inf
// anywhere in K ends in such a pivot) gets NaN in its whole K^-1, as
// jnp.linalg.cholesky gives, and a 1 in `nonpd`; the other problems are
// untouched. Nothing is read back, allocated or synchronized.
//
// What bounds it on the H100. Inverting an SPD matrix is n^3 flop (potrf
// n^3 / 3, the rest 2 n^3 / 3, as LAPACK counts potrf + potri); K is read
// and K^-1 written once, 8 n^2 bytes. At the callers' shapes: (256, 192)
// 1.81 GFLOP, 27.0 us at the published 67 TFLOP/s of float32; (1024, 96)
// 75.5 MB, 22.5 us at 3.35 TB/s; (2048, 144) 340 MB, 101 us. The callers
// wait on the host rather than on this time: one launch where the library
// made many and read a status.
//
// The design, one algorithm whose parameters follow n (read from the
// input):
// * A block per problem of g x g threads, g = ceil(n / 6): thread
//   (ty, tx) keeps in registers the 6 x 6 tile of rows ty + g r and
//   columns tx + g s (r, s < 6) for the whole launch: K, then the trailing
//   matrix of the factor, then Y, then X. The cyclic layout keeps each
//   thread's share of the rows a step updates even as the factor and the
//   forward solve move down the matrix and the backward solve moves up.
//   n = 192: 1,024 threads; n = 144: 576; n = 96: 256; any n up to 192
//   (above it g^2 would pass the 1,024 threads of a block).
// * A step broadcasts one column (the factor) or one row (the solves)
//   through shared memory: the threads that hold it write it, one barrier,
//   and every thread reads the 6 + 6 values its tile needs and updates its
//   36 entries in registers; rows the step does not change are skipped.
//   The buffer is double-buffered, so a step costs one barrier: 3 n a
//   problem.
// * The factor's diagonal is summed apart, in shared memory, with its
//   rounding error carried beside it (a two-sum and the FMA's product
//   error: float32 operations, no wider type). The pivots end sums of up
//   to n products that cancel most of K_jj; as one float32 chain in
//   registers they left the factor 4-8x less accurate than the library's
//   on the solver's KKT matrices (a float32 emulation of both on the
//   CPU), compensated it is as accurate. One thread a step takes the next
//   pivot's 1 / sqrt, so its division and square root are not repeated by
//   every thread.
// * L below its diagonal and 1 / L_jj stay in shared memory for the
//   solves, row stride n + 1, so that a column is read conflict-free:
//   (n (n + 1) + 5 n) x 4 B, 152,064 B at n = 192, 86,400 at 144, 39,168
//   at 96. One problem a block at every n: the 64 registers a thread
//   (1,024 threads at n = 192) and shared memory set how many problems an
//   SM holds (the occupancy query on an H100: one at 192 and 144, four at
//   96, so R = 1,024 runs in two waves over every SM), and problems in
//   separate blocks do not wait at each other's barriers.
// * K is read once, staged in the shared memory L takes later (the
//   transposed reads of the symmetrization are conflict-free there), and
//   K^-1 written once, both coalesced along rows.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TS = 6;              // rows (and columns) of a thread's tile
constexpr int MAX_G = 32;          // g x g threads, at most 1,024 a block
constexpr int MAX_N = TS * MAX_G;  // 192

__host__ __device__ constexpr int side(int n) { return (n + TS - 1) / TS; }

constexpr size_t smem_floats(int n) {
  return (size_t)n * (n + 1) + 5 * (size_t)n;
}

// 1 / sqrt(d) for a pivot d, NaN where d is not positive or not finite.
__device__ __forceinline__ float pivot_inv(float d) {
  return (d > 0.f && d < INFINITY) ? 1.f / sqrtf(d)
                                   : __int_as_float(0x7fc00000);
}

// The threads that hold row k (ty = k mod g, tile row k / g) scale it by
// 1 / L_kk, keep it and write it to `row`: Y_k. or X_k. is final.
__device__ __forceinline__ void finish_row(float (&a)[TS][TS], float* row,
                                           int ty, int tx, int g, int n,
                                           int own, int blk, float dk) {
  if (ty != own) return;
#pragma unroll
  for (int r = 0; r < TS; ++r) {
    if (r != blk) continue;
#pragma unroll
    for (int s = 0; s < TS; ++s) {
      const int c = tx + g * s;
      if (c < n) {
        const float v = a[r][s] * dk;
        a[r][s] = v;
        row[c] = v;
      }
    }
  }
}

// The broadcast row's values at this thread's columns (0 past n).
__device__ __forceinline__ void read_row(float (&v)[TS], const float* row,
                                         int tx, int g, int n) {
#pragma unroll
  for (int s = 0; s < TS; ++s) {
    const int c = tx + g * s;
    v[s] = c < n ? row[c] : 0.f;
  }
}

__global__ void __launch_bounds__(MAX_G * MAX_G)
kinv_kernel(const float* __restrict__ K_g, float* __restrict__ X_g,
            int* __restrict__ nonpd, int n) {
  extern __shared__ float sm[];
  const int g = side(n), ld = n + 1, nt = g * g;
  float* Ls = sm;                       // L below the diagonal, stride ld
  float* dinv = Ls + (size_t)n * ld;    // 1 / L_jj (NaN: not a pivot)
  float* dg = dinv + n;                 // the factor's running diagonal
  float* dc = dg + n;                   // ... and its rounding error
  float* buf = dc + n;                  // the broadcast column or row, 2 n
  const int tid = threadIdx.x, ty = tid / g, tx = tid % g;
  const size_t nn = (size_t)n * n;
  const float* K = K_g + blockIdx.x * nn;
  float* X = X_g + blockIdx.x * nn;

  // (K + K') / 2, as jnp.linalg.cholesky symmetrizes its input: K is
  // staged in the shared memory that L takes later, then each thread
  // reads its tile at and below the diagonal.
  for (int e = tid; e < n * n; e += nt)
    Ls[(e / n) * ld + e % n] = K[e];
  __syncthreads();
  float a[TS][TS];
#pragma unroll
  for (int r = 0; r < TS; ++r) {
    const int i = ty + g * r;
#pragma unroll
    for (int s = 0; s < TS; ++s) {
      const int c = tx + g * s;
      a[r][s] = (i < n && c <= i)
                    ? (Ls[i * ld + c] + Ls[c * ld + i]) / 2.f : 0.f;
    }
  }

  // K = L L', the diagonal summed apart (see above).
  // Step j: the holders of column j (tx = j mod g, tile column j / g)
  // write its entries below the diagonal; every thread takes 1 / L_jj,
  // L_ij = K_ij / L_jj, and updates K_ic -= L_ij L_cj for i, c > j in its
  // tile (the tile's diagonal and the entries above it are updated too
  // and never read); the threads i - j - 1 (mod g^2) store L_ij for the
  // solves, update K_ii, and the one at i = j + 1 takes the next pivot.
  for (int i = tid; i < n; i += nt) {
    dg[i] = Ls[i * ld + i];
    dc[i] = 0.f;
  }
  if (tid == 0) dinv[0] = pivot_inv(Ls[0]);
  bool bad = false;
  int own = 0, blk = 0;                 // j mod g, j / g
  for (int j = 0; j < n; ++j) {
    float* col = buf + (j & 1) * n;
    if (tx == own) {
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        if (s != blk) continue;
#pragma unroll
        for (int r = 0; r < TS; ++r) {
          const int i = ty + g * r;
          if (i > j && i < n) col[i] = a[r][s];
        }
      }
    }
    __syncthreads();
    const float inv = dinv[j];
    bad |= isnan(inv);
    float lc[TS];
#pragma unroll
    for (int s = 0; s < TS; ++s) {
      const int c = tx + g * s;
      lc[s] = (c > j && c < n) ? col[c] * inv : 0.f;
    }
#pragma unroll
    for (int r = 0; r < TS; ++r) {
      const int i = ty + g * r;
      if (i <= j || i >= n) continue;
      const float li = col[i] * inv;
#pragma unroll
      for (int s = 0; s < TS; ++s) a[r][s] = fmaf(-li, lc[s], a[r][s]);
    }
    for (int i = j + 1 + tid; i < n; i += nt) {
      const float li = col[i] * inv;
      Ls[i * ld + j] = li;
      // K_ii - li^2 = s + e - pe exactly (two-sum and FMA error terms)
      const float p = __fmul_rn(li, li);
      const float pe = fmaf(li, li, -p);
      const float a0 = dg[i];
      const float s = __fsub_rn(a0, p);
      const float bb = __fsub_rn(s, a0);
      const float e = __fsub_rn(__fsub_rn(a0, __fsub_rn(s, bb)),
                                __fadd_rn(p, bb));
      dg[i] = s;
      dc[i] = __fadd_rn(dc[i], __fsub_rn(e, pe));
      if (i == j + 1) dinv[i] = pivot_inv(__fadd_rn(s, dc[i]));
    }
    if (++own == g) { own = 0; ++blk; }
  }

  // L Y = I. R starts as I; step k: Y_kc = R_kc / L_kk, then
  // R_ic -= L_ik Y_kc for i > k.
#pragma unroll
  for (int r = 0; r < TS; ++r) {
    const int i = ty + g * r;
#pragma unroll
    for (int s = 0; s < TS; ++s)
      a[r][s] = (i < n && i == tx + g * s) ? 1.f : 0.f;
  }
  own = 0; blk = 0;                     // k mod g, k / g
  for (int k = 0; k < n; ++k) {
    float* row = buf + ((n + k) & 1) * n;
    finish_row(a, row, ty, tx, g, n, own, blk, dinv[k]);
    __syncthreads();
    float v[TS];
    read_row(v, row, tx, g, n);
#pragma unroll
    for (int r = 0; r < TS; ++r) {
      const int i = ty + g * r;
      if (i <= k || i >= n) continue;
      const float l = Ls[i * ld + k];
#pragma unroll
      for (int s = 0; s < TS; ++s) a[r][s] = fmaf(-l, v[s], a[r][s]);
    }
    if (++own == g) { own = 0; ++blk; }
  }

  // L' X = Y. R starts as Y; step k = n - 1 .. 0: X_kc = R_kc / L_kk,
  // then R_ic -= L_ki X_kc for i < k.
  own = (n - 1) % g; blk = (n - 1) / g;
  for (int k = n - 1; k >= 0; --k) {
    float* row = buf + ((3 * n - 1 - k) & 1) * n;
    finish_row(a, row, ty, tx, g, n, own, blk, dinv[k]);
    __syncthreads();
    float v[TS];
    read_row(v, row, tx, g, n);
#pragma unroll
    for (int r = 0; r < TS; ++r) {
      const int i = ty + g * r;
      if (i >= k) continue;
      const float l = Ls[k * ld + i];
#pragma unroll
      for (int s = 0; s < TS; ++s) a[r][s] = fmaf(-l, v[s], a[r][s]);
    }
    if (--own < 0) { own = g - 1; --blk; }
  }

  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int r = 0; r < TS; ++r) {
    const int i = ty + g * r;
    if (i >= n) continue;
#pragma unroll
    for (int s = 0; s < TS; ++s) {
      const int c = tx + g * s;
      if (c < n) X[(size_t)i * n + c] = bad ? nan : a[r][s];
    }
  }
  if (tid == 0) nonpd[blockIdx.x] = bad ? 1 : 0;
}

}  // namespace

extern "C" {

// Blocks of n x n problems an SM holds at once (the occupancy query), in
// *blocks. Returns a CUDA error code.
int qrw_kinv_blocks_per_sm(int n, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      kinv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * smem_floats(MAX_N)));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kinv_kernel, side(n) * side(n),
      sizeof(float) * smem_floats(n));
}

// K, X (B, n, n) and nonpd (B,) are device pointers. Launches on
// `stream` and returns cudaGetLastError(), or -1 for n or B out of range.
// The shared-memory attribute is set once a device, for the largest n.
int qrw_kinv(const float* K, float* X, int* nonpd, int B, int n,
             void* stream) {
  if (n < 1 || n > MAX_N || B < 1) return -1;
  static bool ready[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return -1;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kinv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(sizeof(float) * smem_floats(MAX_N)));
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  const int g = side(n);
  kinv_kernel<<<B, g * g, sizeof(float) * smem_floats(n),
                (cudaStream_t)stream>>>(K, X, nonpd, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
