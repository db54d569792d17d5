// Fixed-length OSQP ADMM in the original variables, one problem a block.
//
// Replaces the TPU kernel qrw_tpu/ops/qp_pallas.py::_admm_kernel (Pallas,
// launched by qrw_tpu.ops.qp_pallas._run_kernel), with its K_ref
// (iterative refinement) variant. Per problem, with a per-problem
// symmetric K^-1 (n x n), a constraint matrix A (m x n) shared by the
// batch, the diagonal rho' and sigma' and relaxation alpha, exactly
// `n_iters` steps of
//
//   b  = sigma' x - q + A'(rho' z - y)
//   xt = K^-1 b;  [K_ref: twice r = b - K xt; xt = xt + K^-1 r]
//   zt = A xt
//   x  = alpha xt + (1 - alpha) x;  zr = alpha zt + (1 - alpha) z
//   z  = clip(zr + y * (1 / rho'), l, u);  y = y + rho' (zr - z)
//
// from z = A x0, then one residual pass giving the infinity norms
// pri = |A x - z|, dua = |P x + q + A'y|, n1 = max(|A x|, |z|) and
// n2 = max(|P x|, |A'y|). The wrapper (qrw_tpu_torch/ops/qp_pallas.py)
// applies the termination test and the rho adaptation between rounds.
//
// Two variants. The cone variant (qp_admm_cone_kernel) runs whenever the
// caller gives the cone structure of A, as every system path does; the
// dense variant (qp_admm_kernel) takes a general shared A and serves the
// `solve` API with cone=None.
//
// What bounds it on the H100. Given the cone, A is 9 nonzeros a 5 x 3
// block (plus identity rows), so a problem-iteration is one product
// K^-1 b (2n^2 flop, 74 kflop at n = 192) and ~1.3k flop of structured
// A'w, A xt and elementwise passes; K_ref adds two K xt and two K^-1 r
// products. K^-1 and P (and K) are read once a launch: 1.2 GB at
// B = 4096, n = 192 (1.8 GB with K), 0.36 ms at the H100 SXM's published
// 3.35 TB/s, which bounds a 50-iteration round; with K_ref the
// operations (~1.15 ms at its published 67 Tflop/s of float32) bound
// it. The dense variant re-reads the shared A
// from L2 twice an iteration (161 GB a 50-iteration round at B = 4096,
// n = 192, m = 512): it is bound by that traffic and by serial FMA
// chains, and no system path runs it.
//
// What the cone design does about it:
// * A is applied by its structure and read from nowhere: the kernel
//   gets the kind, the block count (n / 3) and mu, and each output takes
//   its nonzero terms in the dense loops' order, so z = A x and A'w are
//   the dense variant's bits on finite inputs.
// * One block of 4n threads per problem; K^-1 stays resident in
//   registers for the whole launch (thread g n + j holds column j of a
//   quarter of the rows: 48 registers at n = 192), so the product is 48
//   FMAs a thread from registers plus a fixed-order sum of four
//   partials, instead of a 192-long chain streamed from shared memory.
// * K_ref keeps K resident in shared memory beside the vectors (147 kB
//   at n = 192): the two refinement products stay on the SM, read
//   conflict-free by columns. r = b - K xt stays the JAX kernel's
//   products-then-reduction form, as partial sums.
// * Barriers only between dependent passes: b, the K^-1 partials, their
//   combination, and the z, y, x updates (four a plain iteration).
//
// The dense design:
// * One block per problem, so any batch works with no padding. The block
//   stages K^-1 in dynamic shared memory once and keeps every vector (x,
//   z, y, l, u, rho', 1/rho', sigma', q, b, xt, w, r) in shared memory
//   too: nothing but the final iterate and the four norms goes back to
//   device memory.
// * Where A fits beside them (the rescue's shape: 36.9 + 62.1 kB), A is
//   staged too, with a padded row stride n + 1: the row-wise products
//   (z = A xt, thread r walks row r) then touch banks (r + j) mod 32, all
//   different within a warp. At the full shape A (393 kB) does not fit
//   beside K^-1 (147 kB); the block reads the shared A from device
//   memory, where it stays in L2 because every block reads the same
//   bytes. The wrapper passes A and a contiguous A', so both products
//   read neighbouring words across a warp: A'w walks A's columns
//   (thread j reads A[r][j]), A xt walks A''s columns (thread r reads
//   A'[j][r]).
// * K_ref: K (B, n, n) cannot join K^-1 in shared memory; the two
//   refinement products read the block's own K from device memory by
//   columns (K symmetric, thread j reads K[i][j]).
// * The column-wise products (A'w, K^-1 b and K xt by symmetry: thread j
//   walks column j) read neighbouring words across a warp.
//
// Both variants keep the exact semantics: l = -inf stays -inf through
// the clip (fmaxf(v, -INFINITY) == v), NaN propagates through the clip
// and the norms as it does in jnp.clip / jnp.max, 1 / rho' is a
// reciprocal computed once and then multiplied, and the kernel runs every
// problem, converged or not: the wrapper keeps the converged flags
// sticky. Float32 FMAs throughout, no TF32, no fast-math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Params {
  int B, n, m, n_iters;
  float alpha;
};

// max that propagates NaN from either side (as jnp.max / torch.amax)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// clip(v, lo, hi) = min(max(v, lo), hi), with NaN passing through
__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  return (v != v) ? v : fminf(fmaxf(v, lo), hi);
}

// NaN-propagating max over the block; `red` holds >= 32 floats. Every
// thread gets the result.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < n_warps; ++w) r = nan_max(r, red[w]);
  return r;
}

template <bool A_SMEM>
__global__ void qp_admm_kernel(Params p, const float* __restrict__ kinv_g,
                               const float* __restrict__ K_g,
                               const float* __restrict__ P_g,
                               const float* __restrict__ A_g,
                               const float* __restrict__ At_g,
                               const float* __restrict__ q_g,
                               const float* __restrict__ l_g,
                               const float* __restrict__ u_g,
                               const float* __restrict__ rho_g,
                               const float* __restrict__ sig_g,
                               const float* __restrict__ x0_g,
                               const float* __restrict__ y0_g,
                               float* __restrict__ X, float* __restrict__ Y,
                               float* __restrict__ Z,
                               float* __restrict__ res) {
  extern __shared__ float smem[];
  const int n = p.n, m = p.m, lda = n + 1;
  float* Ki = smem;              // n * n, K^-1 (symmetric)
  float* As = Ki + n * n;        // m * lda when staged: A, padded stride
  float* xs = As + (A_SMEM ? m * lda : 0);  // n
  float* qs = xs + n;            // n
  float* ss = qs + n;            // n, sigma'
  float* bs = ss + n;            // n, right-hand side b
  float* xt = bs + n;            // n
  float* rr = xt + n;            // n, refinement residual b - K xt
  float* zs = rr + n;            // m
  float* ys = zs + m;            // m
  float* ls = ys + m;            // m
  float* us = ls + m;            // m
  float* rs = us + m;            // m, rho'
  float* ri = rs + m;            // m, 1 / rho'
  float* ws = ri + m;            // m, rho' z - y
  float* red = ws + m;           // 32, block reductions

  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float alpha = p.alpha, beta = 1.0f - p.alpha;

  // (A v)_r and (A' w)_j, from shared memory or device memory
  auto arow = [&](int r, const float* v) {
    float acc = 0.f;
    if constexpr (A_SMEM) {
      const float* a = As + r * lda;
      for (int j = 0; j < n; ++j) acc += a[j] * v[j];
    } else {
      const float* a = At_g + r;
      for (int j = 0; j < n; ++j) acc += a[(size_t)j * m] * v[j];
    }
    return acc;
  };
  auto acol = [&](int j, const float* w) {
    float acc = 0.f;
    if constexpr (A_SMEM) {
      for (int r = 0; r < m; ++r) acc += As[r * lda + j] * w[r];
    } else {
      const float* a = A_g + j;
      for (int r = 0; r < m; ++r) acc += a[(size_t)r * n] * w[r];
    }
    return acc;
  };

  const float* kinv = kinv_g + b * n * n;
  for (int i = tid; i < n * n; i += nt) Ki[i] = kinv[i];
  if constexpr (A_SMEM) {
    for (int i = tid; i < m * n; i += nt) {
      const int r = i / n, c = i - r * n;
      As[r * lda + c] = A_g[i];
    }
  }
  for (int j = tid; j < n; j += nt) {
    xs[j] = x0_g[b * n + j];
    qs[j] = q_g[b * n + j];
    ss[j] = sig_g[b * n + j];
  }
  for (int r = tid; r < m; r += nt) {
    ys[r] = y0_g[b * m + r];
    ls[r] = l_g[b * m + r];
    us[r] = u_g[b * m + r];
    rs[r] = rho_g[b * m + r];
    ri[r] = 1.0f / rs[r];
  }
  __syncthreads();

  for (int r = tid; r < m; r += nt) zs[r] = arow(r, xs);   // z = A x0
  __syncthreads();

  const float* Kb = K_g ? K_g + b * n * n : nullptr;
  for (int it = 0; it < p.n_iters; ++it) {
    for (int r = tid; r < m; r += nt) ws[r] = rs[r] * zs[r] - ys[r];
    __syncthreads();
    for (int j = tid; j < n; j += nt)          // b = sigma' x - q + A'w
      bs[j] = (ss[j] * xs[j] - qs[j]) + acol(j, ws);
    __syncthreads();
    for (int j = tid; j < n; j += nt) {        // xt = K^-1 b, column j
      float acc = 0.f;
      for (int i = 0; i < n; ++i) acc += Ki[i * n + j] * bs[i];
      xt[j] = acc;
    }
    if (Kb) {                                  // K_ref: two refinements
      for (int s = 0; s < 2; ++s) {
        __syncthreads();
        for (int j = tid; j < n; j += nt) {    // r = b - K xt, column j
          float acc = 0.f;
          for (int i = 0; i < n; ++i) acc += Kb[(size_t)i * n + j] * xt[i];
          rr[j] = bs[j] - acc;
        }
        __syncthreads();
        for (int j = tid; j < n; j += nt) {    // xt = xt + K^-1 r
          float acc = 0.f;
          for (int i = 0; i < n; ++i) acc += Ki[i * n + j] * rr[i];
          xt[j] = xt[j] + acc;
        }
      }
    }
    __syncthreads();
    for (int r = tid; r < m; r += nt) {        // zt = A xt; z, y updates
      const float zr = alpha * arow(r, xt) + beta * zs[r];
      const float y = ys[r];
      const float zn = clip_nan(zr + y * ri[r], ls[r], us[r]);
      ys[r] = y + rs[r] * (zr - zn);
      zs[r] = zn;
    }
    for (int j = tid; j < n; j += nt) xs[j] = alpha * xt[j] + beta * xs[j];
    __syncthreads();
  }

  // residual pass: A x and its norms (rows), P x and A'y (columns)
  float pri = 0.f, nax = 0.f, nz = 0.f;
  for (int r = tid; r < m; r += nt) {
    const float acc = arow(r, xs);
    pri = nan_max(pri, fabsf(acc - zs[r]));
    nax = nan_max(nax, fabsf(acc));
    nz = nan_max(nz, fabsf(zs[r]));
    Y[b * m + r] = ys[r];
    Z[b * m + r] = zs[r];
  }
  float dua = 0.f, npx = 0.f, naty = 0.f;
  const float* P = P_g + b * n * n;
  for (int j = tid; j < n; j += nt) {
    const float aty = acol(j, ys);
    float px = 0.f;
    for (int i = 0; i < n; ++i) px += P[(size_t)i * n + j] * xs[i];
    dua = nan_max(dua, fabsf((px + qs[j]) + aty));
    npx = nan_max(npx, fabsf(px));
    naty = nan_max(naty, fabsf(aty));
    X[b * n + j] = xs[j];
  }
  pri = block_max(pri, red);
  dua = block_max(dua, red);
  const float n1 = nan_max(block_max(nax, red), block_max(nz, red));
  const float n2 = nan_max(block_max(npx, red), block_max(naty, red));
  if (tid == 0) {
    res[b] = pri;
    res[p.B + b] = dua;
    res[2 * (size_t)p.B + b] = n1;
    res[3 * (size_t)p.B + b] = n2;
  }
}

size_t smem_bytes(int n, int m, bool stage_A) {
  const size_t nn = n, mm = m;
  return sizeof(float) *
         (nn * nn + (stage_A ? mm * (nn + 1) : 0) + 6 * nn + 7 * mm + 32);
}

int max_smem_bytes() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

// A is staged in shared memory where it fits beside K^-1 and the vectors
bool stages_A(int n, int m) {
  return smem_bytes(n, m, true) <= (size_t)max_smem_bytes();
}

int block_threads(int n, int m) {
  const int w = n > m ? n : m;
  const int t = ((w + 31) / 32) * 32;
  return t > 1024 ? 1024 : t;
}

template <bool A_SMEM>
int launch(const Params& p, size_t smem, cudaStream_t stream,
           const float* kinv, const float* K, const float* P, const float* A,
           const float* At, const float* q, const float* l, const float* u,
           const float* rho, const float* sig, const float* x0,
           const float* y0, float* x, float* y, float* z, float* res) {
  cudaError_t e = cudaFuncSetAttribute(
      qp_admm_kernel<A_SMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  qp_admm_kernel<A_SMEM><<<p.B, block_threads(p.n, p.m), smem, stream>>>(
      p, kinv, K, P, A, At, q, l, u, rho, sig, x0, y0, x, y, z, res);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------
// The cone variant: A applied by its structure
// --------------------------------------------------------------------
//
// A = [I_nb (x) C; I_n] (FULL, ConeStructure: nb = 4N friction blocks
// over the 12N activation identity rows) or A = I_nb (x) C
// (ReducedConeStructure), nb = n / 3, C the 5 x 3 pyramid
// [1 0 -mu; -1 0 -mu; 0 1 -mu; 0 -1 -mu; 0 0 -1]. Each output takes its
// nonzero terms as FMAs from 0 in increasing index order, as the dense
// loops above take every term: fma(0, v, acc) == acc on finite v and the
// accumulator is never -0, so z = A x and A'w are the dense kernel's
// bits.

// (A v)_r; cm = -mu as the float32 entry of A
template <int N, bool FULL>
__device__ __forceinline__ float cone_row(int r, const float* v, float cm) {
  constexpr int MF = 5 * (N / 3);  // friction rows
  float acc = 0.f;
  if (FULL && r >= MF) return fmaf(1.f, v[r - MF], acc);
  const int b = r / 5, t = r - 5 * b;
  const float* vb = v + 3 * b;
  switch (t) {
    case 0: acc = fmaf(1.f, vb[0], acc); return fmaf(cm, vb[2], acc);
    case 1: acc = fmaf(-1.f, vb[0], acc); return fmaf(cm, vb[2], acc);
    case 2: acc = fmaf(1.f, vb[1], acc); return fmaf(cm, vb[2], acc);
    case 3: acc = fmaf(-1.f, vb[1], acc); return fmaf(cm, vb[2], acc);
    default: return fmaf(-1.f, vb[2], acc);
  }
}

// (A' w)_j with w(r) the r-th entry of w: the column's five friction
// rows, then (FULL) its identity row
template <int N, bool FULL, class W>
__device__ __forceinline__ float cone_col(int j, W w, float cm) {
  constexpr int MF = 5 * (N / 3);
  const int b = j / 3, c = j - 3 * b, r0 = 5 * b;
  float acc = 0.f;
  if (c == 0) {
    acc = fmaf(1.f, w(r0), acc);
    acc = fmaf(-1.f, w(r0 + 1), acc);
  } else if (c == 1) {
    acc = fmaf(1.f, w(r0 + 2), acc);
    acc = fmaf(-1.f, w(r0 + 3), acc);
  } else {
    acc = fmaf(cm, w(r0), acc);
    acc = fmaf(cm, w(r0 + 1), acc);
    acc = fmaf(cm, w(r0 + 2), acc);
    acc = fmaf(cm, w(r0 + 3), acc);
    acc = fmaf(-1.f, w(r0 + 4), acc);
  }
  if (FULL) acc = fmaf(1.f, w(MF + j), acc);
  return acc;
}

// One block of 4N threads per problem. Thread t = g N + j holds the
// column-j entries of rows [g R, g R + R) of K^-1 (R = N / 4) in
// registers for the whole launch; a product K^-1 v is then R FMAs a
// thread from registers, four partial sums a column combined in a fixed
// order ((p0 + p1) + p2) + p3. With KREF, K sits in shared memory
// (n x n, conflict-free: lane j reads column j) and the two refinement
// products r = b - K xt take the same partial-sum form.
template <int N, bool FULL, bool KREF>
__global__ void __launch_bounds__(4 * N, 1)
qp_admm_cone_kernel(Params p, float mu, const float* __restrict__ kinv_g,
                    const float* __restrict__ K_g,
                    const float* __restrict__ P_g,
                    const float* __restrict__ q_g,
                    const float* __restrict__ l_g,
                    const float* __restrict__ u_g,
                    const float* __restrict__ rho_g,
                    const float* __restrict__ sig_g,
                    const float* __restrict__ x0_g,
                    const float* __restrict__ y0_g,
                    float* __restrict__ X, float* __restrict__ Y,
                    float* __restrict__ Z, float* __restrict__ res) {
  constexpr int n = N, m = FULL ? 8 * N / 3 : 5 * N / 3, R = N / 4;
  constexpr int T = 4 * N;
  extern __shared__ float smem[];
  float* Ks = smem;                     // n * n with KREF
  float* xs = Ks + (KREF ? n * n : 0);  // n
  float* qs = xs + n;                   // n
  float* ss = qs + n;                   // n, sigma'
  float* bs = ss + n;                   // n, right-hand side b
  float* xt = bs + n;                   // n
  float* rr = xt + n;                   // n, refinement residual
  float* part = rr + n;                 // 4n, partial sums
  float* zs = part + 4 * n;             // m
  float* ys = zs + m;                   // m
  float* ls = ys + m;                   // m
  float* us = ls + m;                   // m
  float* rs = us + m;                   // m, rho'
  float* ri = rs + m;                   // m, 1 / rho'
  float* red = ri + m;                  // 32, block reductions

  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, g = tid / n, j = tid - g * n;
  const float alpha = p.alpha, beta = 1.0f - p.alpha, cm = -mu;

  float kr[R];
  const float* kinv = kinv_g + b * n * n + (size_t)g * R * n + j;
#pragma unroll
  for (int k = 0; k < R; ++k) kr[k] = kinv[(size_t)k * n];
  if constexpr (KREF) {
    const float4* K4 = reinterpret_cast<const float4*>(K_g + b * n * n);
    float4* Ks4 = reinterpret_cast<float4*>(Ks);
    for (int i = tid; i < n * n / 4; i += T) Ks4[i] = K4[i];
  }
  for (int i = tid; i < n; i += T) {
    xs[i] = x0_g[b * n + i];
    qs[i] = q_g[b * n + i];
    ss[i] = sig_g[b * n + i];
  }
  for (int r = tid; r < m; r += T) {
    ys[r] = y0_g[b * m + r];
    ls[r] = l_g[b * m + r];
    us[r] = u_g[b * m + r];
    rs[r] = rho_g[b * m + r];
    ri[r] = 1.0f / rs[r];
  }
  __syncthreads();
  for (int r = tid; r < m; r += T) zs[r] = cone_row<N, FULL>(r, xs, cm);
  __syncthreads();

  // part[t] = this thread's share of (M v)_j over rows [g R, g R + R)
  auto kinv_part = [&](const float* v) {
    const float* vg = v + g * R;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < R; ++k) acc += kr[k] * vg[k];
    part[tid] = acc;
  };
  auto comb = [&]() {
    return ((part[j] + part[n + j]) + part[2 * n + j]) + part[3 * n + j];
  };
  auto w_of = [&](int r) { return rs[r] * zs[r] - ys[r]; };
  auto y_of = [&](int r) { return ys[r]; };

  for (int it = 0; it < p.n_iters; ++it) {
    if (tid < n)                               // b = sigma' x - q + A'w
      bs[j] = (ss[j] * xs[j] - qs[j]) + cone_col<N, FULL>(j, w_of, cm);
    __syncthreads();
    kinv_part(bs);                             // xt = K^-1 b
    __syncthreads();
    if (tid < n) xt[j] = comb();
    __syncthreads();
    if constexpr (KREF) {                      // two refinements
      for (int s = 0; s < 2; ++s) {
        {                                      // r = b - K xt
          const float* kc = Ks + (size_t)g * R * n + j;
          const float* vg = xt + g * R;
          float acc = 0.f;
#pragma unroll 8
          for (int k = 0; k < R; ++k) acc += kc[k * n] * vg[k];
          part[tid] = acc;
        }
        __syncthreads();
        if (tid < n) rr[j] = bs[j] - comb();
        __syncthreads();
        kinv_part(rr);                         // xt = xt + K^-1 r
        __syncthreads();
        if (tid < n) xt[j] = xt[j] + comb();
        __syncthreads();
      }
    }
    for (int r = tid; r < m; r += T) {         // zt = A xt; z, y updates
      const float zr = alpha * cone_row<N, FULL>(r, xt, cm) + beta * zs[r];
      const float y = ys[r];
      const float zn = clip_nan(zr + y * ri[r], ls[r], us[r]);
      ys[r] = y + rs[r] * (zr - zn);
      zs[r] = zn;
    }
    if (tid < n) xs[j] = alpha * xt[j] + beta * xs[j];
    __syncthreads();
  }

  // residual pass: A x and its norms (rows), P x and A'y (columns)
  float pri = 0.f, nax = 0.f, nz = 0.f;
  for (int r = tid; r < m; r += T) {
    const float acc = cone_row<N, FULL>(r, xs, cm);
    pri = nan_max(pri, fabsf(acc - zs[r]));
    nax = nan_max(nax, fabsf(acc));
    nz = nan_max(nz, fabsf(zs[r]));
    Y[b * m + r] = ys[r];
    Z[b * m + r] = zs[r];
  }
  {
    const float* Pc = P_g + b * n * n + (size_t)g * R * n + j;
    const float* vg = xs + g * R;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < R; ++k) acc += Pc[(size_t)k * n] * vg[k];
    part[tid] = acc;
  }
  __syncthreads();
  float dua = 0.f, npx = 0.f, naty = 0.f;
  if (tid < n) {
    const float aty = cone_col<N, FULL>(j, y_of, cm);
    const float px = comb();
    dua = nan_max(dua, fabsf((px + qs[j]) + aty));
    npx = nan_max(npx, fabsf(px));
    naty = nan_max(naty, fabsf(aty));
    X[b * n + j] = xs[j];
  }
  pri = block_max(pri, red);
  dua = block_max(dua, red);
  const float n1 = nan_max(block_max(nax, red), block_max(nz, red));
  const float n2 = nan_max(block_max(npx, red), block_max(naty, red));
  if (tid == 0) {
    res[b] = pri;
    res[p.B + b] = dua;
    res[2 * (size_t)p.B + b] = n1;
    res[3 * (size_t)p.B + b] = n2;
  }
}

constexpr size_t cone_smem_floats(int n, int m, bool kref) {
  return (kref ? (size_t)n * n : 0) + 10 * (size_t)n + 6 * (size_t)m + 32;
}

template <int N, bool FULL, bool KREF>
int launch_cone(const Params& p, float mu, cudaStream_t stream,
                const float* kinv, const float* K, const float* P,
                const float* q, const float* l, const float* u,
                const float* rho, const float* sig, const float* x0,
                const float* y0, float* x, float* y, float* z, float* res) {
  constexpr int m = FULL ? 8 * N / 3 : 5 * N / 3;
  const size_t smem = sizeof(float) * cone_smem_floats(N, m, KREF);
  cudaError_t e = cudaFuncSetAttribute(
      qp_admm_cone_kernel<N, FULL, KREF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  qp_admm_cone_kernel<N, FULL, KREF><<<p.B, 4 * N, smem, stream>>>(
      p, mu, kinv, K, P, q, l, u, rho, sig, x0, y0, x, y, z, res);
  return (int)cudaGetLastError();
}

// kind 1: [I (x) C; I] (ConeStructure); kind 2: I (x) C
// (ReducedConeStructure). Returns true where a cone kernel is compiled
// for (kind, n, m): both kinds at n = 96 and 192; the reduced cone also
// at n = 144 (cap 48, the rescue of a fleet whose phase set holds walk:
// 576 threads a block, 36 K^-1 registers a thread).
bool cone_shape(int kind, int n, int m) {
  if (kind == 1) return (n == 96 || n == 192) && m == 8 * n / 3;
  if (kind == 2) return (n == 96 || n == 144 || n == 192) && m == 5 * n / 3;
  return false;
}

}  // namespace

extern "C" {

// 1 if the kernel stages A in shared memory at this shape (then At is not
// read), 0 if it reads A and At from device memory
int qrw_qp_admm_stages_A(int n, int m) { return stages_A(n, m) ? 1 : 0; }

// dynamic shared memory of a block at this shape
int qrw_qp_admm_smem_bytes(int n, int m) {
  return (int)smem_bytes(n, m, stages_A(n, m));
}

int qrw_qp_admm_max_smem_bytes() { return max_smem_bytes(); }

// All pointers are device pointers: Kinv, K, P (B, n, n); A (m, n); At
// (n, m), A transposed, read only where A is not staged; q, sig, x0, x
// (B, n); l, u, rho, y0, y, z (B, m); res (4, B) rows pri, dua, n1, n2.
// K may be NULL: no refinement. Launches on `stream` and returns
// cudaGetLastError().
int qrw_qp_admm_solve(const float* kinv, const float* K, const float* P,
                      const float* A, const float* At, const float* q,
                      const float* l, const float* u, const float* rho,
                      const float* sig, const float* x0, const float* y0,
                      float* x, float* y, float* z, float* res, int B, int n,
                      int m, int n_iters, float alpha, void* stream) {
  Params p;
  p.B = B; p.n = n; p.m = m; p.n_iters = n_iters; p.alpha = alpha;
  const bool stage = stages_A(n, m);
  const size_t smem = smem_bytes(n, m, stage);
  cudaStream_t s = (cudaStream_t)stream;
  return stage ? launch<true>(p, smem, s, kinv, K, P, A, At, q, l, u, rho,
                              sig, x0, y0, x, y, z, res)
               : launch<false>(p, smem, s, kinv, K, P, A, At, q, l, u, rho,
                               sig, x0, y0, x, y, z, res);
}

// The cone variant's dynamic shared memory a block, or -1 where no cone
// kernel is compiled for (kind, n, m); K_ref adds K itself.
int qrw_qp_admm_cone_smem_bytes(int kind, int n, int m, int k_ref) {
  if (!cone_shape(kind, n, m)) return -1;
  return (int)(sizeof(float) * cone_smem_floats(n, m, k_ref != 0));
}

// The cone variant: A is not passed; `kind` (1: [I (x) C; I], 2:
// I (x) C) with nb = n / 3 blocks and mu describe it. Other arguments as
// qrw_qp_admm_solve. Returns cudaGetLastError(), or -1 where no cone
// kernel is compiled for (kind, n, m).
int qrw_qp_admm_cone_solve(int kind, float mu, const float* kinv,
                           const float* K, const float* P, const float* q,
                           const float* l, const float* u, const float* rho,
                           const float* sig, const float* x0,
                           const float* y0, float* x, float* y, float* z,
                           float* res, int B, int n, int m, int n_iters,
                           float alpha, void* stream) {
  if (!cone_shape(kind, n, m)) return -1;
  Params p;
  p.B = B; p.n = n; p.m = m; p.n_iters = n_iters; p.alpha = alpha;
  cudaStream_t s = (cudaStream_t)stream;
#define QRW_CONE(N, FULL, KREF)                                              \
  launch_cone<N, FULL, KREF>(p, mu, s, kinv, K, P, q, l, u, rho, sig, x0, y0, \
                             x, y, z, res)
  const bool full = kind == 1, kref = K != nullptr;
  if (n == 96) {
    if (full) return kref ? QRW_CONE(96, true, true) : QRW_CONE(96, true, false);
    return kref ? QRW_CONE(96, false, true) : QRW_CONE(96, false, false);
  }
  if (n == 144)
    return kref ? QRW_CONE(144, false, true) : QRW_CONE(144, false, false);
  if (full) return kref ? QRW_CONE(192, true, true) : QRW_CONE(192, true, false);
  return kref ? QRW_CONE(192, false, true) : QRW_CONE(192, false, false);
#undef QRW_CONE
}

}  // extern "C"
