// Phase-grouped, matrix-free prox-ADMM of the support-reduced MPC QP.
//
// Replaces the TPU kernel qrw_tpu/ops/qp_phase.py::_kernel (Pallas,
// launched by qrw_tpu.ops.qp_phase.solve). Same arithmetic, per problem:
//
//   w  = rho (A x - z) + y
//   x+ = clip(x - Kbar_p^-1 (H_b x + q + A'w), +-100)        (alpha = 1)
//   z+ = clip(A x+ + y / rho, l, u);  y+ = clip(y + rho (A x+ - z+), +-1e4)
//
// with H_b x matrix-free (torque slabs of the per-slot input blocks and
// the phase Gram matrices G1, G2), A x / A'y applied structurally
// (5x3 friction pyramid per stance slot), the general alpha branch, and
// every `check_every` iterations the OSQP unscaled termination test per
// problem, which records the first passing iteration (`it_conv`) and,
// with stop_at_eps, ends a tile once all of its problems pass.
//
// What bounds it on the H100: not bandwidth. Per solve the bench's own
// model (bench.py:310-335) counts ~15.2 Mflop against ~12.8 kB of
// per-problem data, ~1200 flop/byte, far right of the card's ridge
// point. Each iteration is a chain of ~6 dependent steps (cone product,
// slab products, Gram product, metric step, projections), so the solve
// is latency-bound: 300 iterations of a dependent chain per problem.
//
// What this first design does about it:
// * One block per tile of `tile` problems (the unit of the stop_at_eps
//   exit, as in the JAX kernel), one thread per problem. The block reads
//   phases_of[tile] itself and stages that phase's Kbar^-1 (n x n), G1,
//   G2 and the bounds l, u in shared memory once; every thread then
//   reads the same shared word at the same time (broadcast, no bank
//   conflicts). No per-tile copies of the phase blocks exist.
// * The two per-problem vectors that the dense products consume (the
//   slab products psf, 6cap, and the gradient g, 3cap) live in shared
//   memory in lane-major order [row][thread], so the loops over them
//   are conflict-free. At cap = 32, tile = 128 the block uses
//   ~190 KB of the 227 KB a block can have.
// * The iterates x, y, z and A x stay in device memory in the JAX
//   layout (row-major over lanes): neighbouring threads touch
//   neighbouring addresses, and the working set (~3.8 kB a problem)
//   stays in L1/L2.
// * Exact semantics: l is -inf on four of every five rows and
//   fmaxf(v, -INFINITY) == v; y / rho is a true division; the
//   termination test divides the cost scaling back out as the JAX
//   wrapper does.
// At B = 1024 this is 8 blocks on 132 SMs: correct and simple first.
// Filling the card (several threads per problem, tensor-core products
// for the Kbar^-1 g step) is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float X_CLIP = 100.0f;
constexpr float Y_CLIP = 1.0e4f;

struct Params {
  float wtop[6];
  float wbot[6];
  float rho, alpha, mu, dt2, dt_m, w_force, ci, eps_abs, eps_rel;
  int B, cap, tile, n_iters, check_every, stop_at_eps, n_phases;
};

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Lane-major accessors: element (row, col) of an (rows, B) array.
#define AT(ptr, row) (ptr)[(size_t)(row) * p.B + col]
// Torque slab i, slot s, component a: BlS_tor[(i, s, a), col].
#define SLAB(i, s, a) blst[((size_t)(((i) * p.cap + (s)) * 3 + (a))) * p.B + col]

// psf[s][k] for this thread's problem: k < 3 the constant force rows
// (dt/m x_s), k >= 3 the torque-row inner products.
__device__ void slab_products(const Params& p, int col, int tid,
                              const float* X,
                              const float* __restrict__ blst, float* psf) {
  for (int s = 0; s < p.cap; ++s) {
    const float x0 = AT(X, 3 * s), x1 = AT(X, 3 * s + 1),
                x2 = AT(X, 3 * s + 2);
    psf[(s * 6 + 0) * p.tile + tid] = p.dt_m * x0;
    psf[(s * 6 + 1) * p.tile + tid] = p.dt_m * x1;
    psf[(s * 6 + 2) * p.tile + tid] = p.dt_m * x2;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      psf[(s * 6 + 3 + a) * p.tile + tid] =
          SLAB(0, s, a) * x0 + SLAB(1, s, a) * x1 + SLAB(2, s, a) * x2;
    }
  }
}

// (H_b x) for slot s, rows 3s..3s+2, given psf of x.
__device__ void hx_slot(const Params& p, int col, int tid, int s,
                        const float* X,
                        const float* __restrict__ blst, const float* G1,
                        const float* G2, const float* psf, float out[3]) {
  float v1[6], v2[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) { v1[k] = 0.f; v2[k] = 0.f; }
  for (int c = 0; c < p.cap; ++c) {
    const float g1 = G1[s * p.cap + c], g2 = G2[s * p.cap + c];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float ps = psf[(c * 6 + k) * p.tile + tid];
      v1[k] += g1 * ps;
      v2[k] += g2 * ps;
    }
  }
  float vS[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) vS[k] = v1[k] * p.dt2 * p.wtop[k] + v2[k] * p.wbot[k];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float t = SLAB(i, s, 0) * vS[3] + SLAB(i, s, 1) * vS[4] +
                    SLAB(i, s, 2) * vS[5];
    out[i] = (p.dt_m * vS[i] + t) + p.w_force * AT(X, 3 * s + i);
  }
}

__device__ __forceinline__ void cone5(float fx, float fy, float fz, float mu,
                                      float o[5]) {
  const float mfz = mu * fz;
  o[0] = fx - mfz; o[1] = -fx - mfz; o[2] = fy - mfz; o[3] = -fy - mfz;
  o[4] = -fz;
}

__device__ __forceinline__ void cone5_t(const float w[5], float mu,
                                        float g[3]) {
  g[0] = w[0] - w[1];
  g[1] = w[2] - w[3];
  g[2] = -mu * (((w[0] + w[1]) + w[2]) + w[3]) - w[4];
}

// Residual norms (pri, dua, n1, n2) of this thread's problem.
__device__ void residuals(const Params& p, int col, int tid,
                          const float* X,
                          const float* Z,
                          const float* Y,
                          const float* AX,
                          const float* __restrict__ Q,
                          const float* __restrict__ blst, const float* G1,
                          const float* G2, float* psf, float r[4]) {
  slab_products(p, col, tid, X, blst, psf);
  float pri = 0.f, dua = 0.f, nax = 0.f, nz = 0.f, nhx = 0.f, naty = 0.f;
  for (int s = 0; s < p.cap; ++s) {
    float hx[3], yv[5], aty[3];
    hx_slot(p, col, tid, s, X, blst, G1, G2, psf, hx);
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const float ax = AT(AX, 5 * s + j), zz = AT(Z, 5 * s + j);
      yv[j] = AT(Y, 5 * s + j);
      pri = fmaxf(pri, fabsf(ax - zz));
      nax = fmaxf(nax, fabsf(ax));
      nz = fmaxf(nz, fabsf(zz));
    }
    cone5_t(yv, p.mu, aty);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      dua = fmaxf(dua, fabsf((hx[i] + AT(Q, 3 * s + i)) + aty[i]));
      nhx = fmaxf(nhx, fabsf(hx[i]));
      naty = fmaxf(naty, fabsf(aty[i]));
    }
  }
  r[0] = pri; r[1] = dua; r[2] = fmaxf(nax, nz); r[3] = fmaxf(nhx, naty);
}

__global__ void qp_phase_kernel(Params p, const float* __restrict__ Q,
                                const float* __restrict__ blst,
                                const float* __restrict__ X0,
                                const float* __restrict__ Y0,
                                const float* __restrict__ kinv_all,
                                const float* __restrict__ g1_all,
                                const float* __restrict__ g2_all,
                                const int* __restrict__ phases_of,
                                const float* __restrict__ lo_g,
                                const float* __restrict__ hi_g,
                                float* __restrict__ X, float* __restrict__ Y,
                                float* __restrict__ Z, float* __restrict__ AX,
                                float* __restrict__ res) {
  extern __shared__ float smem[];
  const int cap = p.cap, n = 3 * cap, m = 5 * cap;
  float* K = smem;                  // n * n
  float* G1 = K + n * n;            // cap * cap
  float* G2 = G1 + cap * cap;       // cap * cap
  float* lo = G2 + cap * cap;       // m
  float* hi = lo + m;               // m
  float* psf = hi + m;              // 6cap * tile
  float* gs = psf + 6 * cap * p.tile;  // n * tile

  const int tid = threadIdx.x;
  const int col = blockIdx.x * p.tile + tid;
  const int ph = phases_of[blockIdx.x];
  if (ph < 0 || ph >= p.n_phases) __trap();  // a phase id out of range
  const float* kinv = kinv_all + (size_t)ph * n * n;
  for (int i = tid; i < n * n; i += blockDim.x) K[i] = kinv[i];
  for (int i = tid; i < cap * cap; i += blockDim.x) {
    G1[i] = g1_all[(size_t)ph * cap * cap + i];
    G2[i] = g2_all[(size_t)ph * cap * cap + i];
  }
  for (int i = tid; i < m; i += blockDim.x) { lo[i] = lo_g[i]; hi[i] = hi_g[i]; }

  // x = x0, y = y0, A x, z = A x
  float nrm_q = 0.f;
  for (int s = 0; s < cap; ++s) {
    float c5[5];
    const float x0 = X0[(size_t)(3 * s) * p.B + col];
    const float x1 = X0[(size_t)(3 * s + 1) * p.B + col];
    const float x2 = X0[(size_t)(3 * s + 2) * p.B + col];
    AT(X, 3 * s) = x0; AT(X, 3 * s + 1) = x1; AT(X, 3 * s + 2) = x2;
    cone5(x0, x1, x2, p.mu, c5);
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      AT(AX, 5 * s + j) = c5[j];
      AT(Z, 5 * s + j) = c5[j];
      AT(Y, 5 * s + j) = Y0[(size_t)(5 * s + j) * p.B + col];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) nrm_q = fmaxf(nrm_q, fabsf(AT(Q, 3 * s + i)));
  }
  nrm_q *= p.ci;
  __syncthreads();

  float it_conv = (float)p.n_iters;
  const int n_chunks = (p.n_iters + p.check_every - 1) / p.check_every;
  for (int c = 0; c < n_chunks; ++c) {
    const int hi_it = min((c + 1) * p.check_every, p.n_iters);
    for (int it = c * p.check_every; it < hi_it; ++it) {
      // g = (H_b x + q) + A'(rho (A x - z) + y), into shared memory
      slab_products(p, col, tid, X, blst, psf);
      for (int s = 0; s < cap; ++s) {
        float hx[3], w[5], atw[3];
        hx_slot(p, col, tid, s, X, blst, G1, G2, psf, hx);
#pragma unroll
        for (int j = 0; j < 5; ++j)
          w[j] = p.rho * (AT(AX, 5 * s + j) - AT(Z, 5 * s + j)) +
                 AT(Y, 5 * s + j);
        cone5_t(w, p.mu, atw);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          gs[(3 * s + i) * p.tile + tid] = (hx[i] + AT(Q, 3 * s + i)) + atw[i];
      }
      // x+ = x - Kbar^-1 g, then the cone projection, slot by slot
      for (int s = 0; s < cap; ++s) {
        float xt[3], xo[3], xn[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float* Krow = K + (3 * s + i) * n;
          float acc = 0.f;
#pragma unroll 8
          for (int j = 0; j < n; ++j) acc += Krow[j] * gs[j * p.tile + tid];
          xo[i] = AT(X, 3 * s + i);
          xt[i] = xo[i] - acc;
        }
        float axn[5], zr[5];
        if (p.alpha == 1.0f) {
#pragma unroll
          for (int i = 0; i < 3; ++i) xn[i] = clipf(xt[i], -X_CLIP, X_CLIP);
          cone5(xn[0], xn[1], xn[2], p.mu, axn);
#pragma unroll
          for (int j = 0; j < 5; ++j) zr[j] = axn[j];
        } else {
#pragma unroll
          for (int i = 0; i < 3; ++i)
            xn[i] = clipf(p.alpha * xt[i] + (1.0f - p.alpha) * xo[i],
                          -X_CLIP, X_CLIP);
          float zt[5];
          cone5(xt[0], xt[1], xt[2], p.mu, zt);
#pragma unroll
          for (int j = 0; j < 5; ++j)
            zr[j] = p.alpha * zt[j] + (1.0f - p.alpha) * AT(Z, 5 * s + j);
          cone5(xn[0], xn[1], xn[2], p.mu, axn);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) AT(X, 3 * s + i) = xn[i];
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          const int r = 5 * s + j;
          const float yo = AT(Y, r);
          const float zn = clipf(zr[j] + yo / p.rho, lo[r], hi[r]);
          AT(Z, r) = zn;
          AT(Y, r) = clipf(yo + p.rho * (zr[j] - zn), -Y_CLIP, Y_CLIP);
          AT(AX, r) = axn[j];
        }
      }
    }
    float r[4];
    residuals(p, col, tid, X, Z, Y, AX, Q, blst, G1, G2, psf, r);
    const float eps_p = p.eps_abs + p.eps_rel * r[2];
    const float eps_d = p.eps_abs + p.eps_rel * fmaxf(r[3] * p.ci, nrm_q);
    const bool cv = (r[0] <= eps_p) && (r[1] * p.ci <= eps_d);
    it_conv = fminf(it_conv, cv ? (float)hi_it : (float)p.n_iters);
    if (p.stop_at_eps) {
      if (__syncthreads_and(cv)) break;
    }
  }
  float r[4];
  residuals(p, col, tid, X, Z, Y, AX, Q, blst, G1, G2, psf, r);
  AT(res, 0) = r[0];
  AT(res, 1) = r[1];
  AT(res, 2) = r[2];
  AT(res, 3) = r[3];
  AT(res, 4) = it_conv;
}

#undef AT
#undef SLAB

size_t smem_bytes(int cap, int tile) {
  const size_t n = 3 * (size_t)cap, m = 5 * (size_t)cap;
  return sizeof(float) *
         (n * n + 2 * (size_t)cap * cap + 2 * m + 9 * (size_t)cap * tile);
}

}  // namespace

extern "C" {

int qrw_qp_phase_smem_bytes(int cap, int tile) {
  return (int)smem_bytes(cap, tile);
}

int qrw_qp_phase_max_smem_bytes() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

// Pointers are device pointers except w12 (host, 12 floats: wtop then
// wbot). Launches on `stream` and returns cudaGetLastError().
int qrw_qp_phase_solve(const float* q, const float* blst, const float* x0,
                       const float* y0, const float* kinv, const float* g1,
                       const float* g2, const int* phases_of, const float* lo,
                       const float* hi, float* x, float* y, float* z,
                       float* ax, float* res, const float* w12, int B,
                       int cap, int tile, int n_phases, int n_iters,
                       int check_every, int stop_at_eps, float rho,
                       float alpha, float mu, float dt2, float dt_m,
                       float w_force, float ci, float eps_abs, float eps_rel,
                       void* stream) {
  Params p;
  for (int k = 0; k < 6; ++k) { p.wtop[k] = w12[k]; p.wbot[k] = w12[6 + k]; }
  p.rho = rho; p.alpha = alpha; p.mu = mu; p.dt2 = dt2; p.dt_m = dt_m;
  p.w_force = w_force; p.ci = ci; p.eps_abs = eps_abs; p.eps_rel = eps_rel;
  p.B = B; p.cap = cap; p.tile = tile; p.n_iters = n_iters;
  p.check_every = check_every; p.stop_at_eps = stop_at_eps;
  p.n_phases = n_phases;
  const size_t smem = smem_bytes(cap, tile);
  cudaError_t e = cudaFuncSetAttribute(
      qp_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  qp_phase_kernel<<<B / tile, tile, smem, (cudaStream_t)stream>>>(
      p, q, blst, x0, y0, kinv, g1, g2, phases_of, lo, hi, x, y, z, ax, res);
  return (int)cudaGetLastError();
}

}  // extern "C"
