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
// What bounds it on the H100: operations and their latency, not
// bandwidth. A problem-iteration is ~48 kflop (the metric step 2n^2, the
// two Gram products 24 cap^2, slab, cone and elementwise passes) against
// ~12.8 kB of per-problem data read once a solve; each iteration is a
// chain of dependent steps (slab products -> Gram products -> metric step
// -> projections), 300 iterations long.
//
// What this design does about it:
// * A tile (the unit of the stop_at_eps exit) is spread over a cluster of
//   CL thread blocks on CL SMs, PB = tile / CL problems a block, so
//   B = 1024 at tile 128 runs 64 blocks, not 8. CL is 8 (the portable
//   cluster size) wherever a block of tile / 8 problems is compiled, and
//   16 (the H100's non-portable maximum) for the tiles whose block of
//   tile / 8 would not fit in shared memory: cap 32 at tile 512 (the JAX
//   package's tile on its accelerator), cap 48 at tile 256 and cap 64 at
//   tile 64. At each check the blocks AND their problems' flags, exchange
//   the ANDs through distributed shared memory between two cluster
//   barriers, and the whole tile stops together, as the Pallas kernel's
//   tile does.
// * Every block stages the tile's phase data (Kbar^-1 with a padded row
//   stride n + 1, G1 and G2 with stride cap + 1, l, u) and its problems'
//   q, slabs, x, z, y and A x in shared memory; the iterates never leave
//   the SM until the final write. The phase data is read from L2 by the
//   8 blocks of a tile once a launch; one copy a cluster read through
//   distributed shared memory would instead cross the SM-to-SM network
//   on every Kbar^-1 and G word of every iteration.
// * A thread owns one stance slot s of PPT problems (cap x PB / PPT
//   threads). Every product is computed output by output in the serial
//   order of the previous one-thread-per-problem kernel, so each output is
//   rounded as before; the shared operands are read once per warp for all
//   the lanes that share a slot (a broadcast), and the thread reuses each
//   Kbar^-1 and G word for its PPT problems from a register.
// * Two block barriers an iteration: after the slab products (the Gram
//   products read every slot's) and after the gradient (the metric step
//   reads every row's). The termination test's per-problem maxima reduce
//   over slots with warp shuffles and one shared-memory pass.
// * Exact semantics: l is -inf on four of every five rows and
//   fmaxf(v, -INFINITY) == v; y / rho is a true division; the
//   termination test divides the cost scaling back out as the JAX
//   wrapper does; a phase id out of range traps.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr float X_CLIP = 100.0f;
constexpr float Y_CLIP = 1.0e4f;
constexpr int NRED = 6;          // pri, dua, |A x|, |z|, |H x|, |A'y|

struct Params {
  float wtop[6];
  float wbot[6];
  float rho, alpha, mu, dt2, dt_m, w_force, ci, eps_abs, eps_rel;
  int B, tile, n_iters, check_every, stop_at_eps, n_phases;
};

// The kernel is compiled for three caps (stance slots): 32 = 2N at N = 16
// (trot, pacing, bounding), 48 = 3N (walk's 3-stance rows, and any phase
// set that holds walk) and 64 = 4N (phase sets with 4-stance rows: the
// static gait and the mixed windows of a switch to it), the last at 4
// problems a block only (tile 32, or 64 over 16 blocks: 224,896 B of
// shared memory a block; 8 problems would need 267,264 B). Problems a
// thread (PPT), threads a slot (PH) and threads a block (NT = CAP PH: 8,
// 12, 6 or 8 warps) for PB problems a block, and the shape constants of
// the cap. The cluster size CL (blocks a tile) is the kernel's third
// template parameter.
template <int CAP_, int PB>
struct Geo {
  static constexpr int CAP = CAP_;
  static constexpr int NV = 3 * CAP;     // variables
  static constexpr int MR = 5 * CAP;     // cone rows
  static constexpr int KS = NV + 1;      // padded row stride of Kbar^-1
  static constexpr int GS = CAP + 1;     // padded row stride of G1, G2
  static constexpr int PPT = PB > 8 ? PB / 8 : 1;
  static constexpr int PH = PB / PPT;
  static constexpr int NT = CAP * PH;
  static_assert(NT % 32 == 0, "whole warps a block");
  static_assert(32 % PH == 0, "a warp holds whole slots");
};

__host__ __device__ constexpr size_t smem_floats(int cap, int pb, int nt) {
  const size_t c = cap, n = 3 * c, m = 5 * c;   // variables, cone rows
  return n * (n + 1) + 2 * c * (c + 1) + 2 * m +
         pb * (n + 3 * m + n + 9 * c + 6 * c + n) +
         (size_t)(nt / 32) * NRED * pb + (size_t)NRED * pb + 2 * pb;
}

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
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

// Max over the block's slots of NV_ per-problem values: v[k][j] is this
// thread's value j of its problem k. out[j * PB + p] gets the result.
// Values are >= 0 (absolute values): fmaxf from 0 ignores NaN in any
// order, as the sequential loop of one thread did.
template <class G, int PB, int NV_>
__device__ void slot_max(float (&v)[G::PPT][NV_], float* red, float* out) {
  constexpr int PPT = G::PPT, PH = G::PH, NT = G::NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < PPT; ++k)
#pragma unroll
    for (int j = 0; j < NV_; ++j)
#pragma unroll
      for (int o = PH; o < 32; o <<= 1)
        v[k][j] = fmaxf(v[k][j], __shfl_xor_sync(0xffffffffu, v[k][j], o));
  if (lane < PH) {
#pragma unroll
    for (int k = 0; k < PPT; ++k)
#pragma unroll
      for (int j = 0; j < NV_; ++j)
        red[(warp * NV_ + j) * PB + lane + k * PH] = v[k][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NV_ * PB; i += NT) {
    const int j = i / PB, pp = i - j * PB;
    float r = 0.f;
    for (int w = 0; w < NT / 32; ++w) r = fmaxf(r, red[(w * NV_ + j) * PB + pp]);
    out[i] = r;
  }
  __syncthreads();
}

template <int CAP, int PB, int CL>
__global__ void __launch_bounds__(Geo<CAP, PB>::NT)
qp_phase_kernel(Params p, const float* __restrict__ Qg,
                const float* __restrict__ blst,
                const float* __restrict__ X0, const float* __restrict__ Y0,
                const float* __restrict__ kinv_all,
                const float* __restrict__ g1_all,
                const float* __restrict__ g2_all,
                const int* __restrict__ phases_of,
                const float* __restrict__ lo_g,
                const float* __restrict__ hi_g, float* __restrict__ Xo,
                float* __restrict__ Yo, float* __restrict__ Zo,
                float* __restrict__ res) {
  using G = Geo<CAP, PB>;
  constexpr int PPT = G::PPT, PH = G::PH, NT = G::NT;
  constexpr int NV = G::NV, MR = G::MR, KS = G::KS, GS = G::GS;
  extern __shared__ float smem[];
  float* K = smem;                     // NV x KS, Kbar^-1 of the phase
  float* G1 = K + NV * KS;             // CAP x GS
  float* G2 = G1 + CAP * GS;           // CAP x GS
  float* lo = G2 + CAP * GS;           // MR
  float* hi = lo + MR;                 // MR
  float* X = hi + MR;                  // (NV, PB): element (row, problem)
  float* Z = X + NV * PB;              // (MR, PB)
  float* Y = Z + MR * PB;              // (MR, PB)
  float* AX = Y + MR * PB;             // (MR, PB)
  float* Q = AX + MR * PB;             // (NV, PB)
  float* SL = Q + NV * PB;             // (9 CAP, PB): slab (i, s, a)
  float* PSF = SL + 9 * CAP * PB;      // (6 CAP, PB): slab products
  float* GV = PSF + 6 * CAP * PB;      // (NV, PB): gradient
  float* RED = GV + NV * PB;           // (NT / 32, NRED, PB)
  float* RMAX = RED + (NT / 32) * NRED * PB;  // (NRED, PB) reduced maxima
  float* ITC = RMAX + NRED * PB;         // (PB) it_conv
  float* NQ = ITC + PB;                // (PB) max |q| of each problem
  __shared__ int vote;

  const int tid = threadIdx.x;
  const int tile_id = blockIdx.x / CL;
  const int col0 = tile_id * p.tile + (blockIdx.x % CL) * PB;
  const int ph_id = phases_of[tile_id];
  if (ph_id < 0 || ph_id >= p.n_phases) __trap();  // a phase id out of range

  const float* kinv = kinv_all + (size_t)ph_id * NV * NV;
  for (int i = tid; i < NV * NV; i += NT) K[(i / NV) * KS + i % NV] = kinv[i];
  for (int i = tid; i < CAP * CAP; i += NT) {
    const int r = i / CAP, c = i % CAP;
    G1[r * GS + c] = g1_all[(size_t)ph_id * CAP * CAP + i];
    G2[r * GS + c] = g2_all[(size_t)ph_id * CAP * CAP + i];
  }
  for (int i = tid; i < MR; i += NT) { lo[i] = lo_g[i]; hi[i] = hi_g[i]; }
  for (int i = tid; i < NV * PB; i += NT) {
    const size_t g = (size_t)(i / PB) * p.B + col0 + i % PB;
    X[i] = X0[g];
    Q[i] = Qg[g];
  }
  for (int i = tid; i < MR * PB; i += NT)
    Y[i] = Y0[(size_t)(i / PB) * p.B + col0 + i % PB];
  for (int i = tid; i < 9 * CAP * PB; i += NT)
    SL[i] = blst[(size_t)(i / PB) * p.B + col0 + i % PB];
  for (int i = tid; i < PB; i += NT) ITC[i] = (float)p.n_iters;
  __syncthreads();

  // this thread's stance slot and problems ph + k PH, k < PPT
  const int s = tid / PH, ph = tid % PH;
#define AT(arr, row, k) (arr)[(row) * PB + ph + (k) * PH]
#define SLAB(i, a, k) AT(SL, ((i) * CAP + s) * 3 + (a), k)

  // A x0 and z = A x0; |q| of the slot
  float nq[PPT][1];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    float c5[5];
    cone5(AT(X, 3 * s, k), AT(X, 3 * s + 1, k), AT(X, 3 * s + 2, k), p.mu, c5);
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      AT(AX, 5 * s + j, k) = c5[j];
      AT(Z, 5 * s + j, k) = c5[j];
    }
    nq[k][0] = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) nq[k][0] = fmaxf(nq[k][0], fabsf(AT(Q, 3 * s + i, k)));
  }
  slot_max<G, PB, 1>(nq, RED, NQ);
  for (int i = tid; i < PB; i += NT) NQ[i] *= p.ci;

  // psf of the slot: k < 3 the constant force rows (dt/m x_s), k >= 3 the
  // torque-row inner products
  auto slab_products = [&]() {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const float x0 = AT(X, 3 * s, k), x1 = AT(X, 3 * s + 1, k),
                  x2 = AT(X, 3 * s + 2, k);
      AT(PSF, s * 6 + 0, k) = p.dt_m * x0;
      AT(PSF, s * 6 + 1, k) = p.dt_m * x1;
      AT(PSF, s * 6 + 2, k) = p.dt_m * x2;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        AT(PSF, s * 6 + 3 + a, k) =
            SLAB(0, a, k) * x0 + SLAB(1, a, k) * x1 + SLAB(2, a, k) * x2;
    }
  };
  // (H_b x) for the slot's rows 3s..3s+2, from every slot's psf
  auto hx_slot = [&](float out[PPT][3]) {
    float v1[PPT][6], v2[PPT][6];
#pragma unroll
    for (int k = 0; k < PPT; ++k)
#pragma unroll
      for (int c = 0; c < 6; ++c) { v1[k][c] = 0.f; v2[k][c] = 0.f; }
#pragma unroll 4
    for (int c = 0; c < CAP; ++c) {
      const float g1 = G1[s * GS + c], g2 = G2[s * GS + c];
#pragma unroll
      for (int k = 0; k < PPT; ++k)
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          const float ps = AT(PSF, c * 6 + a, k);
          v1[k][a] += g1 * ps;
          v2[k][a] += g2 * ps;
        }
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      float vS[6];
#pragma unroll
      for (int a = 0; a < 6; ++a)
        vS[a] = v1[k][a] * p.dt2 * p.wtop[a] + v2[k][a] * p.wbot[a];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float t = SLAB(i, 0, k) * vS[3] + SLAB(i, 1, k) * vS[4] +
                        SLAB(i, 2, k) * vS[5];
        out[k][i] = (p.dt_m * vS[i] + t) + p.w_force * AT(X, 3 * s + i, k);
      }
    }
  };
  // residual maxima of the slot, reduced into RMAX
  auto residuals = [&]() {
    slab_products();
    float v[PPT][NRED];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
#pragma unroll
      for (int j = 0; j < NRED; ++j) v[k][j] = 0.f;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const float ax = AT(AX, 5 * s + j, k), zz = AT(Z, 5 * s + j, k);
        v[k][0] = fmaxf(v[k][0], fabsf(ax - zz));
        v[k][2] = fmaxf(v[k][2], fabsf(ax));
        v[k][3] = fmaxf(v[k][3], fabsf(zz));
      }
    }
    __syncthreads();  // every slot's psf
    float hx[PPT][3];
    hx_slot(hx);
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      float yv[5], aty[3];
#pragma unroll
      for (int j = 0; j < 5; ++j) yv[j] = AT(Y, 5 * s + j, k);
      cone5_t(yv, p.mu, aty);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        v[k][1] = fmaxf(v[k][1], fabsf((hx[k][i] + AT(Q, 3 * s + i, k)) + aty[i]));
        v[k][4] = fmaxf(v[k][4], fabsf(hx[k][i]));
        v[k][5] = fmaxf(v[k][5], fabsf(aty[i]));
      }
    }
    slot_max<G, PB, NRED>(v, RED, RMAX);
  };

  cg::cluster_group cluster = cg::this_cluster();
  const int n_chunks = (p.n_iters + p.check_every - 1) / p.check_every;
  for (int c = 0; c < n_chunks; ++c) {
    const int hi_it = min((c + 1) * p.check_every, p.n_iters);
    for (int it = c * p.check_every; it < hi_it; ++it) {
      // A'(rho (A x - z) + y) of the slot, and its psf
      slab_products();
      float atw[PPT][3];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        float w[5];
#pragma unroll
        for (int j = 0; j < 5; ++j)
          w[j] = p.rho * (AT(AX, 5 * s + j, k) - AT(Z, 5 * s + j, k)) +
                 AT(Y, 5 * s + j, k);
        cone5_t(w, p.mu, atw[k]);
      }
      __syncthreads();  // every slot's psf; the metric step done with GV
      // g = (H_b x + q) + A'w
      float hx[PPT][3];
      hx_slot(hx);
#pragma unroll
      for (int k = 0; k < PPT; ++k)
#pragma unroll
        for (int i = 0; i < 3; ++i)
          AT(GV, 3 * s + i, k) = (hx[k][i] + AT(Q, 3 * s + i, k)) + atw[k][i];
      __syncthreads();  // every row of g
      // x+ = x - Kbar^-1 g for the slot's rows, then the cone projection
      float acc[PPT][3];
#pragma unroll
      for (int k = 0; k < PPT; ++k)
#pragma unroll
        for (int i = 0; i < 3; ++i) acc[k][i] = 0.f;
      const float* Krow = K + 3 * s * KS;
#pragma unroll 4
      for (int j = 0; j < NV; ++j) {
        const float k0 = Krow[j], k1 = Krow[KS + j], k2 = Krow[2 * KS + j];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float gv = AT(GV, j, k);
          acc[k][0] += k0 * gv;
          acc[k][1] += k1 * gv;
          acc[k][2] += k2 * gv;
        }
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        float xt[3], xo[3], xn[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          xo[i] = AT(X, 3 * s + i, k);
          xt[i] = xo[i] - acc[k][i];
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
            zr[j] = p.alpha * zt[j] + (1.0f - p.alpha) * AT(Z, 5 * s + j, k);
          cone5(xn[0], xn[1], xn[2], p.mu, axn);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) AT(X, 3 * s + i, k) = xn[i];
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          const int r = 5 * s + j;
          const float yo = AT(Y, r, k);
          const float zn = clipf(zr[j] + yo / p.rho, lo[r], hi[r]);
          AT(Z, r, k) = zn;
          AT(Y, r, k) = clipf(yo + p.rho * (zr[j] - zn), -Y_CLIP, Y_CLIP);
          AT(AX, r, k) = axn[j];
        }
      }
    }
    residuals();
    // the termination test per problem (NQ: max |q| ci); RMAX's first row
    // then holds the flags for the vote
    for (int i = tid; i < PB; i += NT) {
      const float eps_p = p.eps_abs + p.eps_rel * fmaxf(RMAX[2 * PB + i], RMAX[3 * PB + i]);
      const float eps_d = p.eps_abs + p.eps_rel *
          fmaxf(fmaxf(RMAX[4 * PB + i], RMAX[5 * PB + i]) * p.ci, NQ[i]);
      const bool cv = (RMAX[i] <= eps_p) && (RMAX[PB + i] * p.ci <= eps_d);
      ITC[i] = fminf(ITC[i], cv ? (float)hi_it : (float)p.n_iters);
      RMAX[i] = cv ? 1.f : 0.f;  // the flag, read by the vote below
    }
    if (p.stop_at_eps) {
      __syncthreads();
      int all = 1;
      for (int i = 0; i < PB; ++i) all &= RMAX[i] != 0.f;
      if (tid == 0) vote = all;
      cluster.sync();  // every block's vote written
      int tile_all = 1;
      for (int r = 0; r < CL; ++r)
        tile_all &= *cluster.map_shared_rank(&vote, r);
      cluster.sync();  // every vote read before the next is written
      if (tile_all) break;
    }
  }
  residuals();
  for (int i = tid; i < NV * PB; i += NT)
    Xo[(size_t)(i / PB) * p.B + col0 + i % PB] = X[i];
  for (int i = tid; i < MR * PB; i += NT) {
    const size_t g = (size_t)(i / PB) * p.B + col0 + i % PB;
    Yo[g] = Y[i];
    Zo[g] = Z[i];
  }
  for (int i = tid; i < PB; i += NT) {
    float* r = res + col0 + i;
    r[0] = RMAX[i];
    r[(size_t)p.B] = RMAX[PB + i];
    r[2 * (size_t)p.B] = fmaxf(RMAX[2 * PB + i], RMAX[3 * PB + i]);
    r[3 * (size_t)p.B] = fmaxf(RMAX[4 * PB + i], RMAX[5 * PB + i]);
    r[4 * (size_t)p.B] = ITC[i];
  }
#undef AT
#undef SLAB
}

template <int V>
using I = std::integral_constant<int, V>;

// The compiled instances: calls f(I<CAP>(), I<PB>(), I<CL>()) for the one
// at cap, PB problems a block and a cluster of CL blocks and returns what
// f returns, or -1 where none is compiled. The wrapper
// (ops/qp_phase.py::launch_geometry) refuses a block whose shared memory
// exceeds what a block can have, so none is compiled for one (cap 48 at
// 32 problems, cap 64 above 4); a cluster of 16 is compiled only where a
// cluster of 8 cannot hold the tile: cap 32 at tile 512, cap 48 at tile
// 256, cap 64 at tile 64.
template <class F>
int dispatch(int cap, int pb, int cl, F f) {
  if (cl == 8) {
    if (cap == 32) switch (pb) {
      case 4: return f(I<32>(), I<4>(), I<8>());
      case 8: return f(I<32>(), I<8>(), I<8>());
      case 16: return f(I<32>(), I<16>(), I<8>());
      case 32: return f(I<32>(), I<32>(), I<8>());
    }
    if (cap == 48) switch (pb) {
      case 4: return f(I<48>(), I<4>(), I<8>());
      case 8: return f(I<48>(), I<8>(), I<8>());
      case 16: return f(I<48>(), I<16>(), I<8>());
    }
    if (cap == 64 && pb == 4) return f(I<64>(), I<4>(), I<8>());
  }
  if (cl == 16) {
    if (cap == 32 && pb == 32) return f(I<32>(), I<32>(), I<16>());
    if (cap == 48 && pb == 16) return f(I<48>(), I<16>(), I<16>());
    if (cap == 64 && pb == 4) return f(I<64>(), I<4>(), I<16>());
  }
  return -1;
}

// Problems a block for a tile, and its cluster size into *cl: a cluster
// of 8 where its block is compiled, else one of 16; 0 where neither is.
int block_problems(int cap, int tile, int* cl) {
  for (int c = 8; c <= 16; c *= 2)
    if (tile % c == 0 &&
        dispatch(cap, tile / c, c, [](auto, auto, auto) { return 0; }) == 0) {
      *cl = c;
      return tile / c;
    }
  return 0;
}

int block_threads(int cap, int pb) {
  return cap * (pb > 8 ? 8 : pb);
}

template <int CAP, int PB, int CL>
cudaLaunchConfig_t launch_config(int B, int tile, size_t smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B / tile) * CL, 1, 1);
  cfg.blockDim = dim3(Geo<CAP, PB>::NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets the kernel's shared-memory attribute, and for a cluster above the
// portable 8 blocks the non-portable cluster size, which both the
// occupancy query and the launch need; with `clusters` non-null, stores
// how many clusters of the launch can be resident at once.
template <int CAP, int PB, int CL>
int prepare(int B, int tile, cudaStream_t stream, int* clusters) {
  const size_t smem = sizeof(float) * smem_floats(CAP, PB, Geo<CAP, PB>::NT);
  cudaError_t e = cudaFuncSetAttribute(
      qp_phase_kernel<CAP, PB, CL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (CL > 8) {
    e = cudaFuncSetAttribute(qp_phase_kernel<CAP, PB, CL>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return (int)e;
  }
  if (clusters) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg =
        launch_config<CAP, PB, CL>(B, tile, smem, stream, &attr);
    e = cudaOccupancyMaxActiveClusters(clusters,
                                       qp_phase_kernel<CAP, PB, CL>, &cfg);
  }
  return (int)e;
}

template <int CAP, int PB, int CL>
int launch(const Params& p, cudaStream_t stream, const float* q,
           const float* blst, const float* x0, const float* y0,
           const float* kinv, const float* g1, const float* g2,
           const int* phases_of, const float* lo, const float* hi, float* x,
           float* y, float* z, float* res) {
  const int e = prepare<CAP, PB, CL>(p.B, p.tile, stream, nullptr);
  if (e != 0) return e;
  const size_t smem = sizeof(float) * smem_floats(CAP, PB, Geo<CAP, PB>::NT);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      launch_config<CAP, PB, CL>(p.B, p.tile, smem, stream, &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, qp_phase_kernel<CAP, PB, CL>, p,
                                       q,
                                       blst,
                                       x0, y0, kinv, g1, g2, phases_of, lo,
                                       hi, x, y, z, res);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch geometry at (cap, tile): out[0] problems a block, out[1] the
// cluster size, out[2] threads a block, out[3] dynamic shared memory a
// block in bytes. Returns 0, or -1 where no block shape takes the tile.
int qrw_qp_phase_geometry(int cap, int tile, int* out) {
  int cl = 0;
  const int pb = block_problems(cap, tile, &cl);
  if (pb == 0) return -1;
  out[0] = pb;
  out[1] = cl;
  out[2] = block_threads(cap, pb);
  out[3] = (int)(sizeof(float) * smem_floats(cap, pb, block_threads(cap, pb)));
  return 0;
}

// Clusters of a B-problem launch at (cap, tile) that the card can hold
// at once (cudaOccupancyMaxActiveClusters) into *clusters. Returns a
// CUDA error code, or -1 where no kernel takes the tile.
int qrw_qp_phase_max_active_clusters(int cap, int tile, int B,
                                     int* clusters) {
  int cl = 0;
  const int pb = block_problems(cap, tile, &cl);
  return dispatch(cap, pb, cl, [&](auto C, auto P, auto L) {
    return prepare<decltype(C)::value, decltype(P)::value,
                   decltype(L)::value>(B, tile, 0, clusters);
  });
}

// Pointers are device pointers except w12 (host, 12 floats: wtop then
// wbot). Launches on `stream` and returns cudaGetLastError(), or -1
// where no kernel takes (cap, tile).
int qrw_qp_phase_solve(const float* q, const float* blst, const float* x0,
                       const float* y0, const float* kinv, const float* g1,
                       const float* g2, const int* phases_of, const float* lo,
                       const float* hi, float* x, float* y, float* z,
                       float* res, const float* w12, int B, int cap,
                       int tile, int n_phases, int n_iters, int check_every,
                       int stop_at_eps, float rho, float alpha, float mu,
                       float dt2, float dt_m, float w_force, float ci,
                       float eps_abs, float eps_rel, void* stream) {
  Params p;
  for (int k = 0; k < 6; ++k) { p.wtop[k] = w12[k]; p.wbot[k] = w12[6 + k]; }
  p.rho = rho; p.alpha = alpha; p.mu = mu; p.dt2 = dt2; p.dt_m = dt_m;
  p.w_force = w_force; p.ci = ci; p.eps_abs = eps_abs; p.eps_rel = eps_rel;
  p.B = B; p.tile = tile; p.n_iters = n_iters;
  p.check_every = check_every; p.stop_at_eps = stop_at_eps;
  p.n_phases = n_phases;
  if (B % tile) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  int cl = 0;
  const int pb = block_problems(cap, tile, &cl);
  return dispatch(cap, pb, cl, [&](auto C, auto P, auto L) {
    return launch<decltype(C)::value, decltype(P)::value,
                  decltype(L)::value>(p, s, q, blst, x0, y0, kinv, g1, g2,
                                      phases_of, lo, hi, x, y, z, res);
  });
}

}  // extern "C"
