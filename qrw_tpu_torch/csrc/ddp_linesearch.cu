// The line search and accept of a batched iLQR iteration on the SRB model
// of core/mpc_ddp, one launch for every problem b of B: for each of the A
// step sizes alpha (crocoddyl's 2^-k) the closed-loop rollout over the N
// nodes
//   u_k = g_k (us_k + alpha kff_k + K_k (x_k - xs_k)),  x_k+1 = f(x_k, u_k),
// its running costs and terminal cost summed in registers; then the choice
// as ops/ilqr's plain line search makes it (a NaN cost counts as +inf, the
// lowest index wins among equal costs, as torch.argmin), the accept if the
// best cost is below the current one, the new trajectory (on a reject the
// old one), cost, Levenberg regularization (x reg_dec down to reg_min, or
// x reg_inc up to reg_max), the cost trace's column and an accepted flag.
// Without gains (kff null) it is the solve's initial rollout: the controls
// as given, rolled out from x0, the trajectory and its cost written.
//
// Replaces no Pallas kernel. It stands for the `jax.vmap(forward)` line
// search of qrw_tpu/ops/ilqr.py:118-132, which the port ran as plain
// PyTorch over a (A, B) batch: some 7,700 small launches a cycle at the
// DDP cell's shape (per node a batched matrix-vector product that copied
// K_k nine times, the SRB step with its 3 x 3 inverse for each step size,
// the cost's stacks over (A, B, N, ...) tensors). The arithmetic is
// core/mpc_ddp._dynamics and _stage_cost under the same toggles
// (nonlinear, implicit integration, relative forces), in another order of
// roundings; ops/ilqr.plain_linesearch is the plain version.
//
// What bounds it on the H100: the bytes it reads. A problem's gains are
// N (144 + 12) values, its trajectory, node arguments and terminal
// arguments some 90 more a node: 13.6 KB a problem in float32, 446 MB an
// iteration at the DDP cell's shape (B = 32,768, N = 16), and it writes
// 1.6 KB (52 MB): 0.149 ms at 3.35 TB/s. Its arithmetic, ~600 operations
// a (problem, step size, node), is ~2.8 GFLOP: 0.04 ms at 67 TFLOP/s.
//
// The design, for the bytes:
// * A thread takes one (problem, step size) pair, and the A threads of a
//   problem are neighbours in the block (a warp holds 3-4 problems). They
//   read the problem's gains and node rows together, 16 bytes a load, so
//   each load instruction asks for 3-4 distinct lines and the L1 serves
//   the A threads from one fetch: K_k comes from device memory once for
//   the A step sizes, and no copy of it is made. One thread a problem
//   carrying the A states would need ~110 more registers and leave 256
//   threads an SM at this batch.
// * A block holds P = 32 problems (288 threads for A = 9). For the linear
//   model the inertia's rotation and inverse depend on the node's
//   reference yaw, not on alpha: the block computes them once per
//   (problem, node) into shared memory before the rollouts.
// * No trajectory of the A candidates is kept. Each thread sums its cost;
//   a barrier, one thread a problem chooses; then warp 0 rolls the
//   accepted problems' best step size out again, through the same code (a
//   loop of two passes that is not unrolled), and writes it, while the
//   other warps copy the rejected problems' old trajectories.
// * Templated on float and double (runtime/mpc_service runs float64); the
//   toggles are run-time flags, the same for every problem.
//
// Measured on an H100 (700 W) at the DDP cell's shape: 1.02 ms a launch,
// 14.5% of the bound, 2 blocks an SM. The second rollout has 1/A of the
// first's arithmetic but runs on one warp of each block and holds much of
// the time (0.59 of 1.31 ms in a build whose gain() also read row-major
// K, at 96 registers). Tried in that build and not kept: blocks of 3 to
// 16 problems (1.26 to 1.75 ms); 1 or 3 blocks an SM (1.39, 1.38 ms);
// each node's gains and rows staged in shared memory by the whole block,
// two barriers a node (1.21 ms; 1.11 ms at 16 problems a block), for ~70
// lines more.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "ddp_srb.cuh"

namespace {

constexpr int THREADS = 288;      // most threads a block: 32 problems x 9
constexpr int MAX_P = 32;         // problems a block
constexpr int MAX_N = 32;         // nodes (core/mpc_ddp.MAX_NODES)
constexpr int MAX_A = 32;         // step sizes (core/mpc_ddp.MAX_ALPHAS)
constexpr int N_LS = 4;           // reg_min, reg_max, reg_inc, reg_dec

template <typename T> struct Search {
  const T *x0, *xs, *us;              // (B, 12), (B, N+1, 12), (B, N, 12)
  const T* kff[MAX_N];                // each (B, 12); null: the rollout
  const T* K[MAX_N];                  // each (B, 12, 12), column-major
  const T *feet, *gait, *xref, *dt;   // (B, N, 12 | 4 | 12 | 1)
  const T *xrefT, *feetT, *gaitT;     // (B, 12 | 12 | 4)
  const T *cost, *reg;                // (B,)
  T *xs_out, *us_out, *cost_out, *reg_out, *trace;  // trace (B, ld_trace)
  unsigned char* accepted;            // (B,)
  T alpha[MAX_A], reg_min, reg_max, reg_inc, reg_dec;
  int B, N, A, P, gains, ld_trace, it;
};

__device__ __forceinline__ void ldg16(float (&v)[4], const float* p) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void ldg16(double (&v)[2], const double* p) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = q.x;
  v[1] = q.y;
}
__device__ __forceinline__ void st16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// A row of W values at a 16-byte aligned address, 16 bytes a load.
template <typename T, int W>
__device__ __forceinline__ void load_row(T (&o)[W], const T* src) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < W / V; ++j) {
    T v[V];
    ldg16(v, src + j * V);
#pragma unroll
    for (int i = 0; i < V; ++i) o[j * V + i] = v[i];
  }
}

template <typename T>
__device__ __forceinline__ void store_row(T* dst, const T (&o)[NX]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < NX / V; ++j) st16(dst + j * V, o + j * V);
}

// max(r, 0) as torch.maximum: a NaN passes.
template <typename T> __device__ __forceinline__ T relu(T r) {
  return r <= T(0) ? T(0) : r;
}

// s += K dx for one 12 x 12 matrix, column-major as the backward pass's
// solve leaves it, read in memory order; each s[r] sums its 12 products in
// column order.
template <typename T>
__device__ __forceinline__ void gain(const T* K, const T (&dx)[NX],
                                     T (&s)[NX]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < NXX / V; ++j) {
    T v[V];
    ldg16(v, K + j * V);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int e = j * V + i;
      s[e % NX] += v[i] * dx[e / NX];
    }
  }
}

// _stage_cost's state terms: the weighted tracking error and the shoulder
// over-extension penalty (the iterate's yaw rotates the shoulders).
template <typename T>
__device__ __forceinline__ T state_cost(const Params<T>& p, const T (&x)[NX],
                                        const T (&xr)[NX], const T (&ft)[NX],
                                        const T (&g)[4]) {
  T e2 = T(0);
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    const T e = p.w[k] * (x[k] - xr[k]);
    e2 += e * e;
  }
  T s, c;
  sin_cos(x[5], &s, &c);
  T sh = T(0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T ex = x[0] + (c * p.sx[i] - s * p.sy[i]) - ft[3 * i];
    const T ey = x[1] + (s * p.sx[i] + c * p.sy[i]) - ft[3 * i + 1];
    const T d = sqrt(ex * ex + ey * ey + x[2] * x[2] + p.eps);
    const T v = relu(d - p.hlim) * g[i];
    sh += v * v;
  }
  return T(0.5) * e2 + T(0.5) * p.w_sh * sh;
}

// _stage_cost of a node: the state terms, the stance forces' regularization
// (about the static gravity share under RELATIVE) and the friction cone's
// penalty (inner pyramid, the least fz, fz_max).
template <typename T>
__device__ __forceinline__ T running_cost(const Params<T>& p,
                                          const T (&x)[NX], const T (&u)[NX],
                                          const T (&xr)[NX],
                                          const T (&ft)[NX],
                                          const T (&g)[4]) {
  const T n_c = fmax(g[0] + g[1] + g[2] + g[3], T(1));
  const T fz_ref = p.mg / n_c;
  T f2 = T(0), fr = T(0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T fx = u[3 * i], fy = u[3 * i + 1], fz = u[3 * i + 2];
    const T zref = (p.flags & RELATIVE) ? fz_ref * g[i] : T(0);
    const T a0 = fx * g[i], a1 = fy * g[i], a2 = (fz - zref) * g[i];
    f2 += a0 * a0 + a1 * a1 + a2 * a2;
    const T mf = mul_rn(p.mu, fz);
    const T r[6] = {fx - mf, -fx - mf, fy - mf, -fy - mf, p.min_fz - fz,
                    fz - p.fz_max};
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const T v = relu(r[j]) * g[i];
      fr += v * v;
    }
  }
  return state_cost(p, x, xr, ft, g) + T(0.5) * p.w_f2 * f2 +
         T(0.5) * p.w_fr * fr;
}

// _dynamics: the SRB step of x in place (Ii the world-frame inverse
// inertia of the node's yaw).
template <typename T>
__device__ __forceinline__ void srb_step(const Params<T>& p, T (&x)[NX],
                                         const T (&u)[NX], const T (&ft)[NX],
                                         const T (&g)[4], const T (&Ii)[3][3],
                                         T dt, bool implicit) {
  T f[3] = {T(0), T(0), T(0)}, tau[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T l0 = ft[3 * i] - x[0], l1 = ft[3 * i + 1] - x[1];
    const T l2 = ft[3 * i + 2] - (x[2] + p.com_z);
    const T v0 = u[3 * i] * g[i], v1 = u[3 * i + 1] * g[i];
    const T v2 = u[3 * i + 2] * g[i];
    f[0] += v0;
    f[1] += v1;
    f[2] += v2;
    tau[0] += l1 * v2 - l2 * v1;
    tau[1] += l2 * v0 - l0 * v2;
    tau[2] += l0 * v1 - l1 * v0;
  }
  T acc[6];
  acc[0] = f[0] / p.mass;
  acc[1] = f[1] / p.mass;
  acc[2] = f[2] / p.mass - p.gravity;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    acc[3 + r] = Ii[r][0] * tau[0] + Ii[r][1] * tau[1] + Ii[r][2] * tau[2];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const T v = x[6 + j] + dt * acc[j];
    x[j] = x[j] + dt * (implicit ? v : x[6 + j]);
    x[6 + j] = v;
  }
}

// Problem b's closed-loop rollout at step size alpha (without gains: its
// controls as given), its total cost returned; with `write` its states
// (and, with gains, its controls) stored to the outputs. Ii_s: the
// problem's (N, 9) inverse inertias in shared memory, or null (the
// nonlinear model: from the iterate's yaw).
template <typename T>
__device__ __forceinline__ T rollout(const Params<T>& p, const Search<T>& a,
                                     int b, T alpha, const T* Ii_s,
                                     bool write) {
  const int N = a.N;
  const bool implicit = p.flags & IMPLICIT;
  T x[NX];
  load_row(x, a.x0 + (size_t)b * NX);
  T* xs_out = a.xs_out + (size_t)b * (N + 1) * NX;
  if (write) store_row(xs_out, x);
  T cost = T(0);
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    const size_t row = (size_t)b * N + k;
    T u[NX], ft[NX], xr[NX], g[4];
    load_row(u, a.us + row * NX);
    load_row(ft, a.feet + row * NX);
    load_row(xr, a.xref + row * NX);
    load_row(g, a.gait + row * 4);
    if (a.gains) {
      T xk[NX], kf[NX], s[NX];
      load_row(xk, a.xs + ((size_t)b * (N + 1) + k) * NX);
      load_row(kf, a.kff[k] + (size_t)b * NX);
      T dx[NX];
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        dx[c] = x[c] - xk[c];
        s[c] = T(0);
      }
      gain(a.K[k] + (size_t)b * NXX, dx, s);
#pragma unroll
      for (int r = 0; r < NX; ++r) {
        const T v = u[r] + mul_rn(alpha, kf[r]);
        u[r] = (v + s[r]) * g[r / 3];
      }
      if (write) store_row(a.us_out + row * NX, u);
    }
    cost += running_cost(p, x, u, xr, ft, g);
    T Ii[3][3];
    if (Ii_s != nullptr) {
#pragma unroll
      for (int j = 0; j < 9; ++j) Ii[j / 3][j % 3] = Ii_s[k * 9 + j];
    } else {
      T s, c;
      sin_cos(x[5], &s, &c);
      inv_inertia(p, s, c, Ii);
    }
    srb_step(p, x, u, ft, g, Ii, __ldg(a.dt + row), implicit);
    if (write) store_row(xs_out + (size_t)(k + 1) * NX, x);
  }
  T xr[NX], ft[NX], g[4];
  load_row(xr, a.xrefT + (size_t)b * NX);
  load_row(ft, a.feetT + (size_t)b * NX);
  load_row(g, a.gaitT + (size_t)b * 4);
  return cost + state_cost(p, x, xr, ft, g);
}

template <typename T> size_t smem_bytes(int P, int N, int A, bool linear) {
  return sizeof(T) * ((linear ? (size_t)P * N * 9 : 0) + (size_t)P * A) +
         sizeof(int) * P;
}

template <typename T, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ddp_linesearch_kernel(const Params<T> p, const Search<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = a.N, P = a.P, t = threadIdx.x;
  const int A = a.gains ? a.A : 1;
  const bool linear = !(p.flags & NONLINEAR);
  T* Ii_s = reinterpret_cast<T*>(smem);                     // (P, N, 9)
  T* costs = Ii_s + (linear ? P * N * 9 : 0);               // (P, A)
  int* best = reinterpret_cast<int*>(costs + P * A);        // (P,)
  const int b0 = blockIdx.x * P;
  const int np = min(P, a.B - b0);

  if (linear) {  // the inertia of the reference yaw, once a (problem, node)
    for (int i = t; i < np * N; i += blockDim.x) {
      T s, c, Ii[3][3];
      sin_cos(__ldg(a.xref + ((size_t)b0 * N + i) * NX + 5), &s, &c);
      inv_inertia(p, s, c, Ii);
#pragma unroll
      for (int j = 0; j < 9; ++j) Ii_s[i * 9 + j] = Ii[j / 3][j % 3];
    }
    __syncthreads();
  }

  // pass 0: every (problem, step size), or the rollout; pass 1: the
  // accepted problems' best step size again, written. One copy of the
  // code serves both, so they round alike.
#pragma unroll 1
  for (int pass = 0; pass < (a.gains ? 2 : 1); ++pass) {
    const int lp = pass == 0 ? t / A : t;
    const bool run = pass == 0 ? lp < np : (t < np && best[t] >= 0);
    const int ia = pass == 0 ? t % A : (run ? best[t] : 0);
    const bool write = pass == 1 || !a.gains;
    T c = T(0);
    if (run)
      c = rollout(p, a, b0 + lp, a.alpha[ia],
                  linear ? Ii_s + (size_t)lp * N * 9 : nullptr, write);
    if (pass == 1) break;
    if (!a.gains) {
      if (run) a.cost_out[b0 + lp] = c;
      break;
    }
    costs[t] = c != c ? T(INFINITY) : c;
    __syncthreads();
    if (t < np) {  // the choice and the accept of problem b0 + t
      const int b = b0 + t;
      int bi = 0;
      T bc = costs[t * A];
      for (int i = 1; i < A; ++i) {
        if (costs[t * A + i] < bc) {
          bc = costs[t * A + i];
          bi = i;
        }
      }
      const T now = a.cost[b], r = a.reg[b];
      const bool ok = bc < now;
      a.cost_out[b] = ok ? bc : now;
      a.trace[(size_t)b * a.ld_trace + a.it] = ok ? bc : now;
      a.reg_out[b] = ok ? fmax(r * a.reg_dec, a.reg_min)
                        : fmin(r * a.reg_inc, a.reg_max);
      a.accepted[b] = ok;
      best[t] = ok ? bi : -1;
    }
    __syncthreads();
    // the rejected problems keep their trajectory: the warps after the
    // first copy it, 16 bytes a thread, while warp 0 (every t < np) rolls
    // the accepted ones out again
    const int wx = (N + 1) * NX * (int)sizeof(T) / 16;
    const int wu = N * NX * (int)sizeof(T) / 16;
    const int first = blockDim.x > 32 ? 32 : 0;
    const uint4* xs_in =
        reinterpret_cast<const uint4*>(a.xs + (size_t)b0 * (N + 1) * NX);
    const uint4* us_in =
        reinterpret_cast<const uint4*>(a.us + (size_t)b0 * N * NX);
    uint4* xs_o =
        reinterpret_cast<uint4*>(a.xs_out + (size_t)b0 * (N + 1) * NX);
    uint4* us_o = reinterpret_cast<uint4*>(a.us_out + (size_t)b0 * N * NX);
    if (t >= first) {
      for (int j = t - first; j < np * (wx + wu); j += blockDim.x - first) {
        if (j < np * wx) {
          if (best[j / wx] < 0) xs_o[j] = __ldg(xs_in + j);
        } else {
          const int m = j - np * wx;
          if (best[m / wu] < 0) us_o[m] = __ldg(us_in + m);
        }
      }
    }
  }
}

template <typename T, int MIN_BLOCKS>
int launch(const double* prm, int flags, const double* ls, Search<T> a,
           cudaStream_t stream) {
  for (int i = 0; i < a.A; ++i) a.alpha[i] = (T)ls[N_LS + i];
  a.reg_min = (T)ls[0];
  a.reg_max = (T)ls[1];
  a.reg_inc = (T)ls[2];
  a.reg_dec = (T)ls[3];
  const int A = a.gains ? a.A : 1;
  a.P = a.gains ? (THREADS / A < MAX_P ? THREADS / A : MAX_P) : MAX_P;
  const bool linear = !(flags & NONLINEAR);
  const size_t smem = smem_bytes<T>(a.P, a.N, A, linear);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ddp_linesearch_kernel<T, MIN_BLOCKS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (a.B + a.P - 1) / a.P;
  ddp_linesearch_kernel<T, MIN_BLOCKS>
      <<<grid, a.P * A, smem, stream>>>(params<T>(prm, flags), a);
  return (int)cudaGetLastError();
}

template <typename T>
Search<T> search(const void* x0, const void* xs, const void* us,
                 const void* const* kff, const void* const* K,
                 const void* feet, const void* gait, const void* xref,
                 const void* dt, const void* xrefT, const void* feetT,
                 const void* gaitT, const void* cost, const void* reg,
                 void* xs_out, void* us_out, void* cost_out, void* reg_out,
                 void* trace, void* accepted, int B, int N, int A,
                 int ld_trace, int it) {
  Search<T> a = {};
  a.x0 = (const T*)x0;
  a.xs = (const T*)xs;
  a.us = (const T*)us;
  a.gains = kff != nullptr;
  for (int k = 0; a.gains && k < N; ++k) {
    a.kff[k] = (const T*)kff[k];
    a.K[k] = (const T*)K[k];
  }
  a.feet = (const T*)feet;
  a.gait = (const T*)gait;
  a.xref = (const T*)xref;
  a.dt = (const T*)dt;
  a.xrefT = (const T*)xrefT;
  a.feetT = (const T*)feetT;
  a.gaitT = (const T*)gaitT;
  a.cost = (const T*)cost;
  a.reg = (const T*)reg;
  a.xs_out = (T*)xs_out;
  a.us_out = (T*)us_out;
  a.cost_out = (T*)cost_out;
  a.reg_out = (T*)reg_out;
  a.trace = (T*)trace;
  a.accepted = (unsigned char*)accepted;
  a.B = B;
  a.N = N;
  a.A = A;
  a.ld_trace = ld_trace;
  a.it = it;
  return a;
}

}  // namespace

extern "C" {

// One launch on `stream` over the B problems of N nodes; every tensor
// pointer is a device pointer to `itemsize`-byte floats laid out as
// core/mpc_ddp._srb_linesearch documents, `prm` a host array of N_PARAMS
// doubles, `flags` the model toggles, `ls` a host array of 4 + A doubles
// (reg_min, reg_max, reg_inc, reg_dec, the A step sizes), `kff` and `K`
// host arrays of the N nodes' device pointers (null: the initial rollout,
// which reads x0, us and the node arguments and writes xs_out and
// cost_out), each K column-major. Returns cudaGetLastError(), or -1 for
// arguments out of range (a backstop: core/mpc_ddp._srb_linesearch
// refuses them in words before it calls).
int qrw_ddp_linesearch(int itemsize, const double* prm, int flags,
                       const double* ls, int A, const void* x0,
                       const void* xs, const void* us,
                       const void* const* kff, const void* const* K,
                       const void* feet, const void* gait,
                       const void* xref, const void* dt, const void* xrefT,
                       const void* feetT, const void* gaitT, const void* cost,
                       const void* reg, void* xs_out, void* us_out,
                       void* cost_out, void* reg_out, void* trace,
                       void* accepted, int B, int N, int ld_trace, int it,
                       void* stream) {
  if (B < 1 || N < 1 || N > MAX_N || A < 1 || A > MAX_A || prm == nullptr ||
      ls == nullptr || (kff != nullptr && (K == nullptr || it < 0 ||
                                           it >= ld_trace)))
    return -1;
  const cudaStream_t s = (cudaStream_t)stream;
  if (itemsize == 4)
    return launch<float, 2>(
        prm, flags, ls,
        search<float>(x0, xs, us, kff, K, feet, gait, xref, dt, xrefT,
                      feetT, gaitT, cost, reg, xs_out, us_out, cost_out,
                      reg_out, trace, accepted, B, N, A, ld_trace, it),
        s);
  if (itemsize == 8)
    return launch<double, 1>(
        prm, flags, ls,
        search<double>(x0, xs, us, kff, K, feet, gait, xref, dt,
                       xrefT, feetT, gaitT, cost, reg, xs_out, us_out,
                       cost_out, reg_out, trace, accepted, B, N, A, ld_trace,
                       it),
        s);
  return -1;
}

}  // extern "C"
