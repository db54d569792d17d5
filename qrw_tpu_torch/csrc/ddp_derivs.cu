// The SRB model's exact derivatives on every row of a batched iLQR
// iteration, one launch: for each of the R = B N node rows of
// core/mpc_ddp's problem the dynamics' Jacobians fx, fu and the running
// cost's gradients lx, lu and Hessians lxx, luu, and for each of the B
// terminal states the terminal cost's Vx, Vxx, in the dense row-major
// layouts ops/ilqr._backward reads: (R, 12, 12), (R, 12), (B, 12),
// (B, 12, 12). lux is 0 for this cost (no term couples x and u) and is
// not written (the wrapper broadcasts a zero).
//
// Replaces no Pallas kernel. It stands for what qrw_tpu leaves to
// jax.jacfwd and jax.hessian (qrw_tpu/ops/ilqr.py) and the port took
// through torch.func: forward-over-reverse over 24 tangents a row, some
// 1,000 small launches an iteration (batched gemv, stack and cat on
// 12 x 12 operands). Here the mathematics is written out, and it is
// exact, not Gauss-Newton (core/mpc_ddp._srb_derivs_plain is the same
// arithmetic in PyTorch):
//   a = (f / m - g, I^-1 tau), f = sum g_i u_i, tau = sum lever_i x g_i u_i
//   d(I^-1 tau)/dp = I^-1 skew(f); d(I^-1 tau)/du_i = g_i I^-1 skew(lever_i);
//   d(f / m)/du_i = g_i / m I3; with the iterate's yaw rotating I
//   (nonlinear), d(I^-1 tau)/dyaw = (S I^-1 - I^-1 S) tau, S = skew(e_z);
//   v+ = v + dt a, p+ = p + dt v (explicit) or p + dt v+ (implicit: the
//   dt^2 terms); dt per row (the 500 Hz mode's shrunken first node).
//   Each max(r, 0)^2 / 2 penalty weighs grad r grad r' by the square of
//   torch.maximum's derivative (1, 1/2 at the tie r = 0, 0), so 1/4 at a
//   tie, and adds max(r, 0) times the Hessian of r: the friction cone's
//   rows are linear, the shoulder distance's full Hessian in (x, y, z,
//   yaw) is kept. The cone's residuals are formed as PyTorch forms them
//   (a product, then a difference, never fused), so that a tie is a tie
//   in both.
//
// What bounds it on the H100: the bytes it writes. A row reads 53 values
// (x, u, feet, gait, xref, dt) and writes 600 (fx, fu, lxx, luu: 144
// each; lx, lu: 12): 2,612 B in float32; a terminal row reads 40 and
// writes 156. At the DDP cell's shape (B = 32,768, N = 16: R = 524,288)
// that is 1.395 GB an iteration, 0.416 ms at 3.35 TB/s; the arithmetic,
// a few hundred flops a row, is some 0.2 GFLOP.
//
// The design, for the stores:
// * A warp takes 32 rows at a time, a lane a row, and computes the row's
//   derivatives in registers: the few dozen values that are not
//   structural zeros or ones.
// * It stages one output tensor at a time for its 32 rows in shared
//   memory (each lane writes its dense row as 16-byte vectors; the row
//   stride is an odd number of 16-byte words, so the 8 lanes of a
//   quarter-warp hit 8 different bank groups), then the warp copies the
//   32 rows' contiguous slab of that tensor to device memory with
//   16-byte coalesced stores (512 B a warp instruction). A lane never
//   stores its own 2.4 KB row with strided stores.
// * The warps are persistent: the grid is the SMs times the blocks an SM
//   holds (4 warps and 75,776 B of shared memory a block in float32, 3
//   blocks an SM; 2 warps and 74,752 B in float64), and each warp walks
//   the groups of 32 node rows, then those of the terminal rows.
// * Templated on float and double (runtime/mpc_service runs float64);
//   the model toggles are run-time flags, the same for every row.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "ddp_srb.cuh"

namespace {

constexpr int ROWS = 32;          // rows a warp stages at once, a lane each

template <typename T> __host__ __device__ constexpr int warps() {
  return sizeof(T) == 4 ? 4 : 2;
}

template <typename T> struct Rows {
  const T *X, *U, *feet, *gait, *xref, *dt;   // (R, 12 | 4 | 1)
  const T *xT, *xrefT, *feetT, *gaitT;        // (B, 12 | 4); xT row stride ldxT
  T *fx, *fu, *lx, *lu, *lxx, *luu, *Vx, *Vxx;
  int R, B, ldxT;
};

// 16 bytes: the unit of the staging and of the stores.
template <typename T> struct alignas(16) Vec { T v[16 / sizeof(T)]; };

// Staged row stride (in 16-byte words) of a tensor W values wide: odd.
template <typename T, int W> __host__ __device__ constexpr int stride16() {
  return (W * (int)sizeof(T) / 16) | 1;
}

template <typename T> __host__ __device__ constexpr size_t warp_smem_bytes() {
  return (size_t)ROWS * stride16<T, NXX>() * 16;
}

template <typename T> __host__ __device__ constexpr size_t block_smem_bytes() {
  return warps<T>() * warp_smem_bytes<T>();
}

// This lane's dense row of a tensor W wide, entry(e) for e < W, into the
// warp's staging buffer. Under the full unroll e is a constant, so the
// entry's branches fold away.
template <int W, typename T, typename F>
__device__ __forceinline__ void stage(T* buf, int lane, F entry) {
  constexpr int V = 16 / sizeof(T);
  Vec<T>* dst = reinterpret_cast<Vec<T>*>(buf) + lane * stride16<T, W>();
#pragma unroll
  for (int k = 0; k < W / V; ++k) {
    Vec<T> c;
#pragma unroll
    for (int j = 0; j < V; ++j) c.v[j] = entry(k * V + j);
    dst[k] = c;
  }
}

// The staged rows [0, nrows) to their contiguous slab at `out`, 16 bytes
// a lane and store.
template <int W, typename T>
__device__ __forceinline__ void flush(const T* buf, T* out, int nrows,
                                      int lane) {
  constexpr int CPR = W * (int)sizeof(T) / 16;
  const Vec<T>* src = reinterpret_cast<const Vec<T>*>(buf);
  Vec<T>* dst = reinterpret_cast<Vec<T>*>(out);
  __syncwarp();
  for (int c = lane; c < nrows * CPR; c += 32) {
    const int r = c / CPR;
    dst[c] = src[r * stride16<T, W>() + (c - r * CPR)];
  }
  __syncwarp();
}

template <typename T>
__device__ __forceinline__ T tie_weight(T r) {
  return r > T(0) ? T(1) : (r == T(0) ? T(0.5) : T(0));
}

// M skew(v).
template <typename T>
__device__ __forceinline__ void mul_skew(const T (&M)[3][3], T v0, T v1,
                                         T v2, T (&out)[3][3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    out[r][0] = M[r][1] * v2 - M[r][2] * v1;
    out[r][1] = M[r][2] * v0 - M[r][0] * v2;
    out[r][2] = M[r][0] * v1 - M[r][1] * v0;
  }
}

// The state terms' gradient l (12) and, in (x, y, z, yaw), the shoulder
// penalty's Hessian H; the tracking term's Hessian is diag(w^2).
template <typename T>
__device__ __forceinline__ void state_cost(const Params<T>& p,
                                           const T (&x)[NX],
                                           const T (&xr)[NX],
                                           const T (&ft)[NX], const T (&g)[4],
                                           T (&l)[NX], T (&H)[4][4]) {
#pragma unroll
  for (int k = 0; k < NX; ++k) l[k] = p.w[k] * p.w[k] * (x[k] - xr[k]);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) H[a][b] = T(0);
  T s, c;
  sin_cos(x[5], &s, &c);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T ax = c * p.sx[i] - s * p.sy[i], ay = s * p.sx[i] + c * p.sy[i];
    const T ex = x[0] + ax - ft[3 * i], ey = x[1] + ay - ft[3 * i + 1];
    const T ez = x[2];
    const T d = sqrt(ex * ex + ey * ey + ez * ez + p.eps);
    const T r = d - p.hlim;
    if (r < T(0)) continue;          // below the limit: no term (NaN goes on)
    const T wgt = p.w_sh * g[i] * g[i], m = tie_weight(r);
    const T gd[4] = {ex / d, ey / d, ez / d, (ey * ax - ex * ay) / d};
    // J'J + sum_k e_k Hess(e_k), J = d(ex, ey, ez)/d(x, y, z, yaw)
    const T h0[4][4] = {{T(1), T(0), T(0), -ay},
                        {T(0), T(1), T(0), ax},
                        {T(0), T(0), T(1), T(0)},
                        {-ay, ax, T(0), ax * ax + ay * ay - ex * ax - ey * ay}};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const T gg = gd[a] * gd[b];
        H[a][b] += wgt * (m * m * gg + r * ((h0[a][b] - gg) / d));
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) l[a == 3 ? 5 : a] += wgt * r * gd[a];
  }
}

// Entry (i, j) of diag(w^2) + H placed at (x, y, z, yaw).
template <typename T>
__device__ __forceinline__ T state_hess(const Params<T>& p,
                                        const T (&H)[4][4], int e) {
  const int i = e / NX, j = e % NX;
  const int qi = i < 3 ? i : (i == 5 ? 3 : -1);
  const int qj = j < 3 ? j : (j == 5 ? 3 : -1);
  T v = i == j ? p.w[i] * p.w[i] : T(0);
  if (qi >= 0 && qj >= 0) v += H[qi][qj];
  return v;
}

template <typename T>
__device__ __forceinline__ void load(T (&out)[NX], const T* src) {
#pragma unroll
  for (int k = 0; k < NX; ++k) out[k] = __ldg(src + k);
}

template <typename T>
__device__ __forceinline__ void load4(T (&out)[4], const T* src) {
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = __ldg(src + k);
}

template <typename T>
__device__ __forceinline__ void node_rows(const Params<T>& p,
                                          const Rows<T>& a, T* buf,
                                          int row0, int lane) {
  const int nrows = min(ROWS, a.R - row0);
  const size_t row = (size_t)row0 + min(lane, nrows - 1);
  T x[NX], u[NX], ft[NX], xr[NX], g[4];
  load(x, a.X + row * NX);
  load(u, a.U + row * NX);
  load(ft, a.feet + row * NX);
  load(xr, a.xref + row * NX);
  load4(g, a.gait + row * 4);
  const T dt = __ldg(a.dt + row);
  const bool implicit = p.flags & IMPLICIT;
  const size_t o12 = (size_t)row0 * NX, o144 = (size_t)row0 * NXX;

  {  // dynamics: fx, fu
    const T yaw = (p.flags & NONLINEAR) ? x[5] : xr[5];
    T s, c;
    sin_cos(yaw, &s, &c);
    T Ii[3][3];
    inv_inertia(p, s, c, Ii);

    T f[3] = {T(0), T(0), T(0)}, tau[3] = {T(0), T(0), T(0)};
    T Bu[4][3][3], gm[4];
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
      mul_skew(Ii, l0, l1, l2, Bu[i]);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k) Bu[i][r][k] *= g[i];
      gm[i] = g[i] / p.mass;
    }
    T A[3][3], Ay[3] = {T(0), T(0), T(0)};
    mul_skew(Ii, f[0], f[1], f[2], A);
    if (p.flags & NONLINEAR) {
      T t[3], b[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        t[r] = Ii[r][0] * tau[0] + Ii[r][1] * tau[1] + Ii[r][2] * tau[2];
        b[r] = -Ii[r][0] * tau[1] + Ii[r][1] * tau[0];   // I^-1 S tau
      }
      Ay[0] = -t[1] - b[0];
      Ay[1] = t[0] - b[1];
      Ay[2] = -b[2];
    }
    const T dt2 = dt * dt;
    // d(angular acceleration)_r / dx_j
    auto dax = [&](int r, int j) -> T {
      return j < 3 ? A[r][j] : (j == 5 ? Ay[r] : T(0));
    };
    stage<NXX>(buf, lane, [&](int e) -> T {
      const int i = e / NX, j = e % NX;
      T v = i == j ? T(1) : T(0);
      if (i < 6 && j == i + 6) v += dt;
      if (i >= 9) v += dt * dax(i - 9, j);
      if (i >= 3 && i < 6 && implicit) v += dt2 * dax(i - 3, j);
      return v;
    });
    flush<NXX>(buf, a.fx + o144, nrows, lane);
    stage<NXX>(buf, lane, [&](int e) -> T {
      const int i = e / NX, j = e % NX, ft_ = j / 3, k = j % 3;
      if (i >= 6 && i < 9) return k == i - 6 ? dt * gm[ft_] : T(0);
      if (i >= 9) return dt * Bu[ft_][i - 9][k];
      if (!implicit) return T(0);
      if (i < 3) return k == i ? dt2 * gm[ft_] : T(0);
      return dt2 * Bu[ft_][i - 3][k];
    });
    flush<NXX>(buf, a.fu + o144, nrows, lane);
  }

  {  // the state terms: lx, lxx
    T l[NX], H[4][4];
    state_cost(p, x, xr, ft, g, l, H);
    stage<NX>(buf, lane, [&](int e) -> T { return l[e]; });
    flush<NX>(buf, a.lx + o12, nrows, lane);
    stage<NXX>(buf, lane, [&](int e) -> T { return state_hess(p, H, e); });
    flush<NXX>(buf, a.lxx + o144, nrows, lane);
  }

  {  // the force terms: lu, luu
    T lu[NX], dg[4][3], xz[4], yz[4];
    const T n_c = fmax(g[0] + g[1] + g[2] + g[3], T(1));
    const T fz_ref = p.mg / n_c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const T gg = g[i] * g[i], wf = p.w_f2 * gg, wc = p.w_fr * gg;
      const T fx = u[3 * i], fy = u[3 * i + 1], fz = u[3 * i + 2];
      const T zref = (p.flags & RELATIVE) ? fz_ref * g[i] : T(0);
      const T mf = mul_rn(p.mu, fz);
      const T r[6] = {fx - mf, -fx - mf, fy - mf, -fy - mf, p.min_fz - fz,
                      fz - p.fz_max};
      T rl[6], q[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        rl[k] = r[k] > T(0) ? r[k] : T(0);
        const T m = tie_weight(r[k]);
        q[k] = m * m;
      }
      lu[3 * i] = wf * fx + wc * (rl[0] - rl[1]);
      lu[3 * i + 1] = wf * fy + wc * (rl[2] - rl[3]);
      lu[3 * i + 2] = wf * (fz - zref) +
                      wc * (-p.mu * (rl[0] + rl[1] + rl[2] + rl[3]) - rl[4] +
                            rl[5]);
      dg[i][0] = wf + wc * (q[0] + q[1]);
      dg[i][1] = wf + wc * (q[2] + q[3]);
      dg[i][2] = wf + wc * (p.mu * p.mu * (q[0] + q[1] + q[2] + q[3]) +
                            q[4] + q[5]);
      xz[i] = wc * p.mu * (q[1] - q[0]);
      yz[i] = wc * p.mu * (q[3] - q[2]);
    }
    stage<NX>(buf, lane, [&](int e) -> T { return lu[e]; });
    flush<NX>(buf, a.lu + o12, nrows, lane);
    stage<NXX>(buf, lane, [&](int e) -> T {
      const int i = e / NX, j = e % NX, f = i / 3, r = i % 3, k = j % 3;
      if (j / 3 != f) return T(0);
      if (r == k) return dg[f][r];
      if (r + k == 2) return xz[f];          // (x, z), (z, x)
      if (r + k == 3) return yz[f];          // (y, z), (z, y)
      return T(0);
    });
    flush<NXX>(buf, a.luu + o144, nrows, lane);
  }
}

template <typename T>
__device__ __forceinline__ void terminal_rows(const Params<T>& p,
                                              const Rows<T>& a, T* buf,
                                              int row0, int lane) {
  const int nrows = min(ROWS, a.B - row0);
  const size_t row = (size_t)row0 + min(lane, nrows - 1);
  T x[NX], ft[NX], xr[NX], g[4], l[NX], H[4][4];
  load(x, a.xT + row * a.ldxT);
  load(xr, a.xrefT + row * NX);
  load(ft, a.feetT + row * NX);
  load4(g, a.gaitT + row * 4);
  state_cost(p, x, xr, ft, g, l, H);
  stage<NX>(buf, lane, [&](int e) -> T { return l[e]; });
  flush<NX>(buf, a.Vx + (size_t)row0 * NX, nrows, lane);
  stage<NXX>(buf, lane, [&](int e) -> T { return state_hess(p, H, e); });
  flush<NXX>(buf, a.Vxx + (size_t)row0 * NXX, nrows, lane);
}

template <typename T>
__global__ void __launch_bounds__(128)
ddp_derivs_kernel(const Params<T> p, const Rows<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* buf = reinterpret_cast<T*>(smem + warp * warp_smem_bytes<T>());
  const int node_groups = (a.R + ROWS - 1) / ROWS;
  const int groups = node_groups + (a.B + ROWS - 1) / ROWS;
  for (int grp = blockIdx.x * warps<T>() + warp; grp < groups;
       grp += gridDim.x * warps<T>()) {
    if (grp < node_groups)
      node_rows(p, a, buf, grp * ROWS, lane);
    else
      terminal_rows(p, a, buf, (grp - node_groups) * ROWS, lane);
  }
}

// Blocks an SM holds (the occupancy query, with the shared-memory
// attribute set first), per device and type.
template <typename T>
int blocks_per_sm(int* blocks) {
  static int cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return -1;
  if (cached[dev] == 0) {
    e = cudaFuncSetAttribute(ddp_derivs_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)block_smem_bytes<T>());
    if (e != cudaSuccess) return (int)e;
    int n = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, ddp_derivs_kernel<T>, warps<T>() * 32, block_smem_bytes<T>());
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return -1;
    cached[dev] = n * 1024 + sms;    // both, packed
  }
  *blocks = cached[dev];
  return 0;
}

template <typename T>
int launch(const double* prm, int flags, const Rows<T>& a,
           cudaStream_t stream) {
  int packed = 0;
  const int e = blocks_per_sm<T>(&packed);
  if (e != 0) return e;
  const int per_sm = packed / 1024, sms = packed % 1024;
  const long groups = (a.R + ROWS - 1) / ROWS + (a.B + ROWS - 1) / ROWS;
  const long want = (groups + warps<T>() - 1) / warps<T>();
  const int grid = (int)(want < (long)per_sm * sms ? want : per_sm * sms);
  ddp_derivs_kernel<T><<<grid, warps<T>() * 32, block_smem_bytes<T>(),
                         stream>>>(params<T>(prm, flags), a);
  return (int)cudaGetLastError();
}

template <typename T>
Rows<T> rows(const void* X, const void* U, const void* feet,
             const void* gait, const void* xref, const void* dt,
             const void* xT, const void* xrefT, const void* feetT,
             const void* gaitT, void* fx, void* fu, void* lx, void* lu,
             void* lxx, void* luu, void* Vx, void* Vxx, int R, int B,
             int ldxT) {
  return Rows<T>{(const T*)X,     (const T*)U,     (const T*)feet,
                 (const T*)gait,  (const T*)xref,  (const T*)dt,
                 (const T*)xT,    (const T*)xrefT, (const T*)feetT,
                 (const T*)gaitT, (T*)fx,          (T*)fu,
                 (T*)lx,          (T*)lu,          (T*)lxx,
                 (T*)luu,         (T*)Vx,          (T*)Vxx,
                 R,               B,               ldxT};
}

}  // namespace

extern "C" {

// Blocks of the kernel an SM holds for elements of `itemsize` bytes (4:
// float, 8: double), in *blocks. Returns a CUDA error code, or -1.
int qrw_ddp_derivs_blocks(int itemsize, int* blocks) {
  int packed = 0;
  const int e = itemsize == 4   ? blocks_per_sm<float>(&packed)
                : itemsize == 8 ? blocks_per_sm<double>(&packed)
                                : -1;
  if (e == 0) *blocks = packed / 1024;
  return e;
}

// One launch on `stream` over the R node rows and the B terminal rows;
// every pointer is a device pointer to `itemsize`-byte floats laid out as
// core/mpc_ddp._srb_derivs documents, `prm` a host array of N_PARAMS
// doubles, `flags` the model toggles. Returns cudaGetLastError(), or -1
// for arguments out of range.
int qrw_ddp_derivs(int itemsize, const double* prm, int flags,
                   const void* X, const void* U, const void* feet,
                   const void* gait, const void* xref, const void* dt,
                   const void* xT, const void* xrefT, const void* feetT,
                   const void* gaitT, void* fx, void* fu, void* lx, void* lu,
                   void* lxx, void* luu, void* Vx, void* Vxx, int R, int B,
                   int ldxT, void* stream) {
  if (R < 1 || B < 1 || ldxT < NX || prm == nullptr) return -1;
  const cudaStream_t s = (cudaStream_t)stream;
  if (itemsize == 4)
    return launch<float>(prm, flags,
                         rows<float>(X, U, feet, gait, xref, dt, xT, xrefT,
                                     feetT, gaitT, fx, fu, lx, lu, lxx, luu,
                                     Vx, Vxx, R, B, ldxT),
                         s);
  if (itemsize == 8)
    return launch<double>(prm, flags,
                          rows<double>(X, U, feet, gait, xref, dt, xT, xrefT,
                                       feetT, gaitT, fx, fu, lx, lu, lxx, luu,
                                       Vx, Vxx, R, B, ldxT),
                          s);
  return -1;
}

}  // extern "C"
