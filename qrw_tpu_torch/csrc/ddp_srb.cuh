// The SRB model of core/mpc_ddp as the DDP kernels read it: its constants
// (core/mpc_ddp.derivs_params, N_PARAMS doubles, rounded to the kernel's
// type), the toggles' bit mask (derivs_flags) and the arithmetic the
// derivatives kernel (ddp_derivs.cu) and the line-search kernel
// (ddp_linesearch.cu) share.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NX = 12;            // state and control width
constexpr int NXX = NX * NX;

enum Flags { NONLINEAR = 1, IMPLICIT = 2, RELATIVE = 4 };

// The model's constants, in the order of core/mpc_ddp.derivs_params (its
// N_PARAMS doubles).
template <typename T> struct Params {
  T mass, gravity, com_z, gI[9], w[12], sx[4], sy[4], mu, min_fz, fz_max,
      hlim, w_sh, w_f2, w_fr, eps, mg;
  int flags;
};

template <typename T>
Params<T> params(const double* v, int flags) {
  Params<T> p;
  int k = 0;
  p.mass = (T)v[k++];
  p.gravity = (T)v[k++];
  p.com_z = (T)v[k++];
  for (int i = 0; i < 9; ++i) p.gI[i] = (T)v[k++];
  for (int i = 0; i < 12; ++i) p.w[i] = (T)v[k++];
  for (int i = 0; i < 4; ++i) p.sx[i] = (T)v[k++];
  for (int i = 0; i < 4; ++i) p.sy[i] = (T)v[k++];
  p.mu = (T)v[k++];
  p.min_fz = (T)v[k++];
  p.fz_max = (T)v[k++];
  p.hlim = (T)v[k++];
  p.w_sh = (T)v[k++];
  p.w_f2 = (T)v[k++];
  p.w_fr = (T)v[k++];
  p.eps = (T)v[k++];
  p.mg = (T)v[k++];
  p.flags = flags;
  return p;
}

__device__ __forceinline__ void sin_cos(float a, float* s, float* c) {
  sincosf(a, s, c);
}
__device__ __forceinline__ void sin_cos(double a, double* s, double* c) {
  sincos(a, s, c);
}
// Products and differences that the compiler may not fuse into an FMA.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// Ii = (Rz gI Rz')^-1 for the yaw whose sine and cosine are s, c: the
// inertia rotated into the world frame and inverted by its cofactors.
template <typename T>
__device__ __forceinline__ void inv_inertia(const Params<T>& p, T s, T c,
                                            T (&Ii)[3][3]) {
  const T Rz[3][3] = {{c, -s, T(0)}, {s, c, T(0)}, {T(0), T(0), T(1)}};
  T M[3][3], I[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      M[r][k] = Rz[r][0] * p.gI[k] + Rz[r][1] * p.gI[3 + k] +
                Rz[r][2] * p.gI[6 + k];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      I[r][k] = M[r][0] * Rz[k][0] + M[r][1] * Rz[k][1] + M[r][2] * Rz[k][2];
  const T c00 = I[1][1] * I[2][2] - I[1][2] * I[2][1];
  const T c01 = I[1][2] * I[2][0] - I[1][0] * I[2][2];
  const T c02 = I[1][0] * I[2][1] - I[1][1] * I[2][0];
  const T inv_det = T(1) / (I[0][0] * c00 + I[0][1] * c01 + I[0][2] * c02);
  Ii[0][0] = c00 * inv_det;
  Ii[1][0] = c01 * inv_det;
  Ii[2][0] = c02 * inv_det;
  Ii[0][1] = (I[0][2] * I[2][1] - I[0][1] * I[2][2]) * inv_det;
  Ii[1][1] = (I[0][0] * I[2][2] - I[0][2] * I[2][0]) * inv_det;
  Ii[2][1] = (I[0][1] * I[2][0] - I[0][0] * I[2][1]) * inv_det;
  Ii[0][2] = (I[0][1] * I[1][2] - I[0][2] * I[1][1]) * inv_det;
  Ii[1][2] = (I[0][2] * I[1][0] - I[0][0] * I[1][2]) * inv_det;
  Ii[2][2] = (I[0][0] * I[1][1] - I[0][1] * I[1][0]) * inv_det;
}

}  // namespace
