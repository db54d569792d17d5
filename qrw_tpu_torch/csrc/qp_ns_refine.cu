// Newton-Schulz refinement of a batch of KKT inverses, one problem a block:
// K3's general variant, for any n. The full-size MPC path's n = 192 takes
// the tensor-core variant in qp_ns_refine_tc.cu; the wrapper
// (qrw_tpu_torch/ops/qp_pallas.py::ns_variant) picks by n.
//
// Replaces the TPU kernel qrw_tpu/ops/qp_pallas.py::_ns_refine_kernel
// (Pallas, launched by qrw_tpu.ops.qp_pallas._ns_refine). Per problem, with
// K and a seed X0 (both n x n, row-major), `ns_iters` steps of
//
//   KX = K X;  X = 2 X - X KX
//
// then resid = max |K X - I| over the n^2 entries (NaN propagates, as
// jnp.max lets it). ns_iters = 0 computes only the residual of the seed.
// The wrapper (qrw_tpu_torch/ops/qp_pallas.py::_ns_launch) re-centres X
// as 0.5 (X + X') afterwards, as the JAX package does outside its kernel.
//
// What bounds it on the H100: operations. Each step is two dense products
// and the residual one more, 2 n^3 flop each: at n = 192, 14.2 Mflop a
// product, 99 Mflop a problem at ns_iters = 3. At B = 4096 that is
// 406 Gflop, 6.06 ms at the card's 67 Tflop/s of float32 outside the
// tensor cores, against 1.81 GB of K, X0 and X (0.54 ms at 3.35 TB/s).
//
// What this first design does about it:
// * One block per problem, the TPU kernel's unit, with the iterations
//   looped inside: any batch, no padding, one launch a call. K and X
//   (147 kB each at n = 192) do not fit a block's shared memory together,
//   so the products stream through shared memory in tiles: for each
//   64 x 64 output tile, 64 x 32 panels of the left factor and 32 x 64
//   panels of the right factor, 256 threads each accumulating a 4 x 4
//   sub-tile with FMAs in float32 (no TF32, no fast-math).
// * K X and the next iterate go to a per-problem scratch in device memory
//   that the wrapper allocates, (B, 2, n, n); the iterate ping-pongs
//   between the scratch and the output so the last step lands in the
//   output. A block barrier after every product makes its writes visible
//   to the next product of the same block.
// * The residual product stores nothing: its epilogue takes |KX - I| and
//   a NaN-propagating max over the block.
// * The left panel is stored transposed with a stride of 65 so that the
//   panel loads (consecutive threads on consecutive k) hit 32 different
//   banks; the right panel is read as float4 across the 4 columns of a
//   thread's sub-tile.
// This first design runs at 34% of the float32 bound above (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md); n = 192 has the faster variant.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TM = 64;       // output tile edge
constexpr int TK = 32;       // depth of a panel
constexpr int NT = 256;      // threads a block: 16 x 16, 4 x 4 outputs each

enum Epilogue { kStore, kNewton, kResid };

// max that propagates NaN from either side (as jnp.max / torch.amax)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

struct Panels {
  float a[TK][TM + 1];                 // left panel, transposed: a[k][row]
  __align__(16) float b[TK][TM];       // right panel: b[k][col]
};

// One product L R of n x n row-major matrices, tile by tile.
//   kStore:  C = L R
//   kNewton: C = 2 L - L R   (L = X, R = K X)
//   kResid:  returns this thread's max |L R - I|; C is not touched.
// L, R and C are not __restrict__: they may be scratch written earlier in
// the same launch, which the read-only cache path must not serve.
template <int EPI>
__device__ float product(const float* L, const float* R, float* C, int n,
                         Panels& s) {
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  float res = 0.f;
  const int tiles = (n + TM - 1) / TM;
  for (int ti = 0; ti < tiles; ++ti) {
    for (int tj = 0; tj < tiles; ++tj) {
      const int row0 = ti * TM, col0 = tj * TM;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < n; k0 += TK) {
        __syncthreads();  // the previous panels are no longer read
#pragma unroll
        for (int e = 0; e < TM * TK / NT; ++e) {
          const int idx = tid + e * NT;
          const int r = idx / TK, kk = idx % TK;
          const int gr = row0 + r, gk = k0 + kk;
          s.a[kk][r] = (gr < n && gk < n) ? L[(size_t)gr * n + gk] : 0.f;
        }
#pragma unroll
        for (int e = 0; e < TM * TK / NT; ++e) {
          const int idx = tid + e * NT;
          const int kk = idx / TM, c = idx % TM;
          const int gk = k0 + kk, gc = col0 + c;
          s.b[kk][c] = (gk < n && gc < n) ? R[(size_t)gk * n + gc] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < TK; ++kk) {
          const float4 bv = *reinterpret_cast<const float4*>(&s.b[kk][tx * 4]);
          const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float av = s.a[kk][ty * 4 + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, bb[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gr = row0 + ty * 4 + i;
        if (gr >= n) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gc = col0 + tx * 4 + j;
          if (gc >= n) continue;
          const size_t o = (size_t)gr * n + gc;
          if (EPI == kStore) {
            C[o] = acc[i][j];
          } else if (EPI == kNewton) {
            C[o] = 2.0f * L[o] - acc[i][j];
          } else {
            res = nan_max(res, fabsf(acc[i][j] - (gr == gc ? 1.0f : 0.0f)));
          }
        }
      }
    }
  }
  return res;
}

// NaN-propagating max over the block; every thread gets the result.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NT / 32; ++w) r = nan_max(r, red[w]);
  return r;
}

__global__ void __launch_bounds__(NT)
ns_refine_kernel(const float* __restrict__ K_g, const float* __restrict__ X0_g,
                 float* X_g, float* scratch, float* __restrict__ resid,
                 int n, int ns_iters) {
  __shared__ Panels s;
  __shared__ float red[NT / 32];
  const size_t b = blockIdx.x, nn = (size_t)n * n;
  const float* K = K_g + b * nn;
  const float* X = X0_g + b * nn;
  float* out = X_g + b * nn;
  float* KX = scratch + 2 * b * nn;
  float* T = KX + nn;

  if (ns_iters == 0) {
    for (size_t i = threadIdx.x; i < nn; i += NT) out[i] = X[i];
  }
  for (int it = 0; it < ns_iters; ++it) {
    product<kStore>(K, X, KX, n, s);
    __syncthreads();  // K X complete and visible to the block
    float* dst = ((ns_iters - 1 - it) % 2 == 0) ? out : T;
    product<kNewton>(X, KX, dst, n, s);
    __syncthreads();
    X = dst;
  }
  const float r = block_max(product<kResid>(K, X, nullptr, n, s), red);
  if (threadIdx.x == 0) resid[b] = r;
}

}  // namespace

extern "C" {

// All pointers are device pointers: K, X0, X (B, n, n); scratch (B, 2, n,
// n); resid (B,). Launches on `stream` and returns cudaGetLastError().
int qrw_ns_refine(const float* K, const float* X0, float* X, float* scratch,
                  float* resid, int B, int n, int ns_iters, void* stream) {
  ns_refine_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(K, X0, X, scratch,
                                                       resid, n, ns_iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
