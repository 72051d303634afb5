// Shared by cross_scan_fwd.cu (K3) and cross_scan_bwd.cu (K4): the
// contract, the chunks of the backward and the helpers both kernels use.
//
// Contract, every tensor fp32 and contiguous, for G axis orders ("streams"):
//   stream g : (B, L, Dh)        the conv output in the g-th axis order
//   wx       : (G, C, Dh)        x_proj weight, C = R + 2N rows [dt | B | C]
//   wdt      : (G, Dh, R)        dt_proj weight
//   dtb      : (G, Dh)           dt_proj bias
//   A        : (G*Dh, N)         already negated, row g*Dh + d
//   Ds       : (G*Dh)
//   y        : (B, L, G*Dh)      natural order, direction g in [g*Dh, (g+1)*Dh)
// For direction g, channel d (c = g*Dh + d) and traversal step s:
//   x_dbl_s = wx[g] u_s  (C values: dt_s (R), B_s (N), C_s (N))
//   delta_s = softplus(wdt[g, d] . dt_s + dtb[g, d])
//   h_s[n]  = exp(delta_s A[c, n]) h_{s-1}[n] + delta_s u_s[d] B_s[n],  h_{-1} = 0
//   y[p(s), c] = sum_n C_s[n] h_s[n] + Ds[c] u_s[d]
// where p(s) = s, or L-1-s with `reverse`: a reverse scan is the same scan
// walked from the right, so no flipped copy exists.
//
// Chunks. The backward (K4) cuts L into chunks of `chunk` steps in TRAVERSAL
// order (chunk i holds steps [i*chunk, min((i+1)*chunk, L)), so with
// `reverse` the short last chunk sits at the start of L); one of its blocks
// is one (chunk i, direction g, batch b), grid (chunks, G, B), with Dh
// threads: thread d owns channel d and keeps its N states in registers. The
// forward (K3) writes the state entering each such chunk ("carries", indexed
// by the traversal chunk i), which K4 starts its chunks from.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace cross_scan {

constexpr int kN = 16;          // d_state: the states live in registers
constexpr int kMaxR = 8;        // dt_rank taken (1 at M2NetP, 8 at M2Net)
constexpr int kMaxG = 3;        // axis orders (2 in SS2D, 3 in 3D SSND)
constexpr int kMaxDh = 256;     // threads a block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

struct Streams {
  const float* p[kMaxG];
};
struct OutStreams {
  float* p[kMaxG];
};

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ int position(int s, int L, bool reverse) {
  return reverse ? L - 1 - s : s;
}

// delta of channel d at one step (xr = that step's x_dbl row, dt first).
template <int R>
__device__ __forceinline__ float step_delta(const float* xr, const float* wdt_r,
                                            float bias) {
  float raw = bias;
#pragma unroll
  for (int r = 0; r < R; ++r) raw = fmaf(xr[r], wdt_r[r], raw);
  return softplus(raw);
}

// Dynamic shared memory above 48 KB must be asked for per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The backward's carry pass over chunks (the adjoint, walked from the right;
// `from_right` 0 walks a state from the left): one thread per (batch, n,
// channel c of G*Dh). `v` holds each chunk's contribution from a zero entry
// (the backward's entry adjoints); the decay across chunk i is
// exp(A[c, n] * dsum[b, i, c]). After the pass v[b, i] holds what enters
// chunk i from the chunks walked before it.
__global__ void __launch_bounds__(128)
carry_kernel(const float* __restrict__ A, float* __restrict__ v,
             const float* __restrict__ dsum, int batch, int GD, int nchunks,
             int from_right) {
  const size_t idx = (size_t)blockIdx.x * 128 + threadIdx.x;
  if (idx >= (size_t)batch * kN * GD) return;
  const int c = (int)(idx % GD);
  const int n = (int)((idx / GD) % kN);
  const int b = (int)(idx / ((size_t)GD * kN));
  const float a2 = A[c * kN + n] * kLog2e;
  float h = 0.f;
  for (int k = 0; k < nchunks; ++k) {
    const int i = from_right ? nchunks - 1 - k : k;
    const size_t row = (size_t)b * nchunks + i;
    const size_t off = (row * kN + n) * GD + c;
    const float own = v[off];
    v[off] = h;
    h = exp2f(a2 * dsum[row * GD + c]) * h + own;
  }
}

inline cudaError_t launch_carry(const float* A, float* v, const float* dsum,
                                int batch, int GD, int nchunks, bool from_right,
                                cudaStream_t stream) {
  const size_t threads = (size_t)batch * kN * GD;
  carry_kernel<<<(unsigned)((threads + 127) / 128), 128, 0, stream>>>(
      A, v, dsum, batch, GD, nchunks, from_right ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace cross_scan

// One case of a switch over the dt rank R (1..kMaxR): F is a macro taking R.
#define CROSS_SCAN_DISPATCH_R(R_VALUE, F)                                    \
  switch (R_VALUE) {                                                         \
    case 1: F(1); break;                                                     \
    case 2: F(2); break;                                                     \
    case 3: F(3); break;                                                     \
    case 4: F(4); break;                                                     \
    case 5: F(5); break;                                                     \
    case 6: F(6); break;                                                     \
    case 7: F(7); break;                                                     \
    case 8: F(8); break;                                                     \
    default: return cudaErrorInvalidValue;                                   \
  }
