// Fused cross-scan forward for Hopper (sm_90a): the projections of each scan
// direction and its selective scan in one kernel.
//
// Replaces the TPU kernel `_cross_scan_pallas_fwd`
// (nnuzoo_tpu/ops/cross_scan.py, body `_fwd_kernel` with its prologue
// `_projections`). It computes the same function (contract and geometry in
// cross_scan_common.cuh); the TPU kernel's batch lane packing, its
// BlockSpec-mirrored chunk walk and its sequential grid do not carry over.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores):
// a step of one channel reads u (4 bytes) and writes y (4 bytes), against
// C = R+2N multiply-adds of the projection (x_dbl is shared by a direction's
// Dh channels: C a channel), R for dt_proj, ~4 for softplus and the D term,
// and N states of ~7 operations each (exp, 2 mul and 1 fma for the state, 1
// fma for y): 2*33 + 2 + 4 + 112 = 184 operations for 8 bytes at M2NetP
// (R=1, N=16), 23 a byte, above the card's 20. So the function is bound by
// operations, narrowly: at B=12, L=57344, G=2, Dh=32 it moves 0.35 GB
// (0.105 ms at the full rate) and does 8.1 GFLOP (0.121 ms).
//
// Design. K1's chunk-parallel plan (csrc/selective_scan_fwd.cu), with the
// chunk's operands made in the kernel instead of read: a block is one
// (chunk, direction, batch) with one thread a channel. It walks its chunk in
// tiles of T steps: the tile's u rows go to shared memory, one thread per
// x_dbl output sums over Dh (rows padded to Dh+1 against bank conflicts, wx
// staged once), then each thread runs its channel's T steps with delta from
// the tile's dt values, B and C as broadcast reads of shared memory, and the
// N states in registers. delta, B, C, exp(delta*A) and the flipped sequences
// never reach device memory.
//   pass 1 (chunk_kernel<R, false>): each chunk's end state from a zero
//          entry state, and the sum of delta over the chunk;
//   pass 2 (carry_kernel): the state entering each chunk, in traversal order
//          (the decay across a chunk is exp(A * sum(delta)));
//   pass 3 (chunk_kernel<R, true>): each chunk from its entry state, writing
//          y. The entry states stay as the carries the backward starts from.
// With one chunk, passes 1 and 2 are skipped. Passes 1 and 3 both make the
// projections, so the operations are done twice where there is more than
// one chunk; a single pass with a look-back across chunks would remove that.
// On an H100 (700 W) at that shape a call takes 1.95 ms, 16x the bound, in
// either orientation (chip_smoke.py).

#include "cross_scan_common.cuh"

namespace {

using namespace cross_scan;

constexpr int kTile = 16;       // steps a projection tile

template <int R, bool kOutput>
__global__ void __launch_bounds__(kMaxDh)
chunk_kernel(Streams streams, const float* __restrict__ wx,
             const float* __restrict__ wdt, const float* __restrict__ dtb,
             const float* __restrict__ A, const float* __restrict__ Ds,
             float* __restrict__ y, float* __restrict__ states,
             float* __restrict__ dsum, int L, int G, int Dh, int chunk,
             int nchunks, int reverse) {
  constexpr int C = R + 2 * kN;
  extern __shared__ float smem[];
  float* wx_s = smem;
  float* u_s = wx_s + C * (Dh + 1);
  float* xd_s = u_s + kTile * (Dh + 1);

  const int i = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int d = threadIdx.x;
  const int GD = G * Dh;
  const int c = g * Dh + d;
  load_wx<C>(wx + (size_t)g * C * Dh, wx_s, Dh);

  float a2[kN];
  float h[kN];
  float wdt_r[R];
#pragma unroll
  for (int n = 0; n < kN; ++n) a2[n] = A[c * kN + n] * kLog2e;
#pragma unroll
  for (int r = 0; r < R; ++r) wdt_r[r] = wdt[c * R + r];
  const float bias = dtb[c];
  const float dd = Ds[c];
  // states[b, i, n, c]
  const size_t st = ((size_t)b * nchunks + i) * kN * (size_t)GD + c;
#pragma unroll
  for (int n = 0; n < kN; ++n)
    h[n] = (kOutput && states != nullptr) ? states[st + (size_t)n * GD] : 0.f;

  const float* stream = streams.p[g] + (size_t)b * L * Dh;
  const int s0 = i * chunk;
  const int s1 = min(s0 + chunk, L);
  float ds = 0.f;
  for (int t0 = s0; t0 < s1; t0 += kTile) {
    const int tl = min(kTile, s1 - t0);
    project_tile<C>(stream, wx_s, u_s, xd_s, t0, tl, L, Dh, reverse);
    for (int j = 0; j < tl; ++j) {
      const float* xr = xd_s + j * C;
      const float delta = step_delta<R>(xr, wdt_r, bias);
      const float uv = u_s[j * (Dh + 1) + d];
      const float du = delta * uv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        h[n] = exp2f(delta * a2[n]) * h[n] + du * xr[R + n];
        acc = fmaf(xr[R + kN + n], h[n], acc);
      }
      if (kOutput) {
        const int p = position(t0 + j, L, reverse);
        y[((size_t)b * L + p) * GD + c] = fmaf(dd, uv, acc);
      } else {
        ds += delta;
      }
    }
  }
  if (!kOutput) {
#pragma unroll
    for (int n = 0; n < kN; ++n) states[st + (size_t)n * GD] = h[n];
    dsum[((size_t)b * nchunks + i) * GD + c] = ds;
  }
}

template <int R>
cudaError_t run(Streams streams, const float* wx, const float* wdt,
                const float* dtb, const float* A, const float* Ds, float* y,
                float* states, float* dsum, int batch, int L, int G, int Dh,
                int chunk, bool reverse, cudaStream_t stream) {
  const int nchunks = (L + chunk - 1) / chunk;
  const dim3 grid(nchunks, G, batch);
  const size_t smem = sizeof(float) * projection_floats(R + 2 * kN, Dh, kTile);
  cudaError_t err;
  if (nchunks > 1) {
    err = allow_smem(chunk_kernel<R, false>, smem);
    if (err != cudaSuccess) return err;
    chunk_kernel<R, false><<<grid, Dh, smem, stream>>>(
        streams, wx, wdt, dtb, A, Ds, y, states, dsum, L, G, Dh, chunk, nchunks,
        reverse);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = launch_carry(A, states, dsum, batch, G * Dh, nchunks, false, stream);
    if (err != cudaSuccess) return err;
  }
  err = allow_smem(chunk_kernel<R, true>, smem);
  if (err != cudaSuccess) return err;
  chunk_kernel<R, true><<<grid, Dh, smem, stream>>>(
      streams, wx, wdt, dtb, A, Ds, y, nchunks > 1 ? states : nullptr, dsum, L,
      G, Dh, chunk, nchunks, reverse);
  return cudaGetLastError();
}

}  // namespace

// Runs the passes on `stream`. s2 is null when G == 2. `states`
// (B, chunks, N, G*Dh) and `dsum` (B, chunks, G*Dh) are scratch that the
// caller allocates (both may be null with one chunk); after the call
// `states` holds the state entering each traversal chunk. Returns the first
// launch error, or cudaSuccess.
extern "C" int nnuzoo_cross_scan_fwd(const float* s0, const float* s1,
                                     const float* s2, const float* wx,
                                     const float* wdt, const float* dtb,
                                     const float* A, const float* Ds, float* y,
                                     float* states, float* dsum, int batch, int L,
                                     int G, int Dh, int R, int N, int chunk,
                                     int reverse, void* stream_handle) {
  if (N != kN || G < 1 || G > kMaxG || Dh % 32 != 0 || Dh > kMaxDh || chunk < 1)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const Streams streams{{s0, s1, s2}};
#define CROSS_SCAN_FWD(RV)                                                   \
  return run<RV>(streams, wx, wdt, dtb, A, Ds, y, states, dsum, batch, L, G, \
                 Dh, chunk, reverse != 0, stream)
  CROSS_SCAN_DISPATCH_R(R, CROSS_SCAN_FWD)
#undef CROSS_SCAN_FWD
  return cudaErrorInvalidValue;
}
