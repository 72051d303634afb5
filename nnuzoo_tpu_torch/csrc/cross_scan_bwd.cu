// Fused cross-scan backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_cross_scan_pallas_bwd`
// (nnuzoo_tpu/ops/cross_scan.py, body `_bwd_kernel`). It computes the same
// gradients (contract and geometry in cross_scan_common.cuh); the TPU
// kernel's batch lane packing and its weight-gradient sums carried in VMEM
// from one sequential grid step to the next do not carry over.
//
// With dy (B, L, G*Dh), g_s[n] the adjoint of h_s, traversal step s and
// dA_s[n] = exp(delta_s A[c, n]):
//   g_s        = C_s dy_s + dA_{s+1} g_{s+1}
//   GB         = sum_n g_s B_s,    gh[n] = g_s h_{s-1} dA_s
//   ddelta     = sum_n gh A + u GB,          draw = ddelta (1 - exp(-delta))
//   du         = delta GB + dy Ds + sum_c d_xdbl[c] wx[g, c, d]
//   d_xdbl     = [d_dt | dB | dC]: d_dt[r] = sum_d draw wdt[g, d, r],
//                dB[n] = sum_d g_s delta u,  dC[n] = sum_d h_s dy
//   dwx[g,c,d] = sum d_xdbl[c] u      dwdt[g,d,r] = sum draw dt[r]
//   dtb        = sum draw   dA[c, n] = sum gh delta   dDs = sum dy u
// (the sums without an index run over batch and steps). Outputs: d_stream g
// (B, L, Dh) each, and per (batch, chunk) partials of the five weight
// gradients, which the caller sums with one torch.sum each. No atomics, so
// the sums have one order on every run.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores):
// a step of one channel reads u and dy and writes du (12 bytes), against the
// forward's ~184 operations again to recompute, ~14 a state for the adjoint
// and its sums (112 + 112 at N=16), 2C for dB/dC/d_dt, 2C for du's
// projection term and 2C for dwx, 2R for dwdt: some 610 operations at M2NetP,
// 50 a byte. The function is bound by operations: at B=12, L=57344, G=2,
// Dh=32 it moves 0.53 GB (0.158 ms) and does 27 GFLOP (0.40 ms).
//
// Design. K2's plan (csrc/selective_scan_bwd.cu) on K3's geometry and
// carries, the projections made in the kernel as in K3:
//   pass 1 (adjoint_chunk_kernel): each chunk walked backwards from a zero
//          adjoint: the adjoint of its entry state and its sum of delta;
//   pass 2 (carry_kernel, from the right): the adjoint of each chunk's exit
//          state;
//   pass 3 (grad_chunk_kernel): each chunk from K3's entry state. A forward
//          walk stores the state entering every tile of T steps in global
//          scratch (`ckpt`); then the tiles are taken from the right: the
//          tile's projections again, its T states recomputed into shared
//          memory (a private column per thread), and the steps walked
//          backwards with g in registers. Per step the 2N sums [dB | dC]
//          over a warp's 32 channels are K2's transposing butterfly and the
//          R sums of d_dt are shuffle reductions; with more than one warp a
//          direction, the warps' partials meet in shared memory. After the
//          tile's steps, each thread adds d_xdbl . wx[g, :, d] to du and
//          d_xdbl u to its column of dwx, which stays in registers.
// T is 8 where the shared memory allows (Dh <= 64), fewer at wider Dh
// (grad_tile). With one chunk, passes 1 and 2 are skipped.
// The projections are made three times (passes 1 and 3, and pass 3's
// forward walk). On an H100 (700 W) at the shape above a call takes 7.1 ms,
// 17.6x the bound; pass 3 holds 185 registers a thread at R=1, no spills.

#include "cross_scan_common.cuh"

namespace {

using namespace cross_scan;

constexpr int kTileFwd = 16;          // pass 1's projection tile
constexpr size_t kSmemBudget = 100 * 1024;

// pass 3's shared memory in floats: the projection's, the tile's states
// (T+1, N, Dh), delta and du's direct part (T, Dh) each, the warps' d_xdbl
// partials (T, Dh/32, C) and their sums (T, C)
__host__ __device__ inline int grad_floats(int C, int Dh, int T) {
  return projection_floats(C, Dh, T) + (T + 1) * kN * Dh + 2 * T * Dh +
         T * (Dh / 32) * C + T * C;
}

int grad_tile(int Dh, int R) {
  for (int T = 8; T > 1; T /= 2)
    if (sizeof(float) * grad_floats(R + 2 * kN, Dh, T) <= kSmemBudget) return T;
  return 1;
}

// pass 1: adj[b, i, n, c] = adjoint of the state entering chunk i when the
// adjoint of the state leaving it is zero; dsum[b, i, c] = sum of delta.
template <int R>
__global__ void __launch_bounds__(kMaxDh)
adjoint_chunk_kernel(Streams streams, const float* __restrict__ wx,
                     const float* __restrict__ wdt, const float* __restrict__ dtb,
                     const float* __restrict__ A, const float* __restrict__ dy,
                     float* __restrict__ adj, float* __restrict__ dsum, int L,
                     int G, int Dh, int chunk, int nchunks, int reverse) {
  constexpr int C = R + 2 * kN;
  extern __shared__ float smem[];
  float* wx_s = smem;
  float* u_s = wx_s + C * (Dh + 1);
  float* xd_s = u_s + kTileFwd * (Dh + 1);

  const int i = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int d = threadIdx.x;
  const int GD = G * Dh;
  const int c = g * Dh + d;
  load_wx<C>(wx + (size_t)g * C * Dh, wx_s, Dh);

  float a2[kN];
  float q[kN];
  float wdt_r[R];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a2[n] = A[c * kN + n] * kLog2e;
    q[n] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) wdt_r[r] = wdt[c * R + r];
  const float bias = dtb[c];

  const float* stream = streams.p[g] + (size_t)b * L * Dh;
  const int s0 = i * chunk;
  const int s1 = min(s0 + chunk, L);
  const int ntile = (s1 - s0 + kTileFwd - 1) / kTileFwd;
  float ds = 0.f;
  for (int k = ntile - 1; k >= 0; --k) {
    const int t0 = s0 + k * kTileFwd;
    const int tl = min(kTileFwd, s1 - t0);
    project_tile<C>(stream, wx_s, u_s, xd_s, t0, tl, L, Dh, reverse);
    for (int j = tl - 1; j >= 0; --j) {
      const float* xr = xd_s + j * C;
      const float delta = step_delta<R>(xr, wdt_r, bias);
      const int p = position(t0 + j, L, reverse);
      const float dyv = dy[((size_t)b * L + p) * GD + c];
#pragma unroll
      for (int n = 0; n < kN; ++n)
        q[n] = exp2f(delta * a2[n]) * fmaf(xr[R + kN + n], dyv, q[n]);
      ds += delta;
    }
  }
  const size_t st = ((size_t)b * nchunks + i) * kN * (size_t)GD + c;
#pragma unroll
  for (int n = 0; n < kN; ++n) adj[st + (size_t)n * GD] = q[n];
  dsum[((size_t)b * nchunks + i) * GD + c] = ds;
}

// One butterfly stage: the W values of v shrink to W/2; the lanes whose bit
// W/2 is set keep the upper half.
template <int W>
__device__ __forceinline__ void transpose_reduce_stage(float* v, int lane) {
  constexpr int H = W / 2;
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = upper ? v[k] : v[k + H];
    const float keep = upper ? v[k + H] : v[k];
    v[k] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// pass 3. Partials, blk = b * nchunks + i: da_part (B, chunks, G*Dh, N),
// dwx_part (B, chunks, G, C, Dh), dwdt_part (B, chunks, G, Dh, R),
// dtb_part (B, chunks, G, Dh), dds_part (B, chunks, G*Dh).
template <int R>
__global__ void __launch_bounds__(kMaxDh)
grad_chunk_kernel(Streams streams, const float* __restrict__ wx,
                  const float* __restrict__ wdt, const float* __restrict__ dtb,
                  const float* __restrict__ A, const float* __restrict__ Ds,
                  const float* __restrict__ dy, const float* __restrict__ carries,
                  const float* __restrict__ adj, float* __restrict__ ckpt,
                  OutStreams dstreams, float* __restrict__ da_part,
                  float* __restrict__ dwx_part, float* __restrict__ dwdt_part,
                  float* __restrict__ dtb_part, float* __restrict__ dds_part,
                  int L, int G, int Dh, int chunk, int nchunks, int T,
                  int nsub_max, int reverse) {
  static_assert(2 * kN == 32, "the [dB | dC] butterfly takes 2N == 32");
  constexpr int C = R + 2 * kN;
  const int nw = Dh / 32;
  extern __shared__ float smem[];
  float* wx_s = smem;
  float* u_s = wx_s + C * (Dh + 1);
  float* xd_s = u_s + T * (Dh + 1);
  float* hs = xd_s + T * C;                 // hs[slot][n][d], slot 0 = entry
  float* del_s = hs + (T + 1) * kN * Dh;    // del_s[j][d]
  float* dud_s = del_s + T * Dh;            // dud_s[j][d]
  float* dx_s = dud_s + T * Dh;             // dx_s[j][warp][c]
  float* dxt_s = dx_s + T * nw * C;         // dxt_s[j][c]

  const int i = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int d = threadIdx.x;
  const int lane = d & 31;
  const int w = d >> 5;
  const int GD = G * Dh;
  const int c = g * Dh + d;
  load_wx<C>(wx + (size_t)g * C * Dh, wx_s, Dh);

  float a2[kN];
  float h[kN];
  float wdt_r[R];
  const size_t st = ((size_t)b * nchunks + i) * kN * (size_t)GD + c;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a2[n] = A[c * kN + n] * kLog2e;
    h[n] = carries != nullptr ? carries[st + (size_t)n * GD] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) wdt_r[r] = wdt[c * R + r];
  const float bias = dtb[c];
  const float dd = Ds[c];

  const float* stream = streams.p[g] + (size_t)b * L * Dh;
  float* dstream = dstreams.p[g] + (size_t)b * L * Dh;
  const int s0 = i * chunk;
  const int s1 = min(s0 + chunk, L);
  const int ntile = (s1 - s0 + T - 1) / T;
  // ckpt[b, i, g, k, n, d]: the state entering tile k
  const size_t ck0 = (((size_t)b * nchunks + i) * G + g) * nsub_max;

  // forwards: the state entering each tile
  for (int k = 0; k < ntile; ++k) {
    const size_t ck = (ck0 + k) * kN * (size_t)Dh + d;
#pragma unroll
    for (int n = 0; n < kN; ++n) ckpt[ck + (size_t)n * Dh] = h[n];
    if (k == ntile - 1) break;
    const int t0 = s0 + k * T;
    project_tile<C>(stream, wx_s, u_s, xd_s, t0, T, L, Dh, reverse);
    for (int j = 0; j < T; ++j) {
      const float* xr = xd_s + j * C;
      const float delta = step_delta<R>(xr, wdt_r, bias);
      const float du = delta * u_s[j * (Dh + 1) + d];
#pragma unroll
      for (int n = 0; n < kN; ++n) h[n] = exp2f(delta * a2[n]) * h[n] + du * xr[R + n];
    }
  }

  // backwards over the tiles; q = adjoint of the state leaving the step
  float q[kN];
  float da[kN];
  float dwx[C];
  float dwdt[R];
  float dbias = 0.f;
  float dds = 0.f;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    q[n] = adj != nullptr ? adj[st + (size_t)n * GD] : 0.f;
    da[n] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < C; ++k) dwx[k] = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) dwdt[r] = 0.f;

  for (int k = ntile - 1; k >= 0; --k) {
    const int t0 = s0 + k * T;
    const int tl = min(T, s1 - t0);
    project_tile<C>(stream, wx_s, u_s, xd_s, t0, tl, L, Dh, reverse);
    // the tile's states, from the stored entry state
    const size_t ck = (ck0 + k) * kN * (size_t)Dh + d;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      h[n] = ckpt[ck + (size_t)n * Dh];
      hs[n * Dh + d] = h[n];
    }
    for (int j = 0; j < tl; ++j) {
      const float* xr = xd_s + j * C;
      const float delta = step_delta<R>(xr, wdt_r, bias);
      const float du = delta * u_s[j * (Dh + 1) + d];
      del_s[j * Dh + d] = delta;
      float* slot = hs + (size_t)(j + 1) * kN * Dh + d;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        h[n] = exp2f(delta * a2[n]) * h[n] + du * xr[R + n];
        slot[n * Dh] = h[n];
      }
    }
    // the steps backwards
    for (int j = tl - 1; j >= 0; --j) {
      const float* xr = xd_s + j * C;
      const float delta = del_s[j * Dh + d];
      const float uv = u_s[j * (Dh + 1) + d];
      const float dxu = delta * uv;
      const int p = position(t0 + j, L, reverse);
      const float dyv = dy[((size_t)b * L + p) * GD + c];
      const float* prev = hs + (size_t)j * kN * Dh + d;
      float v[2 * kN];                        // [dB | dC] before the sum over d
      float gb = 0.f;
      float gha = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float gn = fmaf(xr[R + kN + n], dyv, q[n]);
        const float dan = exp2f(delta * a2[n]);
        const float gh = gn * prev[n * Dh] * dan;    // g_s h_{s-1} dA_s
        gha = fmaf(gh, a2[n], gha);
        da[n] = fmaf(gh, delta, da[n]);
        gb = fmaf(gn, xr[R + n], gb);
        q[n] = dan * gn;
        v[n] = gn * dxu;
        v[kN + n] = prev[(kN + n) * Dh] * dyv;       // h_s dy_s (the next slot)
      }
      const float ddelta = fmaf(gha, kLn2, uv * gb);
      const float draw = ddelta * -expm1f(-delta);    // softplus' = 1 - exp(-delta)
      dud_s[j * Dh + d] = fmaf(delta, gb, dyv * dd);
      dds = fmaf(dyv, uv, dds);
      dbias += draw;
      float* part = dx_s + (j * nw + w) * C;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        dwdt[r] = fmaf(draw, xr[r], dwdt[r]);
        const float s = warp_sum(draw * wdt_r[r]);
        if (lane == 0) part[r] = s;
      }
      transpose_reduce_stage<32>(v, lane);
      transpose_reduce_stage<16>(v, lane);
      transpose_reduce_stage<8>(v, lane);
      transpose_reduce_stage<4>(v, lane);
      transpose_reduce_stage<2>(v, lane);
      part[R + lane] = v[0];
    }
    __syncthreads();
    for (int o = d; o < tl * C; o += Dh) {
      const int j = o / C;
      const int cc = o % C;
      float s = 0.f;
      for (int ww = 0; ww < nw; ++ww) s += dx_s[(j * nw + ww) * C + cc];
      dxt_s[o] = s;
    }
    __syncthreads();
    // du's projection term and this thread's column of dwx
    for (int j = 0; j < tl; ++j) {
      const float* dr = dxt_s + j * C;
      const float uv = u_s[j * (Dh + 1) + d];
      float due = 0.f;
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        due = fmaf(dr[cc], wx_s[cc * (Dh + 1) + d], due);
        dwx[cc] = fmaf(dr[cc], uv, dwx[cc]);
      }
      const int p = position(t0 + j, L, reverse);
      dstream[(size_t)p * Dh + d] = dud_s[j * Dh + d] + due;
    }
  }

  const size_t blk = (size_t)b * nchunks + i;
#pragma unroll
  for (int n = 0; n < kN; ++n) da_part[(blk * GD + c) * kN + n] = da[n];
#pragma unroll
  for (int cc = 0; cc < C; ++cc)
    dwx_part[((blk * G + g) * C + cc) * Dh + d] = dwx[cc];
#pragma unroll
  for (int r = 0; r < R; ++r) dwdt_part[((blk * G + g) * Dh + d) * R + r] = dwdt[r];
  dtb_part[(blk * G + g) * Dh + d] = dbias;
  dds_part[blk * GD + c] = dds;
}

template <int R>
cudaError_t run(Streams streams, const float* wx, const float* wdt,
                const float* dtb, const float* A, const float* Ds, const float* dy,
                const float* carries, float* adj, float* dsum, float* ckpt,
                OutStreams dstreams, float* da_part, float* dwx_part,
                float* dwdt_part, float* dtb_part, float* dds_part, int batch,
                int L, int G, int Dh, int chunk, bool reverse, cudaStream_t stream) {
  constexpr int C = R + 2 * kN;
  const int nchunks = (L + chunk - 1) / chunk;
  const dim3 grid(nchunks, G, batch);
  cudaError_t err;
  if (nchunks > 1) {
    const size_t smem = sizeof(float) * projection_floats(C, Dh, kTileFwd);
    err = allow_smem(adjoint_chunk_kernel<R>, smem);
    if (err != cudaSuccess) return err;
    adjoint_chunk_kernel<R><<<grid, Dh, smem, stream>>>(
        streams, wx, wdt, dtb, A, dy, adj, dsum, L, G, Dh, chunk, nchunks, reverse);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = launch_carry(A, adj, dsum, batch, G * Dh, nchunks, true, stream);
    if (err != cudaSuccess) return err;
  }
  const int T = grad_tile(Dh, R);
  const size_t smem = sizeof(float) * grad_floats(C, Dh, T);
  err = allow_smem(grad_chunk_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  grad_chunk_kernel<R><<<grid, Dh, smem, stream>>>(
      streams, wx, wdt, dtb, A, Ds, dy, nchunks > 1 ? carries : nullptr,
      nchunks > 1 ? adj : nullptr, ckpt, dstreams, da_part, dwx_part, dwdt_part,
      dtb_part, dds_part, L, G, Dh, chunk, nchunks, T, (chunk + T - 1) / T,
      reverse);
  return cudaGetLastError();
}

}  // namespace

// The number of stored states a chunk needs in pass 3; the caller sizes
// `ckpt` as (B, chunks, G, this, N, Dh).
extern "C" int nnuzoo_cross_scan_bwd_nsub(int chunk, int Dh, int R) {
  const int T = grad_tile(Dh, R);
  return (chunk + T - 1) / T;
}

// Runs the passes on `stream`. s2 and d2 are null when G == 2. Scratch that
// the caller allocates: `adj` (B, chunks, N, G*Dh) and `dsum`
// (B, chunks, G*Dh), which may be null with one chunk, as may `carries` (K3's
// chunk-entry states); `ckpt` (B, chunks, G, nsub, N, Dh). Outputs: d0..d2
// (B, L, Dh) and the partials of grad_chunk_kernel. Returns the first launch
// error, or cudaSuccess.
extern "C" int nnuzoo_cross_scan_bwd(
    const float* s0, const float* s1, const float* s2, const float* wx,
    const float* wdt, const float* dtb, const float* A, const float* Ds,
    const float* dy, const float* carries, float* adj, float* dsum, float* ckpt,
    float* d0, float* d1, float* d2, float* da_part, float* dwx_part,
    float* dwdt_part, float* dtb_part, float* dds_part, int batch, int L, int G,
    int Dh, int R, int N, int chunk, int reverse, void* stream_handle) {
  if (N != kN || G < 1 || G > kMaxG || Dh % 32 != 0 || Dh > kMaxDh || chunk < 1)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const Streams streams{{s0, s1, s2}};
  const OutStreams dstreams{{d0, d1, d2}};
#define CROSS_SCAN_BWD(RV)                                                      \
  return run<RV>(streams, wx, wdt, dtb, A, Ds, dy, carries, adj, dsum, ckpt,    \
                 dstreams, da_part, dwx_part, dwdt_part, dtb_part, dds_part,    \
                 batch, L, G, Dh, chunk, reverse != 0, stream)
  CROSS_SCAN_DISPATCH_R(R, CROSS_SCAN_BWD)
#undef CROSS_SCAN_BWD
  return cudaErrorInvalidValue;
}
