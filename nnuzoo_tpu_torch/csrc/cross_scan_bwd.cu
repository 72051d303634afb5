// Fused cross-scan backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_cross_scan_pallas_bwd`
// (nnuzoo_tpu/ops/cross_scan.py:346, body `_bwd_kernel` :171, prologue
// `_projections` :96). It computes the same gradients (contract and geometry
// in cross_scan_common.cuh); the TPU kernel's batch lane packing and its
// weight-gradient sums carried in VMEM from one sequential grid step to the
// next do not carry over.
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
// gradients, one row of P = G*Dh*(N + C + R + 2) floats a (batch, chunk):
// [dA (G*Dh, N) | dwx (G, C, Dh) | dwdt (G, Dh, R) | dtb (G, Dh) | dDs (G*Dh)],
// which the caller sums over the rows with one reduction. No atomics, so the
// sums have one order on every run.
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
// carries: one block a (chunk, direction, batch), thread d owning channel d.
//   pass A (cross_walk_kernel): each chunk walked forwards once from K3's
//          entry state, in tiles of 16 steps whose u and dy rows are loaded
//          all at once. It makes the tile's projections, the only time they
//          are made, and writes each step's x_dbl to scratch (rows of W =
//          R rounded up to 4, + 2N floats, so B and C sit on 16 bytes); it
//          stores the state entering every tile of T steps of pass C
//          (`ckpt`), sums delta over the chunk, and makes the adjoint of the
//          chunk's entry state for a zero adjoint at its exit as the forward
//          sum q[n] = sum_t P_t[n] C_t[n] dy_t, P_t = prod_{s<=t} dA_s: one
//          exp2 a state-step serves the state and P (where P underflows,
//          its terms vanish);
//   pass B (carry_kernel, from the right): the adjoint of each chunk's exit
//          state;
//   pass C (cross_grad_kernel): the tiles of T steps from the right. Each
//          loads its x_dbl rows, u, dy and stored state with every load
//          issued before the first is used, recomputes the tile's states
//          from the stored one (keeping dA_s h_{s-1} in shared memory, a
//          private column per thread), and walks back with g in registers.
//          Per step the 2N sums [dB | dC] over a warp's 32 channels are K2's
//          transposing butterfly and the R sums of d_dt are shuffle
//          reductions; with more than one warp a direction, the warps'
//          partials meet in shared memory. After the tile's steps, each
//          thread adds d_xdbl . wx[g, :, d] to du and d_xdbl u to its column
//          of dwx, which stays in registers.
// T is 8 where the shared memory allows (Dh <= 64), fewer at wider Dh
// (grad_tile). With one chunk, pass B is skipped. Each exp2 is one
// `ex2.approx.ftz`: three a state-step (pass A, the recompute, the walk
// back).
// Bytes a channel-step at M2NetP (R=1: W=36 floats of x_dbl a direction's
// step, 1.1 a channel): pass A reads u and dy (8), writes x_dbl (4.5) and
// ckpt (16 floats every 8 steps: 8); pass C reads the same 20.5 and writes du
// (4): 45 against the bound's 12, 1.98 GB at B=12, L=57344 (0.59 ms).
// Measured on an H100 80GB HBM3 at 700 W (nnuzoo_tpu_torch/kernel_timing.py
// --kernel cross_bwd, one call, in turns with the design it replaced, which
// made the projections three times in a separate adjoint walk and a
// gradient pass that waited on each u row and dy read): 2.85 ms at B=12,
// L=57344 in either orientation (7.1x the bound; pass A 0.92 ms, the carry
// pass 0.14, pass C 1.78), against 7.1 ms; 0.89 against 1.91 at L=14336,
// 0.28 against 0.54 at L=3584. Pass C holds 255 registers at R=1 (no
// spills) and 27 KB of shared memory: 8 one-warp blocks an SM either way;
// pass A 154 registers. A tile of 4 steps (more blocks by shared memory,
// none by registers) was slower (2.91 ms), storing delta beside x_dbl
// (pass C without softplus) equal within the spread.

#include "cross_scan_common.cuh"

namespace {

using namespace cross_scan;

constexpr int kWalkTile = 16;         // pass A's tile of steps
constexpr int kMaxGradTile = 8;       // pass C's tile, T <= this
constexpr size_t kSmemBudget = 100 * 1024;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// An x_dbl row in scratch and in shared memory: dt (R values, padded to a
// multiple of 4), B (N), C (N).
__host__ __device__ constexpr int row_dt(int R) { return (R + 3) / 4 * 4; }
__host__ __device__ constexpr int row_width(int R) { return row_dt(R) + 2 * kN; }

// The column of x_dbl entry cc (0 .. R+2N-1) in such a row.
template <int R>
__device__ __forceinline__ constexpr int row_col(int cc) {
  return cc < R ? cc : cc - R + row_dt(R);
}

// pass A's shared memory in floats: wx and the tile's u rows (rows of Dh+4,
// 16-byte aligned and on distinct banks for float4 reads), dy (T, Dh), x_dbl
// (T, W)
__host__ __device__ inline int walk_floats(int C, int W, int Dh) {
  return (C + kWalkTile) * (Dh + 4) + kWalkTile * Dh + kWalkTile * W;
}

// pass C's shared memory in floats: wx (C, Dh), x_dbl (T, W), u, dy, delta
// and du's direct part (T, Dh) each, dA_s h_{s-1} (T, N, Dh), the warps'
// d_xdbl partials (T, Dh/32, W) and, with more than one warp, their sums
// (T, W)
__host__ __device__ inline int grad_floats(int C, int W, int Dh, int T) {
  const int nw = Dh / 32;
  return C * Dh + T * W + 4 * T * Dh + T * kN * Dh + T * nw * W +
         (nw > 1 ? T * W : 0);
}

int grad_tile(int Dh, int R) {
  for (int T = kMaxGradTile; T > 1; T /= 2)
    if (sizeof(float) * grad_floats(R + 2 * kN, row_width(R), Dh, T) <= kSmemBudget)
      return T;
  return 1;
}

// pass A. ckpt[b, i, g, k, n, d]: the state entering pass C's tile k;
// adj[b, i, n, c]: the adjoint of the state entering chunk i when the adjoint
// of the state leaving it is zero; dsum[b, i, c]: the sum of delta over the
// chunk; xdbl[b, g, s, :]: the x_dbl row of traversal step s.
template <int R>
__global__ void __launch_bounds__(kMaxDh)
cross_walk_kernel(Streams streams, const float* __restrict__ wx,
                  const float* __restrict__ wdt, const float* __restrict__ dtb,
                  const float* __restrict__ A, const float* __restrict__ dy,
                  const float* __restrict__ carries, float* __restrict__ xdbl,
                  float* __restrict__ ckpt, float* __restrict__ adj,
                  float* __restrict__ dsum, int L, int G, int Dh, int chunk,
                  int nchunks, int T, int nsub_max, int reverse) {
  constexpr int C = R + 2 * kN;
  constexpr int W = row_width(R);
  constexpr int kB = row_dt(R);
  constexpr int kC = kB + kN;
  const int ld = Dh + 4;
  extern __shared__ __align__(16) float smem[];
  float* wx_s = smem;                        // (C, Dh+4)
  float* u_s = wx_s + C * ld;                // (kWalkTile, Dh+4)
  float* dy_s = u_s + kWalkTile * ld;        // (kWalkTile, Dh)
  float* xd_s = dy_s + kWalkTile * Dh;       // (kWalkTile, W)

  const int i = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int d = threadIdx.x;
  const int GD = G * Dh;
  const int c = g * Dh + d;
  const float* wx_g = wx + (size_t)g * C * Dh;
  for (int o = d; o < C * Dh; o += Dh) wx_s[(o / Dh) * ld + o % Dh] = wx_g[o];
  // the padding columns stay zero: the projection never writes them
  for (int o = d; o < kWalkTile * W; o += Dh) xd_s[o] = 0.f;

  float a2[kN], h[kN], p[kN], q[kN], wdt_r[R];
  const size_t st = ((size_t)b * nchunks + i) * kN * (size_t)GD + c;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a2[n] = A[c * kN + n] * kLog2e;
    h[n] = carries != nullptr ? carries[st + (size_t)n * GD] : 0.f;
    p[n] = 1.f;
    q[n] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) wdt_r[r] = wdt[c * R + r];
  const float bias = dtb[c];

  const float* stream = streams.p[g] + (size_t)b * L * Dh;
  float* xrows = xdbl + ((size_t)b * G + g) * (size_t)L * W;
  const int s0 = i * chunk;
  const int s1 = min(s0 + chunk, L);
  const size_t ck0 = (((size_t)b * nchunks + i) * G + g) * nsub_max;
  float ds = 0.f;
  for (int t0 = s0; t0 < s1; t0 += kWalkTile) {
    const int tl = min(kWalkTile, s1 - t0);
    // the tile's u and dy rows, every load issued before the first store
    float ur[kWalkTile], dr[kWalkTile];
#pragma unroll
    for (int j = 0; j < kWalkTile; ++j) {
      if (j < tl) {
        const int pos = position(t0 + j, L, reverse);
        ur[j] = stream[(size_t)pos * Dh + d];
        dr[j] = dy[((size_t)b * L + pos) * GD + c];
      }
    }
    __syncthreads();                         // the last tile's readers are done
#pragma unroll
    for (int j = 0; j < kWalkTile; ++j) {
      if (j < tl) {
        u_s[j * ld + d] = ur[j];
        dy_s[j * Dh + d] = dr[j];
      }
    }
    __syncthreads();
    // x_dbl = wx[g] u, one thread an output, in K3's order of the sum
    for (int o = d; o < tl * C; o += Dh) {
      const int j = o / C;
      const int cc = o % C;
      const float4* ur4 = reinterpret_cast<const float4*>(u_s + j * ld);
      const float4* wr4 = reinterpret_cast<const float4*>(wx_s + cc * ld);
      float acc = 0.f;
      for (int k = 0; k < Dh / 4; ++k) {
        const float4 a = ur4[k];
        const float4 w = wr4[k];
        acc = fmaf(a.x, w.x, acc);
        acc = fmaf(a.y, w.y, acc);
        acc = fmaf(a.z, w.z, acc);
        acc = fmaf(a.w, w.w, acc);
      }
      xd_s[j * W + row_col<R>(cc)] = acc;
    }
    __syncthreads();
    {
      const float4* src = reinterpret_cast<const float4*>(xd_s);
      float4* dst = reinterpret_cast<float4*>(xrows + (size_t)t0 * W);
      for (int o = d; o < tl * W / 4; o += Dh) dst[o] = src[o];
    }
    for (int j = 0; j < tl; ++j) {
      const int r = t0 + j - s0;             // step of the chunk
      if ((r & (T - 1)) == 0) {              // T is a power of two
        const size_t ck = (ck0 + r / T) * kN * (size_t)Dh + d;
#pragma unroll
        for (int n = 0; n < kN; ++n) ckpt[ck + (size_t)n * Dh] = h[n];
      }
      const float* xr = xd_s + j * W;
      const float delta = step_delta<R>(xr, wdt_r, bias);
      const float du = delta * u_s[j * ld + d];
      const float dyv = dy_s[j * Dh + d];
      ds += delta;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float dan = ex2(delta * a2[n]);
        h[n] = fmaf(dan, h[n], du * xr[kB + n]);
        p[n] *= dan;
        q[n] = fmaf(p[n], xr[kC + n] * dyv, q[n]);
      }
    }
  }
  if (adj != nullptr) {
#pragma unroll
    for (int n = 0; n < kN; ++n) adj[st + (size_t)n * GD] = q[n];
    dsum[((size_t)b * nchunks + i) * GD + c] = ds;
  }
}

// One butterfly stage: the W values of v shrink to W/2; the lanes whose bit
// W/2 is set keep the upper half.
template <int Wv>
__device__ __forceinline__ void transpose_reduce_stage(float* v, int lane) {
  constexpr int H = Wv / 2;
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

// pass C. part: the row of (batch b, chunk i), laid out as the header says.
template <int R>
__global__ void __launch_bounds__(kMaxDh)
cross_grad_kernel(Streams streams, const float* __restrict__ wx,
                  const float* __restrict__ wdt, const float* __restrict__ dtb,
                  const float* __restrict__ A, const float* __restrict__ Ds,
                  const float* __restrict__ dy, const float* __restrict__ xdbl,
                  const float* __restrict__ ckpt, const float* __restrict__ adj,
                  OutStreams dstreams, float* __restrict__ part, int L, int G,
                  int Dh, int chunk, int nchunks, int T, int nsub_max,
                  int reverse) {
  static_assert(2 * kN == 32, "the [dB | dC] butterfly takes 2N == 32");
  constexpr int C = R + 2 * kN;
  constexpr int W = row_width(R);
  constexpr int kB = row_dt(R);
  constexpr int kC = kB + kN;
  // float4 loads of a tile's x_dbl rows a thread (Dh >= 32)
  constexpr int kXd4 = (kMaxGradTile * W / 4 + 31) / 32;
  const int nw = Dh / 32;
  extern __shared__ __align__(16) float smem[];
  float* wx_s = smem;                        // (C, Dh)
  float* xd_s = wx_s + C * Dh;               // (T, W)
  float* u_s = xd_s + T * W;                 // (T, Dh)
  float* dy_s = u_s + T * Dh;                // (T, Dh)
  float* del_s = dy_s + T * Dh;              // (T, Dh)
  float* dud_s = del_s + T * Dh;             // (T, Dh)
  float* hm_s = dud_s + T * Dh;              // (T, N, Dh): dA_s h_{s-1}
  float* dx_s = hm_s + T * kN * Dh;          // (T, Dh/32, W)
  float* dxt_s = dx_s + T * nw * W;          // (T, W), with nw > 1

  const int i = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int d = threadIdx.x;
  const int lane = d & 31;
  const int w = d >> 5;
  const int GD = G * Dh;
  const int c = g * Dh + d;
  const float* wx_g = wx + (size_t)g * C * Dh;
  for (int o = d; o < C * Dh; o += Dh) wx_s[o] = wx_g[o];

  float a2[kN], q[kN], da[kN], dwx[C], wdt_r[R], dwdt[R];
  const size_t st = ((size_t)b * nchunks + i) * kN * (size_t)GD + c;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a2[n] = A[c * kN + n] * kLog2e;
    // q: the adjoint of the state leaving the step about to be walked
    q[n] = adj != nullptr ? adj[st + (size_t)n * GD] : 0.f;
    da[n] = 0.f;
  }
#pragma unroll
  for (int cc = 0; cc < C; ++cc) dwx[cc] = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    wdt_r[r] = wdt[c * R + r];
    dwdt[r] = 0.f;
  }
  const float bias = dtb[c];
  const float dd = Ds[c];
  float dbias = 0.f;
  float dds = 0.f;

  const float* stream = streams.p[g] + (size_t)b * L * Dh;
  float* dstream = dstreams.p[g] + (size_t)b * L * Dh;
  const float* xrows = xdbl + ((size_t)b * G + g) * (size_t)L * W;
  const int s0 = i * chunk;
  const int s1 = min(s0 + chunk, L);
  const int ntile = (s1 - s0 + T - 1) / T;
  const size_t ck0 = (((size_t)b * nchunks + i) * G + g) * nsub_max;

  for (int k = ntile - 1; k >= 0; --k) {
    const int t0 = s0 + k * T;
    const int tl = min(T, s1 - t0);
    // the tile's operands and stored state, every load issued before the
    // first is used
    float4 xr4[kXd4];
    float ur[kMaxGradTile], dr[kMaxGradTile], h[kN];
    const float4* xsrc = reinterpret_cast<const float4*>(xrows + (size_t)t0 * W);
    const int nx4 = tl * W / 4;
#pragma unroll
    for (int m = 0; m < kXd4; ++m)
      if (d + m * Dh < nx4) xr4[m] = xsrc[d + m * Dh];
#pragma unroll
    for (int j = 0; j < kMaxGradTile; ++j) {
      if (j < tl) {
        const int pos = position(t0 + j, L, reverse);
        ur[j] = stream[(size_t)pos * Dh + d];
        dr[j] = dy[((size_t)b * L + pos) * GD + c];
      }
    }
    const size_t ck = (ck0 + k) * kN * (size_t)Dh + d;
#pragma unroll
    for (int n = 0; n < kN; ++n) h[n] = ckpt[ck + (size_t)n * Dh];
    __syncthreads();                         // the last tile's readers are done
#pragma unroll
    for (int m = 0; m < kXd4; ++m)
      if (d + m * Dh < nx4) reinterpret_cast<float4*>(xd_s)[d + m * Dh] = xr4[m];
#pragma unroll
    for (int j = 0; j < kMaxGradTile; ++j) {
      if (j < tl) {
        u_s[j * Dh + d] = ur[j];
        dy_s[j * Dh + d] = dr[j];
      }
    }
    __syncthreads();
    // the tile's states from the stored one: dA_s h_{s-1} into hm_s
    for (int j = 0; j < tl; ++j) {
      const float* xr = xd_s + j * W;
      const float delta = step_delta<R>(xr, wdt_r, bias);
      const float dxu = delta * u_s[j * Dh + d];
      del_s[j * Dh + d] = delta;
      float* slot = hm_s + (size_t)j * kN * Dh + d;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float hm = ex2(delta * a2[n]) * h[n];
        h[n] = fmaf(dxu, xr[kB + n], hm);
        slot[n * Dh] = hm;
      }
    }
    // the steps backwards
    for (int j = tl - 1; j >= 0; --j) {
      const float* xr = xd_s + j * W;
      const float delta = del_s[j * Dh + d];
      const float uv = u_s[j * Dh + d];
      const float dyv = dy_s[j * Dh + d];
      const float dxu = delta * uv;
      const float* hm = hm_s + (size_t)j * kN * Dh + d;
      float v[2 * kN];                        // [dB | dC] before the sum over d
      float gb = 0.f;
      float gha = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float gn = fmaf(xr[kC + n], dyv, q[n]);
        const float dan = ex2(delta * a2[n]);
        const float hmn = hm[n * Dh];
        const float bn = xr[kB + n];
        const float gh = gn * hmn;                     // g_s h_{s-1} dA_s
        gha = fmaf(gh, a2[n], gha);
        da[n] = fmaf(gh, delta, da[n]);
        gb = fmaf(gn, bn, gb);
        q[n] = dan * gn;
        v[n] = gn * dxu;
        v[kN + n] = fmaf(dxu, bn, hmn) * dyv;          // h_s dy_s
      }
      const float ddelta = fmaf(gha, kLn2, uv * gb);
      const float draw = ddelta * -expm1f(-delta);     // softplus' = 1 - exp(-delta)
      dud_s[j * Dh + d] = fmaf(delta, gb, dyv * dd);
      dds = fmaf(dyv, uv, dds);
      dbias += draw;
      float* prow = dx_s + (j * nw + w) * W;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        dwdt[r] = fmaf(draw, xr[r], dwdt[r]);
        const float s = warp_sum(draw * wdt_r[r]);
        if (lane == 0) prow[r] = s;
      }
      transpose_reduce_stage<32>(v, lane);
      transpose_reduce_stage<16>(v, lane);
      transpose_reduce_stage<8>(v, lane);
      transpose_reduce_stage<4>(v, lane);
      transpose_reduce_stage<2>(v, lane);
      prow[kB + lane] = v[0];                // lane l holds [dB | dC][l]
    }
    __syncthreads();
    const float* dx_rows = dx_s;
    if (nw > 1) {
      for (int o = d; o < tl * W; o += Dh) {
        const int j = o / W;
        const int col = o % W;
        float s = 0.f;
        for (int ww = 0; ww < nw; ++ww) s += dx_s[(j * nw + ww) * W + col];
        dxt_s[o] = s;
      }
      __syncthreads();
      dx_rows = dxt_s;
    }
    // du's projection term and this thread's column of dwx
    for (int j = 0; j < tl; ++j) {
      const float* dr_j = dx_rows + j * W;
      const float uv = u_s[j * Dh + d];
      float due = 0.f;
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        const float x = dr_j[row_col<R>(cc)];
        due = fmaf(x, wx_s[cc * Dh + d], due);
        dwx[cc] = fmaf(x, uv, dwx[cc]);
      }
      const int pos = position(t0 + j, L, reverse);
      dstream[(size_t)pos * Dh + d] = dud_s[j * Dh + d] + due;
    }
  }

  // this (batch, chunk)'s row of partials
  float* row = part + ((size_t)b * nchunks + i) * (size_t)GD * (kN + C + R + 2);
  float* p_da = row;                         // (G*Dh, N)
  float* p_dwx = p_da + GD * kN;             // (G, C, Dh)
  float* p_dwdt = p_dwx + G * C * Dh;        // (G, Dh, R)
  float* p_dtb = p_dwdt + GD * R;            // (G, Dh)
  float* p_dds = p_dtb + GD;                 // (G*Dh)
#pragma unroll
  for (int n = 0; n < kN; ++n) p_da[c * kN + n] = da[n];
#pragma unroll
  for (int cc = 0; cc < C; ++cc) p_dwx[(g * C + cc) * Dh + d] = dwx[cc];
#pragma unroll
  for (int r = 0; r < R; ++r) p_dwdt[c * R + r] = dwdt[r];
  p_dtb[c] = dbias;
  p_dds[c] = dds;
}

template <int R>
cudaError_t run(Streams streams, const float* wx, const float* wdt,
                const float* dtb, const float* A, const float* Ds, const float* dy,
                const float* carries, float* xdbl, float* ckpt, float* adj,
                float* dsum, float* part, OutStreams dstreams, int batch, int L,
                int G, int Dh, int chunk, bool reverse, cudaStream_t stream) {
  constexpr int C = R + 2 * kN;
  const int nchunks = (L + chunk - 1) / chunk;
  const bool carried = nchunks > 1;
  const dim3 grid(nchunks, G, batch);
  const int T = grad_tile(Dh, R);
  const int nsub = (chunk + T - 1) / T;
  cudaError_t err;
  const size_t walk_smem = sizeof(float) * walk_floats(C, row_width(R), Dh);
  err = allow_smem(cross_walk_kernel<R>, walk_smem);
  if (err != cudaSuccess) return err;
  cross_walk_kernel<R><<<grid, Dh, walk_smem, stream>>>(
      streams, wx, wdt, dtb, A, dy, carried ? carries : nullptr, xdbl, ckpt,
      carried ? adj : nullptr, carried ? dsum : nullptr, L, G, Dh, chunk,
      nchunks, T, nsub, reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (carried) {
    err = launch_carry(A, adj, dsum, batch, G * Dh, nchunks, true, stream);
    if (err != cudaSuccess) return err;
  }
  const size_t grad_smem = sizeof(float) * grad_floats(C, row_width(R), Dh, T);
  err = allow_smem(cross_grad_kernel<R>, grad_smem);
  if (err != cudaSuccess) return err;
  cross_grad_kernel<R><<<grid, Dh, grad_smem, stream>>>(
      streams, wx, wdt, dtb, A, Ds, dy, xdbl, ckpt, carried ? adj : nullptr,
      dstreams, part, L, G, Dh, chunk, nchunks, T, nsub, reverse);
  return cudaGetLastError();
}

}  // namespace

// The number of stored states a chunk needs in pass C; the caller sizes
// `ckpt` as (B, chunks, G, this, N, Dh).
extern "C" int nnuzoo_cross_scan_bwd_nsub(int chunk, int Dh, int R) {
  const int T = grad_tile(Dh, R);
  return (chunk + T - 1) / T;
}

// The floats of a step's x_dbl row in `xdbl`: the caller sizes it as
// (B, G, L, this).
extern "C" int nnuzoo_cross_scan_bwd_row(int R) { return row_width(R); }

// Runs the passes on `stream`. s2 and d2 are null when G == 2. Scratch that
// the caller allocates, each 16-byte aligned: `xdbl` (B, G, L, row), `ckpt`
// (B, chunks, G, nsub, N, Dh), `adj` (B, chunks, N, G*Dh) and `dsum`
// (B, chunks, G*Dh), which may be null with one chunk, as may `carries` (K3's
// chunk-entry states). Outputs: d0..d2 (B, L, Dh) and `part`, one row of the
// five weight gradients' partials a (batch, chunk) (B*chunks, P). Returns the
// first launch error, or cudaSuccess.
extern "C" int nnuzoo_cross_scan_bwd(
    const float* s0, const float* s1, const float* s2, const float* wx,
    const float* wdt, const float* dtb, const float* A, const float* Ds,
    const float* dy, const float* carries, float* xdbl, float* ckpt, float* adj,
    float* dsum, float* part, float* d0, float* d1, float* d2, int batch, int L,
    int G, int Dh, int R, int N, int chunk, int reverse, void* stream_handle) {
  if (N != kN || G < 1 || G > kMaxG || Dh % 32 != 0 || Dh > kMaxDh || chunk < 1)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const Streams streams{{s0, s1, s2}};
  const OutStreams dstreams{{d0, d1, d2}};
#define CROSS_SCAN_BWD(RV)                                                      \
  return run<RV>(streams, wx, wdt, dtb, A, Ds, dy, carries, xdbl, ckpt, adj,    \
                 dsum, part, dstreams, batch, L, G, Dh, chunk, reverse != 0,    \
                 stream)
  CROSS_SCAN_DISPATCH_R(R, CROSS_SCAN_BWD)
#undef CROSS_SCAN_BWD
  return cudaErrorInvalidValue;
}
