// Selective-scan backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_scan_core_pallas_bwd`
// (nnuzoo_tpu/ops/selective_scan.py, bodies `_bwd_kernel_mxu`,
// `_bwd_kernel_fused` and `_bwd_kernel`). It computes the same gradients; the
// TPU kernel's selection-matrix products, its 16-step slabs and its
// sequential grid with scratch carried from step to step do not carry over.
//
// Contract, every tensor fp32 and contiguous (as selective_scan_fwd.cu):
//   u, delta, dy : (B, L, K*Dh)   delta already softplus'ed
//   a_t          : (N, K*Dh)
//   bc           : (B, L, K*2N)   per direction k the lanes hold [B_k | C_k]
//   carries      : (B, chunks, N, K*Dh)  the state entering each chunk of
//                  `chunk` steps, as the forward kernel wrote it (null with
//                  one chunk: the scan starts from zero)
// With h_t the forward's state, c = k*Dh + d and dA_t[n] = exp(delta_t A[n, c]):
//   g_t[n]   = C_t[k, n] dy_t[c] + dA_{t+1}[n] g_{t+1}[n]        (g_L = 0)
//   ddelta_t = sum_n g_t h_{t-1} dA_t A[n, c] + u_t sum_n g_t B_t[k, n]
//   du_t     = delta_t sum_n g_t B_t[k, n]
//   dB_t[k, n] = sum_d g_t delta_t u_t       dC_t[k, n] = sum_d h_t dy_t
//   dA[n, c]   = sum_{b, t} g_t h_{t-1} dA_t delta_t
// Outputs: du, ddelta (B, L, K*Dh); dbc_part (B, L, K*Dh/32, 2N), the
// [dB | dC] sums of each warp of 32 channels (with Dh = 32 that is dbc
// itself, with a wider Dh the caller adds the Dh/32 parts of a direction);
// da_part (B, chunks, N, K*Dh), which the caller sums over batch and chunks.
// No atomics, so the sums have one order on every run.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores):
// a step of one channel reads u, delta, dy and writes du, ddelta (20 bytes)
// and, with Dh=32, reads and writes a 32nd of its direction's 2N bc values
// (8 bytes at N=16), against N states of ~14 operations each: 8 operations a
// byte, below the card's 20. The function is bound by bytes.
//
// Design. As in the forward, one thread owns one (batch, channel, chunk) and
// keeps N states in registers; a warp is 32 neighbouring channels of one
// direction (Dh must be a multiple of 32). The chunks are the forward's, so
// its carries give every chunk's entry state and no forward carry pass is run
// again. The adjoint g needs a carry from the right as the state needs one
// from the left:
//   pass 1 (adjoint_chunk_kernel): each chunk in reverse from a zero adjoint;
//          it leaves the adjoint of the chunk's ENTRY state and the sum of
//          delta over the chunk. Seen from the entry state, the decay across
//          a whole chunk is exp(A * sum(delta)) over the chunk's own steps,
//          with no shift by one;
//   pass 2 (adjoint_carry_kernel): one thread per (batch, n, channel) walks
//          the chunks from the right, turning those into the adjoint of each
//          chunk's EXIT state;
//   pass 3 (grad_chunk_kernel): the gradients. h_{t-1} is needed walking L
//          in reverse, and a thread cannot hold a chunk's states, so it first
//          walks its chunk forwards and stores the state every kSub steps in
//          global scratch (`ckpt`, one kSub-th of 16 floats a step: twice
//          u's bytes at kSub=8). Then it takes the sub-chunks from the
//          right: recompute kSub states from the stored one into shared
//          memory (a private column per thread, no synchronisation), and walk
//          them in reverse with g in registers. The [dB | dC] sums over the
//          32 channels of a warp are a transposing butterfly: 31 shuffles
//          for 32 sums, after which lane l holds sum l and the warp writes
//          one 128-byte line.
// With one chunk, passes 1 and 2 are skipped. Pass 3 reads u, delta and bc
// twice and pass 1 reads delta, dy and bc once more, so the kernel moves
// about 2.7x the bytes of its bound. The kernel is bound by latency, not by
// those bytes: a warp waits for each step's loads, so what counts is the
// number of warps an SM holds. Shared memory (18 KB a warp at kSub=8) allows
// 12, as do the registers; each warp has 16 independent states in flight. On
// an H100 at B=12, L=57344 the call takes 8.4 ms at kSub=16 (6 warps an SM),
// 5.7 ms at kSub=8 and 5.1 ms at kSub=4, where `ckpt` is four times u.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;   // passes 1 and 2
constexpr int kWarp = 32;       // pass 3: one warp a block
constexpr int kSub = 8;         // steps between stored states in pass 3
constexpr unsigned kFull = 0xffffffffu;

template <int N>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float* out) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = __ldg(p4 + q);
    out[4 * q] = v.x; out[4 * q + 1] = v.y; out[4 * q + 2] = v.z; out[4 * q + 3] = v.w;
  }
}

// pass 1: adj[b, j, n, c] = adjoint of the state entering chunk j when the
// adjoint of the state leaving it is zero; dsum[b, j, c] = sum of delta.
template <int N>
__global__ void __launch_bounds__(kThreads)
adjoint_chunk_kernel(const float* __restrict__ delta, const float* __restrict__ a_t,
                     const float* __restrict__ bc, const float* __restrict__ dy,
                     float* __restrict__ adj, float* __restrict__ dsum, int L,
                     int KD, int Dh, int chunk, int nchunks) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int j = blockIdx.y;
  const int b = blockIdx.z;
  if (c >= KD) return;
  const int k = c / Dh;
  const int row_bc = (KD / Dh) * 2 * N;

  float a2[N];
  float q[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = a_t[n * KD + c] * kLog2e;
    q[n] = 0.f;
  }
  const int t0 = j * chunk;
  const int t1 = min(t0 + chunk, L);
  float ds = 0.f;
#pragma unroll 2
  for (int t = t1 - 1; t >= t0; --t) {
    const size_t r = (size_t)b * L + t;
    const float d = delta[r * KD + c];
    const float dyv = dy[r * KD + c];
    float cv[N];
    load_row<N>(bc + r * row_bc + (size_t)k * 2 * N + N, cv);
#pragma unroll
    for (int n = 0; n < N; ++n)
      q[n] = exp2f(d * a2[n]) * fmaf(cv[n], dyv, q[n]);
    ds += d;
  }
  const size_t st = ((size_t)b * nchunks + j) * N * (size_t)KD + c;
#pragma unroll
  for (int n = 0; n < N; ++n) adj[st + (size_t)n * KD] = q[n];
  dsum[((size_t)b * nchunks + j) * KD + c] = ds;
}

// pass 2: from the right, adj[b, j] becomes the adjoint of the state leaving
// chunk j: exit_{j-1} = entry-adjoint_j + exp(A * dsum_j) * exit_j.
__global__ void __launch_bounds__(kThreads)
adjoint_carry_kernel(const float* __restrict__ a_t, float* __restrict__ adj,
                     const float* __restrict__ dsum, int batch, int KD, int N,
                     int nchunks) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)batch * N * KD) return;
  const int c = (int)(idx % KD);
  const int n = (int)((idx / KD) % N);
  const int b = (int)(idx / ((size_t)KD * N));
  const float a2 = a_t[n * KD + c] * kLog2e;
  float q = 0.f;
  for (int j = nchunks - 1; j >= 0; --j) {
    const size_t row = (size_t)b * nchunks + j;
    const size_t off = (row * N + n) * KD + c;
    const float entry = adj[off];
    const float decay = exp2f(a2 * dsum[row * KD + c]);
    adj[off] = q;
    q = decay * q + entry;
  }
}

// One butterfly stage: the W values of v shrink to W/2; the lanes whose bit
// W/2 is set keep the upper half.
template <int W>
__device__ __forceinline__ void transpose_reduce_stage(float* v, int lane) {
  constexpr int H = W / 2;
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

// pass 3, one warp a block.
template <int N>
__global__ void __launch_bounds__(kWarp)
grad_chunk_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                  const float* __restrict__ a_t, const float* __restrict__ bc,
                  const float* __restrict__ dy, const float* __restrict__ carries,
                  const float* __restrict__ adj, float* __restrict__ ckpt,
                  float* __restrict__ du, float* __restrict__ ddelta,
                  float* __restrict__ dbc_part, float* __restrict__ da_part,
                  int L, int KD, int Dh, int chunk, int nchunks, int nsub_max) {
  static_assert(2 * N == kWarp, "the [dB | dC] butterfly takes 2N == 32");
  // hs[i][n][lane]: slot 0 the state entering the sub-chunk, slot i+1 the
  // state after its step i; a thread reads only what it wrote itself
  __shared__ float hs[(kSub + 1) * N * kWarp];

  const int lane = threadIdx.x;
  const int c = blockIdx.x * kWarp + lane;       // KD % 32 == 0: no ragged warp
  const int j = blockIdx.y;
  const int b = blockIdx.z;
  const int k = c / Dh;
  const int row_bc = (KD / Dh) * 2 * N;
  const int t0 = j * chunk;
  const int t1 = min(t0 + chunk, L);
  const int nsub = (t1 - t0 + kSub - 1) / kSub;

  float a2[N];
  float h[N];
  const size_t st = ((size_t)b * nchunks + j) * N * (size_t)KD + c;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = a_t[n * KD + c] * kLog2e;
    h[n] = carries != nullptr ? carries[st + (size_t)n * KD] : 0.f;
  }

  // forwards: the state entering each sub-chunk -> ckpt[b, j, s, n, c]
  const size_t ck0 = ((size_t)b * nchunks + j) * nsub_max;
  for (int s = 0; s < nsub; ++s) {
    const size_t ck = (ck0 + s) * N * (size_t)KD + c;
#pragma unroll
    for (int n = 0; n < N; ++n) ckpt[ck + (size_t)n * KD] = h[n];
    if (s == nsub - 1) break;
    const int ts0 = t0 + s * kSub;
#pragma unroll 2
    for (int t = ts0; t < ts0 + kSub; ++t) {
      const size_t r = (size_t)b * L + t;
      const float d = delta[r * KD + c];
      const float dxu = d * u[r * KD + c];
      float bv[N];
      load_row<N>(bc + r * row_bc + (size_t)k * 2 * N, bv);
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = exp2f(d * a2[n]) * h[n] + dxu * bv[n];
    }
  }

  // backwards over the sub-chunks, q = adjoint of the state leaving step t
  float q[N];
  float da[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    q[n] = adj != nullptr ? adj[st + (size_t)n * KD] : 0.f;
    da[n] = 0.f;
  }
  const int warp_col = (c / kWarp) * kWarp;      // this warp's 32 dbc_part lanes
  for (int s = nsub - 1; s >= 0; --s) {
    const int ts0 = t0 + s * kSub;
    const int ts1 = min(ts0 + kSub, t1);
    const size_t ck = (ck0 + s) * N * (size_t)KD + c;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      h[n] = ckpt[ck + (size_t)n * KD];
      hs[n * kWarp + lane] = h[n];
    }
    for (int t = ts0; t < ts1; ++t) {
      const size_t r = (size_t)b * L + t;
      const float d = delta[r * KD + c];
      const float dxu = d * u[r * KD + c];
      float bv[N];
      load_row<N>(bc + r * row_bc + (size_t)k * 2 * N, bv);
      float* slot = hs + (size_t)(t - ts0 + 1) * N * kWarp + lane;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = exp2f(d * a2[n]) * h[n] + dxu * bv[n];
        slot[n * kWarp] = h[n];
      }
    }
    for (int t = ts1 - 1; t >= ts0; --t) {
      const size_t r = (size_t)b * L + t;
      const float d = delta[r * KD + c];
      const float uv = u[r * KD + c];
      const float dyv = dy[r * KD + c];
      const float dxu = d * uv;
      float v[2 * N];                            // [B_t | C_t], then [dB | dC]
      load_row<2 * N>(bc + r * row_bc + (size_t)k * 2 * N, v);
      const float* prev = hs + (size_t)(t - ts0) * N * kWarp + lane;
      float gb = 0.f;
      float gha = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float g = fmaf(v[N + n], dyv, q[n]);
        const float dan = exp2f(d * a2[n]);
        const float gh = g * prev[n * kWarp] * dan;      // g_t h_{t-1} dA_t
        gha = fmaf(gh, a2[n], gha);
        da[n] = fmaf(gh, d, da[n]);
        gb = fmaf(g, v[n], gb);
        q[n] = dan * g;
        v[n] = g * dxu;                                   // dB before the sum over d
        v[N + n] = prev[(N + n) * kWarp] * dyv;           // h_t dy_t (the next slot)
      }
      ddelta[r * KD + c] = fmaf(gha, kLn2, uv * gb);
      du[r * KD + c] = d * gb;
      transpose_reduce_stage<32>(v, lane);
      transpose_reduce_stage<16>(v, lane);
      transpose_reduce_stage<8>(v, lane);
      transpose_reduce_stage<4>(v, lane);
      transpose_reduce_stage<2>(v, lane);
      dbc_part[r * KD + warp_col + lane] = v[0];
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) da_part[st + (size_t)n * KD] = da[n];
}

}  // namespace

// The number of stored states a chunk needs in pass 3; the caller sizes
// `ckpt` as (B, chunks, this, N, K*Dh).
extern "C" int nnuzoo_selective_scan_bwd_nsub(int chunk) {
  return (chunk + kSub - 1) / kSub;
}

// Runs the passes on `stream`. Scratch that the caller allocates: `adj`
// (B, chunks, N, K*Dh) and `dsum` (B, chunks, K*Dh), both may be null when
// there is one chunk, as may `carries`; `ckpt` (B, chunks, nsub, N, K*Dh).
// Returns the first launch error, or cudaSuccess.
extern "C" int nnuzoo_selective_scan_bwd(
    const float* u, const float* delta, const float* a_t, const float* bc,
    const float* dy, const float* carries, float* du, float* ddelta,
    float* dbc_part, float* da_part, float* adj, float* dsum, float* ckpt,
    int batch, int L, int K, int Dh, int N, int chunk, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  // N is a template argument so the states stay in registers, and 2N is the
  // warp's width in the [dB | dC] butterfly
  if (N != 16 || Dh % kWarp != 0) return cudaErrorInvalidValue;
  const int KD = K * Dh;
  const int nchunks = (L + chunk - 1) / chunk;
  cudaError_t err;
  if (nchunks > 1) {
    const dim3 grid((KD + kThreads - 1) / kThreads, nchunks, batch);
    adjoint_chunk_kernel<16><<<grid, kThreads, 0, stream>>>(
        delta, a_t, bc, dy, adj, dsum, L, KD, Dh, chunk, nchunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t threads = (size_t)batch * N * KD;
    adjoint_carry_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                           kThreads, 0, stream>>>(a_t, adj, dsum, batch, KD, N,
                                                  nchunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(KD / kWarp, nchunks, batch);
  grad_chunk_kernel<16><<<grid, kWarp, 0, stream>>>(
      u, delta, a_t, bc, dy, nchunks > 1 ? carries : nullptr,
      nchunks > 1 ? adj : nullptr, ckpt, du, ddelta, dbc_part, da_part, L, KD,
      Dh, chunk, nchunks, nchunks > 0 ? (chunk + kSub - 1) / kSub : 0);
  return cudaGetLastError();
}
