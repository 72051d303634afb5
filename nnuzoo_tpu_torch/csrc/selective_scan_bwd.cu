// Selective-scan backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_scan_core_pallas_bwd`
// (nnuzoo_tpu/ops/selective_scan.py:915, bodies `_bwd_kernel_mxu` :494,
// `_bwd_kernel_fused` :649 and `_bwd_kernel` :767). It computes the same
// gradients; the TPU kernel's selection-matrix products, its 16-step slabs and
// its sequential grid with scratch carried from step to step do not carry over.
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
// (8 bytes at N=16): 28 bytes, against N states of ~14 operations each, 8
// operations a byte, below the card's 20. The function is bound by bytes:
// 0.736 ms at B=12, L=57344, K*Dh=128.
//
// Design. One thread owns one (batch, channel, chunk) and keeps N states in
// registers; the chunks are the forward's, so its carries give every chunk's
// entry state. A block is 128 channels of one (batch, chunk): four warps,
// all of K*Dh at M2NetP's width, so the bc rows of a step are read whole and
// once (at K*Dh=1024 eight blocks cover a (batch, chunk); below 128 channels
// a block has K*Dh/32 warps). Both walking passes stage their operands in
// tiles of kSub steps: u, delta, dy (128 channels) and the bc columns of the
// block's directions (at most four, 128 floats) go to shared memory by
// cp.async, double buffered, so the next tile is in flight while this one is
// computed and no step waits on a global load.
//   pass A (forward_chunk_kernel): each chunk forwards once from its entry
//          state. It stores the state every kSub steps (`ckpt`), sums delta
//          over the chunk, and makes the adjoint of the chunk's entry state
//          for a zero adjoint at its exit as a forward sum:
//            q_entry[n] = sum_t P_t[n] C_t[n] dy_t,  P_t = prod_{s=t0..t} dA_s,
//          the same quantity as walking the chunk backwards with
//          q = dA_t (C_t dy_t + q). One exp2 a state and step serves both the
//          state and P; where the decay is steep P underflows to zero, which
//          is where its terms vanish. The states are at hand here, so pass A
//          also sums dC over the warp's 32 channels (16 sums, 16 shuffles);
//   pass B (adjoint_carry_kernel): one thread per (batch, n, channel) walks
//          the chunks from the right, turning those into the adjoint of each
//          chunk's EXIT state (the decay across a chunk is exp(A * dsum));
//   pass C (grad_tile_kernel): the gradients, the sub-chunks from the right.
//          For each, the states are recomputed from the stored one, then
//          walked in reverse with g in registers; both walks read the same
//          staged tile. The reverse walk needs a state only as dA_t h_{t-1}
//          (dC is pass A's), so the recompute leaves that product in shared
//          memory (a private column per thread, kSub values a state). dB
//          is summed over the warp's channels by a transposing butterfly
//          (16 sums, 16 shuffles; lanes l and l + 16 end with sum l % 16).
// With one chunk, pass B is skipped. dbc_part's [dB | dC] row of a warp is
// written half by pass C (lanes 0-15) and half by pass A (lanes 16-31).
//
// Bytes a channel-step at kSub=4: pass A reads u, delta, dy and bc (16),
// writes ckpt (16 floats every 4 steps: 16) and dC (2); pass C reads the
// same 16 and ckpt (16) and writes du, ddelta and dB (10): 76 against the
// bound's 28 (2.7x; 2.0 ms at 3.35 TB/s at B=12, L=57344). kSub trades
// those ckpt bytes against the warps an SM holds: pass C's shared memory is
// 48 KB a block at kSub=4 (16 warps an SM, registers capped at 128) and
// 96 KB at kSub=8 (8 warps); on an H100 kSub=8 took 3.82 ms at that shape,
// kSub=4 3.22 (both before the stash held dA_t h_{t-1}). exp2: three a
// state and step (pass A, the recompute and the reverse walk of pass C);
// keeping dA_t in shared memory as well would take the reverse walk's away
// but doubles the stash. At B=12, L=57344, K*Dh=128, N=16 that is 4.2e9 ex2
// at 16 a clock and SM: 1.0-1.1 ms at 1.98-1.75 GHz, under the byte floor.
// Each exp2 is one `ex2.approx.ftz` (an exp2f with its subnormal fix-ups
// costs four instructions): a decay below 2^-126 flushes to zero, where its
// terms vanish anyway.
// Measured on an H100 80GB HBM3 at 700 W (nnuzoo_tpu_torch/kernel_timing.py,
// one call, in turns with the design it replaced): 3.00 ms at B=12,
// L=57344 (4.1x the bound; pass A 1.19 ms, moving its 34 bytes a
// channel-step at 2.5 TB/s; pass B 0.014; pass C 1.81, bound by issuing some
// 350 warp instructions a step), against 5.68 ms for the old design (three
// passes, one-warp blocks, a global load waited on every step, four exp2);
// 26.7 ms against 45.2 for the 80 calls of a training step.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;   // pass B
constexpr int kBlock = 128;     // passes A and C: channels of a block
constexpr int kSub = 4;         // steps of a tile, and between stored states
constexpr int kOperands = 4;    // a tile's rows: u, delta, dy, bc
constexpr int kTileFloats = kSub * kOperands * kBlock;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The block's view of the operands: channels [c0, c0 + nch) of a row of u,
// delta and dy, and columns [bc0, bc0 + nbc) of a row of bc, which hold the
// [B | C] lanes of every direction that those channels touch (at most four:
// Dh is a multiple of 32 and c0 of 128).
struct Cols {
  int c0, nch, bc0, nbc, row_bc;
};

template <int N>
__device__ __forceinline__ Cols block_cols(int KD, int Dh) {
  Cols s;
  s.c0 = blockIdx.x * kBlock;
  s.nch = min(kBlock, KD - s.c0);
  const int k_lo = s.c0 / Dh;
  const int k_hi = (s.c0 + s.nch - 1) / Dh;
  s.bc0 = k_lo * 2 * N;
  s.nbc = (k_hi - k_lo + 1) * 2 * N;
  s.row_bc = (KD / Dh) * 2 * N;
  return s;
}

// Issue the copies of `ns` steps from row `r0` = b*L + t into a tile laid
// out [step][operand][kBlock]; steps past `ns` and columns past the block's
// are left alone (nothing reads them).
__device__ __forceinline__ void stage_tile(float* tile, const float* __restrict__ u,
                                           const float* __restrict__ delta,
                                           const float* __restrict__ dy,
                                           const float* __restrict__ bc,
                                           size_t r0, int ns, int KD, const Cols& s) {
  constexpr int kVec = kBlock / 4;                 // float4 copies a row
  for (int idx = threadIdx.x; idx < kSub * kOperands * kVec; idx += blockDim.x) {
    const int col = (idx % kVec) * 4;
    const int op = (idx / kVec) % kOperands;
    const int i = idx / (kVec * kOperands);
    if (i >= ns) continue;
    const size_t r = r0 + i;
    const float* src;
    if (op == 3) {
      if (col >= s.nbc) continue;
      src = bc + r * s.row_bc + s.bc0 + col;
    } else {
      if (col >= s.nch) continue;
      src = (op == 0 ? u : op == 1 ? delta : dy) + r * KD + s.c0 + col;
    }
    cp_async16(tile + (i * kOperands + op) * kBlock + col, src);
  }
  cp_async_commit();
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

// The sums over a warp's 32 lanes of 16 values: after the call lanes l and
// l + 16 hold sum number l % 16 (15 + 1 shuffles for 16 sums).
__device__ __forceinline__ float warp_sums16(float* v, int lane) {
  transpose_reduce_stage<16>(v, lane);
  transpose_reduce_stage<8>(v, lane);
  transpose_reduce_stage<4>(v, lane);
  transpose_reduce_stage<2>(v, lane);
  return v[0] + __shfl_xor_sync(kFull, v[0], 16);
}

// pass A: ckpt[b, j, s] = the state entering sub-chunk s of chunk j;
// adj[b, j] = the adjoint of the state entering chunk j when the adjoint of
// the state leaving it is zero; dsum[b, j] = the sum of delta over chunk j;
// the dC half of dbc_part (the states are at hand here).
template <int N>
__global__ void __launch_bounds__(kBlock)
forward_chunk_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                     const float* __restrict__ a_t, const float* __restrict__ bc,
                     const float* __restrict__ dy, const float* __restrict__ carries,
                     float* __restrict__ ckpt, float* __restrict__ adj,
                     float* __restrict__ dsum, float* __restrict__ dbc_part, int L,
                     int KD, int Dh, int chunk, int nchunks, int nsub_max) {
  static_assert(N == 16, "a warp sums 16 lanes of dC");
  extern __shared__ __align__(16) float smem[];   // two tiles
  const Cols cols = block_cols<N>(KD, Dh);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int c = cols.c0 + tid;
  const int warp_col = c & ~31;
  const bool active = tid < cols.nch;              // warp-uniform: KD % 32 == 0
  const int j = blockIdx.y;
  const int b = blockIdx.z;
  const int sc = active ? (c / Dh) * 2 * N - cols.bc0 : 0;   // this direction's bc
  const int t0 = j * chunk;
  const int t1 = min(t0 + chunk, L);
  const int nsub = (t1 - t0 + kSub - 1) / kSub;

  float a2[N], h[N], p[N], q[N];
  const size_t st = ((size_t)b * nchunks + j) * N * (size_t)KD + c;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = active ? a_t[n * KD + c] * kLog2e : 0.f;
    h[n] = (active && carries != nullptr) ? carries[st + (size_t)n * KD] : 0.f;
    p[n] = 1.f;
    q[n] = 0.f;
  }
  float ds = 0.f;
  const size_t ck0 = ((size_t)b * nchunks + j) * nsub_max;

  stage_tile(smem, u, delta, dy, bc, (size_t)b * L + t0, min(kSub, t1 - t0), KD, cols);
  for (int s = 0; s < nsub; ++s) {
    const int ts0 = t0 + s * kSub;
    const int ns = min(kSub, t1 - ts0);
    if (s + 1 < nsub) {
      stage_tile(smem + ((s + 1) & 1) * kTileFloats, u, delta, dy, bc,
                 (size_t)b * L + ts0 + kSub, min(kSub, t1 - ts0 - kSub), KD, cols);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const size_t ck = (ck0 + s) * N * (size_t)KD + c;
#pragma unroll
      for (int n = 0; n < N; ++n) ckpt[ck + (size_t)n * KD] = h[n];
      const float* tile = smem + (s & 1) * kTileFloats;
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        if (i >= ns) break;
        const float* row = tile + i * kOperands * kBlock;
        const float uv = row[tid];
        const float d = row[kBlock + tid];
        const float dyv = row[2 * kBlock + tid];
        const float* bcv = row + 3 * kBlock + sc;
        const float dxu = d * uv;
        ds += d;
        float v[N];                                     // dC before the sum over d
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float dan = ex2(d * a2[n]);
          h[n] = fmaf(dan, h[n], dxu * bcv[n]);
          p[n] *= dan;
          q[n] = fmaf(p[n], bcv[N + n] * dyv, q[n]);
          v[n] = h[n] * dyv;
        }
        const float dc = warp_sums16(v, lane);
        if (lane >= 16)
          dbc_part[((size_t)b * L + ts0 + i) * KD + warp_col + lane] = dc;
      }
    }
    __syncthreads();           // this tile's buffer is refilled next round
  }
  if (active && adj != nullptr) {
#pragma unroll
    for (int n = 0; n < N; ++n) adj[st + (size_t)n * KD] = q[n];
    dsum[((size_t)b * nchunks + j) * KD + c] = ds;
  }
}

// pass B: from the right, adj[b, j] becomes the adjoint of the state leaving
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
  // kAhead chunks' loads are issued before their stores: a chunk's row is
  // no longer in L2 after pass A, and one load at a time waits each time
  constexpr int kAhead = 8;
  for (int j0 = nchunks - 1; j0 >= 0; j0 -= kAhead) {
    float entry[kAhead], ds[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int j = j0 - i;
      if (j < 0) break;
      const size_t row = (size_t)b * nchunks + j;
      entry[i] = adj[(row * N + n) * KD + c];
      ds[i] = dsum[row * KD + c];
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int j = j0 - i;
      if (j < 0) break;
      adj[(((size_t)b * nchunks + j) * N + n) * KD + c] = q;
      q = exp2f(a2 * ds[i]) * q + entry[i];
    }
  }
}

template <int N>
constexpr size_t grad_smem_bytes() {
  // two tiles, then the stash hs[i][n][kBlock]: dA_t h_{t-1} of step i of
  // the sub-chunk
  return sizeof(float) * (2 * kTileFloats + kSub * N * kBlock);
}

// pass C: the gradients of one (batch, chunk) and 128 channels.
template <int N>
__global__ void __launch_bounds__(kBlock, 4)
grad_tile_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                 const float* __restrict__ a_t, const float* __restrict__ bc,
                 const float* __restrict__ dy, const float* __restrict__ ckpt,
                 const float* __restrict__ adj, float* __restrict__ du,
                 float* __restrict__ ddelta, float* __restrict__ dbc_part,
                 float* __restrict__ da_part, int L, int KD, int Dh, int chunk,
                 int nchunks, int nsub_max) {
  static_assert(N == 16, "a warp sums 16 lanes of dB");
  extern __shared__ __align__(16) float smem[];
  float* hs = smem + 2 * kTileFloats;
  const Cols cols = block_cols<N>(KD, Dh);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int c = cols.c0 + tid;
  const bool active = tid < cols.nch;
  const int j = blockIdx.y;
  const int b = blockIdx.z;
  const int sc = active ? (c / Dh) * 2 * N - cols.bc0 : 0;
  const int warp_col = c & ~31;                  // this warp's 32 dbc_part lanes
  const int t0 = j * chunk;
  const int t1 = min(t0 + chunk, L);
  const int nsub = (t1 - t0 + kSub - 1) / kSub;
  const size_t st = ((size_t)b * nchunks + j) * N * (size_t)KD + c;
  const size_t ck0 = ((size_t)b * nchunks + j) * nsub_max;

  float a2[N], q[N], da[N], hnext[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = active ? a_t[n * KD + c] * kLog2e : 0.f;
    // q: the adjoint of the state leaving the step about to be walked
    q[n] = (active && adj != nullptr) ? adj[st + (size_t)n * KD] : 0.f;
    da[n] = 0.f;
    hnext[n] = active ? ckpt[(ck0 + nsub - 1) * N * (size_t)KD + c + (size_t)n * KD]
                      : 0.f;
  }

  {
    const int ts0 = t0 + (nsub - 1) * kSub;
    stage_tile(smem + ((nsub - 1) & 1) * kTileFloats, u, delta, dy, bc,
               (size_t)b * L + ts0, t1 - ts0, KD, cols);
  }
  for (int s = nsub - 1; s >= 0; --s) {
    const int ts0 = t0 + s * kSub;
    const int ns = min(kSub, t1 - ts0);
    if (s > 0) {
      stage_tile(smem + ((s - 1) & 1) * kTileFloats, u, delta, dy, bc,
                 (size_t)b * L + ts0 - kSub, kSub, KD, cols);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      float h[N];
      float* col = hs + tid;
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = hnext[n];
      if (s > 0) {               // the next sub-chunk's stored state, in flight now
        const size_t ck = (ck0 + s - 1) * N * (size_t)KD + c;
#pragma unroll
        for (int n = 0; n < N; ++n) hnext[n] = ckpt[ck + (size_t)n * KD];
      }
      const float* tile = smem + (s & 1) * kTileFloats;
      // forwards: the sub-chunk's decayed states into the stash
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        if (i >= ns) break;
        const float* row = tile + i * kOperands * kBlock;
        const float dxu = row[kBlock + tid] * row[tid];
        const float d = row[kBlock + tid];
        const float* bcv = row + 3 * kBlock + sc;
        float* slot = col + i * N * kBlock;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float hm = ex2(d * a2[n]) * h[n];     // dA_t h_{t-1}
          h[n] = fmaf(dxu, bcv[n], hm);
          slot[n * kBlock] = hm;
        }
      }
      // backwards over the same tile
#pragma unroll
      for (int i = kSub - 1; i >= 0; --i) {
        if (i >= ns) continue;
        const float* row = tile + i * kOperands * kBlock;
        const float uv = row[tid];
        const float d = row[kBlock + tid];
        const float dyv = row[2 * kBlock + tid];
        const float* bcv = row + 3 * kBlock + sc;
        const float dxu = d * uv;
        const float* hm = col + i * N * kBlock;         // dA_t h_{t-1}
        float v[N];                                     // dB before the sum over d
        float gb = 0.f;
        float gha = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float g = fmaf(bcv[N + n], dyv, q[n]);
          const float dan = ex2(d * a2[n]);
          const float gh = g * hm[n * kBlock];            // g_t h_{t-1} dA_t
          gha = fmaf(gh, a2[n], gha);
          da[n] = fmaf(gh, d, da[n]);
          gb = fmaf(g, bcv[n], gb);
          q[n] = dan * g;
          v[n] = g * dxu;
        }
        const size_t r = (size_t)b * L + ts0 + i;
        ddelta[r * KD + c] = fmaf(gha, kLn2, uv * gb);
        du[r * KD + c] = d * gb;
        const float db = warp_sums16(v, lane);
        if (lane < 16) dbc_part[r * KD + warp_col + lane] = db;
      }
    }
    __syncthreads();           // this tile's buffer is refilled next round
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) da_part[st + (size_t)n * KD] = da[n];
  }
}

}  // namespace

// The number of stored states a chunk needs; the caller sizes `ckpt` as
// (B, chunks, this, N, K*Dh).
extern "C" int nnuzoo_selective_scan_bwd_nsub(int chunk) {
  return (chunk + kSub - 1) / kSub;
}

// Runs the passes on `stream`. Scratch that the caller allocates: `adj`
// (B, chunks, N, K*Dh) and `dsum` (B, chunks, K*Dh), both may be null when
// there is one chunk, as may `carries`; `ckpt` (B, chunks, nsub, N, K*Dh).
// Every pointer is 16-byte aligned. Returns the first launch error, or
// cudaSuccess.
extern "C" int nnuzoo_selective_scan_bwd(
    const float* u, const float* delta, const float* a_t, const float* bc,
    const float* dy, const float* carries, float* du, float* ddelta,
    float* dbc_part, float* da_part, float* adj, float* dsum, float* ckpt,
    int batch, int L, int K, int Dh, int N, int chunk, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  // N is a template argument so the states stay in registers, and 2N is the
  // warp's width in the [dB | dC] butterfly
  if (N != 16 || Dh % 32 != 0) return cudaErrorInvalidValue;
  const int KD = K * Dh;
  const int nchunks = (L + chunk - 1) / chunk;
  const int nsub = (chunk + kSub - 1) / kSub;
  const bool carried = nchunks > 1;
  const dim3 grid((KD + kBlock - 1) / kBlock, nchunks, batch);
  const int threads = KD < kBlock ? KD : kBlock;
  constexpr size_t kGradSmem = grad_smem_bytes<16>();
  static_assert(kGradSmem <= 48 * 1024,
                "above 48 KB a launch needs cudaFuncSetAttribute first");
  cudaError_t err;
  forward_chunk_kernel<16><<<grid, threads, 2 * kTileFloats * sizeof(float), stream>>>(
      u, delta, a_t, bc, dy, carried ? carries : nullptr, ckpt,
      carried ? adj : nullptr, carried ? dsum : nullptr, dbc_part, L, KD, Dh,
      chunk, nchunks, nsub);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (carried) {
    const size_t n_threads = (size_t)batch * N * KD;
    adjoint_carry_kernel<<<(unsigned)((n_threads + kThreads - 1) / kThreads),
                           kThreads, 0, stream>>>(a_t, adj, dsum, batch, KD, N,
                                                  nchunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  grad_tile_kernel<16><<<grid, threads, kGradSmem, stream>>>(
      u, delta, a_t, bc, dy, ckpt, carried ? adj : nullptr, du, ddelta,
      dbc_part, da_part, L, KD, Dh, chunk, nchunks, nsub);
  return cudaGetLastError();
}
