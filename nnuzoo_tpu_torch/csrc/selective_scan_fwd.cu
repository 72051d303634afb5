// Selective-scan forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_scan_core_pallas_fwd`
// (nnuzoo_tpu/ops/selective_scan.py:868, bodies `_fwd_kernel_mxu` :442 and
// `_fwd_kernel` :616). It computes the same function; none of the TPU devices
// (the MXU selection-matrix unpack of B/C, 128-lane packing, the VMEM chunk
// budget, the sequential grid carrying the state in scratch) carry over.
//
// Contract, every tensor fp32 and contiguous:
//   u, delta : (B, L, K*Dh)   delta already softplus'ed
//   A_t      : (N, K*Dh)      A transposed, column k*Dh + d
//   bc       : (B, L, K*2N)   per direction k the lanes hold [B_k | C_k]
//   y        : (B, L, K*Dh)
//   carries  : (B, chunks, N, K*Dh), optional: the state entering each chunk
//              of `chunk` steps, which the backward kernel
//              (selective_scan_bwd.cu) starts its chunks from
// For every batch b and channel c = k*Dh + d (direction k):
//   h_t[n] = exp(delta_t[c] * A[n, c]) * h_{t-1}[n] + delta_t[c] * u_t[c] * B_t[k, n]
//   y_t[c] = sum_n C_t[k, n] * h_t[n],        h_{-1} = 0.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores):
// each step of one channel reads u and delta and writes y (12 bytes) and, with
// Dh=32, a 32nd of its direction's 2N bc values (4 bytes at N=16): 16 bytes,
// against N states of ~7 operations each. So the function is bound by bytes:
// 0.421 ms at B=12, L=57344, K*Dh=128, N=16 (1.41 GB), 0.140 ms at B=4.
//
// Design: one launch, one read of the inputs, a decoupled look-back across
// groups of tiles. A block owns 128 channels (four warps; at M2NetP's
// K*Dh=128 all four directions, so the bc row of a step is staged whole and
// once) of one (batch, tile of kTile steps); one thread owns one channel and
// keeps its N states in registers. A chain is one (batch, column block); its
// tiles form groups of kGroup. The blocks take their place from an atomic
// ticket (group slowest, then chain, then tile), so a block only ever waits
// on blocks that already run: the look-back cannot deadlock.
//   1. the copy engine brings the tile's u, delta and bc columns into shared
//      memory once (cp.async.bulk, one barrier for each kSub steps);
//   2. walk 1, from shared memory as the steps land: the tile's end state
//      from a zero entry state and its sum of delta, published (behind a
//      flag) as the tile's aggregate;
//   3. the group's last tile composes the group's aggregates, oldest first,
//      into the group's (published behind the group's flag);
//   4. look-back over the groups: one warp polls the predecessors' group
//      flags, nearest first, until it meets a group that published its
//      inclusive state (the state leaving it) with only aggregates in between.
//      The block starts from that state and applies the aggregates between
//      one at a time, oldest first: h = exp2(A2 * dsum) * h + e, the
//      operation each group's last tile uses for the group's inclusive state,
//      which it publishes next. Then the block applies its group's earlier
//      tiles' aggregates in order. Every step is a fixed function of the
//      inputs, whichever predecessors had finished: reruns are bit-identical.
//      Composing the tiles of a group first cuts the look-back's serial chain
//      by kGroup: applying an aggregate costs an L2 round trip, and a chain of
//      one link a tile could not keep up with the tiles (1.2 ms at B=4 with
//      32-step tiles);
//   5. walk 2, from the same shared tile: y from the entry state, and, when
//      asked for, the carries: the state before each chunk start that falls
//      in the tile (the tile need not divide the backward's chunk).
// Flags and the ticket are zeroed in-stream by one memset before the launch.
//
// Bytes a channel-step: 16 read and written once (the bound's), plus the
// look-back's states, written once: 17 floats a tile and 33 a group, 1.8
// bytes at kTile=48 and kGroup=8; they are read back from L2 by the later
// tiles of the group and chain. The carries add 64 bytes a channel and chunk
// of the backward. exp2: two a state-step (walk 1 and walk 2), and one a
// state for each aggregate applied (some 6 a tile: 6% more), each one
// `ex2.approx.ftz` (exp2f with its subnormal fix-ups costs several
// instructions): a decay below 2^-126 flushes to zero, where its terms vanish
// anyway. At B=12, L=57344 that is 2.8e9 ex2 for the walks, at 16 a clock and
// SM 0.67-0.76 ms at 1.98-1.75 GHz: above the byte bound, the floor of this
// design.
// Measured on an H100 80GB HBM3 at 700 W (nnuzoo_tpu_torch/kernel_timing.py
// --kernel fwd, one call, in turns with the three-pass design it replaced):
// 1.034 ms at B=12, L=57344 with the carries (2.5x the byte bound, 1.5x the
// ex2 floor; the three passes took 2.453), 0.400 ms at B=4 without them
// (2.9x the bound; 0.925). A block at B=12 (the trace): walk 1 12.1 us, about
// 4 of them waiting for its first copies, the look-back 7.3 us (publishing
// 1.8, polling 1.9, group aggregates 0.8, the group's earlier tiles 2.9),
// walk 2 8.2 us; three blocks an SM (72 KB of shared memory each; 154
// registers, no spills), so the walks keep the ex2 unit busy about two
// thirds of the call. kTile=32 (four blocks an SM) and 64 (two) were slower
// in the same calls, as was one look-back link a tile.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlock = 128;   // channels of a block
constexpr int kTile = 48;     // steps of a tile
constexpr int kSub = 8;       // steps of a copy group (one barrier each)
constexpr int kGroup = 8;     // tiles of a group, the look-back's unit
constexpr int kAhead = 2;     // aggregates an apply loads at once
constexpr int kAggregate = 1;   // flag states; 0 is "nothing yet"
constexpr int kInclusive = 2;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTile % kSub == 0, "a tile is whole copy groups");

// Optional per-block trace, off unless a caller sets it
// (nnuzoo_selective_scan_fwd_trace): kTraceSlots 64-bit values per block, by
// ticket: %globaltimer (ns) at the start [0], after walk 1 [1], after the
// tile's and the group's aggregates are published [7], when the look-back
// knows where to start [5], with the group's entry state [4], with the
// tile's [2] and at the end [3]; the group aggregates applied, and the tile
// aggregates applied times 2^32 [6].
constexpr int kTraceSlots = 8;
__device__ unsigned long long* g_trace = nullptr;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of bulk copies on the barrier
__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a load of another block's published value: from L2 (never a stale L1
// line), and kept in program order with the flag checks before it
__device__ __forceinline__ float ldcg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

// a bulk copy of `bytes` (a multiple of 16, both ends on 16 bytes) by the
// copy engine, completing on `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
      "%2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The block's view of the operands: channels [c0, c0 + nch) of a row of u and
// delta, and columns [bc0, bc0 + nbc) of a row of bc, which hold the [B | C]
// lanes of every direction that those channels touch.
struct Cols {
  int c0, nch, bc0, nbc, row_bc;
};

__host__ __device__ inline Cols block_cols(int cb, int KD, int Dh, int N) {
  Cols s;
  s.c0 = cb * kBlock;
  s.nch = KD - s.c0 < kBlock ? KD - s.c0 : kBlock;
  const int k_lo = s.c0 / Dh;
  const int k_hi = (s.c0 + s.nch - 1) / Dh;
  s.bc0 = k_lo * 2 * N;
  s.nbc = (k_hi - k_lo + 1) * 2 * N;
  s.row_bc = (KD / Dh) * 2 * N;
  return s;
}

// Shared memory of a block: su and sd (kTile rows of `us` floats, u and
// delta of its channels), then sb (kTile rows of `bcw` floats, its bc
// columns). Each group of kSub steps lands on its own barrier; the copies
// are one per operand and group where the block's columns are whole rows of
// the operand (K*Dh <= 128, and bc whenever the block touches every
// direction), else one per operand and step, spread over the threads.
__device__ __forceinline__ void stage_tile(float* su, float* sd, float* sb, int us,
                                           int bcw, const float* __restrict__ u,
                                           const float* __restrict__ delta,
                                           const float* __restrict__ bc, size_t r0,
                                           int ns, int KD, const Cols& s,
                                           unsigned long long* bars) {
  const int ngroups = (ns + kSub - 1) / kSub;
  const bool whole_ud = s.nch == KD;
  const bool whole_bc = s.nbc == s.row_bc;
  // pieces a group: whole rows go as one piece, else one piece a step
  const int pieces_ud = whole_ud ? 1 : kSub;
  const int pieces_bc = whole_bc ? 1 : kSub;
  const int per_group = 2 * pieces_ud + pieces_bc;
  for (int q = threadIdx.x; q < ngroups * per_group; q += blockDim.x) {
    const int g = q / per_group;
    int p = q % per_group;
    const int i0 = g * kSub;
    const int ng = min(kSub, ns - i0);
    if (p < 2 * pieces_ud) {
      const bool is_u = p < pieces_ud;
      p = is_u ? p : p - pieces_ud;
      const float* src = (is_u ? u : delta) + (r0 + i0) * KD + s.c0;
      float* dst = (is_u ? su : sd) + i0 * us;
      if (whole_ud) {
        bulk_copy(dst, src, 4u * ng * s.nch, &bars[g]);
      } else if (p < ng) {
        bulk_copy(dst + p * us, src + (size_t)p * KD, 4u * s.nch, &bars[g]);
      }
    } else {
      p -= 2 * pieces_ud;
      const float* src = bc + (r0 + i0) * s.row_bc + s.bc0;
      float* dst = sb + i0 * bcw;
      if (whole_bc) {
        bulk_copy(dst, src, 4u * ng * s.nbc, &bars[g]);
      } else if (p < ng) {
        bulk_copy(dst + p * bcw, src + (size_t)p * s.row_bc, 4u * s.nbc, &bars[g]);
      }
    }
  }
}

// One step of a channel's N states from its staged delta, u and its
// direction's [B | C] lanes: h = dA * h + delta * u * B; returns sum_n C * h
// when kY.
template <int N, bool kY>
__device__ __forceinline__ float step(float* h, const float* a2, float d, float uv,
                                      const float* bcrow) {
  const float dxu = d * uv;
  const float4* bq = reinterpret_cast<const float4*>(bcrow);
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 b4 = bq[q];
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * q + e;
      h[n] = fmaf(ex2(d * a2[n]), h[n], dxu * bv[e]);
    }
    if (kY) {
      const float4 c4 = bq[N / 4 + q];
      acc = fmaf(c4.x, h[4 * q], acc);
      acc = fmaf(c4.y, h[4 * q + 1], acc);
      acc = fmaf(c4.z, h[4 * q + 2], acc);
      acc = fmaf(c4.w, h[4 * q + 3], acc);
    }
  }
  return acc;
}

// Set this block's flag after its writes: the barrier orders every thread's
// writes before thread 0's release store, which makes them visible with it.
__device__ __forceinline__ void publish(int* flag, int state) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(flag), "r"(state) : "memory");
}

// a flag, read with acquire: what its block wrote before setting it is
// visible to this thread's later loads
__device__ __forceinline__ int load_flag(const int* flag) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
  return v;
}

// Warp 0: the nearest predecessor group of group g (flags of one chain,
// stride ncb) that has published its inclusive state with only aggregates
// between; lane l polls group base - l.
__device__ __forceinline__ int look_back(const int* flags, int ncb, int g) {
  const int lane = threadIdx.x & 31;
  int base = g - 1;
  while (true) {
    const int k = base - lane;
    const int st = k >= 0 ? load_flag(flags + (size_t)k * ncb) : kInclusive;
    const unsigned incl = __ballot_sync(kFull, st == kInclusive);
    const unsigned none = __ballot_sync(kFull, st == 0);
    // the lanes nearer than the first inclusive state must hold aggregates
    const unsigned nearer = incl ? (incl & (0u - incl)) - 1u : kFull;
    if (none & nearer) continue;
    if (incl) return base - (__ffs(incl) - 1);
    base -= 32;
  }
}

// Warp 0: wait until tiles [k0, k1) of a chain (flags at stride ncb) have
// published their aggregates.
__device__ __forceinline__ void wait_all(const int* flags, int ncb, int k0, int k1) {
  const int lane = threadIdx.x & 31;
  for (int base = k0; base < k1; base += 32) {
    const int k = base + lane;
    while (true) {
      const int st = k < k1 ? load_flag(flags + (size_t)k * ncb) : kAggregate;
      if (__all_sync(kFull, st != 0)) break;
    }
  }
}

// Apply aggregates k0 .. k1 - 1 of a chain to x, oldest first:
// x = exp2(A2 * ds_k) * x + e_k, with e (k, n, channel) and ds (k, channel)
// slots. kAhead aggregates' loads are in flight at once.
template <int N>
__device__ __forceinline__ void apply(float* x, const float* a2, const float* e,
                                      const float* ds, int k0, int k1, int KD, int c) {
  for (int k = k0; k < k1; k += kAhead) {
    float dk[kAhead], ek[kAhead][N];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const size_t kk = min(k + i, k1 - 1);
      dk[i] = ldcg(ds + kk * KD + c);
#pragma unroll
      for (int n = 0; n < N; ++n) ek[i][n] = ldcg(e + (kk * N + n) * KD + c);
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (k + i >= k1) break;
#pragma unroll
      for (int n = 0; n < N; ++n) x[n] = fmaf(ex2(dk[i] * a2[n]), x[n], ek[i][n]);
    }
  }
}

// blocks an SM holds by shared memory (a tile of 1.5 KB a step at M2NetP's
// widths): the registers a thread may take follow from it
constexpr int kMinBlocks = 232448 / (kTile * 3 * kBlock * 4 + 1024);

template <int N>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
scan_lookback_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                     const float* __restrict__ a_t, const float* __restrict__ bc,
                     float* __restrict__ y, float* __restrict__ carries, int* flags,
                     unsigned* ticket, float* agg, float* agg_dsum, float* gagg,
                     float* gdsum, float* gincl,
                     int batch, int L, int KD, int Dh, int ntiles, int ncb,
                     int bcw, int chunk) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bars[kTile / kSub];
  __shared__ unsigned s_ticket;
  __shared__ int s_from;
  const int tid = threadIdx.x;
  unsigned long long* trace = tid == 0 ? g_trace : nullptr;
  if (tid == 0) {
    s_ticket = atomicAdd(ticket, 1u);
    for (int k = 0; k < kTile / kSub; ++k) bar_init(&bars[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const unsigned tk = s_ticket;
  if (trace != nullptr) {
    trace += (size_t)tk * kTraceSlots;
    trace[0] = global_ns();
  }
  // tickets run group by group, then by batch and column block, then by
  // tile within the group (the last group may have fewer tiles): a block
  // waits only on lower tickets, and a group's predecessor in its chain
  // started some B * ncb * kGroup tickets before it
  const int ngroups = (ntiles + kGroup - 1) / kGroup;
  const unsigned chains = (unsigned)batch * ncb;
  const unsigned full = (unsigned)(ngroups - 1) * chains * kGroup;
  const int width = tk < full ? kGroup : ntiles - (ngroups - 1) * kGroup;
  const unsigned rest = tk < full ? tk % (chains * kGroup) : tk - full;
  const int g = tk < full ? (int)(tk / (chains * kGroup)) : ngroups - 1;
  const int r = (int)(rest % width);
  const int cb = (int)((rest / width) % ncb);
  const int b = (int)(rest / width / ncb);
  const int j = g * kGroup + r;
  const Cols cols = block_cols(cb, KD, Dh, N);
  const int c = cols.c0 + tid;
  const bool active = tid < cols.nch;
  const int sc = active ? (c / Dh) * 2 * N - cols.bc0 : 0;
  const int t0 = j * kTile;
  const int ns = min(kTile, L - t0);
  const size_t r0 = (size_t)b * L + t0;
  const int ncopy = (ns + kSub - 1) / kSub;   // groups of copies
  const int us = KD < kBlock ? KD : kBlock;
  float* su = smem;
  float* sd = su + kTile * us;
  float* sb = sd + kTile * us;
  if (tid == 0) {
    for (int k = 0; k < ncopy; ++k)
      bar_expect(&bars[k], 4u * min(kSub, ns - k * kSub) * (2 * cols.nch + cols.nbc));
  }
  __syncthreads();   // the expected bytes are set before any copy lands
  stage_tile(su, sd, sb, us, bcw, u, delta, bc, r0, ns, KD, cols, bars);

  float a2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = active ? a_t[n * KD + c] * kLog2e : 0.f;
    h[n] = 0.f;
  }

  // walk 1: the tile's end state from zero, and its sum of delta, each group
  // of steps as it lands; every thread waits, so the whole tile has landed
  // before the block moves on
  float ds = 0.f;
  for (int k = 0; k < ncopy; ++k) {
    bar_wait(&bars[k], 0);
    if (active) {
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int ti = k * kSub + i;
        if (ti >= ns) break;
        const float d = sd[ti * us + tid];
        ds += d;
        step<N, false>(h, a2, d, su[ti * us + tid], sb + ti * bcw + sc);
      }
    }
  }

  // the entry state. Slots are (batch, tile or group, n, channel) for states
  // and (batch, tile or group, channel) for sums of delta; flags (batch,
  // tile or group, column block), the tiles' before the groups'.
  if (trace != nullptr) trace[1] = global_ns();
  const int j0 = g * kGroup;                       // the group's first tile
  const int last = width - 1;                      // and its last rank
  const bool group_successor = g + 1 < ngroups;
  const size_t tchain = (size_t)b * ntiles;
  const size_t gchain = (size_t)b * ngroups;
  int* tflags = flags + tchain * ncb + cb;
  int* gflags = flags + (size_t)batch * ntiles * ncb + gchain * ncb + cb;
  const float* te = agg + tchain * N * KD;
  const float* tds = agg_dsum + tchain * KD;

  // 1. the tile's aggregate, for the later tiles of its group (the last
  //    tile keeps its own in the same slots, not in registers)
  const size_t mine = (tchain + j) * N * KD + c;
  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) agg[mine + (size_t)n * KD] = h[n];
    agg_dsum[(tchain + j) * KD + c] = ds;
  }
  if (r < last) publish(tflags + (size_t)j * ncb, kAggregate);
  // 2. the group's aggregate, by its last tile: the group's tiles composed
  //    in order from zero, and their sum of delta
  if (r == last && group_successor) {
    if (r > 0) {
      if (tid < 32) wait_all(tflags, ncb, j0, j);
      __syncthreads();
    }
    if (active) {
      float e[N];
#pragma unroll
      for (int n = 0; n < N; ++n) e[n] = 0.f;
      apply<N>(e, a2, te, tds, j0, j + 1, KD, c);
      float dsg = 0.f;
      for (int k = j0; k <= j; ++k) dsg += ldcg(tds + (size_t)k * KD + c);
      const size_t at = gchain + g;
#pragma unroll
      for (int n = 0; n < N; ++n)
        (g == 0 ? gincl : gagg)[(at * N + n) * KD + c] = e[n];
      gdsum[at * KD + c] = dsg;
    }
    publish(gflags + (size_t)g * ncb, g == 0 ? kInclusive : kAggregate);
  }
  if (trace != nullptr) trace[7] = global_ns();
  // 3. the group's entry state: look back over the groups, and apply their
  //    aggregates one at a time, oldest first, from the nearest inclusive
  //    state. Every group's inclusive state is exp2(A2 * dsum) * entry + e
  //    of its own aggregate, the operation applied here, so the result has
  //    the same bits whichever predecessors had finished.
  float entry[N];
#pragma unroll
  for (int n = 0; n < N; ++n) entry[n] = 0.f;
  if (g > 0) {
    if (tid < 32) {
      const int from = look_back(gflags, ncb, g);
      if (tid == 0) s_from = from;
    }
    __syncthreads();
    const int from = s_from;
    if (trace != nullptr) {
      trace[5] = global_ns();
      trace[6] = g - 1 - from;
    }
    if (active) {
#pragma unroll
      for (int n = 0; n < N; ++n)
        entry[n] = ldcg(gincl + ((gchain + from) * N + n) * KD + c);
      apply<N>(entry, a2, gagg + gchain * N * KD, gdsum + gchain * KD, from + 1, g,
               KD, c);
    }
  }
  if (trace != nullptr) trace[4] = global_ns();
  // 4. the group's inclusive state, by its last tile
  if (r == last && group_successor && g > 0) {
    if (active) {
      const size_t at = gchain + g;
      const float dsg = gdsum[at * KD + c];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const size_t s_at = (at * N + n) * KD + c;
        gincl[s_at] = fmaf(ex2(dsg * a2[n]), entry[n], gagg[s_at]);
      }
    }
    publish(gflags + (size_t)g * ncb, kInclusive);
  }
  // 5. the tile's entry state: the group's earlier tiles applied in order
  if (r > 0) {
    if (!(r == last && group_successor)) {
      if (tid < 32) wait_all(tflags, ncb, j0, j);
      __syncthreads();
    }
    if (active) apply<N>(entry, a2, te, tds, j0, j, KD, c);
  }
  if (trace != nullptr) {
    trace[6] |= (unsigned long long)r << 32;
    trace[2] = global_ns();
  }

  // walk 2: y from the entry state; the carries at the chunk starts in the tile
  if (!active) return;
  // thread 0 is active (a block has at least one channel): it stamps the end
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = entry[n];
  int next = carries != nullptr ? (t0 + chunk - 1) / chunk * chunk : INT_MAX;
  const int nchunks = carries != nullptr ? (L + chunk - 1) / chunk : 0;
#pragma unroll 4
  for (int i = 0; i < ns; ++i) {
    if (t0 + i == next) {
      float* dst = carries + ((size_t)b * nchunks + next / chunk) * N * KD + c;
#pragma unroll
      for (int n = 0; n < N; ++n) dst[(size_t)n * KD] = h[n];
      next += chunk;
    }
    y[(r0 + i) * KD + c] =
        step<N, true>(h, a2, sd[i * us + tid], su[i * us + tid], sb + i * bcw + sc);
  }
  if (trace != nullptr) trace[3] = global_ns();
}

// The widest bc span of a block, in floats (every direction its channels touch).
int bc_width(int KD, int Dh, int N) {
  int w = 0;
  for (int cb = 0; cb * kBlock < KD; ++cb) {
    const int nbc = block_cols(cb, KD, Dh, N).nbc;
    w = nbc > w ? nbc : w;
  }
  return w;
}

// The dynamic shared memory a block may take, opted into once per device.
cudaError_t max_dynamic_smem(int* bytes) {
  static int known[64] = {0};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && known[dev] > 0) {
    *bytes = known[dev];
    return cudaSuccess;
  }
  int optin;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, scan_lookback_kernel<16>);
  if (err != cudaSuccess) return err;
  const int dyn = optin - (int)attr.sharedSizeBytes;
  err = cudaFuncSetAttribute(scan_lookback_kernel<16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  if (dev < 64) known[dev] = dyn;
  *bytes = dyn;
  return cudaSuccess;
}

}  // namespace

// Steps of a tile and tiles of a group: the caller sizes the look-back
// scratch by them.
extern "C" int nnuzoo_selective_scan_fwd_tile() { return kTile; }
extern "C" int nnuzoo_selective_scan_fwd_group() { return kGroup; }

// Trace the calls that follow into `trace` (kTraceSlots 64-bit values a
// block, by ticket; see g_trace), or stop tracing with null. Returns the
// slots a block takes, or a negative CUDA error.
extern "C" int nnuzoo_selective_scan_fwd_trace(void* trace) {
  const cudaError_t err = cudaMemcpyToSymbol(g_trace, &trace, sizeof(trace));
  return err == cudaSuccess ? kTraceSlots : -(int)err;
}

// One memset and one launch on `stream`. Scratch that the caller allocates,
// with tiles = ceil(L / kTile), groups = ceil(tiles / kGroup) and cb =
// ceil(K*Dh / 128): `flags`, B * (tiles + groups) * cb + 1 ints (the last is
// the ticket); `agg` (B, tiles, N, K*Dh) and `agg_dsum` (B, tiles, K*Dh),
// `gagg` and `gincl` (B, groups, N, K*Dh) and `gdsum` (B, groups, K*Dh)
// floats. `carries` (B, ceil(L / chunk), N, K*Dh) may be null (then `chunk`
// is not read). u, delta and bc start on 16 bytes and K*Dh is a multiple of
// 4. Returns the first error, or cudaSuccess.
extern "C" int nnuzoo_selective_scan_fwd(const float* u, const float* delta,
                                         const float* a_t, const float* bc,
                                         float* y, float* carries, int* flags,
                                         float* agg, float* agg_dsum, float* gagg,
                                         float* gdsum, float* gincl,
                                         int batch, int L, int K, int Dh, int N,
                                         int chunk, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  // N is a template argument so the states stay in registers; the SS2D
  // blocks of M2Net use d_state 16
  const int KD = K * Dh;
  if (N != 16 || KD % 4 != 0 || L < 1 || batch < 1) return cudaErrorInvalidValue;
  if (carries != nullptr && chunk < 1) return cudaErrorInvalidValue;
  const int ntiles = (L + kTile - 1) / kTile;
  const int ngroups = (ntiles + kGroup - 1) / kGroup;
  const int ncb = (KD + kBlock - 1) / kBlock;
  const size_t blocks = (size_t)batch * ntiles * ncb;
  const size_t nflags = blocks + (size_t)batch * ngroups * ncb;
  if (blocks >= (size_t)INT_MAX) return cudaErrorInvalidValue;
  const int bcw = bc_width(KD, Dh, N);
  const size_t smem = sizeof(float) * kTile * (2 * (KD < kBlock ? KD : kBlock) + bcw);
  int smem_max;
  cudaError_t err = max_dynamic_smem(&smem_max);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  const int threads = KD < kBlock ? (KD + 31) / 32 * 32 : kBlock;
  int* ticket_flags = flags;
  err = cudaMemsetAsync(ticket_flags, 0, (nflags + 1) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  scan_lookback_kernel<16><<<(unsigned)blocks, threads, smem, stream>>>(
      u, delta, a_t, bc, y, carries, flags,
      reinterpret_cast<unsigned*>(flags + nflags), agg, agg_dsum, gagg, gdsum, gincl,
      batch, L,
      KD, Dh, ntiles, ncb, bcw, chunk);
  return cudaGetLastError();
}
