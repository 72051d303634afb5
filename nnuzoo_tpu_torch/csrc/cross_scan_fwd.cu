// Fused cross-scan forward for Hopper (sm_90a): the projections of each scan
// direction and its selective scan in one kernel.
//
// Replaces the TPU kernel `_cross_scan_pallas_fwd`
// (nnuzoo_tpu/ops/cross_scan.py:313, body `_fwd_kernel` :141 with its
// prologue `_projections` :96). It computes the same function (contract in
// cross_scan_common.cuh); the TPU kernel's batch lane packing, its
// BlockSpec-mirrored chunk walk and its sequential grid do not carry over.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores,
// 16 exp2 a clock on each of 132 SMs at up to 1.98 GHz): a step of one
// channel reads u (4 bytes) and writes y (4 bytes), against C = R+2N
// multiply-adds of the projection (x_dbl is shared by a direction's Dh
// channels: C a channel), R for dt_proj, ~4 for softplus and the D term, and
// N states of ~7 operations each, one of them an exp2: 184 operations for 8
// bytes at M2NetP (R=1, N=16). At B=12, L=57344, G=2, Dh=32 it moves 0.35 GB
// (0.105 ms), does 8.1 GFLOP (0.121 ms) and 7.05e8 exp2 (0.169 ms): the
// exp2 the function cannot avoid bound it.
//
// Design: one launch, one read of the streams, the projections made once a
// tile, a decoupled look-back across groups of tiles (K1's protocol,
// csrc/selective_scan_fwd.cu, on K3's operands). A block is one (batch, tile
// of kTile traversal steps) over `dirs` directions' channels (every
// direction at M2NetP's widths: 2 warps; at most kBlock channels, so wider
// shapes split the directions over column blocks); thread t owns channel t
// of its directions and keeps its N states in registers. A chain is one
// (batch, column block); its tiles form groups of kGroup. The blocks take
// their place from an atomic ticket (group slowest, then chain, then tile),
// so a block only ever waits on blocks that already run: the look-back
// cannot deadlock.
//   1. the copy engine brings each direction's u rows of the tile into
//      shared memory once (cp.async.bulk, one barrier for each kSub steps).
//      A tile of one stream is one contiguous range of positions in either
//      orientation: with `reverse` the block copies the mirrored range and
//      reads it from the end. wx goes to shared memory beside it;
//   2. the tile's x_dbl (kTile, R+2N) of each direction: a thread owns one
//      output column for 4 steps at a time, with u read as broadcasts, each
//      output one accumulator over k = 0 .. Dh-1 (the order K4 makes it in,
//      so the two kernels' x_dbl agree bit for bit). It stays in shared
//      memory for both walks;
//   3. walk 1: the tile's end state from a zero entry state and its sum of
//      delta, published (behind a flag) as the tile's aggregate;
//   4. the group's last tile composes the group's aggregates, oldest first;
//      look-back over the groups from the nearest inclusive state, each
//      aggregate applied one at a time, oldest first, then the group's
//      earlier tiles: every state is a fixed formula of the inputs,
//      whichever predecessors had finished, so reruns are bit-identical;
//   5. walk 2, from the same shared tile: y from the entry state, with the
//      D term, and, only when asked, the carries that K4 starts from: the
//      state before each of its chunk starts that falls in the tile.
// Flags and the ticket are zeroed in-stream by one memset before the launch.
// delta, B, C, exp(delta*A) and the flipped sequences never reach device
// memory.
//
// Bytes a channel-step: 8 read and written once (the bound's), plus the
// look-back's states, written once (17 floats a tile and 33 a group, 1.8
// bytes at kTile=48 and kGroup=8, read back from L2), plus wx read by every
// block from L2. The carries add 64 bytes a channel and chunk of K4. exp2:
// two a state-step (walk 1 and walk 2) and one a state for each aggregate
// applied, each one `ex2.approx.ftz` (a decay below 2^-126 flushes to zero,
// where its terms vanish anyway): 1.41e9 at B=12, L=57344 for the walks, at
// 16 a clock and SM 0.34-0.38 ms at 1.98-1.75 GHz, the floor of this design.
// Measured on an H100 80GB HBM3 at 700 W (nnuzoo_tpu_torch/kernel_timing.py
// --kernel cross_fwd, one call, in turns with the three-pass design it
// replaced, which made the projections in two passes and carried the state
// across chunks in a serial third): 0.87 ms at B=12, L=57344 with the
// carries, in either orientation (5.2x the exp2 bound, 2.4x the walks' ex2
// floor; the three passes took 1.95), 0.33 ms at B=4 without them (0.73);
// 0.25 against 0.54 at B=12, L=14336 and 0.11 against 0.17 at L=3584. At
// M2NetP a block takes 144-151 registers (no spills) and 35,616 bytes of
// shared memory: six 2-warp blocks an SM, too few warps to hide each step's
// chain (softplus, then the states) in both walks; at L <= 1000 a call's
// 24-37 us of device time is that chain over a tile or two. In the same
// call one thread an x_dbl output (1.04 ms at L=57344) and delta kept in
// shared memory for walk 2 (0.94: four blocks an SM) were slower.

#include <climits>

#include "cross_scan_common.cuh"

namespace {

using namespace cross_scan;

constexpr int kTile = 48;      // traversal steps of a tile
constexpr int kSub = 8;        // steps of a copy group (one barrier each)
constexpr int kGroup = 8;      // tiles of a group, the look-back's unit
constexpr int kAhead = 2;      // aggregates an apply loads at once
constexpr int kBlock = 256;    // most channels of a block
constexpr int kAggregate = 1;  // flag states; 0 is "nothing yet"
constexpr int kInclusive = 2;
static_assert(kTile % kSub == 0, "a tile is whole copy groups");

// An x_dbl row in shared memory: dt (R values, padded to a multiple of 4),
// B (N), C (N), so that B and C are read 16 bytes at a time.
__host__ __device__ constexpr int row_dt(int R) { return (R + 3) / 4 * 4; }
__host__ __device__ constexpr int row_width(int R) { return row_dt(R) + 2 * kN; }

template <int R>
__device__ __forceinline__ constexpr int row_col(int cc) {
  return cc < R ? cc : cc - R + row_dt(R);
}

// Directions of a block, and the shared memory of one direction in floats:
// its u rows (kTile, Dh) in position order, wx (C, Dh+4: float4 rows on
// distinct banks) and x_dbl (kTile, W) in traversal order.
__host__ __device__ inline int block_dirs(int G, int Dh) {
  return G < kBlock / Dh ? G : kBlock / Dh;
}
__host__ __device__ inline int dir_floats(int Dh, int R) {
  return kTile * Dh + (R + 2 * kN) * (Dh + 4) + kTile * row_width(R);
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

// One step of a channel's N states from its delta, delta*u and its
// direction's B (and C) lanes of the step's x_dbl row:
// h = exp2(delta * A2) * h + delta * u * B; returns sum_n C * h when kY.
template <bool kY>
__device__ __forceinline__ float step(float* h, const float* a2, float delta,
                                      float du, const float* b_row,
                                      const float* c_row) {
  const float4* bq = reinterpret_cast<const float4*>(b_row);
  const float4* cq = reinterpret_cast<const float4*>(c_row);
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < kN / 4; ++q) {
    const float4 b4 = bq[q];
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * q + e;
      h[n] = fmaf(ex2(delta * a2[n]), h[n], du * bv[e]);
    }
    if (kY) {
      const float4 c4 = cq[q];
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

// Warp 0: the nearest predecessor group of group gi (flags of one chain,
// stride ncb) that has published its inclusive state with only aggregates
// between; lane l polls group base - l.
__device__ __forceinline__ int look_back(const int* flags, int ncb, int gi) {
  const int lane = threadIdx.x & 31;
  int base = gi - 1;
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
// slots of GD channels. kAhead aggregates' loads are in flight at once.
__device__ __forceinline__ void apply(float* x, const float* a2, const float* e,
                                      const float* ds, int k0, int k1, int GD, int c) {
  for (int k = k0; k < k1; k += kAhead) {
    float dk[kAhead], ek[kAhead][kN];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const size_t kk = min(k + i, k1 - 1);
      dk[i] = ldcg(ds + kk * GD + c);
#pragma unroll
      for (int n = 0; n < kN; ++n) ek[i][n] = ldcg(e + (kk * kN + n) * GD + c);
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (k + i >= k1) break;
#pragma unroll
      for (int n = 0; n < kN; ++n) x[n] = fmaf(ex2(dk[i] * a2[n]), x[n], ek[i][n]);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kBlock, 1)
cross_fwd_tile_kernel(Streams streams, const float* __restrict__ wx,
                      const float* __restrict__ wdt, const float* __restrict__ dtb,
                      const float* __restrict__ A, const float* __restrict__ Ds,
                      float* __restrict__ y, float* __restrict__ carries, int* flags,
                      unsigned* ticket, float* agg, float* agg_dsum, float* gagg,
                      float* gdsum, float* gincl, int batch, int L, int G, int Dh,
                      int dirs, int ntiles, int ncb, int chunk, int reverse) {
  constexpr int C = R + 2 * kN;
  constexpr int W = row_width(R);
  constexpr int kB = row_dt(R);
  constexpr int kC = kB + kN;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bars[kTile / kSub];
  __shared__ unsigned s_ticket;
  __shared__ int s_from;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_ticket = atomicAdd(ticket, 1u);
    for (int k = 0; k < kTile / kSub; ++k) bar_init(&bars[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const unsigned tk = s_ticket;
  // tickets run group by group, then by batch and column block, then by
  // tile within the group (the last group may have fewer tiles): a block
  // waits only on lower tickets
  const int ngroups = (ntiles + kGroup - 1) / kGroup;
  const unsigned chains = (unsigned)batch * ncb;
  const unsigned full = (unsigned)(ngroups - 1) * chains * kGroup;
  const int width = tk < full ? kGroup : ntiles - (ngroups - 1) * kGroup;
  const unsigned rest = tk < full ? tk % (chains * kGroup) : tk - full;
  const int gi = tk < full ? (int)(tk / (chains * kGroup)) : ngroups - 1;
  const int r = (int)(rest % width);
  const int cb = (int)((rest / width) % ncb);
  const int b = (int)(rest / width / ncb);
  const int j = gi * kGroup + r;

  // the block's directions g0 .. g0+nd-1; thread tid owns channel d of
  // direction g0 + gl
  const int GD = G * Dh;
  const int g0 = cb * dirs;
  const int nd = min(dirs, G - g0);
  const int gl = tid / Dh;
  const int d = tid % Dh;
  const bool active = gl < nd;
  const int c = (g0 + gl) * Dh + d;
  const int t0 = j * kTile;
  const int ns = min(kTile, L - t0);
  const int ncopy = (ns + kSub - 1) / kSub;
  const int per_dir = dir_floats(Dh, R);
  if (tid == 0) {
    for (int k = 0; k < ncopy; ++k)
      bar_expect(&bars[k], 4u * min(kSub, ns - k * kSub) * Dh * nd);
  }
  __syncthreads();   // the expected bytes are set before any copy lands
  // 1. the u rows, one copy a (direction, copy group). Traversal steps
  //    i0 .. i0+ng-1 are tile rows i0 .. (forwards) or ns-i0-ng ..
  //    (reversed): the tile's rows hold positions t0 .. t0+ns-1, or
  //    L-t0-ns .. L-t0-1, in position order.
  for (int q = tid; q < nd * ncopy; q += blockDim.x) {
    const int gq = q / ncopy;
    const int k = q % ncopy;
    const int i0 = k * kSub;
    const int ng = min(kSub, ns - i0);
    const int row0 = reverse ? ns - i0 - ng : i0;
    const int p0 = reverse ? L - t0 - ns + row0 : t0 + row0;
    bulk_copy(smem + gq * per_dir + row0 * Dh,
              streams.p[g0 + gq] + ((size_t)b * L + p0) * Dh, 4u * ng * Dh, &bars[k]);
  }
  // wx of the block's directions beside them, while the copies fly
  {
    const int n4 = C * Dh / 4;
    for (int o = tid; o < nd * n4; o += blockDim.x) {
      const int gq = o / n4;
      const int e = (o % n4) * 4;
      const float4 v = reinterpret_cast<const float4*>(wx + (size_t)(g0 + gq) * C * Dh)[o % n4];
      *reinterpret_cast<float4*>(smem + gq * per_dir + kTile * Dh + (e / Dh) * (Dh + 4) +
                                 e % Dh) = v;
    }
  }
  float a2[kN], h[kN], wdt_r[R];
  float bias = 0.f, dd = 0.f;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a2[n] = active ? A[c * kN + n] * kLog2e : 0.f;
    h[n] = 0.f;
  }
#pragma unroll
  for (int rr = 0; rr < R; ++rr) wdt_r[rr] = active ? wdt[c * R + rr] : 0.f;
  if (active) {
    bias = dtb[c];
    dd = Ds[c];
  }
  __syncthreads();   // wx staged

  // 2. x_dbl = wx[g] u of the tile's steps: a thread owns one output column
  //    of one direction for 4 steps at a time, 4 sums in flight, each over
  //    k = 0 .. Dh-1 in order; consecutive threads take consecutive columns
  //    of the same 4 steps (the u rows broadcasts, the wx rows on distinct
  //    banks), so a float4 of wx serves 16 multiply-adds
  for (int k = 0; k < ncopy; ++k) bar_wait(&bars[k], 0);
  {
    const int nq = (ns + 3) / 4;
    for (int o = tid; o < nd * nq * C; o += blockDim.x) {
      const int cc = o % C;
      const int i4 = (o / C) % nq * 4;
      const int gq = o / (C * nq);
      float* base = smem + gq * per_dir;
      const float4* wr4 = reinterpret_cast<const float4*>(base + kTile * Dh + cc * (Dh + 4));
      const float4* ur4[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = min(i4 + s, ns - 1);
        ur4[s] = reinterpret_cast<const float4*>(base + (reverse ? ns - 1 - i : i) * Dh);
      }
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int q = 0; q < Dh / 4; ++q) {
        const float4 w = wr4[q];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float4 a = ur4[s][q];
          acc[s] = fmaf(a.x, w.x, acc[s]);
          acc[s] = fmaf(a.y, w.y, acc[s]);
          acc[s] = fmaf(a.z, w.z, acc[s]);
          acc[s] = fmaf(a.w, w.w, acc[s]);
        }
      }
      float* xd = base + kTile * Dh + C * (Dh + 4) + row_col<R>(cc);
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (i4 + s < ns) xd[(i4 + s) * W] = acc[s];
    }
  }
  __syncthreads();   // the tile's x_dbl is complete
  const float* u_s = smem + (active ? gl : 0) * per_dir;
  const float* xd_s = u_s + kTile * Dh + C * (Dh + 4);

  // 3. walk 1: the tile's end state from zero, and its sum of delta
  float ds = 0.f;
  if (active) {
#pragma unroll 4
    for (int i = 0; i < ns; ++i) {
      const float* xr = xd_s + i * W;
      const float delta = step_delta<R>(xr, wdt_r, bias);
      const float uv = u_s[(reverse ? ns - 1 - i : i) * Dh + d];
      ds += delta;
      step<false>(h, a2, delta, delta * uv, xr + kB, xr + kC);
    }
  }

  // 4. the entry state. Slots are (batch, tile or group, n, channel) for
  //    states and (batch, tile or group, channel) for sums of delta; flags
  //    (batch, tile or group, column block), the tiles' before the groups'.
  const int j0 = gi * kGroup;                      // the group's first tile
  const int last = width - 1;                      // and its last rank
  const bool group_successor = gi + 1 < ngroups;
  const size_t tchain = (size_t)b * ntiles;
  const size_t gchain = (size_t)b * ngroups;
  int* tflags = flags + tchain * ncb + cb;
  int* gflags = flags + (size_t)batch * ntiles * ncb + gchain * ncb + cb;
  const float* te = agg + tchain * kN * GD;
  const float* tds = agg_dsum + tchain * GD;

  // the tile's aggregate, for the later tiles of its group (the last tile
  // keeps its own in the same slots, not in registers)
  const size_t mine = (tchain + j) * kN * GD + c;
  if (active) {
#pragma unroll
    for (int n = 0; n < kN; ++n) agg[mine + (size_t)n * GD] = h[n];
    agg_dsum[(tchain + j) * GD + c] = ds;
  }
  if (r < last) publish(tflags + (size_t)j * ncb, kAggregate);
  // the group's aggregate, by its last tile: the group's tiles composed in
  // order from zero, and their sum of delta
  if (r == last && group_successor) {
    if (r > 0) {
      if (tid < 32) wait_all(tflags, ncb, j0, j);
      __syncthreads();
    }
    if (active) {
      float e[kN];
#pragma unroll
      for (int n = 0; n < kN; ++n) e[n] = 0.f;
      apply(e, a2, te, tds, j0, j + 1, GD, c);
      float dsg = 0.f;
      for (int k = j0; k <= j; ++k) dsg += ldcg(tds + (size_t)k * GD + c);
      const size_t at = gchain + gi;
#pragma unroll
      for (int n = 0; n < kN; ++n)
        (gi == 0 ? gincl : gagg)[(at * kN + n) * GD + c] = e[n];
      gdsum[at * GD + c] = dsg;
    }
    publish(gflags + (size_t)gi * ncb, gi == 0 ? kInclusive : kAggregate);
  }
  // the group's entry state: look back over the groups, and apply their
  // aggregates one at a time, oldest first, from the nearest inclusive
  // state. Every group's inclusive state is exp2(A2 * dsum) * entry + e of
  // its own aggregate, the operation applied here, so the result has the
  // same bits whichever predecessors had finished.
  float entry[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) entry[n] = 0.f;
  if (gi > 0) {
    if (tid < 32) {
      const int from = look_back(gflags, ncb, gi);
      if (tid == 0) s_from = from;
    }
    __syncthreads();
    const int from = s_from;
    if (active) {
#pragma unroll
      for (int n = 0; n < kN; ++n)
        entry[n] = ldcg(gincl + ((gchain + from) * kN + n) * GD + c);
      apply(entry, a2, gagg + gchain * kN * GD, gdsum + gchain * GD, from + 1, gi, GD,
            c);
    }
  }
  // the group's inclusive state, by its last tile
  if (r == last && group_successor && gi > 0) {
    if (active) {
      const size_t at = gchain + gi;
      const float dsg = gdsum[at * GD + c];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const size_t s_at = (at * kN + n) * GD + c;
        gincl[s_at] = fmaf(ex2(dsg * a2[n]), entry[n], gagg[s_at]);
      }
    }
    publish(gflags + (size_t)gi * ncb, kInclusive);
  }
  // the tile's entry state: the group's earlier tiles applied in order
  if (r > 0) {
    if (!(r == last && group_successor)) {
      if (tid < 32) wait_all(tflags, ncb, j0, j);
      __syncthreads();
    }
    if (active) apply(entry, a2, te, tds, j0, j, GD, c);
  }

  // 5. walk 2: y from the entry state; the carries at the chunk starts in
  //    the tile
  if (!active) return;
#pragma unroll
  for (int n = 0; n < kN; ++n) h[n] = entry[n];
  int next = carries != nullptr ? (t0 + chunk - 1) / chunk * chunk : INT_MAX;
  const int nchunks = carries != nullptr ? (L + chunk - 1) / chunk : 0;
#pragma unroll 4
  for (int i = 0; i < ns; ++i) {
    if (t0 + i == next) {
      float* dst = carries + ((size_t)b * nchunks + next / chunk) * kN * GD + c;
#pragma unroll
      for (int n = 0; n < kN; ++n) dst[(size_t)n * GD] = h[n];
      next += chunk;
    }
    const float* xr = xd_s + i * W;
    const float delta = step_delta<R>(xr, wdt_r, bias);
    const float uv = u_s[(reverse ? ns - 1 - i : i) * Dh + d];
    const float acc = step<true>(h, a2, delta, delta * uv, xr + kB, xr + kC);
    y[((size_t)b * L + position(t0 + i, L, reverse)) * GD + c] = fmaf(dd, uv, acc);
  }
}

template <int R>
cudaError_t run(Streams streams, const float* wx, const float* wdt, const float* dtb,
                const float* A, const float* Ds, float* y, float* carries, int* flags,
                float* agg, float* agg_dsum, float* gagg, float* gdsum, float* gincl,
                int batch, int L, int G, int Dh, int chunk, bool reverse,
                cudaStream_t stream) {
  const int dirs = block_dirs(G, Dh);
  const int ncb = (G + dirs - 1) / dirs;
  const int ntiles = (L + kTile - 1) / kTile;
  const int ngroups = (ntiles + kGroup - 1) / kGroup;
  const size_t blocks = (size_t)batch * ntiles * ncb;
  const size_t nflags = blocks + (size_t)batch * ngroups * ncb;
  if (blocks >= (size_t)INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * dirs * dir_floats(Dh, R);
  cudaError_t err = allow_smem(cross_fwd_tile_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(flags, 0, (nflags + 1) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  cross_fwd_tile_kernel<R><<<(unsigned)blocks, dirs * Dh, smem, stream>>>(
      streams, wx, wdt, dtb, A, Ds, y, carries, flags,
      reinterpret_cast<unsigned*>(flags + nflags), agg, agg_dsum, gagg, gdsum, gincl,
      batch, L, G, Dh, dirs, ntiles, ncb, chunk, reverse ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// Steps of a tile and tiles of a group: the caller sizes the look-back
// scratch by them.
extern "C" int nnuzoo_cross_scan_fwd_tile() { return kTile; }
extern "C" int nnuzoo_cross_scan_fwd_group() { return kGroup; }

// One memset and one launch on `stream`. s2 is null when G == 2. Scratch
// that the caller allocates, with tiles = ceil(L / kTile), groups =
// ceil(tiles / kGroup), dirs = min(G, 256 / Dh) directions a block and cb =
// ceil(G / dirs) column blocks: `flags`, B * (tiles + groups) * cb + 1 ints
// (the last is the ticket); `agg` (B, tiles, N, G*Dh) and `agg_dsum` (B,
// tiles, G*Dh), `gagg` and `gincl` (B, groups, N, G*Dh) and `gdsum` (B,
// groups, G*Dh) floats. `carries` (B, ceil(L / chunk), N, G*Dh) may be null
// (then `chunk` is not read): the state entering each traversal chunk. The
// streams and wx start on 16 bytes. Returns the first error, or
// cudaSuccess.
extern "C" int nnuzoo_cross_scan_fwd(const float* s0, const float* s1,
                                     const float* s2, const float* wx,
                                     const float* wdt, const float* dtb,
                                     const float* A, const float* Ds, float* y,
                                     float* carries, int* flags, float* agg,
                                     float* agg_dsum, float* gagg, float* gdsum,
                                     float* gincl, int batch, int L, int G, int Dh,
                                     int R, int N, int chunk, int reverse,
                                     void* stream_handle) {
  if (N != kN || G < 1 || G > kMaxG || Dh % 32 != 0 || Dh > kBlock || L < 1 ||
      batch < 1 || (carries != nullptr && chunk < 1))
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const Streams streams{{s0, s1, s2}};
#define CROSS_SCAN_FWD(RV)                                                       \
  return run<RV>(streams, wx, wdt, dtb, A, Ds, y, carries, flags, agg, agg_dsum, \
                 gagg, gdsum, gincl, batch, L, G, Dh, chunk, reverse != 0, stream)
  CROSS_SCAN_DISPATCH_R(R, CROSS_SCAN_FWD)
#undef CROSS_SCAN_FWD
  return cudaErrorInvalidValue;
}
