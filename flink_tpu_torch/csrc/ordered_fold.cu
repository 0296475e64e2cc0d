// Ordered fold: a scatter-reduce into [P, cap] accumulator planes that folds
// each slot's lanes in lane (stream) order, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The reference's float folds are XLA scatters
// (`a.at[0, recv_s].add/max/min` per shard in flink_tpu/parallel/shuffle.py
// and parallel/sharded_windower.py), which on the CPU apply the updates in
// index order; torch's CUDA index_add_ folds with atomics in no fixed order,
// so float sums differ in the last bits. This kernel keeps the order, per
// plane p and slot s:
//     acc[p, s] = op(... op(op(acc[p, s], v[p, i1]), v[p, i2]) ..., v[p, ik])
// over the lanes i1 < i2 < ... < ik of plane p whose slot is s.
//
// op: 0 sum; 1 max and 2 min with XLA's x86 semantics — -0.0 < +0.0, and a
// NaN propagates with its bits: of a slot's sequence (its starting value,
// then its lanes in order) max keeps the first negative NaN, else the last
// NaN; min the first positive NaN, else the last NaN. That selection is
// associative, so the fold applies it as it goes (`combine`), at no extra
// pass. A sum that comes out NaN gets
// the CPU's NaN bits, which the card's FADD (canonical NaN) does not give:
// the run's LAST NaN lane, quieted; else the starting accumulator, quieted,
// if it was NaN; else the x86 default NaN 0xffc00000 (float64
// 0xfff8000000000000) of an inf - inf. The rule is applied after the fold
// from the run's values, off the dependent add chain.
//
// Lanes whose slot is 0 (each plane's reserved identity slot, where the
// exchange's padding lanes land with the identity) or outside [0, cap) are
// dropped at the first read and never grouped.
//
// What bounds it: the bytes — each lane's slot read once (4 B), each kept
// lane's value read once, each touched accumulator read and written once —
// except on a hot slot, whose lanes are one chain of dependent adds (IEEE
// adds do not reassociate), about 4 cycles a lane.
//
// Design, 3 + ceil(bits / 8) launches per call, bits = ceil(log2 cap):
//   0. cudaMemsetAsync of a small meta block (histograms, counters).
//   1. histogram: per plane, the counts of every 8-bit digit of the kept
//      slots for every pass, by shared-memory atomics.
//   2. sort_pass (one per digit, least significant first): a stable LSD
//      radix pass over int32 slots that carries the VALUE with its slot (no
//      permutation, no gather pass). A tile of 4096 lanes (512 threads x 8
//      rounds of 32) ranks its lanes per digit in-warp (a lane's peers are
//      the AND of eight ballots, one per digit bit), carries the per-digit
//      counts across the plane's tiles by decoupled
//      look-back (64-bit status words {epoch, flag, value}, the machinery
//      of rank.cu, copied here with its epoch tag: the buffer is zeroed once,
//      never per call; one thread per digit, reading 8 predecessors at
//      once), and adds the plane's digit base from the histogram. The tile
//      is staged in digit order in shared memory and written out
//      coalesced: written straight from the ranks, each 4-byte write took
//      a 32-byte sector and the pass took 42 us at Q5's shapes. The first
//      pass drops the identity and out-of-range lanes; at Q5's shapes half
//      the lanes are padding, so later passes move half as much.
//   3. fold_runs: one warp per window of 32 sorted positions. The lane at
//      each run's head folds the run's lanes in the window, all heads at
//      once, reading the values from the other lanes' registers by
//      __shfl_sync (a warp walking its runs one after another waited a
//      load round trip per run). The window's last run may go on: the warp
//      walks it on, 32 lanes per coalesced step (the next step's loads
//      issued before this step's adds), or — when it reaches kLongRun
//      lanes, seen by one load at start + kLongRun - 1, the slots being
//      sorted — queues it.
//   4. fold_long: one block per queued run. The run's end comes from a
//      block-wide search of the sorted slots (about three rounds of 128
//      probes), not from a walk; its values stream through a 4-stage ring
//      of 8 KiB stages in shared memory by cp.async, and one thread folds
//      them with 16-byte shared-memory reads. The dependent add chain, not
//      load latency, then sets the pace.
// kLongRun = 1024 (32 steps of a warp's walk): a shorter run is not worth
// a queued run's search and pipeline fill.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr int kMaxPasses = 4;                  // slots < 2^31

constexpr int kThreads = 512;                  // sort_pass: 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                      // rounds of 32 lanes per warp
constexpr int kWarpSpan = 32 * kItems;
constexpr int kTile = kThreads * kItems;       // 4096 lanes per tile
constexpr int kLook = 8;                       // predecessors read at once
constexpr size_t kDefaultSmem = 48 * 1024;     // above it a launch opts in

constexpr int kHistThreads = 256;
constexpr int kHistItems = 16;
constexpr int kHistTile = kHistThreads * kHistItems;

constexpr int kFoldThreads = 256;
constexpr int kLongRun = 1024;
constexpr int kLongThreads = 128;
constexpr int kLongBlocks = 264;               // two per SM of an H100
constexpr int kStageBytes = 8192;
constexpr int kStages = 4;
constexpr int kStageVecs = kStageBytes / 16;

constexpr unsigned kFlagAggregate = 1u;
constexpr unsigned kFlagPrefix = 2u;
constexpr unsigned kValueBits = 30;
constexpr unsigned long long kValueMask = (1ull << kValueBits) - 1;

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ unsigned long long pack(unsigned epoch,
                                                   unsigned flag, int value) {
  return ((unsigned long long)epoch << 32) |
         ((unsigned long long)flag << kValueBits) | (unsigned)value;
}

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(word) = v;
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* word) {
  return *reinterpret_cast<const volatile unsigned long long*>(word);
}

__device__ __forceinline__ bool ready(unsigned long long w, unsigned epoch) {
  return (unsigned)(w >> 32) == epoch && ((w >> kValueBits) & 3u) != 0u;
}

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ bool slot_kept(int s, int64_t cap) {
  return s > 0 && s < cap;
}

__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ long long order_key(double x) {
  const long long b = __double_as_longlong(x);
  return b ^ ((b >> 63) & 0x7fffffffffffffffll);
}
__device__ __forceinline__ float quieted(float x) {
  return __int_as_float(__float_as_int(x) | 0x00400000);
}
__device__ __forceinline__ double quieted(double x) {
  return __longlong_as_double(__double_as_longlong(x) | 0x0008000000000000ll);
}
__device__ __forceinline__ float default_nan(float) {
  return __int_as_float((int)0xffc00000u);
}
__device__ __forceinline__ double default_nan(double) {
  return __longlong_as_double((long long)0xfff8000000000000ull);
}

// Max/min keep x86's NaN (see the header): a NaN accumulator whose sign
// ranks first (negative for max, positive for min) stays; else a NaN lane
// replaces the accumulator; else a NaN accumulator stays.
template <int kOp, typename T>
__device__ __forceinline__ T combine(T a, T x) {
  if (kOp == 0) return a + x;
  if (a != a || x != x) {
    const bool first = a != a && (order_key(a) < 0) == (kOp == 1);
    return !first && x != x ? x : a;
  }
  const bool take = kOp == 1 ? order_key(x) > order_key(a)
                             : order_key(x) < order_key(a);
  return take ? x : a;
}

// The CPU's NaN for a sum that came out NaN (see the header).
template <typename T>
__device__ __forceinline__ T sum_nan(T start, bool has_nan_lane, T last) {
  if (has_nan_lane) return quieted(last);
  if (start != start) return quieted(start);
  return default_nan(start);
}

// Exclusive scan of x over threads 0..kBins-1; every thread of the block
// calls it (it synchronises). *total gets the sum of the kBins values.
__device__ __forceinline__ int scan_bins(int x, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31 && warp < kBins / 32) wsum[warp] = inc;
  __syncthreads();
  int off = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kBins / 32; ++w) {
    off += w < warp ? wsum[w] : 0;
    all += wsum[w];
  }
  *total = all;
  return off + inc - x;
}

// The kept lanes of the warp whose digit is this lane's (for a kept lane):
// one ballot per digit bit, cheaper than __match_any_sync over 256 values.
__device__ __forceinline__ unsigned match_digit(int dig, bool kept) {
  unsigned m = __ballot_sync(kFull, kept);
#pragma unroll
  for (int b = 0; b < kDigitBits; ++b) {
    const bool bit = (dig >> b) & 1;
    const unsigned set = __ballot_sync(kFull, bit);
    m &= bit ? set : ~set;
  }
  return m;
}

// Decoupled look-back from tile t's own status word: the sum of the
// values of its predecessors down to the nearest inclusive prefix.
__device__ __forceinline__ int look_back(const unsigned long long* own, int t,
                                         unsigned epoch) {
  int sum = 0;
  for (int pred = t - 1; pred >= 0; pred -= kLook) {
    unsigned long long w[kLook];
#pragma unroll
    for (int j = 0; j < kLook; ++j)
      w[j] = pred - j >= 0 ? peek(own - (int64_t)(t - pred + j) * kBins) : 0;
#pragma unroll
    for (int j = 0; j < kLook; ++j) {
      if (pred - j < 0) return sum;  // not reached: tile 0 is a prefix
      while (!ready(w[j], epoch))
        w[j] = peek(own - (int64_t)(t - pred + j) * kBins);
      sum += (int)(w[j] & kValueMask);
      if (((w[j] >> kValueBits) & 3u) == kFlagPrefix) return sum;
    }
  }
  return sum;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------------- 1. histogram

__global__ void __launch_bounds__(kHistThreads)
    histogram(const int32_t* __restrict__ slots, int64_t L, int64_t cap,
              int npass, int* __restrict__ meta) {
  __shared__ int h[kMaxPasses * kBins];
  const int p = blockIdx.y;
  for (int i = threadIdx.x; i < npass * kBins; i += kHistThreads) h[i] = 0;
  __syncthreads();
  const int32_t* row = slots + (int64_t)p * L;
  const int64_t base = (int64_t)blockIdx.x * kHistTile + threadIdx.x;
  int s[kHistItems];  // every load issued before the first atomic
#pragma unroll
  for (int k = 0; k < kHistItems; ++k) {
    const int64_t i = base + (int64_t)k * kHistThreads;
    s[k] = i < L ? row[i] : -1;
  }
#pragma unroll
  for (int k = 0; k < kHistItems; ++k) {
    if (!slot_kept(s[k], cap)) continue;
    for (int q = 0; q < npass; ++q)
      atomicAdd(
          &h[q * kBins + (int)((s[k] >> (q * kDigitBits)) & (kBins - 1))], 1);
  }
  __syncthreads();
  int* hist = meta + (int64_t)p * npass * kBins;
  for (int i = threadIdx.x; i < npass * kBins; i += kHistThreads)
    if (h[i]) atomicAdd(&hist[i], h[i]);
}

// ------------------------------------------------------------ 2. sort_pass

// One stable LSD pass over digit `pass` of plane blockIdx.y, tile
// blockIdx.x. The first pass reads the caller's slots and values and keeps
// only the kept lanes; later passes read the previous pass's output, of
// nvalid[p] lanes.
template <typename T, bool kFirst>
__global__ void __launch_bounds__(kThreads)
    sort_pass(const int32_t* __restrict__ kin, const T* __restrict__ vin,
              int64_t ld_in, int64_t L, int32_t* __restrict__ kout,
              T* __restrict__ vout, int64_t ld_out, int* __restrict__ meta,
              int npass, int pass, int64_t cap,
              unsigned long long* __restrict__ status, int ntiles,
              unsigned epoch) {
  extern __shared__ __align__(16) unsigned char smem[];
  // warp counts, then warp offsets, then the tile's staged slots
  int* wcnt = reinterpret_cast<int*>(smem);
  T* vstage = reinterpret_cast<T*>(smem + kTile * sizeof(int));
  int* delta = reinterpret_cast<int*>(smem + kTile * (sizeof(int) + sizeof(T)));
  int* tstart = delta + kBins;  // the tile's first position of each digit
  int* wsum = tstart + kBins;
  const int p = blockIdx.y, t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* nvalid = meta + (int64_t)gridDim.y * npass * kBins;
  const int64_t n = kFirst ? L : (int64_t)nvalid[p];
  if (!kFirst && (int64_t)t * kTile >= n) return;  // no later tile waits
  const int shift = pass * kDigitBits;
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) wcnt[i] = 0;

  const int* hist = meta + ((int64_t)p * npass + pass) * kBins;
  int total;
  const int hbase =
      scan_bins(threadIdx.x < kBins ? hist[threadIdx.x] : 0, wsum, &total);
  if (kFirst && t == 0 && threadIdx.x == 0) nvalid[p] = total;

  const int32_t* krow = kin + (int64_t)p * ld_in;
  const T* vrow = vin + (int64_t)p * ld_in;
  const int64_t base = (int64_t)t * kTile + warp * kWarpSpan + lane;
  int key[kItems];
  T val[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k * 32;
    const int s = i < n ? krow[i] : -1;
    const bool kept = kFirst ? slot_kept(s, cap) : i < n;
    key[k] = kept ? s : -1;
    val[k] = kept ? vrow[i] : T(0);
  }

  // in-warp ranks: kept lanes of one digit are one group
  const unsigned lt = lanemask_lt();
  int local[kItems];
  int* mine = wcnt + warp * kBins;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool kept = key[k] >= 0;
    const int dig = kept ? (key[k] >> shift) & (kBins - 1) : 0;
    const unsigned peers = match_digit(dig, kept);
    local[k] = kept ? mine[dig] + __popc(peers & lt) : 0;
    __syncwarp();
    if (kept && lane == __ffs(peers) - 1) mine[dig] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // warp offsets, the tile aggregate, and the look-back: one thread a digit
  int agg = 0, excl = 0;
  if (threadIdx.x < kBins) {
    const int d = threadIdx.x;
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcnt[w * kBins + d];
      wcnt[w * kBins + d] = agg;
      agg += c;
    }
    unsigned long long* st = status + ((int64_t)p * ntiles + t) * kBins + d;
    if (t == 0) {
      publish(st, pack(epoch, kFlagPrefix, agg));
    } else {
      publish(st, pack(epoch, kFlagAggregate, agg));
      excl = look_back(st, t, epoch);
      publish(st, pack(epoch, kFlagPrefix, excl + agg));
    }
  }
  // stage the tile in digit order, so that the write-out is coalesced
  // (scattered 4-byte writes cost a 32-byte sector each)
  int kept_in_tile;
  const int ts = scan_bins(agg, wsum, &kept_in_tile);
  if (threadIdx.x < kBins) {
    tstart[threadIdx.x] = ts;
    delta[threadIdx.x] = hbase + excl - ts;
  }
  __syncthreads();
  int pos[kItems];
  const int* woff = wcnt + warp * kBins;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int dig = (key[k] >> shift) & (kBins - 1);
    pos[k] = key[k] < 0 ? -1 : tstart[dig] + woff[dig] + local[k];
  }
  __syncthreads();
  int* kstage = wcnt;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (pos[k] < 0) continue;
    kstage[pos[k]] = key[k];
    vstage[pos[k]] = val[k];
  }
  __syncthreads();

  int32_t* ko = kout + (int64_t)p * ld_out;
  T* vo = vout + (int64_t)p * ld_out;
  for (int j = threadIdx.x; j < kept_in_tile; j += kThreads) {
    const int key_j = kstage[j];
    const int64_t o = (int64_t)delta[(key_j >> shift) & (kBins - 1)] + j;
    ko[o] = key_j;
    vo[o] = vstage[j];
  }
}

template <typename T>
constexpr size_t sort_smem() {
  return kTile * (sizeof(int) + sizeof(T)) + (2 * kBins + kBins / 32) *
                                                 sizeof(int);
}
static_assert(kWarps * kBins == kTile, "the warp counts hold a tile");

// ------------------------------------------------------------ 3. fold_runs

template <typename T>
__device__ T warp_sum_nan(T start_val, const T* v, int64_t start,
                          int64_t end, int lane) {
  int64_t last = -1;
  for (int64_t b = start; b < end; b += 32) {
    const int64_t q = b + lane;
    const unsigned m = __ballot_sync(kFull, q < end && v[q] != v[q]);
    if (m) last = b + 31 - __clz(m);
  }
  return sum_nan(start_val, last >= 0, last >= 0 ? v[last] : T(0));
}

// One warp per 32 sorted positions (a window). Each run that starts in the
// window is folded by the lane at its head, in parallel with the others:
// the window's values are in the lanes' registers, and a head lane reads
// its run's through __shfl_sync. The last run of the window may go on past
// it: the warp then walks it on together, 32 lanes per coalesced step, or
// queues it for fold_long when it reaches kLongRun lanes.
template <int kOp, typename T>
__global__ void __launch_bounds__(kFoldThreads)
    fold_runs(const int32_t* __restrict__ keys, const T* __restrict__ vals,
              int64_t ld, T* __restrict__ acc, int64_t cap,
              int* __restrict__ meta, int npass, int4* __restrict__ longs) {
  const int p = blockIdx.y, lane = threadIdx.x & 31;
  const int* nvalid = meta + (int64_t)gridDim.y * npass * kBins;
  int* long_count = meta + (int64_t)gridDim.y * (npass * kBins + 1);
  const int64_t n = nvalid[p];
  const int64_t wbase =
      (int64_t)blockIdx.x * kFoldThreads + (threadIdx.x - lane);
  if (wbase >= n) return;  // warp-uniform
  const int32_t* k = keys + (int64_t)p * ld;
  const T* v = vals + (int64_t)p * ld;
  T* a_row = acc + (int64_t)p * cap;
  const int64_t i = wbase + lane;
  const bool valid = i < n;
  const int ti = valid ? k[i] : -1;
  const bool head = valid && (i == 0 || k[i - 1] != ti);
  const T x = valid ? v[i] : T(0);
  const unsigned heads = __ballot_sync(kFull, head);
  if (!heads) return;  // the window lies inside a run that began earlier

  // each head's run end in the window: the next head, else the window end
  const int in_win = (int)lmin(32, n - wbase);
  const unsigned above = lane == 31 ? 0u : heads & (kFull << (lane + 1));
  const int end_w = above ? __ffs(above) - 1 : in_win;
  const int hl = 31 - __clz(heads);
  const int t_last = __shfl_sync(kFull, ti, hl);
  const bool cross = wbase + 32 < n && k[wbase + 32] == t_last;
  const bool is_long = cross && wbase + hl + kLongRun <= n &&
                       k[wbase + hl + kLongRun - 1] == t_last;
  if (is_long && lane == hl)
    longs[atomicAdd(long_count, 1)] = make_int4(p, (int)(wbase + hl), ti, 0);

  const bool mine = head && !(is_long && lane == hl);
  const T a0 = mine ? a_row[ti] : T(0);
  T a = a0;
  const int len = mine ? end_w - lane : 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const T y = __shfl_sync(kFull, x, (lane + j) & 31);
    if (j < len) a = combine<kOp>(a, y);
  }
  const bool ends_here = mine && !(cross && lane == hl);
  if (kOp == 0) {  // a NaN sum takes the CPU's NaN (see the header)
    const unsigned nans = __ballot_sync(kFull, valid && x != x);
    const unsigned below_end = end_w >= 32 ? kFull : (1u << end_w) - 1;
    const unsigned seg = nans & below_end & (kFull << lane);
    const T last = __shfl_sync(kFull, x, seg ? 31 - __clz(seg) : lane);
    if (ends_here && a != a) a = sum_nan(a0, seg != 0, last);
  }
  if (ends_here) a_row[ti] = a;
  if (!cross || is_long) return;  // warp-uniform

  // the last run goes on past the window: walk it on with the whole warp
  const T c0 = __shfl_sync(kFull, a0, hl);
  T c = __shfl_sync(kFull, a, hl);
  int64_t q = wbase + 32 + lane;
  bool in = q < n && k[q] == t_last;
  T y = in ? v[q] : T(0);
  int64_t end = q;
  while (true) {
    const unsigned m = __ballot_sync(kFull, in);  // a prefix of the warp
    const int cnt = __popc(m);
    // issue the next step's loads before folding this one
    const int64_t qn = q + 32;
    const bool in_next = cnt == 32 && qn < n && k[qn] == t_last;
    const T y_next = in_next ? v[qn] : T(0);
    if (cnt == 32) {
#pragma unroll
      for (int l = 0; l < 32; ++l)
        c = combine<kOp>(c, __shfl_sync(kFull, y, l));
    } else {
      for (int l = 0; l < cnt; ++l)
        c = combine<kOp>(c, __shfl_sync(kFull, y, l));
      end = q - lane + cnt;
      break;
    }
    q = qn;
    in = in_next;
    y = y_next;
  }
  if (kOp == 0 && c != c) c = warp_sum_nan(c0, v, wbase + hl, end, lane);
  if (lane == 0) a_row[t_last] = c;
}

// ------------------------------------------------------------ 4. fold_long

template <int kOp>
__device__ __forceinline__ float fold_vec(float a, float4 q) {
  a = combine<kOp>(a, q.x);
  a = combine<kOp>(a, q.y);
  a = combine<kOp>(a, q.z);
  return combine<kOp>(a, q.w);
}
template <int kOp>
__device__ __forceinline__ double fold_vec(double a, double2 q) {
  a = combine<kOp>(a, q.x);
  return combine<kOp>(a, q.y);
}
template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };

// Fold x[0..n) (shared memory) into a in order: 16-byte reads, four per
// step, the next step's reads issued before this step's combines.
template <int kOp, typename T>
__device__ __forceinline__ T fold_span(T a, const T* x, int n) {
  using V = typename Vec<T>::type;
  constexpr int kPer = 16 / sizeof(T);
  const int mis = (int)(((uintptr_t)x / sizeof(T)) % kPer);
  const int head = min(n, (kPer - mis) % kPer);
  int i = 0;
  for (; i < head; ++i) a = combine<kOp>(a, x[i]);
  const V* xv = reinterpret_cast<const V*>(x + i);
  const int nv = (n - i) / kPer;
  const int groups = nv / 4;
  if (groups > 0) {
    V c0 = xv[0], c1 = xv[1], c2 = xv[2], c3 = xv[3];
    for (int g = 0; g < groups; ++g) {
      const int nx = min(g + 1, groups - 1) * 4;
      const V d0 = xv[nx], d1 = xv[nx + 1], d2 = xv[nx + 2], d3 = xv[nx + 3];
      a = fold_vec<kOp>(a, c0);
      a = fold_vec<kOp>(a, c1);
      a = fold_vec<kOp>(a, c2);
      a = fold_vec<kOp>(a, c3);
      c0 = d0; c1 = d1; c2 = d2; c3 = d3;
    }
  }
  for (int j = groups * 4; j < nv; ++j) a = fold_vec<kOp>(a, xv[j]);
  for (i += nv * kPer; i < n; ++i) a = combine<kOp>(a, x[i]);
  return a;
}

template <int kOp, typename T>
__global__ void __launch_bounds__(kLongThreads)
    fold_long(const int32_t* __restrict__ keys, const T* __restrict__ vals,
              int64_t ld, T* __restrict__ acc, int64_t cap,
              const int* __restrict__ meta, int npass, int P,
              const int4* __restrict__ longs) {
  __shared__ __align__(16) int4 ring[kStages * kStageVecs];
  __shared__ T s_acc;
  __shared__ long long s_last;
  constexpr int kPer = 16 / sizeof(T);
  const int* nvalid = meta + (int64_t)P * npass * kBins;
  const int count = meta[(int64_t)P * (npass * kBins + 1)];
  for (int e = blockIdx.x; e < count; e += gridDim.x) {
    const int4 r = longs[e];
    const int p = r.x, t = r.z;
    const int64_t start = r.y, n = nvalid[p];
    const int32_t* k = keys + (int64_t)p * ld;
    const T* v = vals + (int64_t)p * ld;
    // the run's end: the slots are sorted, so k[j] == t exactly on
    // [start, end); keep k[lo] == t and (hi == n or k[hi] != t)
    int64_t lo = start + kLongRun - 1, hi = n;
    while (hi - lo > 1) {
      const int64_t step = (hi - lo + kLongThreads - 1) / kLongThreads;
      const int64_t j = lo + (int64_t)(threadIdx.x + 1) * step;
      const int c = __syncthreads_count(j < hi && k[j] == t);
      lo += (int64_t)c * step;
      hi = lmin(hi, lo + step);
    }
    const int64_t end = hi;

    // stream [start, end) through the ring, 16-byte aligned
    const int64_t e_first = start & ~(int64_t)(kPer - 1);
    const int64_t nvec = (end - e_first + kPer - 1) / kPer;
    const int nchunks = (int)((nvec + kStageVecs - 1) / kStageVecs);
    const int4* src = reinterpret_cast<const int4*>(v + e_first);
    auto issue = [&](int c) {
      if (c < nchunks) {
        int4* dst = ring + (c % kStages) * kStageVecs;
        const int64_t v0 = (int64_t)c * kStageVecs;
        const int nv = (int)lmin(kStageVecs, nvec - v0);
        for (int j = threadIdx.x; j < nv; j += kLongThreads)
          cp_async16(dst + j, src + v0 + j);
      }
      cp_async_commit();
    };
    for (int c = 0; c < kStages - 1; ++c) issue(c);
    T a = T(0), a0 = T(0);
    if (threadIdx.x == 0) a = a0 = acc[(int64_t)p * cap + t];
    for (int c = 0; c < nchunks; ++c) {
      issue(c + kStages - 1);  // into the stage folded in round c - 1
      cp_async_wait<kStages - 1>();
      __syncthreads();
      if (threadIdx.x == 0) {
        const T* x =
            reinterpret_cast<const T*>(ring + (c % kStages) * kStageVecs);
        const int64_t e0 = e_first + (int64_t)c * kStageVecs * kPer;
        const int64_t lo_e = lmax(start, e0);
        const int64_t hi_e = lmin(end, e0 + (int64_t)kStageVecs * kPer);
        a = fold_span<kOp>(a, x + (lo_e - e0), (int)(hi_e - lo_e));
      }
      __syncthreads();
    }
    cp_async_wait<0>();

    if (kOp == 0) {
      if (threadIdx.x == 0) {
        s_acc = a;
        s_last = -1;
      }
      __syncthreads();
      if (s_acc != s_acc) {  // block-uniform: the run's last NaN lane
        long long last = -1;
        for (int64_t q = start + threadIdx.x; q < end; q += kLongThreads)
          if (v[q] != v[q]) last = q;
        if (last >= 0) atomicMax(&s_last, last);
        __syncthreads();
        if (threadIdx.x == 0)
          a = sum_nan(a0, s_last >= 0, s_last >= 0 ? v[s_last] : T(0));
      }
    }
    if (threadIdx.x == 0) acc[(int64_t)p * cap + t] = a;
    __syncthreads();  // s_acc, s_last and the ring are reused
  }
}

// ---------------------------------------------------------------- launcher

int passes_for(int64_t cap) {
  int bits = 0;
  while (bits < 63 && (1ll << bits) < cap) ++bits;
  bits = bits < 1 ? 1 : bits;
  return (bits + kDigitBits - 1) / kDigitBits;
}

struct Layout {
  int64_t ld;        // plane stride of the sorted buffers (elements)
  int64_t vals_a, vals_b, keys_a, keys_b, longs, meta;  // byte offsets
  int64_t long_cap, meta_bytes, total;
};

Layout layout_of(int64_t P, int64_t L, int64_t cap, int elem_bytes) {
  Layout l;
  l.ld = (L + 3) / 4 * 4;  // 16-byte aligned planes for cp.async
  const int64_t vb = P * l.ld * elem_bytes, kb = P * l.ld * 4;
  l.vals_a = 0;
  l.vals_b = vb;
  l.keys_a = 2 * vb;
  l.keys_b = l.keys_a + kb;
  l.longs = l.keys_b + kb;
  l.long_cap = P * (L / kLongRun) + 1;
  l.meta = l.longs + l.long_cap * (int64_t)sizeof(int4);
  l.meta_bytes = (P * passes_for(cap) * kBins + P + 1) * (int64_t)sizeof(int);
  l.total = l.meta + l.meta_bytes;
  return l;
}

inline int64_t tiles_of(int64_t L) { return (L + kTile - 1) / kTile; }

template <int kOp, typename T>
void launch_fold(const Layout& l, const int32_t* keys, const T* vals, T* acc,
                 int64_t P, int64_t L, int64_t cap, int* meta, int npass,
                 int4* longs, cudaStream_t s) {
  const dim3 grid((unsigned)((L + kFoldThreads - 1) / kFoldThreads),
                  (unsigned)P);
  fold_runs<kOp, T><<<grid, kFoldThreads, 0, s>>>(keys, vals, l.ld, acc, cap,
                                                  meta, npass, longs);
  const int blocks =
      (int)(l.long_cap < kLongBlocks ? l.long_cap : kLongBlocks);
  fold_long<kOp, T><<<blocks, kLongThreads, 0, s>>>(
      keys, vals, l.ld, acc, cap, meta, npass, (int)P, longs);
}

template <typename T>
int launch(const int32_t* slots, const void* v, void* acc, int64_t P,
           int64_t L, int64_t cap, char* scratch,
           unsigned long long* status, unsigned epoch, int op, bool fold,
           cudaStream_t s) {
  const Layout l = layout_of(P, L, cap, sizeof(T));
  const int npass = passes_for(cap);
  int* meta = reinterpret_cast<int*>(scratch + l.meta);
  T* vbuf[2] = {reinterpret_cast<T*>(scratch + l.vals_a),
                reinterpret_cast<T*>(scratch + l.vals_b)};
  int32_t* kbuf[2] = {reinterpret_cast<int32_t*>(scratch + l.keys_a),
                      reinterpret_cast<int32_t*>(scratch + l.keys_b)};
  int4* longs = reinterpret_cast<int4*>(scratch + l.longs);
  cudaError_t err = cudaMemsetAsync(meta, 0, l.meta_bytes, s);
  if (err != cudaSuccess) return (int)err;
  const T* v_in = static_cast<const T*>(v);
  histogram<<<dim3((unsigned)((L + kHistTile - 1) / kHistTile), (unsigned)P),
              kHistThreads, 0, s>>>(slots, L, cap, npass, meta);
  const int ntiles = (int)tiles_of(L);
  const dim3 grid((unsigned)ntiles, (unsigned)P);
  constexpr size_t smem = sort_smem<T>();
  if (smem > kDefaultSmem) {
    constexpr cudaFuncAttribute kMaxSmem =
        cudaFuncAttributeMaxDynamicSharedMemorySize;
    err = cudaFuncSetAttribute(sort_pass<T, true>, kMaxSmem, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(sort_pass<T, false>, kMaxSmem, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sort_pass<T, true><<<grid, kThreads, smem, s>>>(
      slots, v_in, L, L, kbuf[0], vbuf[0], l.ld, meta, npass, 0, cap, status,
      ntiles, epoch);
  for (int q = 1; q < npass; ++q)
    sort_pass<T, false><<<grid, kThreads, smem, s>>>(
        kbuf[(q - 1) & 1], vbuf[(q - 1) & 1], l.ld, L, kbuf[q & 1],
        vbuf[q & 1], l.ld, meta, npass, q, cap, status, ntiles, epoch + q);
  if (fold) {
    const int32_t* keys = kbuf[(npass - 1) & 1];
    const T* vals = vbuf[(npass - 1) & 1];
    T* a = static_cast<T*>(acc);
    switch (op) {
      case 0:
        launch_fold<0, T>(l, keys, vals, a, P, L, cap, meta, npass, longs, s);
        break;
      case 1:
        launch_fold<1, T>(l, keys, vals, a, P, L, cap, meta, npass, longs, s);
        break;
      default:
        launch_fold<2, T>(l, keys, vals, a, P, L, cap, meta, npass, longs, s);
        break;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Radix passes (launches of sort_pass) for slots in [0, cap).
int32_t ordered_fold_passes(int64_t cap) { return passes_for(cap); }

// Largest L (lanes per plane) the 30-bit status values hold.
int64_t ordered_fold_max_lanes() { return (int64_t)kValueMask; }

// Bytes of scratch a call needs, and where the grouped output lies in it:
// out[0] = plane stride (elements) of the sorted buffers, out[1] = byte
// offset of the sorted values, out[2] = of the sorted int32 slots, out[3] =
// of the per-plane kept-lane counts (int32 [P]).
int64_t ordered_fold_scratch_bytes(int64_t P, int64_t L, int64_t cap,
                                   int32_t elem_bytes, int64_t* out) {
  const Layout l = layout_of(P, L, cap, elem_bytes);
  const int last = (passes_for(cap) - 1) & 1;
  out[0] = l.ld;
  out[1] = last ? l.vals_b : l.vals_a;
  out[2] = last ? l.keys_b : l.keys_a;
  out[3] = l.meta + P * passes_for(cap) * kBins * (int64_t)sizeof(int);
  return l.total;
}

// 64-bit look-back status words the caller keeps for a call of P planes of
// L lanes.
int64_t ordered_fold_status_elems(int64_t P, int64_t L) {
  return P * tiles_of(L) * kBins;
}

// Group (and, with fold = 1, fold) on `stream` of CUDA device `device`.
// slots int32 [P, L] and values [P, L] (elem_bytes 4 = float32, 8 =
// float64) contiguous; acc [P, cap] contiguous. `scratch` holds
// ordered_fold_scratch_bytes; `status` holds ordered_fold_status_elems
// words, zeroed once when allocated; epochs epoch .. epoch + passes - 1
// must differ from every earlier call's on that buffer. op 0 sum, 1 max,
// 2 min. Returns 0 or a cudaError_t.
int ordered_fold_launch(const int32_t* slots, const void* v, void* acc,
                        int64_t P, int64_t L, int64_t cap, void* scratch,
                        unsigned long long* status, uint32_t epoch,
                        int32_t elem_bytes, int32_t op, int32_t fold,
                        int32_t device, void* stream) {
  if (P <= 0 || L <= 0) return 0;
  if (op < 0 || op > 2 || cap < 1 || cap > 0x7fffffffll || P > 65535 ||
      L > (int64_t)kValueMask || epoch == 0 ||
      (elem_bytes != 4 && elem_bytes != 8))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* sc = static_cast<char*>(scratch);
  const bool f = fold != 0;
  return elem_bytes == 4 ? launch<float>(slots, v, acc, P, L, cap, sc, status,
                                         epoch, op, f, s)
                         : launch<double>(slots, v, acc, P, L, cap, sc,
                                          status, epoch, op, f, s);
}

}  // extern "C"
