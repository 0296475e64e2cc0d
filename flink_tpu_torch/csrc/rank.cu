// Exchange rank: the rank of each record within its destination shard, as a
// one-pass stable counting sort for Hopper (sm_90a).
//
// Replaces: flink_tpu/stateplane/rank.py, pallas_rank -> _rank_kernel (the
// TPU kernel: one sequential fori_loop over the lanes with the per-destination
// counts in SMEM), and the elementwise epilogue of exchange_rank_flat.
//
// Computes, for every row r of an int32 [R, C] destination matrix d (rows are
// independent, one per source shard) and D destinations:
//     rank[r, i] = #{ j < i : 0 <= d[r, j] < D  and  d[r, j] == clip(d[r, i]) }
// with clip(x) = min(max(x, 0), D - 1). Out-of-range lanes READ the prior
// in-range count of their clipped bucket and never add to it — bit for bit
// what the reference's one-hot-cumsum (xla_rank) and its Pallas kernel give.
// With `flat` set it writes exchange_rank_flat's contract instead, as int64:
//     flat[r, i] = d*W + rank   if d < D and rank < W,   else D*W.
//
// Bound: it reads 4 B per lane and writes 4 B (rank) or 8 B (flat) per lane,
// with a handful of integer operations per lane, so it is memory-bound: at
// Q5's shapes (R = 8, C = 131072, D = 8, flat) 12 MiB, 3.76 us at 3.35 TB/s.
//
// Design: ONE launch, tiles of 4096 lanes (512 threads), d read once into
// registers.
//   1. Each warp owns 256 contiguous lanes of its tile, in eight coalesced
//      rounds of 32. Per round it groups lanes by clipped destination with
//      __match_any_sync; a lane's in-warp rank is the warp's running count
//      of its bucket (shared memory) plus __popc(group & in_range &
//      lanemask_lt); the group leader then adds __popc(group & in_range).
//   2. The warp counts become exclusive warp offsets and the tile's
//      per-destination aggregate.
//   3. Decoupled look-back across the tiles of a row (one scan per (row,
//      destination)): a tile publishes its aggregate, then — once it knows
//      its exclusive prefix — its inclusive prefix, each as one 64-bit
//      status word {epoch:32, flag:2, value:30}. A warp looks back 32
//      predecessors at a time and stops at the nearest inclusive prefix.
//      Tiles wait only on lower tiles of their row, which the hardware has
//      dispatched first (blocks are dispatched in increasing linear index).
//      At Q5's 131072 lanes a row has 32 tiles, so one look-back step reaches
//      tile 0's prefix: no tile waits on a chain of prefixes.
//   4. rank = tile prefix + warp offset + in-warp rank, written once.
// The status words live in a buffer the wrapper keeps per device and stream;
// each call carries a new epoch, so words of earlier calls read as "not
// ready" and nothing is cleared or allocated per call. Stream order within a
// destination is kept because every term is a prefix count in lane order.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// 512 x 8: a 131072-lane row is 32 tiles (see the look-back note)
constexpr int kThreads = 512;              // 16 warps per tile
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                  // rounds of 32 lanes per warp
constexpr int kWarpSpan = 32 * kItems;     // contiguous lanes per warp
constexpr int kTile = kThreads * kItems;   // lanes per tile
constexpr int kMaxDests = 1024;            // (kWarps + 2) * D int32 <= 72 KiB
constexpr size_t kDefaultSmem = 48 * 1024; // above it the launch must opt in
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kFlagAggregate = 1u;
constexpr unsigned kFlagPrefix = 2u;
constexpr unsigned kValueBits = 30;
constexpr unsigned long long kValueMask = (1ull << kValueBits) - 1;

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

template <bool kFlat>
__global__ void __launch_bounds__(kThreads)
    rank_onepass(const int32_t* __restrict__ d, void* __restrict__ out,
                 unsigned long long* __restrict__ status, int64_t C, int D,
                 int ntiles, int64_t W, unsigned epoch) {
  extern __shared__ int sh[];
  int* wcnt = sh;                  // [kWarps][D] counts, then warp offsets
  int* excl = sh + kWarps * D;     // [D] the tile's exclusive prefix
  int* agg = excl + D;             // [D] the tile's aggregate
  const int r = blockIdx.y, t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = lanemask_lt();
  for (int i = threadIdx.x; i < kWarps * D; i += kThreads) wcnt[i] = 0;

  const int32_t* row = d + (int64_t)r * C;
  const int64_t base = (int64_t)t * kTile + (int64_t)warp * kWarpSpan + lane;
  int v[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k * 32;
    v[k] = (i < C) ? row[i] : -1;
  }
  __syncthreads();

  // 1. in-warp ranks
  int local[kItems];
  int* mine = wcnt + warp * D;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool valid = base + k * 32 < C;
    const bool in = valid && v[k] >= 0 && v[k] < D;
    const int key = valid ? min(max(v[k], 0), D - 1) : -1;
    const unsigned inr = __ballot_sync(kFull, in);
    const unsigned peers = __match_any_sync(kFull, key);
    const unsigned group = peers & inr;
    local[k] = valid ? mine[key] + __popc(group & lt) : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) mine[key] += __popc(group);
    __syncwarp();
  }
  __syncthreads();

  // 2. exclusive warp offsets and the tile aggregate; publish it
  unsigned long long* st = status + ((int64_t)r * ntiles + t) * D;
  for (int j = threadIdx.x; j < D; j += kThreads) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcnt[w * D + j];
      wcnt[w * D + j] = s;
      s += c;
    }
    agg[j] = s;
    if (t == 0) {
      excl[j] = 0;
      publish(st + j, pack(epoch, kFlagPrefix, s));
    } else {
      publish(st + j, pack(epoch, kFlagAggregate, s));
    }
  }
  __syncthreads();

  // 3. decoupled look-back, one warp per destination
  if (t > 0) {
    const unsigned long long* row_st = status + (int64_t)r * ntiles * D;
    for (int j = warp; j < D; j += kWarps) {
      int sum = 0;
      for (int pred = t - 1;; pred -= 32) {
        const int tt = pred - lane;
        unsigned flag = kFlagPrefix;
        int val = 0;
        if (tt >= 0) {
          const volatile unsigned long long* p =
              row_st + (int64_t)tt * D + j;
          unsigned long long w;
          do {
            w = *p;
            flag = (unsigned)(w >> kValueBits) & 3u;
          } while ((unsigned)(w >> 32) != epoch || flag == 0u);
          val = (int)(w & kValueMask);
        }
        const unsigned pre = __ballot_sync(kFull, flag == kFlagPrefix);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        int x = lane <= stop ? val : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
        sum += x;
        if (pre) break;
      }
      if (lane == 0) {
        excl[j] = sum;
        publish(st + j, pack(epoch, kFlagPrefix, sum + agg[j]));
      }
    }
  }
  __syncthreads();

  // 4. rank = tile prefix + warp offset + in-warp rank
  const int* woff = wcnt + warp * D;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k * 32;
    if (i >= C) continue;
    const int key = min(max(v[k], 0), D - 1);
    const int rk = excl[key] + woff[key] + local[k];
    const int64_t o = (int64_t)r * C + i;
    if (kFlat) {
      // the reference's test: a negative lane whose rank fits keeps
      // d*W + rank (it is never staged by the exchange)
      const bool ok = v[k] < D && rk < W;
      static_cast<int64_t*>(out)[o] =
          ok ? (int64_t)v[k] * W + rk : (int64_t)D * W;
    } else {
      static_cast<int32_t*>(out)[o] = rk;
    }
  }
}

inline int64_t tiles_of(int64_t C) { return (C + kTile - 1) / kTile; }

}  // namespace

extern "C" {

int rank_max_dests() { return kMaxDests; }

// Largest C the 30-bit status values hold.
int64_t rank_max_lanes() { return (int64_t)kValueMask; }

// 64-bit status words the caller keeps for a [R, C] call with D dests.
int64_t rank_status_elems(int64_t R, int64_t C, int32_t D) {
  return R * tiles_of(C) * (int64_t)D;
}

// One launch on `stream` of CUDA device `device`. `status` holds
// rank_status_elems words, zeroed once when allocated; `epoch` (>= 1) must
// differ from every earlier call's on that buffer. flat = 0 writes int32
// ranks, flat = 1 writes int64 flat offsets with bucket width W. Returns 0
// or the cudaError_t of the launch.
int rank_launch(const int32_t* d, void* out, unsigned long long* status,
                int64_t R, int64_t C, int32_t D, int64_t W, uint32_t epoch,
                int32_t flat, int32_t device, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const int64_t ntiles = tiles_of(C);
  if (D < 1 || D > kMaxDests || R > 65535 || C > (int64_t)kValueMask ||
      epoch == 0 || (flat && W < 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)ntiles, (unsigned)R);
  const size_t smem = (size_t)(kWarps + 2) * D * sizeof(int);
  if (smem > kDefaultSmem) {
    constexpr cudaFuncAttribute kMaxSmem =
        cudaFuncAttributeMaxDynamicSharedMemorySize;
    err = flat ? cudaFuncSetAttribute(rank_onepass<true>, kMaxSmem, (int)smem)
               : cudaFuncSetAttribute(rank_onepass<false>, kMaxSmem,
                                      (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (flat)
    rank_onepass<true><<<grid, kThreads, smem, s>>>(d, out, status, C, D,
                                                    (int)ntiles, W, epoch);
  else
    rank_onepass<false><<<grid, kThreads, smem, s>>>(d, out, status, C, D,
                                                     (int)ntiles, W, epoch);
  return (int)cudaGetLastError();
}

}  // extern "C"
