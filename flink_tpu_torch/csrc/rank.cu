// Exchange rank: the rank of each record within its destination shard, as a
// stable parallel counting sort for Hopper (sm_90a).
//
// Replaces: flink_tpu/stateplane/rank.py, pallas_rank -> _rank_kernel (the
// TPU kernel: one sequential fori_loop over the lanes with the per-destination
// counts in SMEM).
//
// Computes, for every row r of an int32 [R, C] destination matrix d (rows are
// independent, one per source shard) and D destinations:
//     rank[r, i] = #{ j < i : 0 <= d[r, j] < D  and  d[r, j] == clip(d[r, i]) }
// with clip(x) = min(max(x, 0), D - 1). Out-of-range lanes READ the prior
// in-range count of their clipped bucket and never add to it — bit for bit
// what the reference's one-hot-cumsum (xla_rank) and its Pallas kernel give.
//
// Bound: it reads 4 B and writes 4 B per lane and does a handful of integer
// operations per lane, so it is memory-bound: at Q5's shapes (R = 8 shards,
// C = 131072, D = 8) that is 8 MiB, 2.5 us at 3.35 TB/s — below the cost of
// its launches, so at these shapes it is launch-bound too.
//
// Design: three launches, each embarrassingly parallel over tiles of 1024
// lanes, instead of the TPU's one serial pass.
//   1. rank_hist: per tile, a per-destination histogram of the in-range
//      lanes. Each warp groups its lanes by destination with
//      __match_any_sync and the group leader adds __popc(group) to a shared
//      histogram (one atomic per group, any D).
//   2. rank_scan: one warp per (row, destination) turns the tile histograms
//      into exclusive per-tile offsets (a warp-shuffle scan over tiles).
//   3. rank_tile: each tile walks its lanes in four coalesced sub-rounds of
//      256; a lane's rank = tile offset + counts of the tile's earlier
//      sub-rounds + counts of earlier warps in this sub-round + its in-warp
//      prefix __popc(group & in_range & lanemask_lt).
// The lanes are read twice (passes 1 and 3) and written once; the histogram
// scratch is R * tiles * D int32. Stream order within a destination is kept
// because every offset is a prefix count in lane order. Making it one pass
// (decoupled look-back) and removing the launch overhead is later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;             // 8 warps per tile
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                 // coalesced sub-rounds per tile
constexpr int kTile = kThreads * kItems;  // lanes per tile
constexpr int kMaxDests = 1024;           // (1 + kWarps) * D int32 <= 36 KiB
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__global__ void rank_hist(const int32_t* __restrict__ d,
                          int32_t* __restrict__ hist, int64_t C, int D,
                          int ntiles) {
  extern __shared__ int sh[];  // [D]
  const int r = blockIdx.y, t = blockIdx.x, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < D; i += kThreads) sh[i] = 0;
  __syncthreads();
  const int32_t* row = d + (int64_t)r * C;
  const int64_t base = (int64_t)t * kTile;
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + (int64_t)k * kThreads + threadIdx.x;
    const int v = (i < C) ? row[i] : -1;
    const int key = (v >= 0 && v < D) ? v : -1;  // -1: counts nowhere
    const unsigned peers = __match_any_sync(kFull, key);
    if (key >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&sh[key], __popc(peers));
  }
  __syncthreads();
  int32_t* out = hist + ((int64_t)r * ntiles + t) * D;
  for (int i = threadIdx.x; i < D; i += kThreads) out[i] = sh[i];
}

__global__ void rank_scan(int32_t* __restrict__ hist, int ntiles, int D) {
  const int dest = blockIdx.x, r = blockIdx.y, lane = threadIdx.x;
  int32_t* col = hist + (int64_t)r * ntiles * D + dest;
  int carry = 0;
  for (int t0 = 0; t0 < ntiles; t0 += 32) {
    const int t = t0 + lane;
    const int v = (t < ntiles) ? col[(int64_t)t * D] : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (t < ntiles) col[(int64_t)t * D] = carry + x - v;  // exclusive
    carry += __shfl_sync(kFull, x, 31);
  }
}

__global__ void rank_tile(const int32_t* __restrict__ d,
                          const int32_t* __restrict__ offs,
                          int32_t* __restrict__ out, int64_t C, int D,
                          int ntiles) {
  extern __shared__ int sh[];
  int* running = sh;      // [D]   counts before the current sub-round
  int* wcnt = sh + D;     // [kWarps][D] this sub-round's per-warp counts
  const int r = blockIdx.y, t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int32_t* o = offs + ((int64_t)r * ntiles + t) * D;
  for (int i = threadIdx.x; i < D; i += kThreads) running[i] = o[i];
  const int32_t* row = d + (int64_t)r * C;
  int32_t* orow = out + (int64_t)r * C;
  const int64_t base = (int64_t)t * kTile;
  const unsigned lt = lanemask_lt();
  int* mine_cnt = wcnt + warp * D;
  for (int k = 0; k < kItems; ++k) {
    for (int i = lane; i < D; i += 32) mine_cnt[i] = 0;
    __syncwarp();
    const int64_t i = base + (int64_t)k * kThreads + threadIdx.x;
    const bool valid = i < C;
    const int v = valid ? row[i] : -1;
    const bool in = valid && v >= 0 && v < D;
    const int key = valid ? min(max(v, 0), D - 1) : -1;
    const unsigned inr = __ballot_sync(kFull, in);
    const unsigned peers = __match_any_sync(kFull, key);
    const unsigned group = peers & inr;  // in-range lanes of my bucket
    if (valid && lane == __ffs(peers) - 1) mine_cnt[key] = __popc(group);
    __syncthreads();
    if (valid) {
      int rk = running[key] + __popc(group & lt);
      for (int w = 0; w < warp; ++w) rk += wcnt[w * D + key];
      orow[i] = rk;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < D; j += kThreads) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) s += wcnt[w * D + j];
      running[j] += s;
    }
    __syncthreads();
  }
}

inline int64_t tiles_of(int64_t C) { return (C + kTile - 1) / kTile; }

}  // namespace

extern "C" {

int rank_max_dests() { return kMaxDests; }

// int32 elements of the histogram scratch the wrapper allocates.
int64_t rank_scratch_elems(int64_t R, int64_t C, int32_t D) {
  return R * tiles_of(C) * (int64_t)D;
}

// Launches the three passes on `stream` of CUDA device `device`. Returns 0 or
// the cudaError_t of the first launch that failed (checked after each).
int rank_launch(const int32_t* d, int32_t* out, int32_t* scratch, int64_t R,
                int64_t C, int32_t D, int32_t device, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const int64_t ntiles = tiles_of(C);
  if (D < 1 || D > kMaxDests || R > 65535 || ntiles > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)ntiles, (unsigned)R);
  rank_hist<<<grid, kThreads, D * sizeof(int), s>>>(d, scratch, C, D,
                                                   (int)ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rank_scan<<<dim3((unsigned)D, (unsigned)R), 32, 0, s>>>(scratch,
                                                          (int)ntiles, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rank_tile<<<grid, kThreads, (1 + kWarps) * D * sizeof(int), s>>>(
      d, scratch, out, C, D, (int)ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}

}  // extern "C"
