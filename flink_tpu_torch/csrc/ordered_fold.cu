// Ordered fold: a scatter-reduce that folds each target's lanes in lane
// (stream) order, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The reference's float folds are XLA scatters
// (`.at[slots].add/max/min` in flink_tpu/parallel/shuffle.py and
// parallel/sharded_windower.py), which on the CPU apply the updates in
// index order; torch's CUDA index_add_ folds with atomics in no fixed order,
// so float sums differ in the last bits. This kernel keeps the order:
//     acc[t] = op(... op(op(acc[t], v[i1]), v[i2]) ..., v[ik])
// over the lanes i1 < i2 < ... < ik whose target is t.
//
// op: 0 sum (IEEE add, bit for bit the CPU's sequential fold; a NaN sum may
// carry another NaN payload than the CPU's); 1 max and
// 2 min with XLA's semantics — NaN propagates (written as the canonical
// quiet NaN) and -0.0 < +0.0 — which are order-free but differ from torch's
// scatter_reduce_ on signed zeros.
//
// Input: the targets already grouped, in lane order within each group: the
// wrapper passes `keys` (the targets, stably sorted) and `perm` (the lane
// each sorted position came from). Two launches:
//   1. gather_sorted: vs[i] = v[perm[i]], so each run's values lie
//      contiguous in fold order (one thread per position);
//   2. fold_runs: one warp per 32 sorted positions; the warp takes the runs
//      that START in its positions one after another (a ballot of the run
//      heads), reads each run 32 positions per step — coalesced, the next
//      step's loads issued before this step's fold — and folds them in order
//      through warp shuffles: every lane keeps the same accumulator, and lane
//      0 writes acc[t] once. Warps whose positions all lie inside a run that
//      began earlier exit at once.
// Targets outside [0, n_acc) are skipped, and so are the multiples of
// `identity_stride` when it is > 0: the reserved identity slot 0 of each
// [identity_stride] shard plane, where the exchange's padded lanes land with
// the identity value (folding them would leave the slot's bits unchanged).
//
// Bound: each lane's target (8 B) and value (4 or 8 B) read once, and each
// touched accumulator read and written once — memory-bound. A hot target
// makes one long run that one warp walks in order at one dependent add per
// value; that, not the bytes, sets the pace on skewed keys (and on the
// identity slot when it is not skipped).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ long long order_key(double x) {
  const long long b = __double_as_longlong(x);
  return b ^ ((b >> 63) & 0x7fffffffffffffffll);
}
__device__ __forceinline__ float quiet_nan(float) {
  return __int_as_float(0x7fc00000);
}
__device__ __forceinline__ double quiet_nan(double) {
  return __longlong_as_double(0x7ff8000000000000ll);
}

template <int kOp, typename T>
__device__ __forceinline__ T combine(T a, T x) {
  if (kOp == 0) return a + x;
  if (a != a || x != x) return quiet_nan(a);
  const bool take = kOp == 1 ? order_key(x) > order_key(a)
                             : order_key(x) < order_key(a);
  return take ? x : a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_sorted(const int64_t* __restrict__ perm, const T* __restrict__ v,
                  T* __restrict__ vs, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) vs[i] = v[perm[i]];
}

template <int kOp, typename T>
__global__ void __launch_bounds__(kThreads)
    fold_runs(const int64_t* __restrict__ keys, const T* __restrict__ vs,
              T* __restrict__ acc, int64_t n, int64_t n_acc,
              int64_t identity_stride) {
  const int lane = threadIdx.x & 31;
  const int64_t wbase =
      ((int64_t)blockIdx.x * kThreads + threadIdx.x) - lane;
  const int64_t i = wbase + lane;
  const int64_t ti = i < n ? keys[i] : 0;
  const bool head = i < n && (i == 0 || keys[i - 1] != ti);
  unsigned heads = __ballot_sync(kFull, head);
  while (heads) {
    const int h = __ffs(heads) - 1;
    heads &= heads - 1;
    const int64_t t = __shfl_sync(kFull, ti, h);
    if (t < 0 || t >= n_acc ||
        (identity_stride > 0 && t % identity_stride == 0))
      continue;  // warp-uniform
    T a = acc[t];
    int64_t p = wbase + h + lane;
    bool in = p < n && keys[p] == t;
    T x = in ? vs[p] : T(0);
    while (true) {
      const unsigned m = __ballot_sync(kFull, in);  // a prefix of the warp
      const int cnt = __popc(m);
      // issue the next step's loads before folding this one
      const int64_t q = p + 32;
      const bool in_next = cnt == 32 && q < n && keys[q] == t;
      const T x_next = in_next ? vs[q] : T(0);
      if (cnt == 32) {
#pragma unroll
        for (int l = 0; l < 32; ++l)
          a = combine<kOp>(a, __shfl_sync(kFull, x, l));
      } else {
        for (int l = 0; l < cnt; ++l)
          a = combine<kOp>(a, __shfl_sync(kFull, x, l));
        break;
      }
      p = q;
      in = in_next;
      x = x_next;
    }
    if (lane == 0) acc[t] = a;
  }
}

template <typename T>
int launch(const int64_t* keys, const int64_t* perm, const void* v, void* vs,
           void* acc, int64_t n, int64_t n_acc, int64_t identity_stride,
           int op, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  T* sorted = static_cast<T*>(vs);
  T* aa = static_cast<T*>(acc);
  gather_sorted<T><<<blocks, kThreads, 0, s>>>(
      perm, static_cast<const T*>(v), sorted, n);
  switch (op) {
    case 0:
      fold_runs<0, T><<<blocks, kThreads, 0, s>>>(keys, sorted, aa, n, n_acc,
                                                 identity_stride);
      break;
    case 1:
      fold_runs<1, T><<<blocks, kThreads, 0, s>>>(keys, sorted, aa, n, n_acc,
                                                 identity_stride);
      break;
    case 2:
      fold_runs<2, T><<<blocks, kThreads, 0, s>>>(keys, sorted, aa, n, n_acc,
                                                 identity_stride);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the gather and the fold on `stream` of CUDA device `device`;
// `vs` is scratch for n values. elem_bytes 4 = float32, 8 = float64; op 0
// sum, 1 max, 2 min; identity_stride 0 folds every in-range target. Returns
// 0 or a cudaError_t.
int ordered_fold_launch(const int64_t* keys, const int64_t* perm,
                        const void* v, void* vs, void* acc, int64_t n,
                        int64_t n_acc, int64_t identity_stride,
                        int32_t elem_bytes, int32_t op, int32_t device,
                        void* stream) {
  if (n <= 0) return 0;
  if (op < 0 || op > 2 || identity_stride < 0 ||
      (n + kThreads - 1) / kThreads > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch<float>(keys, perm, v, vs, acc, n, n_acc, identity_stride,
                         op, s);
  if (elem_bytes == 8)
    return launch<double>(keys, perm, v, vs, acc, n, n_acc, identity_stride,
                          op, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
