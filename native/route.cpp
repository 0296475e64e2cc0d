// Route one micro-batch by shard in two passes: a counting-sort partition.
//
// The mesh window engine sends each record to the shard that owns its key
// group and hands the slot index each shard's records as one contiguous
// run, in stream order. In NumPy that is the key-group hash, the shard
// formula, a stable argsort of the shard ids, a bincount and two gathers.
// Here it is two passes over the records:
//
//   pass 1: key -> key group (the fold k ^ (k >> 32) with an arithmetic
//           shift, truncated to 32 bits, the MurmurHash3 fmix32 finalizer,
//           % max_parallelism: bit for bit flink_tpu_torch.state.keygroups.
//           assign_key_groups), group -> shard through the caller's table,
//           and a count per shard;
//   pass 2: each record, in stream order, at its shard's next position:
//           exactly the order of np.argsort(shards, kind="stable").
//
// The table holds the engine's routing of every key group (the contiguous
// formula, a sub-range's local formula or a rebalanced assignment), so one
// loop serves all three. A record whose table entry is outside [0, P), or a
// P beyond the counters kept here, returns an error code before anything
// past the counts is written: the caller then takes its NumPy path.
//
// Plain C ABI for ctypes; every array is a raw pointer into a NumPy buffer.

#include <cstdint>

namespace {

constexpr int64_t kMaxShards = 4096;

inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

}  // namespace

extern "C" {

// Error codes of rt_partition.
enum { RT_OK = 0, RT_BAD_SHAPE = -1, RT_BAD_TABLE = -2 };

// n records (key_ids, namespaces) -> shards[n] (int32), offsets[P + 1]
// (shard p's records are order[offsets[p]:offsets[p + 1]]), order[n] and
// the grouped columns s_keys[n], s_ns[n] = key_ids[order], namespaces[order].
int64_t rt_partition(int64_t n, const int64_t* key_ids,
                     const int64_t* namespaces, int64_t max_parallelism,
                     const int32_t* table, int64_t P, int32_t* shards,
                     int64_t* offsets, int64_t* order, int64_t* s_keys,
                     int64_t* s_ns) {
  if (P < 1 || P > kMaxShards || max_parallelism < 1 || n < 0)
    return RT_BAD_SHAPE;
  int64_t next[kMaxShards];
  for (int64_t p = 0; p < P; p++) next[p] = 0;
  const uint32_t mp = (uint32_t)max_parallelism;
  const uint32_t up = (uint32_t)P;
  for (int64_t i = 0; i < n; i++) {
    const int64_t k = key_ids[i];
    const uint32_t folded = (uint32_t)(uint64_t)(k ^ (k >> 32));
    const int32_t s = table[fmix32(folded) % mp];
    if ((uint32_t)s >= up) return RT_BAD_TABLE;
    shards[i] = s;
    next[s]++;
  }
  int64_t at = 0;
  for (int64_t p = 0; p < P; p++) {
    offsets[p] = at;
    const int64_t c = next[p];
    next[p] = at;
    at += c;
  }
  offsets[P] = at;
  for (int64_t i = 0; i < n; i++) {
    const int64_t j = next[shards[i]]++;
    order[j] = i;
    s_keys[j] = key_ids[i];
    s_ns[j] = namespaces[i];
  }
  return RT_OK;
}

}  // extern "C"
