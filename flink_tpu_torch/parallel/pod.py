"""The pod runtime: record routing between processes (port of
``flink_tpu/parallel/pod.py``).

In pod mode every PROCESS owns a contiguous slice of the key-group space
(``host_key_group_ranges``, the stable process -> range map) and runs its
own engine over its logical shards; that engine's exchange is the
within-host stage. What one process cannot do is deliver a record whose
key belongs to ANOTHER process: that hop is :class:`PodDataPlane`. Each
process puts its sub-batch on its device, ranks every source chunk's
records within their destination host there (``exchange_rank_flat`` at
D = H: the rank kernel on the card, the same function as the reference's
one-hot cumsum), buckets them ``[L, H, W]``, copies the buckets to host
memory and exchanges them with ``torch.distributed.all_to_all_single``
over gloo (gloo takes no CUDA tensors, and NCCL refuses two ranks on one
card). Arrivals flatten by (source host, source chunk, rank); chunks
partition the stream host-major, so each process receives its records in
GLOBAL stream order and every float fold downstream matches a
one-process run bit for bit.

Columns move whole, 64-bit ones included (the reference's int32 lane
pairs were a JAX x32 artifact). The plane also runs in ONE process over a
virtual topology, every host addressable: pass the whole batch and every
host's arrivals come back.

Host-granular planes fall out of the process split: each process keeps its
own session-metadata plane, spill tier and per-range checkpoint units, so
a lost process is "restore its units, replay one contiguous range"
(``benchmarks/multiproc.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.core.device import DeviceLike, resolve_device
from flink_tpu_torch.ops.segment_ops import sticky_bucket
from flink_tpu_torch.parallel.mesh import HostTopology
from flink_tpu_torch.state.keygroups import host_key_group_ranges
from flink_tpu_torch.stateplane.rank import exchange_rank_flat


def _dist():
    """``torch.distributed`` when a process group is up, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def build_pod_route(topology: HostTopology):
    """The routing step: ``route(dst [R, C] int32, cols, W)`` ranks each
    source chunk's records within their destination HOST (one rank-kernel
    launch on the card; ``H`` marks padding) and scatters them into
    ``[R, H, W]`` buckets per column, the destination column first (a
    real lane carries its destination host, a padded one ``H``)."""
    H = topology.num_hosts

    def route(dst: torch.Tensor, cols: Sequence[torch.Tensor], w: int
              ) -> List[torch.Tensor]:
        R = dst.shape[0]
        W = int(w)
        flat = exchange_rank_flat(dst, H, W)

        def bucket(col: torch.Tensor, fill) -> torch.Tensor:
            buf = torch.full((R, H * W + 1), fill, dtype=col.dtype,
                             device=col.device)
            buf.scatter_(1, flat, col)
            return buf[:, :H * W].view(R, H, W)

        return [bucket(dst, H), *[bucket(c, 0) for c in cols]]

    return route


def agree_max(values: Sequence[int]) -> List[int]:
    """The agree step: every process must exchange blocks of the same
    shape, so each takes the element-wise MAX of its values over all
    processes (one ``all_reduce(MAX)`` of a small int64 tensor); the
    values unchanged in one process."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return [int(v) for v in values]
    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [int(v) for v in t.tolist()]


class PodDataPlane:
    """Routes raw record columns to their owning process.

    ``dtypes``: the record columns every :meth:`exchange` carries (key
    ids, timestamps, values). ``device``: where the rank and the
    bucketing run (``execution.device``: the card unless the caller asks
    for the CPU). Counters: ``rows_cross_host`` / ``rows_intra_host``
    (records that left / stayed on their source process),
    ``bytes_sent`` (bytes this process handed gloo for other processes),
    ``route_s`` (seconds inside :meth:`exchange`) and ``batches``."""

    def __init__(self, topology: HostTopology, dtypes: Sequence,
                 max_parallelism: int = 128, min_bucket: int = 256,
                 device: DeviceLike = None) -> None:
        self.topology = topology
        dist = _dist()
        world = dist.get_world_size() if dist is not None else 1
        if world not in (1, topology.num_hosts):
            raise ValueError(
                f"topology has {topology.num_hosts} hosts but the process "
                f"group has {world} processes")
        self.multi = world > 1
        self.my_host = dist.get_rank() if self.multi else 0
        self.device = resolve_device(device)
        self.dtypes = tuple(np.dtype(d) for d in dtypes)
        self.max_parallelism = int(max_parallelism)
        self.min_bucket = int(min_bucket)
        self._route = build_pod_route(topology)
        self._chunk_bucket = 0
        self._w_bucket = 0
        self.host_ranges = host_key_group_ranges(
            topology.num_hosts, topology.local_devices,
            self.max_parallelism)
        self.rows_cross_host = 0
        self.rows_intra_host = 0
        self.bytes_sent = 0
        self.route_s = 0.0
        self.batches = 0

    def _agree(self, chunk_max: int, pair_max: int) -> Tuple[int, int]:
        """The global chunk length and bucket width (the agree step in
        several processes), on sticky tiers."""
        chunk_max, pair_max = agree_max([chunk_max, pair_max])
        C = sticky_bucket(chunk_max, self._chunk_bucket, self.min_bucket)
        self._chunk_bucket = C
        W = sticky_bucket(min(pair_max, C), self._w_bucket, self.min_bucket)
        self._w_bucket = min(W, C)
        return C, self._w_bucket

    def exchange(self, dst_host: np.ndarray,
                 columns: Sequence[np.ndarray],
                 chunk_bound: Optional[int] = None
                 ) -> Dict[int, List[np.ndarray]]:
        """Route this process's sub-batch: every record lands on its
        owning host, arrivals in GLOBAL stream order.

        Several processes: each passes ITS sub-batch (the global batch is
        their process-major concatenation) and receives
        ``{my_host: [col, ...]}``. One process (virtual topology): pass
        the WHOLE batch and every host's arrivals come back.

        ``chunk_bound``: a deterministic bound on every process's
        per-chunk record count (``ceil(largest sub-batch / L)`` when the
        caller knows the split). With it no agree step runs and the
        bucket width is the chunk tier; without it one ``all_reduce``
        per batch agrees on the shapes."""
        import time

        t0 = time.perf_counter()
        H = self.topology.num_hosts
        L = self.topology.local_devices
        dst_host = np.asarray(dst_host)
        n = len(dst_host)
        columns = [np.asarray(c, dtype=d)
                   for c, d in zip(columns, self.dtypes)]
        local_chunks = L if self.multi else H * L
        per = -(-max(n, 1) // local_chunks)
        if chunk_bound is not None:
            per = max(per, int(chunk_bound))
            C = sticky_bucket(per, self._chunk_bucket, self.min_bucket)
            self._chunk_bucket = C
            self._w_bucket = W = C
        else:
            pair_max = 0
            if n:
                chunk_of = np.arange(n, dtype=np.int64) // per
                pair_max = int(np.bincount(
                    chunk_of * (H + 1) + np.minimum(dst_host, H),
                    minlength=local_chunks * (H + 1))
                    .reshape(local_chunks, H + 1)[:, :H].max())
            C, W = self._agree(per, pair_max)
        if per > C:
            raise AssertionError("agreed chunk below the local need")
        # chunk j holds sub-batch positions [j*per, (j+1)*per): the
        # contiguous split the stream-order reconstruction assumes
        dst_buf = np.full((local_chunks, C), H, dtype=np.int32)
        bufs = [np.zeros((local_chunks, C), dtype=d) for d in self.dtypes]
        src_chunk = np.arange(n, dtype=np.int64) // per
        lane = np.arange(n, dtype=np.int64) - src_chunk * per
        dst_buf[src_chunk, lane] = dst_host
        for buf, col in zip(bufs, columns):
            buf[src_chunk, lane] = col
        src_host = (src_chunk // L if not self.multi
                    else np.full(n, self.my_host))
        cross = int((dst_host != src_host).sum()) if n else 0
        self.rows_cross_host += cross
        self.rows_intra_host += n - cross
        self.batches += 1
        dev = self.device
        blocks = self._route(
            torch.from_numpy(dst_buf).to(dev),
            [torch.from_numpy(b).to(dev) for b in bufs], W)
        # [R, H, W] buckets -> host memory (gloo takes CPU tensors only)
        host = [b.cpu() for b in blocks]
        if self.multi:
            out = self._all_to_all(host)
            hosts = {self.my_host: [o.numpy() for o in out]}
        else:
            # one process: the hosts axis is a transpose,
            # [H_src * L, H_dst, W] -> per destination [H_src, L, W]
            hosts = {h: [b.view(H, L, H, W)[:, :, h].numpy() for b in host]
                     for h in range(H)}
        arrivals: Dict[int, List[np.ndarray]] = {}
        for h, cols in hosts.items():
            # (source host, source chunk, rank): global stream order;
            # a real lane carries its destination host h
            valid = cols[0].reshape(-1) == h
            arrivals[h] = [np.ascontiguousarray(c.reshape(-1)[valid])
                           for c in cols[1:]]
        self.route_s += time.perf_counter() - t0
        return arrivals

    def _all_to_all(self, blocks: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """``[L, H_dst, W]`` buckets of this process -> ``[H_src, L, W]``
        arrivals from every process, one ``all_to_all_single`` per
        column."""
        dist = _dist()
        H = self.topology.num_hosts
        out = []
        for b in blocks:
            send = b.transpose(0, 1).contiguous()       # [H_dst, L, W]
            recv = torch.empty_like(send)               # [H_src, L, W]
            dist.all_to_all_single(recv, send)
            per_host = send[0].numel() * send.element_size()
            self.bytes_sent += per_host * (H - 1)
            out.append(recv)
        return out
