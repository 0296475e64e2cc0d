"""Adaptive micro-batch sizing — the buffer-debloater analog (port of
``flink_tpu/runtime/debloater.py``, unchanged).

The reference tunes in-flight network buffers so queued data represents a
configured latency (reference: runtime/throughput/BufferDebloater.java,
BufferSizeEMA.java, ThroughputCalculator.java). In the micro-batch engine
the knob is the batch size itself: a batch is processed in
``records / throughput`` seconds, and a window can only fire at a batch
boundary, so the batch size bounds the fire-latency floor. The controller
holds ``batch = throughput_ema * target_latency * headroom`` so that each
batch costs a fraction of the latency budget, leaving the rest for the
fire itself.
"""

from __future__ import annotations


class BatchSizeController:
    """EMA throughput -> batch size targeting a latency budget.

    ``observe(records, elapsed_s)`` is called once per processed batch;
    ``size`` is the current recommendation. Growth/shrink per step is
    bounded (x2 / /2) so one noisy measurement cannot swing the size, and
    the result is clamped to [min_size, max_size] and rounded to a power
    of two so the device programs see a tiny set of shapes (sticky buckets
    downstream would otherwise re-pad anyway).
    """

    def __init__(self, initial: int, min_size: int, max_size: int,
                 target_latency_ms: float, alpha: float = 0.3,
                 headroom: float = 0.5):
        self.min_size = max(int(min_size), 16)
        self.max_size = max(int(max_size), self.min_size)
        self.target_s = float(target_latency_ms) / 1000.0
        self.alpha = float(alpha)
        self.headroom = float(headroom)
        self._rate_ema: float = 0.0
        self.size = int(min(max(initial, self.min_size), self.max_size))

    def observe(self, records: int, elapsed_s: float) -> int:
        if records <= 0 or elapsed_s <= 0:
            return self.size
        rate = records / elapsed_s
        self._rate_ema = (rate if self._rate_ema == 0.0
                          else self.alpha * rate
                          + (1 - self.alpha) * self._rate_ema)
        want = self._rate_ema * self.target_s * self.headroom
        # bounded step: at most double or halve per observation
        want = min(max(want, self.size / 2), self.size * 2)
        want = min(max(int(want), self.min_size), self.max_size)
        # round down to a power of two (a stable shape set) — but the
        # configured bounds dominate: never round below min_size
        p2 = 1 << max(want.bit_length() - 1, 4)
        self.size = min(max(p2, self.min_size), self.max_size)
        return self.size
