"""Restart backoff strategies (port of
``flink_tpu/cluster/restart_strategies.py``).

reference: flink-runtime/.../executiongraph/failover/
FixedDelayRestartBackoffTimeStrategy.java,
ExponentialDelayRestartBackoffTimeStrategy.java,
FailureRateRestartBackoffTimeStrategy.java.
"""

from __future__ import annotations

import random
import time
from typing import Callable, List, Optional


class RestartStrategy:
    def can_restart(self) -> bool:
        raise NotImplementedError

    def notify_failure(self) -> None:
        pass

    def backoff_ms(self) -> int:
        raise NotImplementedError


class NoRestartStrategy(RestartStrategy):
    def can_restart(self) -> bool:
        return False

    def backoff_ms(self) -> int:
        return 0


class FixedDelayRestartStrategy(RestartStrategy):
    def __init__(self, max_attempts: int = 3, delay_ms: int = 1000):
        self.max_attempts = max_attempts
        self.delay_ms = delay_ms
        self.attempts = 0

    def notify_failure(self) -> None:
        self.attempts += 1

    def can_restart(self) -> bool:
        return self.attempts < self.max_attempts

    def backoff_ms(self) -> int:
        return self.delay_ms


class ExponentialDelayRestartStrategy(RestartStrategy):
    """Exponential backoff with jitter and a quiet-period reset.

    reference: ExponentialDelayRestartBackoffTimeStrategy — after
    ``reset_backoff_threshold_ms`` of failure-free running the backoff
    (and attempt budget) resets to the initial values, so a job that
    recovered and ran healthily for a while is not punished with the
    max delay (or a spent budget) when it eventually fails again;
    ``jitter_factor`` spreads concurrent restarts by up to +/- that
    fraction of the current backoff (thundering-herd protection).

    ``seed`` pins the jitter PRNG (determinism for chaos runs);
    ``clock`` is injectable for tests (monotonic seconds).
    """

    def __init__(self, initial_ms: int = 100, max_ms: int = 60_000,
                 multiplier: float = 2.0, max_attempts: int = 10,
                 jitter_factor: float = 0.0,
                 reset_backoff_threshold_ms: int = 0,
                 seed: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.initial_ms = initial_ms
        self.max_ms = max_ms
        self.multiplier = multiplier
        self.max_attempts = max_attempts
        self.jitter_factor = float(jitter_factor)
        self.reset_backoff_threshold_ms = int(reset_backoff_threshold_ms)
        self.attempts = 0
        self._current = initial_ms
        self._rng = random.Random(seed)
        self._clock = clock
        self._last_failure_ms: Optional[float] = None

    def notify_failure(self) -> None:
        now_ms = self._clock() * 1000.0
        if (self.reset_backoff_threshold_ms > 0
                and self._last_failure_ms is not None
                and now_ms - self._last_failure_ms
                >= self.reset_backoff_threshold_ms):
            self._current = self.initial_ms
            self.attempts = 0
        if self.attempts > 0:
            self._current = min(self.max_ms,
                                int(self._current * self.multiplier))
        self.attempts += 1
        self._last_failure_ms = now_ms

    def can_restart(self) -> bool:
        return self.attempts < self.max_attempts

    def backoff_ms(self) -> int:
        if self.jitter_factor <= 0.0:
            return self._current
        spread = self._rng.uniform(-self.jitter_factor,
                                   self.jitter_factor)
        return max(0, int(self._current * (1.0 + spread)))


class FailureRateRestartStrategy(RestartStrategy):
    """Allow at most ``max_failures`` within ``interval_ms``."""

    def __init__(self, max_failures: int = 3, interval_ms: int = 60_000,
                 delay_ms: int = 1000,
                 clock: Callable[[], float] = time.monotonic):
        self.max_failures = max_failures
        self.interval_ms = interval_ms
        self.delay_ms = delay_ms
        self._clock = clock
        self._failures: List[float] = []

    def notify_failure(self) -> None:
        now = self._clock() * 1000
        self._failures.append(now)
        cutoff = now - self.interval_ms
        self._failures = [t for t in self._failures if t >= cutoff]

    def can_restart(self) -> bool:
        return len(self._failures) < self.max_failures

    def backoff_ms(self) -> int:
        return self.delay_ms


def restart_strategy_from_config(config) -> RestartStrategy:
    from flink_tpu_torch.core.config import RestartOptions

    kind = config.get(RestartOptions.STRATEGY)
    if kind == "none":
        return NoRestartStrategy()
    if kind == "fixed-delay":
        return FixedDelayRestartStrategy(
            config.get(RestartOptions.MAX_ATTEMPTS),
            config.get(RestartOptions.DELAY_MS))
    if kind == "exponential-delay":
        return ExponentialDelayRestartStrategy(
            initial_ms=config.get(RestartOptions.DELAY_MS),
            max_ms=config.get(RestartOptions.MAX_BACKOFF_MS),
            multiplier=config.get(RestartOptions.BACKOFF_MULTIPLIER),
            max_attempts=config.get(RestartOptions.MAX_ATTEMPTS),
            jitter_factor=config.get(RestartOptions.JITTER_FACTOR),
            reset_backoff_threshold_ms=config.get(
                RestartOptions.RESET_BACKOFF_THRESHOLD_MS))
    if kind == "failure-rate":
        return FailureRateRestartStrategy(
            max_failures=config.get(RestartOptions.MAX_ATTEMPTS),
            interval_ms=config.get(
                RestartOptions.FAILURE_RATE_INTERVAL_MS),
            delay_ms=config.get(RestartOptions.DELAY_MS))
    raise ValueError(f"unknown restart strategy {kind!r}")
