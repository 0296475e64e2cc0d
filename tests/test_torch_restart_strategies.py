"""Restart strategies: the port (``flink_tpu_torch/cluster/
restart_strategies.py``) against the reference on the same failure
sequences, clocks and seeds — every ``can_restart`` and ``backoff_ms``
equal."""

import importlib

import pytest

PKGS = ("reference", "port")


def _mods(pkg):
    base = "flink_tpu" if pkg == "reference" else "flink_tpu_torch"
    return (importlib.import_module(f"{base}.cluster.restart_strategies"),
            importlib.import_module(f"{base}.core.config"))


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _trace(strategy, steps, clock=None):
    """Drive ``strategy`` through ``steps`` (seconds to advance before each
    failure); returns every (can_restart, backoff_ms) after a failure."""
    out = []
    for dt in steps:
        if clock is not None:
            clock.t += dt
        strategy.notify_failure()
        out.append((strategy.can_restart(), strategy.backoff_ms()))
    return out


@pytest.mark.parametrize("pkg", PKGS)
def test_fixed_delay(pkg):
    rs, _ = _mods(pkg)
    s = rs.FixedDelayRestartStrategy(max_attempts=2, delay_ms=5)
    assert s.can_restart()
    s.notify_failure()
    assert s.can_restart() and s.backoff_ms() == 5
    s.notify_failure()
    assert not s.can_restart()


@pytest.mark.parametrize("pkg", PKGS)
def test_exponential_grows(pkg):
    rs, _ = _mods(pkg)
    s = rs.ExponentialDelayRestartStrategy(initial_ms=10, max_attempts=5)
    s.notify_failure()
    b1 = s.backoff_ms()
    s.notify_failure()
    assert s.backoff_ms() > b1


@pytest.mark.parametrize("pkg", PKGS)
def test_failure_rate(pkg):
    rs, _ = _mods(pkg)
    s = rs.FailureRateRestartStrategy(max_failures=2, interval_ms=60_000)
    s.notify_failure()
    assert s.can_restart()
    s.notify_failure()
    assert not s.can_restart()


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_exponential_jitter_is_seeded_and_equal(seed):
    traces = []
    for pkg in PKGS:
        rs, _ = _mods(pkg)
        clock = _Clock()
        s = rs.ExponentialDelayRestartStrategy(
            initial_ms=50, max_ms=3_000, multiplier=1.7, max_attempts=9,
            jitter_factor=0.3, seed=seed, clock=clock)
        traces.append(_trace(s, [0.01] * 10, clock))
    assert traces[0] == traces[1]
    assert traces[0][-1][0] is False  # the budget runs out
    assert len({b for _, b in traces[0]}) > 3


def test_exponential_reset_threshold_with_an_injected_clock():
    steps = [0.0, 0.1, 0.1, 5.0, 0.1, 0.1, 0.1]
    traces = []
    for pkg in PKGS:
        rs, _ = _mods(pkg)
        clock = _Clock()
        s = rs.ExponentialDelayRestartStrategy(
            initial_ms=100, max_ms=10_000, multiplier=2.0, max_attempts=4,
            reset_backoff_threshold_ms=2_000, clock=clock)
        traces.append(_trace(s, steps, clock))
    assert traces[0] == traces[1]
    backoffs = [b for _, b in traces[0]]
    # quiet for 5 s (> 2 s): back to the initial backoff and budget
    assert backoffs[:4] == [100, 200, 400, 100]
    assert traces[0][3][0] is True


def test_failure_rate_window_slides_with_the_clock():
    steps = [0.0, 1.0, 1.0, 70.0, 1.0, 1.0]
    traces = []
    for pkg in PKGS:
        rs, _ = _mods(pkg)
        clock = _Clock()
        s = rs.FailureRateRestartStrategy(max_failures=3, interval_ms=60_000,
                                          delay_ms=25, clock=clock)
        traces.append(_trace(s, steps, clock))
    assert traces[0] == traces[1]
    assert [c for c, _ in traces[0]] == [True, True, False, True, True,
                                         False]


CONFIGS = [
    {},
    {"restart-strategy.type": "none"},
    {"restart-strategy.type": "fixed-delay",
     "restart-strategy.max-attempts": 5, "restart-strategy.delay-ms": 7},
    {"restart-strategy.type": "exponential-delay",
     "restart-strategy.delay-ms": 20,
     "restart-strategy.exponential-delay.max-backoff-ms": 500,
     "restart-strategy.exponential-delay.backoff-multiplier": 3.0,
     "restart-strategy.exponential-delay.jitter-factor": 0.0,
     "restart-strategy.exponential-delay.reset-backoff-threshold-ms": 9},
    {"restart-strategy.type": "failure-rate",
     "restart-strategy.max-attempts": 2,
     "restart-strategy.failure-rate.failure-rate-interval-ms": 1000,
     "restart-strategy.delay-ms": 3},
]


@pytest.mark.parametrize("conf", CONFIGS,
                         ids=[c.get("restart-strategy.type", "default")
                              for c in CONFIGS])
def test_strategy_from_config_matches(conf):
    built = []
    for pkg in PKGS:
        rs, cfg = _mods(pkg)
        s = rs.restart_strategy_from_config(cfg.Configuration(dict(conf)))
        attrs = {k: v for k, v in vars(s).items()
                 if not k.startswith("_")}
        built.append((type(s).__name__, attrs,
                      _trace(s, [0.0] * 6)))
    assert built[0] == built[1]


@pytest.mark.parametrize("pkg", PKGS)
def test_unknown_strategy_raises(pkg):
    rs, cfg = _mods(pkg)
    with pytest.raises(ValueError, match="unknown restart strategy"):
        rs.restart_strategy_from_config(
            cfg.Configuration({"restart-strategy.type": "sometimes"}))


def test_the_config_keys_and_defaults_are_the_references():
    names = ("RestartOptions", "ClusterOptions", "SchedulerOptions",
             "HighAvailabilityOptions")
    _, ref = _mods("reference")
    _, port = _mods("port")
    for name in names:
        r, p = getattr(ref, name), getattr(port, name)
        for attr, opt in vars(r).items():
            if attr.isupper():
                got = getattr(p, attr)
                assert (got.key, got.default, got.type) == \
                    (opt.key, opt.default, opt.type), (name, attr)
