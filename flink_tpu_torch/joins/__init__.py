"""Streaming joins on the device: the interval and temporal join engines
over dual keyed row tables (port of ``flink_tpu/joins/``; see
``joins/engine.py`` for the design)."""

from flink_tpu_torch.joins.engine import (  # noqa: F401
    JoinEngineBase,
    MeshIntervalJoinEngine,
    MeshTemporalJoinEngine,
)
from flink_tpu_torch.joins.operators import (  # noqa: F401
    DeviceIntervalJoinOperator,
    DeviceTemporalJoinOperator,
)
from flink_tpu_torch.joins.side_table import (  # noqa: F401
    JoinSideTable,
    pair_lower_bound,
)
