"""Table/SQL API — minimal SQL layer over the DataStream operators (port of
``flink_tpu/table/__init__.py``).

reference: flink-table/* (TableEnvironmentImpl.executeSql at
flink-table/flink-table-api-java/.../internal/TableEnvironmentImpl.java:936;
planner translate at flink-table-planner/.../delegation/PlannerBase.scala:175).

Re-design: no Calcite, no Janino codegen — the SQL text is parsed by a small
recursive-descent parser, planned directly onto the vectorized DataStream
operators. Scalar expressions evaluate as vectorized NumPy on host columns;
aggregations run on the device slot table of ``execution.device``.
"""

from flink_tpu_torch.table.environment import (  # noqa: F401
    StreamTableEnvironment,
    Table,
    TableResult,
)
