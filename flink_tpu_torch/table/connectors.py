"""SQL connector registry — CREATE TABLE ... WITH ('connector'='...') (port of
``flink_tpu/table/connectors.py``).

reference: the DynamicTableFactory SPI
(flink-table/flink-table-common/src/main/java/org/apache/flink/table/factories/DynamicTableFactory.java:1)
discovered by the 'connector' option, producing ScanTableSource /
DynamicTableSink per table. Re-design: a factory is a plain callable
``factory(table_env, CreateTable) -> None`` that registers the table as a
source view and/or INSERT INTO sink on the environment; register custom
connectors with :func:`register_connector`.
"""

from __future__ import annotations

from typing import Callable, Dict

_CONNECTORS: Dict[str, Callable] = {}


def register_connector(name: str, factory: Callable) -> None:
    """``factory(table_env, stmt)`` wires a CreateTable statement into the
    environment (source view, sink table, or both)."""
    _CONNECTORS[name.lower()] = factory


def resolve_connector(name: str) -> Callable:
    factory = _CONNECTORS.get(name.lower())
    if factory is None:
        from flink_tpu_torch.table.environment import PlanError

        raise PlanError(
            f"unknown connector {name!r} (registered: "
            f"{sorted(_CONNECTORS)}); add one with "
            "flink_tpu_torch.table.connectors.register_connector")
    return factory


def _opt_bool(options: dict, key: str, default: bool) -> bool:
    v = options.get(key)
    if v is None:
        return default
    return str(v).lower() in ("true", "1", "yes")


def _kafka_factory(tenv, stmt) -> None:
    """'kafka': partitioned source (bounded or unbounded scan) AND
    partitioned append sink under the same table name — the reference's
    kafka tables are readable and writable too."""
    from flink_tpu_torch.connectors.kafka import KafkaSink, KafkaSource
    from flink_tpu_torch.table.environment import PlanError

    opts = stmt.options
    topic = opts.get("topic")
    if not topic:
        raise PlanError(f"CREATE TABLE {stmt.name}: kafka connector "
                        "requires a 'topic' option")
    broker_name = opts.get("broker", "default")
    bounded = _opt_bool(opts, "scan.bounded", True)
    cols = [c for c, _ in stmt.columns]
    col_types = [t for _, t in stmt.columns]
    wm_field = stmt.watermark_field
    deser = ser = None
    fmt = opts.get("format")
    if fmt:
        # the format seam: raw byte records <-> typed columns
        # (reference: 'format' = 'json' resolved through the
        # DeserializationFormatFactory SPI)
        from flink_tpu_torch.connectors.formats import resolve_format

        deser, ser = resolve_format(fmt, cols, col_types, opts)
    source = KafkaSource(topic, broker_name=broker_name, bounded=bounded,
                         timestamp_field=wm_field, value_format=deser)
    strategy = source.watermark_strategy(stmt.watermark_delay_ms)
    stream = tenv.env.from_source(source, strategy)
    tenv.create_temporary_view(stmt.name, stream, columns=cols,
                               time_field=wm_field)
    pk = getattr(stmt, "primary_key", None)
    if pk:
        bad = [k for k in pk if k not in cols]
        if bad:
            raise PlanError(
                f"CREATE TABLE {stmt.name}: PRIMARY KEY columns {bad} "
                f"are not table columns {cols}")
    tenv.create_sink_table(
        stmt.name,
        KafkaSink(topic, broker_name=broker_name,
                  partition_by=opts.get("sink.partition-by"),
                  num_partitions=int(opts.get("sink.partitions", "1")),
                  upsert_keys=pk, value_format=ser),
        columns=cols)


def _datagen_factory(tenv, stmt) -> None:
    """'datagen': the deterministic synthetic source as a SQL table
    (reference: the datagen connector)."""
    from flink_tpu_torch.connectors.sources import DataGenSource
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.table.environment import PlanError

    opts = stmt.options
    cols = [c for c, _ in stmt.columns]
    if len(cols) < 2:
        raise PlanError(
            f"CREATE TABLE {stmt.name}: datagen needs (key_col, "
            "value_col [, ...]) columns")
    source = DataGenSource(
        total_records=int(opts.get("number-of-rows", "10000")),
        num_keys=int(opts.get("number-of-keys", "100")),
        events_per_second_of_eventtime=int(
            opts.get("rows-per-second", "10000")),
        key_field=cols[0], value_field=cols[1],
        seed=int(opts.get("seed", "7")))
    strategy = WatermarkStrategy.for_bounded_out_of_orderness(
        stmt.watermark_delay_ms)
    stream = tenv.env.from_source(source, strategy)
    tenv.create_temporary_view(stmt.name, stream, columns=cols,
                               time_field=stmt.watermark_field)


def _collect_factory(tenv, stmt) -> None:
    """'collect': an in-memory append/changelog sink table for tests and
    interactive use (reference: the 'blackhole'/test sinks)."""
    from flink_tpu_torch.connectors.sinks import CollectSink

    sink = CollectSink()
    sink.supports_changelog = _opt_bool(stmt.options, "changelog", False)
    cols = [c for c, _ in stmt.columns] or None
    tenv.create_sink_table(stmt.name, sink, columns=cols)


def _filesystem_factory(tenv, stmt) -> None:
    """'filesystem': bucketed exactly-once FileSink AND a bounded
    committed-files scan under the same table name (reference: the
    filesystem table connector — readable and writable, partitioned
    directories, 'format' option through the (De)SerializationSchema
    seam). Options:

    - ``path`` (required), ``format`` (default 'json')
    - ``sink.bucket-by``: column name, or ``sink.bucket-datetime``:
      strftime pattern over event time (partitioned directories)
    - ``sink.rolling-policy.max-part-bytes`` / ``.max-part-records`` /
      ``.rollover-interval-ms``
    """
    from flink_tpu_torch.connectors.filesystem import (
        ColumnBucketAssigner,
        DateTimeBucketAssigner,
        FileSink,
        FileSource,
        RollingPolicy,
    )
    from flink_tpu_torch.connectors.formats import resolve_format
    from flink_tpu_torch.table.environment import PlanError

    opts = stmt.options
    path = opts.get("path")
    if not path:
        raise PlanError(f"CREATE TABLE {stmt.name}: filesystem connector "
                        "requires a 'path' option")
    cols = [c for c, _ in stmt.columns]
    col_types = [t for _, t in stmt.columns]
    fmt = opts.get("format", "json")
    deser, ser = resolve_format(fmt, cols, col_types, opts)

    assigner = None
    if opts.get("sink.bucket-by"):
        bucket_col = opts["sink.bucket-by"]
        if bucket_col not in cols:
            raise PlanError(
                f"CREATE TABLE {stmt.name}: sink.bucket-by column "
                f"{bucket_col!r} is not a table column {cols}")
        assigner = ColumnBucketAssigner(bucket_col)
    elif opts.get("sink.bucket-datetime"):
        assigner = DateTimeBucketAssigner(opts["sink.bucket-datetime"])
    policy = RollingPolicy(
        max_part_bytes=int(opts.get(
            "sink.rolling-policy.max-part-bytes", 128 << 20)),
        max_part_records=int(opts.get(
            "sink.rolling-policy.max-part-records", 0)),
        rollover_interval_ms=int(opts.get(
            "sink.rolling-policy.rollover-interval-ms", 0)))
    tenv.create_sink_table(
        stmt.name,
        FileSink(path, cols, fmt=ser, bucket_assigner=assigner,
                 rolling_policy=policy),
        columns=cols)

    wm_field = stmt.watermark_field
    source = FileSource(path, deser, timestamp_field=wm_field)
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy

    strategy = WatermarkStrategy.for_bounded_out_of_orderness(
        stmt.watermark_delay_ms or 0)
    stream = tenv.env.from_source(source, strategy)
    tenv.create_temporary_view(stmt.name, stream, columns=cols,
                               time_field=wm_field)


register_connector("kafka", _kafka_factory)
register_connector("datagen", _datagen_factory)
register_connector("collect", _collect_factory)
register_connector("filesystem", _filesystem_factory)
