from flink_tpu_torch.datastream.environment import StreamExecutionEnvironment
from flink_tpu_torch.datastream.stream import (
    DataStream,
    KeyedStream,
    WindowedStream,
)

__all__ = ["StreamExecutionEnvironment", "DataStream", "KeyedStream",
           "WindowedStream"]
