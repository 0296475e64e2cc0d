"""Stream elements: the watermark bounds (port of the constants of
``flink_tpu/runtime/elements.py``)."""

MAX_WATERMARK = (1 << 62)  # end-of-input flush
MIN_WATERMARK = -(1 << 62)
