"""streambench: the end-to-end benchmark of ``flink_tpu_torch`` on one
NVIDIA H100. See ``README.md``; the entry point is ``streambench.run``."""
