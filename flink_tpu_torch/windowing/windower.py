"""Window result columns shared by the window engines (the constants of
``flink_tpu/windowing/windower.py``).

The single-device engine of that module (``SliceSharedWindower``, Q5 at
parallelism 1) is ROADMAP Queue A item 3 and not ported yet; this slice
runs windows on the mesh engine (``parallel/sharded_windower.py``).
"""

WINDOW_START_FIELD = "window_start"
WINDOW_END_FIELD = "window_end"
