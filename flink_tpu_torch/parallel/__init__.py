"""Key-group parallelism: the logical mesh and its host topology, the
keyed exchange (flat, two-level and host bucketing), the mesh engines, and
the pod's routing between processes."""
