"""Key-group parallelism: the logical mesh, the keyed exchange, and the
mesh window engine."""
