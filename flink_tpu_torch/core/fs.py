"""The local filesystem of ``flink_tpu/core/fs.py`` (port of its local
half, the byte-stream IO the file sinks need).

Paths carry their scheme: ``file:///tmp/x`` or a bare local path. Other
schemes (the reference's in-memory ``mem://`` and registered remote
filesystems) are not ported and raise, naming ROADMAP item 8b.
"""

from __future__ import annotations

import os
from typing import Tuple


class LocalFileSystem:
    def open(self, path: str, mode: str = "rb"):
        if "w" in mode or "a" in mode:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                        exist_ok=True)
        return open(path, mode)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)


_LOCAL = LocalFileSystem()


def get_filesystem(path: str) -> Tuple[LocalFileSystem, str]:
    """Resolve ``path`` to (filesystem, scheme-local path)."""
    if "://" in path:
        scheme, rest = path.split("://", 1)
        if scheme != "file":
            from flink_tpu_torch.state.slot_table import _not_ported

            raise _not_ported(f"the {scheme!r} filesystem scheme", "8b")
        return _LOCAL, rest
    return _LOCAL, path
