"""Pluggable filesystems (port of ``flink_tpu/core/fs.py``): a small SPI
with two built-ins, the local disk (``file://`` or a bare path) and a
process-local memory filesystem (``mem://``). Other schemes plug in
through ``register_filesystem``; an unregistered scheme raises.
"""

from __future__ import annotations

import io
import os
import posixpath
import shutil
import threading
from typing import Dict, List, Tuple

_registry: Dict[str, "FileSystem"] = {}
_lock = threading.Lock()


class FileSystem:
    """SPI: byte-stream IO + the small directory surface snapshots need."""

    def open(self, path: str, mode: str = "rb"):
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def mkdirs(self, path: str) -> None:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def delete(self, path: str, recursive: bool = False) -> None:
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        """Atomic within one filesystem (the snapshot-commit primitive)."""
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    def open(self, path: str, mode: str = "rb"):
        if "w" in mode or "a" in mode:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                        exist_ok=True)
        return open(path, mode)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def mkdirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def listdir(self, path: str) -> List[str]:
        return os.listdir(path)

    def delete(self, path: str, recursive: bool = False) -> None:
        if os.path.isdir(path):
            if recursive:
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.rmdir(path)
        elif os.path.exists(path):
            os.remove(path)

    def rename(self, src: str, dst: str) -> None:
        os.replace(src, dst)


class _MemFile(io.BytesIO):
    def __init__(self, fs: "InMemoryFileSystem", path: str, data: bytes,
                 writable: bool):
        super().__init__(data)
        if not writable:
            self.seek(0)
        else:
            self.seek(len(data))
        self._fs = fs
        self._path = path
        self._writable = writable

    def flush(self) -> None:
        # mirror local-FS visibility: a write-then-flush is observable by
        # readers even if close() is never reached
        super().flush()
        if self._writable:
            self._fs._store[self._path] = self.getvalue()

    def close(self) -> None:
        if self._writable:
            self._fs._store[self._path] = self.getvalue()
        super().close()


class InMemoryFileSystem(FileSystem):
    """Process-local FS (``mem://``): tests and scratch artifacts.

    Directory semantics are prefix-based like object stores.
    """

    def __init__(self):
        self._store: Dict[str, bytes] = {}
        self._dirs: set = set()

    def _norm(self, path: str) -> str:
        return posixpath.normpath(path).lstrip("/")

    def open(self, path: str, mode: str = "rb"):
        p = self._norm(path)
        if "r" in mode and "w" not in mode and "+" not in mode:
            if p not in self._store:
                raise FileNotFoundError(path)
            return _MemFile(self, p, self._store[p], writable=False)
        base = self._store.get(p, b"") if "a" in mode else b""
        return _MemFile(self, p, base, writable=True)

    def exists(self, path: str) -> bool:
        p = self._norm(path)
        return (p in self._store or p in self._dirs
                or any(k.startswith(p + "/") for k in self._store))

    def mkdirs(self, path: str) -> None:
        self._dirs.add(self._norm(path))

    def listdir(self, path: str) -> List[str]:
        p = self._norm(path)
        prefix = "" if p in (".", "") else p + "/"
        out = set()
        for k in list(self._store) + list(self._dirs):
            if k != p and k.startswith(prefix):
                out.add(k[len(prefix):].split("/")[0])
        return sorted(out)

    def delete(self, path: str, recursive: bool = False) -> None:
        p = self._norm(path)
        self._store.pop(p, None)
        self._dirs.discard(p)
        if recursive:
            for k in [k for k in self._store if k.startswith(p + "/")]:
                del self._store[k]
            self._dirs = {d for d in self._dirs
                          if not d.startswith(p + "/")}

    def rename(self, src: str, dst: str) -> None:
        s, d = self._norm(src), self._norm(dst)
        if s in self._store:
            self._store[d] = self._store.pop(s)
            return
        moved = False
        for k in [k for k in self._store if k.startswith(s + "/")]:
            self._store[d + k[len(s):]] = self._store.pop(k)
            moved = True
        if s in self._dirs or moved:
            self._dirs.discard(s)
            self._dirs.add(d)
        elif not moved:
            raise FileNotFoundError(src)


def register_filesystem(scheme: str, fs: FileSystem) -> None:
    """Plug a filesystem for a scheme (reference: FileSystemFactory SPI)."""
    with _lock:
        _registry[scheme] = fs


def get_filesystem(path: str) -> Tuple[FileSystem, str]:
    """Resolve ``path`` to (filesystem, scheme-local path)."""
    if "://" in path:
        scheme, rest = path.split("://", 1)
        with _lock:
            fs = _registry.get(scheme)
            known = sorted(_registry)
        if fs is None:
            raise ValueError(
                f"no filesystem registered for scheme {scheme!r} "
                f"(registered: {known})")
        return fs, rest
    with _lock:
        return _registry["file"], path


# built-ins
register_filesystem("file", LocalFileSystem())
register_filesystem("mem", InMemoryFileSystem())
