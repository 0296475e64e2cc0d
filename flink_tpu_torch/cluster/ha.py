"""High availability: leader election, job graph store, blob store (port
of ``flink_tpu/cluster/ha.py``).

reference:
- leader election: runtime/leaderelection/DefaultLeaderElectionService.java
  with ZooKeeper (ZooKeeperLeaderElectionDriver) / Kubernetes ConfigMap
  drivers. Re-design: the same service/driver/contender split with a
  filesystem lease driver (atomic O_EXCL lock file + mtime-renewed lease,
  stale-lease takeover) — the coordination primitive available in this
  environment; ZK/K8s drivers would plug in through the same Driver SPI.
- fencing: each acquired leadership gets a fresh fencing token (the
  reference's leader session id) that RPCs carry.
- job graph store: runtime/jobmanager/JobGraphStore — submitted jobs are
  persisted so a failed-over dispatcher can recover them, through the
  RPC layer's serializer (``cluster/rpc.py`` ``dumps``: the user's
  closures go by value).
- blob store: runtime/blob/BlobServer — content-addressed artifact
  distribution with local caching.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from flink_tpu_torch.cluster.rpc import dumps, loads


# ---------------------------------------------------------------------------
# Leader election
# ---------------------------------------------------------------------------


class LeaderContender:
    """Callbacks the service invokes (reference: LeaderContender)."""

    def grant_leadership(self, fencing_token: int) -> None:
        raise NotImplementedError

    def revoke_leadership(self) -> None:
        raise NotImplementedError


class FileLeaderElectionDriver:
    """Filesystem lease: whoever atomically creates ``<dir>/<name>.lock``
    holds leadership; the holder renews the lease by touching the file; a
    lease not renewed within ``lease_timeout`` is stale and may be taken
    over (reference: the ZK ephemeral-node / K8s lease semantics)."""

    def __init__(self, storage_dir: str, name: str,
                 lease_timeout_s: float = 3.0):
        self.dir = storage_dir
        self.name = name
        self.lease_timeout_s = lease_timeout_s
        self.owner_id = uuid.uuid4().hex
        os.makedirs(storage_dir, exist_ok=True)

    @property
    def _lock_path(self) -> str:
        return os.path.join(self.dir, f"{self.name}.lock")

    def try_acquire(self) -> bool:
        path = self._lock_path
        payload = json.dumps({"owner": self.owner_id,
                              "ts": time.time()}).encode()
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, payload)
            os.close(fd)
            return True
        except FileExistsError:
            pass
        # stale-lease takeover
        try:
            with open(path) as f:
                data = json.load(f)
            if data.get("owner") == self.owner_id:
                return True
            age = time.time() - os.path.getmtime(path)
            if age > self.lease_timeout_s:
                # steal via atomic replace so two stealers cannot both win
                tmp = path + f".steal-{self.owner_id}"
                with open(tmp, "w") as f:
                    f.write(payload.decode())
                os.replace(tmp, path)
                time.sleep(0.01)  # let a racing replace land
                with open(path) as f:
                    return json.load(f).get("owner") == self.owner_id
        except (OSError, ValueError):
            pass
        return False

    def renew(self) -> bool:
        """Touch the lease; False if leadership was lost.

        The touch races a stale-lease ``os.replace`` steal (try_acquire):
        between our read and the utime a stealer may have replaced the
        file, so verify ownership AFTER touching — a renewing loser must
        observe the loss rather than both sides believing they lead."""
        path = self._lock_path
        try:
            with open(path) as f:
                if json.load(f).get("owner") != self.owner_id:
                    return False
            os.utime(path, None)
            with open(path) as f:
                return json.load(f).get("owner") == self.owner_id
        except (OSError, ValueError):
            return False

    def release(self) -> None:
        try:
            with open(self._lock_path) as f:
                if json.load(f).get("owner") == self.owner_id:
                    os.remove(self._lock_path)
        except (OSError, ValueError):
            pass


class LeaderElectionService:
    """Drives a contender through grant/revoke using a driver
    (reference: DefaultLeaderElectionService)."""

    def __init__(self, driver: FileLeaderElectionDriver,
                 contender: LeaderContender,
                 poll_interval_s: float = 0.1):
        self.driver = driver
        self.contender = contender
        self.poll_interval_s = poll_interval_s
        self.is_leader = False
        self.fencing_token: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name=f"leader-election-{self.driver.name}",
            daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            if not self.is_leader:
                if self.driver.try_acquire():
                    self.is_leader = True
                    self.fencing_token = uuid.uuid4().int & ((1 << 62) - 1)
                    try:
                        self.contender.grant_leadership(self.fencing_token)
                    except Exception:
                        pass
            else:
                if not self.driver.renew():
                    self.is_leader = False
                    self.fencing_token = None
                    try:
                        self.contender.revoke_leadership()
                    except Exception:
                        pass
            self._stop.wait(self.poll_interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        if self.is_leader:
            self.driver.release()
            self.is_leader = False


# ---------------------------------------------------------------------------
# Job graph store
# ---------------------------------------------------------------------------


class JobGraphStore:
    """Persist submitted jobs for dispatcher failover recovery
    (reference: runtime/jobmanager/DefaultJobGraphStore over ZK/K8s;
    payloads are pickled by the RPC serializer, like the reference's
    serialized JobGraphs)."""

    def __init__(self, storage_dir: str):
        self.dir = os.path.join(storage_dir, "jobgraphs")
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, job_id: str) -> str:
        return os.path.join(self.dir, f"{job_id}.job")

    def put(self, job_id: str, job_name: str, graph, config_dict: dict
            ) -> None:
        blob = dumps(
            {"job_id": job_id, "job_name": job_name, "graph": graph,
             "config": config_dict})
        tmp = self._path(job_id) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self._path(job_id))

    def remove(self, job_id: str) -> None:
        try:
            os.remove(self._path(job_id))
        except OSError:
            pass

    def job_ids(self) -> List[str]:
        return sorted(n[:-4] for n in os.listdir(self.dir)
                      if n.endswith(".job"))

    def get(self, job_id: str) -> Dict[str, Any]:
        with open(self._path(job_id), "rb") as f:
            return loads(f.read())


# ---------------------------------------------------------------------------
# Blob store
# ---------------------------------------------------------------------------


class BlobStore:
    """Content-addressed artifact store with a local cache
    (reference: runtime/blob/BlobServer + PermanentBlobCache). Keys are
    sha256 of the content, so distribution is idempotent; every read —
    cache hit or store fetch — is verified against the key, and a
    corrupted cache entry falls back to a store re-fetch."""

    def __init__(self, storage_dir: str,
                 cache_dir: Optional[str] = None):
        self.dir = os.path.join(storage_dir, "blobs")
        os.makedirs(self.dir, exist_ok=True)
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def put(self, data: bytes) -> str:
        key = hashlib.sha256(data).hexdigest()
        path = os.path.join(self.dir, key)
        if not os.path.exists(path):
            tmp = path + f".tmp-{uuid.uuid4().hex[:8]}"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        return key

    def get(self, key: str) -> bytes:
        if self.cache_dir:
            cached = os.path.join(self.cache_dir, key)
            if os.path.exists(cached):
                with open(cached, "rb") as f:
                    data = f.read()
                # the content-addressed contract holds for cache hits too:
                # a corrupted cache entry falls through to a store re-fetch
                if hashlib.sha256(data).hexdigest() == key:
                    return data
                try:
                    os.remove(cached)
                except OSError:
                    pass
        with open(os.path.join(self.dir, key), "rb") as f:
            data = f.read()
        if hashlib.sha256(data).hexdigest() != key:
            raise IOError(f"blob {key} failed content verification")
        if self.cache_dir:
            tmp = os.path.join(self.cache_dir,
                               f".{key}.tmp-{uuid.uuid4().hex[:8]}")
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, os.path.join(self.cache_dir, key))
        return data

    def exists(self, key: str) -> bool:
        return os.path.exists(os.path.join(self.dir, key))

    def delete(self, key: str) -> None:
        try:
            os.remove(os.path.join(self.dir, key))
        except OSError:
            pass
