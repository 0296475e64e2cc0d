"""State Processor API: offline read / transform / bootstrap of snapshots
(port of ``flink_tpu/state_processor/__init__.py``).

reference: flink-libraries/flink-state-processing-api —
SavepointReader.java (read keyed state of an operator as a DataSet) and
SavepointWriter.java (bootstrap new state / withOperator / removeOperator /
write). The reference runs these as batch jobs; here snapshots are logical
columnar tables already (key_id / namespace / key_group / leaf arrays — the
SlotTable.snapshot format), so reading is a direct columnar load and
bootstrapping is building those columns — no cluster needed.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.checkpoint.savepoint import write_savepoint
from flink_tpu_torch.checkpoint.storage import (
    read_checkpoint_chain,
    read_manifest,
    resolve_snapshot_dir,
)
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.state.keygroups import assign_key_groups

__all__ = [
    "SavepointReader",
    "SavepointWriter",
    "KeyedStateBootstrap",
]


def _find_table(state: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Locate the logical keyed-state table inside an operator state dict
    (depth-first: operators nest their windower/table state under their own
    keys, e.g. {"windower": {"table": {...}}})."""
    if "key_id" in state:
        return state
    for v in state.values():
        if isinstance(v, dict):
            t = _find_table(v)
            if t is not None:
                return t
    return None


class SavepointReader:
    """Read an existing savepoint / checkpoint.

    reference: state/api/SavepointReader.java (readKeyedState et al.).
    """

    def __init__(self, snapshot_dir: str, manifest: Dict[str, Any],
                 states: Dict[str, Dict[str, Any]]):
        self.path = snapshot_dir
        self.manifest = manifest
        self._states = states

    @staticmethod
    def load(path: str) -> "SavepointReader":
        """``path`` may be a savepoint dir, a single checkpoint dir, or a
        checkpoint root (newest chk-N wins)."""
        d = resolve_snapshot_dir(path)
        return SavepointReader(d, read_manifest(d), read_checkpoint_chain(d))

    # -- inspection ----------------------------------------------------------

    @property
    def job_name(self) -> str:
        return self.manifest["job_name"]

    @property
    def checkpoint_id(self) -> int:
        return int(self.manifest["checkpoint_id"])

    def operators(self) -> List[str]:
        return list(self._states)

    def read_state(self, uid: str) -> Dict[str, Any]:
        """The operator's raw state dict (keyed table + host metadata)."""
        if uid not in self._states:
            raise KeyError(
                f"no state for operator {uid!r}; available: "
                f"{sorted(self._states)}")
        return self._states[uid]

    def has_keyed_state(self, uid: str) -> bool:
        return _find_table(self.read_state(uid)) is not None

    def read_keyed_state(self, uid: str) -> RecordBatch:
        """The operator's keyed state as a columnar batch with key_id /
        namespace / key_group / leaf_i columns."""
        table = _find_table(self.read_state(uid))
        if table is None:
            raise ValueError(f"operator {uid!r} has no keyed state table")
        cols = {k: np.asarray(v) for k, v in table.items()
                if isinstance(v, np.ndarray)}
        return RecordBatch(cols)

    def read_source_position(self, uid: str) -> Any:
        state = self.read_state(uid)
        if "source" not in state:
            raise ValueError(f"operator {uid!r} is not a source")
        return state["source"]


class KeyedStateBootstrap:
    """Build a keyed-state table for one operator from raw columns.

    reference: state/api/KeyedStateBootstrapFunction — here vectorized:
    pass whole arrays instead of a per-record callback.
    """

    def __init__(self, key_ids: Sequence[int], namespaces: Sequence[int],
                 leaves: Sequence[np.ndarray], max_parallelism: int = 128,
                 extra_state: Optional[Dict[str, Any]] = None):
        key_ids = np.asarray(key_ids, dtype=np.int64)
        namespaces = np.asarray(namespaces, dtype=np.int64)
        if len(key_ids) != len(namespaces):
            raise ValueError("key_ids and namespaces must align")
        for leaf in leaves:
            if len(leaf) != len(key_ids):
                raise ValueError("every leaf must align with key_ids")
        self.table: Dict[str, Any] = {
            "key_id": key_ids,
            "namespace": namespaces,
            "key_group": assign_key_groups(key_ids, max_parallelism),
            **{f"leaf_{i}": np.asarray(leaf)
               for i, leaf in enumerate(leaves)},
        }
        self.extra_state = extra_state or {}

    def to_state(self) -> Dict[str, Any]:
        return {"table": self.table, **self.extra_state}


class SavepointWriter:
    """Create or derive a savepoint.

    reference: state/api/SavepointWriter.java — newSavepoint /
    fromExistingSavepoint + withOperator / removeOperator / write.
    """

    def __init__(self, states: Optional[Dict[str, Dict[str, Any]]] = None,
                 job_name: str = "bootstrap", checkpoint_id: int = 0):
        self._states: Dict[str, Dict[str, Any]] = dict(states or {})
        self.job_name = job_name
        self.checkpoint_id = checkpoint_id

    @staticmethod
    def new_savepoint(job_name: str = "bootstrap") -> "SavepointWriter":
        return SavepointWriter(job_name=job_name)

    @staticmethod
    def from_existing(path: str) -> "SavepointWriter":
        reader = SavepointReader.load(path)
        return SavepointWriter(dict(reader._states), reader.job_name,
                               reader.checkpoint_id)

    # -- mutation ------------------------------------------------------------

    def with_operator(self, uid: str, bootstrap) -> "SavepointWriter":
        """Attach state for ``uid`` (a KeyedStateBootstrap or raw dict)."""
        state = (bootstrap.to_state()
                 if isinstance(bootstrap, KeyedStateBootstrap)
                 else dict(bootstrap))
        self._states[uid] = state
        return self

    def transform_operator(
            self, uid: str,
            fn: Callable[[Dict[str, Any]], Dict[str, Any]]
    ) -> "SavepointWriter":
        """Rewrite an operator's state dict through ``fn`` (schema
        migration, filtering, rescaling prep...)."""
        if uid not in self._states:
            raise KeyError(f"no operator {uid!r} to transform")
        self._states[uid] = fn(self._states[uid])
        return self

    def remove_operator(self, uid: str) -> "SavepointWriter":
        self._states.pop(uid, None)
        return self

    # -- output --------------------------------------------------------------

    def write(self, path: str) -> str:
        if os.path.exists(os.path.join(path, "manifest.json")):
            raise FileExistsError(
                f"refusing to overwrite existing snapshot at {path!r}")
        return write_savepoint(path, self.job_name, self._states,
                               checkpoint_id=self.checkpoint_id)
