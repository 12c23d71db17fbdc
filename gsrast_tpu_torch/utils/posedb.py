"""Camera-pose persistence: a JSON file of named tables.

The file format is the reference's (`gsrast_tpu/utils/posedb.py`): one JSON
object of tables, written with indent 1 and sorted keys, keys starting with
`__` hidden from iteration. A store written by either package reads in the
other.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from ..camera import Camera, pose_from_dict, pose_to_dict

HIDDEN_PREFIX = "__"


class Store:
    """A small named-table key-value store backed by one JSON file, written
    through a temporary file on every change."""

    def __init__(self, path: str = "gsrast_store.json"):
        self._path = path
        self._lock = threading.Lock()
        self._data: Dict[str, Dict[str, object]] = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    self._data = json.load(f)
            except (json.JSONDecodeError, OSError):
                self._data = {}

    def _flush(self) -> None:
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._data, f, indent=1, sort_keys=True)
        os.replace(tmp, self._path)

    def put(self, table: str, key: str, value) -> None:
        with self._lock:
            self._data.setdefault(table, {})[key] = value
            self._flush()

    def get(self, table: str, key: str, default=None):
        return self._data.get(table, {}).get(key, default)

    def remove(self, table: str, key: str) -> bool:
        with self._lock:
            tbl = self._data.get(table, {})
            if key in tbl:
                del tbl[key]
                self._flush()
                return True
            return False

    def drop(self, table: str) -> None:
        with self._lock:
            self._data.pop(table, None)
            self._flush()

    def iterate(self, table: str, include_hidden: bool = False
                ) -> Iterator[Tuple[str, object]]:
        """(key, value) in key order; `__` keys only if asked for."""
        for k, v in sorted(self._data.get(table, {}).items()):
            if not include_hidden and k.startswith(HIDDEN_PREFIX):
                continue
            yield k, v


class PoseDB:
    """Named camera poses in the store's `cam_pose` table."""

    TABLE = "cam_pose"

    def __init__(self, store: Optional[Store] = None,
                 path: str = "gsrast_store.json"):
        self.store = store or Store(path)

    def save(self, name: str, camera: Camera) -> None:
        self.store.put(self.TABLE, name, pose_to_dict(camera))

    def load(self, name: str, device="cpu") -> Optional[Camera]:
        d = self.store.get(self.TABLE, name)
        return pose_from_dict(d, device=device) if d is not None else None

    def delete(self, name: str) -> bool:
        return self.store.remove(self.TABLE, name)

    def names(self) -> List[str]:
        return [k for k, _ in self.store.iterate(self.TABLE)]
