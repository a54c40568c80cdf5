"""Resource system (counterpart of ``lumixengine_tpu/engine/resource.py``;
≙ reference engine/resource.{h,cpp} and the resource manager hub).

A ref-counted asynchronous ``Resource`` with the EMPTY → READY/FAILURE
states, a ``ResourceManager`` per type and a hub owning them; loads go
through the FileSystem's IO threads (``engine/file_system.py``) and the
callbacks fire when the file system's callbacks are processed. "Compiling"
an asset is baking it into device data, so the asset compiler's analog is
``AssetCache``: bakes keyed by a content hash (``core/hash.stable_hash64``).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from lumixengine_tpu_torch.core.hash import stable_hash64

# resource states (≙ resource.h Resource::State)
EMPTY = 0
READY = 1
FAILURE = 2


class Resource:
    """Ref-counted async resource."""

    TYPE = "resource"

    def __init__(self, path: str, manager: "ResourceManager"):
        self.path = path
        self.manager = manager
        self.state = EMPTY
        self.refcount = 0
        self.data: Any = None
        self.error: Optional[str] = None
        self._callbacks: List[Callable[["Resource"], None]] = []
        self._lock = threading.Lock()

    @property
    def is_ready(self) -> bool:
        return self.state == READY

    @property
    def is_failure(self) -> bool:
        return self.state == FAILURE

    def on_loaded(self, cb: Callable[["Resource"], None]) -> None:
        with self._lock:
            if self.state != EMPTY:
                cb(self)
            else:
                self._callbacks.append(cb)

    def _finish(self, state: int, data: Any = None, error: Optional[str] = None) -> None:
        with self._lock:
            self.state = state
            self.data = data
            self.error = error
            cbs = self._callbacks
            self._callbacks = []
        for cb in cbs:
            cb(self)

    def load_blob(self, blob: bytes) -> Any:
        """Raw bytes → the resource's data (≙ Resource::load); override."""
        return blob


class ResourceManager:
    """Per-type manager (≙ resource.h ResourceManager)."""

    def __init__(self, hub: "ResourceManagerHub", rtype: str, factory: Callable[..., Resource]):
        self.hub = hub
        self.rtype = rtype
        self.factory = factory
        self.resources: Dict[str, Resource] = {}

    def load(self, path: str) -> Resource:
        res = self.resources.get(path)
        if res is None:
            res = self.factory(path, self)
            self.resources[path] = res
            self.hub.fs.read_async(path, lambda blob, err: self._on_read(res, blob, err))
        res.refcount += 1
        return res

    def _on_read(self, res: Resource, blob: Optional[bytes], err: Optional[str]) -> None:
        if err is not None:
            res._finish(FAILURE, error=err)
            return
        try:
            res._finish(READY, data=res.load_blob(blob))
        except Exception as e:  # noqa: BLE001 — a load failure is the FAILURE state
            res._finish(FAILURE, error=str(e))

    def unload(self, res: Resource) -> None:
        res.refcount -= 1
        if res.refcount <= 0:
            self.resources.pop(res.path, None)
            res.state = EMPTY
            res.data = None


class ResourceManagerHub:
    """≙ resource.h ResourceManagerHub: one manager per type."""

    def __init__(self, fs):
        self.fs = fs
        self.managers: Dict[str, ResourceManager] = {}

    def register(self, rtype: str, factory: Callable[..., Resource] = Resource) -> ResourceManager:
        m = ResourceManager(self, rtype, factory)
        self.managers[rtype] = m
        return m

    def load(self, rtype: str, path: str) -> Resource:
        if rtype not in self.managers:
            self.register(rtype)
        return self.managers[rtype].load(path)


class AssetCache:
    """Baked assets keyed by the hash of their source bytes (≙ the asset
    compiler's compiled-blob cache)."""

    def __init__(self):
        self._cache: Dict[int, Any] = {}
        self.hits = 0
        self.misses = 0

    def get_or_bake(self, source_bytes: bytes, bake: Callable[[], Any]) -> Any:
        key = stable_hash64(source_bytes)
        if key in self._cache:
            self.hits += 1
            return self._cache[key]
        self.misses += 1
        out = bake()
        self._cache[key] = out
        return out
