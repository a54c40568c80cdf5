"""AssetCompiler: watch + recompile (counterpart of
``lumixengine_tpu/editor/asset_compiler.py``; ≙ reference editor/asset_compiler.{h,cpp}
+ editor FileSystemWatcher).

The reference's AssetCompiler registers per-type plugins, compiles source
assets into hash-keyed `.res` blobs, tracks dependencies, and recompiles when
the editor's FileSystemWatcher reports a change. This build keeps the same
surface: register plugins by extension, compile through the content-hash
AssetCache (engine/resource.py), register dependencies (e.g. a .pat depends on
the .pai it imports), and a polling mtime watcher drives recompiles — polled
from the engine frame (Engine.update_host) or a background thread.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from lumixengine_tpu_torch.core import log
from lumixengine_tpu_torch.engine.resource import AssetCache


class FileSystemWatcher:
    """Polling mtime watcher (portable; the reference uses OS watch APIs —
    inotify/ReadDirectoryChangesW — behind the same callback surface)."""

    def __init__(self):
        self._watched: Dict[str, float] = {}
        self._callbacks: List[Callable[[str], None]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()

    def watch(self, path: str) -> None:
        with self._lock:
            try:
                self._watched[path] = os.stat(path).st_mtime
            except OSError:
                self._watched[path] = -1.0

    def unwatch(self, path: str) -> None:
        with self._lock:
            self._watched.pop(path, None)

    def on_change(self, cb: Callable[[str], None]) -> None:
        self._callbacks.append(cb)

    def poll(self) -> List[str]:
        """Check mtimes once; fire callbacks; returns changed paths."""
        changed = []
        with self._lock:
            items = list(self._watched.items())
        for path, old in items:
            try:
                m = os.stat(path).st_mtime
            except OSError:
                m = -1.0
            if m != old:
                with self._lock:
                    self._watched[path] = m
                changed.append(path)
        for p in changed:
            for cb in self._callbacks:
                cb(p)
        return changed

    def start(self, interval: float = 0.5) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def run():
            while not self._stop.wait(interval):
                self.poll()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="fs-watcher")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class AssetCompiler:
    """Per-extension compile plugins + dependency registry + watch-recompile
    (≙ asset_compiler.h addPlugin/registerDependency/onFileChanged)."""

    def __init__(self, watcher: Optional[FileSystemWatcher] = None):
        self.cache = AssetCache()
        self.watcher = watcher or FileSystemWatcher()
        self.watcher.on_change(self.on_file_changed)
        self._plugins: Dict[str, Callable[[str, bytes], Any]] = {}
        # dependency: source path -> set of product paths to recompile
        self._dependents: Dict[str, Set[str]] = {}
        self._compiled: Dict[str, Any] = {}
        self._versions: Dict[str, int] = {}
        self._listeners: List[Callable[[str, Any], None]] = []

    # -- plugin registry ------------------------------------------------------

    def add_plugin(self, ext: str, compile_fn: Callable[[str, bytes], Any]) -> None:
        """compile_fn(path, source_bytes) -> compiled blob."""
        self._plugins[ext.lstrip(".").lower()] = compile_fn

    def _plugin_for(self, path: str):
        return self._plugins.get(path.rsplit(".", 1)[-1].lower())

    def register_dependency(self, product: str, source: str) -> None:
        """Changing `source` recompiles `product` (≙ registerDependency)."""
        self._dependents.setdefault(source, set()).add(product)
        self.watcher.watch(source)

    def on_compiled(self, cb: Callable[[str, Any], None]) -> None:
        self._listeners.append(cb)

    # -- compile --------------------------------------------------------------

    def compile(self, path: str) -> Any:
        fn = self._plugin_for(path)
        if fn is None:
            raise KeyError(f"no asset plugin for {path!r}")
        with open(path, "rb") as f:
            src = f.read()
        # the cache key covers the source AND its registered dependencies —
        # a changed .pai must miss the cache of every .pat importing it
        key = bytearray(src)
        for dep, products in sorted(self._dependents.items()):
            if path in products:
                try:
                    with open(dep, "rb") as f:
                        key += f.read()
                except OSError:
                    key += dep.encode()
        out = self.cache.get_or_bake(bytes(key), lambda: fn(path, src))
        self._compiled[path] = out
        self._versions[path] = self._versions.get(path, 0) + 1
        self.watcher.watch(path)
        for cb in self._listeners:
            cb(path, out)
        return out

    def get(self, path: str) -> Any:
        if path not in self._compiled:
            return self.compile(path)
        return self._compiled[path]

    def version(self, path: str) -> int:
        """Bumps every recompile — resources poll this to hot-reload."""
        return self._versions.get(path, 0)

    # -- watch → recompile ------------------------------------------------------

    def on_file_changed(self, path: str) -> None:
        """≙ AssetCompiler::onFileChanged: recompile the asset itself and
        every registered dependent product."""
        targets = set()
        if path in self._compiled:
            targets.add(path)
        targets |= self._dependents.get(path, set())
        for t in targets:
            try:
                self.compile(t)
                log.log_info("asset_compiler", f"recompiled {t} (changed: {path})")
            except Exception as ex:  # keep watching; report like the reference
                log.log_error("asset_compiler", f"recompile {t} failed: {ex}")

    def poll(self) -> List[str]:
        return self.watcher.poll()
