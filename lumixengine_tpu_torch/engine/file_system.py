"""FileSystem (≙ reference engine/file_system.{h,cpp}).

Reference: async read/write on a dedicated IO thread; completion callbacks are
queued and drained on the main thread from Engine::update (processCallbacks);
mount points map virtual paths to disk roots.

TPU build: a small thread-pool IO service with the same main-thread callback
drain contract, plus an in-memory overlay (≙ the tests' MemoryFileSystem fake,
also used for packaged assets).
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple


class FileSystem:
    def __init__(self, base_path: str = ".", io_threads: int = 2):
        self.base_path = base_path
        self.mounts: Dict[str, str] = {}
        self.memory: Dict[str, bytes] = {}
        self._pool = ThreadPoolExecutor(max_workers=io_threads, thread_name_prefix="lxt-io")
        self._done: List[Tuple[Callable, tuple]] = []
        self._lock = threading.Lock()

    # -- mounts / resolution -------------------------------------------------

    def mount(self, prefix: str, disk_root: str) -> None:
        self.mounts[prefix] = disk_root

    def add_memory_file(self, path: str, data: bytes) -> None:
        """In-memory overlay (≙ MemoryFileSystem test fake)."""
        self.memory[path] = bytes(data)

    def resolve(self, path: str) -> str:
        for prefix, root in sorted(self.mounts.items(), key=lambda kv: -len(kv[0])):
            if path.startswith(prefix):
                return os.path.join(root, path[len(prefix):].lstrip("/"))
        return os.path.join(self.base_path, path)

    def exists(self, path: str) -> bool:
        return path in self.memory or os.path.exists(self.resolve(path))

    # -- sync API ---------------------------------------------------------------

    def read(self, path: str) -> bytes:
        if path in self.memory:
            return self.memory[path]
        with open(self.resolve(path), "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes) -> None:
        full = self.resolve(path)
        os.makedirs(os.path.dirname(full) or ".", exist_ok=True)
        with open(full, "wb") as f:
            f.write(data)

    # -- async API (≙ FileSystem::getContent + IO thread) --------------------------

    def read_async(self, path: str, cb: Callable[[Optional[bytes], Optional[str]], None]) -> None:
        def work():
            try:
                data = self.read(path)
                err = None
            except Exception as e:  # noqa: BLE001
                data, err = None, str(e)
            with self._lock:
                self._done.append((cb, (data, err)))

        self._pool.submit(work)

    def write_async(self, path: str, data: bytes,
                    cb: Optional[Callable[[Optional[str]], None]] = None) -> None:
        def work():
            try:
                self.write(path, data)
                err = None
            except Exception as e:  # noqa: BLE001
                err = str(e)
            if cb is not None:
                with self._lock:
                    self._done.append((cb, (err,)))

        self._pool.submit(work)

    def process_callbacks(self) -> int:
        """Drain completions on the caller's (main) thread — called from the
        engine frame (≙ engine.cpp fs->processCallbacks)."""
        with self._lock:
            done = self._done
            self._done = []
        for cb, args in done:
            cb(*args)
        return len(done)

    def wait_all(self, timeout: float = 10.0) -> None:
        """Block until queued IO finished, then drain (tests/shutdown)."""
        import time

        t0 = time.time()
        self._pool.shutdown(wait=True)
        self._pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="lxt-io")
        while time.time() - t0 < timeout:
            if not self.process_callbacks():
                break
