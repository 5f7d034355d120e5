"""Background artifact writer (port of `tpu_splat/utils/async_io.py`): PLY/eval-image/timelapse saves off the train loop.

Reference: SplatData::save_ply spawns a detached writer thread (and joins on shutdown)
so disk writes never stall training (src/core/splat_data.cpp:455-477). Same contract
here: one daemon thread drains a queue of (fn, args); `flush()` blocks until everything
queued so far is on disk (called before process exit and before artifacts are read
back). Exceptions are logged, never raised into the train loop.
"""

from __future__ import annotations

import queue
import threading

from .log import get_logger

log = get_logger(__name__)


class AsyncWriter:
    def __init__(self, name: str = "artifact-writer"):
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            fn, args, kwargs = item
            try:
                fn(*args, **kwargs)
            except Exception:  # noqa: BLE001 - never kill the writer
                log.exception("async save failed: %s", getattr(fn, "__name__", fn))
            finally:
                self._q.task_done()

    def submit(self, fn, *args, **kwargs) -> None:
        self._q.put((fn, args, kwargs))

    def flush(self) -> None:
        """Block until every queued write has completed."""
        self._q.join()


_writer: AsyncWriter | None = None
_lock = threading.Lock()


def writer() -> AsyncWriter:
    global _writer
    with _lock:
        if _writer is None:
            _writer = AsyncWriter()
        return _writer
