"""Inter-process file lock (fcntl) for shared-filesystem races.

Counterpart of ``tpuflow/utils/locking.py``: the flow store takes it
around its run-id counter, so that flows launched at the same time never
draw one id twice.
"""

from __future__ import annotations

import fcntl
import os


class FileLock:
    """``with FileLock(path):`` — exclusive advisory lock on ``path``."""

    def __init__(self, path: str):
        self.path = os.path.expanduser(path)
        self._fd: int | None = None

    def __enter__(self) -> "FileLock":
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._fd = os.open(self.path, os.O_CREAT | os.O_RDWR)
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc) -> None:
        assert self._fd is not None
        fcntl.flock(self._fd, fcntl.LOCK_UN)
        os.close(self._fd)
        self._fd = None
