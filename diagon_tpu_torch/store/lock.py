"""Single-writer lock: the port's own copy of ``diagon_tpu/store/lock.py``
(reference ``store/Lock.h`` + write.lock semantics).

Acquisition is a single atomic create (``O_CREAT|O_EXCL`` on FSDirectory),
so two processes cannot both obtain the same lock. The lock file records
pid + timestamp; a crashed holder leaves a stale file that can be cleared
with ``Lock.force_unlock`` or ``obtain(..., force=True)``.
"""

from __future__ import annotations

import json
import os
import time


class LockObtainFailedError(Exception):
    pass


class Lock:
    """Atomically-created lock file; released by deletion or context exit."""

    def __init__(self, directory, name: str):
        self.directory = directory
        self.name = name
        self._held = True

    @staticmethod
    def obtain(directory, name: str = "write.lock", force: bool = False) -> "Lock":
        payload = json.dumps(
            {"pid": os.getpid(), "acquired_at": time.time()}
        ).encode()
        if directory.create_atomic(name, payload):
            return Lock(directory, name)
        if force:
            Lock.force_unlock(directory, name)
            if directory.create_atomic(name, payload):
                return Lock(directory, name)
        holder = ""
        try:
            holder = directory.read_bytes(name).decode(errors="replace")
        except OSError:
            pass
        raise LockObtainFailedError(
            f"lock {name!r} already held in {directory} ({holder}); "
            "if the holder crashed, use force=True or Lock.force_unlock()"
        )

    @staticmethod
    def force_unlock(directory, name: str = "write.lock") -> None:
        """Clear a stale lock left by a crashed process."""
        try:
            directory.delete_file(name)
        except (FileNotFoundError, KeyError):
            pass

    def release(self) -> None:
        if self._held:
            self._held = False
            try:
                self.directory.delete_file(self.name)
            except FileNotFoundError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
