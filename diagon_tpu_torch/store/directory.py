"""Directory abstraction: the port's own copy of
``diagon_tpu/store/directory.py`` (reference ``store/Directory.h`` /
``FSDirectory`` / ``ByteBuffersDirectory``).

A Directory is a flat namespace of immutable files. ``FSDirectory`` backs
onto the filesystem with mmap reads; ``RAMDirectory`` holds bytes in memory
(tests). Writes are create-once: rename-into-place is used for atomic
commit files.
"""

from __future__ import annotations

import os
from typing import Dict, List, Union

import numpy as np


class Directory:
    def list_files(self) -> List[str]:
        raise NotImplementedError

    def file_exists(self, name: str) -> bool:
        return name in self.list_files()

    def file_length(self, name: str) -> int:
        raise NotImplementedError

    def read_bytes(self, name: str) -> bytes:
        raise NotImplementedError

    def open_mmap(self, name: str) -> np.ndarray:
        """Zero-copy uint8 view of the file where supported."""
        return np.frombuffer(self.read_bytes(name), dtype=np.uint8)

    def write_bytes(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def create_atomic(self, name: str, data: bytes) -> bool:
        """Create ``name`` only if it does not exist (atomic, for locks).
        Returns False if the file already exists."""
        raise NotImplementedError

    def delete_file(self, name: str) -> None:
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        raise NotImplementedError

    def sync(self, names) -> None:
        pass

    def sync_meta(self) -> None:
        pass

    def obtain_lock(self, name: str = "write.lock", force: bool = False):
        from diagon_tpu_torch.store.lock import Lock

        return Lock.obtain(self, name, force=force)


class FSDirectory(Directory):
    def __init__(self, path: Union[str, os.PathLike]):
        self.path = os.fspath(path)
        os.makedirs(self.path, exist_ok=True)

    @staticmethod
    def open(path) -> "FSDirectory":
        return FSDirectory(path)

    def _p(self, name: str) -> str:
        if "/" in name or name.startswith("."):
            raise ValueError(f"invalid file name {name!r}")
        return os.path.join(self.path, name)

    def list_files(self) -> List[str]:
        return sorted(
            f
            for f in os.listdir(self.path)
            if os.path.isfile(os.path.join(self.path, f))
        )

    def file_exists(self, name: str) -> bool:
        return os.path.isfile(self._p(name))

    def file_length(self, name: str) -> int:
        return os.path.getsize(self._p(name))

    def read_bytes(self, name: str) -> bytes:
        with open(self._p(name), "rb") as f:
            return f.read()

    def open_mmap(self, name: str) -> np.ndarray:
        return np.memmap(self._p(name), dtype=np.uint8, mode="r")

    def write_bytes(self, name: str, data: bytes) -> None:
        # write tmp + rename for atomicity (like segments_N generation files)
        tmp = self._p(name) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._p(name))

    def create_atomic(self, name: str, data: bytes) -> bool:
        try:
            fd = os.open(self._p(name), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        try:
            os.write(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
        return True

    def delete_file(self, name: str) -> None:
        os.unlink(self._p(name))

    def rename(self, src: str, dst: str) -> None:
        os.replace(self._p(src), self._p(dst))

    def sync(self, names) -> None:
        for n in names:
            fd = os.open(self._p(n), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)

    def sync_meta(self) -> None:
        fd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


class RAMDirectory(Directory):
    def __init__(self):
        import threading

        self._files: Dict[str, bytes] = {}
        self._mutex = threading.Lock()

    def list_files(self) -> List[str]:
        return sorted(self._files)

    def file_exists(self, name: str) -> bool:
        return name in self._files

    def file_length(self, name: str) -> int:
        return len(self._files[name])

    def read_bytes(self, name: str) -> bytes:
        return self._files[name]

    def write_bytes(self, name: str, data: bytes) -> None:
        self._files[name] = bytes(data)

    def create_atomic(self, name: str, data: bytes) -> bool:
        with self._mutex:
            if name in self._files:
                return False
            self._files[name] = bytes(data)
            return True

    def delete_file(self, name: str) -> None:
        del self._files[name]

    def rename(self, src: str, dst: str) -> None:
        self._files[dst] = self._files.pop(src)
